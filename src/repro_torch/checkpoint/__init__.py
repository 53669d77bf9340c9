from repro_torch.checkpoint.ckpt import Checkpointer
