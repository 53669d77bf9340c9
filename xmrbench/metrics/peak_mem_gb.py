"""torch.cuda.max_memory_allocated() over the program's set-up and the window, in GB."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.on_chip else None
