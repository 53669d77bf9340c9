"""Launch helpers of the port (counterpart of ``repro.launch``): model input
specs and demo batches. The reference's dry-run, mesh, HLO-statistics and
hardware modules inspect XLA meshes and HLO and are not ported yet."""
