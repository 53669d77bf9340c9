"""Launch helpers of the port (counterpart of ``repro.launch``): model input
specs and demo batches (``specs``), the trainer (``train``), the card's
roofline constants (``hw``), the production meshes (``mesh``), what a step
moves and computes (``hlo_stats``: profiler traces, ``send`` logs and an op
counter in place of XLA's analyses), and the dry runs of every LM cell
(``dryrun``) and of the paper's enterprise serving step (``serve_dryrun``),
run on ``meta`` tensors."""
