"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json`` and prints its result line. See
``ADDING.md``."""
