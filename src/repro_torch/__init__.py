"""PyTorch/CUDA port of the XMR tree inference system (``repro``).

The package mirrors ``repro``'s layout — ``sparse``, ``core``, ``kernels``,
``trees``, ``data``, ``serving`` — with the same module and function names.
It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points place the model on a CUDA device unless the caller passes
``device="cpu"``; the grouped MSCM kernel is CUDA C++ for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use.
"""
