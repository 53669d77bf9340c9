"""PyTorch/CUDA port of the XMR tree inference system (``repro``).

The package mirrors ``repro``'s layout — ``sparse``, ``core``, ``kernels``,
``quant``, ``trees``, ``data``, ``serving``, ``index``, ``distributed``,
``checkpoint``, ``configs``, ``models``, ``launch`` — with the same module and
function names. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``. Entry points place the model on a CUDA device unless the caller
passes ``device="cpu"``. Each of the reference's four Pallas kernels has a
CUDA C++ counterpart for ``sm_90a`` (``kernels/csrc``: ``mscm_grouped.cu``
holds the grouped kernel over f32 and over int8/fp8 tiles, ``mscm_block.cu``
the fused and pregather kernels), built with ``nvcc`` at first use.
"""
