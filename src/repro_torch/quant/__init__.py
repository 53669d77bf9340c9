"""Compressed-weight serving tiers of the port (counterpart of ``repro.quant``).

* :mod:`repro_torch.quant.storage`: per-(chunk, column) int8/fp8-e4m3
  quantization of the ELL chunk tiles, the magnitude-pruned re-pack, and
  :class:`QuantizedTree`;
* :mod:`repro_torch.quant.kernels`: ``method="mscm_pallas_grouped_q"``, the
  grouped CUDA kernel dequantizing each chunk tile as it stages it;
* :mod:`repro_torch.quant.contract`: recall@k and score MAE, the measured
  contract a compressed tier reports.

Selected with ``ServeConfig(quant=QuantConfig(tier="int8"))``.
"""

from repro_torch.quant.contract import recall_at_k, score_mae, topk_scores
from repro_torch.quant.kernels import (
    mscm_grouped_q,
    mscm_grouped_q_level,
    mscm_grouped_q_plain,
    mscm_pallas_grouped_q,
)
from repro_torch.quant.storage import (
    QUANT_DTYPES,
    QuantizedTree,
    QuantLayerArrays,
    dequantize_layer,
    dequantize_tree,
    prune_chunks,
    quantize_chunks,
    quantize_index,
    quantize_layer,
    quantize_tree,
)

__all__ = [
    "QUANT_DTYPES",
    "QuantLayerArrays",
    "QuantizedTree",
    "dequantize_layer",
    "dequantize_tree",
    "mscm_grouped_q",
    "mscm_grouped_q_level",
    "mscm_grouped_q_plain",
    "mscm_pallas_grouped_q",
    "prune_chunks",
    "quantize_chunks",
    "quantize_index",
    "quantize_layer",
    "quantize_tree",
    "recall_at_k",
    "score_mae",
    "topk_scores",
]
