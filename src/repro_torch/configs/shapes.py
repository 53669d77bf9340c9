"""Assigned input shapes (all 10 LM archs share this 4-shape grid).

Counterpart of ``repro.configs.shapes``. train_4k / prefill_32k are
full-sequence steps; decode_32k / long_500k are ONE new token against a KV
cache of seq_len. long_500k needs a sub-quadratic prefill path, so only
ssm/hybrid run it.
"""
import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def runnable(arch_family: str, shape: ShapeSpec) -> bool:
    """long_500k is skipped for pure full-attention archs."""
    if shape.name == "long_500k":
        return arch_family in ("ssm", "hybrid")
    return True
