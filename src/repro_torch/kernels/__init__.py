from repro_torch.kernels import ops, ref
from repro_torch.kernels.mscm_kernel import (
    group_blocks_by_chunk,
    mscm_fused,
    mscm_fused_plain,
    mscm_grouped,
    mscm_grouped_plain,
    mscm_pregather,
    mscm_pregather_plain,
)
from repro_torch.kernels.ops import (
    group_blocks_device,
    grouped_tile_bound,
    mscm_grouped_level,
    mscm_pallas,
    mscm_pallas_grouped,
)

__all__ = [
    "ops",
    "ref",
    "mscm_fused",
    "mscm_fused_plain",
    "mscm_pregather",
    "mscm_pregather_plain",
    "mscm_grouped",
    "mscm_grouped_plain",
    "mscm_grouped_level",
    "mscm_pallas",
    "mscm_pallas_grouped",
    "group_blocks_by_chunk",
    "group_blocks_device",
    "grouped_tile_bound",
]
