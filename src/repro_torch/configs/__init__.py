from repro_torch.configs.base import (ARCH_IDS, PORT_ARCH_IDS, all_configs, get_config,
                                      reduced_config)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, runnable
