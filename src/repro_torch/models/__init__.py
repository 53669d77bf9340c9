from repro_torch.models.common import ArchConfig
from repro_torch.models import lm
