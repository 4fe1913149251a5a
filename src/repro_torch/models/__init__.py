from repro_torch.models.config import (ATTN, CROSS, SSM, LayerSpec,
                                       ModelConfig, Segment)
from repro_torch.models import convert, modules, transformer

__all__ = ["ATTN", "CROSS", "SSM", "LayerSpec", "ModelConfig", "Segment",
           "convert", "modules", "transformer"]
