from basd_tpu_torch.losses.combined import (
    BASDLossConfig,
    basd_loss,
    extraction_layers,
    init_basd_loss,
)
from basd_tpu_torch.losses.selector import SelectorConfig, select_and_mix

__all__ = [
    "BASDLossConfig",
    "SelectorConfig",
    "basd_loss",
    "extraction_layers",
    "init_basd_loss",
    "select_and_mix",
]
