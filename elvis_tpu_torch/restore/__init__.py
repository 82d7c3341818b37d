from elvis_tpu_torch.restore.progressive import (
    StagedUpsampler,
    lanczos_upsample_2x,
    progressive_restore,
)
from elvis_tpu_torch.restore.registry import (
    available_restorers,
    get_restorer,
    register_restorer,
)

__all__ = [
    "StagedUpsampler",
    "available_restorers",
    "get_restorer",
    "lanczos_upsample_2x",
    "progressive_restore",
    "register_restorer",
]
