from elvis_tpu_torch.restore.backends import (
    resolve_deblur_backend,
    resolve_inpaint_backend,
    resolve_sr_backend,
)
from elvis_tpu_torch.restore.dampen import restore_dct_dampen_inverse
from elvis_tpu_torch.restore.hybrid import blended_restoration
from elvis_tpu_torch.restore.inpaint import restore_removal_diffusion
from elvis_tpu_torch.restore.lanczos import (
    restore_downsample_lanczos,
    restore_downsample_scale_lanczos,
)
from elvis_tpu_torch.restore.level_seq import (
    level_sequential_restore,
    naive_diffusion_restore,
    naive_sr_restore,
)
from elvis_tpu_torch.restore.progressive import (
    StagedUpsampler,
    lanczos_upsample_2x,
    progressive_restore,
)
from elvis_tpu_torch.restore.registry import (
    RestoreFallbackWarning,
    available_restorers,
    get_restorer,
    register_restorer,
    safe_restore,
)
from elvis_tpu_torch.restore.temporal import temporal_blend
from elvis_tpu_torch.restore.unsharp import restore_blur_unsharp

__all__ = [
    "RestoreFallbackWarning",
    "StagedUpsampler",
    "available_restorers",
    "blended_restoration",
    "get_restorer",
    "lanczos_upsample_2x",
    "level_sequential_restore",
    "naive_diffusion_restore",
    "naive_sr_restore",
    "progressive_restore",
    "register_restorer",
    "resolve_deblur_backend",
    "resolve_inpaint_backend",
    "resolve_sr_backend",
    "restore_blur_unsharp",
    "restore_dct_dampen_inverse",
    "restore_downsample_lanczos",
    "restore_downsample_scale_lanczos",
    "restore_removal_diffusion",
    "safe_restore",
    "temporal_blend",
]
