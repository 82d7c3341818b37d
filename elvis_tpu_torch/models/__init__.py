from elvis_tpu_torch.models.srnet import (
    SRNetCompact,
    SRNetLarge,
    srnet_phase_fn,
    srnet_upsample_fn,
)

__all__ = ["SRNetCompact", "SRNetLarge", "srnet_phase_fn", "srnet_upsample_fn"]
