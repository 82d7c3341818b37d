from elvis_tpu_torch.models.deblur_unet import DeblurUNet
from elvis_tpu_torch.models.inpaint_net import InpaintNet
from elvis_tpu_torch.models.srnet import (
    SRNetCompact,
    SRNetLarge,
    srnet_phase_fn,
    srnet_upsample_fn,
)

__all__ = ["DeblurUNet", "InpaintNet", "SRNetCompact", "SRNetLarge", "srnet_phase_fn",
           "srnet_upsample_fn"]
