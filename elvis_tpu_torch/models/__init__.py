from elvis_tpu_torch.models.deblur_unet import DeblurUNet
from elvis_tpu_torch.models.diffusion import DiffusionRestorer
from elvis_tpu_torch.models.inpaint_net import InpaintNet
from elvis_tpu_torch.models.saliency_net import SaliencyNet, make_neural_saliency_fn
from elvis_tpu_torch.models.srnet import (
    SRNet,
    SRNetCompact,
    SRNetLarge,
    srnet_phase_fn,
    srnet_upsample_fn,
)

__all__ = ["DeblurUNet", "DiffusionRestorer", "InpaintNet", "SaliencyNet", "SRNet", "SRNetCompact",
           "SRNetLarge", "make_neural_saliency_fn", "srnet_phase_fn", "srnet_upsample_fn"]
