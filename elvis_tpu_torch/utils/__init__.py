from elvis_tpu_torch.utils.transfer import as_pixels_u8

__all__ = ["as_pixels_u8"]
