from elvis_tpu_torch.utils.timing import (
    measure_performance,
    measure_time,
    safe_print,
    silence_console_output,
)
from elvis_tpu_torch.utils.transfer import as_pixels_u8

__all__ = ["as_pixels_u8", "measure_performance", "measure_time", "safe_print",
           "silence_console_output"]
