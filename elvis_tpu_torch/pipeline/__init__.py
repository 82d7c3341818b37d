from elvis_tpu_torch.pipeline.config import ElvisConfig

__all__ = ["ElvisConfig"]
