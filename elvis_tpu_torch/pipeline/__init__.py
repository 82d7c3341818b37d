from elvis_tpu_torch.pipeline.config import ElvisConfig, load_config_from_cli
from elvis_tpu_torch.pipeline.run import APPROACHES, run_elvis

__all__ = ["APPROACHES", "ElvisConfig", "load_config_from_cli", "run_elvis"]
