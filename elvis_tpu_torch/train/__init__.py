from elvis_tpu_torch.train.data import synthetic_sr_batch, synthetic_video_batch
from elvis_tpu_torch.train.trainer import Trainer, TrainState, make_sharded_train_step

__all__ = [
    "Trainer",
    "TrainState",
    "make_sharded_train_step",
    "synthetic_sr_batch",
    "synthetic_video_batch",
]
