"""ReID training on the card: the port of `vehicle_counting_tpu/train/`."""

from vehicle_counting_tpu_torch.train.reid_train import (
    ReidTrainConfig,
    create_train_state,
    eval_step,
    fit,
    train_step,
)

__all__ = ["ReidTrainConfig", "create_train_state", "eval_step", "fit", "train_step"]
