from omnia_tpu_torch.train.trainer import (
    TrainState,
    adamw,
    loss_fn,
    make_train_step,
    pipeline_loss_fn,
    train_state_from_jax,
)

__all__ = ["TrainState", "adamw", "loss_fn", "make_train_step", "pipeline_loss_fn",
           "train_state_from_jax"]
