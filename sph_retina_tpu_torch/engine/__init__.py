from .train import build_optimizer, make_train_step, step_lr_schedule

# The JAX package's TrainState, create_train_state and shard_batch have no
# counterpart by design: the model and the optimiser hold the state here,
# updated in place, and one process drives one card.
__all__ = [
    "build_optimizer",
    "make_train_step",
    "step_lr_schedule",
]
