"""The train step (PyTorch), the counterpart of the JAX package's
``train/``."""
from .step import (TrainConfig, TrainState, make_train_step,  # noqa: F401
                   train_state_for, train_state_init)
