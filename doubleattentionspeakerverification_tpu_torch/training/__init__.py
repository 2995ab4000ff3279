"""The train step, its optimizers and the trainer (JAX ``training/``).

``TrainState`` and ``init_train_state`` have no counterpart by design: the
train state is the model's parameters and buffers and the ``torch.optim``
optimizer's state, and ``make_train_step`` returns a ``TrainStep`` that
holds both and counts the optimizer steps.
"""

from .optimizers import get_lr, make_optimizer, with_lr
from .step import TrainStep, make_eval_loss_step, make_train_step
from .trainer import Trainer

__all__ = [
    "get_lr",
    "make_optimizer",
    "with_lr",
    "TrainStep",
    "make_eval_loss_step",
    "make_train_step",
    "Trainer",
]
