"""Training of the spmel generator: schedules, state and EMA, the train
step, metrics, profiling, histograms and the ``Solver``."""

from autovc_tpu_torch.train.schedule import ReduceLROnPlateau, cosine_annealing, cosine_decay
from autovc_tpu_torch.train.solver import Solver
from autovc_tpu_torch.train.state import TrainState, ema_update, init_ema
from autovc_tpu_torch.train.step import loss_fn, make_eval_loss, make_optimizer, make_train_step

__all__ = [
    "ReduceLROnPlateau",
    "Solver",
    "TrainState",
    "cosine_annealing",
    "cosine_decay",
    "ema_update",
    "init_ema",
    "loss_fn",
    "make_eval_loss",
    "make_optimizer",
    "make_train_step",
]
