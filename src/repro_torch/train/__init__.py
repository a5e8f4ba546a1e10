"""Training substrate: optimizer, step builder, checkpointing, fault
tolerance, metrics (port of ``repro.train``)."""
from . import checkpoint, fault, loop, metrics, optim
from .loop import init_state, make_train_step
from .optim import OptimConfig

__all__ = ["checkpoint", "fault", "loop", "metrics", "optim", "init_state",
           "make_train_step", "OptimConfig"]
