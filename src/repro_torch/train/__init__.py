"""Training substrate: the train step and its knobs, and the
fault-tolerant loop with checkpoints (counterpart of ``repro.train``)."""
from .loop import SimulatedFailure, TrainLoopConfig, train
from .space import apply_train_knobs, train_knob_space
from .step import RunKnobs, init_train_state, make_train_step

__all__ = [n for n in dir() if not n.startswith("_")]
