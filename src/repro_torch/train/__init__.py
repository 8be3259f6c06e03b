"""Training substrate: the train step and its knobs (counterpart of
``repro.train``; the fault-tolerant loop is not ported yet, ROADMAP
queue 1: train loop and checkpoints)."""
from .space import apply_train_knobs, train_knob_space
from .step import RunKnobs, init_train_state, make_train_step

__all__ = [n for n in dir() if not n.startswith("_")]
