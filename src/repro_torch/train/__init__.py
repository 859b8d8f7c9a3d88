"""Training: the train state, the train / prefill / decode steps and the
simulated NxFP gradient cast (the reference's ``train``)."""
from .compress import simulate_compress
from .state import TrainState, init_state
from .step import make_decode_step, make_prefill_step, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "simulate_compress"]
