"""Training: the train state, the train / prefill / decode steps, the
packed NxFP gradient wire over a mesh's pods and its numerics on one
device (the reference's ``train``)."""
from .compress import make_pod_grad_fn, simulate_compress
from .state import TrainState, init_state
from .step import make_decode_step, make_prefill_step, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "simulate_compress",
           "make_pod_grad_fn"]
