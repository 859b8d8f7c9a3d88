"""Step-indexed, atomic, async checkpoints of the port's trees (the
reference's ``checkpoint``)."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
