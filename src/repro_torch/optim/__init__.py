"""AdamW and its learning-rate schedule (the reference's ``optim``)."""
from .adamw import AdamW, AdamWState, cosine_schedule, global_norm

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "global_norm"]
