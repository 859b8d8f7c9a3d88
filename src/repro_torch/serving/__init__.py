"""Serving: the batched engine and the continuous-batching engine over
direct-cast weights and KV cache, and the JSONL event journal."""
from .engine import GenerationResult, ServeEngine, mask_chunk_emissions
from .events import EVENT_KINDS, Journal, emit, parse_event, replay
from .scheduler import (DECODING, PREFILLING, AdmissionPolicy,
                        ContinuousEngine, FifoPolicy, PriorityAdmission,
                        Request, RequestResult, ShortestPromptFirst,
                        SlotScheduler, Status, TtftDeadline)

__all__ = ["ServeEngine", "GenerationResult", "mask_chunk_emissions",
           "ContinuousEngine", "SlotScheduler", "Request", "RequestResult",
           "Status", "AdmissionPolicy", "FifoPolicy", "ShortestPromptFirst",
           "PriorityAdmission", "TtftDeadline", "PREFILLING", "DECODING",
           "Journal", "emit", "parse_event", "replay",
           "EVENT_KINDS"]
