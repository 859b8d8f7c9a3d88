"""Serving: the batched engine, the continuous-batching engine (with
bounded-queue shedding, per-slot tiers, a paged KV cache,
self-speculative decoding, suspension, preemption and checkpoints
through slot snapshots, and seeded faults with quarantine and the KV/SSM
canaries), the slot-sharded engines over several devices, over
direct-cast weights and KV cache, and the JSONL event journal."""
from .engine import GenerationResult, ServeEngine, mask_chunk_emissions
from .events import EVENT_KINDS, Journal, emit, parse_event, replay
from .faults import Fault, FaultPlan, flip_kv_bytes
from .paged import NULL_PAGE, PagePool, auto_page_size
from .paged_engine import (PagedContinuousEngine,
                           ShardedPagedContinuousEngine)
from .scheduler import (DECODING, PREFILLING, AdmissionPolicy,
                        ContinuousEngine, DegradeOverBudget, DropOldest,
                        FifoPolicy, PreemptionPolicy, PriorityAdmission,
                        PriorityPreemption, RejectNew, Request,
                        RequestResult, ShardedSlotScheduler, SheddingPolicy,
                        ShortestPromptFirst, SlotScheduler, Status,
                        TtftDeadline)
from .sharded import ShardedContinuousEngine
from .snapshot import (SlotSnapshot, load_checkpoint, pack_device_state,
                       save_checkpoint, slot_row_capacity, take_owner_row,
                       unpack_device_state)
from .speculative import SpeculativeConfig
from .tiers import (TieredContinuousEngine, TierSpec, default_tiers,
                    kv_row_bytes, repack_kv)

__all__ = ["ServeEngine", "GenerationResult", "mask_chunk_emissions",
           "ContinuousEngine", "SlotScheduler", "Request", "RequestResult",
           "Status", "AdmissionPolicy", "FifoPolicy", "ShortestPromptFirst",
           "PriorityAdmission", "TtftDeadline", "PREFILLING", "DECODING",
           "SheddingPolicy", "RejectNew", "DropOldest", "DegradeOverBudget",
           "PreemptionPolicy", "PriorityPreemption", "SlotSnapshot",
           "save_checkpoint", "load_checkpoint",
           "PagedContinuousEngine", "PagePool", "auto_page_size",
           "NULL_PAGE", "ShardedContinuousEngine", "ShardedSlotScheduler",
           "ShardedPagedContinuousEngine", "take_owner_row",
           "TieredContinuousEngine", "TierSpec", "default_tiers",
           "kv_row_bytes", "repack_kv", "pack_device_state",
           "unpack_device_state", "slot_row_capacity",
           "Journal", "emit", "parse_event", "replay",
           "EVENT_KINDS", "SpeculativeConfig", "Fault", "FaultPlan",
           "flip_kv_bytes"]
