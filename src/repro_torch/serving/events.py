"""Structured JSONL serving events on the standard ``repro_torch.serving``
loggers (a copy of the reference's ``serving/events.py``; the port keeps
its own).

Scheduler and engine transitions (admit, finish and the lifecycle kinds)
are logged as ONE ``json.dumps`` object per record, so a serving run
leaves a machine-parseable trail behind the ordinary logging tree: handlers, filters and levels keep working unchanged, and
human-oriented messages coexist on the same loggers. ``parse_event`` is
the read side: feed it captured log messages and it returns the event
dicts, skipping the human text.

``Journal`` makes the stream a recovery log: one monotonic per-engine
sequence number stamped on every record. A replayed journal with a hole
in its sequence is a journal that lost records; ``replay`` surfaces the
gaps instead of silently reordering around them.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional, Tuple

__all__ = ["emit", "parse_event", "Journal", "replay", "EVENT_KINDS"]

# Every kind the reference's engines and scheduler emit, and the port's
# too: fault and containment kinds (fault, quarantine, requeue), recovery
# kinds (suspend through restore; migrate and drain are the sharded
# engine's shard drain), paged-KV memory kinds (pool, cow-break,
# prefix-hit) and the tiered engine's kv-repack.
EVENT_KINDS = ("admit", "prefill-start", "prefill-done", "degrade",
               "shed", "expire", "cancel", "fault", "quarantine",
               "requeue", "finish", "suspend", "resume", "preempt",
               "migrate", "drain", "checkpoint", "restore", "spec-k",
               "pool", "cow-break", "prefix-hit", "kv-repack")


def emit(logger, event: str, **fields) -> None:
    """Log one structured JSONL event record at INFO on ``logger``.

    The record is ``{"event": <event>, **fields}`` serialized as a single
    JSON object (sorted keys, None-valued fields dropped — absent beats
    null for grep-ability).  Numpy scalars coerce through ``float``.
    """
    rec = {"event": event}
    rec.update({k: v for k, v in fields.items() if v is not None})
    logger.info("%s", json.dumps(rec, sort_keys=True, default=float))


def parse_event(message: str) -> Optional[dict]:
    """Parse one logged message back into its event dict.

    Returns None for anything that is not a JSONL event record — the
    serving loggers intentionally carry human-oriented text too, so the
    postmortem reader filters rather than asserts.
    """
    if not message.lstrip().startswith("{"):
        return None
    try:
        obj = json.loads(message)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) and "event" in obj else None


class Journal:
    """Monotonic sequence numbers over ``emit`` — the engine's event log.

    One Journal per engine; the engine and its scheduler share it so
    every record lands in ONE total order.  ``seq`` is the next number to
    stamp; starting from a persisted ``seq`` continues the sequence
    (re-used numbers from a lost tail dedupe on replay; true losses show
    up as gaps).
    """

    def __init__(self, start: int = 0):
        self.seq = int(start)

    def emit(self, logger, event: str, **fields) -> None:
        emit(logger, event, seq=self.seq, **fields)
        self.seq += 1


def replay(messages: Iterable[str]) -> Tuple[List[dict], List[int]]:
    """Reconstruct an ordered journal from captured log messages.

    Returns ``(events, gaps)``: sequenced events sorted by ``seq``
    (duplicates collapse: a restarted journal may re-issue numbers),
    followed by any un-sequenced
    records, and the list of missing sequence numbers between the
    lowest and highest observed.  A non-empty ``gaps`` means the
    recovery log lost records and replay-derived state is suspect.
    """
    evs = [e for e in (parse_event(m) for m in messages) if e is not None]
    by_seq = {}
    rest = []
    for e in evs:
        if isinstance(e.get("seq"), int):
            by_seq.setdefault(e["seq"], e)
        else:
            rest.append(e)
    ordered = [by_seq[s] for s in sorted(by_seq)]
    gaps: List[int] = []
    if by_seq:
        lo, hi = min(by_seq), max(by_seq)
        gaps = [s for s in range(lo, hi + 1) if s not in by_seq]
    return ordered + rest, gaps
