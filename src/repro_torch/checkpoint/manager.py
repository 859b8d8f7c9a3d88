"""Fault-tolerant checkpointing of the port's trees: parameter trees (a
list of per-layer dicts), QTensor leaves, ``TrainState`` (the reference's
``checkpoint/manager.py``).

  - atomic: a checkpoint is written to ``<dir>.tmp<pid>.<thread>``, its
    ``COMPLETE`` marker last, then renamed into place; a crash mid-write
    never leaves a directory that ``steps`` or ``load_pytree`` accepts.
  - async: one background thread writes host copies, so the train loop
    is not blocked on the disk; an error in it is raised by the next
    ``save``.
  - keep-k: only the newest ``keep`` complete checkpoints stay.
  - leaves are saved as ``.npy`` files with a JSON manifest of the tree's
    structure and each leaf's dtype (bf16 and the unsigned meta words as
    their same-width integer bits); a QTensor keeps its packed bytes, its
    meta and its aux fields.
  - a card's tensors cross to and from the host through one pinned
    staging buffer, ``STAGE_BYTES`` at a time (on an H100 host a
    pageable copy ran at ~2 GB/s, a pinned one at ~40 GB/s:
    ``scripts/host_copy_rates.py``; the host-side copy then sets the
    pace).
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.qtensor import QTensor
from ..tree import tree_leaves, tree_map, tree_structure, tree_unflatten

_MARKER = "COMPLETE"

# bytes of the pinned buffer a card's tensors are staged through
STAGE_BYTES = 1 << 28
_stage = None
_stage_lock = threading.Lock()

# dtypes numpy has no type for, saved as the integer type of their width
_BITS = {torch.bfloat16: torch.int16, torch.uint16: torch.int16,
         torch.uint32: torch.int32}
_DTYPES = {str(d): d for d in (torch.float32, torch.float16, torch.bfloat16,
                               torch.float64, torch.int64, torch.int32,
                               torch.int16, torch.int8, torch.uint8,
                               torch.uint16, torch.uint32, torch.bool)}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _staged_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` between the host and a card, contiguous tensors
    of one dtype, through the pinned staging buffer (each chunk's copy
    to or from the card is synchronous)."""
    global _stage
    d, s = _bytes(dst), _bytes(src)
    with _stage_lock:
        if _stage is None:
            _stage = torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                 pin_memory=True)
        for i in range(0, s.numel(), STAGE_BYTES):
            n = min(STAGE_BYTES, s.numel() - i)
            _stage[:n].copy_(s[i:i + n])
            d[i:i + n].copy_(_stage[:n])


def _to_host(x):
    """A host copy of a tensor (always a copy: training writes its
    tensors in place); QTensors and other leaves likewise."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cuda" or not x.is_contiguous():
            return x.to("cpu", copy=True)
        out = torch.empty(x.shape, dtype=x.dtype)
        _staged_copy(out, x)
        return out
    if isinstance(x, QTensor):
        return QTensor(_to_host(x.packed), _to_host(x.meta), x.fmt_name,
                       x.shape, x.axis, x.orig_len)
    return x


def _save_tensor(path: Path, t: torch.Tensor) -> str:
    t = t.detach().cpu()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    np.save(path, t.numpy())
    return path.name


def _load_tensor(path: Path, dtype: str, device) -> torch.Tensor:
    want = _DTYPES[dtype]
    if torch.device(device).type != "cuda":
        t = torch.from_numpy(np.load(path))
        return (t.view(want) if want in _BITS else t).to(device)
    # straight from the file's pages to the card ("c": copy-on-write, a
    # writable view that copies nothing)
    src = torch.from_numpy(np.load(path, mmap_mode="c"))
    out = torch.empty(src.shape, dtype=want, device=device)
    _staged_copy(out, src)
    return out


def save_pytree(tree, path: Path):
    """Write ``tree`` (tensors, QTensors, numpy arrays) to the directory
    ``path``, atomically. If ``path`` appears meanwhile (another writer),
    theirs is kept."""
    path = Path(path)
    tmp = path.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"treedef": tree_structure(tree), "leaves": []}
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, QTensor):
            _save_tensor(tmp / f"leaf{i}_packed.npy", leaf.packed)
            _save_tensor(tmp / f"leaf{i}_meta.npy", leaf.meta)
            if not isinstance(leaf.fmt_name, str):
                raise ValueError("only registry formats are checkpointed "
                                 f"(got {leaf.fmt_name!r})")
            manifest["leaves"].append({
                "kind": "qtensor", "fmt": leaf.fmt_name,
                "meta_dtype": str(leaf.meta.dtype),
                "shape": list(leaf.shape), "axis": leaf.axis,
                "orig_len": leaf.orig_len})
        elif isinstance(leaf, torch.Tensor):
            _save_tensor(tmp / f"leaf{i}.npy", leaf)
            manifest["leaves"].append({"kind": "tensor",
                                       "dtype": str(leaf.dtype)})
        else:
            np.save(tmp / f"leaf{i}.npy", np.asarray(leaf))
            manifest["leaves"].append({"kind": "array"})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / _MARKER).touch()
    if path.exists():
        shutil.rmtree(tmp)   # a concurrent writer won the race
        return
    os.rename(tmp, path)


def load_pytree(template, path: Path, device=None):
    """Restore into the structure of ``template`` (its values ignored):
    each tensor on its template leaf's device, or on ``device`` when
    given. Raises on an incomplete checkpoint or another structure."""
    path = Path(path)
    if not (path / _MARKER).exists():
        raise FileNotFoundError(f"incomplete checkpoint: {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["treedef"] != tree_structure(template):
        raise ValueError(f"{path} holds another tree structure than the "
                         "template's")
    out = []
    for i, (leaf, info) in enumerate(zip(tree_leaves(template),
                                         manifest["leaves"])):
        dev = device or getattr(leaf, "device", "cpu")
        if info["kind"] == "qtensor":
            out.append(QTensor(
                _load_tensor(path / f"leaf{i}_packed.npy", "torch.uint8",
                             dev),
                _load_tensor(path / f"leaf{i}_meta.npy", info["meta_dtype"],
                             dev),
                info["fmt"], tuple(info["shape"]), info["axis"],
                info["orig_len"]))
        elif info["kind"] == "tensor":
            out.append(_load_tensor(path / f"leaf{i}.npy", info["dtype"],
                                    dev))
        else:
            out.append(np.load(path / f"leaf{i}.npy"))
    return tree_unflatten(template, out)


class CheckpointManager:
    """Step-indexed checkpoints with keep-k GC and async save."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            try:
                save_pytree(tree, self.dir / f"step_{step:08d}")
                self._gc()
            except BaseException as e:  # raised by the next save()
                self._err = e

    def save(self, tree, step: int, block: bool = False):
        """Checkpoint ``tree`` as ``step``: a host copy now, written by
        the background thread (or here, with ``block``)."""
        if self._err:
            raise self._err
        host_tree = tree_map(_to_host, tree)
        if self._thread is None or block:
            save_pytree(host_tree, self.dir / f"step_{step:08d}")
            self._gc()
        else:
            self._q.put((host_tree, step))

    def steps(self):
        """The steps of the complete checkpoints, ascending (a write's
        ``.tmp`` directory is never one)."""
        return sorted(int(p.name[5:]) for p in self.dir.glob("step_*")
                      if re.fullmatch(r"step_\d+", p.name)
                      and (p / _MARKER).exists())

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None, device=None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in "
                                    f"{self.dir}")
        return load_pytree(template, self.dir / f"step_{step:08d}",
                           device), step

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def close(self):
        """Drain the queue and stop the thread; raises a write's error."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._err:
            raise self._err
