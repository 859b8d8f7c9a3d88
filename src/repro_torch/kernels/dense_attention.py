"""Flash-decode attention of one query token over a dense bf16 KV cache.

CUDA kernel: the dense-row instance of ``csrc/nxfp_attention.cu``
(``nxfp_dense_attention_launch``). It replaces the reference's dense
branch of ``models/kvcache.py:attend_decode`` (an einsum that XLA runs)
on the card, where the einsum is a batched cuBLAS product whose reduction
follows the batch: 3715 of 4096 outputs of a decode row moved between B 1
and B 4 at S 512 on the H100, and a continuous slot's stream forked from
the request served alone. The kernel is the packed instance with another
tile loader: the split plan (``nxfp_attention.attention_split``, from S
and the KV heads only), the online softmax and the split-order merge are
the same, so a row's bits do not depend on the batch.

Plain version: ``dense_decode_attention_plain``, the reference's einsum,
f32 scores, the -1e30 mask and a softmax over the whole cache.
"""
from __future__ import annotations

import torch

from . import build
from .nxfp_attention import _split_plan

__all__ = ["dense_decode_attention", "dense_decode_attention_plain"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
_NEG = -1e30


def dense_decode_attention_plain(q, k, v, lengths):
    """q (B, KVH, G, D) f32 pre-scaled; k, v (B, S, KVH, D) -> (B, KVH,
    G, D) f32 (the reference's dense ``attend_decode``)."""
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.to(torch.float32))
    s = k.shape[1]
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))


def dense_decode_attention(q, k, v, lengths):
    """q (B, KVH, G, D) f32 (scaled by 1/sqrt(head_dim)); k, v (B, S, KVH,
    D) bf16, D a multiple of 8 (no padding: head_dim 120 runs as it is);
    lengths (B,) int. Returns (B, KVH, G, D) f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global LAUNCHES
    if not build.on_cuda(q, k, v, lengths):
        return dense_decode_attention_plain(q, k, v, lengths)
    b, kvh, g, d = q.shape
    bb, s, kvh2, d2 = k.shape
    build.require((bb, kvh2, d2) == (b, kvh, d) and v.shape == k.shape,
                  f"q {tuple(q.shape)} vs cache {tuple(k.shape)} / "
                  f"{tuple(v.shape)}")
    build.require(d % 8 == 0, f"head_dim {d} is not a multiple of 8")
    build.require(k.dtype == v.dtype == torch.bfloat16
                  and k.is_contiguous() and v.is_contiguous()
                  and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                  "cache must be contiguous 16-byte-aligned bf16")
    qc = q.to(torch.float32).contiguous()
    lens = lengths.to(torch.int32).reshape(b).contiguous()
    lib = build.library()           # raises first where there is no card
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    splits, tps, ws, counters = _split_plan(q.device, b, kvh, g, d, s)
    rc = lib.nxfp_dense_attention_launch(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, s, kvh, g, d, splits, tps,
        0 if ws is None else ws.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        build.stream_handle(q.device))
    build.check(rc, "nxfp_dense_attention")
    LAUNCHES += 1
    return out
