"""Public wrappers for the NxFP kernels (the reference's ``kernels/ops.py``).

Dispatch is on the tensors' device: CPU tensors take each kernel's plain
PyTorch version, CUDA tensors launch the hand-written CUDA kernel (or raise
for inputs it does not take). There is no ``impl`` switch and no fallback
from a CUDA tensor to the plain version. The reference's tile constraints
(``_tile_ok``/``_pick_tile``) are TPU matters and are not ported: the CUDA
kernels read any block count and mask their ragged edges.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.qtensor import QTensor, fmt_key
from ..core.quantize import fake_quant, resolve_format, to_blocks
from .dense_attention import dense_decode_attention
from .nxfp_attention import nxfp_decode_attention
from .nxfp_matmul import nxfp_matmul, plain_product
from .nxfp_matmul_grouped import nxfp_matmul_grouped
from .nxfp_qq_matmul import nxfp_qq_matmul
from .nxfp_quantize import nxfp_quantize_pack

__all__ = ["qmatmul", "quantize_qtensor", "fake_quant_rows",
           "decode_attention", "decode_attention_dense", "router_matmul",
           "expert_matmul", "expert_bmm", "needs_grad"]

# above this many rows the bf16 product runs on row tiles of this height
DENSE_ROW_TILE = 128
DENSE_SMALL_M = 16


def needs_grad(*tensors) -> bool:
    """Autograd records this call: grad mode is on and an input requires
    grad. Only then does an op take its autograd ``Function``; every
    other call runs the serving route as it is."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _operand_grads(ctx, g, x_t, w_t, mm):
    """The reference's transpose of its rounded product (JAX's
    ``dot_general`` transpose): the f32 cotangent ``g`` times the other
    operand rounded to the product's dtype ``ctx.dtype``, in f32 (``mm``;
    ``x_t``/``w_t`` transpose the saved operands), rounded to that dtype,
    then to the operand's own."""
    x, w = ctx.saved_tensors
    dt = ctx.dtype
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = mm(g, w_t(w.to(dt).float())).to(dt).to(x.dtype)
    if ctx.needs_input_grad[1]:
        gw = mm(x_t(x.to(dt).float()), g).to(dt).to(w.dtype)
    return gx, gw


class _DenseMatmul(torch.autograd.Function):
    """``_dense_matmul`` under autograd: the forward is the serving route,
    bit for bit; the backward gives both operands' gradients with plain
    products (``_operand_grads``)."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.dtype = dtype
        ctx.save_for_backward(x, w)
        return _dense_route(x.to(dtype), w.to(dtype), dtype)

    @staticmethod
    def backward(ctx, g):
        lead = g.shape[:-1]
        g2 = g.reshape(-1, g.shape[-1]).float()

        def x_t(xr):
            return xr.reshape(-1, xr.shape[-1]).T

        gx, gw = _operand_grads(ctx, g2, x_t, lambda wr: wr.T, torch.mm)
        if gx is not None:
            gx = gx.reshape(*lead, gx.shape[-1])
        return gx, gw, None


def _dense_matmul(x, w, dtype=torch.bfloat16):
    """dtype(x) @ dtype(w) with f32 accumulation and an f32 result (bf16
    by default; the MoE router's product runs in f32).

    On CUDA a plain product outside any kernel (the reference leaves it to
    XLA): cuBLAS with f32 accumulation and an f32 output. cuBLAS picks its
    kernel, and with it the order of a row's sums, from the shape, so
    above ``DENSE_SMALL_M`` rows the product runs on fixed (128, K) row
    tiles, the last one zero-padded: every call cuBLAS sees has one shape
    whatever M is, and a prompt row gets the same bits whole or in the
    chunked-prefill lane's chunks of more than 16 rows. Up to 16 rows (a
    decode batch, a short lane chunk) it is one call on exactly 16 rows,
    those past x's zero: cuBLAS may take another kernel at one row than
    at four (Hymba's head, N 32001, gave other bits at B 1 and B 4), and
    one shape keeps a row's bits whatever the batch
    (``scripts/batch_invariance.py --dense``). Under autograd the same
    route runs in ``_DenseMatmul``."""
    if needs_grad(x, w):
        return _DenseMatmul.apply(x, w, dtype)
    return _dense_route(x.to(dtype), w.to(dtype), dtype)


def _dense_route(xb, wb, dtype):
    """``_dense_matmul`` of the operands rounded to ``dtype``."""
    if xb.device.type == "cuda":
        kw = {} if dtype == torch.float32 else {"out_dtype": torch.float32}
        lead = xb.shape[:-1]
        x2 = xb.reshape(-1, xb.shape[-1])
        m, n = x2.shape[0], wb.shape[-1]
        if m <= DENSE_SMALL_M:
            if m < DENSE_SMALL_M:
                x2 = F.pad(x2, (0, 0, 0, DENSE_SMALL_M - m))
            y = torch.mm(x2, wb, **kw)
            return y[:m].reshape(*lead, n)
        tiles = -(-m // DENSE_ROW_TILE)
        if tiles * DENSE_ROW_TILE != m:
            x2 = F.pad(x2, (0, 0, 0, tiles * DENSE_ROW_TILE - m))
        y = torch.empty((tiles * DENSE_ROW_TILE, n), dtype=torch.float32,
                        device=xb.device)
        for i in range(0, tiles * DENSE_ROW_TILE, DENSE_ROW_TILE):
            torch.mm(x2[i:i + DENSE_ROW_TILE], wb, out=y[i:i + DENSE_ROW_TILE],
                     **kw)
        return y[:m].reshape(*lead, n)
    # bf16 x bf16 products are exact in f32, so an f32 matmul of the
    # rounded operands is the reference's bf16 dot with f32 accumulation
    lead = xb.shape[:-1]
    y = plain_product(xb.float().reshape(-1, xb.shape[-1]), wb.float())
    return y.reshape(*lead, wb.shape[-1])


def router_matmul(x, w):
    """The MoE router's f32 product x (..., D) @ w (D, E), f32 throughout
    (TF32 is off: ``repro_torch`` pins it). It runs as ``_dense_matmul``
    does, on 16 zero-padded rows up to 16 and fixed 128-row tiles above,
    so a row routes to the same experts at every batch size: a slot's
    stream stays its solo stream."""
    return _dense_matmul(x, w, torch.float32)


def qmatmul(x, w):
    """x (..., K) @ w, where w is a QTensor (quantized along axis 0 of
    (K, N)) or a dense (K, N) tensor. Returns (..., N) f32.

    ``x`` may itself be a QTensor quantized along axis -1 (a prefill
    activation from ``quantize_qtensor``): with a quantized ``w`` the GEMM
    runs quantized x quantized; with a dense ``w`` the activation is
    decoded once to bf16 and takes the dense product."""
    if isinstance(x, QTensor):
        return _qact_matmul(x, w)
    if not isinstance(w, QTensor):
        return _dense_matmul(x, w)
    n, kb, _ = w.packed.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    k_pad = kb * w.fmt.block_size
    if x2.shape[-1] < k_pad:  # quantization padded K to a block multiple
        x2 = F.pad(x2, (0, k_pad - x2.shape[-1]))
    return nxfp_matmul(x2, w.packed, w.meta, w.fmt).reshape(*lead, n)


def expert_matmul(x, expert, w: QTensor):
    """Routed rows through their experts' quantized weights: x (R, K), one
    row per (token, routed expert); expert (R,) int32, the row's expert or
    -1 for a dropped row; w an expert stack (E, K, N) cast along axis -2.
    Returns (R, N) f32, zero rows where ``expert`` is -1. On CUDA one
    launch of the dequant GEMM's grouped instance, which reads the routing
    on the device; each row has the bits ``qmatmul`` gives it against its
    expert's weight at up to 16 rows."""
    kb = w.packed.shape[-2]
    k_pad = kb * w.fmt.block_size
    if x.shape[-1] < k_pad:  # quantization padded K to a block multiple
        x = F.pad(x, (0, k_pad - x.shape[-1]))
    return nxfp_matmul_grouped(x, expert, w.packed, w.meta, w.fmt)


class _ExpertBmm(torch.autograd.Function):
    """``expert_bmm`` under autograd: the forward is the serving route,
    bit for bit; the backward gives both operands' gradients with plain
    batched products (``_operand_grads``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.dtype = torch.bfloat16
        ctx.save_for_backward(x, w)
        return _expert_bmm_route(x.to(torch.bfloat16), w.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        gx, gw = _operand_grads(ctx, g.float(), lambda xr: xr.transpose(1, 2),
                                lambda wr: wr.transpose(1, 2), torch.bmm)
        return gx, gw


def expert_bmm(x, w):
    """Dense (bf16) experts: x (E, C, K) @ w (E, K, N) -> (E, C, N) f32,
    both rounded to bf16, f32 accumulation. On CUDA one ``torch.bmm`` (a
    plain product outside any kernel, as the reference's XLA einsum is);
    a row's bits depend on C, which the caller keeps fixed where they must
    not follow the batch. On the CPU one product a row (``plain_product``)
    per expert. Under autograd the same route runs in ``_ExpertBmm``."""
    if needs_grad(x, w):
        return _ExpertBmm.apply(x, w)
    return _expert_bmm_route(x.to(torch.bfloat16), w.to(torch.bfloat16))


def _expert_bmm_route(xb, wb):
    """``expert_bmm`` of the bf16-rounded operands."""
    if xb.device.type == "cuda":
        return torch.bmm(xb, wb, out_dtype=torch.float32)
    return torch.stack([plain_product(xb[e].float(), wb[e].float())
                        for e in range(xb.shape[0])])


def _qact_matmul(xq: QTensor, w):
    """Quantized-activation GEMM (``xq`` quantized along axis -1)."""
    if xq.axis != -1:
        raise ValueError(f"activation QTensor must quantize axis -1, "
                         f"got {xq.axis}")
    if not isinstance(w, QTensor):
        return qmatmul(xq.dequantize(torch.bfloat16), w)
    kb, bpb = xq.packed.shape[-2:]
    y = nxfp_qq_matmul(xq.packed.reshape(-1, kb, bpb),
                       xq.meta.reshape(-1, kb), w.packed, w.meta, xq.fmt,
                       w.fmt)
    return y.reshape(*xq.shape[:-1], w.packed.shape[0])


def quantize_qtensor(x, fmt, axis: int = -1, device=None,
                     table: bool = False) -> QTensor:
    """Direct-cast a dense tensor to a QTensor (fused encode + pack).

    ``device`` is where the cast runs: ``cuda`` unless the caller says
    otherwise (the input is moved there first). Raises when CUDA is asked
    for and absent. The encoder is the one the reference serves with
    (``core.quantize.encode_blocks``: the arithmetic one; the serving
    engines' ``load_params``), or with ``table`` the reference's default
    cast, ``QTensor.quantize``: the table-driven ``quantize_blocks`` (a
    value on a midpoint takes the lower level), which its
    ``direct_cast_tree`` uses when given no ``quantize_fn`` (the paper's
    figures). On CUDA both run the quantizer kernel.
    """
    return _cast(x.to(resolve_device(device)), resolve_format(fmt), axis,
                 table)


def _cast(x, fmt, axis: int, table: bool = False) -> QTensor:
    """``x`` cast to a QTensor along ``axis`` where it lies (the encoder's
    rules: ``nxfp_quantize_pack``'s ``table``)."""
    axis = axis if axis < 0 else axis - x.ndim
    xb, orig = to_blocks(x, fmt.block_size, axis)
    flat = xb.reshape(-1, fmt.block_size)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.to(torch.float32)       # the kernel reads bf16 or f32
    flat = flat.contiguous()
    packed, meta = nxfp_quantize_pack(flat, fmt, table=table)
    packed = packed.reshape(*xb.shape[:-1], packed.shape[-1])
    meta = meta.reshape(xb.shape[:-1])
    return QTensor(packed, meta, fmt_key(fmt), tuple(x.shape), axis, orig)


def fake_quant_rows(x, fmt):
    """The direct-cast round trip of ``x`` along its last axis, in its
    dtype (``core.quantize.fake_quant(x, fmt, axis=-1)``, the reference's
    quantized-KV simulation). CPU tensors take ``fake_quant`` itself.
    CUDA tensors are cast by the quantizer kernel and decoded
    (``QTensor.dequantize``). ``fake_quant`` encodes with the table-driven
    ``quantize_blocks`` (a value on a midpoint takes the lower level, where
    the serving cast rounds half to even), so the kernel runs its
    table-driven rules (``nxfp_quantize_pack(table=True)``): the same
    codes, for every format. The activation formats (asym, ox) have no
    table form, and the kernel's arithmetic encoder is ``fake_quant``'s
    there."""
    if x.device.type != "cuda":
        return fake_quant(x, fmt, axis=-1)
    return _cast(x, resolve_format(fmt), -1, table=True).dequantize(x.dtype)


def decode_attention(q, kq: QTensor, vq: QTensor, lengths, n_kv_heads: int):
    """Single-token attention over a quantized KV cache.

    q (B, H, D) unscaled query; kq/vq QTensors of the (B, S, KVH, D) cache
    quantized along axis -1; lengths (B,) valid context lengths.
    Returns (B, H, D) f32.
    """
    b, h, d = q.shape
    g = h // n_kv_heads
    qg = (q.reshape(b, n_kv_heads, g, d).to(torch.float32)
          * float(np.float32(1.0 / np.sqrt(d))))
    fmt = kq.fmt
    # quantization pads head_dim to a block multiple; pad q to match (the
    # padded K dims dequantize to 0, so scores are unchanged) and slice out
    d_pad = kq.packed.shape[-2] * fmt.block_size
    if d_pad != d:
        qg = F.pad(qg, (0, d_pad - d))
    out = nxfp_decode_attention(qg.contiguous(), kq.packed, kq.meta,
                                vq.packed, vq.meta, lengths, fmt)
    return out[..., :d].reshape(b, h, d)


def decode_attention_dense(q, k, v, lengths, n_kv_heads: int):
    """Single-token attention over a dense cache: q (B, H, D) unscaled,
    k/v (B, S, KVH, D) bf16, lengths (B,). Returns (B, H, D) f32. The
    query is scaled as the reference's dense branch scales it (f32, by
    ``D ** -0.5``); head_dim is not padded."""
    b, h, d = q.shape
    qg = q.reshape(b, n_kv_heads, h // n_kv_heads, d).to(torch.float32) \
        * (d ** -0.5)
    return dense_decode_attention(qg, k, v, lengths).reshape(b, h, d)
