"""Shared model machinery: config, init helpers, norms, rotary, dense layer.

Parameters are nested dicts of tensors (or QTensor after direct-cast);
every layer is a function (cfg, params, x, ...) -> y. Unlike the
reference, which stacks layers on a leading axis for ``lax.scan``, the
port keeps one dict per layer in a list and loops over it in Python.

Numerics follow the reference operation for operation: activations are
bf16 (``cfg.dtype``), norms and the SiLU run in f32 on bf16-rounded
inputs, and every GEMM returns f32 before the cast to its output dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.qtensor import QTensor, QuantPolicy, _map_with_path
from ..core.quantize import resolve_format
from ..kernels.ops import needs_grad, qmatmul, quantize_qtensor

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ModelConfig for the families the port serves:
    dense (Llama-style GQA, optionally sliding-window), moe (GQA and a
    routed-expert SwiGLU FFN, optionally a shared MLP beside it), ssm
    (Mamba-1, attention-free), hybrid (windowed GQA and a Mamba head in
    parallel in every layer), vlm (dense layers with a cross-attention
    layer to stub patch embeddings every ``cross_attn_every``-th) and
    audio (an encoder over stub frame embeddings, decoder layers that
    cross-attend to its output)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None   # SWA: a window-sized ring cache
    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    n_experts_padded: int = 0      # dead-expert padding; 0 -> n_experts
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0               # 0 -> 2 * d_model
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    conv_width: int = 4
    ssm_chunk: int = 256           # the selective scan's chunk length
    # --- VLM ---
    cross_attn_every: int = 0      # every k-th layer is cross-attention
    n_vision_tokens: int = 0
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_audio_frames: int = 0
    dtype: Any = torch.bfloat16
    # fake-quantize prefill K/V to this format (the paper's section 7.1
    # quantized-KV simulation, ``attention.self_attention``); None: off
    kv_sim_fmt: Optional[str] = None
    # activation checkpointing per layer in ``lm.forward_train``
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def dinner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def attn_free(self) -> bool:
        """No attention and no K/V cache: the ssm family."""
        return self.family == "ssm"

    @property
    def has_mamba(self) -> bool:
        """Every layer runs a Mamba block: the ssm and hybrid families."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count, embeddings included: the reference's
        formula, equal to its value for every family. It is not the size
        of the tree ``lm.init_params`` builds: for vlm it counts each
        cross layer's attention twice (a cross layer has its cross
        projections and no self attention), and for audio no decoder
        layer's cross attention."""
        d, hd, h, kvh = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * h + 2 * d * hd * kvh + hd * h * d
        mlp = 3 * d * self.d_ff
        di, n, dr = self.dinner, self.ssm_state, self.dtrank
        mamba = (d * 2 * di + di * (dr + 2 * n) + dr * di
                 + di * self.conv_width + di * n + 2 * di + di * d)
        moe = (self.n_experts * 3 * d * self.d_ff + 3 * d * self.shared_d_ff
               + d * self.n_experts)
        per_layer = {"ssm": mamba, "hybrid": attn + mamba + mlp,
                     "moe": attn + moe}.get(self.family, attn + mlp)
        total = self.n_layers * per_layer + 2 * self.vocab * d
        if self.family == "vlm" and self.cross_attn_every:
            total += (self.n_layers // self.cross_attn_every) * attn
        return total + self.n_enc_layers * (attn + mlp)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def ninit(gen: torch.Generator, shape, scale: float = 0.02,
          dtype=torch.float32):
    """Normal(0, scale) weights drawn from ``gen`` on ``gen.device``: f32
    draws scaled in place (one f32 copy of the leaf at a time), then
    ``dtype``."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int, n_layers: int):
    out_scale = 0.02 / math.sqrt(2 * n_layers)
    return {
        "mlp_w1": ninit(gen, (d, ff)),
        "mlp_w3": ninit(gen, (d, ff)),
        "mlp_w2": ninit(gen, (ff, d), scale=out_scale),
    }


def init_attn(gen: torch.Generator, cfg: ModelConfig):
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "wq": ninit(gen, (d, h * hd)),
        "wk": ninit(gen, (d, kvh * hd)),
        "wv": ninit(gen, (d, kvh * hd)),
        "wo": ninit(gen, (h * hd, d), scale=out_scale),
    }


def cast_params(tree, policy: QuantPolicy, device, path: str = ""):
    """The leaves of a parameter (sub)tree as the engines store them under
    ``policy``, on ``device``; ``path`` is the subtree's path in the whole
    tree (``"layers/3"``), which the policy's patterns read.

    With a weight format, the leaves the policy matches are direct-cast
    there by the fused quantizer (``kernels.ops.quantize_qtensor``), one
    at a time. Without one, the leaves a cast would replace are stored in
    bf16: each only ever enters a GEMM that rounds it to bf16 first, so the
    stored rounding changes no result and halves an f32 tree. Other leaves
    keep their dtype. A leaf that is already a QTensor passes through as
    it is (a tree built cast, ``lm.init_params(policy=)``, or one cast
    before; a policy without a weight format serves it as it is cast),
    unless the policy's weight format is another: that raises ValueError,
    naming the leaf, since re-casting a cast leaf would quantize twice."""
    want = policy.weight_fmt and resolve_format(policy.weight_fmt)

    def leaf(name, x):
        if isinstance(x, QTensor):
            if want and x.fmt != want:
                raise ValueError(
                    f"{name} is cast to {x.fmt.name}; the policy asks for "
                    f"weight_fmt={policy.weight_fmt!r}: cast the f32 "
                    "weights instead")
            return dataclasses.replace(x, packed=x.packed.to(device),
                                       meta=x.meta.to(device))
        if not isinstance(x, torch.Tensor):
            return x
        if not want:
            if policy.castable(name, x):
                return x.to(device=device, dtype=torch.bfloat16)
            return x.to(device)
        x = x.to(device)
        if policy.matches(name, x):
            return quantize_qtensor(x, policy.weight_fmt, policy.axis,
                                    device=device)
        return x

    return _map_with_path(leaf, tree, path)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

# up to this many rows (a decode step's batch), a row reduction runs over
# exactly this many rows (``mean_square``)
ROW_GROUP = 16


def _mean_square_rows(x):
    """``mean_square``'s forward (its docstring): the fixed two-stage sum
    over at least ``ROW_GROUP`` rows. Returns (means (..., 1), the f32
    rows (n, d))."""
    rows = x.to(torch.float32).reshape(-1, x.shape[-1])
    n, d = rows.shape
    sq = torch.empty((max(n, ROW_GROUP), d), dtype=torch.float32,
                     device=rows.device)
    torch.square(rows, out=sq[:n])
    parts = math.gcd(d, 32)
    part = torch.sum(sq.reshape(-1, d // parts), dim=-1)
    total = torch.sum(part.reshape(-1, parts), dim=-1)
    return (total[:n] / d).reshape(*x.shape[:-1], 1), rows


class _MeanSquare(torch.autograd.Function):
    """``mean_square`` under autograd: the forward is the no-grad route,
    bit for bit (the ``out=`` square into the ``ROW_GROUP`` buffer has no
    derivative of its own); the backward is the reference's, 2 x g / d on
    the real rows (the buffer's unset rows are never read)."""

    @staticmethod
    def forward(ctx, x):
        out, rows = _mean_square_rows(x)
        ctx.save_for_backward(rows)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        d = rows.shape[-1]
        gx = (g.reshape(-1, 1) / d) * (2.0 * rows)
        return gx.reshape(ctx.x_shape).to(ctx.x_dtype)


def mean_square(x):
    """mean(x^2) over the last axis in f32, keeping it (..., 1).

    A row's sum must not depend on how many rows share the call: a decode
    row's norm on the batch (a continuous slot's stream would fork from
    the request served alone), a prompt row's on whether the prompt runs
    whole or in the chunked-prefill lane's chunks. CUDA's reduction kernel
    picks its thread layout, and with it the order of a row's sums, from
    the number of rows (``scripts/batch_invariance.py`` measures it). So a
    row is summed in two stages of fixed shape, partial sums of up to 32
    parts and then their total, over at least ``ROW_GROUP`` rows: fewer
    rows run on a buffer of exactly that many (its rows past ``x``'s are
    left unset; each row is reduced on its own and theirs are sliced
    off), where one reduction over 16 long rows gives each row a single
    warp, as it does over more rows. Under autograd the same sums run in
    ``_MeanSquare``."""
    if needs_grad(x):
        return _MeanSquare.apply(x)
    return _mean_square_rows(x)[0]


def rmsnorm(x, scale, eps: float):
    xf = x.to(torch.float32)
    var = mean_square(xf)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def dense(x, w, out_dtype=None):
    """Matmul against a dense or quantized (QTensor, axis=-2) weight: f32
    out of the GEMM, then cast to ``out_dtype or x.dtype``.

    ``x`` may be a quantized activation (QTensor, axis=-1), the quantized
    x quantized prefill; it then needs an explicit ``out_dtype``."""
    if isinstance(x, QTensor) and out_dtype is None:
        raise ValueError("a QTensor activation needs an explicit out_dtype")
    return qmatmul(x, w).to(out_dtype or x.dtype)


def dense_rows(x, w, out_dtype=None):
    """``dense`` on groups of at most ``ROW_GROUP`` rows of x (..., K).

    Used by the speculative verify alone (``blocks.layer_verify``), whose
    B * Q rows must each get the bits a decode step's B rows get: on the
    card a decode step runs every product at M = B <= 16, where the
    dequant GEMM takes its split-K regime (its plan the same at every M up
    to 16) and a bf16 weight one product on exactly 16 rows; more rows in
    one call would run wgmma, or cuBLAS on 128-row tiles, which sum a row
    in another order. The weights are read once per group, ceil(B * Q /
    16) times."""
    rows = x.reshape(-1, x.shape[-1])
    out = torch.cat([dense(rows[i:i + ROW_GROUP], w, out_dtype=out_dtype)
                     for i in range(0, rows.shape[0], ROW_GROUP)])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def qact(x, act_fmt: Optional[str]):
    """Quantize an activation along its feature axis for the qq GEMM, on
    the device it lies on; ``act_fmt=None`` is the identity."""
    if act_fmt is None:
        return x
    return quantize_qtensor(x, act_fmt, axis=-1, device=x.device)


def scale_like(x, s: float):
    """``x * s`` with ``s`` rounded to x's dtype first, as JAX treats a
    Python scalar against a bf16 array (weak typing). The rounded scalar
    stays a 0-dim CPU tensor, which a CUDA op reads on the host: no copy
    to the card, so the op is capturable in a CUDA graph."""
    return x * torch.tensor(s, dtype=x.dtype)


def rope_freqs(positions, head_dim: int, theta: float):
    """positions (...,) int -> (cos, sin) each (..., head_dim//2) f32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (ar / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., T, H, D); cos/sin (..., T, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x, w1, w3, w2, act_fmt: Optional[str] = None, mm=dense):
    """SwiGLU MLP: silu(x W1) * (x W3), then W2; SiLU in f32 on the
    bf16-rounded projections. ``act_fmt`` encodes the input once for W1
    and W3 and the gated hidden once for W2 (qq prefill). ``mm`` is the
    product (``dense_rows`` in the speculative verify)."""
    xq = qact(x, act_fmt)
    h = (F.silu(mm(xq, w1, out_dtype=x.dtype).to(torch.float32))
         * mm(xq, w3, out_dtype=x.dtype).to(torch.float32))
    return mm(qact(h.to(x.dtype), act_fmt), w2, out_dtype=x.dtype)
