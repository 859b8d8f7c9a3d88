"""PyTorch/CUDA port of the NxFP serving path (the JAX package ``repro`` is
the reference it is held against).

Layout mirrors the reference: ``core`` (formats, codec, packing, QTensor),
``kernels`` (hand-written CUDA kernels for Hopper + their plain PyTorch
versions), ``models`` (dense, SSM and hybrid families), ``configs``, ``serving``.

Entry points run on ``cuda`` by default and raise when CUDA is absent
unless the caller passes ``device="cpu"`` (as the CPU tests do). The
package never imports JAX or anything of ``repro``.
"""
from __future__ import annotations

import torch

# numerics are pinned once, at import: f32 matmuls and convolutions run in
# full f32 (no TF32), as the reference's f32 dots do
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (or defaulted to) and is not available;
    there is no silent CPU path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
