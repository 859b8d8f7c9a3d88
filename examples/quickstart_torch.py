"""Quickstart for the PyTorch/CUDA port: the format zoo, a direct cast,
a dequantization matmul.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU

On the card every step runs the port's CUDA kernels (the quantizer and
the dequant GEMM); ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import get_format, level_table
from repro_torch.kernels import qmatmul, quantize_qtensor

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu for the plain versions")
dev = resolve_device(ap.parse_args().device)   # raises without a card
rng = np.random.default_rng(0)

# --- 1. the format zoo -----------------------------------------------------
for name in ["bfp4", "mxfp4", "nxfp4", "nxfp4_nm", "nxfp6", "mxfp3",
             "nxfp3", "nxfp4_bs64"]:
    f = get_format(name)
    print(f"{name:10s} bits/value={f.bits_per_value:.3f} "
          f"block={f.block_size} NM={f.nm} AM={f.am} CR={f.cr}")
print("MxFP4 levels:", level_table("e2m1", cr=False).values_sorted)
print("NxFP4 adds the recycled level:",
      level_table("e2m1", cr=True).values_sorted)
print("NxFP3 (e2m0) levels:", level_table("e2m0", cr=True).values_sorted)

# --- 2. direct-cast a weight matrix (Algorithm 1) ---------------------------
w = torch.from_numpy((rng.standard_normal((512, 256)) * 0.05).astype(
    np.float32)).to(dev)
for name in ["mxfp4", "nxfp4", "mxfp3", "nxfp3"]:
    qt = quantize_qtensor(w, name, axis=0, device=dev)
    err = float(torch.mean(torch.square(qt.dequantize(torch.float32) - w)))
    bits = 8 * qt.nbytes() / w.numel()
    print(f"{name}: packed {qt.nbytes()} bytes ({bits:.2f} bits/value), "
          f"mse={err:.3e}")

# --- 3. on-the-fly dequantization matmul (paper Fig. 7) --------------------
x = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32)).to(dev)
ref = x @ w
for name in ["nxfp4", "nxfp3"]:
    qt = quantize_qtensor(w, name, axis=0, device=dev)
    y = qmatmul(x, qt)              # the CUDA dequant GEMM on the card
    rel = float(torch.max(torch.abs(y - ref)) / torch.max(torch.abs(ref)))
    print(f"qmatmul {name} vs dense: rel err {rel:.3%} "
          "(max-normalised; ~8-12% at 4-bit is normal, more at 3-bit)")
print(f"ran on {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                         if dev.type == "cuda" else ""))
