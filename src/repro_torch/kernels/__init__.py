"""NxFP kernels: hand-written CUDA for Hopper (``csrc/``), each with its
plain PyTorch version, and the public wrappers in ``ops``."""
from . import (dense_attention, nxfp_attention, nxfp_matmul,
               nxfp_matmul_grouped, nxfp_qq_matmul, nxfp_quantize)
from .ops import (decode_attention, decode_attention_dense, expert_matmul,
                  qmatmul, quantize_qtensor)

# the modules that hold a kernel and its launch counter (``LAUNCHES``)
KERNEL_MODULES = (nxfp_quantize, nxfp_matmul, nxfp_attention,
                  nxfp_qq_matmul, dense_attention, nxfp_matmul_grouped)


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.LAUNCHES = 0


def launch_counts() -> dict:
    return {mod.__name__.rsplit(".", 1)[-1]: mod.LAUNCHES
            for mod in KERNEL_MODULES}


__all__ = ["qmatmul", "quantize_qtensor", "decode_attention",
           "decode_attention_dense", "expert_matmul",
           "KERNEL_MODULES", "reset_launch_counts", "launch_counts"]
