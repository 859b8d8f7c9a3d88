"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

Each ``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked
into ``build/kernels/libnxfp_<hash>.so`` at the repository root; the hash
covers the sources and the flags, so an edited source rebuilds. The
library has a plain C interface and is loaded with ``ctypes``: nothing
here includes PyTorch's headers, so a build takes seconds.

Nothing is built or loaded at import; the first kernel launch calls
``library()``. Without ``nvcc`` or a CUDA device this raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..core.formats import BlockFormat
from ..core.quantize import ox_emax
from .decode_lib import elem_desc

__all__ = ["build", "library", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the quantizer (nxfp_quantize*.cu) must not contract a*b+c into FMAs: the
# reference rounds the square and the sum of its MSE separately
_PER_FILE = {"nxfp_quantize": ["-fmad=false"]}


def _file_flags(name: str) -> list:
    return [f for prefix, flags in _PER_FILE.items()
            if name.startswith(prefix) for f in flags]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((_ARCH, _COMMON, _PER_FILE)).encode())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str):
    return [ln.strip() for ln in text.splitlines()
            if re.search(r"ptxas info\s*:\s*(Used|Compiling entry)", ln)]


def build() -> dict:
    """Compile ``csrc/*.cu`` (one nvcc per file, in parallel) and link,
    unless a library built from the same sources and flags exists.

    Returns {"path", "seconds", "ptxas": {file: [lines]}, "cached"}.
    """
    out = BUILD_DIR / f"libnxfp_{_digest()}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "ptxas": {}, "cached": True}
    nvcc = _nvcc()
    # objects go to a directory of this process's own, so concurrent builds
    # never share a file; the finished library is renamed into place
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cus, _ = _sources()
    procs = {}
    for cu in cus:
        obj = work / (cu.stem + ".o")
        cmd = [nvcc, *_ARCH, *_COMMON, *_file_flags(cu.name),
               "-I", str(CSRC), "-c", str(cu), "-o", str(obj)]
        procs[cu.name] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ptxas, failed = {}, []
    for name, (obj, proc) in procs.items():
        text, _ = proc.communicate()
        ptxas[name] = _ptxas_lines(text)
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for obj, _ in procs.values()]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return {"path": str(out), "seconds": time.time() - t0, "ptxas": ptxas,
            "cached": False}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        lib = ctypes.CDLL(build()["path"])
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nxfp_quantize_launch.argtypes = [vp, i, i, vp, i, i, ll, vp]
        lib.nxfp_matmul_launch.argtypes = [vp, vp, vp, vp, i, i, i, vp, i, i,
                                           vp, vp, vp]
        lib.nxfp_matmul_decode_geometry.argtypes = [vp, vp, vp]
        lib.nxfp_matmul_grouped_launch.argtypes = [vp, vp, vp, vp, vp, i, i,
                                                   i, i, vp, i, i, vp, vp,
                                                   vp]
        lib.nxfp_decode_attention_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                                     vp, i, i, i, i, i, vp,
                                                     i, i, vp, vp, vp]
        lib.nxfp_dense_attention_launch.argtypes = [vp, vp, vp, vp, vp, i,
                                                    i, i, i, i, i, i, vp, vp,
                                                    vp]
        lib.nxfp_qq_matmul_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                              vp, vp, vp, i, i, vp, vp, vp]
        for fn in (lib.nxfp_quantize_launch, lib.nxfp_matmul_launch,
                   lib.nxfp_matmul_decode_geometry,
                   lib.nxfp_matmul_grouped_launch,
                   lib.nxfp_decode_attention_launch,
                   lib.nxfp_dense_attention_launch,
                   lib.nxfp_qq_matmul_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_OUTGROWN: list = []   # split scratch replaced by larger buffers


def split_scratch(cache: dict, device: torch.device, n_partials: int,
                  n_counters: int):
    """A split kernel's f32 partials and int32 counters for the current
    stream of ``device``, kept in ``cache`` per (device, stream) and grown
    (at least doubled) when too small. An outgrown buffer stays
    referenced (``_OUTGROWN``): a CUDA graph captured before the growth
    still launches on it, so its memory must not go to another tensor.
    The counters are zeroed once, at allocation; each launch leaves them
    at 0 (the last CTA of each group resets its own; a fault inside a
    launch leaves the CUDA context unusable, so no later launch meets a
    counter left off). Only launches on the stream that owns them use
    them, so they run one after another."""
    key = (device, stream_handle(device))
    ws, counters = cache.get(key, (None, None))
    if ws is None or ws.numel() < n_partials:
        if ws is not None:
            _OUTGROWN.append(ws)
        ws = torch.empty(max(n_partials, 1 << 20,
                             2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        if counters is not None:
            _OUTGROWN.append(counters)
        counters = torch.zeros(max(n_counters, 4096), dtype=torch.int32,
                               device=device)
    cache[key] = (ws, counters)
    return ws, counters


_n_sm: dict = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (read once per device)."""
    if device not in _n_sm:
        _n_sm[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _n_sm[device]


# -- format descriptors (ctypes twins of the structs in csrc/) ---------------

class ElemDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in
                ("bits", "is_bfp", "ebits", "mbits", "bias", "cr")] + [
        ("cr_val", ctypes.c_float)]


class FmtDesc(ctypes.Structure):
    _fields_ = [("elem", ElemDesc * 2)] + [
        (n, ctypes.c_int) for n in
        ("bits", "block_size", "asym", "ox", "emax")]


@functools.lru_cache(maxsize=None)
def fmt_desc(fmt: BlockFormat) -> FmtDesc:
    """The ``nxfp::FmtDesc`` of ``csrc/nxfp_decode.cuh`` for ``fmt``: the
    element decode for fmt_bit 0 and 1 (the same one when not AM), widths
    and the activation-format flags. Built once per format (a wrapper
    passes its address on every launch; the C side copies it)."""
    descs = [ElemDesc(*elem_desc(el, fmt.cr, fmt.recycle)) for _, el in
             sorted(fmt.elem_formats, key=lambda e: e[0])]
    return FmtDesc((ElemDesc * 2)(descs[0], descs[-1]), fmt.bits,
                   fmt.block_size, int(fmt.asym), int(fmt.ox), ox_emax(fmt))


# the formats the CUDA kernels take (csrc/nxfp_decode.cuh: native_fmt,
# generic_fmt): 4/5/6/8-bit codes at bs 16/32 run instances that read whole
# blocks; every other width and block size here runs the generic instance
# of its width, which reads rows in units of GENERIC_UNIT codes (2- and
# 7-bit codes are BFP formats only)
KERNEL_BITS = (2, 3, 4, 5, 6, 7, 8)
KERNEL_BLOCK_SIZES = (8, 16, 32, 64, 128)
GENERIC_UNIT = 32


def native(fmt: BlockFormat) -> bool:
    """Whether ``fmt`` has kernel instances that read whole blocks."""
    return fmt.bits in (4, 5, 6, 8) and fmt.block_size in (16, 32)


def require_format(fmt: BlockFormat, what: str) -> None:
    """Raise NotImplementedError for a format no kernel instance takes."""
    if fmt.bits not in KERNEL_BITS or fmt.block_size not in \
            KERNEL_BLOCK_SIZES:
        raise NotImplementedError(
            f"{fmt.name}: the CUDA {what} takes 2- to 8-bit formats with "
            "block sizes 8 to 128")


def gemm_blocks(kb: int, fmt: BlockFormat):
    """(blocks, block size) of a row of ``kb`` blocks as the GEMM kernels
    read it, for their split plan: whole blocks for a native format, else
    units of ``GENERIC_UNIT`` codes (``kb * block_size`` a multiple of it,
    see ``pad_k``)."""
    if native(fmt):
        return kb, fmt.block_size
    return kb * fmt.block_size // GENERIC_UNIT, GENERIC_UNIT


def pad_k(packed, meta, block_size: int):
    """Pad a (R, KB, bpb) operand and its (R, KB) meta with zero blocks to
    whole units of ``GENERIC_UNIT`` codes a row, as a generic GEMM reads
    them (zero codes under a zero meta word decode to 0, and the ox
    substitution is off for a zero E byte). Returns them unchanged when
    nothing is missing."""
    per = GENERIC_UNIT // block_size
    if per <= 1 or packed.shape[1] % per == 0:
        return packed, meta
    extra = per - packed.shape[1] % per
    return (torch.nn.functional.pad(packed, (0, 0, 0, extra)),
            torch.nn.functional.pad(bit_view(meta), (0, extra)).view(
                meta.dtype))


_BIT_VIEWS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def bit_view(t):
    """A view torch's ops take (uint16/uint32 meta -> int16/int32, the
    same bits); other dtypes as they are."""
    view = _BIT_VIEWS.get(t.dtype)
    return t if view is None else t.view(view)


def meta_dtype(fmt: BlockFormat) -> torch.dtype:
    """The torch dtype of ``fmt``'s meta words (uint16, uint32 for asym)."""
    return getattr(torch, fmt.meta_dtype)


def on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when every one is on the CPU.

    A wrapper takes its plain version only for CPU tensors; any other
    device, or a mix, raises rather than fall back.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all be on cpu or all on cuda, got "
                     f"{sorted(kinds)}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
