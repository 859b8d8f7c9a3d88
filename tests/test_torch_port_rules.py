"""Rules of the torch port: no JAX, no silent CPU path, no quiet fallback.

* Nothing under ``src/repro_torch/``, in ``scripts/`` or in
  ``chip_smoke.py`` imports ``jax``/``jaxlib`` or the reference package
  ``repro``.
* Entry points run on CUDA by default and raise without it unless the
  caller passes ``device="cpu"``.
* A CUDA-bound request never takes the plain version: the wrapper builds
  and launches the kernel, or raises.
"""
import ast
import functools
import importlib
import importlib.util
import pathlib
import sys
import tempfile

import jax  # noqa: F401  (the test files of the port import both packages)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_jax
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.figures import common as figures_common
from repro_torch.figures import fig3_profile
from repro_torch.kernels import build, dense_attention, nxfp_attention
from repro_torch.kernels import nxfp_matmul
from repro_torch.kernels import nxfp_qq_matmul, nxfp_quantize
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.launch.mesh import make_mesh, make_serving_mesh, make_test_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import init_cache, init_paged_cache, init_params
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.state import init_state
from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                 PriorityPreemption, ServeEngine,
                                 ShardedContinuousEngine,
                                 ShardedPagedContinuousEngine,
                                 TieredContinuousEngine, default_tiers)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "scripts").glob("*.py"))
              + sorted((ROOT / "examples").glob("*_torch.py"))
              + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
FIGURES = ("fig3_profile", "fig8_quant_error", "fig9_tradeoff",
           "fig10_accuracy", "fig11_remap_sweep", "fig12_blocksize",
           "table1_perplexity")
EXAMPLES = ("train_then_serve_quantized_torch",
            "longcontext_ssm_serving_torch", "quickstart_torch",
            "continuous_serving_torch")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/kernels/ops.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/convert.py", "chip_smoke.py",
                 "scripts/profile_decode.py",
                 "src/repro_torch/serving/tiers.py",
                 "src/repro_torch/serving/snapshot.py",
                 "src/repro_torch/serving/paged.py",
                 "src/repro_torch/serving/paged_engine.py",
                 "src/repro_torch/serving/faults.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/train/compress.py",
                 "src/repro_torch/serving/sharded.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/sharding/rules.py",
                 "src/repro_torch/sharding/ctx.py",
                 "src/repro_torch/sharding/shard_map.py",
                 "src/repro_torch/figures/common.py",
                 "src/repro_torch/figures/table1_perplexity.py",
                 *(f"src/repro_torch/figures/{m}.py" for m in FIGURES),
                 *(f"examples/{m}.py" for m in EXAMPLES)):
        assert must in names


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _smoke():
    return get_smoke_config("llama3_8b")


def _mesh(dev):
    """A 2-shard serving mesh: the first two CUDA devices by default,
    else ``dev`` twice."""
    return make_serving_mesh(2, None if dev is None else [dev] * 2)


ENTRY_POINTS = {
    "init_params": lambda dev: init_params(_smoke(), seed=0, device=dev),
    "init_cache": lambda dev: init_cache(_smoke(), 2, 8, "nxfp4",
                                         device=dev),
    "quantize_qtensor": lambda dev: quantize_qtensor(
        torch.ones((4, 64)), "nxfp4", axis=-1, device=dev),
    "ServeEngine": lambda dev: ServeEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), max_len=16, device=dev),
    "params_from_jax": lambda dev: params_from_jax(
        {"tok_embed": np.ones((4, 2), np.float32),
         "layers": {"wq": np.ones((2, 2, 2), np.float32)}}, device=dev),
    "ContinuousEngine": lambda dev: ContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), n_slots=2, max_len=16, device=dev),
    "ContinuousEngine(preemption=)": lambda dev: ContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), n_slots=2, max_len=16,
        preemption=PriorityPreemption(), device=dev),
    "ContinuousEngine(kv_integrity=)": lambda dev: ContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), n_slots=2, max_len=16,
        kv_integrity=True, device=dev),
    "TieredContinuousEngine": lambda dev: TieredContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        default_tiers(), n_slots=2, max_len=16, device=dev),
    "init_paged_cache": lambda dev: init_paged_cache(
        _smoke(), 2, 16, "nxfp4", 5, 8, device=dev),
    "PagedContinuousEngine": lambda dev: PagedContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), n_slots=2, max_len=16, device=dev),
    "make_serving_mesh": _mesh,
    "ShardedContinuousEngine": lambda dev: ShardedContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), _mesh(dev), n_slots=2, max_len=16),
    "ShardedPagedContinuousEngine": lambda dev: ShardedPagedContinuousEngine(
        _smoke(), init_params(_smoke(), seed=0, device="cpu"),
        QuantPolicy("nxfp4", "nxfp4"), _mesh(dev), n_slots=2, max_len=16),
    "train_loop": lambda dev: train_loop(_smoke(), steps=1, batch=2, seq=8,
                                         device=dev, log_every=100),
    "make_mesh": lambda dev: _process_mesh(make_mesh, (1,), ("pod",),
                                           device=dev),
    "make_test_mesh": lambda dev: _process_mesh(make_test_mesh, 1, 1,
                                                device=dev),
    # the figures' trained model (restored from a cached CPU checkpoint
    # on the CPU path) and a figure that reads no model
    "figures.trained_model": lambda dev: figures_common.trained_model(
        device=dev, cache=_bench_cache()),
    "figures.fig3_profile": lambda dev: fig3_profile.compute(
        figures_common.Csv(), device=dev),
    "examples.longcontext_ssm_serving_torch": lambda dev: _example(
        "longcontext_ssm_serving_torch").main(dev, context=64,
                                              decode_steps=1),
}


_TMP = []


def _process_mesh(make, *args, device):
    """A 1-rank gloo mesh, joined and left again (the group is the
    process's default one)."""
    _TMP.append(tempfile.TemporaryDirectory())
    mesh = make(*args, backend="gloo", device=device, rank=0, world_size=1,
                init_method=f"file://{_TMP[-1].name}/store")
    mesh.close()


@functools.lru_cache(maxsize=None)
def _bench_cache():
    """A checkpoint directory holding the bench model's init state at
    ``TRAIN_STEPS``, on the CPU: ``trained_model`` restores it."""
    _TMP.append(tempfile.TemporaryDirectory())
    cfg, steps = figures_common.BENCH_CFG, figures_common.TRAIN_STEPS
    opt = AdamW(lr=cosine_schedule(1e-3, steps // 20, steps))
    mgr = CheckpointManager(_TMP[-1].name, keep=1, async_save=False)
    mgr.save(init_state(init_params(cfg, 0, device="cpu", train=True), opt),
             steps, block=True)
    return _TMP[-1].name


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]("cuda")
    ENTRY_POINTS[name]("cpu")       # the explicit CPU path works


def _figure_cli(name):
    def run(dev):
        argv = [name] + ([] if dev is None else ["--device", dev])
        old, sys.argv = sys.argv, argv
        try:
            importlib.import_module(f"repro_torch.figures.{name}").main()
        finally:
            sys.argv = old
    return run


# entry points whose CPU path trains or evaluates a model for minutes:
# held here to their refusal only (the CPU tests drive their functions,
# ``tests/test_torch_figures.py``)
SLOW_ENTRY_POINTS = {
    **{f"figures.{m}.compute": lambda dev, m=m: importlib.import_module(
        f"repro_torch.figures.{m}").compute(figures_common.Csv(), device=dev)
       for m in FIGURES},
    **{f"figures.{m} (command line)": _figure_cli(m) for m in FIGURES},
    "examples.train_then_serve_quantized_torch": lambda dev: _example(
        "train_then_serve_quantized_torch").main(dev),
}


@pytest.mark.parametrize("name", sorted(SLOW_ENTRY_POINTS))
def test_figure_entry_points_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        SLOW_ENTRY_POINTS[name](None)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLOW_ENTRY_POINTS[name]("cuda")


@pytest.fixture
def cuda_request(monkeypatch, no_cuda):
    """Every wrapper sees its tensors as CUDA tensors: the request must
    go to the kernel (and fail here for want of a card), never to the
    plain version."""
    monkeypatch.setattr(build, "on_cuda", lambda *tensors: True)

    def plain_called(*a, **k):
        raise AssertionError("a CUDA request took the plain version")

    for mod, name in ((nxfp_quantize, "nxfp_quantize_pack_plain"),
                      (nxfp_matmul, "nxfp_matmul_plain"),
                      (nxfp_attention, "nxfp_decode_attention_plain"),
                      (dense_attention, "dense_decode_attention_plain"),
                      (nxfp_qq_matmul, "nxfp_qq_matmul_plain")):
        monkeypatch.setattr(mod, name, plain_called)


def _meta(shape, fmt):
    return torch.zeros(shape, dtype=getattr(torch, fmt.meta_dtype))


def _matmul_args(fmt):
    n, kb = 8, 2
    return (torch.zeros((4, kb * fmt.block_size), dtype=torch.bfloat16),
            torch.zeros((n, kb, fmt.bytes_per_block), dtype=torch.uint8),
            _meta((n, kb), fmt), fmt)


def _attention_args(fmt):
    b, s, kvh, g, nb = 2, 8, 2, 2, 1
    packed = torch.zeros((b, s, kvh, nb, fmt.bytes_per_block),
                         dtype=torch.uint8)
    meta = _meta((b, s, kvh, nb), fmt)
    return (torch.zeros((b, kvh, g, nb * fmt.block_size)), packed, meta,
            packed, meta, torch.ones((b,), dtype=torch.int32), fmt)


def _qq_args(x_fmt, w_fmt):
    m, n, kb = 4, 8, 2
    return (torch.zeros((m, kb, x_fmt.bytes_per_block), dtype=torch.uint8),
            _meta((m, kb), x_fmt),
            torch.zeros((n, kb, w_fmt.bytes_per_block), dtype=torch.uint8),
            _meta((n, kb), w_fmt), x_fmt, w_fmt)


@pytest.mark.parametrize("kernel", ["quantize", "matmul", "attention", "qq",
                                    "dense_attention", "kv_rows_paged"])
def test_cuda_requests_raise_instead_of_falling_back(cuda_request, kernel):
    """Symmetric and activation formats alike go to the kernel, and a K/V
    write through a block table (the paged cache) too."""
    fmt, act = get_format("nxfp4"), get_format("amxfp4_ox")
    with pytest.raises(RuntimeError, match="CUDA"):
        if kernel == "quantize":
            nxfp_quantize.nxfp_quantize_pack(torch.zeros((4, 32)), act)
        elif kernel == "kv_rows_paged":
            layer = init_paged_cache(_smoke(), 2, 16, "nxfp4", 5, 8,
                                     device="cpu")["layers"][0]
            kv = torch.zeros((2, 1, _smoke().n_kv_heads, _smoke().hd))
            nxfp_quantize.nxfp_quantize_kv_rows(
                kv, kv.clone(), layer, torch.zeros((2,), dtype=torch.int32),
                fmt, block=layer["block"])
        elif kernel == "matmul":
            nxfp_matmul.nxfp_matmul(*_matmul_args(fmt))
        elif kernel == "attention":
            nxfp_attention.nxfp_decode_attention(
                *_attention_args(get_format("mxfp4_ox")))
        elif kernel == "dense_attention":       # head_dim 120, no padding
            kv = torch.zeros((2, 8, 2, 120), dtype=torch.bfloat16)
            dense_attention.dense_decode_attention(
                torch.zeros((2, 2, 3, 120)), kv, kv.clone(),
                torch.ones((2,), dtype=torch.int32))
        else:
            nxfp_qq_matmul.nxfp_qq_matmul(*_qq_args(act, fmt))


@pytest.mark.parametrize("kernel", ["quantize", "matmul", "attention", "qq"])
def test_cuda_kernels_reject_formats_they_do_not_take(cuda_request, kernel):
    """What the kernels still refuse raises NotImplementedError on CUDA: a
    block size outside 8 to 128 (here 4). 3-bit codes and custom recycle
    values, refused once, are taken now
    (``test_cuda_requests_for_wide_formats_reach_the_kernel``)."""
    bs4 = get_format("bfp4_bs4")
    with pytest.raises(NotImplementedError):
        if kernel == "quantize":
            nxfp_quantize.nxfp_quantize_pack(torch.zeros((4, 4)), bs4)
        elif kernel == "matmul":
            nxfp_matmul.nxfp_matmul(*_matmul_args(bs4))
        elif kernel == "attention":
            nxfp_attention.nxfp_decode_attention(*_attention_args(bs4))
        else:
            nxfp_qq_matmul.nxfp_qq_matmul(
                *_qq_args(get_format("amxfp4_bs4"), bs4))


def _wide(name):
    if "@" not in name:
        return get_format(name)
    import dataclasses
    base, value = name.split("@")
    return dataclasses.replace(get_format(base), recycle=float(value),
                               name=name)


WIDE = ["mxfp3", "nxfp3", "bfp3_bs16", "bfp2", "bfp7", "nxfp4_bs8",
        "nxfp4_bs64", "nxfp4_bs128", "nxfp4@0.75", "mxfp4_cr@5.0"]
# the activation format of a qq request at each weight format's block size
WIDE_ACT = {8: "amxfp4_bs8", 16: "amxfp3_bs16", 32: "amxfp3",
            64: "amxfp4_bs64", 128: "amxfp4_bs128"}


@pytest.mark.parametrize("kernel", ["quantize", "matmul", "attention", "qq"])
@pytest.mark.parametrize("fname", WIDE)
def test_cuda_requests_for_wide_formats_reach_the_kernel(cuda_request,
                                                         kernel, fname):
    """3-bit (and 2/7-bit BFP) codes, block sizes 8 to 128 and custom
    recycle values, once refused with NotImplementedError, go to the
    kernel like every other format: the wrapper builds and launches it
    (and fails here for want of a card), never the plain version."""
    fmt = _wide(fname)
    with pytest.raises(RuntimeError, match="CUDA"):
        if kernel == "quantize":
            nxfp_quantize.nxfp_quantize_pack(
                torch.zeros((4, fmt.block_size)), fmt)
        elif kernel == "matmul":
            nxfp_matmul.nxfp_matmul(*_matmul_args(fmt))
        elif kernel == "attention":
            nxfp_attention.nxfp_decode_attention(*_attention_args(fmt))
        else:
            nxfp_qq_matmul.nxfp_qq_matmul(
                *_qq_args(get_format(WIDE_ACT[fmt.block_size]), fmt))


def test_qq_gemm_refuses_mixed_block_sizes():
    """Both operands must share one block size (the reference asserts it),
    on every device."""
    with pytest.raises(ValueError, match="block sizes"):
        nxfp_qq_matmul.nxfp_qq_matmul(*_qq_args(get_format("amxfp4"),
                                                get_format("nxfp4_bs16")))


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        build.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
