"""Building the weights a layer at a time, on the CPU at smoke size.

* ``init_params(cfg, seed, policy=)`` draws each layer and casts it at
  once: the tree is bitwise ``load_params(init_params(cfg, seed),
  policy)`` (every QTensor's packed bytes and meta, every other leaf and
  its dtype) for one config of each family (dense, ssm, hybrid, moe).
  Without a weight format it is the f32 tree of today.
* ``load_params`` passes a cast tree of its weight format through, byte
  for byte, and raises on another format, naming the leaf.
* The paths that cast from the f32 weights refuse a cast tree: the
  speculative draft of another format, and the tiered engine's weight
  sets of formats the tree is not cast to. The recycled draft decodes
  the cast tree and takes it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.qtensor import QTensor, QuantPolicy, _leaves
from repro_torch.kernels.build import bit_view
from repro_torch.models import init_params
from repro_torch.serving import (ContinuousEngine, SpeculativeConfig,
                                 TieredContinuousEngine, TierSpec)
from repro_torch.serving.engine import load_params

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

CPU = torch.device("cpu")
NXFP4 = QuantPolicy("nxfp4", "nxfp4")


def _assert_same_tree(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x) is type(y)
        if isinstance(x, QTensor):
            assert (x.fmt_name, x.shape, x.axis, x.orig_len) == \
                (y.fmt_name, y.shape, y.axis, y.orig_len)
            assert torch.equal(x.packed, y.packed)
            assert torch.equal(bit_view(x.meta), bit_view(y.meta))
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("fmt", ["nxfp4", "nxfp6"])
@pytest.mark.parametrize("arch", ["llama3_8b", "falcon_mamba_7b",
                                  "hymba_1_5b", "qwen2_moe_a2_7b"])
def test_layer_at_a_time_build_is_bitwise_load_params(arch, fmt):
    cfg = get_smoke_config(arch)
    policy = QuantPolicy(fmt, fmt)
    want = load_params(init_params(cfg, 7, device="cpu"), policy, CPU)
    got = init_params(cfg, 7, device="cpu", policy=policy)
    _assert_same_tree(got, want)
    assert any(isinstance(leaf, QTensor) for leaf in _leaves(got))


def test_build_without_weight_format_is_the_f32_tree():
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    want = init_params(cfg, 3, device="cpu")
    _assert_same_tree(init_params(cfg, 3, device="cpu",
                                  policy=QuantPolicy(None, "nxfp4")), want)
    assert want["layers"][0]["experts_w1"].dtype == torch.float32


def test_load_params_passes_same_format_and_refuses_another():
    cfg = get_smoke_config("llama3_8b")
    cast = init_params(cfg, 0, device="cpu", policy=NXFP4)
    again = load_params(cast, NXFP4, CPU)
    _assert_same_tree(again, cast)
    assert again["layers"][1]["wq"].packed is cast["layers"][1]["wq"].packed
    with pytest.raises(ValueError, match="layers/0/wq"):
        load_params(cast, QuantPolicy("nxfp6", "nxfp4"), CPU)


def test_speculative_draft_of_another_format_refuses_a_cast_tree():
    cfg = get_smoke_config("llama3_8b")
    cast = init_params(cfg, 0, device="cpu", policy=NXFP4)
    kw = dict(n_slots=2, max_len=32, chunk=4, device="cpu")
    with pytest.raises(ValueError, match="f32 weights"):
        ContinuousEngine(cfg, cast, NXFP4, speculative=SpeculativeConfig(
            k=2, draft="nxfp3"), **kw)
    eng = ContinuousEngine(cfg, cast, NXFP4,
                           speculative=SpeculativeConfig(k=2), **kw)
    w = eng.draft_params["layers"][0]["wq"]
    assert not isinstance(w, QTensor) and w.dtype == torch.bfloat16


def test_tiered_engine_refuses_a_cast_tree_for_other_formats():
    cfg = get_smoke_config("llama3_8b")
    cast = init_params(cfg, 0, device="cpu", policy=NXFP4)
    tiers = {"economy": TierSpec("nxfp4", "nxfp4", None),
             "premium": TierSpec(None, None, None)}
    with pytest.raises(ValueError, match="f32 weights"):
        TieredContinuousEngine(cfg, cast, tiers, n_slots=2, max_len=32,
                               chunk=4, device="cpu")
    eng = TieredContinuousEngine(cfg, cast, {"economy": tiers["economy"]},
                                 n_slots=2, max_len=32, chunk=4,
                                 device="cpu")
    assert eng.params["layers"][0]["wq"].packed is \
        cast["layers"][0]["wq"].packed
    np.testing.assert_array_equal(
        eng.params["layers"][0]["wq"].packed.numpy(),
        cast["layers"][0]["wq"].packed.numpy())
