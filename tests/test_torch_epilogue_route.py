"""The port's choice of expansion-epilogue function (``epilogue_route``)
held against the JAX package's VMEM gates.

JAX picks the all-modes tier, else the per-mode tier, else computes the
mid through its modules and takes the private tier where ``supports``
admits W2, else the modules (segtran_tpu/nn/attention.py:409-441). The
port follows that arithmetic except where the card measured the kernel
faster than the modules JAX runs: the private tier in bf16 up to W2
[4, 1792, 1792]. Each diverging bf16 path must compute what JAX's path
computes, within the bf16 tolerance of the epilogue parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables
from _torch_parity import one_torch_thread  # noqa: F401

# tests/test_torch_epilogue.py's bf16 bound: XLA on the CPU drops the
# intermediate bf16 roundings that the port's plain version keeps
BF16 = dict(rtol=5e-2, atol=1e-1)


def _jax_route(tier, m, a, f, itemsize):
    """The function JAX calls, from its own gates."""
    from segtran_tpu.kernels import expansion_epilogue as jepi
    if tier == "mid":
        if jepi.supports_full(m, a, f, itemsize):
            return "all_modes"
        if jepi.supports_permode(a, f, itemsize):
            return "per_mode"
    return "private" if jepi.supports(m, f, itemsize) else "unfused"


# (tier, M, A, F, dtype, the port's route): ROADMAP Queue 3's diverging
# shapes, the fundus serving widths and the BraTS shapes
CASES = [
    # fundus flagship serving, bf16, 256 attractors: unchanged
    ("mid", 4, 256, 1792, "bf16", "per_mode"),
    ("mid", 4, 256, 896, "bf16", "all_modes"),
    ("mid", 4, 256, 448, "bf16", "all_modes"),
    # --fused serving: the private tier at the three widths
    ("private", 4, 0, 1792, "bf16", "private"),      # JAX: unfused
    ("private", 4, 0, 896, "bf16", "private"),
    ("private", 4, 0, 448, "bf16", "private"),
    # BraTS whole volume: 1024 attractors, F=1024
    ("mid", 4, 1024, 1024, "bf16", "per_mode"),      # the port took all
    ("private", 4, 0, 1024, "bf16", "private"),
    ("mid", 4, 1024, 1024, "fp32", "per_mode"),
    ("private", 4, 0, 1024, "fp32", "unfused"),
    # fp32 at the fundus widths
    ("mid", 4, 256, 1792, "fp32", "unfused"),        # the port: per-mode
    ("mid", 4, 256, 896, "fp32", "per_mode"),        # the port: all modes
    ("mid", 4, 256, 448, "fp32", "all_modes"),
    ("private", 4, 0, 1792, "fp32", "unfused"),
    ("private", 4, 0, 896, "fp32", "unfused"),
    ("private", 4, 0, 448, "fp32", "private"),
    # beyond the measured W2 in bf16: JAX's gate again
    ("private", 4, 0, 2048, "bf16", "unfused"),
    ("mid", 4, 256, 2048, "bf16", "per_mode"),      # exactly the budget
    ("mid", 4, 256, 2304, "bf16", "unfused"),
]


@pytest.mark.parametrize("tier,m,a,f,dtype,want", CASES)
def test_route_follows_jax_but_for_the_measured_bf16_private_tier(
        tier, m, a, f, dtype, want):
    from segtran_tpu_torch.kernels.expansion_epilogue import epilogue_route
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = epilogue_route(tier, m, a, f, tdt)
    assert got == want
    jax_says = _jax_route(tier, m, a, f, 2 if dtype == "bf16" else 4)
    # the one exception: the bf16 private tier that JAX's gate refuses
    # and the card measured faster (PERF.md; 2.240 against 2.85 ms)
    exception = (dtype == "bf16" and got == "private"
                 and jax_says == "unfused" and m * f * f <= 4 * 1792 * 1792)
    assert got == jax_says or exception, (got, jax_says)


def test_route_rejects_an_unknown_tier():
    from segtran_tpu_torch.kernels.expansion_epilogue import epilogue_route
    with pytest.raises(ValueError, match="tier"):
        epilogue_route("full", 4, 256, 448, torch.float32)


@pytest.mark.parametrize("route,called", [
    ("all_modes", "fused_mid_output_pool"),
    ("per_mode", "fused_mid_output_pool_permode"),
    ("private", "fused_private_output_pool"),
    ("unfused", None)])
def test_layer_calls_the_routed_function(monkeypatch, route, called):
    """The attractor-out expansion asks the route with (tier 'mid', M, A,
    F, dtype), then the private tier's question for its mid, and calls
    only the function named."""
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.nn.attention import (ExpandedFeatTrans,
                                                TransLayerSpec)
    asked, calls = [], []
    monkeypatch.setattr(epi, "epilogue_route",
                        lambda *a: asked.append(a) or route)
    for name in ("fused_mid_output_pool", "fused_mid_output_pool_permode",
                 "fused_private_output_pool"):
        real = getattr(epi, name)
        monkeypatch.setattr(epi, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    layer = ExpandedFeatTrans(TransLayerSpec(
        in_feat_dim=32, feat_dim=16, num_modes=4,
        use_fused_epilogue=True)).eval()
    x = torch.randn(2, 6, 32)
    probs = torch.softmax(torch.randn(2, 4, 20, 6), -1)
    with torch.no_grad():
        out = layer(x, attention_probs=probs)
    assert out.shape == (2, 20, 16)
    assert asked[0] == ("mid", 4, 6, 16, torch.float32)
    assert calls == ([called] if called else [])


def test_training_mode_takes_the_modules(monkeypatch):
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.nn.attention import (ExpandedFeatTrans,
                                                TransLayerSpec)
    monkeypatch.setattr(epi, "epilogue_route",
                        lambda *a: pytest.fail("asked in training"))
    layer = ExpandedFeatTrans(TransLayerSpec(
        in_feat_dim=32, feat_dim=16, num_modes=4, use_fused_epilogue=True,
        hidden_dropout_prob=0.0)).train()
    layer(torch.randn(1, 6, 32),
          attention_probs=torch.softmax(torch.randn(1, 4, 20, 6), -1))


def test_diverging_bf16_private_tier_equals_jax_unfused_path():
    """bf16, F=1792, 4 modes, the --fused form (P V given) at a small N:
    JAX's gate refuses the private kernel and runs its modules; the port's
    route takes the private tier (its plain version on the CPU). The two
    agree within the bf16 bound."""
    from segtran_tpu.kernels import expansion_epilogue as jepi
    from segtran_tpu.nn.attention import ExpandedFeatTrans as JExp
    from segtran_tpu.nn.attention import TransLayerSpec as JSpec
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.nn.attention import ExpandedFeatTrans as TExp
    from segtran_tpu_torch.nn.attention import TransLayerSpec as TSpec
    f, m = 1792, 4
    assert not jepi.supports(m, f, 2)
    assert epi.epilogue_route("private", m, 0, f, torch.bfloat16) == "private"
    kw = dict(in_feat_dim=f, feat_dim=f, num_modes=m,
              use_fused_epilogue=True)
    jm = JExp(JSpec(attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
                    dtype=jnp.bfloat16, **kw))
    rng = np.random.RandomState(3)
    x = rng.randn(1, 8, f).astype(np.float32)
    probs = rng.rand(1, m, 16, 8).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    params, _ = jax_variables(jm, jnp.asarray(x), jnp.asarray(probs), seed=5)
    fused = (rng.randn(1, m, 16, f) * 0.5).astype(np.float32)
    ref = jax.jit(lambda p, xx, fu: jm.apply({"params": p}, xx, fused=fu))(
        params, jnp.asarray(x), jnp.asarray(fused).astype(jnp.bfloat16))
    layer = TExp(TSpec(dtype=torch.bfloat16, **kw))
    layer.load_state_dict(state_dict_from_jax(params), strict=True)
    calls = []
    real = epi.fused_private_output_pool
    try:
        epi.fused_private_output_pool = lambda *a, **k: (
            calls.append(1), real(*a, **k))[1]
        with torch.no_grad():
            out = layer.eval()(torch.from_numpy(x),
                               fused=torch.from_numpy(fused).bfloat16())
    finally:
        epi.fused_private_output_pool = real
    assert calls == [1]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **BF16)
