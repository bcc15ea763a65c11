"""The port's expansion-epilogue functions held against the JAX kernels.

The JAX side runs its Pallas kernels in interpret mode (what
``interpret=None`` gives off-TPU); the port runs on CPU tensors, i.e. its
plain PyTorch versions, which repeat the CUDA kernels' arithmetic. The
CUDA kernels themselves are compared with these plain versions on the
card by chip_smoke.py. Shapes are those of tests/test_pallas_kernels.py:
N=300 is not a multiple of any tile and A=48 not a multiple of 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

# fp32: the JAX kernels' own oracle tolerance
F32 = dict(rtol=2e-4, atol=2e-5)
# bf16: the port rounds to bf16 after every elementwise step, as the CUDA
# kernel does; XLA on the CPU runs the JAX kernel's bf16 chains (bias add,
# the four LayerNorm steps) in fp32 and drops the intermediate roundings
# (its excess-precision default), so single elements differ by several
# bf16 ulps (2^-8 relative) on outputs of magnitude up to ~5 -- measured
# max 0.086; 98% of elements agree within 1e-2 (1 + |ref|)
BF16 = dict(rtol=5e-2, atol=1e-1)


def _inputs(b, m, n, a, f, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, m, n, a).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return dict(
        probs=probs,
        vw1=rng.randn(b, m, a, f).astype(np.float32) * 0.3,
        b1=rng.randn(f).astype(np.float32) * 0.1,
        mid=rng.randn(b, m, n, f).astype(np.float32) * 0.3,
        w2=rng.randn(m, f, f).astype(np.float32) * 0.05,
        b2=rng.randn(m, f).astype(np.float32) * 0.1,
        scale=rng.rand(f).astype(np.float32) + 0.5,
        lnb=rng.randn(f).astype(np.float32) * 0.1,
        ws=rng.randn(f, 1).astype(np.float32) * 0.2,
        bs=rng.randn(1).astype(np.float32))


def _run(name, d, dtype):
    from segtran_tpu.kernels import expansion_epilogue as jepi
    from segtran_tpu_torch.kernels import expansion_epilogue as tepi
    keys = (["mid"] if name == "fused_private_output_pool"
            else ["probs", "vw1", "b1"]) + ["w2", "b2", "scale", "lnb", "ws",
                                            "bs"]
    # the activations enter in the compute dtype, the params stay fp32
    cast = {"probs", "vw1", "mid"}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jargs = [jnp.asarray(d[k]).astype(jdt) if k in cast else jnp.asarray(d[k])
             for k in keys]
    targs = [torch.from_numpy(d[k]).to(tdt) if k in cast
             else torch.from_numpy(d[k]) for k in keys]
    ref = getattr(jepi, name)(*jargs, ln_eps=1e-12)
    before = getattr(tepi, name).launches
    out = getattr(tepi, name)(*targs, ln_eps=1e-12)
    # CPU tensors take the plain version: no kernel launch is counted
    assert getattr(tepi, name).launches == before
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32)) if dtype == "bf16" \
        else np.asarray(ref)
    return out.float().numpy(), ref


@pytest.mark.parametrize("name,b,m,n,a,f", [
    ("fused_private_output_pool", 2, 4, 300, 0, 256),
    ("fused_private_output_pool", 1, 2, 512, 0, 384),
    ("fused_mid_output_pool", 2, 4, 300, 48, 256),
    ("fused_mid_output_pool", 1, 2, 512, 128, 384),
    ("fused_mid_output_pool_permode", 2, 4, 300, 48, 256),
])
def test_epilogue_fp32_matches_jax(name, b, m, n, a, f):
    out, ref = _run(name, _inputs(b, m, n, max(a, 1), f, seed=7), "fp32")
    assert out.shape == (b, n, f)
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("name", ["fused_private_output_pool",
                                  "fused_mid_output_pool",
                                  "fused_mid_output_pool_permode"])
def test_epilogue_bf16_matches_jax(name):
    out, ref = _run(name, _inputs(2, 4, 300, 48, 256, seed=9), "bf16")
    np.testing.assert_allclose(out, ref, **BF16)
    # and most elements agree far closer than the bound
    assert np.mean(np.abs(out - ref) <= 1e-2 * (1 + np.abs(ref))) > 0.95


def test_permode_equals_full_plain():
    """The per-mode tier and the all-modes tier compute the same function."""
    from segtran_tpu_torch.kernels import expansion_epilogue as tepi
    d = _inputs(2, 4, 300, 48, 256, seed=11)
    args = [torch.from_numpy(d[k]) for k in
            ("probs", "vw1", "b1", "w2", "b2", "scale", "lnb", "ws", "bs")]
    full = tepi.fused_mid_output_pool(*args)
    per = tepi.fused_mid_output_pool_permode(*args)
    np.testing.assert_allclose(per.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_tier_gate_reproduces_the_flagship_split():
    """bf16 flagship: F=1792 layer 0 per mode, F=896 and 448 all modes."""
    from segtran_tpu_torch.kernels.expansion_epilogue import (
        supports_full, supports_permode)
    assert not supports_full(4, 256, 1792, 2)
    assert supports_permode(256, 1792, 2)
    assert supports_full(4, 256, 896, 2) and supports_full(4, 256, 448, 2)
