"""The port's flash-attention backward held against the JAX package on the
CPU: the plain version of the dK/dV and dQ kernels against the Pallas
``_flash_bwd_impl`` (interpret mode) on the same inputs, and the gradients
of ``fused_cross_attention_trainable`` against ``jax.grad`` through the
JAX one -- at and above FLASH_BWD_MIN_N keys (the flash backward), with
padding, in fp32 and bf16, with scores past the clip (zero gradient),
and below the threshold (the recompute backward)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtran_tpu.kernels import squeezed_attention as jsa
from segtran_tpu_torch.kernels import squeezed_attention as tsa
from _torch_parity import one_torch_thread  # noqa: F401

# fp32: only summation order differs; bf16 as tests/test_pallas_kernels.py
# (XLA:CPU and PyTorch round the bf16 forward and cotangent differently)
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=0.1, atol=2e-4)}
G, Q, D, F = 2, 100, 32, 48


def _inputs(n, dtype, scale=0.2, seed=3):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(G, Q, D) * scale, rng.randn(G, n, D) * scale,
            rng.randn(G, n, F), rng.randn(G, Q, F)]
    arrs = [a.astype(np.float32) for a in arrs]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(t):
    return (np.array(t, np.float32) if not isinstance(t, torch.Tensor)
            else t.float().numpy())


@pytest.mark.parametrize("n_extra", [0, 604], ids=["N=4096", "N=4700"])
def test_plain_flash_backward_matches_pallas(n_extra):
    """flash_backward_plain == _flash_bwd_impl on the same q, k, v, dO and
    the same saved lse / delta (fp32)."""
    n = jsa.FLASH_BWD_MIN_N + n_extra
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(n, "float32")
    scale, clip = 1.0 / math.sqrt(D), 500.0
    tile_q, tile_n = jsa._auto_tiles(Q, n)
    out, lse = jsa._fused_forward(jq, jk, jv, clip, scale, tile_q, tile_n,
                                  True)
    delta = jnp.sum(jdo * out[:, :Q], axis=-1, keepdims=True)
    q_pad = lse.shape[1]
    delta_pad = jnp.pad(delta, ((0, 0), (0, q_pad - Q), (0, 0)))
    want = jsa._flash_bwd_impl(jq, jk, jv, jdo, lse, delta_pad, clip, scale,
                               tile_q, tile_n, True)
    got = tsa.flash_backward_plain(
        tq, tk, tv, tdo, torch.from_numpy(_np(lse[:, :Q])),
        torch.from_numpy(_np(delta)), clip, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])
    # the wrappers take the plain version for CPU tensors, counting nothing
    tsa.reset_launches()
    args = (tq, tk, tv, tdo, torch.from_numpy(_np(lse[:, :Q])),
            torch.from_numpy(_np(delta)), clip, scale)
    dk, dv = tsa.flash_backward_dkdv(*args)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    assert torch.equal(tsa.flash_backward_dq(*args), got[0])
    assert tsa.flash_backward_dkdv.launches == tsa.flash_backward_dq.launches == 0


def _grads_both(n, dtype, clip=500.0, scale=0.2):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(n, dtype, scale=scale, seed=4)

    def loss(q, k, v):
        out = jsa.fused_cross_attention_trainable(q, k, v, clip)
        return jnp.sum(out * jnp.cos(out))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tsa.fused_cross_attention_trainable(*ts, clip)
    (out * torch.cos(out)).sum().backward()
    return [t.grad for t in ts], want


@pytest.mark.parametrize("n_extra,dtype", [
    (0, "float32"), (604, "float32"), (0, "bfloat16"), (604, "bfloat16")])
def test_trainable_gradients_match_jax_flash_backward(n_extra, dtype):
    tsa.reset_launches()
    got, want = _grads_both(jsa.FLASH_BWD_MIN_N + n_extra, dtype)
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])
    # above the threshold the recompute backward did not run
    assert tsa.cross_attention_bwd_recompute.launches == 0


def test_clamp_gives_zero_gradient_like_jax():
    """Scores pushed past a tiny clip: most of the gradient is zeroed, as
    in the JAX flash backward."""
    got, want = _grads_both(jsa.FLASH_BWD_MIN_N, "float32", clip=1.0,
                            scale=10.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])


def test_below_threshold_takes_the_recompute_backward():
    tsa.reset_launches()
    got, want = _grads_both(1000, "float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL["float32"])
    assert tsa.cross_attention_bwd_recompute.launches == 1
