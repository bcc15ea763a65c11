"""The plain version of the port's flash cross-attention held against the
JAX package's Pallas kernel (interpret mode) on the CPU, fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401


def _inputs(seed, g, q, n, d, f, qk_scale):
    rng = np.random.RandomState(seed)
    return (rng.randn(g, q, d).astype(np.float32) * qk_scale,
            rng.randn(g, n, d).astype(np.float32) * qk_scale,
            rng.randn(g, n, f).astype(np.float32))


# the shapes and tolerances of tests/test_pallas_kernels.py, plus the
# BraTS in/out-squeeze widths (D != F at 1024/256) at a small N
@pytest.mark.parametrize("g,q,n,d,f,qk_scale,tol", [
    (4, 256, 1296, 448, 448, 0.2, 2e-5),
    (1, 256, 700, 64, 64, 0.2, 2e-5),
    (2, 100, 130, 128, 256, 0.2, 2e-5),
    (2, 96, 72, 256, 1024, 0.2, 2e-5),
    (1, 128, 256, 64, 64, 10.0, 5e-5),      # scores beyond the clip
], ids=["squeeze_out", "pad_n", "pad_qn", "d256_f1024", "clamp"])
def test_plain_flash_matches_jax_kernel(g, q, n, d, f, qk_scale, tol):
    from segtran_tpu.kernels.squeezed_attention import fused_cross_attention
    from segtran_tpu_torch.kernels import squeezed_attention as sa

    qn, kn, vn = _inputs(0, g, q, n, d, f, qk_scale)
    ref = np.asarray(fused_cross_attention(jnp.asarray(qn), jnp.asarray(kn),
                                           jnp.asarray(vn), interpret=True))
    out, lse = sa.fused_cross_attention(torch.from_numpy(qn),
                                        torch.from_numpy(kn),
                                        torch.from_numpy(vn), return_lse=True)
    assert out.shape == (g, q, f) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    # lse = log sum exp of the clipped, scaled scores
    s = np.einsum("gqd,gnd->gqn", qn.astype(np.float64), kn) / np.sqrt(d)
    s = np.clip(s, -500.0, 500.0)
    mx = s.max(-1, keepdims=True)
    want = mx + np.log(np.exp(s - mx).sum(-1, keepdims=True))
    assert lse.shape == (g, q, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-4)


def test_clamp_is_applied_always():
    """Unlike the unfused modules, the kernel clamps even when no score
    exceeds +clip: a row whose scores all lie below -clip is flat."""
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    q = torch.full((1, 1, 4), -30.0)
    k = torch.tensor([[[30.0] * 4, [40.0] * 4]])
    v = torch.tensor([[[1.0], [3.0]]])
    out = sa.fused_cross_attention(q, k, v, attn_clip=500.0)
    # scores -1800 and -2400, both clipped to -500: equal weights
    assert float(out) == pytest.approx(2.0)
