"""The port's position codes held against the JAX package's on the CPU:
each code (lsinu, rand, sinu, none, bias) at a 2-D 6x5 and a 3-D 4x3x5
token grid, sliding-bias radius 2, fp32 and bf16, with the same perturbed
parameters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

GRIDS = {2: (6, 5), 3: (4, 3, 5)}
EMBED, RADIUS = 16, 2


def _coords(grid, scale):
    from segtran_tpu.nn.poscode import gen_all_indices
    xy = np.asarray(gen_all_indices(grid)).reshape(-1, len(grid))
    return (xy * np.asarray(scale)[None]).astype(np.float32)[None].repeat(
        2, 0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("code", ["lsinu", "rand", "sinu", "none", "bias"])
def test_pos_code_matches_jax(code, ndim, dtype):
    from segtran_tpu.nn.poscode import SegtranPosEncoder as JEnc
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.poscode import SegtranPosEncoder as TEnc
    grid = GRIDS[ndim]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    pos = _coords(grid, (8, 8, 4)[:ndim])
    jm = JEnc(pos_code_type=code, pos_dim=ndim, pos_embed_dim=EMBED,
              pos_bias_radius=RADIUS, dtype=jdt)
    params, _ = jax_variables(jm, grid, jnp.asarray(pos), seed=11,
                              jit_init=False)
    ref = np.asarray(jm.apply(jvars(params, {}), grid, jnp.asarray(pos))
                     .astype(jnp.float32))
    tm = TEnc(code, ndim, EMBED, pos_bias_radius=RADIUS, dtype=tdt,
              spatial_shape=grid)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = tm(grid, torch.from_numpy(pos)).float().numpy()
    n = int(np.prod(grid))
    want = (1, 1, n, n) if code == "bias" else (2, n, EMBED)
    assert out.shape == ref.shape == want
    if code in ("rand", "bias"):
        assert np.abs(ref).max() > 0.1      # the perturbed parameters show
    tol = 1e-5 if dtype == "fp32" else 2e-2
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("ndim", [2, 3])
def test_relative_bias_window(ndim):
    """bias(q, k) = biases[k - q + R] inside the window, 0 outside, against
    a direct loop over every (q, k) pair."""
    from segtran_tpu_torch.nn.poscode import relative_bias_matrix
    grid = GRIDS[ndim]
    rng = np.random.RandomState(3)
    biases = rng.randn(*(2 * RADIUS + 1,) * ndim).astype(np.float32)
    got = relative_bias_matrix(torch.from_numpy(biases), grid, RADIUS).numpy()
    pts = np.stack(np.meshgrid(*[np.arange(s) for s in grid],
                               indexing="ij"), -1).reshape(-1, ndim)
    want = np.zeros((len(pts), len(pts)), np.float32)
    for qi, q in enumerate(pts):
        for ki, k in enumerate(pts):
            d = k - q
            if np.all(np.abs(d) <= RADIUS):
                want[qi, ki] = biases[tuple(d + RADIUS)]
    np.testing.assert_array_equal(got, want)


def test_rand_needs_the_grid():
    from segtran_tpu_torch.nn.poscode import SegtranPosEncoder
    with pytest.raises(ValueError, match="token grid"):
        SegtranPosEncoder("rand", 2, EMBED)
