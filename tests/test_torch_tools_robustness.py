"""The port's feature-robustness evaluation (``tools/robustness.py``) held
against the JAX package's on the CPU:

* ``_pearson`` and ``lr_half_pearson`` within 1e-6;
* each perturbation, given JAX's draw (the factor, or the noise), within
  1e-5 of JAX's ``PERTURBATIONS[name]`` (``resize_down`` antialiases, as
  ``jax.image.resize`` does when it shrinks);
* ``eval_robustness`` on a tiny Segtran2d (eff-tiny, two translayers,
  64^2, same converted weights) with JAX's draws: the same keys in the
  same order, values within 1e-4; once with a second checkpoint's
  weights giving the clean features (JAX's ``ref_variables``);
* the port's own draws come from a generator seeded by ``seed``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jvars
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import jit_model, segtran2d_pair

ALL = ("brightness", "contrast", "saturation", "resize_down", "resize_up",
       "noise")


def jax_draw(name, key, shape, lo, hi):
    """The factor or noise JAX's PERTURBATIONS[name] draws from ``key``."""
    if name in ("brightness", "contrast", "saturation"):
        return float(jax.random.uniform(key, (), minval=lo, maxval=hi))
    if name == "noise":
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))
    return None


def jax_draws(names, seed, shape, lo, hi):
    """As JAX's eval_robustness draws them: perturbation i from
    fold_in(PRNGKey(seed), i)."""
    key = jax.random.PRNGKey(seed)
    return {n: jax_draw(n, jax.random.fold_in(key, i), shape, lo, hi)
            for i, n in enumerate(names)}


def test_pearson_and_lr_half_match_jax():
    from segtran_tpu.tools import robustness as jr
    from segtran_tpu_torch.tools import robustness as tr
    rng = np.random.RandomState(0)
    a = rng.randn(2, 6, 9, 5).astype(np.float32)
    b = (0.3 * a + rng.randn(*a.shape)).astype(np.float32)
    np.testing.assert_allclose(
        float(tr._pearson(torch.from_numpy(a), torch.from_numpy(b))),
        float(jr._pearson(jnp.asarray(a), jnp.asarray(b))), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(
        float(tr.lr_half_pearson(torch.from_numpy(a))),
        float(jr.lr_half_pearson(jnp.asarray(a))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ALL)
def test_perturbation_at_jax_draw(name):
    from segtran_tpu.tools.robustness import PERTURBATIONS as JP
    from segtran_tpu_torch.tools.robustness import PERTURBATIONS
    x = np.random.RandomState(1).rand(2, 18, 24, 3).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), ALL.index(name))
    want = np.asarray(JP[name](key, jnp.asarray(x), 0.5, 1.5))
    got = PERTURBATIONS[name](torch.from_numpy(x),
                              jax_draw(name, key, x.shape, 0.5, 1.5))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return segtran2d_pair()


def _check(got, want):
    assert list(got) == list(want)
    for pert in want:
        assert list(got[pert]) == list(want[pert]), pert
        np.testing.assert_allclose(
            [got[pert][k] for k in want[pert]], list(want[pert].values()),
            rtol=0, atol=1e-4, err_msg=pert)


def test_eval_robustness_matches_jax(pair):
    from segtran_tpu.tools.robustness import eval_robustness as jeval
    from segtran_tpu_torch.tools.robustness import eval_robustness
    jm, params, bstats, tm = pair
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    want = jeval(jit_model(jm), jvars(params, bstats), jnp.asarray(x),
                 degrees=(0.5, 1.5))
    got = eval_robustness(tm, torch.from_numpy(x), degrees=(0.5, 1.5),
                          draws=jax_draws(ALL, 0, x.shape, 0.5, 1.5))
    assert list(got["noise"])[:4] == [
        "in_fpn_feat", "lr_pearson/in_fpn_feat", "std/in_fpn_feat",
        "voxel_fusion/layer_0_vfeat"]
    assert list(got["noise"])[-1] == "output_pearson"
    _check(got, want)


def test_eval_robustness_against_a_second_checkpoint(pair):
    """JAX's ref_variables: the clean features come from other weights."""
    from segtran_tpu.tools.robustness import eval_robustness as jeval
    from segtran_tpu_torch.tools.robustness import eval_robustness
    jm, params, bstats, tm = pair
    _, ref_params, ref_bstats, ref_tm = segtran2d_pair(seed=5)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    names = ("brightness", "resize_down")
    want = jeval(jit_model(jm), jvars(params, bstats), jnp.asarray(x),
                 perturbations=names, seed=4,
                 ref_variables=jvars(ref_params, ref_bstats))
    got = eval_robustness(tm, torch.from_numpy(x), perturbations=names,
                          ref_state_dict=ref_tm.state_dict(),
                          draws=jax_draws(names, 4, x.shape, 0.7, 1.3))
    _check(got, want)
    assert got["resize_down"]["output_pearson"] < 0.99


def test_port_draws_are_seeded():
    from segtran_tpu_torch.tools.robustness import draw_perturbation
    x = torch.zeros(2, 4, 4, 3)

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        return [draw_perturbation(n, x, 0.5, 1.5, gen) for n in ALL]
    a, b, c = draws(0), draws(0), draws(1)
    assert a[0] == b[0] and a[0] != c[0] and 0.5 <= a[0] <= 1.5
    assert a[3] is None and a[4] is None
    assert torch.equal(a[5], b[5]) and a[5].shape == x.shape
    with pytest.raises(KeyError, match="unknown perturbation"):
        draw_perturbation("blur", x, 0.5, 1.5, torch.Generator())
