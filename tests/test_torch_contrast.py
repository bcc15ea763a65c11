"""train/contrast.py held against the JAX package on the CPU: pearson and
lr_pearson, avg_hausdorff (top-k, one-way, self-distances excluded) with
its gradient, avg_hausdorff_np, load_reference_features from an .npz and
from a torch dict, calc_contrast_losses (positive, and negative with the
other class JAX's key picks, injected) with its feature gradient,
normalize_features_by_class; and one whole step pair of --net
unet-scratch --contrastweight --negcontrast --reffeatcp against JAX's
make_full_step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _close_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-9


def _bank_file(path, dim, per_class=30, seed=0):
    rng = np.random.RandomState(seed)
    np.savez(path, features=rng.randn(3 * per_class, dim).astype(np.float32),
             labels=np.repeat([0, 1, 2], per_class))
    return str(path)


def test_pearson_matches_jax():
    from segtran_tpu.train import contrast as jc
    from segtran_tpu_torch.train import contrast as tc
    rng = np.random.RandomState(1)
    a, b = rng.randn(3, 8).astype(np.float32), rng.randn(3, 8).astype(
        np.float32)
    const = np.full((3, 8), 2.0, np.float32)
    for x, y in ((a, b), (a, const), (const, const)):
        np.testing.assert_allclose(
            float(tc.pearson(torch.from_numpy(x), torch.from_numpy(y))),
            float(jc.pearson(jnp.asarray(x), jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(float(tc.lr_pearson(torch.from_numpy(a))),
                               float(jc.lr_pearson(jnp.asarray(a))), **TOL)


@pytest.mark.parametrize("topk,one_way,same", [(1, False, False),
                                               (3, True, False),
                                               (2, False, True)])
def test_avg_hausdorff_matches_jax(topk, one_way, same):
    from segtran_tpu.train import contrast as jc
    from segtran_tpu_torch.train import contrast as tc
    rng = np.random.RandomState(2)
    a = rng.randn(20, 6).astype(np.float32)
    b = rng.randn(15, 6).astype(np.float32)
    if same:
        # small integers: the self-distances come out exactly 0 in both
        # packages' expanded form and are excluded (others are >= 1)
        a = b = rng.randint(-3, 4, (20, 6)).astype(np.float32)
    want, ga = jax.value_and_grad(lambda x: jc.avg_hausdorff(
        x, jnp.asarray(b), topk, one_way))(jnp.asarray(a))
    at = torch.from_numpy(a.copy()).requires_grad_()
    got = tc.avg_hausdorff(at, torch.from_numpy(b), topk, one_way)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    if not same:          # integer points tie, and ties route gradients
        _close_grad(at.grad.numpy(), ga)
    np.testing.assert_allclose(tc.avg_hausdorff_np(a, b),
                               jc.avg_hausdorff_np(a, b), rtol=1e-12)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_load_reference_features_matches_jax(tmp_path, fmt):
    """Subsampling by the seeded permutation, --refclasses, and classes
    with fewer than top-k points left out."""
    from segtran_tpu.train import contrast as jc
    from segtran_tpu_torch.train import contrast as tc
    rng = np.random.RandomState(3)
    feats = rng.randn(60, 5).astype(np.float32)
    labels = np.concatenate([np.zeros(40), np.ones(2), np.full(18, 2)])
    path = str(tmp_path / f"bank.{fmt}")
    if fmt == "npz":
        np.savez(path, features=feats, labels=labels)
    else:
        torch.save({"features": torch.from_numpy(feats),
                    "labels": torch.from_numpy(labels)}, path)
    for sel in (None, (0, 2)):
        want = jc.load_reference_features(path, 25, 3, sel, seed=4)
        got = tc.load_reference_features(path, 25, 3, sel, seed=4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert not got[1][1].any()


@pytest.mark.parametrize("neg", [False, True])
def test_calc_contrast_losses_matches_jax(tmp_path, neg):
    """pos and neg (the other classes JAX's key picks, injected) and the
    gradient of contrast_w * (pos - neg) into the features."""
    from segtran_tpu.train import contrast as jc
    from segtran_tpu_torch.train import contrast as tc
    path = _bank_file(tmp_path / "bank.npz", 16)
    bank, valid = jc.load_reference_features(path, 20, 3)
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 8, 8, 16).astype(np.float32)
    mask = (rng.rand(2, 16, 16, 3) > 0.5).astype(np.float32)
    cw = np.asarray([0.0, 1.0, 2.0], np.float32) * 2 / 3
    key = jax.random.PRNGKey(6)

    def jf(f):
        pos, n = jc.calc_contrast_losses(
            f, jnp.asarray(mask), jnp.asarray(bank), jnp.asarray(valid),
            jnp.asarray(cw), rng=key, do_neg_contrast=neg)
        return pos - n, (pos, n)
    (_, (wpos, wneg)), gf = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(feats))
    offs = torch.from_numpy(np.asarray(jax.random.randint(
        key, (3,), 1, 3)).astype(np.int64))
    ft = torch.from_numpy(feats).requires_grad_()
    pos, n = tc.calc_contrast_losses(
        ft, torch.from_numpy(mask), torch.from_numpy(bank),
        torch.from_numpy(valid), torch.from_numpy(cw), neg_offsets=offs,
        do_neg_contrast=neg)
    (pos - n).backward()
    np.testing.assert_allclose(float(pos.detach()), float(wpos), rtol=1e-5)
    np.testing.assert_allclose(float(n.detach()), float(wneg), rtol=1e-5,
                               atol=1e-7)
    assert (float(wneg) > 0) == neg
    _close_grad(ft.grad.numpy(), gf)


def test_normalize_features_by_class_matches_jax():
    from segtran_tpu.train import contrast as jc
    from segtran_tpu_torch.train import contrast as tc
    rng = np.random.RandomState(7)
    f = rng.randn(30, 4)
    c = rng.randint(0, 3, 30)
    np.testing.assert_array_equal(tc.normalize_features_by_class(f, c),
                                  jc.normalize_features_by_class(f, c))


def test_contrast_step_matches_jax(tmp_path):
    """Two steps with the contrastive losses on the U-Net's DA feature
    (the fundus mask made exclusive) against JAX."""
    from _torch_da import check_run, jax_run
    from segtran_tpu.configs.presets import TASK_SETTINGS
    argv = ["--task", "fundus", "--net", "unet-scratch", "--contrastweight",
            "0.01", "--negcontrast", "--reffeatcp",
            _bank_file(tmp_path / "bank.npz", 64), "--numreffeat", "30",
            "--origsize", "64", "--patchsize", "64", "--bs", "2",
            "--maxiter", "4", "--lrwarmup", "2", "--seed", "0"]
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(64, 64))
    j = jax_run(argv, task, (64, 64))
    assert j["metrics"][0]["contrast_neg_loss"] > 0
    check_run(argv, j)
