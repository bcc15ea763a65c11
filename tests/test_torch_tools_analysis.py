"""The port's analysis tools (``tools/analysis.py``) held against the JAX
package's on the CPU:

* ``dump_pixel_features`` writes an npz equal to JAX's (the same
  RandomState subsample, float16 features);
* ``tsne_features`` gives JAX's embedding through scikit-learn, and with
  scikit-learn hidden JAX's SVD fallback;
* ``hausdorff_matrix`` within 1e-6 (with and without the class-wise
  normalisation);
* ``effective_receptive_field`` and ``layer_receptive_fields`` on a tiny
  Segtran2d (eff-tiny, two translayers, 64^2, same converted weights) at
  JAX's probe input: the same layer names, maps within 1e-4 of their
  maximum; a model that keeps no features is probed at its output;
* under --fusedepi the probe raises ValueError, as JAX's does (its
  Pallas epilogue cannot be linearized);
* ``compute_dataset_stats``, ``write_stats_json`` and ``vcdr_csv_eval``
  equal to JAX's.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jvars
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import segtran2d_pair


def _dump(tmp_path, name, seed, n=300, c=6, max_pixels=200):
    """One feature dump written by both packages; returns their paths."""
    from segtran_tpu.tools.analysis import dump_pixel_features as jdump
    from segtran_tpu_torch.tools.analysis import dump_pixel_features
    rng = np.random.RandomState(seed)
    feat = rng.randn(n // 20, 20, c).astype(np.float32)
    mask = rng.randint(0, 3, (n // 20, 20))
    jp, tp = str(tmp_path / f"j{name}.npz"), str(tmp_path / f"t{name}.npz")
    jdump(feat, mask, jp, max_pixels=max_pixels)
    dump_pixel_features(feat, mask, tp, max_pixels=max_pixels)
    return jp, tp


def test_dump_pixel_features_equals_jax(tmp_path):
    jp, tp = _dump(tmp_path, "a", 0)
    j, t = np.load(jp), np.load(tp)
    assert sorted(j.files) == sorted(t.files) == ["features", "labels"]
    assert t["features"].dtype == np.float16 and len(t["labels"]) == 200
    for k in j.files:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("sklearn", [True, False], ids=["tsne", "svd"])
def test_tsne_features_matches_jax(tmp_path, monkeypatch, sklearn):
    from segtran_tpu.tools.analysis import tsne_features as jtsne
    from segtran_tpu_torch.tools.analysis import tsne_features
    _, tp = _dump(tmp_path, "b", 1, n=120, max_pixels=1000)
    if not sklearn:
        monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    emb, lab = tsne_features(tp, perplexity=10.0)
    jemb, jlab = jtsne(tp, perplexity=10.0)
    assert emb.shape == (120, 2)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=1e-6)


@pytest.mark.parametrize("feat_norm", [False, True])
def test_hausdorff_matrix_matches_jax(tmp_path, feat_norm):
    from segtran_tpu.tools.analysis import hausdorff_matrix as jfn
    from segtran_tpu_torch.tools.analysis import hausdorff_matrix
    paths = [_dump(tmp_path, str(i), 10 + i, n=200)[1] for i in range(2)]
    got = hausdorff_matrix(paths, 3, max_points_per_class=40,
                           feat_norm=feat_norm)
    want = jfn(paths, 3, max_points_per_class=40, feat_norm=feat_norm)
    assert got.shape == (2, 3, 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    return segtran2d_pair()


def _probe(shape):
    """JAX's probe input: N(0, 1) * 0.5 from PRNGKey(0)."""
    x = jax.random.normal(jax.random.PRNGKey(0), (1,) + shape) * 0.5
    return torch.from_numpy(np.array(x))


def _close_to_max(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got / want.max(), want / want.max(), rtol=0,
                               atol=1e-4)


def test_layer_receptive_fields_match_jax(pair):
    from segtran_tpu.tools.analysis import layer_receptive_fields as jfn
    from segtran_tpu_torch.tools.analysis import layer_receptive_fields
    jm, params, bstats, tm = pair
    shape = (64, 64, 3)
    want = jfn(jm, jvars(params, bstats), shape, [0, 2])
    got = layer_receptive_fields(tm, shape, [0, 2], probe=_probe(shape))
    assert list(got) == list(want) == ["in_fpn", "layer_1"]
    for name in want:
        _close_to_max(got[name], want[name])
    # every kept layer, in the reference's feature_maps order
    all_maps = layer_receptive_fields(tm, shape, probe=_probe(shape))
    assert list(all_maps) == ["in_fpn", "layer_0", "layer_1"]
    np.testing.assert_array_equal(all_maps["layer_1"], got["layer_1"])
    assert not tm.keep_features and tm.in_fpn_feat is None


def test_effective_receptive_field_matches_jax(pair):
    from segtran_tpu.tools.analysis import effective_receptive_field as jfn
    from segtran_tpu_torch.tools.analysis import (effective_receptive_field,
                                                  layer_receptive_fields)
    jm, params, bstats, tm = pair
    shape = (64, 64, 3)
    want = jfn(jm, jvars(params, bstats), shape)
    got = effective_receptive_field(tm, shape, probe=_probe(shape))
    _close_to_max(got, want)
    # a model that keeps nothing is probed at its output
    wrapped = torch.nn.Sequential(tm)
    out = layer_receptive_fields(wrapped, shape, probe=_probe(shape))
    assert list(out) == ["output"]
    np.testing.assert_allclose(out["output"], got, rtol=0, atol=1e-7)
    drawn = effective_receptive_field(tm, shape)       # the seeded draw
    assert drawn.shape == (64, 64) and np.isfinite(drawn).all()
    np.testing.assert_array_equal(drawn, effective_receptive_field(tm, shape))


def test_fusedepi_probe_raises_as_jax(pair):
    """--vis rf --fusedepi: JAX's grad through the Pallas epilogue fails to
    linearize (ValueError); the port's epilogue op has no backward and
    raises ValueError naming the flag."""
    import dataclasses
    from segtran_tpu.tools.analysis import layer_receptive_fields as jfn
    from segtran_tpu_torch.tools.analysis import layer_receptive_fields
    jm, params, bstats, tm = pair
    shape = (64, 64, 3)
    jfused = type(jm)(dataclasses.replace(jm.cfg, use_fused_epilogue=True))
    with pytest.raises(ValueError, match="Linearization failed"):
        jfn(jfused, jvars(params, bstats), shape, [2])
    specs = [(m, m.spec) for m in tm.modules()
             if hasattr(m, "spec") and hasattr(m.spec, "use_fused_epilogue")]
    for m, s in specs:
        object.__setattr__(m, "spec", dataclasses.replace(
            s, use_fused_epilogue=True))
    try:
        with pytest.raises(ValueError, match="--fusedepi"):
            layer_receptive_fields(tm, shape, [2], probe=_probe(shape))
        # the in-FPN layer lies before the epilogue: its probe runs
        assert list(layer_receptive_fields(tm, shape, [0],
                                           probe=_probe(shape))) == ["in_fpn"]
    finally:
        for m, s in specs:
            object.__setattr__(m, "spec", s)


def test_stats_and_vcdr_csv_match_jax(tmp_path):
    from segtran_tpu.tools import analysis as ja
    from segtran_tpu_torch.tools import analysis as ta
    rng = np.random.RandomState(4)
    ds = [{"image": rng.rand(7, 9, 3).astype(np.float32)} for _ in range(5)]
    stats = ta.compute_dataset_stats(ds, sample_limit=4)
    assert stats == ja.compute_dataset_stats(ds, sample_limit=4)
    by_ds = {"train": stats, "valid": ta.compute_dataset_stats(ds)}
    ta.write_stats_json(by_ds, str(tmp_path / "t.json"))
    ja.write_stats_json(by_ds, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert json.loads((tmp_path / "t.json").read_text())["mean"]["train"] \
        == stats["mean"]
    (tmp_path / "p.csv").write_text("a,0.5\nb,0.7\nc,x\nd,0.1\n")
    (tmp_path / "g.csv").write_text("name,vcdr\na,0.4\nb,0.9\nd,0.1\n")
    got = ta.vcdr_csv_eval(str(tmp_path / "p.csv"), str(tmp_path / "g.csv"))
    assert got == ja.vcdr_csv_eval(str(tmp_path / "p.csv"),
                                   str(tmp_path / "g.csv"))
    assert got["n"] == 3
