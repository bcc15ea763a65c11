"""The port's 2-D data path held against the JAX package on the CPU: the
REFUGE-layout datasets (SegCrop, SegWhole, ConcatDataset) over a PNG tree
written here, their split lists, the localisation crop, the GAMMA labels,
the mask-shape probe, the label maps and the loader's order."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data2d import FRAMES, raw_mask, write_tree
from _torch_parity import one_torch_thread  # noqa: F401


def _assert_same_sample(got, want):
    for key in ("image", "mask", "crop_pos", "unscaled_size",
                "uncropped_size", "weight", "cls_label", "index"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
    assert got["image"].dtype == np.float32
    assert set(got) == set(want)


@pytest.mark.parametrize("cls_name", ["SegCrop", "SegWhole"])
@pytest.mark.parametrize("split,out_size", [("all", (64, 64)),
                                            ("train", None)])
def test_datasets_match_jax(tmp_path, cls_name, split, out_size):
    from segtran_tpu.data import datasets2d as jd
    from segtran_tpu_torch.data import datasets2d as td
    jroot = write_tree(str(tmp_path / "jax"))
    troot = write_tree(str(tmp_path / "port"))
    kw = dict(split=split, out_size=out_size, uncropped_size=(2056, 2124),
              ds_weight=0.5, seed=3)
    jds = getattr(jd, cls_name)(base_dir=jroot, **kw)
    tds = getattr(td, cls_name)(base_dir=troot, **kw)
    assert tds.image_list == jds.image_list and len(tds) == len(jds) > 0
    for lst in ("all.list", "train.list", "test.list"):
        with open(os.path.join(jroot, lst)) as f1, \
                open(os.path.join(troot, lst)) as f2:
            assert f1.read() == f2.read(), lst
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        _assert_same_sample(got, dict(want, image_path=got["image_path"]))
        if out_size:
            assert got["image"].shape == out_size + (3,)
            assert got["mask"].shape == out_size + (1,)
        assert "ds_idx" not in got


def test_concat_dataset_adds_ds_idx(tmp_path):
    from segtran_tpu.data import datasets2d as jd
    from segtran_tpu_torch.data import datasets2d as td
    a = write_tree(str(tmp_path / "a"))
    b = write_tree(str(tmp_path / "b"), FRAMES[:2])
    kw = dict(split="all", out_size=(64, 64))
    jcat = jd.ConcatDataset([jd.SegCrop(a, **kw), jd.SegCrop(b, **kw)])
    tcat = td.ConcatDataset([td.SegCrop(a, **kw), td.SegCrop(b, **kw)])
    assert len(tcat) == len(jcat) == 6
    for i in range(6):
        got, want = tcat[i], jcat[i]
        assert int(got["ds_idx"]) == int(want["ds_idx"]) == int(i >= 4)
        assert got["ds_idx"].dtype == np.int32
        _assert_same_sample({k: v for k, v in got.items() if k != "ds_idx"},
                            {k: v for k, v in want.items()
                             if k not in ("ds_idx", "image_path")}
                            | {"image_path": got["image_path"]})


@pytest.mark.parametrize("frac_or_shot", [0.5, 2])
def test_split_lists_match_jax(tmp_path, frac_or_shot):
    from segtran_tpu.data.datasets2d import create_split_lists as jfn
    from segtran_tpu_torch.data.datasets2d import create_split_lists
    j, t = write_tree(str(tmp_path / "j")), write_tree(str(tmp_path / "t"))
    jfn(j, frac_or_shot, seed=11)
    create_split_lists(t, frac_or_shot, seed=11)
    assert sorted(os.listdir(j)) == sorted(os.listdir(t))
    for name in os.listdir(j):
        if name.endswith(".list"):
            assert open(os.path.join(j, name)).read() == \
                open(os.path.join(t, name)).read(), name


class _Draws:
    """The same margins for both packages' localize."""

    def __init__(self, values):
        self.values = list(values)

    def randint(self, lo, hi):
        return self.values.pop(0)

    def integers(self, lo, hi, size):
        return np.array([self.values.pop(0) for _ in range(size)])


def test_localize_matches_jax():
    from segtran_tpu.data.datasets2d import localize as jfn
    from segtran_tpu_torch.data.datasets2d import localize
    mask = raw_mask(80, 80, 1)[..., None]
    fg = (mask < 255).astype(np.uint8)
    image = np.random.RandomState(2).rand(80, 80, 3)
    margins = [11, 17, 13, 19]
    ji, jm = jfn(image, fg, (40, 40), _Draws(margins))
    ti, tm = localize(image, fg, (40, 40), _Draws(margins))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_localization_draws_depend_on_seed_epoch_index(tmp_path):
    """With train_loc_prob 1 a sample's crop is the same for the same
    (seed, epoch, index), whatever was read before it."""
    from segtran_tpu_torch.data.datasets2d import SegCrop
    root = write_tree(str(tmp_path / "d"))
    kw = dict(split="all", train_loc_prob=1.0, min_output_size=(40, 40),
              seed=5)
    a, b = SegCrop(root, **kw), SegCrop(root, **kw)
    a.split = b.split = "train"
    first = a[2]["image"]
    for i in (0, 1, 3):
        b[i]
    np.testing.assert_array_equal(b[2]["image"], first)
    assert first.shape[:2] != (80, 80)


def test_gamma_labels_and_reshape_mask_match_jax(tmp_path):
    from segtran_tpu.data import datasets2d as jd
    from segtran_tpu_torch.data import datasets2d as td
    csv = tmp_path / "glaucoma_label.csv"
    csv.write_text("name,non,early,mid\n0001,1,0,0\n0002,0,0,1\n"
                   "0003,0,1,0\n")
    assert td.load_gamma_labels(str(csv)) == jd.load_gamma_labels(str(csv))
    m = np.stack([(raw_mask(80, 80, 4) < 255).astype(np.uint8) * 255] * 3,
                 -1)
    np.testing.assert_array_equal(
        td.reshape_mask(m, 0, 255, "rectangle"),
        jd.reshape_mask(m, 0, 255, "rectangle"))


@pytest.mark.parametrize("exclusive", [False, True])
def test_label_maps_match_jax(exclusive):
    from segtran_tpu.data import labelmaps as jl
    from segtran_tpu_torch.data import labelmaps as tl
    gray = np.stack([raw_mask(40, 36, s) for s in range(3)])   # [B, H, W]
    chan = np.stack([(gray <= 128), (gray == 0)], -1).astype(np.uint8) * 255
    for raw in (gray[..., None], gray, chan):
        np.testing.assert_array_equal(
            tl.fundus_map_mask(torch.from_numpy(raw), exclusive).numpy(),
            np.asarray(jl.fundus_map_mask(jnp.asarray(raw), exclusive)))
    polyp = (gray < 255).astype(np.uint8) * 255
    for raw in (polyp[..., None], np.repeat(polyp[..., None], 3, -1)):
        np.testing.assert_array_equal(
            tl.polyp_map_mask(torch.from_numpy(raw)).numpy(),
            np.asarray(jl.polyp_map_mask(jnp.asarray(raw))))
    idx = np.random.RandomState(1).randint(0, 4, (2, 9, 7))
    onehot = tl.index_to_onehot(torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jl.index_to_onehot(jnp.asarray(idx), 4)))
    np.testing.assert_array_equal(
        tl.onehot_inv_map(onehot).numpy(),
        np.asarray(jl.onehot_inv_map(jnp.asarray(onehot.numpy()))))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (False, True)])
def test_batch_iterator_order_matches_jax(shuffle, drop_last):
    from segtran_tpu.data.pipeline import batch_iterator as jfn
    from segtran_tpu_torch.data.pipeline import batch_iterator
    ds = [{"index": i, "x": np.full(2, i, np.float32)} for i in range(7)]
    kw = dict(seed=3, shuffle=shuffle, drop_last=drop_last)
    got = [b["index"].tolist() for b in batch_iterator(ds, 3, 1, **kw)]
    want = [b["index"].tolist() for b in jfn(ds, 3, 1, **kw)]
    assert got == want
    assert len(got[-1]) == (3 if drop_last else 1)
