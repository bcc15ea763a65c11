"""The port's 3-D data pieces held against the JAX package on the CPU:
AtriaSet, MSDSet (lists from dataset.json with the seed), --mod,
--xyzpermute and the sample weights on h5 fixtures built as
tests/test_cli3d.py builds them (images and labels bit-identical; a
training crop equal to the same window of JAX's padded volume: the port
draws its windows from (seed, epoch, index) on purpose); center_crop;
data/preprocessing.py (the nonzero normalisation, the bounding boxes, and
the BraTS, atria and MSD conversions through stub nibabel / nrrd modules
made from a seed, which serve both packages); and --testinterp (its
nearest downsampling bit for bit)."""
import os
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

from test_cli3d import make_atria_fixture, make_msd_fixture  # noqa: E402


def _same(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        a, b = np.asarray(port[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _window(port_ds, idx, image_shape):
    """The starts of the port's training crop of sample idx."""
    rng = np.random.default_rng((port_ds.seed, port_ds.epoch, idx))
    size = port_ds.crop_size
    padded = [max(s, t) for s, t in zip(image_shape, size)]
    return [int(rng.integers(0, s - t + 1)) for s, t in zip(padded, size)]


@pytest.mark.parametrize("crop", [(32, 40, 8), (56, 40, 20)],
                         ids=["inside", "padded"])
def test_atria_set_matches_jax(tmp_path, crop):
    from segtran_tpu.data import datasets3d as J
    from segtran_tpu_torch.data import datasets3d as T
    ds_dir = make_atria_fixture(str(tmp_path), n=2)
    ref = J.AtriaSet(ds_dir, split="all", mode="test")
    port = T.AtriaSet(ds_dir, split="all", mode="test")
    assert len(port) == len(ref) == 2 and ref.binarize and port.binarize
    for i in range(2):
        _same(port[i], ref[i])
    jtrain = J.AtriaSet(ds_dir, split="all", mode="train", crop_size=crop)
    ttrain = T.AtriaSet(ds_dir, split="all", mode="train", crop_size=crop,
                        seed=4)
    for i in range(2):
        whole = jtrain[i]            # its crop is timing-free; pad + slice
        image, label = J.pad_to_size(ref[i]["image"], ref[i]["label"], crop)
        starts = _window(ttrain, i, ref[i]["image"].shape[:3])
        sl = tuple(slice(s, s + t) for s, t in zip(starts, crop))
        got = ttrain[i]
        np.testing.assert_array_equal(got["image"], image[sl])
        np.testing.assert_array_equal(got["label"], label[sl])
        assert whole["image"].shape == got["image"].shape


def test_msd_set_lists_modality_and_permute_match_jax(tmp_path):
    from segtran_tpu.data import datasets3d as J
    from segtran_tpu_torch.data import datasets3d as T
    jdir = make_msd_fixture(str(tmp_path / "j"), n=7, shape=(24, 16, 8))
    tdir = str(tmp_path / "t")
    shutil.copytree(jdir, tdir)
    for split in ("train", "test", "all"):
        ref = J.MSDSet(jdir, split=split, mode="test", seed=3)
        port = T.MSDSet(tdir, split=split, mode="test", seed=3)
        assert port.case_list == ref.case_list, split
        assert (open(os.path.join(tdir, f"{split}.list")).read()
                == open(os.path.join(jdir, f"{split}.list")).read())
    assert len(T.MSDSet(tdir, split="train").case_list) == 5
    assert T.MSDSet(tdir).num_modalities == J.MSDSet(jdir).num_modalities == 2
    for kw in ({}, {"chosen_modality": 1}, {"xyz_permute": (1, 2, 0)},
               {"chosen_modality": 0, "xyz_permute": (2, 0, 1)}):
        ref = J.MSDSet(jdir, split="all", mode="test", **kw)
        port = T.MSDSet(tdir, split="all", mode="test", **kw)
        for i in (0, 4):
            _same(port[i], ref[i])


def test_brats_weights_and_center_crop_match_jax(tmp_path):
    from segtran_tpu.data import datasets3d as J
    from segtran_tpu_torch.data import datasets3d as T
    from test_cli3d import make_brats_fixture
    ds_dir = make_brats_fixture(str(tmp_path), n=2, shape=(48, 48, 16))
    for kw in ({}, {"ds_weight": 0.5, "weight_by_size": True},
               {"binarize": True, "weight_by_size": True}):
        ref = J.BratsSet(ds_dir, split="all", mode="test", **kw)
        port = T.BratsSet(ds_dir, split="all", mode="test", **kw)
        for i in range(2):
            _same(port[i], ref[i])
    rng = np.random.RandomState(0)
    image = rng.rand(9, 7, 5, 2).astype(np.float32)
    label = rng.randint(0, 3, (9, 7, 5)).astype(np.uint8)
    for size in ((4, 4, 4), (12, 6, 8), (9, 7, 5)):
        got = T.center_crop(image, label, size)
        want = J.center_crop(image, label, size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- preprocessing


def test_normalize_and_bounding_boxes_match_jax():
    from segtran_tpu.data import preprocessing as J
    from segtran_tpu_torch.data import preprocessing as T
    rng = np.random.RandomState(1)
    image = rng.randn(4, 20, 18, 12).astype(np.float32)
    image[:, :3] = 0.0
    image[:, :, -4:] = 0.0
    np.testing.assert_array_equal(T.normalize_nonzero(image),
                                  J.normalize_nonzero(image))
    crop = image[:, 3:15, 2:16, 1:10]
    np.testing.assert_array_equal(T.normalize_nonzero(image, crop),
                                  J.normalize_nonzero(image, crop))
    assert T.nonzero_bbox(image, 1) == J._nonzero_bbox(image, 1)
    labels = np.zeros((40, 36, 24), np.uint8)
    labels[12:20, 10:15, 6:9] = 1
    for seed in range(3):
        assert T.localized_bbox(
            labels, (16, 16, 8), labels.shape, np.random.RandomState(seed)
        ) == J._localized_bbox(labels, (16, 16, 8), labels.shape,
                               np.random.RandomState(seed))


class _Scan:
    def __init__(self, data):
        self.data = data

    def get_fdata(self):
        return self.data.astype(np.float64)


def _stub_modules(monkeypatch, seed):
    """nibabel.load / nrrd.read serving arrays made from ``seed``, keyed
    by the path's last two parts, the same for every root."""
    cache = {}

    def volume(path):
        key = "/".join(path.split(os.sep)[-2:])
        if key not in cache:
            rng = np.random.RandomState(seed + len(cache))
            if "seg" in key or "labelsTr" in path:
                vol = np.zeros((20, 22, 12))
                vol[5:14, 6:15, 3:9] = rng.randint(0, 3, (9, 9, 6))
            elif "laendo" in key:
                vol = np.zeros((48, 44, 30))
                vol[14:30, 12:28, 8:20] = 255 * rng.randint(0, 2, (16, 16, 12))
            elif "lgemri" in key:
                vol = rng.rand(48, 44, 30) * 100
            else:
                vol = np.zeros((20, 22, 12))
                vol[2:18, 3:20, 1:11] = rng.rand(16, 17, 10) + 0.1
                if "imagesTr" in path and "case1" in key:
                    vol = np.stack([vol, 2 * vol], -1)   # two modalities
            cache[key] = vol
        return cache[key]

    nib = types.ModuleType("nibabel")
    nib.load = lambda p: _Scan(volume(p))
    nrrd = types.ModuleType("nrrd")
    nrrd.read = lambda p: (volume(p), {})
    monkeypatch.setitem(sys.modules, "nibabel", nib)
    monkeypatch.setitem(sys.modules, "nrrd", nrrd)


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


@pytest.mark.parametrize("task", ["brats", "atria", "msd"])
def test_conversions_match_jax(tmp_path, monkeypatch, task):
    from segtran_tpu.data import preprocessing as J
    from segtran_tpu_torch.data import preprocessing as T
    _stub_modules(monkeypatch, seed=7)
    outs = {}
    for side, mod in (("jax", J), ("port", T)):
        root = str(tmp_path / side / "train")
        if task == "brats":
            for c in ("case0", "case1"):
                for m in J.BRATS_MODALITIES + ("seg",):
                    _touch(os.path.join(root, c, f"{c}_{m}.nii.gz"))
            got = mod.convert_brats_root(root, seed=2)
        elif task == "atria":
            for c in ("p0", "p1"):
                _touch(os.path.join(root, c, "lgemri.nrrd"))
                _touch(os.path.join(root, c, "laendo.nrrd"))
            got = mod.convert_atria_root(root, seed=2)
        else:
            for c in ("case0", "case1"):
                _touch(os.path.join(root, "imagesTr", f"{c}.nii.gz"))
            _touch(os.path.join(root, "labelsTr", "case0.nii.gz"))
            got = mod.main(["msd", "--root", root]) if side == "port" else \
                mod.convert_msd_root(root)
        outs[side] = [_h5(p) for p in got]
    assert len(outs["port"]) == len(outs["jax"]) == 2
    for p, j in zip(outs["port"], outs["jax"]):
        _same(p, j)


def test_conversion_without_nibabel_names_the_package(tmp_path, monkeypatch):
    from segtran_tpu_torch.data import preprocessing as T
    monkeypatch.setitem(sys.modules, "nibabel", None)
    with pytest.raises(ImportError, match="nibabel"):
        T.convert_msd_root(str(tmp_path))


# ------------------------------------------------------------ testinterp


@pytest.mark.parametrize("shape,factors", [
    ((20, 17, 9), ["0.5"]), ((24, 24, 16), ["0.3"]),
    ((19, 22, 13), ["0.5", "0.25", "0.75"])])
def test_testinterp_matches_jax(shape, factors):
    """JAX's null model (cli/test3d.py:322-334): the nearest downsampling
    at half-pixel centres bit for bit; the trilinear restore to fp32
    rounding (XLA and PyTorch sum the 8 corners in other orders), and the
    hardened maps equal."""
    import jax
    from segtran_tpu.data.labelmaps import harden_segmap as jharden
    from segtran_tpu.ops.resize import resize_linear
    from segtran_tpu_torch.cli.test3d import interp_probs, nearest_downsample
    from segtran_tpu_torch.data.labelmaps import harden_segmap
    rng = np.random.RandomState(0)
    gt = (rng.rand(*shape, 3) > 0.5).astype(np.float32)
    f = [float(v) for v in factors] * (3 if len(factors) == 1 else 1)
    small = tuple(max(int(s * k), 1) for s, k in zip(shape, f))
    jsmall = jax.image.resize(jnp.asarray(gt)[None], (1,) + small + (3,),
                              "nearest")
    np.testing.assert_array_equal(
        nearest_downsample(torch.from_numpy(gt), factors).numpy(),
        np.asarray(jsmall))
    want = resize_linear(jsmall, shape)[0]
    got = interp_probs(torch.from_numpy(gt), factors)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(harden_segmap(got).numpy(),
                                  np.asarray(jharden(want)))
