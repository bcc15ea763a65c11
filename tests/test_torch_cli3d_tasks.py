"""The port's train3d then test3d on the CPU over h5 fixtures built as
tests/test_cli3d.py builds them: the atria task (one modality, binarized
labels), the MSD task (lists from dataset.json, --mod and --xyzpermute,
the input channels probed from them), and --segtran 25d --dgroup 2 on
BraTS volumes, as tests/test_train_flags.py:246 runs JAX's (eff-tiny
here). The models'
logits and the datasets are held against JAX in
tests/test_torch_segtran3d_options.py, tests/test_torch_segtran25d.py and
tests/test_torch_datasets3d.py; here the CLIs run end to end."""
import os

import numpy as np
import pytest

pytest.importorskip("h5py")

from test_cli3d import (make_atria_fixture, make_brats_fixture,  # noqa: E402
                        make_msd_fixture)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CLIs' small steps on one intra-op thread: beside the other
    test workers, more threads only contend for the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = ["--translayers", "1", "--attractors", "8", "--patchsize",
         "32,32,16", "--inputsize", "32,32,16", "--device", "cpu"]


def _run(tmp_path, task, ds, train_extra, test_extra, train_split="all",
         test_split="all"):
    from segtran_tpu_torch.cli import test3d, train3d
    root = str(tmp_path / "data")
    ckpt_dir = train3d.main(SMALL + [
        "--task", task, "--ds", ds, "--split", train_split, "--maxiter", "1",
        "--saveiter", "1", "--bs", "1", "--dataroot", root, "--ckptdir",
        str(tmp_path / "model")] + train_extra)
    assert os.path.isfile(os.path.join(ckpt_dir, "iter_1.pt"))
    results = test3d.main(SMALL + [
        "--task", task, "--ds", ds, "--split", test_split, "--cpdir",
        ckpt_dir, "--iters", "1", "--dataroot", root, "--outdir",
        str(tmp_path / "preds")] + test_extra)
    assert all(np.isfinite(results[1]))
    assert os.path.isfile(tmp_path / "preds" / "pred.tar")
    return ckpt_dir, results[1]


def test_atria_train_and_eval(tmp_path):
    make_atria_fixture(str(tmp_path / "data"), shape=(32, 32, 16))
    _, dice = _run(tmp_path, "atria", "2018train", ["--into3", "dup3"],
                   ["--into3", "dup3", "--wholevol", "--testinterp", "0.5"])
    assert len(dice) == 1
    # the null model on the ground truth scores near 1
    assert dice[0] > 0.9


def test_msd_train_and_eval(tmp_path):
    """Lists made from dataset.json (85/15 of 4: 3 train, 1 test); one
    of the two stored modalities (--mod 1, so the model takes one
    channel) with the axes permuted (--xyzpermute 0,2,1)."""
    ds_dir = make_msd_fixture(str(tmp_path / "data"), shape=(32, 16, 32))
    flags = ["--mod", "1", "--xyzpermute", "0,2,1", "--nclasses", "3"]
    ckpt_dir, dice = _run(tmp_path, "msd", "Task05_Prostate",
                          flags + ["--outdrop"], flags, train_split="train",
                          test_split="test")
    assert len(dice) == 2
    for split in ("train", "test", "all"):
        assert os.path.isfile(os.path.join(ds_dir, f"{split}.list")), split
    assert len(open(os.path.join(ds_dir, "train.list")).read().split()) == 3
    log = open(os.path.join(ckpt_dir, "train3d_log.txt")).read()
    assert "orig_in_channels probed: 1" in log


def test_train3d_25d_dgroup(tmp_path):
    make_brats_fixture(str(tmp_path / "data"), n=1, shape=(32, 32, 16))
    flags = ["--segtran", "25d", "--dgroup", "2", "--bb", "eff-tiny"]
    _run(tmp_path, "brats", "2019train", flags, flags + ["--wholevol"])


@pytest.mark.parametrize("cli", ["train3d", "test3d"])
def test_flags_jax_ignores_in_3d_set_nothing(cli):
    """--inbn and --gbias reach no 3-D model in JAX (its configs carry
    them, its Segtran3d/25d never read them): the port's config with them
    equals the one without; --posr sets the bias radius."""
    import importlib
    mod = importlib.import_module(f"segtran_tpu_torch.cli.{cli}")
    common = (["--attractors", "8", "--device", "cpu"]
              + (["--cpdir", "unused"] if cli == "test3d" else []))
    cfgs = []
    for extra in ([], ["--inbn", "--gbias"], ["--posr", "3"]):
        args = mod.build_argparser().parse_args(common + extra)
        cfgs.append(mod.build_model_and_config(args, mod.task_settings(
            args))[1])
    assert cfgs[1] == cfgs[0]
    assert cfgs[2].pos_bias_radius == 3 and cfgs[0].pos_bias_radius == 7
