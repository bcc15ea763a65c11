"""train2d under a process group on gloo ranks on the CPU
(tests/_torch_dist.py; ``torchrun``'s env, ``--device cpu``): two
``--ndevices 2`` steps with ``--attnconsist`` (a batch-joint loss) and two
``--ndevices 4 --tp 2 --ep`` steps on a REFUGE-layout PNG tree, each
``iter_2.pt`` equal to the one-process run's to 1e-5 (BatchNorm
statistics included; dropout off, drop-connect drawn from the global
batch); rank 0 alone writes the checkpoint, the log and TensorBoard."""
import glob
import os

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_data2d import write_tree
from _torch_dist import launch
from _torch_parity import one_torch_thread  # noqa: F401

ARGV = ["--task", "fundus", "--split", "all", "--bb", "eff-tiny",
        "--translayers", "2", "--attractors", "8", "--maxiter", "2",
        "--saveiter", "2", "--bs", "4", "--origsize", "64", "--patchsize",
        "64", "--dropout", "0", "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_tree(str(root / "fundus" / "train"))
    return str(root)


def _one_process(tmp_path, argv, monkeypatch):
    import sys
    from segtran_tpu_torch.cli import train2d
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    ckpt = train2d.main(argv + ["--ckptdir", str(tmp_path / "one")])
    return torch.load(os.path.join(ckpt, "iter_2.pt"), weights_only=True)


@pytest.mark.parametrize("world,extra", [
    (2, ["--ndevices", "2", "--attnconsist"]),
    (4, ["--ndevices", "4", "--tp", "2", "--ep"])])
def test_train2d_multi_rank_checkpoint_equals_one_process(tmp_path, dataroot,
                                                          world, extra,
                                                          monkeypatch):
    argv = ARGV + ["--dataroot", dataroot] + extra
    out = launch(ranks.cli, world, tmp_path / "ranks", module="train2d",
                 argv=argv + ["--ckptdir", str(tmp_path / "many")])
    ckpt = str(out[0]["ckpt"])
    assert all(str(o["ckpt"]) == ckpt for o in out)
    got = torch.load(os.path.join(ckpt, "iter_2.pt"), weights_only=True)
    assert sorted(os.listdir(ckpt)) == ["iter_2.config.json", "iter_2.pt",
                                        "log", "train2d_log.txt"]
    log = open(os.path.join(ckpt, "train2d_log.txt")).read()
    assert log.count("saved iter_2") == 1
    one_argv = [a for a in argv if a not in ("--ep",)]
    for flag in ("--ndevices", "--tp"):
        if flag in one_argv:
            i = one_argv.index(flag)
            del one_argv[i:i + 2]
    want = _one_process(tmp_path, one_argv, monkeypatch)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(),
                                   v.float().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert glob.glob(os.path.join(ckpt, "log", "events.out.tfevents.*"))
