"""train3d and test3d under a process group on gloo ranks on the CPU
(tests/_torch_dist.py; ``torchrun``'s env, ``--device cpu``):
``train3d --ndevices 2`` (the tiny BraTS Segtran3d, ``--fused --dropout
0``, one volume per rank) writes an ``iter_2.pt`` equal to the
one-process run's to 1e-5, and ``test3d --wholevol --spatialshard`` on it
over 2 ranks (each an H slab of every volume's logits, Dice from the
all-reduced sums) gives the one-process Dice."""
import os
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_train3d import STATS_TOL
from _torch_dist import launch
from _torch_parity import one_torch_thread  # noqa: F401

UPDATE_REL = 0.05
TRAIN = ["--task", "brats", "--ds", "2019train", "--split", "all",
         "--attractors", "8", "--maxiter", "2", "--saveiter", "2", "--bs",
         "2", "--patchsize", "48,48,16", "--inputsize", "48,48,16",
         "--fused", "--dropout", "0", "--seed", "3", "--device", "cpu"]


def test_train3d_and_spatialshard_test3d_match_one_process(tmp_path,
                                                           monkeypatch):
    pytest.importorskip("h5py")
    from test_cli3d import make_brats_fixture
    from segtran_tpu_torch.cli import test3d, train3d
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    root = str(tmp_path / "data")
    make_brats_fixture(root)
    argv = TRAIN + ["--dataroot", root]
    out = launch(ranks.cli, 2, tmp_path / "ranks", module="train3d",
                 argv=argv + ["--ndevices", "2", "--ckptdir",
                              str(tmp_path / "many")])
    ckpt = str(out[0]["ckpt"])
    assert str(out[1]["ckpt"]) == ckpt
    assert sorted(os.listdir(ckpt)) == ["iter_2.config.json", "iter_2.pt",
                                        "train3d_log.txt"]
    got = torch.load(os.path.join(ckpt, "iter_2.pt"), weights_only=True)
    one = train3d.main(argv + ["--ckptdir", str(tmp_path / "one")])
    want = torch.load(os.path.join(one, "iter_2.pt"), weights_only=True)
    assert set(got) == set(want)
    # the initial weights, as train3d.main draws them
    args = train3d.build_argparser().parse_args(argv)
    model, cfg = train3d.build_model_and_config(args,
                                                train3d.task_settings(args))
    init_with_reference_schemes(model, cfg, seed=3)
    p0 = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **STATS_TOL, err_msg=k)
    names = [k for k in want if k not in stats
             and want[k].is_floating_point()]
    d_many = torch.cat([(got[k] - p0[k]).reshape(-1) for k in names])
    d_one = torch.cat([(want[k] - p0[k]).reshape(-1) for k in names])
    rel = float((d_many - d_one).norm() / d_one.norm())
    assert rel < UPDATE_REL, rel
    # test3d on the seeded eval init, whose logits straddle 0: every class
    # has predictions (the two-step checkpoint predicts none)
    save_checkpoint(ckpt, 3, init_segtran3d(model, seed=0).state_dict(), cfg)
    evals = ["--task", "brats", "--ds", "2019train", "--split", "all",
             "--attractors", "8", "--cpdir", ckpt, "--iters", "3",
             "--wholevol", "--fused", "--fusedepi", "--device", "cpu",
             "--dataroot", root]
    sharded = launch(ranks.cli, 2, tmp_path / "eval", module="test3d",
                     argv=evals + ["--spatialshard"])
    single = test3d.main(evals)[3]
    assert min(single) > 5e-4, single
    for r in sharded:
        np.testing.assert_allclose(r["dice"][0], single, rtol=1e-6,
                                   atol=1e-9)
