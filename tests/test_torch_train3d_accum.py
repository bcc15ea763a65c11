"""``train3d --gradaccum 2`` against JAX's gradient accumulation over two
steps (tests/_torch_train3d.py), and the ``train3d`` CLI on h5 fixtures
whose checkpoint the port's ``test3d`` then evaluates."""
import os

import numpy as np
import pytest
import torch

from _torch_train3d import check_two_train_steps, make_jax_side
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side()


def test_two_train_steps_with_gradaccum_match_jax(jax_side, monkeypatch):
    check_two_train_steps("gradaccum2", jax_side, monkeypatch)


def test_train3d_cli_and_test3d_on_its_checkpoint(tmp_path):
    pytest.importorskip("h5py")
    from test_cli3d import make_brats_fixture
    from segtran_tpu_torch.cli import test3d, train3d
    root = str(tmp_path / "data")
    make_brats_fixture(root)
    ckpt_dir = train3d.main([
        "--task", "brats", "--ds", "2019train", "--split", "all",
        "--attractors", "8", "--maxiter", "2", "--saveiter", "2",
        "--bs", "1", "--patchsize", "48,48,16", "--inputsize", "48,48,16",
        "--fused", "--dropout", "0", "--dataroot", root,
        "--ckptdir", str(tmp_path / "model"), "--device", "cpu"])
    assert os.path.isfile(os.path.join(ckpt_dir, "iter_2.pt"))
    assert os.path.isfile(os.path.join(ckpt_dir, "iter_2.config.json"))
    sd = torch.load(os.path.join(ckpt_dir, "iter_2.pt"), weights_only=True)
    assert "backbone.Conv3d_1a_7x7.bn.running_mean" in sd
    results = test3d.main([
        "--task", "brats", "--ds", "2019train", "--split", "all",
        "--attractors", "8", "--cpdir", ckpt_dir, "--iters", "2",
        "--wholevol", "--fused", "--dataroot", root, "--device", "cpu"])
    assert len(results[2]) == 3 and np.isfinite(results[2]).all()
    with pytest.raises(NotImplementedError, match="later slice"):
        train3d.main(["--tp", "2", "--device", "cpu"])
