"""The port's test3d on the 3-D zoo nets against JAX's on the CPU:
``main`` on two h5 volumes for ``--net vnet`` (whole volume, padded to
48 x 48 x 32) and ``--net unet`` (sliding windows), JAX's ``main`` with
its init replaced by the same seeded weights
(``tests/_torch_volume.fast_variables``) and the port's on a checkpoint
of them: per-class Dice within 1e-4."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_volume import fast_variables
from test_torch_train3d_zoo import SHAPE, _jax_net


def _h5_volumes(root, shape, n=2):
    h5py = pytest.importorskip("h5py")
    ds = os.path.join(root, "brats", "2019valid")
    os.makedirs(ds)
    rng = np.random.RandomState(0)
    h, w, d = shape
    for i in range(n):
        lab = np.zeros(shape, np.uint8)
        lab[h // 4:3 * h // 4, w // 4:3 * w // 4, d // 4:3 * d // 4] = 2
        lab[h // 3:h // 2, w // 3:w // 2, d // 3:d // 2] = 1
        lab[h // 3:h // 3 + 3, w // 3:w // 3 + 3, d // 3:d // 3 + 2] = 4
        with h5py.File(os.path.join(ds, f"case{i}.h5"), "w") as f:
            f.create_dataset("image", data=rng.rand(4, *shape).astype(
                np.float32))
            f.create_dataset("label", data=lab)


@pytest.mark.parametrize("net,flags", [("vnet", ["--wholevol"]),
                                       ("unet", [])])
def test_test3d_dice_matches_jax(net, flags, tmp_path, monkeypatch):
    import segtran_tpu.utils.cache as jcache
    from segtran_tpu.cli import test3d as jt3
    from segtran_tpu_torch.cli import test3d
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    root = str(tmp_path / "data")
    _h5_volumes(root, (40, 36, 30))           # pads to 48 x 48 x 32
    argv = ["--task", "brats", "--net", net, "--patchsize", "32,32,16",
            "--inputsize", "32,32,16", "--dataroot", root, *flags]
    params, _ = fast_variables(_jax_net(net),
                               jnp.zeros((1,) + SHAPE + (4,)), seed=8)
    monkeypatch.setattr(jcache, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jt3, "init_with_reference_schemes",
                        lambda *a, **k: (params, {}))
    want = jt3.main(argv + ["--cpdir", str(tmp_path / "jax")])[None]
    model, _ = test3d.build_model_and_config(
        test3d.build_argparser().parse_args(argv + ["--cpdir", "unused"]),
        test3d.task_settings(test3d.build_argparser().parse_args(
            argv + ["--cpdir", "unused"])))
    ckdir = str(tmp_path / "port")
    save_checkpoint(ckdir, 3, state_dict_from_jax(params, None,
                                                  model.state_dict()))
    got = test3d.main(argv + ["--cpdir", ckdir, "--iters", "3",
                              "--device", "cpu"])[3]
    assert np.isfinite(want).all() and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
