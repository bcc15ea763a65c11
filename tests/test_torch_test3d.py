"""The port's 3D evaluation pieces held against the JAX package on the CPU:
BraTS label maps, the 3D sliding window, one whole volume through
evaluate_volume, and the test3d CLI end to end on h5 volumes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401


def test_brats_label_maps_match_jax():
    from segtran_tpu.data import labelmaps3d as J
    from segtran_tpu_torch.data import labelmaps3d as T
    rng = np.random.RandomState(0)
    lab = rng.randint(0, 4, (6, 5, 4))
    probs = rng.rand(6, 5, 4, 4).astype(np.float32)
    for binarize in (False, True):
        np.testing.assert_array_equal(
            T.brats_map_label(torch.from_numpy(lab), binarize).numpy(),
            np.asarray(J.brats_map_label(jnp.asarray(lab), binarize)))
    for conservative in (False, True):
        np.testing.assert_allclose(
            T.make_brats_pred_consistent(torch.from_numpy(probs),
                                         conservative).numpy(),
            np.asarray(J.make_brats_pred_consistent(jnp.asarray(probs),
                                                    conservative)))
    np.testing.assert_allclose(
        T.brats_inv_map_label(torch.from_numpy(probs)).numpy(),
        np.asarray(J.brats_inv_map_label(jnp.asarray(probs))), rtol=1e-6)


@pytest.mark.parametrize("window_batch", [None, 3])
def test_sliding_window_3d_matches_jax(window_batch):
    """A pointwise 'model' whose input size differs from the window, so the
    gather, both resizes, the chunking and the blend are all exercised."""
    from segtran_tpu.infer.sliding import sliding_window_3d as jsw
    from segtran_tpu_torch.infer.sliding import sliding_window_3d as tsw
    rng = np.random.RandomState(1)
    vol = rng.rand(1, 20, 14, 9, 2).astype(np.float32)
    w = rng.randn(2, 3).astype(np.float32)
    ref = np.asarray(jsw(lambda x: x @ jnp.asarray(w), jnp.asarray(vol),
                         (12, 12, 8), (8, 8, 4), num_classes=3,
                         window_batch=window_batch))
    out = tsw(lambda x: x @ torch.from_numpy(w), torch.from_numpy(vol),
              (12, 12, 8), (8, 8, 4), num_classes=3,
              window_batch=window_batch)
    assert tuple(out.shape) == ref.shape == (1, 20, 14, 9, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _small_args(extra=()):
    from segtran_tpu_torch.cli.test3d import build_argparser
    return build_argparser().parse_args(
        ["--attractors", "8", "--cpdir", "unused", "--device", "cpu",
         *extra])


def test_evaluate_volume_matches_jax_whole_volume():
    """The JAX test3d whole-volume branch (pad to (16, 16, 8), one
    forward, sigmoid, class consistency, hardening, Dice) on the same
    converted weights."""
    from segtran_tpu.data.labelmaps import harden_segmap as jharden
    from segtran_tpu.data.labelmaps3d import (brats_map_label,
                                              make_brats_pred_consistent)
    from segtran_tpu.infer.metrics import dice_score_nd
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    from segtran_tpu_torch.cli.test3d import (build_model_and_config,
                                              evaluate_volume, task_settings)
    from segtran_tpu_torch.convert import state_dict_from_jax

    args = _small_args(["--wholevol", "--fused", "--fusedepi"])
    task = task_settings(args)
    model, tcfg = build_model_and_config(args, task)
    jkw = {f: getattr(tcfg, f) for f in (
        "num_classes", "num_attractors", "orig_in_channels",
        "use_fused_attention", "use_fused_epilogue")}
    jcfg = JCfg(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                **jkw).derive(translayer_compress_ratios=(1.0, 1.0))
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros((1, 32, 32, 16, 4)), seed=6)
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    model.eval()

    rng = np.random.RandomState(3)
    shape = (30, 36, 13)                      # pads to 32 x 48 x 16
    lab = np.zeros(shape, np.uint8)
    lab[8:20, 10:24, 3:9] = 2
    lab[10:16, 12:18, 4:7] = 1
    lab[12:14, 14:16, 5:6] = 3
    sample = {"image": rng.rand(*shape, 4).astype(np.float32), "label": lab}
    probs, hard, metrics = evaluate_volume(model, sample, args, task,
                                           torch.device("cpu"))

    vol = jnp.asarray(sample["image"])[None]
    volp = jnp.pad(vol, [(0, 0), (0, 2), (0, 12), (0, 3), (0, 0)])
    logits = jax.jit(jm.apply)(jvars(params, bstats), volp)
    jprobs = make_brats_pred_consistent(jax.nn.sigmoid(
        logits[:, :30, :36, :13].astype(jnp.float32))[0])
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-4,
                               atol=1e-4)
    jhard = np.asarray(jharden(jprobs))
    gt = np.asarray(brats_map_label(jnp.asarray(lab)))
    want = [dice_score_nd(jhard[..., c], gt[..., c]) for c in range(1, 4)]
    np.testing.assert_allclose(metrics["dice"], want, rtol=1e-6)


def test_test3d_cli_end_to_end_on_the_cpu(tmp_path):
    """main() on BraTS-like h5 volumes: whole volume, flash attention and
    the fused epilogue (their plain versions on the CPU)."""
    h5py = pytest.importorskip("h5py")
    from segtran_tpu_torch.cli.test3d import (build_model_and_config, main,
                                              task_settings)
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    from segtran_tpu_torch.train.checkpoint import save_checkpoint

    ds_dir = tmp_path / "data" / "brats" / "2019valid"
    os.makedirs(ds_dir)
    rng = np.random.RandomState(0)
    for i in range(2):
        lab = np.zeros((40, 40, 20), np.uint8)
        lab[10:30, 10:30, 5:15] = 2
        lab[14:24, 14:24, 7:12] = 1
        lab[17:20, 17:20, 9:10] = 4           # raw ET, remapped to 3
        with h5py.File(ds_dir / f"case{i}.h5", "w") as f:
            f.create_dataset("image", data=rng.rand(4, 40, 40, 20).astype(
                np.float32))
            f.create_dataset("label", data=lab)
    argv = ["--task", "brats", "--attractors", "8", "--cpdir",
            str(tmp_path / "model"), "--iters", "3", "--wholevol",
            "--fused", "--fusedepi", "--device", "cpu", "--dataroot",
            str(tmp_path / "data"), "--outdir", str(tmp_path / "preds")]
    args = _small_args(argv)
    model, cfg = build_model_and_config(args, task_settings(args))
    save_checkpoint(str(tmp_path / "model"), 3,
                    init_segtran3d(model, 0).state_dict(), cfg)
    results = main(argv)
    assert len(results[3]) == 3 and np.isfinite(results[3]).all()
    assert os.path.isfile(tmp_path / "preds" / "pred.tar")
    pred = np.load(tmp_path / "preds" / "case0.npz")["pred"]
    assert pred.shape == (40, 40, 20) and set(np.unique(pred)) <= {0, 1, 2, 4}


def test_later_slice_flags_raise():
    from segtran_tpu_torch.cli.test3d import (build_model_and_config,
                                              task_settings)
    # --spatialshard is ported (tests/test_torch_parallel_cli3d.py): at
    # world size 1 it changes nothing, as in JAX
    args = _small_args(["--spatialshard"])
    assert build_model_and_config(args, task_settings(args))[1] is not None
    # --flop is ported (tests/test_torch_tools_cli.py runs it)
    args = _small_args(["--flop"])
    assert build_model_and_config(args, task_settings(args))[1] is not None
    # the 3-D zoo nets are ported: they build, with no config
    for net in ("vnet", "unet"):
        args = _small_args(["--net", net])
        model, cfg = build_model_and_config(args, task_settings(args))
        assert cfg is None and type(model).__name__ == {
            "vnet": "VNet", "unet": "Modified3DUNet"}[net]
    # a backbone the model does not take is an error, not a later slice
    for extra in (["--bb", "resnet34"], ["--segtran", "25d", "--bb", "i3d"]):
        args = _small_args(extra)
        with pytest.raises(ValueError, match="--bb"):
            build_model_and_config(args, task_settings(args))


def test_segtran3d_takes_only_the_i3d_backbone():
    """The model itself refuses another backbone with a ValueError naming
    i3d (JAX's Segtran3d builds only I3DFeatures)."""
    import dataclasses
    from segtran_tpu_torch.cli.test3d import (build_model_and_config,
                                              task_settings)
    from segtran_tpu_torch.models.segtran3d import Segtran3d
    args = _small_args([])
    _, cfg = build_model_and_config(args, task_settings(args))
    for bb in ("eff-b4", "resnet50"):
        with pytest.raises(ValueError, match="i3d"):
            Segtran3d(dataclasses.replace(cfg, backbone_type=bb))
