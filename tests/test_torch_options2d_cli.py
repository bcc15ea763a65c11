"""The port's 2-D options through the CLIs' paths, held against the JAX
package on the CPU: test2d's evaluate_checkpoint on --task oct, the
position codes on a non-square token grid, the checkpoint sidecar's
option fields, and the 3-D CLIs' refusals of the options Segtran3d is not
yet held to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_options import ATOL, RTOL, _configs, _eval_pair, _pair
from _torch_parity import jax_variables
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("code", ["rand", "sinu", "bias"])
def test_non_square_grid_codes_match_jax(code):
    """A 64x128 input (an 8x16 token grid, as oct's 288x512): the codes
    sized from the grid take its real shape, never sqrt(N)."""
    kw = dict(pos_code_type=code)
    if code == "bias":
        kw.update(use_squeezed_transformer=False, pos_bias_radius=2)
    jm, params, bstats, tm = _pair(seed=8, size=(64, 128), **kw)
    x = np.random.RandomState(3).randn(2, 64, 128, 3).astype(np.float32)
    out, ref = _eval_pair(jm, params, bstats, tm, x)
    assert out.shape == ref.shape == (2, 64, 128, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_checkpoint_sidecar_carries_the_new_fields(tmp_path):
    """The sidecar's config holds the option fields, as JAX's does."""
    import json
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    _, tcfg = _configs(use_squeezed_transformer=False, pos_code_type="bias",
                       pos_bias_radius=3, in_fpn_use_bn=True,
                       ablate_multihead=True)
    save_checkpoint(str(tmp_path), 1, {}, tcfg)
    with open(tmp_path / "iter_1.config.json") as f:
        saved = json.load(f)["config"]
    assert saved["pos_bias_radius"] == 3 and saved["in_fpn_use_bn"]
    assert saved["ablate_multihead"] and saved["num_modalities"] == 0
    assert not saved["use_global_bias"] and not saved["out_fpn_use_bn"]


def test_oct_evaluate_checkpoint_matches_jax():
    """test2d's evaluate_checkpoint on --task oct (64x128 frames, 10-class
    index masks mapped by index_to_onehot) with --nosqueeze --pos bias,
    against JAX's on the same converted weights: per-class Dice of the 9
    foreground classes within 1e-3."""
    import logging
    from segtran_tpu.cli import test2d as jt
    from segtran_tpu.configs.presets import TASK_SETTINGS
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.convert import state_dict_from_jax
    argv = ["--task", "oct", "--bb", "eff-tiny", "--translayers", "1",
            "--attractors", "8", "--origsize", "64,128", "--patchsize",
            "64,128", "--bs", "2", "--nosqueeze", "--pos", "bias", "--posr",
            "2", "--cpdir", "unused"]
    jargs = jt.build_argparser().parse_args(argv)
    task = dict(TASK_SETTINGS["oct"], orig_input_size=(64, 128),
                patch_size=(64, 128))
    jm, _ = jt.build_model(jargs, task)
    params, bstats = jax_variables(jm, jnp.zeros((1, 64, 128, 3)), seed=2)
    rng = np.random.RandomState(6)

    class Frames(list):
        image_list = [f"oct{i}.png" for i in range(3)]
    frames = Frames()
    for i in range(3):
        rows = (np.arange(64)[:, None] * 10 // 64 + i) % 10
        frames.append({
            "image": rng.rand(64, 128, 3).astype(np.float32),
            "mask": np.broadcast_to(rows, (64, 128))[..., None].astype(
                np.uint8),
            "index": i, "crop_pos": np.array([0, 0]),
            "unscaled_size": np.array([64, 128]),
            "uncropped_size": np.array([-1, -1])})
    log = logging.getLogger("oct-parity")
    mean, std = (0.2, 0.2, 0.2), (0.15, 0.15, 0.15)
    want = jt.evaluate_checkpoint(
        jm, {"params": params, "batch_stats": bstats}, frames, task, jargs,
        log, mean, std)
    args = test2d.build_argparser().parse_args(argv + ["--device", "cpu"])
    model, cfg = test2d.build_model(args, train2d.task_settings(args))
    assert cfg.num_classes == 10 and not cfg.use_squeezed_transformer
    model.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    got = test2d.evaluate_checkpoint(model.eval(), frames,
                                     train2d.task_settings(args), args, log,
                                     mean, std, torch.device("cpu"))
    assert got.shape == want.shape == (9,)
    assert (want > 0.05).all()          # the model predicts every class
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("cli", ["train3d", "test3d"])
@pytest.mark.parametrize("flags", [["--pos", "rand"], ["--pos", "bias"],
                                   ["--nosqueeze"]])
def test_3d_clis_refuse_the_2d_options(cli, flags):
    """The 3-D CLIs take --pos and --nosqueeze since Segtran3d is held to
    JAX under them (tests/test_torch_segtran3d_attention_options.py):
    the flags reach the config, and --pos bias with the squeezed encoder
    meets JAX's ValueError. What they still refuse (multi-GPU) names its
    ROADMAP item."""
    import importlib
    mod = importlib.import_module(f"segtran_tpu_torch.cli.{cli}")
    common = (["--attractors", "8", "--device", "cpu"]
              + (["--cpdir", "unused"] if cli == "test3d" else []))
    args = mod.build_argparser().parse_args(common + flags)
    mod._refuse_later_slices(args)
    task = mod.task_settings(args)
    if flags == ["--pos", "bias"]:
        with pytest.raises(ValueError, match="positional biases"):
            mod.build_model_and_config(args, task)
    else:
        _, cfg = mod.build_model_and_config(args, task)
        assert (cfg.pos_code_type, cfg.use_squeezed_transformer) == (
            args.pos_code_type, args.use_squeezed_transformer)
    # --net vnet is ported; multi-GPU is still a later slice
    later = ["--spatialshard"] if cli == "test3d" else ["--tp", "2"]
    args = mod.build_argparser().parse_args(common + later)
    with pytest.raises(NotImplementedError, match="item 6"):
        mod._refuse_later_slices(args)