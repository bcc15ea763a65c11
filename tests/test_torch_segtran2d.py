"""The port's Segtran2d and serving engine held against the JAX package on
the CPU, with the same converted weights (eff-tiny, 64^2, fp32)."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

# fp32 end to end; the sums of a 60-conv backbone and two translayers
# reorder between XLA and PyTorch, so logits agree to ~1e-5 relative
RTOL, ATOL = 1e-4, 1e-4


def _configs(fused_epilogue):
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    kw = dict(backbone_type="eff-tiny", num_classes=3, num_attractors=8,
              use_fused_epilogue=fused_epilogue)
    ratios = (1.0, 1.0, 2.0)
    return (JCfg(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 **kw).derive(translayer_compress_ratios=ratios),
            TCfg(**kw).derive(translayer_compress_ratios=ratios))


def test_segtran2d_logits_match_jax():
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d as TModel

    jcfg, tcfg = _configs(True)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=3)
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats), jnp.asarray(x)))

    tm = TModel(tcfg)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_fused_attention_logits_match_jax():
    """--fused: the flash branch (the plain version on the CPU) against the
    JAX model's Pallas branch in interpret mode, same weights."""
    import dataclasses
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d as TModel

    jcfg, tcfg = _configs(True)
    jcfg = dataclasses.replace(jcfg, use_fused_attention=True)
    tcfg = dataclasses.replace(tcfg, use_fused_attention=True)
    x = np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32)
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=7)
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats), jnp.asarray(x)))
    tm = TModel(tcfg)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_inference_engine_matches_jax_sliding_window(tmp_path):
    """Port checkpoint (made by convert.py) -> InferenceEngine on the CPU,
    against the JAX model under the JAX sliding_window_2d, on one 96^2
    frame served as one window resized to a 32^2 patch (the fundus
    576^2 -> 288^2 recipe at a small size)."""
    from segtran_tpu.infer.sliding import sliding_window_2d
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.cli.serve import (InferenceEngine,
                                             build_argparser,
                                             build_model_and_config,
                                             task_settings)
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    import dataclasses

    args = build_argparser().parse_args([
        "--task", "fundus", "--bb", "eff-tiny", "--translayers", "1",
        "--attractors", "8", "--origsize", "96", "--patchsize", "32",
        "--cpdir", str(tmp_path), "--iter", "3", "--maxbatch", "2",
        "--batchwait", "1", "--fusedepi", "--device", "cpu"])
    task = task_settings(args)
    _, tcfg = build_model_and_config(args, task)
    jcfg_kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(TCfg)
               if f.name != "dtype"}
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    jm = JModel(JCfg(**jcfg_kw))
    params, bstats = jax_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=5)
    save_checkpoint(str(tmp_path), 3, state_dict_from_jax(params, bstats),
                    cfg=tcfg)

    engine = InferenceEngine(args, logging.getLogger("test-torch-serve"))
    try:
        img = np.random.RandomState(1).rand(96, 96, 3).astype(np.float32)
        pending = engine.submit(img)
        pending.event.wait(120)
        assert pending.error is None
        got = pending.probs
    finally:
        engine.close()

    from segtran_tpu.data.stats import load_dataset_stats
    mean, std = load_dataset_stats("fundus", 0.5, "train")
    variables = jvars(params, bstats)

    def model_fn(im):
        gray = jnp.tensordot(im, jnp.asarray([0.299, 0.587, 0.114]),
                             axes=[[-1], [0]])[..., None]
        xx = (0.5 * im + 0.5 * gray - jnp.asarray(mean)) / jnp.asarray(std)
        return jm.apply(variables, xx)

    batch = np.zeros((2, 96, 96, 3), np.float32)   # padded like the engine
    batch[0] = img
    ref = np.asarray(jax.jit(lambda b: sliding_window_2d(
        model_fn, b, (96, 96), (32, 32), num_classes=3))(
            jnp.asarray(batch)))[0]
    assert got.shape == (96, 96, 3) and np.isfinite(got).all()
    # probabilities after sigmoid: the logits' 1e-4 shrinks by <= 1/4
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-5)


def test_later_slice_flags_raise():
    from segtran_tpu_torch.cli.serve import (build_argparser,
                                             build_model_and_config,
                                             task_settings)
    from segtran_tpu_torch.nn.mince import CrossMinceAttFeatTrans
    # the zoo is served since item 6a; a 3-D net is no 2-D --net
    args = build_argparser().parse_args(["--cpdir", "x", "--iter", "1",
                                         "--net", "vnet"])
    with pytest.raises(ValueError, match="unknown --net vnet"):
        build_model_and_config(args, task_settings(args))
    args = build_argparser().parse_args(["--cpdir", "x", "--iter", "1",
                                         "--net", "unet", "--bb", "resnet18"])
    model, cfg = build_model_and_config(args, task_settings(args))
    assert cfg is None and type(model).__name__ == "UnetSMP"
    # item 5's --mince and --net unet-scratch --polyformer are served
    args = build_argparser().parse_args(
        ["--cpdir", "x", "--iter", "1", "--mince", "--nosqueeze",
         "--mincescales", "2,1", "--minceprops", "1,1", "--bb", "eff-tiny",
         "--translayers", "1"])
    model, _ = build_model_and_config(args, task_settings(args))
    assert isinstance(model.voxel_fusion.translayers[0],
                      CrossMinceAttFeatTrans)
    args = build_argparser().parse_args(
        ["--cpdir", "x", "--iter", "1", "--net", "unet-scratch",
         "--polyformer", "source", "--attractors", "8"])
    model, cfg = build_model_and_config(args, task_settings(args))
    assert cfg is None and model.polyformer_mode == "source"
    # --pos bias is served, but only without the squeezed layers (JAX's
    # ValueError)
    args = build_argparser().parse_args(
        ["--cpdir", "x", "--iter", "1", "--pos", "bias", "--bb", "eff-tiny"])
    with pytest.raises(ValueError, match="cannot use positional biases"):
        build_model_and_config(args, task_settings(args))
    args = build_argparser().parse_args(
        ["--cpdir", "x", "--iter", "1", "--pos", "bias", "--nosqueeze",
         "--bb", "eff-tiny", "--translayers", "1", "--task", "oct"])
    _, cfg = build_model_and_config(args, task_settings(args))
    assert not cfg.use_squeezed_transformer and cfg.num_classes == 10


def test_http_server_on_cpu(tmp_path):
    """The port's HTTP surface: /healthz, /statz, a PNG mask at the input's
    own size, and raw probabilities."""
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image
    from segtran_tpu_torch.cli.serve import (build_argparser,
                                             build_model_and_config,
                                             make_server, task_settings)
    from segtran_tpu_torch.models.segtran2d import init_segtran2d
    from segtran_tpu_torch.train.checkpoint import save_checkpoint

    args = build_argparser().parse_args([
        "--bb", "eff-tiny", "--translayers", "1", "--attractors", "8",
        "--origsize", "64", "--patchsize", "64", "--cpdir", str(tmp_path),
        "--iter", "2", "--port", "0", "--maxbatch", "2", "--fusedepi",
        "--device", "cpu"])
    model, cfg = build_model_and_config(args, task_settings(args))
    save_checkpoint(str(tmp_path), 2, init_segtran2d(model, 1).state_dict(),
                    cfg)
    httpd, engine = make_server(args, logging.getLogger("test-torch-http"))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["input_size"] == [64, 64]
        buf = io.BytesIO()
        Image.fromarray(np.random.RandomState(2).randint(
            0, 255, (90, 130, 3), dtype=np.uint8)).save(buf, format="PNG")
        for path, ctype in (("/segment", "image/png"),
                            ("/segment?probs=1", "application/octet-stream")):
            req = urllib.request.Request(url + path, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.headers.get("Content-Type") == ctype
                body = r.read()
            if ctype == "image/png":
                mask = Image.open(io.BytesIO(body))
                assert mask.size == (130, 90)
                assert set(np.asarray(mask).ravel().tolist()) <= {0, 128, 255}
            else:
                probs = np.load(io.BytesIO(body))
                assert probs.shape == (64, 64, 3) and np.isfinite(probs).all()
        with urllib.request.urlopen(url + "/statz", timeout=60) as r:
            assert json.loads(r.read())["requests"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
