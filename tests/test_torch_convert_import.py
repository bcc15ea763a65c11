"""The reference-checkpoint importer (``segtran_tpu_torch.convert.cli``,
``convert/torch_import.py``) held against the JAX package's on the CPU.

For every model kind of ``convert.cli`` and both raw-backbone imports, a
port model (small where the kind's constructor allows) with seeded random
tensors is written in the reference's format by the JAX-free
``tests/_torch_refsd.py``. Then:

* JAX's converter reads it (for Segtran, the U-Net and the backbones
  JAX's own ``convert_pth`` / ``convert_*_backbone``, its model init
  replaced by the ``jax.eval_shape`` tree; for the zoo its
  ``convert_<kind>``) and ``assign_converted(strict=True)`` grafts it onto
  JAX's tree: that succeeds, so the helper writes what the reference
  writes;
* the port's import equals ``state_dict_from_jax`` of JAX's grafted tree
  and the port's own tensors, tensor for tensor;
* the CLI end to end (``torch.save`` -> ``main`` -> ``load_checkpoint``
  -> ``load_state_dict(strict=True)``), ``--strict`` on a missing key,
  and a backbone-only payload through ``train2d --cp``.

Logits of imported Segtran checkpoints are in
test_torch_convert_logits.py.
"""
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_refsd import (eff_raw_state_dict, reference_state_dict,
                          timm_effv2_state_dict, write_reference_pth)

SEGTRAN2D_ARGS = {"backbone_type": "eff-tiny", "num_classes": 3,
                  "num_attractors": 8, "num_translayers": 2,
                  "translayer_compress_ratios": [1.0, 1.0, 2.0],
                  "in_fpn_layers": "34", "out_fpn_layers": "1234",
                  "qk_have_bias": True, "tie_qk_scheme": "shared",
                  "patch_size": (64, 64)}
SEGTRAN3D_ARGS = {"num_classes": 4, "num_attractors": 8,
                  "orig_in_channels": 4, "num_translayers": 1,
                  "input_patch_size": (48, 48, 16)}
# (kind, reference args, extra writer kwargs)
SEGTRAN_CASES = [
    ("segtran2d", SEGTRAN2D_ARGS, {"legacy_names": True}),
    ("segtran2d", dict(SEGTRAN2D_ARGS, out_fpn_layers="34",
                       num_translayers=1,
                       translayer_compress_ratios=[1.0, 1.0]), {}),
    ("segtran3d", SEGTRAN3D_ARGS, {}),
    ("segtran25d", {"backbone_type": "eff-tiny", "num_classes": 4,
                    "num_attractors": 8, "orig_in_channels": 4,
                    "input_patch_size": (64, 64, 16)}, {}),
    ("unet2d", {"num_classes": 3}, {}),
    ("unet2d", {"num_classes": 3, "polyformer_mode": "source",
                "num_attractors": 8}, {}),
]


def _zoo_pair(kind):
    """(JAX module, port module, NHWC(DC) example shape) of a zoo kind at a
    size the CPU test affords."""
    from importlib import import_module
    jm = lambda m: import_module(f"segtran_tpu.models.{m}")
    tm = lambda m: import_module(f"segtran_tpu_torch.models.{m}")
    if kind == "transunet":
        return (jm("transunet").TransUNet(num_classes=2, num_layers=1),
                tm("transunet").TransUNet(2, img_size=64, num_layers=1),
                (1, 64, 64, 3))
    if kind == "setr":
        kw = dict(embed_dim=96, depth=2, num_heads=4)
        return (jm("setr").SETR_PUP(2, **kw),
                tm("setr").SETR_PUP(2, (64, 64), **kw), (1, 64, 64, 3))
    if kind in ("attunet", "r2attunet"):
        r = kind == "r2attunet"
        return (jm("att_unet").AttUNet(2, recurrent=r),
                tm("att_unet").AttUNet(2, recurrent=r), (1, 32, 32, 3))
    if kind == "dunet":
        return (jm("dunet").DUNetV1V2(n_classes=2),
                tm("dunet").DUNetV1V2(n_classes=2), (1, 32, 32, 3))
    if kind == "nestedunet":
        return (jm("nested_unet").NestedUNet(2),
                tm("nested_unet").NestedUNet(2), (1, 32, 32, 3))
    if kind == "unet3plus":
        return (jm("unet_3plus").UNet3Plus(2), tm("unet_3plus").UNet3Plus(2),
                (1, 32, 32, 3))
    if kind == "vnet":
        kw = dict(n_channels=1, num_classes=2, normalization="batchnorm",
                  has_dropout=True)
        return (jm("vnet").VNet(**kw), tm("vnet").VNet(**kw),
                (1, 16, 16, 16, 1))
    if kind == "unet3d":
        return (jm("unet3d").Modified3DUNet(4, 4),
                tm("unet3d").Modified3DUNet(4, 4), (1, 16, 16, 16, 4))
    if kind == "unet_smp":
        return (jm("unet_smp").UnetSMP(2, "resnet18"),
                tm("unet_smp").UnetSMP(2, encoder="resnet18"),
                (1, 64, 64, 3))
    cls = "DeepLabV3Plus" if kind == "deeplabv3plus" else "DeepLabV3"
    return (getattr(jm("deeplab"), cls)(2, backbone="resnet18"),
            getattr(tm("deeplab"), cls)(2, backbone="resnet18"),
            (1, 64, 64, 3))


ZOO_KINDS = ("transunet", "deeplabv3plus", "deeplabv3", "setr", "attunet",
             "r2attunet", "dunet", "nestedunet", "unet3plus", "vnet",
             "unet3d", "unet_smp")


def _seeded(model, seed):
    """``model`` with every float tensor of its state_dict drawn from a
    seeded normal (exact round trips show any mix-up); its state_dict."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=g))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _zeros(tree):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), tuple(s.shape)), tree)


def _jax_init_tree(module, shape):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros(shape))
    return (_zeros(shapes["params"]),
            _zeros(shapes.get("batch_stats", {})))


def _jax_cli(monkeypatch, fn, *args, **kw):
    """JAX's CLI function with its model init replaced by the eval_shape
    tree (no compiled init) and its checkpoint write captured: the
    (params, batch_stats) it would save."""
    import segtran_tpu.nn.init as jinit
    import segtran_tpu.train.checkpoint as jckpt
    got = {}

    def init(model, rngs, example, **kwargs):
        shapes = jax.eval_shape(lambda: model.init(rngs, example, **kwargs))
        rest = {k: _zeros(v) for k, v in shapes.items()
                if k not in ("params", "site_meta")}
        return _zeros(shapes["params"]), rest

    def save(out_dir, step, params, batch_stats, cfg=None, **kwargs):
        got.update(params=params, batch_stats=batch_stats)
        return os.path.join(out_dir, f"iter_{step}")

    monkeypatch.setattr(jinit, "init_with_reference_schemes", init)
    monkeypatch.setattr(jckpt, "save_checkpoint", save)
    fn(*args, **kw)
    return got["params"], got["batch_stats"]


def _assert_same(got, want, own):
    from segtran_tpu_torch.convert import state_dict_from_jax
    want = state_dict_from_jax(*want, target=own)
    assert set(got) == set(want) == set(own)
    for k in own:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], own[k].float()), k


@pytest.mark.parametrize("case", range(len(SEGTRAN_CASES)))
def test_segtran_and_unet_import_matches_jax(case, tmp_path, monkeypatch):
    from segtran_tpu.convert import cli as jcli
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.convert.torch_import import assign_converted
    kind, args, kw = SEGTRAN_CASES[case]
    model = cli.build_model(kind, cli.config_from_pth_args(args, kind), args)
    own = _seeded(model, case)
    pth = write_reference_pth(str(tmp_path / "ref.pth"), own, kind, args,
                              **kw)
    want = _jax_cli(monkeypatch, jcli.convert_pth, pth,
                    str(tmp_path / "jax"), kind, strict=True)
    ref = torch.load(pth, weights_only=False)["model"]
    params, stats = cli.convert_reference(
        {k: v.numpy() for k, v in ref.items()}, args, kind)
    got, missing, extra = assign_converted(own, params, stats, strict=True)
    assert not missing and not extra
    _assert_same(got, want, own)


@pytest.mark.parametrize("kind", ZOO_KINDS)
def test_zoo_import_matches_jax(kind):
    from segtran_tpu.convert import torch_import as jti
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.convert.torch_import import assign_converted
    jm, tm, shape = _zoo_pair(kind)
    own = _seeded(tm, ZOO_KINDS.index(kind))
    ref = {k: v.numpy() for k, v in
           reference_state_dict(own, kind).items()}
    jparams, jstats = _jax_init_tree(jm, shape)
    conv = {"r2attunet": "attunet", "deeplabv3plus": "deeplab",
            "deeplabv3": "deeplab"}.get(kind, kind)
    p, s = getattr(jti, f"convert_{conv}")(ref)
    want = (jti.assign_converted(jparams, p, strict=True),
            jti.assign_converted(jstats, s, strict=True))
    params, stats = cli.convert_reference(ref, {}, kind)
    got, missing, extra = assign_converted(own, params, stats, strict=True)
    assert not missing and not extra
    _assert_same(got, want, own)


@pytest.mark.parametrize("which", ["timm effv2s", "eff-b0"])
def test_backbone_payload_matches_jax(which, tmp_path, monkeypatch):
    from segtran_tpu.convert import cli as jcli
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    if which.startswith("timm"):
        from segtran_tpu_torch.nn.backbones.efficientnetv2 import (
            EfficientNetV2Features)
        bb = EfficientNetV2Features("effv2s", stem_stride=1)
        raw, flag, jfn = timm_effv2_state_dict, ["--timm-bb", "effv2s"], \
            jcli.convert_timm_backbone
    else:
        from segtran_tpu_torch.nn.backbones.efficientnet import (
            EfficientNetFeatures)
        bb = EfficientNetFeatures("eff-b0", stem_stride=1)
        raw, flag, jfn = eff_raw_state_dict, ["--eff-bb", "eff-b0"], \
            jcli.convert_eff_backbone
    own = _seeded(bb, 7)
    pth = str(tmp_path / "bb.pth")
    torch.save(raw(own), pth)
    want = _jax_cli(monkeypatch, jfn, pth, str(tmp_path / "jax"),
                    flag[1])
    path = cli.main(["--pth", pth, "--out", str(tmp_path / "port")] + flag)
    got = load_checkpoint(path)
    assert all(k.startswith("backbone.") for k in got)
    _assert_same(got, want, {f"backbone.{k}": v for k, v in own.items()})


def _segtran3d_pth(tmp_path, drop=None):
    from segtran_tpu_torch.convert import cli
    model = cli.build_model("segtran3d", cli.config_from_pth_args(
        SEGTRAN3D_ARGS, "segtran3d"), SEGTRAN3D_ARGS)
    own = _seeded(model, 11)
    ref = reference_state_dict(own, "segtran3d")
    if drop:
        del ref[drop]
    pth = str(tmp_path / "iter_100.pth")
    torch.save({"iter_num": 100, "model": ref, "args": SEGTRAN3D_ARGS}, pth)
    return pth, own


def test_cli_end_to_end_and_strict(tmp_path):
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    pth, own = _segtran3d_pth(tmp_path)
    path = cli.main(["--pth", pth, "--out", str(tmp_path / "out"),
                     "--model", "segtran3d", "--strict"])
    assert path.endswith("iter_100")
    cfg = cli.config_from_pth_args(SEGTRAN3D_ARGS, "segtran3d")
    model = cli.build_model("segtran3d", cfg, SEGTRAN3D_ARGS)
    model.load_state_dict(load_checkpoint(path, cfg), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, own[k]), k
    # a key the checkpoint lacks: --strict raises, without it the model's
    # fresh value stays
    gone = "voxel_fusion.translayers.0.in_ator_trans.query.bias"
    pth, _ = _segtran3d_pth(tmp_path, drop=gone)
    with pytest.raises(KeyError, match="missing"):
        cli.main(["--pth", pth, "--out", str(tmp_path / "s"), "--model",
                  "segtran3d", "--strict"])
    path = cli.main(["--pth", pth, "--out", str(tmp_path / "ns"),
                     "--model", "segtran3d"])
    assert gone in load_checkpoint(path)


def test_backbone_payload_starts_train2d(tmp_path, monkeypatch):
    """``--eff-bb`` writes ``backbone.``-prefixed keys; train2d --cp loads
    them into a fresh Segtran2d's backbone (the rest keeps its init)."""
    from _torch_data2d import write_tree
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures)
    own = _seeded(EfficientNetFeatures("eff-b0", stem_stride=1), 5)
    pth = str(tmp_path / "adv-efficientnet-b0.pth")
    torch.save(eff_raw_state_dict(own), pth)
    path = cli.main(["--pth", pth, "--out", str(tmp_path / "bb"),
                     "--eff-bb", "eff-b0"])
    write_tree(str(tmp_path / "data" / "fundus" / "train"))
    got = {}
    monkeypatch.setattr(train2d, "train",
                        lambda model, *a, **k: got.update(model=model))
    train2d.main(["--task", "fundus", "--split", "all", "--bb", "eff-b0",
                  "--translayers", "1", "--attractors", "8", "--maxiter",
                  "1", "--bs", "2", "--origsize", "64", "--patchsize", "64",
                  "--dataroot", str(tmp_path / "data"), "--ckptdir",
                  str(tmp_path / "model"), "--cp", path + ".pt",
                  "--device", "cpu"])
    sd = got["model"].backbone.state_dict()
    assert set(sd) == set(own)
    for k in own:
        assert torch.equal(sd[k], own[k]), k
