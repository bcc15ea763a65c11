"""Import a reference ``.pth`` checkpoint into the port's checkpoint format.

The reference saves ``{'iter_num', 'model': state_dict, 'args':
vars(args)}`` (reference train2d.py:640-648). This CLI reads the ``.pth``
on the CPU (``torch.load(map_location='cpu')``: host array work, no
forward, no device), derives the model config from the embedded args as
JAX's ``convert/cli.py`` does, converts the state_dict by the reference
-> JAX rules (``convert/torch_import.py``) and then into the port's
state_dict (``state_dict_from_jax`` with the model's names as target),
checks every shape against a freshly built model (``--strict``: and every
key, missing or left over), and writes ``iter_N.pt`` + its sidecar
(``train/checkpoint.save_checkpoint``), which ``cli/test2d.py``,
``cli/test3d.py``, ``cli/serve.py`` and ``train2d/train3d --cp`` load.

Kinds: ``segtran2d``, ``segtran3d``, ``segtran25d``, ``unet2d`` and the
zoo (``transunet``, ``deeplabv3plus``, ``deeplabv3``, ``setr``,
``attunet``, ``r2attunet``, ``dunet``, ``nestedunet``, ``unet3plus``,
``vnet`` (batchnorm, with dropout: the reference's train3d wiring),
``unet3d``, ``unet_smp``). ``--timm-bb effv2{s,m,l}`` and ``--eff-bb
eff-b{0..7}`` read a raw backbone checkpoint and write a backbone-only
payload (``backbone.``-prefixed keys) that ``train2d --cp`` starts from.

Usage:
  python -m segtran_tpu_torch.convert.cli --pth iter_5000.pth \\
      --out ./converted [--model segtran2d|segtran3d|segtran25d|unet2d|...]
  python -m segtran_tpu_torch.convert.cli --pth tf_efficientnetv2_m.pth \\
      --out ./bb --timm-bb effv2m
  python -m segtran_tpu_torch.convert.cli --pth adv-efficientnet-b4.pth \\
      --out ./bb --eff-bb eff-b4 --stemstride 1
"""
from __future__ import annotations

import argparse
import time

import torch

from . import torch_import as ti

# zoo nets with dedicated key adapters (reference train2d / train3d save
# their plain state_dicts like any other net's)
ZOO_KINDS = ("transunet", "deeplabv3plus", "deeplabv3", "setr", "attunet",
             "r2attunet", "dunet", "nestedunet", "unet3plus", "vnet",
             "unet3d", "unet_smp")
KINDS = ("segtran2d", "segtran3d", "segtran25d", "unet2d") \
    + tuple(sorted(ZOO_KINDS))


def config_from_pth_args(pth_args: dict, model_kind: str):
    """The Segtran config of the reference run's args (JAX
    ``config_from_pth_args``); None for the other kinds."""
    from ..configs.base import (Segtran2dConfig, Segtran3dConfig,
                                Segtran25dConfig)
    get = pth_args.get
    common = dict(
        num_classes=get("num_classes", 2),
        num_attractors=get("num_attractors", 256),
        num_modes=get("num_modes", 4) if get("num_modes", 4) not in (-1, None)
        else 4,
        qk_have_bias=get("qk_have_bias", True),
        use_squeezed_transformer=get("use_squeezed_transformer", True),
        pos_code_type=get("pos_code_type", "lsinu"),
        ablate_multihead=get("ablate_multihead", False),
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    compress = tuple(float(x) for x in get(
        "translayer_compress_ratios",
        [1.0] * (get("num_translayers", 1) + 1)))
    in_layers = tuple(int(c) for c in str(get("in_fpn_layers", "34")))
    out_layers = tuple(int(c) for c in str(get("out_fpn_layers", "1234")))
    if model_kind == "segtran2d":
        cfg = Segtran2dConfig(
            backbone_type=get("backbone_type", "eff-b4"),
            in_fpn_layers=in_layers, out_fpn_layers=out_layers, **common)
    elif model_kind == "segtran3d":
        cfg = Segtran3dConfig(
            orig_in_channels=get("orig_in_channels", 4),
            inchan_to3_scheme=get("inchan_to3_scheme", "bridgeconv"),
            D_pool_K=get("D_pool_K", 2),
            out_fpn_upsampleD_scheme=get("out_fpn_upsampleD_scheme",
                                         "interp"),
            in_fpn_layers=in_layers, out_fpn_layers=out_layers, **common)
    elif model_kind == "segtran25d":
        cfg = Segtran25dConfig(
            backbone_type=get("backbone_type", "eff-b3"),
            orig_in_channels=get("orig_in_channels", 4),
            inchan_to3_scheme=get("inchan_to3_scheme", "stemconv"),
            D_pool_K=get("D_pool_K", 2),
            out_fpn_upsampleD_scheme=get("out_fpn_upsampleD_scheme", "conv"),
            in_fpn_layers=in_layers, out_fpn_layers=out_layers, **common)
    else:
        return None
    return cfg.derive(translayer_compress_ratios=compress)


def _patch(pth_args, key, default):
    ps = pth_args.get(key, default)
    return (ps, ps) if isinstance(ps, int) else tuple(ps)


def build_model(model_kind: str, cfg, pth_args: dict):
    """A fresh port model of ``model_kind`` (fp32 parameters) for the
    reference run's args, as JAX's converter builds its model."""
    get = pth_args.get
    nc = get("num_classes", 2)
    if model_kind == "segtran2d":
        from ..models.segtran2d import Segtran2d
        return Segtran2d(cfg, patch_size=_patch(pth_args, "patch_size",
                                                (288, 288)))
    if model_kind in ("segtran3d", "segtran25d"):
        from ..models.segtran3d import Segtran3d
        from ..models.segtran25d import Segtran25d
        cls = Segtran3d if model_kind == "segtran3d" else Segtran25d
        return cls(cfg, patch_size=_patch(pth_args, "input_patch_size",
                                          (112, 112, 96)))
    if model_kind == "unet2d":
        from ..models.unet2d import VanillaUNet
        return VanillaUNet(3, get("num_classes", 3),
                           polyformer_mode=get("polyformer_mode"),
                           num_attractors=get("num_attractors", 256))
    ps = _patch(pth_args, "patch_size", (224, 224))
    if model_kind == "transunet":
        from ..models.transunet import TransUNet
        return TransUNet(nc, img_size=ps[0])
    if model_kind == "setr":
        from ..models.setr import SETR_PUP
        return SETR_PUP(nc, img_size=ps)
    if model_kind in ("attunet", "r2attunet"):
        from ..models.att_unet import AttUNet
        return AttUNet(nc, recurrent=model_kind == "r2attunet")
    if model_kind == "dunet":
        from ..models.dunet import DUNetV1V2
        return DUNetV1V2(n_classes=nc)
    if model_kind == "nestedunet":
        from ..models.nested_unet import NestedUNet
        return NestedUNet(nc)
    if model_kind == "unet3plus":
        from ..models.unet_3plus import UNet3Plus
        return UNet3Plus(nc)
    if model_kind == "vnet":
        from ..models.vnet import VNet
        return VNet(n_channels=get("orig_in_channels", 1), num_classes=nc,
                    normalization="batchnorm", has_dropout=True)
    if model_kind == "unet3d":
        from ..models.unet3d import Modified3DUNet
        return Modified3DUNet(in_channels=get("orig_in_channels", 4),
                              num_classes=nc)
    if model_kind == "unet_smp":
        from ..models.unet_smp import UnetSMP
        return UnetSMP(nc, encoder=get("backbone_type", "resnet34"))
    if model_kind in ("deeplabv3plus", "deeplabv3"):
        from ..models.deeplab import DeepLabV3, DeepLabV3Plus
        cls = DeepLabV3Plus if model_kind == "deeplabv3plus" else DeepLabV3
        return cls(nc, backbone=get("backbone_type", "resnet50"))
    raise ValueError(f"unknown model kind {model_kind!r}; one of {KINDS}")


_ZOO_CONVERTERS = {
    "transunet": ti.convert_transunet, "setr": ti.convert_setr,
    "attunet": ti.convert_attunet, "r2attunet": ti.convert_attunet,
    "dunet": ti.convert_dunet, "nestedunet": ti.convert_nestedunet,
    "unet3plus": ti.convert_unet3plus, "vnet": ti.convert_vnet,
    "unet3d": ti.convert_unet3d, "unet_smp": ti.convert_unet_smp,
    "deeplabv3plus": ti.convert_deeplab, "deeplabv3": ti.convert_deeplab}


def convert_reference(sd_np: dict, pth_args: dict, model_kind: str):
    """A reference state_dict (name -> numpy array) -> JAX-shaped (params,
    batch_stats), by JAX ``convert_pth``'s steps: a zoo kind through its
    adapter; Segtran and the U-Net with the DA heads dropped
    (``discriminator.``, ``recon.``), the legacy ``out_bridgeconv`` name,
    timm's EfficientNetV2 names under ``backbone.``, ``tie_qk_scheme``
    and the transposed no-out-FPN head."""
    if model_kind in ZOO_KINDS:
        return _ZOO_CONVERTERS[model_kind](sd_np)
    sd_np = {k.replace("out_bridgeconv", "out_fpn_bridgeconv"): v
             for k, v in sd_np.items()
             if not k.startswith(("discriminator.", "recon."))}
    if str(pth_args.get("backbone_type", "")).startswith("effv2"):
        renamed = {}
        for k, v in sd_np.items():
            if k.startswith("backbone."):
                nk = ti.rename_timm_effv2_key(k[len("backbone."):])
                if nk is None:
                    continue
                k = "backbone." + nk
            renamed[k] = v
        sd_np = renamed
    tie_shared = pth_args.get("tie_qk_scheme", "shared") == "shared"
    transposed = frozenset(
        k[:-len(".weight")] for k, v in sd_np.items()
        if k.endswith("out_conv.weight") and v.ndim in (4, 5)
        and any(s > 1 for s in v.shape[2:]))
    return ti.convert_state_dict(sd_np, tie_qk_shared=tie_shared,
                                 transposed_conv_paths=transposed)


def _numpy_state_dict(sd, drop=()):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "numpy") and not k.startswith(tuple(drop))}


def _load(model, params, batch_stats, strict: bool, what: str):
    sd, missing, extra = ti.assign_converted(model.state_dict(), params,
                                             batch_stats, strict=strict)
    model.load_state_dict(sd, strict=True)
    if missing:
        print(f"{what}: kept the fresh values of {len(missing)} tensor(s) "
              f"the checkpoint lacks: {missing[:8]}")
    if extra:
        print(f"{what}: dropped {len(extra)} checkpoint tensor(s) the model "
              f"lacks: {extra[:8]}")
    return model


def convert_pth(pth_path: str, out_dir: str, model_kind: str = "segtran2d",
                strict: bool = False):
    """``.pth`` -> ``<out_dir>/iter_N.pt`` + sidecar; returns (the path
    without extension, the config or None)."""
    from ..train.checkpoint import save_checkpoint
    t0 = time.perf_counter()
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    pth_args = ckpt.get("args", {}) or {}
    iter_num = ckpt.get("iter_num", 0)
    cfg = config_from_pth_args(pth_args, model_kind)
    params, batch_stats = convert_reference(_numpy_state_dict(sd),
                                            pth_args, model_kind)
    model = _load(build_model(model_kind, cfg, pth_args), params,
                  batch_stats, strict, model_kind)
    path = save_checkpoint(out_dir, iter_num, model.state_dict(), cfg)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {model_kind} {pth_path} -> {path} ({n / 1e6:.1f}M "
          f"params, iter {iter_num}) in {time.perf_counter() - t0:.2f} s")
    return path, cfg


def _backbone_payload(out_dir, backbone, params, batch_stats, what):
    from ..train.checkpoint import save_checkpoint
    _load(backbone, params, batch_stats, True, what)
    path = save_checkpoint(out_dir, 0, {f"backbone.{k}": v for k, v in
                                        backbone.state_dict().items()})
    n = sum(p.numel() for p in backbone.parameters())
    print(f"converted {what} -> {path} ({n / 1e6:.1f}M params)")
    return path


def _raw_state_dict(pth_path, drop=()):
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    return _numpy_state_dict(sd, drop)


def convert_timm_backbone(pth_path: str, out_dir: str, variant: str):
    """A raw timm EfficientNetV2 checkpoint (the reference's pretrained
    backbone, segtran2d.py:106-117) -> a backbone-only payload for
    ``train2d --cp`` with ``--bb effv2{s,m,l}`` (stem stride 1, strict)."""
    from ..nn.backbones.efficientnetv2 import EfficientNetV2Features
    params, batch_stats = ti.convert_timm_effv2(_raw_state_dict(pth_path))
    return _backbone_payload(out_dir,
                             EfficientNetV2Features(variant, stem_stride=1),
                             params, batch_stats, f"timm {variant}")


def convert_eff_backbone(pth_path: str, out_dir: str, variant: str,
                         stem_stride: int = 1):
    """A raw EfficientNet checkpoint (the reference's advprop weights,
    efficientnet/model.py from_pretrained; the classifier ``_fc`` is
    dropped) -> a backbone-only payload for ``train2d --cp`` (strict)."""
    from ..nn.backbones.efficientnet import EfficientNetFeatures
    params, batch_stats = ti.convert_state_dict(
        _raw_state_dict(pth_path, drop=("_fc.",)), tie_qk_shared=False)
    return _backbone_payload(
        out_dir, EfficientNetFeatures(variant, stem_stride=stem_stride),
        params, batch_stats, f"{variant} backbone")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pth", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="segtran2d", choices=KINDS)
    p.add_argument("--timm-bb", dest="timm_bb", default=None,
                   choices=["effv2s", "effv2m", "effv2l"],
                   help="treat --pth as a raw timm EfficientNetV2 checkpoint "
                        "and emit a backbone-only payload for train2d --cp")
    p.add_argument("--eff-bb", dest="eff_bb", default=None,
                   choices=[f"eff-b{i}" for i in range(8)],
                   help="treat --pth as a raw EfficientNet (advprop) "
                        "checkpoint and emit a backbone-only payload")
    p.add_argument("--stemstride", dest="stem_stride", type=int, default=1,
                   help="backbone stem stride for --eff-bb (1 = the "
                        "bb_feat_upsize default)")
    p.add_argument("--strict", action="store_true",
                   help="every model key must come from the checkpoint "
                        "and every checkpoint key must reach the model")
    args = p.parse_args(argv)
    if args.timm_bb:
        return convert_timm_backbone(args.pth, args.out, args.timm_bb)
    if args.eff_bb:
        return convert_eff_backbone(args.pth, args.out, args.eff_bb,
                                    args.stem_stride)
    return convert_pth(args.pth, args.out, args.model, args.strict)[0]


if __name__ == "__main__":
    main()
