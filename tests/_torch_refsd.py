"""Reference-format checkpoints written from the port's own weights.

The reference framework (PyTorch) saves ``{'iter_num', 'model':
state_dict, 'args': vars(args)}``. Its state_dicts hold the same torch
layouts as the port's, under the reference's module names; what differs
is undone here, kind by kind (the inverse of the importer's renames):

* Segtran: the tied Q/K stored twice (``key.*`` a copy of ``query.*``),
  the per-mode ``group_linear`` as a grouped Conv1d ``[M*F, F, 1]`` with
  a ``[M*F]`` bias, BatchNorm's ``num_batches_tracked``; a DA run's heads
  (``discriminator.*``, ``recon.*``) the importer drops;
* the zoo: TransUNet's ``transformer.embeddings`` / ``transformer.encoder
  .layer.N`` / ``decoder.`` names, DeepLab's ``convs.I.J``, SETR's
  ``patch_embed.proj`` and its auxiliary heads and ``conv_seg``, the
  R2 U-Net's ``RRCNN`` blocks, DUNet's ``mpconv.1`` and ``conv.conv``
  wrappers, UNet 3+'s encoder ``Sequential`` s, SMP's ``decoder.blocks``
  and ``segmentation_head.0``, the classifier remnants each importer
  drops;
* raw backbones: timm's EfficientNetV2 names (``blocks.S.J``,
  ``se.conv_reduce``, ``bn1``, and its head), the EfficientNet
  classifier ``_fc``.

Imports neither JAX nor Pillow: ``chip_smoke.py`` uses it on the card.
"""
import re

import torch

SEGTRAN_KINDS = ("segtran2d", "segtran3d", "segtran25d", "unet2d")


def _group_linear(k, v):
    """``[M, F, F]`` -> the grouped Conv1d ``[M*F, F, 1]``:
    w[m*F + g, f, 0] = kernel[m, f, g]."""
    if k.endswith("group_linear.weight") and v.dim() == 3:
        m, f, _ = v.shape
        return v.transpose(1, 2).reshape(m * f, f, 1)
    if k.endswith("group_linear.bias") and v.dim() == 2:
        return v.reshape(-1)
    return v


def _bn_counters(sd):
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(1000, dtype=torch.long)
    return sd


def _transunet_key(k):
    if k.startswith(("hybrid_model.", "patch_embeddings.",
                     "position_embeddings")):
        k = k.replace("hybrid_model.root_conv.", "hybrid_model.root.conv.")
        k = k.replace("hybrid_model.root_gn.", "hybrid_model.root.gn.")
        k = re.sub(r"hybrid_model\.body_(block\d+)_(unit\d+)\.",
                   r"hybrid_model.body.\1.\2.", k)
        return "transformer.embeddings." + k
    if k.startswith("encoder."):
        k = re.sub(r"^encoder\.block\.(\d+)\.", r"encoder.layer.\1.", k)
        return "transformer." + k
    if k.startswith("segmentation_head."):
        return k
    return "decoder." + k


def _zoo_key(kind, k):
    if kind == "transunet":
        return _transunet_key(k)
    if kind in ("deeplabv3plus", "deeplabv3"):
        k = re.sub(r"\.aspp\.convs(\d)\.(\d)\.", r".aspp.convs.\1.\2.", k)
        return re.sub(r"classifier\.classifier\.0\.convs(\d)\.(\d)\.",
                      r"classifier.classifier.0.convs.\1.\2.", k)
    if kind == "setr":
        return k.replace("backbone.patch_embed.",
                         "backbone.patch_embed.proj.")
    if kind == "r2attunet":
        k = re.sub(r"^Up_conv(\d)\.", r"Up_RRCNN\1.", k)
        return re.sub(r"^Conv(\d)\.", r"RRCNN\1.", k)
    if kind == "dunet":
        k = re.sub(r"^(down\d)\.conv\.", r"\1.mpconv.1.conv.", k)
        return re.sub(r"^(inc|up\d)\.conv\.", r"\1.conv.conv.", k)
    if kind == "unet3plus":
        k = re.sub(r"^(conv\d)\.conv(\d)\.", r"\1.conv\2.0.", k)
        return re.sub(r"^(conv\d)\.bn(\d)\.", r"\1.conv\2.1.", k)
    if kind == "unet_smp":
        k = re.sub(r"^decoder\.(\d+)\.bn(\d)\.",
                   r"decoder.blocks.\1.conv\2.1.", k)
        k = re.sub(r"^decoder\.(\d+)\.conv(\d)\.",
                   r"decoder.blocks.\1.conv\2.0.", k)
        return re.sub(r"^segmentation_head\.", "segmentation_head.0.", k)
    return k                # attunet, nestedunet, vnet, unet3d: as they are


def _dropped_extras(kind, sd):
    """What the reference's checkpoint holds beside the net's forward and
    the importer drops (a seeded constant each)."""
    z = lambda *s: torch.full(s, 0.5)
    if kind in ("deeplabv3plus", "deeplabv3"):
        sd.update({"backbone.fc.weight": z(10, 8), "backbone.fc.bias": z(10)})
    elif kind == "setr":
        sd.update({"auxiliary_head.0.conv_0.weight": z(4, 4, 3, 3),
                   "auxiliary_head.0.syncbn_fc_0.weight": z(4),
                   "decode_head.conv_seg.weight": z(2, 4, 1, 1),
                   "decode_head.conv_seg.bias": z(2)})
    elif kind == "unet_smp":
        sd.update({"encoder.fc.weight": z(10, 8), "encoder.fc.bias": z(10)})
    elif kind in ("segtran2d", "unet2d"):
        sd.update({"discriminator.model.1.weight": z(4, 3, 3, 3),
                   "recon.weight": z(3, 4, 1, 1)})
    return sd


def reference_state_dict(port_sd, kind, tie_qk=True, legacy_names=False):
    """The reference-format state_dict of ``kind`` (a ``convert.cli``
    model kind) holding ``port_sd``'s tensors. ``tie_qk``: Segtran's
    tied Q/K stored twice, as the reference saves it. ``legacy_names``:
    ``out_fpn_bridgeconv`` under its old name ``out_bridgeconv``."""
    out = {}
    for k, v in port_sd.items():
        v = v.detach().clone()
        if kind in SEGTRAN_KINDS:
            v = _group_linear(k, v)
            if legacy_names:
                k = k.replace("out_fpn_bridgeconv", "out_bridgeconv")
            out[k] = v
            key = re.sub(r"(^|\.)query\.(weight|bias)$", r"\1key.\2", k)
            if tie_qk and key != k and key not in port_sd:
                out[key] = v
        else:
            out[_zoo_key(kind, k)] = v
    return _dropped_extras(kind, _bn_counters(out))


def timm_effv2_state_dict(port_backbone_sd):
    """A raw timm ``tf_efficientnetv2_*`` state_dict (features and the
    classification head timm saves) holding an EfficientNetV2Features'
    tensors."""
    out = {}
    for k, v in port_backbone_sd.items():
        k = k.replace("bn_stem.", "bn1.")
        k = k.replace("se_reduce", "se.conv_reduce")
        k = k.replace("se_expand", "se.conv_expand")
        k = re.sub(r"^s(\d+)_b(\d+)\.", r"blocks.\1.\2.", k)
        out[k] = v.detach().clone()
    out.update({"conv_head.weight": torch.full((8, 4, 1, 1), 0.5),
                "bn2.weight": torch.ones(8), "bn2.bias": torch.zeros(8),
                "classifier.weight": torch.full((10, 8), 0.5),
                "classifier.bias": torch.zeros(10)})
    return _bn_counters(out)


def eff_raw_state_dict(port_backbone_sd):
    """A raw EfficientNet (advprop) state_dict: the backbone's tensors
    under the vendored names (the port's) and the classifier ``_fc``."""
    out = {k: v.detach().clone() for k, v in port_backbone_sd.items()}
    out.update({"_fc.weight": torch.full((10, 8), 0.5),
                "_fc.bias": torch.zeros(10)})
    return _bn_counters(out)


def write_reference_pth(path, port_sd, kind, args, iter_num=100, **kw):
    """``torch.save`` of the reference's checkpoint layout."""
    torch.save({"iter_num": iter_num,
                "model": reference_state_dict(port_sd, kind, **kw),
                "args": dict(args)}, path)
    return path
