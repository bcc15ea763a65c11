"""Reference PyTorch state_dict -> the JAX-shaped (params, batch_stats)
trees.

The port's own copy of ``segtran_tpu/convert/torch_import.py`` (pure
numpy; the reference's released checkpoints, REFUGE / BraTS, are torch
``state_dict`` files). A reference ``.pth`` reaches the port in two
steps: these rules give the trees the JAX package would build, then
``convert.state_dict_from_jax(..., target=model.state_dict())`` gives the
port's state_dict; ``assign_converted`` does both and checks every shape
(and, strict, every key) against the model's state_dict.

Name translation is rule-based:
  * ``a.b.{i}.c``  ->  list-modules become ``a/b_{i}/c`` flax scopes
    (reference uses nn.ModuleList, JAX uses indexed names),
  * Linear ``weight [out,in]``       -> ``kernel [in,out]``,
  * Conv2d/3d ``weight [O,I,*k]``    -> ``kernel [*k,I,O]``,
  * grouped Conv1d ``weight [M*F,F,1]`` (the reference's per-mode "group
    linear", segtran_shared.py:208,261) -> ``kernel [M,F,F]`` einsum weights,
  * LayerNorm/GroupNorm/BatchNorm ``weight/bias`` -> ``scale/bias``; BN
    running stats -> the ``batch_stats`` collection,
  * ``key.*`` dropped when Q/K are shared (the reference stores the tied
    tensor twice; one parameter is kept).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _translate_module_path(torch_key: str) -> Tuple[str, ...]:
    """'translayers.0.in_ator_trans.query.weight' ->
    ('translayers_0', 'in_ator_trans', 'query', 'weight')."""
    parts = torch_key.split(".")
    out = []
    i = 0
    while i < len(parts):
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i+1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def convert_state_dict(sd: Dict[str, np.ndarray],
                       tie_qk_shared: bool = True,
                       norm_class_of: Dict[str, str] | None = None,
                       transposed_conv_paths: frozenset = frozenset(),
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a torch state_dict (str -> np.ndarray) to (params, batch_stats).

    norm_class_of: optional map from torch module path (without '.weight') to
    'bn' for BatchNorm modules whose running stats exist. BN is auto-detected
    from the presence of ``<path>.running_mean``.

    transposed_conv_paths: torch module paths (without '.weight') that are
    ConvTranspose2d/3d. Their weights are stored [I, O, *k] (vs [O, I, *k]
    for Conv), which rank alone cannot distinguish -- e.g. the reference's
    no-out-FPN 2x upsampling head (segtran2d.py:205-208 'out_conv') and the
    segtran3d ConvTranspose3d head.
    """
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    sd = {k: np.asarray(v) for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}

    bn_paths = {k[:-len(".running_mean")] for k in sd
                if k.endswith(".running_mean")}

    for key, w in sd.items():
        path = _translate_module_path(key)
        mod_path_torch = key.rsplit(".", 1)[0]
        leaf = path[-1]
        mod_path = path[:-1]
        is_bn = mod_path_torch in bn_paths or (
            norm_class_of or {}).get(mod_path_torch) == "bn"

        if tie_qk_shared and len(mod_path) >= 1 and mod_path[-1] == "key":
            # Q/K tied: the flax model has a single shared 'query' parameter.
            continue

        if leaf == "running_mean":
            _set_path(batch_stats, mod_path + ("mean",), w)
            continue
        if leaf == "running_var":
            _set_path(batch_stats, mod_path + ("var",), w)
            continue

        if leaf == "weight":
            if w.ndim == 1:
                # norm scale (LN / GN / BN)
                _set_path(params, mod_path + ("scale",), w)
            elif w.ndim == 2:
                # Linear [out, in] -> [in, out]
                _set_path(params, mod_path + ("kernel",), w.T)
            elif w.ndim == 3:
                if w.shape[-1] == 1 and w.shape[0] % w.shape[1] == 0 \
                        and w.shape[0] != w.shape[1]:
                    # grouped 1x1 Conv1d [M*F, F, 1] -> per-mode [M, F, F]
                    # kernel[m, f, g] = w[m*F+g, f, 0]
                    mf, f, _ = w.shape
                    m = mf // f
                    _set_path(params, mod_path + ("kernel",),
                              w[:, :, 0].reshape(m, f, f).transpose(0, 2, 1))
                elif w.shape[-1] == 1 and w.shape[0] == w.shape[1]:
                    # 1-mode group linear (or plain conv1d k=1): [F, F, 1]
                    _set_path(params, mod_path + ("kernel",),
                              w[:, :, 0].reshape(1, w.shape[0], w.shape[1])
                              .transpose(0, 2, 1))
                else:
                    # general Conv1d [O, I, k] -> [k, I, O]
                    _set_path(params, mod_path + ("kernel",),
                              w.transpose(2, 1, 0))
            elif w.ndim == 4:
                if mod_path_torch in transposed_conv_paths:
                    # ConvTranspose2d [I, O, kh, kw] -> [kh, kw, I, O];
                    # torch is gradient-of-conv, flax ConvTranspose
                    # (transpose_kernel=False) is a fractionally strided
                    # correlation -> flip the spatial dims
                    _set_path(params, mod_path + ("kernel",),
                              w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
                else:
                    # Conv2d [O, I, kh, kw] -> [kh, kw, I, O]
                    _set_path(params, mod_path + ("kernel",),
                              w.transpose(2, 3, 1, 0))
            elif w.ndim == 5:
                if mod_path_torch in transposed_conv_paths:
                    # ConvTranspose3d [I, O, kd, kh, kw] -> [kd, kh, kw, I, O]
                    # with the same spatial flip as the 2D case
                    _set_path(params, mod_path + ("kernel",),
                              w[:, :, ::-1, ::-1, ::-1]
                              .transpose(2, 3, 4, 0, 1))
                else:
                    # Conv3d [O, I, kd, kh, kw] -> [kd, kh, kw, I, O]
                    _set_path(params, mod_path + ("kernel",),
                              w.transpose(2, 3, 4, 1, 0))
            else:
                raise ValueError(f"unhandled weight rank for {key}: {w.shape}")
            continue

        if leaf == "bias":
            if w.ndim == 1 and mod_path and mod_path[-1] in (
                    "group_linear",):
                # grouped conv1d bias [M*F] -> [M, F]; F from matching kernel
                kernel_key = key.rsplit(".", 1)[0] + ".weight"
                f = sd[kernel_key].shape[1]
                _set_path(params, mod_path + ("bias",), w.reshape(-1, f))
            else:
                _set_path(params, mod_path + ("bias",), w)
            continue

        # raw parameters (attractors, biases of SlidingPosBiases, vfeat_bias,
        # input_skip_coeff): keep as-is under the translated path
        _set_path(params, path, w)

    return params, batch_stats


_TIMM_EFFV2_BLOCK = re.compile(r"^blocks\.(\d+)\.(\d+)\.(.+)$")


def rename_timm_effv2_key(key: str) -> str | None:
    """timm tf_efficientnetv2_* state_dict key -> this framework's
    EfficientNetV2Features scope path (backbones/efficientnetv2.py), or None
    for head keys a features_only backbone drops.

    timm layout (the reference loads these via timm's
    tf_efficientnetv2_{s,m,l}_in21k factories, segtran2d.py:106-117):
      conv_stem.weight / bn1.*              -> conv_stem / bn_stem
      blocks.{s}.{j}.conv|conv_exp|conv_pw|conv_dw|conv_pwl|bn1..bn3
                                            -> s{s}_b{j}.<same>
      blocks.{s}.{j}.se.conv_reduce|expand  -> s{s}_b{j}.se_reduce|se_expand
      conv_head.* / bn2.* / classifier.*    -> dropped (no head in
                                               features_only mode)
    """
    if key.startswith(("conv_head.", "classifier.", "bn2.")):
        return None
    if key.startswith("bn1."):
        return "bn_stem." + key[len("bn1."):]
    m = _TIMM_EFFV2_BLOCK.match(key)
    if m:
        rest = m.group(3)
        rest = rest.replace("se.conv_reduce", "se_reduce")
        rest = rest.replace("se.conv_expand", "se_expand")
        return f"s{m.group(1)}_b{m.group(2)}.{rest}"
    return key


def convert_timm_effv2(sd: Dict[str, np.ndarray]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a raw timm EfficientNetV2 state_dict to flax (params,
    batch_stats) trees rooted at the backbone scope, ready to graft under
    ``params['backbone']`` (e.g. via train2d --cp on an orbax payload that
    carries only the backbone subtree)."""
    renamed = {}
    for k, v in sd.items():
        nk = rename_timm_effv2_key(k)
        if nk is not None:
            renamed[nk] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


_TU_BODY = re.compile(r"hybrid_model\.body\.(block\d+)\.(unit\d+)\.")
_TU_LAYER = re.compile(r"encoder\.layer\.(\d+)\.")
_TU_ATTN = re.compile(r"encoder\.block_(\d+)\.attn\.(query|key|value|out)\."
                      r"(weight|bias)$")


def rename_transunet_key(key: str) -> str:
    """Reference TransUNet state_dict key (vit_seg_modeling.py) -> this
    framework's models/transunet.py scope path."""
    key = key.replace("transformer.embeddings.", "")
    key = key.replace("transformer.encoder.", "encoder.")
    key = key.replace("hybrid_model.root.conv.", "hybrid_model.root_conv.")
    key = key.replace("hybrid_model.root.gn.", "hybrid_model.root_gn.")
    key = _TU_BODY.sub(r"hybrid_model.body_\1_\2.", key)
    key = _TU_LAYER.sub(r"encoder.block_\1.", key)
    if key.startswith("decoder."):
        key = key[len("decoder."):]
    return key


def convert_transunet(sd: Dict[str, np.ndarray], num_heads: int = 12
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference TransUNet state_dict: rename to our scopes, then
    reshape the attention projections for flax MultiHeadDotProductAttention
    (q/k/v [out,in] -> kernel [in, H, hd], bias [out] -> [H, hd]; out proj
    [out,in] -> kernel [H, hd, out]); everything else goes through the
    generic mapper."""
    renamed = {rename_transunet_key(k): v for k, v in sd.items()}
    params: Dict[str, Any] = {}
    rest = {}
    for k, v in renamed.items():
        m = _TU_ATTN.match(k)
        if not m:
            rest[k] = v
            continue
        i, which, leaf = m.groups()
        path = ("encoder", f"block_{i}", "attn", which)
        v = np.asarray(v)
        if which == "out":
            if leaf == "weight":    # [out, in] -> [H, hd, out]
                d_in = v.shape[1]
                w = v.T.reshape(num_heads, d_in // num_heads, v.shape[0])
                _set_path(params, path + ("kernel",), w)
            else:
                _set_path(params, path + ("bias",), v)
        else:
            if leaf == "weight":    # [out, in] -> [in, H, hd]
                d = v.shape[0]
                _set_path(params, path + ("kernel",),
                          v.T.reshape(v.shape[1], num_heads, d // num_heads))
            else:
                _set_path(params, path + ("bias",),
                          v.reshape(num_heads, -1))
    gparams, gstats = convert_state_dict(rest, tie_qk_shared=False)

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = v
    merge(gparams, params)
    return gparams, gstats


_DL_CONVS = re.compile(r"\.aspp\.convs\.(\d)\.(\d)\.")
_DL_V3_CONVS = re.compile(r"classifier\.classifier\.0\.convs\.(\d)\.(\d)\.")


def rename_deeplab_key(key: str) -> str:
    """Reference deeplab state_dict key (networks/deeplab/_deeplab.py) ->
    models/deeplab.py scope path. Only the ASPP ModuleList needs renaming
    (``convs.I.J`` -> the flat ``convsI_J`` scope); everything else maps via
    the generic digit-pairing translation."""
    key = _DL_V3_CONVS.sub(r"classifier.classifier.0.convs\1_\2.", key)
    key = _DL_CONVS.sub(lambda m: f".aspp.convs{m.group(1)}_{m.group(2)}.",
                        key)
    return key


def convert_deeplab(sd: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference DeepLabV3/V3+ state_dict (torchvision-style
    dilated resnet backbone + ASPP heads) to flax trees for
    models/deeplab.py."""
    renamed = {rename_deeplab_key(k): v for k, v in sd.items()
               if not k.startswith(("backbone.fc.", "backbone.avgpool."))}
    return convert_state_dict(renamed, tie_qk_shared=False)


def convert_vnet(sd: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference VNet state_dict (networks/vnet.py:145-260) to
    flax trees for models/vnet.py. Scope names mirror the torch Sequential
    indices (block_one.conv.0 -> block_one/conv_0); the UpsamplingDeconvBlock
    ConvTranspose3d weights ([I, O, k, k, k]) are flagged so the generic
    mapper applies the transpose+flip."""
    transposed = frozenset(
        k[:-len(".weight")] for k in sd
        if k.endswith("_up.conv.0.weight"))
    return convert_state_dict(sd, tie_qk_shared=False,
                              transposed_conv_paths=transposed)


_U3D_RENAMES = [
    (re.compile(r"^lrelu_conv_c1\.1\."), "lrelu_conv_c1."),
    (re.compile(r"^(norm_lrelu_conv_c\d)\.2\."), r"\1."),
    (re.compile(r"^norm_lrelu_upscale_conv_norm_lrelu_(l\d)\.3\."),
     r"up_\1."),
    (re.compile(r"^(conv_norm_lrelu_l\d)\.0\."), r"\1."),
]


def convert_unet3d(sd: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference Modified3DUNet state_dict (networks/unet3d.py)
    to flax trees for models/unet3d.py. InstanceNorm3d carries no params;
    each helper Sequential holds exactly one conv, renamed onto the flax
    flat conv scopes (the doubly-applied norm_lrelu_conv_cN convs map once
    and are shared, matching the reference's double application)."""
    renamed = {}
    for k, v in sd.items():
        for pat, rep in _U3D_RENAMES:
            k = pat.sub(rep, k)
        renamed[k] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


def convert_nestedunet(sd: Dict[str, np.ndarray]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference NestedUNet (UNet++) state_dict
    (networks/nested_unet.py:67-137) to flax trees for
    models/nested_unet.py. Scope names mirror the torch attributes exactly
    (convI_J.conv1/bn1/conv2/bn2, finalN), so the generic translation
    suffices."""
    return convert_state_dict(sd, tie_qk_shared=False)


_U3P_CONV = re.compile(r"^(conv\d)\.conv(\d)\.0\.")
_U3P_BN = re.compile(r"^(conv\d)\.conv(\d)\.1\.")


def convert_unet3plus(sd: Dict[str, np.ndarray]
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference UNet_3Plus state_dict
    (networks/unet_3plus/unet_3plus.py:10-240) to flax trees for
    models/unet_3plus.py. The encoder's unetConv2 stores each stage as a
    Sequential (convN.0 conv / convN.1 BN, layers.py:17-21) where the flax
    UnetConv2 names them convN / bnN; every decoder branch
    (hX_PT_hdY_conv/_bn, convNd_1/bnNd_1, outconv1) maps generically."""
    renamed = {}
    for k, v in sd.items():
        k = _U3P_BN.sub(r"\1.bn\2.", k)
        k = _U3P_CONV.sub(r"\1.conv\2.", k)
        renamed[k] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


_DUNET_DOWN = re.compile(r"^(down\d)\.mpconv\.1\.conv\.")
_DUNET_WRAP = re.compile(r"^(inc|up\d)\.conv\.conv\.")


def convert_dunet(sd: Dict[str, np.ndarray]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference DUNetV1V2 state_dict
    (networks/deformable_unet/deform_unet.py) to flax trees for
    models/dunet.py.

    The inconv/down/up wrappers each hold a double_conv whose Sequential is
    the flax DoubleConv scope, so the wrapper levels collapse
    (down1.mpconv.1.conv.0 -> down1.conv_0). DeformConv2d's inner stride-k
    conv (deform_conv_v2.py:16,87) becomes the flat ``conv_kernel`` tap
    matmul: [O, I, k, k] -> [(dr*k+dc)*I + i, O]."""
    renamed = {}
    for k, v in sd.items():
        k = _DUNET_DOWN.sub(r"\1.conv.", k)
        k = _DUNET_WRAP.sub(r"\1.conv.", k)
        renamed[k] = v
    # deform blocks: a '<blk>.conv.weight' whose sibling '<blk>.p_conv.weight'
    # exists is the DeformConv2d inner conv, not a plain nn.Conv
    deform_blocks = {k[:-len(".p_conv.weight")] for k in renamed
                     if k.endswith(".p_conv.weight")}
    deform_kernels = {}
    for blk in deform_blocks:
        w = renamed.pop(f"{blk}.conv.weight")
        o, i, kh, kw = w.shape
        deform_kernels[blk] = w.transpose(2, 3, 1, 0).reshape(kh * kw * i, o)
    params, batch_stats = convert_state_dict(renamed, tie_qk_shared=False)
    for blk, kern in deform_kernels.items():
        _set_path(params, _translate_module_path(blk) + ("conv_kernel",),
                  kern)
    return params, batch_stats


_ATT_RRCNN = re.compile(r"^RRCNN(\d)\.")
_ATT_UP_RRCNN = re.compile(r"^Up_RRCNN(\d)\.")


def convert_attunet(sd: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference AttU_Net / R2AttU_Net state_dict
    (networks/att_unet.py:276-418) to flax trees for models/att_unet.py.

    AttU_Net keys map via the generic digit-pairing translation; the R2
    variants name their blocks RRCNN1..5 / Up_RRCNN5..2 where the flax model
    reuses the Conv1..5 / Up_conv5..2 scopes for both topologies."""
    renamed = {}
    for k, v in sd.items():
        k = _ATT_UP_RRCNN.sub(r"Up_conv\1.", k)
        k = _ATT_RRCNN.sub(r"Conv\1.", k)
        renamed[k] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


_SMP_DEC_CONV = re.compile(r"^decoder\.blocks\.(\d+)\.conv(\d)\.0\.")
_SMP_DEC_BN = re.compile(r"^decoder\.blocks\.(\d+)\.conv(\d)\.1\.")


def convert_unet_smp(sd: Dict[str, np.ndarray]
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference smp.Unet state_dict (vendored
    segmentation_models_pytorch, --net unet, train2d.py:933-951) to flax
    trees for models/unet_smp.py.

    Decoder Conv2dReLU Sequentials (unet/decoder.py:18-33: convM.0 conv /
    convM.1 BN) map onto the flat decoder_{i}.convM/bnM scopes and the
    SegmentationHead Sequential's conv (base/heads.py:8) onto
    segmentation_head; encoder keys (torchvision resnet naming, matching our
    ResNetFeatures scopes) go through the generic digit-pairing translation.
    Classifier remnants (fc/avgpool) are dropped."""
    renamed = {}
    for k, v in sd.items():
        if k.startswith(("encoder.fc.", "encoder.avgpool.",
                         "classification_head.")):
            continue
        k = _SMP_DEC_BN.sub(r"decoder_\1.bn\2.", k)
        k = _SMP_DEC_CONV.sub(r"decoder_\1.conv\2.", k)
        if k.startswith("segmentation_head.0."):
            k = "segmentation_head." + k[len("segmentation_head.0."):]
        renamed[k] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


def rename_setr_key(key: str) -> str | None:
    """Reference SETR state_dict key (vendored mmseg, EncoderDecoder of
    VisionTransformer + VisionTransformerUpHead -- train2d.py:954-974) ->
    models/setr.py scope path, or None for params the forward never uses.

    Dropped: the four auxiliary heads (constructed but unreachable through
    forward_dummy, encoder_decoder.py:130-134) and BaseDecodeHead's
    ``conv_seg`` (decode_head.py:79 -- VisionTransformerUpHead.forward never
    calls it). ``backbone.patch_embed.proj`` collapses onto the single
    ``backbone/patch_embed`` conv scope; everything else (blocks.N digit
    pairing, qkv/proj Linear transposes, syncbn running stats) maps via the
    generic translation."""
    if key.startswith("auxiliary_head.") or key.startswith(
            "decode_head.conv_seg."):
        return None
    return key.replace("backbone.patch_embed.proj.",
                       "backbone.patch_embed.")


def convert_setr(sd: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert a reference SETR-PUP state_dict to flax trees for
    models/setr.py (SETR_PUP)."""
    renamed = {}
    for k, v in sd.items():
        nk = rename_setr_key(k)
        if nk is not None:
            renamed[nk] = v
    return convert_state_dict(renamed, tie_qk_shared=False)


def assign_converted(target: Dict[str, Any], params: Dict[str, Any],
                     batch_stats: Dict[str, Any] | None = None,
                     strict: bool = True) -> Tuple[Dict[str, Any], list,
                                                   list]:
    """Load converted trees into a model's state_dict ``target``: returns
    (the new state_dict, the target keys the checkpoint did not give, the
    converted keys the model does not hold). Every shape is checked;
    ``strict``: a missing or left-over key raises KeyError, as does a
    leaf no rule of ``state_dict_from_jax`` covers. Not strict: the
    model's own values stay where the checkpoint gives none, left-overs
    are dropped."""
    from . import state_dict_from_jax
    unknown = None if strict else []
    conv = state_dict_from_jax(params, batch_stats, target=target,
                               unknown=unknown)
    missing = sorted(set(target) - set(conv))
    extra = sorted(set(conv) - set(target)) + list(unknown or ())
    if strict and (missing or extra):
        raise KeyError(f"checkpoint and model disagree: missing "
                       f"{missing[:8]} ({len(missing)}), left over "
                       f"{extra[:8]} ({len(extra)})")
    out = dict(target)
    for k, v in conv.items():
        if k not in target:
            continue
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint "
                             f"{tuple(v.shape)} vs model "
                             f"{tuple(target[k].shape)}")
        out[k] = v.to(target[k].dtype)
    return out, missing, extra
