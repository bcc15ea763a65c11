"""JAX variables -> the port's ``state_dict``.

The reverse of the JAX package's torch importer (rules of
``convert/torch_import.py:8-18``), kept here as the port's own copy:

* flax scope ``name_N`` of a module list  -> ``name.N``
* Dense ``kernel [in, out]``              -> Linear ``weight [out, in]``
* conv ``kernel [kh, kw, I, O]``          -> ``weight [O, I, kh, kw]``
  (depthwise ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``)
* the transposed ``out_conv`` (``nn.ConvTranspose``, a 2x2 kernel
  ``[kh, kw, I, O]``)                     -> ``ConvTranspose2d`` weight
  ``kernel[::-1, ::-1]`` as ``[I, O, kh, kw]``: flax applies the kernel
  unflipped, torch's transposed conv flipped
* 3-D conv ``kernel [kd, kh, kw, I, O]``  -> ``weight [O, I, kd, kh, kw]``
* VNet's transposed up convs (``block_{five,six,seven,eight}_up/conv_0``,
  ``kernel [k, k, k, I, O]``) -> ``ConvTranspose3d`` weight flipped in
  every spatial axis, as ``[I, O, k, k, k]`` (the 2-D rule in 3-D)
* Modified3DUNet: JAX names each helper ``Sequential``'s one conv flat;
  with ``target`` they land at the reference's index
  (``lrelu_conv_c1`` -> ``lrelu_conv_c1.1``, ``norm_lrelu_conv_cN`` ->
  ``norm_lrelu_conv_cN.2``, ``up_lN`` ->
  ``norm_lrelu_upscale_conv_norm_lrelu_lN.3``, ``conv_norm_lrelu_lN`` ->
  ``conv_norm_lrelu_lN.0``)
* MMPrivateLinear ``kernel [M, F, F]``    -> ``weight [M, F, F]`` as is
* ``scale`` / ``bias``                    -> ``weight`` / ``bias``
* ``attractors``, ``pos_embed``, ``biases`` (the sliding position
  biases), ``vfeat_bias``                  -> as they are
* ``batch_stats`` ``mean`` / ``var``      -> ``running_mean`` / ``running_var``
* tied Q/K: the JAX tree holds one ``query`` set, and so does the port.
* Segtran25d: the 2-D in-FPN convs, the 3-D out-FPN convs and the
  EfficientNet stem by the rules above; with ``stemconv`` the stem's
  kernel ``[3, 3, c*G, O]`` (c modalities in depth groups of G) becomes
  ``[O, c*G, 3, 3]`` like any conv (flax infers the stem's input
  channels, the port's ``EfficientNetFeatures`` takes ``in_channels``).

* the 2-D zoo by the same rules, and: flax ``MultiHeadDotProductAttention``
  (the TransUNet ViT's ``attn``) DenseGeneral kernels ``[D, H, hd]`` /
  ``[H, hd, D]`` and biases ``[H, hd]`` -> Linear ``[H * hd, D]`` / ``[D,
  H * hd]`` and ``[H * hd]``; the deformable conv's ``conv_kernel [k*k*I,
  O]`` -> its ``conv.weight [O, I, k, k]`` (k from the sibling
  ``p_conv``'s 2 k^2 outputs) and ``conv_bias`` -> ``conv.bias``; the
  transposed 2x2 ``up{i}`` of the nnU-Net like ``out_conv``;
  ``position_embeddings`` / ``cls_token`` as they are. With ``target``
  (the port model's ``state_dict``), a scope ``name_N`` that the model
  keeps as an attribute (the reference's ``conv0_0``, ``rfb2_1``,
  ``bn4d_1``, ``conv_0``) keeps its spelling.
* the DA slice by the same rules: the U-Net (``inc/double_conv_0`` ->
  ``inc.double_conv.0``), the discriminator's ``model_{idx}`` scopes in
  both index layouts (``model_1`` first with gradient reversal,
  ``model_0`` under ADDA) and its ``tail_1`` Dense, the Polyformer's
  ``attractors`` and attention, the mince layers' plain-Dense
  ``query`` / ``key`` (the Dense rule; JAX names them as ``_QKDense``
  does), the recon head's 1x1 conv; and a DA run's wrapped tree
  ``{"net", "discriminator", "recon", "vcdr_estim" | "vc_estim" +
  "vd_estim"}``, whose top-level names become key prefixes
  (``net.inc...``), the layout ``train/checkpoint.py`` saves.

Every leaf must map; a leaf no rule covers raises.
"""
from __future__ import annotations

import itertools
import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_LIST_SCOPE = re.compile(r"(.+)_(\d+)")


def _leaves(tree: Dict[str, Any], path=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


_AS_IS = ("bias", "attractors", "pos_embed", "biases", "vfeat_bias",
          "position_embeddings", "cls_token")
_TRANSPOSED = re.compile(r"out_conv|up\d+")
_TRANSPOSED_3D = re.compile(r"block_[a-z]+_up")
# (JAX scope prefix, the port's) tried where the target holds no spelling
# of the generic rules: Modified3DUNet's helper Sequentials
_TARGET_RENAMES = [
    (re.compile(r"^lrelu_conv_c1\."), "lrelu_conv_c1.1."),
    (re.compile(r"^(norm_lrelu_conv_c\d)\."), r"\1.2."),
    (re.compile(r"^up_(l\d)\."), r"norm_lrelu_upscale_conv_norm_lrelu_\1.3."),
    (re.compile(r"^(conv_norm_lrelu_l\d)\."), r"\1.0."),
]


def _candidate_keys(path: tuple):
    """Every spelling of ``path``: each ``name_N`` scope as ``name.N`` (the
    generic rule, first) or as it is."""
    opts = []
    for p in path:
        m = _LIST_SCOPE.fullmatch(p)
        opts.append((f"{m.group(1)}.{m.group(2)}", p) if m else (p,))
    return [".".join(c) for c in itertools.product(*opts)]


def _param(path: tuple, arr: np.ndarray, where: str) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    attn = path[-3:-2] == ("attn",)
    if leaf == "kernel":
        if (arr.ndim == 4 and _TRANSPOSED.fullmatch(path[-2])
                and arr.shape[:2] != (1, 1)):
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if (arr.ndim == 5 and path[-2] == "conv_0" and len(path) > 2
                and _TRANSPOSED_3D.fullmatch(path[-3])):
            return "weight", arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        if arr.ndim == 3 and attn:
            if path[-2] == "out":
                return "weight", arr.reshape(-1, arr.shape[-1]).T
            return "weight", arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", arr
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:
            return "weight", arr.transpose(4, 3, 0, 1, 2)
    elif leaf == "scale":
        return "weight", arr
    elif leaf == "bias" and arr.ndim == 2 and attn:
        return "bias", arr.reshape(-1)
    elif leaf == "conv_bias":
        return "conv.bias", arr
    elif leaf in _AS_IS:
        return leaf, arr
    raise ValueError(f"no conversion rule for JAX leaf {where} "
                     f"{arr.shape}")


def _deform_kernel(params, path, arr):
    """``conv_kernel [k*k*I, O]`` -> ``[O, I, k, k]``."""
    scope = params
    for p in path[:-1]:
        scope = scope[p]
    n = np.asarray(scope["p_conv"]["kernel"]).shape[-1] // 2
    k = int(round(n ** 0.5))
    return arr.reshape(k, k, arr.shape[0] // n, arr.shape[1]).transpose(
        3, 2, 0, 1)


def _converted(params, batch_stats, target, unknown=None):
    """(key, numpy value) of every leaf; ``target`` and ``unknown`` as in
    ``state_dict_from_jax``."""
    def key(path):
        keys = _candidate_keys(path)
        if target is not None:
            for k in keys:
                if k in target:
                    return k
            for k in keys:
                for pat, rep in _TARGET_RENAMES:
                    renamed = pat.sub(rep, k)
                    if renamed in target:
                        return renamed
        return keys[0]

    for path, arr in _leaves(params):
        where = "params/" + "/".join(path)
        arr = np.asarray(arr)
        if path[-1] == "conv_kernel":
            name, val = "conv.weight", _deform_kernel(params, path, arr)
        else:
            try:
                name, val = _param(path, arr, where)
            except ValueError:
                if unknown is None:
                    raise
                unknown.append(where)
                continue
        yield key(path[:-1] + tuple(name.split("."))), val
    for path, arr in _leaves(batch_stats or {}):
        leaf = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if leaf is None:
            raise ValueError("no conversion rule for JAX leaf batch_stats/"
                             + "/".join(path))
        yield key(path[:-1] + (leaf,)), np.asarray(arr)


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Dict[str, Any] | None = None,
                        target=None, unknown=None
                        ) -> Dict[str, torch.Tensor]:
    """params / batch_stats: nested dicts of numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, variables)``). ``target``: the
    names the port's model holds (its ``state_dict``), to choose among the
    spellings of a ``name_N`` scope; without it the generic rule.
    ``unknown``: a list that takes the path of every params leaf no rule
    covers, instead of raising."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _converted(params, batch_stats, target, unknown)}
