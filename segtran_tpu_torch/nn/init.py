"""The reference's post-init weight passes on the port's modules.

Counterpart of ``segtran_tpu/nn/init.py`` (reference segtran2d.py:210-213,
segtran_shared.py:392-402, 522-546). After the seeded family init
(``models/segtran2d.init_segtran2d``), by module:

* every ``CrossAttFeatTrans``: with ``tie_qk_scheme='loose'`` K starts as a
  copy of Q; then the identity bias goes onto K's weight (onto the one
  shared Q/K weight when tied);
* every ``ExpandedFeatTrans``: the identity bias onto V's first mode
  (``first_linear``); every ``MultiHeadFeatTrans`` (``ablate_multihead``)
  counts as an expansion of one mode, so its ``first_linear`` takes the
  same bias (JAX sows its ``expansion`` meta, nn/attention.py:715-719).

Weights are torch Linear layouts ``[out, in]`` (the JAX kernels are
``[in, out]``).

``torch_conv_kernel_init`` / ``torch_conv_bias_init_for`` (JAX
nn/init.py:124-137) are PyTorch's own default conv init, U(-b, b) with b =
1 / sqrt(fan in), for torch-layout ``[O, I, *k]`` kernels: the init the
2-D zoo's convs keep (train2d builds a zoo net under ``--seed`` and
leaves its modules' defaults).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .attention import (CrossAttFeatTrans, ExpandedFeatTrans,
                        MultiHeadFeatTrans)


def _idbias_qk(weight: torch.Tensor, amd: int, scale: float,
               base_range: float) -> torch.Tensor:
    """K identity bias (reference segtran_shared.py:538-546): the first
    ``amd`` output rows become ``0.5 W + base * scale * I`` with the
    identity tiled along the input."""
    out = weight.clone()
    in_dim = weight.shape[1]
    eye = (torch.arange(in_dim)[None, :] % amd
           == torch.arange(amd)[:, None]).to(weight.dtype)
    out[:amd] = out[:amd] * 0.5 + eye.to(weight.device) * (base_range * scale)
    return out


def _idbias_v(weight: torch.Tensor, feat_dim: int, scale: float,
              base_range: float) -> torch.Tensor:
    """V identity bias on the first mode (reference
    segtran_shared.py:392-402): ``W[:F, :F] = 0.5 W + base * scale * I``."""
    out = weight.clone()
    eye = torch.eye(feat_dim, dtype=weight.dtype, device=weight.device)
    out[:feat_dim, :feat_dim] = (out[:feat_dim, :feat_dim] * 0.5
                                 + eye * (base_range * scale))
    return out


def apply_reference_init_schemes(model: nn.Module, base_range: float,
                                 query_idbias_scale: float,
                                 feattrans_lin1_idbias_scale: float
                                 ) -> nn.Module:
    """The loose Q->K copy and the identity biases, in place."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, CrossAttFeatTrans):
                s = m.spec
                if s.tie_qk_scheme == "loose":
                    m.key.weight.copy_(m.query.weight)
                    if m.key.bias is not None and m.query.bias is not None:
                        m.key.bias.copy_(m.query.bias)
                if query_idbias_scale > 0:
                    lin = m._key()
                    lin.weight.copy_(_idbias_qk(
                        lin.weight, s.attention_mode_dim,
                        query_idbias_scale, base_range))
            elif isinstance(m, (ExpandedFeatTrans, MultiHeadFeatTrans)):
                if feattrans_lin1_idbias_scale > 0:
                    w = m.first_linear.weight
                    w.copy_(_idbias_v(w, m.spec.feat_dim,
                                      feattrans_lin1_idbias_scale,
                                      base_range))
    return model


def init_with_reference_schemes(model: nn.Module, cfg=None,
                                seed: int = 0) -> nn.Module:
    """The seeded family init that every model of the port shares
    (``init_segtran2d``) + the reference passes with the scales of
    ``cfg``, or without one (the U-Net and its Polyformer, the
    discriminator) JAX ``TransLayerSpec``'s defaults: where JAX
    ``init_with_reference_schemes`` starts a model trained from scratch."""
    from ..models.segtran2d import init_segtran2d
    init_segtran2d(model, seed)
    return apply_reference_init_schemes(
        model, getattr(cfg, "base_initializer_range", 0.02),
        getattr(cfg, "query_idbias_scale", 10.0),
        getattr(cfg, "feattrans_lin1_idbias_scale", 10.0))


def torch_conv_kernel_init(shape, generator=None,
                           dtype=torch.float32) -> torch.Tensor:
    """A conv kernel [O, I, *k] as ``nn.Conv2d`` draws it
    (``kaiming_uniform_(a=sqrt(5))``: U(-b, b), b = 1 / sqrt(I * prod(k)))."""
    w = torch.empty(tuple(shape), dtype=dtype)
    return nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)


def torch_conv_bias_init_for(fan_in: int):
    """``init(shape, generator=None)``: U(-b, b), b = 1 / sqrt(fan_in), the
    bias of a default conv with that fan in."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def init(shape, generator=None, dtype=torch.float32):
        return torch.empty(tuple(shape), dtype=dtype).uniform_(
            -bound, bound, generator=generator)
    return init
