"""Modified 3-D U-Net baseline (``--net unet`` of train3d / test3d,
``convert.cli --model unet3d``).

Counterpart of ``segtran_tpu/models/unet3d.py`` (reference
code/networks/unet3d.py Modified3DUNet): a context pathway of residual
blocks with instance norm (no affine, eps 1e-5) and LeakyReLU (slope
0.01), stride-2 convs down; a localization pathway with nearest-neighbour
2x upscales; deep supervision (``ds2`` and ``ds3`` through 1x1x1 convs,
upscaled and summed into the logits). Convs have no bias and pad k // 2.
Whole-channel dropout (p 0.6) from the ``generator`` that
``set_dropout_generator`` gives.

The reference applies each ``norm_lrelu_conv_cN`` twice, with the same
weights, around the dropout; JAX keeps that quirk and so does the port:
one conv per block in the state_dict, run twice.

Volumes are [B, H, W, D, C] channels-last; the net runs channels-first
inside. Module names are the reference's: each helper ``Sequential``
holds its one conv at the reference's index (``lrelu_conv_c1.1``,
``norm_lrelu_conv_c2.2``, ``norm_lrelu_upscale_conv_norm_lrelu_l1.3``,
``conv_norm_lrelu_l1.0``), where JAX names the conv's scope flat.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import ChannelDropout, Conv3d, InstanceNorm, ncdhw, ndhwc
from .vnet import check_spatial


def _conv(cin: int, cout: int, k: int = 3, s: int = 1) -> Conv3d:
    return Conv3d(cin, cout, k, s, padding=k // 2, bias=False)


def _at(index: int, conv: Conv3d) -> nn.Sequential:
    """A reference helper ``Sequential`` with ``conv`` at ``index`` (its
    norms, activations and upsample hold no parameters)."""
    return nn.Sequential(*[nn.Identity() for _ in range(index)], conv)


def _upscale(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x in every spatial axis (JAX's ``jnp.repeat``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Modified3DUNet(nn.Module):
    def __init__(self, in_channels: int = 4, num_classes: int = 4,
                 base_n_filter: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        bf = base_n_filter
        self.conv3d_c1_1 = _conv(in_channels, bf)
        self.conv3d_c1_2 = _conv(bf, bf)
        self.lrelu_conv_c1 = _at(1, _conv(bf, bf))
        cin = bf
        for lvl, f in (("c2", 2 * bf), ("c3", 4 * bf), ("c4", 8 * bf),
                       ("c5", 16 * bf)):
            setattr(self, f"conv3d_{lvl}", _conv(cin, f, 3, 2))
            setattr(self, f"norm_lrelu_conv_{lvl}", _at(2, _conv(f, f)))
            cin = f
        self.norm_lrelu_upscale_conv_norm_lrelu_l0 = _at(3, _conv(16 * bf,
                                                                  8 * bf))
        self.conv3d_l0 = _conv(8 * bf, 8 * bf, 1)
        # localization levels l1..l3: (concat width, conv width, 1x1 out,
        # upscale conv out)
        for lvl, f in (("l1", 16 * bf), ("l2", 8 * bf), ("l3", 4 * bf)):
            setattr(self, f"conv_norm_lrelu_{lvl}", _at(0, _conv(f, f)))
            setattr(self, f"conv3d_{lvl}", _conv(f, f // 2, 1))
            setattr(self, f"norm_lrelu_upscale_conv_norm_lrelu_{lvl}",
                    _at(3, _conv(f // 2, f // 4)))
        self.conv_norm_lrelu_l4 = _at(0, _conv(2 * bf, 2 * bf))
        self.conv3d_l4 = _conv(2 * bf, num_classes, 1)
        self.ds2_1x1_conv3d = _conv(8 * bf, num_classes, 1)
        self.ds3_1x1_conv3d = _conv(4 * bf, num_classes, 1)
        self.inorm = InstanceNorm(1e-5)
        self.dropout = ChannelDropout(0.6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, D, C] -> fp32 logits [B, H, W, D, num_classes]."""
        check_spatial(x.shape, "Modified3DUNet")
        dt = self.dtype
        lrelu = lambda v: F.leaky_relu(v, 0.01)
        norm = lambda v: self.inorm.run(v, dt)
        conv = lambda m, v: m.run(v, dt)

        def nlc(seq, v):               # norm -> lrelu -> conv (seq[2])
            return conv(seq[2], lrelu(norm(v)))

        def cnl(seq, v):               # conv (seq[0]) -> norm -> lrelu
            return lrelu(norm(conv(seq[0], v)))

        def up(seq, v):                # norm, lrelu, upscale, conv (seq[3]),
            v = _upscale(lrelu(norm(v)))   # norm, lrelu
            return lrelu(norm(conv(seq[3], v)))

        out = conv(self.conv3d_c1_1, ncdhw(x, dt))
        residual_1 = out
        out = conv(self.conv3d_c1_2, lrelu(out))
        out = self.dropout(out)
        out = conv(self.lrelu_conv_c1[1], lrelu(out)) + residual_1
        context_1 = lrelu(out)
        out = lrelu(norm(out))
        contexts = []
        for lvl in ("c2", "c3", "c4", "c5"):
            out = conv(getattr(self, f"conv3d_{lvl}"), out)
            res = out
            block = getattr(self, f"norm_lrelu_conv_{lvl}")
            out = nlc(block, self.dropout(nlc(block, out))) + res
            if lvl != "c5":
                out = lrelu(norm(out))
                contexts.append(out)
        context_2, context_3, context_4 = contexts
        out = up(self.norm_lrelu_upscale_conv_norm_lrelu_l0, out)
        out = lrelu(norm(conv(self.conv3d_l0, out)))

        ds = []
        for lvl, skip in (("l1", context_4), ("l2", context_3),
                          ("l3", context_2)):
            out = cnl(getattr(self, f"conv_norm_lrelu_{lvl}"),
                      torch.cat([out, skip], 1))
            ds.append(out)
            out = conv(getattr(self, f"conv3d_{lvl}"), out)
            out = up(getattr(self, f"norm_lrelu_upscale_conv_norm_lrelu_"
                                   f"{lvl}"), out)
        out = cnl(self.conv_norm_lrelu_l4, torch.cat([out, context_1], 1))
        out_pred = conv(self.conv3d_l4, out)
        ds2_up = _upscale(conv(self.ds2_1x1_conv3d, ds[1]))
        ds3 = conv(self.ds3_1x1_conv3d, ds[2])
        return ndhwc((out_pred + _upscale(ds2_up + ds3)).float())
