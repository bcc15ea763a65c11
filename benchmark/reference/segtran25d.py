"""The plain reference of Segtran 2.5D (askerlee/segtran
code/networks/segtran25d.py, ``Segtran25dConfig`` and its forward), in
training mode, for the BraTS recipe's train step.

Depth is folded into the batch: every slice of a [B, H, W, D, C] volume
goes through a 2-D EfficientNet (B3 at the published widths) whose stem
takes the C modalities as they are (``stemconv``), at stem stride 1
(``bb_feat_upsize``), BatchNorm on the statistics of the whole folded
batch (eps 1e-3), drop-connect on the residual blocks (rate 0.2 i / n for
block i of n). The 2-D input FPN (levels 3 and 4, add then GroupNorm)
runs per slice; its output is put back together as a [B, C, H2, W2, D]
volume, depth-pooled to D / K, and fused by ``nets.fusion_encoder``
with raw coordinates in (H, W, D) order, the depth scale taken from the
input's depth. The output FPN runs on depth-last volumes (levels 1-3),
then in the plain order: the bridge conv plus the fused features resized
to its grid, the ``conv`` depth unpool (channel f K + k to depth d K + k),
``out_conv3d`` and the resize to the input. Float32 through ``Prec``;
nothing of the program is imported.

Departures from the program, none of which changes the mathematics: the
tail runs unfactored (the program composes its three 1x1 convs into one
product); BatchNorm takes the variance as ``x.var(unbiased=False)``;
drop-connect keeps a branch with the scale 1 / 0.8 in float32 (the program
rounds it to its compute dtype). ``D_groupsize`` must be 1 (the
configuration's). Its drop-connect masks are drawn from ``gen``, a
``torch.Generator`` seeded as the program's, one [B D, 1, 1, 1] uniform
draw per residual block in block order, so both sides drop the same
branches. With ``chunked`` the backbone's blocks and each sample's tail
are recomputed in the backward (``torch.utils.checkpoint``), so that the
float32 step fits one card next to nothing else; the result is the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import nets
from .nets import FP32, Prec, batch_norm_batch, conv1x1, group_norm_cl, resize

# variant: (width, depth, nominal resolution), reference utils.py
EFF = {"eff-b3": (1.2, 1.4, 300), "eff-b4": (1.4, 1.8, 380)}
FPN_GRID = 8                # in-FPN layer 3 at stem stride 1


def effnet_blocks(variant):
    """[(kernel, stride, expand, in, out, pad)], endpoint indices, stem
    pad: the static TF-SAME pads of the nominal size chain (halved after
    the stem whatever its stride)."""
    w, d, res = EFF[variant]
    size = (res, res)
    stem_pad = nets._same_pad(size, 3, 1)
    size = tuple(math.ceil(n / 2) for n in size)
    blocks, ends = [], []
    for seg, (r, k, s, e, ci, co, _) in enumerate(nets.B0):
        ci, co = nets._round_filters(ci, w), nets._round_filters(co, w)
        for j in range(int(math.ceil(d * r))):
            st = s if j == 0 else 1
            blocks.append((k, st, e, ci if j == 0 else co, co,
                           nets._same_pad(size, k, st)))
            if j == 0:
                size = tuple(math.ceil(n / st) for n in size)
        if seg in nets.ENDPOINT_SEGMENTS:
            ends.append(len(blocks))
    return blocks, ends, stem_pad


def drop_masks(blocks, rate, batch, gen, device):
    """{block index: [B, 1, 1, 1] kept (1) or dropped (0)} of the residual
    blocks with a rate above 0, drawn in block order."""
    out = {}
    for i, (_, st, _, ci, co, _) in enumerate(blocks):
        r = rate * i / len(blocks)
        if st == 1 and ci == co and r > 0:
            u = torch.rand((batch, 1, 1, 1), generator=gen, device=device)
            out[i] = (u < 1.0 - r).float() / (1.0 - r)
    return out


def _block(x, sd, key, spec, p: Prec, keep):
    k, st, e, ci, co, pad = spec
    inp = x
    if e != 1:
        x = p.conv(x, sd[key + "_expand_conv.weight"])
        x = F.silu(batch_norm_batch(x, sd, key + "_bn0"))
    x = p.conv(F.pad(x, pad), sd[key + "_depthwise_conv.weight"], None, st, 0,
               x.shape[1])
    x = F.silu(batch_norm_batch(x, sd, key + "_bn1"))
    s = x.mean((2, 3), keepdim=True)
    s = F.silu(p.conv(s, sd[key + "_se_reduce.weight"],
                      sd[key + "_se_reduce.bias"]))
    s = p.conv(s, sd[key + "_se_expand.weight"], sd[key + "_se_expand.bias"])
    x = torch.sigmoid(s) * x
    x = batch_norm_batch(p.conv(x, sd[key + "_project_conv.weight"]), sd,
                         key + "_bn2")
    if st == 1 and ci == co:
        x = (x if keep is None else x * keep) + inp
    return x


def effnet_features_train(x, sd, p: Prec, variant, masks, chunked,
                          prefix="backbone."):
    """x [N, C, H, W] -> five endpoints, channels-first, BatchNorm on the
    batch's statistics."""
    blocks, ends, stem_pad = effnet_blocks(variant)
    x = p.conv(F.pad(x, stem_pad), sd[prefix + "_conv_stem.weight"])
    x = F.silu(batch_norm_batch(x, sd, prefix + "_bn0"))
    feats = []
    for i, spec in enumerate(blocks):
        args = (sd, f"{prefix}_blocks.{i}.", spec, p, masks.get(i))
        x = (checkpoint(_block, x, *args, use_reentrant=False) if chunked
             else _block(x, *args))
        if i + 1 in ends:
            feats.append(x)
    x = p.conv(x, sd[prefix + "_conv_head.weight"])
    feats.append(F.silu(batch_norm_batch(x, sd, prefix + "_bn1")))
    return feats


def _tail(curr, fused, sd, k, p: Prec):
    """Plain-order tail of one or more samples: [b, C, H', W', D] and the
    fused tokens [b, F, H2, W2, D3] -> scores [b, classes, H', W', D K]."""
    feat = conv1x1(curr, sd, "out_fpn_bridgeconv3d", p) \
        + resize(fused, curr.shape[2:])
    ups = conv1x1(feat, sd, "out_fpn_upsampleD", p)
    b, c, hh, ww, dd = ups.shape
    ups = ups.reshape(b, c // k, k, hh, ww, dd).permute(0, 1, 3, 4, 5, 2) \
        .reshape(b, c // k, hh, ww, dd * k)
    return conv1x1(ups, sd, "out_conv3d", p)


def segtran25d(vol, sd, cfg, p: Prec = FP32, gen=None, chunked=False):
    """vol [B, H, W, D, C] -> logits [B, H, W, D, classes], training mode.
    cfg: the configuration file's ``model`` section; ``gen`` the
    drop-connect draws' generator (none: no drop-connect)."""
    b, h, w, d, c = vol.shape
    if cfg["D_groupsize"] != 1:
        raise ValueError("the reference folds single slices (D_groupsize 1)")
    k = cfg["depth_pool"]
    x = vol.permute(0, 3, 4, 1, 2).reshape(b * d, c, h, w)
    mask = F.avg_pool2d(x.abs(), FPN_GRID, FPN_GRID).sum(1) > 0
    blocks, _, _ = effnet_blocks(cfg["backbone"])
    masks = ({} if gen is None else
             drop_masks(blocks, cfg["drop_connect_rate"], b * d, gen,
                        vol.device))
    feats = effnet_features_train(x, sd, p, cfg["backbone"], masks, chunked)
    g = cfg["groupnorm_groups"]
    curr = conv1x1(feats[3], sd, "in_fpn34_conv", p)
    curr = group_norm_cl(curr + resize(feats[4], curr.shape[2:]), sd,
                         "in_gn4b", g)

    def to_vol(f2d):                        # [B D, C, h, w] -> [B, C, h, w, D]
        return f2d.reshape(b, d, *f2d.shape[1:]).permute(0, 2, 3, 4, 1)

    h2, w2 = curr.shape[2:]
    d3 = d // k
    vfeat = resize(to_vol(curr), (h2, w2, d3))
    maskv = to_vol(mask[:, None].float())
    vmask = (resize(maskv, (h2, w2, d3)) >= 0.5).float()
    n = h2 * w2 * d3
    ijk = torch.stack(torch.meshgrid(*[torch.arange(s, device=vol.device)
                                       for s in (h2, w2, d3)],
                                     indexing="ij"), -1).reshape(-1, 3)
    pos = (ijk.float() * torch.tensor([h // h2, w // w2, d // d3],
                                      dtype=torch.float32,
                                      device=vol.device))[None].expand(b, n, 3)
    dims = cfg["translayer_dims"]
    fused = nets.fusion_encoder(vfeat.flatten(2).transpose(1, 2), pos,
                                vmask.reshape(b, n, 1), sd, dims,
                                cfg["num_modes"], cfg["attn_clip"], p)
    fused = fused.transpose(1, 2).reshape(b, dims[-1], h2, w2, d3)
    curr = to_vol(feats[1])
    for lv in (1, 2):
        up = conv1x1(curr, sd, f"out_fpn{lv}{lv + 1}_conv3d", p)
        curr = group_norm_cl(up + resize(to_vol(feats[lv + 1]), up.shape[2:]),
                             sd, f"out_gn{lv + 1}b", g)
    if chunked:
        scores = torch.cat([checkpoint(_tail, curr[i:i + 1], fused[i:i + 1],
                                       sd, k, p, use_reentrant=False)
                            for i in range(b)])
    else:
        scores = _tail(curr, fused, sd, k, p)
    return resize(scores, (h, w, d)).permute(0, 2, 3, 4, 1)


def forward(gen=None, chunked=False):
    """``steps.Trainer``'s forward: ``segtran25d`` in training mode, its
    drop-connect drawn from ``gen`` step after step."""
    def fwd(img, sd, cfg, p, step):
        return segtran25d(img, sd, cfg, p, gen, chunked)
    return fwd
