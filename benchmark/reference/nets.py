"""The plain reference of the two Segtran configurations the benchmark runs.

A frozen, functional restatement in plain PyTorch of

* the EfficientNet-B4 feature pyramid (MBConv with TF-SAME static pads
  from the nominal size chain, BatchNorm eps 1e-3) and Segtran2d on it;
* the Inception-v1 I3D pyramid (Unit3D with runtime TF-SAME pads, SAME
  max pools padded with -inf) and Segtran3d on it;
* the squeezed fusion encoder shared by both (learned sinusoidal position
  code, tied Q/K, a clamp to +-attn_clip when the global score maximum
  exceeds it, softmax, P V, the shared gelu mid, the private output with
  its residual dropped, the learned softmax pool over modes).

Every function reads a state dict keyed as the program's modules are (the
benchmark draws one set of weights and hands it to both sides) and
computes in float32. It imports nothing of the program: it works the
folded BatchNorm, the factored head and every other derived operand out
again from the raw weights, in the plain order (P V before its products,
the output head unfactored). ``Prec`` decides how each convolution and
matrix product rounds: not at all (the reference), or as an fp8 recipe
does (the control, the precision below the configurations' bfloat16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the largest finite values of float8 e4m3 (operands of the forward) and
# e5m2 (gradients entering the backward's products)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round8(x, dtype):
    """x rounded to ``dtype`` after scaling its amax to the format's
    largest value (one scale per tensor), back in x's type."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX[dtype]
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """Forward: the product's output rounded to bfloat16. Backward: the
    incoming gradient in e5m2, as the backward's products take it."""

    @staticmethod
    def forward(ctx, y):
        return y.to(torch.bfloat16).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


class Prec:
    """How every product of the reference rounds: ``fp32`` not at all
    (the reference); ``fp8`` as an fp8 recipe does (the control, the
    precision below the configurations' bfloat16): operands in float8
    e4m3 and the gradients entering the backward's products in e5m2, each
    with one scale per tensor, products accumulated in float32 and given
    out in bfloat16."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def _wrap(self, fn, *operands):
        if self.name == "fp32":
            return fn(*operands)
        return _Output.apply(fn(*(_Operand.apply(o) for o in operands)))

    def mm(self, a, b):
        return self._wrap(torch.matmul, a, b)

    def einsum(self, eq, a, b):
        return self._wrap(lambda x, y: torch.einsum(eq, x, y), a, b)

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        fn = F.conv2d if x.dim() == 4 else F.conv3d
        y = self._wrap(lambda xx, ww: fn(xx, ww, None, stride, padding, 1,
                                         groups), x, w)
        return y if b is None else y + b.view((1, -1) + (1,) * (y.dim() - 2))


FP32 = Prec("fp32")


# ----------------------------------------------------------------- norms ----

def batch_norm_eval(x, sd, key, eps=1e-3):
    """x [B, C, *sp] with running statistics."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(sd[key + ".running_var"] + eps) * sd[key + ".weight"]
    return (x - sd[key + ".running_mean"].view(shape)) * inv.view(shape) \
        + sd[key + ".bias"].view(shape)


def batch_norm_batch(x, sd, key, eps=1e-3):
    """Training BatchNorm: the batch's mean and biased variance."""
    dims = [0] + list(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    mean = x.mean(dims)
    var = x.var(dims, unbiased=False)
    inv = torch.rsqrt(var + eps) * sd[key + ".weight"]
    return (x - mean.view(shape)) * inv.view(shape) \
        + sd[key + ".bias"].view(shape)


def layer_norm(x, sd=None, key=None, eps=1e-12):
    w = sd[key + ".weight"] if sd is not None else None
    b = sd[key + ".bias"] if sd is not None else None
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def group_norm_cl(x, sd, key, groups, eps=1e-5):
    """GroupNorm of a channels-first tensor."""
    return F.group_norm(x, groups, sd[key + ".weight"], sd[key + ".bias"], eps)


def resize(x, size):
    """Linear resize of a channels-first tensor, half-pixel centres."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    mode = "bilinear" if len(size) == 2 else "trilinear"
    return F.interpolate(x, size=size, mode=mode, align_corners=False)


def conv1x1(x, sd, key, p: Prec, bias=True):
    w = sd[key + ".weight"]
    return p.conv(x, w, sd[key + ".bias"] if bias else None)


# ------------------------------------------------------- EfficientNet-B4 ----

# variant: (width, depth, nominal resolution)
EFF = {"eff-b4": (1.4, 1.8, 380)}
# (repeats, kernel, stride, expand, in, out, se) of B0
B0 = ((1, 3, 1, 1, 32, 16, 0.25), (2, 3, 2, 6, 16, 24, 0.25),
      (2, 5, 2, 6, 24, 40, 0.25), (3, 3, 2, 6, 40, 80, 0.25),
      (3, 5, 1, 6, 80, 112, 0.25), (4, 5, 2, 6, 112, 192, 0.25),
      (1, 3, 1, 6, 192, 320, 0.25))
ENDPOINT_SEGMENTS = (0, 1, 2, 4)


def _round_filters(f, w, divisor=8):
    f *= w
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * f else new)


def _same_pad(size, k, s):
    """(left, right, top, bottom) of TF-SAME from a nominal size."""
    out = [math.ceil(n / s) for n in size]
    ph = max((out[0] - 1) * s + k - size[0], 0)
    pw = max((out[1] - 1) * s + k - size[1], 0)
    return (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)


def effnet_blocks(variant, stem_stride):
    """[(kernel, stride, expand, in, out, se, pad)], endpoint indices,
    stem pad."""
    w, d, res = EFF[variant]
    size = (res, res)
    stem_pad = _same_pad(size, 3, stem_stride)
    size = tuple(math.ceil(n / 2) for n in size)
    blocks, ends = [], []
    for seg, (r, k, s, e, ci, co, se) in enumerate(B0):
        ci, co = _round_filters(ci, w), _round_filters(co, w)
        for j in range(int(math.ceil(d * r))):
            st = s if j == 0 else 1
            blocks.append((k, st, e, ci if j == 0 else co, co, se,
                           _same_pad(size, k, st)))
            if j == 0:
                size = tuple(math.ceil(n / st) for n in size)
        if seg in ENDPOINT_SEGMENTS:
            ends.append(len(blocks))
    return blocks, ends, stem_pad


def effnet_features(x, sd, p: Prec, variant="eff-b4", stem_stride=1,
                    prefix="backbone."):
    """x [B, 3, H, W] -> five endpoints, channels-first (eval BatchNorm)."""
    blocks, ends, stem_pad = effnet_blocks(variant, stem_stride)
    x = F.pad(x, stem_pad)
    x = p.conv(x, sd[prefix + "_conv_stem.weight"], None, stem_stride)
    x = F.silu(batch_norm_eval(x, sd, prefix + "_bn0"))
    feats = []
    for i, (k, st, e, ci, co, se, pad) in enumerate(blocks):
        key = f"{prefix}_blocks.{i}."
        inp = x
        if e != 1:
            x = p.conv(x, sd[key + "_expand_conv.weight"])
            x = F.silu(batch_norm_eval(x, sd, key + "_bn0"))
        x = p.conv(F.pad(x, pad), sd[key + "_depthwise_conv.weight"], None,
                   st, 0, x.shape[1])
        x = F.silu(batch_norm_eval(x, sd, key + "_bn1"))
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(p.conv(s, sd[key + "_se_reduce.weight"],
                          sd[key + "_se_reduce.bias"]))
        s = p.conv(s, sd[key + "_se_expand.weight"], sd[key + "_se_expand.bias"])
        x = torch.sigmoid(s) * x
        x = batch_norm_eval(p.conv(x, sd[key + "_project_conv.weight"]), sd,
                            key + "_bn2")
        if st == 1 and ci == co:
            x = x + inp
        if i + 1 in ends:
            feats.append(x)
    x = p.conv(x, sd[prefix + "_conv_head.weight"])
    feats.append(F.silu(batch_norm_eval(x, sd, prefix + "_bn1")))
    return feats


# ------------------------------------------------------------------- I3D ----

MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32), ((1, 3, 3), (1, 2, 2))),
         ("Mixed_3c", (128, 128, 192, 32, 96, 64), None),
         ("Mixed_4b", (192, 96, 208, 16, 48, 64), ((3, 3, 3), (2, 2, 2))),
         ("Mixed_4c", (160, 112, 224, 24, 64, 64), None),
         ("Mixed_4d", (128, 128, 256, 24, 64, 64), None),
         ("Mixed_4e", (112, 144, 288, 32, 64, 64), None),
         ("Mixed_4f", (256, 160, 320, 32, 128, 128), None),
         ("Mixed_5b", (256, 160, 320, 32, 128, 128), ((2, 2, 2), (2, 2, 2))),
         ("Mixed_5c", (384, 192, 384, 48, 128, 128), None))
TAPS = ("Mixed_3c", "Mixed_4f", "Mixed_5c")


def _tf_same(size, kernel, stride):
    """F.pad argument of TF-SAME (odd element at the end), last dim first."""
    pads = []
    for s, k, st in zip(size, kernel, stride):
        total = max((math.ceil(s / st) - 1) * st + k - s, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def _unit3d(x, sd, key, p: Prec, train, stride=(1, 1, 1)):
    w = sd[key + ".conv3d.weight"]
    x = F.pad(x, _tf_same(x.shape[2:], w.shape[2:], stride))
    x = p.conv(x, w, None, stride)
    bn = batch_norm_batch if train else batch_norm_eval
    return F.relu(bn(x, sd, key + ".bn"))


def _max_pool_same(x, kernel, stride):
    x = F.pad(x, _tf_same(x.shape[2:], kernel, stride), value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


def i3d_features(x, sd, p: Prec, train=False, prefix="backbone."):
    """x [B, 3, T, H, W] -> five taps, channels-first (no 2a pool: the
    configuration's bb_feat_upsize)."""
    x = _unit3d(x, sd, prefix + "Conv3d_1a_7x7", p, train, (2, 2, 2))
    taps = [x]
    x = _unit3d(x, sd, prefix + "Conv3d_2b_1x1", p, train)
    x = _unit3d(x, sd, prefix + "Conv3d_2c_3x3", p, train)
    taps.append(x)
    for name, _, pool in MIXED:
        if pool is not None:
            x = _max_pool_same(x, *pool)
        k = prefix + name + "."
        b0 = _unit3d(x, sd, k + "b0", p, train)
        b1 = _unit3d(_unit3d(x, sd, k + "b1a", p, train), sd, k + "b1b", p,
                     train)
        b2 = _unit3d(_unit3d(x, sd, k + "b2a", p, train), sd, k + "b2b", p,
                     train)
        b3 = _unit3d(_max_pool_same(x, (3, 3, 3), (1, 1, 1)), sd, k + "b3b",
                     p, train)
        x = torch.cat([b0, b1, b2, b3], 1)
        if name in TAPS:
            taps.append(x)
    return taps


# ---------------------------------------------------- the fusion encoder ----

def _linear(x, sd, key, p: Prec, bias=True):
    y = p.mm(x, sd[key + ".weight"].t())
    b = sd.get(key + ".bias") if bias else None
    return y + b if b is not None else y


def _soft_pool(x, sd, key, p: Prec):
    """Learned softmax pool over the mode axis (dim 1) of [B, M, U, F]."""
    score = _linear(x, sd, key + ".feat2score", p)
    return (x * torch.softmax(score, dim=1)).sum(1)


def cross_attention(q_in, k_in, sd, key, modes, feat_dim, has_ffn, clip,
                    p: Prec):
    """One CrossAttFeatTrans (tied Q/K) of q_in [B, U1, C] over k_in
    [B, U2, C] -> [B, U1, feat_dim]."""
    b, u1, c = q_in.shape
    u2 = k_in.shape[1]
    amd = c // modes
    q = _linear(q_in, sd, key + ".query", p).reshape(b, u1, modes, amd)
    k = _linear(k_in, sd, key + ".query", p).reshape(b, u2, modes, amd)
    scores = p.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) / math.sqrt(amd)
    scores = torch.where(scores.max() > clip, scores.clamp(-clip, clip),
                         scores)
    probs = torch.softmax(scores, dim=-1)                   # [B, M, U1, U2]
    o = key + ".out_trans"
    v = _linear(k_in, sd, o + ".first_linear", p, bias=False)
    v = v.reshape(b, u2, modes, feat_dim).permute(0, 2, 1, 3)
    fused = p.mm(probs, v)                                  # [B, M, U1, F]
    if not has_ffn:
        return layer_norm(_soft_pool(fused, sd, o + ".feat_softaggr", p), sd,
                          o + ".first_norm_layer")
    mid = F.gelu(_linear(fused, sd, o + ".intermediate.shared_linear", p))
    out = p.einsum("bmuf,mfg->bmug", mid, sd[o + ".output.group_linear.weight"])
    out = out + sd[o + ".output.group_linear.bias"][None, :, None, :]
    out = layer_norm(out, sd, o + ".output.resout_norm_layer")
    return _soft_pool(out, sd, o + ".feat_softaggr", p)


def fusion_encoder(vfeat, pos, vmask, sd, dims, modes, clip, p: Prec,
                   prefix="voxel_fusion."):
    """vfeat [B, N, C0], pos [B, N, d] raw coordinates, vmask [B, N, 1]."""
    pn = pos / pos.max()
    e = _linear(pn, sd, prefix + "pos_code_layer.pos_coder.pos_fc", p)
    code = torch.stack([torch.sin(e[..., 0::2]), torch.cos(e[..., 1::2])],
                       -1).reshape(e.shape)
    code = layer_norm(code)
    for i in range(len(dims) - 1):
        x = layer_norm(vfeat, sd, f"{prefix}vfeat_norm_layers.{i}")
        x = layer_norm(x + code[..., :dims[i]]) * vmask
        key = f"{prefix}translayers.{i}"
        ators = sd[key + ".attractors"].expand(x.shape[0], -1, -1)
        ators = cross_attention(ators, x, sd, key + ".in_ator_trans", 1,
                                dims[i], False, clip, p)
        vfeat = cross_attention(x, ators, sd, key + ".ator_out_trans", modes,
                                dims[i + 1], True, clip, p)
    return vfeat


# ------------------------------------------------------------ Segtran2d ----

def segtran2d(x, sd, cfg, p: Prec = FP32):
    """x [B, H, W, 3] normalised frames -> logits [B, H, W, classes]
    (eval). cfg: the configuration file's ``model`` section."""
    b, h, w, _ = x.shape
    xc = x.permute(0, 3, 1, 2)
    grid = 8                                # in-FPN layer 3, stem stride 1
    mask = F.avg_pool2d(xc.abs(), grid, grid).sum(1) > 0      # [B, h2, w2]
    feats = effnet_features(xc, sd, p, cfg["backbone"], 1)
    g = cfg["groupnorm_groups"]
    curr = conv1x1(feats[3], sd, "in_fpn34_conv", p)
    curr = group_norm_cl(curr + resize(feats[4], curr.shape[2:]), sd,
                         "in_gn4b", g)
    h2, w2 = curr.shape[2:]
    vfeat = curr.flatten(2).transpose(1, 2)
    ij = torch.stack(torch.meshgrid(torch.arange(h2, device=x.device),
                                    torch.arange(w2, device=x.device),
                                    indexing="ij"), -1).reshape(-1, 2)
    pos = (ij.float() * torch.tensor([h // h2, w // w2], device=x.device,
                                     dtype=torch.float32))[None].expand(b, -1, -1)
    dims = cfg["translayer_dims"]
    fused = fusion_encoder(vfeat, pos, mask.reshape(b, -1, 1).float(), sd,
                           dims, cfg["num_modes"], cfg["attn_clip"], p)
    fused = fused.transpose(1, 2).reshape(b, dims[-1], h2, w2)
    curr = feats[1]
    for lv in (1, 2):
        up = conv1x1(curr, sd, f"out_fpn{lv}{lv + 1}_conv", p)
        curr = group_norm_cl(up + resize(feats[lv + 1], up.shape[2:]), sd,
                             f"out_gn{lv + 1}b", g)
    feat = conv1x1(curr, sd, "out_fpn_bridgeconv", p) \
        + resize(fused, curr.shape[2:])
    scores = conv1x1(feat, sd, "out_conv", p)
    return resize(scores, (h, w)).permute(0, 2, 3, 1)


def fundus_probs(frames, sd, cfg, p: Prec = FP32):
    """frames [B, S, S, 3] in [0, 1] (S the served size) -> probabilities
    [B, S, S, classes]: the gray blend and the dataset normalisation, the
    frame resized to the model's input, the logits resized back, sigmoid
    (one window: the frame is the window)."""
    a = cfg["gray_alpha"]
    mean = torch.tensor(cfg["pixel_mean"], device=frames.device)
    std = torch.tensor(cfg["pixel_std"], device=frames.device)
    gray = (frames * torch.tensor([0.299, 0.587, 0.114],
                                  device=frames.device)).sum(-1, keepdim=True)
    x = ((1 - a) * frames + a * gray - mean) / std
    size = frames.shape[1:3]
    xin = resize(x.permute(0, 3, 1, 2), cfg["patch_size"]).permute(0, 2, 3, 1)
    logits = segtran2d(xin, sd, cfg, p)
    logits = resize(logits.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return torch.sigmoid(logits)


# ------------------------------------------------------------ Segtran3d ----

def segtran3d(vol, sd, cfg, p: Prec = FP32, train=False):
    """vol [B, H, W, D, C] -> logits [B, H, W, D, classes]."""
    b, h, w, d, _ = vol.shape
    x = vol.permute(0, 4, 3, 1, 2)                        # [B, C, D, H, W]
    x = conv1x1(x, sd, "in_bridge_to3", p)
    pool = (4, 8, 8)                        # in-FPN layer 3, upsized I3D
    mask = (F.avg_pool3d(x.abs(), pool, pool).sum(1, keepdim=True) > 0).float()
    feats = i3d_features(x, sd, p, train)
    g = cfg["groupnorm_groups"]
    curr = conv1x1(feats[3], sd, "in_fpn34_conv", p)
    curr = group_norm_cl(curr + resize(feats[4], curr.shape[2:]), sd,
                         "in_gn4b", g)
    d1, h2, w2 = curr.shape[2:]
    d2 = d1 // cfg["depth_pool"]
    curr = resize(curr, (d2, h2, w2))
    vmask = (resize(mask, (d2, h2, w2)) >= 0.5).float()
    n = d2 * h2 * w2
    vfeat = curr.flatten(2).transpose(1, 2)
    zyx = torch.stack(torch.meshgrid(*[torch.arange(s, device=vol.device)
                                       for s in (d2, h2, w2)],
                                     indexing="ij"), -1).reshape(-1, 3)
    pos = (zyx.float() * torch.tensor([d // d2, h // h2, w // w2],
                                      dtype=torch.float32,
                                      device=vol.device))[None].expand(b, n, 3)
    dims = cfg["translayer_dims"]
    fused = fusion_encoder(vfeat, pos, vmask.reshape(b, n, 1), sd, dims,
                           cfg["num_modes"], cfg["attn_clip"], p)
    fused = fused.transpose(1, 2).reshape(b, dims[-1], d2, h2, w2)
    curr = feats[1]
    for lv in (1, 2):
        up = conv1x1(curr, sd, f"out_fpn{lv}{lv + 1}_conv3d", p)
        curr = group_norm_cl(up + resize(feats[lv + 1], up.shape[2:]), sd,
                             f"out_gn{lv + 1}b", g)
    feat = conv1x1(curr, sd, "out_fpn_bridgeconv3d", p) \
        + resize(fused, curr.shape[2:])
    dd, hh, ww = feat.shape[2:]
    feat = resize(feat, (dd * cfg["depth_pool"], hh, ww))
    scores = conv1x1(feat, sd, "out_conv3d", p)          # [B, K, D', H', W']
    scores = resize(scores.permute(0, 1, 3, 4, 2), (h, w, d))
    return scores.permute(0, 2, 3, 4, 1)
