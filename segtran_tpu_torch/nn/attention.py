"""The Squeeze-and-Expansion transformer core (eval path).

Counterpart of ``segtran_tpu/nn/attention.py``; reference
segtran_shared.py:200-325 (MM mid/output pieces, LearnedSoftAggregate),
:329-476 (ExpandedFeatTrans), :478-610 (CrossAttFeatTrans), :787-816
(SqueezedAttFeatTrans); segtran_ablation.py:182-253 (MultiHeadFeatTrans,
``ablate_multihead``). Numerics follow the JAX modules, including their
exact reassociations, so bf16 rounds at the same places:

* scores scaled by 1/sqrt(in_feat_dim / num_modes) and clamped to
  +-attn_clip only when the GLOBAL max of the whole score tensor (the whole
  batch, padding images included) exceeds the clip;
* exact (erf) gelu, LayerNorm eps 1e-12;
* MMPrivateOutput drops its residual (the reference quirk) unless
  ``fix_private_output_residual``;
* V channel m*F+f belongs to mode m; tied Q/K ("shared") is one parameter
  set applied twice.

With ``use_fused_attention`` a cross-attention goes through the CUDA flash
kernels (``kernels/squeezed_attention.py``), which always clamp, where JAX's
gate lets it: no position biases, no kept scores, no ``ablate_multihead``,
and eval or no attention dropout (then through the differentiable
``fused_cross_attention_trainable``). Position biases are added after the
clamp, ``scores + pos_code_weight * pos_biases``; ``keep_attn_scores`` keeps
those scores on the module (``attention_scores``) for the caller.

Parameters are stored fp32 in torch layouts (Linear ``weight [out, in]``;
the private group linear ``weight [M, F_in, F_out]``) and cast to the
compute dtype at use. Dropout sits at the JAX package's sites (after the
mid gelu, before the private output's LayerNorm, on the attention probs)
and draws from an explicit generator (``Dropout``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import expansion_epilogue as epi
from ..kernels.squeezed_attention import (fused_cross_attention,
                                          fused_cross_attention_trainable)
from ..ops.norm import LayerNorm


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _clamp_if_exceeds(scores: torch.Tensor, clip: float) -> torch.Tensor:
    """Clamp to [-clip, clip] only when the global max exceeds clip
    (reference segtran_shared.py:575-580); no host sync."""
    return torch.where(scores.max() > clip, scores.clamp(-clip, clip), scores)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training keep each value with probability
    1 - p and scale it by 1 / (1 - p); the identity in eval or at p = 0.
    Draws from ``generator`` (a ``torch.Generator`` on the input's device,
    set with ``set_dropout_generator``), else torch's default one."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Give every module of ``model`` that draws random masks (Dropout, the
    EfficientNet blocks' drop-connect: a ``generator`` attribute) the
    generator it draws from."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """flax nn.Dense math: cast input and params to dtype, product, then the
    bias added in dtype."""
    y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return y + lin.bias.to(dtype) if lin.bias is not None else y


@dataclasses.dataclass(frozen=True)
class TransLayerSpec:
    """Per-layer hyperparameters of one attention + expansion block."""
    in_feat_dim: int
    feat_dim: int
    num_modes: int = 4
    qk_have_bias: bool = True
    v_has_bias: bool = False
    tie_qk_scheme: str = "shared"          # shared | loose | none
    attn_clip: float = 500.0
    has_FFN: bool = True
    mid_type: str = "shared"               # shared | private | none
    trans_output_type: str = "private"     # shared | private
    pool_modes_feat: str = "softmax"       # softmax | max | mean | none
    pos_code_weight: float = 1.0           # on pos_biases ('bias' codes)
    ablate_multihead: bool = False
    fix_private_output_residual: bool = False
    reassociate: bool = True
    attention_probs_dropout_prob: float = 0.1
    hidden_dropout_prob: float = 0.1
    use_fused_attention: bool = False
    use_fused_epilogue: bool = False
    keep_attn_diag: bool = False
    ln_eps: float = 1e-12
    dtype: Any = torch.float32

    @property
    def attention_mode_dim(self) -> int:
        return self.in_feat_dim // self.num_modes

    @property
    def att_size_allmode(self) -> int:
        return self.num_modes * self.attention_mode_dim


class LearnedSoftAggregate(nn.Module):
    """Learned softmax pooling over a group axis
    (reference segtran_shared.py:311-325)."""

    def __init__(self, num_feat: int, group_dim: int, dtype=torch.float32):
        super().__init__()
        self.feat2score = nn.Linear(num_feat, 1)
        self.group_dim, self.dtype = group_dim, dtype

    def forward(self, x):
        scores = dense(x, self.feat2score, self.dtype)
        probs = torch.softmax(scores, dim=self.group_dim)
        return torch.sum(x * probs, dim=self.group_dim)


class _SharedLinear(nn.Linear):
    """The shared Dense of MMSharedMid / ExpandedFeatTrans with the
    reassociation stages of the JAX module: ``full`` (plain Dense),
    ``grouped`` (per-mode premul of probs-contracted features),
    ``premul`` (x W, no bias), ``post`` (x + b: finish a premul after the
    flash kernel contracted probs into it) and ``probs``
    (probs @ (x W) + b)."""

    def __init__(self, in_features: int, features: int, use_bias: bool,
                 dtype=torch.float32):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    def forward(self, x, probs=None, stage: str = "full"):
        dt = self.dtype
        if stage == "full" and probs is None:
            return dense(x, self, dt)
        if stage == "post":
            return x + self.bias.to(dt) if self.bias is not None else x
        w = self.weight.to(dt).t()                          # [C, F']
        if stage == "grouped":
            # x: [B, M, U1, C]; channel m*F+f is (mode m, feature f)
            assert self.bias is None, "grouped premul needs v_has_bias=False"
            m = x.shape[1]
            ker = w.reshape(w.shape[0], m, w.shape[1] // m)
            return torch.einsum("bmqc,cmf->bmqf", x.to(dt), ker)
        xw = torch.matmul(x.to(dt), w)
        if stage == "premul":
            return xw
        y = torch.matmul(probs, xw)
        return y + self.bias.to(dt) if self.bias is not None else y


class MMPrivateLinear(nn.Module):
    """Per-mode private linear: weight [M, F, F] (in, out), bias [M, F]
    (reference grouped 1x1 Conv1d, segtran_shared.py:200-218)."""

    def __init__(self, num_modes: int, feat_dim: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_modes, feat_dim, feat_dim))
        self.bias = nn.Parameter(torch.zeros(num_modes, feat_dim))
        self.dtype = dtype

    def forward(self, x):                        # [B, M, U, F]
        dt = self.dtype
        y = torch.einsum("bmuf,mfg->bmug", x.to(dt), self.weight.to(dt))
        return y + self.bias.to(dt)[None, :, None, :]


class MMSharedMid(nn.Module):
    """Shared FFN middle: Linear(F->F) + gelu + dropout
    (segtran_shared.py:220-251); ``probs`` pushes the attention contraction
    through the linear."""

    def __init__(self, feat_dim: int, dtype=torch.float32,
                 hidden_dropout_prob: float = 0.0):
        super().__init__()
        self.shared_linear = _SharedLinear(feat_dim, feat_dim, True, dtype)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, x, probs=None, stage: str = "full"):
        y = self.shared_linear(x, probs=probs, stage=stage)
        return y if stage == "premul" else self.dropout(_gelu_exact(y))


class MMPrivateMid(nn.Module):
    """Private (per-mode) FFN middle + dropout (segtran_shared.py:200-218)."""

    def __init__(self, num_modes: int, feat_dim: int, dtype=torch.float32,
                 hidden_dropout_prob: float = 0.0):
        super().__init__()
        self.group_linear = MMPrivateLinear(num_modes, feat_dim, dtype)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, x):
        return self.dropout(_gelu_exact(self.group_linear(x)))


class MMSharedOutput(nn.Module):
    """Shared FFN output: Linear + residual + dropout + LayerNorm
    (segtran_shared.py:279-308)."""

    def __init__(self, feat_dim: int, ln_eps: float, dtype=torch.float32,
                 hidden_dropout_prob: float = 0.0):
        super().__init__()
        self.shared_linear = nn.Linear(feat_dim, feat_dim)
        self.resout_norm_layer = LayerNorm(feat_dim, ln_eps, dtype=dtype)
        self.dropout = Dropout(hidden_dropout_prob)
        self.dtype = dtype

    def forward(self, x, shortcut):
        y = dense(x, self.shared_linear, self.dtype) + shortcut
        return self.resout_norm_layer(self.dropout(y))


class MMPrivateOutput(nn.Module):
    """Private FFN output (segtran_shared.py:255-275): the reference
    computes ``x + shortcut`` but normalizes ``x`` -- the residual is
    dropped unless ``fix_residual``."""

    def __init__(self, num_modes: int, feat_dim: int, fix_residual: bool,
                 ln_eps: float, dtype=torch.float32,
                 hidden_dropout_prob: float = 0.0):
        super().__init__()
        self.group_linear = MMPrivateLinear(num_modes, feat_dim, dtype)
        self.resout_norm_layer = LayerNorm(feat_dim, ln_eps, dtype=dtype)
        self.fix_residual = fix_residual
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, x, shortcut):
        y = self.group_linear(x)
        if self.fix_residual:
            y = y + shortcut
        return self.resout_norm_layer(self.dropout(y))


def _ffn_blocks(spec: TransLayerSpec, num_modes: int):
    """(intermediate, output) of ``spec.mid_type`` / ``trans_output_type``
    with ``num_modes`` modes; intermediate None for ``mid_type='none'``."""
    s, m = spec, num_modes
    if s.mid_type == "shared":
        mid = MMSharedMid(s.feat_dim, s.dtype, s.hidden_dropout_prob)
    elif s.mid_type == "private":
        mid = MMPrivateMid(m, s.feat_dim, s.dtype, s.hidden_dropout_prob)
    else:
        mid = None
    if s.trans_output_type == "shared":
        out = MMSharedOutput(s.feat_dim, s.ln_eps, s.dtype,
                             s.hidden_dropout_prob)
    else:
        out = MMPrivateOutput(m, s.feat_dim, s.fix_private_output_residual,
                              s.ln_eps, s.dtype, s.hidden_dropout_prob)
    return mid, out


class ExpandedFeatTrans(nn.Module):
    """The expansion block: multi-mode V projection, attention-fused values,
    FFN, mode pooling (segtran_shared.py:329-476)."""

    def __init__(self, spec: TransLayerSpec):
        super().__init__()
        s = self.spec = spec
        self.first_linear = _SharedLinear(s.in_feat_dim,
                                          s.feat_dim * s.num_modes,
                                          s.v_has_bias, s.dtype)
        if not s.has_FFN:
            self.first_norm_layer = LayerNorm(s.feat_dim, s.ln_eps,
                                              dtype=s.dtype)
        if s.pool_modes_feat == "softmax":
            self.feat_softaggr = LearnedSoftAggregate(s.feat_dim, 1,
                                                      dtype=s.dtype)
        if s.has_FFN:
            self.intermediate, self.output = _ffn_blocks(s, s.num_modes)

    def compute_v(self, input_feat):
        """[B, U2, in] -> [B, M, U2, F]; channel m*F+f is (mode m, f)."""
        s = self.spec
        b, u2, _ = input_feat.shape
        v = self.first_linear(input_feat)
        return v.reshape(b, u2, s.num_modes, s.feat_dim).permute(0, 2, 1, 3)

    def supports_mid_premul(self) -> bool:
        """Whether V W1 may stand in for V as the flash kernel's operand
        (gelu((P V) W1 + b1) == gelu(P (V W1) + b1))."""
        s = self.spec
        return (s.reassociate and not s.v_has_bias and s.has_FFN
                and s.mid_type == "shared" and s.trans_output_type == "private"
                and not s.fix_private_output_residual)

    def apply_mid_premul(self, in_key):
        """[B, U2, C] -> V W1 [B, M, U2, F] (no bias)."""
        return self.intermediate(self.compute_v(in_key), stage="premul")

    def finish_from_mid_premul(self, mid_pre):
        """After the kernel: mid = gelu(mid_pre + b1), then the private
        output (residual dropped) and the mode pool."""
        return self._output_and_pool(
            self.intermediate(mid_pre, stage="post"), None)

    def _epilogue_args(self):
        o = self.output
        agg = self.feat_softaggr.feat2score
        return (o.group_linear.weight, o.group_linear.bias,
                o.resout_norm_layer.weight, o.resout_norm_layer.bias,
                agg.weight.t(), agg.bias)

    def _epilogue_route(self, tier: str, num_keys: int = 0) -> str:
        """``epi.epilogue_route`` where the fused epilogue may run (eval,
        ``use_fused_epilogue``, FFN, private output with its residual
        dropped, softmax pool), else ``"unfused"``."""
        s = self.spec
        if not (s.use_fused_epilogue and not self.training and s.has_FFN
                and s.trans_output_type == "private"
                and not s.fix_private_output_residual
                and s.pool_modes_feat == "softmax"):
            return "unfused"
        return epi.epilogue_route(tier, s.num_modes, num_keys, s.feat_dim,
                                  s.dtype)

    def _output_and_pool(self, mid, shortcut):
        if self._epilogue_route("private") == "private":
            return epi.fused_private_output_pool(
                mid, *self._epilogue_args(), ln_eps=self.spec.ln_eps)
        return self._pool_modes(self.output(mid, shortcut))

    def forward(self, input_feat, attention_probs=None, fused=None):
        """input_feat [B, U2, in]; attention_probs [B, M, U1, U2], or the
        flash kernel's ``fused`` = P V [B, M, U1, F] -> [B, U1, F]."""
        s = self.spec
        if fused is not None:
            return self._ffn_and_pool(fused)
        u1, u2 = attention_probs.shape[2], attention_probs.shape[3]
        if s.reassociate and not s.v_has_bias and u2 > u1:
            # squeeze-in side: P (X Wv) == (P X) Wv
            px = torch.matmul(attention_probs, input_feat.to(s.dtype)[:, None])
            fused = self.first_linear(px, stage="grouped")
        elif u2 < u1 and self.supports_mid_premul():
            # attractor-out side: gelu((P V) W1 + b1) == gelu(P (V W1) + b1)
            v = self.compute_v(input_feat)
            route = self._epilogue_route("mid", u2)
            if route in ("all_modes", "per_mode"):
                fn = (epi.fused_mid_output_pool if route == "all_modes"
                      else epi.fused_mid_output_pool_permode)
                vw1 = self.intermediate(v, stage="premul")
                return fn(attention_probs, vw1,
                          self.intermediate.shared_linear.bias,
                          *self._epilogue_args(), ln_eps=s.ln_eps)
            mid = self.intermediate(v, probs=attention_probs)
            return self._output_and_pool(mid, None)
        else:
            fused = torch.matmul(attention_probs, self.compute_v(input_feat))
        return self._ffn_and_pool(fused)

    def _ffn_and_pool(self, fused):
        s = self.spec
        if not s.has_FFN:
            # aggregate-only path (segtran_shared.py:452-457)
            return self.first_norm_layer(self.feat_softaggr(fused))
        mid = (self.intermediate(fused) if self.intermediate is not None
               else _gelu_exact(fused))
        return self._output_and_pool(mid, fused)

    def _pool_modes(self, last):
        s = self.spec
        if s.pool_modes_feat == "softmax":
            return self.feat_softaggr(last)
        if s.pool_modes_feat == "max":
            return last.max(dim=1).values
        if s.pool_modes_feat == "mean":
            return last.mean(dim=1)
        return last


class _QKDense(nn.Linear):
    """Q/K projection; the score folds read its raw weight and bias."""

    def forward(self, x, dtype):
        return dense(x, self, dtype)


class MultiHeadFeatTrans(nn.Module):
    """Ablation: standard multi-head attention output in place of the
    expansion block (reference segtran_ablation.py:182-253): V projected to
    feat_dim (with a bias) split over num_modes heads of feat_dim // M,
    fused per head, heads concatenated in (head, dim) order, then one-mode
    mid and output blocks of ``mid_type`` / ``trans_output_type`` (the
    private output drops its residual, as MMPrivateOutput does)."""

    def __init__(self, spec: TransLayerSpec):
        super().__init__()
        s = self.spec = spec
        self.head_dim = s.feat_dim // s.num_modes
        self.first_linear = nn.Linear(s.in_feat_dim,
                                      self.head_dim * s.num_modes)
        self.intermediate, self.output = _ffn_blocks(s, 1)

    def forward(self, input_feat, attention_probs):
        s = self.spec
        b, u2, _ = input_feat.shape
        m = s.num_modes
        v = dense(input_feat, self.first_linear, s.dtype)
        v = v.reshape(b, u2, m, self.head_dim).permute(0, 2, 1, 3)
        fused = torch.matmul(attention_probs, v)             # [B,M,U1,hd]
        u1 = fused.shape[2]
        fused = fused.permute(0, 2, 1, 3).reshape(b, 1, u1, s.feat_dim)
        mid = (self.intermediate(fused) if self.intermediate is not None
               else _gelu_exact(fused))
        return self.output(mid, fused)[:, 0]


class CrossAttFeatTrans(nn.Module):
    """Multi-mode QK cross-attention feeding an ExpandedFeatTrans, or a
    MultiHeadFeatTrans with ``ablate_multihead`` (segtran_shared.py:478-610);
    the non-fused path with the q/k folds. ``keep_attn_scores`` keeps each
    call's clamped, biased scores in ``attention_scores``; the spec's
    ``keep_attn_diag`` keeps the non-fused path's [max, positive mean,
    clamped] of the unclamped scores in ``attn_diag`` (None after a flash
    call, which keeps nothing, as in JAX)."""

    def __init__(self, spec: TransLayerSpec, keep_attn_scores: bool = False):
        super().__init__()
        s = self.spec = spec
        self.keep_attn_scores = keep_attn_scores
        self.attention_scores = None
        self.attn_diag = None
        self.query = _QKDense(s.in_feat_dim, s.att_size_allmode,
                              bias=s.qk_have_bias)
        if s.tie_qk_scheme != "shared":
            self.key = _QKDense(s.in_feat_dim, s.att_size_allmode,
                                bias=s.qk_have_bias)
        self.out_trans = (MultiHeadFeatTrans(s) if s.ablate_multihead
                          else ExpandedFeatTrans(s))
        self.attn_dropout = Dropout(s.attention_probs_dropout_prob)

    def _key(self) -> _QKDense:
        # tied Q/K: one parameter set applied twice (segtran_shared.py:528-531)
        return self.query if self.spec.tie_qk_scheme == "shared" else self.key

    def forward(self, in_query, in_key=None, pos_biases=None):
        s = self.spec
        dt = s.dtype
        in_key = in_query if in_key is None else in_key
        b, u1, c_q = in_query.shape
        u2, c_k = in_key.shape[1], in_key.shape[2]
        m, amd = s.num_modes, s.attention_mode_dim
        query, key = self.query, self._key()
        self.attn_diag = None

        def proj_q():
            return query(in_query, dt).reshape(b, u1, m, amd).permute(0, 2, 1, 3)

        def proj_k():
            return key(in_key, dt).reshape(b, u2, m, amd).permute(0, 2, 1, 3)

        # JAX's gate (nn/attention.py:597-600)
        if (s.use_fused_attention and pos_biases is None
                and not self.keep_attn_scores and not s.ablate_multihead
                and (not self.training
                     or s.attention_probs_dropout_prob == 0)):
            return self._flash(proj_q(), proj_k(), in_key)

        # exact QK reassociation through the small side (nn/attention.py
        # :641-669 of the JAX package); scores stay in the compute dtype
        q_fold = s.reassociate and u2 * c_q * (amd + u1) < amd * u1 * (c_q + u2)
        k_fold = s.reassociate and u1 * c_k * (amd + u2) < amd * u2 * (c_k + u1)
        if q_fold:
            k = proj_k()                                        # [B,M,U2,amd]
            wq = query.weight.to(dt).t().reshape(c_q, m, amd)
            wfold = torch.einsum("cmd,bmad->bmca", wq, k)
            scores = torch.einsum("bqc,bmca->bmqa", in_query.to(dt), wfold)
            if s.qk_have_bias:
                bq = query.bias.to(dt).reshape(m, amd)
                scores = scores + torch.einsum("md,bmad->bma", bq,
                                               k)[:, :, None, :]
        elif k_fold:
            q = proj_q()                                        # [B,M,U1,amd]
            wk = key.weight.to(dt).t().reshape(c_k, m, amd)
            qfold = torch.einsum("bmqd,cmd->bmqc", q, wk)
            scores = torch.einsum("bmqc,bkc->bmqk", qfold, in_key.to(dt))
            if s.qk_have_bias:
                bk = key.bias.to(dt).reshape(m, amd)
                scores = scores + torch.einsum("bmqd,md->bmq", q, bk)[..., None]
        else:
            scores = torch.matmul(proj_q(), proj_k().transpose(-1, -2))
        scores = scores / math.sqrt(amd)
        if s.keep_attn_diag:
            # the stats behind the reference's every-500-calls print
            # (segtran_shared.py:569-587)
            sg = scores.detach().float()
            cur_max = sg.max()
            cur_avg = sg.sum() / (sg > 0).sum().clamp(min=1)
            self.attn_diag = torch.stack(
                [cur_max, cur_avg, (cur_max > s.attn_clip).float()])
        scores = _clamp_if_exceeds(scores, s.attn_clip)
        if pos_biases is not None:
            scores = scores + s.pos_code_weight * pos_biases.to(dt)
        if self.keep_attn_scores:
            self.attention_scores = scores
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        return self.out_trans(in_key, self.attn_dropout(probs))

    def _flash(self, q, k, in_key):
        """The fused branch (nn/attention.py:597-624 of the JAX package):
        the kernel contracts softmax(q k^T) with V, or with V W1 on the
        attractor-out side, whose mid then finishes after the kernel. In
        training, and in any forward that autograd records (an eval
        gradient such as the receptive-field probe; JAX always takes its
        custom_vjp), the differentiable wrapper runs."""
        s = self.spec
        attend = (fused_cross_attention_trainable
                  if self.training or torch.is_grad_enabled()
                  else fused_cross_attention)
        out_trans = self.out_trans
        b, m, u1, amd = q.shape
        u2, f = k.shape[2], s.feat_dim
        qg, kg = q.reshape(b * m, u1, amd), k.reshape(b * m, u2, amd)
        if u2 < u1 and out_trans.supports_mid_premul():
            vw = out_trans.apply_mid_premul(in_key)          # [B,M,U2,F]
            mid_pre = attend(qg, kg, vw.reshape(b * m, u2, f), s.attn_clip)
            return out_trans.finish_from_mid_premul(
                mid_pre.reshape(b, m, u1, f).to(s.dtype))
        v = out_trans.compute_v(in_key)                      # [B,M,U2,F]
        fused = attend(qg, kg, v.reshape(b * m, u2, f), s.attn_clip)
        return out_trans(in_key, fused=fused.reshape(b, m, u1, f).to(s.dtype))


class SqueezedAttFeatTrans(nn.Module):
    """N tokens <-> A learnable attractors, two cross-attentions, O(N*A)
    (segtran_shared.py:787-816)."""

    def __init__(self, spec: TransLayerSpec, num_attractors: int = 256,
                 has_FFN_in_squeeze: bool = False,
                 keep_attn_scores: bool = False):
        super().__init__()
        self.spec = spec
        # in-squeeze: single mode, no channel compression
        in_spec = dataclasses.replace(spec, feat_dim=spec.in_feat_dim,
                                      num_modes=1, has_FFN=has_FFN_in_squeeze)
        self.attractors = nn.Parameter(
            torch.empty(1, num_attractors, spec.in_feat_dim))
        self.in_ator_trans = CrossAttFeatTrans(in_spec, keep_attn_scores)
        self.ator_out_trans = CrossAttFeatTrans(spec, keep_attn_scores)

    def forward(self, in_feat, pos_biases=None):
        b = in_feat.shape[0]
        attractors = self.attractors.to(self.spec.dtype).expand(
            b, -1, -1)
        new_attractors = self.in_ator_trans(attractors, in_feat, pos_biases)
        return self.ator_out_trans(in_feat, new_attractors, pos_biases)
