"""Flash cross-attention for the squeezed transformer, forward and backward.

Counterpart of ``segtran_tpu/kernels/squeezed_attention.py``
(``fused_cross_attention``, its forward ``_fused_forward``, and
``fused_cross_attention_trainable`` with the flash backward
``_flash_bwd_impl``):

    out = softmax(clip(q k^T * sm_scale, +-attn_clip)) @ v

streamed over the keys, so the [G, Q, N] score matrix never reaches device
memory. The clamp is applied always (the unfused modules clamp only when
the global max exceeds the clip, ``nn/attention._clamp_if_exceeds``); the
two differ only for rows whose scores all lie below -attn_clip.

The wrappers keep the JAX signatures minus ``tile_*``/``interpret``. For
tensors on the CPU they run their plain PyTorch versions (``*_plain``);
for CUDA tensors they launch the hand-written kernels in
``csrc/squeezed_attention.cu`` (built by nvcc for sm_90a at first use) or
raise. Each wrapper counts its launches in ``<wrapper>.launches``: one
forward call is one launch of the kernel pair (softmax statistics, then
the output); ``flash_backward_dkdv`` and ``flash_backward_dq`` count one
kernel each.

``fused_cross_attention_trainable`` is the autograd counterpart of the JAX
custom_vjp: at N >= ``FLASH_BWD_MIN_N`` keys its backward runs the flash
backward kernels from the saved lse; below, the recompute backward
``cross_attention_bwd_recompute`` (JAX's ``_fca_bwd_xla``, plain PyTorch
on every device), counted in ``cross_attention_bwd_recompute.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_SRC = "squeezed_attention"
_TQ, _TN = 64, 64          # the kernel's query and key tiles
_vp, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_typed", False):
        lib.flash_fwd.argtypes = [_i] + [_vp] * 7 + [_i] * 6 + [_d, _d, _vp]
        lib.flash_fwd.restype = _i
        lib.flash_bwd.argtypes = [_i, _i] + [_vp] * 10 + [_i] * 7 + [
            _d, _d, _vp]
        lib.flash_bwd.restype = _i
        lib.flash_bwd_occupancy.argtypes = [_i] * 4 + [_vp, _vp]
        lib.flash_bwd_occupancy.restype = _i
        lib._typed = True
    return lib


def fused_cross_attention_plain(q, k, v, attn_clip: float = 500.0,
                                sm_scale: Optional[float] = None):
    """The kernel's arithmetic in plain PyTorch: fp32 scores and softmax
    statistics, p = exp(s - max) rounded to v.dtype, p v summed in fp32,
    divided by the fp32 sum and rounded to v.dtype. Returns (out [G, Q, F]
    in v.dtype, lse [G, Q, 1] fp32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.clamp(-attn_clip, attn_clip)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(v.dtype), m + torch.log(l)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check_shapes(q, k, v, *others):
    """(G, Q, D, N, F) of q [G, Q, D], k [G, N, D], v [G, N, F] on one CUDA
    device in one kernel dtype; raises on what the kernels do not take."""
    g, nq, d = q.shape
    n, f = k.shape[1], v.shape[2]
    dt, dev = v.dtype, v.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {dt}")
    if tuple(k.shape) != (g, n, d) or tuple(v.shape[:2]) != (g, n):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    vec = 16 // (torch.finfo(dt).bits // 8)    # elements per 16 bytes
    if d % vec or f % vec:
        raise ValueError(f"the kernel needs D and F to be multiples of {vec} "
                         f"for {dt}, got D={d}, F={f}")
    for t in (q, k) + others:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    return g, nq, d, n, f


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _key_splits(g: int, nq: int, n: int, device) -> int:
    """Key slices of the statistics kernel: enough blocks for two per SM,
    every slice at least one key tile."""
    sms = _sm_count(device)
    q_tiles, n_tiles = -(-nq // _TQ), -(-n // _TN)
    want = max(1, min(n_tiles, -(-2 * sms // (q_tiles * g))))
    per = -(-n_tiles // want)
    return -(-n_tiles // per)


def fused_cross_attention(q, k, v, attn_clip: float = 500.0,
                          sm_scale: Optional[float] = None, *,
                          return_lse: bool = False):
    """q [G, Q, D], k [G, N, D], v [G, N, F] (G = batch * modes) -> out
    [G, Q, F] in v.dtype, and with ``return_lse`` also the fp32
    log-sum-exp [G, Q, 1] of the clipped scores. Replaces the Pallas
    fused_cross_attention."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q):
        out, lse = fused_cross_attention_plain(q, k, v, attn_clip, sm_scale)
        return (out, lse) if return_lse else out
    g, nq, d, n, f = _check_shapes(q, k, v)
    dt, dev = v.dtype, v.device
    lib = _lib()
    q_, k_, v_ = (t.to(dt).contiguous() for t in (q, k, v))
    splits = _key_splits(g, nq, n, dev)
    out = torch.empty((g, nq, f), dtype=dt, device=dev)
    lse = torch.empty((g, nq, 1), dtype=torch.float32, device=dev)
    part = torch.empty((2, g * splits * nq), dtype=torch.float32, device=dev)
    rc = lib.flash_fwd(
        int(dt == torch.bfloat16), q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
        out.data_ptr(), lse.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), g, nq, n, d, f, splits, float(sm_scale),
        float(attn_clip), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_cross_attention: CUDA error {rc} at launch")
    fused_cross_attention.launches += 1
    return (out, lse) if return_lse else out


fused_cross_attention.launches = 0

# Keys from which the backward takes the flash kernels (JAX
# ``FLASH_BWD_MIN_N``, kept equal so that both packages take the same
# path); below it the recompute backward runs.
FLASH_BWD_MIN_N = 4096


def _probs_and_dscores(q, k, v, do, lse, delta, attn_clip, sm_scale):
    """The flash backward's recompute (JAX ``_bwd_common``) in fp32:
    p = exp(clip(s) - lse) and ds = p (dO v^T - delta) [|s| < clip] scale."""
    s_raw = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    inside = (s_raw.abs() < attn_clip).float()
    p = torch.exp(s_raw.clamp(-attn_clip, attn_clip) - lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta) * inside * sm_scale


def flash_backward_dkdv_plain(q, k, v, do, lse, delta, attn_clip=500.0,
                              sm_scale=None):
    """``_dkdv_kernel``'s arithmetic at JAX's rounding points: p and ds in
    fp32, dO cast to fp32, dK = ds^T q and dV = p^T dO summed in fp32 and
    rounded to k.dtype / v.dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, attn_clip, sm_scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do.float()).to(v.dtype)
    return dk, dv


def flash_backward_dq_plain(q, k, v, do, lse, delta, attn_clip=500.0,
                            sm_scale=None):
    """``_dq_kernel``'s arithmetic: dQ = ds k in fp32, rounded to q.dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, attn_clip, sm_scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_backward_plain(q, k, v, do, lse, delta, attn_clip=500.0,
                         sm_scale=None):
    """(dq, dk, dv) of the flash backward in plain PyTorch."""
    dk, dv = flash_backward_dkdv_plain(q, k, v, do, lse, delta, attn_clip,
                                       sm_scale)
    return (flash_backward_dq_plain(q, k, v, do, lse, delta, attn_clip,
                                    sm_scale), dk, dv)


# the backward kernels' limits: a portable cluster, one CTA's shared memory
_BWD_MAX_CLUSTER = 8
_SMEM_MAX = 232448
_BWD_RING = 3          # slots of the streamed tiles' ring


class BwdPlan(NamedTuple):
    """Launch shape of the flash backward kernels (``csrc/
    squeezed_attention.cu``): CTA c of a cluster owns columns
    ``d_slices[c]`` of D and ``f_slices[c]`` of F (None: no slice)."""
    width: int                   # columns of a CTA's slice
    cluster: int                 # CTAs per cluster
    tile: int                    # rows of a query or key tile
    d_slices: Tuple
    f_slices: Tuple
    dkdv_grid: Tuple[int, int, int]
    dq_grid: Tuple[int, int, int]
    splits: int                  # dQ key splits
    split_tiles: int             # key tiles per split, the last may hold fewer
    dkdv_smem: int               # bytes per CTA
    dq_smem: int


def _bwd_plan(g: int, nq: int, n: int, d: int, f: int, dtype,
              sms: int) -> BwdPlan:
    """The kernels' decomposition: 128-column slices (256 where D or F
    exceeds 1024), one cluster of max(ceil(D/W), ceil(F/W)) CTAs per key
    tile (dK/dV) or per query tile and key split (dQ), tiles of
    16 KB / (W * itemsize) rows, and dQ key splits for about eight waves of
    clusters on `sms` SMs (so that a last, partial wave costs little).
    Raises ValueError for a shape the kernels do not take (a cluster above
    8 CTAs, or too much shared memory)."""
    es = 2 if dtype == torch.bfloat16 else 4
    width = 128 if max(d, f) <= 1024 else 256
    n_d, n_f = -(-d // width), -(-f // width)
    cluster = max(n_d, n_f)
    if cluster > _BWD_MAX_CLUSTER:
        raise ValueError(
            f"flash backward: D={d}, F={f} needs a cluster of {cluster} CTAs "
            f"of {width} columns; the kernels take at most "
            f"{_BWD_MAX_CLUSTER} (D, F <= {_BWD_MAX_CLUSTER * 256})")
    tile = 16384 // (width * es)
    pad = 16 // es
    smem = (es * (2 + 2 * _BWD_RING) * tile * (width + pad)
            + 4 * (2 * tile * (tile + 4) + 2 * _BWD_RING * tile)
            + es * 4 * tile * (tile + pad))
    if smem > _SMEM_MAX:
        raise ValueError(f"flash backward: {smem} bytes of shared memory per "
                         f"CTA at D={d}, F={f}, over {_SMEM_MAX}")
    q_tiles, n_tiles = -(-nq // tile), -(-n // tile)
    waves = max(1, sms // cluster)       # clusters the card runs at once
    want = max(1, min(n_tiles, -(-8 * waves // (q_tiles * g))))
    splits = -(-n_tiles // -(-n_tiles // want))
    per = -(-n_tiles // splits)          # as the kernel splits the keys

    def slices(width_total, count):
        return tuple((c * width, min(width_total, (c + 1) * width))
                     if c < count else None for c in range(cluster))
    return BwdPlan(width, cluster, tile, slices(d, n_d), slices(f, n_f),
                   (cluster * n_tiles, g, 1), (cluster * q_tiles, splits, g),
                   splits, per, smem, smem)


def bwd_occupancy(plan: BwdPlan, dtype) -> dict:
    """Per kernel: the shared-memory bytes the built kernel takes (which
    must equal the plan's) and cudaOccupancyMaxActiveClusters for the
    plan's cluster; builds the kernels. For logging on the card."""
    lib = _lib()
    out = {}
    for name, dkdv in (("dkdv", 1), ("dq", 0)):
        smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.flash_bwd_occupancy(int(dtype == torch.bfloat16), dkdv,
                                     plan.width, plan.cluster,
                                     ctypes.addressof(smem),
                                     ctypes.addressof(clusters))
        if rc != 0:
            raise RuntimeError(f"flash_bwd_occupancy: CUDA error {rc}")
        out[name] = dict(smem=smem.value, max_active_clusters=clusters.value)
    return out


def _launch_bwd(dkdv, q, k, v, do, lse, delta, attn_clip, sm_scale):
    g, nq, d, n, f = _check_shapes(q, k, v, do, lse, delta)
    dt, dev = v.dtype, v.device
    if tuple(do.shape) != (g, nq, f) or lse.numel() != g * nq \
            or delta.numel() != g * nq:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} do not match q "
                         f"{tuple(q.shape)} and v {tuple(v.shape)}")
    lib = _lib()
    plan = _bwd_plan(g, nq, n, d, f, dt, _sm_count(dev))
    q_, k_, v_, do_ = (t.to(dt).contiguous() for t in (q, k, v, do))
    lse_, delta_ = (t.float().contiguous() for t in (lse, delta))
    if dkdv:
        outs = (torch.empty((g, n, d), dtype=dt, device=dev),
                torch.empty((g, n, f), dtype=dt, device=dev))
        ptrs = (None, outs[0].data_ptr(), outs[1].data_ptr(), None)
    else:
        outs = (torch.empty((g, nq, d), dtype=dt, device=dev),)
        part = torch.empty((plan.splits, g, nq, d), dtype=torch.float32,
                           device=dev)
        ptrs = (outs[0].data_ptr(), None, None, part.data_ptr())
    rc = lib.flash_bwd(
        int(dt == torch.bfloat16), int(dkdv), q_.data_ptr(), k_.data_ptr(),
        v_.data_ptr(), do_.data_ptr(), lse_.data_ptr(), delta_.data_ptr(),
        *ptrs, g, nq, n, d, f, plan.width, plan.splits, float(sm_scale),
        float(attn_clip), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash backward: CUDA error {rc} at launch")
    return outs


def flash_backward_dkdv(q, k, v, do, lse, delta, attn_clip=500.0,
                        sm_scale=None):
    """(dk [G, N, D] in k.dtype, dv [G, N, F] in v.dtype) of out = flash
    attention, given dO [G, Q, F], the forward's fp32 lse [G, Q, 1] and
    delta = sum_f dO O [G, Q, 1] fp32. Replaces the Pallas _dkdv_kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q):
        return flash_backward_dkdv_plain(q, k, v, do, lse, delta, attn_clip,
                                         sm_scale)
    out = _launch_bwd(True, q, k, v, do, lse, delta, attn_clip, sm_scale)
    flash_backward_dkdv.launches += 1
    return out


def flash_backward_dq(q, k, v, do, lse, delta, attn_clip=500.0,
                      sm_scale=None):
    """dq [G, Q, D] in q.dtype; the arguments of flash_backward_dkdv.
    Replaces the Pallas _dq_kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, attn_clip,
                                       sm_scale)
    (dq,) = _launch_bwd(False, q, k, v, do, lse, delta, attn_clip, sm_scale)
    flash_backward_dq.launches += 1
    return dq


flash_backward_dkdv.launches = 0
flash_backward_dq.launches = 0


def cross_attention_bwd_recompute(q, k, v, do, attn_clip, sm_scale):
    """JAX's ``_fca_bwd_xla``: the backward below FLASH_BWD_MIN_N keys,
    recomputing softmax(clip(q k^T scale)) in fp32 (its own oracle on every
    device, as in JAX; not a kernel)."""
    s_raw = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    inside = (s_raw.abs() < attn_clip).float()
    p = torch.softmax(s_raw.clamp(-attn_clip, attn_clip), dim=-1)
    g32, v32 = do.float(), v.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * inside * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    cross_attention_bwd_recompute.launches += 1
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


cross_attention_bwd_recompute.launches = 0


class _FusedCrossAttention(torch.autograd.Function):
    """Flash forward; flash backward at N >= FLASH_BWD_MIN_N keys (saving
    out and lse), else the recompute backward (saving q, k, v only)."""

    @staticmethod
    def forward(ctx, q, k, v, attn_clip, sm_scale):
        out, lse = fused_cross_attention(q, k, v, attn_clip, sm_scale,
                                         return_lse=True)
        ctx.attn_clip, ctx.sm_scale = attn_clip, sm_scale
        ctx.flash = k.shape[1] >= FLASH_BWD_MIN_N
        if ctx.flash:
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        clip, scale = ctx.attn_clip, ctx.sm_scale
        if not ctx.flash:
            q, k, v = ctx.saved_tensors
            return cross_attention_bwd_recompute(q, k, v, do, clip,
                                                 scale) + (None, None)
        q, k, v, out, lse = ctx.saved_tensors
        # delta outside the kernels, as JAX computes it outside Pallas
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dk, dv = flash_backward_dkdv(q, k, v, do, lse, delta, clip, scale)
        dq = flash_backward_dq(q, k, v, do, lse, delta, clip, scale)
        return dq, dk, dv, None, None


def fused_cross_attention_trainable(q, k, v, attn_clip: float = 500.0,
                                    sm_scale: Optional[float] = None):
    """Differentiable fused_cross_attention (JAX
    ``fused_cross_attention_trainable``); out [G, Q, F] in v.dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedCrossAttention.apply(q, k, v, attn_clip, sm_scale)


def reset_launches() -> None:
    for fn in (fused_cross_attention, flash_backward_dkdv, flash_backward_dq,
               cross_attention_bwd_recompute):
        fn.launches = 0
