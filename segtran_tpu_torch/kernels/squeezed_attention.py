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
forward call is one launch (the cluster kernel, and the merge of its key
splits where there is more than one); ``flash_backward_dkdv`` and
``flash_backward_dq`` count one kernel each. Each wrapper calls a custom
op (``torch.ops.segtran_tpu_torch.flash_fwd``, ``flash_bwd_dkdv``,
``flash_bwd_dq``) that holds the device dispatch and a FLOP formula
(``_build.kernel_flops``).

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
from ._build import kernel_flops

_SRC = "squeezed_attention"
_vp, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_typed", False):
        lib.flash_fwd.argtypes = [_i] + [_vp] * 7 + [_i] * 7 + [_d, _d, _vp]
        lib.flash_fwd.restype = _i
        lib.flash_fwd_occupancy.argtypes = [_i] * 3 + [_vp, _vp]
        lib.flash_fwd_occupancy.restype = _i
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


# the cluster kernels' limits: a portable cluster, one CTA's shared memory
_MAX_CLUSTER = 8
_SMEM_MAX = 232448
_RING = 3              # slots of the backward's streamed tiles' ring


def _cluster_slices(what: str, d: int, f: int, dtype, width=None):
    """The column slices of the cluster kernels (forward and backward):
    W = 128 columns per CTA (256 where D or F exceeds 1024, unless
    `width` names one), C = max(ceil(D/W), ceil(F/W)) CTAs per cluster,
    tiles of 16 KB / (W * itemsize) rows. Returns (element size, W, C,
    tile, d_slices, f_slices), CTA c owning columns d_slices[c] of D and
    f_slices[c] of F (None: no slice). Raises ValueError naming the shape
    where C exceeds 8."""
    es = 2 if dtype == torch.bfloat16 else 4
    if width is None:
        width = 128 if max(d, f) <= 1024 else 256
    n_d, n_f = -(-d // width), -(-f // width)
    cluster = max(n_d, n_f)
    if cluster > _MAX_CLUSTER:
        raise ValueError(
            f"{what}: D={d}, F={f} needs a cluster of {cluster} CTAs "
            f"of {width} columns; the kernels take at most "
            f"{_MAX_CLUSTER} (D, F <= {_MAX_CLUSTER * 256})")

    def slices(total, count):
        return tuple((c * width, min(total, (c + 1) * width))
                     if c < count else None for c in range(cluster))
    return (es, width, cluster, 16384 // (width * es), slices(d, n_d),
            slices(f, n_f))


def _key_splits(n_tiles: int, clusters: int, cluster: int, sms: int):
    """(splits, tiles per split) of `n_tiles` key tiles for about eight
    waves of `clusters` clusters per split on `sms` SMs (so that a last,
    partial wave costs little); every split holds at least one tile."""
    waves = max(1, sms // cluster)       # clusters the card runs at once
    want = max(1, min(n_tiles, -(-8 * waves // clusters)))
    splits = -(-n_tiles // -(-n_tiles // want))
    return splits, -(-n_tiles // splits)  # as the kernels split the keys


def _check_smem(what: str, smem: int, d: int, f: int) -> None:
    if smem > _SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory per CTA at "
                         f"D={d}, F={f}, over {_SMEM_MAX}")


class FwdPlan(NamedTuple):
    """Launch shape of the flash forward (``fwd_kernel`` in ``csrc/
    squeezed_attention.cu``): CTA c of a cluster owns columns
    ``f_slices[c]`` of F (None: no slice); the partial scores of D slice
    ``d_slices[j]`` come from CTA j, over all keys of a cell, or with
    ``halves`` 2 from CTAs j and j + nD, one key half each."""
    width: int                   # columns of a CTA's slice
    cluster: int                 # CTAs per cluster
    tile: int                    # rows of a query tile
    key_tile: int                # keys of a key tile (2 * tile)
    d_slices: Tuple
    f_slices: Tuple
    halves: int                  # key halves of a cell's partial scores
    grid: Tuple[int, int, int]   # (cluster * query tiles, splits, G)
    splits: int                  # key splits
    split_tiles: int             # key tiles per split, the last may hold fewer
    smem: int                    # bytes per CTA
    acc_scratch: int             # fp32 elements of the splits' outputs
    stats_scratch: int           # fp32 elements of their (m, l)


def _fwd_plan(g: int, nq: int, n: int, d: int, f: int, dtype, sms: int,
              width: Optional[int] = None) -> FwdPlan:
    """The forward's decomposition: one cluster per (G, query tile, key
    split), cells of a query tile by a key tile of twice its rows, key
    splits for about eight waves of clusters, and fp32 scratch for the
    splits' partial outputs and (m, l) where there is more than one.
    `width` overrides the slice width (for measuring). Raises ValueError
    for a shape the kernel does not take."""
    what = "flash forward"
    es, width, cluster, tile, d_sl, f_sl = _cluster_slices(what, d, f, dtype,
                                                           width)
    pad, keys = 16 // es, 2 * tile
    smem = (es * (tile + 3 * keys) * (width + pad)   # q, one k and two v
            + 4 * (2 * tile * (keys + 8) + 5 * tile)  # scores, statistics
            + es * 2 * tile * (keys + pad))          # two p buffers
    _check_smem(what, smem, d, f)
    q_tiles, n_tiles = -(-nq // tile), -(-n // keys)
    splits, per = _key_splits(n_tiles, q_tiles * g, cluster, sms)
    merged = splits > 1
    n_d = -(-d // width)
    return FwdPlan(width, cluster, tile, keys, d_sl, f_sl,
                   2 if 2 * n_d <= cluster else 1,
                   (cluster * q_tiles, splits, g), splits, per, smem,
                   splits * g * nq * f if merged else 0,
                   2 * splits * g * nq if merged else 0)


def fwd_occupancy(plan: FwdPlan, dtype) -> dict:
    """The shared-memory bytes the built forward kernel takes (which must
    equal the plan's) and cudaOccupancyMaxActiveClusters for the plan's
    cluster; builds the kernels. For logging on the card."""
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().flash_fwd_occupancy(int(dtype == torch.bfloat16), plan.width,
                                    plan.cluster, ctypes.addressof(smem),
                                    ctypes.addressof(clusters))
    if rc != 0:
        raise RuntimeError(f"flash_fwd_occupancy: CUDA error {rc}")
    return dict(smem=smem.value, max_active_clusters=clusters.value)


def _launch_fwd(q, k, v, attn_clip, sm_scale, width=None):
    """(out, lse) from the forward kernel at the plan's width, or at
    `width` (for measuring); raises on what the kernel does not take."""
    g, nq, d, n, f = _check_shapes(q, k, v)
    dt, dev = v.dtype, v.device
    lib = _lib()
    plan = _fwd_plan(g, nq, n, d, f, dt, _sm_count(dev), width)
    q_, k_, v_ = (t.to(dt).contiguous() for t in (q, k, v))
    out = torch.empty((g, nq, f), dtype=dt, device=dev)
    lse = torch.empty((g, nq, 1), dtype=torch.float32, device=dev)
    part = torch.empty((plan.acc_scratch + plan.stats_scratch,),
                       dtype=torch.float32, device=dev)
    acc_ptr = part.data_ptr() if plan.acc_scratch else None
    stats_ptr = part[plan.acc_scratch:].data_ptr() if plan.acc_scratch \
        else None
    rc = lib.flash_fwd(
        int(dt == torch.bfloat16), q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
        out.data_ptr(), lse.data_ptr(), acc_ptr, stats_ptr, g, nq, n, d, f,
        plan.width, plan.splits, float(sm_scale), float(attn_clip),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_cross_attention: CUDA error {rc} at launch")
    return out, lse


def fused_cross_attention(q, k, v, attn_clip: float = 500.0,
                          sm_scale: Optional[float] = None, *,
                          return_lse: bool = False):
    """q [G, Q, D], k [G, N, D], v [G, N, F] (G = batch * modes) -> out
    [G, Q, F] in v.dtype, and with ``return_lse`` also the fp32
    log-sum-exp [G, Q, 1] of the clipped scores. Replaces the Pallas
    fused_cross_attention."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = torch.ops.segtran_tpu_torch.flash_fwd(q, k, v, float(attn_clip),
                                                     float(sm_scale))
    return (out, lse) if return_lse else out


fused_cross_attention.launches = 0


@torch.library.custom_op(
    "segtran_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float attn_clip, float sm_scale)"
           " -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, attn_clip, sm_scale):
    if _on_cpu(q):
        return fused_cross_attention_plain(q, k, v, attn_clip, sm_scale)
    out, lse = _launch_fwd(q, k, v, attn_clip, sm_scale)
    fused_cross_attention.launches += 1
    return out, lse


@_flash_fwd_op.register_fake
def _(q, k, v, attn_clip, sm_scale):
    g, nq = q.shape[:2]
    return (v.new_empty((g, nq, v.shape[2])),
            q.new_empty((g, nq, 1), dtype=torch.float32))


@kernel_flops(torch.ops.segtran_tpu_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, *args, **kwargs):
    """q k^T and p v: what the unfused chain's two products count."""
    g, nq, d = q_shape
    return 2 * g * nq * k_shape[1] * (d + v_shape[2])

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
    what = "flash backward"
    es, width, cluster, tile, d_sl, f_sl = _cluster_slices(what, d, f, dtype)
    pad = 16 // es
    smem = (es * (2 + 2 * _RING) * tile * (width + pad)
            + 4 * (2 * tile * (tile + 4) + 2 * _RING * tile)
            + es * 4 * tile * (tile + pad))
    _check_smem(what, smem, d, f)
    q_tiles, n_tiles = -(-nq // tile), -(-n // tile)
    splits, per = _key_splits(n_tiles, q_tiles * g, cluster, sms)
    return BwdPlan(width, cluster, tile, d_sl, f_sl,
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
    dk, dv = torch.ops.segtran_tpu_torch.flash_bwd_dkdv(
        q, k, v, do, lse, delta, float(attn_clip), float(sm_scale))
    return dk, dv


def flash_backward_dq(q, k, v, do, lse, delta, attn_clip=500.0,
                      sm_scale=None):
    """dq [G, Q, D] in q.dtype; the arguments of flash_backward_dkdv.
    Replaces the Pallas _dq_kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.ops.segtran_tpu_torch.flash_bwd_dq(
        q, k, v, do, lse, delta, float(attn_clip), float(sm_scale))


flash_backward_dkdv.launches = 0
flash_backward_dq.launches = 0

_BWD_ARGS = ("(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
             "Tensor delta, float attn_clip, float sm_scale)")


@torch.library.custom_op("segtran_tpu_torch::flash_bwd_dkdv", mutates_args=(),
                         schema=_BWD_ARGS + " -> (Tensor, Tensor)")
def _flash_bwd_dkdv_op(q, k, v, do, lse, delta, attn_clip, sm_scale):
    if _on_cpu(q):
        return flash_backward_dkdv_plain(q, k, v, do, lse, delta, attn_clip,
                                         sm_scale)
    dk, dv = _launch_bwd(True, q, k, v, do, lse, delta, attn_clip, sm_scale)
    flash_backward_dkdv.launches += 1
    return dk, dv


@torch.library.custom_op("segtran_tpu_torch::flash_bwd_dq", mutates_args=(),
                         schema=_BWD_ARGS + " -> Tensor")
def _flash_bwd_dq_op(q, k, v, do, lse, delta, attn_clip, sm_scale):
    if _on_cpu(q):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, attn_clip,
                                       sm_scale)
    (dq,) = _launch_bwd(False, q, k, v, do, lse, delta, attn_clip, sm_scale)
    flash_backward_dq.launches += 1
    return dq


@_flash_bwd_dkdv_op.register_fake
def _(q, k, v, do, lse, delta, attn_clip, sm_scale):
    return torch.empty_like(k), torch.empty_like(v)


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, attn_clip, sm_scale):
    return torch.empty_like(q)


@kernel_flops(torch.ops.segtran_tpu_torch.flash_bwd_dkdv)
def _(q_shape, k_shape, v_shape, *args, **kwargs):
    """s = q k^T and dp = dO v^T recomputed, dv = p^T dO, dk = ds^T q."""
    g, nq, d = q_shape
    return 4 * g * nq * k_shape[1] * (d + v_shape[2])


@kernel_flops(torch.ops.segtran_tpu_torch.flash_bwd_dq)
def _(q_shape, k_shape, v_shape, *args, **kwargs):
    """s = q k^T and dp = dO v^T recomputed, dq = ds k."""
    g, nq, d = q_shape
    return 2 * g * nq * k_shape[1] * (2 * d + v_shape[2])


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
