"""Fused expansion epilogue: per-mode private output linear + LayerNorm +
learned softmax mode pooling, optionally with the shared FFN mid
``gelu(P @ VW1 + b1)`` computed in the same pass.

Counterpart of ``segtran_tpu/kernels/expansion_epilogue.py``. Each function
keeps the JAX signature (minus ``tile_n``/``interpret``) and has a plain
PyTorch version beside it (``*_plain``) that repeats the kernel's
arithmetic rounding point for rounding point. The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
hand-written kernel in ``csrc/expansion_epilogue.cu`` (built by nvcc for
sm_90a at first use) or raises. Each wrapper counts its kernel launches in
its ``launches`` attribute, and calls a custom op
(``torch.ops.segtran_tpu_torch.epi_mid_pool``, ``epi_mid_pool_permode``,
``epi_private_pool``) that holds the device dispatch, a FLOP formula
(``_build.kernel_flops``) and a backward that raises ValueError: like
JAX's Pallas epilogue, the kernels have no gradient.

Per mode m (the reference's ExpandedFeatTrans tail, segtran_shared.py
:255-275 and :311-325; the private output drops its residual):

    mid_m = gelu(P_m @ VW1_m + b1)    (fused_mid_output_pool[_permode])
    z_m   = mid_m @ W2_m + b2_m
    l_m   = LayerNorm(z_m)            (eps 1e-12, fp32 stats, var >= 0)
    s_m   = l_m @ ws + bs
    out   = sum_m softmax_m(s) * l_m  (fp32)

``fused_mid_output_pool`` and ``fused_mid_output_pool_permode`` compute the
same function (JAX split the second per mode for TPU VMEM) and launch the
same cluster kernel, once per call, at the launch shape of ``_epi_plan``;
``fused_private_output_pool`` launches that kernel's private tier (mid
given, no gelu(P VW1 + b1) step), once per call, at its plan. See the CUDA
source for what bounds the kernel on an H100 and what its design does
about it.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from . import _build
from ._build import kernel_flops
from .squeezed_attention import _check_smem, _cluster_slices, _sm_count

_SRC = "expansion_epilogue"

# JAX's residency budget for W2 (+ V W1) in TPU VMEM
# (segtran_tpu/kernels/expansion_epilogue.py:46); epilogue_route keeps its
# arithmetic, so the port calls the function JAX calls at every shape
W2_VMEM_BUDGET = 9 * 1024 * 1024

_vp, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_typed", False):
        lib.epi_mid_pool.argtypes = [_i] + [_vp] * 10 + [_i] * 6 + [_d, _vp]
        lib.epi_mid_pool.restype = _i
        lib.epi_mid_pool_occupancy.argtypes = [_i] * 3 + [_vp, _vp]
        lib.epi_mid_pool_occupancy.restype = _i
        lib.epi_private_pool.argtypes = [_i] + [_vp] * 8 + [_i] * 5 + [_d, _vp]
        lib.epi_private_pool.restype = _i
        lib._typed = True
    return lib


def _pad128(n: int) -> int:
    return ((n + 127) // 128) * 128


def supports(num_modes: int, feat_dim: int, itemsize: int) -> bool:
    """JAX's private-tier gate: W2 [M, F, F] within the budget."""
    return num_modes * feat_dim * feat_dim * itemsize <= W2_VMEM_BUDGET


def supports_full(num_modes: int, num_keys: int, feat_dim: int,
                  itemsize: int) -> bool:
    """JAX's all-modes gate: W2 [M, F, F] plus V W1 [M, pad128(A), F]."""
    resident = (num_modes * feat_dim * feat_dim
                + num_modes * _pad128(num_keys) * feat_dim) * itemsize
    return resident <= W2_VMEM_BUDGET


def supports_permode(num_keys: int, feat_dim: int, itemsize: int) -> bool:
    """JAX's per-mode gate: one mode's W2 [F, F] plus [pad128(A), F]."""
    resident = (feat_dim * feat_dim + _pad128(num_keys) * feat_dim) * itemsize
    return resident <= W2_VMEM_BUDGET


# The largest private-tier W2 (M * F * F) measured on the card in bf16:
# [4, 1792, 1792] (chip_smoke.py's kernels phase; H100 80GB HBM3, 700 W):
# kernel 2.240 ms against the unfused modules' 2.85 at mid
# [8,4,1296,1792], 0.596 against 0.83 at [2,4,1296,1792] (PERF.md §6)
_BF16_PRIVATE_MEASURED = 4 * 1792 * 1792


def epilogue_route(tier: str, num_modes: int, num_keys: int, feat_dim: int,
                   dtype) -> str:
    """Which function computes an expansion epilogue: ``"all_modes"``
    (fused_mid_output_pool), ``"per_mode"``
    (fused_mid_output_pool_permode), ``"private"``
    (fused_private_output_pool) or ``"unfused"`` (the model's modules).
    ``tier`` is ``"mid"`` (the attractor-out side, from P and V W1, with
    ``num_keys`` attractors) or ``"private"`` (mid given).

    JAX's VMEM arithmetic decides (segtran_tpu/nn/attention.py:409-441):
    the all-modes tier, else the per-mode tier, else the mid through the
    modules and then the private tier where ``supports`` admits it, else
    the modules. On the H100 the all-modes and per-mode functions launch
    the same kernel, so following JAX's split costs nothing. The one
    exception is taken where the card measured the kernel faster than the
    modules JAX would run: the private tier in bf16 up to the largest W2
    measured (``_BF16_PRIVATE_MEASURED``). In fp32 the card agrees with
    JAX's refusals: the private kernel loses to the modules at F >= 896
    (3.84 against 2.62 ms at the BraTS mid [1,4,8640,1024], 15.79 against
    8.08 at [8,4,1296,1792]), and so does the full tier where JAX refuses
    it (F=1792, 256 attractors: 18.27 against 9.41 ms at P
    [8,4,1296,256]); chip_smoke.py's kernels phase times each beside the
    modules (PERF.md §6)."""
    itemsize = torch.finfo(dtype).bits // 8
    if tier == "mid":
        if supports_full(num_modes, num_keys, feat_dim, itemsize):
            return "all_modes"
        if supports_permode(num_keys, feat_dim, itemsize):
            return "per_mode"
    elif tier != "private":
        raise ValueError(f"tier must be 'mid' or 'private', got {tier!r}")
    if supports(num_modes, feat_dim, itemsize):
        return "private"
    if (dtype == torch.bfloat16
            and num_modes * feat_dim * feat_dim <= _BF16_PRIVATE_MEASURED):
        return "private"
    return "unfused"


# slots of mid_pool_kernel's streamed chunks' ring: full tier, private tier
_EPI_RING = {False: 2, True: 3}
_EPI_WIDTH = 256       # columns of a CTA's slice of F (kW in the source)


class EpiPlan(NamedTuple):
    """Launch shape of ``mid_pool_kernel`` (``csrc/expansion_epilogue.cu``):
    one cluster of ``cluster`` CTAs per (image, row tile of ``tile`` rows
    of N); CTA c owns columns ``slices[c]`` of F. ``from_mid``: the private
    tier (mid given), which keeps no mid slice in shared memory and takes a
    third ring slot in its place."""
    width: int                   # columns of a CTA's slice
    cluster: int                 # CTAs per cluster
    tile: int                    # rows of a row tile
    slices: Tuple                # (start, stop) of each CTA's columns
    grid: Tuple[int, int, int]   # (cluster * row tiles, B, 1)
    smem: int                    # bytes per CTA
    waves: int                   # rounds of clusters at one CTA per SM
    from_mid: bool               # the private tier


def _epi_plan(b: int, m: int, n: int, a: int, f: int, dtype,
              sms: int) -> EpiPlan:
    """The kernel's decomposition: W = 256 columns per CTA, C = ceil(F/W)
    CTAs per cluster, row tiles of 32 KB / (W * itemsize) rows. A = 0
    plans the private tier (mid [B, M, N, F] given; no P, no mid slice).
    Raises ValueError naming the shape where C exceeds 8 or the shared
    memory a CTA."""
    from_mid = a == 0
    what = (f"private expansion epilogue at B={b}, M={m}, N={n}, F={f}"
            if from_mid else
            f"expansion epilogue at B={b}, M={m}, N={n}, A={a}, F={f}")
    es, width, cluster, _, _, slices = _cluster_slices(what, f, f, dtype,
                                                       _EPI_WIDTH)
    tile, vec, kc = 32768 // (width * es), 16 // es, 64 if es == 2 else 32
    smem = (es * (0 if from_mid else tile * (width + vec))   # mid slice
            + es * _EPI_RING[from_mid] * (tile * (kc + vec)
                                          + kc * (width + vec))
            + 4 * (tile * (width + 4)                        # fp32 pool
                   + 25 * tile + 5 * width))  # row partials, stats, params
    _check_smem(what, smem, f, f)
    tiles = -(-n // tile)
    return EpiPlan(width, cluster, tile, slices, (cluster * tiles, b, 1), smem,
                   -(-b * tiles // max(1, sms // cluster)), from_mid)


def epi_occupancy(plan: EpiPlan, dtype) -> dict:
    """The shared-memory bytes the built kernel takes (which must equal the
    plan's) and cudaOccupancyMaxActiveClusters for the plan's cluster;
    builds the kernels. For logging on the card."""
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().epi_mid_pool_occupancy(int(dtype == torch.bfloat16),
                                       int(plan.from_mid), plan.cluster,
                                       ctypes.addressof(smem),
                                       ctypes.addressof(clusters))
    _raise_if(rc, "epi_mid_pool_occupancy")
    return dict(smem=smem.value, max_active_clusters=clusters.value)


# ---------------------------------------------------------------- plain ----

def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu computed in fp32 and rounded once to x.dtype."""
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 * 0.7071067811865476))).to(x.dtype)


def _out_ln_score(z32, b2, scale, lnb, ws, bs, dt, eps):
    """From the fp32 output-linear product: bias-add in dt, LayerNorm (fp32
    stats, normalize in dt), fp32 score. Returns (l [..., F] dt, s [...])."""
    z = z32.to(dt) + b2
    zf = z.float()
    mean = zf.mean(-1, keepdim=True)
    var = torch.clamp(zf.square().mean(-1, keepdim=True) - mean.square(),
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    l = (z - mean.to(dt)) * inv.to(dt) * scale.to(dt) + lnb.to(dt)
    s = torch.matmul(l.float(), ws.to(dt).float().reshape(-1, 1))
    return l, s[..., 0] + bs.float().reshape(())


def _pool_modes(ls: List[torch.Tensor], ss: List[torch.Tensor], dt):
    """Softmax over modes in fp32 and the weighted sum; ls: M x [B, N, F],
    ss: M x [B, N] fp32 scores."""
    s = torch.stack(ss)
    e = torch.exp(s - s.max(0).values)
    acc = sum(e[i][..., None] * ls[i].float() for i in range(len(ls)))
    return (acc / e.sum(0)[..., None]).to(dt)


def _mid_plain(probs, vw1, b1, dt):
    mid32 = torch.matmul(probs.to(dt).float(), vw1.float())
    return _gelu_erf(mid32.to(dt) + b1.to(dt))


def fused_private_output_pool_plain(mid, w2, b2, ln_scale, ln_bias, ws, bs, *,
                                    ln_eps: float = 1e-12):
    dt = mid.dtype
    z32 = torch.einsum("bmnf,mfg->bmng", mid.float(), w2.to(dt).float())
    l, s = _out_ln_score(z32, b2.to(dt)[None, :, None, :], ln_scale, ln_bias,
                         ws, bs, dt, ln_eps)
    m = mid.shape[1]
    return _pool_modes([l[:, i] for i in range(m)], [s[:, i] for i in range(m)],
                       dt)


def fused_mid_output_pool_plain(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws,
                                bs, *, ln_eps: float = 1e-12):
    mid = _mid_plain(probs, vw1, b1, vw1.dtype)
    return fused_private_output_pool_plain(mid, w2, b2, ln_scale, ln_bias, ws,
                                           bs, ln_eps=ln_eps)


def _mode_plain(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, mode,
                ln_eps):
    dt = vw1.dtype
    mid = _mid_plain(probs[:, mode], vw1[:, mode], b1, dt)
    z32 = torch.matmul(mid.float(), w2[mode].to(dt).float())
    return _out_ln_score(z32, b2[mode].to(dt), ln_scale, ln_bias, ws, bs, dt,
                         ln_eps)


def fused_mid_output_pool_permode_plain(probs, vw1, b1, w2, b2, ln_scale,
                                        ln_bias, ws, bs, *,
                                        ln_eps: float = 1e-12):
    outs = [_mode_plain(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, m,
                        ln_eps) for m in range(probs.shape[1])]
    return _pool_modes([o[0] for o in outs], [o[1] for o in outs], vw1.dtype)


# --------------------------------------------------------------- kernel ----

def _prep(dt, device, *tensors):
    """Cast to the compute dtype, make contiguous, and check the device.
    These copies may be freed once the wrapper returns, before the kernel
    runs: PyTorch's allocator reuses them only for later work on the same
    stream, which the kernel precedes."""
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, got {t.device}")
        out.append(t.to(dt).contiguous())
    return out


def _check_shapes(b, m, n, a, f, vw1, b1, w2, b2, ln_scale, ln_bias, ws,
                  bs):
    """Raise unless the operands have the shapes the kernel indexes."""
    want = {"w2": (w2, (m, f, f)), "b2": (b2, (m, f)),
            "ln_scale": (ln_scale, (f,)), "ln_bias": (ln_bias, (f,)),
            "ws": (ws, (f, 1)), "bs": (bs, (1,))}
    if vw1 is not None:
        want.update(vw1=(vw1, (b, m, a, f)), b1=(b1, (f,)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                             f"takes {shape}")


def _check_dtype(dt):
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expansion epilogue kernel takes float32 or "
                        f"bfloat16, got {dt}")


def _raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _vec(dt) -> int:
    """Elements of dt in 16 bytes, the kernel's copy unit."""
    return 16 // (torch.finfo(dt).bits // 8)


def _kernel_plan(b, m, n, a, f, dt, dev) -> EpiPlan:
    """The plan of a launch (A = 0: the private tier), after checking that
    F is a whole number of 16-byte vectors; raises ValueError naming the
    shape otherwise, or where the plan refuses it."""
    _check_dtype(dt)
    if f % _vec(dt):
        raise ValueError(f"the kernel needs F to be a multiple of "
                         f"{_vec(dt)} for {dt}, got B={b}, M={m}, N={n}, "
                         f"F={f}")
    return _epi_plan(b, m, n, a, f, dt, _sm_count(dev))


def _check_aligned(**operands):
    """The kernel stages these by 16-byte copies from their first byte."""
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"the kernel needs {name} to start at a 16-byte "
                             f"boundary, got address {t.data_ptr():#x} "
                             f"({name} {tuple(t.shape)})")


def _launch_mid_pool(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs,
                     ln_eps):
    """out [B, N, F] from mid_pool_kernel at the plan's launch shape;
    raises on what the kernel does not take. The kernel stages P, VW1 and
    W2 by 16-byte copies: a ragged A is padded with zeros here (P's extra
    columns meet VW1's extra rows, adding exact zeros), F must be a whole
    number of 16-byte vectors, and the three must start 16-byte aligned."""
    b, m, n, a = probs.shape
    f = vw1.shape[-1]
    dt, dev = vw1.dtype, vw1.device
    _check_shapes(b, m, n, a, f, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs)
    plan = _kernel_plan(b, m, n, a, f, dt, dev)
    lib = _lib()
    p, v, b1_, w2_, b2_, sc, lb, ws_ = _prep(dt, dev, probs, vw1, b1, w2, b2,
                                             ln_scale, ln_bias, ws)
    vec = _vec(dt)
    if a % vec:
        pad = vec - a % vec
        p = torch.nn.functional.pad(p, (0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        a += pad
    _check_aligned(probs=p, vw1=v, w2=w2_)
    bs_ = bs.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((b, n, f), dtype=dt, device=dev)
    rc = lib.epi_mid_pool(
        int(dt == torch.bfloat16), p.data_ptr(), v.data_ptr(), b1_.data_ptr(),
        w2_.data_ptr(), b2_.data_ptr(), sc.data_ptr(), lb.data_ptr(),
        ws_.data_ptr(), bs_.data_ptr(), out.data_ptr(), b, m, n, a, f,
        plan.tile, ln_eps, torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(rc, "mid_pool_kernel")
    return out


def fused_mid_output_pool(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs,
                          *, ln_eps: float = 1e-12):
    """probs [B, M, N, A], vw1 = V W1 [B, M, A, F], b1 [F], w2 [M, F, F],
    b2 [M, F], ln_scale/ln_bias [F], ws [F, 1], bs [1] -> [B, N, F] in
    vw1.dtype. Replaces the Pallas fused_mid_output_pool."""
    return torch.ops.segtran_tpu_torch.epi_mid_pool(
        probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, float(ln_eps))


def fused_mid_output_pool_permode(probs, vw1, b1, w2, b2, ln_scale, ln_bias,
                                  ws, bs, *, ln_eps: float = 1e-12):
    """The large-F tier, same signature and result as
    fused_mid_output_pool; on the H100 the same kernel launch. Replaces the
    Pallas fused_mid_output_pool_permode."""
    return torch.ops.segtran_tpu_torch.epi_mid_pool_permode(
        probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, float(ln_eps))


def fused_private_output_pool(mid, w2, b2, ln_scale, ln_bias, ws, bs, *,
                              ln_eps: float = 1e-12):
    """mid [B, M, N, F] -> pooled [B, N, F] in mid.dtype. Replaces the Pallas
    fused_private_output_pool. On CUDA: one launch of mid_pool_kernel's
    private tier, which stages mid and W2 by 16-byte copies: F must be a
    whole number of 16-byte vectors and at most 2048 (8 CTAs of 256
    columns), and mid and W2 must start 16-byte aligned; ValueError
    otherwise."""
    return torch.ops.segtran_tpu_torch.epi_private_pool(
        mid, w2, b2, ln_scale, ln_bias, ws, bs, float(ln_eps))


def _launch_private_pool(mid, w2, b2, ln_scale, ln_bias, ws, bs, ln_eps):
    b, m, n, f = mid.shape
    dt, dev = mid.dtype, mid.device
    _check_shapes(b, m, n, 0, f, None, None, w2, b2, ln_scale, ln_bias, ws,
                  bs)
    lib = _lib()
    plan = _kernel_plan(b, m, n, 0, f, dt, dev)
    mid_, w2_, b2_, sc, lb, ws_ = _prep(dt, dev, mid, w2, b2, ln_scale,
                                        ln_bias, ws)
    _check_aligned(mid=mid_, w2=w2_)
    bs_ = bs.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((b, n, f), dtype=dt, device=dev)
    rc = lib.epi_private_pool(
        int(dt == torch.bfloat16), mid_.data_ptr(), w2_.data_ptr(),
        b2_.data_ptr(), sc.data_ptr(), lb.data_ptr(), ws_.data_ptr(),
        bs_.data_ptr(), out.data_ptr(), b, m, n, f, plan.tile, ln_eps,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(rc, "mid_pool_kernel (private tier)")
    return out


for _fn in (fused_mid_output_pool, fused_mid_output_pool_permode,
            fused_private_output_pool):
    _fn.launches = 0

_MID_ARGS = ("(Tensor probs, Tensor vw1, Tensor b1, Tensor w2, Tensor b2, "
             "Tensor ln_scale, Tensor ln_bias, Tensor ws, Tensor bs, "
             "float ln_eps) -> Tensor")


@torch.library.custom_op("segtran_tpu_torch::epi_mid_pool", mutates_args=(),
                         schema=_MID_ARGS)
def _epi_mid_pool_op(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs,
                     ln_eps):
    if _on_cpu(probs):
        return fused_mid_output_pool_plain(probs, vw1, b1, w2, b2, ln_scale,
                                           ln_bias, ws, bs, ln_eps=ln_eps)
    out = _launch_mid_pool(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs,
                           ln_eps)
    fused_mid_output_pool.launches += 1
    return out


@torch.library.custom_op("segtran_tpu_torch::epi_mid_pool_permode",
                         mutates_args=(), schema=_MID_ARGS)
def _epi_mid_pool_permode_op(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws,
                             bs, ln_eps):
    if _on_cpu(probs):
        return fused_mid_output_pool_permode_plain(
            probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, ln_eps=ln_eps)
    out = _launch_mid_pool(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs,
                           ln_eps)
    fused_mid_output_pool_permode.launches += 1
    return out


@torch.library.custom_op(
    "segtran_tpu_torch::epi_private_pool", mutates_args=(),
    schema="(Tensor mid, Tensor w2, Tensor b2, Tensor ln_scale, "
           "Tensor ln_bias, Tensor ws, Tensor bs, float ln_eps) -> Tensor")
def _epi_private_pool_op(mid, w2, b2, ln_scale, ln_bias, ws, bs, ln_eps):
    if _on_cpu(mid):
        return fused_private_output_pool_plain(mid, w2, b2, ln_scale, ln_bias,
                                               ws, bs, ln_eps=ln_eps)
    out = _launch_private_pool(mid, w2, b2, ln_scale, ln_bias, ws, bs, ln_eps)
    fused_private_output_pool.launches += 1
    return out


@_epi_mid_pool_op.register_fake
def _(probs, vw1, *args):
    b, _, n, _ = probs.shape
    return vw1.new_empty((b, n, vw1.shape[-1]))


_epi_mid_pool_permode_op.register_fake(_)


@_epi_private_pool_op.register_fake
def _(mid, *args):
    b, _, n, f = mid.shape
    return mid.new_empty((b, n, f))


def _no_backward(ctx, grad):
    raise ValueError(
        "the fused expansion epilogue (--fusedepi) has no backward, as the "
        "JAX package's Pallas epilogue has none (jax.grad through it fails "
        "to linearize): take gradients through this model without "
        "--fusedepi")


for _op in (_epi_mid_pool_op, _epi_mid_pool_permode_op, _epi_private_pool_op):
    _op.register_autograd(_no_backward)


@kernel_flops([torch.ops.segtran_tpu_torch.epi_mid_pool,
               torch.ops.segtran_tpu_torch.epi_mid_pool_permode])
def _(probs_shape, vw1_shape, *args, **kwargs):
    """P VW1, the output linear and the mode score, as the unfused modules'
    products count them."""
    b, m, n, a = probs_shape
    f = vw1_shape[-1]
    return 2 * b * m * n * f * (a + f + 1)


@kernel_flops(torch.ops.segtran_tpu_torch.epi_private_pool)
def _(mid_shape, *args, **kwargs):
    """The output linear and the mode score."""
    b, m, n, f = mid_shape
    return 2 * b * m * n * f * (f + 1)


def reset_launches() -> None:
    for fn in (fused_mid_output_pool, fused_mid_output_pool_permode,
               fused_private_output_pool):
        fn.launches = 0
