"""The front half of an EfficientNet MBConv block in eval, fused:
1x1 expand -> BN -> swish -> k x k depthwise -> BN -> swish, plus the SE
spatial mean.

Counterpart of ``segtran_tpu/kernels/mbconv.py`` (``mbconv_front``,
``fold_bn``). The wrapper keeps the JAX signature minus ``interpret``. For
tensors on the CPU it runs the plain PyTorch version
(``mbconv_front_reference``); for CUDA tensors it launches the hand-written
kernel in ``csrc/mbconv.cu`` (built by nvcc for sm_90a at first use) or
raises. ``mbconv_front.launches`` counts the kernel's launches. The
wrapper calls the custom op ``torch.ops.segtran_tpu_torch.mbconv_front``,
which holds the device dispatch and a FLOP formula
(``_build.kernel_flops``).

Both round where the TPU kernel rounds: the expand product of x.dtype
operands summed in fp32; BN0 and swish in fp32; the halo (the TF-SAME pad
positions) zero AFTER swish, because the unfused chain pads the expanded
tensor and swish(bn0(0)) is not zero; the expanded tensor rounded to
x.dtype; the depthwise taps summed in fp32 in (ky, kx) order; BN1 and swish
in fp32; the output rounded to x.dtype; the SE mean taken over the fp32
values before that rounding (so in bf16 it differs slightly from the
unfused module's mean of the rounded tensor).

The kernel's operand types: w_exp in x.dtype, the BatchNorm affines and
w_dw in fp32. Operands that already have them and are contiguous are passed
as they are (``MBConvBlock`` caches them so); others are converted on each
call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import kernel_flops
from .squeezed_attention import _SMEM_MAX
from .squeezed_attention import _sm_count as _device_sm_count

_SRC = "mbconv"
_THREADS = 256                  # threads per block (csrc)
_NRMAX = 6                      # output columns per thread run, at most
# what one SM holds: shared memory (with 1 KB reserved per block), and
# blocks of the kernel at its register budget (__launch_bounds__(256, 2))
_SM_SMEM = 233472
_MAX_BLOCKS_PER_SM = 2
_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

Pad = Tuple[Tuple[int, int], Tuple[int, int]]
# per call the wrapper's host work is a few tens of microseconds, near the
# kernel's own time at small shapes: the plan and the SM count are cached
_sm_count = functools.lru_cache(maxsize=16)(_device_sm_count)


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_typed", False):
        lib.mbconv_front.argtypes = ([_i, _i, _i, _vp, _ll, _ll, _ll]
                                     + [_vp] * 9 + [_i] * 11 + [_vp])
        lib.mbconv_front.restype = _i
        lib.mbconv_occupancy.argtypes = [_i] * 8 + [_vp, _vp]
        lib.mbconv_occupancy.restype = _i
        lib._typed = True
    return lib


def fold_bn(scale, bias, mean, var, eps: float = 1e-3):
    """Eval-mode BatchNorm as one affine: y = x * s + b."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def _out_size(h: int, w: int, kernel: int, stride: int, pad: Pad):
    (pt, pb), (pl, pr) = pad
    return ((h + pt + pb - kernel) // stride + 1,
            (w + pl + pr - kernel) // stride + 1)


def mbconv_front_reference(x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale,
                           bn1_shift, *, kernel: int, stride: int, pad: Pad):
    """The kernel's arithmetic in plain PyTorch (see the module
    docstring). Same arguments and results as ``mbconv_front``."""
    dt = x.dtype
    (pt, pb), (pl, pr) = pad
    if w_exp is not None:
        # products of two x.dtype values are exact in fp32
        e = torch.matmul(x.float(), w_exp.to(dt).float())
        e = F.silu(e * bn0_scale.float() + bn0_shift.float()).to(dt)
    else:
        e = x
    e = F.pad(e.float(), (0, 0, pl, pr, pt, pb))
    ho, wo = _out_size(x.shape[1], x.shape[2], kernel, stride, pad)
    wf = w_dw.float()
    acc = None
    for ky in range(kernel):
        for kx in range(kernel):
            tap = e[:, ky:ky + (ho - 1) * stride + 1:stride,
                    kx:kx + (wo - 1) * stride + 1:stride] * wf[ky, kx]
            acc = tap if acc is None else acc + tap
    y = F.silu(acc * bn1_scale.float() + bn1_shift.float())
    return y.to(dt), y.sum((1, 2)) / float(ho * wo)


class MbPlan(NamedTuple):
    """Launch shape of ``mbconv_kernel`` (``csrc/mbconv.cu``): one block of
    256 threads per (chunk of ``cc`` expanded channels, segment of ``rows``
    output rows, image), grid (chunks, segments, B). A block walks
    (rows - 1) * stride + k padded input rows; ``ring`` = k + 1 expanded
    rows of ``wr`` columns stay in shared memory: k read by the taps, one
    being filled."""
    cc: int                      # expanded channels per block
    rows: int                    # output rows per segment
    nseg: int                    # segments
    grid: Tuple[int, int, int]   # (chunks, segments, B)
    kp: int                      # Cin (bf16: padded to the mma depth 16)
    mpad: int                    # input positions padded to the mma rows
    wr: int                      # ring columns (padded width)
    ring: int                    # ring slots
    nr: int                      # output columns per thread run
    smem: int                    # bytes per block
    blocks_per_sm: int
    waves: int                   # rounds of blocks on the card


def _smem(es: int, expand: bool, kp: int, mpad: int, wr: int,
          ring: int) -> int:
    """Shared memory of a block, as ``layout()`` in the source carves it:
    w_exp chunk, two staged x rows (the SE reduction after the walk), the
    ring, the BN0 affine; staged rows padded by 16 bytes, the others too in
    bf16 (for ldmatrix). The depthwise weights and BN1 stay in
    registers."""
    vec, cc = 16 // es, 128 // es
    pad = vec if es == 2 else 0
    staged = es * 2 * mpad * (kp + vec) if expand else 0
    return ((es * kp * (cc + pad) if expand else 0)
            + max(staged, 4 * _THREADS * 4)
            + es * ring * wr * (cc + pad) + 4 * 2 * cc)


@functools.lru_cache(maxsize=256)
def _mb_plan(b: int, h: int, w: int, cin: int, cexp: int, k: int,
             stride: int, pad: Pad, dtype, sms: int,
             expand: bool = True) -> MbPlan:
    """The kernel's decomposition. Chunks of 128 bytes of channels per
    position (64 in bf16, 32 in fp32); segment rows chosen to take the
    fewest rounds of (walk steps per block) on ``sms`` SMs, each holding
    the blocks its shared memory and the register budget allow; runs of
    output columns spread one output row over the threads. Raises
    ValueError naming the shape where one block's shared memory is over
    the card's."""
    es = 2 if dtype == torch.bfloat16 else 4
    vec, cc = 16 // es, 128 // es
    pl = pad[1][0]
    ho, wo = _out_size(h, w, k, stride, pad)
    # K padded to the mma depth in bf16; fp32 runs on the CUDA cores
    kp, mpad = -(-cin // 16) * 16 if es == 2 else cin, -(-w // 16) * 16
    wr = max(pl + w, (wo - 1) * stride + k)
    ring = k + 1
    smem = _smem(es, expand, kp, mpad, wr, ring)
    if smem > _SMEM_MAX:
        raise ValueError(f"mbconv_front at H={h}, W={w}, Cin={cin}, "
                         f"Cexp={cexp}, k={k}, stride={stride}, {dtype}: "
                         f"{smem} bytes of shared memory per block, over "
                         f"{_SMEM_MAX}")
    per_sm = min(_MAX_BLOCKS_PER_SM, _SM_SMEM // (smem + 1024))
    chunks = -(-cexp // cc)
    best = None
    for nseg in range(1, ho + 1):
        rows = -(-ho // nseg)
        nseg = -(-ho // rows)
        blocks = chunks * nseg * b
        waves = -(-blocks // (sms * per_sm))
        cost = (waves * ((rows - 1) * stride + k), blocks)
        if best is None or cost < best[0]:
            best = (cost, rows, nseg, waves)
    _, rows, nseg, waves = best
    # run slots: a thread owns 4 channels at k 3, 2 at k 5
    slots = _THREADS // (cc // (4 if k == 3 else 2))
    passes = -(-wo // (slots * _NRMAX))
    nr = -(-wo // (slots * passes))
    return MbPlan(cc, rows, nseg, (chunks, nseg, b), kp, mpad, wr, ring, nr,
                  smem, per_sm, waves)


def mb_occupancy(plan: MbPlan, dtype, k: int, stride: int, w: int, cin: int,
                 pl: int, wo: int, expand: bool = True) -> dict:
    """The shared-memory bytes the built kernel takes (which must equal the
    plan's) and how many of its blocks an SM holds; builds the kernel. For
    logging on the card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _lib().mbconv_occupancy(int(dtype == torch.bfloat16), k, stride,
                                 int(expand), w, cin, pl, wo,
                                 ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"mbconv_occupancy: CUDA error {rc}")
    return {"smem": smem.value, "blocks_per_sm": blocks.value,
            "plan_smem": plan.smem}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _operand(t: torch.Tensor, dtype, dev, name: str) -> torch.Tensor:
    """t in the kernel's type, contiguous and 16-byte aligned on dev; no
    copy where it already is."""
    if t.device != dev:
        raise ValueError(f"all inputs must be on {dev}, got {name} on "
                         f"{t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"mbconv_front kernel needs {name} "
                         f"{tuple(t.shape)} 16-byte aligned")
    return t


def mbconv_front(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                 bn0_scale: Optional[torch.Tensor],
                 bn0_shift: Optional[torch.Tensor], w_dw: torch.Tensor,
                 bn1_scale: torch.Tensor, bn1_shift: torch.Tensor, *,
                 kernel: int, stride: int, pad: Pad):
    """Fused expand + BN + swish + depthwise + BN + swish (+ SE mean).

    x [B, H, W, Cin] (NHWC; channels-last activations seen through a
    permuted view are taken as they are, by their strides). w_exp
    [Cin, Cexp] or None (expand_ratio 1). w_dw [k, k, Cexp]. bn*: folded
    eval-mode BatchNorm affines (``fold_bn``). pad: static TF-SAME pads
    ((top, bottom), (left, right)). Returns (dw_out [B, Ho, Wo, Cexp] in
    x.dtype, se_mean [B, Cexp] fp32)."""
    (pt, pb), (pl, pr) = pad
    return torch.ops.segtran_tpu_torch.mbconv_front(
        x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale, bn1_shift,
        int(kernel), int(stride), [int(pt), int(pb), int(pl), int(pr)])


def _launch(x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale, bn1_shift,
            kernel, stride, pad):
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mbconv_front kernel takes float32 or bfloat16, "
                         f"got {dt}")
    if kernel not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"mbconv_front kernel takes k in (3, 5) and stride "
                         f"in (1, 2), got k={kernel}, stride={stride}")
    b, h, w, cin = x.shape
    cexp = w_dw.shape[-1]
    vec = 16 // x.element_size()
    if (x.stride(3) != 1 or x.data_ptr() % 16
            or any(s % vec for s in x.stride()[:3]) or cin % vec):
        raise ValueError(f"mbconv_front kernel needs contiguous channels, "
                         f"16-byte aligned rows and Cin a multiple of {vec} "
                         f"for {dt}; got x {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if w_exp is None and cin != cexp:
        raise ValueError(f"without an expand Cin ({cin}) must equal Cexp "
                         f"({cexp})")
    if tuple(w_dw.shape) != (kernel, kernel, cexp) or (
            w_exp is not None and tuple(w_exp.shape) != (cin, cexp)):
        raise ValueError(f"w_exp {None if w_exp is None else tuple(w_exp.shape)}"
                         f" / w_dw {tuple(w_dw.shape)} do not match x "
                         f"{tuple(x.shape)} and k={kernel}")
    expand = w_exp is not None
    f32 = torch.float32
    args = ([_operand(w_exp, dt, dev, "w_exp"),
             _operand(bn0_scale, f32, dev, "bn0_scale"),
             _operand(bn0_shift, f32, dev, "bn0_shift")] if expand
            else [None] * 3)
    args += [_operand(w_dw, f32, dev, "w_dw"),
             _operand(bn1_scale, f32, dev, "bn1_scale"),
             _operand(bn1_shift, f32, dev, "bn1_shift")]
    ragged = -cexp % vec
    if ragged:
        # the kernel stores whole 16-byte vectors: zero channels take the
        # width to one (an expand only; without one Cexp == Cin)
        args = [F.pad(t, (0, ragged)).contiguous() for t in args]
    cpad = cexp + ragged
    lib = _lib()
    plan = _mb_plan(b, h, w, cin, cpad, kernel, stride, pad, dt,
                    _sm_count(dev), expand)
    ho, wo = _out_size(h, w, kernel, stride, pad)
    out = torch.empty((b, ho, wo, cpad), dtype=dt, device=dev)
    # the SE mean [B, Cexp], then the segments' sums [B, nseg, Cexp]
    buf = torch.empty(b * (plan.nseg + 1) * cpad, dtype=f32, device=dev)
    se = buf[:b * cpad].view(b, cpad)
    part = buf[b * cpad:].view(b, plan.nseg, cpad)
    (pt, _), (pl, _) = pad
    rc = lib.mbconv_front(
        int(dt == torch.bfloat16), kernel, stride, x.data_ptr(),
        *x.stride()[:3],
        *[t.data_ptr() if t is not None else None for t in args],
        out.data_ptr(), part.data_ptr(), se.data_ptr(), b, h, w, cin, cpad,
        pt, pl, ho, wo, plan.rows, plan.nr,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mbconv_front: CUDA error {rc} at launch")
    if ragged:
        return out[..., :cexp], se[:, :cexp]
    return out, se


mbconv_front.launches = 0


@torch.library.custom_op(
    "segtran_tpu_torch::mbconv_front", mutates_args=(),
    schema="(Tensor x, Tensor? w_exp, Tensor? bn0_scale, Tensor? bn0_shift, "
           "Tensor w_dw, Tensor bn1_scale, Tensor bn1_shift, int kernel, "
           "int stride, int[] pad) -> (Tensor, Tensor)")
def _mbconv_front_op(x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale,
                     bn1_shift, kernel, stride, pad):
    pad = ((pad[0], pad[1]), (pad[2], pad[3]))
    args = (x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale, bn1_shift)
    if _on_cpu(x):
        return mbconv_front_reference(*args, kernel=kernel, stride=stride,
                                      pad=pad)
    out = _launch(*args, kernel, stride, pad)
    mbconv_front.launches += 1
    return out


@_mbconv_front_op.register_fake
def _(x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale, bn1_shift, kernel,
      stride, pad):
    b, h, w, _ = x.shape
    ho, wo = _out_size(h, w, kernel, stride, ((pad[0], pad[1]),
                                              (pad[2], pad[3])))
    cexp = w_dw.shape[-1]
    return (x.new_empty((b, ho, wo, cexp)),
            x.new_empty((b, cexp), dtype=torch.float32))


@kernel_flops(torch.ops.segtran_tpu_torch.mbconv_front)
def _(x_shape, w_exp_shape, *args, out_shape=None, **kwargs):
    """The 1x1 expand and the depthwise taps, as the unfused convolutions
    count them."""
    b, h, w, cin = x_shape
    _, ho, wo, cexp = out_shape[0]
    k = args[-3]
    expand = 2 * b * h * w * cin * cexp if w_exp_shape is not None else 0
    return expand + 2 * b * ho * wo * cexp * k * k


def reset_launches() -> None:
    mbconv_front.launches = 0
