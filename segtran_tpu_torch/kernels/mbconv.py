"""The front half of an EfficientNet MBConv block in eval, fused:
1x1 expand -> BN -> swish -> k x k depthwise -> BN -> swish, plus the SE
spatial mean.

Counterpart of ``segtran_tpu/kernels/mbconv.py`` (``mbconv_front``,
``fold_bn``). The wrapper keeps the JAX signature minus ``interpret``. For
tensors on the CPU it runs the plain PyTorch version
(``mbconv_front_reference``); for CUDA tensors it launches the hand-written
kernel in ``csrc/mbconv.cu`` (built by nvcc for sm_90a at first use) or
raises. ``mbconv_front.launches`` counts the kernel's launches.

Both round where the TPU kernel rounds: the expand product of x.dtype
operands summed in fp32; BN0 and swish in fp32; the halo (the TF-SAME pad
positions) zero AFTER swish, because the unfused chain pads the expanded
tensor and swish(bn0(0)) is not zero; the expanded tensor rounded to
x.dtype; the depthwise taps summed in fp32 in (ky, kx) order; BN1 and swish
in fp32; the output rounded to x.dtype; the SE mean taken over the fp32
values before that rounding (so in bf16 it differs slightly from the
unfused module's mean of the rounded tensor).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_SRC = "mbconv"
_CT = 32                        # expanded channels per block (csrc)
# shared memory per block: 100 KB lets two blocks share an SM; a tile whose
# one output row needs more takes what one block may have (227 KB, less the
# kernel's 1 KB static SE buffer)
_SMEM_BUDGETS = (100 * 1024, 227 * 1024 - 1024)
_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def _lib():
    lib = _build.load(_SRC)
    if not getattr(lib, "_typed", False):
        lib.mbconv_front.argtypes = ([_i, _i, _vp, _ll, _ll, _ll] + [_vp] * 8
                                     + [_i] * 11 + [_vp])
        lib.mbconv_front.restype = _i
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


def _pick_tile_h(ho: int, wo: int, cin: int, kernel: int, stride: int,
                 itemsize: int, has_expand: bool) -> int:
    """Output rows per block: the most, up to 8, whose shared-memory tile
    (the expanded band plus the expand weights) fits the first budget that
    holds one row."""
    wc = (wo - 1) * stride + kernel
    for budget in _SMEM_BUDGETS:
        for th in range(min(8, ho), 0, -1):
            tin = (th - 1) * stride + kernel
            smem = (tin * wc * _CT * itemsize
                    + (cin * _CT * 4 if has_expand else 0))
            if smem <= budget:
                return th
    raise ValueError(f"mbconv_front: a one-row tile of width {wc} does not "
                     f"fit {_SMEM_BUDGETS[-1]} bytes of shared memory")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


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
    if _on_cpu(x):
        return mbconv_front_reference(
            x, w_exp, bn0_scale, bn0_shift, w_dw, bn1_scale, bn1_shift,
            kernel=kernel, stride=stride, pad=pad)
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mbconv_front kernel takes float32 or bfloat16, "
                        f"got {dt}")
    if kernel not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"mbconv_front kernel takes k in (3, 5) and stride "
                         f"in (1, 2), got k={kernel}, stride={stride}")
    b, h, w, cin = x.shape
    cexp = w_dw.shape[-1]
    vec = 16 // x.element_size()
    if (x.stride(3) != 1 or x.data_ptr() % 16
            or any(s % vec for s in x.stride()[:3])
            or (w_exp is not None and cin % vec)):
        raise ValueError(f"mbconv_front kernel needs contiguous channels, "
                         f"16-byte aligned rows and Cin a multiple of {vec} "
                         f"for {dt}; got strides {x.stride()}, Cin {cin}")
    if w_exp is None and cin != cexp:
        raise ValueError(f"without an expand Cin ({cin}) must equal Cexp "
                         f"({cexp})")
    if tuple(w_dw.shape) != (kernel, kernel, cexp) or (
            w_exp is not None and tuple(w_exp.shape) != (cin, cexp)):
        raise ValueError(f"w_exp {None if w_exp is None else tuple(w_exp.shape)}"
                         f" / w_dw {tuple(w_dw.shape)} do not match x "
                         f"{tuple(x.shape)} and k={kernel}")
    ho, wo = _out_size(h, w, kernel, stride, pad)
    th = _pick_tile_h(ho, wo, cin, kernel, stride, x.element_size(),
                      w_exp is not None)
    n_t = -(-ho // th)

    def f32(t):
        return t.float().contiguous()
    args = [f32(w_exp.to(dt)) if w_exp is not None else None,
            f32(bn0_scale) if w_exp is not None else None,
            f32(bn0_shift) if w_exp is not None else None,
            f32(w_dw), f32(bn1_scale), f32(bn1_shift)]
    for t in args:
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    out = torch.empty((b, ho, wo, cexp), dtype=dt, device=dev)
    part = torch.empty((b, n_t, cexp), dtype=torch.float32, device=dev)
    (pt, _), (pl, _) = pad
    rc = _lib().mbconv_front(
        int(dt == torch.bfloat16), kernel, x.data_ptr(), *x.stride()[:3],
        *[t.data_ptr() if t is not None else None for t in args],
        out.data_ptr(), part.data_ptr(), b, h, w, cin, cexp, stride, pt, pl,
        ho, wo, th, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mbconv_front: CUDA error {rc} at launch")
    mbconv_front.launches += 1
    return out, part.sum(1) / float(ho * wo)


mbconv_front.launches = 0


def reset_launches() -> None:
    mbconv_front.launches = 0
