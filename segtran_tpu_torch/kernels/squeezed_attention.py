"""Flash cross-attention forward for the squeezed transformer.

Counterpart of ``segtran_tpu/kernels/squeezed_attention.py``
(``fused_cross_attention``, its forward ``_fused_forward``):

    out = softmax(clip(q k^T * sm_scale, +-attn_clip)) @ v

streamed over the keys, so the [G, Q, N] score matrix never reaches device
memory. The clamp is applied always (the unfused modules clamp only when
the global max exceeds the clip, ``nn/attention._clamp_if_exceeds``); the
two differ only for rows whose scores all lie below -attn_clip.

The wrapper keeps the JAX signature minus ``tile_*``/``interpret``. For
tensors on the CPU it runs the plain PyTorch version
``fused_cross_attention_plain``; for CUDA tensors it launches the
hand-written kernel in ``csrc/squeezed_attention.cu`` (built by nvcc for
sm_90a at first use) or raises. One call is one launch of the kernel pair
(softmax statistics, then the output), counted in
``fused_cross_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

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


def _key_splits(g: int, nq: int, n: int, device) -> int:
    """Key slices of the statistics kernel: enough blocks for two per SM,
    every slice at least one key tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
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
    for t in (q, k):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
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


def reset_launches() -> None:
    fused_cross_attention.launches = 0
