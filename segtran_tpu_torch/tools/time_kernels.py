"""Time a kernel of a checkout of this repository at the chip check's
shapes (bf16), to compare two commits on one card.

    python3 -m segtran_tpu_torch.tools.time_kernels \
        --kernel flash|epilogue|mbconv [--root DIR] [--all-blocks] \
        [--backbone]

DIR is the root of a checkout (default: this one). Its kernel module is
imported and built, and each case timed with CUDA events on the inputs
chip_smoke makes for it (taken from this checkout's ``chip_smoke.py``):

- ``flash``: ``fused_cross_attention`` at ``chip_smoke.FLASH_CASES`` and
  ``FLASH_FUNDUS_CASES``;
- ``epilogue``: ``chip_smoke.EPILOGUE_CASES``, the full-fusion cases
  (``fused_mid_output_pool_permode`` at F=1792, ``fused_mid_output_pool``
  at F=896 and 448; B=8, M=4, N=1296, A=256) and the private tier's
  (``fused_private_output_pool`` at every mid shape of its paths), the
  whole call, whatever launches it makes;
- ``mbconv``: ``mbconv_front`` at ``chip_smoke.MBCONV_CASES`` (batch 8,
  operands as the model passes them); ``--all-blocks`` adds each distinct
  block shape of the eff-b4 288^2 backbone (stem stride 1) beside cuDNN's
  unfused chain of the same block (``chip_smoke.mbconv_unfused``);
  ``--backbone`` profiles one fused and one unfused eff-b4 288^2 backbone
  forward at batch 8 and 32 (device busy, device operations,
  ``mbconv_front`` launches) and times each.

Prints one JSON line: the card, DIR, the kernel and the ms of each case.
Run it once per checkout, in turns (A, B, B, A), inside one command to
compare two commits on one card. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
MODULES = {"flash": "squeezed_attention", "epilogue": "expansion_epilogue",
           "mbconv": "mbconv"}


def _flash_calls(cs, sa):
    """(label, call) per flash case; the inputs stay on the card."""
    for i, (label, g, nq, n, d, f, qk) in enumerate(cs.FLASH_CASES
                                                    + cs.FLASH_FUNDUS_CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = ((torch.randn(*shape, generator=gen, device="cuda") * s).to(
            torch.bfloat16) for shape, s in (((g, nq, d), qk), ((g, n, d), qk),
                                             ((g, n, f), 1.0)))
        yield label, lambda: sa.fused_cross_attention(q, k, v)


def _epilogue_calls(cs, epi):
    for seed, (name, kind, b, m, n, a, f) in enumerate(cs.EPILOGUE_CASES):
        fn = getattr(epi, name)
        inputs = cs.epilogue_inputs(torch, kind, b, m, n, a, f,
                                    torch.bfloat16, seed=seed)
        label = (f"{name} F={f}" if kind == "mid"
                 else f"{name} [{b},{m},{n},{f}]")
        yield label, lambda: fn(*inputs)


def _mbconv_blocks():
    """(label, block index, H) of each distinct block shape of eff-b4 at
    288^2, stem stride 1."""
    from segtran_tpu_torch.nn.backbones.efficientnet import build_block_specs
    out, seen, h = [], set(), 288
    for i, spec in enumerate(build_block_specs("eff-b4", 1)[0]):
        key = (h, spec.kernel, spec.stride, spec.in_filters,
               spec.expand_ratio)
        if key not in seen:
            seen.add(key)
            out.append((f"H{h} k{spec.kernel} s{spec.stride} "
                        f"{spec.in_filters}->"
                        f"{spec.in_filters * spec.expand_ratio}", i, h))
        h = -(-h // spec.stride)
    return out


def _mbconv_calls(cs, mb, all_blocks):
    """(label, call) per case; with all_blocks also each block shape's
    cuDNN chain, labelled 'cudnn ...'."""
    import torch.nn.functional as F
    from segtran_tpu_torch.nn.backbones.efficientnet import build_block_specs
    specs = build_block_specs("eff-b4", 1)[0]
    cases = [(label, bi, h, False) for label, bi, h in cs.MBCONV_CASES]
    if all_blocks:
        cases += [(label, bi, h, True) for label, bi, h in _mbconv_blocks()]
    for i, (label, bi, h, chain) in enumerate(cases):
        spec = specs[bi]
        args = cs.mbconv_inputs(torch, spec, h, torch.bfloat16, seed=100 + i)
        kw = dict(kernel=spec.kernel, stride=spec.stride, pad=spec.pad)
        yield label, lambda: mb.mbconv_front(*args, **kw)
        if chain:
            yield f"cudnn {label}", lambda: cs.mbconv_unfused(torch, F, args,
                                                              spec)


def _backbone(cs, mb):
    """Fused and unfused eff-b4 288^2 backbone forwards (bf16, TF32 off):
    ms per forward, and one profiled forward each."""
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for fused in (True, False):
        bb = cs.seeded_backbone(torch, fused)
        for b in (8, 32):
            x = torch.randn(b, 288, 288, 3, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(b))
            name = f"{'fused' if fused else 'unfused'} B={b}"
            with torch.inference_mode():
                mb.reset_launches()
                prof = cs.profile_forward(
                    torch, lambda: (bb(x), torch.cuda.synchronize()),
                    f"eff-b4 288^2 backbone {name}",
                    {"mbconv_front": ("mbconv", "se_mean_kernel")})
                launches = mb.mbconv_front.launches
                ms = cs.cuda_ms(torch, lambda: bb(x), iters=5)
            out[name] = dict(ms=ms, mbconv_front_launches=launches, **prof)
        del bb
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(MODULES), required=True)
    ap.add_argument("--root", default=str(HERE),
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--all-blocks", action="store_true",
                    help="mbconv: also every eff-b4 288^2 block shape, "
                         "beside cuDNN's chain")
    ap.add_argument("--backbone", action="store_true",
                    help="mbconv: also profile and time the fused and "
                         "unfused backbone forwards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA GPU")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    root = Path(args.root).resolve()
    for name in [m for m in sys.modules if m.split(".")[0] ==
                 "segtran_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    mod = importlib.import_module(
        f"segtran_tpu_torch.kernels.{MODULES[args.kernel]}")
    if not Path(mod.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {mod.__file__}, not the kernel of {root}")
    if args.kernel == "mbconv":
        calls = _mbconv_calls(cs, mod, args.all_blocks)
    else:
        calls = (_flash_calls if args.kernel == "flash"
                 else _epilogue_calls)(cs, mod)
    times = {label: cs.cuda_ms(torch, call, iters=args.iters)
             for label, call in calls}
    result = {"card": cs.card_line(torch), "root": str(root),
              "kernel": args.kernel, "ms": times}
    if args.kernel == "mbconv" and args.backbone:
        result["backbone"] = _backbone(cs, mod)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
