"""Time the flash forward of a checkout of this repository at the chip
check's flash shapes (bf16), to compare two commits on one card.

    python3 -m segtran_tpu_torch.tools.time_flash_fwd [--root DIR]

DIR is the root of a checkout (default: this one). Its
``segtran_tpu_torch.kernels.squeezed_attention`` is imported and built,
and its ``fused_cross_attention`` timed with CUDA events at
``chip_smoke.FLASH_CASES`` and ``FLASH_FUNDUS_CASES`` (taken from this
checkout's ``chip_smoke.py``), on the inputs chip_smoke makes for them.
Prints one JSON line: the card, DIR and the ms of each case. Run it once
per checkout, in turns (A, B, B, A), inside one command to compare two
commits on one card. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_fwd needs a CUDA GPU")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    root = Path(args.root).resolve()
    for name in [m for m in sys.modules if m.split(".")[0] ==
                 "segtran_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    sa = importlib.import_module("segtran_tpu_torch.kernels.squeezed_attention")
    if not Path(sa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {sa.__file__}, not the kernel of {root}")
    times = {}
    for i, (label, g, nq, n, d, f, qk) in enumerate(cs.FLASH_CASES
                                                    + cs.FLASH_FUNDUS_CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = ((torch.randn(*shape, generator=gen, device="cuda") * s).to(
            torch.bfloat16) for shape, s in (((g, nq, d), qk), ((g, n, d), qk),
                                             ((g, n, f), 1.0)))
        times[label] = cs.cuda_ms(torch, lambda: sa.fused_cross_attention(
            q, k, v), iters=args.iters)
        del q, k, v
    print(json.dumps({"card": cs.card_line(torch), "root": str(root),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
