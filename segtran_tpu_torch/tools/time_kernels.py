"""Time a kernel of a checkout of this repository at the chip check's
shapes (bf16), to compare two commits on one card.

    python3 -m segtran_tpu_torch.tools.time_kernels --kernel flash|epilogue \
        [--root DIR]

DIR is the root of a checkout (default: this one). Its kernel module is
imported and built, and each case timed with CUDA events on the inputs
chip_smoke makes for it (taken from this checkout's ``chip_smoke.py``):

- ``flash``: ``fused_cross_attention`` at ``chip_smoke.FLASH_CASES`` and
  ``FLASH_FUNDUS_CASES``;
- ``epilogue``: ``chip_smoke.EPILOGUE_CASES``, the full-fusion cases
  (``fused_mid_output_pool_permode`` at F=1792, ``fused_mid_output_pool``
  at F=896 and 448; B=8, M=4, N=1296, A=256) and the private tier's
  (``fused_private_output_pool`` at every mid shape of its paths), the
  whole call, whatever launches it makes.

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
MODULES = {"flash": "squeezed_attention", "epilogue": "expansion_epilogue"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(MODULES), required=True)
    ap.add_argument("--root", default=str(HERE),
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--iters", type=int, default=10)
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
    calls = (_flash_calls if args.kernel == "flash" else _epilogue_calls)(
        cs, mod)
    times = {label: cs.cuda_ms(torch, call, iters=args.iters)
             for label, call in calls}
    print(json.dumps({"card": cs.card_line(torch), "root": str(root),
                      "kernel": args.kernel, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
