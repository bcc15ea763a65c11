"""The readings that the limits of the correctness checks are set from,
for many seeds in one process (the benchmark's own runs never call it):

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 \\
        [--seconds 4] [--program] [--control fp8] [--faults half_batch]

``--program`` runs the cell as a run does (a short window) and prints
its readings against the reference; ``--control`` prints those of the
reference put in the program's place in the lower precision (for the
configurations' bfloat16: float8 e4m3, one scale per tensor);
``--faults`` runs the program with each planted fault in turn. One JSON
line per seed and kind, on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness as H

T_PROCESS = H.process_start_time()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", default=None)
    p.add_argument("--faults", default="")
    p.add_argument("--fp32-program", action="store_true",
                   help="the program without --bf16 (a witness path)")
    args = p.parse_args(argv)
    H.set_cache_dirs()
    import torch
    from benchmark.reference import nets
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    wl, cfg = H.cell_spec(args.workload)
    if args.fp32_program:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for key in ("serve_argv", "eval_argv"):
            if key in cfg:
                cfg[key] = [a for a in cfg[key] if a != "--bf16"]
        if "train" in cfg:
            cfg["train"]["argv"] = [a for a in cfg["train"]["argv"]
                                    if a != "--bf16"]
    driver = H.load_module(H.find("drivers", wl["driver"], ".py"),
                           wl["driver"])

    def ctx(seed, faults=()):
        return H.Context(cell=args.workload, workload=wl, config=cfg,
                         seed=seed, seconds=args.seconds, trace=False,
                         t_process=time.time(), spans=H.Spans(False),
                         tracer=H.Tracer(False),
                         device=torch.device("cuda"), faults=faults,
                         log=lambda m: print(m, file=sys.stderr, flush=True))

    def emit(kind, seed, readings, **extra):
        print(json.dumps(dict(kind=kind, seed=seed, readings=readings,
                              **extra)), flush=True)
        torch.cuda.empty_cache()

    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            out = driver.run(ctx(seed))
            emit("program", seed, out.counters.get("readings"),
                 end_to_end=out.end_to_end, failed=out.failed)
        if args.control:
            emit(f"control_{args.control}", seed,
                 driver.control(ctx(seed), nets.Prec(args.control)))
        for fault in filter(None, args.faults.split(",")):
            out = driver.run(ctx(seed, (fault,)))
            emit(f"fault_{fault}", seed, out.counters.get("readings"))
    found = H.forbidden_loaded(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
