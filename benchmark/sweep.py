"""The sweep that finds the serving cell's knee: the cell run at each
offered rate in turn, in one process, printing per rate the completion
rate, the latency percentiles and whether the backlog grew (the median
latency of the window's last third against its first third).

    python3 -m benchmark.sweep --workload fundus-serve \\
        --rates 60,100,140,180 --seconds 15 --seed 7

The knee is the highest rate whose completions keep up with its
arrivals without a growing backlog; the cell's file holds 0.8 of it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from . import harness as H


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    H.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    wl, cfg = H.cell_spec(args.workload)
    driver = H.load_module(H.find("drivers", wl["driver"], ".py"),
                           wl["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        w = copy.deepcopy(wl)
        w["traffic"]["rate_rps"] = rate
        ctx = H.Context(cell=args.workload, workload=w, config=cfg,
                        seed=args.seed, seconds=args.seconds, trace=False,
                        t_process=time.time(), spans=H.Spans(False),
                        tracer=H.Tracer(False), device=torch.device("cuda"),
                        log=lambda m: print(m, file=sys.stderr, flush=True))
        out = driver.run(ctx)
        c = out.counters
        print(json.dumps({
            "rate_rps": rate, "completed_rps": c["completed_rps"],
            "serve_p95_ms": out.end_to_end["serve_p95_ms"],
            "p50_first_third_ms": c["p50_first_third_ms"],
            "p50_last_third_ms": c["p50_last_third_ms"],
            "occupancy": c["requests"] / max(c["batches"], 1),
            "failed": out.failed}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
