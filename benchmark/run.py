"""One benchmark run of one cell of segtran_tpu_torch on the GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell (``workloads/<cell>.json``) and its configuration
(``configs/<config>.json``), hands both to the cell's traffic driver
(``drivers/<driver>.py``), which sets up, warms every shape it will use,
measures for ``--seconds`` and then checks what the timed path produced
against the plain reference. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``metrics/<metric>.py``) read from the spans, counters and a profiled
slice of the window. The last line of standard output is one JSON
object; the numbers compared with the reference, each beside its limit,
are the last lines of standard error and the result's last key. Without
a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result; it exits 3 and prints none if JAX or the JAX package
is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys

if __package__ in (None, ""):
    sys.exit("run as a module from the checkout's root: "
             "python3 -m benchmark.run --workload <cell> ...")

from . import harness as H  # noqa: E402

T_PROCESS = H.process_start_time()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None, require_device: bool = True, faults=(),
         root=H.BENCH_DIR, spec_root=H.ROOT) -> int:
    args = parse(argv)
    H.set_cache_dirs()
    import torch

    wl, cfg = H.cell_spec(args.workload, root)
    chips = int(wl.get("chips", 1))
    if require_device:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the GPU only")
            return 2
        if torch.cuda.device_count() < chips:
            log(f"the cell asks for {chips} GPUs, {torch.cuda.device_count()} "
                f"found")
            return 2
        device = torch.device("cuda")
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
    else:
        device = torch.device("cpu")
    logging.getLogger("segtran_tpu_torch").setLevel(logging.WARNING)

    e2e, per_layer = H.benchmark_entries(args.workload, spec_root)
    ctx = H.Context(cell=args.workload, workload=wl, config=cfg,
                    seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), t_process=T_PROCESS,
                    spans=H.Spans(bool(args.trace)),
                    tracer=H.Tracer(bool(args.trace)), device=device,
                    faults=tuple(faults), log=log)
    driver = H.load_module(H.find("drivers", wl["driver"], ".py", root),
                           wl["driver"])
    out = driver.run(ctx)

    found = H.forbidden_loaded(sys.modules)
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3

    metrics = {}
    if args.trace:
        run = H.Run(args.workload, wl, cfg, out, ctx.spans, ctx.tracer.trace)
        for entry in per_layer:
            reader = H.load_module(H.find("metrics", entry["name"], ".py",
                                          root), entry["name"])
            value = reader.read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
    else:
        for entry in e2e:
            if entry["name"] not in out.end_to_end:
                log(f"the driver did not measure {entry['name']}")
                return 4
            metrics[entry["name"]] = {"value": float(
                out.end_to_end[entry["name"]]), "unit": entry["unit"]}

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                 else "cpu"),
        "count": chips,
        "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": out.failed == 0 and all(c.ok for c in out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    trace = ctx.tracer.trace
    if args.trace and trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {
            "device_ops": trace.top_ops(10),
            "idle_gaps": trace.idle_gaps(ctx.spans.items, 10)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    log(f"setup and window: attempted {out.attempted}, failed {out.failed}, "
        f"window {out.window_s:.3f} s")
    for c in out.checks:
        log(f"check {c.name}: {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
