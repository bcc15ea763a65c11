"""A copy of the benchmark with tiny cells that run on the CPU: the
same drivers, readers and reference at small shapes and in float32 (so
that the port's plain CPU path and the reference agree to rounding)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness as H

TINY = {
    "tiny-serve": ("fundus-serve", "tiny-fundus", {
        "rate_rps": 40.0, "pool": 6, "check_answers": 12,
        "trace_s": 0.5}),
    "tiny-train": ("brats-train", "tiny-brats", {
        "volume_size": [40, 40, 32], "crop_size": [32, 32, 24],
        "input_size": [32, 32, 24], "volumes": 4, "warm_steps": 1,
        "trace_s": 0.5,
        "extra_argv": ["--bs", "2", "--patchsize", "32,32,24",
                       "--inputsize", "32,32,24"]}),
    "tiny-wholevol": ("brats-wholevol", "tiny-brats", {
        "volume_size": [32, 32, 24], "pool": 2, "check_within": 2,
        "check_answers": 1, "trace_s": 0.5}),
}
# float32 on both sides: the readings are rounding, far under these
TINY_CHECKS = {
    "tiny-serve": {"worst_answer_mean_gap": 1e-4},
    "tiny-wholevol": {"worst_answer_mean_gap": 1e-4,
                      "worst_hard_mismatch": 1e-3,
                      "worst_hard_own_mismatch": 0.0,
                      "worst_dice_own_gap": 0.0},
    "tiny-train": {"first_logit_gap": 1e-4, "loss_gap": 1e-4,
                   "change_p90_gap": 0.02, "change_gap": 0.02},
}


def make(dst: Path) -> Path:
    """Copy the benchmark into ``dst/benchmark`` with the tiny cells and a
    BENCHMARK.json that lists them; returns the copy's benchmark dir."""
    bench = dst / "benchmark"
    shutil.copytree(H.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    fundus = H.load_json(bench / "configs" / "fundus-segtran2d-effb4.json")
    fundus["model"].update(orig_input_size=[64, 64], patch_size=[32, 32])
    fundus["serve_argv"] = [a for a in fundus["serve_argv"]
                            if a != "--bf16"] + [
        "--origsize", "64", "--patchsize", "32", "--maxbatch", "4"]
    brats = H.load_json(bench / "configs" / "brats-segtran3d-i3d.json")
    brats["train"]["argv"] = [a for a in brats["train"]["argv"]
                              if a != "--bf16"]
    brats["eval_argv"] = [a for a in brats["eval_argv"] if a != "--bf16"]
    for name, cfg in (("tiny-fundus", fundus), ("tiny-brats", brats)):
        cfg["name"] = name
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec = H.load_json(H.ROOT / "BENCHMARK.json")
    for tiny, (cell, config, traffic) in TINY.items():
        wl = H.load_json(bench / "workloads" / f"{cell}.json")
        mix = H.load_json(bench / "traffic" / f"{wl['traffic']}.json")
        mix.update(traffic)
        (bench / "traffic" / f"{tiny}.json").write_text(json.dumps(mix))
        wl.update(name=tiny, config=config, traffic=tiny,
                  checks=TINY_CHECKS[tiny])
        wl.pop("flops")                 # the mfu readers find nothing
        (bench / "workloads" / f"{tiny}.json").write_text(json.dumps(wl))
        for e in spec["end_to_end"] + spec["per_layer"]:
            if cell in e.get("workloads", ()):
                e["workloads"].append(tiny)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def run(bench: Path, cell: str, seed: int = 3, seconds: float = 2.0,
        trace: int = 0, faults=(), capsys=None):
    """One run of a tiny cell on the CPU; returns the result line."""
    from benchmark import run as runner
    rc = runner.main(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)],
                     require_device=False, faults=faults, root=bench,
                     spec_root=bench.parent)
    assert rc == 0, rc
    if capsys is None:
        return None
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
