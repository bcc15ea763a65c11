"""The benchmark's harness on the CPU at tiny sizes: what it imports, that
new files are found by name, the reference against the port's plain
path, the control and the planted faults failing the check, and the
kernel work counts against shapes worked by hand.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness as H
from benchmark.tests import tiny

ROOT = H.ROOT


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_compare_whole_top_level_names():
    assert H.forbidden_loaded(["segtran_tpu_torch", "segtran_tpu_torch.cli",
                               "jaxtyping", "numpy"]) == []
    assert H.forbidden_loaded(["segtran_tpu.cli", "jaxlib.xla_client",
                               "flax"]) == ["flax", "jaxlib", "segtran_tpu"]


def test_reference_imports_nothing_of_the_program_or_jax():
    mods = _modules("import benchmark.reference.nets, "
                    "benchmark.reference.train3d, benchmark.work.flops")
    tops = {m.split(".", 1)[0] for m in mods}
    assert not tops & {"segtran_tpu_torch", "segtran_tpu", "jax", "jaxlib",
                       "flax"}, tops


def test_a_whole_run_imports_no_jax_nor_the_jax_package(tmp_path):
    bench = tiny.make(tmp_path)
    code = (f"from pathlib import Path\nfrom benchmark.tests import tiny\n"
            f"tiny.run(Path({str(bench)!r}), 'tiny-serve', seconds=1.0)\n"
            "import benchmark.calibrate\n"
            "for d in ('serve_open_loop', 'train_closed_loop', "
            "'volume_closed_loop'):\n"
            "    from benchmark import harness as H\n"
            "    H.load_module(H.find('drivers', d, '.py'), d)")
    tops = {m.split(".", 1)[0] for m in _modules(code)}
    assert "segtran_tpu_torch" in tops
    assert not tops & {"segtran_tpu", "jax", "jaxlib", "flax"}, tops


def test_new_config_traffic_cell_and_metric_are_found_by_name(tmp_path,
                                                              capsys):
    bench = tiny.make(tmp_path)
    cfg = json.loads((bench / "configs" / "tiny-fundus.json").read_text())
    cfg["name"] = "tiny-fundus-copy"
    (bench / "configs" / "tiny-fundus-copy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny-serve.json").read_text())
    mix["rate_rps"] = 20.0
    (bench / "traffic" / "tiny-open-loop-20rps.json").write_text(
        json.dumps(mix))
    wl = json.loads((bench / "workloads" / "tiny-serve.json").read_text())
    wl.update(name="tiny-serve-copy", config="tiny-fundus-copy",
              traffic="tiny-open-loop-20rps")
    (bench / "workloads" / "tiny-serve-copy.json").write_text(json.dumps(wl))
    (bench / "metrics" / "serve.answered_share.py").write_text(
        "def read(run):\n"
        "    c = run.outcome.counters\n"
        "    return 100.0 * c['answered'] / run.outcome.attempted\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for e in spec["end_to_end"]:
        if "tiny-serve" in e.get("workloads", ()):
            e["workloads"].append("tiny-serve-copy")
    spec["per_layer"].append({
        "name": "serve.answered_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "serving engine",
        "moves": "frames_per_s", "workloads": ["tiny-serve-copy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = tiny.run(bench, "tiny-serve-copy", seconds=1.0, trace=1,
                   capsys=capsys)
    assert res["correct"] and res["attempted"] == 20
    assert res["metrics"]["serve.answered_share"]["value"] == 100.0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-wholevol",
                                  "tiny-train"])
def test_reference_agrees_with_the_plain_port(bench, capsys, cell):
    """fp32 on both sides at tiny sizes: the limits of TINY_CHECKS hold
    rounding, far under any fault."""
    res = tiny.run(bench, cell, seed=2 ** 31 + 11, seconds=1.5,
                   capsys=capsys)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell,fault", [
    ("tiny-serve", "answer_altered"), ("tiny-serve", "half_batch"),
    ("tiny-wholevol", "answer_altered"),
    ("tiny-wholevol", "consistency_skipped"),
    ("tiny-wholevol", "background_inverted"),
    ("tiny-wholevol", "dice_wrong_region"),
    ("tiny-train", "state_unchanged"),
    ("tiny-train", "half_batch")])
def test_a_planted_fault_fails_the_check(bench, capsys, cell, fault):
    res = tiny.run(bench, cell, seed=5, seconds=1.5, faults=(fault,),
                   capsys=capsys)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-wholevol",
                                  "tiny-train"])
def test_the_control_fails_the_check(bench, cell):
    """The reference in float8 e4m3 in the program's place reads above the
    cell's limit on at least one number."""
    import torch
    from benchmark.reference import nets
    wl, cfg = H.cell_spec(cell, bench)
    driver = H.load_module(H.find("drivers", wl["driver"], ".py", bench),
                           wl["driver"])
    ctx = H.Context(cell=cell, workload=wl, config=cfg, seed=9, seconds=1.5,
                    trace=False, t_process=0.0, spans=H.Spans(False),
                    tracer=H.Tracer(False), device=torch.device("cpu"))
    readings = driver.control(ctx, nets.Prec("fp8"))
    assert any(readings[k] > v for k, v in wl["checks"].items()), readings


def test_the_result_line_and_the_checks_come_last(bench, capsys):
    res = tiny.run(bench, "tiny-wholevol", seconds=1.0, trace=1,
                   capsys=capsys)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run reads no device metric
    assert not any(k.startswith(("device_idle", "mfu", "epilogue_roofline",
                                 "flash_fwd_roofline"))
                   for k in res["metrics"])


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "fundus-serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_work_counts_by_hand():
    from benchmark.work import epilogue, flash, peaks
    # flash: 2 G Q N (D + F); Q, K, V read and O written once, 2 bytes
    assert flash.work(2, 3, 5, 4, 6) == (2 * 2 * 3 * 5 * 10,
                                         (24 + 40 + 60 + 36) * 2)
    # private tier: 2 B M N F F; mid read once, W2 b2 LN(2F) ws bs, out
    f, nb = epilogue.work("private", 1, 2, 3, 0, 4)
    assert f == 2 * 1 * 2 * 3 * 4 * 4
    assert nb == (24 + (32 + 8 + 12 + 1)) * 2 + 12 * 2
    # mid tier adds P V W1: 2 B M N F (A + F); P and V W1 and b1 read
    f, nb = epilogue.work("mid", 1, 2, 3, 5, 4)
    assert f == 2 * 1 * 2 * 3 * 4 * (5 + 4)
    assert nb == (30 + 40) * 2 + (32 + 8 + 12 + 1 + 4) * 2 + 12 * 2
    # the flagship's per-mode call is bound by operations
    fl, b = epilogue.work("mid", 8, 4, 1296, 256, 1792)
    assert peaks.bound_seconds(fl, b) == fl / 989e12


def test_roofline_reader_counts_traced_calls_against_device_time():
    from benchmark import readers
    trace = H.Trace([("void mid_pool_kernel<bf16, false>", 0, 2_000_000),
                     ("void mid_pool_kernel<bf16, false>", 1_000_000,
                      3_000_000), ("other", 0, 9_000_000)], 0, 10_000_000)
    out = H.Outcome(1, 0, {}, [], 0, 1.0,
                    counters={"traced_items": 2,
                              "traced_launches": {"epilogue": 2}})
    wl = {"kernels_per_item": {"epilogue": [["private", 1, 4, 18000, 0,
                                             1024]]}}
    run = H.Run("c", wl, {}, out, H.Spans(False), trace)
    from benchmark.work import epilogue, peaks
    want = 2 * peaks.bound_seconds(*epilogue.work("private", 1, 4, 18000, 0,
                                                  1024)) / 3e-3 * 100
    assert readers.roofline(run, "epilogue") == pytest.approx(want)
    assert readers.idle(run) == pytest.approx(10.0)
    out.counters["traced_launches"]["epilogue"] = 3
    assert readers.roofline(run, "epilogue") is None


@pytest.mark.parametrize("launches,read", [(6, True), (8, True), (5, False),
                                           (9, False)])
def test_roofline_reader_takes_a_batch_straddling_the_slice(launches, read):
    """Three launches per serving batch: a slice that opens inside a batch
    holds up to two launches more than its whole batches; other counts
    are launches the shapes do not account for."""
    from benchmark import readers
    trace = H.Trace([("void mid_pool_kernel<bf16, false>", 0, 1_000_000)],
                    0, 2_000_000)
    out = H.Outcome(1, 0, {}, [], 0, 1.0, counters={
        "traced_items": 2, "traced_launches": {"epilogue": launches}})
    shapes = [["mid", 8, 4, 1296, 256, f] for f in (1792, 896, 448)]
    run = H.Run("c", {"kernels_per_item": {"epilogue": shapes}}, {}, out,
                H.Spans(False), trace)
    assert (readers.roofline(run, "epilogue") is not None) == read


def test_arrivals_keep_the_load_and_change_the_order():
    from benchmark import inputs
    a = inputs.arrivals(50.0, 10.0, 2 ** 33 + 5)
    b = inputs.arrivals(50.0, 10.0, 7)
    assert len(a) == len(b) == 500 and a[0] == b[0] == 0.0
    assert a.tolist() != b.tolist() and max(a[-1], b[-1]) < 10.0
    gaps_a = {round(x, 9) for x in (a[1:] - a[:-1]).tolist()}
    gaps_b = {round(x, 9) for x in (b[1:] - b[:-1]).tolist()}
    assert len(gaps_a & gaps_b) >= 498


def test_seeds_above_32_bits():
    from benchmark import inputs
    assert H.seed_parts(2 ** 40 + 3) == [3, 256]
    assert 0 <= H.torch_seed(2 ** 70) < 2 ** 63
    inputs.rng(2 ** 40, 1).integers(0, 5)
