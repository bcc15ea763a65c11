"""The span recorder's counters and the stages they were added for: the
2.5D model's backbone and out-FPN spans and its slice counter, and the
data-parallel all-reduce counters and gradient all-reduce span on two
gloo ranks; none of them records anything with recording off. No JAX;
the modules under test are imported inside the tests, so that a rank
reads ``SEGTRAN_TRACE`` before the recorder is imported."""
import time

import pytest
import torch
import torch.distributed as dist

from _torch_dist import launch


def test_counters_add_and_copy(monkeypatch):
    from segtran_tpu_torch.utils import tracing
    rec = tracing.Recorder()
    rec.count("a")
    rec.count("a", 4)
    rec.count("b", 2)
    got = rec.counters()
    assert got == {"a": 5, "b": 2}
    got["a"] = 0
    assert rec.counters()["a"] == 5
    before = tracing.counters().get("test.off", 0)
    monkeypatch.setattr(tracing, "ENABLED", False)
    tracing.count("test.off", 3)
    assert tracing.counters().get("test.off", 0) == before


@pytest.fixture(scope="module")
def model25d():
    from segtran_tpu_torch.configs.base import Segtran25dConfig
    from segtran_tpu_torch.models.segtran25d import Segtran25d
    cfg = Segtran25dConfig(backbone_type="eff-tiny", num_classes=3,
                           num_attractors=8, orig_in_channels=4,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0).derive(
        translayer_compress_ratios=(1.0, 1.0))
    torch.manual_seed(0)
    return Segtran25d(cfg).eval()


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_segtran25d_stages_and_slices(model25d, monkeypatch, on):
    """One forward of [2, 32, 32, 8, 4]: the backbone span, then the
    out-FPN span, both inside the forward, and 16 slices counted; with
    recording off neither span nor the count."""
    from segtran_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "ENABLED", on)
    x = torch.rand(2, 32, 32, 8, 4)
    slices0 = tracing.counters().get("segtran25d.slices", 0)
    t0 = time.time_ns()
    with torch.no_grad():
        model25d(x)
    t1 = time.time_ns()
    bb = tracing.spans("segtran25d.backbone", t0)
    out = tracing.spans("segtran25d.out_fpn", t0)
    slices = tracing.counters().get("segtran25d.slices", 0) - slices0
    if not on:
        assert (bb, out, slices) == ([], [], 0)
        return
    assert len(bb) == len(out) == 1 and slices == 2 * 8
    assert t0 <= bb[0].t0 <= bb[0].t1 <= out[0].t0 <= out[0].t1 <= t1


def _dp_rank(rank, world, out_dir):
    from segtran_tpu_torch.ops import norm
    from segtran_tpu_torch.utils import tracing
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)                 # 8 float32 parameters
    x = torch.rand(4, 3, requires_grad=True)
    with norm.global_batch(dist.group.WORLD):
        norm.global_sum(x.sum(0)).sum().backward()   # 3 floats, then 3
        lin(x).sum().backward()
        norm.average_gradients(lin.parameters())     # 8 floats at once
    c = tracing.counters()
    return {"calls": c.get("dp.allreduce_calls", 0),
            "bytes": c.get("dp.allreduce_bytes", 0),
            "spans": len(tracing.spans("dp.grad_allreduce"))}


@pytest.mark.parametrize("trace", ["1", "0"])
def test_data_parallel_allreduces_are_counted(tmp_path, trace):
    """A statistics all-reduce, its gradient's and the gradients' one per
    dtype: 3 calls of 12, 12 and 32 bytes and one ``dp.grad_allreduce``
    span per rank; nothing with SEGTRAN_TRACE=0."""
    ranks = launch(_dp_rank, 2, tmp_path, deadline=60.0,
                   env={"SEGTRAN_TRACE": trace})
    want = (3, 56, 1) if trace == "1" else (0, 0, 0)
    for r in ranks:
        assert (int(r["calls"]), int(r["bytes"]), int(r["spans"])) == want
