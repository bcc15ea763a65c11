"""The benchmark's plain reference of Segtran 2.5D
(``benchmark/reference/segtran25d.py``) against the port's Segtran25d on
the CPU, at the published widths (eff-b3 per slice, F = 1536) and a small
volume, on seeded weights, in float32 and training mode: the logits with
the same drop-connect draws, the recipe's loss and every leaf's
gradient; the configuration's entry in BENCHMARK.json; the flash
backward's work counted by hand. No JAX here."""
import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import inputs
from benchmark.reference import segtran25d as r25
from benchmark.reference import train3d as ref
from benchmark.work import flash_bwd, flops25d

ROOT = Path(__file__).resolve().parents[1]
SIZE = (32, 32, 4)                   # H, W, D: a 4 x 4 x 2 token grid


@pytest.fixture(scope="module")
def pair():
    from segtran_tpu_torch.cli import train3d
    torch.manual_seed(0)
    args = train3d.build_argparser().parse_args([
        "--task", "brats", "--segtran", "25d", "--bb", "eff-b3",
        "--translayers", "1", "--attractors", "8", "--dropout", "0",
        "--device", "cpu", "--patchsize", ",".join(map(str, SIZE)),
        "--inputsize", ",".join(map(str, SIZE))])
    model, cfg = train3d.build_model_and_config(args,
                                                train3d.task_settings(args))
    state = inputs.seeded_state(inputs.model_shapes(model), 11, "cpu")
    model.load_state_dict(state, strict=True)
    spec = json.loads((ROOT / "benchmark" / "configs"
                       / "brats-segtran25d-effb3.json").read_text())["model"]
    return model, cfg, state, spec


def test_reference_matches_the_port_in_training(pair):
    """Logits, loss and gradients of one training forward and backward.
    Tolerances: float32 on both sides, in different orders (the port
    composes the tail's three 1x1 convs into one product and recomputes
    each EfficientNet block in the backward; BatchNorm statistics over a
    batch of 8 slices): the logits differ by ~1e-5 of their largest
    value, the gradients by ~1e-4 of a leaf's norm; a planted fault (a
    block dropped, another slice order) moves them by more than 1e-1."""
    from segtran_tpu_torch.nn.attention import set_dropout_generator
    model, cfg, state, spec = pair
    assert cfg.translayer_dims == tuple(spec["translayer_dims"])
    model.train()
    set_dropout_generator(model, torch.Generator().manual_seed(5))
    x = torch.rand((2,) + SIZE + (4,), generator=torch.Generator()
                   .manual_seed(3))
    mask = (torch.rand((2,) + SIZE + (4,), generator=torch.Generator()
                       .manual_seed(4)) < 0.3).float()
    out = model(x)
    params = dict(model.named_parameters())
    loss = ref.loss_fn(out, mask, spec["bce_weight"], 0.5)
    grads = torch.autograd.grad(loss, list(params.values()))

    sd = {k: v.clone().requires_grad_(k in params) for k, v in state.items()}
    want = r25.segtran25d(x, sd, spec, gen=torch.Generator().manual_seed(5),
                          chunked=True)
    want_loss = ref.loss_fn(want, mask, spec["bce_weight"], 0.5)
    want_grads = torch.autograd.grad(want_loss, [sd[k] for k in params])

    scale = float(want.detach().abs().max())
    assert float((out - want).detach().abs().max()) <= 1e-4 * scale
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    # leaves whose gradient is zero in exact arithmetic (a BatchNorm bias
    # before another BatchNorm, the mode scores' bias under the softmax,
    # the in-squeeze's scores, a softmax over its one mode) read rounding
    # alone, ~1e-9: they are left out as the benchmark's readings leave
    # them out (under 1e-3 of the median leaf's norm)
    norms = [float(w.norm()) for w in want_grads]
    floor = 1e-3 * sorted(norms)[len(norms) // 2]
    worst = max(float((g - w).norm()) / n
                for g, w, n in zip(grads, want_grads, norms) if n >= floor)
    assert worst <= 1e-3, worst
    left = [k for k, n in zip(params, norms) if n < floor]
    assert all(k.endswith(".bias") or ".in_ator_trans." in k
               for k in left), left


def test_drop_connect_draws_follow_the_blocks():
    """One [N, 1, 1, 1] draw per residual block with a rate above 0, in
    block order, kept with probability 1 - 0.2 i / n and scaled by its
    inverse."""
    blocks, ends, _ = r25.effnet_blocks("eff-b3")
    assert len(blocks) == 26 and ends == [2, 5, 8, 18]
    assert [b[4] for b in blocks[:2]] == [24, 24]
    masks = r25.drop_masks(blocks, 0.2, 6, torch.Generator().manual_seed(1),
                           "cpu")
    residual = [i for i, (_, st, _, ci, co, _) in enumerate(blocks)
                if st == 1 and ci == co and i > 0]
    assert sorted(masks) == residual
    for i, m in masks.items():
        keep = 1.0 - 0.2 * i / len(blocks)
        assert m.shape == (6, 1, 1, 1)
        kept = m.flatten()[m.flatten() > 0]
        assert torch.allclose(kept, torch.full_like(kept, 1.0 / keep))


def test_config_is_its_own_entry():
    """The 2.5D configuration's (source, reduced) pair is no other
    configuration's, its file is its own and names the published
    widths, and its cell lists it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = next(c for c in spec["configs"]
                if c["name"] == "brats-segtran25d-effb3")
    others = [c for c in spec["configs"] if c is not mine]
    assert (mine["source"], mine["reduced"]) not in [
        (c["source"], c["reduced"]) for c in others]
    assert mine["file"] not in [c["file"] for c in others]
    assert mine["reduced"] == []
    assert "segtran25d.py" in mine["source"]
    cfg = json.loads((ROOT / mine["file"]).read_text())
    assert cfg["source"] == mine["source"]
    m = cfg["model"]
    assert (m["backbone"], m["translayer_dims"], m["num_attractors"],
            m["num_modes"], m["depth_pool"], m["D_groupsize"]) == (
        "eff-b3", [1536, 1536], 1024, 4, 2, 1)
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["brats25d-train"]["config"] == mine["name"]
    assert cells["brats-train-dp4"]["chips"] == 4


def test_flash_backward_work_counts_by_hand():
    """G=1 Q=2 N=3 D=4 F=5: dK/dV 2*1*2*3*(8 + 10) = 216 FLOP, dQ
    2*1*2*3*(8 + 5) = 156; elements Q 8, K 12, V 15, dO 10, dK 12, dV 15,
    dQ 8 = 80 at 2 bytes, lse and delta 2 * 2 at 4 bytes."""
    assert flash_bwd.work(1, 2, 3, 4, 5) == (216 + 156, 80 * 2 + 16)
    g, q, n, d, f = 4, 1024, 9408, 1536, 1536
    flops, nbytes = flash_bwd.work(g, q, n, d, f)
    assert flops == 2 * g * q * n * (4 * d + 3 * f)
    # the dK/dV and dQ bounds of the kernel table, 0.479 + 0.359 ms
    assert math.isclose(flops / 989e12 * 1e3, 0.838, rel_tol=0.01)


def test_flops_count_the_plain_step(pair):
    """The 2.5D step's reference FLOPs on the meta device: the backward
    about twice the forward, the depthwise convolutions' weight gradients
    counted once and not once per channel."""
    model, _, _, spec = pair
    shapes = inputs.model_shapes(model)
    wl = {"flops": {"pass": "train", "input": [1] + list(SIZE) + [4]}}
    total = flops25d.per_item({"model": spec}, wl, shapes)
    assert total and total > 0
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in shapes.items()}
        x = torch.empty(wl["flops"]["input"])
    counter = FlopCounterMode(display=False)
    with counter:
        r25.segtran25d(x, sd, spec)
    fwd = counter.get_total_flops()
    assert 2.9 * fwd <= total <= 3.1 * fwd
