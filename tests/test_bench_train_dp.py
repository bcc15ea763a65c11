"""The benchmark's data-parallel reference of the BraTS recipe step
(``benchmark/reference/train_dp.py``) on four gloo ranks of the CPU, one
sample each, against the whole-batch reference (``reference/train3d``)
on the four samples in one process: the same loss, first gradients and
weights after one step, because every BatchNorm takes the global batch's
statistics and the gradients are averaged before the clip. I3D at its
widths on a 32x32x16 crop (a 2x4x4 token grid), 8 attractors, float32."""
import numpy as np
import pytest
import torch

from _torch_dist import launch

CROP = (32, 32, 16)
SEED = 7


def _shapes():
    """({leaf or buffer: shape}, the trainable leaves' names) of the
    recipe's Segtran3d with 8 attractors."""
    from benchmark import inputs
    from segtran_tpu_torch.cli import train3d
    args = train3d.build_argparser().parse_args([
        "--task", "brats", "--translayers", "1", "--attractors", "8",
        "--device", "cpu"])
    with torch.device("meta"):
        meta, _ = train3d.build_model_and_config(
            args, train3d.train_task_settings(args))
    return inputs.model_shapes(meta), [n for n, _ in meta.named_parameters()]


def _inputs(shapes):
    from benchmark import inputs
    from benchmark.drivers.train_closed_loop import draw
    state = inputs.seeded_state(shapes, SEED, "cpu")
    g = torch.Generator().manual_seed(SEED)
    image = torch.rand((4,) + CROP + (4,), generator=g)
    label = torch.randint(0, 4, (4,) + CROP, generator=g).to(torch.uint8)
    return state, image, label, draw(torch.Generator().manual_seed(SEED),
                                     4, 0.1)


def _trainer(cls, state, names):
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                      / "configs" / "brats-segtran3d-i3d.json").read_text())
    hp = dict(cfg["train"], input_size=CROP)
    return cls({k: state[k] for k in names},
               {k: v for k, v in state.items() if k not in names},
               cfg["model"], hp)


def _rank(rank, world, out_dir, shapes, names, whole):
    """This rank's step on its sample, held against the whole batch's
    (``whole``, an .npz) here, so that only numbers come back."""
    import hashlib
    from benchmark.reference import train_dp
    state, image, label, d = _inputs(shapes)
    rows = [rank]
    trn = _trainer(train_dp.Trainer, state, names)
    loss = trn.step(image[rows], label[rows],
                    {"rot_flip": tuple(v[rows] for v in d["rot_flip"]),
                     "zoom": d["zoom"]})
    mine = _step(trn, names)
    with np.load(whole) as w:
        norms = {k: np.linalg.norm(w["g:" + k]) for k in names}
        floor = 1e-3 * np.median(list(norms.values()))
        gaps = [np.linalg.norm(mine["g:" + k] - w["g:" + k]) / norms[k]
                for k in names if norms[k] >= floor]
        moved = float(np.abs(mine["params"] - w["params"]).max())
    return {"loss": loss, "worst_grad_gap": max(gaps), "weight_gap": moved,
            "weights": hashlib.sha256(mine["params"].tobytes()).hexdigest()}


def _step(trn, names):
    """Each leaf's first gradient and the weights after the step."""
    return {**{"g:" + k: trn.first_grads[k].numpy() for k in names},
            "params": torch.cat([trn.params[k].detach().reshape(-1)
                                 for k in names]).numpy()}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_four_shards_with_global_statistics_give_the_whole_batch_step(
        tmp_path):
    """float32, the same sums split four ways and the variance taken as
    E[x^2] - E[x]^2 of the ranks' moments: rounding only, which the
    BatchNorm statistics of one sample a rank at this size amplify to
    ~1e-4 of a leaf's gradient (leaves whose gradient is zero in exact
    arithmetic, under 1e-3 of the median leaf's, left out); the weights
    after the step agree to ~1e-7 and are the same numbers on every rank.
    Statistics of the shard alone move the gradients by more than 1e-1."""
    from benchmark.reference import train3d as ref
    shapes, names = _shapes()
    state, image, label, d = _inputs(shapes)
    trn = _trainer(ref.Trainer, state, names)
    loss = trn.step(image, label, d)
    whole = str(tmp_path / "whole.npz")
    np.savez(whole, **_step(trn, names))
    ranks = launch(_rank, 4, tmp_path, shapes=shapes, names=names,
                   whole=whole)
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= 1e-5 * loss
        assert float(r["worst_grad_gap"]) <= 1e-2, r["worst_grad_gap"]
        assert float(r["weight_gap"]) <= 1e-6, r["weight_gap"]
    assert len({str(r["weights"]) for r in ranks}) == 1
