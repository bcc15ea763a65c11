"""evaluate_volume's post-processing on the device (cli/test3d.py): the
Dice and Jaccard from voxel counts equal the float64 numpy formulas bit for
bit; ``ground_truth`` is looked up through the module at call time; the
hard map comes back as uint8, over memory of its own, equal to the
hardening of the probabilities. On the card (``-m cuda``): the ground
truth is built there, the device counts equal the host's, the hard map
comes through page-locked memory. No JAX here, so the card test runs with
``--noconftest`` on a machine without it."""
import numpy as np
import pytest
import torch

from segtran_tpu_torch.cli import test3d
from segtran_tpu_torch.data.labelmaps import harden_segmap
from segtran_tpu_torch.parallel.spatial import slab_overlap


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_dice(pred, gt, smooth=1e-5):
    """Dice over all voxels in float64 numpy (medpy's dc with smoothing)."""
    pred, gt = pred.astype(np.float64), gt.astype(np.float64)
    inter = float((pred * gt).sum())
    return (2 * inter + smooth) / (float(pred.sum() + gt.sum()) + smooth)


def np_jaccard(pred, gt, smooth=1e-5):
    pred, gt = pred.astype(np.float64), gt.astype(np.float64)
    inter = float((pred * gt).sum())
    union = float(pred.sum() + gt.sum()) - inter
    return (inter + smooth) / (union + smooth)


def host_truth(label, task_name, num_classes):
    """The n-hot ground truth built on the host in numpy: BraTS's (bg, ET,
    WT, TC), else one-hot."""
    if task_name == "brats":
        return np.stack([label == 0, label == 3, (label >= 1) & (label <= 3),
                         (label == 1) | (label == 3)], -1).astype(np.uint8)
    return np.eye(num_classes, dtype=np.uint8)[label]


def make_args(task_name, extra=(), device="cpu"):
    args = test3d.build_argparser().parse_args(
        ["--cpdir", "unused", "--task", task_name, "--device", device,
         *extra])
    return args, test3d.task_settings(args)


def blobs(shape, labels, seed):
    """A label volume of nested boxes carrying ``labels`` outside in."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.uint8)
    for i, v in enumerate(labels):
        lo = [int(rng.randint(i + 1, i + 3)) for _ in shape]
        hi = [s - int(rng.randint(i + 1, i + 3)) for s in shape]
        lab[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = v
    return lab


def linear_model(bias):
    """A pointwise 'model': logits (image - 0.5) * 8 plus a per-class
    bias (-40 keeps a class from ever firing)."""
    b = torch.tensor(bias, dtype=torch.float32)
    return lambda v: (v - 0.5) * 8 + b.to(v.device)


# (task, label values outside in, per-class bias, extra flags, empty class)
CASES = {
    "brats-all-regions": ("brats", (2, 1, 3), (0, 0, 0, 0), ("--wholevol",),
                          None),
    "brats-no-et": ("brats", (2, 1), (0, -40, 0, 0), ("--wholevol",), 1),
    "brats-testinterp": ("brats", (2, 1, 3), None, ("--testinterp", "0.5"),
                         None),
    "msd-onehot-empty-class": ("msd", (1,), (0, 0, -40), ("--wholevol",),
                               2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dice_and_jaccard_equal_the_float64_numpy_formulas(case):
    task_name, labels, bias, extra, empty = CASES[case]
    args, task = make_args(task_name, extra)
    nc = task["num_classes"]
    shape = (20, 18, 10)                      # pads to 32 x 32 x 16
    label = blobs(shape, labels, seed=len(case))
    rng = np.random.RandomState(5)
    sample = {"image": rng.rand(*shape, nc).astype(np.float32),
              "label": label}
    model_fn = None if bias is None else linear_model(bias)
    probs, hard, metrics = test3d.evaluate_volume(model_fn, sample, args,
                                                  task, torch.device("cpu"))
    gt = host_truth(label, task_name, nc)
    want_dice = [np_dice(hard[..., c], gt[..., c]) for c in range(1, nc)]
    want_jac = [np_jaccard(hard[..., c], gt[..., c]) for c in range(1, nc)]
    assert metrics["dice"] == want_dice
    assert metrics["jaccard"] == want_jac
    if empty is not None:
        assert not hard[..., empty].any() and not gt[..., empty].any()
        assert metrics["dice"][empty - 1] == metrics["jaccard"][empty - 1]
        assert metrics["dice"][empty - 1] == 1.0
    # the other regions are neither empty nor matched exactly
    assert any(0.0 < d < 1.0 for d in metrics["dice"])


def region_volume(shape, labels, seed):
    """A BraTS sample whose image is its own n-hot regions, so that the
    linear model predicts the ground truth exactly."""
    label = blobs(shape, labels, seed)
    image = host_truth(label, "brats", 4).astype(np.float32)
    return {"image": image, "label": label}


def test_ground_truth_is_found_through_the_module(monkeypatch):
    """The benchmark's ``dice_wrong_region`` fault: a wrapper of
    ``test3d.ground_truth`` that rolls the regions changes the Dice."""
    args, task = make_args("brats", ("--wholevol",))
    sample = region_volume((20, 18, 10), (2, 1, 3), seed=1)
    model_fn = linear_model((0, 0, 0, 0))
    cpu = torch.device("cpu")
    _, _, right = test3d.evaluate_volume(model_fn, sample, args, task, cpu)
    assert right["dice"] == [1.0, 1.0, 1.0]
    truth = test3d.ground_truth

    def rolled(*a, **k):
        gt = truth(*a, **k)
        return torch.cat([gt[..., :1], gt[..., 1:].roll(1, -1)], -1)
    monkeypatch.setattr(test3d, "ground_truth", rolled)
    _, _, wrong = test3d.evaluate_volume(model_fn, sample, args, task, cpu)
    assert all(d < 1.0 for d in wrong["dice"]), wrong["dice"]


def test_hard_map_is_uint8_its_own_and_the_hardened_probs():
    args, task = make_args("brats", ("--wholevol",))
    cpu = torch.device("cpu")
    model_fn = linear_model((0, 0, 0, 0))
    first = region_volume((20, 18, 10), (2, 1, 3), seed=2)
    second = region_volume((20, 18, 10), (2, 1, 3), seed=3)
    probs, hard, _ = test3d.evaluate_volume(model_fn, first, args, task, cpu)
    assert hard.dtype == np.uint8 and hard.shape == (20, 18, 10, 4)
    np.testing.assert_array_equal(hard, harden_segmap(probs).numpy())
    kept = hard.copy()
    _, hard2, _ = test3d.evaluate_volume(model_fn, second, args, task, cpu)
    assert (hard2 != kept).any()              # another volume's map
    np.testing.assert_array_equal(hard, kept)


@pytest.mark.cuda
def test_post_processing_on_the_card(monkeypatch):
    """A whole 240x240x155 BraTS volume: the ground truth is built on the
    card; the device counts equal the host's numpy counts of the fetched
    maps, and the Dice and Jaccard the float64 formulas; the hard map is
    uint8 in page-locked memory and equals the probabilities' hardening."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the post-processing runs there")
    dev = torch.device("cuda")
    args, task = make_args("brats", ("--wholevol",), device="cuda")
    shape = (240, 240, 155)
    label = blobs(shape, (2, 1, 3), seed=4)
    rng = np.random.RandomState(6)
    sample = {"image": rng.rand(*shape, 4).astype(np.float32),
              "label": label}
    truth, built = test3d.ground_truth, []

    def spy(*a, **k):
        gt = truth(*a, **k)
        built.append(gt.device.type)
        return gt
    monkeypatch.setattr(test3d, "ground_truth", spy)
    probs, hard, metrics = test3d.evaluate_volume(
        linear_model((0, 0, 0, 0)), sample, args, task, dev)
    assert built == ["cuda"] and probs.device.type == "cuda"
    assert hard.dtype == np.uint8 and hard.base.is_pinned()
    np.testing.assert_array_equal(hard, harden_segmap(probs).cpu().numpy())
    gt = host_truth(label, "brats", 4)
    counts = slab_overlap(torch.from_numpy(hard).to(dev),
                          truth(label, "brats", 4, dev), None).cpu().numpy()
    host = np.stack([(hard.astype(bool) & gt.astype(bool)).sum((0, 1, 2)),
                     hard.sum((0, 1, 2), dtype=np.int64),
                     gt.sum((0, 1, 2), dtype=np.int64)])
    np.testing.assert_array_equal(counts, host)
    assert metrics["dice"] == [np_dice(hard[..., c], gt[..., c])
                               for c in range(1, 4)]
    assert metrics["jaccard"] == [np_jaccard(hard[..., c], gt[..., c])
                                  for c in range(1, 4)]
