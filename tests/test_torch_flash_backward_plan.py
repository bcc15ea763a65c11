"""The flash backward's launch plan (``_bwd_plan``), which the wrapper
uses to size the clusters, the grids, the dQ key splits and the scratch:
checked on the CPU at the path shapes and the chip check's cases, in bf16
and fp32, for an H100's 132 SMs."""
import pytest
import torch

from segtran_tpu_torch.kernels import squeezed_attention as sa
from _torch_parity import one_torch_thread  # noqa: F401

SMS = 132
# (G, Q, N, D, F): the in-squeeze of the 160x192x144 and 240x240x160
# training crops, the ragged and clamp cases of chip_smoke's
# FLASH_BWD_CASES, the recipe crop (timing only), the 2-D width 1792
SHAPES = {"in-squeeze N=8640": (1, 1024, 8640, 1024, 1024),
          "in-squeeze N=18000": (1, 1024, 18000, 1024, 1024),
          "ragged": (3, 1000, 4700, 200, 264),
          "clamp": (1, 256, 512, 64, 64),
          "recipe crop": (4, 1024, 2352, 1024, 1024),
          "D=F=1792": (4, 1296, 4096, 1792, 1792)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _covered_once(slices, width):
    seen = [0] * width
    for sl in slices:
        if sl is not None:
            for col in range(*sl):
                seen[col] += 1
    return seen == [1] * width


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_the_card_and_covers_every_column(shape, dname):
    g, nq, n, d, f = SHAPES[shape]
    plan = sa._bwd_plan(g, nq, n, d, f, DTYPES[dname], SMS)
    assert 1 <= plan.cluster <= 8
    assert plan.width == (128 if max(d, f) <= 1024 else 256)
    assert len(plan.d_slices) == len(plan.f_slices) == plan.cluster
    # CTA c owns columns [c W, (c + 1) W): each column of D and F once
    assert _covered_once(plan.d_slices, d) and _covered_once(plan.f_slices, f)
    for c, sl in enumerate(plan.d_slices + plan.f_slices):
        assert sl is None or sl[0] == (c % plan.cluster) * plan.width
    assert plan.dkdv_smem <= 232448 and plan.dq_smem <= 232448
    # a tile is 16 KB of one slice; the grids are whole clusters
    esize = 2 if dname == "bf16" else 4
    assert plan.tile * plan.width * esize == 16384
    assert plan.dkdv_grid == (plan.cluster * -(-n // plan.tile), g, 1)
    assert plan.dq_grid == (plan.cluster * -(-nq // plan.tile), plan.splits,
                            g)
    # every dQ key split holds at least one key tile, and they cover all
    n_tiles = -(-n // plan.tile)
    assert plan.split_tiles == -(-n_tiles // plan.splits)
    starts = [s * plan.split_tiles for s in range(plan.splits)]
    assert all(st < n_tiles for st in starts)
    assert plan.splits * plan.split_tiles >= n_tiles


def test_plan_at_the_path_shape():
    """The in-squeeze at 160x192x144 in bf16: clusters of 8 CTAs, 64-row
    tiles, 135 dK/dV clusters and eight dQ key splits."""
    plan = sa._bwd_plan(1, 1024, 8640, 1024, 1024, torch.bfloat16, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (128, 8, 64)
    assert plan.dkdv_grid == (8 * 135, 1, 1)
    assert plan.dq_grid == (8 * 16, 8, 1)
    assert plan.dkdv_smem == plan.dq_smem == 212480


@pytest.mark.parametrize("d,f", [(4096, 1024), (1024, 2304), (2056, 8)])
def test_plan_refuses_a_cluster_above_eight(d, f):
    with pytest.raises(ValueError, match=f"D={d}, F={f}"):
        sa._bwd_plan(1, 1024, 8640, d, f, torch.bfloat16, SMS)


@pytest.mark.parametrize("wrapper", ["flash_backward_dkdv",
                                     "flash_backward_dq"])
def test_cuda_wrapper_raises_on_a_shape_outside_the_plan(monkeypatch,
                                                         wrapper):
    """A CUDA tensor at a width the kernels do not take raises ValueError
    naming the shape; the plain version does not run."""
    monkeypatch.setattr(sa, "_on_cpu", lambda t: False)
    monkeypatch.setattr(sa, "_lib", lambda: None)
    monkeypatch.setattr(sa, "_sm_count", lambda device: SMS)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(sa, "flash_backward_dkdv_plain", refuse)
    monkeypatch.setattr(sa, "flash_backward_dq_plain", refuse)
    q, k = torch.zeros(1, 4, 4096), torch.zeros(1, 8, 4096)
    v, do = torch.zeros(1, 8, 64), torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="D=4096, F=64"):
        getattr(sa, wrapper)(q, k, v, do, torch.zeros(1, 4, 1),
                             torch.zeros(1, 4, 1))
