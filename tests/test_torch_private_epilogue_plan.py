"""The private tier of the expansion epilogue (``fused_private_output_pool``:
mid [B, M, N, F] given), which launches ``mid_pool_kernel``'s private tier:
its plan (``_epi_plan`` with A = 0) at every shape the chip check runs, in
bf16 and fp32 for an H100's 132 SMs; a plain-PyTorch emulation of its
decomposition (mid chunks from memory, z of each slice summed over the
depth chunks in order, rank-ordered LayerNorm and score partials, the
online mode pool in mode order; steps (b)-(d) shared with the full tier's
emulation) held against the plain version and the JAX package's Pallas
kernel in interpret mode; the CUDA wrapper's refusals and its one launch;
and the ablation tool's source edits, which must all still apply."""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtran_tpu_torch.kernels import _build
from segtran_tpu_torch.kernels import expansion_epilogue as epi
from test_torch_epilogue_plan import (DTYPES, F32, SMS, _inputs,
                                      emulate_steps)
from _torch_parity import one_torch_thread  # noqa: F401

# chip_smoke's private cases (B, M, N, F): the BraTS whole-volume layer at
# 160x192x144 and 240x240x155, the non-reassociated fundus forward (batch
# 2) and the --fused serving forward (batch 8) at the three widths
SHAPES = [(1, 4, 8640, 1024), (1, 4, 18000, 1024),
          (2, 4, 1296, 1792), (2, 4, 1296, 896), (2, 4, 1296, 448),
          (8, 4, 1296, 1792), (8, 4, 1296, 896), (8, 4, 1296, 448)]


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("b,m,n,f", SHAPES,
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_private_plan_fits_the_card_and_covers_every_row_and_column(
        b, m, n, f, dname):
    dt = DTYPES[dname]
    plan = epi._epi_plan(b, m, n, 0, f, dt, SMS)
    assert plan.from_mid and 1 <= plan.cluster <= 8
    seen = np.zeros(f, int)
    for c, (lo, hi) in enumerate(plan.slices):
        assert lo == c * plan.width and 0 < hi - lo <= plan.width
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.smem <= 232448
    # the full tier's carve-up with a third ring slot (an A chunk [tile,
    # KC] and a W2 chunk [KC, W]) in place of its mid slice [tile, W], rows
    # padded by 16 bytes
    es = 2 if dname == "bf16" else 4
    vec, kc = 16 // es, 64 if es == 2 else 32
    full = epi._epi_plan(b, m, n, 256, f, dt, SMS)
    assert not full.from_mid
    slot = es * (plan.tile * (kc + vec) + kc * (plan.width + vec))
    assert plan.smem == full.smem - es * plan.tile * (plan.width + vec) + slot
    assert plan.grid[0] % plan.cluster == 0 and plan.grid[1:] == (b, 1)
    tiles = plan.grid[0] // plan.cluster
    hits = np.zeros((b, n), int)
    for i in range(b):
        for t in range(tiles):
            assert t * plan.tile < n
            hits[i, t * plan.tile:(t + 1) * plan.tile] += 1
    assert (hits == 1).all()
    assert plan.waves == -(-b * tiles // (SMS // plan.cluster))


def test_private_plan_at_the_brats_volume():
    """mid [1,4,8640,1024]: 135 row tiles of 64 in clusters of 4, five
    rounds of the 33 clusters that 132 SMs hold; 207,104 bytes of shared
    memory per CTA in bf16 (the full tier: 197,888, with a mid slice and
    two ring slots), 155,264 in fp32 (32-row tiles)."""
    plan = epi._epi_plan(1, 4, 8640, 0, 1024, torch.bfloat16, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 4, 64)
    assert plan.grid == (4 * 135, 1, 1) and plan.waves == 5
    assert plan.smem == 207104
    plan = epi._epi_plan(1, 4, 8640, 0, 1024, torch.float32, SMS)
    assert (plan.cluster, plan.tile, plan.smem) == (4, 32, 155264)


def _private_inputs(b, m, n, f, seed):
    """mid, and the parameters at the scales of test_torch_epilogue_plan."""
    rng = np.random.RandomState(seed)
    return ([rng.randn(b, m, n, f).astype(np.float32) * 0.5]
            + _inputs(1, m, 1, 8, f, seed)[3:])


def emulate_private(mid, w2, b2, ln_scale, ln_bias, ws, bs, plan,
                    ln_eps=1e-12):
    """The private tier: each tile's mid rows straight from memory, the
    output product summed over depth chunks of the kernel's KC (64 bf16 or
    32 fp32 values) in order, then the shared steps (c)-(d)."""
    dt = mid.dtype
    bsz, _, n, f = mid.shape
    kc = 64 if dt == torch.bfloat16 else 32
    chunks = [(lo, min(f, lo + kc)) for lo in range(0, f, kc)]
    return emulate_steps(lambda b, mode, rows: mid[b, mode, rows].float(),
                         chunks, w2, b2, ln_scale, ln_bias, ws, bs, plan,
                         bsz, n, dt, ln_eps)


# (B, M, N, F): two slices of 256 and 8 columns over two row tiles, one
# ragged; three slices, the last 88 columns wide; a single CTA
@pytest.mark.parametrize("b,m,n,f", [
    (2, 3, 100, 264),
    (1, 2, 70, 600),
    (1, 3, 40, 96),
], ids=["w256_8", "ragged_c3", "one_cta"])
def test_emulated_private_tier_equals_the_plain_version(b, m, n, f):
    args = [torch.from_numpy(x) for x in _private_inputs(b, m, n, f, seed=7)]
    plan = epi._epi_plan(b, m, n, 0, f, torch.float32, SMS)
    assert plan.cluster == -(-f // plan.width)
    out = emulate_private(*args, plan)
    ref = epi.fused_private_output_pool_plain(*args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_emulated_private_tier_matches_the_jax_kernel():
    """fp32 at the ragged two-slice shape, against JAX's
    fused_private_output_pool in interpret mode."""
    from segtran_tpu.kernels import expansion_epilogue as jepi
    b, m, n, f = 2, 3, 100, 264
    d = _private_inputs(b, m, n, f, seed=9)
    ref = np.asarray(jepi.fused_private_output_pool(
        *(jnp.asarray(x) for x in d), ln_eps=1e-12))
    plan = epi._epi_plan(b, m, n, 0, f, torch.float32, SMS)
    assert plan.cluster == 2
    out = emulate_private(*(torch.from_numpy(x) for x in d), plan)
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def _private_without_a_card(monkeypatch):
    """The private wrapper as on a CUDA tensor, with neither a library nor
    a plain version to run."""
    monkeypatch.setattr(epi, "_on_cpu", lambda t: False)
    monkeypatch.setattr(epi, "_lib", lambda: None)
    monkeypatch.setattr(epi, "_sm_count", lambda device: SMS)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(epi, "fused_private_output_pool_plain", refuse)


def _args(b, m, n, f, dtype=torch.float32):
    return [torch.zeros(b, m, n, f, dtype=dtype), torch.zeros(m, f, f),
            torch.zeros(m, f), torch.ones(f), torch.zeros(f),
            torch.zeros(f, 1), torch.zeros(1)]


@pytest.mark.parametrize("f", [2304, 60])
def test_cuda_private_wrapper_raises_on_a_width_it_does_not_take(
        monkeypatch, f):
    """F=2304 needs a cluster of 9 CTAs; F=60 is not a whole number of
    16-byte vectors of bf16 (8 values). Either raises ValueError naming the
    shape, before any launch."""
    _private_without_a_card(monkeypatch)
    launches = epi.fused_private_output_pool.launches
    with pytest.raises(ValueError, match=f"N=4, F={f}"):
        epi.fused_private_output_pool(*_args(1, 2, 4, f, torch.bfloat16))
    assert epi.fused_private_output_pool.launches == launches


@pytest.mark.parametrize("name", ["mid", "w2"])
def test_cuda_private_wrapper_raises_on_an_operand_off_a_16_byte_boundary(
        monkeypatch, name):
    """The kernel copies mid and W2 by 16-byte vectors: a contiguous view
    that starts 4 bytes off a 16-byte boundary raises ValueError naming the
    operand and its shape, before any launch."""
    _private_without_a_card(monkeypatch)
    args = _args(1, 2, 4, 64)
    at = {"mid": 0, "w2": 1}[name]
    t = args[at]
    args[at] = torch.zeros(t.numel() + 1)[1:].view(t.shape)   # 4 bytes off
    launches = epi.fused_private_output_pool.launches
    with pytest.raises(ValueError,
                       match=re.escape(f"({name} {tuple(t.shape)})")):
        epi.fused_private_output_pool(*args)
    assert epi.fused_private_output_pool.launches == launches


def test_cuda_private_wrapper_launches_once_at_the_plan(monkeypatch):
    """One call of epi_private_pool with mid, W2, the shape and the plan's
    row tile; one launch counted."""
    _private_without_a_card(monkeypatch)
    seen = []

    class Lib:
        def epi_private_pool(self, is_bf16, mid, w2, *rest):
            seen.append((is_bf16, mid, w2) + rest[6:11])
            return 0
    monkeypatch.setattr(epi, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    args = _args(2, 4, 100, 264, torch.bfloat16)
    launches = epi.fused_private_output_pool.launches
    out = epi.fused_private_output_pool(*args)
    assert out.shape == (2, 100, 264) and out.dtype == torch.bfloat16
    assert epi.fused_private_output_pool.launches == launches + 1
    (is_bf16, mid, w2, b, m, n, f, tile), = seen
    assert (is_bf16, mid, (b, m, n, f, tile)) == (
        1, args[0].data_ptr(), (2, 4, 100, 264, 64))
    assert w2 % 16 == 0


def test_ablation_edits_all_apply_to_the_source():
    """tools/ablate_epilogue.py builds variants of the kernel's source by
    text replacement: every text it replaces must still be in it."""
    from segtran_tpu_torch.tools import ablate_epilogue
    src = _build.source_text("expansion_epilogue")
    for name, edits in ablate_epilogue.VARIANTS.items():
        for old, _ in edits:
            assert old in src, f"variant '{name}': {old!r} not found"
