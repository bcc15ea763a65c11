"""The flash forward's launch plan (``_fwd_plan``), which the wrapper uses
to size the clusters, the grid, the key splits and the scratch, checked on
the CPU at the chip check's shapes in bf16 and fp32 for an H100's 132 SMs;
and a plain-PyTorch emulation of the kernel's decomposition (the plan's
key tiles and splits, partial scores per D slice summed in rank order, the
online rescale, the merge of the splits in split order) held against the
plain version and, at one ragged shape, the JAX package's Pallas kernel in
interpret mode."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtran_tpu_torch.kernels import squeezed_attention as sa
from _torch_parity import one_torch_thread  # noqa: F401

SMS = 132
# (G, Q, N, D, F): chip_smoke's FLASH_CASES (the BraTS whole-volume in- and
# out-squeeze at N=8640 and 18000, a ragged shape, a clamp case) and the
# two flash calls of layer 0 of the batch-8 --fused fundus forward
SHAPES = {"in-squeeze N=8640": (1, 1024, 8640, 1024, 1024),
          "out-squeeze N=8640": (4, 8640, 1024, 256, 1024),
          "in-squeeze N=18000": (1, 1024, 18000, 1024, 1024),
          "out-squeeze N=18000": (4, 18000, 1024, 256, 1024),
          "ragged": (3, 1000, 1333, 200, 264),
          "clamp": (1, 256, 512, 64, 64),
          "fundus in-squeeze": (8, 256, 1296, 1792, 1792),
          "fundus out-squeeze": (32, 1296, 256, 448, 1792)}
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
    plan = sa._fwd_plan(g, nq, n, d, f, DTYPES[dname], SMS)
    assert 1 <= plan.cluster <= 8
    assert len(plan.d_slices) == len(plan.f_slices) == plan.cluster
    # CTA c owns columns [c W, (c + 1) W): each column of D and F once
    assert _covered_once(plan.d_slices, d) and _covered_once(plan.f_slices, f)
    for c, sl in enumerate(plan.d_slices + plan.f_slices):
        assert sl is None or sl[0] == (c % plan.cluster) * plan.width
    # score halves where the cluster has two ranks per D slice
    n_d = sum(sl is not None for sl in plan.d_slices)
    assert plan.halves == (2 if 2 * n_d <= plan.cluster else 1)
    assert plan.smem <= 232448
    esize = 2 if dname == "bf16" else 4
    assert plan.tile * plan.width * esize == 16384
    assert plan.key_tile == 2 * plan.tile
    # the grid is whole clusters: one per (query tile, key split, G)
    assert plan.grid == (plan.cluster * -(-nq // plan.tile), plan.splits, g)
    assert plan.grid[0] % plan.cluster == 0
    # every key split holds at least one key tile, and they cover all
    n_tiles = -(-n // plan.key_tile)
    assert plan.split_tiles == -(-n_tiles // plan.splits)
    starts = [s * plan.split_tiles for s in range(plan.splits)]
    assert all(st < n_tiles for st in starts)
    assert plan.splits * plan.split_tiles >= n_tiles
    # scratch only where the splits are merged
    merged = plan.splits > 1
    assert plan.acc_scratch == (plan.splits * g * nq * f if merged else 0)
    assert plan.stats_scratch == (2 * plan.splits * g * nq if merged else 0)


def test_plan_at_the_path_shapes():
    """bf16: the in-squeeze at 160x192x144 takes clusters of 8 CTAs of 128
    columns, 64 x 128 cells and eight key splits of nine key tiles; the
    out-squeeze one split (540 query-tile clusters fill the card); the
    fundus in-squeeze clusters of 7 CTAs of 256 columns."""
    bf = torch.bfloat16
    plan = sa._fwd_plan(1, 1024, 8640, 1024, 1024, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile, plan.key_tile) == (128, 8,
                                                                    64, 128)
    assert plan.grid == (8 * 16, 8, 1) and plan.split_tiles == 9
    assert plan.smem == 227584
    plan = sa._fwd_plan(4, 8640, 1024, 256, 1024, bf, SMS)
    assert (plan.cluster, plan.splits, plan.acc_scratch) == (8, 1, 0)
    assert plan.halves == 2
    plan = sa._fwd_plan(8, 256, 1296, 1792, 1792, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 7, 32)


@pytest.mark.parametrize("d,f", [(4096, 1024), (1024, 2304), (2056, 8)])
def test_plan_refuses_a_cluster_above_eight(d, f):
    with pytest.raises(ValueError, match=f"D={d}, F={f}"):
        sa._fwd_plan(1, 1024, 8640, d, f, torch.bfloat16, SMS)


def test_cuda_wrapper_raises_on_a_shape_outside_the_plan(monkeypatch):
    """A CUDA tensor at a width the kernel does not take raises ValueError
    naming the shape; the plain version does not run."""
    monkeypatch.setattr(sa, "_on_cpu", lambda t: False)
    monkeypatch.setattr(sa, "_lib", lambda: None)
    monkeypatch.setattr(sa, "_sm_count", lambda device: SMS)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(sa, "fused_cross_attention_plain", refuse)
    q, k = torch.zeros(1, 4, 4096), torch.zeros(1, 8, 4096)
    v = torch.zeros(1, 8, 64)
    launches = sa.fused_cross_attention.launches
    with pytest.raises(ValueError, match="D=4096, F=64"):
        sa.fused_cross_attention(q, k, v, return_lse=True)
    assert sa.fused_cross_attention.launches == launches


def emulate_kernel(q, k, v, attn_clip, sm_scale, plan):
    """fwd_kernel's decomposition in plain PyTorch: per query tile and key
    split, per key tile, the partial scores of the plan's D slices summed
    in rank order, scaled and clipped; the running max m and sum l; p =
    exp(s - m_new) rounded to v.dtype; acc rescaled by alpha and p v added
    in fp32. One split: out = acc / l, lse = m + log l; more: the merge of
    fwd_merge_kernel in split order. Returns (out, lse [G, Q, 1])."""
    g, nq, _ = q.shape
    n, f = k.shape[1], v.shape[2]
    tb, tk = plan.tile, plan.key_tile
    n_tiles = -(-n // tk)
    d_slices = [sl for sl in plan.d_slices if sl is not None]
    out = torch.empty(g, nq, f, dtype=v.dtype)
    lse = torch.empty(g, nq, 1)
    for q0 in range(0, nq, tb):
        qt = q[:, q0:q0 + tb].float()
        parts = []
        for split in range(plan.splits):
            t0 = split * plan.split_tiles
            m = torch.full((g, qt.shape[1], 1), -math.inf)
            l = torch.zeros(g, qt.shape[1], 1)
            acc = torch.zeros(g, qt.shape[1], f)
            for t in range(t0, min(n_tiles, t0 + plan.split_tiles)):
                kt = k[:, t * tk:(t + 1) * tk].float()
                vt = v[:, t * tk:(t + 1) * tk]
                dot = sum(qt[..., a:b] @ kt[..., a:b].transpose(-1, -2)
                          for a, b in d_slices)
                s = (dot * sm_scale).clamp(-attn_clip, attn_clip)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(v.dtype).float() @ vt.float()
                m = m_new
            parts.append((m, l, acc))
        if len(parts) == 1:
            (m, l, acc), = parts
            o, ls = acc / l, m + torch.log(l)
        else:
            mx = parts[0][0]
            for m, _, _ in parts[1:]:
                mx = torch.maximum(mx, m)
            big_l, o = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
            for m, l, acc in parts:
                e = torch.exp(m - mx)
                big_l = big_l + l * e
                o = o + acc * e
            o, ls = o / big_l, mx + torch.log(big_l)
        out[:, q0:q0 + tb] = o.to(v.dtype)
        lse[:, q0:q0 + tb] = ls
    return out, lse


def _inputs(seed, g, nq, n, d, f, qk_scale):
    rng = np.random.RandomState(seed)
    return (rng.randn(g, nq, d).astype(np.float32) * qk_scale,
            rng.randn(g, n, d).astype(np.float32) * qk_scale,
            rng.randn(g, n, f).astype(np.float32))


# (G, Q, N, D, F, q/k scale, sms): ragged Q, N, D and F over clusters of 3
# CTAs with ten key splits (132 SMs) and one (a single SM); D and F of two
# 256-column slices; scores beyond the clip
@pytest.mark.parametrize("g,nq,n,d,f,qk,sms", [
    (2, 140, 333, 200, 264, 0.2, SMS),
    (2, 140, 333, 200, 264, 0.2, 1),
    (1, 40, 300, 1100, 520, 0.05, SMS),
    (1, 64, 200, 64, 64, 10.0, SMS),
], ids=["ragged_splits", "ragged_one_split", "w256", "clamp"])
def test_emulated_decomposition_equals_the_plain_version(g, nq, n, d, f, qk,
                                                         sms):
    qn, kn, vn = _inputs(1, g, nq, n, d, f, qk)
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    plan = sa._fwd_plan(g, nq, n, d, f, torch.float32, sms)
    assert (plan.splits > 1) == (sms == SMS)
    scale = 1.0 / math.sqrt(d)
    out, lse = emulate_kernel(q, k, v, 500.0, scale, plan)
    ref, ref_lse = sa.fused_cross_attention_plain(q, k, v, 500.0, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_emulated_decomposition_matches_the_jax_kernel():
    """fp32 at a ragged shape with key splits, against the Pallas kernel in
    interpret mode (the tolerance of test_torch_squeezed_attention.py)."""
    from segtran_tpu.kernels.squeezed_attention import fused_cross_attention
    g, nq, n, d, f = 2, 100, 130, 128, 256
    qn, kn, vn = _inputs(0, g, nq, n, d, f, 0.2)
    ref = np.asarray(fused_cross_attention(jnp.asarray(qn), jnp.asarray(kn),
                                           jnp.asarray(vn), interpret=True))
    plan = sa._fwd_plan(g, nq, n, d, f, torch.float32, SMS)
    assert plan.splits > 1
    out, _ = emulate_kernel(*(torch.from_numpy(x) for x in (qn, kn, vn)),
                            500.0, 1.0 / math.sqrt(d), plan)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
