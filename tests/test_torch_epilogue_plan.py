"""The full-fusion epilogue's launch plan (``_epi_plan``), which the
wrappers of ``fused_mid_output_pool`` and ``fused_mid_output_pool_permode``
use to size the clusters, the row tiles and the grid, checked on the CPU
at the chip check's shapes in bf16 and fp32 for an H100's 132 SMs; and a
plain-PyTorch emulation of ``mid_pool_kernel``'s decomposition (the plan's
row tiles, mid per column slice, the output product summed over the slices
in order, LayerNorm and score partials summed in rank order, the online
mode pool in mode order) held against the plain version and, at one small
ragged shape, the JAX package's Pallas kernels in interpret mode."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtran_tpu_torch.kernels import expansion_epilogue as epi
from _torch_parity import one_torch_thread  # noqa: F401

SMS = 132
# chip_smoke's full-fusion cases: B=8, M=4, N=1296, A=256 at the fundus
# flagship's three translayer widths
B, M, N, A = 8, 4, 1296, 256
WIDTHS = (1792, 896, 448)
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the tolerance of tests/test_torch_epilogue.py against the JAX kernels
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
def test_plan_fits_the_card_and_covers_every_row_and_column(f, dname):
    plan = epi._epi_plan(B, M, N, A, f, DTYPES[dname], SMS)
    assert 1 <= plan.cluster <= 8
    assert len(plan.slices) == plan.cluster
    # CTA c owns columns [c W, min(F, (c + 1) W)): each column of F once
    seen = np.zeros(f, int)
    for c, (lo, hi) in enumerate(plan.slices):
        assert lo == c * plan.width and 0 < hi - lo <= plan.width
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan.smem <= 232448
    # the mid slice [tile, W] is 32 KB in either dtype
    esize = 2 if dname == "bf16" else 4
    assert plan.tile * plan.width * esize == 32768
    # the grid is whole clusters, one per (image, row tile); every (b, row)
    # lies in exactly one tile, and no tile straddles two images
    assert plan.grid[0] % plan.cluster == 0 and plan.grid[1:] == (B, 1)
    tiles = plan.grid[0] // plan.cluster
    hits = np.zeros((B, N), int)
    for b in range(plan.grid[1]):
        for t in range(tiles):
            lo = t * plan.tile
            assert lo < N
            hits[b, lo:min(N, lo + plan.tile)] += 1
    assert (hits == 1).all()
    clusters_at_once = SMS // plan.cluster
    assert plan.waves == -(-B * tiles // clusters_at_once)


def test_plan_at_the_path_shapes():
    """bf16: 256-column slices and 64-row tiles at every width: clusters of
    7 CTAs at F=1792 (168 clusters), 4 at F=896, 2 at F=448 (the second
    slice 192 columns), 3 at a ragged F=600 (the last slice 88 columns);
    fp32: 32-row tiles."""
    bf = torch.bfloat16
    plan = epi._epi_plan(B, M, N, A, 1792, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 7, 64)
    assert plan.grid == (7 * 21, 8, 1) and plan.smem == 197888
    plan = epi._epi_plan(B, M, N, A, 896, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 4, 64)
    assert plan.grid == (4 * 21, 8, 1)
    plan = epi._epi_plan(B, M, N, A, 448, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 2, 64)
    assert plan.slices == ((0, 256), (256, 448))
    plan = epi._epi_plan(B, M, N, A, 600, bf, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 3, 64)
    assert plan.slices == ((0, 256), (256, 512), (512, 600))
    assert plan.grid == (3 * 21, 8, 1)
    plan = epi._epi_plan(B, M, N, A, 600, torch.float32, SMS)
    assert (plan.width, plan.cluster, plan.tile) == (256, 3, 32)
    assert plan.grid == (3 * 41, 8, 1)


@pytest.mark.parametrize("f", [2304, 4096, 2056])
def test_plan_refuses_a_cluster_above_eight(f):
    with pytest.raises(ValueError, match=f"F={f}"):
        epi._epi_plan(B, M, N, A, f, torch.bfloat16, SMS)


def _cuda_wrapper_without_a_card(monkeypatch):
    """The wrappers as on a CUDA tensor, with neither a library nor a plain
    version to run."""
    monkeypatch.setattr(epi, "_on_cpu", lambda t: False)
    monkeypatch.setattr(epi, "_lib", lambda: None)
    monkeypatch.setattr(epi, "_sm_count", lambda device: SMS)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    for name in ("fused_mid_output_pool_plain",
                 "fused_mid_output_pool_permode_plain"):
        monkeypatch.setattr(epi, name, refuse)


def _args(b, m, n, a, f, dtype=torch.float32):
    return [torch.zeros(b, m, n, a, dtype=dtype),
            torch.zeros(b, m, a, f, dtype=dtype), torch.zeros(f),
            torch.zeros(m, f, f), torch.zeros(m, f), torch.ones(f),
            torch.zeros(f), torch.zeros(f, 1), torch.zeros(1)]


@pytest.mark.parametrize("name", ["fused_mid_output_pool",
                                  "fused_mid_output_pool_permode"])
def test_cuda_wrapper_raises_on_a_shape_outside_the_plan(monkeypatch, name):
    """A CUDA tensor at a width the kernel does not take raises ValueError
    naming the shape; the plain version does not run."""
    _cuda_wrapper_without_a_card(monkeypatch)
    fn = getattr(epi, name)
    launches = fn.launches
    with pytest.raises(ValueError, match="F=2304"):
        fn(*_args(1, 1, 4, 8, 2304, torch.bfloat16))
    assert fn.launches == launches


def test_cuda_wrapper_raises_on_rows_of_a_partial_16_bytes(monkeypatch):
    """F must be a whole number of 16-byte vectors (8 bf16 values)."""
    _cuda_wrapper_without_a_card(monkeypatch)
    with pytest.raises(ValueError, match="F=60"):
        epi.fused_mid_output_pool(*_args(1, 2, 4, 48, 60, torch.bfloat16))


@pytest.mark.parametrize("name", ["probs", "vw1", "w2"])
def test_cuda_wrapper_raises_on_an_operand_off_a_16_byte_boundary(
        monkeypatch, name):
    """The kernel copies P, VW1 and W2 by 16-byte vectors: a contiguous
    view that starts off a 16-byte boundary raises ValueError naming it,
    before any launch."""
    _cuda_wrapper_without_a_card(monkeypatch)
    args = _args(1, 2, 4, 16, 64)
    at = {"probs": 0, "vw1": 1, "w2": 3}[name]
    t = args[at]
    args[at] = torch.zeros(t.numel() + 1)[1:].view(t.shape)   # 4 bytes off
    with pytest.raises(ValueError, match=name):
        epi.fused_mid_output_pool_permode(*args)


def test_cuda_wrapper_pads_a_ragged_a_with_zeros(monkeypatch):
    """A = 42 in bf16 (not whole 16-byte rows) reaches the kernel as A = 48,
    P's extra columns and VW1's extra rows zero."""
    _cuda_wrapper_without_a_card(monkeypatch)
    seen = {}

    class Lib:
        def epi_mid_pool(self, is_bf16, p, vw1, *rest):
            b, m, n, a, f = rest[8:13]
            seen.update(a=a, f=f, p=p, vw1=vw1)
            return 0
    monkeypatch.setattr(epi, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    pads = []
    real_pad = torch.nn.functional.pad

    def pad(t, widths):
        out = real_pad(t, widths)
        pads.append(out)
        return out
    monkeypatch.setattr(torch.nn.functional, "pad", pad)
    args = _args(1, 2, 4, 42, 64, torch.bfloat16)
    args[0] = torch.ones_like(args[0])
    args[1] = torch.ones_like(args[1])
    epi.fused_mid_output_pool(*args)
    assert seen["a"] == 48 and seen["f"] == 64
    p, v = pads
    assert (p.data_ptr(), v.data_ptr()) == (seen["p"], seen["vw1"])
    assert p.shape == (1, 2, 4, 48) and v.shape == (1, 2, 48, 64)
    assert (p[..., :42] == 1).all() and (p[..., 42:] == 0).all()
    assert (v[:, :, :42] == 1).all() and (v[:, :, 42:] == 0).all()


def emulate_steps(mid_tile, chunks, w2, b2, ln_scale, ln_bias, ws, bs,
                  plan, bsz, n, dt, ln_eps=1e-12):
    """Steps (b)-(d) of mid_pool_kernel in plain PyTorch, which both tiers
    share: per image and row tile of the plan, per mode, z of each column
    slice as the sum over the depth chunks in order of mid[:, chunk]
    W2[chunk, slice], rounded with b2; the LayerNorm sums and the score
    partials of the slices summed in rank order; l in T; the online softmax
    pool over the modes in mode order; out = pool / denominator rounded to
    T. mid_tile(b, mode, rows) gives the tile's mid [rows, F] (fp32 holding
    T values); chunks are (start, stop) depth ranges covering F."""
    def rnd(x):
        return x.to(dt).float()
    m, f = w2.shape[0], w2.shape[-1]
    w2, b2, scale, lnb = rnd(w2), rnd(b2), rnd(ln_scale), rnd(ln_bias)
    wsv, bsv = rnd(ws)[:, 0], bs.float().reshape(())
    sl = plan.slices
    out = torch.empty(bsz, n, f, dtype=dt)
    for b in range(bsz):
        for n0 in range(0, n, plan.tile):
            rows = slice(n0, min(n, n0 + plan.tile))
            run_max = denom = None
            pool = [None] * len(sl)
            for mode in range(m):
                mid = mid_tile(b, mode, rows)
                z = []
                for lo, hi in sl:
                    acc = torch.zeros(mid.shape[0], hi - lo)
                    for klo, khi in chunks:
                        acc = acc + mid[:, klo:khi] @ w2[mode, klo:khi, lo:hi]
                    z.append(rnd(rnd(acc) + b2[mode, lo:hi]))
                tot = sq = 0.0
                for zc in z:                       # rank order
                    tot = tot + zc.sum(-1)
                    sq = sq + (zc * zc).sum(-1)
                mean = tot / f
                var = torch.clamp(sq / f - mean * mean, min=0.0)
                mean_t = rnd(mean)[:, None]
                inv_t = rnd(1.0 / torch.sqrt(var + ln_eps))[:, None]
                ls, s = [], 0.0
                for (lo, hi), zc in zip(sl, z):
                    t = rnd(rnd(rnd(zc - mean_t) * inv_t) * scale[lo:hi])
                    ls.append(rnd(t + lnb[lo:hi]))
                    s = s + (ls[-1] * wsv[lo:hi]).sum(-1)
                s = s + bsv
                if mode == 0:
                    run_max, denom, pool = s, torch.ones_like(s), ls
                else:
                    nm = torch.maximum(run_max, s)
                    alpha, e = torch.exp(run_max - nm), torch.exp(s - nm)
                    denom = denom * alpha + e
                    run_max = nm
                    pool = [pc * alpha[:, None] + e[:, None] * lc
                            for pc, lc in zip(pool, ls)]
            out[b, rows] = (torch.cat(pool, -1) / denom[:, None]).to(dt)
    return out


def emulate_kernel(probs, vw1, b1, w2, b2, ln_scale, ln_bias, ws, bs, plan,
                   ln_eps=1e-12):
    """mid_pool_kernel's full tier in plain PyTorch: the mid slice of each
    CTA (gelu of the product rounded to T plus b1, rounded once), then
    steps (b)-(d) with the output product summed over the slices j in
    order (mid_j W2[slice j, slice c])."""
    dt = vw1.dtype
    bsz, _, n, _ = probs.shape

    def rnd(x):
        return x.to(dt).float()
    b1 = rnd(b1)

    def mid_tile(b, mode, rows):
        p = rnd(probs[b, mode, rows])
        v = rnd(vw1[b, mode])
        return torch.cat([epi._gelu_erf((rnd(p @ v[:, lo:hi]) + b1[lo:hi])
                                        .to(dt)).float()
                          for lo, hi in plan.slices], -1)
    return emulate_steps(mid_tile, plan.slices, w2, b2, ln_scale, ln_bias,
                         ws, bs, plan, bsz, n, dt, ln_eps)


def _inputs(b, m, n, a, f, seed):
    """The parameter scales of tests/test_torch_epilogue.py, fp32."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, m, n, a).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return [probs, rng.randn(b, m, a, f).astype(np.float32) * 0.3,
            rng.randn(f).astype(np.float32) * 0.1,
            rng.randn(m, f, f).astype(np.float32) * 0.05,
            rng.randn(m, f).astype(np.float32) * 0.1,
            rng.rand(f).astype(np.float32) + 0.5,
            rng.randn(f).astype(np.float32) * 0.1,
            rng.randn(f, 1).astype(np.float32) * 0.2,
            rng.randn(1).astype(np.float32)]


# (B, M, N, A, F): ragged N, A and F over clusters of 3 CTAs (the last
# slice 88 columns wide) and four row tiles; 3 CTAs, the last slice 8
# columns wide; a single CTA
@pytest.mark.parametrize("b,m,n,a,f", [
    (2, 3, 100, 40, 600),
    (1, 2, 70, 24, 520),
    (1, 3, 40, 16, 96),
], ids=["ragged_c3", "w256", "one_cta"])
def test_emulated_decomposition_equals_the_plain_version(b, m, n, a, f):
    args = [torch.from_numpy(x) for x in _inputs(b, m, n, a, f, seed=3)]
    plan = epi._epi_plan(b, m, n, a, f, torch.float32, SMS)
    assert plan.cluster == -(-f // plan.width)
    out = emulate_kernel(*args, plan)
    ref = epi.fused_mid_output_pool_plain(*args)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["fused_mid_output_pool",
                                  "fused_mid_output_pool_permode"])
def test_emulated_decomposition_matches_the_jax_kernels(name):
    """fp32 at a small ragged shape with two slices (256 and 8 columns),
    against each JAX full-fusion kernel in interpret mode."""
    from segtran_tpu.kernels import expansion_epilogue as jepi
    b, m, n, a, f = 2, 3, 100, 40, 264
    d = _inputs(b, m, n, a, f, seed=5)
    ref = np.asarray(getattr(jepi, name)(*(jnp.asarray(x) for x in d),
                                         ln_eps=1e-12))
    plan = epi._epi_plan(b, m, n, a, f, torch.float32, SMS)
    assert plan.cluster == 2
    out = emulate_kernel(*(torch.from_numpy(x) for x in d), plan)
    np.testing.assert_allclose(out.numpy(), ref, **F32)
