"""The port's parameter and FLOP counting, throughput and traces
(``tools/flops.py``) and prediction post-processing (``tools/postproc.py``)
on the CPU:

* ``remove_fragmentary_segs`` equal to JAX's, exactly, on seeded masks of
  0, 1, 2 and 5 components (uint8 and int32);
* ``count_params`` equal to JAX's on the same tiny Segtran2d;
* ``estimate_flops`` equal to the analytic count of a conv + linear net,
  and its bytes to the operands' and results' bytes;
* the kernels count in full: a tiny Segtran2d counts the same FLOPs with
  --fusedepi as without; with --fused --fusedepi it counts what the same
  route counts with each kernel's plain version in its place; and with
  the unfused attention's reassociation off (the folds of Q and K into
  the scores, which the flash route does not make) the fused and unfused
  routes count the same FLOPs, within 1%;
* ``measure_fps`` > 0 and ``profile_trace`` writes a trace file.
"""
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_tools import segtran2d_pair


def _mask(n_blobs, seed, dtype):
    rng = np.random.RandomState(seed)
    m = np.zeros((40, 48), dtype)
    for i in range(n_blobs):
        r, c = 2 + 9 * (i % 4), 3 + 22 * (i // 4)
        h, w = rng.randint(2, 7, 2)
        m[r:r + h, c:c + w] = rng.randint(1, 4)
    if n_blobs == 2:
        m[20, 20] = 2                      # a diagonal neighbour joins
        m[21, 21] = 1
    return m


@pytest.mark.parametrize("n_blobs", [0, 1, 2, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_remove_fragmentary_segs_equals_jax(n_blobs, dtype):
    from segtran_tpu.tools.postproc import remove_fragmentary_segs as jfn
    from segtran_tpu_torch.tools.postproc import remove_fragmentary_segs
    m = _mask(n_blobs, n_blobs, dtype)
    got, want = remove_fragmentary_segs(m), jfn(m)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if n_blobs == 5:
        assert (got > 0).sum() < (m > 0).sum()
    elif n_blobs <= 1:
        assert got is m


def test_count_params_equals_jax():
    from segtran_tpu.tools.flops import count_params as jcount
    from segtran_tpu_torch.tools.flops import count_params
    _, params, _, tm = segtran2d_pair()
    assert count_params(tm) == jcount(params) > 0


def test_estimate_flops_is_the_analytic_count():
    from segtran_tpu_torch.tools.flops import estimate_flops
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                              torch.nn.Flatten(),
                              torch.nn.Linear(8 * 16 * 16, 10))
    x = torch.randn(2, 3, 16, 16)
    got = estimate_flops(net, x)
    conv = 2 * 2 * (8 * 3 * 3 * 3) * (16 * 16)
    linear = 2 * 2 * (8 * 16 * 16) * 10
    assert got["flops"] == conv + linear
    # conv: x, w, b, y; linear: y (viewed), W, b, out
    y = 2 * 8 * 16 * 16 * 4
    want = (x.nbytes + 8 * 27 * 4 + 8 * 4 + y) + (y + 2048 * 10 * 4
                                                  + 10 * 4 + 2 * 10 * 4)
    assert got["bytes"] >= want


def _count(tm, x, plain=False, monkeypatch=None):
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    from segtran_tpu_torch.nn import attention
    from segtran_tpu_torch.tools.flops import estimate_flops
    if plain:
        def flash(q, k, v, attn_clip=500.0, sm_scale=None):
            return sa.fused_cross_attention_plain(q, k, v, attn_clip,
                                                  sm_scale)[0]
        monkeypatch.setattr(attention, "fused_cross_attention", flash)
        monkeypatch.setattr(attention, "fused_cross_attention_trainable",
                            flash)
        for name in ("fused_mid_output_pool", "fused_mid_output_pool_permode",
                     "fused_private_output_pool"):
            monkeypatch.setattr(epi, name, getattr(epi, name + "_plain"))
    return estimate_flops(tm.eval(), x)["flops"]


@pytest.mark.parametrize("reassociate", [True, False])
def test_fused_routes_count_their_kernels(reassociate, monkeypatch):
    x = torch.from_numpy(
        np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32))
    kw = dict(reassociate=reassociate)
    unfused = _count(segtran2d_pair(**kw)[3], x)
    epi_only = _count(segtran2d_pair(use_fused_epilogue=True, **kw)[3], x)
    assert abs(epi_only - unfused) <= 0.01 * unfused
    tm = segtran2d_pair(use_fused_attention=True, use_fused_epilogue=True,
                        **kw)[3]
    fused = _count(tm, x)
    if reassociate:
        # the flash route computes the projections the folds skip
        assert fused > 1.01 * unfused
    else:
        assert abs(fused - unfused) <= 0.01 * unfused
    assert fused == _count(tm, x, plain=True, monkeypatch=monkeypatch)
    # and the kernels' own ops ran in the counted forward
    monkeypatch.undo()
    seen = []
    for op in ("flash_fwd", "epi_mid_pool", "epi_private_pool"):
        packet = getattr(torch.ops.segtran_tpu_torch, op)
        monkeypatch.setattr(torch.ops.segtran_tpu_torch, op,
                            lambda *a, _p=packet, _n=op: (seen.append(_n),
                                                          _p(*a))[1])
    _count(tm, x)
    assert "flash_fwd" in seen and {"epi_mid_pool",
                                    "epi_private_pool"} & set(seen)


def test_measure_fps_and_profile_trace(tmp_path):
    from segtran_tpu_torch.tools.flops import measure_fps, profile_trace
    net = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8)
    assert measure_fps(net, x, iters=4, warmup=1) > 0
    with profile_trace(str(tmp_path / "trace")):
        net(x)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert files[0].stat().st_size > 0
