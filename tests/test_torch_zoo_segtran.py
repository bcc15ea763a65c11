"""Segtran on the zoo's backbones, held against the JAX package on the CPU,
and the kernel path of ``--bb resnet101``.

* Segtran2d on ResNet-34 (``bb_feat_upsize``: the stem pool dropped) and
  on EfficientNetV2-S, one translayer, 8 attractors, at 64x96: eval
  logits to 1e-4 of their largest magnitude, the same seeded weights on
  both sides (tests/_torch_zoo.py);
* Segtran25d on ResNet-34 (4 modalities, stemconv: the ResNet stem takes
  the 4 channels) at 32x32x4: eval logits;
* resnet18 / resnet152 (no Segtran widths in JAX either) are refused with
  a clear error;
* the flagship recipe on ResNet-101 (translayers 2048 -> 2048 -> 1024 ->
  512, 4 modes, 256 attractors, bf16) at 288^2: the functions each layer's
  epilogue calls with --fusedepi and with --fused --fusedepi, recorded on
  the CPU (2 per-mode + 1 all-modes; 6 flash forwards + 2 private tiers,
  F = 2048 through the modules), each route against JAX's own gates
  (per-mode at F = 2048 sits exactly on its 9 MiB budget), and the
  cluster plans of both kernels at the path's shapes (8 CTAs of 256
  columns at D = F = 2048).
"""
import numpy as np
import pytest
import torch

from _torch_zoo import assert_close, eval_outputs, load_pair
from _torch_parity import one_torch_thread  # noqa: F401

SMS = 132


def _seg2d_pair(bb):
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    from segtran_tpu_torch.models.segtran2d import Segtran2d as TModel
    kw = dict(backbone_type=bb, num_classes=3, num_attractors=8,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ratios = (1.0, 2.0)
    return (JModel(JCfg(**kw).derive(translayer_compress_ratios=ratios)),
            TModel(TCfg(**kw).derive(translayer_compress_ratios=ratios),
                   patch_size=(64, 96)))


@pytest.mark.parametrize("bb", ["resnet34", "effv2s"])
def test_segtran2d_backbone_logits_match_jax(bb):
    jm, tm = _seg2d_pair(bb)
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    params, bstats = load_pair(jm, tm, x)
    got, ref = eval_outputs(jm, params, bstats, tm, x)
    assert got[0].shape == (2, 64, 96, 3)
    assert_close(got, ref)


def test_segtran25d_resnet_logits_match_jax():
    from segtran_tpu.configs.base import Segtran25dConfig as JCfg
    from segtran_tpu.models.segtran25d import Segtran25d as JModel
    from segtran_tpu_torch.configs.base import Segtran25dConfig as TCfg
    from segtran_tpu_torch.models.segtran25d import Segtran25d as TModel
    kw = dict(backbone_type="resnet34", num_attractors=8,
              inchan_to3_scheme="stemconv", hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    jm = JModel(JCfg(**kw).derive(translayer_compress_ratios=(1.0, 1.0)))
    tm = TModel(TCfg(**kw).derive(translayer_compress_ratios=(1.0, 1.0)),
                patch_size=(32, 32, 4))
    x = np.random.RandomState(1).randn(1, 32, 32, 4, 4).astype(np.float32)
    params, bstats = load_pair(jm, tm, x)
    assert tm.backbone.conv1.weight.shape[1] == 4
    got, ref = eval_outputs(jm, params, bstats, tm, x)
    assert_close(got, ref)


@pytest.mark.parametrize("bb", ["resnet18", "resnet152"])
def test_segtran_refuses_a_backbone_without_widths(bb):
    from segtran_tpu_torch.cli import train2d
    args = train2d.build_argparser().parse_args(["--bb", bb,
                                                 "--device", "cpu"])
    with pytest.raises(ValueError, match=f"no feature widths for backbone "
                                         f"'{bb}'"):
        train2d.build_model_and_config(args, train2d.task_settings(args))


def _jax_route(tier, m, a, f, itemsize):
    from segtran_tpu.kernels import expansion_epilogue as jepi
    if tier == "mid":
        if jepi.supports_full(m, a, f, itemsize):
            return "all_modes"
        if jepi.supports_permode(a, f, itemsize):
            return "per_mode"
    return "private" if jepi.supports(m, f, itemsize) else "unfused"


@pytest.fixture(scope="module")
def resnet101_calls():
    """{flags: [(function, shapes)]} of one bs-1 bf16 forward of the
    recipe on ResNet-101 through test2d's factory, recorded at the
    kernels' wrappers (their plain versions run on the CPU)."""
    import segtran_tpu_torch.nn.attention as att
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    mp = pytest.MonkeyPatch()
    calls = []
    flash = att.fused_cross_attention

    def rec_flash(q, k, v, *a, **kw):
        calls.append(("flash", tuple(q.shape), tuple(k.shape),
                      tuple(v.shape)))
        return flash(q, k, v, *a, **kw)
    mp.setattr(att, "fused_cross_attention", rec_flash)
    for name in ("fused_mid_output_pool", "fused_mid_output_pool_permode",
                 "fused_private_output_pool"):
        def rec(*a, _f=getattr(epi, name), _n=name, **kw):
            calls.append((_n, tuple(a[0].shape), tuple(a[1].shape)))
            return _f(*a, **kw)
        mp.setattr(epi, name, rec)
    out = {}
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 288, 288, 3)
                         .astype(np.float32))
    try:
        for extra in (("--fusedepi",), ("--fused", "--fusedepi")):
            args = test2d.build_argparser().parse_args(
                ["--bb", "resnet101", "--translayers", "3", "--layercompress",
                 "1,1,2,2", "--bf16", "--cpdir", "x", "--device", "cpu",
                 *extra])
            model, cfg = test2d.build_model(args, train2d.task_settings(args))
            assert cfg.translayer_dims == (2048, 2048, 1024, 512)
            init_with_reference_schemes(model, cfg, seed=0)
            calls.clear()
            with torch.inference_mode():
                y = model.eval()(x)
            assert y.shape == (1, 288, 288, 3) and torch.isfinite(y).all()
            out[extra] = list(calls)
    finally:
        mp.undo()
    return out


def test_resnet101_fusedepi_path(resnet101_calls):
    calls = resnet101_calls[("--fusedepi",)]
    assert [(c[0], c[2][-1]) for c in calls] == [
        ("fused_mid_output_pool_permode", 2048),
        ("fused_mid_output_pool_permode", 1024),
        ("fused_mid_output_pool", 512)]
    assert all(c[1] == (1, 4, 1296, 256) for c in calls)
    for f, want in ((2048, "per_mode"), (1024, "per_mode"),
                    (512, "all_modes")):
        assert _jax_route("mid", 4, 256, f, 2) == want
    # F = 2048 sits exactly on JAX's budget: (F^2 + 256 F) * 2 bytes
    from segtran_tpu.kernels.expansion_epilogue import W2_VMEM_BUDGET
    assert (2048 ** 2 + 256 * 2048) * 2 == W2_VMEM_BUDGET


def test_resnet101_fused_path(resnet101_calls):
    calls = resnet101_calls[("--fused", "--fusedepi")]
    flash = [c[1:] for c in calls if c[0] == "flash"]
    assert flash == [
        ((1, 256, 2048), (1, 1296, 2048), (1, 1296, 2048)),
        ((4, 1296, 512), (4, 256, 512), (4, 256, 2048)),
        ((1, 256, 2048), (1, 1296, 2048), (1, 1296, 2048)),
        ((4, 1296, 512), (4, 256, 512), (4, 256, 1024)),
        ((1, 256, 1024), (1, 1296, 1024), (1, 1296, 1024)),
        ((4, 1296, 256), (4, 256, 256), (4, 256, 512))]
    private = [c[1] for c in calls if c[0] == "fused_private_output_pool"]
    assert private == [(1, 4, 1296, 1024), (1, 4, 1296, 512)]
    # the F = 2048 layer's private tier is refused by JAX's gate and lies
    # beyond the W2 the card measured: the modules run it
    from segtran_tpu_torch.kernels.expansion_epilogue import epilogue_route
    for f, want in ((2048, "unfused"), (1024, "private"), (512, "private")):
        assert epilogue_route("private", 4, 0, f, torch.bfloat16) == want
        assert _jax_route("private", 4, 0, f, 2) == want


@pytest.mark.parametrize("dname", ["bf16", "fp32"])
def test_resnet101_kernel_plans(dname):
    """At batch 8: both kernels take D = F = 2048 as one cluster of 8 CTAs
    of 256 columns, within a CTA's shared memory; the out-squeeze at D =
    512 gives only 2 of the 8 CTAs a D slice (two score halves)."""
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    dt = torch.bfloat16 if dname == "bf16" else torch.float32
    plan = sa._fwd_plan(8, 256, 1296, 2048, 2048, dt, SMS)
    assert (plan.width, plan.cluster) == (256, 8)
    assert all(sl is not None for sl in plan.d_slices + plan.f_slices)
    plan = sa._fwd_plan(32, 1296, 256, 512, 2048, dt, SMS)
    assert (plan.width, plan.cluster, plan.halves) == (256, 8, 2)
    assert sum(sl is not None for sl in plan.d_slices) == 2
    for g, nq, n, d, f in ((8, 256, 1296, 1024, 1024),
                           (32, 1296, 256, 512, 1024),
                           (32, 1296, 256, 256, 512)):
        plan = sa._fwd_plan(g, nq, n, d, f, dt, SMS)
        assert plan.smem <= 232448
    for a, f in ((256, 2048), (256, 1024), (256, 512), (0, 1024), (0, 512)):
        plan = epi._epi_plan(8, 4, 1296, a, f, dt, SMS)
        assert plan.cluster == -(-f // 256) and plan.smem <= 232448
    assert epi._epi_plan(8, 4, 1296, 256, 2048, dt, SMS).cluster == 8
