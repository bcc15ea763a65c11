"""The unfactored output-FPN tail (training with out_fpn_do_dropout and a
hidden dropout above 0) held against JAX's unfactored tail on the CPU
with the same converted weights: Segtran3d with the interp and the conv
depth unpool (block order) and Segtran25d with the conv unpool
(interleaved order), in training mode. Both sides run every dropout at
p = 1e-9: JAX's keep probability rounds to 1 and the port's draw
(seeded) keeps every value, so the arithmetic, not the random stream, is
compared. Segtran3d computes in fp64 on both sides: in fp32 its
train-mode I3D (BatchNorm on batch statistics) moves the logits by ~1e-3
with the summation order alone, tail or no tail (see
tests/test_torch_i3d_vjp.py); Segtran25d runs in fp32. Then the port's
out-FPN dropout at p = 0.5, and one state_dict through both tails."""
import numpy as np
import pytest
import torch

from _torch_volume import ATOL, RTOL, model_pair, train_pair
from _torch_parity import one_torch_thread  # noqa: F401

P_TINY = 1e-9


def _models(kind, **kw):
    import segtran_tpu.configs.base as jb
    import segtran_tpu.models.segtran3d as j3
    import segtran_tpu.models.segtran25d as j25
    import segtran_tpu_torch.configs.base as tb
    from segtran_tpu_torch.models.segtran3d import Segtran3d
    from segtran_tpu_torch.models.segtran25d import Segtran25d
    import jax.numpy as jnp
    base = dict(num_classes=4, num_attractors=8, orig_in_channels=4,
                out_fpn_do_dropout=True, hidden_dropout_prob=P_TINY,
                attention_probs_dropout_prob=P_TINY, **kw)
    jdt = tdt = {}
    if kind == "3d":
        names, size = ("Segtran3dConfig", j3.Segtran3d, Segtran3d), (32, 32, 8)
        jdt, tdt = {"dtype": jnp.float64}, {"dtype": torch.float64}
    else:
        base["backbone_type"] = "eff-tiny"
        names, size = ("Segtran25dConfig", j25.Segtran25d, Segtran25d), (32, 32, 8)
    cname, jcls, tcls = names
    jcfg = getattr(jb, cname)(**base, **jdt).derive(
        translayer_compress_ratios=(1.0, 1.0))
    tcfg = getattr(tb, cname)(**base, **tdt).derive(
        translayer_compress_ratios=(1.0, 1.0))
    batch = 1 if kind == "3d" else 2
    x = np.random.RandomState(2).rand(batch, *size, 4).astype(np.float32)
    return model_pair(jcls, tcls, jcfg, tcfg, x.shape) + (x,)


@pytest.mark.parametrize("kind,upd", [("3d", "interp"), ("3d", "conv"),
                                      ("25d", "conv")])
def test_unfactored_tail_matches_jax_in_training(kind, upd, monkeypatch):
    import functools
    import segtran_tpu.models.segtran25d as j25
    # drop-connect draws from each package's own stream: off on both sides
    monkeypatch.setattr(j25, "EfficientNetFeatures", functools.partial(
        j25.EfficientNetFeatures, drop_connect_rate=0.0))
    jm, params, bstats, tm, x = _models(kind, out_fpn_upsampleD_scheme=upd)
    if kind == "25d":
        for blk in tm.backbone._blocks:
            blk.drop_rate = 0.0
    calls = []
    tm._unfactored_tail = (lambda f: lambda *a: calls.append(1) or f(*a))(
        tm._unfactored_tail)
    out, ref, _, _ = train_pair(jm, params, bstats, tm, x, x64=kind == "3d")
    assert calls == [1]
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_out_fpn_dropout_drops_and_one_state_dict_runs_both_tails():
    """At p = 0.5 the out-FPN dropout zeroes about half of its input in
    training and scales the rest by 2; with that dropout put in eval, the
    unfactored tail equals the factored one on the same parameters."""
    from segtran_tpu_torch.configs.base import Segtran3dConfig
    from segtran_tpu_torch.models.segtran3d import Segtran3d, init_segtran3d
    from segtran_tpu_torch.nn.attention import set_dropout_generator
    for upd in ("interp", "conv"):
        cfg = Segtran3dConfig(num_attractors=8, out_fpn_do_dropout=True,
                              hidden_dropout_prob=0.5,
                              out_fpn_upsampleD_scheme=upd).derive(
                                  translayer_compress_ratios=(1.0, 1.0))
        model = init_segtran3d(Segtran3d(cfg), seed=1)
        set_dropout_generator(model, torch.Generator().manual_seed(0))
        seen = []
        model.out_fpn_dropout.register_forward_hook(
            lambda m, i, o: seen.append((i[0], o)))
        with torch.no_grad():
            model.train()(torch.rand(1, 32, 32, 16, 4))
        (inp, out), = seen
        dropped = float((out == 0).float().mean())
        assert 0.45 < dropped < 0.55, dropped
        kept = out != 0
        torch.testing.assert_close(out[kept], 2 * inp[kept])

        g = torch.Generator().manual_seed(3)
        curr = torch.randn(1, 8, 16, 16, 832, generator=g)
        fused = torch.randn(1, 2, 4, 4, 1024, generator=g)
        model.out_fpn_dropout.eval()
        with torch.no_grad():
            a = model._unfactored_tail(curr, fused)
            b = model._factored_tail(curr, fused)
        assert a.shape == b.shape == (1, 16, 16, 16, 4)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
