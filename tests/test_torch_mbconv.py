"""The port's mbconv_front (its plain version: the tensors lie on the CPU)
held against the JAX package's Pallas kernel in interpret mode, and the
port's EfficientNetFeatures(fused_eval=True) against JAX's fused backbone
and against the port's unfused one, at a size where the gate fires."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401


def _case(k, stride, expand, seed):
    """The JAX test's inputs (tests/test_mbconv_fused.py) as numpy: x
    [2, 12, 20, 8], TF-SAME pads of the runtime size."""
    rng = np.random.RandomState(seed)
    b, h, w, cin = 2, 12, 20, 8
    cexp = cin * (6 if expand else 1)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    w_dw = (rng.randn(k, k, cexp) * 0.2).astype(np.float32)
    s1 = (rng.rand(cexp) + 0.5).astype(np.float32)
    b1 = (rng.randn(cexp) * 0.1).astype(np.float32)
    pad_h = max((-(h // -stride) - 1) * stride + k - h, 0)
    pad_w = max((-(w // -stride) - 1) * stride + k - w, 0)
    pad = ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))
    if expand:
        w_exp = (rng.randn(cin, cexp) * 0.2).astype(np.float32)
        s0 = (rng.rand(cexp) + 0.5).astype(np.float32)
        b0 = (rng.randn(cexp) * 0.1).astype(np.float32)
    else:
        w_exp = s0 = b0 = None
    return [x, w_exp, s0, b0, w_dw, s1, b1], pad


def _both(args, k, stride, pad, jdt, tdt):
    """(JAX interpret-mode results, the port's results) as fp32 numpy;
    x and the two weights in the compute type, BN affines fp32."""
    from segtran_tpu.kernels.mbconv import mbconv_front as jax_front
    from segtran_tpu_torch.kernels.mbconv import mbconv_front
    typed = {0, 1, 4}
    jargs = [None if a is None else
             jnp.asarray(a, jdt if i in typed else jnp.float32)
             for i, a in enumerate(args)]
    targs = [None if a is None else
             torch.from_numpy(a).to(tdt if i in typed else torch.float32)
             for i, a in enumerate(args)]
    jdw, jse = jax_front(*jargs, kernel=k, stride=stride, pad=pad,
                         interpret=True)
    tdw, tse = mbconv_front(*targs, kernel=k, stride=stride, pad=pad)
    assert tdw.dtype == tdt and tse.dtype == torch.float32
    assert tuple(tdw.shape) == jdw.shape and tuple(tse.shape) == jse.shape
    return ((np.asarray(jdw, np.float32), np.asarray(jse)),
            (tdw.float().numpy(), tse.numpy()))


@pytest.mark.parametrize("k,stride,expand", [
    (3, 1, True), (3, 2, True), (5, 1, True), (5, 2, True), (3, 1, False),
])
def test_plain_mbconv_front_matches_jax_interpret(k, stride, expand):
    """fp32: both sum the same products in other orders; 1e-5."""
    args, pad = _case(k, stride, expand, seed=k * 10 + stride)
    (jdw, jse), (tdw, tse) = _both(args, k, stride, pad, jnp.float32,
                                   torch.float32)
    np.testing.assert_allclose(tdw, jdw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tse, jse, rtol=1e-5, atol=1e-5)


def test_plain_mbconv_front_matches_jax_interpret_bf16():
    """bf16 x and weights: both round the expanded tensor and the output to
    bf16 at the same points, but their fp32 sums run in other orders, which
    can move a value across a bf16 rounding boundary: at most one bf16 ulp
    (2^-8 relative) of the output, carried once through the depthwise
    taps. The SE mean is taken over fp32 values on both sides."""
    args, pad = _case(5, 1, True, seed=51)
    (jdw, jse), (tdw, tse) = _both(args, 5, 1, pad, jnp.bfloat16,
                                   torch.bfloat16)
    err = np.abs(tdw - jdw) / (1.0 + np.abs(jdw))
    assert err.max() <= 2 ** -7, err.max()
    assert np.abs(tdw - jdw).mean() <= 1e-3
    np.testing.assert_allclose(tse, jse, rtol=2e-3, atol=2e-3)


def test_fold_bn_matches_jax():
    """Equal up to the last bit of XLA's and PyTorch's rsqrt."""
    from segtran_tpu.kernels.mbconv import fold_bn as jfold
    from segtran_tpu_torch.kernels.mbconv import fold_bn
    rng = np.random.RandomState(5)
    scale, bias, mean = (rng.randn(3, 16) * 0.5).astype(np.float32)
    var = rng.rand(16).astype(np.float32) + 0.1
    want = jfold(*(jnp.asarray(a) for a in (scale, bias, mean, var)), 1e-3)
    got = fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean, var)),
                  1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-7,
                                   atol=1e-7)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_fused_eval_backbone_matches_jax_and_unfused(monkeypatch):
    """eff-b0 at stem stride 1 and 72^2: segment 1's second block runs at
    H = 36, inside the gate (stride 1, an expand, 36 <= H <= 144). fp32
    against JAX's fused backbone (Pallas in interpret mode) to the 1e-4 of
    the whole-model parity tests, and against the port's unfused backbone
    to 1e-5 (in fp32 the two paths differ only in summation order)."""
    import segtran_tpu.kernels.mbconv as jmb
    from segtran_tpu.nn.backbones.efficientnet import (
        EfficientNetFeatures as JNet)
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.backbones import efficientnet as teff

    jcalls = _count_calls(monkeypatch, jmb, "mbconv_front")
    tcalls = _count_calls(monkeypatch, teff, "mbconv_front")
    x = np.random.RandomState(0).randn(1, 72, 72, 3).astype(np.float32)
    jnet = JNet(variant="eff-b0", stem_stride=1, fused_eval=True)
    params, bstats = jax_variables(jnet, jnp.zeros((1, 72, 72, 3)), seed=3)
    jcalls.clear()                     # the init traced the fused path too
    ref = jnet.apply(jvars(params, bstats), jnp.asarray(x))
    assert len(jcalls) == 1

    sd = state_dict_from_jax(params, bstats)
    fused = teff.EfficientNetFeatures("eff-b0", stem_stride=1,
                                      fused_eval=True)
    plain = teff.EfficientNetFeatures("eff-b0", stem_stride=1)
    assert {k: v.shape for k, v in fused.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    fused.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = fused.eval()(torch.from_numpy(x))
        assert len(tcalls) == 1
        unfused = plain.eval()(torch.from_numpy(x))
    assert len(tcalls) == 1 and len(got) == len(ref) == 5
    for g, r, u in zip(got, ref, unfused):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_fused_eval_leaves_training_alone(monkeypatch):
    """In training the fused flag changes nothing: the kernel is eval-only
    (JAX: ``not train`` in the gate)."""
    from segtran_tpu_torch.nn.backbones import efficientnet as teff
    calls = _count_calls(monkeypatch, teff, "mbconv_front")
    torch.manual_seed(0)
    fused = teff.EfficientNetFeatures("eff-b0", stem_stride=1,
                                      drop_connect_rate=0.0, fused_eval=True)
    plain = teff.EfficientNetFeatures("eff-b0", stem_stride=1,
                                      drop_connect_rate=0.0)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 72, 72, 3)
    for a, b in zip(fused.train()(x), plain.train()(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not calls
