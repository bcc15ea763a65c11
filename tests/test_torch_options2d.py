"""The port's Segtran2d under the model options of the Segtran paper's
ablations, held against the JAX package on the CPU (eff-tiny, 64^2,
fp32, the same perturbed, converted weights; logits to 1e-4):
the non-squeezed encoder (alone, with the sliding position biases, and
with --fused --fusedepi against JAX's fused path), --multihead, the shared
FFN output, the rand and sinu position codes, BatchNorm in the in-FPN (eval
on perturbed statistics; a train-mode forward whose running statistics
move as JAX's do), the learned global bias, both no-out-FPN heads and two
modalities; the squeezed layers' refusal of position biases; the
transposed head's conversion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_options import (ATOL, RTOL, _configs, _eval_pair, _input_shape,
                            _pair)
from _torch_parity import jvars, to_numpy
from _torch_parity import one_torch_thread  # noqa: F401

OPTIONS = {
    "nosqueeze": dict(use_squeezed_transformer=False),
    "nosqueeze+bias": dict(use_squeezed_transformer=False,
                           pos_code_type="bias", pos_bias_radius=2),
    "multihead": dict(ablate_multihead=True),
    "shared_output": dict(trans_output_type="shared"),
    "pos_rand": dict(pos_code_type="rand"),
    "pos_sinu": dict(pos_code_type="sinu"),
    "inbn": dict(in_fpn_use_bn=True),
    "gbias": dict(use_global_bias=True),
    "head_1x1": dict(in_fpn_layers=(2, 3, 4), out_fpn_layers=(2, 3, 4)),
    "head_transposed": dict(out_fpn_layers=(3, 4)),
    "modalities2": dict(num_modalities=2),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_logits_match_jax(option):
    jm, params, bstats, tm = _pair(**OPTIONS[option])
    x = np.random.RandomState(0).randn(
        *_input_shape(tm.cfg)).astype(np.float32)
    out, ref = _eval_pair(jm, params, bstats, tm, x)
    assert out.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_inbn_train_forward_matches_jax(monkeypatch):
    """A train-mode forward (BatchNorm on the batch's statistics, dropout
    and drop-connect 0): the logits, and every running statistic after
    JAX's update (momentum 0.9, biased variance)."""
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from segtran_tpu_torch.convert import state_dict_from_jax
    monkeypatch.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    jm, params, bstats, tm = _pair(**OPTIONS["inbn"])
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ref, upd = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(jvars(params, bstats),
                                                   jnp.asarray(x))
    for blk in tm.backbone._blocks:
        blk.drop_rate = 0.0
    tm.train()
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    want = state_dict_from_jax({}, to_numpy(upd["batch_stats"]))
    sd = tm.state_dict()
    assert any(k.startswith("in_bn4b.") for k in want)
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_nosqueeze_fused_matches_jax_fused():
    """--nosqueeze --fused --fusedepi: the self-attention through the
    flash branch and the private-tier epilogue (their plain versions on the
    CPU) against JAX's fused path (Pallas in interpret mode)."""
    jm, params, bstats, tm = _pair(
        seed=7, use_squeezed_transformer=False, use_fused_attention=True,
        use_fused_epilogue=True)
    x = np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32)
    out, ref = _eval_pair(jm, params, bstats, tm, x)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_squeezed_bias_is_refused():
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    _, tcfg = _configs(pos_code_type="bias")
    with pytest.raises(ValueError, match="Squeezed transformer cannot use"):
        Segtran2d(tcfg)


def test_transposed_head_conversion_flips_the_kernel():
    """flax ConvTranspose kernel [kh, kw, I, O] == torch conv_transpose2d
    with weight kernel[::-1, ::-1] as [I, O, kh, kw] (the rule in
    convert.py), on a random 5x6 input; the unflipped kernel does not."""
    import flax.linen as fnn
    from segtran_tpu_torch.convert import state_dict_from_jax
    rng = np.random.RandomState(5)
    x = rng.randn(1, 5, 6, 4).astype(np.float32)
    conv = fnn.ConvTranspose(3, (2, 2), strides=(2, 2))
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kern = rng.randn(2, 2, 4, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    ref = np.asarray(conv.apply({"params": {"kernel": kern, "bias": bias}},
                                jnp.asarray(x)))
    sd = state_dict_from_jax({"out_conv": {"kernel": kern, "bias": bias}})
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), sd["out_conv.weight"],
        sd["out_conv.bias"], stride=2).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, 10, 12, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    unflipped = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kern.transpose(2, 3, 0, 1).copy()),
        torch.from_numpy(bias), stride=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - ref).max() > 0.1
    assert v["params"]["kernel"].shape == kern.shape


def test_unknown_leaf_still_raises():
    from segtran_tpu_torch.convert import state_dict_from_jax
    with pytest.raises(ValueError, match="no conversion rule"):
        state_dict_from_jax({"vfeat": {"table": np.zeros(3, np.float32)}})
