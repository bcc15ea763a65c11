"""The port's Modified3DUNet held against the JAX package on the CPU, with
the same seeded weights on both sides (tests/_torch_zoo.py), at a
non-cubic 32x48x16 volume:

* eval logits in fp32 (1e-4 of the largest magnitude) and in fp64 (1e-6):
  the residual context blocks, each ``norm_lrelu_conv_cN`` conv applied
  twice with the same weights (one conv per block in JAX's tree and in
  the port's state_dict, at the reference's index), the nearest upscales
  and the deep-supervision sum;
* train mode differs from eval only by the whole-channel dropout (p 0.6;
  instance norm has no running statistics): with it off the train logits
  equal the eval logits, with it on the masks are per (sample, channel)
  and repeat with the generator's seed;
* an input whose depth is a multiple of 8 but not of 16 is refused by
  both packages (the port with a ValueError naming the shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import assert_close, eval_outputs, load_pair
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 32, 48, 16, 4).astype(np.float32)


def _pair(dtype=None):
    from segtran_tpu.models.unet3d import Modified3DUNet as J
    from segtran_tpu_torch.models.unet3d import Modified3DUNet as T
    if dtype is None:
        return J(4, 3), T(4, 3)
    return J(4, 3, dtype=jnp.float64), T(4, 3, dtype=torch.float64)


def test_unet3d_eval_logits_match_jax():
    jm, tm = _pair()
    params, bstats = load_pair(jm, tm, X)
    assert not bstats
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert got[0].shape == (2, 32, 48, 16, 3)
    assert_close(got, ref)
    sd = tm.state_dict()
    # one conv per doubly-applied block, in both trees
    for lvl in ("c2", "c3", "c4", "c5"):
        assert list(params[f"norm_lrelu_conv_{lvl}"]) == ["kernel"]
        assert [k for k in sd if k.startswith(f"norm_lrelu_conv_{lvl}.")] \
            == [f"norm_lrelu_conv_{lvl}.2.weight"]
    assert "lrelu_conv_c1.1.weight" in sd
    assert "norm_lrelu_upscale_conv_norm_lrelu_l2.3.weight" in sd
    assert "conv_norm_lrelu_l4.0.weight" in sd
    assert not any(k.endswith("bias") for k in sd)
    assert len(sd) == len(jax.tree_util.tree_leaves(params)) == 26


def test_unet3d_fp64_matches_jax():
    jm, tm = _pair(torch.float64)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X, x64=True)
    assert_close(got, ref, rel=1e-6)


def test_unet3d_train_mode_is_eval_plus_channel_dropout():
    _, tm = _pair()
    torch.manual_seed(0)
    x = torch.from_numpy(X)
    with torch.no_grad():
        ev = tm.eval()(x)
        tm.train()
        tm.dropout.p = 0.0
        assert torch.equal(tm(x), ev)
        tm.dropout.p = 0.6
        tm.dropout.generator = torch.Generator().manual_seed(3)
        a = tm(x)
        tm.dropout.generator = torch.Generator().manual_seed(3)
        assert torch.equal(tm(x), a)
        assert not torch.allclose(a, ev)
        y = tm.dropout(torch.ones(128, 40, 2, 2, 2)).reshape(128, 40, -1)
    assert torch.equal(y.min(-1).values, y.max(-1).values)
    assert set(y[..., 0].unique().tolist()) == {0.0, float(1 / 0.4)}
    assert 0.35 < float((y[..., 0] > 0).float().mean()) < 0.45


def test_unet3d_refuses_depth_not_multiple_of_16():
    from segtran_tpu.models.unet3d import Modified3DUNet as J
    from segtran_tpu_torch.models.unet3d import Modified3DUNet as T
    x = np.zeros((1, 32, 32, 24, 4), np.float32)      # 24 % 8 == 0, % 16 != 0
    with pytest.raises(ValueError, match=r"\(1, 32, 32, 24, 4\)"):
        T(4, 3, base_n_filter=2)(torch.from_numpy(x))
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(J(4, 3, base_n_filter=2).init, jax.random.PRNGKey(0),
                       jnp.asarray(x))
