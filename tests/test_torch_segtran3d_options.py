"""The port's Segtran3d options held against the JAX package on the CPU
with the same converted weights (I3D, 8 attractors, one translayer, a
32x32x16 volume, fp32): the avgto3 bridge at 4 and 2 channels, dup3 at 1
channel, the no-out-FPN head and a non-unit ``input_scale``; and the
refusals of the bridges JAX refuses."""
import numpy as np
import pytest

from _torch_volume import ATOL, RTOL, eval_pair, model_pair
from _torch_parity import one_torch_thread  # noqa: F401

SIZE = (32, 32, 16)


def _cfgs(**kw):
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    from segtran_tpu_torch.configs.base import Segtran3dConfig as TCfg
    base = dict(num_classes=4, num_attractors=8, orig_in_channels=4,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    base.update(kw)
    return (JCfg(**base).derive(translayer_compress_ratios=(1.0, 1.0)),
            TCfg(**base).derive(translayer_compress_ratios=(1.0, 1.0)))


def _volume(channels):
    x = np.random.RandomState(1).rand(1, *SIZE, channels).astype(np.float32)
    x[:, :, :8] = 0.0            # a zero band: the nonzero mask drops tokens
    return x


@pytest.mark.parametrize("kw,model_kw", [
    ({"inchan_to3_scheme": "avgto3"}, {}),
    ({"inchan_to3_scheme": "dup3", "orig_in_channels": 1}, {}),
    ({"out_fpn_layers": (3, 4)}, {}),
    ({}, {"input_scale": (0.5, 0.75, 2.0)}),
], ids=["avgto3_4ch", "dup3_1ch", "no_out_fpn", "input_scale"])
def test_segtran3d_option_logits_match_jax(kw, model_kw):
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel
    jcfg, tcfg = _cfgs(**kw)
    x = _volume(jcfg.orig_in_channels)
    jm, params, bstats, tm = model_pair(JModel, TModel, jcfg, tcfg, x.shape,
                                        jkw=model_kw, tkw=model_kw)
    out, ref = eval_pair(jm, params, bstats, tm, x)
    assert out.shape == ref.shape == (1,) + SIZE + (4,)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_avgto3_two_channels():
    """avgto3 at 2 channels maps (c0, c1) to (c0, (c0 + c1) / 2, c1).
    JAX writes that matrix transposed ([3, 2]) and its product with a
    2-channel volume raises; the port's logits equal JAX's 3-channel model
    on the volume mapped by the reference's matrix."""
    import jax
    import jax.numpy as jnp
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel
    import torch
    from _torch_volume import fast_variables
    from _torch_parity import jvars
    jcfg2, tcfg2 = _cfgs(inchan_to3_scheme="avgto3", orig_in_channels=2)
    x = _volume(2)
    with pytest.raises(TypeError):
        jm2 = JModel(jcfg2)
        jax.eval_shape(jm2.init, jax.random.PRNGKey(0), jnp.asarray(x))
    jcfg3, _ = _cfgs(orig_in_channels=3)
    jm = JModel(jcfg3)
    params, bstats = fast_variables(jm, jnp.zeros(x.shape[:4] + (3,)),
                                    seed=3)
    rgb = x @ np.asarray([[1, 0.5, 0], [0, 0.5, 1]], np.float32)
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats),
                                       jnp.asarray(rgb)))
    tm = TModel(tcfg2)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    {"inchan_to3_scheme": "only1"},
    {"inchan_to3_scheme": "avgto3", "orig_in_channels": 3 + 2},
    {"inchan_to3_scheme": "dup3", "orig_in_channels": 2},
], ids=["only1", "avgto3_5ch", "dup3_2ch"])
def test_unsupported_bridges_raise(kw):
    """JAX raises ValueError for these schemes (segtran3d.py:55-60), and so
    does the port, at construction."""
    from segtran_tpu_torch.models.segtran3d import Segtran3d
    _, tcfg = _cfgs(**kw)
    with pytest.raises(ValueError):
        Segtran3d(tcfg)
