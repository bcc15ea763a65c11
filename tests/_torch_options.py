"""Shared pieces of the tests that hold the port's Segtran2d options
against the JAX package (tests/test_torch_options2d*.py): configs of a
tiny eff-tiny Segtran2d in both packages, a model pair on the same
perturbed, converted weights, and their eval forwards."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jax_variables, jvars

# as tests/test_torch_segtran2d.py: fp32 sums reorder between XLA and
# PyTorch, so logits agree to ~1e-5 relative
RTOL, ATOL = 1e-4, 1e-4


def _configs(**kw):
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    kw = dict(dict(backbone_type="eff-tiny", num_classes=3,
                   num_attractors=8, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0), **kw)
    ratios = (1.0, 1.0, 2.0)
    return (JCfg(**kw).derive(translayer_compress_ratios=ratios),
            TCfg(**kw).derive(translayer_compress_ratios=ratios))


def _input_shape(cfg, batch=2, size=(64, 64)):
    shape = (batch,) + size + (3,)
    return shape + ((cfg.num_modalities,) if cfg.num_modalities else ())


def _pair(seed=3, size=(64, 64), **kw):
    """(JAX model, its perturbed variables, the port's model loaded with
    them), for inputs of ``size``."""
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d as TModel
    jcfg, tcfg = _configs(**kw)
    jm = JModel(jcfg)
    params, bstats = jax_variables(
        jm, jnp.zeros((1,) + _input_shape(jcfg, size=size)[1:]), seed=seed)
    tm = TModel(tcfg, patch_size=size)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return jm, params, bstats, tm


def _eval_pair(jm, params, bstats, tm, x):
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats),
                                       jnp.asarray(x)))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    return out, ref
