"""--attnconsist's pieces held against the JAX package on the CPU with
the same converted weights: the scores the encoder keeps and
``collect_attn_scores`` (squeezed: in/out pairs; non-squeezed: one
matrix), ``attention_consistency_loss_3d`` in both rasters, and the
refusal under --remat. The train3d step is in
tests/test_torch_train3d_attnconsist.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jvars
from _torch_volume import fast_variables
from _torch_parity import one_torch_thread  # noqa: F401

SIZE = (32, 32, 16)


def _jax_cfg(**kw):
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    return JCfg(num_classes=4, num_attractors=8, orig_in_channels=4,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                use_attn_consist_loss=True, **kw).derive(
                    translayer_compress_ratios=(1.0, 1.0))


@pytest.mark.parametrize("squeeze", [True, False])
def test_kept_scores_and_the_loss_match_jax(squeeze):
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu.train import da as jda
    from segtran_tpu_torch.configs.base import Segtran3dConfig as TCfg
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel
    from segtran_tpu_torch.train import da as tda
    jcfg = _jax_cfg(use_squeezed_transformer=squeeze)
    rng = np.random.RandomState(0)
    x = rng.rand(2, *SIZE, 4).astype(np.float32)
    mask = (rng.rand(2, *SIZE, 4) > 0.6).astype(np.float32)
    jm = JModel(jcfg)
    params, bstats = fast_variables(jm, jnp.zeros(x.shape), seed=2)
    _, inter = jax.jit(lambda v, x: jm.apply(
        v, x, mutable=["intermediates"]))(jvars(params, bstats),
                                          jnp.asarray(x))
    jscores = jda.collect_attn_scores(inter)
    grid = inter["intermediates"]["in_fpn_feat"][0].shape[1:4]
    tm = TModel(TCfg(**{k: getattr(jcfg, k) for k in (
        "num_classes", "num_attractors", "orig_in_channels",
        "use_attn_consist_loss", "use_squeezed_transformer")}).derive(
            translayer_compress_ratios=(1.0, 1.0)))
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.no_grad():
        tm.eval()(torch.from_numpy(x))
    tscores = tda.collect_attn_scores(tm)
    assert tm.last_grid == tuple(grid) == (2, 4, 4)
    assert len(tscores) == len(jscores) == 1
    got = tscores[0] if squeeze else (tscores[0],)
    want = jscores[0] if squeeze else (jscores[0],)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    for depth_first in (True, False):
        shape = grid if depth_first else (4, 4, 2)
        j = jda.attention_consistency_loss_3d(
            jscores, jnp.asarray(mask), shape, depth_first=depth_first)
        t = tda.attention_consistency_loss_3d(
            tscores, torch.from_numpy(mask), shape, depth_first=depth_first)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_attnconsist_refuses_remat():
    """JAX's aux loss finds no scores under --remat and raises; the port
    refuses the pair when the step is built."""
    from segtran_tpu_torch.cli import train3d
    args = train3d.build_argparser().parse_args(
        ["--attnconsist", "--remat", "--device", "cpu"])
    with pytest.raises(ValueError, match="remat"):
        train3d.make_attn_consist_loss(args)
