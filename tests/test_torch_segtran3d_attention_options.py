"""The port's Segtran3d under the encoder's options, held against the JAX
package on the CPU with the same converted weights (I3D, 8 attractors,
one translayer, a 32x32x16 volume, fp32): the rand, sinu and bias
position codes (bias with the non-squeezed encoder, which JAX requires),
the non-squeezed encoder (self-attention over the N tokens) and the
multi-head output."""
import numpy as np
import pytest

from _torch_volume import ATOL, RTOL, eval_pair, model_pair
from test_torch_segtran3d_options import SIZE, _cfgs, _volume
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kw", [
    {"pos_code_type": "rand"},
    {"pos_code_type": "sinu"},
    {"pos_code_type": "bias", "use_squeezed_transformer": False},
    {"use_squeezed_transformer": False},
    {"ablate_multihead": True},
], ids=["pos_rand", "pos_sinu", "pos_bias_nosqueeze", "nosqueeze",
        "multihead"])
def test_segtran3d_encoder_option_logits_match_jax(kw):
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel
    jcfg, tcfg = _cfgs(**kw)
    x = _volume(4)
    jm, params, bstats, tm = model_pair(JModel, TModel, jcfg, tcfg, x.shape)
    out, ref = eval_pair(jm, params, bstats, tm, x)
    assert out.shape == ref.shape == (1,) + SIZE + (4,)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_rand_table_is_sized_from_the_token_grid():
    """--pos rand: one table row per token of the patch's grid,
    (16/4/2) * (32/8) * (32/8) = 32 at a 32x32x16 patch (JAX sizes it
    from the grid it sees at init)."""
    from segtran_tpu_torch.models.segtran3d import Segtran3d
    _, tcfg = _cfgs(pos_code_type="rand")
    model = Segtran3d(tcfg, patch_size=SIZE)
    assert model.token_grid(SIZE) == (2, 4, 4)
    assert tuple(model.voxel_fusion.pos_code_layer.pos_coder.pos_embed
                 .shape) == (32, 1024)
    with pytest.raises(ValueError, match="patch_size"):
        Segtran3d(tcfg)
