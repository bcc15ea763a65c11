"""The port's Segtran3d held against the JAX package on the CPU with the
same converted weights (8 attractors, a 32x32x16 4-modality volume, fp32):
the unfused modules, the flash-attention branch, flash attention plus the
fused epilogue, and the 'conv' depth unpool. On the CPU the port's kernels
run their plain versions; the JAX side runs its Pallas kernels in
interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

# fp32 end to end through I3D, the FPNs and one translayer
RTOL, ATOL = 1e-4, 1e-4
SHAPE = (1, 32, 32, 16, 4)


def _configs(**kw):
    from segtran_tpu.configs.base import Segtran3dConfig as JCfg
    from segtran_tpu_torch.configs.base import Segtran3dConfig as TCfg
    base = dict(num_classes=4, num_attractors=8, orig_in_channels=4, **kw)
    ratios = (1.0, 1.0)
    return (JCfg(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 **base).derive(translayer_compress_ratios=ratios),
            TCfg(**base).derive(translayer_compress_ratios=ratios))


@pytest.mark.parametrize("kw", [
    {},
    {"use_fused_attention": True},
    {"use_fused_attention": True, "use_fused_epilogue": True},
    {"out_fpn_upsampleD_scheme": "conv"},
], ids=["unfused", "fused", "fused_epilogue", "conv_unpool"])
def test_segtran3d_logits_match_jax(kw):
    from segtran_tpu.models.segtran3d import Segtran3d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran3d import Segtran3d as TModel

    jcfg, tcfg = _configs(**kw)
    x = np.random.RandomState(1).rand(*SHAPE).astype(np.float32)
    jm = JModel(jcfg)
    params, bstats = jax_variables(jm, jnp.zeros(SHAPE), seed=4)
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats), jnp.asarray(x)))

    tm = TModel(tcfg)
    # every JAX leaf converts (convert.py raises on one it cannot map), and
    # the converted dict covers the port's parameters exactly
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == SHAPE[:4] + (4,)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_fused_branch_runs_the_flash_wrapper(monkeypatch):
    """The fused config reaches fused_cross_attention twice per translayer
    (in-squeeze, out-squeeze) and, where epilogue_route takes it, the
    private epilogue once: in bf16 (the BraTS recipe; the translayer alone,
    since PyTorch's CPU avg_pool3d takes no bf16) at F=1024; in fp32 the
    route takes the modules, as JAX's VMEM gate does. The unfused config
    never reaches either."""
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.models.segtran3d import Segtran3d, init_segtran3d
    from segtran_tpu_torch.nn import attention

    calls = []
    real = attention.fused_cross_attention

    def spy(q, k, v, attn_clip):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, attn_clip)
    monkeypatch.setattr(attention, "fused_cross_attention", spy)
    private = []
    real_pool = epi.fused_private_output_pool
    monkeypatch.setattr(epi, "fused_private_output_pool",
                        lambda *a, **k: private.append(1) or real_pool(*a, **k))
    x = torch.from_numpy(np.random.RandomState(2).rand(*SHAPE).astype(
        np.float32))
    for fused in (False, True):
        _, tcfg = _configs(use_fused_attention=fused, use_fused_epilogue=fused)
        model = init_segtran3d(Segtran3d(tcfg), seed=0).eval()
        with torch.inference_mode():
            model(x)
        if not fused:
            assert calls == [] and private == []
    assert private == []
    layer = init_segtran3d(Segtran3d(dataclasses.replace(
        tcfg, dtype=torch.bfloat16)), seed=0).eval().voxel_fusion.translayers[0]
    with torch.inference_mode():
        layer(torch.randn(1, 32, 1024, dtype=torch.bfloat16))
    # N = (16/8) * (32/8) * (32/8) = 32 tokens, A = 8, C = 1024, 4 modes;
    # the fp32 forward, then the bf16 translayer
    assert calls == 2 * [((1, 8, 1024), (1, 32, 1024), (1, 32, 1024)),
                         ((4, 32, 256), (4, 8, 256), (4, 8, 1024))]
    assert private == [1]
