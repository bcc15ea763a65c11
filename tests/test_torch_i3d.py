"""The port's I3D feature pyramid held against the JAX package on the CPU,
with the same converted weights: all five taps, fp32, on an even volume
and an odd one (TF-SAME padding is asymmetric on even sizes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

# fp32; ~60 convolutions summed in other orders by XLA and PyTorch
RTOL, ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("shape,do_pool1", [((16, 32, 32), False),
                                            ((17, 33, 31), True)])
def test_i3d_taps_match_jax(shape, do_pool1):
    from segtran_tpu.nn.backbones.i3d import I3DFeatures as JI3D
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.backbones.i3d import I3DFeatures as TI3D

    x = np.random.RandomState(0).randn(1, *shape, 3).astype(np.float32)
    jm = JI3D(do_pool1=do_pool1)
    params, bstats = jax_variables(jm, jnp.zeros((1,) + shape + (3,)), seed=2)
    refs = jax.jit(jm.apply)(jvars(params, bstats), jnp.asarray(x))

    tm = TI3D(do_pool1=do_pool1)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    with torch.inference_mode():
        outs = tm.eval()(torch.from_numpy(x))
    assert len(outs) == len(refs) == 5
    for out, ref in zip(outs, refs):
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
