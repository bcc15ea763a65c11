"""PraNet held against the JAX package on the CPU, with the same seeded
weights on both sides (tests/_torch_zoo.py): Res2Net-50-v1b, the
one-channel aggregation, the reverse-attention branches, at 64x96. Its
four lateral maps in eval (fp32 to 1e-4 of the largest magnitude) and in
training in fp64 to 1e-6 (the backbone's 16 train-mode BatchNorms in a
row over 2 x 2 x 3 values per channel make fp32 ill-conditioned), the
running statistics after it; ``PraNetForTraining``, the CLIs' net, is
lateral_map_2 behind a zero background channel.
"""
import jax.numpy as jnp
import numpy as np
import torch

from _torch_zoo import (assert_close, assert_stats_close, eval_outputs,
                        load_pair, train_outputs)
from _torch_parity import one_torch_thread  # noqa: F401

X = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)


def test_pranet_matches_jax():
    from segtran_tpu.models.pranet import PraNet as J
    from segtran_tpu_torch.models.pranet import PraNet as T
    from segtran_tpu_torch.models.pranet import PraNetForTraining
    jm, tm = J(2), T(2)
    params, bstats = load_pair(jm, tm, X)
    got, ref = eval_outputs(jm, params, bstats, tm, X)
    assert [g.shape[-1] for g in got] == [1, 2, 2, 2]
    assert_close(got, ref)
    wrapped = PraNetForTraining(3)
    wrapped.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        out = wrapped.eval()(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(out[..., 0], 0.0)
    np.testing.assert_allclose(out[..., 1:], got[3], rtol=1e-6, atol=1e-6)
    jm64, tm64 = J(2, dtype=jnp.float64), T(2, dtype=torch.float64)
    tm64.load_state_dict(tm.state_dict())
    got, ref, sd, new = train_outputs(jm64, params, bstats, tm64, X,
                                      x64=True)
    assert_close(got, ref, rel=1e-6)
    assert_stats_close(sd, new, rel=1e-6)
