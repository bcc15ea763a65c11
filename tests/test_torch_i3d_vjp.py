"""The I3D backbone's train-mode backward, port against JAX on the CPU:
the five taps' forward with BatchNorm on batch statistics, then the vjp of
random cotangents into every parameter, with the same converted weights,
on a batch-2 8x32x32 volume (no pool 1; the BatchNorms see 8 to 2,048
values per channel).

Both sides run in fp64, and every gradient is held to 1e-6 of its largest
entry (the converter stores them in fp32; 5.5e-8 measured at 2x16x64x64).
In fp32 the comparison measures rounding, not the port: a ReLU whose
input lies within rounding of zero flips, and one flip moves a gradient
entry summed over N positions by ~1/sqrt(N) of its size (one unit's
weight gradient differs by ~1% between JAX and the port, and each by as
much from an fp64 reference); through ~60 train-mode BatchNorms the
port's own fp32 gradients move by up to ~17% of their largest entry when
its input moves by 1e-7 relative, at a 2x32x96x96 volume where every
BatchNorm sees 288 values or more. More values per channel do not help:
N grows the number of flips faster than it shrinks each one. In fp64 the
population does not matter; the volume is small because JAX's fp64
convolutions under the suite's unoptimised XLA flags (tests/conftest.py)
are slow (2x16x64x64 took 188 s)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jax_variables
from _torch_parity import one_torch_thread  # noqa: F401

SHAPE = (8, 32, 32)
GRAD_TOL = 1e-6          # max |diff| / max |jax grad|, per gradient
TAP_TOL = 1e-9           # max |diff| / max |jax tap|, fp64


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_i3d_train_vjp_matches_jax():
    from segtran_tpu.nn.backbones.i3d import I3DFeatures as JI3D
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.backbones.i3d import I3DFeatures as TI3D
    rng = np.random.RandomState(0)
    x = rng.randn(2, *SHAPE, 3)
    params, bstats = jax_variables(JI3D(do_pool1=False),
                                   jnp.zeros((1, 8, 16, 16, 3)), seed=4)
    with jax.enable_x64(True):
        jm = JI3D(do_pool1=False, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     bstats)

        def taps(p, xx):
            out, _ = jm.apply({"params": p, "batch_stats": s64}, xx,
                              train=True, mutable=["batch_stats"])
            return out

        shapes = jax.eval_shape(taps, p64, jnp.asarray(x))
        cts = tuple(rng.randn(*s.shape) for s in shapes)

        @jax.jit
        def fwd_vjp(p, xx, c):
            out, vjp = jax.vjp(lambda q: taps(q, xx), p)
            return out, vjp(c)[0]

        refs, jgrads = fwd_vjp(p64, jnp.asarray(x), cts)
        refs = [np.asarray(r) for r in refs]
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    assert refs[0].dtype == np.float64
    want = state_dict_from_jax(jgrads)        # (fp32 tensors)

    tm = TI3D(do_pool1=False, dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    tm = tm.double().train()
    outs = tm(torch.from_numpy(x))
    # the smallest BatchNorm population: the deepest tap's voxels
    assert min(int(np.prod(o.shape[:-1])) for o in outs) == 8
    for out, ref in zip(outs, refs):
        assert tuple(out.shape) == ref.shape
        assert _max_rel(out.detach().numpy(), ref) < TAP_TOL
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(grads) == set(want) and len(grads) > 100
    for name, w in want.items():
        assert _max_rel(grads[name].float().numpy(), w.numpy()) < GRAD_TOL, \
            name
