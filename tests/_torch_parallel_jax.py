"""The JAX side of the port's parallel step tests: the tiny Segtran2d of
tests/_torch_parallel_ranks.py in the JAX package, its variables, and
train steps through JAX's ``shard_train_step`` (a data mesh) or
``shard_train_step_2d`` (a (data, model) mesh, ``--tp`` / ``--ep``), with
the same loss; and the comparison of a port run with it and with the
port's one-rank run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_dist import launch, save_inputs
from _torch_volume import fast_variables

STEPS = 2
JAX_LOSS = dict(rtol=1e-4, atol=1e-5)      # tests/test_expert_parallel.py
JAX_PARAMS = 2e-4
PORT_TOL = 1e-5
# the whole update p(after) - p(0) against JAX's by relative Frobenius
# error: BertAdam's m / (sqrt(v) + eps) normalises every entry, so the
# two packages' summation orders move noise-sized gradients by a whole
# step (tests/_torch_train3d.py's UPDATE_TOL holds each tensor to 0.3)
UPDATE_TOL = 0.05


def batch(seed=5, n=4):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, 64, 64, 3).astype(np.float32)
    mask = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (n, 64, 64))]
    return image, mask


def jax_steps(image, mask, n_dev, tp=1, expert=False):
    """STEPS JAX steps on ``n_dev`` host devices: ``shard_train_step`` on
    make_mesh(n_dev), or with ``tp`` > 1 ``shard_train_step_2d`` on a
    (n_dev / tp, tp) mesh with JAX's default rule (min_size 1 << 16) and
    with ``expert`` its mode preference. Returns (params, batch_stats,
    losses, params after, batch_stats after, sharding spec)."""
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu.ops.losses import dice_loss_mix
    from segtran_tpu.parallel.mesh import (make_mesh, replicate_to_mesh,
                                           shard_batch_to_mesh,
                                           shard_train_step)
    from segtran_tpu.parallel.tensor_parallel import (shard_state_to_mesh,
                                                      shard_train_step_2d)
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from segtran_tpu.train.trainer import (build_optimizer, create_train_state,
                                           make_loss_fn, make_train_step)
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    try:
        jcfg = JCfg(**ranks.TINY2D).derive(
            translayer_compress_ratios=ranks.RATIOS2D)
        jm = JModel(jcfg)
        params, bstats = fast_variables(jm, jnp.zeros((1, 64, 64, 3)),
                                        seed=3)
        base = make_loss_fn(3, (0.0, 1.0, 2.0))

        def loss_fn(logits, m):
            loss, metrics = base(logits, m)
            loss = loss + ranks.MIX_W * dice_loss_mix(
                jax.nn.sigmoid(logits[..., 1]), m[..., 1])
            return loss, dict(metrics, loss=loss)
        tx = build_optimizer(lr=2e-4, decay=1e-4, t_total=4,
                             warmup_ratio=0.5, grad_clip=0.1)
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, bstats), tx,
            jax.random.PRNGKey(1))
        step = make_train_step(jm, tx, loss_fn)
        spec = None
        if tp > 1:
            mesh = make_mesh(n_dev, axes=("data", "model"),
                             shape=(n_dev // tp, tp))
            state, spec = shard_state_to_mesh(
                state, mesh,
                expert_dim_size=jcfg.num_modes if expert else None)
            sstep = shard_train_step_2d(step, mesh, spec,
                                        donate_state=False)
        else:
            mesh = make_mesh(n_dev)
            sstep = shard_train_step(step, mesh, donate_state=False)
            state = replicate_to_mesh(state, mesh)
        b = shard_batch_to_mesh({"image": jnp.asarray(image),
                                 "mask": jnp.asarray(mask)}, mesh)
        losses = []
        for _ in range(STEPS):
            state, metrics = sstep(state, b)
            losses.append(float(metrics["loss"]))
    finally:
        mp.undo()
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    return (params, bstats, np.array(losses), get(state.params),
            get(state.batch_stats), spec)


def port_runs(tmp_path, image, mask, params, bstats, worlds, tp=1,
              ep=False):
    """The port's STEPS steps at each (world, tp) of ``worlds``: {world:
    (per-rank outputs, full state_dict after)}."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    torch.save(state_dict_from_jax(params, bstats), tmp_path / "sd.pt")
    inp = save_inputs(tmp_path / "in.npz", image=image, mask=mask)
    runs = {}
    for world in worlds:
        out = launch(ranks.segtran2d_steps, world, tmp_path / f"w{world}",
                     inputs=inp, sd=str(tmp_path / "sd.pt"), steps=STEPS,
                     tp=tp if world > 1 else 1, ep=ep)
        runs[world] = (out, torch.load(tmp_path / f"w{world}" / "after.pt",
                                       weights_only=True))
    return runs


def check_against(runs, world, jlosses, jparams, jstats, params, bstats):
    """The ``world``-rank run against the one-rank run (1e-5: losses on
    every rank, the full state_dict) and against JAX (JAX's bounds)."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    (many, after_n), (one, after_1) = runs[world], runs[1]
    for r in many:
        np.testing.assert_array_equal(r["losses"], many[0]["losses"])
    np.testing.assert_allclose(many[0]["losses"], one[0]["losses"],
                               rtol=PORT_TOL)
    np.testing.assert_allclose(many[0]["mix"], one[0]["mix"], rtol=PORT_TOL)
    assert set(after_n) == set(after_1)
    for k, v in after_1.items():
        np.testing.assert_allclose(after_n[k].numpy(), v.numpy(),
                                   rtol=PORT_TOL, atol=PORT_TOL, err_msg=k)
    np.testing.assert_allclose(many[0]["losses"], jlosses, **JAX_LOSS)
    want = state_dict_from_jax(jparams, jstats)
    sd0 = state_dict_from_jax(params, bstats)
    worst = max(float((after_n[k] - v).abs().max()) for k, v in want.items()
                if not k.endswith(("running_mean", "running_var")))
    assert worst < JAX_PARAMS, worst
    names = [k for k in want if not k.endswith(("running_mean",
                                                "running_var"))]
    got = torch.cat([(after_n[k] - sd0[k]).reshape(-1) for k in names])
    ref = torch.cat([(want[k] - sd0[k]).reshape(-1) for k in names])
    assert float(ref.abs().max()) > 1e-5
    rel = float((got - ref).norm() / ref.norm())
    print(f"update vs JAX: relative Frobenius {rel:.3g}")
    assert rel < UPDATE_TOL, rel
