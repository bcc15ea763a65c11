"""Shared pieces of the tests that hold the port's 2-D zoo against the
JAX package: a JAX module and the port's twin on the same seeded weights
(JAX's from ``jax.eval_shape``, no compiled init), and their jitted eval
and train forwards (jitted, JAX's CPU forward of a zoo net compiles in a
few seconds under tests/conftest.py's flags; run eagerly it compiles
every operation on its own, 4-5x slower)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_volume import fast_variables

# fp32 logits to 1e-4 of their largest magnitude (as the earlier slices)
REL = 1e-4


def load_pair(jm, tm, x, seed=3, init_kwargs=None):
    """(JAX variables (params, batch_stats), the port model loaded with
    them) for the NHWC input ``x``."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    params, bstats = fast_variables(jm, jnp.asarray(x), seed=seed,
                                    **(init_kwargs or {}))
    tm.load_state_dict(state_dict_from_jax(params, bstats, tm.state_dict()),
                       strict=True)
    return params, bstats


def eval_outputs(jm, params, bstats, tm, x, x64=False, **apply_kw):
    """(port outputs, JAX outputs) of the eval forward, each a list of
    numpy arrays (one per output of a tuple-valued net); ``x64``: both in
    fp64."""
    import contextlib
    with (jax.enable_x64(True) if x64 else contextlib.nullcontext()):
        cast = ((lambda a: jnp.asarray(a, jnp.float64)) if x64
                else jnp.asarray)
        v = {"params": jax.tree_util.tree_map(cast, params)}
        if bstats:
            v["batch_stats"] = jax.tree_util.tree_map(cast, bstats)
        fwd = jax.jit(lambda v, x: jm.apply(v, x, **apply_kw))
        ref = _listed(fwd(v, cast(x)), lambda a: np.asarray(a, np.float64))
    xt = torch.from_numpy(x)
    if x64:
        tm, xt = tm.double(), xt.double()
    with torch.no_grad():
        out = tm.eval()(xt)
    return _listed(out, lambda t: t.double().numpy()), ref


def train_outputs(jm, params, bstats, tm, x, x64=False, **apply_kw):
    """Train-mode outputs and the new running statistics of both: (port
    outputs, JAX outputs, port state_dict, JAX batch_stats)."""
    import contextlib
    with (jax.enable_x64(True) if x64 else contextlib.nullcontext()):
        cast = ((lambda a: jnp.asarray(a, jnp.float64)) if x64
                else jnp.asarray)
        v = {"params": jax.tree_util.tree_map(cast, params),
             "batch_stats": jax.tree_util.tree_map(cast, bstats)}
        fwd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"], **apply_kw))
        ref, new = fwd(v, cast(x))
        ref = _listed(ref, lambda a: np.asarray(a, np.float64))
        new = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    xt = torch.from_numpy(x)
    if x64:
        tm, xt = tm.double(), xt.double()
    with torch.no_grad():
        out = tm.train()(xt)
    return (_listed(out, lambda t: t.double().numpy()), ref,
            tm.state_dict(), new)


def state_dict_shapes_from_jax(params, batch_stats=None, target=None):
    """The names and shapes ``convert.state_dict_from_jax`` gives, from a
    tree of shapes (``jax.eval_shape`` of ``init``), without allocating
    the arrays: zero-strided views pass through its rules."""
    from segtran_tpu_torch.convert import _converted

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                np.broadcast_to(np.float32(0), tuple(v.shape))
                for k, v in tree.items()}
    return {k: tuple(v.shape) for k, v in _converted(
        zeros(params), zeros(batch_stats or {}), target)}


def _listed(out, conv):
    if isinstance(out, (tuple, list)):
        return [conv(o) for o in out]
    return [conv(out)]


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def assert_close(got, ref, rel=REL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        err = rel_err(g, r)
        assert err <= rel, f"relative error {err:.3g} > {rel:.3g}"


def assert_stats_close(sd, new, rel=REL):
    """The port's running statistics against JAX's new batch_stats."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    conv = state_dict_from_jax({}, new, sd)
    assert conv, "no running statistics"
    for k, v in conv.items():
        err = rel_err(sd[k].double().numpy(), v.numpy())
        assert err <= rel, f"{k}: relative error {err:.3g} > {rel:.3g}"


class _Captured(Exception):
    pass


def jax_cli_state(argv, tmp_root):
    """What JAX train2d.main builds before its first step, for ``argv``
    (over a PNG tree written under ``tmp_root``): (model, args, task, tx,
    params, batch_stats). Its variables come from ``fast_variables`` at
    the patch size (no compiled init); main stops at create_train_state.
    """
    import pytest
    import segtran_tpu.utils.cache as jcache
    from segtran_tpu.cli import train2d as jt2
    from _torch_data2d import write_tree
    import os
    write_tree(os.path.join(tmp_root, "fundus", "train"))
    got = {}

    def init(model, rngs, example, **kw):
        got["model"] = model
        params, bstats = fast_variables(model, example, seed=3)
        return params, {"batch_stats": bstats}

    def capture(params, batch_stats, tx, rng):
        got.update(params=params, batch_stats=batch_stats, tx=tx)
        raise _Captured

    mp = pytest.MonkeyPatch()
    mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    mp.setattr(jt2, "init_with_reference_schemes", init)
    mp.setattr(jt2, "create_train_state", capture)
    try:
        jt2.main(argv + ["--dataroot", tmp_root,
                         "--ckptdir", os.path.join(tmp_root, "jax_model")])
    except _Captured:
        pass
    finally:
        mp.undo()
    args = jt2.build_argparser().parse_args(argv)
    task = dict(jt2.TASK_SETTINGS[args.task_name])
    for field, v in (("orig_input_size", args.orig_input_size),
                     ("patch_size", args.patch_size)):
        if v:
            vals = tuple(int(s) for s in str(v).split(","))
            task[field] = vals * 2 if len(vals) == 1 else vals
    return (got["model"], args, task, got["tx"], got["params"],
            got["batch_stats"])


def jax_cli_step(argv, tmp_root, batch):
    """One jitted JAX make_full_step on the raw ``batch``: (the
    variables before it, its draws, its metrics, the gradients, the
    params and batch_stats after it)."""
    import optax
    from segtran_tpu.cli import train2d as jt2
    from segtran_tpu.data.augment import Aug2dConfig
    from segtran_tpu.train.trainer import create_train_state
    from _torch_data2d import jax_draws
    model, args, task, tx, params, bstats = jax_cli_state(argv, tmp_root)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))
    tx = optax.chain(keep, tx)
    state = create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, bstats), tx,
        jax.random.PRNGKey(args.seed + 1))
    mean, std = jt2.load_stats(args, "train")
    aug_cfg = Aug2dConfig(randscale=args.randscale,
                          gray_alpha=args.gray_alpha, mean=mean, std=std)
    step = jax.jit(jt2.make_full_step(model, tx, task, args, aug_cfg,
                                      tuple(task["patch_size"])))
    key = jax.random.fold_in(state.rng, 77)
    draws = jax_draws(key, batch["image"].shape[0], aug_cfg)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(params=params, bstats=bstats, draws=draws,
                loss=float(metrics["loss"]), grads=tree(new.opt_state[0]),
                after=tree(new.params), bstats_after=tree(new.batch_stats))
