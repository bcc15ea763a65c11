"""Shared pieces of the tests that hold the port's 3-D and 2.5D models
against the JAX package: seeded variables for a flax model made from its
parameter shapes alone (``jax.eval_shape`` of ``init``: no compile of the
init, which takes most of a minute for I3D on the CPU), the tiny model
pairs on the same converted weights, and their eval and train forwards."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jvars

# as tests/test_torch_segtran3d.py: fp32 through the backbone, the FPNs and
# one translayer; XLA and PyTorch sum in other orders
RTOL, ATOL = 1e-4, 1e-4


def fast_variables(module, example, seed=0, **kwargs):
    """numpy (params, batch_stats) of ``module`` for ``example``: kernels
    normal / sqrt(fan-in), attractors and position tables normal(1), norm
    scales 1 + 0.1 N, biases and BN means 0.1 N, BN variances U(0.5, 1.5),
    all from ``seed``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), example,
                            **kwargs)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = shape[1] if len(shape) == 3 else int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("attractors", "pos_embed"):
            v = rng.randn(*shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:                     # bias, biases, mean
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    fill = lambda tree: jax.tree_util.tree_map_with_path(leaf, tree)
    return fill(shapes["params"]), fill(shapes.get("batch_stats", {}))


def model_pair(jcls, tcls, jcfg, tcfg, shape, seed=3, jkw=None, tkw=None):
    """(JAX model, its variables, the port's model loaded with them) for
    inputs of ``shape`` [B, H, W, D, C]."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    jm = jcls(jcfg, **(jkw or {}))
    params, bstats = fast_variables(jm, jnp.zeros(shape), seed=seed)
    tm = tcls(tcfg, patch_size=shape[1:4], **(tkw or {}))
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return jm, params, bstats, tm


def eval_pair(jm, params, bstats, tm, x):
    """Eval logits of both (port, JAX) on x."""
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats),
                                       jnp.asarray(x)))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    return out, ref


def train_pair(jm, params, bstats, tm, x, seed=0, x64=False):
    """Train-mode logits and the new BatchNorm statistics of both: (port
    logits, JAX logits, port state_dict, JAX batch_stats). Dropout draws
    from a seeded generator on the port's side, from PRNGKey(seed) on
    JAX's. ``x64``: both run in fp64 (the models' configs must say so),
    the logits still leave as fp32."""
    import contextlib
    from segtran_tpu_torch.nn.attention import set_dropout_generator

    with (jax.enable_x64(True) if x64 else contextlib.nullcontext()):
        cast = ((lambda a: jnp.asarray(a, jnp.float64)) if x64
                else jnp.asarray)
        v = {"params": jax.tree_util.tree_map(cast, params)}
        if bstats:
            v["batch_stats"] = jax.tree_util.tree_map(cast, bstats)

        @jax.jit
        def fwd(v, x):
            return jm.apply(v, x, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(seed)})
        ref, new = fwd(v, cast(x))
        ref = np.asarray(ref)
        new = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    set_dropout_generator(tm, torch.Generator().manual_seed(seed))
    xt = torch.from_numpy(x)
    if x64:
        tm, xt = tm.double(), xt.double()
    with torch.no_grad():
        out = tm.train()(xt).numpy()
    return out, ref, tm.state_dict(), new
