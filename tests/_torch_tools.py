"""Shared pieces of the tests that hold the port's analysis tools
against the JAX package (tests/test_torch_tools_*.py): a compiled JAX
apply that returns the sown intermediates in flax's sow order, the
port's kept features of one eval forward, and a tiny Segtran2d pair on
the same converted weights."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jvars

TOL = dict(rtol=1e-4, atol=1e-4)


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v[0]


class JitModel:
    """A flax model whose ``apply(v, x, train=False, mutable=...)`` runs
    compiled and returns the intermediates in the order flax sows them, as
    an eager apply returns them (a jitted function's dict output comes back
    with sorted keys, so the paths leave through a trace-time list). JAX's
    tools take it in place of the model: they run eagerly, tens of seconds
    a forward on the CPU."""

    def __init__(self, jm):
        self.names = []

        @jax.jit
        def run(v, x):
            out, st = jm.apply(v, x, train=False, mutable=["intermediates"])
            items = list(_walk(st.get("intermediates", {})))
            self.names[:] = [k for k, _ in items]
            return out, [a for _, a in items]
        self._run = run

    def apply(self, v, x, train=False, mutable=None):
        assert not train
        out, vals = self._run(v, x)
        if not mutable:
            return out
        tree = {}
        for name, a in zip(self.names, vals):
            *dirs, leaf = name.split("/")
            t = tree
            for d in dirs:
                t = t.setdefault(d, {})
            t[leaf] = (a,)
        return out, {"intermediates": tree}


_JIT_MODELS = {}


def jit_model(jm):
    """The JitModel of ``jm``, compiled once per flax module in a
    process (modules compare by their fields)."""
    if jm not in _JIT_MODELS:
        _JIT_MODELS[jm] = JitModel(jm)
    return _JIT_MODELS[jm]


def jax_intermediates(jm, params, bstats, x):
    """{path: array} of JAX's sown intermediates, in flax's order (the
    first element of each sown tuple)."""
    _, st = jit_model(jm).apply(jvars(params, bstats), jnp.asarray(x),
                                mutable=["intermediates"])
    return {k: np.asarray(v) for k, v in _walk(st["intermediates"])}


def port_features(tm, x):
    from segtran_tpu_torch.nn.features import drop_kept_features, kept_features
    tm.eval().keep_features = True
    with torch.no_grad():
        tm(torch.from_numpy(x))
    got = {k: v.numpy() for k, v in kept_features(tm).items()}
    drop_kept_features(tm)
    assert kept_features(tm).keys() <= {
        k for k in got if "translayers_" in k}     # the attentions' own
    return got


def assert_same_features(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def segtran2d_pair(seed=3, size=(64, 64), **kw):
    """(JAX model, its variables, the port's model loaded with them): the
    eff-tiny Segtran2d of tests/_torch_options.py with two translayers,
    variables from parameter shapes alone (tests/_torch_volume.py)."""
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d as TModel
    from _torch_options import _configs
    from _torch_volume import fast_variables
    jcfg, tcfg = _configs(**kw)
    jm = JModel(jcfg)
    params, bstats = fast_variables(jm, jnp.zeros((1,) + size + (3,)),
                                    seed=seed)
    tm = TModel(tcfg, patch_size=size)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return jm, params, bstats, tm.eval()
