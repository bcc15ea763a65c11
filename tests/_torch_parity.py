"""Shared helpers of the tests that hold segtran_tpu_torch against the JAX
package: seeded JAX variables, converted into the port's state_dict, and
the fixture that runs a test module on one intra-op PyTorch thread."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A test module that imports this fixture runs on one intra-op
    PyTorch thread: the xdist workers share the host's cores, and
    PyTorch's default pool (a thread per core in each worker)
    oversubscribes them. The count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# leaves moved off their init: norm scales and biases, BN means, and the
# position codes' and global bias's parameters (zeros or a table whose
# LayerNorm would hide a shared offset)
_SHIFTED = ("scale", "bias", "mean", "biases", "pos_embed", "vfeat_bias")


def perturb(tree, seed):
    """Move every norm scale/bias, BN statistic and position-code parameter
    off its init value, so the folds, affines and codes are tested with
    non-trivial numbers."""
    rng = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k in _SHIFTED:
                v = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
            elif k == "var":
                v = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out
    return walk(tree)


# jax_variables' results in this process, by (module, seed, example
# inputs, keyword arguments): flax modules compare and hash by their
# fields, so a test file that builds the same module again (a parametrised
# test, a helper called per case) compiles its init once
_VARIABLES = {}


def _variables_key(module, args, seed, kwargs):
    try:
        arrays = tuple((np.shape(a), str(np.asarray(a).dtype),
                        hashlib.sha1(np.asarray(a).tobytes()).hexdigest())
                       for a in args)
        key = (module, seed, arrays, repr(sorted(kwargs.items())))
        hash(key)
        return key
    except TypeError:                  # a module with an unhashable field
        return None


def jax_variables(module, *args, seed=0, **kwargs):
    """Init a flax module with the reference init schemes; returns numpy
    (params, batch_stats) with perturbed norms and statistics (a fresh
    copy on every call; the init runs once per module, inputs and seed in
    a process)."""
    from segtran_tpu.nn.init import init_with_reference_schemes
    key = _variables_key(module, args, seed, kwargs)
    if key is None or key not in _VARIABLES:
        params, rest = init_with_reference_schemes(
            module, {"params": jax.random.PRNGKey(seed)}, *args, **kwargs)
        out = (perturb(to_numpy(params), seed + 1),
               perturb(to_numpy(rest.get("batch_stats", {})), seed + 2))
        if key is None:
            return out
        _VARIABLES[key] = out
    return jax.tree_util.tree_map(np.copy, _VARIABLES[key])


def jvars(params, batch_stats):
    v = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    if batch_stats:
        v["batch_stats"] = jax.tree_util.tree_map(jnp.asarray, batch_stats)
    return v
