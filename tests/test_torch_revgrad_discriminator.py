"""Gradient reversal and the domain discriminator held against the JAX
package on the CPU: revgrad's identity forward and -alpha gradient; the
discriminator in both index layouts (with and without revgrad) and both
heads (average pool, tail Linear) on converted weights: eval logits, a
train-mode forward and its running statistics (fp32, 1e-4), its
train-mode backward in fp64 (1e-6); the >= 32x32 check; and one whole
ADDA step pair (--net unet-scratch --adv feat --adda) against JAX's
make_full_step, whose discriminator update does not depend on
--domweight while the net's does (JAX tests/test_da_training.py:71-111)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
ADDA_ARGV = ["--task", "fundus", "--net", "unet-scratch", "--adv", "feat",
             "--adda", "--domweight", "0.5", "--attractors", "8",
             "--origsize", "64", "--patchsize", "64", "--bs", "2",
             "--maxiter", "4", "--lrwarmup", "2", "--seed", "0"]


def test_gradient_reversal_matches_jax():
    from segtran_tpu.adapt.revgrad import gradient_reversal as jrev
    from segtran_tpu_torch.adapt.revgrad import gradient_reversal
    x = np.asarray([1.0, -2.0, 0.5], np.float32)
    for alpha in (1.0, 0.3):
        want = jax.grad(lambda v: jnp.sum(jrev(v, alpha) ** 2))(
            jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        y = gradient_reversal(xt, alpha)
        assert torch.equal(y.detach(), xt.detach())
        (y ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want))
        np.testing.assert_allclose(xt.grad.numpy(), -alpha * 2 * x)


def _pair(revgrad, avgpool, seed=2, ch=5, hw=(64, 64)):
    from segtran_tpu.models.discriminator import Discriminator as JD
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.discriminator import Discriminator
    jd = JD(num_classes=2, do_avgpool=avgpool, do_revgrad=revgrad,
            num_base_chan=8)
    params, bstats = jax_variables(jd, jnp.zeros((1,) + hw + (ch,)),
                                   seed=seed)
    td = Discriminator(ch, 2, avgpool, revgrad, 8, in_hw=hw)
    td.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return jd, params, bstats, td


@pytest.mark.parametrize("revgrad,avgpool", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_discriminator_matches_jax(revgrad, avgpool):
    """The index layout (model.1 first with revgrad, model.0 without) loads
    JAX's variables strictly; eval and train-mode logits and the running
    statistics agree."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    jd, params, bstats, td = _pair(revgrad, avgpool)
    first = "model.1.weight" if revgrad else "model.0.weight"
    assert first in td.state_dict()
    x = np.random.RandomState(3).randn(2, 64, 64, 5).astype(np.float32)
    ref = jax.jit(lambda v, xx: jd.apply(v, xx, train=False))(
        jvars(params, bstats), jnp.asarray(x))
    with torch.no_grad():
        out = td.eval()(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ref, st = jax.jit(lambda v, xx: jd.apply(
        v, xx, train=True, mutable=["batch_stats"]))(
        jvars(params, bstats), jnp.asarray(x))
    with torch.no_grad():
        out = td.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    sd = td.state_dict()
    for k, v in state_dict_from_jax({}, jax.tree_util.tree_map(
            np.asarray, st["batch_stats"])).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("revgrad", [True, False])
def test_discriminator_train_vjp_fp64(revgrad):
    """Train-mode backward, both packages in fp64: the gradients of every
    parameter and of the input (reversed with revgrad) within 1e-6 of
    their largest entry."""
    from segtran_tpu.models.discriminator import Discriminator as JD
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.discriminator import Discriminator
    _, params, bstats, _ = _pair(revgrad, True)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 64, 64, 5)
    ct = rng.randn(2, 2)
    with jax.enable_x64(True):
        jd = JD(num_classes=2, do_revgrad=revgrad, num_base_chan=8,
                dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     bstats)

        def f(p, xx):
            out, _ = jd.apply({"params": p, "batch_stats": s64}, xx,
                              train=True, mutable=["batch_stats"])
            return out.astype(jnp.float64)
        gp, gx = jax.jit(lambda p, xx, c: jax.vjp(f, p, xx)[1](c))(
            p64, jnp.asarray(x), jnp.asarray(ct))
        want = {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, gp)).items()}
        want_x = np.asarray(gx)
    td = Discriminator(5, 2, True, revgrad, 8, dtype=torch.float64)
    td.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    td = td.double().train()
    xt = torch.from_numpy(x).requires_grad_()
    td(xt).backward(torch.from_numpy(ct).float())
    for name, p in td.named_parameters():
        g, w = p.grad.numpy(), want[name]
        assert np.abs(g - w).max() < 1e-6 * np.abs(w).max(), name
    assert np.abs(xt.grad.numpy() - want_x).max() < 1e-6 * np.abs(
        want_x).max()


def test_small_inputs_raise():
    from segtran_tpu_torch.models.discriminator import Discriminator
    with pytest.raises(ValueError, match="32x32"):
        Discriminator(4, 1)(torch.zeros(1, 16, 64, 4))


@pytest.fixture(scope="module")
def jax_adda():
    from _torch_da import jax_run
    from segtran_tpu.configs.presets import TASK_SETTINGS
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(64, 64))
    return jax_run(ADDA_ARGV, task, (64, 64))


def test_adda_step_matches_jax(jax_adda):
    """Two ADDA steps against JAX (d_loss on detached features and live
    discriminator parameters, g_loss on live features and detached
    parameters; the discriminator's running statistics from its last
    call, once)."""
    from _torch_da import check_run
    check_run(ADDA_ARGV, jax_adda)


def test_adda_discriminator_update_ignores_domweight(jax_adda):
    """The discriminator's update is the same under --domweight 0.5 and
    0.001; the net's is not (one step, no warmup: the full lr)."""
    from _torch_da import port_run
    after = {}
    for w in ("0.5", "0.001"):
        argv = list(ADDA_ARGV) + ["--lrwarmup", "0"]
        argv[argv.index("--domweight") + 1] = w
        wrapped, step = port_run(argv, jax_adda)
        batch = {k: torch.from_numpy(v) for k, v in jax_adda["batch"].items()}
        step(batch, **jax_adda["draws"][0])
        after[w] = {k: v.clone() for k, v in wrapped.state_dict().items()}
    from segtran_tpu_torch.convert import state_dict_from_jax
    start = state_dict_from_jax(jax_adda["params"])
    assert any(not torch.equal(v, start[k]) for k, v in after["0.5"].items()
               if k.startswith("discriminator.") and k in start)
    for k, v in after["0.5"].items():
        if k.startswith("discriminator."):
            np.testing.assert_allclose(v.numpy(), after["0.001"][k].numpy(),
                                       atol=1e-6, err_msg=k)
    net_diff = max(float((v - after["0.001"][k]).abs().max())
                   for k, v in after["0.5"].items() if k.startswith("net."))
    assert net_diff > 1e-7
