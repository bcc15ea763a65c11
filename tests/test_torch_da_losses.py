"""The DA and auxiliary losses of train/da.py held against the JAX
package on the CPU, values and gradients (fp32, 1e-4): the attention
diagnostics (keep_attn_diag through a tiny Segtran2d, and JAX behaviour
(d): none from the flash path), the 2-D attention-consistency loss
(squeezed pairs and plain layers, below and above its cap of 1), the
reconstruction loss, the domain-adversarial loss through a
gradient-reversal discriminator, the vCDR estimation losses; and one
whole --vcdr sep step pair against JAX's make_full_step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_options import _pair
from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)
VCDR_ARGV = ["--task", "fundus", "--net", "unet-scratch", "--vcdr", "sep",
             "--vcdrestimstart", "0", "--vcdrnetstart", "1",
             "--vcdrweight", "0.5", "--origsize", "64", "--patchsize", "64",
             "--bs", "2", "--maxiter", "4", "--lrwarmup", "2", "--seed", "0"]


def _close_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-9


@pytest.mark.parametrize("fused", [False, True])
def test_attn_diag_matches_jax(fused):
    """[max over calls, mean of the positive means, clamp count] of an
    eval forward with attn_diag; with --fused the flash path keeps
    none in either package (behaviour (d))."""
    from segtran_tpu.train.da import collect_attn_diag as jcollect
    from segtran_tpu_torch.train.da import collect_attn_diag
    jm, params, bstats, tm = _pair(attn_diag=True, use_fused_attention=fused,
                                   attn_clip=0.01)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    _, st = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=False, mutable=["intermediates"]))(
        jvars(params, bstats), jnp.asarray(x))
    want = jcollect(st)
    with torch.inference_mode():
        tm.eval()(torch.from_numpy(x))
    got = collect_attn_diag(tm)
    if fused:
        assert want is None and got is None
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert float(got[2]) > 0          # the clip of 0.01 was exceeded


@pytest.mark.parametrize("scale", [0.05, 300.0])
def test_attention_consistency_loss_matches_jax(scale):
    """Value and score gradients; scale 300 takes the loss above 1, where
    the detached denominator caps it."""
    from segtran_tpu.train.da import attention_consistency_loss as jloss
    from segtran_tpu_torch.train.da import attention_consistency_loss
    rng = np.random.RandomState(2)
    in_s = (scale * rng.randn(2, 1, 4, 24)).astype(np.float32)
    out_s = rng.randn(2, 1, 24, 4).astype(np.float32)
    plain = (scale * rng.randn(2, 1, 24, 24)).astype(np.float32)
    mask = (rng.rand(2, 16, 24, 3) > 0.6).astype(np.float32)

    def jf(a, b, c):
        return jloss([(a, b), c], jnp.asarray(mask), (4, 6))
    want, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(in_s), jnp.asarray(out_s), jnp.asarray(plain))
    ts = [torch.from_numpy(v).requires_grad_() for v in (in_s, out_s, plain)]
    got = attention_consistency_loss([(ts[0], ts[1]), ts[2]],
                                     torch.from_numpy(mask), (4, 6))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert (float(want) == 1.0) == (scale > 1)
    for t, g in zip(ts, jg):
        _close_grad(t.grad.numpy(), g)


def test_recon_loss_matches_jax():
    from _torch_da import jax_recon_head
    from segtran_tpu.train.da import recon_loss as jrecon
    from segtran_tpu_torch.cli.train2d import ReconHead
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.train.da import recon_loss
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 16, 16, 8).astype(np.float32)
    image = rng.randn(2, 32, 32, 3).astype(np.float32)
    head = jax_recon_head()
    params = head.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)))
    want, (gp, gf) = jax.value_and_grad(
        lambda p, f: jrecon(lambda v: head.apply(p, v), f,
                            jnp.asarray(image)), argnums=(0, 1))(
        params, jnp.asarray(feat))
    th = ReconHead(8)
    th.load_state_dict(state_dict_from_jax(params["params"]), strict=True)
    ft = torch.from_numpy(feat).requires_grad_()
    got = recon_loss(th, ft, torch.from_numpy(image))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grad(ft.grad.numpy(), gf)
    _close_grad(th.conv.weight.grad.numpy()[:, :, 0, 0].T,
                gp["params"]["conv"]["kernel"][0, 0])


def test_domain_adversarial_loss_matches_jax():
    """Through a gradient-reversal discriminator (eval statistics): the
    loss, the reversed feature gradients and the discriminator's."""
    from segtran_tpu.models.discriminator import Discriminator as JD
    from segtran_tpu.train.da import domain_adversarial_loss as jdal
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.discriminator import Discriminator
    from segtran_tpu_torch.train.da import domain_adversarial_loss
    jd = JD(num_classes=1)
    params, bstats = jax_variables(jd, jnp.zeros((1, 64, 64, 4)), seed=4)
    rng = np.random.RandomState(5)
    src = rng.randn(2, 64, 64, 4).astype(np.float32)
    tgt = rng.randn(3, 64, 64, 4).astype(np.float32)

    def jf(p, s, t):
        return jdal(lambda v: jd.apply(jvars(p, bstats), v, train=False),
                    s, t)
    want, (gp, gs, gt) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        params, jnp.asarray(src), jnp.asarray(tgt))
    td = Discriminator(4, 1)
    td.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    st, tt = (torch.from_numpy(v).requires_grad_() for v in (src, tgt))
    got = domain_adversarial_loss(td.eval(), st, tt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grad(st.grad.numpy(), gs)
    _close_grad(tt.grad.numpy(), gt)
    assert float((st.grad * torch.from_numpy(np.asarray(gs))).sum()) > 0
    want_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    for n, p in td.named_parameters():
        _close_grad(p.grad.numpy(), want_p[n].numpy())


def test_vcdr_estimation_losses_match_jax():
    """Both losses and their gradients into the estimator and the probs
    (the estimator's own loss reaches only the estimator)."""
    from segtran_tpu.models.discriminator import Discriminator as JD
    from segtran_tpu.train.da import vcdr_estimation_losses as jv
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.discriminator import Discriminator
    from segtran_tpu_torch.train.da import vcdr_estimation_losses
    from _torch_data2d import raw_mask
    jd = JD(num_classes=1, do_revgrad=False)
    params, bstats = jax_variables(jd, jnp.zeros((1, 64, 64, 3)), seed=6)
    rng = np.random.RandomState(7)
    probs = rng.rand(2, 64, 64, 3).astype(np.float32)
    raw = np.stack([raw_mask(64, 64, s) for s in (1, 2)])
    gt = np.stack([raw < 255, raw < 200, raw < 64], -1).astype(np.float32)
    for which in ("vcdr_estim_loss", "vcdr_net_loss"):
        def jf(p, pr):
            est = lambda v: jax.nn.sigmoid(   # noqa: E731
                jd.apply(jvars(p, bstats), v, train=False)[:, 0])
            return jv(est, pr, jnp.asarray(gt))[which]
        want, (gp, gpr) = jax.value_and_grad(jf, argnums=(0, 1))(
            params, jnp.asarray(probs))
        td = Discriminator(3, 1, do_revgrad=False)
        td.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
        td.eval()
        pt = torch.from_numpy(probs).requires_grad_()
        got = vcdr_estimation_losses(
            lambda v: torch.sigmoid(td(v)[:, 0]), pt,
            torch.from_numpy(gt))[which]
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        if which == "vcdr_estim_loss":
            assert pt.grad is None or float(pt.grad.abs().max()) == 0.0
        else:
            _close_grad(pt.grad.numpy(), gpr)
        want_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp))
        for n, p in td.named_parameters():
            _close_grad(p.grad.numpy(), want_p[n].numpy())


def test_vcdr_sep_step_matches_jax():
    """Two --vcdr sep steps (the estimator loss on from step 0, the net's
    from step 1) against JAX: the estimators called twice a step, their
    running statistics moved once, from the live call."""
    from _torch_da import check_run, jax_run
    from segtran_tpu.configs.presets import TASK_SETTINGS
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(64, 64))
    j = jax_run(VCDR_ARGV, task, (64, 64))
    assert j["metrics"][1]["vcdr_net_loss"] > 0
    check_run(VCDR_ARGV, j)
