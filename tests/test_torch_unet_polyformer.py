"""The vanilla U-Net and its Polyformer held against the JAX package on
the CPU: the three resize functions of ops/resize.py; VanillaUNet with no,
source and target Polyformer (eval logits, a train-mode forward, its
running statistics and the DA feature, fp32 to 1e-4); the U-Net's
train-mode backward in fp64 (every gradient to 1e-6); the parameter
labels of every opt mode, alone, combined and with --bnopt affine, and on
a DA-wrapped run (JAX behaviour (a): the discriminator frozen, 'h' and
'affine' matching nothing); loading a source checkpoint into a target run
(behaviour (b): K keeps its fresh value); no flash call from the
Polyformer; and one whole DA step pair of --net unet-scratch --polyformer
target --targetopt k --adv feat --reconweight 0.1 against JAX's
make_full_step (tests/_torch_da.py), which leaves every tensor but K
unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
DA_ARGV = ["--task", "fundus", "--net", "unet-scratch", "--polyformer",
           "target", "--targetopt", "k", "--adv", "feat", "--sourceds",
           "rim", "--reconweight", "0.1", "--attractors", "8", "--origsize",
           "64", "--patchsize", "64", "--bs", "2", "--maxiter", "4",
           "--lrwarmup", "2", "--seed", "0"]


def test_resize_functions_match_jax():
    from segtran_tpu.ops import resize as jr
    from segtran_tpu_torch.ops import resize as tr
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 9, 4).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for size in ((10, 18), (5, 9), (1, 4), (7, 3)):
        np.testing.assert_allclose(
            tr.resize_linear_align_corners(xt, size).numpy(),
            np.asarray(jr.resize_linear_align_corners(xj, size)),
            rtol=1e-5, atol=1e-6)
    v = rng.randn(1, 4, 6, 8, 3).astype(np.float32)
    np.testing.assert_allclose(
        tr.resize_linear_align_corners(torch.from_numpy(v), (8, 11, 9)),
        np.asarray(jr.resize_linear_align_corners(jnp.asarray(v),
                                                  (8, 11, 9))),
        rtol=1e-5, atol=1e-6)
    for kw in (dict(window=(2, 2)), dict(window=(3, 3), strides=(2, 2)),
               dict(window=(2, 2), padding=((1, 0), (0, 1)))):
        np.testing.assert_array_equal(tr.max_pool_nhwc(xt, **kw).numpy(),
                                      np.asarray(jr.max_pool_nhwc(xj, **kw)))
    for scale in (0.5, 2, (1.5, 0.7)):
        np.testing.assert_allclose(
            tr.interpolate_channels_last(xt, scale).numpy(),
            np.asarray(jr.interpolate_channels_last(xj, scale)),
            rtol=1e-5, atol=1e-6)


def _unet_pair(mode, seed=1, dtype=None):
    from segtran_tpu.models.unet2d import VanillaUNet as JU
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.unet2d import VanillaUNet
    jm = JU(n_channels=3, num_classes=3, polyformer_mode=mode,
            num_attractors=8, num_modes=4,
            **({} if dtype is None else dict(dtype=dtype)))
    params, bstats = jax_variables(
        JU(n_channels=3, num_classes=3, polyformer_mode=mode,
           num_attractors=8, num_modes=4), jnp.zeros((1, 64, 64, 3)),
        seed=seed)
    tm = VanillaUNet(3, 3, mode, 8, 4)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    return jm, params, bstats, tm


@pytest.mark.parametrize("mode", [None, "source", "target"])
def test_unet_matches_jax(mode):
    """Eval logits; a train-mode forward's logits, DA feature
    (pre_outc_feat, JAX's sown intermediate) and running statistics."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    jm, params, bstats, tm = _unet_pair(mode)
    if mode:
        key = tm.polyformer.polyformer_layers[0].in_ator_trans
        assert hasattr(key, "key") == (mode == "target")
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        jvars(params, bstats), jnp.asarray(x))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ref, st = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=True, mutable=["batch_stats", "intermediates"]))(
        jvars(params, bstats), jnp.asarray(x))
    tm.train().keep_features = True
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        tm.pre_outc_feat.numpy(),
        np.asarray(st["intermediates"]["pre_outc_feat"][0]), **TOL)
    sd = tm.state_dict()
    want = state_dict_from_jax({}, jax.tree_util.tree_map(
        np.asarray, st["batch_stats"]))
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_unet_train_vjp_fp64():
    """The U-Net's train-mode forward and the vjp of a random cotangent
    into every parameter and the input, both packages in fp64: every
    gradient within 1e-6 of its largest entry (in fp32 they differ by up
    to ~1e-2, as the port's own do from its fp64 ones:
    tests/_torch_da.py bn_chain)."""
    from segtran_tpu.models.unet2d import VanillaUNet as JU
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.unet2d import VanillaUNet
    params, bstats = jax_variables(JU(n_channels=3, num_classes=3),
                                   jnp.zeros((1, 16, 16, 3)), seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 16, 3)
    ct = rng.randn(2, 16, 16, 3)
    with jax.enable_x64(True):
        jm = JU(n_channels=3, num_classes=3, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        s64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     bstats)

        def f(p, xx):
            out, _ = jm.apply({"params": p, "batch_stats": s64}, xx,
                              train=True, mutable=["batch_stats"])
            return out.astype(jnp.float64)
        gp, gx = jax.jit(lambda p, xx, c: jax.vjp(f, p, xx)[1](c))(
            p64, jnp.asarray(x), jnp.asarray(ct))
        want = {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   gp)).items()}
        want_x = np.asarray(gx)
    tm = VanillaUNet(3, 3, dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    tm = tm.double().train()
    xt = torch.from_numpy(x).requires_grad_()
    tm(xt).backward(torch.from_numpy(ct).float())
    gmax = max(np.abs(g).max() for g in want.values())
    for name, p in tm.named_parameters():
        g, w = p.grad.numpy(), want[name]
        # conv biases before a BatchNorm: zero gradients by structure
        scale = np.abs(w).max() if np.abs(w).max() > 1e-9 * gmax else gmax
        assert np.abs(g - w).max() < 1e-6 * scale, name
    assert np.abs(xt.grad.numpy() - want_x).max() < 1e-6 * np.abs(
        want_x).max()


def _label_sd(labels, params):
    """A JAX label tree as {port name: trained}."""
    from segtran_tpu_torch.convert import state_dict_from_jax
    marks = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), lab == "normal", np.float32),
        labels, params)
    return {k: bool(v.reshape(-1)[0])
            for k, v in state_dict_from_jax(marks).items()}


@pytest.mark.parametrize("opt_mode,bn", [
    ("allpoly", None), ("inator", None), ("k", None), ("q", None),
    ("v", None), ("h", None), ("allnet", None), ("k,h", None),
    ("k", "affine"), ("v,q", "affine")])
def test_param_labels_match_jax(opt_mode, bn):
    from segtran_tpu.adapt.polyformer import polyformer_param_labels as jl
    from segtran_tpu_torch.adapt.polyformer import polyformer_param_labels
    _, params, bstats, tm = _unet_pair("target")
    want = _label_sd(jl(params, opt_mode, batch_stats=bstats,
                        bn_opt_scheme=bn), params)
    bn_names = {n.rsplit(".", 1)[0] for n, _ in tm.named_buffers()
                if n.endswith("running_mean")}
    got = polyformer_param_labels([n for n, _ in tm.named_parameters()],
                                  opt_mode, bn_names, bn)
    assert got == want
    assert any(got.values())


def test_param_labels_under_da_match_jax():
    """JAX behaviour (a): over the DA-wrapped tree the discriminator is
    frozen, 'h' (startswith('outc')) and --bnopt affine (paths from the
    unwrapped batch_stats) match nothing; the port labels the wrapped
    names the same way."""
    from segtran_tpu.adapt.polyformer import polyformer_param_labels as jl
    from segtran_tpu.models.discriminator import Discriminator as JD
    from segtran_tpu_torch.adapt.polyformer import polyformer_param_labels
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.discriminator import Discriminator
    _, params, bstats, tm = _unet_pair("target")
    dp, _ = jax_variables(JD(num_classes=1), jnp.zeros((1, 64, 64, 64)),
                          seed=6)
    wrapped = torch.nn.ModuleDict({"net": tm,
                                   "discriminator": Discriminator(64, 1)})
    bn_names = {n.rsplit(".", 1)[0] for n, _ in tm.named_buffers()
                if n.endswith("running_mean")}
    for opt_mode in ("k,h", "allnet", "inator"):
        tree = {"net": params, "discriminator": dp}
        want = _label_sd(jl(tree, opt_mode, batch_stats=bstats,
                            bn_opt_scheme="affine"), tree)
        got = polyformer_param_labels(
            [n for n, _ in wrapped.named_parameters()], opt_mode, bn_names,
            "affine")
        assert got == want
        if opt_mode != "allnet":
            assert not any(v for k, v in got.items()
                           if k.startswith(("discriminator", "net.outc"))
                           or ".double_conv.1." in k)
    assert set(state_dict_from_jax({"net": params, "discriminator": dp})) \
        == {n for n, _ in wrapped.named_parameters()}


def test_source_checkpoint_into_target_keeps_fresh_key(tmp_path):
    """JAX behaviour (b): a --polyformer source checkpoint (tied Q/K, no
    K) loaded into a target run leaves K at its fresh value in JAX's
    merge_params, and in the port's --cp load (train2d.load_into)."""
    import logging
    from segtran_tpu.models.unet2d import VanillaUNet as JU
    from segtran_tpu.train.checkpoint import merge_params
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.models.unet2d import VanillaUNet
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    jsrc, _ = jax_variables(JU(num_classes=3, polyformer_mode="source",
                               num_attractors=8), jnp.zeros((1, 32, 32, 3)),
                            seed=7)
    jtgt, _ = jax_variables(JU(num_classes=3, polyformer_mode="target",
                               num_attractors=8), jnp.zeros((1, 32, 32, 3)),
                            seed=8)
    merged = merge_params(jtgt, jsrc)
    jl = ("polyformer", "polyformer_layers_0", "in_ator_trans")
    node = lambda t: t[jl[0]][jl[1]][jl[2]]    # noqa: E731
    np.testing.assert_array_equal(node(merged)["key"]["kernel"],
                                  node(jtgt)["key"]["kernel"])
    np.testing.assert_array_equal(node(merged)["query"]["kernel"],
                                  node(jsrc)["query"]["kernel"])
    src = init_with_reference_schemes(VanillaUNet(3, 3, "source", 8),
                                      seed=1)
    tgt = init_with_reference_schemes(VanillaUNet(3, 3, "target", 8),
                                      seed=2)
    fresh = {k: v.clone() for k, v in tgt.state_dict().items()}
    train2d.load_into(tgt, src.state_dict(), logging.getLogger("test"))
    name = "polyformer.polyformer_layers.0.in_ator_trans."
    assert torch.equal(tgt.state_dict()[name + "key.weight"],
                       fresh[name + "key.weight"])
    assert torch.equal(tgt.state_dict()[name + "query.weight"],
                       src.state_dict()[name + "query.weight"])
    assert not torch.equal(fresh[name + "key.weight"],
                           src.state_dict()[name + "query.weight"])


def test_polyformer_takes_no_flash_path(monkeypatch):
    """The Polyformer's spec leaves use_fused_attention off, as JAX's
    does: no flash call in an eval or a training forward."""
    import segtran_tpu_torch.nn.attention as att
    from segtran_tpu_torch.models.unet2d import VanillaUNet
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    calls = []
    for name in ("fused_cross_attention", "fused_cross_attention_trainable"):
        fn = getattr(att, name)
        monkeypatch.setattr(att, name, lambda *a, _fn=fn, **k: (
            calls.append(1), _fn(*a, **k))[1])
    m = init_with_reference_schemes(VanillaUNet(3, 3, "target", 8), seed=0)
    x = torch.randn(1, 32, 32, 3)
    with torch.inference_mode():
        m.eval()(x)
    m.train()(x).sum().backward()
    assert calls == []
    assert all(not mod.spec.use_fused_attention for mod in m.modules()
               if isinstance(mod, att.CrossAttFeatTrans))


@pytest.fixture(scope="module")
def jax_da():
    from _torch_da import jax_run
    from segtran_tpu.configs.presets import TASK_SETTINGS
    task = dict(TASK_SETTINGS["fundus"], orig_input_size=(64, 64),
                patch_size=(64, 64))
    return jax_run(DA_ARGV, task, (64, 64))


def test_polyformer_target_da_step_matches_jax(jax_da):
    """Two steps of --polyformer target --targetopt k --adv feat
    --reconweight 0.1 against JAX: loss, metrics, K's gradients, running
    statistics and parameters; every tensor but K bit-identical to its
    start, the discriminator and recon head included (behaviour (a))."""
    from _torch_da import check_run
    from segtran_tpu_torch.convert import state_dict_from_jax
    wrapped = check_run(DA_ARGV, jax_da)
    start = state_dict_from_jax(jax_da["params"])
    moved = {n for n, p in wrapped.named_parameters()
             if not torch.equal(p.detach(), start[n])}
    assert moved == {"net.polyformer.polyformer_layers.0.in_ator_trans."
                     "key.weight", "net.polyformer.polyformer_layers.0."
                     "in_ator_trans.key.bias"}
