"""The port's 2-D training held against the JAX package on the CPU.

* the EfficientNet backbone in training (batch statistics, momentum 0.99,
  eps 1e-3, no variance clamp): endpoints and running statistics;
* drop-connect: per-sample mask, scale, per-block rates, repeatability;
* two whole train steps of a tiny Segtran2d (eff-tiny, 64^2, fp32, batch
  2) through ``make_train_step`` with the 2-D loss and BertAdam, with
  ``remat_blocks`` off and on, against JAX ``make_train_step`` +
  ``make_loss_fn(3, (0, 1, 2))`` + ``build_optimizer``; dropout and
  drop-connect off on both sides;
* the 2-D loss, the class weights, ``resolve_remat_blocks``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, jvars, to_numpy
from _torch_train3d import (GRAD_TOL, LOSS_RTOL, STATS_TOL, UPDATE_TOL,
                            _fro_rel, _max_rel)

SHAPE = (64, 64)


def test_backbone_train_mode_matches_jax():
    """eff-b0 at 64^2, batch 2, fp32, drop-connect 0: the five endpoints to
    the 1e-4 of the whole-model parity tests (49 train-mode BatchNorms in a
    row, each over as few as 2 * 2 * 2 values per channel at the head,
    carry XLA's and PyTorch's other summation orders to ~3e-5) and every
    BatchNorm's updated running statistics to 1e-5."""
    from segtran_tpu.nn.backbones.efficientnet import (
        EfficientNetFeatures as JNet)
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures)
    x = np.random.RandomState(1).randn(2, *SHAPE, 3).astype(np.float32)
    jnet = JNet(variant="eff-b0", drop_connect_rate=0.0)
    params, bstats = jax_variables(jnet, jnp.zeros((1, *SHAPE, 3)), seed=4)
    ref, upd = jax.jit(lambda v, x: jnet.apply(v, x, True,
                                               mutable=["batch_stats"]))(
        jvars(params, bstats), jnp.asarray(x))
    net = EfficientNetFeatures("eff-b0", drop_connect_rate=0.0)
    net.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    got = net.train()(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
    sd = net.state_dict()
    moved = 0
    stats = state_dict_from_jax({}, to_numpy(upd["batch_stats"]))
    for name, want in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        moved += not np.allclose(want.numpy(), state_dict_from_jax(
            {}, bstats)[name].numpy())
    assert moved == len(stats) == 2 * 49          # every BatchNorm moved


def _fp64_folded_bn_class():
    """JAX's ``FoldedBatchNorm`` (nn/backbones/efficientnet.py) with its
    statistics in x's type: JAX casts x to fp32 before them, which would
    leave each package's fp32 summation order in an fp64 run."""
    from segtran_tpu.nn.backbones.efficientnet import FoldedBatchNorm

    class FoldedBatchNorm64(FoldedBatchNorm):
        @fnn.compact
        def __call__(self, x):
            feats = x.shape[-1]
            scale = self.param("scale", fnn.initializers.ones, (feats,),
                               jnp.float32)
            bias = self.param("bias", fnn.initializers.zeros, (feats,),
                              jnp.float32)
            ra_mean = self.variable("batch_stats", "mean",
                                    lambda: jnp.zeros((feats,), jnp.float32))
            ra_var = self.variable("batch_stats", "var",
                                   lambda: jnp.ones((feats,), jnp.float32))
            if self.use_running_average:
                mean, var = ra_mean.value, ra_var.value
            else:
                xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
                axes = tuple(range(x.ndim - 1))
                mean = jnp.mean(xf, axes)
                var = jnp.mean(jnp.square(xf), axes) - jnp.square(mean)
                if not self.is_initializing():
                    m = self.momentum
                    ra_mean.value = m * ra_mean.value + (1 - m) * mean
                    ra_var.value = m * ra_var.value + (1 - m) * var
            a = scale * jax.lax.rsqrt(var + self.epsilon)
            b = bias - mean * a
            return x * a.astype(self.dtype) + b.astype(self.dtype)
    return FoldedBatchNorm64


def test_backbone_train_mode_matches_jax_fp64(monkeypatch):
    """The same eff-b0 endpoints and updated running statistics with both
    sides in fp64 (JAX under x64, its FoldedBatchNorm's statistics in
    fp64 for this test: ``_fp64_folded_bn_class``), to 1e-6 of each
    tensor's largest entry: what the fp32 test's 1e-4 leaves is the two
    packages' fp32 summation orders, not the port."""
    from segtran_tpu.nn.backbones import efficientnet as jeff
    monkeypatch.setattr(jeff, "FoldedBatchNorm", _fp64_folded_bn_class())
    from segtran_tpu.nn.backbones.efficientnet import (
        EfficientNetFeatures as JNet)
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures)
    x = np.random.RandomState(1).randn(2, *SHAPE, 3)
    params, bstats = jax_variables(
        JNet(variant="eff-b0", drop_connect_rate=0.0),
        jnp.zeros((1, *SHAPE, 3)), seed=4)
    with jax.enable_x64(True):
        jnet = JNet(variant="eff-b0", drop_connect_rate=0.0,
                    dtype=jnp.float64)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   jvars(params, bstats))
        ref, upd = jax.jit(lambda v, x: jnet.apply(
            v, x, True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        ref = [np.asarray(r) for r in ref]
        new = to_numpy(upd["batch_stats"])
    assert ref[0].dtype == np.float64
    net = EfficientNetFeatures("eff-b0", drop_connect_rate=0.0,
                               dtype=torch.float64)
    net.load_state_dict(state_dict_from_jax(params, bstats), strict=True)
    net = net.double().train()
    got = net(torch.from_numpy(x))
    for g, r in zip(got, ref):
        g = g.detach().numpy()
        assert g.dtype == np.float64 and g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-6 * np.abs(r).max()
    sd = net.state_dict()
    stats = {k: v.numpy() for k, v in state_dict_from_jax({}, new).items()}
    assert len(stats) == 2 * 49
    for name, want in stats.items():
        got_s = sd[name].double().numpy()
        assert np.abs(got_s - want).max() <= 1e-6 * np.abs(want).max(), name


def test_drop_connect_per_sample_scaled_and_repeatable():
    from segtran_tpu_torch.nn.backbones.efficientnet import _drop_connect
    x = torch.ones(400, 3, 2, 2)
    g = torch.Generator().manual_seed(0)
    y = _drop_connect(x, 0.25, g)
    per_sample = y.reshape(400, -1)
    # one draw per sample: each sample is all dropped or all kept / keep
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    assert set(per_sample[:, 0].tolist()) == {0.0, float(x[0, 0, 0, 0]
                                                         / 0.75)}
    kept = float((per_sample[:, 0] > 0).float().mean())
    assert 0.68 < kept < 0.82
    again = _drop_connect(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    # the scale is rounded to x.dtype first, as in JAX
    yb = _drop_connect(x.bfloat16(), 0.3, torch.Generator().manual_seed(1))
    want = torch.tensor(1.0, dtype=torch.bfloat16) / torch.tensor(
        0.7, dtype=torch.bfloat16)
    assert set(yb.reshape(400, -1)[:, 0].tolist()) <= {0.0, float(want)}


def test_drop_connect_rates_and_sites():
    """Block i gets drop_connect_rate * i / n (JAX efficientnet.py:530);
    only residual blocks drop, only in training."""
    from segtran_tpu.nn.backbones.efficientnet import build_block_specs
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures)
    blocks = build_block_specs("eff-b0", 2)[0]
    net = EfficientNetFeatures("eff-b0", drop_connect_rate=0.2)
    n = len(blocks)
    assert [b.drop_rate for b in net._blocks] == [0.2 * float(i) / n
                                                  for i in range(n)]
    torch.manual_seed(0)
    x = torch.randn(8, 40, 16, 16)              # block 4: 40 -> 40, stride 1
    blk = net._blocks[4]
    assert blk.spec.in_filters == blk.spec.out_filters == 40
    blk.drop_rate = 0.5
    blk.generator = torch.Generator().manual_seed(2)
    blk.train()
    with torch.no_grad():
        residual = blk(x) - x
        dropped = residual.reshape(8, -1).abs().max(1).values == 0
        assert 0 < int(dropped.sum()) < 8
        blk.eval()
        assert not bool((blk(x) - x).reshape(8, -1).abs().max(1).values.eq(
            0).any())


def test_loss_and_class_weights_match_jax():
    from segtran_tpu.train import trainer as jt
    from segtran_tpu_torch.train import trainer as tt
    for n, focus in ((3, -1), (4, 2), (2, 1)):
        np.testing.assert_allclose(tt.make_class_weights(n, focus).numpy(),
                                   np.asarray(jt.make_class_weights(n, focus)),
                                   rtol=1e-7)
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 16, 12, 3) * 2).astype(np.float32)
    mask = (rng.rand(2, 32, 24, 3) > 0.5).astype(np.float32)
    for same_size in (True, False):
        m = mask[:, ::2, ::2] if same_size else mask
        jl, jm = jt.make_loss_fn(3, (0.0, 1.0, 2.0), 0.5)(logits, m)
        tl, tm = tt.make_loss_fn(3, (0.0, 1.0, 2.0), 0.5)(
            torch.from_numpy(logits), torch.from_numpy(m))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)


def test_resolve_remat_blocks_matches_jax():
    from segtran_tpu.cli.train2d import resolve_remat_blocks as jrule
    from segtran_tpu_torch.train.trainer import resolve_remat_blocks
    for bs in (1, 6, 11, 12, 24, 48):
        for accum in (1, 2, 4):
            for dev, tp in ((1, 1), (4, 1), (4, 2), (8, 4)):
                assert resolve_remat_blocks(bs, accum, dev, tp) == \
                    jrule(bs, accum, dev, tp)


def _configs():
    from segtran_tpu.configs.base import Segtran2dConfig as JCfg
    from segtran_tpu_torch.configs.base import Segtran2dConfig as TCfg
    kw = dict(backbone_type="eff-tiny", num_classes=3, num_attractors=8,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ratios = (1.0, 1.0, 2.0)
    return (JCfg(**kw).derive(translayer_compress_ratios=ratios),
            TCfg(**kw).derive(translayer_compress_ratios=ratios))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's two train steps: the loss of each, step 1's clipped
    gradients, the parameters and statistics after step 2. Drop-connect
    is patched out (the model passes its default rate 0.2)."""
    import optax
    import segtran_tpu.nn.backbones.efficientnet as jeff
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu.train.trainer import (build_optimizer, create_train_state,
                                           make_loss_fn, make_train_step)
    mp = pytest.MonkeyPatch()
    mp.setattr(jeff, "_drop_connect", lambda x, rate, det, rng: x)
    try:
        jcfg, _ = _configs()
        jm = JModel(jcfg)
        params, bstats = jax_variables(jm, jnp.zeros((1, *SHAPE, 3)), seed=3)
        rng = np.random.RandomState(5)
        image = rng.randn(2, *SHAPE, 3).astype(np.float32)
        cls = rng.randint(0, 3, (2, *SHAPE))
        mask = np.eye(3, dtype=np.float32)[cls]
        # a pass-through stage first keeps each step's raw gradients
        keep = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda u, st, p=None: (u, u))
        tx = optax.chain(keep, build_optimizer(
            lr=2e-4, decay=1e-4, t_total=4, warmup_ratio=0.5, grad_clip=0.1))
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, bstats), tx,
            jax.random.PRNGKey(1))
        step = jax.jit(make_train_step(jm, tx, make_loss_fn(3, (0, 1, 2))))
        batch = {"image": jnp.asarray(image), "mask": jnp.asarray(mask)}
        losses, grads = [], None
        for s in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if s == 0:
                grads, _ = optax.clip_by_global_norm(0.1).update(
                    state.opt_state[0], None)
                grads = to_numpy(grads)
    finally:
        mp.undo()
    return dict(params=params, bstats=bstats, image=image, mask=mask,
                losses=losses, grads=grads, after=to_numpy(state.params),
                stats_after=to_numpy(state.batch_stats))


# a gradient whose largest entry lies below this share of the model's
# largest is zero by structure (a BatchNorm bias followed by a train-mode
# BatchNorm, the mode softmax's shared shift, the last translayer's
# out-query), and rounding noise in both packages
NOISE = 1e-6


@pytest.mark.parametrize("remat_blocks", [False, True])
def test_two_train_steps_match_jax(jax_steps, remat_blocks):
    """The loss of each step to 1e-5; step 1's clipped gradients, each to
    2e-3 of its largest entry (the 3-D tests' GRAD_TOL; the EfficientNet
    backbone needs no looser bound than the rest); the running statistics
    and the parameters after step 2 at the 3-D train tests' tolerances
    (tests/_torch_train3d.py). Structurally zero gradients (``NOISE``) are
    held to that bound, and their tensors to an update under 1e-6."""
    import dataclasses
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.train.trainer import (build_optimizer,
                                                 make_loss_fn,
                                                 make_train_step)
    j = jax_steps
    _, tcfg = _configs()
    model = Segtran2d(dataclasses.replace(tcfg, remat_blocks=remat_blocks))
    model.load_state_dict(state_dict_from_jax(j["params"], j["bstats"]),
                          strict=True)
    for blk in model.backbone._blocks:
        blk.drop_rate = 0.0
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=4,
                          warmup_ratio=0.5)
    step = make_train_step(model, opt, make_loss_fn(3, (0.0, 1.0, 2.0)),
                           grad_clip=0.1)
    batch = {"image": torch.from_numpy(j["image"]),
             "mask": torch.from_numpy(j["mask"])}
    named = dict(model.named_parameters())
    jgrads = {k: v.numpy() for k, v in state_dict_from_jax(j["grads"]).items()}
    gmax = max(np.abs(g).max() for g in jgrads.values())
    noise = {k for k, g in jgrads.items() if np.abs(g).max() < NOISE * gmax}
    assert len(noise) < 20
    for s in range(2):
        metrics = step(batch)
        np.testing.assert_allclose(float(metrics["loss"]), j["losses"][s],
                                   rtol=LOSS_RTOL)
        if s == 0:
            for name, want in jgrads.items():
                got = named[name].grad.numpy()
                if name in noise:
                    assert np.abs(got).max() < NOISE * gmax, name
                else:
                    assert _max_rel(got, want) < GRAD_TOL, name
    sd = model.state_dict()
    p0 = state_dict_from_jax(j["params"], j["bstats"])
    for name, want in state_dict_from_jax(j["after"],
                                          j["stats_after"]).items():
        got, want = sd[name].numpy(), want.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, **STATS_TOL, err_msg=name)
            continue
        d0 = p0[name].numpy()
        if name in noise:
            assert np.abs(got - d0).max() < 1e-6, name
        else:
            assert _fro_rel(got - d0, want - d0) < UPDATE_TOL, name


def test_init_passes_match_jax_2d():
    """The reference init passes on a tiny Segtran2d with the flagship's
    shared Q/K (bench.py's from-scratch start): JAX's raw init converted,
    then the port's passes, equals JAX's params after its passes."""
    from segtran_tpu.models.segtran2d import Segtran2d as JModel
    from segtran_tpu.nn import init as jinit
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn import init as tinit
    jcfg, tcfg = _configs()
    assert tcfg.tie_qk_scheme == "shared"
    variables = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, *SHAPE, 3)))
    raw = to_numpy(variables["params"])
    after = state_dict_from_jax(to_numpy(jinit.apply_reference_init_schemes(
        variables["params"], variables["site_meta"])))
    model = Segtran2d(tcfg)
    model.load_state_dict(state_dict_from_jax(raw, to_numpy(
        variables["batch_stats"])), strict=True)
    tinit.apply_reference_init_schemes(model, tcfg.base_initializer_range,
                                       tcfg.query_idbias_scale,
                                       tcfg.feattrans_lin1_idbias_scale)
    sd, before = model.state_dict(), state_dict_from_jax(raw)
    changed = 0
    for name, want in after.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        changed += not np.array_equal(want.numpy(), before[name].numpy())
    # the shared Q/K of both cross-attentions and V of both expansions, in
    # each of the 2 translayers
    assert changed == 8


def test_out_fpn_dropout_tail_equals_the_factored_head():
    """With out_fpn_do_dropout and dropout in training, Segtran2d takes the
    unfactored tail (bridge, add the upsampled fused features, dropout,
    out_conv; JAX segtran2d.py:206-214); with its dropout at p = 0 it
    computes the factored head's logits, up to the reassociation."""
    import dataclasses
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn.attention import Dropout
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    _, tcfg = _configs()
    cfg = dataclasses.replace(tcfg, hidden_dropout_prob=0.1)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, *SHAPE, 3).astype(np.float32))
    logits = {}
    for tail in (True, False):
        model = init_with_reference_schemes(
            Segtran2d(dataclasses.replace(cfg, out_fpn_do_dropout=tail)),
            cfg, seed=0).train()
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        calls = []
        model.out_fpn_dropout.register_forward_hook(
            lambda *a: calls.append(1))
        with torch.no_grad():
            logits[tail] = model(x)
        assert len(calls) == int(tail)
    torch.testing.assert_close(logits[True], logits[False], rtol=1e-5,
                               atol=1e-5)
