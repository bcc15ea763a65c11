"""The port's context, expert and pipeline primitives on four gloo ranks
on the CPU (tests/_torch_dist.py), against the JAX package's on a (1, 4)
mesh of host devices and against one-process references:

* ``sharded_cross_attention`` (keys sharded; the flash forward's plain
  version per rank, merged by lse) and ``token_sharded_expand_attention``
  (queries sharded) against JAX's, ``cross_attention_reference`` and the
  port's plain flash version on the whole input;
* ``mode_sharded_ffn_aggregate`` (one mode per rank) against JAX's and the
  port's ``MMPrivateMid`` + ``LearnedSoftAggregate``;
* ``gpipe``: a toy tanh stack at M = 1, 2, 4 against JAX's ``gpipe`` and
  the sequential stack, its gradients (parameters per stage, input)
  against JAX's, a pytree hand-off, and the fusion encoder's translayers
  -- 4 uniform stages and the ``--layercompress 1,1,2,2`` stages over 3
  ranks -- against JAX's sequential encoder and JAX's ``gpipe``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

import _torch_parallel_ranks as ranks
from _torch_dist import launch, save_inputs
from _torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CLIP = 5.0
S = 4


def _encoder(ratios, seed):
    """JAX's tiny fusion encoder (squeezed), its variables, inputs, the
    position code, its sequential output and JAX's gpipe of its stages."""
    from segtran_tpu.configs import Segtran2dConfig
    from segtran_tpu.nn.encoder import SegtranFusionEncoder
    from segtran_tpu.nn.poscode import SegtranPosEncoder, gen_all_indices
    from segtran_tpu.parallel import pipeline as jpl
    cfg_kw = dict(backbone_type="eff-tiny", num_classes=3, num_attractors=8,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = Segtran2dConfig(**cfg_kw).derive(translayer_compress_ratios=ratios)
    h2 = w2 = 4
    b, n, c = 4, h2 * w2, cfg.trans_in_dim
    rng = np.random.RandomState(seed)
    vfeat = jnp.asarray(rng.randn(b, n, c) * 0.5, jnp.float32)
    vmask = jnp.ones((b, n, 1), jnp.float32)
    pos = gen_all_indices((h2, w2)).reshape(1, n, 2).astype(jnp.float32)
    voxels_pos = jnp.tile(pos, (b, 1, 1))
    enc = SegtranFusionEncoder(cfg)
    variables = jax.jit(lambda k, x, p, m: enc.init(
        k, x, p, m, (h2, w2), deterministic=True))(
        jax.random.PRNGKey(0), vfeat, voxels_pos, vmask)
    y_ref = jax.jit(lambda v, x, p, m: enc.apply(
        v, x, p, m, (h2, w2), deterministic=True))(
        variables, vfeat, voxels_pos, vmask)
    pos_code = SegtranPosEncoder(
        pos_code_type=cfg.pos_code_type, pos_dim=cfg.pos_dim,
        pos_embed_dim=cfg.trans_in_dim, pos_bias_radius=cfg.pos_bias_radius,
        ln_eps=cfg.ln_eps, dtype=cfg.dtype).apply(
        {"params": variables["params"]["pos_code_layer"]}, (h2, w2),
        voxels_pos)
    s = cfg.num_translayers
    mesh = Mesh(np.array(jax.devices()[:s]), ("model",))
    if len(set(cfg.translayer_dims)) == 1:
        stacked = jpl.stack_translayer_params(variables["params"], s)
        stage = jpl.make_translayer_stage(cfg)
    else:
        stacked, shapes = jpl.stack_translayer_params_padded(
            variables["params"], s)
        stage = jpl.make_hetero_translayer_stage(cfg, shapes)
    y_pipe, _, _ = jax.jit(lambda p, xt: jpl.gpipe(stage, p, xt, mesh,
                                                   "model", 2))(
        stacked, (vfeat, pos_code, vmask))
    y_pipe = np.asarray(y_pipe)[..., :cfg.translayer_dims[-1]]
    arrays = {"vfeat": np.asarray(vfeat), "pos": np.asarray(pos_code),
              "mask": np.asarray(vmask)}
    return (dict(cfg=cfg_kw, ratios=list(ratios)), variables["params"],
            arrays, np.asarray(y_ref), y_pipe)


def test_context_expert_and_pipeline_match_jax(tmp_path):
    from segtran_tpu.kernels.squeezed_attention import (
        cross_attention_reference)
    from segtran_tpu.parallel import context_parallel as jcp
    from segtran_tpu.parallel.expert import mode_sharded_ffn_aggregate
    from segtran_tpu.parallel.mesh import make_mesh
    from segtran_tpu.parallel.pipeline import gpipe
    from segtran_tpu_torch.convert import state_dict_from_jax
    from segtran_tpu_torch.kernels.squeezed_attention import (
        fused_cross_attention_plain)
    from segtran_tpu_torch.nn.attention import (LearnedSoftAggregate,
                                                MMPrivateMid)
    rng = np.random.RandomState(0)
    f32 = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    a = dict(q=f32(2, 16, 32, scale=1.5), k=f32(2, 64, 32, scale=1.5),
             v=f32(2, 64, 48), eq=f32(2, 64, 32, scale=0.3),
             ek=f32(2, 16, 32, scale=0.3), ev=f32(2, 16, 48),
             fx=f32(2, 4, 6, 16, scale=0.5), fk=f32(4, 16, 16, scale=0.25),
             fb=f32(4, 16, scale=0.1), sk=f32(16, 1), sb=f32(1),
             pw=f32(S, 12, 12, scale=0.3), pb=f32(S, 12, scale=0.1),
             px=f32(8, 5, 12), pside=f32(8, 5, 12))
    uniform = _encoder((1.0,) * (S + 1), seed=3)
    hetero = _encoder((1.0, 1.0, 2.0, 2.0), seed=7)
    for label, enc in (("uniform", uniform), ("hetero", hetero)):
        torch.save(state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, enc[1])), tmp_path / f"{label}.pt")
        a.update({f"{label}_{k}": v for k, v in enc[2].items()})
    inp = save_inputs(tmp_path / "in.npz", **a)
    out = launch(ranks.primitives, S, tmp_path / "ranks", inputs=inp,
                 encoder_sd=str(tmp_path / "uniform.pt"),
                 hetero_sd=str(tmp_path / "hetero.pt"),
                 cfg_kw=uniform[0], hetero_kw=hetero[0])
    j = {k: jnp.asarray(v) for k, v in a.items()}
    mesh = make_mesh(S, axes=("data", "model"), shape=(1, S))

    # the squeeze: the same result on every rank
    want = np.asarray(jcp.sharded_cross_attention(
        j["q"], j["k"], j["v"], mesh, "model", attn_clip=CLIP))
    ref = np.asarray(cross_attention_reference(j["q"], j["k"], j["v"],
                                               attn_clip=CLIP))
    plain, _ = fused_cross_attention_plain(*(torch.from_numpy(a[x])
                                             for x in "qkv"), CLIP)
    for r in out:
        np.testing.assert_allclose(r["squeeze"], want, **TOL)
        np.testing.assert_allclose(r["squeeze"], ref, **TOL)
        np.testing.assert_allclose(r["squeeze"], plain.numpy(), **TOL)
    # the expand: token-sharded, rank order
    got = np.concatenate([r["expand"] for r in out], 1)
    np.testing.assert_allclose(got, np.asarray(
        jcp.token_sharded_expand_attention(j["eq"], j["ek"], j["ev"], mesh,
                                           "model")), **TOL)
    np.testing.assert_allclose(got, np.asarray(cross_attention_reference(
        j["eq"], j["ek"], j["ev"])), **TOL)
    # the mode-sharded aggregate against JAX's and the port's modules
    want = np.asarray(mode_sharded_ffn_aggregate(
        j["fx"], j["fk"], j["fb"], j["sk"], j["sb"], mesh, "model"))
    ffn, agg = MMPrivateMid(4, 16), LearnedSoftAggregate(16, group_dim=1)
    with torch.no_grad():
        ffn.group_linear.weight.copy_(torch.from_numpy(a["fk"]))
        ffn.group_linear.bias.copy_(torch.from_numpy(a["fb"]))
        agg.feat2score.weight.copy_(torch.from_numpy(a["sk"].T))
        agg.feat2score.bias.copy_(torch.from_numpy(a["sb"]))
        mods = agg(ffn.eval()(torch.from_numpy(a["fx"]))).numpy()
    for r in out:
        np.testing.assert_allclose(r["aggregate"], want, **TOL)
        np.testing.assert_allclose(r["aggregate"], mods, **TOL)

    # gpipe: the toy stack against JAX's gpipe and the sequential stack
    pmesh = Mesh(np.array(jax.devices()[:S]), ("model",))
    params = {"w": j["pw"], "b": j["pb"]}

    def stage(p, xb):
        return jnp.tanh(xb @ p["w"] + p["b"])

    def sequential(p, x):
        for i in range(S):
            x = stage(jax.tree_util.tree_map(lambda l: l[i], p), x)
        return x
    seq = np.asarray(sequential(params, j["px"]))
    for m in (1, 2, 4):
        jy = np.asarray(gpipe(stage, params, j["px"], pmesh, "model", m))
        for r in out:
            np.testing.assert_allclose(r[f"toy{m}"], jy, **TOL)
            np.testing.assert_allclose(r[f"toy{m}"], seq, **TOL)
    jg = jax.grad(lambda p, x: jnp.sum(gpipe(stage, p, x, pmesh, "model",
                                             4) ** 2),
                  argnums=(0, 1))(params, j["px"])
    sg = jax.grad(lambda p, x: jnp.sum(sequential(p, x) ** 2),
                  argnums=(0, 1))(params, j["px"])
    gtol = dict(rtol=1e-4, atol=1e-5)         # tests/test_pipeline.py
    for i, r in enumerate(out):
        for name, key in (("grad_w", "w"), ("grad_b", "b")):
            np.testing.assert_allclose(r[name], np.asarray(jg[0][key][i]),
                                       **gtol)
            np.testing.assert_allclose(r[name], np.asarray(sg[0][key][i]),
                                       **gtol)
        np.testing.assert_allclose(r["grad_x"], np.asarray(jg[1]), **gtol)
    # a pytree hand-off: the side value rides through unchanged
    v_ref = (j["px"], j["pside"])
    for i in range(S):
        w_i, b_i = j["pw"][i], j["pb"][i]
        v_ref = (jnp.tanh(v_ref[0] @ w_i + b_i) + v_ref[1], v_ref[1])
    for r in out:
        np.testing.assert_allclose(r["pair_v"], np.asarray(v_ref[0]), **TOL)
        np.testing.assert_array_equal(r["pair_side"], a["pside"])
    # the translayers: 4 uniform stages, 3 --layercompress 1,1,2,2 stages
    for label, enc in (("uniform", uniform), ("hetero", hetero)):
        y_ref, y_pipe = enc[3], enc[4]
        n_stage = len(enc[0]["ratios"]) - 1
        for r in out[:n_stage]:
            got = r[label][..., :y_ref.shape[-1]]
            np.testing.assert_allclose(got, y_ref, **TOL)
            np.testing.assert_allclose(got, y_pipe, **TOL)
            assert not np.any(r[label][..., y_ref.shape[-1]:])
