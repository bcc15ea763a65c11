"""The port's process-group set-up and global-batch pieces on gloo ranks
on the CPU (tests/_torch_dist.py), against the JAX package's meaning:

* ``multihost.init_multihost`` joins the group the launcher's env
  describes (gloo for the CPU) and returns JAX's topology keys with JAX's
  rank line; ``is_master`` on rank 0 only; ``--ndevices`` -1 is the world
  size, another count raises naming both, ``--tp`` must divide it (JAX's
  message); ``replicate_to_mesh`` makes rank 0's weights every rank's;
  ``shard_batch_to_mesh`` keeps the contiguous rows of the data index on
  a (data, model) mesh, as JAX's ``P("data")`` does; ``from_master``;
* train-mode BatchNorm and FoldedBatchNorm over two ranks' rows: outputs,
  input and weight gradients, running statistics, against JAX's BatchNorm
  on the global batch and the port's one-process module;
* ``draw_2d`` and the 3-D draws: each rank's rows equal the one-process
  draws' rows;
* the batch-joint loss terms made global (``dice_loss_mix``, the 2-D
  attention-consistency loss, the contrast losses): the same value on
  every rank as one process on the global batch, and the rows of its
  input gradients, against the JAX package's functions too.
"""
import jax
import jax.numpy as jnp
import numpy as np

import _torch_parallel_ranks as ranks
from _torch_dist import launch, save_inputs
from _torch_parity import one_torch_thread  # noqa: F401

PORT_TOL = 1e-5


def test_topology_rank_line_and_mesh_helpers(tmp_path):
    from segtran_tpu.parallel.mesh import make_mesh, shard_batch_to_mesh
    out = launch(ranks.topology, 4, tmp_path, init=False, tp=2)
    for r, o in enumerate(out):
        assert o["topo"].tolist() == [r, 4, 1, 4]
        assert str(o["line"]) == f"multi-host: rank {r}/4, 1 local / 4 " \
                                 f"global devices"
        assert bool(o["master"]) == (r == 0)
        assert o["ndevices"].tolist() == [4, 4]
        assert "--ndevices 5" in str(o["errors"][0]) and \
            "world size 4" in str(o["errors"][0])
        assert str(o["errors"][1]) == "--tp 3 must divide device count 4"
        np.testing.assert_array_equal(o["weight"], out[0]["weight"])
        assert str(o["job"]) == "job-0" and str(o["backend"]) == "gloo"
    # JAX's P("data") rows on its (2, 2) mesh: the devices of data index i
    mesh = make_mesh(4, axes=("data", "model"), shape=(2, 2))
    x = shard_batch_to_mesh(jnp.arange(12).reshape(12, 1), mesh)
    for shard in x.addressable_shards:
        r = list(mesh.devices.flat).index(shard.device)
        np.testing.assert_array_equal(out[r]["rows"],
                                      np.asarray(shard.data)[:, 0])
    assert out[0]["rows"].tolist() == list(range(6))
    assert out[3]["rows"].tolist() == list(range(6, 12))


def test_global_batch_norm_matches_jax_and_one_process(tmp_path):
    import flax.linen as fnn
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 5, 3).astype(np.float32) * 2 + 0.5
    arrays = dict(x=x, w=rng.randn(*x.shape).astype(np.float32),
                  weight=(rng.rand(6) + 0.5).astype(np.float32),
                  bias=rng.randn(6).astype(np.float32))
    inp = save_inputs(tmp_path / "in.npz", **arrays)
    two = launch(ranks.batch_norms, 2, tmp_path / "two", inputs=inp)
    one = launch(ranks.batch_norms, 1, tmp_path / "one", inputs=inp)[0]
    for k, want in one.items():
        rows = k.endswith(("_y", "_dx"))
        got = np.concatenate([r[k] for r in two]) if rows else two[0][k]
        np.testing.assert_allclose(got, want, rtol=PORT_TOL, atol=PORT_TOL,
                                   err_msg=k)
        if not rows:
            np.testing.assert_array_equal(two[1][k], two[0][k])
    # JAX's BatchNorm (channels last) on the global batch
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    wl = jnp.asarray(np.moveaxis(arrays["w"], 1, -1))
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def f(xv, params):
        y, st = bn.apply({"params": params, "batch_stats": stats}, xv,
                         mutable=["batch_stats"])
        return jnp.sum(y * wl), (y, st)
    (_, (y, st)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            xl, {"scale": jnp.asarray(arrays["weight"]),
                 "bias": jnp.asarray(arrays["bias"])})
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["bn_y"] for r in two]),
                               np.moveaxis(np.asarray(y), -1, 1), **tol)
    np.testing.assert_allclose(np.concatenate([r["bn_dx"] for r in two]),
                               np.moveaxis(np.asarray(dx), -1, 1), **tol)
    np.testing.assert_allclose(two[0]["bn_dw"], np.asarray(dp["scale"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(two[0]["bn_mean"],
                               np.asarray(st["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(two[0]["bn_var"],
                               np.asarray(st["batch_stats"]["var"]), **tol)


def test_draws_keep_the_one_process_rows(tmp_path):
    two = launch(ranks.draws, 2, tmp_path / "two", batch=6)
    one = launch(ranks.draws, 1, tmp_path / "one", batch=6)[0]
    for k, want in one.items():
        got = np.concatenate([two[0][k], two[1][k]])
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the ranks hold different rows, not one rank's draws twice
    assert not np.array_equal(two[0]["jitter"], two[1]["jitter"])


def test_batch_joint_losses_are_the_global_batch_s(tmp_path):
    from segtran_tpu.ops.losses import dice_loss_mix
    from segtran_tpu.train import contrast as jc
    from segtran_tpu.train import da as jda
    rng = np.random.RandomState(4)
    b = 4
    mask = (rng.rand(b, 16, 16, 3) > 0.5).astype(np.float32)
    arrays = dict(
        score=rng.rand(b, 16, 16).astype(np.float32), mask=mask,
        in_s=rng.randn(b, 1, 8, 16).astype(np.float32),
        out_s=rng.randn(b, 1, 16, 8).astype(np.float32),
        feat=rng.randn(b, 4, 4, 6).astype(np.float32),
        bank=rng.randn(3, 5, 6).astype(np.float32),
        valid=(rng.rand(3, 5) > 0.2).astype(np.float32),
        cls_w=np.array([0.0, 0.4, 0.6], np.float32),
        offsets=np.array([1, 2, 1], np.int64))
    inp = save_inputs(tmp_path / "in.npz", **arrays)
    two = launch(ranks.batch_joint_losses, 2, tmp_path / "two", inputs=inp)
    one = launch(ranks.batch_joint_losses, 1, tmp_path / "one",
                 inputs=inp)[0]
    for k, want in one.items():
        if k.startswith("d_"):
            # every rank back-propagates the same global loss, so a rank's
            # raw gradient is the ranks' sum: the step's gradient average
            # (ops.norm.average_gradients) divides it by the world size
            got = np.concatenate([r[k] for r in two]) / 2
        else:
            got = two[0][k]
            np.testing.assert_array_equal(two[1][k], got)
        np.testing.assert_allclose(got, want, rtol=PORT_TOL, atol=1e-7,
                                   err_msg=k)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        two[0]["mix"], np.asarray(dice_loss_mix(j["score"],
                                                j["mask"][..., 1])), **tol)
    np.testing.assert_allclose(two[0]["ac"], np.asarray(
        jda.attention_consistency_loss([(j["in_s"], j["out_s"])],
                                       j["mask"], (4, 4))), **tol)
    # (JAX draws the negative classes from a key; the port's neg is held
    # to its one-process value above)
    pos, _ = jc.calc_contrast_losses(j["feat"], j["mask"], j["bank"],
                                     j["valid"].astype(bool), j["cls_w"])
    np.testing.assert_allclose(two[0]["pos"], np.asarray(pos), **tol)
