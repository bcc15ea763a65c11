"""The port's data-parallel step (``parallel/mesh.py``, ``ops.norm``'s
global batch) on gloo ranks on the CPU (tests/_torch_dist.py): three
steps of the tiny flagship-shaped Segtran2d (eff-tiny, --layercompress
1,1,2, fp32, dropout 0) with a batch-joint term (``dice_loss_mix``) in
the loss, 2 ranks against JAX's ``shard_train_step`` on a 2-device mesh
(JAX's own bounds: loss rtol 1e-4 / atol 1e-5, parameters 2e-4) and
against 1 rank (1e-5: the metrics of every rank, the parameters and
running statistics)."""
import _torch_parallel_jax as pj
from _torch_parity import one_torch_thread  # noqa: F401


def test_segtran2d_steps_match_jax_sharded_and_one_rank(tmp_path):
    image, mask = pj.batch()
    params, bstats, jlosses, jparams, jstats, _ = pj.jax_steps(image, mask, 2)
    runs = pj.port_runs(tmp_path, image, mask, params, bstats, (2, 1))
    pj.check_against(runs, 2, jlosses, jparams, jstats, params, bstats)
