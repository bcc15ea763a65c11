"""``--tp 2 --ep``: the shape rule's expert preference shards the
per-mode private weights ([M, F, F] kernels, [M, F] biases) on their
mode dim; four gloo ranks on a (2, 2) mesh against JAX's
``shard_train_step_2d`` with ``expert_dim_size`` (JAX's bounds) and the
port's one-rank step (1e-5; the gathered checkpoint too)."""
import _torch_parallel_jax as pj
from _torch_parity import one_torch_thread  # noqa: F401


def test_tp2_ep_steps_match_jax_and_one_rank(tmp_path):
    image, mask = pj.batch()
    params, bstats, jlosses, jparams, jstats, spec = pj.jax_steps(
        image, mask, 4, tp=2, expert=True)
    runs = pj.port_runs(tmp_path, image, mask, params, bstats, (4, 1), tp=2,
                        ep=True)
    pj.check_against(runs, 4, jlosses, jparams, jstats, params, bstats)
    sharded = [str(s) for s in runs[4][0][0]["sharded"]]
    mode_dim = [s for s in sharded if s.endswith("group_linear.weight:0")]
    assert mode_dim, sharded
    assert all(int(r["moment_numel"]) < int(runs[1][0][0]["moment_numel"])
               for r in runs[4][0])
