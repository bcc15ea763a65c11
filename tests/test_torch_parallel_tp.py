"""``--tp``: the port's sharded optimizer state and master weights
(``parallel/tensor_parallel.py``) on a (2 data x 2 model) mesh of four
gloo ranks, against JAX's ``shard_train_step_2d`` on the same mesh
(JAX's bounds: loss rtol 1e-4 / atol 1e-5, parameters 2e-4) and the
port's one-rank step (1e-5; the gathered checkpoint equal to the
one-rank one); each rank holds half of every sharded leaf's moments; the
shape rule's edges as JAX's (tests/test_training.py:181)."""

import _torch_parallel_jax as pj
from _torch_parity import one_torch_thread  # noqa: F401


def test_rule_edges_match_jax():
    from segtran_tpu.parallel.mesh import make_mesh
    from segtran_tpu.parallel.tensor_parallel import leaf_sharding_rule as jr
    from segtran_tpu_torch.parallel.tensor_parallel import leaf_sharding_rule
    import jax.numpy as jnp
    mesh = make_mesh(8, axes=("data", "model"), shape=(2, 4))
    shapes = [(), (1280,), (64, 64), (1280, 320), (320, 1280), (1283, 512),
              (1283, 517, 33), (4, 256, 256), (4, 256), (3, 256, 256)]
    for ep in (None, 4, 3):
        jrule = jr(mesh, min_size=1 << 14, expert_dim_size=ep)
        rule = leaf_sharding_rule(axis_size=4, min_size=1 << 14,
                                  expert_dim_size=ep)
        for shape in shapes:
            spec = tuple(jrule(jnp.zeros(shape)).spec)
            want = spec.index("model") if "model" in spec else None
            got = rule(shape)
            assert getattr(got, "dim", None) == want, (shape, ep, got, spec)
    assert not leaf_sharding_rule(axis_size=1)((4096, 4096)).is_shard()


def test_tp2_steps_match_jax_and_one_rank(tmp_path):
    image, mask = pj.batch()
    params, bstats, jlosses, jparams, jstats, _ = pj.jax_steps(
        image, mask, 4, tp=2)
    runs = pj.port_runs(tmp_path, image, mask, params, bstats, (4, 1), tp=2)
    pj.check_against(runs, 4, jlosses, jparams, jstats, params, bstats)
    many, one = runs[4][0], runs[1][0]
    # the moments of the sharded leaves are halved on every rank
    assert all(int(r["moment_numel"]) < int(one[0]["moment_numel"]) * 0.75
               for r in many)
    assert len(many[0]["sharded"]) > 4
    # between steps a rank holds its slices, not the full parameters
    assert all(int(r["held_numel"]) < int(one[0]["param_numel"]) * 0.75
               for r in many)


def test_sharded_state_dict_round_trip():
    """convert/sharded.py carries a full state_dict to each rank's share of
    the rule's sharding and back, offline; the shares hold 1/2 of every
    sharded tensor and the rest whole."""
    import torch
    from _torch_parallel_ranks import tiny_segtran2d
    from segtran_tpu_torch.convert.sharded import (state_dict_from_sharded,
                                                   state_dict_to_sharded)
    from segtran_tpu_torch.parallel.tensor_parallel import state_sharding_spec
    model, cfg = tiny_segtran2d()
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point()
          else v for k, v in model.state_dict().items()}
    spec = state_sharding_spec(model, axis_size=2,
                               expert_dim_size=cfg.num_modes)
    shares = [state_dict_to_sharded(sd, spec, i, 2) for i in range(2)]
    sharded = [k for k, v in spec.items() if hasattr(v, "dim")]
    assert len(sharded) > 4
    for k in sd:
        full, part = sd[k], shares[1][k]
        if k in sharded:
            assert part.numel() * 2 == full.numel(), k
        else:
            assert part is full, k
    back = state_dict_from_sharded(shares, spec)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
