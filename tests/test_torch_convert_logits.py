"""Logits of imported reference checkpoints, the port against JAX on the
CPU: a small Segtran2d (eff-tiny, 2 translayers, 64x64) and Segtran3d
(I3D, 8 attractors, 48x48x16) with the port's seeded init and moved
BatchNorm statistics, written as a reference ``.pth``
(tests/_torch_refsd.py), imported by both packages' ``convert_pth`` and
run in eval: fp32, to 1e-4 (tests/_torch_volume.py's bounds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jvars, one_torch_thread  # noqa: F401
from _torch_refsd import write_reference_pth
from _torch_volume import ATOL, RTOL
from test_torch_convert_import import (SEGTRAN2D_ARGS, SEGTRAN3D_ARGS,
                                       _jax_cli)

CASES = {"segtran2d": (SEGTRAN2D_ARGS, (2, 64, 64, 3)),
         "segtran3d": (SEGTRAN3D_ARGS, (1, 48, 48, 16, 4))}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_imported_segtran_logits_match_jax(kind, tmp_path, monkeypatch):
    from segtran_tpu.convert import cli as jcli
    from segtran_tpu.models import Segtran2d as J2d
    from segtran_tpu.models.segtran3d import Segtran3d as J3d
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    args, shape = CASES[kind]
    cfg = cli.config_from_pth_args(args, kind)
    model = cli.build_model(kind, cfg, args)
    init_with_reference_schemes(model, cfg, seed=2)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    pth = write_reference_pth(str(tmp_path / "iter_7.pth"),
                              model.state_dict(), kind, args, iter_num=7)
    params, bstats = _jax_cli(monkeypatch, jcli.convert_pth, pth,
                              str(tmp_path / "jax"), kind, strict=True)
    jcfg = jcli.config_from_pth_args(args, kind)
    jm = J2d(jcfg) if kind == "segtran2d" else J3d(jcfg)
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(jvars(params, bstats),
                                       jnp.asarray(x)))
    path, tcfg = cli.convert_pth(pth, str(tmp_path / "port"), kind)
    imported = cli.build_model(kind, tcfg, args)
    imported.load_state_dict(load_checkpoint(path, tcfg), strict=True)
    with torch.inference_mode():
        got = imported.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
