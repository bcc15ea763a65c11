"""segtran_tpu_torch stands alone: importing every module of it pulls in
neither JAX nor the JAX package, nor torchvision, timm or
segmentation_models_pytorch (the zoo's backbones and decoders are the
port's own), and its entry points refuse to run without a GPU unless the
CPU is asked for."""
import os
import subprocess
import sys

import pytest
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import segtran_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for want in ("kernels.mbconv", "nn.remat", "nn.backbones.efficientnet",
             "train.trainer", "cli.train2d", "cli.test2d", "data.datasets2d",
             "data.augment", "adapt.revgrad", "adapt.polyformer",
             "models.discriminator", "models.unet2d", "nn.mince",
             "train.da", "train.contrast", "nn.backbones.resnet",
             "nn.backbones.res2net", "nn.backbones.efficientnetv2",
             "nn.vit", "ops.deform_conv", "models.unet_smp",
             "models.deeplab", "models.pranet", "models.nested_unet",
             "models.unet_3plus", "models.att_unet", "models.generic_unet",
             "models.dunet", "models.transunet", "models.setr",
             "convert.torch_import", "convert.cli", "models.vnet",
             "models.unet3d"):
    assert "segtran_tpu_torch." + want in names, want
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "segtran_tpu",
                                    "torchvision", "timm",
                                    "segmentation_models_pytorch"))
print(len(names), bad)
assert not bad, bad
"""


def test_no_jax_and_no_jax_package_imported():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20


_SMOKE_PROBE = r"""
import importlib, pkgutil, sys
import chip_smoke
import segtran_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
sys.path.insert(0, "tests")
import _torch_refsd          # the reference-format writer phase 13 imports
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "flax", "orbax", "segtran_tpu", "PIL"))
print(bad)
assert not bad, bad
"""


def test_no_source_imports_a_model_library():
    """No module of the port, nor chip_smoke.py, imports torchvision, timm
    or segmentation_models_pytorch, not even inside a function (none is
    on the GPU machine)."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(torchvision|timm|"
                     r"segmentation_models_pytorch)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "segtran_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = [p for p in paths if pat.search(open(p).read())]
    assert len(paths) > 60 and not bad, bad


def test_chip_smoke_and_the_port_import_no_jax_and_no_pillow():
    """chip_smoke.py and every module it reaches (the port, and
    tests/_torch_refsd.py, which its import phase writes reference
    checkpoints with) import neither JAX, nor the JAX package, nor
    Pillow, which the GPU machine lacks: reading image files imports it
    at use."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _SMOKE_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch
    from segtran_tpu_torch import resolve_device
    from segtran_tpu_torch.cli.serve import InferenceEngine, build_argparser
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    args = build_argparser().parse_args(["--cpdir", str(tmp_path),
                                         "--iter", "1"])
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        InferenceEngine(args, None)
    from segtran_tpu_torch.cli import test3d, train3d
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        test3d.main(["--cpdir", str(tmp_path), "--wholevol"])
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        train3d.main(["--ckptdir", str(tmp_path), "--fused", "--dropout",
                      "0"])


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with no CUDA here, the
    build step must be reached (and fail), not the plain version."""
    import torch
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import expansion_epilogue as epi

    def refuse(name):
        raise RuntimeError("kernel build reached")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(epi, "_on_cpu", lambda t: False)
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(RuntimeError, match="kernel build reached"):
        epi.fused_private_output_pool(x, torch.zeros(1, 4, 4),
                                      torch.zeros(1, 4), torch.ones(4),
                                      torch.zeros(4), torch.zeros(4, 1),
                                      torch.zeros(1))


def test_cuda_tensors_never_take_the_plain_flash_version(monkeypatch):
    """The same for the flash cross-attention wrapper."""
    import torch
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import squeezed_attention as sa

    def refuse(name):
        raise RuntimeError("kernel build reached")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(sa, "_on_cpu", lambda t: False)
    q = torch.zeros(1, 4, 16)
    with pytest.raises(RuntimeError, match="kernel build reached"):
        sa.fused_cross_attention(q, torch.zeros(1, 8, 16),
                                 torch.zeros(1, 8, 16))


@pytest.mark.parametrize("wrapper", ["flash_backward_dkdv",
                                     "flash_backward_dq"])
def test_cuda_tensors_never_take_the_plain_flash_backward(monkeypatch,
                                                          wrapper):
    """The same for the flash backward's dK/dV and dQ wrappers."""
    import torch
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import squeezed_attention as sa

    def refuse(name):
        raise RuntimeError("kernel build reached")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(sa, "_on_cpu", lambda t: False)
    q, k, v = torch.zeros(1, 4, 16), torch.zeros(1, 8, 16), torch.zeros(1, 8, 16)
    with pytest.raises(RuntimeError, match="kernel build reached"):
        getattr(sa, wrapper)(q, k, v, torch.zeros(1, 4, 16),
                             torch.zeros(1, 4, 1), torch.zeros(1, 4, 1))


def test_cuda_tensors_never_take_the_plain_mbconv_version(monkeypatch):
    """The same for the fused MBConv front half."""
    import torch
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import mbconv as mb

    def refuse(name):
        raise RuntimeError("kernel build reached")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(mb, "_on_cpu", lambda t: False)
    x = torch.zeros(1, 6, 6, 8)
    with pytest.raises(RuntimeError, match="kernel build reached"):
        mb.mbconv_front(x, torch.zeros(8, 48), torch.ones(48),
                        torch.zeros(48), torch.zeros(3, 3, 48),
                        torch.ones(48), torch.zeros(48), kernel=3, stride=1,
                        pad=((1, 1), (1, 1)))
