"""Build the hand-written CUDA kernels at first use and load them.

Each source in ``segtran_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which is loaded
through ``ctypes``. Libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of their source and of the shared headers
(``csrc/*.cuh``), so an edited source or header is rebuilt and an
unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC)]
_INCLUDE = re.compile(r'^#include "([^"]+)"\n', re.M)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use on the GPU machine")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def source_text(name: str) -> str:
    """``csrc/<name>.cu`` with its ``#include "..."`` headers inlined: one
    text that the ablation tools edit and build elsewhere."""
    def inline(m):
        return (CSRC / m.group(1)).read_text().replace("#pragma once\n", "")
    return _INCLUDE.sub(inline, (CSRC / f"{name}.cu").read_text())


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name))


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together."""
    with _LOCK:
        procs = [(n, _start(n)) for n in names]
        for n, p in procs:
            _finish(n, p)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _LIBS[name] = lib
    return lib


def all_sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def kernel_flops(op):
    """Register ``formula(*arg shapes, out_shape=..., **kwargs) -> int`` as
    the FLOP count of the custom op ``op`` (a ``torch.ops`` packet, or a
    list of them), so
    that ``torch.utils.flop_counter.FlopCounterMode`` counts a kernel's
    products (which it cannot see inside a ctypes launch) as it counts the
    aten products of the unfused modules. On the CPU the op's plain version
    runs inside the op, hidden from the counter, so the count is the same
    on every device."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    ops = op if isinstance(op, (list, tuple)) else [op]

    def register(formula):
        new = [o for o in ops if o not in flop_registry]
        if new:
            register_flop_formula(new)(formula)
        return formula
    return register
