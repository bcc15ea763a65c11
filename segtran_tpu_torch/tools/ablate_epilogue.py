"""Where the expansion-epilogue kernel spends its time, by ablation.

    python3 -m segtran_tpu_torch.tools.ablate_epilogue

Builds the CUDA source as it is and in variants with one part removed
(the tensor-core products, the B-fragment loads, the LayerNorm/pool row
pass, the gelu), then times one per-mode launch at F=1792 and one all-modes
launch at F=896 (bf16, the flagship's B=8, M=4, N=1296, A=256) with CUDA
events. A variant computes garbage; only its time is read. The difference
to the unchanged source is that part's share. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from ..kernels import _build

# text to remove -> replacement, per variant
VARIANTS = {
    "as is": None,
    "no products": ("wmma::mma_sync(acc[j], a, b, acc[j]);", ""),
    "no B-fragment loads": (
        "wmma::load_matrix_sync(b, sb + kk * LDB + ch * (NC / CG) + j * 16, LDB);",
        "wmma::fill_fragment(b, __float2bfloat16(1.f));"),
    "no row pass": ("if (r >= rows) continue;  // uniform across the warp",
                    "if (true) continue;"),
    "no gelu": (
        "from_f<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));",
        "from_f<T>(v);"),
}


def _build_variants(out_dir: Path) -> dict:
    src = (_build.CSRC / "expansion_epilogue.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        text = src
        if edit is not None:
            if edit[0] not in text:
                raise RuntimeError(f"variant '{name}': source text not found")
            text = text.replace(edit[0], edit[1])
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant '{name}':\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, i_, d_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.epi_mid_mode.argtypes = [i_] + [vp] * 12 + [i_] * 6 + [d_, vp]
        lib.epi_mid_pool.argtypes = [i_] + [vp] * 12 + [i_] * 5 + [d_, vp]
        libs[name] = lib
    return libs


def _time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_epilogue needs a CUDA GPU")
    libs = _build_variants(_build.BUILD_DIR / "ablate")
    b, m, n, a = 8, 4, 1296, 256
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0))
    for f, entry in ((1792, "epi_mid_mode"), (896, "epi_mid_pool")):
        p = torch.softmax(rn(b, m, n, a, s=4.0), -1).to(bf)
        t = [p, rn(b, m, a, f, s=2.0).to(bf), rn(f, s=0.1).to(bf),
             (rn(m, f, f) / f ** 0.5).to(bf), rn(m, f, s=0.1).to(bf),
             (torch.rand(f, device="cuda") + 0.5).to(bf), rn(f, s=0.1).to(bf),
             rn(f, 1, s=0.02).to(bf), rn(1)]
        out = torch.empty(b, n, f, dtype=bf, device="cuda")
        mid = torch.empty(b, n, f, dtype=bf, device="cuda")
        acc = torch.empty(b, n, f, device="cuda")
        s_out = torch.empty(b, n, device="cuda")
        ptrs = [x.data_ptr() for x in t]
        base = None
        for name, lib in libs.items():
            if entry == "epi_mid_mode":
                def call(lib=lib):
                    return lib.epi_mid_mode(1, *ptrs, out.data_ptr(),
                                            s_out.data_ptr(), mid.data_ptr(),
                                            0, b, m, n, a, f, 1e-12, stream)
            else:
                def call(lib=lib):
                    return lib.epi_mid_pool(1, *ptrs, out.data_ptr(),
                                            mid.data_ptr(), acc.data_ptr(),
                                            b, m, n, a, f, 1e-12, stream)
            if call() != 0:
                raise RuntimeError(f"variant '{name}' failed to launch")
            ms = _time_ms(call)
            base = ms if base is None else base
            print(f"{entry} F={f} {name:20s} {ms:.4f} ms "
                  f"({100 * (base - ms) / base:+.1f}% of the as-is time "
                  f"removed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
