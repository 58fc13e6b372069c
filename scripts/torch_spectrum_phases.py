"""Where a spectrum kernel's time goes: phase timestamps inside one launch.

    python3 scripts/torch_spectrum_phases.py [spectrum_bypass spectrum_complex spectrum_iir fft_mag_fused]

Builds an instrumented copy of each named kernel (``tpu_sdr_torch/csrc/
<name>.cu``, default: the two radix-FFT kernels) under
``build/spectrum_phases/``: thread 0 of every block records ``clock64`` and
the global timer at the kernel's start, after each ``__syncthreads`` in the
kernel's own body, and at its end. Launches it once at the main path's
shape (F = 512 frames, fp32 in and out, no window) after a warm-up, then
prints per phase the mean and max SM cycles over the blocks, each block's
life (mean, min, max ns) and how the blocks' start times spread over the
launch (the waves). ``spectrum_iir`` runs with zero entry states (its IIR,
in a header, is one phase); ``fft_mag_fused`` with the plan's planes is
persistent (a block walks several frames, six phases each), so a phase's
statistics cover the blocks that reached it. The instrumented copy is for
reading the schedule only: its stores add a few cycles a phase. Needs one
CUDA device.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tpu_sdr_torch.kernels.cuda import launch, loader  # noqa: E402

N = 16384
F = 512
MAX_PHASES = 32

PRELUDE = r"""
__device__ unsigned long long tpu_sdr_phase_ts[%d * %d * 2];
#define TPU_SDR_PHASE()                                                        \
  do {                                                                         \
    if (threadIdx.x == 0) {                                                    \
      unsigned long long g;                                                    \
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g));                 \
      const size_t k = (size_t(blockIdx.x) * %d + tpu_sdr_phase_k) * 2;         \
      tpu_sdr_phase_ts[k] = clock64();                                         \
      tpu_sdr_phase_ts[k + 1] = g;                                             \
    }                                                                          \
    ++tpu_sdr_phase_k;                                                         \
  } while (0)
extern "C" int tpu_sdr_read_phases(void* dst) {
  return int(cudaMemcpyFromSymbol(dst, tpu_sdr_phase_ts, sizeof(tpu_sdr_phase_ts)));
}
"""


def instrument(src: str, name: str) -> str:
    """The kernel body of ``<name>_kernel`` with a timestamp at its start,
    after each barrier and at its end."""
    start = src.index(f"{name}_kernel(")
    body = src.index("{\n", start) + 2
    end = src.index("\n}\n", body)
    inner = src[body:end].replace("__syncthreads();", "__syncthreads(); TPU_SDR_PHASE();")
    inner = "  unsigned tpu_sdr_phase_k = 0;\n  TPU_SDR_PHASE();\n" + inner + "\n  TPU_SDR_PHASE();"
    head = src[:body]
    include = head.index('#include "fft128.cuh"') if "fft128.cuh" in head else head.index("#include")
    line_end = head.index("\n", include) + 1
    prelude = PRELUDE % (F, MAX_PHASES, MAX_PHASES)
    return head[:line_end] + prelude + head[line_end:] + inner + src[end:]


def build(name: str) -> ctypes.CDLL:
    out_dir = REPO / "build" / "spectrum_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(instrument((loader.SOURCE_DIR / f"{name}.cu").read_text(), name))
    lib = out_dir / f"lib{name}.so"
    flags = [f for f in loader.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([loader._nvcc(), *flags, f"-I{loader.SOURCE_DIR}", "-o", str(lib), str(cu)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn = getattr(dll, f"tpu_sdr_{name}")
    fn.argtypes = [types[c] for c in launch._SIGNATURES[name]]
    fn.restype = ctypes.c_int
    return dll


def run(name: str, pp, plan: dict) -> None:
    dll = build(name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((F, N), device="cuda", generator=gen)
    xi = torch.randn((F, N), device="cuda", generator=gen)
    zs = torch.zeros((F, 12), device="cuda")
    out = torch.empty((F, N), device="cuda")
    tab, twr, twi = pp.kernel_constants
    stream = torch.cuda.current_stream().cuda_stream
    consts = (tab.data_ptr(), twr.data_ptr(), twi.data_ptr(), out.data_ptr(), 0, F, stream)
    if name == "spectrum_complex":
        args = (x.data_ptr(), xi.data_ptr(), 0, None, *consts)
    elif name == "spectrum_iir":
        iir = [t.data_ptr() for t in pp.iir_constants]
        args = (x.data_ptr(), zs.data_ptr(), None, *iir, *consts)
    elif name == "fft_mag_fused":
        planes = [plan[k].data_ptr() for k in ("w2r", "w2i", "twr", "twi", "w1r", "w1i")]
        args = (x.data_ptr(), pp.win.data_ptr(), *planes, out.data_ptr(), F, stream)
    else:
        args = (x.data_ptr(), 0, None, *consts)
    fn = getattr(dll, f"tpu_sdr_{name}")
    for _ in range(3):
        assert fn(*args) == 0
    torch.cuda.synchronize()
    ts = np.zeros((F, MAX_PHASES, 2), dtype=np.uint64)
    assert dll.tpu_sdr_read_phases(ctypes.c_void_p(ts.ctypes.data)) == 0
    seen = ts[:, :, 0] != 0
    blocks = np.flatnonzero(seen[:, 0])  # a persistent kernel runs fewer blocks than frames
    used = int(seen[blocks].sum(axis=1).max())
    cyc = ts[blocks, :used, 0].astype(np.int64)
    ns = ts[blocks, :used, 1].astype(np.int64)
    d = np.diff(cyc, axis=1)
    valid = seen[blocks, 1:used]
    print(f"{name}: F={F}, {len(blocks)} blocks, {used - 1} phases (start, after each barrier, end)")
    for k in range(used - 1):
        dk = d[valid[:, k], k]
        print(f"  phase {k:2d}: mean {dk.mean():9.1f} cycles, max {dk.max():7d} ({dk.size} blocks)")
    last = seen[blocks, :used].sum(axis=1) - 1
    life = ns[np.arange(len(blocks)), last] - ns[:, 0]
    t0 = ns[:, 0].min()
    starts = np.sort(ns[:, 0] - t0)
    print(f"  block life: mean {life.mean():.0f} ns, min {life.min()}, max {life.max()}; "
          f"launch span {(ns[:, 0] + life).max() - t0} ns")
    print(f"  block starts (ns after the first): quantiles 0/25/50/75/100 % "
          f"{[int(np.percentile(starts, q)) for q in (0, 25, 50, 75, 100)]}")


def main(argv: list[str]) -> None:
    import scipy.signal as sps

    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline

    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    pipe = SpectrumPipeline(PipelineConfig(channels=8))
    pipe.upload_sos(sps.butter(12, 0.25, output="sos"))
    for name in argv or ["spectrum_bypass", "spectrum_complex"]:
        run(name, pipe.bank_custom["pp"], pipe.plan)


if __name__ == "__main__":
    main(sys.argv[1:])
