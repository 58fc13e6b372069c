"""Where a kernel's time goes: phase timestamps inside one launch.

    python3 scripts/torch_spectrum_phases.py [--root OTHER_ROOT] [spectrum_bypass
        spectrum_complex spectrum_iir fft_mag_fused fm_demod pfb_fold_dft iir_summaries]

Builds an instrumented copy of each named kernel (``tpu_sdr_torch/csrc/
<name>.cu`` of this checkout, or of OTHER_ROOT, another checkout such as
the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists; default: the two radix-FFT kernels) under
``build/spectrum_phases/``: thread 0 of every block records ``clock64`` and
the global timer at the kernel's start, after each ``__syncthreads`` (and
each cluster barrier) in the kernel's own body, and at its end. Launches it
once at the main path's shape (F = 512 frames, fp32 in and out, no window;
FM and PFB at 8 x 2^20 samples) after a warm-up, then prints per phase the
mean and max SM cycles
over the blocks, each block's life (mean, min, max ns) and how the blocks'
start times spread over the launch (the waves). ``spectrum_iir`` runs with
zero entry states (its IIR, in a header, is one phase); ``fft_mag_fused``
with the plan's planes is persistent (a block walks several frames, six
phases each), so a phase's statistics cover the blocks that reached it.
``fm_demod`` (with de-emphasis) is one launch of map tiles, walkers and
emit tiles taken by ticket: it prints each kind's start and end over the
launch, the phases of the tiles (compute; an emit tile's wait for its
entry states) and each walker's cycles per 128-sample block (the chain's
barriers are in a header, so a walker's one phase is its whole walk). ``pfb_fold_dft`` (taps 8, real: 8 rows; random planes)
is persistent over tiles of 64 steps and warp specialised: thread 0, a
consumer, stamps the start (the first tile's rows, their fold by four
consumer warps, the planes' split), each tile's products (from the barrier
that hands it the tile's pieces to its stores) and its wait for the next
tile's pieces, summed over the tiles by kind. ``iir_summaries`` runs at F =
512 with the plan of butter(12, 0.25), its arguments bound by the names in
the source's C entry point (so another tree's form of the kernel runs
too); its persistent clusters stamp after each batch's barriers. The
instrumented copy is for reading the schedule only: its stores add a few
cycles a phase. Needs one CUDA device.
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

from tpu_sdr_torch.kernels.cuda import loader  # noqa: E402

N = 16384
F = 512
MAX_PHASES = 64
MAX_BLOCKS = 4096
# The kernel each name instruments, where it is not <name>_kernel.
KERNEL = {"fm_demod": "fm_fused"}
FM_C, FM_T = 8, 1 << 20

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
__device__ int tpu_sdr_phase_id[%d];
extern "C" int tpu_sdr_read_ids(void* dst) {
  return int(cudaMemcpyFromSymbol(dst, tpu_sdr_phase_id, sizeof(tpu_sdr_phase_id)));
}
"""


def instrument(src: str, name: str) -> str:
    """The kernel body of ``<name>_kernel`` with a timestamp at its start,
    after each barrier and at its end."""
    start = src.index(f"{name}_kernel(")
    body = src.index("{\n", start) + 2
    end = src.index("\n}\n", body)
    inner = src[body:end].replace("__syncthreads();", "__syncthreads(); TPU_SDR_PHASE();")
    inner = inner.replace("cluster.sync();", "cluster.sync(); TPU_SDR_PHASE();")
    # the PFB kernel's consumers: a stamp as each tile's products start and end
    inner = inner.replace("bar_sync(kFull + (i & 1), kThreads);",
                          "bar_sync(kFull + (i & 1), kThreads); TPU_SDR_PHASE();")
    inner = inner.replace("bar_arrive(kEmpty + (i & 1), kThreads);",
                          "TPU_SDR_PHASE(); bar_arrive(kEmpty + (i & 1), kThreads);")
    # a kernel that takes tickets: each block's ticket
    inner = inner.replace("const int id = ticket;\n",
                          "const int id = ticket;\n  if (threadIdx.x == 0) tpu_sdr_phase_id[blockIdx.x] = id;\n")
    inner = "  unsigned tpu_sdr_phase_k = 0;\n  TPU_SDR_PHASE();\n" + inner + "\n  TPU_SDR_PHASE();"
    head = src[:body]
    include = head.index('#include "fft128.cuh"') if "fft128.cuh" in head else head.index("#include")
    line_end = head.index("\n", include) + 1
    prelude = PRELUDE % (MAX_BLOCKS, MAX_PHASES, MAX_PHASES, MAX_BLOCKS)
    return head[:line_end] + prelude + head[line_end:] + inner + src[end:]


def signature(src_dir: Path, name: str) -> list[str]:
    """The parameter declarations of ``tpu_sdr_<name>`` in src_dir/<name>.cu."""
    text = (src_dir / f"{name}.cu").read_text()
    m = re.search(rf"int tpu_sdr_{name}\((.*?)\)\s*{{", text, re.S)
    return [a.strip() for a in m.group(1).split(",")]


def build(name: str, src_dir: Path) -> tuple[ctypes.CDLL, list[str]]:
    """The instrumented library of src_dir/<name>.cu and the names of its
    entry point's parameters."""
    out_dir = REPO / "build" / "spectrum_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(instrument((src_dir / f"{name}.cu").read_text(), KERNEL.get(name, name)))
    lib = out_dir / f"lib{name}.so"
    flags = [f for f in loader.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([loader._nvcc(), *flags, f"-I{src_dir}", "-o", str(lib), str(cu)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    params = signature(src_dir, name)
    fn = getattr(dll, f"tpu_sdr_{name}")
    fn.argtypes = [ctypes.c_void_p if "*" in a else ctypes.c_float if a.startswith("float")
                   else ctypes.c_int for a in params]
    fn.restype = ctypes.c_int
    return dll, [a.split()[-1].lstrip("*") for a in params]


def run(name: str, pp, plan: dict, src_dir: Path = loader.SOURCE_DIR) -> None:
    dll, params = build(name, src_dir)
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
    elif name == "fm_demod":  # de-emphasis on
        re, im = x.reshape(FM_C, FM_T), xi.reshape(FM_C, FM_T)
        z = torch.zeros(FM_C, device="cuda")
        outs = [torch.empty((FM_C, FM_T), device="cuda"),
                *(torch.empty(FM_C, device="cuda") for _ in range(3))]
        blocks = FM_T // 128
        ab, y_in = torch.empty(FM_C * blocks * 2, device="cuda"), torch.empty(FM_C * blocks, device="cuda")
        pole = float(np.float32(np.exp(-1.0 / (200e3 * 75e-6))))
        sync = torch.empty(1 + FM_C * (1 + blocks), dtype=torch.int32, device="cuda")
        args = (re.data_ptr(), im.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(),
                *(o.data_ptr() for o in outs), ab.data_ptr(), y_in.data_ptr(), sync.data_ptr(),
                FM_C, blocks, float(np.float32(200e3 / (2 * np.pi))), float(np.float32(1 / 75e3)),
                pole, float(np.float32(1) - np.float32(pole)), 1, stream)
    elif name == "pfb_fold_dft":  # taps 8, real input's 8 rows, random planes
        rows, h2, cos, sin = (torch.randn(shape, device="cuda", generator=gen)
                              for shape in ((8, 8199, 128), (8, 128), (128, 128), (128, 128)))
        a, b = (torch.empty((8, 8192, 128), device="cuda") for _ in range(2))
        args = (rows.data_ptr(), h2.data_ptr(), cos.data_ptr(), sin.data_ptr(), a.data_ptr(),
                b.data_ptr(), 8, 8199, 8, 1, stream)
    elif name == "iir_summaries":  # the arguments by name: any tree's form of the kernel
        _, pt, _, al1t = pp.iir_constants
        values = dict(x=x, win=pp.win, pt=pt, al1t=al1t, kw=pp.summary_matrix,
                      out=torch.empty((F, 12), device="cuda"), frames=F, stream=stream)
        args = tuple(v.data_ptr() if isinstance(v, torch.Tensor) else v
                     for v in (values[p] for p in params))
    else:
        args = (x.data_ptr(), 0, None, *consts)
    fn = getattr(dll, f"tpu_sdr_{name}")
    for _ in range(3):
        assert fn(*args) == 0
    torch.cuda.synchronize()
    ts = np.zeros((MAX_BLOCKS, MAX_PHASES, 2), dtype=np.uint64)
    assert dll.tpu_sdr_read_phases(ctypes.c_void_p(ts.ctypes.data)) == 0
    if name == "fm_demod":
        ids = np.zeros(MAX_BLOCKS, dtype=np.int32)
        assert dll.tpu_sdr_read_ids(ctypes.c_void_p(ids.ctypes.data)) == 0
        return fm_timeline(ts, ids)
    seen = ts[:, :, 0] != 0
    blocks = np.flatnonzero(seen[:, 0])  # a persistent kernel runs fewer blocks than frames
    used = int(seen[blocks].sum(axis=1).max())
    cyc = ts[blocks, :used, 0].astype(np.int64)
    ns = ts[blocks, :used, 1].astype(np.int64)
    d = np.diff(cyc, axis=1)
    valid = seen[blocks, 1:used]
    print(f"{name}: F={F}, {len(blocks)} blocks, {used - 1} phases (start, after each barrier, end)")
    if name == "pfb_fold_dft":  # three start phases, then (products, wait) a tile
        for k, kind in enumerate(("the first tile's rows", "its fold by four consumer warps",
                                  "the planes' split")):
            print(f"  start, {kind}: mean {d[:, k].mean():9.1f} cycles")
        for kind, k0 in (("products and stores", 3), ("wait for the next tile's pieces", 4)):
            dk = d[:, k0::2][valid[:, k0::2]]
            print(f"  {kind}: mean {dk.mean():9.1f} cycles a tile, max {dk.max():7d} "
                  f"({dk.size} tiles)")
    else:
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


def fm_timeline(ts: np.ndarray, ids: np.ndarray) -> None:
    """The one-launch FM kernel's blocks by ticket (csrc/fm_demod.cu's order:
    each channel's map tiles and then its walker, then the emit tiles):
    their start and end (ns after the launch's first block) and phases
    (cycles)."""
    tile = 64  # blocks of a map or emit tile
    tiles = FM_T // 128 // tile
    per = tiles + 1
    n = FM_C * (2 * tiles + 1)
    ns = ts[:n, :, 1].astype(np.int64)
    cyc = ts[:n, :, 0].astype(np.int64)
    t0 = ns[:, 0].min()
    tk = ids[:n]
    kind = np.where(tk >= FM_C * per, "emit", np.where(tk % per == tiles, "walker", "map"))
    # stamps: start, ticket, [map or wait barrier,] end; a block's slots past
    # its own may hold an earlier launch's stamps
    end_at = np.where(kind == "walker", 2, 3)
    last = ns[np.arange(n), end_at] - t0
    first = ns[:, 0] - t0
    q = lambda a: [int(np.percentile(a, p)) for p in (0, 25, 50, 75, 100)]
    print(f"fm_demod: {n} blocks ({FM_C} x {tiles} map tiles of {tile} blocks, {FM_C} "
          f"walkers, {FM_C} x {tiles} emit tiles); launch span {last.max()} ns")
    for k in ("map", "walker", "emit"):
        sel = kind == k
        print(f"  {k:6s} ({sel.sum()}): start ns quantiles 0/25/50/75/100 % {q(first[sel])}, "
              f"end {q(last[sel])}")
    for i in np.flatnonzero(kind == "walker"):
        print(f"  walker of channel {tk[i] // per}: ticket {tk[i]}, ns {first[i]} .. "
              f"{last[i]}, {(cyc[i, 2] - cyc[i, 1]) / (FM_T // 128):.2f} cycles a 128-sample block")
    for k, label in (("map", "compute"), ("emit", "wait for the entry states")):
        sel = kind == k
        print(f"  {k} tiles, {label}: mean {(cyc[sel, 2] - cyc[sel, 1]).mean():.0f} cycles")
    sel = kind == "emit"
    print(f"  emit tiles, compute: mean {(cyc[sel, 3] - cyc[sel, 2]).mean():.0f} cycles")


def main(argv: list[str]) -> None:
    import scipy.signal as sps

    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline

    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    pipe = SpectrumPipeline(PipelineConfig(channels=8))
    pipe.upload_sos(sps.butter(12, 0.25, output="sos"))
    src_dir = loader.SOURCE_DIR
    if argv[:1] == ["--root"]:
        src_dir, argv = Path(argv[1]).resolve() / "tpu_sdr_torch" / "csrc", argv[2:]
    for name in argv or ["spectrum_bypass", "spectrum_complex"]:
        run(name, pipe.bank_custom["pp"], pipe.plan, src_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
