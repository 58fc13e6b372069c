"""One kernel of two source trees on the same inputs: bits and times.

    python3 scripts/torch_kernel_ab.py OTHER_ROOT [fft_mag_fused fm_demod pfb_fold_dft pfb_fold_dft_iq
                                                  iir_summaries sosfilt_q15 sosfilt_q15_4rows
                                                  viterbi viterbi_k12 q15_fft q15_fft_f8 q15_fft_f64]
    python3 scripts/torch_kernel_ab.py --variant {fmax_tree,one_imad,shfl_up,no_store,c1,c2,c4,c16,
                                                  phases} [LABEL ...]

Builds ``tpu_sdr_torch/csrc/<name>.cu`` of this checkout and of OTHER_ROOT
(another checkout, for example the parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists) with the loader's nvcc
flags, each against its own headers, under ``build/kernel_ab/``. Calls both
libraries' entry points with the same inputs at the main path's shape (row
6: 512 frames of 16384 with the plan's planes; row 7: 8 x 2^20 samples
with de-emphasis; row 8: 8 x 2^20 real samples or (2, 8, 2^20) IQ planes,
taps 8, random planes; row 3: 512 frames with the plan of butter(12, 0.25),
each tree's entry point given the arguments it names: the window and the
chain's constants, or the plan's summary_matrix; K2: 1 or 4 rows of 2
frames, the window and 6 sections, the Q15 path's; K3: 64 rows x 2054
steps of the burst path's K = 7 code, or 4 x 523 at k = 12; K1: F = 1 (the
main path's shape), or F = 8 or 64 with ``_f8`` / ``_f64``, frames of 16384
random int16, no window, the schedule all ones), reports whether every
output is bit for bit the same as OTHER_ROOT's (and how far apart), then
times them in turns (other, this, this, other; CUDA events around 20
launches queued behind a spin kernel, as ``chip_smoke.py`` times). Needs one
CUDA device.

With ``--variant NAME`` the other tree is this checkout's csrc with the
edits of ``VARIANTS[NAME]`` (under ``build/kernel_variants/NAME/``): a design
choice that K1, K2 or K3 replaced, so that its time stands beside the kernel's.
Each edit's old text must be in the source once, else the script exits.

- ``fmax_tree`` (K3): the step's maximum as a 5-level ``__shfl_xor_sync``
  tree of ``fmaxf``, in place of one ``__reduce_max_sync`` of
  order-preserving integer keys;
- ``one_imad`` (K2): the rounding as ``acc + 32 + (acc >> 31)`` after one
  multiply-add, in place of acc and acc + 32 from two multiply-adds side by
  side (six dependent operations a step, not five);
- ``shfl_up`` (K2): each section's output handed to the next section by a
  ``__shfl_up_sync`` a step (lane s at step j filters sample j - s), in
  place of shared memory a 32-step chunk later;
- ``no_store`` (K2, a diagnostic, not a design): the last lane's 16-byte
  output stores left out (the vectors are still packed), so that y is not
  written; what the stores cost;
- ``c1``, ``c2``, ``c4``, ``c16`` (K1): a frame of 16384 on a cluster of
  1, 2, 4 or 16 CTAs in place of 8 (``kClusterCtas``; 16 is the H100's
  non-portable cluster size). Give the labels ``q15_fft q15_fft_f8
  q15_fft_f64`` to time each at F = 1, 8 and 64;
- ``phases`` (K1, a diagnostic): where a launch's time goes. Thread 0 of
  every CTA of the cluster route records ``clock64`` at its start, around
  A1 (ranks 0-3), after the Y barrier, after A2 (ranks 4-6), once its X
  points have come, around B1 (ranks 7-10), after B2 (ranks 11-13), once
  its W points have come and at its end (after the store and the exit
  barrier), and the global timer at its start and end. After the times,
  one more launch of each label, and one at F = 1 without |X| (the
  magnitude's share of the store), print the CTAs' span on the global
  timer and per phase the median and the largest SM cycles over the CTAs.
  The stamps add a few cycles a phase.

All but ``no_store`` compute the same function, so a variant whose bits
differ fails; ``no_store``'s y is expected to differ.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tpu_sdr_torch.kernels.cuda import loader  # noqa: E402

HOLD_CYCLES = 100_000_000
TURNS = 3

_MAX_KEY = """  int key = __float_as_int(v);
  key ^= (key >> 31) & 0x7fffffff;
  if (Trellis<K>::LANES < 32 && int(threadIdx.x & 31) >= Trellis<K>::LANES) key = INT_MIN;
  int m = __reduce_max_sync(kFull, key);
  m ^= (m >> 31) & 0x7fffffff;
  return __int_as_float(m);"""
_ROUND_TWO_IMADS = """  int acc32;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(acc32) : "r"(neg_a1), "r"(y_prev), "r"(q_bracket + 32));
  return min(max((acc32 + (acc >> 31)) >> 6, -32768), 32767);"""
_OUT_STORE = "      *(put ? reinterpret_cast<uint4*>(y_row) + (i - (kVec - 1)) / kVec : sink) = w;"
# The last lane's ring, indexed by its sample (i = j0 + u - LAG, j0 a
# multiple of the chunk), so that a ring of 8 is one aligned vector at any
# lag.
_RING_SLOT = "(u + kVec - Sh::LAG % kVec) % kVec"

_MAX_CTAS = 8192
_STAMP_PRELUDE = f"""
__device__ long long tpu_sdr_q15_clk[{_MAX_CTAS}][11];
__device__ long long tpu_sdr_q15_glb[{_MAX_CTAS}][2];
#define STAMP(i)                                                              \\
  do {{                                                                        \\
    if (threadIdx.x == 0 && blockIdx.x < {_MAX_CTAS}) {{                          \\
      tpu_sdr_q15_clk[blockIdx.x][i] = clock64();                             \\
      if ((i) == 0 || (i) == 10) {{                                            \\
        long long t;                                                          \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \\
        tpu_sdr_q15_glb[blockIdx.x][(i) == 0 ? 0 : 1] = t;                    \\
      }}                                                                       \\
    }}                                                                         \\
  }} while (0)
extern "C" int tpu_sdr_q15_stamps(long long* clk, long long* glb) {{
  cudaMemcpyFromSymbol(clk, tpu_sdr_q15_clk, sizeof(tpu_sdr_q15_clk));
  return int(cudaMemcpyFromSymbol(glb, tpu_sdr_q15_glb, sizeof(tpu_sdr_q15_glb)));
}}
"""
_PHASES = ["start", "A1 issued", "A1 done", "Y barrier", "A2 done", "X came", "B1 issued",
           "B1 done", "B2 done", "W came", "end"]

VARIANTS = {  # name -> (kernel source, case label, exact, [(old text, new text), ...])
    "fmax_tree": ("viterbi", "viterbi", True, [(_MAX_KEY, """#pragma unroll
  for (int o = Trellis<K>::LANES / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;""")]),
    "one_imad": ("sosfilt_q15", "sosfilt_q15", True, [(_ROUND_TWO_IMADS, """\
  return min(max((acc + 32 + (acc >> 31)) >> 6, -32768), 32767);""")]),
    "shfl_up": ("sosfilt_q15", "sosfilt_q15", True, [
        ("static constexpr int LAG = kChunk * (S - 1);", "static constexpr int LAG = S - 1;"),
        ("    const int v = vin[u];\n",
         "    const int up = __shfl_up_sync(0xffffffffu, ln.y, 1, Sh::G);\n"
         "    const int v = sec == 0 ? vin[u] : up;\n"),
        ("const int i = j0 + u - kChunk * sec;", "const int i = j0 + u - sec;"),
        ("ln.ring[u % kVec] = y;", f"ln.ring[{_RING_SLOT}] = y;"),
        ("if (u % kVec == kVec - 1) {", f"if ({_RING_SLOT} == kVec - 1) {{"),
    ]),
    **{f"c{c}": ("q15_fft", "q15_fft", True, [("constexpr int kClusterCtas = 8;",
                                               f"constexpr int kClusterCtas = {c};")])
       for c in (1, 2, 4, 16)},
    "phases": ("q15_fft", "q15_fft", True, [
        ('#include "error_string.cuh"\n', '#include "error_string.cuh"\n' + _STAMP_PRELUDE),
        ("  const size_t base = size_t(blockIdx.x / kC) * kN;\n",
         "  const size_t base = size_t(blockIdx.x / kC) * kN;\n  STAMP(0);\n"),
        ("  pass<4>(re, im, wa1, s);  // A1: ranks 0-3\n",
         "  STAMP(1);\n  pass<4>(re, im, wa1, s);  // A1: ranks 0-3\n  STAMP(2);\n"),
        ("  __syncthreads();\n#pragma unroll\n  for (int k = 0; k < kPoints; ++k) {\n"
         "    const uint32_t v = yz[",
         "  __syncthreads();\n  STAMP(3);\n#pragma unroll\n  for (int k = 0; k < kPoints; ++k) {\n"
         "    const uint32_t v = yz["),
        ("  pass<3, 2>(re, im, wa2, s + 4);  // A2: ranks 4-6, two groups of 8\n",
         "  pass<3, 2>(re, im, wa2, s + 4);  // A2: ranks 4-6, two groups of 8\n  STAMP(4);\n"),
        ("  // Phase B: rows.", "  STAMP(5);\n  // Phase B: rows."),
        ("  pass<4>(re, im, wb1, s + 7);  // B1: ranks 7-10\n",
         "  STAMP(6);\n  pass<4>(re, im, wb1, s + 7);  // B1: ranks 7-10\n  STAMP(7);\n"),
        ("  pass<3, 2>(re, im, wb2, s + 11);  // B2: ranks 11-13, two groups of 8\n",
         "  pass<3, 2>(re, im, wb2, s + 11);  // B2: ranks 11-13, two groups of 8\n  STAMP(8);\n"),
        ("  // The store: unit v", "  STAMP(9);\n  // The store: unit v"),
        ("  if constexpr (kC > 1) cluster_wait();  // no store into any CTA of the cluster is in "
         "flight\n}",
         "  if constexpr (kC > 1) cluster_wait();  // no store into any CTA of the cluster is in "
         "flight\n  STAMP(10);\n}"),
    ]),
    "no_store": ("sosfilt_q15", "sosfilt_q15", False, [(_OUT_STORE, (
        "      if (put && w.x == 0x12345678u && w.y == 0x9abcdef0u) *sink = w;  // never, in effect"))]),
}


def signature(src: Path, name: str) -> list[str]:
    """The parameter list of ``tpu_sdr_<name>`` in src/<name>.cu."""
    text = (src / f"{name}.cu").read_text()
    m = re.search(rf"int tpu_sdr_{name}\((.*?)\)\s*{{", text, re.S)
    return [a.strip() for a in m.group(1).split(",")]


_BUILT = {}


def build(root: Path, name: str, tag: str):
    """(entry point, its parameter declarations) of root's <name>.cu, built
    once a process."""
    if (root, name, tag) not in _BUILT:
        _BUILT[root, name, tag] = _build(root, name, tag)
    return _BUILT[root, name, tag]


def _build(root: Path, name: str, tag: str):
    src = root / "tpu_sdr_torch" / "csrc"
    out = REPO / "build" / "kernel_ab" / f"{tag}-{root.name}"  # one library a tree
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    flags = [f for f in loader.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([loader._nvcc(), *flags, f"-I{src}", "-o", str(lib), str(src / f"{name}.cu")],
                   check=True)
    params = signature(src, name)
    fn = getattr(ctypes.CDLL(str(lib)), f"tpu_sdr_{name}")
    fn.argtypes = [ctypes.c_void_p if "*" in a else ctypes.c_float if a.startswith("float")
                   else ctypes.c_int for a in params]
    fn.restype = ctypes.c_int
    return fn, [a.split()[-1].lstrip("*") for a in params]


def variant_root(name: str) -> Path:
    """A tree whose csrc is this checkout's with the variant's edits."""
    src, _, _, edits = VARIANTS[name]
    root = REPO / "build" / "kernel_variants" / name
    csrc = root / "tpu_sdr_torch" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(REPO / "tpu_sdr_torch" / "csrc", csrc)
    text = (csrc / f"{src}.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old.strip()[:60]!r} is not in csrc/{src}.cu once")
        text = text.replace(old, new)
    (csrc / f"{src}.cu").write_text(text)
    return root


def case(label: str):
    """(source name, a function that returns ({parameter name: value}, outputs))."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
    if label == "fft_mag_fused":
        from tpu_sdr_torch.kernels import fft, window

        x, win = rand(512, 16384), window.hann_coefficients(16384, device="cuda")
        plan = fft.plan_constants(128, 128, device="cuda")

        def args():
            out = torch.empty_like(x)
            return dict(x=x, win=win, out=out, frames=512, **{k: plan[k] for k in
                        ("w2r", "w2i", "twr", "twi", "w1r", "w1i")}), [out]

        return label, args
    if label == "iir_summaries":
        import scipy.signal as sps

        from tpu_sdr_torch.kernels import fft, window
        from tpu_sdr_torch.kernels.cuda import iir_fft

        pp = iir_fft.build_plan(sps.butter(12, 0.25, output="sos"),
                                window.hann_coefficients(16384, device="cuda"),
                                fft.plan_constants(128, 128, device="cuda"))
        x = rand(512, 16384)
        _, pt, _, al1t = pp.iir_constants

        def args():
            out = torch.empty((512, 12), device="cuda")
            return dict(x=x, win=pp.win, pt=pt, al1t=al1t, kw=pp.summary_matrix, out=out,
                        frames=512), [out]

        return label, args
    if label == "fm_demod":
        c, t = 8, 1 << 20
        re_, im_ = rand(c, t), rand(c, t)
        pr, pi, y0 = rand(c, 1), rand(c, 1), 0.1 * rand(c)
        pole = np.float32(np.exp(-1.0 / (200e3 * 75e-6)))

        def args():
            outs = [torch.empty((c, t), device="cuda"), *(torch.empty(c, device="cuda") for _ in range(3))]
            return dict(re=re_, im=im_, prev_re=pr, prev_im=pi, y0=y0, audio=outs[0],
                        prev_re_out=outs[1], prev_im_out=outs[2], filt_out=outs[3],
                        ab=torch.empty(c * t // 128 * 2, device="cuda"),
                        y_in=torch.empty(c * t // 128, device="cuda"),
                        sync=torch.empty(1 + c * (1 + t // 128), dtype=torch.int32, device="cuda"),
                        channels=c, blocks=t // 128, k_hz=float(np.float32(200e3 / (2 * np.pi))),
                        k_dev=float(np.float32(1 / 75e3)), pole=float(pole),
                        one_minus_pole=float(np.float32(1) - pole), has_pole=1), outs

        return label, args
    if label.startswith("sosfilt_q15"):
        from tpu_sdr_torch.kernels import window

        rows = 4 if label == "sosfilt_q15_4rows" else 1
        sos = torch.tensor([[1, 2, 1, 64, -73, 21], [64, 128, 64, 64, -84, 33],
                            [64, 127, 64, 64, -106, 65]] + [[64, 0, 0, 64, 0, 0]] * 3,
                           dtype=torch.int32, device="cuda")
        tone = 0.9 * 32767 * torch.sin(torch.arange(2 * 16384, device="cuda") * 0.0628)
        x = (tone + 300 * rand(rows, 2 * 16384)).round().clamp(-32768, 32767).to(torch.int16)
        rom = window.hann_q16_rom(16384, device="cuda")
        zi = torch.zeros((rows, 6, 2), dtype=torch.int32, device="cuda")

        def args():
            xw, y, zf = torch.empty_like(x), torch.empty_like(x), torch.empty_like(zi)
            return dict(sos=sos, sections=6, x=x, rows=rows, t_len=x.shape[1], rom=rom,
                        n_rom=rom.shape[0], zi=zi, xw=xw, y=y, zf=zf), [xw, y, zf]

        return "sosfilt_q15", args
    if label.startswith("q15_fft"):
        from tpu_sdr_torch.kernels import fft_q15

        f = re.search(r"_f(\d+)$", label)
        frames = int(f.group(1)) if f else 1
        x = (torch.randn((frames, 16384), device="cuda", generator=gen) * 6000).to(torch.int16)
        tw, sched = fft_q15._kernel_tables(16384, (1,) * 14, "cuda")

        def args():
            outs = [torch.empty_like(x), torch.empty_like(x), torch.empty(x.shape, device="cuda")]
            return dict(x_re=x, x_im=None, rom=None, tw=tw, sched=sched, out_re=outs[0],
                        out_im=outs[1], mag=outs[2], frames=frames, log2n=14), outs

        return "q15_fft", args
    if label.startswith("viterbi"):
        from tpu_sdr_torch.kernels import fec

        k, polys, rows, t = ((12, (0o4335, 0o5723), 4, 523) if label == "viterbi_k12"
                             else (7, (0o133, 0o171), 64, 2054))
        code = fec.ConvCode(k, polys, device="cuda")
        x = rand(rows, t, 2)

        def args():
            bits = torch.empty((rows, t), dtype=torch.uint8, device="cuda")
            dec = torch.empty((rows, t, max(code.n_states // 32, 1)), dtype=torch.int32,
                              device="cuda")
            return dict(x=x, out0=code._tables["out0"], out1=code._tables["out1"], dec=dec,
                        bits=bits, rows=rows, t_len=t, n_out=2, k=k), [bits]

        return "viterbi", args
    batch = 16 if label == "pfb_fold_dft_iq" else 8
    rows, h2, cos, sin = rand(batch, 8192 + 7, 128), rand(8, 128), rand(128, 128), rand(128, 128)

    def args():
        a, b = (torch.empty((batch, 8192, 128), device="cuda") for _ in range(2))
        return dict(rows=rows, h2=h2, cos=cos, sin=sin, a=a, b=b, batch=batch, r_rows=8199,
                    taps=8, neg_b=int(batch == 8)), [a, b]

    return "pfb_fold_dft", args


def bind(fn, names, values: dict):
    """fn() called with the values of its parameters, by name."""
    conv = [v.data_ptr() if isinstance(v, torch.Tensor) else v
            for v in (values[n] for n in names if n != "stream")]

    def call():
        err = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return call


def ms(call, iters=20):
    for _ in range(3):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_report(lib: Path, call, frames: int, what: str) -> None:
    """One launch of the stamped K1 (``--variant phases``): the CTAs' span
    on the global timer and the SM cycles of each phase."""
    call()
    torch.cuda.synchronize()
    clk = np.zeros((_MAX_CTAS, 11), np.int64)
    glb = np.zeros((_MAX_CTAS, 2), np.int64)
    dll = ctypes.CDLL(str(lib))
    dll.tpu_sdr_q15_stamps(clk.ctypes.data_as(ctypes.c_void_p), glb.ctypes.data_as(ctypes.c_void_p))
    ctas = frames * dll.tpu_sdr_q15_fft_route(frames, 14)
    d = np.diff(clk[:ctas].astype(np.float64), axis=1)
    g = glb[:ctas]
    life = g[:, 1] - g[:, 0]
    print(f"{what}: {ctas} CTAs; global timer: span {(g[:, 1].max() - g[:, 0].min()) / 1e3:.2f} us, "
          f"starts spread {(g[:, 0].max() - g[:, 0].min()) / 1e3:.2f} us, CTA life median "
          f"{np.median(life) / 1e3:.2f} us, max {life.max() / 1e3:.2f} us")
    print("   SM cycles a phase (median / max over the CTAs): " + "; ".join(
        f"{_PHASES[i]} -> {_PHASES[i + 1]} {np.median(d[:, i]):.0f} / {d[:, i].max():.0f}"
        for i in range(10)), flush=True)


def main(argv):
    exact = False
    if argv[0] == "--variant":
        other, labels = variant_root(argv[1]), argv[2:] or [VARIANTS[argv[1]][1]]
        exact = VARIANTS[argv[1]][2]
    else:
        other = Path(argv[0]).resolve()
        labels = argv[1:] or ["fft_mag_fused", "fm_demod", "pfb_fold_dft", "pfb_fold_dft_iq"]
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    for label in labels:
        src, make = case(label)
        builds = {"other": build(other, src, "other"), "this": build(REPO, src, "this")}
        outs, calls = {}, {}
        for tag, (fn, names) in builds.items():
            values, out = make()
            calls[tag] = bind(fn, names, values)
            calls[tag]()
            torch.cuda.synchronize()
            outs[tag] = out
        same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(outs["other"], outs["this"]))
        scale = max(a.float().abs().max().item() for a in outs["other"])
        print(f"{label}: bitwise equal={same} (max abs diff {diff:.3e}, of max |other| "
              f"{diff / scale:.3e})")
        times = {"other": [], "this": []}
        for _ in range(TURNS):
            for tag in ("other", "this", "this", "other"):
                times[tag].append(ms(calls[tag]))
        for tag, ts in times.items():
            print(f"{label} [{tag}]: ms {', '.join(f'{t:.4f}' for t in ts)}; median {np.median(ts):.4f}")
        if exact and not same:
            raise SystemExit(f"{label}: the variant's bits differ from the checkout's")
        if argv[0] == "--variant" and argv[1] == "phases":
            lib = REPO / "build" / "kernel_ab" / f"other-{other.name}" / f"lib{src}.so"
            frames = outs["other"][0].shape[0]
            phase_report(lib, calls["other"], frames, f"{label} F={frames}")
            if frames == 1:
                values, _ = make()
                values["mag"] = 0
                phase_report(lib, bind(*builds["other"], values), 1, f"{label} F=1 without |X|")

if __name__ == "__main__":
    main(sys.argv[1:])
