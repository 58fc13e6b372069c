"""One kernel of two source trees on the same inputs: bits and times.

    python3 scripts/torch_kernel_ab.py OTHER_ROOT [fft_mag_fused fm_demod pfb_fold_dft pfb_fold_dft_iq
                                                  iir_summaries]

Builds ``tpu_sdr_torch/csrc/<name>.cu`` of this checkout and of OTHER_ROOT
(another checkout, for example the parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists) with the loader's nvcc
flags, each against its own headers, under ``build/kernel_ab/``. Calls both
libraries' entry points with the same inputs at the main path's shape (row
6: 512 frames of 16384 with the plan's planes; row 7: 8 x 2^20 samples
with de-emphasis; row 8: 8 x 2^20 real samples or (2, 8, 2^20) IQ planes,
taps 8, random planes; row 3: 512 frames with the plan of butter(12, 0.25),
each tree's entry point given the arguments it names: the window and the
chain's constants, or the plan's summary_matrix), reports whether every
output is bit for bit the same as OTHER_ROOT's (and how far apart), then
times them in turns (other, this, this, other; CUDA events around 20
launches queued behind a spin kernel, as ``chip_smoke.py`` times). Needs one
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

from tpu_sdr_torch.kernels.cuda import loader  # noqa: E402

HOLD_CYCLES = 100_000_000
TURNS = 3


def signature(src: Path, name: str) -> list[str]:
    """The parameter list of ``tpu_sdr_<name>`` in src/<name>.cu."""
    text = (src / f"{name}.cu").read_text()
    m = re.search(rf"int tpu_sdr_{name}\((.*?)\)\s*{{", text, re.S)
    return [a.strip() for a in m.group(1).split(",")]


def build(root: Path, name: str, tag: str):
    """(entry point, its parameter declarations) of root's <name>.cu."""
    src = root / "tpu_sdr_torch" / "csrc"
    out = REPO / "build" / "kernel_ab" / tag
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


def main(argv):
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
        diff = max((a - b).abs().max().item() for a, b in zip(outs["other"], outs["this"]))
        scale = max(a.abs().max().item() for a in outs["other"])
        print(f"{label}: bitwise equal={same} (max abs diff {diff:.3e}, of max |other| "
              f"{diff / scale:.3e})")
        times = {"other": [], "this": []}
        for _ in range(TURNS):
            for tag in ("other", "this", "this", "other"):
                times[tag].append(ms(calls[tag]))
        for tag, ts in times.items():
            print(f"{label} [{tag}]: ms {', '.join(f'{t:.4f}' for t in ts)}; median {np.median(ts):.4f}")

if __name__ == "__main__":
    main(sys.argv[1:])
