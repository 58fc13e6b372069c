"""Call size of the port's IIR products against dispatch shape, on one GPU.

    python3 scripts/torch_iir_call_shape.py [pairs ...]   (default 128 256 512)

``tpu_sdr_torch.kernels.biquad`` runs every product over the (channel,
frame) axes in calls of ``CANONICAL_FRAMES`` pairs, so that chunked ==
one-shot holds bitwise. For each call size given, and for one call per
product, this drives CUSTOM dispatches (butter(12, 0.25)) at 1 x 1, 1 x 4,
2 x 8 and 8 x 64 (channels x frames) and prints the host-clock dispatch
time, the device kernels and busy time per dispatch (torch.profiler), and
whether 4 chunks give the one-shot bits. Two rounds, to show the spread.
"""

import sys
from pathlib import Path

import scipy.signal as sps
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline  # noqa: E402
from tpu_sdr_torch.kernels import biquad  # noqa: E402

N = 16384
SHAPES = ((1, 1), (1, 4), (2, 8), (8, 64))


def chunked_is_oneshot(pipe, x) -> bool:
    one, st_one = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    st, parts = pipe.initial_state(), []
    for chunk in x.chunk(4, dim=-1):
        out, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        parts.append(out["magnitude"])
    return torch.equal(torch.cat(parts, dim=1), one["magnitude"]) and torch.equal(
        st.sos_state, st_one.sos_state
    )


def main(sizes):
    cs.phase_device()
    fixed, default_size = biquad._canonical_matmul, biquad.CANONICAL_FRAMES
    policies = [("one call", lambda a, bt, rows: a @ bt, default_size)]
    policies += [(f"{n} pairs", fixed, n) for n in sizes]
    sos = sps.butter(12, 0.25, output="sos")
    gen = torch.Generator(device="cuda").manual_seed(3)
    pipes, xs = {}, {}
    for c, f in SHAPES:
        if c not in pipes:
            pipes[c] = SpectrumPipeline(PipelineConfig(channels=c))
            pipes[c].upload_sos(sos)
        xs[c, f] = torch.randn((c, f * N), device="cuda", generator=gen)
    try:
        for rnd in range(2):
            for label, matmul, size in policies:
                biquad._canonical_matmul, biquad.CANONICAL_FRAMES = matmul, size
                for c, f in SHAPES:
                    pipe = pipes[c]
                    step = cs.chained(lambda a, s, p=pipe: p.process(a, s, FilterMode.CUSTOM),
                                      xs[c, f], pipe.initial_state)
                    med, lo, hi = cs.dispatch_wall(step)
                    prof = cs.device_kernels(step)
                    busy = ("device not measured" if prof is None
                            else f"{prof[0]:.0f} kernels, busy {prof[1]:.4f} ms")
                    bitwise = chunked_is_oneshot(pipes[c], xs[c, f]) if f >= 4 else "-"
                    print(f"round {rnd} {label:9s} {c} ch x {f:2d} frames: median "
                          f"{med * 1e3:.4f} ms ({lo * 1e3:.4f}-{hi * 1e3:.4f}); {busy}; "
                          f"4 chunks bitwise: {bitwise}", flush=True)
    finally:
        biquad._canonical_matmul, biquad.CANONICAL_FRAMES = fixed, default_size


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [128, 256, 512])
