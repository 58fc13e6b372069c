"""Per-channel bank products: one batched call or one channel at a time, on
one GPU.

    python3 scripts/torch_bank_call_shape.py

``biquad.sosfilt_blocked_composite_bank`` runs each product batched over
the bank's channels, in calls of ``bank_frames(C)`` frames of every
channel, so that chunked == one-shot holds bitwise. The other way runs each
channel's products on their own, through ``_canonical_matmul`` in calls of
the same size. For each way this drives CUSTOM dispatches of a bank
(butter(12, 0.05 (c + 1)) on channel c) at 2 x 8 and 8 x 64 (channels x
frames) and prints the host-clock dispatch time, the device kernels and
busy time per dispatch (torch.profiler), whether 4 chunks give the one-shot
bits, and whether the two ways give the same bits. Two rounds, to show the
spread.
"""

import dataclasses
import sys
from pathlib import Path

import scipy.signal as sps
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline  # noqa: E402
from tpu_sdr_torch.kernels import biquad  # noqa: E402

N = 16384
SHAPES = ((2, 8), (8, 64))


def bank_per_channel(op, x, zi, **_):
    """``sosfilt_blocked_composite_bank`` for x (C, T) with each channel's
    products on their own (the state step still takes all channels at
    once)."""
    C = op.T.shape[0]
    frames = biquad.bank_frames(C)
    ops = [biquad.BlockedSOSComposite(**{f.name: None if getattr(op, f.name) is None
                                         else getattr(op, f.name)[c]
                                         for f in dataclasses.fields(op)}) for c in range(C)]
    terms = [biquad.cascade_products(ops[c], x[c], frames) for c in range(C)]
    f = torch.stack([t[1] for t in terms])  # (C, F, B, m)
    z_in, z = biquad.cascade_chain(op, f, zi, frames)
    y = torch.stack([biquad.cascade_emit(ops[c], y_zs, z_in[c], frames)
                     for c, (y_zs, _) in enumerate(terms)])
    return y, biquad.cascade_state(op, z)


def run(pipe, x):
    return pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)[0]["magnitude"]


def chunked_is_oneshot(pipe, x) -> bool:
    one, st_one = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    st, parts = pipe.initial_state(), []
    for chunk in x.chunk(4, dim=-1):
        out, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        parts.append(out["magnitude"])
    return torch.equal(torch.cat(parts, dim=1), one["magnitude"]) and torch.equal(
        st.sos_state, st_one.sos_state
    )


def main():
    cs.phase_device()
    batched = biquad.sosfilt_blocked_composite_bank
    ways = (("batched", batched), ("per channel", bank_per_channel))
    gen = torch.Generator(device="cuda").manual_seed(3)
    pipes, xs = {}, {}
    for c, f in SHAPES:
        if c not in pipes:
            pipes[c] = SpectrumPipeline(PipelineConfig(channels=c))
            pipes[c].upload_sos_bank([sps.butter(12, 0.05 * (k + 1), output="sos")
                                      for k in range(c)])
        xs[c, f] = torch.randn((c, f * N), device="cuda", generator=gen)
    try:
        for rnd in range(2):
            outs = {}
            for label, fn in ways:
                biquad.sosfilt_blocked_composite_bank = fn
                for c, f in SHAPES:
                    pipe, x = pipes[c], xs[c, f]
                    step = cs.chained(lambda a, s, p=pipe: p.process(a, s, FilterMode.CUSTOM), x,
                                      pipe.initial_state)
                    med, lo, hi = cs.dispatch_wall(step)
                    prof = cs.device_kernels(step)
                    busy = ("device not measured" if prof is None
                            else f"{prof[0]:g} kernels, busy {prof[1]:.4f} ms")
                    outs[label, c] = run(pipe, x)
                    print(f"round {rnd} {label:11s} {c} ch x {f:2d} frames: median "
                          f"{med * 1e3:.4f} ms ({lo * 1e3:.4f}-{hi * 1e3:.4f}); {busy}; "
                          f"4 chunks bitwise: {chunked_is_oneshot(pipe, x)}", flush=True)
            for c, _ in SHAPES:
                a, b = outs["per channel", c], outs["batched", c]
                rel = ((a - b).abs().max() / a.abs().max()).item()
                print(f"round {rnd} {c} ch: batched == per channel bitwise: {torch.equal(a, b)} "
                      f"(max_rel {rel:.2e})", flush=True)
    finally:
        biquad.sosfilt_blocked_composite_bank = batched


if __name__ == "__main__":
    main()
