"""The forcing step of the composite IIR on the card (``csrc/iir_force.cu``):
its plain PyTorch version on the CPU, its routes, and the kernel on a card.

Where the state and emit kernels run (``biquad.takes_emit_kernel``), one pass
over the chunk forms every block's windowed input xw = x w (each product
rounded alone, as ``torch.mul`` rounds it) and its forcing f = xw P^T
(``block_forcing``): lane l's four products k = 4l .. 4l + 3 added to 0 in
ascending k, then the 32 partial sums pairwise with strides 16, 8, 4, 2 and
1. Here the plain version (``block_forcing_plain``), which sums in the
kernel's order, is held against float64, the GEMM form it replaces and a
block summed by hand; xw against ``x * hann_w`` bit for bit; chunked against
one-shot; a lead axis's layout; the graphs' prepared launch; every dispatch
that takes the pass, dressed as the card as
``tests/test_torch_dispatch_graph.py`` dresses it; and the wrapper against
what the kernel does not take. The cases marked ``cuda``
hold the kernel to the plain version on a card and skip without one:

    python -m pytest tests/test_torch_iir_force.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.kernels import biquad, window
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.runtime import dispatch_graphs, stream
from tpu_sdr_torch.shard.latency import LatencyPipeline
from tpu_sdr_torch.shard.mesh import MeshAxis, make_sdr_mesh
from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline

torch.set_num_threads(1)

FS = 1e6
N = 16384
L = 128  # samples a block
B = 128  # blocks a frame
M = 12


def _wn(hz):
    return np.asarray(hz) / (FS / 2)


DESIGNS = {
    # The corners of bank64's draws (as in tests/test_torch_iir_emit.py).
    "bank64_mix": [
        sps.butter(12, _wn(20e3), output="sos"),
        sps.butter(12, _wn(450e3), output="sos"),
        sps.butter(6, _wn([50e3, 70e3]), btype="bandpass", output="sos"),
        sps.butter(6, _wn([370e3, 470e3]), btype="bandpass", output="sos"),
        sps.butter(12, _wn(20e3), btype="highpass", output="sos"),
        sps.butter(12, _wn(450e3), btype="highpass", output="sos"),
    ],
    "narrow": [sps.butter(12, 0.01, output="sos"), sps.butter(12, 0.002, output="sos")],
    "shared": sps.butter(12, 0.25, output="sos"),
}
# Of each row's largest |f|: the plain version against float64 and against
# the GEMM form (P's product in canonical calls), fp32 sums of the same
# rounded products in other orders. Measured at most 1.7e-7 and 5.5e-7
# (every design, with and without the window, 2 seeds).
REL_VS_FLOAT64 = 2e-6
REL_VS_GEMM = 2e-6
# The kernel against its plain version on the card, of the largest |f|:
# the kernel's FMAs round once where the plain version rounds twice. On an
# H100 it read at most 1.24e-7 (bank64's designs, 64 x 16 frames).
FORCE_KERNEL_REL = 1e-6


def _op(name: str, device="cpu"):
    designs = DESIGNS[name]
    if name == "shared":
        return biquad.precompute_composite(designs, device=device)
    return biquad.precompute_composite_bank(
        np.stack([biquad.pad_sos(s, 6) for s in designs]), device=device)


def _rows(op) -> int:
    return op.T.shape[0] if op.T.ndim == 3 else 3


def _chunk(op, frames: int, seed: int, device="cpu") -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((_rows(op), frames * N)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def _hann(device="cpu") -> torch.Tensor:
    return window.hann_coefficients(N, device=device)


def _per_row(got, ref) -> np.ndarray:
    rows = got.shape[0]
    gap = (got.double() - ref.double()).abs().reshape(rows, -1).amax(-1)
    return (gap / ref.double().abs().reshape(rows, -1).amax(-1)).cpu().numpy()


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "raw"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DESIGNS))
def test_plain_forcing_matches_float64_and_the_gemm_form(name, seed, windowed):
    op = _op(name)
    x = _chunk(op, 2, seed)
    w = _hann() if windowed else None
    xw, f = biquad.block_forcing_plain(op, x, w)
    assert xw.shape == (_rows(op), 2, B, L) and f.shape == (_rows(op), 2, B, M)
    assert xw.is_contiguous() and f.dtype == torch.float32
    P = op.P if op.P.ndim == 3 else op.P[None].expand(_rows(op), M, L)
    exact = torch.einsum("rfbk,rjk->rfbj", xw.double(), P.double())
    gemm = biquad._canonical_matmul(xw, op.P.mT, biquad.cascade_frames(op) * B)
    err64, err = _per_row(f, exact), _per_row(f, gemm)
    assert err64.max() <= REL_VS_FLOAT64 and err.max() <= REL_VS_GEMM, (name, err64, err)


def test_plain_forcing_sums_in_the_kernels_order():
    """One block by hand: each lane's four products added to 0 in ascending
    k, each product rounded; then the 32 lanes' sums pairwise, l with l + 16,
    then + 8, + 4, + 2, + 1."""
    op = _op("bank64_mix")
    x, w = _chunk(op, 1, 4), _hann()
    xw, f = biquad.block_forcing_plain(op, x, w)
    c, blk = 3, 77
    v, P = xw[c, 0, blk], op.P[c]
    for j in (0, 5, 11):
        lanes = []
        for lane in range(32):
            acc = torch.zeros((), dtype=torch.float32)
            for k in range(4 * lane, 4 * lane + 4):
                acc = acc + P[j, k] * v[k]
            lanes.append(acc)
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [lanes[i] + lanes[i + h] for i in range(h)]
        assert torch.equal(lanes[0], f[c, 0, blk, j]), j


@pytest.mark.parametrize("name", ["bank64_mix", "shared"])
def test_xw_is_the_window_multiply_bitwise(name):
    """The window's product is rounded on its own: xw is ``x * hann_w`` a
    frame at a time, bit for bit, in the steps' layout."""
    op = _op(name)
    x, w = _chunk(op, 3, 5), _hann()
    xw, _ = biquad.block_forcing_plain(op, x, w)
    want = (x.reshape(_rows(op), 3, N) * w).reshape(_rows(op), 3, B, L)
    assert torch.equal(xw, want)


@pytest.mark.parametrize("sizes", [(4,), (1, 3), (2, 1, 1), (3, 1)], ids=str)
def test_plain_forcing_chunked_equals_one_shot(sizes):
    """Each block's xw and f depend on that block's input, its place in the
    frame and its row's P alone: any split of the frames gives the one-shot
    bits."""
    op = _op("bank64_mix")
    x, w = _chunk(op, 4, 6), _hann()
    xw, f = biquad.block_forcing_plain(op, x, w)
    parts = [biquad.block_forcing_plain(op, xc, w) for xc in x.split([s * N for s in sizes], -1)]
    assert torch.equal(torch.cat([p[0] for p in parts], dim=1), xw)
    assert torch.equal(torch.cat([p[1] for p in parts], dim=1), f)


def test_a_lead_axis_goes_behind_the_channels():
    """IQ planes (2, C, T) through a bank: the steps' layout (C, 2, F, B, L),
    each plane's rows the bits of that plane alone."""
    op = _op("bank64_mix")
    xs = torch.stack([_chunk(op, 1, 7), _chunk(op, 1, 8)])
    xw, f = biquad.block_forcing_plain(op, xs, _hann())
    assert xw.shape == (6, 2, 1, B, L) and f.shape == (6, 2, 1, B, M)
    for plane in range(2):
        want_xw, want_f = biquad.block_forcing_plain(op, xs[plane], _hann())
        assert torch.equal(xw[:, plane], want_xw) and torch.equal(f[:, plane], want_f)


@pytest.mark.parametrize("name", ["shared", "bank64_mix"])
def test_a_prepared_launch_takes_chunks_of_its_shape(name):
    """``ForcingLaunch`` (the graphs' replays) writes each chunk's pass into
    its ``out`` (the graphs' static buffers), for a shared design and a
    bank, and refuses a chunk of another shape or dtype."""
    op = _op(name)
    x, w = _chunk(op, 1, 13), _hann()
    rows = _rows(op)
    out = (torch.empty(rows, 1, B, L), torch.empty(rows, 1, B, M))
    force = biquad.ForcingLaunch(op, x, w, out)
    for seed in (14, 15):
        xc = _chunk(op, 1, seed)
        force(xc)
        want = biquad.block_forcing_plain(op, xc, w)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    for bad in (_chunk(op, 2, 16), x.double()):
        with pytest.raises(ValueError):
            force(bad)


# ------------------------------------------------------ the routes, dressed


@pytest.fixture
def card(monkeypatch):
    """The CPU as the card (as in tests/test_torch_dispatch_graph.py): the
    kernels' routes on, graphs that run their steps again on replay. Yields
    the forcing pass's calls, each (x, window), and the P products' count."""
    class Standin:
        def __init__(self, step):
            self.step = step

        def replay(self):
            with launch.captured():
                self.step()

    def capture(steps, device):
        for step in steps:
            step()
        return [Standin(step) for step in steps]

    seen = {"calls": [], "p_gemms": 0}
    forcing, matmul = biquad.block_forcing, biquad._canonical_matmul

    def block_forcing(op, x, window=None):
        seen["calls"].append((x, window))
        return forcing(op, x, window)

    def canonical_matmul(a, bt, rows):
        seen["p_gemms"] += tuple(bt.shape[-2:]) == (L, M)
        return matmul(a, bt, rows)

    monkeypatch.setattr(biquad, "takes_state_kernel", lambda op: True)
    monkeypatch.setattr(biquad, "block_forcing", block_forcing)
    monkeypatch.setattr(biquad, "_canonical_matmul", canonical_matmul)
    monkeypatch.setattr(dispatch_graphs, "_stream_id", lambda device: 7)
    monkeypatch.setattr(dispatch_graphs, "_capture", capture)
    launch.reset_counts()
    yield seen
    launch.reset_counts()


BANK = [sps.butter(12, 0.1 * (c + 1), output="sos") for c in range(2)]


def _pipe(**cfg) -> SpectrumPipeline:
    pipe = SpectrumPipeline(PipelineConfig(channels=2, **cfg), device="cpu")
    pipe.upload_sos_bank(BANK)
    return pipe


def _dispatches(route: str, x: torch.Tensor) -> tuple[int, bool]:
    """Run ``route``'s filtered dispatches of chunk x (2, 2 N); returns (how
    many, whether the caller's window reaches the pass)."""
    if route in ("eager", "graphs"):
        pipe = _pipe()
        if route == "eager":
            stream.process_stream(x, pipe.initial_state(), pipe.bank_fixed, pipe.bank_custom,
                                  pipe.hann_w, pipe.plan, mode_index=2, cfg=pipe.cfg)
            return 1, True
        st = pipe.initial_state()
        for _ in range(4):  # eager, capture, replay, replay
            _, st = pipe.process(x, st, FilterMode.CUSTOM)
        return 4, True
    if route == "power":
        pipe = _pipe()
        pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM, outputs="power")
        return 1, True
    if route == "iq":
        pipe = _pipe()
        pipe.process_planes(torch.stack([x, x.flip(0)]), pipe.initial_state((2,)),
                            FilterMode.CUSTOM)
        return 1, True
    if route == "hop":
        pipe = _pipe(hop=N // 2)
        pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
        return 1, False
    if route == "time_axis":
        pipe = _pipe()
        stream.process_stream(x, pipe.initial_state(), pipe.bank_fixed, pipe.bank_custom,
                              pipe.hann_w, pipe.plan, mode_index=2, cfg=pipe.cfg,
                              time_axis=MeshAxis("time", 1, 0, (0,)))
        return 1, True
    if route == "sharded":
        pipe = ShardedSpectrumPipeline(PipelineConfig(channels=2), make_sdr_mesh(devices="cpu"))
        pipe.upload_sos_bank(BANK)
        pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
        return 1, True
    lat = LatencyPipeline(PipelineConfig(channels=1), make_sdr_mesh(channel=1, devices="cpu"))
    lat.upload_sos(BANK[0])
    lat.process_frame(x[0, :N], lat.initial_state(), FilterMode.CUSTOM)
    return 1, False


ROUTES = ["eager", "graphs", "power", "iq", "hop", "time_axis", "sharded", "latency"]


@pytest.mark.parametrize("route", ROUTES)
def test_each_filtered_dispatch_makes_one_forcing_pass_and_no_p_product(card, route):
    """Every caller of ``cascade_products`` on the kernels' route: one pass a
    dispatch (a replayed one too), no P product, and no window multiply
    before it: the pass reads the caller's own chunk (the hybrid and IQ
    dispatches, with the window) or the raw stream (the hop dispatch) or the
    frame as the latency engine windows it; the plain path's outputs too."""
    x = _chunk(_op("narrow"), 2, 10)
    dispatches, windowed = _dispatches(route, x)
    counts = launch.counts
    assert counts["plain"]["iir_force"] == dispatches and counts["kernel"]["iir_force"] == 0
    assert counts["plain"]["iir_emit"] == dispatches
    assert card["p_gemms"] == 0
    assert len(card["calls"]) == dispatches
    for got, w in card["calls"]:
        assert (w is not None) == windowed
        if route in ("eager", "graphs", "power", "time_axis", "sharded", "hop"):
            assert torch.equal(got, x)
        if route == "iq":
            assert torch.equal(got, torch.stack([x, x.flip(0)]))


def test_the_cpu_keeps_the_gemm_form(monkeypatch):
    """Undressed, the CPU's filtered dispatch takes the window multiply and
    P's canonical product, and never the pass; its P keeps the host build's
    layout, which only the card's build makes contiguous."""
    calls = []
    matmul = biquad._canonical_matmul
    monkeypatch.setattr(biquad, "_canonical_matmul",
                        lambda a, bt, rows: calls.append(tuple(bt.shape[-2:])) or matmul(a, bt, rows))
    pipe = _pipe()
    launch.reset_counts()
    pipe.process(_chunk(_op("narrow"), 2, 11), pipe.initial_state(), FilterMode.CUSTOM)
    assert launch.counts["plain"]["iir_force"] == 0 and (L, M) in calls
    assert not pipe.bank_custom["op"].P.is_contiguous()


# ---------------------------------------------------------------- the wrapper


def _kernel_op(name: str):
    """``_op(name)`` with P contiguous, as the card's build leaves it."""
    op = _op(name)
    return dataclasses.replace(op, P=op.P.contiguous())


REFUSED = {
    "P transposed, as the CPU's build leaves it": lambda op, x, w: (_op("bank64_mix"), x, w),
    "float64": lambda op, x, w: (op, x.double(), w),
    "T not whole frames": lambda op, x, w: (op, x[..., : N + L], w),
    "window of 8192": lambda op, x, w: (op, x, w[: N // 2]),
    "window float64": lambda op, x, w: (op, x, w.double()),
    "channels not the bank's": lambda op, x, w: (op, x[:4], w),
    "a bank with no channel axis": lambda op, x, w: (op, x[0], w),
    "P of 8 states": lambda op, x, w: (dataclasses.replace(op, P=op.P[:, :8].contiguous()), x, w),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    op = _kernel_op("bank64_mix")
    x, w = _chunk(op, 2, 12), _hann()
    assert biquad._force_check(op, x, w) == (6, M * L, 1, 6)
    with pytest.raises(ValueError):
        biquad._force_check(*REFUSED[case](op, x, w))


def test_the_wrapper_maps_rows_and_sets():
    """Row r of the steps' layout reads x's row (r % set_rows) * chans + r //
    set_rows and the P of set r // set_rows."""
    bank, shared = _kernel_op("bank64_mix"), _kernel_op("shared")
    xs = torch.zeros((2, 6, N))
    assert biquad._force_check(bank, xs, None) == (12, M * L, 2, 6)
    assert biquad._force_check(shared, xs, None) == (12, 0, 12, 1)
    rows, _, set_rows, chans = biquad._force_check(bank, xs, None)
    v = biquad.blocked(bank, torch.arange(12.0)[:, None].expand(12, N).reshape(2, 6, N))
    assert [int(v.reshape(rows, -1)[r, 0]) for r in range(rows)] == \
        [(r % set_rows) * chans + r // set_rows for r in range(rows)]


def test_the_wrapper_reads_evenly_strided_rows_in_place():
    """A chunk cut from a longer stream is read where it lies, its rows'
    stride handed to the kernel; other layouts are copied first."""
    x = torch.zeros((6, 4 * N))
    assert biquad._row_stride(x) == 4 * N
    assert biquad._row_stride(x[:, N : 3 * N]) == 4 * N
    assert biquad._row_stride(torch.zeros((2, 6, 4 * N))[:, :, :N]) == 4 * N
    assert biquad._row_stride(torch.zeros((2, 7, N))[:, :6]) is None  # two strides
    assert biquad._row_stride(x.reshape(6, 4, N)[:, 0].contiguous()[None]) == N
    assert biquad._row_stride(torch.zeros(N + 4)[1 : N + 1]) is None  # off 16 bytes
    assert biquad._row_stride(torch.zeros((N, 6)).mT) is None


# ---------------------------------------------------------------- on a card


@pytest.fixture(scope="module")
def on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.set_float32_matmul_precision("highest")
    return {"bank": _op("bank64_mix", "cuda"), "shared": _op("shared", "cuda")}


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [True, False], ids=["window", "raw"])
@pytest.mark.parametrize("kind,frames_", [("bank", 16), ("shared", 512), ("iq", 4)])
def test_kernel_matches_plain_and_keeps_the_window_bits(on_card, kind, frames_, windowed):
    """One launch; xw bit-equal to the plain version's (``torch.mul``'s
    bits) and f within the FMAs' gap of it; chunked == one-shot bit for
    bit."""
    op = on_card["shared" if kind == "shared" else "bank"]
    assert op.P.is_contiguous() and op.W is None
    gen = torch.Generator(device="cuda").manual_seed(frames_)
    rows = 1 if kind == "shared" else 6
    x = torch.randn((rows, frames_ * N), device="cuda", generator=gen)
    if kind == "iq":
        x = torch.stack([x, torch.randn((rows, frames_ * N), device="cuda", generator=gen)])
    w = _hann("cuda") if windowed else None
    launch.reset_counts()
    xw, f = biquad.block_forcing(op, x, w)
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["iir_force"] == 1 and launch.counts["plain"]["iir_force"] == 0
    pxw, pf = biquad.block_forcing_plain(op, x, w)
    assert torch.equal(xw, pxw)
    assert (xw.data_ptr() == x.data_ptr()) == (kind != "iq" and not windowed)
    gap = ((f - pf).abs().max() / pf.abs().max()).item()
    assert gap <= FORCE_KERNEL_REL, gap
    h = frames_ // 2 + 1
    parts = [biquad.block_forcing(op, xc, w) for xc in x.split([h * N, (frames_ - h) * N], -1)]
    assert torch.equal(torch.cat([p[1] for p in parts], dim=-3), f)
    assert torch.equal(torch.cat([p[0] for p in parts], dim=-3), xw)


@pytest.mark.cuda
def test_kernel_pipeline_chunked_and_time_sharded_equal_one_shot(on_card):
    """The bank's composite filter with the window, as the hybrid dispatch
    runs it: chunks of 3 and 5 frames with the state carried give the
    one-shot output and state bit for bit; and the pass over each half of
    the frames, as a (1, 2) time axis hands them to its ranks, gives the
    one-shot pass's bits (``tests/test_torch_cuda.py`` runs the whole
    time-sharded dispatch on 4 ranks)."""
    op = on_card["bank"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((6, 8 * N), device="cuda", generator=gen)
    zi = torch.randn((6, 6, 2), device="cuda", generator=gen)
    w = _hann("cuda")
    run = biquad.sosfilt_blocked_composite_bank
    launch.reset_counts()
    y, zf = run(op, x, zi, window=w)
    parts, z = [], zi
    for part in x.split([3 * N, 5 * N], dim=-1):
        yp, z = run(op, part, z, window=w)
        parts.append(yp)
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["iir_force"] == 3 and launch.counts["kernel"]["iir_emit"] == 3
    assert torch.equal(torch.cat(parts, dim=-1), y) and torch.equal(z, zf)
    halves = [biquad.block_forcing(op, half, w) for half in x.chunk(2, dim=-1)]
    whole = biquad.block_forcing(op, x, w)
    assert torch.equal(torch.cat([h[1] for h in halves], dim=1), whole[1])
    assert torch.equal(torch.cat([h[0] for h in halves], dim=1), whole[0])


@pytest.mark.cuda
def test_kernel_replayed_dispatch_equals_eager(on_card):
    """A bank's CUSTOM dispatches through the graphs: each makes one forcing
    launch, written into the graphs' static inputs, and no other launch of
    the window or P; every chunk's magnitudes and the carried state equal
    the eager dispatch's bit for bit."""
    pipe = SpectrumPipeline(PipelineConfig(channels=2))
    pipe.upload_sos_bank(BANK)
    gen = torch.Generator(device="cuda").manual_seed(17)
    chunks = torch.randn((2, 5 * 2 * N), device="cuda", generator=gen).chunk(5, dim=-1)
    launch.reset_counts()
    st, outs = pipe.initial_state(), []
    for chunk in chunks:
        out, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        outs.append(out["magnitude"])
    torch.cuda.synchronize()
    assert launch.graph_counts == {"captures": 1, "replays": 3, "eager": 1, "evictions": 0}
    assert launch.counts["kernel"]["iir_force"] == 5
    ref_st = pipe.initial_state()
    for chunk, got in zip(chunks, outs):
        ref, ref_st = stream.process_stream(
            chunk, ref_st, pipe.bank_fixed, pipe.bank_custom, pipe.hann_w, pipe.plan,
            mode_index=2, cfg=pipe.cfg)
        assert torch.equal(got, ref["magnitude"])
    assert torch.equal(st.sos_state, ref_st.sos_state)
