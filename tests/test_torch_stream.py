"""PyTorch port's SpectrumPipeline vs tpu_sdr's, the golden model, and its
own streaming contracts (on the CPU, where the spectrum kernel's plain
version runs).

Every comparison feeds the same NumPy input, made from a seed, to both
packages. SNR = 10*log10(sum(ref^2) / sum((ref - port)^2)) over all bins.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.control import golden
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr.runtime.state import StreamState as JStreamState
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline, StreamState
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels.cuda import iir_fft
from tpu_sdr_torch.runtime import stream

torch.set_num_threads(1)

N = 16384
SOS = sps.butter(12, 0.25, output="sos")
TIERS = {
    "f32": dict(dtype="f32"),
    "f32max": dict(dtype="f32max"),
    "bf16": dict(dtype="bf16"),
    "bf16-io": dict(dtype="bf16", bf16_io=True),
}
MODES = ["BYPASS", "FIXED", "CUSTOM"]
# Port vs JAX magnitude SNR floors: the reference's f32 tier runs its
# "high3" bf16-split products (~98 dB class), f32max is exact fp32 on both
# sides, bf16 results keep ~50 dB.
PARITY_FLOOR_DB = {"f32": 90.0, "f32max": 120.0, "bf16": 45.0, "bf16-io": 45.0}
# Tier contracts vs the float64 golden (docs/ARCHITECTURE.md).
CONTRACT_DB = {"f32": 98.0, "f32max": 139.0, "bf16": 50.0, "bf16-io": 50.0}


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def _db(x):
    return 20.0 * np.log10(np.maximum(np.asarray(x, np.float64), 1e-12))


def _mag(out) -> np.ndarray:
    return out["magnitude"].float().numpy()


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) per (tier, channels), built once."""
    cache = {}

    def get(tier, channels):
        if (tier, channels) not in cache:
            jp = JSpectrumPipeline(JPipelineConfig(channels=channels, **TIERS[tier]))
            p = SpectrumPipeline(
                PipelineConfig(channels=channels, **TIERS[tier]), device="cpu"
            )
            jp.upload_sos(SOS)
            p.upload_sos(SOS)
            cache[tier, channels] = jp, p
        return cache[tier, channels]

    return get


@pytest.fixture(scope="module")
def port():
    p = SpectrumPipeline(PipelineConfig(), device="cpu")
    p.upload_sos(SOS)
    return p


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", list(TIERS))
def test_pipeline_matches_jax(pipes, tier, mode):
    jp, p = pipes(tier, 2)
    x = np.random.default_rng(0).standard_normal((2, 4 * N)).astype(np.float32)
    jout, jst = jp.process(x, jp.initial_state(), JFilterMode[mode])
    out, st = p.process(x, p.initial_state(), FilterMode[mode])
    ref = np.asarray(jout["magnitude"])
    got = out["magnitude"]
    assert got.dtype == getattr(torch, ref.dtype.name)
    assert tuple(got.shape) == ref.shape == (2, 4, N)
    snr = snr_db(ref.astype(np.float32), got.float().numpy())
    assert snr >= PARITY_FLOOR_DB[tier], snr
    np.testing.assert_allclose(
        st.sos_state.numpy(), np.asarray(jst.sos_state), rtol=1e-4, atol=1e-6
    )
    assert int(st.frame_count) == int(jst.frame_count) == 4
    assert int(st.window_phase) == int(jst.window_phase) == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_snr_vs_golden(pipes, tier, mode):
    """Each tier meets its contract vs the float64 golden, or the
    reference's own SNR on the same input where that is lower."""
    jp, p = pipes(tier, 1)
    x = golden.synth_tone(100_000.0, 2 * N, 1e6, noise=0.01).astype(np.float32)
    sos = {"BYPASS": None, "FIXED": golden.fixed_filter_sos(), "CUSTOM": SOS}[mode]
    ref = golden.golden_pipeline(x.astype(np.float64), sos=sos)["magnitude"]
    got = _mag(p.process(x, p.initial_state(), FilterMode[mode])[0])[0]
    jgot = np.asarray(
        jp.process(x, jp.initial_state(), JFilterMode[mode])[0]["magnitude"],
        np.float32,
    )[0]
    floor = min(CONTRACT_DB[tier], snr_db(ref, jgot)) - 0.5
    assert snr_db(ref, got) >= floor


@pytest.mark.parametrize(
    "case",
    ["tone-bypass", "custom", "fixed", "rtl-window"],
)
def test_within_1db_of_golden(port, case):
    x = golden.synth_tone(100_000.0, N, 1e6, noise=0.01, seed=9)
    p, mode, kw = port, FilterMode.BYPASS, dict(sos=None, window="hann")
    if case == "custom":
        mode, kw = FilterMode.CUSTOM, dict(sos=SOS, window="hann")
    elif case == "fixed":
        mode, kw = FilterMode.FIXED, dict(sos=golden.fixed_filter_sos(), window="hann")
    elif case == "rtl-window":
        p = SpectrumPipeline(PipelineConfig(rtl_faithful_window=True), device="cpu")
        kw = dict(sos=None, window="rtl")
    ref = golden.golden_pipeline(x, **kw)["magnitude"][0]
    out, st = p.process(x.astype(np.float32), p.initial_state(), mode)
    mag = _mag(out)[0, 0]
    mask = ref > ref.max() * 1e-3
    assert np.abs(_db(mag[mask]) - _db(ref[mask])).max() < 1.0
    assert int(st.frame_count) == 1


@pytest.mark.parametrize(
    "tier,channels,frames,chunks,mode",
    [
        ("f32", 1, 8, 4, "CUSTOM"),
        ("f32", 1, 4, 4, "CUSTOM"),
        ("f32", 2, 8, 2, "CUSTOM"),
        ("f32", 2, 4, 2, "FIXED"),
        ("f32", 2, 4, 4, "BYPASS"),
        ("f32max", 2, 4, 2, "CUSTOM"),
        ("bf16", 2, 4, 2, "CUSTOM"),
        ("bf16-io", 2, 4, 4, "CUSTOM"),
    ],
    ids=["f32", "f32-1frame", "f32-2ch", "f32-fixed", "f32-bypass",
         "f32max", "bf16", "bf16-io-1frame"],
)
def test_chunked_equals_oneshot_bitwise(pipes, tier, channels, frames, chunks, mode):
    _, p = pipes(tier, channels)
    x = np.random.default_rng(5).standard_normal((channels, frames * N)).astype(np.float32)
    whole, st_whole = p.process(x, p.initial_state(), FilterMode[mode])
    st = p.initial_state()
    mags = []
    for chunk in np.split(x, chunks, axis=-1):
        out, st = p.process(chunk, st, FilterMode[mode])
        mags.append(out["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)
    assert int(st.frame_count) == frames and int(st.window_phase) == 0


def test_plain_path_chunked_equals_oneshot_bitwise():
    p = SpectrumPipeline(PipelineConfig(use_pallas=False, channels=2), device="cpu")
    p.upload_sos(SOS)
    x = np.random.default_rng(6).standard_normal((2, 4 * N)).astype(np.float32)
    whole, _ = p.process(x, p.initial_state(), FilterMode.CUSTOM)
    st = p.initial_state()
    parts = []
    for chunk in np.split(x, 4, axis=-1):
        out, st = p.process(chunk, st, FilterMode.CUSTOM)
        parts.append(out["magnitude"])
    assert torch.equal(torch.cat(parts, dim=1), whole["magnitude"])


def test_plain_path_matches_kernel_path(port):
    """use_pallas=False (fft_4step + decode) and the kernel's plain
    version compute the same spectrum."""
    p = SpectrumPipeline(PipelineConfig(use_pallas=False), device="cpu")
    p.upload_sos(SOS)
    x = np.random.default_rng(7).standard_normal(2 * N).astype(np.float32)
    a = _mag(port.process(x, port.initial_state(), FilterMode.CUSTOM)[0])
    b = _mag(p.process(x, p.initial_state(), FilterMode.CUSTOM)[0])
    assert snr_db(b, a) > 120.0


def test_fixed_mode_matches_golden_fixed_sos(port):
    x = golden.synth_tone(50_000.0, N, 1e6, noise=0.05, seed=9)
    ref = golden.golden_pipeline(x, sos=golden.fixed_filter_sos())["magnitude"][0]
    mag = _mag(port.process(x.astype(np.float32), port.initial_state(), FilterMode.FIXED)[0])[0, 0]
    mask = ref > ref.max() * 1e-3
    assert np.abs(_db(mag[mask]) - _db(ref[mask])).max() < 1.0


def test_multichannel_independent():
    p3 = SpectrumPipeline(PipelineConfig(channels=3), device="cpu")
    p1 = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    x = np.random.default_rng(11).standard_normal((3, N)).astype(np.float32)
    mags = _mag(p3.process(x, p3.initial_state(), FilterMode.FIXED)[0])
    for c in range(3):
        m1 = _mag(p1.process(x[c : c + 1], p1.initial_state(), FilterMode.FIXED)[0])[0]
        assert np.abs(m1 - mags[c]).max() / (mags[c].max() + 1e-30) < 1e-5


def test_counters_carry_across_calls(port):
    x = np.random.default_rng(12).standard_normal(3 * N).astype(np.float32)
    st = port.initial_state()
    for k, chunk in enumerate(np.split(x, 3), start=1):
        _, st = port.process(chunk, st, FilterMode.CUSTOM)
        assert int(st.frame_count) == k and int(st.window_phase) == 0
    assert st.frame_count.dtype == st.window_phase.dtype == torch.int32


def test_plain_path_outputs_all(port):
    x = np.random.default_rng(33).standard_normal(N).astype(np.float32)
    out, _ = port.process(x, port.initial_state(), FilterMode.BYPASS, outputs="all")
    assert set(out) == {"magnitude", "re", "im", "phase", "power"}
    ref = np.fft.fft(x.astype(np.float64) * golden.hann_true(N))
    spec = out["re"].double().numpy()[0, 0] + 1j * out["im"].double().numpy()[0, 0]
    assert np.abs(spec - ref).max() / np.abs(ref).max() < 1e-5
    mask = np.abs(ref) > np.abs(ref).max() * 1e-3
    dphi = np.angle(np.exp(1j * (out["phase"].numpy()[0, 0][mask] - np.angle(ref)[mask])))
    assert np.abs(dphi).max() < 1e-2
    np.testing.assert_allclose(out["power"].numpy()[0, 0], np.abs(ref) ** 2, rtol=1e-4, atol=1e-3)


def test_bf16_io_plain_path_dtype_contract(pipes):
    _, p = pipes("bf16-io", 1)
    x = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    out, _ = p.process(x, p.initial_state(), FilterMode.BYPASS, outputs="all")
    assert out["magnitude"].dtype == torch.bfloat16
    assert out["re"].dtype == torch.float32
    kernel, _ = p.process(x, p.initial_state(), FilterMode.BYPASS)
    assert kernel["magnitude"].dtype == torch.bfloat16


def _leaves(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("mode", MODES)
def test_jax_bank_through_convert_gives_same_bits(mode):
    """A JAX-built bank, window and plan carried over by convert.py give the
    same output, bit for bit, as the port's own constants."""
    jp = JSpectrumPipeline(JPipelineConfig())
    jp.upload_sos(SOS)
    own = SpectrumPipeline(PipelineConfig(), device="cpu")
    own.upload_sos(SOS)
    carried = SpectrumPipeline(PipelineConfig(), device="cpu")
    carried.hann_w = convert.window(np.asarray(jp.hann_w), device="cpu")
    carried.plan = convert.fft_plan(
        {k: np.asarray(v) for k, v in jp.plan.items()}, device="cpu"
    )
    for name in ("bank_fixed", "bank_custom"):
        jbank = getattr(jp, name)
        setattr(carried, name, convert.bank(
            {"op": _leaves(jbank["op"]), "pp": _leaves(jbank["pp"])}, device="cpu"
        ))
    x = np.random.default_rng(8).standard_normal(2 * N).astype(np.float32)
    a, sa = own.process(x, own.initial_state(), FilterMode[mode])
    b, sb = carried.process(x, carried.initial_state(), FilterMode[mode])
    assert torch.equal(a["magnitude"], b["magnitude"])
    assert torch.equal(sa.sos_state, sb.sos_state)


def test_state_checkpoint_matches_jax_layout(port):
    jp = JSpectrumPipeline(JPipelineConfig())
    x = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    _, jst = jp.process(x, jp.initial_state(), JFilterMode.FIXED)
    _, st = port.process(x, port.initial_state(), FilterMode.FIXED)
    jd, d = jst.to_numpy(), st.to_numpy()
    assert set(d) == set(jd)
    for k in jd:
        if jd[k] is None:
            assert d[k] is None
            continue
        assert d[k].shape == jd[k].shape and d[k].dtype == jd[k].dtype, k
    # a JAX checkpoint resumes in the port, and the port's in JAX
    resumed = convert.state(jd, device="cpu")
    out, st2 = port.process(x, resumed, FilterMode.FIXED)
    assert int(st2.frame_count) == 2 and np.isfinite(_mag(out)).all()
    back = JStreamState.from_numpy(st2.to_numpy())
    _, jst2 = jp.process(x, back, JFilterMode.FIXED)
    assert int(jst2.frame_count) == 3
    assert StreamState.from_numpy(d, device="cpu").to_numpy()["frame_count"] == 1


def test_import_pulls_in_neither_jax_nor_tpu_sdr():
    code = (
        "import sys, tpu_sdr_torch, tpu_sdr_torch.convert, "
        "tpu_sdr_torch.kernels.cuda.loader, tpu_sdr_torch.kernels.cuda.iir_fft, "
        "tpu_sdr_torch.kernels.cuda.launch, tpu_sdr_torch.kernels.cuda.affine_scan, "
        "tpu_sdr_torch.kernels.cuda.pfb_kernel, tpu_sdr_torch.kernels.ddc, "
        "tpu_sdr_torch.kernels.demod, tpu_sdr_torch.kernels.resample, "
        "tpu_sdr_torch.kernels.stereo, tpu_sdr_torch.kernels.pfb, "
        "tpu_sdr_torch.runtime.stream, tpu_sdr_torch.runtime.receiver, "
        "tpu_sdr_torch.control, tpu_sdr_torch.control.api, "
        "tpu_sdr_torch.kernels.cuda.spectrum, tpu_sdr_torch.core.qformat, "
        "tpu_sdr_torch.kernels.fft_q15, tpu_sdr_torch.kernels.native_q15, "
        "tpu_sdr_torch.runtime.q15, tpu_sdr_torch.runtime.feeder, "
        "tpu_sdr_torch.runtime.waterfall, tpu_sdr_torch.runtime.psd, "
        "tpu_sdr_torch.runtime.source, tpu_sdr_torch.runtime.measure, "
        "tpu_sdr_torch.runtime.recorder, tpu_sdr_torch.kernels.digital, "
        "tpu_sdr_torch.kernels.fec, tpu_sdr_torch.kernels.cuda.viterbi, "
        "tpu_sdr_torch.kernels.fastconv, tpu_sdr_torch.kernels.rds, "
        "tpu_sdr_torch.kernels.iqcorr, tpu_sdr_torch.runtime.scanner, "
        "tpu_sdr_torch.transport, tpu_sdr_torch.transport.native, "
        "tpu_sdr_torch.transport.udp_stream, tpu_sdr_torch.transport.uart_stream, "
        "tpu_sdr_torch.transport.serial_port, tpu_sdr_torch.transport.ipstack, "
        "tpu_sdr_torch.transport.crc32, tpu_sdr_torch.transport.framing, "
        "tpu_sdr_torch.gui, tpu_sdr_torch.gui.server, tpu_sdr_torch.bench.roofline, "
        "tpu_sdr_torch.bench.trace, tpu_sdr_torch.__main__, tpu_sdr_torch.shard, "
        "tpu_sdr_torch.shard.distributed, tpu_sdr_torch.shard.halo, tpu_sdr_torch.core.comm, tpu_sdr_torch.core.halo\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpu_sdr' or m.startswith('tpu_sdr.')]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpectrumPipeline()


def test_cpu_run_never_launches_the_kernel(port):
    iir_fft.reset_counts()
    x = np.random.default_rng(10).standard_normal(N).astype(np.float32)
    for mode in FilterMode:
        port.process(x, port.initial_state(), mode)
    assert not any(iir_fft.counts["kernel"].values())
    assert iir_fft.counts["plain"] == {
        "spectrum_bypass": 3, "spectrum_iir": 0, "iir_summaries": 0, "spectrum_complex": 0,
        "fm_demod": 0, "pfb_fold_dft": 0, "spectrum_half": 0, "fft_mag_fused": 0,
        "q15_fft": 0, "sosfilt_q15": 0, "viterbi": 0,
    }


@pytest.mark.parametrize(
    "case",
    ["hop", "bank", "time-axis"],
)
def test_unported_paths_raise(port, case):
    """Paths that once raised, ported now, run: hop < N, per-channel banks,
    and ``time_axis`` (here the time axis of a 1 x 1 mesh outside
    torch.distributed, which exchanges nothing: the same bits as no axis;
    tests/test_torch_shard_*.py run it on 2 and 4 ranks)."""
    x = np.zeros(N, np.float32)
    if case == "hop":
        p = SpectrumPipeline(PipelineConfig(hop=8192), device="cpu")
        out, st = p.process(x, p.initial_state(), FilterMode.BYPASS)
        assert out["magnitude"].shape == (1, 2, N) and int(st.frame_count) == 2
        assert st.history.shape == (1, 8192)
    elif case == "bank":
        p = SpectrumPipeline(PipelineConfig(), device="cpu")
        p.upload_sos_bank(SOS[None])
        assert p.bank_custom["op"].T.shape == (1, 128, 128)
        assert p.bank_custom["pp"] is p.bank_fixed["pp"]
    else:
        from tpu_sdr_torch.shard import make_sdr_mesh

        axis = make_sdr_mesh(devices="cpu").time
        xs = torch.as_tensor(np.random.default_rng(3).standard_normal((1, 2 * N)), dtype=torch.float32)
        for mode_index in (0, 2):
            outs = [
                stream.process_stream(
                    xs, port.initial_state(), port.bank_fixed, port.bank_custom,
                    port.hann_w, port.plan, mode_index=mode_index, cfg=port.cfg, time_axis=ta,
                )
                for ta in (axis, None)
            ]
            assert torch.equal(outs[0][0]["magnitude"], outs[1][0]["magnitude"])
            assert torch.equal(outs[0][1].sos_state, outs[1][1].sos_state)
            assert int(outs[0][1].frame_count) == 2


def test_fused_two_pass_ignored_by_bf16_tier():
    p = SpectrumPipeline(PipelineConfig(dtype="bf16", fused_two_pass=True), device="cpu")
    out, _ = p.process(np.ones(N, np.float32), p.initial_state(), FilterMode.CUSTOM)
    assert out["magnitude"].shape == (1, 1, N)


def test_refuses_reduced_matmul_precision(port):
    x = np.zeros(N, np.float32)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="IEEE fp32"):
            port.process(x, port.initial_state())
    finally:
        torch.set_float32_matmul_precision("highest")
    port.process(x, port.initial_state())


def test_rejects_bad_uploads_and_lengths(port):
    with pytest.raises(ValueError, match="unstable"):
        port.upload_sos(np.array([[1.0, 0, 0, 1.0, -2.5, 1.5]]))
    with pytest.raises(ValueError, match="multiple of"):
        port.process(np.zeros(N + 1, np.float32), port.initial_state())
