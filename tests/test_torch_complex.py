"""The port's complex (IQ) input against tpu_sdr's, a NumPy oracle and its
own streaming contracts, on the CPU, where the complex spectrum kernel's
plain version runs.

IQ samples reach the pipeline as complex arrays (``process``) or as stacked
re/im planes (``process_planes``), with a re/im-stacked state from
``initial_state(batch_shape=(2,))``. The JAX complex kernel runs in Pallas
interpret mode. Inputs come from seeded NumPy generators. SNR =
10*log10(sum(ref^2) / sum((ref - port)^2)) over all bins.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr.runtime.state import StreamState as JStreamState
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline, convert
from tpu_sdr_torch.kernels import fft, window
from tpu_sdr_torch.kernels.cuda import iir_fft

torch.set_num_threads(1)

N = 16384
FS = 1e6
SOS = sps.butter(12, 0.25, output="sos")
TIERS = {
    "f32": dict(dtype="f32"),
    "f32max": dict(dtype="f32max"),
    "bf16": dict(dtype="bf16"),
    "bf16-io": dict(dtype="bf16", bf16_io=True),
}
MODES = ["BYPASS", "FIXED", "CUSTOM"]
# Port vs JAX magnitude SNR floors, as for real input
# (tests/test_torch_stream.py): the JAX f32 tier runs "high3" bf16-split
# products, f32max is exact fp32 on both sides, bf16 results keep ~50 dB.
PARITY_FLOOR_DB = {"f32": 90.0, "f32max": 120.0, "bf16": 45.0, "bf16-io": 45.0}
# The complex kernel's plain version vs the JAX kernel at "highest": fp32
# results agree to fp32 rounding; a bf16 store keeps 8 mantissa bits.
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def _iq(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _cstate(p):
    return p.initial_state(batch_shape=(2,))


@pytest.fixture(scope="module")
def plans():
    sos = sps.butter(12, 0.25, output="sos")
    jp = jiir.build_plan(sos, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128))
    pp = iir_fft.build_plan(
        sos, window.hann_coefficients(N, device="cpu"),
        fft.plan_constants(128, 128, device="cpu"),
    )
    return jp, pp


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(11)
    return rng.standard_normal((2, 3, N)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) per (tier, channels), custom bank
    loaded."""
    cache = {}

    def get(tier, channels):
        if (tier, channels) not in cache:
            jp = JSpectrumPipeline(JPipelineConfig(channels=channels, **TIERS[tier]))
            p = SpectrumPipeline(PipelineConfig(channels=channels, **TIERS[tier]), device="cpu")
            jp.upload_sos(SOS)
            p.upload_sos(SOS)
            cache[tier, channels] = jp, p
        return cache[tier, channels]

    return get


@pytest.fixture(scope="module")
def port():
    return SpectrumPipeline(PipelineConfig(), device="cpu")


# ---------------------------------------------------------------- the kernel


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("F", [1, 3])
def test_spectrum_complex_plain_matches_jax(plans, planes, F, apply_window, out_dtype):
    jp, pp = plans
    xr, xi = planes[0][:F], planes[1][:F]
    ref = jiir.spectrum_mag_complex(
        jnp.asarray(xr), jnp.asarray(xi), jp, interpret=True, precision="highest",
        apply_window=apply_window, out_dtype=out_dtype,
    )
    got = iir_fft.spectrum_mag_complex(
        torch.as_tensor(xr), torch.as_tensor(xi), pp, precision="highest",
        apply_window=apply_window, out_dtype=out_dtype,
    )
    assert got.shape == (F, N) and str(got.dtype) == f"torch.{out_dtype}"
    assert snr_db(np.asarray(ref, np.float32), got.float().numpy()) >= SNR_FLOOR_DB[out_dtype]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_spectrum_complex_plain_bf16_input_matches_jax(plans, planes, out_dtype):
    """bf16_io hands the kernel bf16 planes (FIXED/CUSTOM, no window)."""
    jp, pp = plans
    xr, xi = planes[0], planes[1]
    ref = jiir.spectrum_mag_complex(
        jnp.asarray(xr, jnp.bfloat16), jnp.asarray(xi, jnp.bfloat16), jp,
        interpret=True, precision="default", apply_window=False, out_dtype=out_dtype,
    )
    got = iir_fft.spectrum_mag_complex(
        torch.as_tensor(xr).to(torch.bfloat16), torch.as_tensor(xi).to(torch.bfloat16),
        pp, precision="default", apply_window=False, out_dtype=out_dtype,
    )
    assert snr_db(np.asarray(ref, np.float32), got.float().numpy()) >= SNR_FLOOR_DB[out_dtype]


def test_spectrum_complex_matches_numpy(plans, planes):
    _, pp = plans
    xr, xi = planes[0], planes[1]
    got = iir_fft.spectrum_mag_complex(torch.as_tensor(xr), torch.as_tensor(xi), pp)
    w = window.hann_coefficients(N, device="cpu").double().numpy()
    ref = np.abs(np.fft.fft((xr.astype(np.float64) + 1j * xi) * w, axis=-1))
    assert np.abs(got.numpy() - ref).max() / ref.max() < 1e-5


@pytest.mark.parametrize(
    "call,exc,match",
    [
        (lambda xr, xi, pp: iir_fft.spectrum_complex_cuda(xr, xi, pp), ValueError, "CUDA tensor"),
        (lambda xr, xi, pp: iir_fft.spectrum_mag_complex(xr, xi[:, :8192], pp), ValueError, "xi must be"),
        (lambda xr, xi, pp: iir_fft.spectrum_mag_complex(xr, xi, pp, out_dtype="float16"), ValueError, "out_dtype"),
    ],
    ids=["cpu-tensor", "xi-shape", "out_dtype"],
)
def test_spectrum_complex_rejects_bad_calls(plans, planes, call, exc, match):
    _, pp = plans
    with pytest.raises(exc, match=match):
        call(torch.as_tensor(planes[0][:1]), torch.as_tensor(planes[1][:1]), pp)


# ---------------------------------------------------------------- the pipeline


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", list(TIERS))
def test_iq_process_matches_jax(pipes, tier, mode):
    jp, p = pipes(tier, 2)
    x = _iq(np.random.default_rng(0), (2, 2 * N))
    jout, jst = jp.process(x, jp.initial_state(batch_shape=(2,)), JFilterMode[mode])
    iir_fft.reset_counts()
    out, st = p.process(x, _cstate(p), FilterMode[mode])
    assert iir_fft.counts["plain"]["spectrum_complex"] == 1
    ref = np.asarray(jout["magnitude"])
    got = out["magnitude"]
    assert got.dtype == getattr(torch, ref.dtype.name)
    assert tuple(got.shape) == ref.shape == (2, 2, N)
    assert snr_db(ref.astype(np.float32), got.float().numpy()) >= PARITY_FLOOR_DB[tier]
    np.testing.assert_allclose(
        st.sos_state.numpy(), np.asarray(jst.sos_state), rtol=1e-4, atol=1e-6
    )
    assert int(st.frame_count) == int(jst.frame_count) == 2


def test_iq_tone_is_single_sided(port):
    """exp(+i*2*pi*f*t) peaks at +f only (a real tone would mirror at
    N - k)."""
    f = 250_000.0
    x = np.exp(2j * np.pi * f * np.arange(2 * N) / FS).astype(np.complex64)
    out, st = port.process(x, _cstate(port), FilterMode.BYPASS)
    mag = out["magnitude"].numpy()[0, -1]
    k = int(f * N / FS)
    assert np.argmax(mag) == k
    assert mag[N - k] < 1e-3 * mag[k]
    assert int(st.frame_count) == 2


def test_iq_matches_numpy_oracle():
    p = SpectrumPipeline(PipelineConfig(), device="cpu")
    sos = sps.butter(12, 0.3, output="sos")
    p.upload_sos(sos)
    x = _iq(np.random.default_rng(21), N)
    mag = p.process(x, _cstate(p), FilterMode.CUSTOM)[0]["magnitude"].numpy()[0, 0]
    y = sps.sosfilt(sos, x.astype(np.complex128) * np.hanning(N))
    ref = np.abs(np.fft.fft(y))
    mask = ref > ref.max() * 1e-3
    assert np.abs(20 * np.log10(mag[mask] / ref[mask])).max() < 1.0


@pytest.mark.parametrize(
    "mode,channels,chunks", [("CUSTOM", 1, 2), ("CUSTOM", 2, 4), ("BYPASS", 2, 2)],
    ids=["custom-1ch", "custom-2ch-1frame", "bypass"],
)
def test_iq_chunked_equals_oneshot_bitwise(mode, channels, chunks):
    p = SpectrumPipeline(PipelineConfig(channels=channels), device="cpu")
    p.upload_sos(sps.ellip(12, 0.5, 70, 0.25, output="sos"))
    x = _iq(np.random.default_rng(22), (channels, 4 * N))
    whole, st_whole = p.process(x, _cstate(p), FilterMode[mode])
    st = _cstate(p)
    mags = []
    for chunk in np.split(x, chunks, axis=-1):
        out, st = p.process(chunk, st, FilterMode[mode])
        mags.append(out["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)
    assert int(st.frame_count) == 4


def test_iq_outputs_all_and_state_validation(port):
    x = np.zeros(N, np.complex64)
    with pytest.raises(ValueError, match="initial_state"):
        port.process(x, port.initial_state(), FilterMode.BYPASS)
    out, _ = port.process(x, _cstate(port), FilterMode.BYPASS, outputs="all")
    assert set(out) == {"magnitude", "re", "im", "phase", "power"}


def test_iq_outputs_all_match_the_kernel_path(pipes):
    """outputs="all" combines the plain path's spectra of the two planes;
    its magnitude equals the complex kernel's."""
    _, p = pipes("f32", 1)
    x = _iq(np.random.default_rng(23), 2 * N)
    kernel, _ = p.process(x, _cstate(p), FilterMode.CUSTOM)
    every, st = p.process(x, _cstate(p), FilterMode.CUSTOM, outputs="all")
    assert snr_db(every["magnitude"].numpy(), kernel["magnitude"].numpy()) >= 120.0
    spec = every["re"].double().numpy() + 1j * every["im"].double().numpy()
    np.testing.assert_allclose(np.abs(spec), every["magnitude"].numpy(), rtol=1e-5, atol=1e-4)
    assert int(st.frame_count) == 2


def test_iq_complex_tensor_equals_numpy(port):
    x = _iq(np.random.default_rng(24), (1, N))
    a, sa = port.process(x, _cstate(port), FilterMode.FIXED)
    b, sb = port.process(torch.as_tensor(x), _cstate(port), FilterMode.FIXED)
    assert torch.equal(a["magnitude"], b["magnitude"])
    assert torch.equal(sa.sos_state, sb.sos_state)


@pytest.mark.parametrize("mode", MODES)
def test_process_planes_equals_process(pipes, mode):
    _, p = pipes("f32", 2)
    x = _iq(np.random.default_rng(25), (2, 2 * N))
    a, sa = p.process(x, _cstate(p), FilterMode[mode])
    b, sb = p.process_planes(np.stack([x.real, x.imag]), _cstate(p), FilterMode[mode])
    assert torch.equal(a["magnitude"], b["magnitude"])
    assert torch.equal(sa.sos_state, sb.sos_state)


def test_process_planes_takes_2d_planes(port):
    """(2, T) planes keep their axes: (frames, N), the same bits as the
    channel of a (T,) complex input through ``process``."""
    x = _iq(np.random.default_rng(26), N)
    a, _ = port.process(x, _cstate(port), FilterMode.BYPASS)
    b, _ = port.process_planes(np.stack([x.real, x.imag]), _cstate(port), FilterMode.BYPASS)
    assert tuple(b["magnitude"].shape) == (1, N)
    assert torch.equal(a["magnitude"][0], b["magnitude"])


@pytest.mark.parametrize(
    "xs_shape,batch_shape",
    [((2, 2, 1, N), (2, 2)), ((2, N), (2,))],
    ids=["batched-state", "2d-planes"],
)
def test_process_planes_shapes_match_jax(xs_shape, batch_shape):
    """process_planes checks only the state's leading 2-axis and keeps the
    input's own axes, as the reference does: the same output shape and
    magnitudes (channels=1, BYPASS)."""
    jp = JSpectrumPipeline(JPipelineConfig(channels=1))
    p = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    xs = np.random.default_rng(27).standard_normal(xs_shape).astype(np.float32)
    jout, jst = jp.process_planes(
        jnp.asarray(xs), jp.initial_state(batch_shape=batch_shape), JFilterMode.BYPASS
    )
    out, st = p.process_planes(xs, p.initial_state(batch_shape=batch_shape), FilterMode.BYPASS)
    ref = np.asarray(jout["magnitude"])
    got = out["magnitude"]
    assert tuple(got.shape) == ref.shape
    assert snr_db(ref, got.numpy()) >= PARITY_FLOOR_DB["f32"]
    assert tuple(st.sos_state.shape) == tuple(jst.sos_state.shape)
    assert int(st.frame_count) == int(jst.frame_count) == 1


@pytest.mark.parametrize(
    "xs,state,match",
    [
        (np.zeros((2, 1, 100), np.float32), "iq", "multiple of"),
        (np.zeros((3, 1, N), np.float32), "iq", "leading 2-axis"),
        (np.zeros((2, 1, N), np.float32), "real", "initial_state"),
    ],
    ids=["misaligned", "not-stacked", "real-state"],
)
def test_process_planes_rejects_bad_input(port, xs, state, match):
    st = _cstate(port) if state == "iq" else port.initial_state()
    with pytest.raises(ValueError, match=match):
        port.process_planes(xs, st)


def test_bf16_io_complex_bypass_rounding_contract():
    """Complex BYPASS at bf16_io does not round the raw IQ input before the
    in-kernel window: its magnitudes are the plain bf16 tier's fp32 results
    rounded once on store."""
    x = _iq(np.random.default_rng(3), 2 * N)
    p_ref = SpectrumPipeline(PipelineConfig(dtype="bf16"), device="cpu")
    p_io = SpectrumPipeline(PipelineConfig(dtype="bf16", bf16_io=True), device="cpu")
    o_ref, _ = p_ref.process(x, _cstate(p_ref), FilterMode.BYPASS)
    o_io, _ = p_io.process(x, _cstate(p_io), FilterMode.BYPASS)
    assert o_ref["magnitude"].dtype == torch.float32
    assert o_io["magnitude"].dtype == torch.bfloat16
    assert torch.equal(o_io["magnitude"], o_ref["magnitude"].to(torch.bfloat16))


def test_jax_iq_checkpoint_carries_on_in_the_port(pipes):
    """A JAX IQ state (leading re/im 2-axis) converts and carries the
    stream on in the port as it does in JAX, and back."""
    jp, p = pipes("f32max", 1)
    x = _iq(np.random.default_rng(27), (1, 2 * N))
    first, second = x[:, :N], x[:, N:]
    _, jst = jp.process(first, jp.initial_state(batch_shape=(2,)), JFilterMode.CUSTOM)
    ck = jst.to_numpy()
    assert ck["sos_state"].shape == (2, 1, 6, 2)
    jout, jst2 = jp.process(second, jst, JFilterMode.CUSTOM)
    out, st2 = p.process(second, convert.state(ck, device="cpu"), FilterMode.CUSTOM)
    assert snr_db(np.asarray(jout["magnitude"]), out["magnitude"].numpy()) >= PARITY_FLOOR_DB["f32max"]
    np.testing.assert_allclose(
        st2.sos_state.numpy(), np.asarray(jst2.sos_state), rtol=1e-4, atol=1e-6
    )
    assert int(st2.frame_count) == int(jst2.frame_count) == 2
    back = JStreamState.from_numpy(st2.to_numpy())
    _, jst3 = jp.process(second, back, JFilterMode.CUSTOM)
    assert int(jst3.frame_count) == 3
