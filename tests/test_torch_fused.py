"""The port's fused two-pass path (``PipelineConfig(fused_two_pass=True)``
at the f32/f32max tiers) against tpu_sdr's, the float64 golden, the port's
own hybrid path and its streaming contracts, on the CPU, where the two IIR
kernels' plain versions run.

The kernels' plain versions (``iir_summaries_plain``, ``spectrum_iir_plain``)
are held against the JAX kernels in Pallas interpret mode, as the JAX
package's own tests run them on the CPU. Inputs come from seeded NumPy
generators and go to both packages. SNR = 10*log10(sum(ref^2) /
sum((ref - port)^2)) over all bins.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from tpu_sdr.control import golden
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr.runtime.state import StreamState as JStreamState
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.kernels import fft, window
from tpu_sdr_torch.kernels.cuda import iir_fft

torch.set_num_threads(1)

N = 16384
SOS = sps.butter(12, 0.25, output="sos")
TIERS = ("f32", "f32max")
MODES = ("CUSTOM", "FIXED")
# Port vs JAX magnitude SNR floors (tests/test_torch_stream.py): the JAX f32
# tier runs its "high3" bf16-split products, f32max is exact fp32 on both.
PARITY_FLOOR_DB = {"f32": 90.0, "f32max": 120.0}
# The in-kernel IIR's plain version vs the JAX kernel at "highest": both
# fp32, the block prefix summed in another order (sequential chain against
# Hillis-Steele doubling), so agreement is to fp32 rounding.
SPECTRUM_IIR_FLOOR_DB = 110.0
# Frame-end states (summaries and carried states): max |port - JAX| over
# max |JAX|, fp32 rounding of sums taken in different orders.
STATE_REL_TOL = 1e-5
# The port's fused path vs its hybrid path: the same function, the block
# prefix as a chain against the hybrid's block-Toeplitz product.
FUSED_VS_HYBRID_DB = 100.0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / np.abs(ref).max()


def _db(x):
    return 20.0 * np.log10(np.maximum(np.asarray(x, np.float64), 1e-12))


def _sos(mode):
    return {"CUSTOM": SOS, "FIXED": golden.fixed_filter_sos()}[mode]


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan) of the CUSTOM filter."""
    jp = jiir.build_plan(SOS, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128))
    pp = iir_fft.build_plan(
        SOS, window.hann_coefficients(N, device="cpu"),
        fft.plan_constants(128, 128, device="cpu"),
    )
    return jp, pp


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, N)).astype(np.float32)
    # entry states scaled 0.1, as tests/test_pallas_kernel.py does
    zs = (0.1 * rng.standard_normal((8, 12))).astype(np.float32)
    return x, zs


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) with fused_two_pass per (tier,
    channels), the custom bank loaded."""
    cache = {}

    def get(tier, channels, fused=True):
        key = tier, channels, fused
        if key not in cache:
            kw = dict(channels=channels, dtype=tier, fused_two_pass=fused)
            jp = JSpectrumPipeline(JPipelineConfig(**kw))
            p = SpectrumPipeline(PipelineConfig(**kw), device="cpu")
            jp.upload_sos(SOS)
            p.upload_sos(SOS)
            cache[key] = jp, p
        return cache[key]

    return get


def _random_state(p, seed):
    """A nonzero carried state, distinct per channel, for both packages."""
    st = p.initial_state()
    z = 0.1 * np.random.default_rng(seed).standard_normal(tuple(st.sos_state.shape))
    return z.astype(np.float32)


# ---------------------------------------------------------------- the kernels


@pytest.mark.parametrize("F", [1, 3, 8])
def test_iir_summaries_plain_matches_jax(plans, frames, F):
    jp, pp = plans
    x = frames[0][:F]
    ref = jiir.iir_summaries(jnp.asarray(x), jp, interpret=True, precision="highest")
    got = iir_fft.iir_summaries(torch.as_tensor(x), pp, precision="highest")
    assert got.shape == (F, 12) and got.dtype == torch.float32
    assert rel_err(np.asarray(ref), got.numpy()) <= STATE_REL_TOL


@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("F", [1, 3])
def test_spectrum_iir_plain_matches_jax(plans, frames, F, apply_window):
    jp, pp = plans
    x, zs = frames[0][:F], frames[1][:F]
    ref = jiir.spectrum_from_state(
        jnp.asarray(x), jnp.asarray(zs), jp, interpret=True,
        precision="highest", apply_window=apply_window, flat_emit=True,
    )
    got = iir_fft.spectrum_from_state(
        torch.as_tensor(x), torch.as_tensor(zs), pp, precision="highest",
        apply_window=apply_window,
    )
    assert got.shape == (F, N) and got.dtype == torch.float32
    assert snr_db(np.asarray(ref), got.numpy()) >= SPECTRUM_IIR_FLOOR_DB


def test_spectrum_iir_entry_state_matters(plans, frames):
    """The entry states reach the output: zero and nonzero states give
    different spectra, and the difference is the state's own response."""
    _, pp = plans
    x, zs = torch.as_tensor(frames[0][:2]), torch.as_tensor(frames[1][:2])
    with_state = iir_fft.spectrum_from_state(x, zs, pp)
    at_rest = iir_fft.spectrum_from_state(x, torch.zeros_like(zs), pp)
    assert not torch.equal(with_state, at_rest)
    assert snr_db(with_state.numpy(), at_rest.numpy()) < 60.0


def test_spectrum_iir_frames_independent_of_call(plans, frames):
    """A frame's bits do not depend on how many frames share the call."""
    _, pp = plans
    x, zs = torch.as_tensor(frames[0][:4]), torch.as_tensor(frames[1][:4])
    whole = iir_fft.spectrum_from_state(x, zs, pp)
    parts = torch.cat([
        iir_fft.spectrum_from_state(x[i : i + 1], zs[i : i + 1], pp) for i in range(4)
    ])
    assert torch.equal(whole, parts)
    s_whole = iir_fft.iir_summaries(x, pp)
    s_parts = torch.cat([iir_fft.iir_summaries(x[i : i + 1], pp) for i in range(4)])
    assert torch.equal(s_whole, s_parts)


def test_cpu_tensors_take_the_plain_versions(plans, frames):
    _, pp = plans
    x, zs = torch.as_tensor(frames[0][:1]), torch.as_tensor(frames[1][:1])
    iir_fft.reset_counts()
    iir_fft.iir_summaries(x, pp)
    iir_fft.spectrum_from_state(x, zs, pp)
    assert iir_fft.counts["plain"] == {
        "spectrum_bypass": 0, "spectrum_iir": 1, "iir_summaries": 1, "spectrum_complex": 0,
        "fm_demod": 0, "pfb_fold_dft": 0, "spectrum_half": 0, "fft_mag_fused": 0,
        "q15_fft": 0, "sosfilt_q15": 0, "viterbi": 0, "iir_state": 0, "iir_emit": 0,
        "iir_force": 0,
    }
    assert not any(iir_fft.counts["kernel"].values())


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda x, zs, pp: iir_fft.iir_summaries_cuda(x, pp), "CUDA tensor"),
        (lambda x, zs, pp: iir_fft.spectrum_iir_cuda(x, zs, pp), "CUDA tensor"),
        (lambda x, zs, pp: iir_fft.iir_summaries(x, pp, precision="fast"), "precision"),
        (lambda x, zs, pp: iir_fft.iir_summaries(x[:, :8192], pp), "x must be"),
        (lambda x, zs, pp: iir_fft.spectrum_from_state(x, zs[:0], pp), "z_starts"),
    ],
    ids=["summaries-cpu-tensor", "spectrum-iir-cpu-tensor", "precision", "shape", "z_starts"],
)
def test_iir_kernels_reject_bad_calls(plans, frames, call, match):
    _, pp = plans
    x, zs = torch.as_tensor(frames[0][:1]), torch.as_tensor(frames[1][:1])
    with pytest.raises(ValueError, match=match):
        call(x, zs, pp)


# ---------------------------------------------------------------- the pipeline


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", TIERS)
def test_fused_pipeline_matches_jax(pipes, tier, mode, channels):
    """Same input and the same nonzero carried state through both packages'
    fused two-pass paths."""
    jp, p = pipes(tier, channels)
    x = np.random.default_rng(1).standard_normal((channels, 2 * N)).astype(np.float32)
    z0 = _random_state(p, seed=2)
    jst = JStreamState.from_numpy({**jp.initial_state().to_numpy(), "sos_state": z0})
    st = p.initial_state()
    st.sos_state = torch.as_tensor(z0)
    jout, jst = jp.process(x, jst, JFilterMode[mode])
    iir_fft.reset_counts()
    out, st = p.process(x, st, FilterMode[mode])
    assert iir_fft.counts["plain"]["iir_summaries"] == 1
    assert iir_fft.counts["plain"]["spectrum_iir"] == 1
    assert iir_fft.counts["plain"]["spectrum_bypass"] == 0
    ref = np.asarray(jout["magnitude"])
    assert tuple(out["magnitude"].shape) == ref.shape == (channels, 2, N)
    assert snr_db(ref, out["magnitude"].numpy()) >= PARITY_FLOOR_DB[tier]
    assert rel_err(np.asarray(jst.sos_state), st.sos_state.numpy()) <= STATE_REL_TOL
    assert int(st.frame_count) == int(jst.frame_count) == 2


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", TIERS)
def test_fused_within_1db_of_golden(pipes, tier, mode):
    _, p = pipes(tier, 1)
    x = golden.synth_tone(100_000.0, 2 * N, 1e6, noise=0.01, seed=9)
    ref = golden.golden_pipeline(x, sos=_sos(mode), window="hann")["magnitude"]
    out, _ = p.process(x.astype(np.float32), p.initial_state(), FilterMode[mode])
    mag = out["magnitude"].numpy()[0]
    mask = ref > ref.max() * 1e-3
    assert np.abs(_db(mag[mask]) - _db(ref[mask])).max() < 1.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", TIERS)
def test_fused_matches_hybrid(pipes, tier, mode):
    _, fused = pipes(tier, 2)
    _, hybrid = pipes(tier, 2, fused=False)
    x = np.random.default_rng(3).standard_normal((2, 3 * N)).astype(np.float32)
    z0 = torch.as_tensor(_random_state(fused, seed=4))
    sf, sh = fused.initial_state(), hybrid.initial_state()
    sf.sos_state, sh.sos_state = z0.clone(), z0.clone()
    a, sa = fused.process(x, sf, FilterMode[mode])
    b, sb = hybrid.process(x, sh, FilterMode[mode])
    assert snr_db(b["magnitude"].numpy(), a["magnitude"].numpy()) >= FUSED_VS_HYBRID_DB
    assert rel_err(sb.sos_state.numpy(), sa.sos_state.numpy()) <= STATE_REL_TOL


def test_fused_keeps_channels_apart(pipes):
    """2 channels x 3 frames with distinct entry states: each channel's
    spectra and state are those of the channel run alone (the summaries'
    lead-major rows, the chain's (channel, frame) layout and z_starts' row
    order agree)."""
    _, p2 = pipes("f32", 2)
    _, p1 = pipes("f32", 1)
    x = np.random.default_rng(5).standard_normal((2, 3 * N)).astype(np.float32)
    z0 = torch.as_tensor(_random_state(p2, seed=6))
    st = p2.initial_state()
    st.sos_state = z0.clone()
    both, st_both = p2.process(x, st, FilterMode.CUSTOM)
    for c in range(2):
        st1 = p1.initial_state()
        st1.sos_state = z0[c : c + 1].clone()
        one, st_one = p1.process(x[c : c + 1], st1, FilterMode.CUSTOM)
        assert torch.equal(one["magnitude"][0], both["magnitude"][c])
        assert torch.equal(st_one.sos_state[0], st_both.sos_state[c])


@pytest.mark.parametrize(
    "tier,channels,frames,chunks,mode",
    [
        ("f32", 1, 4, 4, "CUSTOM"),
        ("f32", 2, 4, 2, "CUSTOM"),
        ("f32", 2, 4, 4, "FIXED"),
        ("f32max", 2, 4, 2, "CUSTOM"),
    ],
    ids=["f32-1frame", "f32-2ch", "f32-fixed", "f32max"],
)
def test_fused_chunked_equals_oneshot_bitwise(pipes, tier, channels, frames, chunks, mode):
    _, p = pipes(tier, channels)
    x = np.random.default_rng(8).standard_normal((channels, frames * N)).astype(np.float32)
    whole, st_whole = p.process(x, p.initial_state(), FilterMode[mode])
    st = p.initial_state()
    mags = []
    for chunk in np.split(x, chunks, axis=-1):
        out, st = p.process(chunk, st, FilterMode[mode])
        mags.append(out["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)
    assert int(st.frame_count) == frames and int(st.window_phase) == 0


def test_fused_bypass_takes_the_bypass_kernel(pipes):
    _, p = pipes("f32", 1)
    iir_fft.reset_counts()
    out, st = p.process(np.ones(N, np.float32), p.initial_state(), FilterMode.BYPASS)
    assert iir_fft.counts["plain"]["spectrum_bypass"] == 1
    assert iir_fft.counts["plain"]["iir_summaries"] == 0
    assert torch.equal(st.sos_state, p.initial_state().sos_state)
