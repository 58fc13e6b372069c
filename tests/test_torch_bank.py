"""Per-channel filter banks in the port (``upload_sos_bank``): each
channel's golden, the chunking contract, validation, the 2-D promotion,
the hybrid branch under ``fused_two_pass``, and the JAX package on the same
seeded NumPy input (JAX's kernels in Pallas interpret mode)."""

import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.kernels import biquad as jbiquad
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr.runtime import banks as jbanks
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline, convert
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.runtime import banks

torch.set_num_threads(1)

N = 16384
# Port vs JAX, the f32 tier (the reference's bf16-split products).
PARITY_FLOOR_DB = 90.0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def butter_bank(C):
    return np.stack([sps.butter(12, 0.1 * (c + 1), output="sos") for c in range(C)])


def test_per_channel_bank_matches_per_channel_golden():
    C = 4
    pipe = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    bank = butter_bank(C)
    pipe.upload_sos_bank(bank)
    x = np.random.default_rng(0).standard_normal((C, 2 * N)).astype(np.float32)
    out, st = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    mag = out["magnitude"].numpy()
    win = golden.hann_true(N)
    for c in range(C):
        xw = (x[c].astype(np.float64).reshape(-1, N) * win).reshape(-1)
        ref = np.abs(np.fft.fft(sps.sosfilt(bank[c], xw).reshape(-1, N), axis=-1))
        mask = ref > ref.max() * 1e-3
        db = np.abs(20 * np.log10(mag[c][mask] / ref[mask])).max()
        assert db < 0.05, f"channel {c}: {db} dB"
    assert tuple(st.sos_state.shape) == (C, 6, 2)


@pytest.mark.parametrize("chunks", [2, 4])
def test_bank_state_carry_ragged_list(chunks):
    C = 2
    pipe = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    # heterogeneous orders: passed as a list, padded per channel
    pipe.upload_sos_bank([sps.cheby1(8, 0.5, 0.2, output="sos"),
                          sps.butter(10, 0.35, output="sos")])
    x = np.random.default_rng(1).standard_normal((C, 4 * N)).astype(np.float32)
    out_w, st_w = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    st = pipe.initial_state()
    mags = []
    for chunk in np.split(x, chunks, axis=-1):
        o, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        mags.append(o["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), out_w["magnitude"])
    assert torch.equal(st.sos_state, st_w.sos_state)


def test_bank_single_frame_chunks_bit_identical():
    C = 1
    pipe = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    pipe.upload_sos_bank([sps.butter(12, 0.3, output="sos")])
    x = np.random.default_rng(60).standard_normal((C, 4 * N)).astype(np.float32)
    whole, st_w = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    st = pipe.initial_state()
    mags = []
    for chunk in np.split(x, 4, axis=-1):
        out, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        mags.append(out["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), whole["magnitude"])
    assert torch.equal(st.sos_state, st_w.sos_state)


def test_bank_validation():
    pipe = SpectrumPipeline(PipelineConfig(channels=4), device="cpu")
    with pytest.raises(ValueError, match="config has 4 channels"):
        pipe.upload_sos_bank(np.stack([sps.butter(4, 0.2, output="sos")] * 2))
    bad = np.stack([sps.butter(4, 0.2, output="sos")] * 4)
    bad[2, 0, 4] = -2.5
    bad[2, 0, 5] = 1.6
    with pytest.raises(ValueError, match="channel 2"):
        pipe.upload_sos_bank(bad)


def test_upload_rejects_a0_zero():
    pipe = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    with pytest.raises(ValueError, match="a0"):
        pipe.upload_sos(np.array([[1.0, 0, 0, 0.0, 1.0, 0.25]]))
    with pytest.raises(ValueError, match="a0"):
        pipe.upload_sos_bank([np.array([[1.0, 0, 0, 0.0, 1.0, 0.25]])])


def test_bank_precompute_promotes_2d_design():
    """One (S, 6) design builds the same 1-channel bank as (1, S, 6), and
    prepare_bank normalizes it the same way."""
    sos = sps.butter(6, 0.3, output="sos")
    op2d = biquad.precompute_composite_bank(sos, device="cpu")
    op3d = biquad.precompute_composite_bank(np.asarray(sos)[None], device="cpu")
    for f in dataclasses.fields(op2d):
        assert torch.equal(getattr(op2d, f.name), getattr(op3d, f.name)), f.name
    b = banks.prepare_bank(sos, channels=1, n_sections=6)
    assert b.shape == (1, 6, 6)  # padded with identity sections
    np.testing.assert_array_equal(b[0, :3], np.asarray(sos, np.float64))
    np.testing.assert_array_equal(b, jbanks.prepare_bank(sos, channels=1, n_sections=6))


def test_bank_leaves_equal_jax_bitwise():
    bank = banks.prepare_bank(butter_bank(2), 2, 6)
    ours = biquad.precompute_composite_bank(bank, device="cpu")
    ref = jbiquad.precompute_composite_bank(bank)
    for f in dataclasses.fields(ours):
        assert np.array_equal(getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))), f.name
    assert ours.block == 128 and ours.frame_blocks == 128 and ours.state_dim == 12


def test_bank_channel_equals_shared_cascade():
    """Channel c of a bank filters like the shared cascade of its design
    (the products batched over the channels, at another call shape)."""
    C = 2
    bank = banks.prepare_bank(butter_bank(C), C, 6)
    op = biquad.precompute_composite_bank(bank, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((C, 2 * N)).astype(np.float32))
    zi = torch.as_tensor(0.01 * np.random.default_rng(4).standard_normal((C, 6, 2)).astype(np.float32))
    y, zf = biquad.sosfilt_blocked_composite_bank(op, x, zi)
    for c in range(C):
        shared = biquad.precompute_composite(bank[c], device="cpu")
        yc, zc = biquad.sosfilt_blocked_composite(shared, x[c], zi[c])
        assert (y[c] - yc).abs().max() <= 1e-5 * yc.abs().max()
        assert (zf[c] - zc).abs().max() <= 1e-5 * zc.abs().max()


def test_fused_two_pass_bank_takes_the_hybrid_branch():
    C = 2
    pipe = SpectrumPipeline(PipelineConfig(channels=C, fused_two_pass=True), device="cpu")
    pipe.upload_sos_bank(butter_bank(C))
    x = np.random.default_rng(4).standard_normal((C, 2 * N)).astype(np.float32)
    launch.reset_counts()
    out, _ = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    assert launch.counts["plain"]["spectrum_iir"] == launch.counts["plain"]["iir_summaries"] == 0
    assert launch.counts["plain"]["spectrum_bypass"] == 1
    hybrid = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    hybrid.upload_sos_bank(butter_bank(C))
    ref, _ = hybrid.process(x, hybrid.initial_state(), FilterMode.CUSTOM)
    assert torch.equal(out["magnitude"], ref["magnitude"])
    # FIXED keeps the fused kernels: the bank replaces only the custom cascade
    launch.reset_counts()
    pipe.process(x, pipe.initial_state(), FilterMode.FIXED)
    assert launch.counts["plain"]["spectrum_iir"] == launch.counts["plain"]["iir_summaries"] == 1


@pytest.fixture(scope="module")
def jax_pair():
    C = 4
    bank = [sps.butter(12, 0.08 * (c + 1), output="sos") for c in range(C)]
    jp = JSpectrumPipeline(JPipelineConfig(channels=C))
    p = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    jp.upload_sos_bank(bank)
    p.upload_sos_bank(bank)
    return jp, p


@pytest.mark.parametrize("outputs", ["magnitude", "all"])
def test_bank_matches_jax(jax_pair, outputs):
    jp, p = jax_pair
    x = np.random.default_rng(7).standard_normal((4, 2 * N)).astype(np.float32)
    jout, jst = jp.process(x, jp.initial_state(), JFilterMode.CUSTOM, outputs)
    out, st = p.process(x, p.initial_state(), FilterMode.CUSTOM, outputs)
    assert set(out) == set(jout)
    for key in out:
        if key != "phase":
            assert snr_db(np.asarray(jout[key]), out[key].numpy()) >= PARITY_FLOOR_DB, key
    np.testing.assert_allclose(st.sos_state.numpy(), np.asarray(jst.sos_state), rtol=1e-4, atol=1e-6)


def test_jax_bank_through_convert_gives_same_bits(jax_pair):
    """A JAX per-channel bank carried over by convert.bank gives the port's
    own bank's output, bit for bit."""
    jp, p = jax_pair
    leaves = lambda obj: {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    carried = SpectrumPipeline(PipelineConfig(channels=4), device="cpu")
    carried.bank_custom = convert.bank(
        {"op": leaves(jp.bank_custom["op"]), "pp": leaves(jp.bank_custom["pp"])}, device="cpu"
    )
    assert carried.bank_custom["op"].T.shape == (4, 128, 128)
    x = np.random.default_rng(8).standard_normal((4, N)).astype(np.float32)
    a, sa = p.process(x, p.initial_state(), FilterMode.CUSTOM)
    b, sb = carried.process(x, carried.initial_state(), FilterMode.CUSTOM)
    assert torch.equal(a["magnitude"], b["magnitude"]) and torch.equal(sa.sos_state, sb.sos_state)


def test_bank_iq_planes_and_hop():
    """A bank under IQ input (stacked re/im planes) and under hop < N."""
    C = 2
    bank = butter_bank(C)
    n = np.arange(2 * N)
    xc = np.stack([np.exp(2j * np.pi * 800 * n / N)] * C).astype(np.complex64)
    p = SpectrumPipeline(PipelineConfig(channels=C), device="cpu")
    p.upload_sos_bank(bank)
    out, st = p.process(xc, p.initial_state(batch_shape=(2,)), FilterMode.CUSTOM)
    mag = out["magnitude"].numpy()
    assert tuple(st.sos_state.shape) == (2, C, 6, 2)
    # channel 0's lowpass at 0.1 (819 bins) passes bin 800 less than channel 1's at 0.2
    assert mag[0, 1, 800] < mag[1, 1, 800] and int(np.argmax(mag[1, 1])) == 800
    h = SpectrumPipeline(PipelineConfig(channels=C, hop=8192), device="cpu")
    h.upload_sos_bank(bank)
    x = np.random.default_rng(9).standard_normal((C, 2 * N)).astype(np.float32)
    whole, _ = h.process(x, h.initial_state(), FilterMode.CUSTOM)
    st = h.initial_state()
    parts = []
    for chunk in np.split(x, 2, axis=-1):
        o, st = h.process(chunk, st, FilterMode.CUSTOM)
        parts.append(o["magnitude"])
    assert torch.equal(torch.cat(parts, dim=1), whole["magnitude"])
