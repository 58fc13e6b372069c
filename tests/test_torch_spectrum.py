"""The port's last two kernel forms against the JAX package: the half
spectrum and blocked output of ``spectrum_from_state`` (kernel row 4) and
``fft_mag_fused`` (row 6), on the CPU, where each wrapper runs its plain
version. The JAX kernels run in Pallas interpret mode, as their own tests
run them. The CUDA kernels are held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr.kernels.pallas import spectrum as jspectrum
from tpu_sdr_torch.kernels import fft, window
from tpu_sdr_torch.kernels.cuda import iir_fft, launch, spectrum

torch.set_num_threads(1)

N = 16384
# As tests/test_torch_kernels.py: fp32 results agree to fp32 rounding; a
# bf16 store keeps 8 mantissa bits, rounded once on each side.
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}
# Half against full spectrum, max error over max |full|: the reference's
# own bound (tests/test_pallas_kernel.py).
HALF_REL = 1e-5
FORMS = {"iir": dict(), "bypass": dict(bypass=True), "nowindow": dict(apply_window=False)}


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


@pytest.fixture(scope="module")
def setup():
    """The plans of both packages and the inputs of the reference's
    half-spectrum test (4 frames, entry states 0.1 x normal)."""
    sos = sps.butter(12, 0.25, output="sos")
    jp = jiir.build_plan(sos, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128))
    pp = iir_fft.build_plan(
        sos, window.hann_coefficients(N, device="cpu"), fft.plan_constants(128, 128, device="cpu")
    )
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, N)).astype(np.float32)
    zs = (0.1 * rng.standard_normal((4, 12))).astype(np.float32)
    return jp, pp, x, zs


def _port(pp, x, zs, **kw):
    return iir_fft.spectrum_from_state(torch.as_tensor(x), torch.as_tensor(zs), pp, **kw)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_half_spectrum_matches_jax(setup, form, out_dtype):
    jp, pp, x, zs = setup
    ref = jiir.spectrum_from_state(
        jnp.asarray(x), jnp.asarray(zs), jp, interpret=True, half_spectrum=True,
        out_dtype=out_dtype, **FORMS[form],
    )
    got = _port(pp, x, zs, half_spectrum=True, out_dtype=out_dtype, **FORMS[form])
    assert got.shape == (4, N) and str(got.dtype) == f"torch.{out_dtype}"
    snr = snr_db(np.asarray(ref, np.float32), got.float().numpy())
    assert snr >= SNR_FLOOR_DB[out_dtype], snr


@pytest.mark.parametrize("form", list(FORMS))
def test_half_spectrum_matches_full(setup, form):
    _, pp, x, zs = setup
    full = _port(pp, x, zs, **FORMS[form]).numpy()
    half = _port(pp, x, zs, half_spectrum=True, **FORMS[form]).numpy()
    assert np.abs(full - half).max() / np.abs(full).max() < HALF_REL


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_half_spectrum_mirrored_bins_are_their_partners_bits(setup, form, out_dtype):
    """out[k1, k2] for k2 in [65, 127] is out[127 - k1, 128 - k2], bit for
    bit, in the stored type."""
    _, pp, x, zs = setup
    got = _port(pp, x, zs, half_spectrum=True, out_dtype=out_dtype, **FORMS[form])
    g = got.view(4, 128, 128)
    k1 = torch.arange(128)[:, None]
    k2 = torch.arange(65, 128)[None, :]
    assert torch.equal(g[:, k1, k2], g[:, 127 - k1, 128 - k2])


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("form", list(FORMS))
def test_blocked_output_is_the_same_bits(setup, form, half):
    _, pp, x, zs = setup
    flat = _port(pp, x, zs, half_spectrum=half, **FORMS[form])
    blocked = _port(pp, x, zs, half_spectrum=half, blocked_output=True, **FORMS[form])
    assert blocked.shape == (4, 128, 128)
    assert torch.equal(blocked.reshape(4, N), flat)


def test_blocked_output_matches_jax_layout(setup):
    jp, pp, x, zs = setup
    ref = np.asarray(jiir.spectrum_from_state(
        jnp.asarray(x), jnp.asarray(zs), jp, interpret=True, blocked_output=True,
    ))
    got = _port(pp, x, zs, blocked_output=True).numpy()
    assert got.shape == ref.shape == (4, 128, 128)
    assert snr_db(ref, got) >= SNR_FLOOR_DB["float32"]


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(half_spectrum=True, flat_emit=True), "half_spectrum"),
        (dict(flat_emit=True, blocked_output=True), "exclusive"),
    ],
    ids=["half-flat", "flat-blocked"],
)
def test_layout_option_errors_match_jax(setup, kw, match):
    jp, pp, x, zs = setup
    with pytest.raises(ValueError, match=match):
        jiir.spectrum_from_state(jnp.asarray(x), jnp.asarray(zs), jp, interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        _port(pp, x, zs, **kw)


def test_half_spectrum_runs_its_plain_version_on_cpu(setup):
    _, pp, x, zs = setup
    launch.reset_counts()
    _port(pp, x[:1], zs[:1], half_spectrum=True, bypass=True)
    _port(pp, x[:1], zs[:1], half_spectrum=True)
    assert launch.counts["plain"]["spectrum_half"] == 2
    assert not any(launch.counts["kernel"].values())
    assert launch.counts["plain"]["spectrum_bypass"] == launch.counts["plain"]["spectrum_iir"] == 0


def test_half_kernel_wrapper_refuses_other_devices(setup):
    """A tensor that is not on the CPU reaches the CUDA wrapper, which
    checks it before any build (a meta tensor here)."""
    _, pp, _, _ = setup
    for zs in (None, torch.zeros((2, 12))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            iir_fft.spectrum_from_state(
                torch.empty((2, N), device="meta"), torch.zeros((2, 12)), pp,
                half_spectrum=True, bypass=zs is None,
            )


# ---------------------------------------------------------------- fft_mag_fused


@pytest.fixture(scope="module")
def fused_inputs():
    rng = np.random.default_rng(11)
    return rng.standard_normal((4, N)).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5], ids=["plan", "scaled-plan"])
@pytest.mark.parametrize("F", [1, 4])
def test_fft_mag_fused_matches_jax(fused_inputs, F, scale):
    """Scaled planes (each x 0.5, so |X| x 1/8) show that both packages
    compute with the planes they are given."""
    x = fused_inputs[:F]
    jplan = {k: v * scale for k, v in jfft.plan_constants(128, 128).items()}
    plan = {k: v * scale for k, v in fft.plan_constants(128, 128, device="cpu").items()}
    ref = np.asarray(jspectrum.fft_mag_fused(
        jnp.asarray(x), jwindow.hann_coefficients(N), jplan, interpret=True
    ))
    got = spectrum.fft_mag_fused(
        torch.as_tensor(x), window.hann_coefficients(N, device="cpu"), plan
    ).numpy()
    assert got.shape == (F, N) and got.dtype == np.float32
    assert np.abs(got - ref).max() / np.abs(ref).max() < HALF_REL
    golden = np.abs(np.fft.fft(x.astype(np.float64) * np.asarray(jwindow.hann_coefficients(N))))
    assert np.abs(got - golden * scale**3).max() / (golden.max() * scale**3) < HALF_REL


def test_fft_mag_fused_other_geometry_on_cpu(fused_inputs):
    """n1 = 64, n2 = 256 runs the plain version on the CPU (the kernel takes
    128 x 128 only)."""
    x = torch.as_tensor(fused_inputs[:2])
    win = window.hann_coefficients(N, device="cpu")
    got = spectrum.fft_mag_fused(x, win, fft.plan_constants(64, 256, device="cpu"), n1=64, n2=256)
    ref = np.abs(np.fft.fft(x.double().numpy() * win.double().numpy()))
    assert np.abs(got.numpy() - ref).max() / ref.max() < HALF_REL


def test_fft_mag_fused_validation(fused_inputs):
    x = torch.as_tensor(fused_inputs[:1])
    win = window.hann_coefficients(N, device="cpu")
    plan = fft.plan_constants(128, 128, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        spectrum.fft_mag_fused(x, win, plan, precision="fast")
    with pytest.raises(ValueError, match="plan"):
        spectrum.fft_mag_fused(x, win, plan, n1=64, n2=256)
    with pytest.raises(ValueError, match="frames must be"):
        spectrum.fft_mag_fused(x[:, :8192], win, plan)
    meta = lambda shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="n1 = n2 = 128"):
        spectrum.fft_mag_fused(
            meta((1, N)), meta((N,)), {k: meta(v.shape) for k, v in
                                       fft.plan_constants(64, 256, device="cpu").items()},
            n1=64, n2=256,
        )
    with pytest.raises(ValueError, match="CUDA tensor"):
        spectrum.fft_mag_fused_cuda(x, win, plan)
    launch.reset_counts()
    spectrum.fft_mag_fused(x, win, plan)
    assert launch.counts["plain"]["fft_mag_fused"] == 1 and not any(launch.counts["kernel"].values())


# ---------------------------------------------------------------- launch plumbing


def test_ctypes_signatures_match_the_c_entry_points():
    """Each kernel's ctypes argument list matches its C entry point: a
    pointer passed as a 32-bit int would be cut."""
    src = Path(launch.__file__).resolve().parents[2] / "csrc"
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    assert set(launch._SIGNATURES) == set(launch.KERNELS)
    for name, sig in launch._SIGNATURES.items():
        assert set(sig) <= set(kinds)
        text = (src / f"{name}.cu").read_text()
        m = re.search(rf"int tpu_sdr_{name}\((.*?)\)\s*{{", text, re.S)
        args = [a.strip() for a in m.group(1).split(",")]
        got = "".join("p" if "*" in a else "f" if a.startswith("float") else "i" for a in args)
        assert got == sig, name
