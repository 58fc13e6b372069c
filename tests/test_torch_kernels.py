"""PyTorch port kernels vs the JAX package: four-step FFT, window, decode,
the kernel plan and the spectrum kernel's plain version.

Inputs are made with NumPy from a seed and handed to both packages. The JAX
spectrum kernel runs in Pallas interpret mode, as its own tests run it on
the CPU. The CUDA kernel itself is tested on the card by
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import magnitude as jmag
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr_torch.kernels import fft, magnitude, window
from tpu_sdr_torch.kernels.cuda import iir_fft

torch.set_num_threads(1)

N = 16384
# SNR floors of the spectrum kernel against the reference, by output type:
# fp32 results agree to fp32 rounding (>= 120 dB); a bf16 store keeps 8
# mantissa bits (~50 dB), and both sides round once.
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


@pytest.fixture(scope="module")
def plan():
    return fft.plan_constants(128, 128, device="cpu")


def _spec(fr, fi):
    return fr.double().numpy() + 1j * fi.double().numpy()


@pytest.mark.parametrize(
    "shape,n1,n2,complex_in",
    [
        ((N,), 128, 128, False),
        ((N,), 128, 128, True),
        ((3, N), 128, 128, False),
        ((8192,), 64, 128, False),
        ((N,), 64, 256, False),
    ],
    ids=["real", "complex", "batched", "64x128", "64x256"],
)
def test_fft_4step_matches_numpy(shape, n1, n2, complex_in):
    rng = np.random.default_rng(0)
    xr = rng.standard_normal(shape).astype(np.float32)
    xi = rng.standard_normal(shape).astype(np.float32) if complex_in else None
    p = fft.plan_constants(n1, n2, device="cpu")
    fr, fi = fft.fft_4step(
        torch.as_tensor(xr), None if xi is None else torch.as_tensor(xi), p
    )
    x = xr.astype(np.float64) + (0 if xi is None else 1j * xi.astype(np.float64))
    ref = np.fft.fft(x, axis=-1)
    assert np.max(np.abs(_spec(fr, fi) - ref)) / np.max(np.abs(ref)) < 1e-5


def test_fft_tone_bin_exact(plan):
    k = 1638
    x = np.cos(2 * np.pi * k * np.arange(N) / N).astype(np.float32)
    fr, fi = fft.fft_4step(torch.as_tensor(x), None, plan)
    mag = magnitude.magnitude(fr, fi).numpy()
    assert int(np.argmax(mag)) in (k, N - k)
    assert mag[k] == pytest.approx(8192.0, rel=1e-4)
    assert np.max(np.delete(mag, [k, N - k])) < 1e-2 * mag[k]


def test_fft_parseval(plan):
    x = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    fr, fi = fft.fft_4step(torch.as_tensor(x), None, plan)
    p_freq = np.sum(np.abs(_spec(fr, fi)) ** 2) / N
    assert p_freq == pytest.approx(np.sum(x.astype(np.float64) ** 2), rel=1e-5)


def test_ifft_roundtrip(plan):
    rng = np.random.default_rng(2)
    xr = torch.as_tensor(rng.standard_normal(N).astype(np.float32))
    xi = torch.as_tensor(rng.standard_normal(N).astype(np.float32))
    br, bi = fft.ifft_4step(*fft.fft_4step(xr, xi, plan), plan)
    assert (br - xr).abs().max() < 1e-3 and (bi - xi).abs().max() < 1e-3


def test_ifft_real_input_convention(plan):
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    rr, ri = fft.ifft_4step(torch.as_tensor(x), None, plan)
    ref = np.fft.ifft(x.astype(np.float64))
    np.testing.assert_allclose(rr.double().numpy(), ref.real, atol=1e-6)
    np.testing.assert_allclose(ri.double().numpy(), ref.imag, atol=1e-6)


@pytest.mark.parametrize("n1,n2", [(128, 128), (64, 256)])
def test_plan_constants_equal_jax_bitwise(n1, n2):
    ours = fft.plan_constants(n1, n2, device="cpu")
    ref = jfft.plan_constants(n1, n2)
    assert set(ours) == set(ref)
    for k in ref:
        assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k


@pytest.mark.parametrize("rtl", [False, True], ids=["hann", "rtl"])
def test_window_equals_jax_bitwise(rtl):
    ours = window.hann_coefficients(N, rtl, device="cpu").numpy()
    assert np.array_equal(ours, np.asarray(jwindow.hann_coefficients(N, rtl)))


@pytest.mark.parametrize("fn", ["magnitude", "power", "phase"])
def test_decode_matches_jax(fn):
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal((2, 4, 256)).astype(np.float32)
    got = getattr(magnitude, fn)(torch.as_tensor(re), torch.as_tensor(im))
    ref = getattr(jmag, fn)(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def plans():
    sos = sps.butter(12, 0.25, output="sos")
    jp = jiir.build_plan(
        sos, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128)
    )
    pp = iir_fft.build_plan(
        sos,
        window.hann_coefficients(N, device="cpu"),
        fft.plan_constants(128, 128, device="cpu"),
    )
    return jp, pp


@pytest.mark.parametrize(
    "leaf", [f.name for f in dataclasses.fields(iir_fft.PallasSOSPlan)]
)
def test_build_plan_leaf_equals_jax_bitwise(plans, leaf):
    jp, pp = plans
    ref = np.asarray(getattr(jp, leaf))
    got = getattr(pp, leaf).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_build_plan_rejects_other_geometry():
    with pytest.raises(ValueError, match="128x128 four-step"):
        iir_fft.build_plan(
            sps.butter(12, 0.2, output="sos"),
            window.hann_coefficients(N, device="cpu"),
            fft.plan_constants(64, 256, device="cpu"),
        )


def test_kernel_dft_table_is_the_plan(plans):
    """The kernel reads W[k, n] as table[(k*n) mod 128] (row 1 of each DFT
    plane) and the twiddle from the plan: within 1 ulp of every plan entry."""
    _, pp = plans
    tab, twr, twi = pp.kernel_constants
    idx = np.outer(np.arange(128), np.arange(128)) % 128
    for row, leaf in enumerate(("w2r", "w2i", "w1r", "w1i")):
        full = getattr(pp, leaf).numpy()
        assert np.abs(full - tab[row].numpy()[idx]).max() <= np.spacing(np.float32(1))
    assert torch.equal(twr, pp.twr[:, :128]) and torch.equal(twi, pp.twi[:, :128])


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).standard_normal((8, N)).astype(np.float32)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("F", [1, 3, 8])
def test_spectrum_plain_matches_jax(plans, frames, F, apply_window, out_dtype):
    jp, pp = plans
    x = frames[:F]
    zs = np.zeros((F, 12), np.float32)
    ref = jiir.spectrum_from_state(
        jnp.asarray(x), jnp.asarray(zs), jp, interpret=True,
        precision="highest", bypass=True, apply_window=apply_window,
        out_dtype=out_dtype, flat_emit=True,
    )
    got = iir_fft.spectrum_from_state(
        torch.as_tensor(x), torch.as_tensor(zs), pp, precision="highest",
        bypass=True, apply_window=apply_window, out_dtype=out_dtype,
        flat_emit=True,
    )
    assert got.shape == (F, N) and str(got.dtype) == f"torch.{out_dtype}"
    snr = snr_db(np.asarray(ref, np.float32), got.float().numpy())
    assert snr >= SNR_FLOOR_DB[out_dtype], snr


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_spectrum_plain_bf16_input_matches_jax(plans, frames, out_dtype):
    """bf16_io hands the kernel bf16 frames (FIXED/CUSTOM, no window)."""
    jp, pp = plans
    x = frames[:3]
    zs = np.zeros((3, 12), np.float32)
    ref = jiir.spectrum_from_state(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(zs), jp, interpret=True,
        precision="default", bypass=True, apply_window=False,
        out_dtype=out_dtype, flat_emit=True,
    )
    got = iir_fft.spectrum_from_state(
        torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(zs), pp,
        precision="default", bypass=True, apply_window=False,
        out_dtype=out_dtype, flat_emit=True,
    )
    snr = snr_db(np.asarray(ref, np.float32), got.float().numpy())
    assert snr >= SNR_FLOOR_DB[out_dtype], snr


def test_spectrum_flat_emit_same_bits(plans, frames):
    _, pp = plans
    x = torch.as_tensor(frames[:2])
    zs = torch.zeros((2, 12))
    a = iir_fft.spectrum_from_state(x, zs, pp, bypass=True, flat_emit=True)
    b = iir_fft.spectrum_from_state(x, zs, pp, bypass=True, flat_emit=False)
    assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_version_only(plans, frames):
    _, pp = plans
    iir_fft.reset_counts()
    iir_fft.spectrum_from_state(
        torch.as_tensor(frames[:1]), torch.zeros((1, 12)), pp, bypass=True
    )
    assert not any(iir_fft.counts["kernel"].values())
    assert iir_fft.counts["plain"]["spectrum_bypass"] == 1


def test_aligned_copies_only_unaligned_or_strided_tensors():
    """The kernel loads 16 bytes at a time: its wrapper hands it a copy of
    a view that starts off a 16-byte boundary or is not contiguous."""
    from tpu_sdr_torch.kernels.cuda import launch

    base = torch.arange(2 * N + 8, dtype=torch.float32)
    assert launch.aligned(base) is base
    for view in (base[3 : 3 + N], base[: 2 * N].reshape(2, N)[:, ::2]):
        got = launch.aligned(view)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, view)


def test_kernel_wrapper_refuses_cpu_tensor(plans, frames):
    _, pp = plans
    with pytest.raises(ValueError, match="CUDA tensor"):
        iir_fft.spectrum_bypass_cuda(torch.as_tensor(frames[:1]), pp)


@pytest.mark.parametrize(
    "kw,exc",
    [
        (dict(bypass=True, half_spectrum=True), None),
        (dict(bypass=True, blocked_output=True), None),
        (dict(bypass=True, precision="fast"), ValueError),
        (dict(bypass=True, out_dtype="float16"), ValueError),
    ],
    ids=["half", "blocked", "precision", "out_dtype"],
)
def test_spectrum_rejects_unported_and_bad_options(plans, frames, kw, exc):
    """Bad options raise; half_spectrum and blocked_output, ported now, run
    (each beside flat_emit raises, as in the reference)."""
    _, pp = plans
    run = lambda **extra: iir_fft.spectrum_from_state(
        torch.as_tensor(frames[:1]), torch.zeros((1, 12)), pp, **kw, **extra
    )
    if exc is not None:
        with pytest.raises(exc):
            run()
        return
    out = run()
    full = iir_fft.spectrum_from_state(
        torch.as_tensor(frames[:1]), torch.zeros((1, 12)), pp, bypass=True
    )
    assert out.reshape(1, N).shape == (1, N) and torch.isfinite(out).all()
    assert (out.reshape(1, N) - full).abs().max() <= 1e-5 * full.abs().max()
    with pytest.raises(ValueError):
        run(flat_emit=True)


def test_spectrum_checks_shapes(plans, frames):
    _, pp = plans
    with pytest.raises(ValueError, match="z_starts"):
        iir_fft.spectrum_from_state(
            torch.as_tensor(frames[:2]), torch.zeros((1, 12)), pp, bypass=True
        )
    with pytest.raises(ValueError, match="x must be"):
        iir_fft.spectrum_from_state(
            torch.zeros((1, 8192)), torch.zeros((1, 12)), pp, bypass=True
        )


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """A kernel source and two headers in a temporary SOURCE_DIR."""
    from tpu_sdr_torch.kernels.cuda import loader

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(loader, "SOURCE_DIR", tmp_path)
    return loader, tmp_path


@pytest.mark.parametrize("changed", ["k.cu", "a.cuh", "b.cuh"])
def test_library_path_hashes_source_and_headers(sources, changed):
    """Editing the source or any header of csrc/ names a new library, so a
    stale build of a shared header is never loaded."""
    loader, src = sources
    before = loader.library_path("k")
    (src / changed).write_text((src / changed).read_text() + "// edited\n")
    after = loader.library_path("k")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_library_path_sees_a_new_header(sources):
    loader, src = sources
    before = loader.library_path("k")
    (src / "c.cuh").write_text("// c\n")
    assert loader.library_path("k") != before
    (src / "c.cuh").unlink()
    assert loader.library_path("k") == before


def test_package_data_lists_the_headers():
    """Every header the kernels include ships with the package."""
    import tomllib
    from pathlib import Path

    from tpu_sdr_torch.kernels.cuda import launch, loader

    root = Path(__file__).resolve().parents[1]
    data = tomllib.loads((root / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["tpu_sdr_torch"]
    assert "csrc/*.cu" in globs and "csrc/*.cuh" in globs
    assert sorted(p.name for p in loader.SOURCE_DIR.glob("*.cuh")) == [
        "affine_chain.cuh", "error_string.cuh", "fft128.cuh", "frame.cuh", "iir_blocks.cuh",
        "split_bf16.cuh",
    ]
    # The half spectrum launches the bypass and IIR kernels: a counter, no source.
    assert "fft_mag_fused" in launch.KERNELS and "spectrum_half" not in launch.KERNELS
    assert set(launch.COUNTERS) == set(launch.KERNELS) | {"spectrum_half"}
    assert set(iir_fft.KERNELS) <= set(launch.KERNELS)
    for name in launch.KERNELS:
        assert (loader.SOURCE_DIR / f"{name}.cu").is_file()
