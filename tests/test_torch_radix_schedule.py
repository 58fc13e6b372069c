"""A NumPy model of the radix schedule of the two spectrum kernels that run
radix FFTs on the card (``csrc/spectrum_bypass.cu``, real frames, and
``csrc/spectrum_complex.cu``, IQ frames; the radix core is
``csrc/fft128.cuh``).

No CUDA kernel runs here, so this file is the readable spec of their index
maps: the same four-step split (N = 128 x 128), the same radix stages
(column: 16-point FFTs over n2 = a + 8b, twiddle W128^(a*c), 8-point FFTs
over a; row: 8-point FFTs over n1 = u + 16b, twiddle W128^(u*t), 16-point
FFTs over u), the same W128-table twiddle indices, the same digit
reversal, the same assignment of stage-2 rows to the eight threads of a
group, the real kernel's Hermitian split of a packed column pair and its
mirror |X[N - k]| = |X[k]|. The model runs from ``plan.kernel_constants``
of ``tpu_sdr_torch`` in float64 and is held against ``np.fft.fft`` (float64)
and against ``tpu_sdr``'s kernels in Pallas interpret mode. It is not a
plain version: nothing on any path calls it.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr_torch.kernels import fft, window
from tpu_sdr_torch.kernels.cuda import iir_fft

N = 16384
SOS = sps.butter(12, 0.25, output="sos")
# The model against a float64 FFT: it computes in float64 from the plan's
# float32 table and twiddle planes, whose rounding (2^-25 relative) bounds it
# near 140 dB; a wrong index, twiddle or digit reversal falls below 0 dB.
FFT64_FLOOR_DB = 135.0
# The model against the JAX kernels in interpret mode: those run the dense
# four-step in float32 (about 133 dB against float64), so the floor is the
# kernel-vs-plain one.
JAX_FLOOR_DB = 120.0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def bitrev(k: int, bits: int) -> int:
    return int(f"{k:0{bits}b}"[::-1], 2)


def dft_dif(v: list, w: np.ndarray) -> list:
    """``fft128.cuh`` ``dft<L>``: radix-2 decimation in frequency on L
    arrays in natural order; stage s pairs v[i], v[i + h] (h = L >> (s+1))
    and multiplies the difference by W128^(j * 64 / h), j = i mod h (1 and
    -i exactly); the output is read back in bit-reversed order."""
    v = list(v)
    L = len(v)
    bits = L.bit_length() - 1
    for s in range(bits):
        h = L >> (s + 1)
        for i in range(L):
            if i & h:
                continue
            a, b = v[i], v[i + h]
            v[i] = a + b
            d = a - b
            idx = (i & (h - 1)) * (64 // h)
            v[i + h] = d if idx == 0 else (-1j * d if idx == 32 else d * w[idx])
    return [v[bitrev(k, bits)] for k in range(L)]


def column_fft(z: np.ndarray, w: np.ndarray) -> np.ndarray:
    """z (F, n2, cols) complex -> Y (F, k2, cols): thread a holds z[a + 8b];
    V_a[c] = FFT16_b(z[a + 8b])[c] * W128^(a*c); Y[c + 16d] = FFT8_a(V_a[c])[d]."""
    V = []
    for a in range(8):
        U = dft_dif([z[:, a + 8 * b] for b in range(16)], w)
        V.append([U[c] * w[a * c] if c else U[c] for c in range(16)])
    Y = np.empty_like(z)
    for c in range(16):
        Z = dft_dif([V[a][c] for a in range(8)], w)
        for d in range(8):
            Y[:, c + 16 * d] = Z[d]
    return Y


def row_fft(T: np.ndarray, w: np.ndarray) -> np.ndarray:
    """T (F, rows, n1) -> Z (F, rows, k1): thread a' holds T[u + 16b] for
    u = 2a', 2a' + 1; V_u[t] = FFT8_b(T[u + 16b])[t] * W128^(u*t); thread t:
    Z[t + 8v] = FFT16_u(V_u[t])[v]."""
    V = []
    for u in range(16):
        U = dft_dif([T[..., u + 16 * b] for b in range(8)], w)
        V.append([U[t] * w[u * t] if t else U[t] for t in range(8)])
    Z = np.empty_like(T)
    for t in range(8):
        R = dft_dif([V[u][t] for u in range(16)], w)
        for v in range(16):
            Z[..., t + 8 * v] = R[v]
    return Z


def real_rows_of_thread(t: int) -> list:
    """Thread t of a column group's stage 2 (``spectrum_bypass.cu``): its
    c = (0, 8) for t = 0, else (t, 16 - t); the rows it emits as (k2, its
    Z[k2] as (c index, d), the partner Z[128 - k2] as (c index, d))."""
    c = (0, 8) if t == 0 else (t, 16 - t)
    if t == 0:
        rows = [(16 * d, (0, d), (0, (8 - d) % 8)) for d in range(5)]
        rows += [(8 + 16 * d, (1, d), (1, 7 - d)) for d in range(4)]
    else:
        rows = [(t + 16 * d, (0, d), (1, 7 - d)) for d in range(4)]
        rows += [(c[1] + 16 * d, (1, d), (0, 7 - d)) for d in range(4)]
    return [(k2, c[i] + 16 * d, c[j] + 16 * e) for k2, (i, d), (j, e) in rows]


def model_real(x: np.ndarray, pp, apply_window: bool) -> np.ndarray:
    """``spectrum_bypass.cu``: |DFT| (F, N) of real frames x (F, N)."""
    tab, twr, twi = (t.double().numpy() for t in pp.kernel_constants)
    wc, wr = tab[0] + 1j * tab[1], tab[2] + 1j * tab[3]
    tw = twr + 1j * twi
    xw = x * pp.win.reshape(-1).numpy() if apply_window else x  # the fp32 product
    X = xw.astype(np.float64).reshape(-1, 128, 128)
    Zp = column_fft(X[:, :, 0::2] + 1j * X[:, :, 1::2], wc)  # column pairs (2P, 2P + 1)
    Y = np.zeros((X.shape[0], 65, 128), complex)
    emitted = []
    for t in range(8):
        for k2, k, kk in real_rows_of_thread(t):
            assert kk == (128 - k2) % 128 and k == k2
            zk, zkk = Zp[:, k], Zp[:, kk]
            Y[:, k2, 0::2] = (zk.real + zkk.real) * 0.5 + 1j * (zk.imag - zkk.imag) * 0.5
            Y[:, k2, 1::2] = (zk.imag + zkk.imag) * 0.5 + 1j * (zkk.real - zk.real) * 0.5
            emitted.append(k2)
    assert sorted(emitted) == list(range(65))
    Z = np.abs(row_fft(Y * tw[:65], wr))  # (F, k2 <= 64, k1)
    out = np.empty((X.shape[0], 128, 128))
    out[:, :, :65] = Z.transpose(0, 2, 1)
    for k2 in range(1, 64):  # the mirror: out[127 - k1][128 - k2] = |Z[k2][k1]|
        out[:, ::-1, 128 - k2] = Z[:, k2, :]
    return out.reshape(-1, N)


def model_complex(xr: np.ndarray, xi: np.ndarray, pp, apply_window: bool) -> np.ndarray:
    """``spectrum_complex.cu``: |DFT| (F, N) of IQ frames, the twiddled rows
    in two halves: thread t's c = t (k2 mod 16 < 8) and c = t + 8."""
    tab, twr, twi = (t.double().numpy() for t in pp.kernel_constants)
    wc, wr = tab[0] + 1j * tab[1], tab[2] + 1j * tab[3]
    tw = twr + 1j * twi
    if apply_window:
        w32 = pp.win.reshape(-1).numpy()
        xr, xi = xr * w32, xi * w32
    z = (xr.astype(np.float64) + 1j * xi.astype(np.float64)).reshape(-1, 128, 128)
    Y = column_fft(z, wc) * tw
    out = np.empty((z.shape[0], 128, 128))
    for h in range(2):
        # row r of half h is k2 = (r mod 8) + 8h + 16 (r / 8)
        k2s = [(r % 8) + 8 * h + 16 * (r // 8) for r in range(64)]
        assert sorted(k2s) == [k for k in range(128) if (k % 16 >= 8) == bool(h)]
        out[:, :, k2s] = np.abs(row_fft(Y[:, k2s], wr)).transpose(0, 2, 1)
    return out.reshape(-1, N)


@pytest.fixture(scope="module")
def plans():
    jp = jiir.build_plan(SOS, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128))
    pp = iir_fft.build_plan(
        SOS, window.hann_coefficients(N, device="cpu"), fft.plan_constants(128, 128, device="cpu")
    )
    return jp, pp


@pytest.fixture(scope="module")
def planes():
    return np.random.default_rng(21).standard_normal((2, 2, N)).astype(np.float32)


def test_stage2_rows_cover_the_half_spectrum_once():
    """Stage 2's threads of a real column pair emit every row k2 in [0, 64]
    once, each with its partner 128 - k2 in the same thread."""
    rows = [r for t in range(8) for r in real_rows_of_thread(t)]
    assert sorted(k2 for k2, _, _ in rows) == list(range(65))
    assert all(k == k2 and kk == (128 - k2) % 128 for k2, k, kk in rows)
    assert [len(real_rows_of_thread(t)) for t in range(8)] == [9] + [8] * 7


@pytest.mark.parametrize("L", [8, 16])
def test_dft_dif_is_the_dft(plans, L):
    _, pp = plans
    tab = pp.kernel_constants[0].double().numpy()
    v = np.random.default_rng(L).standard_normal((L, 2)) @ np.array([1, 1j])
    got = np.array(dft_dif(list(v), tab[0] + 1j * tab[1]))
    # the table's float32 rounding, summed over L terms of size ~1
    np.testing.assert_allclose(got, np.fft.fft(v), rtol=0, atol=1e-6)


@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_model_matches_float64_fft(plans, planes, kind, apply_window):
    _, pp = plans
    xr, xi = planes
    w = pp.win.reshape(-1).numpy() if apply_window else np.float32(1)
    if kind == "real":
        got = model_real(xr, pp, apply_window)
        ref = np.abs(np.fft.fft((xr * w).astype(np.float64), axis=-1))
    else:
        got = model_complex(xr, xi, pp, apply_window)
        ref = np.abs(np.fft.fft((xr * w).astype(np.float64) + 1j * (xi * w).astype(np.float64)))
    assert snr_db(ref, got) >= FFT64_FLOOR_DB


@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_model_matches_jax_kernels(plans, planes, kind, apply_window):
    """The model against ``spectrum_from_state(bypass=True)`` and
    ``spectrum_mag_complex`` of ``tpu_sdr`` in interpret mode, F = 2."""
    jp, pp = plans
    xr, xi = planes
    kw = dict(interpret=True, precision="highest", apply_window=apply_window)
    if kind == "real":
        ref = jiir.spectrum_from_state(jnp.asarray(xr), jnp.zeros((2, 12)), jp, bypass=True, **kw)
        got = model_real(xr, pp, apply_window)
    else:
        ref = jiir.spectrum_mag_complex(jnp.asarray(xr), jnp.asarray(xi), jp, **kw)
        got = model_complex(xr, xi, pp, apply_window)
    assert snr_db(np.asarray(ref, np.float64), got) >= JAX_FLOOR_DB


def test_model_mirror_and_port_plain(plans, planes):
    """The real model's mirrored bins equal their partners, and the model
    agrees with the port's plain version (the dense four-step, the CPU path)."""
    _, pp = plans
    xr, _ = planes
    got = model_real(xr, pp, True).reshape(-1, 128, 128)
    assert np.array_equal(got[:, :, 65:], got[:, ::-1, 1:64][:, :, ::-1])
    plain = iir_fft.spectrum_bypass_plain(torch.as_tensor(xr), pp, True).numpy()
    assert snr_db(plain, got.reshape(-1, N)) >= JAX_FLOOR_DB
