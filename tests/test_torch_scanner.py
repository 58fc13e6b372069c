"""The port's spectrum scanner (``tpu_sdr_torch.runtime.scanner``) against
tpu_sdr's, on the CPU.

Tolerance: ``power_db`` within 0.01 dB (the DDC bank's fp32 baseband and
mean, XLA's reduction against ``ddc.fixed_sum``, agree to a few ulps;
0.01 dB is 2.3e-3 relative) and the occupancy flags equal.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.runtime import scanner as jscanner
from tpu_sdr_torch.runtime import scanner

torch.set_num_threads(1)

FS = 1_000_000.0
DB_ATOL = 0.01


def _tones(freqs_amps, t_len, noise=1e-4, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(t_len)
    x = noise * rng.standard_normal(t_len)
    for f, a in freqs_amps:
        x = x + a * np.cos(2 * np.pi * f * n / FS + rng.uniform(0, 2 * np.pi))
    return x.astype(np.float32)


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.centers_hz, jres.centers_hz)
    np.testing.assert_allclose(tres.power_db, jres.power_db, rtol=0, atol=DB_ATOL)
    np.testing.assert_array_equal(tres.occupied, jres.occupied)
    assert tres.noise_floor_db == pytest.approx(jres.noise_floor_db, abs=DB_ATOL)
    assert [h["center_hz"] for h in tres.hits] == [h["center_hz"] for h in jres.hits]


@pytest.mark.parametrize("k_per_dispatch", [16, 7])
def test_real_scan_matches_jax(k_per_dispatch):
    kw = dict(fs=FS, f_start=0.0, f_stop=500e3, channel_bw=25e3, threshold_db=10.0,
              k_per_dispatch=k_per_dispatch)
    x = _tones([(62.5e3, 0.5), (187.5e3, 0.2), (387.5e3, 0.05)], 65536)
    jres = jscanner.SpectrumScanner(**kw).scan(x)
    tsc = scanner.SpectrumScanner(device="cpu", **kw)
    assert tsc.decimation == 40 and tsc.n_channels == 20
    tres = tsc.scan(x)
    _compare(jres, tres)
    assert list(np.flatnonzero(tres.occupied)) == [2, 7, 15]


def test_iq_and_batched_scan_match_jax():
    rng = np.random.default_rng(3)
    t = 32768
    n = np.arange(t)
    z = (0.3 * np.exp(2j * np.pi * -137.5e3 * n / FS) + 0.05 * np.exp(2j * np.pi * 212.5e3 * n / FS)
         + 1e-3 * (rng.standard_normal(t) + 1j * rng.standard_normal(t)))
    planes = np.stack([z.real, z.imag]).astype(np.float32)
    kw = dict(fs=FS, f_start=-250e3, f_stop=250e3, channel_bw=25e3)
    _compare(jscanner.SpectrumScanner(**kw).scan_planes(planes),
             scanner.SpectrumScanner(device="cpu", **kw).scan_planes(planes))
    xb = np.stack([_tones([(112.5e3, 0.4)], t, seed=s) for s in range(3)])
    kw = dict(fs=FS, f_start=0.0, f_stop=300e3, channel_bw=25e3)
    _compare(jscanner.SpectrumScanner(**kw).scan(xb),
             scanner.SpectrumScanner(device="cpu", **kw).scan(xb))


def test_validation_and_mesh():
    # mesh= on a 1 x 1 mesh (no process group): the carrier-sharded bank's
    # path, bit for bit the single-device scan; a device beside it refused
    from tpu_sdr_torch.shard import make_sdr_mesh

    mesh = make_sdr_mesh(devices="cpu")
    x = _tones([(137.5e3, 0.4), (362.5e3, 0.02)], 65536)
    kw = dict(channel_bw=25e3, k_per_dispatch=8, taps_per_phase=8)
    one = scanner.SpectrumScanner(FS, 0.0, 500e3, device="cpu", **kw).scan(x)
    meshed = scanner.SpectrumScanner(FS, 0.0, 500e3, mesh=mesh, **kw).scan(x)
    np.testing.assert_array_equal(meshed.power, one.power)
    np.testing.assert_array_equal(meshed.occupied, one.occupied)
    with pytest.raises(ValueError, match="mesh's devices"):
        scanner.SpectrumScanner(mesh=mesh, device="cpu")
    with pytest.raises(ValueError):
        scanner.SpectrumScanner(FS, 100.0, 50.0, device="cpu")
    with pytest.raises(ValueError):
        scanner.SpectrumScanner(FS, 0.0, 10.0, channel_bw=25e3, device="cpu")
    sc = scanner.SpectrumScanner(device="cpu")
    with pytest.raises(ValueError):
        sc.scan(np.zeros(100, np.float32))
    with pytest.raises(ValueError):
        sc.scan(np.zeros(4096, np.complex64))
