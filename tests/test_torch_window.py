"""The port's Q15 window path against the JAX package and the golden model:
the RTL's Hann ROM and its Q15 multiply, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.control import golden as jgolden
from tpu_sdr.kernels import window as jwindow
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.core import qformat
from tpu_sdr_torch.kernels import window


@pytest.mark.parametrize("n", [16384, 8192, 1000])
def test_hann_q16_rom_bitwise(n):
    ours = window.hann_q16_rom(n, device="cpu")
    assert ours.dtype == torch.int16
    assert np.array_equal(ours.numpy(), np.asarray(jwindow.hann_q16_rom(n)))
    assert np.array_equal(golden.hann_q16_rom(n), jgolden.hann_q16_rom(n))


def _q15_samples(n: int, seed: int) -> np.ndarray:
    """Random int16 samples with the extremes (-32768 against the ROM's
    -32768 wraps to int16) at the ends."""
    x = np.random.default_rng(seed).integers(-32768, 32768, n).astype(np.int16)
    x[:2] = (-32768, 32767)
    x[-2:] = (-32768, 32767)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_window_q15_bitwise_against_jax_and_golden(seed):
    n = 16384
    x = _q15_samples(2 * n, seed).reshape(2, n)
    rom = golden.hann_q16_rom(n)
    got = window.window_q15(torch.as_tensor(x), torch.as_tensor(rom))
    assert got.dtype == torch.int16
    ref = np.asarray(jwindow.window_q15(jnp.asarray(x), jnp.asarray(rom)))
    assert np.array_equal(got.numpy(), ref)
    for row in range(2):
        assert np.array_equal(got.numpy()[row], golden.rtl_window_q15(x[row]))


@pytest.mark.parametrize("phase,misaligned", [(0, True), (5000, False), (16383, True)])
def test_rtl_window_q15_phase_and_misalignment_match_jax_golden(phase, misaligned):
    x = _q15_samples(3000, 2)
    ours = golden.rtl_window_q15(x, phase=phase, misaligned=misaligned)
    ref = jgolden.rtl_window_q15(x, phase=phase, misaligned=misaligned)
    assert np.array_equal(ours, ref)


def test_window_q15_wraps_like_the_rtl():
    """-32768 x -32768 -> 2^30: (p >> 15) + bit 14 = 32768, which wraps to
    -32768 as the RTL's 16-bit slice does."""
    got = window.window_q15(torch.tensor([-32768], dtype=torch.int16),
                            torch.tensor([-32768], dtype=torch.int16))
    assert got.item() == -32768
    assert qformat.window_multiply_q15(np.int16(-32768), np.int16(-32768)) == -32768


def test_apply_window_is_the_product():
    x = torch.randn(3, 64)
    w = torch.rand(64)
    assert torch.equal(window.apply_window(x, w), x * w)
