"""A NumPy model of K2's wavefront (``tpu_sdr_torch/csrc/sosfilt_q15.cu``),
the saturating Q15 cascade with one section a lane.

No CUDA kernel runs here, so this file is the readable spec of the
kernel's index maps: rows packed 32 / G a warp (G lanes a row, the section
count rounded up to a power of two), lane s of a row's group owning
section s, lane s at step j filtering sample j - D * s (D, the hand-over
delay: the kernel's is its chunk, ``kChunk``, ``biquad.Q15_SECTION_DELAY``),
lane 0 reading the windowed
sample, lane s > 0 the output lane s - 1 made D steps before, a lane off
its row's samples (below 0, at T or above) keeping its state, the state
carried as (R = b1 v[n-1] + z1[n-1], z1[n], y[n-1]) with z0 = R - a1 y, zi
entering as R = z0, y = 0, and the last lane's outputs making the row. The
model runs in int32 as the kernel does and is held bit for bit against
``tpu_sdr.kernels.biquad.sosfilt_q15_scan`` (JAX on the CPU, after the JAX
package's RTL window) and the port's ``sosfilt_q15_plain``. Nothing on any
path calls it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import biquad as jbiquad
from tpu_sdr.kernels import window as jwindow
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.kernels import biquad

torch.set_num_threads(1)

KERNEL_DELAY = biquad.Q15_SECTION_DELAY  # csrc/sosfilt_q15.cu kChunk
ROM_N = 8  # a short window ROM (it must divide T)


def group_width(sections: int) -> int:
    """Lanes a row: the section count rounded up to a power of two."""
    return 1 << (sections - 1).bit_length()


def window_np(x: np.ndarray, rom: np.ndarray) -> np.ndarray:
    """The RTL window, as the kernel applies it on the tile's load."""
    p = x.astype(np.int32) * np.resize(rom, x.shape[-1]).astype(np.int32)
    return ((p >> 15) + ((p >> 14) & 1)).astype(np.int16)


def wavefront(sos, x, zi, rom=None, delay: int = KERNEL_DELAY):
    """The kernel's schedule: returns (y (rows, T) int16, windowed or None,
    zf (rows, S, 2) int32, rails (S,) bool: each section's output reached
    -32768 or 32767 on some sample)."""
    sos = np.asarray(sos, np.int32)
    rows, t = x.shape
    S = sos.shape[0]
    G = group_width(S)
    R = 32 // G
    warps = -(-rows // R)
    xw = None if rom is None else window_np(x, rom)
    xin = (x if xw is None else xw).astype(np.int32)
    # lane l of warp w: row w * R + l // G, section l % G
    lane = np.arange(32)
    sec = np.broadcast_to(lane % G, (warps, 32))
    row = np.arange(warps)[:, None] * R + lane // G
    live = (row < rows) & (sec < S)
    coef = np.zeros((5, warps, 32), np.int32)
    for k, col in enumerate((0, 1, 2, 4, 5)):
        coef[k] = np.where(sec < S, sos[np.minimum(sec, S - 1), col], 0)
    b0, b1, b2, a1, a2 = coef
    rr = np.zeros((warps, 32), np.int32)
    z1 = np.zeros((warps, 32), np.int32)
    yp = np.zeros((warps, 32), np.int32)
    rc, sc = np.nonzero(live)
    rr[rc, sc] = zi[row[rc, sc], sec[rc, sc], 0]
    z1[rc, sc] = zi[row[rc, sc], sec[rc, sc], 1]
    out = np.zeros((rows, t), np.int16)
    rails = np.zeros(S, bool)
    hist = np.zeros((delay, warps, 32), np.int32)  # each lane's y, the last `delay` steps
    row_c = np.minimum(row, rows - 1)
    for j in range(t + delay * (S - 1)):
        older = hist[j % delay]  # the outputs of step j - delay
        v = np.where(sec == 0, xin[row_c, min(j, t - 1)], np.roll(older, 1, axis=1))
        q = b0 * v + rr
        acc = q - a1 * yp
        y = np.clip((acc + 32 + (acc >> 31)) >> 6, -32768, 32767).astype(np.int32)
        i = j - delay * sec
        on = (i >= 0) & (i < t)
        rr = np.where(on, b1 * v + z1, rr)
        z1 = np.where(on, b2 * v - a2 * y, z1)
        yp = np.where(on, y, yp)
        hist[j % delay] = y
        hit = on & live & ((y == 32767) | (y == -32768))
        rails[np.unique(sec[hit])] = True
        last = (sec == S - 1) & live & on
        out[row[last], i[last]] = y[last]
    zf = np.zeros((rows, S, 2), np.int32)
    zf[row[rc, sc], sec[rc, sc], 0] = (rr - a1 * yp)[rc, sc]
    zf[row[rc, sc], sec[rc, sc], 1] = z1[rc, sc]
    return out, xw, zf, rails


def q15_sos(sections: int, rng, loud: bool) -> np.ndarray:
    """int8 x64 sections (a0 = 64); ``loud``: gains that drive every
    section to the rails on full-scale input."""
    sos = np.zeros((sections, 6), np.int64)
    sos[:, 3] = 64
    if loud:
        sos[:, 0] = rng.integers(100, 128, sections)
        sos[:, 1] = rng.integers(-128, 128, sections)
        sos[:, 2] = rng.integers(-128, 128, sections)
        sos[:, 4] = rng.integers(-40, 40, sections)
        sos[:, 5] = rng.integers(0, 30, sections)
    else:
        base = np.array([[18, 36, 18, 64, -38, 14], [64, -120, 64, 64, -110, 52],
                         [1, 2, 1, 64, -73, 21], [64, 128, 64, 64, -84, 33]], np.int64)
        sos[:] = base[np.arange(sections) % 4]
    return sos


def inputs(rows: int, t: int, sections: int, seed: int, loud: bool):
    rng = np.random.default_rng(seed)
    scale = 32767 if loud else 6000
    x = np.clip(np.round(rng.standard_normal((rows, t)) * scale), -32768, 32767).astype(np.int16)
    zi = rng.integers(-200_000, 200_000, (rows, sections, 2)).astype(np.int32)
    return q15_sos(sections, rng, loud), x, zi


def jax_reference(sos, x, zi, rom=None):
    xj = jnp.asarray(x)
    if rom is not None:
        xj = jwindow.window_q15(xj.reshape(x.shape[0], -1, rom.shape[0]),
                                jnp.asarray(rom)).reshape(x.shape)
    y, zf = jbiquad.sosfilt_q15_scan(jnp.asarray(sos), xj, jnp.asarray(zi))
    return np.asarray(y), np.asarray(zf)


def plain(sos, x, zi, rom=None):
    y, xw, zf = biquad.sosfilt_q15_plain(
        torch.as_tensor(sos, dtype=torch.int32), torch.as_tensor(x), torch.as_tensor(zi),
        rom=None if rom is None else torch.as_tensor(rom))
    return y.numpy(), None if xw is None else xw.numpy(), zf.numpy()


@pytest.mark.parametrize("sections", range(1, 9))
@pytest.mark.parametrize("t", [8, 2 * 16384], ids=["T8", "T32768"])
@pytest.mark.parametrize("part_full", [False, True], ids=["1row", "partwarp"])
def test_wavefront_equals_jax_scan_and_plain(sections, t, part_full):
    """The model, bit for bit, against the JAX scan and the plain version,
    on 1 row and on a row count that leaves the last packed warp part-full;
    the window on for the part-full case."""
    rows = 32 // group_width(sections) + 1 if part_full else 1
    sos, x, zi = inputs(rows, t, sections, 100 * sections + rows, loud=False)
    rom = golden.hann_q16_rom(ROM_N) if part_full else None
    y, xw, zf, _ = wavefront(sos, x, zi, rom)
    jy, jzf = jax_reference(sos, x, zi, rom)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(zf, jzf)
    py, pxw, pzf = plain(sos, x, zi, rom)
    np.testing.assert_array_equal(y, py)
    np.testing.assert_array_equal(zf, pzf)
    if rom is not None:
        np.testing.assert_array_equal(xw, pxw)


@pytest.mark.parametrize("sections", range(1, 9))
def test_wavefront_at_the_rails(sections):
    """Full-scale input through loud sections: every section saturates, and
    the model still equals the JAX scan bit for bit."""
    sos, x, zi = inputs(5, 512, sections, 7 + sections, loud=True)
    y, _, zf, rails = wavefront(sos, x, zi)
    assert rails.all(), rails
    jy, jzf = jax_reference(sos, x, zi)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(zf, jzf)


@pytest.mark.parametrize("delay", [1, 3, KERNEL_DELAY])
@pytest.mark.parametrize("sections", [1, 6, 8])
def test_wavefront_delay_does_not_change_the_bits(delay, sections):
    """Any hand-over delay gives the same bits: lane s's input is lane s-1's
    output of the same sample, whenever it was made (a shuffle a step
    later: 1, or 3; the kernel's chunk)."""
    sos, x, zi = inputs(6, 200, sections, 40 + sections, loud=True)
    ref = wavefront(sos, x, zi, delay=KERNEL_DELAY)
    got = wavefront(sos, x, zi, delay=delay)
    for a, b in zip(got[:3:2], ref[:3:2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sections", [2, 6, 8])
def test_wavefront_two_chunks_equal_one_shot(sections):
    """The state carried through zf: two calls of 16384 samples equal one
    call of 32768, windowed and filtered."""
    sos, x, zi = inputs(5, 2 * 16384, sections, 60 + sections, loud=False)
    rom = golden.hann_q16_rom(ROM_N)
    y, xw, zf, _ = wavefront(sos, x, zi, rom)
    y1, xw1, z1, _ = wavefront(sos, x[:, :16384], zi, rom)
    y2, xw2, z2, _ = wavefront(sos, x[:, 16384:], z1, rom)
    np.testing.assert_array_equal(np.concatenate([y1, y2], axis=1), y)
    np.testing.assert_array_equal(np.concatenate([xw1, xw2], axis=1), xw)
    np.testing.assert_array_equal(z2, zf)


def test_wavefront_state_matches_the_oracle():
    """zf against golden.sosfilt_q15_intended (int64) row by row."""
    sos, x, zi = inputs(3, 1000, 6, 5, loud=True)
    y, _, zf, _ = wavefront(sos, x, zi)
    for r in range(3):
        gy, gz = golden.sosfilt_q15_intended(sos, x[r], zi[r])
        np.testing.assert_array_equal(y[r], gy)
        np.testing.assert_array_equal(zf[r].astype(np.int64), gz)


def test_kernel_delay_is_the_sources_chunk():
    """biquad.Q15_SECTION_DELAY, the delay this model and the CPU read, is
    the kernel's kChunk (which its library returns on the card)."""
    src = Path(biquad.__file__).resolve().parent.parent / "csrc" / "sosfilt_q15.cu"
    m = re.search(r"constexpr int kChunk = (\d+);", src.read_text())
    assert m is not None and int(m.group(1)) == KERNEL_DELAY
    assert "return kChunk;" in src.read_text()
