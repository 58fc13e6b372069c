"""The state path of the composite IIR on the card (``csrc/iir_state.cu``)
through its plain PyTorch version, on the CPU.

On the card, at B = 128 blocks and m = 12 states, the composite filters
take every block's entry state as a triangular sum of products with the
powers P_d = (A^L)^d, the frame chain as a fixed-order 12-term step, and
each frame's end state from rest as a sum (``biquad.frame_ends``,
``entry_states``, ``state_path``). No CUDA kernel runs here: the plain
versions (``frame_ends_plain``, ``entry_states_plain``), which sum in the
kernel's order, are held against the GEMM form (``gemm_state_path``: the
block-Toeplitz W product, ``frame_chain`` and the APow product, the CPU's
route) and against float64 ``scipy.signal.sosfilt`` states, on the extremes
of the ``bank64`` benchmark configuration's design mix (Butterworth low-,
band- and high-passes, 20-450 kHz at 1 MSPS) and on two narrow low-passes,
whose poles near the unit circle cost a 128-step fp32 block recurrence
digits: ``iir_blocks.cuh``'s ``block_chain`` reached 6.1e-3 of max |state|
on butter(12, 0.002) (ROADMAP C9). The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``).

The composite filters through the state path (the plain version here) are
held against the JAX package's ``sosfilt_blocked_composite_bank`` and
``sosfilt_blocked_composite`` on the same NumPy inputs. JAX's outputs are
kept in ``tests/data/iir_state_jax.npz``, where the card's test of the
kernel path (which runs without JAX) reads them; a test here holds the file
to JAX's output of today. To write the file anew:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_iir_state.py
"""

import dataclasses
import hashlib
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from sdrbench import inputs, spec
from tpu_sdr.kernels import biquad as jbq
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch

torch.set_num_threads(1)

FS = 1e6
FRAMES = 64
L = 128  # samples a block
B = 128  # blocks a frame
M = 12


def _wn(hz):
    return np.asarray(hz) / (FS / 2)


DESIGNS = {
    # The corners of bank64's draws: cutoffs 20 and 450 kHz, bandpass centres
    # 60 and 420 kHz at widths 20 and 100 kHz.
    "bank64_mix": [
        sps.butter(12, _wn(20e3), output="sos"),
        sps.butter(12, _wn(450e3), output="sos"),
        sps.butter(6, _wn([50e3, 70e3]), btype="bandpass", output="sos"),
        sps.butter(6, _wn([370e3, 470e3]), btype="bandpass", output="sos"),
        sps.butter(12, _wn(20e3), btype="highpass", output="sos"),
        sps.butter(12, _wn(450e3), btype="highpass", output="sos"),
    ],
    "butter(12, 0.01)": [sps.butter(12, 0.01, output="sos")],
    "butter(12, 0.002)": [sps.butter(12, 0.002, output="sos")],
}
# The plain version against the GEMM form, of the largest |state| of the
# GEMM form: both fp32 sums of products with the same rounded powers, in
# other orders. Measured 2.0e-7, 2.2e-5 and 3.0e-4: on the narrow designs
# each form is about that far from float64 (below), so the bound is their
# distances from float64 with room.
REL_VS_GEMM = {"bank64_mix": 1e-6, "butter(12, 0.01)": 1e-4, "butter(12, 0.002)": 2e-3}
# Against float64 sosfilt states, of the channel's largest |state|: the fp32
# forcing (the P product) and the powers rounded once bound both forms;
# measured 8.5e-7, 2.4e-5, 2.5e-4 (the GEMM form 8.0e-7, 1.3e-5, 2.3e-4).
# On butter(12, 0.002) the bound is a sixth of block_chain's 6.1e-3.
REL_VS_FLOAT64 = {"bank64_mix": 5e-6, "butter(12, 0.01)": 1e-4, "butter(12, 0.002)": 1e-3}


def _bank(designs):
    return biquad.precompute_composite_bank(
        np.stack([biquad.pad_sos(s, 6) for s in designs]), device="cpu"
    )


def _input(channels: int, frames: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((channels, frames * B * L)).astype(np.float32)


def _sosfilt_states(sos: np.ndarray, x: np.ndarray, frames: int) -> np.ndarray:
    """float64 scipy states entering every block, and after the last:
    (frames * B + 1, 12), each the stacked (S, 2) zi of a section cascade."""
    z = np.zeros((sos.shape[0], 2))
    out = np.zeros((frames * B + 1, M))
    for g in range(frames * B):
        _, z = sps.sosfilt(sos, x[g * L : (g + 1) * L], zi=z)
        out[g + 1] = z.reshape(M)
    return out


@pytest.fixture(scope="module", params=list(DESIGNS))
def design_run(request):
    """One design set at 64 frames from rest: the forcing, the plain
    version's states, the GEMM form's and float64 sosfilt's."""
    designs = DESIGNS[request.param]
    op = _bank(designs)
    C = len(designs)
    x = _input(C, FRAMES, seed=3)
    v = torch.as_tensor(x).reshape(C, FRAMES, B, L)
    z0 = torch.zeros((C, M))
    frames = biquad.bank_frames(C)
    _, f = biquad._composite_products(op, v, frames)
    w = biquad.frame_ends_plain(op, f)
    z_in, zf = biquad.entry_states_plain(op, f, z0, w)
    gz_in, gzf = biquad.gemm_state_path(op, f, z0, frames)
    ref = [_sosfilt_states(biquad.pad_sos(s, 6), x[c].astype(np.float64), FRAMES)
           for c, s in enumerate(designs)]
    return request.param, (z_in, zf), (gz_in, gzf), ref


def _per_channel_err(states, ref) -> np.ndarray:
    z_in, zf = (s.double().numpy() for s in states)
    err = []
    for c, r in enumerate(ref):
        gap = max(np.abs(z_in[c] - r[:-1].reshape(FRAMES, B, M)).max(), np.abs(zf[c] - r[-1]).max())
        err.append(gap / np.abs(r).max())
    return np.array(err)


def test_state_path_plain_matches_the_gemm_form(design_run):
    name, (z_in, zf), (gz_in, gzf), _ = design_run
    assert z_in.shape == gz_in.shape == (len(DESIGNS[name]), FRAMES, B, M)
    scale = gz_in.abs().amax(dim=(1, 2, 3))
    gap = torch.maximum((z_in - gz_in).abs().amax(dim=(1, 2, 3)), (zf - gzf).abs().amax(dim=1))
    assert (gap <= REL_VS_GEMM[name] * scale).all(), (name, (gap / scale).tolist())


def test_state_path_plain_against_float64_sosfilt_states(design_run):
    name, plain, gemm, ref = design_run
    err = _per_channel_err(plain, ref)
    assert err.max() <= REL_VS_FLOAT64[name], (name, err, _per_channel_err(gemm, ref))


@pytest.fixture(scope="module")
def mix_forcing():
    designs = DESIGNS["bank64_mix"]
    op = _bank(designs)
    C = len(designs)
    v = torch.as_tensor(_input(C, 24, seed=5)).reshape(C, 24, B, L)
    _, f = biquad._composite_products(op, v, biquad.bank_frames(C))
    z0 = torch.as_tensor(np.random.default_rng(6).standard_normal((C, M)).astype(np.float32))
    w = biquad.frame_ends_plain(op, f)
    return op, f, z0, w, biquad.entry_states_plain(op, f, z0, w)


@pytest.mark.parametrize("sizes", [(24,), (5, 19), (1, 7, 16), (8, 8, 8)], ids=str)
def test_plain_state_path_chunked_equals_one_shot(mix_forcing, sizes):
    """Each frame's sums depend on that frame and its entry state alone:
    chunks with the state carried give the one-shot bits."""
    op, f, z0, w, (z_in, zf) = mix_forcing
    z, parts, ends = z0, [], []
    for chunk in f.split(list(sizes), dim=1):
        wc = biquad.frame_ends_plain(op, chunk)
        zc, z = biquad.entry_states_plain(op, chunk, z, wc)
        parts.append(zc)
        ends.append(wc)
    assert torch.equal(torch.cat(ends, dim=1), w)
    assert torch.equal(torch.cat(parts, dim=1), z_in) and torch.equal(z, zf)


@pytest.mark.parametrize("lo,frames", [(0, 6), (6, 6), (18, 6), (9, 15)])
def test_plain_entry_states_of_a_frame_run_equal_the_one_shot(mix_forcing, lo, frames):
    """A time shard: its frames lo .. lo + F - 1 of the gathered end states,
    the chain walked from the stream's head: the one-shot's frames and the
    one-shot's final state, bit for bit."""
    op, f, z0, w, (z_in, zf) = mix_forcing
    run = f[:, lo : lo + frames]
    assert torch.equal(biquad.frame_ends_plain(op, run), w[:, lo : lo + frames])
    got, z = biquad.entry_states_plain(op, run, z0, w, lo)
    assert torch.equal(got, z_in[:, lo : lo + frames]) and torch.equal(z, zf)


def test_shared_design_is_a_bank_of_copies_bitwise():
    """A shared design's rows all take its one set of powers (the kernel's
    stride 0): the bits of a bank holding that design in every channel."""
    sos = sps.butter(12, 0.25, output="sos")
    shared = biquad.precompute_composite(sos, device="cpu")
    bank = _bank([sos] * 3)
    f = torch.as_tensor(np.random.default_rng(7).standard_normal((3, 5, B, M)).astype(np.float32))
    z0 = torch.as_tensor(np.random.default_rng(8).standard_normal((3, M)).astype(np.float32))
    w = biquad.frame_ends_plain(shared, f)
    assert torch.equal(w, biquad.frame_ends_plain(bank, f))
    got = biquad.entry_states_plain(shared, f, z0, w)
    want = biquad.entry_states_plain(bank, f, z0, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # Rows channel-major with a lead axis: (C, 2, F, B, m) over 3 channels.
    f2 = torch.stack([f, f.flip(0)], dim=1)
    w2 = biquad.frame_ends_plain(bank, f2)
    assert torch.equal(w2[:, 0], w) and torch.equal(w2[:, 1], w.flip(0))


def test_state_functions_take_the_plain_version_on_the_cpu():
    """On a CPU tensor ``state_path`` runs the plain versions (two plain
    calls, no launch), and the composite filters keep the GEMM form."""
    op = _bank(DESIGNS["bank64_mix"][:2])
    f = torch.as_tensor(np.random.default_rng(9).standard_normal((2, 3, B, M)).astype(np.float32))
    launch.reset_counts()
    z_in, zf = biquad.state_path(op, f, torch.zeros((2, M)))
    assert z_in.shape == f.shape and zf.shape == (2, M)
    assert launch.counts["plain"]["iir_state"] == 2 and launch.counts["kernel"]["iir_state"] == 0
    x = torch.as_tensor(_input(2, 1, seed=10))
    assert not biquad.takes_state_kernel(op)
    biquad.sosfilt_blocked_composite_bank(op, x, torch.zeros((2, 6, 2)))
    assert launch.counts["plain"]["iir_state"] == 2


@pytest.mark.parametrize("blocks,sections", [(128, 6), (64, 6), (128, 4)],
                         ids=["B128-m12", "B64-m12", "B128-m8"])
@pytest.mark.parametrize("kind", ["shared", "bank"])
def test_w_is_built_exactly_where_the_gemm_form_reads_it(monkeypatch, kind, blocks, sections):
    """``takes_state_kernel`` reads the operator alone: true on the card at
    B = 128, m = 12, false on the CPU and at any other geometry. Those
    operators hold W (``block_toeplitz``'s placement) and the state step
    takes the GEMM form there (no state-path call); where the predicate
    holds, the build leaves W out and the state step runs ``state_path``."""
    designs = [sps.butter(2 * sections, 0.1 * (c + 1), output="sos") for c in range(2)]
    m = 2 * sections
    on_geometry = blocks == biquad.STATE_BLOCKS and m == biquad.STATE_DIM

    def build():
        if kind == "bank":
            return biquad.precompute_composite_bank(np.stack(designs), L, blocks, device="cpu")
        return biquad.precompute_composite(designs[0], L, blocks, device="cpu")

    op = build()
    lead = (2,) if kind == "bank" else ()
    assert op.W is not None and op.W.shape == (*lead, blocks * m, blocks * m)
    assert torch.equal(op.W, biquad.block_toeplitz(op))
    assert not biquad.takes_state_kernel(op)
    card = dataclasses.replace(op, APow=types.SimpleNamespace(is_cuda=True, shape=op.APow.shape))
    assert biquad.takes_state_kernel(card) == on_geometry
    x = torch.as_tensor(_input(2, 1, seed=12)[:, : blocks * L])
    zi = torch.zeros((2, sections, 2))
    run = biquad.sosfilt_blocked_composite_bank
    launch.reset_counts()
    y, zf = run(op, x, zi)
    assert launch.counts["plain"]["iir_state"] == 0 and y.shape == x.shape
    # The card's rule on CPU tensors: W is left out where the state kernel runs.
    monkeypatch.setattr(biquad, "takes_state_kernel",
                        lambda op: (op.frame_blocks, op.state_dim) == (B, M))
    op = build()
    assert (op.W is None) == on_geometry
    launch.reset_counts()
    y2, zf2 = run(op, x, zi)
    assert launch.counts["plain"]["iir_state"] == (2 if on_geometry else 0)
    if not on_geometry:
        assert torch.equal(y2, y) and torch.equal(zf2, zf)


def test_state_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    op = _bank(DESIGNS["bank64_mix"][:2])
    good = torch.zeros((2, 3, B, M))
    with pytest.raises(ValueError, match="f must be"):
        biquad._state_check(op, torch.zeros((2, 3, 64, M)))
    with pytest.raises(ValueError, match="f must be"):
        biquad._state_check(op, good.double())
    with pytest.raises(ValueError, match="bank of 2"):
        biquad._state_check(op, torch.zeros((3, 3, B, M)))
    assert biquad._state_check(op, good) == (2, op.APow.stride(0), 1)
    assert biquad._state_check(op, torch.zeros((2, 4, 3, B, M)))[1:] == (op.APow.stride(0), 4)
    shared = biquad.precompute_composite(sps.butter(12, 0.25, output="sos"), device="cpu")
    assert biquad._state_check(shared, torch.zeros((5, 3, B, M))) == (5, 0, 5)
    with pytest.raises(ValueError, match="within 2"):
        biquad.entry_states_cuda(op, good, torch.zeros((2, M)), torch.zeros((2, 2, M)), 0)


# ------------------------------------------------- against the JAX package

JAX_REFERENCE = Path(__file__).with_name("data") / "iir_state_jax.npz"
# The bank: the first 6 designs of a bank64 draw, the benchmark's own (seed
# 64): two each of high-, low- and band-pass. The shared design: butter(12,
# 0.25) over 2 rows. Each 2 frames from a random state: (rows, input seed).
JAX_CASES = {"bank": (6, 64), "shared": (2, 66)}
# Of each row's own largest |y| and |zf|. The plain state path read 5.0e-8
# and 1.8e-7 (the GEMM form the same); on the card the kernel's states lie
# within 1.1e-7 of the plain version's (chip_smoke.py's [3]).
JAX_Y_REL, JAX_ZF_REL = 1e-6, 2e-6


def jax_case_inputs(case: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sos, x (rows, 2 * N), zi (rows, 6, 2)) of a case, float32 x and zi;
    sos (rows, 6, 6) for the bank, (6, 6) for the shared design."""
    rows, seed = JAX_CASES[case]
    if case == "bank":
        sos = inputs.make_designs(spec.find_cell(spec.load_benchmark(), "bank64.custom.sat").config,
                                  64)[:rows]
    else:
        sos = sps.butter(12, 0.25, output="sos")
    x = np.random.default_rng(seed).standard_normal((rows, 2 * B * L), dtype=np.float32)
    zi = (0.1 * np.random.default_rng(seed + 1).standard_normal((rows, 6, 2))).astype(np.float32)
    return sos, x, zi


def jax_outputs(case: str, sos, x, zi) -> tuple[np.ndarray, np.ndarray]:
    if case == "bank":
        y, zf = jbq.sosfilt_blocked_composite_bank(
            jbq.precompute_composite_bank(sos), jnp.asarray(x), jnp.asarray(zi), precision="highest")
    else:
        y, zf = jbq.sosfilt_blocked_composite(
            jbq.precompute_composite(sos), jnp.asarray(x), jnp.asarray(zi), precision="highest")
    return np.asarray(y), np.asarray(zf)


def write_jax_reference(path: Path = JAX_REFERENCE) -> None:
    """Each case's sos, zi, JAX's y and zf, and the input's seed, shape and
    SHA-256 (the input is drawn again where the file is read)."""
    out = {}
    for case, (rows, seed) in JAX_CASES.items():
        sos, x, zi = jax_case_inputs(case)
        y, zf = jax_outputs(case, sos, x, zi)
        out.update({f"{case}_sos": sos, f"{case}_zi": zi, f"{case}_y": y, f"{case}_zf": zf,
                    f"{case}_x_seed": seed, f"{case}_x_shape": np.array(x.shape),
                    f"{case}_x_sha256": hashlib.sha256(x.tobytes()).hexdigest()})
    path.parent.mkdir(exist_ok=True)
    np.savez_compressed(path, **out)


def _rel_gaps(y, zf, ref_y, ref_zf) -> tuple[float, float]:
    """The largest gap of y and zf over each row's own largest |y|, |zf|."""
    rows = ref_y.shape[0]
    gy = np.abs(y - ref_y).reshape(rows, -1).max(-1) / np.abs(ref_y).reshape(rows, -1).max(-1)
    gz = np.abs(zf - ref_zf).reshape(rows, -1).max(-1) / np.abs(ref_zf).reshape(rows, -1).max(-1)
    return float(gy.max()), float(gz.max())


def _composite(case: str, sos):
    if case == "bank":
        return biquad.precompute_composite_bank(sos, device="cpu"), biquad.sosfilt_blocked_composite_bank
    return biquad.precompute_composite(sos, device="cpu"), biquad.sosfilt_blocked_composite


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_state_path_matches_jax(monkeypatch, case):
    """The composite filter as it runs on the card (the forcing, state and
    emit kernels' route, here with the plain ``block_forcing``,
    ``state_path`` and ``block_outputs``) against JAX on the same inputs."""
    sos, x, zi = jax_case_inputs(case)
    ref_y, ref_zf = jax_outputs(case, sos, x, zi)
    op, run = _composite(case, sos)
    monkeypatch.setattr(biquad, "takes_state_kernel", lambda op: True)
    launch.reset_counts()
    y, zf = run(op, torch.as_tensor(x), torch.as_tensor(zi))
    assert launch.counts["plain"]["iir_state"] == 2 and launch.counts["kernel"]["iir_state"] == 0
    assert launch.counts["plain"]["iir_emit"] == 1 and launch.counts["kernel"]["iir_emit"] == 0
    assert launch.counts["plain"]["iir_force"] == 1 and launch.counts["kernel"]["iir_force"] == 0
    assert y.shape == ref_y.shape and zf.shape == ref_zf.shape
    gy, gz = _rel_gaps(y.numpy(), zf.numpy(), ref_y, ref_zf)
    assert gy <= JAX_Y_REL and gz <= JAX_ZF_REL, (case, gy, gz)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_stored_jax_reference_is_jaxs_output(case):
    """The file the card's test reads holds today's inputs and JAX's output
    on them. XLA on another CPU may sum in another order, so the outputs are
    held within a tenth of the port's bounds, not bit for bit."""
    sos, x, zi = jax_case_inputs(case)
    with np.load(JAX_REFERENCE) as ref:
        assert np.array_equal(ref[f"{case}_sos"], sos) and np.array_equal(ref[f"{case}_zi"], zi)
        assert tuple(ref[f"{case}_x_shape"]) == x.shape
        assert str(ref[f"{case}_x_sha256"]) == hashlib.sha256(x.tobytes()).hexdigest()
        y, zf = jax_outputs(case, sos, x, zi)
        gy, gz = _rel_gaps(ref[f"{case}_y"], ref[f"{case}_zf"], y, zf)
    assert gy <= JAX_Y_REL / 10 and gz <= JAX_ZF_REL / 10, (case, gy, gz)


if __name__ == "__main__":
    write_jax_reference()
    print(f"wrote {JAX_REFERENCE}")
