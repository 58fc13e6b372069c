"""The output step of the composite IIR on the card (``csrc/iir_emit.cu``)
through its plain PyTorch version, on the CPU.

Where the state kernel runs and blocks hold 128 samples
(``biquad.takes_emit_kernel``), every block's output y = v T^T + z_in M^T
is one kernel's work (``block_outputs``): the z term first, j ascending,
then the Toeplitz triangle, k ascending. No CUDA kernel runs here: the
plain version (``block_outputs_plain``), which sums in the kernel's order,
is held against the GEMM form (``y_zs + z_in M^T``, the CPU's route) and
float64 on the extremes of the ``bank64`` benchmark configuration's design
mix, on two narrow low-passes and on a shared design; chunked against
one-shot; the route against the operator; and the wrapper against what the
kernel does not take. The kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import types

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch

torch.set_num_threads(1)

FS = 1e6
L = 128  # samples a block
B = 128  # blocks a frame
M = 12


def _wn(hz):
    return np.asarray(hz) / (FS / 2)


DESIGNS = {
    # The corners of bank64's draws (as in tests/test_torch_iir_state.py).
    "bank64_mix": [
        sps.butter(12, _wn(20e3), output="sos"),
        sps.butter(12, _wn(450e3), output="sos"),
        sps.butter(6, _wn([50e3, 70e3]), btype="bandpass", output="sos"),
        sps.butter(6, _wn([370e3, 470e3]), btype="bandpass", output="sos"),
        sps.butter(12, _wn(20e3), btype="highpass", output="sos"),
        sps.butter(12, _wn(450e3), btype="highpass", output="sos"),
    ],
    "narrow": [sps.butter(12, 0.01, output="sos"), sps.butter(12, 0.002, output="sos")],
    "shared": sps.butter(12, 0.25, output="sos"),
}
# Of each channel's largest |y|: the plain version against the GEMM form and
# against float64, both fp32 sums of the same rounded products in other
# orders. Measured at most 5.0e-7 and 4.5e-7 (bank64_mix, 3 seeds; the
# narrow designs 1.0e-7 and 1.6e-7, the shared one 2.0e-7 against the GEMM
# form).
REL_VS_GEMM = 2e-6
REL_VS_FLOAT64 = 2e-6


def _op(name: str):
    designs = DESIGNS[name]
    if name == "shared":
        return biquad.precompute_composite(designs, device="cpu")
    return biquad.precompute_composite_bank(
        np.stack([biquad.pad_sos(s, 6) for s in designs]), device="cpu")


def _rows(op) -> int:
    return op.T.shape[0] if op.T.ndim == 3 else 3


def _inputs(op, frames: int, seed: int):
    """A blocked input and entry states of every block, the states at a
    scale drawn from 0.1 to 100."""
    rng = np.random.default_rng(seed)
    rows = _rows(op)
    v = rng.standard_normal((rows, frames, B, L)).astype(np.float32)
    z = (rng.standard_normal((rows, frames, B, M)) * 10 ** rng.uniform(-1, 2)).astype(np.float32)
    return torch.as_tensor(v), torch.as_tensor(z)


def _gemm_form(op, v, z):
    calls = v.shape[-3] * B
    return biquad._canonical_matmul(v, op.T.mT, calls) + biquad._canonical_matmul(z, op.M.mT, calls)


def _per_row(got, ref) -> np.ndarray:
    rows = got.shape[0]
    gap = (got.double() - ref.double()).abs().reshape(rows, -1).amax(-1)
    return (gap / ref.double().abs().reshape(rows, -1).amax(-1)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DESIGNS))
def test_plain_emit_matches_the_gemm_form_and_float64(name, seed):
    op = _op(name)
    v, z = _inputs(op, 3, seed)
    y = biquad.block_outputs_plain(op, v, z)
    assert y.shape == v.shape and y.dtype == torch.float32
    gemm = _gemm_form(op, v, z)
    h, Mm = (op.T, op.M) if op.T.ndim == 3 else (op.T[None], op.M[None])
    exact = v.double() @ h.double().mT[:, None] + z.double() @ Mm.double().mT[:, None]
    err, err64 = _per_row(y, gemm), _per_row(y, exact)
    assert err.max() <= REL_VS_GEMM and err64.max() <= REL_VS_FLOAT64, (name, err, err64)


def test_plain_emit_sums_in_the_kernels_order():
    """One block by hand: 0, then M[n, j] z[j] for j ascending, then
    h[n - k] v[k] for k = 0 .. n, each product rounded, then added."""
    op = _op("bank64_mix")
    v, z = _inputs(op, 1, 4)
    y = biquad.block_outputs_plain(op, v, z)
    c, blk = 4, 77
    h, Mc = op.T[c, :, 0], op.M[c]
    vb, zb = v[c, 0, blk], z[c, 0, blk]
    for n in (0, 1, 63, 127):
        acc = torch.zeros((), dtype=torch.float32)
        for j in range(M):
            acc = acc + Mc[n, j] * zb[j]
        for k in range(n + 1):
            acc = acc + h[n - k] * vb[k]
        assert torch.equal(acc, y[c, 0, blk, n]), n


@pytest.mark.parametrize("sizes", [(6,), (1, 5), (2, 1, 3), (3, 3)], ids=str)
def test_plain_emit_chunked_equals_one_shot(sizes):
    """Each block's outputs depend on that block's input and entry state
    alone: any split of the frames gives the one-shot bits."""
    op = _op("bank64_mix")
    v, z = _inputs(op, 6, 5)
    y = biquad.block_outputs_plain(op, v, z)
    parts = [biquad.block_outputs_plain(op, vc, zc)
             for vc, zc in zip(v.split(list(sizes), dim=1), z.split(list(sizes), dim=1))]
    assert torch.equal(torch.cat(parts, dim=1), y)


def test_shared_design_is_a_bank_of_copies_bitwise():
    """A shared design's rows all take its one T and M (the kernel's stride
    0): the bits of a bank holding that design in every channel, also with
    a lead axis inside the channel-major rows."""
    shared = _op("shared")
    bank = biquad.precompute_composite_bank(np.stack([DESIGNS["shared"]] * 3), device="cpu")
    v, z = _inputs(shared, 2, 6)
    want = biquad.block_outputs_plain(bank, v, z)
    assert torch.equal(biquad.block_outputs_plain(shared, v, z), want)
    v2, z2 = torch.stack([v, v.flip(0)], dim=1), torch.stack([z, z.flip(0)], dim=1)
    y2 = biquad.block_outputs_plain(bank, v2, z2)
    assert torch.equal(y2[:, 1], biquad.block_outputs_plain(bank, v.flip(0), z.flip(0)))


def _card(op):
    """``op`` as the card's predicates read it: leaves on CUDA."""
    apow = types.SimpleNamespace(is_cuda=True, shape=op.APow.shape, ndim=op.APow.ndim)
    return dataclasses.replace(op, APow=apow)


# (L, B, m) -> (takes the state kernel, takes the emit kernel) on the card
ROUTES = {
    (128, 128, 12): (True, True),
    (64, 128, 12): (True, False),
    (128, 64, 12): (False, False),
    (128, 128, 8): (False, False),
}


@pytest.mark.parametrize("geometry", list(ROUTES), ids=lambda g: "L{}-B{}-m{}".format(*g))
@pytest.mark.parametrize("kind", ["shared", "bank"])
def test_the_route_is_read_from_the_operator(kind, geometry):
    """On the card the emit kernel takes exactly the operators that take
    the state kernel with blocks of 128 samples; on the CPU none."""
    block, blocks, m = geometry
    designs = [sps.butter(m, 0.1 * (c + 1), output="sos") for c in range(2)]
    if kind == "bank":
        op = biquad.precompute_composite_bank(np.stack(designs), block, blocks, device="cpu")
    else:
        op = biquad.precompute_composite(designs[0], block, blocks, device="cpu")
    assert not biquad.takes_state_kernel(op) and not biquad.takes_emit_kernel(op)
    card = _card(op)
    assert (biquad.takes_state_kernel(card), biquad.takes_emit_kernel(card)) == ROUTES[geometry]


@pytest.mark.parametrize("kind", ["shared", "bank"])
def test_the_steps_take_the_emit_of_the_route(monkeypatch, kind):
    """With the card's rule on CPU tensors (the forcing and state kernels'
    route, here their plain versions): the products step hands on the
    blocked input (a view of x) with the forcing pass's f, and the emit step
    runs ``block_outputs`` (its plain version, one call). Against the same
    state route with the GEMM form's products and emit. The final state does
    not depend on the emit: it is bit for bit the state step's on the plain
    pass's f. The GEMM form's forcing sums in another order, so its final
    states and outputs agree within the plain versions' limit."""
    name = "shared" if kind == "shared" else "bank64_mix"
    op = _op(name)
    run = (biquad.sosfilt_blocked_composite if kind == "shared"
           else biquad.sosfilt_blocked_composite_bank)
    rows = 2 if kind == "shared" else len(DESIGNS[name])
    x = np.random.default_rng(7).standard_normal((rows, 2 * B * L)).astype(np.float32)
    zi = 0.1 * np.random.default_rng(8).standard_normal((rows, 6, 2)).astype(np.float32)
    x, zi = torch.as_tensor(x), torch.as_tensor(zi)
    frames = biquad.cascade_frames(op)
    monkeypatch.setattr(biquad, "takes_state_kernel", lambda op: True)
    assert biquad.takes_emit_kernel(op)
    y0, f = biquad.cascade_products(op, x, frames)
    assert y0.data_ptr() == x.data_ptr() and torch.equal(f, biquad.block_forcing_plain(op, x)[1])
    launch.reset_counts()
    y, zf = run(op, x, zi)
    assert launch.counts["plain"]["iir_emit"] == 1 and launch.counts["plain"]["iir_state"] == 2
    assert launch.counts["plain"]["iir_force"] == 1
    _, z = biquad.cascade_chain(op, f, zi, frames)
    assert torch.equal(zf, biquad.cascade_state(op, z))
    monkeypatch.setattr(biquad, "takes_emit_kernel", lambda op: False)
    assert biquad.cascade_products(op, x, frames)[0].data_ptr() != x.data_ptr()
    launch.reset_counts()
    y_gemm, zf_gemm = run(op, x, zi)
    assert launch.counts["plain"]["iir_emit"] == 0 and launch.counts["plain"]["iir_state"] == 2
    assert launch.counts["plain"]["iir_force"] == 0
    assert _per_row(zf, zf_gemm).max() <= REL_VS_GEMM
    assert _per_row(y, y_gemm).max() <= REL_VS_GEMM


REFUSED = {
    "v not contiguous": lambda v, z: (v.transpose(-1, -2), z),
    "v float64": lambda v, z: (v.double(), z),
    "v blocks of 64": lambda v, z: (v[..., :64].contiguous(), z),
    "v frames of 64 blocks": lambda v, z: (v[:, :, :64].contiguous(), z[:, :, :64].contiguous()),
    "z_in of 8 states": lambda v, z: (v, z[..., :8].contiguous()),
    "z_in not contiguous": lambda v, z: (v, z.transpose(0, 1).contiguous().transpose(0, 1)),
    "rows not over the bank": lambda v, z: (v[:4], z[:4]),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    op = _op("bank64_mix")
    v, z = _inputs(op, 2, 9)
    assert biquad._emit_check(op, v, z) == (6, L * L, L * M, 1)
    with pytest.raises(ValueError):
        biquad._emit_check(op, *REFUSED[case](v, z))


def test_the_wrapper_reads_the_sets_of_a_bank_and_a_shared_design():
    bank = _op("bank64_mix")
    v = torch.zeros((6, 4, 1, B, L))
    z = torch.zeros((6, 4, 1, B, M))
    assert biquad._emit_check(bank, v, z) == (24, L * L, L * M, 4)
    shared = _op("shared")
    assert biquad._emit_check(shared, v, z) == (24, 0, 0, 24)
    with pytest.raises(ValueError, match="T and M"):
        biquad._emit_check(dataclasses.replace(shared, M=shared.M.double()), v, z)
