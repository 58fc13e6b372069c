"""The port's PFB channelizer (``tpu_sdr_torch.kernels.pfb``) and the fused
kernel's plain version (``kernels/cuda/pfb_kernel.pfb_fold_dft_plain``)
against tpu_sdr's, on the CPU.

The JAX kernel runs as its own tests run it on the CPU, in Pallas interpret
mode (``pfb_fold_dft(..., interpret=True)``, or
``Channelizer(use_pallas=True)``, which interprets on the CPU). Errors are
measured against the output scale, max |re| of the reference.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import pfb as jpfb
from tpu_sdr.kernels.pallas import pfb_kernel as jkern
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import pfb
from tpu_sdr_torch.kernels.cuda import launch, pfb_kernel

torch.set_num_threads(1)

# fp32 products of 128 terms summed in different orders (XLA's dot, MKL
# through _canonical_matmul, the fold in the same order): a few ulps of the
# output scale (tests/test_pfb.py's bound).
PFB_REL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_designs_equal_jax():
    for m, taps in ((128, 8), (64, 4), (16, 33)):
        assert np.array_equal(pfb.design_prototype(m, taps), jpfb.design_prototype(m, taps))
        for a, b in zip(pfb.dft_matrices(m), jpfb.dft_matrices(m)):
            assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("neg_b", [False, True], ids=["b", "negb"])
@pytest.mark.parametrize("steps,taps", [(1, 8), (7, 2), (9, 9), (300, 20), (40, 33), (5, 1)])
def test_plain_matches_jax_kernel_interpret(steps, taps, neg_b):
    rows = _x((2, steps + taps - 1, 128), seed=steps + taps)
    h2 = jpfb.design_prototype(128, taps).reshape(taps, 128).astype(np.float32)
    cos, sin = jpfb.dft_matrices(128)
    ja, jb = jkern.pfb_fold_dft(*(jnp.asarray(a) for a in (rows, h2, cos, sin)), taps, 128,
                                interpret=True, neg_b=neg_b)
    a, b = pfb_kernel.pfb_fold_dft(*(torch.tensor(v) for v in (rows, h2, cos, sin)), taps, 128,
                                   neg_b=neg_b)
    assert a.shape == np.shape(ja) == (2, steps, 128)
    scale = np.abs(np.asarray(ja)).max()
    assert np.abs(a.numpy() - np.asarray(ja)).max() < PFB_REL * scale
    assert np.abs(b.numpy() - np.asarray(jb)).max() < PFB_REL * scale


def test_plain_fold_is_the_reference_fold_and_counts():
    rows = torch.tensor(_x((1, 20, 128), seed=2))
    h2 = torch.tensor(_x((5, 128), seed=3))
    cos, sin = (torch.tensor(v) for v in pfb.dft_matrices(128))
    launch.reset_counts()
    a, _ = pfb_kernel.pfb_fold_dft(rows, h2, cos, sin, 5, 128, interpret=True)
    assert launch.counts["plain"]["pfb_fold_dft"] == 1
    assert not any(launch.counts["kernel"].values())
    folded = sum(rows[:, t : t + 16].double() * h2[t].double() for t in range(5))
    np.testing.assert_allclose(a.double().numpy(), (folded @ cos.double()).numpy(),
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="precision"):
        pfb_kernel.pfb_fold_dft(rows, h2, cos, sin, 5, 128, precision="high")
    with pytest.raises(ValueError, match="taps"):
        pfb_kernel.pfb_fold_dft(rows, h2, cos, sin, 22, 128)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("taps", [8, 3])
def test_channelizer_matches_jax(use_pallas, taps):
    j = jpfb.Channelizer(m=128, taps=taps, use_pallas=use_pallas)
    c = pfb.Channelizer(m=128, taps=taps, use_pallas=use_pallas, device="cpu")
    x = _x((2, 40 * 128), seed=4)
    jo, jst = j.process(x, j.initial_state((2,)), outputs="all")
    o, st = c.process(x, c.initial_state((2,)), outputs="all")
    scale = np.abs(np.asarray(jo["re"])).max()
    for k in ("re", "im", "magnitude"):
        assert np.abs(o[k].numpy() - np.asarray(jo[k])).max() < PFB_REL * scale, k
    assert np.array_equal(st.numpy(), np.asarray(jst))
    xs = _x((2, 1, 24 * 128), seed=5)
    jo, _ = j.process_planes(xs, j.initial_state((2, 1)))
    o, _ = c.process_planes(xs, c.initial_state((2, 1)))
    for k in ("re", "im"):
        assert np.abs(o[k].numpy() - np.asarray(jo[k])).max() < PFB_REL * scale, k


@pytest.mark.parametrize("steps", [1, 7, 9, 300])
def test_kernel_path_matches_xla_path(steps):
    """Mirrors tests/test_pfb.py's odd-size and halo cases."""
    a = pfb.Channelizer(m=128, taps=8, use_pallas=True, device="cpu")
    b = pfb.Channelizer(m=128, taps=8, device="cpu")
    x = _x((1, steps * 128), seed=steps)
    oa, sa = a.process(x, a.initial_state((1,)))
    ob, sb = b.process(x, b.initial_state((1,)))
    scale = ob["re"].abs().max().item()
    assert (oa["re"] - ob["re"]).abs().max().item() < PFB_REL * scale
    assert (oa["im"] - ob["im"]).abs().max().item() < PFB_REL * scale
    assert torch.equal(sa, sb)


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
def test_chunked_equals_oneshot_bitwise(use_pallas, iq):
    c = pfb.Channelizer(m=128, taps=8, use_pallas=use_pallas, device="cpu")
    shape = (2, 2) if iq else (2,)
    x = _x(shape + (30 * 128,), seed=6)
    run = c.process_planes if iq else c.process
    one, st_one = run(x, c.initial_state(shape))
    st, parts, prev = c.initial_state(shape), [], 0
    for cut in (128, 5 * 128, 17 * 128, 30 * 128):
        o, st = run(x[..., prev:cut], st)
        parts.append(o)
        prev = cut
    for k in ("re", "im"):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=-2), one[k])
    assert torch.equal(st, st_one)


def test_batch_row_equals_row_alone():
    c = pfb.Channelizer(m=128, taps=8, use_pallas=True, device="cpu")
    x = _x((3, 12 * 128), seed=7)
    o, _ = c.process(x, c.initial_state((3,)))
    alone, _ = c.process(x[1:2], c.initial_state((1,)))
    assert torch.equal(o["re"][1:2], alone["re"]) and torch.equal(o["im"][1:2], alone["im"])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
def test_tone_lands_in_its_channel(use_pallas):
    """A complex tone at channel 37's center: IQ input puts it there and
    nowhere else above -60 dB; a real tone lands in 37 and its mirror."""
    m, fs = 128, 1e6
    c = pfb.Channelizer(m=m, taps=8, use_pallas=use_pallas, sample_rate=fs, device="cpu")
    n = np.arange(64 * m)
    f = 37 * c.channel_hz
    xs = np.stack([np.cos(2 * np.pi * f * n / fs), np.sin(2 * np.pi * f * n / fs)])
    o, _ = c.process_planes(xs.astype(np.float32)[:, None], c.initial_state((2, 1)),
                            outputs="magnitude")
    mag = o["magnitude"][0, 16:].mean(dim=0).numpy()
    assert mag.argmax() == 37 and np.sort(mag)[-2] < 1e-3 * mag.max()
    o, _ = c.process(xs[0].astype(np.float32), c.initial_state(), outputs="magnitude")
    mag = o["magnitude"][16:].mean(dim=0).numpy()
    assert set(np.argsort(mag)[-2:]) == {37, m - 37}


def test_state_from_jax_and_validation():
    j = jpfb.Channelizer(m=128, taps=4)
    x = _x(6 * 128, seed=8)
    _, jst = j.process(x, j.initial_state())
    c = pfb.Channelizer(m=128, taps=4, device="cpu")
    st = convert.channelizer_state(np.asarray(jst), device="cpu")
    o, _ = c.process(x, st)
    jo, _ = j.process(x, jst)
    scale = np.abs(np.asarray(jo["re"])).max()
    assert _rel(o["re"].numpy(), jo["re"]) < PFB_REL and scale > 0
    cos, sin = convert.dft(*jpfb.dft_matrices(128), device="cpu")
    assert torch.equal(cos, c._cos) and torch.equal(sin, c._sin)
    with pytest.raises(ValueError, match="not a multiple"):
        c.process(np.zeros(100, np.float32), c.initial_state())
    with pytest.raises(ValueError, match="dtype"):
        pfb.Channelizer(dtype="f16", device="cpu")
    with pytest.raises(ValueError, match="outputs"):
        c.process(x, st, outputs="phase")
