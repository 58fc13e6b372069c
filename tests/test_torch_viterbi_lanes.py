"""A NumPy model of K3's warp route (``tpu_sdr_torch/csrc/viterbi.cu``,
``viterbi_warp_kernel``: one warp a codeword row, k <= 7).

No CUDA kernel runs here, so this file is the readable spec of the route's
lane-state map: lane l holds the raw metrics of states l and l + 32 (one
state a lane below 64 states; lanes >= S hold nothing that is read); state
l's predecessors l>>1 and (l>>1) + 32 are read from lane l>>1, slots 0 and
1, state l+32's 16+(l>>1) and 48+(l>>1) from lane 16+(l>>1) (below 64
states, from lanes l>>1 and (l>>1) + S/2, slot 0); the step's maximum is
one reduction of order-preserving integer keys over the lanes that hold
states; each step's decisions are ballots, one 32-state word a slot; the
traceback walks those words from state 0, the state kept as lo | hi << 5
(hi picks the word, lo the bit). The arithmetic is float32 as the
kernel's: c = (raw[p] - m) + bm, bm summed in index order, a strict
compare. The model is held bit for bit against
``tpu_sdr.kernels.fec._viterbi`` (JAX on the CPU) and the port's
``fec.viterbi_plain``. Nothing on any path calls it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import fec as jfec
from tpu_sdr_torch.kernels import fec

torch.set_num_threads(1)

# A code for each k (the burst path's at k = 7), rate 1/2 and one rate 1/3.
CODES = {2: (0o3, 0o1), 3: (0o7, 0o5), 4: (0o17, 0o13), 5: (0o35, 0o23), 6: (0o75, 0o53),
         7: (0o133, 0o171)}
NEG = np.float32(-1e9)


def lane_map(k: int):
    """(states S, slots a lane, lanes that hold states, src_a, src_b): lane
    l reads state l's predecessors from lane src_a[l], state l + 32's (or
    state l's second below 64 states) from lane src_b[l]."""
    S = 1 << (k - 1)
    lane = np.arange(32)
    src_a = lane >> 1
    src_b = 16 + (lane >> 1) if S > 32 else (lane >> 1) + S // 2
    return S, 2 if S > 32 else 1, min(S, 32), src_a, src_b


def to_key(v: np.ndarray) -> np.ndarray:
    """A float32's order-preserving int32 key (the magnitude bits flipped
    where the sign is set); its own inverse."""
    i = v.view(np.int32) if v.dtype == np.float32 else v
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def states_max(r: np.ndarray, lanes: int) -> np.ndarray:
    """r (B, 32, slots) -> (B,) float32: the reduction of the keys of the
    lanes that hold states."""
    keys = to_key(r.max(axis=-1).astype(np.float32))
    keys[:, lanes:] = np.iinfo(np.int32).min
    return to_key(keys.max(axis=1)).view(np.float32)


def warp_viterbi(x: np.ndarray, out0: np.ndarray, out1: np.ndarray, k: int):
    """x (B, T, n) float32 -> (bits (B, T) uint8, words (B, T, W) uint32)."""
    b, t, n = x.shape
    S, slots, lanes, src_a, src_b = lane_map(k)
    st = np.arange(32)[:, None] + 32 * np.arange(slots)  # (32, slots): the lane's states
    held = st < S
    m0 = np.where(held, out0[np.minimum(st, S - 1)], 0)
    m1 = np.where(held, out1[np.minimum(st, S - 1)], 0)
    sg0 = np.where((m0[..., None] >> np.arange(n)) & 1, -1, 1).astype(np.float32)
    sg1 = np.where((m1[..., None] >> np.arange(n)) & 1, -1, 1).astype(np.float32)
    r = np.where(st == 0, np.float32(0), NEG).astype(np.float32)
    r = np.broadcast_to(r, (b, 32, slots)).copy()
    words = np.zeros((b, t, slots), np.uint32)
    for step in range(t):
        xk = x[:, step]  # (B, n)
        m = states_max(r, lanes)[:, None, None]
        bm0 = xk[:, None, None, 0] * sg0[..., 0]
        bm1 = xk[:, None, None, 0] * sg1[..., 0]
        for j in range(1, n):
            bm0 = bm0 + xk[:, None, None, j] * sg0[..., j]
            bm1 = bm1 + xk[:, None, None, j] * sg1[..., j]
        if slots == 2:  # slot 0 from lane src_a (slots 0, 1), slot 1 from src_b
            p0 = np.stack([r[:, src_a, 0], r[:, src_b, 0]], axis=-1)
            p1 = np.stack([r[:, src_a, 1], r[:, src_b, 1]], axis=-1)
        else:  # p0 from lane src_a, p1 from src_b, slot 0
            p0, p1 = r[:, src_a, :1], r[:, src_b, :1]
        c0 = (p0 - m) + bm0
        c1 = (p1 - m) + bm1
        dec = c1 > c0
        r = np.where(dec, c1, c0).astype(np.float32)
        ballot = (dec & held).astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None]
        words[:, step] = ballot.sum(axis=1).astype(np.uint32)
    bits = np.zeros((b, t), np.uint8)
    lo = np.zeros(b, np.int64)
    hi = np.zeros(b, bool)
    for step in range(t - 1, -1, -1):
        bits[:, step] = lo & 1
        word = np.where(hi, words[:, step, slots - 1], words[:, step, 0]).astype(np.int64)
        bit = ((word >> lo) & 1).astype(bool)
        if slots == 2:
            lo = (lo >> 1) | np.where(hi, 16, 0)
            hi = bit
        else:
            lo = (lo >> 1) | np.where(bit, 1 << (k - 2), 0)
    return bits, words


def observations(k: int, n: int, rows: int, t: int, kind: str):
    rng = np.random.default_rng(10 * k + n + (kind == "hard"))
    x = rng.standard_normal((rows, t, n)).astype(np.float32)
    return np.sign(x).astype(np.float32) if kind == "hard" else x


def polys(k: int, n: int) -> tuple:
    a, b = CODES[k]
    return (a, b) if n == 2 else (a, b, a | 1)


@pytest.mark.parametrize("k", sorted(CODES))
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_warp_route_equals_jax_and_plain(k, n, kind):
    """Every decision bit, tail included, against the JAX scans and the
    plain version, on soft and on hard (tie-rich) observations."""
    jc = jfec.ConvCode(k, polys(k, n))
    tc = fec.ConvCode(k, polys(k, n), device="cpu")
    x = observations(k, n, 3, 150, kind)
    got, _ = warp_viterbi(x, tc._tables["out0"].numpy(), tc._tables["out1"].numpy(), k)
    ref = np.asarray(jfec._viterbi(
        jnp.asarray(x), jnp.asarray(jc._prev0), jnp.asarray(jc._prev1),
        jnp.asarray(jc._sign0), jnp.asarray(jc._sign1), k=k))
    np.testing.assert_array_equal(got, ref)
    plain = fec.viterbi_plain(torch.as_tensor(x), tc._tables["sign0"], tc._tables["sign1"], k)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("k", sorted(CODES))
def test_predecessors_sit_where_the_map_reads_them(k):
    """Each state's two predecessors t >> 1 and (t >> 1) + S/2 are the
    states that lanes src_a and src_b hold in the slots the model reads."""
    S, slots, _, src_a, src_b = lane_map(k)
    for t in range(S):
        lane, slot = t % 32, t // 32
        p0, p1 = t >> 1, (t >> 1) + S // 2
        if slots == 2:
            src = src_a[lane] if slot == 0 else src_b[lane]
            assert (p0, p1) == (src, src + 32)
        else:
            assert (p0, p1) == (src_a[lane], src_b[lane])
        assert max(p0, p1) < S


@pytest.mark.parametrize("k", sorted(CODES))
def test_ballot_words_are_the_decisions_and_trace_back(k):
    """The words a step hold bit t & 31 of word t >> 5 = the decision of
    state t, the plain version's; walking them from state 0 gives the bits."""
    tc = fec.ConvCode(k, CODES[k], device="cpu")
    x = observations(k, 2, 2, 80, "soft")
    bits, words = warp_viterbi(x, tc._tables["out0"].numpy(), tc._tables["out1"].numpy(), k)
    S = 1 << (k - 1)
    st = np.arange(S)
    dec = (words[:, :, st // 32] >> (st % 32).astype(np.uint32)) & 1  # (B, T, S)
    # the plain version's decisions, one step at a time
    sign0, sign1 = tc._tables["sign0"].numpy(), tc._tables["sign1"].numpy()
    pm = np.full((2, S), NEG, np.float32)
    pm[:, 0] = 0
    for step in range(x.shape[1]):
        bm0 = x[:, step, :1] * sign0[:, 0] + x[:, step, 1:2] * sign0[:, 1]
        bm1 = x[:, step, :1] * sign1[:, 0] + x[:, step, 1:2] * sign1[:, 1]
        c0, c1 = pm[:, st >> 1] + bm0, pm[:, (st >> 1) + S // 2] + bm1
        np.testing.assert_array_equal(dec[:, step], (c1 > c0).astype(np.uint32))
        pm = np.where(c1 > c0, c1, c0)
        pm = pm - pm.max(axis=1, keepdims=True)
    state = np.zeros(2, np.int64)
    for step in range(x.shape[1] - 1, -1, -1):
        np.testing.assert_array_equal(bits[:, step], state & 1)
        state = (state >> 1) | (dec[np.arange(2), step, state].astype(np.int64) << (k - 2))


def test_keys_order_floats_as_fmaxf_does():
    """The integer keys keep the order of finite floats (negative, zero and
    positive, the -1e9 of a start), so the reduced key is the maximum."""
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.standard_normal(1000) * 10.0 ** rng.integers(-30, 30, 1000),
                        [0.0, 1e9, -1e9, 1e-40, -1e-40]]).astype(np.float32)
    order = np.argsort(v, kind="stable")
    keys = to_key(v.copy())
    assert np.all(np.diff(keys[order].astype(np.int64)) >= 0)
    r = rng.standard_normal((4, 32, 2)).astype(np.float32)
    r[:, 5:, :] = -np.inf  # lanes that hold no state never win
    np.testing.assert_array_equal(states_max(r, 32), r.max(axis=(1, 2)))
    np.testing.assert_array_equal(states_max(r[..., :1], 4), r[:, :4, 0].max(axis=1))
