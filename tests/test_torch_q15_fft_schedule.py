"""A NumPy model of K1's schedule (``tpu_sdr_torch/csrc/q15_fft.cu``), the
scaled Q15 FFT, on both of its routes.

No CUDA kernel runs here, so this file is the readable spec of the
kernel's index maps. The cluster route (n = 2^14) sees a frame as 128 x
128, i = 128 r + c, on a cluster of C CTAs of 8 x 128 / C threads, each
holding 16 points in registers:

- phase A, CTA q owns the columns c = q 128 / C + cl. Thread (g, cl),
  tid = g 128 / C + cl, loads r = g + 8k into register k (k < 16) and runs
  ranks 0-3 (rank u pairs registers k and k ^ 2^(3-u)); through Y it takes
  r = 8h + k', h = g + 8w, into register 8w + k' and runs ranks 4-6 on each
  group of 8;
- the X send: phase B runs row r on CTA b // (128 / C) as its local row b
  % (128 / C), b = brev7(r); each point is stored into that CTA's X (an
  asynchronous store counted on the receiver's mbarrier, so each CTA must
  receive exactly its 128 x 128 / C words);
- phase B, thread (u, g), tid = 8u + g, of CTA q takes c = g + 8k from its
  own X and runs ranks 7-10; through Z it takes c = 8h + k', h = g + 8w,
  and runs ranks 11-13;
- the W send: output k = brev7(c) 128 + brev7(r), so each point goes to
  the W of CTA cp // (128 / C), cp = brev7(c), at (local row cp % (128 /
  C), column brev7(r));
- the store: unit v = tid + T w takes the 8 outputs 8 (v % 16) .. of
  output row q 128 / C + v // 16 from its own W, so a warp stores two
  whole output rows.

The block route (n < 2^14) holds max(n, 2048) points a CTA (several frames
when n is small), 16 a thread, runs passes of up to four ranks from the top
index bit down through shared memory, and stores 8 bit-reversed outputs a
unit. Each layout is the kernel's (``y_word``, ``x_word``, ``z_word``,
``w_word``, ``block_slot``); the bank model counts shared-memory wavefronts
per warp access (4-byte words, 32 banks; 8-byte accesses in half-warp
phases, 16-byte in quarter-warp phases; a send's lanes counted per
receiving CTA). The model runs in int64 and is
held bit for bit against ``tpu_sdr.kernels.fft_q15.fft_q15`` (JAX on the
CPU), ``fft_q15_np`` and the port's ``window_fft_q15_plain``. Nothing on
any path calls it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_sdr.kernels import fft_q15 as jfft_q15
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.kernels import fft_q15

torch.set_num_threads(1)

SOURCE = Path(fft_q15.__file__).resolve().parent.parent / "csrc" / "q15_fft.cu"

CLUSTER_LOG2 = 14   # kClusterLog2: the cluster route's frame
LINE = 128          # kLine: points a column, and a row
POINTS = 16         # kPoints: points a thread holds
TPL = LINE // POINTS
CLUSTER_CTAS = 8    # kClusterCtas: C, the CTAs a frame on the cluster route
BLOCK_POINTS = 2048  # kBlockPoints
Z_STRIDE = 136      # kZStride
N = 1 << CLUSTER_LOG2
CTAS = (1, 2, 4, 8, 16)


def brev(x, bits: int):
    x = np.asarray(x)
    r = np.zeros_like(x)
    for b in range(bits):
        r |= ((x >> b) & 1) << (bits - 1 - b)
    return r


# --------------------------------------------------------------- layouts


def row_mask(cols: int) -> int:
    return 32 // cols - 1 if cols < 32 else 0


def y_word(r, cl, cols):
    return (r * cols + cl) ^ (((r >> 3) & row_mask(cols)) * cols)


def x_word(u, c):
    return (u >> 1) * 2 * LINE + 2 * (c ^ (((u >> 1) & 1) << 3)) + (u & 1)


def z_word(u, c):
    return u * Z_STRIDE + (c ^ (((c >> 5) & 1) << 2))


def w_word(rl, col):
    ch = col >> 2
    return rl * LINE + ((ch ^ ((ch >> 3) & 1) ^ ((rl >> 1) & 7)) << 2) + (col & 3)


def block_slot(p):
    return p ^ ((p >> 5) & 31)


# --------------------------------------------------------------- arithmetic


def sat16(v):
    return np.clip(v, -32768, 32767)


def butterfly(ar, ai, br, bi, w_re, w_im, s: int):
    """The kernel's butterfly: no clamp on (a +- b) >> s when s >= 1."""
    if s:
        sr, si, dr, di = (ar + br) >> s, (ai + bi) >> s, (ar - br) >> s, (ai - bi) >> s
    else:
        sr, si, dr, di = sat16(ar + br), sat16(ai + bi), sat16(ar - br), sat16(ai - bi)
    return sr, si, sat16((dr * w_re - di * w_im) >> 15), sat16((dr * w_im + di * w_re) >> 15)


def twiddle(tw, e):
    """The table's entry e in registers; entry 0 as (32768, 0), whose
    product is d exactly (the bypass)."""
    e = np.asarray(e)
    return np.where(e == 0, 32768, tw[e, 0]), tw[e, 1]


def pass_ranks(re, im, q: int, t0: int, j_of, tw, sched):
    """q ranks in registers on groups of 2^q points along the last axis
    (register k of a group holds its point k): rank u pairs registers ka
    and ka | 2^(q-1-u); j_of(u, ka & (2^(q-1-u) - 1)) is the pair's j."""
    size = 1 << q
    for grp in range(re.shape[-1] // size):
        off = grp * size
        for u in range(q):
            t = t0 + u
            span = 1 << (q - 1 - u)
            for ka in range(size):
                if ka & span:
                    continue
                a, b = off + ka, off + (ka | span)
                w_re, w_im = twiddle(tw, j_of(u, ka & (span - 1)) << t)
                re[..., a], im[..., a], re[..., b], im[..., b] = butterfly(
                    re[..., a], im[..., a], re[..., b], im[..., b], w_re, w_im, sched[t])


def table(n: int) -> np.ndarray:
    return np.stack(fft_q15.plan_q15(n)["ranks"][0], axis=-1)


def windowed(x, rom):
    p = x.astype(np.int64) * rom.astype(np.int64)
    return ((p >> 15) + ((p >> 14) & 1)).astype(np.int16).astype(np.int64)


# --------------------------------------------------------------- the cluster route


def cluster_maps(C: int) -> dict:
    """Every index map of the cluster route at C CTAs a frame, as (T, 16)
    arrays over (thread, register) of CTA q = 0..C-1 (leading axis)."""
    cols = LINE // C
    T = TPL * cols
    tid, k = np.arange(T)[:, None], np.arange(POINTS)[None, :]
    q = np.arange(C)[:, None, None]
    g, cl = tid // cols, tid % cols
    h = g + 8 * (k >> 3)
    ub, gb = tid // TPL, tid % TPL
    r_b = brev(q * cols + ub, 7)
    c_b = gb + TPL * k
    c_b2 = TPL * (gb + 8 * (k >> 3)) + (k & 7)
    return dict(
        cols=cols, T=T, g=g, cl=cl, c_a=q * cols + cl,
        a1_r=np.broadcast_to(g + TPL * k, (C, T, POINTS)),   # A1: register k holds r
        a2_r=np.broadcast_to(TPL * h + (k & 7), (C, T, POINTS)),  # A2
        b_u=ub, b_g=gb, b_r=r_b,
        b1_c=np.broadcast_to(c_b, (C, T, POINTS)),            # B1: register k holds c
        b2_c=np.broadcast_to(c_b2, (C, T, POINTS)),           # B2
        send_b=np.broadcast_to(brev(TPL * h + (k & 7), 7), (C, T, POINTS)),  # phase B's row
        push_cp=np.broadcast_to(brev(c_b2, 7), (C, T, POINTS)),  # the output row
        push_col=np.broadcast_to(q * cols + ub, (C, T, POINTS)),  # and column
    )


def push_cp(gb, k):
    """The kernel's output row of register k of thread (u, gb) after B2,
    and (with g for gb) phase B's row of register k of thread (g, cl) after
    A2: brev3(k & 7) 16 + brev3(gb) 2 + (k >> 3)."""
    return (brev(k & 7, 3) << 4) | (brev(gb, 3) << 1) | (k >> 3)


def cluster_route(x_re, x_im=None, rom=None, schedule=None, C: int = CLUSTER_CTAS):
    """(F, 16384) int16 frames through the cluster route's schedule with C
    CTAs a frame. Returns (re, im) int16 in natural order."""
    sched = (1,) * CLUSTER_LOG2 if schedule is None else tuple(schedule)
    mp = cluster_maps(C)
    cols, T = mp["cols"], mp["T"]
    tw = table(N).astype(np.int64)
    xr = x_re.astype(np.int64)
    xi = np.zeros_like(xr) if x_im is None else x_im.astype(np.int64)
    if rom is not None:
        xr, xi = windowed(xr, rom), windowed(xi, rom)
    F = xr.shape[0]
    g, c_a = mp["g"][:, 0], mp["c_a"][..., 0]    # (T,), (C, T)
    X = np.full((C, 2, F, LINE * cols), 1 << 40, np.int64)   # as each CTA receives it
    for q in range(C):
        # A1: straight from the frame; ranks 0-3, j = 128 g + c + (jj << 10)
        idx = LINE * mp["a1_r"][q] + c_a[q][:, None]
        re, im = xr[:, idx], xi[:, idx]
        pass_ranks(re, im, 4, 0, lambda u, jj: LINE * g + c_a[q] + (jj << 10), tw, sched)
        # through Y (each word written once, read once)
        y = np.zeros((2, F, LINE * cols), np.int64)
        wy = y_word(mp["a1_r"][q], mp["cl"], cols)
        y[0][:, wy], y[1][:, wy] = re, im
        wy2 = y_word(mp["a2_r"][q], mp["cl"], cols)
        re, im = y[0][:, wy2], y[1][:, wy2]
        # A2: ranks 4-6 on two groups, j = c + (jj << 7)
        pass_ranks(re, im, 3, 4, lambda u, jj: c_a[q] + (jj << 7), tw, sched)
        # the X send: point (r, c) to phase B's CTA of row r
        b = mp["send_b"][q]
        dest, word = b // cols, x_word(b % cols, c_a[q][:, None])
        X[dest, 0, :, word], X[dest, 1, :, word] = re.transpose(1, 2, 0), im.transpose(1, 2, 0)
    out_re = np.zeros((F, N), np.int16)
    out_im = np.zeros((F, N), np.int16)
    W = np.full((C, 2, F, LINE * cols), 1 << 40, np.int64)   # each word written once
    gb = mp["b_g"]
    for q in range(C):
        c = mp["b1_c"][q]
        wx = x_word(mp["b_u"], c)                   # from its own X
        re, im = X[q, 0][:, wx], X[q, 1][:, wx]
        # B1: ranks 7-10, j = g + (jj << 3): the row twiddle W_128^(j << u),
        # the table's entry (j << u) << 7
        pass_ranks(re, im, 4, 7, lambda u, jj: (gb + (jj << 3))[:, 0], tw, sched)
        z = np.zeros((2, F, (LINE // C) * Z_STRIDE), np.int64)
        wz = z_word(mp["b_u"], c)
        z[0][:, wz], z[1][:, wz] = re, im
        wz2 = z_word(mp["b_u"], mp["b2_c"][q])
        re, im = z[0][:, wz2], z[1][:, wz2]
        # B2: ranks 11-13, j = jj
        pass_ranks(re, im, 3, 11, lambda u, jj: np.full(T, jj), tw, sched)
        # the push into the W of the output row's owner
        cp, col = mp["push_cp"][q], mp["push_col"][q]
        owner, word = cp // cols, w_word(cp % cols, col)
        W[owner, 0, :, word], W[owner, 1, :, word] = re.transpose(1, 2, 0), im.transpose(1, 2, 0)
    # then each CTA stores whole output rows: unit v = tid + T w the
    # outputs 8 (v % 16) .. of its row v // 16
    for q in range(C):
        for half in range(2):
            v = np.arange(T) + T * half
            rl, j = v >> 4, v & 15
            src = w_word(rl[:, None], 8 * j[:, None] + np.arange(8)[None, :])
            dst = (q * cols + rl)[:, None] * LINE + 8 * j[:, None] + np.arange(8)[None, :]
            out_re[:, dst], out_im[:, dst] = W[q, 0][:, src], W[q, 1][:, src]
    return out_re, out_im


# --------------------------------------------------------------- the block route


def block_route(x_re, x_im=None, rom=None, schedule=None):
    """(F, n) int16 frames, n < 2^14, through the block route: max(n, 2048)
    points a CTA in shared memory (at block_slot), passes of up to four
    ranks from the top index bit, 16 points a thread, then 8 bit-reversed
    outputs a unit."""
    F, n = x_re.shape
    m = n.bit_length() - 1
    sched = (1,) * m if schedule is None else tuple(schedule)
    tw = table(n).astype(np.int64)
    points = max(n, BLOCK_POINTS)
    T = points // POINTS
    total = F * n
    ctas = -(-total // points)
    flat_r = np.zeros(ctas * points, np.int64)
    flat_i = np.zeros(ctas * points, np.int64)
    xr = x_re.astype(np.int64).ravel()
    xi = np.zeros_like(xr) if x_im is None else x_im.astype(np.int64).ravel()
    if rom is not None:
        r16 = np.tile(rom, F)
        xr, xi = windowed(xr, r16), windowed(xi, r16)
    flat_r[:total], flat_i[:total] = xr, xi
    out_re = np.zeros(ctas * points, np.int16)
    out_im = np.zeros(ctas * points, np.int16)
    tid = np.arange(T)
    for cta in range(ctas):
        buf = np.zeros((2, points), np.int64)
        p = tid[:, None] + T * np.arange(POINTS)[None, :]
        buf[0, block_slot(p)] = flat_r[cta * points + p]
        buf[1, block_slot(p)] = flat_i[cta * points + p]
        done = 0
        while done < m:
            q = min(4, m - done)
            lo = m - done - q
            gi = tid[:, None] + T * np.arange(POINTS >> q)[None, :]   # a thread's groups
            fl, gl = gi >> (m - q), gi & ((n >> q) - 1)
            jbase = gl & ((1 << lo) - 1)
            p0 = (fl << m) + ((gl >> lo) << (lo + q)) + jbase
            slots = block_slot(p0[..., None] + (np.arange(1 << q) << lo))
            for grp in range(POINTS >> q):
                re, im = buf[0, slots[:, grp]], buf[1, slots[:, grp]]  # (T, 2^q)
                pass_ranks(re, im, q, done, lambda u, jj: jbase[:, grp] + (jj << lo), tw, sched)
                buf[0, slots[:, grp]], buf[1, slots[:, grp]] = re, im
            done += q
        for half in range(2):
            p0 = 8 * (tid + T * half)
            pp = p0[:, None] + np.arange(8)[None, :]
            k = pp & (n - 1)
            src = block_slot((pp - k) + brev(k, m))
            out_re[cta * points + pp] = buf[0, src]
            out_im[cta * points + pp] = buf[1, src]
    return out_re[:total].reshape(F, n), out_im[:total].reshape(F, n)


# --------------------------------------------------------------- shared-memory banks


def wavefronts(words, width: int) -> int:
    """Wavefronts of one warp access: ``words`` the 32 lanes' first 4-byte
    words, ``width`` words a lane (1, 2 or 4: phases of 32, 16 or 8
    lanes); per phase, the most distinct words in one bank."""
    lanes = {1: 32, 2: 16, 4: 8}[width]
    total = 0
    for p in range(0, len(words), lanes):
        banks = {}
        for a in words[p:p + lanes]:
            for i in range(width):
                banks.setdefault((a + i) % 32, set()).add(a + i)
        total += max(len(s) for s in banks.values())
    return total


def cluster_accesses(C: int) -> dict:
    """Each exchange's warp accesses in CTA 1 (CTA 0 at C = 1): name ->
    (width, list of 32-word lists)."""
    mp = cluster_maps(C)
    cols, T = mp["cols"], mp["T"]
    q = min(1, C - 1)
    warps = [slice(w, w + 32) for w in range(0, T, 32)]
    acc = {}

    def per_reg(words, regs=range(POINTS)):
        return [list(words[ws, k]) for ws in warps for k in regs]

    acc["Y write"] = (1, per_reg(y_word(mp["a1_r"][q], mp["cl"], cols)))
    acc["Y read"] = (1, per_reg(y_word(mp["a2_r"][q], mp["cl"], cols)))
    # a send: a warp's store of register k, per destination CTA (each its
    # own SM's banks)
    # registers k and k + 8 as one 8-byte vector
    b = mp["send_b"][q]
    dest, word = b // cols, x_word(b % cols, mp["c_a"][q])
    acc["X send"] = (2, [list(word[ws, k][dest[ws, k] == o]) for ws in warps
                         for k in range(POINTS // 2) for o in np.unique(dest[ws, k])])
    acc["X read"] = (1, per_reg(x_word(mp["b_u"], mp["b1_c"][q])))
    acc["Z write"] = (1, per_reg(z_word(mp["b_u"], mp["b1_c"][q])))
    acc["Z read"] = (4, per_reg(z_word(mp["b_u"], mp["b2_c"][q]), regs=range(0, POINTS, 4)))
    cp, col = mp["push_cp"][q], mp["push_col"][q]
    owner, word = cp // cols, w_word(cp % cols, col)
    acc["W send"] = (1, [list(word[ws, k][owner[ws, k] == o]) for ws in warps
                         for k in range(POINTS) for o in np.unique(owner[ws, k])])
    v = np.arange(T)[:, None] + T * np.arange(2)[None, :]
    rl, j = v >> 4, v & 15
    reads = [list(w_word(rl[ws, h], 8 * j[ws, h] + 4 * i)) for ws in warps for h in range(2)
             for i in range(2)]
    acc["W read"] = (4, reads)
    return acc


# --------------------------------------------------------------- inputs and references


def frames(shape, seed: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal(shape) * 6000).astype(np.int16)
    return rng.choice(np.array([-32768, 32767], np.int16), shape)   # full scale


def references(x_re, x_im, schedule):
    """(JAX fft_q15 on the CPU, fft_q15_np, the port's plain version)."""
    import jax.numpy as jnp

    jre, jim = jfft_q15.fft_q15(jnp.asarray(x_re), None if x_im is None else jnp.asarray(x_im),
                                schedule=schedule)
    nre, nim = fft_q15.fft_q15_np(x_re, x_im, schedule=schedule)
    pre, pim, _ = fft_q15.window_fft_q15_plain(
        torch.as_tensor(x_re), None if x_im is None else torch.as_tensor(x_im), None, schedule,
        want_magnitude=False)
    return (np.asarray(jre), np.asarray(jim)), (nre, nim), (pre.numpy(), pim.numpy())


def assert_equal_all(got, refs):
    for ref in refs:
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("C", CTAS)
def test_cluster_maps_partition_the_frame(C):
    """At every phase the (CTA, thread, register) of the cluster route hold
    each of the 16384 points once; each output is stored once."""
    mp = cluster_maps(C)
    cols = mp["cols"]
    a1 = LINE * mp["a1_r"] + mp["c_a"]
    a2 = LINE * mp["a2_r"] + mp["c_a"]
    b1 = LINE * mp["b_r"] + mp["b1_c"]
    b2 = LINE * mp["b_r"] + mp["b2_c"]
    for idx in (a1, a2, b1, b2):
        assert np.array_equal(np.sort(idx.ravel()), np.arange(N))
    # the X send: the kernel's phase-B row of a register; every point lands
    # once, each CTA receiving cols x 128 words (its mbarrier's bytes)
    k = np.arange(POINTS)[None, :]
    assert np.array_equal(push_cp(mp["g"], k), mp["send_b"][0])
    assert np.array_equal(mp["send_b"], brev(mp["a2_r"], 7))
    dest = mp["send_b"] // cols
    got = (dest * cols + mp["send_b"] % cols) * LINE + mp["c_a"]
    assert np.array_equal(np.sort(got.ravel()), np.arange(N))
    assert np.array_equal(np.bincount(dest.ravel()), np.full(C, cols * LINE))
    # phase B's CTA q row u is brev7(q cols + u), as the send put it
    assert np.array_equal(brev(mp["b_r"][..., 0], 7), q_cols_u := (np.arange(C)[:, None] * cols
                                                                   + mp["b_u"][:, 0]))
    del q_cols_u
    # output k of point (r, c) is brev7(c) 128 + brev7(r): CTA q's rows are
    # the outputs q cols .. q cols + cols - 1 of every output row
    assert np.array_equal(brev(mp["b_r"][:, ::TPL, 0], 7),
                          np.arange(C)[:, None] * cols + np.arange(cols))
    # the W send: the kernel's output row of a register; every output
    # point lands once, in the W of the CTA that owns its output row
    assert np.array_equal(push_cp(mp["b_g"], k), brev(mp["b2_c"][0], 7))
    out = LINE * mp["push_cp"] + mp["push_col"]
    assert np.array_equal(out, LINE * brev(mp["b2_c"], 7) + brev(mp["b_r"], 7))
    assert np.array_equal(np.sort(out.ravel()), np.arange(N))
    # the store: CTA q's units cover its cols output rows once, 8 outputs each
    q = np.arange(C)[:, None, None]
    v = np.arange(mp["T"])[:, None] + mp["T"] * np.arange(2)[None, :]
    dst = (q * cols + (v >> 4))[..., None] * LINE + 8 * (v & 15)[None, ..., None] + np.arange(8)
    assert np.array_equal(np.sort(dst.ravel()), np.arange(N))
    assert np.array_equal(np.bincount((out // LINE // cols).ravel()), np.full(C, cols * LINE))


@pytest.mark.parametrize("C", CTAS)
def test_layouts_are_one_to_one_and_keep_vectors_whole(C):
    """Each exchange's layout is a bijection onto its buffer, and the
    words a thread moves as one vector are contiguous and aligned."""
    cols = LINE // C
    r, cl = np.meshgrid(np.arange(LINE), np.arange(cols), indexing="ij")
    w = y_word(r, cl, cols)
    assert np.array_equal(np.sort(w.ravel()), np.arange(LINE * cols))
    for fn in (x_word, w_word):
        w = fn(*np.meshgrid(np.arange(cols), np.arange(LINE), indexing="ij"))
        assert np.array_equal(np.sort(w.ravel()), np.arange(LINE * cols))
    u, c = np.meshgrid(np.arange(cols), np.arange(LINE), indexing="ij")
    assert len(np.unique(z_word(u, c))) == u.size and z_word(u, c).max() < cols * Z_STRIDE
    # a sender's registers k and k + 8 (rows b and b + 1, b even): one
    # aligned 8-byte vector
    base = x_word(np.arange(0, cols, 2)[:, None], np.arange(LINE)[None, :])
    assert np.all(base % 2 == 0)
    assert np.all(x_word(np.arange(1, cols, 2)[:, None], np.arange(LINE)[None, :]) == base + 1)
    for col0 in range(0, LINE, 4):
        base = w_word(np.arange(cols), col0)
        assert np.all(base % 4 == 0)
        for i in range(4):
            assert np.all(w_word(np.arange(cols), col0 + i) == base + i)
    assert np.array_equal(np.sort(block_slot(np.arange(8192))), np.arange(8192))


@pytest.mark.parametrize("C", CTAS)
def test_exchanges_are_free_of_bank_conflicts(C):
    """Every warp access of every exchange takes its least number of
    wavefronts: one per 32 lanes of words, two for 8-byte and four for
    16-byte vectors."""
    for name, (width, accesses) in cluster_accesses(C).items():
        worst = max(wavefronts(a, width) for a in accesses)
        assert worst == {1: 1, 2: 2, 4: 4}[width], (C, name, worst)


@pytest.mark.parametrize("C", CTAS)
def test_cluster_route_equals_jax_numpy_and_plain(C):
    """Complex input, the default schedule: the model at every cluster size
    equals JAX's fft_q15 (CPU), fft_q15_np and the plain version bit for
    bit."""
    x, xi = frames((1, N), 10 + C, "random"), frames((1, N), 20 + C, "random")
    got = cluster_route(x, xi, C=C)
    assert_equal_all(got, references(x, xi, (1,) * CLUSTER_LOG2))


@pytest.mark.parametrize("schedule", ["ones", "t%3", "zeros", "twos"])
def test_cluster_route_schedules_at_full_scale(schedule):
    """Full-scale complex input through the chosen C: the schedule all
    ones, t % 3, all zeros (every rank saturates) and 2-0 alternating."""
    sched = {"ones": (1,) * 14, "t%3": tuple(t % 3 for t in range(14)), "zeros": (0,) * 14,
             "twos": (2, 0) * 7}[schedule]
    x, xi = frames((1, N), 31, "full"), frames((1, N), 32, "full")
    got = cluster_route(x, xi, schedule=sched)
    refs = references(x, xi, sched)
    assert_equal_all(got, refs)
    if schedule == "zeros":
        assert (np.abs(got[0].astype(np.int64)) == 32767).any() or (got[0] == -32768).any()


def test_cluster_route_window():
    """With the ROM: the window on the load, then the FFT, against the
    plain version's window_fft_q15."""
    x = frames((1, N), 40, "random")
    rom = golden.hann_q16_rom(N)
    got = cluster_route(x, rom=rom)
    pre, pim, _ = fft_q15.window_fft_q15_plain(torch.as_tensor(x), None, torch.as_tensor(rom))
    np.testing.assert_array_equal(got[0], pre.numpy())
    np.testing.assert_array_equal(got[1], pim.numpy())


@pytest.mark.parametrize("log2n,F", [(1, 5), (4, 3), (8, 9), (11, 2), (13, 3)])
def test_block_route_equals_jax_numpy_and_plain(log2n, F):
    """The block route at small frames, frames a CTA not dividing F (the
    last CTA part-full), t % 3 schedules and complex input."""
    n = 1 << log2n
    sched = tuple(t % 3 for t in range(log2n))
    x, xi = frames((F, n), 50 + log2n, "random"), frames((F, n), 60 + log2n, "full")
    got = block_route(x, xi, schedule=sched)
    assert_equal_all(got, references(x, xi, sched))


def test_route_constants_are_the_sources():
    """The model's constants are the kernel's: C, the points a thread and a
    line, the block route's points, Z's stride, the route's frame; and the
    route is the cluster route for n = 2^14 only."""
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kClusterCtas"]) == CLUSTER_CTAS
    assert int(consts["kLine"]) == LINE
    assert int(consts["kPoints"]) == POINTS
    assert int(consts["kBlockPoints"]) == BLOCK_POINTS
    assert int(consts["kZStride"]) == Z_STRIDE
    assert int(consts["kClusterLog2"]) == CLUSTER_LOG2
    assert "return log2n == kClusterLog2 ? kClusterCtas : 0;" in src
