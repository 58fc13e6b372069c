"""Forward error correction: convolutional codes and batched Viterbi
decoding (the counterpart of ``tpu_sdr.kernels.fec``).

A rate-1/n non-recursive convolutional encoder with optional puncturing
(host NumPy, as in the reference) and a soft/hard-decision Viterbi decoder.
The decoder, ``viterbi``, launches K3 (``kernels/cuda/viterbi.py``,
``csrc/viterbi.cu``: one CTA a codeword, all states in parallel, one launch
a decode) on a CUDA tensor and runs ``viterbi_plain`` on a CPU tensor: a
Python loop over the trellis steps with the reference's add-compare-select,
the branch metrics summed in index order, ``c1 > c0`` strict (state p0 wins
a tie), the per-step maximum subtracted, and the traceback from state 0.
The kernel equals the plain version bit for bit.

Conventions (as the reference's):

- Generator polynomials in octal with the MSB as the D^0 (newest-input)
  tap, e.g. the NASA/Voyager K=7 pair ``(0o133, 0o171)``.
- Zero-terminated encoding: K-1 tail zeros flush the register, so the
  decoder tracebacks from state 0.
- Soft inputs are positive when coded bit 0 is more likely (BPSK mapping
  x = (1-2c) + noise).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.kernels.ddc import resolve_device

_NEG = -1e9  # "minus infinity" for float32 path metrics


def _poly_taps(poly: int, k: int) -> np.ndarray:
    """Octal generator -> tap array t[i] = coefficient of D^i (multiplies
    u_{n-i}), MSB = D^0."""
    if poly <= 0 or poly >= (1 << k):
        raise ValueError(f"polynomial {poly:#o} does not fit constraint length {k}")
    bits = [(poly >> (k - 1 - i)) & 1 for i in range(k)]
    return np.array(bits, np.uint8)


# Standard puncturing patterns for a rate-1/2 mother code (802.11a/DVB-style).
# pattern[j, p] == 1 keeps output stream j at trellis step (k mod P).
_PUNCTURE_PATTERNS = {
    "1/2": np.array([[1], [1]], np.uint8),
    "2/3": np.array([[1, 1], [1, 0]], np.uint8),
    "3/4": np.array([[1, 0, 1], [1, 1, 0]], np.uint8),
}


class ConvCode:
    """Rate-1/n convolutional code with Viterbi decoding on the device.

    Parameters
    ----------
    constraint_len : total register length K (state = K-1 bits), 2..12.
    polys : octal generators, one per output stream (n = len(polys)).
    puncture : None / "1/2" (no-op) / "2/3" / "3/4" for the standard
        rate-1/2 patterns, or an explicit (n, P) 0/1 array applied
        cyclically over trellis steps.
    device : where ``decode`` runs (None: CUDA).
    """

    def __init__(self, constraint_len: int = 7,
                 polys: tuple[int, ...] = (0o133, 0o171),
                 puncture=None, device=None):
        self.device = resolve_device(device, "ConvCode")
        self.k = int(constraint_len)
        if self.k < 2 or self.k > 12:
            raise ValueError(f"constraint length {self.k} out of range [2, 12]")
        self.polys = tuple(int(p) for p in polys)
        self.n_out = len(self.polys)
        if self.n_out < 2:
            raise ValueError("need at least 2 generator polynomials")
        self.n_states = 1 << (self.k - 1)
        self._taps = np.stack([_poly_taps(p, self.k) for p in self.polys])
        if puncture is None:
            pat = np.ones((self.n_out, 1), np.uint8)
        elif isinstance(puncture, str):
            if self.n_out != 2:
                raise ValueError("named puncture patterns assume a rate-1/2 mother code")
            pat = _PUNCTURE_PATTERNS.get(puncture)
            if pat is None:
                raise ValueError(f"unknown puncture pattern {puncture!r}; "
                                 f"choose from {sorted(_PUNCTURE_PATTERNS)}")
        else:
            pat = np.asarray(puncture, np.uint8)
            if pat.ndim != 2 or pat.shape[0] != self.n_out:
                raise ValueError(f"puncture pattern must be (n_out={self.n_out}, P)")
        self.puncture_pattern = pat
        self.rate = pat.shape[1] / float(pat.sum())

        # Trellis tables. Register r = (s << 1) | b, K bits with bit i
        # holding u_{n-i} (bit 0 = newest); next state t = r & (S-1), so
        # t's predecessors are p0 = t >> 1 and p1 = p0 + S/2, both with
        # input bit b = t & 1.
        g_ints = [int(np.sum(self._taps[j].astype(np.int64) << np.arange(self.k)))
                  for j in range(self.n_out)]

        def outs(reg):
            r = np.asarray(reg)[..., None] & np.array(g_ints)  # (..., n)
            o = np.zeros(r.shape, np.uint8)
            for i in range(self.k):
                o ^= ((r >> i) & 1).astype(np.uint8)
            return o

        t_all = np.arange(self.n_states)
        b_in = (t_all & 1).astype(np.int64)
        p0 = t_all >> 1
        p1 = p0 + self.n_states // 2
        self._prev0 = p0.astype(np.int32)
        self._prev1 = p1.astype(np.int32)
        o0, o1 = outs((p0 << 1) | b_in), outs((p1 << 1) | b_in)  # (S, n) bits
        # branch output signs (1-2c) for the p0->t and p1->t transitions
        self._sign0 = (1.0 - 2.0 * o0).astype(np.float32)
        self._sign1 = (1.0 - 2.0 * o1).astype(np.float32)
        # the same bits packed (bit j = stream j), the kernel's tables
        weights = 1 << np.arange(self.n_out)
        self._tables = {
            "sign0": torch.as_tensor(self._sign0, device=self.device),
            "sign1": torch.as_tensor(self._sign1, device=self.device),
            "out0": torch.as_tensor((o0 * weights).sum(-1).astype(np.int32), device=self.device),
            "out1": torch.as_tensor((o1 * weights).sum(-1).astype(np.int32), device=self.device),
        }

    # ------------------------------------------------------------ lengths

    def n_steps(self, n_bits: int) -> int:
        """Trellis steps for ``n_bits`` info bits (incl. K-1 tail zeros)."""
        return int(n_bits) + self.k - 1

    def _keep_mask(self, n_bits: int) -> np.ndarray:
        t = self.n_steps(n_bits)
        p = self.puncture_pattern.shape[1]
        # (T, n) mask, step-major like the coded stream
        return self.puncture_pattern.T[np.arange(t) % p].astype(bool)

    def coded_len(self, n_bits: int) -> int:
        """Wire bits produced by ``encode`` for ``n_bits`` info bits."""
        return int(self._keep_mask(n_bits).sum())

    # ------------------------------------------------------------- encode

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """Info bits (..., n_bits) uint8 -> coded bits (..., coded_len),
        zero-terminated then punctured. Host NumPy."""
        bits = np.asarray(bits)
        if bits.ndim == 0:
            raise ValueError("bits must have at least one axis")
        lead = bits.shape[:-1]
        n = bits.shape[-1]
        u = bits.reshape(-1, n).astype(np.uint8)
        # c_j = conv(u, taps_j) mod 2; 'full' length n+K-1 == T gives the
        # zero-termination tail for free.
        c = np.stack(
            [np.stack([np.convolve(row, self._taps[j]) % 2 for row in u])
             for j in range(self.n_out)], axis=-1)  # (B, T, n)
        keep = self._keep_mask(n)
        out = c[:, keep].astype(np.uint8)
        return out.reshape(*lead, -1)

    # ------------------------------------------------------------- decode

    def decode(self, soft, n_bits: int):
        """Soft-decision Viterbi decode.

        ``soft``: (..., coded_len(n_bits)) floats (NumPy or a tensor),
        positive => coded bit 0. Returns (..., n_bits) uint8 info bits as
        NumPy. Leading axes are decoded together: one kernel launch on the
        card."""
        soft = torch.as_tensor(soft, dtype=torch.float32, device=self.device)
        lead = tuple(soft.shape[:-1])
        want = self.coded_len(n_bits)
        if soft.shape[-1] != want:
            raise ValueError(
                f"soft stream has {soft.shape[-1]} values; "
                f"{n_bits} info bits need coded_len={want}")
        t = self.n_steps(n_bits)
        b = int(np.prod(lead, dtype=np.int64)) if lead else 1
        # depuncture: erased positions get metric 0 (no opinion)
        keep = torch.as_tensor(self._keep_mask(n_bits), device=self.device)
        full = torch.zeros((b, t, self.n_out), dtype=torch.float32, device=self.device)
        full[:, keep] = soft.reshape(b, -1)
        bits = viterbi(full, self._tables, self.k)
        return bits[:, :n_bits].cpu().numpy().reshape(*lead, n_bits)

    def decode_hard(self, coded_bits, n_bits: int):
        """Hard-decision decode: coded bits (..., coded_len) in {0,1}."""
        coded = np.asarray(coded_bits)
        return self.decode(1.0 - 2.0 * coded.astype(np.float32), n_bits)


def viterbi_plain(x: torch.Tensor, sign0: torch.Tensor, sign1: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Batched Viterbi, K3's plain version: x (B, T, n) branch observations
    -> (B, T) uint8 decisions (info bits incl. tail), one Python step a
    trellis step (``fec._viterbi``'s two scans)."""
    b, t, n = x.shape
    n_states = sign0.shape[0]
    dev = x.device
    prev0 = torch.arange(n_states, device=dev) >> 1
    prev1 = prev0 + n_states // 2
    pm = torch.full((b, n_states), _NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    decs = []
    for step in range(t):
        xk = x[:, step]
        bm0 = xk[:, 0:1] * sign0[:, 0]
        bm1 = xk[:, 0:1] * sign1[:, 0]
        for j in range(1, n):
            bm0 = bm0 + xk[:, j : j + 1] * sign0[:, j]
            bm1 = bm1 + xk[:, j : j + 1] * sign1[:, j]
        c0 = pm[:, prev0] + bm0
        c1 = pm[:, prev1] + bm1
        dec = c1 > c0
        pm = torch.where(dec, c1, c0)
        pm = pm - pm.amax(dim=-1, keepdim=True)
        decs.append(dec)
    state = torch.zeros(b, dtype=torch.int64, device=dev)  # zero-terminated
    bits = torch.empty((b, t), dtype=torch.uint8, device=dev)
    for step in range(t - 1, -1, -1):
        bits[:, step] = (state & 1).to(torch.uint8)
        won1 = torch.gather(decs[step], 1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (won1 << (k - 2))
    return bits


def viterbi(x: torch.Tensor, tables: dict, k: int) -> torch.Tensor:
    """x (B, T, n) -> (B, T) uint8: K3 on a CUDA tensor, its plain version
    on a CPU tensor. ``tables``: ``ConvCode``'s sign and packed-bit tables
    on x's device."""
    if launch.on_cpu("viterbi", x):
        return viterbi_plain(x, tables["sign0"], tables["sign1"], k)
    from tpu_sdr_torch.kernels.cuda.viterbi import viterbi_cuda

    return viterbi_cuda(x, tables["out0"], tables["out1"], k)


# --------------------------------------------------------- soft demapping


def max_log_llrs(s_re, s_im, points: np.ndarray, bit_lut: np.ndarray,
                 noise_var: float = 1.0, device=None):
    """Max-log-MAP bit LLRs from equalized symbols.

    ``points`` (M,) complex constellation, ``bit_lut`` (M, bps) the
    per-point bit labels (e.g. ``BurstModem.points`` / ``.bit_lut``).
    Returns (..., n_sym * bps) float32, positive => bit 0, on the symbols'
    device (tensors) or ``device`` (NumPy input; None: CUDA)."""
    if isinstance(s_re, torch.Tensor):
        dev = s_re.device
    else:
        dev = resolve_device(device, "max_log_llrs")
    s_re = torch.as_tensor(s_re, dtype=torch.float32, device=dev)
    s_im = torch.as_tensor(s_im, dtype=torch.float32, device=dev)
    pts = np.asarray(points)
    pt_re = torch.as_tensor(np.float32(pts.real), device=dev)
    pt_im = torch.as_tensor(np.float32(pts.imag), device=dev)
    d2 = (s_re[..., None] - pt_re) ** 2 + (s_im[..., None] - pt_im) ** 2
    bps = bit_lut.shape[1]
    llrs = []
    for i in range(bps):
        one = torch.as_tensor(np.asarray(bit_lut[:, i], bool), device=dev)
        d_one = torch.where(one, d2, torch.inf).amin(dim=-1)
        d_zero = torch.where(~one, d2, torch.inf).amin(dim=-1)
        llrs.append((d_one - d_zero) / float(noise_var))
    out = torch.stack(llrs, dim=-1)  # (..., n_sym, bps)
    return out.reshape(*out.shape[:-2], -1)


def modem_soft_bits(modem, sym_re, sym_im, noise_var: float = 1.0):
    """Bit LLRs for a coherent `BurstModem`'s recovered payload symbols
    (the ``symbols`` planes returned by ``demodulate``). Differential
    modems demap on phase increments: use hard decisions and
    `decode_hard` there."""
    if modem.differential:
        raise ValueError("soft demapping needs a coherent (differential=False) modem")
    return max_log_llrs(sym_re, sym_im, modem.points, modem.bit_lut,
                        noise_var=noise_var, device=modem.device)
