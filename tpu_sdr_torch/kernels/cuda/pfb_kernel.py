"""Fused PFB fold + M-point DFT (the counterpart of
``tpu_sdr.kernels.pallas.pfb_kernel``).

``pfb_fold_dft`` folds ``taps`` shifted rows of a (B, steps + taps - 1, m)
row array with the prototype h2 (taps, m) and returns A = folded @ cos and
B = folded @ sin (B negated with ``neg_b``). On a CUDA tensor it launches
``csrc/pfb_fold_dft.cu`` (m = 128): the fold in IEEE fp32, bit for bit the
plain version's, and both products on the tensor cores with each fp32
operand split into three bf16 pieces, six piece products a k-step
(``csrc/split_bf16.cuh``; ``tests/test_torch_pfb_split.py`` models it). On
a CPU tensor it runs ``pfb_fold_dft_plain``, the same fold followed by the
two products in fp32 through ``biquad._canonical_matmul``.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch

PRECISIONS = ("highest", "default")

# Every (rows, m) @ (m, m) product of the channelizer runs in calls of
# exactly this many rows (``biquad._canonical_matmul``), so that a step's
# bits do not depend on how many steps share the dispatch.
PRODUCT_ROWS = 2048

# The longest prototype the kernel takes, in taps.
MAX_KERNEL_TAPS = 256


def fold_rows(rows: torch.Tensor, h2: torch.Tensor, taps: int) -> torch.Tensor:
    """(..., steps + taps - 1, m) rows -> (..., steps, m): the weighted
    overlap-fold, acc = rows[t .. t + steps) * h2[t] summed over t in order."""
    steps = rows.shape[-2] - (taps - 1)
    acc = rows[..., 0:steps, :] * h2[0]
    for t in range(1, taps):
        acc = acc + rows[..., t : t + steps, :] * h2[t]
    return acc


def pfb_fold_dft_plain(rows, h2, cos, sin, taps: int, m: int, neg_b: bool = False):
    """The plain PyTorch version of ``pfb_fold_dft``: rows (B, R, m) ->
    (A, B) each (B, R - taps + 1, m)."""
    folded = fold_rows(rows, h2, taps)
    a = biquad._canonical_matmul(folded, cos, PRODUCT_ROWS)
    b = biquad._canonical_matmul(folded, sin, PRODUCT_ROWS)
    return a, -b if neg_b else b


def pfb_fold_dft_cuda(rows, h2, cos, sin, taps: int, neg_b: bool = False):
    """Launch ``csrc/pfb_fold_dft.cu`` on rows (B, R, 128) fp32 on a CUDA
    device. Raises if the kernel cannot be built or launched."""
    b, r, m = rows.shape
    device = rows.device
    if device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got rows on {device}")
    if m != 128:
        raise ValueError(f"the kernel takes m = 128 channels, got {m}")
    if not 1 <= taps <= min(r, MAX_KERNEL_TAPS):
        raise ValueError(f"the kernel takes 1 <= taps <= min(R={r}, {MAX_KERNEL_TAPS}), got {taps}")
    if b >= 65536 or b * r * m >= 2**31:
        raise ValueError(f"rows too large for one launch: {tuple(rows.shape)}")
    for name, v, shape in (("rows", rows, (b, r, m)), ("h2", h2, (taps, m)),
                           ("cos", cos, (m, m)), ("sin", sin, (m, m))):
        if v.device != device or v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(
                f"{name} must be {shape} float32 on {device}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}"
            )
    rows, h2, cos, sin = (launch.aligned(v) for v in (rows, h2, cos, sin))
    steps = r - taps + 1
    a = torch.empty((b, steps, m), dtype=torch.float32, device=device)
    bb = torch.empty((b, steps, m), dtype=torch.float32, device=device)
    launch.launch(
        "pfb_fold_dft", device,
        rows.data_ptr(), h2.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        a.data_ptr(), bb.data_ptr(), b, r, taps, int(neg_b),
    )
    return a, bb


def pfb_fold_dft(rows, h2, cos, sin, taps: int, m: int, group: int = 256,
                 interpret: bool = False, precision: str = "highest",
                 neg_b: bool = False):
    """rows (B, R, m) with R = steps + taps - 1 (history included) -> (A, B)
    each (B, steps, m), A = folded @ cos and B = folded @ sin (negated when
    ``neg_b``).

    ``group`` (the reference's steps per grid step) and ``precision`` are
    validated and accepted: the kernel's tile is its own and does not
    change the result, and every precision computes as "highest" does: the
    plain version in IEEE fp32, the kernel with six bf16 piece products.
    ``interpret`` has no meaning for a CUDA kernel: the plain version runs
    exactly when rows lie on the CPU, and ``interpret=True`` on a CUDA
    tensor raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if rows.dim() != 3 or rows.shape[-1] != m:
        raise ValueError(f"rows must be (B, R, {m}), got {tuple(rows.shape)}")
    if not 1 <= taps <= rows.shape[1] + 1:
        raise ValueError(f"need 1 <= taps <= R + 1 = {rows.shape[1] + 1}, got {taps}")
    if rows.shape[1] == taps - 1:  # no step: nothing to compute or launch
        empty = rows.new_empty((rows.shape[0], 0, m))
        return empty, empty.clone()
    if launch.on_cpu("pfb_fold_dft", rows, interpret):
        return pfb_fold_dft_plain(rows, h2, cos, sin, taps, m, neg_b)
    return pfb_fold_dft_cuda(rows, h2, cos, sin, taps, neg_b)
