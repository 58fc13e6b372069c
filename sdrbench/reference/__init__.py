"""The plain reference of the spectrum chain, in float64 NumPy and SciPy.

It imports nothing of the system under test: it works out the window, each
channel's IIR with its state carried across frames, the FFT and the
magnitude again from the samples and the SOS it is handed. ``precision="tf32"``
is the control: the same chain with every operand rounded to TF32 and the
arithmetic in float32, the precision just below the configuration's IEEE fp32
with TF32 off.
"""

from sdrbench.reference.chain import (
    hann,
    magnitudes_complex,
    magnitudes_real,
    settle_frames,
    to_tf32,
)

__all__ = ["hann", "magnitudes_complex", "magnitudes_real", "settle_frames", "to_tf32"]
