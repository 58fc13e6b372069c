"""Ethernet CRC-32 (IEEE 802.3) — parity with the reference MAC.

The reference computes the FCS in hardware with byte-parallel XOR equations
(``imp/crc_generator.vhd:23-86``: input bit-reversal, init-to-ones, final
NOT + bit-reverse) and verifies received frames against the magic residue
0xC704DD7B (``imp/phy_rmii_if.vhd:529``). Both conventions are reproduced
here (table-driven reflected implementation — same math, software-shaped);
the C++ native layer implements the same with slicing-by-8.
"""

from __future__ import annotations


_POLY_REFLECTED = 0xEDB88320
# Residue of the reflected running register over (frame + correct FCS).
# The RTL compares its MSB-first register against 0xC704DD7B
# (imp/phy_rmii_if.vhd:529); that constant is exactly the bit-reversal of
# this one — same check, different register convention.
RESIDUE_MAGIC = 0xDEBB20E3
RESIDUE_MAGIC_RTL = 0xC704DD7B
assert int(f"{RESIDUE_MAGIC:032b}"[::-1], 2) == RESIDUE_MAGIC_RTL


def _make_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY_REFLECTED if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32_ethernet(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    """Standard Ethernet CRC-32 of ``data`` (final XOR applied).

    Equivalent to the hardware generator's output
    (``imp/crc_generator.vhd:84-86``): init all-ones, reflected processing,
    final inversion. The returned value is appended little-endian as the FCS.
    """
    return crc32_update_raw(data, crc) ^ 0xFFFFFFFF


def crc32_update_raw(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    """Running CRC without the final inversion — the checker's form
    (``imp/crc32_checker.vhd:27``)."""
    c = crc
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
        c &= 0xFFFFFFFF
    return c


def fcs_bytes(data: bytes) -> bytes:
    """The 4 FCS bytes to append to an Ethernet frame (LE byte order)."""
    return crc32_ethernet(data).to_bytes(4, "little")


def check_frame(frame_with_fcs: bytes) -> bool:
    """Verify a received frame the way the RTL does: the running (raw) CRC
    over frame+FCS equals the magic residue (``imp/phy_rmii_if.vhd:529``)."""
    return crc32_update_raw(frame_with_fcs) == RESIDUE_MAGIC
