"""Ethernet/IPv4/UDP header construction — byte parity with the reference MAC.

The reference streams a 42-byte header from a ROM (``imp/head_data.mif``) and
substitutes dynamic fields while serializing (``imp/phy_rmii_if.vhd:338-371``):
ip_total_length @16-17, IP-ID = frame counter @18-19, ip_checksum @24-25,
udp_length @38-39. The UDP checksum is transmitted as 0 (the hardware has an
unused checksum engine, ``imp/udp_utils.vhd``). This module reproduces those
bytes exactly, so a packet built here + payload + FCS equals what the FPGA
puts on the wire — verified against the ROM constants in tests.
"""

from __future__ import annotations

import dataclasses
import struct

# head_data.mif constants (SURVEY.md §2.4 table)
DST_MAC = bytes.fromhex("FFFFFFFFFFFF")
SRC_MAC = bytes.fromhex("001122334455")
ETHERTYPE_IPV4 = 0x0800
SRC_IP = "169.254.252.255"
DST_IP = "255.255.255.255"
SRC_PORT = 5005
DST_PORT = 6006
TTL = 64
PROTO_UDP = 0x11
HEADER_LEN = 42


def ip_checksum(header: bytes) -> int:
    """RFC 1071 ones-complement sum over the IPv4 header, checksum field
    zeroed — the same computation as ``src/ip_checksum.vhd:44-73``."""
    if len(header) % 2:
        header += b"\x00"
    s = 0
    for i in range(0, len(header), 2):
        if i == 10:  # checksum field position within the IP header
            continue
        s += (header[i] << 8) | header[i + 1]
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def _ip_to_bytes(ip: str) -> bytes:
    return bytes(int(p) for p in ip.split("."))


@dataclasses.dataclass
class HeaderConfig:
    dst_mac: bytes = DST_MAC
    src_mac: bytes = SRC_MAC
    src_ip: str = SRC_IP
    dst_ip: str = DST_IP
    src_port: int = SRC_PORT
    dst_port: int = DST_PORT
    ttl: int = TTL


def build_header(
    payload_len: int, frame_id: int, cfg: HeaderConfig | None = None
) -> bytes:
    """The 42 wire-header bytes for one UDP datagram.

    ``frame_id`` lands in the IPv4 Identification field — the RTL increments
    it per transmitted Ethernet frame (``imp/phy_rmii_if.vhd:434``).
    """
    cfg = cfg or HeaderConfig()
    udp_len = 8 + payload_len
    ip_len = 20 + udp_len

    eth = cfg.dst_mac + cfg.src_mac + struct.pack(">H", ETHERTYPE_IPV4)
    ip_wo_csum = struct.pack(
        ">BBHHHBBH4s4s",
        0x45,  # version + IHL
        0x00,  # DSCP/ECN
        ip_len,
        frame_id & 0xFFFF,
        0x0000,  # flags/fragment
        cfg.ttl,
        PROTO_UDP,
        0,  # checksum placeholder
        _ip_to_bytes(cfg.src_ip),
        _ip_to_bytes(cfg.dst_ip),
    )
    csum = ip_checksum(ip_wo_csum)
    ip = ip_wo_csum[:10] + struct.pack(">H", csum) + ip_wo_csum[12:]
    # UDP checksum transmitted as 0, like the hardware.
    udp = struct.pack(">HHHH", cfg.src_port, cfg.dst_port, udp_len, 0)
    hdr = eth + ip + udp
    assert len(hdr) == HEADER_LEN
    return hdr


def build_ethernet_frame(
    payload: bytes, frame_id: int, cfg: HeaderConfig | None = None
) -> bytes:
    """Full wire frame incl. FCS (excl. preamble/SFD, which are PHY-level)."""
    from tpu_sdr_torch.transport.crc32 import fcs_bytes

    body = build_header(len(payload), frame_id, cfg) + payload
    return body + fcs_bytes(body)


def udp_checksum(
    payload: bytes,
    src_ip: str = SRC_IP,
    dst_ip: str = DST_IP,
    src_port: int = SRC_PORT,
    dst_port: int = DST_PORT,
) -> int:
    """Full pseudo-header UDP checksum incl. the 0 -> 0xFFFF rule.

    The reference carries an equivalent (unused) engine in
    ``imp/udp_utils.vhd:24-139`` and transmits 0 on the wire; provided here
    for completeness and for validating frames from standards-compliant
    senders.
    """
    udp_len = 8 + len(payload)
    pseudo = (
        _ip_to_bytes(src_ip)
        + _ip_to_bytes(dst_ip)
        + struct.pack(">BBH", 0, PROTO_UDP, udp_len)
    )
    udp_hdr = struct.pack(">HHHH", src_port, dst_port, udp_len, 0)
    data = pseudo + udp_hdr + payload
    if len(data) % 2:
        data += b"\x00"
    s = 0
    for i in range(0, len(data), 2):
        s += (data[i] << 8) | data[i + 1]
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    csum = (~s) & 0xFFFF
    return 0xFFFF if csum == 0 else csum


def parse_header(frame: bytes) -> dict:
    """Parse + validate the 42-byte header; returns fields incl. checksum_ok."""
    if len(frame) < HEADER_LEN:
        raise ValueError("frame shorter than header")
    eth_type = struct.unpack(">H", frame[12:14])[0]
    ip = frame[14:34]
    version_ihl, _, ip_len, ident, _, ttl, proto, csum = struct.unpack(
        ">BBHHHBBH", ip[:12]
    )
    src_ip = ".".join(str(b) for b in ip[12:16])
    dst_ip = ".".join(str(b) for b in ip[16:20])
    sport, dport, udp_len, udp_csum = struct.unpack(">HHHH", frame[34:42])
    return {
        "ethertype": eth_type,
        "ip_len": ip_len,
        "ip_id": ident,
        "ttl": ttl,
        "proto": proto,
        "src_ip": src_ip,
        "dst_ip": dst_ip,
        "src_port": sport,
        "dst_port": dport,
        "udp_len": udp_len,
        "udp_checksum": udp_csum,
        "checksum_ok": ip_checksum(ip) == csum,
    }
