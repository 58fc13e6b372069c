"""ctypes bindings for the C++ framer (the counterpart of
``tpu_sdr.transport.native``).

``native/framer.cpp`` (the port's copy of the reference's source) is built
with the host C++ compiler on first use into ``build/tpu_sdr_torch/``, the
file named by a hash of the source and the flags, as ``kernels/native_q15``
builds its library. A missing compiler or a failed build raises: unlike the
reference, which warns and falls back to NumPy, nothing here runs without
the library. The NumPy versions (``framing.py``, ``crc32.py``) stay public
and are the oracle the tests hold these functions to.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_sdr_torch.kernels.cuda import loader

SOURCE = Path(__file__).resolve().parents[1] / "native" / "framer.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-fPIC", "-shared"]
ABI_VERSION = 2

_lib = None
_load_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of ``native/framer.cpp`` and ``CXX_FLAGS`` lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + b"\0" + " ".join(CXX_FLAGS).encode())
    return loader.BUILD_DIR / f"libframer-{key.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found (CXX, g++, c++, clang++): the native framer "
                       "is built from source on first use")


def build(force: bool = False) -> str:
    """Compile the framer unless its library exists; returns the compiler's
    output ("" when nothing was built), raises RuntimeError if it fails."""
    lib = library_path()
    if lib.exists() and not force:
        return ""
    loader.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"native framer build failed: exit {proc.returncode}\n{log}")
    os.replace(tmp, lib)
    return log


def _load() -> ctypes.CDLL:
    # Serialized: concurrent first calls (a sender on the main thread while
    # a receiver worker reaches the module) build and load once.
    global _lib
    with _load_lock:
        if _lib is None:
            build()
            _lib = _bind(ctypes.CDLL(str(library_path())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.crc32_raw.restype = ctypes.c_uint32
    lib.crc32_raw.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
    ]
    lib.crc32_eth.restype = ctypes.c_uint32
    lib.crc32_eth.argtypes = lib.crc32_raw.argtypes
    lib.quantize_interleave.restype = None
    lib.quantize_interleave.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint64,
        ctypes.c_float,
    ]
    lib.packetize.restype = None
    lib.packetize.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.assemble.restype = ctypes.c_uint32
    lib.assemble.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.framer_abi_version.restype = ctypes.c_int
    if lib.framer_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native framer ABI {lib.framer_abi_version()} != {ABI_VERSION}")
    lib.udp_open.restype = ctypes.c_int
    lib.udp_open.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32]
    lib.udp_send_frame.restype = ctypes.c_int
    lib.udp_send_frame.argtypes = [
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.udp_bind.restype = ctypes.c_int
    lib.udp_bind.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint32]
    lib.udp_local_port.restype = ctypes.c_int
    lib.udp_local_port.argtypes = [ctypes.c_int]
    lib.udp_recv_burst.restype = ctypes.c_int
    lib.udp_recv_burst.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_int,
    ]
    lib.udp_close.restype = ctypes.c_int
    lib.udp_close.argtypes = [ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the framer builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def crc32_ethernet(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    return _load().crc32_eth(data, len(data), crc)


def crc32_raw(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    return _load().crc32_raw(data, len(data), crc)


def spectrum_to_frame_bytes(re, im, scale: float | None = None) -> bytes:
    from tpu_sdr_torch.transport import framing

    if scale is None:
        scale = framing.XFFT_WIRE_SCALE
    re_a = np.asarray(re)
    im_a = np.asarray(im)
    if re_a.dtype != np.float32 or im_a.dtype != np.float32:
        # A non-f32 spectrum rounds in its own precision, as the NumPy
        # framer does: coercing float64 to f32 first moves some words by
        # 1 LSB.
        return framing.spectrum_to_frame_bytes(re_a, im_a, scale)
    lib = _load()
    re = np.ascontiguousarray(re_a, dtype=np.float32)
    im = np.ascontiguousarray(im_a, dtype=np.float32)
    if re.shape != im.shape or re.ndim != 1:
        raise ValueError(f"re/im must be equal-length 1-D, got {re.shape}/{im.shape}")
    if re.shape[-1] != framing.N_BINS:
        raise ValueError(f"expected {framing.N_BINS} bins, got {re.shape[-1]}")
    out = np.empty(2 * re.shape[-1], dtype=np.int16)
    lib.quantize_interleave(
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        re.shape[-1],
        scale,
    )
    return out.tobytes()


def frame_to_packets(frame: bytes, packets: int = 64, data_size: int = 1024):
    lib = _load()
    if len(frame) != packets * data_size:
        raise ValueError(
            f"frame must be {packets * data_size} bytes, got {len(frame)}"
        )
    out = np.empty(packets * (data_size + 1), dtype=np.uint8)
    lib.packetize(
        frame, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), packets, data_size
    )
    raw = out.tobytes()
    step = data_size + 1
    return [raw[i * step : (i + 1) * step] for i in range(packets)]


def assemble_payloads(payloads, data_size: int = 1024):
    """Lenient batch reassembly: (frame_bytes, filled_slot_count).

    ``MultiPacketAssembler``'s drop semantics: payloads whose count byte is
    >= 64 are DROPPED (invalid on this wire; the UDP checksum is 0, so
    corruption reaches this layer), never aliased into a valid slot. The
    caller decides whether filled < 64 is an error; the strict raising
    variant is ``framing.packets_to_frame``.
    """
    from tpu_sdr_torch.transport import framing

    n = framing.PACKETS_PER_FRAME
    step = data_size + 1
    lib = _load()
    for p in payloads:
        # per payload: a 1024 + 1026 pair sums to 2 x 1025 and would pass a
        # total-length check, then be misparsed at fixed strides
        if len(p) != step:
            raise ValueError(f"every payload must be {step} bytes")
    buf = b"".join(payloads)
    out = np.zeros(n * data_size, dtype=np.uint8)
    filled = lib.assemble(
        buf,
        len(payloads),
        data_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.tobytes(), int(filled)


def udp_available() -> bool:
    """True: the batch-UDP (sendmmsg/recvmmsg) entry points are part of the
    library (built on first use; raises if it cannot be)."""
    _load()
    return True


def _check(ret: int, what: str) -> int:
    if ret < 0:
        raise OSError(-ret, f"{what}: {os.strerror(-ret)}")
    return ret


class NativeUdpSender:
    """Connected UDP socket that transmits a whole wire frame (64 packets)
    with one sendmmsg syscall — the host-edge analog of the FPGA's
    back-to-back frame drain (imp/sequ2.vhd / imp/phy_rmii_if.vhd:421-437)."""

    def __init__(self, host: str, port: int, sndbuf: int = 1 << 22):
        lib = _load()
        self._lib = lib
        self.fd = _check(
            lib.udp_open(host.encode(), port, sndbuf), f"udp_open {host}:{port}"
        )

    def send_frame(self, frame: bytes, packets: int = 64, data_size: int = 1024):
        if len(frame) != packets * data_size:
            raise ValueError(
                f"frame must be {packets * data_size} bytes, got {len(frame)}"
            )
        ret = self._lib.udp_send_frame(self.fd, frame, packets, data_size)
        if ret == -errno.ECONNREFUSED:
            # Fire-and-forget contract (no retransmit, like the FPGA's
            # wire): a connected UDP socket surfaces the receiver's ICMP
            # port-unreachable as ECONNREFUSED on the NEXT send, which
            # would crash a streaming loop the moment the GUI detaches —
            # the unconnected sendto fallback never sees this, so the
            # native path must not either (review finding). The error is
            # consumed by this send; subsequent sends proceed normally.
            return 0
        return _check(ret, "udp_send_frame")

    def close(self):
        if self.fd >= 0:
            self._lib.udp_close(self.fd)
            self.fd = -1


class NativeUdpSocket:
    """Bound UDP socket draining bursts of datagrams with one recvmmsg
    syscall. ``recv_burst`` returns ``[(payload, (src_ip, src_port)), ...]``
    — source filtering/policy stays with the caller, like the GUI's."""

    def __init__(
        self,
        port: int = 0,
        bind_ip: str = "0.0.0.0",
        rcvbuf: int = 1 << 22,
        max_pkts: int = 128,
        buf_size: int = 2048,
    ):
        lib = _load()
        self._lib = lib
        self.fd = _check(
            lib.udp_bind(bind_ip.encode(), port, rcvbuf), f"udp_bind {bind_ip}:{port}"
        )
        self.max_pkts = max_pkts
        self.buf_size = buf_size
        self._buf = np.empty(max_pkts * buf_size, dtype=np.uint8)
        self._lens = np.empty(max_pkts, dtype=np.uint32)
        self._srcs = np.empty(max_pkts * 6, dtype=np.uint8)

    @property
    def port(self) -> int:
        return _check(self._lib.udp_local_port(self.fd), "udp_local_port")

    def recv_burst(self, timeout: float = 0.25):
        import socket as _socket

        n = _check(
            self._lib.udp_recv_burst(
                self.fd,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                self._srcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.max_pkts,
                self.buf_size,
                max(0, int(round(timeout * 1000))),
            ),
            "udp_recv_burst",
        )
        out = []
        for i in range(n):
            ln = int(self._lens[i])
            payload = self._buf[i * self.buf_size : i * self.buf_size + ln].tobytes()
            src_ip = _socket.inet_ntoa(self._srcs[6 * i : 6 * i + 4].tobytes())
            src_port = int.from_bytes(self._srcs[6 * i + 4 : 6 * i + 6], "big")
            out.append((payload, (src_ip, src_port)))
        return out

    def close(self):
        if self.fd >= 0:
            self._lib.udp_close(self.fd)
            self.fd = -1
