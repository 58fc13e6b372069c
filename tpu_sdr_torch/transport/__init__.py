"""The host-edge transport: wire framing, UDP and UART streams, the serial
port, CRC32 and the IP stack (the port's copy of ``tpu_sdr.transport``,
with its own native framer, ``native/framer.cpp``)."""

from tpu_sdr_torch.transport.framing import (  # noqa: F401
    FRAME_SIZE_BYTES,
    PACKETS_PER_FRAME,
    PACKET_DATA_SIZE,
    XFFT_WIRE_SCALE,
    MultiPacketAssembler,
    decode_frame,
    frame_bytes_from_q15,
    frame_to_packets,
    packets_to_frame,
    quantize_spectrum_q15,
    spectrum_to_frame_bytes,
)
from tpu_sdr_torch.transport.crc32 import crc32_ethernet  # noqa: F401
from tpu_sdr_torch.transport.serial_port import (  # noqa: F401
    FdSerial,
    SerialTransport,
    make_raw_pty,
    open_serial,
)
