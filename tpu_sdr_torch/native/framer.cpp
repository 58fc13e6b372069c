// Native host-edge hot path: spectrum quantize/interleave, packetize, CRC32.
//
// The reference performs these per-byte operations in hardware (the RMII
// serializer + CRC engine, imp/phy_rmii_if.vhd / imp/crc_generator.vhd);
// here they are the host-side cost of emitting the GUI wire format at
// multi-GSPS spectrum rates, so they get a C++ implementation (exposed via
// ctypes; the NumPy versions in framing.py and crc32.py are the oracle).
//
// The port's copy of tpu_sdr/transport/native/framer.cpp. It is built with
// the host C++ compiler on first use (tpu_sdr_torch/transport/native.py,
// into build/tpu_sdr_torch/, named by a hash of this source and the flags).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

#include <arpa/inet.h>
#include <cerrno>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// Bumped whenever the exported symbol set changes (the library's file name
// already changes with the source; native.py checks this too).
int framer_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3, reflected), slicing-by-8
// ---------------------------------------------------------------------------

static uint32_t crc_tab[8][256];

static void crc_init() {
    for (int i = 0; i < 256; ++i) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (c >> 1) ^ 0xEDB88320u : (c >> 1);
        crc_tab[0][i] = c;
    }
    for (int i = 0; i < 256; ++i)
        for (int t = 1; t < 8; ++t)
            crc_tab[t][i] =
                (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
}

static void crc_ensure_init() {
    // C++11 magic static: thread-safe one-time init. ctypes releases the
    // GIL, so two threads CAN make their first CRC call concurrently; the
    // previous plain-bool lazy flag was a formal data race.
    static const bool once = (crc_init(), true);
    (void)once;
}

// Raw (non-inverted) running CRC — the checker form (crc32_checker.vhd:27).
uint32_t crc32_raw(const uint8_t* data, uint64_t n, uint32_t crc) {
    crc_ensure_init();
    uint32_t c = crc;
    while (n >= 8) {
        uint32_t lo, hi;
        std::memcpy(&lo, data, 4);
        std::memcpy(&hi, data + 4, 4);
        lo ^= c;
        c = crc_tab[7][lo & 0xFF] ^ crc_tab[6][(lo >> 8) & 0xFF] ^
            crc_tab[5][(lo >> 16) & 0xFF] ^ crc_tab[4][lo >> 24] ^
            crc_tab[3][hi & 0xFF] ^ crc_tab[2][(hi >> 8) & 0xFF] ^
            crc_tab[1][(hi >> 16) & 0xFF] ^ crc_tab[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    while (n--) c = crc_tab[0][(c ^ *data++) & 0xFF] ^ (c >> 8);
    return c;
}

// Final (inverted) Ethernet CRC — the generator form (crc_generator.vhd:84-86).
uint32_t crc32_eth(const uint8_t* data, uint64_t n, uint32_t crc) {
    return crc32_raw(data, n, crc) ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Spectrum -> wire frame: scale, round, saturate, interleave {re, im} LE int16
// ---------------------------------------------------------------------------

void quantize_interleave(const float* re, const float* im, int16_t* out,
                         uint64_t n_bins, float scale) {
    for (uint64_t i = 0; i < n_bins; ++i) {
        float r = std::nearbyint(re[i] * scale);
        float m = std::nearbyint(im[i] * scale);
        r = std::min(32767.0f, std::max(-32768.0f, r));
        m = std::min(32767.0f, std::max(-32768.0f, m));
        out[2 * i] = (int16_t)r;
        out[2 * i + 1] = (int16_t)m;
    }
}

// ---------------------------------------------------------------------------
// Frame -> 64 x (1 + 1024) payloads, count byte = packet index mod 64
// (imp/phy_rmii_if.vhd:322)
// ---------------------------------------------------------------------------

void packetize(const uint8_t* frame, uint8_t* out, uint32_t packets,
               uint32_t data_size) {
    for (uint32_t k = 0; k < packets; ++k) {
        uint8_t* p = out + (uint64_t)k * (data_size + 1);
        p[0] = (uint8_t)(k % 64);
        std::memcpy(p + 1, frame + (uint64_t)k * data_size, data_size);
    }
}

// Reassemble payloads (any order). Returns number of distinct slots filled.
// A count byte >= 64 is invalid on this wire (the FPGA's mark_cnt is mod-64,
// imp/phy_rmii_if.vhd:322) and the packet is DROPPED, matching the Python
// MultiPacketAssembler/packets_to_frame — aliasing it into slot p[0] % 64
// would silently overwrite a genuine packet's data (the UDP checksum is 0
// on this wire, so corruption reaches this layer).
uint32_t assemble(const uint8_t* payloads, uint32_t count, uint32_t data_size,
                  uint8_t* frame_out) {
    uint64_t seen = 0;
    uint32_t filled = 0;
    for (uint32_t i = 0; i < count; ++i) {
        const uint8_t* p = payloads + (uint64_t)i * (data_size + 1);
        uint32_t slot = p[0];
        if (slot >= 64) continue;
        if (!(seen >> slot & 1)) {
            seen |= 1ull << slot;
            ++filled;
        }
        std::memcpy(frame_out + (uint64_t)slot * data_size, p + 1, data_size);
    }
    return filled;
}

// ---------------------------------------------------------------------------
// Batch UDP transport: one sendmmsg/recvmmsg syscall per spectrum burst.
//
// The reference drains a whole 64-packet spectrum frame back-to-back in
// hardware (imp/sequ2.vhd Ethernet FSM + imp/phy_rmii_if.vhd auto-restart,
// :421-437); the host-edge analog is a single sendmmsg of all 64 datagrams
// with zero-copy iovecs straight into the frame buffer (count byte + data,
// the payload layout of imp/phy_rmii_if.vhd:322).
// All functions return >=0 on success, -errno on failure.
// ---------------------------------------------------------------------------

static const uint32_t kMaxBurst = 256;

// Connected UDP socket towards ip:port (SO_BROADCAST on, like the FPGA's
// fixed broadcast destination from head_data.mif).
int udp_open(const char* ip, uint16_t port, uint32_t sndbuf) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_BROADCAST, &one, sizeof one);
    if (sndbuf)
        setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sndbuf, sizeof sndbuf);
    sockaddr_in a;
    std::memset(&a, 0, sizeof a);
    a.sin_family = AF_INET;
    a.sin_port = htons(port);
    if (inet_pton(AF_INET, ip, &a.sin_addr) != 1) {
        close(fd);
        return -EINVAL;
    }
    if (connect(fd, (sockaddr*)&a, sizeof a) < 0) {
        int e = errno;
        close(fd);
        return -e;
    }
    return fd;
}

// Send one wire frame as `packets` datagrams of (1 + data_size) bytes each:
// count byte k%64 followed by frame[k*data_size : (k+1)*data_size], without
// materializing the packets (two iovecs per datagram). Returns packets sent.
int udp_send_frame(int fd, const uint8_t* frame, uint32_t packets,
                   uint32_t data_size) {
    if (packets == 0 || packets > kMaxBurst) return -EINVAL;
    uint8_t counts[kMaxBurst];
    iovec iov[kMaxBurst][2];
    mmsghdr msgs[kMaxBurst];
    std::memset(msgs, 0, packets * sizeof(mmsghdr));
    for (uint32_t k = 0; k < packets; ++k) {
        counts[k] = (uint8_t)(k % 64);
        iov[k][0].iov_base = &counts[k];
        iov[k][0].iov_len = 1;
        iov[k][1].iov_base = (void*)(frame + (uint64_t)k * data_size);
        iov[k][1].iov_len = data_size;
        msgs[k].msg_hdr.msg_iov = iov[k];
        msgs[k].msg_hdr.msg_iovlen = 2;
    }
    uint32_t sent = 0;
    while (sent < packets) {
        int r = sendmmsg(fd, msgs + sent, packets - sent, 0);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        sent += (uint32_t)r;
    }
    return (int)sent;
}

// Bound (receiving) UDP socket.
int udp_bind(const char* ip, uint16_t port, uint32_t rcvbuf) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return -errno;
    if (rcvbuf)
        setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof rcvbuf);
    sockaddr_in a;
    std::memset(&a, 0, sizeof a);
    a.sin_family = AF_INET;
    a.sin_port = htons(port);
    if (inet_pton(AF_INET, ip, &a.sin_addr) != 1) {
        close(fd);
        return -EINVAL;
    }
    if (bind(fd, (sockaddr*)&a, sizeof a) < 0) {
        int e = errno;
        close(fd);
        return -e;
    }
    return fd;
}

int udp_local_port(int fd) {
    sockaddr_in a;
    socklen_t len = sizeof a;
    if (getsockname(fd, (sockaddr*)&a, &len) < 0) return -errno;
    return (int)ntohs(a.sin_port);
}

// Drain up to max_pkts waiting datagrams in one recvmmsg. Blocks at most
// timeout_ms for the FIRST datagram (poll; recvmmsg's own timeout argument
// notoriously does not bound the wait for the first message), then takes
// whatever is already queued without further blocking. Per packet i:
// payload -> out[i*buf_size ...], lens[i] = datagram length (truncated to
// buf_size), srcs[6*i ...] = {ipv4 be32, port be16}. Returns packet count
// (0 on timeout).
int udp_recv_burst(int fd, uint8_t* out, uint32_t* lens, uint8_t* srcs,
                   uint32_t max_pkts, uint32_t buf_size, int timeout_ms) {
    if (max_pkts == 0 || max_pkts > kMaxBurst) return -EINVAL;
    pollfd p;
    p.fd = fd;
    p.events = POLLIN;
    p.revents = 0;
    int pr = poll(&p, 1, timeout_ms);
    if (pr == 0) return 0;
    if (pr < 0) return errno == EINTR ? 0 : -errno;
    iovec iov[kMaxBurst];
    mmsghdr msgs[kMaxBurst];
    sockaddr_in addrs[kMaxBurst];
    std::memset(msgs, 0, max_pkts * sizeof(mmsghdr));
    for (uint32_t i = 0; i < max_pkts; ++i) {
        iov[i].iov_base = out + (uint64_t)i * buf_size;
        iov[i].iov_len = buf_size;
        msgs[i].msg_hdr.msg_iov = &iov[i];
        msgs[i].msg_hdr.msg_iovlen = 1;
        msgs[i].msg_hdr.msg_name = &addrs[i];
        msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    }
    int r = recvmmsg(fd, msgs, max_pkts, MSG_DONTWAIT, nullptr);
    if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
            return 0;
        return -errno;
    }
    for (int i = 0; i < r; ++i) {
        lens[i] = std::min(msgs[i].msg_len, buf_size);
        std::memcpy(srcs + 6 * i, &addrs[i].sin_addr, 4);
        std::memcpy(srcs + 6 * i + 4, &addrs[i].sin_port, 2);
    }
    return r;
}

int udp_close(int fd) { return close(fd) < 0 ? -errno : 0; }

}  // extern "C"
