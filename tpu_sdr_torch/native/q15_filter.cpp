// Native Q15 integer SOS filter — the host-side hot loop of the
// hardware-faithful split pipeline (runtime/q15.py, device_fft=True).
// A copy of tpu_sdr/kernels/native/q15_filter.cpp, built by
// tpu_sdr_torch/kernels/native_q15.py.
//
// Bit-exact implementation of the 'intended' fixed-point semantics the
// NumPy oracle defines (control/golden.sosfilt_q15_intended, mirroring
// the reference RTL's custom-coefficient cascade src/filter_iir12_cust.vhd
// with the intended /64 scale): int8 x64 coefficients as int64, products
// accumulated in int64, each section output scaled by >>6 with
// round-half-away-from-zero, saturated to int16. The per-sample, per-
// section recurrence is inherently sequential (saturation is nonlinear),
// which is why it lives in C++ rather than in tensor operations: a Python
// loop over the samples is far too slow for the live filtered mode.
//
// Contract notes:
//  - sos rows are [b0, b1, b2, a0, a1, a2] with a0 == 64 (validated by the
//    caller; enforced here too — returns -1 so a bad call cannot silently
//    produce non-faithful bits);
//  - z is the (n_sections, 2) int64 pre-shift accumulator state, updated
//    in place (same layout as the oracle's zf);
//  - batch variant filters R independent rows with per-row state.

#include <cstdint>

namespace {

inline int64_t rshift_half_away6(int64_t v) {
    // arithmetic >>6 with round-half-away-from-zero (qformat.rshift_round_half_away)
    return v >= 0 ? (v + 32) >> 6 : -(((-v) + 32) >> 6);
}

inline int64_t sat16(int64_t v) {
    if (v > 32767) return 32767;
    if (v < -32768) return -32768;
    return v;
}

}  // namespace

extern "C" {

// One row: x (n) int16 -> y (n) int16; z (n_sections*2) int64 in/out.
// Returns 0, or -1 when any a0 != 64.
int sosfilt_q15(const int64_t* sos, int n_sections, const int16_t* x,
                int64_t n, int64_t* z, int16_t* y) {
    for (int s = 0; s < n_sections; ++s) {
        if (sos[s * 6 + 3] != 64) return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t v = x[i];
        for (int s = 0; s < n_sections; ++s) {
            const int64_t* c = sos + s * 6;
            int64_t* zs = z + s * 2;
            int64_t out = sat16(rshift_half_away6(c[0] * v + zs[0]));
            zs[0] = c[1] * v - c[4] * out + zs[1];
            zs[1] = c[2] * v - c[5] * out;
            v = out;
        }
        y[i] = static_cast<int16_t>(v);
    }
    return 0;
}

// R independent rows (channels), contiguous x/y (R, n) and z (R, S, 2).
int sosfilt_q15_batch(const int64_t* sos, int n_sections, const int16_t* x,
                      int64_t rows, int64_t n, int64_t* z, int16_t* y) {
    for (int64_t r = 0; r < rows; ++r) {
        int rc = sosfilt_q15(sos, n_sections, x + r * n, n,
                             z + r * n_sections * 2, y + r * n);
        if (rc != 0) return rc;
    }
    return 0;
}

// Fused RTL window + filter, one pass over the samples (a separate window
// pass over the chunk would cost about as much as the filter itself).
//
// Window semantics are bit-exact core/qformat.window_multiply_q15
// (src/hann8192.vhd:36-39): p = x*w in int32; out = (p >> 15) +
// ((p >> 14) & 1), wrapped to int16. rom has rom_n entries; the sample at
// stream index i uses rom[(phase + i) % rom_n] (frame-aligned chunks pass
// phase = 0). yw (the windowed intermediate, the pipeline's
// ``windowed_q15`` product) is stored when non-null.
int sosfilt_q15_window(const int64_t* sos, int n_sections, const int16_t* x,
                       int64_t n, const int16_t* rom, int64_t rom_n,
                       int64_t phase, int64_t* z, int16_t* yw, int16_t* y) {
    for (int s = 0; s < n_sections; ++s) {
        if (sos[s * 6 + 3] != 64) return -1;
    }
    int64_t k = phase % rom_n;
    for (int64_t i = 0; i < n; ++i) {
        int32_t p = static_cast<int32_t>(x[i]) * static_cast<int32_t>(rom[k]);
        int16_t w = static_cast<int16_t>((p >> 15) + ((p >> 14) & 1));
        if (yw) yw[i] = w;
        if (++k == rom_n) k = 0;
        int64_t v = w;
        for (int s = 0; s < n_sections; ++s) {
            const int64_t* c = sos + s * 6;
            int64_t* zs = z + s * 2;
            int64_t out = sat16(rshift_half_away6(c[0] * v + zs[0]));
            zs[0] = c[1] * v - c[4] * out + zs[1];
            zs[1] = c[2] * v - c[5] * out;
            v = out;
        }
        y[i] = static_cast<int16_t>(v);
    }
    return 0;
}

int sosfilt_q15_window_batch(const int64_t* sos, int n_sections,
                             const int16_t* x, int64_t rows, int64_t n,
                             const int16_t* rom, int64_t rom_n, int64_t phase,
                             int64_t* z, int16_t* yw, int16_t* y) {
    for (int64_t r = 0; r < rows; ++r) {
        int rc = sosfilt_q15_window(sos, n_sections, x + r * n, n, rom, rom_n,
                                    phase, z + r * n_sections * 2,
                                    yw ? yw + r * n : nullptr, y + r * n);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // extern "C"
