// Batched block checksums — the libglusterfs checksum.c workload
// (gf_rchecksum weak sums) as a native batch kernel: one call
// checksums thousands of equal-size blocks (the scrubber/heal
// handshake regime), auto-vectorized by -O3 -mavx2.
//
// Adler-32 (zlib-compatible) decomposes into two weighted sums:
//   A = 1 + sum(d_i)                   (mod 65521)
//   B = blen + sum((blen - i) * d_i)   (mod 65521)
// which lets the whole block reduce with multiply-accumulate loops
// instead of the serial a+=d; b+=a; recurrence.  64-bit accumulators
// hold exactly while blen^2 * 255 < 2^63, i.e. blocks up to ~180 MiB.

#include <cstddef>
#include <cstdint>

namespace {
constexpr uint64_t MOD = 65521;
}

extern "C" {

// blocks: n contiguous blocks of blen bytes; out: n uint32 checksums.
void adler32_batch(const uint8_t* blocks, size_t n, size_t blen,
                   uint32_t* out) {
    for (size_t b = 0; b < n; ++b) {
        const uint8_t* d = blocks + b * blen;
        uint64_t s1 = 0, s2 = 0;
        for (size_t i = 0; i < blen; ++i) {
            s1 += d[i];
            s2 += static_cast<uint64_t>(blen - i) * d[i];
        }
        uint64_t a = (1 + s1) % MOD;
        uint64_t bb = (blen + s2) % MOD;
        out[b] = static_cast<uint32_t>((bb << 16) | a);
    }
}

}  // extern "C"
