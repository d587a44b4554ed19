// Native GF(2^8) erasure-coding kernels (CPU fast path + bench baseline).
//
// The port's host-side analog of the reference's JIT-emitted
// AVX/SSE/x64 XOR-chain kernels (reference: xlators/cluster/ec/src/ec-code.c,
// ec-code-avx.c — behavior only; this is an independent implementation).
//
// Layout contract (shared with glusterfs_tpu_torch/ops/gf256.py):
//   * data is bit-sliced in 512-byte chunks: 8 bit-planes x 64-byte words
//     (EC_METHOD_CHUNK_SIZE / EC_METHOD_WORD_SIZE, reference ec-method.h:17-29)
//   * multiplying a chunk by a GF(256) constant == applying an 8x8 GF(2)
//     bit-matrix to its planes; a full encode is one (N*8, K*8) binary
//     matrix applied per stripe.
//
// Compiled with -O3 -mavx2 -funroll-loops: the fixed 64-byte XOR loops below
// vectorize to YMM xor/load/store chains, which is the same instruction mix
// the reference JIT emits.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kWord = 64;     // bytes per bit-plane word
constexpr int kBits = 8;      // GF(2^8)
constexpr int kChunk = kWord * kBits;  // 512

// XOR-accumulate one 64-byte word: dst ^= src.  Auto-vectorizes to 2x YMM.
inline void xor_word(uint8_t* __restrict dst, const uint8_t* __restrict src) {
  for (int b = 0; b < kWord; ++b) dst[b] ^= src[b];
}

// Variable-width helpers for the program walk.  The __restrict is what
// lets the compiler emit straight YMM loads/xor/stores: the pointers all
// point into one var slab, so without it every op pays an aliasing check
// (program destinations are always fresh vars, so the promise holds by
// construction).
inline void xor2_w(uint8_t* __restrict dst, const uint8_t* __restrict a,
                   const uint8_t* __restrict b, int w) {
  for (int i = 0; i < w; ++i) dst[i] = a[i] ^ b[i];
}

inline void xor_accum_w(uint8_t* __restrict dst,
                        const uint8_t* __restrict src, int w) {
  for (int i = 0; i < w; ++i) dst[i] ^= src[i];
}

// Per output row, the list of selected input planes (built once per call).
// cols = k*8 <= 128 (k <= 16 data fragments); rows = n*8 can exceed that
// (n up to 255), so the row table is heap-allocated.
struct RowSel {
  int idx[16 * kBits];
  int count;
};

std::vector<RowSel> build_sels(const uint8_t* abits, int rows, int cols) {
  std::vector<RowSel> sels(rows);
  for (int i = 0; i < rows; ++i) {
    sels[i].count = 0;
    for (int j = 0; j < cols; ++j) {
      if (abits[i * cols + j]) sels[i].idx[sels[i].count++] = j;
    }
  }
  return sels;
}

// y_row = XOR of selected 64-byte plane words from x (stride kWord rows).
inline void apply_row(const RowSel& sel, const uint8_t* __restrict x,
                      uint8_t* __restrict y) {
  if (sel.count == 0) {
    std::memset(y, 0, kWord);
    return;
  }
  std::memcpy(y, x + sel.idx[0] * kWord, kWord);
  for (int t = 1; t < sel.count; ++t) xor_word(y, x + sel.idx[t] * kWord);
}

}  // namespace

extern "C" {

// Generic plane-major apply: x is (c, w) bytes, y is (r, w); w a multiple of
// kWord.  abits is (r, c) in {0,1}.  Each 64-byte column block is independent.
void gf_apply_bitmatrix(const uint8_t* abits, int r, int c,
                        const uint8_t* x, uint8_t* y, size_t w) {
  std::vector<RowSel> sels = build_sels(abits, r, c);
  for (size_t off = 0; off < w; off += kWord) {
    // Gather is strided here; encode/decode below use the stripe-contiguous
    // layout instead.  This entry exists for parity testing vs the JAX path.
    for (int i = 0; i < r; ++i) {
      const RowSel& sel = sels[i];
      uint8_t* dst = y + i * w + off;
      if (sel.count == 0) {
        std::memset(dst, 0, kWord);
        continue;
      }
      std::memcpy(dst, x + sel.idx[0] * w + off, kWord);
      for (int t = 1; t < sel.count; ++t)
        xor_word(dst, x + sel.idx[t] * w + off);
    }
  }
}

// Encode: data is stripe-major (s, k*8, 64) plane words; abits (n*8, k*8);
// out is fragment-major (n, s*512) — fragment i chunk for stripe t lands at
// out + (i*s + t)*512 (matches ec_method_encode's output layout,
// reference ec-method.c:393-408).
void gf_encode(const uint8_t* __restrict data, uint8_t* __restrict out,
               const uint8_t* __restrict abits, int k, int n, size_t s) {
  const int cols = k * kBits;
  const int rows = n * kBits;
  std::vector<RowSel> sels = build_sels(abits, rows, cols);
  for (size_t t = 0; t < s; ++t) {
    const uint8_t* x = data + t * (size_t)k * kChunk;
    for (int f = 0; f < n; ++f) {
      uint8_t* frag = out + (f * s + t) * (size_t)kChunk;
      for (int p = 0; p < kBits; ++p)
        apply_row(sels[f * kBits + p], x, frag + p * kWord);
    }
  }
}

// Decode via a CSE'd straight-line XOR program, register-allocated by
// ops/gf256.py schedule_program (TRANSPOSED: output rows are fixed
// accumulator slots, values scatter into them as computed, slots recycle
// at last use).  frags is fragment-major (k, s*512), out stripe-major
// bytes (s*k*512).  code is a flat int32 instruction stream over n_slots
// reusable variable slots:
//   [0, dst, a, b]      slot dst = slot a ^ slot b
//   [1, row, nv, v...]  emit output plane row = XOR of nv slots (0 -> 0s)
//   [2, slot, f, p]     load plane p of surviving fragment f into slot
//   [3, src, n, s...]   slot s_i ^= slot src (scatter into accumulators)
//   [4, src, n, s...]   slot s_i = slot src  (first touch of those accs)
// Shared subexpressions are computed once per block instead of once per
// output row (~2-3x fewer word-XORs than the row-select kernel below —
// the programs of ops/gf256.py build_xor_program); the transposed schedule
// keeps the slab at peak-LIVE size so it stays cache-resident.  An
// unscheduled flat slab (one var per op, ~550 KiB at 16+4) measured
// SLOWER than row-select (133 vs 277 MiB/s) from cache thrash alone;
// see bench.py's native sweep rows (native_decode vs
// native_decode_rowselect) for the live numbers per geometry.
//
// The walk is blocked over `block` stripes: each slot holds `block`
// consecutive 64-byte words, so per-instruction dispatch (index loads,
// pointer math, loop overhead) amortizes across the block; the slab
// grows linearly with it, so the block stays caller-tunable (the python
// binding passes 8 — best or within noise at every geometry on a
// 1/2/4/8/16 scan once the schedule keeps the slab live-range-sized).
constexpr int kProgBlockMax = 16;

void gf_decode_prog(const uint8_t* __restrict frags, uint8_t* __restrict out,
                    const int32_t* __restrict code, int n_code, int n_slots,
                    int block, int k, size_t s) {
  if (block < 1) block = 1;
  if (block > kProgBlockMax) block = kProgBlockMax;
  const int vw = block * kWord;  // bytes per slot per block
  std::vector<uint8_t> slab((size_t)n_slots * vw);
  uint8_t* t = slab.data();
  uint8_t acc[kProgBlockMax * kWord];
  for (size_t st = 0; st < s; st += block) {
    const int nb = (s - st) < (size_t)block ? (int)(s - st) : block;
    const int w = nb * kWord;
    const int32_t* pc = code;
    const int32_t* end = code + n_code;
    while (pc < end) {
      switch (pc[0]) {
        case 0:
          xor2_w(t + (size_t)pc[1] * vw, t + (size_t)pc[2] * vw,
                 t + (size_t)pc[3] * vw, w);
          pc += 4;
          break;
        case 1: {
          const int row = pc[1], nv = pc[2];
          if (nv == 0) {
            std::memset(acc, 0, w);
          } else {
            std::memcpy(acc, t + (size_t)pc[3] * vw, w);
            for (int i = 1; i < nv; ++i)
              xor_accum_w(acc, t + (size_t)pc[3 + i] * vw, w);
          }
          // scatter plane `row` back to stripe-major output
          for (int b = 0; b < nb; ++b)
            std::memcpy(out + (st + b) * (size_t)k * kChunk + row * kWord,
                        acc + b * kWord, kWord);
          pc += 3 + nv;
          break;
        }
        case 2: {  // gather one input plane, nb stripes
          uint8_t* dst = t + (size_t)pc[1] * vw;
          const int f = pc[2], p = pc[3];
          for (int b = 0; b < nb; ++b)
            std::memcpy(dst + b * kWord,
                        frags + (f * s + st + b) * (size_t)kChunk + p * kWord,
                        kWord);
          pc += 4;
          break;
        }
        case 3: {  // scatter: acc slots ^= src
          const uint8_t* src = t + (size_t)pc[1] * vw;
          const int n = pc[2];
          for (int i = 0; i < n; ++i)
            xor_accum_w(t + (size_t)pc[3 + i] * vw, src, w);
          pc += 3 + n;
          break;
        }
        default: {  // 4: first touch: acc slots = src
          const uint8_t* src = t + (size_t)pc[1] * vw;
          const int n = pc[2];
          for (int i = 0; i < n; ++i)
            std::memcpy(t + (size_t)pc[3 + i] * vw, src, w);
          pc += 3 + n;
          break;
        }
      }
    }
  }
}

// Decode: frags is fragment-major (k, s*512) (the k surviving fragments in
// row order matching the decode matrix); bbits (k*8, k*8); out is
// stripe-major bytes (s*k*512).
void gf_decode(const uint8_t* __restrict frags, uint8_t* __restrict out,
               const uint8_t* __restrict bbits, int k, size_t s) {
  const int cols = k * kBits;
  std::vector<RowSel> sels = build_sels(bbits, cols, cols);
  // Gather one stripe's planes into a contiguous scratch (k*8 x 64), apply.
  uint8_t x[16 * kBits * kWord];
  for (size_t t = 0; t < s; ++t) {
    for (int f = 0; f < k; ++f)
      std::memcpy(x + f * (size_t)kChunk, frags + (f * s + t) * (size_t)kChunk,
                  kChunk);
    uint8_t* y = out + t * (size_t)k * kChunk;
    for (int i = 0; i < cols; ++i) apply_row(sels[i], x, y + i * kWord);
  }
}

}  // extern "C"
