// GF(2^8) Reed-Solomon codec kernels for Hopper (sm_90a), behind a plain
// C interface that ops/gf256_cuda.py loads with ctypes.
//
// Replaces the seven Pallas kernels of the JAX package's
// glusterfs_tpu/ops/gf256_pallas.py:
//   fused_encode       <- _fused_encode_fn       (pallas_call at :342)
//   fused_decode       <- _fused_decode_fn       (pallas_call at :378)
//   fused_parity       <- _fused_parity_fn       (pallas_call at :444)
//   fused_reconstruct  <- _fused_reconstruct_fn  (pallas_call at :477)
//   xor_apply          <- _xor_apply_fn          (pallas_call at :161)
//   xor3_apply         <- _xor3_apply_fn         (pallas_call at :134)
//   mxu_apply          <- _mxu_apply_fn          (pallas_call at :187)
//
// All seven compute one GF(2) contraction on bit-sliced chunk data:
// output plane i is the byte-wise XOR of the input planes j whose
// bit-matrix entry abits[i][j] is 1 (ops/gf256.py).  A plane word is 64
// bytes; a 512-byte chunk holds 8 of them; a stripe holds C = k*8 input
// planes.  They differ in the layouts they read and write:
//
//   stripe-major    plane p of stripe s at  (s*P + p) * 64
//   fragment-major  plane p of stripe s at  (p/8)*S*512 + s*512 + (p%8)*64
//   plane-major     plane p of stripe s at  p*W + s*64      (W = S*64)
//
//   encode, parity:  stripe-major in   -> fragment-major out
//   decode:          fragment-major in -> stripe-major out
//   reconstruct:     fragment-major in -> fragment-major out
//   xor, xor3, mxu:  plane-major in    -> plane-major out
//
// The bit-matrix is a device operand (two uint64 masks per output plane
// for the XOR kernels, an int8 (R, C) matrix for the mma kernel), so one
// build serves every decode mask, as the TPU's mxu form did; the TPU's
// XOR kernels baked the matrix into their trace instead.
//
// XOR kernels (the six but mxu_apply).  Bound: device memory.  A launch
// reads each input byte once and writes each output byte once, and does
// about R*C/2 16-byte XORs per stripe.  C <= 128 holds because the masks
// carry 128 bits (ops/gf256_cuda.py masks_of).
//
// All six launch one body, layout_xor<RB>; the entry points differ only
// in the layout pair they pass (and xor_apply and xor3_apply in the
// widths they take).  In each layout plane p of stripe s lies at
// (p/8)*group + (p%8)*plane + s*stripe bytes (struct Strides), so the
// body addresses all three alike.  An earlier fused body read the operand
// of every XOR term from shared memory and used it once (at 16+4 those
// reads alone took 3.1x the byte bound at the SM's shared-memory rate),
// walked each mask bit by bit, and staged a whole synchronous tile before
// its first XOR.  layout_xor keeps its outputs in registers and reads
// shared memory once per output plane and 4 input planes:
// - A persistent grid (sized to the resident blocks) walks tiles of 8
//   stripes (512 bytes of each plane row in plane-major order); each
//   thread of a warp owns one 16-byte lane of every plane of the tile:
//   stripe lane/4, quarter lane%4.
// - Each of the 8 warps of a block holds RB output planes, one uint4
//   accumulator each per thread (RB = 1..20, the fewest that cover R in
//   one pass; more than 160 planes take several passes over a tile).
// - Input planes stream through a ring of 6 shared-memory slots of 16
//   planes x 8 stripes (cp.async; a barrier when a slot has landed and one
//   when its tables are written), so the ring does not grow with C and 2
//   blocks reside at any C.  Staging threads follow the input's own order,
//   so each warp loads 512 contiguous bytes: 8 planes of one stripe
//   (stripe-major, where the chunk's 16 planes of a stripe are one run of
//   1 KiB), one chunk of one stripe (fragment-major, where a fragment's 8
//   stripes are one run of 4 KiB) or 8 stripes of one plane
//   (plane-major).  Each thread's two copies per slot keep their source
//   offset from the step's first byte and their slot index at every
//   step, so both are made once per launch (made per step, they cost
//   `xor_apply` 2.5-4.5 % at 8+4 and 16+4 on the H100; PERF.md).
// - Four-plane tables: after each slot lands, the block writes, for each
//   group of 4 staged planes and each lane, the 16 XORs of the group's
//   subsets (entry e = XOR of the planes whose bit is set in e; two warps
//   a group, 7 or 8 entries each, entry 0 is zero).  An output plane then
//   takes its 4 mask bits of a group as an entry index: one 16-byte read
//   and one 16-byte XOR per (output plane, 4 input planes), whatever the
//   bits, where a test per bit costs the integer pipe a predicated XOR
//   per pair.  The entries' byte offsets are made from the masks once per
//   launch, 16 bits each, and read 8 at a time; they are the same for all
//   32 lanes of a warp.
// - Stores go straight from registers: a warp's store of one output plane
//   is 8 runs of 64 bytes in the wire layouts (one run of 512 in
//   plane-major order), whole sectors.
// - Tails: any stripe count works.  Stripes past S in the last tile are
//   never loaded (in fragment-major order they would be the next
//   fragment's bytes) and never stored; their lanes compute on stale slot
//   bytes, and the tables are per lane, so those bytes stay there.
//   Planes past C in the last ring slot are stale too; no mask bit
//   selects them.
// The layout pair is a runtime argument, uniform and used only in address
// arithmetic: one instantiation per RB serves all six kernels.  Layouts
// as template arguments (36 instantiations) gained only at 4+2 parity and
// reconstruct, which the staging offsets made once per launch gain as
// well, and spilled at RB = 20 (PERF.md).  The TPU's
// xor3 filled whole vregs with (256, 128) row tiles where xor used (1, W)
// row slices; on Hopper "more bytes in flight per step" is more slots in
// flight, not a larger synchronous tile, and 6 slots were no slower than 4
// for either.
//
// mxu_apply, the tensor-core kernel.  y = (abits . unpack(x)) mod 2,
// packed: the TPU's unpack -> int8 matmul -> & 1 -> pack, with the
// product on the tensor cores through mma.sync m16n8k32 s8.  Bound: at 256
// MiB of plane data, 4+2 encode moves 640 MiB (0.200 ms at 3.35 TB/s)
// and does 2*R*C*8W int8 operations (0.104 ms at 1,979e12/s); 8+4 0.200
// vs 0.208 ms; 16+4 0.180 vs 0.347 ms, bound by operations.
//
// What binds it is instruction issue, not bytes.  The first version spent
// about 13 integer instructions around each mma.sync (shift and mask per
// B fragment, bit 0 out of each accumulator and shifted into place) and
// issued 8 mmas per plane byte: at 4+2 encode (R = 48, C = 32, one
// k-step) 25.2 M warp mmas, with the integer pipes (half the issue rate
// of the others) as the limit, at a third of the byte bound.  At 16+4
// (C = 128, four k-steps) the integer work spreads over four mmas per
// extraction and the mma.sync issue rate binds.  So the design cuts both
// the integer instructions per mma and the mmas per byte; times per step
// are in PERF.md.
//
// Design.  A block of 8 warps walks 256-byte column tiles (a persistent
// grid sized to the resident blocks) and each warp takes 32 byte columns
// of every tile.
// - Staging: each tile of every plane row goes into a ring of three
//   shared-memory slots with cp.async (16 bytes a thread, two tiles in
//   flight while the third is multiplied), one barrier per tile.  The
//   16-byte chunks of plane row p sit at chunk v ^ 2*((p/4)%4), so the
//   four row quads of one B load fall on distinct banks.
// - B fragments: a lane (g, t) reads one 32-bit word (byte columns
//   4g..4g+3) from each of planes 4t..4t+3 and transposes the 4x4 bytes
//   with 8 byte_perms: register i then holds the four planes of byte
//   column 4g+i, which is the B fragment of mma i when N column g of mma
//   i stands for byte column 4g+i.  Four mmas cover 32 byte columns, and
//   the accumulators of lane (g, t) are then the 8 contiguous bytes
//   8t..8t+7 of rows g and g+8: they leave as 8-byte stores, straight from
//   registers.
// - Bits in place: the B fragment for bit b is raw & (0x01010101 << b),
//   one AND, made once per step and shared by all MB row tiles.  The sum
//   S of the selected bits then sits at 2^b * S, so bit b of the int32
//   accumulator is S mod 2, and acc |= d & (1 << b) is one LOP3 per
//   accumulator.  Bit 7's operand byte 0x80 is -128 as s8: the sum is
//   -128 * S, and since -128 * S = 128 * S (mod 256), bit 7 is still
//   S mod 2.  No sum overflows: |S| <= C <= 128.
// - Two bits per mma: with every row sum of the bit-matrix below 2^SP
//   (SP = 4..7), one mma reads bits b and b + SP of each byte (mask
//   0x01010101 * (2^b + 2^(b+SP))): its sum is 2^b * S + 2^(b+SP) * S',
//   the first term is below 2^(b+SP), so bits b and b + SP hold S mod 2
//   and S' mod 2 and one LOP3 takes both (for b + SP = 7 the second term
//   is -128 * S', and bit 7 is S' mod 2 as above).  Steps 0..7-SP take
//   such pairs, the rest one bit each: SP mmas per byte instead of 8.
//   The kernel sums the rows of the bit-matrix it stages (entries taken
//   mod 2, so every row sum is at most C) and picks the narrowest SP that
//   holds; the codec's matrices have row sums 4-15 at 4+2 encode, 18-28
//   at 4+2 decode, 34-56 at 8+4 and 73-74 at 16+4.  With a row sum of
//   128 (SP = 8) bit 7's mma takes the accumulator of bits 0-6 as its C
//   operand, so its low byte is the output byte with no extraction
//   (bits 0-6 are not touched by a multiple of 128).  byte_perm moves
//   byte 0 of each mma's accumulator to byte i of the output word.
// - A fragments: the bit-matrix is zero-padded in shared memory to
//   (rows to a whole number of passes of MB tiles of 16, columns to 32)
//   and held in registers (4*KS*MB of them).  When one pass covers every
//   row (4+2, 8+4 decode) they are loaded once for the launch; otherwise
//   once per pass and column tile, for SP*4*KS*MB mmas.
// - At one k-step the main loop is a function of its own, not inlined
//   into the kernel: the compiler then gives it 128 registers (105
//   inlined; two blocks per SM either way) and the 4+2 shapes run 6-8 %
//   faster on the H100 (PERF.md); at more k-steps inlining is as fast
//   or faster.
// Why not wgmma: its B operand comes from shared memory in the canonical
// K-major layout, so the 0/1 unpack would be written there at 8x the
// packed tile, and the integer work around each product would stay; it
// is the next step only if 16+4 stays bound by mma.sync issue.  Bit
// order: any consistent one is right (the TPU grouped b*TW + w over its
// tile).

#include <cstdint>
#include <cuda_runtime.h>

namespace gf256 {

constexpr int kWord = 64;    // bytes per bit-plane word
constexpr int kChunk = 512;  // bytes per fragment chunk (8 planes)
constexpr int kThreads = 256;
constexpr int kMmaTile = 256;  // bytes of each plane row per mxu tile

enum Layout : int { kStripeMajor = 0, kFragmentMajor = 1, kPlaneMajor = 2 };

// Plane p of stripe s of a buffer lies at (p/8)*group + (p%8)*plane +
// s*stripe bytes in every layout.
struct Strides {
  int64_t group, plane, stripe;
};

// The strides of layout l for S stripes of `planes` planes each.
inline Strides strides_of(Layout l, int64_t S, int planes) {
  if (l == kStripeMajor) {
    return {8 * kWord, kWord, static_cast<int64_t>(planes) * kWord};
  }
  if (l == kFragmentMajor) return {S * kChunk, kWord, kChunk};
  return {S * kChunk, S * kWord, kWord};  // plane-major, W = S*64
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// d = a . b (+ c) over one m16n8k32 tile: A 16x32 s8 (row), B 32x8 s8
// (col), D 16x8 s32.  Fragments (PTX ISA, mma.m16n8k32 with .s8), with
// g = lane / 4 and t = lane % 4:
//   a[0]: row g,   cols 4t..4t+3      a[1]: row g+8, cols 4t..4t+3
//   a[2]: row g,   cols 16+4t..       a[3]: row g+8, cols 16+4t..
//   b0:   rows 4t..4t+3, col g        b1:   rows 16+4t..16+4t+3, col g
//   d[0], d[1]: row g, cols 2t, 2t+1  d[2], d[3]: row g+8, cols 2t, 2t+1
// (the lowest byte of a fragment register is its lowest row or column).
__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, with a zero accumulator
__device__ __forceinline__ void mma_s8_zero(uint32_t (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kStages = 3;  // column tiles in the shared-memory ring

// layout_xor, the body of the six XOR kernels (see the note at the top).
constexpr int kXorStripes = 8;  // stripes per tile (512 bytes of a plane row)
constexpr int kXorChunk = 16;   // input planes per ring slot
constexpr int kXorGroup = 4;    // input planes per table (16 entries)
constexpr int kXorGroups = kXorChunk / kXorGroup;  // tables per slot
constexpr int kXorWarps = kThreads / 32;  // blocks of RB output planes
constexpr int kXorPlanes = 128;  // the masks' width
constexpr int kXorMaskGroups = kXorPlanes / kXorGroup;  // tables per mask
constexpr int kXorMaxRB = 20;    // output planes a warp holds (8*20 = 160)
constexpr int kXorStages = 6;    // ring slots
constexpr int kXorSlot = kXorChunk * 32;   // uint4 lanes of one ring slot
constexpr int kXorTable = 16 * 32;         // uint4 lanes of one table
// The most stripes one launch takes (137 GB of input at C = 8): tile and
// step counts stay within 32 bits.
constexpr int64_t kXorMaxStripes = int64_t{1} << 28;

// Output planes per warp padded to whole uint4 loads of 16-bit offsets.
__host__ __device__ constexpr int xor_rows_padded(int rb) {
  return (rb + 7) / 8 * 8;
}

// Element e (0..255) of a ring slot's staging, in the input's own order:
// its plane pl (0..15) of the chunk and its stripe t (0..7) of the tile;
// its quarter is e % 4 in every layout.  Element e + 256 is 4 stripes on
// (stripe-major) or 8 planes on (the others).
__device__ __forceinline__ void xor_stage_coords(Layout in, int e, int& pl,
                                                 int& t) {
  if (in == kStripeMajor) {  // stripe, plane, quarter
    t = e >> 6;
    pl = (e >> 2) & 15;
  } else if (in == kFragmentMajor) {  // fragment, stripe, plane, quarter
    t = (e >> 5) & 7;
    pl = (e >> 2) & 7;
  } else {  // plane, stripe, quarter
    t = (e >> 2) & 7;
    pl = e >> 5;
  }
}

template <int RB>
__global__ void __launch_bounds__(kThreads, 2)
    layout_xor(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
               const unsigned long long* __restrict__ masks, int64_t S,
               int C, int R, int passes, Layout in, Strides src,
               Strides dst) {
  constexpr int kRBP = xor_rows_padded(RB);
  // kXorStages ring slots, kXorGroups tables, then the table offsets
  extern __shared__ __align__(16) uint4 ring[];
  uint4* tab = ring + kXorStages * kXorSlot;
  uint16_t* offs = reinterpret_cast<uint16_t*>(tab + kXorGroups * kXorTable);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // offs[(b * kXorMaskGroups + G) * kRBP + i]: the byte offset in `tab`
  // of the entry that output plane b * RB + i takes from the table of
  // input planes 4G..4G+3 (b = pass * kXorWarps + warp): table G % 4,
  // entry = the row's 4 mask bits there.  Padding rows take entry 0,
  // which is zero.
  for (int e = threadIdx.x; e < passes * kXorWarps * kXorMaskGroups * kRBP;
       e += kThreads) {
    const int i = e % kRBP;
    const int grp = e / kRBP % kXorMaskGroups;
    const int r = e / (kXorMaskGroups * kRBP) * RB + i;
    unsigned nib = 0;
    if (i < RB && r < R && kXorGroup * grp < C) {
      const unsigned long long m = masks[2 * r + (grp >> 4)];
      const int live = min(kXorGroup, C - kXorGroup * grp);
      nib = static_cast<unsigned>(m >> (kXorGroup * grp & 63)) &
            ((1u << live) - 1u);
    }
    offs[e] = static_cast<uint16_t>(
        ((grp % kXorGroups) * kXorTable + nib * 32) * sizeof(uint4));
  }
  for (int e = threadIdx.x; e < kXorGroups * 32; e += kThreads) {
    tab[(e >> 5) * kXorTable + (e & 31)] = make_uint4(0u, 0u, 0u, 0u);
  }

  // A block's steps: its tiles, each in `passes` passes of `chunks` ring
  // slots (32-bit counts: S is at most kXorMaxStripes).
  const int tiles = static_cast<int>((S + kXorStripes - 1) / kXorStripes);
  const int chunks = (C + kXorChunk - 1) / kXorChunk;
  const int steps =
      tiles > static_cast<int>(blockIdx.x)
          ? ((tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) *
                passes * chunks
          : 0;
  // This thread stages elements threadIdx.x and threadIdx.x + 256 of
  // every ring slot: their offsets from the step's first byte, and their
  // places in the slot, are the same at every step.
  int pl, t;
  xor_stage_coords(in, threadIdx.x, pl, t);
  const bool by_stripe = in == kStripeMajor;
  const int64_t from = (pl >> 3) * src.group + (pl & 7) * src.plane +
                       t * src.stripe + (threadIdx.x & 3) * 16;
  const int64_t from_next = by_stripe ? 4 * src.stripe : src.group;
  const int at = pl * 32 + 4 * t + (threadIdx.x & 3);
  const int at_next = by_stripe ? 16 : 8 * 32;
  int st_tile = blockIdx.x, st_step = 0;  // the next step to stage
  int st_chunk = 0, st_pass = 0;
  auto stage = [&](int slot) {
    if (st_step < steps) {
      // planes 16c.. of stripes 8t..: chunk c is fragments 2c and 2c + 1
      const uint8_t* base = x + int64_t{st_tile} * kXorStripes * src.stripe +
                            st_chunk * 2 * src.group + from;
      // stripes of the tile and planes of the chunk from this thread's on
      const int64_t stripes = S - int64_t{st_tile} * kXorStripes - t;
      const int planes = C - st_chunk * kXorChunk - pl;
      uint4* to = ring + slot * kXorSlot + at;
      if (planes > 0 && stripes > 0) cp_async16(to, base);
      if (by_stripe ? planes > 0 && stripes > 4 : planes > 8 && stripes > 0) {
        cp_async16(to + at_next, base + from_next);
      }
      if (++st_chunk == chunks) {
        st_chunk = 0;
        if (++st_pass == passes) {
          st_pass = 0;
          st_tile += gridDim.x;
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count in step
    ++st_step;
  };
#pragma unroll
  for (int s = 0; s < kXorStages - 1; ++s) stage(s);

  uint4 acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
  int tile = blockIdx.x;
  int chunk = 0, pass = 0, slot = 0;
  const int grp = warp >> 1;  // the table this warp fills
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kXorStages - 2>();
    __syncthreads();  // this slot is in; the tables and the slot staged
                      // next are free
    stage((slot + kXorStages - 1) % kXorStages);

    // Tables: entry e of table g is the XOR of the planes 4g + q of the
    // slot with bit q of e set; warps 2g and 2g + 1 fill entries 1-7 and
    // 8-15 (planes past C hold stale bytes; no mask bit selects them).
    if (chunk * kXorChunk + grp * kXorGroup < C) {
      const uint4* xs = ring + slot * kXorSlot + grp * kXorGroup * 32 + lane;
      uint4* t = tab + grp * kXorTable + lane;
      const uint4 v0 = xs[0], v1 = xs[32], v2 = xs[64];
      uint4 v01 = v0;
      xor_into(v01, v1);
      auto put = [&](int e, uint4 a, const uint4& b) {  // entry e = a ^ b
        xor_into(a, b);
        t[e * 32] = a;
      };
      if ((warp & 1) == 0) {
        t[1 * 32] = v0;
        t[2 * 32] = v1;
        t[3 * 32] = v01;
        t[4 * 32] = v2;
        put(5, v2, v0);
        put(6, v2, v1);
        put(7, v2, v01);
      } else {
        const uint4 v3 = xs[96];
        t[8 * 32] = v3;
        put(9, v3, v0);
        put(10, v3, v1);
        put(11, v3, v01);
        uint4 v23 = v3;
        xor_into(v23, v2);
        t[12 * 32] = v23;
        put(13, v23, v0);
        put(14, v23, v1);
        put(15, v23, v01);
      }
    }
    __syncthreads();  // the tables are in

    const int b = pass * kXorWarps + warp;
    if (b * RB < R) {
      const uint16_t* ob =
          offs + (b * kXorMaskGroups + chunk * kXorGroups) * kRBP;
      const uint8_t* tl = reinterpret_cast<const uint8_t*>(tab + lane);
#pragma unroll
      for (int g = 0; g < kXorGroups; ++g) {
        if (chunk * kXorChunk + g * kXorGroup >= C) break;
#pragma unroll
        for (int i0 = 0; i0 < RB; i0 += 8) {
          // eight rows' offsets, the same for every lane of the warp
          const uint4 o =
              *reinterpret_cast<const uint4*>(ob + g * kRBP + i0);
          const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int i = i0; i < i0 + 8 && i < RB; ++i) {
            const uint32_t w = ow[(i - i0) >> 1];
            const uint32_t off = (i & 1) ? w >> 16 : w & 0xFFFFu;
            xor_into(acc[i], *reinterpret_cast<const uint4*>(tl + off));
          }
        }
      }
    }
    if (++chunk == chunks) {  // the pass over this tile is done
      chunk = 0;
      const int64_t s = int64_t{tile} * kXorStripes + (lane >> 2);
      uint8_t* ys = y + s * dst.stripe + (lane & 3) * 16;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int o = b * RB + i;
        if (o < R && s < S) {
          *reinterpret_cast<uint4*>(ys + (o >> 3) * dst.group +
                                    (o & 7) * dst.plane) = acc[i];
        }
        acc[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (++pass == passes) {
        pass = 0;
        tile += gridDim.x;
      }
    }
    slot = (slot + 1) % kXorStages;
  }
  cp_async_wait<0>();
}

// One layout_xor call: S stripes of C input and R output planes; with
// `per_sm` set, only the blocks per SM that the occupancy calculator
// gives for it.
struct XorCall {
  const void* x;
  void* y;
  const void* masks;
  int64_t S;
  int C, R;
  Layout in, out;
  int device;
  cudaStream_t stream;
  int* per_sm;
};

// The grid is sized to the blocks that fit on the card at once.
template <int RB>
cudaError_t launch_xor(const XorCall& a) {
  const int passes = (a.R + kXorWarps * RB - 1) / (kXorWarps * RB);
  const size_t smem =
      (static_cast<size_t>(kXorStages) * kXorSlot + kXorGroups * kXorTable) *
          sizeof(uint4) +
      static_cast<size_t>(passes) * kXorWarps * kXorMaskGroups *
          xor_rows_padded(RB) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      layout_xor<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, layout_xor<RB>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (a.per_sm) {
    *a.per_sm = per_sm;
    return cudaSuccess;
  }
  const int64_t tiles = (a.S + kXorStripes - 1) / kXorStripes;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = tiles < resident ? tiles : resident;
  layout_xor<RB>
      <<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
          static_cast<const uint8_t*>(a.x), static_cast<uint8_t*>(a.y),
          static_cast<const unsigned long long*>(a.masks), a.S, a.C, a.R,
          passes, a.in, strides_of(a.in, a.S, a.C),
          strides_of(a.out, a.S, a.R));
  return cudaGetLastError();
}

// RB: the fewest output planes per warp, of those built, that cover R in
// one pass; past 160 planes, kXorMaxRB in several passes.
cudaError_t dispatch_xor(const XorCall& a) {
  const int rb = (a.R + kXorWarps - 1) / kXorWarps;
  if (rb <= 1) return launch_xor<1>(a);
  if (rb <= 2) return launch_xor<2>(a);
  if (rb <= 3) return launch_xor<3>(a);
  if (rb <= 4) return launch_xor<4>(a);
  if (rb <= 6) return launch_xor<6>(a);
  if (rb <= 8) return launch_xor<8>(a);
  if (rb <= 12) return launch_xor<12>(a);
  if (rb <= 16) return launch_xor<16>(a);
  return launch_xor<kXorMaxRB>(a);
}

// One launch of the XOR body from a C entry point.
int xor_entry(const void* x, void* y, const void* masks, int64_t S, int C,
              int R, Layout in, Layout out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (S < 0 || S > kXorMaxStripes || C < 1 || C > kXorPlanes || R < 1) {
    return cudaErrorInvalidValue;
  }
  if (S == 0) return cudaSuccess;
  return dispatch_xor({x, y, masks, S, C, R, in, out, device,
                       static_cast<cudaStream_t>(stream), nullptr});
}

// Row tiles of 16 output planes per pass (MB) for KS k-steps: the A
// fragments of a pass (4*KS*MB registers) stay in registers.
constexpr int mxu_max_mb(int ks) { return ks <= 2 ? 4 : 2; }

// Bits of each plane byte that step st of a product with pair spacing SP
// reads: bits st and st + SP for the first 8 - SP steps, then bit st
// alone (SP = 8: bit st alone at every one of the 8 steps).
__host__ __device__ constexpr uint32_t mxu_step_bits(int sp, int st) {
  return sp < 8 && st < 8 - sp ? (1u << st) | (1u << (st + sp))
                               : 1u << st;
}

// The widest spacing KS k-steps can need: a row sums to at most 32*KS.
__host__ __device__ constexpr int mxu_max_sp(int ks) {
  return ks == 1 ? 6 : ks < 4 ? 7 : 8;
}

// 16-byte chunk v of staged plane row p sits at chunk v ^ (2 * ((p/4)%4)),
// so the four row quads a warp's B loads touch land on distinct banks.
__device__ __forceinline__ int mxu_swizzle(int p, int v) {
  return v ^ (((p >> 2) & 3) << 1);
}

// The kernel's main loop for pair spacing SP; `as` holds the bit-matrix
// and `xs` the ring, both set up by mxu_apply.
template <int KS, int MB, int SP>
__device__ __forceinline__ void mxu_run(const uint8_t* __restrict__ x,
                                        uint8_t* __restrict__ y, int64_t W,
                                        int C, int R, int passes,
                                        const uint8_t* as, uint8_t* xs) {
  constexpr int kCp = KS * 32;
  constexpr int kAS = kCp + 16;
  constexpr int kSlot = kCp * kMmaTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;

  uint32_t a[MB][KS][4];
  auto load_a = [&](int pass) {
#pragma unroll
    for (int mt = 0; mt < MB; ++mt) {
      const uint8_t* ar = as + ((pass * MB + mt) * 16 + g) * kAS + t * 4;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[mt][ks][0] = *reinterpret_cast<const uint32_t*>(ar + ks * 32);
        a[mt][ks][1] =
            *reinterpret_cast<const uint32_t*>(ar + 8 * kAS + ks * 32);
        a[mt][ks][2] = *reinterpret_cast<const uint32_t*>(ar + ks * 32 + 16);
        a[mt][ks][3] =
            *reinterpret_cast<const uint32_t*>(ar + 8 * kAS + ks * 32 + 16);
      }
    }
  };
  load_a(0);  // for the whole launch when one pass covers every row

  const int64_t tiles = W / kMmaTile;
  int64_t next = blockIdx.x;  // the next column tile to stage
  auto stage = [&](int slot) {
    if (next < tiles) {
      const uint8_t* src = x + next * kMmaTile;
      uint8_t* dst = xs + slot * kSlot;
      for (int e = threadIdx.x; e < C * (kMmaTile / 16); e += kThreads) {
        const int p = e >> 4;
        const int v = e & 15;
        cp_async16(dst + p * kMmaTile + mxu_swizzle(p, v) * 16,
                   src + p * W + v * 16);
      }
    }
    cp_async_commit();  // an empty group keeps the count in step
    next += gridDim.x;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);

  // this warp's 32 byte columns of each tile; lane (g, t) reads the 4
  // bytes at columns col0 + 4g .. + 3 of planes 4t..4t+3 of each quad
  const int col0 = warp * 32;
  const int boff =
      mxu_swizzle(4 * t, (col0 >> 4) + (g >> 2)) * 16 + (g & 3) * 4;
  int slot = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile is in; the slot staged next is free
    stage((slot + kStages - 1) % kStages);

    // b[ks][h][i]: the B register of mma i, i.e. planes 32ks + 16h +
    // 4t .. +3 at byte column col0 + 4g + i (a 4x4 byte transpose of
    // the four words read)
    uint32_t b[KS][2][4];
    const uint8_t* xt = xs + slot * kSlot + 4 * t * kMmaTile + boff;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* p = xt + (ks * 32 + h * 16) * kMmaTile;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + kMmaTile);
        const uint32_t w2 =
            *reinterpret_cast<const uint32_t*>(p + 2 * kMmaTile);
        const uint32_t w3 =
            *reinterpret_cast<const uint32_t*>(p + 3 * kMmaTile);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
        b[ks][h][0] = __byte_perm(lo01, lo23, 0x5410);
        b[ks][h][1] = __byte_perm(lo01, lo23, 0x7632);
        b[ks][h][2] = __byte_perm(hi01, hi23, 0x5410);
        b[ks][h][3] = __byte_perm(hi01, hi23, 0x7632);
      }
    }

    const int64_t yc = tile * kMmaTile + col0 + 8 * t;
    for (int pass = 0; pass < passes; ++pass) {
      if (passes > 1) load_a(pass);
      // out[mt]: row g bytes 8t..8t+3 and 8t+4..8t+7 of the warp's
      // columns, then the same of row g+8
      uint32_t out[MB][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t acc[MB][4];
#pragma unroll
        for (int st = 0; st < SP; ++st) {  // SP steps per byte
          // the step's bits of each plane byte, in place: the parity of
          // each sum lands at its bit of the accumulator (see the note)
          const uint32_t m = mxu_step_bits(SP, st);
          // bit 7 alone adds onto the accumulated bits 0-6
          const bool chain = SP == 8 && st == 7;
          uint32_t bm[KS][2];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            bm[ks][0] = b[ks][0][i] & (m * 0x01010101u);
            bm[ks][1] = b[ks][1][i] & (m * 0x01010101u);
          }
#pragma unroll
          for (int mt = 0; mt < MB; ++mt) {
            uint32_t d[4];
            if (!chain) {
              mma_s8_zero(d, a[mt][0], bm[0][0], bm[0][1]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) d[q] = acc[mt][q];
              mma_s8(d, a[mt][0], bm[0][0], bm[0][1]);
            }
#pragma unroll
            for (int ks = 1; ks < KS; ++ks) {
              mma_s8(d, a[mt][ks], bm[ks][0], bm[ks][1]);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[mt][q] = st == 0 ? d[q] & m
                           : chain ? d[q]  // byte 0 is the output byte
                                   : acc[mt][q] | (d[q] & m);
            }
          }
        }
        // byte 0 of acc goes to byte i of out
#pragma unroll
        for (int mt = 0; mt < MB; ++mt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            out[mt][q] = i == 0 ? acc[mt][q]
                         : i == 1 ? __byte_perm(out[mt][q], acc[mt][q], 0x3240)
                         : i == 2 ? __byte_perm(out[mt][q], acc[mt][q], 0x3410)
                                  : __byte_perm(out[mt][q], acc[mt][q], 0x4210);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MB; ++mt) {
        const int r = (pass * MB + mt) * 16 + g;
        if (r < R) {
          *reinterpret_cast<uint2*>(y + r * W + yc) =
              make_uint2(out[mt][0], out[mt][1]);
        }
        if (r + 8 < R) {
          *reinterpret_cast<uint2*>(y + (r + 8) * W + yc) =
              make_uint2(out[mt][2], out[mt][3]);
        }
      }
    }
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();
}

// mxu_run as a function of its own, not inlined (see the note)
template <int KS, int MB, int SP>
__device__ __noinline__ void mxu_run_outlined(const uint8_t* x, uint8_t* y,
                                              int64_t W, int C, int R,
                                              int passes, const uint8_t* as,
                                              uint8_t* xs) {
  mxu_run<KS, MB, SP>(x, y, W, C, R, passes, as, xs);
}

// mxu_run for the narrowest spacing SP >= 4 that holds sp, among those
// KS k-steps can need.
template <int KS, int MB, int SP = 4>
__device__ __forceinline__ void mxu_dispatch(int sp, const uint8_t* x,
                                             uint8_t* y, int64_t W, int C,
                                             int R, int passes,
                                             const uint8_t* as, uint8_t* xs) {
  if constexpr (SP < mxu_max_sp(KS)) {
    if (sp > SP) {
      mxu_dispatch<KS, MB, SP + 1>(sp, x, y, W, C, R, passes, as, xs);
      return;
    }
  }
  if constexpr (KS == 1) {
    mxu_run_outlined<KS, MB, SP>(x, y, W, C, R, passes, as, xs);
  } else {
    mxu_run<KS, MB, SP>(x, y, W, C, R, passes, as, xs);
  }
}

// KS: k-steps of 32 input planes (C_pad = 32*KS); MB: row tiles per pass;
// the kernel makes `passes` passes of MB row tiles over each column tile.
template <int KS, int MB>
__global__ void __launch_bounds__(kThreads)
    mxu_apply(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
              const int8_t* __restrict__ abits, int64_t W, int C, int R,
              int passes) {
  constexpr int kCp = KS * 32;
  constexpr int kAS = kCp + 16;  // bit-matrix row stride in shared memory
  constexpr int kSlot = kCp * kMmaTile;  // bytes of one staged column tile
  const int rp = passes * MB * 16;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ unsigned max_sum;  // the largest row sum of the bit-matrix
  uint8_t* as = smem;           // rp x kAS: the bit-matrix, zero-padded
  uint8_t* xs = as + rp * kAS;  // kStages x kCp x kMmaTile, swizzled

  if (threadIdx.x == 0) max_sum = 0;
  for (int e = threadIdx.x; e < rp * kAS; e += kThreads) {
    const int r = e / kAS;
    const int c = e - r * kAS;
    // an entry's parity is all that counts mod 2: 0/1 keeps every row
    // sum within C
    as[e] = (r < R && c < C) ? abits[r * C + c] & 1 : 0;
  }
  // padded planes meet zero columns of A; keep them defined all the same
  for (int e = threadIdx.x; e < (kCp - C) * kMmaTile; e += kThreads) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) xs[s * kSlot + C * kMmaTile + e] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const auto* row = reinterpret_cast<const uint32_t*>(as + r * kAS);
    unsigned s = 0;
#pragma unroll
    for (int c = 0; c < kCp / 4; ++c) s = __dp4a(row[c], 0x01010101u, s);
    atomicMax(&max_sum, s);
  }
  __syncthreads();
  // the bits of the largest sum, at least 4: below 16 -> 4, below 32 ->
  // 5, below 64 -> 6, below 128 -> 7, 128 -> 8
  const int sp = max(4, 32 - __clz(static_cast<int>(max_sum)));
  mxu_dispatch<KS, MB>(sp, x, y, W, C, R, passes, as, xs);
}

template <int KS, int MB>
cudaError_t launch_mxu(const void* x, void* y, const void* abits, int64_t W,
                       int C, int R, int passes, int device,
                       cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(passes) * MB * 16 * (KS * 32 + 16) +
      static_cast<size_t>(kStages) * KS * 32 * kMmaTile;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_apply<KS, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mxu_apply<KS, MB>, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = W / kMmaTile;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = tiles < resident ? tiles : resident;
  mxu_apply<KS, MB><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(abits), W, C, R, passes);
  return cudaGetLastError();
}

// The pass size for KS k-steps and R output planes: as few passes of at
// most mxu_max_mb(KS) row tiles as will do, split evenly.
template <int KS>
cudaError_t dispatch_mxu(const void* x, void* y, const void* abits, int64_t W,
                         int C, int R, int device, cudaStream_t stream) {
  constexpr int kMax = mxu_max_mb(KS);
  const int tiles = (R + 15) / 16;
  const int passes = (tiles + kMax - 1) / kMax;
  const int mb = (tiles + passes - 1) / passes;
  switch (mb) {
    case 1:
      return launch_mxu<KS, 1>(x, y, abits, W, C, R, passes, device, stream);
    case 2:
      return launch_mxu<KS, 2>(x, y, abits, W, C, R, passes, device, stream);
    case 3:
      return launch_mxu<KS, kMax < 3 ? kMax : 3>(x, y, abits, W, C, R, passes,
                                                 device, stream);
    default:
      return launch_mxu<KS, kMax>(x, y, abits, W, C, R, passes, device,
                                  stream);
  }
}

}  // namespace gf256

using gf256::kFragmentMajor;
using gf256::kPlaneMajor;
using gf256::kStripeMajor;
using gf256::xor_entry;

// Every entry point: x and y are device pointers (16-byte aligned), the
// operand is the bit-matrix, `device` the card's index and `stream` a
// cudaStream_t.  S counts stripes (fused kernels), W bytes of each plane
// row (plane-major kernels).  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue, with nothing launched, for C outside 1..128, R
// below 1 or a width the kernel's tiling cannot cover.
extern "C" {

int gf256_fused_encode(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  return xor_entry(x, y, masks, S, C, R, kStripeMajor, kFragmentMajor,
                   device, stream);
}

int gf256_fused_decode(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  return xor_entry(x, y, masks, S, C, R, kFragmentMajor, kStripeMajor,
                   device, stream);
}

int gf256_fused_parity(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  return xor_entry(x, y, masks, S, C, R, kStripeMajor, kFragmentMajor,
                   device, stream);
}

int gf256_fused_reconstruct(const void* x, void* y, const void* masks,
                            int64_t S, int C, int R, int device,
                            void* stream) {
  return xor_entry(x, y, masks, S, C, R, kFragmentMajor, kFragmentMajor,
                   device, stream);
}

int gf256_xor_apply(const void* x, void* y, const void* masks, int64_t W,
                    int C, int R, int device, void* stream) {
  if (W % 8192) return cudaErrorInvalidValue;
  return xor_entry(x, y, masks, W / gf256::kWord, C, R, kPlaneMajor,
                   kPlaneMajor, device, stream);
}

int gf256_xor3_apply(const void* x, void* y, const void* masks, int64_t W,
                     int C, int R, int device, void* stream) {
  if (W % 32768) return cudaErrorInvalidValue;
  return xor_entry(x, y, masks, W / gf256::kWord, C, R, kPlaneMajor,
                   kPlaneMajor, device, stream);
}

// Blocks per SM of the XOR kernels' body for R output planes, from the
// occupancy calculator; a negative cudaError_t if the query fails.
int gf256_xor_blocks(int R, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -err;
  if (R < 1) return -cudaErrorInvalidValue;
  int per_sm = 0;
  const gf256::XorCall a{nullptr,     nullptr,     nullptr, 0,       1, R,
                         kPlaneMajor, kPlaneMajor, device,  nullptr, &per_sm};
  err = gf256::dispatch_xor(a);
  return err != cudaSuccess ? -err : per_sm;
}

int gf256_mxu_apply(const void* x, void* y, const void* abits, int64_t W,
                    int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (W % gf256::kMmaTile || C < 1 || C > 128 || R < 1) {
    return cudaErrorInvalidValue;
  }
  if (W == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((C + 31) / 32) {
    case 1:
      return gf256::dispatch_mxu<1>(x, y, abits, W, C, R, device, s);
    case 2:
      return gf256::dispatch_mxu<2>(x, y, abits, W, C, R, device, s);
    case 3:
      return gf256::dispatch_mxu<3>(x, y, abits, W, C, R, device, s);
    default:
      return gf256::dispatch_mxu<4>(x, y, abits, W, C, R, device, s);
  }
}

const char* gf256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
