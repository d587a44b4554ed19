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
// about R*C/2 16-byte XORs per stripe out of shared memory.  Design: a
// block stages T stripes (word columns) in shared memory with coalesced
// 16-byte loads (the tile of one fragment or plane row is contiguous in
// every layout), then each group of T*4 threads takes one output plane
// at a time across the tile's T columns x 4 16-byte lanes, so the mask
// loop is uniform across each warp and the shared-memory reads hit no
// bank twice (a 64-byte pad per staged column puts neighbouring columns
// on opposite halves of the banks).  Stores are 64-byte runs, whole
// sectors.  Any stripe count works: the last tile is masked.
//
// xor_apply and xor3_apply compute the same function with the same body;
// they differ only in the tile.  The TPU's xor3 existed to fill whole
// vregs with (256, 128) row tiles where xor used (1, W) row slices.  The
// Hopper counterpart of "more bytes in flight per step" is more columns
// per block: xor_apply stages 8 columns (512 bytes of each plane row),
// xor3_apply 32 (2 KiB of each plane row).  At C = 128 (k = 16) 32
// columns would take 264 KB of shared memory, more than the 227 KB a
// block may use, so xor3_apply takes 16 columns there.  C <= 128 holds
// because the masks carry 128 bits (ops/gf256_cuda.py masks_of).
//
// mxu_apply, the tensor-core kernel.  y = (abits . unpack(x)) mod 2,
// packed: the TPU's unpack -> int8 matmul -> & 1 -> pack, with the
// product on the tensor cores through mma.sync m16n8k32 s8.  Bound: at 256
// MiB of plane data, 4+2 encode moves 640 MiB (0.200 ms at 3.35 TB/s)
// and does 2*R*C*8W int8 operations (0.104 ms at 1,979e12/s); 8+4 0.200
// vs 0.208 ms; 16+4 0.180 vs 0.347 ms, bound by operations.  Design: a
// block keeps the bit-matrix in shared memory as int8 (R_pad, C_pad)
// (rows padded to 16, columns to 32, with zeros) and walks column tiles
// of 256 bytes: it stages the tile of every plane row in shared memory,
// then each warp takes 8 byte columns at a time.  The N dimension of one
// mma is those 8 byte columns at one bit b; the B fragment for bit b is
// (4 staged plane bytes >> b) & 0x01010101, which is the unpack to 0/1
// int8.  Eight mmas (b = 0..7) against the same A fragment give each
// thread 4 whole output bytes: bit 0 of each int32 sum (at most C = 128,
// no overflow) goes to bit b.  The bytes go through shared memory and
// leave as 16-byte stores.  Bit order: b outer, byte column inner, per 8
// columns (the TPU grouped b*TW + w over its whole tile; any consistent
// order is right).  No wgmma, TMA or pipelining yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace gf256 {

constexpr int kWord = 64;    // bytes per bit-plane word
constexpr int kChunk = 512;  // bytes per fragment chunk (8 planes)
constexpr int kThreads = 256;
constexpr int kMmaTile = 256;  // bytes of each plane row per mxu tile

enum Layout : int { kStripeMajor = 0, kFragmentMajor = 1, kPlaneMajor = 2 };

// Byte offset of plane p of stripe s in a buffer of `planes` planes per
// stripe and S stripes.
template <int L>
__device__ __forceinline__ int64_t plane_offset(int64_t s, int p, int planes,
                                                int64_t S) {
  if (L == kStripeMajor) return (s * planes + p) * kWord;
  if (L == kPlaneMajor) return (static_cast<int64_t>(p) * S + s) * kWord;
  return static_cast<int64_t>(p >> 3) * S * kChunk + s * kChunk +
         (p & 7) * kWord;
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// T: stripes (word columns) per block.
template <int IN, int OUT, int T>
__global__ void __launch_bounds__(kThreads)
    xor_apply(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
              const unsigned long long* __restrict__ masks, int64_t S, int C,
              int R) {
  extern __shared__ uint4 tile[];  // T x (C*4 + 4 pad) 16-byte lanes
  const int stride = C * 4 + 4;
  const int per_stripe = C * 4;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * T;

  // Stage the tile.  Element e walks global memory contiguously: in
  // stripe-major order the tile is one run; in fragment-major order one
  // run per fragment (T chunks of 32 lanes); in plane-major order one
  // run per plane row (T words of 4 lanes).
  for (int e = threadIdx.x; e < T * per_stripe; e += kThreads) {
    int t, p, q;
    if (IN == kStripeMajor) {
      t = e / per_stripe;
      const int rem = e - t * per_stripe;
      p = rem >> 2;
      q = rem & 3;
    } else if (IN == kFragmentMajor) {
      const int f = e / (T * 32);
      const int rem = e - f * (T * 32);
      t = rem >> 5;
      p = f * 8 + ((rem & 31) >> 2);
      q = rem & 3;
    } else {
      p = e / (T * 4);
      const int rem = e - p * (T * 4);
      t = rem >> 2;
      q = rem & 3;
    }
    const int64_t s = s0 + t;
    if (s < S) {
      tile[t * stride + p * 4 + q] = *reinterpret_cast<const uint4*>(
          x + plane_offset<IN>(s, p, C, S) + q * 16);
    }
  }
  __syncthreads();

  constexpr int kLanes = T * 4;               // threads on one output plane
  constexpr int kPlanes = kThreads / kLanes;  // output planes in flight
  const int group = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int t = lane >> 2;
  const int q = lane & 3;
  const int64_t s = s0 + t;
  const uint4* row = tile + t * stride + q;
  for (int i = group; i < R; i += kPlanes) {
    unsigned long long m0 = masks[2 * i];
    unsigned long long m1 = masks[2 * i + 1];
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    while (m0) {
      const int j = __ffsll(static_cast<long long>(m0)) - 1;
      m0 &= m0 - 1;
      xor_into(acc, row[j * 4]);
    }
    while (m1) {
      const int j = 64 + __ffsll(static_cast<long long>(m1)) - 1;
      m1 &= m1 - 1;
      xor_into(acc, row[j * 4]);
    }
    if (s < S) {
      *reinterpret_cast<uint4*>(y + plane_offset<OUT>(s, i, R, S) + q * 16) =
          acc;
    }
  }
}

template <int IN, int OUT, int T>
cudaError_t launch_xor(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, cudaStream_t stream) {
  if (S == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(T) * (C * 4 + 4) * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      xor_apply<IN, OUT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (S + T - 1) / T;
  xor_apply<IN, OUT, T><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const unsigned long long*>(masks), S, C, R);
  return cudaGetLastError();
}

// d += a . b over one m16n8k32 tile: A 16x32 s8 (row), B 32x8 s8 (col),
// D 16x8 s32.  Fragments (PTX ISA, mma.m16n8k32 with .s8), with
// g = lane / 4 and t = lane % 4:
//   a[0]: row g,   cols 4t..4t+3      a[1]: row g+8, cols 4t..4t+3
//   a[2]: row g,   cols 16+4t..       a[3]: row g+8, cols 16+4t..
//   b0:   rows 4t..4t+3, col g        b1:   rows 16+4t..16+4t+3, col g
//   d[0], d[1]: row g, cols 2t, 2t+1  d[2], d[3]: row g+8, cols 2t, 2t+1
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KS: k-steps of 32 input planes (C_pad = 32*KS).
template <int KS>
__global__ void __launch_bounds__(kThreads)
    mxu_apply(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
              const int8_t* __restrict__ abits, int64_t W, int C, int R) {
  constexpr int kCp = KS * 32;
  // row strides in bytes; the 16-byte pads keep the fragment loads of a
  // warp on distinct banks (A, Y) or at most two deep (X)
  constexpr int kAS = kCp + 16;
  constexpr int kXS = kMmaTile + 16;
  constexpr int kYS = kMmaTile + 16;
  constexpr int kVecs = kMmaTile / 16;  // 16-byte lanes per tile row
  const int rp = (R + 15) & ~15;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* as = smem;            // rp x kAS: the bit-matrix, zero-padded
  uint8_t* xs = as + rp * kAS;   // kCp x kXS: one tile of every plane row
  uint8_t* ys = xs + kCp * kXS;  // rp x kYS: the tile's output bytes

  for (int e = threadIdx.x; e < rp * kAS; e += kThreads) {
    const int r = e / kAS;
    const int c = e - r * kAS;
    as[e] = (r < R && c < C) ? static_cast<uint8_t>(abits[r * C + c]) : 0;
  }
  // padded planes meet zero columns of A; keep them defined all the same
  for (int e = threadIdx.x; e < (kCp - C) * kXS; e += kThreads) {
    xs[C * kXS + e] = 0;
  }

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int64_t tiles = W / kMmaTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t w0 = tile * kMmaTile;
    __syncthreads();  // the bit-matrix is in; the last tile is written out
    for (int e = threadIdx.x; e < C * kVecs; e += kThreads) {
      const int c = e / kVecs;
      const int v = e - c * kVecs;
      *reinterpret_cast<uint4*>(xs + c * kXS + v * 16) =
          *reinterpret_cast<const uint4*>(x + c * W + w0 + v * 16);
    }
    __syncthreads();

    for (int nt = warp; nt < kMmaTile / 8; nt += kThreads / 32) {
      // byte i of b[ks][h]: plane 32ks + 16h + 4t + i at byte column 8nt + g
      uint32_t b[KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* p = xs + (ks * 32 + h * 16 + t * 4) * kXS + nt * 8 + g;
          b[ks][h] = static_cast<uint32_t>(p[0]) |
                     (static_cast<uint32_t>(p[kXS]) << 8) |
                     (static_cast<uint32_t>(p[2 * kXS]) << 16) |
                     (static_cast<uint32_t>(p[3 * kXS]) << 24);
        }
      }
      for (int mt = 0; mt < rp / 16; ++mt) {
        uint32_t a[KS][4];
        const uint8_t* ar = as + (mt * 16 + g) * kAS + t * 4;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          a[ks][0] = *reinterpret_cast<const uint32_t*>(ar + ks * 32);
          a[ks][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAS + ks * 32);
          a[ks][2] = *reinterpret_cast<const uint32_t*>(ar + ks * 32 + 16);
          a[ks][3] =
              *reinterpret_cast<const uint32_t*>(ar + 8 * kAS + ks * 32 + 16);
        }
        // lo: row g, bytes 2t (bits 0-7) and 2t+1 (bits 8-15); hi: row g+8
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          int d[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma_s8(d, a[ks], (b[ks][0] >> bit) & 0x01010101u,
                   (b[ks][1] >> bit) & 0x01010101u);
          }
          lo |= ((d[0] & 1u) << bit) | ((d[1] & 1u) << (bit + 8));
          hi |= ((d[2] & 1u) << bit) | ((d[3] & 1u) << (bit + 8));
        }
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<uint16_t*>(ys + (mt * 16 + g) * kYS + col) =
            static_cast<uint16_t>(lo);
        *reinterpret_cast<uint16_t*>(ys + (mt * 16 + g + 8) * kYS + col) =
            static_cast<uint16_t>(hi);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int v = e - r * kVecs;
      *reinterpret_cast<uint4*>(y + r * W + w0 + v * 16) =
          *reinterpret_cast<const uint4*>(ys + r * kYS + v * 16);
    }
  }
}

template <int KS>
cudaError_t launch_mxu(const void* x, void* y, const void* abits, int64_t W,
                       int C, int R, int device, cudaStream_t stream) {
  const int rp = (R + 15) & ~15;
  const size_t smem = static_cast<size_t>(rp) * (KS * 32 + 16) +
                      static_cast<size_t>(KS * 32) * (kMmaTile + 16) +
                      static_cast<size_t>(rp) * (kMmaTile + 16);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_apply<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mxu_apply<KS>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = W / kMmaTile;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = tiles < resident ? tiles : resident;
  mxu_apply<KS><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y),
      static_cast<const int8_t*>(abits), W, C, R);
  return cudaGetLastError();
}

}  // namespace gf256

using gf256::kFragmentMajor;
using gf256::kPlaneMajor;
using gf256::kStripeMajor;

// Every entry point: x and y are device pointers (16-byte aligned), the
// operand is the bit-matrix, `device` the card's index and `stream` a
// cudaStream_t.  S counts stripes (fused kernels), W bytes of each plane
// row (plane-major kernels).  Returns the cudaError_t of the launch.
extern "C" {

int gf256_fused_encode(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gf256::launch_xor<kStripeMajor, kFragmentMajor, 8>(
      x, y, masks, S, C, R, static_cast<cudaStream_t>(stream));
}

int gf256_fused_decode(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gf256::launch_xor<kFragmentMajor, kStripeMajor, 8>(
      x, y, masks, S, C, R, static_cast<cudaStream_t>(stream));
}

int gf256_fused_parity(const void* x, void* y, const void* masks, int64_t S,
                       int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gf256::launch_xor<kStripeMajor, kFragmentMajor, 8>(
      x, y, masks, S, C, R, static_cast<cudaStream_t>(stream));
}

int gf256_fused_reconstruct(const void* x, void* y, const void* masks,
                            int64_t S, int C, int R, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gf256::launch_xor<kFragmentMajor, kFragmentMajor, 8>(
      x, y, masks, S, C, R, static_cast<cudaStream_t>(stream));
}

int gf256_xor_apply(const void* x, void* y, const void* masks, int64_t W,
                    int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (W % 64) return cudaErrorInvalidValue;
  return gf256::launch_xor<kPlaneMajor, kPlaneMajor, 8>(
      x, y, masks, W / 64, C, R, static_cast<cudaStream_t>(stream));
}

int gf256_xor3_apply(const void* x, void* y, const void* masks, int64_t W,
                     int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (W % 64) return cudaErrorInvalidValue;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (static_cast<size_t>(32) * (C * 4 + 4) * 16 <= static_cast<size_t>(optin)) {
    return gf256::launch_xor<kPlaneMajor, kPlaneMajor, 32>(x, y, masks, W / 64,
                                                           C, R, s);
  }
  return gf256::launch_xor<kPlaneMajor, kPlaneMajor, 16>(x, y, masks, W / 64,
                                                         C, R, s);
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
      return gf256::launch_mxu<1>(x, y, abits, W, C, R, device, s);
    case 2:
      return gf256::launch_mxu<2>(x, y, abits, W, C, R, device, s);
    case 3:
      return gf256::launch_mxu<3>(x, y, abits, W, C, R, device, s);
    default:
      return gf256::launch_mxu<4>(x, y, abits, W, C, R, device, s);
  }
}

const char* gf256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
