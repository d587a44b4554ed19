// GF(2^8) Reed-Solomon codec kernels for Hopper (sm_90a).
//
// Replaces the four fused Pallas kernels of the JAX package's
// glusterfs_tpu/ops/gf256_pallas.py that the served disperse path runs:
//   fused_encode       <- _fused_encode_fn       (pallas_call at :342)
//   fused_decode       <- _fused_decode_fn       (pallas_call at :378)
//   fused_parity       <- _fused_parity_fn       (pallas_call at :444)
//   fused_reconstruct  <- _fused_reconstruct_fn  (pallas_call at :477)
//
// All four compute one GF(2) contraction on bit-sliced chunk data:
// output plane i of a stripe is the byte-wise XOR of the input planes j
// whose bit-matrix entry abits[i][j] is 1 (ops/gf256.py).  A plane is a
// 64-byte word; a 512-byte chunk holds 8 planes; a stripe holds C = k*8
// input planes.  They differ only in the layouts they read and write:
//
//   stripe-major    plane p of stripe s at  (s*P + p) * 64
//   fragment-major  plane p of stripe s at  (p/8)*S*512 + s*512 + (p%8)*64
//
//   encode, parity:  stripe-major in   -> fragment-major out
//   decode:          fragment-major in -> stripe-major out
//   reconstruct:     fragment-major in -> fragment-major out
//
// The bit-matrix is a device operand: for each output plane, a
// C-bit (<= 128) mask as two uint64 words.  One build serves every
// decode mask, as the TPU's mxu form did; the TPU kernels baked the
// matrix into their trace instead.
//
// Bound: device memory.  A launch reads each input byte once and
// writes each output byte once, and does about R*C/2 16-byte XORs per
// stripe out of shared memory.  Design: a block stages kTile stripes in
// shared memory with coalesced 16-byte loads (the tile of one fragment
// is contiguous in either layout), then each warp takes one output plane
// at a time across the tile's 8 stripes x 4 16-byte lanes, so the mask
// loop is uniform across the warp and the shared-memory reads hit no
// bank twice (a 64-byte pad per staged stripe puts neighbouring stripes
// on opposite halves of the banks).  Stores are 64-byte
// runs, whole sectors.  Any stripe count works: the last tile is masked,
// nothing is padded.  No XOR-program CSE, tensor cores or TMA yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace gf256 {

constexpr int kWord = 64;    // bytes per bit-plane word
constexpr int kChunk = 512;  // bytes per fragment chunk (8 planes)
constexpr int kTile = 8;     // stripes per block (a warp spans 8 x 4 lanes)
constexpr int kThreads = 256;

enum Layout : int { kStripeMajor = 0, kFragmentMajor = 1 };

// Byte offset of plane p of stripe s in a buffer of `planes` planes per
// stripe and S stripes.
template <int L>
__device__ __forceinline__ int64_t plane_offset(int64_t s, int p, int planes,
                                                int64_t S) {
  if (L == kStripeMajor) return (s * planes + p) * kWord;
  return static_cast<int64_t>(p >> 3) * S * kChunk + s * kChunk +
         (p & 7) * kWord;
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads)
    xor_apply(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
              const unsigned long long* __restrict__ masks, int64_t S, int C,
              int R) {
  extern __shared__ uint4 tile[];  // kTile x (C*4 + 4 pad) 16-byte lanes
  const int stride = C * 4 + 4;
  const int per_stripe = C * 4;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kTile;

  // Stage the tile.  Element e walks global memory contiguously: in
  // stripe-major order the tile is one run; in fragment-major order it
  // is one run per fragment (kTile chunks of 32 lanes).
  for (int e = threadIdx.x; e < kTile * per_stripe; e += kThreads) {
    int t, p, q;
    if (IN == kStripeMajor) {
      t = e / per_stripe;
      const int rem = e - t * per_stripe;
      p = rem >> 2;
      q = rem & 3;
    } else {
      const int f = e / (kTile * 32);
      const int rem = e - f * (kTile * 32);
      t = rem >> 5;
      p = f * 8 + ((rem & 31) >> 2);
      q = rem & 3;
    }
    const int64_t s = s0 + t;
    if (s < S) {
      tile[t * stride + p * 4 + q] = *reinterpret_cast<const uint4*>(
          x + plane_offset<IN>(s, p, C, S) + q * 16);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane >> 2;
  const int q = lane & 3;
  const int64_t s = s0 + t;
  const uint4* row = tile + t * stride + q;
  for (int i = warp; i < R; i += kThreads / 32) {
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

template <int IN, int OUT>
cudaError_t launch(const uint8_t* x, uint8_t* y, const int64_t* masks,
                   int64_t S, int C, int R, cudaStream_t stream) {
  if (S == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(kTile) * (C * 4 + 4) * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      xor_apply<IN, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (S + kTile - 1) / kTile;
  xor_apply<IN, OUT><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      x, y, reinterpret_cast<const unsigned long long*>(masks), S, C, R);
  return cudaSuccess;
}

cudaError_t fused_encode(const uint8_t* x, uint8_t* y, const int64_t* masks,
                         int64_t S, int C, int R, cudaStream_t stream) {
  return launch<kStripeMajor, kFragmentMajor>(x, y, masks, S, C, R, stream);
}

cudaError_t fused_decode(const uint8_t* x, uint8_t* y, const int64_t* masks,
                         int64_t S, int C, int R, cudaStream_t stream) {
  return launch<kFragmentMajor, kStripeMajor>(x, y, masks, S, C, R, stream);
}

cudaError_t fused_parity(const uint8_t* x, uint8_t* y, const int64_t* masks,
                         int64_t S, int C, int R, cudaStream_t stream) {
  return launch<kStripeMajor, kFragmentMajor>(x, y, masks, S, C, R, stream);
}

cudaError_t fused_reconstruct(const uint8_t* x, uint8_t* y,
                              const int64_t* masks, int64_t S, int C, int R,
                              cudaStream_t stream) {
  return launch<kFragmentMajor, kFragmentMajor>(x, y, masks, S, C, R, stream);
}

}  // namespace gf256
