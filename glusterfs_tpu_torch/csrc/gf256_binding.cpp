// PyTorch binding of the GF(2^8) codec kernels in gf256_kernels.cu.
//
// The only translation unit that includes PyTorch's headers: it checks
// each tensor, takes PyTorch's current stream on the tensor's device,
// launches, and checks the launch.  Outputs are allocated by the Python
// wrappers (ops/gf256_cuda.py); the kernels allocate nothing.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

namespace gf256 {
using Launcher = cudaError_t (*)(const uint8_t*, uint8_t*, const int64_t*,
                                 int64_t, int, int, cudaStream_t);
cudaError_t fused_encode(const uint8_t*, uint8_t*, const int64_t*, int64_t,
                         int, int, cudaStream_t);
cudaError_t fused_decode(const uint8_t*, uint8_t*, const int64_t*, int64_t,
                         int, int, cudaStream_t);
cudaError_t fused_parity(const uint8_t*, uint8_t*, const int64_t*, int64_t,
                         int, int, cudaStream_t);
cudaError_t fused_reconstruct(const uint8_t*, uint8_t*, const int64_t*,
                              int64_t, int, int, cudaStream_t);
}  // namespace gf256

namespace {

void check_bytes(const at::Tensor& t, const char* what) {
  TORCH_CHECK(t.is_cuda(), what, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == at::kByte, what, " must be uint8");
  TORCH_CHECK(t.is_contiguous(), what, " must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, what,
              " must be 16-byte aligned");
}

// x: S stripes of C input planes; y: S stripes of R output planes (both
// 64-byte planes, layouts fixed by the launcher); masks: (R, 2) int64.
void run(gf256::Launcher launcher, const at::Tensor& x, at::Tensor& y,
         const at::Tensor& masks, int64_t S, int64_t C, int64_t R) {
  check_bytes(x, "input");
  check_bytes(y, "output");
  TORCH_CHECK(masks.is_cuda() && masks.scalar_type() == at::kLong &&
                  masks.is_contiguous(),
              "masks must be a contiguous int64 CUDA tensor");
  TORCH_CHECK(x.device() == y.device() && x.device() == masks.device(),
              "input, output and masks must be on one device");
  TORCH_CHECK(S >= 0 && C % 8 == 0 && C >= 8 && C <= 128 && R >= 1,
              "bad geometry S=", S, " C=", C, " R=", R);
  TORCH_CHECK(masks.dim() == 2 && masks.size(0) == R && masks.size(1) == 2,
              "masks must be (R, 2)");
  TORCH_CHECK(x.numel() == S * C * 64, "input holds ", x.numel(),
              " bytes, expected ", S * C * 64);
  TORCH_CHECK(y.numel() == S * R * 64, "output holds ", y.numel(),
              " bytes, expected ", S * R * 64);
  // a fragment-major output plane p lives in fragment p / 8
  TORCH_CHECK(R % 8 == 0, "output planes must fill whole chunks");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(launcher(x.data_ptr<uint8_t>(), y.data_ptr<uint8_t>(),
                          masks.data_ptr<int64_t>(), S, static_cast<int>(C),
                          static_cast<int>(R),
                          at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_encode(const at::Tensor& x, at::Tensor y, const at::Tensor& masks,
                  int64_t S, int64_t C, int64_t R) {
  run(gf256::fused_encode, x, y, masks, S, C, R);
}

void fused_decode(const at::Tensor& x, at::Tensor y, const at::Tensor& masks,
                  int64_t S, int64_t C, int64_t R) {
  run(gf256::fused_decode, x, y, masks, S, C, R);
}

void fused_parity(const at::Tensor& x, at::Tensor y, const at::Tensor& masks,
                  int64_t S, int64_t C, int64_t R) {
  run(gf256::fused_parity, x, y, masks, S, C, R);
}

void fused_reconstruct(const at::Tensor& x, at::Tensor y,
                       const at::Tensor& masks, int64_t S, int64_t C,
                       int64_t R) {
  run(gf256::fused_reconstruct, x, y, masks, S, C, R);
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fused_encode", &fused_encode,
        "stripe-major stripes -> fragment-major planes (encode)");
  m.def("fused_decode", &fused_decode,
        "fragment-major survivors -> stripe-major stripes (decode)");
  m.def("fused_parity", &fused_parity,
        "stripe-major stripes -> fragment-major parity planes");
  m.def("fused_reconstruct", &fused_reconstruct,
        "fragment-major survivors -> fragment-major missing data rows");
}
