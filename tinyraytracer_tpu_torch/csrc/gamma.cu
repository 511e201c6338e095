// The render's gamma on the card: out = max(in, 0) ^ inv_gamma, elementwise
// over a float32 framebuffer, for ops/tonemap.py `gamma_cuda`.
//
// No TPU kernel: the JAX package, like the reference (utils/image.rs:29-36),
// raises the image to the power on the host, after the readback. Here the
// power runs on the framebuffer's stream right after the render kernel, so
// the host receives the corrected image and no host core holds the card
// idle while it computes 3 x H x W powers.
//
// Each value: m = np.maximum(x, 0) (NaN passes through; negatives and -0.0
// become +0), then pow((double) m, (double) inv_gamma) rounded once to
// float: the power in double precision, rounded to float32, as the host
// twin `tonemap.gamma_reference` computes it. Not powf or __powf, whose
// float results may be off in the last places.
//
// Bound: 8 bytes an element cross the card's memory (4 read, 4 written;
// 8.64 MB at 600x600: 2.6 us at 3.35 TB/s), but the double power, a few
// hundred FP64 instructions an element at half the FP32 rate, takes
// longer: ~10 us a launch at 600x600, against ~62 ms of render (PERF.md,
// section 6). Each thread moves one float4 (16-byte loads and stores,
// neighbouring threads on neighbouring addresses, four independent powers
// in flight) when both pointers are 16-byte aligned, else one float; the
// first threads also take the 1-3 values past the last whole float4. The
// grid comes from the element count.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gamma_one(float x, double inv_gamma) {
  const float m = x <= 0.0f ? 0.0f : x;  // NaN compares false: it stays
  return static_cast<float>(pow(static_cast<double>(m), inv_gamma));
}

// vec: in and out are 16-byte aligned; thread i takes float4 i and, for
// i < n % 4, the value 4 * (n / 4) + i.
__global__ void __launch_bounds__(kThreads)
    gamma_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long n, int vec, double inv_gamma) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (!vec) {
    if (i < n) out[i] = gamma_one(in[i], inv_gamma);
    return;
  }
  const long n4 = n >> 2;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(in)[i];
    v.x = gamma_one(v.x, inv_gamma);
    v.y = gamma_one(v.y, inv_gamma);
    v.z = gamma_one(v.z, inv_gamma);
    v.w = gamma_one(v.w, inv_gamma);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  if (i < (n & 3)) {
    const long k = (n4 << 2) + i;
    out[k] = gamma_one(in[k], inv_gamma);
  }
}

}  // namespace

extern "C" {

// out[k] = max(in[k], 0) ^ inv_gamma for k < n, on `stream`; `in` is only
// read (out of place: the caller's linear image stays as it was). Returns
// the launch's cudaError_t (0 on success, cudaErrorInvalidValue for n < 0
// or in == out); does not synchronise.
int tinyrt_gamma(const float* in, float* out, long n, float inv_gamma,
                 void* stream) {
  if (n < 0 || (n > 0 && in == out)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int vec = (reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long threads = vec ? ((n >> 2) > 3 ? (n >> 2) : 3) : n;
  const long blocks = (threads + kThreads - 1) / kThreads;
  gamma_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      in, out, n, vec, static_cast<double>(inv_gamma));
  return (int)cudaGetLastError();
}

}  // extern "C"
