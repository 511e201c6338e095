// Classic-layout fused differentiable kernel (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/diffkernel.py:357
// (`_make_diff_kernel`): the training objective (NEE image, MSE loss and
// hand-derived adjoint) of scenes of any size, with any surrogate scope.
// The JAX package sends it explicit surrogate row subsets
// (`trainable_rows`), scenes of more than 48 primitives or 16 spheres and,
// past its VMEM model, the row-streamed step; the port also sends it the
// scenes whose gradient table overflows K5's 1 024-float accumulator. Its
// plain PyTorch twin is `packed_diff_reference` in
// ops/diffkernel_packed.py, the twin of K5 as well: the estimator is K5's,
// function by function (diff_common.cuh).
//
// Design, and what it does about the TPU kernel's layout:
// - As in K5, classic_image_kernel renders the NEE image first (a thread
//   per pixel and sample part), then a thread of classic_kernel runs a
//   pixel's replay and adjoint at a time (diff_thread). The TPU
//   kernel's (rows, lanes) candidate matrices and one-hot payload
//   products become a walk over the table's real rows in scene order with
//   a strict `<` (the first minimum, as the TPU's argmin), and the
//   winner's fields read by row index. `row_chunk` streaming has no
//   counterpart: the walk reads any number of rows.
// - The table is K5's flat table (spheres, quads, lights, AoS rows) read
//   from global memory: all threads of a warp read the same row at once,
//   so each load is a broadcast served by L1. Shared memory would not hold
//   8 000 spheres.
// - The surrogate scope is one device list of table rows per class
//   (RowScope), so dense, off and subset run one code path. The
//   soft-shadow visibility product runs over the listed rows only, as the
//   TPU kernel's code does (diffkernel.py:1729-1755).
// - The gradient table has any width (na floats: about 6 150 for 512
//   spheres with 512 materials), too wide for a per-thread array. The grid
//   is one the card holds at once, sized on the host
//   (ops/diff_schedule.py) so that every thread gets the same number of
//   pixels, give or take one, and the scratch stays within its budget.
//   Each thread loops over pixels with K5's per-lane regeneration loops
//   (diff_common.cuh) and adds into its own column of a
//   global [na][T] scratch (T threads in all), so a warp's adds coalesce,
//   skipping exact-zero terms. At the end each warp sums its 32 columns
//   with shuffles into one row of a [warps][na] table; a second kernel
//   sums, per entry, the 4 warps of a block in order and then the blocks
//   in order. Every sum has a fixed order, so two launches give the same
//   bits. The scratch (na x T floats) and the replay's save slots (T x
//   slots x 16 floats) do not grow with the pixel count.
//
// What bounds it: FP32 work. A live bounce walks every row twice (phase 1
// and the replay) and re-shades in the adjoint; a dense scope adds each
// listed sphere's silhouette (and soft shadow under a light). The scratch
// traffic is one read and one write per non-zero term.

#include "diff_common.cuh"

// megakernel.cu: adds per-sample colours up in sample order.
extern "C" int tinyrt_fold_samples(const float* samples, float* out,
                                   int npix, int spp, float inv_spp,
                                   void* stream);


namespace {

using namespace tinyrt;
using namespace tinyrt::diff;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
// Blocks per SM that ptxas must make room for (__launch_bounds__): 2
// leaves it 255 registers, 3 168, 4 128. 3 is the fastest at cfg5f and
// ties at cfg4class (PERF.md section 6 has the sweep): the NEE variants
// spill 170-230 bytes there, and a third block per SM pays for it; the
// others fit in 121-162 registers.
constexpr int kMinBlocks = 3;

// Phase 1 on its own (image_thread): a thread per pixel and sample part,
// no accumulator.
template <class F>
__global__ void __launch_bounds__(kBlock)
    classic_image_kernel(const float* __restrict__ cam_g, Args a, Launch L,
                         int split, float* __restrict__ samples,
                         float* __restrict__ img) {
  __shared__ float cam[kCamWords];
  for (int i = threadIdx.x; i < kCamWords; i += kBlock) cam[i] = cam_g[i];
  __syncthreads();
  a.cam = cam;
  image_thread<F>(a, L, split, samples, img);
}

template <class F>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    classic_kernel(const float* __restrict__ cam_g, Args a, RowScope sc,
                   Launch L, const float* __restrict__ target,
                   const float* __restrict__ img, float4* __restrict__ saves,
                   float* __restrict__ cols, float* __restrict__ wpart) {
  __shared__ float cam[kCamWords];
  for (int i = threadIdx.x; i < kCamWords; i += kBlock) cam[i] = cam_g[i];
  __syncthreads();
  a.cam = cam;

  const size_t nt = (size_t)gridDim.x * kBlock;
  const size_t tid = (size_t)blockIdx.x * kBlock + threadIdx.x;
  float* col = cols + tid;
  for (int j = 0; j < L.na; ++j) col[(size_t)j * nt] = 0.0f;
  diff_thread<F>(a, sc, L, target, img, saves + tid * L.slots * kSlotVec,
                 StridedAcc{col, nt});

  // ---- each warp's 32 columns, summed with shuffles in a fixed order
  const int lane = threadIdx.x & 31;
  const size_t warp = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int j = 0; j < L.na; ++j) {
    float v = col[(size_t)j * nt];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) wpart[warp * L.na + j] = v;
  }
}

// Sums the warp rows per block in warp order, then the blocks in block
// order; the loss entry is then divided by npix * 3 (the mean over pixels
// and channels).
__global__ void classic_reduce(const float* __restrict__ wpart, int blocks,
                               int na, int loss_idx, float loss_div,
                               float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= na) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) {
    const float* w = wpart + (size_t)b * kWarps * na + j;
    float s = w[0];
    for (int k = 1; k < kWarps; ++k) s = s + w[(size_t)k * na];
    v = v + s;
  }
  out[j] = j == loss_idx ? v / loss_div : v;
}

struct Occupancy {
  bool image;
  int* per_sm;
  int* sms;
  template <class F>
  cudaError_t run() const {
    return image ? occupancy(classic_image_kernel<F>, kBlock, 0, per_sm, sms)
                 : occupancy(classic_kernel<F>, kBlock, 0, per_sm, sms);
  }
};

struct Launcher {
  const float* cam;
  Args a;
  RowScope sc;
  Launch L;
  int split;  // the image kernel's sample parts
  const float* target;
  float *img, *samples;
  float4* saves;
  float *cols, *wpart;
  int blocks;
  cudaStream_t st;
  template <class F>
  cudaError_t run() const {
    const dim3 grid((L.npix + kBlock - 1) / kBlock, split);
    classic_image_kernel<F><<<grid, kBlock, 0, st>>>(cam, a, L, split,
                                                     samples, img);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess && split > 1) {
      e = (cudaError_t)tinyrt_fold_samples(samples, img, L.npix, L.spp,
                                           L.inv_spp, st);
    }
    if (e != cudaSuccess) return e;
    classic_kernel<F><<<blocks, kBlock, 0, st>>>(cam, a, sc, L, target, img,
                                                 saves, cols, wpart);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Blocks of K4's kernel (`image` 0) or of its image kernel (1) for these
// switches that one SM holds at once (*per_sm), and the device's SMs
// (*sms). Returns a cudaError_t (0 on success).
int tinyrt_diff_classic_occupancy(int image, int nee, int sil, int has_met,
                                  int has_die, int* per_sm, int* sms) {
  return (int)dispatch_flags(nee != 0, sil != 0, has_met != 0, has_die != 0,
                             Occupancy{image != 0, per_sm, sms});
}

// Runs K4 on `stream` with `blocks` blocks (ops/diff_schedule.py): writes
// the (height, width, 3) image into `img` and the summed gradient
// accumulator (layout as K5's) into `acc`. `surr_s` / `surr_q` list the
// sphere / quad table rows whose surrogates run (n_s, n_q of them). Phase
// 1 runs first in the image kernel, each pixel's samples in `split` parts
// (`samples` then holds spp x npix x 3 floats when split > 1). Scratch:
// `saves` T x slots x 16 floats (slots >= max_bounces), `cols` na x T,
// `wpart` blocks x 4 x na (T = blocks x 128). Returns the first failing
// launch's cudaError_t (0 on success); does not synchronise.
int tinyrt_diff_classic(const float* cam, const float* tab, int n_sph,
                        int n_quad, int n_lights, int nm, int light_quad,
                        const int* surr_s, int n_s, const int* surr_q,
                        int n_q, const float* target, float* img,
                        float* saves, float* cols, float* wpart, float* acc,
                        int blocks, int slots, int width, int height,
                        unsigned int seed, unsigned int spp_offset, int spp,
                        int max_bounces, float inv_spp, int nee, int sil,
                        int has_met, int has_die, int split, float* samples,
                        void* stream) {
  Args a{};
  const int na = set_layout(a, n_sph, n_quad, n_lights, nm, light_quad);
  a.tab = tab;
  a.seed = seed;
  Launch L;
  L.npix = width * height;
  L.width = width;
  L.spp = spp;
  L.mb = max_bounces;
  L.na = na;
  L.slots = slots;
  L.spp_offset = spp_offset;
  L.inv_spp = inv_spp;
  if (blocks < 1 || slots < max_bounces || split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launcher launch{cam,    a,       RowScope{surr_s, surr_q, n_s, n_q},
                        L,      split,   target,
                        img,    samples, reinterpret_cast<float4*>(saves),
                        cols,   wpart,   blocks,
                        st};
  cudaError_t e = dispatch_flags(nee != 0, sil != 0, has_met != 0,
                                 has_die != 0, launch);
  if (e != cudaSuccess) return (int)e;
  const float loss_div = (float)(width * height) * 3.0f;
  classic_reduce<<<(na + 127) / 128, 128, 0, st>>>(wpart, blocks, na,
                                                   a.a_loss, loss_div, acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
