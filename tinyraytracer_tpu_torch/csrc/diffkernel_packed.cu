// Packed fused differentiable kernel (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/diffkernel_packed.py:240
// (`_make_packed_diff_kernel`): the training objective of scenes of at
// most 48 primitives and 16 spheres in one launch. Its plain PyTorch twin
// is `packed_diff_reference` in ops/diffkernel_packed.py. The estimator
// (shade, advance, color_adds, shadow_vis, the surrogates, bounce_adj and
// the per-pixel phases) lives in diff_common.cuh, shared with K4.
//
// Design: two kernels. image_kernel renders phase 1, the NEE image, one
// thread per pixel (and, under one wave of the card, per part of its
// samples, folded in sample order), at the 56-72 registers phase 1 needs.
// diff_kernel then runs on a grid of 128-thread blocks that the card
// holds at once (the host sizes it, ops/diff_schedule.py); each thread
// loops over pixels, reads its pixel's image for the loss cotangent and
// runs the replay and the adjoint in per-lane regeneration loops
// (diff_thread, diff_common.cuh). The replay saves a chunk of each
// thread's samples in the thread's own slots, so the scratch scales with
// the threads, not with the pixels.
// Gradients go into a per-thread accumulator laid out [sphere 4 | quad 9 |
// material 8 | light 12 per row | background 3 | loss 1]: the thread's
// column of a [na][128] block of shared memory when it fits beside the
// table without costing occupancy, else a local array. The block sums it
// with warp shuffles and then over its 4 warps in a fixed order into one
// row of partial sums per block; a second small kernel sums the rows over
// blocks in block order. Every sum has a fixed order, so two launches
// give the same bits (float atomics would not).
//
// The scene table is the JAX package's flat table, read as it is from
// shared memory and walked at run time; the estimator's switches (NEE,
// silhouette, metal and dielectric chains) are template arguments, one
// kernel per combination (dispatch_flags), and the surrogate classes
// run-time arguments that skip exactly what the TPU kernel compiles out.
//
// What bounds it: FP32 work (several shadings per bounce, the surrogates'
// per-sphere and per-quad chains) and the per-thread register footprint
// of the adjoint, not bandwidth: a save slot is written and read once per
// live bounce, the table and camera once per block.

#include "diff_common.cuh"

// megakernel.cu: adds per-sample colours up in sample order.
extern "C" int tinyrt_fold_samples(const float* samples, float* out,
                                   int npix, int spp, float inv_spp,
                                   void* stream);


namespace {

using namespace tinyrt;
using namespace tinyrt::diff;

constexpr int kMaxAcc = 1024;  // ops/diffkernel.py DIFF_PACKED_MAX_ACC
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
// Blocks per SM that ptxas must make room for (__launch_bounds__): 2
// leaves it 255 registers, 3 168, 4 128. 3 is the fastest at cfg5f and
// ties at cfg4class (PERF.md section 6 has the sweep): the NEE variants
// spill 170-230 bytes there, and a third block per SM pays for it; the
// others fit in 121-162 registers.
constexpr int kMinBlocks = 3;

// Dynamic shared memory of a block: camera, table, kWarps x na sums and,
// with a shared accumulator, its [na][kBlock] columns.
size_t smem_bytes(int nw, int na, bool shared_acc) {
  return sizeof(float) * ((size_t)kCamWords + nw + (size_t)kWarps * na +
                          (shared_acc ? (size_t)na * kBlock : 0));
}

// Phase 1 on its own (image_thread): the camera and table in shared
// memory, a thread per pixel and sample part, no accumulator.
template <class F>
__global__ void __launch_bounds__(kBlock)
    image_kernel(const float* __restrict__ cam_g,
                 const float* __restrict__ tab_g, Args a, Launch L, int nw,
                 int split, float* __restrict__ samples,
                 float* __restrict__ img) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < kCamWords + nw; i += kBlock) {
    smem[i] = i < kCamWords ? cam_g[i] : tab_g[i - kCamWords];
  }
  __syncthreads();
  a.cam = smem;
  a.tab = smem + kCamWords;
  image_thread<F>(a, L, split, samples, img);
}

template <class F>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    diff_kernel(const float* __restrict__ cam_g,
                const float* __restrict__ tab_g, Args a, ClassScope sc,
                Launch L, int nw, bool shared_acc,
                const float* __restrict__ target,
                const float* __restrict__ img, float4* __restrict__ saves,
                float* __restrict__ part) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < kCamWords + nw; i += kBlock) {
    smem[i] = i < kCamWords ? cam_g[i] : tab_g[i - kCamWords];
  }
  a.cam = smem;
  a.tab = smem + kCamWords;
  float* red = smem + kCamWords + nw;

  float local_acc[kMaxAcc];
  const StridedAcc acc =
      shared_acc ? StridedAcc{red + kWarps * L.na + threadIdx.x, kBlock}
                 : StridedAcc{local_acc, 1};
  for (int j = 0; j < L.na; ++j) acc.p[(size_t)j * acc.stride] = 0.0f;
  __syncthreads();

  const size_t tid = (size_t)blockIdx.x * kBlock + threadIdx.x;
  diff_thread<F>(a, sc, L, target, img, saves + tid * L.slots * kSlotVec,
                 acc);

  // ---- block sum of the accumulators, fixed order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < L.na; ++j) {
    float v = acc.p[(size_t)j * acc.stride];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * L.na + j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L.na; j += kBlock) {
    float v = red[j];
    for (int k = 1; k < kWarps; ++k) v = v + red[k * L.na + j];
    part[(size_t)blockIdx.x * L.na + j] = v;
  }
}

// Sums the per-block partial rows in block order; the loss entry is then
// divided by npix * 3 (the mean over pixels and channels).
__global__ void reduce_kernel(const float* __restrict__ part, int blocks,
                              int na, int loss_idx, float loss_div,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= na) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v = v + part[(size_t)b * na + j];
  out[j] = j == loss_idx ? v / loss_div : v;
}

struct Occupancy {
  bool image;
  size_t smem;
  int* per_sm;
  int* sms;
  template <class F>
  cudaError_t run() const {
    return image ? occupancy(image_kernel<F>, kBlock, smem, per_sm, sms)
                 : occupancy(diff_kernel<F>, kBlock, smem, per_sm, sms);
  }
};

struct Launcher {
  const float *cam, *tab;
  Args a;
  ClassScope sc;
  Launch L;
  int nw;
  bool shared_acc;
  int split;  // the image kernel's sample parts
  const float* target;
  float *img, *samples;
  float4* saves;
  float* part;
  int blocks;
  cudaStream_t st;
  template <class F>
  cudaError_t run() const {
    const dim3 grid((L.npix + kBlock - 1) / kBlock, split);
    image_kernel<F><<<grid, kBlock, smem_bytes(nw, 0, false), st>>>(
        cam, tab, a, L, nw, split, samples, img);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess && split > 1) {
      e = (cudaError_t)tinyrt_fold_samples(samples, img, L.npix, L.spp,
                                           L.inv_spp, st);
    }
    if (e != cudaSuccess) return e;
    const size_t smem = smem_bytes(nw, L.na, shared_acc);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(diff_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    diff_kernel<F><<<blocks, kBlock, smem, st>>>(
        cam, tab, a, sc, L, nw, shared_acc, target, img, saves, part);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Blocks of K5's kernel (`image` 0) or of its image kernel (1) for these
// switches that one SM holds at once (*per_sm, 0 if a block does not
// fit), for a table of nw floats and an accumulator of na, shared or
// local; and the device's SMs (*sms). Returns a cudaError_t (0 on
// success).
int tinyrt_diff_packed_occupancy(int nw, int na, int shared_acc, int image,
                                 int nee, int sil, int has_met, int has_die,
                                 int* per_sm, int* sms) {
  *per_sm = 0;
  const size_t smem = image ? smem_bytes(nw, 0, false)
                            : smem_bytes(nw, na, shared_acc != 0);
  if (smem > 227 * 1024) return 0;
  return (int)dispatch_flags(nee != 0, sil != 0, has_met != 0, has_die != 0,
                             Occupancy{image != 0, smem, per_sm, sms});
}

// Runs K5 on `stream` with `blocks` blocks: writes the (height, width, 3)
// image into `img` and the summed gradient accumulator (see the file
// comment) into `acc`. Phase 1 runs first in the image kernel, each
// pixel's samples in `split` parts (`samples` then holds spp x npix x 3
// floats of per-sample colours when split > 1). `saves` holds blocks x
// 128 x slots x 16 floats of scratch (slots >= max_bounces), `part`
// blocks x na. Returns the first failing launch's cudaError_t (0 on
// success); does not synchronise.
int tinyrt_diff_packed(const float* cam, const float* tab, int nw, int n_sph,
                       int n_quad, int n_lights, int nm, int light_quad,
                       const float* target, float* img, float* saves,
                       float* part, float* acc, int width, int height,
                       unsigned int seed, unsigned int spp_offset, int spp,
                       int max_bounces, float inv_spp, int nee, int sil,
                       int has_met, int has_die, int surr_sph, int surr_quad,
                       int blocks, int slots, int shared_acc, int split,
                       float* samples, void* stream) {
  Args a{};
  const int na = set_layout(a, n_sph, n_quad, n_lights, nm, light_quad);
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
  if (na > kMaxAcc || blocks < 1 || slots < max_bounces || split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launcher launch{cam,   tab,
                        a,     ClassScope{surr_sph ? n_sph : 0,
                                          surr_quad ? n_quad : 0},
                        L,     nw,
                        shared_acc != 0, split,
                        target, img,
                        samples, reinterpret_cast<float4*>(saves),
                        part,  blocks,
                        st};
  cudaError_t e = dispatch_flags(nee != 0, sil != 0, has_met != 0,
                                 has_die != 0, launch);
  if (e != cudaSuccess) return (int)e;
  const float loss_div = (float)(width * height) * 3.0f;
  reduce_kernel<<<(na + 127) / 128, 128, 0, st>>>(part, blocks, na,
                                                  a.a_loss, loss_div, acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
