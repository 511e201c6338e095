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
// - One thread per pixel runs the pixel's whole estimator (diff_pixel), as
//   in K5. The TPU kernel's (rows, lanes) candidate matrices and one-hot
//   payload products become a walk over the table's real rows in scene
//   order with a strict `<` (the first minimum, as the TPU's argmin), and
//   the winner's fields read by row index. `row_chunk` streaming has no
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
//   is capped at the blocks the card holds at once (and at what the
//   scratch budget allows); each thread loops over pixels tid, tid + T,
//   ... (T threads in all) and adds into its own column of a global
//   [na][T] scratch, so a warp's adds coalesce, and skips exact-zero
//   terms (ColumnAcc). At the end each warp sums its 32 columns with
//   shuffles into one row of a [warps][na] table; a second kernel sums, per
//   entry, the 4 warps of a block in order and then the blocks in order.
//   Every sum has a fixed order, so two launches give the same bits. The
//   scratch (na x T floats, T = blocks x 128) and the saves ([bounce][14]
//   [T]) do not grow with the pixel count.
//
// What bounds it: FP32 work. A live bounce walks every row twice (phase 1
// and the replay) and re-shades in the adjoint; a dense scope adds each
// listed sphere's silhouette (and soft shadow under a light). The scratch
// traffic is one read and one write per non-zero term.

#include "diff_common.cuh"

namespace {

using namespace tinyrt;
using namespace tinyrt::diff;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

struct Launch {
  int npix, width, spp, mb, na;
  uint32_t spp_offset;
  float inv_spp;
};

__global__ void __launch_bounds__(kBlock)
    classic_kernel(const float* __restrict__ cam_g, Args a, RowScope sc,
                   Launch L, const float* __restrict__ target,
                   float* __restrict__ img, float* __restrict__ saves,
                   float* __restrict__ cols, float* __restrict__ wpart) {
  __shared__ float cam[kCamWords];
  for (int i = threadIdx.x; i < kCamWords; i += kBlock) cam[i] = cam_g[i];
  __syncthreads();
  a.cam = cam;

  const size_t nt = (size_t)gridDim.x * kBlock;
  const int tid = blockIdx.x * kBlock + threadIdx.x;
  float* col = cols + tid;
  for (int j = 0; j < L.na; ++j) col[(size_t)j * nt] = 0.0f;
  const ColumnAcc acc{col, nt};
  for (int pix = tid; pix < L.npix; pix += (int)nt) {
    diff_pixel(a, sc, pix, L.width, L.spp, L.mb, L.spp_offset, L.inv_spp,
               target, img, saves + tid, nt, acc);
  }

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

}  // namespace

extern "C" {

// The grid K4 launches for `npix` pixels and an accumulator of `na`
// floats on the current device: at most the blocks the card holds at once,
// no more than the pixels need, and few enough that the [na][threads]
// scratch stays within `max_cols` floats. Writes it to *blocks; returns a
// cudaError_t (0 on success).
int tinyrt_diff_classic_blocks(int npix, int na, long long max_cols,
                               int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, classic_kernel,
                                                      kBlock, 0);
  }
  if (e != cudaSuccess) return (int)e;
  long long n = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = ((long long)npix + kBlock - 1) / kBlock;
  const long long fit = max_cols / ((long long)(na > 0 ? na : 1) * kBlock);
  if (need < n) n = need;
  if (fit < n) n = fit;
  *blocks = (int)(n > 0 ? n : 1);
  return 0;
}

// Runs K4 on `stream` with `blocks` blocks (tinyrt_diff_classic_blocks):
// writes the (height, width, 3) image into `img` and the summed gradient
// accumulator (layout as K5's) into `acc`. `surr_s` / `surr_q` list the
// sphere / quad table rows whose surrogates run (n_s, n_q of them).
// Scratch: `saves` max_bounces x 14 x T floats, `cols` na x T, `wpart`
// blocks x 4 x na (T = blocks x 128). Returns the first failing launch's
// cudaError_t (0 on success); does not synchronise.
int tinyrt_diff_classic(const float* cam, const float* tab, int n_sph,
                        int n_quad, int n_lights, int nm, int light_quad,
                        const int* surr_s, int n_s, const int* surr_q,
                        int n_q, const float* target, float* img,
                        float* saves, float* cols, float* wpart, float* acc,
                        int blocks, int width, int height, unsigned int seed,
                        unsigned int spp_offset, int spp, int max_bounces,
                        float inv_spp, int nee, int sil, int has_met,
                        int has_die, void* stream) {
  Args a{};
  const int na = set_layout(a, n_sph, n_quad, n_lights, nm, light_quad);
  a.tab = tab;
  a.nee = nee != 0;
  a.sil = sil != 0;
  a.has_met = has_met != 0;
  a.has_die = has_die != 0;
  a.seed = seed;
  const RowScope sc{surr_s, surr_q, n_s, n_q};
  Launch L;
  L.npix = width * height;
  L.width = width;
  L.spp = spp;
  L.mb = max_bounces;
  L.na = na;
  L.spp_offset = spp_offset;
  L.inv_spp = inv_spp;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  classic_kernel<<<blocks, kBlock, 0, st>>>(cam, a, sc, L, target, img, saves,
                                            cols, wpart);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float loss_div = (float)(width * height) * 3.0f;
  classic_reduce<<<(na + 127) / 128, 128, 0, st>>>(wpart, blocks, na,
                                                   a.a_loss, loss_div, acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
