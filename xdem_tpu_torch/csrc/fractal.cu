// K3: fractal roughness by Taud & Parrot (2005) voxel box counting.
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::fractal_roughness_pallas (kernel body
// _make_fractal_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/window.py::fractal_roughness.
//
// What bounds it on the H100: the per-pixel box maxima. For each divisor q of w // 2 a pixel
// takes ((w - 1) // q)^2 box maxima of q x q values, so every scale re-reads the (w - 1)^2
// neighbourhood: 576 shared-memory reads per pixel at w = 13, against one f32 read and one
// f32 write of HBM. The kernel is bound by shared-memory load issue, not by HBM.
//
// Design: one thread per output pixel over a shared-memory tile of (tile + 2*halo)^2 with NaN
// beyond the raster (bounds-checked global loads when the tile would exceed 227 KB). Boxes
// start at (j*q, k*q) from the window's top-left corner, so the last row and column of the
// w x w window are never read, exactly as the reference. Maxima and the clip propagate NaN
// explicitly, so any NaN in the window poisons the result. Building large boxes from cached
// small ones, as the TPU kernel does, is left for a later version: here every scale re-reads.
#include "common.cuh"

namespace {

using namespace xdt;

// Divisors of w // 2: numbers below 10^4 have at most 64 of them.
constexpr int kMaxScales = 64;

struct FracParams {
  int w, n_q;
  int q[kMaxScales];
  float log_q[kMaxScales];
  float mx, ss_xx;  // mean of log q and its centred sum of squares, in f32
};

template <class View>
__device__ float fractal_pixel(const View& z, const FracParams& p) {
  const int w = p.w;
  const int hw = w / 2;
  const float center = z(hw, hw);
  const float wf = (float)w;
  float sum_y = 0.f, sum_xy = 0.f;
  for (int i = 0; i < p.n_q; ++i) {
    const int q = p.q[i];
    const int nq = (w - 1) / q;
    float ns = 0.f;
    for (int j = 0; j < nq; ++j) {
      for (int k = 0; k < nq; ++k) {
        float m = z(j * q, k * q);
        for (int u = 0; u < q; ++u) {
          for (int v = 0; v < q; ++v) m = max_nan(m, z(j * q + u, k * q + v));
        }
        ns = ns + clip_nan(m - center, 0.f, wf);
      }
    }
    const float y = logf(ns / (float)q);
    sum_y = sum_y + y;
    sum_xy = sum_xy + p.log_q[i] * y;
  }
  const float my = sum_y / (float)p.n_q;
  const float ss_xy = sum_xy - (float)p.n_q * my * p.mx;
  return -(ss_xy / p.ss_xx);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    fractal_kernel(const float* __restrict__ dem, float* __restrict__ out, int H, int W,
                   FracParams p) {
  const int hw = p.w / 2;
  const int c0 = blockIdx.x * kTileX;
  const int r0 = blockIdx.y * kTileY;
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if constexpr (kShared) {
    extern __shared__ float tile[];
    const int sw = kTileX + 2 * hw;
    const int sh = kTileY + 2 * hw;
    load_tile(tile, sh, sw, dem, H, W, r0, c0, hw);
    __syncthreads();
    if (r >= H || c >= W) return;
    const SharedView z{tile, sw, (int)threadIdx.y, (int)threadIdx.x};
    out[(size_t)r * W + c] = fractal_pixel(z, p);
  } else {
    if (r >= H || c >= W) return;
    const GlobalView z{dem, H, W, r - hw, c - hw};
    out[(size_t)r * W + c] = fractal_pixel(z, p);
  }
}

}  // namespace

// qs, log_q: the n_q divisors of w // 2 and their f32 logarithms (host memory).
extern "C" int launch_fractal(const float* dem, float* out, int H, int W, int w, int n_q,
                              const int* qs, const float* log_q, float mx, float ss_xx,
                              void* stream) {
  if (w < 5 || n_q < 1 || n_q > kMaxScales || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  FracParams p{};
  p.w = w;
  p.n_q = n_q;
  for (int i = 0; i < n_q; ++i) {
    p.q[i] = qs[i];
    p.log_q[i] = log_q[i];
  }
  p.mx = mx;
  p.ss_xx = ss_xx;

  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = w / 2;
  const size_t smem = sizeof(float) * (size_t)(kTileX + 2 * hw) * (size_t)(kTileY + 2 * hw);
  if (smem <= (size_t)kMaxSharedBytes) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fractal_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    fractal_kernel<true><<<grid, block, smem, s>>>(dem, out, H, W, p);
  } else {
    fractal_kernel<false><<<grid, block, 0, s>>>(dem, out, H, W, p);
  }
  return (int)cudaGetLastError();
}
