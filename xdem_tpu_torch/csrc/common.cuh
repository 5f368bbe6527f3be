// Shared pieces of the terrain kernels: block tile geometry, NaN-propagating min/max and
// the halo tile loader.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace xdt {

// One thread per output pixel; a block covers a kTileY x kTileX patch of the raster.
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
// Shared memory one block may use on sm_90 (227 KB of the SM's 256 KB).
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// jnp.maximum and jnp.clip propagate NaN; fmaxf/fminf return the non-NaN operand.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}

// The same in one instruction each: PTX max.NaN and min.NaN (sm_80+) propagate NaN as
// torch.maximum, torch.minimum and torch.clamp do.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Stage the (sh, sw) patch whose top-left corner is raster pixel (r0 - halo, c0 - halo)
// into shared memory, NaN beyond the raster edge (the NaN padding of the reference).
__device__ __forceinline__ void load_tile(float* tile, int sh, int sw,
                                          const float* __restrict__ src, int H, int W,
                                          int r0, int c0, int halo) {
  const int n = sh * sw;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += blockDim.x * blockDim.y) {
    const int r = r0 - halo + i / sw;
    const int c = c0 - halo + i % sw;
    tile[i] = (r >= 0 && r < H && c >= 0 && c < W) ? src[(size_t)r * W + c] : qnan();
  }
}

// Window accessor: z(u, v) is the value at offset (u, v) from a window's top-left corner.
// Used when a window's tile does not fit in shared memory: bounds-checked global reads.
struct GlobalView {
  const float* __restrict__ src;
  int H, W, r, c;
  __device__ __forceinline__ float operator()(int u, int v) const {
    const int rr = r + u, cc = c + v;
    return (rr >= 0 && rr < H && cc >= 0 && cc < W) ? __ldg(src + (size_t)rr * W + cc) : qnan();
  }
};

}  // namespace xdt
