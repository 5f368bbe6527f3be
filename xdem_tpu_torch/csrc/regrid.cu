// One fixed-point step of the small-rotation regrid (tier 3 of a matrix apply), bilinear.
//
// Replaces no TPU kernel: the JAX package leaves this loop to XLA
// (xdem_tpu/coreg/base.py::_iterate_affine_regrid_small_rotations). Caller:
// xdem_tpu_torch/coreg/base.py::_iterate_affine_regrid_small_rotations, which launches it once a
// step (through _regrid_step_on_card) on a CUDA float32 DEM with linear resampling. Plain PyTorch
// twin: _regrid_step_aten in the same module (with ops/interp.py::interp_rowcol), which a CPU
// tensor or another resampling takes. That is ~90 elementwise and gather passes a step, each
// reading and writing whole float32 or int64 planes.
//
// A thread takes one pixel at a time, down a column, and keeps everything in registers: the
// node's world coordinates (X, Y) about the centroid, the inverse transform of (X, Y, guess),
// its source row and column, the four clamped neighbours of the DEM and their bilinear blend,
// the forward transform, which overwrites the guess in place, and the horizontal residual in
// pixels. The residual of each pixel whose new guess is finite (0 elsewhere) goes into a
// block maximum and one atomicMax a block on its bits: the residuals are non-negative, so
// their bits order as their values and the maximum is the same whatever the order.
//
// Bit-equal to the ATen loop on the card: built with -fmad=false (each multiply and add rounds
// on its own, as separate ATen passes do), each Python scalar rounded once to float32 by the
// caller (as ATen does with a wrapped scalar on a float32 tensor), ATen's order of operations,
// IEEE divisions by the determinant and the pixel sizes (the loop divides by tensors on the
// card, never by a scalar's reciprocal) and every neighbour gathered, a zero-weight one too (a
// NaN there poisons the pixel, as 0 * NaN does in the loop).
//
// What bounds it on the H100: bytes. A read of the guess, a write of the new guess and a read
// of the DEM near the same pixel (the gathers hit the cache for small rotations): 1.2 GB at
// 10 000^2, 0.36 ms against 3.35 TB/s.
// Indices are 64-bit: one card holds DEMs of more than 2^31 values.
#include <string.h>

#include "common.cuh"

namespace {

using namespace xdt;

constexpr int kRegridThreads = 256;
// Blocks a launch aims for: enough waves to fill the SMs, few atomics on the maximum.
constexpr long long kRegridBlocks = 4096;
constexpr long long kMaxGridY = 65535;

// The step's constants, each rounded once to float32 by the caller, in this order.
struct RegridParams {
  float a, b, c, d, e, f;  // the DEM's affine transform; c and f less the centroid's x and y
  float mi[2][4];          // rows 0 and 1 of the inverse matrix
  float mf[3][4];          // rows 0-2 of the matrix
  float det;               // a * e - b * d
  float col_off, row_off;  // the pixel offsets of the centroid, less 0.5
  float cz;                // the centroid's z
  float res_x, res_y;      // the pixel sizes
};
static_assert(sizeof(RegridParams) == 32 * sizeof(float), "the caller passes 32 floats");

// One pixel's step: `z` is the guess on entry and the new guess on return. Returns the
// horizontal residual in pixels, 0 where the new guess is not finite.
__device__ __forceinline__ float regrid_pixel(const float* __restrict__ dem, long long h, long long w,
                                              long long row, long long col, float& z,
                                              const RegridParams& p) {
  const float xc = (float)col + 0.5f;
  const float yr = (float)row + 0.5f;
  const float X = p.a * xc + p.b * yr + p.c;
  const float Y = p.d * xc + p.e * yr + p.f;
  const float xs = p.mi[0][0] * X + p.mi[0][1] * Y + p.mi[0][2] * z + p.mi[0][3];
  const float ys = p.mi[1][0] * X + p.mi[1][1] * Y + p.mi[1][2] * z + p.mi[1][3];
  const float colp = (p.e * xs - p.b * ys) / p.det + p.col_off;
  const float rowp = (-p.d * xs + p.a * ys) / p.det + p.row_off;
  float v = qnan();
  if (rowp >= 0.0f && rowp <= (float)(h - 1) && colp >= 0.0f && colp <= (float)(w - 1)) {
    const float r0f = floorf(rowp), c0f = floorf(colp);
    const float fr = rowp - r0f, fc = colp - c0f;
    // The loop's clamp of each index: at the last row or column the second neighbour is the
    // first again, with weight 0.
    const long long r0 = min((long long)r0f, h - 1), c0 = min((long long)c0f, w - 1);
    const float* __restrict__ top_row = dem + r0 * w;
    const float* __restrict__ bot_row = dem + min(r0 + 1, h - 1) * w;
    const long long c1 = min(c0 + 1, w - 1);
    const float top = __ldg(top_row + c0) * (1.0f - fc) + __ldg(top_row + c1) * fc;
    const float bot = __ldg(bot_row + c0) * (1.0f - fc) + __ldg(bot_row + c1) * fc;
    v = top * (1.0f - fr) + bot * fr;
  }
  const float zsrc = v - p.cz;
  const float xf = p.mf[0][0] * xs + p.mf[0][1] * ys + p.mf[0][2] * zsrc + p.mf[0][3];
  const float yf = p.mf[1][0] * xs + p.mf[1][1] * ys + p.mf[1][2] * zsrc + p.mf[1][3];
  z = p.mf[2][0] * xs + p.mf[2][1] * ys + p.mf[2][2] * zsrc + p.mf[2][3];
  const float res = hypotf((xf - X) / p.res_x, (yf - Y) / p.res_y);
  return isfinite(z) ? res : 0.0f;
}

// Block (x, y) takes 256 columns and every gridDim.y-th row from row y.
__global__ void __launch_bounds__(kRegridThreads)
regrid_step_kernel(const float* __restrict__ dem, float* __restrict__ zg, long long h, long long w,
                   const RegridParams p, unsigned* __restrict__ maxres) {
  const long long col = (long long)blockIdx.x * kRegridThreads + threadIdx.x;
  unsigned largest = 0;  // the bits of the largest residual
  if (col < w) {
    for (long long row = blockIdx.y; row < h; row += gridDim.y) {
      float* __restrict__ z = zg + row * w + col;
      float guess = *z;
      largest = max(largest, __float_as_uint(regrid_pixel(dem, h, w, row, col, guess, p)));
      *z = guess;
    }
  }
  __shared__ unsigned warp_largest[kRegridThreads / 32];
  largest = __reduce_max_sync(0xffffffffu, largest);
  if ((threadIdx.x & 31) == 0) {
    warp_largest[threadIdx.x / 32] = largest;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kRegridThreads / 32; ++i) {
      largest = max(largest, warp_largest[i]);
    }
    atomicMax(maxres, largest);
  }
}

}  // namespace

// dem, zg: h x w float32, contiguous, on the card (zg is read and overwritten); params: 32 host
// floats in the order of RegridParams; maxres: one float32 on the card, set to the step's
// largest residual. Zeroes maxres and launches on `stream`.
extern "C" int launch_regrid_step(const float* dem, float* zg, long long h, long long w, const float* params,
                                  float* maxres, void* stream) {
  const long long gx = (w + kRegridThreads - 1) / kRegridThreads;
  if (h <= 0 || w <= 0 || gx > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  RegridParams p;
  memcpy(&p, params, sizeof p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(maxres, 0, sizeof(float), s);
  if (rc != cudaSuccess) {
    return (int)rc;
  }
  long long gy = kRegridBlocks / gx;
  gy = gy < 1 ? 1 : (gy > h ? h : gy);
  gy = gy > kMaxGridY ? kMaxGridY : gy;
  regrid_step_kernel<<<dim3((unsigned)gx, (unsigned)gy), kRegridThreads, 0, s>>>(
      dem, zg, h, w, p, reinterpret_cast<unsigned*>(maxres));
  return (int)cudaGetLastError();
}
