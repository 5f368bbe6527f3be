// K3: fractal roughness by Taud & Parrot (2005) voxel box counting.
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::fractal_roughness_pallas (kernel body
// _make_fractal_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/window.py::fractal_roughness.
//
// What bounds it on the H100: arithmetic. For each divisor q of w // 2 a pixel adds
// ((w - 1) // q)^2 clipped box heights, each a subtraction, a max, a min and an add that
// cannot fuse (-fmad=false, and none is a multiply-add): 200 boxes, ~830 f32 operations per
// pixel at w = 13, against one f32 read and one f32 write of HBM. The rate at which the SMs
// dispatch those instructions sets the floor, so the design removes every other one it can:
//   * Box-maxima planes in shared memory. A block stages its raw patch (tile + w - 2 halo,
//     NaN beyond the raster) once, coalesced, then builds M_q(y, x) = max of the q x q box
//     at (y, x) for every scale, each from its largest proper divisor (already built),
//     separably: rows into a scratch plane, then columns, as window.fractal_roughness does.
//     Max is exact, so the planes hold the plain version's box maxima to the bit. Counting
//     reads one plane value per box: 200 reads per pixel at w = 13 instead of 576.
//   * Compile-time windows. The odd windows 5-21 (13 is the suite's and the public
//     default) are template instances: scales, box counts and offsets are constants.
//   * Register blocking. Such a block covers 64 x 32 pixels with 64 x 8 threads; a thread
//     owns R = 4 pixels down a column and loads each plane value once for all of its pixels
//     whose boxes use it (84 shared loads per pixel at w = 13). Each pixel still adds its
//     boxes in the plain order (j outer, k inner, from 0), then takes log, sum_y, sum_xy
//     and the slope in the plain order, so the kernel is bit-equal to its plain version.
//     The box columns of a plane row run in rolled steps of up to 12, unrolled within (all
//     of them at w = 13). R = 4 and steps of 12 were the fastest of R = 2, 4, 8 and 16 and
//     steps of 1, 2, 3, 4, 6 and 12 timed on an H100 at w = 13: R = 4 keeps more warps per
//     SM than R = 8 at 40 registers, R = 16 spills, and a full unroll at R = 8 outgrows the
//     code supply.
//   * One instruction per NaN-propagating max or min (PTX max.NaN / min.NaN, sm_80+):
//     any NaN in a box, and the NaN of inf - inf at an infinite centre, poisons the pixel
//     as torch.maximum and torch.clamp do.
// Other windows up to kMaxSharedWindow = 71 run the same planes with runtime scales on a
// 32 x 8 tile, one pixel per thread. Past it the planes of some window exceed the 227 KB a
// block may hold (w = 72 needs 265 KB), so larger windows read the raster directly through
// bounds-checked global loads, re-reading every box of every scale.
//
// Shared memory per block (planes + row scratch): 60 544 B at w = 13 (64 x 32 tile);
// 14 304 B at w = 13 and 127 428 B at w = 71 on the 32 x 8 tile.
#include "common.cuh"

namespace {

using namespace xdt;

// Divisors of w // 2: numbers below 10^4 have at most 64 of them (global route).
constexpr int kMaxScales = 64;
// The shared route takes w <= kMaxSharedWindow, so w // 2 <= 35: at most 8 divisors.
constexpr int kMaxPlanes = 8;
constexpr int kMaxSharedWindow = 71;

// Compile-time windows: 64 x 32 pixels, 64 x (32 / kFixR) threads, kFixR pixels down a
// column each.
constexpr int kFixTX = 64;
constexpr int kFixTY = 32;
constexpr int kFixR = 4;
// The box columns k of one plane row are read in rolled steps of at most this many.
constexpr int kMaxKChunk = 12;
// Runtime windows: 32 x 8 pixels, one per thread.
constexpr int kRunTX = 32;
constexpr int kRunTY = 8;

struct FracParams {
  int w, n_q;
  int q[kMaxScales];
  float log_q[kMaxScales];
  float mx, ss_xx;  // mean of log q and its centred sum of squares, in f32
};

// Where the planes live in a block's shared memory, in floats. Plane i holds M_q for the
// i-th divisor q of w // 2 over (ty + w - 1 - q) x (tx + w - 1 - q) positions; plane 0
// is the raw patch. The row scratch follows the planes.
struct Plan {
  int n;
  int off[kMaxPlanes];
  int tmp;
  int floats;
};

__host__ __device__ constexpr int plane_h(int w, int ty, int q) { return ty + w - 1 - q; }

__host__ __device__ constexpr int n_divisors(int n) {
  int c = 0;
  for (int d = 1; d <= n; ++d) c += (n % d == 0);
  return c;
}

__host__ __device__ constexpr int nth_divisor(int n, int i) {
  for (int d = 1; d <= n; ++d) {
    if (n % d == 0 && i-- == 0) return d;
  }
  return 0;
}

// The largest proper divisor of q: every divisor of q divides w // 2 and is built before
// q, so this is the plane M_q is built from (the plain version's choice).
__host__ __device__ constexpr int source_scale(int q) {
  for (int d = q / 2; d > 1; --d) {
    if (q % d == 0) return d;
  }
  return 1;
}

constexpr int plan_floats(int w, int ty, int tx) {
  const int hw = w / 2;
  int planes = 0, scratch = 0;
  for (int q = 1; q <= hw; ++q) {
    if (hw % q != 0) continue;
    planes += plane_h(w, ty, q) * plane_h(w, tx, q);
    if (q > 1) {
      const int s = plane_h(w, ty, q) * plane_h(w, tx, source_scale(q));
      scratch = s > scratch ? s : scratch;
    }
  }
  return planes + scratch;
}

constexpr bool planes_fit(int w, int ty, int tx) {
  return 4 * plan_floats(w, ty, tx) <= kMaxSharedBytes;
}

constexpr bool shared_route_fits() {
  for (int w = 5; w <= kMaxSharedWindow; ++w) {
    if (!planes_fit(w, kRunTY, kRunTX) || n_divisors(w / 2) > kMaxPlanes) return false;
    if (w <= 21 && w % 2 == 1 && !planes_fit(w, kFixTY, kFixTX)) return false;
  }
  return true;
}
static_assert(shared_route_fits(), "every window of the shared route must fit its planes");
static_assert(!planes_fit(kMaxSharedWindow + 1, kRunTY, kRunTX),
              "kMaxSharedWindow is the last window before the planes outgrow shared memory");

Plan make_plan(int w, int ty, int tx) {
  Plan p{};
  const int hw = w / 2;
  int at = 0;
  for (int q = 1; q <= hw; ++q) {
    if (hw % q != 0) continue;
    p.off[p.n++] = at;
    at += plane_h(w, ty, q) * plane_h(w, tx, q);
  }
  p.tmp = at;
  p.floats = plan_floats(w, ty, tx);
  return p;
}

// clip(x, 0, hi) with NaN kept: torch.clamp(x, 0.0, hi), by common.cuh's one-instruction
// NaN-propagating max and min (fmaxf and fminf return the non-NaN operand).
__device__ __forceinline__ float clamp_nan(float x, float hi) {
  return fmin_nan(fmax_nan(x, 0.f), hi);
}

// log(Ns / q) into the two regression sums, and the slope, in the plain version's order.
__device__ __forceinline__ void add_scale(float ns, int q, float log_q, float& sum_y, float& sum_xy) {
  const float y = logf(ns / (float)q);
  sum_y = sum_y + y;
  sum_xy = sum_xy + log_q * y;
}

__device__ __forceinline__ float slope(float sum_y, float sum_xy, const FracParams& p) {
  const float my = sum_y / (float)p.n_q;
  const float ss_xy = sum_xy - (float)p.n_q * my * p.mx;
  return -(ss_xy / p.ss_xx);
}

// ------------------------------------------------------------------ global route

// Windows past kMaxSharedWindow: one thread per pixel reads every box of every scale from the
// raster (bounds-checked, NaN beyond it).
__global__ void __launch_bounds__(kThreads)
    fractal_global(const float* __restrict__ dem, float* __restrict__ out, int H, int W,
                   FracParams p) {
  const int w = p.w;
  const int hw = w / 2;
  const int r = blockIdx.y * kTileY + threadIdx.y;
  const int c = blockIdx.x * kTileX + threadIdx.x;
  if (r >= H || c >= W) return;
  const GlobalView z{dem, H, W, r - hw, c - hw};
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
          for (int v = 0; v < q; ++v) m = fmax_nan(m, z(j * q + u, k * q + v));
        }
        ns = ns + clamp_nan(m - center, wf);
      }
    }
    add_scale(ns, q, p.log_q[i], sum_y, sum_xy);
  }
  out[(size_t)r * W + c] = slope(sum_y, sum_xy, p);
}

// ------------------------------------------------------------------ shared route

// Stage the raw patch (plane 0): rows r0 - hw .. r0 + ty + w - 3 - hw, NaN beyond the
// raster. One warp per patch row, lanes on neighbouring columns.
template <int kWarps>
__device__ __forceinline__ void stage_patch(float* m1, int ph, int pw, const float* __restrict__ dem,
                                            int H, int W, int r0, int c0, int warp, int lane) {
  for (int y = warp; y < ph; y += kWarps) {
    const int r = r0 + y;
    const bool row_in = r >= 0 && r < H;
    for (int x = lane; x < pw; x += 32) {
      const int c = c0 + x;
      m1[y * pw + x] = (row_in && c >= 0 && c < W) ? __ldg(dem + (size_t)r * W + c) : qnan();
    }
  }
}

// Build planes 1 .. n-1, each from the plane of its largest proper divisor: the maxima of
// f = q / s rows of M_s at stride s into the scratch, then of f scratch columns at stride s.
template <int kWarps>
__device__ __forceinline__ void build_planes(float* smem, const Plan& plan, const FracParams& p,
                                             int w, int ty, int tx, int warp, int lane) {
  float* scratch = smem + plan.tmp;
  for (int i = 1; i < plan.n; ++i) {
    const int q = p.q[i];
    int src = 0;
    for (int j = 1; j < i; ++j) src = (q % p.q[j] == 0) ? j : src;
    const int s = p.q[src];
    const int f = q / s;
    const float* ms = smem + plan.off[src];
    float* mq = smem + plan.off[i];
    const int ph = plane_h(w, ty, q), pw = plane_h(w, tx, q), spw = plane_h(w, tx, s);
    for (int y = warp; y < ph; y += kWarps) {
      for (int x = lane; x < spw; x += 32) {
        float m = ms[y * spw + x];
        for (int a = 1; a < f; ++a) m = fmax_nan(m, ms[(y + a * s) * spw + x]);
        scratch[y * spw + x] = m;
      }
    }
    __syncthreads();
    for (int y = warp; y < ph; y += kWarps) {
      for (int x = lane; x < pw; x += 32) {
        float m = scratch[y * spw + x];
        for (int b = 1; b < f; ++b) m = fmax_nan(m, scratch[y * spw + x + b * s]);
        mq[y * pw + x] = m;
      }
    }
    __syncthreads();
  }
}

__host__ __device__ constexpr int k_chunk(int nq) {
  for (int u = kMaxKChunk; u > 1; --u) {
    if (nq % u == 0) return u;
  }
  return 1;
}

// Scale kI of a compile-time window for the thread's kR pixels (rows ty0 .. ty0 + kR - 1
// of the tile, column tx). Plane row y serves pixel i as box row j = (y - i) / q.
template <int kW, int kR, int kI>
__device__ __forceinline__ void count_scales(const float* smem, const Plan& plan, const FracParams& p,
                                             int ty0, int tx, const float (&c)[kR], float (&sum_y)[kR],
                                             float (&sum_xy)[kR]) {
  if constexpr (kI < n_divisors(kW / 2)) {
    constexpr int q = nth_divisor(kW / 2, kI);
    constexpr int nq = (kW - 1) / q;
    constexpr int pw = plane_h(kW, kFixTX, q);
    constexpr int rows = kR + (nq - 1) * q;
    constexpr int kc = k_chunk(nq);
    const float wf = (float)kW;
    const float* m = smem + plan.off[kI] + ty0 * pw + tx;
    float ns[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) ns[i] = 0.f;
#pragma unroll
    for (int y = 0; y < rows; ++y) {
      bool used = false;
#pragma unroll
      for (int i = 0; i < kR; ++i) used |= (y >= i && (y - i) % q == 0 && (y - i) / q < nq);
      if (!used) continue;
      const float* row = m + y * pw;
#pragma unroll 1
      for (int k0 = 0; k0 < nq; k0 += kc) {
#pragma unroll
        for (int u = 0; u < kc; ++u) {
          const float v = row[(k0 + u) * q];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            if (y >= i && (y - i) % q == 0 && (y - i) / q < nq) ns[i] = ns[i] + clamp_nan(v - c[i], wf);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) add_scale(ns[i], q, p.log_q[kI], sum_y[i], sum_xy[i]);
    count_scales<kW, kR, kI + 1>(smem, plan, p, ty0, tx, c, sum_y, sum_xy);
  }
}

// kW > 0: a compile-time window on a kTY x kTX tile, kR pixels per thread down a column.
// kW = 0: the window of p on a kTY x kTX tile, one pixel per thread (kR = 1).
template <int kW, int kTY, int kTX, int kR>
__global__ void __launch_bounds__(kTX * kTY / kR)
    fractal_planes(const float* __restrict__ dem, float* __restrict__ out, int H, int W, Plan plan,
                   FracParams p) {
  constexpr int kWarps = kTX * kTY / kR / 32;
  extern __shared__ float smem[];
  const int w = kW > 0 ? kW : p.w;
  const int hw = w / 2;
  const int r0 = blockIdx.y * kTY;
  const int c0 = blockIdx.x * kTX;
  const int t = threadIdx.y * kTX + threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int pw1 = plane_h(w, kTX, 1);
  stage_patch<kWarps>(smem, plane_h(w, kTY, 1), pw1, dem, H, W, r0 - hw, c0 - hw, warp, lane);
  __syncthreads();
  build_planes<kWarps>(smem, plan, p, w, kTY, kTX, warp, lane);

  const int tx = threadIdx.x;
  const int c = c0 + tx;
  if constexpr (kW > 0) {
    const int ty0 = threadIdx.y * kR;
    float center[kR], sum_y[kR], sum_xy[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      center[i] = smem[(ty0 + i + hw) * pw1 + tx + hw];
      sum_y[i] = 0.f;
      sum_xy[i] = 0.f;
    }
    count_scales<kW, kR, 0>(smem, plan, p, ty0, tx, center, sum_y, sum_xy);
    if (c >= W) return;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = r0 + ty0 + i;
      if (r < H) out[(size_t)r * W + c] = slope(sum_y[i], sum_xy[i], p);
    }
  } else {
    const int ty = threadIdx.y;
    const float center = smem[(ty + hw) * pw1 + tx + hw];
    const float wf = (float)w;
    float sum_y = 0.f, sum_xy = 0.f;
    for (int i = 0; i < plan.n; ++i) {
      const int q = p.q[i];
      const int nq = (w - 1) / q;
      const int pw = plane_h(w, kTX, q);
      const float* m = smem + plan.off[i] + ty * pw + tx;
      float ns = 0.f;
      for (int j = 0; j < nq; ++j) {
        const float* row = m + j * q * pw;
        for (int k = 0; k < nq; ++k) ns = ns + clamp_nan(row[k * q] - center, wf);
      }
      add_scale(ns, q, p.log_q[i], sum_y, sum_xy);
    }
    const int r = r0 + ty;
    if (r < H && c < W) out[(size_t)r * W + c] = slope(sum_y, sum_xy, p);
  }
}

template <int kW, int kTY, int kTX, int kR>
int launch_planes(const float* dem, float* out, int H, int W, const FracParams& p, cudaStream_t s) {
  const Plan plan = make_plan(p.w, kTY, kTX);
  if (plan.n != p.n_q) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)plan.floats;
  const dim3 block(kTX, kTY / kR);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fractal_planes<kW, kTY, kTX, kR>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fractal_planes<kW, kTY, kTX, kR><<<grid, block, smem, s>>>(dem, out, H, W, plan, p);
  return (int)cudaGetLastError();
}

template <int kW>
int launch_fixed(const float* dem, float* out, int H, int W, const FracParams& p, cudaStream_t s) {
  return launch_planes<kW, kFixTY, kFixTX, kFixR>(dem, out, H, W, p, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  switch (w) {
    case 5: return launch_fixed<5>(dem, out, H, W, p, s);
    case 7: return launch_fixed<7>(dem, out, H, W, p, s);
    case 9: return launch_fixed<9>(dem, out, H, W, p, s);
    case 11: return launch_fixed<11>(dem, out, H, W, p, s);
    case 13: return launch_fixed<13>(dem, out, H, W, p, s);
    case 15: return launch_fixed<15>(dem, out, H, W, p, s);
    case 17: return launch_fixed<17>(dem, out, H, W, p, s);
    case 19: return launch_fixed<19>(dem, out, H, W, p, s);
    case 21: return launch_fixed<21>(dem, out, H, W, p, s);
    default: break;
  }
  if (w <= kMaxSharedWindow) return launch_planes<0, kRunTY, kRunTX, 1>(dem, out, H, W, p, s);

  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  fractal_global<<<grid, block, 0, s>>>(dem, out, H, W, p);
  return (int)cudaGetLastError();
}

// The last window whose box-maxima planes fit in shared memory: the one place the limit is
// kept, so the tests and chip_smoke.py read it here to hold both sides of it.
extern "C" int fractal_max_shared_window(void) { return kMaxSharedWindow; }
