// K1: fused surface-fit terrain attributes (slope, aspect, hillshade and seven curvatures).
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::surface_attributes_pallas (kernel body
// _make_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/surfit.py::surface_attributes,
// which it equals to the bit (the library is built with -fmad=false, every sum starts from
// +0 and adds its taps in the plain version's order, every formula keeps its operation order,
// and the library functions are the ones PyTorch's CUDA operations call).
//
// What bounds it on the H100: per pixel it reads one f32 and writes one f32 per attribute (40
// bytes at nine attributes: 4.0 GB and 1.194 ms at 10 000^2 against 3.35 TB/s), against 106
// multiplies and 106 adds that must not fuse (the five Florinsky stencils), five IEEE
// divisions by the divisors, and the attribute algebra with its correctly rounded divisions
// and square roots, atanf, atan2f, sinf and cosf. Not bytes but instruction latency bounds
// it: every correctly rounded division and root is a basic block of its own with a branch
// to a slow path, so a thread's pixels do not interleave across them, and only more warps on
// an SM hide the dependent chains. Timed on an NVIDIA H100 80GB HBM3 (700 W limit), nine
// attributes at 10 000^2, the time fell with every step up in resident warps: four pixels a
// thread at 104 registers (16 warps an SM) was slowest, 80 registers (24 warps) faster, and
// two pixels a thread at 64 registers (32 warps, this file's shape) fastest, 2.9-3.0 ms.
// Fetching the next tile into registers ahead of the compute was slower (more registers,
// fewer warps), and taking ~60 instructions a pixel out of the staging changed nothing.
// PERF.md has the record.
//
// Design:
// - The fit, whether the second derivatives are needed and the curvature method are template
//   parameters (seven instances). The stencils come from surface_fit_tables.h, which the
//   build script (_build.py) generates from terrain/surfit.py: each derivative sum is a
//   straight line of `acc = acc + w * z` over its non-zero taps, with the weight a literal
//   and the window value a register; there is no loop, no test and no load of a weight.
// - A thread computes kPix = 2 neighbouring pixels of a row. It loads its K x (kPix + 4)
//   window values from shared memory once, as 8-byte loads, and every plane is written as one
//   float2 a thread where the width is even (scalar stores otherwise). __launch_bounds__ asks
//   for 4 blocks of 256 threads an SM, which caps a thread at 64 registers (12 bytes of spills).
// - The block stages `x - center` once (a non-finite x stays non-finite, the raster's edge
//   is NaN), so no tap centres or selects: where a window holds a non-finite value the output
//   is NaN whatever the sums hold. Validity is an AND down each of the thread's window
//   columns, then an AND across the K columns of each pixel.
// - The attributes arrive as a bit mask and one output plane per attribute. Each bit is
//   tested once, by a branch that is uniform over the grid, and every intermediate that two
//   attributes share (grad2, slope, aspect, 2 z_xy z_x z_y, the roots, the tangential and
//   planform numerator, the mean curvature and unsphericity) is computed once per pixel under
//   the union of the bits that need it.
// - The centre is read from device memory, so the wrapper never waits for the host.
#include "common.cuh"
#include "surface_fit_tables.h"

namespace {

using namespace xdt;

// The block's shape, chosen by timing on the card: threads along x, rows of the tile (one thread
// row each), the pixels a thread computes, and the blocks per SM that __launch_bounds__ asks for
// (it caps a thread's registers).
constexpr int kThreadsX = 16;
constexpr int kRows = 16;
constexpr int kThreads = kThreadsX * kRows;
constexpr int kPix = 2;
constexpr int kMinBlocks = 4;
constexpr int kTileW = kThreadsX * kPix;
constexpr int kWin = kPix + 4;      // window columns a thread holds: enough for K = 5
constexpr int kStageW = kTileW + 4;  // staged columns; a multiple of kPix, so a thread's window stays aligned
constexpr int kAttrs = XDT_N_ATTRS;
constexpr int kMaxRoles = 5;  // z_x, z_y, z_xx, z_yy, z_xy, in this order
static_assert(kPix == 2, "the sums, the window loads and the stores take two pixels a thread");

template <int FIT> struct FitInfo;
#define XDT_FIT_INFO(id, k, n)                \
  template <> struct FitInfo<id> {            \
    static constexpr int K = k, kRoles = n;   \
  };
XDT_SURFIT_FITS(XDT_FIT_INFO)
#undef XDT_FIT_INFO

__host__ __device__ constexpr unsigned bit(int attr) { return 1u << attr; }
constexpr unsigned kSlope = bit(XDT_ATTR_SLOPE), kAspect = bit(XDT_ATTR_ASPECT),
                   kHillshade = bit(XDT_ATTR_HILLSHADE), kCurvature = bit(XDT_ATTR_CURVATURE),
                   kProfile = bit(XDT_ATTR_PROFILE_CURVATURE),
                   kTangential = bit(XDT_ATTR_TANGENTIAL_CURVATURE),
                   kPlanform = bit(XDT_ATTR_PLANFORM_CURVATURE),
                   kFlowline = bit(XDT_ATTR_FLOWLINE_CURVATURE),
                   kMaxCurv = bit(XDT_ATTR_MAX_CURVATURE), kMinCurv = bit(XDT_ATTR_MIN_CURVATURE);
constexpr unsigned kSecondOrder =
    kCurvature | kProfile | kTangential | kPlanform | kFlowline | kMaxCurv | kMinCurv;

struct FitArgs {
  float* plane[kAttrs];      // output plane of each attribute code; read only where its bit is set
  float divisor[kMaxRoles];  // DIV_CONST * res ** DIV_POW, rounded as the plain version does
  const float* center;       // device pointer to the constant removed before the stencils
  unsigned mask;             // requested attributes, bit = attribute code
  int vec;                   // 1 where a thread can write its pixels of a plane as one vector
  float sin_alt, cos_alt, azimuth, z_factor;  // hillshade constants (radians, f32)
};

// One derivative sum of pixel I of the thread: +0, then each non-zero tap in row-major order.
template <int FIT, int ROLE, int I>
__device__ __forceinline__ float stencil_sum(const float (&z)[FitInfo<FIT>::K][kWin]) {
  float acc = 0.f;
#define XDT_TAP(u, v, w) acc = acc + (w) * z[u][(v) + I];
#define XDT_STENCIL_CASE(fit, role, TAPS) \
  if constexpr (FIT == fit && ROLE == role) { TAPS(XDT_TAP) }
  XDT_SURFIT_STENCILS(XDT_STENCIL_CASE)
#undef XDT_STENCIL_CASE
#undef XDT_TAP
  return acc;
}

// The derivative of role ROLE at the thread's pixels.
template <int FIT, int ROLE>
__device__ __forceinline__ void derivative(const float (&z)[FitInfo<FIT>::K][kWin], float divisor,
                                           float (&d)[kPix]) {
  d[0] = stencil_sum<FIT, ROLE, 0>(z) / divisor;
  d[1] = stencil_sum<FIT, ROLE, 1>(z) / divisor;
}

// (-atan2(-z_x, z_y)) mod 2*pi as a floor-modulo, as torch.remainder computes it: fmodf, then
// 2*pi added where the result is negative. |atan2f| <= pi < 2*pi, and fmodf(x, y) returns x
// itself wherever |x| < y (NaN and -0 included), so the fmodf is the identity and is left out.
__device__ __forceinline__ float aspect_of(float zx, float zy) {
  const float two_pi = 6.283185307179586f;
  float r = -atan2f(-zx, zy);
  if (r < 0.f) r += two_pi;
  return r;
}

// Closed-form attribute algebra of one pixel; mirrors surfit._attrs_from_derivs operation for
// operation. o[a] is written where bit a of m is set and nowhere else. Every `if (m & ...)` is
// uniform over the grid.
template <bool CURV, bool GEO>
__device__ __forceinline__ void attributes(unsigned m, float zx, float zy, float zxx, float zyy,
                                           float zxy, const FitArgs& p, float (&o)[kAttrs]) {
  const float zx2 = zx * zx, zy2 = zy * zy;
  const float grad2 = zx2 + zy2;
  const bool flat = grad2 == 0.f;

  float slope = 0.f, aspect = 0.f;
  if (m & (kSlope | kHillshade)) slope = atanf(sqrtf(grad2));
  if (m & (kAspect | kHillshade)) aspect = aspect_of(zx, zy);
  if (m & kSlope) o[XDT_ATTR_SLOPE] = slope;
  if (m & kAspect) o[XDT_ATTR_ASPECT] = aspect;
  if (m & kHillshade) {
    const float slopemap = p.z_factor != 1.f ? atanf(tanf(slope) * p.z_factor) : slope;
    o[XDT_ATTR_HILLSHADE] = 1.5f + 254.f * (p.sin_alt * cosf(slopemap) +
                                            p.cos_alt * sinf(slopemap) * sinf(p.azimuth - aspect));
  }
  if constexpr (CURV) {
    if (m & kCurvature) o[XDT_ATTR_CURVATURE] = -2.f * (zxx + zyy) * 100.f;

    constexpr unsigned kGeoExtremes = GEO ? (kMaxCurv | kMinCurv) : 0u;
    const float g1 = 1.f + grad2;
    float cross = 0.f, g1_32 = 0.f, sqrt_g1 = 0.f, g3 = 0.f, num_t = 0.f;
    if (m & (kProfile | kTangential | kPlanform | kGeoExtremes)) cross = 2.f * zxy * zx * zy;
    if (GEO && (m & (kProfile | kGeoExtremes))) g1_32 = sqrtf(g1 * g1 * g1);
    if (GEO && (m & (kTangential | kFlowline))) sqrt_g1 = sqrtf(g1);
    if (m & (kPlanform | kFlowline)) g3 = sqrtf(grad2 * grad2 * grad2);
    if (m & (kTangential | kPlanform)) num_t = -(zxx * zy2 - cross + zyy * zx2);

    if (m & kProfile) {
      const float num = -(zxx * zx2 + cross + zyy * zy2);
      const float den = GEO ? grad2 * g1_32 : grad2;
      o[XDT_ATTR_PROFILE_CURVATURE] = (flat ? 0.f : num / den) * 100.f;
    }
    if (m & kTangential) {
      const float den = GEO ? grad2 * sqrt_g1 : grad2;
      o[XDT_ATTR_TANGENTIAL_CURVATURE] = (flat ? 0.f : num_t / den) * 100.f;
    }
    if (m & kPlanform) {
      o[XDT_ATTR_PLANFORM_CURVATURE] = (grad2 < 1e-14f ? 0.f : num_t / g3) * 100.f;
    }
    if (m & kFlowline) {
      const float num = zx * zy * (zxx - zyy) - zxy * (zx2 - zy2);
      const float den = GEO ? g3 * sqrt_g1 : g3;
      const bool guard = GEO ? grad2 < 1e-14f : flat;
      o[XDT_ATTR_FLOWLINE_CURVATURE] = (guard ? 0.f : num / den) * 100.f;
    }
    if (m & (kMaxCurv | kMinCurv)) {
      if constexpr (GEO) {
        // Mean curvature (Gauss) and unsphericity (Shary). The plain version writes the cross
        // term of t in another order than that of the mean curvature, so t keeps its own.
        const float denom_m = 2.f * g1_32;
        const float mean_c = -((1.f + zy2) * zxx - cross + (1.f + zx2) * zyy) / denom_m;
        const float t = ((1.f + zy2) * zxx - 2.f * zy * zx * zxy + (1.f + zx2) * zyy) / denom_m;
        const float d = t * t - (zxx * zyy - zxy * zxy) / (g1 * g1);
        const float unsph = sqrtf(max_nan(d, 0.f));
        if (m & kMaxCurv) o[XDT_ATTR_MAX_CURVATURE] = flat ? 0.f : (mean_c + unsph) * 100.f;
        if (m & kMinCurv) o[XDT_ATTR_MIN_CURVATURE] = flat ? 0.f : (mean_c - unsph) * 100.f;
      } else {
        const float half = (zxx - zyy) / 2.f;
        const float root = sqrtf(half * half + zxy * zxy);
        const float mid = (zxx + zyy) / 2.f;
        if (m & kMaxCurv) o[XDT_ATTR_MAX_CURVATURE] = flat ? 0.f : -(mid - root) * 100.f;
        if (m & kMinCurv) o[XDT_ATTR_MIN_CURVATURE] = flat ? 0.f : -(mid + root) * 100.f;
      }
    }
  }
}

// Stage the centred patch whose top-left corner is raster pixel (r0 - R, c0 - R): NaN beyond the
// raster edge, and inf - center or NaN - center stays non-finite. A warp takes whole rows of
// the patch, so its loads are contiguous and a row's bounds and address are worked out once.
template <int R>
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ dem, int H, int W,
                                      int r0, int c0, float center) {
#pragma unroll
  for (int rr = threadIdx.y; rr < kRows + 2 * R; rr += kRows) {
    const int r = r0 - R + rr;
    const bool row_inside = r >= 0 && r < H;
    const float* row = dem + (size_t)(row_inside ? r : 0) * W;
#pragma unroll
    for (int cc = threadIdx.x; cc < kStageW; cc += kThreadsX) {
      const int c = c0 - R + cc;
      const float x = (row_inside && c >= 0 && c < W) ? __ldg(row + c) : qnan();
      tile[rr * kStageW + cc] = x - center;
    }
  }
}

// The thread's pixels (r, c .. c + kPix - 1) from the staged patch.
template <int FIT, bool CURV, bool GEO>
__device__ __forceinline__ void thread_pixels(const float* tile, int r, int c, int W, const FitArgs& p) {
  constexpr int K = FitInfo<FIT>::K;
  // The thread's window: rows r - R .. r + R, columns c - R .. c - R + kWin - 1.
  float z[K][kWin];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const float* at = &tile[(threadIdx.y + u) * kStageW + kPix * threadIdx.x];
#pragma unroll
    for (int v = 0; v < kWin; v += 2) {
      const float2 a = reinterpret_cast<const float2*>(at)[v / 2];
      z[u][v] = a.x, z[u][v + 1] = a.y;
    }
  }
  // All K x K neighbours finite (the reference's NaN dilation): down the columns, then across.
  bool column[K + kPix - 1];
#pragma unroll
  for (int v = 0; v < K + kPix - 1; ++v) {
    column[v] = true;
#pragma unroll
    for (int u = 0; u < K; ++u) column[v] = column[v] && isfinite(z[u][v]);
  }
  bool valid[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    valid[i] = true;
#pragma unroll
    for (int v = 0; v < K; ++v) valid[i] = valid[i] && column[i + v];
  }

  float zx[kPix], zy[kPix], zxx[kPix] = {}, zyy[kPix] = {}, zxy[kPix] = {};
  derivative<FIT, 0>(z, p.divisor[0], zx);
  derivative<FIT, 1>(z, p.divisor[1], zy);
  if constexpr (CURV) {
    derivative<FIT, 2>(z, p.divisor[2], zxx);
    derivative<FIT, 3>(z, p.divisor[3], zyy);
    derivative<FIT, 4>(z, p.divisor[4], zxy);
  }

  float res[kPix][kAttrs];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    attributes<CURV, GEO>(p.mask, zx[i], zy[i], zxx[i], zyy[i], zxy[i], p, res[i]);
  }

  const size_t at = (size_t)r * W + c;
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) {
    if (!(p.mask & bit(a))) continue;
    float* o = p.plane[a] + at;
    float v[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) v[i] = valid[i] ? res[i][a] : qnan();
    if (p.vec) {  // W is a multiple of kPix and so is c: all the pixels lie inside the raster
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (c + i < W) o[i] = v[i];
      }
    }
  }
}

template <int FIT, bool CURV, bool GEO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    surface_fit_kernel(const float* __restrict__ dem, int H, int W, FitArgs p) {
  constexpr int K = FitInfo<FIT>::K;
  constexpr int R = K / 2;
  static_assert(K + kPix - 1 <= kWin, "a thread's window columns do not hold this stencil");
  static_assert(CURV ? FitInfo<FIT>::kRoles == kMaxRoles : true, "this fit has no second derivatives");
  __shared__ __align__(16) float tile[(kRows + 2 * R) * kStageW];

  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kRows;
  stage<R>(tile, dem, H, W, r0, c0, __ldg(p.center));
  __syncthreads();
  const int r = r0 + threadIdx.y;
  const int c = c0 + kPix * threadIdx.x;
  if (r < H && c < W) thread_pixels<FIT, CURV, GEO>(tile, r, c, W, p);
}

template <int FIT, bool CURV, bool GEO>
int launch(const float* dem, int H, int W, const FitArgs& p, cudaStream_t s) {
  const dim3 block(kThreadsX, kRows);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kRows - 1) / kRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  surface_fit_kernel<FIT, CURV, GEO><<<grid, block, 0, s>>>(dem, H, W, p);
  return (int)cudaGetLastError();
}

template <int FIT>
int launch_fit(bool curv, bool geo, const float* dem, int H, int W, const FitArgs& p, cudaStream_t s) {
  if constexpr (FitInfo<FIT>::kRoles == kMaxRoles) {
    if (curv) {
      return geo ? launch<FIT, true, true>(dem, H, W, p, s) : launch<FIT, true, false>(dem, H, W, p, s);
    }
  } else {
    if (curv) return (int)cudaErrorInvalidValue;
  }
  return launch<FIT, false, false>(dem, H, W, p, s);
}

}  // namespace

// fit: XDT_FIT_* id; divisors: n_roles values (host memory), n_roles 2 (z_x, z_y) or 5;
// attr_mask: bit a set where attribute code a is requested; plane_of: per attribute code the
// index of its (H, W) plane in `out`, read where its bit is set (host memory); center: device
// pointer to one f32. Launches on `stream`, allocates nothing, waits for nothing.
extern "C" int launch_surface_fit(const float* dem, float* out, int H, int W, int fit,
                                  int geometric, int n_roles, const float* divisors,
                                  int attr_mask, const int* plane_of, const float* center,
                                  float sin_alt, float cos_alt, float azimuth, float z_factor,
                                  void* stream) {
  const unsigned mask = (unsigned)attr_mask;
  const bool curv = (mask & kSecondOrder) != 0u;
  if (H <= 0 || W <= 0 || mask == 0u || (mask >> kAttrs) != 0u || center == nullptr ||
      n_roles != (curv ? kMaxRoles : 2)) {
    return (int)cudaErrorInvalidValue;
  }
  FitArgs p{};
  const size_t plane = (size_t)H * W;
  for (int a = 0; a < kAttrs; ++a) {
    if (!(mask & bit(a))) continue;
    if (plane_of[a] < 0) return (int)cudaErrorInvalidValue;
    p.plane[a] = out + plane_of[a] * plane;
  }
  for (int k = 0; k < n_roles; ++k) p.divisor[k] = divisors[k];
  p.center = center;
  p.mask = mask;
  p.vec = (W % kPix == 0 && reinterpret_cast<uintptr_t>(out) % (4 * kPix) == 0) ? 1 : 0;
  p.sin_alt = sin_alt;
  p.cos_alt = cos_alt;
  p.azimuth = azimuth;
  p.z_factor = z_factor;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool geo = geometric != 0;
  switch (fit) {
    case XDT_FIT_HORN: return launch_fit<XDT_FIT_HORN>(curv, geo, dem, H, W, p, s);
    case XDT_FIT_ZEVENBERGTHORNE: return launch_fit<XDT_FIT_ZEVENBERGTHORNE>(curv, geo, dem, H, W, p, s);
    case XDT_FIT_FLORINSKY: return launch_fit<XDT_FIT_FLORINSKY>(curv, geo, dem, H, W, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
