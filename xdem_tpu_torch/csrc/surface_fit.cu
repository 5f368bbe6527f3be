// K1: fused surface-fit terrain attributes (slope, aspect, hillshade and seven curvatures).
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::surface_attributes_pallas (kernel body
// _make_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/surfit.py::surface_attributes.
//
// What bounds it on the H100: per pixel it reads one f32 and writes n_attrs f32 (40 bytes at
// nine attributes), against up to 5 x 25 multiplies and adds, IEEE divisions and atan, sin,
// cos per attribute. Measured at 10 000^2 with nine attributes it moves 4.0 GB in 7.5 ms, 16 %
// of the HBM roofline: instruction issue (the runtime attribute switch, the unfused
// multiply-adds, the divisions) bounds it, not bytes.
//
// Design: one thread per output pixel; each block stages its (tile + 2*halo)^2 patch of the
// raster once in shared memory (NaN beyond the edge), so every input byte leaves HBM about
// once; outputs are written row-contiguous per attribute plane. Stencil weights arrive as a
// kernel argument generated from the Python tables (never typed here), already flipped so
// that tap (u, v) uses weights[role][u * K + v]. The library is built with -fmad=false so
// that each stencil sum rounds exactly as the unfused `acc + w * z` of the plain version.
#include "common.cuh"

namespace {

using namespace xdt;

constexpr int kMaxRoles = 5;  // z_x, z_y, z_xx, z_yy, z_xy, in this order
constexpr int kMaxAttrs = 10;
constexpr int kMaxTaps = 25;

// Attribute codes, shared with xdem_tpu_torch/terrain/cuda_kernels.py (SURFACE_FIT_ATTRS order).
enum Attr : int {
  kSlope = 0,
  kAspect,
  kHillshade,
  kCurvature,
  kProfile,
  kTangential,
  kPlanform,
  kFlowline,
  kMaxCurv,
  kMinCurv,
};

struct FitParams {
  float weights[kMaxRoles][kMaxTaps];
  float divisor[kMaxRoles];  // DIV_CONST * res ** DIV_POW, rounded as the plain version does
  int attrs[kMaxAttrs];
  int n_roles, n_attrs, geometric;
  float center;  // mean of the finite pixels, removed before the stencils
  float sin_alt, cos_alt, azimuth, z_factor;  // hillshade constants (radians, f32)
};

// (-atan2(-z_x, z_y)) mod 2*pi as a floor-modulo: fmodf truncates and may return a negative.
__device__ __forceinline__ float aspect_of(float zx, float zy) {
  const float two_pi = 6.283185307179586f;
  float r = fmodf(-atan2f(-zx, zy), two_pi);
  if (r < 0.f) r += two_pi;
  return r;
}

// Closed-form attribute algebra; mirrors surfit._attrs_from_derivs operation for operation.
__device__ float attr_value(int a, float zx, float zy, float zxx, float zyy, float zxy,
                            const FitParams& p) {
  const bool geo = p.geometric != 0;
  const float grad2 = zx * zx + zy * zy;
  const bool flat = grad2 == 0.f;
  switch (a) {
    case kSlope:
      return atanf(sqrtf(grad2));
    case kAspect:
      return aspect_of(zx, zy);
    case kHillshade: {
      const float slope = atanf(sqrtf(grad2));
      const float slopemap = p.z_factor != 1.f ? atanf(tanf(slope) * p.z_factor) : slope;
      const float asp = aspect_of(zx, zy);
      return 1.5f + 254.f * (p.sin_alt * cosf(slopemap) +
                             p.cos_alt * sinf(slopemap) * sinf(p.azimuth - asp));
    }
    case kCurvature:
      return -2.f * (zxx + zyy) * 100.f;
    case kProfile: {
      const float num = -(zxx * (zx * zx) + 2.f * zxy * zx * zy + zyy * (zy * zy));
      const float g1 = 1.f + grad2;
      const float den = geo ? grad2 * sqrtf(g1 * g1 * g1) : grad2;
      return (flat ? 0.f : num / den) * 100.f;
    }
    case kTangential: {
      const float num = -(zxx * (zy * zy) - 2.f * zxy * zx * zy + zyy * (zx * zx));
      const float den = geo ? grad2 * sqrtf(1.f + grad2) : grad2;
      return (flat ? 0.f : num / den) * 100.f;
    }
    case kPlanform: {
      const float num = -(zxx * (zy * zy) - 2.f * zxy * zx * zy + zyy * (zx * zx));
      return (grad2 < 1e-14f ? 0.f : num / sqrtf(grad2 * grad2 * grad2)) * 100.f;
    }
    case kFlowline: {
      const float num = zx * zy * (zxx - zyy) - zxy * (zx * zx - zy * zy);
      const float g3 = sqrtf(grad2 * grad2 * grad2);
      const float den = geo ? g3 * sqrtf(1.f + grad2) : g3;
      const bool guard = geo ? grad2 < 1e-14f : flat;
      return (guard ? 0.f : num / den) * 100.f;
    }
    case kMaxCurv:
    case kMinCurv: {
      const float sign = a == kMaxCurv ? 1.f : -1.f;
      if (flat) return 0.f;
      if (geo) {
        // Mean curvature (Gauss) and unsphericity (Shary).
        const float g1 = 1.f + grad2;
        const float denom_m = 2.f * sqrtf(g1 * g1 * g1);
        const float mean_c =
            -((1.f + zy * zy) * zxx - 2.f * zxy * zx * zy + (1.f + zx * zx) * zyy) / denom_m;
        const float t = ((1.f + zy * zy) * zxx - 2.f * zy * zx * zxy + (1.f + zx * zx) * zyy) / denom_m;
        const float d = t * t - (zxx * zyy - zxy * zxy) / (g1 * g1);
        const float unsph = sqrtf(max_nan(d, 0.f));
        return (a == kMaxCurv ? mean_c + unsph : mean_c - unsph) * 100.f;
      }
      const float half = (zxx - zyy) / 2.f;
      const float root = sqrtf(half * half + zxy * zxy);
      return -((zxx + zyy) / 2.f - sign * root) * 100.f;
    }
    default:
      return qnan();
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    surface_fit_kernel(const float* __restrict__ dem, float* __restrict__ out, int H, int W,
                       FitParams p) {
  constexpr int R = K / 2;
  constexpr int SW = kTileX + 2 * R;
  constexpr int SH = kTileY + 2 * R;
  __shared__ float tile[SH * SW];
  const int c0 = blockIdx.x * kTileX;
  const int r0 = blockIdx.y * kTileY;
  load_tile(tile, SH, SW, dem, H, W, r0, c0, R);
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r >= H || c >= W) return;

  float acc[kMaxRoles];
#pragma unroll
  for (int k = 0; k < kMaxRoles; ++k) acc[k] = 0.f;
  bool valid = true;  // all K x K neighbours finite (the reference's NaN dilation)
#pragma unroll
  for (int u = 0; u < K; ++u) {
#pragma unroll
    for (int v = 0; v < K; ++v) {
      const float x = tile[(threadIdx.y + u) * SW + threadIdx.x + v];
      const bool fin = isfinite(x);
      valid = valid && fin;
      const float z = fin ? x - p.center : 0.f;
#pragma unroll
      for (int k = 0; k < kMaxRoles; ++k) {
        const float wgt = p.weights[k][u * K + v];
        if (k < p.n_roles && wgt != 0.f) acc[k] = acc[k] + wgt * z;
      }
    }
  }

  const size_t plane = (size_t)H * W;
  float* o = out + (size_t)r * W + c;
  if (!valid) {
    for (int i = 0; i < p.n_attrs; ++i) o[i * plane] = qnan();
    return;
  }
  float d[kMaxRoles];
#pragma unroll
  for (int k = 0; k < kMaxRoles; ++k) d[k] = k < p.n_roles ? acc[k] / p.divisor[k] : 0.f;
  for (int i = 0; i < p.n_attrs; ++i) {
    o[i * plane] = attr_value(p.attrs[i], d[0], d[1], d[2], d[3], d[4], p);
  }
}

}  // namespace

// weights: n_roles * ksize * ksize flipped taps (host memory); divisors: n_roles (host);
// attrs: n_attrs attribute codes (host). Launches on `stream`, allocates nothing.
extern "C" int launch_surface_fit(const float* dem, float* out, int H, int W, int ksize,
                                  int n_roles, const float* weights, const float* divisors,
                                  int n_attrs, const int* attrs, int geometric, float center,
                                  float sin_alt, float cos_alt, float azimuth, float z_factor,
                                  void* stream) {
  if ((ksize != 3 && ksize != 5) || n_roles < 1 || n_roles > kMaxRoles || n_attrs < 1 ||
      n_attrs > kMaxAttrs || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  FitParams p{};
  const int taps = ksize * ksize;
  for (int k = 0; k < n_roles; ++k) {
    for (int t = 0; t < taps; ++t) p.weights[k][t] = weights[k * taps + t];
    p.divisor[k] = divisors[k];
  }
  for (int i = 0; i < n_attrs; ++i) p.attrs[i] = attrs[i];
  p.n_roles = n_roles;
  p.n_attrs = n_attrs;
  p.geometric = geometric;
  p.center = center;
  p.sin_alt = sin_alt;
  p.cos_alt = cos_alt;
  p.azimuth = azimuth;
  p.z_factor = z_factor;

  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksize == 3) {
    surface_fit_kernel<3><<<grid, block, 0, s>>>(dem, out, H, W, p);
  } else {
    surface_fit_kernel<5><<<grid, block, 0, s>>>(dem, out, H, W, p);
  }
  return (int)cudaGetLastError();
}
