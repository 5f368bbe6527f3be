// K2: windowed terrain indexes in one w x w pass: TPI, TRI (Riley or Wilson), roughness and
// Jenness rugosity (3 x 3 only).
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::windowed_indexes_pallas (kernel body
// _make_windowed_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/window.py::windowed_indexes.
//
// What bounds it on the H100: instruction issue. At w = 3 with all four indexes a pixel reads
// one f32 and writes four (2.0 GB at 10 000^2, moved in 4.3 ms: 14 % of the HBM roofline),
// while rugosity alone takes 24 square roots; at larger w the w^2 shared-memory reads and
// adds per pixel (441 at w = 21) dominate.
//
// Design: one thread per output pixel over a shared-memory tile of (tile + 2*halo)^2, NaN
// beyond the raster; any odd or even w is taken. When that tile would not fit in the 227 KB a
// block may use (w above ~200), the same per-pixel code reads the raster directly through
// bounds-checked global loads instead. NaN semantics follow the reference explicitly: the
// roughness carries a nan_seen flag, and Heron's guard max(., 0) keeps a NaN argument.
#include "common.cuh"

namespace {

using namespace xdt;

constexpr int kMaxAttrs = 4;
constexpr int kSegs = 8;

// Attribute codes, shared with xdem_tpu_torch/terrain/cuda_kernels.py (WINDOWED_ATTRS order).
enum Attr : int { kTPI = 0, kTRI, kRoughness, kRugosity };

struct WinParams {
  int attrs[kMaxAttrs];
  int n_attrs, w, riley;
  float res;
  // Jenness (2004) geometry from window.py's RUGOSITY_* tables: centre-to-neighbour
  // segments (window row, col) with their planimetric length factor, neighbour-to-neighbour
  // segments (r0, c0, r1, c1), and triangles as three indices into the 16 half-lengths.
  int seg_c[kSegs][2];
  float seg_f[kSegs];
  int seg_e[kSegs][4];
  int tri[kSegs][3];
};

template <class View>
__device__ float rugosity(const View& z, const WinParams& p) {
  const float L = p.res;
  const float center = z(1, 1);
  float hsl[2 * kSegs];
  for (int i = 0; i < kSegs; ++i) {
    const float dz = center - z(p.seg_c[i][0], p.seg_c[i][1]);
    const float lf = p.seg_f[i] * L;
    hsl[i] = sqrtf(dz * dz + lf * lf) / 2.f;
  }
  for (int i = 0; i < kSegs; ++i) {
    const float dz = z(p.seg_e[i][0], p.seg_e[i][1]) - z(p.seg_e[i][2], p.seg_e[i][3]);
    hsl[kSegs + i] = sqrtf(dz * dz + L * L) / 2.f;
  }
  float area = 0.f;
  for (int t = 0; t < kSegs; ++t) {
    const float a = hsl[p.tri[t][0]], b = hsl[p.tri[t][1]], c = hsl[p.tri[t][2]];
    const float s = (a + b + c) / 2.f;
    area = area + sqrtf(max_nan(s * (s - a) * (s - b) * (s - c), 0.f));
  }
  return area / (L * L);
}

template <class View>
__device__ void windowed_pixel(const View& z, const WinParams& p, float* o, size_t plane) {
  const int w = p.w;
  const int hw = w / 2;
  const float center = z(hw, hw);
  bool need_sum = false, need_tri = false, need_rough = false;
  for (int i = 0; i < p.n_attrs; ++i) {
    need_sum |= p.attrs[i] == kTPI;
    need_tri |= p.attrs[i] == kTRI;
    need_rough |= p.attrs[i] == kRoughness;
  }
  float acc_sum = 0.f, acc_tri = 0.f;
  float acc_max = -INFINITY, acc_min = INFINITY;
  bool nan_seen = false;
  if (need_sum || need_tri || need_rough) {
    for (int u = 0; u < w; ++u) {
      for (int v = 0; v < w; ++v) {
        const float s = z(u, v);
        if (need_sum) acc_sum = acc_sum + s;
        if (need_tri) {
          const float d = s - center;
          acc_tri = acc_tri + (p.riley ? d * d : fabsf(d));
        }
        if (need_rough) {
          acc_max = fmaxf(acc_max, s);
          acc_min = fminf(acc_min, s);
          nan_seen = nan_seen || isnan(s);
        }
      }
    }
  }
  const float n_nb = (float)(w * w - 1);
  for (int i = 0; i < p.n_attrs; ++i) {
    float val;
    switch (p.attrs[i]) {
      case kTPI:
        val = center - (acc_sum - center) / n_nb;
        break;
      case kTRI:
        val = p.riley ? sqrtf(acc_tri) : acc_tri / n_nb;
        break;
      case kRoughness:
        val = nan_seen ? qnan() : acc_max - acc_min;
        break;
      default:
        val = rugosity(z, p);
        break;
    }
    o[i * plane] = val;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    windowed_kernel(const float* __restrict__ dem, float* __restrict__ out, int H, int W,
                    WinParams p) {
  const int hw = p.w / 2;
  const int c0 = blockIdx.x * kTileX;
  const int r0 = blockIdx.y * kTileY;
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  const size_t plane = (size_t)H * W;
  if constexpr (kShared) {
    extern __shared__ float tile[];
    const int sw = kTileX + 2 * hw;
    const int sh = kTileY + 2 * hw;
    load_tile(tile, sh, sw, dem, H, W, r0, c0, hw);
    __syncthreads();
    if (r >= H || c >= W) return;
    const SharedView z{tile, sw, (int)threadIdx.y, (int)threadIdx.x};
    windowed_pixel(z, p, out + (size_t)r * W + c, plane);
  } else {
    if (r >= H || c >= W) return;
    const GlobalView z{dem, H, W, r - hw, c - hw};
    windowed_pixel(z, p, out + (size_t)r * W + c, plane);
  }
}

}  // namespace

// attrs: n_attrs attribute codes (host). The rugosity tables (host) are the flattened
// RUGOSITY_* tables: seg_c 8 x 2, seg_f 8, seg_e 8 x 4, tri 8 x 3.
extern "C" int launch_windowed(const float* dem, float* out, int H, int W, int w, int riley,
                               int n_attrs, const int* attrs, float res, const int* seg_c,
                               const float* seg_f, const int* seg_e, const int* tri,
                               void* stream) {
  if (w < 1 || n_attrs < 1 || n_attrs > kMaxAttrs || H <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  WinParams p{};
  for (int i = 0; i < n_attrs; ++i) {
    if (attrs[i] == kRugosity && w != 3) return (int)cudaErrorInvalidValue;
    p.attrs[i] = attrs[i];
  }
  p.n_attrs = n_attrs;
  p.w = w;
  p.riley = riley;
  p.res = res;
  for (int i = 0; i < kSegs; ++i) {
    p.seg_c[i][0] = seg_c[2 * i];
    p.seg_c[i][1] = seg_c[2 * i + 1];
    p.seg_f[i] = seg_f[i];
    for (int j = 0; j < 4; ++j) p.seg_e[i][j] = seg_e[4 * i + j];
    for (int j = 0; j < 3; ++j) p.tri[i][j] = tri[3 * i + j];
  }

  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = w / 2;
  const size_t smem = sizeof(float) * (size_t)(kTileX + 2 * hw) * (size_t)(kTileY + 2 * hw);
  if (smem <= (size_t)kMaxSharedBytes) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          windowed_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    windowed_kernel<true><<<grid, block, smem, s>>>(dem, out, H, W, p);
  } else {
    windowed_kernel<false><<<grid, block, 0, s>>>(dem, out, H, W, p);
  }
  return (int)cudaGetLastError();
}
