// K2: windowed terrain indexes in one w x w pass: TPI, TRI (Riley or Wilson), roughness and
// Jenness rugosity (3 x 3 only).
//
// Replaces xdem_tpu/terrain/pallas_kernels.py::windowed_indexes_pallas (kernel body
// _make_windowed_kernel). Plain PyTorch twin: xdem_tpu_torch/terrain/window.py::windowed_indexes,
// which it equals to the bit (the library is built with -fmad=false, every sum starts from +0
// and adds its window in raster order, every formula keeps its operation order, and sqrtf and
// the divisions are the correctly rounded ones PyTorch's CUDA operations use).
//
// What bounds it on the H100: per pixel it reads one f32 and writes one per attribute (20
// bytes at four attributes: 2.0 GB and 0.597 ms at 10 000^2 against 3.35 TB/s), against the
// correctly rounded square roots of rugosity (16 half-lengths and 8 Heron triangles a pixel)
// and of Riley's TRI. Each such root is a basic block of its own with a branch to a slow
// path, so a thread's work does not interleave across them: the latency of those dependent
// chains bounds it, and what hides it is resident warps (registers a thread) and fewer roots.
// At larger w the w^2 shared-memory reads and adds per pixel bound it (441 at w = 21).
//
// Three routes, all bit-equal to the plain version:
// - w = 3, the default of get_terrain_attribute and the only window with rugosity
//   (windowed3_kernel). The window is nine registers read once from the shared tile and every
//   loop unrolls. TRI's method and the presence of rugosity are template flags (four
//   instances); TPI, TRI and roughness are tested once per thread through a mask that is
//   uniform over the grid. The Jenness geometry comes from windowed_tables.h, which the build
//   script (_build.py) generates from terrain/window.py. A half-length sqrt(dz^2 + l^2) / 2
//   squares dz, so the segment between two raster pixels has one value whichever end is the
//   centre, and a centre segment of length factor 1 equals the edge segment there: the raster
//   holds four distinct half-lengths a pixel (to the right neighbour, to the lower one, the
//   two diagonals). The block computes those four planes over its tile and halo once, in
//   shared memory, and after one barrier a pixel reads its 16 from them at compile-time
//   offsets and runs Heron's eight triangles: 13 roots a pixel and the halo's share, not 25.
// - any other w whose tile fits in the 227 KB of shared memory a block may use
//   (windowed_shared_kernel): a thread owns four neighbouring pixels of a row and walks each
//   window row once, left to right, as 16-byte loads, adding a value to each of its pixels whose
//   window holds that column; each pixel still sees its window in raster order.
// - larger w (windowed_global_kernel): one thread a pixel walks its window by bounds-checked
//   global reads.
//   In both the requested sums are a template parameter, so the loop tests nothing.
// NaN semantics follow the plain version: NaN beyond the raster, the NaN-propagating max and
// min make the roughness of a window NaN where it holds one, and Heron's guard keeps a NaN.
#include "common.cuh"
#include "windowed_tables.h"

namespace {

using namespace xdt;

constexpr int kAttrs = XDT_WIN_N_ATTRS;

__host__ __device__ constexpr unsigned bit(int attr) { return 1u << attr; }
constexpr unsigned kTPI = bit(XDT_WIN_TOPOGRAPHIC_POSITION_INDEX),
                   kTRI = bit(XDT_WIN_TERRAIN_RUGGEDNESS_INDEX), kRoughness = bit(XDT_WIN_ROUGHNESS),
                   kRugosity = bit(XDT_WIN_RUGOSITY);
constexpr unsigned kRiley = bit(kAttrs);  // beside the attribute bits where a template takes both

struct WinArgs {
  float* plane[kAttrs];  // output plane of each attribute code; read only where its bit is set
  unsigned mask;         // requested attributes, bit = attribute code
  int vec;               // 1 where a thread can write its pixels of a plane as one vector
  int w;                 // window size
  float ll, dd;          // squared planimetric length of a segment along the grid, and of a diagonal
};

// One pixel's running sums over its window, each from the plain version's start value, and its
// attributes from them: window.windowed_indexes operation for operation. M holds the bits of
// the sums to take (kTPI, kTRI, kRoughness) and kRiley for TRI's method.
template <unsigned M>
struct Sums {
  float sum = 0.f, tri = 0.f, hi = -INFINITY, lo = INFINITY;

  // The sums, whose bits depend on the order: the caller feeds a window in raster order.
  __device__ __forceinline__ void add(float s, float center) {
    if constexpr ((M & kTPI) != 0u) sum = sum + s;
    if constexpr ((M & kTRI) != 0u) {
      const float d = s - center;
      tri = tri + ((M & kRiley) != 0u ? d * d : fabsf(d));
    }
  }

  // The extremes, which are exact in any order and grouping (NaN poisons either way): `top` and
  // `bottom` may be the maximum and minimum of several window values.
  __device__ __forceinline__ void widen(float top, float bottom) {
    if constexpr ((M & kRoughness) != 0u) {
      hi = fmax_nan(hi, top);
      lo = fmin_nan(lo, bottom);
    }
  }

  __device__ __forceinline__ void take(float s, float center) {
    add(s, center);
    widen(s, s);
  }

  // The pixel's value of attribute code A, which M asks for.
  template <int A>
  __device__ __forceinline__ float value(float center, float n_nb) const {
    if constexpr (A == XDT_WIN_TOPOGRAPHIC_POSITION_INDEX) return center - (sum - center) / n_nb;
    if constexpr (A == XDT_WIN_TERRAIN_RUGGEDNESS_INDEX) return (M & kRiley) != 0u ? sqrtf(tri) : tri / n_nb;
    return hi - lo;  // NaN where the window holds one
  }
};

// ------------------------------------------------------------------ the 3 x 3 instance

// The block's shape, chosen by timing on the card: threads along x, rows of the tile (one thread
// row each), the pixels a thread computes along its row, and the blocks per SM that
// __launch_bounds__ asks for: 6 blocks of 256 threads cap a thread at 40 registers (the
// rugosity instances would take 54), which holds 48 warps an SM.
constexpr int kThreadsX3 = 32;
constexpr int kRows3 = 8;
constexpr int kThreads3 = kThreadsX3 * kRows3;
constexpr int kPix3 = 2;
constexpr int kMinBlocks3 = 6;
constexpr int kTileW3 = kThreadsX3 * kPix3;
constexpr int kPatchW3 = kTileW3 + 2;  // the tile and its one-pixel halo
constexpr int kPatchH3 = kRows3 + 2;
constexpr int kPatch3 = kPatchH3 * kPatchW3;
constexpr int kPatchRounds3 = (kPatch3 + kThreads3 - 1) / kThreads3;  // passes of the block over the patch
constexpr int kWin3 = kPix3 + 2;  // window columns a thread holds
static_assert(kPix3 == 2, "the window loads and the stores take two pixels a thread");

// Planes of half-lengths over the patch, in this order in shared memory. Entry (r, c) of HH
// joins patch pixel (r, c) to (r, c + 1), of HV to (r + 1, c), of D1 to (r + 1, c + 1); of D2
// it joins (r, c + 1) to (r + 1, c).
enum SegPlane : int { HH = 0, HV, D1, D2, kSegPlanes };

// Stage the patch whose top-left corner is raster pixel (r0 - 1, c0 - 1), NaN beyond the raster.
__device__ __forceinline__ void stage3(float* tile, const float* __restrict__ dem, int H, int W,
                                       int r0, int c0, int tid) {
#pragma unroll
  for (int k = 0; k < kPatchRounds3; ++k) {
    const int i = tid + k * kThreads3;
    if (i >= kPatch3) break;
    const int r = r0 - 1 + i / kPatchW3;
    const int c = c0 - 1 + i % kPatchW3;
    tile[i] = (r >= 0 && r < H && c >= 0 && c < W) ? __ldg(dem + (size_t)r * W + c) : qnan();
  }
}

// window._rugosity's half-length of a segment with height difference dz; the sign of dz is lost
// in its square, so either end may be subtracted from the other.
__device__ __forceinline__ float half_length(float dz, float len2) {
  return sqrtf(dz * dz + len2) / 2.f;
}

// The four planes over the whole patch. Entries of the last column and row that would join a
// pixel outside the patch join the pixel to itself instead and are read by no one.
__device__ __forceinline__ void half_length_planes(const float* tile, float* seg, float ll, float dd,
                                                   int tid) {
#pragma unroll
  for (int k = 0; k < kPatchRounds3; ++k) {
    const int i = tid + k * kThreads3;
    if (i >= kPatch3) break;
    const int right = (i % kPatchW3 != kPatchW3 - 1) ? 1 : 0;
    const int down = (i < kPatch3 - kPatchW3) ? kPatchW3 : 0;
    const float a = tile[i], b = tile[i + right], c = tile[i + down], d = tile[i + down + right];
    seg[HH * kPatch3 + i] = half_length(a - b, ll);
    seg[HV * kPatch3 + i] = half_length(a - c, ll);
    seg[D1 * kPatch3 + i] = half_length(a - d, dd);
    seg[D2 * kPatch3 + i] = half_length(b - c, dd);
  }
}

// The thread's ROWS x kWin3 window of a plane, from its top-left corner, as 8-byte loads (the
// patch's width and the thread's first column are even).
template <int ROWS>
__device__ __forceinline__ void load_window(const float* at, float (&z)[3][kWin3]) {
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
#pragma unroll
    for (int v = 0; v < kWin3; v += 2) {
      const float2 a = reinterpret_cast<const float2*>(at + u * kPatchW3)[v / 2];
      z[u][v] = a.x, z[u][v + 1] = a.y;
    }
  }
}

// Attribute A of pixel I of the thread from its 3 x 3 window, in raster order.
template <unsigned M, int A, int I>
__device__ __forceinline__ void index3(const float (&z)[3][kWin3], float (&o)[kAttrs]) {
  const float center = z[1][1 + I];
  Sums<M> acc;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
#pragma unroll
    for (int v = 0; v < 3; ++v) acc.take(z[u][v + I], center);
  }
  o[A] = acc.template value<A>(center, 8.f);
}

// TPI, TRI and roughness of pixel I of the thread, each where its bit of m is set.
template <bool RILEY, int I>
__device__ __forceinline__ void indexes3(unsigned m, const float (&z)[3][kWin3], float (&o)[kAttrs]) {
  if (m & kTPI) index3<kTPI, XDT_WIN_TOPOGRAPHIC_POSITION_INDEX, I>(z, o);
  if (m & kTRI) index3<(RILEY ? kTRI | kRiley : kTRI), XDT_WIN_TERRAIN_RUGGEDNESS_INDEX, I>(z, o);
  if (m & kRoughness) index3<kRoughness, XDT_WIN_ROUGHNESS, I>(z, o);
}

// Jenness rugosity of pixel I of the thread from its windows of the four planes: the 16
// half-lengths in the order of window.RUGOSITY_CENTER_SEGS then RUGOSITY_EDGE_SEGS, then
// Heron's formula over RUGOSITY_TRIS, as window._rugosity.
template <int I>
__device__ __forceinline__ float rugosity3(const float (&seg)[kSegPlanes][3][kWin3], float ll) {
  float hl[XDT_RUG_N_SEGMENTS];
#define XDT_SEG(i, plane, du, dv) hl[i] = seg[plane][du][(dv) + I];
  XDT_RUG_SEGMENTS(XDT_SEG)
#undef XDT_SEG
  float area = 0.f;
#define XDT_TRI(ia, ib, ic)                                                   \
  {                                                                           \
    const float a = hl[ia], b = hl[ib], c = hl[ic];                           \
    const float s = (a + b + c) / 2.f;                                        \
    area = area + sqrtf(fmax_nan(s * (s - a) * (s - b) * (s - c), 0.f));      \
  }
  XDT_RUG_TRIANGLES(XDT_TRI)
#undef XDT_TRI
  return area / ll;
}

template <bool RILEY, bool RUG>
__global__ void __launch_bounds__(kThreads3, kMinBlocks3)
    windowed3_kernel(const float* __restrict__ dem, int H, int W, WinArgs p) {
  __shared__ __align__(16) float tile[kPatch3];
  __shared__ __align__(16) float seg_planes[RUG ? kSegPlanes * kPatch3 : 2];

  const int c0 = blockIdx.x * kTileW3;
  const int r0 = blockIdx.y * kRows3;
  const int tid = threadIdx.y * kThreadsX3 + threadIdx.x;
  stage3(tile, dem, H, W, r0, c0, tid);
  __syncthreads();
  if constexpr (RUG) {
    half_length_planes(tile, seg_planes, p.ll, p.dd, tid);
    __syncthreads();
  }
  const int r = r0 + threadIdx.y;
  const int c = c0 + kPix3 * threadIdx.x;
  if (r >= H || c >= W) return;

  // The thread's windows start at patch pixel (threadIdx.y, kPix3 * threadIdx.x).
  const int corner = threadIdx.y * kPatchW3 + kPix3 * threadIdx.x;
  float res[kPix3][kAttrs] = {};
  float z[3][kWin3];
  load_window<3>(tile + corner, z);
  indexes3<RILEY, 0>(p.mask, z, res[0]);
  indexes3<RILEY, 1>(p.mask, z, res[1]);
  if constexpr (RUG) {
    float seg[kSegPlanes][3][kWin3];
    load_window<3>(seg_planes + HH * kPatch3 + corner, seg[HH]);
    load_window<2>(seg_planes + HV * kPatch3 + corner, seg[HV]);
    load_window<2>(seg_planes + D1 * kPatch3 + corner, seg[D1]);
    load_window<2>(seg_planes + D2 * kPatch3 + corner, seg[D2]);
    res[0][XDT_WIN_RUGOSITY] = rugosity3<0>(seg, p.ll);
    res[1][XDT_WIN_RUGOSITY] = rugosity3<1>(seg, p.ll);
  }

  const size_t at = (size_t)r * W + c;
#pragma unroll
  for (int a = 0; a < kAttrs; ++a) {
    if (!(p.mask & bit(a))) continue;
    float* o = p.plane[a] + at;
    if (p.vec) {  // W is even and so is c: both pixels lie inside the raster
      *reinterpret_cast<float2*>(o) = make_float2(res[0][a], res[1][a]);
    } else {
#pragma unroll
      for (int i = 0; i < kPix3; ++i) {
        if (c + i < W) o[i] = res[i][a];
      }
    }
  }
}

template <bool RILEY, bool RUG>
int launch3(const float* dem, int H, int W, const WinArgs& p, cudaStream_t s) {
  const dim3 block(kThreadsX3, kRows3);
  const dim3 grid((W + kTileW3 - 1) / kTileW3, (H + kRows3 - 1) / kRows3);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  windowed3_kernel<RILEY, RUG><<<grid, block, 0, s>>>(dem, H, W, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ every other window

// Register blocking over a shared tile: a thread owns kPixW neighbouring pixels of a row and
// walks each window row once, left to right, as 16-byte loads; a value goes to each of its pixels
// whose window holds that column. Every pixel still sees its window in raster order, so the sums
// keep their bits, and a pixel costs w (w + kPixW - 1) / kPixW shared reads instead of w^2. The
// maximum and minimum are exact in any grouping, so four columns that lie in all the pixels'
// windows are reduced once and folded into each pixel: 14 min/max instead of 32.
constexpr int kPixW = 4;
constexpr int kTileWW = kTileX * kPixW;

// The tile's row stride: a multiple of 4, so every thread's 16-byte loads stay aligned; its
// last chunk ends within the stride (4 * ceil((w + 3) / 4) <= 4 + the rounded halo).
__host__ __device__ constexpr int tile_stride(int w) { return (kTileWW + 2 * (w / 2) + 3) & ~3; }

// Attribute A of a thread's N neighbouring pixels into its plane, where M asks for it.
template <unsigned M, int A, int N>
__device__ __forceinline__ void store_pixels(const Sums<M> (&acc)[N], const float (&center)[N],
                                             const WinArgs& p, size_t at, int c, int W) {
  if constexpr ((M & bit(A)) != 0u) {
    const float n_nb = (float)(p.w * p.w - 1);
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = acc[k].template value<A>(center[k], n_nb);
    float* o = p.plane[A] + at;
    if constexpr (N == 4) {
      if (p.vec) {  // W is a multiple of 4 and so is c: all four pixels lie inside the raster
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (c + k < W) o[k] = v[k];
    }
  }
}

template <unsigned M, int N>
__device__ __forceinline__ void store_all(const Sums<M> (&acc)[N], const float (&center)[N],
                                          const WinArgs& p, size_t at, int c, int W) {
  store_pixels<M, XDT_WIN_TOPOGRAPHIC_POSITION_INDEX>(acc, center, p, at, c, W);
  store_pixels<M, XDT_WIN_TERRAIN_RUGGEDNESS_INDEX>(acc, center, p, at, c, W);
  store_pixels<M, XDT_WIN_ROUGHNESS>(acc, center, p, at, c, W);
}

template <unsigned M>
__global__ void __launch_bounds__(kThreads)
    windowed_shared_kernel(const float* __restrict__ dem, int H, int W, WinArgs p) {
  extern __shared__ __align__(16) float tile[];
  const int w = p.w;
  const int hw = w / 2;
  const int sw = tile_stride(w);
  const int c0 = blockIdx.x * kTileWW;
  const int r0 = blockIdx.y * kTileY;
  load_tile(tile, kTileY + 2 * hw, sw, dem, H, W, r0, c0, hw);
  __syncthreads();
  const int r = r0 + threadIdx.y;
  const int c = c0 + kPixW * threadIdx.x;
  if (r >= H || c >= W) return;

  // The window of the thread's pixel k starts at column k of `corner`.
  const float* corner = tile + threadIdx.y * sw + kPixW * threadIdx.x;
  float center[kPixW];
#pragma unroll
  for (int k = 0; k < kPixW; ++k) center[k] = corner[hw * sw + hw + k];
  Sums<M> acc[kPixW];
  for (int u = 0; u < w; ++u) {
    const float4* row = reinterpret_cast<const float4*>(corner + u * sw);
    for (int v0 = 0; v0 < w + kPixW - 1; v0 += 4) {
      const float4 q = row[v0 / 4];
      const float s[4] = {q.x, q.y, q.z, q.w};
      if (v0 >= kPixW - 1 && v0 + 3 < w) {  // these four columns lie in every pixel's window
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k < kPixW; ++k) acc[k].add(s[j], center[k]);
        }
        if constexpr ((M & kRoughness) != 0u) {  // their extremes once for all the pixels
          const float top = fmax_nan(fmax_nan(s[0], s[1]), fmax_nan(s[2], s[3]));
          const float bottom = fmin_nan(fmin_nan(s[0], s[1]), fmin_nan(s[2], s[3]));
#pragma unroll
          for (int k = 0; k < kPixW; ++k) acc[k].widen(top, bottom);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k < kPixW; ++k) {
            if (v0 + j >= k && v0 + j - k < w) acc[k].take(s[j], center[k]);
          }
        }
      }
    }
  }
  store_all(acc, center, p, (size_t)r * W + c, c, W);
}

// Windows whose tile does not fit in shared memory: one thread a pixel reads its window from
// the raster (bounds-checked, NaN beyond it).
template <unsigned M>
__global__ void __launch_bounds__(kThreads)
    windowed_global_kernel(const float* __restrict__ dem, int H, int W, WinArgs p) {
  const int r = blockIdx.y * kTileY + threadIdx.y;
  const int c = blockIdx.x * kTileX + threadIdx.x;
  if (r >= H || c >= W) return;
  const int w = p.w;
  const GlobalView z{dem, H, W, r - w / 2, c - w / 2};
  const float center[1] = {z(w / 2, w / 2)};
  Sums<M> acc[1];
  for (int u = 0; u < w; ++u) {
    for (int v = 0; v < w; ++v) acc[0].take(z(u, v), center[0]);
  }
  store_all(acc, center, p, (size_t)r * W + c, c, W);
}

size_t tile_bytes(int w) {
  return sizeof(float) * (size_t)tile_stride(w) * (size_t)(kTileY + 2 * (w / 2));
}

template <unsigned M>
int launch_any(const float* dem, int H, int W, const WinArgs& p, cudaStream_t s) {
  const dim3 block(kTileX, kTileY);
  const size_t smem = tile_bytes(p.w);
  const bool shared = smem <= (size_t)kMaxSharedBytes;
  const int tile_w = shared ? kTileWW : kTileX;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + kTileY - 1) / kTileY);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  if (shared) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          windowed_shared_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    windowed_shared_kernel<M><<<grid, block, smem, s>>>(dem, H, W, p);
  } else {
    windowed_global_kernel<M><<<grid, block, 0, s>>>(dem, H, W, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The last window whose tile fits in shared memory; larger ones read the raster directly.
extern "C" int windowed_max_shared_window() {
  int w = 1;
  while (tile_bytes(w + 1) <= (size_t)kMaxSharedBytes) ++w;
  return w;
}

// attr_mask: bit a set where attribute code a (its place in window.WINDOWED_ATTRS) is
// requested; plane_of: per attribute code the index of its (H, W) plane in `out`, read where
// its bit is set (host memory). Launches on `stream`, allocates nothing, waits for nothing.
extern "C" int launch_windowed(const float* dem, float* out, int H, int W, int w, int riley,
                               int attr_mask, const int* plane_of, float res, void* stream) {
  const unsigned mask = (unsigned)attr_mask;
  if (w < 1 || H <= 0 || W <= 0 || mask == 0u || (mask >> kAttrs) != 0u ||
      ((mask & kRugosity) != 0u && w != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  WinArgs p{};
  const size_t plane = (size_t)H * W;
  for (int a = 0; a < kAttrs; ++a) {
    if (!(mask & bit(a))) continue;
    if (plane_of[a] < 0) return (int)cudaErrorInvalidValue;
    p.plane[a] = out + plane_of[a] * plane;
  }
  p.mask = mask;
  const int per_thread = w == 3 ? kPix3 : kPixW;  // a thread's pixels of a plane, written as one vector
  p.vec = (W % per_thread == 0 && reinterpret_cast<uintptr_t>(out) % (4 * per_thread) == 0) ? 1 : 0;
  p.w = w;
  // As window._rugosity rounds them: L * L, and lf * lf with lf = f32(sqrt 2) * L.
  const float diagonal = XDT_RUG_DIAG_FACTOR * res;
  p.ll = res * res;
  p.dd = diagonal * diagonal;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 3) {
    const bool rug = (mask & kRugosity) != 0u;
    if (riley != 0) return rug ? launch3<true, true>(dem, H, W, p, s) : launch3<true, false>(dem, H, W, p, s);
    return rug ? launch3<false, true>(dem, H, W, p, s) : launch3<false, false>(dem, H, W, p, s);
  }
  // One instance per set of sums; TRI's method counts only where TRI is asked for.
  switch ((mask & (kTPI | kTRI | kRoughness)) | ((mask & kTRI) != 0u && riley != 0 ? kRiley : 0u)) {
#define XDT_CASE(m) \
  case (m): return launch_any<(m)>(dem, H, W, p, s);
    XDT_CASE(kTPI)
    XDT_CASE(kTRI)
    XDT_CASE(kTRI | kRiley)
    XDT_CASE(kRoughness)
    XDT_CASE(kTPI | kTRI)
    XDT_CASE(kTPI | kTRI | kRiley)
    XDT_CASE(kTPI | kRoughness)
    XDT_CASE(kTRI | kRoughness)
    XDT_CASE(kTRI | kRiley | kRoughness)
    XDT_CASE(kTPI | kTRI | kRoughness)
    XDT_CASE(kTPI | kTRI | kRiley | kRoughness)
#undef XDT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
