// ICP's brute nearest-neighbour scan: for each query point, the index and squared distance of
// its nearest reference point.
//
// Replaces no TPU kernel: the JAX package leaves this scan to XLA, which fuses it
// (xdem_tpu/coreg/affine.py::_nn_planes_scan). Caller: xdem_tpu_torch/coreg/affine.py::
// _nn_planes_scan, whose nn(q) launches it once a scan (through _nn_scan_on_card) on a CUDA
// float32 reference cloud; ICP's loop (_icp_while_loop) scans once a step, and the sharded ICP
// (parallel/coreg.py::icp_solve_sharded) once a step on each shard's card. Plain PyTorch twin:
// _nn_scan_aten in the same module, which a CPU cloud takes: blocks of 2 048 reference points,
// each about nine ATen passes over a (queries x 2 048) float32 plane of distances, so a
// 5e4 x 5e4 scan moves ~100 GB through device memory to produce 5e4 indices.
//
// Here no distance reaches device memory. A thread holds kScanQueries queries in registers,
// with each one's running minimum and its index. A block stages the reference cloud tile by
// tile in shared memory as x, y and z planes, which every thread reads as broadcasts, four
// points to a 16-byte load. 5e4 queries make only ~50 blocks of 1 024, so the reference cloud
// is also split over gridDim.y, into chunks of whole tiles, until the launch has ~kScanBlocks
// blocks. Each split ends with one 64-bit atomicMin a query on (bits of d2) << 32 | index: a
// non-negative float's bits order as its value, so the smallest key is the least d2 and,
// among equal d2, the lowest index, whatever order the blocks run in (deterministic, as
// regrid.cu's atomicMax). A second, small launch unpacks the keys into int64 indices and
// float32 distances; the caller allocates both and the keys.
//
// Bit-equal to the ATen scan on the card: d2 = ((qx - rx)^2 + (qy - ry)^2) + (qz - rz)^2 in
// float32, in that order, each product and sum rounded on its own (-fmad=false, as separate
// ATen passes round; ATen's square_ is x * x). Within a split a thread walks the reference
// points in ascending order and takes a point only when strictly closer, so it keeps the
// first minimum, as torch.min keeps the first within a block and a later block takes over
// only when strictly closer: the winner is the least d2, ties to the lowest index, whatever
// the block size or the split. The tail of the last tile is padded with +inf coordinates,
// whose d2 (+inf) is never strictly less; a split starts from (+inf, its first index), so a
// query whose every d2 is +inf gets index 0, as torch.min gives it.
//
// Contract: finite coordinates (the draw keeps finite pixels and standardisation keeps them
// finite; the padded shards' 1e15 coordinates are finite and scanned like any point), fewer
// than 2^32 reference points (the indices are 32-bit inside the key; ICP's "auto" rule caps
// the pairs at 1e10).
//
// What bounds it on the H100: operations. 9 float32 operations a pair (three differences,
// three products, two sums and the compare), 2.5e9 pairs a 5e4 x 5e4 scan: 0.34 ms at
// 67 TFLOP/s, which counts a fused multiply-add as two. Bit equality forbids the fusion, so
// the card issues one operation a lane a cycle, and with the argmin's compare and two selects
// ~11 instructions a pair: ~0.8 ms a scan. The staging (the 0.6 MB cloud read once for each
// 1 024 queries, mostly from L2) and the atomics (one a query a split) are small beside that.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 128;
constexpr int kScanQueries = 8;  // queries a thread, each with its running minimum and index
constexpr int kBlockQueries = kScanThreads * kScanQueries;
constexpr int kScanTile = 256;  // reference points a block stages at a time (3 KB)
// Blocks a launch aims for: 132 SMs x 32, so the last blocks to finish are a small share of
// the scan.
constexpr long long kScanBlocks = 4224;
constexpr int kUnpackThreads = 256;

__device__ __forceinline__ void take_nearer(float qx, float qy, float qz, float rx, float ry, float rz,
                                            unsigned j, float& best, unsigned& best_j) {
  const float dx = qx - rx;
  const float dy = qy - ry;
  const float dz = qz - rz;
  const float d2 = (dx * dx + dy * dy) + dz * dz;
  if (d2 < best) {
    best = d2;
    best_j = j;
  }
}

// Block (x, y) takes queries [x * kBlockQueries, (x + 1) * kBlockQueries) against reference
// points [y * chunk, min((y + 1) * chunk, n)); thread t holds queries x * kBlockQueries + t +
// k * kScanThreads. `ref` is the reference cloud as three planes of n floats (x, y, z).
__global__ void __launch_bounds__(kScanThreads)
nn_scan_kernel(const float* __restrict__ ref, long long n, long long chunk, const float* __restrict__ q,
               long long m, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float sx[kScanTile];
  __shared__ __align__(16) float sy[kScanTile];
  __shared__ __align__(16) float sz[kScanTile];
  const long long first_query = (long long)blockIdx.x * kBlockQueries + threadIdx.x;
  const long long begin = (long long)blockIdx.y * chunk;
  const long long end = min(begin + chunk, n);
  const float inf = __int_as_float(0x7f800000);

  float qx[kScanQueries], qy[kScanQueries], qz[kScanQueries], best[kScanQueries];
  unsigned best_j[kScanQueries];
#pragma unroll
  for (int k = 0; k < kScanQueries; ++k) {
    const long long i = first_query + k * kScanThreads;
    const bool in = i < m;
    qx[k] = in ? q[3 * i] : 0.0f;
    qy[k] = in ? q[3 * i + 1] : 0.0f;
    qz[k] = in ? q[3 * i + 2] : 0.0f;
    best[k] = inf;
    best_j[k] = (unsigned)begin;
  }

  for (long long t0 = begin; t0 < end; t0 += kScanTile) {
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < kScanTile; i += kScanThreads) {
      const long long j = t0 + i;
      const bool in = j < end;
      sx[i] = in ? __ldg(ref + j) : inf;
      sy[i] = in ? __ldg(ref + n + j) : inf;
      sz[i] = in ? __ldg(ref + 2 * n + j) : inf;
    }
    __syncthreads();
#pragma unroll 2
    for (int u = 0; u < kScanTile; u += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(sx + u);
      const float4 y4 = *reinterpret_cast<const float4*>(sy + u);
      const float4 z4 = *reinterpret_cast<const float4*>(sz + u);
      const unsigned j = (unsigned)(t0 + u);
#pragma unroll
      for (int k = 0; k < kScanQueries; ++k) {
        take_nearer(qx[k], qy[k], qz[k], x4.x, y4.x, z4.x, j, best[k], best_j[k]);
        take_nearer(qx[k], qy[k], qz[k], x4.y, y4.y, z4.y, j + 1, best[k], best_j[k]);
        take_nearer(qx[k], qy[k], qz[k], x4.z, y4.z, z4.z, j + 2, best[k], best_j[k]);
        take_nearer(qx[k], qy[k], qz[k], x4.w, y4.w, z4.w, j + 3, best[k], best_j[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kScanQueries; ++k) {
    const long long i = first_query + k * kScanThreads;
    if (i < m) {
      atomicMin(keys + i, ((unsigned long long)__float_as_uint(best[k]) << 32) | best_j[k]);
    }
  }
}

__global__ void __launch_bounds__(kUnpackThreads)
nn_unpack_kernel(const unsigned long long* __restrict__ keys, long long m, long long* __restrict__ index,
                 float* __restrict__ d2) {
  const long long i = (long long)blockIdx.x * kUnpackThreads + threadIdx.x;
  if (i < m) {
    const unsigned long long key = keys[i];
    index[i] = (long long)(key & 0xffffffffull);
    d2[i] = __uint_as_float((unsigned)(key >> 32));
  }
}

}  // namespace

// ref: 3 x n float32 planes (x, y, z), contiguous, on the card; q: m x 3 float32, contiguous, on
// the same card; keys: m 64-bit scratch values; index: m int64 and d2: m float32, written with
// each query's nearest reference point and its squared distance. Sets the keys, then launches
// the scan and the unpacking on `stream`.
extern "C" int launch_nn_scan(const float* ref, long long n, const float* q, long long m, void* keys,
                              long long* index, float* d2, void* stream) {
  const long long gx = (m + kBlockQueries - 1) / kBlockQueries;
  if (n <= 0 || n > 0xffffffffLL || m <= 0 || gx > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(keys, 0xff, (size_t)m * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) {
    return (int)rc;
  }
  // Splits of whole tiles: as many as bring the launch near kScanBlocks (so gridDim.y stays
  // under 65536), at most one a tile, none empty.
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  long long splits = (kScanBlocks + gx - 1) / gx;
  splits = splits > tiles ? tiles : splits;
  const long long per_split = (tiles + splits - 1) / splits;
  const long long gy = (tiles + per_split - 1) / per_split;
  auto* k = static_cast<unsigned long long*>(keys);
  nn_scan_kernel<<<dim3((unsigned)gx, (unsigned)gy), kScanThreads, 0, s>>>(ref, n, per_split * kScanTile, q, m, k);
  const cudaError_t scan_rc = cudaGetLastError();
  if (scan_rc != cudaSuccess) {
    return (int)scan_rc;
  }
  const long long ux = (m + kUnpackThreads - 1) / kUnpackThreads;
  nn_unpack_kernel<<<(unsigned)ux, kUnpackThreads, 0, s>>>(k, m, index, d2);
  return (int)cudaGetLastError();
}
