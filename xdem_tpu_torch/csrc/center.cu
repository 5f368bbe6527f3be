// The DEM's centre: the mean of the finite values of a float32 array, accumulated in float64
// and rounded once to float32, 0 where none is finite. K1 removes it before its stencils.
//
// Replaces no TPU kernel: the JAX package leaves this mean to XLA, and the port took it with
// torch's nanmean (isfinite, where, nanmean, any, where: seven passes over the DEM and three
// temporaries its size). Wrapper: xdem_tpu_torch/terrain/cuda_kernels.py::dem_center; plain
// PyTorch twin: xdem_tpu_torch/terrain/surfit.py::dem_center, which a CPU tensor takes. On the
// card the value is this kernel's: the float64 sum rounds far
// below float32's ulp, so it is the correctly rounded mean but for a last-ulp tie, and it is
// the same bits on every call, as the sums' order is fixed.
//
// What bounds it on the H100: bytes. One read of the array (0.4 GB and 0.119 ms at 10 000^2
// against 3.35 TB/s); per value an exponent test, a conversion to float64 and a float64 add,
// well under the FP64 rate. On an H100 (700 W) stage 1 reads at 87 % of that bound at
// 10 000^2 and 92 % at 50 000^2.
//
// Design, deterministic without atomics:
// - Stage 1 (center_partials_kernel). The number of blocks is a function of n alone
//   (center_blocks, never of the card's SM count), and each block owns a fixed contiguous
//   range of the 16-byte vectors. A thread walks its vectors kUnroll loads at a time and adds
//   each finite value to a float64 sum and an integer count; the block adds its threads'
//   partials in a fixed tree in shared memory and writes one (sum, count) into scratch.
//   The values before the first 16-byte boundary (a view at an offset) and after the last
//   whole vector are read one by one, by block 0 and by the last block.
// - Stage 2 (center_finish_kernel), a second launch on the same stream: one block adds the
//   partials in a fixed order and writes sum / count rounded to float32.
// Indices are 64-bit: the 50 000^2 DEM of a mesh holds 2.5e9 values.
#include "common.cuh"

namespace {

using namespace xdt;

constexpr int kCenterThreads = 256;
constexpr int kMaxBlocks = 1024;
// Fewer values than this a block, and the array takes fewer blocks.
constexpr long long kMinPerBlock = 16384;
constexpr int kUnroll = 4;

__host__ __device__ inline int blocks_for(long long n) {
  const long long b = (n + kMinPerBlock - 1) / kMinPerBlock;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : (int)b);
}

__device__ __forceinline__ void add_finite(float x, double& sum, unsigned& count) {
  const bool finite = (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
  sum += finite ? (double)x : 0.0;
  count += finite;
}

// The block's threads' (sum, count) added in a fixed tree; the result is thread 0's.
__device__ __forceinline__ void block_sum(double& sum, unsigned long long& count) {
  __shared__ double sums[kCenterThreads];
  __shared__ unsigned long long counts[kCenterThreads];
  const int t = threadIdx.x;
  sums[t] = sum;
  counts[t] = count;
  __syncthreads();
  for (int stride = kCenterThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      sums[t] += sums[t + stride];
      counts[t] += counts[t + stride];
    }
    __syncthreads();
  }
  sum = sums[0];
  count = counts[0];
}

// src: the array, at a 4-byte boundary; head: the values before its first 16-byte boundary;
// n_vec: the whole vectors after them; per: vectors a block; sums, counts: one per block.
__global__ void __launch_bounds__(kCenterThreads)
center_partials_kernel(const float* __restrict__ src, long long n, int head, long long n_vec,
                       long long per, double* __restrict__ sums,
                       unsigned long long* __restrict__ counts) {
  const int t = threadIdx.x;
  double sum = 0.0;
  unsigned count = 0;  // at most ceil(n / (blocks * threads)) + 4 values: n < 2^50
  if (blockIdx.x == 0 && t < head) {
    add_finite(src[t], sum, count);
  }
  const long long tail_start = head + 4 * n_vec;
  if (blockIdx.x == gridDim.x - 1 && tail_start + t < n) {
    add_finite(src[tail_start + t], sum, count);
  }
  const float4* __restrict__ vec = reinterpret_cast<const float4*>(src + head);
  const long long begin = (long long)blockIdx.x * per;
  const long long end = begin + per < n_vec ? begin + per : n_vec;
  for (long long i = begin + t; i < end; i += (long long)kCenterThreads * kUnroll) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * kCenterThreads;
      q[u] = j < end ? __ldg(vec + j) : make_float4(qnan(), qnan(), qnan(), qnan());
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_finite(q[u].x, sum, count);
      add_finite(q[u].y, sum, count);
      add_finite(q[u].z, sum, count);
      add_finite(q[u].w, sum, count);
    }
  }
  unsigned long long total = count;
  block_sum(sum, total);
  if (t == 0) {
    sums[blockIdx.x] = sum;
    counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kCenterThreads)
center_finish_kernel(const double* __restrict__ sums, const unsigned long long* __restrict__ counts,
                     int blocks, float* __restrict__ out) {
  double sum = 0.0;
  unsigned long long count = 0;
  for (int b = threadIdx.x; b < blocks; b += kCenterThreads) {
    sum += sums[b];
    count += counts[b];
  }
  block_sum(sum, count);
  if (threadIdx.x == 0) {
    *out = count ? (float)(sum / (double)count) : 0.0f;
  }
}

}  // namespace

// Blocks of stage 1 for n values: the wrapper allocates 2 * center_blocks(n) doubles of scratch.
extern "C" int center_blocks(long long n) { return blocks_for(n); }

// src: n float32 values, contiguous, on the card; scratch: 2 * center_blocks(n) doubles;
// out: one float32. Any n >= 0 (0 writes 0).
extern "C" int launch_center(const float* src, long long n, double* scratch, float* out, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  if (n < 0 || (addr & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long to_boundary = (long long)((16 - (addr & 15)) & 15) / 4;
  const int head = (int)(to_boundary < n ? to_boundary : n);
  const long long n_vec = (n - head) / 4;
  const int blocks = blocks_for(n);
  const long long per = (n_vec + blocks - 1) / blocks;
  double* sums = scratch;
  unsigned long long* counts = reinterpret_cast<unsigned long long*>(scratch + blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  center_partials_kernel<<<blocks, kCenterThreads, 0, s>>>(src, n, head, n_vec, per, sums, counts);
  center_finish_kernel<<<1, kCenterThreads, 0, s>>>(sums, counts, blocks, out);
  return (int)cudaGetLastError();
}
