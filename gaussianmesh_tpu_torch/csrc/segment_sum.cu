// K3, the per-Gaussian gradient reduction, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel gaussianmesh_tpu/ops/segsum.py::_segtree_kernel
// (launched by the pallas_call in _tree_passes_tpu, segsum.py:132, under
// _reduce_grouped, which the blend's fused VJP calls at tile_blend.py:1297).
// It computes the function of the plain
// gaussianmesh_tpu_torch/ops/segsum.py::segment_sum_plain:
//   out[g][c] = sum over e in [seg_starts[g], seg_starts[g + 1]) of
//               rows[grouped_pos[e]][c],   g < n;   out[n] = 0 (dummy row)
// rows are the blend backward's (M, 16) per-pair gradient rows in sorted
// (tile, depth) order; grouped_pos maps each emission-order pair (emission
// is Gaussian-major) to its sorted position, so Gaussian g's rows are one
// contiguous run of grouped_pos and no sort is needed.
//
// Bound: bytes. It reads each row once (64 B) plus its grouped_pos entry
// (4 B), reads seg_starts and writes the (n + 1, 16) table; the float64 adds
// (16 per row) are far below the card's float64 rate. What holds a simple
// kernel back is latency: each row sits behind a chain of three dependent
// loads (seg_starts -> grouped_pos -> the row), most segments hold 0 to a
// few rows, and a splat near the camera holds one row per tile it reaches
// (up to 8,160 at 1080p).
//
// Design, one launch of 256-thread blocks, 64 Gaussians per block:
// 1. 4 lanes per Gaussian. Each lane owns one float4 quad of columns, so a
//    warp sums 8 Gaussians; the warp loads their 9 segment starts with one
//    coalesced load and shares them by shuffle. A group fetches the next 4
//    grouped_pos entries, then their rows, and the following 4 entries
//    before it adds: 4 rows and the next 4 indices are in flight at once.
//    The adds run in segment order into float64, so the bits are fixed. A
//    zero-length Gaussian reads no row. The warp writes its 8 output rows as
//    16-byte stores, 512 contiguous bytes.
// 2. A segment of more than kLongSegment (32) rows is left to its block.
//    Each warp publishes a ballot of its long groups in shared memory; after
//    one barrier (__syncthreads_or, which also tells a block with no long
//    segment to stop) the whole block sums its long segments one after
//    another in id order: group j of the block's 64 takes rows j, j + 64,
//    ... with the same loads ahead, a fixed xor butterfly sums each warp's 8
//    groups, and one thread per column adds the 8 warp partials in warp
//    order. A full-screen segment (8,160 rows) is 128 rows per lane. No work
//    list, no scratch, no second launch, no atomics: every sum runs in an
//    order fixed by the data.
// Float64 accumulation, no cap on segment length; the same bits on every
// run. ops/segsum.py's LONG_SEGMENT mirrors kLongSegment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 16;
constexpr int kQuads = kFeat / 4;                  // lanes per Gaussian
constexpr int kGroups = 32 / kQuads;               // Gaussians per warp
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerBlock = kThreads / kQuads;       // Gaussians per block
constexpr int kUnroll = 4;                         // rows in flight per lane
constexpr int kLongSegment = 32;                   // longer: the whole block
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
  double x = 0.0, y = 0.0, z = 0.0, w = 0.0;
};

__device__ __forceinline__ void add(Acc& a, const float4& v) {
  a.x += static_cast<double>(v.x);
  a.y += static_cast<double>(v.y);
  a.z += static_cast<double>(v.z);
  a.w += static_cast<double>(v.w);
}

// Adds quad q of rows[grouped_pos[e]] for e = e0, e0 + stride, ... < end
// into a, in that order, with kUnroll rows and the next kUnroll indices in
// flight.
__device__ __forceinline__ void walk(const float4* __restrict__ rows,
                                     const int32_t* __restrict__ grouped_pos,
                                     int e, int end, int stride, int q,
                                     Acc& a) {
  int pos[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = e + u * stride;
    pos[u] = i < end ? __ldg(grouped_pos + i) : -1;
  }
  for (; e < end; e += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = pos[u] >= 0
                 ? __ldg(rows + static_cast<size_t>(pos[u]) * kQuads + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int next = e + kUnroll * stride;
    int nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = next + u * stride;
      nxt[u] = i < end ? __ldg(grouped_pos + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (pos[u] >= 0) add(a, v[u]);
      pos[u] = nxt[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float4* __restrict__ rows,
                   const int32_t* __restrict__ grouped_pos,
                   const int32_t* __restrict__ seg_starts, int n,
                   float4* __restrict__ out) {
  __shared__ unsigned long_groups[kWarps];
  __shared__ double part[kWarps][kFeat];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = blockIdx.x * kPerBlock + warp * kGroups;
  const int s = (lane <= kGroups && g0 + lane <= n)
                    ? __ldg(seg_starts + g0 + lane) : 0;
  const int grp = lane / kQuads, q = lane % kQuads;
  const int g = g0 + grp;
  const int begin = __shfl_sync(kFull, s, grp);
  int end = __shfl_sync(kFull, s, grp + 1);
  if (g >= n) end = begin;                      // the dummy row and past it
  const bool is_long = end - begin > kLongSegment;
  const unsigned ballot = __ballot_sync(kFull, is_long && q == 0);
  if (!is_long && g <= n) {
    Acc a;
    walk(rows, grouped_pos, begin, end, 1, q, a);
    out[static_cast<size_t>(g) * kQuads + q] = make_float4(
        static_cast<float>(a.x), static_cast<float>(a.y),
        static_cast<float>(a.z), static_cast<float>(a.w));
  }
  if (lane == 0) long_groups[warp] = ballot;
  if (!__syncthreads_or(ballot != 0)) return;
  float* out_cols = reinterpret_cast<float*>(out);
  for (int w = 0; w < kWarps; ++w) {
    for (unsigned b = long_groups[w]; b != 0; b &= b - 1) {
      const int gl = blockIdx.x * kPerBlock + w * kGroups +
                     (__ffs(b) - 1) / kQuads;
      Acc a;
      walk(rows, grouped_pos,
           __ldg(seg_starts + gl) + static_cast<int>(threadIdx.x) / kQuads,
           __ldg(seg_starts + gl + 1), kPerBlock, q, a);
#pragma unroll
      for (int off = kQuads; off < 32; off <<= 1) {
        a.x += __shfl_xor_sync(kFull, a.x, off);
        a.y += __shfl_xor_sync(kFull, a.y, off);
        a.z += __shfl_xor_sync(kFull, a.z, off);
        a.w += __shfl_xor_sync(kFull, a.w, off);
      }
      if (lane < kQuads) {
        part[warp][4 * q] = a.x;
        part[warp][4 * q + 1] = a.y;
        part[warp][4 * q + 2] = a.z;
        part[warp][4 * q + 3] = a.w;
      }
      __syncthreads();
      if (threadIdx.x < kFeat) {
        double t = 0.0;
        for (int k = 0; k < kWarps; ++k) t += part[k][threadIdx.x];
        out_cols[static_cast<size_t>(gl) * kFeat + threadIdx.x] =
            static_cast<float>(t);
      }
      __syncthreads();                          // part is free again
    }
  }
}

}  // namespace

// Launches K3 on `stream`: n Gaussians (seg_starts holds n + 1 entries),
// out (n + 1, 16); rows 16-byte aligned. Returns a cudaError_t.
extern "C" int gm_segment_sum(const float* rows, const int32_t* grouped_pos,
                              const int32_t* seg_starts, int n, float* out,
                              void* stream) {
  const int blocks = n / kPerBlock + 1;         // n + 1 rows
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), grouped_pos, seg_starts, n,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of K3 on the current device: threads per block, shared
// memory per block and resident blocks per SM. Returns a cudaError_t.
extern "C" int gm_segment_sum_occupancy(int* threads, int* smem_bytes,
                                        int* blocks_per_sm) {
  *threads = kThreads;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, segment_sum_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, segment_sum_kernel, kThreads, 0));
}
