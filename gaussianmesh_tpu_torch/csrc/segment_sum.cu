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
// Design: one warp per Gaussian. Lane = (sub, column): columns 0..15 of the
// row, sub 0 or 1 takes the segment's even or odd entries, so each load
// instruction of the warp reads two whole 64-byte rows. Each lane sums its
// column in float64 in segment order, one __shfl_xor_sync joins the two
// halves, and the f32 result is written once. The order is fixed, so the
// result is the same bits on every run (no atomics), and float64 keeps it
// within one f32 rounding of the exact sum for any segment length: there is
// no length cap (the TPU version's extra-head scatter is capped,
// segsum.py:194-199, and drops gradient for long segments at high ids).
//
// Bound: bytes. It reads each row once (64 B) plus its grouped_pos entry
// (4 B), reads seg_starts and writes the (n + 1, 16) table; the float64 adds
// (16 per row) are far below the card's float64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeat = 16;
constexpr int kWarps = 8;  // Gaussians per 256-thread block

__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ rows,
                   const int32_t* __restrict__ grouped_pos,
                   const int32_t* __restrict__ seg_starts, int n,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g > n) return;  // whole warps leave together
  const int col = lane & (kFeat - 1);
  const int sub = lane >> 4;
  double acc = 0.0;
  if (g < n) {
    const int begin = seg_starts[g];
    const int end = seg_starts[g + 1];
#pragma unroll 4
    for (int e = begin + sub; e < end; e += 2) {
      acc += static_cast<double>(
          rows[static_cast<size_t>(grouped_pos[e]) * kFeat + col]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (sub == 0) out[static_cast<size_t>(g) * kFeat + col] = static_cast<float>(acc);
}

}  // namespace

// Launches K3 on `stream`: n Gaussians (seg_starts holds n + 1 entries),
// out (n + 1, 16). Returns the cudaError_t of the launch.
extern "C" int gm_segment_sum(const float* rows, const int32_t* grouped_pos,
                              const int32_t* seg_starts, int n, float* out,
                              void* stream) {
  const int blocks = (n + 1 + kWarps - 1) / kWarps;
  segment_sum_kernel<<<blocks, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, grouped_pos, seg_starts, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of K3 on the current device: threads per block, shared
// memory per block and resident blocks per SM. Returns a cudaError_t.
extern "C" int gm_segment_sum_occupancy(int* threads, int* smem_bytes,
                                        int* blocks_per_sm) {
  *threads = kWarps * 32;
  *smem_bytes = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, segment_sum_kernel, kWarps * 32, 0));
}
