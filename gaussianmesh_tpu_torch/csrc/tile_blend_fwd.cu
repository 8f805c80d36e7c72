// K1, the blend forward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel gaussianmesh_tpu/ops/tile_blend.py::
// _make_sorted_fwd_kernel (launched by the pallas_call in _sorted_fwd_impl,
// tile_blend.py:1111). It computes the function of the plain
// gaussianmesh_tpu_torch/ops/tile_blend.py::blend_forward_plain, straight
// from the ragged sorted pair domain: for each 16x16 tile t, each pixel walks
// the pairs [starts[t], starts[t] + counts[t]) of sorted_gid front to back
// with the reference's sequential semantics (renderCUDA, forward.cu:261-374):
//   skip the pair if power > 0 or alpha = min(0.99, op * e^power) < 1/255;
//   stop when T * (1 - alpha) < 1e-4 (that pair is not blended);
//   color += alpha * T * rgb; T *= 1 - alpha; n_contrib = rank of the last
//   blended pair (1-based).
//
// Design. One block of 256 threads per tile, one pixel per thread, so each
// warp holds 2 pixel rows (2 pixels per thread, measured, halves the warps
// a heavy tile has and loses at the training step's shapes). The kernel is
// bound by latency, not by the card's rates: each pixel's walk is a serial
// chain, and the heavy tiles (1,352 pairs against a mean of 156 at 1080p,
// thousands at the training step's shapes) set its end. So:
//  - staging: 256-pair batches gathered through sorted_gid (this folds in
//    the table gather that the JAX path does as a separate pass) with
//    cp.async into a ring of two, as float4s (3 LDS.128 broadcasts per
//    pair); the next batch's copies and the one after's sorted_gid loads
//    are in flight while a batch is walked;
//  - per-warp pair lists: a warp walks only the pairs of the batch whose
//    gate can pass on its rows (reaches_rows, a conservative test: a pair
//    it drops would have been gated out at every pixel of the warp, so no
//    bit changes), compacted with a ballot;
//  - a thread walks kG = 4 listed pairs at a time: it first evaluates them
//    (independent expf chains), then runs the sequential updates; its loop
//    ends when its pixel is done, and the block leaves on
//    __syncthreads_count once every pixel is. Pixels outside the image
//    (the last tile row of 1080p is 8 px high) start done.
// Blocks take tiles in index order: a heaviest-first order (K2's) saves
// less here than the sort that makes it costs.
// Deterministic: no atomics, every output element written by one thread.
//
// Bound: per (pair, pixel) evaluation about 12 FP32 operations and one expf
// (one MUFU.EX2 plus a few FP32 operations); bytes are sorted_gid + 36 B of
// features per pair, and 20 B per pixel written. At the 1080p render path
// the evaluations dominate, so the operations bound it (the MUFU rate
// first). All arithmetic of the chain is written with explicit
// round-to-nearest intrinsics in the plain version's operation order, so no
// FMA contraction moves alpha across the 1/255 gate or T across 1e-4
// relative to the plain version on the same card, and the two agree bit for
// bit there. Built without --use_fast_math: expf, not __expf.

#include "blend_common.cuh"

namespace {

using namespace gm_blend;

constexpr int kThreads = kPix;      // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;               // listed pairs evaluated together
constexpr int kBatch = 256;         // pairs per staged batch (one per thread)
constexpr float kTEps = 1e-4f;
static_assert(kBatch == kThreads, "each thread stages one pair of a batch");

__global__ void __launch_bounds__(kThreads)
tile_blend_fwd_kernel(const float* __restrict__ feat,
                      const int32_t* __restrict__ sorted_gid,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      int grid_x, int width, int height,
                      float* __restrict__ color,
                      float* __restrict__ final_t,
                      int32_t* __restrict__ n_contrib) {
  // cols 0-3, 4-7, 8-11 of each staged row, two stages
  __shared__ float4 s_feat[2][kBatch][3];
  __shared__ unsigned char s_list[kWarps][kBatch];  // each warp's pairs of the batch

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int pix_x = (tile % grid_x) * kTile + t % kTile;
  const int pix_y = (tile / grid_x) * kTile + t / kTile;
  const float px = static_cast<float>(pix_x);
  const float py = static_cast<float>(pix_y);
  // this warp's two pixel rows
  const float wy0 = static_cast<float>((tile / grid_x) * kTile + 2 * warp);
  const float wy1 = wy0 + 1.0f;

  float T = 1.0f;
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  int last = 0;
  bool done = !(pix_x < width && pix_y < height);

  const int begin = starts[tile];
  const int count = counts[tile];
  const int nb = (count + kBatch - 1) / kBatch;

  // batch b holds pairs [b * kBatch, min(count, (b + 1) * kBatch)); this
  // thread stages pair b * kBatch + t
  int gid = 0;
  auto load_gid = [&](int b) {
    const int pair = b * kBatch + t;
    gid = pair < count ? sorted_gid[begin + pair] : 0;
  };
  auto issue = [&](int b) {
    if (b * kBatch + t < count) {
      const float4* src = reinterpret_cast<const float4*>(
          feat + static_cast<size_t>(gid) * kFeat);
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async16(&s_feat[b & 1][t][c], src + c);
    }
    cp_async_commit();
  };
  if (nb > 0) {
    load_gid(0);
    issue(0);
    if (nb > 1) load_gid(1);
  }

  for (int b = 0; b < nb; ++b) {
    const int base = b * kBatch;
    const int n = min(kBatch, count - base);
    if (b + 1 < nb) {
      issue(b + 1);  // its stage was last read by batch b - 1's walk
      if (b + 2 < nb) load_gid(b + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // batch b staged

    const float4(*f4)[3] = s_feat[b & 1];
    if (!__all_sync(0xffffffffu, done)) {
      // the pairs of the batch whose gate can pass on this warp's rows
      unsigned char* list = s_list[warp];
      int cnt = 0;
      for (int c = 0; c < n; c += 32) {
        const int i = c + lane;
        const bool r = i < n && reaches_rows(f4[i][0], f4[i][1], wy0, wy1);
        const unsigned bal = __ballot_sync(0xffffffffu, r);
        if (r) list[cnt + __popc(bal & ((1u << lane) - 1u))] = static_cast<unsigned char>(i);
        cnt += __popc(bal);
      }
      __syncwarp();
      for (int e0 = 0; !done && e0 < cnt; e0 += kG) {
        // evaluate kG listed pairs, then blend them in order
        int jj[kG];
        float alpha[kG];
        bool gate[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          jj[i] = e0 + i < cnt ? list[e0 + i] : -1;
          const float4 a = f4[max(jj[i], 0)][0];  // x y ca cb
          const float4 f = f4[max(jj[i], 0)][1];  // cc op r g
          const float dx = __fsub_rn(a.x, px);
          const float dy = __fsub_rn(a.y, py);
          // power = -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy
          const float qa = __fmul_rn(__fmul_rn(a.z, dx), dx);
          const float qc = __fmul_rn(__fmul_rn(f.x, dy), dy);
          const float qb = __fmul_rn(__fmul_rn(a.w, dx), dy);
          const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
          alpha[i] = fminf(kAlphaMax, __fmul_rn(f.y, expf(power)));
          // also false for a NaN power
          gate[i] = jj[i] >= 0 && power <= 0.0f && alpha[i] >= kAlphaMin;
        }
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          if (done || !gate[i]) continue;
          const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha[i]));
          if (test_t < kTEps) {
            done = true;
            continue;
          }
          const float4 f = f4[jj[i]][1];
          const float w = __fmul_rn(alpha[i], T);
          c_r = __fadd_rn(c_r, __fmul_rn(w, f.z));
          c_g = __fadd_rn(c_g, __fmul_rn(w, f.w));
          c_b = __fadd_rn(c_b, __fmul_rn(w, f4[jj[i]][2].x));
          T = test_t;
          last = base + jj[i] + 1;
        }
      }
    }
    // also the barrier that keeps the next issue behind this batch's reads
    if (__syncthreads_count(done) == kThreads) break;
  }
  cp_async_wait<0>();

  if (pix_x < width && pix_y < height) {
    const size_t hw = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pix_y) * width + pix_x;
    color[p] = c_r;
    color[hw + p] = c_g;
    color[2 * hw + p] = c_b;
    final_t[p] = T;
    n_contrib[p] = last;
  }
}

}  // namespace

// Launches K1 on `stream` over num_tiles = grid_x * ceil(height / 16) tiles.
// `feat` is 16-B aligned. Outputs: color (3, height, width), final_t and
// n_contrib (height, width). Returns the cudaError_t of the launch.
extern "C" int gm_tile_blend_fwd(const float* feat, const int32_t* sorted_gid,
                                 const int32_t* starts, const int32_t* counts,
                                 int num_tiles, int grid_x, int width, int height,
                                 float* color, float* final_t,
                                 int32_t* n_contrib, void* stream) {
  if (num_tiles > 0) {
    tile_blend_fwd_kernel<<<num_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        feat, sorted_gid, starts, counts, grid_x, width, height, color,
        final_t, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of K1 on the current device: threads per block, shared
// memory per block and resident blocks per SM. Returns a cudaError_t.
extern "C" int gm_tile_blend_fwd_occupancy(int* threads, int* smem_bytes,
                                           int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tile_blend_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kThreads;
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tile_blend_fwd_kernel, kThreads, 0));
}
