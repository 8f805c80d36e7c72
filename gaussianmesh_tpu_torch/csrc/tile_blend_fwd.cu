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
// Design (simple and right first): one block of 256 threads per tile, one
// thread per pixel. The block stages 256 pairs at a time in shared memory,
// one pair per thread: it gathers the pair's 9 feature floats through
// sorted_gid (this folds in the table gather that the JAX path does as a
// separate pass), then every thread walks the batch in order. The block
// leaves once every pixel is done (__syncthreads_count); pixels outside the
// image (the last tile row of 1080p is 8 px high) start done. Deterministic:
// no atomics, every output element written by one thread.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kFeat = 16;  // pack_features row: x y ca cb cc op r g b real ...
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
tile_blend_fwd_kernel(const float* __restrict__ feat,
                      const int32_t* __restrict__ sorted_gid,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      int grid_x, int width, int height,
                      float* __restrict__ color,
                      float* __restrict__ final_t,
                      int32_t* __restrict__ n_contrib) {
  __shared__ float s_x[kPix], s_y[kPix], s_ca[kPix], s_cb[kPix], s_cc[kPix];
  __shared__ float s_op[kPix], s_r[kPix], s_g[kPix], s_b[kPix];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int pix_x = (tile % grid_x) * kTile + t % kTile;
  const int pix_y = (tile / grid_x) * kTile + t / kTile;
  const bool inside = pix_x < width && pix_y < height;
  const float px = static_cast<float>(pix_x);
  const float py = static_cast<float>(pix_y);

  const int begin = starts[tile];
  const int count = counts[tile];

  float T = 1.0f;
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f;
  int last = 0;
  bool done = !inside;

  for (int base = 0; base < count; base += kPix) {
    // also the barrier that keeps this batch's loads behind the last
    // batch's reads
    if (__syncthreads_count(done) == kPix) break;
    const int k = base + t;
    if (k < count) {
      const float* f = feat + static_cast<size_t>(sorted_gid[begin + k]) * kFeat;
      s_x[t] = f[0];
      s_y[t] = f[1];
      s_ca[t] = f[2];
      s_cb[t] = f[3];
      s_cc[t] = f[4];
      s_op[t] = f[5];
      s_r[t] = f[6];
      s_g[t] = f[7];
      s_b[t] = f[8];
    }
    __syncthreads();
    const int n = min(kPix, count - base);
    for (int j = 0; !done && j < n; ++j) {
      const float dx = __fsub_rn(s_x[j], px);
      const float dy = __fsub_rn(s_y[j], py);
      // power = -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy
      const float qa = __fmul_rn(__fmul_rn(s_ca[j], dx), dx);
      const float qc = __fmul_rn(__fmul_rn(s_cc[j], dy), dy);
      const float qb = __fmul_rn(__fmul_rn(s_cb[j], dx), dy);
      const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
      if (!(power <= 0.0f)) continue;  // also skips a NaN power
      const float alpha = fminf(kAlphaMax, __fmul_rn(s_op[j], expf(power)));
      if (!(alpha >= kAlphaMin)) continue;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
      c_r = __fadd_rn(c_r, __fmul_rn(w, s_r[j]));
      c_g = __fadd_rn(c_g, __fmul_rn(w, s_g[j]));
      c_b = __fadd_rn(c_b, __fmul_rn(w, s_b[j]));
      T = test_t;
      last = base + j + 1;
    }
  }

  if (inside) {
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
// Outputs: color (3, height, width), final_t and n_contrib (height, width).
// Returns the cudaError_t of the launch.
extern "C" int gm_tile_blend_fwd(const float* feat, const int32_t* sorted_gid,
                                 const int32_t* starts, const int32_t* counts,
                                 int num_tiles, int grid_x, int width,
                                 int height, float* color, float* final_t,
                                 int32_t* n_contrib, void* stream) {
  if (num_tiles > 0) {
    tile_blend_fwd_kernel<<<num_tiles, kPix, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        feat, sorted_gid, starts, counts, grid_x, width, height, color,
        final_t, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}
