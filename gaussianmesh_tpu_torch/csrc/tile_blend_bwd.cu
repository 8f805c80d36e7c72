// K2, the blend backward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel gaussianmesh_tpu/ops/tile_blend.py::
// _make_sorted_bwd_kernel (launched by the pallas_call in _run_bwd_kernel,
// tile_blend.py:1187; VJP rules _sorted_bwd_rule :1201 and _fused_bwd_rule
// :1275). It computes the function of the plain
// gaussianmesh_tpu_torch/ops/tile_blend.py::blend_backward_plain: one
// gradient row per sorted pair, in pack_features layout
//   0 x, 1 y, 2 conic a, 3 conic b, 4 conic c, 5 opacity, 6..8 rgb, 9..15 0,
// contracted over the pair's tile's 256 pixels.
//
// Per pixel it walks its tile's pairs back to front, the reference's way
// (renderCUDA backward, backward.cu:399-557): it starts from K1's final_t
// and n_contrib (the rank of the last blended pair) and recovers the
// transmittance in front of each blended pair by dividing by (1 - alpha).
// Nothing is stashed by the forward (the TPU kernel stashes the blend
// weight w, (pairs, 256) f32: 1.3 GB per step at 1080p). For a blended pair
//   dL/dw     = rgb . g_color
//   dL/dalpha = dL/dw * T - q / (1 - alpha), q = sum of dL/dw_j * w_j over
//               the later blended pairs + g_final_t * final_t
//   dL/dpower = dL/dalpha * alpha,  d opacity = dL/dalpha * e^power
//               (both 0 where the 0.99 cap is active: no gradient through
//               min(0.99, .), README "Known deviations")
//   d(x, y, conic) from power = -0.5 (a dx^2 + c dy^2) - b dx dy
//   d rgb     = w * g_color
// Gated pairs (power > 0 or alpha < 1/255), the pair that ends a pixel,
// pairs behind a pixel's last blended one and pixels outside the image
// (1080 % 16 = 8) contribute nothing. Pairs that max_per_tile dropped get a
// zero row.
//
// Design (simple and right first): one block of 256 threads per tile, one
// thread per pixel, 8 warps. The tile's walk starts at the largest
// n_contrib of its pixels. Pairs are staged back to front in batches of 128
// (their 9 feature floats gathered through sorted_gid into shared memory);
// every thread walks the batch in reverse. For each pair each warp sums its
// 32 pixels' 9 values with a fixed __shfl_down_sync tree (skipped when no
// lane of the warp has a blended pixel) into shared memory; after the batch
// each output value is the sum of the 8 warp partials in warp order.
// Deterministic: no atomics, every row written by one block in a fixed
// order. Shared memory 128 pairs x 8 warps x 9 floats (36,864 B) + the
// staged features (4,608 B), under the 48 KB static limit.
//
// Bound: operations. Per (pair, pixel) evaluation of the walk about 12 FP32
// operations and one expf (as K1); per blended one about 40 more and a
// division. The arithmetic of the chain uses explicit round-to-nearest
// intrinsics in the plain version's operation order (no FMA contraction), so
// the gates, the recovered T and each pixel's terms are the plain version's
// bits on the same card; only the 256-pixel sum is taken in another order.
// Built without --use_fast_math: expf, not __expf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kFeat = 16;  // pack_features row: x y ca cb cc op r g b real ...
constexpr int kOut = 9;    // live columns of a gradient row
constexpr int kBatch = 128;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

__global__ void __launch_bounds__(kPix)
tile_blend_bwd_kernel(const float* __restrict__ feat,
                      const int32_t* __restrict__ sorted_gid,
                      const int32_t* __restrict__ starts,
                      const float* __restrict__ final_t,
                      const int32_t* __restrict__ n_contrib,
                      const float* __restrict__ g_color,
                      const float* __restrict__ g_final_t,
                      int grid_x, int width, int height,
                      float* __restrict__ rows) {
  __shared__ float s_x[kBatch], s_y[kBatch], s_ca[kBatch], s_cb[kBatch];
  __shared__ float s_cc[kBatch], s_op[kBatch], s_r[kBatch], s_g[kBatch];
  __shared__ float s_b[kBatch];
  __shared__ float s_part[kBatch][kWarps][kOut];
  __shared__ int s_last[kWarps];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int pix_x = (tile % grid_x) * kTile + t % kTile;
  const int pix_y = (tile / grid_x) * kTile + t / kTile;
  const bool inside = pix_x < width && pix_y < height;
  const float px = static_cast<float>(pix_x);
  const float py = static_cast<float>(pix_y);

  const size_t hw = static_cast<size_t>(width) * height;
  const size_t p = static_cast<size_t>(pix_y) * width + pix_x;
  float T = 1.0f, q = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int last = 0;
  if (inside) {
    T = final_t[p];
    last = n_contrib[p];
    gr = g_color[p];
    gg = g_color[hw + p];
    gb = g_color[2 * hw + p];
    q = __fmul_rn(g_final_t[p], T);
  }

  const int begin = starts[tile];
  const int range = starts[tile + 1] - begin;  // clamped pairs included
  const int wmax = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s_last[warp] = wmax;
  __syncthreads();
  int walk = 0;  // pairs [0, walk) can have a blended pixel
  for (int w = 0; w < kWarps; ++w) walk = max(walk, s_last[w]);

  float* tile_rows = rows + static_cast<size_t>(begin) * kFeat;
  for (int k = walk * kFeat + t; k < range * kFeat; k += kPix) tile_rows[k] = 0.0f;

  for (int end = walk; end > 0; end -= kBatch) {
    const int base = max(end - kBatch, 0);
    const int n = end - base;
    __syncthreads();  // the last batch's staged features and partials are read
    if (t < n) {
      const float* f = feat + static_cast<size_t>(sorted_gid[begin + base + t]) * kFeat;
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

    for (int jb = n - 1; jb >= 0; --jb) {
      float c[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) c[k] = 0.0f;
      bool blended = false;
      if (base + jb < last) {
        const float ca = s_ca[jb], cb = s_cb[jb], cc = s_cc[jb];
        const float dx = __fsub_rn(s_x[jb], px);
        const float dy = __fsub_rn(s_y[jb], py);
        const float qa = __fmul_rn(__fmul_rn(ca, dx), dx);
        const float qc = __fmul_rn(__fmul_rn(cc, dy), dy);
        const float qb = __fmul_rn(__fmul_rn(cb, dx), dy);
        const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
        if (power <= 0.0f) {
          const float e = expf(power);
          const float raw = __fmul_rn(s_op[jb], e);
          const float alpha = fminf(kAlphaMax, raw);
          if (alpha >= kAlphaMin) {
            blended = true;
            const float om = __fsub_rn(1.0f, alpha);
            T = __fdiv_rn(T, om);  // the transmittance in front of this pair
            const float w = __fmul_rn(alpha, T);
            const float dldw = __fadd_rn(
                __fadd_rn(__fmul_rn(s_r[jb], gr), __fmul_rn(s_g[jb], gg)),
                __fmul_rn(s_b[jb], gb));
            c[6] = __fmul_rn(w, gr);
            c[7] = __fmul_rn(w, gg);
            c[8] = __fmul_rn(w, gb);
            const float dalpha = __fsub_rn(__fmul_rn(dldw, T), __fdiv_rn(q, om));
            q = __fadd_rn(q, __fmul_rn(dldw, w));
            if (raw <= kAlphaMax) {
              const float dpower = __fmul_rn(dalpha, alpha);
              c[0] = __fmul_rn(dpower, -__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(cb, dy)));
              c[1] = __fmul_rn(dpower, -__fadd_rn(__fmul_rn(cc, dy), __fmul_rn(cb, dx)));
              c[2] = __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(dx, dx)));
              c[3] = __fmul_rn(dpower, -__fmul_rn(dx, dy));
              c[4] = __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(dy, dy)));
              c[5] = __fmul_rn(dalpha, e);
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, blended)) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            c[k] = __fadd_rn(c[k], __shfl_down_sync(0xffffffffu, c[k], off));
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) s_part[jb][warp][k] = c[k];
      }
    }
    __syncthreads();

    float* batch_rows = tile_rows + static_cast<size_t>(base) * kFeat;
    for (int k = t; k < n * kFeat; k += kPix) {
      const int pair = k / kFeat;
      const int col = k % kFeat;
      float v = 0.0f;
      if (col < kOut) {
        for (int w = 0; w < kWarps; ++w) v = __fadd_rn(v, s_part[pair][w][col]);
      }
      batch_rows[k] = v;
    }
  }
}

}  // namespace

// Launches K2 on `stream` over num_tiles = grid_x * ceil(height / 16) tiles.
// Inputs: the (N + 1, 16) feature table, the sorted pair domain (sorted_gid,
// starts (num_tiles + 1,)), K1's final_t and n_contrib (height, width; the
// clamped per-tile counts bound n_contrib, so the kernel needs only it), the
// cotangents g_color (3, height, width) and g_final_t (height, width).
// Output rows (starts[num_tiles], 16), every row written. Returns the
// cudaError_t of the launch.
extern "C" int gm_tile_blend_bwd(const float* feat, const int32_t* sorted_gid,
                                 const int32_t* starts,
                                 const float* final_t, const int32_t* n_contrib,
                                 const float* g_color, const float* g_final_t,
                                 int num_tiles, int grid_x, int width,
                                 int height, float* rows, void* stream) {
  if (num_tiles > 0) {
    tile_blend_bwd_kernel<<<num_tiles, kPix, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        feat, sorted_gid, starts, final_t, n_contrib, g_color,
        g_final_t, grid_x, width, height, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
