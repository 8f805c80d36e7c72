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
// Design. One block of 256 threads per tile, one pixel per thread, so each
// warp holds 2 pixel rows (2 pixels per thread, measured, halves the warps
// a heavy tile has and loses at the training step's shapes). The kernel is
// bound by latency, not by the card's rates: each pixel's walk is a serial
// chain, and the heavy tiles (thousands of pairs at the training step's
// shapes) set its end. So:
//  - staging: 96-pair batches gathered through sorted_gid with cp.async
//    into a ring of two, as float4s (3 LDS.128 broadcasts per pair); the
//    next batch's copies and the one after's sorted_gid loads are in
//    flight while a batch is walked;
//  - per-warp pair lists: a warp walks only the pairs below its own
//    pixels' largest n_contrib, and of those only the ones whose gate can
//    pass on its rows (reaches_rows, a conservative test: a pair it drops
//    would have been gated out at every pixel of the warp, so no bit
//    changes). The warp compacts them with a ballot; a warp with none
//    neither evaluates, reduces nor stores;
//  - groups of 3 listed pairs: a thread first evaluates them
//    (independent expf chains), then runs the sequential T / q updates,
//    every lane on every pair some lane blends, keeping its results only
//    where its own pixel does (selects, no divergence);
//  - a transposed warp reduction: one butterfly reduce-scatter over the
//    group's 27 values (28 shuffles for 3 pairs, against 45 per pair in a
//    shuffle tree) leaves each lane with at most one fixed-order sum, which
//    it stores; a group no lane blended is skipped;
//  - the wrapper passes a heaviest-first tile order (block b takes tile
//    order[b]), so the longest walks start first;
//  - writes: each row as 4 coalesced float4 stores; the epilogue sums, in
//    warp order, only the partials that warps produced (a per-batch bit
//    per pair and warp).
// Deterministic: no atomics, every row written by one thread, every sum in
// a fixed order that does not depend on scheduling or on the tile order.
//
// Bound: operations. Per (pair, pixel) evaluation of the walk about 12 FP32
// operations and one expf (as K1); per blended one about 40 more and a
// division. The arithmetic of the chain uses explicit round-to-nearest
// intrinsics in the plain version's operation order (no FMA contraction), so
// the gates, the recovered T and each pixel's terms are the plain version's
// bits on the same card; only the 256-pixel sum is taken in another order.
// Built without --use_fast_math: expf, not __expf.

#include "blend_common.cuh"

namespace {

using namespace gm_blend;

constexpr int kThreads = kPix;      // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kG = 3;               // listed pairs per reduction group (2, 4 lose)
constexpr int kOut = 9;             // live columns of a gradient row
constexpr int kV = kG * kOut;       // values a warp reduces per group
constexpr int kBatch = 96;          // pairs per staged batch
constexpr int kWords = kBatch / 32; // mask words per warp and batch
static_assert(kBatch % 32 == 0 && kBatch <= kThreads, "whole words, one pair a thread");

// value counts per lane after each level of the reduce-scatter
constexpr int halve(int n) { return (n + 1) / 2; }
constexpr int kV1 = halve(kV), kV2 = halve(kV1), kV3 = halve(kV2);
constexpr int kV4 = halve(kV3), kV5 = halve(kV4);

struct Smem {
  float4 feat[2][kBatch][3];          // cols 0-3, 4-7, 8-11 of each staged row
  float part[kBatch][kWarps][kOut];   // warp partials of the current batch
  unsigned mask[kWarps][kWords];      // pairs each warp reduced this batch
  unsigned char list[kWarps][kBatch]; // each warp's pairs of the batch
  int last[kWarps];                   // each warp's largest n_contrib
};

// One level of the butterfly reduce-scatter: v[0, N) -> v[0, (N + 1) / 2),
// each kept value the sum of this lane's and lane ^ OFF's. The lower lane
// keeps the first half, the upper one the second (padded with a 0).
template <int N, int OFF>
__device__ __forceinline__ void reduce_level(float (&v)[kV], int lane) {
  constexpr int H = (N + 1) / 2;
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = (i + H < N) ? v[i + H] : 0.0f;
    v[i] = __fadd_rn(upper ? hi : lo,
                     __shfl_xor_sync(0xffffffffu, upper ? lo : hi, OFF));
  }
}

__global__ void __launch_bounds__(kThreads, 3)
tile_blend_bwd_kernel(const float* __restrict__ feat,
                      const int32_t* __restrict__ sorted_gid,
                      const int32_t* __restrict__ starts,
                      const float* __restrict__ final_t,
                      const int32_t* __restrict__ n_contrib,
                      const float* __restrict__ g_color,
                      const float* __restrict__ g_final_t,
                      const int32_t* __restrict__ order,
                      int grid_x, int width, int height,
                      float* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tile = order[blockIdx.x];
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

  float T = 1.0f, q = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int last = 0;
  if (pix_x < width && pix_y < height) {
    const size_t hw = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pix_y) * width + pix_x;
    T = final_t[p];
    last = n_contrib[p];
    gr = g_color[p];
    gg = g_color[hw + p];
    gb = g_color[2 * hw + p];
    q = __fmul_rn(g_final_t[p], T);
  }
  const int wlast = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s.last[warp] = wlast;

  // which (pair in group, column) each of this lane's final reduce-scatter
  // values holds; -1 for padding
  int slot_pair[kV5], slot_col[kV5];
#pragma unroll
  for (int i = 0; i < kV5; ++i) {
    int idx = i;
    bool ok = true;
    idx += (lane & 1) ? kV5 : 0;
    ok = ok && idx < kV4;
    idx += (lane & 2) ? kV4 : 0;
    ok = ok && idx < kV3;
    idx += (lane & 4) ? kV3 : 0;
    ok = ok && idx < kV2;
    idx += (lane & 8) ? kV2 : 0;
    ok = ok && idx < kV1;
    idx += (lane & 16) ? kV1 : 0;
    ok = ok && idx < kV;
    slot_pair[i] = ok ? idx / kOut : -1;
    slot_col[i] = idx % kOut;
  }

  const int begin = starts[tile];
  const int range = starts[tile + 1] - begin;  // clamped pairs included
  __syncthreads();
  int walk = 0;  // pairs [0, walk) can have a blended pixel
#pragma unroll
  for (int w = 0; w < kWarps; ++w) walk = max(walk, s.last[w]);

  float4* tile_rows = reinterpret_cast<float4*>(rows + static_cast<size_t>(begin) * kFeat);
  for (int k = walk * 4 + t; k < range * 4; k += kThreads) {
    tile_rows[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (walk == 0) return;

  // batch kb holds pairs [kb * kBatch, min(walk, (kb + 1) * kBatch)); thread
  // t < kBatch stages pair kb * kBatch + t
  int gid = 0;
  auto load_gid = [&](int kb) {
    const int pair = kb * kBatch + t;
    gid = (t < kBatch && pair < walk) ? sorted_gid[begin + pair] : 0;
  };
  auto issue = [&](int kb) {
    if (t < kBatch && kb * kBatch + t < walk) {
      const float4* src = reinterpret_cast<const float4*>(
          feat + static_cast<size_t>(gid) * kFeat);
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async16(&s.feat[kb & 1][t][c], src + c);
    }
    cp_async_commit();
  };
  const int top = (walk - 1) / kBatch;
  load_gid(top);
  issue(top);
  if (top > 0) load_gid(top - 1);

  for (int kb = top; kb >= 0; --kb) {
    const int base = kb * kBatch;
    const int n = min(kBatch, walk - base);
    if (kb > 0) {
      issue(kb - 1);  // its stage was last read by batch kb + 1's walk
      if (kb > 1) load_gid(kb - 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // batch kb staged; batch kb + 1's epilogue is done

    const float4(*f4)[3] = s.feat[kb & 1];
    const int hi = min(n, wlast - base);  // this warp's pairs in the batch
    if (hi > 0) {
      // the pairs [0, hi) whose gate can pass on this warp's rows, in order
      unsigned char* list = s.list[warp];
      int cnt = 0;
      for (int c = 0; c < hi; c += 32) {
        const int i = c + lane;
        const bool r = i < hi && reaches_rows(f4[i][0], f4[i][1], wy0, wy1);
        const unsigned bal = __ballot_sync(0xffffffffu, r);
        if (r) list[cnt + __popc(bal & ((1u << lane) - 1u))] = static_cast<unsigned char>(i);
        cnt += __popc(bal);
      }
      __syncwarp();

      unsigned m[kWords];  // the pairs this warp reduced
#pragma unroll
      for (int w = 0; w < kWords; ++w) m[w] = 0u;
      for (int e = cnt; e > 0; e -= kG) {
        // the group's pairs, back to front (-1 past the list's start)
        int jj[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) jj[i] = e - 1 - i >= 0 ? list[e - 1 - i] : -1;
        // evaluate them
        float dx[kG], dy[kG], ex[kG], raw[kG];
        bool gate[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const float4 a = f4[max(jj[i], 0)][0];  // x y ca cb
          const float4 b = f4[max(jj[i], 0)][1];  // cc op r g
          dx[i] = __fsub_rn(a.x, px);
          dy[i] = __fsub_rn(a.y, py);
          const float qa = __fmul_rn(__fmul_rn(a.z, dx[i]), dx[i]);
          const float qc = __fmul_rn(__fmul_rn(b.x, dy[i]), dy[i]);
          const float qb = __fmul_rn(__fmul_rn(a.w, dx[i]), dy[i]);
          const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
          ex[i] = expf(power);
          raw[i] = __fmul_rn(b.y, ex[i]);
          gate[i] = jj[i] >= 0 && base + jj[i] < last && power <= 0.0f &&
                    fminf(kAlphaMax, raw[i]) >= kAlphaMin;
        }
        // the sequential part, in walk order: every lane runs a pair some
        // lane blends (no divergence) and keeps its results where its own
        // pixel blends it
        float v[kV];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          float* c = v + i * kOut;
          const bool g = gate[i];
          if (!__any_sync(0xffffffffu, g)) {
#pragma unroll
            for (int o = 0; o < kOut; ++o) c[o] = 0.0f;
            continue;
          }
          any = true;
          const float4 a = f4[max(jj[i], 0)][0];
          const float4 b = f4[max(jj[i], 0)][1];
          const float bb = f4[max(jj[i], 0)][2].x;
          const float ca = a.z, cb = a.w, cc = b.x;
          const float ddx = dx[i], ddy = dy[i];
          const float alpha = fminf(kAlphaMax, raw[i]);
          const float om = __fsub_rn(1.0f, alpha);
          const float tn = __fdiv_rn(T, om);  // the transmittance in front
          const float w = __fmul_rn(alpha, tn);
          const float dldw = __fadd_rn(__fadd_rn(__fmul_rn(b.z, gr), __fmul_rn(b.w, gg)),
                                       __fmul_rn(bb, gb));
          const float dalpha = __fsub_rn(__fmul_rn(dldw, tn), __fdiv_rn(q, om));
          const float qn = __fadd_rn(q, __fmul_rn(dldw, w));
          const bool live = g && raw[i] <= kAlphaMax;  // the 0.99 cap is off
          const float dpower = __fmul_rn(dalpha, alpha);
          c[0] = live ? __fmul_rn(dpower, -__fadd_rn(__fmul_rn(ca, ddx), __fmul_rn(cb, ddy))) : 0.0f;
          c[1] = live ? __fmul_rn(dpower, -__fadd_rn(__fmul_rn(cc, ddy), __fmul_rn(cb, ddx))) : 0.0f;
          c[2] = live ? __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(ddx, ddx))) : 0.0f;
          c[3] = live ? __fmul_rn(dpower, -__fmul_rn(ddx, ddy)) : 0.0f;
          c[4] = live ? __fmul_rn(dpower, __fmul_rn(-0.5f, __fmul_rn(ddy, ddy))) : 0.0f;
          c[5] = live ? __fmul_rn(dalpha, ex[i]) : 0.0f;
          c[6] = g ? __fmul_rn(w, gr) : 0.0f;
          c[7] = g ? __fmul_rn(w, gg) : 0.0f;
          c[8] = g ? __fmul_rn(w, gb) : 0.0f;
          T = g ? tn : T;
          q = g ? qn : q;
        }
        if (!any) continue;  // warp-uniform
        reduce_level<kV, 16>(v, lane);
        reduce_level<kV1, 8>(v, lane);
        reduce_level<kV2, 4>(v, lane);
        reduce_level<kV3, 2>(v, lane);
        reduce_level<kV4, 1>(v, lane);
#pragma unroll
        for (int i = 0; i < kV5; ++i) {
          int j = -1;
#pragma unroll
          for (int g = 0; g < kG; ++g) j = slot_pair[i] == g ? jj[g] : j;
          if (j >= 0) s.part[j][warp][slot_col[i]] = v[i];
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            if (jj[g] >= 0 && (jj[g] >> 5) == w) m[w] |= 1u << (jj[g] & 31);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (lane == w) s.mask[warp][w] = m[w];
      }
    }
    __syncthreads();  // the batch's partials are stored

    // rows [base, base + n): each output value the sum, in warp order, of
    // the partials the warps produced
    for (int k = t; k < n * 4; k += kThreads) {
      const int jj = k >> 2;
      const int col0 = (k & 3) * 4;
      float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (col0 < kOut) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (base + jj < s.last[w] && ((s.mask[w][jj >> 5] >> (jj & 31)) & 1u)) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (col0 + c < kOut) r[c] = __fadd_rn(r[c], s.part[jj][w][col0 + c]);
            }
          }
        }
      }
      tile_rows[static_cast<size_t>(base) * 4 + k] = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
}

cudaError_t configure() {
  if (sizeof(Smem) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tile_blend_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Smem)));
}

}  // namespace

// Launches K2 on `stream` over num_tiles = grid_x * ceil(height / 16) tiles.
// Inputs: the (N + 1, 16) feature table (16-B aligned), the sorted pair
// domain (sorted_gid, starts (num_tiles + 1,)), K1's final_t and n_contrib
// (height, width; the clamped per-tile counts bound n_contrib, so the kernel
// needs only it), the cotangents g_color (3, height, width) and g_final_t
// (height, width), and `order`, a permutation of the tiles (block b takes
// tile order[b]). Output rows (starts[num_tiles], 16), every row written.
// Returns the cudaError_t of the launch.
extern "C" int gm_tile_blend_bwd(const float* feat, const int32_t* sorted_gid,
                                 const int32_t* starts,
                                 const float* final_t, const int32_t* n_contrib,
                                 const float* g_color, const float* g_final_t,
                                 const int32_t* order, int num_tiles, int grid_x,
                                 int width, int height, float* rows,
                                 void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    tile_blend_bwd_kernel<<<num_tiles, kThreads, sizeof(Smem),
                            static_cast<cudaStream_t>(stream)>>>(
        feat, sorted_gid, starts, final_t, n_contrib, g_color, g_final_t,
        order, grid_x, width, height, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of K2 on the current device: threads per block, dynamic
// shared memory per block and resident blocks per SM. Returns a cudaError_t.
extern "C" int gm_tile_blend_bwd_occupancy(int* threads, int* smem_bytes,
                                           int* blocks_per_sm) {
  *threads = kThreads;
  *smem_bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tile_blend_bwd_kernel, kThreads, sizeof(Smem)));
}
