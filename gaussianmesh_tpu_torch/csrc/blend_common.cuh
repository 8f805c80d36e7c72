// Pieces shared by K1 (tile_blend_fwd.cu) and K2 (tile_blend_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gm_blend {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kFeat = 16;  // pack_features row: x y ca cb cc op r g b real ...
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

// cp.async of 16 bytes from device memory into shared memory, its commit
// and its wait (all but the N most recent groups have landed)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether a pair can pass the blend's gate (power <= 0 and
// min(0.99, op * e^power) >= 1/255) at any pixel of rows [y0, y1]: a = its
// staged columns 0-3 (x y ca cb), b = 4-7 (cc op r g). If not, skipping it
// changes no bit of the walk, which would evaluate it and move on.
//
// With q = ca dx^2 + 2 cb dx dy + cc dy^2 (power = -q / 2) the gate needs
// q <= 2 ln(255 op), and over all dx the least q at a row is
// dy^2 (ca cc - cb^2) / ca. The test widens that bound by 5 % + 0.5 in q
// and the reach by 0.5 px, far beyond what float rounding moves the kernels'
// computed power by while the conic is well conditioned (|q - computed q| <=
// 12 u kappa q, kappa <= 2 max(ca, cc)^2 / det <= 1e4, so under 1 %). A conic
// that is not positive definite and well conditioned, or a NaN, reaches.
__device__ __forceinline__ bool reaches_rows(float4 a, float4 b, float y0,
                                             float y1) {
  const float ca = a.z, cb = a.w, cc = b.x, op = b.y;
  if (op < kAlphaMin) return false;  // alpha <= op < 1/255 at every pixel
  const float det = ca * cc - cb * cb;
  const float m = fmaxf(ca, cc);
  if (!(ca > 0.0f && cc > 0.0f && det > 2e-4f * m * m)) return true;
  const float qmax = 1.05f * 2.0f * __logf(255.0f * op) + 0.5f;
  const float reach = sqrtf(qmax * ca / det) + 0.5f;
  return !(a.y + reach < y0 || a.y - reach > y1);
}

}  // namespace gm_blend
