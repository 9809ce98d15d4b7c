// Shared device helpers for the port's kernels.
//
// Tie-breaking contract (counterpart of sparenet_tpu/ops/pallas/reduce.py
// argmin_lanes / argmax_lanes): every argmin in these kernels compares
// (value, index) pairs lexicographically, so among equal values the lowest
// index wins. A GPU reduction gives no such guarantee by itself, so the
// comparison is written out here and used everywhere.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spn {

constexpr unsigned kFullMask = 0xffffffffu;

// (va, ia) < (vb, ib) in lexicographic order: lowest index wins a tie.
__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Warp-wide lexicographic argmin; every lane ends with the winner.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// As warp_argmin, carrying one float payload of the winner along.
__device__ __forceinline__ void warp_argmin_payload(float& v, int& i, float& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    const float op = __shfl_xor_sync(kFullMask, p, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
      p = op;
    }
  }
}

// NaN-propagating max and min, as torch.amax / jnp.maximum (and min): a
// NaN in either argument wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// x rounded to bfloat16 (round to nearest even) and widened back to float:
// one term of the 3-term bf16 split used by the kNN graph distance.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Squared distance summed x, y, z as one fused multiply-add chain:
// fma(dz, dz, fma(dy, dy, dx * dx)). This is the order and rounding the
// reference's XLA CPU program computes for sum((p - q) ** 2, axis=-1).
__device__ __forceinline__ float sqdist3(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Asynchronous copies into shared memory (cp.async): 16 bytes through L2
// only (both addresses 16-byte aligned), or 4 bytes through L1 (`.cg`
// takes only 16). A group is committed, then waited for until at most N
// newer groups are pending; a __syncthreads() after the wait makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace spn
