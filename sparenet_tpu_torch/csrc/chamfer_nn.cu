// Chamfer nearest neighbour: idx[b, i] = argmin_j |x1[b, i] - x2[b, j]|^2 for
// x1 [B, N1, 3] and x2 [B, N2, 3] f32 -> idx [B, N1] int32, lowest index on
// ties.
//
// Replaces: sparenet_tpu/ops/pallas/chamfer_pallas.py:nn_idx_pallas (used by
// sparenet_tpu/ops/chamfer.py:_nn_batched on the TPU, for the consistency
// Chamfer term of the training loss).
//
// Distance: from coordinate differences, as the TPU kernel computes it,
// rounded as the reference's interpret-mode program rounds
// dx*dx + dy*dy + dz*dz:  fma(dz, dz, fma(dx, dx, dy * dy)).
//
// Bound on an H100: operations. Each (query, candidate) pair costs three
// subtractions, three multiply(-add)s, a compare and a select, B*N1*N2 pairs
// in all, against (N1 + N2)*12 bytes read per cloud; no distance is written.
//
// Design: one thread per query, 256 queries per block (B=24, N1=16384 gives
// 1536 blocks). Candidates stream through shared memory in tiles of 2048 as
// three coordinate arrays, read by every thread of the block at the same
// address (a broadcast). Each thread keeps its running (min, index); tiles
// and candidates within a tile are visited in ascending order and a strict
// < keeps the earlier index, so the lowest index among equal minima wins.
#include "common.cuh"

namespace {

constexpr int kQ = 256;      // queries per block, one per thread
constexpr int kTile = 2048;  // candidates per shared-memory tile
constexpr float kBig = 3.4e38f;

__global__ void __launch_bounds__(kQ)
nn_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n1,
          int n2, int* __restrict__ out) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kQ + threadIdx.x;
  const bool active = q < n1;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* p = x1 + ((size_t)b * n1 + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  const float* cb = x2 + (size_t)b * n2 * 3;
  float best = kBig;
  int bi = 0;
  for (int t0 = 0; t0 < n2; t0 += kTile) {
    const int cnt = min(kTile, n2 - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * 3; e += kQ) {
      const float v = cb[(size_t)t0 * 3 + e];
      const int r = e / 3, c = e - r * 3;
      (c == 0 ? sx : c == 1 ? sy : sz)[r] = v;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
      if (d2 < best) {
        best = d2;
        bi = t0 + j;
      }
    }
  }
  if (active) out[(size_t)b * n1 + q] = bi;
}

}  // namespace

extern "C" int spn_nn_idx(const float* x1, const float* x2, int batch, int n1,
                          int n2, int* out, void* stream) {
  if (batch < 1 || n1 < 1 || n2 < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n1 + kQ - 1) / kQ, batch);
  nn_kernel<<<grid, kQ, 0, static_cast<cudaStream_t>(stream)>>>(x1, x2, n1, n2,
                                                                 out);
  return (int)cudaGetLastError();
}
