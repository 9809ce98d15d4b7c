// Auction bids of the EMD: for every bidder i of x1 [B, M, 3] against the
// objects x2 [B, N, 3] with prices given as pp = 3 - price [B, N]:
//   v[j]      = pp[j] - sqrt(|x1[i] - x2[j]|^2)
//   target[i] = the lowest j among the maxima of v
//   inc[i]    = v[target] - max over every other j of v (an equal value at
//               another index counts, so a tie gives 0)
// -> target [B, M] int32, inc [B, M] f32.
//
// Replaces: sparenet_tpu/ops/pallas/emd_pallas.py:emd_bids_pallas (the bid
// step of sparenet_tpu/ops/emd.py:_emd_batched on the TPU).
//
// Rounding: d2 = fma(dz, dz, fma(dx, dx, dy * dy)) as the reference's
// interpret-mode program rounds dx*dx + dy*dy + dz*dz, the IEEE square root
// (__fsqrt_rn; the library is built without -use_fast_math), and 3 - price
// formed in f32 by the caller, as the TPU kernel's caller does.
//
// Bound on an H100: operations. Each (bidder, object) pair costs three
// subtractions, three multiply(-add)s, a correctly rounded square root (a
// reciprocal square root and a few fused corrections), a subtraction and two
// compares: B*M*N pairs a round against (M + N)*12 + N*4 bytes read.
//
// Design: as the chamfer kernel, one thread per bidder and objects staged
// through shared memory in ascending tiles. The scan keeps (best, index,
// second): a value above best demotes best to second; any other value above
// second replaces it. Visiting objects in ascending order makes the result
// the reference's for any tiling: best is the first maximum, and second the
// maximum over every other index.
#include "common.cuh"

namespace {

constexpr int kQ = 256;      // bidders per block, one per thread
constexpr int kTile = 2048;  // objects per shared-memory tile
constexpr float kNeg = -3.4e38f;

__global__ void __launch_bounds__(kQ)
bids_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ pp, int m, int n, int* __restrict__ target,
            float* __restrict__ inc) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sp[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kQ + threadIdx.x;
  const bool active = q < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* p = x1 + ((size_t)b * m + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  const float* ob = x2 + (size_t)b * n * 3;
  const float* pb = pp + (size_t)b * n;
  float best = kNeg, second = kNeg;
  int bi = 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * 3; e += kQ) {
      const float v = ob[(size_t)t0 * 3 + e];
      const int r = e / 3, c = e - r * 3;
      (c == 0 ? sx : c == 1 ? sy : sz)[r] = v;
    }
    for (int e = threadIdx.x; e < cnt; e += kQ) sp[e] = pb[t0 + e];
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
      const float v = __fsub_rn(sp[j], __fsqrt_rn(d2));
      if (v > best) {
        second = best;
        best = v;
        bi = t0 + j;
      } else if (v > second) {
        second = v;
      }
    }
  }
  if (active) {
    target[(size_t)b * m + q] = bi;
    inc[(size_t)b * m + q] = __fsub_rn(best, second);
  }
}

}  // namespace

extern "C" int spn_emd_bids(const float* x1, const float* x2, const float* pp,
                            int batch, int m, int n, int* target, float* inc,
                            void* stream) {
  if (batch < 1 || m < 1 || n < 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kQ - 1) / kQ, batch);
  bids_kernel<<<grid, kQ, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, pp, m, n, target, inc);
  return (int)cudaGetLastError();
}
