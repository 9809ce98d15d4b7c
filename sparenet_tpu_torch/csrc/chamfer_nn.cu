// Chamfer nearest neighbour: idx[b, i] = argmin_j |x1[b, i] - x2[b, j]|^2 for
// x1 [B, N1, 3] and x2 [B, N2, 3] f32 -> idx [B, N1] int32, lowest index on
// ties; a NaN distance counts as +inf (never picked), and a query whose
// distances are all +inf or NaN gets index 0.
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
// subtractions, a multiply, two fmas and a compare, B*N1*N2 pairs in all,
// against (N1 + N2)*12 bytes read per cloud; no distance is written. At the
// training step's shapes (2 x 4 x 16384^2 pairs a B=4 step) the six
// arithmetic instructions of the distance and half a one of the selection
// make 6.5 issue slots a pair: about 0.42 ms a step at 1.98 GHz, against the
// 0.26 ms of the fp32 operation bound (an H100 SXM at 700 W, its published
// clock and peak; the measured times are in PERF.md).
//
// Design (nn_split_kernel, then nn_merge_kernel):
//   - each thread holds kQ queries in registers; a block's candidates stream
//     through shared memory as 16-byte records (x, y, z, pad), one broadcast
//     128-bit load serving kQ pairs;
//   - selection is half an instruction a pair: over a chunk of kChunk
//     candidates each query keeps the chunk's minimum, one 3-way unsigned
//     minimum of the distances' bits (Hopper's DPX VIMNMX3) for every two
//     candidates, and only where it is strictly below the best so far does
//     the query take the chunk's number. Distances are never -0, so for
//     them the bits order as the values, and a NaN (either sign) sorts above
//     +inf, never below the best, as `d < best` skips it: the first chunk
//     holding the minimum is the strict-< scan's; pad records are NaN;
//   - the candidate range is split in chunk-aligned ranges over `splits`
//     blocks of the same query tile, chosen so the launch fills the card;
//     each writes its (minimum, chunk) pair;
//   - the merge takes the pairs in split order with strict <, so the first
//     chunk holding the global minimum wins, and scans that chunk alone
//     (kChunk candidates, from L2, one a lane of a warp) for the first index
//     at that distance.
// The picks are those of one strict-< scan in ascending order.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // per block
constexpr int kQ = 8;          // queries per thread
constexpr int kChunk = 32;     // candidates a selection chunk
constexpr int kTile = 2048;    // candidates in shared memory at a time
constexpr int kMaxSplits = 8;
constexpr int kMergeThreads = 256;
constexpr int kBlocksPerSm = 4;  // split until the launch has this many a SM

__device__ __forceinline__ float nn_dist(float qx, float qy, float qz, float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// grid (query tiles of kThreads * kQ, splits, B)
__global__ void __launch_bounds__(kThreads)
nn_split_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                int n1, int n2, int chunks_per_split, float* __restrict__ part_min,
                int* __restrict__ part_chunk) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.z, s = blockIdx.y;
  const int q0 = blockIdx.x * kThreads * kQ + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int chunk[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = min(q0 + i * kThreads, n1 - 1);
    const float* p = x1 + ((size_t)b * n1 + q) * 3;
    qx[i] = p[0];
    qy[i] = p[1];
    qz[i] = p[2];
    best[i] = __int_as_float(0x7f800000);  // +inf
    chunk[i] = -1;
  }
  const float* cb = x2 + (size_t)b * n2 * 3;
  const int j_beg = s * chunks_per_split * kChunk;
  const int j_end = min(n2, j_beg + chunks_per_split * kChunk);
  const float nan = __int_as_float(0x7fc00000);
  for (int t0 = j_beg; t0 < j_end; t0 += kTile) {
    const int cnt = min(kTile, j_end - t0);
    const int padded = (cnt + kChunk - 1) / kChunk * kChunk;
    __syncthreads();
    for (int e = threadIdx.x; e < padded; e += kThreads) {
      float4 r = make_float4(nan, nan, nan, 0.f);
      if (e < cnt) {
        const float* p = cb + (size_t)(t0 + e) * 3;
        r.x = p[0];
        r.y = p[1];
        r.z = p[2];
      }
      tile[e] = r;
    }
    __syncthreads();
    for (int c = 0; c < padded; c += kChunk) {
      float m[kQ];
      // the distances' float bits as unsigned: for distances >= +0 (never
      // -0) their order, and NaN (either sign) above +inf; one 3-way
      // minimum (Hopper's DPX VIMNMX3) takes two candidates
      unsigned um[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) um[i] = 0x7f800000u;
#pragma unroll
      for (int j = 0; j < kChunk; j += 2) {
        const float4 r = tile[c + j];
        const float4 r2 = tile[c + j + 1];
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          um[i] = __vimin3_u32(um[i], __float_as_uint(nn_dist(qx[i], qy[i], qz[i], r)),
                               __float_as_uint(nn_dist(qx[i], qy[i], qz[i], r2)));
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i) m[i] = __uint_as_float(um[i]);
      const int id = (t0 + c) / kChunk;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (m[i] < best[i]) {
          best[i] = m[i];
          chunk[i] = id;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = q0 + i * kThreads;
    if (q < n1) {
      const size_t o = ((size_t)s * gridDim.z + b) * n1 + q;
      part_min[o] = best[i];
      part_chunk[o] = chunk[i];
    }
  }
}

// one warp 32 queries: each lane merges its query's splits in order
// (strict <); then, query by query, the 32 lanes read the winning chunk's 32
// candidates side by side (coalesced) and the first lane whose distance
// equals the minimum names the index
__global__ void __launch_bounds__(kMergeThreads)
nn_merge_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                int batch, int n1, int n2, int splits,
                const float* __restrict__ part_min,
                const int* __restrict__ part_chunk, int* __restrict__ out) {
  static_assert(kChunk == 32, "a chunk is one candidate a lane");
  const size_t queries = (size_t)batch * n1;
  const size_t g0 = ((size_t)blockIdx.x * kMergeThreads + threadIdx.x) & ~(size_t)31;
  if (g0 >= queries) return;
  const int lane = threadIdx.x & 31;
  const size_t g = min(g0 + lane, queries - 1);
  float best = __int_as_float(0x7f800000);
  int chunk = -1;
  for (int s = 0; s < splits; ++s) {
    const float v = part_min[s * queries + g];
    if (v < best) {
      best = v;
      chunk = part_chunk[s * queries + g];
    }
  }
  const float* p = x1 + g * 3;
  const float qx = p[0], qy = p[1], qz = p[2];
  int mine = 0;
#pragma unroll 4
  for (int u = 0; u < 32; ++u) {
    const int cu = __shfl_sync(spn::kFullMask, chunk, u);
    const float bu = __shfl_sync(spn::kFullMask, best, u);
    const float ux = __shfl_sync(spn::kFullMask, qx, u);
    const float uy = __shfl_sync(spn::kFullMask, qy, u);
    const float uz = __shfl_sync(spn::kFullMask, qz, u);
    const size_t gu = min(g0 + u, queries - 1);
    const int j = cu * kChunk + lane;
    bool hit = false;
    if (cu >= 0 && j < n2) {
      const float* c = x2 + ((gu / n1) * n2 + j) * 3;
      hit = nn_dist(ux, uy, uz, make_float4(c[0], c[1], c[2], 0.f)) == bu;
    }
    const unsigned mask = __ballot_sync(spn::kFullMask, hit);
    if (lane == u && cu >= 0) mine = cu * kChunk + __ffs(mask) - 1;
  }
  if (g0 + lane < queries) out[g0 + lane] = mine;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// Blocks over the candidate range of one query tile: doubled from 1 while
// the launch has fewer than kBlocksPerSm blocks an SM, at most kMaxSplits
// and one chunk a split; the wrapper sizes the split scratch with it.
extern "C" int spn_nn_idx_splits(int batch, int n1, int n2) {
  if (batch < 1 || n1 < 1 || n2 < 1) return 1;
  const long long tiles =
      (long long)batch * ((n1 + kThreads * kQ - 1) / (kThreads * kQ));
  const int chunks = (n2 + kChunk - 1) / kChunk;
  const long long want = (long long)kBlocksPerSm * sm_count();
  int splits = 1;
  while (splits < kMaxSplits && splits * 2 <= chunks && tiles * splits < want)
    splits *= 2;
  const int per = (chunks + splits - 1) / splits;
  return (chunks + per - 1) / per;
}

// part_min, part_chunk: scratch of splits x B x N1; any splits >= 1 gives the
// same picks (spn_nn_idx_splits is the launch's choice).
extern "C" int spn_nn_idx(const float* x1, const float* x2, int batch, int n1,
                          int n2, int splits, float* part_min, int* part_chunk,
                          int* out, void* stream) {
  if (batch < 1 || n1 < 1 || n2 < 1 || splits < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (n2 + kChunk - 1) / kChunk;
  const int per = (chunks + splits - 1) / splits;  // a split past the end is empty
  const dim3 grid((n1 + kThreads * kQ - 1) / (kThreads * kQ), splits, batch);
  nn_split_kernel<<<grid, kThreads, 0, st>>>(x1, x2, n1, n2, per, part_min,
                                             part_chunk);
  const size_t queries = (size_t)batch * n1;
  nn_merge_kernel<<<(unsigned)((queries + kMergeThreads - 1) / kMergeThreads),
                    kMergeThreads, 0, st>>>(x1, x2, batch, n1, n2, splits,
                                            part_min, part_chunk, out);
  return (int)cudaGetLastError();
}
