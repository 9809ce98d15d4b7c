// Auction bids of the EMD: for every bidder i of x1 [B, M, 3] against the
// objects x2 [B, N, 3] with prices given as pp = 3 - price [B, N]:
//   v[j]      = pp[j] - sqrt(|x1[i] - x2[j]|^2)
//   target[i] = the lowest j among the maxima of v
//   inc[i]    = v[target] - max over every other j of v (an equal value at
//               another index counts, so a tie gives 0)
// -> target [B, M] int32, inc [B, M] f32, for the first count[b] bidders of
// each cloud (0 and 0 for the rest).
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
// Design:
// 1. The bidders to score come from device memory: count [B] (null: all M);
//    the auction keeps its list of unassigned bidders at full width, first
//    count[b] of them unassigned, and makes no host read a round. The grid
//    is sized for M; every block reads the counts and takes its part of a
//    plan made from the largest count u (plan() below, the same on the host
//    and in both kernels); blocks past the plan or past their cloud's count
//    exit at once.
// 2. The plan splits the object axis: a block takes a tile of 512 bidders
//    (128 threads, 4 bidders each) and one of S chunks of the objects, S the
//    most that keeps the grid within one resident wave of the card (at
//    least 1, chunks of at least 128 objects). Each block writes (best,
//    index, second) for its bidders; bids_merge_kernel merges the chunks in
//    ascending order: a lower chunk's (b1, i1, s1) and a higher one's (b2,
//    i2, s2) give (b2, i2, max(b1, s2)) if b2 > b1, else (b1, i1,
//    max(s1, b2)), the earlier value kept on a tie, which is the scan's
//    result over both. With S = 1 the block writes target and inc itself.
// 3. Objects are staged in shared memory as float4 (x, y, z, pp): one
//    broadcast load serves the thread's 4 bidders, whose compare chains are
//    independent.
// 4. The square root only where it can matter. The scan keeps (best,
//    index, second): a value above best demotes best to second; any other
//    value above second replaces it. A value v <= second changes neither,
//    so skipping it is exact. v = fsub_rn(pp, fsqrt_rn(d2)) <= second
//    whenever d2 >= D = fmul_ru(A, |A|), A = fsub_ru(pp, second): for
//    A > 0, sqrt(d2) >= A (D >= A^2), so fsqrt_rn(d2) >= A (rounding is
//    monotone and A is a float) >= pp - second, and fsub_rn of a value
//    <= second is <= second (second is a float); for A <= 0, D <= 0 <= d2
//    and pp <= second, so v <= pp <= second. A NaN d2 or pp fails d2 < D
//    and is skipped; it would have changed nothing either. So the kernel
//    takes the root only where d2 < D, in two passes over each sub-tile of
//    32 objects: a branch-free pass marks, for each of the thread's
//    bidders, the objects with d2 < D at the second the sub-tile starts
//    with (a 32-bit mask; second only grows, so an object unmarked then
//    stays skippable), then a second pass visits the marked objects in
//    ascending order with the root and the exact updates. Visiting objects in ascending order
//    makes best the first maximum and second the maximum over every other
//    index, for any tiling.
#include "common.cuh"

namespace {

constexpr int kT = 128;              // threads a block
constexpr int kR = 4;                // bidders a thread
constexpr int kQ = kT * kR;          // bidders a block
constexpr int kTile = 512;           // objects a shared-memory tile
constexpr int kMinChunk = 128;       // objects a chunk, at least
constexpr int kSub = 32;             // objects a candidate mask
constexpr float kNeg = -3.4e38f;

// fma(dz, dz, fma(dx, dx, dy * dy)) from bidder (qx, qy, qz) to object o
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float4 o) {
  const float dx = __fsub_rn(qx, o.x), dy = __fsub_rn(qy, o.y), dz = __fsub_rn(qz, o.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

struct Plan {
  int tiles, splits, chunk;
};

// tiles of kQ of the u bidders, and the object chunks, for a card with
// `slots` resident blocks of bids_kernel
__host__ __device__ inline Plan plan(int batch, int n, int u, int slots) {
  Plan p;
  p.tiles = (u + kQ - 1) / kQ;
  int s = p.tiles > 0 ? slots / (batch * p.tiles) : 1;
  s = s < 1 ? 1 : s;
  const int most = n / kMinChunk > 1 ? n / kMinChunk : 1;
  s = s < most ? s : most;
  p.chunk = (n + s - 1) / s;
  p.splits = (n + p.chunk - 1) / p.chunk;
  return p;
}

// the largest count over the batch (all M where count is null); every
// lane of the warp must call it
__device__ __forceinline__ int largest_count(const int* count, int batch, int m) {
  if (count == nullptr) return m;
  int u = 0;
  for (int i = threadIdx.x & 31; i < batch; i += 32) u = max(u, count[i]);
  return min(__reduce_max_sync(spn::kFullMask, u), m);
}

__global__ void __launch_bounds__(kT)
bids_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ pp, const int* __restrict__ count,
            int batch, int m, int n, int slots, int* __restrict__ target,
            float* __restrict__ inc, float* __restrict__ part_best,
            int* __restrict__ part_idx, float* __restrict__ part_second) {
  __shared__ float4 sobj[kTile];  // kTile is a multiple of kSub
  const Plan pl = plan(batch, n, largest_count(count, batch, m), slots);
  int id = blockIdx.x;
  if (id >= batch * pl.tiles * pl.splits) return;
  const int split = id % pl.splits;
  id /= pl.splits;
  const int tile = id % pl.tiles, b = id / pl.tiles;
  const int ub = count == nullptr ? m : min(count[b], m);
  const int q0 = tile * kQ;
  if (q0 >= ub) return;
  const int tid = threadIdx.x;

  float qx[kR], qy[kR], qz[kR], best[kR], second[kR];
  int bi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = q0 + r * kT + tid;
    const float* p = x1 + ((size_t)b * m + min(q, ub - 1)) * 3;
    qx[r] = p[0];
    qy[r] = p[1];
    qz[r] = p[2];
    best[r] = second[r] = kNeg;
    bi[r] = 0;
  }
  const float* ob = x2 + (size_t)b * n * 3;
  const float* pb = pp + (size_t)b * n;
  const int o0 = split * pl.chunk, o1 = min(n, o0 + pl.chunk);
  for (int t0 = o0; t0 < o1; t0 += kTile) {
    const int cnt = min(kTile, o1 - t0);
    const int padded = (cnt + kSub - 1) / kSub * kSub;
    __syncthreads();
    for (int e = tid; e < padded; e += kT) {
      // past the chunk: pp = -inf, never a candidate
      const float* o = ob + (size_t)(t0 + e) * 3;
      sobj[e] = e < cnt ? make_float4(o[0], o[1], o[2], pb[t0 + e])
                        : make_float4(0.f, 0.f, 0.f, -__int_as_float(0x7f800000));
    }
    __syncthreads();
    for (int s0 = 0; s0 < padded; s0 += kSub) {
      // 1. candidates of the sub-tile against each bidder's second at its
      //    start (second only grows, so the others stay below it): no branch
      unsigned cand[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) cand[r] = 0u;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4 o = sobj[s0 + jj];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float a = __fsub_ru(o.w, second[r]);
          if (sqdist(qx[r], qy[r], qz[r], o) < __fmul_ru(a, fabsf(a)))
            cand[r] |= 1u << jj;
        }
      }
      // 2. the candidates in ascending order, exactly
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        for (unsigned m = cand[r]; m; m &= m - 1) {
          const int jj = __ffs(m) - 1;
          const float4 o = sobj[s0 + jj];
          const float v = __fsub_rn(o.w, __fsqrt_rn(sqdist(qx[r], qy[r], qz[r], o)));
          if (v > best[r]) {
            second[r] = best[r];
            best[r] = v;
            bi[r] = t0 + s0 + jj;
          } else if (v > second[r]) {
            second[r] = v;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q = q0 + r * kT + tid;
    if (q >= ub) continue;
    if (pl.splits == 1) {
      target[(size_t)b * m + q] = bi[r];
      inc[(size_t)b * m + q] = __fsub_rn(best[r], second[r]);
    } else {
      const size_t o = (size_t)blockIdx.x * kQ + r * kT + tid;
      part_best[o] = best[r];
      part_idx[o] = bi[r];
      part_second[o] = second[r];
    }
  }
}

// One thread a bidder: merges its chunks in ascending order (or, with one
// chunk, leaves the block's output); bidders past their cloud's count get
// target 0 and inc 0.
__global__ void __launch_bounds__(256)
bids_merge_kernel(const int* __restrict__ count, int batch, int m, int n,
                  int slots, const float* __restrict__ part_best,
                  const int* __restrict__ part_idx,
                  const float* __restrict__ part_second, int* __restrict__ target,
                  float* __restrict__ inc) {
  const Plan pl = plan(batch, n, largest_count(count, batch, m), slots);
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const size_t o = (size_t)b * m + q;
  if (q >= (count == nullptr ? m : min(count[b], m))) {
    target[o] = 0;
    inc[o] = 0.f;
    return;
  }
  if (pl.splits == 1) return;
  const size_t base = (size_t)(b * pl.tiles + q / kQ) * pl.splits * kQ + q % kQ;
  float best = part_best[base], second = part_second[base];
  int bi = part_idx[base];
  for (int s = 1; s < pl.splits; ++s) {
    const size_t e = base + (size_t)s * kQ;
    const float b2 = part_best[e], s2 = part_second[e];
    if (b2 > best) {
      second = s2 > best ? s2 : best;
      best = b2;
      bi = part_idx[e];
    } else {
      second = b2 > second ? b2 : second;
    }
  }
  target[o] = bi;
  inc[o] = __fsub_rn(best, second);
}

// resident blocks of bids_kernel on the current card
int slots() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bids_kernel, kT, 0);
  const int v = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = v;
  return v;
}

int grid_blocks(int batch, int m) {
  const int full = batch * ((m + kQ - 1) / kQ);
  return full > slots() ? full : slots();
}

}  // namespace

// Partial-result entries (best, index, second) of scratch a call needs.
extern "C" long long spn_emd_bids_scratch(int batch, int m) {
  return (long long)grid_blocks(batch, m) * kQ;
}

// The plan at u bidders: out[0..3] = tiles, splits, objects a chunk, blocks
// that work (the grid launched is spn_emd_bids_scratch / 512 blocks).
extern "C" void spn_emd_bids_plan(int batch, int m, int n, int u, int* out) {
  const Plan p = plan(batch, n, u < m ? u : m, slots());
  out[0] = p.tiles;
  out[1] = p.splits;
  out[2] = p.chunk;
  out[3] = batch * p.tiles * p.splits;
}

// count: [B] int32 on the card, the bidders of each cloud to score (the
// first count[b] rows of x1; the others get target 0 and inc 0), or null
// for all M. part_*: scratch of spn_emd_bids_scratch entries each.
extern "C" int spn_emd_bids(const float* x1, const float* x2, const float* pp,
                            const int* count, int batch, int m, int n,
                            float* part_best, int* part_idx,
                            float* part_second, int* target, float* inc,
                            void* stream) {
  if (batch < 1 || m < 1 || n < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = slots();
  bids_kernel<<<grid_blocks(batch, m), kT, 0, st>>>(
      x1, x2, pp, count, batch, m, n, s, target, inc, part_best, part_idx,
      part_second);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bids_merge_kernel<<<dim3((m + 255) / 256, batch), 256, 0, st>>>(
      count, batch, m, n, s, part_best, part_idx, part_second, target, inc);
  return (int)cudaGetLastError();
}
