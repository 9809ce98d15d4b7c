// Edge-gather statistics of the train-mode EdgeConv stage, forward and
// backward.
//
// Forward: for table [B, N, C] f32 and idx [B, M, k] int32 (values in
// [0, N)), per point m and channel c over its k gathered rows r_j =
// table[b, idx[b, m, j]]:
//   mx = max_j r_j,  mn = min_j r_j,  s1 = sum_j r_j,  s2 = sum_j r_j^2
// -> four [B, M, C] f32. Sums run in slot order from slot 0, rounded as the
// reference's interpret-mode program: s1 = ((r0 + r1) + r2) ...;
// s2 = fma(r0, r0, r1 * r1), then s2 = fma(r_j, r_j, s2).
//
// Backward: given the saved mx, mn and the output gradients gmx, gmn, gs1,
// gs2 [B, M, C], the table gradient
//   gtable[n] = sum over (m, j) with idx[m, j] = n, ascending, from 0, of
//     fma(2 r, gs2[m], gs1[m]) + [j is m's first slot with r == mx[m]] gmx[m]
//                              + [j is m's first slot with r == mn[m]] gmn[m]
// (r = table[n]; the two bracketed terms are added in that order, 0 where
// the slot is not the first extremal one).
//
// Replaces: sparenet_tpu/ops/pallas/edge_train_pallas.py:edge_gather_stats
// (_fwd_kernel via _stats_fwd_impl, _bwd_kernel via _stats_bwd_impl).
//
// Bound on an H100: bytes, both ways. The forward reads the table (L2
// resident at the model's sizes: at most 12 MB a cloud) and the indices and
// writes four [B, M, C] outputs. The backward reads the table, the indices
// and six [B, M, C] inputs and writes one [B, N, C] output: 32 B a (point,
// channel) at k = 8, 0.235 ms for the four calls of a B=4 training step at
// an H100 SXM's published 3.35 TB/s (700 W; measured times in PERF.md).
//
// Design, forward: stats_slice_kernel, a channel slice of the cloud's
// table held in shared memory (slices.cuh, shared with the gather-max
// kernel: a block is (cloud, row group, slice), the slice copied in by
// cp.async, each row's k reads from shared memory); all four statistics
// accumulate in registers in slot order, and each row's W channels of the
// four outputs are written as W x 4 contiguous bytes. Where no slice fits
// (N > 13760 at k = 8), stats_fwd_kernel: a block takes 32 points of one
// cloud, threads across C with 16-byte loads where C % 4 == 0 and the rows
// are 16-byte aligned (else one channel a thread).
//
// Design, backward: the TPU kernel scatters every (m, j) contribution into a
// gradient table held in VMEM, in ascending (m, j) order because its grid
// runs in sequence. Hopper blocks run in no order and atomic adds would sum
// in an order that changes from run to run, so the scatter becomes a gather
// in three launches:
//   1. route_kernel: per (m, c), the first slot equal to mx and to mn (two
//      4-bit slot numbers in one byte, 15 where none is equal; above 15
//      slots two 16-bit slot numbers in 32 bits, 0xFFFF for none);
//   2. the inverse adjacency as lists per cloud, each in ascending flat
//      slot e = m * k + j, by one stable sort a cloud in one block, with no
//      atomics: radix_lists_kernel where a cloud has at most 24576 slots
//      and 16384 rows (M = 3000, k = 8: 24000), a least-significant-digit
//      radix sort of the keys (target, slot) in shared memory (164 KB), 4
//      bits of the target a pass; else lists_kernel, a counting sort in
//      device memory for any N, M and k (warp segments counted, scanned
//      over (target, warp), and placed in order);
//   3. accum_kernel: one warp a table row and a slice of 32 x V channels
//      (V = 4: 128 channels, 16 bytes a lane), the rows taken in the order
//      of their lists' first slots (the radix path writes that order: the
//      rows a point names first are its neighbours, whose lists share
//      points, so a block's warps read some of the same rows); the warp
//      stages up to 32 entries of its row's list in registers, issues the
//      loads of kU entries before their adds (gmx and gmn only where the
//      route code names the slot), and sums the contributions in list
//      order.
// The lists do not depend on the route codes: they run on a second stream
// of the device, forked from the caller's stream and joined back before the
// accumulation, beside the route kernel.
// The gradient reads each [B, M, C] input once for every slot that names
// its point (k times in all). The grids of both channel-sliced kernels run
// (cloud, slice) outermost and rows innermost, so the blocks in flight share
// one slice of one cloud: 3000 x 128 x 17 B = 6.5 MB of m-side data, which
// L2 holds, where the whole cloud at C = 1024 (52 MB) did not. Every step
// is deterministic, and the sum order is the reference's. The arithmetic is
// per channel, so the 16-byte and the one-channel paths give the same bits.
#include <mutex>

#include "common.cuh"
#include "slices.cuh"

namespace {

using spn::max_nan;
using spn::min_nan;
namespace sl = spn::slices;

constexpr int kRows = 32;      // points a block of the forward
constexpr int kThreads = 256;  // per block
constexpr int kStageK = 16;    // neighbour lists staged in shared memory
constexpr int kNarrowK = 15;   // slots that fit a 4-bit route code
constexpr int kWarps = 8;      // rows (route: points) a block, one a warp
constexpr int kU = 4;          // list entries whose loads are issued together
constexpr int kListWarps = 8;  // warps of the device-memory lists kernel
constexpr int kSortThreads = 1024;  // the shared-memory lists kernel: a
constexpr int kSortItems = 24;      //   radix sort of up to 24576 slots a cloud
constexpr int kDigitBits = 4;       //   by target, 4 bits a pass
constexpr int kDigits = 1 << kDigitBits;
constexpr int kSlotBits = 15;       // a key: target << 15 | flat slot
constexpr int kSortPadded = kSortThreads * (kSortItems + 1);
// rows of the radix path: its first-slot targets (2 bytes a slot) and row
// flags (a byte a row) fit the count columns' 64 KB
constexpr int kMaxSortRows = kDigits * kSortThreads * 4 - 2 * kSortThreads * kSortItems;

// V consecutive elements at p (aligned to V elements when V = 4)
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load(const unsigned* p, unsigned (&v)[V]) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load(const unsigned char* p, unsigned char (&v)[V]) {
  if constexpr (V == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}
template <int V>
__device__ __forceinline__ void store(unsigned* p, const unsigned (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}
template <int V>
__device__ __forceinline__ void store(unsigned char* p, const unsigned char (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<uchar4*>(p) = make_uchar4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// The k slot indices of the block's points: staged in shared memory up to
// kStageK slots, read from device memory above that.
__device__ __forceinline__ const int* stage_idx(int* sidx, const int* ib,
                                                int rows, int k, int tid) {
  const bool staged = k <= kStageK;
  if (staged)
    for (int e = tid; e < rows * k; e += kThreads) sidx[e] = ib[e];
  __syncthreads();
  return staged ? sidx : ib;
}

// The four statistics of a row's slots, in slot order.
struct Stats {
  float *mx, *mn, *s1, *s2;
  float4 a, i, s, q, r0;
  __device__ void first(float4 r) {
    a = i = s = r0 = r;
    q = make_float4(__fmul_rn(r.x, r.x), __fmul_rn(r.y, r.y),
                    __fmul_rn(r.z, r.z), __fmul_rn(r.w, r.w));
  }
  __device__ static float sq(float r, float acc) { return __fmaf_rn(r, r, acc); }
  __device__ void next(int j, float4 r) {
    a = make_float4(max_nan(a.x, r.x), max_nan(a.y, r.y), max_nan(a.z, r.z),
                    max_nan(a.w, r.w));
    i = make_float4(min_nan(i.x, r.x), min_nan(i.y, r.y), min_nan(i.z, r.z),
                    min_nan(i.w, r.w));
    s = make_float4(__fadd_rn(s.x, r.x), __fadd_rn(s.y, r.y),
                    __fadd_rn(s.z, r.z), __fadd_rn(s.w, r.w));
    if (j == 1)  // the reference contracts r0*r0 + r1*r1 into fma(r0, r0, r1*r1)
      q = make_float4(sq(r0.x, __fmul_rn(r.x, r.x)), sq(r0.y, __fmul_rn(r.y, r.y)),
                      sq(r0.z, __fmul_rn(r.z, r.z)), sq(r0.w, __fmul_rn(r.w, r.w)));
    else
      q = make_float4(sq(r.x, q.x), sq(r.y, q.y), sq(r.z, q.z), sq(r.w, q.w));
  }
  __device__ void store(size_t o, int valid, bool vec) {
    sl::st4(mx + o, a, valid, vec);
    sl::st4(mn + o, i, valid, vec);
    sl::st4(s1 + o, s, valid, vec);
    sl::st4(s2 + o, q, valid, vec);
  }
  __device__ void close(const sl::Shape&, const sl::Place&, float*) {}
};

template <int K>
__global__ void __launch_bounds__(sl::kThreads)
stats_slice_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   sl::Shape sh, float* __restrict__ mx, float* __restrict__ mn,
                   float* __restrict__ s1, float* __restrict__ s2) {
  extern __shared__ float4 smem4[];
  Stats e{mx, mn, s1, s2};
  sl::pass<K>(table, idx, sh, reinterpret_cast<float*>(smem4), e);
}

// The row path. threads: blockDim.x = tx across the C / V vectors,
// blockDim.y = 256 / tx
template <int V>
__global__ void __launch_bounds__(kThreads)
stats_fwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 int n, int m, int c, int k, float* __restrict__ mx,
                 float* __restrict__ mn, float* __restrict__ s1,
                 float* __restrict__ s2) {
  __shared__ int sidx[kRows * kStageK];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int rows = min(kRows, m - m0);
  const int* ix = stage_idx(sidx, idx + ((size_t)b * m + m0) * k, rows, k, tid);

  const float* tb = table + (size_t)b * n * c;
  const size_t ob = (size_t)b * m * c;
  for (int v = threadIdx.x; v < c / V; v += blockDim.x) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const int* ir = ix + r * k;
      float r0[V], a[V], i[V], s[V], q[V];
      load<V>(tb + (size_t)ir[0] * c + v * V, r0);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a[e] = i[e] = s[e] = r0[e];
        q[e] = __fmul_rn(r0[e], r0[e]);
      }
      for (int j = 1; j < k; ++j) {
        float rj[V];
        load<V>(tb + (size_t)ir[j] * c + v * V, rj);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          a[e] = max_nan(a[e], rj[e]);
          i[e] = min_nan(i[e], rj[e]);
          s[e] = __fadd_rn(s[e], rj[e]);
        }
        if (j == 1) {
          // the reference contracts r0*r0 + r1*r1 into fma(r0, r0, r1*r1)
#pragma unroll
          for (int e = 0; e < V; ++e)
            q[e] = __fmaf_rn(r0[e], r0[e], __fmul_rn(rj[e], rj[e]));
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) q[e] = __fmaf_rn(rj[e], rj[e], q[e]);
        }
      }
      const size_t o = ob + (size_t)(m0 + r) * c + v * V;
      store<V>(mx + o, a);
      store<V>(mn + o, i);
      store<V>(s1 + o, s);
      store<V>(s2 + o, q);
    }
  }
}

// Route codes: the first slot equal to mx in the low field, to mn in the
// high field; an all-ones field means none. unsigned char: 4-bit fields
// (k <= 15); unsigned: 16-bit fields.
template <typename Code>
struct Route {
  static constexpr int kBits = sizeof(Code) == 1 ? 4 : 16;
  static constexpr unsigned kNone = (1u << kBits) - 1;
  static constexpr Code kEmpty = (Code)((kNone << kBits) | kNone);
  __device__ static Code first(float r, float a, float i, int j, Code code) {
    unsigned c = code;
    if ((c & kNone) == kNone && r == a) c = (c & (kNone << kBits)) | (unsigned)j;
    if ((c >> kBits) == kNone && r == i) c = (c & kNone) | ((unsigned)j << kBits);
    return (Code)c;
  }
  __device__ static bool is_max(Code code, unsigned j) { return (code & kNone) == j; }
  __device__ static bool is_min(Code code, unsigned j) { return (unsigned)(code >> kBits) == j; }
};

// route[b, m, c]; grid (ceil(M / kWarps), slices, B), one warp a point
template <int V, typename Code>
__global__ void __launch_bounds__(kWarps * 32)
route_kernel(const float* __restrict__ table, const int* __restrict__ idx,
             const float* __restrict__ mx, const float* __restrict__ mn,
             int n, int m, int c, int k, Code* __restrict__ route) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int pm = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pm >= m) return;
  const int ch = (blockIdx.y * 32 + lane) * V;
  const bool on = ch < c;
  const int* ir = idx + ((size_t)b * m + pm) * k;
  const float* tb = table + (size_t)b * n * c + ch;
  const size_t o = ((size_t)b * m + pm) * c + ch;
  float a[V], i[V];
  Code code[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = i[e] = 0.f;
    code[e] = Route<Code>::kEmpty;
  }
  if (on) {
    load<V>(mx + o, a);
    load<V>(mn + o, i);
  }
  for (int j0 = 0; j0 < k; j0 += 8) {
    const int slot = j0 + lane < k ? ir[j0 + lane] : 0;
    float r[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = __shfl_sync(spn::kFullMask, slot, u);
      if (on && j0 + u < k) load<V>(tb + (size_t)t * c, r[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (j0 + u < k) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          code[e] = Route<Code>::first(r[u][e], a[e], i[e], j0 + u, code[e]);
      }
    }
  }
  if (on) store<V>(route + o, code);
}

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum. tmp: 32 ints of shared memory. Every thread calls it.
__device__ int block_exclusive_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(spn::kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();  // tmp may still be read by an earlier call
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? tmp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(spn::kFullMask, w, off);
      if (lane >= off) w += y;
    }
    tmp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  *total = tmp[nwarps - 1];
  return incl - v + (warp ? tmp[warp - 1] : 0);
}

// offs[b, 0..n] and list[b, offs[b, t] ...] = the flat slots e = m * k + j
// with idx[b, m, j] = t, ascending (shared-memory path: M k <= 24576 slots,
// N <= 16384): one block a cloud sorts the keys t << 15 | e by their target
// field, least significant 4 bits first, each pass stable (every thread
// holds 24 consecutive keys and places them in order after the threads
// before it, digit by digit), so the slots of a target stay ascending. A
// slot naming no row gets the key 0xffffffff and sorts after every list.
// Shared memory: the keys [1024 * 25] and one count column a thread [16][1024].
__global__ void __launch_bounds__(kSortThreads)
radix_lists_kernel(const int* __restrict__ idx, int n, int mk, int passes,
                   int* __restrict__ offs, int* __restrict__ list,
                   int* __restrict__ order) {
  extern __shared__ unsigned sbuf[];
  __shared__ int wsum[kDigits][32];
  __shared__ int dbase[kDigits];
  // keys in sorted order, one pad word after every kSortItems: a thread's
  // kSortItems consecutive keys then sit in distinct banks across a warp
  unsigned* buf = sbuf;
  int* col = reinterpret_cast<int*>(sbuf + kSortPadded) + threadIdx.x;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int* src = idx + (size_t)b * mk;
  constexpr unsigned kNone = 0xffffffffu;
  auto at = [](int p) { return p + p / kSortItems; };  // padded position
  unsigned key[kSortItems];
#pragma unroll
  for (int x = 0; x < kSortItems; ++x) {  // coalesced: slot p = tid + 1024 x
    const int p = tid + x * kSortThreads;
    key[x] = p < mk ? (unsigned)src[p] : kNone;
  }
#pragma unroll
  for (int x = 0; x < kSortItems; ++x) {
    const int p = tid + x * kSortThreads;
    buf[at(p)] = key[x] < (unsigned)n ? (key[x] << kSlotBits) | (unsigned)p : kNone;
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kSortItems; ++x) key[x] = buf[tid * (kSortItems + 1) + x];
  __syncthreads();
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = kSlotBits + pass * kDigitBits;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) col[d * kSortThreads] = 0;
#pragma unroll
    for (int x = 0; x < kSortItems; ++x)
      ++col[((key[x] >> shift) & (kDigits - 1)) * kSortThreads];
    // positions: digit-major, then thread order: per digit an exclusive
    // scan over the lanes, then the warps, after the lower digits
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      const int v = col[d * kSortThreads];
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(spn::kFullMask, incl, off);
        if (lane >= off) incl += y;
      }
      col[d * kSortThreads] = incl - v;
      if (lane == 31) wsum[d][warp] = incl;
    }
    __syncthreads();
    if (warp < kDigits) {  // warp d: the warps' totals of digit d
      int w = wsum[warp][lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(spn::kFullMask, w, off);
        if (lane >= off) w += y;
      }
      wsum[warp][lane] = w;  // inclusive over warps
      if (lane == 31) dbase[warp] = w;
    }
    __syncthreads();
    if (warp == 0) {  // the digits' totals scanned: their bases
      const int tot = lane < kDigits ? dbase[lane] : 0;
      int incl = tot;
#pragma unroll
      for (int off = 1; off < kDigits; off <<= 1) {
        const int y = __shfl_up_sync(spn::kFullMask, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane < kDigits) dbase[lane] = incl - tot;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDigits; ++d)
      col[d * kSortThreads] += dbase[d] + (warp ? wsum[d][warp - 1] : 0);
#pragma unroll
    for (int x = 0; x < kSortItems; ++x) {
      int* cur = col + ((key[x] >> shift) & (kDigits - 1)) * kSortThreads;
      const int pos = *cur;
      buf[at(pos)] = key[x];
      *cur = pos + 1;
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kSortItems; ++x) key[x] = buf[tid * (kSortItems + 1) + x];
    __syncthreads();
  }
  // the sorted keys out, coalesced: position p = tid + 1024 x
  int* ob = offs + (size_t)b * (n + 1);
  int* lb = list + (size_t)b * mk;
  const int last = kSortThreads * kSortItems - 1;
#pragma unroll
  for (int x = 0; x < kSortItems; ++x) {
    const int p = tid + x * kSortThreads;
    const unsigned kp = buf[at(p)];
    if (kp == kNone) continue;
    const int t = (int)(kp >> kSlotBits);
    lb[p] = (int)(kp & ((1u << kSlotBits) - 1));
    const int prev = p == 0 ? -1 : (int)(buf[at(p - 1)] >> kSlotBits);
    for (int u = prev + 1; u <= t; ++u) ob[u] = p;
    if (p == last || buf[at(p + 1)] == kNone)
      for (int u = t + 1; u <= n; ++u) ob[u] = p + 1;
  }
  if (buf[0] == kNone)
    for (int u = tid; u <= n; u += kSortThreads) ob[u] = 0;

  // The rows in the order the accumulation takes them: each row where its
  // list's first slot e stands, in ascending e, so that the rows that
  // slot's point names first (its neighbours) run side by side; then the
  // rows no slot names. In the count columns' space: first[e] = t + 1
  // where slot e starts target t's list (0 elsewhere), orphan[t] = 1 where
  // no slot names t.
  __syncthreads();
  unsigned short* first = reinterpret_cast<unsigned short*>(col - tid);
  unsigned char* orphan = reinterpret_cast<unsigned char*>(first + kSortThreads * kSortItems);
  for (int e = tid; e < kSortThreads * kSortItems; e += kSortThreads) first[e] = 0;
  for (int u = tid; u < n; u += kSortThreads) orphan[u] = 1;
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kSortItems; ++x) {
    const int p = tid + x * kSortThreads;
    const unsigned kp = buf[at(p)];
    if (kp != kNone && (p == 0 || (buf[at(p - 1)] >> kSlotBits) != (kp >> kSlotBits))) {
      first[kp & ((1u << kSlotBits) - 1)] = (unsigned short)((kp >> kSlotBits) + 1);
      orphan[kp >> kSlotBits] = 0;
    }
  }
  __syncthreads();
  int* ord = order + (size_t)b * n;
  int claimed = 0;
  {  // the first slots, in ascending order: kSortItems a thread
    const int lo = tid * kSortItems;
    int cnt = 0;
#pragma unroll
    for (int x = 0; x < kSortItems; ++x) cnt += first[lo + x] != 0;
    int pos = block_exclusive_scan(cnt, &wsum[0][0], &claimed);
#pragma unroll
    for (int x = 0; x < kSortItems; ++x)
      if (first[lo + x]) ord[pos++] = first[lo + x] - 1;
  }
  const int per = (n + kSortThreads - 1) / kSortThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int cnt = 0;
  for (int u = lo; u < hi; ++u) cnt += orphan[u];
  int total = 0;
  int pos = claimed + block_exclusive_scan(cnt, &wsum[0][0], &total);
  for (int u = lo; u < hi; ++u)
    if (orphan[u]) ord[pos++] = u;
}

// The same lists (device-memory path, any N, M and k): one block a cloud;
// each warp takes a contiguous segment of the slots, counts its targets,
// the counts are scanned over (target, warp), and each warp places its
// slots in order, ranking equal targets within a 32-slot step by
// __match_any_sync. Scratch: counts [kListWarps][n] and totals [n] a
// cloud, [B][kListWarps + 1][n] ints of device memory.
__global__ void __launch_bounds__(kListWarps * 32)
lists_kernel(const int* __restrict__ idx, int n, int mk, int* __restrict__ offs,
             int* __restrict__ list, int* __restrict__ scratch,
             int* __restrict__ order) {
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int t = tid; t < n; t += kListWarps * 32) order[(size_t)b * n + t] = t;
  const int lane = tid & 31, warp = tid >> 5;
  int* cnt = scratch + (size_t)b * (kListWarps + 1) * n;
  int* tot = cnt + kListWarps * n;
  const int* src = idx + (size_t)b * mk;
  for (int e = tid; e < kListWarps * n; e += kListWarps * 32) cnt[e] = 0;
  __syncthreads();
  const int seg = (mk + kListWarps - 1) / kListWarps;
  const int beg = min(mk, warp * seg), end = min(mk, beg + seg);
  int* mine = cnt + warp * n;
  // 1. each warp counts the targets of its segment
  for (int e0 = beg; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    const int v = e < end ? src[e] : -1;
    const int t = v >= 0 && v < n ? v : -1;
    const unsigned peers = __match_any_sync(spn::kFullMask, t);
    if (t >= 0 && lane == __ffs(peers) - 1) mine[t] += __popc(peers);
  }
  __syncthreads();
  // 2. per target, the warps' counts scanned in warp order; the targets'
  // totals scanned in target order (each thread a contiguous run of targets,
  // then the threads' sums across the block)
  const int per = (n + kListWarps * 32 - 1) / (kListWarps * 32);
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int run = 0;
  for (int t = lo; t < hi; ++t) {
    int s = 0;
    for (int w = 0; w < kListWarps; ++w) {
      const int x = cnt[w * n + t];
      cnt[w * n + t] = s;
      s += x;
    }
    tot[t] = s;
    run += s;
  }
  __shared__ int warp_sums[kListWarps];
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(spn::kFullMask, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int base = incl - run;
  for (int w = 0; w < warp; ++w) base += warp_sums[w];
  int* ob = offs + (size_t)b * (n + 1);
  for (int t = lo; t < hi; ++t) {
    ob[t] = base;
    for (int w = 0; w < kListWarps; ++w) cnt[w * n + t] += base;
    base += tot[t];
  }
  if (tid == kListWarps * 32 - 1) ob[n] = base;
  __syncthreads();
  // 3. each warp places its segment's slots in order
  int* lb = list + (size_t)b * mk;
  for (int e0 = beg; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    const int v = e < end ? src[e] : -1;
    const int t = v >= 0 && v < n ? v : -1;
    const unsigned peers = __match_any_sync(spn::kFullMask, t);
    int pos = 0;
    if (t >= 0) pos = mine[t] + __popc(peers & ((1u << lane) - 1));
    __syncwarp();
    if (t >= 0) {
      lb[pos] = e;
      if (lane == __ffs(peers) - 1) mine[t] += __popc(peers);
    }
    __syncwarp();
  }
}

// gtable[b, t] = ordered sum over t's list; grid (ceil(N / kWarps), slices,
// B), one warp a row and slice
template <int V, typename Code>
__global__ void __launch_bounds__(kWarps * 32)
accum_kernel(const float* __restrict__ table, const int* __restrict__ offs,
             const int* __restrict__ list, const int* __restrict__ order,
             const float* __restrict__ gmx,
             const float* __restrict__ gmn, const float* __restrict__ gs1,
             const float* __restrict__ gs2, const Code* __restrict__ route,
             int n, int m, int c, int k, float* __restrict__ gtable) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  const int t = order[(size_t)b * n + r];
  const int ch = (blockIdx.y * 32 + lane) * V;
  const bool on = ch < c;
  const size_t to = ((size_t)b * n + t) * c + ch;
  float row[V], acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) row[e] = acc[e] = 0.f;
  if (on) load<V>(table + to, row);
#pragma unroll
  for (int e = 0; e < V; ++e) row[e] = 2.f * row[e];
  const int* ob = offs + (size_t)b * (n + 1) + t;
  const int beg = ob[0], end = ob[1];
  const int* lb = list + (size_t)b * m * k;
  const size_t gb = (size_t)b * m * c + ch;
  for (int p0 = beg; p0 < end; p0 += 32) {
    const int cnt = min(32, end - p0);
    const int f = lane < cnt ? lb[p0 + lane] : 0;
    const int my_m = f / k, my_j = f - my_m * k;
    for (int e0 = 0; e0 < cnt; e0 += kU) {
      float a[kU][V], q[kU][V], x[kU][V], y[kU][V];
      Code code[kU][V];
      size_t o[kU];
      unsigned j[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) code[u][e] = Route<Code>::kEmpty;
      // the kU entries' loads, all issued before any add; gmx and gmn only
      // where a channel of the lane takes them (the first extremal slot)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        o[u] = gb + (size_t)__shfl_sync(spn::kFullMask, my_m, (e0 + u) & 31) * c;
        j[u] = (unsigned)__shfl_sync(spn::kFullMask, my_j, (e0 + u) & 31);
        if (on && e0 + u < cnt) {
          load<V>(gs1 + o[u], a[u]);
          load<V>(gs2 + o[u], q[u]);
          load<V>(route + o[u], code[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        bool want_x = false, want_y = false;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          x[u][e] = y[u][e] = 0.f;
          want_x |= Route<Code>::is_max(code[u][e], j[u]);
          want_y |= Route<Code>::is_min(code[u][e], j[u]);
        }
        if (on && e0 + u < cnt) {
          if (want_x) load<V>(gmx + o[u], x[u]);
          if (want_y) load<V>(gmn + o[u], y[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (e0 + u < cnt) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float con = __fmaf_rn(row[e], q[u][e], a[u][e]);
            con = __fadd_rn(con, Route<Code>::is_max(code[u][e], j[u]) ? x[u][e] : 0.f);
            con = __fadd_rn(con, Route<Code>::is_min(code[u][e], j[u]) ? y[u][e] : 0.f);
            acc[e] = __fadd_rn(acc[e], con);
          }
        }
      }
    }
  }
  if (on) store<V>(gtable + to, acc);
}

dim3 row_block(int cv) {
  int tx = 1;
  while (tx * 2 <= cv && tx * 2 <= kThreads) tx *= 2;
  return dim3(tx, kThreads / tx);
}

// the 16-byte path: C % 4 == 0 and every tensor 16-byte aligned
template <typename... P>
bool vector_path(int c, const P*... ptrs) {
  return c % 4 == 0 && ((reinterpret_cast<size_t>(ptrs) % 16 == 0) && ...);
}

// shared memory of the radix lists kernel (dynamic part)
constexpr size_t kSortSmem = sizeof(unsigned) * (kSortPadded + kDigits * kSortThreads);

// radix passes over the target field, 0 where the lists take the
// device-memory path
int radix_passes(int n, int mk) {
  if (mk > kSortThreads * kSortItems || n > kMaxSortRows) return 0;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      kSortSmem + 1024 > (size_t)optin)
    return 0;
  int bits = 0;  // bit length of n: every target < n sorts below 0xffff...
  while ((n >> bits) != 0) ++bits;
  return (bits + kDigitBits - 1) / kDigitBits;
}

// A second stream on each device, at the highest priority so that the
// lists kernel's blocks are placed before the route kernel's fill the card,
// and its fork and join events: the lists kernel runs there beside the
// route kernel, which does not depend on it.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
constexpr int kMaxDevices = 64;
std::mutex side_mutex;  // held while a call forks and joins

cudaError_t side_stream(SideStream** out) {
  static SideStream per_device[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  SideStream& s = per_device[dev];
  if (s.stream == nullptr) {
    SideStream made;
    int least = 0, greatest = 0;  // the lists' one block a cloud is dispatched
    if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess ||
        (err = cudaStreamCreateWithPriority(&made.stream, cudaStreamNonBlocking,
                                            greatest)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&made.fork, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&made.join, cudaEventDisableTiming)) != cudaSuccess)
      return err;
    s = made;
  }
  *out = &s;
  return cudaSuccess;
}

template <int V, typename Code>
cudaError_t route_and_accum(const float* table, const int* idx, const float* mx,
                            const float* mn, const float* gmx, const float* gmn,
                            const float* gs1, const float* gs2, int batch, int n,
                            int m, int c, int k, void* route, const int* offs,
                            const int* list, const int* order, float* gtable,
                            cudaStream_t st, bool first) {
  const int slices = (c + 32 * V - 1) / (32 * V);
  Code* rt = static_cast<Code*>(route);
  if (first) {
    route_kernel<V, Code><<<dim3((m + kWarps - 1) / kWarps, slices, batch),
                            kWarps * 32, 0, st>>>(table, idx, mx, mn, n, m, c,
                                                  k, rt);
  } else {
    accum_kernel<V, Code><<<dim3((n + kWarps - 1) / kWarps, slices, batch),
                            kWarps * 32, 0, st>>>(table, offs, list, order,
                                                  gmx, gmn, gs1, gs2, rt, n, m,
                                                  c, k, gtable);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of the route code a (point, channel) at k slots.
extern "C" int spn_edge_stats_route_bytes(int k) { return k <= kNarrowK ? 1 : 4; }

extern "C" int spn_edge_stats_fwd(const float* table, const int* idx, int batch,
                                  int n, int m, int c, int k, float* mx,
                                  float* mn, float* s1, float* s2,
                                  void* stream) {
  sl::Plan p;
  const cudaError_t err = sl::make_plan(batch, n, m, c, k, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.width > 0) {
    const sl::Shape sh = sl::shape_of(p, n, m, c, k,
                                      vector_path(c, table, mx, mn, s1, s2), idx);
    return (int)(k == 8 ? sl::launch(stats_slice_kernel<8>, p, st, table, idx,
                                     sh, mx, mn, s1, s2)
                        : sl::launch(stats_slice_kernel<0>, p, st, table, idx,
                                     sh, mx, mn, s1, s2));
  }
  const dim3 grid((m + kRows - 1) / kRows, batch);
  if (vector_path(c, table, mx, mn, s1, s2))
    stats_fwd_kernel<4><<<grid, row_block(c / 4), 0, st>>>(table, idx, n, m, c, k,
                                                          mx, mn, s1, s2);
  else
    stats_fwd_kernel<1><<<grid, row_block(c), 0, st>>>(table, idx, n, m, c, k,
                                                      mx, mn, s1, s2);
  return (int)cudaGetLastError();
}

// 1 if the inverse lists of this shape are built in shared memory, 0 if in
// device memory; *scratch_ints is the device-memory path's scratch (ints).
extern "C" int spn_edge_stats_lists(int batch, int n, int m, int k,
                                    long long* scratch_ints) {
  const bool smem = radix_passes(n, m * k) > 0;
  *scratch_ints = smem ? 0 : (long long)batch * (kListWarps + 1) * n;
  return smem ? 1 : 0;
}

// Scratch, allocated by the caller: route [B, M, C] codes of
// spn_edge_stats_route_bytes(k) bytes; offs [B, N + 1] int32; list
// [B, M * k] int32; order [B, N] int32 (the rows in the accumulation's
// order); lists_scratch, the ints spn_edge_stats_lists gives (may be null
// where it gives 0).
extern "C" int spn_edge_stats_bwd(const float* table, const int* idx,
                                  const float* mx, const float* mn,
                                  const float* gmx, const float* gmn,
                                  const float* gs1, const float* gs2, int batch,
                                  int n, int m, int c, int k,
                                  unsigned char* route, int* offs, int* list,
                                  int* order, int* lists_scratch, float* gtable,
                                  void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 1 || k < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_path(c, table, mx, mn, gmx, gmn, gs1, gs2, gtable,
                               route),
             narrow = k <= kNarrowK;
  auto stage = [&](bool first) {
    auto go = vec ? (narrow ? route_and_accum<4, unsigned char> : route_and_accum<4, unsigned>)
                  : (narrow ? route_and_accum<1, unsigned char> : route_and_accum<1, unsigned>);
    return go(table, idx, mx, mn, gmx, gmn, gs1, gs2, batch, n, m, c, k, route,
              offs, list, order, gtable, st, first);
  };
  const int mk = m * k;
  const int passes = radix_passes(n, mk);
  if (passes == 0 && lists_scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (passes)
    err = cudaFuncSetAttribute(radix_lists_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSortSmem);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStream* side = nullptr;
  if ((err = side_stream(&side)) != cudaSuccess) return (int)err;
  // fork: the lists on the side stream after everything before on st
  if ((err = cudaEventRecord(side->fork, st)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess)
    return (int)err;
  if (passes)
    radix_lists_kernel<<<batch, kSortThreads, kSortSmem, side->stream>>>(
        idx, n, mk, passes, offs, list, order);
  else
    lists_kernel<<<batch, kListWarps * 32, 0, side->stream>>>(
        idx, n, mk, offs, list, lists_scratch, order);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = cudaEventRecord(side->join, side->stream)) != cudaSuccess)
    return (int)err;
  if ((err = stage(true)) != cudaSuccess) return (int)err;
  // join: the accumulation after both the route codes and the lists
  if ((err = cudaStreamWaitEvent(st, side->join, 0)) != cudaSuccess) return (int)err;
  return (int)stage(false);
}
