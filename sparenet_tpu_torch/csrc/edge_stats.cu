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
// and six [B, M, C] inputs and writes one [B, N, C] output.
//
// Design, forward: as the gather-max kernel, a block takes 32 points of one
// cloud; threads run across C with 16-byte loads (where C % 4 == 0 and the
// rows are 16-byte aligned; else one channel a thread), so a gathered row
// is read by neighbouring threads at neighbouring addresses; all four
// statistics accumulate in registers in slot order.
//
// Design, backward: the TPU kernel scatters every (m, j) contribution into a
// gradient table held in VMEM, in ascending (m, j) order because its grid
// runs in sequence. Hopper blocks run in no order and atomic adds would sum
// in an order that changes from run to run, so the scatter becomes a gather:
//   1. route: per (m, c), the first slot equal to mx and to mn (two 4-bit
//      slot numbers in one byte, 15 where none is equal; above 15 slots two
//      16-bit slot numbers in 32 bits, 0xFFFF for none);
//   2. the inverse adjacency as CSR lists per cloud: count the in-degree of
//      each n, scan it, fill each list, then sort each (short) list so it
//      holds the flat slots m * k + j in ascending order;
//   3. accumulate: one block per range of rows n, threads across C; each n
//      walks its list in order and sums the contributions in registers.
// Every step is deterministic, and the sum order is the reference's. The
// arithmetic is per channel, so the 16-byte and the one-channel paths give
// the same bits.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // points (forward, route) or rows (backward)
constexpr int kThreads = 256;  // per block
constexpr int kStageK = 16;    // neighbour lists staged in shared memory
constexpr int kNarrowK = 15;   // slots that fit a 4-bit route code
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating, as jnp.maximum and torch.amax
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

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

// threads: blockDim.x = tx across the C / V vectors, blockDim.y = 256 / tx
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

// route[b, m, c]
template <int V, typename Code>
__global__ void __launch_bounds__(kThreads)
route_kernel(const float* __restrict__ table, const int* __restrict__ idx,
             const float* __restrict__ mx, const float* __restrict__ mn,
             int n, int m, int c, int k, Code* __restrict__ route) {
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
      const size_t o = ob + (size_t)(m0 + r) * c + v * V;
      float a[V], i[V];
      load<V>(mx + o, a);
      load<V>(mn + o, i);
      Code code[V];
#pragma unroll
      for (int e = 0; e < V; ++e) code[e] = Route<Code>::kEmpty;
      for (int j = 0; j < k; ++j) {
        float rj[V];
        load<V>(tb + (size_t)ix[r * k + j] * c + v * V, rj);
#pragma unroll
        for (int e = 0; e < V; ++e)
          code[e] = Route<Code>::first(rj[e], a[e], i[e], j, code[e]);
      }
      store<V>(route + o, code);
    }
  }
}

// in-degree of every table row, one thread per (b, m, j)
__global__ void count_kernel(const int* __restrict__ idx, int n, int mk,
                             int total, int* __restrict__ cnt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int t = idx[e];
  if (t >= 0 && t < n) atomicAdd(cnt + (size_t)(e / mk) * n + t, 1);
}

// offs[b, 0..n]: exclusive prefix sum of cnt[b, :], one block per cloud
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ cnt, int n, int* __restrict__ offs) {
  __shared__ int part[kScanThreads];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int* c = cnt + (size_t)b * n;
  int* o = offs + (size_t)b * (n + 1);
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += c[i];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += add;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int i = lo; i < hi; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (tid == kScanThreads - 1) o[n] = part[tid];
}

// list[b, offs[b, t] + ...] = flat slot e = m * k + j of every idx[b, m, j] = t
__global__ void fill_kernel(const int* __restrict__ idx, int n, int mk,
                            int total, const int* __restrict__ offs,
                            int* __restrict__ cursor, int* __restrict__ list) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int t = idx[e];
  if (t < 0 || t >= n) return;
  const int b = e / mk;
  const int pos = atomicAdd(cursor + (size_t)b * n + t, 1);
  list[(size_t)b * mk + offs[(size_t)b * (n + 1) + t] + pos] = e - b * mk;
}

// each list in ascending order (insertion sort; lists hold about k entries)
__global__ void sort_kernel(const int* __restrict__ offs, int n, int mk,
                            int batch, int* __restrict__ list) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= batch * n) return;
  const int b = g / n, t = g - b * n;
  const int* o = offs + (size_t)b * (n + 1) + t;
  int* l = list + (size_t)b * mk;
  for (int p = o[0] + 1; p < o[1]; ++p) {
    const int key = l[p];
    int q = p - 1;
    while (q >= o[0] && l[q] > key) {
      l[q + 1] = l[q];
      --q;
    }
    l[q + 1] = key;
  }
}

// gtable[b, t] = ordered sum over t's list; threads as in the forward
template <int V, typename Code>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float* __restrict__ table, const int* __restrict__ offs,
             const int* __restrict__ list, const float* __restrict__ gmx,
             const float* __restrict__ gmn, const float* __restrict__ gs1,
             const float* __restrict__ gs2, const Code* __restrict__ route,
             int n, int m, int c, int k, float* __restrict__ gtable) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - t0);
  const int* ob = offs + (size_t)b * (n + 1);
  const int* lb = list + (size_t)b * m * k;
  const size_t gb = (size_t)b * m * c;
  for (int v = threadIdx.x; v < c / V; v += blockDim.x) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const int t = t0 + r;
      const size_t to = ((size_t)b * n + t) * c + v * V;
      float row[V], acc[V];
      load<V>(table + to, row);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        row[e] = 2.f * row[e];
        acc[e] = 0.f;
      }
      for (int p = ob[t]; p < ob[t + 1]; ++p) {
        const int f = lb[p];
        const int mm = f / k;
        const unsigned j = (unsigned)(f - mm * k);
        const size_t o = gb + (size_t)mm * c + v * V;
        float a[V], q[V], x[V], y[V];
        Code code[V];
        load<V>(gs1 + o, a);
        load<V>(gs2 + o, q);
        load<V>(gmx + o, x);
        load<V>(gmn + o, y);
        load<V>(route + o, code);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float con = __fmaf_rn(row[e], q[e], a[e]);
          con = __fadd_rn(con, Route<Code>::is_max(code[e], j) ? x[e] : 0.f);
          con = __fadd_rn(con, Route<Code>::is_min(code[e], j) ? y[e] : 0.f);
          acc[e] = __fadd_rn(acc[e], con);
        }
      }
      store<V>(gtable + to, acc);
    }
  }
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

template <int V, typename Code>
cudaError_t route_and_accum(const float* table, const int* idx, const float* mx,
                            const float* mn, const float* gmx, const float* gmn,
                            const float* gs1, const float* gs2, int batch, int n,
                            int m, int c, int k, void* route, const int* offs,
                            const int* list, float* gtable, cudaStream_t st,
                            bool first) {
  const dim3 block = row_block(c / V);
  Code* rt = static_cast<Code*>(route);
  if (first) {
    route_kernel<V, Code><<<dim3((m + kRows - 1) / kRows, batch), block, 0, st>>>(
        table, idx, mx, mn, n, m, c, k, rt);
  } else {
    accum_kernel<V, Code><<<dim3((n + kRows - 1) / kRows, batch), block, 0, st>>>(
        table, offs, list, gmx, gmn, gs1, gs2, rt, n, m, c, k, gtable);
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
  if (batch < 1 || n < 1 || m < 1 || c < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kRows - 1) / kRows, batch);
  if (vector_path(c, table, mx, mn, s1, s2))
    stats_fwd_kernel<4><<<grid, row_block(c / 4), 0, st>>>(table, idx, n, m, c, k,
                                                          mx, mn, s1, s2);
  else
    stats_fwd_kernel<1><<<grid, row_block(c), 0, st>>>(table, idx, n, m, c, k,
                                                      mx, mn, s1, s2);
  return (int)cudaGetLastError();
}

// Scratch, allocated by the caller: route [B, M, C] codes of
// spn_edge_stats_route_bytes(k) bytes; cnt and cursor [B, N] int32 (zeroed
// here); offs [B, N + 1] int32; list [B, M * k] int32.
extern "C" int spn_edge_stats_bwd(const float* table, const int* idx,
                                  const float* mx, const float* mn,
                                  const float* gmx, const float* gmn,
                                  const float* gs1, const float* gs2, int batch,
                                  int n, int m, int c, int k,
                                  unsigned char* route, int* cnt, int* cursor,
                                  int* offs, int* list, float* gtable,
                                  void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_path(c, table, mx, mn, gmx, gmn, gs1, gs2, gtable,
                               route),
             narrow = k <= kNarrowK;
  auto stage = [&](bool first) {
    auto go = vec ? (narrow ? route_and_accum<4, unsigned char> : route_and_accum<4, unsigned>)
                  : (narrow ? route_and_accum<1, unsigned char> : route_and_accum<1, unsigned>);
    return go(table, idx, mx, mn, gmx, gmn, gs1, gs2, batch, n, m, c, k, route,
              offs, list, gtable, st, first);
  };
  cudaError_t err = stage(true);
  if (err != cudaSuccess) return (int)err;

  const int mk = m * k, total = batch * mk;
  err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)batch * n, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(cursor, 0, sizeof(int) * (size_t)batch * n, st);
  if (err != cudaSuccess) return (int)err;
  count_kernel<<<(total + 255) / 256, 256, 0, st>>>(idx, n, mk, total, cnt);
  scan_kernel<<<batch, kScanThreads, 0, st>>>(cnt, n, offs);
  fill_kernel<<<(total + 255) / 256, 256, 0, st>>>(idx, n, mk, total, offs,
                                                   cursor, list);
  sort_kernel<<<(batch * n + 255) / 256, 256, 0, st>>>(offs, n, mk, batch, list);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)stage(false);
}
