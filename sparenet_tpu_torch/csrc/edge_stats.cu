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
// cloud; threads run across C with 16-byte loads, so a gathered row is read
// by neighbouring threads at neighbouring addresses; all four statistics
// accumulate in registers in slot order.
//
// Design, backward: the TPU kernel scatters every (m, j) contribution into a
// gradient table held in VMEM, in ascending (m, j) order because its grid
// runs in sequence. Hopper blocks run in no order and atomic adds would sum
// in an order that changes from run to run, so the scatter becomes a gather:
//   1. route: per (m, c), the first slot equal to mx and to mn (two 4-bit
//      slot numbers in one byte; 15 where none is equal);
//   2. the inverse adjacency as CSR lists per cloud: count the in-degree of
//      each n, scan it, fill each list, then sort each (short) list so it
//      holds the flat slots m * k + j in ascending order;
//   3. accumulate: one block per range of rows n, threads across C; each n
//      walks its list in order and sums the contributions in registers.
// Every step is deterministic, and the sum order is the reference's.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // points (forward, route) or rows (backward)
constexpr int kThreads = 256;  // per block
constexpr int kMaxK = 15;      // slots fit in 4 bits; 15 means "none"
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating, as jnp.maximum and torch.amax
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// threads: blockDim.x = tx across the C/4 vectors, blockDim.y = 256 / tx
__global__ void __launch_bounds__(kThreads)
stats_fwd_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                 int n, int m, int cv, int k, float4* __restrict__ mx,
                 float4* __restrict__ mn, float4* __restrict__ s1,
                 float4* __restrict__ s2) {
  __shared__ int sidx[kRows * kMaxK];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int rows = min(kRows, m - m0);
  const int* ib = idx + ((size_t)b * m + m0) * k;
  for (int e = tid; e < rows * k; e += kThreads) sidx[e] = ib[e];
  __syncthreads();

  const float4* tb = table + (size_t)b * n * cv;
  const size_t ob = (size_t)b * m * cv;
  for (int v = threadIdx.x; v < cv; v += blockDim.x) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const int* ir = sidx + r * k;
      const float4 r0 = tb[(size_t)ir[0] * cv + v];
      float4 a = r0, i = r0, s = r0;
      float4 q = make_float4(__fmul_rn(r0.x, r0.x), __fmul_rn(r0.y, r0.y),
                             __fmul_rn(r0.z, r0.z), __fmul_rn(r0.w, r0.w));
      for (int j = 1; j < k; ++j) {
        const float4 rj = tb[(size_t)ir[j] * cv + v];
        a = make_float4(max_nan(a.x, rj.x), max_nan(a.y, rj.y),
                        max_nan(a.z, rj.z), max_nan(a.w, rj.w));
        i = make_float4(min_nan(i.x, rj.x), min_nan(i.y, rj.y),
                        min_nan(i.z, rj.z), min_nan(i.w, rj.w));
        s = make_float4(__fadd_rn(s.x, rj.x), __fadd_rn(s.y, rj.y),
                        __fadd_rn(s.z, rj.z), __fadd_rn(s.w, rj.w));
        if (j == 1) {
          // the reference contracts r0*r0 + r1*r1 into fma(r0, r0, r1*r1)
          q = make_float4(__fmaf_rn(r0.x, r0.x, __fmul_rn(rj.x, rj.x)),
                          __fmaf_rn(r0.y, r0.y, __fmul_rn(rj.y, rj.y)),
                          __fmaf_rn(r0.z, r0.z, __fmul_rn(rj.z, rj.z)),
                          __fmaf_rn(r0.w, r0.w, __fmul_rn(rj.w, rj.w)));
        } else {
          q = make_float4(__fmaf_rn(rj.x, rj.x, q.x), __fmaf_rn(rj.y, rj.y, q.y),
                          __fmaf_rn(rj.z, rj.z, q.z), __fmaf_rn(rj.w, rj.w, q.w));
        }
      }
      const size_t o = ob + (size_t)(m0 + r) * cv + v;
      mx[o] = a;
      mn[o] = i;
      s1[o] = s;
      s2[o] = q;
    }
  }
}

__device__ __forceinline__ unsigned route1(float r, float a, float i, int j,
                                           unsigned code) {
  if ((code & 0xFu) == 0xFu && r == a) code = (code & 0xF0u) | (unsigned)j;
  if ((code >> 4) == 0xFu && r == i) code = (code & 0x0Fu) | ((unsigned)j << 4);
  return code;
}

// route[b, m, c]: low nibble = first slot equal to mx, high = first equal to mn
__global__ void __launch_bounds__(kThreads)
route_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
             const float4* __restrict__ mx, const float4* __restrict__ mn,
             int n, int m, int cv, int k, uchar4* __restrict__ route) {
  __shared__ int sidx[kRows * kMaxK];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int rows = min(kRows, m - m0);
  const int* ib = idx + ((size_t)b * m + m0) * k;
  for (int e = tid; e < rows * k; e += kThreads) sidx[e] = ib[e];
  __syncthreads();

  const float4* tb = table + (size_t)b * n * cv;
  const size_t ob = (size_t)b * m * cv;
  for (int v = threadIdx.x; v < cv; v += blockDim.x) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const size_t o = ob + (size_t)(m0 + r) * cv + v;
      const float4 a = mx[o], i = mn[o];
      unsigned cx = 0xFFu, cy = 0xFFu, cz = 0xFFu, cw = 0xFFu;
      for (int j = 0; j < k; ++j) {
        const float4 rj = tb[(size_t)sidx[r * k + j] * cv + v];
        cx = route1(rj.x, a.x, i.x, j, cx);
        cy = route1(rj.y, a.y, i.y, j, cy);
        cz = route1(rj.z, a.z, i.z, j, cz);
        cw = route1(rj.w, a.w, i.w, j, cw);
      }
      route[o] = make_uchar4(cx, cy, cz, cw);
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

__device__ __forceinline__ float contrib(float row2, float g1, float g2,
                                         float gx, float gn, unsigned code,
                                         unsigned j) {
  float c = __fmaf_rn(row2, g2, g1);
  c = __fadd_rn(c, (code & 0xFu) == j ? gx : 0.f);
  c = __fadd_rn(c, (code >> 4) == j ? gn : 0.f);
  return c;
}

// gtable[b, t] = ordered sum over t's list; threads as in the forward
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float4* __restrict__ table, const int* __restrict__ offs,
             const int* __restrict__ list, const float4* __restrict__ gmx,
             const float4* __restrict__ gmn, const float4* __restrict__ gs1,
             const float4* __restrict__ gs2, const uchar4* __restrict__ route,
             int n, int m, int cv, int k, float4* __restrict__ gtable) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - t0);
  const int* ob = offs + (size_t)b * (n + 1);
  const int* lb = list + (size_t)b * m * k;
  const size_t gb = (size_t)b * m * cv;
  for (int v = threadIdx.x; v < cv; v += blockDim.x) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y) {
      const int t = t0 + r;
      const size_t to = ((size_t)b * n + t) * cv + v;
      const float4 row = table[to];
      const float4 r2 = make_float4(2.f * row.x, 2.f * row.y, 2.f * row.z,
                                    2.f * row.w);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = ob[t]; p < ob[t + 1]; ++p) {
        const int e = lb[p];
        const int mm = e / k;
        const unsigned j = (unsigned)(e - mm * k);
        const size_t o = gb + (size_t)mm * cv + v;
        const float4 a = gs1[o], q = gs2[o], x = gmx[o], y = gmn[o];
        const uchar4 c = route[o];
        acc.x = __fadd_rn(acc.x, contrib(r2.x, a.x, q.x, x.x, y.x, c.x, j));
        acc.y = __fadd_rn(acc.y, contrib(r2.y, a.y, q.y, x.y, y.y, c.y, j));
        acc.z = __fadd_rn(acc.z, contrib(r2.z, a.z, q.z, x.z, y.z, c.z, j));
        acc.w = __fadd_rn(acc.w, contrib(r2.w, a.w, q.w, x.w, y.w, c.w, j));
      }
      gtable[to] = acc;
    }
  }
}

dim3 row_block(int cv) {
  int tx = 1;
  while (tx * 2 <= cv && tx * 2 <= kThreads) tx *= 2;
  return dim3(tx, kThreads / tx);
}

}  // namespace

extern "C" int spn_edge_stats_max_k(void) { return kMaxK; }

extern "C" int spn_edge_stats_fwd(const float* table, const int* idx, int batch,
                                  int n, int m, int c, int k, float* mx,
                                  float* mn, float* s1, float* s2,
                                  void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 4 || c % 4 != 0 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int cv = c / 4;
  const dim3 grid((m + kRows - 1) / kRows, batch);
  stats_fwd_kernel<<<grid, row_block(cv), 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, n, m, cv, k,
      reinterpret_cast<float4*>(mx), reinterpret_cast<float4*>(mn),
      reinterpret_cast<float4*>(s1), reinterpret_cast<float4*>(s2));
  return (int)cudaGetLastError();
}

// Scratch, allocated by the caller: route [B, M, C] bytes; cnt and cursor
// [B, N] int32 (zeroed here); offs [B, N + 1] int32; list [B, M * k] int32.
extern "C" int spn_edge_stats_bwd(const float* table, const int* idx,
                                  const float* mx, const float* mn,
                                  const float* gmx, const float* gmn,
                                  const float* gs1, const float* gs2, int batch,
                                  int n, int m, int c, int k,
                                  unsigned char* route, int* cnt, int* cursor,
                                  int* offs, int* list, float* gtable,
                                  void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 4 || c % 4 != 0 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cv = c / 4;
  const dim3 block = row_block(cv);
  route_kernel<<<dim3((m + kRows - 1) / kRows, batch), block, 0, st>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<const float4*>(mx), reinterpret_cast<const float4*>(mn),
      n, m, cv, k, reinterpret_cast<uchar4*>(route));
  cudaError_t err = cudaGetLastError();
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

  accum_kernel<<<dim3((n + kRows - 1) / kRows, batch), block, 0, st>>>(
      reinterpret_cast<const float4*>(table), offs, list,
      reinterpret_cast<const float4*>(gmx), reinterpret_cast<const float4*>(gmn),
      reinterpret_cast<const float4*>(gs1), reinterpret_cast<const float4*>(gs2),
      reinterpret_cast<const uchar4*>(route), n, m, cv, k,
      reinterpret_cast<float4*>(gtable));
  return (int)cudaGetLastError();
}
