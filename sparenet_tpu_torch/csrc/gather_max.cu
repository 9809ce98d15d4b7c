// Neighbour gather + max over k: out[b, m] = max_j table[b, idx[b, m, j]],
// and optionally the f32 sum over (m, j) of every gathered row, [B, C]
// (the squeeze statistic of the encoder's SE layer).
//
// Replaces: sparenet_tpu/ops/pallas/gather_pallas.py:gather_rows_max, used
// by the eval EdgeConv commute path (sparenet_tpu/models/layers.py,
// EdgeConv1x1._commute).
//
// Bound on an H100: bytes. The least traffic is one read of the table and
// the indices and one write of the output (and the sum).
//
// Design: gather_slice_kernel, a channel slice of the cloud's table held in
// shared memory (slices.cuh: a block is (cloud, row group, slice), the
// slice copied in by cp.async, the rows' k reads from shared memory). The
// max is taken in registers in slot order, with no reassociation, so it
// equals the plain version exactly. The sum, in a fixed order and the same
// on every run: each thread adds its rows' slots in order (rows q, q + R,
// ... of its group, R rows a chunk), the block adds its R row lanes by a
// halving tree in shared memory (lane q += lane q + h, h = R / 2, ..., 1);
// a block that holds its cloud's every row writes the sum itself, and with
// row groups each group writes a partial [B, groups, C] that
// sum_partials_kernel adds in group order (ops/gather.py:
// gather_max_sum_blocks_plain is this order in PyTorch).
//
// Where no slice fits in shared memory (slices.cuh: N > 13760 at k = 8),
// gather_max_kernel: a block takes 32 output rows of one cloud, threads
// across C with 16-byte loads where C % 4 == 0 and the table is 16-byte
// aligned, and the sum goes through per-block partials [B, ceil(M / 32),
// C] and sum_partials_kernel.
#include "common.cuh"
#include "slices.cuh"

namespace {

using spn::max_nan;
namespace sl = spn::slices;

constexpr int kRows = 32;      // output rows a block of the row path
constexpr int kThreads = 256;
constexpr int kStageK = 16;    // neighbour lists staged in shared memory

// The max of a row's slots, and the thread's running sum over its rows;
// at the block's close, the sum of its row lanes.
struct MaxSum {
  float* out;
  float* sum;      // [B, C] where a block holds every row of its cloud
  float* partial;  // [B, groups, C] where it holds a row group
  float4 mx, acc;
  __device__ void first(float4 r) {
    mx = r;
    add(r);
  }
  __device__ void next(int, float4 r) {
    mx = make_float4(max_nan(mx.x, r.x), max_nan(mx.y, r.y), max_nan(mx.z, r.z),
                     max_nan(mx.w, r.w));
    add(r);
  }
  __device__ void add(float4 r) {
    acc = make_float4(__fadd_rn(acc.x, r.x), __fadd_rn(acc.y, r.y),
                      __fadd_rn(acc.z, r.z), __fadd_rn(acc.w, r.w));
  }
  __device__ void store(size_t o, int valid, bool vec) {
    sl::st4(out + o, mx, valid, vec);
  }
  // the row lanes by a halving tree in the slice's space
  __device__ void close(const sl::Shape& sh, const sl::Place& at, float* smem) {
    if (sum == nullptr && partial == nullptr) return;
    __syncthreads();  // every thread done with the slice
    float* red = smem + 4 * (threadIdx.x & ((sh.width >> 2) - 1));
    *reinterpret_cast<float4*>(red + at.q * sh.width) = acc;
    __syncthreads();
    for (int h = sl::kLanes >> 1; h > 0; h >>= 1) {
      if (at.q < h) {
        const float4 a = sl::ld4(red + at.q * sh.width);
        const float4 o = sl::ld4(red + (at.q + h) * sh.width);
        *reinterpret_cast<float4*>(red + at.q * sh.width) =
            make_float4(__fadd_rn(a.x, o.x), __fadd_rn(a.y, o.y),
                        __fadd_rn(a.z, o.z), __fadd_rn(a.w, o.w));
      }
      __syncthreads();
    }
    if (at.q == 0 && at.ch < sh.c) {
      float* dst = partial ? partial + ((size_t)at.b * sh.groups + at.g) * sh.c
                           : sum + (size_t)at.b * sh.c;
      sl::st4(dst + at.ch, sl::ld4(red), sh.c - at.ch, false);
    }
  }
};

template <int K>
__global__ void __launch_bounds__(sl::kThreads)
gather_slice_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                    sl::Shape sh, float* __restrict__ out,
                    float* __restrict__ sum, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  MaxSum e{out, sum, partial, {}, make_float4(0.f, 0.f, 0.f, 0.f)};
  sl::pass<K>(table, idx, sh, reinterpret_cast<float*>(smem4), e);
}

// V consecutive floats at p (16-byte aligned when V = 4)
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
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// The row path. V channels a thread (4: float4 loads; 1: any C and
// alignment); blockDim.x = tx threads across the C / V vectors,
// blockDim.y = 256 / tx
template <int V>
__global__ void __launch_bounds__(kThreads)
gather_max_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  int n, int m, int c, int k, float* __restrict__ out,
                  float* __restrict__ partial) {
  __shared__ int sidx[kRows * kStageK];
  __shared__ __align__(16) float sred[kThreads * V];

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int m0 = blk * kRows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int rows = min(kRows, m - m0);
  const int cv = c / V;

  const int* ib = idx + ((size_t)b * m + m0) * k;
  const bool staged = k <= kStageK;
  if (staged)
    for (int e = tid; e < rows * k; e += kThreads) sidx[e] = ib[e];
  __syncthreads();
  const int* isrc = staged ? sidx : ib;

  const float* tb = table + (size_t)b * n * c;
  float* ob = out + (size_t)b * m * c;
  for (int v0 = 0; v0 < cv; v0 += blockDim.x) {
    const int v = v0 + tx;
    const bool active = v < cv;
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
    if (active) {
      for (int r = ty; r < rows; r += blockDim.y) {
        const int* ir = isrc + r * k;
        float row[V], mx[V];
        load<V>(tb + (size_t)ir[0] * c + v * V, row);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          mx[i] = row[i];
          s[i] += row[i];
        }
        for (int j = 1; j < k; ++j) {
          load<V>(tb + (size_t)ir[j] * c + v * V, row);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            mx[i] = max_nan(mx[i], row[i]);
            s[i] += row[i];
          }
        }
        store<V>(ob + (size_t)(m0 + r) * c + v * V, mx);
      }
    }
    if (partial != nullptr) {
      store<V>(sred + tid * V, s);
      __syncthreads();
      if (ty == 0 && active) {
        float tot[V], o[V];
        load<V>(sred + tx * V, tot);
        for (int y = 1; y < blockDim.y; ++y) {
          load<V>(sred + (y * blockDim.x + tx) * V, o);
#pragma unroll
          for (int i = 0; i < V; ++i) tot[i] += o[i];
        }
        store<V>(partial + ((size_t)b * gridDim.x + blk) * c + v * V, tot);
      }
      __syncthreads();
    }
  }
}

// sum[b, c] = partial[b, 0, c] + ... + partial[b, nblk - 1, c], from 0
__global__ void sum_partials_kernel(const float* __restrict__ partial, int nblk,
                                    int c, float* __restrict__ sum) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const float* p = partial + (size_t)b * nblk * c + col;
  float s = 0.f;
  for (int i = 0; i < nblk; ++i) s = __fadd_rn(s, p[(size_t)i * c]);
  sum[(size_t)b * c + col] = s;
}

template <int V>
cudaError_t launch_rows(const float* table, const int* idx, int batch, int n,
                        int m, int c, int k, float* out, float* partial,
                        int nblk, cudaStream_t st) {
  const int cv = c / V;
  int tx = 1;
  while (tx * 2 <= cv && tx * 2 <= kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  gather_max_kernel<V><<<dim3(nblk, batch), block, 0, st>>>(
      table, idx, n, m, c, k, out, partial);
  return cudaGetLastError();
}

// rows of the partial sums need_sum takes: the row groups where there are
// more than one, the row path's blocks, or 0
int partial_rows(const sl::Plan& p, int m) {
  if (p.width == 0) return (m + kRows - 1) / kRows;
  return p.groups > 1 ? p.groups : 0;
}

}  // namespace

// Rows of the partials [B, rows, C] spn_gather_max takes with the sum for a
// [B, N, C] table and [B, M, k] lists (0: none), or a negative CUDA error.
extern "C" int spn_gather_partial_rows(int batch, int n, int m, int c, int k) {
  sl::Plan p;
  const cudaError_t err = sl::make_plan(batch, n, m, c, k, &p);
  return err == cudaSuccess ? partial_rows(p, m) : -(int)err;
}

// sum [B, C] null without the sum; partial [B, rows, C] with the sum where
// spn_gather_partial_rows gives rows, else null.
extern "C" int spn_gather_max(const float* table, const int* idx, int batch,
                              int n, int m, int c, int k, float* out,
                              float* partial, float* sum, void* stream) {
  sl::Plan p;
  cudaError_t err = sl::make_plan(batch, n, m, c, k, &p);
  if (err != cudaSuccess) return (int)err;
  const int rows = sum == nullptr ? 0 : partial_rows(p, m);
  if ((rows > 0) != (partial != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.width > 0) {
    const bool vec = c % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0 &&
                     reinterpret_cast<size_t>(out) % 16 == 0;
    const sl::Shape sh = sl::shape_of(p, n, m, c, k, vec, idx);
    float* whole = rows > 0 ? nullptr : sum;
    err = k == 8 ? sl::launch(gather_slice_kernel<8>, p, st, table, idx, sh,
                              out, whole, partial)
                 : sl::launch(gather_slice_kernel<0>, p, st, table, idx, sh,
                              out, whole, partial);
  } else {
    const bool vec = c % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0 &&
                     reinterpret_cast<size_t>(out) % 16 == 0 &&
                     reinterpret_cast<size_t>(partial) % 16 == 0;
    const int nblk = (m + kRows - 1) / kRows;
    err = vec ? launch_rows<4>(table, idx, batch, n, m, c, k, out, partial, nblk, st)
              : launch_rows<1>(table, idx, batch, n, m, c, k, out, partial, nblk, st);
  }
  if (err != cudaSuccess || rows == 0) return (int)err;
  const dim3 g2((c + 255) / 256, batch);
  sum_partials_kernel<<<g2, 256, 0, st>>>(partial, rows, c, sum);
  return (int)cudaGetLastError();
}
