// Neighbour gather + max over k: out[b, m] = max_j table[b, idx[b, m, j]],
// and optionally the f32 sum over (m, j) of every gathered row, [B, C]
// (the squeeze statistic of the encoder's SE layer).
//
// Replaces: sparenet_tpu/ops/pallas/gather_pallas.py:gather_rows_max, used
// by the eval EdgeConv commute path (sparenet_tpu/models/layers.py,
// EdgeConv1x1._commute).
//
// Bound on an H100: bytes. Each output row reads k random table rows of C
// floats; the table (N*C*4 bytes per cloud, at most 12 MB on the model's
// path) stays in the 50 MB L2, so the least traffic is one read of the table
// and the indices and one write of the output.
//
// Design: a block takes 32 output rows of one cloud and stages their
// indices in shared memory (read from device memory directly above 16
// neighbours). Threads run across C, with 16-byte loads where C % 4 == 0
// and the table is 16-byte aligned, else one channel a thread; either way a
// gathered row is read by neighbouring threads at neighbouring addresses.
// The max is taken in registers with no reassociation, so it equals the
// plain version exactly. The sum avoids atomics: each block writes its
// per-column partial sums to scratch [B, blocks, C], and a second small
// kernel adds them in block order, so the result is the same on every run.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // output rows per block
constexpr int kThreads = 256;
constexpr int kStageK = 16;    // neighbour lists staged in shared memory

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating max, as torch.amax / jnp.max
  return (a > b || a != a) ? a : b;
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

// V channels a thread (4: float4 loads; 1: any C and alignment);
// blockDim.x = tx threads across the C / V vectors, blockDim.y = 256 / tx
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

__global__ void sum_partials_kernel(const float* __restrict__ partial, int nblk,
                                    int c, float* __restrict__ sum) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const float* p = partial + (size_t)b * nblk * c + col;
  float s = 0.f;
  for (int i = 0; i < nblk; ++i) s += p[(size_t)i * c];
  sum[(size_t)b * c + col] = s;
}

template <int V>
cudaError_t launch(const float* table, const int* idx, int batch, int n, int m,
                   int c, int k, float* out, float* partial, int nblk,
                   cudaStream_t st) {
  const int cv = c / V;
  int tx = 1;
  while (tx * 2 <= cv && tx * 2 <= kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  gather_max_kernel<V><<<dim3(nblk, batch), block, 0, st>>>(
      table, idx, n, m, c, k, out, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spn_gather_rows_per_block(void) { return kRows; }

// partial [B, ceil(M / 32), C] and sum [B, C] are both null or both set.
extern "C" int spn_gather_max(const float* table, const int* idx, int batch,
                              int n, int m, int c, int k, float* out,
                              float* partial, float* sum, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 1 || k < 1 ||
      ((partial == nullptr) != (sum == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (m + kRows - 1) / kRows;
  const bool vec = c % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0 &&
                   reinterpret_cast<size_t>(partial) % 16 == 0;
  cudaError_t err = vec ? launch<4>(table, idx, batch, n, m, c, k, out, partial, nblk, st)
                        : launch<1>(table, idx, batch, n, m, c, k, out, partial, nblk, st);
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const dim3 g2((c + 255) / 256, batch);
  sum_partials_kernel<<<g2, 256, 0, st>>>(partial, nblk, c, sum);
  return (int)cudaGetLastError();
}
