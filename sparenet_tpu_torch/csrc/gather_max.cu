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
// indices in shared memory. Threads run across C with 16-byte loads, so a
// gathered row is read by neighbouring threads at neighbouring addresses.
// The max is taken in registers with no reassociation, so it equals the
// plain version exactly. The sum avoids atomics: each block writes its
// per-column partial sums to scratch [B, blocks, C], and a second small
// kernel adds them in block order, so the result is the same on every run.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxK = 16;

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating max, as torch.amax / jnp.max
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// blockDim.x = tx (threads across the C/4 vectors), blockDim.y = 256 / tx
__global__ void __launch_bounds__(kThreads)
gather_max_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                  int n, int m, int cv, int k, float4* __restrict__ out,
                  float4* __restrict__ partial) {
  __shared__ int sidx[kRows * kMaxK];
  __shared__ float4 sred[kThreads];

  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int m0 = blk * kRows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx;
  const int rows = min(kRows, m - m0);

  const int* ib = idx + ((size_t)b * m + m0) * k;
  for (int e = tid; e < rows * k; e += kThreads) sidx[e] = ib[e];
  __syncthreads();

  const float4* tb = table + (size_t)b * n * cv;
  float4* ob = out + (size_t)b * m * cv;
  for (int v0 = 0; v0 < cv; v0 += blockDim.x) {
    const int v = v0 + tx;
    const bool active = v < cv;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      for (int r = ty; r < rows; r += blockDim.y) {
        const int* ir = sidx + r * k;
        float4 row = tb[(size_t)ir[0] * cv + v];
        float4 mx = row;
        s = add4(s, row);
        for (int j = 1; j < k; ++j) {
          row = tb[(size_t)ir[j] * cv + v];
          mx = max4(mx, row);
          s = add4(s, row);
        }
        ob[(size_t)(m0 + r) * cv + v] = mx;
      }
    }
    if (partial != nullptr) {
      sred[tid] = s;
      __syncthreads();
      if (ty == 0 && active) {
        float4 tot = sred[tx];
        for (int y = 1; y < blockDim.y; ++y) tot = add4(tot, sred[y * blockDim.x + tx]);
        partial[((size_t)b * gridDim.x + blk) * cv + v] = tot;
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

}  // namespace

extern "C" int spn_gather_rows_per_block(void) { return kRows; }

// partial [B, ceil(M / 32), C] and sum [B, C] are both null or both set.
extern "C" int spn_gather_max(const float* table, const int* idx, int batch,
                              int n, int m, int c, int k, float* out,
                              float* partial, float* sum, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || c < 4 || c % 4 != 0 || k < 1 || k > kMaxK ||
      ((partial == nullptr) != (sum == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cv = c / 4;
  int tx = 1;
  while (tx * 2 <= cv && tx * 2 <= kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const int nblk = (m + kRows - 1) / kRows;
  const dim3 grid(nblk, batch);
  gather_max_kernel<<<grid, block, 0, st>>>(
      reinterpret_cast<const float4*>(table), idx, n, m, cv, k,
      reinterpret_cast<float4*>(out), reinterpret_cast<float4*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const dim3 g2((c + 255) / 256, batch);
  sum_partials_kernel<<<g2, 256, 0, st>>>(partial, nblk, c, sum);
  return (int)cudaGetLastError();
}
