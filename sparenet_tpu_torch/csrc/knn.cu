// Self-kNN graph: x [B, N, C] f32 -> idx [B, N, 8] int32, self included,
// ascending by distance, lowest index on ties.
//
// Replaces: sparenet_tpu/ops/pallas/knn_pallas.py:knn_self_pallas (the
// one-chunk and C-chunked Pallas kernels), whose semantics are
// sparenet_tpu/ops/knn.py:_knn_one / _smallest_k.
//
// Distance: the reference's parity-mode graph distance
// (sparenet_tpu/ops/common.py:graph_dot at HIGH precision), i.e. the 3-term
// bf16 split  dot = xh.yh + xh.yl + xl.yh  accumulated in f32, then
// d = max(|x|^2 + |y|^2 - 2 dot, 0).
//
// Bound on an H100: operations. Each (query, candidate, channel) triple
// costs three multiply-adds, 6*B*N*N*C flops in all, against N*C*4 bytes
// read per cloud; the distance matrix itself is never written.
//
// Design: one block holds 128 queries of one cloud, one query per thread.
// Candidates stream through shared memory in tiles of 64; channels in
// chunks of 16, so any C fits (3 to 1024 on the model's path) in 25 KB of
// shared memory. The bf16 split of both operands is made once, when a chunk
// is staged. Each thread keeps 64 partial dot products for the current
// candidate tile and its running top-8 as (distance, index) pairs in
// registers, inserted in lexicographic order so ties keep the lowest index.
// The products run on the fp32 pipes (no tensor cores yet).
//
// Packed arm (serving mode; spn_knn_packed): the arm of the same Pallas entry
// that knn_pallas.py:_knn_onechunk_kernel runs with packed=True. The distance
// is one bf16 pass with f32 accumulation, d = max(|x|^2 + |y|^2 - 2 xh.yh, 0)
// (|x|^2 from the f32 values, summed in channel order), and each candidate
// is ranked by one int32 key: the f32 bits of d with their low `bits` bits
// cleared (bits = bit_length(n_pad - 1), n_pad = n rounded up to 128) and
// the candidate index in them. The 8 smallest keys are the neighbours, so a
// tie of truncated distances goes to the lowest index. Products of two bf16
// values are exact in f32, so the sequential fma over channels is the plain
// version's sequential sum. Bound: operations, 2*B*N*N*C flops (one fma per
// triple).
#include "common.cuh"

namespace {

constexpr int kQT = 128;      // queries per block (one per thread)
constexpr int kCT = 64;       // candidates per tile
constexpr int kCTP = kCT + 4; // padded row: fewer bank conflicts on staging
constexpr int kCC = 16;       // channels per staged chunk
constexpr int kK = 8;         // neighbours per point (the model's k)

__global__ void sqnorm_kernel(const float* __restrict__ x, int rows, int c,
                              float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + (size_t)r * c;
  float s = 0.f;
  for (int i = 0; i < c; ++i) s = fmaf(p[i], p[i], s);
  out[r] = s;
}

__global__ void __launch_bounds__(kQT)
knn_kernel(const float* __restrict__ x, const float* __restrict__ sq, int n,
           int c, int* __restrict__ out) {
  __shared__ float qh[kQT][kCC + 1];
  __shared__ float ql[kQT][kCC + 1];
  __shared__ __align__(16) float yh[kCC][kCTP];
  __shared__ __align__(16) float yl[kCC][kCTP];
  __shared__ float yn[kCT];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int t = threadIdx.x;
  const int q = q0 + t;
  const float* xb = x + (size_t)b * n * c;
  const float* sqb = sq + (size_t)b * n;
  const float xq2 = q < n ? sqb[q] : 0.f;

  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bi[s] = INT_MAX;
  }

  for (int j0 = 0; j0 < n; j0 += kCT) {
    float acc[kCT];
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += kCC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int e = t; e < kQT * kCC; e += kQT) {
        const int r = e / kCC, cc = e % kCC;
        const int row = q0 + r, ch = c0 + cc;
        const float v = (row < n && ch < c) ? xb[(size_t)row * c + ch] : 0.f;
        const float h = spn::bf16_round(v);
        qh[r][cc] = h;
        ql[r][cc] = spn::bf16_round(v - h);
      }
      for (int e = t; e < kCT * kCC; e += kQT) {
        const int r = e / kCC, cc = e % kCC;
        const int row = j0 + r, ch = c0 + cc;
        const float v = (row < n && ch < c) ? xb[(size_t)row * c + ch] : 0.f;
        const float h = spn::bf16_round(v);
        yh[cc][r] = h;
        yl[cc][r] = spn::bf16_round(v - h);
      }
      if (c0 == 0 && t < kCT) yn[t] = (j0 + t < n) ? sqb[j0 + t] : 0.f;
      __syncthreads();

#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const float xh = qh[t][cc];
        const float xl = ql[t][cc];
#pragma unroll
        for (int j = 0; j < kCT; j += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(&yh[cc][j]);
          const float4 l4 = *reinterpret_cast<const float4*>(&yl[cc][j]);
          acc[j + 0] = fmaf(xl, h4.x, fmaf(xh, l4.x, fmaf(xh, h4.x, acc[j + 0])));
          acc[j + 1] = fmaf(xl, h4.y, fmaf(xh, l4.y, fmaf(xh, h4.y, acc[j + 1])));
          acc[j + 2] = fmaf(xl, h4.z, fmaf(xh, l4.z, fmaf(xh, h4.z, acc[j + 2])));
          acc[j + 3] = fmaf(xl, h4.w, fmaf(xh, l4.w, fmaf(xh, h4.w, acc[j + 3])));
        }
      }
    }

    // Candidates arrive in increasing index order, so a newcomer enters
    // only if strictly closer than the current 8th; the bubble below
    // keeps the list in (distance, index) order.
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      const int cand = j0 + j;
      if (cand < n) {
        const float d = fmaxf(__fsub_rn(__fadd_rn(xq2, yn[j]), 2.f * acc[j]), 0.f);
        if (d < bd[kK - 1]) {
          float cd = d;
          int ci = cand;
#pragma unroll
          for (int s = 0; s < kK; ++s) {
            const bool sw = spn::lex_less(cd, ci, bd[s], bi[s]);
            const float tv = sw ? bd[s] : cd;
            const int ti = sw ? bi[s] : ci;
            bd[s] = sw ? cd : bd[s];
            bi[s] = sw ? ci : bi[s];
            cd = tv;
            ci = ti;
          }
        }
      }
    }
  }

  if (q < n) {
    int* o = out + ((size_t)b * n + q) * kK;
#pragma unroll
    for (int s = 0; s < kK; ++s) o[s] = bi[s];
  }
}

__global__ void sqnorm_seq_kernel(const float* __restrict__ x, int rows, int c,
                                  float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + (size_t)r * c;
  float s = 0.f;
  for (int i = 0; i < c; ++i) s = __fadd_rn(s, __fmul_rn(p[i], p[i]));
  out[r] = s;
}

__global__ void __launch_bounds__(kQT)
knn_packed_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                  int n, int c, int bits, int* __restrict__ out) {
  __shared__ float qh[kQT][kCC + 1];
  __shared__ __align__(16) float yh[kCC][kCTP];
  __shared__ float yn[kCT];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int t = threadIdx.x;
  const int q = q0 + t;
  const float* xb = x + (size_t)b * n * c;
  const float* sqb = sq + (size_t)b * n;
  const float xq2 = q < n ? sqb[q] : 0.f;
  const int mask = -(1 << bits);

  int bk[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) bk[s] = INT_MAX;

  for (int j0 = 0; j0 < n; j0 += kCT) {
    float acc[kCT];
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += kCC) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int e = t; e < kQT * kCC; e += kQT) {
        const int r = e / kCC, cc = e % kCC;
        const int row = q0 + r, ch = c0 + cc;
        qh[r][cc] = spn::bf16_round(
            (row < n && ch < c) ? xb[(size_t)row * c + ch] : 0.f);
      }
      for (int e = t; e < kCT * kCC; e += kQT) {
        const int r = e / kCC, cc = e % kCC;
        const int row = j0 + r, ch = c0 + cc;
        yh[cc][r] = spn::bf16_round(
            (row < n && ch < c) ? xb[(size_t)row * c + ch] : 0.f);
      }
      if (c0 == 0 && t < kCT) yn[t] = (j0 + t < n) ? sqb[j0 + t] : 0.f;
      __syncthreads();

#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const float xh = qh[t][cc];
#pragma unroll
        for (int j = 0; j < kCT; j += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(&yh[cc][j]);
          acc[j + 0] = __fmaf_rn(xh, h4.x, acc[j + 0]);
          acc[j + 1] = __fmaf_rn(xh, h4.y, acc[j + 1]);
          acc[j + 2] = __fmaf_rn(xh, h4.z, acc[j + 2]);
          acc[j + 3] = __fmaf_rn(xh, h4.w, acc[j + 3]);
        }
      }
    }

    // keys are unique (the index is in them): a plain sorted insert
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      const int cand = j0 + j;
      if (cand < n) {
        const float d = fmaxf(
            __fsub_rn(__fadd_rn(xq2, yn[j]), __fmul_rn(2.f, acc[j])), 0.f);
        int key = (__float_as_int(d) & mask) | cand;
        if (key < bk[kK - 1]) {
#pragma unroll
          for (int s = 0; s < kK; ++s) {
            const int lo = min(key, bk[s]);
            key = max(key, bk[s]);
            bk[s] = lo;
          }
        }
      }
    }
  }

  if (q < n) {
    int* o = out + ((size_t)b * n + q) * kK;
#pragma unroll
    for (int s = 0; s < kK; ++s) o[s] = bk[s] & ((1 << bits) - 1);
  }
}

}  // namespace

extern "C" int spn_knn(const float* x, float* sqnorm, int batch, int n, int c,
                       int k, int* out, void* stream) {
  if (batch < 1 || n < k || c < 1 || k != kK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * n;
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, st>>>(x, rows, c, sqnorm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQT - 1) / kQT, batch);
  knn_kernel<<<grid, kQT, 0, st>>>(x, sqnorm, n, c, out);
  return (int)cudaGetLastError();
}

// bits: the low key bits the index takes, bit_length(n_pad - 1).
extern "C" int spn_knn_packed(const float* x, float* sqnorm, int batch, int n,
                              int c, int k, int bits, int* out, void* stream) {
  if (batch < 1 || n < k || c < 1 || k != kK || bits < 1 || bits > 30 ||
      (n - 1) >> bits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * n;
  sqnorm_seq_kernel<<<(rows + 255) / 256, 256, 0, st>>>(x, rows, c, sqnorm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQT - 1) / kQT, batch);
  knn_packed_kernel<<<grid, kQT, 0, st>>>(x, sqnorm, n, c, bits, out);
  return (int)cudaGetLastError();
}
