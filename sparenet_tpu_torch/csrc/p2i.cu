// Zero-background max splat of points into depth images (p2i, max reduce):
// points [P, 2] f32 in (y, x) pixels, features [P, 1] f32, image index [P]
// int32 -> out [B, H, W, 1] f32 and, optionally, ids [B, H, W, 1] int32 (the
// winning point, -1 where nothing won).
//
// Replaces: sparenet_tpu/ops/pallas/p2i_pallas.py:p2i_max_pallas (reached
// from sparenet_tpu/ops/p2i.py:p2i_max_zbg on the TPU; the renderer's splat,
// three calls a GAN training step).
//
// Rule: every pixel within r <= R of a point takes the max of f * w(r), with
// w = cos_weight_sq((r / R)^2), a Taylor series in s = (r / R)^2; a pixel is
// updated only where a value is strictly above 0, and an exact tie goes to
// the lowest point id. Rounding follows the JAX package's XLA path
// (ops/p2i.py:_window, _cos_weight), which its CPU program computes as
//   r = sqrt(dy * dy + dx * dx)      (two products and a sum, no fma)
//   s = r * (1 / R)                  (the division by a constant is a product)
//   w = fma(... fma(c10, s^2, c9) ..., s^2, 1)
//   wv = w * f
// and the plain version (ops/p2i.py) reproduces bit for bit.
//
// Bound on an H100: operations. Each point visits the (2 ceil(R) + 2)^2
// window, about 26 fp32 operations a pixel (two subtractions, the squared
// distance, a square root, a compare, eleven Horner fma steps, the product),
// against 16 bytes read a point and 4 (or 8) written a pixel.
//
// Design: one thread per point walks its window. Each winning candidate is
// packed as (float bits of wv) << 32 | (0xFFFFFFFF - pid) into a 64-bit
// image and merged with atomicMax: for positive floats the bits order as
// integers, so the packed maximum is the largest value with the lowest id on
// a tie, whatever order the threads run in (deterministic ids). A finishing
// pass unpacks it into out and ids. Without ids, a 32-bit atomicMax on the
// float bits of out itself does. The pixel is read before the atomic, which
// is skipped when the candidate is not above it (values only grow, so a
// stale read only costs an atomic). No tiles: any H, W and R.
//
// The backward (p2i_bwd_kernel, spn_p2i_max_backward) computes the JAX
// package's _p2i_max_bwd (sparenet_tpu/ops/p2i.py), which XLA runs there:
// one thread a point gathers the pixels its id won over the same window, in
// a fixed order, instead of scattering every pixel's gradient into its
// winner (two index_add_ in the plain version, which deterministic mode
// replaces by sort-based kernels). Bound: bytes, the window's ids read a
// point.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// _COS_COEFFS of p2i_pallas.py rounded to f32, c1 .. c10
// (0.5 * (-1)^k * pi^(2k) / (2k)!).
__constant__ float kCos[10] = {
    -0x1.3bd3ccp+1f, 0x1.03c1f0p+1f,  -0x1.55d3c8p-1f,  0x1.e1f506p-4f,
    -0x1.a6d1f2p-7f, 0x1.f9d38ap-11f, -0x1.b6e250p-15f, 0x1.20c62cp-19f,
    -0x1.2a0c5ap-24f, 0x1.ef6e30p-30f};

// w(r) = 1 + sum_k c_k s^k, s = (r / R)^2 as (r * (1 / R))^2, by Horner
// with one rounding a step.
__device__ __forceinline__ float cos_weight(float r, float inv_r) {
  const float s = __fmul_rn(r, inv_r);
  const float s2 = __fmul_rn(s, s);
  float w = kCos[9];
#pragma unroll
  for (int k = 8; k >= 0; --k) w = __fmaf_rn(w, s2, kCos[k]);
  return __fmaf_rn(w, s2, 1.f);
}

// sqrt(dy * dy + dx * dx), no fma.
__device__ __forceinline__ float pixel_distance(float dy, float dx) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)));
}

// f * w(r) at pixel (iy, ix) of a point at (y, x), or 0 when the pixel is
// beyond R.
__device__ __forceinline__ float splat_value(int iy, int ix, float y, float x,
                                             float f, float radius,
                                             float inv_r) {
  const float r = pixel_distance(__fsub_rn((float)iy, y), __fsub_rn((float)ix, x));
  if (!(r <= radius)) return 0.f;
  return __fmul_rn(cos_weight(r, inv_r), f);
}

template <bool kIds>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ pts, const float* __restrict__ feat,
             const int* __restrict__ binds, int n_points, int n_images, int h,
             int w, float radius, int k, float* __restrict__ out,
             unsigned long long* __restrict__ packed) {
  const float inv_r = __frcp_rn(radius);
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n_points;
       p += gridDim.x * kThreads) {
    const int bi = binds[p];
    if (bi < 0 || bi >= n_images) continue;
    const float y = pts[2 * (size_t)p], x = pts[2 * (size_t)p + 1];
    const float f = feat[p];
    const int y0 = (int)floorf(__fsub_rn(y, radius));
    const int x0 = (int)floorf(__fsub_rn(x, radius));
    const unsigned low = 0xFFFFFFFFu - (unsigned)p;
    for (int iy = max(y0, 0); iy < min(y0 + k, h); ++iy) {
      const size_t row = ((size_t)bi * h + iy) * w;
      for (int ix = max(x0, 0); ix < min(x0 + k, w); ++ix) {
        const float v = splat_value(iy, ix, y, x, f, radius, inv_r);
        if (!(v > 0.f)) continue;
        if (kIds) {
          const unsigned long long cand =
              ((unsigned long long)__float_as_uint(v) << 32) | low;
          unsigned long long* px = packed + row + ix;
          if (cand > __ldcg(px)) atomicMax(px, cand);
        } else {
          int* px = reinterpret_cast<int*>(out + row + ix);
          const int cand = __float_as_int(v);
          if (cand > __ldcg(px)) atomicMax(px, cand);
        }
      }
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ packed,
                              size_t n, float* __restrict__ out,
                              int* __restrict__ ids) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    const unsigned long long v = packed[i];
    out[i] = v ? __uint_as_float((unsigned)(v >> 32)) : 0.f;
    ids[i] = v ? (int)(0xFFFFFFFFu - (unsigned)(v & 0xFFFFFFFFull)) : -1;
  }
}

// Backward of the max splat: each point gathers the gradients of the pixels
// it won (ids[pixel] == its id), visiting its window in row-major order, so
// the sums have one fixed order and no atomics (deterministic by
// construction). For a won pixel at distance r, with g its gradient:
//   d feat   += g * w(r)
//   d (y, x) += k * (dy, dx),  k = g f sin(pi r / R) (pi / 2R) / max(r, 1e-10)
// with dy = iy - y, dx = ix - x, each term in the plain version's order of
// operations on the card (ops/p2i.py:p2i_max_backward_plain; the JAX
// package's _p2i_max_bwd), each point's terms summed in pixel order (the
// plain version's index_add_ sums them in its own order: the two agree to
// rounding).
__global__ void __launch_bounds__(kThreads)
p2i_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ feat,
               const int* __restrict__ binds, const int* __restrict__ ids,
               const float* __restrict__ g, int n_points, int n_images, int h,
               int w, float radius, int k, float* __restrict__ gpts,
               float* __restrict__ gfeat) {
  const float inv_r = __frcp_rn(radius);
  const float pi = 3.14159265358979323846f;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n_points;
       p += gridDim.x * kThreads) {
    const int bi = binds[p];
    const float y = pts[2 * (size_t)p], x = pts[2 * (size_t)p + 1];
    const float f = feat[p];
    float gy = 0.f, gx = 0.f, gf = 0.f;
    if (bi >= 0 && bi < n_images) {
      const int y0 = (int)floorf(__fsub_rn(y, radius));
      const int x0 = (int)floorf(__fsub_rn(x, radius));
      for (int iy = max(y0, 0); iy < min(y0 + k, h); ++iy) {
        const size_t row = ((size_t)bi * h + iy) * w;
        for (int ix = max(x0, 0); ix < min(x0 + k, w); ++ix) {
          if (ids[row + ix] != p) continue;
          const float gv = g[row + ix];
          const float dy = __fsub_rn((float)iy, y);
          const float dx = __fsub_rn((float)ix, x);
          const float r = pixel_distance(dy, dx);
          gf = __fadd_rn(gf, __fmul_rn(gv, cos_weight(r, inv_r)));
          // a division by the scalar R is a product with 1 / R, as in
          // PyTorch's CUDA division by a host scalar
          const float sn = sinf(__fmul_rn(__fmul_rn(r, pi), inv_r));
          float kf = __fmul_rn(__fmul_rn(__fmul_rn(gv, f), sn), 0.5f);
          kf = __fdiv_rn(__fmul_rn(__fmul_rn(kf, pi), inv_r), fmaxf(r, 1e-10f));
          gy = __fadd_rn(gy, __fmul_rn(kf, dy));
          gx = __fadd_rn(gx, __fmul_rn(kf, dx));
        }
      }
    }
    gpts[2 * (size_t)p] = gy;
    gpts[2 * (size_t)p + 1] = gx;
    gfeat[p] = gf;
  }
}

int blocks_for(size_t n) {
  return (int)std::min<size_t>((n + kThreads - 1) / kThreads, 132 * 64);
}

}  // namespace

// packed: scratch of B*H*W uint64 when ids is given (ignored otherwise).
extern "C" int spn_p2i_max(const float* pts, const float* feat,
                           const int* binds, int n_points, int n_images, int h,
                           int w, float radius, int k, float* out, int* ids,
                           unsigned long long* packed, void* stream) {
  if (n_points < 0 || n_images < 1 || h < 1 || w < 1 || k < 1 ||
      !(radius > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_pix = (size_t)n_images * h * w;
  cudaError_t e;
  if (ids) {
    e = cudaMemsetAsync(packed, 0, n_pix * sizeof(unsigned long long), s);
    if (e != cudaSuccess) return (int)e;
    if (n_points > 0)
      splat_kernel<true><<<blocks_for(n_points), kThreads, 0, s>>>(
          pts, feat, binds, n_points, n_images, h, w, radius, k, out, packed);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    unpack_kernel<<<blocks_for(n_pix), kThreads, 0, s>>>(packed, n_pix, out,
                                                          ids);
    return (int)cudaGetLastError();
  }
  e = cudaMemsetAsync(out, 0, n_pix * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (n_points > 0)
    splat_kernel<false><<<blocks_for(n_points), kThreads, 0, s>>>(
        pts, feat, binds, n_points, n_images, h, w, radius, k, out, nullptr);
  return (int)cudaGetLastError();
}

// Gradients of sum(g * out) for the winner ids of a splat: g, ids
// [B, H, W] -> d points [P, 2], d feats [P] (every entry written).
extern "C" int spn_p2i_max_backward(const float* pts, const float* feat,
                                    const int* binds, const int* ids,
                                    const float* g, int n_points, int n_images,
                                    int h, int w, float radius, int k,
                                    float* gpts, float* gfeat, void* stream) {
  if (n_points < 1 || n_images < 1 || h < 1 || w < 1 || k < 1 ||
      !(radius > 0.f))
    return (int)cudaErrorInvalidValue;
  p2i_bwd_kernel<<<blocks_for(n_points), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      pts, feat, binds, ids, g, n_points, n_images, h, w, radius, k, gpts,
      gfeat);
  return (int)cudaGetLastError();
}
