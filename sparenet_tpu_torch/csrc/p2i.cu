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
// Design: image tiles in shared memory (the TPU kernel's VMEM tiles, 32 x
// 128 pixels there). Each candidate is packed as
//   (float bits of wv) << 32 | (0xFFFFFFFF - pid)
// and merged with atomicMax: for positive floats the bits order as
// integers, so the packed maximum is the largest value with the lowest id on
// a tie, whatever order the points are merged in (deterministic ids, and
// the order within a bin does not matter). Without ids, the 32-bit float
// bits alone. Steps, all on the card (no host read):
//   1. bin: a counting sort of (point, tile) entries, every tile of every
//      image that the point's window (clipped to the image) overlaps, at
//      most 4 when the tile edges are at least the window: a histogram of
//      the bins (bin_kernel<false>; the lanes of a warp that share a bin
//      add to it once), one block's exclusive scan of the counts and of
//      each bin's work items (bin_scan_kernel: ceil(count / per_item)
//      items, at least one, so an empty tile is written too), a scatter of
//      the point ids into their bins (bin_kernel<true>);
//   2. splat (tile_splat_kernel): a grid of CTAs takes work items from a
//      counter; an item is a bin's tile in shared memory (keys zeroed), a
//      warp a point over its window clipped to the tile in patches of 4 x 8
//      pixels (a lane a pixel; a warp loads 32 points at once and
//      broadcasts them), a shared-memory atomicMax where the candidate is
//      above the pixel's key (keys only grow, so a stale read costs an
//      atomic, never a value; sm_90 runs a 64-bit shared atomicMax as a
//      compare-and-swap loop, which the read keeps rare); then the tile is
//      written once, coalesced, into out and ids;
//   3. a bin whose entries fill more than one item is split over CTAs:
//      split_prepare_kernel zeroes its pixels of the merge image (with ids)
//      or of out (values only) before the splat, its items merge with a
//      global atomicMax of their nonzero keys, and split_finish_kernel
//      unpacks its pixels into out and ids. No pass touches the pixels of
//      a tile that was not split.
// per_item (entries a work item) is chosen by the caller from the window,
// so an item holds about the same number of window pixels at any radius.
// Any H, W, R and layout of binds: tiles past the image's edge are clipped.
//
// The backward (p2i_bwd_kernel, spn_p2i_max_backward) computes the JAX
// package's _p2i_max_bwd (sparenet_tpu/ops/p2i.py), which XLA runs there:
// one thread a point gathers the pixels its id won over the same window, in
// a fixed order, instead of scattering every pixel's gradient into its
// winner (two index_add_ in the plain version, which deterministic mode
// replaces by sort-based kernels). Bound: bytes, the window's ids read a
// point.
#include <algorithm>
#include <map>
#include <type_traits>
#include <utility>

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

using u64 = unsigned long long;

// A packed (value bits << 32 | 0xFFFFFFFF - id) key into out and ids; 0
// where nothing won.
__device__ __forceinline__ void unpack(u64 v, float& out, int& id) {
  out = v ? __uint_as_float((unsigned)(v >> 32)) : 0.f;
  id = v ? (int)(0xFFFFFFFFu - (unsigned)(v & 0xFFFFFFFFull)) : -1;
}

// Shared tile rows hold pitch = tw + 8 keys: a warp's 4 x 8 patch then
// falls on disjoint banks for 32-bit keys, and on two wavefronts (the
// least) for 64-bit ones.
constexpr int kPad = 8;

// A point's window, clipped to the image: rows [y0, y1), columns [x0, x1)
// (empty where y0 >= y1 or x0 >= x1). The origin is floor(p - R); it is
// clamped first, so a point far off the image cannot overflow.
struct Window {
  int y0, y1, x0, x1;
};
__device__ __forceinline__ int window_origin(float c, float radius, int size, int k) {
  // a NaN coordinate gives -k: an empty window (its pixels' r would be NaN)
  const float o = floorf(__fsub_rn(c, radius));
  return (int)fminf(fmaxf(o, (float)-k), (float)size);
}
__device__ __forceinline__ Window window_of(float y, float x, float radius, int h,
                                            int w, int k) {
  const int oy = window_origin(y, radius, h, k), ox = window_origin(x, radius, w, k);
  return {max(oy, 0), min(oy + k, h), max(ox, 0), min(ox + k, w)};
}

// The tiles a window overlaps: rows [ty0, ty1], columns [tx0, tx1]; false
// where the point adds nothing (image index outside [0, B), or a window
// that misses the image).
struct Span {
  int bin0, ty0, ty1, tx0, tx1;
};
__device__ __forceinline__ bool span_of(const float* pts, const int* binds, int p,
                                        int n_images, int h, int w, float radius,
                                        int k, int th, int tw, int nty, int ntx,
                                        Span& s) {
  const int bi = binds[p];
  if (bi < 0 || bi >= n_images) return false;
  const Window win = window_of(pts[2 * (size_t)p], pts[2 * (size_t)p + 1], radius,
                               h, w, k);
  if (win.y0 >= win.y1 || win.x0 >= win.x1) return false;
  s = {bi * nty * ntx, win.y0 / th, (win.y1 - 1) / th, win.x0 / tw, (win.x1 - 1) / tw};
  return true;
}

// The histogram (kScatter false: counts[bin] += entries) or the scatter
// (kScatter true: counts holds the cursors, entries[cursor++] = point) of
// the (point, tile) entries. A warp's points mostly share their bins (the
// renderer's points come image by image, and crowd), so the lanes of a
// warp that hold the same bin add to it once (__match_any_sync), the
// lowest of them for the group.
template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
bin_kernel(const float* __restrict__ pts, const int* __restrict__ binds,
           int n_points, int n_images, int h, int w, float radius, int k, int th,
           int tw, int nty, int ntx, int* __restrict__ counts,
           int* __restrict__ entries) {
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * kThreads + (threadIdx.x & ~31); base < n_points;
       base += gridDim.x * kThreads) {
    const int p = base + lane;
    Span s{0, 0, -1, 0, -1};
    if (p < n_points)
      span_of(pts, binds, p, n_images, h, w, radius, k, th, tw, nty, ntx, s);
    const int nx = max(s.tx1 - s.tx0 + 1, 0), n = max(s.ty1 - s.ty0 + 1, 0) * nx;
    const int most = __reduce_max_sync(spn::kFullMask, n);
    for (int q = 0; q < most; ++q) {
      const int bin = q < n ? s.bin0 + (s.ty0 + q / nx) * ntx + s.tx0 + q % nx : -1;
      const unsigned group = __match_any_sync(spn::kFullMask, bin);
      const int leader = __ffs(group) - 1;
      int slot = 0;
      if (bin >= 0 && lane == leader) slot = atomicAdd(&counts[bin], __popc(group));
      if (kScatter) {
        slot = __shfl_sync(spn::kFullMask, slot, leader) +
               __popc(group & ((1u << lane) - 1));
        if (bin >= 0) entries[slot] = p;
      }
    }
  }
}

// One block: off[b] = sum of counts before bin b, item_off[b] = work items
// before bin b (ceil(count / per_item), at least 1), both with their total
// at [nbins]; counts[b] becomes the scatter's cursor, off[b].
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(spn::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(spn::kFullMask, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next call
  return before;
}

__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(int* __restrict__ counts, int nbins, int per_item,
                int* __restrict__ off, int* __restrict__ item_off) {
  __shared__ int warp_sums[32];
  int carry = 0, carry_items = 0;
  for (int base = 0; base < nbins; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const int c = b < nbins ? counts[b] : 0;
    const int items = b < nbins ? max(1, (c + per_item - 1) / per_item) : 0;
    int total, total_items;
    const int before = block_exclusive_scan(c, &total, warp_sums);
    const int before_items = block_exclusive_scan(items, &total_items, warp_sums);
    if (b < nbins) {
      off[b] = carry + before;
      item_off[b] = carry_items + before_items;
      counts[b] = carry + before;
    }
    carry += total;
    carry_items += total_items;
  }
  if (threadIdx.x == 0) {
    off[nbins] = carry;
    item_off[nbins] = carry_items;
  }
}

// A bin's tile: image bi, rows [y0, y1), columns [x0, x1) (clipped).
struct Tile {
  int bi, y0, y1, x0, x1;
};
__device__ __forceinline__ Tile tile_of(int bin, int h, int w, int th, int tw,
                                        int nty, int ntx) {
  const int bi = bin / (nty * ntx), r = bin % (nty * ntx);
  const int y0 = (r / ntx) * th, x0 = (r % ntx) * tw;
  return {bi, y0, min(y0 + th, h), x0, min(x0 + tw, w)};
}

__device__ __forceinline__ bool split(const int* item_off, int bin) {
  return item_off[bin + 1] - item_off[bin] > 1;
}

template <bool kIds>
using Key = typename std::conditional<kIds, u64, unsigned>::type;

// Zero the pixels of each split tile in the merge target: the merge image
// with ids, out without. A block a bin, grid-strided.
template <bool kIds>
__global__ void __launch_bounds__(kThreads)
split_prepare_kernel(const int* __restrict__ item_off, int nbins, int h, int w,
                     int th, int tw, int nty, int ntx, Key<kIds>* __restrict__ merge) {
  for (int bin = blockIdx.x; bin < nbins; bin += gridDim.x) {
    if (!split(item_off, bin)) continue;
    const Tile t = tile_of(bin, h, w, th, tw, nty, ntx);
    const int cw = t.x1 - t.x0;
    for (int q = threadIdx.x; q < (t.y1 - t.y0) * cw; q += kThreads)
      merge[((size_t)t.bi * h + t.y0 + q / cw) * w + t.x0 + q % cw] = 0;
  }
}

// Unpack each split tile's merged keys into out and ids.
__global__ void __launch_bounds__(kThreads)
split_finish_kernel(const int* __restrict__ item_off, int nbins, int h, int w,
                    int th, int tw, int nty, int ntx, const u64* __restrict__ merge,
                    float* __restrict__ out, int* __restrict__ ids) {
  for (int bin = blockIdx.x; bin < nbins; bin += gridDim.x) {
    if (!split(item_off, bin)) continue;
    const Tile t = tile_of(bin, h, w, th, tw, nty, ntx);
    const int cw = t.x1 - t.x0;
    for (int q = threadIdx.x; q < (t.y1 - t.y0) * cw; q += kThreads) {
      const size_t i = ((size_t)t.bi * h + t.y0 + q / cw) * w + t.x0 + q % cw;
      unpack(merge[i], out[i], ids[i]);
    }
  }
}

constexpr int kWarps = kThreads / 32;

template <bool kIds>
__global__ void __launch_bounds__(kThreads)
tile_splat_kernel(const float* __restrict__ pts, const float* __restrict__ feat,
                  const int* __restrict__ entries, const int* __restrict__ off,
                  const int* __restrict__ item_off, int nbins, int* __restrict__ next,
                  int h, int w, float radius, int k, int th, int tw, int nty,
                  int ntx, int per_item, float* __restrict__ out,
                  int* __restrict__ ids, Key<kIds>* __restrict__ merge) {
  using K = Key<kIds>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* tile = reinterpret_cast<K*>(smem_raw);
  __shared__ int s_item, s_bin;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = tw + kPad;
  const float inv_r = __frcp_rn(radius);
  const int n_items = item_off[nbins];
  const int py = lane >> 3, px = lane & 7;  // the lane's pixel in a 4 x 8 patch
  for (;;) {
    if (tid == 0) {
      const int item = atomicAdd(next, 1);
      int lo = 0, hi = nbins - 1;  // the last bin whose items start <= item
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (item_off[mid] <= item) lo = mid;
        else hi = mid - 1;
      }
      s_item = item;
      s_bin = lo;
    }
    __syncthreads();
    const int item = s_item, bin = s_bin;
    if (item >= n_items) break;
    const Tile t = tile_of(bin, h, w, th, tw, nty, ntx);
    for (int q = tid; q < th * pitch; q += kThreads) tile[q] = 0;
    __syncthreads();
    const int first = off[bin] + (item - item_off[bin]) * per_item;
    const int last = min(off[bin + 1], first + per_item);
    // warp w takes entries first + w, first + w + 8, ...: 32 of them loaded
    // at once, a lane each, then broadcast one by one
    for (int e0 = first + warp; e0 < last; e0 += kWarps * 32) {
      const int e = e0 + kWarps * lane;
      int p = 0;
      float y = 0.f, x = 0.f, f = 0.f;
      if (e < last) {
        p = entries[e];
        y = pts[2 * (size_t)p];
        x = pts[2 * (size_t)p + 1];
        f = feat[p];
      }
      const int n = min(32, (last - e0 + kWarps - 1) / kWarps);
      for (int j = 0; j < n; ++j) {
        const int pj = __shfl_sync(spn::kFullMask, p, j);
        const float yj = __shfl_sync(spn::kFullMask, y, j);
        const float xj = __shfl_sync(spn::kFullMask, x, j);
        const float fj = __shfl_sync(spn::kFullMask, f, j);
        const Window win = window_of(yj, xj, radius, h, w, k);
        const int y0 = max(win.y0, t.y0), y1 = min(win.y1, t.y1);
        const int x0 = max(win.x0, t.x0), x1 = min(win.x1, t.x1);
        const unsigned low = 0xFFFFFFFFu - (unsigned)pj;
        for (int by = y0; by < y1; by += 4) {
          const int iy = by + py;
          const float dy = __fsub_rn((float)iy, yj);
          const float dy2 = __fmul_rn(dy, dy);
          K* row = tile + (iy - t.y0) * pitch - t.x0;
          for (int bx = x0; bx < x1; bx += 8) {
            const int ix = bx + px;
            // f * w(r) by pixel_distance and cos_weight, dy * dy once a row
            const float dx = __fsub_rn((float)ix, xj);
            const float r = __fsqrt_rn(__fadd_rn(dy2, __fmul_rn(dx, dx)));
            const float v = __fmul_rn(cos_weight(r, inv_r), fj);
            if (iy < y1 && ix < x1 && r <= radius && v > 0.f) {
              K cand;
              if constexpr (kIds) cand = ((u64)__float_as_uint(v) << 32) | low;
              else cand = __float_as_uint(v);
              if (cand > row[ix]) atomicMax(&row[ix], cand);
            }
          }
        }
      }
    }
    __syncthreads();
    const bool merged = split(item_off, bin);
    const int cw = t.x1 - t.x0;
    for (int q = tid; q < (t.y1 - t.y0) * cw; q += kThreads) {
      const int ry = q / cw, rx = q % cw;
      const K v = tile[ry * pitch + rx];
      const size_t i = ((size_t)t.bi * h + t.y0 + ry) * w + t.x0 + rx;
      if (merged) {
        if (v) atomicMax(&merge[i], v);
      } else if constexpr (kIds) {
        unpack(v, out[i], ids[i]);
      } else {
        out[i] = __uint_as_float(v);
      }
    }
    __syncthreads();  // the tile and s_item are reused by the next item
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

// The tiling of a call: th x tw tiles, nty x ntx an image.
struct Tiling {
  int th, tw, nty, ntx, nbins;
  long long span;  // most tiles one window overlaps
};
Tiling tiling(int n_images, int h, int w, int k, int th, int tw) {
  const int nty = (h + th - 1) / th, ntx = (w + tw - 1) / tw;
  return {th, tw, nty, ntx, n_images * nty * ntx,
          (long long)((k - 1) / th + 2) * ((k - 1) / tw + 2)};
}

// tw a multiple of 32, a tile of 64-bit keys within 200 KiB of shared
// memory, and every offset within an int
bool tiling_ok(int n_points, int n_images, int h, int w, int k, int th, int tw) {
  if (k < 1 || th < 1 || tw < 32 || tw % 32 != 0 ||
      (long long)th * (tw + kPad) * 8 > 200 * 1024)
    return false;
  const long long nty = (h + th - 1) / th, ntx = (w + tw - 1) / tw;
  const long long span = (long long)((k - 1) / th + 2) * ((k - 1) / tw + 2);
  return n_images * nty * ntx < (1ll << 30) && (long long)n_points * span < INT_MAX;
}

// The splat's launch: as many CTAs as fit on the card at once, each taking
// work items until none is left. The grid is worked out once a (device,
// shared memory size) and kept, and the kernel's shared-memory attribute
// only ever raised, so a call costs the host no more than its launches.
template <bool kIds>
cudaError_t launch_splat(const float* pts, const float* feat, const int* entries,
                         const int* off, const int* item_off, const Tiling& tl,
                         int* next, int h, int w, float radius, int k, int per_item,
                         float* out, int* ids, Key<kIds>* merge, cudaStream_t s) {
  static std::map<std::pair<int, int>, int> grids;
  static std::map<int, int> allowed;  // the attribute set so far, a device
  const int smem = tl.th * (tl.tw + kPad) * (int)sizeof(Key<kIds>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > allowed[dev]) {  // only raised: a launch with less still fits
    e = cudaFuncSetAttribute(tile_splat_kernel<kIds>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  auto hit = grids.find({dev, smem});
  if (hit == grids.end()) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_splat_kernel<kIds>, kThreads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    hit = grids.emplace(std::make_pair(dev, smem), std::max(1, per_sm) * sms).first;
  }
  tile_splat_kernel<kIds><<<hit->second, kThreads, smem, s>>>(
      pts, feat, entries, off, item_off, tl.nbins, next, h, w, radius, k, tl.th,
      tl.tw, tl.nty, tl.ntx, per_item, out, ids, merge);
  return cudaGetLastError();
}

}  // namespace

// Scratch ints spn_p2i_max needs: a work counter and the counts, the bin
// offsets and the item offsets (nbins + 1 each), and the entries (at most
// span a point); -1 for a tiling it refuses (tiling_ok).
extern "C" long long spn_p2i_scratch_ints(int n_points, int n_images, int h, int w,
                                          int k, int th, int tw) {
  if (n_points < 0 || n_images < 1 || h < 1 || w < 1 ||
      !tiling_ok(n_points, n_images, h, w, k, th, tw))
    return -1;
  const Tiling tl = tiling(n_images, h, w, k, th, tw);
  return 1 + 3 * ((long long)tl.nbins + 1) + (long long)n_points * tl.span;
}

// scratch: spn_p2i_scratch_ints ints (uninitialised); merge: B*H*W uint64
// (uninitialised) with ids, else ignored; only split tiles' pixels of it
// are written. per_item: entries a work item.
extern "C" int spn_p2i_max(const float* pts, const float* feat,
                           const int* binds, int n_points, int n_images, int h,
                           int w, float radius, int k, int th, int tw,
                           int per_item, float* out, int* ids, int* scratch,
                           unsigned long long* merge, void* stream) {
  if (n_points < 0 || n_images < 1 || h < 1 || w < 1 || k < 1 ||
      !(radius > 0.f) || per_item < 1 || !tiling_ok(n_points, n_images, h, w, k, th, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiling tl = tiling(n_images, h, w, k, th, tw);
  int* next = scratch;
  int* counts = scratch + 1;
  int* off = counts + tl.nbins + 1;
  int* item_off = off + tl.nbins + 1;
  int* entries = item_off + tl.nbins + 1;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (tl.nbins + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n_points > 0)
    bin_kernel<false><<<blocks_for(n_points), kThreads, 0, s>>>(
        pts, binds, n_points, n_images, h, w, radius, k, th, tw, tl.nty, tl.ntx,
        counts, nullptr);
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, tl.nbins, per_item, off, item_off);
  if (n_points > 0)
    bin_kernel<true><<<blocks_for(n_points), kThreads, 0, s>>>(
        pts, binds, n_points, n_images, h, w, radius, k, th, tw, tl.nty, tl.ntx,
        counts, entries);
  const int bin_blocks = std::min(tl.nbins, 132 * 16);
  if (ids) {
    split_prepare_kernel<true><<<bin_blocks, kThreads, 0, s>>>(
        item_off, tl.nbins, h, w, th, tw, tl.nty, tl.ntx, merge);
    e = launch_splat<true>(pts, feat, entries, off, item_off, tl, next, h, w,
                           radius, k, per_item, out, ids, merge, s);
    if (e != cudaSuccess) return (int)e;
    split_finish_kernel<<<bin_blocks, kThreads, 0, s>>>(
        item_off, tl.nbins, h, w, th, tw, tl.nty, tl.ntx, merge, out, ids);
  } else {
    unsigned* m = reinterpret_cast<unsigned*>(out);
    split_prepare_kernel<false><<<bin_blocks, kThreads, 0, s>>>(
        item_off, tl.nbins, h, w, th, tw, tl.nty, tl.ntx, m);
    e = launch_splat<false>(pts, feat, entries, off, item_off, tl, next, h, w,
                            radius, k, per_item, out, nullptr, m, s);
    if (e != cudaSuccess) return (int)e;
  }
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
