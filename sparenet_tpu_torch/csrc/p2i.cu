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
// The backward (spn_p2i_max_backward) computes the JAX package's
// _p2i_max_bwd (sparenet_tpu/ops/p2i.py), which XLA runs there: each point
// sums the gradient terms of the pixels its id won within its window, in
// row-major pixel order, with no atomics on floats (deterministic by
// construction). Bound: bytes, the
// ids and g of every pixel read once and 12 bytes in and out a point. A
// point's window is K^2 pixels (K = 2 ceil(R) + 2): scanning each window
// for the point's id reads ~K^2 ids a point, so the design turns the scan
// around:
//   1. bin (bwd_bin_kernel, bin_scan_kernel): a counting sort of the points
//      by the tile that holds their window's origin clipped to the image
//      (window_of, so far-off and NaN points cannot overflow); a point with
//      an invalid image index or an empty window gets zero gradients there
//      and is not binned; each bin's points split into work items of
//      per_item, and the scan maps each item to its bin;
//   2. tile pass (bwd_bits_kernel, a block of 512 threads an item): the
//      ids of the tile and a halo of K - 1 rows and columns (every window
//      that starts in the tile) come in by cp.async while the item's points
//      go into a hash table and a bit filter; a region pixel whose id is an
//      item's point, inside that point's window, sets its bit in the
//      point's window bitmask in shared memory; a warp scan of the
//      bitmasks' popcounts (a ballot a bit of the counts) places every hit
//      in row-major order a point; a thread a hit computes its terms (two
//      at once, their g loads together); a thread a point adds its terms in
//      order. Hits that do not fit at once go in rounds.
// Windows whose bitmask does not fit in shared memory take bwd_scan_kernel:
// a warp a point reads its window's ids where they lie, its lanes on a
// group of 32 / K rows, a ballot of the lanes holding its id, their terms
// at once, added in lane (row-major) order. spn_p2i_bwd_plan picks the
// tile, item and path.
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
// before bin b (ceil(count / per_item), at least min_items), both with
// their total at [nbins]; counts[b] becomes the scatter's cursor, off[b];
// item_bin (where given) the bin of each item.
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
bin_scan_kernel(int* __restrict__ counts, int nbins, int per_item, int min_items,
                int* __restrict__ off, int* __restrict__ item_off,
                int* __restrict__ item_bin) {
  __shared__ int warp_sums[32];
  int carry = 0, carry_items = 0;
  for (int base = 0; base < nbins; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const int c = b < nbins ? counts[b] : 0;
    const int items = b < nbins ? max(min_items, (c + per_item - 1) / per_item) : 0;
    int total, total_items;
    const int before = block_exclusive_scan(c, &total, warp_sums);
    const int before_items = block_exclusive_scan(items, &total_items, warp_sums);
    if (b < nbins) {
      off[b] = carry + before;
      item_off[b] = carry_items + before_items;
      counts[b] = carry + before;
      if (item_bin)
        for (int j = 0; j < items; ++j) item_bin[carry_items + before_items + j] = b;
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

// ---- backward ----

// The bin of a point's backward pass: the tile holding its window's origin
// clipped to the image; -1 where it adds nothing (image index outside
// [0, B), or a window that misses the image).
__device__ __forceinline__ int bwd_bin_of(const float* pts, const int* binds, int p,
                                          int n_images, int h, int w, float radius,
                                          int k, int th, int tw, int nty, int ntx) {
  const int bi = binds[p];
  if (bi < 0 || bi >= n_images) return -1;
  const Window win = window_of(pts[2 * (size_t)p], pts[2 * (size_t)p + 1], radius,
                               h, w, k);
  if (win.y0 >= win.y1 || win.x0 >= win.x1) return -1;
  return (bi * nty + win.y0 / th) * ntx + win.x0 / tw;
}

// The histogram (kScatter false) or the scatter (kScatter true, counts
// holding the cursors) of the points by bwd_bin_of, the lanes of a warp
// that share a bin adding to it once; the scatter writes zero gradients
// for the points it does not bin.
template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
bwd_bin_kernel(const float* __restrict__ pts, const int* __restrict__ binds,
               int n_points, int n_images, int h, int w, float radius, int k, int th,
               int tw, int nty, int ntx, int* __restrict__ counts,
               int* __restrict__ entries, float* __restrict__ gpts,
               float* __restrict__ gfeat) {
  const int lane = threadIdx.x & 31;
  for (int base = blockIdx.x * kThreads + (threadIdx.x & ~31); base < n_points;
       base += gridDim.x * kThreads) {
    const int p = base + lane;
    const int bin = p < n_points ? bwd_bin_of(pts, binds, p, n_images, h, w, radius,
                                              k, th, tw, nty, ntx)
                                 : -1;
    const unsigned group = __match_any_sync(spn::kFullMask, bin);
    const int leader = __ffs(group) - 1;
    int slot = 0;
    if (bin >= 0 && lane == leader) slot = atomicAdd(&counts[bin], __popc(group));
    if (kScatter) {
      slot = __shfl_sync(spn::kFullMask, slot, leader) +
             __popc(group & ((1u << lane) - 1));
      if (bin >= 0) {
        entries[slot] = p;
      } else if (p < n_points) {
        gpts[2 * (size_t)p] = 0.f;
        gpts[2 * (size_t)p + 1] = 0.f;
        gfeat[p] = 0.f;
      }
    }
  }
}

// A won pixel's gradient terms for its point (y, x, f), with g its
// gradient and r its distance:
//   d feat   += g * w(r)
//   d (y, x) += k * (dy, dx),  k = g f sin(pi r / R) (pi / 2R) / max(r, 1e-10)
// with dy = iy - y, dx = ix - x, each term in the plain version's order of
// operations on the card (ops/p2i.py:p2i_max_backward_plain; the JAX
// package's _p2i_max_bwd). Each point's terms are summed in row-major
// pixel order from +0 (the plain version's index_add_ sums them in its own
// order: the two agree to rounding).
struct Terms {
  float f, y, x;
};
__device__ __forceinline__ Terms pixel_terms(float gv, int iy, int ix, float y,
                                             float x, float f, float inv_r) {
  const float pi = 3.14159265358979323846f;
  const float dy = __fsub_rn((float)iy, y);
  const float dx = __fsub_rn((float)ix, x);
  const float r = pixel_distance(dy, dx);
  // a division by the scalar R is a product with 1 / R, as in PyTorch's
  // CUDA division by a host scalar
  const float sn = sinf(__fmul_rn(__fmul_rn(r, pi), inv_r));
  float kf = __fmul_rn(__fmul_rn(__fmul_rn(gv, f), sn), 0.5f);
  kf = __fdiv_rn(__fmul_rn(__fmul_rn(kf, pi), inv_r), fmaxf(r, 1e-10f));
  return {__fmul_rn(gv, cos_weight(r, inv_r)), __fmul_rn(kf, dy), __fmul_rn(kf, dx)};
}

// The points of a work item: entries [first, last) of its bin.
__device__ __forceinline__ void item_range(const int* off, const int* item_off,
                                           int bin, int item, int per_item,
                                           int& first, int& last) {
  first = off[bin] + (item - item_off[bin]) * per_item;
  last = min(off[bin + 1], first + per_item);
}

// One block a work item of the bitmask path. Shared memory (per_item
// points): each point's clipped window (y0, x0, y1, x1), its (y, x, f), its
// first hit and its three sums; an open-addressing table from point id to
// its place in the item (2^hash_bits slots, at least twice the item) and a
// 2^15-bit filter of the same ids (most region pixels belong to other
// items' points: one load rejects them); the window bitmasks, `words` ints
// a point (odd, at least K ceil(K / 32)): bit c % 32 of word r ceil(K / 32)
// + c / 32 is window row r, column c; and the region, the ids of the tile
// and its halo (row pitch tw + K - 1), copied in by cp.async, its space
// then reused for the hits of a round (hit_cap of them): (point, row << 16 |
// column) and three terms, 20 bytes a hit.
constexpr int kHitBytes = 20;
constexpr int kFilterWords = 1024;  // 2^15 bits
constexpr int kFilterBits = 15;
constexpr int kRegionUnroll = 4;  // region pixels a lane has in flight
constexpr int kBitsThreads = 512;
constexpr int kBitsWarps = kBitsThreads / 32;

__device__ __forceinline__ unsigned hash_slot(int q, int bits) {
  return ((unsigned)q * 2654435761u) >> (32 - bits);
}

__global__ void __launch_bounds__(kBitsThreads, 2)
bwd_bits_kernel(const float* __restrict__ pts, const float* __restrict__ feat,
                const int* __restrict__ ids, const float* __restrict__ g,
                const int* __restrict__ entries, const int* __restrict__ off,
                const int* __restrict__ item_off, const int* __restrict__ item_bin,
                int nbins, int h, int w, float radius, int k, int th, int tw, int nty,
                int ntx, int per_item, int words, int hash_bits, int hit_cap,
                float* __restrict__ gpts, float* __restrict__ gfeat) {
  extern __shared__ __align__(16) int sm[];
  __shared__ int sums[kBitsWarps];
  const int item = blockIdx.x;
  if (item >= item_off[nbins]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bin = item_bin[item];
  const Tile t = tile_of(bin, h, w, th, tw, nty, ntx);
  int first, last;
  item_range(off, item_off, bin, item, per_item, first, last);
  const int n = last - first;
  const int pitch = tw + k - 1;
  const int rows = min(t.y0 + th + k - 1, h) - t.y0, cols = min(t.x0 + pitch, w) - t.x0;
  const int n_slots = 1 << hash_bits;
  int4* win = reinterpret_cast<int4*>(sm);                     // [per_item]
  float4* pxf = reinterpret_cast<float4*>(win + per_item);     // [per_item]
  int2* table = reinterpret_cast<int2*>(pxf + per_item);       // [n_slots]
  unsigned* filter = reinterpret_cast<unsigned*>(table + n_slots);  // [kFilterWords]
  int* cnt = reinterpret_cast<int*>(filter + kFilterWords);    // [per_item]
  float* acc = reinterpret_cast<float*>(cnt + per_item);       // [3 per_item]
  unsigned* bits = reinterpret_cast<unsigned*>(acc + 3 * per_item);  // [per_item words]
  // [(th + k - 1) pitch], 16-byte aligned
  int* region = reinterpret_cast<int*>(bits + ((per_item * words + 3) & ~3));
  const int wpr = (k + 31) >> 5;  // words a window row
  // the region's ids, in flight while the points are read and the tables
  // cleared
  const int* img = ids + (size_t)t.bi * h * w;
  for (int r = warp; r < rows; r += kBitsWarps) {
    const int* src = img + (size_t)(t.y0 + r) * w + t.x0;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(region + r * pitch));
    for (int c = lane; c < cols; c += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4u * c),
                   "l"(src + c)
                   : "memory");
  }
  for (int j = tid; j < n; j += kBitsThreads) {
    const int p = entries[first + j];
    const float y = pts[2 * (size_t)p], x = pts[2 * (size_t)p + 1];
    const Window v = window_of(y, x, radius, h, w, k);
    win[j] = make_int4(v.y0, v.x0, v.y1, v.x1);
    pxf[j] = make_float4(y, x, feat[p], __int_as_float(p));
  }
  for (int q = tid; q < n_slots; q += kBitsThreads) table[q] = make_int2(-1, 0);
  for (int q = tid; q < kFilterWords; q += kBitsThreads) filter[q] = 0u;
  for (int q = tid; q < (n * words + 3) / 4; q += kBitsThreads)
    reinterpret_cast<uint4*>(bits)[q] = make_uint4(0u, 0u, 0u, 0u);
  for (int q = tid; q < 3 * n; q += kBitsThreads) acc[q] = 0.f;
  __syncthreads();
  for (int j = tid; j < n; j += kBitsThreads) {
    const int p = __float_as_int(pxf[j].w);
    unsigned at = hash_slot(p, hash_bits);
    while (atomicCAS(&table[at].x, -1, p) != -1) at = (at + 1) & (n_slots - 1);
    table[at].y = j;
    const unsigned f = hash_slot(p, kFilterBits);
    atomicOr(&filter[f >> 5], 1u << (f & 31));
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // each region pixel whose id is a point of the item, inside that point's
  // window, sets its bit; kRegionUnroll pixels of a row a lane at once
  for (int r = warp; r < rows; r += kBitsWarps) {
    for (int c0 = lane; c0 < cols; c0 += 32 * kRegionUnroll) {
      int q[kRegionUnroll];
      bool in[kRegionUnroll];
#pragma unroll
      for (int u = 0; u < kRegionUnroll; ++u) {
        const int c = c0 + 32 * u;
        q[u] = c < cols ? region[r * pitch + c] : -1;
      }
#pragma unroll
      for (int u = 0; u < kRegionUnroll; ++u) {
        const unsigned f = hash_slot(q[u], kFilterBits);
        in[u] = q[u] >= 0 && ((filter[f >> 5] >> (f & 31)) & 1u);
      }
#pragma unroll
      for (int u = 0; u < kRegionUnroll; ++u) {
        if (!in[u]) continue;
        unsigned at = hash_slot(q[u], hash_bits);
        int2 e = table[at];
        while (e.x != q[u] && e.x != -1) {
          at = (at + 1) & (n_slots - 1);
          e = table[at];
        }
        if (e.x != q[u]) continue;  // not a point of this item
        const int iy = t.y0 + r, ix = t.x0 + c0 + 32 * u;
        const int4 v = win[e.y];
        if (iy < v.x || iy >= v.z || ix < v.y || ix >= v.w) continue;
        const int cc = ix - v.y;
        atomicOr(&bits[e.y * words + (iy - v.x) * wpr + (cc >> 5)], 1u << (cc & 31));
      }
    }
  }
  __syncthreads();
  // the hits' places, by a scan of the popcounts of all the item's bitmask
  // words in memory order (point, row, column): each warp takes a run of
  // consecutive words, 32 at a time, a word a lane (no bank conflicts); a
  // point's first hit is its first word's
  const int n_words = n * words;
  const int per_warp = (n_words + 32 * kBitsWarps - 1) / (32 * kBitsWarps) * 32;
  const int ww0 = min(warp * per_warp, n_words), ww1 = min(ww0 + per_warp, n_words);
  {
    int tot = 0;
    for (int q = ww0 + lane; q < ww1; q += 32) tot += __popc(bits[q]);
    tot = __reduce_add_sync(spn::kFullMask, tot);
    if (lane == 0) sums[warp] = tot;
  }
  __syncthreads();
  int warp_first = 0, hits_total = 0;
  for (int q = 0; q < kBitsWarps; ++q) {
    warp_first += q < warp ? sums[q] : 0;
    hits_total += sums[q];
  }
  const float inv_words = 1.f / (float)words;
  // the hits in rounds of hit_cap: each warp writes the descriptors (point,
  // row << 16 | column) of its run's hits in the round, then a thread a hit
  // (two at once) computes its terms; then each point adds its hits' terms
  // in order. The first round also writes each point's first hit.
  int2* desc = reinterpret_cast<int2*>(region);
  float* tf = reinterpret_cast<float*>(desc + hit_cap);
  float* ty = tf + hit_cap;
  float* tx = ty + hit_cap;
  const float inv_r = __frcp_rn(radius);
  const float* gi = g + (size_t)t.bi * h * w;
  for (int h0 = 0; h0 < hits_total; h0 += hit_cap) {
    const int h1 = min(hits_total, h0 + hit_cap);
    int i0 = warp_first;
    const unsigned below = (1u << lane) - 1u;
    for (int q0 = ww0; q0 < ww1 && (h0 == 0 || i0 < h1); q0 += 32) {
      const int q = q0 + lane;
      unsigned m = q < ww1 ? bits[q] : 0u;
      const int c = __popc(m);  // 0 .. 32: six bits
      // the popcounts of the lanes below, and of all 32 lanes, bit by bit
      // of the counts (a ballot a bit; no chain of shuffles)
      int before = 0, group = 0;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        const unsigned v = __ballot_sync(spn::kFullMask, (c >> b) & 1);
        before += __popc(v & below) << b;
        group += __popc(v) << b;
      }
      int i = i0 + before;
      // q / words exactly: (q + 0.5) / words stays 0.5 / words from an integer
      const int j = (int)(((float)q + 0.5f) * inv_words), rem = q - j * words;
      if (h0 == 0 && q < ww1 && rem == 0) cnt[j] = i;
      if (m && i + c > h0 && i < h1) {
        const int r = rem / wpr, c0 = rem - r * wpr;
        while (m) {
          if (i >= h0 && i < h1)
            desc[i - h0] = make_int2(j, (r << 16) | (32 * c0 + __ffs(m) - 1));
          m &= m - 1;
          ++i;
        }
      }
      i0 += group;
    }
    __syncthreads();
    for (int q = tid; q < h1 - h0; q += 2 * kBitsThreads) {
      const int q2 = min(q + kBitsThreads, h1 - h0 - 1);  // the last hit past the end
      const int2 d = desc[q], d2 = desc[q2];
      const int4 v = win[d.x], v2 = win[d2.x];
      const float4 a = pxf[d.x], a2 = pxf[d2.x];
      const int iy = v.x + (d.y >> 16), ix = v.y + (d.y & 0xffff);
      const int iy2 = v2.x + (d2.y >> 16), ix2 = v2.y + (d2.y & 0xffff);
      const float gv = gi[(size_t)iy * w + ix], gv2 = gi[(size_t)iy2 * w + ix2];
      const Terms e = pixel_terms(gv, iy, ix, a.x, a.y, a.z, inv_r);
      const Terms e2 = pixel_terms(gv2, iy2, ix2, a2.x, a2.y, a2.z, inv_r);
      tf[q] = e.f;
      ty[q] = e.y;
      tx[q] = e.x;
      tf[q2] = e2.f;
      ty[q2] = e2.y;
      tx[q2] = e2.x;
    }
    __syncthreads();
    for (int j = tid; j < n; j += kBitsThreads) {
      const int lo = max(cnt[j], h0), hi = min(j + 1 < n ? cnt[j + 1] : hits_total, h1);
      if (lo >= hi) continue;
      float af = acc[3 * j], ay = acc[3 * j + 1], ax = acc[3 * j + 2];
      for (int q = lo - h0; q < hi - h0; ++q) {  // in row-major order
        af = __fadd_rn(af, tf[q]);
        ay = __fadd_rn(ay, ty[q]);
        ax = __fadd_rn(ax, tx[q]);
      }
      acc[3 * j] = af;
      acc[3 * j + 1] = ay;
      acc[3 * j + 2] = ax;
    }
    __syncthreads();
  }
  for (int j = tid; j < n; j += kBitsThreads) {
    const int p = __float_as_int(pxf[j].w);
    gpts[2 * (size_t)p] = acc[3 * j + 1];
    gpts[2 * (size_t)p + 1] = acc[3 * j + 2];
    gfeat[p] = acc[3 * j];
  }
}

// The path for windows whose bitmask does not fit: one block a work item, a
// warp a point, reading the window's ids from device memory.
__global__ void __launch_bounds__(kThreads)
bwd_scan_kernel(const float* __restrict__ pts, const float* __restrict__ feat,
                const int* __restrict__ ids, const float* __restrict__ g,
                const int* __restrict__ entries, const int* __restrict__ off,
                const int* __restrict__ item_off, const int* __restrict__ item_bin,
                int nbins, int h, int w, float radius, int k, int th, int tw, int nty,
                int ntx, int per_item, float* __restrict__ gpts,
                float* __restrict__ gfeat) {
  const int item = blockIdx.x;
  if (item >= item_off[nbins]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bin = item_bin[item];
  const int bi = bin / (nty * ntx);
  const int* img = ids + (size_t)bi * h * w;
  const float* gi = g + (size_t)bi * h * w;
  const float inv_r = __frcp_rn(radius);
  // the lane's place in a group of window rows: row dr, column dc
  const int kc = min(k, 32), rows_a_group = 32 / kc;
  const int dr = lane / kc, dc = lane % kc;
  const bool lane_on = dr < rows_a_group;
  int first, last;
  item_range(off, item_off, bin, item, per_item, first, last);
  for (int e = first + warp; e < last; e += kWarps) {
    const int p = entries[e];
    const float y = pts[2 * (size_t)p], x = pts[2 * (size_t)p + 1], f = feat[p];
    const Window v = window_of(y, x, radius, h, w, k);
    const int wy = v.y1 - v.y0, wx = v.x1 - v.x0;
    float af = 0.f, ay = 0.f, ax = 0.f;
    for (int r0 = 0; r0 < wy; r0 += rows_a_group) {
      const int r = r0 + dr;
      for (int c0 = 0; c0 < wx; c0 += 32) {
        const int c = c0 + dc;
        const int iy = v.y0 + r, ix = v.x0 + c;
        const bool hit = lane_on && r < wy && c < wx && img[(size_t)iy * w + ix] == p;
        unsigned m = __ballot_sync(spn::kFullMask, hit);
        if (!m) continue;
        Terms d{0.f, 0.f, 0.f};
        if (hit) d = pixel_terms(gi[(size_t)iy * w + ix], iy, ix, y, x, f, inv_r);
        while (m) {  // the hits in lane order: row-major
          const int b = __ffs(m) - 1;
          m &= m - 1;
          af = __fadd_rn(af, __shfl_sync(spn::kFullMask, d.f, b));
          ay = __fadd_rn(ay, __shfl_sync(spn::kFullMask, d.y, b));
          ax = __fadd_rn(ax, __shfl_sync(spn::kFullMask, d.x, b));
        }
      }
    }
    if (lane == 0) {
      gpts[2 * (size_t)p] = ay;
      gpts[2 * (size_t)p + 1] = ax;
      gfeat[p] = af;
    }
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
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, tl.nbins, per_item, 1, off,
                                              item_off, nullptr);
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

// Scratch ints spn_p2i_max_backward needs: the counts, the bin offsets and
// the item offsets (nbins + 1 each), the items' bins (at most nbins +
// ceil(P / per_item)) and the entries (one a point); -1 for a shape it
// refuses.
extern "C" long long spn_p2i_bwd_scratch_ints(int n_points, int n_images, int h,
                                              int w, int th, int tw, int per_item) {
  if (n_points < 0 || n_images < 1 || h < 1 || w < 1 || th < 1 || tw < 1 ||
      per_item < 1)
    return -1;
  const long long nbins =
      (long long)n_images * ((h + th - 1) / th) * ((w + tw - 1) / tw);
  if (nbins >= (1ll << 30)) return -1;
  return 3 * (nbins + 1) + nbins + (n_points + per_item - 1) / per_item +
         (long long)n_points;
}

namespace {

// The bitmask path's point table: 2^bits slots, at least twice the item.
int hash_bits_for(int per_item) {
  int b = 1;
  while ((1 << b) < 2 * per_item) ++b;
  return b;
}

// Shared memory a block of the bitmask path takes: per_item points'
// windows, (y, x, f), hit offsets, sums and bitmasks, the point table and
// filter, and the region (the ids of the tile and its halo) or the hits of
// a round, whichever is larger.
long long bwd_smem(int k, int th, int tw, int per_item, int words, int hit_cap) {
  return (long long)per_item * 48 + 4ll * ((per_item * (long long)words + 3) & ~3ll) +
         8ll * (1 << hash_bits_for(per_item)) + 4ll * kFilterWords +
         std::max(4ll * (th + k - 1) * (tw + k - 1), (long long)kHitBytes * hit_cap);
}

// The backward's plan: the bitmask path's tiles (tried in turn), the shared
// memory a block takes (and the most a forced item may take), the hits a
// point a round has room for, the fewest and most points a work item
// holds; and the points a work item of the scan path.
constexpr int kBwdTiles[2][2] = {{16, 64}, {8, 32}};
constexpr long long kBwdSmem = 73 * 1024, kBwdSmemMost = 226 * 1024;
constexpr int kBwdHits = 4;
constexpr int kBwdItemMin = 8, kBwdItemMax = 300, kBwdScanItem = 256;

}  // namespace

// The backward's plan for windows of K pixels a side. The bitmask path
// takes the first of kBwdTiles (or th x tw, where th > 0) on which a block
// of kBwdItemMin points (or `item`, where item > 0) fits in kBwdSmem (a
// forced item in kBwdSmemMost), with words = K ceil(K / 32) | 1 ints a
// point's window bitmask, room for kBwdHits hits a point a round, and the
// points an item that fill it (at most kBwdItemMax, or `item`). Where no
// tile fits, or scan != 0, the scan path: words 0, kBwdScanItem points an
// item (or `item`). out: {words, th, tw, per_item, hit_cap, smem bytes (0
// on the scan path)}.
extern "C" void spn_p2i_bwd_plan(int k, int th, int tw, int item, int scan,
                                 long long* out) {
  const int words = k * ((k + 31) / 32) | 1;
  for (int i = 0; i < (th > 0 ? 1 : 2) && !scan; ++i) {
    const int ty = th > 0 ? th : kBwdTiles[i][0], tx = th > 0 ? tw : kBwdTiles[i][1];
    const int least = item > 0 ? item : kBwdItemMin;
    if (bwd_smem(k, ty, tx, least, words, kBwdHits * least) >
        (item > 0 ? kBwdSmemMost : kBwdSmem))
      continue;
    int n = item > 0 ? item : kBwdItemMax;
    while (item <= 0 && bwd_smem(k, ty, tx, n, words, kBwdHits * n) > kBwdSmem) --n;
    const long long plan[6] = {words, ty, tx, n, kBwdHits * n,
                               bwd_smem(k, ty, tx, n, words, kBwdHits * n)};
    std::copy(plan, plan + 6, out);
    return;
  }
  const long long plan[6] = {0, th > 0 ? th : kBwdTiles[0][0],
                             th > 0 ? tw : kBwdTiles[0][1],
                             item > 0 ? item : kBwdScanItem, 0, 0};
  std::copy(plan, plan + 6, out);
}

// Gradients of sum(g * out) for the winner ids of a splat: g, ids
// [B, H, W] -> d points [P, 2], d feats [P] (every entry written). th x tw
// tiles, per_item points a work item; words > 0: the bitmask path with
// `words` ints a point (odd, at least K ceil(K / 32)) and hit_cap hits a
// round (bwd_smem bytes of shared memory a block, at most kBwdSmemMost);
// words = 0: the scan path. spn_p2i_bwd_plan gives them. scratch:
// spn_p2i_bwd_scratch_ints ints.
extern "C" int spn_p2i_max_backward(const float* pts, const float* feat,
                                    const int* binds, const int* ids,
                                    const float* g, int n_points, int n_images,
                                    int h, int w, float radius, int k, int th,
                                    int tw, int per_item, int words, int hit_cap,
                                    int* scratch, float* gpts, float* gfeat,
                                    void* stream) {
  const long long n_scratch =
      spn_p2i_bwd_scratch_ints(n_points, n_images, h, w, th, tw, per_item);
  const long long smem = bwd_smem(k, th, tw, per_item, words, hit_cap);
  if (n_points < 1 || k < 1 || !(radius > 0.f) || n_scratch < 0 ||
      n_scratch >= INT_MAX || words < 0 ||
      (words && (words < k * ((k + 31) / 32) || hit_cap < 1 || smem > kBwdSmemMost)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nty = (h + th - 1) / th, ntx = (w + tw - 1) / tw;
  const int nbins = n_images * nty * ntx;
  const int max_items = nbins + (n_points + per_item - 1) / per_item;
  int* counts = scratch;
  int* off = counts + nbins + 1;
  int* item_off = off + nbins + 1;
  int* item_bin = item_off + nbins + 1;
  int* entries = item_bin + max_items;
  cudaError_t e = cudaMemsetAsync(counts, 0, (nbins + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  bwd_bin_kernel<false><<<blocks_for(n_points), kThreads, 0, s>>>(
      pts, binds, n_points, n_images, h, w, radius, k, th, tw, nty, ntx, counts,
      nullptr, nullptr, nullptr);
  bin_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, nbins, per_item, 0, off,
                                              item_off, item_bin);
  bwd_bin_kernel<true><<<blocks_for(n_points), kThreads, 0, s>>>(
      pts, binds, n_points, n_images, h, w, radius, k, th, tw, nty, ntx, counts,
      entries, gpts, gfeat);
  if (words) {
    // the kernel may take all of an SM's shared memory (set once a device;
    // each launch's occupancy follows its own size)
    static std::map<int, bool> ready;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (!ready[dev]) {
      int optin = 0;
      cudaFuncAttributes fa;
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, bwd_bits_kernel);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(bwd_bits_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(bwd_bits_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
      ready[dev] = true;
    }
    bwd_bits_kernel<<<max_items, kBitsThreads, smem, s>>>(
        pts, feat, ids, g, entries, off, item_off, item_bin, nbins, h, w, radius, k,
        th, tw, nty, ntx, per_item, words, hash_bits_for(per_item), hit_cap, gpts,
        gfeat);
  } else {
    bwd_scan_kernel<<<max_items, kThreads, 0, s>>>(
        pts, feat, ids, g, entries, off, item_off, item_bin, nbins, h, w, radius, k,
        th, tw, nty, ntx, per_item, gpts, gfeat);
  }
  return (int)cudaGetLastError();
}
