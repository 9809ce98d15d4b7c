// One channel slice of a cloud's table resident in shared memory: the
// skeleton of the gather-max kernel (gather_max.cu) and of the edge-stats
// forward (edge_stats.cu). Both read, for every output row m of a cloud,
// its k neighbour rows r_j = table[b, idx[b, m, j]] and reduce them per
// channel in slot order.
//
// The Pallas kernels keep a cloud's whole [N, C] table VMEM-resident
// (sparenet_tpu/ops/pallas/gather_pallas.py, edge_train_pallas.py). A
// Hopper block holds one slice of it, table[b, :, c0:c0+W] (N x W x 4
// bytes: 192 KB at N = 3000 and W = 16), so each table byte comes from L2
// once a block, where a row-at-a-time gather reads a row once for each slot
// that names it (k = 8 times on average).
//
// A block is (cloud b, row group g, slice s), s fastest in launch order, so
// the blocks in flight share the 128-byte lines of the table's and the
// outputs' rows, and one cloud's data stays in L2. It
//   1. copies its slice in by cp.async (16 bytes a copy where C % 4 == 0
//      and the table is 16-byte aligned, else 4 bytes), with the neighbour
//      lists of its first two chunks of rows;
//   2. walks its group's rows in chunks of 128 rows (W / 4 threads a row,
//      4 channels a thread: one float4 of shared memory a slot), the lists
//      of chunk i + 2 copied in by cp.async while it works on chunk i (a
//      ring of kStages chunks in shared memory, one barrier a chunk);
//   3. for each row issues the k shared-memory reads together (k = 8 is
//      compiled with the reads unrolled; any other k runs a loop) and hands
//      them to the epilogue in slot order; the epilogue keeps its state in
//      registers and writes the row's W channels, W x 4 contiguous bytes at
//      stride C x 4, and closes the block (gather_max.cu's sum).
// The block cannot gather before its slice has arrived (neighbours are
// random), so its copy overlaps only with other blocks; at W = 16 an SM
// holds one block, and its gather, 8 x 64 bytes of shared memory a row, is
// bound by the shared memory's 128 bytes a clock and the issue rate. Random
// rows share banks: a quarter-warp's float4 reads cover 128 / (4 W) rows,
// which serialise where two start in the same bank group.
//
// make_plan fixes W, the row groups and the shared memory from the shape
// and the card; a shape reaches every plan (at k = 8 on an H100: W = 16
// up to N = 3440, W = 8 for C in 5..8 or N in 3441..6880, W = 4 for C <= 4
// or N in 6881..13760; row groups where the clouds' slices fill less than
// a wave, as at B <= 2 or at B = 4, C = 256). Past N = 13760 (N x 16
// bytes plus the list ring above the opt-in shared memory) it gives width
// 0, and each kernel takes its row-at-a-time path there.
#pragma once

#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"

namespace spn {
namespace slices {

constexpr int kLanes = 128;       // rows a chunk
constexpr int kStages = 3;        // chunks of neighbour lists in the ring
constexpr int kMaxWidth = 16;     // channels a slice: 4, 8 or 16
constexpr int kThreads = kLanes * kMaxWidth / 4;  // most threads a block

// What every block of a launch shares.
struct Shape {
  int n, m, c, k;
  int width;       // channels a slice
  int slices;      // ceil(C / width)
  int groups;      // row groups a cloud
  int group_rows;  // rows a group (the last may hold fewer)
  bool vec;        // 16-byte copies of the slice and 16-byte output stores
  bool idx_vec;    // 16-byte copies of the neighbour lists
};

struct Plan {
  int width;       // 0: the shape takes the row-at-a-time kernels
  int groups;
  int group_rows;
  int threads;     // 32 x width: width / 4 threads a row, kLanes rows
  int lanes;       // kLanes
  int smem;        // bytes of dynamic shared memory a block
  int blocks;      // batch x groups x slices
};

// What make_plan reads of a card, asked once a device.
struct Card {
  int sms, optin, per_sm_smem;
};

inline cudaError_t card_of(int dev, Card* out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static Card cards[kMaxDevices];
  static bool known[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!known[dev]) {
    Card c{};
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&c.per_sm_smem,
                                      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) != cudaSuccess)
      return err;
    cards[dev] = c;
    known[dev] = true;
  }
  *out = cards[dev];
  return cudaSuccess;
}

// floats of the slice (or, for a short table, of the sum's kLanes x width
// reduction), then ints of the list ring
inline size_t smem_bytes(int n, int k, int width) {
  return sizeof(float) *
         ((size_t)std::max(n, kLanes) * width + (size_t)kStages * kLanes * k);
}

// The widest of W = 16, 8, 4 that fits the card's shared memory and that C
// fills more than half of; 0 where none fits.
inline int pick_width(int n, int c, int k, int optin) {
  for (int w = kMaxWidth; w >= 4; w /= 2)
    if (smem_bytes(n, k, w) <= (size_t)optin && (w == 4 || c > w / 2)) return w;
  return 0;
}

// The launch plan of a [B, N, C] table and [B, M, k] lists on the current
// card: pick_width's W, and as many row groups as the card holds in one
// wave of blocks beside the clouds' slices (at least one).
inline cudaError_t make_plan(int batch, int n, int m, int c, int k, Plan* p) {
  *p = Plan{};
  if (batch < 1 || n < 1 || m < 1 || c < 1 || k < 1) return cudaErrorInvalidValue;
  int dev = 0;
  Card card;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess || (err = card_of(dev, &card)) != cudaSuccess)
    return err;
  const int w = pick_width(n, c, k, card.optin);
  if (w == 0) return cudaSuccess;
  const int threads = kLanes * w / 4;
  const int chunks = (m + kLanes - 1) / kLanes;
  const int smem = (int)smem_bytes(n, k, w);
  const int reserved = 1024;  // shared memory the runtime keeps a block
  const long long wave =
      (long long)card.sms *
      std::max(1, std::min(2048 / threads, card.per_sm_smem / (smem + reserved)));
  const long long clouds_slices = (long long)batch * ((c + w - 1) / w);
  const int g = std::max(1, (int)std::min<long long>(wave / clouds_slices, chunks));
  const int group_rows = kLanes * ((chunks + g - 1) / g);
  const int groups_made = (m + group_rows - 1) / group_rows;
  const long long blocks = (long long)batch * groups_made * ((c + w - 1) / w);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  *p = Plan{w, groups_made, group_rows, threads, kLanes, smem, (int)blocks};
  return cudaSuccess;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four channels at p: one 16-byte store, or the first `valid` one at a time
__device__ __forceinline__ void st4(float* p, float4 v, int valid, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    if (valid > 0) p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}

// Where a thread's work lies: cloud, row group, row lane q (rows
// row0 + q, row0 + q + kLanes, ...), first channel.
struct Place {
  int b, g, q, ch;
};

// The pass over the block's rows. Epi provides
//   first(float4 r0), next(int j, float4 rj)  -- a row's slots in order;
//   store(size_t o, int valid, bool vec)      -- the row's outputs at o;
//   close(const Shape&, const Place&, float* smem) -- after the rows, on
//     every thread (the slice's space is free after a barrier).
// Every thread of the block calls it and returns from it together.
template <int K, class Epi>
__device__ __forceinline__ void pass(const float* __restrict__ table,
                                     const int* __restrict__ idx,
                                     const Shape& sh, float* smem, Epi& epi) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int shift = __ffs(sh.width >> 2) - 1;  // log2 of the threads a row
  constexpr int lanes = kLanes;
  const int q = tid >> shift, v = tid & ((sh.width >> 2) - 1);
  int bx = blockIdx.x;
  const int s = bx % sh.slices;
  bx /= sh.slices;
  const int g = bx % sh.groups, b = bx / sh.groups;
  const int c0 = s * sh.width;
  const int row0 = g * sh.group_rows;
  const int row1 = min(row0 + sh.group_rows, sh.m);
  const int chunks = (row1 - row0 + lanes - 1) / lanes;
  const int k = K > 0 ? K : sh.k;
  float* slice = smem;
  int* ring = reinterpret_cast<int*>(smem + (size_t)max(sh.n, lanes) * sh.width);
  const int slot = lanes * k;

  // 1. the slice: table[b, :, c0:c0+W], channels past C left unwritten
  {
    const float* tb = table + (size_t)b * sh.n * sh.c + c0;
    const int pieces = sh.n << shift;
    for (int e = tid; e < pieces; e += nthreads) {
      const int r = e >> shift, u = e & ((sh.width >> 2) - 1);
      float* dst = slice + r * sh.width + 4 * u;
      const float* src = tb + (size_t)r * sh.c + 4 * u;
      const int left = sh.c - c0 - 4 * u;
      if (sh.vec) {
        if (left > 0) cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < left) cp_async4(dst + i, src + i);
      }
    }
  }
  auto lists = [&](int chunk) {  // chunk's neighbour lists into its ring slot
    const int r0 = row0 + chunk * lanes;
    const int count = min(lanes, row1 - r0) * k;
    const int* src = idx + ((size_t)b * sh.m + r0) * k;
    int* dst = ring + (chunk % kStages) * slot;
    if (sh.idx_vec) {
      for (int e = tid; e < count / 4; e += nthreads) cp_async16(dst + 4 * e, src + 4 * e);
    } else {
      for (int e = tid; e < count; e += nthreads) cp_async4(dst + e, src + e);
    }
  };
  lists(0);
  cp_async_commit();
  if (chunks > 1) lists(1);
  cp_async_commit();

  // 2. the rows, a chunk at a time
  const float* sv = slice + 4 * v;
  const int ch = c0 + 4 * v;
  const int valid = min(4, sh.c - ch);
  const size_t ob = (size_t)b * sh.m * sh.c + ch;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<1>();  // all but the newest group: the slice and this chunk
    __syncthreads();     // ... from every thread; chunk - 1's slot is free
    if (chunk + 2 < chunks) lists(chunk + 2);
    cp_async_commit();
    const int row = row0 + chunk * lanes + q;
    if (row >= row1) continue;
    const int* ir = ring + (chunk % kStages) * slot + q * k;
    if constexpr (K > 0) {
      int j_[K];
      if constexpr (K % 4 == 0) {
#pragma unroll
        for (int j = 0; j < K; j += 4) {
          const int4 t = *reinterpret_cast<const int4*>(ir + j);
          j_[j] = t.x, j_[j + 1] = t.y, j_[j + 2] = t.z, j_[j + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) j_[j] = ir[j];
      }
      float4 r[K];
#pragma unroll
      for (int j = 0; j < K; ++j) r[j] = ld4(sv + j_[j] * sh.width);
      epi.first(r[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) epi.next(j, r[j]);
    } else {
      epi.first(ld4(sv + ir[0] * sh.width));
      for (int j = 1; j < k; ++j) epi.next(j, ld4(sv + ir[j] * sh.width));
    }
    if (valid > 0) epi.store(ob + (size_t)row * sh.c, valid, sh.vec);
  }
  cp_async_wait<0>();
  epi.close(sh, Place{b, g, q, ch}, smem);
}

// Raise a kernel's shared-memory limit to the card's opt-in most, which
// every plan fits, on its first launch on a device.
inline cudaError_t raise_smem_once(const void* kernel, int dev, int bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;  // (kernel, device)
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.emplace_back(kernel, dev);
  return err;
}

// Launch kernel<<<p.blocks, p.threads, p.smem>>>(args...).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), const Plan& p, cudaStream_t st,
                   A... args) {
  int dev = 0;
  Card card;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = card_of(dev, &card)) != cudaSuccess ||
      (err = raise_smem_once(reinterpret_cast<const void*>(kernel), dev,
                             card.optin)) != cudaSuccess)
    return err;
  kernel<<<p.blocks, p.threads, p.smem, st>>>(args...);
  return cudaGetLastError();
}

inline Shape shape_of(const Plan& p, int n, int m, int c, int k, bool vec,
                      const int* idx) {
  return Shape{n, m, c, k, p.width, (c + p.width - 1) / p.width, p.groups,
               p.group_rows, vec,
               k % 4 == 0 && reinterpret_cast<size_t>(idx) % 16 == 0};
}

}  // namespace slices
}  // namespace spn
