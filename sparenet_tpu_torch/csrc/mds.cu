// Exact greedy minimum-density sampling, and its continuation.
//   xyz [B, N, 3] f32, t [B] f32 (t = 5 * mean_mst_length^2)
//   -> idx [B, npoint] int32
// Pick 0 is point 0, pinned to 1e9. Each step adds w * exp(-d2 / t) to every
// density, d2 being the squared distance to the previous pick and w = 2 for
// index >= 8192 (else 1); the next pick is the lowest-index argmin, and it
// is pinned to 1e9.
//
// Replaces: sparenet_tpu/ops/pallas/mds_pallas.py:mds_pallas (via
// _run_stage). Semantics: sparenet_tpu/ops/mds.py:_mds_one. The TPU kernel's
// 2^40 pin encoding and exp2 bias form are workarounds for that chip and
// are not carried over; its staged lane compaction is (below).
//
// The continuation (kernel #5, spn_mds_continue) is the same kernel in its
// kCont mode:
//   xyz [B, N, 3] live-lane coordinates, temp0 [B, N] densities with every
//   earlier bump applied, orig [B, N] int32 original index (>= 8192: weight
//   2), t [B] -> lane indices [B, steps] int32.
// Replaces: sparenet_tpu/ops/pallas/mds_pallas.py:mds_pallas_continue (via
// _run_stage), the exact tail of the hybrid schedule (ops/mds.py:
// _mds_hybrid). Semantics: that function's XLA tail. The state starts at
// temp0 (no pick 0, no pending bump before the first argmin), the weights
// come from orig, and each step takes the lowest-lane argmin (a NaN density
// first, before -inf), pins it to 1e9 and adds w * exp(-d2 / t) to every
// density. The lanes are the points of the greedy kernel: lane i is "point"
// i, and every C gives the picks of C = 1 as there. The caller compacts the
// lanes with a stable sort, so the lowest lane is the lowest original index
// and the picks are those of the full-width tail. Coordinates stay f32 (the
// TPU kernel's bf16 coordinates under fast math are not carried).
//
// Bound on an H100: latency of a chain of npoint-1 dependent steps, each an
// N-wide update (an exp per point) and an argmin over the cloud. No work
// crosses clouds, so a batch of B clouds has B chains; one SM a cloud keeps
// only B of the 132 SMs busy.
//
// Design: one cloud on a thread-block cluster of C CTAs (C <= 16). Among
// the shapes at which all B clusters are resident at once
// (cudaOccupancyMaxActiveClusters), one or two CTAs an SM, the launch takes
// the one with the fewest points an SM (choose_shape: C = 16 at B = 4,
// every cloud on its own 16 SMs). Points go to the
// CTAs in chunks of 32: point i to CTA (i / 32) mod C, so the picks spread
// evenly. In a CTA of 512 threads, local point p = l * 512 + t is lane l of
// thread t; lanes ascend in the original index. A thread keeps z and the
// density of its lanes in registers, x and y (and each slot's original
// lane) in shared memory. A step:
//   1. the lane pass: each lane gains its bump (the pick of the previous
//      step pinned lazily to 1e9 first, which gives the same densities as
//      pinning it at the end of its own step), and the thread keeps its
//      lowest-index argmin;
//   2. a warp argmin on (density, original index) in lexicographic order
//      (two redux.sync: the density's bits as an ordered integer, then the
//      least index among the lanes holding that minimum), the 16 warp
//      winners in shared memory, ONE __syncthreads, then every warp reduces
//      the 16: each knows the CTA's winner;
//   3. the warp holding it writes the record (density, index, x, y, z) into
//      slot `rank` of every peer CTA's shared memory (distributed shared
//      memory) with st.async, which completes 32 bytes of the peer's
//      mbarrier transaction count; the slots and mbarriers are
//      double-buffered by step parity;
//   4. each CTA waits on its own mbarrier for its C records (no cluster
//      barrier a step), then reduces them in the same order, so each has
//      the pick and its coordinates without reading another CTA's points.
// A CTA arms its mbarrier for a step (expect 32 C bytes) before or after
// records for that step arrive (the count may go below zero meanwhile).
// Double buffering is enough: a peer sends step j + 2's record only after
// it has every CTA's step j + 1 record, which a CTA sends after it has
// read its step j records and waited on step j's phase.
// The argmin compares (density, original index) lexicographically at every
// level, so the picks do not depend on C: every C gives the picks of C = 1.
//
// Staged compaction (as the TPU kernel's, per thread): every `stage` steps
// each thread packs its live lanes (not yet picked) to the front, stably,
// in registers (a select network) and in its shared-memory column, with
// the original lane kept beside each slot; its lane loop then ends at the
// warp's largest live count. A picked lane's density is >= 1e9 and it is
// never the argmin again unless a density is NaN, so compaction is on only
// where no NaN can arise: t finite and > 0, and every coordinate of the
// cloud finite (agreed over the cluster before the first step). The
// continuation also needs every density of temp0 below 5e8 (so no NaN
// there either): a live lane then stays below 5.003e8 over its at most 2^14
// steps of bumps of at most 2 (each add rounds by at most 16), below any
// picked lane; a temp0 of 1e9 or inf could lose to a picked lane, and a
// picked lane be picked again.
//
// The density arithmetic is IEEE and unfused where the reference is: d2 is
// the fma chain of sqdist3, then (-d2) / t, expf (no fast math) flushed to
// 0 below the smallest normal float (the reference's XLA CPU and TPU
// programs have no subnormals), w * e, and one add.
#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;         // points a chunk; chunk i to CTA i mod C
constexpr int kMaxCluster = 16;
constexpr int kMaxLanes = 40;      // lanes a thread: 20480 points a CTA
constexpr int kHeavyFrom = 8192;
constexpr float kBig = 1e9f;
// the continuation compacts only when every density of temp0 is below this
constexpr float kLiveBelow = 5e8f;
constexpr float kTiny = 1.17549435e-38f;  // smallest normal float
// dynamic shared memory of a CTA at least: more than half an SM's, so one
// CTA an SM and a cloud spreads over C SMs; or more than a third, so at
// most two (where the registers allow two)
constexpr int kMinSmem = 116 * 1024;
constexpr int kMinSmem2 = 77 * 1024;

// The argmin's comparison value: a NaN density is the minimum (the first
// NaN wins, as argmin in the reference and in PyTorch). Densities turn NaN
// when t = 0, i.e. a cloud whose mml estimate is 0 (every primitive
// collapsed onto one point); the greedy kernel's densities are >= 0, never
// -inf (the continuation's temp0 may hold -inf: cont_key).
__device__ __forceinline__ float nan_first(float v) {
  return isnan(v) ? -__int_as_float(0x7f800000) : v;
}

// The argmin key as an unsigned integer in the float order (the key is
// never NaN: nan_first maps NaN to -inf), so that a warp's minimum is one
// redux.sync.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The continuation's argmin key: a NaN density below every other, -inf
// included (0 is the ordered key of no float that is not NaN), and -0 equal
// to +0 (adding +0 turns -0 into +0), as argmin compares them.
__device__ __forceinline__ unsigned cont_key(float v) {
  return isnan(v) ? 0u : order_key(__fadd_rn(v, 0.f));
}

// Warp-wide lexicographic (key, index) minimum; every lane ends with it.
__device__ __forceinline__ void warp_lexmin(unsigned& key, int& idx) {
  const unsigned k = __reduce_min_sync(spn::kFullMask, key);
  idx = __reduce_min_sync(spn::kFullMask, key == k ? idx : INT_MAX);
  key = k;
}

// original index of lane l of thread t in CTA `rank` of a C-CTA cluster
__device__ __forceinline__ int orig_index(int l, int t, int rank, int c) {
  const int p = l * kThreads + t;
  return ((p / kChunk) * c + rank) * kChunk + (p % kChunk);
}

using u64 = unsigned long long;

// The record exchange: st.async into a peer's shared memory, completing
// its mbarrier's transaction count; each CTA waits on its own mbarrier.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(unsigned addr, uint4 v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
      "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void expect_bytes(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool try_wait_parity(unsigned mbar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(mbar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// A step's wait longer than this means a record was lost (a step takes
// about a microsecond): the kernel traps, the launch fails with an error
// and the process's CUDA context is lost, rather than spinning forever.
constexpr u64 kWaitNs = 10000000000ull;
// Spin until the mbarrier's phase of this parity completes (acquiring the
// cluster's writes); the clock is read once the first try fails and
// checked every 256 tries after.
__device__ __forceinline__ void wait_phase(unsigned mbar, unsigned parity) {
  if (try_wait_parity(mbar, parity)) return;
  const u64 start = global_ns();
  for (unsigned tries = 1;; ++tries) {
    if (try_wait_parity(mbar, parity)) return;
    if ((tries & 255u) == 0 && global_ns() - start > kWaitNs) __trap();
  }
}

// kMode: kPicks, the MDS; kFloor, the same chain of steps with no lane pass
// (each thread offers its first lane): the latency floor; kCtaFloor, as
// kFloor without the record exchange and its wait (each CTA
// takes its own winner after its __syncthreads): the CTA's share of it.
// kCont: the continuation (temp0, orig; npoint is its step count).
enum { kPicks = 0, kFloor = 1, kCtaFloor = 2 };

template <int L, int kMode, bool kCont>
__global__ void __launch_bounds__(kThreads, 1)
mds_cluster_kernel(const float* __restrict__ xyz, const float* __restrict__ temp0,
                   const int* __restrict__ orig, const float* __restrict__ tparam,
                   int n, int npoint, int stage, int* __restrict__ out) {
  extern __shared__ float2 sxy[];  // [L * 512] (x, y) of each slot
  unsigned char* sorig = reinterpret_cast<unsigned char*>(sxy + L * kThreads);
  __shared__ unsigned wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ float4 rec[2][kMaxCluster][2];  // (key, index, x, y), (z, -, -, -)
  __shared__ int flags[kMaxCluster];
  __shared__ __align__(8) u64 mbar[2];        // rec[p] complete: C records

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float* p = xyz + (size_t)b * n * 3;
  int* ob = out + (size_t)b * npoint;

  float z[L], temp[L];
  u64 heavy = 0;  // bit l: lane l weighs 2
  int mylive = 0;  // lanes 0..mylive-1 hold points (they ascend in index)
  bool finite = true;  // and, continuing, every density below kLiveBelow
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = orig_index(l, tid, rank, nc);
    const bool valid = i < n;
    const float x = valid ? p[3 * i + 0] : 0.f, y = valid ? p[3 * i + 1] : 0.f;
    z[l] = valid ? p[3 * i + 2] : 0.f;
    finite = finite && isfinite(x) && isfinite(y) && isfinite(z[l]);
    sxy[l * kThreads + tid] = make_float2(x, y);
    sorig[l * kThreads + tid] = (unsigned char)l;
    if (kCont) {
      temp[l] = valid ? temp0[(size_t)b * n + i] : 0.f;
      finite = finite && temp[l] < kLiveBelow;
    } else {
      temp[l] = (i == 0) ? kBig : 0.f;
    }
    if (valid) {
      mylive = l + 1;
      if ((kCont ? orig[(size_t)b * n + i] : i) >= kHeavyFrom) heavy |= 1ull << l;
    }
  }
  const float t = tparam[b];
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&mbar[i])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  finite = __syncthreads_and(finite);
  cluster.sync();  // every CTA of the cluster runs: its shared memory is live
  if (tid < nc) *cluster.map_shared_rank(&flags[rank], tid) = finite ? 1 : 0;
  cluster.sync();
  bool compact = stage > 0 && isfinite(t) && t > 0.f;
  for (int r = 0; r < nc; ++r) compact = compact && flags[r] != 0;

  int until = stage;                         // steps to the next compaction
  u64 dead = 0;                              // picked lanes, until compacted
  // lane to pin this step: the greedy kernel's point 0
  int pin = (!kCont && rank == 0 && tid == 0) ? 0 : -1;
  if (pin == 0) dead = 1;
  int wlive = __reduce_max_sync(spn::kFullMask, mylive);
  float lx = kCont ? 0.f : p[0], ly = kCont ? 0.f : p[1], lz = kCont ? 0.f : p[2];
  int prev = 0;  // the floor modes' last winner
  if (!kCont && rank == 0 && tid == 0) ob[0] = 0;

  // step j picks output j (the continuation's output j - 1, with no bump
  // at j = 1)
  const int end = kCont ? npoint + 1 : npoint;
  for (int j = 1; j < end; ++j) {
    const int par = j & 1;
    const unsigned my_mbar = smem_addr(&mbar[par]);
    if (kMode != kCtaFloor && tid == 0) expect_bytes(my_mbar, 32u * nc);
    if (compact && --until == 0) {  // every stage steps: j = stage, 2 stage, ...
      until = stage;
      const u64 present = mylive >= 64 ? ~0ull : (1ull << mylive) - 1;
      const u64 live = present & ~dead;
      int d = 0;
      for (u64 m = live; m; m &= m - 1, ++d) {  // shared-memory column
        const int l = __ffsll((long long)m) - 1;
        if (l != d) {
          sxy[d * kThreads + tid] = sxy[l * kThreads + tid];
          sorig[d * kThreads + tid] = sorig[l * kThreads + tid];
        }
      }
      u64 m = live, hv = 0;
#pragma unroll
      for (int dd = 0; dd < L; ++dd) {  // registers, in place: src >= dd
        const int src = m ? __ffsll((long long)m) - 1 : -1;
        m &= m - 1;
#pragma unroll
        for (int l = dd + 1; l < L; ++l) {
          if (src == l) {
            z[dd] = z[l];
            temp[dd] = temp[l];
          }
        }
        if (src >= 0) hv |= ((heavy >> src) & 1ull) << dd;
      }
      heavy = hv;
      mylive = d;
      dead = 0;
      pin = -1;  // the lane to pin was picked, so it is gone
      wlive = __reduce_max_sync(spn::kFullMask, mylive);
    }

    float bv = inf, bz = 0.f;
    unsigned bk = ~0u;  // the continuation's key of bv
    int bl = -1;
    if (kMode != kPicks) {
      if (mylive > 0) {  // a key that depends on the last step's winner
        bv = (float)((prev + tid) & 7);
        bk = order_key(bv);
        bl = 0;
      }
    } else {
      const bool bump = !kCont || j > 1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (l >= wlive) break;
        if (l < mylive) {
          float tv = temp[l];
          if (bump) {
            const float2 q = sxy[l * kThreads + tid];
            const float d2 = spn::sqdist3(q.x - lx, q.y - ly, z[l] - lz);
            float e = expf(__fdiv_rn(-d2, t));
            if (e < kTiny) e = 0.f;
            const float w = ((heavy >> l) & 1ull) ? 2.f : 1.f;
            tv = __fadd_rn(l == pin ? kBig : tv, __fmul_rn(w, e));
            temp[l] = tv;
          }
          if (kCont) {
            const unsigned key = cont_key(tv);
            if (key < bk) {  // lanes ascend in index: strict < keeps the lowest
              bk = key;
              bl = l;
              bz = z[l];
            }
          } else {
            const float key = nan_first(tv);
            if (key < bv) {  // lanes ascend in index: strict < keeps the lowest
              bv = key;
              bl = l;
              bz = z[l];
            }
          }
        }
      }
    }
    const int bi = bl >= 0 ? orig_index(sorig[bl * kThreads + tid], tid, rank, nc)
                           : INT_MAX;
    unsigned v = kCont ? bk : order_key(bv);
    int vi = bi;
    warp_lexmin(v, vi);
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = vi;
    }
    __syncthreads();
    v = lane < kWarps ? wv[lane] : ~0u;
    vi = lane < kWarps ? wi[lane] : INT_MAX;
    warp_lexmin(v, vi);  // every warp: the CTA's winner (v, vi)
    if (kMode == kCtaFloor) {
      prev = vi;
      continue;
    }

    // the warp holding it sends the record to every CTA of the cluster
    const unsigned who = __ballot_sync(spn::kFullMask, vi != INT_MAX && bi == vi);
    if (who != 0 || (vi == INT_MAX && warp == 0)) {
      float2 xy = make_float2(0.f, 0.f);
      float wz = 0.f;
      if (who != 0) {
        const int src = __ffs(who) - 1;
        if (lane == src) xy = sxy[bl * kThreads + tid];
        xy.x = __shfl_sync(spn::kFullMask, xy.x, src);
        xy.y = __shfl_sync(spn::kFullMask, xy.y, src);
        wz = __shfl_sync(spn::kFullMask, bz, src);
      }
      if (lane < nc) {
        const unsigned dst = peer_addr(smem_addr(&rec[par][rank][0]), lane);
        const unsigned mb = peer_addr(my_mbar, lane);
        st_async(dst, make_uint4(v, (unsigned)vi, __float_as_uint(xy.x),
                                 __float_as_uint(xy.y)), mb);
        st_async(dst + 16, make_uint4(__float_as_uint(wz), 0u, 0u, 0u), mb);
      }
    }
    wait_phase(my_mbar, ((j - 1) >> 1) & 1);

    const float4 mine = lane < nc ? rec[par][lane][0]
                                  : make_float4(__uint_as_float(~0u), __int_as_float(INT_MAX), 0.f, 0.f);
    const int ri = __float_as_int(mine.y);
    unsigned kv = __float_as_uint(mine.x);
    int pick = ri;
    warp_lexmin(kv, pick);
    const int src = __ffs(__ballot_sync(spn::kFullMask, lane < nc && ri == pick)) - 1;
    const float4 r0 = rec[par][src][0];
    lx = r0.z;
    ly = r0.w;
    lz = rec[par][src][1].x;
    pin = (bl >= 0 && bi == pick) ? bl : -1;
    if (pin >= 0) dead |= 1ull << pin;
    if (rank == 0 && tid == 0) ob[kCont ? j - 1 : j] = pick;
    prev = pick;
  }
  cluster.sync();  // no CTA leaves while a peer may still write to it
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// lanes a thread that CTA 0 (which holds the most) needs at cluster size c
int lanes_needed(int n, int c) {
  const int chunks = (n + kChunk - 1) / kChunk;
  const int local = (chunks + c - 1) / c * kChunk;
  return (local + kThreads - 1) / kThreads;
}

// the instantiated lane count for `need` lanes (0: none holds them)
int lanes_built(int need) {
  for (int l : {2, 4, 8, 16, 24, kMaxLanes})
    if (need <= l) return l;
  return 0;
}

// A launch's shape: C CTAs a cloud, at most `per_sm` CTAs an SM (the
// dynamic shared memory is padded so that no more fit).
struct Shape {
  int c, per_sm;
};

// The kernel's inputs: temp0 and orig are null but in the continuation;
// npoint is the continuation's step count.
struct Args {
  const float *xyz, *temp0;
  const int* orig;
  const float* t;
  int batch, n, npoint, stage;
  int* out;
};

template <int L, int kMode, bool kCont>
struct Cluster {
  static auto kernel() { return mds_cluster_kernel<L, kMode, kCont>; }
  static int smem(int per_sm) {
    const int need = L * kThreads * (int)(sizeof(float2) + 1);
    const int pad = per_sm == 1 ? kMinSmem : kMinSmem2;
    return need > pad ? need : pad;
  }
  static cudaError_t prepare() {
    cudaError_t err = cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem(1));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }
  static void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                     Shape sh, int batch, cudaStream_t st) {
    cfg = {};
    cfg.gridDim = dim3(sh.c, batch);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem(sh.per_sm);
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = sh.c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  // clusters of this shape that can be resident at once (0 where an SM
  // cannot hold per_sm CTAs)
  static int resident(Shape sh, int batch) {
    if (prepare() != cudaSuccess) return 0;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel(), kThreads,
                                                      smem(sh.per_sm)) != cudaSuccess ||
        blocks < sh.per_sm) {
      cudaGetLastError();
      return 0;
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(cfg, attr, sh, batch, nullptr);
    int num = 0;
    if (cudaOccupancyMaxActiveClusters(&num, kernel(), &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size the card refuses: clear its error
      return 0;
    }
    return num;
  }
  static int launch(const Args& a, Shape sh, cudaStream_t st) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(cfg, attr, sh, a.batch, st);
    err = cudaLaunchKernelEx(&cfg, kernel(), a.xyz, a.temp0, a.orig, a.t, a.n,
                             a.npoint, a.stage, a.out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

template <int kMode, bool kCont>
int resident_clusters(int lanes, Shape sh, int batch) {
  switch (lanes) {
    case 2: return Cluster<2, kMode, kCont>::resident(sh, batch);
    case 4: return Cluster<4, kMode, kCont>::resident(sh, batch);
    case 8: return Cluster<8, kMode, kCont>::resident(sh, batch);
    case 16: return Cluster<16, kMode, kCont>::resident(sh, batch);
    case 24: return Cluster<24, kMode, kCont>::resident(sh, batch);
    default: return Cluster<kMaxLanes, kMode, kCont>::resident(sh, batch);
  }
}

template <int kMode, bool kCont>
int launch_cluster(const Args& a, Shape sh, cudaStream_t st) {
  switch (lanes_built(lanes_needed(a.n, sh.c))) {
    case 2: return Cluster<2, kMode, kCont>::launch(a, sh, st);
    case 4: return Cluster<4, kMode, kCont>::launch(a, sh, st);
    case 8: return Cluster<8, kMode, kCont>::launch(a, sh, st);
    case 16: return Cluster<16, kMode, kCont>::launch(a, sh, st);
    case 24: return Cluster<24, kMode, kCont>::launch(a, sh, st);
    case kMaxLanes: return Cluster<kMaxLanes, kMode, kCont>::launch(a, sh, st);
    default: return (int)cudaErrorInvalidValue;  // c CTAs cannot hold n points
  }
}

// The launch shape for B clouds of N points (N lanes, continuing): among
// the shapes (C <= 16 and at most one CTA a chunk; 1 or 2 CTAs an SM) at
// which all B clusters are resident at once, the one with the fewest points
// an SM, per_sm x (points a CTA), then the fewer CTAs an SM, then the
// larger C; where none is, the smallest C that holds N at one CTA an SM
// (the clusters then run in waves). Cached per (device, B, N, mode).
template <bool kCont>
Shape choose_shape(int batch, int n) {
  static std::map<std::tuple<int, int, int>, Shape> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, batch, n);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  const int chunks = (n + kChunk - 1) / kChunk;
  int smallest = 0;
  for (int c = 1; c <= kMaxCluster; ++c)
    if (lanes_built(lanes_needed(n, c))) {
      smallest = c;
      break;
    }
  if (smallest == 0) return {0, 0};
  Shape chosen{smallest, 1};
  long best = -1;
  for (int per_sm = 1; per_sm <= 2; ++per_sm) {
    for (int c = std::min(kMaxCluster, std::max(chunks, smallest)); c >= smallest; --c) {
      const long cost = (long)per_sm * ((chunks + c - 1) / c);
      if ((best >= 0 && cost >= best) ||
          resident_clusters<kPicks, kCont>(lanes_built(lanes_needed(n, c)),
                                           {c, per_sm}, batch) < batch)
        continue;
      best = cost;
      chosen = {c, per_sm};
    }
  }
  cache[key] = chosen;
  return chosen;
}

bool shape_ok(int batch, int n) {
  return batch >= 1 && n >= 1 && n <= kMaxCluster * kMaxLanes * kThreads;
}

}  // namespace

// Largest N the kernel takes: a 16-CTA cluster's points.
extern "C" int spn_mds_max_points(void) { return kMaxCluster * kMaxLanes * kThreads; }

// The launch shape spn_mds takes for B clouds of N points: out[0] the
// cluster size, out[1] the CTAs an SM (0 and 0: N too large).
extern "C" void spn_mds_shape(int batch, int n, int* out) {
  const Shape sh = shape_ok(batch, n) ? choose_shape<false>(batch, n) : Shape{0, 0};
  out[0] = sh.c;
  out[1] = sh.per_sm;
}

// cluster: 0 for choose_shape's, else 1..16 at one CTA an SM (C = 1 is one
// block a cloud);
// stage: steps between compactions (0: none).
extern "C" int spn_mds(const float* xyz, const float* t, int batch, int n,
                       int npoint, int cluster, int stage, int* out,
                       void* stream) {
  if (!shape_ok(batch, n) || npoint < 1 || npoint > n || cluster < 0 ||
      cluster > kMaxCluster || stage < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh = cluster ? Shape{cluster, 1} : choose_shape<false>(batch, n);
  return launch_cluster<kPicks, false>({xyz, nullptr, nullptr, t, batch, n, npoint, stage, out},
                                       sh, static_cast<cudaStream_t>(stream));
}

// The latency floor: spn_mds's chain of npoint - 1 steps at cluster size c
// with no lane pass (each thread offers its first lane), for timing; with
// cta_only, without the record exchange and its wait too. What
// it writes is not MDS picks.
extern "C" int spn_mds_floor(const float* xyz, const float* t, int batch, int n,
                             int npoint, int cluster, int cta_only, int* out,
                             void* stream) {
  if (!shape_ok(batch, n) || npoint < 1 || npoint > n || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape sh{cluster, 1};
  const Args a{xyz, nullptr, nullptr, t, batch, n, npoint, 0, out};
  return cta_only ? launch_cluster<kCtaFloor, false>(a, sh, st)
                  : launch_cluster<kFloor, false>(a, sh, st);
}

// Largest live-lane count and step count the continuation takes (the TPU
// kernel's pin encoding holds step < 2^14; kept as the same contract, on
// which the compaction's bound also rests).
extern "C" int spn_mds_continue_max_points(void) {
  return kMaxCluster * kMaxLanes * kThreads;
}
extern "C" int spn_mds_continue_max_steps(void) { return 1 << 14; }

// The launch shape spn_mds_continue takes for B clouds of N live lanes.
extern "C" void spn_mds_continue_shape(int batch, int n, int* out) {
  const Shape sh = shape_ok(batch, n) ? choose_shape<true>(batch, n) : Shape{0, 0};
  out[0] = sh.c;
  out[1] = sh.per_sm;
}

// cluster and stage as spn_mds's.
extern "C" int spn_mds_continue(const float* xyz, const float* temp0,
                                const int* orig, const float* t, int batch,
                                int n, int steps, int cluster, int stage,
                                int* out, void* stream) {
  if (!shape_ok(batch, n) || steps < 1 || steps > n || steps > (1 << 14) ||
      cluster < 0 || cluster > kMaxCluster || stage < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh = cluster ? Shape{cluster, 1} : choose_shape<true>(batch, n);
  return launch_cluster<kPicks, true>({xyz, temp0, orig, t, batch, n, steps, stage, out},
                                      sh, static_cast<cudaStream_t>(stream));
}

// The continuation's latency floor: its chain of steps at cluster size c
// with no lane pass, for timing; what it writes is not picks.
extern "C" int spn_mds_continue_floor(const float* xyz, const float* temp0,
                                      const int* orig, const float* t, int batch,
                                      int n, int steps, int cluster, int* out,
                                      void* stream) {
  if (!shape_ok(batch, n) || steps < 1 || steps > n || steps > (1 << 14) ||
      cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return launch_cluster<kFloor, true>({xyz, temp0, orig, t, batch, n, steps, 0, out},
                                      {cluster, 1}, static_cast<cudaStream_t>(stream));
}
