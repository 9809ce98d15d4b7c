// Expansion penalty, forward: Prim's minimum spanning tree of each primitive
// plus the leaf-prune charge of each tree edge.
//   xyz [BP, S, 3] f32 -> parent [BP, S] i32, cost [BP, S] f32,
//                         charged [BP, S] i32
// Edge v (v >= 1) joins v and parent[v] with Euclidean length cost[v];
// charged[v] is the endpoint the edge is charged to. Vertex 0 is the root:
// parent, cost and charged are 0 there.
//
// Replaces: sparenet_tpu/ops/pallas/expansion_pallas.py:expansion_pallas
// (and mst_parents_pallas). Semantics: sparenet_tpu/ops/expansion_penalty.py
// _mst_parents_xla (strict < relaxation, lowest-index argmin, visited
// vertices masked to 1e9) and _prune_edges (parallel leaf-pruning rounds; an
// edge whose two endpoints are leaves together is charged to the higher
// vertex). A vertex that is never picked (a NaN coordinate) keeps cost 0.
//
// Bound on an H100: neither bytes nor operations. The work is S-1 dependent
// steps per primitive, each an S-wide update and an argmin, so the time is
// the latency of that chain (and of the pruning rounds after it); the
// arithmetic (about 10 flops per vertex per step) is tiny. The floor is
// (S-1) x the latency of an empty step (spn_expansion with mode kFloor).
//
// Design (S <= 1024, expansion_warp_kernel): a primitive is one block of 16
// warps, thread t holding V = 1 or 2 vertices v = t V + k in registers (one
// at S = 512): coordinates, distance
// to the tree, the squared distance behind it, the tree vertex it came
// from, and its cost. A step:
//   - relaxation by the squared distance: a vertex whose d^2 is not below
//     the d^2 behind its current distance cannot get closer (a correctly
//     rounded square root is monotone), so the IEEE root and the strict <
//     test run only where d^2 dropped; visited vertices carry d^2 = -inf and
//     distance 1e9, vertices past S -inf and +inf, so neither is relaxed;
//   - the argmin: a tree of (distance bits, slot) minima over a thread's
//     slots, then redux.sync.min.u32 over the warp on the bits (non-negative
//     floats order as integers, NaN above +inf) and a ballot for the lowest
//     lane holding them: threads hold ascending vertex ranges, so that is
//     the lowest index; each warp's (bits, index) key goes to shared memory
//     (a buffer a step parity, one barrier a step), and every warp takes
//     the least bits and the lowest warp holding them the same way;
//   - the pick: its owner takes its cost and marks it visited; every thread
//     reads its coordinates from shared memory (PTX loads on an address
//     taken once, so no shared-window setup sits in the step).
// The charging peels leaves round by round as _prune_edges does: a
// vertex's degree starts at 1 where its own edge is alive, the parents' by
// shared-memory atomics (integer counts, so the order does not matter),
// three barriers a round (chip_smoke.py phase 4 prints the rounds). The
// distance is sqrt(fma(dz, dz, fma(dy, dy, dx*dx))) with IEEE sqrt, as the
// reference computes it. spn_expansion's modes kPrim (no charging) and
// kFloor (empty steps) time the parts.
#include "common.cuh"

namespace {

constexpr int kMaxS = 1024;  // S a block of expansion_warp_kernel takes, and
                             // the threads of expansion_wide_kernel
// warps a primitive of expansion_warp_kernel: on an H100 16 was faster than
// 1, 2, 4 and 8 at B = 4, 24 and 32 (PERF.md), and a block holds S <= 1024
// at two vertices a thread
constexpr int kWarps = 16;
constexpr float kBig = 1e9f;

// spn_expansion's modes: the whole function; Prim's steps without the
// charging; empty steps (no relaxation: the argmin, the key exchange and
// the pick) and no charging, the latency floor. Only kFull writes charged.
enum Mode { kFull = 0, kPrim = 1, kFloor = 2 };

using u64 = unsigned long long;

// a[k] by a tree of selects on the bits of k (k in [0, V); any value of
// the array for k outside it)
template <int V, typename T>
__device__ __forceinline__ T pick(const T (&a)[V], int k) {
  T t[V];
#pragma unroll
  for (int j = 0; j < V; ++j) t[j] = a[j];
#pragma unroll
  for (int w = 1; w < V; w <<= 1)
#pragma unroll
    for (int j = 0; j + w < V; j += 2 * w) t[j] = (k & w) ? t[j + w] : t[j];
  return t[0];
}

// The lowest lane holding `bits` == the warp's minimum, and that minimum.
__device__ __forceinline__ int lowest_min_lane(unsigned bits, unsigned& wmin) {
  wmin = __reduce_min_sync(spn::kFullMask, bits);
  return __ffs(__ballot_sync(spn::kFullMask, bits == wmin)) - 1;
}

template <int V, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
expansion_warp_kernel(const float* __restrict__ xyz, int s,
                      int* __restrict__ parent, float* __restrict__ cost,
                      int* __restrict__ charged) {
  extern __shared__ float4 sxyz[];  // [s] (x, y, z, 0), then deg [s]
  int* deg = reinterpret_cast<int*>(sxyz + s);
  __shared__ u64 keys[2][kWarps];

  const int bp = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  // shared addresses, taken once: the step's loads and stores are PTX on them
  const unsigned xyz_sh = static_cast<unsigned>(__cvta_generic_to_shared(sxyz));
  const unsigned keys_sh = static_cast<unsigned>(__cvta_generic_to_shared(&keys[0][0]));

  const float* p = xyz + (size_t)bp * s * 3;
  // per vertex: coordinates, distance to the tree, the d^2 behind it, the
  // tree vertex it came from, and its cost (set when it is picked)
  float x[V], y[V], z[V], dis[V], d2[V], cst[V];
  int from[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = tid * V + k;
    const bool valid = v < s;
    x[k] = valid ? p[3 * v + 0] : 0.f;
    y[k] = valid ? p[3 * v + 1] : 0.f;
    z[k] = valid ? p[3 * v + 2] : 0.f;
    if (valid) sxyz[v] = make_float4(x[k], y[k], z[k], 0.f);
    dis[k] = valid ? kBig : inf;
    d2[k] = (valid && v != 0) ? inf : -inf;  // vertex 0 starts visited
    cst[k] = 0.f;  // a vertex never picked (NaN input) keeps cost 0
    from[k] = 0;
  }
  __syncthreads();

  int last = 0;
  for (int it = 0; it < s - 1; ++it) {
    if (kMode != kFloor) {
      float4 c;
      asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(c.x), "=f"(c.y), "=f"(c.z), "=f"(c.w)
          : "r"(xyz_sh + 16u * last));
      float e[V];
      unsigned need = 0;  // slots whose d^2 dropped below the one behind dis
#pragma unroll
      for (int k = 0; k < V; ++k) {
        e[k] = spn::sqdist3(__fsub_rn(x[k], c.x), __fsub_rn(y[k], c.y),
                            __fsub_rn(z[k], c.z));
        need |= (e[k] < d2[k] ? 1u : 0u) << k;
      }
      if constexpr (V == 1) {
        if (need) {
          const float d = __fsqrt_rn(e[0]);
          if (d < dis[0]) {
            dis[0] = d;
            d2[0] = e[0];
            from[0] = last;
          }
        }
      }
      // V > 1: one slot a lane a pass, the root and the strict < test
      // written back by predicated selects (no branch a slot)
      while (V > 1 && __any_sync(spn::kFullMask, need)) {
        const int k = __ffs(need) - 1;
        need &= need - 1;
        const float ek = pick(e, k);
        const float d = __fsqrt_rn(ek);
        const unsigned hot = (k >= 0 && d < pick(dis, k)) ? 1u << k : 0u;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const bool h = (hot >> j) & 1u;
          dis[j] = h ? d : dis[j];
          d2[j] = h ? ek : d2[j];
          from[j] = h ? last : from[j];
        }
      }
    }
    // the lane's (bits, slot) minimum, the lower slot on a tie; then the
    // warp's minimum bits and the lowest lane holding them (lanes hold
    // ascending vertex ranges v = tid V + k, so that is the lowest index)
    unsigned bv[V];
    int bk[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      bv[k] = __float_as_uint(dis[k]);
      bk[k] = k;
    }
#pragma unroll
    for (int span = 1; span < V; span <<= 1) {
#pragma unroll
      for (int k = 0; k + span < V; k += 2 * span) {
        if (bv[k + span] < bv[k]) {
          bv[k] = bv[k + span];
          bk[k] = bk[k + span];
        }
      }
    }
    unsigned wmin;
    const int wl = lowest_min_lane(bv[0], wmin);
    int nxt = V == 1 ? 32 * warp + wl
                     : __shfl_sync(spn::kFullMask, tid * V + bk[0], wl);
    {
      // each warp's (bits, index), then the least bits and the lowest warp
      // holding them (warps hold ascending vertex ranges too); every lane
      // stores its warp's key (one value), and reads a clamped slot, so
      // neither side branches
      const u64 key = ((u64)wmin << 32) | (unsigned)nxt;
      const unsigned slot = keys_sh + 8u * ((it & 1) * kWarps);
      asm volatile("st.shared.u64 [%0], %1;" ::"r"(slot + 8u * warp), "l"(key)
                   : "memory");
      __syncthreads();
      u64 kw;
      asm volatile("ld.shared.u64 %0, [%1];"
                   : "=l"(kw)
                   : "r"(slot + 8u * (lane & (kWarps - 1)))
                   : "memory");
      kw = lane < kWarps ? kw : ~0ull;
      const int ww = lowest_min_lane((unsigned)(kw >> 32), wmin);
      nxt = __shfl_sync(spn::kFullMask, (int)(unsigned)kw, ww);
    }
    // the pick's owner takes its cost and marks it visited
    const unsigned mark = nxt / V == tid ? 1u << (nxt % V) : 0u;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool h = (mark >> k) & 1u;
      cst[k] = h ? dis[k] : cst[k];
      dis[k] = h ? kBig : dis[k];
      d2[k] = h ? -inf : d2[k];
    }
    last = nxt;
  }

  // Leaf pruning: edge v (v >= 1) is (v, from[v]). Each round, an alive
  // edge with a degree-1 endpoint dies and is charged to that endpoint (to
  // the higher vertex when both endpoints are leaves).
  int* pb = parent + (size_t)bp * s;
  float* cb = cost + (size_t)bp * s;
  int* gb = charged + (size_t)bp * s;
  unsigned alive = 0;
  int chg[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = tid * V + k;
    chg[k] = 0;
    if (v < s) {
      pb[v] = from[k];
      cb[v] = cst[k];
      if (v >= 1 && kMode == kFull) alive |= 1u << k;
    }
  }
  while (__syncthreads_or(alive != 0)) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (tid * V + k < s) deg[tid * V + k] = (alive >> k) & 1u;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k)
      if ((alive >> k) & 1u) atomicAdd(&deg[from[k]], 1);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid * V + k;
      if ((alive >> k) & 1u) {
        const bool u_leaf = deg[v] == 1, p_leaf = deg[from[k]] == 1;
        if (u_leaf || p_leaf) {
          chg[k] = (u_leaf && p_leaf) ? max(v, from[k]) : (u_leaf ? v : from[k]);
          alive &= ~(1u << k);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (tid * V + k < s) gb[tid * V + k] = chg[k];
}

template <int V>
int launch_warp(const float* xyz, int bp, int s, int mode, int* parent,
                float* cost, int* charged, cudaStream_t st) {
  const int smem = s * (int)(sizeof(float4) + sizeof(int));
  const dim3 grid(bp), block(32 * kWarps);
  if (mode == kFull)
    expansion_warp_kernel<V, kFull><<<grid, block, smem, st>>>(xyz, s, parent, cost, charged);
  else if (mode == kPrim)
    expansion_warp_kernel<V, kPrim><<<grid, block, smem, st>>>(xyz, s, parent, cost, charged);
  else
    expansion_warp_kernel<V, kFloor><<<grid, block, smem, st>>>(xyz, s, parent, cost, charged);
  return (int)cudaGetLastError();
}

constexpr int kMaxV = 14;  // vertices a thread of expansion_wide_kernel

// S > kMaxS: a block of kMaxS threads with V vertices a thread (v = tid + k *
// kMaxS), their distances and parents in registers, their coordinates and
// degrees in dynamic shared memory (16 bytes a vertex, which bounds S at
// kMaxV * kMaxS = 14336). The argmin is a (value, index) warp shuffle plus
// one shared-memory stage, two barriers a step; the charging is the leaf
// pruning of expansion_warp_kernel with shared-memory atomics.
template <int V>
__global__ void __launch_bounds__(kMaxS)
expansion_wide_kernel(const float* __restrict__ xyz, int s,
                      int* __restrict__ parent, float* __restrict__ cost,
                      int* __restrict__ charged) {
  extern __shared__ float smem[];  // sx, sy, sz [s], deg [s]
  float* sx = smem;
  float* sy = sx + s;
  float* sz = sy + s;
  int* deg = reinterpret_cast<int*>(sz + s);
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ int s_pick;

  const int bp = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const float inf = __int_as_float(0x7f800000);

  const float* p = xyz + (size_t)bp * s * 3;
  int* pb = parent + (size_t)bp * s;
  float* cb = cost + (size_t)bp * s;
  int* gb = charged + (size_t)bp * s;
  float cur_dis[V];
  int cur_idx[V], par[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = tid + k * nt;
    if (v < s) {
      sx[v] = p[3 * v + 0];
      sy[v] = p[3 * v + 1];
      sz[v] = p[3 * v + 2];
      cb[v] = 0.f;  // a vertex never picked (NaN input) keeps cost 0
    }
    cur_dis[k] = kBig;
    cur_idx[k] = 0;
    par[k] = 0;
  }
  unsigned visited = tid == 0 ? 1u : 0u;  // bit k: vertex tid + k * nt
  int last = 0;
  __syncthreads();

  for (int it = 0; it < s - 1; ++it) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = inf;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * nt;
      const bool valid = v < s, vis = (visited >> k) & 1u;
      const float d = valid ? __fsqrt_rn(spn::sqdist3(sx[v] - lx, sy[v] - ly,
                                                       sz[v] - lz))
                            : inf;
      if (valid && !vis && d < cur_dis[k]) {
        cur_dis[k] = d;
        cur_idx[k] = last;
      }
      const float masked = valid ? (vis ? kBig : cur_dis[k]) : inf;
      if (masked < bv) {  // v ascends in k: strict < keeps the lowest
        bv = masked;
        bi = v;
      }
    }
    spn::warp_argmin(bv, bi);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? wv[lane] : inf;
      bi = lane < nwarps ? wi[lane] : INT_MAX;
      spn::warp_argmin(bv, bi);
      if (lane == 0) s_pick = bi;
    }
    __syncthreads();
    const int nxt = s_pick;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (tid + k * nt == nxt) {
        cb[nxt] = ((visited >> k) & 1u) ? kBig : cur_dis[k];
        visited |= 1u << k;
        par[k] = cur_idx[k];
      }
    }
    last = nxt;
  }

  // leaf pruning, as expansion_warp_kernel's
  unsigned alive = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int v = tid + k * nt;
    if (v < s && v >= 1) alive |= 1u << k;
    if (v < s) pb[v] = par[k];
  }
  if (tid == 0) gb[0] = 0;
  while (__syncthreads_or(alive != 0)) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (tid + k * nt < s) deg[tid + k * nt] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if ((alive >> k) & 1u) {
        atomicAdd(&deg[par[k]], 1);
        atomicAdd(&deg[tid + k * nt], 1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int v = tid + k * nt;
      const bool a = (alive >> k) & 1u;
      const bool u_leaf = a && deg[v] == 1;
      const bool p_leaf = a && deg[par[k]] == 1;
      if (u_leaf || p_leaf) {
        gb[v] = (u_leaf && p_leaf) ? max(v, par[k]) : (u_leaf ? v : par[k]);
        alive &= ~(1u << k);
      }
    }
  }
}

template <int V>
int launch_wide(const float* xyz, int bp, int s, int* parent, float* cost,
                int* charged, cudaStream_t st) {
  const int smem = 4 * s * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      expansion_wide_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  expansion_wide_kernel<V><<<bp, kMaxS, smem, st>>>(xyz, s, parent, cost, charged);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest primitive size the kernels take.
extern "C" int spn_expansion_max_points(void) { return kMaxV * kMaxS; }

// mode: 0 the whole function; 1 Prim's steps only (charged is all 0); 2
// empty steps, the latency floor (parent and cost are not the tree). S >
// kMaxS takes the wide kernel, mode 0 only.
extern "C" int spn_expansion(const float* xyz, int bp, int s, int mode, int* parent,
                             float* cost, int* charged, void* stream) {
  if (bp < 1 || s < 2 || s > kMaxV * kMaxS || mode < kFull || mode > kFloor)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s > kMaxS) {
    if (mode != kFull) return (int)cudaErrorInvalidValue;
    const int v = (s + kMaxS - 1) / kMaxS;
    if (v <= 2) return launch_wide<2>(xyz, bp, s, parent, cost, charged, st);
    if (v <= 4) return launch_wide<4>(xyz, bp, s, parent, cost, charged, st);
    if (v <= 8) return launch_wide<8>(xyz, bp, s, parent, cost, charged, st);
    return launch_wide<kMaxV>(xyz, bp, s, parent, cost, charged, st);
  }
  if (s <= 32 * kWarps) return launch_warp<1>(xyz, bp, s, mode, parent, cost, charged, st);
  return launch_warp<2>(xyz, bp, s, mode, parent, cost, charged, st);
}
