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
// _mst_parents_xla (strict < relaxation, lowest-index argmin) and
// _prune_edges (parallel leaf-pruning rounds; an edge whose two endpoints
// are leaves together is charged to the higher vertex).
//
// Bound on an H100: neither bytes nor operations. The work is S-1 dependent
// steps per primitive, each an S-wide update and a block-wide argmin, so the
// time is the latency of that chain (and of the pruning rounds after it);
// the arithmetic (about 10 flops per vertex per step) is tiny.
//
// Design: one block per primitive. Up to 1024 vertices (expansion_kernel),
// one thread per vertex: the vertex's coordinates, its current distance to
// the tree and its parent stay in registers, and only the coordinates of
// the vertex just added are read from shared memory. Above 1024
// (expansion_wide_kernel), a block of 1024 threads with V vertices a
// thread (v = tid + k * 1024), their distances and parents in registers,
// their coordinates and degrees in dynamic shared memory (16 bytes a
// vertex, which bounds S at 14336, V = 14). The argmin is a (value, index)
// warp shuffle plus one shared-memory stage, two barriers per step. The
// charging peels leaves round by round exactly as _prune_edges does, with
// vertex degrees counted by shared-memory atomics (integer counts, so the
// order does not matter). The distance is sqrt(fma(dz, dz, fma(dy, dy,
// dx*dx))) with IEEE sqrt, as the reference computes it.
#include "common.cuh"

namespace {

constexpr int kMaxS = 1024;
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kMaxS)
expansion_kernel(const float* __restrict__ xyz, int s, int* __restrict__ parent,
                 float* __restrict__ cost, int* __restrict__ charged) {
  __shared__ float sx[kMaxS], sy[kMaxS], sz[kMaxS];
  __shared__ int deg[kMaxS];
  __shared__ float wv[32];
  __shared__ int wi[32];
  __shared__ int s_pick;

  const int bp = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31, warp = v >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool valid = v < s;
  const float inf = __int_as_float(0x7f800000);

  const float* p = xyz + (size_t)bp * s * 3;
  const float px = valid ? p[3 * v + 0] : 0.f;
  const float py = valid ? p[3 * v + 1] : 0.f;
  const float pz = valid ? p[3 * v + 2] : 0.f;
  sx[v] = px;
  sy[v] = py;
  sz[v] = pz;

  bool visited = (v == 0);
  float cur_dis = kBig;
  int cur_idx = 0, par = 0;
  float cst = 0.f;
  int last = 0;
  __syncthreads();

  for (int it = 0; it < s - 1; ++it) {
    const float d = __fsqrt_rn(spn::sqdist3(px - sx[last], py - sy[last], pz - sz[last]));
    if (valid && !visited && d < cur_dis) {
      cur_dis = d;
      cur_idx = last;
    }
    const float masked = valid ? (visited ? kBig : cur_dis) : inf;
    float bv = masked;
    int bi = v;
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
    if (v == nxt) {
      visited = true;
      par = cur_idx;
      cst = masked;
    }
    last = nxt;
  }

  // Leaf pruning: edge v (v >= 1) is (v, par). Each round, an alive edge
  // with a degree-1 endpoint dies and is charged to that endpoint (to the
  // higher vertex when both endpoints are leaves).
  bool alive = valid && v >= 1;
  int chg = 0;
  while (__syncthreads_or(alive)) {
    deg[v] = 0;
    __syncthreads();
    if (alive) {
      atomicAdd(&deg[par], 1);
      atomicAdd(&deg[v], 1);
    }
    __syncthreads();
    const bool u_leaf = alive && deg[v] == 1;
    const bool p_leaf = alive && deg[par] == 1;
    if (u_leaf || p_leaf) {
      chg = (u_leaf && p_leaf) ? max(v, par) : (u_leaf ? v : par);
      alive = false;
    }
  }

  if (valid) {
    const size_t o = (size_t)bp * s + v;
    parent[o] = par;
    cost[o] = cst;
    charged[o] = chg;
  }
}

constexpr int kMaxV = 14;  // vertices a thread of expansion_wide_kernel

// expansion_kernel's steps with V vertices a thread of kMaxS threads
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

  // leaf pruning, as expansion_kernel's
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

extern "C" int spn_expansion(const float* xyz, int bp, int s, int* parent,
                             float* cost, int* charged, void* stream) {
  if (bp < 1 || s < 2 || s > kMaxV * kMaxS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= kMaxS) {
    const int threads = (s + 31) / 32 * 32;
    expansion_kernel<<<bp, threads, 0, st>>>(xyz, s, parent, cost, charged);
    return (int)cudaGetLastError();
  }
  const int v = (s + kMaxS - 1) / kMaxS;
  if (v <= 2) return launch_wide<2>(xyz, bp, s, parent, cost, charged, st);
  if (v <= 4) return launch_wide<4>(xyz, bp, s, parent, cost, charged, st);
  if (v <= 8) return launch_wide<8>(xyz, bp, s, parent, cost, charged, st);
  return launch_wide<kMaxV>(xyz, bp, s, parent, cost, charged, st);
}
