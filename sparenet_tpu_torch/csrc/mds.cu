// Exact greedy minimum-density sampling.
//   xyz [B, N, 3] f32, t [B] f32 (t = 5 * mean_mst_length^2)
//   -> idx [B, npoint] int32
// Pick 0 is point 0, pinned to 1e9. Each step adds w * exp(-d2 / t) to every
// density, d2 being the squared distance to the previous pick and w = 2 for
// index >= 8192 (else 1); the next pick is the lowest-index argmin, and it
// is pinned to 1e9.
//
// Replaces: sparenet_tpu/ops/pallas/mds_pallas.py:mds_pallas (via
// _run_stage). Semantics: sparenet_tpu/ops/mds.py:_mds_one. The TPU kernel's
// 2^40 pin encoding, exp2 bias form and lane compaction are workarounds for
// that chip and are not carried over.
//
// Bound on an H100: latency of a chain of npoint-1 dependent steps, each an
// N-wide update (an exp per point) and a block-wide argmin. One cloud's
// state (19384 densities and coordinates, about 310 KB) is larger than one
// SM's shared memory, and no work crosses clouds, so a cloud runs on one SM
// and a batch of B clouds keeps only B of the 132 SMs busy.
//
// Design: one block of 512 threads per cloud. Thread t owns points
// t, t + 512, t + 1024, ...: their densities and z coordinates live in
// registers, x and y in shared memory (160 KB). A step is one pass
// over the thread's points, a (value, index) warp-shuffle argmin carrying
// the winner's z, and one shared-memory stage: two barriers per step. The
// previous pick is pinned lazily at the start of the next step, which gives
// the same densities as pinning it at the end of its own. The density
// arithmetic is IEEE and unfused where the reference is: d2 is the fma chain
// of sqdist3, then (-d2) / t, expf (no fast math) flushed to 0 below the
// smallest normal float (the reference's XLA CPU and TPU programs have no
// subnormals), w * e, and one add.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 40;  // points per thread: N <= 20480
constexpr int kWarps = kThreads / 32;
constexpr int kHeavyFrom = 8192;
constexpr float kBig = 1e9f;
constexpr float kTiny = 1.17549435e-38f;  // smallest normal float

// The argmin's comparison value: a NaN density is the minimum (the first
// NaN wins, as argmin in the reference and in PyTorch). Densities turn NaN
// when t = 0, i.e. a cloud whose mml estimate is 0 (every primitive
// collapsed onto one point); real densities are >= 0, never -inf.
__device__ __forceinline__ float nan_first(float v) {
  return isnan(v) ? -__int_as_float(0x7f800000) : v;
}

__global__ void __launch_bounds__(kThreads, 1)
mds_kernel(const float* __restrict__ xyz, const float* __restrict__ tparam,
           int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + kLanes * kThreads;
  __shared__ float wv[kWarps], wz[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int s_pick;
  __shared__ float s_z;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float* p = xyz + (size_t)b * n * 3;
  int* ob = out + (size_t)b * npoint;

  float z[kLanes], temp[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int i = tid + l * kThreads;
    if (i < n) {
      sx[i] = p[3 * i + 0];
      sy[i] = p[3 * i + 1];
      z[l] = p[3 * i + 2];
      temp[l] = (i == 0) ? kBig : 0.f;
    } else {
      sx[i] = 0.f;
      sy[i] = 0.f;
      z[l] = 0.f;
      temp[l] = inf;
    }
  }
  const float t = tparam[b];
  int last = 0;
  float lz = p[2];
  if (tid == 0) ob[0] = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last];
    float bv = inf, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const int i = tid + l * kThreads;
      if (i < n) {
        const float d2 = spn::sqdist3(sx[i] - lx, sy[i] - ly, z[l] - lz);
        float e = expf(__fdiv_rn(-d2, t));
        if (e < kTiny) e = 0.f;
        const float w = i >= kHeavyFrom ? 2.f : 1.f;
        const float tv = __fadd_rn(i == last ? kBig : temp[l], __fmul_rn(w, e));
        temp[l] = tv;
        const float key = nan_first(tv);
        if (key < bv) {  // lanes ascend in index: strict < keeps the lowest
          bv = key;
          bi = i;
          bz = z[l];
        }
      }
    }
    spn::warp_argmin_payload(bv, bi, bz);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wz[warp] = bz;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? wv[lane] : inf;
      bi = lane < kWarps ? wi[lane] : INT_MAX;
      bz = lane < kWarps ? wz[lane] : 0.f;
      spn::warp_argmin_payload(bv, bi, bz);
      if (lane == 0) {
        s_pick = bi;
        s_z = bz;
        ob[j] = bi;
      }
    }
    __syncthreads();
    last = s_pick;
    lz = s_z;
  }
}

// Greedy continuation (kernel #5): steps more picks from a density state.
//   xyz [B, N, 3] live-lane coordinates, temp0 [B, N] densities with every
//   earlier bump applied, orig [B, N] int32 original index (>= 8192: weight
//   2), t [B] -> lane indices [B, steps] int32.
// Replaces: sparenet_tpu/ops/pallas/mds_pallas.py:mds_pallas_continue (via
// _run_stage), the exact tail of the hybrid schedule (ops/mds.py:
// _mds_hybrid). Semantics: that function's XLA tail: each step takes the
// lowest-lane argmin, pins it to 1e9, then adds w * exp(-d2 / t) to every
// density (d2 the sqdist3 fma chain, exp flushed to 0 below the smallest
// normal). The lanes are compacted by the caller with a stable sort, so the
// lowest lane is the lowest original index and the picks are those of the
// full-width tail. Coordinates stay f32 (the TPU kernel's bf16 coordinates
// under fast math are not carried).
//
// Bound on an H100: latency of steps dependent steps, each an N-wide update
// and a block argmin; one block a cloud keeps B of the 132 SMs busy, as
// mds_kernel does. Design: mds_kernel's, with kContLanes points a thread
// (N <= 5120; the hybrid's tail has 5048 live lanes), the weights from
// orig, and no pending bump before the first argmin: the state starts at
// temp0.
constexpr int kContLanes = 10;

__global__ void __launch_bounds__(kThreads, 1)
mds_continue_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ temp0,
                    const int* __restrict__ orig,
                    const float* __restrict__ tparam, int n, int steps,
                    int* __restrict__ out) {
  __shared__ float sx[kContLanes * kThreads], sy[kContLanes * kThreads];
  __shared__ float wv[kWarps], wz[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int s_pick;
  __shared__ float s_z;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float* p = xyz + (size_t)b * n * 3;
  int* ob = out + (size_t)b * steps;

  float z[kContLanes], temp[kContLanes], w[kContLanes];
#pragma unroll
  for (int l = 0; l < kContLanes; ++l) {
    const int i = tid + l * kThreads;
    const bool live = i < n;
    sx[i] = live ? p[3 * i + 0] : 0.f;
    sy[i] = live ? p[3 * i + 1] : 0.f;
    z[l] = live ? p[3 * i + 2] : 0.f;
    temp[l] = live ? temp0[(size_t)b * n + i] : inf;
    w[l] = (live && orig[(size_t)b * n + i] >= kHeavyFrom) ? 2.f : 1.f;
  }
  const float t = tparam[b];
  int last = -1;
  float lz = 0.f;
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    const bool bump = j > 0;
    const float lx = bump ? sx[last] : 0.f, ly = bump ? sy[last] : 0.f;
    float bv = inf, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int l = 0; l < kContLanes; ++l) {
      const int i = tid + l * kThreads;
      if (i < n) {
        float tv = temp[l];
        if (bump) {
          const float d2 = spn::sqdist3(sx[i] - lx, sy[i] - ly, z[l] - lz);
          float e = expf(__fdiv_rn(-d2, t));
          if (e < kTiny) e = 0.f;
          tv = __fadd_rn(i == last ? kBig : tv, __fmul_rn(w[l], e));
          temp[l] = tv;
        }
        const float key = nan_first(tv);
        if (key < bv) {  // lanes ascend in index: strict < keeps the lowest
          bv = key;
          bi = i;
          bz = z[l];
        }
      }
    }
    spn::warp_argmin_payload(bv, bi, bz);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wz[warp] = bz;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? wv[lane] : inf;
      bi = lane < kWarps ? wi[lane] : INT_MAX;
      bz = lane < kWarps ? wz[lane] : 0.f;
      spn::warp_argmin_payload(bv, bi, bz);
      if (lane == 0) {
        s_pick = bi;
        s_z = bz;
        ob[j] = bi;
      }
    }
    __syncthreads();
    last = s_pick;
    lz = s_z;
  }
}

}  // namespace

// Largest N the kernel takes.
extern "C" int spn_mds_max_points(void) { return kLanes * kThreads; }

extern "C" int spn_mds(const float* xyz, const float* t, int batch, int n,
                       int npoint, int* out, void* stream) {
  if (batch < 1 || n < 1 || n > kLanes * kThreads || npoint < 1 || npoint > n)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * kLanes * kThreads * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mds_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, t, n, npoint, out);
  return (int)cudaGetLastError();
}

// Largest live-lane count and step count the continuation takes (the TPU
// kernel's pin encoding holds step < 2^14; kept as the same contract).
extern "C" int spn_mds_continue_max_points(void) { return kContLanes * kThreads; }
extern "C" int spn_mds_continue_max_steps(void) { return 1 << 14; }

extern "C" int spn_mds_continue(const float* xyz, const float* temp0,
                                const int* orig, const float* t, int batch,
                                int n, int steps, int* out, void* stream) {
  if (batch < 1 || n < 1 || n > kContLanes * kThreads || steps < 1 ||
      steps > n || steps > (1 << 14))
    return (int)cudaErrorInvalidValue;
  mds_continue_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, temp0, orig, t, n, steps, out);
  return (int)cudaGetLastError();
}
