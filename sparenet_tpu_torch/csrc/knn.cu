// Self-kNN graph on the tensor cores: x [B, N, C] f32 -> idx [B, N, k]
// int32, self included, ascending. For k <= 32 the kernels below are built
// for K = 8, 16 and 32 and write the first k of the smallest K >= k (in
// both arms' orders the top k is a prefix of the top K); above 32 every
// query takes an exact scan of all N candidates (knn_scan_all_kernel).
//
// Replaces sparenet_tpu/ops/pallas/knn_pallas.py: the entry :152
// knn_self_pallas, its C-chunked kernel :32 _knn_kernel (the exact arm) and
// its one-chunk kernel :70 _knn_onechunk_kernel (both arms). The Pallas
// kernels accumulate a [Q, N] distance tile in VMEM and run k masked-argmin
// passes over it; here no distance tile is kept anywhere: each distance is
// ranked straight out of the MMA accumulator registers.
//
// Exact arm (spn_knn; parity mode and training). The distance is the
// reference's graph distance at HIGH precision
// (sparenet_tpu/ops/common.py:graph_dot): dot = xh.yh + xh.yl + xl.yh with
// xh = bf16(x), xl = bf16(x - xh); d = max(|x|^2 + |y|^2 - 2 dot, 0).
// Ranked by (d, index) in lexicographic order, so a tie goes to the lowest
// index. The answer is that of one fixed order of the sums: per channel,
// in channel order, fma(xl, yh, fma(xh, yl, fma(xh, yh, dot))), and |x|^2
// an fma chain over the f32 values (the first CUDA design's order,
// ops/common.py:pairwise_sqdist_graph_seq). The plain version
// (ops/knn.py:knn_plain) sums the three products in torch.bmm's order, so
// the two may pick another neighbour at near-ties only. Bound on an H100:
// operations, three bf16 products a (query, candidate, channel) triple,
// 6 B N^2 C flops at the bf16 tensor-core peak (989 TFLOP/s); 1.1e11 flops
// for the C = 512 call at B = 4, N = 3000, 0.11 ms.
//
// Packed arm (spn_knn_packed; serving mode). The distance is one bf16 pass,
// d = max(|x|^2 + |y|^2 - 2 xh.yh, 0), the dot and the norms summed in
// channel order with every step rounded (ops/common.py:
// pairwise_sqdist_serving), and each candidate is ranked by one int32 key,
// (bits(d) & -(1 << bits)) | index, bits = bit_length(n_pad - 1), n_pad = N
// rounded up to 128. The kernel equals the plain version
// (ops/knn.py:knn_packed_plain) bit for bit. Bound: operations,
// 2 B N^2 C flops at the bf16 peak.
//
// Both arms filter on the tensor cores and re-rank exactly:
// 1. knn_prepass_kernel, once a call: each point's bf16 operands (xh, and
//    xl for the exact arm) go to scratch [B, c_pad / 16, n_pad, 16], the
//    channels padded with zeros to c_pad, a multiple of 32 (two k-steps a
//    stage), and the rows to a multiple of 64 (zero products: no distance
//    changes), so that one 16-channel chunk of 64 rows is 2 KB in one
//    piece; with the norms in each arm's order (equal to the plain
//    versions' bit for bit) and |xh|, rounded up. At B = 32, N = 3000,
//    C = 512 the exact arm's scratch is 32 x 3008 x 512 x 2 planes x
//    2 bytes, 197 MB (the packed arm's half of that); the wrapper allocates
//    it with torch.empty. The pre-pass also hashes each row's f32 bits into
//    a table a cloud, and knn_dedup_kernel groups the rows that are equal
//    bit for bit (each with the lowest index of its hash, the two rows
//    compared; on a hash collision a row is a group of its own), with
//    knn_dedup_next_kernel linking each group's rows in index order. Equal
//    rows have equal exact keys but for the index, so only a group's first
//    row (its representative) is ranked below, and the re-rank expands a
//    representative into its rows. The data loaders zero-pad every cloud
//    short of 3000 points (sparenet_tpu/data/transforms.py:
//    RandomSamplePoints), and the padding rows stay equal through the
//    encoder: hundreds of exact ties a query, which no margin separates.
// 2. knn_mma_kernel: a block of 4 warps owns 64 queries of one cloud, one
//    m16 MMA tile a warp, and sweeps a range of candidates in tiles of 64.
//    The query tile is loaded into shared memory once and kept for the
//    whole sweep (above about 800 channels, 1700 in the packed arm, it no
//    longer fits, and each stage of it is staged beside the candidates').
//    Candidate tiles stream through a 4-stage cp.async ring of 32-channel
//    stages, as bf16. Fragments come from shared memory with ldmatrix; the
//    products run on mma.sync.m16n8k16 (bf16 in, f32 out): three a k-step
//    in the exact arm (xl.yh, xh.yl, xh.yh), one in the packed arm, each
//    term issued for all eight n8 tiles before the next (independent
//    products hide the MMA latency), into fresh accumulators that are then
//    added to the running f32 sums, so the MMA's own truncating adds only
//    act on one k-step's products.
// 3. Selection from the accumulator fragments, without writing the
//    distances anywhere. Each representative gets the packed key of its
//    MMA distance d', (bits(d') & mask) | index. In the MMA layout a thread
//    holds two query rows and two of every eight candidate columns; it
//    keeps the M = 2K smallest keys of each row (16 for the model's k). When
//    a tile is complete, each thread compares its 16 new keys of a row
//    with the list's last entry and then inserts only those that pass, so
//    a warp waits for its busiest thread rather than for every insertion
//    of any thread. Padded candidates never enter a list. At the end the
//    four threads that share a row merge their lists with warp shuffles.
// 4. Filling the card: 64-query blocks give 47 x B blocks at N = 3000; where
//    that is under two blocks an SM (B = 4: 188 blocks for 132 SMs), the
//    candidate range is split over 2-4 blocks. Any N >= k and any C >= 1.
// 5. knn_rerank_kernel, one warp a query: merges the splits' lists into
//    the shortlist of the M smallest keys (M groups), tests the margin
//    below, and recomputes the exact key of each shortlisted representative
//    in the arm's fixed order (one lane a candidate, the sequential
//    __fmaf_rn chains over the bf16 scratch), then takes the k smallest
//    keys of the shortlisted groups' rows. A query whose shortlist fails
//    the test is flagged, and knn_scan_kernel ranks it by the exact keys of
//    all N candidates. The count of flagged queries is added to a counter
//    on the card that the wrapper reads (ops/_lib.py:
//    device_count("knn_flagged")).
//
// The margin test. The re-rank is the exact answer whenever the shortlist's
// groups hold every candidate whose exact key could be among the k
// smallest. With T(v) = bits(v) & mask, lo_M = float(T(key'_M)) (the M-th
// key's bucket floor), k' the fewest leading groups of the shortlist with
// k rows in all, and hi_k = float(T(key'_k') + 2^bits) (the k'-th key's
// bucket ceiling), the test is T(lo_M - E, rounded down) > T(hi_k + E,
// rounded up): every group outside the shortlist has d' >= lo_M, so
// d >= lo_M - E; the rows of the first k' groups, k or more, have
// d' < hi_k, so d < hi_k + E; the test puts every outside row's d above
// theirs (and its truncated distance too), so its exact key above the k-th
// smallest. A shortlist that holds every group (at most M) passes.
//
// The margin E bounds |d' - d| for one query over all candidates. u = 2^-24.
// The products of bf16 values are exact in f32 (8-bit significands).
// S = the sum of their magnitudes <= 1.01 P, P = |xh_q| max_j |yh_j|
// (Cauchy-Schwarz; |xl| <= 2^-8 |xh|; the norms from the pre-pass, rounded
// up). The exact order's dot, a sequential round-to-nearest sum of T = c
// (packed) or 3c (exact) products, is within 1.01 T u S of their sum. The
// MMA sum of one k-step's products (16, or 48 over three chained MMAs), in
// any order, with each add truncating but keeping 24 significant bits of
// its largest operand, loses less than 2^-23 of the step's sum of
// magnitudes for each term it aligns and each normalisation: at most 32
// (64) of them, 2^-18 (2^-17) of the step's S. The premise is Fasi,
// Higham, Mikaitis and Pranesh's measurement of the tensor cores of V100,
// T4 and A100 (Numerical behavior of NVIDIA tensor cores, PeerJ Computer
// Science 7:e330, 2021): exact products, a block's terms aligned to the
// largest and truncated, no fewer than an f32 significand's 24 bits kept.
// Hopper's adder is not published; spn_knn_dots returns this kernel's
// dot', and tests/test_torch_port_gpu.py and chip_smoke.py phase 2 hold
// |dot' - dot| to the bound below, and |d' - d| to E, on operands of mixed
// exponents and with cancellation on the card. Adding the step to the running sum rounds to
// nearest, u S each, c_pad / 16 times. So
// |dot' - dot| <= f (2^-18 + 1.6 c_pad u) 1.01 P, f = 1 (packed) or 2
// (exact). Then d' and d subtract 2 dot' and 2 dot from the same rounded
// |x|^2 + |y|^2 = A (the norms are shared) and round once each:
// |d' - d| <= 2 |dot' - dot| + 2 u (A + 2.04 P), A <= (1 + u)(|x_q|^2 +
// max |y|^2). Hence
//   E = f (2^-16 + c_pad 2^-22) P + 2^-22 (|x_q|^2 + max_j |y_j|^2)
//       + f c_pad 2^-124,
// computed with upward rounding (margin()); each term at least 1.2 times
// what it covers, the last for products that underflow (an MMA may flush
// them). The plain mirror is ops/knn.py:margin and rerank_plain.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQT = 16 * kWarps;  // queries a block: one m16 tile a warp
constexpr int kNT = 64;           // candidates a tile: eight n8 tiles
constexpr int kKS = 2;            // k-steps (16 channels each) a stage
constexpr int kStages = 4;        // cp.async ring of stages
constexpr int kSRow = 16 * kKS + 8;  // staged row in bf16: an odd count of
                                     // 16-byte units, so the 8 rows an
                                     // ldmatrix reads fall in distinct banks
constexpr int kMaxSplits = 4;
constexpr int kScanThreads = 256;
constexpr int kScanRows = 4;      // candidates a scan thread keys at once
constexpr int kRerankWarps = 4;
constexpr int kPrepassRows = 32;
constexpr int kDedupThreads = 256;
constexpr u64 kEmpty = ~0ull;     // a free slot of the row-hash table
static_assert(kThreads == 2 * kNT && kQT == kNT, "one 16-byte copy a thread");

// M, the shortlist a query keeps
__host__ __device__ constexpr int list_len(int k) { return 2 * k; }

using spn::cp_async16;
using spn::cp_async_commit;
using spn::cp_async_wait;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a b: a 16x16 bf16 (row major), b 16x8 bf16 (column major), d f32.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int none_key(int) { return INT_MAX; }
__device__ __forceinline__ u64 none_key(u64) { return ~0ull; }

// A sorted list of L unique keys (int or u64), the empty ones none_key.
template <int L, typename T>
struct KeyList {
  T k[L];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < L; ++s) k[s] = none_key(T());
  }
  __device__ __forceinline__ void push(T key) {
    if (key < k[L - 1]) {
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const T lo = min(key, k[s]);
        key = max(key, k[s]);
        k[s] = lo;
      }
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int s = 0; s < L - 1; ++s) k[s] = k[s + 1];
    k[L - 1] = none_key(T());
  }
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(spn::kFullMask, v, off));
  return v;
}

__device__ __forceinline__ int packed_key(float d, int mask, int j) {
  return (__float_as_int(d) & mask) | j;
}

// The exact keys of R candidates j[r] of query q, in the arm's fixed order:
// each dot over the c true channels as one sequential __fmaf_rn chain (the
// R chains interleave), then the norms' sum minus twice the dot, clamped at
// 0. Exact arm: ((u64) bits(d) << 32) | j, the lexicographic (d, j) order;
// packed arm: the packed key. xh, xl: the cloud's scratch (a row's
// 16-channel chunks are n_pad * 16 apart).
template <int R, bool kPacked>
__device__ __forceinline__ void exact_keys(const bf16* __restrict__ xh,
                                           const bf16* __restrict__ xl,
                                           int n_pad, int q, const int (&j)[R],
                                           float sqq, const float (&sqj)[R],
                                           int c, int mask, u64 (&key)[R]) {
  const size_t chunk = (size_t)n_pad * 16;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int c0 = 0; c0 < c; c0 += 8) {
    const size_t o = (c0 >> 4) * chunk + (c0 & 15);
    const uint4 qh4 = *reinterpret_cast<const uint4*>(xh + o + q * 16);
    const bf16* qh = reinterpret_cast<const bf16*>(&qh4);
    uint4 ql4 = qh4, yh4[R], yl4[R];
    if (!kPacked) ql4 = *reinterpret_cast<const uint4*>(xl + o + q * 16);
    const bf16* ql = reinterpret_cast<const bf16*>(&ql4);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      yh4[r] = *reinterpret_cast<const uint4*>(xh + o + j[r] * 16);
      if (!kPacked) yl4[r] = *reinterpret_cast<const uint4*>(xl + o + j[r] * 16);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i < c) {
        const float a = __bfloat162float(qh[i]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float yh = __bfloat162float(reinterpret_cast<const bf16*>(&yh4[r])[i]);
          if (kPacked) {
            acc[r] = __fmaf_rn(a, yh, acc[r]);
          } else {
            const float yl = __bfloat162float(reinterpret_cast<const bf16*>(&yl4[r])[i]);
            acc[r] = __fmaf_rn(__bfloat162float(ql[i]), yh,
                               __fmaf_rn(a, yl, __fmaf_rn(a, yh, acc[r])));
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float d = fmaxf(
        __fsub_rn(__fadd_rn(sqq, sqj[r]), __fmul_rn(2.f, acc[r])), 0.f);
    key[r] = kPacked ? (u64)(unsigned)packed_key(d, mask, j[r])
                     : ((u64)__float_as_uint(d) << 32) | (unsigned)j[r];
  }
}

// the index a key holds
template <bool kPacked>
__device__ __forceinline__ int key_index(u64 key, int mask) {
  return kPacked ? (int)key & ~mask : (int)(key & 0xffffffffu);
}

// E of the header, rounded up.
template <bool kPacked>
__device__ __forceinline__ float margin(float nq, float nmax, float sqq,
                                        float sqmax, int c_pad) {
  constexpr float f = kPacked ? 1.f : 2.f;
  const float p = __fmul_ru(nq, nmax);
  const float coef = f * __fadd_ru(0x1p-16f, __fmul_ru(float(c_pad), 0x1p-22f));
  float e = __fmul_ru(coef, p);
  e = __fadd_ru(e, __fmul_ru(0x1p-22f, __fadd_ru(sqq, sqmax)));
  return __fadd_ru(e, f * __fmul_ru(float(c_pad), 0x1p-124f));
}

// MurmurHash3's 32-bit block step and finaliser, over a row's f32 bits
__device__ __forceinline__ unsigned hash_step(unsigned h, unsigned w) {
  w *= 0xcc9e2d51u;
  w = (w << 15) | (w >> 17);
  h ^= w * 0x1b873593u;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xe6546b64u;
}

__device__ __forceinline__ unsigned hash_final(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// One block: 32 rows of a cloud. Writes the bf16 operands (zero rows and
// channels as padding), the norms in the arm's order, |xh| (rounded up),
// the cloud's largest |xh| and |x|^2, and each row's hash, entered in the
// cloud's table (open addressing, tsize slots; a slot holds
// (hash << 32) | the lowest row index with that hash).
template <bool kPacked>
__global__ void __launch_bounds__(256)
knn_prepass_kernel(const float* __restrict__ x, int n, int c, int n_pad,
                   int c_pad, int tsize, bf16* __restrict__ xh,
                   bf16* __restrict__ xl, float* __restrict__ sq,
                   float* __restrict__ nh, unsigned* __restrict__ cmax,
                   unsigned* __restrict__ hsh, u64* __restrict__ table) {
  __shared__ float tile[kPrepassRows][64 + 1];
  const int b = blockIdx.y, r0 = blockIdx.x * kPrepassRows, tid = threadIdx.x;
  float s = 0.f, h2 = 0.f;
  unsigned hv = 0x9747b28cu;
  for (int c0 = 0; c0 < c_pad; c0 += 64) {
    for (int e = tid; e < kPrepassRows * 32; e += blockDim.x) {
      const int r = e >> 5, cc = 2 * (e & 31), ch = c0 + cc, row = r0 + r;
      const float* px = x + ((size_t)b * n + row) * c;
      const float v0 = (row < n && ch < c) ? px[ch] : 0.f;
      const float v1 = (row < n && ch + 1 < c) ? px[ch + 1] : 0.f;
      tile[r][cc] = v0;
      tile[r][cc + 1] = v1;
      if (ch < c_pad) {
        const size_t o =
            (((size_t)b * (c_pad / 16) + ch / 16) * n_pad + row) * 16 + ch % 16;
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(xh + o) = h;
        if (!kPacked) {
          const float2 hf = __bfloat1622float2(h);
          *reinterpret_cast<__nv_bfloat162*>(xl + o) =
              __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
        }
      }
    }
    __syncthreads();
    if (tid < kPrepassRows) {
      const int lim = min(64, c - c0);
      for (int i = 0; i < lim; ++i) {
        const float v = tile[tid][i];
        hv = hash_step(hv, __float_as_uint(v));
        s = kPacked ? __fadd_rn(s, __fmul_rn(v, v)) : __fmaf_rn(v, v, s);
        const float h = spn::bf16_round(v);
        h2 = __fmaf_rn(h, h, h2);
      }
    }
    __syncthreads();
  }
  if (tid < kPrepassRows) {
    const int row = r0 + tid;
    sq[(size_t)b * n_pad + row] = s;
    // the fma-summed h2 is within c u of |xh|^2: scale it up past that
    const float v = __fsqrt_ru(__fmul_ru(h2, 1.f + float(c_pad) * 0x1p-23f));
    nh[(size_t)b * n_pad + row] = v;
    if (row < n) {  // non-negative floats order as their bits
      atomicMax(cmax + 2 * b, __float_as_uint(v));
      atomicMax(cmax + 2 * b + 1, __float_as_uint(s));
      const unsigned h = hash_final(hv);
      hsh[(size_t)b * n_pad + row] = h;
      u64* tab = table + (size_t)b * tsize;
      const u64 mine = ((u64)h << 32) | (unsigned)row;
      for (unsigned at = h & (tsize - 1);; at = (at + 1) & (tsize - 1)) {
        const u64 e = atomicCAS(tab + at, kEmpty, mine);
        if (e == kEmpty) break;
        if ((e >> 32) == h) {
          atomicMin(tab + at, mine);
          break;
        }
      }
    }
  }
}

// One thread a row (n_pad of them): its group's representative rep (the
// lowest index of its hash if that row equals it bit for bit, else
// itself), the rows of each group (cnt, at the representative), the groups
// of each cloud (nrep), and a bit a row, set for the representatives (live,
// 32 rows a word; padding rows clear).
__global__ void __launch_bounds__(kDedupThreads)
knn_dedup_kernel(const float* __restrict__ x, int n, int c, int n_pad,
                 int tsize, const unsigned* __restrict__ hsh,
                 const u64* __restrict__ table, int* __restrict__ rep,
                 int* __restrict__ cnt, int* __restrict__ nrep,
                 unsigned* __restrict__ live) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  bool first = false;
  if (j < n) {
    const unsigned h = hsh[(size_t)b * n_pad + j];
    const u64* tab = table + (size_t)b * tsize;
    unsigned at = h & (tsize - 1);
    while ((tab[at] >> 32) != h) at = (at + 1) & (tsize - 1);
    int r = (int)(tab[at] & 0xffffffffu);
    if (r != j) {
      const unsigned* a = reinterpret_cast<const unsigned*>(x) + ((size_t)b * n + r) * c;
      const unsigned* o = reinterpret_cast<const unsigned*>(x) + ((size_t)b * n + j) * c;
      for (int i = 0; i < c; ++i) {
        if (a[i] != o[i]) {
          r = j;
          break;
        }
      }
    }
    rep[(size_t)b * n_pad + j] = r;
    atomicAdd(cnt + (size_t)b * n_pad + r, 1);
    first = r == j;
    if (first) atomicAdd(nrep + b, 1);
  }
  const unsigned word = __ballot_sync(spn::kFullMask, first);
  if ((threadIdx.x & 31) == 0 && j < n_pad) live[((size_t)b * n_pad + j) / 32] = word;
}

// One thread a row: the next row of its group in index order, or -1.
__global__ void __launch_bounds__(kDedupThreads)
knn_dedup_next_kernel(int n, int n_pad, const int* __restrict__ rep,
                      const int* __restrict__ cnt, int* __restrict__ next) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (j >= n) return;
  const int* rb = rep + (size_t)b * n_pad;
  const int g = rb[j];
  int nx = -1;
  if (cnt[(size_t)b * n_pad + g] > 1) {
    for (int i = j + 1; i < n; ++i) {
      if (rb[i] == g) {
        nx = i;
        break;
      }
    }
  }
  next[(size_t)b * n_pad + j] = nx;
}

// The main kernel. grid (n_pad / 64 query tiles, splits, B). Writes, for
// each query and split, the M smallest keys of the representatives (the
// live bits) to part [B, N, splits, M]; kProbe: also every dot' to probe
// [B, N, N] (the measurement of the margin's premise).
template <int K, bool kPacked, bool kProbe>
__global__ void __launch_bounds__(kThreads)
knn_mma_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ xl,
               const float* __restrict__ sq, const unsigned* __restrict__ live,
               int n, int n_pad, int c_pad, int bits, int resident,
               int* __restrict__ part, float* __restrict__ probe) {
  constexpr int P = kPacked ? 1 : 2;  // bf16 planes: hi (and lo)
  constexpr int L = list_len(K);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int q0 = blockIdx.x * kQT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ks_n = c_pad / 16, kc_n = ks_n / kKS;  // k-steps, stages a tile
  const int tiles = n_pad / kNT;
  const int t0 = split * tiles / splits, t1 = (split + 1) * tiles / splits;
  const int n_stages = (t1 - t0) * kc_n;
  const size_t cloud = (size_t)b * n_pad;
  const size_t chunk = (size_t)n_pad * 16;  // one 16-channel chunk of a cloud
  const size_t base_x = (size_t)b * ks_n * chunk;
  const int mask = -(1 << bits);

  // shared memory: [resident query tile] [ring of kStages slots]
  const int q_stride = c_pad + 8;  // odd count of 16-byte units: no conflicts
  const int q_plane = kQT * q_stride;
  bf16* qs = smem;
  bf16* ring = smem + (resident ? P * q_plane : 0);
  const int slot_plane = (kNT + (resident ? 0 : kQT)) * kSRow;
  const int slot = P * slot_plane;

  if (resident) {  // chunk by chunk: 2 KB in one piece each
    for (int e = tid; e < P * ks_n * 2 * kQT; e += kThreads) {
      const int p = e / (ks_n * 2 * kQT), ks = (e / (2 * kQT)) % ks_n;
      const int r = (e >> 1) % kQT, h = (e & 1) * 8;
      cp_async16(qs + p * q_plane + r * q_stride + ks * 16 + h,
                 (p ? xl : xh) + base_x + ks * chunk + (q0 + r) * 16 + h);
    }
  }
  // stage s: candidate tile t0 + s / kc_n, k-steps kKS (s % kc_n) + [0, kKS)
  auto load = [&](int s) {
    bf16* dst = ring + (s % kStages) * slot;
    const int tile = t0 + s / kc_n, ks0 = (s % kc_n) * kKS;
    const int r = tid >> 1, h = (tid & 1) * 8;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < kKS; ++i) {
        const bf16* at = (p ? xl : xh) + base_x + (ks0 + i) * chunk + h;
        bf16* to = dst + p * slot_plane + i * 16 + h;
        cp_async16(to + r * kSRow, at + (tile * kNT + r) * 16);
        if (!resident) cp_async16(to + (kNT + r) * kSRow, at + (q0 + r) * 16);
      }
    }
  };

  // the two query rows this thread owns in the MMA layout
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  const float sqa = sq[cloud + qa], sqb = sq[cloud + qb];
  // ldmatrix row addresses: A (16x16, rows = queries), B (two n8 tiles)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  KeyList<L, int> la, lb;
  la.init();
  lb.init();
  float acc[kNT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kNT / 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  u64 tile_live = 0;  // the live bits of the tile in flight
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; slot (s - 1) % kStages is free
    if (s + kStages - 1 < n_stages) load(s + kStages - 1);
    cp_async_commit();

    const bf16* sl = ring + (s % kStages) * slot;
    const int kc = s % kc_n;
    if (kc == 0) {  // loaded at the tile's first stage, used after its last
      const uint2 lw = *reinterpret_cast<const uint2*>(
          live + (cloud + (t0 + s / kc_n) * kNT) / 32);
      tile_live = ((u64)lw.y << 32) | lw.x;
    }
#pragma unroll
    for (int i = 0; i < kKS; ++i) {
      const bf16* ap =
          resident ? qs + a_row * q_stride + (kc * kKS + i) * 16 + a_col
                   : sl + (kNT + a_row) * kSRow + i * 16 + a_col;
      uint32_t ah[4], al[4], bh[kNT / 8][2], bl[kNT / 8][2];
      ldmatrix_x4(ah, ap);
      if (!kPacked) ldmatrix_x4(al, ap + (resident ? q_plane : slot_plane));
#pragma unroll
      for (int np = 0; np < kNT / 16; ++np) {  // two n8 tiles each
        const bf16* bp = sl + (np * 16 + b_row) * kSRow + i * 16 + b_col;
        uint32_t r[4];
        ldmatrix_x4(r, bp);
        bh[2 * np][0] = r[0], bh[2 * np][1] = r[1];
        bh[2 * np + 1][0] = r[2], bh[2 * np + 1][1] = r[3];
        if (!kPacked) {
          ldmatrix_x4(r, bp + slot_plane);
          bl[2 * np][0] = r[0], bl[2 * np][1] = r[1];
          bl[2 * np + 1][0] = r[2], bl[2 * np + 1][1] = r[3];
        }
      }
      float step[kNT / 8][4];
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) step[nt][v] = 0.f;
      if (!kPacked) {
#pragma unroll
        for (int nt = 0; nt < kNT / 8; ++nt)
          mma_bf16(step[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < kNT / 8; ++nt)
          mma_bf16(step[nt], ah, bl[nt][0], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt)
        mma_bf16(step[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[nt][v] = __fadd_rn(acc[nt][v], step[nt][v]);
    }

    if (kc == kc_n - 1) {  // the tile's distances are complete: rank them
      const int jt = (t0 + s / kc_n) * kNT;
      // representatives only (padding rows clear); loading these bits here,
      // after the tile's MMAs, left the packed arm fewer registers and made
      // it slower (PERF.md, Findings)
      const u64 lm = tile_live >> (2 * t);
      int va[kNT / 4], vb[kNT / 4];
      unsigned pa = 0, pb = 0;
#pragma unroll
      for (int nt = 0; nt < kNT / 8; ++nt) {
        const float2 sq2 =
            *reinterpret_cast<const float2*>(sq + cloud + jt + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 2 * nt + e, j = jt + nt * 8 + 2 * t + e;
          const float sqj = e ? sq2.y : sq2.x;
          va[u] = packed_key(fmaxf(__fsub_rn(__fadd_rn(sqa, sqj),
                                             __fmul_rn(2.f, acc[nt][e])), 0.f),
                             mask, j);
          vb[u] = packed_key(fmaxf(__fsub_rn(__fadd_rn(sqb, sqj),
                                             __fmul_rn(2.f, acc[nt][2 + e])), 0.f),
                             mask, j);
          const unsigned ok = unsigned(lm >> (nt * 8 + e)) & 1u;
          pa |= (ok & unsigned(va[u] < la.k[L - 1])) << u;
          pb |= (ok & unsigned(vb[u] < lb.k[L - 1])) << u;
          if (kProbe && j < n) {
            if (qa < n) probe[((size_t)b * n + qa) * n + j] = acc[nt][e];
            if (qb < n) probe[((size_t)b * n + qb) * n + j] = acc[nt][2 + e];
          }
          acc[nt][e] = 0.f;
          acc[nt][2 + e] = 0.f;
        }
      }
      while (pa | pb) {
        if (pa) {
          la.push(va[__ffs(pa) - 1]);
          pa &= pa - 1;
        }
        if (pb) {
          lb.push(vb[__ffs(pb) - 1]);
          pb &= pb - 1;
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the lists of the four threads (t = 0..3) that share each row
  auto merge = [&](KeyList<L, int>& lst, int q) {
    const size_t base = (((size_t)b * n + q) * splits + split) * L;
    for (int o = 0; o < L; ++o) {
      int v = lst.k[0];
      v = min(v, __shfl_xor_sync(spn::kFullMask, v, 1));
      v = min(v, __shfl_xor_sync(spn::kFullMask, v, 2));
      if (lst.k[0] == v) lst.pop();
      if (t == 0 && q < n) part[base + o] = v;
    }
  };
  merge(la, qa);
  merge(lb, qb);
}

// the key with its index replaced by j (the next row of a group)
template <bool kPacked>
__device__ __forceinline__ u64 with_index(u64 key, int j, int mask) {
  return kPacked ? (key & (u64)(unsigned)mask) | (unsigned)j
                 : (key & ~0xffffffffull) | (unsigned)j;
}

// One warp a query: merge the splits' lists, test the margin, and either
// rank the shortlisted groups' rows by exact keys or flag the query for
// knn_scan_kernel.
template <int K, bool kPacked>
__global__ void __launch_bounds__(32 * kRerankWarps)
knn_rerank_kernel(const int* __restrict__ part, const bf16* __restrict__ xh,
                  const bf16* __restrict__ xl, const float* __restrict__ sq,
                  const float* __restrict__ nh, const float* __restrict__ cmax,
                  const int* __restrict__ nrep, const int* __restrict__ cnt,
                  const int* __restrict__ next, int batch, int n, int n_pad,
                  int c, int c_pad, int splits, int k, int bits,
                  int* __restrict__ count, int* __restrict__ flagged,
                  int* __restrict__ out) {
  constexpr int L = list_len(K);
  __shared__ int lists[kRerankWarps][kMaxSplits * L];
  __shared__ int merged[kRerankWarps][L];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRerankWarps + warp;
  if (r >= batch * n) return;  // the whole warp leaves together
  const int b = r / n, q = r % n;
  const size_t cloud = (size_t)b * n_pad;
  const int mask = -(1 << bits);
  const int groups = nrep[b];
  int* p = lists[warp];
  int* m = merged[warp];
  for (int e = lane; e < splits * L; e += 32) p[e] = part[(size_t)r * splits * L + e];
  __syncwarp();
  if (lane == 0) {
    int pos[kMaxSplits] = {0, 0, 0, 0};
    for (int o = 0; o < L; ++o) {
      int best = 0, v = INT_MAX;
      for (int s = 0; s < splits; ++s) {
        if (pos[s] < L && p[s * L + pos[s]] < v) {
          v = p[s * L + pos[s]];
          best = s;
        }
      }
      m[o] = v;
      ++pos[best];
    }
  }
  __syncwarp();
  // shortlist entry lane + 32 i: its representative j, its group's rows
  // and the group's next row
  constexpr int kPer = (L + 31) / 32;
  int j[kPer], v[kPer], nxt[kPer];
  float sqj[kPer];
  u64 key[kPer];
  // k': the fewest leading groups with k rows in all (a prefix sum of the
  // groups' rows over the warp)
  int kth = L - 1, base = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = lane + 32 * i < L ? m[lane + 32 * i] : INT_MAX;
    j[i] = v[i] == INT_MAX ? q : v[i] & ~mask;  // an empty entry reads the query
    sqj[i] = sq[cloud + j[i]];
    nxt[i] = next[cloud + j[i]];
    int pre = v[i] == INT_MAX ? 0 : cnt[cloud + j[i]];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(spn::kFullMask, pre, off);
      if (lane >= off) pre += u;
    }
    pre += base;
    const unsigned hit = __ballot_sync(spn::kFullMask, pre >= k);
    if (hit) kth = min(kth, 32 * i + __ffs(hit) - 1);
    base = __shfl_sync(spn::kFullMask, pre, 31);
  }
  if (groups > L) {  // else every group is in the shortlist
    const float e = margin<kPacked>(nh[cloud + q], cmax[2 * b], sq[cloud + q],
                                    cmax[2 * b + 1], c_pad);
    const float lo = __int_as_float(m[L - 1] & mask);
    const float hi = __int_as_float((m[kth] & mask) + (1 << bits));
    if ((__float_as_int(__fsub_rd(lo, e)) & mask) <=
        (__float_as_int(__fadd_ru(hi, e)) & mask)) {
      if (lane == 0) flagged[atomicAdd(count, 1)] = r;
      return;
    }
  }
  const size_t plane = (size_t)b * (c_pad / 16) * n_pad * 16;
  exact_keys<kPer, kPacked>(xh + plane, xl + plane, n_pad, q, j, sq[cloud + q],
                            sqj, c, mask, key);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (v[i] == INT_MAX) key[i] = ~0ull;
  // k rounds of the smallest key; the entry that gave it moves on to its
  // group's next row (the same distance, a higher index)
  for (int o = 0; o < k; ++o) {
    u64 best = key[0];
#pragma unroll
    for (int i = 1; i < kPer; ++i) best = min(best, key[i]);
    best = warp_min(best);
    const int jb = key_index<kPacked>(best, mask);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (key[i] == best) {
        key[i] = nxt[i] < 0 ? ~0ull : with_index<kPacked>(best, nxt[i], mask);
        if (nxt[i] >= 0) nxt[i] = next[cloud + nxt[i]];
      }
    }
    if (lane == 0) out[(size_t)r * k + o] = jb;
  }
}

// The flagged queries: one block a query (grid-stride over the list), the
// exact key of every candidate by the sequential scalar loop (four
// candidates a thread at once), each thread keeping its K smallest, then k
// rounds of a block-wide minimum.
template <int K, bool kPacked>
__global__ void __launch_bounds__(kScanThreads)
knn_scan_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ xl,
                const float* __restrict__ sq, int n, int n_pad, int c,
                int c_pad, int k, int bits, const int* __restrict__ count,
                const int* __restrict__ flagged, u64* __restrict__ total,
                int* __restrict__ out) {
  __shared__ u64 red[kScanThreads / 32];
  const int nf = *count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) atomicAdd(total, (u64)nf);
  const int mask = -(1 << bits);
  for (int f = blockIdx.x; f < nf; f += gridDim.x) {
    const int r = flagged[f], b = r / n, q = r % n;
    const size_t cloud = (size_t)b * n_pad;
    const size_t plane = (size_t)b * (c_pad / 16) * n_pad * 16;
    const float sqq = sq[cloud + q];
    KeyList<K, u64> lst;
    lst.init();
    for (int j0 = tid; j0 < n; j0 += kScanRows * kScanThreads) {
      int j[kScanRows];
      float sqj[kScanRows];
      u64 key[kScanRows];
#pragma unroll
      for (int i = 0; i < kScanRows; ++i) {
        j[i] = min(j0 + i * kScanThreads, n - 1);
        sqj[i] = sq[cloud + j[i]];
      }
      exact_keys<kScanRows, kPacked>(xh + plane, xl + plane, n_pad, q, j, sqq,
                                     sqj, c, mask, key);
#pragma unroll
      for (int i = 0; i < kScanRows; ++i)
        if (j0 + i * kScanThreads < n) lst.push(key[i]);
    }
    for (int o = 0; o < k; ++o) {
      u64 v = warp_min(lst.k[0]);
      if (lane == 0) red[warp] = v;
      __syncthreads();
      v = red[0];
#pragma unroll
      for (int w = 1; w < kScanThreads / 32; ++w) v = min(v, red[w]);
      __syncthreads();  // red is written again next round
      if (lst.k[0] == v) lst.pop();
      if (tid == 0) out[(size_t)r * k + o] = key_index<kPacked>(v, mask);
    }
  }
}

// k > 32 (spn_knn and spn_knn_packed at any k): every query ranks the exact
// keys of all N candidates, as knn_scan_kernel does, and keeps the k
// smallest in device memory. One block a query (grid-stride); the
// candidates come in chunks of kScanThreads, keyed (one a thread) and
// bitonic-sorted in shared memory; each chunk is merged into the sorted
// list of the k smallest so far: a key's place in the merged list is its
// rank in its own list plus the count of smaller keys in the other (binary
// search), and keys are unique (the index is in them), so no two keys take
// one place. lists: [gridDim.x, 2, k] u64 of scratch, two a block.
template <bool kPacked>
__global__ void __launch_bounds__(kScanThreads)
knn_scan_all_kernel(const bf16* __restrict__ xh, const bf16* __restrict__ xl,
                    const float* __restrict__ sq, int batch, int n, int n_pad,
                    int c, int c_pad, int k, int bits, u64* __restrict__ lists,
                    int* __restrict__ out) {
  __shared__ u64 chunk[kScanThreads];
  const int tid = threadIdx.x;
  const int mask = -(1 << bits);
  u64* la = lists + (size_t)blockIdx.x * 2 * k;
  u64* lb = la + k;
  // the count of entries of the sorted a[0, len) below v
  auto below = [](const u64* a, int len, u64 v) {
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a[mid] < v) lo = mid + 1;
      else hi = mid;
    }
    return lo;
  };
  for (int r = blockIdx.x; r < batch * n; r += gridDim.x) {
    const int b = r / n, q = r % n;
    const size_t cloud = (size_t)b * n_pad;
    const size_t plane = (size_t)b * (c_pad / 16) * n_pad * 16;
    const float sqq = sq[cloud + q];
    int have = 0;
    for (int j0 = 0; j0 < n; j0 += kScanThreads) {
      const int cnt = min(kScanThreads, n - j0);
      u64 key = none_key(u64());
      if (tid < cnt) {
        const int j[1] = {j0 + tid};
        const float sqj[1] = {sq[cloud + j0 + tid]};
        u64 kk[1];
        exact_keys<1, kPacked>(xh + plane, xl + plane, n_pad, q, j, sqq, sqj,
                               c, mask, kk);
        key = kk[0];
      }
      chunk[tid] = key;
      __syncthreads();
      for (int size = 2; size <= kScanThreads; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const int partner = tid ^ stride;
          if (partner > tid) {
            const u64 a = chunk[tid], z = chunk[partner];
            if ((a > z) == ((tid & size) == 0)) {
              chunk[tid] = z;
              chunk[partner] = a;
            }
          }
          __syncthreads();
        }
      }
      for (int i = tid; i < have; i += kScanThreads) {
        const u64 v = la[i];
        const int at = i + below(chunk, cnt, v);
        if (at < k) lb[at] = v;
      }
      if (tid < cnt) {
        const int at = tid + below(la, have, chunk[tid]);
        if (at < k) lb[at] = chunk[tid];
      }
      __syncthreads();
      u64* t = la;
      la = lb;
      lb = t;
      have = min(k, have + cnt);
    }
    for (int o = tid; o < k; o += kScanThreads)
      out[(size_t)r * k + o] = key_index<kPacked>(la[o], mask);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// the largest k of the filtered kernels (built for K = 8, 16 and 32); above
// it knn_scan_all_kernel answers every query
constexpr int kMaxListK = 32;

int kernel_k(int k) { return k <= 8 ? 8 : k <= 16 ? 16 : 32; }

// the low key bits the index takes: bit_length(n_pad - 1), n_pad = N
// rounded up to 128 (ops/knn.py:packed_bits)
int key_bits(int n) {
  int bits = 1;
  while ((round_up(n, 128) - 1) >> bits) ++bits;
  return bits;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// Scratch carved from one byte buffer, each part 256-byte aligned. The
// "zeroed" part (cmax, count, nrep, cnt) is set to 0 and the table to
// kEmpty at the start of each call.
struct Layout {
  int n_pad, c_pad, splits, K, L, tsize, scan_blocks;
  size_t xh, xl, sq, nh, hsh, table, rep, next, live, zeroed, cmax, count,
      nrep, cnt, zeroed_bytes, flagged, part, lists, bytes;
};

Layout layout(int batch, int n, int c, int k, bool packed) {
  Layout l{};
  l.n_pad = round_up(n, kNT);
  l.c_pad = round_up(c, 16 * kKS);
  l.K = kernel_k(k);
  l.L = list_len(l.K);
  l.tsize = 1;
  while (l.tsize < 2 * l.n_pad) l.tsize *= 2;
  // split the candidates until the grid has two blocks for each SM
  const int blocks = l.n_pad / kQT * batch;
  const int want = (2 * device_attr(cudaDevAttrMultiProcessorCount) + blocks - 1) / blocks;
  l.splits = std::max(1, std::min({want, kMaxSplits, l.n_pad / kNT}));
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t rows = (size_t)batch * l.n_pad;
  l.xh = take(rows * l.c_pad * sizeof(bf16));
  l.xl = packed ? l.xh : take(rows * l.c_pad * sizeof(bf16));
  l.sq = take(rows * sizeof(float));
  l.nh = take(rows * sizeof(float));
  l.hsh = take(rows * sizeof(unsigned));
  l.table = take((size_t)batch * l.tsize * sizeof(u64));
  l.rep = take(rows * sizeof(int));
  l.next = take(rows * sizeof(int));
  l.live = take(rows / 32 * sizeof(unsigned));
  l.zeroed_bytes = (batch * 2 + 1 + batch) * sizeof(int) + rows * sizeof(int);
  l.zeroed = take(l.zeroed_bytes);
  l.cmax = l.zeroed;
  l.count = l.cmax + batch * 2 * sizeof(float);
  l.nrep = l.count + sizeof(int);
  l.cnt = l.nrep + batch * sizeof(int);
  l.flagged = take((size_t)batch * n * sizeof(int));
  if (k > kMaxListK) {  // knn_scan_all_kernel: two lists of k keys a block
    l.scan_blocks = std::min(batch * n, 4 * device_attr(cudaDevAttrMultiProcessorCount));
    l.lists = take((size_t)l.scan_blocks * 2 * k * sizeof(u64));
  } else {
    l.part = take((size_t)batch * n * l.splits * l.L * sizeof(int));
  }
  l.bytes = off;
  return l;
}

size_t mma_smem(int planes, int c_pad, bool resident) {
  return resident ? (size_t)planes * kQT * (c_pad + 8) * sizeof(bf16) +
                        (size_t)kStages * planes * kNT * kSRow * sizeof(bf16)
                  : (size_t)kStages * planes * (kNT + kQT) * kSRow * sizeof(bf16);
}

template <typename T>
T* carve(unsigned char* s, size_t off) {
  return reinterpret_cast<T*>(s + off);
}

template <int K, bool kPacked>
int run(const float* x, unsigned char* s, int batch, int n, int c, int k,
        u64* total, int* out, float* probe, cudaStream_t st) {
  const Layout l = layout(batch, n, c, k, kPacked);
  const int bits = key_bits(n), rows = batch * n;
  auto* xh = carve<bf16>(s, l.xh);
  auto* xl = carve<bf16>(s, l.xl);
  auto* sq = carve<float>(s, l.sq);
  auto* nh = carve<float>(s, l.nh);
  auto* rep = carve<int>(s, l.rep);
  auto* cnt = carve<int>(s, l.cnt);
  auto* next = carve<int>(s, l.next);
  auto* live = carve<unsigned>(s, l.live);
  auto* count = carve<int>(s, l.count);
  auto* flagged = carve<int>(s, l.flagged);
  auto* part = carve<int>(s, l.part);

  cudaError_t err = cudaMemsetAsync(s + l.zeroed, 0, l.zeroed_bytes, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(s + l.table, 0xff, (size_t)batch * l.tsize * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  knn_prepass_kernel<kPacked><<<dim3(l.n_pad / kPrepassRows, batch), 256, 0, st>>>(
      x, n, c, l.n_pad, l.c_pad, l.tsize, xh, xl, sq, nh, carve<unsigned>(s, l.cmax),
      carve<unsigned>(s, l.hsh), carve<u64>(s, l.table));
  knn_dedup_kernel<<<dim3((l.n_pad + kDedupThreads - 1) / kDedupThreads, batch),
                     kDedupThreads, 0, st>>>(
      x, n, c, l.n_pad, l.tsize, carve<unsigned>(s, l.hsh), carve<u64>(s, l.table),
      rep, cnt, carve<int>(s, l.nrep), live);
  knn_dedup_next_kernel<<<dim3((n + kDedupThreads - 1) / kDedupThreads, batch),
                          kDedupThreads, 0, st>>>(n, l.n_pad, rep, cnt, next);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (k > kMaxListK) {
    if (probe) return (int)cudaErrorInvalidValue;
    knn_scan_all_kernel<kPacked><<<l.scan_blocks, kScanThreads, 0, st>>>(
        xh, xl, sq, batch, n, l.n_pad, c, l.c_pad, k, bits,
        carve<u64>(s, l.lists), out);
    return (int)cudaGetLastError();
  }

  const int planes = kPacked ? 1 : 2;
  const bool resident =
      mma_smem(planes, l.c_pad, true) <=
      (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const size_t smem = mma_smem(planes, l.c_pad, resident);
  auto main_kernel = knn_mma_kernel<K, kPacked, false>;
  if (probe) {  // the probe is built for K = 8 only
    if constexpr (K == 8) main_kernel = knn_mma_kernel<K, kPacked, true>;
    else return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(main_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  main_kernel<<<dim3(l.n_pad / kQT, l.splits, batch), kThreads, smem, st>>>(
      xh, xl, sq, live, n, l.n_pad, l.c_pad, bits, resident ? 1 : 0, part, probe);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  knn_rerank_kernel<K, kPacked><<<(rows + kRerankWarps - 1) / kRerankWarps,
                                  32 * kRerankWarps, 0, st>>>(
      part, xh, xl, sq, nh, carve<float>(s, l.cmax), carve<int>(s, l.nrep), cnt, next,
      batch, n, l.n_pad, c, l.c_pad, l.splits, k, bits, count, flagged, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int blocks = std::min(rows, 4 * device_attr(cudaDevAttrMultiProcessorCount));
  knn_scan_kernel<K, kPacked><<<blocks, kScanThreads, 0, st>>>(
      xh, xl, sq, n, l.n_pad, c, l.c_pad, k, bits, count, flagged, total, out);
  return (int)cudaGetLastError();
}

template <bool kPacked>
int dispatch(const float* x, void* scratch, int batch, int n, int c, int k,
             void* total, int* out, float* probe, void* stream) {
  if (batch < 1 || c < 1 || k < 1 || n < k || key_bits(n) > 30)
    return (int)cudaErrorInvalidValue;
  auto* s = static_cast<unsigned char*>(scratch);
  auto* tot = static_cast<u64*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kernel_k(k)) {
    case 8: return run<8, kPacked>(x, s, batch, n, c, k, tot, out, probe, st);
    case 16: return run<16, kPacked>(x, s, batch, n, c, k, tot, out, probe, st);
    default: return run<32, kPacked>(x, s, batch, n, c, k, tot, out, probe, st);
  }
}

}  // namespace

// Bytes of scratch a call needs (the wrapper allocates them).
extern "C" long long spn_knn_scratch_bytes(int batch, int n, int c, int k,
                                           int packed) {
  return (long long)layout(batch, n, c, k, packed != 0).bytes;
}

// total: the card's running count of flagged queries (one unsigned 64-bit
// integer), added to by each call.
extern "C" int spn_knn(const float* x, void* scratch, int batch, int n, int c,
                       int k, void* total, int* out, void* stream) {
  return dispatch<false>(x, scratch, batch, n, c, k, total, out, nullptr, stream);
}

extern "C" int spn_knn_packed(const float* x, void* scratch, int batch, int n,
                              int c, int k, void* total, int* out,
                              void* stream) {
  return dispatch<true>(x, scratch, batch, n, c, k, total, out, nullptr, stream);
}

// As spn_knn (packed = 0) or spn_knn_packed, also writing the main
// kernel's tensor-core dot' of every pair to probe [B, N, N] f32: the
// measurement of the margin's premise, not a path of the model.
extern "C" int spn_knn_dots(const float* x, void* scratch, int batch,
                                 int n, int c, int k, int packed, void* total,
                                 int* out, float* probe, void* stream) {
  return packed ? dispatch<true>(x, scratch, batch, n, c, k, total, out, probe, stream)
                : dispatch<false>(x, scratch, batch, n, c, k, total, out, probe, stream);
}
