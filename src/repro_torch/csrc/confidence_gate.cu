// Confidence gate for Hopper: score pass + thresholded bottom-k select.
//
// Replaces src/repro/kernels/confidence_gate/kernel.py:
//   _score_kernel  (confidence_gate_pallas, pallas_call at :160)
//   _select_kernel (pallas_call at :176)
//
// Bound on the H100: memory. The score pass reads each logit once and does
// a handful of flops per element (an exp and a few FMAs), far below the
// ~20 flop/byte the card needs before arithmetic limits it; at the yi-6b
// vocabulary ([32, 64000] f32 = 8.2 MB) the floor is ~2.4 us at 3.35 TB/s.
// The select pass touches B floats and is bound by launch latency at the
// serve path's B = 32.
//
// Design. The TPU walks the class blocks of a row tile in order on one core
// ("arbitrary" grid axis) and carries the running statistics in VMEM
// scratch. Here the score is the one-launch pass of vocab_stats.cuh: one
// warp per row at the serve path's [32, 8], a thread-block cluster per row
// for a wide vocabulary (merged through distributed shared memory), each
// thread folding 16-byte register blocks with _fold_stats' algebra, and
// the supervisor's epilogue in the same kernel. s2 is carried only for
// Gini. The ragged class edge and unaligned rows are handled in the
// kernel, so no -1e30 padding copy is made. The supervisor is a runtime
// code.
//
// Select. The TPU runs k rounds of a masked argmin (first index on ties),
// stopping to take rows once the minimum reaches t_local. That is: slot r
// holds the row of stable ascending rank r among the masked confidences
// when its value is < t_local, else -1 (rows >= n_valid count as +inf).
// Here the ranks come in one pass with no rounds: at B <= 32 one warp
// counts, for each lane's row, the rows that order before it (32
// shuffles); above that one block sorts (value key, row) pairs: 16 keys
// a thread sorted in registers, then merged in pairs of runs through
// shared memory (merge paths found by binary search). Values compare
// through an order-preserving uint32 key: -0.0 and +0.0 tie (lower row
// first), NaN orders after +inf and, like +inf, is never taken (the JAX
// package's oracle and stable argsort order NaN so; its Pallas select
// instead returns no row at all once a NaN is the minimum). t_local and
// n_valid are read from device scalars, so a new threshold needs no new
// launch configuration (and a CUDA graph no recapture).

#include "vocab_stats.cuh"

namespace {

constexpr int kSortE = 16;          // keys per thread of the sort
constexpr int kSortMax = 16384;    // rows the sort takes
constexpr int kSortThreads = kSortMax / kSortE;

// order-preserving image of a confidence as a uint32: the value made
// canonical first (-0.0 + 0.0 = +0.0, so the two zeros tie), then
// negatives reversed below the positives; NaN above +inf. Two rows
// compare as their keys do, and as < and == do on non-NaN values.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.f));
  if (isnan(v)) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the canonical value of a key (NaN for NaN's)
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// B <= 32: one warp, lane i holds row i (rows >= n_valid as +inf, lanes
// past B above every row). Row i's stable rank is the number of rows
// whose key is smaller, or equal at a lower index: 32 shuffles, no
// shared memory, no barrier. Lane i writes idx[rank] = i when it is
// taken; the slots after the last taken row get -1.
__global__ void __launch_bounds__(32)
gate_select_warp_kernel(const float* __restrict__ conf, int B,
                        const float* __restrict__ t_local,
                        const int* __restrict__ n_valid, int k,
                        int* __restrict__ idx) {
  const int lane = threadIdx.x;
  const float t = *t_local;
  const float v = lane < *n_valid && lane < B ? conf[lane] : INFINITY;
  const uint32_t key = lane < B ? order_key(v) : 0xffffffffu;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t kj = __shfl_sync(0xffffffffu, key, j);
    rank += kj < key || (kj == key && j < lane);
  }
  // eligible rows are the smallest keys, so their ranks are 0 .. cnt - 1
  const bool take = lane < B && v < t;
  const int cnt = __popc(__ballot_sync(0xffffffffu, take));
  if (take && rank < k) idx[rank] = lane;
  if (lane >= cnt && lane < k) idx[lane] = -1;
}

// compare-exchange: a <= b afterwards if up, a >= b otherwise
__device__ __forceinline__ void cas(unsigned long long& a,
                                    unsigned long long& b, bool up) {
  const unsigned long long lo = a < b ? a : b, hi = a < b ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// padded shared-memory index: one 8-byte gap after every kSortE keys, so
// the threads of a warp storing their kSortE keys hit different banks
__device__ __forceinline__ int sidx(int i) { return i + i / kSortE; }

// B > 32: one block sorts the 64-bit keys (order_key << 32 | row; unique,
// so the sort is stable by construction) of N rows (the next power of
// two, at least 512; rows past B get NaN's key, so they sort last) by
// merging, then slot r takes the row of rank r if its value is below
// t_local. Thread t sorts keys t kSortE .. + kSortE - 1 in registers (a
// bitonic network), then runs of 16, 32, ... N / 2 keys are merged in
// pairs through shared memory: thread t finds where its kSortE outputs
// start in the pair by a binary search along the merge path and merges
// them into registers, reading one key per output.
__global__ void __launch_bounds__(kSortThreads)
gate_select_sort_kernel(const float* __restrict__ conf, int B,
                        const float* __restrict__ t_local,
                        const int* __restrict__ n_valid, int k, int N,
                        int* __restrict__ idx) {
  extern __shared__ unsigned long long keys[];  // [sidx(N)]
  const int base = threadIdx.x * kSortE;
  const int n = *n_valid;
  unsigned long long r[kSortE];
#pragma unroll
  for (int e = 0; e < kSortE; ++e) {
    const int i = base + e;
    const uint32_t key =
        i < B ? order_key(i < n ? conf[i] : INFINITY) : 0xffffffffu;
    r[e] = static_cast<unsigned long long>(key) << 32 |
           static_cast<uint32_t>(i);
  }
#pragma unroll
  for (int size = 2; size <= kSortE; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int e = 0; e < kSortE; ++e)
        if ((e & j) == 0) cas(r[e], r[e + j], (e & size) == 0);
  for (int run = kSortE; run < N; run <<= 1) {
#pragma unroll
    for (int e = 0; e < kSortE; ++e) keys[sidx(base + e)] = r[e];
    __syncthreads();
    // the pair of runs A, B this thread's outputs come from, and their
    // first position kk in the merged pair: i keys of A and kk - i of B
    // precede it, i the least with A[i] > B[kk - i - 1]
    const int a0 = base & ~(2 * run - 1), b0 = a0 + run, kk = base - a0;
    int lo = max(0, kk - run), hi = min(kk, run);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[sidx(a0 + mid)] < keys[sidx(b0 + kk - mid - 1)])
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, ib = kk - lo;  // an exhausted run reads as ~0, above all
    unsigned long long a = ia < run ? keys[sidx(a0 + ia)] : ~0ull;
    unsigned long long b = ib < run ? keys[sidx(b0 + ib)] : ~0ull;
#pragma unroll
    for (int e = 0; e < kSortE; ++e) {
      const bool ta = a < b;
      r[e] = ta ? a : b;
      ia += ta;
      ib += !ta;
      const int pos = ta ? ia : ib;
      const unsigned long long next =
          pos < run ? keys[sidx((ta ? a0 : b0) + pos)] : ~0ull;
      a = ta ? next : a;
      b = ta ? b : next;
    }
    __syncthreads();  // every pair read before the next round's stores
  }
  const float t = *t_local;
#pragma unroll
  for (int e = 0; e < kSortE; ++e) {
    const int i = base + e;
    if (i < k)
      idx[i] = key_value(static_cast<uint32_t>(r[e] >> 32)) < t
                   ? static_cast<int>(static_cast<uint32_t>(r[e]))
                   : -1;
  }
}

}  // namespace

// logits [B, C] (dtype code DT_F32 / DT_BF16, contiguous) -> out [2, B]:
// conf (f32), pred (i32). cluster: the wrapper's plan (blocks per row, or
// 0 for one warp per row).
extern "C" int gate_score(const void* logits, int dtype, int B, int C,
                          int cluster, int sup, void* out, void* stream) {
  return launch_vocab_stats<vstats::EPI_GATE>(
      logits, dtype, B, C, cluster, sup, out,
      static_cast<cudaStream_t>(stream));
}

// conf [B] f32, t_local f32 scalar, n_valid i32 scalar (device) -> idx [k]
// (1 <= k <= B <= 16384: the sort's keys fill at most 136 KB of shared
// memory).
extern "C" int gate_select(const void* conf, int B, const void* t_local,
                           const void* n_valid, int k, void* idx,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(conf);
  const float* t = static_cast<const float*>(t_local);
  const int* n = static_cast<const int*>(n_valid);
  int* out = static_cast<int*>(idx);
  if (B < 1 || k < 1 || k > B || B > kSortMax) return cudaErrorInvalidValue;
  if (B <= 32) {
    gate_select_warp_kernel<<<1, 32, 0, s>>>(c, B, t, n, k, out);
    return cudaGetLastError();
  }
  int N = 32 * kSortE;
  while (N < B) N <<= 1;
  const int smem = (N + N / kSortE) * 8;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      smem_set, reinterpret_cast<const void*>(gate_select_sort_kernel),
      (kSortMax + kSortMax / kSortE) * 8);
  if (err != cudaSuccess) return err;
  gate_select_sort_kernel<<<1, N / kSortE, smem, s>>>(c, B, t, n, k, N, out);
  return cudaGetLastError();
}
