// The vocabulary statistics of gate_stats.cuh (max and first argmax,
// second max, sum exp, sum exp * x and, for Gini only, sum exp^2) over
// each row of a logits matrix [B, C], and the epilogue of maxconf or of
// the confidence gate's score: one launch per call, no global scratch.
// Used by maxconf.cu and confidence_gate.cu (gate_score); its fold and
// merge also by fused_head_gate.cu.
//
// Replaces, with those two files, the statistics pass of
//   src/repro/kernels/maxconf/kernel.py: _kernel (pallas_call at :93)
//   src/repro/kernels/confidence_gate/kernel.py: _score_kernel (:160).
//
// Bound on the H100: memory. Each logit is read once and costs one exp
// and a few FMAs: at [8, 64000] f32 (the generate path, 2 MB) 0.6 us at
// 3.35 TB/s, at [32, 152064] f32 (19.5 MB) 5.8 us; at the serve path's
// [32, 8] the call is launch latency.
//
// Design. The TPU walks a row's vocabulary blocks in order on one core
// and folds each [rows, 2048] VMEM block into running statistics
// (_fold_stats: block max, first-index argmax, second max with the argmax
// masked, one exp per element against the block max, one rescale per
// block). Here each thread folds the same way a register block of 8
// logits at a time: one 16-byte load of bf16, or two of f32. Each thread
// keeps kUnroll 16-byte loads in flight, and issues the next kUnroll
// before it folds the last, so the copies overlap the arithmetic. The
// exps are ex2.approx on log2(e)-scaled differences (MUFU, as __expf).
// Each thread keeps two running statistics, for its even and its odd
// register blocks, so two merge chains overlap; they merge at the end.
// The ragged edges need no masking in the loop: a row start that is not
// 16-byte aligned (odd V in bf16 or f32, a storage offset) is folded as
// scalar head elements, and the columns after the last whole vector as
// scalar tail elements, in the same kernel. Two launch shapes, chosen by
// the wrapper's plan (kernels/confidence_gate/kernel.py, stats_plan):
//   - wide rows: a thread-block cluster of `cluster` blocks per row, each
//     folding a contiguous run of the row's vectors; every block writes
//     its statistics into slot [rank] of rank 0's shared memory (a
//     distributed shared memory store), one cluster barrier, and rank 0
//     merges the slots in rank order and writes the row's outputs. No
//     block touches a peer's shared memory after that barrier, so any
//     block may exit after it; a barrier arrival at the start, waited on
//     before the store, makes sure rank 0 is running before it is
//     written to.
//   - narrow rows (the serve path's C = 8): one warp per row, eight rows
//     per block, no cluster.
// Merges run in a fixed order (lanes by a shuffle tree, warps by warp 0,
// ranks in order), and keep merge's explicit first-index tie rule;
// a maximum found twice leaves m2 == m1, so PCS is 0 there as in
// _fold_stats. Only Gini reads s2: it is carried only where the gate
// scores Gini (template S2).

#pragma once

#include <cooperative_groups.h>

#include "gate_stats.cuh"

namespace vstats {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // narrow rows: a warp each
constexpr int kMaxCluster = 8;               // the portable cluster size
constexpr int kUnroll = 8;                    // 16-byte loads in flight
constexpr int kBlock = 8;                     // logits per register block
constexpr float kLog2e = 1.4426950408889634f;
enum { EPI_GATE = 0, EPI_MAXCONF = 1 };

// 16 bytes of logits as a register block of N floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const float4& r,
                                                float (&x)[N]) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  // bf16 is the top half of an f32: element 2i is word i's low half
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&x)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 2^x (MUFU.EX2; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// b merged into a: _fold_stats' rescaling algebra and a first-index tie
// rule, with one exp (the side with the larger max keeps its scale,
// exactly 1)
template <bool S2>
__device__ __forceinline__ void merge(GateStats& a, const GateStats& b) {
  const bool a_hi = a.m1 >= b.m1;
  const float hi = a_hi ? a.m1 : b.m1, lo = a_hi ? b.m1 : a.m1;
  const float c = ex2((lo - hi) * kLog2e);
  const float ca = a_hi ? 1.f : c, cb = a_hi ? c : 1.f;
  a.a1 = (b.m1 > a.m1 || (b.m1 == a.m1 && b.a1 < a.a1)) ? b.a1 : a.a1;
  a.m2 = fmaxf(lo, fmaxf(a.m2, b.m2));
  a.m1 = hi;
  a.s = a.s * ca + b.s * cb;
  a.t = a.t * ca + b.t * cb;
  if constexpr (S2) a.s2 = a.s2 * ca * ca + b.s2 * cb * cb;
}

// fold a register block x of N logits into st, as _fold_stats folds a
// VMEM block; x is made of loads of NV logits each, stride columns apart,
// the first at column col0 (masked logits hold GATE_NEG)
template <bool S2, int N, int NV>
__device__ __forceinline__ void fold(GateStats& st, const float (&x)[N],
                                     int col0, int stride) {
  GateStats b;
  b.m1 = x[0];
  int bi = 0;
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (x[i] > b.m1) {
      b.m1 = x[i];
      bi = i;
    }
  b.m2 = GATE_NEG;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i != bi) b.m2 = fmaxf(b.m2, x[i]);
  b.a1 = col0 + bi / NV * stride + bi % NV;
  b.s = b.t = b.s2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = ex2((x[i] - b.m1) * kLog2e);
    b.s += e;
    b.t = fmaf(e, x[i], b.t);
    if constexpr (S2) b.s2 = fmaf(e, e, b.s2);
  }
  merge<S2>(st, b);
}

template <typename T, bool S2>
__device__ __forceinline__ void fold_one(GateStats& st, const T* row,
                                         int col) {
  const float x[1] = {to_f32(row[col])};
  fold<S2, 1, 1>(st, x, col, 0);
}

// kUnroll loads: vectors v, v + nt, ... of the row's aligned body, those
// at or past v1 left zero
template <typename Raw>
__device__ __forceinline__ void load_group(Raw (&r)[kUnroll], const Raw* vp,
                                           int v, int v1, int nt) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    r[u] = v + u * nt < v1 ? __ldg(vp + v + u * nt) : Raw{};
}

// fold a group of kUnroll loads (vectors v + u nt) in column order, a
// register block of kBlock logits at a time, the blocks alternately into
// st and alt (two merge chains in flight); logits of vectors at or past
// v1 are masked
template <typename T, bool S2>
__device__ __forceinline__ void fold_group(
    GateStats& st, GateStats& alt, const typename Vec<T>::Raw (&r)[kUnroll],
    int head, int v, int v1, int nt) {
  using V = Vec<T>;
  constexpr int L = kBlock / V::N;  // loads per register block
#pragma unroll
  for (int u = 0; u < kUnroll; u += L) {
    if (v + u * nt >= v1) break;
    float x[kBlock];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float y[V::N];
      V::unpack(r[u + l], y);
      const bool ok = v + (u + l) * nt < v1;
#pragma unroll
      for (int i = 0; i < V::N; ++i) x[l * V::N + i] = ok ? y[i] : GATE_NEG;
    }
    fold<S2, kBlock, V::N>(u / L % 2 ? alt : st, x,
                           head + (v + u * nt) * V::N, nt * V::N);
  }
}

// this thread's vectors v0 + tid, v0 + tid + nt, ... below v1 of the row's
// aligned body (which starts `head` columns in): kUnroll loads in flight,
// the next group issued before the current one is folded; the even and
// odd register blocks are merged at the end
template <typename T, bool S2>
__device__ __forceinline__ void fold_vectors(GateStats& st, const T* row,
                                             int head, int v0, int v1,
                                             int tid, int nt) {
  using Raw = typename Vec<T>::Raw;
  const Raw* vp = reinterpret_cast<const Raw*>(row + head);
  Raw cur[kUnroll];
  GateStats alt = gate_empty();
  int v = v0 + tid;
  load_group(cur, vp, v, v1, nt);
  while (v < v1) {
    Raw nxt[kUnroll];
    load_group(nxt, vp, v + kUnroll * nt, v1, nt);
    fold_group<T, S2>(st, alt, cur, head, v, v1, nt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    v += kUnroll * nt;
  }
  merge<S2>(st, alt);
}

// a row's scalar head (up to its first 16-byte boundary) and the number
// of whole vectors after it; the rest is the scalar tail
template <typename T>
__device__ __forceinline__ void row_split(const T* row, int C, int& head,
                                          int& nvec) {
  constexpr int N = Vec<T>::N;
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
  head = min(C, mis ? N - mis : 0);
  nvec = (C - head) / N;
}

template <bool S2>
__device__ __forceinline__ GateStats shfl_down(const GateStats& v, int off) {
  GateStats r;
  r.m1 = __shfl_down_sync(0xffffffffu, v.m1, off);
  r.m2 = __shfl_down_sync(0xffffffffu, v.m2, off);
  r.s = __shfl_down_sync(0xffffffffu, v.s, off);
  r.t = __shfl_down_sync(0xffffffffu, v.t, off);
  r.s2 = 0.f;
  if constexpr (S2) r.s2 = __shfl_down_sync(0xffffffffu, v.s2, off);
  r.a1 = __shfl_down_sync(0xffffffffu, v.a1, off);
  return r;
}

// full-warp tree (fixed order); lane 0 holds the result
template <bool S2>
__device__ __forceinline__ GateStats warp_reduce(GateStats v) {
  for (int off = 16; off > 0; off >>= 1) merge<S2>(v, shfl_down<S2>(v, off));
  return v;
}

// out: maxconf [4, B] (pred as i32, max_softmax, pcs, entropy); the gate
// [2, B] (conf, pred as i32)
template <int EPI>
__device__ __forceinline__ void epilogue(const GateStats& st, int sup,
                                         int row, int B, float* out) {
  int* outi = reinterpret_cast<int*>(out);
  if constexpr (EPI == EPI_MAXCONF) {
    const float z = st.s;
    outi[row] = st.a1;
    out[B + row] = 1.f / z;                                // exp(m1 - m1) / s
    out[2 * B + row] = (1.f - expf(st.m2 - st.m1)) / z;
    out[3 * B + row] = (st.m1 + logf(z)) - st.t / z;
  } else {
    out[row] = gate_conf(st, sup);
    outi[B + row] = st.a1;
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int EPI, bool S2, bool WIDE>
__global__ void __launch_bounds__(kThreads)
vocab_stats_kernel(const T* __restrict__ x, int B, int C, int sup,
                   float* __restrict__ out) {
  constexpr int N = Vec<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  GateStats st = gate_empty();
  if constexpr (!WIDE) {
    const int row = blockIdx.x * kRowsPerBlock + warp;
    if (row >= B) return;  // warp-uniform; no block-wide barrier follows
    const T* xr = x + static_cast<size_t>(row) * C;
    int head, nvec;
    row_split(xr, C, head, nvec);
    if (lane < head) fold_one<T, S2>(st, xr, lane);
    fold_vectors<T, S2>(st, xr, head, 0, nvec, lane, 32);
    const int tail0 = head + nvec * N;
    if (lane < C - tail0) fold_one<T, S2>(st, xr, tail0 + lane);
    st = warp_reduce<S2>(st);
    if (lane == 0) epilogue<EPI>(st, sup, row, B, out);
  } else {
    namespace cg = cooperative_groups;
    __shared__ GateStats slots[kMaxCluster];       // rank 0's: one per rank
    __shared__ GateStats warp_st[kThreads / 32];
    cg::cluster_group cluster = cg::this_cluster();
    cluster_arrive_relaxed();
    const int ncl = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int row = blockIdx.x / ncl;
    const T* xr = x + static_cast<size_t>(row) * C;
    int head, nvec;
    row_split(xr, C, head, nvec);
    const int per = (nvec + ncl - 1) / ncl;
    const int v0 = min(nvec, rank * per), v1 = min(nvec, v0 + per);
    const int tail0 = head + nvec * N;
    if (rank == 0 && threadIdx.x < head) fold_one<T, S2>(st, xr, threadIdx.x);
    fold_vectors<T, S2>(st, xr, head, v0, v1, threadIdx.x, kThreads);
    if (rank == ncl - 1 && threadIdx.x < C - tail0)
      fold_one<T, S2>(st, xr, tail0 + threadIdx.x);
    st = warp_reduce<S2>(st);
    if (lane == 0) warp_st[warp] = st;
    __syncthreads();
    if (warp == 0) {
      st = warp_reduce<S2>(lane < kThreads / 32 ? warp_st[lane]
                                                : gate_empty());
    }
    cluster_wait();  // every block of the cluster is running
    if (threadIdx.x == 0) *cluster.map_shared_rank(&slots[rank], 0) = st;
    cluster.sync();  // release / acquire: rank 0 sees every slot
    if (rank == 0 && threadIdx.x == 0) {
      GateStats r = slots[0];
      for (int i = 1; i < ncl; ++i) merge<S2>(r, slots[i]);
      epilogue<EPI>(r, sup, row, B, out);
    }
  }
}

template <typename T, int EPI, bool S2>
cudaError_t launch_typed(const void* x, int B, int C, int cluster, int sup,
                         float* out, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (cluster == 0) {
    vocab_stats_kernel<T, EPI, S2, false>
        <<<(B + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
            xt, B, C, sup, out);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const auto kern = vocab_stats_kernel<T, EPI, S2, true>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, xt, B, C, sup, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace vstats

// logits [B, C] (dtype code DT_F32 / DT_BF16, rows contiguous, any
// alignment of the elements' type) -> out (vstats::epilogue's layout).
// cluster: blocks per row (1..8), or 0 for one warp per row.
template <int EPI>
cudaError_t launch_vocab_stats(const void* logits, int dtype, int B, int C,
                               int cluster, int sup, void* out,
                               cudaStream_t s) {
  using namespace vstats;
  if (B < 1 || C < 1 || cluster < 0 || cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  if constexpr (EPI == EPI_GATE) {
    if (sup == SUP_GINI)
      return dtype == DT_F32
                 ? launch_typed<float, EPI, true>(logits, B, C, cluster, sup,
                                                  o, s)
                 : launch_typed<__nv_bfloat16, EPI, true>(logits, B, C,
                                                          cluster, sup, o, s);
  }
  return dtype == DT_F32
             ? launch_typed<float, EPI, false>(logits, B, C, cluster, sup, o,
                                               s)
             : launch_typed<__nv_bfloat16, EPI, false>(logits, B, C, cluster,
                                                       sup, o, s);
}
