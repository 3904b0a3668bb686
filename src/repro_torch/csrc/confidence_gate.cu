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
// The select pass touches B floats and is bound by launch latency.
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
// code. Select is one block doing k rounds of a block-wide argmin (first
// index on ties), with t_local and n_valid read from device scalars so a
// new threshold needs no new launch configuration (and a CUDA graph no
// recapture).

#include <climits>

#include "vocab_stats.cuh"

namespace {

constexpr int kSelectThreads = 256;

__device__ __forceinline__ void argmin_step(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
gate_select_kernel(const float* __restrict__ conf, int B,
                   const float* __restrict__ t_local,
                   const int* __restrict__ n_valid, int k,
                   int* __restrict__ idx) {
  extern __shared__ float c[];  // [B] masked confidences
  __shared__ float wv[kSelectThreads / 32];
  __shared__ int wi[kSelectThreads / 32];
  const float t = *t_local;
  const int n = *n_valid;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < B; i += kSelectThreads)
    c[i] = i < n ? conf[i] : INFINITY;
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    float v = INFINITY;
    int vi = INT_MAX;
    for (int i = threadIdx.x; i < B; i += kSelectThreads) argmin_step(v, vi, c[i], i);
    for (int off = 16; off > 0; off >>= 1)
      argmin_step(v, vi, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, vi, off));
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = vi;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kSelectThreads / 32 ? wv[lane] : INFINITY;
      vi = lane < kSelectThreads / 32 ? wi[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        argmin_step(v, vi, __shfl_down_sync(0xffffffffu, v, off),
                    __shfl_down_sync(0xffffffffu, vi, off));
      if (lane == 0) {
        const bool take = v < t;
        idx[r] = take ? vi : -1;
        if (take) c[vi] = INFINITY;
      }
    }
    __syncthreads();
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

// conf [B] f32, t_local f32 scalar, n_valid i32 scalar (device) -> idx [k].
extern "C" int gate_select(const void* conf, int B, const void* t_local,
                           const void* n_valid, int k, void* idx,
                           void* stream) {
  gate_select_kernel<<<1, kSelectThreads, B * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), B, static_cast<const float*>(t_local),
      static_cast<const int*>(n_valid), k, static_cast<int*>(idx));
  return cudaGetLastError();
}
