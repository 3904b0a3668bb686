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
// scratch. Blocks on the H100 run in parallel and in no order, and at B=32
// one block per row tile would leave most of the 132 SMs idle, so the class
// axis is split: grid = (vocab splits, rows); each block folds its slice
// into partial statistics (gate_stats.cuh) and a second pass merges the
// partials per row with the same algebra and applies the supervisor's
// epilogue. The ragged class edge is masked in the kernel, so no -1e30
// padding copy is made. The supervisor is a runtime code. Select is one
// block doing k rounds of a block-wide argmin (first index on ties), with
// t_local and n_valid read from device scalars so a new threshold needs no
// new launch configuration (and a CUDA graph no recapture).

#include <climits>

#include "gate_stats.cuh"

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

// logits [B, C] (dtype code DT_F32 / DT_BF16) -> conf [B] f32, pred [B] i32.
// part: scratch of B * nsplit GateStats (24 bytes each).
extern "C" int gate_score(const void* logits, int dtype, int B, int C,
                          int nsplit, int sup, void* part, void* conf,
                          void* pred, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GateStats* p = static_cast<GateStats*>(part);
  cudaError_t err = launch_gate_partial(logits, dtype, B, C, nsplit, p, s);
  if (err != cudaSuccess) return err;
  return launch_gate_finish(p, B, nsplit, sup, static_cast<float*>(conf),
                            static_cast<int*>(pred), s);
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
