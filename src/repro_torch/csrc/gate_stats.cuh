// Online-softmax running statistics of the confidence gate, shared by the
// gate's score kernel (confidence_gate.cu) and the fused head gate
// (fused_head_gate.cu). Per row:
//   m1, a1 : max logit and its column (first index on ties) -> pred
//   m2     : second-largest logit                           -> PCS
//   s      : sum exp(x - m1)                                -> normaliser
//   t      : sum exp(x - m1) * x                            -> entropy
//   s2     : sum exp(2 (x - m1))                            -> Gini
// The merge is the algebra of _fold_stats in
// src/repro/kernels/confidence_gate/kernel.py (exact rescaling to the new
// max), extended with a first-index tie rule for a1 because blocks here
// merge in no fixed order.
#pragma once

#include <math.h>

#include "kernel_common.cuh"

#define GATE_NEG (-1e30f)

// supervisor codes (order of SUPERVISORS in the Python wrapper)
enum { SUP_MAX_SOFTMAX = 0, SUP_PCS = 1, SUP_NEG_ENTROPY = 2, SUP_GINI = 3 };

struct GateStats {
  float m1, m2, s, t, s2;
  int a1;
};

__device__ __forceinline__ GateStats gate_empty() {
  GateStats r;
  r.m1 = GATE_NEG;
  r.m2 = GATE_NEG;
  r.s = 0.f;
  r.t = 0.f;
  r.s2 = 0.f;
  r.a1 = 0x7fffffff;
  return r;
}

// fold one logit x at column col into st
__device__ __forceinline__ void gate_push(GateStats& st, float x, int col) {
  if (x > st.m1) {
    const float c = expf(st.m1 - x);
    st.s = st.s * c + 1.f;
    st.t = st.t * c + x;
    st.s2 = st.s2 * c * c + 1.f;
    st.m2 = st.m1;
    st.m1 = x;
    st.a1 = col;
  } else {
    const float e = expf(x - st.m1);
    st.s += e;
    st.t += e * x;
    st.s2 += e * e;
    st.m2 = fmaxf(st.m2, x);
    if (x == st.m1 && col < st.a1) st.a1 = col;
  }
}

__device__ __forceinline__ GateStats gate_merge(const GateStats& a,
                                                const GateStats& b) {
  GateStats r;
  r.m1 = fmaxf(a.m1, b.m1);
  // best of (loser of the two maxes, both second maxes)
  r.m2 = fmaxf(fminf(a.m1, b.m1), fmaxf(a.m2, b.m2));
  const float ca = expf(a.m1 - r.m1), cb = expf(b.m1 - r.m1);
  r.s = a.s * ca + b.s * cb;
  r.t = a.t * ca + b.t * cb;
  r.s2 = a.s2 * ca * ca + b.s2 * cb * cb;
  r.a1 = (b.m1 > a.m1 || (b.m1 == a.m1 && b.a1 < a.a1)) ? b.a1 : a.a1;
  return r;
}

__device__ __forceinline__ GateStats gate_shfl_down(const GateStats& v,
                                                    int off) {
  GateStats r;
  r.m1 = __shfl_down_sync(0xffffffffu, v.m1, off);
  r.m2 = __shfl_down_sync(0xffffffffu, v.m2, off);
  r.s = __shfl_down_sync(0xffffffffu, v.s, off);
  r.t = __shfl_down_sync(0xffffffffu, v.t, off);
  r.s2 = __shfl_down_sync(0xffffffffu, v.s2, off);
  r.a1 = __shfl_down_sync(0xffffffffu, v.a1, off);
  return r;
}

// full-warp reduction; lane 0 holds the result
__device__ __forceinline__ GateStats gate_warp_reduce(GateStats v) {
  for (int off = 16; off > 0; off >>= 1) v = gate_merge(v, gate_shfl_down(v, off));
  return v;
}

// the one supervisor's confidence from the final statistics
__device__ __forceinline__ float gate_conf(const GateStats& st, int sup) {
  const float z = st.s;
  switch (sup) {
    case SUP_MAX_SOFTMAX:
      return 1.f / z;
    case SUP_PCS:
      return (1.f - expf(st.m2 - st.m1)) / z;
    case SUP_NEG_ENTROPY:
      return st.t / z - (st.m1 + logf(z));
    default:
      return st.s2 / (z * z);
  }
}

// Second pass: merge the nsplit partial statistics of each row (one warp
// per row, lanes striding over the splits) and apply the epilogue.
static __global__ void __launch_bounds__(128)
gate_finish_kernel(const GateStats* __restrict__ part, int B, int nsplit,
                   int sup, float* __restrict__ conf, int* __restrict__ pred) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  GateStats st = gate_empty();
  for (int j = lane; j < nsplit; j += 32)
    st = gate_merge(st, part[(size_t)row * nsplit + j]);
  st = gate_warp_reduce(st);
  if (lane == 0) {
    conf[row] = gate_conf(st, sup);
    pred[row] = st.a1;
  }
}

static inline cudaError_t launch_gate_finish(const GateStats* part, int B,
                                             int nsplit, int sup, float* conf,
                                             int* pred, cudaStream_t stream) {
  gate_finish_kernel<<<(B + 3) / 4, 128, 0, stream>>>(part, B, nsplit, sup,
                                                      conf, pred);
  return cudaGetLastError();
}
