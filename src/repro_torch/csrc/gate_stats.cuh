// Online-softmax running statistics of the confidence gate, shared by the
// one-launch pass of maxconf and the gate's score (vocab_stats.cuh, which
// folds and merges them) and the fused head gate (fused_head_gate.cu).
// Per row:
//   m1, a1 : max logit and its column (first index on ties) -> pred
//   m2     : second-largest logit                           -> PCS
//   s      : sum exp(x - m1)                                -> normaliser
//   t      : sum exp(x - m1) * x                            -> entropy
//   s2     : sum exp(2 (x - m1))                            -> Gini
// vstats::merge is the algebra of _fold_stats in
// src/repro/kernels/confidence_gate/kernel.py (exact rescaling to the new
// max), with an explicit first-index tie rule for a1, so any merge order
// keeps the first maximal column.
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
