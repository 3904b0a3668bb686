// Fused supervisor confidences of an LM head's logits for Hopper: one pass
// over [B, V] giving pred (argmax), max_softmax, pcs and entropy per row.
//
// Replaces src/repro/kernels/maxconf/kernel.py:
//   _kernel (maxconf_pallas, pallas_call at :93).
//
// Bound on the H100: memory. Each logit is read once and costs a handful
// of flops (an exp and a few FMAs), far below the ~20 flop/byte the card
// needs before arithmetic limits it. At the generate path's shape
// ([8, 64000] f32 = 2 MB) the floor is ~0.6 us, so one call sits at launch
// latency; at [32, 152064] f32 (19.5 MB) it is ~5.8 us.
//
// Design. The statistics (m1, a1, m2, s, t) are those of the confidence
// gate (gate_stats.cuh; s2 rides along unused), and so is the split of the
// vocabulary: the TPU walks vocab blocks of a row tile in order on one
// core and carries the statistics in VMEM scratch, but at B = 8 a block
// per row would leave most of the 132 SMs idle, so grid = (vocab splits,
// rows), each block folds its slice into partial statistics, and a second
// pass (one warp per row) merges a row's partials and applies the
// epilogue of maxconf/kernel.py:70-76. Blocks merge in no fixed order, so
// a1 carries an explicit first-index tie rule — the choice of jnp.argmax
// and of the Pallas kernel's sequential merge. The ragged vocab edge is
// masked in the kernel: no -1e30 padding copy, and any B.

#include "gate_stats.cuh"

namespace {

__global__ void __launch_bounds__(128)
maxconf_finish_kernel(const GateStats* __restrict__ part, int B, int nsplit,
                      int* __restrict__ pred, float* __restrict__ ms,
                      float* __restrict__ pcs, float* __restrict__ ent) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  const GateStats st = gate_merge_row(part, row, nsplit, lane);
  if (lane == 0) {
    const float z = st.s;
    pred[row] = st.a1;
    ms[row] = 1.f / z;                                  // exp(m1 - m1) / s
    pcs[row] = (1.f - expf(st.m2 - st.m1)) / z;
    ent[row] = (st.m1 + logf(z)) - st.t / z;
  }
}

}  // namespace

// logits [B, V] (dtype code DT_F32 / DT_BF16, contiguous) -> pred [B] i32,
// max_softmax, pcs, entropy [B] f32. part: scratch of B * nsplit GateStats.
extern "C" int maxconf(const void* logits, int dtype, int B, int V,
                       int nsplit, void* part, void* pred, void* ms,
                       void* pcs, void* ent, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GateStats* p = static_cast<GateStats*>(part);
  cudaError_t err = launch_gate_partial(logits, dtype, B, V, nsplit, p, s);
  if (err != cudaSuccess) return err;
  maxconf_finish_kernel<<<(B + 3) / 4, 128, 0, s>>>(
      p, B, nsplit, static_cast<int*>(pred), static_cast<float*>(ms),
      static_cast<float*>(pcs), static_cast<float*>(ent));
  return cudaGetLastError();
}
