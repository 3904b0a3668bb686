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
// Design. The statistics (m1, a1, m2, s, t; no s2) are those of the
// confidence gate, folded by the one-launch pass of vocab_stats.cuh: a
// thread-block cluster per row for the vocabulary (merged through
// distributed shared memory in rank order), 16-byte loads folded a
// register block at a time, and the epilogue of maxconf/kernel.py:70-76
// in the same kernel. a1 keeps the first index on ties, the choice of
// jnp.argmax and of the Pallas kernel's sequential merge. The ragged vocab
// edge and unaligned rows are handled in the kernel: no padding copy, any
// B and V.

#include "vocab_stats.cuh"

// logits [B, V] (dtype code DT_F32 / DT_BF16, contiguous) -> out [4, B]:
// pred (i32), max_softmax, pcs, entropy (f32). cluster: the wrapper's
// plan (blocks per row, or 0 for one warp per row).
extern "C" int maxconf(const void* logits, int dtype, int B, int V,
                       int cluster, void* out, void* stream) {
  return launch_vocab_stats<vstats::EPI_MAXCONF>(
      logits, dtype, B, V, cluster, 0, out, static_cast<cudaStream_t>(stream));
}
