// Fused local head -> confidence gate for Hopper.
//
// Replaces src/repro/kernels/fused_head_gate/kernel.py:
//   _head_gate_kernel (fused_head_gate_pallas, pallas_call at :81);
// selection reuses the gate's select kernel (confidence_gate.cu), as the
// TPU version reuses _select_kernel at :100.
//
// Bound on the H100. Reading the head weight w [D, C] dominates the bytes
// (yi-6b's head: 4096 x 64000 bf16 = 524 MB, ~156 us at 3.35 TB/s); the
// product does 2*B*D*C flops (16.8 GFLOP at B=32), which in full fp32 on
// the CUDA cores (67 TFLOP/s, no TF32: the TPU dot is f32) takes ~250 us,
// so at that shape the operations bound it, not the bytes.
//
// Design. Each block computes one [BB=32 x VB=256] logits tile in fp32 FMA
// from hidden [B, D] and a slice of w (f32, or bf16 upcast on load),
// staging DK=32-deep slices of both operands through shared memory; each
// thread owns 8 rows x 4 columns of the tile. The tile plus bias is then
// folded straight into partial online-softmax statistics (one warp per
// row), so the [B, C] logits never reach device memory; the gate's merge
// pass (gate_stats.cuh) turns the per-block partials into conf and pred.
// VB=256 keeps the re-reads of the small hidden tile (served from L2) at a
// quarter of the weight bytes per block. Ragged rows and columns are
// masked in the kernel; no padded copy of w is made.

#include "gate_stats.cuh"

namespace {

constexpr int BB = 32;   // rows per tile
constexpr int VB = 256;  // columns per tile
constexpr int DK = 32;   // reduction depth staged per step
constexpr int kThreads = 256;
constexpr int kStageFloats = BB * (DK + 1) + DK * VB;
constexpr int kTileFloats = BB * (VB + 1);
constexpr int kSmemFloats = kStageFloats > kTileFloats ? kStageFloats : kTileFloats;

template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
head_gate_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                 const float* __restrict__ bias, int B, int D, int C,
                 int nsplit, GateStats* __restrict__ part) {
  __shared__ float smem[kSmemFloats];
  float* Hs = smem;                   // [BB][DK + 1]
  float* Ws = smem + BB * (DK + 1);   // [DK][VB]
  const int tid = threadIdx.x;
  const int tx = tid & 63;            // columns tx + 64 j, j < 4
  const int ty = tid >> 6;            // rows ty + 4 i, i < 8
  const int r0 = blockIdx.y * BB;
  const int c0 = blockIdx.x * VB;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = tid; e < BB * DK; e += kThreads) {
      const int r = e / DK, kk = e % DK;
      const int gr = r0 + r, gd = d0 + kk;
      Hs[r * (DK + 1) + kk] =
          (gr < B && gd < D) ? to_f32(h[(size_t)gr * D + gd]) : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < DK * VB; e += kThreads) {
      const int kk = e / VB, c = e % VB;
      const int gd = d0 + kk, gc = c0 + c;
      Ws[kk * VB + c] =
          (gd < D && gc < C) ? to_f32(w[(size_t)gd * C + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DK; ++kk) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk * VB + tx + 64 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float hv = Hs[(ty + 4 * i) * (DK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv, wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // logits tile (+ bias) to shared memory, reusing the staging buffer
  float* L = smem;  // [BB][VB + 1]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 64 * j, gc = c0 + c;
      L[(ty + 4 * i) * (VB + 1) + c] = acc[i][j] + (gc < C ? bias[gc] : 0.f);
    }
  __syncthreads();

  // fold: one warp per row, 8 warps x 4 rows
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < BB / 8; ++rr) {
    const int r = warp * (BB / 8) + rr, gr = r0 + r;
    GateStats st = gate_empty();
    for (int c = lane; c < VB; c += 32) {
      const int gc = c0 + c;
      if (gc < C) gate_push(st, L[r * (VB + 1) + c], gc);
    }
    st = gate_warp_reduce(st);
    if (lane == 0 && gr < B) part[(size_t)gr * nsplit + blockIdx.x] = st;
  }
}

template <typename TH, typename TW>
void launch(const void* h, const void* w, const float* bias, int B, int D,
            int C, int nsplit, GateStats* part, cudaStream_t s) {
  const dim3 grid(nsplit, (B + BB - 1) / BB);
  head_gate_kernel<TH, TW><<<grid, kThreads, 0, s>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), bias, B, D, C,
      nsplit, part);
}

}  // namespace

extern "C" int fused_head_gate_tile_cols() { return VB; }

// hidden [B, D] (h_dtype), w [D, C] (w_dtype), bias [C] f32 -> conf [B] f32,
// pred [B] i32. part: scratch of B * nsplit GateStats, nsplit = ceil(C/VB).
extern "C" int fused_head_gate(const void* h, int h_dtype, const void* w,
                               int w_dtype, const void* bias, int B, int D,
                               int C, int nsplit, int sup, void* part,
                               void* conf, void* pred, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GateStats* p = static_cast<GateStats*>(part);
  const float* b = static_cast<const float*>(bias);
  if (h_dtype == DT_F32 && w_dtype == DT_F32)
    launch<float, float>(h, w, b, B, D, C, nsplit, p, s);
  else if (h_dtype == DT_F32)
    launch<float, __nv_bfloat16>(h, w, b, B, D, C, nsplit, p, s);
  else if (w_dtype == DT_F32)
    launch<__nv_bfloat16, float>(h, w, b, B, D, C, nsplit, p, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(h, w, b, B, D, C, nsplit, p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gate_finish(p, B, nsplit, sup, static_cast<float*>(conf),
                            static_cast<int*>(pred), s);
}
