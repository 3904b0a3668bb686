// Mahalanobis distance for the MDSA supervisor on Hopper:
//   d[b] = sqrt(max((x_b - mu)^T P (x_b - mu), 0))   for each row b,
// in full fp32 on the CUDA cores (the TPU kernel asks for
// Precision.HIGHEST; TF32 would keep ~3 decimal digits).
//
// Replaces src/repro/kernels/mdsa/kernel.py:
//   _kernel (mdsa_pallas, pallas_call at :61).
// The JAX supervisor computes the same function as a jnp einsum
// (src/repro/core/supervisors.py:122, mdsa_confidence); the port holds
// this kernel to it.
//
// Bound on the H100: operations. With Y = X - mu, the quadratic form is
// rowsum((Y P) o Y): 2 B D^2 fp32 flops against D^2 + 2 B D floats read.
// At [256, 4096] x [4096, 4096] that is 8.6 GFLOP (0.128 ms at the fp32
// CUDA-core peak of 67 TFLOP/s) against 71 MB (0.021 ms at 3.35 TB/s).
// On the supervisor path (a surrogate's penultimate activations, D = 64)
// the call is a few microseconds of launch latency.
//
// Design. The TPU kernel walks (batch blocks, j blocks, i blocks) in order
// with z = Y_i P[i, j] accumulated in VMEM scratch and d2 carried across
// the j axis. On the H100 blocks run in parallel and in no order, so a
// block owns one tile of Z = Y P (64 rows x 64 columns j), accumulated
// over i-tiles of 16 in registers (4 x 4 outputs per thread, operands
// staged in shared memory), and folds its tile into a partial
// rowsum(Z_tile o Y[:, j-tile]) per row, written to a [D/64, B] buffer. A
// second pass sums a row's partials in a fixed order and takes the sqrt:
// no atomics, so the result is deterministic. x - mu is folded into the
// tile loads (no Y copy), and the ragged edges of B and D are masked in
// the kernel (no padding to 128, any B and D). A [256, 4096] call gives
// 64 x 4 = 256 blocks, about two per SM. No double buffering and no
// tensor cores: a first, simple kernel.

#include "kernel_common.cuh"

namespace {

constexpr int BM = 64;    // rows (batch) per tile
constexpr int BN = 64;    // columns j per tile
constexpr int BK = 16;    // depth i per staged step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
mdsa_partial_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ P, float* __restrict__ part,
                    int B, int D) {
  __shared__ float As[BK][BM + 1];  // Y tile, transposed; padded rows
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float Mu[BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int rr = idx / BK, kk = idx % BK;
      const int row = m0 + rr, col = k0 + kk;
      As[kk][rr] = (row < B && col < D)
          ? x[static_cast<size_t>(row) * D + col] - mu[col] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BK * BN / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int kk = idx / BN, cc = idx % BN;
      const int prow = k0 + kk, pcol = j0 + cc;
      Bs[kk][cc] = (prow < D && pcol < D)
          ? P[static_cast<size_t>(prow) * D + pcol] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], bb[c], acc[i][c]);
    }
    __syncthreads();
  }

  // epilogue: partial d2 over this tile's columns, rowsum(Z o Y_j)
  if (tid < BN) Mu[tid] = (j0 + tid < D) ? mu[j0 + tid] : 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    float p = 0.f;
    if (row < B) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j0 + tx * 4 + c;
        if (col < D)
          p = fmaf(acc[i][c], x[static_cast<size_t>(row) * D + col]
                   - Mu[tx * 4 + c], p);
      }
    }
    // the 16 threads of a row are 16 consecutive lanes: fixed-order tree
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (tx == 0 && row < B) part[static_cast<size_t>(blockIdx.x) * B + row] = p;
  }
}

__global__ void __launch_bounds__(256)
mdsa_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int B, int nj) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float d2 = 0.f;
  for (int jt = 0; jt < nj; ++jt) d2 += part[static_cast<size_t>(jt) * B + row];
  out[row] = sqrtf(fmaxf(d2, 0.f));
}

}  // namespace

// x [B, D], mu [D], P [D, D] (f32, contiguous) -> out [B] f32.
// part: scratch of ceil(D / 64) * B floats.
extern "C" int mdsa(const void* x, const void* mu, const void* P, void* part,
                    void* out, int B, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (D + BN - 1) / BN;
  const dim3 grid(nj, (B + BM - 1) / BM);
  mdsa_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(P), static_cast<float*>(part), B, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mdsa_finish_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, nj);
  return cudaGetLastError();
}
