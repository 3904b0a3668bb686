// RWKV6 "Finch" time-mix recurrence for Hopper: per (batch, head),
//   y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i]
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// over t = 0..T-1, starting from s0; returns y [B,T,H,M] f32 and S_T.
//
// Replaces src/repro/kernels/rwkv6_scan/kernel.py:
//   _kernel (rwkv6_scan, pallas_call at :72).
// The JAX model runs the same recurrence as the jnp scan _time_mix_core
// (src/repro/models/rwkv6.py:89); the port holds this kernel to it.
//
// Bound on the H100: neither bytes nor operations, but the serial chain
// over T. At the generate prefill (B 8, T 512, H 32, M 64, bf16 r/k/v,
// f32 w) the work is ~126 MB (r/k/v 50 MB, w 34 MB, y 34 MB, state 8 MB;
// 0.038 ms at 3.35 TB/s) and ~2.1 GFLOP of fp32 FMAs (4 M^2 per token and
// head; 0.032 ms at 67 TFLOP/s), but each token's update needs the state
// the previous one left: 512 dependent steps, each a few hundred cycles
// of one thread's FMAs and shared-memory reads, whatever the card's width.
//
// Design. The TPU kernel walks (B*H, time chunks) with the [M, M] state
// in VMEM scratch and a fori_loop over the tokens of a chunk; its wrapper
// first transposes r/k/v/w to [B*H, T, M], a copy as large as the
// kernel's own reads. Here the inputs are indexed in place, [B,T,H,M] by
// their offsets, and the state never leaves registers: column j of S is
// independent of the other columns (each step only scales rows and adds
// k v^T), so one thread owns one column S[:, j] as M fp32 registers and a
// block of M threads serves one (b, h). B*H blocks (256 at B = 8, H = 32)
// cover the 132 SMs twice. Per chunk of TC tokens the block stages r, k,
// v and w (as f32) and each token's bonus term sum_i r_i u_i k_i in
// shared memory with coalesced loads, so no global load sits on the
// serial chain; then every thread runs the chunk's steps reading those
// rows as broadcasts; y is stored per token, one coalesced row of M
// floats. Any T >= 1 (decode T = 1, a serve window's 48, a 512-token
// prompt) needs no padding: the last chunk is clipped. s0 is read once
// and S_T written once per block.
//
// In-place state: decode passes s0 and S_T as the same buffer (the
// layer's slice of the recurrent state). That is safe because every
// thread reads its whole column of s0 into registers before the first
// step and writes only that column of S_T after the last; no thread
// touches another's column, and no block another's (b, h). Hence s0 and
// sT carry no __restrict__.

#include "kernel_common.cuh"

namespace {

constexpr int TC = 32;  // tokens staged per chunk

template <typename T, int M>
__global__ void __launch_bounds__(M)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* sT, int Tn, int H) {
  __shared__ float Rs[TC][M];
  __shared__ float Ks[TC][M];
  __shared__ float Vs[TC][M];
  __shared__ float Ws[TC][M];
  __shared__ float Us[M];
  __shared__ float Bonus[TC];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const size_t row = static_cast<size_t>(H) * M;       // stride of t
  const size_t base = static_cast<size_t>(b) * Tn * row
      + static_cast<size_t>(h) * M;                     // (b, t=0, h, 0)
  const size_t sbase = static_cast<size_t>(bh) * M * M;

  float S[M];
#pragma unroll
  for (int i = 0; i < M; ++i) S[i] = s0[sbase + i * M + j];
  Us[j] = u[h * M + j];

  for (int t0 = 0; t0 < Tn; t0 += TC) {
    const int tc = min(TC, Tn - t0);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int idx = j; idx < tc * M; idx += M) {
      const int tt = idx / M, i = idx % M;
      const size_t off = base + (t0 + tt) * row + i;
      Rs[tt][i] = to_f32(r[off]);
      Ks[tt][i] = to_f32(k[off]);
      Vs[tt][i] = to_f32(v[off]);
      Ws[tt][i] = w[off];
    }
    __syncthreads();
    for (int tt = j; tt < tc; tt += M) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < M; ++i) acc += Rs[tt][i] * Us[i] * Ks[tt][i];
      Bonus[tt] = acc;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const float vj = Vs[tt][j];
      // four partial sums break the dependent chain of the dot product
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < M; i += 4) {
        y0 += Rs[tt][i] * S[i];
        y1 += Rs[tt][i + 1] * S[i + 1];
        y2 += Rs[tt][i + 2] * S[i + 2];
        y3 += Rs[tt][i + 3] * S[i + 3];
        S[i] = Ws[tt][i] * S[i] + Ks[tt][i] * vj;
        S[i + 1] = Ws[tt][i + 1] * S[i + 1] + Ks[tt][i + 1] * vj;
        S[i + 2] = Ws[tt][i + 2] * S[i + 2] + Ks[tt][i + 2] * vj;
        S[i + 3] = Ws[tt][i + 3] * S[i + 3] + Ks[tt][i + 3] * vj;
      }
      y[base + (t0 + tt) * row + j] =
          (y0 + y1) + (y2 + y3) + vj * Bonus[tt];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) sT[sbase + i * M + j] = S[i];
}

template <typename T, int M>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sT, int B, int Tn, int H, cudaStream_t s) {
  rwkv6_scan_kernel<T, M><<<B * H, M, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), Tn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_m(int M, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* sT, int B, int Tn, int H, cudaStream_t s) {
  switch (M) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, y, sT, B, Tn, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sT, B, Tn, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sT, B, Tn, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v [B, T, H, M] (dtype code DT_F32 / DT_BF16, contiguous); w
// [B, T, H, M] f32; u [H, M] f32; s0 [B, H, M, M] f32 -> y [B, T, H, M]
// f32, sT [B, H, M, M] f32. sT may be s0 (in-place state update).
// M in {16, 32, 64}; T >= 1.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* sT, int dtype, int B, int Tn, int H,
                          int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_m<__nv_bfloat16>(M, r, k, v, w, u, s0, y, sT, B, Tn, H, s);
  return launch_m<float>(M, r, k, v, w, u, s0, y, sT, B, Tn, H, s);
}
