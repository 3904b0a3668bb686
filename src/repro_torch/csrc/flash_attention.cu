// Flash-attention prefill (GQA, causal, optional sliding window) for Hopper.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   _kernel (flash_attention, pallas_call at :114).
//
// Bound on the H100. Causal prefill does ~2*B*H*T*S*hd flops (half of
// 4*B*H*T*S*hd) on bytes that are only the q/k/v/o tensors, so at long T
// it is bound by operations (989 TFLOP/s on bf16 tensor cores); at the
// cascade's serving shape (T = 48) it is bound by launch latency and the
// bytes of q/k/v. This first version computes in fp32 FMA on the CUDA
// cores, well short of the tensor-core bound; wgmma and TMA are later work.
//
// Design. One block per (batch x KV head, tile of BR=16 query rows). As on
// the TPU (kernel.py:106-109) the G query heads of a KV group are fused
// into the rows: row r of the group is (t = r / G, g = r % G), so every row
// of a block shares the same K and V. KV tiles of BC=32 keys are staged
// through shared memory as fp32; each thread owns one row and 4 key columns
// of the score tile and 1/8 of the row's output, with an fp32 online
// softmax (running max m, sum l) and an fp32 accumulator. Causal and
// sliding-window masks are applied in the kernel, tiles that no row of the
// block can see are skipped by the loop bounds, and ragged T and S edges
// are masked: no divisibility requirement. Inputs are bf16 or f32; the
// output has the input's dtype.

#include "kernel_common.cuh"

namespace {

constexpr int BR = 16;        // query rows per block
constexpr int BC = 32;        // keys per staged tile
constexpr int kThreads = 128; // 8 threads per row

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Tq,
                     int S, int H, int KH, int causal, int window,
                     float scale) {
  __shared__ float Qs[BR][HD + 1];
  __shared__ float Ks[BC][HD + 1];
  __shared__ float Vs[BC][HD + 1];
  __shared__ float Ps[BR][BC + 1];
  constexpr int NJ = HD / 8;  // output columns per thread

  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int r0 = blockIdx.x * BR;
  const int nrows = Tq * G;
  const int tid = threadIdx.x;
  const int row = tid >> 3, sub = tid & 7;

  for (int e = tid; e < BR * HD; e += kThreads) {
    const int i = e / HD, d = e % HD, r = r0 + i;
    float x = 0.f;
    if (r < nrows) {
      const int t = r / G, g = r % G;
      x = to_f32(q[(((size_t)b * Tq + t) * H + kh * G + g) * HD + d]);
    }
    Qs[i][d] = x;
  }

  const int my_r = r0 + row;
  const bool row_ok = my_r < nrows;
  const int my_t = row_ok ? my_r / G : 0;
  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + BR, nrows) - 1) / G;
  int s_begin = 0, s_end = S;
  if (causal) s_end = min(S, t_hi + 1);
  if (window > 0) s_begin = max(0, t_lo - window + 1) / BC * BC;

  float m = -INFINITY, l = 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += BC) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int e = tid; e < BC * HD; e += kThreads) {
      const int c = e / HD, d = e % HD, s = s0 + c;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * KH + kh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[c][d] = kx;
      Vs[c][d] = vx;
    }
    __syncthreads();

    float sc[BC / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      const int c = sub + 8 * j, s = s0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[row][d], Ks[c][d], dot);
      const bool ok = row_ok && s < S && (!causal || s <= my_t) &&
                      (window <= 0 || s > my_t - window);
      sc[j] = ok ? dot * scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    // the 8 threads of a row are 8 consecutive lanes
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    float alpha = 1.f, psum = 0.f;
    if (m_new != -INFINITY) {
      alpha = expf(m - m_new);
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        sc[j] = expf(sc[j] - m_new);
        psum += sc[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) sc[j] = 0.f;
    }
    for (int off = 4; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) Ps[row][sub + 8 * j] = sc[j];
    __syncwarp();  // a row's P is written and read by the same warp
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    for (int c = 0; c < BC; ++c) {
      const float p = Ps[row][c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = fmaf(p, Vs[c][sub + 8 * j], acc[j]);
    }
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int g = my_r % G;
    T* out = o + (((size_t)b * Tq + my_t) * H + kh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[sub + 8 * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Tq, int S, int H, int KH, int causal, int window, float scale,
            cudaStream_t s) {
  const int G = H / KH;
  const dim3 grid((Tq * G + BR - 1) / BR, B * KH);
  flash_prefill_kernel<T, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KH, causal,
      window, scale);
}

}  // namespace

// q [B, Tq, H, HD], k/v [B, S, KH, HD] -> o [B, Tq, H, HD], all contiguous
// and of one dtype (DT_F32 / DT_BF16); HD is 64 or 128; H % KH == 0.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, int dtype, int B, int Tq, int S, int H,
                             int KH, int HD, int causal, int window,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (HD == 128)
      launch<float, 128>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
    else
      launch<float, 64>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
  } else {
    if (HD == 128)
      launch<__nv_bfloat16, 128>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                                 scale, s);
    else
      launch<__nv_bfloat16, 64>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                                scale, s);
  }
  return cudaGetLastError();
}
