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
// Bound on the H100: bytes, at ~126 MB for the generate prefill (B 8,
// T 512, H 32, M 64, bf16 r/k/v, f32 w: r/k/v 50 MB, w 34 MB, y 34 MB,
// state 8 MB; 0.038 ms at 3.35 TB/s) against ~2.1 GFLOP of fp32 FMAs
// (0.032 ms at 67 TFLOP/s). In practice issue sets the pace: each token's
// update needs the state the previous one left, so the T steps of a
// (b, h) run in order; the SMs must issue ~3 fp32 instructions per state
// element per token (~0.05 ms at [8x512]) and deliver every thread the
// token's r, w, k and v from shared memory.
//
// Design. A block serves one (b, h) and keeps the whole [M, M] state in
// registers. Thread (row group g, column group c) owns the A x A tile
// S[g A .. g A + A - 1][c A .. c A + A - 1], A = M / 8 (8 x 8 = 64
// registers at M = 64): 64 threads, 8 row groups x 8 column groups. The
// tile is what makes the step cheap: per token a thread reads 4 A values
// (r, w, k of its rows, v of its columns) for A^2 state elements, where
// a thread owning one column reads 3 values per element; those
// shared-memory reads, not the FMAs, set the pace of the earlier designs
// (one thread per column, and a column shared by 4 threads, both ~0.25
// ms at [8x512] on the H100). The bonus is folded into each thread's
// partial: p_g[j] = sum_{i in g} r_i S_ij + v_j sum_{i in g} (r_i u_i)
// k_i, with u_i in registers. The 8 row groups of a column group are
// adjacent lanes (lane = 8 (c mod 4) + g), so the partials are
// reduce-scattered over them by shuffles, xor 4, 2, 1 in that fixed
// order, leaving each lane one column's y_t[j]; every lane of a column
// ends with the same bits.
//
// Inputs arrive in chunks of TC tokens through a double-buffered cp.async
// ring: the raw bf16 (or f32) r/k/v rows and f32 w rows of chunk n + 1
// land while chunk n's steps run (rows of 32-256 bytes at multiples of
// their size, so the 16-byte copies are aligned). A step reads its rows
// straight from the ring, a row group's A values in one vector load (16
// bytes of bf16 at M = 64, so a warp's 8 row groups cover the 32 banks
// once), and widens bf16 to f32 in registers: no conversion pass, one
// __syncthreads per chunk. The last chunk is clipped: no row past T is
// read. Any T >= 1 (decode T = 1, a serve window's 48, a 512-token
// prompt).
//
// In-place state: decode passes s0 and S_T as the same buffer (the
// layer's slice of the recurrent state). That is safe because every
// thread reads its part of s0 into registers before the first step and
// writes only that part of S_T after the last; no thread touches
// another's, and no block another's (b, h). Hence s0 and sT carry no
// __restrict__. No atomics: each output element has one writer.

#include "kernel_common.cuh"

namespace {

constexpr int TC = 32;   // tokens per chunk
constexpr int RG = 8;    // row groups (and column groups) of the state

template <typename T, int M>
struct Layout {
  static constexpr int A = M / RG;                 // state tile is A x A
  static constexpr int NT = RG * RG;               // threads per block
  static constexpr int RAW_T = TC * M * static_cast<int>(sizeof(T));
  static constexpr int RAW_W = TC * M * 4;
  static constexpr int STAGE = 3 * RAW_T + RAW_W;  // bytes: r, k, v, w
  static constexpr int SMEM = 2 * STAGE;
};

// N consecutive floats (16-, 8- or 4-byte aligned as N allows) into
// registers, and back; N consecutive bf16 (aligned to 2 N bytes) widened
// to f32 in registers
template <int N>
__device__ __forceinline__ void load_n(float (&d)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N / 4; ++e) {
      const float4 x = reinterpret_cast<const float4*>(p)[e];
      d[4 * e] = x.x; d[4 * e + 1] = x.y; d[4 * e + 2] = x.z;
      d[4 * e + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x; d[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) d[e] = p[e];
  }
}

__device__ __forceinline__ void widen2(uint32_t x, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  a = f.x;
  b = f.y;
}

template <int N>
__device__ __forceinline__ void load_n(float (&d)[N],
                                       const __nv_bfloat16* p) {
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    widen2(x.x, d[0], d[1]); widen2(x.y, d[2], d[3]);
    widen2(x.z, d[4], d[5]); widen2(x.w, d[6], d[7]);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    widen2(x.x, d[0], d[1]); widen2(x.y, d[2], d[3]);
  } else {
    static_assert(N == 2, "head sizes 16, 32, 64");
    widen2(*reinterpret_cast<const uint32_t*>(p), d[0], d[1]);
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&d)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N / 4; ++e)
      reinterpret_cast<float4*>(p)[e] =
          make_float4(d[4 * e], d[4 * e + 1], d[4 * e + 2], d[4 * e + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = d[e];
  }
}

// Sum p over the RG = 8 lanes that differ in their low 3 bits (the row
// groups of one column group), halving the columns each level: xor 4,
// then 2, then 1, in that fixed order. Returns the sum for column `col`
// of p; with N < 8 columns the last levels reduce whole, and lanes that
// differ only in those bits hold the same sum.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&p)[N], int rg,
                                                int& col) {
  col = 0;
#pragma unroll
  for (int off = 4, n = N; off >= 1; off >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool up = rg & off;
#pragma unroll
      for (int e = 0; e < half; ++e) {
        const float send = up ? p[e] : p[e + half];
        const float keep = up ? p[e + half] : p[e];
        p[e] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (up) col += half;
      n = half;
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
    }
  }
  return p[0];
}

// the raw rows of chunk tokens [t0, t0 + tc) into ring stage `st`
template <typename T, int M>
__device__ __forceinline__ void load_chunk(unsigned char* st, const T* r,
                                           const T* k, const T* v,
                                           const float* w, size_t base,
                                           size_t row, int t0, int tc,
                                           int tid) {
  using L = Layout<T, M>;
  constexpr int PER_T = 16 / static_cast<int>(sizeof(T));  // elements/copy
  constexpr int CT = M / PER_T, CW = M / 4;   // 16-byte copies per row
  T* rs = reinterpret_cast<T*>(st);
  T* ks = reinterpret_cast<T*>(st + L::RAW_T);
  T* vs = reinterpret_cast<T*>(st + 2 * L::RAW_T);
  float* ws = reinterpret_cast<float*>(st + 3 * L::RAW_T);
  for (int c = tid; c < tc * CT; c += L::NT) {
    const int tt = c / CT, e = (c % CT) * PER_T;
    const size_t off = base + (t0 + tt) * row + e;
    cp_async16(smem_addr(rs + tt * M + e), r + off, true);
    cp_async16(smem_addr(ks + tt * M + e), k + off, true);
    cp_async16(smem_addr(vs + tt * M + e), v + off, true);
  }
  for (int c = tid; c < tc * CW; c += L::NT) {
    const int tt = c / CW, e = (c % CW) * 4;
    cp_async16(smem_addr(ws + tt * M + e), w + base + (t0 + tt) * row + e,
               true);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(Layout<T, M>::NT)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* sT, int Tn, int H) {
  using L = Layout<T, M>;
  constexpr int A = L::A;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = lane & (RG - 1), cg = (tid >> 5) * (32 / RG) + lane / RG;
  const int i0 = rg * A, j0 = cg * A;     // this thread's state tile
  const size_t row = static_cast<size_t>(H) * M;       // stride of t
  const size_t base = static_cast<size_t>(b) * Tn * row
      + static_cast<size_t>(h) * M;                     // (b, t=0, h, 0)
  const size_t sbase = static_cast<size_t>(bh) * M * M;
  const int nchunks = (Tn + TC - 1) / TC;

  load_chunk<T, M>(smem, r, k, v, w, base, row, 0, min(TC, Tn), tid);
  cp_async_commit();
  float S[A][A];
#pragma unroll
  for (int ii = 0; ii < A; ++ii) load_n(S[ii], s0 + sbase + (i0 + ii) * M + j0);
  float uu[A];
#pragma unroll
  for (int ii = 0; ii < A; ++ii) uu[ii] = u[h * M + i0 + ii];

  for (int n = 0; n < nchunks; ++n) {
    const int t0 = n * TC, tc = min(TC, Tn - t0);
    cp_async_wait<0>();   // chunk n has landed (this thread's copies)
    __syncthreads();      // ... everyone's; chunk n - 1's steps are done
    // chunk n + 1 into the stage chunk n - 1 used, while chunk n's steps run
    if (n + 1 < nchunks) {
      load_chunk<T, M>(smem + ((n + 1) & 1) * L::STAGE, r, k, v, w, base,
                       row, t0 + TC, min(TC, Tn - t0 - TC), tid);
      cp_async_commit();
    }
    const unsigned char* st = smem + (n & 1) * L::STAGE;
    const T* rs = reinterpret_cast<const T*>(st);
    const T* ks = reinterpret_cast<const T*>(st + L::RAW_T);
    const T* vs = reinterpret_cast<const T*>(st + 2 * L::RAW_T);
    const float* ws = reinterpret_cast<const float*>(st + 3 * L::RAW_T);

#pragma unroll 2
    for (int tt = 0; tt < tc; ++tt) {
      float rr[A], kk[A], ww[A], vv[A], p[A];
      load_n(rr, rs + tt * M + i0);
      load_n(kk, ks + tt * M + i0);
      load_n(ww, ws + tt * M + i0);
      load_n(vv, vs + tt * M + j0);
      float bq = 0.f;     // this row group's sum_i (r_i u_i) k_i
#pragma unroll
      for (int ii = 0; ii < A; ++ii) bq = fmaf(rr[ii] * uu[ii], kk[ii], bq);
#pragma unroll
      for (int jj = 0; jj < A; ++jj) p[jj] = 0.f;
#pragma unroll
      for (int ii = 0; ii < A; ++ii)
#pragma unroll
        for (int jj = 0; jj < A; ++jj) {
          p[jj] = fmaf(rr[ii], S[ii][jj], p[jj]);
          S[ii][jj] = fmaf(ww[ii], S[ii][jj], kk[ii] * vv[jj]);
        }
#pragma unroll
      for (int jj = 0; jj < A; ++jj) p[jj] = fmaf(vv[jj], bq, p[jj]);
      int col;
      const float sum = reduce_scatter(p, rg, col);
      if ((rg & (RG / A - 1)) == 0)
        y[base + (t0 + tt) * row + j0 + col] = sum;
    }
  }
#pragma unroll
  for (int ii = 0; ii < A; ++ii) store_n(sT + sbase + (i0 + ii) * M + j0, S[ii]);
}

template <typename T, int M>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sT, int B, int Tn, int H, cudaStream_t s) {
  constexpr int bytes = Layout<T, M>::SMEM;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  rwkv6_scan_kernel<T, M><<<B * H, Layout<T, M>::NT, bytes, s>>>(
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
// M in {16, 32, 64}; T >= 1; all but u 16-byte aligned.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* sT, int dtype, int B, int Tn, int H,
                          int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_m<__nv_bfloat16>(M, r, k, v, w, u, s0, y, sT, B, Tn, H, s);
  return launch_m<float>(M, r, k, v, w, u, s0, y, sT, B, Tn, H, s);
}
