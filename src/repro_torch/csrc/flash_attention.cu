// Flash-attention prefill (GQA, causal or not, optional sliding window) for
// Hopper.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   _kernel (flash_attention, pallas_call at :114).
//
// Bound on the H100. Causal prefill does ~2*B*H*T*S*hd flops (half of
// 4*B*H*T*S*hd) on bytes that are only the q/k/v/o tensors, so at long T
// it is bound by operations: 989 TFLOP/s on the bf16 tensor cores, which
// only a tensor-core kernel approaches. At the cascade's serving shape
// (T = 48) it is bound by launch latency and the bytes of q/k/v.
//
// Design. As on the TPU (kernel.py:106-109) the G query heads of a KV
// group are fused into the rows: row r of the group is (t = r / G,
// g = r % G), so every row of a block shares the same K and V. Causal and
// sliding-window masks are applied in the kernel, tiles that no row of
// the block can see are skipped by the loop bounds, and ragged T and S
// edges are masked: no divisibility requirement. The output has the
// input's dtype.
//
// bf16: on the tensor cores with wgmma (flash_wgmma_kernel), the shape of
// FlashAttention-3's consumer without its producer warp. A block is one
// warpgroup (4 warps) owning 64 fused rows, wgmma's M. K and V arrive in
// tiles of 64 keys through a 2-stage ring in shared memory, filled by
// cp.async 16-byte copies (rows past S are zero-filled, never read), so
// the next tile is in flight while this one is computed; a proxy fence
// makes the copies visible to wgmma. Q, K and V tiles are stored as
// 64-column atoms with the 128-byte swizzle that wgmma's shared-memory
// descriptors read. A head dim of 80 or 112 is staged in the hd-128
// layout (two atoms): its columns 80-127 (112-127) are zero-filled by
// cp.async, never read from device memory. S = Q K^T is wgmma m64n64k16
// with both operands K-major from shared memory (ceil(hd/16) of them: at
// hd 80 the fifth reads columns 64-79 of the second atom, at hd 112 the
// fifth to seventh its columns 64-111); the online softmax (base 2,
// running max and sum per row) runs on the fp32 accumulator registers; P
// is rounded to bf16 in registers, where the accumulator's layout is
// already the A operand's, and O += P V is wgmma m64n{64,128}k16 (the
// staged width) with A from registers and V N-major (transposed) from
// shared memory; O's padding columns sum zeros and are never stored, a
// surplus of P V's MMA work of 60% at hd 80 and 14% at hd 112 (a 64 + 16
// or 64 + 48 split would avoid it). Rounding P to bf16 is the only
// rounding the fp32 version does not have. Blocks are issued latest rows
// first, so the causal mask's longest rows start first. Not yet done: TMA loads from a producer warp, and
// overlapping one tile's softmax with the next tile's Q K^T (two S
// register sets).
//
// f32: on the CUDA cores (flash_prefill_kernel), since the JAX kernel
// multiplies f32 at Precision.HIGHEST, which TF32 on the tensor cores
// would not match. BR=16 rows and BC=32 keys per step, fp32 tiles in
// shared memory, 8 threads per row.

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

template <int HD>
void launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int S, int H, int KH, int causal, int window,
                float scale, cudaStream_t s) {
  const int G = H / KH;
  const dim3 grid((Tq * G + BR - 1) / BR, B * KH);
  flash_prefill_kernel<float, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, S, H, KH,
      causal, window, scale);
}

// ---------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

constexpr int MB = 64;      // fused rows per block: one warpgroup's M
constexpr int NB = 64;      // keys per tile
constexpr int kStages = 2;  // K/V tiles in the ring

// the width a head dim is staged at: whole 64-column atoms (80, 112 -> 128)
__host__ __device__ constexpr int staged_hd(int hd) {
  return (hd + 63) / 64 * 64;
}

// shared bytes of flash_wgmma_kernel: Q, the K ring and the V ring, each
// a [64, staged_hd(HD)] bf16 tile, plus 1 KB to align the tiles to 1024
// bytes
constexpr int mma_smem_bytes(int hd) {
  return (MB + 2 * kStages * NB) * staged_hd(hd) *
             static_cast<int>(sizeof(bf16)) +
         1024;
}

// S[64 rows x 64 keys] (+)= Q K^T for one k-step of 16, both operands
// K-major from shared memory
__device__ __forceinline__ void wgmma_s(float* d, uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x N] += P V for 16 keys: P (bf16) from registers, V from shared
// memory, N-major (transposed)
__device__ __forceinline__ void wgmma_o128(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_o64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// one tile of NB keys of K and V (rows s0 .. s0 + NB - 1, those past S
// and columns past HD zero-filled) into the ring's stage at shared
// addresses ks, vs
template <int HD>
__device__ __forceinline__ void load_kv(uint32_t ks, uint32_t vs,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        size_t base, size_t stride, int s0,
                                        int S, int tid) {
  constexpr int CPR = staged_hd(HD) / 8;  // 16-byte chunks per staged row
#pragma unroll
  for (int x = 0; x < NB * CPR / kThreads; ++x) {
    const int e = tid + x * kThreads, i = e / CPR, c = e % CPR, s = s0 + i;
    const bool ok = s < S && c < HD / 8;
    const size_t off = ok ? base + (size_t)s * stride + c * 8 : 0;
    cp_async16(ks + atom_off<NB>(i, c), k + off, ok);
    cp_async16(vs + atom_off<NB>(i, c), v + off, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                   int S, int H, int KH, int causal, int window,
                   float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int HDS = staged_hd(HD);    // staged width: 64 or 128
  constexpr int CPR = HDS / 8;          // 16-byte chunks per staged row
  constexpr int KSTEP = (HD + 15) / 16;  // k-steps of Q K^T
  constexpr int NT = NB / 8;            // 8-key column tiles of S
  constexpr int OT = HDS / 8;           // 8-wide column tiles of O
  constexpr uint32_t TB = MB * HDS * 2;  // bytes of one tile
  static_assert(HD % 16 == 0 && (HDS == 64 || HDS == 128), "head dim");
  static_assert(MB == NB, "Q, K and V tiles share one layout");
  const uint32_t Qb = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t Kb = Qb + TB, Vb = Qb + (1 + kStages) * TB;

  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MB;  // latest rows first
  const int nrows = Tq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + MB, nrows) - 1) / G;
  int s_begin = 0, s_end = S;
  if (causal) s_end = min(S, t_hi + 1);
  if (window > 0) s_begin = max(0, t_lo - window + 1) / NB * NB;
  const int ntiles = s_end > s_begin ? (s_end - s_begin + NB - 1) / NB : 0;

  // Q rows (past T zero-filled), then the first K/V tile: one group
#pragma unroll
  for (int x = 0; x < MB * CPR / kThreads; ++x) {
    const int e = tid + x * kThreads, i = e / CPR, c = e % CPR, r = r0 + i;
    const bool ok = r < nrows && c < HD / 8;
    size_t off = 0;
    if (ok) {
      const int t = r / G, g = r - t * G;
      off = (((size_t)b * Tq + t) * H + kh * G + g) * HD + c * 8;
    }
    cp_async16(Qb + atom_off<MB>(i, c), q + off, ok);
  }
  const size_t kv_base = (size_t)b * S * KH * HD + (size_t)kh * HD;
  const size_t kv_stride = (size_t)KH * HD;
  if (ntiles > 0)
    load_kv<HD>(Kb, Vb, k, v, kv_base, kv_stride, s_begin, S, tid);
  cp_async_commit();

  // this thread's two rows of the warp's 16 (the accumulators' layout):
  // g8 and g8 + 8
  const int g8 = lane >> 2, q4 = lane & 3;
  int row_t[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g8 + 8 * h;
    row_ok[h] = r < nrows;
    row_t[h] = row_ok[h] ? r / G : 0;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    const int s0 = s_begin + it * NB;
    cp_async_wait<0>();   // tile it (and Q) landed, for this thread
    fence_proxy_async();  // ... and is visible to wgmma
    __syncthreads();      // ... for all; stage it - 1 fully consumed
    if (it + 1 < ntiles)
      load_kv<HD>(Kb + (stage ^ 1) * TB, Vb + (stage ^ 1) * TB, k, v,
                  kv_base, kv_stride, s0 + NB, S, tid);
    cp_async_commit();
    const uint32_t ks = Kb + stage * TB, vs = Vb + stage * TB;

    // S = Q K^T: 64 rows x 64 keys, one wgmma per 16 of hd
    float sc[NT][4];
    uint64_t dq[KSTEP], dk[KSTEP];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) {
      // atom kk / 4 (8 KB apart), 32 bytes per k-step inside it
      const uint32_t koff = (kk >> 2) * (MB * 128) + (kk & 3) * 32;
      dq[kk] = gmma_desc(Qb + koff, 16, 1024);
      dk[kk] = gmma_desc(ks + koff, 16, 1024);
    }
    fence_regs<NT * 4>(&sc[0][0]);
    fence_regs<KSTEP>(dq);
    fence_regs<KSTEP>(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) wgmma_s(&sc[0][0], dq[kk], dk[kk], kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<NT * 4>(&sc[0][0]);

    // mask (only on tiles that cross an edge: block-uniform), scale to
    // base 2, online softmax on the accumulator registers
    const bool edge = s0 + NB > S || r0 + MB > nrows ||
                      (causal && s0 + NB - 1 > t_lo) ||
                      (window > 0 && s0 <= t_hi - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, s = s0 + j * 8 + q4 * 2 + (e & 1);
        const bool ok = !edge || (row_ok[h] && s < S &&
                                  (!causal || s <= row_t[h]) &&
                                  (window <= 0 || s > row_t[h] - window));
        sc[j][e] = ok ? sc[j][e] * scale_log2 : -INFINITY;
        mx[h] = fmaxf(mx[h], sc[j][e]);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a quad hold one row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[h] = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m_use[e >> 1]);
        l[e >> 1] += sc[j][e];  // this lane's part of the row sum
      }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V: P in bf16 from the accumulators (their layout is the A
    // operand's), V N-major from shared memory, one wgmma per 16 keys
    uint32_t pa[NB / 16][4];
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    uint64_t dv[NB / 16];
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk)
      dv[kk] = gmma_desc(vs + kk * 16 * 128, NB * 128, 1024);
    fence_regs<OT * 4>(&acc[0][0]);
    fence_regs<NB / 16 * 4>(&pa[0][0]);
    fence_regs<NB / 16>(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) {
      if constexpr (HDS == 128)
        wgmma_o128(&acc[0][0], pa[kk], dv[kk]);
      else
        wgmma_o64(&acc[0][0], pa[kk], dv[kk]);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<OT * 4>(&acc[0][0]);
    fence_regs<NB / 16 * 4>(&pa[0][0]);
  }
  cp_async_wait<0>();  // no copy outlives the block (ntiles == 0)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (!row_ok[h]) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    const int r = r0 + warp * 16 + g8 + 8 * h, g = r - row_t[h] * G;
    bf16* out = o + (((size_t)b * Tq + row_t[h]) * H + kh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)  // O's padding columns are dropped
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + q4 * 2) =
          __floats2bfloat162_rn(acc[j][2 * h] * inv,
                                acc[j][2 * h + 1] * inv);
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int S, int H, int KH, int causal, int window,
                float scale, int smem_bytes, cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes(HD);
  if (smem_bytes != bytes) return cudaErrorInvalidValue;  // plan mismatch
  static bool attr_set = false;  // above 48 KB needs the opt-in, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int G = H / KH;
  const dim3 grid((Tq * G + MB - 1) / MB, B * KH);
  flash_wgmma_kernel<HD><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Tq, S, H, KH,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, HD], k/v [B, S, KH, HD] -> o [B, Tq, H, HD], all contiguous
// and of one dtype (DT_F32 / DT_BF16; bf16 16-byte aligned); HD is 64, 80,
// 112 or 128; H % KH == 0. smem_bytes: the bf16 kernel's dynamic shared
// memory as the wrapper's plan computed it (checked here); unused for f32.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, int dtype, int B, int Tq, int S, int H,
                             int KH, int HD, int causal, int window,
                             float scale, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (HD == 128)
      launch_f32<128>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
    else if (HD == 112)
      launch_f32<112>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
    else if (HD == 80)
      launch_f32<80>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
    else
      launch_f32<64>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale, s);
    return cudaGetLastError();
  }
  if (HD == 128)
    return launch_bf16<128>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                            scale, smem_bytes, s);
  if (HD == 112)
    return launch_bf16<112>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                            scale, smem_bytes, s);
  if (HD == 80)
    return launch_bf16<80>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                           scale, smem_bytes, s);
  return launch_bf16<64>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale,
                         smem_bytes, s);
}
