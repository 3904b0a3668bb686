// Mahalanobis distance for the MDSA supervisor on Hopper:
//   d[b] = sqrt(max((x_b - mu)^T P (x_b - mu), 0))   for each row b,
// to fp32 accuracy on the tensor cores (3xTF32; the TPU kernel asks for
// Precision.HIGHEST, itself a multi-pass emulation of fp32 on the MXU).
//
// Replaces src/repro/kernels/mdsa/kernel.py:
//   _kernel (mdsa_pallas, pallas_call at :61).
// The JAX supervisor computes the same function as a jnp einsum
// (src/repro/core/supervisors.py:122, mdsa_confidence); the port holds
// this kernel to it.
//
// Bound on the H100: operations. With Y = X - mu the quadratic form is
// rowsum(Z o Y) with Z = Y P^T: 2 B D^2 multiply-adds against D^2 + 2 B D
// floats read. fp32 accuracy on the tensor cores takes three TF32
// products (below), so the least time is max(bytes / 3.35 TB/s,
// 3 * 2 B D^2 / 495 TFLOP/s): at [256, 4096] x [4096, 4096] 0.052 ms
// (25.8 GFLOP) against 0.021 ms for its 71 MB; on the CUDA cores in
// fp32 it could not go below 0.128 ms (67 TFLOP/s). On the supervisor
// path (1024 rows of a 64-wide layer) the call is a few microseconds.
//
// Design. A block of two warpgroups owns one 128-row x 128-column tile of
// Z over one depth slice, each warpgroup 64 rows: wgmma's m64n128k8 in
// TF32, A (Y's rows) from registers, B (P's rows) from shared memory.
// P, X and mu arrive in 32-deep steps through a 3-stage cp.async ring of
// 16-byte copies (4-byte copies where D or an address is not a multiple
// of 16 bytes); rows past B or D are zero-filled by the copy and never
// read. P's rows land 128-byte swizzled, the K-major layout wgmma's
// descriptors read; a pass over the step writes its TF32 big part in
// place and its small part beside it (elementwise, so the swizzle does
// not matter), a proxy fence makes both visible to wgmma; Y = x - mu is
// split into registers. Three products per 8 of depth: small.big,
// big.small, big.big. P's split of step k + 1 runs while the tensor
// cores multiply step k (wgmma is asynchronous), so most of the CUDA
// cores' work hides behind the products. The depth is split as well as the
// tiles: rowsum(Z o Y_j) is linear in Z, so each block folds its partial
// Z into one partial sum per row, part[slice, column tile, b], and a
// second kernel sums a row's partials in a fixed order and takes the
// square root. No atomics: the result is bitwise the same on every call.
// The launch plan (how many depth slices, so that the blocks fill the
// 132 SMs) is the wrapper's (kernels/mdsa/kernel.py, plan): at [256,
// 4096], 2 x 32 tiles x 2 slices = 128 blocks, one per SM (154 KB of
// shared memory each).
//
// Why Y P^T and not Y P. A quadratic form sees only P's symmetric part:
// y^T P^T y = y^T P y for any P, symmetric or not. With P^T both
// operands of the product are read along their contiguous axis: a depth
// slice of Y is a run of row b of X, one of P^T a run of row j of P.
// Both are K-major, which TF32 wgmma requires (and mma.sync's .row.col
// form), and no transposed copy of P is made.
//
// 3xTF32. Each operand v is split into big = tf32(v), rounded to
// nearest, and small = v - big (exact in fp32, at most 2^-11 |v|)
// truncated to TF32; Z accumulates small.big + big.small + big.big in
// fp32. The products of TF32 values are exact; what is dropped
// (small.small, and small's truncation) is ~2^-21 of a product. One TF32
// pass keeps ~3 decimal digits and is not used. The split rounds with
// integer operations: cvt.rna.tf32.f32 runs at a sixteenth of the fp32
// rate and set the pace of an earlier mma.sync version.
//
// Accumulation. Accumulated on the tensor cores over all 4096 of D, the
// distances were off by 6.4% of the 1e-4 tolerance against float64 on an
// H100 (chip_smoke.py; the fp32 plain version 0.13%). So each 32-deep
// step's 12 products start a fresh accumulator (wgmma's scale-d 0) and
// the steps are added on the CUDA cores, rounded to nearest: 0.28%, for
// 64 more registers a thread and no measurable time.

#include "kernel_common.cuh"

namespace {

constexpr int BM = 128;        // rows (batch) per tile: 2 warpgroups of 64
constexpr int BN = 128;        // columns j per tile: wgmma's N
constexpr int BK = 32;         // depth per pipeline step: one 128-byte row
constexpr int LDY = BK + 4;    // Y's row stride in shared memory (floats)
constexpr int STAGES = 3;
constexpr int kThreads = 256;
// a stage: P's step as its TF32 big part (in place of the copy) and its
// small part, [BN][128 B] each, 128-byte swizzled; then Y [BM][LDY] and mu
constexpr int P_BYTES = BN * BK * 4;
constexpr int Y_OFF = 2 * P_BYTES;
constexpr int MU_OFF = Y_OFF + BM * LDY * 4;
constexpr int STAGE_BYTES = (MU_OFF + BK * 4 + 1023) / 1024 * 1024;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + 1 KB to align

constexpr uint32_t TF32_MASK = 0xffffe000u;

// big = tf32(v), rounded to nearest with ties away (cvt.rna's rounding,
// done with two integer operations: cvt runs at a sixteenth of the fp32
// rate); small = v - big (exact in fp32) truncated to TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & TF32_MASK;
  small = __float_as_uint(v - __uint_as_float(big)) & TF32_MASK;
}

// Z[64 x 128] = A[64 x 8] B[8 x 128] (+ Z where scale_d is 1) in TF32: A
// from registers (mma's m16n8k8 A fragment in each warp), B K-major from
// shared memory
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 4 floats of row `row` (of `rows`), columns col..col+3 (of D), to shared
// address dst; masked floats are zero-filled without a read. VEC: one
// 16-byte copy (D % 4 == 0 and 16-byte aligned bases, so the 4 columns
// are all in or all out); else four 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void copy4(uint32_t dst, const float* base,
                                      int row, int rows, int col, int D) {
  const bool in_row = row < rows;
  const float* src = base + static_cast<size_t>(row) * D + col;
  if (VEC) {
    const bool ok = in_row && col < D;
    cp_async16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = in_row && col + e < D;
      cp_async4(dst + 4 * e, ok ? src + e : base, ok);
    }
  }
}

// step [k0, k0 + BK) of P's rows j0.., X's rows m0.. and mu into stage st
template <bool VEC>
__device__ __forceinline__ void load_stage(uint32_t st, const float* x,
                                           const float* mu, const float* P,
                                           int m0, int j0, int k0, int B,
                                           int D, int tid) {
  constexpr int CPR = BK / 4;  // 16-byte chunks per row of a step
#pragma unroll
  for (int e = 0; e < BN * CPR / kThreads; ++e) {
    const int q = tid + e * kThreads, rr = q / CPR, c = q % CPR;
    copy4<VEC>(st + atom_off<BN>(rr, c), P, j0 + rr, D, k0 + c * 4, D);
  }
#pragma unroll
  for (int e = 0; e < BM * CPR / kThreads; ++e) {
    const int q = tid + e * kThreads, rr = q / CPR, c = q % CPR;
    copy4<VEC>(st + Y_OFF + (rr * LDY + c * 4) * 4, x, m0 + rr, B,
               k0 + c * 4, D);
  }
  if (tid < CPR)
    copy4<VEC>(st + MU_OFF + tid * 16, mu, 0, 1, k0 + tid * 4, D);
}

// P's rows of a landed step at st, split elementwise (the swizzle does
// not matter): the TF32 big part in place, the small part beside it; then
// a proxy fence, so that wgmma sees both
__device__ __forceinline__ void split_p(unsigned char* st, int tid) {
  float4* pb = reinterpret_cast<float4*>(st);
  float4* ps = reinterpret_cast<float4*>(st + P_BYTES);
#pragma unroll
  for (int e = 0; e < P_BYTES / 16 / kThreads; ++e) {
    const int q = tid + e * kThreads;
    const float4 v = pb[q];
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    split_tf32(v.x, b0, s0);
    split_tf32(v.y, b1, s1);
    split_tf32(v.z, b2, s2);
    split_tf32(v.w, b3, s3);
    pb[q] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                        __uint_as_float(b2), __uint_as_float(b3));
    ps[q] = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                        __uint_as_float(s2), __uint_as_float(s3));
  }
  fence_proxy_async();
}

// this thread's A fragments of a landed step at st: Y = x - mu at rows
// r0, r0 + 8 and depth 8 kk + t, 8 kk + t + 4, split
__device__ __forceinline__ void split_a(const unsigned char* st, int r0,
                                        int t, uint32_t (&ab)[BK / 8][4],
                                        uint32_t (&as)[BK / 8][4]) {
  const float* Ys = reinterpret_cast<const float*>(st + Y_OFF);
  const float* Ms = reinterpret_cast<const float*>(st + MU_OFF);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int kc = kk * 8 + t;
    const float mu0 = Ms[kc], mu1 = Ms[kc + 4];
    const float* y0 = Ys + r0 * LDY + kc;
    split_tf32(y0[0] - mu0, ab[kk][0], as[kk][0]);
    split_tf32(y0[8 * LDY] - mu0, ab[kk][1], as[kk][1]);
    split_tf32(y0[4] - mu1, ab[kk][2], as[kk][2]);
    split_tf32(y0[8 * LDY + 4] - mu1, ab[kk][3], as[kk][3]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
mdsa_partial_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ P, float* __restrict__ part,
                    int B, int D, int slice_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // wgmma's swizzled operands need 1024-byte-aligned atoms
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int r0 = warp * 16 + g;            // this thread's rows r0, r0 + 8
  const int j0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * slice_len;
  const int nk = (min(D, kbeg + slice_len) - kbeg + BK - 1) / BK;

  // acc: one step's products (the tensor cores'); tot: their sum over the
  // steps, added on the CUDA cores
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;

  // the whole ring in flight first
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nk)
      load_stage<VEC>(sbase + s * STAGE_BYTES, x, mu, P, m0, j0,
                      kbeg + s * BK, B, D, tid);
    cp_async_commit();
  }
  uint32_t ab[BK / 8][4], as[BK / 8][4];   // A of the step being multiplied
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  split_p(smem, tid);
  split_a(smem, r0, t, ab, as);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const uint32_t pbase = sbase + (kt % STAGES) * STAGE_BYTES;
    fence_regs<64>(acc);
    fence_regs<BK / 2>(&ab[0][0]);
    fence_regs<BK / 2>(&as[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // 32 bytes of depth per instruction inside the swizzled atom rows
      const uint64_t db = gmma_desc(pbase + kk * 32, 16, 1024);
      const uint64_t dsm = gmma_desc(pbase + P_BYTES + kk * 32, 16, 1024);
      wgmma_tf32(acc, as[kk], db, kk > 0);   // a fresh sum for each step
      wgmma_tf32(acc, ab[kk], dsm, 1);
      wgmma_tf32(acc, ab[kk], db, 1);
    }
    wgmma_commit();
    // while the tensor cores run step kt, split P's step kt + 1 in shared
    // memory; A's registers are built after the wait (built here, while
    // wgmma may still read the last ones, they gave wrong sums on an H100)
    cp_async_wait<STAGES - 2>();   // step kt + 1 has landed (this thread's)
    __syncthreads();               // ... everyone's
    unsigned char* next = smem + ((kt + 1) % STAGES) * STAGE_BYTES;
    if (kt + 1 < nk) split_p(next, tid);
    wgmma_wait0();
    fence_regs<64>(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    fence_regs<BK / 2>(&ab[0][0]);
    fence_regs<BK / 2>(&as[0][0]);
    __syncthreads();   // step kt + 1's split is visible; step kt is consumed
    const int pf = kt + STAGES;
    if (pf < nk)
      load_stage<VEC>(pbase, x, mu, P, m0, j0, kbeg + pf * BK, B, D, tid);
    cp_async_commit();
    if (kt + 1 < nk) split_a(next, r0, t, ab, as);
  }
  cp_async_wait<0>();

  // fold: each thread's rows r0, r0 + 8 over its 32 of the tile's columns;
  // accumulator 4 n + 2 h + e is row r0 + 8 h, column 8 n + 2 t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r0 + 8 * h;
    float p = 0.f;
    if (row < B) {
      const float* xr = x + static_cast<size_t>(row) * D;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + n * 8 + 2 * t + e;
          if (col < D) p = fmaf(tot[4 * n + 2 * h + e], xr[col] - mu[col], p);
        }
    }
    // the 4 lanes of a row (t = 0..3) are adjacent: fixed-order tree
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (t == 0 && row < B)
      part[(static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * B +
           row] = p;
  }
}

__global__ void __launch_bounds__(256)
mdsa_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int B, int nparts) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float d2 = 0.f;
  for (int p = 0; p < nparts; ++p) d2 += part[static_cast<size_t>(p) * B + row];
  out[row] = sqrtf(fmaxf(d2, 0.f));
}

template <bool VEC>
cudaError_t launch_partial(dim3 grid, const float* x, const float* mu,
                           const float* P, float* part, int B, int D,
                           int slice_len, cudaStream_t s) {
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      smem_set, reinterpret_cast<const void*>(mdsa_partial_kernel<VEC>),
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  mdsa_partial_kernel<VEC><<<grid, kThreads, SMEM_BYTES, s>>>(
      x, mu, P, part, B, D, slice_len);
  return cudaGetLastError();
}

}  // namespace

// x [B, D], mu [D], P [D, D] (f32, contiguous) -> out [B] f32. The depth
// is cut into `splits` slices of `slice_len` (a multiple of 32; the last
// slice ends at D). part: scratch of splits * ceil(D / 128) * B floats.
extern "C" int mdsa(const void* x, const void* mu, const void* P, void* part,
                    void* out, int B, int D, int splits, int slice_len,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slice_len % BK || splits < 1 || (splits - 1) * slice_len >= D ||
      splits * slice_len < D)
    return cudaErrorInvalidValue;  // not a plan from kernels/mdsa/kernel.py
  const int nj = (D + BN - 1) / BN;
  const dim3 grid(nj, (B + BM - 1) / BM, splits);
  const bool vec = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(mu) |
        reinterpret_cast<uintptr_t>(P)) & 15) == 0;
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mu);
  const float* pf = static_cast<const float*>(P);
  float* partf = static_cast<float*>(part);
  const cudaError_t err =
      vec ? launch_partial<true>(grid, xf, mf, pf, partf, B, D, slice_len, s)
          : launch_partial<false>(grid, xf, mf, pf, partf, B, D, slice_len, s);
  if (err != cudaSuccess) return err;
  mdsa_finish_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      partf, static_cast<float*>(out), B, nj * splits);
  return cudaGetLastError();
}
