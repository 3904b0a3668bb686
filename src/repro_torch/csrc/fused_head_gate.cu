// Fused local head -> confidence gate for Hopper: logits = h w + b folded
// straight into the gate's online-softmax statistics, conf and pred out,
// in one launch; the [B, C] logits never reach device memory.
//
// Replaces src/repro/kernels/fused_head_gate/kernel.py:
//   _head_gate_kernel (fused_head_gate_pallas, pallas_call at :81);
// selection reuses the gate's select kernel (confidence_gate.cu), as the
// TPU version reuses _select_kernel at :100.
//
// Bound on the H100. At the yi-6b head ([32, 4096] x [4096, 64000], w
// bf16) reading w dominates the bytes: 524 MB, ~157 us at 3.35 TB/s. The
// product is 2 B D C = 16.8 GFLOP: ~250 us in fp32 on the CUDA cores (67
// TFLOP/s), ~51 us as the three bf16 tensor-core products below (989
// TFLOP/s). So on the tensor cores the bytes bound it. At the serve path's
// [32, 32] x [32, 8] the call is launch latency.
//
// Design. The TPU multiplies a [BB, D] x [D, VB] tile in f32 and folds it
// into running statistics, walking the vocabulary blocks of a row tile in
// order on one core. Here three forms, picked by the wrapper's plan
// (kernels/fused_head_gate/kernel.py, head_plan):
//   - narrow (C <= 32, the serve path's 8 classes): one warp per row (a
//     block each, so each warp issues alone), no scratch. Lane l takes
//     depths l, l + 32, ... of the row: its h value and w's row of C
//     columns (16-byte loads where C and the base allow, no broadcast of
//     h), fp32 FMAs into 32 partial dots; a reduce-scatter across the
//     lanes (31 shuffles) leaves column l's logit in lane l, which folds
//     it (+ bias); the warp merges its lanes and writes conf and pred.
//   - tensor cores (bf16 w): the logits transposed, L^T = w^T h^T, so the
//     vocabulary columns are the MMA's M and the 32 batch rows its N
//     (mma.sync m16n8k16; w [D, C] is MN-major for it, read by
//     ldmatrix.trans). An f32 hidden value splits exactly into three bf16
//     pieces h0 + h1 + h2 (8 + 8 + 8 bits of mantissa; for |h| >= 2^-110,
//     where h2 is still a normal bf16) and a bf16 x bf16
//     product is exact in fp32, so three products against one w tile give
//     the fp32 dot's products; a bf16 hidden is one piece. Each 16-deep
//     step's products go into a fresh accumulator and the steps are added
//     on the CUDA cores (the tensor cores' fp32 accumulation over all of D
//     loses accuracy: mdsa.cu). w streams through a 4-stage cp.async ring
//     of [32 x BM] tiles (rows padded 16 bytes, so ldmatrix is free of
//     bank conflicts) and is read once; h comes from L2 32 deep at a time
//     into registers two steps ahead and is split once per block into a
//     double-buffered pieces tile. A block owns BM = 128 MT columns (8
//     warps x MT 16-column tiles, 1024-byte aligned rows of w) for 32
//     rows; its epilogue folds each thread's 2 MT logits of a row (+ bias)
//     straight from the accumulator registers, merges the 8 lanes of a
//     row by shuffles and the warps in order.
//   - fp32 FMA tile (f32 w, or bf16 w whose rows are not 16-byte
//     aligned): a [32 x 256] logits tile from 32-deep slices of h and w
//     staged through shared memory, 8 rows x 4 columns a thread, folded a
//     warp per row. Not redesigned beyond the merge.
// Both wide forms merge the blocks' statistics in one launch: a
// thread-block cluster merges its blocks through distributed shared
// memory in rank order (as vocab_stats.cuh), rank 0 writes the cluster's
// partial to a small scratch, and the last cluster to arrive (a
// __threadfence and an atomic ticket, reset by that cluster) merges the
// partials in cluster order and writes conf and pred. Every merge runs in
// a fixed order with vstats::merge's first-index tie rule, so results
// are deterministic.

#include "vocab_stats.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // batch rows per block of the wide forms
constexpr int kDK = 32;          // depth of one ring stage / FMA slice
constexpr int kStages = 4;       // the tensor-core form's ring
constexpr int kPad = 8;          // bf16 of padding per shared row (16 B)
constexpr int kFmaCols = 256;    // the FMA tile's columns

enum { FORM_NARROW = 0, FORM_MMA = 1, FORM_FMA = 2 };

// ---- statistics merged across the grid

__device__ __forceinline__ GateStats load_cg(const GateStats* p) {
  const float* f = reinterpret_cast<const float*>(p);
  GateStats r;
  r.m1 = __ldcg(f);
  r.m2 = __ldcg(f + 1);
  r.s = __ldcg(f + 2);
  r.t = __ldcg(f + 3);
  r.s2 = __ldcg(f + 4);
  r.a1 = __ldcg(reinterpret_cast<const int*>(f + 5));
  return r;
}

__device__ __forceinline__ void write_row(const GateStats& st, int sup,
                                          int row, int B, float* out) {
  out[row] = gate_conf(st, sup);
  reinterpret_cast<int*>(out)[B + row] = st.a1;
}

// st (threads < kRows): row blockIdx.y * kRows + tid's statistics over
// this block's columns. Merged across the cluster (rank order, through
// rank 0's slots), then across clusters (cluster order, by the last
// cluster to take a ticket), which writes the rows' conf and pred. Every
// block arrived on the cluster barrier when it started.
__device__ __forceinline__ void finish_rows(
    GateStats st, GateStats (&slots)[vstats::kMaxCluster][kRows], int& last,
    int B, int sup, GateStats* __restrict__ part,
    unsigned* __restrict__ ticket, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  vstats::cluster_wait();  // every block of the cluster is running
  if (tid < kRows) *cluster.map_shared_rank(&slots[rank][tid], 0) = st;
  cluster.sync();  // release / acquire: rank 0 sees every slot
  if (rank != 0) return;
  const int nclusters = gridDim.x / ncl;
  GateStats* gp = part + static_cast<size_t>(blockIdx.y) * nclusters * kRows;
  if (tid < kRows) {
    GateStats r = slots[0][tid];
    for (int i = 1; i < ncl; ++i) vstats::merge<true>(r, slots[i][tid]);
    gp[(blockIdx.x / ncl) * kRows + tid] = r;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket + blockIdx.y, 1u) ==
           static_cast<unsigned>(nclusters - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int row = blockIdx.y * kRows + tid;
  if (tid < kRows && row < B) {
    GateStats r = load_cg(gp + tid);
    for (int c = 1; c < nclusters; ++c)
      vstats::merge<true>(r, load_cg(gp + c * kRows + tid));
    write_row(r, sup, row, B, out);
  }
  if (tid == 0) ticket[blockIdx.y] = 0;  // every cluster has taken one
}

// ---- narrow (C <= 32): one warp per row

// a block per row: one warp, alone on its SM sub-partition, so the
// row's instructions issue without a second warp's in between
template <typename TH, typename TW>
__global__ void __launch_bounds__(32)
head_gate_narrow_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                        const float* __restrict__ bias, int B, int D, int C,
                        int sup, float* __restrict__ out) {
  const int lane = threadIdx.x, row = blockIdx.x;
  const TH* hr = h + static_cast<size_t>(row) * D;
  const float bv = lane < C ? bias[lane] : 0.f;
  // lane l: partial dots of every column over depths l, l + 32, ...
  float p[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) p[c] = 0.f;
  // w's rows in 16-byte loads where C and the base allow them
  using V = vstats::Vec<TW>;
  const bool wvec =
      C % V::N == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int d = lane; d < D; d += 32) {
    const float hv = to_f32(hr[d]);
    const TW* wr = w + static_cast<size_t>(d) * C;
    float wv[32];
    if (wvec) {
#pragma unroll
      for (int v = 0; v < 32 / V::N; ++v) {
        float x[V::N];
        const typename V::Raw* wp =
            reinterpret_cast<const typename V::Raw*>(wr) + v;
        V::unpack(v * V::N < C ? __ldg(wp) : typename V::Raw{}, x);
#pragma unroll
        for (int i = 0; i < V::N; ++i) wv[v * V::N + i] = x[i];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c) wv[c] = c < C ? to_f32(wr[c]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) p[c] = fmaf(hv, wv[c], p[c]);
  }
  // reduce-scatter across the lanes: at offset o a lane keeps the lower
  // half of its columns if (lane & o) == 0, else the upper half, and adds
  // its partner's partials of that half; lane l ends with column l's dot
  // (the halves picked by bit masks: a select per value, no branch)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t up = lane & o ? 0xffffffffu : 0u;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const uint32_t lo = __float_as_uint(p[i]);
      const uint32_t hi = __float_as_uint(p[i + o]);
      const float give = __uint_as_float((lo & up) | (hi & ~up));
      const float keep = __uint_as_float((hi & up) | (lo & ~up));
      p[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  GateStats st = gate_empty();
  if (lane < C) {
    const float x[1] = {p[0] + bv};
    vstats::fold<true, 1, 1>(st, x, lane, 0);
  }
  st = vstats::warp_reduce<true>(st);
  if (lane == 0) write_row(st, sup, row, B, out);
}

// ---- tensor cores: bf16 w, hidden in 1 (bf16) or 3 (f32) bf16 pieces

// bf16 pieces of a hidden value: three for f32, one for bf16
template <typename TH>
__host__ __device__ constexpr int pieces() {
  return sizeof(TH) == 4 ? 3 : 1;
}

template <int MT, int NP>
struct MmaLayout {
  static constexpr int BM = kWarps * 16 * MT;  // columns per block
  static constexpr int WROW = BM + kPad;       // bf16 per w row (shared)
  static constexpr int WSTAGE = kDK * WROW;    // bf16 per ring stage
  static constexpr int PROW = kDK + kPad;      // bf16 per pieces row
  static constexpr int PIECE = kRows * PROW;   // bf16 per piece
  static constexpr int PBUF = NP * PIECE;      // bf16 per pieces buffer
  static constexpr int SMEM = (kStages * WSTAGE + 2 * PBUF) * 2;  // bytes
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8] = a[16x16] b[16x8] + c, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// 4 consecutive hidden values (16 bytes of f32 or 8 of bf16, aligned)
__device__ __forceinline__ void load_h4(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_h4(const __nv_bfloat16* p,
                                        float (&x)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// MT 4 keeps one block per SM (f32 hidden: ~230 registers); narrower
// tiles fit two, which the bf16 hidden's lighter products can use
template <typename TH, int MT>
__global__ void __launch_bounds__(kThreads, MT >= 4 ? 1 : 2)
head_gate_mma_kernel(const TH* __restrict__ h,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, int B, int D, int C,
                     int sup, GateStats* __restrict__ part,
                     unsigned* __restrict__ ticket, float* __restrict__ out) {
  constexpr int NP = pieces<TH>();
  using L = MmaLayout<MT, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ps = Ws + kStages * L::WSTAGE;
  __shared__ GateStats slots[vstats::kMaxCluster][kRows];
  __shared__ GateStats wst[kWarps][kRows];
  __shared__ int last;
  vstats::cluster_arrive_relaxed();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row
  const int c0 = blockIdx.x * L::BM, r0 = blockIdx.y * kRows;
  const int wm0 = warp * 16 * MT;  // this warp's first column in the tile
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (c0 < C) {  // block-uniform: the grid's padding blocks fold nothing
    const int nsteps = (D + kDK - 1) / kDK;
    // w rows d0 .. d0 + 31, columns c0 .. c0 + BM - 1, in 16-byte chunks
    // (zero-filled past D or C: C % 8 == 0, so a chunk is all in or out)
    auto load_w = [&](int step) {
      __nv_bfloat16* dst = Ws + (step % kStages) * L::WSTAGE;
      const int d0 = step * kDK;
#pragma unroll
      for (int i = 0; i < kDK * L::BM / 8 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int kk = e / (L::BM / 8), ch = e % (L::BM / 8);
        const int gd = d0 + kk, gc = c0 + 8 * ch;
        const bool ok = gd < D && gc < C;
        cp_async16(smem_addr(dst + kk * L::WROW + 8 * ch),
                   ok ? w + static_cast<size_t>(gd) * C + gc : w, ok);
      }
    };
    // this thread's 4 hidden values of a step: row r0 + tid / 8, depth
    // 4 (tid % 8) .. + 3, read two steps ahead into registers (even steps
    // into ha, odd into hb: a register array takes no runtime index)
    const int hn = tid >> 3, hk = (tid & 7) * 4;
    const bool hrow = r0 + hn < B;
    const TH* hp = h + static_cast<size_t>(hrow ? r0 + hn : 0) * D;
    float ha[4], hb[4];
    // one 16-byte (f32) or 8-byte (bf16) load where the rows allow it:
    // every block reads the same h, so fewer requests spare its L2 lines
    const bool hvec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(h) &
                                     (4 * sizeof(TH) - 1)) == 0;
    auto load4 = [&](float (&x)[4], int step) {
      const int d = step * kDK + hk;
      if (hvec) {
        if (hrow && d < D) {
          load_h4(hp + d, x);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = hrow && d + i < D ? to_f32(hp[d + i]) : 0.f;
      }
    };
    auto load_h = [&](int step) {
      if (step & 1)
        load4(hb, step);
      else
        load4(ha, step);
    };
    // split into bf16 pieces h0 = bf16(h), h1 = bf16(h - h0),
    // h2 = bf16(h - h0 - h1) (each difference exact in fp32; the sum of
    // the three is h for every |h| >= 2^-110, below which the last piece
    // can fall under bf16's normal range and round)
    auto split4 = [&](const float (&x)[4], int step) {
      __nv_bfloat16* dst = Ps + (step & 1) * L::PBUF + hn * L::PROW + hk;
      __nv_bfloat16 p[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[0][i] = __float2bfloat16_rn(x[i]);
        if constexpr (NP == 3) {
          const float r1 = __fsub_rn(x[i], __bfloat162float(p[0][i]));
          p[1][i] = __float2bfloat16_rn(r1);
          p[2][i] = __float2bfloat16_rn(
              __fsub_rn(r1, __bfloat162float(p[1][i])));
        }
      }
#pragma unroll
      for (int q = 0; q < NP; ++q)
        *reinterpret_cast<uint2*>(dst + q * L::PIECE) =
            make_uint2(pack_bf16(p[q][0], p[q][1]),
                       pack_bf16(p[q][2], p[q][3]));
    };
    auto store_pieces = [&](int step) {
      if (step & 1)
        split4(hb, step);
      else
        split4(ha, step);
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nsteps) load_w(s);
      cp_async_commit();
    }
    load_h(0);
    if (nsteps > 1) load_h(1);
    store_pieces(0);
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (int step = 0; step < nsteps; ++step) {
      cp_async_wait<kStages - 2>();  // this step's w tile, for this thread
      __syncthreads();  // ... and every thread's; pieces visible; the
                        // slot and pieces buffer of step - 1 are free
      if (step + kStages - 1 < nsteps) load_w(step + kStages - 1);
      cp_async_commit();
      if (step + 2 < nsteps) load_h(step + 2);
      const __nv_bfloat16* Wt = Ws + (step % kStages) * L::WSTAGE;
      const __nv_bfloat16* Pt = Ps + (step & 1) * L::PBUF;
#pragma unroll
      for (int k16 = 0; k16 < kDK / 16; ++k16) {
        // B = h^T: per piece, n-tiles 0..3 (batch rows), k 16 deep;
        // matrix i of an x4 load: rows n + 8 (i >> 1), depth + 8 (i & 1)
        uint32_t b[NP][4][2];
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t r[4];
            ldsm_x4(smem_addr(Pt + q * L::PIECE +
                              (half * 16 + (mat >> 1) * 8 + mrow) * L::PROW +
                              k16 * 16 + (mat & 1) * 8),
                    r);
            b[q][2 * half][0] = r[0];
            b[q][2 * half][1] = r[1];
            b[q][2 * half + 1][0] = r[2];
            b[q][2 * half + 1][1] = r[3];
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A = w^T [16 columns x 16 deep] by ldmatrix.trans from w's
          // rows; matrix i: depth + 8 (i >> 1), columns + 8 (i & 1)
          uint32_t a[4];
          ldsm_x4_trans(smem_addr(Wt + (k16 * 16 + (mat >> 1) * 8 + mrow) *
                                           L::WROW +
                                  wm0 + mt * 16 + (mat & 1) * 8),
                        a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // this step's products, smallest piece first, in a fresh
            // accumulator; then added on the CUDA cores
            float f[4];
            mma_bf16(f, a, b[NP - 1][nt], zero);
#pragma unroll
            for (int q = NP - 2; q >= 0; --q) mma_bf16(f, a, b[q][nt], f);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += f[i];
          }
        }
      }
      if (step + 1 < nsteps) store_pieces(step + 1);
    }
    cp_async_wait<0>();  // no copy outlives the block
  }

  // Epilogue. Thread (g = lane / 4, q = lane % 4) holds, for batch rows
  // nt * 8 + 2 q + j, the logits of columns wm0 + g + 8 i, i < 2 MT
  // (acc[i / 2][nt][2 (i % 2) + j]): one register block per row, folded
  // with the bias; the 8 lanes of a row merge by shuffles (lanes g + 4,
  // g + 2, g + 1), lanes 0..3 keep the warp's rows, warps merge in order.
  const int g = lane >> 2;
  const int col0 = c0 + wm0 + g;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      GateStats st = gate_empty();
      if (col0 < C) {
        float x[2 * MT];
#pragma unroll
        for (int i = 0; i < 2 * MT; ++i) {
          const int c = col0 + 8 * i;
          x[i] = c < C ? acc[i / 2][nt][2 * (i % 2) + j] + bias[c]
                       : GATE_NEG;
        }
        vstats::fold<true, 2 * MT, 1>(st, x, col0, 8);
      }
#pragma unroll
      for (int off = 16; off >= 4; off >>= 1)
        vstats::merge<true>(st, vstats::shfl_down<true>(st, off));
      if (lane < 4) wst[warp][nt * 8 + 2 * lane + j] = st;
    }
  __syncthreads();
  GateStats st = gate_empty();
  if (tid < kRows) {
    st = wst[0][tid];
    for (int i = 1; i < kWarps; ++i) vstats::merge<true>(st, wst[i][tid]);
  }
  finish_rows(st, slots, last, B, sup, part, ticket, out);
}

// ---- fp32 FMA tile

constexpr int kStageFloats = kRows * (kDK + 1) + kDK * kFmaCols;
constexpr int kTileFloats = kRows * (kFmaCols + 1);
constexpr int kFmaFloats =
    kStageFloats > kTileFloats ? kStageFloats : kTileFloats;

template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads)
head_gate_fma_kernel(const TH* __restrict__ h, const TW* __restrict__ w,
                     const float* __restrict__ bias, int B, int D, int C,
                     int sup, GateStats* __restrict__ part,
                     unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float smem[kFmaFloats];
  __shared__ GateStats slots[vstats::kMaxCluster][kRows];
  __shared__ GateStats rst[kRows];
  __shared__ int last;
  vstats::cluster_arrive_relaxed();
  float* Hs = smem;                      // [kRows][kDK + 1]
  float* Ws = smem + kRows * (kDK + 1);  // [kDK][kFmaCols]
  const int tid = threadIdx.x;
  const int tx = tid & 63;               // columns tx + 64 j, j < 4
  const int ty = tid >> 6;               // rows ty + 4 i, i < 8
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kFmaCols;
  const int warp = tid >> 5, lane = tid & 31;

  if (c0 < C) {  // block-uniform: the grid's padding blocks fold nothing
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDK) {
      for (int e = tid; e < kRows * kDK; e += kThreads) {
        const int r = e / kDK, kk = e % kDK;
        const int gr = r0 + r, gd = d0 + kk;
        Hs[r * (kDK + 1) + kk] =
            (gr < B && gd < D) ? to_f32(h[(size_t)gr * D + gd]) : 0.f;
      }
#pragma unroll 4
      for (int e = tid; e < kDK * kFmaCols; e += kThreads) {
        const int kk = e / kFmaCols, c = e % kFmaCols;
        const int gd = d0 + kk, gc = c0 + c;
        Ws[kk * kFmaCols + c] =
            (gd < D && gc < C) ? to_f32(w[(size_t)gd * C + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[kk * kFmaCols + tx + 64 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float hv = Hs[(ty + 4 * i) * (kDK + 1) + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv, wv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    // logits tile (+ bias) to shared memory, reusing the staging buffer
    float* Lt = smem;  // [kRows][kFmaCols + 1]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 64 * j, gc = c0 + c;
        Lt[(ty + 4 * i) * (kFmaCols + 1) + c] =
            acc[i][j] + (gc < C ? bias[gc] : 0.f);
      }
    __syncthreads();
    // fold: one warp per row, 8 warps x 4 rows; lane l folds columns
    // l + 32 i as one register block
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp * (kRows / kWarps) + rr;
      GateStats st = gate_empty();
      if (c0 + lane < C) {
        float x[kFmaCols / 32];
#pragma unroll
        for (int i = 0; i < kFmaCols / 32; ++i) {
          const int c = lane + 32 * i;
          x[i] = c0 + c < C ? Lt[r * (kFmaCols + 1) + c] : GATE_NEG;
        }
        vstats::fold<true, kFmaCols / 32, 1>(st, x, c0 + lane, 32);
      }
      st = vstats::warp_reduce<true>(st);
      if (lane == 0) rst[r] = st;
    }
  } else if (tid < kRows) {
    rst[tid] = gate_empty();
  }
  __syncthreads();
  finish_rows(tid < kRows ? rst[tid] : gate_empty(), slots, last, B, sup,
              part, ticket, out);
}

// ---- launches

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, dim3 grid, int cluster, int smem,
                           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TH, typename TW>
cudaError_t launch_narrow(const void* h, const void* w, const float* bias,
                          int B, int D, int C, int sup, float* out,
                          cudaStream_t s) {
  if (C > 32) return cudaErrorInvalidValue;  // plan mismatch
  head_gate_narrow_kernel<TH, TW><<<B, 32, 0, s>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), bias, B, D, C,
      sup, out);
  return cudaGetLastError();
}

template <typename TH, int MT>
cudaError_t launch_mma(const void* h, const void* w, const float* bias,
                       int B, int D, int C, dim3 grid, int cluster, int sup,
                       GateStats* part, unsigned* ticket, float* out,
                       cudaStream_t s) {
  constexpr int smem = MmaLayout<MT, pieces<TH>()>::SMEM;
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      smem_set, reinterpret_cast<const void*>(head_gate_mma_kernel<TH, MT>),
      smem);
  if (err != cudaSuccess) return err;
  return launch_cluster(head_gate_mma_kernel<TH, MT>, grid, cluster, smem, s,
                        static_cast<const TH*>(h),
                        static_cast<const __nv_bfloat16*>(w), bias, B, D, C,
                        sup, part, ticket, out);
}

template <typename TH>
cudaError_t launch_mma_mt(int tile_cols, const void* h, const void* w,
                          const float* bias, int B, int D, int C, dim3 grid,
                          int cluster, int sup, GateStats* part,
                          unsigned* ticket, float* out, cudaStream_t s) {
  if (tile_cols % (kWarps * 16)) return cudaErrorInvalidValue;
  switch (tile_cols / (kWarps * 16)) {  // MT
    case 1:
      return launch_mma<TH, 1>(h, w, bias, B, D, C, grid, cluster, sup, part,
                               ticket, out, s);
    case 2:
      return launch_mma<TH, 2>(h, w, bias, B, D, C, grid, cluster, sup, part,
                               ticket, out, s);
    case 4:
      return launch_mma<TH, 4>(h, w, bias, B, D, C, grid, cluster, sup, part,
                               ticket, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TH, typename TW>
cudaError_t launch_fma(const void* h, const void* w, const float* bias,
                       int B, int D, int C, dim3 grid, int cluster, int sup,
                       GateStats* part, unsigned* ticket, float* out,
                       cudaStream_t s) {
  return launch_cluster(head_gate_fma_kernel<TH, TW>, grid, cluster, 0, s,
                        static_cast<const TH*>(h), static_cast<const TW*>(w),
                        bias, B, D, C, sup, part, ticket, out);
}

// f(TH{}, TW{}) for the hidden's and w's element types (f32 or bf16)
template <typename F>
cudaError_t by_dtypes(bool hf, bool wf, F f) {
  if (hf && wf) return f(float{}, float{});
  if (hf) return f(float{}, __nv_bfloat16{});
  if (wf) return f(__nv_bfloat16{}, float{});
  return f(__nv_bfloat16{}, __nv_bfloat16{});
}

}  // namespace

// hidden [B, D] (h_dtype), w [D, C] (w_dtype), bias [C] f32 -> out [2, B]:
// conf (f32), pred (i32). The wrapper's plan (head_plan) gives form
// (FORM_*), tile_cols (columns per block: kWarps * 16 * MT for the
// tensor-core form, MT 1, 2 or 4, and kFmaCols for the FMA tile; a plan
// that disagrees with the kernel's geometry is refused), tiles (column
// blocks of the wide forms, a multiple of cluster) and cluster (blocks merged
// through distributed shared memory, 1..8). The wide forms take ticket
// (ceil(B / 32) counters, zero, and left zero) and part (ceil(B / 32) *
// tiles / cluster * 32 GateStats of scratch); the narrow form neither.
// The tensor-core form needs w bf16 with C % 8 == 0 and a 16-byte
// aligned base.
extern "C" int fused_head_gate(const void* h, int h_dtype, const void* w,
                               int w_dtype, const void* bias, int B, int D,
                               int C, int form, int tile_cols, int tiles,
                               int cluster, int sup, void* ticket, void* part,
                               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (B < 1 || D < 1 || C < 1) return cudaErrorInvalidValue;
  const bool hf = h_dtype == DT_F32, wf = w_dtype == DT_F32;
  if (form == FORM_NARROW)
    return by_dtypes(hf, wf, [&](auto th, auto tw) {
      return launch_narrow<decltype(th), decltype(tw)>(h, w, b, B, D, C, sup,
                                                       o, s);
    });
  if (cluster < 1 || cluster > vstats::kMaxCluster || tiles % cluster ||
      static_cast<long long>(tiles) * tile_cols < C)
    return cudaErrorInvalidValue;  // plan mismatch
  const dim3 grid(tiles, (B + kRows - 1) / kRows);
  GateStats* p = static_cast<GateStats*>(part);
  unsigned* t = static_cast<unsigned*>(ticket);
  if (form == FORM_MMA) {
    if (wf || C % 8 || (reinterpret_cast<uintptr_t>(w) & 15))
      return cudaErrorInvalidValue;
    return hf ? launch_mma_mt<float>(tile_cols, h, w, b, B, D, C, grid,
                                     cluster, sup, p, t, o, s)
              : launch_mma_mt<__nv_bfloat16>(tile_cols, h, w, b, B, D, C,
                                             grid, cluster, sup, p, t, o, s);
  }
  if (form != FORM_FMA || tile_cols != kFmaCols) return cudaErrorInvalidValue;
  return by_dtypes(hf, wf, [&](auto th, auto tw) {
    return launch_fma<decltype(th), decltype(tw)>(h, w, b, B, D, C, grid,
                                                  cluster, sup, p, t, o, s);
  });
}
