// Single-token GQA decode attention over a KV cache for Hopper, masked per
// sequence by kv_len (flash-decoding: the cache is split along S).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
//   _kernel (decode_attention, pallas_call at :83).
//
// Bound on the H100: memory. One query token does 4*hd flops per cached
// key and head against 2*hd*sizeof(T) bytes of K and V per key and KV
// head, so the card is bound by reading the valid part of the cache once:
// at the generate path's shape (B 8, 544 slots, 4 KV heads, hd 128, bf16)
// ~8.9 MB, ~2.7 us at 3.35 TB/s, below launch latency; at a 16384-token
// context ~268 MB, ~80 us. At G = 8 query heads per KV head that is ~8
// flops per byte: the CUDA cores could sustain it at the HBM rate, but the
// shared-memory reads of a CUDA-core score loop (each warp re-reading the
// K tile and q) hold it well below that. So bf16 scores run on the tensor
// cores (bf16 products are exact in fp32, summed in fp32); the softmax, P
// and O stay fp32 on the CUDA cores, and P is never rounded.
//
// Design. The TPU kernel walks the KV blocks of one (batch, KV head) in
// order on one core and carries the online-softmax state in VMEM. On the
// H100 the cache is split along S: grid = (splits, B*K); block
// (j, b*K + k) streams keys [j*chunk, (j+1)*chunk) of that pair, clipped
// to kv_len[b], which each block reads on the device (no host sync, any
// per-row length). The wrapper's plan (kernel.py, splits) sizes the grid
// to one wave of resident blocks, so that every SM keeps several tiles in
// flight. As on the TPU, the G = H/K query heads of the group share the
// block, so each K/V tile is read once for all of them.
//
// Bytes arrive through a ring of kStages = 4 tiles of KT = 32 keys in
// dynamic shared memory, each filled by cp.async 16-byte copies in the
// cache's own dtype (bf16 stays bf16 in shared memory and is converted at
// use): while tile i is computed, tiles i+1 .. i+3 are in flight. Keys
// past kv_len are zero-filled, never read. 16-byte chunks are
// XOR-swizzled by row, so a warp reading 32 rows' chunk c hits 32
// different banks. Scores: bf16, S^T = K q^T by mma.sync m16n8k16 (warps
// 0 and 1 take 16 keys each, K by ldmatrix, q's fragments in registers,
// padded to 8 heads), written to shared memory; f32, a lane computes its
// key's score for its warp's heads in fp32 (q pre-scaled in shared memory,
// read as broadcasts; four FMA chains). Warp w owns query heads w*HPW ..
// (HPW = G/4, G rounded up to a power of two): the warp takes the
// online-softmax max and sum by shuffles, writes P to its own slice of
// shared memory, and accumulates O for hd/32 columns per lane, reading P
// four keys at a time. One __syncthreads per tile (two for bf16: the
// scores). Each block writes its unnormalised partial
// (acc, m, l); a second pass merges the splits of each (batch, head) with
// the same rescaling and divides by the sum. A head dim of 80 or 112 is
// staged in rows of 128 (the swizzle stays within a row's 16 bf16 or 32
// f32 chunks; the padding is never loaded nor read): its scores take 5
// or 7 k-steps, and its P V gives each lane 4 columns, so lanes 20-31 (at
// hd 112 lanes 28-31) sit that loop out. A group of 1 (MHA) is padded to
// 8 heads in the score MMA, whose columns 1-7 are zero. Contract:
// 1 <= kv_len[b] (the decode path passes pos + 1); kv_len = 0 writes 0,
// as the Pallas kernel does. S needs no alignment; hd is 64, 80, 112 or
// 128; G <= 16; inputs bf16 or f32, output in q's dtype.

#include "kernel_common.cuh"

namespace {

constexpr int KT = 32;                // keys per tile: one per lane
constexpr int kStages = 4;            // tiles in the ring
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// heads of a group padded to a power of two; warp w owns HPW of them
__host__ __device__ constexpr int heads_per_warp(int gp) {
  return gp >= kWarps ? gp / kWarps : 1;
}

// bf16 computes the scores on the tensor cores, in 8-head column tiles
template <typename T>
constexpr bool kMma = sizeof(T) == 2;
__host__ __device__ constexpr int mma_heads(int gp) { return gp > 8 ? gp : 8; }

// the row width a head dim is staged at: 64 or 128 (80, 112 -> 128)
__host__ __device__ constexpr int staged_hd(int hd) {
  return (hd + 63) / 64 * 64;
}

// shared bytes: the K and V rings (rows at the staged width); then for
// bf16 the scores S[heads][KT+1] (fp32), for f32 q (fp32, padded group);
// then P per warp
template <typename T, int HD, int GP>
constexpr int smem_bytes() {
  return 2 * kStages * KT * staged_hd(HD) * static_cast<int>(sizeof(T)) +
         (kMma<T> ? mma_heads(GP) * (KT + 1) * 4 : GP * HD * 4) +
         kWarps * heads_per_warp(GP) * KT * 4;
}

// ldmatrix: four 8x8 b16 matrices from shared memory, one row address per
// lane (lanes 8i .. 8i+7 give matrix i's rows)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N consecutive elements (N * sizeof(T) bytes, so aligned) into fp32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, float* dst);
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* src,
                                                   float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
template <>
__device__ __forceinline__ void load_vec<float, 2>(const float* src,
                                                   float* dst) {
  const float2 x = *reinterpret_cast<const float2*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
}
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* src,
                                          float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(src);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  load_bf16<8>(reinterpret_cast<const __nv_bfloat16*>(&x), dst);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* src, float* dst) {
  const uint2 x = *reinterpret_cast<const uint2*>(src);
  load_bf16<4>(reinterpret_cast<const __nv_bfloat16*>(&x), dst);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 2>(
    const __nv_bfloat16* src, float* dst) {
  load_bf16<2>(src, dst);
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int S, int H, int KH, int chunk, int nsplit, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / VEC;        // chunks per cached row (>= 8)
  constexpr int HDS = staged_hd(HD);   // a staged row's elements
  constexpr int HPW = heads_per_warp(GP);
  constexpr int DPL = HDS / 32;        // output columns per lane
  constexpr int TILE = KT * HDS;       // elements per K (or V) tile
  constexpr int LOADS = KT * CPR;      // 16-byte copies per K (or V) tile
  static_assert(HD % 16 == 0 && (HDS == 64 || HDS == 128), "head dim");
  constexpr int NQT = mma_heads(GP) / 8;  // 8-head column tiles (bf16)
  constexpr int SROW = KT + 1;            // S row stride (bf16)
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kStages * TILE;
  // bf16: S [NQT*8][SROW]; f32: q [GP][HD] pre-scaled
  float* Qs = reinterpret_cast<float*>(Vs + kStages * TILE);
  float* Ps = Qs + (kMma<T> ? NQT * 8 * SROW : GP * HD);  // [warps][HPW][KT]

  const int G = H / KH;
  const int bk = blockIdx.y, b = bk / KH, kh = bk % KH;
  const int split = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(kv_len[b], S);
  const int s_begin = split * chunk;
  const int s_end = min(len, s_begin + chunk);
  const int ntiles = s_end > s_begin ? (s_end - s_begin + KT - 1) / KT : 0;

  const size_t row = (size_t)KH * HD;  // elements between keys s and s + 1
  const T* kb = k + (size_t)b * S * row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * row + (size_t)kh * HD;
  // tile i of this split into ring stage i % kStages (keys past s_end
  // zero-filled); every thread commits one group per call
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      T* ks = Ks + (i % kStages) * TILE;
      T* vs = Vs + (i % kStages) * TILE;
      const int s0 = s_begin + i * KT;
#pragma unroll
      for (int x = 0; x < (LOADS + kThreads - 1) / kThreads; ++x) {
        const int e = tid + x * kThreads, r = e / CPR, c = e % CPR;
        if (LOADS % kThreads != 0 && e >= LOADS) break;
        const bool ok = s0 + r < s_end;
        const size_t off = ok ? (size_t)(s0 + r) * row + c * VEC : 0;
        const int at = r * HDS + ((c ^ (r & 7)) * VEC);
        cp_async16(smem_addr(ks + at), kb + off, ok);
        cp_async16(smem_addr(vs + at), vb + off, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);

  // the G query heads of KV head kh are heads kh*G .. kh*G + G - 1; the
  // padding heads G .. are zero
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * HD;
  const int g8 = lane >> 2, q4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row
  // bf16: q as the B operand of S^T = K q^T (k = hd, n = heads), held in
  // registers for the whole loop
  uint32_t qf[kMma<T> ? NQT : 1][HD / 16][2];
  if constexpr (kMma<T>) {
#pragma unroll
    for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int h = nt * 8 + g8, d = kk * 16 + 2 * q4;
        const T* src = qb + (size_t)h * HD + d;
        qf[nt][kk][0] = h < G ? *reinterpret_cast<const uint32_t*>(src) : 0u;
        qf[nt][kk][1] =
            h < G ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
      }
  } else {
    for (int e = tid; e < GP * HD; e += kThreads)
      Qs[e] = e < G * HD ? to_f32(qb[e]) * scale : 0.f;
  }

  const int h0 = warp * HPW;        // this warp's first head
  const bool active = h0 < G;       // warp-uniform
  float* Pw = Ps + warp * HPW * KT;
  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }
  // the lane's output columns lie in 16-byte chunk vc at offset voff;
  // at hd 80 (112) lanes 20-31 (28-31) own padding columns and take no
  // part in P V
  const int vc = lane * DPL / VEC, voff = lane * DPL % VEC;
  const bool cols_ok = HD == HDS || lane * DPL < HD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile it landed, for this thread
    __syncthreads();               // ... for all; tile it - 1 consumed
    load_tile(it + kStages - 1);   // into the stage tile it - 1 used
    const T* ks = Ks + (it % kStages) * TILE;
    const T* vs = Vs + (it % kStages) * TILE;

    float dot[HPW];  // the score of key s0 + lane for the warp's heads
    if constexpr (kMma<T>) {
      // S^T [16 keys x 8 heads] per mma.sync m16n8k16, K by ldmatrix from
      // the swizzled tile: warp w < KT/16 owns keys 16w .. 16w + 15
      if (warp < KT / 16) {
        const int m0 = warp * 16;
        float st[NQT][4];
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          const int r = m0 + (mat & 1) * 8 + mrow;
          ldsm_x4(smem_addr(ks + r * HDS + (((2 * kk + (mat >> 1)) ^ mrow)
                                            * VEC)),
                  a);
#pragma unroll
          for (int nt = 0; nt < NQT; ++nt)
            mma_bf16(st[nt], a, qf[nt][kk][0], qf[nt][kk][1]);
        }
        // st[nt][e]: key m0 + g8 + 8 (e / 2), head 8 nt + 2 q4 + e % 2
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Qs[(nt * 8 + 2 * q4 + (e & 1)) * SROW + m0 + g8 + 8 * (e >> 1)] =
                st[nt][e] * scale;
      }
      __syncthreads();  // S complete
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < HPW; ++i) dot[i] = Qs[(h0 + i) * SROW + lane];
    } else {
      if (!active) continue;
      // fp32 dot products on the CUDA cores, in four interleaved partial
      // sums (four independent FMA chains)
      float sc[HPW][4];
#pragma unroll
      for (int i = 0; i < HPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
      const T* krow = ks + lane * HDS;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        float kx[VEC];
        load_vec<T, VEC>(krow + ((c ^ (lane & 7)) * VEC), kx);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const float* qh = Qs + (h0 + i) * HD + c * VEC;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qx = *reinterpret_cast<const float4*>(qh + e);
            sc[i][0] = fmaf(qx.x, kx[e], sc[i][0]);
            sc[i][1] = fmaf(qx.y, kx[e + 1], sc[i][1]);
            sc[i][2] = fmaf(qx.z, kx[e + 2], sc[i][2]);
            sc[i][3] = fmaf(qx.w, kx[e + 3], sc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < HPW; ++i)
        dot[i] = (sc[i][0] + sc[i][1]) + (sc[i][2] + sc[i][3]);
    }

    // key s0 < s_end is valid, so every tile's max is finite
    const bool ok = s_begin + it * KT + lane < s_end;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const float x = ok ? dot[i] : -INFINITY;
      float mx = x;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(x - m_new);
      float ps = p;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
      Pw[i * KT + lane] = p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // the warp's P is written and read by the warp alone
    // O += P V in fp32: P four keys at a time (broadcast reads)
#pragma unroll 2
    for (int c = 0; c < (cols_ok ? KT : 0); c += 4) {
      float pc[HPW][4];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + i * KT + c);
        pc[i][0] = p4.x;
        pc[i][1] = p4.y;
        pc[i][2] = p4.z;
        pc[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = c + u;
        float vx[DPL];
        load_vec<T, DPL>(vs + key * HDS + ((vc ^ (key & 7)) * VEC) + voff,
                         vx);
#pragma unroll
        for (int i = 0; i < HPW; ++i)
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[i][j] = fmaf(pc[i][u], vx[j], acc[i][j]);
      }
    }
    __syncwarp();  // P read before the next tile overwrites it
  }
  cp_async_wait<0>();  // no copy outlives the block

  // unnormalised partial of this split (m = -inf, l = 0 if it saw no key)
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = h0 + i;
    if (g >= G) break;  // warp-uniform
    const size_t slot = ((size_t)bk * nsplit + split) * G + g;
    if (cols_ok) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        part_o[slot * HD + lane * DPL + j] = acc[i][j];
    }
    if (lane == 0) {
      part_ml[slot * 2] = m[i];
      part_ml[slot * 2 + 1] = l[i];
    }
  }
}

// Second pass: one block of HD threads per (batch, query head) merges the
// splits' partials with the online-softmax rescaling and normalises.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      int H, int KH, int nsplit) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int G = H / KH, kh = h / G, g = h % G;
  const size_t base = ((size_t)(b * KH + kh) * nsplit) * G + g;
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int j = 0; j < nsplit; ++j)
    mx = fmaxf(mx, part_ml[(base + (size_t)j * G) * 2]);
  float sum = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
    for (int j = 0; j < nsplit; ++j) {
      const size_t slot = base + (size_t)j * G;
      const float w = expf(part_ml[slot * 2] - mx);
      sum = fmaf(part_ml[slot * 2 + 1], w, sum);
      acc = fmaf(part_o[slot * HD + d], w, acc);
    }
  }
  o[(size_t)bh * HD + d] = from_f32<T>(sum > 0.f ? acc / sum : 0.f);
}

template <typename T, int HD, int GP>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* kv_len, float* part_o, float* part_ml,
                         int B, int S, int H, int KH, int chunk, int nsplit,
                         float scale, int smem, cudaStream_t s) {
  constexpr int bytes = smem_bytes<T, HD, GP>();
  if (smem != bytes) return cudaErrorInvalidValue;  // plan mismatch
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(
      smem_set, reinterpret_cast<const void*>(decode_split_kernel<T, HD, GP>),
      bytes);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, HD, GP><<<dim3(nsplit, B * KH), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_o, part_ml, S, H, KH, chunk,
      nsplit, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* o, float* part_o, float* part_ml,
                   int B, int S, int H, int KH, int chunk, int nsplit,
                   float scale, int smem, cudaStream_t s) {
  const int G = H / KH;
  cudaError_t err;
#define SPLIT(GP)                                                          \
  launch_split<T, HD, GP>(q, k, v, kv_len, part_o, part_ml, B, S, H, KH, \
                          chunk, nsplit, scale, smem, s)
  if (G <= 1)
    err = SPLIT(1);
  else if (G <= 2)
    err = SPLIT(2);
  else if (G <= 4)
    err = SPLIT(4);
  else if (G <= 8)
    err = SPLIT(8);
  else
    err = SPLIT(16);
#undef SPLIT
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<B * H, HD, 0, s>>>(
      part_o, part_ml, static_cast<T*>(o), H, KH, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, HD], k/v caches [B, S, KH, HD] (one dtype, DT_F32 / DT_BF16,
// contiguous, 16-byte aligned), kv_len [B] i32 (device) -> o [B, H, HD].
// part_o: B*KH*nsplit*G*HD floats, part_ml: B*KH*nsplit*G*2 floats of
// scratch; chunk (a multiple of 32) keys per split, nsplit*chunk >= S;
// smem: the split kernel's dynamic shared bytes as the wrapper's plan
// computed them (checked here against the kernel's own count).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* part_o,
                                void* part_ml, int dtype, int B, int S,
                                int H, int KH, int HD, int chunk, int nsplit,
                                float scale, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
#define LAUNCH(T, D)                                                      \
  launch<T, D>(q, k, v, len, o, po, pml, B, S, H, KH, chunk, nsplit, scale, \
               smem, s)
  if (dtype == DT_F32) {
    if (HD == 128) return LAUNCH(float, 128);
    if (HD == 112) return LAUNCH(float, 112);
    if (HD == 80) return LAUNCH(float, 80);
    return LAUNCH(float, 64);
  }
  if (HD == 128) return LAUNCH(__nv_bfloat16, 128);
  if (HD == 112) return LAUNCH(__nv_bfloat16, 112);
  if (HD == 80) return LAUNCH(__nv_bfloat16, 80);
  return LAUNCH(__nv_bfloat16, 64);
#undef LAUNCH
}
