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
// context ~268 MB, ~80 us.
//
// Design. The TPU kernel walks the KV blocks of one (batch, KV head) in
// order on one core and carries the online-softmax state in VMEM. On the
// H100 one block per (batch, KV head) gives only B*K = 32 blocks at the
// path's shape, a quarter of the 132 SMs, each streaming its whole cache
// alone. So the cache is split along S: grid = (splits, B*K); block
// (j, b*K + k) streams keys [j*chunk, (j+1)*chunk) of that pair, clipped
// to kv_len[b], which each block reads on the device (no host sync, any
// per-row length). As on the TPU, the G = H/K query heads of the group
// share the block, so each K/V tile is read once for all of them. Tiles of
// 32 keys are staged through shared memory in fp32 with 16-byte loads; a
// lane owns one key of the tile for the scores, and a warp owns query
// heads g = warp, warp + 4, ... with an fp32 online softmax (max and sum by
// warp shuffles) and an fp32 accumulator of hd/32 columns per lane. Each
// block writes its unnormalised partial (acc, m, l); a second pass merges
// the splits of each (batch, head) with the same rescaling and divides by
// the sum. Rows past kv_len (and past S) are never read. Contract:
// 1 <= kv_len[b] (the decode path passes pos + 1); kv_len = 0 writes 0, as
// the Pallas kernel does. S needs no alignment; hd is 64 or 128; G <= 16;
// inputs bf16 or f32, output in q's dtype.

#include "kernel_common.cuh"

namespace {

constexpr int KT = 32;                // keys per staged tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int MAX_G = 16;             // query heads per KV head
constexpr int GPW = MAX_G / kWarps;   // query heads per warp, at most

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int S, int H, int KH, int chunk, int nsplit, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CHUNKS = HD / VEC;     // 16-byte loads per cached row
  constexpr int NJ = HD / 32;          // output columns per lane
  __shared__ float Qs[MAX_G][HD];
  __shared__ float Ks[KT][HD + 1];
  __shared__ float Vs[KT][HD + 1];
  __shared__ float Ps[MAX_G][KT];

  const int G = H / KH;
  const int bk = blockIdx.y, b = bk / KH, kh = bk % KH;
  const int split = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(kv_len[b], S);
  const int s_begin = split * chunk;
  const int s_end = min(len, s_begin + chunk);

  // the G query heads of KV head kh are heads kh*G .. kh*G + G - 1
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) Qs[e / HD][e % HD] = to_f32(qb[e]);

  float m[GPW], l[GPW], acc[GPW][NJ];
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const size_t row = (size_t)KH * HD;  // elements between keys s and s + 1
  const T* kb = k + (size_t)b * S * row + (size_t)kh * HD;
  const T* vb = v + (size_t)b * S * row + (size_t)kh * HD;

  for (int s0 = s_begin; s0 < s_end; s0 += KT) {
    __syncthreads();  // previous tile consumed (and Qs written)
    for (int e = tid; e < KT * CHUNKS; e += kThreads) {
      const int c = e / CHUNKS, d0 = (e % CHUNKS) * VEC, s = s0 + c;
      float kx[VEC], vx[VEC];
      if (s < s_end) {
        load16(kb + s * row + d0, kx);
        load16(vb + s * row + d0, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        Ks[c][d0 + i] = kx[i];
        Vs[c][d0 + i] = vx[i];
      }
    }
    __syncthreads();

    // key s0 < s_end is valid, so every tile's max is finite
    const bool ok = s0 + lane < s_end;
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;  // warp-uniform
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[g][d], Ks[lane][d], dot);
      const float sc = ok ? dot * scale : -INFINITY;
      float mx = sc;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(sc - m_new);
      float ps = p;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
      Ps[g][lane] = p;
      __syncwarp();  // a head's P is written and read by one warp
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      for (int c = 0; c < KT; ++c) {
        const float pc = Ps[g][c];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(pc, Vs[c][lane + 32 * j], acc[i][j]);
      }
    }
  }

  // unnormalised partial of this split (m = -inf, l = 0 if it saw no key)
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) break;
    const size_t slot = ((size_t)bk * nsplit + split) * G + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) part_o[slot * HD + lane + 32 * j] = acc[i][j];
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* o, float* part_o, float* part_ml,
                   int B, int S, int H, int KH, int chunk, int nsplit,
                   float scale, cudaStream_t s) {
  decode_split_kernel<T, HD><<<dim3(nsplit, B * KH), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_o, part_ml, S, H, KH, chunk,
      nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<B * H, HD, 0, s>>>(
      part_o, part_ml, static_cast<T*>(o), H, KH, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, HD], k/v caches [B, S, KH, HD] (one dtype, DT_F32 / DT_BF16,
// contiguous, 16-byte aligned), kv_len [B] i32 (device) -> o [B, H, HD].
// part_o: B*KH*nsplit*G*HD floats, part_ml: B*KH*nsplit*G*2 floats of
// scratch; chunk (a multiple of 32) keys per split, nsplit*chunk >= S.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* part_o,
                                void* part_ml, int dtype, int B, int S,
                                int H, int KH, int HD, int chunk, int nsplit,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == DT_F32) {
    if (HD == 128)
      return launch<float, 128>(q, k, v, len, o, po, pml, B, S, H, KH, chunk,
                                nsplit, scale, s);
    return launch<float, 64>(q, k, v, len, o, po, pml, B, S, H, KH, chunk,
                             nsplit, scale, s);
  }
  if (HD == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, len, o, po, pml, B, S, H, KH,
                                      chunk, nsplit, scale, s);
  return launch<__nv_bfloat16, 64>(q, k, v, len, o, po, pml, B, S, H, KH,
                                   chunk, nsplit, scale, s);
}
