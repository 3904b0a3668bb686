// Shared helpers for the port's CUDA kernels: element loads/stores in
// fp32 registers, asynchronous copies into shared memory, wgmma's
// swizzled layout, descriptors and fences, and the error-string export
// every library carries.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed by the Python wrappers
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg). With
// ok false nothing is read and the 16 bytes are zero-filled, so a masked
// row costs no load and can never bring a NaN in; src must still be a
// valid address (callers pass the tensor's base).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory (cp.async.ca: the only form that
// takes fewer than 16), zero-filled without a read when ok is false; for
// rows whose length or start is not a multiple of 16 bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma: operand layout, descriptors, fences

// byte offset of 16-byte chunk c of row r in a tile kept as column atoms
// of [ROWS][128 B] (64 bf16 or 32 f32 a row): in each group of 8 rows
// (1024 bytes) chunk c % 8 sits at (c % 8) ^ (r % 8). That is the 128-byte
// swizzle that wgmma's descriptors read (and no two of 8 rows share banks)
template <int ROWS>
__device__ __forceinline__ uint32_t atom_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// shared address addr (1024-byte-aligned atoms): lbo, sbo in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// ties registers to the surrounding wgmma fences and waits: the compiler
// neither touches an accumulator while a wgmma may own it nor computes a
// wgmma's input inside a batch (which makes ptxas serialise the batch)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint64_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(r[i])::"memory");
}
// cp.async writes through the generic proxy; wgmma reads through the
// async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Above 48 KB of dynamic shared memory a launch needs an opt-in, which
// is an attribute of the kernel on one device: set it on the current
// device the first time, flagging it in done[] (one array per kernel).
constexpr int kMaxDevices = 64;
inline cudaError_t allow_dynamic_smem(bool (&done)[kMaxDevices],
                                      const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
