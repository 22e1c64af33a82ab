// Pieces shared by the flash-attention kernels that run on the float32 FMA
// units: the forward's scalar kernel (flash_attention/csrc/flash_attention.cu)
// and the backward (flash_attention/csrc/flash_attention_bwd.cu). Tiles of 64
// rows are staged into shared memory as float32 whatever the input type
// (float32, bfloat16 or float16), four columns a thread at a time; float32
// rows can also arrive by cp.async; the TPU kernel's masking constants; the
// shared-memory opt-in above 48 KB.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {


constexpr float kMasked = -1e30f;
constexpr float kMaxFloor = -1e29f;
constexpr float kDenomFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;                // shared-memory opt-in slots

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 4 consecutive elements, 4-element aligned, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// columns c0 .. c0 + 3 of a row (c0 % 4 == 0), zeros at and past n
template <typename T>
__device__ __forceinline__ float4 fetch4(const T* row, int c0, int n,
                                         bool vec) {
  if (vec && c0 + 3 < n) return load4(row + c0);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = c0 + e < n ? to_f32(row[c0 + e]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Where a staged tile's element (row r, column c) goes in shared memory:
// kDMajor dst[c * 64 + r]; kDMajorSlots dst[c * 64 + row_slot(r)] (the
// rows R ty + .. of a strided owner lie side by side); kRowMajor
// dst[r * LD + c].
enum Layout { kDMajor, kDMajorSlots, kRowMajor };

// row r's place in a narrow block's d-major Q tile and in its P: thread
// ty's rows ty + 8 i lie at 8 ty + i
__device__ __forceinline__ int row_slot(int r) { return 8 * (r % 8) + r / 8; }

// A block of 64 rows x C columns on its way into shared memory: load()
// reads rows `row0` + r (r < 64, valid below `n_rows`) of a (., heads, D)
// tensor at head `hd`, columns c0 .. c0 + C - 1 (valid below D), into
// registers, all of a thread's loads in flight at once; put() stores them
// times `mul`, converted to float32. d-major layouts take consecutive rows
// on consecutive threads (the scattered stores spread over the banks), the
// row-major one consecutive column quads.
template <typename T, int C, Layout L, int LD, int THREADS>
struct Staged {
  static constexpr int kQuads = C / 4;
  static constexpr int kN = 64 * kQuads / THREADS;
  float4 x[kN];

  __device__ __forceinline__ static int row(int i) {
    return L == kRowMajor ? i / kQuads : i % 64;
  }
  __device__ __forceinline__ static int quad(int i) {
    return L == kRowMajor ? i % kQuads : i / 64;
  }
  __device__ __forceinline__ void load(const T* src, int row0, int n_rows,
                                       int heads, int hd, int D, int c0,
                                       bool vec) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const int s = row0 + row(i);
      x[k] = s < n_rows
                 ? fetch4(src + (static_cast<size_t>(s) * heads + hd) * D +
                              c0,
                          4 * quad(i), D - c0, vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // DLD: the destination's row stride (row-major layout), LD unless a
  // caller puts the same registers into a second tile of another width
  template <int DLD = LD>
  __device__ __forceinline__ void put(float* dst, float mul) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const float4 y = make_float4(x[k].x * mul, x[k].y * mul, x[k].z * mul,
                                   x[k].w * mul);
      if (L == kRowMajor) {
        *reinterpret_cast<float4*>(dst + row(i) * DLD + 4 * quad(i)) = y;
      } else {
        float* d = dst + 4 * quad(i) * 64 +
                   (L == kDMajorSlots ? row_slot(row(i)) : row(i));
        d[0] = y.x; d[64] = y.y; d[128] = y.z; d[192] = y.w;
      }
    }
  }
};

// float32 rows straight into shared memory by cp.async, 16 bytes a copy
// (no registers, nothing to convert): rows row0 .. row0 + 63 (valid below
// n_rows), columns 0 .. C - 1 (valid below D; D % 4 == 0 and 16-byte
// aligned rows) of a (., heads, D) tensor at head hd, row-major LD apart;
// zeros where invalid (a source size of 0 reads nothing)
template <int C, int LD, int THREADS>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int row0, int n_rows, int heads,
                                            int hd, int D) {
#pragma unroll
  for (int k = 0; k < 64 * C / 4 / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int r = i / (C / 4), c = 4 * (i % (C / 4)), s = row0 + r;
    const bool in = s < n_rows && c < D;
    const float* g =
        in ? src + (static_cast<size_t>(s) * heads + hd) * D + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<uint32_t>(
                         __cvta_generic_to_shared(dst + r * LD + c))),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// above 48 KB a block's shared memory must be opted into; the setting
// belongs to the current device, so set once per kernel and device (a
// repeated set is harmless)
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
bool aligned4(const void* p) {   // 4 elements
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

}  // namespace
