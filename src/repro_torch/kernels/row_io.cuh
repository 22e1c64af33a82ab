// Loads and stores of (R, T) row data shared by the locf and window_agg
// kernels: float32 values beside one-byte flags (torch.bool), row-major.
//
// The row instance (one thread per row, T <= 16) holds a row in registers:
// with VEC (16-byte aligned pointers, T % 4 == 0) values move as float4 and
// flags as the widest of 16-, 8- or 4-byte words that divides T; else one
// element at a time. The warp instance (one warp per row) covers 64 ticks a
// chunk, two a lane: with VEC (8-byte aligned rows, T even) a float2 and
// two flag bytes a lane, so a warp instruction touches 256 contiguous bytes
// of values and 64 of flags. Every load is read-only (__ldg).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowMaxT = 16;        // the row instance's largest T
constexpr int kRowThreads = 32;     // one-warp blocks: 2048 rows on 64 SMs
constexpr int kWarpThreads = 128;   // four rows a block
constexpr int kChunk = 64;          // ticks a warp covers at once
constexpr unsigned kFull = 0xffffffffu;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------------ row
template <int T, bool VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[T]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = x.x; v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) v[t] = __ldg(p + t);
  }
}

template <int T, bool VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[T]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < T / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) p[t] = v[t];
  }
}

template <int T, bool VEC>
__device__ __forceinline__ void load_row(const uint8_t* p,
                                         uint8_t (&b)[T]) {
  if constexpr (VEC) {
    uint32_t w[T / 4];
    if constexpr (T % 16 == 0) {
#pragma unroll
      for (int i = 0; i < T / 16; ++i) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = x.x; w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
      }
    } else if constexpr (T % 8 == 0) {
#pragma unroll
      for (int i = 0; i < T / 8; ++i) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + i);
        w[2 * i] = x.x; w[2 * i + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < T / 4; ++i)
        w[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) b[t] = (w[t / 4] >> (8 * (t % 4))) & 0xff;
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) b[t] = __ldg(p + t);
  }
}

template <int T, bool VEC>
__device__ __forceinline__ void store_row(uint8_t* p,
                                          const uint8_t (&b)[T]) {
  if constexpr (VEC) {
    uint32_t w[T / 4];
#pragma unroll
    for (int i = 0; i < T / 4; ++i)
      w[i] = b[4 * i] | (b[4 * i + 1] << 8) | (b[4 * i + 2] << 16) |
             (b[4 * i + 3] << 24);
    if constexpr (T % 16 == 0) {
#pragma unroll
      for (int i = 0; i < T / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (T % 8 == 0) {
#pragma unroll
      for (int i = 0; i < T / 8; ++i)
        reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < T / 4; ++i)
        reinterpret_cast<unsigned int*>(p)[i] = w[i];
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) p[t] = b[t];
  }
}

// ----------------------------------------------------------------- warp
// ticks t and t + 1 of a row (t = chunk * 64 + 2 * lane): the values, and
// the flags as bits 0 and 1; ticks at or past T read as unflagged zeros.
// VEC needs an even T, so t < T implies t + 1 < T.
template <bool VEC>
__device__ __forceinline__ void load_pair(const float* vrow,
                                          const uint8_t* frow, int t, int T,
                                          float2& v, uint32_t& f) {
  v = make_float2(0.0f, 0.0f);
  f = 0;
  if constexpr (VEC) {
    if (t < T) {
      v = __ldg(reinterpret_cast<const float2*>(vrow + t));
      const unsigned short b =
          __ldg(reinterpret_cast<const unsigned short*>(frow + t));
      f = ((b & 0xff) ? 1u : 0u) | ((b >> 8) ? 2u : 0u);
    }
  } else {
    if (t < T) {
      v.x = __ldg(vrow + t);
      f = __ldg(frow + t) ? 1u : 0u;
    }
    if (t + 1 < T) {
      v.y = __ldg(vrow + t + 1);
      f |= __ldg(frow + t + 1) ? 2u : 0u;
    }
  }
}

// flags bits 0 and 1 to ticks t and t + 1 (those below T)
template <bool VEC>
__device__ __forceinline__ void store_pair(uint8_t* row, int t, int T,
                                           uint32_t bits) {
  if constexpr (VEC) {
    if (t < T)
      *reinterpret_cast<unsigned short*>(row + t) =
          static_cast<unsigned short>((bits & 1u) | ((bits >> 1) << 8));
  } else {
    if (t < T) row[t] = bits & 1u;
    if (t + 1 < T) row[t + 1] = bits >> 1;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_pair(float* row, int t, int T,
                                           float2 v) {
  if constexpr (VEC) {
    if (t < T) *reinterpret_cast<float2*>(row + t) = v;
  } else {
    if (t < T) row[t] = v.x;
    if (t + 1 < T) row[t + 1] = v.y;
  }
}

// Launch a row kernel instance for the runtime T (1..kRowMaxT): calls
// launch.template operator()<T, VEC>() for the matching template instance.
// VEC exists only where T % 4 == 0.
template <int T = 1, typename Launch>
cudaError_t dispatch_row(int t, bool vec, Launch&& launch) {
  if constexpr (T > kRowMaxT) {
    return cudaErrorInvalidValue;
  } else {
    if (t != T) return dispatch_row<T + 1>(t, vec, launch);
    if constexpr (T % 4 == 0) {
      if (vec) return launch.template operator()<T, true>();
    }
    if (vec) return cudaErrorInvalidValue;
    return launch.template operator()<T, false>();
  }
}

}  // namespace
