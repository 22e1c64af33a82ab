// Causal GQA flash attention (online softmax), optional sliding window and
// tanh softcap, float32 or bfloat16 in and out, float32 accumulators.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, called through flash_attention_pallas), which tiles (Qb, D) and
// (Kb, D) blocks into VMEM and carries (acc, m, l) in VMEM scratch across a
// sequential kv grid axis.
//
// Bound on Hopper: operations. A causal pass does 4*B*H*S^2*D/2 flops
// against 2*B*S*(H + 2*Hkv)*D elements moved, so at S = 2048 it sits far
// above the card's flops-per-byte line. The real bound is the tensor
// cores (989 TFLOP/s in bf16), which this first, scalar kernel does not
// use: it runs on the float32 FMA units (67 TFLOP/s), and smem reads of the
// tiles are its practical limit. wgmma, TMA and warp specialisation are the
// next step.
//
// Design: one CTA per (q block of 32 rows, q head, batch); 4 warps, each
// owning 8 query rows. The Q tile (pre-scaled) and each K/V tile of 32
// keys are staged in shared memory as float32. The sequential kv grid axis
// of the TPU becomes a loop inside the CTA; blocks do not share state.
//   * scores: lane j computes key j's score for each of the warp's 8 rows
//     (K rows padded to D+1 floats, so the 32 lanes hit 32 banks; Q reads
//     are warp broadcasts);
//   * softmax: the row max and sum are warp shuffles; the TPU kernel's
//     constants are kept: masked scores -1e30, running-max floor -1e29,
//     denominator floor 1e-30, softcap before the mask;
//   * PV: lane owns dims lane + 32*i of each row's accumulator (registers),
//     p_j is broadcast by shuffle; p stays float32 (as kernel.py:62 does).
// GQA: q head h reads kv head h / G, never a repeated copy. KV tiles wholly
// in the causal future of the block, or wholly before every row's window,
// are skipped: such a tile would add p = 0 and leave alpha at 1 (or 0 for
// a row that has seen nothing), so skipping is exact. Any S is accepted:
// rows and keys past S are bounds-checked (the TPU kernel asserted S was a
// multiple of its blocks). Inputs are read in the model layout (B, S, H, D)
// directly, so no transpose precedes the launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;                    // query rows per CTA
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kBlockK = 32;                    // keys per tile, one per lane
constexpr float kMasked = -1e30f;
constexpr float kMaxFloor = -1e29f;
constexpr float kDenomFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;                // shared-memory opt-in slots

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockQ) * D + size_t(kBlockK) * (D + 1) + size_t(kBlockK) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int Hkv, int window, float softcap,
                       float scale) {
  constexpr int kDPL = (D + 31) / 32;  // accumulator dims per lane
  constexpr int kKStride = D + 1;      // padded K row
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x D
  float* ks = qs + kBlockQ * D;              // kBlockK x (D + 1)
  float* vs = ks + kBlockK * kKStride;       // kBlockK x D

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, s = q0 + r;
    qs[i] = s < S ? to_f32(q[((size_t(b) * S + s) * H + h) * D + d]) * scale
                  : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  const int q_last = min(q0 + kBlockQ, S) - 1;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;
  const float* qw = qs + warp * kRowsPerWarp * D;

  for (int k0 = k_begin; k0 <= q_last; k0 += kBlockK) {
    __syncthreads();  // Q staged / the previous tile fully read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, d = i - j * D, s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = ((size_t(b) * S + s) * Hkv + hk) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * kKStride + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* krow = ks + lane * kKStride;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        sc[r] = fmaf(qw[r * D + d], kd, sc[r]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = row0 + r;
      float s = sc[r];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      bool ok = kpos <= qpos && kpos < S;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s = ok ? s : kMasked;
      const float m_new = fmaxf(fmaxf(m[r], warp_max(s)), kMaxFloor);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      sc[r] = p;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, sc[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = row0 + r;
    if (s >= S) continue;
    const float denom = fmaxf(l[r], kDenomFloor);
    T* orow = o + ((size_t(b) * S + s) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(orow + d, acc[r][i] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int Hkv, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into; the setting
  // belongs to the current device, so set once per instance and device (a
  // repeated set is harmless)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, window,
      softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int Hkv, int window,
                     float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o (B, S, H, D), k/v (B, S, Hkv, D),
// contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int D, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(D, q, k, v, o, B, S, H, Hkv, window, softcap, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, window, softcap, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
