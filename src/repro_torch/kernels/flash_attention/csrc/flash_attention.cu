// Causal GQA flash attention (online softmax), optional sliding window and
// tanh softcap, float32, bfloat16 or float16 in and out, float32
// accumulators, any head dim D >= 1.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, called through flash_attention_pallas), which tiles (Qb, D) and
// (Kb, D) blocks into VMEM and carries (acc, m, l) in VMEM scratch across a
// sequential kv grid axis.
//
// Query offset: q and o are (B, Sq, H, D), k and v (B, Skv, Hkv, D); query
// row i sits at position q_offset + i, keys at 0..Skv-1, with
// q_offset + Sq <= Skv. Causal means key <= query position, and the window
// is measured in positions. q_offset = 0 with Sq = Skv is the plain causal
// pass; a context-parallel shard passes its own rows at their offset
// against every key.
//
// Bound on Hopper: operations. A block does 4*H*D*sum_rows min(pos + 1,
// window) flops (pos the row's position, window = Skv when there is none;
// 4*B*H*S^2*D/2 for a whole causal pass) against
// (B*Sq*2*H + 2*B*Skv*Hkv)*D elements moved, so at S = 2048 it sits far
// above the card's flops-per-byte line. The real bound is the tensor
// cores (989 TFLOP/s in bf16), which this first, scalar kernel does not
// use: it runs on the float32 FMA units (67 TFLOP/s), and smem reads of the
// tiles are its practical limit. The 16-bit types at D = 64, 128 and 256
// run on the tensor cores instead (flash_attention_sm90.cu); this kernel
// serves float32 and every other head dim.
//
// Design: one CTA per (q block of 32 rows, q head and, for D > 256, output
// chunk, batch); 4 warps, each owning 8 query rows. The Q tile (pre-scaled)
// and each K/V tile of 32 keys are staged in shared memory as float32. The
// sequential kv grid axis of the TPU becomes a loop inside the CTA; blocks
// do not share state.
//   * scores: lane j computes key j's score for each of the warp's 8 rows
//     (K rows padded to D+1 floats, so the 32 lanes hit 32 banks; Q reads
//     are warp broadcasts);
//   * softmax: the row max and sum are warp shuffles; the TPU kernel's
//     constants are kept: masked scores -1e30, running-max floor -1e29,
//     denominator floor 1e-30, softcap before the mask;
//   * PV: lane owns dims lane + 32*i of each row's accumulator (registers),
//     p_j is broadcast by shuffle; p stays float32 (as kernel.py:62 does).
// Head dims: instances are DW = 16, 32, 64, 128 and 256 columns wide, and
// a head dim runs on the narrowest that holds it (D <= 256), its columns
// past D staged as zeros and never stored; the score loop runs over D
// itself, so D = DW adds exactly the products it always did. D > 256 runs
// on DW = 256 with grid axis y over (head, 256-column chunk of the output):
// each block reads all of D for the scores, chunk by chunk (Q and K
// restaged per chunk, the sums continuing in column order), keeps the full
// softmax and does the PV product of its own chunk only.
// GQA: q head h reads kv head h / G, never a repeated copy. KV tiles wholly
// in the causal future of the block, or wholly before every row's window,
// are skipped: such a tile would add p = 0 and leave alpha at 1 (or 0 for
// a row that has seen nothing), so skipping is exact. Any Sq and Skv are
// accepted: rows past Sq and keys past Skv are bounds-checked (the TPU
// kernel asserted S was a multiple of its blocks). Inputs are read in the
// model layout (B, S, H, D) directly, so no transpose precedes the launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
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

template <int DW>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBlockQ) * DW + size_t(kBlockK) * (DW + 1) +
                          size_t(kBlockK) * DW);
}

// sc[r] += sum over d < n of qw[r][d] * krow[d], in column order; N > 0
// fixes n = N at compile time (a chunk as wide as the instance)
template <int N, int STRIDE>
__device__ __forceinline__ void qk_dot(float (&sc)[kRowsPerWarp],
                                       const float* qw, const float* krow,
                                       int n) {
#pragma unroll 4
  for (int d = 0; d < (N > 0 ? N : n); ++d) {
    const float kd = krow[d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      sc[r] = fmaf(qw[r * STRIDE + d], kd, sc[r]);
  }
}

template <typename T, int DW>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int q_offset, int H, int Hkv, int D,
                       int window, float softcap, float scale) {
  constexpr int kDPL = (DW + 31) / 32;  // accumulator dims per lane
  constexpr int kKStride = DW + 1;      // padded K row
  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x DW
  float* ks = qs + kBlockQ * DW;             // kBlockK x (DW + 1)
  float* vs = ks + kBlockK * kKStride;       // kBlockK x DW

  const int n_chunks = (D + DW - 1) / DW;       // 1 unless D > 256
  const int q0 = blockIdx.x * kBlockQ;          // first row of the block
  const int h = blockIdx.y / n_chunks;
  const int d_out = (blockIdx.y - h * n_chunks) * DW;  // its output columns
  const int dv = min(DW, D - d_out);                   // d_out .. + dv - 1
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // columns dc .. dc + DW - 1 of the block's q rows, scaled; zeros past D
  auto stage_q = [&](int dc) {
    for (int i = tid; i < kBlockQ * DW; i += kThreads) {
      const int r = i / DW, d = i - r * DW, s = q0 + r;
      qs[i] = s < Sq && dc + d < D
                  ? to_f32(q[((size_t(b) * Sq + s) * H + h) * D + dc + d]) *
                        scale
                  : 0.f;
    }
  };
  if (n_chunks == 1) stage_q(0);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first row
  const int p0 = q_offset + q0;                // the block's first position
  const int q_last = q_offset + min(q0 + kBlockQ, Sq) - 1;  // a position
  int k_begin = 0;
  if (window > 0) k_begin = max(0, p0 - window + 1) / kBlockK * kBlockK;
  const float* qw = qs + warp * kRowsPerWarp * DW;

  for (int k0 = k_begin; k0 <= q_last; k0 += kBlockK) {
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* krow = ks + lane * kKStride;
    // the scores over D in chunks of DW columns (one chunk unless D > 256);
    // the V columns of this block's output arrive with the first
    for (int dc = 0; dc < D; dc += DW) {
      __syncthreads();  // Q staged / the previous tile or chunk fully read
      if (n_chunks > 1) stage_q(dc);
      for (int i = tid; i < kBlockK * DW; i += kThreads) {
        const int j = i / DW, d = i - j * DW, s = k0 + j;
        float kx = 0.f, vx = 0.f;
        if (s < Skv) {
          const size_t row = ((size_t(b) * Skv + s) * Hkv + hk) * D;
          if (dc + d < D) kx = to_f32(k[row + dc + d]);
          if (dc == 0 && d < dv) vx = to_f32(v[row + d_out + d]);
        }
        ks[j * kKStride + d] = kx;
        if (dc == 0) vs[j * DW + d] = vx;
      }
      __syncthreads();
      const int dn = min(DW, D - dc);
      if (dn == DW)
        qk_dot<DW, DW>(sc, qw, krow, dn);
      else
        qk_dot<0, DW>(sc, qw, krow, dn);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q_offset + row0 + r;
      float s = sc[r];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      bool ok = kpos <= qpos && kpos < Skv;
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
        vv[i] = d < dv ? vs[j * DW + d] : 0.f;
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
    if (s >= Sq) continue;
    const float denom = fmaxf(l[r], kDenomFloor);
    T* orow = o + ((size_t(b) * Sq + s) * H + h) * D + d_out;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dv) store(orow + d, acc[r][i] / denom);
    }
  }
}

template <typename T, int DW>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int q_offset, int H, int Hkv,
                   int D, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DW>();
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
        flash_attention_kernel<T, DW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const long long heads = static_cast<long long>(H) * ((D + DW - 1) / DW);
  if (heads > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, static_cast<unsigned>(heads),
                  B);
  flash_attention_kernel<T, DW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, q_offset, H,
      Hkv, D, window, softcap, scale);
  return cudaGetLastError();
}

// the narrowest instance that holds D; D > 256 on the 256-wide one, in
// 256-column chunks
template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Sq, int Skv, int q_offset, int H,
                     int Hkv, int window, float softcap, float scale,
                     cudaStream_t stream) {
  if (D <= 16) return launch<T, 16>(q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q/o (B, Sq, H, D), k/v
// (B, Skv, Hkv, D), contiguous, D >= 1; query row i at position
// q_offset + i, q_offset + Sq <= Skv.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int q_offset, int H, int Hkv,
                                      int D, int window, float softcap,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      q_offset > Skv - Sq || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(D, q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, window, softcap, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, window, softcap, scale, st);
  else if (dtype == 2)
    err = dispatch<__half>(D, q, k, v, o, B, Sq, Skv, q_offset, H, Hkv, window, softcap, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
