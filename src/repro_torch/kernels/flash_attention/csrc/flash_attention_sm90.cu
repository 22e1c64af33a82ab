// Causal GQA flash attention for Hopper's tensor cores: bfloat16 or float16
// in and out (E, one instance each), float32 scores, softmax and
// accumulators; optional sliding window and tanh softcap. Any head dim D
// that is a multiple of 8 up to 256, on the narrowest of three instances,
// DW = 64, 128 or 256 columns wide, that holds it.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, called through flash_attention_pallas), which tiles (Qb, D) and
// (Kb, D) blocks into VMEM, feeds both products to the MXU and carries
// (acc, m, l) in VMEM scratch across a sequential kv grid axis.
//
// Query offset: q and o are (B, Sq, H, D), k and v (B, Skv, Hkv, D); query
// row i sits at position q_offset + i, keys at 0..Skv-1, with
// q_offset + Sq <= Skv. Causal means key <= query position, and the window
// is measured in positions. Block starts, tile skips and the mask read
// positions; TMA loads and stores address rows. q_offset = 0 with Sq = Skv
// is the plain causal pass, computed exactly as before the offset existed.
//
// Bound on Hopper: operations. A block does 4*H*D*sum_rows min(pos + 1,
// window) flops (pos the row's position, window = Skv when there is none;
// 4*B*H*S^2*D/2 for a whole causal pass) against
// (B*Sq*2*H + 2*B*Skv*Hkv)*D elements moved, far above the card's
// flops-per-byte line, so the bound is the 16-bit tensor cores (989 TFLOP/s
// dense in bf16 and in fp16), reached only through wgmma.
//
// Design: one CTA per (128 q rows, q head, batch), q blocks launched
// heaviest first (the last causal block has the most key tiles). Three
// warpgroups: two consumers own 64 q rows each (wgmma M = 64); the third,
// the producer, drops its registers with setmaxnreg, and one of its threads
// issues the TMA loads: Q once, then K and V tiles of BN keys into a 2-stage
// ring, one full and one empty mbarrier per stage. The tensor maps describe the model layout as it is,
// dims (D, H, Sq, B) for q/out and (D, Hkv, Skv, B) for k/v, so no transpose
// precedes the launch and q head h reads kv head h / G directly. Every box is
// 64 columns (128 bytes) wide with the 128-byte swizzle that wgmma reads; a
// tile of DW columns is DW / 64 such chunks. TMA fills rows past Sq and keys
// past Skv with zeros; keys >= Skv are masked, and the store of a partial
// last q block stops at Sq (TMA clips the box).
// Head dim and instance width: the maps describe the tensors as they are
// (dim 0 = D, rows D * 2 bytes apart, so D % 8 == 0 keeps every row
// 16-byte aligned). Columns D .. DW - 1 of a chunk that starts below D
// are filled with zeros on load and clipped on the store; a chunk that
// starts at or past D (D <= 192 on the 256 instance) is neither loaded nor
// stored, and its places in the Q tile and the K/V ring are zeroed once
// when the CTA starts. The consumers do not read D: they run every k-step
// and every column as at D = DW, so the scores add the products of the D
// real columns and exact zeros, the columns past D are computed and never
// stored, and at D = DW the kernel computes exactly what it did when D was
// the instance, bit for bit, in the same registers. The softmax scale is
// the caller's (1/sqrt(D), never 1/sqrt(DW)).
//   * S = Q K^T: wgmma m64nBNk16, A (Q) and B (K) from shared memory, both
//     K-major, f32 accumulators in registers. The softmax scale multiplies
//     the f32 scores (the model calls with scale 1, its q already scaled).
//   * softmax in the accumulator fragment, with the TPU kernel's constants
//     and order: softcap tanh(s/cap)*cap before the mask, masked scores
//     -1e30, running max floored at -1e29, row max and sum by quad shuffles,
//     l summed from the f32 p. The mask is applied only on tiles that cut
//     the diagonal, the window edge or Skv; tiles wholly in a warpgroup's
//     causal future or before its window are skipped (they add p = 0 and
//     leave alpha at 1, so skipping is exact).
//   * O += P V with p split in two halves of E, P_hi = E(p) and
//     P_lo = E(p - P_hi), both register A fragments against the same V
//     tile in shared memory (MN-major: the transpose flag). A single bf16 p
//     would move outputs near zero by tens of bf16 ulps of the float32-p
//     reference; the split keeps p to ~16 bits at half again the tensor work.
//     float16 keeps the split: one f16 p (11 bits) would still move such
//     outputs by several f16 ulps, and the pair holds ~22 bits of p (fewer
//     only where P_lo falls below f16's normal range, 2^-14, a term too
//     small to move an output by 1e-5).
//   * epilogue: O / max(l, 1e-30), rounded once to E, written swizzled
//     into the warpgroup's own rows of the Q tile and stored by TMA; where
//     the caller passes an lse pointer, each row's m + log(max(l, 1e-30))
//     too (the backward's input), after the main loop, so the loop's
//     registers and the output's arithmetic are those of a null pointer.
// The PTX helpers (mbarriers, TMA, the wgmma forms and descriptors, the
// register pins, pack2) are kernels/sm90.cuh's, shared with the gradient's
// tensor-core kernels (flash_attention_bwd_sm90.cu).
#include <cstdint>
#include <type_traits>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../sm90.cuh"

namespace {

constexpr int kBlockM = 128;                  // q rows per CTA
constexpr int kMaxDevices = 64;               // shared-memory opt-in slots
constexpr int kConsumers = 2;                 // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 2;
constexpr int kRowBytes = 128;                // one swizzled row of a chunk
constexpr float kMasked = -1e30f;
constexpr float kMaxFloor = -1e29f;
constexpr float kDenomFloor = 1e-30f;

template <int DW, int BN>
struct Tiles {
  static constexpr int kChunks = DW / 64;                 // 64-column chunks
  static constexpr int kQChunk = kBlockM * kRowBytes;     // bytes
  static constexpr int kKVChunk = BN * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;   // K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + barriers, + slack to align the base to 1024 bytes (the swizzle atom)
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// Accumulator fragment of wgmma m64nN (f32): in each warpgroup, register i of
// thread (warp w, lane) holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (lane % 4) + i % 2. Registers 8j..8j+7 of a score
// fragment are then exactly the 16-bit A fragment of keys 16j..16j+15 for
// the P V product (pairs of neighbouring columns packed low to high).
template <typename E, int DW, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map,
                            float* __restrict__ lse, int Sq, int Skv,
                            int q_offset, int H, int Hkv, int D, int window,
                            float softcap, float scale) {
  using T = Tiles<DW, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;       // Q tile, chunk-major
  const uint32_t skv = sq + T::kQBytes;           // stage s: K, then V
  const uint32_t q_bar = sq + T::kBarOffset;
  const uint32_t full_bar = q_bar + 8;            // + 8 s
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;   // heaviest first
  const int p0 = q_offset + q0;                 // q0's position
  const int hk = h / (H / Hkv);
  const int q_last = q_offset + min(q0 + kBlockM, Sq) - 1;  // a position
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / BN * BN : 0;
  const int n_tiles = (q_last - k_begin) / BN + 1;
  const int wg = threadIdx.x / 128;
  const int n_chunks = (D + 63) / 64;           // chunks that hold columns

  if (n_chunks < T::kChunks) {
    // the chunks past D are never loaded: zeros in the Q tile and in every
    // stage's K and V tiles, visible to the tensor cores' (async) proxy
    uint8_t* const base = smem_raw + (sq - raw);
    const int per_chunk = T::kQChunk / 16 + kStages * 2 * T::kKVChunk / 16;
    const int n = (T::kChunks - n_chunks) * per_chunk;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = n_chunks + i / per_chunk;
      int j = i % per_chunk;
      uint32_t off;
      if (j < T::kQChunk / 16) {
        off = c * T::kQChunk + 16 * j;
      } else {
        j -= T::kQChunk / 16;
        const int tile = j / (T::kKVChunk / 16);   // stage s: 2 s K, 2 s + 1 V
        off = T::kQBytes + tile * T::kTileBytes + c * T::kKVChunk +
              16 * (j % (T::kKVChunk / 16));
      }
      *reinterpret_cast<uint4*>(base + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_bar, n_chunks * T::kQChunk);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        if (c < n_chunks)
          tma_load(sq + c * T::kQChunk, &q_map, q_bar, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar + 8 * s, (t / kStages - 1) & 1);
        const uint32_t full = full_bar + 8 * s;
        const uint32_t ks = skv + s * 2 * T::kTileBytes;
        const uint32_t vs = ks + T::kTileBytes;
        const int k0 = k_begin + t * BN;
        mbar_expect_tx(full, 2 * n_chunks * T::kKVChunk);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          if (c >= n_chunks) break;
          tma_load(ks + c * T::kKVChunk, &k_map, full, 64 * c, hk, k0, b);
          tma_load(vs + c * T::kKVChunk, &v_map, full, 64 * c, hk, k0, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wg_lo = p0 + 64 * wg;       // this warpgroup's rows' positions
    const int wg_hi = wg_lo + 63;
    const int row0 = wg_lo + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t q_wg = sq + 64 * wg * kRowBytes;

    float o[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = k_begin + t * BN;
      const uint32_t ks = skv + s * 2 * T::kTileBytes;
      const uint32_t vs = ks + T::kTileBytes;
      mbar_wait(full_bar + 8 * s, (t / kStages) & 1);
      const bool live = k0 <= wg_hi && (window == 0 || k0 + BN > wg_lo - window + 1);
      if (live) {
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DW / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
          wgmma_ss<BN, E>(sc,
                       sw128_desc(q_wg + (kk / 4) * T::kQChunk + off, 16,
                                  1024),
                       sw128_desc(ks + (kk / 4) * T::kKVChunk + off, 16,
                                  1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);

        const bool edge = k0 + BN - 1 > wg_lo || k0 + BN > Skv ||
                          (window > 0 && wg_hi - k0 >= window);
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          float x = sc[i] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (edge) {
            const int qpos = row0 + 8 * ((i / 2) % 2);
            const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            bool ok = kpos <= qpos && kpos < Skv;
            if (window > 0) ok = ok && qpos - kpos < window;
            x = ok ? x : kMasked;
          }
          sc[i] = x;
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(fmaxf(m[r], quad_max(mx[r])), kMaxFloor);
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
        uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * j + 2 * e;
            const int r = e % 2;
            const float p0 = expf(sc[i] - m[r]);
            const float p1 = expf(sc[i + 1] - m[r]);
            sum[r] += p0;
            sum[r] += p1;
            float h0, h1, unused0, unused1;
            p_hi[j][e] = pack2<E>(p0, p1, h0, h1);
            p_lo[j][e] = pack2<E>(p0 - h0, p1 - h1, unused0, unused1);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        pin(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          // keys 16j..16j+15 of every chunk; the chunks (64 columns of DW
          // each) sit T::kKVChunk apart, the leading byte offset
          const uint64_t vd = sw128_desc(vs + 16 * j * kRowBytes,
                                         T::kKVChunk, 1024);
          wgmma_rs<DW, E>(o, p_hi[j], vd);
          wgmma_rs<DW, E>(o, p_lo[j], vd);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
        pin(p_hi);
        pin(p_lo);
      }
      mbar_arrive(empty_bar + 8 * s);
    }

    // epilogue: this warpgroup's rows of the Q tile are free (its last QK
    // wgmma has completed); write O there in the TMA box's swizzled layout
    const float denom[2] = {fmaxf(l[0], kDenomFloor),
                                fmaxf(l[1], kDenomFloor)};
    uint8_t* const q_ptr = smem_raw + (q_wg - raw);
#pragma unroll
    for (int i = 0; i < DW / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int row = 16 * warp + lane / 4 + 8 * r;      // within 64 rows
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int unit = ((col % 64) / 8) ^ (row % 8);
      float unused0, unused1;
      *reinterpret_cast<uint32_t*>(
          q_ptr + (col / 64) * T::kQChunk + row * kRowBytes + unit * 16 +
          (col % 8) * 2) = pack2<E>(o[i] / denom[r], o[i + 1] / denom[r],
                                    unused0, unused1);
    }
    // the logsumexp of each row, m + log(max(l, 1e-30)) (m in the natural
    // log's base, as expf reads it), by one lane of the row's quad
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 64 * wg + 16 * warp + lane / 4 + 8 * r;
        if (row < Sq)
          lse[(static_cast<size_t>(blockIdx.y) * H + h) * Sq + row] =
              m[r] + logf(denom[r]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int wg_row = q0 + 64 * wg;                // its first row
    if (tid == 0 && wg_row < Sq) {
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        if (64 * c < D)
          tma_store(&o_map, q_wg + c * T::kQChunk, 64 * c, h, wg_row, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <typename E, int DW, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int q_offset, int H,
                   int Hkv, int D, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Tiles<DW, BN>::kSmem;
  // the opt-in belongs to the current device: once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        flash_attention_sm90_kernel<E, DW, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, encode, type, q, D, H, Sq, B, kBlockM) ||
      !make_map(&km, encode, type, k, D, Hkv, Skv, B, BN) ||
      !make_map(&vm, encode, type, v, D, Hkv, Skv, B, BN) ||
      !make_map(&om, encode, type, o, D, H, Sq, B, 64))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (Sq + kBlockM - 1) / kBlockM);
  flash_attention_sm90_kernel<E, DW, BN><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, om, lse, Sq, Skv, q_offset, H, Hkv, D, window, softcap,
      scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int Sq, int Skv,
                     int q_offset, int H, int Hkv, int window, float softcap,
                     float scale, cudaStream_t st) {
  // the narrowest instance that holds D
  if (D <= 0 || D % 8 != 0 || D > 256) return cudaErrorInvalidValue;
  if (D <= 64) return launch<E, 64, 128>(q, k, v, o, lse, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, st);
  if (D <= 128) return launch<E, 128, 128>(q, k, v, o, lse, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, st);
  return launch<E, 256, 64>(q, k, v, o, lse, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, st);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (the scalar entry's codes). q/o
// (B, Sq, H, D), k/v (B, Skv, Hkv, D), contiguous, 16-byte aligned; query
// row i at position q_offset + i, q_offset + Sq <= Skv; D % 8 == 0 and
// D <= 256, on the 64-, 128- or 256-column instance (256 on 64-key tiles,
// to fit shared memory and registers). lse: a float32 (B, H, Sq) output for
// each row's logsumexp of its scores (the backward's input), or null.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int Sq, int Skv,
                                           int q_offset, int H, int Hkv,
                                           int D, int window, float softcap,
                                           float scale, int dtype,
                                           void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      q_offset > Skv - Sq || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || (Sq + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = dispatch<__nv_bfloat16>(D, q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, q_offset, H, Hkv, window, softcap, scale, st);
  else if (dtype == 2)
    err = dispatch<__half>(D, q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, q_offset, H, Hkv, window, softcap, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
