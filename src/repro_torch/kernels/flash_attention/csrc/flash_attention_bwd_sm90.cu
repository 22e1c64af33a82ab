// Gradient of causal GQA flash attention (optional sliding window and tanh
// softcap) on Hopper's tensor cores: bfloat16 or float16 in and out (E, one
// instance each), float32 arithmetic, any head dim D that is a multiple of
// 8 up to 256, on the narrowest of three instances, DW = 64, 128 or 256
// columns wide, that holds it (the forward's domain and widths,
// flash_attention_sm90.cu). Two of the gradient's four launches: the
// (b) dK/dV and (c) dQ kernels of flash_attention_bwd.cu, whose (a) delta
// and (b') sum kernels this instance launches too. Every sum is taken in
// a fixed order and every output element has one writer, so two calls on
// the same inputs give the same bits:
//   (b) flash_bwd_dkdv_wgmma_kernel: one CTA per (b, q head, 128-key block,
//       group of 128 output columns): the q head's share of dK and dV at its
//       keys, summed over every q tile that sees them, written in float32 to
//       the (B, Skv, H, D) partial of each, which (b') adds over a kv head's
//       q heads in head order;
//   (c) flash_bwd_dq_wgmma_kernel: one CTA per (b, q head, 128-row block):
//       dQ of its rows over the key tiles they see.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention/kernel.py has no
// backward, and the reference trains through src/repro/models/layers.py's
// blockwise_attention, which JAX differentiates with its score chunks
// recomputed. This is the tensor-core redesign of flash_attention_bwd.cu's
// FMA kernels in 16 bits; flash_attention_bwd_tf32.cu is float32's (and the
// 16-bit head dims this instance does not take, up to 128), and the FMA
// kernels stay for the head dims above both.
//
// Query offset: q, dO and dQ are (B, Sq, H, D), k, v (B, Skv, Hkv, D); query
// row i sits at position q_offset + i, keys at 0..Skv-1, with
// q_offset + Sq <= Skv, as in the forward. Keys no row sees get dK = dV = 0.
//
// Bound on Hopper: operations. The recompute and the four products do 2.5
// times the forward's causal FLOPs on ~(4 B Sq H + 4 B Skv Hkv) D elements
// moved; the card's peak for them is the 16-bit tensor cores' (989 TFLOP/s
// dense), reached only through wgmma. This design does 20 D FLOPs per
// scored (row, key) pair, twice the bound's 10 D: each kernel recomputes S
// and dP (8 D), and P and dS enter their three products as two halves each
// (12 D), so 2 x the bound is its own ceiling.
//
// Design: the forward's (flash_attention_sm90.cu), through the Hopper
// helpers of sm90.cuh. 384 threads: two consumer warpgroups own 64 rows
// each of a CTA's 128 resident rows (wgmma M = 64) and raise their
// registers to 232 with setmaxnreg; the producer warpgroup drops to 40 (the
// CTA's own registers move between them), and its first warp feeds a
// 2-stage ring of streamed tiles of BS rows, one full and one empty
// mbarrier per stage. BS is 64, and 32 where a stage of 64 would not fit
// shared memory (DW = 256) or where the dK/dV kernel's two 64 x 128
// float32 accumulators and two 64 x BS score fragments would not fit 232
// registers (DW = 128: at BS = 64 it spilled).
// Every tile is a TMA box of 64 columns (128 bytes) with the 128-byte
// swizzle wgmma reads, DW / 64 such chunks; TMA fills rows past S and
// columns past D with zeros, and chunks wholly past D are zeroed once when
// the CTA starts and never loaded, so the consumers run every column as at
// D = DW.
//   * dK/dV, computed transposed: the resident tiles are the CTA's keys of
//     K and V, the streamed ones q tiles of Q and dO (and, written by the
//     producer warp's lanes into the stage, the tile's lse and delta rows).
//     S^T = K Q^T and dP^T = V dO^T (wgmma ss, both K-major), then in the
//     accumulator fragment P^T = exp(scale S^T - lse) (the softcap before
//     the mask, as the forward) and dS^T = P^T (dP^T - delta) (1 - t^2);
//     then dV += P^T dO and dK += dS^T Q (wgmma rs: the fragments are the A
//     operand as they are, dO and Q the MN-major B at the CTA's output
//     columns). A tile is skipped by a warpgroup whose keys it cannot see;
//     masks are applied only on tiles that cut the diagonal, the window
//     edge or Sq. dK/dV accumulators for DW columns would not fit in
//     registers at DW = 256, so the output columns split into groups of 128
//     over grid axis x, each recomputing S^T and dP^T. The scale multiplies
//     dK once, in the float32 share.
//   * dQ: the resident tiles are the CTA's rows of Q and dO, the streamed
//     ones key tiles of K and V; S = Q K^T and dP = dO V^T (ss), P and dS in
//     the fragment, dQ += dS K (rs, K MN-major); the scale multiplies dQ
//     once, and it is rounded once to E, written into the warpgroup's rows
//     of the Q tile and stored by TMA, as the forward stores O. Row blocks
//     launch heaviest first.
//   * P and dS are float32. Each goes to the tensor cores as two halves of
//     E, hi = E(x) and lo = E(x - hi), as the forward splits p: x to ~16
//     bits in bfloat16 (~22 in float16; fewer only where lo is below E's
//     normal range) at twice the tensor work of one 16-bit operand.
//     ref.backward_error_bound(split=True) carries the halves' error.
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../flash_tiles.cuh"
#include "../../sm90.cuh"

namespace {

constexpr int kRows = 128;                    // resident rows a CTA
constexpr int kWarpgroups = 2;                // consumers of 64 rows each
constexpr int kBwdThreads = (kWarpgroups + 1) * 128;
constexpr int kRing = 2;                      // stages of streamed tiles
constexpr int kChunkRow = 128;                // bytes of a swizzled chunk row

// Shared memory: two resident tiles of kRows rows (the dQ kernel's Q and
// dO, the dK/dV kernel's K and V), the ring's 2 kRing streamed tiles of BS
// rows (K and V, or Q and dO), each stage's lse and delta rows (dK/dV), and
// the barriers: resident, kRing full, kRing empty.
template <int DW, int BS>
struct BwdTiles {
  static constexpr int kChunks = DW / 64;
  static constexpr int kResChunk = kRows * kChunkRow;     // bytes
  static constexpr int kStrChunk = BS * kChunkRow;
  static constexpr int kResTile = kChunks * kResChunk;
  static constexpr int kStrTile = kChunks * kStrChunk;
  static constexpr int kRingOffset = 2 * kResTile;         // stage s: 2 tiles
  static constexpr int kRowsOffset = kRingOffset + kRing * 2 * kStrTile;
  static constexpr int kBarOffset = kRowsOffset + kRing * 2 * BS * 4;
  // + slack to align the base to 1024 bytes (the swizzle atom)
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kRing) + 1024;
};

// the streamed tile's rows a stage holds: 64, and 32 at DW = 256 and in
// the dK/dV kernel at DW = 128
template <int DW, bool kDkdv>
constexpr int stream_rows() {
  return DW == 256 || (kDkdv && DW == 128) ? 32 : 64;
}

// the output columns a dK/dV CTA holds: DW, at most 128 (two groups over
// grid axis x at DW = 256)
template <int DW>
__host__ __device__ constexpr int dkdv_cols() {
  return DW < 128 ? DW : 128;
}

// zeros chunks n_chunks .. chunks - 1 of n_tiles consecutive tiles of
// `chunks` chunks of chunk_bytes each
__device__ __forceinline__ void zero_past_d(uint8_t* p, int n_tiles,
                                            int chunks, int chunk_bytes,
                                            int n_chunks) {
  const int per = (chunks - n_chunks) * chunk_bytes / 16;   // 16-byte units
  for (int i = threadIdx.x; i < n_tiles * per; i += kBwdThreads) {
    const int t = i / per;
    *reinterpret_cast<uint4*>(p + (t * chunks + n_chunks) * chunk_bytes +
                              16 * (i - t * per)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the CTA's set-up: chunks past D zeroed in every tile and made visible to
// the async proxy, the barriers initialized (full: `full_count` arrivals)
template <int DW, int BS>
__device__ __forceinline__ void bwd_setup(uint8_t* tiles, uint32_t bars,
                                          int n_chunks, int full_count) {
  using T = BwdTiles<DW, BS>;
  if (n_chunks < T::kChunks) {
    zero_past_d(tiles, 2, T::kChunks, T::kResChunk, n_chunks);
    zero_past_d(tiles + T::kRingOffset, 2 * kRing, T::kChunks, T::kStrChunk,
                n_chunks);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bars + 8 + 8 * s, full_count);
      mbar_init(bars + 8 + 8 * kRing + 8 * s, kWarpgroups * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// S and dP of one tile (or their transposes): s = A1 B1^T and dp = A2 B2^T
// over DW columns, f32 in registers; A1 and A2 are a warpgroup's 64 rows
// of the resident tiles, B1 and B2 the stage's BS-row streamed tiles
template <typename E, int DW, int BS>
__device__ __forceinline__ void scores(float (&s)[BS / 2], float (&dp)[BS / 2],
                                       uint32_t a1, uint32_t a2, uint32_t b1,
                                       uint32_t b2) {
  using T = BwdTiles<DW, BS>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DW / 16; ++kk) {
    const uint32_t off = (kk / 4) * T::kResChunk + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * T::kStrChunk + (kk % 4) * 32;
    wgmma_ss<BS, E>(s, sw128_desc(a1 + off, 16, 1024),
                    sw128_desc(b1 + boff, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DW / 16; ++kk) {
    const uint32_t off = (kk / 4) * T::kResChunk + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * T::kStrChunk + (kk % 4) * 32;
    wgmma_ss<BS, E>(dp, sw128_desc(a2 + off, 16, 1024),
                    sw128_desc(b2 + boff, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  pin(dp);
}

// the f32 fragment x as hi and lo halves of E, the rs A fragments of its
// BS / 16 k-slices
template <typename E, int BS>
__device__ __forceinline__ void split(const float (&x)[BS / 2],
                                      uint32_t (&hi)[BS / 16][4],
                                      uint32_t (&lo)[BS / 16][4]) {
#pragma unroll
  for (int j = 0; j < BS / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * j + 2 * e;
      float h0, h1, unused0, unused1;
      hi[j][e] = pack2<E>(x[i], x[i + 1], h0, h1);
      lo[j][e] = pack2<E>(x[i] - h0, x[i + 1] - h1, unused0, unused1);
    }
}

// ------------------------------------------------------------------ (b)
// Accumulator fragment of wgmma m64nN (f32): register i of thread (warp w,
// lane) holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) +
// 2 (lane % 4) + i % 2 (rows are keys here, columns the tile's q rows), so
// registers 8j..8j+7 of P^T and dS^T are the A fragments of q rows
// 16j..16j+15 for the dV and dK products.
template <typename E, int DW, int BS>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ part, int Sq, int Skv,
                            int q_offset, int H, int Hkv, int D, int window,
                            float softcap, float scale) {
  using T = BwdTiles<DW, BS>;
  constexpr int DO = dkdv_cols<DW>();
  constexpr int kGroups = DW / DO;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const tiles = smem_raw + (base - raw);
  const uint32_t sk = base;                      // resident K, then V
  const uint32_t sv = base + T::kResTile;
  const uint32_t ring = base + T::kRingOffset;   // stage s: Q, then dO
  float* const rows = reinterpret_cast<float*>(tiles + T::kRowsOffset);
  const uint32_t res_bar = base + T::kBarOffset;
  const uint32_t full_bar = res_bar + 8;         // + 8 s
  const uint32_t empty_bar = full_bar + 8 * kRing;

  const int hq = blockIdx.x / kGroups;
  const int c_lo = (blockIdx.x % kGroups) * DO;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kRows;             // key block 0 first
  const int hk = hq / (H / Hkv);
  // the rows that see keys k0 .. k_last: positions k0 .. k_last + window - 1
  const int k_last = min(k0 + kRows, Skv) - 1;
  const int r_first = max(0, k0 - q_offset) / BS * BS;
  const int r_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int n_tiles = r_end > r_first ? (r_end - r_first + BS - 1) / BS : 0;
  const int n_chunks = (D + 63) / 64;
  const int wg = threadIdx.x / 128;
  const size_t row_base = (static_cast<size_t>(b) * H + hq) * Sq;

  bwd_setup<DW, BS>(tiles, res_bar, n_chunks, 32);

  if (wg == kWarpgroups) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kWarpgroups * 128;
    if (pt < 32 && n_tiles > 0) {
      if (pt == 0) {
        mbar_expect_tx(res_bar, 2 * n_chunks * T::kResChunk);
        for (int c = 0; c < n_chunks; ++c) {
          tma_load(sk + c * T::kResChunk, &k_map, res_bar, 64 * c, hk, k0, b);
          tma_load(sv + c * T::kResChunk, &v_map, res_bar, 64 * c, hk, k0, b);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kRing;
        if (t >= kRing) mbar_wait(empty_bar + 8 * s, (t / kRing - 1) & 1);
        const int r0 = r_first + t * BS;
        // the tile's lse and delta rows, zeros past Sq
        float* const rs = rows + s * 2 * BS;
        for (int i = pt; i < BS; i += 32) {
          const bool in = r0 + i < Sq;
          rs[i] = in ? lse[row_base + r0 + i] : 0.f;
          rs[BS + i] = in ? delta[row_base + r0 + i] : 0.f;
        }
        const uint32_t full = full_bar + 8 * s;
        if (pt == 0) {
          const uint32_t qs = ring + s * 2 * T::kStrTile;
          mbar_expect_tx(full, 2 * n_chunks * T::kStrChunk);
          for (int c = 0; c < n_chunks; ++c) {
            tma_load(qs + c * T::kStrChunk, &q_map, full, 64 * c, hq, r0, b);
            tma_load(qs + T::kStrTile + c * T::kStrChunk, &do_map, full,
                     64 * c, hq, r0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wk_lo = k0 + 64 * wg;          // this warpgroup's keys
    const int wk_hi = wk_lo + 63;
    const int key0 = wk_lo + 16 * warp + lane / 4;   // and key0 + 8
    const uint32_t a_off = 64 * wg * kChunkRow;

    float dk[DO / 2], dv[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_tiles > 0) mbar_wait(res_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kRing;
      const int r0 = r_first + t * BS;
      const uint32_t qs = ring + s * 2 * T::kStrTile;
      const uint32_t dos = qs + T::kStrTile;
      const float* const rs = rows + s * 2 * BS;
      mbar_wait(full_bar + 8 * s, (t / kRing) & 1);
      const int pr_lo = q_offset + r0;       // the tile's first position
      const int pr_hi = pr_lo + BS - 1;
      const bool live = pr_hi >= wk_lo && (window == 0 || pr_lo - wk_hi < window);
      if (live) {
        float st[BS / 2], dpt[BS / 2];
        scores<E, DW, BS>(st, dpt, sk + a_off, sv + a_off, qs, dos);
        const bool edge = pr_lo < wk_hi || r0 + BS > Sq ||
                          (window > 0 && pr_hi - wk_lo >= window);
#pragma unroll
        for (int i = 0; i < BS / 2; ++i) {
          const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;   // tile row
          bool ok = true;
          if (edge) {
            const int kpos = key0 + 8 * ((i / 2) % 2);
            const int qpos = pr_lo + col;
            ok = r0 + col < Sq && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
          }
          p_ds(st[i], dpt[i], ok, rs[col], rs[BS + col], scale, softcap);
        }
        uint32_t p_hi[BS / 16][4], p_lo[BS / 16][4];
        uint32_t d_hi[BS / 16][4], d_lo[BS / 16][4];
        split<E, BS>(st, p_hi, p_lo);
        split<E, BS>(dpt, d_hi, d_lo);

        pin(dk);
        pin(dv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BS / 16; ++j) {
          // q rows 16j..16j+15 of the output columns' chunks, which sit
          // T::kStrChunk apart (the leading byte offset)
          const uint32_t off = (c_lo / 64) * T::kStrChunk + 16 * j * kChunkRow;
          const uint64_t od = sw128_desc(dos + off, T::kStrChunk, 1024);
          const uint64_t qd = sw128_desc(qs + off, T::kStrChunk, 1024);
          wgmma_rs<DO, E>(dv, p_hi[j], od);
          wgmma_rs<DO, E>(dv, p_lo[j], od);
          wgmma_rs<DO, E>(dk, d_hi[j], qd);
          wgmma_rs<DO, E>(dk, d_lo[j], qd);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(dk);
        pin(dv);
        pin(p_hi);
        pin(p_lo);
        pin(d_hi);
        pin(d_lo);
      }
      mbar_arrive(empty_bar + 8 * s);
    }

    // the q head's float32 shares: dK (times the scale) to part's first
    // (B, Skv, H, D) half, dV to its second; pairs of neighbouring columns
    const size_t n = static_cast<size_t>(gridDim.y) * Skv * H * D;
#pragma unroll
    for (int i = 0; i < DO / 2; i += 2) {
      const int key = key0 + 8 * ((i / 2) % 2);
      const int col = c_lo + 8 * (i / 4) + 2 * (lane % 4);
      if (key < Skv && col < D) {
        float* const pk =
            part + ((static_cast<size_t>(b) * Skv + key) * H + hq) * D + col;
        *reinterpret_cast<float2*>(pk) =
            make_float2(dk[i] * scale, dk[i + 1] * scale);
        *reinterpret_cast<float2*>(pk + n) = make_float2(dv[i], dv[i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ (c)
// The fragment layout of (b), rows the CTA's q rows and columns the tile's
// keys: registers 8j..8j+7 of dS are the A fragment of keys 16j..16j+15.
template <typename E, int DW, int BS>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int Sq, int Skv,
                          int q_offset, int H, int Hkv, int D, int window,
                          float softcap, float scale) {
  using T = BwdTiles<DW, BS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const tiles = smem_raw + (base - raw);
  const uint32_t sq = base;                      // resident Q, then dO
  const uint32_t sdo = base + T::kResTile;
  const uint32_t ring = base + T::kRingOffset;   // stage s: K, then V
  const uint32_t res_bar = base + T::kBarOffset;
  const uint32_t full_bar = res_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kRing;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest first
  const int p0 = q_offset + q0;                  // q0's position
  const int hk = h / (H / Hkv);
  const int q_last = q_offset + min(q0 + kRows, Sq) - 1;   // a position
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / BS * BS : 0;
  const int n_tiles = (q_last - k_begin) / BS + 1;
  const int n_chunks = (D + 63) / 64;
  const int wg = threadIdx.x / 128;

  bwd_setup<DW, BS>(tiles, res_bar, n_chunks, 1);

  if (wg == kWarpgroups) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kWarpgroups * 128) {
      mbar_expect_tx(res_bar, 2 * n_chunks * T::kResChunk);
      for (int c = 0; c < n_chunks; ++c) {
        tma_load(sq + c * T::kResChunk, &q_map, res_bar, 64 * c, h, q0, b);
        tma_load(sdo + c * T::kResChunk, &do_map, res_bar, 64 * c, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kRing;
        if (t >= kRing) mbar_wait(empty_bar + 8 * s, (t / kRing - 1) & 1);
        const uint32_t full = full_bar + 8 * s;
        const uint32_t ks = ring + s * 2 * T::kStrTile;
        const int k0 = k_begin + t * BS;
        mbar_expect_tx(full, 2 * n_chunks * T::kStrChunk);
        for (int c = 0; c < n_chunks; ++c) {
          tma_load(ks + c * T::kStrChunk, &k_map, full, 64 * c, hk, k0, b);
          tma_load(ks + T::kStrTile + c * T::kStrChunk, &v_map, full, 64 * c,
                   hk, k0, b);
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
    const uint32_t a_off = 64 * wg * kChunkRow;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r - q_offset;
      const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
      lse_r[r] = row < Sq ? lse[at] : 0.f;
      delta_r[r] = row < Sq ? delta[at] : 0.f;
    }

    float dq[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dq[i] = 0.f;

    mbar_wait(res_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kRing;
      const int k0 = k_begin + t * BS;
      const uint32_t ks = ring + s * 2 * T::kStrTile;
      const uint32_t vs = ks + T::kStrTile;
      mbar_wait(full_bar + 8 * s, (t / kRing) & 1);
      const bool live = k0 <= wg_hi && (window == 0 || k0 + BS > wg_lo - window + 1);
      if (live) {
        float sc[BS / 2], dp[BS / 2];
        scores<E, DW, BS>(sc, dp, sq + a_off, sdo + a_off, ks, vs);
        const bool edge = k0 + BS - 1 > wg_lo || k0 + BS > Skv ||
                          (window > 0 && wg_hi - k0 >= window);
#pragma unroll
        for (int i = 0; i < BS / 2; ++i) {
          const int r = (i / 2) % 2;
          bool ok = true;
          if (edge) {
            const int qpos = row0 + 8 * r;
            const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            ok = kpos <= qpos && kpos < Skv;
            if (window > 0) ok = ok && qpos - kpos < window;
          }
          p_ds(sc[i], dp[i], ok, lse_r[r], delta_r[r], scale, softcap);
        }
        uint32_t d_hi[BS / 16][4], d_lo[BS / 16][4];
        split<E, BS>(dp, d_hi, d_lo);

        pin(dq);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BS / 16; ++j) {
          // keys 16j..16j+15 of every chunk of K (MN-major)
          const uint64_t kd = sw128_desc(ks + 16 * j * kChunkRow,
                                         T::kStrChunk, 1024);
          wgmma_rs<DW, E>(dq, d_hi[j], kd);
          wgmma_rs<DW, E>(dq, d_lo[j], kd);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(dq);
        pin(d_hi);
        pin(d_lo);
      }
      mbar_arrive(empty_bar + 8 * s);
    }

    // epilogue: this warpgroup's rows of the Q tile are free (its last
    // wgmma has completed); dQ times the scale, rounded once, goes there in
    // the TMA box's swizzled layout
    uint8_t* const q_ptr = tiles + a_off;
#pragma unroll
    for (int i = 0; i < DW / 2; i += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int unit = ((col % 64) / 8) ^ (row % 8);
      float unused0, unused1;
      *reinterpret_cast<uint32_t*>(
          q_ptr + (col / 64) * T::kResChunk + row * kChunkRow + unit * 16 +
          (col % 8) * 2) =
          pack2<E>(dq[i] * scale, dq[i + 1] * scale, unused0, unused1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int wg_row = q0 + 64 * wg;                // its first row
    if (tid == 0 && wg_row < Sq) {
      for (int c = 0; c < n_chunks; ++c)
        tma_store(&dq_map, sq + a_off + c * T::kResChunk, 64 * c, h, wg_row,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------- host
struct Maps {
  CUtensorMap q, k, v, dout, dq;
};

// the tensor maps of both kernels: boxes of q_rows rows for q and dO,
// kv_rows for k and v (a kernel's resident tensors take kRows, its
// streamed ones BS), 64 rows for dq (the dQ kernel's store, when dq is
// given)
template <typename E>
bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, const void* dq, int B, int Sq, int Skv,
               int H, int Hkv, int D, int q_rows, int kv_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return make_map(&m->q, encode, type, q, D, H, Sq, B, q_rows) &&
         make_map(&m->dout, encode, type, dout, D, H, Sq, B, q_rows) &&
         make_map(&m->k, encode, type, k, D, Hkv, Skv, B, kv_rows) &&
         make_map(&m->v, encode, type, v, D, Hkv, Skv, B, kv_rows) &&
         (dq == nullptr ||
          make_map(&m->dq, encode, type, dq, D, H, Sq, B, 64));
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Sq, Skv, q_offset, H, Hkv, D, window;
  float softcap, scale;
};

template <typename E, int DW>
cudaError_t dkdv(const Args& a, float* part, cudaStream_t st) {
  constexpr int BS = stream_rows<DW, true>();
  constexpr int smem = BwdTiles<DW, BS>::kSmem;
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      opt_in(flash_bwd_dkdv_wgmma_kernel<E, DW, BS>, smem, configured);
  if (err != cudaSuccess) return err;
  Maps m;
  if (!make_maps<E>(&m, a.q, a.k, a.v, a.dout, nullptr, a.B, a.Sq, a.Skv,
                    a.H, a.Hkv, a.D, BS, kRows))
    return cudaErrorInvalidValue;
  const dim3 grid(a.H * (DW / dkdv_cols<DW>()), a.B,
                  (a.Skv + kRows - 1) / kRows);
  flash_bwd_dkdv_wgmma_kernel<E, DW, BS><<<grid, kBwdThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, a.lse, a.delta, part, a.Sq, a.Skv, a.q_offset,
      a.H, a.Hkv, a.D, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename E, int DW>
cudaError_t dq(const Args& a, void* dqp, cudaStream_t st) {
  constexpr int BS = stream_rows<DW, false>();
  constexpr int smem = BwdTiles<DW, BS>::kSmem;
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      opt_in(flash_bwd_dq_wgmma_kernel<E, DW, BS>, smem, configured);
  if (err != cudaSuccess) return err;
  Maps m;
  if (!make_maps<E>(&m, a.q, a.k, a.v, a.dout, dqp, a.B, a.Sq, a.Skv, a.H,
                    a.Hkv, a.D, kRows, BS))
    return cudaErrorInvalidValue;
  const dim3 grid(a.H, a.B, (a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_wgmma_kernel<E, DW, BS><<<grid, kBwdThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, m.dq, a.lse, a.delta, a.Sq, a.Skv, a.q_offset,
      a.H, a.Hkv, a.D, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

// the narrowest instance that holds D, in E
template <typename E>
cudaError_t dispatch(bool dkdv_kernel, const Args& a, void* out,
                     cudaStream_t st) {
  float* part = static_cast<float*>(out);
  if (a.D <= 64)
    return dkdv_kernel ? dkdv<E, 64>(a, part, st) : dq<E, 64>(a, out, st);
  if (a.D <= 128)
    return dkdv_kernel ? dkdv<E, 128>(a, part, st) : dq<E, 128>(a, out, st);
  return dkdv_kernel ? dkdv<E, 256>(a, part, st) : dq<E, 256>(a, out, st);
}

int launch(bool dkdv_kernel, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* out,
           int B, int Sq, int Skv, int q_offset, int H, int Hkv, int D,
           int window, float softcap, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      q_offset > Skv - Sq || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || window < 0 || B > 65535 ||
      (Sq + kRows - 1) / kRows > 65535 || (Skv + kRows - 1) / kRows > 65535 ||
      H > 0x3fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Sq, Skv, q_offset, H,
               Hkv, D, window, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = dispatch<__nv_bfloat16>(dkdv_kernel, a, out, st);
  else if (dtype == 2)
    err = dispatch<__half>(dkdv_kernel, a, out, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (the forward's codes); D % 8 == 0 and
// D <= 256. q/dout (B, Sq, H, D), k/v (B, Skv, Hkv, D), contiguous and
// 16-byte aligned; lse and delta (B, H, Sq) float32 (flash_attention's lse
// and flash_bwd_dot_launch's delta); query row i at position q_offset + i,
// q_offset + Sq <= Skv. part (2 B Skv H D floats) receives each q head's
// share of dK, then of dV, which flash_bwd_dkdv_sum_launch adds into dk and
// dv: the arguments of flash_bwd_dkdv_launch.
extern "C" int flash_bwd_dkdv_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* part, int B, int Sq, int Skv,
    int q_offset, int H, int Hkv, int D, int window, float softcap,
    float scale, int dtype, void* stream) {
  return launch(true, q, k, v, dout, lse, delta, part, B, Sq, Skv, q_offset,
                H, Hkv, D, window, softcap, scale, dtype, stream);
}

// the same arguments as flash_bwd_dkdv_wgmma_launch; dq (B, Sq, H, D) out,
// 16-byte aligned
extern "C" int flash_bwd_dq_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dqp, int B, int Sq, int Skv,
    int q_offset, int H, int Hkv, int D, int window, float softcap,
    float scale, int dtype, void* stream) {
  return launch(false, q, k, v, dout, lse, delta, dqp, B, Sq, Skv, q_offset,
                H, Hkv, D, window, softcap, scale, dtype, stream);
}
