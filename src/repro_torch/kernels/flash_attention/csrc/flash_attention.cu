// Causal GQA flash attention (online softmax) on the float32 FMA units,
// optional sliding window and tanh softcap, float32, bfloat16 or float16 in
// and out, float32 accumulators, any head dim D >= 1. It serves what the
// tensor-core kernel (flash_attention_sm90.cu) does not: float32 at every
// D, and bfloat16/float16 at D % 8 != 0 or D > 256.
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
// (B*Sq*2*H + 2*B*Skv*Hkv)*D elements moved, far above the card's
// flops-per-byte line. In float32 (TF32 would not hold the reference's
// bound) the ceiling is the FMA units, 67 TFLOP/s, so the design is a
// register-tiled product in the manner of a SIMT GEMM: the first version of
// this kernel fed one FMA per shared-memory load and reached under a fifth
// of that ceiling. What bounds it in practice is the shared-memory pipe: a
// warp's 16-byte shared load occupies it for four cycles whether its lanes
// read 512 distinct bytes or broadcast a few, so the micro-tiles are sized
// by FMAs per 16-byte load.
//
// Design: one CTA per (64 q rows, q head, batch), q blocks launched
// heaviest first (the last causal block has the most key tiles); the TPU's
// sequential kv grid axis is a loop over tiles of 64 keys inside the CTA,
// and blocks share no state. Thread (ty, tx) = (tid / 16, tid % 16).
//   * staging: the products always run on float32 operands in shared
//     memory. Q is scaled by `scale` as it is staged; rows past Sq, keys
//     past Skv and columns past D are staged as zeros. A thread moves 4
//     columns of a row at a time (one 16- or 8-byte load where D % 4 == 0
//     and the pointers allow it), all its loads of a tile in flight
//     together, converting 16-bit inputs to float32.
//   * scores: a register micro-tile per thread, each score one FMA chain
//     over d in column order from 0 (the chain the first version of this
//     kernel ran).
//   * softmax: across the 16 threads that share a row, by xor shuffles,
//     with the TPU kernel's constants and order: softcap
//     tanh(s / cap) * cap before the mask, masked scores -1e30, running
//     max floored at -1e29, l = l * alpha + sum(p) (each thread sums its 4
//     keys in order, then the butterfly), the denominator floored at
//     1e-30. The mask is applied only on tiles that cut the diagonal, the
//     window edge or Skv.
//   * P V: p goes through shared memory (key-major); each thread owns an
//     R x 4G tile of the output (its rows, columns 4 tx + 64 g .. + 3, g <
//     G), summing over keys in order onto acc * alpha.
//   * logsumexp: where the caller passes an lse pointer, each row's
//     m + log(max(l, 1e-30)) goes there beside the output (the backward
//     recomputes p = exp(s - lse) from it); a null pointer stores nothing
//     else and leaves the output's arithmetic as it was.
//   * tiles wholly in the causal future of the block, or wholly before
//     every row's window, are skipped: such a tile would add p = 0 and
//     leave alpha at 1 (or 0 for a row that has seen nothing), so skipping
//     is exact. Rows of an offset launch therefore equal the same rows of a
//     full launch bit for bit when the offset is a multiple of 64 (the same
//     tiles in the same order; a tile that only the longer launch runs is
//     wholly in those rows' causal future and adds exactly 0).
// Instances. D <= 64 and 64 < D <= 128 run the "narrow" kernel (DW = 64 or
// 128 columns wide; 128 threads, two CTAs an SM): thread (ty, tx) owns
// rows ty + 8 i (i < 8) and, in the scores, keys tx + 16 j (j < 4): an
// 8 x 4 micro-tile, eight 16-byte loads of Q and four of K feeding 128
// FMAs a 4-column step; P V 8 x 4G (DW = 128: 64 FMAs per four loads).
// Q stays d-major in shared memory for the whole block, the output
// accumulator in registers. K is row-major with rows DW + 4 floats apart,
// so 16 consecutive keys' 16-byte reads at one column hit distinct banks,
// and P's 16-byte quads are swizzled by the key, so 16 consecutive keys'
// writes do too. Float32 K and V (D % 4 == 0, aligned rows) arrive by
// cp.async, 16 bytes a copy, each read while the other is in use: the next
// tile's K during this tile's softmax and P V, the next V during the next
// scores. 16-bit (and unaligned) ones are converted through registers
// when their tile starts. D > 128 runs the "wide" kernel (256 threads, one
// CTA an SM): rows 4 ty + i, keys 4 tx + j (4 x 4 micro-tiles); the scores
// are computed ONCE per key tile over all of D, Q and K staged in
// 64-column chunks (kDC) whose products continue the same FMA chains; the
// output accumulator stays in registers, 4 rows x 4G columns a thread (G =
// ceil(D / 64) column groups of 64, instances G = 4, 5 and 6), and the
// tile's V is staged whole where the Q/K chunks were. One CTA holds at
// most kMaxOut = 384 output columns; a larger D splits its output columns
// over grid axis x (the one case that computes the scores once per 384
// output columns).
// GQA: q head h reads kv head h / G, never a repeated copy. Any Sq and Skv
// are accepted (rows and keys are bounds-checked). Inputs are read in the
// model layout (B, S, H, D) directly, so no transpose precedes the launch.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../flash_tiles.cuh"

namespace {

constexpr int kBQ = 64;                        // q rows per CTA
constexpr int kBK = 64;                        // keys per tile
constexpr int kDC = 64;                        // wide: Q/K columns a chunk
constexpr int kMaxOut = 384;                   // wide: output columns a CTA

// Wide kernel's scores: s[i][j] += sum over d < n of qs[d][4 ty + i] *
// ks[d][4 tx + j] (both d-major, 64 wide), one FMA chain per score in
// column order: two 16-byte loads feed 16 FMAs.
__device__ __forceinline__ void qk_wide(float (&s)[4][4], const float* qs,
                                        const float* ks, int n, int tx,
                                        int ty) {
  const float* qp = qs + 4 * ty;
  const float* kp = ks + 4 * tx;
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(qp + d * 64);
    const float4 b = *reinterpret_cast<const float4*>(kp + d * 64);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Narrow kernel's scores: rows ty + 8 i against keys tx + 16 j, Q d-major
// in row slots, K row-major KS apart; per 4 columns, eight 16-byte loads of
// Q and four of K feed 128 FMAs, each score one FMA chain over d in column
// order. n4 = ceil(D / 4) (the columns past D are zeros).
template <int KS>
__device__ __forceinline__ void qk_narrow(float (&s)[8][4], const float* qs,
                                          const float* ks, int n4, int tx,
                                          int ty) {
  const float* qp = qs + 8 * ty;
  const float* kp = ks + tx * KS;
  for (int d4 = 0; d4 < n4; ++d4) {
    float kv[4][4], qv[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(kp + 16 * j * KS + 4 * d4);
      kv[j][0] = b.x; kv[j][1] = b.y; kv[j][2] = b.z; kv[j][3] = b.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(qp + (4 * d4 + e) * 64);
      const float4 a1 =
          *reinterpret_cast<const float4*>(qp + (4 * d4 + e) * 64 + 4);
      qv[e][0] = a0.x; qv[e][1] = a0.y; qv[e][2] = a0.z; qv[e][3] = a0.w;
      qv[e][4] = a1.x; qv[e][5] = a1.y; qv[e][6] = a1.z; qv[e][7] = a1.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qv[e][i], kv[j][e], s[i][j]);
  }
}

// Where p of (key, row slot c, c % 4 == 0) lies in ps: key-major, 64 wide.
// STRIDED (narrow) swizzles the 16-byte quads by the key's low bits, so the
// 16 threads of a row group, writing 16 consecutive keys, hit distinct
// banks; a P V read of one key still finds a thread's 8 slots in two quads.
template <bool STRIDED>
__device__ __forceinline__ int p_index(int key, int c) {
  return key * 64 + (STRIDED ? 4 * ((c / 4) ^ (key & 15)) : c);
}

// The online softmax of one tile: softcap, mask (on an edge tile), the
// running max and sum of each of the thread's R rows (the 16 threads of a
// row reduce by xor shuffles within their half-warp); p into ps
// (key-major, 64 wide, the thread's rows side by side at R ty), alpha of
// each row returned. STRIDED (narrow): rows ty + 8 i, keys tx + 16 j; else
// rows R ty + i, keys 4 tx + j.
template <int R, bool STRIDED>
__device__ __forceinline__ void softmax_tile(
    float (&s)[R][4], float (&m)[R], float (&l)[R], float (&alpha)[R],
    float* ps, int k0, int p0, int Skv, int window, float softcap,
    bool edge, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = p0 + (STRIDED ? ty + 8 * i : R * ty + i);
    float mx = kMasked;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if (edge) {
        const int kpos = k0 + (STRIDED ? tx + 16 * j : 4 * tx + j);
        bool ok = kpos <= qpos && kpos < Skv;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        x = ok ? x : kMasked;
      }
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(fmaxf(m[i], mx), kMaxFloor);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m_new);
      sum += s[i][j];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    l[i] = l[i] * alpha[i] + sum;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      const int key = STRIDED ? tx + 16 * j : 4 * tx + j;
      *reinterpret_cast<float4*>(ps + p_index<STRIDED>(key, R * ty + 4 * h)) =
          make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                      s[4 * h + 3][j]);
    }
}

// o[i][4 g + e] += sum over keys of ps[key][R ty + i] * vs[key][4 tx + 64 g
// + e], keys in order (vs row-major, LD wide): R / 4 + G 16-byte loads
// feed 4 R G FMAs
template <int R, int G, int LD, bool STRIDED>
__device__ __forceinline__ void pv(float (&o)[R][4 * G], const float* ps,
                                   const float* vs, int tx, int ty) {
  const float* vp = vs + 4 * tx;
#pragma unroll 4
  for (int key = 0; key < kBK; ++key) {
    float pr[R];
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          ps + p_index<STRIDED>(key, R * ty + 4 * h));
      pr[4 * h] = p4.x; pr[4 * h + 1] = p4.y; pr[4 * h + 2] = p4.z;
      pr[4 * h + 3] = p4.w;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v4 =
          *reinterpret_cast<const float4*>(vp + key * LD + 64 * g);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[i][4 * g + e] = fmaf(pr[i], vv[e], o[i][4 * g + e]);
    }
  }
}

// o / max(l, 1e-30) into columns c0 + 4 tx + 64 g + e (< D) of the
// thread's rows below Sq (STRIDED: rows ty + 8 i; else R ty + i); where
// lse_row (the head's row 0 of the (B, H, Sq) logsumexp) is given, the
// threads at tx = 0 of the block at c0 = 0 also write each row's
// m + log(max(l, 1e-30)), the natural-log base the running max m is kept in
template <typename T, int R, int G, bool STRIDED>
__device__ __forceinline__ void store_rows(T* o_base,
                                           const float (&o)[R][4 * G],
                                           const float (&m)[R],
                                           const float (&l)[R],
                                           float* lse_row, int q0,
                                           int Sq, int H, int h, int D,
                                           int c0, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + (STRIDED ? ty + 8 * i : R * ty + i);
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], kDenomFloor);
    if (lse_row != nullptr && tx == 0 && c0 == 0)
      lse_row[s] = m[i] + logf(denom);
    T* orow = o_base + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * tx + 64 * g + e;
        if (c < D) store(orow + c, o[i][4 * g + e] / denom);
      }
  }
}

// whether any (row, key) pair of the tile is masked: it cuts the
// diagonal, Skv or a window edge
__device__ __forceinline__ bool edge_tile(int k0, int p0, int Skv,
                                          int window) {
  return k0 + kBK - 1 > p0 || k0 + kBK > Skv ||
         (window > 0 && p0 + kBQ - 1 - k0 >= window);
}

struct Params {
  int Sq, Skv, q_offset, H, Hkv, D, window;
  float softcap, scale;
  int vec;   // 4-element loads: D % 4 == 0 and the pointers aligned
  float* lse;   // (B, H, Sq) logsumexp of the scores, or null
};

// head h of batch row b's logsumexp row, or null when none is asked for
__device__ __forceinline__ float* lse_row(const Params& a, int b, int h) {
  return a.lse == nullptr
             ? nullptr
             : a.lse + (static_cast<size_t>(b) * a.H + h) * a.Sq;
}

// ------------------------------------------------------------- narrow
// 128 threads; thread (ty, tx) owns rows ty + 8 i (i < 8): scores in 8 x 4
// micro-tiles against keys tx + 16 j (32 FMAs per three 16-byte loads), P V
// in 8 x 4G (DW = 128: 64 FMAs per four loads). Q stays d-major in row
// slots; K is row-major with rows DW + 4 apart, so the 16-byte reads of 16
// consecutive keys at one column hit distinct banks; V row-major.
constexpr int kNarrowThreads = 128;

template <int DW>
struct Narrow {
  static constexpr int kKStride = DW + 4;
  static constexpr int kQ = DW * 64, kK = 64 * kKStride, kV = 64 * DW;
  // two CTAs an SM: 115,712 bytes each at DW = 128
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kQ) + kK + kV + size_t(kBK) * kBQ);
};

// ASYNC (float32 with 16-byte aligned rows, D % 4 == 0): K and V arrive by
// cp.async, each read while the other is in use: the next tile's K during
// this tile's softmax and P V, the next V during the next scores; two
// commit groups in flight. Else each tile converts K and V through
// registers when it starts.
template <typename T, int DW, bool ASYNC>
__global__ void __launch_bounds__(kNarrowThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const Params a) {
  using N = Narrow<DW>;
  constexpr int R = 8;
  constexpr int G = DW / 64;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + N::kQ;
  float* vs = ks + N::kK;
  float* ps = vs + N::kV;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = a.vec != 0;
  const T* qb = q + static_cast<size_t>(b) * a.Sq * a.H * a.D;
  const T* kb = k + static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;
  const T* vb = v + static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;

  {
    Staged<T, DW, kDMajorSlots, 0, kNarrowThreads> qn;
    qn.load(qb, q0, a.Sq, a.H, h, a.D, 0, vec);
    qn.put(qs, a.scale);
  }

  float m[R], l[R], acc[R][4 * G];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }
  const int p0 = a.q_offset + q0;                              // a position
  const int q_last = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  const int k_begin =
      a.window > 0 ? max(0, p0 - a.window + 1) / kBK * kBK : 0;
  const int n4 = (a.D + 3) / 4;
  const float* kf = reinterpret_cast<const float*>(kb);
  const float* vf = reinterpret_cast<const float*>(vb);

  if constexpr (ASYNC) {
    stage_async<DW, N::kKStride, kNarrowThreads>(ks, kf, k_begin, a.Skv,
                                                 a.Hkv, hk, a.D);
    cp_async_commit();
    stage_async<DW, DW, kNarrowThreads>(vs, vf, k_begin, a.Skv, a.Hkv, hk,
                                        a.D);
    cp_async_commit();
  }
  for (int k0 = k_begin; k0 <= q_last; k0 += kBK) {
    const bool next = k0 + kBK <= q_last;
    if constexpr (ASYNC) {
      cp_async_wait<1>();   // this tile's K (its V may be in flight)
    } else {   // K, then V: both in flight at once would spill registers
      {
        Staged<T, DW, kRowMajor, N::kKStride, kNarrowThreads> kn;
        kn.load(kb, k0, a.Skv, a.Hkv, hk, a.D, 0, vec);
        __syncthreads();   // Q staged / the previous tile fully read
        kn.put(ks, 1.f);
      }
      Staged<T, DW, kRowMajor, DW, kNarrowThreads> vn;
      vn.load(vb, k0, a.Skv, a.Hkv, hk, a.D, 0, vec);
      vn.put(vs, 1.f);
    }
    __syncthreads();
    float s[R][4] = {};
    qk_narrow<N::kKStride>(s, qs, ks, n4, tx, ty);
    if constexpr (ASYNC) {
      __syncthreads();   // every thread's scores read K
      if (next)
        stage_async<DW, N::kKStride, kNarrowThreads>(ks, kf, k0 + kBK, a.Skv,
                                                     a.Hkv, hk, a.D);
      cp_async_commit();
    }
    float alpha[R];
    softmax_tile<R, true>(s, m, l, alpha, ps, k0, p0, a.Skv, a.window,
                          a.softcap, edge_tile(k0, p0, a.Skv, a.window), tx,
                          ty);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha[i];
    if constexpr (ASYNC) cp_async_wait<1>();   // this tile's V
    __syncthreads();   // P complete (and V)
    pv<R, G, DW, true>(acc, ps, vs, tx, ty);
    if constexpr (ASYNC) {
      __syncthreads();   // every thread's P V read V and P
      if (next)
        stage_async<DW, DW, kNarrowThreads>(vs, vf, k0 + kBK, a.Skv, a.Hkv,
                                            hk, a.D);
      cp_async_commit();
    }
  }
  store_rows<T, R, G, true>(o + static_cast<size_t>(b) * a.Sq * a.H * a.D,
                            acc, m, l, lse_row(a, b, h), q0, a.Sq, a.H, h,
                            a.D, 0, tx, ty);
}

// --------------------------------------------------------------- wide
// 256 threads over 64 q rows, 4 rows each: scores 4 x 4 against keys 4 tx +
// j; the output accumulator in registers, 4 x 4G (columns 4 tx + 64 g, g <
// G, G = ceil(D / 64) <= 6: up to 96 floats a thread), P V reading one
// 16-byte load of p and G of V per 16 G FMAs. One CTA an SM.
constexpr int kWideThreads = 256;
constexpr int kWideRows = 4;

// shared memory of G column groups: Q and K chunks (kDC x 64 each,
// d-major), whose place the tile's V (64 x 64 G row-major) takes; P (64 x
// 64)
template <int G>
constexpr size_t wide_smem() {
  return sizeof(float) * ((2 * kDC * 64 > kBK * 64 * G ? 2 * kDC * 64
                                                       : kBK * 64 * G) +
                          size_t(kBK) * kBQ);
}

template <typename T, int G>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_attention_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            const Params a) {
  constexpr int R = kWideRows;
  constexpr int kRegion =
      2 * kDC * 64 > kBK * 64 * G ? 2 * kDC * 64 : kBK * 64 * G;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kDC x 64, d-major
  float* ks = qs + kDC * 64;        // kDC x 64, d-major
  float* vs = smem;                 // 64 x 64 G row-major, over qs and ks
  float* ps = smem + kRegion;       // 64 keys x 64 rows

  const int n_groups = (a.D + kMaxOut - 1) / kMaxOut;
  const int h = blockIdx.x / n_groups;
  const int c_lo = (blockIdx.x - h * n_groups) * kMaxOut;  // output columns
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = a.vec != 0;
  const T* qb = q + static_cast<size_t>(b) * a.Sq * a.H * a.D;
  const T* kb = k + static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;
  const T* vb = v + static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;

  float m[R], l[R], acc[R][4 * G];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }
  const int p0 = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  const int k_begin =
      a.window > 0 ? max(0, p0 - a.window + 1) / kBK * kBK : 0;

  for (int k0 = k_begin; k0 <= q_last; k0 += kBK) {
    // the scores, once, over all of D in chunks of kDC columns
    float s[R][4] = {};
    for (int dc = 0; dc < a.D; dc += kDC) {
      {
        Staged<T, kDC, kDMajor, 0, kWideThreads> qn, kn;
        qn.load(qb, q0, a.Sq, a.H, h, a.D, dc, vec);
        kn.load(kb, k0, a.Skv, a.Hkv, hk, a.D, dc, vec);
        __syncthreads();   // the previous chunk or tile fully read
        qn.put(qs, a.scale);
        kn.put(ks, 1.f);
      }
      __syncthreads();
      qk_wide(s, qs, ks, min(kDC, a.D - dc), tx, ty);
    }
    float alpha[R];
    softmax_tile<R, false>(s, m, l, alpha, ps, k0, p0, a.Skv, a.window,
                           a.softcap, edge_tile(k0, p0, a.Skv, a.window), tx,
                           ty);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha[i];
    {   // in two halves of 32 G columns: all of V at once would spill
      Staged<T, 32 * G, kRowMajor, 64 * G, kWideThreads> vn;
      vn.load(vb, k0, a.Skv, a.Hkv, hk, a.D, c_lo, vec);
      __syncthreads();   // P complete; Q and K read
      vn.put(vs, 1.f);
      vn.load(vb, k0, a.Skv, a.Hkv, hk, a.D, c_lo + 32 * G, vec);
      vn.put(vs + 32 * G, 1.f);
    }
    __syncthreads();
    pv<R, G, 64 * G, false>(acc, ps, vs, tx, ty);
  }
  store_rows<T, R, G, false>(o + static_cast<size_t>(b) * a.Sq * a.H * a.D,
                             acc, m, l, lse_row(a, b, h), q0, a.Sq, a.H, h,
                             a.D, c_lo, tx, ty);
}

template <typename T, int DW, bool ASYNC>
cudaError_t narrow(dim3 grid, const T* q, const T* k, const T* v, T* o,
                   const Params& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in(flash_attention_kernel<T, DW, ASYNC>,
                                 Narrow<DW>::kSmem, configured);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, DW, ASYNC>
      <<<grid, kNarrowThreads, Narrow<DW>::kSmem, stream>>>(q, k, v, o, a);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t wide(dim3 grid, const T* q, const T* k, const T* v, T* o,
                 const Params& a, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in(flash_attention_kernel_wide<T, G>,
                                 wide_smem<G>(), configured);
  if (err != cudaSuccess) return err;
  flash_attention_kernel_wide<T, G>
      <<<grid, kWideThreads, wide_smem<G>(), stream>>>(q, k, v, o, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, Params a, cudaStream_t stream) {
  a.vec = a.D % 4 == 0 && aligned4<T>(q) && aligned4<T>(k) &&
          aligned4<T>(v);
  const int n_q = (a.Sq + kBQ - 1) / kBQ;
  if (B > 65535 || n_q > 65535) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (a.D <= 128) {
    const dim3 grid(a.H, B, n_q);
    if constexpr (std::is_same<T, float>::value) {
      if (a.vec)
        return a.D <= 64
                   ? narrow<T, 64, true>(grid, qt, kt, vt, ot, a, stream)
                   : narrow<T, 128, true>(grid, qt, kt, vt, ot, a, stream);
    }
    return a.D <= 64 ? narrow<T, 64, false>(grid, qt, kt, vt, ot, a, stream)
                     : narrow<T, 128, false>(grid, qt, kt, vt, ot, a, stream);
  }
  const long long blocks_x =
      static_cast<long long>(a.H) * ((a.D + kMaxOut - 1) / kMaxOut);
  if (blocks_x > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_x), B, n_q);
  // the narrowest accumulator that holds a CTA's output columns
  const int cols = a.D < kMaxOut ? a.D : kMaxOut;
  if (cols <= 256) return wide<T, 4>(grid, qt, kt, vt, ot, a, stream);
  if (cols <= 320) return wide<T, 5>(grid, qt, kt, vt, ot, a, stream);
  return wide<T, 6>(grid, qt, kt, vt, ot, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q/o (B, Sq, H, D), k/v
// (B, Skv, Hkv, D), contiguous, D >= 1; query row i at position
// q_offset + i, q_offset + Sq <= Skv. lse: a float32 (B, H, Sq) output for
// each row's logsumexp of its scores (the backward's input), or null.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq, int Skv, int q_offset,
                                      int H, int Hkv, int D, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      q_offset > Skv - Sq || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params a{Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, 0,
                 static_cast<float*>(lse)};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, B, a, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, B, a, st);
  else if (dtype == 2)
    err = dispatch<__half>(q, k, v, o, B, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
