// Gradient of causal GQA flash attention (optional sliding window and tanh
// softcap) on the float32 FMA units: float32, bfloat16 or float16 in and
// out, float32 arithmetic, any head dim D >= 1. Four launches, no float
// atomics anywhere, so two calls on the same inputs give the same bits:
//   (a) flash_bwd_dot_kernel: delta_i = sum_d dO_id O_id per (b, h, row),
//       float32, one warp a row (xor-shuffle sum in a fixed order);
//   (b) flash_bwd_dkdv_kernel: one CTA per (b, q head, 64-key block, group
//       of output columns): the q head's share of dK and dV at its keys,
//       summed over every q block that sees those keys, written in float32
//       to a (B, Skv, H, D) partial of each (a CTA a q head, not a kv head:
//       recurrentgemma-2b's one kv head would give 128 CTAs, under one wave
//       of the card);
//   (b') flash_bwd_dkdv_sum_kernel: dK and dV, each the sum of its kv
//       head's G partials in head order, rounded once;
//   (c) flash_bwd_dq_kernel: one CTA per (b, q head, 64-row block, group of
//       output columns): dQ of its rows over the key blocks they see.
// Both (b) and (c) recompute, per (64 rows, 64 keys) tile, S = scale Q K^T
// (the tanh softcap before the mask, as the forward), P = exp(S - lse) from
// the forward's logsumexp (flash_attention's lse output), dP = dO V^T and
// dS = P (dP - delta) (1 - (S / cap)^2 under a softcap); then (b) adds
// dV += P^T dO and dK += dS^T (scale Q), (c) adds dQ += dS K and scales it
// once at the end. Accumulators are float32, rounded once to the input
// type, as autograd through the plain version rounds.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention/kernel.py has
// no backward, and the reference trains through
// src/repro/models/layers.py's blockwise_attention, which JAX
// differentiates with its score chunks recomputed (jax.checkpoint), so its
// residuals stay O(chunk). This is that gradient without an (S, S) buffer:
// the port's backward before it held the float32 (B, H, Sq, Skv) scores of
// a layer, 2 GB a tensor at qwen3-0.6b's training microbatch.
//
// Query offset: q, dO and dQ are (B, Sq, H, D), k, v, dK, dV (B, Skv, Hkv,
// D); query row i sits at position q_offset + i, keys at 0..Skv-1, with
// q_offset + Sq <= Skv, as in the forward. Keys no row sees get dK = dV =
// 0.
//
// Bound on Hopper: operations. The recompute and the four products do
// 2.5 times the forward's causal FLOPs (S and dP are two QK^T-sized
// products, dV, dK and dQ three PV-sized ones, against the forward's two)
// on ~(4 B Sq H + 4 B Skv Hkv) D elements moved. The card's peak for them
// is the tensor cores' in bfloat16 and float16 (989 TFLOP/s dense) and the
// FMA units' in float32 (67 TFLOP/s); this design runs on the FMA units at
// every dtype, so 67 TFLOP/s is its own ceiling.
//
// Design (the scalar forward's, flash_attention.cu, shared through
// flash_tiles.cuh): 256 threads, (ty, tx) = (tid / 16, tid % 16).
//   * staging: every product runs on float32 operands in shared memory,
//     staged in 64-column chunks (any D) as the wide forward stages Q and
//     K: a chunk of Q (times `scale`), K, dO and V, 64 rows each,
//     row-major 68 floats apart (16 consecutive rows' 16-byte reads at one
//     column hit distinct banks). The output-side operands (Q and dO in
//     (b), K in (c)) are also kept whole for the CTA's group of DW = 64 G
//     output columns (G = 1 for D <= 64, else 2; a larger D splits its
//     columns over grid axis x and recomputes S and dP per group).
//   * S and dP: a 4 x 4 register micro-tile per thread, rows ty + 16 i and
//     keys tx + 16 j, each one FMA chain over d in column order from 0;
//     per four columns eight 16-byte loads feed 64 FMAs.
//   * P and dS go through shared memory: (b) row-major (rows 80 floats
//     apart, so a warp's two rows fall on distinct banks), (c) key-major.
//   * dV, dK ((b): keys 4 ty + i, columns 4 tx + 64 g + e) and dQ ((c):
//     rows 4 ty + i) are register tiles of 4 x 4G, summed over rows ((b))
//     or keys ((c)) in order; per row one 16-byte load of P (dS) and G of
//     dO (Q) feed 16 G FMAs.
//   * (b) launches key block 0 first (it is seen by the most q blocks), (c)
//     the last q block first, as the forward.
// Tensor cores (P and dS in 16 bits or split hi/lo, as the wgmma forward
// splits p) are a later redesign.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../flash_tiles.cuh"

namespace {

constexpr int kB = 64;                  // rows of a q tile, keys of a k tile
constexpr int kC = 64;                  // columns of a staged chunk
constexpr int kThreads = 256;
constexpr int kLC = kC + 4;             // a staged chunk's row stride
constexpr int kLP = kB + 16;            // (b): P and dS, rows apart
constexpr int kLT = kB + 4;             // (c): dS^T, keys apart
constexpr int kDotRows = 8;             // (a): rows (warps) a block

struct BwdParams {
  int Sq, Skv, q_offset, H, Hkv, D, window;
  float softcap, scale;
  int vec;     // 4-element loads: D % 4 == 0 and every pointer aligned
};

// a 64-row x 64-column chunk on its way into shared memory (row-major)
template <typename T>
using Chunk = Staged<T, kC, kRowMajor, kLC, kThreads>;

// s[i][j] += sum over the chunk's n4 column quads of a[ty + 16 i][d] *
// b[tx + 16 j][d] (both row-major, kLC apart), each score one FMA chain
// in column order
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int n4, int tx,
                                         int ty) {
  const float* ap = a + ty * kLC;
  const float* bp = b + tx * kLC;
  for (int d4 = 0; d4 < n4; ++d4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(ap + 16 * i * kLC + 4 * d4);
      av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
      const float4 y =
          *reinterpret_cast<const float4*>(bp + 16 * i * kLC + 4 * d4);
      bv[i][0] = y.x; bv[i][1] = y.y; bv[i][2] = y.z; bv[i][3] = y.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
  }
}

// The tile's P and dS from its scores s and dp (rows ty + 16 i of the tile
// at row r0, keys tx + 16 j of the tile at key k0), in place: s becomes p,
// dp becomes ds. lse and delta hold the tile's 64 rows.
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         const float* lse, const float* delta,
                                         int r0, int k0, const BwdParams& a,
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    const int qpos = a.q_offset + row;
    const float l = lse[ty + 16 * i], dl = delta[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      float x = s[i][j], dcap = 1.f;
      if (a.softcap > 0.f) {
        const float t = tanhf(x / a.softcap);
        x = t * a.softcap;
        dcap = 1.f - t * t;
      }
      bool ok = row < a.Sq && kpos < a.Skv && kpos <= qpos;
      if (a.window > 0) ok = ok && qpos - kpos < a.window;
      const float p = ok ? expf(x - l) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl) * dcap;
    }
  }
}

// rows row0 .. row0 + 63 of head hd's (B, H, Sq) float32 row into sh (zeros
// past Sq)
__device__ __forceinline__ void stage_rows(float* sh, const float* src,
                                           int row0, int Sq) {
  if (threadIdx.x < kB) {
    const int r = row0 + threadIdx.x;
    sh[threadIdx.x] = r < Sq ? src[r] : 0.f;
  }
}

// the 4 x 4G register tile (rows 4 ty + i, columns c_lo + 4 tx + 64 g + e)
// times mul into a (., heads, D) tensor at head hd, rows below n_rows and
// columns below D
template <typename T, int G>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[4][4 * G],
                                           int row0, int n_rows, int heads,
                                           int hd, int D, int c_lo, float mul,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= n_rows) continue;
    T* row = dst + (static_cast<size_t>(r) * heads + hd) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c_lo + 4 * tx + 64 * g + e;
        if (c < D) store(row + c, acc[i][4 * g + e] * mul);
      }
  }
}

// acc[i][4 g + e] += sum over 64 rows n of w[n][4 ty + i] * x[n][4 tx + 64 g
// + e], n in order (w LW apart, x LX apart)
template <int G, int LW, int LX>
__device__ __forceinline__ void add_tile(float (&acc)[4][4 * G],
                                         const float* w, const float* x,
                                         int tx, int ty) {
#pragma unroll 4
  for (int n = 0; n < kB; ++n) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + n * LW + 4 * ty);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 x4 =
          *reinterpret_cast<const float4*>(x + n * LX + 4 * tx + 64 * g);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * g + e] = fmaf(wv[i], xv[e], acc[i][4 * g + e]);
    }
  }
}

// shared memory, in floats
template <int G>
struct DkdvSmem {
  static constexpr int kLR = 64 * G + 4;   // resident Q and dO, rows apart
  static constexpr int kChunks = 4 * kB * kLC;
  static constexpr int kResident = 2 * kB * kLR;
  static constexpr size_t kBytes =
      sizeof(float) * (size_t(kChunks) + kResident + 2 * kB * kLP + 2 * kB);
};
template <int G>
struct DqSmem {
  static constexpr int kLR = 64 * G + 4;   // resident K, rows apart
  static constexpr size_t kBytes =
      sizeof(float) *
      (size_t(4) * kB * kLC + kB * kLR + kB * kLT + 2 * kB);
};

// --------------------------------------------------------------- (a)
template <typename T>
__global__ void __launch_bounds__(kDotRows * 32)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int Sq,
                     int H, int D) {
  const long long n = static_cast<long long>(blockIdx.x) * kDotRows +
                      threadIdx.x / 32;
  if (n >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* op = o + n * D;
  const T* dp = dout + n * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32)
    sum = fmaf(to_f32(dp[c]), to_f32(op[c]), sum);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
  if (lane == 0) {
    // row n of the (B, Sq, H) rows is (b, s, h); delta is (B, H, Sq)
    const long long b = n / (static_cast<long long>(Sq) * H);
    const int s = static_cast<int>((n / H) % Sq);
    const int h = static_cast<int>(n % H);
    delta[(b * H + h) * Sq + s] = sum;
  }
}

// --------------------------------------------------------------- (b)
// Grid axis x: (q head, column group). The CTA writes its q head's float32
// share of dK to part's first (B, Skv, H, D) half and of dV to its second.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ part, const BwdParams a) {
  using M = DkdvSmem<G>;
  constexpr int DW = 64 * G;
  extern __shared__ __align__(16) float smem[];
  float* qc = smem;                     // chunks: Q (scaled), K, dO, V
  float* kc = qc + kB * kLC;
  float* oc = kc + kB * kLC;
  float* vc = oc + kB * kLC;
  float* qr = smem + M::kChunks;        // Q (scaled) and dO at the group's
  float* orr = qr + kB * M::kLR;        // columns
  float* ps = qr + M::kResident;        // P and dS, row-major
  float* dss = ps + kB * kLP;
  float* lse_s = dss + kB * kLP;
  float* delta_s = lse_s + kB;

  const int n_groups = (a.D + DW - 1) / DW;
  const int hq = blockIdx.x / n_groups;
  const int c_lo = (blockIdx.x - hq * n_groups) * DW;
  const int hk = hq / (a.H / a.Hkv);
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = a.vec != 0;
  const size_t q_base = static_cast<size_t>(b) * a.Sq * a.H * a.D;
  const size_t k_base = static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;

  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the rows that see keys k0 .. k_last: positions k0 .. k_last + window - 1
  const int k_last = min(k0 + kB, a.Skv) - 1;
  const int r_first = max(0, k0 - a.q_offset) / kB * kB;
  const int r_end = a.window > 0
                        ? min(a.Sq, k_last + a.window - a.q_offset)
                        : a.Sq;
  const size_t row_base = (static_cast<size_t>(b) * a.H + hq) * a.Sq;
  for (int r0 = r_first; r0 < r_end; r0 += kB) {
    stage_rows(lse_s, lse + row_base, r0, a.Sq);
    stage_rows(delta_s, delta + row_base, r0, a.Sq);
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < a.D; dc += kC) {
      Chunk<T> qn, kn, on, vn;
      qn.load(q + q_base, r0, a.Sq, a.H, hq, a.D, dc, vec);
      kn.load(k + k_base, k0, a.Skv, a.Hkv, hk, a.D, dc, vec);
      on.load(dout + q_base, r0, a.Sq, a.H, hq, a.D, dc, vec);
      vn.load(v + k_base, k0, a.Skv, a.Hkv, hk, a.D, dc, vec);
      __syncthreads();   // the previous chunk, P, dS and resident read
      qn.put(qc, a.scale);
      kn.put(kc, 1.f);
      on.put(oc, 1.f);
      vn.put(vc, 1.f);
      if (dc >= c_lo && dc < c_lo + DW) {
        qn.template put<M::kLR>(qr + (dc - c_lo), a.scale);
        on.template put<M::kLR>(orr + (dc - c_lo), 1.f);
      }
      __syncthreads();
      const int n4 = (min(kC, a.D - dc) + 3) / 4;
      dot_tile(s, qc, kc, n4, tx, ty);
      dot_tile(dp, oc, vc, n4, tx, ty);
    }
    p_and_ds(s, dp, lse_s, delta_s, r0, k0, a, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = s[i][j];
        dss[(ty + 16 * i) * kLP + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    add_tile<G, kLP, M::kLR>(acc_v, ps, orr, tx, ty);
    add_tile<G, kLP, M::kLR>(acc_k, dss, qr, tx, ty);
  }
  const size_t n = static_cast<size_t>(gridDim.y) * a.Skv * a.H * a.D;
  float* pk = part + static_cast<size_t>(b) * a.Skv * a.H * a.D;
  store_tile<float, G>(pk, acc_k, k0, a.Skv, a.H, hq, a.D, c_lo, 1.f, tx,
                       ty);
  store_tile<float, G>(pk + n, acc_v, k0, a.Skv, a.H, hq, a.D, c_lo, 1.f, tx,
                       ty);
}

// (b') dK and dV (n = B Skv Hkv D elements each) from the dK/dV kernel's
// partials: element i of kv head hk adds q heads G hk .. G hk + G - 1 in
// order and rounds once. One thread an element.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                          T* __restrict__ dv, long long n, int G, int D) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  // row (b, key, hk) of dk is rows (b, key, G hk + g) of a partial
  const float* pk = part + i / D * G * D + i % D;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < G; ++g) {
    sk += pk[g * D];
    sv += pk[G * n + g * D];
  }
  store(dk + i, sk);
  store(dv + i, sv);
}

// --------------------------------------------------------------- (c)
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const BwdParams a) {
  using M = DqSmem<G>;
  constexpr int DW = 64 * G;
  extern __shared__ __align__(16) float smem[];
  float* qc = smem;                     // chunks: Q (scaled), K, dO, V
  float* kc = qc + kB * kLC;
  float* oc = kc + kB * kLC;
  float* vc = oc + kB * kLC;
  float* kr = vc + kB * kLC;            // K at the group's columns
  float* dst = kr + kB * M::kLR;        // dS, key-major
  float* lse_s = dst + kB * kLT;
  float* delta_s = lse_s + kB;

  const int n_groups = (a.D + DW - 1) / DW;
  const int h = blockIdx.x / n_groups;
  const int c_lo = (blockIdx.x - h * n_groups) * DW;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kB;   // heaviest first
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = a.vec != 0;
  const size_t q_base = static_cast<size_t>(b) * a.Sq * a.H * a.D;
  const size_t k_base = static_cast<size_t>(b) * a.Skv * a.Hkv * a.D;
  const size_t row_base = (static_cast<size_t>(b) * a.H + h) * a.Sq;

  stage_rows(lse_s, lse + row_base, r0, a.Sq);
  stage_rows(delta_s, delta + row_base, r0, a.Sq);
  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;

  const int p0 = a.q_offset + r0;                              // a position
  const int q_last = a.q_offset + min(r0 + kB, a.Sq) - 1;
  const int k_begin =
      a.window > 0 ? max(0, p0 - a.window + 1) / kB * kB : 0;
  for (int k0 = k_begin; k0 <= q_last; k0 += kB) {
    float s[4][4] = {}, dp[4][4] = {};
    for (int dc = 0; dc < a.D; dc += kC) {
      Chunk<T> qn, kn, on, vn;
      qn.load(q + q_base, r0, a.Sq, a.H, h, a.D, dc, vec);
      kn.load(k + k_base, k0, a.Skv, a.Hkv, hk, a.D, dc, vec);
      on.load(dout + q_base, r0, a.Sq, a.H, h, a.D, dc, vec);
      vn.load(v + k_base, k0, a.Skv, a.Hkv, hk, a.D, dc, vec);
      __syncthreads();   // the previous chunk, dS and resident K read
      qn.put(qc, a.scale);
      kn.put(kc, 1.f);
      on.put(oc, 1.f);
      vn.put(vc, 1.f);
      if (dc >= c_lo && dc < c_lo + DW)
        kn.template put<M::kLR>(kr + (dc - c_lo), 1.f);
      __syncthreads();
      const int n4 = (min(kC, a.D - dc) + 3) / 4;
      dot_tile(s, qc, kc, n4, tx, ty);
      dot_tile(dp, oc, vc, n4, tx, ty);
    }
    p_and_ds(s, dp, lse_s, delta_s, r0, k0, a, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(tx + 16 * j) * kLT + ty + 16 * i] = dp[i][j];
    __syncthreads();
    add_tile<G, kLT, M::kLR>(acc, dst, kr, tx, ty);
  }
  store_tile<T, G>(dq + q_base, acc, r0, a.Sq, a.H, h, a.D, c_lo, a.scale,
                   tx, ty);
}

// ---------------------------------------------------------------- host
template <typename T>
cudaError_t dot(const void* o, const void* dout, float* delta, int B,
                int Sq, int H, int D, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long blocks = (rows + kDotRows - 1) / kDotRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), kDotRows * 32, 0,
                            st>>>(static_cast<const T*>(o),
                                  static_cast<const T*>(dout), delta, rows,
                                  Sq, H, D);
  return cudaGetLastError();
}

// grid axis x: heads x column groups of 64 G
inline bool groups_fit(long long heads, int D, int G) {
  const long long x = heads * ((D + 64 * G - 1) / (64 * G));
  return x <= 0x7fffffffLL;
}

template <typename T, int G>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* part, int B, const BwdParams& a, cudaStream_t st) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in(flash_bwd_dkdv_kernel<T, G>,
                                 DkdvSmem<G>::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_groups = (a.D + 64 * G - 1) / (64 * G);
  const dim3 grid(a.H * n_groups, B, (a.Skv + kB - 1) / kB);
  flash_bwd_dkdv_kernel<T, G><<<grid, kThreads, DkdvSmem<G>::kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      part, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkdv_sum(const float* part, void* dk, void* dv, long long n,
                     int G, int D, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkdv_sum_kernel<T><<<static_cast<unsigned>(blocks), 256, 0,
                                 st>>>(part, static_cast<T*>(dk),
                                       static_cast<T*>(dv), n, G, D);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dqp, int B,
               const BwdParams& a, cudaStream_t st) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t err =
      opt_in(flash_bwd_dq_kernel<T, G>, DqSmem<G>::kBytes, configured);
  if (err != cudaSuccess) return err;
  const int n_groups = (a.D + 64 * G - 1) / (64 * G);
  const dim3 grid(a.H * n_groups, B, (a.Sq + kB - 1) / kB);
  flash_bwd_dq_kernel<T, G><<<grid, kThreads, DqSmem<G>::kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqp), a);
  return cudaGetLastError();
}

template <typename T, int N>
bool all_aligned(const void* const (&ps)[N]) {
  for (const void* p : ps)
    if (!aligned4<T>(p)) return false;
  return true;
}

// the parameters both kernels take, or false where the shapes are refused
bool params(BwdParams* a, int B, int Sq, int Skv, int q_offset, int H,
            int Hkv, int D, int window, float softcap, float scale) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      q_offset > Skv - Sq || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      window < 0 || B > 65535 || (Sq + kB - 1) / kB > 65535 ||
      (Skv + kB - 1) / kB > 65535 || !groups_fit(H, D, D <= 64 ? 1 : 2))
    return false;
  *a = BwdParams{Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale, 0};
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the forward's codes).
// o/dout (B, Sq, H, D) contiguous; delta (B, H, Sq) float32 out.
extern "C" int flash_bwd_dot_launch(const void* o, const void* dout,
                                    void* delta, int B, int Sq, int H, int D,
                                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = dot<float>(o, dout, d, B, Sq, H, D, st);
  else if (dtype == 1)
    err = dot<__nv_bfloat16>(o, dout, d, B, Sq, H, D, st);
  else if (dtype == 2)
    err = dot<__half>(o, dout, d, B, Sq, H, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// q/dout (B, Sq, H, D), k/v (B, Skv, Hkv, D), contiguous; lse and delta
// (B, H, Sq) float32 (flash_attention's lse and the dot launch's delta);
// query row i at position q_offset + i, q_offset + Sq <= Skv. part (2 B
// Skv H D floats) receives each q head's share of dK, then of dV, which
// flash_bwd_dkdv_sum_launch adds into dk and dv.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* part, int B, int Sq, int Skv,
                                     int q_offset, int H, int Hkv, int D,
                                     int window, float softcap, float scale,
                                     int dtype, void* stream) {
  BwdParams a;
  if (!params(&a, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  float* pt = static_cast<float*>(part);
  const void* const ptrs[4] = {q, k, v, dout};
  cudaError_t err;
  if (dtype == 0) {
    a.vec = D % 4 == 0 && all_aligned<float>(ptrs);
    err = D <= 64 ? dkdv<float, 1>(q, k, v, dout, l, d, pt, B, a, st)
                  : dkdv<float, 2>(q, k, v, dout, l, d, pt, B, a, st);
  } else if (dtype == 1) {
    a.vec = D % 4 == 0 && all_aligned<__nv_bfloat16>(ptrs);
    err = D <= 64
              ? dkdv<__nv_bfloat16, 1>(q, k, v, dout, l, d, pt, B, a, st)
              : dkdv<__nv_bfloat16, 2>(q, k, v, dout, l, d, pt, B, a, st);
  } else if (dtype == 2) {
    a.vec = D % 4 == 0 && all_aligned<__half>(ptrs);
    err = D <= 64 ? dkdv<__half, 1>(q, k, v, dout, l, d, pt, B, a, st)
                  : dkdv<__half, 2>(q, k, v, dout, l, d, pt, B, a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dk/dv (n = B Skv Hkv D elements each, the dkdv launch's dtype) from its
// partials part (2 G n floats, G = H / Hkv)
extern "C" int flash_bwd_dkdv_sum_launch(const void* part, void* dk,
                                         void* dv, long long n, int G, int D,
                                         int dtype, void* stream) {
  if (n <= 0 || G <= 0 || D <= 0 || n % D != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(part);
  cudaError_t err;
  if (dtype == 0)
    err = dkdv_sum<float>(p, dk, dv, n, G, D, st);
  else if (dtype == 1)
    err = dkdv_sum<__nv_bfloat16>(p, dk, dv, n, G, D, st);
  else if (dtype == 2)
    err = dkdv_sum<__half>(p, dk, dv, n, G, D, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the same arguments as flash_bwd_dkdv_launch; dq (B, Sq, H, D) out
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dqp, int B, int Sq, int Skv,
                                   int q_offset, int H, int Hkv, int D,
                                   int window, float softcap, float scale,
                                   int dtype, void* stream) {
  BwdParams a;
  if (!params(&a, B, Sq, Skv, q_offset, H, Hkv, D, window, softcap, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  const void* const ptrs[5] = {q, k, v, dout, dqp};
  cudaError_t err;
  if (dtype == 0) {
    a.vec = D % 4 == 0 && all_aligned<float>(ptrs);
    err = D <= 64 ? dq<float, 1>(q, k, v, dout, l, d, dqp, B, a, st)
                  : dq<float, 2>(q, k, v, dout, l, d, dqp, B, a, st);
  } else if (dtype == 1) {
    a.vec = D % 4 == 0 && all_aligned<__nv_bfloat16>(ptrs);
    err = D <= 64 ? dq<__nv_bfloat16, 1>(q, k, v, dout, l, d, dqp, B, a, st)
                  : dq<__nv_bfloat16, 2>(q, k, v, dout, l, d, dqp, B, a, st);
  } else if (dtype == 2) {
    a.vec = D % 4 == 0 && all_aligned<__half>(ptrs);
    err = D <= 64 ? dq<__half, 1>(q, k, v, dout, l, d, dqp, B, a, st)
                  : dq<__half, 2>(q, k, v, dout, l, d, dqp, B, a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
