// Gradient of causal GQA flash attention (optional sliding window and tanh
// softcap) in float32 on Hopper's tensor cores, every product taken in
// TF32 from the operands' big and small halves. float32 in and out at any
// head dim D up to 128, and bfloat16 and float16 at the head dims the
// 16-bit instance (flash_attention_bwd_sm90.cu) does not take (D % 8 !=
// 0), whose values are exact in TF32; on the narrowest of two instances, DW
// = 64 or 128 columns wide, that holds D. Three of the gradient's four
// launches; the fourth, (b') the sum of dK/dV shares, is
// flash_attention_bwd.cu's:
//   (a) flash_bwd_split_tf32_kernel: delta_i = sum_d dO_id O_id per (b, h,
//       row) (flash_bwd_dot_kernel's order, so its bits), and Q, dO, K and
//       V as two TF32 halves each, big = tf32(x) and small = tf32(x - big),
//       rounded by cvt.rna, in the model layout padded to DW columns with
//       zeros; K also transposed (a (B, Hkv, DW, Skv') plane a half, Skv'
//       = Skv rounded up to 32, zeros past Skv), and at DW = 64 Q and dO too;
//   (b) flash_bwd_dkdv_tf32_kernel: one CTA per (b, q head, 64-key block):
//       the q head's share of dK and dV at its keys, written in float32 to
//       the (B, Skv, H, D) partial of each, which (b') adds over a kv
//       head's q heads in head order;
//   (c) flash_bwd_dq_tf32_kernel: one CTA per (b, q head, 64-row block): dQ
//       of its rows over the key tiles they see.
// Every sum is taken in a fixed order and every output element has one
// writer, so two calls on the same inputs give the same bits.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention/kernel.py has no
// backward, and the reference trains through src/repro/models/layers.py's
// blockwise_attention, which JAX differentiates in float32. This is the
// tensor-core redesign of flash_attention_bwd.cu's FMA kernels for float32;
// those stay for the head dims above 128.
//
// Query offset: q, dO and dQ are (B, Sq, H, D), k, v (B, Skv, Hkv, D); query
// row i sits at position q_offset + i, keys at 0..Skv-1, with
// q_offset + Sq <= Skv, as in the forward. Keys no row sees get dK = dV = 0.
//
// Bound on Hopper: operations. The recompute and the four products do 2.5
// times the forward's causal FLOPs, 10 D per scored (row, key) pair, at the
// TF32 tensor cores' 495 TFLOP/s (dense) for a float32 case, the 16-bit
// peak for a 16-bit one. At three TF32 products a product the design's
// ceiling is 3 x 10 D a pair at 495. This design recomputes S and dP in
// both kernels, as the 16-bit instance does, and takes them as four
// products: 4 x 4 D + 3 x 6 D = 34 D a pair. But its pace is set by
// shared memory, not by the tensor cores: wgmma reads both operands of an
// ss product from shared memory (128 bytes a clock an SM), and at the 16-
// and 32-row tiles that 4-byte halves leave room for, an m64nNk8 ss
// product needs 2 KB of A and 32 N bytes of B for its 512 N MACs (1024 a
// clock at the TF32 peak): more bytes than a clock brings below N = 64.
//
// Numbers: x = big + small + e with |e| <= 2^-22 |x| (TF32 keeps 10
// fraction bits, so |x - big| <= 2^-11 |x| and the small half rounds that
// difference again). dV, dK and dQ take a b as big_a big_b + big_a small_b
// + small_a big_b (~3 2^-22 |a b| a term); S and dP as all four products
// (the small small one too, 2 2^-22), each product exact in float32, into
// float32 accumulators: far inside float32's per-sum gamma(D + 2) ~ 2^-17
// at D = 128. ref.backward_error_bound(split="tf32") carries it. An
// operand left unrounded would be truncated by the tensor cores (2^-10).
//
// Design: the 16-bit instance's (flash_attention_bwd_sm90.cu) at a quarter
// of the rows a tile, since every operand takes 4 bytes and two halves in
// shared memory:
//   * A CTA keeps 64 resident rows (one wgmma M: the dK/dV kernel's keys of
//     K and V, the dQ kernel's rows of Q and dO), both halves, and streams
//     tiles of BS rows (32 at DW = 64, 16 at DW = 128) of the other two
//     tensors through a ring of 2 stages, every tile a TMA box of 32
//     columns (128 bytes) with the 128-byte swizzle. A stage holds each
//     streamed tensor as pairs, [big; small] rows a chunk, so that one ss
//     wgmma of 2 BS columns takes A's big half times both of B's, and a
//     second A's small half: S (or S^T) and dP (or dP^T) in two wgmma a
//     k-step, whose two column halves are added once at the end (a third
//     of the shared-memory reads of three BS-column products).
//   * wgmma takes 32-bit A and B K-major only, so the products that
//     contract over rows (dV += P^T dO, dK += dS^T Q, dQ += dS K) read
//     transposed tiles, DW rows of BS positions with the BS * 4-byte
//     swizzle (64 bytes at BS = 16): the dQ kernel's K^T, and at DW = 64
//     the dK/dV kernel's Q^T and dO^T, are split-pass planes that TMA loads
//     beside the stage; at DW = 128 the dK/dV kernel has no room for them
//     (two 32 KB stages beside 128 KB of resident K and V), so once its ss
//     products are done each warpgroup rewrites its stage's Q and dO pairs
//     in place, transposed, and fences them for the tensor cores (64 KB
//     of shared-memory traffic a tile, against the second output-column
//     group's recompute of S^T and dP^T that the columns would cost
//     otherwise).
//   * P and dS stay in the accumulator fragment as the A operand of those
//     products. A TF32 A fragment holds k = t and t + 4 (t = lane % 4) where
//     the accumulator holds columns 2t and 2t + 1 of each 8, so the
//     transposed tiles hold each 8 positions in the order 0 2 4 6 1 3 5 7
//     (perm_row), and the registers go to the tensor cores unshuffled.
//   * Shared memory (232,448 bytes a block): 4 resident planes of 64 x DW
//     floats (131,072 bytes at DW = 128), 2 stages (4 streamed planes of
//     BS x DW: 32,768 bytes; the dQ kernel's K^T adds 16,384, the dK/dV
//     kernel's Q^T and dO^T at DW = 64 32,768), each stage's lse and delta
//     rows, the barriers and 1 KB of alignment: at DW = 128 197,928 bytes
//     (dK/dV) and 230,696 (dQ); at DW = 64 198,184 and 165,416.
//   * Two consumer warpgroups share the resident tiles and take the
//     streamed tiles in turn (tile t to warpgroup t % 2, which owns stage t
//     % 2), each with its own accumulators, so one's exp, splits and
//     transposes run beside the other's products; at the end warpgroup 1
//     hands its sums to warpgroup 0 through the ring's shared memory, which
//     adds them (its own first) and writes. The dK/dV kernel's two 64 x DW
//     accumulators need a producer warpgroup and setmaxnreg (232 registers
//     a consumer thread, 40 a producer's, the 16-bit instance's split); the
//     dQ kernel runs with a producer warp (288 threads). The scale
//     multiplies dK and dQ once, in float32.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "../../flash_tiles.cuh"
#include "../../sm90.cuh"

namespace {

constexpr int kRes = 64;                      // resident rows a CTA
constexpr int kConsumers = 2;                 // warpgroups, in turns
constexpr int kStages = 2;                    // stage s feeds warpgroup s
// the dK/dV kernel: the consumers and a producer warpgroup (setmaxnreg:
// 232 registers a consumer thread, 40 a producer thread); the dQ kernel:
// the consumers and a producer warp, 168 registers a thread
constexpr int kDkdvThreads = (kConsumers + 1) * 128;
constexpr int kDqThreads = kConsumers * 128 + 32;
constexpr int kChunkCols = 32;                // a 128-byte swizzled chunk
constexpr int kSplitRows = 32;                // rows a split block, and the
                                              // transposed plane's padding

// streamed rows a stage: 32 at DW = 64, 16 at DW = 128
template <int DW>
__host__ __device__ constexpr int tf32_rows() {
  return DW == 64 ? 32 : 16;
}

// whether the dK/dV kernel transposes its streamed Q and dO in shared
// memory (DW = 128) or streams the split pass's Q^T and dO^T (DW = 64,
// where its 32-row tiles leave room for them)
template <int DW>
__host__ __device__ constexpr bool dkdv_in_place() {
  return DW == 128;
}

// the row of an 8 that position p of a transposed tile's 8 holds: positions
// 0 .. 7 hold rows 0 2 4 6 1 3 5 7
__host__ __device__ constexpr int perm_row(int p) { return 2 * (p % 4) + p / 4; }

// ------------------------------------------------------------------ (a)
// Block: 32 rows of one head of q and dO (blockIdx.x < q_tiles H) or of k
// and v (the rest), batch row blockIdx.y. Planes (floats): qn (2, 2, B, Sq,
// H, DW) [q, dO][big, small]; kn (2, 2, B, Skv, Hkv, DW) [k, v][big,
// small]; kt (2, B, Hkv, DW, Skv') [big, small], K transposed (the dQ
// kernel's row-contracting product reads it as it stands), and where qt is
// given, qt (2, 2, B, H, DW, Sq') [q, dO][big, small], likewise for the
// dK/dV kernel.
template <typename T, int DW>
__global__ void __launch_bounds__(256)
flash_bwd_split_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta, float* __restrict__ qn,
                            float* __restrict__ kn, float* __restrict__ kt,
                            float* __restrict__ qt, int Sq, int Skv, int H,
                            int Hkv, int D) {
  __shared__ float tile[2][kSplitRows][DW + 1];    // big, small
  const int B = gridDim.y, b = blockIdx.y;
  const int q_tiles = (Sq + kSplitRows - 1) / kSplitRows;
  const bool q_side = blockIdx.x < q_tiles * H;
  const int S = q_side ? Sq : Skv, heads = q_side ? H : Hkv;
  const int tiles = (S + kSplitRows - 1) / kSplitRows;
  const int idx = q_side ? blockIdx.x : blockIdx.x - q_tiles * H;
  const int h = idx / tiles, s0 = (idx % tiles) * kSplitRows;
  const int Sp = tiles * kSplitRows;
  const size_t nat = static_cast<size_t>(B) * S * heads * DW;   // a plane

  if (q_side) {
    // delta of the block's rows, a warp a row, as flash_bwd_dot_kernel
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kSplitRows && s0 + r < Sq; r += 8) {
      const size_t row = (static_cast<size_t>(b) * Sq + s0 + r) * H + h;
      const T* op = o + row * D;
      const T* dp = dout + row * D;
      float sum = 0.f;
      for (int c = lane; c < D; c += 32)
        sum = fmaf(to_f32(dp[c]), to_f32(op[c]), sum);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
      if (lane == 0)
        delta[(static_cast<size_t>(b) * H + h) * Sq + s0 + r] = sum;
    }
  }
  for (int x = 0; x < 2; ++x) {
    const T* src = q_side ? (x ? dout : q) : (x ? v : k);
    float* const nbig = (q_side ? qn : kn) + 2 * x * nat;
    const bool trans = q_side ? qt != nullptr : x == 0;   // no V^T
    for (int i = threadIdx.x; i < kSplitRows * DW; i += 256) {
      const int r = i / DW, c = i % DW, s = s0 + r;
      const float val =
          s < S && c < D
              ? to_f32(src[((static_cast<size_t>(b) * S + s) * heads + h) *
                               D + c])
              : 0.f;
      const float big = __uint_as_float(tf32_rna(val));
      const float small = __uint_as_float(tf32_rna(val - big));
      if (s < S) {
        const size_t at = ((static_cast<size_t>(b) * S + s) * heads + h) *
                              DW + c;
        nbig[at] = big;
        nbig[nat + at] = small;
      }
      if (trans) {
        tile[0][r][c] = big;
        tile[1][r][c] = small;
      }
    }
    if (trans) {
      __syncthreads();
      const size_t tr = static_cast<size_t>(B) * heads * DW * Sp;
      for (int i = threadIdx.x; i < DW * kSplitRows; i += 256) {
        const int c = i / kSplitRows, p = i % kSplitRows;
        const int r = (p & ~7) | perm_row(p & 7);
        const size_t at =
            ((static_cast<size_t>(b) * heads + h) * DW + c) * Sp + s0 + p;
        float* const t = q_side ? qt + 2 * x * tr : kt;
        t[at] = tile[0][r][c];
        t[tr + at] = tile[1][r][c];
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------- (b) and (c) pieces
// Shared memory: 4 resident planes (big and small of two tensors, 64 rows x
// DW: the dK/dV kernel's K and V, the dQ kernel's Q and dO), the ring of
// kStages stages, each stage's lse and delta rows (the dK/dV kernel's),
// the barriers: resident, kStages full, kStages empty. A stage holds the
// streamed tiles of two tensors (Q and dO, or K and V) as pairs, DW / 32
// chunks of [big; small] rows, BS each, and kTr transposed planes of DW rows
// x BS (the dQ kernel's K^T, big and small; at DW = 64 the dK/dV kernel's
// Q^T and dO^T).
template <int DW, int BS, int kTr>
struct Tiles {
  static constexpr int kChunks = DW / kChunkCols;
  static constexpr int kResChunk = kRes * 128;          // bytes
  static constexpr int kResTile = kChunks * kResChunk;  // a plane
  static constexpr int kStrChunk = BS * 128;
  static constexpr int kStrTile = kChunks * kStrChunk;  // a streamed plane,
  static constexpr int kTrPlanes = kTr;                 // and a transposed
  static constexpr int kTrTile = DW * BS * 4;           // one: as many bytes
  static constexpr int kStage = 4 * kStrTile + kTr * kTrTile;
  static constexpr int kRingOffset = 4 * kResTile;
  static constexpr int kRowsOffset = kRingOffset + kStages * kStage;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * BS * 4;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "shared memory");
  // warpgroup 1's sums (two 64 x DW at most) go through the ring
  static_assert(2 * kRes * DW * 4 <= kStages * kStage, "hand-over");
  // natural plane p (tensor p / 2, big or small = p % 2), chunk c: in the
  // stage's pair of that tensor
  __host__ __device__ static constexpr int natural(int p, int c) {
    return (p / 2) * 2 * kStrTile + c * 2 * kStrChunk + (p % 2) * kStrChunk;
  }
};

// a kernel's maps: res (its resident planes, 64-row boxes), str (its
// streamed ones, BS-row boxes), each [x big, x small, y big, y small]; t
// (transposed planes, BS x DW boxes: the dQ kernel's K^T big and small, at
// DW = 64 the dK/dV kernel's Q^T and dO^T)
struct Maps {
  CUtensorMap res[4], str[4], t[4];
};

// the barriers' set-up: full barriers take `full_count` arrivals, empty
// ones a warpgroup's 128
__device__ __forceinline__ void ring_setup(uint32_t bars, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 + 8 * s, full_count);
      mbar_init(bars + 8 + 8 * kStages + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the resident planes, by one thread: 4 maps x DW / 32 chunks of 64 rows at
// (row0, head) into smem at base
template <class T>
__device__ __forceinline__ void load_resident(const Maps& maps, uint32_t base,
                                              uint32_t bar, int head,
                                              int row0, int b) {
  mbar_expect_tx(bar, 4 * T::kResTile);
  for (int p = 0; p < 4; ++p)
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(base + p * T::kResTile + c * T::kResChunk, &maps.res[p], bar,
               kChunkCols * c, head, row0, b);
}

// one streamed tile of BS rows at (row0, head) into stage st, by one thread,
// and the stage's transposed planes at (row0, column 0)
template <class T>
__device__ __forceinline__ void load_stage(const Maps& maps, uint32_t st,
                                           uint32_t bar, int head, int row0,
                                           int b) {
  mbar_expect_tx(bar, T::kStage);
  for (int p = 0; p < 4; ++p)
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(st + T::natural(p, c), &maps.str[p], bar, kChunkCols * c,
               head, row0, b);
  for (int p = 0; p < T::kTrPlanes; ++p)
    tma_load(st + 4 * T::kStrTile + p * T::kTrTile, &maps.t[p], bar, row0, 0,
             head, b);
}

// s = A1 B1^T, then dp = A2 B2^T over DW columns, each as the four TF32
// products of its operands' halves in two wgmma of 2 BS columns a k-step:
// A's big half times B's [big; small] rows, then A's small half times the
// same, into one accumulator whose column halves (A B_big and A B_small)
// are added once at the end. a1/a2 are the resident planes' big halves
// (small halves a_half bytes on), b1/b2 the stage's pairs: DW / 32 chunks
// of [big; small] rows (BS each, str_chunk bytes apart), 2 str_chunk
// apart; the resident chunks are res_chunk bytes apart
template <int DW, int BS>
__device__ __forceinline__ void scores4(float (&s)[BS / 2], float (&dp)[BS / 2],
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a_half, uint32_t b1,
                                        uint32_t b2, uint32_t res_chunk,
                                        uint32_t str_chunk) {
  float s2[BS], dp2[BS];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DW / 8; ++kk) {
    const uint32_t off = (kk / 4) * res_chunk + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * 2 * str_chunk + (kk % 4) * 32;
    wgmma_ss_tf32<2 * BS>(s2, kmajor_desc<128>(a1 + off, 1024),
                          kmajor_desc<128>(b1 + boff, 1024), kk > 0);
    wgmma_ss_tf32<2 * BS>(s2, kmajor_desc<128>(a1 + a_half + off, 1024),
                          kmajor_desc<128>(b1 + boff, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < DW / 8; ++kk) {
    const uint32_t off = (kk / 4) * res_chunk + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * 2 * str_chunk + (kk % 4) * 32;
    wgmma_ss_tf32<2 * BS>(dp2, kmajor_desc<128>(a2 + off, 1024),
                          kmajor_desc<128>(b2 + boff, 1024), kk > 0);
    wgmma_ss_tf32<2 * BS>(dp2, kmajor_desc<128>(a2 + a_half + off, 1024),
                          kmajor_desc<128>(b2 + boff, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(s2);
  pin(dp2);
  // column c + BS of the accumulator is register i + BS / 2 of column c's
#pragma unroll
  for (int i = 0; i < BS / 2; ++i) {
    s[i] = s2[i] + s2[i + BS / 2];
    dp[i] = dp2[i] + dp2[i + BS / 2];
  }
}

// the f32 accumulator fragment x (64 x BS) as the TF32 A fragments of its
// BS / 8 k-slices, big and small: slice j's registers 4j, 4j + 2, 4j + 1,
// 4j + 3 (columns 2t and 2t + 1 of rows g and g + 8) in the A order (k = t
// and t + 4), which the transposed tiles' order (perm_row) matches
template <int BS>
__device__ __forceinline__ void split_frag(const float (&x)[BS / 2],
                                           uint32_t (&big)[BS / 8][4],
                                           uint32_t (&small)[BS / 8][4]) {
#pragma unroll
  for (int j = 0; j < BS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = x[4 * j + (e % 2) * 2 + e / 2];
      big[j][e] = tf32_rna(v);
      small[j][e] = tf32_rna(v - __uint_as_float(big[j][e]));
    }
}

// d += A B over the fragments' BS / 8 k-slices, three passes a slice
// (small big, big small, big big): B's big half at b_big, its small half
// b_half bytes on, K-major rows of BS floats (8 rows sbo bytes apart)
template <int N, int BS>
__device__ __forceinline__ void product3(float (&d)[N / 2],
                                         const uint32_t (&big)[BS / 8][4],
                                         const uint32_t (&small)[BS / 8][4],
                                         uint32_t b_big, uint32_t b_half) {
  constexpr int kRow = BS * 4;            // bytes: the swizzle span
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) {
    const uint32_t at = b_big + 32 * j;
    wgmma_rs_tf32<N>(d, small[j], kmajor_desc<kRow>(at, 8 * kRow));
    wgmma_rs_tf32<N>(d, big[j], kmajor_desc<kRow>(at + b_half, 8 * kRow));
    wgmma_rs_tf32<N>(d, big[j], kmajor_desc<kRow>(at, 8 * kRow));
  }
}

// The stage's pair at `pair` (DW / 32 chunks of [big; small] rows, BS each,
// 128-byte rows with the 128-byte swizzle, as TMA wrote them) rewritten in
// place as two K-major B operands of a product over its rows, big then
// small, each DW rows of BS positions with the BS * 4-byte swizzle, each 8
// positions holding rows 0 2 4 6 1 3 5 7 of their 8 (perm_row). By the
// warpgroup's 128 threads (tid); `bar` is its named barrier.
template <int DW, int BS>
__device__ __forceinline__ void transpose_pair(uint8_t* pair, int tid,
                                               int bar) {
  constexpr int kN = BS * DW / 128;
  float x[2][kN];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + 128 * j;
      const int n = e / BS, p = e % BS;        // column n, position p
      const int r = (p & ~7) | perm_row(p % 8);
      x[h][j] = *reinterpret_cast<const float*>(
          pair + (n / kChunkCols) * 2 * (BS * 128) + h * (BS * 128) +
          r * 128 + ((((n % kChunkCols) / 4) ^ (r % 8)) * 16) + (n % 4) * 4);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + 128 * j;
      const int n = e / BS, p = e % BS;
      const int unit = BS == 32 ? (p / 4) ^ (n % 8) : (p / 4) ^ ((n / 2) % 4);
      *reinterpret_cast<float*>(pair + h * (BS * DW * 4) + n * (BS * 4) +
                                unit * 16 + (p % 4) * 4) = x[h][j];
    }
}

// warpgroup 1's sums x handed to warpgroup 0 through the ring (every
// stage's loads have landed and been read once both consumers have passed
// the first barrier); on warpgroup 0, x becomes its own plus those
template <int N>
__device__ __forceinline__ void hand_over(float (&x)[N], float* hand, int wg,
                                          int tid) {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) hand[i * 128 + tid] = x[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += hand[i * 128 + tid];
  }
}

// ------------------------------------------------------------------ (b)
// Accumulator fragment of wgmma m64nN (f32): register i of thread (warp w,
// lane) holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) +
// 2 (lane % 4) + i % 2; rows are keys here, columns the tile's q rows.
// maps.res: K and V (64 rows); maps.str: Q and dO (BS rows); at DW = 64
// maps.t: Q^T and dO^T.
template <int DW, int BS>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_tf32_kernel(const __grid_constant__ Maps maps,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ part, int Sq, int Skv,
                           int q_offset, int H, int Hkv, int D, int window,
                           float softcap, float scale) {
  constexpr bool kInPlace = dkdv_in_place<DW>();
  using T = Tiles<DW, BS, kInPlace ? 0 : 4>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const tiles = smem_raw + (base - raw);
  const uint32_t ring = base + T::kRingOffset;
  float* const rows = reinterpret_cast<float*>(tiles + T::kRowsOffset);
  const uint32_t res_bar = base + T::kBarOffset;
  const uint32_t full_bar = res_bar + 8;         // + 8 s
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kRes;              // key block 0 first
  const int hk = hq / (H / Hkv);
  // the rows that see keys k0 .. k_last: positions k0 .. k_last + window - 1
  const int k_last = min(k0 + kRes, Skv) - 1;
  const int r_first = max(0, k0 - q_offset) / BS * BS;
  const int r_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int n_tiles = r_end > r_first ? (r_end - r_first + BS - 1) / BS : 0;
  const int wg = threadIdx.x / 128;
  const size_t row_base = (static_cast<size_t>(b) * H + hq) * Sq;

  ring_setup(res_bar, 32);

  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - kConsumers * 128;
    if (pt < 32 && n_tiles > 0) {
      if (pt == 0) load_resident<T>(maps, base, res_bar, hk, k0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar + 8 * s, (t / kStages - 1) & 1);
        const int r0 = r_first + t * BS;
        // the tile's lse and delta rows, zeros past Sq
        float* const rs = rows + s * 2 * BS;
        for (int i = pt; i < BS; i += 32) {
          const bool in = r0 + i < Sq;
          rs[i] = in ? lse[row_base + r0 + i] : 0.f;
          rs[BS + i] = in ? delta[row_base + r0 + i] : 0.f;
        }
        const uint32_t full = full_bar + 8 * s;
        if (pt == 0)
          load_stage<T>(maps, ring + s * T::kStage, full, hq, r0, b);
        else
          mbar_arrive(full);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int key0 = k0 + 16 * warp + lane / 4;   // and key0 + 8
    const int bar = 2 + wg;                       // the warpgroup's barrier

    float dk[DW / 2], dv[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_tiles > 0) mbar_wait(res_bar, 0);
    for (int t = wg; t < n_tiles; t += kConsumers) {
      const int s = t % kStages;
      const int r0 = r_first + t * BS;
      const uint32_t st = ring + s * T::kStage;
      uint8_t* const stp = tiles + T::kRingOffset + s * T::kStage;
      const float* const rs = rows + s * 2 * BS;
      mbar_wait(full_bar + 8 * s, (t / kStages) & 1);
      const int pr_lo = q_offset + r0;       // the tile's first position
      const int pr_hi = pr_lo + BS - 1;
      const bool live = pr_hi >= k0 && (window == 0 || pr_lo - (k0 + kRes - 1) < window);
      if (live) {
        float sc[BS / 2], dp[BS / 2];
        scores4<DW, BS>(sc, dp, base, base + 2 * T::kResTile, T::kResTile,
                        st, st + 2 * T::kStrTile, T::kResChunk,
                        T::kStrChunk);
        if (kInPlace) {
          // Q's pair and dO's, transposed in place for dK and dV
          transpose_pair<DW, BS>(stp, tid, bar);
          transpose_pair<DW, BS>(stp + 2 * T::kStrTile, tid, bar);
        }
        const bool edge = pr_lo < k0 + kRes - 1 || r0 + BS > Sq ||
                          (window > 0 && pr_hi - k0 >= window);
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
          p_ds(sc[i], dp[i], ok, rs[col], rs[BS + col], scale, softcap);
        }
        uint32_t p_big[BS / 8][4], p_small[BS / 8][4];
        uint32_t d_big[BS / 8][4], d_small[BS / 8][4];
        split_frag<BS>(sc, p_big, p_small);
        split_frag<BS>(dp, d_big, d_small);
        if (kInPlace) {
          // the rewrites made visible to the tensor cores
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
        }
        // Q^T's and dO^T's planes, big then small (kStrTile == kTrTile)
        const uint32_t tq = kInPlace ? st : st + 4 * T::kStrTile;
        const uint32_t tdo = tq + 2 * T::kStrTile;

        pin(dk);
        pin(dv);
        wgmma_fence();
        product3<DW, BS>(dv, p_big, p_small, tdo, T::kStrTile);
        product3<DW, BS>(dk, d_big, d_small, tq, T::kStrTile);
        wgmma_commit();
        wgmma_wait_all();
        pin(dk);
        pin(dv);
        pin(p_big);
        pin(p_small);
        pin(d_big);
        pin(d_small);
      }
      mbar_arrive(empty_bar + 8 * s);
    }

    float* const hand = reinterpret_cast<float*>(tiles + T::kRingOffset);
    hand_over<DW / 2>(dk, hand, wg, tid);
    hand_over<DW / 2>(dv, hand, wg, tid);
    if (wg == 0) {
      // the q head's float32 shares: dK (times the scale) to part's first
      // (B, Skv, H, D) half, dV to its second
      const size_t n = static_cast<size_t>(gridDim.y) * Skv * H * D;
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) {
        const int key = key0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (key < Skv && col < D) {
          float* const pk =
              part + ((static_cast<size_t>(b) * Skv + key) * H + hq) * D +
              col;
          *pk = dk[i] * scale;
          pk[n] = dv[i];
        }
      }
    }
  }
}

// ------------------------------------------------------------------ (c)
// The fragment layout of (b), rows the CTA's q rows and columns the tile's
// keys. maps.res: Q and dO (64 rows); maps.str: K and V (BS rows); maps.t:
// K^T.
template <typename E, int DW, int BS>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ Maps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, E* __restrict__ dq,
                         int Sq, int Skv, int q_offset, int H, int Hkv, int D,
                         int window, float softcap, float scale) {
  using T = Tiles<DW, BS, 2>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const tiles = smem_raw + (base - raw);
  const uint32_t ring = base + T::kRingOffset;
  const uint32_t res_bar = base + T::kBarOffset;
  const uint32_t full_bar = res_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRes;    // heaviest first
  const int p0 = q_offset + q0;                  // q0's position
  const int hk = h / (H / Hkv);
  const int q_last = q_offset + min(q0 + kRes, Sq) - 1;   // a position
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / BS * BS : 0;
  const int n_tiles = (q_last - k_begin) / BS + 1;
  const int wg = threadIdx.x / 128;

  ring_setup(res_bar, 1);

  if (wg == kConsumers) {
    // ----------------------------------------------------- producer warp
    if (threadIdx.x == kConsumers * 128) {
      load_resident<T>(maps, base, res_bar, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar + 8 * s, (t / kStages - 1) & 1);
        load_stage<T>(maps, ring + s * T::kStage, full_bar + 8 * s, hk,
                      k_begin + t * BS, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = p0 + 16 * warp + lane / 4;  // and row0 + 8: positions
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r - q_offset;
      const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
      lse_r[r] = row < Sq ? lse[at] : 0.f;
      delta_r[r] = row < Sq ? delta[at] : 0.f;
    }

    float acc[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;

    mbar_wait(res_bar, 0);
    for (int t = wg; t < n_tiles; t += kConsumers) {
      const int s = t % kStages;
      const int k0 = k_begin + t * BS;
      const uint32_t st = ring + s * T::kStage;
      mbar_wait(full_bar + 8 * s, (t / kStages) & 1);
      const bool live = k0 <= p0 + kRes - 1 &&
                        (window == 0 || k0 + BS > p0 - window + 1);
      if (live) {
        float sc[BS / 2], dp[BS / 2];
        scores4<DW, BS>(sc, dp, base, base + 2 * T::kResTile, T::kResTile,
                        st, st + 2 * T::kStrTile, T::kResChunk,
                        T::kStrChunk);
        const bool edge = k0 + BS - 1 > p0 || k0 + BS > Skv ||
                          (window > 0 && p0 + kRes - 1 - k0 >= window);
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
        uint32_t d_big[BS / 8][4], d_small[BS / 8][4];
        split_frag<BS>(dp, d_big, d_small);

        pin(acc);
        wgmma_fence();
        product3<DW, BS>(acc, d_big, d_small, st + 4 * T::kStrTile,
                         T::kTrTile);
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(d_big);
        pin(d_small);
      }
      mbar_arrive(empty_bar + 8 * s);
    }

    hand_over<DW / 2>(acc, reinterpret_cast<float*>(tiles + T::kRingOffset),
                      wg, tid);
    if (wg == 0) {
      // dQ times the scale, rounded once to E
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) {
        const int row = row0 + 8 * ((i / 2) % 2) - q_offset;
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (row < Sq && col < D)
          store(dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * D + col,
                acc[i] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------- host
// a float32 (B, S, heads, DW) split plane as (DW, heads, S, B): boxes of 32
// columns x `rows` rows of one head and one batch row, 128-byte swizzle;
// rows past S read as zeros
bool natural_map(CUtensorMap* map, EncodeTiled encode, const float* ptr,
                 int DW, int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(DW), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(DW) * 4,
                                 cuuint64_t(heads) * DW * 4,
                                 cuuint64_t(S) * heads * DW * 4};
  const cuuint32_t box[4] = {kChunkCols, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a float32 (B, heads, DW, Sp) transposed plane as (Sp, DW, heads, B): boxes
// of bs positions x DW columns, a bs * 4-byte swizzle (64 or 128)
bool transposed_map(CUtensorMap* map, EncodeTiled encode, const float* ptr,
                    int Sp, int DW, int heads, int B, int bs) {
  const cuuint64_t dims[4] = {cuuint64_t(Sp), cuuint64_t(DW),
                              cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(Sp) * 4,
                                 cuuint64_t(DW) * Sp * 4,
                                 cuuint64_t(heads) * DW * Sp * 4};
  const cuuint32_t box[4] = {cuuint32_t(bs), cuuint32_t(DW), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bs == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pad_rows(int S) { return (S + kSplitRows - 1) / kSplitRows * kSplitRows; }

// The split pass's planes, one float32 workspace in this order (floats; DW
// = 64 for D <= 64 and 128 above, S' = S rounded up to kSplitRows):
//   qn (2, 2, B, Sq, H, DW)    [q, dO][big, small], the model layout
//   kn (2, 2, B, Skv, Hkv, DW) [k, v][big, small]
//   kt (2, B, Hkv, DW, Skv')   [big, small], K transposed
//   qt (2, 2, B, H, DW, Sq')   [q, dO][big, small], transposed; at DW = 64
//                              only (the dK/dV kernel transposes its own
//                              tiles at DW = 128, qt is null)
// Every plane's size is a multiple of DW floats, so each starts 256-byte
// aligned when the workspace does. The one place that knows this layout:
// the launches take the workspace and find their planes here.
struct Planes {
  float *qn, *kn, *kt, *qt;
  size_t floats;                             // the workspace's size
};

Planes planes(float* ws, int B, int Sq, int Skv, int H, int Hkv, int D) {
  const size_t DW = D <= 64 ? 64 : 128;
  const size_t n_qn = 4 * size_t(B) * Sq * H * DW;
  const size_t n_kn = 4 * size_t(B) * Skv * Hkv * DW;
  const size_t n_kt = 2 * size_t(B) * Hkv * DW * pad_rows(Skv);
  const size_t n_qt = DW == 64 ? 4 * size_t(B) * H * DW * pad_rows(Sq) : 0;
  const size_t at_kn = n_qn, at_kt = at_kn + n_kn, at_qt = at_kt + n_kt;
  return Planes{ws, ws + at_kn, ws + at_kt, n_qt ? ws + at_qt : nullptr,
                at_qt + n_qt};
}

struct Args {
  Planes p;
  const float *lse, *delta;
  int B, Sq, Skv, q_offset, H, Hkv, D, window;
  float softcap, scale;
};

// a kernel's maps of its resident planes (from `res`, 64-row boxes) and
// streamed ones (from `str`, BS-row boxes), each a (2, 2, B, S, heads, DW)
// buffer of the split pass, and its n_t transposed planes from t (those of
// the streamed tensors)
bool make_maps(Maps* m, const float* res, int res_heads, int res_S,
               const float* str, int str_heads, int str_S, const float* t,
               int n_t, int B, int DW, int BS) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const size_t n_res = size_t(B) * res_S * res_heads * DW;
  const size_t n_str = size_t(B) * str_S * str_heads * DW;
  for (int p = 0; p < 4; ++p)
    if (!natural_map(&m->res[p], encode, res + p * n_res, DW, res_heads,
                     res_S, B, kRes) ||
        !natural_map(&m->str[p], encode, str + p * n_str, DW, str_heads,
                     str_S, B, BS))
      return false;
  const int Sp = pad_rows(str_S);
  const size_t n_tr = size_t(B) * str_heads * DW * Sp;
  for (int p = 0; p < n_t; ++p)
    if (!transposed_map(&m->t[p], encode, t + p * n_tr, Sp, DW, str_heads, B,
                        BS))
      return false;
  return true;
}

template <int DW>
cudaError_t dkdv(const Args& a, float* part, cudaStream_t st) {
  constexpr int BS = tf32_rows<DW>();
  constexpr bool kInPlace = dkdv_in_place<DW>();
  constexpr int smem = Tiles<DW, BS, kInPlace ? 0 : 4>::kSmem;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = opt_in(flash_bwd_dkdv_tf32_kernel<DW, BS>, smem,
                                 configured);
  if (err != cudaSuccess) return err;
  Maps m;
  if (!make_maps(&m, a.p.kn, a.Hkv, a.Skv, a.p.qn, a.H, a.Sq, a.p.qt,
                 kInPlace ? 0 : 4, a.B, DW, BS))
    return cudaErrorInvalidValue;
  const dim3 grid(a.H, a.B, (a.Skv + kRes - 1) / kRes);
  flash_bwd_dkdv_tf32_kernel<DW, BS><<<grid, kDkdvThreads, smem, st>>>(
      m, a.lse, a.delta, part, a.Sq, a.Skv, a.q_offset, a.H, a.Hkv, a.D,
      a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename E, int DW>
cudaError_t dq(const Args& a, void* dqp, cudaStream_t st) {
  constexpr int BS = tf32_rows<DW>();
  constexpr int smem = Tiles<DW, BS, 2>::kSmem;
  static bool configured[kMaxDevices] = {};
  const cudaError_t err =
      opt_in(flash_bwd_dq_tf32_kernel<E, DW, BS>, smem, configured);
  if (err != cudaSuccess) return err;
  Maps m;
  if (!make_maps(&m, a.p.qn, a.H, a.Sq, a.p.kn, a.Hkv, a.Skv, a.p.kt, 2, a.B,
                 DW, BS))
    return cudaErrorInvalidValue;
  const dim3 grid(a.H, a.B, (a.Sq + kRes - 1) / kRes);
  flash_bwd_dq_tf32_kernel<E, DW, BS><<<grid, kDqThreads, smem, st>>>(
      m, a.lse, a.delta, static_cast<E*>(dqp), a.Sq, a.Skv, a.q_offset, a.H,
      a.Hkv, a.D, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename E, int DW>
cudaError_t split(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, float* delta, const Planes& p, int B,
                  int Sq, int Skv, int H, int Hkv, int D, cudaStream_t st) {
  const long long blocks =
      static_cast<long long>(pad_rows(Sq) / kSplitRows) * H +
      static_cast<long long>(pad_rows(Skv) / kSplitRows) * Hkv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_split_tf32_kernel<E, DW>
      <<<dim3(static_cast<unsigned>(blocks), B), 256, 0, st>>>(
          static_cast<const E*>(q), static_cast<const E*>(k),
          static_cast<const E*>(v), static_cast<const E*>(o),
          static_cast<const E*>(dout), delta, p.qn, p.kn, p.kt, p.qt, Sq,
          Skv, H, Hkv, D);
  return cudaGetLastError();
}

bool shapes_ok(int B, int Sq, int Skv, int q_offset, int H, int Hkv, int D,
               int window) {
  return B > 0 && Sq > 0 && Skv > 0 && q_offset >= 0 &&
         q_offset <= Skv - Sq && H > 0 && Hkv > 0 && H % Hkv == 0 && D > 0 &&
         D <= 128 && window >= 0 && B <= 65535 &&
         (Sq + kRes - 1) / kRes <= 65535 && (Skv + kRes - 1) / kRes <= 65535 &&
         Skv <= 0x7fffffff - kSplitRows;
}

}  // namespace

// the floats of the split planes' workspace (planes()) at these shapes,
// or 0 where the launches would refuse them
extern "C" long long flash_bwd_tf32_workspace_floats(int B, int Sq, int Skv,
                                                     int H, int Hkv, int D) {
  if (!shapes_ok(B, Sq, Skv, 0, H, Hkv, D, 0)) return 0;
  return static_cast<long long>(
      planes(nullptr, B, Sq, Skv, H, Hkv, D).floats);
}

// (a): q, k, v, out, dout in dtype (0 = float32, 1 = bfloat16, 2 = float16,
// the forward's codes), q/out/dout (B, Sq, H, D), k/v (B, Skv, Hkv, D),
// contiguous, D <= 128; delta (B, H, Sq) float32 out; ws the split planes'
// workspace (flash_bwd_tf32_workspace_floats floats, 16-byte aligned).
extern "C" int flash_bwd_split_tf32_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* delta, void* ws, int B, int Sq, int Skv, int H,
    int Hkv, int D, int dtype, void* stream) {
  if (!shapes_ok(B, Sq, Skv, 0, H, Hkv, D, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const d = static_cast<float*>(delta);
  const Planes p = planes(static_cast<float*>(ws), B, Sq, Skv, H, Hkv, D);
#define SPLIT(E, W) \
  split<E, W>(q, k, v, out, dout, d, p, B, Sq, Skv, H, Hkv, D, st)
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64 ? SPLIT(float, 64) : SPLIT(float, 128);
  else if (dtype == 1)
    err = D <= 64 ? SPLIT(__nv_bfloat16, 64) : SPLIT(__nv_bfloat16, 128);
  else if (dtype == 2)
    err = D <= 64 ? SPLIT(__half, 64) : SPLIT(__half, 128);
  else
    err = cudaErrorInvalidValue;
#undef SPLIT
  return static_cast<int>(err);
}

// (b): ws as flash_bwd_split_tf32_launch left it, lse and delta (B, H, Sq)
// float32; query row i
// at position q_offset + i, q_offset + Sq <= Skv. part (2 B Skv H D floats)
// receives each q head's share of dK, then of dV, which
// flash_bwd_dkdv_sum_launch adds into dk and dv.
extern "C" int flash_bwd_dkdv_tf32_launch(
    const void* ws, const void* lse, const void* delta, void* part, int B,
    int Sq, int Skv, int q_offset, int H, int Hkv, int D, int window,
    float softcap, float scale, void* stream) {
  if (!shapes_ok(B, Sq, Skv, q_offset, H, Hkv, D, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{planes(static_cast<float*>(const_cast<void*>(ws)), B, Sq, Skv,
                      H, Hkv, D),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Sq, Skv, q_offset, H,
               Hkv, D, window, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const p = static_cast<float*>(part);
  return static_cast<int>(D <= 64 ? dkdv<64>(a, p, st) : dkdv<128>(a, p, st));
}

// (c): ws, lse and delta as (b); dq (B, Sq, H, D) out in dtype (the codes
// of (a)).
extern "C" int flash_bwd_dq_tf32_launch(
    const void* ws, const void* lse, const void* delta, void* dqp, int B,
    int Sq, int Skv, int q_offset, int H, int Hkv, int D, int window,
    float softcap, float scale, int dtype, void* stream) {
  if (!shapes_ok(B, Sq, Skv, q_offset, H, Hkv, D, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{planes(static_cast<float*>(const_cast<void*>(ws)), B, Sq, Skv,
                      H, Hkv, D),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), B, Sq, Skv, q_offset, H,
               Hkv, D, window, softcap, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64 ? dq<float, 64>(a, dqp, st) : dq<float, 128>(a, dqp, st);
  else if (dtype == 1)
    err = D <= 64 ? dq<__nv_bfloat16, 64>(a, dqp, st)
                  : dq<__nv_bfloat16, 128>(a, dqp, st);
  else if (dtype == 2)
    err = D <= 64 ? dq<__half, 64>(a, dqp, st) : dq<__half, 128>(a, dqp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
