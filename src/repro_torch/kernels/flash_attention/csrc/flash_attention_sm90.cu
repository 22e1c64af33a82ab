// Causal GQA flash attention for Hopper's tensor cores: bfloat16 in and out,
// float32 scores, softmax and accumulators; optional sliding window and tanh
// softcap. Head dims 64, 128 and 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, called through flash_attention_pallas), which tiles (Qb, D) and
// (Kb, D) blocks into VMEM, feeds both products to the MXU and carries
// (acc, m, l) in VMEM scratch across a sequential kv grid axis.
//
// Bound on Hopper: operations. A causal pass does 4*B*H*S^2*D/2 flops
// against 2*B*S*(H + 2*Hkv)*D elements moved, far above the card's
// flops-per-byte line, so the bound is the bf16 tensor cores (989 TFLOP/s
// dense), reached only through wgmma.
//
// Design: one CTA per (128 q rows, q head, batch), q blocks launched
// heaviest first (the last causal block has the most key tiles). Three
// warpgroups: two consumers own 64 q rows each (wgmma M = 64); the third,
// the producer, drops its registers with setmaxnreg, and one of its threads
// issues the TMA loads: Q once, then K and V tiles of BN keys into a 2-stage
// ring, one full and one empty mbarrier per stage. The tensor maps describe the model layout as it is,
// dims (D, H, S, B) for q/out and (D, Hkv, S, B) for k/v, so no transpose
// precedes the launch and q head h reads kv head h / G directly. Every box is
// 64 columns (128 bytes) wide with the 128-byte swizzle that wgmma reads; a
// tile of D columns is D / 64 such chunks. TMA fills rows past S with zeros;
// keys >= S are masked and rows >= S are not stored.
//   * S = Q K^T: wgmma m64nBNk16, A (Q) and B (K) from shared memory, both
//     K-major, f32 accumulators in registers. The softmax scale multiplies
//     the f32 scores (the model calls with scale 1, its q already scaled).
//   * softmax in the accumulator fragment, with the TPU kernel's constants
//     and order: softcap tanh(s/cap)*cap before the mask, masked scores
//     -1e30, running max floored at -1e29, row max and sum by quad shuffles,
//     l summed from the f32 p. The mask is applied only on tiles that cut
//     the diagonal, the window edge or S; tiles wholly in a warpgroup's
//     causal future or before its window are skipped (they add p = 0 and
//     leave alpha at 1, so skipping is exact).
//   * O += P V with p split in two bf16 halves, P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), both register A fragments against the same V
//     tile in shared memory (MN-major: the transpose flag). A single bf16 p
//     would move outputs near zero by tens of bf16 ulps of the float32-p
//     reference; the split keeps p to ~16 bits at half again the tensor work.
//   * epilogue: O / max(l, 1e-30), rounded once to bf16, written swizzled
//     into the warpgroup's own rows of the Q tile and stored by TMA.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <int D, int BN>
struct Tiles {
  static constexpr int kChunks = D / 64;                  // 64-column chunks
  static constexpr int kQChunk = kBlockM * kRowBytes;     // bytes
  static constexpr int kKVChunk = BN * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;   // K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + barriers, + slack to align the base to 1024 bytes (the swizzle atom)
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (B128) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers an async wgmma reads or writes at this point of the
// program, so the compiler neither reads an accumulator before the wait nor
// reuses an operand's register while the wgmma may still read it
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N): A and B from shared memory, both
// K-major; scale_d = 0 overwrites D
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int scale_d);
// D(64 x N, f32) += A(64 x 16, bf16 registers) B(16 x N): B from shared
// memory, MN-major (transposed)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b);

// The instructions name every accumulator register, so the operand lists
// are spelled out per width.

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Accumulator fragment of wgmma m64nN (f32): in each warpgroup, register i of
// thread (warp w, lane) holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (lane % 4) + i % 2. Registers 8j..8j+7 of a score
// fragment are then exactly the bf16 A fragment of keys 16j..16j+15 for the
// P V product (pairs of neighbouring columns packed low to high).
template <int D, int BN>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap o_map, int S,
                            int H, int Hkv, int window, float softcap,
                            float scale) {
  using T = Tiles<D, BN>;
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
  const int hk = h / (H / Hkv);
  const int q_last = min(q0 + kBlockM, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  const int n_tiles = (q_last - k_begin) / BN + 1;
  const int wg = threadIdx.x / 128;

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
      mbar_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(sq + c * T::kQChunk, &q_map, q_bar, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar + 8 * s, (t / kStages - 1) & 1);
        const uint32_t full = full_bar + 8 * s;
        const uint32_t ks = skv + s * 2 * T::kTileBytes;
        const uint32_t vs = ks + T::kTileBytes;
        const int k0 = k_begin + t * BN;
        mbar_expect_tx(full, 2 * T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
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
    const int wg_lo = q0 + 64 * wg;                 // this warpgroup's rows
    const int wg_hi = wg_lo + 63;
    const int row0 = wg_lo + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t q_wg = sq + 64 * wg * kRowBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
          wgmma_ss<BN>(sc,
                       sw128_desc(q_wg + (kk / 4) * T::kQChunk + off, 16,
                                  1024),
                       sw128_desc(ks + (kk / 4) * T::kKVChunk + off, 16,
                                  1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);

        const bool edge = k0 + BN - 1 > wg_lo || k0 + BN > S ||
                          (window > 0 && wg_hi - k0 >= window);
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          float x = sc[i] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (edge) {
            const int qpos = row0 + 8 * ((i / 2) % 2);
            const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            bool ok = kpos <= qpos && kpos < S;
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
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            p_hi[j][e] = bf16x2_bits(hi);
            p_lo[j][e] = bf16x2_bits(__floats2bfloat162_rn(
                p0 - __low2float(hi), p1 - __high2float(hi)));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        pin(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          // keys 16j..16j+15 of every chunk; the chunks (64 columns of D
          // each) sit T::kKVChunk apart, the leading byte offset
          const uint64_t vd = sw128_desc(vs + 16 * j * kRowBytes,
                                         T::kKVChunk, 1024);
          wgmma_rs<D>(o, p_hi[j], vd);
          wgmma_rs<D>(o, p_lo[j], vd);
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
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int row = 16 * warp + lane / 4 + 8 * r;      // within 64 rows
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int unit = ((col % 64) / 8) ^ (row % 8);
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          o[i] / denom[r], o[i + 1] / denom[r]);
      *reinterpret_cast<__nv_bfloat162*>(
          q_ptr + (col / 64) * T::kQChunk + row * kRowBytes + unit * 16 +
          (col % 8) * 2) = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && wg_lo < S) {
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_store(&o_map, q_wg + c * T::kQChunk, 64 * c, h, wg_lo, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, heads, S, B) bf16 tensor in the model layout, boxes of 64 columns x
// `rows` positions of one head and one batch row, 128-byte swizzle; reads
// past S give zeros
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D,
              int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int Hkv, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Tiles<D, BN>::kSmem;
  // the opt-in belongs to the current device: once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        flash_attention_sm90_kernel<D, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, encode, q, D, H, S, B, kBlockM) ||
      !make_map(&km, encode, k, D, Hkv, S, B, BN) ||
      !make_map(&vm, encode, v, D, Hkv, S, B, BN) ||
      !make_map(&om, encode, o, D, H, S, B, 64))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + kBlockM - 1) / kBlockM);
  flash_attention_sm90_kernel<D, BN><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, om, S, H, Hkv, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q/o (B, S, H, D), k/v (B, S, Hkv, D), contiguous, 16-byte
// aligned; D in {64, 128, 256} (256 on 64-key tiles, to fit shared memory
// and registers)
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int Hkv, int D,
                                           int window, float softcap,
                                           float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      B > 65535 || (S + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = launch<64, 128>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, st); break;
    case 128: err = launch<128, 128>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, st); break;
    case 256: err = launch<256, 64>(q, k, v, o, B, S, H, Hkv, window, softcap, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
