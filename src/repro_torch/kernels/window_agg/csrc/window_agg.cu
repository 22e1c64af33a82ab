// Fused window statistics + z-score spike mask over rows of T ticks.
//
// Replaces the TPU kernel src/repro/kernels/window_agg/kernel.py:59
// (window_agg_pallas, body _kernel), which reduces (8, T) row blocks in
// VMEM and stores the eight stats into a 128-lane block (the TPU's store
// width; 120 of the 128 lanes are padding).
//
// Output per row: stats[8] = [mean, var, min, max, last, count, sum,
// n_spikes] over the masked ticks, and spikes[T] = mask & (|v - mu| / sigma
// > k_sigma) against the carried (mu, var) of the row.
//
// Bound on Hopper: bytes. Per row it reads T floats + T bools + 2 floats
// and writes 8 floats + T bools (the (R, 8) stats without the TPU's lane
// padding); the arithmetic is a handful of adds per element. What keeps a
// kernel from that bound is memory latency and access width: a thread that
// walks its row with one dependent load after another waits a round trip
// per tick, and the 32 threads of a warp that each walk their own row
// touch 32 rows at once, so no warp access is coalesced.
//
// Two instances; the wrapper picks one statically (ops.impl_for) and says
// whether it may move vector pieces (`vec`: 16-byte aligned pointers and a
// T that the piece divides):
//   * row (T <= 16; the decision path has T = 8): one thread per row, T a
//     template parameter, the whole row in registers. Every load of the row
//     is issued before the first instruction that uses one: with vec as
//     float4 values and 16-, 8- or 4-byte mask words (T % 4 == 0), else as
//     scalars. The stats leave as two float4, the spikes as packed words.
//     One-warp blocks spread the path's 2048 rows over 64 SMs. The
//     arithmetic is the sequential loop of the plain definition with every
//     add, multiply and divide written _rn, so nvcc cannot contract them:
//     the stats equal a sequential float32 loop over the row bit for bit.
//   * warp (T > 16; the fleet has T = 64): one warp per row. The row is
//     cut into chunks of 64 ticks; lane l owns ticks 2l and 2l + 1 of each,
//     so a warp instruction reads 256 contiguous bytes of values (a float2
//     a lane with vec) and 64 of mask (two bytes a lane). The first KREG
//     chunks of the row are loaded before any is used and stay in
//     registers, where the second pass reads them; a row longer than KREG
//     chunks loads the rest chunk by chunk in each pass. count and n_spikes
//     are popcounts of ballots, min and max shuffle reductions, last the
//     value at the largest masked index (__reduce_max_sync, then a shuffle
//     from the lane that owns it): all exact. sum and the sum of squared
//     deviations are summed per lane in tick order, then over the lanes by
//     a fixed __shfl_xor_sync butterfly (offsets 16, 8, 4, 2, 1), which
//     leaves the same bits in every lane. That order is not the sequential
//     one, so mean, var and sum agree with it within rounding (rtol = atol
//     = 1e-5), not bit for bit; tests/test_torch_kernels.py emulates it.
// Neither instance uses atomics, so both are deterministic. Indices are
// 32-bit: the wrapper keeps R * max(T, 8) below 2^31.
#include "../../row_io.cuh"

namespace {

constexpr int kStats = 8;
constexpr float kBig = 3.4e38f;

struct Args {
  const float* values;
  const uint8_t* mask;
  const float* state_mean;
  const float* state_var;
  float* stats;
  uint8_t* spikes;
  int R, T;
  float k_sigma;
};

template <int T, bool VEC>
__global__ void __launch_bounds__(kRowThreads)
window_agg_row_kernel(const Args a) {
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= a.R) return;
  float v[T];
  uint8_t m[T];
  load_row<T, VEC>(a.values + r * T, v);
  load_row<T, VEC>(a.mask + r * T, m);
  const float mu = __ldg(a.state_mean + r);
  const float sigma = sqrtf(fmaxf(__ldg(a.state_var + r), 1e-12f));

  float n = 0.0f, s = 0.0f, vmin = kBig, vmax = -kBig, last = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (m[t]) {
      n = __fadd_rn(n, 1.0f);
      s = __fadd_rn(s, v[t]);
      vmin = fminf(vmin, v[t]);
      vmax = fmaxf(vmax, v[t]);
      last = v[t];
    }
  }
  const float mean = __fdiv_rn(s, fmaxf(n, 1.0f));
  float ss = 0.0f, n_spikes = 0.0f;
  uint8_t spike[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    spike[t] = 0;
    if (m[t]) {
      const float d = __fsub_rn(v[t], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
      spike[t] = __fdiv_rn(fabsf(__fsub_rn(v[t], mu)), sigma) > a.k_sigma;
      n_spikes = __fadd_rn(n_spikes, spike[t] ? 1.0f : 0.0f);
    }
  }
  const bool any = n > 0.0f;
  float4* out = reinterpret_cast<float4*>(a.stats + r * kStats);
  out[0] = make_float4(mean, __fdiv_rn(ss, fmaxf(n, 1.0f)),
                       any ? vmin : 0.0f, any ? vmax : 0.0f);
  out[1] = make_float4(last, n, s, n_spikes);
  store_row<T, VEC>(a.spikes + r * T, spike);
}

// ----------------------------------------------------------------- warp
__device__ __forceinline__ int ballot_count(uint32_t bits) {
  return __popc(__ballot_sync(kFull, bits & 1u)) +
         __popc(__ballot_sync(kFull, bits & 2u));
}

// KREG: chunks held in registers, a power of two covering the row up to 16
template <int KREG, bool VEC>
__global__ void __launch_bounds__(kWarpThreads)
window_agg_warp_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (r >= a.R) return;   // the whole warp leaves together
  const int T = a.T;
  const float* vrow = a.values + r * T;
  const uint8_t* mrow = a.mask + r * T;
  const int chunks = (T + kChunk - 1) / kChunk;
  float2 v[KREG];
  uint32_t m[KREG];
#pragma unroll
  for (int c = 0; c < KREG; ++c)
    load_pair<VEC>(vrow, mrow, c * kChunk + 2 * lane, T, v[c], m[c]);
  const float mu = __ldg(a.state_mean + r);
  const float sigma = sqrtf(fmaxf(__ldg(a.state_var + r), 1e-12f));

  int n = 0, last_t = -1;
  float s = 0.0f, vmin = kBig, vmax = -kBig, last_v = 0.0f;
  auto pass1 = [&](float2 x, uint32_t bits, int t) {
    if (bits & 1u) {
      s = __fadd_rn(s, x.x);
      vmin = fminf(vmin, x.x);
      vmax = fmaxf(vmax, x.x);
      last_t = t;
      last_v = x.x;
    }
    if (bits & 2u) {
      s = __fadd_rn(s, x.y);
      vmin = fminf(vmin, x.y);
      vmax = fmaxf(vmax, x.y);
      last_t = t + 1;
      last_v = x.y;
    }
    n += ballot_count(bits);
  };
#pragma unroll
  for (int c = 0; c < KREG; ++c) pass1(v[c], m[c], c * kChunk + 2 * lane);
  for (int c = KREG; c < chunks; ++c) {
    float2 x;
    uint32_t bits;
    const int t = c * kChunk + 2 * lane;
    load_pair<VEC>(vrow, mrow, t, T, x, bits);
    pass1(x, bits, t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, off));
    vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, off));
  }
  const int t_last = __reduce_max_sync(kFull, last_t);
  const float last_bcast =
      __shfl_sync(kFull, last_v, (t_last & (kChunk - 1)) >> 1);
  const float nf = static_cast<float>(n);
  const float mean = __fdiv_rn(s, fmaxf(nf, 1.0f));

  float ss = 0.0f;
  int n_spikes = 0;
  uint8_t* srow = a.spikes + r * T;
  auto pass2 = [&](float2 x, uint32_t bits, int t) {
    uint32_t spike = 0;
    if (bits & 1u) {
      const float d = __fsub_rn(x.x, mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
      spike |= __fdiv_rn(fabsf(__fsub_rn(x.x, mu)), sigma) > a.k_sigma;
    }
    if (bits & 2u) {
      const float d = __fsub_rn(x.y, mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
      spike |= (__fdiv_rn(fabsf(__fsub_rn(x.y, mu)), sigma) > a.k_sigma)
               << 1;
    }
    n_spikes += ballot_count(spike);
    store_pair<VEC>(srow, t, T, spike);
  };
#pragma unroll
  for (int c = 0; c < KREG; ++c) pass2(v[c], m[c], c * kChunk + 2 * lane);
  for (int c = KREG; c < chunks; ++c) {
    float2 x;
    uint32_t bits;
    const int t = c * kChunk + 2 * lane;
    load_pair<VEC>(vrow, mrow, t, T, x, bits);
    pass2(x, bits, t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));

  if (lane == 0) {
    const bool any = n > 0;
    float4* out = reinterpret_cast<float4*>(a.stats + r * kStats);
    out[0] = make_float4(mean, __fdiv_rn(ss, fmaxf(nf, 1.0f)),
                         any ? vmin : 0.0f, any ? vmax : 0.0f);
    out[1] = make_float4(any ? last_bcast : 0.0f, nf, s,
                         static_cast<float>(n_spikes));
  }
}

// -------------------------------------------------------------- launch
struct RowLaunch {
  const Args& a;
  cudaStream_t st;
  template <int T, bool VEC>
  cudaError_t operator()() const {
    window_agg_row_kernel<T, VEC>
        <<<(a.R + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
};

template <int KREG>
cudaError_t launch_warp(const Args& a, bool vec, cudaStream_t st) {
  const int rows = kWarpThreads / 32;
  const int blocks = (a.R + rows - 1) / rows;
  if (vec)
    window_agg_warp_kernel<KREG, true><<<blocks, kWarpThreads, 0, st>>>(a);
  else
    window_agg_warp_kernel<KREG, false><<<blocks, kWarpThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// impl: 0 = row (T <= 16), 1 = warp. vec: vector loads and stores, which
// need 16-byte aligned pointers and T % 4 == 0 (row) or T % 2 == 0 (warp).
extern "C" int window_agg_launch(const void* values, const void* mask,
                                 const void* state_mean,
                                 const void* state_var, void* stats,
                                 void* spikes, int R, int T, float k_sigma,
                                 int impl, int vec, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const long long wide = T > kStats ? T : kStats;
  if (static_cast<long long>(R) * wide >= (1ll << 31) || !aligned16(stats))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned16(values) && aligned16(mask) && aligned16(spikes) &&
               T % (impl == 0 ? 4 : 2) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(values),
               static_cast<const uint8_t*>(mask),
               static_cast<const float*>(state_mean),
               static_cast<const float*>(state_var),
               static_cast<float*>(stats), static_cast<uint8_t*>(spikes), R,
               T, k_sigma};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (impl == 0)
    return static_cast<int>(dispatch_row(T, vec != 0, RowLaunch{a, st}));
  if (impl != 1 || T <= kRowMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (T + kChunk - 1) / kChunk;
  const cudaError_t err =
      chunks <= 1   ? launch_warp<1>(a, vec != 0, st)
      : chunks <= 2 ? launch_warp<2>(a, vec != 0, st)
      : chunks <= 4 ? launch_warp<4>(a, vec != 0, st)
      : chunks <= 8 ? launch_warp<8>(a, vec != 0, st)
                    : launch_warp<16>(a, vec != 0, st);
  return static_cast<int>(err);
}
