// LOCF gap filling: carry the latest observation forward along T.
//
// Replaces the TPU kernel src/repro/kernels/locf/kernel.py:36 (locf_pallas,
// body _kernel), which walks T with the carry in vector registers over
// (8, T) row blocks in VMEM.
//
// Bound on Hopper: bytes. Per (row, tick) it reads a float and a bool and
// writes a float and a bool (10 bytes) and does no arithmetic at all: the
// output is pure selection, so it is bit-exact against any other LOCF
// wherever `has` is true (and here also where it is false: the carry-in
// value comes back). What keeps a kernel from that bound is memory latency
// and access width: a thread that walks its row with one dependent load
// after another waits a round trip per tick, and the 32 threads of a warp
// that each walk their own row touch 32 rows at once, so no warp access is
// coalesced.
//
// Two instances; the wrapper picks one statically (ops.impl_for) and says
// whether it may move vector pieces (`vec`: 16-byte aligned pointers and a
// T that the piece divides):
//   * row (T <= 16; the decision path has T = 8): one thread per row, T a
//     template parameter, the whole row in registers. Every load of the row
//     is issued before the first instruction that uses one: with vec as
//     float4 values and 16-, 8- or 4-byte words of flags (T % 4 == 0),
//     else as scalars. The walk is unrolled, and the row leaves in the same
//     widths. One-warp blocks spread the path's 2048 rows over 64 SMs.
//   * warp (T > 16; the fleet has T = 64): one warp per row. The row is
//     cut into chunks of 64 ticks; lane l owns ticks 2l and 2l + 1 of each,
//     so a warp instruction reads 256 contiguous bytes of values (a float2
//     a lane with vec) and 64 of flags. Four chunks are loaded before any
//     is used. Each chunk is an inclusive scan under
//     combine(l, r) = r.has ? r : l: a lane combines its two ticks, five
//     __shfl_up_sync steps carry the scan across the lanes, and the carry
//     from the chunks before (at first the carry-in, the element before
//     tick 0) enters ahead of lane 0. The combine is associative and pure
//     selection, so the result is bit-exact.
// Neither instance uses atomics. Indices are 32-bit: the wrapper keeps
// R * T below 2^31.
#include "../../row_io.cuh"

namespace {

constexpr int kAhead = 4;   // chunks whose loads are in flight together

struct Args {
  const float* values;
  const uint8_t* observed;
  const float* init_value;
  const uint8_t* init_has;
  float* out;
  uint8_t* has;
  int R, T;
};

template <int T, bool VEC>
__global__ void __launch_bounds__(kRowThreads) locf_row_kernel(const Args a) {
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= a.R) return;
  float v[T];
  uint8_t o[T];
  load_row<T, VEC>(a.values + r * T, v);
  load_row<T, VEC>(a.observed + r * T, o);
  float cv = __ldg(a.init_value + r);
  uint8_t ch = __ldg(a.init_has + r) ? 1 : 0;
  uint8_t h[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (o[t]) {
      cv = v[t];
      ch = 1;
    }
    v[t] = cv;
    h[t] = ch;
  }
  store_row<T, VEC>(a.out + r * T, v);
  store_row<T, VEC>(a.has + r * T, h);
}

// ----------------------------------------------------------------- warp
template <bool VEC>
__global__ void __launch_bounds__(kWarpThreads)
locf_warp_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (r >= a.R) return;   // the whole warp leaves together
  const int T = a.T;
  const float* vrow = a.values + r * T;
  const uint8_t* orow = a.observed + r * T;
  float* out_row = a.out + r * T;
  uint8_t* has_row = a.has + r * T;
  const int chunks = (T + kChunk - 1) / kChunk;
  // the carry: the scan of everything before the current chunk
  float cv = __ldg(a.init_value + r);
  int ch = __ldg(a.init_has + r) ? 1 : 0;
  for (int c0 = 0; c0 < chunks; c0 += kAhead) {
    float2 v[kAhead];
    uint32_t o[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      load_pair<VEC>(vrow, orow, (c0 + u) * kChunk + 2 * lane, T, v[u], o[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u >= chunks) break;   // uniform across the warp
      // this lane's two ticks combined, then the inclusive scan over lanes
      float sv = (o[u] & 2u) ? v[u].y : v[u].x;
      int sh = o[u] != 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float up_v = __shfl_up_sync(kFull, sv, d);
        const int up_h = __shfl_up_sync(kFull, sh, d);
        if (lane >= d && !sh) {
          sv = up_v;
          sh = up_h;
        }
      }
      // the scan before this lane's first tick: the lane before, over the
      // carry
      float pv = __shfl_up_sync(kFull, sv, 1);
      int ph = __shfl_up_sync(kFull, sh, 1);
      if (lane == 0 || !ph) {
        pv = cv;
        ph = ch;
      }
      const float v0 = (o[u] & 1u) ? v[u].x : pv;
      const uint32_t h0 = (o[u] & 1u) || ph;
      const float v1 = (o[u] & 2u) ? v[u].y : v0;
      const uint32_t h1 = (o[u] & 2u) || h0;
      const int t = (c0 + u) * kChunk + 2 * lane;
      store_pair<VEC>(out_row, t, T, make_float2(v0, v1));
      store_pair<VEC>(has_row, t, T, h0 | (h1 << 1));
      const float last_v = __shfl_sync(kFull, sv, 31);
      if (__shfl_sync(kFull, sh, 31)) {
        cv = last_v;
        ch = 1;
      }
    }
  }
}

// -------------------------------------------------------------- launch
struct RowLaunch {
  const Args& a;
  cudaStream_t st;
  template <int T, bool VEC>
  cudaError_t operator()() const {
    locf_row_kernel<T, VEC>
        <<<(a.R + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

// impl: 0 = row (T <= 16), 1 = warp. vec: vector loads and stores, which
// need 16-byte aligned pointers and T % 4 == 0 (row) or T % 2 == 0 (warp).
extern "C" int locf_launch(const void* values, const void* observed,
                           const void* init_value, const void* init_has,
                           void* out, void* has, int R, int T, int impl,
                           int vec, void* stream) {
  if (R <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(R) * T >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned16(values) && aligned16(observed) && aligned16(out) &&
               aligned16(has) && T % (impl == 0 ? 4 : 2) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(values),
               static_cast<const uint8_t*>(observed),
               static_cast<const float*>(init_value),
               static_cast<const uint8_t*>(init_has),
               static_cast<float*>(out), static_cast<uint8_t*>(has), R, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (impl == 0)
    return static_cast<int>(dispatch_row(T, vec != 0, RowLaunch{a, st}));
  if (impl != 1 || T <= kRowMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kWarpThreads / 32;
  const int blocks = (R + rows - 1) / rows;
  if (vec)
    locf_warp_kernel<true><<<blocks, kWarpThreads, 0, st>>>(a);
  else
    locf_warp_kernel<false><<<blocks, kWarpThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
