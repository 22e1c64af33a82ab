// Fused bucketize + per-tick mean: raw (E*S, M) samples -> (E*S, T) tick
// means and an observed mask.
//
// Replaces the TPU kernel src/repro/kernels/harmonize/kernel.py:47
// (harmonize_pallas, body _kernel), which keeps (8, T) accumulators in VMEM
// and walks M with a fori_loop so HBM sees only the (R, M) inputs and the
// (R, T) outputs.
//
// What it computes, for each row r and tick t (the oracle's function,
// harmonize_ref with use_pallas=False, and the plain version in ref.py):
//   bucket(m) = ceil((ts[m] - t0) / tick_s) - 1, t0 = window_start[r / S],
//   h(m, t)   = valid[m] && bucket(m) == t (0 <= bucket < T),
//   total[t]  = sum over m, in M order, of h(m, t) * v[m] (from +0),
//   count[t]  = sum over m of h(m, t),
//   out[t]    = count[t] > 0 ? total[t] / max(count[t], 1) : 0.
// The hit weight is a product, so a non-finite value in a sample that
// misses tick t still makes total[t] NaN (0 * NaN and 0 * inf are NaN).
// The oracle does this; the Pallas kernel does not, because XLA turns the
// 0/1 product into a select (see tests/test_torch_kernels.py). The port
// follows the oracle.
//
// Bound on Hopper: bytes. Per row it reads M floats of values, M of
// timestamps and M valid bytes and writes T floats and T bytes; each
// sample needs one bucket (a subtract, an IEEE divide, a ceil) and two
// adds. What kept the port's first kernel (one thread per (row, tick),
// each walking all M samples) far from that bound was its instruction
// count: it bucketed every sample once per tick.
//
// This kernel buckets each sample exactly once, with that kernel's
// arithmetic (__fsub_rn; __fdiv_rn: IEEE division, no reciprocal
// multiply; ceilf; the same float-to-int conversion), and add each tick's
// hits one at a time (__fadd_rn) in M order onto a total that starts at
// +0, so the means equal a sequential float32 loop bit for bit. A miss
// adds h * v = +-0 when v is finite, which never changes such a sum (it
// can never become -0); a miss with a non-finite value makes it NaN for
// good. So each row counts its non-finite values and keeps the lowest and
// highest bucket key among them (-1 for a sample that hits no tick): tick
// t's total is NaN when the row has a non-finite value and they do not all
// hit t. A NaN total reaches out[t] only where count[t] > 0, as in the
// loop. Every add and divide is written _rn, so nvcc contracts nothing
// into an FMA. No atomics on device memory.
//
// One instance, "warp" (ops.impl_for), for the decision loop's windows
// (32 samples into 8 ticks) and the fleet's (128 into 64) alike: one warp
// per row, four rows a block. The row goes in chunks of 32 samples, lane l
// holding sample 32c + l. Lanes that hit the same tick find each other
// through a mask per tick in shared memory (atomicOr, then a read; at 128
// samples a row this is cheaper than __match_any_sync, which
// tools/harmonize_variants.py times beside it). Each group's first lane
// adds the group's values, taken by shuffle in lane (= M) order, onto the
// tick's total; the totals, counts and masks are the warp's own 12 * T
// bytes of shared memory, one group per tick, so the lanes of a warp write
// different addresses. Loads: with `vec` (16-byte aligned pointers and
// M % 4 == 0, so that every row starts aligned) a warp reads 128 samples
// at once as a float4 of values, a float4 of timestamps and a 4-byte word
// of flags a lane (512, 512 and 128 contiguous bytes) and stages them in
// shared memory; else each lane reads its samples as scalars (128 and 32
// contiguous bytes a warp instruction). Either way every input byte is
// read once, coalesced, and each lane writes its ticks of the row, 32
// contiguous outputs a warp instruction.
// Indices are 64-bit where they multiply rows by M or T.
#include <climits>

#include "../../row_io.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // a block's shared memory (227 KB)

struct Args {
  const float* values;
  const float* timestamps;
  const uint8_t* valid;
  const float* window_start;
  float* out;
  uint8_t* observed;
  int R, S, M, T;
  float tick_s;
};

__device__ __forceinline__ int bucket_key(float ts, bool ok, float t0,
                                          float tick_s, int T) {
  const float rel = __fsub_rn(ts, t0);
  const int idx = static_cast<int>(ceilf(__fdiv_rn(rel, tick_s))) - 1;
  return (ok && idx >= 0 && idx < T) ? idx : -1;
}

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// A row's non-finite values: how many, and the range of their keys.
struct NonFinite {
  int n = 0, lo = INT_MAX, hi = INT_MIN;
  // tick t's total as the sequential loop leaves it: NaN where a
  // non-finite value misses t, i.e. unless every one of them hits t
  __device__ float total(int t, float total) const {
    return (n > 0 && !(lo == hi && lo == t)) ? __int_as_float(0x7fffffff)
                                             : total;
  }
};

// ----------------------------------------------------------------- warp
constexpr int kWarpRows = 4;              // rows (warps) a block
constexpr int kStage = 128;               // samples a warp stages (vec)
constexpr int kStageBytes = kStage * 9;   // values, timestamps, valid

// shared memory of one warp: the staged samples (vec), then T totals, T
// counts and T group masks
__host__ __device__ constexpr int warp_bytes(int T, bool vec) {
  return ((vec ? kStageBytes : 0) + 12 * T + 15) / 16 * 16;
}

template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
harmonize_warp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= a.R) return;   // the whole warp leaves together
  const int M = a.M, T = a.T;
  unsigned char* mine = smem + w * warp_bytes(T, VEC);
  float* stage_v = reinterpret_cast<float*>(mine);
  float* stage_ts = stage_v + kStage;
  uint8_t* stage_ok = reinterpret_cast<uint8_t*>(stage_ts + kStage);
  float* total_acc =
      reinterpret_cast<float*>(mine + (VEC ? kStageBytes : 0));
  float* count_acc = total_acc + T;
  unsigned* masks = reinterpret_cast<unsigned*>(count_acc + T);
  for (int t = lane; t < T; t += 32) {
    total_acc[t] = 0.0f;
    count_acc[t] = 0.0f;
    masks[t] = 0u;
  }
  __syncwarp();

  const float t0 = __ldg(a.window_start + r / a.S);
  const long long base = static_cast<long long>(r) * M;
  const float* vrow = a.values + base;
  const float* trow = a.timestamps + base;
  const uint8_t* orow = a.valid + base;
  const unsigned below = (1u << lane) - 1u;   // the lanes before this one
  NonFinite nf;

  for (int b0 = 0; b0 < M; b0 += kStage) {
    // samples b0 + 32k + lane, k < 4; past M a finite zero that hits no tick
    float v[4], ts[4];
    bool ok[4];
    if constexpr (VEC) {
      if (b0 + 4 * lane < M) {   // M % 4 == 0: a float4 is wholly in or out
        reinterpret_cast<float4*>(stage_v)[lane] =
            __ldg(reinterpret_cast<const float4*>(vrow + b0) + lane);
        reinterpret_cast<float4*>(stage_ts)[lane] =
            __ldg(reinterpret_cast<const float4*>(trow + b0) + lane);
        reinterpret_cast<unsigned int*>(stage_ok)[lane] =
            __ldg(reinterpret_cast<const unsigned int*>(orow + b0) + lane);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 32 * k + lane;
        const bool in = b0 + i < M;
        v[k] = in ? stage_v[i] : 0.0f;
        ts[k] = in ? stage_ts[i] : 0.0f;
        ok[k] = in && stage_ok[i] != 0;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = b0 + 32 * k + lane;
        const bool in = m < M;
        v[k] = in ? __ldg(vrow + m) : 0.0f;
        ts[k] = in ? __ldg(trow + m) : 0.0f;
        ok[k] = in && __ldg(orow + m) != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (b0 + 32 * k >= M) break;   // uniform across the warp
      const int key = bucket_key(ts[k], ok[k], t0, a.tick_s, T);
      const bool fin = finite(v[k]);
      const unsigned nfb = __ballot_sync(kFull, !fin);
      if (nfb) {   // uniform
        nf.n += __popc(nfb);
        nf.lo = min(nf.lo, __reduce_min_sync(kFull, fin ? INT_MAX : key));
        nf.hi = max(nf.hi, __reduce_max_sync(kFull, fin ? INT_MIN : key));
      }

      // the lanes of this chunk that hit the same tick, in M order
      const int slot = max(key, 0);
      if (key >= 0) atomicOr(masks + slot, 1u << lane);
      __syncwarp();
      const unsigned grp = key >= 0 ? masks[slot] : 0u;
      __syncwarp();   // every lane has its group before a mask is cleared
      const bool first = key >= 0 && (grp & below) == 0;
      const int pop = first ? __popc(grp) : 0;
      const int steps = __reduce_max_sync(kFull, pop);
      float total = total_acc[slot];
      unsigned rest = grp;
      for (int j = 0; j < steps; ++j) {   // uniform trip count
        const int src = __ffs(rest) - 1;  // -1 once the group is done
        rest &= rest - 1u;
        const float x = __shfl_sync(kFull, v[k], src & 31);
        if (j < pop) total = __fadd_rn(total, x);
      }
      if (first) {
        total_acc[slot] = total;
        count_acc[slot] = __fadd_rn(count_acc[slot], static_cast<float>(pop));
        masks[slot] = 0u;
      }
      __syncwarp();
    }
  }

  float* out_row = a.out + static_cast<long long>(r) * T;
  uint8_t* obs_row = a.observed + static_cast<long long>(r) * T;
  for (int t = lane; t < T; t += 32) {
    const float count = count_acc[t];
    const bool obs = count > 0.0f;
    out_row[t] =
        obs ? __fdiv_rn(nf.total(t, total_acc[t]), fmaxf(count, 1.0f)) : 0.0f;
    obs_row[t] = obs ? 1 : 0;
  }
}

}  // namespace

// values/timestamps (E*S, M) float32, valid (E*S, M) bool, window_start
// (E,) float32 -> out (E*S, T) float32, observed (E*S, T) bool.
// vec: staged float4 loads, which need 16-byte aligned values, timestamps
// and valid, and M % 4 == 0.
extern "C" int harmonize_launch(const void* values, const void* timestamps,
                                const void* valid, const void* window_start,
                                void* out, void* observed, int E, int S,
                                int M, int T, float tick_s, int vec,
                                void* stream) {
  if (E <= 0 || S <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (vec && !(aligned16(values) && aligned16(timestamps) &&
               aligned16(valid) && M % 4 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(E) * S;
  if (rows >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = warp_bytes(T, vec != 0);
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = per_warp * kWarpRows <= kMaxSmem ? kWarpRows
                                                     : kMaxSmem / per_warp;
  const int bytes = warps * per_warp;
  const Args a{static_cast<const float*>(values),
               static_cast<const float*>(timestamps),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(window_start),
               static_cast<float*>(out), static_cast<uint8_t*>(observed),
               static_cast<int>(rows), S, M, T, tick_s};
  auto kernel = vec ? harmonize_warp_kernel<true>
                    : harmonize_warp_kernel<false>;
  if (bytes > 48 * 1024) {   // beyond the default: opt in (large T only)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((rows + warps - 1) / warps);
  kernel<<<blocks, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
