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
// The warp instance buckets each sample exactly once, with that kernel's
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
// Two instances, chosen by ops.impl_for from T. "warp" (T <= ops.MAX_T) serves
// the decision loop's windows (32 samples into 8 ticks) and the fleet's (128
// into 64) alike: one warp per row, four rows a block. The row goes in chunks
// of 32 samples, lane l holding sample 32c + l. Lanes that hit the same tick
// find each other through a mask per tick in shared memory (atomicOr, then a
// read; at 128 samples a row this is cheaper than __match_any_sync, which
// tools/harmonize_variants.py times beside it). Each group's first lane adds
// the group's values, taken by shuffle in lane (= M) order, onto the tick's
// total; the totals, counts and masks are the warp's own 12 * T bytes of shared
// memory, one group per tick, so the lanes of a warp write different addresses.
// Loads: with `vec` (16-byte aligned pointers and M % 4 == 0, so that every row
// starts aligned) a warp reads 128 samples at once as a float4 of values, a
// float4 of timestamps and a 4-byte word of flags a lane (512, 512 and 128
// contiguous bytes) and stages them in shared memory; else each lane reads its
// samples as scalars (128 and 32 contiguous bytes a warp instruction). Either
// way every input byte is read once, coalesced, and each lane writes its ticks
// of the row, 32 contiguous outputs a warp instruction.
//
// "tiled" (T > ops.MAX_T, where a row's 12 * T bytes no longer fit a
// block's shared memory; a week of 30 s ticks is 20,160): one block of
// kSortThreads threads per row, each sample bucketed ONCE. The block loads
// its row kSortChunk samples at a time (thread i the kSortItems samples
// kSortItems * i .., as float4 values and timestamps and 4-byte words of
// flags with `vec`), buckets them with the warp instance's arithmetic
// (bucket_key), counts the row's non-finite values as the warp instance
// does, and sorts the chunk's samples by tick with a stable radix sort
// (CUB's BlockRadixSort, in shared memory, 5-bit digits over the bits
// that T needs: three passes for a week; a sample that hits no tick sorts
// last under the key T): a tick's hits then lie side by side in M order.
// The thread holding the first hit of a tick adds the tick's values one at
// a time (__fadd_rn) onto its running total, in that order, and counts
// them: the sequential loop's sum, with no other thread touching that tick
// in that chunk. Totals and counts live in a staging tile of
// `tile` ticks in shared memory (8 bytes a tick), filled by the chunks in
// M order, then written as means (16 bytes of means and 4 of flags a
// thread where T % 4 == 0) and zeroed behind for the next tile. With one
// chunk (M <= kSortChunk, the week shape's 2048) the run's thread divides
// (the only divides: one per observed tick), the sort runs once and the
// row's ticks go out kTile at a time (a block's ~50 KB let four rows
// share an SM); with more, the tile is as large as shared
// memory allows (24,000-odd ticks, a week in one tile) and the chunks are
// sorted again for each tile. Per row the work is O(M log M + T): no
// sample is bucketed twice, no tick scans the samples. The means equal the
// sequential float32 loop bit for bit, NaN and inf included, as the warp
// instance's do; no atomics on device memory.
// Indices are 64-bit where they multiply rows by M or T.
#include <climits>

#include <cub/block/block_radix_sort.cuh>

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
  int tile;   // ticks a warp keeps ("warp": T), or a staging tile holds
  int vec_out;   // tiled: T % 4 == 0 and out 16-byte aligned (quads out)
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

// One warp's row, all T of its ticks.
template <bool VEC>
__device__ __forceinline__ void harmonize_row(const Args& a,
                                              unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= a.R) return;   // the whole warp leaves together
  const int M = a.M, T = a.T;
  unsigned char* mine = smem + w * warp_bytes(a.tile, VEC);
  float* stage_v = reinterpret_cast<float*>(mine);
  float* stage_ts = stage_v + kStage;
  uint8_t* stage_ok = reinterpret_cast<uint8_t*>(stage_ts + kStage);
  float* total_acc =
      reinterpret_cast<float*>(mine + (VEC ? kStageBytes : 0));
  float* count_acc = total_acc + a.tile;
  unsigned* masks = reinterpret_cast<unsigned*>(count_acc + a.tile);
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
      const bool hit = key >= 0;
      const int slot = hit ? key : 0;
      if (hit) atomicOr(masks + slot, 1u << lane);
      __syncwarp();
      const unsigned grp = hit ? masks[slot] : 0u;
      __syncwarp();   // every lane has its group before a mask is cleared
      const bool first = hit && (grp & below) == 0;
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
    out_row[t] = obs ? __fdiv_rn(nf.total(t, total_acc[t]),
                                 fmaxf(count, 1.0f))
                     : 0.0f;
    obs_row[t] = obs ? 1 : 0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
harmonize_warp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  harmonize_row<VEC>(a, smem);
}

// ---------------------------------------------------------------- tiled
constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;                           // samples a thread
constexpr int kSortChunk = kSortThreads * kSortItems;   // samples a sort
constexpr int kTile = 2048;   // ticks a staging tile holds (one chunk)

// the row's NonFinite as the block gathered it in shared memory
__device__ __forceinline__ NonFinite row_summary(const int (&s_nf)[3]) {
  NonFinite nf;
  nf.n = s_nf[0];
  nf.lo = s_nf[1];
  nf.hi = s_nf[2];
  return nf;
}

// samples m0 .. m0 + kSortItems - 1 of a row (past M: a finite zero that
// is not valid); VEC: M % 4 == 0 and 16-byte aligned rows of values and
// timestamps, 4-byte aligned flags, so each group of 4 is wholly in or out
template <bool VEC>
__device__ __forceinline__ void load_items(const float* vrow,
                                           const float* trow,
                                           const uint8_t* orow, int m0,
                                           int M, float (&v)[kSortItems],
                                           float (&ts)[kSortItems],
                                           bool (&ok)[kSortItems]) {
  if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < kSortItems / 4; ++h) {
      const int m = m0 + 4 * h;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      unsigned w = 0u;
      if (m < M) {
        x = __ldg(reinterpret_cast<const float4*>(vrow + m));
        y = __ldg(reinterpret_cast<const float4*>(trow + m));
        w = __ldg(reinterpret_cast<const unsigned*>(orow + m));
      }
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
      ts[4 * h] = y.x; ts[4 * h + 1] = y.y; ts[4 * h + 2] = y.z;
      ts[4 * h + 3] = y.w;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ok[4 * h + e] = ((w >> (8 * e)) & 0xffu) != 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int m = m0 + i;
      const bool in = m < M;
      v[i] = in ? __ldg(vrow + m) : 0.0f;
      ts[i] = in ? __ldg(trow + m) : 0.0f;
      ok[i] = in && __ldg(orow + m) != 0;
    }
  }
}

// four blocks an SM (64 registers a thread): 512 rows in one wave
template <bool VEC>
__global__ void __launch_bounds__(kSortThreads, 4)
harmonize_tiled_kernel(const Args a) {
  // 5-bit digits: three passes cover the 15 bits of a week's ticks
  using Sort =
      cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, float, 5>;
  __shared__ typename Sort::TempStorage sort_tmp;
  __shared__ unsigned s_key[kSortChunk];   // the chunk's keys, sorted
  __shared__ float s_val[kSortChunk];      // their values, in that order
  __shared__ int s_nf[3];                  // the row's NonFinite
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile_total = reinterpret_cast<float*>(smem);
  int* tile_count = reinterpret_cast<int*>(tile_total + a.tile);

  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int M = a.M, T = a.T;
  const float t0 = __ldg(a.window_start + r / a.S);
  const long long base = static_cast<long long>(r) * M;
  const float* vrow = a.values + base;
  const float* trow = a.timestamps + base;
  const uint8_t* orow = a.valid + base;
  const int n_chunks = (M + kSortChunk - 1) / kSortChunk;
  const int end_bit = 32 - __clz(T);   // keys 0..T, T for a sample that misses
  if (tid == 0) {
    s_nf[0] = 0;
    s_nf[1] = INT_MAX;
    s_nf[2] = INT_MIN;
  }
  // this thread's positions kSortItems * tid + i of the sorted chunk: keys,
  // and which of them start a tick's run of hits
  unsigned key[kSortItems];
  unsigned head = 0u;
  // one chunk: a run is all of its tick's hits, so its head stores the
  // tick's mean itself; else the tile's totals are divided when written.
  // The general path gives one chunk the same bits, but at the week shape
  // (512 rows, M = 2048, T = 20,160) an H100 took 49.0 us a launch through
  // it against 38.0 us through this one (PERF.md §6)
  const bool final_runs = n_chunks == 1;
  for (int t = tid; t < min(a.tile, T); t += kSortThreads) {
    tile_total[t] = 0.0f;
    tile_count[t] = 0;
  }

  for (int lo = 0; lo < T; lo += a.tile) {
    const int tt = min(a.tile, T - lo);
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();   // the tile zeroed; the last chunk's runs added
      if (lo == 0 || n_chunks > 1) {
        const int m0 = c * kSortChunk + tid * kSortItems;
        float v[kSortItems], ts[kSortItems];
        bool ok[kSortItems];
        load_items<VEC>(vrow, trow, orow, m0, M, v, ts, ok);
        int nf_n = 0, nf_lo = INT_MAX, nf_hi = INT_MIN;
#pragma unroll
        for (int i = 0; i < kSortItems; ++i) {
          const bool in = m0 + i < M;
          const int k = in ? bucket_key(ts[i], ok[i], t0, a.tick_s, T) : -1;
          if (in && !finite(v[i])) {
            ++nf_n;
            nf_lo = min(nf_lo, k);
            nf_hi = max(nf_hi, k);
          }
          key[i] = static_cast<unsigned>(k >= 0 ? k : T);
        }
        if (lo == 0) {   // every sample once: the row's summary
          nf_n = __reduce_add_sync(kFull, nf_n);
          nf_lo = __reduce_min_sync(kFull, nf_lo);
          nf_hi = __reduce_max_sync(kFull, nf_hi);
          if ((tid & 31) == 0 && nf_n > 0) {
            atomicAdd(&s_nf[0], nf_n);
            atomicMin(&s_nf[1], nf_lo);
            atomicMax(&s_nf[2], nf_hi);
          }
        }
        Sort(sort_tmp).Sort(key, v, 0, end_bit);   // stable: M order kept
#pragma unroll
        for (int i = 0; i < kSortItems; ++i) {
          s_key[tid * kSortItems + i] = key[i];
          s_val[tid * kSortItems + i] = v[i];
        }
        __syncthreads();
        unsigned prev = tid > 0 ? s_key[tid * kSortItems - 1] : 0xffffffffu;
        head = 0u;
#pragma unroll
        for (int i = 0; i < kSortItems; ++i) {
          if (key[i] < static_cast<unsigned>(T) && key[i] != prev)
            head |= 1u << i;
          prev = key[i];
        }
        if (final_runs) {
          // one chunk: each run's mean and count, once, by its head, kept
          // in the run's first slot of s_val and s_key (the summary is
          // complete: its atomics came before the sort's barriers)
          const NonFinite nf = row_summary(s_nf);
          // a run is added in registers over the thread's own sorted
          // items, and read on from s_key/s_val only where it runs into
          // the next thread's (x / 1 is x: a run of one is not divided)
          const int p_next = (tid + 1) * kSortItems;
          const unsigned next_key =
              p_next < kSortChunk ? s_key[p_next] : 0xffffffffu;
          float run_mean[kSortItems];
          int run_n[kSortItems];
#pragma unroll
          for (int i = 0; i < kSortItems; ++i) {
            run_mean[i] = 0.0f;
            run_n[i] = 0;
            if (!((head >> i) & 1u)) continue;
            float total = __fadd_rn(0.0f, v[i]);
            int n = 1;
            bool on = true;
#pragma unroll
            for (int j = i + 1; j < kSortItems; ++j) {
              on = on && key[j] == key[i];
              if (on) {
                total = __fadd_rn(total, v[j]);
                ++n;
              }
            }
            if (on && next_key == key[i])
              for (int p = p_next; p < kSortChunk && s_key[p] == key[i];
                   ++p, ++n)
                total = __fadd_rn(total, s_val[p]);
            const float x = nf.total(static_cast<int>(key[i]), total);
            run_mean[i] = n == 1 ? x : __fdiv_rn(x, __int2float_rn(n));
            run_n[i] = n;
          }
          __syncthreads();   // every run read
#pragma unroll
          for (int i = 0; i < kSortItems; ++i) {
            if (!((head >> i) & 1u)) continue;
            s_val[tid * kSortItems + i] = run_mean[i];
            s_key[tid * kSortItems + i] = static_cast<unsigned>(run_n[i]);
          }
        }
      }
      // each tick's run of hits in this chunk, onto its total in M order
      // (one chunk: the run's mean, computed once above)
#pragma unroll
      for (int i = 0; i < kSortItems; ++i) {
        const int k = static_cast<int>(key[i]);
        if (!((head >> i) & 1u) || k < lo || k >= lo + tt) continue;
        if (final_runs) {
          tile_total[k - lo] = s_val[tid * kSortItems + i];
          tile_count[k - lo] = static_cast<int>(s_key[tid * kSortItems + i]);
          continue;
        }
        float total = tile_total[k - lo];
        int n = 0;
        for (int p = tid * kSortItems + i;
             p < kSortChunk && s_key[p] == key[i]; ++p, ++n)
          total = __fadd_rn(total, s_val[p]);
        tile_total[k - lo] = total;
        tile_count[k - lo] += n;
      }
    }
    __syncthreads();   // every run added; the row's summary complete
    const NonFinite nf = row_summary(s_nf);
    // out = count > 0 ? total / max(count, 1) : 0, the tile zeroed behind
    // for the next one (each thread reads and zeroes the same ticks)
    auto mean = [&](int t, float total, int count) {
      if (count == 0) return 0.0f;
      return final_runs ? total
                        : __fdiv_rn(nf.total(lo + t, total),
                                    fmaxf(__int2float_rn(count), 1.0f));
    };
    float* out_row = a.out + static_cast<long long>(r) * T + lo;
    uint8_t* obs_row = a.observed + static_cast<long long>(r) * T + lo;
    if (a.vec_out) {   // tt % 4 == 0: 16 bytes of means, 4 of flags
      for (int t = 4 * tid; t < tt; t += 4 * kSortThreads) {
        const float4 tot = *reinterpret_cast<const float4*>(tile_total + t);
        const int4 cnt = *reinterpret_cast<const int4*>(tile_count + t);
        *reinterpret_cast<float4*>(out_row + t) =
            make_float4(mean(t, tot.x, cnt.x), mean(t + 1, tot.y, cnt.y),
                        mean(t + 2, tot.z, cnt.z), mean(t + 3, tot.w, cnt.w));
        *reinterpret_cast<unsigned*>(obs_row + t) =
            (cnt.x > 0 ? 1u : 0u) | (cnt.y > 0 ? 1u << 8 : 0u) |
            (cnt.z > 0 ? 1u << 16 : 0u) | (cnt.w > 0 ? 1u << 24 : 0u);
        *reinterpret_cast<float4*>(tile_total + t) =
            make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<int4*>(tile_count + t) = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int t = tid; t < tt; t += kSortThreads) {
        const int count = tile_count[t];
        out_row[t] = mean(t, tile_total[t], count);
        obs_row[t] = count > 0 ? 1 : 0;
        tile_total[t] = 0.0f;
        tile_count[t] = 0;
      }
    }
    // the next tile's first chunk waits at its barrier before any run is
    // added to the zeroed tile
  }
}

// the tiled instance: one block per row, the staging tile as large as
// shared memory allows beside the kernel's own arrays when the row takes
// more than one sorted chunk, else kTile ticks
cudaError_t launch_tiled(const Args& base, bool vec, cudaStream_t stream) {
  auto kernel = vec ? harmonize_tiled_kernel<true>
                    : harmonize_tiled_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const int max_tile =
      static_cast<int>((kMaxSmem - attr.sharedSizeBytes) / 8 / 256 * 256);
  Args a = base;
  const int want = a.M > kSortChunk ? max_tile : kTile;
  a.tile = a.T < want ? a.T : want;
  a.vec_out = a.T % 4 == 0 && aligned16(a.out) &&
              reinterpret_cast<uintptr_t>(a.observed) % 4 == 0;
  const int bytes = 8 * a.tile;
  if (attr.sharedSizeBytes + bytes > 48 * 1024) {   // beyond the default
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.R, kSortThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// values/timestamps (E*S, M) float32, valid (E*S, M) bool, window_start
// (E,) float32 -> out (E*S, T) float32, observed (E*S, T) bool.
// impl: 0 = warp (T <= ops.MAX_T), 1 = tiled. vec: float4 loads, which
// need 16-byte aligned values, timestamps and valid, and M % 4 == 0.
extern "C" int harmonize_launch(const void* values, const void* timestamps,
                                const void* valid, const void* window_start,
                                void* out, void* observed, int E, int S,
                                int M, int T, float tick_s, int impl,
                                int vec, void* stream) {
  if (E <= 0 || S <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (vec && !(aligned16(values) && aligned16(timestamps) &&
               aligned16(valid) && M % 4 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(E) * S;
  if (rows >= (1ll << 31) || (impl != 0 && impl != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(values),
               static_cast<const float*>(timestamps),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(window_start),
               static_cast<float*>(out), static_cast<uint8_t*>(observed),
               static_cast<int>(rows), S, M, T, tick_s, T, 0};
  if (impl == 1)
    return static_cast<int>(
        launch_tiled(a, vec != 0, static_cast<cudaStream_t>(stream)));
  const int per_warp = warp_bytes(T, vec != 0);
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = per_warp * kWarpRows <= kMaxSmem ? kWarpRows
                                                     : kMaxSmem / per_warp;
  const int bytes = warps * per_warp;
  auto kernel = vec ? harmonize_warp_kernel<true>
                    : harmonize_warp_kernel<false>;
  if (bytes > 48 * 1024) {   // beyond the default: opt in (large T only)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((rows + warps - 1) / warps));
  kernel<<<grid, warps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
