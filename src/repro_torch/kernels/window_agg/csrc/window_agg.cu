// Fused window statistics + z-score spike mask, one pass per row.
//
// Replaces the TPU kernel src/repro/kernels/window_agg/kernel.py (_kernel,
// called through window_agg_pallas), which reduces (8, T_pad) row blocks in
// VMEM and stores the eight stats into a 128-lane block (the TPU's store
// width; 120 of the 128 lanes are padding).
//
// Output per row: stats[8] = [mean, var, min, max, last, count, sum,
// n_spikes] over the masked ticks, and spikes[T] = mask & (|v - mu| / sigma
// > k_sigma) against the carried (mu, var) of the row.
//
// Bound on Hopper: bytes. Per row it reads T floats + T bools + 2 floats
// and writes 8 floats + T bools; the arithmetic is a handful of adds per
// element. The (R, 8) output is written as it is, without the TPU's lane
// padding, which cuts the output bytes 16-fold.
//
// Design: one thread per row. Pass 1 accumulates n, sum, min, max and the
// last masked index; pass 2 computes var from the mean exactly as the TPU
// kernel does (sum of squared deviations over n, not Welford) and the
// spike mask. The second pass re-reads the row from L1. Adds and multiplies
// are written with __fadd_rn / __fmul_rn so nvcc cannot contract them into
// FMAs: the kernel then rounds exactly like a sequential float32 loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStats = 8;

__global__ void window_agg_kernel(const float* __restrict__ values,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ state_mean,
                                  const float* __restrict__ state_var,
                                  float* __restrict__ stats,
                                  uint8_t* __restrict__ spikes, int R, int T,
                                  float k_sigma) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long base = static_cast<long long>(r) * T;
  const float big = 3.4e38f;

  float n = 0.0f, s = 0.0f, vmin = big, vmax = -big, last = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (mask[base + t]) {
      const float v = values[base + t];
      n = __fadd_rn(n, 1.0f);
      s = __fadd_rn(s, v);
      vmin = fminf(vmin, v);
      vmax = fmaxf(vmax, v);
      last = v;
    }
  }
  const float mean = __fdiv_rn(s, fmaxf(n, 1.0f));

  const float mu = state_mean[r];
  const float sigma = sqrtf(fmaxf(state_var[r], 1e-12f));
  float ss = 0.0f, n_spikes = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float v = values[base + t];
    const bool m = mask[base + t] != 0;
    uint8_t spike = 0;
    if (m) {
      const float d = __fsub_rn(v, mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
      spike = __fdiv_rn(fabsf(__fsub_rn(v, mu)), sigma) > k_sigma;
      n_spikes = __fadd_rn(n_spikes, spike ? 1.0f : 0.0f);
    }
    spikes[base + t] = spike;
  }

  float* out = stats + static_cast<long long>(r) * kStats;
  const bool any = n > 0.0f;
  out[0] = mean;
  out[1] = __fdiv_rn(ss, fmaxf(n, 1.0f));
  out[2] = any ? vmin : 0.0f;
  out[3] = any ? vmax : 0.0f;
  out[4] = last;
  out[5] = n;
  out[6] = s;
  out[7] = n_spikes;
}

}  // namespace

extern "C" int window_agg_launch(const void* values, const void* mask,
                                 const void* state_mean,
                                 const void* state_var, void* stats,
                                 void* spikes, int R, int T, float k_sigma,
                                 void* stream) {
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  if (blocks > 0) {
    window_agg_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(state_mean),
        static_cast<const float*>(state_var), static_cast<float*>(stats),
        static_cast<uint8_t*>(spikes), R, T, k_sigma);
  }
  return static_cast<int>(cudaGetLastError());
}
