// Fused bucketize + per-tick mean: raw (E*S, M) samples -> (E*S, T) tick
// means and an observed mask.
//
// Replaces the TPU kernel src/repro/kernels/harmonize/kernel.py (_kernel,
// called through harmonize_pallas), which keeps (8, T) accumulators in VMEM
// and walks M with a fori_loop so HBM sees only the (R, M) inputs and the
// (R, T) outputs.
//
// Bound on Hopper: bytes. Per row it reads M floats of values, M of
// timestamps and M valid bytes and writes T floats and T bytes; the work is
// a compare and two adds per (sample, tick), far under the flops-per-byte
// line.
//
// Design: one thread per (row, tick) walks the row's M samples and keeps
// its tick's (total, count) in registers, so nothing but the inputs and
// outputs touches device memory. The T threads of one row read the same
// addresses, which the warp serves as broadcasts. The arithmetic is the
// TPU kernel's, in its order: the bucket is ceil((ts - t0) / tick_s) - 1
// with IEEE division and ceilf (no fast math), the sums are added in M
// order, the hit weight is multiplied into the value (total += h * v, not a
// branch, so a NaN in an invalid slot propagates as in both JAX versions),
// and out = observed ? total / max(count, 1) : 0. Every add and multiply is
// written _rn so nothing is contracted into an FMA. t0 is the row's env's
// window start (one per env, broadcast over its S streams). No 8-row
// padding: that was the TPU's block shape.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void harmonize_kernel(const float* __restrict__ values,
                                 const float* __restrict__ timestamps,
                                 const uint8_t* __restrict__ valid,
                                 const float* __restrict__ window_start,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ observed, int R, int S,
                                 int M, int T, float tick_s) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(R) * T) return;
  const int r = static_cast<int>(i / T);
  const int t = static_cast<int>(i - static_cast<long long>(r) * T);
  const float t0 = window_start[r / S];
  const long long base = static_cast<long long>(r) * M;
  float total = 0.f, count = 0.f;
  for (int m = 0; m < M; ++m) {
    const float rel = __fsub_rn(timestamps[base + m], t0);
    const int idx = static_cast<int>(ceilf(__fdiv_rn(rel, tick_s))) - 1;
    const bool ok = valid[base + m] != 0 && idx >= 0 && idx < T;
    const float h = (ok && idx == t) ? 1.f : 0.f;
    total = __fadd_rn(total, __fmul_rn(h, values[base + m]));
    count = __fadd_rn(count, h);
  }
  const bool obs = count > 0.f;
  out[i] = obs ? __fdiv_rn(total, fmaxf(count, 1.f)) : 0.f;
  observed[i] = obs ? 1 : 0;
}

}  // namespace

// values/timestamps (E*S, M) float32, valid (E*S, M) bool, window_start
// (E,) float32 -> out (E*S, T) float32, observed (E*S, T) bool.
extern "C" int harmonize_launch(const void* values, const void* timestamps,
                                const void* valid, const void* window_start,
                                void* out, void* observed, int E, int S,
                                int M, int T, float tick_s, void* stream) {
  const int R = E * S;
  const long long n = static_cast<long long>(R) * T;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    harmonize_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values),
        static_cast<const float*>(timestamps),
        static_cast<const uint8_t*>(valid),
        static_cast<const float*>(window_start), static_cast<float*>(out),
        static_cast<uint8_t*>(observed), R, S, M, T, tick_s);
  }
  return static_cast<int>(cudaGetLastError());
}
