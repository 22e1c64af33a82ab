// LOCF gap filling: carry the latest observation forward along T.
//
// Replaces the TPU kernel src/repro/kernels/locf/kernel.py (_kernel, called
// through locf_pallas), which walks T with the carry in vector registers
// over (8, T) row blocks in VMEM.
//
// Bound on Hopper: bytes. Per (row, tick) it reads a float and a bool and
// writes a float and a bool (10 bytes) and does no arithmetic at all: the
// output is pure selection, so it is bit-exact against any other LOCF
// wherever `has` is true.
//
// Design: one thread per row keeps (value, has) in registers and walks T
// once, so every input byte is read once and every output byte written
// once. On the decision path R = E*S rows with T = n_ticks (a few ticks),
// so a launch is dominated by its fixed cost, not by its bytes; at fleet
// size (R = 32768, T = 64) the row-strided walk leaves coalescing on the
// table, which a warp-per-row-block layout would recover in a later step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void locf_kernel(const float* __restrict__ values,
                            const uint8_t* __restrict__ observed,
                            const float* __restrict__ init_value,
                            const uint8_t* __restrict__ init_has,
                            float* __restrict__ out,
                            uint8_t* __restrict__ has,
                            int R, int T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long base = static_cast<long long>(r) * T;
  float cv = init_value[r];
  uint8_t ch = init_has[r] ? 1 : 0;
  for (int t = 0; t < T; ++t) {
    if (observed[base + t]) {
      cv = values[base + t];
      ch = 1;
    }
    out[base + t] = cv;
    has[base + t] = ch;
  }
}

}  // namespace

extern "C" int locf_launch(const void* values, const void* observed,
                           const void* init_value, const void* init_has,
                           void* out, void* has, int R, int T, void* stream) {
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  if (blocks > 0) {
    locf_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values),
        static_cast<const uint8_t*>(observed),
        static_cast<const float*>(init_value),
        static_cast<const uint8_t*>(init_has), static_cast<float*>(out),
        static_cast<uint8_t*>(has), R, T);
  }
  return static_cast<int>(cudaGetLastError());
}
