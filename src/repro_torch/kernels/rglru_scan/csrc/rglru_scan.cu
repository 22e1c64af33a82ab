// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, T, W).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py (_kernel,
// called through rglru_scan_pallas), which gives each grid instance a
// (T, 128) channel stripe in VMEM (W padded to 128 lanes) and walks T with
// a fori_loop.
//
// Bound on Hopper: bytes. Per (b, t, w) it reads a and b and writes h (12
// bytes) for one multiply and one add. On the decision path B = n_envs,
// T = 1 and W = hidden (16): one launch moves a few tens of KB, so its time
// is the launch's fixed cost.
//
// Design: one thread per (b, w) channel, sequential over T with h in a
// register; neighbouring threads own neighbouring w, so every load and
// store of a step is coalesced. No lane padding: W is any width. The update
// is __fadd_rn(__fmul_rn(a, h), b), which nvcc may not contract into an
// FMA, so the kernel equals the plain `a * h + b` of PyTorch (two rounded
// operations) bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ h0,
                                  float* __restrict__ hs,
                                  float* __restrict__ h_last, int B, int T,
                                  int W) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * W) return;
  const long long bi = i / W;
  const long long w = i % W;
  float h = h0[i];
  for (int t = 0; t < T; ++t) {
    const long long off = (bi * T + t) * W + w;
    h = __fadd_rn(__fmul_rn(a[off], h), b[off]);
    hs[off] = h;
  }
  h_last[i] = h;
}

}  // namespace

extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* hs, void* h_last, int B, int T, int W,
                                 void* stream) {
  const int threads = 256;
  const long long n = static_cast<long long>(B) * W;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    rglru_scan_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(hs),
        static_cast<float*>(h_last), B, T, W);
  }
  return static_cast<int>(cudaGetLastError());
}
