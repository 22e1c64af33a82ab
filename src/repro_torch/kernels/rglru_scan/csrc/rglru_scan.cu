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
// is the launch's fixed cost and the few instructions before the first
// load. At long T few threads exist (one per channel) and each step's loads
// would wait a full memory round trip.
//
// Design: no thread divides, and all index math is 32-bit (the wrapper
// keeps B*T*W below 2^31). When W % 4 == 0 and the pointers are 16-byte
// aligned, each thread owns 4 consecutive channels (float4 loads and
// stores); otherwise one.
//   * T = 1 (the decision path): the flat (b, w) index is the element's
//     offset, so the kernel is one elementwise step over 128-thread blocks.
//     The T > 1 kernel below, run at T = 1, lost to one torch.addcmul by
//     half a microsecond: its unrolled look-ahead costs code and registers
//     even when there is one step (PERF.md).
//   * T > 1: a 2-D launch of one-warp blocks, threads over W and
//     blockIdx.y over groups of batch rows (one-warp blocks spread the few
//     channel threads over every SM). Over T, a thread loads a and b for
//     the next kAhead steps into registers before it runs their updates, so
//     kAhead round trips overlap.
// The updates stay in order, each
// __fadd_rn(__fmul_rn(a, h), b), which nvcc may not contract into an FMA:
// the kernel equals the plain `a * h + b` of PyTorch bit for bit. (A chunked
// parallel scan would reassociate the recurrence and lose that.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAhead = 16;   // steps whose loads are in flight together

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}
__device__ __forceinline__ float4 step(float4 a, float4 h, float4 b) {
  return make_float4(step(a.x, h.x, b.x), step(a.y, h.y, b.y),
                     step(a.z, h.z, b.z), step(a.w, h.w, b.w));
}

// T = 1: one step per element, n = B * W in units of V
template <typename V>
__global__ void __launch_bounds__(128)
rglru_step_kernel(const V* __restrict__ a, const V* __restrict__ b,
                  const V* __restrict__ h0, V* __restrict__ hs,
                  V* __restrict__ h_last, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V h = step(a[i], h0[i], b[i]);
  hs[i] = h;
  h_last[i] = h;
}

// V is float (one channel a thread) or float4 (four); n = W / (channels a
// thread), the row length in units of V
template <typename V>
__global__ void __launch_bounds__(32)
rglru_scan_kernel(const V* __restrict__ a, const V* __restrict__ b,
                  const V* __restrict__ h0, V* __restrict__ hs,
                  V* __restrict__ h_last, int B, int T, int n) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y * blockDim.y + threadIdx.y;
  if (w >= n || bi >= B) return;
  const int row = bi * n + w;
  int off = bi * T * n + w;   // (bi, t, w) at off + t * n
  V h = h0[row];
  for (int t0 = 0; t0 < T; t0 += kAhead, off += kAhead * n) {
    V ra[kAhead], rb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < T) {
        ra[u] = a[off + u * n];
        rb[u] = b[off + u * n];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < T) {
        h = step(ra[u], h, rb[u]);
        hs[off + u * n] = h;
      }
    }
  }
  h_last[row] = h;
}

template <typename V>
cudaError_t launch(const void* a, const void* b, const void* h0, void* hs,
                   void* h_last, int B, int T, int n, cudaStream_t stream) {
  if (T == 1) {
    rglru_step_kernel<V><<<(B * n + 127) / 128, 128, 0, stream>>>(
        static_cast<const V*>(a), static_cast<const V*>(b),
        static_cast<const V*>(h0), static_cast<V*>(hs),
        static_cast<V*>(h_last), B * n);
    return cudaGetLastError();
  }
  int tx = 1;
  while (tx < n && tx < 32) tx *= 2;            // threads over the row
  const int ty = 32 / tx;                       // batch rows per block
  const dim3 block(tx, ty);
  const dim3 grid((n + tx - 1) / tx, (B + ty - 1) / ty);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  rglru_scan_kernel<V><<<grid, block, 0, stream>>>(
      static_cast<const V*>(a), static_cast<const V*>(b),
      static_cast<const V*>(h0), static_cast<V*>(hs), static_cast<V*>(h_last),
      B, T, n);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* hs, void* h_last, int B, int T, int W,
                                 void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(B) * T * W >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(h0) && aligned16(hs) && aligned16(h_last);
  const cudaError_t err =
      vec ? launch<float4>(a, b, h0, hs, h_last, B, T, W / 4, st)
          : launch<float>(a, b, h0, hs, h_last, B, T, W, st);
  return static_cast<int>(err);
}
