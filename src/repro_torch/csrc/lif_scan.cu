// Fused fixed-point LIF/IF window scan with the CG shift-add leak.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lif_scan/lif_scan.py::lif_scan
// which keeps a [block_b, block_n] tile of membrane state in VMEM while the
// whole window streams through.  Here one thread owns one (b, n) neuron and
// keeps its membrane u in a register for all T steps, so device memory sees
// exactly one read of the current stream and one write of the spike raster;
// state never round-trips.  Per step t (identical to lif_scan_ref):
//
//   u   = sat(u + I[t])                       (u_bits register)
//   spk = u >= theta
//   u   = spk ? reset(u) : sat(sum of gated (u >> shift))   (k = 256: bypass)
//
// What bounds it: 4 bytes in and 4 bytes out per neuron-step against ~20-30
// int32 ops, far below the card's ops-per-byte balance, so it is bound by
// bytes (3.35 TB/s).  The design makes every access coalesced: thread p
// handles flat index p = b * N + n, so a warp reads currents[t, b, n..n+31]
// and writes spikes[t, b, n..n+31] as contiguous 128-byte lines, and the T
// loop walks them with stride B * N.
//
// theta, the decay code k (0..256), u_bits and the reset mode are runtime
// arguments (static in Pallas), so a threshold held in a tensor needs no
// fallback to the plain path.
//
// Arithmetic: u + I[t] and u - theta wrap mod 2**32 *before* the saturation
// in the JAX reference; signed overflow is undefined in C++, so both are
// computed in uint32_t and reinterpreted.  `>>` on a signed int is an
// arithmetic (sign-extending) shift under nvcc, which the leak relies on
// for negative u (-7 >> 1 == -4, floor semantics).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clamp(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
lif_scan_kernel(const int32_t* __restrict__ cur, int32_t* __restrict__ spikes,
                int32_t* __restrict__ u_final, int T, int BN, int theta, int decay_k,
                int qmin, int qmax, int reset_to_zero) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= BN) return;
  int32_t u = 0;
  for (int t = 0; t < T; ++t) {
    const size_t off = static_cast<size_t>(t) * BN + p;
    const int32_t v = clamp(wrap_add(u, cur[off]), qmin, qmax);
    const bool spk = v >= theta;
    const int32_t u_reset = reset_to_zero ? 0 : clamp(wrap_sub(v, theta), qmin, qmax);
    int32_t u_leak = v;  // k = 256: the IF bypass path
    if (decay_k < 256) {
      uint32_t acc = 0;
#pragma unroll
      for (int shift = 1; shift <= 8; ++shift) {
        if ((decay_k >> (8 - shift)) & 1) acc += static_cast<uint32_t>(v >> shift);
      }
      u_leak = clamp(static_cast<int32_t>(acc), qmin, qmax);
    }
    u = spk ? u_reset : u_leak;
    spikes[off] = spk ? 1 : 0;
  }
  u_final[p] = u;
}

}  // namespace

extern "C" int lif_scan_launch(const void* cur, void* spikes, void* u_final, int T, int BN,
                               int theta, int decay_k, int qmin, int qmax, int reset_to_zero,
                               void* stream) {
  if (BN > 0) {
    const int blocks = (BN + kThreads - 1) / kThreads;
    lif_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cur), static_cast<int32_t*>(spikes),
        static_cast<int32_t*>(u_final), T, BN, theta, decay_k, qmin, qmax, reset_to_zero);
  }
  return static_cast<int>(cudaGetLastError());
}
