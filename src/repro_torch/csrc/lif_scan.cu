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
// theta, the decay register, u_bits and the reset mode are runtime
// arguments (static in Pallas), so a threshold held in a tensor needs no
// fallback to the plain path.
//
// A candidate axis (the population sweep of the design-space exploration):
// P windows [P, T, B, N] in one launch, blockIdx.y the candidate, each with
// its own theta and 9-bit decay register read from device arrays (theta_p,
// k_p) -- quantization scales theta by a factor that depends on the
// candidate's weight width, and the leak taps on its leak_bits, so both
// differ per candidate; reading them on the device needs no host sync.  A
// register of 256 or more is the bypass (bit 8), as apply_decay_traced
// reads it.  u_bits and the reset mode are static across a population.  A
// single window is the case P = 1.
//
// ataf_scan_kernel: the same scan for an ATA-F (self-feedback) IF/LIF layer
// of the population sweep, whose step adds the neuron's own previous spike
// times the candidate's self-weight (int32 [P], read on the device like
// theta) to I[t].  It replaces no TPU kernel: JAX steps ATA-F with jnp
// under vmap; it was added because the port's step loop launched dozens of
// elementwise kernels a step over [P, B, N] (the leak's gated taps alone
// take five a tap).  Bound by bytes as lif_scan_kernel is (one read of the
// currents, one write of the spikes), with the same thread-per-neuron,
// coalesced design.  It is a kernel of its own, so lif_scan_kernel compiles
// as it did (the same SASS).
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
                int32_t* __restrict__ u_final, int T, int BN,
                const int32_t* __restrict__ theta_p, const int32_t* __restrict__ k_p,
                int qmin, int qmax, int reset_to_zero) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= BN) return;
  const size_t c = blockIdx.y;  // the candidate
  const int32_t theta = theta_p[c];
  const int32_t decay_k = k_p[c];
  cur += c * T * BN;
  spikes += c * T * BN;
  u_final += c * BN;
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

// The CG shift-add leak of a saturated membrane v: the sum of v >> shift
// over the taps set in the 9-bit register, saturated; 256 and above is the
// IF bypass.  lif_scan_kernel keeps these lines inline: called through this
// helper it compiled to other SASS under nvcc 12.8, and ran 6-8 % further
// from its bound in the population sweep.
__device__ __forceinline__ int32_t cg_leak(int32_t v, int32_t decay_k, int qmin, int qmax) {
  int32_t u_leak = v;  // k = 256: the IF bypass path
  if (decay_k < 256) {
    uint32_t acc = 0;
#pragma unroll
    for (int shift = 1; shift <= 8; ++shift) {
      if ((decay_k >> (8 - shift)) & 1) acc += static_cast<uint32_t>(v >> shift);
    }
    u_leak = clamp(static_cast<int32_t>(acc), qmin, qmax);
  }
  return u_leak;
}

// lif_scan_kernel's step with the ATA-F layer's self-feedback: the previous
// step's own spike times the candidate's self-weight joins the step's
// current (a select, since a spike is 0 or 1), both adds wrapping before
// the saturation as _integrate_acc and saturate do in int32.  The membrane
// and the previous spike stay in registers for all T steps; only the spikes
// are written (the sweep reads no final membrane).
__global__ void __launch_bounds__(kThreads)
ataf_scan_kernel(const int32_t* __restrict__ cur, int32_t* __restrict__ spikes, int T, int BN,
                 const int32_t* __restrict__ w_p, const int32_t* __restrict__ theta_p,
                 const int32_t* __restrict__ k_p, int qmin, int qmax, int reset_to_zero) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= BN) return;
  const size_t c = blockIdx.y;  // the candidate
  const int32_t w_self = w_p[c];
  const int32_t theta = theta_p[c];
  const int32_t decay_k = k_p[c];
  cur += c * T * BN;
  spikes += c * T * BN;
  int32_t u = 0;
  bool prev = false;
  for (int t = 0; t < T; ++t) {
    const size_t off = static_cast<size_t>(t) * BN + p;
    const int32_t acc = wrap_add(cur[off], prev ? w_self : 0);
    const int32_t v = clamp(wrap_add(u, acc), qmin, qmax);
    const bool spk = v >= theta;
    const int32_t u_reset = reset_to_zero ? 0 : clamp(wrap_sub(v, theta), qmin, qmax);
    const int32_t u_leak = cg_leak(v, decay_k, qmin, qmax);
    u = spk ? u_reset : u_leak;
    spikes[off] = spk ? 1 : 0;
    prev = spk;
  }
}

}  // namespace

// P candidates' windows [P, T, B, N] (BN = B * N) in one launch: theta and
// the decay register of candidate c are theta_p[c] and k_p[c] (int32 [P] on
// the device).
extern "C" int lif_scan_launch(const void* cur, void* spikes, void* u_final, const void* theta_p,
                               const void* k_p, int P, int T, int BN, int qmin, int qmax,
                               int reset_to_zero, void* stream) {
  if (P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (BN > 0 && P > 0) {
    const dim3 grid((BN + kThreads - 1) / kThreads, P);
    lif_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cur), static_cast<int32_t*>(spikes),
        static_cast<int32_t*>(u_final), T, BN, static_cast<const int32_t*>(theta_p),
        static_cast<const int32_t*>(k_p), qmin, qmax, reset_to_zero);
  }
  return static_cast<int>(cudaGetLastError());
}

// P candidates' ATA-F windows [P, T, B, N] (BN = B * N) in one launch, the
// spikes only: candidate c's self-weight, theta and decay register are
// w_p[c], theta_p[c] and k_p[c] (int32 [P] on the device).
extern "C" int ataf_scan_launch(const void* cur, void* spikes, const void* w_p, const void* theta_p,
                                const void* k_p, int P, int T, int BN, int qmin, int qmax,
                                int reset_to_zero, void* stream) {
  if (P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (BN > 0 && P > 0) {
    const dim3 grid((BN + kThreads - 1) / kThreads, P);
    ataf_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(cur), static_cast<int32_t*>(spikes), T, BN,
        static_cast<const int32_t*>(w_p), static_cast<const int32_t*>(theta_p),
        static_cast<const int32_t*>(k_p), qmin, qmax, reset_to_zero);
  }
  return static_cast<int>(cudaGetLastError());
}
