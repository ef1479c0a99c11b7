// Exact int32 spike x quantized-weight product: out[M, N] = s[M, K] @ w[K, N].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/quant_matmul/spike_matmul.py::spike_matmul
// (grid (M/bm, N/bn, K/bk) with an int32 VMEM accumulator carried across
// the sequential K grid axis).  On Hopper the blocks run in parallel and in
// no order, so the K loop moves inside the block and nothing is carried
// between blocks.
//
// What bounds it: at the main path's shapes ([25*1024, 256] x [256, 128])
// the kernel reads ~26 MB of int32 spikes and writes ~13 MB of currents;
// the same product on the int8 tensor cores would be limited by those bytes
// (3.35 TB/s).  This first version does the multiply-adds on the CUDA cores
// (int32 IMAD, ~33.5 TOP/s), so it is bound by operations: 1.7 G int ops.
// The design keeps the CUDA-core version simple and correct: 64 x 64 output
// tiles per block, 16-deep stages of s and w through shared memory, each
// thread owning a 4 x 4 patch of the tile so every shared-memory value feeds
// four multiply-adds.  Ragged M / N / K edges are masked with zeros, so any
// shape works (the JAX wrapper falls back to einsum where shapes do not
// tile; this kernel needs no fallback).
//
// Arithmetic: the JAX product wraps mod 2**32.  Signed overflow is undefined
// in C++, so the accumulators are uint32_t (mod-2**32 by definition) and the
// result is reinterpreted as int32 -- bit-identical to the wrapping int32
// matmul for any inputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 16;         // depth of one shared-memory stage
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 output patch

__global__ void __launch_bounds__(kThreads)
spike_matmul_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ w,
                    int32_t* __restrict__ out, int M, int K, int N) {
  // s tile stored transposed ([k][row]) so a thread's four rows are one
  // broadcast read per k; +1 column breaks the store-side bank conflicts.
  __shared__ uint32_t s_tile[kBK][kBM + 1];
  __shared__ uint32_t w_tile[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  uint32_t acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gc = k0 + c;
      s_tile[c][r] = (gr < M && gc < K)
                         ? static_cast<uint32_t>(s[static_cast<size_t>(gr) * K + gc])
                         : 0u;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      w_tile[r][c] = (gr < K && gc < N)
                         ? static_cast<uint32_t>(w[static_cast<size_t>(gr) * N + gc])
                         : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = s_tile[kk][ty * 4 + m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = w_tile[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] += a[m] * b[n];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int gr = row0 + ty * 4 + m;
    if (gr >= M) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int gc = col0 + tx + 16 * n;
      if (gc < N) out[static_cast<size_t>(gr) * N + gc] = static_cast<int32_t>(acc[m][n]);
    }
  }
}

}  // namespace

extern "C" int spike_matmul_launch(const void* s, const void* w, void* out, int M, int K,
                                   int N, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    spike_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(s), static_cast<const int32_t*>(w),
        static_cast<int32_t*>(out), M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
