// Fixed-capacity sparse event accumulation (the AER scatter of phase A):
//   out[e, :] = sum_j vals[e, j] * w[idx[e, j], :]     (zero-valued slots skipped)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sparse_accum/sparse_accum.py::sparse_accum
// whose program instances walk their [be, K] event slots in order and
// read-modify-write output rows in VMEM.  Here one block owns kRows event
// rows x kCols output columns; its rows' (value, channel) slots are staged
// through shared memory kSlots at a time, and each thread owns one output
// column, keeping the kRows partial sums in registers.  Every thread of a
// block reads the same slot, so the `v != 0` skip is uniform (no
// divergence) and a warp's weight reads w[c, col..col+31] are one coalesced
// line.  Work tracks real traffic: padding slots cost a shared-memory read.
//
// What bounds it: the event lists are 2 * E * K int32 and the output E * N
// int32; the weight table (n_in x N int32, 128 KB at 256 x 128) stays in L2.
// At the serving shape (E = 2048 rows, K = 64 slots, N = 128) that is about
// 2 MB, so the bound is bytes at 3.35 TB/s.  This first version is limited
// instead by latency: such a small E makes only 128 blocks, under one wave
// on 132 SMs, and each thread walks its rows' slots one after another.
//
// Arithmetic: exact int32 with the dense matmul's wraparound -- products and
// sums in uint32_t (mod 2**32, defined in C++), reinterpreted as int32 at
// the end.  A channel outside [0, n_in) is clamped (as a jnp gather clamps)
// so a malformed list can never read out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // event rows per block
constexpr int kCols = 128;  // output columns per block, one per thread
constexpr int kSlots = 64;  // event slots staged per pass

__global__ void __launch_bounds__(kCols)
sparse_accum_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ w, int32_t* __restrict__ out, int E, int K,
                    int n_in, int N) {
  __shared__ int32_t v_tile[kRows][kSlots];
  __shared__ int32_t c_tile[kRows][kSlots];

  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  uint32_t acc[kRows] = {};

  for (int j0 = 0; j0 < K; j0 += kSlots) {
    for (int i = threadIdx.x; i < kRows * kSlots; i += kCols) {
      const int r = i / kSlots, j = i % kSlots;
      const int e = row0 + r, jj = j0 + j;
      const bool ok = e < E && jj < K;
      v_tile[r][j] = ok ? vals[static_cast<size_t>(e) * K + jj] : 0;
      c_tile[r][j] = ok ? idx[static_cast<size_t>(e) * K + jj] : 0;
    }
    __syncthreads();
    if (col < N) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        for (int j = 0; j < kSlots; ++j) {
          const int32_t v = v_tile[r][j];
          if (v != 0) {
            const int c = min(max(c_tile[r][j], 0), n_in - 1);
            acc[r] += static_cast<uint32_t>(v) *
                      static_cast<uint32_t>(__ldg(&w[static_cast<size_t>(c) * N + col]));
          }
        }
      }
    }
    __syncthreads();
  }

  if (col < N) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < E) out[static_cast<size_t>(row0 + r) * N + col] = static_cast<int32_t>(acc[r]);
    }
  }
}

}  // namespace

extern "C" int sparse_accum_launch(const void* vals, const void* idx, const void* w, void* out,
                                   int E, int K, int n_in, int N, void* stream) {
  if (E > 0 && N > 0) {
    const dim3 grid((N + kCols - 1) / kCols, (E + kRows - 1) / kRows);
    sparse_accum_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(vals), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(w), static_cast<int32_t*>(out), E, K, n_in, N);
  }
  return static_cast<int>(cudaGetLastError());
}
