// Fixed-capacity sparse event accumulation (the AER scatter of phase A):
//   out[e, :] = sum_j vals[e, j] * w[idx[e, j], :]     (zero-valued slots skipped)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sparse_accum/sparse_accum.py::sparse_accum
// whose program instances walk their [be, K] event slots in order and
// read-modify-write output rows in VMEM.
//
// What bounds it: the event lists are 2 * E * K int32 and the output E * N
// int32; the weight table (n_in x N int32, 128 KB at 256 x 128) stays in L1
// and L2.  At the serving shape (E = 2048 rows, K = 64 slots, N = 128) that
// is about 2 MB, so the bound is bytes at 3.35 TB/s (under a microsecond,
// less than a launch's ramp); the first version (a thread per output column,
// 16 rows a block walking 16 x 64 slots in series, every slot a shared-memory
// read then a dependent weight load) was a chain of latencies on 128 blocks.
// What the byte bound leaves out: every event gathers a whole weight row, so
// at E = 25600 (~30 events a row) some 400 MB of rows pass through L1.
//
// Design: one warp owns one event row, 8 warps a block, and the grid runs
// over rows on grid.x, so E has no grid limit and E = 2048 gives 256 blocks,
// all resident at once.  The warp reads 32 slots of vals and idx with one
// coalesced load each (the next 32 are already in flight), takes
// __ballot_sync(v != 0) and walks only the set bits, in slot order,
// broadcasting each event's value and weight-row offset with __shfl_sync:
// zero slots cost nothing wherever they lie, and nothing assumes the list is
// sorted.  The warp's two 16-lane halves take the two lowest set slots of
// each step, so each shuffle, load and multiply-add instruction serves two
// events; a lane owns 8 output columns (two 16-byte loads of a weight row of
// N = 128, 256 bytes a half-warp), and at the end the halves' sums are added
// with one shuffle.  Two steps go at once, so that four independent
// weight-row loads are in flight.  N that is not a multiple of 4 takes
// scalar loads and stores, and N wider than 128 loops over 128-column
// chunks.  On the H100 the event walk -- shuffles and address arithmetic,
// not the weight loads -- bounds it (PERF.md): with the loads removed the
// first design took as long.
//
// Arithmetic: exact int32 with the dense matmul's wraparound -- products and
// sums in uint32_t (mod 2**32, defined in C++), reinterpreted as int32 at
// the end.  A channel outside [0, n_in) is clamped (as a jnp gather clamps)
// so a malformed list can never read out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // event rows per block, one a warp
constexpr int kCols = 128;               // output columns a warp covers per pass
constexpr int kGroup = 16;               // lanes that share one event
constexpr int kSub = 32 / kGroup;        // events a warp takes at once, one a group
constexpr int kPer = kCols / kGroup;     // output columns a lane owns (a multiple of 4)
constexpr int kBatch = 2;                // steps whose weight rows are loaded together

// The lane's kPer columns of one weight row, zero past N.
__device__ __forceinline__ void load_row(uint32_t (&r)[kPer], const int32_t* __restrict__ row,
                                         int col, int N, bool vec) {
  if (vec) {  // N % 4 == 0: col + 4q < N implies col + 4q + 3 < N
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 v = col + 4 * q < N ? __ldg(reinterpret_cast<const int4*>(row + col + 4 * q))
                                     : make_int4(0, 0, 0, 0);
      r[4 * q] = static_cast<uint32_t>(v.x);
      r[4 * q + 1] = static_cast<uint32_t>(v.y);
      r[4 * q + 2] = static_cast<uint32_t>(v.z);
      r[4 * q + 3] = static_cast<uint32_t>(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      r[i] = col + i < N ? static_cast<uint32_t>(__ldg(row + col + i)) : 0u;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
sparse_accum_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ w, int32_t* __restrict__ out, int E, int K,
                    int n_in, int N, bool vec) {
  const int lane = threadIdx.x % 32, sub = lane / kGroup;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (e >= E) return;  // the whole warp
  const int32_t* v_row = vals + e * K;
  const int32_t* c_row = idx + e * K;
  int32_t* o_row = out + e * N;

  for (int n0 = 0; n0 < N; n0 += kCols) {
    const int col = n0 + kPer * (lane % kGroup);
    uint32_t acc[kPer] = {};
    int32_t v = lane < K ? __ldg(v_row + lane) : 0;
    int32_t c = lane < K ? __ldg(c_row + lane) : 0;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int jn = j0 + 32 + lane;
      const int32_t v_next = jn < K ? __ldg(v_row + jn) : 0;
      const int32_t c_next = jn < K ? __ldg(c_row + jn) : 0;
      // each slot's weight-row offset, its channel clamped into [0, n_in)
      const uint32_t off =
          static_cast<uint32_t>(min(max(c, 0), n_in - 1)) * static_cast<uint32_t>(N);
      uint32_t live = __ballot_sync(0xffffffffu, v != 0);
      while (live) {  // warp-uniform
        uint32_t ev[kBatch], wo[kBatch];  // value and weight-row offset; value 0: no event
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          // the kSub lowest set slots, in slot order, one to each group
          int src = 0;
          bool mine = false;
#pragma unroll
          for (int h = 0; h < kSub; ++h) {
            if (live) {
              if (sub == h) {
                src = __ffs(live) - 1;
                mine = true;
              }
              live &= live - 1;
            }
          }
          const uint32_t ve = static_cast<uint32_t>(__shfl_sync(0xffffffffu, v, src));
          wo[b] = __shfl_sync(0xffffffffu, off, src);
          ev[b] = mine ? ve : 0u;
        }
        uint32_t rows[kBatch][kPer];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (ev[b] != 0u) {
            load_row(rows[b], w + wo[b], col, N, vec);
          } else {
#pragma unroll
            for (int i = 0; i < kPer; ++i) rows[b][i] = 0u;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] += ev[b] * rows[b][i];
        }
      }
      v = v_next;
      c = c_next;
    }
    // the groups' partial sums of the same columns, added into group 0
#pragma unroll
    for (int o = 16; o >= kGroup; o /= 2) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += __shfl_down_sync(0xffffffffu, acc[i], o);
    }
    if (sub == 0) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
          if (col + 4 * q < N) {
            *reinterpret_cast<int4*>(o_row + col + 4 * q) =
                make_int4(static_cast<int32_t>(acc[4 * q]), static_cast<int32_t>(acc[4 * q + 1]),
                          static_cast<int32_t>(acc[4 * q + 2]),
                          static_cast<int32_t>(acc[4 * q + 3]));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (col + i < N) o_row[col + i] = static_cast<int32_t>(acc[i]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int sparse_accum_launch(const void* vals, const void* idx, const void* w, void* out,
                                   int E, int K, int n_in, int N, void* stream) {
  if (E > 0 && N > 0) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec = N % 4 == 0 && aligned(w) && aligned(out);
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(E) + kWarps - 1) / kWarps);
    sparse_accum_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(vals), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(w), static_cast<int32_t*>(out), E, K, n_in, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
