// Activation x quantized-weight matmul: out[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/quant_matmul/quant_matmul.py::quant_matmul
// (_kernel_int8 / _kernel_int4: grid (M/bm, N/bn, K/bk) with an f32 VMEM
// accumulator carried across the sequential K grid axis, the per-column
// scale applied in the last K step).  On Hopper the blocks run in parallel
// and in no order, so the K loop moves inside the block and nothing is
// carried between blocks.
//
// Numerics (the contract of ref.py): x (bf16 or f32) and the integer
// weights are widened to f32, multiplied and summed in an f32 accumulator,
// the per-output-column scale is applied once in the epilogue, and the
// result is rounded to the output type (bf16 round-to-nearest-even with
// __float2bfloat16_rn, or f32).  Weights are int8-class (bits 5..8, one
// int8 per value) or packed int4 (two sign-extended nibbles per int8, the
// low nibble holding the even column), selected at run time.
//
// What bounds it on the H100: at decode (M = batch = 8) the kernel reads
// every weight byte once for a handful of multiply-adds per byte, so it is
// bound by bytes (3.35 TB/s); at prefill (M = 4096) it is bound by
// operations.  This first version multiplies on the CUDA cores in f32
// (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s bf16), so at
// prefill it sits far above the bf16 bound.  Every int8 (and int4) weight
// is exactly representable in bf16, so a later mma.sync / wgmma version can
// feed the raw weights to the bf16 tensor cores and keep the same products;
// only the summation order would change.
//
// Design: 64 x 64 output tiles per block, 256 threads each owning a 4 x 4
// patch, 32-deep stages of x and w through shared memory (widened to f32 on
// the way in, int4 unpacked there), the next stage's global loads issued
// into registers before the current stage's multiply-adds so that their
// latency overlaps.  Ragged M / N / K edges are masked with zeros, so any
// shape works.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;                       // 16 x 16, each a 4 x 4 patch
constexpr int kXPerThread = kBM * kBK / kThreads;   // 8
constexpr int kWPerThread = kBK * kBN / kThreads;   // 8

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Weight (k, n) as a float: int8 value, or the sign-extended nibble of the
// packed byte q[k, n / 2] (low nibble = even column).
template <bool kInt4>
__device__ __forceinline__ float load_w(const int8_t* __restrict__ q, int k, int n, int N) {
  if (kInt4) {
    const uint8_t byte = static_cast<uint8_t>(q[static_cast<size_t>(k) * (N / 2) + n / 2]);
    int v = (n & 1) ? (byte >> 4) : (byte & 0xF);
    v = v >= 8 ? v - 16 : v;
    return static_cast<float>(v);
  }
  return static_cast<float>(q[static_cast<size_t>(k) * N + n]);
}

template <typename TX, typename TO, bool kInt4>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, TO* __restrict__ out, int M, int K, int N) {
  // x stage stored transposed ([k][row]) so a thread's four rows are one
  // broadcast read per k; +1 column breaks the store-side bank conflicts.
  __shared__ float x_tile[kBK][kBM + 1];
  __shared__ float w_tile[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float x_reg[kXPerThread];
  float w_reg[kWPerThread];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      x_reg[i] = (gr < M && gc < K) ? to_f32(x[static_cast<size_t>(gr) * K + gc]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      w_reg[i] = (gr < K && gc < N) ? load_w<kInt4>(q, gr, gc, N) : 0.f;
    }
  };

  float acc[4][4] = {};
  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int e = tid + i * kThreads;
      x_tile[e % kBK][e / kBK] = x_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kWPerThread; ++i) {
      const int e = tid + i * kThreads;
      w_tile[e / kBN][e % kBN] = w_reg[i];
    }
    __syncthreads();
    if (k0 + kBK < K) load_stage(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = x_tile[kk][ty * 4 + m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = w_tile[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int gc = col0 + tx + 16 * n;
    if (gc >= N) continue;
    const float s = scale[gc];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gr = row0 + ty * 4 + m;
      if (gr < M) store_out(&out[static_cast<size_t>(gr) * N + gc], acc[m][n] * s);
    }
  }
}

template <typename TX, typename TO>
void launch_typed(const void* x, const void* q, const void* scale, void* out, int M, int K, int N,
                  bool int4, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto* xp = static_cast<const TX*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<TO*>(out);
  if (int4) {
    quant_matmul_kernel<TX, TO, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N);
  } else {
    quant_matmul_kernel<TX, TO, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, op, M, K, N);
  }
}

}  // namespace

// bits: 4 = packed int4 (N even), 5..8 = one int8 per value.
// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32.
extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                   int M, int K, int N, int bits, int x_bf16, int out_bf16,
                                   void* stream) {
  if (bits < 4 || bits > 8 || (bits == 4 && N % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && N > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool int4 = bits == 4;
    if (x_bf16 && out_bf16) {
      launch_typed<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, M, K, N, int4, s);
    } else if (x_bf16) {
      launch_typed<__nv_bfloat16, float>(x, q, scale, out, M, K, N, int4, s);
    } else if (out_bf16) {
      launch_typed<float, __nv_bfloat16>(x, q, scale, out, M, K, N, int4, s);
    } else {
      launch_typed<float, float>(x, q, scale, out, M, K, N, int4, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
