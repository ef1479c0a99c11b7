// Activation x quantized-weight matmul: out[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/quant_matmul/quant_matmul.py::quant_matmul
// (_kernel_int8 / _kernel_int4: grid (M/bm, N/bn, K/bk) with an f32 VMEM
// accumulator carried across the sequential K grid axis, the per-column
// scale applied in the last K step).  On Hopper the blocks run in parallel
// and in no order, so the K loop moves inside the block; where one block's
// K loop would leave the card idle (decode), K is split over blocks and the
// partial sums are added in a fixed order by the last block to finish.
//
// Numerics (the contract of ref.py): the products x * w summed in f32, the
// per-output-column scale applied once in the epilogue, then rounding to
// the output type (bf16 round-to-nearest-even with __float2bfloat16_rn, or
// f32).  Weights are int8-class (bits 5..8, one int8 per value) or packed
// int4 (two sign-extended nibbles per int8, the low nibble holding the even
// column), selected at run time.
//
// What bounds it on the H100: at decode (M = batch = 8) every weight byte is
// read once for a handful of multiply-adds, so the bound is bytes (3.35
// TB/s, 1.3-3.5 us at the LM's shapes) -- reached only with enough bytes in
// flight on every SM; at prefill (M = 4096) it is operations, on the bf16
// tensor cores (989 TFLOP/s).
//
// bf16 activations (every LM activation) take the tensor cores.  A bf16
// value times an int8 or int4 weight is exact in f32, and every such weight
// is exact in bf16, so bf16 x bf16 -> f32 tensor-core products of the raw
// integer weights are the products of ref.py; only the order of summation
// differs.  cp.async brings the bf16 x tile and the raw weight bytes (int8
// or packed int4: a half or a quarter of a bf16 weight's traffic) into a
// ring of 4 shared-memory stages; each stage's weights are widened to bf16
// in shared memory once (exact, by the 2^23 float trick), the next stage's
// while the tensor cores work on this one, so a stage costs one barrier.
// The host planner in kernels/quant_matmul/quant_matmul.py picks one of two
// configurations from the shape alone:
//   * skinny (M <= 64, decode): mma.sync m16n8k16 fed by ldmatrix /
//     ldmatrix.trans, 16 x 64 output tiles (rows past M are zero), 4 warps,
//     BK 64, and K split over S blocks (S from K and N only) so that every
//     decode shape launches >= 2 x 132 blocks.  Each block writes its f32
//     partial to a workspace; the last block of a tile to arrive (an integer
//     counter, reset by that block) sums the S partials in split order,
//     scales and rounds.  No floating-point atomics: results do not change
//     between runs.  What holds it back: each block's few stages run one
//     after another (load, widen, multiply), so a call costs a chain of
//     latencies, 11-17 us against a 1.3-3.5 us byte bound.
//   * wide (M > 64, prefill): wgmma m64n128k16 (two warpgroups, 128 x 128
//     output tiles, a ring of 4 stages of BK 32), both operands read from
//     shared memory through descriptors in the no-swizzle K-major layout,
//     one wgmma batch a stage, no split.  The tensor cores add bf16 products into
//     their f32 fragment less exactly than f32 FADDs do, and the error grows
//     with the chain (at K = 14336 cuBLAS's own bf16 GEMM is ~6x further
//     from the f64 product than f32 FFMA), so every kPromoteStages stages
//     the fragment is added into f32 sums with plain FADDs and zeroed: the
//     promotion interval of CUTLASS's FP8 GEMMs.  The sums live in
//     registers (half) and shared memory (each thread's own), so that two
//     blocks still share an SM (see kAccRegs).  The
//     fragment chains and the promotions depend on K only, so a row's result
//     does not depend on M or on the other rows.  What holds it back: bringing x and the weights into
//     shared memory, not the tensor cores -- dropping the wgmma instructions
//     altogether (a timing-only ablation) left the time unchanged.
// f32 activations (tests only) keep the first version's CUDA-core kernel:
// bf16 tensor-core products would round an f32 x and miss its 1e-5
// contract.  Rows whose 16-byte chunks are not aligned (K % 8 for x, N % 16
// int8 or N % 32 int4 for q) take predicated, zero-filled scalar loads, so
// any shape works; outputs are stored in pairs where aligned.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// f32 activations: the first version, f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;                       // 16 x 16, each a 4 x 4 patch
constexpr int kXPerThread = kBM * kBK / kThreads;   // 8
constexpr int kWPerThread = kBK * kBN / kThreads;   // 8

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

template <typename TO, bool kInt4>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
       TO* __restrict__ out, int M, int K, int N) {
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
      x_reg[i] = (gr < M && gc < K) ? x[static_cast<size_t>(gr) * K + gc] : 0.f;
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

template <typename TO>
void launch(const float* x, const int8_t* q, const float* scale, TO* out, int M, int K, int N,
            bool int4, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (int4) {
    kernel<TO, true><<<grid, kThreads, 0, stream>>>(x, q, scale, out, M, K, N);
  } else {
    kernel<TO, false><<<grid, kThreads, 0, stream>>>(x, q, scale, out, M, K, N);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 activations: tensor cores (mma.sync) fed by cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with valid = false it writes 16 zero bytes
// and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Exact int8 / int4 -> f32: a biased integer in the low mantissa bits of
// 2^23, minus the bias.
__device__ __forceinline__ float int8_to_f32(uint32_t byte) {
  return __uint_as_float(0x4B000000u | ((byte & 0xFFu) ^ 0x80u)) - 8388736.f;  // 2^23 + 128
}
__device__ __forceinline__ float int4_to_f32(uint32_t nibble) {
  return __uint_as_float(0x4B000000u | ((nibble & 0xFu) ^ 0x8u)) - 8388616.f;  // 2^23 + 8
}

// x rows [row0, row0 + kRows), columns [k0, k0 + kBK) -> dst [kRows][kBK + 8]
// (bf16), zero outside [0, M) x [0, K).
template <int kRows, int kBK, int kThreads>
__device__ __forceinline__ void load_x_tile(bf16* dst, const bf16* __restrict__ x, int row0, int k0,
                                            int M, int K, bool vec, int tid) {
  constexpr int kLd = kBK + 8;
  constexpr int kPerRow = kBK / 8;
#pragma unroll
  for (int c = tid; c < kRows * kPerRow; c += kThreads) {
    const int r = c / kPerRow, kc = (c % kPerRow) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    bf16* d = dst + r * kLd + kc;
    if (vec) {
      const bool in = gr < M && gk < K;
      cp_async16(d, in ? x + static_cast<size_t>(gr) * K + gk : x, in);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[i] = (gr < M && gk + i < K) ? x[static_cast<size_t>(gr) * K + gk + i]
                                      : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// Raw weight bytes, rows [k0, k0 + kBK), byte columns [cb0, cb0 + kTB) of a
// [K, NB] byte matrix -> dst [kBK][kTB], zero outside.
template <int kBK, int kTB, int kThreads>
__device__ __forceinline__ void load_w_tile(int8_t* dst, const int8_t* __restrict__ q, int k0,
                                            int cb0, int K, int NB, bool vec, int tid) {
  constexpr int kPerRow = kTB / 16;
#pragma unroll
  for (int c = tid; c < kBK * kPerRow; c += kThreads) {
    const int r = c / kPerRow, bc = (c % kPerRow) * 16;
    const int gk = k0 + r, gb = cb0 + bc;
    int8_t* d = dst + r * kTB + bc;
    if (vec) {
      const bool in = gk < K && gb < NB;
      cp_async16(d, in ? q + static_cast<size_t>(gk) * NB + gb : q, in);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        d[i] = (gk < K && gb + i < NB) ? q[static_cast<size_t>(gk) * NB + gb + i] : int8_t(0);
      }
    }
  }
}

// Raw weight stage [kBK][kTB] bytes -> bf16 [kBK][kBN + 8] weights.  int4:
// byte j of a row holds columns 2j (low nibble) and 2j + 1 (high nibble).
template <bool kInt4, int kBK, int kBN, int kThreads>
__device__ __forceinline__ void widen_w_tile(bf16* dst, const int8_t* src, int tid) {
  constexpr int kLd = kBN + 8;
  constexpr int kTB = kInt4 ? kBN / 2 : kBN;
  constexpr int kWordsPerRow = kTB / 4;
#pragma unroll
  for (int i = tid; i < kBK * kWordsPerRow; i += kThreads) {
    const int r = i / kWordsPerRow, b = (i % kWordsPerRow) * 4;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src + r * kTB + b);
    if (kInt4) {
      uint4 v;
      v.x = pack_bf16x2(int4_to_f32(w), int4_to_f32(w >> 4));
      v.y = pack_bf16x2(int4_to_f32(w >> 8), int4_to_f32(w >> 12));
      v.z = pack_bf16x2(int4_to_f32(w >> 16), int4_to_f32(w >> 20));
      v.w = pack_bf16x2(int4_to_f32(w >> 24), int4_to_f32(w >> 28));
      *reinterpret_cast<uint4*>(dst + r * kLd + 2 * b) = v;
    } else {
      uint2 v;
      v.x = pack_bf16x2(int8_to_f32(w), int8_to_f32(w >> 8));
      v.y = pack_bf16x2(int8_to_f32(w >> 16), int8_to_f32(w >> 24));
      *reinterpret_cast<uint2*>(dst + r * kLd + b) = v;
    }
  }
}

__device__ __forceinline__ void store_two(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_two(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One output fragment pair (row, cols col and col + 1) through `value(e)`,
// as one 4- or 8-byte store where both columns exist and it is aligned.
template <typename TO, typename F>
__device__ __forceinline__ void store_pair(TO* __restrict__ out, int row, int col, int M, int N,
                                           F value) {
  if (row >= M) return;
  TO* p = out + static_cast<size_t>(row) * N + col;
  if (col + 1 < N && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(TO)) == 0) {
    store_two(p, value(0), value(1));
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (col + e < N) store_out(p + e, value(e));
  }
}

// The skinny kernel's ring of cp.async stages: x tile [kBM][kBK + 8] bf16
// and raw weight bytes [kBK][kBN] per stage, plus two widened bf16 weight
// tiles [kBK][kBN + 8] (rows padded by 16 bytes, so ldmatrix reads no two
// rows from one bank).  `mma_stage(xs, ws)` consumes a stage; stages
// [s0, s1) of K are walked.
template <int kBM, int kBN, int kBK, int kStages, int kThreads>
struct Ring {
  static constexpr int kXElems = kBM * (kBK + 8);
  static constexpr int kRawBytes = kBK * kBN;
  static constexpr int kWElems = kBK * (kBN + 8);
  static constexpr int kBytes = kStages * (kXElems * 2 + kRawBytes) + 2 * kWElems * 2;

  template <bool kInt4, typename F>
  __device__ __forceinline__ static void run(unsigned char* smem, const bf16* __restrict__ x,
                                             const int8_t* __restrict__ q, int row0, int col0,
                                             int M, int K, int N, int s0, int s1, bool x_vec,
                                             bool w_vec, F mma_stage) {
    bf16* xs = reinterpret_cast<bf16*>(smem);
    int8_t* raw = reinterpret_cast<int8_t*>(smem + kStages * kXElems * 2);
    bf16* ws = reinterpret_cast<bf16*>(raw + kStages * kRawBytes);
    const int tid = threadIdx.x;
    const int NB = kInt4 ? N / 2 : N;
    const int cb0 = kInt4 ? col0 / 2 : col0;
    constexpr int kTB = kInt4 ? kBN / 2 : kBN;
    auto issue = [&](int s) {
      if (s < s1) {
        const int slot = (s - s0) % kStages;
        load_x_tile<kBM, kBK, kThreads>(xs + slot * kXElems, x, row0, s * kBK, M, K, x_vec, tid);
        load_w_tile<kBK, kTB, kThreads>(raw + slot * kRawBytes, q, s * kBK, cb0, K, NB, w_vec,
                                        tid);
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(s0 + i);
    // one barrier a stage: stage s + 1 is widened into the other tile while
    // stage s multiplies
    if (s0 < s1) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      widen_w_tile<kInt4, kBK, kBN, kThreads>(ws, raw, tid);
    }
    for (int s = s0; s < s1; ++s) {
      const int i = s - s0;
      cp_async_wait<kStages - 3>();  // stage s + 1 has landed (this thread's copies)
      __syncthreads();               // ... everyone's; stage s is widened; s - 1's mma is done
      issue(s + kStages - 1);        // refills the slot stage s - 1 used
      if (s + 1 < s1) {
        widen_w_tile<kInt4, kBK, kBN, kThreads>(ws + ((i + 1) % 2) * kWElems,
                                                raw + ((i + 1) % kStages) * kRawBytes, tid);
      }
      mma_stage(xs + (i % kStages) * kXElems, ws + (i % 2) * kWElems);
    }
  }
};

// ---- skinny: M <= 64, split K ----------------------------------------------

namespace skinny {

constexpr int kBM = 16;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 128;  // 4 warps, 16 columns each
using R = Ring<kBM, kBN, kBK, kStages, kThreads>;

// grid (N / kBN, splits, M / kBM); split s walks K stages [s * chunk, ...).
template <typename TO, bool kInt4>
__global__ void __launch_bounds__(kThreads)
kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
       TO* __restrict__ out, float* __restrict__ partial, int* __restrict__ counters, int M, int K,
       int N, int chunk, int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.z * kBM;
  const int splits = gridDim.y, split = blockIdx.y;
  const int n_stages = (K + kBK - 1) / kBK;
  const int s0 = min(split * chunk, n_stages), s1 = min(s0 + chunk, n_stages);

  float acc[2][4] = {};
  R::run<kInt4>(smem, x, q, row0, col0, M, K, N, s0, s1, x_vec, w_vec,
                [&](const bf16* xs, const bf16* ws) {
#pragma unroll
                  for (int kk = 0; kk < kBK; kk += 16) {
                    uint32_t a[4], b[4];
                    ldmatrix_x4(a, xs + (lane % 16) * (kBK + 8) + kk + (lane / 16) * 8);
                    ldmatrix_x4_trans(
                        b, ws + (kk + lane % 16) * (kBN + 8) + warp * 16 + (lane / 16) * 8);
                    mma_bf16(acc[0], a, b[0], b[1]);
                    mma_bf16(acc[1], a, b[2], b[3]);
                  }
                });

  const int r = row0 + lane / 4;
  const int c = col0 + warp * 16 + 2 * (lane % 4);
  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        store_pair(out, r + 8 * h, c + 8 * nt, M, N,
                   [&](int e) { return acc[nt][2 * h + e] * scale[c + 8 * nt + e]; });
      }
    }
    return;
  }
  // partial [splits][M][N] f32; the last block of this output tile to
  // arrive adds the splits in order 0..splits-1 and resets the counter.
  float* mine = partial + static_cast<size_t>(split) * M * N;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c + 8 * nt + e;
        if (row < M && col < N) mine[static_cast<size_t>(row) * N + col] = acc[nt][2 * h + e];
      }
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // this thread's 8 outputs: j = 4 * nt + 2 * h + e -> (r + 8h, c + 8nt + e);
  // four splits' loads are in flight at once, added in split order
  size_t off[8];
  bool in[8];
  float sum[8] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = r + 8 * ((j / 2) % 2), col = c + 8 * (j / 4) + j % 2;
    in[j] = row < M && col < N;
    off[j] = static_cast<size_t>(row) * N + col;
  }
  for (int s = 0; s < splits; s += 4) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[u][j] = s + u < splits && in[j]
                      ? __ldcg(partial + static_cast<size_t>(s + u) * M * N + off[j])
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (s + u < splits) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sum[j] += v[u][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (in[j]) store_out(&out[off[j]], sum[j] * scale[c + 8 * (j / 4) + j % 2]);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

}  // namespace skinny

// ---- wide: M > 64, wgmma ----------------------------------------------------

namespace wide {

constexpr int kBM = 128;  // two warpgroups of 64 rows
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kXBytes = kBM * kBK * 2;  // per stage, 8 x 8 core matrices
constexpr int kRawBytes = kBK * kBN;
constexpr int kWBytes = kBN * kBK * 2;
// The promoted f32 sums of a thread's 64 fragment elements: the first
// kAccRegs in registers, the rest in shared memory ([64 - kAccRegs][kThreads]).
// All 64 in registers take 156 registers a thread and leave one block on an
// SM (+40 % time); all in shared memory leave too little for the ring of
// stages.  Half and half: 124 registers and 96 KB of shared memory, two
// blocks an SM, as the unpromoted route had.
constexpr int kAccRegs = 32;
// K stages (of kBK) in one tensor-core chain before it is added into the
// sums: 512 K.  scripts/quant_matmul_accumulation_check.py measures its error
// and time; PERF.md records the sweep that chose it.
constexpr int kPromoteStages = 16;
constexpr int kAccBytes = (64 - kAccRegs) * kThreads * 4;
constexpr int kBytes = kStages * (kXBytes + kRawBytes) + 2 * kWBytes + kAccBytes;

// wgmma operand layout, K-major without swizzle: core matrices of 8 rows x
// 8 bf16 (16 B a row, 128 B each), (row / 8, k / 8) at ((row / 8) * (kBK /
// 8) + k / 8) * 128 bytes: 128 B between neighbours along K (LBO), 512 B
// along M or N (SBO).
__device__ __forceinline__ int core_offset(int row, int k) {
  return ((row / 8) * (kBK / 8) + k / 8) * 128 + (row % 8) * 16 + (k % 8) * 2;
}

__device__ __forceinline__ uint64_t make_desc(const void* p) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= uint64_t(128 >> 4) << 16;               // leading dimension (K) byte offset
  d |= uint64_t((kBK / 8) * 128 >> 4) << 32;  // stride dimension (M / N) byte offset
  return d;                                    // base offset 0, no swizzle
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's fragment) += A (64 x 16) B (16 x 128).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// x rows [row0, row0 + kBM), k [k0, k0 + kBK) -> core-matrix layout.
__device__ __forceinline__ void load_x(unsigned char* dst, const bf16* __restrict__ x, int row0,
                                       int k0, int M, int K, bool vec, int tid) {
#pragma unroll
  for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
    const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    bf16* d = reinterpret_cast<bf16*>(dst + core_offset(r, kc));
    if (vec) {
      const bool in = gr < M && gk < K;
      cp_async16(d, in ? x + static_cast<size_t>(gr) * K + gk : x, in);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[i] = (gr < M && gk + i < K) ? x[static_cast<size_t>(gr) * K + gk + i]
                                      : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// Raw weight stage [kBK][kTB] bytes -> bf16 B in the core-matrix layout
// (row = n): each thread widens 8 consecutive k of one column n.
template <bool kInt4>
__device__ __forceinline__ void widen(unsigned char* dst, const int8_t* src, int tid) {
  constexpr int kTB = kInt4 ? kBN / 2 : kBN;
#pragma unroll
  for (int i = tid; i < kBN * kBK / 8; i += kThreads) {
    const int n = i % kBN, kc = (i / kBN) * 8;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t byte =
            static_cast<uint8_t>(src[(kc + 2 * j + e) * kTB + (kInt4 ? n / 2 : n)]);
        f[e] = kInt4 ? int4_to_f32((n & 1) ? byte >> 4 : byte) : int8_to_f32(byte);
      }
      v[j] = pack_bf16x2(f[0], f[1]);
    }
    *reinterpret_cast<uint4*>(dst + core_offset(n, kc)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <typename TO, bool kInt4>
__global__ void __launch_bounds__(kThreads)
kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
       TO* __restrict__ out, int M, int K, int N, int x_vec, int w_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                             // [kStages][kXBytes]
  int8_t* raw = reinterpret_cast<int8_t*>(xs + kStages * kXBytes);
  unsigned char* ws = reinterpret_cast<unsigned char*>(raw + kStages * kRawBytes);  // [2][...]
  // this thread's promoted sums past kAccRegs, element i at
  // acc_s[(i - kAccRegs) * kThreads]: no bank conflicts, and no other thread
  // reads them, so no barrier
  float* acc_s = reinterpret_cast<float*>(ws + 2 * kWBytes) + threadIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, group = warp / 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int NB = kInt4 ? N / 2 : N, cb0 = kInt4 ? col0 / 2 : col0;
  constexpr int kTB = kInt4 ? kBN / 2 : kBN;
  const int n_stages = (K + kBK - 1) / kBK;
  auto issue = [&](int s) {
    if (s < n_stages) {
      load_x(xs + (s % kStages) * kXBytes, x, row0, s * kBK, M, K, x_vec, tid);
      load_w_tile<kBK, kTB, kThreads>(raw + (s % kStages) * kRawBytes, q, s * kBK, cb0, K, NB,
                                      w_vec, tid);
    }
    cp_async_commit();
  };

  float d[64] = {};  // the tensor cores' chain of the current promotion interval
  float acc_r[kAccRegs] = {};
  int left = kPromoteStages;  // stages to the next promotion (no division)
#pragma unroll
  for (int i = kAccRegs; i < 64; ++i) acc_s[(i - kAccRegs) * kThreads] = 0.f;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  if (n_stages > 0) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    widen<kInt4>(ws, raw, tid);
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 3>();  // stage s + 1 has landed (this thread's copies)
    fence_proxy_async();           // x of stage s and B of stage s, for the async proxy
    __syncthreads();
    issue(s + kStages - 1);  // refills the slot stage s - 1 used
    const unsigned char* a = xs + (s % kStages) * kXBytes + group * (kXBytes / 2);
    const unsigned char* b = ws + (s % 2) * kWBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_m64n128k16(d, make_desc(a + kk * 256), make_desc(b + kk * 256));
    }
    wgmma_commit();
    if (s + 1 < n_stages) {  // widened while the tensor cores work on stage s
      widen<kInt4>(ws + ((s + 1) % 2) * kWBytes, raw + ((s + 1) % kStages) * kRawBytes, tid);
    }
    wgmma_wait<0>();
    fence_operands(d);
    if (--left == 0 || s + 1 == n_stages) {
      left = kPromoteStages;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i < kAccRegs) {
          acc_r[i] += d[i];
        } else {
          acc_s[(i - kAccRegs) * kThreads] += d[i];
        }
        d[i] = 0.f;
      }
    }
  }

  // element 4j + 2h + e: row 16 * (warp % 4) + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  auto sum = [&](int i) { return i < kAccRegs ? acc_r[i] : acc_s[(i - kAccRegs) * kThreads]; };
  const int r = row0 + group * 64 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store_pair(out, r + 8 * h, c, M, N,
                 [&](int e) { return sum(4 * j + 2 * h + e) * scale[c + e]; });
    }
  }
}

}  // namespace wide

template <typename TO, bool kInt4>
int launch_tc(const bf16* x, const int8_t* q, const float* scale, TO* out, float* partial,
              int* counters, int M, int K, int N, int kind, int splits, cudaStream_t stream) {
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int NB = kInt4 ? N / 2 : N;
  const bool w_vec = NB % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (kind == 1) {
    const int n_stages = (K + skinny::kBK - 1) / skinny::kBK;
    const int chunk = n_stages > 0 ? (n_stages + splits - 1) / splits : 1;
    const dim3 grid((N + skinny::kBN - 1) / skinny::kBN, splits,
                    (M + skinny::kBM - 1) / skinny::kBM);
    skinny::kernel<TO, kInt4><<<grid, skinny::kThreads, skinny::R::kBytes, stream>>>(
        x, q, scale, out, partial, counters, M, K, N, chunk, x_vec, w_vec);
  } else {
    auto k = wide::kernel<TO, kInt4>;
    const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 wide::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + wide::kBN - 1) / wide::kBN, (M + wide::kBM - 1) / wide::kBM);
    k<<<grid, wide::kThreads, wide::kBytes, stream>>>(x, q, scale, out, M, K, N, x_vec, w_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_out(const void* x, const void* q, const void* scale, void* out, void* partial,
               void* counters, int M, int K, int N, bool int4, int kind, int splits,
               cudaStream_t stream) {
  const auto* xp = static_cast<const bf16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<TO*>(out);
  auto* pp = static_cast<float*>(partial);
  auto* cp = static_cast<int*>(counters);
  return int4 ? launch_tc<TO, true>(xp, qp, sp, op, pp, cp, M, K, N, kind, splits, stream)
              : launch_tc<TO, false>(xp, qp, sp, op, pp, cp, M, K, N, kind, splits, stream);
}

}  // namespace

// bits: 4 = packed int4 (N even), 5..8 = one int8 per value.
// x_bf16 / out_bf16: 1 = bfloat16, 0 = float32.
// kind: 0 = CUDA cores (x f32), 1 = skinny tensor-core (x bf16, M <= 64),
// 2 = wide tensor-core (x bf16).  splits (skinny only): blocks along K; when
// > 1, partial is f32 [splits, M, N] scratch and counters int32
// [ceil(M / 16) * ceil(N / 64)] zeros (left zero on exit).
extern "C" int quant_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                   void* partial, void* counters, int M, int K, int N, int bits,
                                   int x_bf16, int out_bf16, int kind, int splits, void* stream) {
  if (bits < 4 || bits > 8 || (bits == 4 && N % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (kind < 0 || kind > 2 || (kind == 0) == (x_bf16 != 0) || splits < 1 || splits > 65535 ||
      (kind != 1 && splits != 1) || (splits > 1 && (!partial || !counters))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0 && N > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool int4 = bits == 4;
    if (kind == 0) {
      const auto* xp = static_cast<const float*>(x);
      const auto* qp = static_cast<const int8_t*>(q);
      const auto* sp = static_cast<const float*>(scale);
      if (out_bf16) {
        simt::launch(xp, qp, sp, static_cast<__nv_bfloat16*>(out), M, K, N, int4, s);
      } else {
        simt::launch(xp, qp, sp, static_cast<float*>(out), M, K, N, int4, s);
      }
    } else if (out_bf16) {
      return launch_out<__nv_bfloat16>(x, q, scale, out, partial, counters, M, K, N, int4, kind,
                                       splits, s);
    } else {
      return launch_out<float>(x, q, scale, out, partial, counters, M, K, N, int4, kind, splits, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
