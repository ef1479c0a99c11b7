// Flash attention (online softmax, K/V streamed through shared memory).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// (_kernel: grid (B*H, Sq/bq, Sk/bk) with the KV axis innermost and the
// running max, running sum and f32 accumulator carried in VMEM scratch
// across the sequential KV grid steps).  On Hopper the blocks run in
// parallel and in no order, so one block owns one (batch, head, 64-query
// tile) and runs the whole K/V loop itself; the running statistics and the
// accumulator stay in registers for the block's lifetime and nothing is
// carried between blocks.  The [Sq, Sk] score matrix never reaches device
// memory: one 64 x 64 tile of it lives in shared memory at a time.
//
// Numerics (those of the Pallas kernel and of ref.py): scores in f32,
// s = (q . k) * scale, optional soft-cap s = cap * tanh(s / cap), masked
// entries set to NEG_INF = -2.3819763e38 (causal: q_pos >= k_pos; window:
// q_pos - k_pos < window; and k_pos < Sk at the ragged edge), then per key
// tile m_new = max(m, rowmax), p = exp(s - m_new) (0 where masked),
// l = exp(m - m_new) * l + sum(p), acc = acc * exp(m - m_new) + p @ v, and
// out = acc / max(l, 1e-30) rounded to the inputs' type.  A key tile that
// every row of the block masks is skipped: for it the update above is the
// identity (p = 0, exp(m - m_new) = 1), so skipping changes no bit.
//
// Positions are 0..Sq-1 and 0..Sk-1 (no offset); the wrapper refuses
// anything else.  GQA: query head h reads kv head h / (Hq / Hk) directly,
// without materialising the repeat.  Any [B, H, S, D] strides with a
// contiguous D axis are taken, so the model's [B, S, H, D] layout needs no
// transpose.
//
// What bounds it on the H100: at the prefill shape ([1, 32, 4096, 64],
// causal) the work is ~69 GFLOP against ~67 MB of q/k/v/o, so it is bound by
// operations -- 0.07 ms on the bf16 tensor cores.  This first version does
// the two products on the CUDA cores in f32 (67 TFLOP/s peak) through
// shared memory and skips the masked half of the causal tiles; a tensor-core
// (mma.sync / wgmma) version is later work.  Design: 256 threads, four per
// query row (lanes 4r..4r+3 of one warp, so row reductions are two xor
// shuffles); each thread owns 16 of the tile's 64 scores and D/4 of the
// row's output columns; shared-memory rows are padded by one float so the
// strided reads fall in distinct banks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per query row
constexpr int kColsPerThread = kBK / 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {
  int b, h, s;
};

template <int kDMax>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (kDMax + 1) + kBQ * (kBK + 1));
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int Hq, int Hk, int Sq, int Sk, int D, Strides sq,
                       Strides sk, Strides sv, Strides so, int causal, int window, float scale,
                       float softcap) {
  extern __shared__ float smem[];
  constexpr int kLd = kDMax + 1;
  float* q_s = smem;                 // [kBQ][kLd]
  float* k_s = q_s + kBQ * kLd;      // [kBK][kLd]
  float* v_s = k_s + kBK * kLd;      // [kBK][kLd]
  float* p_s = v_s + kBK * kLd;      // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hk);
  const T* qb = q + static_cast<size_t>(b) * sq.b + static_cast<size_t>(h) * sq.h;
  const T* kb = k + static_cast<size_t>(b) * sk.b + static_cast<size_t>(hk) * sk.h;
  const T* vb = v + static_cast<size_t>(b) * sv.b + static_cast<size_t>(hk) * sv.h;

  for (int e = tid; e < kBQ * kDMax; e += kThreads) {
    const int r = e / kDMax, d = e % kDMax;
    const int gq = q0 + r;
    q_s[r * kLd + d] =
        (gq < Sq && d < D) ? to_f32(qb[static_cast<size_t>(gq) * sq.s + d]) : 0.f;
  }

  // Key tiles that some row of this block can see.
  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBQ);
  if (window > 0) k_lo = max(0, (q0 - window + 1) / kBK * kBK);

  const int q_pos = q0 + row;
  float m = kNegInf, l = 0.f;
  float acc[kDMax / 4];
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) acc[i] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    for (int e = tid; e < kBK * kDMax; e += kThreads) {
      const int r = e / kDMax, d = e % kDMax;
      const int gk = k0 + r;
      const bool in = gk < Sk && d < D;
      k_s[r * kLd + d] = in ? to_f32(kb[static_cast<size_t>(gk) * sk.s + d]) : 0.f;
      v_s[r * kLd + d] = in ? to_f32(vb[static_cast<size_t>(gk) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) s[c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[row * kLd + d];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) s[c] = fmaf(qv, k_s[(sub + 4 * c) * kLd + d], s[c]);
    }

    float row_max = kNegInf;
    bool ok[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int k_pos = k0 + sub + 4 * c;
      float sc = s[c] * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      bool valid = k_pos < Sk;
      if (causal) valid = valid && q_pos - k_pos >= 0;
      if (window > 0) valid = valid && q_pos - k_pos < window;
      ok[c] = valid;
      s[c] = valid ? sc : kNegInf;
      row_max = fmaxf(row_max, s[c]);
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m, row_max);
    float p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const float p = ok[c] ? expf(s[c] - m_new) : 0.f;
      p_s[row * (kBK + 1) + sub + 4 * c] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    const float corr = expf(m - m_new);
    l = corr * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's p values were written by this warp's lanes

#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) acc[i] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = p_s[row * (kBK + 1) + j];
#pragma unroll
      for (int i = 0; i < kDMax / 4; ++i) acc[i] = fmaf(p, v_s[j * kLd + sub + 4 * i], acc[i]);
    }
  }

  if (q_pos < Sq) {
    T* ob = o + static_cast<size_t>(b) * so.b + static_cast<size_t>(h) * so.h +
            static_cast<size_t>(q_pos) * so.s;
#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) {
      const int d = sub + 4 * i;
      if (d < D) store(&ob[d], acc[i] / fmaxf(l, 1e-30f));
    }
  }
}

template <typename T, int kDMax>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hk,
                 int Sq, int Sk, int D, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, int window, float scale, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, kDMax>;
  constexpr size_t bytes = smem_bytes<kDMax>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hk,
                 int Sq, int Sk, int D, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, int window, float scale, float softcap, cudaStream_t stream) {
  if (D <= 64) {
    return launch_typed<T, 64>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal, window,
                               scale, softcap, stream);
  }
  return launch_typed<T, 128>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal, window,
                              scale, softcap, stream);
}

}  // namespace

// q [B, Hq, Sq, D], k / v [B, Hk, Sk, D], o like q, each given by element
// strides (batch, head, seq) with D contiguous.  1 <= D <= 128, Hq % Hk == 0.
// window = 0: no sliding window; softcap = 0: no soft-cap; is_bf16: 1 =
// bfloat16 tensors, 0 = float32.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int Hq, int Hk, int Sq, int Sk, int D, int sqb, int sqh,
                                      int sqs, int skb, int skh, int sks, int svb, int svh,
                                      int svs, int sob, int soh, int sos, int causal, int window,
                                      int is_bf16, float scale, float softcap, void* stream) {
  if (D < 1 || D > 128 || Hk < 1 || Hq % Hk) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dtype<__nv_bfloat16>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                       window, scale, softcap, s);
  }
  return launch_dtype<float>(q, k, v, o, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal, window,
                             scale, softcap, s);
}
