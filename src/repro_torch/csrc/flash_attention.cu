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
// memory.
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
// operations -- 0.07 ms on the bf16 tensor cores.
//
// bf16 inputs (the LM path) run FA2-style on the tensor cores: 4 warps,
// each owning 16 query rows of a 64-query block, its Q fragments held in
// registers for the whole loop; K/V tiles of 64 keys double-buffered in
// shared memory by cp.async (the next tile's copy overlaps this tile's
// math).  S = Q K^T is mma.sync m16n8k16 (bf16 in, f32 accumulate, K
// fragments by ldmatrix); scale, soft-cap and masks are applied in
// registers (masks only on tiles that straddle the causal diagonal, the
// window edge or Sk), with the scores kept in log2 units so that each exp
// is one exp2f; row max and row sum are reduced across each quad with
// shuffles, l from the f32 p.  P V is two mma.sync per fragment, with P
// split into hi = bf16(p) and lo = bf16(p - hi) (V fragments by
// ldmatrix.trans): a single bf16 P would round p by up to 2^-9 and use
// more than the one-ulp tolerance of the output (the soft-capped case of
// chip_smoke phase 2), while hi + lo keeps p to ~2^-17, as good as f32 p
// there.  Under the causal mask the longest query tiles are launched first.
// D is padded to 64 or 128 with zero columns (they add nothing to Q K^T
// and are never stored).  Rows whose 16-byte chunks are not aligned (D or
// a stride not a multiple of 8) take predicated scalar loads.  What holds
// it back: each warp's chain per tile (Q K^T, then the softmax, then P V)
// runs in series, with 4 blocks of 4 warps an SM to overlap it -- at 128
// queries a block (fewer K/V loads) or 128 keys a tile the register cost
// took more than it gave, on the card.

// f32 inputs (tests only) keep the first version's kernel on the CUDA
// cores: bf16 tensor-core products would round f32 q, k, v and miss its
// 1e-4 contract.  256 threads, four per query row (lanes 4r..4r+3 of one
// warp, so row reductions are two xor shuffles); each thread owns 16 of
// the tile's 64 scores and D/4 of the row's output columns; shared-memory
// rows are padded by one float so the strided reads fall in distinct banks.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -2.3819763e38f;

struct Strides {
  int b, h, s;
};

// ---------------------------------------------------------------------------
// f32: the first version, on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 per query row
constexpr int kColsPerThread = kBK / 4;

template <int kDMax>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kBQ * (kDMax + 1) + kBQ * (kBK + 1));
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, int Hq, int Hk, int Sq, int Sk, int D, Strides sq, Strides sk,
       Strides sv, Strides so, int causal, int window, float scale, float softcap) {
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
  const float* qb = q + static_cast<size_t>(b) * sq.b + static_cast<size_t>(h) * sq.h;
  const float* kb = k + static_cast<size_t>(b) * sk.b + static_cast<size_t>(hk) * sk.h;
  const float* vb = v + static_cast<size_t>(b) * sv.b + static_cast<size_t>(hk) * sv.h;

  for (int e = tid; e < kBQ * kDMax; e += kThreads) {
    const int r = e / kDMax, d = e % kDMax;
    const int gq = q0 + r;
    q_s[r * kLd + d] = (gq < Sq && d < D) ? qb[static_cast<size_t>(gq) * sq.s + d] : 0.f;
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
      k_s[r * kLd + d] = in ? kb[static_cast<size_t>(gk) * sk.s + d] : 0.f;
      v_s[r * kLd + d] = in ? vb[static_cast<size_t>(gk) * sv.s + d] : 0.f;
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
    float* ob = o + static_cast<size_t>(b) * so.b + static_cast<size_t>(h) * so.h +
                static_cast<size_t>(q_pos) * so.s;
#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) {
      const int d = sub + 4 * i;
      if (d < D) ob[d] = acc[i] / fmaxf(l, 1e-30f);
    }
  }
}

template <int kDMax>
int launch(const float* q, const float* k, const float* v, float* o, int B, int Hq, int Hk,
           int Sq, int Sk, int D, Strides sq, Strides sk, Strides sv, Strides so, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  auto fn = kernel<kDMax>;
  constexpr size_t bytes = smem_bytes<kDMax>();
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  fn<<<grid, kThreads, bytes, stream>>>(q, k, v, o, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                        window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) fed by cp.async
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 64;        // queries per block, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps

template <int kD>
constexpr int smem_bytes() {
  return (kBQ + 4 * kBK) * (kD + 8) * 2;  // Q, then two buffers of K and V
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (p0, p1) -> hi = bf16 pair, lo = bf16 pair of the remainders.
__device__ __forceinline__ void split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [r0, r0 + 64) of a [S, D] matrix with row stride rs -> dst
// [64][kD + 8], zero outside [0, S) x [0, D).
template <int kD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int r0, int S,
                                          int rs, int D, bool vec, int tid) {
  constexpr int kPerRow = kD / 8;
#pragma unroll
  for (int c = tid; c < 64 * kPerRow; c += kThreads) {
    const int r = c / kPerRow, d = (c % kPerRow) * 8;
    const int gr = r0 + r;
    bf16* p = dst + r * (kD + 8) + d;
    if (vec) {
      const bool in = gr < S && d < D;
      cp_async16(p, in ? src + static_cast<size_t>(gr) * rs + d : src, in);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[i] = (gr < S && d + i < D) ? src[static_cast<size_t>(gr) * rs + d + i]
                                     : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// grid (B * Hq, ceil(Sq / 64)); under the causal mask blockIdx.y = 0 is the
// last (longest) query tile.  At D = 64, 4 blocks an SM (a 128-register cap).
template <int kD>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 4 : 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       bf16* __restrict__ o, int Hq, int Hk, int Sq, int Sk, int D, Strides sq, Strides sk,
       Strides sv, Strides so, int causal, int window, float scale, float softcap, int vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kLd = kD + 8;
  constexpr int kDT = kD / 8;  // n8 tiles of the output
  constexpr float kLog2e = 1.4426950408889634f;
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kBQ][kLd]
  bf16* kv_s = q_s + kBQ * kLd;                   // [2][K, V][kBK][kLd]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hk);
  const int q_tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kBQ;
  const bf16* qb = q + static_cast<size_t>(b) * sq.b + static_cast<size_t>(h) * sq.h;
  const bf16* kb = k + static_cast<size_t>(b) * sk.b + static_cast<size_t>(hk) * sk.h;
  const bf16* vb = v + static_cast<size_t>(b) * sv.b + static_cast<size_t>(hk) * sv.h;
  // scores in log2 units, so exp is one exp2f: s * scale * log2 e, or
  // cap * log2 e * tanh(s * scale / cap)
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;
  const float cap_log2e = softcap * kLog2e;

  // Key tiles that some row of this block can see.
  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + kBQ);
  if (window > 0) k_lo = max(0, (q0 - window + 1) / kBK * kBK);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  auto load_kv = [&](int t) {
    bf16* dst = kv_s + (t & 1) * 2 * kBK * kLd;
    load_rows<kD>(dst, kb, k_lo + t * kBK, Sk, sk.s, D, vec, tid);
    load_rows<kD>(dst + kBK * kLd, vb, k_lo + t * kBK, Sk, sv.s, D, vec, tid);
  };

  load_rows<kD>(q_s, qb, q0, Sq, sq.s, D, vec, tid);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
  }

  // this thread's rows: r = 0 -> q0 + warp*16 + lane/4, r = 1 -> that + 8;
  // its columns of an n8 tile: 2 * (lane % 4) + {0, 1}
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  float o_acc[kDT][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kBK;
    if (t + 1 < n_tiles) load_kv(t + 1);  // into the buffer tile t - 1 used
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + (t & 1) * 2 * kBK * kLd;
    const bf16* v_s = k_s + kBK * kLd;

    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + (np * 16 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, soft-cap, masks (only where the tile straddles an edge)
    const bool unmasked = (!causal || k0 + kBK - 1 <= q0) &&
                          (window <= 0 || q0 + kBQ - 1 - k0 < window) && k0 + kBK <= Sk;
    uint32_t ok = 0xffffffffu;  // bit 4 * nt + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[nt][e] * qk_scale;
        if (softcap > 0.f) sc = cap_log2e * tanhf(sc / softcap);
        if (!unmasked) {
          const int qp = row[e / 2], kp = k0 + nt * 8 + 2 * (lane % 4) + e % 2;
          bool valid = kp < Sk;
          if (causal) valid = valid && qp - kp >= 0;
          if (window > 0) valid = valid && qp - kp < window;
          if (!valid) {
            ok &= ~(1u << (4 * nt + e));
            sc = kNegInf;
          }
        }
        s[nt][e] = sc;
        mx[e / 2] = fmaxf(mx[e / 2], sc);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * nt + e)) & 1u ? exp2f(s[nt][e] - m[e / 2]) : 0.f;
        s[nt][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o_acc[dt][0] *= corr[0];
      o_acc[dt][1] *= corr[0];
      o_acc[dt][2] *= corr[1];
      o_acc[dt][3] *= corr[1];
    }

    // O += P_hi V + P_lo V; the S accumulator layout is the A fragment's
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + lane % 16) * kLd + dp * 16 + (lane / 16) * 8);
        mma_bf16(o_acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o_acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o_acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(o_acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  bf16* ob = o + static_cast<size_t>(b) * so.b + static_cast<size_t>(h) * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + static_cast<size_t>(row[r]) * so.s;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {  // pairs of columns, one 4-byte store where aligned
      const int d = dt * 8 + 2 * (lane % 4);
      const float v0 = o_acc[dt][2 * r] / denom, v1 = o_acc[dt][2 * r + 1] / denom;
      if (d + 1 < D && reinterpret_cast<uintptr_t>(orow + d) % 4 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < D) orow[d] = __float2bfloat16_rn(v0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int kD>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Hq, int Hk, int Sq,
           int Sk, int D, Strides sq, Strides sk, Strides sv, Strides so, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  auto fn = kernel<kD>;
  constexpr int bytes = smem_bytes<kD>();
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool vec = D % 8 == 0;
  for (const Strides& st : {sq, sk, sv}) vec = vec && st.b % 8 == 0 && st.h % 8 == 0 && st.s % 8 == 0;
  for (const void* p : {static_cast<const void*>(q), static_cast<const void*>(k),
                        static_cast<const void*>(v)}) {
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  fn<<<grid, kThreads, bytes, stream>>>(q, k, v, o, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                        window, scale, softcap, int(vec));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q [B, Hq, Sq, D], k / v [B, Hk, Sk, D], o like q, each given by element
// strides (batch, head, seq) with D contiguous.  1 <= D <= 128, Hq % Hk == 0.
// window = 0: no sliding window; softcap = 0: no soft-cap; is_bf16: 1 =
// bfloat16 tensors (tensor cores), 0 = float32 (CUDA cores).
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
    const auto *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
               *vp = static_cast<const bf16*>(v);
    auto* op = static_cast<bf16*>(o);
    return D <= 64 ? tc::launch<64>(qp, kp, vp, op, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                    window, scale, softcap, s)
                   : tc::launch<128>(qp, kp, vp, op, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                     window, scale, softcap, s);
  }
  const auto *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
             *vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  return D <= 64 ? simt::launch<64>(qp, kp, vp, op, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                    window, scale, softcap, s)
                 : simt::launch<128>(qp, kp, vp, op, B, Hq, Hk, Sq, Sk, D, sq, sk, sv, so, causal,
                                     window, scale, softcap, s);
}
