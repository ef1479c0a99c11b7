// Exact int32 spike x quantized-weight product: out[M, N] = s[M, K] @ w[K, N].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/quant_matmul/spike_matmul.py::spike_matmul
// (grid (M/bm, N/bn, K/bk) with an int32 VMEM accumulator carried across
// the sequential K grid axis).  On Hopper the blocks run in parallel and in
// no order, so the K loop moves inside the block and nothing is carried
// between blocks.
//
// Contract: any int32 s and w, the result exact mod 2**32 (the JAX product
// wraps).  Signed overflow is undefined in C++, so every accumulator is
// uint32_t (mod 2**32 by definition), reinterpreted as int32 at the end.
//
// What bounds it: at the main path's shapes ([25 * 1024, 256] x [256, 128])
// the kernel reads ~26 MB of int32 spikes and writes ~13 MB of currents, so
// on the int8 tensor cores (1979 TOP/s) it is bound by those bytes (3.35
// TB/s, ~12 us); the first version's int32 multiply-adds on the CUDA cores
// (33.5 TOP/s) could never come below 50 us.  Binary spikes times weights of
// at most 8 bits fit int8 exactly, so this version runs them on the tensor
// cores (mma.sync m16n8k32 s8 x s8 -> s32); larger spikes run there too, by
// byte planes, and so do weights of 9-16 bits (every width a quantized layer
// has), as two weight byte planes: two passes where int8 weights take one,
// not the CUDA cores' 33.5 TOP/s (the sweep's [4620, 256] x [512, 256, 128]
// takes 1.3x its int8 time on an H100, 1/48 of the CUDA cores').  Only
// weights beyond int16, and graded spikes times weights beyond int8, stay
// on the CUDA cores -- every route decided on the device with no host sync:
//
//   * Weights.  A block owns bn <= 128 output columns and narrows its K x bn
//     slice of w to int8 into shared memory once per launch ([n][k], rows
//     padded by 16 bytes so the B-fragment reads hit 32 distinct banks),
//     checking every value (__syncthreads_or).  The int32 slice comes in by
//     cp.async, 256 rows at a time, every copy in flight at once.
//   * The raster.  One block an SM, persistent: a block takes a contiguous
//     range of 16-row strips (equal shares for the SMs), its 8 warps take
//     them in turn, so M has no grid limit.  Per K chunk of up to 256 a warp
//     loads its strip straight into registers in the A fragments' own layout
//     (each thread 16-byte loads of 4 consecutive int32 of a row, packed to
//     4 int8 in one register; no shared memory) and votes (__all_sync) on
//     whether every value fits int8.  The next strip's loads are issued
//     before the tensor cores work on this one (the first strip's before
//     the weights are staged), so a warp always has 16 KB in flight.
//   * Where everything fits, the chunk runs on the tensor cores into a fresh
//     zero int32 fragment (|chunk sum| <= 256 * 2^14 < 2^31: no overflow),
//     which is then added into the uint32_t accumulator with plain adds --
//     the mod-2**32 sum stays exact without relying on how mma overflows.
//     The accumulator is the output itself: the first chunk writes it and
//     each later one (K > 256) adds to it, one thread owning each element,
//     so no 16 x 128 accumulator is held in registers across chunks.
//   * Where a chunk's values do not fit int8 (graded spikes, such as the
//     16 graded serving requests of phase 5 with values up to 3999), the
//     same warp splits them into byte planes, s = b0 + 2^8 b1 + 2^16 b2 +
//     2^24 b3 (b0..b2 unsigned, b3 signed), and runs each nonzero plane on
//     the tensor cores (u8 x s8, the top plane s8 x s8) into a fresh
//     fragment, shifted into place and added with plain uint32_t adds:
//     exact mod 2**32 for any int32 s.  A single large value degrades only
//     its own strip and chunk, and only to 2-4 passes.
//   * Where the block's weights do not fit int8 but fit int16 (w_bits
//     9-16), the block stages a second plane, w = 2^8 hi + lo: the plane
//     above is lo = w & 0xff, read unsigned, and hi = w >> 8, signed, goes
//     into the int32 staging area, which is free once the weights are
//     narrowed (so the shared memory, and the int8 route's carveout, stay
//     as they were; at K above ~1024 the plane does not fit and the block
//     keeps the CUDA cores).  A chunk whose spikes fit int8 then runs each
//     tile's fragment through the high plane (s8 x s8), shifts it left by
//     8 and runs it on through the low plane (s8 x u8): |chunk sum| <= 256
//     * 2^7 * 2^15 = 2^30, and every partial sum below 2^30 + 2^23, so the
//     int32 fragment never overflows.  The two passes run a few of the
//     block's tiles at a time in a loop kept rolled, so that the int8
//     route's loop beside it runs as fast as it did.
//   * Where the block's weights do not fit int16 (the 2^27 wraparound case)
//     or a chunk of graded spikes meets int16 weights (graded serving
//     requests at w_bits > 8; one mechanism, not spike planes times weight
//     planes), the warp runs int32 multiply-adds on the CUDA cores, reading
//     s and w from device memory, into the same accumulator in the
//     C-fragment layout.

// What holds it back (PERF.md): narrowing the weights is a fixed cost at the
// start of every launch, when all 132 SMs read the same 128 KB from L2 at
// once -- the largest single overhead at M = 25600 (sharing one narrowing
// across a 4-block cluster through distributed shared memory cost as much in
// cluster barriers as it saved); the streaming after it stays below the
// card's byte rate.
//
// A candidate axis (the population sweep of the design-space exploration):
// grid.z runs `batch` independent products out[z] = s[z] @ w[z] in one
// launch, each block offsetting its three pointers by z before anything
// else; a shared operand (the sweep's layer-0 raster, read by every
// candidate) has stride 0.  The strides are whole matrices, so every
// alignment the host checked on the base pointers holds for each z.  The
// offsets live in their own instantiation (kBatched): held in registers
// they made the 128-column kernel spill, and a single product (batch 1)
// keeps the kernel without them.  The batched kernel exists only for
// bn = 16 and 128, the blocks the planner gives a candidate axis (16 for
// N <= 16, such as a 10-class output layer; 128 otherwise).
//
// A route counter: where `macs` (int64[3]) is not null, lane 0 of a warp
// adds to it, for each tile -- one 16-row strip x one 256-deep K chunk x
// the block's columns -- the tile's multiply-adds (its rows below M x its
// depth below K x its columns below N), in the slot of the route the tile
// ran: [0] one tensor-core pass, [1] byte planes (of graded spikes, or of
// int16 weights), [2] the CUDA cores.  So a launch adds batch * M * K * N in
// all, however plan() cuts it into tiles.
// An atomic a tile and no more: counting in a register or in shared memory
// and adding once a block at the end made the narrow sweep's 128-column
// launch 3-7 % slower on an H100 even with `macs` null (any epilogue after
// the item loop did); this way a null `macs` leaves one predicated-off
// branch a tile, and the outputs are the same either way.
//
// Ragged M and K are zero-filled, N pads its last n8 tile with zero columns
// and the stores are masked.  The kernel is instantiated for bn = 8, 16, 32,
// 64 and 128, so every tile loop has a compile-time trip count.  When the
// block's shared memory does not fit even at bn = 8 (K above ~27000), the
// host planner (plan() in kernels/quant_matmul/spike_matmul.py) sends the
// whole call to the CUDA-core route.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps per block (one block an SM)
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 16;           // rows of s per warp-strip: the mma's M
constexpr int kChunk = 256;          // K per int8 chunk
constexpr int kSteps = kChunk / 32;  // m16n8k32 steps per chunk
constexpr int kPad = 16;             // bytes after each [n] row of the weights

// Bytes of one int8 weight column in shared memory: K rounded up to whole
// chunks, at least one (zero-filled, so every chunk runs all kSteps with no
// guard, K = 0 included), padded.
__host__ __device__ constexpr int row_bytes(int K) {
  return (K > kChunk ? (K + kChunk - 1) / kChunk : 1) * kChunk + kPad;
}

__device__ __forceinline__ bool fits_i8(int32_t v) {
  return static_cast<uint32_t>(v) + 128u < 256u;
}

__device__ __forceinline__ uint32_t pack_i8x4(int32_t a, int32_t b, int32_t c, int32_t d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// d += a * b on the tensor cores: a int8 (kSignedA) or uint8, b int8
// (kSignedB) or uint8; not both unsigned.
template <bool kSignedA, bool kSignedB = true>
__device__ __forceinline__ void mma_8bit(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  static_assert(kSignedA || kSignedB, "no u8 x u8 pass");
  if constexpr (kSignedA && kSignedB) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if constexpr (kSignedA) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 4 consecutive int32 of row `row` from column k, zero past M and K.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ s, int row, int k, int M, int K,
                                      bool vec) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= M || k >= K) return v;
  const int32_t* p = s + static_cast<size_t>(row) * K + k;
  if (vec) return __ldg(reinterpret_cast<const int4*>(p));  // K % 4 == 0: k + 3 < K
  v.x = __ldg(p);
  if (k + 1 < K) v.y = __ldg(p + 1);
  if (k + 2 < K) v.z = __ldg(p + 2);
  if (k + 3 < K) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ bool fits4(int4 v) {
  return fits_i8(v.x) & fits_i8(v.y) & fits_i8(v.z) & fits_i8(v.w);
}

// The raw int32 values behind one warp's A fragments (m16n8k32, row-major
// A) for the K chunk from k0: step j holds row g, cols k0+32j+4t..+3; row
// g+8, same; row g, cols +16; row g+8, cols +16 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void load_raw(int4 (&x)[kSteps][4], const int32_t* __restrict__ s,
                                         int r0, int k0, int M, int K, bool vec, int t) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int k = k0 + 32 * j + 4 * t;
    x[j][0] = load4(s, r0, k, M, K, vec);
    x[j][1] = load4(s, r0 + 8, k, M, K, vec);
    x[j][2] = load4(s, r0, k + 16, M, K, vec);
    x[j][3] = load4(s, r0 + 8, k + 16, M, K, vec);
  }
}

// Packs the raw values to int8 A fragments; returns whether every value
// fits int8.
__device__ __forceinline__ bool pack_a(uint32_t (&a)[kSteps][4], const int4 (&x)[kSteps][4]) {
  bool fits = true;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fits = fits & fits4(x[j][q]);
      a[j][q] = pack_i8x4(x[j][q].x, x[j][q].y, x[j][q].z, x[j][q].w);
    }
  }
  return fits;
}

// Packs byte `plane` (0 = lowest) of every raw value into A fragments;
// returns whether any of those bytes is nonzero.
__device__ __forceinline__ bool pack_plane(uint32_t (&a)[kSteps][4], const int4 (&x)[kSteps][4],
                                           int plane) {
  const int sh = 8 * plane;
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = x[j][q];
      a[j][q] = pack_i8x4(v.x >> sh, v.y >> sh, v.z >> sh, v.w >> sh);
      any |= a[j][q];
    }
  }
  return any != 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory without registers; zeros
// when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// int32 bytes of one staged row of weights: bn values and 16 bytes of pad,
// so that the 4 x 4 blocks read below fall on distinct banks
__host__ __device__ constexpr int staged_row_bytes(int bn) { return 4 * bn + 16; }

// Narrow the block's K x bn slice of w (columns col0..) to int8 in shared
// memory, ws[n * row_bytes(K) + k], zero past N and K; returns whether this
// thread saw a value outside int8.  With N % 4 == 0 each 256-row piece of
// the slice is first copied as int32 into `st` by cp.async (every copy in
// flight at once, no registers held), then narrowed from there.
__device__ __forceinline__ bool stage_w(uint8_t* ws, uint8_t* st, const int32_t* __restrict__ w,
                                        int K, int N, int col0, int bn, bool vec) {
  const int rb = row_bytes(K), kr = rb - kPad, sb = staged_row_bytes(bn);
  bool bad = false;
  if (vec) {
    for (int p0 = 0; p0 < kr; p0 += kChunk) {
      for (int i = threadIdx.x; i < kChunk * (bn / 4); i += kThreads) {
        const int k = i / (bn / 4), n = 4 * (i % (bn / 4));
        const bool in = p0 + k < K && col0 + n < N;
        const int32_t* src = in ? w + static_cast<size_t>(p0 + k) * N + col0 + n : w;
        cp_async16(st + k * sb + 4 * n, src, in);
      }
      cp_async_wait_all();
      __syncthreads();
      // a thread takes a 4 (k) x 4 (n) block; lane pairs share k and step
      // along n, so the word stores hit 32 distinct banks
      constexpr int kb = kChunk / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < (bn / 4) * kb; i += kThreads) {
        const int n = 4 * (i % 2 + 2 * (i / (2 * kb))), k = 4 * (i / 2 % kb);
        int4 r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          r[q] = *reinterpret_cast<const int4*>(st + (k + q) * sb + 4 * n);
          bad = bad | !fits4(r[q]);
        }
        uint8_t* o = ws + p0 + k;
        *reinterpret_cast<uint32_t*>(o + (n + 0) * rb) = pack_i8x4(r[0].x, r[1].x, r[2].x, r[3].x);
        *reinterpret_cast<uint32_t*>(o + (n + 1) * rb) = pack_i8x4(r[0].y, r[1].y, r[2].y, r[3].y);
        *reinterpret_cast<uint32_t*>(o + (n + 2) * rb) = pack_i8x4(r[0].z, r[1].z, r[2].z, r[3].z);
        *reinterpret_cast<uint32_t*>(o + (n + 3) * rb) = pack_i8x4(r[0].w, r[1].w, r[2].w, r[3].w);
      }
      __syncthreads();  // the next piece reuses st
    }
  } else {  // a thread takes 4 consecutive k of one column, 4 scalar loads
    for (int i = threadIdx.x; i < bn * (kr / 4); i += kThreads) {
      const int n = i % bn, k = 4 * (i / bn), col = col0 + n;
      int32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        r[q] = (col < N && k + q < K) ? __ldg(w + static_cast<size_t>(k + q) * N + col) : 0;
        bad = bad | !fits_i8(r[q]);
      }
      *reinterpret_cast<uint32_t*>(ws + n * rb + k) = pack_i8x4(r[0], r[1], r[2], r[3]);
    }
  }
  return bad;
}

// Whether the high plane of the block's weights (bn rows of row_bytes(K))
// fits in the staging area it takes over once stage_w is done.
__host__ __device__ constexpr bool planes_fit(int K, int bn) {
  return bn * row_bytes(K) <= kChunk * staged_row_bytes(bn);
}

// The high plane of the block's weights, hi = w >> 8 as int8, into `hi` in
// stage_w's layout ([n][k], zero past N and K); the low plane is what
// stage_w left, w & 0xff.  Returns whether this thread saw a weight beyond
// int16 (a high byte beyond int8).  The slice comes again from device
// memory, just read by stage_w, so from L2: a thread takes 4 consecutive k
// of one column.
__device__ __forceinline__ bool stage_hi(uint8_t* hi, const int32_t* __restrict__ w, int K, int N,
                                         int col0, int bn) {
  const int rb = row_bytes(K), kr = rb - kPad;
  bool bad = false;
#pragma unroll 1
  for (int i = threadIdx.x; i < bn * (kr / 4); i += kThreads) {
    const int n = i % bn, k = 4 * (i / bn), col = col0 + n;
    int32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[q] = (col < N && k + q < K) ? __ldg(w + static_cast<size_t>(k + q) * N + col) >> 8 : 0;
      bad = bad | !fits_i8(r[q]);
    }
    *reinterpret_cast<uint32_t*>(hi + n * rb + k) = pack_i8x4(r[0], r[1], r[2], r[3]);
  }
  return bad;
}

// Writes (a, b) to out[row, col..col+1] -- or, with `add`, adds them to what
// the same thread wrote there for the earlier K chunks (uint32_t adds).
__device__ __forceinline__ void store2(int32_t* __restrict__ out, int row, int col, uint32_t a,
                                       uint32_t b, int M, int N, bool pair, bool add) {
  if (row >= M) return;
  int32_t* p = out + static_cast<size_t>(row) * N + col;
  if (pair && col + 1 < N) {
    if (add) {
      const int2 old = *reinterpret_cast<const int2*>(p);
      a += static_cast<uint32_t>(old.x);
      b += static_cast<uint32_t>(old.y);
    }
    *reinterpret_cast<int2*>(p) = make_int2(static_cast<int32_t>(a), static_cast<int32_t>(b));
  } else {
    if (col < N) p[0] = static_cast<int32_t>(a + (add ? static_cast<uint32_t>(p[0]) : 0u));
    if (col + 1 < N) p[1] = static_cast<int32_t>(b + (add ? static_cast<uint32_t>(p[1]) : 0u));
  }
}

// One 16-row strip's K chunk (A fragments `a`) against the block's int8
// weights on the tensor cores: each tile's sum in a fresh int32 fragment,
// shifted left by `shift` bits (a byte plane's place), then written to the
// output -- or, with `add`, added to it in uint32_t: the output is the
// accumulator across K chunks and planes, one thread owning each element.
// kPart tiles' fragments are live at once.
template <int kTiles, int kPart, bool kSignedA>
__device__ __forceinline__ void run_tiles(const uint32_t (&a)[kSteps][4], const uint8_t* ws,
                                          int32_t* __restrict__ out, int rb, int k0, int r0,
                                          int col0, int M, int N, int g, int t, bool pair,
                                          int shift, bool add) {
#pragma unroll
  for (int j0 = 0; j0 < kTiles; j0 += kPart) {
    int32_t f[kPart][4] = {};
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        const uint8_t* wp = ws + (8 * (j0 + j) + g) * rb + k0 + 32 * st + 4 * t;
        mma_8bit<kSignedA>(f[j], a[st], *reinterpret_cast<const uint32_t*>(wp),
                           *reinterpret_cast<const uint32_t*>(wp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const int col = col0 + 8 * (j0 + j) + 2 * t;
      const auto u = [&](int q) { return static_cast<uint32_t>(f[j][q]) << shift; };
      store2(out, r0, col, u(0), u(1), M, N, pair, add);
      store2(out, r0 + 8, col, u(2), u(3), M, N, pair, add);
    }
  }
}

// One 16-row strip's K chunk (A fragments `a`, values that fit int8)
// against int16 weights as two byte planes, w = 2^8 hi + lo (`hi` signed,
// `lo` unsigned, each in stage_w's layout): each tile's fragment runs
// through the high plane, is shifted left by 8, runs on through the low
// plane (|chunk sum| <= 256 * 2^7 * 2^15 = 2^30, every partial sum below
// 2^30 + 2^23: the int32 fragment never overflows), then is written or
// added as in run_tiles.  kPart tiles at a time, the groups in a loop that
// is not unrolled: beside the int8 route's loop, the two passes unrolled
// over every group changed how the compiler laid out that loop and slowed
// it by ~10 % on an H100, with this loop it runs as before (PERF.md).
template <int kTiles, int kPart>
__device__ __forceinline__ void run_wide_tiles(const uint32_t (&a)[kSteps][4], const uint8_t* lo,
                                               const uint8_t* hi, int32_t* __restrict__ out,
                                               int rb, int k0, int r0, int col0, int M, int N,
                                               int g, int t, bool pair, bool add) {
#pragma unroll 1
  for (int j0 = 0; j0 < kTiles; j0 += kPart) {
    int32_t f[kPart][4] = {};
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        const uint8_t* wp = hi + (8 * (j0 + j) + g) * rb + k0 + 32 * st + 4 * t;
        mma_8bit<true>(f[j], a[st], *reinterpret_cast<const uint32_t*>(wp),
                       *reinterpret_cast<const uint32_t*>(wp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[j][q] = static_cast<int32_t>(static_cast<uint32_t>(f[j][q]) << 8);
      }
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        const uint8_t* wp = lo + (8 * (j0 + j) + g) * rb + k0 + 32 * st + 4 * t;
        mma_8bit<true, false>(f[j], a[st], *reinterpret_cast<const uint32_t*>(wp),
                              *reinterpret_cast<const uint32_t*>(wp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const int col = col0 + 8 * (j0 + j) + 2 * t;
      const auto u = [&](int q) { return static_cast<uint32_t>(f[j][q]); };
      store2(out, r0, col, u(0), u(1), M, N, pair, add);
      store2(out, r0 + 8, col, u(2), u(3), M, N, pair, add);
    }
  }
}

// The route counter's add for the tile at rows r0.., K chunk k0.. and
// columns col0.. (lane 0's item): its multiply-adds inside [M, K, N].
__device__ __forceinline__ void count_macs(unsigned long long* macs, int route, int r0, int k0,
                                           int col0, int bn, int M, int K, int N) {
  atomicAdd(&macs[route], static_cast<unsigned long long>(min(kStrip, M - r0)) *
                              static_cast<unsigned long long>(min(kChunk, K - k0)) *
                              static_cast<unsigned long long>(min(bn, N - col0)));
}

// kTiles n8 tiles a block (bn = 8 * kTiles columns), so every tile and
// step loop has a compile-time trip count and the mma chains interleave.
template <int kTiles, bool kBatched>
__global__ void __launch_bounds__(kThreads, 1)
spike_matmul_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ w,
                    int32_t* __restrict__ out, unsigned long long* __restrict__ macs, int M,
                    int K, int N, bool use_tc, bool s_vec, bool w_vec, bool pair, bool s_batched,
                    bool w_batched) {
  constexpr int kBN = 8 * kTiles;
  // tiles whose fragments are live at once: half the block's in one pass, a
  // quarter in the byte planes, whose raw values stay live besides
  constexpr int kPart = kTiles > 1 ? kTiles / 2 : 1;
  constexpr int kPlanePart = kTiles > 3 ? kTiles / 4 : 1;
  // and in the weight planes' rolled loop: half the block's in the batched
  // kernel, two in the single product's (the most each takes with its int8
  // loop as fast as before, PERF.md)
  constexpr int kWidePart = kBatched ? kPart : (kTiles > 7 ? kTiles / 8 : 1);
  extern __shared__ __align__(16) uint8_t ws[];
  if constexpr (kBatched) {
    const size_t z = blockIdx.z;  // the candidate
    if (s_batched) s += z * M * K;
    if (w_batched) w += z * K * N;
    out += z * M * N;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = row_bytes(K);
  const int col0 = blockIdx.y * kBN;
  const int n_chunks = max(1, (K + kChunk - 1) / kChunk);  // K = 0 still writes zeros
  // a block takes a contiguous range of strips (so the SMs get equal
  // shares); its warps take them in turn, each strip chunk by chunk: the
  // warp's items are (strip, chunk) pairs
  const int n_strips = (M + kStrip - 1) / kStrip;
  const int begin = static_cast<int>(static_cast<int64_t>(n_strips) * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<int64_t>(n_strips) * (blockIdx.x + 1) / gridDim.x);
  const int strips = end - begin > warp ? (end - begin - warp + kWarps - 1) / kWarps : 0;
  const int n_items = strips * n_chunks;
  const auto item_row = [&](int i) {
    return (begin + warp + i / n_chunks * kWarps) * kStrip + g;
  };

  // the next item's raw values are in flight while the warp works on the
  // current one; the first item's while the block stages the weights
  int4 x[kSteps][4];
  if (use_tc && n_items > 0) load_raw(x, s, item_row(0), 0, M, K, s_vec, t);
  // w16: weights beyond int8 that fit int16, as two planes, the high one in
  // the staging area (ws + kBN * rb)
  bool w8 = false, w16 = false;
  if (use_tc) {
    w8 = !__syncthreads_or(stage_w(ws, ws + kBN * rb, w, K, N, col0, kBN, w_vec));
    if (!w8 && planes_fit(K, kBN)) {
      w16 = !__syncthreads_or(stage_hi(ws + kBN * rb, w, K, N, col0, kBN));
    }
  }

  for (int i = 0; i < n_items; ++i) {
    const int r0 = item_row(i), c = i % n_chunks, k0 = c * kChunk;
    uint32_t a[kSteps][4];
    const bool s8 = (w8 || w16) && pack_a(a, x);
    if (w8 && __all_sync(0xffffffffu, s8)) {
      // every value fits int8: one pass on the tensor cores, the next
      // item's loads in flight meanwhile
      if (macs != nullptr && lane == 0) count_macs(macs, 0, r0, k0, col0, kBN, M, K, N);
      if (i + 1 < n_items) {
        load_raw(x, s, item_row(i + 1), (i + 1) % n_chunks * kChunk, M, K, s_vec, t);
      }
      run_tiles<kTiles, kPart, true>(a, ws, out, rb, k0, r0, col0, M, N, g, t, pair, 0, c > 0);
    } else if (w8) {
      // values beyond int8 (graded spikes): s = b0 + 2^8 b1 + 2^16 b2 + 2^24 b3
      // with bytes b0..b2 unsigned and b3 signed, so s * w is the sum of the
      // byte planes' products shifted into place -- exact mod 2**32.  Each
      // plane is one tensor-core pass (u8 x s8, the top one s8 x s8; a
      // chunk's plane sum |.| <= 256 * 255 * 128 < 2^31); all-zero planes
      // are skipped.
      if (macs != nullptr && lane == 0) count_macs(macs, 1, r0, k0, col0, kBN, M, K, N);
      run_tiles<kTiles, kPlanePart, false>(a, ws, out, rb, k0, r0, col0, M, N, g, t, pair, 0,
                                           c > 0);
#pragma unroll 1
      for (int plane = 1; plane < 4; ++plane) {
        if (!__any_sync(0xffffffffu, pack_plane(a, x, plane))) continue;
        if (plane < 3) {
          run_tiles<kTiles, kPlanePart, false>(a, ws, out, rb, k0, r0, col0, M, N, g, t, pair,
                                               8 * plane, true);
        } else {
          run_tiles<kTiles, kPlanePart, true>(a, ws, out, rb, k0, r0, col0, M, N, g, t, pair, 24,
                                              true);
        }
      }
      if (i + 1 < n_items) {
        load_raw(x, s, item_row(i + 1), (i + 1) % n_chunks * kChunk, M, K, s_vec, t);
      }
    } else if (w16 && __all_sync(0xffffffffu, s8)) {
      // int16 weights, spikes that fit int8: the two weight planes on the
      // tensor cores, the next item's loads in flight meanwhile
      if (macs != nullptr && lane == 0) count_macs(macs, 1, r0, k0, col0, kBN, M, K, N);
      if (i + 1 < n_items) {
        load_raw(x, s, item_row(i + 1), (i + 1) % n_chunks * kChunk, M, K, s_vec, t);
      }
      run_wide_tiles<kTiles, kWidePart>(a, ws, ws + kBN * rb, out, rb, k0, r0, col0, M, N, g, t,
                                        pair, c > 0);
    } else {
      // weights beyond int16 (or beyond int8 where the high plane does not
      // fit), or graded spikes times int16 weights: int32 multiply-adds on
      // the CUDA cores in the C-fragment layout (rows r0 and r0 + 8, columns
      // n and n + 1 of tile j), w from device memory
      const int k_end = min(K, k0 + kChunk);
      if (macs != nullptr && lane == 0) count_macs(macs, 2, r0, k0, col0, kBN, M, K, N);
      for (int j = 0; j < kTiles; ++j) {
        const int n = col0 + 8 * j + 2 * t;
        uint32_t d[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
        for (int k = k0; k < k_end; ++k) {
          const uint32_t sa =
              r0 < M ? static_cast<uint32_t>(s[static_cast<size_t>(r0) * K + k]) : 0u;
          const uint32_t sb =
              r0 + 8 < M ? static_cast<uint32_t>(s[static_cast<size_t>(r0 + 8) * K + k]) : 0u;
          const int32_t* wk = w + static_cast<size_t>(k) * N + n;
          const uint32_t w0 = n < N ? static_cast<uint32_t>(__ldg(wk)) : 0u;
          const uint32_t w1 = n + 1 < N ? static_cast<uint32_t>(__ldg(wk + 1)) : 0u;
          d[0] += sa * w0;
          d[1] += sa * w1;
          d[2] += sb * w0;
          d[3] += sb * w1;
        }
        store2(out, r0, n, d[0], d[1], M, N, pair, c > 0);
        store2(out, r0 + 8, n, d[2], d[3], M, N, pair, c > 0);
      }
      if (w16 && i + 1 < n_items) {
        load_raw(x, s, item_row(i + 1), (i + 1) % n_chunks * kChunk, M, K, s_vec, t);
      }
    }
  }
}

template <int kTiles, bool kBatched>
int launch(const void* s, const void* w, void* out, void* macs, int M, int K, int N, int blocks,
           bool use_tc, int batch, bool s_batched, bool w_batched, cudaStream_t stream) {
  auto fn = spike_matmul_kernel<kTiles, kBatched>;
  constexpr int kBN = 8 * kTiles;
  const int smem = use_tc ? kBN * row_bytes(K) + kChunk * staged_row_bytes(kBN) : 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool s_vec = K % 4 == 0 && aligned(s, 16);
  const bool w_vec = N % 4 == 0 && aligned(w, 16);
  const bool pair = N % 2 == 0 && aligned(out, 8);
  const dim3 grid(blocks, (N + kBN - 1) / kBN, batch);
  fn<<<grid, kThreads, smem, stream>>>(static_cast<const int32_t*>(s),
                                       static_cast<const int32_t*>(w),
                                       static_cast<int32_t*>(out),
                                       static_cast<unsigned long long*>(macs), M, K, N, use_tc,
                                       s_vec, w_vec, pair, s_batched, w_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `bn` (8, 16, 32, 64 or 128 columns a block), `blocks` (along M) and
// `use_tc` come from the host planner; with use_tc a block takes
// bn * row_bytes(K) bytes of shared memory for its int8 weights and
// 256 * staged_row_bytes(bn) for the int32 pieces on their way in.
// `batch` products run in one launch (grid.z); s and w advance by a whole
// matrix per product where `s_batched` / `w_batched` is set, else every
// product reads the same one.  With batch > 1, bn must be 16 or 128.
// `macs` is null, or an int64[3] that the launch adds its multiply-adds to by
// route (tensor-core pass, byte planes, CUDA cores).
extern "C" int spike_matmul_launch(const void* s, const void* w, void* out, void* macs, int M,
                                   int K, int N, int bn, int blocks, int use_tc, int batch,
                                   int s_batched, int w_batched, void* stream) {
  if (M <= 0 || N <= 0 || batch == 0) return static_cast<int>(cudaGetLastError());
  if (blocks <= 0 || batch < 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool tc = use_tc != 0, sb = s_batched != 0, wb = w_batched != 0;
  if (batch > 1) {
    switch (bn) {
      case 16: return launch<2, true>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
      case 128: return launch<16, true>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bn) {
    case 8: return launch<1, false>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
    case 16: return launch<2, false>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
    case 32: return launch<4, false>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
    case 64: return launch<8, false>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
    case 128: return launch<16, false>(s, w, out, macs, M, K, N, blocks, tc, batch, sb, wb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
