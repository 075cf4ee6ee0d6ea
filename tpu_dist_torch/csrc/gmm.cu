// Grouped matrix multiply for Hopper (sm_90a): the dropless-MoE kernel pair.
//
// Replaces the Pallas TPU kernels of tpu_dist/ops/gmm.py:
//   gmm_*   <- gmm  (:74)   out[block i] = x[block i] @ w[groups[i]] (+ bias)
//   tgmm_*  <- tgmm (:181)  dw[e] = sum over e's row blocks of x_blk^T dy_blk,
//                           db[e] = the row sums of e's dy
//
// What bounds it on an H100: at the MoE training shapes (36864 allocated rows,
// 32768 of them routed, D = 768, H = 3072, 8 experts) one launch is ~155 GFLOP
// of bf16 products against ~0.3 GB of operands, so the bound is tensor-core
// throughput (~0.16 ms at 989 TFLOP/s), not memory (~0.1 ms).
//
// What the design does about it.  Products run on the tensor cores as mma.sync
// m16n8k16 with f32 accumulation, operands loaded from shared memory with
// ldmatrix (the building blocks of csrc/flash_attention.cu), tiles streamed
// through a four-stage cp.async ring so loads overlap the products.  A block
// is 4 warps, each owning a 64 x 64 piece of the 128 x 128 tile: 64 products
// a warp between two barriers, 32 FLOP per byte read from shared memory, two
// blocks an SM.  Measured on an H100 (PERF.md), the first design (8 warps of
// 64 x 32, three stages) was 3-11% slower, and 128 x 256 tiles of 8 such
// warps (one block an SM) 20-40% slower, which points at latency with few
// warps in flight rather than at shared-memory or L2 bandwidth (no hardware
// counters were available to show it).  The grid
// walks the output columns fastest, so the blocks in flight share one group's
// weights and a few row tiles, which stay in the 50 MB L2: each operand comes
// from device memory about once.
//
//   gmm: one block per (128-row tile, 128-column tile).  The row tile lies
//   inside one row block (block_rows may be any multiple of 8: a tile is cut
//   at its block's end and the rows past it are masked), so it has one group.
//   Each block reads its group id and the live-block count from device memory
//   (the TPU kernel's scalar prefetch): no host sync.  A dead tail block writes
//   zeros and issues no product.  The TPU kernel keeps D whole in VMEM; here
//   the block loops over D in 32-wide k tiles.  The bias is added in f32
//   before rounding.  w is read either as (E, D, H) or, for the dx pass, as
//   the transpose of a contiguous (E, H, D) tensor (ldmatrix transposes on the
//   way; no copy of w^T).
//
//   tgmm: one block per (group, 128-row d tile, 128-column h tile), looping
//   over its own group's rows [offsets[e], offsets[e+1]) in 32-row k tiles.
//   The TPU kernel carries each group's accumulator in VMEM across a
//   sequential grid; GPU blocks run in no order, so the loop inside the block
//   takes its place.  No split over rows, no atomics: deterministic.  A group
//   with no rows writes zeros.  The row sum for db is taken from the dy tiles
//   already in shared memory by the blocks of d tile 0.
//
// float32 inputs take plain shared-memory FMA kernels (64 x 64 tiles) that
// keep full f32 precision; they serve the tests and ragged shapes.
//
// Not yet done (later work): wgmma and TMA, a warp-specialized pipeline, the
// in-kernel activation of the TPU gmm.
//
// Layouts: x (M, D) and dy (M, H) contiguous; w (E, D, H) contiguous, or
// (E, H, D) contiguous read as its transpose (w_nk); bias (E, H); groups
// (M / block_rows,) int32; n_live (1,) int32; out (M, H); offsets (E + 1,)
// int32; dw (E, D, H); db (E, H).  bf16 needs D and H multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kThreads = 128;  // bf16 kernels: 4 warps of 64 x 64, 2 x 2
constexpr int kF32Threads = 256;  // float32 kernels: 16 x 16 threads of 4 x 4
constexpr int BM = 128, BN = 128, BK = 32, kStages = 4;
constexpr int LD_K = BK + 8;   // tile stored [row][k]: 80-byte rows
constexpr int LD_N = BN + 8;   // tile stored [k][col]: 272-byte rows
constexpr int LD_M = BM + 8;
constexpr int FT = 64, FK = 16;  // float32 kernels: 64 x 64 tiles, 16-deep k

struct GmmParams {
  const void* x;
  const void* w;
  const void* bias;  // may be null
  const int* groups;
  const int* n_live;
  void* out;
  int M, K, N, block_rows, tiles_per_block, out_f32;
};

struct TgmmParams {
  const void* x;
  const void* dy;
  const int* offsets;
  void* dw;
  void* db;  // may be null
  int D, H, out_f32;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// mma.sync building blocks (as in flash_attention.cu).  Fragment layouts
// (lane = 4g + t): A 16x16 {a0: (g, 2t..2t+1), a1: (g+8, 2t..), a2: (g,
// 2t+8..), a3: (g+8, 2t+8..)}; B 16x8 {b0: (k 2t..2t+1, n g), b1: (k 2t+8..,
// n g)}; C 16x8 {c0,c1: (g, 2t..2t+1), c2,c3: (g+8, 2t..2t+1)}.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16x16 block at (m0, k0) of a tile stored [m][k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (m0 + (q & 1) * 8 + r) * ld + k0 + (q >> 1) * 8);
}

// The same from a tile stored [k][m] (x for x^T dy), transposed by ldmatrix.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* tile,
                                             int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  ldsm_x4_trans(a, tile + (k0 + (q >> 1) * 8 + r) * ld + m0 + (q & 1) * 8);
}

// B fragments of the n8 tiles n0 and n0 + 8 over k [k0, k0 + 16) from a tile
// stored [n][k]: b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (n0 + (q >> 1) * 8 + r) * ld + k0 + (q & 1) * 8);
}

// The same from a tile stored [k][n], transposed by ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b, tile + (k0 + (q & 1) * 8 + r) * ld + n0 + (q >> 1) * 8);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ROWS x COLS tile of the row-major matrix `src` (row stride ld_g) at (r0, c0)
// into shared memory (leading dim LD), asynchronously, 16 bytes a thread;
// zero-filled at rows >= r_end and columns >= c_end (c_end a multiple of 8).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src, long long ld_g,
                                           int r0, int r_end, int c0, int c_end) {
  constexpr int VPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = r0 + r < r_end && c0 + c < c_end;
    const bf16* p = in ? src + (long long)(r0 + r) * ld_g + c0 + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * LD + c)), "l"(p), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void store2(void* out, long long idx, float v0, float v1,
                                       int out_f32) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
        __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store1(void* out, long long idx, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
}

// The row range of this block's row tile: [r0, r_end) inside row block blk.
struct RowTile {
  int blk, r0, r_end;
};

__device__ __forceinline__ RowTile row_tile(const GmmParams& p, int tile_rows) {
  RowTile t;
  t.blk = blockIdx.y / p.tiles_per_block;
  t.r0 = t.blk * p.block_rows + (blockIdx.y % p.tiles_per_block) * tile_rows;
  t.r_end = min(t.r0 + tile_rows, (t.blk + 1) * p.block_rows);
  return t;
}

// A dead tail block: zeros over the tile's rows and columns [n0, n_end).
__device__ __forceinline__ void write_zeros(const GmmParams& p, const RowTile& t,
                                            int n0, int n_end) {
  const int cols = n_end - n0;
  for (int i = threadIdx.x; i < (t.r_end - t.r0) * cols; i += blockDim.x)
    store1(p.out, (long long)(t.r0 + i / cols) * p.N + n0 + i % cols, 0.0f, p.out_f32);
}

// ===========================================================================
// bf16 gmm: mma.sync, 128 x 128 tiles, 4 warps of 64 x 64
// ===========================================================================

template <bool W_NK>
constexpr size_t gmm_smem() {
  return (size_t)kStages * (BM * LD_K + (W_NK ? BN * LD_K : BK * LD_N)) * sizeof(bf16);
}

template <bool W_NK>
__global__ void __launch_bounds__(kThreads) gmm_mma_kernel(GmmParams p) {
  constexpr int A_TILE = BM * LD_K;
  constexpr int B_TILE = W_NK ? BN * LD_K : BK * LD_N;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * A_TILE;

  const int n0 = blockIdx.x * BN;
  const RowTile t = row_tile(p, BM);
  if (t.blk >= *p.n_live) {
    write_zeros(p, t, n0, min(n0 + BN, p.N));
    return;
  }
  const int g = p.groups[t.blk];
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w) + (long long)g * p.K * p.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int n_k = cdiv(p.K, BK);

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    load_async<BM, BK, LD_K>(sA + s * A_TILE, x, p.K, t.r0, t.r_end, k0, p.K);
    if (W_NK)  // w holds (N, K) per group: tile [n][k]
      load_async<BN, BK, LD_K>(sB + s * B_TILE, w, p.K, n0, p.N, k0, p.K);
    else       // w holds (K, N) per group: tile [k][n]
      load_async<BK, BN, LD_N>(sB + s * B_TILE, w, p.N, k0, p.K, n0, p.N);
  };

  float acc[4][8][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load_stage(nxt, nxt % kStages);
    cp_async_commit();
    const bf16* a = sA + (kt % kStages) * A_TILE;
    const bf16* b = sB + (kt % kStages) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) load_a(af[mt], a, LD_K, wm + mt * 16, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        if (W_NK)
          load_b_nk(bf, b, LD_K, wn + j * 16, kk);
        else
          load_b_kn(bf, b, LD_N, kk, wn + j * 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * j], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, tc = lane & 3;
  const bf16* bias = static_cast<const bf16*>(p.bias);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn + nt * 8 + 2 * tc;
    if (col >= p.N) continue;  // N % 8 == 0: col + 1 is in range too
    float b0 = 0.0f, b1 = 0.0f;
    if (bias) {
      b0 = __bfloat162float(bias[(long long)g * p.N + col]);
      b1 = __bfloat162float(bias[(long long)g * p.N + col + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t.r0 + wm + mt * 16 + gr + r * 8;
        if (row < t.r_end)
          store2(p.out, (long long)row * p.N + col, acc[mt][nt][2 * r] + b0,
                 acc[mt][nt][2 * r + 1] + b1, p.out_f32);
      }
  }
}

// ===========================================================================
// bf16 tgmm: mma.sync, 128 (d) x 128 (h) tiles over the group's rows
// ===========================================================================

constexpr size_t tgmm_smem() {
  return (size_t)kStages * BK * (LD_M + LD_N) * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads) tgmm_mma_kernel(TgmmParams p) {
  constexpr int X_TILE = BK * LD_M, Y_TILE = BK * LD_N;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sY = sX + kStages * X_TILE;

  const int e = blockIdx.z, d0 = blockIdx.y * BM, h0 = blockIdx.x * BN;
  const int rs = p.offsets[e], re = p.offsets[e + 1];
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* dy = static_cast<const bf16*>(p.dy);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int n_k = cdiv(max(re - rs, 0), BK);
  const bool rowsum = p.db != nullptr && blockIdx.y == 0 && threadIdx.x < BN;

  auto load_stage = [&](int kt, int s) {
    const int row0 = rs + kt * BK;
    load_async<BK, BM, LD_M>(sX + s * X_TILE, x, p.D, row0, re, d0, p.D);
    load_async<BK, BN, LD_N>(sY + s * Y_TILE, dy, p.H, row0, re, h0, p.H);
  };

  float acc[4][8][4] = {};
  float rsum = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load_stage(nxt, nxt % kStages);
    cp_async_commit();
    const bf16* a = sX + (kt % kStages) * X_TILE;
    const bf16* b = sY + (kt % kStages) * Y_TILE;
    if (rowsum) {  // rows past the group's end are zero-filled
#pragma unroll 8
      for (int r = 0; r < BK; ++r) rsum += __bfloat162float(b[r * LD_N + threadIdx.x]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) load_a_trans(af[mt], a, LD_M, wm + mt * 16, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        load_b_kn(bf, b, LD_N, kk, wn + j * 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * j], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, tc = lane & 3;
  const long long base = (long long)e * p.D * p.H;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h0 + wn + nt * 8 + 2 * tc;
    if (col >= p.H) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = d0 + wm + mt * 16 + gr + r * 8;
        if (row < p.D)
          store2(p.dw, base + (long long)row * p.H + col, acc[mt][nt][2 * r],
                 acc[mt][nt][2 * r + 1], p.out_f32);
      }
  }
  if (rowsum && h0 + threadIdx.x < p.H)
    store1(p.db, (long long)e * p.H + h0 + threadIdx.x, rsum, p.out_f32);
}

// ===========================================================================
// float32: shared-memory FMA, 64 x 64 tiles, each thread 4 x 4 (strided by 16)
// ===========================================================================

template <bool W_NK>
__global__ void __launch_bounds__(kF32Threads) gmm_f32_kernel(GmmParams p) {
  __shared__ float sA[FK][FT + 4];  // [k][row]
  __shared__ float sB[FK][FT + 4];  // [k][col]
  const int n0 = blockIdx.x * FT;
  const RowTile t = row_tile(p, FT);
  if (t.blk >= *p.n_live) {
    write_zeros(p, t, n0, min(n0 + FT, p.N));
    return;
  }
  const int g = p.groups[t.blk];
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w) + (long long)g * p.K * p.N;
  const int tr = threadIdx.x / 16, tcol = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FK) {
    for (int i = threadIdx.x; i < FT * FK; i += kF32Threads) {
      const int r = i / FK, k = i % FK;
      sA[k][r] = (t.r0 + r < t.r_end && k0 + k < p.K)
                     ? x[(long long)(t.r0 + r) * p.K + k0 + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < FK * FT; i += kF32Threads) {
      const int k = i / FT, c = i % FT, kk = k0 + k, n = n0 + c;
      float v = 0.0f;
      if (kk < p.K && n < p.N) v = W_NK ? w[(long long)n * p.K + kk] : w[(long long)kk * p.N + n];
      sB[k][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sA[k][tr + 16 * i] * sB[k][tcol + 16 * j];
    __syncthreads();
  }
  const float* bias = static_cast<const float*>(p.bias);
  for (int i = 0; i < 4; ++i) {
    const int row = t.r0 + tr + 16 * i;
    if (row >= t.r_end) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tcol + 16 * j;
      if (col < p.N)
        store1(p.out, (long long)row * p.N + col,
               acc[i][j] + (bias ? bias[(long long)g * p.N + col] : 0.0f), p.out_f32);
    }
  }
}

__global__ void __launch_bounds__(kF32Threads) tgmm_f32_kernel(TgmmParams p) {
  __shared__ float sX[FK][FT + 4];  // [row][d]
  __shared__ float sY[FK][FT + 4];  // [row][h]
  const int e = blockIdx.z, d0 = blockIdx.y * FT, h0 = blockIdx.x * FT;
  const int rs = p.offsets[e], re = p.offsets[e + 1];
  const float* x = static_cast<const float*>(p.x);
  const float* dy = static_cast<const float*>(p.dy);
  const int tr = threadIdx.x / 16, tcol = threadIdx.x % 16;
  const bool rowsum = p.db != nullptr && blockIdx.y == 0 && threadIdx.x < FT;
  float acc[4][4] = {};
  float rsum = 0.0f;
  for (int row0 = rs; row0 < re; row0 += FK) {
    for (int i = threadIdx.x; i < FK * FT; i += kF32Threads) {
      const int k = i / FT, c = i % FT, row = row0 + k;
      sX[k][c] = (row < re && d0 + c < p.D) ? x[(long long)row * p.D + d0 + c] : 0.0f;
      sY[k][c] = (row < re && h0 + c < p.H) ? dy[(long long)row * p.H + h0 + c] : 0.0f;
    }
    __syncthreads();
    if (rowsum)
      for (int k = 0; k < FK; ++k) rsum += sY[k][threadIdx.x];
#pragma unroll
    for (int k = 0; k < FK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sX[k][tr + 16 * i] * sY[k][tcol + 16 * j];
    __syncthreads();
  }
  const long long base = (long long)e * p.D * p.H;
  for (int i = 0; i < 4; ++i) {
    const int row = d0 + tr + 16 * i;
    if (row >= p.D) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = h0 + tcol + 16 * j;
      if (col < p.H) store1(p.dw, base + (long long)row * p.H + col, acc[i][j], p.out_f32);
    }
  }
  if (rowsum && h0 + threadIdx.x < p.H)
    store1(p.db, (long long)e * p.H + h0 + threadIdx.x, rsum, p.out_f32);
}

// ===========================================================================
// host side
// ===========================================================================

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Params& params) {
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(params);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; out_f32: write float32 (else the input
// dtype).  w_nk: w is the transpose view of a contiguous (E, N, K) tensor.
// Returns a cudaError_t.
int gmm_launch(const void* x, const void* w, const void* bias, const int* groups,
               const int* n_live, void* out, int M, int K, int N, int block_rows,
               int w_nk, int dtype, int out_f32, void* stream) {
  GmmParams p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.groups = groups;
  p.n_live = n_live;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.block_rows = block_rows;
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = M / block_rows;
  if (dtype == 1) {
    p.tiles_per_block = cdiv(block_rows, BM);
    const dim3 grid(cdiv(N, BN), n_blocks * p.tiles_per_block);
    return w_nk ? launch(gmm_mma_kernel<true>, grid, kThreads, gmm_smem<true>(), s, p)
                : launch(gmm_mma_kernel<false>, grid, kThreads, gmm_smem<false>(), s, p);
  }
  p.tiles_per_block = cdiv(block_rows, FT);
  const dim3 grid(cdiv(N, FT), n_blocks * p.tiles_per_block);
  return w_nk ? launch(gmm_f32_kernel<true>, grid, kF32Threads, 0, s, p)
              : launch(gmm_f32_kernel<false>, grid, kF32Threads, 0, s, p);
}

// offsets: (E + 1,) int32 row offsets of each group's rows; db may be null.
int tgmm_launch(const void* x, const void* dy, const int* offsets, void* dw, void* db,
                int E, int D, int H, int dtype, int out_f32, void* stream) {
  TgmmParams p;
  p.x = x;
  p.dy = dy;
  p.offsets = offsets;
  p.dw = dw;
  p.db = db;
  p.D = D;
  p.H = H;
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch(tgmm_mma_kernel, dim3(cdiv(H, BN), cdiv(D, BM), E), kThreads,
                  tgmm_smem(), s, p);
  return launch(tgmm_f32_kernel, dim3(cdiv(H, FT), cdiv(D, FT), E), kF32Threads, 0, s,
                p);
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
