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
// throughput (~0.16 ms at 989 TFLOP/s), not memory (~0.1 ms).  Only wgmma
// reaches that rate, and only when its operands arrive without costing the
// consumers instructions.
//
// Three designs; ops/gmm.py's gmm_design() picks one from the shapes alone
// (never on failure):
//
// 1. wgmma (bf16, block_rows a multiple of 128, D and H multiples of 64,
//    16-byte aligned bases): the path's kernels, gmm_wgmma_kernel and
//    tgmm_wgmma_kernel.  A persistent grid of one 384-thread block per SM
//    walks output tiles of 128 x 192.  One producer warp (warpgroup 2, its
//    registers given up with setmaxnreg) issues TMA loads of 64-deep k tiles
//    into a four-stage ring of 128-byte-swizzled shared memory, each stage
//    guarded by an mbarrier pair (full: the bytes landed; empty: every
//    reader is done with it).  Two consumer warpgroups each run wgmma
//    m64n192k16 on 64 rows of the tile, reading both operands from shared
//    memory through descriptors (no ldmatrix, no address arithmetic, no
//    __syncthreads in the main loop), one group of products in flight
//    while the next stage is waited for.  The producer runs ahead into the
//    next tile while the consumers write the last one out, so one tile's
//    epilogue overlaps the next tile's loads.  No branch near the wgmma
//    depends on the thread (ptxas would serialize them: advisory C7518).
//    Every operand
//    layout is read in place by the transpose bits of wgmma:
//      gmm,  w (E, D, H)          A = x K-major,  B = w MN-major (3-D map,
//                                 the group is a TMA coordinate)
//      gmm,  w^T of (E, H, D)     A = x K-major,  B = w K-major (dx pass)
//      tgmm, x^T dy               A = x MN-major, B = dy MN-major
//    Tile width 192 divides the path's N = 768 and 3072 into 4 and 16
//    column tiles: the live tiles of a launch come to whole rounds of 132
//    SMs more nearly than with 128 or 256 (PERF.md counts them).
//
//    gmm: tiles are (128-row tile, column tile), columns fastest, so the
//    blocks in flight share one group's weight panel in L2.  A row tile lies
//    in one row block, so it has one group; each tile reads its group and
//    the live-block count from device memory (the TPU kernel's scalar
//    prefetch): no host sync.  A dead tail tile writes zeros and loads
//    nothing.  The bias is added in f32 before rounding; bf16 output goes
//    through swizzled shared memory and leaves by TMA store, float32 output
//    as 32-byte quad stores straight from the accumulators.
//
//    tgmm: tiles are (group, 128-row d tile, 192-column h tile); each loops
//    over its group's rows [offsets[e], offsets[e+1]) in 64-row k tiles (the
//    TPU kernel's sequential grid, carried in registers).  The offsets come
//    from the block map and the live count through group_offsets_kernel,
//    which tgmm_launch enqueues just before every tgmm kernel, so the
//    wrapper's host work before a launch stays small.  Offsets are
//    multiples of block_rows, so a k tile never straddles two groups.  The
//    groups are walked largest first (every block ranks them from the
//    offsets), so an imbalanced routing does not leave its biggest group's
//    tiles to the last round.  No split over rows and no atomics: each tile
//    is summed by one block in a fixed order, so a launch is deterministic.
//    A group with no rows writes zeros.  The row sum for db is taken from
//    the swizzled dy tiles already in shared memory by the producer
//    warpgroup's three spare warps (the d tiles of an h tile split its
//    columns, so no block reads more than a sixth of each dy tile at the
//    path shapes), which release each stage like a consumer and reduce
//    across lanes in a fixed order.
//
// 2. mma.sync (every other bf16 shape: block_rows any multiple of 8, D and H
//    multiples of 8): gmm_mma_kernel and tgmm_mma_kernel, the first port's
//    design, kept for ragged shapes that TMA tiles do not fit (a 128-row
//    tile would straddle row blocks, a 64-wide box would cross D or H).
//    mma.sync m16n8k16 with ldmatrix operands, a four-stage cp.async ring,
//    4 warps of 64 x 64 on 128 x 128 tiles, one block per output tile; rows
//    past a row block's end are masked.
//
// 3. FMA (float32): shared-memory FMA kernels on 64 x 64 tiles, which keep
//    full f32 precision for the tests and ragged shapes.
//
// Not yet done (later work): the in-kernel activation of the TPU gmm.
//
// Layouts: x (M, D) and dy (M, H) contiguous; w (E, D, H) contiguous, or
// (E, H, D) contiguous read as its transpose (w_nk); bias (E, H); groups
// (M / block_rows,) int32; n_live (1,) int32; out (M, H); offsets (E + 1,)
// int32, written by group_offsets_kernel ahead of every tgmm kernel; dw
// (E, D, H); db (E, H).  bf16 needs D and H multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors, make_map

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
// bf16 wgmma design: TMA ring, warp-specialized, persistent
// ===========================================================================

constexpr int WM = 128, WN = 192, WK = 64, kWStages = 4;
constexpr int kWThreads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
// setmaxnreg moves registers between the warpgroups from the 168 a thread
// each has at launch (65536 / 384, rounded down to a multiple of 8): the
// consumers can only take what the producer gives up
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 384 * 168,
              "setmaxnreg.inc would wait forever for registers");
constexpr int CHUNK = 64 * 128;     // one 64-row box of 64 bf16 (128 B) rows
constexpr int A_BYTES = WM * WK * 2;                  // 16 KB
constexpr int B_BYTES = WK * WN * 2;                  // 24 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGING_BYTES = 2 * (WN / 64) * CHUNK;  // 3 out boxes a warpgroup
constexpr int BARS_OFF = kWStages * STAGE_BYTES + STAGING_BYTES;

// dynamic shared memory of a wgmma kernel: 1 KB of slack to align the ring
// to the 1024-byte period of the 128-byte swizzle, the ring, the staging
// buffers, the barriers, and tgmm's row-sum warps' scratch
constexpr int kScratch = 96;
constexpr size_t wgmma_smem() {
  return 1024 + (size_t)BARS_OFF + 2 * kWStages * 8 + kScratch * 4;
}
static_assert(wgmma_smem() <= 232448, "more shared memory than a block can have");

#define WG_F8(i)                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 192, f32) += A (64 x 16) B (16 x 192), both read from shared memory.
// TA / TB: 0 = K-major, 1 = MN-major.  Accumulator layout (thread t of the
// warpgroup, warp w = t / 32, lane l): d[4j + {0,1}] at row 16w + l/4,
// columns 8j + 2(l%4) + {0,1}; d[4j + {2,3}] at row 16w + l/4 + 8.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40),
        WG_F8(48), WG_F8(56), WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef WG_F8

// One 64-deep k tile of a warpgroup's 64 x 192 product: four k16 steps.
// a, b: shared addresses of its A rows and of the B tile; A_MN / B_MN say
// which operand is MN-major (64-k-row boxes, a k16 step 2 KB further) rather
// than K-major (a k16 step 32 B further).
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void wgmma_k_tile(float (&acc)[96], uint32_t a, uint32_t b) {
  wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk) {
    const uint64_t da = A_MN ? wgmma_desc(a + kk * 2048, CHUNK, 1024)
                             : wgmma_desc(a + kk * 32, 16, 1024);
    const uint64_t db = B_MN ? wgmma_desc(b + kk * 2048, CHUNK, 1024)
                             : wgmma_desc(b + kk * 32, 16, 1024);
    wgmma_192<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
  }
  wgmma_commit();
}

// The shared-memory carve-up of a wgmma kernel, and its ring position.
struct Ring {
  unsigned char* gen;  // generic pointer to the 1024-aligned ring
  uint32_t base;       // its shared address
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ uint32_t a(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + BARS_OFF + s * 8; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BARS_OFF + (kWStages + s) * 8;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == kWStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem) {
  Ring r;
  const uint32_t raw = smem_addr(smem);
  const uint32_t aligned = (raw + 1023) & ~1023u;
  r.gen = smem + (aligned - raw);
  r.base = aligned;
  return r;
}

// Barriers: full[s] completes on the producer's expect_tx arrival plus the
// stage's bytes; empty[s] on one arrival from each of `readers` warps.
__device__ __forceinline__ void init_ring(const Ring& r, int readers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), readers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The consumer warp's release of a stage it has finished reading.
__device__ __forceinline__ void release(const Ring& r, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty(s));
}

// A consumer warpgroup's walk over the n_k stages of one tile: wait for each
// stage, issue its products (A rows at a_off in the stage), and release the
// stage before once its products are done, so one group of products is
// always in flight.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void consume(Ring& ring, float (&acc)[96], int n_k,
                                        uint32_t a_off) {
  int prev = -1;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = ring.stage;
    mbar_wait(ring.full(s), ring.phase);
    wgmma_k_tile<A_MN, B_MN>(acc, ring.a(s) + a_off, ring.b(s));
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0) release(ring, prev);
    prev = s;
    ring.advance();
  }
  if (prev >= 0) {
    wgmma_wait<0>();
    fence_acc(acc);
    release(ring, prev);
  }
}

// A thread's bias pairs for its accumulator columns of the tile at col0
// (zero past col_end, or with no bias), loaded before the products so that
// their latency hides behind them.
__device__ __forceinline__ void load_bias(__nv_bfloat162 (&bv)[WN / 8], const bf16* bias,
                                          int col0, int col_end) {
  const int c_lo = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = col0 + 8 * j + c_lo;
    bv[j] = bias != nullptr && col < col_end
                ? *reinterpret_cast<const __nv_bfloat162*>(bias + col)
                : __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

// Writes a warpgroup's 64 x 192 accumulator tile at (row0, col0) of the
// output, if row0 < row_end (then all 64 rows are in range: row_end is a
// multiple of 64), at columns below col_end (a multiple of 8), plus the
// thread's bias pairs (load_bias) in f32.  No branch here depends on the
// thread or its warpgroup: one around a use of the accumulators would make
// the compiler serialize the wgmma.  So a warpgroup past row_end stores its
// float32 into its staging instead, and the bf16 TMA store clips it.  float32 leaves as 8-byte pairs, four lanes
// filling one 32-byte sector, into `out` (row stride ld); bf16 through
// `out_map` (2-D, or 3-D at `group` when group >= 0).
__device__ __forceinline__ void store_tile(const float (&acc)[96], const CUtensorMap* out_map,
                                           int group, void* out, long long ld, int row0,
                                           int row_end, int col0, int col_end,
                                           const __nv_bfloat162 (&bias)[WN / 8],
                                           int out_f32, unsigned char* staging,
                                           int bar_id) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  const int r_lo = 16 * w + (l >> 2), c_lo = 2 * (l & 3);
  if (out_f32) {
    const bool rows_in = row0 < row_end;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      if (col0 + 8 * j >= col_end) break;
      const int col = col0 + 8 * j + c_lo;
      const float b0 = __low2float(bias[j]), b1 = __high2float(bias[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(rows_in ? out : staging,
               rows_in ? (long long)(row0 + r_lo + 8 * h) * ld + col : 2 * t,
               acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1, 1);
    }
    return;
  }
  // bf16: into the warpgroup's three 64 x 64 swizzled staging boxes (each
  // lane's 4 bytes land in its own bank), then out by TMA stores that one
  // thread issues and nobody waits for until the staging is needed again
  if (t == 0) tma_store_wait_read();
  named_bar(bar_id, 128);  // the last tile's stores have read the staging
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const float b0 = __low2float(bias[j]), b1 = __high2float(bias[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(staging + (j / 8) * CHUNK + r * 128 +
                                         (((j % 8) ^ (r & 7)) * 16) + c_lo * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  fence_async_shared();
  named_bar(bar_id, 128);
  if (t == 0) {
    const uint32_t src = smem_addr(staging);
    for (int c = 0; c < WN / 64 && col0 + 64 * c < col_end; ++c) {
      if (group < 0)
        tma_store_2d(out_map, src + c * CHUNK, col0 + 64 * c, row0);
      else
        tma_store_3d(out_map, src + c * CHUNK, col0 + 64 * c, row0, group);
    }
    tma_store_commit();
  }
}

// Zeros over a warpgroup's rows [row0, row0 + 64) and columns [col0,
// col_end) of `out` (element size es), as 16-byte vectors.
__device__ __forceinline__ void zero_tile(void* out, long long ld, int row0, int col0,
                                          int col_end, int es) {
  const int vecs = (col_end - col0) * es / 16;
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int i = threadIdx.x & 127; i < 64 * vecs; i += 128)
    *reinterpret_cast<uint4*>(o + ((long long)(row0 + i / vecs) * ld + col0) * es +
                              (i % vecs) * 16) = make_uint4(0, 0, 0, 0);
}

// gmm: persistent over (128-row tile, 192-column tile), columns fastest.
// map_x: x as (M, K), boxes of 128 rows x 64 k.  map_w: w as (E, K, N) with
// boxes of 64 k x 64 n (MN-major), or, W_NK, as (E, N, K) with boxes of 192
// n x 64 k (K-major).  map_out: out as (M, N) in 64 x 64 boxes (bf16 only).
// block_rows is a multiple of 128, K of 64.
template <bool W_NK>
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out, GmmParams p) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = make_ring(smem_raw);
  init_ring(ring, kConsumers / 32);
  const int n_col = cdiv(p.N, WN);
  const int n_tiles = (p.M / WM) * n_col;
  const int tiles_per_block = p.block_rows / WM;
  const int n_k = p.K / WK;
  const int n_live = *p.n_live;

  // the role, from a warp-uniform value: a branch on threadIdx itself would
  // put the wgmma on a divergent path, which serializes them
  if (__shfl_sync(0xffffffff, threadIdx.x / 32, 0) >= kConsumers / 32) {
    // producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int rt = tile / n_col, n0 = (tile % n_col) * WN;
      const int blk = rt / tiles_per_block;
      if (blk >= n_live) continue;
      const int g = p.groups[blk];
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = ring.stage;
        mbar_wait(ring.empty(s), ring.phase ^ 1);
        mbar_expect_tx(ring.full(s), STAGE_BYTES);
        tma_load_2d(ring.a(s), &map_x, ring.full(s), kt * WK, rt * WM);
        if (W_NK) {
          tma_load_3d(ring.b(s), &map_w, ring.full(s), kt * WK, n0, g);
        } else {
#pragma unroll
          for (int c = 0; c < WN / 64; ++c)
            tma_load_3d(ring.b(s) + c * CHUNK, &map_w, ring.full(s), n0 + 64 * c,
                        kt * WK, g);
        }
        ring.advance();
      }
    }
  } else {  // consumer warpgroups: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);  // uniform
    unsigned char* staging = ring.gen + kWStages * STAGE_BYTES + wg * (STAGING_BYTES / 2);
    const bf16* bias = static_cast<const bf16*>(p.bias);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int rt = tile / n_col, n0 = (tile % n_col) * WN;
      const int blk = rt / tiles_per_block;
      const int row0 = rt * WM + 64 * wg, col_end = min(n0 + WN, p.N);
      if (blk >= n_live) {  // dead tail: zeros, no product
        zero_tile(p.out, p.N, row0, n0, col_end, p.out_f32 ? 4 : 2);
        continue;
      }
      const int g = p.groups[blk];
      __nv_bfloat162 bv[WN / 8];
      load_bias(bv, bias ? bias + (long long)g * p.N : nullptr, n0, col_end);
      float acc[96];
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
      consume<false, !W_NK>(ring, acc, n_k, wg * CHUNK);
      store_tile(acc, &map_out, -1, p.out, p.N, row0, row0 + 64, n0, col_end, bv,
                 p.out_f32, staging, 2 + wg);
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait();
  }
}

// tgmm: persistent over (group, 128-row d tile, 192-column h tile), groups
// largest first.  map_x: x as (M, D), map_dy: dy as (M, H), both in boxes of
// 64 rows x 64 columns (MN-major operands: x^T and dy).  map_out: dw as
// (E, D, H) in 64 x 64 boxes (bf16 only).  Offsets are multiples of 64.
template <bool WITH_DB>
__global__ void __launch_bounds__(kWThreads, 1)
    tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_out, TgmmParams p,
                      int n_groups) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = make_ring(smem_raw);
  const int n_d = cdiv(p.D, WM), n_h = cdiv(p.H, WN), per_group = n_d * n_h;
  const int n_tiles = n_groups * per_group;
  // db: the n_d tiles of one (group, h tile) split its 24 column groups of
  // 8 columns, per_dt each, among up to 3 summer warps of gw groups each
  // (gw a power of two, >= 2: lanes split evenly into row slices)
  const int per_dt = cdiv(WN / 8, n_d);
  int gw = 2;  // at least 4 rows a lane (a batch of loads)
  while (gw * 3 < per_dt) gw *= 2;
  const int sum_warps = WITH_DB ? cdiv(per_dt, gw) : 0;
  init_ring(ring, kConsumers / 32 + sum_warps);

  struct Tile {
    int e, dt, h0, rs, n_k;
  };
  // the group of rank r by row count, largest first (ties: lower index
  // first), from the offsets in device memory: every role computes it the
  // same way, and it stays uniform across the block in the compiler's eyes
  // (a group read back from shared memory is not, and a k loop bounded by it
  // would serialize the wgmma)
  auto group_at_rank = [&](int r) {
    for (int e = 0; e < n_groups; ++e) {
      const int ce = p.offsets[e + 1] - p.offsets[e];
      int rank = 0;
      for (int f = 0; f < n_groups; ++f) {
        const int cf = p.offsets[f + 1] - p.offsets[f];
        rank += cf > ce || (cf == ce && f < e);
      }
      if (rank == r) return e;
    }
    return 0;
  };
  auto tile_at = [&](int tile) {
    Tile t;
    t.e = group_at_rank(tile / per_group);
    const int rem = tile % per_group;
    t.dt = rem / n_h;
    t.h0 = (rem % n_h) * WN;
    t.rs = p.offsets[t.e];
    t.n_k = (p.offsets[t.e + 1] - t.rs) / WK;
    return t;
  };

  if (__shfl_sync(0xffffffff, threadIdx.x / 32, 0) >= kConsumers / 32) {  // see gmm
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int st = threadIdx.x - kConsumers - 32;  // row-sum thread, warps 9-11
    if (st < 0) {  // warp 8: one thread loads
      if (threadIdx.x != kConsumers) return;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile t = tile_at(tile);
        for (int kt = 0; kt < t.n_k; ++kt) {
          const int s = ring.stage, row = t.rs + kt * WK;
          mbar_wait(ring.empty(s), ring.phase ^ 1);
          mbar_expect_tx(ring.full(s), STAGE_BYTES);
          tma_load_2d(ring.a(s), &map_x, ring.full(s), t.dt * WM, row);
          tma_load_2d(ring.a(s) + CHUNK, &map_x, ring.full(s), t.dt * WM + 64, row);
#pragma unroll
          for (int c = 0; c < WN / 64; ++c)
            tma_load_2d(ring.b(s) + c * CHUNK, &map_dy, ring.full(s), t.h0 + 64 * c, row);
          ring.advance();
        }
      }
      return;
    }
    // warps 9-11: the row sums for db, from the dy tiles in the ring, off the
    // consumers' path; each stage waits for their release too.  Summer warp
    // sw takes gw column groups of its tile's share; its lane (slice, gi)
    // adds rows slice, slice + slices, ... of group sw * gw + gi (a load
    // instruction reads `slices` rows in distinct swizzle slots: no bank
    // conflict), and the slices are then summed across lanes in a fixed
    // butterfly order.  Spread so, each warp issues few instructions beside
    // the consumer warps that share its scheduler.
    const int sw = st >> 5, lane = st & 31;
    if (!WITH_DB || sw >= sum_warps) return;
    const int slices = 32 / gw, slice = lane / gw, rows = WK / slices;
    float* scratch = reinterpret_cast<float*>(ring.gen + BARS_OFF + 2 * kWStages * 8) + 32 * sw;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile t = tile_at(tile);
      const int q = sw * gw + lane % gw, grp = t.dt * per_dt + q;
      // every lane loads (an idle lane a valid group, weighted 0): no lane-
      // dependent branch, which would make the compiler serialize the
      // consumers' wgmma
      const bool active = q < per_dt && grp < WN / 8;
      const int g_rd = min(grp, WN / 8 - 1);
      const float weight = active ? 1.0f : 0.0f;
      float rsum[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) rsum[j] = 0.0f;
      for (int kt = 0; kt < t.n_k; ++kt) {
        const int s = ring.stage;
        mbar_wait(ring.full(s), ring.phase);
        const unsigned char* box = ring.gen + (ring.b(s) - ring.base) + (g_rd / 8) * CHUNK;
        for (int i0 = 0; i0 < rows; i0 += 4) {
          uint4 v[4];  // four loads in flight, then their sums
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = slice + slices * (i0 + i);
            v[i] = *reinterpret_cast<const uint4*>(box + r * 128 + (((g_rd % 8) ^ (r & 7)) * 16));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(q2[j]);
              rsum[2 * j] = fmaf(weight, f.x, rsum[2 * j]);
              rsum[2 * j + 1] = fmaf(weight, f.y, rsum[2 * j + 1]);
            }
          }
        }
        release(ring, s);
        ring.advance();
      }
      for (int m = gw; m < 32; m *= 2) {
#pragma unroll
        for (int j = 0; j < 8; ++j) rsum[j] += __shfl_xor_sync(0xffffffff, rsum[j], m);
      }
      // all slice lanes of a group now hold its sums and all store them; an
      // idle lane, or a column past H, stores into a scratch word instead
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = active && t.h0 + grp * 8 + j < p.H;
        const long long at = (long long)t.e * p.H + t.h0 + g_rd * 8 + j;
        void* dst = ok ? (p.out_f32 ? static_cast<void*>(static_cast<float*>(p.db) + at)
                                    : static_cast<void*>(static_cast<bf16*>(p.db) + at))
                       : static_cast<void*>(scratch + lane);
        store1(dst, 0, rsum[j], p.out_f32);
      }
    }
  } else {  // consumer warpgroups: 64 d rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);  // uniform
    unsigned char* staging = ring.gen + kWStages * STAGE_BYTES + wg * (STAGING_BYTES / 2);
    const int es = p.out_f32 ? 4 : 2;
    __nv_bfloat162 no_bias[WN / 8];
    load_bias(no_bias, nullptr, 0, 0);
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile t = tile_at(tile);
      float acc[96];
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
      consume<true, true>(ring, acc, t.n_k, wg * CHUNK);
      store_tile(acc, &map_out, t.e,
                 static_cast<unsigned char*>(p.dw) + (long long)t.e * p.D * p.H * es, p.H,
                 t.dt * WM + 64 * wg, p.D, t.h0, min(t.h0 + WN, p.H), no_bias, p.out_f32,
                 staging, 2 + wg);
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait();
  }
}

// tgmm's row offsets from the sorted block map, on the device (no host sync):
// offsets[e] = block_rows x the live blocks of groups below e, so group e's
// rows are [offsets[e], offsets[e + 1]); blocks from n_live on belong to no
// group.  Block i (and i = live, the end) writes the offsets of the groups
// that start there: each entry is written once, and empty groups get an
// empty range.  ops/gmm.py's group_offsets() is its plain version.
__global__ void group_offsets_kernel(const int* groups, const int* n_live, int n_blocks,
                                     int E, int block_rows, int* offsets) {
  const int live = n_live ? max(0, min(*n_live, n_blocks)) : n_blocks;
  for (int i = threadIdx.x; i <= live; i += blockDim.x) {
    const int lo = i == 0 ? 0 : groups[i - 1] + 1;
    const int hi = i == live ? E : min(groups[i], E);
    for (int e = lo; e <= hi; ++e) offsets[e] = i * block_rows;
  }
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

// Which kernel a call takes; ops/gmm.py's gmm_design() decides from the shapes.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2 };

// A persistent launch: one block per SM, or fewer if there are fewer tiles.
template <typename Kernel, typename... Args>
int launch_wgmma(Kernel kernel, int n_tiles, size_t smem, cudaStream_t stream,
                 const Args&... args) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<min(n_tiles, sms), kWThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; out_f32: write float32 (else the input
// dtype).  w_nk: w is the transpose view of a contiguous (E, N, K) tensor.
// design: 0 = FMA (float32), 1 = mma.sync, 2 = wgmma (bf16).  Returns a
// cudaError_t, or kErrNoEncoder / kErrEncode for a tensor map.
int gmm_launch(const void* x, const void* w, const void* bias, const int* groups,
               const int* n_live, void* out, int M, int K, int N, int E, int block_rows,
               int w_nk, int dtype, int out_f32, int design, void* stream) {
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
  if ((design == kFma) != (dtype == 0)) return cudaErrorInvalidValue;
  if (design == kWgmma) {
    if (block_rows % WM || K % WK || N % 64) return cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t x_box[2] = {WK, WM};
    int err = make_map(&map_x, x, 2, x_dims, x_strides, x_box);
    if (err != 0) return err;
    // w_nk: (E, N, K) read K-major in 192 x 64 boxes; else (E, K, N) read
    // MN-major in 64 x 64 boxes
    const cuuint64_t w_dims[3] = {(cuuint64_t)(w_nk ? K : N), (cuuint64_t)(w_nk ? N : K),
                                  (cuuint64_t)E};
    const cuuint64_t w_strides[2] = {w_dims[0] * 2, (cuuint64_t)K * N * 2};
    const cuuint32_t w_box[3] = {64, (cuuint32_t)(w_nk ? WN : WK), 1};
    err = make_map(&map_w, w, 3, w_dims, w_strides, w_box);
    if (err != 0) return err;
    CUtensorMap map_out = map_x;  // float32 output is stored without a map
    if (!out_f32) {
      const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
      const cuuint64_t o_strides[1] = {(cuuint64_t)N * 2};
      const cuuint32_t o_box[2] = {64, 64};
      err = make_map(&map_out, out, 2, o_dims, o_strides, o_box);
      if (err != 0) return err;
    }
    const int n_tiles = (M / WM) * cdiv(N, WN);
    return w_nk ? launch_wgmma(gmm_wgmma_kernel<true>, n_tiles, wgmma_smem(), s, map_x,
                               map_w, map_out, p)
                : launch_wgmma(gmm_wgmma_kernel<false>, n_tiles, wgmma_smem(), s, map_x,
                               map_w, map_out, p);
  }
  if (design == kMmaSync) {
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

// groups: the (M / block_rows,) non-decreasing block map; n_live may be null
// (every block live); offsets: (E + 1,) int32 scratch that the launch fills
// (group_offsets_kernel) before the kernel reads it; db may be null.
int tgmm_launch(const void* x, const void* dy, const int* groups, const int* n_live,
                int* offsets, void* dw, void* db, int M, int E, int D, int H,
                int block_rows, int dtype, int out_f32, int design, void* stream) {
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
  if ((design == kFma) != (dtype == 0)) return cudaErrorInvalidValue;
  if (design == kWgmma && (block_rows % WM || D % 64 || H % 64)) return cudaErrorInvalidValue;
  group_offsets_kernel<<<1, 128, 0, s>>>(groups, n_live, M / block_rows, E, block_rows,
                                          offsets);
  const cudaError_t off_err = cudaGetLastError();
  if (off_err != cudaSuccess) return off_err;
  if (design == kWgmma) {
    // offsets are multiples of block_rows, a multiple of the 128-row tile
    const size_t smem = wgmma_smem();
    CUtensorMap map_x, map_dy;
    const cuuint32_t box[2] = {64, WK};
    const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)D * 2};
    int err = make_map(&map_x, x, 2, x_dims, x_strides, box);
    if (err != 0) return err;
    const cuuint64_t dy_dims[2] = {(cuuint64_t)H, (cuuint64_t)M};
    const cuuint64_t dy_strides[1] = {(cuuint64_t)H * 2};
    err = make_map(&map_dy, dy, 2, dy_dims, dy_strides, box);
    if (err != 0) return err;
    CUtensorMap map_out = map_x;  // float32 output is stored without a map
    if (!out_f32) {
      const cuuint64_t o_dims[3] = {(cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)E};
      const cuuint64_t o_strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)D * H * 2};
      const cuuint32_t o_box[3] = {64, 64, 1};
      err = make_map(&map_out, dw, 3, o_dims, o_strides, o_box);
      if (err != 0) return err;
    }
    const int n_tiles = E * cdiv(D, WM) * cdiv(H, WN);
    return db ? launch_wgmma(tgmm_wgmma_kernel<true>, n_tiles, smem, s, map_x, map_dy,
                             map_out, p, E)
              : launch_wgmma(tgmm_wgmma_kernel<false>, n_tiles, smem, s, map_x, map_dy,
                             map_out, p, E);
  }
  if (design == kMmaSync)
    return launch(tgmm_mma_kernel, dim3(cdiv(H, BN), cdiv(D, BM), E), kThreads,
                  tgmm_smem(), s, p);
  return launch(tgmm_f32_kernel, dim3(cdiv(H, FT), cdiv(D, FT), E), kF32Threads, 0, s,
                p);
}

const char* gmm_error_string(int err) { return map_error_string(err); }

}  // extern "C"
