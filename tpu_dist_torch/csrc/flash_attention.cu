// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of tpu_dist/ops/flash_attention.py:
//   *fwd*  <- _make_fwd_kernel / _fwd_call  (online-softmax forward)
//   *dq*   <- _make_dq_kernel  / _bwd_call  (dQ over the k sweep)
//   *dkv*  <- _make_dkv_kernel / _bwd_call  (dK, dV over the q sweep)
//
// What bounds it on an H100: at the training shapes (B = 8, T = 2048, H = 12,
// D = 64, causal) the products are ~51.5 GFLOP forward and ~129 GFLOP
// backward (5 products; the split below computes 7) against ~100 MB of
// q/k/v/o, so the bound is tensor-core throughput (~0.05 / 0.13 ms at 989
// TFLOP/s), not memory.  At D = 64 the softmax's exponentials cost as much as
// the products: one exp per score on the SM's 16 special-function lanes takes
// as long as that score's 4 x 64 multiply-adds on its tensor cores, so the
// two have to overlap.  No (T, T) tensor ever reaches device memory.
//
// Three designs; ops/flash_attention.py's flash_design() picks one from the
// dtype, the head dim and the strides alone (never on failure):
//
// 1. wgmma (bf16, D = 64, strides and bases multiples of 16 bytes): the
//    path's kernels.  Persistent grids of one block per SM walk tiles
//    heaviest first (under a causal mask the last query tiles see the most
//    keys, the first key tiles the most queries).  In each block one
//    producer warp (its warpgroup's registers given up with setmaxnreg)
//    issues TMA loads through 4-D tensor maps over (D, H, T, B) with the
//    operands' own strides, so the strided q/k/v views of the fused qkv
//    projection are read in place: 64-row boxes of one head, 128 bytes a
//    row, 128-byte swizzled, into a ring of stages guarded by full/empty
//    mbarrier pairs.  The block's own rows (Q; Q and dO; K and V) are
//    double-buffered, so the next tile's load overlaps this one's end.
//    Consumer warpgroups of 64 rows run wgmma with both operands read from
//    shared memory through descriptors (K-major, or MN-major through the
//    transpose bit for V, K, Q and dO on the right of P V, dS K, P^T dO and
//    dS^T Q), and P or dS go from the f32 accumulator straight into the
//    bf16 register A operand of the next product.  Each consumer issues
//    one tile's second product and the next tile's first together and
//    waits once, so the tensor cores run them back to back while the other
//    warpgroups compute their softmax.
//      forward: 3 consumers x 64 query rows (a 192-row tile), 128-key K/V
//        tiles in a 3-stage ring; S on m64n128k16, softmax in registers
//        (exp2 with scale * log2 e folded into one multiply, the row max and
//        sum over the quad, the sum reduced once at the end), O += P V on
//        m64n64k16; O / l leaves through swizzled shared memory by TMA
//        store, lse by a store per row.
//      dQ: 2 consumers x 64 query rows, Q and dO resident, 64-key K/V tiles;
//        S = Q K^T and dP = dO V^T, dS = P (dP - delta), dQ += dS K.
//      dK/dV: 2 consumers x 64 keys, K and V resident, 64-query Q/dO tiles
//        whose lse and delta a second producer warp copies beside them;
//        S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
//    dQ and dK/dV stay separate kernels, as in the TPU kernels' split: no
//    block adds into another's output, no atomics, and a launch repeats
//    bit for bit.  The causal mask and the ragged ends are applied only on
//    tiles that cross the diagonal or the end of T, under a branch on the
//    tile (uniform), with a select per element: a thread-dependent branch
//    around an accumulator would make ptxas serialize the wgmma (advisory
//    C7518).  TMA reads zeros past the end of T, so keys and queries past
//    it are masked explicitly; stores past it are dropped by the maps.
//
// 2. mma.sync (every other bf16 head dim, D % 8 == 0, D <= 128): the first
//    port's kernels, kept for ragged head dims that the 64-wide TMA boxes do
//    not fit.  Blocks of 64 rows, 4 warps of 16, mma.sync m16n8k16 fed by
//    ldmatrix, the swept tiles double-buffered with cp.async (the
//    FlashAttention-2 layout).  Also the older design that chip_smoke.py
//    times beside the wgmma one (the wrappers' private _older=True).
//
// 3. FMA (float32): shared-memory tiles and plain FMA, full f32 precision,
//    for the tests and ragged shapes.
//
// Every design takes three masking modes (Mask below): none, causal, and the
// TPU kernels' causal="offdiag" (_tile_live), where query row q sees the
// keys of the key blocks strictly left of its query block: k < L(q) =
// floor((q / bq) * bq / bk) * bk, with bq, bk the caller's block sizes.  L is
// a per-row key limit, nondecreasing in q, so offdiag needs no diagonal
// tiles: the key sweep of a query tile ends at L of its last row, the query
// sweep of a key tile starts at the first row whose L passes the tile, and a
// tile crossing a limit (a ragged end, or a 192-row forward tile straddling
// two query blocks) takes the same select as the ragged end of the keys.
// The split_diag variant (ops/flash_attention.py) is an offdiag call plus a
// batched causal call over the diagonal bands, merged by their lse.
//
// Rows with no visible key get lse = -1e30 and o = 0, as in the TPU kernel.
// Layout: q, k, v are (B, T, H, D) with unit stride in D and any other
// strides (so the split of a fused qkv projection needs no copy); o, dO, dQ,
// dK, dV are contiguous (B, T, H, D); lse and delta are contiguous (B, H, Tq)
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors, make_map

using bf16 = __nv_bfloat16;

namespace {

constexpr float kNegInf = -1e30f;  // finite: a fully masked row stays NaN-free
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Strided {  // a (B, T, H, D) operand with unit stride in D
  const void* ptr;
  long long sb, st, sh;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The masking mode of a launch: kFull (every key), kCausal (k <= q) or
// kOffdiag (k < L(q), the key blocks strictly left of q's query block; bq and
// bk are the block sizes, used only by kOffdiag).
enum Mode { kFull = 0, kCausal = 1, kOffdiag = 2 };

struct Mask {
  int mode, bq, bk;

  // Keys [0, key_end(q)) are visible to query row q: nondecreasing in q.
  __device__ __forceinline__ int key_end(int q, int Tk) const {
    if (mode == kCausal) return min(q + 1, Tk);
    if (mode == kOffdiag) return min((q / bq) * bq / bk * bk, Tk);
    return Tk;
  }

  // Queries [query_start(k), Tq) see key k (k < Tk), the inverse of
  // key_end: nondecreasing in k.  Offdiag: the first query block j with
  // floor(j bq / bk) > floor(k / bk).
  __device__ __forceinline__ int query_start(int k) const {
    if (mode == kCausal) return k;
    if (mode == kOffdiag) return cdiv((k / bk + 1) * bk, bq) * bq;
    return 0;
  }
};

struct FwdParams {
  Strided q, k, v;
  void* o;
  float* lse;
  int H, Tq, Tk, D;
  float scale;
  Mask mask;
};

struct BwdParams {
  Strided q, k, v, dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk, D;
  float scale;
  Mask mask;
};

template <typename T>
__device__ __forceinline__ const T* head_base(const Strided& s, int b, int h) {
  return static_cast<const T*>(s.ptr) + b * s.sb + h * s.sh;
}

// The key tiles of TILE keys a query tile of rows [q0, q0 + rows) sweeps:
// up to the key limit of its last row (zero when no row sees a key).
template <int TILE>
__device__ __forceinline__ int key_tiles(const Mask& m, int q0, int rows, int Tq, int Tk) {
  return cdiv(m.key_end(min(q0 + rows, Tq) - 1, Tk), TILE);
}

// The first query tile of ROWS rows that a key tile starting at k0 (< Tk)
// meets, at most n_qt.
template <int ROWS>
__device__ __forceinline__ int first_query_tile(const Mask& m, int k0, int n_qt) {
  return min(m.query_start(k0) / ROWS, n_qt);
}

// ROWS x DP tile of rows [r0, r0 + ROWS) into shared memory (leading dim
// LD), zero-filled past row `limit` and past column D.  16-byte vectors:
// D, the row stride and the base are multiples of 16 bytes (checked by the
// Python wrapper).
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* base,
                                          long long row_stride, int r0,
                                          int limit, int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DP / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit && c < D)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// ===========================================================================
// bf16: mma.sync m16n8k16 on register-resident tiles.
//
// Fragment layouts (lane = 4g + t): A 16x16 row-major {a0: (g, 2t..2t+1),
// a1: (g+8, 2t..), a2: (g, 2t+8..), a3: (g+8, 2t+8..)}; B 16x8 {b0: (k 2t..
// 2t+1, n g), b1: (k 2t+8.., n g)}; C 16x8 {c0,c1: (g, 2t..2t+1), c2,c3:
// (g+8, 2t..2t+1)}.  A C fragment pair over 16 columns is therefore an A
// fragment over 16 k once packed to bf16, which is how P and dS feed the
// next product without leaving registers.
// ===========================================================================

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16x16 block at (r0, c0) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (r0 + (m & 1) * 8 + r) * ld + c0 + (m >> 1) * 8);
}

// B fragments of the n8 tiles n0 and n0 + 8 over k [k0, k0 + 16), from a
// tile stored [n][k] row-major (K for Q K^T): b[0..1] for n0, b[2..3] for
// n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (n0 + (m >> 1) * 8 + r) * ld + k0 + (m & 1) * 8);
}

// The same from a tile stored [k][n] row-major (V for P V), transposed by
// ldmatrix on the way.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b, tile + (k0 + (m & 1) * 8 + r) * ld + n0 + (m >> 1) * 8);
}

// C fragments c[0..1] (16 x 16 as two n8 tiles) packed as an A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The tile of load_tile, copied asynchronously (cp.async, 16 bytes a
// thread; zero-filled past row `limit` and column D).  Lands in shared
// memory at cp_async_wait.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long row_stride, int r0,
                                                int limit, int D) {
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = r0 + r < limit && c < D;
    const bf16* src = in ? base + (long long)(r0 + r) * row_stride + c : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst + r * LD + c)), "l"(src), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

constexpr int kRows = 64;  // rows per block: 4 warps x 16

// bf16 tiles of kRows x (DP + 8), plus two double-buffered rows of floats
template <int DP>
constexpr size_t mma_smem(int tiles) {
  return (size_t)tiles * kRows * (DP + 8) * sizeof(bf16) + 4 * kRows * sizeof(float);
}

// Store a warp's 16 x DP f32 accumulator (rows row[0], row[1] per lane) as
// bf16 pairs of a contiguous (B, T, H, D) tensor, times `mul`.
template <int ND>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride,
                                           const float (&acc)[ND][4],
                                           const int (&row)[2], const float (&mul)[2],
                                           int limit, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= limit) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(base + row[r] * row_stride + col) =
            __floats2bfloat162_rn(acc[nd][2 * r] * mul[r], acc[nd][2 * r + 1] * mul[r]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(FwdParams p) {
  constexpr int LD = DP + 8, KD = DP / 16, ND = DP / 8, NT = kRows / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK2 = sQ + kRows * LD;       // K and V: two buffers each
  bf16* sV2 = sK2 + 2 * kRows * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // heaviest causal tiles (last rows) first: they set the tail of the launch
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = head_base<bf16>(p.k, b, h);
  const bf16* vb = head_base<bf16>(p.v, b, h);
  const int n_kt = key_tiles<kRows>(p.mask, q0, kRows, p.Tq, p.Tk);
  auto prefetch = [&](int kt) {
    const int buf = (kt & 1) * kRows * LD;
    load_tile_async<kRows, DP, LD>(sK2 + buf, kb, p.k.st, kt * kRows, p.Tk, p.D);
    load_tile_async<kRows, DP, LD>(sV2 + buf, vb, p.v.st, kt * kRows, p.Tk, p.D);
    cp_async_commit();
  };
  if (n_kt > 0) prefetch(0);

  load_tile<bf16, kRows, DP, LD>(sQ, head_base<bf16>(p.q, b, h), p.q.st, q0, p.Tq, p.D);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) load_a(qa[kc], sQ, LD, warp * 16, kc * 16);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // each row's keys: [0, kend) (rows past Tq are computed, never stored)
  const int kend[2] = {p.mask.key_end(row[0], p.Tk), p.mask.key_end(row[1], p.Tk)};
  float o[ND][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    const bf16* sK = sK2 + (kt & 1) * kRows * LD;
    const bf16* sV = sV2 + (kt & 1) * kRows * LD;
    __syncthreads();  // every warp is done with the buffer the prefetch fills
    if (kt + 1 < n_kt) {
      prefetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every warp

    float s[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        load_b_nk(bk, sK, LD, j * 8, kc * 16);
        mma_bf16(s[j], qa[kc], bk[0], bk[1]);
        mma_bf16(s[j + 1], qa[kc], bk[2], bk[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = kpos < kend[r] ? s[j][e] * p.scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + j * 8 + 2 * t + (e & 1);
        const float pr = kpos < kend[r] ? __expf(s[j][e] - m[r]) : 0.0f;
        s[j][e] = pr;
        rs[r] += pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bv[4];
        load_b_kn(bv, sV, LD, kc * 16, nd * 8);
        mma_bf16(o[nd], pa, bv[0], bv[1]);
        mma_bf16(o[nd + 1], pa, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = l[r] == 0.0f ? 1.0f : l[r];
    inv[r] = 1.0f / ls;
    if (t == 0 && row[r] < p.Tq) p.lse[(long long)bh * p.Tq + row[r]] = m[r] + logf(ls);
  }
  store_rows<ND>(static_cast<bf16*>(p.o) + ((long long)b * p.Tq * p.H + h) * p.D,
                 (long long)p.H * p.D, o, row, inv, p.Tq, p.D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_mma_kernel(BwdParams p) {
  constexpr int LD = DP + 8, KD = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + kRows * LD;
  bf16* sK2 = sDO + kRows * LD;      // K and V: two buffers each
  bf16* sV2 = sK2 + 2 * kRows * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = head_base<bf16>(p.k, b, h);
  const bf16* vb = head_base<bf16>(p.v, b, h);
  const int n_kt = key_tiles<kRows>(p.mask, q0, kRows, p.Tq, p.Tk);
  auto prefetch = [&](int kt) {
    const int buf = (kt & 1) * kRows * LD;
    load_tile_async<kRows, DP, LD>(sK2 + buf, kb, p.k.st, kt * kRows, p.Tk, p.D);
    load_tile_async<kRows, DP, LD>(sV2 + buf, vb, p.v.st, kt * kRows, p.Tk, p.D);
    cp_async_commit();
  };
  if (n_kt > 0) prefetch(0);

  load_tile<bf16, kRows, DP, LD>(sQ, head_base<bf16>(p.q, b, h), p.q.st, q0, p.Tq, p.D);
  load_tile<bf16, kRows, DP, LD>(sDO, head_base<bf16>(p.dout, b, h), p.dout.st, q0, p.Tq, p.D);
  __syncthreads();
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    load_a(qa[kc], sQ, LD, warp * 16, kc * 16);
    load_a(da[kc], sDO, LD, warp * 16, kc * 16);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
  int kend[2];  // each row's keys: [0, kend), none past Tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Tq;
    lse[r] = in ? p.lse[(long long)bh * p.Tq + row[r]] : 0.0f;
    delta[r] = in ? p.delta[(long long)bh * p.Tq + row[r]] : 0.0f;
    kend[r] = in ? p.mask.key_end(row[r], p.Tk) : 0;
  }
  float dq[ND][4] = {};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    const bf16* sK = sK2 + (kt & 1) * kRows * LD;
    const bf16* sV = sV2 + (kt & 1) * kRows * LD;
    __syncthreads();
    if (kt + 1 < n_kt) {
      prefetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kc2 = 0; kc2 < kRows / 16; ++kc2) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t bf[4];
        load_b_nk(bf, sK, LD, kc2 * 16, kc * 16);
        mma_bf16(s[0], qa[kc], bf[0], bf[1]);
        mma_bf16(s[1], qa[kc], bf[2], bf[3]);
        load_b_nk(bf, sV, LD, kc2 * 16, kc * 16);
        mma_bf16(dp[0], da[kc], bf[0], bf[1]);
        mma_bf16(dp[1], da[kc], bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kpos = k0 + kc2 * 16 + j * 8 + 2 * t + (e & 1);
          const float pr = kpos < kend[r] ? __expf(s[j][e] * p.scale - lse[r]) : 0.0f;
          s[j][e] = pr * (dp[j][e] - delta[r]);  // dS
        }
      uint32_t dsa[4];
      pack_a(dsa, s[0], s[1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bk[4];
        load_b_kn(bk, sK, LD, kc2 * 16, nd * 8);
        mma_bf16(dq[nd], dsa, bk[0], bk[1]);
        mma_bf16(dq[nd + 1], dsa, bk[2], bk[3]);
      }
    }
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows<ND>(static_cast<bf16*>(p.dq) + ((long long)b * p.Tq * p.H + h) * p.D,
                 (long long)p.H * p.D, dq, row, mul, p.Tq, p.D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_mma_kernel(BwdParams p) {
  constexpr int LD = DP + 8, KD = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ2 = sV + kRows * LD;       // Q, dO, lse, delta: two buffers each
  bf16* sDO2 = sQ2 + 2 * kRows * LD;
  float* sLse2 = reinterpret_cast<float*>(sDO2 + 2 * kRows * LD);
  float* sDelta2 = sLse2 + 2 * kRows;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kRows;  // low key tiles see the most queries: first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = head_base<bf16>(p.q, b, h);
  const bf16* db = head_base<bf16>(p.dout, b, h);

  load_tile<bf16, kRows, DP, LD>(sK, head_base<bf16>(p.k, b, h), p.k.st, k0, p.Tk, p.D);
  load_tile<bf16, kRows, DP, LD>(sV, head_base<bf16>(p.v, b, h), p.v.st, k0, p.Tk, p.D);
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  // each key's queries: [qs, Tq); none for keys past Tk
  const int qs[2] = {krow[0] < p.Tk ? p.mask.query_start(krow[0]) : 0x7fffffff,
                     krow[1] < p.Tk ? p.mask.query_start(krow[1]) : 0x7fffffff};
  float dk[ND][4] = {}, dv[ND][4] = {};
  const int n_qt = cdiv(p.Tq, kRows);
  // the first query tile that sees a key of this tile
  const int qt0 = first_query_tile<kRows>(p.mask, k0, n_qt);
  auto prefetch = [&](int qt) {
    const int q0 = qt * kRows, buf = qt & 1;
    load_tile_async<kRows, DP, LD>(sQ2 + buf * kRows * LD, qb, p.q.st, q0, p.Tq, p.D);
    load_tile_async<kRows, DP, LD>(sDO2 + buf * kRows * LD, db, p.dout.st, q0, p.Tq, p.D);
    cp_async_commit();
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool in = q0 + r < p.Tq;
      sLse2[buf * kRows + r] = in ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.0f;
      sDelta2[buf * kRows + r] = in ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.0f;
    }
  };
  if (qt0 < n_qt) prefetch(qt0);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kRows, buf = qt & 1;
    const bf16* sQ = sQ2 + buf * kRows * LD;
    const bf16* sDO = sDO2 + buf * kRows * LD;
    const float* sLse = sLse2 + buf * kRows;
    const float* sDelta = sDelta2 + buf * kRows;
    __syncthreads();
    if (qt + 1 < n_qt) {
      prefetch(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < kRows / 16; ++qc) {  // 16 queries at a time
      float st[2][4] = {}, dpt[2][4] = {};     // S^T, dP^T: keys x queries
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t a[4], bf[4];
        load_a(a, sK, LD, warp * 16, kc * 16);
        load_b_nk(bf, sQ, LD, qc * 16, kc * 16);
        mma_bf16(st[0], a, bf[0], bf[1]);
        mma_bf16(st[1], a, bf[2], bf[3]);
        load_a(a, sV, LD, warp * 16, kc * 16);
        load_b_nk(bf, sDO, LD, qc * 16, kc * 16);
        mma_bf16(dpt[0], a, bf[0], bf[1]);
        mma_bf16(dpt[1], a, bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qi = qc * 16 + j * 8 + 2 * t + (e & 1);
          const float pr = q0 + qi < p.Tq && q0 + qi >= qs[r]
                               ? __expf(st[j][e] * p.scale - sLse[qi]) : 0.0f;
          st[j][e] = pr;
          dpt[j][e] = pr * (dpt[j][e] - sDelta[qi]);  // dS^T
        }
      uint32_t pa[4], dsa[4];
      pack_a(pa, st[0], st[1]);
      pack_a(dsa, dpt[0], dpt[1]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bf[4];
        load_b_kn(bf, sDO, LD, qc * 16, nd * 8);
        mma_bf16(dv[nd], pa, bf[0], bf[1]);
        mma_bf16(dv[nd + 1], pa, bf[2], bf[3]);
        load_b_kn(bf, sQ, LD, qc * 16, nd * 8);
        mma_bf16(dk[nd], dsa, bf[0], bf[1]);
        mma_bf16(dk[nd + 1], dsa, bf[2], bf[3]);
      }
    }
  }
  const long long off = ((long long)b * p.Tk * p.H + h) * p.D;
  const float mul_k[2] = {p.scale, p.scale}, one[2] = {1.0f, 1.0f};
  store_rows<ND>(static_cast<bf16*>(p.dk) + off, (long long)p.H * p.D, dk, krow, mul_k,
                 p.Tk, p.D);
  store_rows<ND>(static_cast<bf16*>(p.dv) + off, (long long)p.H * p.D, dv, krow, one,
                 p.Tk, p.D);
}

// ===========================================================================
// float32: shared-memory tiles, plain FMA (keeps full f32 precision).
// ===========================================================================

constexpr int kF32Rows = 32;  // = warp size: the forward's row pass is lane per key
static_assert(kF32Rows == 32, "the f32 forward maps one lane to one key");

// C (M x N, row-major) = or += A (M x K, row-major) * op(B).  B_T: B is
// stored N x K row-major and the product is A B^T; otherwise B is K x N.
template <int M, int N, int K, bool B_T, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int r = idx / N, c = idx % N;
    float s = ACC ? C[r * ldc + c] : 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk)
      s = fmaf(A[r * lda + kk], B_T ? B[c * ldb + kk] : B[kk * ldb + c], s);
    C[r * ldc + c] = s;
  }
}

// leading dims of the f32 tiles: +4 floats keeps 16-byte rows and staggers
// the banks
template <int DP>
struct F32Smem {
  static constexpr int R = kF32Rows, LDQ = DP + 4, LDS = R + 4, LDO = DP + 4;
  // forward: Q, K, V, S, P, O, m, l
  static constexpr size_t fwd = sizeof(float) * (3 * R * LDQ + 2 * R * LDS + R * LDO + 2 * R);
  // dQ: Q, dO, K, V, S, dP, dS, acc, lse, delta
  static constexpr size_t dq = sizeof(float) * (4 * R * LDQ + 3 * R * LDS + R * LDO + 2 * R);
  // dK/dV: K, V, Q, dO, S^T, dP^T, P^T, dS^T, dK, dV, lse, delta
  static constexpr size_t dkv = sizeof(float) * (4 * R * LDQ + 4 * R * LDS + 2 * R * LDO + 2 * R);
};

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(FwdParams p) {
  using S = F32Smem<DP>;
  constexpr int R = S::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + R * S::LDQ;
  float* sV = sK + R * S::LDQ;
  float* sS = sV + R * S::LDQ;
  float* sP = sS + R * S::LDS;
  float* sO = sP + R * S::LDS;
  float* sM = sO + R * S::LDO;
  float* sL = sM + R;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const float* kb = head_base<float>(p.k, b, h);
  const float* vb = head_base<float>(p.v, b, h);
  load_tile<float, R, DP, S::LDQ>(sQ, head_base<float>(p.q, b, h), p.q.st, q0, p.Tq, p.D);
  for (int i = threadIdx.x; i < R * S::LDO; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }
  const int n_kt = key_tiles<R>(p.mask, q0, R, p.Tq, p.Tk);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<float, R, DP, S::LDQ>(sK, kb, p.k.st, k0, p.Tk, p.D);
    load_tile<float, R, DP, S::LDQ>(sV, vb, p.v.st, k0, p.Tk, p.D);
    __syncthreads();
    mm<R, R, DP, true, false>(sS, S::LDS, sQ, S::LDQ, sK, S::LDQ);
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {  // one warp per row, lane per key
      const int c = lane;
      const bool ok = k0 + c < p.mask.key_end(q0 + r, p.Tk);
      const float s = ok ? sS[r * S::LDS + c] * p.scale : kNegInf;
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r], m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float pr = ok ? expf(s - m_new) : 0.0f;
      float sum = pr;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[r * S::LDS + c] = pr;
      for (int d = lane; d < DP; d += 32) sO[r * S::LDO + d] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = alpha * sL[r] + sum;
      }
    }
    __syncthreads();
    mm<R, DP, R, false, true>(sO, S::LDO, sP, S::LDS, sV, S::LDQ);
  }
  __syncthreads();

  const long long row_stride = (long long)p.H * p.D;
  float* ob = static_cast<float*>(p.o) + ((long long)b * p.Tq * p.H + h) * p.D;
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (q0 + r < p.Tq && c < p.D) {
      const float l = sL[r];
      ob[(q0 + r) * row_stride + c] = sO[r * S::LDO + c] / (l == 0.0f ? 1.0f : l);
    }
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    if (q0 + r < p.Tq) {
      const float l = sL[r];
      p.lse[(long long)bh * p.Tq + q0 + r] = sM[r] + logf(l == 0.0f ? 1.0f : l);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(BwdParams p) {
  using S = F32Smem<DP>;
  constexpr int R = S::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + R * S::LDQ;
  float* sK = sDO + R * S::LDQ;
  float* sV = sK + R * S::LDQ;
  float* sS = sV + R * S::LDQ;
  float* sDP = sS + R * S::LDS;
  float* sDS = sDP + R * S::LDS;
  float* sAcc = sDS + R * S::LDS;
  float* sLse = sAcc + R * S::LDO;
  float* sDelta = sLse + R;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const float* kb = head_base<float>(p.k, b, h);
  const float* vb = head_base<float>(p.v, b, h);
  load_tile<float, R, DP, S::LDQ>(sQ, head_base<float>(p.q, b, h), p.q.st, q0, p.Tq, p.D);
  load_tile<float, R, DP, S::LDQ>(sDO, head_base<float>(p.dout, b, h), p.dout.st, q0, p.Tq,
                                  p.D);
  for (int i = threadIdx.x; i < R * S::LDO; i += kThreads) sAcc[i] = 0.0f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool in = q0 + r < p.Tq;
    sLse[r] = in ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.0f;
    sDelta[r] = in ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.0f;
  }
  const int n_kt = key_tiles<R>(p.mask, q0, R, p.Tq, p.Tk);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<float, R, DP, S::LDQ>(sK, kb, p.k.st, k0, p.Tk, p.D);
    load_tile<float, R, DP, S::LDQ>(sV, vb, p.v.st, k0, p.Tk, p.D);
    __syncthreads();
    mm<R, R, DP, true, false>(sS, S::LDS, sQ, S::LDQ, sK, S::LDQ);    // S
    mm<R, R, DP, true, false>(sDP, S::LDS, sDO, S::LDQ, sV, S::LDQ);  // dO V^T
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R;
      const float pr = q0 + r < p.Tq && k0 + c < p.mask.key_end(q0 + r, p.Tk)
                           ? expf(sS[r * S::LDS + c] * p.scale - sLse[r]) : 0.0f;
      sDS[r * S::LDS + c] = pr * (sDP[r * S::LDS + c] - sDelta[r]);
    }
    __syncthreads();
    mm<R, DP, R, false, true>(sAcc, S::LDO, sDS, S::LDS, sK, S::LDQ);  // += dS K
  }
  __syncthreads();

  const long long row_stride = (long long)p.H * p.D;
  float* out = static_cast<float*>(p.dq) + ((long long)b * p.Tq * p.H + h) * p.D;
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (q0 + r < p.Tq && c < p.D) out[(q0 + r) * row_stride + c] = p.scale * sAcc[r * S::LDO + c];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(BwdParams p) {
  using S = F32Smem<DP>;
  constexpr int R = S::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + R * S::LDQ;
  float* sQ = sV + R * S::LDQ;
  float* sDO = sQ + R * S::LDQ;
  float* sS = sDO + R * S::LDQ;  // transposed tiles: key rows x query columns
  float* sDP = sS + R * S::LDS;
  float* sP = sDP + R * S::LDS;
  float* sDS = sP + R * S::LDS;
  float* sDK = sDS + R * S::LDS;
  float* sDV = sDK + R * S::LDO;
  float* sLse = sDV + R * S::LDO;
  float* sDelta = sLse + R;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * R;
  const float* qb = head_base<float>(p.q, b, h);
  const float* db = head_base<float>(p.dout, b, h);
  load_tile<float, R, DP, S::LDQ>(sK, head_base<float>(p.k, b, h), p.k.st, k0, p.Tk, p.D);
  load_tile<float, R, DP, S::LDQ>(sV, head_base<float>(p.v, b, h), p.v.st, k0, p.Tk, p.D);
  for (int i = threadIdx.x; i < R * S::LDO; i += kThreads) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }
  const int n_qt = cdiv(p.Tq, R);
  const int qt0 = first_query_tile<R>(p.mask, k0, n_qt);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_tile<float, R, DP, S::LDQ>(sQ, qb, p.q.st, q0, p.Tq, p.D);
    load_tile<float, R, DP, S::LDQ>(sDO, db, p.dout.st, q0, p.Tq, p.D);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const bool in = q0 + r < p.Tq;
      sLse[r] = in ? p.lse[(long long)bh * p.Tq + q0 + r] : 0.0f;
      sDelta[r] = in ? p.delta[(long long)bh * p.Tq + q0 + r] : 0.0f;
    }
    __syncthreads();
    mm<R, R, DP, true, false>(sS, S::LDS, sK, S::LDQ, sQ, S::LDQ);    // S^T
    mm<R, R, DP, true, false>(sDP, S::LDS, sV, S::LDQ, sDO, S::LDQ);  // V dO^T
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int j = i / R, c = i % R;
      const float pr = q0 + c < p.Tq && k0 + j < p.Tk && q0 + c >= p.mask.query_start(k0 + j)
                           ? expf(sS[j * S::LDS + c] * p.scale - sLse[c]) : 0.0f;
      sP[j * S::LDS + c] = pr;
      sDS[j * S::LDS + c] = pr * (sDP[j * S::LDS + c] - sDelta[c]);
    }
    __syncthreads();
    mm<R, DP, R, false, true>(sDV, S::LDO, sP, S::LDS, sDO, S::LDQ);  // += P^T dO
    mm<R, DP, R, false, true>(sDK, S::LDO, sDS, S::LDS, sQ, S::LDQ);  // += dS^T Q
  }
  __syncthreads();

  const long long row_stride = (long long)p.H * p.D;
  const long long off = ((long long)b * p.Tk * p.H + h) * p.D;
  float* dk = static_cast<float*>(p.dk) + off;
  float* dv = static_cast<float*>(p.dv) + off;
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    if (k0 + r < p.Tk && c < p.D) {
      dk[(k0 + r) * row_stride + c] = p.scale * sDK[r * S::LDO + c];
      dv[(k0 + r) * row_stride + c] = sDV[r * S::LDO + c];
    }
  }
}

// ===========================================================================
// bf16, D = 64: wgmma design.  TMA rings, one producer warp, two consumer
// warpgroups, persistent over tiles, heaviest tiles first.
// ===========================================================================

constexpr int kWgThreads = 384;     // consumer warpgroups 0 and 1, producer 2
constexpr int kWgConsumers = 256;
// setmaxnreg moves registers between the warpgroups from the 168 a thread
// each has at launch (65536 / 384, rounded down to a multiple of 8): the
// consumers can only take what the producer gives up
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 384 * 168,
              "setmaxnreg.inc would wait forever for registers");
constexpr int BOX = 64 * 128;       // one TMA box: 64 rows of 64 bf16 (128 B)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();

// The tensor maps of a launch, all (D, H, T, B) over bf16 in boxes of 64 x
// 1 x 64 x 1, 128-byte swizzled: q, k, v with their own strides (the fused
// qkv views), dout and the outputs contiguous.  The T extent of each is its
// own length, so loads past it read zeros and stores past it are dropped.
struct FlashMaps {
  CUtensorMap q, k, v, dout, o, dq, dk, dv;
};

struct WgParams {
  float* lse;           // forward: written; backward: read
  const float* delta;   // backward
  int BH, H, Tq, Tk;
  float scale;
  Mask mask;
};

// Shared memory of a wgmma kernel, from a 1024-aligned base (the period of
// the 128-byte swizzle): two resident buffers of RES bytes (the tile's own
// rows, double-buffered so the next tile's load overlaps this tile's end),
// a ring of NS stages of STAGE bytes (the swept side), a staging area of STG
// bytes per consumer warpgroup (the TMA-stored outputs), SIDE bytes a stage
// of side data, then the barriers and a scratch row for stores of no use.
template <int RES, int STAGE, int NS, int STG, int SIDE, int NWG = 2>
struct WgLayout {
  static constexpr int kStages = NS;
  static constexpr int kConsumerWarps = 4 * NWG;
  static constexpr int stg = STG;
  static constexpr int ring = 2 * RES;
  static constexpr int staging = ring + NS * STAGE;
  static constexpr int side = staging + NWG * STG;
  static constexpr int bars = side + NS * SIDE;
  static constexpr int scratch = bars + (2 * NS + 4) * 8;
  static constexpr size_t bytes = 1024 + scratch + 128 * 4;
  static_assert(RES % 1024 == 0 && STAGE % 1024 == 0 && STG % 1024 == 0,
                "swizzled tiles need 1024-byte alignment");
  static_assert(bytes <= 232448, "more shared memory than a block can have");
};

// A block's view of its shared memory and its place in the ring and in the
// resident buffers.  full[s]: the stage's bytes (and side data) arrived;
// empty[s]: all 8 consumer warps are done with it; rfull/rempty the same for
// the two resident buffers.
template <typename L>
struct Pipe {
  unsigned char* gen;  // generic pointer to the aligned base
  uint32_t base;       // its shared address
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ uint32_t res(int rb) const { return base + rb * (L::ring / 2); }
  __device__ __forceinline__ uint32_t st(int s) const {
    return base + L::ring + s * ((L::staging - L::ring) / L::kStages);
  }
  __device__ __forceinline__ float* side(int s) const {
    return reinterpret_cast<float*>(gen + L::side + s * ((L::bars - L::side) / L::kStages));
  }
  __device__ __forceinline__ unsigned char* staging(int wg) const {
    return gen + L::staging + wg * L::stg;
  }
  __device__ __forceinline__ uint32_t full(int s) const { return base + L::bars + s * 8; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + L::bars + (L::kStages + s) * 8;
  }
  __device__ __forceinline__ uint32_t rfull(int rb) const {
    return base + L::bars + (2 * L::kStages + rb) * 8;
  }
  __device__ __forceinline__ uint32_t rempty(int rb) const {
    return base + L::bars + (2 * L::kStages + 2 + rb) * 8;
  }
  __device__ __forceinline__ float* scratch() const {
    return reinterpret_cast<float*>(gen + L::scratch);
  }
  __device__ __forceinline__ void advance() {
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Aligns the base and initialises the barriers (full[s] waits for `fill`
// arrivals plus the bytes; empty and rempty for the 8 consumer warps).
template <typename L>
__device__ __forceinline__ Pipe<L> make_pipe(unsigned char* smem, int fill) {
  Pipe<L> p;
  const uint32_t raw = smem_addr(smem);
  const uint32_t aligned = (raw + 1023) & ~1023u;
  p.gen = smem + (aligned - raw);
  p.base = aligned;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(p.full(s), fill);
      mbar_init(p.empty(s), L::kConsumerWarps);
    }
    for (int rb = 0; rb < 2; ++rb) {
      mbar_init(p.rfull(rb), 1);
      mbar_init(p.rempty(rb), L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return p;
}

// A consumer warp's release of a stage or resident buffer it has finished.
__device__ __forceinline__ void release_bar(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define WG_F8(i)                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Accumulator layout of m64nN (thread t of the warpgroup, warp w = t / 32,
// lane l): d[4j + {0,1}] at row 16w + l/4, columns 8j + 2(l%4) + {0,1};
// d[4j + {2,3}] at row 16w + l/4 + 8.  The register A operand of m64k16
// has the same rows, so the accumulator over 16 columns 16c.. packed to bf16
// pairs {d[8c], d[8c+1]}, {d[8c+2], d[8c+3]}, {d[8c+4], d[8c+5]}, {d[8c+6],
// d[8c+7]} is the A fragment over k 16c..16c+15: P and dS feed their next
// product without leaving registers.

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both K-major in shared memory;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) (+)= A (64 x 16) B (16 x 128), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40), WG_F8(48),
        WG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_F8

// K-major operand at `a` (rows of 64 d values), the k16 step kk.
__device__ __forceinline__ uint64_t kmaj(uint32_t a, int kk) {
  return wgmma_desc(a + kk * 32, 16, 1024);
}

// MN-major operand at `b` (k rows of 64 n values), the k16 step kc.
__device__ __forceinline__ uint64_t mnmaj(uint32_t b, int kc) {
  return wgmma_desc(b + kc * 2048, BOX, 1024);
}

// A 64 x 64 product over D = 64 into d: 4 k16 steps, A and B K-major.
__device__ __forceinline__ void product64(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss64(d, kmaj(a, kk), kmaj(b, kk), kk > 0);
}

// d += (A packed in registers, 64 x 16*KC) x B (16*KC x 64, MN-major at b).
template <int KC>
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[4 * KC],
                                           uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) wgmma_rs64(d, &a[4 * kc], mnmaj(b, kc));
}

// f32 accumulator over 16*KC columns → bf16 A fragments (see above).
template <int KC>
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4 * KC], const float (&d)[8 * KC]) {
#pragma unroll
  for (int i = 0; i < 4 * KC; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// A warpgroup's 64 x 64 accumulator times mul[row half] into a swizzled box
// of its staging (the layout TMA stores from): each lane's 4 bytes land in
// their own bank.
__device__ __forceinline__ void stage_box(unsigned char* box, const float (&d)[32],
                                          const float (&mul)[2]) {
  const int t = threadIdx.x & 127, r_lo = 16 * (t >> 5) + ((t & 31) >> 2);
  const int c_lo = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(box + r * 128 + ((j ^ (r & 7)) * 16) + c_lo * 2) =
          __floats2bfloat162_rn(d[4 * j + 2 * h] * mul[h], d[4 * j + 2 * h + 1] * mul[h]);
    }
}

// The warpgroup's staged boxes out by TMA: wait until the last tile's
// stores have read the staging, fill it (fill()), then one thread stores
// n_boxes boxes, box i through maps[i] at rows row0.. of (b, h).
template <typename Fill>
__device__ __forceinline__ void store_boxes(unsigned char* staging, int wg, Fill fill,
                                            const CUtensorMap* m0, const CUtensorMap* m1,
                                            int h, int row0, int b) {
  const int t = threadIdx.x & 127;
  if (t == 0) tma_store_wait_read();
  named_bar(2 + wg, 128);
  fill();
  fence_async_shared();
  named_bar(2 + wg, 128);
  if (t == 0) {
    tma_store_4d(m0, smem_addr(staging), 0, h, row0, b);
    if (m1 != nullptr) tma_store_4d(m1, smem_addr(staging) + BOX, 0, h, row0, b);
    tma_store_commit();
  }
}

// ---------------------------------------------------------------------------
// forward: a tile is 192 query rows of one (b, h), 64 per consumer; the ring
// carries 128-key tiles of K and V.
// ---------------------------------------------------------------------------

// Three consumer warpgroups of 64 query rows each (a 192-row tile) and the
// producer warpgroup: 512 threads, 128 registers each at launch, so the
// consumers get 160 and the producer 24.  Two consumer warpgroups (128 rows,
// 224 registers) took 2% longer (PERF.md).
constexpr int kFwdWgs = 3, kFwdRows = 64 * kFwdWgs, kFwdThreads = 128 * (kFwdWgs + 1);
constexpr int kFwdProducerRegs = 24, kFwdConsumerRegs = 160;
static_assert(128 * kFwdProducerRegs + 128 * kFwdWgs * kFwdConsumerRegs <= 65536,
              "setmaxnreg.inc would wait forever for registers");
using FwdLayout = WgLayout<kFwdWgs * BOX, 4 * BOX, 3, BOX, 0, kFwdWgs>;

struct FwdTile {
  int b, h, bh, q0, n_kt;
};

// Tile i of the forward, heaviest first: the last query tiles see the most
// keys under a causal mask.
__device__ __forceinline__ FwdTile fwd_tile(const WgParams& p, int i, int rows) {
  const int n_qt = cdiv(p.Tq, rows);
  FwdTile t;
  t.bh = i % p.BH;
  t.b = t.bh / p.H;
  t.h = t.bh % p.H;
  t.q0 = (n_qt - 1 - i / p.BH) * rows;
  t.n_kt = key_tiles<128>(p.mask, t.q0, rows, p.Tq, p.Tk);
  return t;
}

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ FlashMaps maps, WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  Pipe<FwdLayout> pipe = make_pipe<FwdLayout>(smem_raw, 1);
  const int n_tiles = cdiv(p.Tq, kFwdRows) * p.BH;

  // the role, from a warp-uniform value: a branch on threadIdx itself would
  // put the wgmma on a divergent path, which serializes them
  if (__shfl_sync(0xffffffff, threadIdx.x / 32, 0) >= 4 * kFwdWgs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kFwdProducerRegs));
    if (threadIdx.x != 128 * kFwdWgs) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const FwdTile t = fwd_tile(p, tile, kFwdRows);
      const int rb = it & 1;
      mbar_wait(pipe.rempty(rb), ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(pipe.rfull(rb), kFwdWgs * BOX);
      for (int w = 0; w < kFwdWgs; ++w)
        tma_load_4d(pipe.res(rb) + w * BOX, &maps.q, pipe.rfull(rb), 0, t.h, t.q0 + 64 * w,
                    t.b);
      for (int kt = 0; kt < t.n_kt; ++kt) {
        const int s = pipe.stage, k0 = kt * 128;
        mbar_wait(pipe.empty(s), pipe.phase ^ 1);
        mbar_expect_tx(pipe.full(s), 4 * BOX);
        tma_load_4d(pipe.st(s), &maps.k, pipe.full(s), 0, t.h, k0, t.b);
        tma_load_4d(pipe.st(s) + BOX, &maps.k, pipe.full(s), 0, t.h, k0 + 64, t.b);
        tma_load_4d(pipe.st(s) + 2 * BOX, &maps.v, pipe.full(s), 0, t.h, k0, t.b);
        tma_load_4d(pipe.st(s) + 3 * BOX, &maps.v, pipe.full(s), 0, t.h, k0 + 64, t.b);
        pipe.advance();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kFwdConsumerRegs));
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);  // uniform
  const int tid = threadIdx.x & 127;
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2), c_lo = 2 * (tid & 3);
  const float c = p.scale * kLog2e;  // exp(scale s) = 2^(c s)
  unsigned char* staging = pipe.staging(wg);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const FwdTile t = fwd_tile(p, tile, kFwdRows);
    const int rb = it & 1, row0 = t.q0 + 64 * wg;
    float o[32], s[64];
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m[2] = {-kInf, -kInf}, l[2] = {0.0f, 0.0f};
    // this warpgroup's key limits: its first row's (the least) and this
    // thread's two rows'
    const int kend_lo = p.mask.key_end(row0, p.Tk);
    const int kend[2] = {p.mask.key_end(row0 + r_lo, p.Tk),
                         p.mask.key_end(row0 + r_lo + 8, p.Tk)};
    mbar_wait(pipe.rfull(rb), (it >> 1) & 1);
    const uint32_t qa = pipe.res(rb) + wg * BOX;
    // S of the first key tile; every later S is issued behind the last PV.
    // An offdiag tile of the first query block sees no key: no tile at all.
    if (t.n_kt > 0) {
      mbar_wait(pipe.full(pipe.stage), pipe.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss128(s, kmaj(qa, kk), kmaj(pipe.st(pipe.stage), kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
    }
    for (int kt = 0; kt < t.n_kt; ++kt) {
      const int cur = pipe.stage, k0 = kt * 128;
      // the mask only on tiles that cross a row's key limit (the diagonal,
      // the end of the keys, an offdiag limit past the warpgroup's first
      // row): a branch on the tile, uniform; the element test a select
      if (k0 + 128 > kend_lo) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + c_lo + (i & 1);
          s[i] = kpos < kend[(i >> 1) & 1] ? s[i] : -kInf;
        }
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float alpha[2], mu[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        mu[r] = m_new == -kInf ? 0.0f : m_new * c;  // a row with no key yet
        alpha[r] = ex2(m[r] * c - mu[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], c, -mu[r]));
        rs[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // per thread; summed at the end
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_frag<8>(pa, s);
      wgmma_fence();
      product_rs<8>(o, pa, pipe.st(cur) + 2 * BOX);  // O += P V
      wgmma_commit();
      if (kt + 1 < t.n_kt) {  // the next S behind this PV, then wait for PV
        pipe.advance();
        mbar_wait(pipe.full(pipe.stage), pipe.phase);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss128(s, kmaj(qa, kk), kmaj(pipe.st(pipe.stage), kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(o);
        release_bar(pipe.empty(cur));
        wgmma_wait<0>();
        fence_acc(s);
      } else {
        wgmma_wait<0>();
        fence_acc(o);
        release_bar(pipe.empty(cur));
        pipe.advance();
      }
    }
    release_bar(pipe.rempty(rb));
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      inv[r] = 1.0f / (lr == 0.0f ? 1.0f : lr);
      const int row = row0 + r_lo + 8 * r;
      // rows past Tq, and three lanes of each quad, store to scratch: a
      // select, not a branch
      float* dst = c_lo == 0 && row < p.Tq ? p.lse + (long long)t.bh * p.Tq + row
                                            : pipe.scratch() + tid;
      *dst = lr == 0.0f ? kNegInf : m[r] * p.scale + logf(lr);
    }
    store_boxes(staging, wg, [&] { stage_box(staging, o, inv); }, &maps.o, nullptr, t.h,
                row0, t.b);
  }
  if (tid == 0) tma_store_wait();
}

// ---------------------------------------------------------------------------
// dQ: a tile is 128 query rows (Q and dO resident), 64 per consumer; the
// ring carries 64-key tiles of K and V.
// ---------------------------------------------------------------------------

using DqLayout = WgLayout<4 * BOX, 2 * BOX, 4, BOX, 0>;

__device__ __forceinline__ FwdTile dq_tile(const WgParams& p, int i) {
  FwdTile t = fwd_tile(p, i, 128);
  t.n_kt = key_tiles<64>(p.mask, t.q0, 128, p.Tq, p.Tk);
  return t;
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ FlashMaps maps, WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  Pipe<DqLayout> pipe = make_pipe<DqLayout>(smem_raw, 1);
  const int n_tiles = cdiv(p.Tq, 128) * p.BH;

  if (__shfl_sync(0xffffffff, threadIdx.x / 32, 0) >= kWgConsumers / 32) {  // see fwd
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x != kWgConsumers) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const FwdTile t = dq_tile(p, tile);
      const int rb = it & 1;
      const uint32_t r = pipe.res(rb);
      mbar_wait(pipe.rempty(rb), ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(pipe.rfull(rb), 4 * BOX);
      tma_load_4d(r, &maps.q, pipe.rfull(rb), 0, t.h, t.q0, t.b);
      tma_load_4d(r + BOX, &maps.q, pipe.rfull(rb), 0, t.h, t.q0 + 64, t.b);
      tma_load_4d(r + 2 * BOX, &maps.dout, pipe.rfull(rb), 0, t.h, t.q0, t.b);
      tma_load_4d(r + 3 * BOX, &maps.dout, pipe.rfull(rb), 0, t.h, t.q0 + 64, t.b);
      for (int kt = 0; kt < t.n_kt; ++kt) {
        const int s = pipe.stage;
        mbar_wait(pipe.empty(s), pipe.phase ^ 1);
        mbar_expect_tx(pipe.full(s), 2 * BOX);
        tma_load_4d(pipe.st(s), &maps.k, pipe.full(s), 0, t.h, kt * 64, t.b);
        tma_load_4d(pipe.st(s) + BOX, &maps.v, pipe.full(s), 0, t.h, kt * 64, t.b);
        pipe.advance();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);  // uniform
  const int tid = threadIdx.x & 127;
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2), c_lo = 2 * (tid & 3);
  const float c = p.scale * kLog2e;
  unsigned char* staging = pipe.staging(wg);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const FwdTile t = dq_tile(p, tile);
    const int rb = it & 1, row0 = t.q0 + 64 * wg;
    // this thread's two rows: lse (in log2 units) and delta; rows past Tq
    // read row Tq - 1 (their dQ is never stored)
    float lse2[2], dl[2];
    int kend[2];  // the key limits of the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = (long long)t.bh * p.Tq + min(row0 + r_lo + 8 * r, p.Tq - 1);
      lse2[r] = p.lse[at] * kLog2e;
      dl[r] = p.delta[at];
      kend[r] = p.mask.key_end(row0 + r_lo + 8 * r, p.Tk);
    }
    const int kend_lo = p.mask.key_end(row0, p.Tk);  // the warpgroup's least
    float dq[32], s[32], dp[32];
    uint32_t dsa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
    mbar_wait(pipe.rfull(rb), (it >> 1) & 1);
    const uint32_t qa = pipe.res(rb) + wg * BOX, da = qa + 2 * BOX;
    if (t.n_kt > 0) {  // none for an offdiag tile of the first query block
      mbar_wait(pipe.full(pipe.stage), pipe.phase);
      wgmma_fence();
      product64(s, qa, pipe.st(pipe.stage));        // S = Q K^T
      product64(dp, da, pipe.st(pipe.stage) + BOX);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
    }
    for (int kt = 0; kt < t.n_kt; ++kt) {
      const int cur = pipe.stage, k0 = kt * 64;
      if (k0 + 64 > kend_lo) {  // see the forward
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + c_lo + (i & 1);
          s[i] = kpos < kend[(i >> 1) & 1] ? s[i] : -kInf;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], c, -lse2[r])) * (dp[i] - dl[r]);  // dS = P (dP - delta)
      }
      pack_frag<4>(dsa, s);
      wgmma_fence();
      product_rs<4>(dq, dsa, pipe.st(cur));  // dQ += dS K
      wgmma_commit();
      if (kt + 1 < t.n_kt) {
        pipe.advance();
        mbar_wait(pipe.full(pipe.stage), pipe.phase);
        product64(s, qa, pipe.st(pipe.stage));
        product64(dp, da, pipe.st(pipe.stage) + BOX);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(dq);
        release_bar(pipe.empty(cur));
        wgmma_wait<0>();
        fence_acc(s);
        fence_acc(dp);
      } else {
        wgmma_wait<0>();
        fence_acc(dq);
        release_bar(pipe.empty(cur));
        pipe.advance();
      }
    }
    release_bar(pipe.rempty(rb));
    const float mul[2] = {p.scale, p.scale};
    store_boxes(staging, wg, [&] { stage_box(staging, dq, mul); }, &maps.dq, nullptr, t.h,
                row0, t.b);
  }
  if (tid == 0) tma_store_wait();
}

// ---------------------------------------------------------------------------
// dK/dV: a tile is 128 keys (K and V resident), 64 per consumer; the ring
// carries 64-query tiles of Q and dO, with their lse (log2 units) and delta
// as side data, copied by the producer warpgroup's second warp.
// ---------------------------------------------------------------------------

using DkvLayout = WgLayout<4 * BOX, 2 * BOX, 4, 2 * BOX, 128 * 4>;

struct DkvTile {
  int b, h, bh, k0, qt0, n_qt;
};

// Tile i of dK/dV, heaviest first: under a causal mask the first key tiles
// see the most queries.
__device__ __forceinline__ DkvTile dkv_tile(const WgParams& p, int i) {
  DkvTile t;
  t.bh = i % p.BH;
  t.b = t.bh / p.H;
  t.h = t.bh % p.H;
  t.k0 = (i / p.BH) * 128;
  t.n_qt = cdiv(p.Tq, 64);
  t.qt0 = first_query_tile<64>(p.mask, t.k0, t.n_qt);
  return t;
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ FlashMaps maps, WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  // full[s]: the producer's bytes and the 32 side-data lanes
  Pipe<DkvLayout> pipe = make_pipe<DkvLayout>(smem_raw, 1 + 32);
  const int n_tiles = cdiv(p.Tk, 128) * p.BH;

  if (__shfl_sync(0xffffffff, threadIdx.x / 32, 0) >= kWgConsumers / 32) {  // see fwd
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int pw = threadIdx.x / 32 - kWgConsumers / 32, lane = threadIdx.x & 31;
    if (pw == 0) {
      if (lane != 0) return;
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const DkvTile t = dkv_tile(p, tile);
        const int rb = it & 1;
        const uint32_t r = pipe.res(rb);
        mbar_wait(pipe.rempty(rb), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(pipe.rfull(rb), 4 * BOX);
        tma_load_4d(r, &maps.k, pipe.rfull(rb), 0, t.h, t.k0, t.b);
        tma_load_4d(r + BOX, &maps.k, pipe.rfull(rb), 0, t.h, t.k0 + 64, t.b);
        tma_load_4d(r + 2 * BOX, &maps.v, pipe.rfull(rb), 0, t.h, t.k0, t.b);
        tma_load_4d(r + 3 * BOX, &maps.v, pipe.rfull(rb), 0, t.h, t.k0 + 64, t.b);
        for (int qt = t.qt0; qt < t.n_qt; ++qt) {
          const int s = pipe.stage;
          mbar_wait(pipe.empty(s), pipe.phase ^ 1);
          mbar_expect_tx(pipe.full(s), 2 * BOX);
          tma_load_4d(pipe.st(s), &maps.q, pipe.full(s), 0, t.h, qt * 64, t.b);
          tma_load_4d(pipe.st(s) + BOX, &maps.dout, pipe.full(s), 0, t.h, qt * 64, t.b);
          pipe.advance();
        }
      }
    } else if (pw == 1) {
      // side data: each lane copies two queries' lse (times log2 e) and
      // delta into the stage (zeros past Tq), then arrives on its full[s]
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const DkvTile t = dkv_tile(p, tile);
        for (int qt = t.qt0; qt < t.n_qt; ++qt) {
          const int s = pipe.stage;
          mbar_wait(pipe.empty(s), pipe.phase ^ 1);
          float* side = pipe.side(s);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int q = qt * 64 + lane + 32 * k;
            const bool in = q < p.Tq;
            const long long at = (long long)t.bh * p.Tq + (in ? q : 0);
            side[lane + 32 * k] = in ? p.lse[at] * kLog2e : 0.0f;
            side[64 + lane + 32 * k] = in ? p.delta[at] : 0.0f;
          }
          mbar_arrive(pipe.full(s));
          pipe.advance();
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);  // uniform
  const int tid = threadIdx.x & 127;
  const int r_lo = 16 * (tid >> 5) + ((tid & 31) >> 2), c_lo = 2 * (tid & 3);
  const float c = p.scale * kLog2e;
  unsigned char* staging = pipe.staging(wg);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const DkvTile t = dkv_tile(p, tile);
    const int rb = it & 1, key0 = t.k0 + 64 * wg;
    float dk[32], dv[32], st[32], dpt[32];
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk[i] = 0.0f;
      dv[i] = 0.0f;
    }
    // the first query of this warpgroup's last key (the largest), and of
    // this thread's two keys; keys past Tk are computed, never stored
    const int qs_hi = p.mask.query_start(key0 + 63);
    const int qs[2] = {p.mask.query_start(key0 + r_lo), p.mask.query_start(key0 + r_lo + 8)};
    mbar_wait(pipe.rfull(rb), (it >> 1) & 1);
    const uint32_t ka = pipe.res(rb) + wg * BOX, va = ka + 2 * BOX;
    const int n = t.n_qt - t.qt0;
    if (n > 0) {
      mbar_wait(pipe.full(pipe.stage), pipe.phase);
      wgmma_fence();
      product64(st, ka, pipe.st(pipe.stage));         // S^T = K Q^T
      product64(dpt, va, pipe.st(pipe.stage) + BOX);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
    }
    for (int qi = 0; qi < n; ++qi) {
      const int cur = pipe.stage, q0 = (t.qt0 + qi) * 64;
      if (q0 < qs_hi || q0 + 64 > p.Tq) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int q = q0 + 8 * (i >> 2) + c_lo + (i & 1);
          st[i] = q < p.Tq && q >= qs[(i >> 1) & 1] ? st[i] : -kInf;
        }
      }
      const float* side = pipe.side(cur);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i >> 2) + c_lo + (i & 1);
        st[i] = ex2(fmaf(st[i], c, -side[qc]));           // P^T
        dpt[i] = st[i] * (dpt[i] - side[64 + qc]);        // dS^T
      }
      pack_frag<4>(pa, st);
      pack_frag<4>(dsa, dpt);
      wgmma_fence();
      product_rs<4>(dv, pa, pipe.st(cur) + BOX);  // dV += P^T dO
      product_rs<4>(dk, dsa, pipe.st(cur));       // dK += dS^T Q
      wgmma_commit();
      if (qi + 1 < n) {
        pipe.advance();
        mbar_wait(pipe.full(pipe.stage), pipe.phase);
        product64(st, ka, pipe.st(pipe.stage));
        product64(dpt, va, pipe.st(pipe.stage) + BOX);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(dk);
        fence_acc(dv);
        release_bar(pipe.empty(cur));
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
      } else {
        wgmma_wait<0>();
        fence_acc(dk);
        fence_acc(dv);
        release_bar(pipe.empty(cur));
        pipe.advance();
      }
    }
    release_bar(pipe.rempty(rb));
    const float mul_k[2] = {p.scale, p.scale}, one[2] = {1.0f, 1.0f};
    store_boxes(
        staging, wg,
        [&] {
          stage_box(staging, dk, mul_k);
          stage_box(staging + BOX, dv, one);
        },
        &maps.dk, &maps.dv, t.h, key0, t.b);
  }
  if (tid == 0) tma_store_wait();
}

// ===========================================================================
// host side
// ===========================================================================

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Params& params) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(params);
  return cudaGetLastError();
}

template <int DP>
cudaError_t fwd(const FwdParams& p, int B, bool is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_fwd_mma_kernel<DP>, dim3(B * p.H, cdiv(p.Tq, kRows)),
                  mma_smem<DP>(5), stream, p);
  return launch(flash_fwd_f32_kernel<DP>, dim3(B * p.H, cdiv(p.Tq, kF32Rows)),
                F32Smem<DP>::fwd, stream, p);
}

template <int DP>
cudaError_t bwd(const BwdParams& p, int B, bool is_bf16, cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
    err = launch(flash_dq_mma_kernel<DP>, dim3(B * p.H, cdiv(p.Tq, kRows)),
                 mma_smem<DP>(6), stream, p);
    if (err != cudaSuccess) return err;
    return launch(flash_dkv_mma_kernel<DP>, dim3(B * p.H, cdiv(p.Tk, kRows)),
                  mma_smem<DP>(6), stream, p);
  }
  err = launch(flash_dq_f32_kernel<DP>, dim3(B * p.H, cdiv(p.Tq, kF32Rows)),
               F32Smem<DP>::dq, stream, p);
  if (err != cudaSuccess) return err;
  return launch(flash_dkv_f32_kernel<DP>, dim3(B * p.H, cdiv(p.Tk, kF32Rows)),
                F32Smem<DP>::dkv, stream, p);
}

Strided strided(const void* ptr, long long sb, long long st, long long sh) {
  Strided s;
  s.ptr = ptr;
  s.sb = sb;
  s.st = st;
  s.sh = sh;
  return s;
}

// Which kernels a call takes; ops/flash_attention.py's flash_design()
// decides from the shapes and strides.
enum Design { kFma = 0, kMmaSync = 1, kWgmma = 2 };

bool valid_mask(int mode, int bq, int bk) {
  return mode == kFull || mode == kCausal || (mode == kOffdiag && bq >= 1 && bk >= 1);
}

// The (D, H, T, B) map of a (B, T, H, 64) bf16 tensor with element strides
// sb, st, sh (unit stride in D), in boxes of 64 rows of one head.
int head_map(CUtensorMap* map, const void* base, int B, int T, int H, long long sb,
             long long st, long long sh) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return make_map(map, base, 4, dims, strides, box);
}

// The map of a contiguous (B, T, H, 64) bf16 tensor.
int dense_map(CUtensorMap* map, const void* base, int B, int T, int H) {
  return head_map(map, base, B, T, H, (long long)T * H * 64, (long long)H * 64, 64);
}

// A persistent launch: one block per SM, or fewer if there are fewer tiles.
// The SM count and the kernel's shared-memory opt-in are set up once per
// device and kernel (one instantiation, and one cache, per kernel).
template <void (*kernel)(FlashMaps, WgParams)>
int launch_wgmma(int n_tiles, size_t smem, cudaStream_t stream, const FlashMaps& maps,
                 const WgParams& p, int threads) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  kernel<<<min(n_tiles, sms[dev]), threads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 = no mask, 1 = causal, 2 = offdiag with block sizes bq, bk (>= 1;
// read only in mode 2); dtype: 0 = float32, 1 = bfloat16; design: 0 = FMA
// (float32), 1 = mma.sync, 2 = wgmma (bf16, D = 64, 16-byte strides and
// bases).  Returns a cudaError_t, or kErrNoEncoder / kErrEncode for a tensor
// map.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int H, int Tq, int Tk, int D,
              long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale, int mode, int bq, int bk, int dtype, int design,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_mask(mode, bq, bk)) return cudaErrorInvalidValue;
  const Mask mask{mode, bq, bk};
  if (design == kWgmma) {
    if (dtype != 1 || D != 64 || Tq < 1 || Tk < 1) return cudaErrorInvalidValue;
    FlashMaps maps{};
    int err = head_map(&maps.q, q, B, Tq, H, q_sb, q_st, q_sh);
    if (err == 0) err = head_map(&maps.k, k, B, Tk, H, k_sb, k_st, k_sh);
    if (err == 0) err = head_map(&maps.v, v, B, Tk, H, v_sb, v_st, v_sh);
    if (err == 0) err = dense_map(&maps.o, o, B, Tq, H);
    if (err != 0) return err;
    const WgParams wp{lse, nullptr, B * H, H, Tq, Tk, scale, mask};
    return launch_wgmma<flash_fwd_wgmma_kernel>(cdiv(Tq, kFwdRows) * B * H, FwdLayout::bytes,
                                                s, maps, wp, kFwdThreads);
  }
  if ((design == kFma) != (dtype == 0)) return cudaErrorInvalidValue;
  FwdParams p;
  p.q = strided(q, q_sb, q_st, q_sh);
  p.k = strided(k, k_sb, k_st, k_sh);
  p.v = strided(v, v_sb, v_st, v_sh);
  p.o = o;
  p.lse = lse;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.scale = scale;
  p.mask = mask;
  return D <= 64 ? fwd<64>(p, B, dtype == 1, s) : fwd<128>(p, B, dtype == 1, s);
}

// dout, dq, dk, dv contiguous (B, T, H, D); lse, delta contiguous (B, H, Tq).
// Two kernels, dQ then dK/dV, in every design.
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta,
              void* dq, void* dk, void* dv,
              int B, int H, int Tq, int Tk, int D,
              long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale, int mode, int bq, int bk, int dtype, int design,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_mask(mode, bq, bk)) return cudaErrorInvalidValue;
  const Mask mask{mode, bq, bk};
  if (design == kWgmma) {
    if (dtype != 1 || D != 64 || Tq < 1 || Tk < 1) return cudaErrorInvalidValue;
    FlashMaps maps{};
    int err = head_map(&maps.q, q, B, Tq, H, q_sb, q_st, q_sh);
    if (err == 0) err = head_map(&maps.k, k, B, Tk, H, k_sb, k_st, k_sh);
    if (err == 0) err = head_map(&maps.v, v, B, Tk, H, v_sb, v_st, v_sh);
    if (err == 0) err = dense_map(&maps.dout, dout, B, Tq, H);
    if (err == 0) err = dense_map(&maps.dq, dq, B, Tq, H);
    if (err == 0) err = dense_map(&maps.dk, dk, B, Tk, H);
    if (err == 0) err = dense_map(&maps.dv, dv, B, Tk, H);
    if (err != 0) return err;
    const WgParams wp{const_cast<float*>(lse), delta, B * H, H, Tq, Tk, scale, mask};
    err = launch_wgmma<flash_dq_wgmma_kernel>(cdiv(Tq, 128) * B * H, DqLayout::bytes, s, maps,
                                              wp, kWgThreads);
    if (err != 0) return err;
    return launch_wgmma<flash_dkv_wgmma_kernel>(cdiv(Tk, 128) * B * H, DkvLayout::bytes, s,
                                                maps, wp, kWgThreads);
  }
  if ((design == kFma) != (dtype == 0)) return cudaErrorInvalidValue;
  BwdParams p;
  p.q = strided(q, q_sb, q_st, q_sh);
  p.k = strided(k, k_sb, k_st, k_sh);
  p.v = strided(v, v_sb, v_st, v_sh);
  p.dout = strided(dout, (long long)Tq * H * D, (long long)H * D, D);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.scale = scale;
  p.mask = mask;
  return D <= 64 ? bwd<64>(p, B, dtype == 1, s) : bwd<128>(p, B, dtype == 1, s);
}

const char* flash_attention_error_string(int err) { return map_error_string(err); }

}  // extern "C"
