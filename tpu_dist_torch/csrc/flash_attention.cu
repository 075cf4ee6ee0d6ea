// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of tpu_dist/ops/flash_attention.py:
//   *fwd*  <- _make_fwd_kernel / _fwd_call  (online-softmax forward)
//   *dq*   <- _make_dq_kernel  / _bwd_call  (dQ over the k sweep)
//   *dkv*  <- _make_dkv_kernel / _bwd_call  (dK, dV over the q sweep)
//
// What bounds it on an H100: at the training shapes (T = 2048, D = 64,
// causal) the work is the QK^T / PV products, ~51.5 GFLOP forward and
// ~129 GFLOP backward per layer against ~100 MB of q/k/v/o, so the bound is
// tensor-core throughput, not memory.
//
// What the design does about it: no (T, T) tensor ever reaches device memory.
// Each block stages one tile of its own rows and sweeps the other side's
// tiles through shared memory.  For bf16 each of the block's four warps owns
// 16 rows and keeps its scores, probabilities, running max/sum and the f32
// O / dQ / dK / dV accumulators in registers; products run on the tensor
// cores as mma.sync m16n8k16 with f32 accumulation, operands loaded from
// shared memory with ldmatrix (the FlashAttention-2 layout).  float32 inputs
// take a plain shared-memory FMA path that keeps full f32 precision.  Causal
// tiles entirely above the diagonal are never visited.  The TPU kernels
// carry their accumulators across a sequential grid axis; blocks on a GPU run
// in no order, so the sweep is a loop inside the block, and dQ and dK/dV are
// separate kernels so that no block adds into another's output: no atomics,
// and the result is deterministic.  Ragged T and head dims (D % 8 == 0,
// D <= 128) are masked in the kernel: out-of-range rows and columns are
// zero-filled in shared memory instead of padding the tensors.
//
// The swept tiles are double-buffered: tile i + 1 is copied with cp.async
// while tile i is computed.  Not yet done (later work): wgmma and TMA, a
// warp-specialized producer/consumer pipeline.
//
// Layout: q, k, v are (B, T, H, D) with unit stride in D and any other
// strides (so the split of a fused qkv projection needs no copy); o, dO, dQ,
// dK, dV are contiguous (B, T, H, D); lse and delta are contiguous (B, H, Tq)
// float32.  Rows with no visible key get lse = -1e30 and o = 0, as in the
// TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr float kNegInf = -1e30f;  // finite: a fully masked row stays NaN-free
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Strided {  // a (B, T, H, D) operand with unit stride in D
  const void* ptr;
  long long sb, st, sh;
};

struct FwdParams {
  Strided q, k, v;
  void* o;
  float* lse;
  int H, Tq, Tk, D;
  float scale;
  int causal;
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
  int causal;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__device__ __forceinline__ const T* head_base(const Strided& s, int b, int h) {
  return static_cast<const T*>(s.ptr) + b * s.sb + h * s.sh;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Tq, int Tk,
                                        int causal) {
  return qpos < Tq && kpos < Tk && (!causal || kpos <= qpos);
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
  int n_kt = cdiv(p.Tk, kRows);
  if (p.causal) n_kt = min(n_kt, cdiv(min(q0 + kRows, p.Tq), kRows));
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
        s[j][e] = visible(row[r], kpos, 0x7fffffff, p.Tk, p.causal)
                      ? s[j][e] * p.scale : kNegInf;
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
        const float pr = visible(row[r], kpos, 0x7fffffff, p.Tk, p.causal)
                             ? __expf(s[j][e] - m[r]) : 0.0f;
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
  int n_kt = cdiv(p.Tk, kRows);
  if (p.causal) n_kt = min(n_kt, cdiv(min(q0 + kRows, p.Tq), kRows));
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < p.Tq;
    lse[r] = in ? p.lse[(long long)bh * p.Tq + row[r]] : 0.0f;
    delta[r] = in ? p.delta[(long long)bh * p.Tq + row[r]] : 0.0f;
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
          const float pr = visible(row[r], kpos, p.Tq, p.Tk, p.causal)
                               ? __expf(s[j][e] * p.scale - lse[r]) : 0.0f;
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
  float dk[ND][4] = {}, dv[ND][4] = {};
  const int n_qt = cdiv(p.Tq, kRows);
  // causal: the first query tile whose last row reaches this key tile
  const int qt0 = p.causal ? k0 / kRows : 0;
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
          const float pr = visible(q0 + qi, krow[r], p.Tq, p.Tk, p.causal)
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
  int n_kt = cdiv(p.Tk, R);
  if (p.causal) n_kt = min(n_kt, cdiv(min(q0 + R, p.Tq), R));

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
      const bool ok = visible(q0 + r, k0 + c, 0x7fffffff, p.Tk, p.causal);
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
  int n_kt = cdiv(p.Tk, R);
  if (p.causal) n_kt = min(n_kt, cdiv(min(q0 + R, p.Tq), R));

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
      const float pr = visible(q0 + r, k0 + c, p.Tq, p.Tk, p.causal)
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
  const int qt0 = p.causal ? k0 / R : 0;

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
      const float pr = visible(q0 + c, k0 + j, p.Tq, p.Tk, p.causal)
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int H, int Tq, int Tk, int D,
              long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale, int causal, int dtype, void* stream) {
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
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? fwd<64>(p, B, dtype == 1, s) : fwd<128>(p, B, dtype == 1, s);
}

// dout, dq, dk, dv contiguous (B, T, H, D); lse, delta contiguous (B, H, Tq).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta,
              void* dq, void* dk, void* dv,
              int B, int H, int Tq, int Tk, int D,
              long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale, int causal, int dtype, void* stream) {
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
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? bwd<64>(p, B, dtype == 1, s) : bwd<128>(p, B, dtype == 1, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
