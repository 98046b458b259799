// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of ray_tpu/ops/flash_attention.py that
// _flash_bwd_impl launches:
//   flash_bwd_dq  <- _dq_kernel  (grid (b*h, nq, nk)):
//     dq = sum_k scale * P o (dP - delta) . K, P = exp(S*scale - lse),
//     dP = dO . V^T, with dS rounded to k's dtype before the product;
//   flash_bwd_dkv <- _dkv_kernel (grid (b*h_kv, nk, rep*nq)):
//     dV = sum_q P^T . dO (P rounded to dO's dtype),
//     dK = sum_q scale * dS^T . Q (dS rounded to q's dtype),
//     with GQA's sum over the rep query heads of one kv head in the
//     accumulator.
// Masked scores give P = 0 exactly as exp(NEG_INF - lse) does there. delta
// (sum_d dO o O, minus an upstream dlse) is computed outside, as in JAX.
//
// Work split, both designs. The TPU grid walks its innermost axis in order
// and carries the fp32 accumulator in VMEM scratch between grid steps. CUDA
// blocks run in no order, so each block owns one 64-row output tile and
// loops over the other axis:
//   dq:  one block per (b*h row, q tile), looping over the k tiles up to the
//        causal last tile (JAX's last_k);
//   dkv: one block per (b, kv head, k tile), looping over the rep q heads
//        kvh*rep .. kvh*rep+rep-1 (JAX's q_map in [b,s,h,d] terms) times the
//        q tiles at or below the diagonal (JAX's first q block).
// One owner per output tile means no atomics: results are deterministic, bit
// for bit from run to run. Inputs are read in the model's [b, s, h, d]
// layout, so no transpose precedes the launch. Rows past s are zero-filled,
// P and dS are forced to 0 for q rows or k columns past s, and lse / delta
// are never read past s, so any s works.
//
// bfloat16: tensor cores (flash_bwd_dq_mma, flash_bwd_dkv_mma). 128 threads,
// four warps, each owning 16 rows of the 64-row output tile. Every product is
// mma.sync m16n8k16 (bf16 in, fp32 accumulators in registers), fed by
// ldmatrix from bf16 tiles in shared memory (mma_bf16.cuh), 32 score columns
// at a time:
//   dq:  S = Q.K^T and dP = dO.V^T for 32 keys (K, V as n-major B operands),
//        then P and dS in fp32 from those accumulators; dS, rounded to bf16
//        where the Pallas kernel casts (:126), is already the A operand of
//        dS.K, whose B operand is K through ldmatrix.trans.
//   dkv: S^T = K.Q^T and dP^T = V.dO^T for the warp's 16 keys and 32
//        queries, so P^T and dS^T (rounded at :161, :164) are in registers as
//        the A operands of P^T.dO and dS^T.Q; dO and Q are their B operands
//        through ldmatrix.trans.
// Nothing is staged through shared memory between the products. Each score
// is summed over the head dim as two chains of mma and the chains added in
// fp32 (scores_16x32, mma_bf16.cuh): one chain of 8 drifts far enough from an
// fp32 sum to put P and dS across a bf16 rounding boundary from the plain
// version's.
// Tiles stay bf16 in shared memory, rows padded by 16 bytes so that the 8
// rows one ldmatrix phase reads fall in 8 distinct bank groups. They load by
// 16-byte cp.async, double-buffered: dq prefetches the next K/V tile, dkv the
// next Q/dO tile with its lse and delta, while the current one is computed;
// rows past s are zero-filled by the copy's source size. Shared memory at
// d=128: dq 102 KB (Q, dO, 2 x K, 2 x V), dkv 103 KB (K, V, 2 x (Q, dO, lse,
// delta)): two blocks per SM. dq takes its q tile in reverse order, so the
// heaviest causal rows start first; dkv's k tile 0 is its heaviest already.
// ptxas (CUDA 12.8, sm_90a, d=128): dq 242 registers, dkv 254, no spills;
// the 128 fp32 accumulators of dK and dV hold dkv at the 255 ceiling. So at
// d=256 (GPT-J) two blocks share each output tile, each owning 128 of its
// columns (grid z, out_cols) and computing S and dP over the full head dim:
// the products S and dP run twice, the output products once; 198 KB of
// tiles, one block per SM.
//
// float32: the FMA kernels (flash_bwd_dq_fma, flash_bwd_dkv_fma). TF32
// tensor cores would miss the fp32 gates (1e-5 of each leaf's gradient norm,
// 1e-4 per entry), so fp32 keeps fp32 FMAs from fp32 tiles in shared memory:
// thread t owning rows 4*(t/16)..+3 of its tile, score columns (t%16) +
// 16*j and output columns (t%16) + 16*c; rows padded by one float. 64-row
// tiles and 256 threads up to d=128 (149 KB for dq and 166 KB for dk/dv at
// d=128); 32-row tiles and 128 threads at d=256 (133 KB and 137 KB), since
// 64-row ones would not fit; one block per SM.
//
// Bound at the training shape (b=2, s=2048, h=h_kv=32, d=128, bf16, causal),
// with pairs = s(s+1)/2: dq does 3 products, 3*2*b*h*pairs*d = 103 GFLOP =
// 0.104 ms at 989 TFLOP/s, against 168 MB = 0.050 ms at 3.35 TB/s; dkv does
// 4 products, 137 GFLOP = 0.139 ms. Both are bound by operations. On an H100
// at 700 W the bf16 kernels take 0.56 and 0.82 ms there (PERF.md):
// about 185 and 168 TFLOP/s. mma.sync with two 4-warp blocks per SM issues
// too few products to near the peak; wgmma with TMA is the way further.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
static_assert(BQ == BK, "the causal tile bounds assume square tiles");

// ---------------------------------------------------------------------------
// float32: FMA kernels.

constexpr int ROWS = 4;  // rows of the owned tile per thread

// The FMA kernels' square tile: 64 rows up to d=128; 32 at d=256, where four
// fp32 tiles of 64 x 257 would take 263 KB of the 227 KB a block may use.
// 16 threads share a row group, so the block has 16 * tile / ROWS threads,
// and each thread takes tile / 16 score columns.
template <int D>
__host__ __device__ constexpr int fma_tile() {
  return D > 128 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int fma_threads() {
  return 16 * fma_tile<D>() / ROWS;
}

// rows [r0, r0 + tile) of one head of a [B, S, heads, D] tensor into a
// padded tile; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long stride, int r0,
                                          int S) {
  constexpr int LD = D + 1, T = fma_tile<D>();
  for (int e = threadIdx.x; e < T * D; e += fma_threads<D>()) {
    const int r = e / D, c = e % D;
    const int pos = r0 + r;
    dst[r * LD + c] = pos < S ? src[long(pos) * stride + c] : 0.f;
  }
}

// lse and delta of rows [r0, r0 + tile) of one [B, H, S] row; 0 past S.
template <int D>
__device__ __forceinline__ void load_row_stats(float* sL, float* sD, const float* lse,
                                               const float* delta, int r0, int S) {
  for (int r = threadIdx.x; r < fma_tile<D>(); r += fma_threads<D>()) {
    const int pos = r0 + r;
    sL[r] = pos < S ? lse[pos] : 0.f;
    sD[r] = pos < S ? delta[pos] : 0.f;
  }
}

template <int D>
constexpr size_t dq_fma_smem_bytes() {
  constexpr size_t T = fma_tile<D>();
  return sizeof(float) * (4 * T * (D + 1) + T * (T + 1) + 2 * T);
}

template <int D>
constexpr size_t dkv_fma_smem_bytes() {
  constexpr size_t T = fma_tile<D>();
  return sizeof(float) * (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T);
}

// Grid (b*h, q tiles).
template <int D>
__global__ void __launch_bounds__(fma_threads<D>())
flash_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int H, int HKV, float scale, int causal) {
  constexpr int T = fma_tile<D>();
  constexpr int JC = T / 16;  // score columns per thread
  constexpr int LD = D + 1;
  constexpr int LP = T + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + T * LD;
  float* sK = sDO + T * LD;
  float* sV = sK + T * LD;
  float* sDS = sV + T * LD;
  float* sL = sDS + T * LP;
  float* sDl = sL + T;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = blockIdx.y * T;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long q_off = long(b) * S * q_stride + long(head) * D;
  const float* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const float* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  load_tile<D>(sQ, q + q_off, q_stride, q0, S);
  load_tile<D>(sDO, dout + q_off, q_stride, q0, S);
  load_row_stats<D>(sL, sDl, lse + long(bh) * S, delta + long(bh) * S, q0, S);

  float acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  const int nk = (S + T - 1) / T;
  const int last_k = causal ? min(nk - 1, (q0 + T - 1) / T) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * T;
    __syncthreads();  // the previous tile's sK/sDS reads are done
    load_tile<D>(sK, kb, kv_stride, k0, S);
    load_tile<D>(sV, vb, kv_stride, k0, S);
    __syncthreads();

    float s[ROWS][JC], dp[ROWS][JC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < JC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[ROWS], ov[ROWS], kv[JC], vv[JC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = sQ[(ROWS * rg + i) * LD + dd];
        ov[i] = sDO[(ROWS * rg + i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        kv[j] = sK[(cl + 16 * j) * LD + dd];
        vv[j] = sV[(cl + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ROWS * rg + i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const int kp = k0 + cl + 16 * j;
        const bool live = qp < S && kp < S && (!causal || qp >= kp);
        const float p = live ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sDS[r * LP + cl + 16 * j] = p * (dp[i][j] - sDl[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = sDS[(ROWS * rg + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kval = sK[kk * LD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
      }
    }
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + ROWS * rg + i;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) dqb[long(qp) * q_stride + cl + 16 * c] = acc[i][c];
  }
}

// Grid (b*h_kv, k tiles).
template <int D>
__global__ void __launch_bounds__(fma_threads<D>())
flash_bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int H, int HKV,
                  float scale, int causal) {
  constexpr int T = fma_tile<D>();
  constexpr int JC = T / 16;  // score columns per thread
  constexpr int LD = D + 1;
  constexpr int LP = T + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + T * LD;
  float* sQ = sV + T * LD;
  float* sDO = sQ + T * LD;
  float* sP = sDO + T * LD;
  float* sDS = sP + T * LP;
  float* sL = sDS + T * LP;
  float* sDl = sL + T;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int b = blockIdx.x / HKV;
  const int kvh = blockIdx.x % HKV;
  const int rep = H / HKV;
  const int k0 = blockIdx.y * T;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long kv_off = long(b) * S * kv_stride + long(kvh) * D;

  load_tile<D>(sK, k + kv_off, kv_stride, k0, S);
  load_tile<D>(sV, v + kv_off, kv_stride, k0, S);

  float dk_acc[ROWS][OC], dv_acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (S + T - 1) / T;
  // The first q tile whose last row reaches k0 (flash_attention.py:149).
  const int first_q = causal ? k0 / T : 0;
  for (int r = 0; r < rep; ++r) {
    const int head = kvh * rep + r;
    const long q_off = long(b) * S * q_stride + long(head) * D;
    const long row_off = (long(b) * H + head) * S;
    for (int qt = first_q; qt < nq; ++qt) {
      const int q0 = qt * T;
      __syncthreads();  // the previous tile's sQ/sDO/sP/sDS reads are done
      load_tile<D>(sQ, q + q_off, q_stride, q0, S);
      load_tile<D>(sDO, dout + q_off, q_stride, q0, S);
      load_row_stats<D>(sL, sDl, lse + row_off, delta + row_off, q0, S);
      __syncthreads();

      // Transposed scores: s[i][j] = S[q0 + cl + 16j][k0 + 4rg + i].
      float s[ROWS][JC], dp[ROWS][JC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < JC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float kv[ROWS], vv[ROWS], qv[JC], ov[JC];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          kv[i] = sK[(ROWS * rg + i) * LD + dd];
          vv[i] = sV[(ROWS * rg + i) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          qv[j] = sQ[(cl + 16 * j) * LD + dd];
          ov[j] = sDO[(cl + 16 * j) * LD + dd];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int kr = ROWS * rg + i;
        const int kp = k0 + kr;
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const int qr = cl + 16 * j;
          const int qp = q0 + qr;
          const bool live = qp < S && kp < S && (!causal || qp >= kp);
          const float p = live ? expf(s[i][j] * scale - sL[qr]) : 0.f;
          sP[kr * LP + qr] = p;
          sDS[kr * LP + qr] = p * (dp[i][j] - sDl[qr]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < T; ++qq) {
        float pv[ROWS], dsv[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          pv[i] = sP[(ROWS * rg + i) * LP + qq];
          dsv[i] = sDS[(ROWS * rg + i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const float ov = sDO[qq * LD + cl + 16 * c];
          const float qv = sQ[qq * LD + cl + 16 * c];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            dv_acc[i][c] = fmaf(pv[i], ov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

  float* dkb = dk + kv_off;
  float* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kp = k0 + ROWS * rg + i;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dkb[long(kp) * kv_stride + cl + 16 * c] = dk_acc[i][c];
      dvb[long(kp) * kv_stride + cl + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels.

using namespace mma_bf16;

constexpr int TC_WARPS = 4;
constexpr int TC_NT = 32 * TC_WARPS;
static_assert(BQ == 16 * TC_WARPS, "each warp owns 16 rows of the output tile");
constexpr int PASS = 32;  // score columns per pass (scores_16x32)

template <int D>
constexpr size_t tc_tile_bytes() {
  return size_t(BQ) * tc_ld<D>() * sizeof(bf16);
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return 6 * tc_tile_bytes<D>();
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  return 6 * tc_tile_bytes<D>() + 4 * size_t(BQ) * sizeof(float);
}

// Output columns per block. At d=256 the dk and dv accumulators of a warp's
// 16 rows would take 256 registers a thread (dq's 128 on top of the scores),
// past the 255 a thread may have: there grid z = 2 blocks share each output
// tile, each owning 128 of its columns and computing S and dP over the full
// head dim. Up to d=128 one block owns every column, as before.
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}

// Two blocks per SM up to d=128; at d=256 the six tiles take 198 KB.
template <int D>
__host__ __device__ constexpr int tc_min_blocks() {
  return D > 128 ? 1 : 2;
}

// Grid (b*h, nq, D / out_cols); block y takes q tile nq-1-y, so the heaviest
// causal tiles are scheduled first; block z owns output columns
// [z * out_cols, (z + 1) * out_cols).
template <int D>
__global__ void __launch_bounds__(TC_NT, tc_min_blocks<D>())
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int H, int HKV, float scale, int causal) {
  constexpr int LD = tc_ld<D>();
  constexpr int TILE = BQ * LD;
  constexpr int DO = out_cols<D>();
  constexpr int NO = DO / 8;  // 8-column tiles of the dq accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + TILE;
  bf16* sK = sDO + TILE;     // two buffers
  bf16* sV = sK + 2 * TILE;  // two buffers

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int col0 = DO == D ? 0 : blockIdx.z * DO;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long q_off = long(b) * S * q_stride + long(head) * D;
  const bf16* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const bf16* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  const int nk = (S + BK - 1) / BK;
  const int last_k = causal ? min(nk - 1, (q0 + BQ - 1) / BK) : nk - 1;

  cp_async_tile<BQ, D, LD, TC_NT>(sQ, q + q_off, q_stride, q0, S);
  cp_async_tile<BQ, D, LD, TC_NT>(sDO, dout + q_off, q_stride, q0, S);
  cp_async_tile<BK, D, LD, TC_NT>(sK, kb, kv_stride, 0, S);
  cp_async_tile<BK, D, LD, TC_NT>(sV, vb, kv_stride, 0, S);
  cp_async_commit();

  // This thread's two rows of the warp's 16: g and g + 8.
  const int row = warp * 16 + g;
  const int qp[2] = {q0 + row, q0 + row + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_lse[i] = qp[i] < S ? lse[long(bh) * S + qp[i]] : 0.f;
    row_delta[i] = qp[i] < S ? delta[long(bh) * S + qp[i]] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16* a_q = sQ + (warp * 16 + frag_row_a(lane)) * LD + frag_col_a(lane);
  const bf16* a_do = sDO + (warp * 16 + frag_row_a(lane)) * LD + frag_col_a(lane);
  const int off_bn = frag_row_bn(lane) * LD + frag_col_bn(lane);
  const int off_bt = frag_row_a(lane) * LD + frag_col_a(lane);

  for (int kt = 0; kt <= last_k; ++kt) {
    const int buf = kt & 1;
    if (kt < last_k) {  // prefetch the next K/V tile into the other buffer
      cp_async_tile<BK, D, LD, TC_NT>(sK + (buf ^ 1) * TILE, kb, kv_stride, (kt + 1) * BK, S);
      cp_async_tile<BK, D, LD, TC_NT>(sV + (buf ^ 1) * TILE, vb, kv_stride, (kt + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * TILE;
    const bf16* cV = sV + buf * TILE;
    const int k0 = kt * BK;

#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += PASS) {
      // S = Q.K^T and dP = dO.V^T: the warp's 16 rows x 32 keys.
      float s[4][4], dp[4][4];
      scores_16x32<D, LD>(s, a_q, cK + c0 * LD + off_bn);
      scores_16x32<D, LD>(dp, a_do, cV + c0 * LD + off_bn);

      // dS = P o (dP - delta) * scale in fp32, into s.
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kp = k0 + c0 + n * 8 + 2 * t + (e & 1);
          const bool live = qp[i] < S && kp < S && (!causal || qp[i] >= kp);
          const float p = live ? expf(s[n][e] * scale - row_lse[i]) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[i]) * scale;
        }

      // dq += dS . K, dS rounded to k's dtype (flash_attention.py:126) as the
      // A operand; K is the k-major B operand, read with ldmatrix.trans.
#pragma unroll
      for (int j = 0; j < PASS / 16; ++j) {
        uint32_t ads[4];
        c_to_a(ads, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int np = 0; np < DO / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, cK + (c0 + j * 16) * LD + col0 + np * 16 + off_bt);
          mma_16816(acc[2 * np], ads, bk[0], bk[1]);
          mma_16816(acc[2 * np + 1], ads, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + long(qp[i]) * q_stride + col0 + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// Grid (b*h_kv, nk, D / out_cols): block y owns k tile y, block z output
// columns [z * out_cols, (z + 1) * out_cols) of it.
template <int D>
__global__ void __launch_bounds__(TC_NT, tc_min_blocks<D>())
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int HKV,
                  float scale, int causal) {
  constexpr int LD = tc_ld<D>();
  constexpr int TILE = BQ * LD;
  constexpr int DO = out_cols<D>();
  constexpr int NO = DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;        // two buffers
  bf16* sDO = sQ + 2 * TILE;   // two buffers
  float* sL = reinterpret_cast<float*>(sDO + 2 * TILE);  // two buffers of BQ
  float* sDl = sL + 2 * BQ;                               // two buffers of BQ

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / HKV, kvh = blockIdx.x % HKV;
  const int rep = H / HKV;
  const int k0 = blockIdx.y * BK;
  const int col0 = DO == D ? 0 : blockIdx.z * DO;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long kv_off = long(b) * S * kv_stride + long(kvh) * D;

  const int nq = (S + BQ - 1) / BQ;
  // The first q tile whose last row reaches k0 (flash_attention.py:149).
  const int first_q = causal ? k0 / BQ : 0;
  const int per_head = nq - first_q;
  const int n_tiles = rep * per_head;  // (rep head, q tile) pairs, in order

  // Tile i: Q, dO, lse and delta of q tile first_q + i % per_head of query
  // head kvh*rep + i / per_head, into buffer i % 2.
  auto load_q_tile = [&](int i) {
    const int head = kvh * rep + i / per_head;
    const int q0 = (first_q + i % per_head) * BQ;
    const long q_off = long(b) * S * q_stride + long(head) * D;
    const long row_off = (long(b) * H + head) * S;
    const int buf = i & 1;
    cp_async_tile<BQ, D, LD, TC_NT>(sQ + buf * TILE, q + q_off, q_stride, q0, S);
    cp_async_tile<BQ, D, LD, TC_NT>(sDO + buf * TILE, dout + q_off, q_stride, q0, S);
    cp_async_rows<BQ, TC_NT>(sL + buf * BQ, lse + row_off, q0, S);
    cp_async_rows<BQ, TC_NT>(sDl + buf * BQ, delta + row_off, q0, S);
  };

  cp_async_tile<BK, D, LD, TC_NT>(sK, k + kv_off, kv_stride, k0, S);
  cp_async_tile<BK, D, LD, TC_NT>(sV, v + kv_off, kv_stride, k0, S);
  load_q_tile(0);
  cp_async_commit();

  // This thread's two keys of the warp's 16: g and g + 8.
  const int kp[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const bf16* a_k = sK + (warp * 16 + frag_row_a(lane)) * LD + frag_col_a(lane);
  const bf16* a_v = sV + (warp * 16 + frag_row_a(lane)) * LD + frag_col_a(lane);
  const int off_bn = frag_row_bn(lane) * LD + frag_col_bn(lane);
  const int off_bt = frag_row_a(lane) * LD + frag_col_a(lane);

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {  // prefetch the next Q/dO tile into the other buffer
      load_q_tile(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first_q + i % per_head) * BQ;
    const bf16* cQ = sQ + buf * TILE;
    const bf16* cDO = sDO + buf * TILE;
    const float* cL = sL + buf * BQ;
    const float* cDl = sDl + buf * BQ;

#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += PASS) {
      // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 keys x 32 queries.
      float st[4][4], dpt[4][4];
      scores_16x32<D, LD>(st, a_k, cQ + c0 * LD + off_bn);
      scores_16x32<D, LD>(dpt, a_v, cDO + c0 * LD + off_bn);

      // P^T into st and dS^T into dpt, in fp32.
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int qpos = q0 + col;
          const int kpos = kp[e >> 1];
          const bool live = qpos < S && kpos < S && (!causal || qpos >= kpos);
          const float p = live ? expf(st[n][e] * scale - cL[col]) : 0.f;
          dpt[n][e] = p * (dpt[n][e] - cDl[col]) * scale;
          st[n][e] = p;
        }

      // dV += P^T.dO with P rounded to dO's dtype (flash_attention.py:161);
      // dK += dS^T.Q with dS rounded to q's dtype (:164). dO and Q are the
      // k-major B operands, read with ldmatrix.trans.
#pragma unroll
      for (int j = 0; j < PASS / 16; ++j) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, st[2 * j], st[2 * j + 1]);
        c_to_a(ads, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int np = 0; np < DO / 16; ++np) {
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, cDO + (c0 + j * 16) * LD + col0 + np * 16 + off_bt);
          mma_16816(dv_acc[2 * np], ap, bo[0], bo[1]);
          mma_16816(dv_acc[2 * np + 1], ap, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, cQ + (c0 + j * 16) * LD + col0 + np * 16 + off_bt);
          mma_16816(dk_acc[2 * np], ads, bq[0], bq[1]);
          mma_16816(dk_acc[2 * np + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long o = long(kp[i]) * kv_stride + col0 + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + o) =
          __floats2bfloat162_rn(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + o) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int B, S, H, HKV;
  float scale;
  int causal;
  cudaStream_t stream;
};

// float32 -> FMA kernels, grid (b*heads, tiles).
template <int D, bool DKV>
cudaError_t launch_fma(const Args& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  constexpr int T = fma_tile<D>();
  const int tiles = (a.S + T - 1) / T;
  if constexpr (DKV) {
    constexpr size_t smem = dkv_fma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_fma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_fma<D><<<dim3(a.B * a.HKV, tiles), fma_threads<D>(), smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
        a.S, a.H, a.HKV, a.scale, a.causal);
  } else {
    constexpr size_t smem = dq_fma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_fma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_fma<D><<<dim3(a.B * a.H, tiles), fma_threads<D>(), smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.out0), a.S, a.H, a.HKV, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

// bfloat16 -> tensor-core kernels, grid (b*heads, tiles, column blocks).
template <int D, bool DKV>
cudaError_t launch_mma(const Args& a) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int tiles = (a.S + BQ - 1) / BQ;
  constexpr int splits = D / out_cols<D>();
  if constexpr (DKV) {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_mma<D><<<dim3(a.B * a.HKV, tiles, splits), TC_NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.S,
        a.H, a.HKV, a.scale, a.causal);
  } else {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_mma<D><<<dim3(a.B * a.H, tiles, splits), TC_NT, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<bf16*>(a.out0), a.S, a.H, a.HKV, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t dispatch(const Args& a, int D, int dtype) {
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_fma<16, DKV>(a);
      case 32: return launch_fma<32, DKV>(a);
      case 64: return launch_fma<64, DKV>(a);
      case 128: return launch_fma<128, DKV>(a);
      case 256: return launch_fma<256, DKV>(a);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<16, DKV>(a);
      case 32: return launch_mma<32, DKV>(a);
      case 64: return launch_mma<64, DKV>(a);
      case 128: return launch_mma<128, DKV>(a);
      case 256: return launch_mma<256, DKV>(a);
    }
  }
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run(const Args& a, int D, int dtype) {
  // Grid limits: b*heads on x, the tile count (of the smallest tile, 32
  // rows) on y, which must fit 65535.
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.HKV < 1 || a.H % a.HKV != 0 ||
      long(a.B) * a.H > 0x7fffffffL || (a.S + 31) / 32 > 65535)
    return int(cudaErrorInvalidValue);
  return int(dispatch<DKV>(a, D, dtype));
}

}  // namespace

// q, dout, dq: [B, S, H, D]; k, v: [B, S, HKV, D] (all contiguous, one dtype;
// bf16 pointers 16-byte aligned); lse, delta: [B, H, S] fp32; D in 16, 32,
// 64, 128, 256. dtype:
// 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels).
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int S, int H,
                            int HKV, int D, int dtype, float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, HKV, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, D, dtype);
}

// As flash_bwd_dq; dk, dv: [B, S, HKV, D] in the dtype of k and v.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                             int H, int HKV, int D, int dtype, float scale, int causal,
                             void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, HKV, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, D, dtype);
}
