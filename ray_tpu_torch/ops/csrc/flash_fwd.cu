// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd_impl on grid (b*h, nq, nk)). It computes the same
// function: exact attention with an online softmax over 64-key blocks, causal
// or not, NEG_INF = -1e30 for masked scores, o in the input dtype and lse =
// m + log(max(l, 1e-30)) in fp32. Per block, with m the running max, P =
// exp(S*scale - m) is summed into l in fp32 unrounded and rounded to the input
// dtype only for P.V (:91-92); o = acc / max(l, 1e-30) at the end (:100).
// reference_flash_fwd in ops/flash_attention.py is the same function in plain
// PyTorch. GQA maps query head `head` to kv head `head / (H / HKV)`; K/V are
// never repeated in memory.
//
// Work split, both designs. The TPU grid walks its k axis in order and
// carries (max, normalizer, accumulator) in VMEM scratch from one grid step to
// the next. CUDA blocks run in no order, so that axis becomes a loop inside
// one block: one block per (b*h row, q tile) streams the 64-key K and V tiles
// of the mapped kv head up to the causal last tile and keeps the running max,
// normalizer and fp32 accumulator in registers. Inputs are read in the
// model's [b, s, h, d] layout, so no transpose precedes the launch. Rows past
// s are zero-filled and their scores masked, so any s works.
//
// bfloat16: tensor cores (flash_fwd_mma). FWD_BQ / 16 warps (4 at the 64-row
// q tile), each owning 16 query rows. Per 64-key tile a warp computes its
// 16 x 64 scores as two scores_16x32 (mma.sync m16n8k16, bf16 in, fp32
// accumulators, two chains over the head dim: mma_bf16.cuh), scales them,
// masks them only where the tile reaches the warp's diagonal or s, reduces
// row max and row sum over the 4 lanes of a quad, and rescales its 16 x D
// accumulator by alpha = exp(m_old - m_new) once per tile. The max is taken
// per 64 keys, on reference_flash_fwd's block boundaries, so P rounds where
// the plain version and the Pallas kernel round it. P's C fragments, rounded
// to bf16, are the A operands of P.V straight from registers; V is its k-major
// B operand through ldmatrix.trans. Tiles stay bf16 in shared memory, rows
// padded by 16 bytes (tc_ld), loaded by 16-byte cp.async with zero fill past
// s: Q once, K and V double-buffered so that the next tile loads while this
// one is computed. Shared memory at d=128: Q + 2 x K + 2 x V = 85 KB, two
// blocks per SM. At d=256 (GPT-J) the same design runs one block per SM:
// the tiles take 165 KB and the 16 x 256 accumulator 128 registers a thread,
// and each score sums four chains of 64 (scores_16x32). Block y takes q tile
// nq-1-y, so the heaviest causal tiles start first. ptxas (CUDA 12.8,
// sm_90a): 240 registers at d=128, 177 at 64, 127 at 32 and 16, no spills;
// 255 and 416 bytes spilled at d=256. A 128-row q tile (8 warps) ran slower at the
// train shape and no faster at the serve shape, with registers for one block
// per SM or spilling for two; holding Q's A fragments in registers instead of
// reloading them per tile did not move the time (PERF.md).
//
// float32: the FMA kernel of the first port (flash_fwd_fma), unchanged. TF32
// tensor cores would miss the fp32 gates (the paged phase's and
// train-parity's 1e-4 and 1e-5). 256 threads: thread t owns query rows
// 4*(t/16)..+3 of a 64-row tile, score columns (t%16) + 16*j and output
// columns (t%16) + 16*c; fp32 FMAs from fp32 tiles in shared memory, rows
// padded by one float: 116 KB at d=128 and 209 KB at d=256, one block per
// SM.
//
// Bound, with pairs = s(s+1)/2 causal: operations 2*2*b*h*pairs*d against
// 989 TFLOP/s, bytes q+k+v+o (bf16) + lse (fp32) against 3.35 TB/s. At the
// serve shape (b=1, s=1024, h=32, d=128) 8.6 GFLOP = 8.7 us against 33.7 MB
// = 10.1 us: bytes bound. At the train shape (b=2, s=2048) 68.7 GFLOP = 69.5
// us against 134.7 MB = 40.2 us: operations bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BK = 64;  // key tile of both kernels: the softmax max is taken per BK keys
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: FMA kernel.

constexpr int BQ = 64;
constexpr int NT = 256;
constexpr int ROWS = 4;  // query rows per thread

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + 2 * size_t(BK) * (D + 1) + size_t(BQ) * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int S,
              int H, int HKV, float scale, int causal) {
  constexpr int LD = D + 1;   // padded row of q/k/v tiles
  constexpr int LP = BK + 1;  // padded row of the probability tile
  constexpr int OC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = blockIdx.y * BQ;
  const long q_stride = long(H) * D;    // between positions of one head
  const long kv_stride = long(HKV) * D;
  const float* qb = q + long(b) * S * q_stride + long(head) * D;
  const float* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const float* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int pos = q0 + r;
    sQ[r * LD + c] = pos < S ? qb[long(pos) * q_stride + c] : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  const int last_k = causal ? min(nk - 1, (q0 + BQ - 1) / BK) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      const int pos = k0 + r;
      const bool in = pos < S;
      sK[r * LD + c] = in ? kb[long(pos) * kv_stride + c] : 0.f;
      sV[r * LD + c] = in ? vb[long(pos) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[ROWS], kv[4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(ROWS * rg + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cl + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + ROWS * rg + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cl + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= S || (causal && qp < kp)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ROWS * rg + i) * LP + cl + 16 * j] = p;  // fp32 inputs: P.V takes P unrounded
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(ROWS * rg + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = sV[kk * LD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = o + long(b) * S * q_stride + long(head) * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + ROWS * rg + i;
    if (qp >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) ob[long(qp) * q_stride + cl + 16 * c] = acc[i][c] / ll;
    if (cl == 0) lse[long(bh) * S + qp] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel.

using namespace mma_bf16;

// Rows of the q tile, 16 per warp, and the blocks per SM that ptxas must
// leave registers for: two up to d=128; one at d=256, where the 16 x 256 fp32
// accumulator alone takes 128 registers a thread and the tiles 165 KB.
constexpr int FWD_BQ = 64;
constexpr int FWD_NT = 32 * (FWD_BQ / 16);
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() {
  return D > 128 ? 1 : 2;
}
static_assert(FWD_BQ % BK == 0, "the causal last tile assumes q tiles of whole key tiles");

template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t(FWD_BQ) + 4 * size_t(BK)) * tc_ld<D>() * sizeof(bf16);
}

// Grid (b*h, nq); block y takes q tile nq-1-y.
template <int D>
__global__ void __launch_bounds__(FWD_NT, fwd_min_blocks<D>())
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, float* __restrict__ lse, int S, int H, int HKV, float scale,
              int causal) {
  constexpr int LD = tc_ld<D>();
  constexpr int KT = BK * LD;  // one K or V tile
  constexpr int NO = D / 8;    // 8-column tiles of the o accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + FWD_BQ * LD;  // two buffers
  bf16* sV = sK + 2 * KT;       // two buffers

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BQ;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long q_off = long(b) * S * q_stride + long(head) * D;
  const bf16* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const bf16* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  const int nk = (S + BK - 1) / BK;
  const int last_k = causal ? min(nk - 1, (q0 + FWD_BQ - 1) / BK) : nk - 1;

  cp_async_tile<FWD_BQ, D, LD, FWD_NT>(sQ, q + q_off, q_stride, q0, S);
  cp_async_tile<BK, D, LD, FWD_NT>(sK, kb, kv_stride, 0, S);
  cp_async_tile<BK, D, LD, FWD_NT>(sV, vb, kv_stride, 0, S);
  cp_async_commit();

  // This thread's two rows of the warp's 16: g and g + 8.
  const int w0 = q0 + warp * 16;
  const int qp[2] = {w0 + g, w0 + g + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16* a_q = sQ + (warp * 16 + frag_row_a(lane)) * LD + frag_col_a(lane);
  const int off_bn = frag_row_bn(lane) * LD + frag_col_bn(lane);
  const int off_bt = frag_row_a(lane) * LD + frag_col_a(lane);

  for (int kt = 0; kt <= last_k; ++kt) {
    const int buf = kt & 1;
    if (kt < last_k) {  // prefetch the next K/V tile into the other buffer
      cp_async_tile<BK, D, LD, FWD_NT>(sK + (buf ^ 1) * KT, kb, kv_stride, (kt + 1) * BK, S);
      cp_async_tile<BK, D, LD, FWD_NT>(sV + (buf ^ 1) * KT, vb, kv_stride, (kt + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * KT;
    const bf16* cV = sV + buf * KT;
    const int k0 = kt * BK;

    // S = Q.K^T, the warp's 16 rows x the tile's 64 keys: s[h][n][e] is row
    // qp[e / 2], key k0 + 32h + 8n + 2t + e % 2.
    float s[2][4][4];
    scores_16x32<D, LD>(s[0], a_q, cK + off_bn);
    scores_16x32<D, LD>(s[1], a_q, cK + 32 * LD + off_bn);

    // Scaled, then masked where the tile reaches past s or the warp's diagonal.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > w0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[h][n][e] * scale;
          if (edge) {
            const int kp = k0 + 32 * h + 8 * n + 2 * t + (e & 1);
            if (kp >= S || (causal && qp[e >> 1] < kp)) x = NEG_INF;
          }
          s[h][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }

    // The online softmax, once per 64 keys (flash_attention.py:87-91); the
    // four lanes of a quad share a row.
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[h][n][e] - m[e >> 1]);
          rs[e >> 1] += p;
          s[h][n][e] = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // o += P.V with P rounded to v's dtype (flash_attention.py:92) as the A
    // operand, straight from the score registers; V is the k-major B
    // operand, read with ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t ap[4];
      c_to_a(ap, s[j >> 1][2 * (j & 1)], s[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + j * 16 * LD + np * 16 + off_bt);
        mma_16816(acc[2 * np], ap, bv[0], bv[1]);
        mma_16816(acc[2 * np + 1], ap, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // o = acc / max(l, 1e-30) as bf16 pairs; lse by one lane of the quad.
  bf16* ob = o + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + long(qp[i]) * q_stride + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] / ll, acc[n][2 * i + 1] / ll);
    if (t == 0) lse[long(bh) * S + qp[i]] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// Launch.

// Grid (b*h, q tiles) for both kernels: b*h on x (up to 2^31 - 1), the q tile
// count on y (up to 65535).
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                   int H, int HKV, int dtype, float scale, int causal, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_fma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_fma<D><<<dim3(B * H, (S + BQ - 1) / BQ), NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), S, H, HKV, scale, causal);
  } else {
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_mma<D><<<dim3(B * H, (S + FWD_BQ - 1) / FWD_BQ), FWD_NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), S, H, HKV, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q: [B, S, H, D], k/v: [B, S, HKV, D], o: [B, S, H, D] (all contiguous, one
// dtype; bf16 pointers 16-byte aligned), lse: [B, H, S] fp32; D in 16, 32,
// 64, 128, 256. dtype:
// 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int S, int H, int HKV, int D, int dtype, float scale, int causal,
                         void* stream) {
  // Grid limits: b*h on x, the q tile count on y, which must fit 65535.
  if (B < 1 || S < 1 || H < 1 || HKV < 1 || H % HKV != 0 || long(B) * H > 0x7fffffffL ||
      (S + BQ - 1) / BQ > 65535 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch<16>(q, k, v, o, lse, B, S, H, HKV, dtype, scale, causal, st));
    case 32: return int(launch<32>(q, k, v, o, lse, B, S, H, HKV, dtype, scale, causal, st));
    case 64: return int(launch<64>(q, k, v, o, lse, B, S, H, HKV, dtype, scale, causal, st));
    case 128: return int(launch<128>(q, k, v, o, lse, B, S, H, HKV, dtype, scale, causal, st));
    case 256: return int(launch<256>(q, k, v, o, lse, B, S, H, HKV, dtype, scale, causal, st));
    default: return int(cudaErrorInvalidValue);
  }
}
