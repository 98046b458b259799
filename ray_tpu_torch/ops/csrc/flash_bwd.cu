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
// Design. The TPU grid walks its innermost axis in order and carries the
// fp32 accumulator in VMEM scratch between grid steps. CUDA blocks run in no
// order, so each block owns one output tile and loops over the other axis:
//   dq:  one block per (b*h row, 64-row q tile), looping over the k tiles up
//        to the causal last tile (JAX's last_k);
//   dkv: one block per (b, kv head, 64-row k tile), looping over the rep q
//        heads kvh*rep .. kvh*rep+rep-1 (JAX's q_map in [b,s,h,d] terms)
//        times the q tiles at or below the diagonal (the first is the one
//        whose last row reaches the tile's first key).
// One owner per output tile means no atomics: results are deterministic,
// bit for bit from run to run. Inputs are read in the model's [b, s, h, d]
// layout, so no transpose precedes the launch. Rows past s are zero-filled,
// P and dS are forced to 0 for q rows or k columns past s, and lse / delta
// are never read past s, so any s works.
//
// 256 threads; thread t owns rows 4*(t/16)..+3 of its tile, score columns
// (t%16) + 16*j and output columns (t%16) + 16*c. Tiles are held in fp32 in
// dynamic shared memory (rows padded by one float against bank conflicts):
// at d=128 that is 149 KB for dq and 166 KB for dkv, one block per SM.
// Products are fp32 FMAs from shared memory; no tensor cores yet.
//
// Bound at the training shape (b=2, s=2048, h=h_kv=32, d=128, bf16, causal),
// with pairs = s(s+1)/2: dq does 3 products, 3*2*b*h*pairs*d = 103 GFLOP =
// 0.104 ms at 989 TFLOP/s, against 168 MB = 0.050 ms at 3.35 TB/s; dkv does
// 4 products, 137 GFLOP = 0.139 ms. Both are bound by operations, which this
// FMA kernel runs far from; wgmma on the tensor cores is the way there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int ROWS = 4;  // rows of the owned tile per thread
static_assert(BQ == BK && BQ == ROWS * (NT / 16), "q and k tiles share one row mapping");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: where the Pallas kernels cast before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rows [r0, r0 + n) of one head of a [B, S, heads, D] tensor into a padded
// fp32 tile; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long stride, int r0, int S) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int pos = r0 + r;
    dst[r * LD + c] = pos < S ? to_f32(src[long(pos) * stride + c]) : 0.f;
  }
}

// lse and delta of rows [r0, r0 + 64) of one [B, H, S] row; 0 past S.
__device__ __forceinline__ void load_row_stats(float* sL, float* sD, const float* lse,
                                               const float* delta, int r0, int S) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int pos = r0 + r;
    sL[r] = pos < S ? lse[pos] : 0.f;
    sD[r] = pos < S ? delta[pos] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(BQ) * (D + 1) + size_t(BQ) * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * size_t(BQ) * (D + 1) + 2 * size_t(BK) * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int HKV,
                    float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;
  float* sL = sDS + BQ * LP;
  float* sDl = sL + BQ;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long q_off = long(b) * S * q_stride + long(head) * D;
  const T* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const T* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  load_tile<T, D>(sQ, q + q_off, q_stride, q0, S);
  load_tile<T, D>(sDO, dout + q_off, q_stride, q0, S);
  load_row_stats(sL, sDl, lse + long(bh) * S, delta + long(bh) * S, q0, S);

  float acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  const int nk = (S + BK - 1) / BK;
  const int last_k = causal ? min(nk - 1, (q0 + BQ - 1) / BK) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sDS reads are done
    load_tile<T, D>(sK, kb, kv_stride, k0, S);
    load_tile<T, D>(sV, vb, kv_stride, k0, S);
    __syncthreads();

    float s[ROWS][4], dp[ROWS][4];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[ROWS], ov[ROWS], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        qv[i] = sQ[(ROWS * rg + i) * LD + dd];
        ov[i] = sDO[(ROWS * rg + i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cl + 16 * j) * LD + dd];
        vv[j] = sV[(cl + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ROWS * rg + i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cl + 16 * j;
        const bool live = qp < S && kp < S && (!causal || qp >= kp);
        const float p = live ? expf(s[i][j] * scale - sL[r]) : 0.f;
        // dq multiplies dS rounded to k's dtype (flash_attention.py:126).
        sDS[r * LP + cl + 16 * j] = round_to<T>(p * (dp[i][j] - sDl[r]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + ROWS * rg + i;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) dqb[long(qp) * q_stride + cl + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int HKV, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = BQ + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sDS = sP + BK * LP;
  float* sL = sDS + BK * LP;
  float* sDl = sL + BQ;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cl = tid & 15;
  const int b = blockIdx.y / HKV;
  const int kvh = blockIdx.y % HKV;
  const int rep = H / HKV;
  const int k0 = blockIdx.x * BK;
  const long q_stride = long(H) * D;
  const long kv_stride = long(HKV) * D;
  const long kv_off = long(b) * S * kv_stride + long(kvh) * D;

  load_tile<T, D>(sK, k + kv_off, kv_stride, k0, S);
  load_tile<T, D>(sV, v + kv_off, kv_stride, k0, S);

  float dk_acc[ROWS][OC], dv_acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  // The first q tile whose last row reaches k0 (flash_attention.py:149).
  const int first_q = causal ? k0 / BQ : 0;
  for (int r = 0; r < rep; ++r) {
    const int head = kvh * rep + r;
    const long q_off = long(b) * S * q_stride + long(head) * D;
    const long row_off = (long(b) * H + head) * S;
    for (int qt = first_q; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's sQ/sDO/sP/sDS reads are done
      load_tile<T, D>(sQ, q + q_off, q_stride, q0, S);
      load_tile<T, D>(sDO, dout + q_off, q_stride, q0, S);
      load_row_stats(sL, sDl, lse + row_off, delta + row_off, q0, S);
      __syncthreads();

      // Transposed scores: s[i][j] = S[q0 + cl + 16j][k0 + 4rg + i].
      float s[ROWS][4], dp[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float kv[ROWS], vv[ROWS], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          kv[i] = sK[(ROWS * rg + i) * LD + dd];
          vv[i] = sV[(ROWS * rg + i) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(cl + 16 * j) * LD + dd];
          ov[j] = sDO[(cl + 16 * j) * LD + dd];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int kr = ROWS * rg + i;
        const int kp = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = cl + 16 * j;
          const int qp = q0 + qr;
          const bool live = qp < S && kp < S && (!causal || qp >= kp);
          const float p = live ? expf(s[i][j] * scale - sL[qr]) : 0.f;
          // dV multiplies P rounded to dO's dtype (flash_attention.py:161),
          // dK multiplies dS rounded to q's dtype (:164).
          sP[kr * LP + qr] = round_to<T>(p);
          sDS[kr * LP + qr] = round_to<T>(p * (dp[i][j] - sDl[qr]) * scale);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
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

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kp = k0 + ROWS * rg + i;
    if (kp >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dkb[long(kp) * kv_stride + cl + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dvb[long(kp) * kv_stride + cl + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int B, S, H, HKV;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.S, a.H, a.HKV, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BK - 1) / BK, a.B * a.HKV);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S,
      a.H, a.HKV, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 16: return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int run(const Args& a, int D, int dtype) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.HKV < 1 || a.H % a.HKV != 0 || a.B * a.H > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype == 0) return int(dispatch_d<DKV, float>(a, D));
  if (dtype == 1) return int(dispatch_d<DKV, __nv_bfloat16>(a, D));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq: [B, S, H, D]; k, v: [B, S, HKV, D] (all contiguous, one dtype);
// lse, delta: [B, H, S] fp32. dtype: 0 = float32, 1 = bfloat16.
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
