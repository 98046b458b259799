// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd_impl on grid (b*h, nq, nk)). It computes the same
// function: exact attention with an online softmax, causal or not, o in the
// input dtype and lse = m + log(max(l, 1e-30)) in fp32, with probabilities
// rounded to the input dtype before the P.V product, and NEG_INF = -1e30 for
// masked scores. GQA maps query head `head` to kv head `head / (H / HKV)`;
// K/V are never repeated in memory.
//
// Design. The TPU grid walks its k axis in order and carries (max,
// normalizer, accumulator) in VMEM scratch from one grid step to the next.
// CUDA blocks run in no order, so that axis becomes a loop inside one block:
// one block per (b*h row, 64-row q tile) loads its q tile once, streams 64-row
// K and V tiles of the mapped kv head through shared memory up to the causal
// last tile, and keeps the running max, normalizer and fp32 accumulator in
// registers. Inputs are read in the model's own [b, s, h, d] layout, so no
// transpose precedes the launch. Rows past s are zero-filled and their scores
// masked, so any s works, including s shorter than a tile.
//
// 256 threads: thread t owns query rows 4*(t/16)..+3 of the tile, score
// columns (t%16) + 16*j and output columns (t%16) + 16*c. The 16 threads that
// share rows sit in one half-warp, so row max and row sum are shuffles.
// Products are fp32 FMAs from shared memory (rows padded by one float against
// bank conflicts); no tensor cores yet.
//
// Bound at the Llama-2-7B prefill shape (b=1, h=32, d=128, bf16, causal):
// operations 2*2*b*h*s^2*d/2 against 989 TFLOP/s, bytes q+k+v+o (bf16) + lse
// (fp32) against 3.35 TB/s. At s=2048 that is 34.4 GFLOP = 34.7 us against
// 67.4 MB = 20.1 us (operations bound); at s=1024, 8.6 GFLOP = 8.7 us against
// 33.7 MB = 10.1 us (bytes bound). This FMA kernel runs far from either
// bound; a wgmma/TMA pipeline is the way to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int ROWS = 4;  // query rows per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + 2 * size_t(BK) * (D + 1) + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int HKV, float scale,
                 int causal) {
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
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int kvh = head / (H / HKV);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = long(H) * D;    // between positions of one head
  const long kv_stride = long(HKV) * D;
  const T* qb = q + long(b) * S * q_stride + long(head) * D;
  const T* kb = k + long(b) * S * kv_stride + long(kvh) * D;
  const T* vb = v + long(b) * S * kv_stride + long(kvh) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int pos = q0 + r;
    sQ[r * LD + c] = pos < S ? to_f32(qb[long(pos) * q_stride + c]) : 0.f;
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
      sK[r * LD + c] = in ? to_f32(kb[long(pos) * kv_stride + c]) : 0.f;
      sV[r * LD + c] = in ? to_f32(vb[long(pos) * kv_stride + c]) : 0.f;
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
        // P.V multiplies probabilities rounded to the input dtype.
        sP[(ROWS * rg + i) * LP + cl + 16 * j] = to_f32(from_f32<T>(p));
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

  T* ob = o + long(b) * S * q_stride + long(head) * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + ROWS * rg + i;
    if (qp >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) ob[long(qp) * q_stride + cl + 16 * c] = from_f32<T>(acc[i][c] / ll);
    if (cl == 0) lse[long(bh) * S + qp] = m[i] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                   int H, int HKV, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, H, HKV, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int S, int H, int HKV, int D, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, HKV, scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, HKV, scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, HKV, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, HKV, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, S, H, D], k/v: [B, S, HKV, D], o: [B, S, H, D] (all contiguous, one
// dtype), lse: [B, H, S] fp32. dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int S, int H, int HKV, int D, int dtype, float scale, int causal,
                         void* stream) {
  if (B < 1 || S < 1 || H < 1 || HKV < 1 || H % HKV != 0 || B * H > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, lse, B, S, H, HKV, D, scale, causal, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, HKV, D, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
