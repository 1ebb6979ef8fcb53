// Chunked RWKV-6 WKV, forward, for Hopper (sm_90a).  Per (b, h), head
// size N = 64, with the N x N fp32 state S (row n: key channel, column m:
// value channel):
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// S_{-1} = s0 (or 0); returns all y and the final S.
//
// Replaces the TPU kernel K3: src/repro/kernels/rwkv6.py, wkv6() ->
// pl.pallas_call, body _kernel.  It computes the same chunked algorithm
// (chunk L, lc_t the inclusive cumulative sum of log w over the chunk):
//     E(x)  = exp(clip(x, -40, 0))
//     y_t   = sum_{s<t} [sum_n r_tn k_sn E(lc_{t-1,n} - lc_{s,n})] v_s
//           + (r_t . (u * k_t)) v_t + (r_t * E(lc_{t-1})) S
//     S'    = diag(E(lc_L)) S + sum_s (k_s * E(lc_L - lc_s))^T v_s
// with the reference's one-sided clamp and w clipped at 1e-38 before the
// log, but is not carried over block by block.  The TPU grid walks the
// chunks of one (b, h) in order and keeps S in VMEM scratch between grid
// steps; blocks on the card run in no order, so here the chunk walk is a
// loop inside one block, and S stays in shared memory for the whole
// sequence: loaded from s0 (or zeroed) once, written to s_final once.
// The TPU kernel holds the (L, L, N) pairwise decay in VMEM (256 KB at
// chunk 32, more than a block's 227 KB here); this kernel never
// materialises it: each score sums exp(clip(lc_{t-1,n} - lc_{s,n})) over n
// on the fly.  The TPU kernel needs S % chunk == 0; here the tail chunk is
// masked with r = k = v = 0 and w = 1, which is the padding the model's
// chunked WKV (src/repro/models/rwkv.py, wkv6_chunked) applies, so any S
// works.
//
// Parallelism: column m of S depends only on v[:, m], so the 64 value
// columns split into kGroups groups of kCols with no communication.  One
// block owns one (b, h, column group); at the serving shape B = 1, H = 64
// that is 256 blocks for 132 SMs, where one block per (b, h) would leave
// half the card idle.  The price is that each of the kGroups blocks of a
// head recomputes the chunk's scores and decays.
//
// Bound on this card (H100 SXM): bytes of r, k, v, w, u, s0 in and y,
// s_final out at 3.35e12 B/s, or the recurrence's fp32 operations (about
// 5 N^2 a token and head: r S, the k v^T outer product and w S + k v^T) at
// 67e12 FLOP/s outside the tensor cores, whichever is larger.  At B = 1,
// H = 64, S = 23 (a serving prompt, bf16 r/k/v, zero s0 passed) the bytes
// bound it, 3.43 MB, about 1 us; at S = 2048 the operations, about 40 us.
// What the design does about it: every input byte is read once per
// column group (r, k and w kGroups times, from L2 after the first) and
// every output written once; the state never leaves shared memory.  Each
// chunk is loaded, then computed between barriers with no overlap of
// loads and arithmetic, and the scores are recomputed per column group:
// this first version is simple and right, not at its bound (overlap and
// tensor cores are later work).
//
// Math: plain expf and logf, no --use_fast_math (fast math flushes
// subnormals, which the 1e-38 clip reaches, and changes expf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;               // head size (rwkv6: d_model / 64 heads)
constexpr int kCols = 16;            // value columns a block owns
constexpr int kGroups = kN / kCols;  // blocks per (b, h)
constexpr int kMaxChunk = 32;
constexpr int kThreads = 256;
constexpr int kPad = kN + 1;         // row pitch of the (L, N) tiles: rows
                                     // read down a column hit distinct banks
constexpr float kClamp = 40.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp(clip(x, -40, 0)), the reference's one-sided clamp
__device__ __forceinline__ float clamped_exp(float x) {
  return expf(fminf(fmaxf(x, -kClamp), 0.f));
}

// r, k, v: (B, H, S, N) in T; w: (B, H, S, N) fp32 -- all four with the
// element strides (sb, sh, ss, 1); u: (H, N); s0: (B, H, N, N) or null;
// y: (B, H, S, N) and s_final: (B, H, N, N), contiguous fp32.
// Grid: (kGroups, H, B); block: kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_final, int S, int L,
            long long sb, long long sh, long long ss) {
  __shared__ float r_s[kMaxChunk][kPad];    // r, then r * exp(lc_{t-1})
  __shared__ float k_s[kMaxChunk][kPad];    // k, then k * exp(lc_L - lc_s)
  __shared__ float cum[kMaxChunk][kPad];    // log w, then lc_t
  __shared__ float cum_ex[kMaxChunk][kPad]; // lc_{t-1}
  __shared__ float v_s[kMaxChunk][kCols];
  __shared__ float score[kMaxChunk][kMaxChunk + 1];
  __shared__ float bonus[kMaxChunk];
  __shared__ float u_s[kN];
  __shared__ float state[kN][kCols];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const long long in0 = b * sb + h * sh;
  const long long y0 = (static_cast<long long>(b) * H + h) * S * kN;
  const long long st0 = (static_cast<long long>(b) * H + h) * kN * kN;
  const int pairs = L * (L - 1) / 2;        // (t, s) with s < t

  for (int i = tid; i < kN * kCols; i += kThreads) {
    const int n = i / kCols, m = i % kCols;
    state[n][m] = s0 != nullptr ? s0[st0 + n * kN + c0 + m] : 0.f;
  }
  if (tid < kN) u_s[tid] = u[h * kN + tid];

  for (int t0 = 0; t0 < S; t0 += L) {
    // 1. the chunk; rows past S are the reference's padding
    for (int i = tid; i < L * kN; i += kThreads) {
      const int t = i / kN, n = i % kN;
      const bool in = t0 + t < S;
      const long long off = in0 + (t0 + t) * ss + n;
      r_s[t][n] = in ? to_f32(r[off]) : 0.f;
      k_s[t][n] = in ? to_f32(k[off]) : 0.f;
      cum[t][n] = in ? logf(fmaxf(w[off], 1e-38f)) : 0.f;
    }
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, m = i % kCols;
      v_s[t][m] = t0 + t < S ? to_f32(v[in0 + (t0 + t) * ss + c0 + m])
                             : 0.f;
    }
    __syncthreads();

    // 2. cumulative log decay, one thread per key channel
    if (tid < kN) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = cum[t][tid];
        acc += lw;
        cum[t][tid] = acc;
        cum_ex[t][tid] = acc - lw;
      }
    }
    __syncthreads();

    // 3. strictly causal scores, one (t, s) pair of the lower triangle a
    //    thread, and the diagonal's u bonus
    for (int i = tid; i < pairs; i += kThreads) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * i)) * 0.5f);
      while (t * (t - 1) / 2 > i) --t;
      while ((t + 1) * t / 2 <= i) ++t;
      const int s = i - t * (t - 1) / 2;
      float acc = 0.f;
#pragma unroll 16
      for (int n = 0; n < kN; ++n)
        acc += r_s[t][n] * k_s[s][n] * clamped_exp(cum_ex[t][n] - cum[s][n]);
      score[t][s] = acc;
    }
    if (tid < L) {
      float acc = 0.f;
      for (int n = 0; n < kN; ++n) acc += r_s[tid][n] * (u_s[n] * k_s[tid][n]);
      bonus[tid] = acc;
    }
    __syncthreads();

    // 4. fold the decays into r (reading S) and k (writing S)
    for (int i = tid; i < L * kN; i += kThreads) {
      const int t = i / kN, n = i % kN;
      r_s[t][n] *= clamped_exp(cum_ex[t][n]);
      k_s[t][n] *= clamped_exp(cum[L - 1][n] - cum[t][n]);
    }
    __syncthreads();

    // 5. this block's columns of y for the chunk
    for (int i = tid; i < L * kCols; i += kThreads) {
      const int t = i / kCols, m = i % kCols;
      if (t0 + t >= S) continue;
      float acc = bonus[t] * v_s[t][m];
      for (int s = 0; s < t; ++s) acc += score[t][s] * v_s[s][m];
#pragma unroll 16
      for (int n = 0; n < kN; ++n) acc += r_s[t][n] * state[n][m];
      y[y0 + static_cast<long long>(t0 + t) * kN + c0 + m] = acc;
    }
    __syncthreads();

    // 6. carry the state across the chunk; each element has one owner
    for (int i = tid; i < kN * kCols; i += kThreads) {
      const int n = i / kCols, m = i % kCols;
      float acc = clamped_exp(cum[L - 1][n]) * state[n][m];
      for (int s = 0; s < L; ++s) acc += k_s[s][n] * v_s[s][m];
      state[n][m] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < kN * kCols; i += kThreads) {
    const int n = i / kCols, m = i % kCols;
    s_final[st0 + n * kN + c0 + m] = state[n][m];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* y, float* s_final, int B, int H, int S, int L,
                   long long sb, long long sh, long long ss,
                   cudaStream_t stream) {
  const dim3 grid(kGroups, H, B);
  wkv6_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, s_final, S, L, sb, sh, ss);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k and v): 0 = float32, 1 = bfloat16; w, u and s0 are
// float32.  N must be 64 and 1 <= chunk <= 32.  s0 may be null (zero
// initial state).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_final, int B, int H, int S,
                              int N, int chunk, long long stride_b,
                              long long stride_h, long long stride_s,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || B > 65535 || H > 65535 || N != kN ||
      chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_final);
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, yf, sf, B, H, S, chunk,
                         stride_b, stride_h, stride_s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, yf, sf, B, H, S,
                                 chunk, stride_b, stride_h, stride_s, st);
  return cudaErrorInvalidValue;
}
