// Causal grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel K1: src/repro/kernels/flash_attention.py,
// flash_attention() -> pl.pallas_call, body _kernel.  It computes the same
// function -- causal GQA attention with an online softmax (running max m,
// denominator l, fp32 accumulator), scale 1/sqrt(D), optional tanh softcap
// applied before the mask, optional sliding window (q - k < window) -- but
// is not carried over block by block: the TPU walks a dense sequential grid
// over KV blocks and skips irrelevant ones, here one block owns one
// (b, h, q-tile) and loops over exactly the KV tiles that causality and the
// window leave, and any S works (the ragged edge is masked).
//
// Bound on this card (H100 SXM, 989e12 bf16 tensor-core FLOP/s,
// 3.35e12 B/s of device memory):
//     max(4 * B * H * S_eff * D / 989e12,  bytes(q, k, v, o) / 3.35e12)  s
// with S_eff the unmasked (query, key) pairs of one (b, h).  At the shapes
// of the serving path (B=1, S<=32, H=32, KV=8, D=64, bf16) both terms are
// well under a microsecond, so the launch itself dominates; at S=2048 the
// operation term dominates.
//
// What the design does about it: this first version is simple and right,
// not fast.  Scores never touch device memory (q, k, v are read and o is
// written once per block, which is the byte term), the KV loop is bounded
// by causality and the window so no masked tile is loaded, and the math
// runs as scalar fp32 FMAs out of shared memory: far from the operation
// term, which needs wgmma on the tensor cores (later work).  Each warp
// carries four query rows so that every shared-memory load of K or V
// feeds four FMAs.  Head dims 64, 128 and 256 are instantiated; at 256
// (recurrentgemma's MQA) a block holds 151,808 B of tiles, so one block
// runs on an SM at a time, and each thread keeps 4 x 8 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 64;                     // keys per shared tile
constexpr float kNegInf = -1e30f;               // as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// p is rounded to v's type before the PV product, as the reference model
// casts its probabilities to v.dtype (models/layers.py).
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockK * (D + 1)         // K tile, padded rows
                          + kBlockK * D             // V tile
                          + kBlockQ * D             // q tile
                          + kWarps * kRowsPerWarp * kBlockK);  // p rows
}

// q: (B, S, H, D); k, v: (B, S, KV, D); o: (B, S, H, D); all contiguous.
// Grid: (ceil(S / kBlockQ), H, B); block: kWarps * 32 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, float scale, int window,
                       float softcap) {
  constexpr int KS = D + 1;     // K row stride: lane j reads row j, column d
  constexpr int DPL = D / 32;   // output columns per lane
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * KS;
  float* Qs = Vs + kBlockK * D;
  float* Ps = Qs + kBlockQ * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  float* Pw = Ps + warp * kRowsPerWarp * kBlockK;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int qp = q0 + i / D;
    Qs[i] = qp < S
        ? to_f32(q[((static_cast<size_t>(b) * S + qp) * H + h) * D + i % D])
        : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // Causality ends the KV range at the tile's last row; the window starts
  // it at the first key the tile's first row can see.
  const int k_end = min(q0 + kBlockQ, S);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (first pass: Qs is in)
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i % D;
      const int kp = k0 + j;
      const size_t g = ((static_cast<size_t>(b) * S + kp) * KV + kvh) * D + d;
      Ks[j * KS + d] = kp < S ? to_f32(k[g]) : 0.f;
      Vs[j * D + d] = kp < S ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // Scores of this warp's rows against keys lane and lane + 32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * KS + d];
      const float kb = Ks[(lane + 32) * KS + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = Qs[(warp * kRowsPerWarp + r) * D + d];
        s[r][0] = fmaf(qd, ka, s[r][0]);
        s[r][1] = fmaf(qd, kb, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q0 + warp * kRowsPerWarp + r;
      bool valid[2];
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        valid[c] = qp < S && kp <= qp && (window <= 0 || qp - kp < window);
        s[r][c] = x;
        if (valid[c]) tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[r], warp_max(tile_max));
      const float corr = expf(m[r] - m_new);
      const float p0 = valid[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = valid[1] ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      Pw[r * kBlockK + lane] = round_as<T>(p0);
      Pw[r * kBlockK + lane + 32] = round_as<T>(p1);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const float vj = Vs[j * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][c] = fmaf(Pw[r * kBlockK + j], vj, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q0 + warp * kRowsPerWarp + r;
    if (qp >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store(out + lane + 32 * c, acc[r][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int window, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  // Above 48 KB (D = 128: 78,080 B; D = 256: 151,808 B of the 232,448 a
  // block may have) a block gets the memory only when asked for.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, window,
      softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window; softcap <= 0:
// no softcap.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int H, int KV, int D,
                                         int dtype, int window, float softcap,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, KV, window,
                                     softcap, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, KV, window,
                                      softcap, st);
  if (dtype == 0 && D == 256)
    return launch<float, 256>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 1 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, o, B, S, H, KV, window,
                                      softcap, st);
  return cudaErrorInvalidValue;
}
