// RG-LRU linear scan, forward, for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t   per channel, fp32, h_{-1} = h0 (or 0).
//
// Replaces the TPU kernel K2: src/repro/kernels/rglru.py,
// rglru_scan_kernel() -> pl.pallas_call, body _kernel.  It computes the
// same function -- all h of a (B, S, R) sequence and the final state --
// but is not carried over block by block: the TPU walks time blocks in
// order over its sequential grid and keeps the state in VMEM scratch
// between them, and needs S % t_blk == R % r_blk == 0.  Here one thread
// owns one (b, r) channel for the whole sequence and keeps h in a
// register; neighbouring threads take neighbouring r, so every step reads
// and writes one coalesced row.  Any S and R work (the edge is masked).
//
// Bound on this card (H100 SXM, 3.35e12 B/s of device memory):
//     bytes(a, b, h) / 3.35e12 s = 12 * B * S * R / 3.35e12 s
// for fp32 a and b (8 * B * S * R for bf16), plus h0 and h_final
// (4 * B * R each).  Two flops a step is nothing beside that: no matmul
// work, the bound is memory bandwidth.
//
// What the design does about it: each byte of a and b is read once and
// each h written once, straight from and to device memory, with no
// scratch and no second pass.  The recurrence runs in time order, so a
// thread's loads would wait on each other step by step; instead the loop
// loads the next kSteps steps of a and b into registers before it does
// the arithmetic of the current ones, which keeps 2 * kSteps loads of
// every thread in flight.  With B * R threads in all (2,560 at the
// serving shapes) the card is not filled: this first version is simple
// and right, and at long S it is latency-bound, not at its bound (a
// chunked two-pass scan over time is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kSteps = 16;     // time steps loaded ahead

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a, b: (B, S, R); h0: (B, R) or null; h: (B, S, R); h_final: (B, R).
// Grid: (ceil(R / kThreads), B); block: kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_final, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t row = static_cast<size_t>(R);
  const size_t base = static_cast<size_t>(blockIdx.y) * S * row + r;
  const size_t chan = static_cast<size_t>(blockIdx.y) * row + r;
  float state = h0 != nullptr ? h0[chan] : 0.f;

  float a_next[kSteps], b_next[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool in = i < S;
    a_next[i] = in ? to_f32(a[base + i * row]) : 0.f;
    b_next[i] = in ? to_f32(b[base + i * row]) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    float a_cur[kSteps], b_cur[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      a_cur[i] = a_next[i];
      b_cur[i] = b_next[i];
    }
    // the next steps' loads go out before this step's arithmetic
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + kSteps + i;
      const bool in = t < S;
      a_next[i] = in ? to_f32(a[base + t * row]) : 0.f;
      b_next[i] = in ? to_f32(b[base + t * row]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = t0 + i;
      if (t < S) {
        state = fmaf(a_cur[i], state, b_cur[i]);
        h[base + t * row] = state;
      }
    }
  }
  h_final[chan] = state;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h,
                   void* h_final, int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_final), S, R);
  return cudaGetLastError();
}

}  // namespace

// dtype (of a and b): 0 = float32, 1 = bfloat16.  h0 may be null (zero
// initial state).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b,
                                    const void* h0, void* h, void* h_final,
                                    int B, int S, int R, int dtype,
                                    void* stream) {
  if (B <= 0 || S < 0 || R <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_final, B, S, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, h_final, B, S, R, st);
  return cudaErrorInvalidValue;
}
