// RG-LRU linear scan, forward, for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t   per channel, fp32, h_{-1} = h0 (or 0).
//
// Replaces the TPU kernel K2: src/repro/kernels/rglru.py,
// rglru_scan_kernel() -> pl.pallas_call, body _kernel.  It computes the
// same function -- all h of a (B, S, R) sequence and the final state --
// but is not carried over block by block: the TPU walks time blocks in
// order over its sequential grid and keeps the state in VMEM scratch
// between them, and needs S % t_blk == R % r_blk == 0.  Here any S and R
// work (the edges are masked), and neighbouring threads always take
// neighbouring r, so every step reads and writes one coalesced row.
//
// Bound on this card (H100 SXM, 3.35e12 B/s of device memory):
//     bytes(a, b, h) / 3.35e12 s = 12 * B * S * R / 3.35e12 s
// for fp32 a and b (8 * B * S * R for bf16), plus h0 and h_final
// (4 * B * R each).  Two flops a step is nothing beside that: no matmul
// work, the bound is memory bandwidth.
//
// Design.  A thread that walks one channel through the whole sequence
// leaves the card nearly empty at long S (B * R = 2,560 threads at the
// serving shapes, 20 blocks for 132 SMs) and waits on memory latency.  So
// for S > kChunk the scan is chunked over time, in three launches behind
// the one entry point:
//   1. summary: for each (b, chunk of kChunk steps, r) in parallel, the
//      chunk's product of a and its scan from 0 (its last value) -- two
//      (B, n_chunks, R) fp32 scratch arrays the wrapper allocates;
//   2. carry: for each (b, r), a serial walk over the n_chunks summaries
//      from h0: carry_{c+1} = prod_c * carry_c + local_c; each chunk's
//      carry-in overwrites its product;
//   3. rescan: for each (b, chunk, r) in parallel, the chunk's scan again
//      from its carry-in, writing h (and h_final from the last chunk).
// At S = 2048, R = 2560 passes 1 and 3 run 81,920 threads each.  Pass 3
// reads a and b a second time (from L2 where they still sit), and the
// scratch adds 8 * B * n_chunks * R bytes each way: 0.66 MB at S = 2048,
// against the bound's 63 MB.  The reassociation h_t = local_t + prod *
// carry touches only the carries, whose rounding stays far inside the
// scan's 1e-5.  For S <= kChunk (every serving prefill: 4 to 23 tokens)
// one launch keeps the one-pass loop: a thread per channel, kSteps loads
// in flight ahead of the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kSteps = 16;     // one-pass: time steps loaded ahead
constexpr int kChunk = 64;     // chunked: time steps a chunk
constexpr int kGroup = 32;     // chunked: loads in flight a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One pass.  a, b: (B, S, R); h0: (B, R) or null; h: (B, S, R);
// h_final: (B, R).  Grid: (ceil(R / kThreads), B).
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

// Scan kChunk steps of one channel from `state`, kGroup loads in flight;
// with `h` non-null every step is stored.  Returns the last state and
// multiplies `prod` by every a.
template <typename T>
__device__ __forceinline__ float scan_chunk(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            size_t base, size_t row, int n,
                                            float state, float& prod,
                                            float* __restrict__ h) {
#pragma unroll
  for (int i0 = 0; i0 < kChunk; i0 += kGroup) {
    float av[kGroup], bv[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const bool in = i0 + i < n;
      av[i] = in ? to_f32(a[base + (i0 + i) * row]) : 1.f;
      bv[i] = in ? to_f32(b[base + (i0 + i) * row]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      state = fmaf(av[i], state, bv[i]);
      prod *= av[i];
      if (h != nullptr && i0 + i < n) h[base + (i0 + i) * row] = state;
    }
  }
  return state;
}

// Pass 1.  prod, local: (B, n_chunks, R).  Grid: (ceil(R / kThreads),
// n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_summary(const T* __restrict__ a, const T* __restrict__ b,
                    float* __restrict__ prod, float* __restrict__ local,
                    int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int c = blockIdx.y, nc = gridDim.y;
  const size_t row = static_cast<size_t>(R);
  const size_t base =
      (static_cast<size_t>(blockIdx.z) * S + static_cast<size_t>(c) * kChunk)
          * row + r;
  float p = 1.f;
  const float last = scan_chunk(a, b, base, row, min(kChunk, S - c * kChunk),
                                0.f, p, static_cast<float*>(nullptr));
  const size_t out = (static_cast<size_t>(blockIdx.z) * nc + c) * row + r;
  prod[out] = p;
  local[out] = last;
}

// Pass 2.  Grid: (ceil(R / kThreads), B).  prod[c] becomes chunk c's
// carry-in.
__global__ void __launch_bounds__(kThreads)
rglru_chunk_carry(const float* __restrict__ h0, float* __restrict__ prod,
                  const float* __restrict__ local, int nc, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t row = static_cast<size_t>(R);
  const size_t chan = static_cast<size_t>(blockIdx.y) * row + r;
  const size_t base = static_cast<size_t>(blockIdx.y) * nc * row + r;
  float carry = h0 != nullptr ? h0[chan] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kSteps) {
    float pv[kSteps], lv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool in = c0 + i < nc;
      pv[i] = in ? prod[base + (c0 + i) * row] : 0.f;
      lv[i] = in ? local[base + (c0 + i) * row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (c0 + i < nc) {
        prod[base + (c0 + i) * row] = carry;
        carry = fmaf(pv[i], carry, lv[i]);
      }
    }
  }
}

// Pass 3.  Grid: (ceil(R / kThreads), n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_rescan(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ carry_in, float* __restrict__ h,
                   float* __restrict__ h_final, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int c = blockIdx.y, nc = gridDim.y;
  const size_t row = static_cast<size_t>(R);
  const size_t base =
      (static_cast<size_t>(blockIdx.z) * S + static_cast<size_t>(c) * kChunk)
          * row + r;
  const size_t chan = static_cast<size_t>(blockIdx.z) * row + r;
  float p = 1.f;
  const float last = scan_chunk(
      a, b, base, row, min(kChunk, S - c * kChunk),
      carry_in[(static_cast<size_t>(blockIdx.z) * nc + c) * row + r], p, h);
  if (c == nc - 1) h_final[chan] = last;
}

template <typename T>
cudaError_t launch(const void* a_, const void* b_, const float* h0, float* h,
                   float* h_final, float* scratch, int B, int S, int R,
                   cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  const int blocks = (R + kThreads - 1) / kThreads;
  if (S <= kChunk) {
    rglru_scan_kernel<T><<<dim3(blocks, B), kThreads, 0, stream>>>(
        a, b, h0, h, h_final, S, R);
    return cudaGetLastError();
  }
  const int nc = (S + kChunk - 1) / kChunk;
  float* prod = scratch;
  float* local = scratch + static_cast<size_t>(B) * nc * R;
  rglru_chunk_summary<T><<<dim3(blocks, nc, B), kThreads, 0, stream>>>(
      a, b, prod, local, S, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_chunk_carry<<<dim3(blocks, B), kThreads, 0, stream>>>(h0, prod,
                                                              local, nc, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_chunk_rescan<T><<<dim3(blocks, nc, B), kThreads, 0, stream>>>(
      a, b, prod, h, h_final, S, R);
  return cudaGetLastError();
}

}  // namespace

// Time steps a chunk: for S > this the scan is chunked, and the caller
// passes a scratch of 2 * B * ceil(S / chunk) * R floats.
extern "C" int repro_rglru_chunk() { return kChunk; }

// dtype (of a and b): 0 = float32, 1 = bfloat16.  h0 may be null (zero
// initial state); scratch may be null when S <= repro_rglru_chunk().
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b,
                                    const void* h0, void* h, void* h_final,
                                    void* scratch, int B, int S, int R,
                                    int dtype, void* stream) {
  if (B <= 0 || S < 0 || R <= 0 || B > 65535 ||
      (S > kChunk && (scratch == nullptr || (S + kChunk - 1) / kChunk > 65535)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  float* hff = static_cast<float*>(h_final);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(a, b, h0f, hf, hff, sc, B, S, R, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0f, hf, hff, sc, B, S, R, st);
  return cudaErrorInvalidValue;
}
