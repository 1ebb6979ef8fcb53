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
// with S_eff the unmasked (query, key) pairs of one (b, h): 4 * D
// operations a pair (QK^T and PV).  At the serving path's shapes (S <= 32)
// both terms are well under a microsecond and the launch dominates; at
// S = 2048 the operation term dominates, so the products have to run on
// the tensor cores.
//
// bfloat16: flash_attention_tc, on the tensor cores.
//   * One consumer warpgroup (128 threads) owns 64 query rows.  S = Q K^T
//     is wgmma m64n64k16 (bf16 in, fp32 accumulate) with Q and K read from
//     shared memory through descriptors; the online softmax runs on the
//     accumulator registers (row max and sum across the 4 threads of a
//     row-quad by shuffles, expf in fp32, -1e30 and 1e-30 as the TPU
//     kernel); P is rounded to bf16 in registers -- as the reference model
//     rounds p to v's dtype -- and fed as the register A operand of
//     O += P V, with V the B operand read from shared memory through the
//     transpose flag, so V needs no transposed copy.  l sums the unrounded
//     fp32 p.
//   * Tiles live in shared memory in the 128-byte swizzle that TMA writes
//     and the descriptors read: D is split into 64-column (128 B) slabs,
//     each slab of a tile stored as rows of 128 B, 1024-B aligned.
//   * K/V tiles arrive by TMA (one cp.async.bulk.tensor per slab, over
//     k and v as they lie, (B, S, KV, D), rows past S filled with zeros
//     by the hardware) into a ring of two stages with an mbarrier each:
//     while the warpgroups consume tile j, tile j+1 is in flight; thread 0
//     refills a stage once a __syncthreads shows every warpgroup done
//     with it.  Q arrives once per block the same way.
//   * Tiles per D (BQ query rows, BK keys, two K/V stages, 1 KiB of
//     alignment slack on top; registers a thread from ptxas -v):
//         D = 64:  BQ = 64  (1 warpgroup),  BK = 128,  73 KiB, 168 regs
//         D = 128: BQ = 128 (2 warpgroups), BK = 64,   97 KiB, 149 regs
//         D = 256: BQ = 128 (2 warpgroups), BK = 64,  193 KiB, 227 regs
//     Nothing inside a warpgroup overlaps its softmax with its products,
//     so what keeps the tensor cores busy is other warpgroups on the same
//     SM: the sizes are those that put the most warpgroups on an SM --
//     three blocks of one at D = 64 (registers), one block of two at
//     D = 256 (shared memory; the O accumulator alone is 128 fp32
//     registers a thread).  launch/k1_tiles.py times the alternatives.
//     No configuration spills.
//   * The grid is (H, B, q-tiles) with the q-tile index reversed, so the
//     heaviest causal tiles start first and the short ones fill the tail.
//   * Tiles a warpgroup cannot see are skipped; tiles wholly inside the
//     causal and window band skip the mask.
//   Left for later: warp specialisation (a producer warp and setmaxnreg),
//   a persistent grid, ping-pong of softmax and wgmma inside a
//   warpgroup, wider wgmma N (n128 for S, n256 for O), fp8.
//
// float32: flash_attention_f32, scalar fp32 FMAs out of shared memory.
//   TF32 tensor cores keep about three decimal digits and cannot hold the
//   float32 tolerance of 2e-5, and float32 runs only in the small
//   card-vs-CPU models and tests, so it stays the simple kernel: one block
//   of 4 warps per 16 query rows, 64-key tiles.  The kernel is chosen by
//   dtype, never on failure.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // as the TPU kernel

// ---------------------------------------------------------------------------
// float32: scalar kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 64;                     // keys per shared tile

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
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBlockK * (D + 1)         // K tile, padded rows
                          + kBlockK * D             // V tile
                          + kBlockQ * D             // q tile
                          + kWarps * kRowsPerWarp * kBlockK);  // p rows
}

// q: (B, S, H, D); k, v: (B, S, KV, D); o: (B, S, H, D); all contiguous.
// Grid: (ceil(S / kBlockQ), H, B); block: kWarps * 32 threads.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int S, int H, int KV, float scale, int window,
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
    Qs[i] = qp < S ? q[((static_cast<size_t>(b) * S + qp) * H + h) * D + i % D]
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
      Ks[j * KS + d] = kp < S ? k[g] : 0.f;
      Vs[j * D + d] = kp < S ? v[g] : 0.f;
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
      Pw[r * kBlockK + lane] = p0;
      Pw[r * kBlockK + lane + 32] = p1;
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
    float* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) out[lane + 32 * c] = acc[r][c] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, int window, float softcap,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  auto kernel = flash_attention_f32<D>;
  // Above 48 KB (D = 128: 78,080 B; D = 256: 151,808 B) a block gets the
  // memory only when asked for.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, scale,
      window, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory; completion is
// counted in bytes on the mbarrier ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-B units.  K-major tiles (Q, K: the
// reduction dim D contiguous) use SBO = 1024 B between 8-row groups; the
// MN-major V tile (d contiguous, keys the reduction dim) uses SBO = 1024 B
// between 8-key groups and LBO between 64-column slabs.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, fp32) += A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D_, int BK_, int NWG_>
struct Tiles {
  static constexpr int D = D_;
  static constexpr int BK = BK_;
  static constexpr int NWG = NWG_;
  static constexpr int BQ = 64 * NWG;
  static constexpr int kSlabs = D / 64;
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;  // one K or V tile
  // Q, K stages, V stages, 3 mbarriers, 1 KiB to align the base to 1024 B
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 3 * 8;
};

using TilesD64 = Tiles<64, 128, 1>;
using TilesD128 = Tiles<128, 64, 2>;
using TilesD256 = Tiles<256, 64, 2>;

// q: (B, S, H, D), k, v: (B, S, KV, D) through tensor maps; o: (B, S, H, D)
// contiguous bf16.  Grid: (H, B, ceil(S / BQ)); block: 128 * NWG threads.
template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                   float scale, int window, float softcap) {
  constexpr int D = T::D, BK = T::BK, BQ = T::BQ, kSlabs = T::kSlabs;
  constexpr int kHalves = BK / 64;  // n64 score blocks per K tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::kQBytes;                      // + stage * tile
  const uint32_t sV = sK + T::kStages * T::kTileBytes;      // + stage * tile
  const uint32_t bar_q = sV + T::kStages * T::kTileBytes;
  const uint32_t bar_kv = bar_q + 8;                        // + stage * 8

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int kvh = h / (H / KV);

  // Causality ends the KV range at the block's last row; the window starts
  // it at the first key the block's first row can see.
  const int k_end = min(q0 + BQ, S);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % T::kStages;
    const int k0 = k_begin + j * BK;
    mbar_expect_tx(bar_kv + 8 * s, 2 * T::kTileBytes);
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      tma_load(sK + s * T::kTileBytes + sl * BK * 128, map_k, bar_kv + 8 * s,
               sl * 64, kvh, k0, b);
      tma_load(sV + s * T::kTileBytes + sl * BK * 128, map_v, bar_kv + 8 * s,
               sl * 64, kvh, k0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < T::kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl)
      tma_load(sQ + sl * BQ * 128, &tq, bar_q, sl * 64, h, q0, b);
    for (int j = 0; j < T::kStages && j < n_tiles; ++j) load_kv(j);
  }

  // This thread's accumulator rows (the wgmma fragment): row0 and row0 + 8;
  // its columns in each 8-column block: c2 and c2 + 1.
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int wq_lo = q0 + wg * 64;  // this warpgroup's rows [wq_lo, +64)
  const int wq_last = min(wq_lo + 63, S - 1);

  float acc[kSlabs][32];
#pragma unroll
  for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % T::kStages;
    const int k0 = k_begin + j * BK;
    const uint32_t sKs = sK + s * T::kTileBytes;
    const uint32_t sVs = sV + s * T::kTileBytes;
    mbar_wait(bar_kv + 8 * s, (j / T::kStages) & 1);

    // Does any row of this warpgroup see a key of the tile?
    const bool live = wq_lo <= wq_last && k0 <= wq_last &&
                      (window <= 0 || k0 + BK - 1 > wq_lo - window);
    if (live) {
      // S = Q K^T, fp32 in registers.
      float sc[kHalves][32];
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[hf][i] = 0.f;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) reg_fence(sc[hf]);
      wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;  // 16 columns of a slab
          const uint64_t da = smem_desc(
              sQ + (kk / 4) * (BQ * 128) + wg * (64 * 128) + col, 16);
          const uint64_t db = smem_desc(
              sKs + (kk / 4) * (BK * 128) + hf * (64 * 128) + col, 16);
          wgmma_ss(sc[hf], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) reg_fence(sc[hf]);

      // Online softmax on the fragment.  Masked scores become -inf, so
      // their p is exactly 0; m starts at -1e30, so it stays finite.
      const float kMasked = __int_as_float(static_cast<int>(0xff800000u));
      const bool need_mask =
          !(k0 + BK - 1 <= wq_lo &&
            (window <= 0 || wq_lo + 63 - k0 < window));
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = row0 + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[hf][4 * n + 2 * i + e] * scale;
              if (softcap > 0.f) x = softcap * tanhf(x / softcap);
              if (need_mask) {
                const int kp = k0 + hf * 64 + 8 * n + c2 + e;
                if (kp > qp || (window > 0 && qp - kp >= window))
                  x = kMasked;
              }
              sc[hf][4 * n + 2 * i + e] = x;
              mx = fmaxf(mx, x);
            }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = expf(sc[hf][4 * n + 2 * i + e] - m_new);
              sc[hf][4 * n + 2 * i + e] = p;
              sum += p;
            }
        l[i] = l[i] * corr[i] + sum;
      }
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[sl][4 * n + 2 * i + e] *= corr[i];

      // P in bf16 as the A fragment of each 16-key step: the score
      // fragment's layout is the A operand's, two columns to a register.
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int hf = kk / 4, n = 8 * (kk % 4);
        pf[kk][0] = pack_bf16(sc[hf][n], sc[hf][n + 1]);  // row0, keys c2, +1
        pf[kk][1] = pack_bf16(sc[hf][n + 2], sc[hf][n + 3]);  // row0 + 8
        pf[kk][2] = pack_bf16(sc[hf][n + 4], sc[hf][n + 5]);  // row0, c2 + 8
        pf[kk][3] = pack_bf16(sc[hf][n + 6], sc[hf][n + 7]);  // row0 + 8
      }

      // O += P V, V read MN-major (transposed) from its swizzled tile.
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) reg_fence(acc[sl]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) reg_fence(pf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int sl = 0; sl < kSlabs; ++sl)
          wgmma_rs(acc[sl], pf[kk],
                   smem_desc(sVs + sl * (BK * 128) + kk * (16 * 128),
                             BK * 128));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) reg_fence(acc[sl]);
    }

    // Every warpgroup is done with stage s: refill it with tile j + 2.
    __syncthreads();
    if (tid == 0 && j + T::kStages < n_tiles) load_kv(j + T::kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + sl * 64 + 8 * n + c2) =
            __floats2bfloat162_rn(acc[sl][4 * n + 2 * i] / denom,
                                  acc[sl][4 * n + 2 * i + 1] / denom);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda) looked up through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, S, heads, D) contiguous tensor as a 4-D tensor map whose box
// is one 64-column slab of ``rows`` positions of one head, 128-B swizzled.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KV, int window, float softcap,
                      cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, H, T::D, T::BQ) ||
      !make_map(encode, &tk, k, B, S, KV, T::D, T::BK) ||
      !make_map(encode, &tv, v, B, S, KV, T::D, T::BK))
    return cudaErrorInvalidValue;
  const int n_qt = (S + T::BQ - 1) / T::BQ;
  if (n_qt > 65535 || B > 65535) return cudaErrorInvalidValue;
  auto kernel = flash_attention_tc<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(T::D));
  kernel<<<dim3(H, B, n_qt), T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, KV, scale, window,
      softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// window <= 0: no window; softcap <= 0: no softcap.  bf16 pointers must be
// 16-byte aligned (TMA).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int H, int KV, int D,
                                         int dtype, int window, float softcap,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 0 && D == 256)
    return launch_f32<256>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 1 && D == 64)
    return launch_tc<TilesD64>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 1 && D == 128)
    return launch_tc<TilesD128>(q, k, v, o, B, S, H, KV, window, softcap, st);
  if (dtype == 1 && D == 256)
    return launch_tc<TilesD256>(q, k, v, o, B, S, H, KV, window, softcap, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (D, dtype) takes, in
// bytes; 0 for a pair the library does not take.
extern "C" int repro_flash_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0 && D == 64) return static_cast<int>(f32_smem_bytes<64>());
  if (dtype == 0 && D == 128) return static_cast<int>(f32_smem_bytes<128>());
  if (dtype == 0 && D == 256) return static_cast<int>(f32_smem_bytes<256>());
  if (dtype == 1 && D == 64) return static_cast<int>(TilesD64::kSmem);
  if (dtype == 1 && D == 128) return static_cast<int>(TilesD128::kSmem);
  if (dtype == 1 && D == 256) return static_cast<int>(TilesD256::kSmem);
  return 0;
}
