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
//     A_ts  = sum_n r_tn k_sn E(lc_{t-1,n} - lc_{s,n})   (s < t)
//     A_tt  = r_t . (u * k_t)
//     y_t   = sum_{s<=t} A_ts v_s + r~_t S,      r~_t = r_t * E(lc_{t-1})
//     S'    = diag(E(lc_L)) S + K~^T V,          K~_s = k_s * E(lc_L - lc_s)
// with the reference's one-sided clamp and w clipped at 1e-38 before the
// log.  The TPU grid walks the chunks of one (b, h) in order and keeps S
// in VMEM between grid steps; here the walk is a loop inside the two CTAs
// of a head.  The TPU kernel needs S % chunk == 0; here the tail is the
// zero padding of the model's chunked WKV (src/repro/models/rwkv.py,
// wkv6_chunked: r = k = v = 0, w = 1), so any S works.
//
// Bound on this card (H100 SXM, 700 W): bytes of r, k, v, w, u, s0 in and
// y, s_final out at 3.35e12 B/s, or the operations -- the two products r S
// and k^T v, 4 N^2 a token and head, at the TF32 tensor-core peak 495e12
// FLOP/s, the rest (N^2 + 5 N) at the fp32 peak 67e12 -- whichever is
// larger.  At B = 1, H = 64, S = 2048 with bf16 r/k/v the bytes bound it:
// 118.5 MB, 0.0354 ms; at S = 23 (a serving prompt, zero s0 passed)
// 3.43 MB, about 1 us.
//
// Design.  Only S' and the r~ S term of y need the previous chunk; the
// loads, log w, the cumulative sums, r~, K~, the decays and the scores do
// not, so they run a block ahead of the state.
//   * Grid (2, H, B): a thread block cluster (__cluster_dims__) of two
//     CTAs a head, 128 CTAs at B = 1, H = 64, one a SM.  CTA j owns key
//     channels [32 j, 32 j + 32): the state rows, their log w, decays and
//     scores.  Its y is a partial sum over those channels; each state warp
//     pushes its partials into the shared memory of the CTA that stores
//     those columns (distributed shared memory, float2 stores), which sums
//     the two.  Four CTAs a head (16 channels each, two a SM) were tried
//     first: the runtime fits only 62 such clusters at once, so the last
//     two heads ran in a second wave.
//   * A block is the kernel's unit of work: two chunks of L <= 16 tokens
//     (one chunk for L > 16), at most 32 tokens, one a prep lane.
//   * Warp specialisation: warps 0-7 ("prep") take block i while warps
//     8-11 ("state", each owning 16 value columns of S) take block i - 1;
//     a CTA barrier an iteration hands the prepared block over through a
//     two-stage ring.  One cluster barrier phase an iteration hands the y
//     partials over; every arrive is relaxed and put where nothing of its
//     thread is in flight, with a cluster fence before the state warps'
//     arrive (a release arrive waits for every store of its thread still
//     in flight, the prep warps' y stores included).
//   * Loads run ahead: block i + 1's r, k, w (this CTA's channels) and v
//     (every column) arrive as four TMA boxes into a three-stage ring,
//     issued by four prep warps (one box each: a box stalls its issuing
//     warp while the copy engine takes it) and counted on an mbarrier.
//     The boxes for r, k and w are 16 B wider than the CTA's channels so
//     their rows land at a bank-conflict-free pitch; past S, TMA fills
//     zeros.  (Per-thread 16-byte cp.async, and one bulk copy a row, held
//     the issuing warps far longer than four boxes.)
//   * Prep: a lane is a token; each warp takes a float4 of 4 channels:
//     log2 w (lg2.approx, which keeps the subnormal 1e-38), a shuffle
//     scan within each chunk, r~, K~ and the decays, and the partial
//     scores of each chunk's (t, s) pairs over the CTA's 32 channels,
//     one pair a thread, in base 2 with ex2.approx.ftz (the clamp keeps
//     2^x in [2^-57.7, 1], far from the subnormals).  Each value that
//     goes into a product is split for 3xTF32 once, here, and stored as
//     hi and lo planes.
//   * State: y = r~ S_a + A V and S' = diag(d) S + K~^T V on the tensor
//     cores, mma.sync m16n8k8 TF32 with fp32 accumulation, per chunk.  S
//     lives in the state warps' accumulator registers for the whole
//     sequence and is staged through shared memory as a B operand once a
//     chunk.  hi*hi and the correction terms go to separate accumulators
//     (and the corrections to two, by k-step parity) to shorten the
//     dependency chains.
//   * Precision: a single TF32 pass rounds r~, K~, S and A to 11 bits
//     (about 4.9e-4 relative) and misses WKV_TOL = 1e-4; so every product
//     is 3xTF32: a = a_hi + a_lo, hi*hi + hi*lo + lo*hi in fp32 (the
//     dropped lo*lo is about 2^-22 relative).  bf16 v is exact in TF32,
//     so its lo term is 0 and those products take two passes.  Emulated
//     on the CPU (src/repro_torch/launch/k3_split.py) at chip_smoke.py's
//     inputs, against the step-by-step plain version: 3xTF32 errs by
//     3.3e-6 to 9.1e-6, as unrounded fp32 products do (4.3e-6 to
//     7.9e-6); one TF32 pass by 2.8e-3 to 7.4e-3.  On the card every
//     check of chip_smoke.py holds at 1e-4: max |err| up to 6.9e-5, and
//     6.9e-4 at w = 1e-38, inside rtol of y there, where the cumulative
//     log2 decay reaches -2,000 and rounds by 2.4e-4 in the exponent (the
//     same cumulative sums as the reference's chunked form).
//   * Scores stay scalar: on the tensor cores they would need the decay
//     split into two factors per sub-chunk, left for later.
//   * 384 threads, about 130 (bf16) and 140 (fp32) registers with no
//     spills (ptxas -v); 153,856 B (bf16) and 178,432 B (fp32) of dynamic
//     shared memory a block, so one CTA a SM; 184 and 240 HMMA in the
//     machine code (chip_smoke.py prints all of these).
//
// What holds it back: the prep and the state warps take about as long a
// block, the scores (an exp a pair and channel) most of prep's time, and
// each role's phases stretch when the other runs beside it on the SM:
// with 12 warps a SM the kernel is bound by instruction latency and issue,
// not by bytes (PERF.md, K3).
//
// Math: accurate enough without --use_fast_math (which would flush the
// subnormal 1e-38 that the clip reaches); the approximate SFU ops above
// are applied only where their inputs keep them exact to about 2 ulp.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 64;               // head size (rwkv6: d_model / 64 heads)
constexpr int kGroups = 2;           // CTAs in a head's cluster
constexpr int kRows = kN / kGroups;  // key channels (state rows) a CTA owns
constexpr int kOut = kN / kGroups;   // y columns a CTA sums and stores
constexpr int kMaxChunk = 32;        // tokens a block: one prep lane each
constexpr int kPrepWarps = 8;
constexpr int kStateWarps = 4;       // each owns 16 value columns
constexpr int kCols = kN / kStateWarps;
constexpr int kMT = kRows / 16;      // m-tiles of a warp's state rows
constexpr int kPrepThreads = 32 * kPrepWarps;
constexpr int kThreads = 32 * (kPrepWarps + kStateWarps);
constexpr int kChan = 4;             // key channels a prep warp scans
static_assert(kChan * kPrepWarps == kRows, "one float4 of channels a warp");
// Row pitches (floats) of 16-byte aligned rows, chosen against bank
// conflicts: prep reads and writes a float4 of channels a lane (token),
// which a pitch of 4 mod 32 words keeps conflict-free; the mma fragment
// loads read A at (row g, column tg) and B at (row tg, column g).
constexpr int kPitchA = kRows + 4;   // r~ (t, n), K~ (t, n), prep's tiles
constexpr int kPitchS = 36;          // scores (t, s)
constexpr int kPitchST = 24;         // a warp's S (n, m), read as B
// the clamp of exp(clip(x, -40, 0)) in base 2: x log2(e) >= -40 log2(e)
constexpr float kClamp2 = 57.70780163555854f;

template <typename T>
struct Smem {
  // TMA boxes: this CTA's key channels of r, k and w, widened by 16 B so
  // the rows land at a conflict-free pitch (the extra columns are the
  // next channels, or zero past the last); every value column of v
  static constexpr int kPitchR = kRows + 16 / static_cast<int>(sizeof(T));
  struct alignas(128) Raw {          // one block's inputs
    alignas(128) T r[kMaxChunk][kPitchR];
    alignas(128) T k[kMaxChunk][kPitchR];
    alignas(128) float w[kMaxChunk][kPitchA];
    alignas(128) T v[kMaxChunk][kN];
  };
  static constexpr unsigned kBoxBytes = sizeof(Raw);
  struct Stage {                     // one prepared block, split for 3xTF32
    float rt[2][kMaxChunk][kPitchA]; // [hi, lo] r * E(lc_{t-1})
    float kt[2][kMaxChunk][kPitchA]; // [hi, lo] k * E(lc_L - lc_t)
    float a[2][kMaxChunk][kPitchS];  // [hi, lo] scores over the CTA's channels
    float d[2][kRows];               // E(lc_L) of the block's chunks
  };
  Raw raw[3];
  uint64_t loaded[3];                // raw[i]'s TMA boxes have landed
  alignas(16) Stage stage[2];
  alignas(16) float rf[kMaxChunk][kPitchA];  // prep: r, k, lc_t, lc_{t-1}
  alignas(16) float kf[kMaxChunk][kPitchA];  // (base 2)
  alignas(16) float lc[kMaxChunk][kPitchA];
  alignas(16) float lce[kMaxChunk][kPitchA];
  float bonus[kPrepWarps][kMaxChunk];
  float u[kRows];
  float st[kStateWarps][kRows][kPitchST];  // S, staged as a B operand
  // y partials over the cluster's channels, for this CTA's output
  // columns: [block % 3][source CTA][token][column]
  alignas(16) float ypart[3][kGroups][kMaxChunk][kOut];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp(clip(x, -40, 0)) for x2 = x log2(e), the reference's one-sided
// clamp.  The clamped input keeps 2^x2 in [2^-57.7, 1], far from the
// subnormals, so the SFU's ex2.approx.ftz (2 ulp) is exact enough.
__device__ __forceinline__ float clamped_exp2(float x2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(fminf(fmaxf(x2, -kClamp2), 0.f)));
  return y;
}

__device__ __forceinline__ void prep_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPrepThreads) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` from bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one TMA box of a 4-D (channel, token, head, batch) tensor map into
// shared memory, completing in bytes on `bar`; rows past S read as zero
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(h), "r"(b),
      "r"(smem_addr(bar))
      : "memory");
}

// x = hi + lo, both TF32 (hi rounded to nearest, lo the rounded rest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// store x split into hi and lo planes (as fp32 bit patterns)
__device__ __forceinline__ void store_split(float& hi, float& lo, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// B from fp32 values: split here; from bf16 values: exact in TF32, no lo
template <typename T>
__device__ __forceinline__ FragB frag_b(T x0, T x1) {
  FragB f;
  if constexpr (std::is_same_v<T, float>) {
    split_tf32(x0, f.hi[0], f.lo[0]);
    split_tf32(x1, f.hi[1], f.lo[1]);
  } else {
    f.hi[0] = __float_as_uint(to_f32(x0));
    f.hi[1] = __float_as_uint(to_f32(x1));
    f.lo[0] = f.lo[1] = 0u;
  }
  return f;
}

// d += a_hi b_hi and c += a_lo b_hi + a_hi b_lo: 3xTF32 with the small
// terms in their own accumulator, two short dependency chains instead of
// one long one; b's lo term is skipped where b is exact in TF32
template <bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&c)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  if constexpr (!kExactB) mma_tf32(c, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// r, k, v (T) and w (fp32): tensor maps of (B, H, S, N) tensors (make_map);
// u: (H, N); s0: (B, H, N, N) or null; y: (B, H, S, N) and s_final:
// (B, H, N, N), contiguous fp32.  Grid: (kGroups, H, B) in clusters of
// kGroups; block: kThreads threads; dynamic shared memory sizeof(Smem<T>).
template <typename T>
__global__ void __cluster_dims__(kGroups, 1, 1)
    __launch_bounds__(kThreads, kGroups / 2)
wkv6_kernel(const __grid_constant__ CUtensorMap tr,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_final, int S,
            int L) {
  using Stage = typename Smem<T>::Stage;
  using Raw = typename Smem<T>::Raw;
  constexpr bool kExactV = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_bytes);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * kRows;                 // this CTA's key channels
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long y0 = (static_cast<long long>(b) * H + h) * S * kN;
  const long long st0 = (static_cast<long long>(b) * H + h) * kN * kN;
  // a block is G chunks of L tokens, BT <= 32 tokens
  const int G = L <= kMaxChunk / 2 ? 2 : 1;
  const int BT = G * L;
  const int nblocks = (S + BT - 1) / BT;
  const bool prep = warp < kPrepWarps;

  // -- prep: a block's loads, four TMA boxes from four warps --------------
  // (a box stalls its issuing warp while the copy engine takes it; the
  // barrier's byte count may run ahead of the expect, it only completes
  // once the arrive is in too)
  auto issue = [&](int blk) {
    if (lane != 0 || warp >= 4) return;
    Raw& raw = sm.raw[blk % 3];
    uint64_t* bar = &sm.loaded[blk % 3];
    const int t0 = blk * BT;
    switch (warp) {
      case 0:
        mbar_expect(bar, Smem<T>::kBoxBytes);
        tma_load(raw.r, &tr, bar, n0, t0, h, b);
        break;
      case 1: tma_load(raw.k, &tk, bar, n0, t0, h, b); break;
      case 2: tma_load(raw.w, &tw, bar, n0, t0, h, b); break;
      default: tma_load(raw.v, &tv, bar, 0, t0, h, b);
    }
  };

  // -- prep: a block's state-free work into stage blk % 2 -----------------
  auto prepare = [&](int blk) {
    const Raw& raw = sm.raw[blk % 3];
    Stage& st = sm.stage[blk & 1];
    const int t0 = blk * BT;
    // lane t, a float4 of key channels a warp: log2 w, the shuffle scan
    // over each chunk, r~, K~, d; rows past the block or past S are the
    // zero padding (w = 1)
    const int t = lane, tau = t % L, a = t / L;
    const bool in = t < BT && t0 + t < S;
    const int nb = warp * kChan;
    float lw[kChan], lc[kChan], rv[kChan], kv[kChan];
    {
      const float4 w4 = *reinterpret_cast<const float4*>(&raw.w[t][nb]);
      const float wv[kChan] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int q = 0; q < kChan; ++q) {
        // lg2.approx handles the subnormal 1e-38 (no ftz)
        float l;
        asm("lg2.approx.f32 %0, %1;\n" : "=f"(l) : "f"(fmaxf(wv[q], 1e-38f)));
        lw[q] = in ? l : 0.f;
        lc[q] = lw[q];
        rv[q] = in ? to_f32(raw.r[t][nb + q]) : 0.f;
        kv[q] = in ? to_f32(raw.k[t][nb + q]) : 0.f;
      }
    }
#pragma unroll
    for (int off = 1; off < kMaxChunk; off <<= 1) {
#pragma unroll
      for (int q = 0; q < kChan; ++q) {
        const float up = __shfl_up_sync(0xffffffffu, lc[q], off);
        if (tau >= off) lc[q] += up;
      }
    }
    float rt[kChan], kt[kChan], lce[kChan];
    float bon = 0.f;
#pragma unroll
    for (int q = 0; q < kChan; ++q) {
      const float last = __shfl_sync(0xffffffffu, lc[q], (a * L + L - 1) & 31);
      lce[q] = lc[q] - lw[q];
      rt[q] = rv[q] * clamped_exp2(lce[q]);
      kt[q] = kv[q] * clamped_exp2(last - lc[q]);
      bon += rv[q] * (sm.u[nb + q] * kv[q]);
      if (tau == 0 && a < G) st.d[a][nb + q] = clamped_exp2(last);
    }
    uint32_t rh[kChan], rl[kChan], kh[kChan], kl[kChan];
#pragma unroll
    for (int q = 0; q < kChan; ++q) {
      split_tf32(rt[q], rh[q], rl[q]);
      split_tf32(kt[q], kh[q], kl[q]);
    }
    auto put = [](float* dst, const float (&x)[kChan]) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    };
    auto put_u = [](float* dst, const uint32_t (&x)[kChan]) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
    };
    put_u(&st.rt[0][t][nb], rh);
    put_u(&st.rt[1][t][nb], rl);
    put_u(&st.kt[0][t][nb], kh);
    put_u(&st.kt[1][t][nb], kl);
    put(&sm.rf[t][nb], rv);
    put(&sm.kf[t][nb], kv);
    put(&sm.lc[t][nb], lc);
    put(&sm.lce[t][nb], lce);
    sm.bonus[warp][t] = bon;
    prep_barrier();
    // strictly causal partial scores within each chunk, over this CTA's
    // channels, one (t, s) pair a thread; the diagonal's u bonus
    const int pairs = L * (L - 1) / 2;
    for (int i = threadIdx.x; i < G * pairs; i += kPrepThreads) {
      const int c = i / pairs, j = i % pairs;
      int tt = static_cast<int>((1.f + sqrtf(1.f + 8.f * j)) * 0.5f);
      while (tt * (tt - 1) / 2 > j) --tt;
      while ((tt + 1) * tt / 2 <= j) ++tt;
      const int ts = c * L + tt, s = c * L + j - tt * (tt - 1) / 2;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kRows; n += 4) {
        const float4 rv = *reinterpret_cast<const float4*>(&sm.rf[ts][n]);
        const float4 kv = *reinterpret_cast<const float4*>(&sm.kf[s][n]);
        const float4 le = *reinterpret_cast<const float4*>(&sm.lce[ts][n]);
        const float4 lc = *reinterpret_cast<const float4*>(&sm.lc[s][n]);
        acc += rv.x * kv.x * clamped_exp2(le.x - lc.x);
        acc += rv.y * kv.y * clamped_exp2(le.y - lc.y);
        acc += rv.z * kv.z * clamped_exp2(le.z - lc.z);
        acc += rv.w * kv.w * clamped_exp2(le.w - lc.w);
      }
      store_split(st.a[0][ts][s], st.a[1][ts][s], acc);
    }
    for (int i = threadIdx.x; i < BT; i += kPrepThreads) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kPrepWarps; ++q) acc += sm.bonus[q][i];
      store_split(st.a[0][i][i], st.a[1][i][i], acc);
    }
  };

  // -- state: warp sw owns S[n0 .. n0 + kRows)[16 sw .. 16 sw + 16) -------
  const int sw = warp - kPrepWarps;
  const int g = lane / 4, tg = lane % 4;
  const int c0 = sw * kCols;                   // this warp's value columns
  float acc[kMT][2][4];                        // [m-tile][n-tile][fragment]
  float (*stw)[kPitchST] = sm.st[sw < 0 ? 0 : sw];
  float yacc[2][2][4];                         // [token m-tile][n-tile][fragment]

  auto frag_a = [](const float (*hi)[kPitchA], const float (*lo)[kPitchA],
                   int row, int col) {
    FragA f;
    const int rr[4] = {row, row + 8, row, row + 8};
    const int cc[4] = {col, col, col + 4, col + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.hi[e] = __float_as_uint(hi[rr[e]][cc[e]]);
      f.lo[e] = __float_as_uint(lo[rr[e]][cc[e]]);
    }
    return f;
  };
  // y's partial over this CTA's channels for the m-tile of chunk a that
  // starts at token r0, into ya
  auto chunk_y = [&](const Stage& st, const Raw& raw, int a, int mt,
                     float (&ya)[2][4]) {
    const int r0 = a * L + 16 * mt;
    const int s_lo = a * L, s_hi = a * L + L;
    float yc[2][2][4] = {};                    // [k-step parity][n-tile]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] = 0.f;
    // r~ S_a over this CTA's channels
#pragma unroll
    for (int ks = 0; ks < kRows / 8; ++ks) {
      const FragA fa = frag_a(st.rt[0], st.rt[1], r0 + g, 8 * ks + tg);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const FragB fb = frag_b(stw[8 * ks + tg][8 * nt + g],
                                stw[8 * ks + tg + 4][8 * nt + g]);
        mma_3xtf32<false>(ya[nt], yc[ks & 1][nt], fa, fb);
      }
    }
    // the chunk's scores times V
#pragma unroll
    for (int kk = 0; kk < kMaxChunk / 8; ++kk) {
      const int s0k = s_lo + 8 * kk;
      if (s0k >= s_hi) break;
      FragA fa;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = r0 + g + (e % 2) * 8, s = s0k + tg + (e / 2) * 4;
        const bool on = s <= tt && tt < s_hi;
        fa.hi[e] = on ? __float_as_uint(st.a[0][tt][s]) : 0u;
        fa.lo[e] = on ? __float_as_uint(st.a[1][tt][s]) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const FragB fb = frag_b(raw.v[s0k + tg][c0 + 8 * nt + g],
                                raw.v[s0k + tg + 4][c0 + 8 * nt + g]);
        mma_3xtf32<kExactV>(ya[nt], yc[kk & 1][nt], fa, fb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] += yc[0][nt][e] + yc[1][nt][e];
  };
  // S <- diag(d) S + K~^T V over chunk a's tokens (K~ and v are zero past
  // S: the padding, and TMA's fill)
  auto carry = [&](const Stage& st, const Raw& raw, int a) {
    const int s_lo = a * L, s_hi = a * L + L;
    float cc[kMT][2][4] = {};
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float d0 = st.d[a][16 * mt + g], d1 = st.d[a][16 * mt + g + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[mt][nt][0] *= d0;
        acc[mt][nt][1] *= d0;
        acc[mt][nt][2] *= d1;
        acc[mt][nt][3] *= d1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMaxChunk / 8; ++kk) {
      const int s0k = s_lo + 8 * kk;
      if (s0k >= s_hi) break;
      const int s = s0k + tg;
      FragB fb[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        fb[nt] = frag_b(raw.v[s][c0 + 8 * nt + g], raw.v[s + 4][c0 + 8 * nt + g]);
        // keys of the block's next chunk add nothing
        if (s >= s_hi) fb[nt].hi[0] = fb[nt].lo[0] = 0u;
        if (s + 4 >= s_hi) fb[nt].hi[1] = fb[nt].lo[1] = 0u;
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        FragA fa;
        const int n = 16 * mt + g;
        const int ss_[4] = {s, s, s + 4, s + 4}, nn[4] = {n, n + 8, n, n + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fa.hi[e] = __float_as_uint(st.kt[0][ss_[e]][nn[e]]);
          fa.lo[e] = __float_as_uint(st.kt[1][ss_[e]][nn[e]]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_3xtf32<kExactV>(acc[mt][nt], cc[mt][nt], fa, fb[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += cc[mt][nt][e];
  };
  // S_a as a B operand: this warp's tile through shared memory
  auto stage_state = [&]() {
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = 16 * mt + g, m = 8 * nt + 2 * tg;
        stw[n][m] = acc[mt][nt][0];
        stw[n][m + 1] = acc[mt][nt][1];
        stw[n + 8][m] = acc[mt][nt][2];
        stw[n + 8][m + 1] = acc[mt][nt][3];
      }
    __syncwarp();
  };
  // the m-tile's tokens of chunk a into the partial sums of the CTA that
  // stores this warp's columns, slot p
  auto push = [&](const float (&ya)[2][4], int p, int a, int mt, int rows) {
    const int owner = c0 / kOut;
    float* dst = cluster.map_shared_rank(&sm.ypart[p][rank][0][0], owner);
    const int s_hi = min(a * L + L, rows);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tt = a * L + 16 * mt + g + 8 * half;
      if (tt >= s_hi) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<float2*>(dst + tt * kOut + c0 % kOut + 8 * nt + 2 * tg) =
            make_float2(ya[nt][2 * half], ya[nt][2 * half + 1]);
    }
  };
  // y of block blk for this CTA's columns: the cluster's partials, slot p,
  // summed by the prep warps (which have time to spare) into `held`, one
  // float4 a thread, and stored after the next cluster arrive so that no
  // global store is in flight when it releases
  static_assert(kMaxChunk * kOut / 4 <= kPrepThreads, "one float4 a thread");
  float4 held = make_float4(0.f, 0.f, 0.f, 0.f);
  long long held_at = -1;
  auto reduce = [&](int blk) {
    const int p = blk % 3, t0 = blk * BT, rows = min(BT, S - t0);
    const int i = threadIdx.x;
    if (i >= rows * (kOut / 4)) return;
    const int tt = i / (kOut / 4), m = 4 * (i % (kOut / 4));
    held = *reinterpret_cast<const float4*>(&sm.ypart[p][0][tt][m]);
#pragma unroll
    for (int q = 1; q < kGroups; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.ypart[p][q][tt][m]);
      held.x += x.x;
      held.y += x.y;
      held.z += x.z;
      held.w += x.w;
    }
    held_at = y0 + static_cast<long long>(t0 + tt) * kN + rank * kOut + m;
  };
  auto store_held = [&]() {
    if (held_at >= 0) *reinterpret_cast<float4*>(&y[held_at]) = held;
    held_at = -1;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) mbar_init(&sm.loaded[q]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (prep) {
    if (nblocks > 0) issue(0);
    if (threadIdx.x < kRows) sm.u[threadIdx.x] = u[h * kN + n0 + threadIdx.x];
  } else {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 16 * mt + g + (e / 2) * 8;
          const int m = c0 + 8 * nt + 2 * tg + e % 2;
          acc[mt][nt][e] = s0 != nullptr ? s0[st0 + n * kN + m] : 0.f;
        }
  }
  __syncthreads();

  // Iteration i: prep takes block i, the state warps block i - 1.  The
  // state warps push each chunk's y partials into the shared memory of the
  // CTA that stores those columns (slot (i - 1) % 3), and one cluster
  // barrier phase an iteration hands them over.  Every arrive is relaxed,
  // so none waits on stores in flight: the state warps fence their last
  // iteration's pushes just before they arrive (after the block's first
  // products, when the pushes have drained), which releases them; the
  // prep warps' reads of a slot are ordered before its next write, two
  // phases later, through the CTA barrier and that same fence.
  for (int i = 0; i <= nblocks; ++i) {
    if (prep) {
      cluster_arrive_relaxed();
      store_held();
      if (i < nblocks) {
        if (i + 1 < nblocks) issue(i + 1);
        mbar_wait(&sm.loaded[i % 3], (i / 3) & 1);
        prepare(i);
      }
      cluster_wait();
      if (i >= 2) reduce(i - 2);
    } else {
      const int blk = i - 1, p = (blk + 3) % 3;
      const int rows = blk >= 0 ? min(BT, S - blk * BT) : 0;
      const Stage& st = sm.stage[blk & 1];
      const Raw& raw = sm.raw[(blk + 3) % 3];
      const int MT = (L + 15) / 16;
      if (blk >= 0) {
        mbar_wait(&sm.loaded[blk % 3], (blk / 3) & 1);
        stage_state();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < MT) chunk_y(st, raw, 0, mt, yacc[mt]);
        carry(st, raw, 0);
      }
      fence_cluster();
      cluster_arrive_relaxed();
      cluster_wait();
      if (blk >= 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < MT) push(yacc[mt], p, 0, mt, rows);
        if (G == 2 && L < rows) {
          stage_state();
          chunk_y(st, raw, 1, 0, yacc[0]);
          carry(st, raw, 1);
          push(yacc[0], p, 1, 0, rows);
        }
      }
    }
    __syncthreads();
  }
  if (prep) {
    cluster_arrive_relaxed();
    store_held();
  } else {
    fence_cluster();
    cluster_arrive_relaxed();
  }
  cluster_wait();
  if (prep) {
    if (nblocks > 0) reduce(nblocks - 1);
    store_held();
  } else {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 16 * mt + g + (e / 2) * 8;
          const int m = c0 + 8 * nt + 2 * tg + e % 2;
          s_final[st0 + n * kN + m] = acc[mt][nt][e];
        }
  }
}

template <typename T>
cudaError_t configure() {
  static cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem<T>)));
  return err;
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

// A (B, H, S, N) tensor with element strides (sb, sh, ss, 1) as a 4-D
// (channel, token, head, batch) tensor map whose box is `width` channels
// of a block's 32 tokens, unswizzled; reads past the tensor are zero.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              CUtensorMapDataType type, int elem, int width, int B, int H,
              int S, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kN),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * elem,
                                 static_cast<cuuint64_t>(sh) * elem,
                                 static_cast<cuuint64_t>(sb) * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), kMaxChunk, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* y, float* s_final, int B, int H, int S, int L,
                   long long sb, long long sh, long long ss,
                   cudaStream_t stream) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a map needs every extent > 0 and every stride > 0: an axis of size 1
  // is never stepped, so give it the packed stride
  const int rows = S > 0 ? S : 1;
  if (H == 1) sh = ss * rows;
  if (B == 1) sb = sh * H;
  const CUtensorMapDataType type = std::is_same_v<T, float>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int e = static_cast<int>(sizeof(T));
  CUtensorMap tr, tk, tv, tw;
  if (!make_map(encode, &tr, r, type, e, Smem<T>::kPitchR, B, H, rows, sb, sh,
                ss) ||
      !make_map(encode, &tk, k, type, e, Smem<T>::kPitchR, B, H, rows, sb, sh,
                ss) ||
      !make_map(encode, &tv, v, type, e, kN, B, H, rows, sb, sh, ss) ||
      !make_map(encode, &tw, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kPitchA, B,
                H, rows, sb, sh, ss))
    return cudaErrorInvalidValue;
  const dim3 grid(kGroups, H, B);
  wkv6_kernel<T><<<grid, kThreads, sizeof(Smem<T>), stream>>>(
      tr, tk, tv, tw, u, s0, y, s_final, S, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t cluster_info(int* width, int* max_clusters, int* smem) {
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wkv6_kernel<T>);
  if (err != cudaSuccess) return err;
  *width = attr.requiredClusterWidth;
  *smem = static_cast<int>(sizeof(Smem<T>));
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kGroups, 64, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = sizeof(Smem<T>);
  return cudaOccupancyMaxActiveClusters(max_clusters, wkv6_kernel<T>,
                                        &config);
}

}  // namespace

// dtype (of r, k and v): 0 = float32, 1 = bfloat16; w, u and s0 are
// float32.  N must be 64 and 1 <= chunk <= 32; r, k, v and w 16-byte
// aligned with strides that keep every row 16-byte aligned.  s0 may be
// null (zero initial state).  Returns the cudaError_t of the launch (0
// on success).
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

// The launch shape the runtime sees for dtype's kernel: the cluster
// width it requires, how many such clusters fit on the card at once, and
// the dynamic shared memory of a block.  Returns a cudaError_t.
extern "C" int repro_wkv6_cluster_info(int dtype, int* width,
                                       int* max_clusters, int* smem) {
  if (dtype == 0) return cluster_info<float>(width, max_clusters, smem);
  if (dtype == 1)
    return cluster_info<__nv_bfloat16>(width, max_clusters, smem);
  return cudaErrorInvalidValue;
}
