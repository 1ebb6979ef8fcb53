// One-token grouped-query attention against a KV cache (decode), for
// Hopper (sm_90a): split-KV ("flash-decoding").
//
// Replaces no TPU kernel.  The JAX package computes decode attention in
// plain jnp (src/repro/models/layers.py, decode_gqa_attention, under the
// profiling scope "pallas:flash_decode"): no pallas_call.  It is K4
// because the port's plain version of the same function (kernels/ref.py,
// decode_attention_ref) casts the whole (B, Sc, KV, D) cache to float32,
// masks and softmaxes a (B, KV, G, 1, Sc) score tensor and permutes V,
// about 20 launches and several passes over the cache a layer, where one
// read of the valid positions is all the function needs.
//
// What it computes, per slot b and query head h (group of KV head kh):
//     o = softmax_s(cap(q . k_s / sqrt(D))) v_s   over the valid slots s,
// cap(x) = c tanh(x / c) with a softcap c, else x.  The cache is a ring:
// slot s holds position pos - ((pos - s) mod Sc), valid when it lies in
// [0, pos], which is the slots [0, min(pos + 1, Sc)) -- the ring's and the
// linear cache's masks agree for every integer pos.  pos is read on the
// device, one per slot (or one for all): no host sync.
//
// Bound on this card (H100 SXM, 3.35e12 B/s of device memory, 989e12
// bf16 tensor-core FLOP/s):
//     bytes(valid K and V rows, q, o) / 3.35e12 s
// = (2 * sum_b min(pos_b + 1, Sc) * KV * D * 2 + 2 * B * H * D * 2) / 3.35e12
// against 4 * D operations a valid position and query head: G = H / KV
// operations a byte (at most 16), far below the card's ~295, so the bytes
// bound it.  The design reads each valid byte once.
//
// Design.
//   * bfloat16 q and cache: flash_decode_split_tc, then
//     flash_decode_merge.  Grid (splits, KV, B): one block per slot, KV
//     head and split of the cache's positions.  The G query heads of the
//     group are the rows of one mma tile, so each K/V tile is read once
//     for the whole group.  splits comes from the shapes alone (the
//     wrapper: enough blocks for the card's SMs at B * KV, at most one
//     split a tile).  A block reads pos[b], intersects its split with the
//     valid slots and exits at once where that is empty, so a short slot
//     costs its own positions only.
//   * Tiles of T positions (T * D = 8192: T = 128, 64, 32 for D = 64,
//     128, 256) of K and V arrive by cp.async (16 B a thread, rows past
//     the split filled with zeros) into two stages, the next tile in
//     flight while the block works on this one.  S = Q K^T is mma.sync
//     m16n8k16 (bf16 operands, fp32 sums: the reference's
//     preferred_element_type=float32), rows = the group's heads padded to
//     16, each warp a quarter of the tile's positions; the scores go to
//     shared memory with the scale, the softcap (tanhf, fp32) and the
//     mask.  The online softmax (running max and sum, fp32, expf) runs on
//     8 threads a row.  O += P V is mma.sync m16n8k8 in TF32 with P split
//     into two TF32 terms (hi + lo, about 21 bits: P stays float32, where
//     the reference rounds it to bf16) and V exact (a bf16 value is a
//     TF32 value), each warp a quarter of D.  Shared-memory pitches (D + 8
//     bf16, T + 4 floats) keep every fragment load free of bank
//     conflicts.
//   * flash_decode_merge: one block per (slot, head) reads the splits'
//     max and sum into shared memory, rescales their accumulators to the
//     largest max, in fp32, and writes o in bf16.  Splits that held no
//     valid slot wrote sum 0 and are skipped.
//   * float32 q (flash_decode_f32; the float32 models keep a bf16 or
//     float32 cache): the products on the CUDA cores in fp32, one block a
//     slot and KV head over all its valid slots, twice -- the rows' max
//     and sum, then each probability normalised and rounded to the
//     cache's dtype before P V, as the plain version rounds it: the
//     float32 models are held token for token against the CPU's plain
//     version.  Only small models take it.
//   Two launches a call (one for float32 q).  Left for later: a
//   persistent grid balancing slots of unequal length, fp8 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // query rows of a block: G <= 16, padded
constexpr int kTileF32 = 32;   // positions a tile of the float32 kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !full (nothing is read from src then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b: m16n8k16, bf16 operands, fp32 sums.  a: (row g, cols 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); b: (k 2t..2t+1, col g),
// (k 2t + 8.., g); d: (g, 2t..2t+1), (g + 8, 2t..2t+1), with g = lane / 4
// and t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8 in TF32.  a: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b: (k t, col g), (k t + 4, g); d as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, both TF32 (hi rounded to nearest, lo the rounded rest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

struct Range {
  int begin, end;  // the split's valid slots [begin, end); empty if >=
};

// The slots of split `split` (chunk slots each) that hold positions in
// [0, pos]: the ring's slots [0, min(pos + 1, Sc)).
__device__ __forceinline__ Range valid_range(const int64_t* pos,
                                             int pos_stride, int b, int Sc,
                                             int split, int chunk) {
  const long long p = pos[static_cast<long long>(b) * pos_stride];
  const int n = p < 0 ? 0 : (p >= Sc ? Sc : static_cast<int>(p) + 1);
  const int begin = split * chunk;
  return {begin, min(begin + chunk, n)};
}

// The online softmax over one tile of scores ps (kRows rows of T, pitch
// SLD; masked scores -inf): each row's running max m and sum l (kept
// alike by the row's 8 threads), ps overwritten by exp(s - m_new), and
// alpha[row] = exp(m_old - m_new), by which the accumulator is rescaled.
template <int T, int SLD>
__device__ __forceinline__ void softmax_tile(float* ps, float* alpha,
                                             float& m, float& l, int tid) {
  constexpr int kCols = T / 8;
  const int row = tid / 8, j = tid % 8;
  float* pr = ps + row * SLD;
  float s[kCols];
  float mt = -INFINITY;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    s[c] = pr[j + 8 * c];
    mt = fmaxf(mt, s[c]);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
  const float m_new = fmaxf(m, mt);
  // a row whose every score so far is -inf keeps p = 0, not NaN
  const float base = m_new == -INFINITY ? 0.f : m_new;
  const float a = expf(m - base);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float p = expf(s[c] - base);
    pr[j + 8 * c] = p;
    sum += p;
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  l = l * a + sum;
  m = m_new;
  if (j == 0) alpha[row] = a;
}

__device__ __forceinline__ float capped(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct Tc {
  static constexpr int T = 8192 / D;          // positions a tile
  static constexpr int LD = D + 8;            // K/V/Q row pitch, bf16
  static constexpr int SLD = T + 4;           // score row pitch, floats
  static constexpr int kQkTiles = T / (8 * kWarps);  // n8 tiles a warp
  static constexpr int kCols = D / kWarps;    // output columns a warp
  static constexpr int kPvTiles = kCols / 8;
  static constexpr int kTileElems = T * LD;   // one K or V stage
  static constexpr size_t kSmem =
      (4 * kTileElems + kRows * LD) * sizeof(__nv_bfloat16) +
      (kRows * SLD + kRows) * sizeof(float);
  static_assert(kQkTiles >= 1 && kPvTiles >= 1, "tile shapes");
};

// q: (B, 1, H, D); k, v: (B, Sc, KV, D), contiguous bf16; pos: int64 at
// pos[b * pos_stride].  Grid (splits, KV, B).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_tc(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int64_t* __restrict__ pos, int pos_stride,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int Sc, int G, int chunk, float scale, float softcap) {
  using C = Tc<D>;
  constexpr int T = C::T, LD = C::LD, SLD = C::SLD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][T][LD]
  __nv_bfloat16* vs = ks + 2 * C::kTileElems;                  // [2][T][LD]
  __nv_bfloat16* qs = vs + 2 * C::kTileElems;                  // [16][LD]
  float* ps = reinterpret_cast<float*>(qs + kRows * LD);       // [16][SLD]
  float* alpha = ps + kRows * SLD;                             // [16]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.y, H = KV * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the block's partial results: m and l of each of its G rows in two
  // planes of n_rows floats (split-major within a slot and KV head), its
  // unnormalised accumulator rows (G, D) at part_o + part * G * D
  const size_t part =
      (static_cast<size_t>(b) * KV + kh) * gridDim.x + split;
  const size_t n_rows =
      static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z * G;
  float* pm = part_ml + part * G;
  float* pl = part_ml + n_rows + part * G;
  const Range r = valid_range(pos, pos_stride, b, Sc, split, chunk);
  if (r.begin >= r.end) {
    if (tid < G) {
      pm[tid] = -INFINITY;
      pl[tid] = 0.f;
    }
    return;
  }

  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  auto load_tile = [&](int first, int stage) {
    __nv_bfloat16* kd = ks + stage * C::kTileElems;
    __nv_bfloat16* vd = vs + stage * C::kTileElems;
#pragma unroll 4
    for (int i = tid; i < T * kChunks; i += kThreads) {
      const int row = i / kChunks, c = i % kChunks;
      const int s = first + row;
      const bool in = s < r.end;
      const size_t off =
          ((static_cast<size_t>(b) * Sc + (in ? s : r.begin)) * KV + kh) * D +
          c * 8;
      cp_async16(kd + row * LD + c * 8, k + off, in);
      cp_async16(vd + row * LD + c * 8, v + off, in);
    }
  };
  load_tile(r.begin, 0);
  cp_commit();

  // the group's query rows, zero past G
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int row = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < G)
      x = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * H + kh * G + row) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + row * LD + c * 8) = x;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* q0 = qs + g * LD + kc * 16 + 2 * t;
    qa[kc][0] = ld32(q0);
    qa[kc][1] = ld32(q0 + 8 * LD);
    qa[kc][2] = ld32(q0 + 8);
    qa[kc][3] = ld32(q0 + 8 * LD + 8);
  }

  float o[C::kPvTiles][4];
#pragma unroll
  for (int j = 0; j < C::kPvTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (r.end - r.begin + T - 1) / T;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int t0 = r.begin + it * T;
    if (it + 1 < n_tiles) {
      load_tile(t0 + T, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // scores: this warp's kQkTiles n8 tiles of positions
    const __nv_bfloat16* kt = ks + st * C::kTileElems;
#pragma unroll
    for (int j = 0; j < C::kQkTiles; ++j) {
      const int p0 = warp * (T / kWarps) + j * 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* krow = kt + (p0 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_bf16(c, qa[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e / 2) * 8, col = p0 + 2 * t + (e % 2);
        ps[row * SLD + col] = t0 + col < r.end
                                  ? capped(c[e] * scale, softcap)
                                  : -INFINITY;
      }
    }
    __syncthreads();
    softmax_tile<T, SLD>(ps, alpha, m, l, tid);
    __syncthreads();

    // O = O * alpha + P V over this warp's columns
    const float a_lo = alpha[g], a_hi = alpha[g + 8];
#pragma unroll
    for (int j = 0; j < C::kPvTiles; ++j) {
      o[j][0] *= a_lo;
      o[j][1] *= a_lo;
      o[j][2] *= a_hi;
      o[j][3] *= a_hi;
    }
    const __nv_bfloat16* vt = vs + st * C::kTileElems;
#pragma unroll 4
    for (int k8 = 0; k8 < T / 8; ++k8) {
      const float* pr = ps + g * SLD + k8 * 8 + t;
      uint32_t hi[4], lo[4];
      split_tf32(pr[0], hi[0], lo[0]);
      split_tf32(pr[8 * SLD], hi[1], lo[1]);
      split_tf32(pr[4], hi[2], lo[2]);
      split_tf32(pr[8 * SLD + 4], hi[3], lo[3]);
      const __nv_bfloat16* vr = vt + (k8 * 8 + t) * LD + warp * C::kCols + g;
#pragma unroll
      for (int j = 0; j < C::kPvTiles; ++j) {
        const uint32_t bv[2] = {__float_as_uint(to_f32(vr[j * 8])),
                                __float_as_uint(to_f32(vr[4 * LD + j * 8]))};
        mma_tf32(o[j], lo, bv);
        mma_tf32(o[j], hi, bv);
      }
    }
    __syncthreads();  // the stage and the scores are free again
  }

  float* po = part_o + part * G * D;
#pragma unroll
  for (int j = 0; j < C::kPvTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e / 2) * 8;
      if (row < G)
        po[row * D + warp * C::kCols + j * 8 + 2 * t + (e % 2)] = o[j][e];
    }
  if (tid % 8 == 0 && tid / 8 < G) {
    pm[tid / 8] = m;
    pl[tid / 8] = l;
  }
}

// ---------------------------------------------------------------------------
// float32 q: the CUDA cores, in the plain version's rounding
// ---------------------------------------------------------------------------

// q: (B, 1, H, D) float32; k, v: (B, Sc, KV, D) of TKV; out: (B, 1, H, D)
// of TKV.  Grid (1, KV, B): a block takes all of its slot's valid
// positions, twice -- first the rows' max and sum, then each probability
// normalised and rounded to TKV (as the plain version's
// softmax(s).to(v.dtype)) times v, summed in fp32 and rounded to TKV.
template <int D, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_decode_f32(const float* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const int64_t* __restrict__ pos,
                 int pos_stride, TKV* __restrict__ out, int Sc, int G,
                 float scale, float softcap) {
  constexpr int T = kTileF32, SLD = T + 4;
  constexpr int kPer = kRows * D / kThreads;  // accumulators a thread
  __shared__ float qs[kRows][D];
  __shared__ float ps[kRows * SLD];
  __shared__ float alpha[kRows];
  __shared__ float stats[2][kRows];

  const int kh = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.y, H = KV * G;
  const int tid = threadIdx.x;
  const Range r = valid_range(pos, pos_stride, b, Sc, 0, Sc);
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, d = i % D;
    qs[row][d] =
        row < G ? q[(static_cast<size_t>(b) * H + kh * G + row) * D + d] : 0.f;
  }
  __syncthreads();

  auto row_of = [&](int s) {  // the cache row of slot s
    return ((static_cast<size_t>(b) * Sc + s) * KV + kh) * D;
  };
  // the tile's scores into ps, -inf past its n slots
  auto scores = [&](int t0, int n) {
    for (int e = tid; e < kRows * T; e += kThreads) {
      const int row = e / T, col = e % T;
      float s = -INFINITY;
      if (col < n) {
        float dot = 0.f;
        if (row < G) {
          const TKV* kr = k + row_of(t0 + col);
#pragma unroll 8
          for (int d = 0; d < D; ++d)
            dot = fmaf(qs[row][d], to_f32(kr[d]), dot);
        }
        s = capped(dot * scale, softcap);
      }
      ps[row * SLD + col] = s;
    }
  };
  float m = -INFINITY, l = 0.f;
  for (int t0 = r.begin; t0 < r.end; t0 += T) {
    scores(t0, min(T, r.end - t0));
    __syncthreads();
    softmax_tile<T, SLD>(ps, alpha, m, l, tid);
    __syncthreads();
  }
  if (tid % 8 == 0) {
    stats[0][tid / 8] = m;
    stats[1][tid / 8] = l;
  }
  __syncthreads();
  float o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  for (int t0 = r.begin; t0 < r.end; t0 += T) {
    const int n = min(T, r.end - t0);
    scores(t0, n);
    __syncthreads();
    for (int e = tid; e < kRows * T; e += kThreads) {
      const int row = e / T;
      float& p = ps[row * SLD + e % T];
      p = to_f32(from_f32<TKV>(expf(p - stats[0][row]) / stats[1][row]));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads, row = e / D, col = e % D;
      if (row < G)
        for (int p = 0; p < n; ++p)
          o[i] = fmaf(ps[row * SLD + p], to_f32(v[row_of(t0 + p) + col]),
                      o[i]);
    }
    __syncthreads();
  }
  // no valid slot at all (pos < 0): NaN, as the plain version's softmax of
  // a row of -inf
  const float none = r.begin < r.end ? 0.f : __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads, row = e / D;
    if (row < G)
      out[(static_cast<size_t>(b) * H + kh * G + row) * D + e % D] =
          from_f32<TKV>(o[i] + none);
  }
}

// ---------------------------------------------------------------------------
// the splits merged
// ---------------------------------------------------------------------------

// out: (B, 1, H, D) bf16.  Grid (H, B), D threads, 2 * splits floats of
// dynamic shared memory: the splits' m and l, read once by the block.
__global__ void flash_decode_merge(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   __nv_bfloat16* __restrict__ out, int KV,
                                   int G, int splits, size_t n_rows) {
  extern __shared__ float stats[];  // [splits] m, then [splits] l
  float* ls = stats + splits;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, D = blockDim.x;
  const int kh = h / G, row = h % G;
  const size_t first = (static_cast<size_t>(b) * KV + kh) * splits;
  for (int s = d; s < splits; s += D) {
    const size_t i = (first + s) * G + row;
    stats[s] = part_ml[i];
    ls[s] = part_ml[n_rows + i];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    if (ls[s] > 0.f) m = fmaxf(m, stats[s]);
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    // an empty split wrote no accumulator: its garbage is read, not used
    const float x = part_o[((first + s) * G + row) * D + d];
    if (ls[s] > 0.f) {
      const float w = expf(stats[s] - m);
      l += ls[s] * w;
      acc += x * w;
    }
  }
  // no valid slot at all (pos < 0): 0 / 0, as the plain version's softmax
  // of a row of -inf
  out[(static_cast<size_t>(b) * gridDim.x + h) * D + d] =
      __float2bfloat16(acc / l);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int64_t* pos, int pos_stride, float* part_o,
                      float* part_ml, int B, int Sc, int KV, int G,
                      int splits, int chunk, float scale, float softcap,
                      cudaStream_t stream) {
  using C = Tc<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_split_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  flash_decode_split_tc<D><<<dim3(splits, KV, B), kThreads, C::kSmem,
                             stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, pos_stride, part_o, part_ml,
      Sc, G, chunk, scale, softcap);
  return cudaGetLastError();
}

template <int D, typename TKV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int64_t* pos, int pos_stride, void* out, int B,
                       int Sc, int KV, int G, float softcap,
                       cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_decode_f32<D, TKV><<<dim3(1, KV, B), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), pos, pos_stride, static_cast<TKV*>(out), Sc,
      G, scale, softcap);
  return cudaGetLastError();
}

// bf16 q and cache: the splits on the tensor cores, then their merge;
// float32 q: one launch of the float32 kernel
template <int D>
cudaError_t launch_decode(bool tc, int kv_dtype, const void* q, const void* k,
                          const void* v, const int64_t* pos, int pos_stride,
                          float* part_o, float* part_ml, void* out, int B,
                          int Sc, int H, int KV, int splits, int chunk,
                          float softcap, cudaStream_t stream) {
  const int G = H / KV;
  if (!tc && kv_dtype == 0)
    return launch_f32<D, float>(q, k, v, pos, pos_stride, out, B, Sc, KV, G,
                                softcap, stream);
  if (!tc)
    return launch_f32<D, __nv_bfloat16>(q, k, v, pos, pos_stride, out, B, Sc,
                                        KV, G, softcap, stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaError_t err = launch_tc<D>(q, k, v, pos, pos_stride, part_o, part_ml, B,
                                 Sc, KV, G, splits, chunk, scale, softcap,
                                 stream);
  if (err != cudaSuccess) return err;
  const size_t n_rows = static_cast<size_t>(B) * KV * splits * G;
  const size_t smem = 2 * static_cast<size_t>(splits) * sizeof(float);
  flash_decode_merge<<<dim3(H, B), D, smem, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(out), KV, G, splits,
      n_rows);
  return cudaGetLastError();
}

}  // namespace

// q: (B, 1, H, D); k, v: (B, Sc, KV, D), contiguous, q 16-byte aligned
// and k, v too for bf16; pos: int64 on the device, slot b's at
// pos[b * pos_stride] (pos_stride 0: one for all); out: (B, 1, H, D) of
// the cache's dtype.  For bf16 q (the tensor cores), part_o holds
// B * KV * splits * G * D floats and part_ml twice B * KV * splits * G;
// split i takes the slots [i * chunk, (i + 1) * chunk), so
// splits * chunk >= Sc, and splits is at most 4096 (the merge holds their
// statistics in shared memory).  float32 q takes neither scratch nor
// splits (null, 1, Sc).  softcap <= 0: none.  Launches on `stream` (two
// for bf16, one for float32 q); returns the first cudaError_t that is not
// cudaSuccess (0 on success).
extern "C" int repro_flash_decode_fwd(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      int pos_stride, void* part_o,
                                      void* part_ml, void* out, int B, int Sc,
                                      int H, int KV, int D, int q_dtype,
                                      int kv_dtype, int splits, int chunk,
                                      float softcap, void* stream) {
  // dtypes: 0 = float32, 1 = bfloat16.  bf16 q with a bf16 cache runs on
  // the tensor cores, float32 q with either cache dtype on the CUDA cores
  const bool tc = q_dtype == 1;
  if ((D != 64 && D != 128 && D != 256) ||
      (kv_dtype != 0 && kv_dtype != 1) ||
      (q_dtype != 0 && !(tc && kv_dtype == 1)) || B <= 0 || Sc <= 0 ||
      KV <= 0 || H % KV != 0 || H / KV > kRows || B > 65535 || KV > 65535 ||
      H > 65535 || splits <= 0 || splits > 4096 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk < Sc || pos_stride < 0 || (tc && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(pos);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (D == 64)
    return launch_decode<64>(tc, kv_dtype, q, k, v, p, pos_stride, po, pml,
                             out, B, Sc, H, KV, splits, chunk, softcap, st);
  if (D == 128)
    return launch_decode<128>(tc, kv_dtype, q, k, v, p, pos_stride, po, pml,
                              out, B, Sc, H, KV, splits, chunk, softcap, st);
  return launch_decode<256>(tc, kv_dtype, q, k, v, p, pos_stride, po, pml,
                            out, B, Sc, H, KV, splits, chunk, softcap, st);
}
