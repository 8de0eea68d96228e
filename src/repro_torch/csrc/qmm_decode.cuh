// Tensor-core decode loop of the packed f32 matmuls for M <= 16 (sm_90a), shared
// by csrc/qmatmul_f32.cu and csrc/qmatmul_blockscale.cu.
//
// Replaces: the decode (M <= 16) path of src/repro/kernels/qmatmul.py ::
//   qmatmul_f32 (_qmatmul_f32_kernel) and :: qmatmul_f32_blockscale
//   (_qmatmul_f32_blockscale_kernel), both with the unpack helper
//   _unpack_block.
//
// Computes what csrc/qmm_tc.cuh computes (its note has the formula): per
//   32-wide K group kb, out[m, n] = post[n] * sum_kb pre[n, kb] * sum_{k in
//   kb} x[m, k] * level[n, k]; B1 (SCALED = false) post = scale[n] after the
//   reduction, B3 (SCALED = true) pre = scales[n, kb] inside it, a ragged
//   tail group's scale covering only its tail.  k >= K is masked (x is zero
//   there), so ragged K is exact.
//
// What bounds it on this card: decode calls it with M = batch slots (4), so
//   each packed byte is used M times and the time is the packed bytes (plus
//   B3's scales) over the 3.35 TB/s of device memory.  On the CUDA cores
//   unpack plus M f32 FMAs a level outrun the SMs' issue rate at that byte
//   rate below 8 bits; in TF32 on the tensor cores the MMAs do not bind, the
//   unpack (two integer / float ops a level) and the copies do.
//
// What the design does about it:
//   - weights on the MMA's M side ("swap AB"): mma.sync.m16n8k8 TF32 with
//     the unpacked levels as A, from registers (exact in TF32), and x as the
//     8-wide B.  B's columns hold x's TF32 hi parts, then its lo parts (f32
//     x: hi = tf32_rna(x), lo = tf32_rna(x - hi)), or x itself (bf16 x,
//     exact in TF32), so M = 4 fills one 8-column MMA in one pass; hi and lo
//     are added in f32 once, at the end.  Each 32-wide group's MMAs start a
//     fresh fragment that is promoted into f32 on the CUDA cores (B3's scale
//     there), as in qmm_tc.cuh, so the tensor core's own accumulation spans
//     32 terms.  The MMA's k order is free: quad lane t holds levels 8t ..
//     8t + 7 of a group, 8 contiguous packed fields, and x's columns in the
//     same order.
//   - packed rows stream once through a 4-stage cp.async ring a warp, 16 B
//     copies, 128 B of each of the warp's 32 rows a stage (B3's scales
//     beside them; 64 B a row streamed falcon-mamba-7b's decode linears 1.3x
//     slower on an H100 SXM); each warp copies and reads only its own rows,
//     so a cp.async wait and a __syncwarp are all a stage needs.  The 16 B
//     chunks of a row are swizzled so that the quads' 8, 4 or 2 B reads hit
//     distinct banks.
//     Rows that are not 16 B aligned take 4 B copies (Kp = 100 at 8 bits)
//     or byte loads (K = 1,001) in the same kernel (ALIGNED = false).
//   - x is loaded once a block, into shared memory, with wide loads all
//     issued before any is used, and split into hi / lo there.
//   - levels unpack in two ops: the field ORed into the exponent of 2^23 (a
//     byte permute at 8 bits) and one FADD / FFMA that removes 2^23 and the
//     offset 2^(bits-1).
//   - K is split over gridDim.z (kernels/qmatmul.tc_splits) so that every SM
//     streams.  One launch a call: each split writes its slice, and the last
//     block of an N tile to arrive (a counter per tile, reset by that block)
//     adds the slices in split order and applies B1's scale, so two calls
//     give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tc.cuh"

namespace dcmm {

using tcmm::BK;

constexpr int MAX_M = 16;            // largest M the .cu files send here (decode)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 2;                // 16-row MMA tiles a warp
constexpr int WROWS = 16 * NT;       // packed rows a warp
constexpr int BN = WARPS * WROWS;    // packed rows a block: an N tile
constexpr int ROW_BYTES = 128;       // packed bytes of a row a ring stage
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 2;        // resident blocks an SM (launch bounds)
constexpr int X_WORDS = 8192;        // a block's x slice, columns x K range (or one stage's)

// The numbers kernels/qmatmul.py plans a launch with, for both loops
// (qmm_tc.cuh's and this one's), written once here and exported by each .cu:
// BM, BN, BK, MAX_M, MIN_BLOCKS, STAGES of the tensor-core loop, then this
// loop's BN, MIN_BLOCKS, X_WORDS, ROW_BYTES.
constexpr int GEOMETRY_INTS = 10;
inline void geometry(int* g) {
  const int v[GEOMETRY_INTS] = {tcmm::BM, tcmm::BN, BK,         MAX_M,   tcmm::MIN_BLOCKS,
                                tcmm::STAGES, BN,   MIN_BLOCKS, X_WORDS, ROW_BYTES};
  for (int i = 0; i < GEOMETRY_INTS; ++i) g[i] = v[i];
}

template <int BITS>
__host__ __device__ constexpr int group_bytes() { return BK * BITS / 8; }
template <int BITS>
__host__ __device__ constexpr int stage_groups() { return ROW_BYTES / group_bytes<BITS>(); }
template <int BITS, bool SCALED>
__host__ __device__ constexpr int warp_stage_bytes() {
  return WROWS * ROW_BYTES + (SCALED ? stage_groups<BITS>() * WROWS * 4 : 0);
}
template <int BITS, bool SCALED>
__host__ __device__ constexpr int ring_bytes() {
  return WARPS * STAGES * warp_stage_bytes<BITS, SCALED>();
}
// the x slice's pitch in words: K range + 4 puts the 8 rows of a quad
// phase's 16 B reads on distinct banks
__host__ __device__ constexpr int x_pitch(int kr) { return kr + 4; }
// the most x words a block stages: X_WORDS, or one ring stage's K range of
// 32 columns where that is more (M > 8 at 2 bits)
template <int BITS>
__host__ __device__ constexpr int x_words_max(int cols) {
  return X_WORDS > cols * BK * stage_groups<BITS>() ? X_WORDS : cols * BK * stage_groups<BITS>();
}
template <int BITS, bool SCALED>
__host__ __device__ constexpr int smem_max() {
  return ring_bytes<BITS, SCALED>() + (x_words_max<BITS>(32) + 4 * 32) * 4;
}
static_assert(ROW_BYTES % 16 == 0 && WROWS * (ROW_BYTES / 16) % 32 == 0,
              "a stage is whole 16 B chunks, the same number a lane");

// 16 B chunk c of a 128 B ring row r sits at chunk c ^ swz(r), so that the
// quads' 8, 4 or 2 B reads of 8 rows fall on distinct banks at every width
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) | ((r >> 2) & 1); }
static_assert(ROW_BYTES == 128, "swz() is written for 128 B rows");

// Copy stage groups [g0, g0 + stage_groups) of the warp's rows [nw, nw + 32)
// (and B3's scales) into ring slot st; rows past N and bytes past Kp are zero.
template <int BITS, bool SCALED, bool ALIGNED>
__device__ __forceinline__ void load_stage(unsigned char* st, const uint8_t* __restrict__ packed,
                                           const float* __restrict__ scales, int N, int Kp,
                                           int nblk, int nw, int g0) {
  constexpr int CH = ROW_BYTES / 16;          // chunks a row
  const int lane = threadIdx.x & 31;
  const int b0 = g0 * group_bytes<BITS>();
#pragma unroll
  for (int i = 0; i < WROWS * CH / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / CH, h = c % CH;
    const int n = nw + r, off = b0 + 16 * h;
    unsigned char* dst = st + r * ROW_BYTES + 16 * (h ^ swz(r));
    if constexpr (ALIGNED) {
      // rows 16 B aligned and Kp a multiple of 16: a chunk is all in or out
      const bool in = n < N && off < Kp;
      tcmm::cp_async<16>(dst, in ? packed + static_cast<size_t>(n) * Kp + off : packed,
                         in ? 16 : 0);
    } else if ((Kp & 3) == 0 && (reinterpret_cast<uintptr_t>(packed) & 3) == 0) {
      // rows 4 B aligned (Kp = 100 at 8 bits): four 4 B copies a chunk
      const uint8_t* src = packed + static_cast<size_t>(n) * Kp + off;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = n < N && off + 4 * e < Kp;
        tcmm::cp_async<4>(dst + 4 * e, in ? src + 4 * e : packed, in ? 4 : 0);
      }
    } else {
      const uint8_t* src = packed + static_cast<size_t>(n < N ? n : 0) * Kp;
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = (n < N && off + b < Kp) ? src[off + b] : uint8_t(0);
    }
  }
  if constexpr (SCALED) {
    float* sc = reinterpret_cast<float*>(st + WROWS * ROW_BYTES);
    const int n = nw + lane;
#pragma unroll
    for (int gg = 0; gg < stage_groups<BITS>(); ++gg) {
      const bool in = n < N && g0 + gg < nblk;
      tcmm::cp_async<4>(sc + gg * WROWS + lane,
                        in ? scales + static_cast<size_t>(n) * nblk + g0 + gg : scales,
                        in ? 4 : 0);
    }
  }
}

// Quad lane t's packed fields of group gg of ring row r: levels 8t .. 8t + 7
// of the group, 8 fields of BITS bits in .x (then .y at 8 bits)
template <int BITS>
__device__ __forceinline__ uint2 row_fields(const unsigned char* st, int r, int gg, int t) {
  const unsigned char* row = st + r * ROW_BYTES;
  const int s = swz(r);
  if constexpr (BITS == 8) {
    return *reinterpret_cast<const uint2*>(row + 16 * ((2 * gg + (t >> 1)) ^ s) + 8 * (t & 1));
  } else if constexpr (BITS == 4) {
    return make_uint2(*reinterpret_cast<const uint32_t*>(row + 16 * (gg ^ s) + 4 * t), 0u);
  } else {
    return make_uint2(
        *reinterpret_cast<const uint16_t*>(row + 16 * ((gg >> 1) ^ s) + 8 * (gg & 1) + 2 * t),
        0u);
  }
}

// Field q (0 .. 7) of w as a TF32 level, field - 2^(bits-1), exact, in two
// ops: 8 bits, byte-permute the byte under the exponent of 2^23 and subtract
// 2^23 + 128; 4 / 2 bits, OR the field in place under that exponent (value
// 2^23 + field * 2^p) and one FFMA by 2^-p with -(2^(23-p) + 2^(bits-1)).
template <int BITS>
__device__ __forceinline__ uint32_t level(uint2 w, int q) {
  if constexpr (BITS == 8) {
    const uint32_t f = __byte_perm(q < 4 ? w.x : w.y, 0x4B000000u, 0x7440 + (q & 3));
    return __float_as_uint(__uint_as_float(f) - 8388736.f);
  } else {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    int p = q * BITS;
    uint32_t word = w.x;
    if (p + BITS > 23) {                    // the field would reach the exponent
      word >>= 16;
      p -= 16;
    }
    const uint32_t f = (word & (kMask << p)) | 0x4B000000u;
    const float inv = __uint_as_float(static_cast<uint32_t>(127 - p) << 23);          // 2^-p
    const float off = __uint_as_float(static_cast<uint32_t>(150 - p) << 23)          // 2^(23-p)
                      + static_cast<float>(1 << (BITS - 1));
    return __float_as_uint(fmaf(__uint_as_float(f), inv, -off));
  }
}

// four x values from p as floats: one 16 B (f32) or 8 B (bf16) load
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16); v[1] = __uint_as_float(r.x & 0xFFFF0000u);
  v[2] = __uint_as_float(r.y << 16); v[3] = __uint_as_float(r.y & 0xFFFF0000u);
}

// Stage x rows [0, M) at k in [k0, k0 + kr) as the block's B columns: [0, M)
// hi (or bf16 x), [M, 2M) lo, the rest zero; k >= K zero.  Four k a thread
// at a time, eight such loads issued before any is used, as one wide load
// each when x's rows allow it.
template <typename T, int NC>
__device__ __forceinline__ void stage_x(uint32_t* xs, const T* __restrict__ x, int M, int K,
                                        int k0, int kr, int xp) {
  constexpr int P = tcmm::passes<T>();
  constexpr int U = 8;
  const int tid = threadIdx.x;
  const int q = kr / 4;                       // quads of k a row
  const int total = M * q;
  const bool wide =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  for (int i0 = tid; i0 < total; i0 += U * THREADS) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int m = i / q, k = k0 + 4 * (i - m * q);
      const T* src = x + static_cast<size_t>(m) * K + k;
      if (i < total && wide && k < K) {
        load4(src, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = i < total && k + e < K ? tcmm::to_f32(src[e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= total) break;
      const int m = i / q, kk = 4 * (i - m * q);
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (P == 2) {
          h[e] = tcmm::tf32_rna(v[u][e]);
          l[e] = tcmm::tf32_rna(v[u][e] - __uint_as_float(h[e]));
        } else {
          h[e] = __float_as_uint(v[u][e]);
        }
      }
      *reinterpret_cast<uint4*>(xs + m * xp + kk) = make_uint4(h[0], h[1], h[2], h[3]);
      if constexpr (P == 2)
        *reinterpret_cast<uint4*>(xs + (M + m) * xp + kk) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
  for (int i = tid; i < (8 * NC - P * M) * q; i += THREADS)
    *reinterpret_cast<uint4*>(xs + (P * M + i / q) * xp + 4 * (i % q)) = make_uint4(0, 0, 0, 0);
}

// d += a (16 x 8 levels, TF32) x b (8 x 8 of x, TF32): one warp
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The body of one block: packed rows [n0, n0 + BN) of N tile blockIdx.x over
// the K groups of split blockIdx.z, gps groups a split.  Unsplit it writes
// out (times scales[n] for B1); split, it writes its slice of part, laid out
// (split, N, M rounded up to 4), and the tile's last block to arrive adds the
// slices in split order into out.  NC 8-column MMA tiles hold the B columns
// (1, 2 or 4 of them, for hi and lo of M rows, or M bf16 rows).
template <int BITS, typename T, bool SCALED, bool ALIGNED, int NC>
__device__ __forceinline__ void decode(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                                       const float* __restrict__ scales, float* __restrict__ out,
                                       float* __restrict__ part, int* __restrict__ counters,
                                       int M, int N, int K, int Kp, int nblk, int gps) {
  constexpr int GS = stage_groups<BITS>();
  constexpr int WSB = warp_stage_bytes<BITS, SCALED>();
  constexpr int P = tcmm::passes<T>();        // x columns a row: hi and lo, or x
  constexpr int DP = 8 * NC + 1;              // pitch of the epilogue's row sums
  static_assert(STAGES * WSB >= WROWS * DP * 4, "the epilogue reuses the warp's ring");
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (K + BK - 1) / BK;
  const int gb = blockIdx.z * gps;
  const int ng = min(groups, gb + gps) - gb;
  const int nst = (ng + GS - 1) / GS;
  const int n0 = blockIdx.x * BN, nw = n0 + warp * WROWS;
  const int kr = gps * BK, xp = x_pitch(kr);
  unsigned char* ring = tcmm::smem + warp * STAGES * WSB;
  uint32_t* xs = reinterpret_cast<uint32_t*>(tcmm::smem + ring_bytes<BITS, SCALED>());
  const bool active = nw < N;                 // the warp has rows

  if (active) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst)
        load_stage<BITS, SCALED, ALIGNED>(ring + s * WSB, packed, scales, N, Kp, nblk, nw,
                                          gb + s * GS);
      tcmm::cp_commit();
    }
  }
  // the block's x slice, while the first stages are in flight
  stage_x<T, NC>(xs, x, M, K, gb * BK, kr, xp);
  __syncthreads();

  float acc[NT][NC][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][c][i] = 0.f;

  if (active) {
    for (int st = 0; st < nst; ++st) {
      const int nx = st + STAGES - 1;
      if (nx < nst)
        load_stage<BITS, SCALED, ALIGNED>(ring + (nx % STAGES) * WSB, packed, scales, N, Kp,
                                          nblk, nw, gb + nx * GS);
      tcmm::cp_commit();
      tcmm::cp_wait<STAGES - 1>();            // stage st has landed for this thread
      __syncwarp();                           // ... and for its warp
      const unsigned char* sp = ring + (st % STAGES) * WSB;
      const float* sc = reinterpret_cast<const float*>(sp + WROWS * ROW_BYTES);
#pragma unroll
      for (int gg = 0; gg < GS; ++gg) {
        const int ig = st * GS + gg;
        if (ig >= ng) break;                  // warp-uniform: the split's last stage
        // B: x columns 8c + g at k = 8t .. 8t + 7 of the group, in the
        // order the quad lanes hold the levels
        uint32_t b[NC][8];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t* src = xs + (8 * c + g) * xp + ig * BK + 8 * t;
          const uint4 lo = *reinterpret_cast<const uint4*>(src);
          const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
          b[c][0] = lo.x; b[c][1] = lo.y; b[c][2] = lo.z; b[c][3] = lo.w;
          b[c][4] = hi.x; b[c][5] = hi.y; b[c][6] = hi.z; b[c][7] = hi.w;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r0 = 16 * j + g;
          const uint2 w0 = row_fields<BITS>(sp, r0, gg, t);
          const uint2 w1 = row_fields<BITS>(sp, r0 + 8, gg, t);
          float pt[NC][4];
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i) pt[c][i] = 0.f;
          // k step s: MMA k index t is the group's k 8t + 2s, index t + 4 is
          // 8t + 2s + 1, on both operands
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t a0 = level<BITS>(w0, 2 * s), a1 = level<BITS>(w1, 2 * s);
            const uint32_t a2 = level<BITS>(w0, 2 * s + 1), a3 = level<BITS>(w1, 2 * s + 1);
#pragma unroll
            for (int c = 0; c < NC; ++c)
              mma_tf32(pt[c], a0, a1, a2, a3, b[c][2 * s], b[c][2 * s + 1]);
          }
          // promote the group's partial sums: rows r0 (d0, d1) and r0 + 8 (d2, d3)
          if constexpr (SCALED) {
            const float s0 = sc[gg * WROWS + r0], s1 = sc[gg * WROWS + r0 + 8];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[j][c][0] = fmaf(s0, pt[c][0], acc[j][c][0]);
              acc[j][c][1] = fmaf(s0, pt[c][1], acc[j][c][1]);
              acc[j][c][2] = fmaf(s1, pt[c][2], acc[j][c][2]);
              acc[j][c][3] = fmaf(s1, pt[c][3], acc[j][c][3]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[j][c][i] += pt[c][i];
          }
        }
      }
      __syncwarp();                           // slot st is read before it is refilled
    }
  }
  tcmm::cp_wait<0>();
  __syncwarp();

  // each lane gathers one row's columns through the warp's ring, then adds
  // hi and lo in f32
  float* dw = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int r0 = 16 * j + g, col = 8 * c + 2 * t;
      dw[r0 * DP + col] = acc[j][c][0];
      dw[r0 * DP + col + 1] = acc[j][c][1];
      dw[(r0 + 8) * DP + col] = acc[j][c][2];
      dw[(r0 + 8) * DP + col + 1] = acc[j][c][3];
    }
  __syncwarp();
  const float* row = dw + lane * DP;
  const int n = nw + lane;
  auto sum = [&](int m) { return P == 2 ? row[m] + row[M + m] : row[m]; };

  if (gridDim.z == 1) {
    if (n < N) {
      const float post = SCALED ? 1.f : scales[n];
      for (int m = 0; m < M; ++m) out[static_cast<size_t>(m) * N + n] = sum(m) * post;
    }
    return;
  }

  const int mp = (M + 3) & ~3;
  if (n < N) {
    float* dst = part + (static_cast<size_t>(blockIdx.z) * N + n) * mp;
    for (int q = 0; q < mp; q += 4) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = q + i < M ? sum(q + i) : 0.f;
      *reinterpret_cast<float4*>(dst + q) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // the last block of the tile to arrive adds the slices (threadFenceReduction)
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.x, 1) == static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int splits = gridDim.z;
  const int nn = n0 + tid;                    // one row a thread
  if (nn < N) {
    const float post = SCALED ? 1.f : scales[nn];
    const size_t zs = static_cast<size_t>(N) * mp;
    const float* src = part + static_cast<size_t>(nn) * mp;
    for (int q = 0; q < mp; q += 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      int z = 0;
      for (; z + 8 <= splits; z += 8) {       // eight loads in flight, added in order
        float4 p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          p[u] = __ldcg(reinterpret_cast<const float4*>(src + (z + u) * zs + q));
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s.x += p[u].x; s.y += p[u].y; s.z += p[u].z; s.w += p[u].w;
        }
      }
      for (; z < splits; ++z) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(src + z * zs + q));
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q + i < M) out[static_cast<size_t>(q + i) * N + nn] = v[i] * post;
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next launch
}

// Launch Kernel (a __global__ wrapping decode() with NC column tiles) over
// ``experts`` problems of one shape along gridDim.y (a grouped Kernel hands
// each block its expert's pointers).  part is the (experts, splits, N, M
// rounded up to 4) f32 scratch and counters one zeroed int a tile and expert
// (both unused when splits == 1).  The K range a split is rounded up to
// whole ring stages; the splits launched are those that own a group, no
// more than asked for.
template <auto Kernel, int BITS, typename T, bool SCALED, int NC>
cudaError_t launch(const T* x, const uint8_t* packed, const float* scales, float* out,
                   float* part, int* counters, int M, int N, int K, int Kp, int nblk,
                   int splits, cudaStream_t stream, int experts = 1) {
  constexpr int kSmemMax = smem_max<BITS, SCALED>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return attr;
  if (splits < 1 || M > MAX_M || experts < 1 || experts > 65535) return cudaErrorInvalidValue;
  constexpr int GS = stage_groups<BITS>();
  const int groups = (K + BK - 1) / BK;
  const int gps = ((groups + splits - 1) / splits + GS - 1) / GS * GS;
  const int z = (groups + gps - 1) / gps;
  const int kr = gps * BK;
  if (8 * NC * kr > x_words_max<BITS>(8 * NC) || (z > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int smem = ring_bytes<BITS, SCALED>() + 8 * NC * x_pitch(kr) * 4;
  const dim3 grid((N + BN - 1) / BN, experts, z);
  Kernel<<<grid, THREADS, smem, stream>>>(x, packed, scales, out, part, counters, M, N, K, Kp,
                                          nblk, gps);
  return cudaGetLastError();
}

// Expert e's operands of a grouped launch (csrc/qmatmul_f32.cu and
// csrc/qmatmul_blockscale.cu: the MoE experts; E = 1 is the plain 2-D
// call): x (E, M, K), packed (E, N, Kp), scales of scale_stride floats an
// expert (B1's (E, N), B3's (E, N, nblk)), out (E, M, N), and the split
// scratch, part (E, splits, ...) of part_stride floats an expert, counters
// (E, tiles).
template <typename T>
struct Expert {
  const T* x;
  const uint8_t* packed;
  const float* scale;
  float* out;
  float* part;
  int* counters;
  __device__ __forceinline__ Expert(const T* x0, const uint8_t* w0, const float* s0, float* o0,
                                    float* p0, int* c0, size_t e, int M, int N, int K, int Kp,
                                    size_t scale_stride, size_t part_stride, int tiles)
      : x(x0 + e * M * K),
        packed(w0 + e * N * Kp),
        scale(s0 + e * scale_stride),
        out(o0 + e * M * N),
        part(p0 == nullptr ? p0 : p0 + e * part_stride),
        counters(c0 == nullptr ? c0 : c0 + e * tiles) {}
};

}  // namespace dcmm
