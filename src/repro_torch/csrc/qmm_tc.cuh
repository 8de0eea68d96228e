// Tensor-core main loop of the packed f32 matmuls for M > 16 (sm_90a), shared
// by csrc/qmatmul_f32.cu and csrc/qmatmul_blockscale.cu; M <= 16 (decode)
// takes csrc/qmm_decode.cuh, which uses this header's copy helpers.
//
// Replaces: the prefill (M > 16) path of src/repro/kernels/qmatmul.py ::
//   qmatmul_f32 (_qmatmul_f32_kernel) and :: qmatmul_f32_blockscale
//   (_qmatmul_f32_blockscale_kernel), both with the unpack helper
//   _unpack_block.
//
// Computes, per 32-wide K group kb,
//   out[m, n] = post[n] * sum_kb pre[n, kb] * sum_{k in kb} x[m, k] * level[n, k]
//   with level = field(packed[n, k / f], k % f) - 2^(bits-1), f = 8 / bits,
//   fields little-endian within the byte.  B1 (SCALED = false): pre = 1 and
//   post = scale[n], the per-channel scale after the reduction.  B3 (SCALED =
//   true): pre = scales[n, kb], one per (row, 32-block), inside the reduction,
//   and post = 1.  A ragged tail group's scale covers only its tail.
//
// What bounds it on this card: at the serves' prefill shapes (M = 256 and up)
//   the multiply-adds; in f32 on the CUDA cores their ceiling is 67 TFLOP/s,
//   on the tensor cores in TF32 495 TFLOP/s, but TF32 keeps 10 mantissa bits
//   and one pass misses the 1e-4 tolerance about tenfold at K = 3,072.
//
// What the design does about it:
//   - f32 accuracy from two TF32 passes: each x is split into hi =
//     tf32_rna(x) and lo = tf32_rna(x - hi); the levels (|level| <= 128) are
//     exact in TF32, so hi * level + lo * level keeps x to 22 bits.  bf16 x is
//     exact in TF32 and takes one pass.  Each 32-wide group's MMAs accumulate
//     in a fresh fragment that is then promoted on the CUDA cores, acc +=
//     pre * part, so the tensor core's own accumulation (which does not
//     round to nearest) spans 32 terms only, and B3's scale costs one FMA a
//     group instead of one multiply a level.
//   - Hopper's warpgroup MMA: a block is one warpgroup and its 64 x 128 tile
//     one wgmma.m64n128k8 per k step and pass, A (the split x) from
//     registers, B (the levels) from shared memory.  Each x is split by the
//     one thread whose A fragment holds it; each packed byte is unpacked
//     once for the block, one row a thread, into a TF32 level tile laid out
//     for wgmma (K-major rows of 128 B, 128 B swizzle).
//   - x tiles (as stored, f32 or bf16), the packed bytes (not expanded
//     levels) and B3's scales go through a 4-stage cp.async ring.  While a
//     group's wgmmas run, the block copies the group three ahead, unpacks
//     the next group's levels into a second level tile and splits its x
//     into a second set of A fragments; one barrier a group.  Each warp
//     copies the x rows it multiplies and each thread the packed row it
//     unpacks, so a __syncwarp after the thread's own cp.async wait is all
//     the next group needs.  Two blocks share an SM, so one block's
//     promotion and barrier overlap the other's wgmmas.  Rows that are not
//     16 B aligned (K = 1,001, or Kp = 100 at 8 bits) take plain loads in the
//     same kernel (ALIGNED = false).
//   - Few output tiles (x_proj's N = 288, N = 1,024 at M = 256) would leave
//     most SMs idle: the wrapper then splits K over gridDim.z, each split
//     writes its own partial slice, and a second kernel adds the slices in a
//     fixed order, so every call gives the same bits (no atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tcmm {

constexpr int BM = 64, BN = 128;       // block tile: one m64n128 wgmma
constexpr int BK = 32;                 // K a stage: one scale group
constexpr int THREADS = 128;           // one warpgroup
constexpr int ACC = BM * BN / THREADS; // f32 accumulators a thread
constexpr int STAGES = 4;
constexpr int MIN_BLOCKS = 2;          // resident blocks an SM (launch bounds)
// (kernels/qmatmul.py reads these through dcmm::geometry, csrc/qmm_decode.cuh)

// x rows in shared memory, padded so that the warps' scalar fragment loads
// (rows g, columns 8s + t of quad lane (g, t)) hit 32 distinct banks: 36
// words for f32, 20 for bf16; both keep rows on 16 B for cp.async
template <typename T>
__host__ __device__ constexpr int x_pitch() { return sizeof(T) == 4 ? BK + 4 : BK + 8; }

template <int BITS, typename T, bool SCALED>
__host__ __device__ constexpr int stage_bytes() {
  return BM * x_pitch<T>() * static_cast<int>(sizeof(T)) + BN * (BK * BITS / 8)
         + (SCALED ? BN * 4 : 0);
}

// TF32 passes over x: hi and lo for f32, one for bf16 (exact in TF32)
template <typename T>
__host__ __device__ constexpr int passes() { return sizeof(T) == 4 ? 2 : 1; }

// A group's levels as TF32, the wgmma B operand: BN K-major rows of 128 B
// (32 levels) with the 128 B swizzle, on a 1,024 B boundary; two of them,
// one read by the running wgmmas while the next is unpacked.
constexpr int LEVEL_TILE_BYTES = BN * BK * 4;

template <int BITS, typename T, bool SCALED>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + 2 * LEVEL_TILE_BYTES + STAGES * stage_bytes<BITS, T, SCALED>();
}

extern __shared__ __align__(16) unsigned char smem[];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES from global to shared, of which the first src_bytes are read and
// the rest zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Stage group g of the block's x rows [m0, m0 + BM), packed rows [n0, n0 + BN)
// and (B3) their scales; everything past M, N, K or Kp is zero.  Each warp
// copies the 16 x rows it multiplies and each thread the packed row it
// unpacks, so that once a thread has waited for its copies, a __syncwarp
// makes a group's x and levels ready for their readers without a block
// barrier.
template <int BITS, typename T, bool SCALED, bool ALIGNED>
__device__ __forceinline__ void load_stage(unsigned char* st, const T* __restrict__ x,
                                           const uint8_t* __restrict__ packed,
                                           const float* __restrict__ scales, int M, int N,
                                           int K, int Kp, int nblk, int m0, int n0, int g) {
  constexpr int XP = x_pitch<T>();
  constexpr int WB = BK * BITS / 8;          // packed bytes a row a group
  static_assert(BN == THREADS && BM == 16 * (THREADS / 32), "row ownership");
  T* xs = reinterpret_cast<T*>(st);
  uint8_t* ws = st + BM * XP * sizeof(T);
  float* ss = reinterpret_cast<float*>(ws + BN * WB);
  const int tid = threadIdx.x, lane = tid & 31, r0 = 16 * (tid >> 5);
  const int k0 = g * BK, b0 = g * WB;
  const int n = n0 + tid;
  const uint8_t* wrow = packed + static_cast<size_t>(n) * Kp + b0;
  uint8_t* wdst = ws + tid * WB;
  if constexpr (ALIGNED) {
    // rows are 16 B aligned and K, Kp multiples of a chunk: a chunk is all
    // inside or all outside
    constexpr int XC = 16 / sizeof(T), XCH = BK / XC;
    for (int c = lane; c < 16 * XCH; c += 32) {
      const int r = r0 + c / XCH, kc = (c % XCH) * XC;
      const int m = m0 + r, k = k0 + kc;
      const bool in = m < M && k < K;
      cp_async<16>(xs + r * XP + kc, in ? x + static_cast<size_t>(m) * K + k : x,
                   in ? 16 : 0);
    }
    constexpr int WC = WB < 16 ? WB : 16;
#pragma unroll
    for (int bc = 0; bc < WB; bc += WC) {
      const bool in = n < N && b0 + bc < Kp;
      cp_async<WC>(wdst + bc, in ? wrow + bc : packed, in ? WC : 0);
    }
  } else {
    using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
    const Bits* xb = reinterpret_cast<const Bits*>(x);
    Bits* xd = reinterpret_cast<Bits*>(xs);
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = r0 + i / BK, kk = i % BK;
      const int m = m0 + r, k = k0 + kk;
      xd[r * XP + kk] = (m < M && k < K) ? xb[static_cast<size_t>(m) * K + k] : Bits(0);
    }
    for (int bb = 0; bb < WB; ++bb)
      wdst[bb] = (n < N && b0 + bb < Kp) ? wrow[bb] : uint8_t(0);
  }
  if constexpr (SCALED) {
    const bool in = n < N;
    cp_async<4>(ss + tid, in ? scales + static_cast<size_t>(n) * nblk + g : scales,
                in ? 4 : 0);
  }
}

// Level k (0 .. 31) of a row whose group bytes are the BITS words w, as TF32
// bits: 2^23 + field as float bits, minus 2^23 + 2^(bits-1), is exact.
template <int BITS>
__device__ __forceinline__ uint32_t level_tf32(const uint32_t (&w)[BITS], int k) {
  constexpr float kBias = 8388608.f + static_cast<float>(1 << (BITS - 1));
  const uint32_t word = w[(k * BITS) >> 5];
  const int sh = (k * BITS) & 31;
  uint32_t f;
  if constexpr (BITS == 8)
    f = __byte_perm(word, 0x4B000000u, 0x7440 + (sh >> 3));
  else
    f = 0x4B000000u | ((word >> sh) & ((1u << BITS) - 1u));
  return __float_as_uint(__uint_as_float(f) - kBias);
}

// Unpack one landed stage's packed bytes into the level tile, one row a
// thread, each byte once for the block: 16 B chunk c of row n (levels 4c ..
// 4c + 3) goes to chunk c ^ (n % 8), the 128 B swizzle, so that the eight
// stores of a phase hit distinct banks and wgmma reads the tile as laid out.
template <int BITS>
__device__ __forceinline__ void stage_levels(const uint8_t* ws, unsigned char* lt) {
  static_assert(BN == THREADS, "one level row a thread");
  constexpr int WB = BK * BITS / 8;
  const int n = threadIdx.x;
  uint32_t w[BITS];
  const uint8_t* row = ws + n * WB;
  if constexpr (BITS == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(row);
    const uint4 b = *reinterpret_cast<const uint4*>(row + 16);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (BITS == 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(row);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(row);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int c = 0; c < BK / 4; ++c)
    *reinterpret_cast<uint4*>(lt + n * 128 + ((c ^ (n & 7)) << 4)) =
        make_uint4(level_tf32<BITS>(w, 4 * c), level_tf32<BITS>(w, 4 * c + 1),
                   level_tf32<BITS>(w, 4 * c + 2), level_tf32<BITS>(w, 4 * c + 3));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// wgmma B descriptor of the level tile at shared address addr (plus 32 B a
// k step): K-major, 128 B swizzle, 8-row groups 1,024 B apart
__device__ __forceinline__ uint64_t level_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous MMAs' issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// d (+)= a (64 x 8 TF32, registers) x levels (8 x 128, shared), one
// warpgroup; accumulate = 0 starts a fresh sum
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
}
static_assert(ACC == 64, "wgmma_tf32 is written for m64n128");

// Warp w's A fragments of one landed stage: rows 16w .. 16w + 15, quad lane
// (g, t) holding rows g, g + 8 at columns t, t + 4 of each k step, split
// into hi / lo (f32) or taken as they are (bf16); each x is split by exactly
// one thread.  a is [k step][pass][a0 .. a3].
template <typename T>
__device__ __forceinline__ void x_fragments(const unsigned char* st,
                                            uint32_t (&a)[4 * passes<T>() * 4]) {
  constexpr int XP = x_pitch<T>();
  constexpr int P = passes<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* r0 = reinterpret_cast<const T*>(st) + (16 * warp + (lane >> 2)) * XP + (lane & 3);
  const T* r1 = r0 + 8 * XP;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float v[4] = {to_f32(r0[8 * s]), to_f32(r1[8 * s]), to_f32(r0[8 * s + 4]),
                        to_f32(r1[8 * s + 4])};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (P == 2) {
        const uint32_t hi = tf32_rna(v[q]);
        a[(s * P) * 4 + q] = hi;
        a[(s * P + 1) * 4 + q] = tf32_rna(v[q] - __uint_as_float(hi));
      } else {
        a[s * 4 + q] = __float_as_uint(v[q]);
      }
    }
  }
}

// Issue one group's wgmmas (4 k steps x passes, m64n128k8 each) into a fresh
// partial sum; they run while the block stages the next group.
template <typename T>
__device__ __forceinline__ void issue_group(float (&part)[ACC],
                                            uint32_t (&a)[4 * passes<T>() * 4], uint32_t lt) {
  constexpr int P = passes<T>();
  fence_regs(part);
  fence_regs(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t* f = a + (s * P + p) * 4;
      wgmma_tf32(part, f[0], f[1], f[2], f[3], level_desc(lt + 32 * s), s | p);
    }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait for the group's wgmmas, then promote its partial sum into acc on the
// CUDA cores (times the group's scales for B3, which the stage holds).
template <int BITS, typename T, bool SCALED>
__device__ __forceinline__ void promote_group(const unsigned char* st, float (&part)[ACC],
                                              uint32_t (&a)[4 * passes<T>() * 4],
                                              float (&acc)[ACC]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(part);
  fence_regs(a);
  const float* ss = reinterpret_cast<const float*>(st + BM * x_pitch<T>() * sizeof(T)
                                                   + BN * (BK * BITS / 8));
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    if constexpr (SCALED) {
      const float2 sc = *reinterpret_cast<const float2*>(ss + 8 * i + 2 * t);
      acc[4 * i] = fmaf(sc.x, part[4 * i], acc[4 * i]);
      acc[4 * i + 1] = fmaf(sc.y, part[4 * i + 1], acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(sc.x, part[4 * i + 2], acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(sc.y, part[4 * i + 3], acc[4 * i + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[4 * i + c] += part[4 * i + c];
    }
  }
}

// Group it of the block's loop (gemm below): issue its wgmmas on level
// tile it % 2; while they run, copy group it + 3 into the ring, wait for
// group it + 1, unpack its levels into the other level tile and split its x
// into the other A fragments an; then wait, promote, and one block barrier
// (which frees ring slot it and makes the next level tile visible to the
// async proxy).  The loop alternates a and an, so no fragment is copied.
template <int BITS, typename T, bool SCALED, bool ALIGNED>
__device__ __forceinline__ void group_step(int it, int ng, unsigned char* ring, unsigned char* lt,
                                           uint32_t lt_addr, const T* __restrict__ x,
                                           const uint8_t* __restrict__ packed,
                                           const float* __restrict__ scales, int M, int N, int K,
                                           int Kp, int nblk, int m0, int n0, int gb,
                                           float (&part)[ACC],
                                           uint32_t (&a)[4 * passes<T>() * 4],
                                           uint32_t (&an)[4 * passes<T>() * 4],
                                           float (&acc)[ACC]) {
  constexpr int SB = stage_bytes<BITS, T, SCALED>();
  constexpr int XBYTES = BM * x_pitch<T>() * static_cast<int>(sizeof(T));
  issue_group<T>(part, a, lt_addr + (it & 1) * LEVEL_TILE_BYTES);
  const int nx = it + STAGES - 1;
  if (nx < ng)
    load_stage<BITS, T, SCALED, ALIGNED>(ring + (nx % STAGES) * SB, x, packed, scales, M, N, K,
                                         Kp, nblk, m0, n0, gb + nx);
  cp_commit();
  cp_wait<STAGES - 2>();      // group it + 1 has landed for this thread
  __syncwarp();               // ... and for its warp
  if (it + 1 < ng) {
    const unsigned char* nst = ring + ((it + 1) % STAGES) * SB;
    stage_levels<BITS>(nst + XBYTES, lt + ((it + 1) & 1) * LEVEL_TILE_BYTES);
    x_fragments<T>(nst, an);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  promote_group<BITS, T, SCALED>(ring + (it % STAGES) * SB, part, a, acc);
  __syncthreads();
}

// The body of one block: output tile (M tile blockIdx.x, N tile blockIdx.y)
// over the K groups of split blockIdx.z, gps groups a split.  Unsplit, it
// writes out (times post[n] for B1); split, it writes its unscaled partial
// slice out + z * M * N for reduce().
template <int BITS, typename T, bool SCALED, bool ALIGNED>
__device__ __forceinline__ void gemm(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                                     const float* __restrict__ scales, float* __restrict__ out,
                                     int M, int N, int K, int Kp, int nblk, int gps) {
  constexpr int SB = stage_bytes<BITS, T, SCALED>();
  constexpr int XBYTES = BM * x_pitch<T>() * static_cast<int>(sizeof(T));
  constexpr int NA = 4 * passes<T>() * 4;
  // the level tiles on a 1,024 B boundary (the swizzle's period), the ring
  // after them
  unsigned char* lt = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = lt + 2 * LEVEL_TILE_BYTES;
  const uint32_t lt_addr = smem_addr(lt);
  // M tiles vary fastest, so the blocks of one weight tile run together and
  // share its bytes in L2
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int groups = (K + BK - 1) / BK;
  const int gb = blockIdx.z * gps;
  const int ng = min(groups, gb + gps) - gb;

  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
  uint32_t a[NA], a_next[NA];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ng)
      load_stage<BITS, T, SCALED, ALIGNED>(ring + s * SB, x, packed, scales, M, N, K, Kp,
                                           nblk, m0, n0, gb + s);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncwarp();
  stage_levels<BITS>(ring + XBYTES, lt);
  x_fragments<T>(ring, a);
  // the level tiles are written through the generic proxy and read by
  // wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int it = 0; it < ng; it += 2) {
    group_step<BITS, T, SCALED, ALIGNED>(it, ng, ring, lt, lt_addr, x, packed, scales, M, N, K,
                                         Kp, nblk, m0, n0, gb, part, a, a_next, acc);
    if (it + 1 < ng)
      group_step<BITS, T, SCALED, ALIGNED>(it + 1, ng, ring, lt, lt_addr, x, packed, scales, M,
                                           N, K, Kp, nblk, m0, n0, gb, part, a_next, a, acc);
  }
  cp_wait<0>();

  const bool post = !SCALED && gridDim.z == 1;
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * t;
    if (n >= N) continue;
    const bool pair = n + 1 < N;
    const float s0 = post ? scales[n] : 1.f;
    const float s1 = post && pair ? scales[n + 1] : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * warp + g + 8 * h;
      if (m >= M) continue;
      float* o = dst + static_cast<size_t>(m) * N + n;
      const float v0 = acc[4 * i + 2 * h] * s0, v1 = acc[4 * i + 2 * h + 1] * s1;
      if (pair && (N & 1) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (pair) o[1] = v1;
      }
    }
  }
}

// out[i] = post * sum_z part[z][i], z in order: the split's second pass
template <bool SCALED>
__device__ __forceinline__ void reduce(const float* __restrict__ part,
                                       const float* __restrict__ scale, float* __restrict__ out,
                                       int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * mn + i];
  out[i] = SCALED ? s : s * scale[i % N];
}

// Launch Kernel (a __global__ wrapping gemm()) and, when split, Reducer (one
// wrapping reduce()).  part is the (splits, M, N) f32 scratch the wrapper
// allocated, unused when splits == 1.
template <auto Kernel, auto Reducer, int BITS, typename T, bool SCALED>
cudaError_t launch(const T* x, const uint8_t* packed, const float* scales, float* out,
                   float* part, int M, int N, int K, int Kp, int nblk, int splits,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<BITS, T, SCALED>();
  // once per kernel: more than 48 KB of dynamic shared memory must be asked for
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int groups = (K + BK - 1) / BK;
  if (splits < 1) return cudaErrorInvalidValue;
  const int gps = (groups + splits - 1) / splits;
  // every split must own at least one group, and split output needs scratch
  if ((splits - 1) * gps >= groups || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  Kernel<<<grid, THREADS, kSmem, stream>>>(x, packed, scales, splits > 1 ? part : out, M, N, K,
                                           Kp, nblk, gps);
  if (splits > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    Reducer<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(part, scales, out, M,
                                                                         N, splits);
  }
  return cudaGetLastError();
}

}  // namespace tcmm
