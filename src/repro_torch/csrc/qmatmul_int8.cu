// Integer N-EUREKA matmul for Hopper (sm_90a): uint8 activations x packed
// signed weight levels -> int32 accumulators -> NORMQUANT requant -> uint8,
// on the int8 tensor cores.
//
// Replaces: src/repro/kernels/qmatmul.py :: qmatmul_int8 (Pallas body
//   _qmatmul_int8_kernel, unpack helper _unpack_block).  It carries every
//   pointwise (1x1) job of MobileNet-V2 through neureka_conv.conv1x1.
//
// Computes out[m, n] = clip(rint(float(acc) * mult[n]) + bias[n], 0, 255) with
//   acc = sum_k x[m, k] * (field(packed[n, k / f], k % f) - 2^(bits-1)), f = 8 / bits
//   fields per byte, little-endian within the byte.  x is (M, K) uint8, packed is
//   (N, ceil(K / f)) uint8, mult (N,) f32, bias (N,) int32, out (M, N) uint8.  The
//   sum is exact in int32 (|acc| <= 255 * 128 * K); the requant rounds half to
//   even (rintf, as jnp.round) and keeps the multiply and the add apart, so the
//   result equals the plain version bit for bit.
//
// What bounds it on this card: MobileNet-V2 at 224 gives M from 1 (fc) to
//   12,544 (a 112 x 112 map), K and N from 16 to 1,280.  A job moves 62 KB
//   (b14.pw_proj) to 1.4 MB (b1.pw_exp's output), 0.02-0.42 us at 3.35 TB/s, and
//   does at most 19 M multiply-adds, 0.02 us at the int8 tensor cores' 1,979
//   TOP/s: every job is bound by its bytes, and at these sizes in fact by
//   latency: the launch, one trip to device memory and back, and too few
//   blocks to keep the trips of all 132 SMs in flight.
//
// What the design does about it (each choice from per-job times on an H100
// SXM, tools/neureka_ab.py --sweep; kernels/qmatmul.int8_plan holds the rule):
//   - the products run on the tensor cores, mma.sync m16n8k32 u8 x s8 -> s32
//     (csrc/int8_mma.cuh); each lane unpacks its own B fragment (8 levels of
//     a column) in registers, a byte permute and a carry-free subtraction,
//     with fields past K zeroed, so ragged K is exact;
//   - blocks of 64 rows by 16 columns, one 16 x 16 tile a warp: at every
//     MobileNet-V2 shape the narrowest tile, with the most blocks and the
//     least to copy, beat 32- to 128-column and 128-row tiles;
//   - the direct route (K <= 64: the 112 x 112 to 14 x 14 expansions and
//     b0's projection): each lane loads its fragments straight from global
//     memory into registers, a 32 B sector a row a quad, and the block has
//     no barrier; 1.2-1.5x faster there than staging the tiles first;
//   - the staged route (the rest, and any unaligned x): the block copies its
//     x and packed tiles with cp.async at the widest width the rows allow,
//     all issued before any is waited on, then MMAs from shared memory;
//   - a K split where the tiles leave SMs idle and a block would stage its
//     K three times or more (the 14 x 14 and 7 x 7 projections, fc): one
//     launch, each split writing its int32 slice and the last block of a
//     tile to arrive (a counter a tile, reset by that block) adding the
//     others; splitting a shorter K cost more than the blocks it added;
//   - the requanted tile goes through shared memory and out as whole rows of
//     16 B (8, 4, 2 or 1 B where N is not a multiple of 16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace i8mma;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;     // rows a block: one 16-row MMA tile a warp
constexpr int BN = 16;             // columns a block: two 8-column MMA tiles
constexpr int NI = BN / 8;
constexpr int KSTAGE = 256;        // K a staged block holds in shared memory at once
constexpr int KUNIT = 64;          // a split's K range is a multiple of this (16 B of 2-bit fields)
constexpr int DIRECT_MAX_K = 64;   // K of the direct route: two MMA steps in registers

// With K split over gridDim.z: write this block's int32 slice of its tile
// to `part`, and let the last block of the tile to arrive (a counter a tile,
// reset by that block; threadFenceReduction) add the others' slices into its
// acc.  Returns whether this block goes on to the requant: unsplit, or last.
__device__ __forceinline__ bool add_slices(int (&acc)[NI][4], int* __restrict__ part,
                                           int* __restrict__ counters) {
  constexpr int NREG = NI * 4;
  const int splits = gridDim.z;
  if (splits == 1) return true;
  __shared__ int last;
  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int* mine = part + (static_cast<size_t>(tile) * splits + blockIdx.z) * NREG * THREADS;
#pragma unroll
  for (int r = 0; r < NREG; ++r) mine[r * THREADS + tid] = acc[r / 4][r % 4];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int z = 0; z < splits; ++z) {
    if (z == static_cast<int>(blockIdx.z)) continue;
    const int* src = part + (static_cast<size_t>(tile) * splits + z) * NREG * THREADS;
    int v[NREG];
#pragma unroll
    for (int r = 0; r < NREG; ++r) v[r] = __ldcg(src + r * THREADS + tid);
#pragma unroll
    for (int r = 0; r < NREG; ++r) acc[r / 4][r % 4] += v[r];
  }
  if (tid == 0) counters[tile] = 0;   // ready for the next launch
  return true;
}

// requant a warp's 16 x 16 outputs into rows r0 .. r0 + 15 of a shared
// tile of pitch BN: lane (g, t) holds rows g and g + 8, columns 8j + 2t + h
__device__ __forceinline__ void requant_tile(const int (&acc)[NI][4], const float (&mu)[NI][2],
                                             const int (&bi)[NI][2], unsigned char* os, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * j + 2 * t + h;
      os[(r0 + g) * BN + c] = requant(acc[j][h], mu[j][h], bi[j][h]);
      os[(r0 + g + 8) * BN + c] = requant(acc[j][2 + h], mu[j][h], bi[j][h]);
    }
}

// this lane's requant operands: columns n0 + 8j + 2t + h
__device__ __forceinline__ void load_requant(const float* __restrict__ mult,
                                             const int* __restrict__ bias, int n0, int N,
                                             float (&mu)[NI][2], int (&bi)[NI][2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 8 * j + 2 * t + h;
      mu[j][h] = n < N ? __ldg(mult + n) : 0.f;
      bi[j][h] = n < N ? __ldg(bias + n) : 0;
    }
}

// The direct route (K <= DIRECT_MAX_K, a multiple of 8; x and packed 8 B
// aligned): no shared staging and no block barrier.  Each lane loads its A
// fragments (8 B of rows g and g + 8 a K step: a quad reads one 32 B sector
// of a row), its B fragments (the packed bytes of 8 levels of column g a
// step, unpacked in registers) and its requant operands straight from global
// memory, all before the first MMA; each warp requants its 16 x 16 outputs
// into its own shared rows and writes them out after a __syncwarp.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
qmm_int8_direct(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ mult, const int* __restrict__ bias,
                uint8_t* __restrict__ out, int M, int N, int K, int Kp, int ow) {
  constexpr int F = 8 / BITS, STEPS = DIRECT_MAX_K / 32;
  __shared__ __align__(16) unsigned char os[WARPS][16 * BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM + 16 * warp, n0 = blockIdx.x * BN;
  if (m0 >= M) return;

  uint2 a[STEPS][2];
  uint32_t b[STEPS][NI][2];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int k = 32 * s + 8 * t;   // this lane's 8 K of the step, all in or all out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * h + g;
      a[s][h] = k < K && m < M
                    ? __ldg(reinterpret_cast<const uint2*>(x + static_cast<size_t>(m) * K + k))
                    : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int n = n0 + 8 * j + g;
      const uint8_t* src = packed + static_cast<size_t>(n) * Kp + k / F;
      const bool in = k < K && n < N;
      // the 8 / F packed bytes of the lane's 8 levels, unpacked after all loads
      if constexpr (BITS == 8) {
        const uint2 v = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
        b[s][j][0] = v.x;
        b[s][j][1] = v.y;
      } else if constexpr (BITS == 4) {
        b[s][j][0] = in ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
      } else {
        b[s][j][0] = in ? __ldg(reinterpret_cast<const uint16_t*>(src)) : 0u;
      }
    }
  }
  float mu[NI][2];
  int bi[NI][2];
  load_requant(mult, bias, n0, N, mu, bi);

  int acc[NI][4] = {};
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (32 * s >= K) break;
    const bool live = 32 * s + 8 * t < K;   // a level is zero where k >= K
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      uint32_t lv[F];
      if constexpr (BITS == 8) {
        lv[0] = center<8>(b[s][j][0]);
        b[s][j][1] = live ? center<8>(b[s][j][1]) : 0u;
      } else {
        unpack_word<BITS>(b[s][j][0], lv);
        b[s][j][1] = live ? lv[1] : 0u;
      }
      b[s][j][0] = live ? lv[0] : 0u;
      mma_u8s8(acc[j], a[s][0].x, a[s][1].x, a[s][0].y, a[s][1].y, b[s][j][0], b[s][j][1]);
    }
  }

  requant_tile(acc, mu, bi, os[warp], 0);
  __syncwarp();
  const int rows = min(16, M - m0), cols = min(BN, N - n0), per = cols / ow;
  for (int i = lane; i < rows * per; i += 32) {
    const int r = i / per, c = (i - r * per) * ow;
    store_w(ow, out + static_cast<size_t>(m0 + r) * N + n0 + c, os[warp] + r * BN + c);
  }
}

struct Smem {
  int xp, pp, ps, os, mb, bytes;
};

// the staged route's shared layout: x tile (BM x xp), packed tile (BN x
// pp), output tile (BM x BN), the tile's mult and bias (BN each)
template <int BITS>
__host__ __device__ inline Smem smem_layout(int kchunk) {
  const int kst = KSTAGE < kchunk ? KSTAGE : round_up(kchunk, 32);
  Smem s;
  s.xp = frag_pitch(kst);
  s.pp = round_up(kst * BITS / 8, 16);
  s.ps = BM * s.xp;
  s.os = s.ps + BN * s.pp;
  s.mb = round_up(s.os + BM * BN, 16);
  s.bytes = s.mb + 2 * BN * 4;
  return s;
}

// The staged route, at any alignment and K: a block copies its x and packed
// tiles (KSTAGE of K at a time) into shared memory with cp.async at the
// widest width the rows allow (byte loads for an unaligned x), each lane
// builds its B fragments from the packed bytes there, and the block's K
// range [kb, ke) is its split's.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
qmm_int8_staged(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ mult, const int* __restrict__ bias,
                uint8_t* __restrict__ out, int* __restrict__ part, int* __restrict__ counters,
                int M, int N, int K, int Kp, int kchunk, int xw, int pw, int ow) {
  constexpr int F = 8 / BITS;
  const Smem L = smem_layout<BITS>(kchunk);
  unsigned char* xs = smem;
  unsigned char* ps = smem + L.ps;
  unsigned char* os = smem + L.os;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int rows_m = min(BM, M - m0), rows_n = min(BN, N - n0);

  // the tile's requant operands, copied beside the first tiles
  float* mus = reinterpret_cast<float*>(smem + L.mb);
  int* bis = reinterpret_cast<int*>(mus + BN);
  if (tid < rows_n) cp_async<4>(mus + tid, mult + n0 + tid);
  else if (tid >= BN && tid < BN + rows_n) cp_async<4>(bis + tid - BN, bias + n0 + tid - BN);
  cp_commit();

  int acc[NI][4] = {};
  for (int ks = kb; ks < ke; ks += KSTAGE) {
    const int kl = min(KSTAGE, ke - ks);
    if (ks > kb) __syncthreads();   // the previous stage's tiles are read
    copy_rows_w(xw, xs, L.xp, x + static_cast<size_t>(m0) * K + ks, K, rows_m, kl);
    copy_rows_w(pw, ps, L.pp, packed + static_cast<size_t>(n0) * Kp + ks / F, Kp, rows_n,
                (kl + F - 1) / F);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    for (int k0 = 0; k0 < kl; k0 += 32) {
      uint32_t a[4];
      const unsigned char* row = xs + (16 * warp + g) * L.xp + k0;
      load_a(row, row + 8 * L.xp, t, a);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        // levels straight from the packed tile, fields at or past kl zero
        uint32_t b[2];
        load_b_packed<BITS>(ps + (8 * j + g) * L.pp, k0 + 8 * t, kl - k0 - 8 * t, b);
        mma_u8s8(acc[j], a[0], a[1], a[2], a[3], b[0], b[1]);
      }
    }
  }
  if (!add_slices(acc, part, counters)) return;

  if (kb >= ke) {   // mult and bias, where no K stage has waited for them
    cp_wait_all();
    __syncthreads();
  }
  float mu[NI][2];
  int bi[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu[j][h] = mus[8 * j + 2 * t + h];
      bi[j][h] = bis[8 * j + 2 * t + h];
    }
  requant_tile(acc, mu, bi, os, 16 * warp);
  __syncthreads();
  store_rows_w(ow, out + static_cast<size_t>(m0) * N + n0, N, os, BN, rows_m, rows_n);
}

template <int BITS>
cudaError_t launch(bool direct, const uint8_t* x, const uint8_t* packed, const float* mult,
                   const int* bias, uint8_t* out, int* part, int* counters, int M, int N, int K,
                   int Kp, int splits, int kchunk, int xw, int pw, int ow, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (direct) {
    if (splits != 1 || K > DIRECT_MAX_K || K % 8 != 0 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(packed)) % 8 != 0)
      return cudaErrorInvalidValue;
    qmm_int8_direct<BITS><<<grid, THREADS, 0, stream>>>(x, packed, mult, bias, out, M, N, K, Kp,
                                                        ow);
    return cudaGetLastError();
  }
  const bool split_ok = splits == 1 ? kchunk >= K
                                    : kchunk % KUNIT == 0 && (splits - 1) * kchunk < K &&
                                          splits * kchunk >= K && part != nullptr &&
                                          counters != nullptr;
  if (!split_ok) return cudaErrorInvalidValue;
  auto kernel = qmm_int8_staged<BITS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_layout<BITS>(KSTAGE).bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, smem_layout<BITS>(kchunk).bytes, stream>>>(
      x, packed, mult, bias, out, part, counters, M, N, K, Kp, kchunk, xw, pw, ow);
  return cudaGetLastError();
}

}  // namespace

// One launch of the plan kernels/qmatmul.int8_plan chose: blocks of 64 rows
// by 16 columns on the direct route (K <= 64, a multiple of 8, x and packed
// 8 B aligned, unsplit) or the staged one, K split into `splits` ranges of
// kchunk (part: the tiles x splits x (64 x 16) int32 slices, counters: one
// zeroed int a tile; both unused unsplit).  xw and pw are the copy widths
// the rows of x and packed allow (16, 8, 4 or 1 B), ow the store width of
// out's rows.  A plan the kernels do not hold is refused with
// cudaErrorInvalidValue.
extern "C" int qmatmul_int8_launch(const void* x, const void* packed, const void* mult,
                                   const void* bias, void* out, void* part, void* counters,
                                   int M, int N, int K, int Kp, int bits, int direct, int splits,
                                   int kchunk, int xw, int pw, int ow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* mp = static_cast<const float*>(mult);
  const int* bp = static_cast<const int*>(bias);
  uint8_t* op = static_cast<uint8_t*>(out);
  int* pp = static_cast<int*>(part);
  int* cp = static_cast<int*>(counters);
  const bool d = direct != 0;
  switch (bits) {
    case 2: return launch<2>(d, xp, wp, mp, bp, op, pp, cp, M, N, K, Kp, splits, kchunk, xw, pw,
                             ow, s);
    case 4: return launch<4>(d, xp, wp, mp, bp, op, pp, cp, M, N, K, Kp, splits, kchunk, xw, pw,
                             ow, s);
    case 8: return launch<8>(d, xp, wp, mp, bp, op, pp, cp, M, N, K, Kp, splits, kchunk, xw, pw,
                             ow, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
