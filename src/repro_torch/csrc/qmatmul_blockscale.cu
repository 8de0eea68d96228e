// Wire-form dequant matmul for Hopper (sm_90a):
//   out = x @ (unpack(packed) * scales[n, k / 32])^T.
//
// Replaces: src/repro/kernels/qmatmul.py :: qmatmul_f32_blockscale (Pallas
//   body _qmatmul_f32_blockscale_kernel, unpack helper _unpack_block).
//
// Computes out[m, n] = sum_k x[m, k] * (field(packed[n, k / f], k % f)
//   - 2^(bits-1)) * scales[n, k / 32], with f = 8 / bits fields per byte,
//   little-endian within the byte.  x is (M, K) f32, packed is (N, ceil(K / f))
//   uint8, scales is (N, ceil(K / 32)) f32, out is (M, N) f32.  This is the
//   page codec's blockwise wire form (core/quantize.quantize_blockwise), one
//   scale per 32 weights of a row, applied inside the reduction: there is no
//   final scale step.  A ragged tail block's scale covers only its tail.
//
// What bounds it on this card: the serve's cold linears at decode (M = batch
//   slots, 4) are GEMVs whose time is the wire bytes over the 3.35 TB/s of
//   device memory: the int8 levels plus 4 / 32 B of scale per weight, 12.5 %
//   more than the payload.  Prefill (M = slots x bucket, 256) is bound by the
//   multiply-adds: 67 TFLOP/s in f32 on the CUDA cores, 495 TFLOP/s in TF32
//   on the tensor cores.
//
// What the design does about it: the two shapes of csrc/qmatmul_f32.cu.
//   M <= 16 takes a weight-streaming kernel: one warp per output channel
//   reads the packed row as 32-bit words, coalesced along K; a word holds at
//   most 16 levels, all of one 32-wide scale group, so each word's partial
//   sums for all M rows are scaled once by the one scale it reads.  Larger M
//   takes the tensor-core main loop of csrc/qmm_tc.cuh, whose K stage of 32
//   is exactly one scale group: each group's two-pass TF32 partial sums are
//   promoted into f32 with one FMA by that group's scale, read once a tile.
//   Both mask k >= K.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tc.cuh"

namespace {

constexpr int BLOCK = 32;        // weights per scale (PAGE_SCALE_BLOCK)
constexpr int GEMV_ROWS = 8;     // x rows one weight-streaming block carries
constexpr int GEMV_WARPS = 8;    // output channels per block, one per warp
static_assert(tcmm::BK == BLOCK, "a tensor-core K stage must be one scale group");

template <int BITS>
__device__ __forceinline__ float level(uint32_t byte, int t) {
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kHalf = 1 << (BITS - 1);
  return static_cast<float>(static_cast<int>((byte >> (t * BITS)) & kMask) - kHalf);
}

// unscaled partial sums of one packed byte's levels, all rows at once
template <int BITS>
__device__ __forceinline__ void gemv_byte(uint32_t byte, int kbase, int K, int rows,
                                          const float* __restrict__ xb,
                                          float (&part)[GEMV_ROWS]) {
  constexpr int F = 8 / BITS;
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const int k = kbase + t;
    if (k < K) {
      const float w = level<BITS>(byte, t);
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r)
        if (r < rows) part[r] += xb[static_cast<size_t>(r) * K + k] * w;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
bs_gemv(const float* __restrict__ x, const uint8_t* __restrict__ packed,
        const float* __restrict__ scales, float* __restrict__ out,
        int M, int N, int K, int Kp, int nblk) {
  constexpr int F = 8 / BITS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  const int m0 = blockIdx.y * GEMV_ROWS;
  if (n >= N) return;
  const int rows = min(GEMV_ROWS, M - m0);
  const uint8_t* wrow = packed + static_cast<size_t>(n) * Kp;
  const float* srow = scales + static_cast<size_t>(n) * nblk;
  const float* xb = x + static_cast<size_t>(m0) * K;
  float acc[GEMV_ROWS];
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r) acc[r] = 0.f;

  if ((Kp & 3) == 0 && (reinterpret_cast<uintptr_t>(wrow) & 3) == 0) {
    // a word's 4 * F <= 16 levels start at a multiple of 4 * F, which
    // divides 32, so they share one scale group; kbase < K always
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wrow);
    for (int wi = lane; wi < (Kp >> 2); wi += 32) {
      const uint32_t word = __ldg(w32 + wi);
      const int kbase = wi * 4 * F;
      float part[GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) part[r] = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        gemv_byte<BITS>((word >> (8 * bb)) & 0xFFu, kbase + bb * F, K, rows, xb, part);
      const float s = __ldg(srow + kbase / BLOCK);
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) acc[r] += part[r] * s;
    }
  } else {
    for (int j = lane; j < Kp; j += 32) {
      float part[GEMV_ROWS];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) part[r] = 0.f;
      gemv_byte<BITS>(__ldg(wrow + j), j * F, K, rows, xb, part);
      const float s = __ldg(srow + (j * F) / BLOCK);
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) acc[r] += part[r] * s;
    }
  }
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r)
      if (r < rows) out[static_cast<size_t>(m0 + r) * N + n] = acc[r];
  }
}

template <int BITS, bool ALIGNED>
__global__ void __launch_bounds__(tcmm::THREADS, tcmm::MIN_BLOCKS)
bs_tc(const float* __restrict__ x, const uint8_t* __restrict__ packed,
      const float* __restrict__ scales, float* __restrict__ out, int M, int N, int K,
      int Kp, int nblk, int gps) {
  tcmm::gemm<BITS, float, true, ALIGNED>(x, packed, scales, out, M, N, K, Kp, nblk, gps);
}

__global__ void bs_tc_reduce(const float* __restrict__ part, const float* __restrict__ scales,
                             float* __restrict__ out, int M, int N, int splits) {
  tcmm::reduce<true>(part, scales, out, M, N, splits);
}

template <int BITS>
int launch(const float* x, const uint8_t* packed, const float* scales, float* out,
           float* part, int M, int N, int K, int Kp, int nblk, int aligned, int splits,
           cudaStream_t stream) {
  if (M <= tcmm::GEMV_MAX_M) {
    dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, (M + GEMV_ROWS - 1) / GEMV_ROWS);
    bs_gemv<BITS><<<grid, GEMV_WARPS * 32, 0, stream>>>(x, packed, scales, out, M, N, K,
                                                         Kp, nblk);
    return static_cast<int>(cudaGetLastError());
  }
  if (aligned)
    return static_cast<int>(tcmm::launch<bs_tc<BITS, true>, bs_tc_reduce, BITS, float, true>(
        x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream));
  return static_cast<int>(tcmm::launch<bs_tc<BITS, false>, bs_tc_reduce, BITS, float, true>(
      x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream));
}

}  // namespace

// part: (splits, M, N) f32 scratch when splits > 1 (M > 16 only), else null;
// aligned: as for qmatmul_f32_launch
extern "C" int qmatmul_blockscale_launch(const void* x, const void* packed,
                                         const void* scales, void* out, void* part, int M,
                                         int N, int K, int Kp, int nblk, int bits,
                                         int aligned, int splits, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(xp, wp, sp, op, pp, M, N, K, Kp, nblk, aligned, splits, s);
    case 4: return launch<4>(xp, wp, sp, op, pp, M, N, K, Kp, nblk, aligned, splits, s);
    case 8: return launch<8>(xp, wp, sp, op, pp, M, N, K, Kp, nblk, aligned, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the tensor-core path's geometry (tcmm::geometry), six ints
extern "C" void qmatmul_blockscale_tc_geometry(int* g) { tcmm::geometry(g); }
