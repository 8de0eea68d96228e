// Fused dequant matmul for Hopper (sm_90a): out = x @ unpack(packed)^T * scale.
//
// Replaces: src/repro/kernels/qmatmul.py :: qmatmul_f32 (Pallas body
//   _qmatmul_f32_kernel, unpack helper _unpack_block).
//
// Computes out[m, n] = scale[n] * sum_k x[m, k] * (field(packed[n, k / f], k % f)
//   - 2^(bits-1)), with f = 8 / bits fields per byte, little-endian within the
//   byte.  x is (M, K) f32 or bf16, packed is (N, ceil(K / f)) uint8, scale is
//   (N,) f32, out is (M, N) f32.  The scale is applied once, after the K
//   reduction, as the reference does.
//
// What bounds it on this card: decode calls it with M = batch slots (4), a
//   GEMV whose time is the packed weight bytes over the 3.35 TB/s of device
//   memory; prefill calls it with M = slots x bucket (256 and up), where the
//   multiply-adds bind: 67 TFLOP/s in f32 on the CUDA cores, 495 TFLOP/s in
//   TF32 on the tensor cores.
//
// What the design does about it: the packed weight is read from device memory
//   as it is stored and never expanded there; fields are unpacked in registers
//   next to the multiply-adds (the At-MRAM point of qmatmul.py).  M <= 16 takes
//   a weight-streaming kernel: one warp per output channel reads the packed row
//   as 32-bit words, coalesced along K, and carries all M rows' sums at once on
//   the CUDA cores, so each weight byte is loaded once.  Larger M takes the
//   tensor-core main loop of csrc/qmm_tc.cuh (two TF32 passes for f32 x, one
//   for bf16 x, per-32 groups promoted into f32, a cp.async ring of x and
//   packed bytes, K split over blocks when the output tiles alone would leave
//   SMs idle); its note says why that keeps f32 accuracy.  Both mask k >= K,
//   so ragged K (not a multiple of f or of a group) is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tc.cuh"

namespace {

constexpr int GEMV_ROWS = 8;     // x rows one weight-streaming block carries
constexpr int GEMV_WARPS = 8;    // output channels per block, one per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int BITS>
__device__ __forceinline__ float level(uint32_t byte, int t) {
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kHalf = 1 << (BITS - 1);
  return static_cast<float>(static_cast<int>((byte >> (t * BITS)) & kMask) - kHalf);
}

template <int BITS, typename T>
__device__ __forceinline__ void gemv_byte(uint32_t byte, int kbase, int K, int rows,
                                          const T* __restrict__ xb, float (&acc)[GEMV_ROWS]) {
  constexpr int F = 8 / BITS;
#pragma unroll
  for (int t = 0; t < F; ++t) {
    const int k = kbase + t;
    if (k < K) {
      const float w = level<BITS>(byte, t);
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r)
        if (r < rows) acc[r] += to_f32(xb[static_cast<size_t>(r) * K + k]) * w;
    }
  }
}

template <int BITS, typename T>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qmm_gemv(const T* __restrict__ x, const uint8_t* __restrict__ packed,
         const float* __restrict__ scale, float* __restrict__ out,
         int M, int N, int K, int Kp) {
  constexpr int F = 8 / BITS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  const int m0 = blockIdx.y * GEMV_ROWS;
  if (n >= N) return;
  const int rows = min(GEMV_ROWS, M - m0);
  const uint8_t* wrow = packed + static_cast<size_t>(n) * Kp;
  const T* xb = x + static_cast<size_t>(m0) * K;
  float acc[GEMV_ROWS];
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r) acc[r] = 0.f;

  if ((Kp & 3) == 0 && (reinterpret_cast<uintptr_t>(wrow) & 3) == 0) {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wrow);
    for (int wi = lane; wi < (Kp >> 2); wi += 32) {
      const uint32_t word = __ldg(w32 + wi);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        gemv_byte<BITS>((word >> (8 * bb)) & 0xFFu, (wi * 4 + bb) * F, K, rows, xb, acc);
    }
  } else {
    for (int j = lane; j < Kp; j += 32)
      gemv_byte<BITS>(__ldg(wrow + j), j * F, K, rows, xb, acc);
  }
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  if (lane == 0) {
    const float s = scale[n];
#pragma unroll
    for (int r = 0; r < GEMV_ROWS; ++r)
      if (r < rows) out[static_cast<size_t>(m0 + r) * N + n] = acc[r] * s;
  }
}

template <int BITS, typename T, bool ALIGNED>
__global__ void __launch_bounds__(tcmm::THREADS, tcmm::MIN_BLOCKS)
qmm_tc(const T* __restrict__ x, const uint8_t* __restrict__ packed,
       const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
       int Kp, int nblk, int gps) {
  tcmm::gemm<BITS, T, false, ALIGNED>(x, packed, scale, out, M, N, K, Kp, nblk, gps);
}

__global__ void qmm_tc_reduce(const float* __restrict__ part, const float* __restrict__ scale,
                              float* __restrict__ out, int M, int N, int splits) {
  tcmm::reduce<false>(part, scale, out, M, N, splits);
}

template <int BITS, typename T>
int launch(const void* x, const void* packed, const void* scale, void* out, void* part,
           int M, int N, int K, int Kp, int aligned, int splits, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  if (M <= tcmm::GEMV_MAX_M) {
    dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, (M + GEMV_ROWS - 1) / GEMV_ROWS);
    qmm_gemv<BITS, T><<<grid, GEMV_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, N, K, Kp);
    return static_cast<int>(cudaGetLastError());
  }
  if (aligned)
    return static_cast<int>(tcmm::launch<qmm_tc<BITS, T, true>, qmm_tc_reduce, BITS, T, false>(
        xp, wp, sp, op, pp, M, N, K, Kp, 0, splits, stream));
  return static_cast<int>(tcmm::launch<qmm_tc<BITS, T, false>, qmm_tc_reduce, BITS, T, false>(
      xp, wp, sp, op, pp, M, N, K, Kp, 0, splits, stream));
}

template <typename T>
int launch_bits(const void* x, const void* packed, const void* scale, void* out, void* part,
                int M, int N, int K, int Kp, int bits, int aligned, int splits,
                cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, T>(x, packed, scale, out, part, M, N, K, Kp, aligned, splits, stream);
    case 4: return launch<4, T>(x, packed, scale, out, part, M, N, K, Kp, aligned, splits, stream);
    case 8: return launch<8, T>(x, packed, scale, out, part, M, N, K, Kp, aligned, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part: (splits, M, N) f32 scratch when splits > 1 (M > 16 only), else null;
// aligned: x and packed rows are 16 B aligned and K, Kp multiples of a copy
// chunk (kernels/qmatmul.py decides both)
extern "C" int qmatmul_f32_launch(const void* x, int x_is_bf16, const void* packed,
                                  const void* scale, void* out, void* part, int M, int N,
                                  int K, int Kp, int bits, int aligned, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits<__nv_bfloat16>(x, packed, scale, out, part, M, N, K, Kp, bits, aligned,
                                      splits, s);
  return launch_bits<float>(x, packed, scale, out, part, M, N, K, Kp, bits, aligned, splits, s);
}

// the tensor-core path's geometry (tcmm::geometry), six ints
extern "C" void qmatmul_f32_tc_geometry(int* g) { tcmm::geometry(g); }
