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
//   slots, 4) take a time that is the wire bytes over the 3.35 TB/s of
//   device memory: the int8 levels plus 4 / 32 B of scale per weight, 12.5 %
//   more than the payload.  Prefill (M = slots x bucket, 256) is bound by the
//   multiply-adds: 67 TFLOP/s in f32 on the CUDA cores, 495 TFLOP/s in TF32
//   on the tensor cores.
//
// What the design does about it: the two loops of csrc/qmatmul_f32.cu, with
//   the block scales inside the reduction.  M <= 16 takes the decode loop of
//   csrc/qmm_decode.cuh, whose ring carries each stage's scales beside its
//   packed bytes: each 32-wide group's TF32 partial sums (x's hi and lo parts
//   as separate MMA columns) are promoted into f32 with one FMA by that
//   group's scale.  Larger M takes the tensor-core main loop of
//   csrc/qmm_tc.cuh, whose K stage of 32 is exactly one scale group, promoted
//   the same way.  Both mask k >= K.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_decode.cuh"
#include "qmm_tc.cuh"

namespace {

constexpr int BLOCK = 32;        // weights per scale (PAGE_SCALE_BLOCK)
static_assert(tcmm::BK == BLOCK, "a K stage must be one scale group");

template <int BITS, bool ALIGNED, int NC>
__global__ void __launch_bounds__(dcmm::THREADS, dcmm::MIN_BLOCKS)
bs_dec(const float* __restrict__ x, const uint8_t* __restrict__ packed,
       const float* __restrict__ scales, float* __restrict__ out, float* __restrict__ part,
       int* __restrict__ counters, int M, int N, int K, int Kp, int nblk, int gps) {
  dcmm::decode<BITS, float, true, ALIGNED, NC>(x, packed, scales, out, part, counters, M, N, K,
                                               Kp, nblk, gps);
}

template <int BITS, int NC>
cudaError_t launch_dec(const float* x, const uint8_t* packed, const float* scales, float* out,
                       float* part, int* counters, int M, int N, int K, int Kp, int nblk,
                       int aligned, int splits, cudaStream_t stream) {
  if (aligned)
    return dcmm::launch<bs_dec<BITS, true, NC>, BITS, float, true, NC>(
        x, packed, scales, out, part, counters, M, N, K, Kp, nblk, splits, stream);
  return dcmm::launch<bs_dec<BITS, false, NC>, BITS, float, true, NC>(
      x, packed, scales, out, part, counters, M, N, K, Kp, nblk, splits, stream);
}

template <int BITS, bool ALIGNED>
__global__ void __launch_bounds__(tcmm::THREADS, tcmm::MIN_BLOCKS)
bs_tc(const float* __restrict__ x, const uint8_t* __restrict__ packed,
      const float* __restrict__ scales, float* __restrict__ out, int M, int N, int K,
      int Kp, int nblk, int gps) {
  tcmm::gemm<BITS, float, true, ALIGNED>(x, packed, scales, out, M, N, K, Kp, nblk, gps,
                                         blockIdx.x);
}

__global__ void bs_tc_reduce(const float* __restrict__ part, const float* __restrict__ scales,
                             float* __restrict__ out, int M, int N, int splits) {
  tcmm::reduce<true>(part, scales, out, M, N, splits);
}

template <int BITS>
int launch(const float* x, const uint8_t* packed, const float* scales, float* out,
           float* part, int* counters, int M, int N, int K, int Kp, int nblk, int aligned,
           int splits, cudaStream_t stream) {
  if (M <= dcmm::MAX_M) {
    const int cols = 2 * M;               // x's hi and lo parts
    if (cols <= 8)
      return static_cast<int>(launch_dec<BITS, 1>(x, packed, scales, out, part, counters, M, N,
                                                  K, Kp, nblk, aligned, splits, stream));
    if (cols <= 16)
      return static_cast<int>(launch_dec<BITS, 2>(x, packed, scales, out, part, counters, M, N,
                                                  K, Kp, nblk, aligned, splits, stream));
    return static_cast<int>(launch_dec<BITS, 4>(x, packed, scales, out, part, counters, M, N,
                                                K, Kp, nblk, aligned, splits, stream));
  }
  if (aligned)
    return static_cast<int>(tcmm::launch<bs_tc<BITS, true>, bs_tc_reduce, BITS, float, true>(
        x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream));
  return static_cast<int>(tcmm::launch<bs_tc<BITS, false>, bs_tc_reduce, BITS, float, true>(
      x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream));
}

}  // namespace

// part, counters and aligned: as for qmatmul_f32_launch
extern "C" int qmatmul_blockscale_launch(const void* x, const void* packed,
                                         const void* scales, void* out, void* part,
                                         void* counters, int M, int N, int K, int Kp, int nblk,
                                         int bits, int aligned, int splits, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  int* cp = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(xp, wp, sp, op, pp, cp, M, N, K, Kp, nblk, aligned, splits, s);
    case 4: return launch<4>(xp, wp, sp, op, pp, cp, M, N, K, Kp, nblk, aligned, splits, s);
    case 8: return launch<8>(xp, wp, sp, op, pp, cp, M, N, K, Kp, nblk, aligned, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// both loops' geometry (dcmm::geometry), ten ints
extern "C" void qmatmul_blockscale_tc_geometry(int* g) { dcmm::geometry(g); }
