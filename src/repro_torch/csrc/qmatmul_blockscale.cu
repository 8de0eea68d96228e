// Wire-form dequant matmul for Hopper (sm_90a):
//   out = x @ (unpack(packed) * scales[n, k / 32])^T.
//
// Replaces: src/repro/kernels/qmatmul.py :: qmatmul_f32_blockscale (Pallas
//   body _qmatmul_f32_blockscale_kernel, unpack helper _unpack_block).
//
// Computes out[m, n] = sum_k x[m, k] * (field(packed[n, k / f], k % f)
//   - 2^(bits-1)) * scales[n, k / 32], with f = 8 / bits fields per byte,
//   little-endian within the byte.  x is (M, K) f32 or bf16 (as the Pallas
//   kernel takes x of any float dtype), packed is (N, ceil(K / f))
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
//   the same way.  Both mask k >= K.  bf16 x takes both loops exactly as
//   csrc/qmatmul_f32.cu's bf16 x does: loaded as bf16 (half of x's bytes),
//   exact in TF32, so one MMA pass and one column of B a row of x instead of
//   the hi and lo parts of f32 x.
//
// Grouped over experts (kernels/qmatmul.py :: qmatmul_f32_blockscale_grouped;
//   replaces the vmapped qmatmul_f32_blockscale of src/repro/models/moe.py ::
//   expert_ffn when a MoE store's cold expert pages are wire-served, one
//   Pallas launch whose grid gains the expert axis): E problems of one
//   shape, x (E, M, K) against packed (E, N, Kp) and scales (E, N, nblk), in
//   one launch of the same loops, as csrc/qmatmul_f32.cu groups B1.  The
//   decode kernel takes the expert from blockIdx.y (the plain call is
//   E = 1), the tensor-core kernel's grouped instantiation from blockIdx.x
//   over the expert's M tiles, and each block offsets its operands by the
//   expert's strides.  Every expert is computed, its empty capacity rows
//   included (an expert with no rows gives zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_decode.cuh"
#include "qmm_tc.cuh"

namespace {

constexpr int BLOCK = 32;        // weights per scale (PAGE_SCALE_BLOCK)
static_assert(tcmm::BK == BLOCK, "a K stage must be one scale group");

// decode: expert blockIdx.y, its N tiles along x, its K splits along z
template <int BITS, typename T, bool ALIGNED, int NC>
__global__ void __launch_bounds__(dcmm::THREADS, dcmm::MIN_BLOCKS)
bs_dec(const T* __restrict__ x, const uint8_t* __restrict__ packed,
       const float* __restrict__ scales, float* __restrict__ out, float* __restrict__ part,
       int* __restrict__ counters, int M, int N, int K, int Kp, int nblk, int gps) {
  const dcmm::Expert<T> ex(x, packed, scales, out, part, counters, blockIdx.y, M, N, K, Kp,
                           static_cast<size_t>(N) * nblk,
                           static_cast<size_t>(gridDim.z) * N * ((M + 3) & ~3), gridDim.x);
  dcmm::decode<BITS, T, true, ALIGNED, NC>(ex.x, ex.packed, ex.scale, ex.out, ex.part,
                                           ex.counters, M, N, K, Kp, nblk, gps);
}

template <int BITS, typename T, int NC>
cudaError_t launch_dec(const T* x, const uint8_t* packed, const float* scales, float* out,
                       float* part, int* counters, int E, int M, int N, int K, int Kp,
                       int nblk, int aligned, int splits, cudaStream_t stream) {
  if (aligned)
    return dcmm::launch<bs_dec<BITS, T, true, NC>, BITS, T, true, NC>(
        x, packed, scales, out, part, counters, M, N, K, Kp, nblk, splits, stream, E);
  return dcmm::launch<bs_dec<BITS, T, false, NC>, BITS, T, true, NC>(
      x, packed, scales, out, part, counters, M, N, K, Kp, nblk, splits, stream, E);
}

// M > 16: N tiles along y, K splits along z.  Grouped (E > 1), expert
// blockIdx.x / (its M tiles); the plain call keeps its own instantiation,
// the M tile blockIdx.x and no offsets.
template <int BITS, typename T, bool ALIGNED, bool GROUPED>
__global__ void __launch_bounds__(tcmm::THREADS, tcmm::MIN_BLOCKS)
bs_tc(const T* __restrict__ x, const uint8_t* __restrict__ packed,
      const float* __restrict__ scales, float* __restrict__ out, int M, int N, int K,
      int Kp, int nblk, int gps) {
  if constexpr (GROUPED) {
    // out is the split scratch when gridDim.z > 1: (E, splits, M, N)
    const int mtiles = (M + tcmm::BM - 1) / tcmm::BM;
    const int e = blockIdx.x / mtiles;
    const dcmm::Expert<T> ex(x, packed, scales, out, nullptr, nullptr, e, M, N, K, Kp,
                             static_cast<size_t>(N) * nblk, 0, 0);
    tcmm::gemm<BITS, T, true, ALIGNED>(ex.x, ex.packed, ex.scale,
                                       out + static_cast<size_t>(e) * gridDim.z * M * N,
                                       M, N, K, Kp, nblk, gps, blockIdx.x - e * mtiles);
  } else {
    tcmm::gemm<BITS, T, true, ALIGNED>(x, packed, scales, out, M, N, K, Kp, nblk, gps,
                                       blockIdx.x);
  }
}

__global__ void bs_tc_reduce(const float* __restrict__ part, const float* __restrict__ scales,
                             float* __restrict__ out, int M, int N, int splits) {
  tcmm::reduce<true>(part, scales, out, M, N, splits);
}

template <int BITS, typename T, bool ALIGNED>
cudaError_t launch_tc(const T* x, const uint8_t* packed, const float* scales, float* out,
                      float* part, int E, int M, int N, int K, int Kp, int nblk, int splits,
                      cudaStream_t stream) {
  if (E > 1)
    return tcmm::launch<bs_tc<BITS, T, ALIGNED, true>, bs_tc_reduce, BITS, T, true>(
        x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream, E);
  return tcmm::launch<bs_tc<BITS, T, ALIGNED, false>, bs_tc_reduce, BITS, T, true>(
      x, packed, scales, out, part, M, N, K, Kp, nblk, splits, stream);
}

template <int BITS, typename T>
int launch(const T* x, const uint8_t* packed, const float* scales, float* out,
           float* part, int* counters, int E, int M, int N, int K, int Kp, int nblk,
           int aligned, int splits, cudaStream_t stream) {
  if (M <= dcmm::MAX_M) {
    const int cols = tcmm::passes<T>() * M;   // f32 x's hi and lo parts, or bf16 x
    if (cols <= 8)
      return static_cast<int>(launch_dec<BITS, T, 1>(x, packed, scales, out, part, counters, E,
                                                     M, N, K, Kp, nblk, aligned, splits,
                                                     stream));
    if (cols <= 16)
      return static_cast<int>(launch_dec<BITS, T, 2>(x, packed, scales, out, part, counters, E,
                                                     M, N, K, Kp, nblk, aligned, splits,
                                                     stream));
    if constexpr (tcmm::passes<T>() == 2)
      return static_cast<int>(launch_dec<BITS, T, 4>(x, packed, scales, out, part, counters, E,
                                                     M, N, K, Kp, nblk, aligned, splits,
                                                     stream));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (aligned)
    return static_cast<int>(launch_tc<BITS, T, true>(x, packed, scales, out, part, E, M, N, K,
                                                     Kp, nblk, splits, stream));
  return static_cast<int>(launch_tc<BITS, T, false>(x, packed, scales, out, part, E, M, N, K,
                                                    Kp, nblk, splits, stream));
}

template <typename T>
int launch_bits(const void* x, const void* packed, const void* scales, void* out, void* part,
                void* counters, int E, int M, int N, int K, int Kp, int nblk, int bits,
                int aligned, int splits, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  int* cp = static_cast<int*>(counters);
  switch (bits) {
    case 2: return launch<2>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp, nblk, aligned, splits, s);
    case 4: return launch<4>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp, nblk, aligned, splits, s);
    case 8: return launch<8>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp, nblk, aligned, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// E problems of one shape in one launch (the MoE experts; E = 1 for the
// plain call): x (E, M, K) f32 (x_is_bf16 = 0) or bf16, packed (E, N, Kp),
// scales (E, N, nblk), out (E, M, N) f32; part, counters and aligned: as
// for qmatmul_f32_launch
extern "C" int qmatmul_blockscale_launch(const void* x, int x_is_bf16, const void* packed,
                                         const void* scales, void* out, void* part,
                                         void* counters, int E, int M, int N, int K, int Kp,
                                         int nblk, int bits, int aligned, int splits,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits<__nv_bfloat16>(x, packed, scales, out, part, counters, E, M, N, K, Kp,
                                      nblk, bits, aligned, splits, s);
  return launch_bits<float>(x, packed, scales, out, part, counters, E, M, N, K, Kp, nblk, bits,
                            aligned, splits, s);
}

// both loops' geometry (dcmm::geometry), ten ints
extern "C" void qmatmul_blockscale_tc_geometry(int* g) { dcmm::geometry(g); }
