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
// What bounds it on this card: decode calls it with M = batch slots (4), where
//   its time is the packed weight bytes over the 3.35 TB/s of device memory;
//   prefill calls it with M = slots x bucket (256 and up), where the
//   multiply-adds bind: 67 TFLOP/s in f32 on the CUDA cores, 495 TFLOP/s in
//   TF32 on the tensor cores.
//
// What the design does about it: the packed weight is read from device memory
//   as it is stored and never expanded there; fields are unpacked in registers
//   next to the multiply-adds (the At-MRAM point of qmatmul.py).  M <= 16
//   takes the decode loop of csrc/qmm_decode.cuh: the weights stream once
//   through a cp.async ring and meet x on the tensor cores with the levels on
//   the MMA's M side (TF32, x's hi and lo parts as the 8-wide B), K split over
//   blocks and the slices added by the last block, in one launch.  Larger M
//   takes the tensor-core main loop of csrc/qmm_tc.cuh (two TF32 passes for
//   f32 x, one for bf16 x, per-32 groups promoted into f32, a cp.async ring of
//   x and packed bytes, K split over blocks when the output tiles alone would
//   leave SMs idle); its note says why that keeps f32 accuracy.  Both mask
//   k >= K, so ragged K (not a multiple of f or of a group) is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_decode.cuh"
#include "qmm_tc.cuh"

namespace {

template <int BITS, typename T, bool ALIGNED, int NC>
__global__ void __launch_bounds__(dcmm::THREADS, dcmm::MIN_BLOCKS)
qmm_dec(const T* __restrict__ x, const uint8_t* __restrict__ packed,
        const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ part,
        int* __restrict__ counters, int M, int N, int K, int Kp, int nblk, int gps) {
  dcmm::decode<BITS, T, false, ALIGNED, NC>(x, packed, scale, out, part, counters, M, N, K, Kp,
                                            nblk, gps);
}

template <int BITS, typename T, int NC>
cudaError_t launch_dec(const T* x, const uint8_t* packed, const float* scale, float* out,
                       float* part, int* counters, int M, int N, int K, int Kp, int aligned,
                       int splits, cudaStream_t stream) {
  if (aligned)
    return dcmm::launch<qmm_dec<BITS, T, true, NC>, BITS, T, false, NC>(
        x, packed, scale, out, part, counters, M, N, K, Kp, 0, splits, stream);
  return dcmm::launch<qmm_dec<BITS, T, false, NC>, BITS, T, false, NC>(
      x, packed, scale, out, part, counters, M, N, K, Kp, 0, splits, stream);
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
           void* counters, int M, int N, int K, int Kp, int aligned, int splits,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  int* cp = static_cast<int*>(counters);
  if (M <= dcmm::MAX_M) {
    const int cols = tcmm::passes<T>() * M;
    if (cols <= 8)
      return static_cast<int>(
          launch_dec<BITS, T, 1>(xp, wp, sp, op, pp, cp, M, N, K, Kp, aligned, splits, stream));
    if constexpr (tcmm::passes<T>() == 2) {
      if (cols > 16)
        return static_cast<int>(launch_dec<BITS, T, 4>(xp, wp, sp, op, pp, cp, M, N, K, Kp,
                                                       aligned, splits, stream));
    }
    return static_cast<int>(
        launch_dec<BITS, T, 2>(xp, wp, sp, op, pp, cp, M, N, K, Kp, aligned, splits, stream));
  }
  if (aligned)
    return static_cast<int>(tcmm::launch<qmm_tc<BITS, T, true>, qmm_tc_reduce, BITS, T, false>(
        xp, wp, sp, op, pp, M, N, K, Kp, 0, splits, stream));
  return static_cast<int>(tcmm::launch<qmm_tc<BITS, T, false>, qmm_tc_reduce, BITS, T, false>(
      xp, wp, sp, op, pp, M, N, K, Kp, 0, splits, stream));
}

template <typename T>
int launch_bits(const void* x, const void* packed, const void* scale, void* out, void* part,
                void* counters, int M, int N, int K, int Kp, int bits, int aligned, int splits,
                cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, T>(x, packed, scale, out, part, counters, M, N, K, Kp, aligned, splits, stream);
    case 4: return launch<4, T>(x, packed, scale, out, part, counters, M, N, K, Kp, aligned, splits, stream);
    case 8: return launch<8, T>(x, packed, scale, out, part, counters, M, N, K, Kp, aligned, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part: f32 scratch when splits > 1, else null: (splits, M, N) for M > 16,
// (splits, N, M rounded up to 4) for M <= 16, where counters is one zeroed
// int an N tile of 128 rows (left zeroed); aligned: the route's rows are 16 B
// aligned (kernels/qmatmul.py decides it and splits)
extern "C" int qmatmul_f32_launch(const void* x, int x_is_bf16, const void* packed,
                                  const void* scale, void* out, void* part, void* counters,
                                  int M, int N, int K, int Kp, int bits, int aligned,
                                  int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits<__nv_bfloat16>(x, packed, scale, out, part, counters, M, N, K, Kp, bits,
                                      aligned, splits, s);
  return launch_bits<float>(x, packed, scale, out, part, counters, M, N, K, Kp, bits, aligned,
                            splits, s);
}

// both loops' geometry (dcmm::geometry), ten ints
extern "C" void qmatmul_f32_tc_geometry(int* g) { dcmm::geometry(g); }
