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
//
// Grouped over experts (kernels/qmatmul.py :: qmatmul_f32_grouped; replaces
//   the vmapped qmatmul_f32 of src/repro/models/moe.py :: expert_ffn, one
//   Pallas launch whose grid gains the expert axis): E problems of one shape,
//   x (E, C, K) against packed (E, N, Kp) and scale (E, N), in one launch of
//   the same loops.  The decode kernel takes the expert from blockIdx.y (the
//   plain call is E = 1), the tensor-core kernel's grouped instantiation
//   from blockIdx.x over the expert's M tiles (the plain call keeps an
//   instantiation without the expert arithmetic, which slowed its
//   register-bound main loop), and each block offsets its operands by the
//   expert's strides.  Every expert is
//   computed, its empty capacity rows included, as the reference does.  At qwen2-moe-a2.7b's decode (E = 60, C = 8) one
//   layer's three expert linears read 519 MB of 8-bit levels: the bytes over
//   the 3.35 TB/s of device memory bound them, at 0.155 ms a layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_decode.cuh"
#include "qmm_tc.cuh"

namespace {

// decode: expert blockIdx.y, its N tiles along x, its K splits along z
template <int BITS, typename T, bool ALIGNED, int NC>
__global__ void __launch_bounds__(dcmm::THREADS, dcmm::MIN_BLOCKS)
qmm_dec(const T* __restrict__ x, const uint8_t* __restrict__ packed,
        const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ part,
        int* __restrict__ counters, int M, int N, int K, int Kp, int nblk, int gps) {
  const dcmm::Expert<T> ex(x, packed, scale, out, part, counters, blockIdx.y, M, N, K, Kp, N,
                           static_cast<size_t>(gridDim.z) * N * ((M + 3) & ~3), gridDim.x);
  dcmm::decode<BITS, T, false, ALIGNED, NC>(ex.x, ex.packed, ex.scale, ex.out, ex.part,
                                            ex.counters, M, N, K, Kp, nblk, gps);
}

template <int BITS, typename T, int NC>
cudaError_t launch_dec(const T* x, const uint8_t* packed, const float* scale, float* out,
                       float* part, int* counters, int E, int M, int N, int K, int Kp,
                       int aligned, int splits, cudaStream_t stream) {
  if (aligned)
    return dcmm::launch<qmm_dec<BITS, T, true, NC>, BITS, T, false, NC>(
        x, packed, scale, out, part, counters, M, N, K, Kp, 0, splits, stream, E);
  return dcmm::launch<qmm_dec<BITS, T, false, NC>, BITS, T, false, NC>(
      x, packed, scale, out, part, counters, M, N, K, Kp, 0, splits, stream, E);
}

__global__ void qmm_tc_reduce(const float* __restrict__ part, const float* __restrict__ scale,
                              float* __restrict__ out, int M, int N, int splits) {
  tcmm::reduce<false>(part, scale, out, M, N, splits);
}

// M > 16: N tiles along y, K splits along z.  Grouped (E > 1), expert
// blockIdx.x / (its M tiles), so an expert's M tiles run together; the plain
// call keeps its own instantiation, the M tile blockIdx.x and no offsets.
template <int BITS, typename T, bool ALIGNED, bool GROUPED>
__global__ void __launch_bounds__(tcmm::THREADS, tcmm::MIN_BLOCKS)
qmm_tc(const T* __restrict__ x, const uint8_t* __restrict__ packed,
       const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
       int Kp, int nblk, int gps) {
  if constexpr (GROUPED) {
    // out is the split scratch when gridDim.z > 1: (E, splits, M, N)
    const int mtiles = (M + tcmm::BM - 1) / tcmm::BM;
    const int e = blockIdx.x / mtiles;
    const dcmm::Expert<T> ex(x, packed, scale, out, nullptr, nullptr, e, M, N, K, Kp, N, 0,
                             0);
    tcmm::gemm<BITS, T, false, ALIGNED>(ex.x, ex.packed, ex.scale,
                                        out + static_cast<size_t>(e) * gridDim.z * M * N, M, N,
                                        K, Kp, nblk, gps, blockIdx.x - e * mtiles);
  } else {
    tcmm::gemm<BITS, T, false, ALIGNED>(x, packed, scale, out, M, N, K, Kp, nblk, gps,
                                        blockIdx.x);
  }
}

template <int BITS, typename T, bool ALIGNED>
cudaError_t launch_tc(const T* x, const uint8_t* packed, const float* scale, float* out,
                      float* part, int E, int M, int N, int K, int Kp, int splits,
                      cudaStream_t stream) {
  if (E > 1)
    return tcmm::launch<qmm_tc<BITS, T, ALIGNED, true>, qmm_tc_reduce, BITS, T, false>(
        x, packed, scale, out, part, M, N, K, Kp, 0, splits, stream, E);
  return tcmm::launch<qmm_tc<BITS, T, ALIGNED, false>, qmm_tc_reduce, BITS, T, false>(
      x, packed, scale, out, part, M, N, K, Kp, 0, splits, stream);
}

template <int BITS, typename T>
int launch(const void* x, const void* packed, const void* scale, void* out, void* part,
           void* counters, int E, int M, int N, int K, int Kp, int aligned, int splits,
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
      return static_cast<int>(launch_dec<BITS, T, 1>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp,
                                                     aligned, splits, stream));
    if constexpr (tcmm::passes<T>() == 2) {
      if (cols > 16)
        return static_cast<int>(launch_dec<BITS, T, 4>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp,
                                                       aligned, splits, stream));
    }
    return static_cast<int>(launch_dec<BITS, T, 2>(xp, wp, sp, op, pp, cp, E, M, N, K, Kp,
                                                   aligned, splits, stream));
  }
  if (aligned)
    return static_cast<int>(launch_tc<BITS, T, true>(xp, wp, sp, op, pp, E, M, N, K, Kp, splits,
                                                     stream));
  return static_cast<int>(launch_tc<BITS, T, false>(xp, wp, sp, op, pp, E, M, N, K, Kp, splits,
                                                    stream));
}

template <typename T>
int launch_bits(const void* x, const void* packed, const void* scale, void* out, void* part,
                void* counters, int E, int M, int N, int K, int Kp, int bits, int aligned,
                int splits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, T>(x, packed, scale, out, part, counters, E, M, N, K, Kp, aligned, splits, stream);
    case 4: return launch<4, T>(x, packed, scale, out, part, counters, E, M, N, K, Kp, aligned, splits, stream);
    case 8: return launch<8, T>(x, packed, scale, out, part, counters, E, M, N, K, Kp, aligned, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// E problems of one shape in one launch (the MoE experts; E = 1 for the
// plain call): x (E, M, K), packed (E, N, Kp), scale (E, N), out (E, M, N).
// part: f32 scratch when splits > 1, else null: (E, splits, M, N) for M > 16,
// (E, splits, N, M rounded up to 4) for M <= 16, where counters is one zeroed
// int an N tile of 128 rows and expert (left zeroed); aligned: the route's
// rows are 16 B aligned (kernels/qmatmul.py decides it and splits)
extern "C" int qmatmul_f32_launch(const void* x, int x_is_bf16, const void* packed,
                                  const void* scale, void* out, void* part, void* counters,
                                  int E, int M, int N, int K, int Kp, int bits, int aligned,
                                  int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits<__nv_bfloat16>(x, packed, scale, out, part, counters, E, M, N, K, Kp,
                                      bits, aligned, splits, s);
  return launch_bits<float>(x, packed, scale, out, part, counters, E, M, N, K, Kp, bits,
                            aligned, splits, s);
}

// both loops' geometry (dcmm::geometry), ten ints
extern "C" void qmatmul_f32_tc_geometry(int* g) { dcmm::geometry(g); }
