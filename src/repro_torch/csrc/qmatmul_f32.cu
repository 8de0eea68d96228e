// Fused dequant matmul for Hopper (sm_90a): out = x @ unpack(packed)^T * scale.
//
// Replaces: src/repro/kernels/qmatmul.py :: qmatmul_f32 (Pallas body
//   _qmatmul_f32_kernel, unpack helper _unpack_block).
//
// Computes out[m, n] = scale[n] * sum_k x[m, k] * (field(packed[n, k / f], k % f)
//   - 2^(bits-1)), with f = 8 / bits fields per byte, little-endian within the
//   byte.  x is (M, K) f32 or bf16 (read as f32), packed is (N, ceil(K / f))
//   uint8, scale is (N,) f32, out is (M, N) f32.  The scale is applied once,
//   after the K reduction, as the reference does.
//
// What bounds it on this card: decode calls it with M = batch slots (4), a
//   GEMV whose time is the packed weight bytes over the 3.35 TB/s of device
//   memory; prefill calls it with M <= 256, where the f32 multiply-adds on the
//   CUDA cores (67 TFLOP/s) come close to the weight bytes.
//
// What the design does about it: the packed weight is read from device memory
//   once per output tile and never expanded there; fields are unpacked in
//   registers next to the multiply-adds (the At-MRAM point of qmatmul.py).
//   Small M takes a weight-streaming kernel: one warp per output channel reads
//   the packed row as 32-bit words, coalesced along K, and carries all M rows'
//   sums at once, so each weight byte is loaded once.  Larger M takes a
//   64 x 64 output tile per block: x and the unpacked levels are staged in
//   shared memory 32 K-steps at a time and each thread accumulates a 4 x 4
//   strided sub-tile.  Both mask k >= K, so ragged K (not a multiple of f or of
//   the tile) is exact.  Accumulation is f32 on the CUDA cores (no TF32), so
//   the kernel matches the f32 plain version to reordering error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GEMV_ROWS = 8;     // x rows one weight-streaming block carries
constexpr int GEMV_WARPS = 8;    // output channels per block, one per warp
constexpr int GEMV_MAX_M = 16;   // largest M sent to the weight-streaming kernel
constexpr int TM = 64, TN = 64, TK = 32, TPB = 256;   // tiled kernel

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

template <int BITS, typename T>
__global__ void __launch_bounds__(TPB)
qmm_tiled(const T* __restrict__ x, const uint8_t* __restrict__ packed,
          const float* __restrict__ scale, float* __restrict__ out,
          int M, int N, int K, int Kp) {
  constexpr int F = 8 / BITS;
  // K-major tiles, one float of padding so the transposing stores of
  // consecutive k land in different banks
  __shared__ float xs[TK][TM + 1];
  __shared__ float ws[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int i = 0; i < (TM * TK) / TPB; ++i) {
      const int idx = tid + i * TPB;
      const int ml = idx / TK, kl = idx % TK;
      const int m = m0 + ml, k = k0 + kl;
      xs[kl][ml] = (m < M && k < K) ? to_f32(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (TN * TK) / TPB; ++i) {
      const int idx = tid + i * TPB;
      const int nl = idx / TK, kl = idx % TK;
      const int n = n0 + nl, k = k0 + kl;
      float w = 0.f;
      if (n < N && k < K)
        w = level<BITS>(__ldg(packed + static_cast<size_t>(n) * Kp + k / F), k % F);
      ws[kl][nl] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j] * scale[n];
    }
  }
}

template <int BITS, typename T>
void launch(const void* x, const void* packed, const void* scale, void* out,
            int M, int N, int K, int Kp, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= GEMV_MAX_M) {
    dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, (M + GEMV_ROWS - 1) / GEMV_ROWS);
    qmm_gemv<BITS, T><<<grid, GEMV_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, N, K, Kp);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qmm_tiled<BITS, T><<<grid, TPB, 0, stream>>>(xp, wp, sp, op, M, N, K, Kp);
  }
}

template <typename T>
int launch_bits(const void* x, const void* packed, const void* scale, void* out,
                int M, int N, int K, int Kp, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: launch<2, T>(x, packed, scale, out, M, N, K, Kp, stream); break;
    case 4: launch<4, T>(x, packed, scale, out, M, N, K, Kp, stream); break;
    case 8: launch<8, T>(x, packed, scale, out, M, N, K, Kp, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmatmul_f32_launch(const void* x, int x_is_bf16, const void* packed,
                                  const void* scale, void* out, int M, int N, int K,
                                  int Kp, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_bits<__nv_bfloat16>(x, packed, scale, out, M, N, K, Kp, bits, s);
  return launch_bits<float>(x, packed, scale, out, M, N, K, Kp, bits, s);
}
