// Integer N-EUREKA matmul for Hopper (sm_90a): uint8 activations x packed
// signed weight levels -> int32 accumulators -> NORMQUANT requant -> uint8.
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
//   12,544 (a 112 x 112 map), K and N from 16 to 1,280.  Every job moves a few
//   hundred KB to a few MB and does at most ~60 M multiply-adds, so against the
//   H100's int8 tensor-core rate each one is bound by its bytes; what it really
//   pays on this simple design is the int32 dp4a rate of the CUDA cores and, for
//   the small jobs, launch latency and too few blocks.
//
// What the design does about it: the packed weights are read as they are
//   stored and unpacked in registers into signed bytes, four K steps to a 32-bit
//   word, which dp4a (u8 x s8, inline PTX) multiplies against four activation
//   bytes and adds into an int32 sum; fields past K are masked to zero, so
//   ragged K is exact.  Large jobs take a 64 x 64 output tile per block, with x
//   and the unpacked weights staged 32 K steps at a time in shared memory and a
//   4 x 4 sub-tile per thread; its time grows with the number of K steps.  Jobs
//   with a long K and few outputs (the projections on the 28 x 28 to 7 x 7 maps,
//   the classifier) take a warp per (output channel, 8 rows) that streams the
//   packed row along K instead, so they spread over all SMs and split K over
//   the lanes.  Tensor cores (mma.sync / wgmma on s8) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 32, TPB = 256;   // tiled kernel
constexpr int KW = TK / 4;                             // dp4a words per K step
constexpr int ROWS = 8;                                // rows a streaming warp carries
constexpr int WARPS = 8;                               // warps per streaming block
// The streaming path is taken only where it keeps every lane busy (K >= 128:
// 32 lanes x 4 K steps) and its warps fit in one wave on the card (132 SMs x
// 32 resident warps at its 64 registers a thread).  On the MobileNet-V2 jobs at
// 224 that picks the faster of the two paths at every job but one, where the
// two are within 3 % (PERF.md).
constexpr int STREAM_MIN_K = 4 * 32;
constexpr long STREAM_MAX_WARPS = 132L * 32;

__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// NORMQUANT, float-rescale form of the reference (_requant_f32)
__device__ __forceinline__ uint8_t requant(int acc, float mult, int bias) {
  float y = rintf(__fmul_rn(__int2float_rn(acc), mult));
  y = __fadd_rn(y, __int2float_rn(bias));
  return static_cast<uint8_t>(fminf(fmaxf(y, 0.f), 255.f));
}

// four activation bytes x[k .. k+3] of one row as a word, zero past K
__device__ __forceinline__ uint32_t x_word(const uint8_t* __restrict__ xr, int k, int K,
                                           bool aligned) {
  if (aligned) return k < K ? __ldg(reinterpret_cast<const uint32_t*>(xr + k)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (k + q < K) v |= static_cast<uint32_t>(__ldg(xr + k + q)) << (8 * q);
  return v;
}

// four signed levels w[k .. k+3] of one packed row as s8 bytes, zero past K
template <int BITS>
__device__ __forceinline__ uint32_t w_word(const uint8_t* __restrict__ wr, int k, int K,
                                           bool aligned) {
  constexpr int F = 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kHalf = 1 << (BITS - 1);
  if (BITS == 8 && aligned)   // offset binary -> two's complement: flip the top bit
    return k < K ? __ldg(reinterpret_cast<const uint32_t*>(wr + k)) ^ 0x80808080u : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kk = k + q;
    if (kk < K) {
      const int lvl = static_cast<int>((__ldg(wr + kk / F) >> ((kk % F) * BITS)) & kMask) - kHalf;
      v |= (static_cast<uint32_t>(lvl) & 0xFFu) << (8 * q);
    }
  }
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(TPB)
qmm_int8_tiled(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ mult, const int* __restrict__ bias,
               uint8_t* __restrict__ out, int M, int N, int K, int Kp, bool aligned) {
  __shared__ uint32_t xs[KW][TM + 1];
  __shared__ uint32_t ws[KW][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int i = 0; i < (TM * KW) / TPB; ++i) {
      const int idx = tid + i * TPB;
      const int ml = idx / KW, kw = idx % KW;
      const int m = m0 + ml;
      xs[kw][ml] = m < M ? x_word(x + static_cast<size_t>(m) * K, k0 + 4 * kw, K, aligned) : 0u;
    }
#pragma unroll
    for (int i = 0; i < (TN * KW) / TPB; ++i) {
      const int idx = tid + i * TPB;
      const int nl = idx / KW, kw = idx % KW;
      const int n = n0 + nl;
      ws[kw][nl] = n < N ? w_word<BITS>(packed + static_cast<size_t>(n) * Kp, k0 + 4 * kw, K,
                                        aligned)
                         : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dp4a_us(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float mu = mult[n];
    const int bi = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) out[static_cast<size_t>(m) * N + n] = requant(acc[i][j], mu, bi);
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(WARPS * 32)
qmm_int8_stream(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
                const float* __restrict__ mult, const int* __restrict__ bias,
                uint8_t* __restrict__ out, int M, int N, int K, int Kp, bool aligned) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  const int m0 = blockIdx.y * ROWS;
  if (n >= N) return;
  const int rows = min(ROWS, M - m0);
  const uint8_t* wr = packed + static_cast<size_t>(n) * Kp;
  const uint8_t* xb = x + static_cast<size_t>(m0) * K;
  int acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0;
  for (int k = 4 * lane; k < K; k += 4 * 32) {
    const uint32_t w = w_word<BITS>(wr, k, K, aligned);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) acc[r] = dp4a_us(x_word(xb + static_cast<size_t>(r) * K, k, K, aligned), w,
                                     acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  if (lane == 0) {
    const float mu = mult[n];
    const int bi = bias[n];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) out[static_cast<size_t>(m0 + r) * N + n] = requant(acc[r], mu, bi);
  }
}

template <int BITS>
void launch(const uint8_t* x, const uint8_t* packed, const float* mult, const int* bias,
            uint8_t* out, int M, int N, int K, int Kp, bool aligned, cudaStream_t stream) {
  const long stream_warps = static_cast<long>(N) * ((M + ROWS - 1) / ROWS);
  if (K >= STREAM_MIN_K && stream_warps <= STREAM_MAX_WARPS) {
    dim3 grid((N + WARPS - 1) / WARPS, (M + ROWS - 1) / ROWS);
    qmm_int8_stream<BITS><<<grid, WARPS * 32, 0, stream>>>(x, packed, mult, bias, out, M, N, K,
                                                          Kp, aligned);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qmm_int8_tiled<BITS><<<grid, TPB, 0, stream>>>(x, packed, mult, bias, out, M, N, K, Kp,
                                                   aligned);
  }
}

}  // namespace

// x_aligned: K % 4 == 0 and x, packed start on 4-byte boundaries, so the
// activation rows (and 8-bit weight rows) are read as 32-bit words.
extern "C" int qmatmul_int8_launch(const void* x, const void* packed, const void* mult,
                                   const void* bias, void* out, int M, int N, int K, int Kp,
                                   int bits, int x_aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(packed);
  const float* mp = static_cast<const float*>(mult);
  const int* bp = static_cast<const int*>(bias);
  uint8_t* op = static_cast<uint8_t*>(out);
  const bool al = x_aligned != 0;
  switch (bits) {
    case 2: launch<2>(xp, wp, mp, bp, op, M, N, K, Kp, al, s); break;
    case 4: launch<4>(xp, wp, mp, bp, op, M, N, K, Kp, al, s); break;
    case 8: launch<8>(xp, wp, mp, bp, op, M, N, K, Kp, al, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
