// Mamba-1 selective scan for Hopper (sm_90a), f32, with the state kept in
// registers.
//
// Replaces: src/repro/kernels/ssm_scan.py:64 :: selective_scan_fused (Pallas
//   body _scan_kernel), extended to what serving needs: an optional initial
//   state h0 in and the final state h_last out.  For x, dt (Bz, S, Di),
//   A (Di, N), B, C (Bz, S, N), D (Di,), all f32 and contiguous:
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * B_t) * x_t      (per d, n)
//     y_t = sum_n h_t[n] * C_t[n] + x_t * D
//   with h_{-1} = h0 (zero when h0 is null).  Writes y (Bz, S, Di) and
//   h_last (Bz, Di, N).  h_last may be h0 itself (the serve cache's state,
//   updated in place): each thread reads its own h0 elements before the
//   time loop and writes the same h_last elements after it, so neither
//   pointer is __restrict__.  A position with dt = 0 (a pad of bucketed prefill)
//   gives exp(0) = 1 and a zero update, so it leaves h unchanged.
//
// What bounds it on this card: every (b, t, d) reads x and dt and writes y
//   once, and the state is read (h0) and written (h_last) once: at the
//   falcon-mamba prefill shape (4, 64, 8192) with N = 16 that is about 30 MB,
//   8.9 us at 3.35 TB/s, against 33.5 M exponentials, 8.0 us on the SFUs
//   (16 a clock per SM).  Decode (S = 1) moves mostly h: about 1.5 us.
//
// What the design does about it: the TPU kernel expands (chunk, di_block, N)
//   in VMEM and runs an associative scan over it; here nothing is expanded.
//   Each channel d is owned by G = 4 neighbouring lanes, each holding N / 4
//   states and their A in registers, and the block walks t in a loop.  One
//   block covers 32 channels of one batch row (128 threads).  Per chunk of 32
//   time steps it stages x and dt (coalesced along Di, one 128-byte row a
//   step) and the B and C rows that every channel reads into shared memory,
//   runs the recurrence from there, reduces y over the 4 lanes with two
//   xor-shuffles and writes the chunk of y back coalesced.  expf, not the
//   faster __expf, so that the scan stays within the reference's tolerance
//   and exp(0) is exactly 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 4;                 // lanes per channel
constexpr int CH = 32;               // channels per block
constexpr int THREADS = CH * G;
constexpr int T = 32;                // time steps per staged chunk
constexpr unsigned FULL = 0xffffffffu;

template <int NPT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ C, const float* __restrict__ D,
             const float* h0, float* __restrict__ y, float* h_last, int S,
             int Di) {
  constexpr int N = G * NPT;
  __shared__ float xs[T][CH];
  __shared__ float dts[T][CH];
  __shared__ float ys[T][CH];
  __shared__ float Bs[T][N];
  __shared__ float Cs[T][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / G;             // channel within the block
  const int j = tid % G;             // this lane's share of the N states
  const int d = d0 + c;
  const bool live = d < Di;
  const size_t hrow = (static_cast<size_t>(b) * Di + d) * N + j * NPT;

  float a[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    a[i] = live ? A[static_cast<size_t>(d) * N + j * NPT + i] : 0.f;
    h[i] = (live && h0 != nullptr) ? h0[hrow + i] : 0.f;
  }
  const float dd = live ? D[d] : 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int tn = min(T, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    for (int e = tid; e < T * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      float xv = 0.f, dv = 0.f;
      if (tt < tn && d0 + cc < Di) {
        const size_t off = (row0 + tt) * Di + d0 + cc;
        xv = x[off];
        dv = dt[off];
      }
      xs[tt][cc] = xv;
      dts[tt][cc] = dv;
    }
    for (int e = tid; e < T * N; e += THREADS) {
      const int tt = e / N, nn = e % N;
      float bv = 0.f, cv = 0.f;
      if (tt < tn) {
        const size_t off = (row0 + tt) * N + nn;
        bv = B[off];
        cv = C[off];
      }
      Bs[tt][nn] = bv;
      Cs[tt][nn] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const float xv = xs[tt][c];
      const float dv = dts[tt][c];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int n = j * NPT + i;
        const float dA = expf(dv * a[i]);
        const float dBx = dv * Bs[tt][n] * xv;
        h[i] = dA * h[i] + dBx;
        acc += h[i] * Cs[tt][n];
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      if (j == 0) ys[tt][c] = acc + xv * dd;
    }
    __syncthreads();

    for (int e = tid; e < tn * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      if (d0 + cc < Di) y[(row0 + tt) * Di + d0 + cc] = ys[tt][cc];
    }
    // the next chunk's staging writes xs, dts, Bs and Cs only, and its
    // compute (which writes ys) starts after the next __syncthreads
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) h_last[hrow + i] = h[i];
  }
}

template <int NPT>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* h_last,
           int Bz, int S, int Di, cudaStream_t stream) {
  dim3 grid((Di + CH - 1) / CH, Bz);
  ssm_scan_fwd<NPT><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), S, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h0 may be null (zero initial state) and h_last may equal h0.  N must be
// 4, 8, 16 or 32.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* h0, void* y, void* h_last, int Bz,
                               int S, int Di, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<1>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, s);
    case 8: return launch<2>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, s);
    case 16: return launch<4>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, s);
    case 32: return launch<8>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
