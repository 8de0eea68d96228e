// Mamba-1 selective scan for Hopper (sm_90a), f32 or bf16 inputs, f32 inside,
// with the state kept in registers.
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
//   pointer is __restrict__.  A position with dt = 0 (a pad of bucketed
//   prefill) gives exp2(0) = 1 and a zero update, so it leaves h unchanged.
//
// What bounds it on this card: every (b, t, d) reads x and dt and writes y
//   once, and the state is read (h0) and written (h_last) once: at the
//   falcon-mamba prefill shape (4, 64, 8192) with N = 16 that is about 30 MB,
//   8.9 us at 3.35 TB/s, against 33.5 M exponentials, 8.0 us on the SFUs
//   (16 a clock per SM).  Decode (S = 1) moves mostly h: about 1.5 us.
//
// What the design does about it: the TPU kernel expands (chunk, di_block, N)
//   in VMEM and runs an associative scan over it; here nothing is expanded.
//   Each channel d is owned by G neighbouring lanes (1, 2, 4 or 8), each
//   holding N / G states and their A in registers, and a thread walks t in a
//   loop; y is reduced over the G lanes by xor-shuffles.  One MUFU op a state
//   step: A is scaled by log2(e) once, into registers, and each step takes
//   ex2.approx(dt * A log2(e)); ex2.approx(0) is exactly 1, so pads stay
//   no-ops.  Two routes, chosen by S in kernels/ssm_scan.py::scan_plan:
//   - scan_step (decode, small S): no shared memory and no barrier.  Each
//     thread issues its loads of h0, A, D and the step's x, dt, B and C row
//     together, then computes and writes y and h_last;
//   - scan_chunked (prefill): a block covers CH channels of one batch row.
//     x, dt and the B and C rows of a chunk of T steps go through a 3-stage
//     cp.async ring in shared memory (16 B copies where Di allows, else 4 B),
//     so chunk c + 1 and c + 2 arrive while chunk c runs; the h0 and A loads
//     are issued right after the first stages, one barrier a chunk.
//
// bf16 inputs (the Pallas kernel's bf16 contract: bf16 x, dt, B and C, f32 A
//   and D, f32 inside, y in x's dtype): both routes are templated on the
//   input type T.  x, dt, B and C are read (and the chunked route's ring
//   carries them) as bf16, half the bytes the kernel streams, and are widened
//   to f32 in registers; A, D, h0 and h_last stay f32, and y is written as
//   bf16 (or f32, for a model whose activations are f32).  The ring's x and dt rows take 16 B copies of 8 channels where Di
//   allows (else plain loads), the B and C rows 8 B copies of 4 states.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 3;            // scan_chunked's ring depth
constexpr int MAX_THREADS = 256;     // a block, either route (launch bounds)
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NPT consecutive floats from p (aligned to 4 NPT bytes, up to 16 B)
template <int NPT>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[NPT]) {
  if constexpr (NPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NPT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
  } else if constexpr (NPT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = p[0];
  }
}

// NPT consecutive bf16 from p (aligned to 2 NPT bytes), widened to f32
template <int NPT>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&r)[NPT]) {
  if constexpr (NPT % 8 == 0) {
#pragma unroll
    for (int i = 0; i < NPT; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        r[i + 2 * j] = f.x;
        r[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (NPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    r[0] = f0.x; r[1] = f0.y; r[2] = f1.x; r[3] = f1.y;
  } else if constexpr (NPT == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    r[0] = f.x; r[1] = f.y;
  } else {
    r[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

template <int NPT>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[NPT]) {
  if constexpr (NPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NPT; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  } else if constexpr (NPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// one step of the recurrence for this lane's NPT states; returns the
// channel's y_t - x_t D, summed over its G lanes
template <int NPT, int G>
__device__ __forceinline__ float step(float (&h)[NPT], const float (&a2)[NPT], float xv, float dv,
                                      const float (&Bv)[NPT], const float (&Cv)[NPT]) {
  const float dx = dv * xv;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    h[i] = fmaf(ex2(dv * a2[i]), h[i], dx * Bv[i]);
    acc = fmaf(h[i], Cv[i], acc);
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// the lane's states (zero without h0) and A * log2(e)
template <int N, int G>
__device__ __forceinline__ void load_state(const float* h0, const float* __restrict__ A,
                                           size_t hrow, int d, int j, float (&h)[N / G],
                                           float (&a2)[N / G]) {
  constexpr int NPT = N / G;
  load_vec<NPT>(A + static_cast<size_t>(d) * N + j * NPT, a2);
  if (h0 != nullptr) {
    load_vec<NPT>(h0 + hrow, h);
  } else {
#pragma unroll
    for (int i = 0; i < NPT; ++i) h[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NPT; ++i) a2[i] *= LOG2E;
}

// T: x, dt, B and C (float or __nv_bfloat16); Y: y (T or float); A, D,
// h0 and h_last f32
template <typename T, typename Y>
struct Args {
  const T* x;
  const T* dt;
  const float* A;
  const T* B;
  const T* C;
  const float* D;
  const float* h0;
  Y* y;
  float* h_last;
  int Bz, S, Di;
};

// decode route: thread (b, d, j) of a flat grid, loads straight to registers
template <int N, int G, typename T, typename Y>
__global__ void __launch_bounds__(MAX_THREADS)
scan_step(const Args<T, Y> a) {
  constexpr int NPT = N / G;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int j = static_cast<int>(idx % G);
  const long bd = idx / G;
  const bool live = bd < static_cast<long>(a.Bz) * a.Di;   // others only shuffle
  const int d = live ? static_cast<int>(bd % a.Di) : 0;
  const int b = live ? static_cast<int>(bd / a.Di) : 0;
  const size_t hrow = (static_cast<size_t>(b) * a.Di + d) * N + j * NPT;
  float h[NPT], a2[NPT];
  load_state<N, G>(a.h0, a.A, hrow, d, j, h, a2);
  const float dd = a.D[d];
  for (int t = 0; t < a.S; ++t) {
    const size_t row = static_cast<size_t>(b) * a.S + t;
    const float xv = to_f32(a.x[row * a.Di + d]), dv = to_f32(a.dt[row * a.Di + d]);
    float Bv[NPT], Cv[NPT];
    load_vec<NPT>(a.B + row * N + j * NPT, Bv);
    load_vec<NPT>(a.C + row * N + j * NPT, Cv);
    const float acc = step<NPT, G>(h, a2, xv, dv, Bv, Cv);
    if (live && j == 0) a.y[row * a.Di + d] = from_f32<Y>(acc + xv * dd);
  }
  if (live) store_vec<NPT>(a.h_last + hrow, h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(in ? BYTES : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// elements of a ring stage: x and dt (T x CH), B and C (T x N)
__host__ __device__ constexpr int stage_elems(int T, int CH, int N) {
  return 2 * T * CH + 2 * T * N;
}

// prefill route: block (channel tile, b) of CH x G threads, chunks of T steps
// through the ring; vec: x and dt rows take 16 B copies (Di a multiple of
// 16 B of channels)
template <int N, int G, typename E, typename Y>
__global__ void __launch_bounds__(MAX_THREADS)
scan_chunked(const Args<E, Y> a, int T, int vec) {
  constexpr int NPT = N / G;
  constexpr int EV = 16 / static_cast<int>(sizeof(E));   // elements a 16 B copy
  constexpr int BC = 4 * static_cast<int>(sizeof(E));    // bytes a copy of 4 B or C states
  extern __shared__ __align__(16) float smf[];
  E* sm = reinterpret_cast<E*>(smf);
  const int CH = blockDim.x / G;
  const int sf = stage_elems(T, CH, N);
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, c = tid / G, j = tid % G, d = d0 + c;
  const bool live = d < a.Di;
  const size_t hrow = (static_cast<size_t>(b) * a.Di + (live ? d : 0)) * N + j * NPT;
  const int chunks = (a.S + T - 1) / T;

  auto load_chunk = [&](int ci) {
    E* xs = sm + (ci % STAGES) * sf;
    E* dts = xs + T * CH;
    E* Bs = dts + T * CH;
    E* Cs = Bs + T * N;
    const int t0 = ci * T, tn = min(T, a.S - t0);
    const size_t row0 = static_cast<size_t>(b) * a.S + t0;
    if (vec) {
      const int q = CH / EV;
      for (int e = tid; e < tn * q; e += blockDim.x) {
        const int tt = e / q, cc = EV * (e % q);
        const bool in = d0 + cc < a.Di;
        const size_t off = in ? (row0 + tt) * a.Di + d0 + cc : 0;
        cp_async<16>(xs + tt * CH + cc, a.x + off, in);
        cp_async<16>(dts + tt * CH + cc, a.dt + off, in);
      }
    } else {
      for (int e = tid; e < tn * CH; e += blockDim.x) {
        const int tt = e / CH, cc = e % CH;
        const bool in = d0 + cc < a.Di;
        const size_t off = in ? (row0 + tt) * a.Di + d0 + cc : 0;
        if constexpr (sizeof(E) == 4) {
          cp_async<4>(xs + tt * CH + cc, a.x + off, in);
          cp_async<4>(dts + tt * CH + cc, a.dt + off, in);
        } else {
          // no 2 B cp.async: plain loads, seen by the next chunk's barrier
          xs[tt * CH + cc] = in ? a.x[off] : E();
          dts[tt * CH + cc] = in ? a.dt[off] : E();
        }
      }
    }
    for (int e = tid; e < tn * (N / 4); e += blockDim.x) {
      const size_t off = row0 * N + 4 * e;
      cp_async<BC>(Bs + 4 * e, a.B + off, true);
      cp_async<BC>(Cs + 4 * e, a.C + off, true);
    }
  };

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < chunks) load_chunk(p);
    cp_commit();
  }
  float h[NPT], a2[NPT];
  load_state<N, G>(a.h0, a.A, hrow, live ? d : 0, j, h, a2);
  const float dd = a.D[live ? d : 0];

  for (int ci = 0; ci < chunks; ++ci) {
    cp_wait<STAGES - 2>();
    __syncthreads();                 // chunk ci landed; chunk ci - 1 is consumed
    if (ci + STAGES - 1 < chunks) load_chunk(ci + STAGES - 1);
    cp_commit();
    const E* xs = sm + (ci % STAGES) * sf;
    const E* dts = xs + T * CH;
    const E* Bs = dts + T * CH;
    const E* Cs = Bs + T * N;
    const int t0 = ci * T, tn = min(T, a.S - t0);
    Y* yrow = a.y + (static_cast<size_t>(b) * a.S + t0) * a.Di + d;
#pragma unroll 4
    for (int tt = 0; tt < tn; ++tt) {
      const float xv = to_f32(xs[tt * CH + c]), dv = to_f32(dts[tt * CH + c]);
      float Bv[NPT], Cv[NPT];
      load_vec<NPT>(Bs + tt * N + j * NPT, Bv);
      load_vec<NPT>(Cs + tt * N + j * NPT, Cv);
      const float acc = step<NPT, G>(h, a2, xv, dv, Bv, Cv);
      if (live && j == 0) yrow[static_cast<size_t>(tt) * a.Di] = from_f32<Y>(acc + xv * dd);
    }
  }
  cp_wait<0>();
  if (live) store_vec<NPT>(a.h_last + hrow, h);
}

// route 0: scan_step, block threads a block; route 1: scan_chunked, block
// channels a block (a multiple of 16 B of channels: 4 f32, 8 bf16), chunk
// steps a ring stage (each stage's B and C rows whole 16 B)
template <int N, int G, typename T, typename Y>
int launch(const Args<T, Y>& a, int route, int block, int chunk, int vec, cudaStream_t s) {
  constexpr int EV = 16 / static_cast<int>(sizeof(T));
  if (route == 0) {
    if (block < 32 || block > MAX_THREADS || block % 32)
      return static_cast<int>(cudaErrorInvalidValue);
    const long threads = static_cast<long>(a.Bz) * a.Di * G;
    scan_step<N, G, T, Y><<<static_cast<unsigned>((threads + block - 1) / block), block, 0,
                            s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_chunked<N, G, T, Y>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = STAGES * stage_elems(chunk, block, N) * static_cast<int>(sizeof(T));
  if (route != 1 || block % EV || block * G > MAX_THREADS || (block * G) % 32 || chunk < 1 ||
      (chunk * N) % EV || smem > MAX_SMEM || a.Bz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Di + block - 1) / block, a.Bz);
  scan_chunked<N, G, T, Y><<<grid, block * G, smem, s>>>(a, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename T, typename Y>
int launch_n(const Args<T, Y>& a, int lanes, int route, int block, int chunk, int vec,
             cudaStream_t s) {
  switch (lanes) {
    case 1: if constexpr (N <= 16) return launch<N, 1>(a, route, block, chunk, vec, s);
            return static_cast<int>(cudaErrorInvalidValue);
    case 2: return launch<N, 2>(a, route, block, chunk, vec, s);
    case 4: return launch<N, 4>(a, route, block, chunk, vec, s);
    case 8: if constexpr (N >= 8) return launch<N, 8>(a, route, block, chunk, vec, s);
            [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename Y>
int launch_t(const void* x, const void* dt, const void* A, const void* B, const void* C,
             const void* D, const void* h0, void* y, void* h_last, int Bz, int S, int Di, int N,
             int route, int lanes, int block, int chunk, int vec, cudaStream_t s) {
  const Args<T, Y> a{static_cast<const T*>(x), static_cast<const T*>(dt),
                     static_cast<const float*>(A), static_cast<const T*>(B),
                     static_cast<const T*>(C), static_cast<const float*>(D),
                     static_cast<const float*>(h0), static_cast<Y*>(y),
                     static_cast<float*>(h_last), Bz, S, Di};
  switch (N) {
    case 4: return launch_n<4>(a, lanes, route, block, chunk, vec, s);
    case 8: return launch_n<8>(a, lanes, route, block, chunk, vec, s);
    case 16: return launch_n<16>(a, lanes, route, block, chunk, vec, s);
    case 32: return launch_n<32>(a, lanes, route, block, chunk, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// h0 may be null (zero initial state) and h_last may equal h0.  N must be 4,
// 8, 16 or 32; lanes (G) 1, 2, 4 or 8 with 1 <= N / G <= 16.  route, block and chunk as
// kernels/ssm_scan.py::scan_plan gives them; vec: Di a multiple of 16 B of
// channels and x, dt on 16 B.  bf16: x, dt, B and C are bf16 (else f32), and
// y is bf16 unless y_f32 (a model that scans in bf16 but keeps f32
// activations, as the reference's scan returns f32 y there).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* D, const void* h0, void* y,
                               void* h_last, int Bz, int S, int Di, int N, int bf16, int y_f32,
                               int route, int lanes, int block, int chunk, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_t<float, float>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, N, route, lanes,
                                  block, chunk, vec, s);
  if (y_f32)
    return launch_t<__nv_bfloat16, float>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, N, route,
                                          lanes, block, chunk, vec, s);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, D, h0, y, h_last, Bz, S, Di, N,
                                                route, lanes, block, chunk, vec, s);
}
