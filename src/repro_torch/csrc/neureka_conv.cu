// N-EUREKA's two 3x3 operators for Hopper (sm_90a): dense and depthwise 3x3
// convolutions over HWC uint8 maps with packed 2/4/8-bit weights, int32
// accumulation and the NORMQUANT requant to uint8.
//
// Replaces: src/repro/kernels/neureka_conv.py :: conv3x3_dense (Pallas body
//   _dense3x3_kernel) and :: conv3x3_dw (_dw3x3_kernel).  The 1x1 operator has
//   no kernel of its own: it runs on qmatmul_int8.cu, as in the reference.
//
// Computes, for stride s in {1, 2}, Ho = ceil(H / s), Wo = ceil(W / s):
//   dense: out[h, w, co] = requant(sum_{i,j,ci} x[s*h+i-1, s*w+j-1, ci] * W[co, i, j, ci])
//          packed (Cout, 3, 3, ceil(Cin / f)): (co, i, j, ci) is byte ci / f, field ci % f
//   dw:    out[h, w, c]  = requant(sum_{i,j} x[s*h+i-1, s*w+j-1, c] * W[c, 3i + j])
//          packed (C, ceil(9 / f)) along the nine taps
//   with requant(a) = clip(rint(float(a) * mult) + bias, 0, 255).  Input rows and
//   columns outside the map read as zero: the reference pads one row and column
//   above and left and at most one below and right, and no padded copy is made
//   here.  The sums are exact in int32 and the requant rounds as jnp.round does,
//   so both kernels equal their plain versions bit for bit.
//
// What bounds them on this card: MobileNet-V2 at 224 runs the dense kernel once,
//   on the stem (224 x 224 x 3 -> 112 x 112 x 32, 10.8 M multiply-adds, 0.55 MB
//   moved), and the depthwise kernel 17 times, from 112 x 112 x 32 to 7 x 7 x 960
//   (at most ~1.2 MB in and 9 multiply-adds per output).  Both are bound by
//   their bytes, and at these sizes by launch latency.
//
// What the design does about it: the depthwise kernel gives one thread to each
//   (output pixel, channel), channels fastest, so a warp's nine tap reads are
//   contiguous runs of the HWC map and its output writes are coalesced; each
//   thread unpacks its channel's nine levels from the (C, ceil(9 / f)) carrier.
//   The dense kernel gives one thread to each output pixel and 16 output channels,
//   with those channels' unpacked levels staged in shared memory 32 input channels
//   at a time and read by all threads at once (a broadcast); at Cin = 3 an im2col
//   tiling would have nothing to reuse.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DENSE_TPB = 128;   // output pixels per dense block
constexpr int CO_G = 16;         // output channels per dense thread
constexpr int CI_CHUNK = 32;     // input channels staged per pass
constexpr int DW_TPB = 256;
constexpr long DW_MAX_BLOCKS = 132L * 16;   // grid-stride beyond 16 blocks per SM

// NORMQUANT, float-rescale form of the reference (_requant_f32)
__device__ __forceinline__ uint8_t requant(int acc, float mult, int bias) {
  float y = rintf(__fmul_rn(__int2float_rn(acc), mult));
  y = __fadd_rn(y, __int2float_rn(bias));
  return static_cast<uint8_t>(fminf(fmaxf(y, 0.f), 255.f));
}

template <int BITS>
__device__ __forceinline__ int level(const uint8_t* __restrict__ row, int t) {
  constexpr int F = 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  return static_cast<int>((__ldg(row + t / F) >> ((t % F) * BITS)) & kMask) - (1 << (BITS - 1));
}

template <int BITS>
__global__ void __launch_bounds__(DENSE_TPB)
dense3x3(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
         const float* __restrict__ mult, const int* __restrict__ bias,
         uint8_t* __restrict__ out, int H, int W, int Cin, int Cout, int Cinp, int stride,
         int Ho, int Wo) {
  __shared__ int ws[CO_G][9][CI_CHUNK];
  const int p = blockIdx.x * DENSE_TPB + threadIdx.x;
  const int co0 = blockIdx.y * CO_G;
  const bool live = p < Ho * Wo;
  const int oh = live ? p / Wo : 0, ow = live ? p % Wo : 0;
  int acc[CO_G];
#pragma unroll
  for (int c = 0; c < CO_G; ++c) acc[c] = 0;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_CHUNK) {
    const int nci = min(CI_CHUNK, Cin - ci0);
    __syncthreads();
    for (int e = threadIdx.x; e < CO_G * 9 * CI_CHUNK; e += DENSE_TPB) {
      const int c = e / (9 * CI_CHUNK), tap = (e / CI_CHUNK) % 9, cil = e % CI_CHUNK;
      const int co = co0 + c;
      ws[c][tap][cil] = (co < Cout && cil < nci)
          ? level<BITS>(packed + (static_cast<size_t>(co) * 9 + tap) * Cinp, ci0 + cil)
          : 0;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < 3; ++i) {
      const int ih = oh * stride + i - 1;
      if (ih < 0 || ih >= H) continue;
      for (int j = 0; j < 3; ++j) {
        const int iw = ow * stride + j - 1;
        if (iw < 0 || iw >= W) continue;
        const uint8_t* xp = x + (static_cast<size_t>(ih) * W + iw) * Cin + ci0;
        const int tap = 3 * i + j;
        for (int cil = 0; cil < nci; ++cil) {
          const int xv = __ldg(xp + cil);
#pragma unroll
          for (int c = 0; c < CO_G; ++c) acc[c] += xv * ws[c][tap][cil];
        }
      }
    }
  }
  if (!live) return;
  uint8_t* op = out + static_cast<size_t>(p) * Cout + co0;
#pragma unroll
  for (int c = 0; c < CO_G; ++c)
    if (co0 + c < Cout) op[c] = requant(acc[c], mult[co0 + c], bias[co0 + c]);
}

template <int BITS>
__global__ void __launch_bounds__(DW_TPB)
dw3x3(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
      const float* __restrict__ mult, const int* __restrict__ bias,
      uint8_t* __restrict__ out, int H, int W, int C, int Kp, int stride, int Ho, int Wo) {
  const long total = static_cast<long>(Ho) * Wo * C;
  for (long idx = blockIdx.x * static_cast<long>(DW_TPB) + threadIdx.x; idx < total;
       idx += static_cast<long>(gridDim.x) * DW_TPB) {
    const int c = static_cast<int>(idx % C);
    const long p = idx / C;
    const int ow = static_cast<int>(p % Wo), oh = static_cast<int>(p / Wo);
    const uint8_t* wr = packed + static_cast<size_t>(c) * Kp;
    int acc = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ih = oh * stride + i - 1;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int iw = ow * stride + j - 1;
        if (iw < 0 || iw >= W) continue;
        acc += static_cast<int>(__ldg(x + (static_cast<size_t>(ih) * W + iw) * C + c)) *
               level<BITS>(wr, 3 * i + j);
      }
    }
    out[idx] = requant(acc, mult[c], bias[c]);
  }
}

template <int BITS>
void launch_dense(const void* x, const void* packed, const void* mult, const void* bias,
                  void* out, int H, int W, int Cin, int Cout, int Cinp, int stride,
                  cudaStream_t s) {
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  dim3 grid((Ho * Wo + DENSE_TPB - 1) / DENSE_TPB, (Cout + CO_G - 1) / CO_G);
  dense3x3<BITS><<<grid, DENSE_TPB, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(mult), static_cast<const int*>(bias),
      static_cast<uint8_t*>(out), H, W, Cin, Cout, Cinp, stride, Ho, Wo);
}

template <int BITS>
void launch_dw(const void* x, const void* packed, const void* mult, const void* bias,
               void* out, int H, int W, int C, int Kp, int stride, cudaStream_t s) {
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  const long total = static_cast<long>(Ho) * Wo * C;
  const long need = (total + DW_TPB - 1) / DW_TPB;
  const int blocks = static_cast<int>(need < DW_MAX_BLOCKS ? need : DW_MAX_BLOCKS);
  dw3x3<BITS><<<blocks, DW_TPB, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(mult), static_cast<const int*>(bias),
      static_cast<uint8_t*>(out), H, W, C, Kp, stride, Ho, Wo);
}

}  // namespace

extern "C" int conv3x3_dense_launch(const void* x, const void* packed, const void* mult,
                                    const void* bias, void* out, int H, int W, int Cin,
                                    int Cout, int Cinp, int stride, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_dense<2>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride, s); break;
    case 4: launch_dense<4>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride, s); break;
    case 8: launch_dense<8>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv3x3_dw_launch(const void* x, const void* packed, const void* mult,
                                 const void* bias, void* out, int H, int W, int C, int Kp,
                                 int stride, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_dw<2>(x, packed, mult, bias, out, H, W, C, Kp, stride, s); break;
    case 4: launch_dw<4>(x, packed, mult, bias, out, H, W, C, Kp, stride, s); break;
    case 8: launch_dw<8>(x, packed, mult, bias, out, H, W, C, Kp, stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
