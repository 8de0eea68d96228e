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
//   moved, 0.17 us at 3.35 TB/s), and the depthwise kernel 17 times, from 112 x
//   112 x 32 to 7 x 7 x 960 (at most ~1.2 MB in and 9 multiply-adds per output).
//   Both are bound by their bytes, and at these sizes by launch latency.
//
// What the design does about it: the dense kernel is an implicit GEMM on the
//   int8 tensor cores (mma.sync m16n8k32 u8 x s8 -> s32, csrc/int8_mma.cuh):
//   M is the block's output pixels (R rows of TW pixels), N its 16 output
//   channels, K = 9 * Cin in one fixed order, tap-major (t = 3i + j) then ci,
//   padded with zero levels to a multiple of 32 (conv0: K = 27, one MMA step).
//   A block stages once, with cp.async at the widest width the map's rows
//   allow, the (R - 1) * s + 3 input rows its outputs read, each row's bytes
//   as stored (HWC: one contiguous run of the map's row), with the zero halo
//   written into shared memory and never read from the map.  The A fragments
//   are gathered from there through a table of K offsets (one per K index:
//   i * pitch + (j - 1) * Cin + ci), the B fragments from the levels unpacked
//   once a block in the same K order from the (Cout, 3, 3, ceil(Cin / f))
//   carrier.  The requanted tile goes out through shared memory, each
//   pixel's channels contiguous.  The tile shape is kernels/neureka_conv's
//   dense_plan.  The depthwise kernel gives one thread to each (output pixel,
//   channel), channels fastest, so a warp's nine tap reads are contiguous runs
//   of the HWC map and its output writes are coalesced; each thread unpacks
//   its channel's nine levels from the (C, ceil(9 / f)) carrier.  It has no
//   MMA shape (one input channel an output) and stays on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int DENSE_THREADS = 128;   // four warps
constexpr int DENSE_BN = 16;         // output channels a dense block: two 8-column MMA tiles
constexpr int DW_TPB = 256;
constexpr long DW_MAX_BLOCKS = 132L * 16;   // grid-stride beyond 16 blocks per SM

using i8mma::requant;

template <int BITS>
__device__ __forceinline__ int level(const uint8_t* __restrict__ row, int t) {
  constexpr int F = 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  return static_cast<int>((__ldg(row + t / F) >> ((t % F) * BITS)) & kMask) - (1 << (BITS - 1));
}

// Shared layout of one dense block: the K offset table (KP ints), the staged
// input rows (IR x XS: `left` bytes of zero halo, the rows' bytes, zeros), the
// level tile (BN x wp, K order), the packed staging (BN x 9 x Cinp) and the
// output tile (P pixels x BN).
struct DenseSmem {
  int KP, wp, left, XS, IR, P, xs, ws, ps, os, bytes;
};

__host__ __device__ inline DenseSmem dense_layout(int Cin, int Cinp, int stride, int R, int TW,
                                                  int BN) {
  using i8mma::round_up;
  DenseSmem L;
  L.KP = round_up(9 * Cin, 32);
  L.wp = i8mma::frag_pitch(L.KP);
  L.left = round_up(Cin, 16);
  // the staged bytes of a row start up to 15 B before its first column (a
  // 16 B boundary of the map's row)
  L.XS = round_up(L.left + ((TW - 1) * stride + 3) * Cin + 16, 16);
  L.IR = (R - 1) * stride + 3;
  L.P = R * TW;
  L.xs = L.KP * 4;
  L.ws = L.xs + L.IR * L.XS;
  L.ps = L.ws + BN * L.wp;
  L.os = L.ps + round_up(BN * 9 * Cinp, 16);
  L.bytes = L.os + L.P * BN;
  return L;
}

// the four staged bytes at xb + o.x, o.y, o.z, o.w as a word, low byte first
__device__ __forceinline__ uint32_t gather4(const unsigned char* xb, int4 o) {
  return xb[o.x] | (xb[o.y] << 8) | (xb[o.z] << 16) | (static_cast<uint32_t>(xb[o.w]) << 24);
}

// One block: output rows oh0 .. oh0 + R - 1, columns ow0 .. ow0 + TW - 1 (P =
// R x TW pixels, M), channels co0 .. co0 + 15 (N); warp w takes the 16-pixel
// MMA tiles w, w + 4, ...
template <int BITS>
__global__ void __launch_bounds__(DENSE_THREADS)
dense3x3_mma(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ mult, const int* __restrict__ bias,
             uint8_t* __restrict__ out, int H, int W, int Cin, int Cout, int Cinp, int stride,
             int Ho, int Wo, int R, int TW, int xw, int pw, int ow) {
  using namespace i8mma;
  constexpr int BN = DENSE_BN, NI = BN / 8;
  const DenseSmem L = dense_layout(Cin, Cinp, stride, R, TW, BN);
  int* koff = reinterpret_cast<int*>(smem);
  unsigned char* xs = smem + L.xs;
  unsigned char* ws = smem + L.ws;
  unsigned char* ps = smem + L.ps;
  unsigned char* os = smem + L.os;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ow0 = blockIdx.x * TW, oh0 = blockIdx.y * R, co0 = blockIdx.z * BN;
  const int s = stride, K9 = 9 * Cin, wrow = 9 * Cinp;
  const int ncout = min(BN, Cout - co0);

  // the input window: staged row q is map row ih0 + q; of each row the
  // map's bytes b_lo .. b_hi (columns c_lo .. c_hi - 1, widened to 16 B)
  const int ih0 = oh0 * s - 1;
  const int c_lo = max(0, ow0 * s - 1), c_hi = min(W, (ow0 + TW - 1) * s + 2);
  const int row_bytes = W * Cin;
  const int b_lo = (c_lo * Cin) & ~15;
  const int b_hi = min(row_bytes, round_up(c_hi * Cin, 16));
  const int nb = b_hi - b_lo;
  const int q_lo = max(0, -ih0), q_hi = min(L.IR, H - ih0);
  if (q_hi > q_lo)
    copy_rows_w(xw, xs + q_lo * L.XS + L.left, L.XS,
                x + static_cast<size_t>(ih0 + q_lo) * row_bytes + b_lo, row_bytes, q_hi - q_lo, nb);
  copy_rows_w(pw, ps, 0, packed + static_cast<size_t>(co0) * wrow, 0, 1, ncout * wrow);
  cp_commit();
  // while the copies fly: the zero halo (rows outside the map, bytes outside
  // the copied run), the K offsets (k = 3i + j major, then ci) and this
  // lane's requant operands
  for (int i = tid; i < L.IR * L.XS; i += DENSE_THREADS) {
    const int q = i / L.XS, c = i - q * L.XS;
    if (q < q_lo || q >= q_hi || c < L.left || c >= L.left + nb) xs[i] = 0;
  }
  for (int k = tid; k < L.KP; k += DENSE_THREADS) {
    int o = 0;   // k >= 9 Cin: any staged byte; its level is zero
    if (k < K9) {
      const int tap = k / Cin, ci = k - tap * Cin;
      o = (tap / 3) * L.XS + (tap % 3 - 1) * Cin + ci;
    }
    koff[k] = o;
  }
  float mu[NI][2];
  int bi[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = co0 + 8 * j + 2 * t + h;
      mu[j][h] = n < Cout ? __ldg(mult + n) : 0.f;
      bi[j][h] = n < Cout ? __ldg(bias + n) : 0;
    }
  cp_wait_all();
  __syncthreads();
  // levels in the same K order, zero past 9 Cin and past Cout
  for (int i = tid; i < BN * L.KP; i += DENSE_THREADS) {
    const int r = i / L.KP, k = i - r * L.KP;
    int8_t v = 0;
    if (r < ncout && k < K9) {
      const int tap = k / Cin, ci = k - tap * Cin;
      v = level_at<BITS>(ps + r * wrow + tap * Cinp, ci);
    }
    ws[r * L.wp + k] = static_cast<unsigned char>(v);
  }
  __syncthreads();

  // a pixel's staged byte of K index k is xs[base + koff[k]]; pixels outside
  // the map (or the tile) read pixel 0's and are not written
  const int base0 = L.left + ow0 * s * Cin - b_lo;
  for (int mt = warp; mt * 16 < L.P; mt += DENSE_THREADS / 32) {
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h, r = p / TW, c = p - r * TW;
      base[h] = p < L.P && oh0 + r < Ho && ow0 + c < Wo ? base0 + r * s * L.XS + c * s * Cin
                                                          : base0;
    }
    int acc[NI][4];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0;
    for (int kk = 0; kk < L.KP; kk += 32) {
      const int4 o0 = *reinterpret_cast<const int4*>(koff + kk + 8 * t);
      const int4 o1 = *reinterpret_cast<const int4*>(koff + kk + 8 * t + 4);
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h] = gather4(xs + base[h], o0);
        a[2 + h] = gather4(xs + base[h], o1);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        uint32_t b[2];
        load_b(ws + (8 * j + g) * L.wp + kk, t, b);
        mma_u8s8(acc[j], a[0], a[1], a[2], a[3], b[0], b[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int p = mt * 16 + g + 8 * h2;
        if (p >= L.P) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          os[p * BN + 8 * j + 2 * t + h] = requant(acc[j][2 * h2 + h], mu[j][h], bi[j][h]);
      }
  }
  __syncthreads();
  // each pixel's ncout channels, ow bytes a store
  const int per = ncout / ow;
  for (int i = tid; i < L.P * per; i += DENSE_THREADS) {
    const int p = i / per, ch = (i - p * per) * ow, r = p / TW, c = p - r * TW;
    if (oh0 + r < Ho && ow0 + c < Wo)
      store_w(ow, out + (static_cast<size_t>(oh0 + r) * Wo + ow0 + c) * Cout + co0 + ch,
              os + p * BN + ch);
  }
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
cudaError_t launch_dense(const void* x, const void* packed, const void* mult, const void* bias,
                         void* out, int H, int W, int Cin, int Cout, int Cinp, int stride, int R,
                         int TW, int xw, int pw, int ow, cudaStream_t s) {
  constexpr int kMaxSmem = 227 * 1024;
  auto kernel = dense3x3_mma<BITS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  if (R < 1 || TW < 1) return cudaErrorInvalidValue;
  const DenseSmem L = dense_layout(Cin, Cinp, stride, R, TW, DENSE_BN);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  dim3 grid((Wo + TW - 1) / TW, (Ho + R - 1) / R, (Cout + DENSE_BN - 1) / DENSE_BN);
  kernel<<<grid, DENSE_THREADS, L.bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(mult), static_cast<const int*>(bias),
      static_cast<uint8_t*>(out), H, W, Cin, Cout, Cinp, stride, Ho, Wo, R, TW, xw, pw, ow);
  return cudaGetLastError();
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

// One dense launch of the tile kernels/neureka_conv.dense_plan chose: R output
// rows of TW pixels by 16 channels a block; xw and pw are the copy widths
// the map's rows and the packed carrier allow (16, 8, 4 or 1 B), ow the store
// width of a pixel's channels.  A tile whose shared memory exceeds the
// card's 227 KB is refused with cudaErrorInvalidValue.
extern "C" int conv3x3_dense_launch(const void* x, const void* packed, const void* mult,
                                    const void* bias, void* out, int H, int W, int Cin,
                                    int Cout, int Cinp, int stride, int bits, int rows, int tw,
                                    int xw, int pw, int ow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch_dense<2>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride,
                                   rows, tw, xw, pw, ow, s);
    case 4: return launch_dense<4>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride,
                                   rows, tw, xw, pw, ow, s);
    case 8: return launch_dense<8>(x, packed, mult, bias, out, H, W, Cin, Cout, Cinp, stride,
                                   rows, tw, xw, pw, ow, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
