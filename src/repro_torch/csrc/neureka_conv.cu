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
//   dense_plan.
//
// The depthwise kernel (dw3x3_vec) has no MMA shape: each output reads one
//   input channel.  Its 17 MobileNet-V2 jobs move 0.1-1.5 MB each (0.03-0.45
//   us of bytes), so what binds them is latency and the instructions an
//   output byte costs.  A block takes R output rows of TW pixels by CG
//   channels, each thread V = 16, 8, 4, 2 or 1 channels (the widest that
//   divides C and the map pointers' alignment) of one pixel (a plan sweep
//   found two and four pixels a thread slower at every MobileNet-V2 shape).
//   The block unpacks its channels' levels once, into a word for each kernel
//   row (three signed taps and a zero byte), and stages mult and bias; each
//   thread then holds its levels, mult and bias in registers.
//   The taps come one of two ways: staged, the block copies once, with
//   cp.async at the thread's width, the (R - 1) * s + 3 by (TW - 1) * s + 3
//   input pixels its outputs read, zeros written for the halo and never read
//   from the map, and every tap's V channels come from there in one load;
//   or direct, each thread loads its nine taps (V bytes each, zeros
//   outside the map) into registers before the block's barrier.  Each
//   kernel row of four channels is six byte permutes and four dp4a (u8 x
//   s8; a plan sweep found them 0.80-0.90x the time of an IMAD a tap and
//   channel); the outputs go out V bytes a store.  The grid is (row tiles x
//   column tiles, channel groups), the threads (CG / V, TW, R), all
//   index arithmetic 32-bit (the wrapper refuses maps of 2^31 bytes or
//   more).  The plan, and with it the route, is kernels/neureka_conv's
//   dw_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int DENSE_THREADS = 128;   // four warps
constexpr int DENSE_BN = 16;         // output channels a dense block: two 8-column MMA tiles
constexpr int DW_THREADS = 128;      // the most threads a depthwise block
constexpr int kMaxSmem = 227 * 1024;  // the shared memory a block can have

using i8mma::requant;

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

// The depthwise block: output rows oh0 .. oh0 + R - 1, columns ow0 .. ow0 +
// TW - 1 (TW = blockDim.y), channels c0 .. c0 + CG - 1.  Thread (x, y, z)
// takes channels c0 + V x .. + V - 1 of the output pixel in column ow0 + y of
// row oh0 + z.  Shared: the staged input window (IR rows x IC columns
// x CG channels, HWC as in the map, the zero halo included; none on the
// direct route), the levels as 3 words a channel (kernel row i: taps 3i ..
// 3i + 2 as signed bytes, byte 3 zero) and the block's mult and bias.
struct DwSmem {
  int IR, IC, lv, mu, bi, bytes;
};

__host__ __device__ inline DwSmem dw_layout(int stride, int R, int TW, int CG, bool staged) {
  using i8mma::round_up;
  DwSmem L;
  L.IR = (R - 1) * stride + 3;
  L.IC = (TW - 1) * stride + 3;
  L.lv = staged ? round_up(L.IR * L.IC * CG, 16) : 0;
  L.mu = L.lv + round_up(12 * CG, 16);
  L.bi = L.mu + round_up(4 * CG, 16);
  L.bytes = L.bi + round_up(4 * CG, 16);
  return L;
}

// V bytes (16, 8, 4, 2 or 1; the address aligned to V) as ceil(V / 4) words
template <int V>
struct Vec {
  uint32_t w[(V + 3) / 4];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const unsigned char* p) {
  Vec<V> v;
  if constexpr (V == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v.w[0] = t.x; v.w[1] = t.y; v.w[2] = t.z; v.w[3] = t.w;
  } else if constexpr (V == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v.w[0] = t.x; v.w[1] = t.y;
  } else if constexpr (V == 4) {
    v.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (V == 2) {
    v.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    v.w[0] = *p;
  }
  return v;
}

// load_vec from global memory through the read-only path
template <int V>
__device__ __forceinline__ Vec<V> ldg_vec(const uint8_t* p) {
  Vec<V> v;
  if constexpr (V == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = t.x; v.w[1] = t.y; v.w[2] = t.z; v.w[3] = t.w;
  } else if constexpr (V == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = t.x; v.w[1] = t.y;
  } else if constexpr (V == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (V == 2) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    v.w[0] = __ldg(p);
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store_vec(unsigned char* p, const Vec<V>& v) {
  if constexpr (V == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  else if constexpr (V == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  else if constexpr (V == 4)
    *reinterpret_cast<uint32_t*>(p) = v.w[0];
  else if constexpr (V == 2)
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.w[0]);
  else
    *p = static_cast<unsigned char>(v.w[0]);
}

// V consecutive shared words (16 B loads where V is a multiple of 4: the
// offset then is too)
template <int V>
__device__ __forceinline__ void words(uint32_t (&dst)[V], const uint32_t* src) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const uint4 t = *reinterpret_cast<const uint4*>(src + c);
      dst[c] = t.x; dst[c + 1] = t.y; dst[c + 2] = t.z; dst[c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) dst[c] = src[c];
  }
}

// c + the dot product of a's four unsigned bytes with b's four signed ones
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the signed level of tap t of a channel's packed row (Kp bytes, 2/4/8-bit
// fields along the nine taps)
__device__ __forceinline__ int dw_level(const uint8_t* __restrict__ row, int t, int bits) {
  const int lg = bits == 8 ? 0 : bits == 4 ? 1 : 2;   // log2(8 / bits)
  const int field = (__ldg(row + (t >> lg)) >> ((t & ((1 << lg) - 1)) * bits)) &
                    ((1 << bits) - 1);
  return field - (1 << (bits - 1));
}

// V channels of one pixel a thread.  STAGED: the taps come from the block's
// staged window; otherwise each thread loads its nine taps from the
// map into registers before the block's barrier.  Each kernel row's three
// taps of four channels are transposed by byte permutes into one word a
// channel (taps j = 0, 1, 2 and a fourth byte that meets a zero level) and
// summed with one dp4a a channel, exact in int32 (at most 9 * 255 * 128 in
// magnitude).
template <int V, bool STAGED>
__global__ void __launch_bounds__(DW_THREADS)
dw3x3_vec(const uint8_t* __restrict__ x, const uint8_t* __restrict__ packed,
          const float* __restrict__ mult, const int* __restrict__ bias,
          uint8_t* __restrict__ out, int H, int W, int C, int Kp, int bits, int stride,
          int Ho, int Wo, int R, int CG, int tiles_w) {
  using namespace i8mma;
  constexpr int NW = (V + 3) / 4;
  const int TW = blockDim.y;
  const DwSmem L = dw_layout(stride, R, TW, CG, STAGED);
  unsigned char* xs = smem;
  uint32_t* lvs = reinterpret_cast<uint32_t*>(smem + L.lv);
  float* mus = reinterpret_cast<float*>(smem + L.mu);
  int* bis = reinterpret_cast<int*>(smem + L.bi);
  const int s = stride;
  const int nthreads = blockDim.x * TW * blockDim.z;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + TW * threadIdx.z);
  const int th = blockIdx.x / tiles_w, tw = blockIdx.x - th * tiles_w;
  const int oh0 = th * R, ow0 = tw * TW, c0 = blockIdx.y * CG;
  const int ncg = min(CG, C - c0);
  const int ih0 = oh0 * s - 1, iw0 = ow0 * s - 1;
  const int k = threadIdx.x * V;   // this thread's channels in the group

  const int oh = oh0 + threadIdx.z, ow = ow0 + threadIdx.y;
  const bool live = oh < Ho && ow < Wo && k < ncg;
  Vec<V> taps[STAGED ? 1 : 9];
  if constexpr (STAGED) {
    // stage the window: thread (x, y, z) copies its V channels of staged
    // rows z, z + R, ... and columns y, y + TW, ...; outside the map (and
    // past C) zeros
    for (int q = threadIdx.z; q < L.IR; q += blockDim.z) {
      const int ih = ih0 + q;
      const bool row_in = k < ncg && ih >= 0 && ih < H;
      for (int col = threadIdx.y; col < L.IC; col += TW) {
        const int iw = iw0 + col;
        unsigned char* dst = xs + (q * L.IC + col) * CG + k;
        if (row_in && iw >= 0 && iw < W) {
          const uint8_t* src = x + (ih * W + iw) * C + c0 + k;
          if constexpr (V >= 4)
            cp_async<V>(dst, src);
          else
            store_vec<V>(dst, ldg_vec<V>(src));
        } else {
          store_vec<V>(dst, Vec<V>{});
        }
      }
    }
    cp_commit();
  } else if (live) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int ih = oh * s + i - 1, iw = ow * s + j - 1;
        taps[3 * i + j] = ih >= 0 && ih < H && iw >= 0 && iw < W
                              ? ldg_vec<V>(x + (ih * W + iw) * C + c0 + k)
                              : Vec<V>{};
      }
  }
  // meanwhile: the levels, kernel row i of channel c as word i * CG + c,
  // and the group's mult and bias (zero past C)
  for (int e = tid; e < 3 * CG; e += nthreads) {
    const int i = e >= 2 * CG ? 2 : e >= CG ? 1 : 0, c = e - i * CG;
    uint32_t w = 0;
    if (c < ncg) {
      const uint8_t* row = packed + (c0 + c) * Kp;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        w |= static_cast<uint32_t>(dw_level(row, 3 * i + j, bits) & 0xFF) << (8 * j);
    }
    lvs[e] = w;
  }
  for (int c = tid; c < CG; c += nthreads) {
    mus[c] = c < ncg ? __ldg(mult + c0 + c) : 0.f;
    bis[c] = c < ncg ? __ldg(bias + c0 + c) : 0;
  }
  if constexpr (STAGED) cp_wait_all();
  __syncthreads();
  if (!live) return;
  uint32_t lv[3][V];
#pragma unroll
  for (int i = 0; i < 3; ++i) words<V>(lv[i], lvs + i * CG + k);
  int acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0;
  const unsigned char* base = xs + (threadIdx.z * s * L.IC + threadIdx.y * s) * CG + k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const unsigned char* row = base + i * L.IC * CG;
    const Vec<V> x0 = STAGED ? load_vec<V>(row) : taps[3 * i],
                 x1 = STAGED ? load_vec<V>(row + CG) : taps[3 * i + 1],
                 x2 = STAGED ? load_vec<V>(row + 2 * CG) : taps[3 * i + 2];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t a = __byte_perm(x0.w[w], x1.w[w], 0x5140);   // x0[0] x1[0] x0[1] x1[1]
      const uint32_t b = __byte_perm(x0.w[w], x1.w[w], 0x7362);   // x0[2] x1[2] x0[3] x1[3]
      const int c = 4 * w;
      acc[c] = dp4a_us(__byte_perm(a, x2.w[w], 0x4410), lv[i][c], acc[c]);
      if (c + 1 < V)
        acc[c + 1] = dp4a_us(__byte_perm(a, x2.w[w], 0x5532), lv[i][c + 1], acc[c + 1]);
      if (c + 2 < V)
        acc[c + 2] = dp4a_us(__byte_perm(b, x2.w[w], 0x6610), lv[i][c + 2], acc[c + 2]);
      if (c + 3 < V)
        acc[c + 3] = dp4a_us(__byte_perm(b, x2.w[w], 0x7732), lv[i][c + 3], acc[c + 3]);
    }
  }
  uint32_t mu[V], bi[V];
  words<V>(mu, reinterpret_cast<const uint32_t*>(mus) + k);
  words<V>(bi, reinterpret_cast<const uint32_t*>(bis) + k);
  Vec<V> o{};
#pragma unroll
  for (int c = 0; c < V; ++c)
    o.w[c / 4] |= static_cast<uint32_t>(requant(acc[c], __uint_as_float(mu[c]),
                                               static_cast<int>(bi[c]))) << (8 * (c % 4));
  store_vec<V>(out + (oh * Wo + ow) * C + c0 + k, o);
}

template <int BITS>
cudaError_t launch_dense(const void* x, const void* packed, const void* mult, const void* bias,
                         void* out, int H, int W, int Cin, int Cout, int Cinp, int stride, int R,
                         int TW, int xw, int pw, int ow, cudaStream_t s) {
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

template <int V>
cudaError_t launch_dw(bool staged, const void* x, const void* packed, const void* mult,
                      const void* bias, void* out, int H, int W, int C, int Kp, int bits,
                      int stride, int R, int TW, int CG, cudaStream_t s) {
  auto kernel = staged ? dw3x3_vec<V, true> : dw3x3_vec<V, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(dw3x3_vec<V, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem),
      cudaFuncSetAttribute(dw3x3_vec<V, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem)};
  if (attr[staged] != cudaSuccess) return attr[staged];
  if (R < 1 || R > 64 || TW < 1 || CG < V || CG % V != 0 || C % V != 0 ||
      static_cast<long>(CG / V) * TW * R > DW_THREADS ||
      reinterpret_cast<uintptr_t>(x) % V != 0 || reinterpret_cast<uintptr_t>(out) % V != 0)
    return cudaErrorInvalidValue;
  const DwSmem L = dw_layout(stride, R, TW, CG, staged);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + R - 1) / R;
  const int groups = (C + CG - 1) / CG;
  if (static_cast<long>(tiles_w) * tiles_h > 0x7FFFFFFFL || groups > 65535)
    return cudaErrorInvalidValue;
  kernel<<<dim3(tiles_w * tiles_h, groups), dim3(CG / V, TW, R), L.bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(mult), static_cast<const int*>(bias),
      static_cast<uint8_t*>(out), H, W, C, Kp, bits, stride, Ho, Wo, R, CG, tiles_w);
  return cudaGetLastError();
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

// One depthwise launch of the plan kernels/neureka_conv.dw_plan chose: vec
// channels (16, 8, 4, 2 or 1 bytes; it must divide C and both map pointers'
// alignment) of one output pixel a thread, a block of cg channels by tc
// columns by `rows` output rows, the taps from a staged window or (staged =
// 0) loaded straight to registers.  A plan the kernel cannot take (threads
// past DW_THREADS, shared memory past 227 KB, a width the pointers do not
// allow) is refused with cudaErrorInvalidValue.
extern "C" int conv3x3_dw_launch(const void* x, const void* packed, const void* mult,
                                 const void* bias, void* out, int H, int W, int C, int Kp,
                                 int stride, int bits, int vec, int cg, int tc, int rows,
                                 int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bits != 2 && bits != 4 && bits != 8) || Kp != (9 * bits + 7) / 8 ||
      (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool st = staged != 0;
  switch (vec) {
    case 16: return launch_dw<16>(st, x, packed, mult, bias, out, H, W, C, Kp, bits, stride,
                                  rows, tc, cg, s);
    case 8: return launch_dw<8>(st, x, packed, mult, bias, out, H, W, C, Kp, bits, stride,
                                rows, tc, cg, s);
    case 4: return launch_dw<4>(st, x, packed, mult, bias, out, H, W, C, Kp, bits, stride,
                                rows, tc, cg, s);
    case 2: return launch_dw<2>(st, x, packed, mult, bias, out, H, W, C, Kp, bits, stride,
                                rows, tc, cg, s);
    case 1: return launch_dw<1>(st, x, packed, mult, bias, out, H, W, C, Kp, bits, stride,
                                rows, tc, cg, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
