// Int8 tensor-core helpers shared by csrc/qmatmul_int8.cu (B4) and the dense
// half of csrc/neureka_conv.cu (B5): cp.async copies, the unpack of packed
// 2/4/8-bit fields into signed bytes, the u8 x s8 MMA with its fragment
// loads, and the NORMQUANT requant.
//
// The MMA is mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32: A is 16 rows x
// 32 K of uint8 activations, B 32 K x 8 columns of signed levels, C / D 16 x 8
// int32.  The sum over K is exact in int32 in any order, so the K index of a
// fragment may be permuted as long as A and B agree: quad lane t (lane % 4)
// holds K 8t .. 8t + 7 of a 32-wide step, one 8 B shared read for its two A
// registers of a row and one for its two B registers.  The D fragment is the
// usual one: lane (g = lane / 4, t) holds rows g and g + 8, columns 2t and
// 2t + 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i8mma {

extern __shared__ __align__(16) unsigned char smem[];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES (4, 8 or 16; src and dst aligned to it) from global to shared
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `rows` rows of `nbytes` bytes each, row r from src + r * src_pitch to
// dst + r * dst_pitch, with the block's threads, W bytes a copy (cp.async for
// W >= 4, plain byte loads for W = 1).  nbytes, src_pitch, dst_pitch and both
// bases must be multiples of W.  Call cp_commit / cp_wait_all afterwards.
template <int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_pitch,
                                          const uint8_t* __restrict__ src, size_t src_pitch,
                                          int rows, int nbytes) {
  const int per = nbytes / W;
  const int total = rows * per;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per, c = (i - r * per) * W;
    if constexpr (W == 1)
      dst[r * dst_pitch + c] = __ldg(src + r * src_pitch + c);
    else
      cp_async<W>(dst + r * dst_pitch + c, src + r * src_pitch + c);
  }
}

// copy_rows at the widest width `w` (16, 8, 4 or 1) that the caller has
// checked the rows allow
__device__ __forceinline__ void copy_rows_w(int w, unsigned char* dst, int dst_pitch,
                                            const uint8_t* __restrict__ src, size_t src_pitch,
                                            int rows, int nbytes) {
  switch (w) {
    case 16: copy_rows<16>(dst, dst_pitch, src, src_pitch, rows, nbytes); break;
    case 8: copy_rows<8>(dst, dst_pitch, src, src_pitch, rows, nbytes); break;
    case 4: copy_rows<4>(dst, dst_pitch, src, src_pitch, rows, nbytes); break;
    default: copy_rows<1>(dst, dst_pitch, src, src_pitch, rows, nbytes); break;
  }
}

// levels of four packed fields' bytes: offset binary 0 .. 2^BITS - 1 ->
// two's complement field - 2^(BITS-1), a byte each, without a carry between
// bytes (the top bit is set first and flipped back after the subtraction)
template <int BITS>
__device__ __forceinline__ uint32_t center(uint32_t fields) {
  if constexpr (BITS == 8) return fields ^ 0x80808080u;
  constexpr uint32_t half = (1u << (BITS - 1)) * 0x01010101u;
  return ((fields | 0x80808080u) - half) ^ 0x80808080u;
}

// The signed levels of one packed 32-bit word, fields little-endian within a
// byte and bytes in order: 4 * (8 / BITS) levels as 8 / BITS words.
template <int BITS>
__device__ __forceinline__ void unpack_word(uint32_t p, uint32_t (&lv)[8 / BITS]) {
  if constexpr (BITS == 8) {
    lv[0] = center<8>(p);
  } else if constexpr (BITS == 4) {
    const uint32_t lo = p & 0x0F0F0F0Fu, hi = (p >> 4) & 0x0F0F0F0Fu;
    lv[0] = center<4>(__byte_perm(lo, hi, 0x5140));
    lv[1] = center<4>(__byte_perm(lo, hi, 0x7362));
  } else {
    const uint32_t f0 = p & 0x03030303u, f1 = (p >> 2) & 0x03030303u;
    const uint32_t f2 = (p >> 4) & 0x03030303u, f3 = (p >> 6) & 0x03030303u;
    const uint32_t a = __byte_perm(f0, f1, 0x5140), b = __byte_perm(f2, f3, 0x5140);
    const uint32_t c = __byte_perm(f0, f1, 0x7362), d = __byte_perm(f2, f3, 0x7362);
    lv[0] = center<2>(__byte_perm(a, b, 0x5410));
    lv[1] = center<2>(__byte_perm(a, b, 0x7632));
    lv[2] = center<2>(__byte_perm(c, d, 0x5410));
    lv[3] = center<2>(__byte_perm(c, d, 0x7632));
  }
}

// the low `n` (0 .. 4) bytes of a word
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, int n) {
  return n >= 4 ? v : n <= 0 ? 0u : v & ((1u << (8 * n)) - 1u);
}

// B column g's 8 levels for K k .. k + 7 (quad lane t: k = k0 + 8t) from a
// packed row in shared memory, levels at or past `valid` of them zero
template <int BITS>
__device__ __forceinline__ void load_b_packed(const unsigned char* row, int k, int valid,
                                              uint32_t (&b)[2]) {
  if constexpr (BITS == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + k);
    b[0] = center<8>(v.x);
    b[1] = center<8>(v.y);
  } else if constexpr (BITS == 4) {
    uint32_t lv[2];
    unpack_word<4>(*reinterpret_cast<const uint32_t*>(row + k / 2), lv);
    b[0] = lv[0];
    b[1] = lv[1];
  } else {
    uint32_t lv[4];
    unpack_word<2>(*reinterpret_cast<const uint16_t*>(row + k / 4), lv);
    b[0] = lv[0];
    b[1] = lv[1];
  }
  b[0] = keep_bytes(b[0], valid);
  b[1] = keep_bytes(b[1], valid - 4);
}

// the signed level of field t of a packed row (one byte load)
template <int BITS>
__device__ __forceinline__ int8_t level_at(const unsigned char* row, int t) {
  constexpr int F = 8 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  return static_cast<int8_t>(static_cast<int>((row[t / F] >> ((t % F) * BITS)) & kMask) -
                             (1 << (BITS - 1)));
}

// D += A (u8, 16 x 32) * B (s8, 32 x 8), int32
__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A rows g and g + 8 (row pointers into a shared tile, the step's K start
// added), quad lane t's 8 K: {a0, a1, a2, a3} of mma_u8s8
__device__ __forceinline__ void load_a(const unsigned char* row_g, const unsigned char* row_g8,
                                       int t, uint32_t (&a)[4]) {
  const uint2 lo = *reinterpret_cast<const uint2*>(row_g + 8 * t);
  const uint2 hi = *reinterpret_cast<const uint2*>(row_g8 + 8 * t);
  a[0] = lo.x; a[1] = hi.x; a[2] = lo.y; a[3] = hi.y;
}

// B column g (a row of the shared level tile, the step's K start added)
__device__ __forceinline__ void load_b(const unsigned char* col_g, int t, uint32_t (&b)[2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(col_g + 8 * t);
  b[0] = v.x; b[1] = v.y;
}

// The pitch of a shared tile whose rows hold `k` bytes (a multiple of 32):
// a pitch of 32 or 96 mod 128 puts the 16 lanes of each half warp's 8 B
// fragment reads (rows g .. g + 3, quad lanes 0 .. 3) on distinct banks.
__host__ __device__ constexpr int frag_pitch(int k) {
  return (k % 128 == 0 || k % 128 == 64) ? k + 32 : k;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// NORMQUANT, float-rescale form of the reference (_requant_f32): the multiply
// and the add rounded apart, half to even, clipped to uint8
__device__ __forceinline__ uint8_t requant(int acc, float mult, int bias) {
  float y = rintf(__fmul_rn(__int2float_rn(acc), mult));
  y = __fadd_rn(y, __int2float_rn(bias));
  return static_cast<uint8_t>(fminf(fmaxf(y, 0.f), 255.f));
}

// one store of w (16, 8, 4, 2 or 1) bytes from shared to global, both
// aligned to w
__device__ __forceinline__ void store_w(int w, uint8_t* dst, const unsigned char* src) {
  switch (w) {
    case 16: *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src); break;
    case 8: *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src); break;
    case 2: *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src); break;
    default: *dst = *src; break;
  }
}

// Write `rows` rows of `nbytes` bytes from a shared tile (pitch `pitch`) to
// global rows dst + r * dst_pitch, w bytes a store (w divides nbytes, both
// pitches and both bases), coalesced.
__device__ __forceinline__ void store_rows_w(int w, uint8_t* __restrict__ dst, size_t dst_pitch,
                                             const unsigned char* src, int pitch, int rows,
                                             int nbytes) {
  const int per = nbytes / w;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = (i - r * per) * w;
    store_w(w, dst + r * dst_pitch + c, src + r * pitch + c);
  }
}

}  // namespace i8mma
