// Blocked online-softmax (flash) attention for Hopper (sm_90a): f32 q, k and
// v on the TF32 tensor cores (flash_fwd_tc), bf16 q, k and v on the bf16
// tensor cores (flash_fwd_bf16).
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
//   body _flash_kernel).  Generalised to what model prefill needs: q is
//   (B, Hq, Sq, D), k and v are (B, Hkv, Sk, D) with Hq % Hkv == 0 (the GQA
//   fold), and q_offset (B,) gives each batch row's first query position in
//   the kv sequence.  Query i of row b sits at qpos = q_offset[b] + i; key j is
//   visible when j <= qpos (causal) and j > qpos - window (window > 0).  Scores
//   are q.k * scale; masked scores take the reference's finite NEG_INF, and the
//   running max, sum and accumulator are f32, as in the reference.  A query
//   row that sees no key gets what the plain version (kernels/ref.py) gives it,
//   a softmax over Sk equal scores: the mean of v over [0, Sk).  (The Pallas
//   kernel agrees where its 256-key blocks cover Sk exactly; beyond that it
//   counts its own zero pads in the mean.)
//
// What bounds it on this card: 4 D flops a visible (query, key) pair.  In
//   f32 on the CUDA cores (67 TFLOP/s) those bind at every serving shape; on
//   the tensor cores in TF32 (495 TFLOP/s) with each f32 operand split into a
//   TF32 hi and lo part, three MMAs a multiply-add, the operations still bind
//   at hymba's long prompt and k / v bytes (3.35 TB/s) at qwen3's 64-query
//   chunks.  Where the kv loop is short, latency and balance bind.
//
// What the design does about it:
//   - the GQA group is folded into the tile's rows: a block owns 16 * WARPS
//     = 64 (query, head) rows of one (batch row, kv head), query-major (row r is
//     query r / G, head r % G of the group), so each k / v tile is read once
//     for the group's G heads;
//   - QK^T and PV run as mma.sync.m16n8k8 TF32 with f32 accumulators, each
//     operand split on its way from shared memory into registers, hi =
//     tf32_rna(x) and lo = tf32_rna(x - hi), the products hi.hi + hi.lo +
//     lo.hi (the lo.lo term is below f32's rounding).  P goes from S's
//     accumulator fragment through 16 rows a warp of shared memory, so that
//     the k loops of QK^T and PV may run rolled: at D = 128 they take two
//     steps a turn, which keeps the code small where a block walks one or
//     two tiles and runs its code once (qwen3-0.6b's serving chunks, 2-22 %
//     faster than unrolled); at D <= 64 they are unrolled (hymba-1.5b's
//     blocks walk up to 32 tiles; 0-4 % faster so; tools/attn_scan_ab.py
//     --sweep, PERF.md section 6).  Quad lane t reads keys 2t and 2t + 1
//     of an 8-key step as the MMA's k = t and t + 4, and V's fragment the
//     same keys.  Each kv tile's PV lands in a fresh fragment that is folded
//     into the f32 output by one FMA (o = o * alpha + pv), so the tensor
//     core's own accumulation spans one tile;
//   - k and v tiles go through a two-stage cp.async ring in shared memory,
//     rows padded by 4 words (P's by 8) so that every fragment read (Q and
//     K rows at column t, V rows 2t at column g, P rows at 2t) hits distinct
//     banks; the next tile's copy runs under this tile's MMAs, one barrier a
//     tile;
//   - head dim 256 (gemma-7b) keeps the same block of 64 rows and 32-key
//     tiles: q, two (k, v) stages and P take 205 KB of shared memory, one
//     block an SM.  Its output accumulator is 128 registers a thread, so
//     PV runs in four passes over P of 64 output columns each (a fresh
//     fragment of 32 registers, folded into o as above, the same
//     arithmetic in the same order), and the slices' combine reads one
//     row's slice at a time (ROWS); ptxas then fits the kernel in 255 registers
//     without spills.  16-key tiles fit so too (136 KB) but halve the MMAs
//     a barrier, so the tile stays at 32 keys; the plan gives this block
//     longer kv slices than at D <= 128 (kernels/flash_attention.py,
//     WIDE_SLICE_WORK);
//   - the online softmax stays in registers: row max and sum over the quad by
//     two xor-shuffles, exponentials as ex2 of log2(e)-scaled scores, masked
//     scores weighted 0 (a row that has seen no key keeps l = 0 and o = 0);
//   - the kv loop runs over the tiles the block's rows can see, so wholly
//     masked tiles are never read, and only tiles at the causal or window edge
//     evaluate the mask;
//   - the work is balanced by splitting each row tile's kv tiles into slices
//     of split_tiles tiles, one block each, the slices of a row tile next to
//     each other in the grid (kernels/flash_attention.py::flash_plan picks
//     the sizes from the shapes and the card's SMs).  A block whose
//     slice holds no visible tile exits at once.  Where one slice holds all of
//     a row tile's tiles, its block writes the output; else every slice
//     writes (m, l, o) to a scratch and the last block of the row tile to
//     arrive (an int counter a row tile, kept zeroed) adds the slices in
//     slice order, so two calls give the same bits.  One launch a call.
//
// The bf16 route (flash_fwd_bf16; the Pallas kernel's bf16 contract: bf16
//   q, k, v, f32 inside, the output in q's dtype): the same block, tile
//   walk, masks, online softmax, slices and combine, from one body
//   (flash_body<D, BK, T>).  What differs:
//   - q, k and v tiles are staged as bf16, rows padded by 16 B, half the
//     bytes of the f32 route's copies and shared memory (101 KB at D = 256);
//   - QK^T and PV run as mma.sync.m16n8k16 bf16 with f32 accumulators, one
//     MMA a product (bf16 operands are exact inputs, the products exact in
//     f32); Q and K fragments are 32-bit loads of two neighbouring bf16 of
//     a row, V's come from ldmatrix.x4.trans (keys are V's rows);
//   - P goes to PV from registers: S's accumulator fragment of two 8-key
//     tiles is the A fragment of one 16-key k step, so P never goes
//     through shared memory.  Where the caller's compute dtype is bf16
//     (P_ROUND, the reference's bf16 attn_dtype) P is rounded to bf16, as
//     the reference's chunked attention rounds p before PV; else (a bf16
//     model whose attention computes in f32, as the Pallas kernel keeps p
//     in f32) it is split into hi = bf16(p) and lo = bf16(p - hi), two MMAs
//     a k step, which keeps p to 2^-18 of itself.  The row sums l add the
//     f32 p, as the reference's do;
//   - o is rescaled by alpha and the PV MMAs accumulate into it directly,
//     so no second fragment is live and D = 256 needs no PV passes;
//   - the output is written as bf16, or as f32 where the caller asks (a
//     model whose activations are f32 and whose attention computes in
//     bf16, as the reference's returns f32 there); the slices' scratch
//     stays f32.
//   What bounds it: the same pairs at 4 D flops each at the bf16 rate (989
//   TFLOP/s dense; the MMAs do 6 D with P split), or k / v bytes at 2 B an
//   element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_decode.cuh"   // tcmm::cp_async / cp_commit / cp_wait / tf32_rna / to_f32, dcmm::mma_tf32

namespace {

constexpr float NEG_INF = -1e30f;     // the reference's finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // a block: 16 (query, head) rows a warp

template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }   // words a staged f32 row
template <int D>
__host__ __device__ constexpr int pitch_bf16() { return D + 8; }  // elements a staged bf16 row
template <int BK>
__host__ __device__ constexpr int p_pitch() { return BK + 8; }  // words a staged row of P
template <int D, int BK>
__host__ __device__ constexpr int smem_bytes() {
  // q tile, 2 x (k, v) tiles, each warp's 16 rows of P
  return ((16 * WARPS + 4 * BK) * pitch<D>() + 16 * WARPS * p_pitch<BK>()) * 4;
}
template <int D, int BK>
__host__ __device__ constexpr int smem_bytes_bf16() {
  // q tile and 2 x (k, v) tiles of bf16; P stays in registers
  return (16 * WARPS + 4 * BK) * pitch_bf16<D>() * 2;
}
static_assert(smem_bytes<256, 32>() <= 232448, "a block takes at most 227 KB");
static_assert(smem_bytes_bf16<256, 32>() <= 232448, "a block takes at most 227 KB");

struct Args {
  const void* q;     // float or bf16, as k, v and out
  const void* k;
  const void* v;
  const int* q_offset;
  void* out;
  float* part;       // slices' o (tiles, splits, rows, D) then (m, l) (tiles, splits, rows, 2)
  int* counters;     // one zeroed int a row tile
  int Hq, Hkv, Sq, Sk;
  float scale_log2;  // scale * log2(e)
  int causal, window;
  int row_tiles, split_tiles, splits;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tcmm::tf32_rna(x);
  lo = tcmm::tf32_rna(x - __uint_as_float(hi));
}

// d += a x b in three TF32 passes: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  dcmm::mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  dcmm::mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  dcmm::mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

// d += a x b, a 16 x 16 bf16, b 16 x 8 bf16, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring bf16 of a staged row (the lower index in the low half)
__device__ __forceinline__ uint32_t lds_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 bf16 matrices, transposed: lanes 8i .. 8i + 7 give the rows of
// matrix i, and r[i] holds this lane's column pair of its transpose
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tcmm::smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p and q rounded to bf16 (hi), and what that rounding left (lo), each a
// packed pair
__device__ __forceinline__ void split_bf16(float p, float q, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p, q);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p - hf.x, q - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// One block of either route: T is float (TF32, three passes) or
// __nv_bfloat16 (bf16 MMAs); TO, the output's type, is T or float; P_ROUND
// (bf16 route) rounds P to bf16 for PV, else P is a bf16 hi and lo part.
template <int D, int BK, typename T, typename TO, bool P_ROUND>
__device__ __forceinline__ void flash_body(const Args& a) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int THREADS = 32 * WARPS;
  constexpr int BR = 16 * WARPS;     // (query, head) rows a block
  constexpr int P = BF ? pitch_bf16<D>() : pitch<D>();   // elements a staged row
  constexpr int NKT = BK / 8;        // 8-key column tiles of S, k steps of PV
  constexpr int NDT = D / 8;         // k steps of S, 8-wide column tiles of PV
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a 16 B chunk
  constexpr int CPR = D / EPC;       // 16 B chunks a row
  constexpr int PP = p_pitch<BK>();
  constexpr int PV_TILES = D > 128 ? 8 : NDT;
  static_assert(NDT % PV_TILES == 0, "PV passes cover the output's columns");
  static_assert(!BF || (BK % 16 == 0 && D % 16 == 0), "bf16 MMAs take 16-deep k steps");
  extern __shared__ __align__(16) float smem[];
  T* qs = reinterpret_cast<T*>(smem);   // BR x P
  T* kvs = qs + BR * P;              // stage s: k at 2s BK P, v at (2s + 1) BK P
  float* pss = smem + (BR + 4 * BK) * P;  // f32 route: warp w's P at w 16 PP
  __shared__ int last;
  const T* gq = static_cast<const T*>(a.q);

  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int rt = tile % a.row_tiles, bhk = tile / a.row_tiles;
  const int b = bhk / a.Hkv, hk = bhk % a.Hkv;
  const int G = a.Hq / a.Hkv, rows = a.Sq * G, r0 = rt * BR;
  const int off = a.q_offset[b];
  const int qfirst = off + r0 / G, qlast = off + (min(r0 + BR, rows) - 1) / G;

  // the kv tiles [lo, hi) that any row of the block sees (mirrored by
  // kernels/flash_attention.py::visible_tiles), and the live slices of them;
  // with none, slice 0 alone writes the rows (as rows that see no key)
  const int khi = a.causal ? min(a.Sk, qlast + 1) : a.Sk;
  const int klo = a.window > 0 ? max(0, qfirst - a.window + 1) : 0;
  int lo = 0, hi = 0;
  if (khi > klo) { lo = klo / BK; hi = (khi + BK - 1) / BK; }
  const int s_lo = hi > lo ? lo / a.split_tiles : 0;
  const int s_hi = hi > lo ? (hi - 1) / a.split_tiles : 0;
  if (split < s_lo || split > s_hi) return;
  const int n_live = s_hi - s_lo + 1;
  const int t_begin = max(lo, split * a.split_tiles);
  const int t_end = min(hi, (split + 1) * a.split_tiles);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * warp;          // the warp's first row in the block
  const size_t kv_base = static_cast<size_t>(b * a.Hkv + hk) * a.Sk * D;
  const T* kb = static_cast<const T*>(a.k) + kv_base;
  const T* vb = static_cast<const T*>(a.v) + kv_base;

  auto load_kv = [&](int t, int st) {
    T* ks = kvs + 2 * st * BK * P;
    T* vs = ks + BK * P;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, key = t * BK + r;
      const bool in = key < a.Sk;
      const size_t gofs = in ? static_cast<size_t>(key) * D + EPC * c : 0;
      tcmm::cp_async<16>(ks + r * P + EPC * c, kb + gofs, in ? 16 : 0);
      tcmm::cp_async<16>(vs + r * P + EPC * c, vb + gofs, in ? 16 : 0);
    }
  };

  if (t_begin < t_end) {
    for (int i = tid; i < BR * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, rr = r0 + r;
      const bool in = rr < rows;
      const T* src = gq;
      if (in) {
        const int qi = rr / G, h = hk * G + rr % G;
        src = gq + (static_cast<size_t>(b * a.Hq + h) * a.Sq + qi) * D + EPC * c;
      }
      tcmm::cp_async<16>(qs + r * P + EPC * c, src, in ? 16 : 0);
    }
    load_kv(t_begin, 0);
  }
  tcmm::cp_commit();

  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = off + (r0 + wr + g + 8 * i) / G;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = t_begin; it < t_end; ++it) {
    const int st = (it - t_begin) & 1;
    tcmm::cp_wait<0>();
    __syncthreads();                 // tile it landed; tile it - 1 is consumed
    if (it + 1 < t_end) load_kv(it + 1, st ^ 1);
    tcmm::cp_commit();
    const T* ks = kvs + 2 * st * BK * P;
    const T* vs = ks + BK * P;

    // S = Q K^T: rows wr + g (+ 8), keys 8 nt + 2 t4 (+ 1)
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (BF) {
      // 16 head dims a k step: A is Q's rows g and g + 8 at dims 2 t4 (+ 1)
      // and 2 t4 + 8 (+ 9), B is K's row (key) g at the same dims
#pragma unroll(D >= 128 ? 2 : D / 16)
      for (int kk = 0; kk < D / 16; ++kk) {
        const T* qa = qs + (wr + g) * P + 16 * kk + 2 * t4;
        const uint32_t af[4] = {lds_pair(qa), lds_pair(qa + 8 * P), lds_pair(qa + 8),
                                lds_pair(qa + 8 * P + 8)};
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          const T* kp = ks + (8 * n + g) * P + 16 * kk + 2 * t4;
          mma_bf16(s[n], af, lds_pair(kp), lds_pair(kp + 8));
        }
      }
    } else {
#pragma unroll(D >= 128 ? 2 : D / 8)
      for (int kk = 0; kk < NDT; ++kk) {
        const float* qa = qs + (wr + g) * P + 8 * kk + t4;
        uint32_t ah[4], al[4];
        tf32_split(qa[0], ah[0], al[0]);
        tf32_split(qa[8 * P], ah[1], al[1]);
        tf32_split(qa[4], ah[2], al[2]);
        tf32_split(qa[8 * P + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          const float* kp = ks + (8 * n + g) * P + 8 * kk + t4;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(kp[0], bh0, bl0);
          tf32_split(kp[4], bh1, bl1);
          mma3(s[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }

    // scale, mask at the edges, online softmax in the fragment
    const int k0 = it * BK;
    const bool full = k0 + BK <= a.Sk && (!a.causal || k0 + BK - 1 <= qfirst) &&
                      (a.window <= 0 || k0 > qlast - a.window);
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale_log2;
        if (!full) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1), qpos = qp[e >> 1];
          const bool ok = key < a.Sk && (!a.causal || key <= qpos) &&
                          (a.window <= 0 || key > qpos - a.window);
          if (!ok) x = NEG_INF;
        }
        s[n][e] = x;
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NKT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m[i], mx);
      // a row with no visible key yet subtracts 0: its masked scores give
      // ex2(NEG_INF) = 0, so l and o stay 0
      const float base = mn == NEG_INF ? 0.f : mn;
      alpha[i] = ex2(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        s[n][2 * i] = ex2(s[n][2 * i] - base);
        s[n][2 * i + 1] = ex2(s[n][2 * i + 1] - base);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = mn;
    }

    if constexpr (BF) {
      // O = O * alpha + P V.  P (rounded to bf16) for keys 16 kk .. 16 kk +
      // 15 is the accumulator fragment of S's tiles 2 kk and 2 kk + 1; V's B
      // fragments of output tiles n and n + 1 come from one ldmatrix of the
      // four 8 x 8 blocks (keys 16 kk (+ 8), columns 8 n (+ 8))
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      const int mi = lane >> 3, mr = lane & 7;   // this lane's ldmatrix block and row
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pf[4], pl[4];
        if constexpr (P_ROUND) {
          pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        } else {
          split_bf16(s[2 * kk][0], s[2 * kk][1], pf[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], pf[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pf[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pf[3], pl[3]);
        }
        const T* vrow = vs + (16 * kk + 8 * (mi & 1) + mr) * P + 8 * (mi >> 1);
#pragma unroll
        for (int n = 0; n < NDT; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vrow + 8 * n);
          if constexpr (!P_ROUND) {
            mma_bf16(o[n], pl, bf[0], bf[1]);
            mma_bf16(o[n + 1], pl, bf[2], bf[3]);
          }
          mma_bf16(o[n], pf, bf[0], bf[1]);
          mma_bf16(o[n + 1], pf, bf[2], bf[3]);
        }
      }
    } else {
      // O = O * alpha + P V.  P goes through the warp's own staging rows, so
      // that the k loop need not be unrolled; the MMA's k = t4 (t4 + 4) is key
      // 8 kk + 2 t4 (+ 1), so that P's and V's reads hit distinct banks
      float* ps = pss + warp * 16 * PP;
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        *reinterpret_cast<float2*>(ps + g * PP + 8 * n + 2 * t4) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(ps + (g + 8) * PP + 8 * n + 2 * t4) =
            make_float2(s[n][2], s[n][3]);
      }
      __syncwarp();
      // PV_TILES of the output's 8-wide column tiles a pass over P: all of
      // them up to D = 128; at D = 256 four passes of 8, so that the fresh
      // fragment holds 32 registers beside o's 128
#pragma unroll
      for (int c0 = 0; c0 < NDT; c0 += PV_TILES) {
        float pv[PV_TILES][4];
#pragma unroll
        for (int n = 0; n < PV_TILES; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll(D >= 128 ? 2 : BK / 8)
        for (int kk = 0; kk < NKT; ++kk) {
          const float2 p0 = *reinterpret_cast<const float2*>(ps + g * PP + 8 * kk + 2 * t4);
          const float2 p1 =
              *reinterpret_cast<const float2*>(ps + (g + 8) * PP + 8 * kk + 2 * t4);
          uint32_t ph[4], pl[4];
          tf32_split(p0.x, ph[0], pl[0]);
          tf32_split(p1.x, ph[1], pl[1]);
          tf32_split(p0.y, ph[2], pl[2]);
          tf32_split(p1.y, ph[3], pl[3]);
#pragma unroll
          for (int n = 0; n < PV_TILES; ++n) {
            const float* vp = vs + (8 * kk + 2 * t4) * P + 8 * (c0 + n) + g;
            uint32_t bh0, bl0, bh1, bl1;
            tf32_split(vp[0], bh0, bl0);
            tf32_split(vp[P], bh1, bl1);
            mma3(pv[n], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int n = 0; n < PV_TILES; ++n) {
          o[c0 + n][0] = fmaf(o[c0 + n][0], alpha[0], pv[n][0]);
          o[c0 + n][1] = fmaf(o[c0 + n][1], alpha[0], pv[n][1]);
          o[c0 + n][2] = fmaf(o[c0 + n][2], alpha[1], pv[n][2]);
          o[c0 + n][3] = fmaf(o[c0 + n][3], alpha[1], pv[n][3]);
        }
      }
    }
  }
  tcmm::cp_wait<0>();
  if (n_live > 1) {
    // this slice's (m, l, o) to the scratch, in the fragment's own layout
    const size_t slot = (static_cast<size_t>(tile) * a.splits + split) * BR;
    float* po = a.part;
    float* pml = a.part + static_cast<size_t>(gridDim.x) * BR * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t row = slot + wr + g + 8 * i;
#pragma unroll
      for (int n = 0; n < NDT; ++n)
        *reinterpret_cast<float2*>(po + row * D + 8 * n + 2 * t4) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (t4 == 0) *reinterpret_cast<float2*>(pml + 2 * row) = make_float2(m[i], l[i]);
    }
    // the last slice of the row tile to arrive adds them all, in slice order
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.counters + tile, 1) == n_live - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // slices outer, the lane's two rows inner
    const size_t row = static_cast<size_t>(tile) * a.splits * BR + wr + g;
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = NEG_INF;
    for (int z = s_lo; z <= s_hi; ++z)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[i] = fmaxf(m[i], __ldcg(pml + 2 * (row + 8 * i + static_cast<size_t>(z) * BR)));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      base[i] = m[i] == NEG_INF ? 0.f : m[i];
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    // ROWS of the lane's two rows a load batch: both up to D = 128, so that
    // their loads are in flight together; at D = 256 one, since both rows'
    // loads would take 128 registers beside o's 128
    constexpr int ROWS = D > 128 ? 1 : 2;
    for (int z = s_lo; z <= s_hi; ++z) {
#pragma unroll
      for (int i0 = 0; i0 < 2; i0 += ROWS) {
        float2 ml[ROWS], p[ROWS][NDT];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const size_t zr = row + 8 * (i0 + r) + static_cast<size_t>(z) * BR;
          ml[r] = __ldcg(reinterpret_cast<const float2*>(pml + 2 * zr));
#pragma unroll
          for (int n = 0; n < NDT; ++n)
            p[r][n] = __ldcg(reinterpret_cast<const float2*>(po + zr * D + 8 * n + 2 * t4));
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int i = i0 + r;
          const float w = ex2(ml[r].x - base[i]);
          l[i] = fmaf(w, ml[r].y, l[i]);
#pragma unroll
          for (int n = 0; n < NDT; ++n) {
            o[n][2 * i] = fmaf(w, p[r][n].x, o[n][2 * i]);
            o[n][2 * i + 1] = fmaf(w, p[r][n].y, o[n][2 * i + 1]);
          }
        }
      }
    }
    if (tid == 0) a.counters[tile] = 0;      // ready for the next launch
  }

  // rows that saw no key take the mean of v over [0, Sk), as the plain
  // version's softmax over Sk equal scores gives them
  bool empty[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) empty[i] = m[i] == NEG_INF && r0 + wr + g + 8 * i < rows;
  if (__syncthreads_or(empty[0] || empty[1])) {
    for (int d = tid; d < D; d += THREADS) {
      float sum = 0.f;
      for (int j = 0; j < a.Sk; ++j) sum += tcmm::to_f32(vb[static_cast<size_t>(j) * D + d]);
      smem[d] = sum / static_cast<float>(a.Sk);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r0 + wr + g + 8 * i;
    if (rr >= rows) continue;
    const int qi = rr / G, h = hk * G + rr % G;
    TO* dst = static_cast<TO*>(a.out) + (static_cast<size_t>(b * a.Hq + h) * a.Sq + qi) * D +
              2 * t4;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      const float2 val = empty[i] ? make_float2(smem[8 * n + 2 * t4], smem[8 * n + 2 * t4 + 1])
                                  : make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      if constexpr (std::is_same<TO, __nv_bfloat16>::value)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(val.x, val.y);
      else
        *reinterpret_cast<float2*>(dst + 8 * n) = val;
    }
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_tc(const Args a) {
  flash_body<D, BK, float, float, false>(a);
}

// OUT_F32: the output in f32 (a model that computes attention in bf16 but
// keeps its activations in f32), else in bf16.  P_ROUND: P rounded to bf16
// for PV (a bf16 compute dtype), else kept as a bf16 hi and lo part
template <int D, int BK, bool OUT_F32, bool P_ROUND>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_bf16(const Args a) {
  flash_body<D, BK, __nv_bfloat16, std::conditional_t<OUT_F32, float, __nv_bfloat16>, P_ROUND>(
      a);
}

template <int D, int BK, bool BF, bool OUT_F32, bool P_ROUND>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = BF ? smem_bytes_bf16<D, BK>() : smem_bytes<D, BK>();
  void (*kernel)(const Args) = nullptr;
  if constexpr (BF)
    kernel = flash_fwd_bf16<D, BK, OUT_F32, P_ROUND>;
  else
    kernel = flash_fwd_tc<D, BK>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int kv_tiles = (a.Sk + BK - 1) / BK;
  // one block a (row tile, slice), on grid x
  const long blocks = static_cast<long>(B) * a.Hkv * a.row_tiles * a.splits;
  if (a.split_tiles < 1 || a.splits != (kv_tiles + a.split_tiles - 1) / a.split_tiles ||
      a.row_tiles != (a.Sq * (a.Hq / a.Hkv) + 16 * WARPS - 1) / (16 * WARPS) ||
      blocks > 0x7fffffffL || (a.splits > 1 && (a.part == nullptr || a.counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF, bool OUT_F32, bool P_ROUND>
int launch_d(const Args& a, int B, int D, int block_keys, cudaStream_t s) {
  switch (D * 1000 + block_keys) {
    case 16064: return launch<16, 64, BF, OUT_F32, P_ROUND>(a, B, s);
    case 32032: return launch<32, 32, BF, OUT_F32, P_ROUND>(a, B, s);
    case 64032: return launch<64, 32, BF, OUT_F32, P_ROUND>(a, B, s);
    case 128032: return launch<128, 32, BF, OUT_F32, P_ROUND>(a, B, s);
    case 256032: return launch<256, 32, BF, OUT_F32, P_ROUND>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The (head dim, keys a kv tile) pairs instantiated, as BLOCK_KEYS of
// kernels/flash_attention.py gives them, each for f32 q, k, v and out
// (bf16 = 0) and for bf16 q, k, v (bf16 = 1) with out in bf16 or, out_f32 =
// 1, in f32, and P rounded to bf16 (p_bf16 = 1) or kept as a hi and lo part.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offset, void* out, void* part,
                                      void* counters, int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int bf16, int out_f32, int p_bf16, float scale,
                                      int causal, int window, int block_keys, int row_tiles,
                                      int split_tiles, int splits, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(q_offset), out, static_cast<float*>(part),
               static_cast<int*>(counters), Hq, Hkv, Sq, Sk, scale * LOG2E, causal, window,
               row_tiles, split_tiles, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_d<false, true, false>(a, B, D, block_keys, s);
  if (p_bf16)
    return out_f32 ? launch_d<true, true, true>(a, B, D, block_keys, s)
                   : launch_d<true, false, true>(a, B, D, block_keys, s);
  return out_f32 ? launch_d<true, true, false>(a, B, D, block_keys, s)
                 : launch_d<true, false, false>(a, B, D, block_keys, s);
}
