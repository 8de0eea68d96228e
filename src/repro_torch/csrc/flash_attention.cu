// Blocked online-softmax (flash) attention for Hopper (sm_90a), f32.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention (Pallas
//   body _flash_kernel).  Generalised to what model prefill needs: q is
//   (B, Hq, Sq, D), k and v are (B, Hkv, Sk, D) with Hq % Hkv == 0 (the GQA
//   fold), and q_offset (B,) gives each batch row's first query position in
//   the kv sequence.  Query i of row b sits at qpos = q_offset[b] + i; key j is
//   visible when j <= qpos (causal) and j > qpos - window (window > 0).  Scores
//   are q.k * scale; masked scores take the reference's finite NEG_INF, and the
//   running max, sum and accumulator are f32, as in the reference.  Every query
//   row must see at least one key (true for every causal prefill chunk).
//
// What bounds it on this card: at the serving shapes (Sq <= 64 queries per
//   chunk, Sk <= 512 keys, D = 128) it does 4 * D flops per visible
//   (query, key) pair on the f32 CUDA cores (67 TFLOP/s) against reading k and
//   v once, about 2 * D * 4 bytes per key per kv head; per head group of Hq/Hkv
//   queries that is below the card's ratio of flops to bytes, so the bound is
//   the bytes of k and v, and in practice the latency of a short kv loop.
//
// What the design does about it: one block per (batch * query head, tile of 16
//   queries); the kv loop runs inside the block, so nothing carries across
//   blocks.  The loop starts at the first tile the window can reach and ends at
//   the causal frontier of the block's last query, so kv tiles wholly masked
//   for every query of the block are never read (the early-out the reference
//   docstring promises and its body never does).  A 32-key tile of k and v is
//   staged in shared memory; each of the 4 warps carries 4 query rows.  Lane j
//   scores key j against the 4 rows (k padded by one float so the lanes hit
//   different banks), the row max and sum are warp shuffles, and for p @ v the
//   lanes split the head dimension and take each key's probability by shuffle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BK = 32;               // keys per tile, one per lane
constexpr float NEG_INF = -1e30f;    // the reference's finite mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ q_offset,
          float* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, float scale,
          int causal, int window) {
  constexpr int DL = (D + 31) / 32;   // head dims per lane in p @ v
  constexpr int D4 = D / 4;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x;                  // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int off = q_offset[b];
  const float* qb = q + static_cast<size_t>(bh) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b * Hkv + hk) * Sk * D;
  const float* kb = k + kv_base;
  const float* vb = v + kv_base;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, qi = q0 + r;
    qs[r][i % D] = qi < Sq ? qb[static_cast<size_t>(qi) * D + i % D] : 0.f;
  }

  // kv range that any query of this block can see
  const int qpos_first = off + q0;
  const int qpos_last = off + min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, qpos_last + 1) : Sk;
  const int kstart = window > 0 ? max(0, qpos_first - window + 1) : 0;

  const int row0 = warp * ROWS;
  int qpos[ROWS];
  float m[ROWS], l[ROWS], o[ROWS][DL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qpos[r] = off + q0 + row0 + r;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[r][i] = 0.f;
  }

  for (int kt = (kstart / BK) * BK; kt < kend; kt += BK) {
    __syncthreads();   // qs is written / the previous tile is consumed
    for (int i = tid; i < BK * D4; i += WARPS * 32) {
      const int kl = i / D4, d = (i % D4) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (kt + kl < Sk) {
        const size_t g = static_cast<size_t>(kt + kl) * D + d;
        kv4 = *reinterpret_cast<const float4*>(kb + g);
        vv4 = *reinterpret_cast<const float4*>(vb + g);
      }
      ks[kl][d] = kv4.x; ks[kl][d + 1] = kv4.y; ks[kl][d + 2] = kv4.z; ks[kl][d + 3] = kv4.w;
      *reinterpret_cast<float4*>(&vs[kl][d]) = vv4;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += qs[row0 + r][d] * kd;
    }
    const int kpos = kt + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos[r];
      if (window > 0) ok = ok && kpos > qpos[r] - window;
      const float sr = ok ? s[r] * scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      p[r] = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int i = 0; i < DL; ++i) o[r][i] *= alpha;
      m[r] = m_new;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? vs[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) o[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = o[r][i] * inv;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_offset, void* out,
           int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal, int window,
           cudaStream_t stream) {
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd<D><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_offset),
      static_cast<float*>(out), Hq, Hkv, Sq, Sk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offset, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D, float scale,
                                      int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, q_offset, out, B, Hq, Hkv, Sq, Sk, scale, causal, window, s);
    case 32: return launch<32>(q, k, v, q_offset, out, B, Hq, Hkv, Sq, Sk, scale, causal, window, s);
    case 64: return launch<64>(q, k, v, q_offset, out, B, Hq, Hkv, Sq, Sk, scale, causal, window, s);
    case 128: return launch<128>(q, k, v, q_offset, out, B, Hq, Hkv, Sq, Sk, scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
