// One-token GQA flash-decode over a gathered, masked KV set, for sm_90a.
//
// Replaces the TPU kernel `_attn_kernel` / `gather_attention_pallas`
// (src/repro/kernels/gather_attention.py).  For each row b and query head h
// (KV head kh = h / rep):
//
//   s_t   = q[b,h] . k[b,t,kh] / sqrt(d)             (t with mask[b,t] set)
//   out   = sum_t softmax(s)_t v[b,t,kh]             (p = 0 on masked tokens,
//                                                     denominator >= 1e-30)
//
// computed with an online softmax in fp32 over tiles of 32 tokens, so a
// fully masked tile (or row) stays finite and a fully masked row gives 0.
//
// Layout: K/V arrive token-major [B, S, H_kv, d], as the engine gathers them;
// a tile is read straight from that layout (row stride H_kv*d), with no
// transpose.  One block per (KV head, row); its `rep = H / H_kv` query heads
// go one per warp, so every K/V byte the block stages in shared memory is
// used by all `rep` heads.
//
// Bound: bytes.  The kernel reads 2*S*H_kv*d*4 bytes of K/V per row and does
// about 4*S*H*d flops on them (2 flops per byte at rep = 4).  What the design
// does about that: each K/V element is loaded from device memory once, as
// 16-byte vectors, coalesced along d; scores are one token per lane from
// shared memory (rows padded by 4 floats so the 16-byte reads of 8 lanes hit
// distinct banks), and P.V reads one row per step across the lanes.  Only
// B*H_kv blocks exist (32 at the main path's B = 4, H_kv = 8, on 132 SMs):
// splitting S across blocks with a combine pass is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // tokens per tile: one per lane when scoring
constexpr int kMaxD = 128;     // head_dim capacity (lane owns 4 columns)
constexpr int kMaxRep = 8;     // query heads per KV head (warps per block)
constexpr int kPad = 4;        // K row padding (floats) against bank conflicts
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kMaxRep * 32)
gather_attention_kernel(const float* __restrict__ q,       // [B, H, d]
                        const float* __restrict__ k,       // [B, S, Hk, d]
                        const float* __restrict__ v,       // [B, S, Hk, d]
                        const uint8_t* __restrict__ mask,  // [B, S]
                        float* __restrict__ out,           // [B, H, d]
                        int H, int Hk, int S, int d, float scale) {
  __shared__ __align__(16) float ks[kTile][kMaxD + kPad];
  __shared__ __align__(16) float vs[kTile][kMaxD];
  __shared__ __align__(16) float qs[kMaxRep][kMaxD];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rep = blockDim.x >> 5;
  const int h = kh * rep + warp;
  const int d4 = d >> 2;

  for (int c = lane; c < d; c += 32) qs[warp][c] = q[((size_t)b * H + h) * d + c];

  const size_t tok_stride = (size_t)Hk * d;
  const float* kb = k + (size_t)b * S * tok_stride + (size_t)kh * d;
  const float* vb = v + (size_t)b * S * tok_stride + (size_t)kh * d;
  const uint8_t* mb = mask + (size_t)b * S;
  const bool owns_cols = lane < d4;   // lane owns columns 4*lane .. 4*lane+3

  float m = kNeg, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();   // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kTile * d4; i += blockDim.x) {
      const int t = i / d4, c4 = i - t * d4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (t < nt) {
        kk = reinterpret_cast<const float4*>(kb + (size_t)(t0 + t) * tok_stride)[c4];
        vv = reinterpret_cast<const float4*>(vb + (size_t)(t0 + t) * tok_stride)[c4];
      }
      *reinterpret_cast<float4*>(&ks[t][4 * c4]) = kk;
      *reinterpret_cast<float4*>(&vs[t][4 * c4]) = vv;
    }
    __syncthreads();

    // scores: lane t scores token t0 + t
    const bool valid = lane < nt && mb[t0 + lane] != 0;
    float s = kNeg;
    if (valid) {
      float dot = 0.f;
      for (int c = 0; c < d; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][c]);
        const float4 qq = *reinterpret_cast<const float4*>(&qs[warp][c]);
        dot += kk.x * qq.x + kk.y * qq.y + kk.z * qq.z + kk.w * qq.w;
      }
      s = dot * scale;
    }
    float tmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] *= corr;
    for (int t = 0; t < nt; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      if (owns_cols) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[t][4 * lane]);
        acc[0] += pt * vv.x;
        acc[1] += pt * vv.y;
        acc[2] += pt * vv.z;
        acc[3] += pt * vv.w;
      }
    }
    m = m_new;
  }

  if (owns_cols) {
    const float denom = fmaxf(l, 1e-30f);
    float4 o = make_float4(acc[0] / denom, acc[1] / denom, acc[2] / denom, acc[3] / denom);
    reinterpret_cast<float4*>(out + ((size_t)b * H + h) * d)[lane] = o;
  }
}

}  // namespace

// q [B,H,d], k/v [B,S,Hk,d] f32, mask [B,S] bool (one byte each) -> out [B,H,d] f32.
// All contiguous and 16-byte aligned on the current device; d % 4 == 0,
// d <= 128, H / Hk <= 8.  Launches on `stream`.  Returns cudaGetLastError().
extern "C" int gather_attention_f32(const float* q, const float* k, const float* v,
                                    const uint8_t* mask, float* out,
                                    int B, int H, int Hk, int S, int d,
                                    void* stream) {
  if (Hk < 1 || H % Hk || H / Hk > kMaxRep || d % 4 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    dim3 grid(Hk, B);
    gather_attention_kernel<<<grid, (H / Hk) * 32, 0, (cudaStream_t)stream>>>(
        q, k, v, mask, out, H, Hk, S, d, 1.0f / sqrtf((float)d));
  }
  return (int)cudaGetLastError();
}
