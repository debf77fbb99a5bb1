// Mamba2 SSD intra-chunk term, for sm_90a.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_chunk_pallas`
// (src/repro/kernels/ssd_chunk.py).  Per chunk of Q tokens and per head h:
//
//   y[i,h,:] = sum_{j<=i} (C_i . B_j) * exp(cum_i,h - cum_j,h) * dt_j,h * x[j,h,:]
//
// Inputs (fp32, contiguous): x [BC, Q, H, P], B/C [BC, Q, N], dt/cum [BC, Q, H]
// with BC = batch * chunks; output [BC, Q, H, P].
//
// The Pallas body holds a whole (batch, chunk) in VMEM: x alone is
// Q*H*P*4 B = 2 MiB at Zamba2's shapes (Q = 128, H = 64, P = 64) and the
// decayed weights [H,Q,Q] 4 MiB, far past a Hopper block's 227 KB of shared
// memory.  Design: one block of 256 threads per (batch*chunk, group of 8
// heads), the chunk padded to 128 rows in shared memory.
//   1. Stage C^T and B^T, form cb = C.B^T [128,128] once (each thread an
//      8x8 register tile, operands as 16-byte shared-memory loads).
//   2. For each head of the group: x[:,h,:] [Q,P], cum[:,h] and dt[:,h] go
//      to shared memory from registers that were loaded during the previous
//      head's product (their global latency hides under it); each thread
//      forms an 8x8 tile of w_ij = cb_ij * exp(cum_i - cum_j) * dt_j for
//      j <= i only (j > i is written as 0 and never used as a product: cum
//      falls by up to ~45 a token at full width, so exp(cum_i - cum_j)
//      overflows above the diagonal and inf * 0 would be NaN); then y = w x
//      with each thread owning one float4 of columns on up to 8 rows, four
//      columns of w per 16-byte load, row blocks wholly above the diagonal
//      skipped.  Accumulation is fp32 in registers, in order of j.
// Zero-padded tail tokens (dt = 0, log-decay 0, B = C = 0) give w = 0 and
// y = 0; rows past Q are zero in shared memory and never stored.
//
// Bound: bytes.  At the main path's shapes (B = 4, 16 chunks, Q = 128,
// H = 64, P = 64, N = 64) the kernel must read x and write y (~277 MB with
// B, C, dt and cum; ~83 us at 3.35 TB/s) against ~4.5 GFLOP of fp32 work on
// and below the diagonal (~67 us at 67 TFLOP/s).  What the design does
// about it: every input byte is read from device memory once per block (x
// as 16-byte vectors along P; B and C once per 8 heads), y is written once
// as 16-byte vectors, and all Q^2 intermediates stay in shared memory.
// Shared memory (~165 KB at these shapes) allows one block per SM, so the
// 8 warps rely on the register tiles' instruction-level parallelism;
// tensor cores (wgmma), TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQP = 128;                   // padded chunk rows of cb, w and x
constexpr int kLd = kQP + 4;               // row stride of cb, w, C^T, B^T: 16-byte rows,
                                           // neighbouring rows 4 banks apart
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kHeadsPerBlock = 8;
constexpr int kMinP = 8;                   // P/4 >= 2 column groups: row lanes <= 128
constexpr int kMaxRows = 8;                // product rows per thread: 128 / (256 / (P/4))
constexpr int kMaxXVec = kQP * (kMaxP / 4) / kThreads;   // float4s of x staged per thread

// Shared-memory layout, in floats: cb [128][kLd] | cum [128] | dt [128] |
// x [128][P] | w [128][kLd]; C^T and B^T ([N][kLd] each) are staged in the
// x/w region before cb is formed.
constexpr int kOffCs = kQP * kLd;
constexpr int kOffDs = kOffCs + kQP;
constexpr int kOffX = kOffDs + kQP;        // a multiple of 4: 16-byte aligned

__host__ __device__ inline int smem_floats(int P, int N) {
  const int tail = kQP * P + kQP * kLd;
  const int staging = 2 * N * kLd;
  return kOffX + (tail > staging ? tail : staging);
}

__device__ inline int ilog2(int v) { return 31 - __clz(v); }

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// tile rows/columns of the 8x8 register tiles: 4t..4t+3 and 64+4t..64+4t+3
__device__ inline int tile_idx(int t, int a) { return (a < 4 ? 0 : 64) + 4 * t + (a & 3); }

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xh,    // [BC, Q, H, P]
                 const float* __restrict__ bm,    // [BC, Q, N]
                 const float* __restrict__ cm,    // [BC, Q, N]
                 const float* __restrict__ dt,    // [BC, Q, H]
                 const float* __restrict__ cum,   // [BC, Q, H]
                 float* __restrict__ out,         // [BC, Q, H, P]
                 int Q, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* cb = smem;
  float* cs = smem + kOffCs;
  float* ds = smem + kOffDs;
  float* xs = smem + kOffX;
  float* w = xs + kQP * P;
  float* ct = smem + kOffX;                // staging, before cb exists
  float* bt = ct + N * kLd;

  const size_t bc = blockIdx.x;
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int h1 = min(H, h0 + kHeadsPerBlock);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // 16 x 16 threads over the 8x8 tiles

  // 1. cb = C . B^T over the padded 128 x 128 (rows/cols past Q are 0)
  for (int e = tid; e < kQP * N; e += kThreads) {
    const int t = e / N, n = e - t * N;
    const bool in = t < Q;
    ct[n * kLd + t] = in ? cm[(bc * Q + t) * N + n] : 0.f;
    bt[n * kLd + t] = in ? bm[(bc * Q + t) * N + n] : 0.f;
  }
  __syncthreads();
  {
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 c0 = ld4(ct + n * kLd + 4 * ty), c1 = ld4(ct + n * kLd + 64 + 4 * ty);
      const float4 b0 = ld4(bt + n * kLd + 4 * tx), b1 = ld4(bt + n * kLd + 64 + 4 * tx);
      const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(cr[a], br[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float* row = cb + tile_idx(ty, a) * kLd;
      st4(row + 4 * tx, make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
      st4(row + 64 + 4 * tx, make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]));
    }
  }

  // 2. per head: stage x, cum, dt; form w; y = w x
  const int lcg = ilog2(P >> 2);           // P/4 float4 column groups, a power of two
  const int cg = 1 << lcg;
  const int lrl = ilog2(kThreads) - lcg;   // row lanes: rows of a thread are ty2 + r * rl
  const int rows = kQP >> lrl;             // <= kMaxRows
  const int tx2 = tid & (cg - 1), ty2 = tid >> lcg;
  const int nx = kQP << lcg;               // float4s of x per head (padded rows)

  float4 xr[kMaxXVec];
  float cum_r = 0.f, dt_r = 0.f;
  auto prefetch = [&](int h) {
#pragma unroll
    for (int k = 0; k < kMaxXVec; ++k) {
      const int e = tid + k * kThreads;
      const int t = e >> lcg;
      xr[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < nx && t < Q)
        xr[k] = ld4(xh + ((bc * Q + t) * H + h) * P + 4 * (e & (cg - 1)));
    }
    if (tid < Q) {
      cum_r = cum[(bc * Q + tid) * H + h];
      dt_r = dt[(bc * Q + tid) * H + h];
    } else {
      cum_r = 0.f;
      dt_r = 0.f;
    }
  };
  prefetch(h0);

  for (int h = h0; h < h1; ++h) {
    __syncthreads();   // cb is complete, and the previous head's x, w are consumed
#pragma unroll
    for (int k = 0; k < kMaxXVec; ++k) {
      const int e = tid + k * kThreads;
      if (e < nx) st4(xs + 4 * e, xr[k]);
    }
    if (tid < kQP) {
      cs[tid] = cum_r;
      ds[tid] = dt_r;
    }
    __syncthreads();
    if (h + 1 < h1) prefetch(h + 1);       // in flight while this head computes

    {
      const float4 ci0 = ld4(cs + 4 * ty), ci1 = ld4(cs + 64 + 4 * ty);
      const float4 cj0 = ld4(cs + 4 * tx), cj1 = ld4(cs + 64 + 4 * tx);
      const float4 dj0 = ld4(ds + 4 * tx), dj1 = ld4(ds + 64 + 4 * tx);
      const float ci[8] = {ci0.x, ci0.y, ci0.z, ci0.w, ci1.x, ci1.y, ci1.z, ci1.w};
      const float cj[8] = {cj0.x, cj0.y, cj0.z, cj0.w, cj1.x, cj1.y, cj1.z, cj1.w};
      const float dj[8] = {dj0.x, dj0.y, dj0.z, dj0.w, dj1.x, dj1.y, dj1.z, dj1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = tile_idx(ty, a);
        const float4 b0 = ld4(cb + i * kLd + 4 * tx), b1 = ld4(cb + i * kLd + 64 + 4 * tx);
        const float cbv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float wv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tile_idx(tx, c);
          // a select, never a product with the masked value: above the
          // diagonal expf may be inf
          wv[c] = (j <= i && i < Q) ? cbv[c] * expf(ci[a] - cj[c]) * dj[c] : 0.f;
        }
        st4(w + i * kLd + 4 * tx, make_float4(wv[0], wv[1], wv[2], wv[3]));
        st4(w + i * kLd + 64 + 4 * tx, make_float4(wv[4], wv[5], wv[6], wv[7]));
      }
    }
    __syncthreads();

    float4 acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nj = (Q + 3) & ~3;           // w columns and x rows past Q are 0
    for (int j = 0; j < nj; j += 4) {
      const float4 x0 = ld4(xs + ((j + 0) << lcg << 2) + 4 * tx2);
      const float4 x1 = ld4(xs + ((j + 1) << lcg << 2) + 4 * tx2);
      const float4 x2 = ld4(xs + ((j + 2) << lcg << 2) + 4 * tx2);
      const float4 x3 = ld4(xs + ((j + 3) << lcg << 2) + 4 * tx2);
      const int rlo = j >> lrl;            // row blocks below rlo lie wholly above the diagonal
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows && r >= rlo) {
          const float4 wv = ld4(w + (ty2 + (r << lrl)) * kLd + j);
          float4& o = acc[r];
          o.x = fmaf(wv.x, x0.x, o.x); o.x = fmaf(wv.y, x1.x, o.x);
          o.x = fmaf(wv.z, x2.x, o.x); o.x = fmaf(wv.w, x3.x, o.x);
          o.y = fmaf(wv.x, x0.y, o.y); o.y = fmaf(wv.y, x1.y, o.y);
          o.y = fmaf(wv.z, x2.y, o.y); o.y = fmaf(wv.w, x3.y, o.y);
          o.z = fmaf(wv.x, x0.z, o.z); o.z = fmaf(wv.y, x1.z, o.z);
          o.z = fmaf(wv.z, x2.z, o.z); o.z = fmaf(wv.w, x3.z, o.z);
          o.w = fmaf(wv.x, x0.w, o.w); o.w = fmaf(wv.y, x1.w, o.w);
          o.w = fmaf(wv.z, x2.w, o.w); o.w = fmaf(wv.w, x3.w, o.w);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const int i = ty2 + (r << lrl);
      if (r < rows && i < Q) st4(out + ((bc * Q + i) * H + h) * P + 4 * tx2, acc[r]);
    }
  }
}

}  // namespace

// x [BC,Q,H,P], B/C [BC,Q,N], dt/cum [BC,Q,H] f32 -> out [BC,Q,H,P] f32.
// All contiguous and 16-byte aligned on the current device; 1 <= Q <= 128,
// P a power of two in [8, 64], 1 <= N <= 128.  Launches on `stream`.
// Returns the error of raising the shared-memory limit, else cudaGetLastError().
extern "C" int ssd_chunk_f32(const float* xh, const float* bm, const float* cm,
                             const float* dt, const float* cum, float* out,
                             int BC, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > kQP || P < kMinP || P > kMaxP || (P & (P - 1)) || N < 1 || N > kMaxN ||
      H < 1 || BC < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (BC > 0) {
    dim3 grid(BC, (H + kHeadsPerBlock - 1) / kHeadsPerBlock);
    ssd_chunk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        xh, bm, cm, dt, cum, out, Q, H, P, N);
  }
  return (int)cudaGetLastError();
}
