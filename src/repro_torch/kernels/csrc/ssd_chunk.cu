// Mamba2 SSD intra-chunk term, for sm_90a: tensor cores in split precision.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_chunk_pallas`
// (src/repro/kernels/ssd_chunk.py).  Per chunk of Q tokens and per head h:
//
//   y[i,h,:] = sum_{j<=i} (C_i . B_j) * exp(cum_i,h - cum_j,h) * dt_j,h * x[j,h,:]
//
// Inputs (fp32, contiguous): x [BC, Q, H, P], B/C [BC, Q, N], dt/cum [BC, Q, H]
// with BC = batch * chunks; output [BC, Q, H, P].
//
// Bound: bytes.  At the main path's shapes (B = 4, 16 chunks, Q = 128,
// H = 64, P = 64, N = 64) the kernel must read x and write y, 134 MB each,
// ~277 MB with B, C, dt and cum: ~83 us at 3.35 TB/s.  The ~4.5 GFLOP on
// and below the diagonal would take as long on the CUDA cores at their full
// fp32 rate, so both products run on the tensor cores, and the [Q,Q]
// intermediates never leave the SM.  What the design does about it:
//
// * Tensor cores at fp32 accuracy.  Both products, cb = C.B^T and y = w.x,
//   split each operand as a = hi + lo, hi = a rounded to TF32 (to nearest,
//   ties away, as cvt.rna does) and lo = a - hi, and take each 8-wide
//   k-slice as two mma.sync products into fp32 accumulators: first the
//   cross terms lo_a.b + a.lo_b as ONE bf16 m16n8k16 product (k 0-7 hold
//   lo_a against b, k 8-15 hold a against lo_b; bf16 keeps 8 bits, and the
//   cross terms need no more), then hi_a.hi_b as one TF32 m16n8k8 product.
//   Each product term is held to ~2^-18 of its size, against 1e-4 asked;
//   one TF32 product alone keeps ~3 digits, too few over 128-term sums.
//   Two products a slice instead of three TF32 ones (lo.hi, hi.lo, hi.hi):
//   the tensor pipe, not memory, limits this kernel.
// * cb once per 16 heads.  One block of 8 warps per (batch*chunk, group of
//   16 heads): 256 blocks at the path's shapes.  B and C come in through
//   shared memory in 16-column chunks (double-buffered 16-byte cp.async
//   copies, started ahead of the first head's x), and each warp
//   accumulates its 9 of the 72 16x8 cb tiles on or below the diagonal in
//   registers, then stores them in the tensor cores' A-operand order (36
//   KB), one 16-byte word a lane.  With the k index of each 8-wide slice
//   permuted (position t <-> column 2t, t + 4 <-> 2t + 1), the accumulator
//   layout of a cb tile is exactly the A-operand layout of the same tile of
//   w, and the bf16 operand's k 2t, 2t+1 (and 2t+8, 2t+9) are the same two
//   columns: no value moves between lanes.
// * w never goes to shared memory.  Per head, each warp reads its cb tiles
//   and forms w = cb * exp(cum_i - cum_j) * dt_j in registers, already in
//   A-operand order, splits it there and multiplies it into x's tile, the
//   B operand, read from shared memory.  Column g of a warp's 8-column
//   tile nt is column 4g + nt of its 32 (P = 64), so a lane's B values for
//   its four tiles are one 16-byte load (rows padded to P + 4 floats: the
//   loads hit distinct banks) and its y values in a row are 8 contiguous
//   floats, written straight from the accumulators as two 16-byte stores.
//   Tiles wholly above the diagonal are never formed; inside the two
//   diagonal tiles of a strip a select sets j > i to 0 (the exponent there
//   reaches +5000, so exp is inf and must never meet a product).
// * Balanced causal work.  Warp w takes the 16-row strips s = w/2 and
//   7 - w/2, which together hold 18 tiles of the triangle whatever w is,
//   and half of the P columns (w odd: the upper half); rows past Q are
//   never stored.
// * The next head's x arrives while this head computes: 16-byte cp.async
//   copies into the second of two buffers, one started per k-slice of the
//   product so the copy instructions overlap the math, one barrier a
//   head.  cum and dt come four heads at a time (16 bytes of a token's
//   row, double-buffered): a 4-byte copy per head and token would touch a
//   different line in every lane, and cost as much as all of x.  Rows
//   past Q are zero-filled by the copies.
// * Two blocks an SM.  Shared memory is 114,688 B at P = 64 (cb 36,864,
//   two x buffers 69,632, two cum/dt slots 8,192) and the launch bounds
//   hold a thread to 128 registers, so two blocks of 8 warps share an SM:
//   the 256 blocks of the path's shapes run in one wave on 132 SMs.
//
// Zero-padded tail tokens (dt = 0, log-decay 0, B = C = 0) give w = 0 and
// y = 0 exactly.  Fixed order of accumulation, no atomics: the same inputs
// give the same bits on every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kQP = 128;                    // chunk rows, padded
constexpr int kStrips = kQP / 16;           // 16-row strips of y (the mma's M)
constexpr int kTiles = kStrips * (kStrips + 1);   // 16x8 tiles on or below the diagonal
constexpr int kHeadsPerBlock = 16;
constexpr int kMaxN = 128;
constexpr int kGroup = 4;                   // heads whose cum and dt are staged together
constexpr int kDecayFloats = 2 * kQP * kGroup;    // one decay slot: cum, then dt, [kQP][kGroup]
constexpr int kChunkN = 16;                 // columns of C and B per staged chunk
constexpr int kChunkFloats = 2 * kQP * kChunkN;   // one chunk slot: C, then B

// Shared memory, in floats: cb tiles [kTiles][32 lanes][4] | x [2][kQP][P + 4]
// | two decay slots, each cum [kQP][kGroup] then dt [kQP][kGroup].
__host__ __device__ constexpr int x_ld(int P) { return P + 4; }
__host__ __device__ constexpr size_t smem_bytes(int P) {
  return (size_t)(kTiles * 128 + 2 * kQP * x_ld(P) + 2 * kDecayFloats) * sizeof(float);
}

// index of the cb tile of strip s (rows 16s..16s+15) and k-slice ks (columns 8ks..8ks+7)
__device__ __forceinline__ int tile_index(int s, int ks) { return s * (s + 1) + ks; }

// The TF32 part of a: rounded to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite value (two integer operations)
__device__ __forceinline__ float tf32_hi(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

// two bf16 values, k0 in the low half (the lower k index of an mma operand)
__device__ __forceinline__ uint32_t bf16x2(float k0, float k1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(k0, k1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A operand of one 16x8 tile, split: hi for the TF32 product; for the BF16
// product, k 0-7 hold lo = a - hi and k 8-15 hold a itself
struct AFrag {
  uint32_t hi[4];
  uint32_t bf[4];
};

// v: this lane's values of the tile in TF32 A-operand order,
// (g, j), (g+8, j), (g, j+1), (g+8, j+1) with j = 2t
__device__ __forceinline__ AFrag a_frag(const float (&v)[4]) {
  AFrag f;
  float lo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float h = tf32_hi(v[c]);
    f.hi[c] = __float_as_uint(h);
    lo[c] = v[c] - h;
  }
  f.bf[0] = bf16x2(lo[0], lo[2]);    // (g,   k 2t, 2t+1)
  f.bf[1] = bf16x2(lo[1], lo[3]);    // (g+8, k 2t, 2t+1)
  f.bf[2] = bf16x2(v[0], v[2]);      // (g,   k 2t+8, 2t+9)
  f.bf[3] = bf16x2(v[1], v[3]);      // (g+8, k 2t+8, 2t+9)
  return f;
}

// B operand of one 8x8 tile, split to match: hi for the TF32 product; for
// the BF16 product, k 0-7 hold b itself and k 8-15 hold lo = b - hi
struct BFrag {
  uint32_t hi[2];
  uint32_t bf[2];
};

// b0, b1: this lane's values at rows j = 2t and j + 1, column g
__device__ __forceinline__ BFrag b_frag(float b0, float b1) {
  BFrag f;
  const float h0 = tf32_hi(b0), h1 = tf32_hi(b1);
  f.hi[0] = __float_as_uint(h0);
  f.hi[1] = __float_as_uint(h1);
  f.bf[0] = bf16x2(b0, b1);
  f.bf[1] = bf16x2(b0 - h0, b1 - h1);
  return f;
}

// d += a.b over one 8-wide k-slice: the cross terms lo_a.b + a.lo_b as one
// BF16 m16n8k16 product, then hi_a.hi_b as one TF32 m16n8k8 product
__device__ __forceinline__ void mma_split(float (&d)[4], const AFrag& a, const BFrag& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.bf[0]), "r"(a.bf[1]), "r"(a.bf[2]), "r"(a.bf[3]), "r"(b.bf[0]), "r"(b.bf[1]));
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.hi[0]), "r"(a.hi[1]), "r"(a.hi[2]), "r"(a.hi[3]), "r"(b.hi[0]), "r"(b.hi[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// n contiguous floats (n = 1, 2 or 4; 4n-byte aligned) from shared memory
template <int n>
__device__ __forceinline__ void load_row(float (&v)[n], const float* p) {
  if constexpr (n == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (n == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

// n contiguous floats (n = 2, 4 or 8; aligned to min(4n, 16) bytes) to device memory
template <int n>
__device__ __forceinline__ void store_row(float* p, const float (&v)[n]) {
  if constexpr (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < n; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// wait until at most n (0, 1 or 2) of this thread's latest cp.async groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16-byte copies of head h's x [kQP][P] a thread starts (rows past Q are zero-filled)
template <int P>
constexpr int kCopies = kQP * (P / 4) / kThreads;

// Copy k of this thread's share of head h's x.
template <int P>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ xh, size_t bc,
                                        int Q, int H, int h, int tid, int k) {
  const int e = tid + k * kThreads;
  const int t = e / (P / 4), c = e % (P / 4);
  const bool in = t < Q;
  cp_async16(xs + t * x_ld(P) + 4 * c, xh + ((bc * Q + (in ? t : 0)) * H + h) * P + 4 * c, in);
}

// This thread's copies of cum (threads 0-127) or dt (128-255) at token
// tid % 128 for heads hg .. hg + kGroup - 1 into a decay slot: one 16-byte
// copy where H is a multiple of 4 (hg always is), else one per head below H.
// (A copy per head and token would touch a different line in every lane:
// the four heads of a row share one.)
__device__ __forceinline__ void stage_decay(float* slot, const float* __restrict__ dt,
                                            const float* __restrict__ cum, size_t bc, int Q,
                                            int H, int hg, int tid) {
  const int t = tid & (kQP - 1);             // kThreads = 2 * kQP
  const bool in = t < Q;
  const float* src = (tid < kQP ? cum : dt) + (bc * Q + (in ? t : 0)) * H + hg;
  float* dst = slot + (tid < kQP ? 0 : kQP * kGroup) + t * kGroup;
  if ((H & 3) == 0) {
    cp_async16(dst, src, in);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (hg + k < H) cp_async4(dst + k, src + k, in);
  }
}

// Start the copies of columns 16c .. 16c+15 of C and of B into dst as
// C [kQP][16] | B [kQP][16], zero past Q and past N, as one cp.async group.
__device__ __forceinline__ void stage_bc(float* dst, const float* __restrict__ bm,
                                         const float* __restrict__ cm, size_t bc, int Q, int N,
                                         int c, int tid) {
  const int n0 = c * kChunkN;
  if ((N & 3) == 0) {                        // rows are 16-byte aligned
    for (int e = tid; e < 2 * kQP * (kChunkN / 4); e += kThreads) {
      const int m = e / (kQP * (kChunkN / 4)), r = (e / (kChunkN / 4)) % kQP, q = e % (kChunkN / 4);
      const int n = n0 + 4 * q;
      const bool in = r < Q && n < N;
      cp_async16(dst + (m * kQP + r) * kChunkN + 4 * q,
                 (m ? bm : cm) + (bc * Q + (in ? r : 0)) * N + (in ? n : 0), in);
    }
  } else {
    for (int e = tid; e < 2 * kQP * kChunkN; e += kThreads) {
      const int m = e / (kQP * kChunkN), r = (e / kChunkN) % kQP, q = e % kChunkN;
      const int n = n0 + q;
      const bool in = r < Q && n < N;
      cp_async4(dst + (m * kQP + r) * kChunkN + q,
                (m ? bm : cm) + (bc * Q + (in ? r : 0)) * N + (in ? n : 0), in);
    }
  }
  cp_commit();
}

// In a staged chunk, lane (g, t) reads n = 4t .. 4t+3 of a row as one
// float4: the first two feed k-positions j = 2t, 2t + 1 of one k-slice, the
// last two those of the next.  C's A operands for strip s, both k-slices:
__device__ __forceinline__ void c_frags(AFrag (&a)[2], const float* cs, int s, int g, int t) {
  const float4 ca = *reinterpret_cast<const float4*>(cs + (16 * s + g) * kChunkN + 4 * t);
  const float4 cc = *reinterpret_cast<const float4*>(cs + (16 * s + g + 8) * kChunkN + 4 * t);
  const float v0[4] = {ca.x, cc.x, ca.y, cc.y}, v1[4] = {ca.z, cc.z, ca.w, cc.w};
  a[0] = a_frag(v0);
  a[1] = a_frag(v1);
}

// One chunk of one cb tile (columns 8ks..) into acc: B's rows 8ks.. times C's fragments.
__device__ __forceinline__ void cb_chunk(float (&acc)[4], const AFrag (&a)[2], const float* bs,
                                         int ks, int g, int t) {
  const float4 bb = *reinterpret_cast<const float4*>(bs + (8 * ks + g) * kChunkN + 4 * t);
  mma_split(acc, a[0], b_frag(bb.x, bb.y));
  mma_split(acc, a[1], b_frag(bb.z, bb.w));
}

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ xh,    // [BC, Q, H, P]
                 const float* __restrict__ bm,    // [BC, Q, N]
                 const float* __restrict__ cm,    // [BC, Q, N]
                 const float* __restrict__ dt,    // [BC, Q, H]
                 const float* __restrict__ cum,   // [BC, Q, H]
                 float* __restrict__ out,         // [BC, Q, H, P]
                 int Q, int H, int N) {
  constexpr int kLd = x_ld(P);
  constexpr int kNT = P >= 16 ? P / 16 : 1;  // 8-column tiles of y per warp
  extern __shared__ __align__(16) float smem[];
  float* cbf = smem;
  float* xbuf = smem + kTiles * 128;
  float* decay = xbuf + 2 * kQP * kLd;       // two slots of kDecayFloats

  const size_t bc = blockIdx.x;
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int h1 = min(H, h0 + kHeadsPerBlock);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pw = warp >> 1, half = warp & 1;
  const int strip[2] = {pw, kStrips - 1 - pw};
  const int nk_all = (Q + 7) >> 3;           // k-slices holding a token
  int nk[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    nk[u] = 16 * strip[u] < Q ? min(2 * strip[u] + 2, nk_all) : 0;

  // copies in flight, one group each: the first two 16-column chunks of C
  // and B, then the first head's x with the first four heads' cum and dt
  const int n_chunks = (N + kChunkN - 1) / kChunkN;
  stage_bc(cbf, bm, cm, bc, Q, N, 0, tid);
  if (n_chunks > 1) stage_bc(cbf + kChunkFloats, bm, cm, bc, Q, N, 1, tid);
#pragma unroll
  for (int k = 0; k < kCopies<P>; ++k) stage_x<P>(xbuf, xh, bc, Q, H, h0, tid, k);
  stage_decay(decay, dt, cum, bc, Q, H, h0, tid);
  cp_commit();

  // this warp's cb tiles: its two strips, every other k-slice (strip 0 has
  // at most 4 such tiles, strip 1 at most 8), accumulated chunk by chunk in
  // the double-buffered chunk slots, which lie where the tiles go at the end
  float acc_cb[12][4];
#pragma unroll
  for (int k = 0; k < 12; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_cb[k][c] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    // groups started after chunk c's: chunk 1 and x (c = 0); x and chunk 2
    // (c = 1); chunk c + 1 (c >= 2) -- each only where it exists
    cp_wait(c == 0 ? 1 + (n_chunks > 1) : c == 1 ? 1 + (n_chunks > 2) : c + 1 < n_chunks);
    __syncthreads();                         // chunk c has landed for every warp
    const float* cs = cbf + (c & 1) * kChunkFloats;
    const float* bs = cs + kQP * kChunkN;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!nk[u]) continue;
      AFrag a[2];
      c_frags(a, cs, strip[u], g, t);
#pragma unroll
      for (int k = 0; k < (u ? 8 : 4); ++k) {
        const int ks = half + 2 * k;
        if (ks < nk[u]) cb_chunk(acc_cb[u ? 4 + k : k], a, bs, ks, g, t);
      }
    }
    __syncthreads();                         // chunk c's slot is free again
    if (c + 2 < n_chunks) stage_bc(cbf + (c & 1) * kChunkFloats, bm, cm, bc, Q, N, c + 2, tid);
  }
  // accumulator (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) -> A operand
  // (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int u = k < 4 ? 0 : 1, ks = half + 2 * (k < 4 ? k : k - 4);
    if (ks < nk[u])
      reinterpret_cast<float4*>(cbf)[tile_index(strip[u], ks) * 32 + lane] =
          make_float4(acc_cb[k][0], acc_cb[k][2], acc_cb[k][1], acc_cb[k][3]);
  }

  const bool active = P >= 16 || half == 0;  // P = 8: one column tile, half the warps
  // column g of the warp's 8-column tile nt is column col0 + kNT*g + nt of
  // y: a lane's B values for all kNT tiles are contiguous in a row of x,
  // and its outputs in a row of y are 2*kNT contiguous columns
  const int col0 = half * kNT * 8;
  const int nk_max = max(nk[0], nk[1]);
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // head h's copies have landed; head h-1 is done with the other buffer
    // head h+1's copies go to the other buffer, one per k-slice of this
    // head's product (the rest after it): the copies overlap the math
    const bool next = h + 1 < h1;
    float* xn = xbuf + (buf ^ 1) * kQP * kLd;
    const int early = active && next ? min(nk_max, kCopies<P>) : 0;
    if (next)
      for (int k = early; k < kCopies<P>; ++k) stage_x<P>(xn, xh, bc, Q, H, h + 1, tid, k);
    // cum and dt of the next group of heads go to the other decay slot at
    // the first head of this group (the slot's last reader is done)
    const int hl = (h - h0) % kGroup, slot = (h - h0) / kGroup % 2;
    if (hl == 0 && h + kGroup < h1)
      stage_decay(decay + (slot ^ 1) * kDecayFloats, dt, cum, bc, Q, H, h + kGroup, tid);
    if (!active) {
      cp_commit();
      continue;
    }
    const float* xs = xbuf + buf * kQP * kLd;
    const float* cs = decay + slot * kDecayFloats + hl;   // cum of head h at token t: cs[kGroup * t]
    const float* ds = cs + kQP * kGroup;

    float acc[2][kNT][4];
    float ci[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ci[u][0] = cs[kGroup * (16 * strip[u] + g)];
      ci[u][1] = cs[kGroup * (16 * strip[u] + g + 8)];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[u][nt][c] = 0.f;
    }

    for (int ks = 0; ks < nk_max; ++ks) {
      if (ks < early) stage_x<P>(xn, xh, bc, Q, H, h + 1, tid, ks);
      const int j = 8 * ks + 2 * t;          // this lane's k-positions t, t + 4 <-> j, j + 1
      const float2 cj = make_float2(cs[kGroup * j], cs[kGroup * (j + 1)]);
      const float2 dj = make_float2(ds[kGroup * j], ds[kGroup * (j + 1)]);
      BFrag xb[kNT];
      float x0[kNT], x1[kNT];
      load_row<kNT>(x0, xs + j * kLd + col0 + kNT * g);
      load_row<kNT>(x1, xs + (j + 1) * kLd + col0 + kNT * g);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) xb[nt] = b_frag(x0[nt], x1[nt]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (ks >= nk[u]) continue;
        const int s = strip[u];
        const float4 cb = reinterpret_cast<const float4*>(cbf)[tile_index(s, ks) * 32 + lane];
        float w[4] = {cb.x * __expf(ci[u][0] - cj.x) * dj.x,    // (g,   j)
                      cb.y * __expf(ci[u][1] - cj.x) * dj.x,    // (g+8, j)
                      cb.z * __expf(ci[u][0] - cj.y) * dj.y,    // (g,   j+1)
                      cb.w * __expf(ci[u][1] - cj.y) * dj.y};   // (g+8, j+1)
        if (ks >= 2 * s) {                   // a diagonal tile: keep j <= i by a select
          const int i = 16 * s + g;
          w[0] = j <= i ? w[0] : 0.f;
          w[1] = j <= i + 8 ? w[1] : 0.f;
          w[2] = j + 1 <= i ? w[2] : 0.f;
          w[3] = j + 1 <= i + 8 ? w[3] : 0.f;
        }
        const AFrag a = a_frag(w);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_split(acc[u][nt], a, xb[nt]);
      }
    }
    cp_commit();                             // head h+1's group (empty past the last head)

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!nk[u]) continue;
      const int i = 16 * strip[u] + g;
      // accumulator c0, c1 of tile nt: row i, tile columns 2t, 2t + 1, i.e.
      // columns col0 + 2*kNT*t + nt and + kNT; c2, c3 the same on row i + 8
      float r0[2 * kNT], r1[2 * kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        r0[nt] = acc[u][nt][0];
        r0[kNT + nt] = acc[u][nt][1];
        r1[nt] = acc[u][nt][2];
        r1[kNT + nt] = acc[u][nt][3];
      }
      const int col = col0 + 2 * kNT * t;
      if (i < Q) store_row<2 * kNT>(out + ((bc * Q + i) * H + h) * P + col, r0);
      if (i + 8 < Q) store_row<2 * kNT>(out + ((bc * Q + i + 8) * H + h) * P + col, r1);
    }
  }
}

template <int P>
int launch(const float* xh, const float* bm, const float* cm, const float* dt,
           const float* cum, float* out, int BC, int Q, int H, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_kernel<P>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (BC > 0) {
    dim3 grid(BC, (H + kHeadsPerBlock - 1) / kHeadsPerBlock);
    ssd_chunk_kernel<P><<<grid, kThreads, smem, stream>>>(xh, bm, cm, dt, cum, out, Q, H, N);
  }
  return (int)cudaGetLastError();
}

template <int P>
int occupancy(int* blocks_per_sm, int* smem_per_block) {
  const size_t smem = smem_bytes(P);
  *smem_per_block = (int)smem;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_kernel<P>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssd_chunk_kernel<P>,
                                                        kThreads, smem);
  return (int)err;
}

}  // namespace

// x [BC,Q,H,P], B/C [BC,Q,N], dt/cum [BC,Q,H] f32 -> out [BC,Q,H,P] f32.
// All contiguous and 16-byte aligned on the current device; 1 <= Q <= 128,
// P in {8, 16, 32, 64}, 1 <= N <= 128.  Launches on `stream`.  Returns the
// error of setting the kernel's shared-memory attributes, else
// cudaGetLastError().
extern "C" int ssd_chunk_f32(const float* xh, const float* bm, const float* cm,
                             const float* dt, const float* cum, float* out,
                             int BC, int Q, int H, int P, int N, void* stream) {
  if (Q < 1 || Q > kQP || N < 1 || N > kMaxN || H < 1 || BC < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 8: return launch<8>(xh, bm, cm, dt, cum, out, BC, Q, H, N, s);
    case 16: return launch<16>(xh, bm, cm, dt, cum, out, BC, Q, H, N, s);
    case 32: return launch<32>(xh, bm, cm, dt, cum, out, BC, Q, H, N, s);
    case 64: return launch<64>(xh, bm, cm, dt, cum, out, BC, Q, H, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For head width P: the blocks of the kernel one SM holds at once, into
// *blocks_per_sm; the heads each block takes, into *heads_per_block; its
// dynamic shared memory in bytes, into *smem_per_block.  Returns a CUDA
// error code (0 on success).
extern "C" int ssd_chunk_occupancy(int P, int* blocks_per_sm, int* heads_per_block,
                                   int* smem_per_block) {
  *heads_per_block = kHeadsPerBlock;
  switch (P) {
    case 8: return occupancy<8>(blocks_per_sm, smem_per_block);
    case 16: return occupancy<16>(blocks_per_sm, smem_per_block);
    case 32: return occupancy<32>(blocks_per_sm, smem_per_block);
    case 64: return occupancy<64>(blocks_per_sm, smem_per_block);
    default: return (int)cudaErrorInvalidValue;
  }
}
