// One-token GQA flash-decode over a gathered, masked KV set, for sm_90a:
// split over the tokens, combined by the last block of each KV head.
//
// Replaces the TPU kernel `_attn_kernel` / `gather_attention_pallas`
// (src/repro/kernels/gather_attention.py).  For each row b and query head h
// (KV head kh = h / rep):
//
//   s_t   = q[b,h] . k[b,t,kh] / sqrt(d)             (t with mask[b,t] set)
//   out   = sum_t softmax(s)_t v[b,t,kh]             (p = 0 on masked tokens,
//                                                     denominator >= 1e-30)
//
// Bound: bytes.  A call reads 2*S*H_kv*d*4 bytes of K/V per row and does
// about 4*S*H*d flops on them (2 flops per byte at rep = 4), far below the
// H100's balance point; tensor cores would not help (and TF32 would not hold
// fp32 accuracy).  What bounds it in practice is how many bytes are in
// flight at once and how many round trips lie in series, so the design
// spreads the tokens over the SMs, starts every copy of a block first, and
// keeps the block's own work short:
//
// * Split S.  The tokens are cut into splits of kSplit = 32 (the count
//   depends only on S); one block of 4 warps per (split, KV head, row) --
//   416 blocks at B = 4, H_kv = 8, S = 405 and 1,664 at H_kv = 32, against
//   132 SMs.  At rep = 1, d = 64 a block needs 16.6 KB of shared memory and
//   at most 32 registers a thread, so 13 fit an SM and 1,664 blocks run in
//   one wave.  Shared memory grows with d: 2 * 32 * d floats of K and V plus
//   rep * d of q, 72 KB at d = 256, rep = 8 (above 48 KB the launch raises
//   the block's dynamic shared-memory limit).
// * Stage once, asynchronously.  A block copies its split's K and V tiles
//   for its KV head, and its rep query rows, into shared memory with 16-byte
//   cp.async copies straight from the token-major [B, S, H_kv, d] layout
//   (row stride H_kv*d, no transpose), all started before any compute: one
//   trip to device memory.  Tokens past S are zero-filled by the copy.
// * Read each staged byte once.  Every query head of the block uses every
//   staged K and V element from registers: for scores, lane t holds token t
//   and warp w every 4th float4 of d, and each K float4 is dotted with all
//   rep query rows (broadcast reads); for P.V, d/4 lanes take a V row and
//   32/(d/4) rows go side by side (two at d = 64, so every lane works), the
//   warps take every 4th row, and each V float4 is weighted for all rep
//   heads.  Past d = 128 the columns go in chunks of 128 (32 float4, one a
//   lane; d = 160 is a chunk of 128 and one of 32, eight rows side by side),
//   and p then lies on the q rows, which the scores have consumed, so the
//   first chunk's sums can be stored while the next is computed.  The
//   warps' partial sums meet in shared memory, in warp order.
//   K's 16-byte chunks are XOR-swizzled by token so the lane-per-token reads
//   hit distinct banks.
// * Combine in split order, in the same kernel.  Each block writes fp32
//   partials (m, l, acc[d]) for its heads, then counts itself in an integer
//   counter of its (row, KV head); the block that counts last merges that
//   head group's splits in split order, M = max m_i, L = sum l_i e^(m_i - M),
//   out = sum acc_i e^(m_i - M) / max(L, 1e-30), one warp per head and one
//   lane per float4 of d (in chunks of 32 float4 past d = 128, each chunk
//   summing the same splits in the same order), with 16 splits' partials in
//   flight at once (4 at
//   rep = 1, whose 32 registers allow no more), and sets the counter back to
//   0 for the next call.  Which block comes last does not change the
//   arithmetic, and no float is summed atomically, so the result is the same
//   on every run.  A fully masked split has m = -1e30, l = 0, acc = 0 and
//   adds nothing; a fully masked row gives 0.
//
// Masked tokens may hold stale finite data (the engine's device-resident
// gather leaves it there); they are read but always weighted exactly 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 32;     // tokens per split (one block's K/V tile)
constexpr int kWarps = 4;      // warps per block
constexpr int kMaxD = 256;     // head_dim capacity
constexpr int kChunk4 = 32;    // float4 columns per P.V and combine pass (one a lane)
constexpr int kMaxRep = 8;     // query heads per KV head
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Floats of the scratch the phases share: partial scores [4][rep][32] and
// p [rep][32], later the warps' P.V sums [4][rep][d].  It lies on the K tile
// (free by then) where it fits, else after the q rows.  Past d = 128, p lies
// on the q rows instead (they hold rep * d >= rep * 32 floats), and the
// scratch always fits on the K tile (4 * rep * d <= 32 * d at rep <= 8).
constexpr int scratch_floats(int rep, int d) {
  return 5 * kSplit * rep > kWarps * rep * d ? 5 * kSplit * rep : kWarps * rep * d;
}

// One block per (split, KV head, row).  REP is the largest rep the
// instantiation serves (1, 2, 4 or 8); rep itself is a runtime value.  WIDE
// instantiations serve d > 128 and loop over column chunks; the others take
// d <= 128 in one pass, which the compiler unrolls away (no loop state, so
// no more registers than a kernel without the chunk loop).
template <int REP, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32, REP == 1 ? 13 : 4)
gather_attention_kernel(const float* __restrict__ q,       // [B, H, d]
                        const float* __restrict__ k,       // [B, S, Hk, d]
                        const float* __restrict__ v,       // [B, S, Hk, d]
                        const uint8_t* __restrict__ mask,  // [B, S]
                        float* __restrict__ out,           // [B, H, d]
                        float* __restrict__ pacc,          // [B, H, n_split, d]
                        float* __restrict__ pml,           // [B, H, n_split, 2]
                        int* __restrict__ counter,         // [B * Hk], 0 between calls
                        int H, int Hk, int S, int d, int x_off, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float2 ml_s[REP];
  __shared__ int is_last;
  const int d4 = d >> 2;
  float4* ks = reinterpret_cast<float4*>(smem);              // [kSplit][d4], swizzled
  float4* vs = ks + kSplit * d4;                              // [kSplit][d4]
  float4* qs = vs + kSplit * d4;                              // [rep][d4]
  float* xs = smem + x_off;                                   // scratch_floats(rep, d)

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int rep = H / Hk;
  const int swz = d4 % 8 == 0 ? 7 : 0;
  const int t0 = split * kSplit;
  const int nt = min(kSplit, S - t0);
  const size_t tok_stride = (size_t)Hk * d;
  const float* kb = k + ((size_t)b * S + t0) * tok_stride + (size_t)kh * d;
  const float* vb = v + ((size_t)b * S + t0) * tok_stride + (size_t)kh * d;
  const float* qb = q + ((size_t)b * H + (size_t)kh * rep) * d;

  // stage the split and the q rows: every byte once, all copies in flight
  for (int i = threadIdx.x; i < kSplit * d4; i += blockDim.x) {
    const int t = i / d4, c4 = i - t * d4;
    const bool in = t < nt;
    const size_t off = in ? (size_t)t * tok_stride + 4 * c4 : 0;
    cp_async16(reinterpret_cast<float*>(ks + t * d4 + (c4 ^ (t & swz))), kb + off, in);
    cp_async16(reinterpret_cast<float*>(vs + i), vb + off, in);
  }
  for (int i = threadIdx.x; i < rep * d4; i += blockDim.x)
    cp_async16(reinterpret_cast<float*>(qs + i), qb + 4 * i, true);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool valid = lane < nt && mask[(size_t)b * S + t0 + lane] != 0;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // scores: lane = token, warp = every 4th float4 of d, all rep heads at once
  float dot[REP];
#pragma unroll
  for (int h = 0; h < REP; ++h) dot[h] = 0.f;
#pragma unroll 4
  for (int c4 = warp; c4 < d4; c4 += kWarps) {
    const float4 kk = ks[lane * d4 + (c4 ^ (lane & swz))];
#pragma unroll
    for (int h = 0; h < REP; ++h) {
      if (h < rep) {
        const float4 qq = qs[h * d4 + c4];
        dot[h] += kk.x * qq.x + kk.y * qq.y + kk.z * qq.z + kk.w * qq.w;
      }
    }
  }
  float* sp = xs;                          // [kWarps][rep][kSplit] partial scores
  float* ps = WIDE ? reinterpret_cast<float*>(qs)           // [rep][kSplit] p
                   : xs + kWarps * rep * kSplit;
  const int n_pass = WIDE ? (d4 + kChunk4 - 1) / kChunk4 : 1;  // column chunks
  __syncthreads();                         // the K tile is free: scratch may lie on it
#pragma unroll
  for (int h = 0; h < REP; ++h)
    if (h < rep) sp[(warp * rep + h) * kSplit + lane] = dot[h];
  __syncthreads();

  // softmax over the split, one warp per head
  for (int h = warp; h < rep; h += kWarps) {
    float s = sp[h * kSplit + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sp[(w * rep + h) * kSplit + lane];
    s = valid ? s * scale : kNeg;
    float m = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
    const float p = valid ? expf(s - m) : 0.f;
    float l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kAll, l, off);
    ps[h * kSplit + lane] = p;
    if (lane == 0) ml_s[h] = make_float2(m, l);
  }
  __syncthreads();

  // P.V, a chunk of up to 32 float4 columns at a time: w4 lanes per V row,
  // tps rows side by side, the warps every 4th step
  float4* rsum = reinterpret_cast<float4*>(xs);   // [kWarps][rep][d4]
  for (int pass = 0; pass < n_pass; ++pass) {
    const int c0 = pass * kChunk4;
    const int w4 = WIDE ? min(kChunk4, d4 - c0) : d4;
    const int tps = 32 / w4;
    const int rs = lane / w4, c4 = c0 + lane - rs * w4;
    float4 acc[REP];
#pragma unroll
    for (int h = 0; h < REP; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rs < tps) {
#pragma unroll 4
      for (int t = warp * tps + rs; t < kSplit; t += kWarps * tps) {
        const float4 vv = vs[t * d4 + c4];
#pragma unroll
        for (int h = 0; h < REP; ++h)
          if (h < rep) fma4(acc[h], ps[h * kSplit + t], vv);
      }
    }
    for (int o = 1; o < tps; ++o) {        // row slot 0 gathers the others, in order
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        if (h < rep) {
          float4 x;
          x.x = __shfl_down_sync(kAll, acc[h].x, o * w4);
          x.y = __shfl_down_sync(kAll, acc[h].y, o * w4);
          x.z = __shfl_down_sync(kAll, acc[h].z, o * w4);
          x.w = __shfl_down_sync(kAll, acc[h].w, o * w4);
          if (rs == 0) add4(acc[h], x);
        }
      }
    }
    __syncthreads();                      // p is consumed where rsum lies on it
    if (rs == 0) {
#pragma unroll
      for (int h = 0; h < REP; ++h)
        if (h < rep) rsum[(warp * rep + h) * d4 + c4] = acc[h];
    }
  }
  __syncthreads();

  // this split's partials: the warps' sums in warp order
  for (int i = threadIdx.x; i < rep * d4; i += blockDim.x) {
    const int h = i / d4, c = i - h * d4;
    float4 a = rsum[h * d4 + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(a, rsum[(w * rep + h) * d4 + c]);
    const size_t idx = ((size_t)b * H + (size_t)kh * rep + h) * n_split + split;
    reinterpret_cast<float4*>(pacc + idx * d)[c] = a;
    if (c == 0) reinterpret_cast<float2*>(pml)[idx] = ml_s[h];
  }

  // the last block of this (row, KV head) to finish combines its splits
  __threadfence();
  __syncthreads();
  int* cnt = counter + (size_t)b * Hk + kh;
  if (threadIdx.x == 0) is_last = atomicAdd(cnt, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  constexpr int kChunk = REP == 1 ? 4 : 16;     // splits whose partials load at once
  for (int h = warp; h < rep; h += kWarps) {     // warp w combines query heads w, w + 4
    const size_t row = (size_t)b * H + (size_t)kh * rep + h;
    const float2* ml = reinterpret_cast<const float2*>(pml) + row * n_split;
    float mx = kNeg;
    for (int i = lane; i < n_split; i += 32) mx = fmaxf(mx, __ldcg(ml + i).x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
    for (int pass = 0; pass < n_pass; ++pass) {  // lane = float4 c0 + lane of d
      const int c0 = pass * kChunk4;
      const bool has = c0 + lane < d4;
      const float4* ab = reinterpret_cast<const float4*>(pacc + row * n_split * d) + c0 + lane;
      float lsum = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = 0; i0 < n_split; i0 += kChunk) {
        float4 a[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          a[j] = has && i0 + j < n_split ? __ldcg(ab + (size_t)(i0 + j) * d4)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        float w = 0.f, lw = 0.f;           // lane j: split i0 + j's weight, l * weight
        if (lane < kChunk && i0 + lane < n_split) {
          const float2 mi = __ldcg(ml + i0 + lane);
          w = expf(mi.x - mx);
          lw = mi.y * w;
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) { // in split order
          lsum += __shfl_sync(kAll, lw, j);
          fma4(o, __shfl_sync(kAll, w, j), a[j]);
        }
      }
      if (has) {
        const float denom = fmaxf(lsum, 1e-30f);
        reinterpret_cast<float4*>(out + row * d)[c0 + lane] =
            make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom);
      }
    }
  }
  if (threadIdx.x == 0) *cnt = 0;          // ready for the next call on this stream
}

// Dynamic shared memory of one block, and where the scratch starts (floats).
size_t smem_bytes(int rep, int d, int* x_off) {
  const int staged = 2 * kSplit * d + rep * d;             // K, V, q (floats)
  const int x = scratch_floats(rep, d);
  *x_off = x <= kSplit * d ? 0 : staged;                   // on the K tile where it fits
  return sizeof(float) * (size_t)(*x_off ? staged + x : staged);
}

// Sets the kernel's attributes once per instantiation, and raises its dynamic
// shared-memory limit the first time a launch needs more than 48 KB.
template <int REP, bool WIDE>
cudaError_t configure(size_t smem) {
  static bool configured = false;          // as much shared memory per SM as it offers
  static size_t limit = 48 << 10;
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = cudaFuncSetAttribute(gather_attention_kernel<REP, WIDE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (smem > limit) {
    err = cudaFuncSetAttribute(gather_attention_kernel<REP, WIDE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) limit = smem;
  }
  return err;
}

template <int REP, bool WIDE>
cudaError_t launch(const float* q, const float* k, const float* v, const uint8_t* mask,
                   float* out, float* pacc, float* pml, int* counter, int B, int H, int Hk,
                   int S, int d, int n_split, cudaStream_t st) {
  const int rep = H / Hk;
  int x_off;
  const size_t smem = smem_bytes(rep, d, &x_off);
  const cudaError_t err = configure<REP, WIDE>(smem);
  if (err != cudaSuccess) return err;
  gather_attention_kernel<REP, WIDE><<<dim3(n_split, Hk, B), kWarps * 32, smem, st>>>(
      q, k, v, mask, out, pacc, pml, counter, H, Hk, S, d, x_off, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t dispatch(const float* q, const float* k, const float* v, const uint8_t* mask,
                     float* out, float* pacc, float* pml, int* counter, int B, int H, int Hk,
                     int S, int d, int n_split, cudaStream_t st) {
  const int rep = H / Hk;
  if (rep == 1)
    return launch<1, WIDE>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d, n_split, st);
  if (rep == 2)
    return launch<2, WIDE>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d, n_split, st);
  if (rep <= 4)
    return launch<4, WIDE>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d, n_split, st);
  return launch<8, WIDE>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d, n_split, st);
}

template <int REP, bool WIDE>
cudaError_t occupancy(size_t bytes, int* blocks_per_sm) {
  const cudaError_t err = configure<REP, WIDE>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gather_attention_kernel<REP, WIDE>, kWarps * 32, bytes);
}

template <bool WIDE>
cudaError_t occupancy_for(int rep, size_t bytes, int* blocks_per_sm) {
  if (rep == 1) return occupancy<1, WIDE>(bytes, blocks_per_sm);
  if (rep == 2) return occupancy<2, WIDE>(bytes, blocks_per_sm);
  if (rep <= 4) return occupancy<4, WIDE>(bytes, blocks_per_sm);
  return occupancy<8, WIDE>(bytes, blocks_per_sm);
}

}  // namespace

// q [B,H,d], k/v [B,S,Hk,d] f32, mask [B,S] bool (one byte each) -> out [B,H,d] f32.
// pacc [B,H,n_split,d] and pml [B,H,n_split,2] f32 are scratch for the
// per-split partials, n_split = ceil(S / 32); counter [B*Hk] int32 must be 0
// and is 0 again when the kernel ends (calls that share it must share a
// stream).  All contiguous and 16-byte aligned on the current device;
// S >= 1, d % 4 == 0, d <= 256, H / Hk <= 8.  Launches one kernel on
// `stream`.  Returns cudaGetLastError().
extern "C" int gather_attention_f32(const float* q, const float* k, const float* v,
                                    const uint8_t* mask, float* out, float* pacc, float* pml,
                                    int* counter, int B, int H, int Hk, int S, int d,
                                    int n_split, void* stream) {
  if (Hk < 1 || H % Hk || H / Hk > kMaxRep || d < 4 || d % 4 || d > kMaxD || S < 1 ||
      n_split != (S + kSplit - 1) / kSplit)
    return (int)cudaErrorInvalidValue;
  if (B < 1) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(d > 4 * kChunk4
                   ? dispatch<true>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d,
                                    n_split, st)
                   : dispatch<false>(q, k, v, mask, out, pacc, pml, counter, B, H, Hk, S, d,
                                     n_split, st));
}

// Kernel B on the current device for H / Hk = rep and head_dim d: the blocks
// of one SM at once (what its shared memory and registers allow) and one
// block's dynamic shared memory.  Returns a cudaError_t.
extern "C" int gather_attention_occupancy(int rep, int d, int* blocks_per_sm, int* smem) {
  if (rep < 1 || rep > kMaxRep || d < 4 || d % 4 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  int x_off;
  const size_t bytes = smem_bytes(rep, d, &x_off);
  *smem = (int)bytes;
  return (int)(d > 4 * kChunk4 ? occupancy_for<true>(rep, bytes, blocks_per_sm)
                               : occupancy_for<false>(rep, bytes, blocks_per_sm));
}
