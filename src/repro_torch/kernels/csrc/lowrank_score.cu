// Low-rank group scoring (KVSwap Eq. 1) for sm_90a.
//
// Replaces the TPU kernel `_score_kernel` / `lowrank_group_scores_pallas`
// (src/repro/kernels/lowrank_score.py).  For each row b and each group of G
// consecutive tokens:
//
//   score[b, n] = sum_h q_lr[b, h, :] . k_lr[b, n, :]   (masked to -1e30 at n >= valid[b])
//   out[b, g]   = max over the G tokens of group g      (ragged last group allowed)
//
// The head sum is folded first, sum_h (q_h . k) = (sum_h q_h) . k, which
// turns the kernel into a GEMV over K_lr.  It is bound by the bytes of K_lr
// it reads: 2 flops per 4-byte element, far below the H100's balance point.
// At the decode path's sizes (about 1.6 MB) the time is latency: what counts
// is how many round trips to device memory lie in series, so the design
// puts every load of a block in flight at once:
//
// * Four lanes per token, each holding up to 16 float4 (64 floats) of its
//   row in registers: every thread starts all its row loads before any
//   arithmetic, and before the block folds the head sum, so the K_lr loads
//   and the q_lr loads overlap in one trip.  A block of 256 threads scores
//   64 tokens (16 groups of 4) and a row of 4096 tokens takes 64 blocks.
//   Ranks that are not a multiple of 4 take a scalar path with the same
//   layout.
// * The head sum is folded by all 256 threads: each sums every
//   (256 / r)-th head of one column with independent loads, and the
//   partial sums meet in shared memory.
// * The four lanes of a token reduce with two shuffles; the group max is
//   read from the block's scores in shared memory, so any G works (a group
//   longer than 64 tokens is scored in several passes, each thread keeping
//   a running max of its token slot).
// * Blocks whose groups all lie past valid[b] write -1e30 without reading
//   K_lr or q_lr, so the bytes moved follow the valid tokens, not the cache
//   capacity; the ragged tail (N not a multiple of G) is bounds-checked
//   here, so the caller pads nothing.
// * Ranks past 256 take a second instance of the kernel (Wide): the folded
//   query, r floats, lives in dynamic shared memory, and each token's dot
//   product runs over the rank in chunks of 256 columns (one register row
//   a chunk), accumulated in fp32 before the group max.  Its row loads
//   start after the fold, not before: ranks past 256 only have to be
//   right, and the r <= 256 instance is left as it was.
// The folded sum rounds differently from the reference's per-head sum; the
// wrapper's plain version is held to it at 1e-5 of the row's score scale.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                      // lanes per token
constexpr int kTokens = kThreads / kLanes;     // tokens per pass
constexpr int kMaxRank = 256;                  // 4 lanes x 64 floats: one register row
constexpr int kStaticSmem = 48 * 1024;         // dynamic shared memory without opt-in
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// Vec: float4 units (r % 4 == 0), 16 per lane; scalar: float units, 64 per lane.
template <bool Vec>
struct Row {
  using T = typename std::conditional<Vec, float4, float>::type;
  static constexpr int kUnits = Vec ? 16 : 64;
  T x[kUnits];

  // this lane's units of token row `row` (units sub, sub + 4, ...)
  __device__ __forceinline__ void load(const float* row, int sub, int units, bool pred) {
    const T* p = reinterpret_cast<const T*>(row);
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = sub + kLanes * i;
      x[i] = pred && u < units ? __ldg(p + u) : T{};
    }
  }

  __device__ __forceinline__ float dot(const float* qsum, int sub, int units) const {
    const T* qv = reinterpret_cast<const T*>(qsum);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kUnits; ++i) {
      const int u = sub + kLanes * i;
      if (u < units) s += mul(qv[u], x[i]);
    }
    return s;
  }

  __device__ __forceinline__ static float mul(const float4& a, const float4& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  __device__ __forceinline__ static float mul(float a, float b) { return a * b; }
};

template <bool Vec, bool Wide>
__global__ void __launch_bounds__(kThreads)
lowrank_group_scores_kernel(const float* __restrict__ q_lr,     // [B, H, r]
                            const float* __restrict__ k_lr,     // [B, N, r]
                            const int32_t* __restrict__ valid,  // [B]
                            float* __restrict__ out,            // [B, n_groups]
                            int H, int N, int r, int G, int n_groups, int gpb) {
  __shared__ __align__(16) float qsum_narrow[Wide ? 1 : kMaxRank];
  extern __shared__ __align__(16) float qsum_wide[];   // [r], Wide only
  __shared__ float part[kThreads];
  __shared__ float sc[kTokens];
  float* qsum = Wide ? qsum_wide : qsum_narrow;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, n_groups - g0);      // groups of this block
  const int vl = min(valid[b], N);
  float* ob = out + (size_t)b * n_groups + g0;
  const long long t_first = (long long)g0 * G;
  if (t_first >= vl) {                         // every group past valid[b]: no reads
    for (int j = tid; j < ng; j += kThreads) ob[j] = kNeg;
    return;
  }

  const int units = Vec ? r / 4 : r;
  const int tok = tid / kLanes, sub = tid - tok * kLanes;
  const int span = ng * G;                     // the block's tokens (some may be masked)
  const float* kb = k_lr + (size_t)b * N * r;
  const float* qb = q_lr + (size_t)b * H * r;

  Row<Vec> row;
  int t = (int)t_first + tok;
  bool live = tok < span && t < vl;
  if constexpr (Wide) {
    // fold the head sum: one thread a column, every head
    for (int c = tid; c < r; c += kThreads) {
      float s = 0.f;
#pragma unroll 8
      for (int h = 0; h < H; ++h) s += __ldg(qb + (size_t)h * r + c);
      qsum[c] = s;
    }
  } else {
    // first pass's rows: in flight before the fold, so the two trips overlap
    row.load(kb + (size_t)t * r, sub, units, live);

    // fold the head sum: (256 / r) threads per column, independent loads
    const int per = kThreads / max(r, 1);     // r <= 256
    if (tid < per * r) {
      const int c = tid % r;
      float s = 0.f;
#pragma unroll 8
      for (int h = tid / r; h < H; h += per) s += __ldg(qb + (size_t)h * r + c);
      part[tid] = s;
    }
    __syncthreads();
    if (tid < r) {
      float s = 0.f;
      for (int j = 0; j < per; ++j) s += part[j * r + tid];
      qsum[tid] = s;
    }
  }
  __syncthreads();

  float best = kNeg;
  for (int pass = 0;;) {
    float s;
    if constexpr (Wide) {
      // the rank in chunks of 256 columns, one register row each
      constexpr int kChunk = Vec ? kMaxRank / 4 : kMaxRank;   // units a chunk
      s = 0.f;
      for (int u0 = 0; u0 < units; u0 += kChunk) {
        const int col = Vec ? 4 * u0 : u0;
        row.load(kb + (size_t)t * r + col, sub, min(kChunk, units - u0), live);
        s += row.dot(qsum + col, sub, min(kChunk, units - u0));
      }
    } else {
      s = row.dot(qsum, sub, units);
    }
    s += __shfl_xor_sync(kAll, s, 1);
    s += __shfl_xor_sync(kAll, s, 2);
    if (live) best = fmaxf(best, s);
    if (++pass * kTokens >= span) break;       // block-uniform
    const int local = pass * kTokens + tok;
    t = (int)t_first + local;
    live = local < span && t < vl;
    if constexpr (!Wide) row.load(kb + (size_t)t * r, sub, units, live);
  }
  if (sub == 0) sc[tok] = best;
  __syncthreads();

  // group max: one pass holds gpb whole groups; a longer group is one token
  // slot per thread, each already the max over its passes
  const int width = min(G, kTokens);
  for (int j = tid; j < ng; j += kThreads) {
    float gmax = kNeg;
    for (int i = j * width; i < (j + 1) * width; ++i) gmax = fmaxf(gmax, sc[i]);
    ob[j] = gmax;
  }
}

template <bool Vec, bool Wide>
int launch(const float* q_lr, const float* k_lr, const int32_t* valid, float* out,
           int H, int N, int r, int G, int n_groups, int gpb, dim3 grid, cudaStream_t st) {
  auto kernel = lowrank_group_scores_kernel<Vec, Wide>;
  const size_t smem = Wide ? (size_t)r * sizeof(float) : 0;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, st>>>(q_lr, k_lr, valid, out, H, N, r, G, n_groups, gpb);
  return 0;
}

}  // namespace

// q_lr [B,H,r] f32, k_lr [B,N,r] f32, valid [B] i32 -> out [B, ceil(N/G)] f32.
// All contiguous and 16-byte aligned on the current device; r >= 0 (past 256
// the wide instance, whose r floats of shared memory must fit the card's
// opt-in limit), G >= 1.  Launches on `stream`.  Returns a CUDA error code
// as an int (0 = success).
extern "C" int lowrank_group_scores_f32(const float* q_lr, const float* k_lr,
                                        const int32_t* valid, float* out,
                                        int B, int H, int N, int r, int G,
                                        void* stream) {
  if (r < 0 || G < 1) return (int)cudaErrorInvalidValue;
  const int n_groups = (N + G - 1) / G;
  if (B > 0 && n_groups > 0) {
    const int gpb = G <= kTokens ? kTokens / G : 1;   // groups per block
    dim3 grid((n_groups + gpb - 1) / gpb, B);
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = r % 4 == 0, wide = r > kMaxRank;
    const int err =
        vec ? (wide ? launch<true, true>(q_lr, k_lr, valid, out, H, N, r, G, n_groups, gpb, grid, st)
                    : launch<true, false>(q_lr, k_lr, valid, out, H, N, r, G, n_groups, gpb, grid, st))
            : (wide ? launch<false, true>(q_lr, k_lr, valid, out, H, N, r, G, n_groups, gpb, grid, st)
                    : launch<false, false>(q_lr, k_lr, valid, out, H, N, r, G, n_groups, gpb, grid, st));
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
