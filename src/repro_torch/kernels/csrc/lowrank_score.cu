// Low-rank group scoring (KVSwap Eq. 1) for sm_90a.
//
// Replaces the TPU kernel `_score_kernel` / `lowrank_group_scores_pallas`
// (src/repro/kernels/lowrank_score.py).  For each row b and each group of G
// consecutive tokens:
//
//   score[b, n] = sum_h q_lr[b, h, :] . k_lr[b, n, :]   (masked to -1e30 at n >= valid[b])
//   out[b, g]   = max over the G tokens of group g      (ragged last group allowed)
//
// The head sum is folded first, sum_h (q_h . k) = (sum_h q_h) . k, so each
// block stages q_lr[b] once, reduces it to one rank-r vector in shared
// memory, and the kernel becomes a GEMV over K_lr.  It is bound by the bytes
// of K_lr it reads: 2 flops per 4-byte element, far below the H100's
// balance point.  What the design does about that:
//   * one warp scores one group; for each token the 32 lanes read the token's
//     r floats side by side (one 256-byte coalesced row at r = 64) and
//     reduce with shuffles, so every byte of K_lr is read once, coalesced;
//   * groups wholly past valid[b] are written as -1e30 without reading K_lr,
//     so the bytes moved follow the valid tokens, not the cache capacity;
//   * the ragged tail (N not a multiple of G or of the tile) is
//     bounds-checked here, so the caller pads nothing.
// The folded sum rounds differently from the reference's per-head sum; the
// wrapper's plain version is held to it at 1e-5 of the row's score scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps per block
constexpr int kGroupsPerWarp = 4;   // groups each warp scores
constexpr int kMaxRank = 256;       // shared q-sum capacity (floats)
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kWarps * 32)
lowrank_group_scores_kernel(const float* __restrict__ q_lr,     // [B, H, r]
                            const float* __restrict__ k_lr,     // [B, N, r]
                            const int32_t* __restrict__ valid,  // [B]
                            float* __restrict__ out,            // [B, n_groups]
                            int H, int N, int r, int G, int n_groups) {
  __shared__ float qsum[kMaxRank];
  const int b = blockIdx.y;

  // fold the head sum into one rank-r query
  const float* qb = q_lr + (size_t)b * H * r;
  for (int c = threadIdx.x; c < r; c += blockDim.x) {
    float s = 0.f;
    for (int h = 0; h < H; ++h) s += qb[(size_t)h * r + c];
    qsum[c] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int vl = valid[b];
  if (vl > N) vl = N;
  const float* kb = k_lr + (size_t)b * N * r;
  const int g0 = (blockIdx.x * kWarps + warp) * kGroupsPerWarp;

  for (int gi = 0; gi < kGroupsPerWarp; ++gi) {
    const int grp = g0 + gi;
    if (grp >= n_groups) break;
    float gmax = kNeg;
    const int t0 = grp * G;
    // tokens at or past vl (or past N) stay at -1e30: the loop bound is
    // warp-uniform, so masked tokens are never read
    for (int t = t0; t < t0 + G && t < vl; ++t) {
      const float* row = kb + (size_t)t * r;
      float part = 0.f;
      for (int c = lane; c < r; c += 32) part += qsum[c] * row[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      gmax = fmaxf(gmax, part);
    }
    if (lane == 0) out[(size_t)b * n_groups + grp] = gmax;
  }
}

}  // namespace

// q_lr [B,H,r] f32, k_lr [B,N,r] f32, valid [B] i32 -> out [B, ceil(N/G)] f32.
// All contiguous on the current device; launches on `stream`.
// Returns cudaGetLastError() as an int (0 = success).
extern "C" int lowrank_group_scores_f32(const float* q_lr, const float* k_lr,
                                        const int32_t* valid, float* out,
                                        int B, int H, int N, int r, int G,
                                        void* stream) {
  if (r > kMaxRank || G < 1) return (int)cudaErrorInvalidValue;
  const int n_groups = (N + G - 1) / G;
  if (B > 0 && n_groups > 0) {
    const int per_block = kWarps * kGroupsPerWarp;
    dim3 grid((n_groups + per_block - 1) / per_block, B);
    lowrank_group_scores_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        q_lr, k_lr, valid, out, H, N, r, G, n_groups);
  }
  return (int)cudaGetLastError();
}
