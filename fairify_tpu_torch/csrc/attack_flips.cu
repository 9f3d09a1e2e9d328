// KC — stage-0 attack: candidate forwards, strict flips, gap, stats, fold.
//
// Replaces the attack half of fairify_tpu/verify/sweep.py:
// _mega_stage0_kernel — engine._attack_logits, _find_flips_dev,
// _attack_gap_impl, sweep._chunk_stats_dev and sweep._fold_dev.  Per box:
// the logits of the host-drawn (S, V, d) candidates of both roles; the
// strict-sign flips (x positive / x' negative or the reverse) over valid
// assignment pairs, with the first hit in flat (s, a, b) order as the
// witness (argmax of a bool, 0 when none); the best flip gap; the reason
// code cert + 2*found; the (2, 14) margin/gap histogram increment of real
// rows (idx = sum(v >= edge)); and the int32 fold over cert, wit, reason and
// the histogram, accumulated with wrapping atomicAdd like
// resilience/integrity.py:fold_host.
//
// Bound on the H100: fp32 FMA throughput of the forwards
// (2 * 2 * S * V * sum(in_l * out_l) flops per box); the candidates are
// read once (2 * S * V * d floats per box).
//
// Design: one block per box.  Candidate rows stream through the network in
// shared-memory tiles (the prune kernel's layout) and every logit lands in
// shared memory; the flip scan strides threads over the S*V*V triples and
// reduces the first hit with a shared atomicMin and the gap with a block
// max.  Thread 0 writes the box's outputs and its histogram/fold atomics.
#include "common.cuh"

#define KC_THREADS 256
#define KC_TILE 32
#define N_EDGES 13

__global__ void __launch_bounds__(KC_THREADS)
kc_kernel(NetDesc nd, const float* __restrict__ params,
          const float* __restrict__ xr, const float* __restrict__ pr,
          const uint8_t* __restrict__ valid, const uint8_t* __restrict__ vpair,
          const uint8_t* __restrict__ cert, const float* __restrict__ margin,
          const uint8_t* __restrict__ okrow, const float* __restrict__ edges,
          int S, int V, int* __restrict__ wit, int8_t* __restrict__ reason,
          float* __restrict__ gap, int* __restrict__ stats,
          int* __restrict__ fold) {
  extern __shared__ float smem[];
  const int d = nd.in[0];
  const int SV = S * V, R = 2 * SV;
  float* P = smem;
  float* X = P + nd.total;
  float* A0 = X + KC_TILE * nd.ld;
  float* A1 = A0 + KC_TILE * nd.ld;
  float* LG = A1 + KC_TILE * nd.ld;  // lx[SV] then lp[SV]
  float* scratch = LG + R;           // 32
  int* first = (int*)(scratch + 32);

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  if (tid == 0) *first = INT_MAX;
  __syncthreads();

  for (int t0 = 0; t0 < R; t0 += KC_TILE) {
    const int T = min(KC_TILE, R - t0);
    for (int idx = tid; idx < T * d; idx += nt) {
      const int s = idx / d, j = idx - s * d;
      const int q = t0 + s;
      const float* src = q < SV ? xr + ((size_t)b * SV + q) * d
                                : pr + ((size_t)b * SV + (q - SV)) * d;
      X[s * nd.ld + j] = src[j];
    }
    __syncthreads();
    tile_forward(nd, P, nullptr, X, A0, A1, T, LG + t0);
  }
  __syncthreads();

  const float* lx = LG;
  const float* lp = LG + SV;
  const uint8_t* va = valid + (size_t)b * V;
  float gloc = -FLT_MAX;
  int floc = INT_MAX;
  for (int idx = tid; idx < S * V * V; idx += nt) {
    const int s = idx / (V * V), rem = idx - s * V * V;
    const int a = rem / V, c = rem - a * V;
    const float x = lx[s * V + a], y = lp[s * V + c];
    const bool vx = va[a], vy = va[c], vp = vpair[a * V + c];
    const bool flip = (((x > 0.f) && vx && (y < 0.f) && vy) ||
                       ((x < 0.f) && vx && (y > 0.f) && vy)) && vp;
    if (flip && idx < floc) floc = idx;
    if (vx && vy && vp) gloc = fmaxf(gloc, fmaxf(fminf(x, -y), fminf(-x, y)));
  }
  if (floc != INT_MAX) atomicMin(first, floc);
  const float g = block_max(gloc, scratch);  // syncs, so *first is final
  if (tid == 0) {
    const bool found = *first != INT_MAX;
    const int w = found ? *first : 0;
    const int ws = w / (V * V), wr = w - ws * V * V;
    const int wa = wr / V, wb = wr - wa * V;
    wit[3 * b + 0] = ws;
    wit[3 * b + 1] = wa;
    wit[3 * b + 2] = wb;
    const int rc = (int)cert[b] + (found ? 2 : 0);
    reason[b] = (int8_t)rc;
    gap[b] = g;
    int add = (int)cert[b] + ws + wa + wb + rc;
    if (okrow[b]) {
      int im = 0, ig = 0;
      for (int e = 0; e < N_EDGES; ++e) {
        im += margin[b] >= edges[e];
        ig += g >= edges[e];
      }
      atomicAdd(&stats[im], 1);
      atomicAdd(&stats[(N_EDGES + 1) + ig], 1);
      add += 2;
    }
    atomicAdd(fold, add);
  }
}

extern "C" int kc_attack_flips(const void* params, const int* dims, int L,
                               const void* xr, const void* pr, const void* valid,
                               const void* vpair, const void* cert,
                               const void* margin, const void* okrow,
                               const void* edges, int N, int S, int V, void* wit,
                               void* reason, void* gap, void* stats, void* fold,
                               void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const size_t smem = sizeof(float) * (nd.total + 3 * KC_TILE * nd.ld + 2 * S * V + 32)
                      + sizeof(int);
  cudaError_t err = set_smem(kc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    kc_kernel<<<N, KC_THREADS, smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)xr, (const float*)pr,
        (const uint8_t*)valid, (const uint8_t*)vpair, (const uint8_t*)cert,
        (const float*)margin, (const uint8_t*)okrow, (const float*)edges, S, V,
        (int*)wit, (int8_t*)reason, (float*)gap, (int*)stats, (int*)fold);
  return (int)cudaGetLastError();
}
