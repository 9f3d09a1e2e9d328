// K10, rows 17 and 9 — the forward logit of every attack candidate.
//
// Replaces fairify_tpu/verify/engine.py:_attack_logits (row 17: the IBP
// path's attack in the chunk loop, sweep.py:_stage0_block_submit, and in
// the host frontier's non-fused branch) and
// fairify_tpu/verify/sweep.py:_family_logits_kernel (row 9: the same mapped
// over a stacked family, every model on the same candidates), and, with one
// model, fairify_tpu/verify/engine.py:_sample_role_logits (Phase S's 32
// sampled role points per root).  The masked forward of each candidate row
// of the x role and of the x' role, (N, d) rows each, to its logit.
//
// Bound on the H100: fp32 FMA throughput, 2 * sum(in_l * out_l) flops per
// row and model (one 2,048-box AC-S1 chunk at S = 128, V = 2: 1,048,576
// rows x 12,552 MACs = 26.3 GFLOP, 0.39 ms at the fp32 peak); the rows are
// read once (d floats) and one logit per row and model is written.  At
// 20-50-1 widths (25 flops per input byte) loads count too.
//
// Design (warp_tile.cuh): a persistent grid sized to the card by the
// wrapper (engine.attack_logits_geometry), blockIdx.y the model of a
// stacked family.  Each block stages its model's padded net in shared
// memory with one bulk copy; each warp walks tiles of TW rows (x rows, then
// x' rows, as one index space), double-buffering the next tile's rows with
// cp.async while it carries the current one through every layer with
// __syncwarp only, and writes each tile's logits straight to device memory.
#include "common.cuh"
#include "warp_tile.cuh"

#define AL_MAX_WARPS 12

// Floats of one warp's tiles: two input tiles, two activation buffers.
__host__ __device__ inline long long al_warp_floats(const PadDesc& pd, int tw) {
  int h0, h1;
  hidden_buffers(pd, h0, h1);
  return (long long)(2 * pd.in[0] + h0 + h1) * tw;
}

// Dynamic shared memory: the mbarrier's 16 bytes, the forward part of the
// padded net, the warps' tiles (engine.attack_logits_smem is the same sum).
static inline long long al_smem(const PadDesc& pd, int tw, int warps) {
  return 4LL * (4 + pd.fwd + warps * al_warp_floats(pd, tw));
}

__device__ __forceinline__ void al_load_rows(float* X, const float* __restrict__ x,
                                             const float* __restrict__ xp, long long N,
                                             long long row0, int d, int tw, int smask,
                                             int lane) {
  const long long rows2 = 2 * N;
  for (int e = lane; e < tw * d; e += 32) {
    const int r = e / d, i = e - r * d;
    const long long q = row0 + r;
    if (q >= rows2) break;
    const float* src = q < N ? x + q * d + i : xp + (q - N) * d + i;
    cp_async4(X + act_off(i, r, tw, smask), src);
  }
}

__global__ void __launch_bounds__(AL_MAX_WARPS * 32, 1)
k10a_kernel(PadDesc pd, const float* __restrict__ params, const float* __restrict__ x,
            const float* __restrict__ xp, long long N, float* __restrict__ out, int tw) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int d = pd.in[0], smask = swz_mask(tw);
  int h0, h1;
  hidden_buffers(pd, h0, h1);
  float* base = P + pd.fwd + warp * al_warp_floats(pd, tw);
  float* X[2] = {base, base + d * tw};
  float* H[2] = {base + 2 * d * tw, base + (2 * d + h0) * tw};
  const uint32_t tiles_f = pick_tiles(pd.L, tw, [&](int l) { return pd.out[l]; });
  stage_net(P, params + (size_t)blockIdx.y * pd.total, pd.fwd, bar);

  const long long tiles = (2 * N + tw - 1) / tw;
  const long long stride = (long long)gridDim.x * nw;
  long long t = (long long)blockIdx.x * nw + warp;
  if (t < tiles) al_load_rows(X[0], x, xp, N, t * tw, d, tw, smask, lane);
  cp_async_commit();
  mbar_wait(bar, 0);
  float* om = out + (size_t)blockIdx.y * 2 * N;
  for (int buf = 0; t < tiles; t += stride, buf ^= 1) {
    if (t + stride < tiles)
      al_load_rows(X[buf ^ 1], x, xp, N, (t + stride) * tw, d, tw, smask, lane);
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();
    const long long row0 = t * tw;
    const float* cur = X[buf];
    for (int l = 0; l < pd.L; ++l) {
      const bool last = l + 1 == pd.L;
      Epi e;
      e.mode = last ? EPI_LOGIT : EPI_HIDDEN;
      e.bias = P + pd.b[l];
      e.mask = P + pd.m[l];
      e.out = H[l & 1];
      e.logit = om + row0;
      e.nvalid = (int)min((long long)tw, 2 * N - row0);
      e.bits = nullptr;
      e.tw = tw;
      e.smask = smask;
      warp_layer((tiles_f >> (3 * l)) & 7, cur, tw, smask, P + pd.w[l], pd.ldw[l], pd.in[l],
                 pd.out[l], lane, e);
      __syncwarp();
      cur = H[l & 1];
    }
  }
}

// The launch geometry comes from the wrapper (engine.attack_logits_geometry:
// rows per warp tile `tw`, warps per block, blocks per model, shared-memory
// bytes); it is checked here against the net and the kernel's limits.
extern "C" int k10_attack_logits(const void* params, const int* dims, int L, const void* x,
                                 const void* xp, long long N, int M, void* out, int tw,
                                 int warps, int grid, long long smem, void* stream) {
  const PadDesc pd = make_pad_desc(dims, L);
  if (tw < 4 || tw % 4 != 0 || tw > 64 || warps < 1 || warps > AL_MAX_WARPS || grid < 1 ||
      smem != al_smem(pd, tw, warps) || smem > SMEM_LIMIT || pd.out[L - 1] != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(k10a_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && M > 0)
    k10a_kernel<<<dim3((unsigned)grid, (unsigned)M), warps * 32, (size_t)smem,
                  (cudaStream_t)stream>>>(pd, (const float*)params, (const float*)x,
                                          (const float*)xp, N, (float*)out, tw);
  return (int)cudaGetLastError();
}
