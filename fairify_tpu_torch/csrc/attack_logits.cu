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
// read once (d floats) and one logit per row and model is written (55 MB).
//
// Design: the rows of both roles form one index space (x rows, then x'
// rows); blockIdx.x takes AL_ROWS of them, blockIdx.y the model of a
// stacked family (its packed net at m * nd.total floats, its logits at
// m * 2N).  Each block stages its model's packed network in shared memory
// once and streams its rows through common.cuh:tile_forward in tiles of
// AL_TILE (register-blocked dense layers, index-ordered fmaf chains),
// writing each tile's logits straight to device memory.
#include "common.cuh"

#define AL_THREADS 256
#define AL_TILE 32
#define AL_ROWS 512

__global__ void __launch_bounds__(AL_THREADS)
k10a_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ x,
            const float* __restrict__ xp, long long N, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  float* P = smem;
  float* X = P + nd.total;
  float* A0 = X + AL_TILE * nd.ld;
  float* A1 = A0 + AL_TILE * nd.ld;
  const float* Pm = params + (size_t)blockIdx.y * nd.total;
  for (int i = tid; i < nd.total; i += nt) P[i] = Pm[i];
  __syncthreads();
  float* om = out + (size_t)blockIdx.y * 2 * N;
  const long long row0 = (long long)blockIdx.x * AL_ROWS;
  const long long rows = min((long long)AL_ROWS, 2LL * N - row0);
  for (int t0 = 0; t0 < rows; t0 += AL_TILE) {
    const int T = (int)min((long long)AL_TILE, rows - t0);
    for (int idx = tid; idx < T * d; idx += nt) {
      const int s = idx / d, j = idx - s * d;
      const long long q = row0 + t0 + s;
      const float* src = q < N ? x + q * d : xp + (q - N) * d;
      X[s * nd.ld + j] = src[j];
    }
    __syncthreads();
    tile_forward(nd, P, nullptr, X, A0, A1, T, om + row0 + t0);
  }
}

extern "C" int k10_attack_logits(const void* params, const int* dims, int L,
                                 const void* x, const void* xp, long long N, int M,
                                 void* out, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const size_t smem = sizeof(float) * (nd.total + 3 * AL_TILE * nd.ld);
  cudaError_t err = set_smem(k10a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (2LL * N + AL_ROWS - 1) / AL_ROWS;
  if (N > 0 && M > 0)
    k10a_kernel<<<dim3((unsigned)blocks, (unsigned)M), AL_THREADS, smem,
                  (cudaStream_t)stream>>>(nd, (const float*)params, (const float*)x,
                                          (const float*)xp, N, (float*)out);
  return (int)cudaGetLastError();
}
