// Role logits of the sign conjecture's sampled points.
//
// Replaces fairify_tpu/verify/engine.py:_sample_role_logits: the masked
// forward of the x and x' role points, (R_pad * 32 * V, d) rows each, to
// their logits.  The engine's Phase S draws 32 points per open root and
// calls it once, the root axis padded to a power of two.
//
// Bound on the H100: fp32 FMA throughput of the forwards
// (2 * sum(in_l * out_l) flops per row); the rows are read once (d floats)
// and one logit per row is written.
//
// Design: the rows of both roles form one index space; each block stages
// the packed network in shared memory once and streams RL_ROWS rows through
// common.cuh:tile_forward in tiles of RL_TILE (register-blocked dense
// layers), writing each tile's logits straight to device memory.
#include "common.cuh"

#define RL_THREADS 256
#define RL_TILE 32
#define RL_ROWS 512

__global__ void __launch_bounds__(RL_THREADS)
kr_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ x,
          const float* __restrict__ xp, int N, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  float* P = smem;
  float* X = P + nd.total;
  float* A0 = X + RL_TILE * nd.ld;
  float* A1 = A0 + RL_TILE * nd.ld;
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * RL_ROWS;
  const long long rows = min((long long)RL_ROWS, 2LL * N - row0);
  for (int t0 = 0; t0 < rows; t0 += RL_TILE) {
    const int T = (int)min((long long)RL_TILE, rows - t0);
    for (int idx = tid; idx < T * d; idx += nt) {
      const int s = idx / d, j = idx - s * d;
      const long long q = row0 + t0 + s;
      const float* src = q < N ? x + q * d : xp + (q - N) * d;
      X[s * nd.ld + j] = src[j];
    }
    __syncthreads();
    tile_forward(nd, P, nullptr, X, A0, A1, T, out + row0 + t0);
  }
}

extern "C" int kr_role_logits(const void* params, const int* dims, int L,
                              const void* x, const void* xp, int N, void* out,
                              void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const size_t smem = sizeof(float) * (nd.total + 3 * RL_TILE * nd.ld);
  cudaError_t err = set_smem(kr_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (2LL * N + RL_ROWS - 1) / RL_ROWS;
  if (N > 0)
    kr_kernel<<<(unsigned)blocks, RL_THREADS, smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)x, (const float*)xp, N, (float*)out);
  return (int)cudaGetLastError();
}
