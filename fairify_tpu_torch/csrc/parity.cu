// KD — the parity pass: pruned-vs-original prediction agreement.
//
// Replaces fairify_tpu/verify/sweep.py:_mega_parity_kernel (the lax.scan of
// _parity_grid_from_keys): per partition, regenerate the same sim_size
// threefry samples as the prune pass (same key, same randint), run the
// forward of the original net and of the masked net (hidden layers use the
// partition's alive mask, the last layer stays all ones), and return the
// fraction of samples whose `logit > 0` predictions agree.
//
// Bound on the H100: fp32 FMA throughput — two forwards per sample, twice
// the prune pass's flops (8.0e11 on the 16,000-partition adult grid); the
// bytes (boxes, masks in; one float per partition out) are negligible.
//
// Design: the prune kernel's layout (one block per partition, network in
// dynamic shared memory, samples generated in registers and pushed through
// the layers in shared-memory tiles); the two forwards share each tile's
// samples, and agreement is counted with one shared-memory atomic per row.
#include "common.cuh"

#define KD_THREADS 256
#define KD_TILE 32

__global__ void __launch_bounds__(KD_THREADS)
kd_kernel(NetDesc nd, const float* __restrict__ params,
          const uint32_t* __restrict__ keys, const float* __restrict__ lo,
          const float* __restrict__ hi, const float* __restrict__ alive,
          int nhid, int S, float* __restrict__ parity) {
  extern __shared__ float smem[];
  float* P = smem;
  float* X = P + nd.total;           // sample tile (kept for both passes)
  float* A0 = X + KD_TILE * nd.ld;
  float* A1 = A0 + KD_TILE * nd.ld;
  float* AL = A1 + KD_TILE * nd.ld;  // this partition's hidden alive masks
  float* lg0 = AL + nhid;
  float* lg1 = lg0 + KD_TILE;
  int* box = (int*)(lg1 + KD_TILE);
  int* agree = box + 2 * nd.in[0];

  const int p = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int d = nd.in[0];
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  for (int i = tid; i < nhid; i += nt) AL[i] = alive[(size_t)p * nhid + i];
  for (int j = tid; j < d; j += nt) {
    box[j] = (int)lo[(size_t)p * d + j];
    box[d + j] = (int)hi[(size_t)p * d + j] + 1;
  }
  if (tid == 0) *agree = 0;
  __syncthreads();

  const SplitKey key = split_key(keys[2 * p], keys[2 * p + 1]);
  for (int t0 = 0; t0 < S; t0 += KD_TILE) {
    const int T = min(KD_TILE, S - t0);
    for (int idx = tid; idx < T * d; idx += nt) {
      const int s = idx / d, j = idx - s * d;
      const uint64_t n = (uint64_t)(t0 + s) * d + j;
      X[s * nd.ld + j] = sample_value(key, n, box[j], box[d + j]);
    }
    __syncthreads();
    tile_forward(nd, P, nullptr, X, A0, A1, T, lg0);
    tile_forward(nd, P, AL, X, A0, A1, T, lg1);
    if (tid < T && ((lg0[tid] > 0.f) == (lg1[tid] > 0.f))) atomicAdd(agree, 1);
    __syncthreads();
  }
  if (tid == 0) parity[p] = (float)(*agree) * (1.f / (float)S);  // XLA's mean
}

extern "C" int kd_parity(const void* params, const int* dims, int L,
                         const void* keys, const void* lo, const void* hi,
                         const void* alive, int nhid, int N, int S, void* parity,
                         void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const size_t smem = sizeof(float) * (nd.total + 3 * KD_TILE * nd.ld + nhid + 2 * KD_TILE)
                      + sizeof(int) * (2 * nd.in[0] + 1);
  cudaError_t err = set_smem(kd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    kd_kernel<<<N, KD_THREADS, smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const uint32_t*)keys, (const float*)lo,
        (const float*)hi, (const float*)alive, nhid, S, (float*)parity);
  return (int)cudaGetLastError();
}
