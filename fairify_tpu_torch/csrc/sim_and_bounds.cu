// KA — the prune pass: simulation statistics + IBP bounds per partition.
//
// Replaces fairify_tpu/verify/pruning.py:_mega_sim_and_bounds (the lax.scan
// over chunks of _sim_and_bounds): per partition, sim_size uniform integer
// samples from the box (jax.random.randint under the partition's threefry
// key), the masked forward of every sample, each neuron's activation count
// (candidates = never active, pos_prob = count * (1 / sim_size), the
// f32 arithmetic of XLA's mean), the widened IBP
// pre-activation bounds lb@W+ + ub@W- of every layer, and the per-layer
// sum of (ub - lb) (looseness telemetry).
//
// Bound on the H100: fp32 FMA throughput.  The forward costs
// 2 * sim_size * sum(in_l * out_l) flops per partition (4.0e11 on the
// 16,000-partition adult grid at 13-128-64-32-16-8-1); the bytes are
// boxes in and per-neuron rows out, a few MB.
//
// Design: one block per partition, so nothing crosses blocks.  The samples
// are generated in registers by the threefry device function and never
// touch device memory (the JAX package also never ships them).  The whole
// packed network (51 KB at AC-S1 widths, above the 48 KB static limit)
// sits in dynamic shared memory; samples run through the layers in tiles
// of KA_TILE rows kept in shared memory, each thread owning a 4 x 4 block
// of (sample, neuron) outputs in registers (common.cuh:dense_tile).
// Activation counts are shared-memory atomics, one per thread and neuron
// per tile.
#include "common.cuh"

#define KA_THREADS 256
#define KA_TILE 32

__global__ void __launch_bounds__(KA_THREADS)
ka_kernel(NetDesc nd, const float* __restrict__ params,
          const uint32_t* __restrict__ keys, const float* __restrict__ lo,
          const float* __restrict__ hi, int S, float* __restrict__ cand,
          float* __restrict__ pos, float* __restrict__ wslb,
          float* __restrict__ wsub, float* __restrict__ loos) {
  extern __shared__ float smem[];
  float* P = smem;
  float* A0 = P + nd.total;
  float* A1 = A0 + KA_TILE * nd.ld;
  float* blo = A1 + KA_TILE * nd.ld;
  float* bhi = blo + nd.maxw;
  float* red = bhi + nd.maxw;
  int* cnt = (int*)(red + nd.maxw);
  int* box = cnt + nd.nsum;  // minval[d], maxval[d]

  const int p = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int d = nd.in[0], L = nd.L;
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  for (int i = tid; i < nd.nsum; i += nt) cnt[i] = 0;
  for (int j = tid; j < d; j += nt) {
    const float l = lo[(size_t)p * d + j], h = hi[(size_t)p * d + j];
    blo[j] = l;
    bhi[j] = h;
    box[j] = (int)l;
    box[d + j] = (int)h + 1;
  }
  __syncthreads();

  // --- IBP: widened interval image of every layer --------------------------
  for (int l = 0; l < L; ++l) {
    const int nin = nd.in[l], nout = nd.out[l];
    const float* W = P + nd.w[l];
    const float* B = P + nd.b[l];
    const float* M = P + nd.m[l];
    for (int j = tid; j < nout; j += nt) {
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float w = W[i * nout + j];
        const float wp = fmaxf(w, 0.f), wn = fminf(w, 0.f);
        a1 = fmaf(blo[i], wp, a1);
        a2 = fmaf(bhi[i], wn, a2);
        a3 = fmaf(bhi[i], wp, a3);
        a4 = fmaf(blo[i], wn, a4);
      }
      float zlo = (a1 + a2) + B[j], zhi = (a3 + a4) + B[j];
      const float slack = SLACK_REL * fmaxf(fabsf(zlo), fabsf(zhi)) + SLACK_ABS;
      zlo -= slack;
      zhi += slack;
      const size_t o = (size_t)p * nd.nsum + nd.n[l] + j;
      wslb[o] = zlo;
      wsub[o] = zhi;
      A0[j] = zlo;
      A0[nd.ld + j] = zhi;
      red[j] = zhi - zlo;
    }
    __syncthreads();
    const bool hidden = l < L - 1;
    for (int j = tid; j < nout; j += nt) {
      blo[j] = hidden ? fmaxf(A0[j], 0.f) * M[j] : A0[j];
      bhi[j] = hidden ? fmaxf(A0[nd.ld + j], 0.f) * M[j] : A0[nd.ld + j];
    }
    if (tid == 0) {
      float s = 0.f;
      for (int j = 0; j < nout; ++j) s += red[j];
      loos[(size_t)p * L + l] = s;
    }
    __syncthreads();
  }

  // --- simulation: threefry samples through the masked forward -------------
  const SplitKey key = split_key(keys[2 * p], keys[2 * p + 1]);
  for (int t0 = 0; t0 < S; t0 += KA_TILE) {
    const int T = min(KA_TILE, S - t0);
    for (int idx = tid; idx < T * d; idx += nt) {
      const int s = idx / d, j = idx - s * d;
      const uint64_t n = (uint64_t)(t0 + s) * d + j;
      A0[s * nd.ld + j] = sample_value(key, n, box[j], box[d + j]);
    }
    __syncthreads();
    float* cur = A0;
    float* nxt = A1;
    for (int l = 0; l < L; ++l) {
      const float* B = P + nd.b[l];
      const float* M = P + nd.m[l];
      const bool hidden = l < L - 1;
      int* cl = cnt + nd.n[l];
      const int ld = nd.ld;
      dense_tile(cur, ld, P + nd.w[l], nd.in[l], nd.out[l], T,
                 [&](int s0, int nrows, int j, const float* v) {
                   int nz = 0;
#pragma unroll
                   for (int r = 0; r < RT_ROWS; ++r) {
                     if (r >= nrows) break;
                     const float z = v[r] + B[j];
                     const float h = hidden ? fmaxf(z, 0.f) * M[j] : z;
                     nxt[(s0 + r) * ld + j] = h;
                     nz += h != 0.f;
                   }
                   if (nz) atomicAdd(&cl[j], nz);
                 });
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  for (int i = tid; i < nd.nsum; i += nt) {
    const int c = cnt[i];
    const size_t o = (size_t)p * nd.nsum + i;
    pos[o] = (float)c * (1.f / (float)S);  // XLA's mean: sum * (1 / S)
    cand[o] = c == 0 ? 1.f : 0.f;
  }
}

extern "C" int ka_sim_and_bounds(const void* params, const int* dims, int L,
                                 const void* keys, const void* lo, const void* hi,
                                 int N, int S, void* cand, void* pos, void* wslb,
                                 void* wsub, void* loos, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const size_t smem = sizeof(float) * (nd.total + 2 * KA_TILE * nd.ld + 3 * nd.maxw)
                      + sizeof(int) * (nd.nsum + 2 * nd.in[0]);
  cudaError_t err = set_smem(ka_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    ka_kernel<<<N, KA_THREADS, smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const uint32_t*)keys, (const float*)lo,
        (const float*)hi, S, (float*)cand, (float*)pos, (float*)wslb,
        (float*)wsub, (float*)loos);
  return (int)cudaGetLastError();
}
