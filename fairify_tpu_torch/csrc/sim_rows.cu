// K12 (row generator) — simulation samples regenerated from partition keys.
//
// Replaces fairify_tpu/verify/sweep.py:_sim_rows, which the heuristic retry
// launches for one partition whose masks changed after the parity pass: the
// same sim_size threefry rows as the prune pass and KD (same key, same
// randint over [lo, hi]), written out as f32 (N, S, d) for the host's exact
// forwards.
//
// Bound on the H100: the output bytes (S·d·4 per partition); the threefry
// work is integer arithmetic, which the fp32 bound does not count.
//
// Design: one grid row (blockIdx.y) per partition, threads striding over
// its S·d values; each thread derives the split key once and draws each
// value through common.cuh's draw_dim and draw_value, the helpers KA, row 3
// and KD draw through, so every value is bit-equal to theirs.
#include "common.cuh"

#define K12_THREADS 256

__global__ void __launch_bounds__(K12_THREADS)
k12_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ lo,
           const float* __restrict__ hi, int d, int S, float* __restrict__ out) {
  const int p = blockIdx.y;
  const SplitKey key = split_key(keys[2 * p], keys[2 * p + 1]);
  const uint64_t total = (uint64_t)S * d;
  float* row = out + (size_t)p * total;
  for (uint64_t n = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; n < total;
       n += (uint64_t)gridDim.x * blockDim.x) {
    const int j = (int)(n % (uint64_t)d);
    const DrawDim c = draw_dim((int)lo[(size_t)p * d + j], (int)hi[(size_t)p * d + j] + 1);
    row[n] = draw_value(key, n, c.minval, c.span, c.mult);
  }
}

extern "C" int k12_sim_rows(const void* keys, const void* lo, const void* hi,
                            int N, int d, int S, void* out, void* stream) {
  if (N > 0 && S > 0 && d > 0) {
    const uint64_t total = (uint64_t)S * d;
    const uint64_t blocks = (total + K12_THREADS - 1) / K12_THREADS;
    const unsigned bx = blocks < 64 ? (unsigned)blocks : 64u;
    k12_kernel<<<dim3(bx, N), K12_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keys, (const float*)lo, (const float*)hi, d, S, (float*)out);
  }
  return (int)cudaGetLastError();
}
