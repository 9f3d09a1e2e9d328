// K12 (row generator) — simulation samples regenerated from (seed, index),
// and the per-partition keys of utils/prng.py:grid_keys.
//
// Replaces fairify_tpu/verify/sweep.py:_sim_rows, which the heuristic retry
// launches for one partition whose masks changed after the parity pass: the
// same sim_size threefry rows as the prune pass and KD (key fold_in(key(seed),
// global index), randint over [lo, hi]), as f32 (N, S, d) for the host's
// exact forwards; and fairify_tpu/utils/prng.py:grid_keys (fold_in of each
// global index), which the sweep runs on the card once per prune and parity
// segment or chunk.
//
// Bound on the H100: one partition's draw is S d values (13,000 at AC-S1's
// sim_size 1,000), each two threefry draws of integer work, about 2.66 SM
// clocks a value (PERF.md); the output bytes (4 S d) are smaller still.  So
// a launch is bound by its own latency.  Design: the key derivation moves
// into the kernel (common.cuh:fold_in, then split_key), the boxes travel as
// a by-value argument (no host-to-device copy), and the entry point copies
// the rows to the caller's pinned host buffer on the same stream, so a
// retry row costs one launch, one transfer and one sync.  A block's threads
// own fixed (row, column) slots of a partition: thread t draws column t % d
// of rows t / d, t / d + rpp, ... (rpp = blockDim / d rows a pass), so its
// column's DrawDim is taken once and the index arithmetic is 32-bit (S d is
// checked below 2^31); blocks (x, p) split partition p's rows.  Each value
// goes through common.cuh's draw_value, the draw KA, row 3 and KD share, so
// every value is bit-equal to theirs.
#include "common.cuh"

#define K12_THREADS 256
// Box values (boxes x d) one launch takes by value: lo and hi, int32 each.
#define K12_MAX_VALUES 256

struct K12Boxes {
  int lo[K12_MAX_VALUES];
  int hi[K12_MAX_VALUES];
};

__global__ void __launch_bounds__(K12_THREADS)
k12_kernel(uint32_t s0, uint32_t s1, uint32_t index0, const K12Boxes boxes, int d, int S,
           float* __restrict__ out) {
  const int p = blockIdx.y;
  const int rpp = K12_THREADS / d, t = threadIdx.x;
  if (t >= rpp * d) return;
  const int j = t % d;
  uint32_t f0, f1;
  fold_in(s0, s1, index0 + (uint32_t)p, f0, f1);
  const SplitKey key = split_key(f0, f1);
  const DrawDim c = draw_dim(boxes.lo[p * d + j], boxes.hi[p * d + j] + 1);
  float* rows = out + (size_t)p * S * d;
  for (int s = blockIdx.x * rpp + t / d; s < S; s += gridDim.x * rpp) {
    const int n = s * d + j;
    rows[n] = draw_value(key, (uint32_t)n, c.minval, c.span, c.mult);
  }
}

// The keys (k0, k1) of global indices index0 .. index0 + n - 1 as int64 (n, 2)
// (prng.grid_keys' layout: 32-bit values in int64).
__global__ void k12_keys_kernel(uint32_t s0, uint32_t s1, uint32_t index0, int n,
                                long long* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t f0, f1;
  fold_in(s0, s1, index0 + (uint32_t)i, f0, f1);
  out[2 * i] = (long long)f0;
  out[2 * i + 1] = (long long)f1;
}

// Rows of N boxes (lo, hi: host int32 arrays of N x d), partition p's key
// fold_in((s0, s1), index0 + p), into dev_out (N, S, d) f32; with host_out
// (pinned host memory) also one asynchronous copy there, on the same
// stream.  Blocks (grid_x, N); grid_x from the wrapper
// (pruning.sim_rows_geometry).
extern "C" int k12_sim_rows(unsigned s0, unsigned s1, unsigned index0, const int* lo,
                            const int* hi, int N, int d, int S, int grid_x, void* dev_out,
                            void* host_out, void* stream) {
  if (N < 1 || N > 65535 || d < 1 || d > K12_THREADS || (long long)N * d > K12_MAX_VALUES ||
      S < 1 || (long long)S * d >= (1LL << 31) || grid_x < 1)
    return (int)cudaErrorInvalidValue;
  K12Boxes boxes;
  for (int i = 0; i < N * d; ++i) {
    boxes.lo[i] = lo[i];
    boxes.hi[i] = hi[i];
  }
  k12_kernel<<<dim3((unsigned)grid_x, (unsigned)N), K12_THREADS, 0, (cudaStream_t)stream>>>(
      s0, s1, index0, boxes, d, S, (float*)dev_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || host_out == nullptr) return (int)err;
  return (int)cudaMemcpyAsync(host_out, dev_out, sizeof(float) * (size_t)N * S * d,
                              cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}

extern "C" int k12_grid_keys(unsigned s0, unsigned s1, unsigned index0, int n, void* out,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    k12_keys_kernel<<<(unsigned)((n + 255LL) / 256), 256, 0, (cudaStream_t)stream>>>(
        s0, s1, index0, n, (long long*)out);
  return (int)cudaGetLastError();
}
