// Shared pieces of the port's CUDA kernels: the network descriptor, the
// host-side launcher helpers and the bit-exact threefry sampler.
//
// Network layout (utils/cuda_build.py:pack_net): per layer l a row-major
// weight block W_l (in_l x out_l), then its bias b_l (out_l), then its
// alive mask m_l (out_l), all float32, concatenated.  Kernels stage the
// whole buffer in shared memory once per block.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#define MAX_LAYERS 8

// Outward widening of computed bounds (ops/interval.py: SOUND_SLACK_*).
#define SLACK_REL 1e-5f
#define SLACK_ABS 1e-6f

struct NetDesc {
  int L;       // layers
  int maxw;    // widest layer, input included
  int ld;      // odd row stride (>= maxw) for per-sample activation tiles
  int total;   // floats in the packed parameter buffer
  int nsum;    // sum of layer widths (per-neuron output rows)
  int in[MAX_LAYERS], out[MAX_LAYERS];
  int w[MAX_LAYERS], b[MAX_LAYERS], m[MAX_LAYERS];  // offsets into params
  int n[MAX_LAYERS];                                // offsets into nsum
};

static inline NetDesc make_desc(const int* dims, int L) {
  NetDesc nd;
  nd.L = L;
  nd.maxw = dims[0];
  int off = 0, noff = 0;
  for (int l = 0; l < L; ++l) {
    nd.in[l] = dims[l];
    nd.out[l] = dims[l + 1];
    nd.w[l] = off;
    off += dims[l] * dims[l + 1];
    nd.b[l] = off;
    off += dims[l + 1];
    nd.m[l] = off;
    off += dims[l + 1];
    nd.n[l] = noff;
    noff += dims[l + 1];
    if (dims[l + 1] > nd.maxw) nd.maxw = dims[l + 1];
  }
  nd.total = off;
  nd.nsum = noff;
  nd.ld = nd.maxw | 1;
  return nd;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
static inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// threefry2x32 (20 rounds), bit-identical to JAX's (jax/_src/prng.py) and to
// utils/prng.py's torch version.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.split(key, 2) on the partitionable path: counters (0,0), (0,1).
struct SplitKey {
  uint32_t hi0, hi1, lo0, lo1;
};

__device__ __forceinline__ SplitKey split_key(uint32_t k0, uint32_t k1) {
  SplitKey s;
  s.hi0 = 0u;
  s.hi1 = 0u;
  threefry2x32(k0, k1, s.hi0, s.hi1);
  s.lo0 = 0u;
  s.lo1 = 1u;
  threefry2x32(k0, k1, s.lo0, s.lo1);
  return s;
}

__device__ __forceinline__ uint32_t random_bits32(uint32_t k0, uint32_t k1,
                                                  uint64_t n) {
  uint32_t x0 = (uint32_t)(n >> 32), x1 = (uint32_t)n;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// Element n (flat index into the (S, d) draw) of
// jax.random.randint(key, (S, d), minval, maxval) — jax/_src/random.py:_randint.
__device__ __forceinline__ float sample_value(const SplitKey& k, uint64_t n,
                                              int minval, int maxval) {
  uint32_t span = (uint32_t)maxval - (uint32_t)minval;
  if (maxval <= minval) span = 1u;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t hb = random_bits32(k.hi0, k.hi1, n);
  const uint32_t lb = random_bits32(k.lo0, k.lo1, n);
  uint32_t off = (hb % span) * mult + (lb % span);
  off %= span;
  return (float)(int32_t)((uint32_t)minval + off);
}

// One dense layer over a tile of T activation rows held in shared memory
// (row stride ld), register-blocked: each thread owns RT_ROWS rows x
// RT_COLS columns of the output and keeps their sums in registers, so
// every k-step loads RT_ROWS activations (broadcast across the warp) and
// RT_COLS weights (neighbouring threads on neighbouring columns: the
// thread's columns are cg, cg + CG, cg + 2 CG, ...) for RT_ROWS * RT_COLS
// FMAs — two shared-memory loads per FMA become half a load.  Each sum is
// the index-ordered FMA chain from 0, so the result is bit-identical to a
// one-unit-per-thread loop.  Rows past T (the ragged last tile) and
// columns past nout are computed on stale/clamped operands and never
// passed on.  `epi(s0, nrows, j, v)` receives the pre-bias sums v[r] of
// column j for rows s0 .. s0 + nrows - 1.  Callers __syncthreads() after.
#define RT_ROWS 4
#define RT_COLS 4

template <typename Epi>
__device__ __forceinline__ void dense_tile(const float* __restrict__ cur, int ld,
                                           const float* __restrict__ W, int nin,
                                           int nout, int T, Epi epi) {
  const int CG = (nout + RT_COLS - 1) / RT_COLS;
  const int RG = (T + RT_ROWS - 1) / RT_ROWS;
  for (int item = threadIdx.x; item < RG * CG; item += blockDim.x) {
    const int cg = item % CG, s0 = (item / CG) * RT_ROWS;
    int jc[RT_COLS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c) jc[c] = min(cg + c * CG, nout - 1);
    float acc[RT_COLS][RT_ROWS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) acc[c][r] = 0.f;
    const float* x = cur + s0 * ld;
    for (int i = 0; i < nin; ++i) {
      float xv[RT_ROWS], wv[RT_COLS];
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) xv[r] = x[r * ld + i];
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c) wv[c] = W[i * nout + jc[c]];
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
        for (int r = 0; r < RT_ROWS; ++r) acc[c][r] = fmaf(xv[r], wv[c], acc[c][r]);
    }
    const int nrows = min(RT_ROWS, T - s0);
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
      if (cg + c * CG < nout) epi(s0, nrows, cg + c * CG, acc[c]);
  }
}

// One forward pass of a tile of T input rows X (row stride nd.ld) through
// the net: hidden activations alternate between the scratch tiles A0 and
// A1 (X is only read, so a second pass can reuse it).  `alive` (hidden
// layers, packed) replaces the net's masks when given.  Writes each row's
// logit (the last layer has one unit) to logit[s].
__device__ __forceinline__ void tile_forward(const NetDesc& nd, const float* P,
                                             const float* alive, const float* X,
                                             float* A0, float* A1, int T,
                                             float* logit) {
  const int L = nd.L;
  int aoff = 0;
  for (int l = 0; l < L; ++l) {
    const float* B = P + nd.b[l];
    const bool hidden = l < L - 1;
    const float* M = alive != nullptr && hidden ? alive + aoff : P + nd.m[l];
    const float* cur = l == 0 ? X : (l & 1 ? A0 : A1);
    float* nxt = l & 1 ? A1 : A0;
    const int ld = nd.ld;
    dense_tile(cur, ld, P + nd.w[l], nd.in[l], nd.out[l], T,
               [&](int s0, int nrows, int j, const float* v) {
#pragma unroll
                 for (int r = 0; r < RT_ROWS; ++r) {
                   if (r >= nrows) break;
                   const float z = v[r] + B[j];
                   if (hidden)
                     nxt[(s0 + r) * ld + j] = fmaxf(z, 0.f) * M[j];
                   else if (j == 0)
                     logit[s0 + r] = z;
                 }
               });
    __syncthreads();
    if (hidden) aoff += nd.out[l];
  }
}

// Block-wide reductions through shared scratch of >= 32 floats.
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_min(float v, float* scratch) {
  v = warp_min(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  float r = threadIdx.x < nw ? scratch[threadIdx.x] : FLT_MAX;
  if (wid == 0) r = warp_min(r);
  if (threadIdx.x == 0) scratch[0] = r;
  __syncthreads();
  r = scratch[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  float r = threadIdx.x < nw ? scratch[threadIdx.x] : -FLT_MAX;
  if (wid == 0) r = warp_max(r);
  if (threadIdx.x == 0) scratch[0] = r;
  __syncthreads();
  r = scratch[0];
  __syncthreads();
  return r;
}
