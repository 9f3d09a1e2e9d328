// Shared pieces of the port's CUDA kernels: the network descriptor, the
// host-side launcher helpers and the bit-exact threefry sampler.
//
// Network layout (utils/cuda_build.py:pack_net): per layer l a row-major
// weight block W_l (in_l x out_l), then its bias b_l (out_l), then its
// alive mask m_l (out_l), all float32, concatenated.  Kernels stage the
// whole buffer in shared memory once per block.  K6 reads the same layout
// with each weight row padded to an odd stride (cuda_build.pack_odd,
// make_desc's odd_rows), so lanes on consecutive rows hit distinct banks.
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
  int ldw[MAX_LAYERS];                              // row stride of W_l
  int w[MAX_LAYERS], b[MAX_LAYERS], m[MAX_LAYERS];  // offsets into params
  int n[MAX_LAYERS];                                // offsets into nsum
};

// odd_rows: cuda_build.pack_odd's layout, W_l rows of out_l | 1 floats.
static inline NetDesc make_desc(const int* dims, int L, bool odd_rows = false) {
  NetDesc nd;
  nd.L = L;
  nd.maxw = dims[0];
  int off = 0, noff = 0;
  for (int l = 0; l < L; ++l) {
    nd.in[l] = dims[l];
    nd.out[l] = dims[l + 1];
    nd.ldw[l] = odd_rows ? (dims[l + 1] | 1) : dims[l + 1];
    nd.w[l] = off;
    off += dims[l] * nd.ldw[l];
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

// Dynamic shared memory above 48 KB must be opted into per kernel and
// device.  The largest size opted into so far is kept per (kernel, device),
// so a launch pays cudaFuncSetAttribute only when it needs more.
template <typename K>
static inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Opted {
    const void* fn;
    int dev;
    size_t bytes;
  };
  static Opted opted[32];
  static int n_opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = (const void*)kernel;
  int slot = -1;
  for (int i = 0; i < n_opted; ++i)
    if (opted[i].fn == fn && opted[i].dev == dev) {
      if (opted[i].bytes >= bytes) return cudaSuccess;
      slot = i;
    }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (slot < 0 && n_opted < 32) slot = n_opted++;
  if (slot >= 0) opted[slot] = Opted{fn, dev, bytes};
  return cudaSuccess;
}

// The padded rows of a launch over its live rows: in each of `groups`
// (rows, width) arrays laid end to end, rows live .. rows - 1 take row live
// - 1 — what a launch over every row returns for padded rows that repeat
// that row's inputs (engine.fill_past).  Blocks (x, group).
template <typename T>
__global__ void fill_past_kernel(T* __restrict__ out, int rows, int live, int width) {
  T* g = out + (size_t)blockIdx.y * rows * width;
  const T* src = g + (size_t)(live - 1) * width;
  T* dst = g + (size_t)live * width;
  const size_t n = (size_t)(rows - live) * width;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = src[i % width];
}

// Launch fill_past_kernel (nothing when no row is padded); the caller reads
// cudaGetLastError.
template <typename T>
static inline void fill_past(T* out, int groups, int rows, int live, int width, void* stream) {
  if (live < 1 || live >= rows || width < 1 || groups < 1) return;
  const size_t blocks = ((size_t)(rows - live) * width + 255) / 256;
  fill_past_kernel<T><<<dim3((unsigned)(blocks < 264 ? blocks : 264), (unsigned)groups), 256, 0,
                        (cudaStream_t)stream>>>(out, rows, live, width);
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

// jax.random.fold_in(key, index): threefry2x32(key, (0, index)), the key
// of partition `index` under the seed's key words (k0, k1)
// (utils/prng.py:grid_keys).
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t index,
                                        uint32_t& f0, uint32_t& f1) {
  f0 = 0u;
  f1 = index;
  threefry2x32(k0, k1, f0, f1);
}

__device__ __forceinline__ uint32_t random_bits32(uint32_t k0, uint32_t k1,
                                                  uint64_t n) {
  uint32_t x0 = (uint32_t)(n >> 32), x1 = (uint32_t)n;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// The simulation draw: jax.random.randint(key, (S, d), minval, maxval)
// (jax/_src/random.py:_randint), element n = s * d + j of it.  Per
// dimension, the three constants of its reduction (DrawDim) depend on the
// box alone, so a kernel computes them once per (partition, dimension)
// (draw_dim) and each value takes two threefry draws and three `% span`
// (draw_value).  KA, row 3, KD (sim_tile.cuh) and K12 (sim_rows.cu) draw
// through these two helpers; utils/prng.py:draw_constants and draw_offset
// are their Python mirror.
struct DrawDim {
  uint32_t minval, span, mult;  // mult = (65536 % span)^2 mod 2^32 % span
};

__host__ __device__ inline DrawDim draw_dim(int minval, int maxval) {
  DrawDim c;
  c.minval = (uint32_t)minval;
  c.span = maxval <= minval ? 1u : (uint32_t)maxval - (uint32_t)minval;
  const uint32_t m = 65536u % c.span;
  c.mult = (m * m) % c.span;
  return c;
}

__device__ __forceinline__ float draw_value(const SplitKey& k, uint64_t n, uint32_t minval,
                                            uint32_t span, uint32_t mult) {
  const uint32_t hb = random_bits32(k.hi0, k.hi1, n);
  const uint32_t lb = random_bits32(k.lo0, k.lo1, n);
  uint32_t off = (hb % span) * mult + (lb % span);
  off %= span;
  return (float)(int32_t)(minval + off);
}

// Warp-wide reductions, and a block-wide minimum through shared scratch of
// >= 32 floats.
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
