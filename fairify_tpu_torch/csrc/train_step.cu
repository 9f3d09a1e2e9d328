// Rows 25-28 — the training and repair steps of the experiment path, one
// cooperative launch each.
//
// Replaces four plain jax.jit functions of the JAX package:
//   bce_adam_step      fairify_tpu/models/train.py:66 `step` (row 25) and
//                      fairify_tpu/analysis/repair.py:68 `_fit.step` (row 26:
//                      the gradient times a 0/1 mask per parameter);
//   pair_adam_step     fairify_tpu/analysis/repair.py:284 `pair_step` (row 27:
//                      lw·½(BCE(x)+BCE(x')) + lc·mean((σ(f(x))−σ(f(x')))²)
//                      + la·Σ(θ−θ₁)²);
//   pair_inconsistency fairify_tpu/analysis/repair.py:303 `inconsistency`
//                      (row 28: mean |σ(f(x))−σ(f(x'))| over all pairs).
// The steps compute JAX's function, not its blocks: the masked MLP forward
// h = relu(z)·m with relu'(0) = 0, BCE as −y·log σ(x) − (1−y)·log σ(−x)
// (log1pf/expf, no fast intrinsics) with gradient (σ(x) − y)/B, then
// optax.adam in optax's order and rounding: mu = (1−b1)·g + b1·mu,
// nu = (1−b2)·g² + b2·nu, u = (mu/bc1) / (sqrt(nu/bc2) + eps),
// θ = θ + (−lr)·u (bc1, bc2 = 1 − b^t come from the host).  Unlike JAX,
// which returns new arrays, θ, m and v are updated in place.
//
// Bound on the H100 (ops/train_step.py:step_cost): a step is tiny — 6·MACs
// flops a row for the forward and backward less layer 0's input gradient,
// which no step needs (a pair is two rows), plus ~30 per parameter for the
// tile sums and Adam, over 6·4·P bytes (θ, m, v read and written; 7·4·P
// with the mask or the anchor) plus the batch; at the AC-S1 shape
// (P = 12,801, B = 128), against the published 3.35 TB/s and 67 TFLOP/s
// fp32, that is 0.09 µs of bytes and 0.14 µs of flops, so a launch is
// latency: the grid sync, the layer chain and the launch itself.
//
// Design.  Phase 1: blocks own tiles of R batch rows (R pairs: 2R rows) and
// carry them through every layer in shared memory — the gather of the rows
// by the batch's index vector, the forward (pre-activations kept for the
// backward), the output gradient and loss terms, the backward; each tile
// writes its partial gradient of every parameter to its own scratch row
// and its loss sums to its own slots.  After a grid sync, phase 2: blocks
// own chunks of `threads` parameters; a thread sums its parameter's tile
// partials in tile order (no float atomics), adds the anchor gradient,
// applies the mask and Adam.  Every sum runs in a fixed order that depends
// on neither the grid nor the timing, so two launches on the same inputs
// are bit-equal.  With the mask at 0 and m = v = 0 an entry's update is
// 0 / (0 + eps) = 0: θ, m and v stay bit-unchanged.  Rows past B in the
// last tile are gathered as zeros and left out of every sum.
//
// Layout of θ (models/mlp.py:param_offsets): per layer W_l (in_l x out_l,
// row-major, the Keras layout) then b_l (out_l).  `alive` holds each layer's
// alive mask (out_l floats, layers end to end; the last layer's is unused).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#ifndef SMEM_LIMIT
#define SMEM_LIMIT 232448  // as warp_tile.cuh: dynamic shared memory a block may use
#endif
#define TS_THREADS 256
#define MODE_BCE 0
#define MODE_PAIR 1
#define MODE_INC 2

struct TDesc {
  int L, P, S, maxw;
  int in[MAX_LAYERS], out[MAX_LAYERS];
  int w[MAX_LAYERS], b[MAX_LAYERS];  // offsets into θ
  int a[MAX_LAYERS];                 // offsets into alive
  int z[MAX_LAYERS];                 // column of layer l's pre-activations in a row tile
};

static inline TDesc make_tdesc(const int* dims, int L) {
  TDesc D;
  D.L = L;
  D.maxw = dims[0];
  int off = 0, aoff = 0, col = dims[0];
  for (int l = 0; l < L; ++l) {
    D.in[l] = dims[l];
    D.out[l] = dims[l + 1];
    D.w[l] = off;
    off += dims[l] * dims[l + 1];
    D.b[l] = off;
    off += dims[l + 1];
    D.a[l] = aoff;
    aoff += dims[l + 1];
    D.z[l] = col;
    col += dims[l + 1];
    if (dims[l + 1] > D.maxw) D.maxw = dims[l + 1];
  }
  D.P = off;
  D.S = col;
  return D;
}

struct StepArgs {
  float *theta, *m, *v;
  const float *mask, *anchor, *alive;
  const float *X, *Xp, *y;
  const long long* idx;  // batch row -> dataset row; null: the identity
  int B, mode, R, tiles, chunks;
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, wl, wc, wa;
  float* part;   // tiles x P: each tile's partial gradient
  float* lpart;  // tiles x 3: each tile's loss sums
  float* apart;  // chunks: the anchor's sum over each parameter chunk
  float* loss;   // the step's loss (row 28: the mean inconsistency)
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// optax.sigmoid_binary_cross_entropy: log σ(±x) = −(max(∓x, 0) + log1p(exp(−|x|))).
__device__ __forceinline__ float bce(float x, float y) {
  const float l1 = log1pf(expf(-fabsf(x)));
  const float ls_p = -(fmaxf(-x, 0.f) + l1);
  const float ls_n = -(fmaxf(x, 0.f) + l1);
  return -y * ls_p - (1.f - y) * ls_n;
}

// Phase 1 on tile t: gather, forward, output gradient and loss terms,
// backward into the tile's partial-gradient row.
__device__ void tile_pass(const TDesc& D, const StepArgs& A, int t, float* act, float* dza,
                          float* dzb, float* terms) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = A.R, S = D.S, mw = D.maxw, L = D.L, d = D.in[0];
  const bool pair = A.mode != MODE_BCE;
  const int RR = pair ? 2 * R : R;
  const int base = t * R;
  const int nv = min(R, A.B - base);
  for (int e = tid; e < RR * d; e += nt) {
    const int r = e / d, k = e - r * d, q = r % R;
    float val = 0.f;
    if (q < nv) {
      const long long src = A.idx ? A.idx[base + q] : (long long)(base + q);
      val = (r < R ? A.X : A.Xp)[src * d + k];
    }
    act[r * S + k] = val;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const int in = D.in[l], out = D.out[l];
    const float* W = A.theta + D.w[l];
    const float* bb = A.theta + D.b[l];
    const int pin = l == 0 ? 0 : D.z[l - 1];
    const float* al = l == 0 ? nullptr : A.alive + D.a[l - 1];
    for (int e = tid; e < RR * out; e += nt) {
      const int r = e / out, j = e - r * out;
      const float* h = act + r * S + pin;
      float s = 0.f;
      if (l == 0) {
        for (int k = 0; k < in; ++k) s = fmaf(h[k], W[k * out + j], s);
      } else {
        for (int k = 0; k < in; ++k) s = fmaf(fmaxf(h[k], 0.f) * al[k], W[k * out + j], s);
      }
      act[r * S + D.z[l] + j] = s + bb[j];
    }
    __syncthreads();
  }
  // The output layer's gradient (one logit a row) and the loss terms.
  const int zl = D.z[L - 1];
  const float invB = 1.f / (float)A.B;
  for (int q = tid; q < R; q += nt) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
    if (q < nv) {
      const long long src = A.idx ? A.idx[base + q] : (long long)(base + q);
      const float lx = act[q * S + zl];
      if (A.mode == MODE_BCE) {
        const float yv = A.y[src];
        t0 = bce(lx, yv);
        dza[q * mw] = (sigm(lx) - yv) / (float)A.B;
      } else {
        const float lp = act[(R + q) * S + zl];
        const float sx = sigm(lx), sp = sigm(lp);
        if (A.mode == MODE_INC) {
          t0 = fabsf(sx - sp);
        } else {
          const float yv = A.y[src];
          const float dd = sx - sp;
          t0 = bce(lx, yv);
          t1 = bce(lp, yv);
          t2 = dd * dd;
          const float hl = A.wl * 0.5f, c2 = A.wc * 2.f * dd;
          dza[q * mw] = (hl * (sx - yv) + c2 * (sx * (1.f - sx))) * invB;
          dza[(R + q) * mw] = (hl * (sp - yv) - c2 * (sp * (1.f - sp))) * invB;
        }
      }
    } else {
      dza[q * mw] = 0.f;
      if (pair) dza[(R + q) * mw] = 0.f;
    }
    terms[3 * q] = t0;
    terms[3 * q + 1] = t1;
    terms[3 * q + 2] = t2;
  }
  __syncthreads();
  if (tid == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < nv; ++q) {
      s0 += terms[3 * q];
      s1 += terms[3 * q + 1];
      s2 += terms[3 * q + 2];
    }
    A.lpart[3 * t] = s0;
    A.lpart[3 * t + 1] = s1;
    A.lpart[3 * t + 2] = s2;
  }
  if (A.mode == MODE_INC) {
    __syncthreads();
    return;
  }
  float* part = A.part + (size_t)t * D.P;
  const int halves = pair ? 2 : 1;
  float *dz = dza, *dn = dzb;
  for (int l = L - 1; l >= 0; --l) {
    const int in = D.in[l], out = D.out[l];
    const float* W = A.theta + D.w[l];
    const int pin = l == 0 ? 0 : D.z[l - 1];
    const float* al = l == 0 ? nullptr : A.alive + D.a[l - 1];
    for (int e = tid; e < in * out + out; e += nt) {
      float s = 0.f;
      if (e < in * out) {
        const int k = e / out, j = e - k * out;
        for (int hh = 0; hh < halves; ++hh)
          for (int q = 0; q < nv; ++q) {
            const int r = hh * R + q;
            const float hv = act[r * S + pin + k];
            s = fmaf(l == 0 ? hv : fmaxf(hv, 0.f) * al[k], dz[r * mw + j], s);
          }
        part[D.w[l] + e] = s;
      } else {
        const int j = e - in * out;
        for (int hh = 0; hh < halves; ++hh)
          for (int q = 0; q < nv; ++q) s += dz[(hh * R + q) * mw + j];
        part[D.b[l] + j] = s;
      }
    }
    if (l > 0) {
      for (int e = tid; e < RR * in; e += nt) {
        const int r = e / in, k = e - r * in;
        float s = 0.f;
        for (int j = 0; j < out; ++j) s = fmaf(dz[r * mw + j], W[k * out + j], s);
        dn[r * mw + k] = act[r * S + pin + k] > 0.f ? s * al[k] : 0.f;
      }
    }
    __syncthreads();
    float* tmp = dz;
    dz = dn;
    dn = tmp;
  }
}

// Phase 2 on parameter chunk c: the tile partials summed in tile order, the
// anchor gradient, the mask, Adam; the chunk's anchor sum (pair step) by a
// fixed tree.
__device__ void adam_chunk(const TDesc& D, const StepArgs& A, int c, float* red) {
  const int tid = threadIdx.x;
  const int p = c * blockDim.x + tid;
  float anc = 0.f;
  if (p < D.P) {
    float g = 0.f;
    for (int t = 0; t < A.tiles; ++t) g += A.part[(size_t)t * D.P + p];
    const float th = A.theta[p];
    if (A.mode == MODE_PAIR) {
      const float dl = th - A.anchor[p];
      anc = dl * dl;
      g += A.wa * (2.f * dl);
    }
    if (A.mask) g *= A.mask[p];
    const float mu = __fadd_rn(__fmul_rn(A.omb1, g), __fmul_rn(A.b1, A.m[p]));
    const float nu = __fadd_rn(__fmul_rn(A.omb2, __fmul_rn(g, g)), __fmul_rn(A.b2, A.v[p]));
    const float u = __fdiv_rn(__fdiv_rn(mu, A.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, A.bc2)), A.eps));
    A.m[p] = mu;
    A.v[p] = nu;
    A.theta[p] = __fadd_rn(th, __fmul_rn(-A.lr, u));
  }
  if (A.mode != MODE_PAIR) return;
  red[tid] = anc;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) A.apart[c] = red[0];
  __syncthreads();
}

__global__ void __launch_bounds__(TS_THREADS) ts_kernel(TDesc D, StepArgs A) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int RR = A.mode == MODE_BCE ? A.R : 2 * A.R;
  float* act = smem;
  float* dza = act + RR * D.S;
  float* dzb = dza + RR * D.maxw;
  float* terms = dzb + RR * D.maxw;
  float* red = terms + 3 * A.R;
  for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) tile_pass(D, A, t, act, dza, dzb, terms);
  grid.sync();
  if (A.mode != MODE_INC) {
    for (int c = blockIdx.x; c < A.chunks; c += gridDim.x) adam_chunk(D, A, c, red);
    if (A.mode == MODE_PAIR) grid.sync();
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < A.tiles; ++t) {
    s0 += A.lpart[3 * t];
    s1 += A.lpart[3 * t + 1];
    s2 += A.lpart[3 * t + 2];
  }
  const float fB = (float)A.B;
  if (A.mode == MODE_PAIR) {
    float anc = 0.f;
    for (int c = 0; c < A.chunks; ++c) anc += A.apart[c];
    const float b = 0.5f * (s0 / fB + s1 / fB);
    *A.loss = A.wl * b + A.wc * (s2 / fB) + A.wa * anc;
  } else {
    *A.loss = s0 / fB;
  }
}

// Dynamic shared memory of one block (ops/train_step.py:step_smem).
static inline long long ts_smem(const TDesc& D, int R, int mode) {
  const long long RR = mode == MODE_BCE ? R : 2LL * R;
  return 4LL * (RR * D.S + 2 * RR * D.maxw + 3LL * R + TS_THREADS);
}

// Shared launcher: checks the geometry, sizes the cooperative grid to the
// card's residency (tiles and chunks are grid-strided, so the grid changes
// no sum) and launches.
static int ts_launch(const int* dims, int L, StepArgs& A, int threads, long long smem,
                     void* stream) {
  if (L < 1 || L > MAX_LAYERS || threads != TS_THREADS || A.R < 1 || A.B < 1)
    return (int)cudaErrorInvalidValue;
  const TDesc D = make_tdesc(dims, L);
  if (D.out[L - 1] != 1 || smem != ts_smem(D, A.R, A.mode) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  A.tiles = (A.B + A.R - 1) / A.R;
  A.chunks = (D.P + threads - 1) / threads;
  cudaError_t err = set_smem(ts_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, resident = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  // The resident blocks of (device, shared memory), asked once: the
  // occupancy query costs more host time than a step's kernel.
  static struct { int dev; long long smem; int blocks; } seen[16];
  static int n_seen = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].smem == smem) resident = seen[i].blocks;
  if (resident == 0) {
    int nsm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ts_kernel, threads,
                                                             (size_t)smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * nsm;
    if (n_seen < 16) seen[n_seen++] = {dev, smem, resident};
  }
  const int want = A.mode == MODE_INC || A.tiles > A.chunks ? A.tiles : A.chunks;
  const int grid = want < resident ? want : resident;
  TDesc Dk = D;
  void* args[] = {(void*)&Dk, (void*)&A};
  err = cudaLaunchCooperativeKernel((const void*)ts_kernel, dim3(grid), dim3(threads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static void adam_args(StepArgs& A, float lr, float b1, float omb1, float b2, float omb2,
                      float eps, float bc1, float bc2) {
  A.lr = lr;
  A.b1 = b1;
  A.omb1 = omb1;
  A.b2 = b2;
  A.omb2 = omb2;
  A.eps = eps;
  A.bc1 = bc1;
  A.bc2 = bc2;
}

// Rows 25 and 26: one Adam step on the mean BCE of the batch rows idx[0..B)
// of (X, y); mask null for row 25.  part: tiles x P floats, lpart: tiles x 3.
extern "C" int bce_adam_step(const int* dims, int L, void* theta, void* m, void* v,
                             const void* mask, const void* alive, const void* X, const void* y,
                             const void* idx, int B, float lr, float b1, float omb1, float b2,
                             float omb2, float eps, float bc1, float bc2, void* part, void* lpart,
                             void* loss, int R, int threads, long long smem, void* stream) {
  StepArgs A = {};
  A.theta = (float*)theta;
  A.m = (float*)m;
  A.v = (float*)v;
  A.mask = (const float*)mask;
  A.alive = (const float*)alive;
  A.X = (const float*)X;
  A.y = (const float*)y;
  A.idx = (const long long*)idx;
  A.B = B;
  A.mode = MODE_BCE;
  A.R = R;
  adam_args(A, lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  A.part = (float*)part;
  A.lpart = (float*)lpart;
  A.loss = (float*)loss;
  return ts_launch(dims, L, A, threads, smem, stream);
}

// Row 27: one Adam step on the pair loss of the pairs idx[0..B) of
// (Xs, Xps, y) with the anchor θ₁.  apart: chunks floats.
extern "C" int pair_adam_step(const int* dims, int L, void* theta, void* m, void* v,
                              const void* anchor, const void* alive, const void* Xs,
                              const void* Xps, const void* y, const void* idx, int B, float lr,
                              float b1, float omb1, float b2, float omb2, float eps, float bc1,
                              float bc2, float wl, float wc, float wa, void* part, void* lpart,
                              void* apart, void* loss, int R, int threads, long long smem,
                              void* stream) {
  StepArgs A = {};
  A.theta = (float*)theta;
  A.m = (float*)m;
  A.v = (float*)v;
  A.anchor = (const float*)anchor;
  A.alive = (const float*)alive;
  A.X = (const float*)Xs;
  A.Xp = (const float*)Xps;
  A.y = (const float*)y;
  A.idx = (const long long*)idx;
  A.B = B;
  A.mode = MODE_PAIR;
  A.R = R;
  adam_args(A, lr, b1, omb1, b2, omb2, eps, bc1, bc2);
  A.wl = wl;
  A.wc = wc;
  A.wa = wa;
  A.part = (float*)part;
  A.lpart = (float*)lpart;
  A.apart = (float*)apart;
  A.loss = (float*)loss;
  return ts_launch(dims, L, A, threads, smem, stream);
}

// Row 28: mean |σ(f(x)) − σ(f(x'))| over the n pairs of (Xs, Xps); θ is
// only read.
extern "C" int pair_inconsistency(const int* dims, int L, const void* theta, const void* alive,
                                  const void* Xs, const void* Xps, int n, void* lpart, void* out,
                                  int R, int threads, long long smem, void* stream) {
  StepArgs A = {};
  A.theta = (float*)theta;
  A.alive = (const float*)alive;
  A.X = (const float*)Xs;
  A.Xp = (const float*)Xps;
  A.B = n;
  A.mode = MODE_INC;
  A.R = R;
  A.lpart = (float*)lpart;
  A.loss = (float*)out;
  return ts_launch(dims, L, A, threads, smem, stream);
}
