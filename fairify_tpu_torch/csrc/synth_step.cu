// Rows 29-30 — the autoregressive column synthesizer's training step and
// its sampler, one launch each.
//
// Replaces two plain jax.jit functions of fairify_tpu/models/synth.py:
//   synth_adam_step  :283 `step` (row 29): one optax.adam step on the
//                    masked-prefix NLL of ARColumnModel.fit — for every row b
//                    of the batch and every target column j, the trunk
//                    h1 = relu(pref·w1 + b1), h2 = relu(h1·w2 + b2) over the
//                    one-hot prefix of the columns before j, the head
//                    logits = h2·wh[j] + bh[j] (+ −1e30 on the padded
//                    classes), log_softmax, and −mean over B·d of the
//                    target's log-probability;
//   synth_draw       :315 `draw` (row 30): the d column steps of sampling in
//                    one launch — per row and column the trunk over the
//                    columns drawn so far, the head, and
//                    jax.random.categorical: argmax(gumbel(sub_j) + logits),
//                    the first index winning ties.
//
// What the kernels exploit.  The prefix is one-hot and causal: layer 1's
// pre-activation of target j is b1 + Σ_{c<j} w1[off_c + x_c], a running sum
// of gathered w1 rows, so no (B, d, D) tensor is formed; the sum starts at 0
// and b1 is added last, as XLA adds the bias to x·w1.  In the backward pass
// w1's row off_c + x_bc collects the suffix sum Σ_{j>c} ∂pre1[b, j].  The
// padded classes are never computed: their gradient is exactly 0, so Adam
// leaves θ, m and v of those entries bit-unchanged (0 / (0 + eps) = 0), and
// they never win a draw.
//
// Numerics: f32, TF32 off, no fast-math intrinsics (expf/logf as compiled
// with IEEE division and no flush to zero).  Adam follows optax's order and
// rounding exactly as train_step.cu does (mu, nu, u = (mu/bc1) /
// (sqrt(nu/bc2) + eps), θ + (−lr)·u, each operation one f32 rounding).  The
// draw's gumbel is JAX 0.9's mode="low": u = max(tiny, f·(1 − tiny) + tiny)
// with f the 23 high
// bits of threefry2x32(sub_j, flat index r·kmax + k) as a mantissa in [1, 2)
// less 1, then −log(−log(u)) (jax/_src/random.py:_gumbel, _uniform); the
// subkeys come from the host (jax.random.split of the run key, column by
// column), the bits from common.cuh:random_bits32.
//
// Design of the step (one cooperative launch).  Phase 1: blocks own tiles of
// R batch rows and write, for each (row, target) pair, h1, h2, the logit
// gradient (softmax − onehot)/N, ∂pre2 and the suffix sums of ∂pre1 to
// global scratch, plus each tile's partial sums of ∂w2, ∂b2, ∂b1 and its
// loss terms.  After a grid sync, phase 2: a thread owns a parameter and
// sums its gradient in a fixed order — w1 over the batch rows whose column
// holds its slot, wh and bh over the batch rows of their column, w2, b2,
// b1 over the tile partials in tile order — then applies Adam.  No float
// atomics: two launches on the same inputs are bit-equal.
//
// Design of the draw.  A block owns R rows and keeps, per row, the running
// w1 sum, h1, h2 and the perturbed logits in shared memory; it walks the d
// columns with block barriers between the trunk, the head and the argmax.
//
// Bound on the H100 (ops/synth_step.py:step_cost, draw_cost).  The step:
// per row (d − 1)·H adds of the running w1 sums; per (row, target j) 2·H²
// flops of layer 2 and 2·H·K_j of the head forward, twice each backward,
// ~5·K_j of the softmax, ~3·H of the bias gradients and suffix sums; 14
// operations an Adam parameter.  At the GC shape (d = 21, D = 182, H = 64,
// kmax = 64, B = 256, P = 103,232) 0.153 GFLOP, 2.28 µs at 67 TFLOP/s fp32,
// against 2.5 MB (θ, m, v both ways and the batch), 0.75 µs at 3.35 TB/s:
// bound by operations.  The draw: per row and column 2·H + 2·H² + 2·H·K_j
// + 4·K_j; at n = 2,000 0.397 GFLOP, 5.93 µs, against 0.58 MB, 0.17 µs:
// bound by operations.  The threefry draws are integer work beside that
// (n·Σ K_j values).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SS_THREADS 256
#define SD_THREADS 128

// Shapes and the offsets of the six parameters in θ (ops/synth_step.py:
// param_layout): w1 (D, H), b1 (H), w2 (H, H), b2 (H), wh (d, H, kmax),
// bh (d, kmax), row-major, end to end.
struct SynthDesc {
  int d, D, H, kmax;
  int w1, b1, w2, b2, wh, bh, P;
};

static inline SynthDesc make_sdesc(int d, int D, int H, int kmax) {
  SynthDesc S;
  S.d = d;
  S.D = D;
  S.H = H;
  S.kmax = kmax;
  S.w1 = 0;
  S.b1 = S.w1 + D * H;
  S.w2 = S.b1 + H;
  S.b2 = S.w2 + H * H;
  S.wh = S.b2 + H;
  S.bh = S.wh + d * H * kmax;
  S.P = S.bh + d * kmax;
  return S;
}

struct SynthStepArgs {
  float *theta, *m, *v;
  const int* codes;      // (n, d) class codes of the dataset rows
  const long long* idx;  // (B) batch row -> dataset row
  const int *off, *card; // (d) one-hot offsets and cardinalities
  int B, R, tiles, chunks;
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, invN;
  float *h1, *h2, *dl, *dp2, *sfx;  // scratch: (B·d, H) and dl (B·d, kmax)
  float* part;   // tiles x (H·H + 2H): each tile's ∂w2, ∂b2, ∂b1
  float* lpart;  // tiles: each tile's sum of −log p(target)
  float* loss;   // the step's loss
};

// Phase 1 on tile t: the forward and backward of its (row, target) pairs.
__device__ void synth_tile(const SynthDesc& S, const SynthStepArgs& A, int t, float* terms) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = S.d, H = S.H, K = S.kmax;
  const int base = t * A.R;
  const int nv = min(A.R, A.B - base);
  const int RD = nv * d;
  const float* th = A.theta;
  const long long g0 = (long long)base * d;  // first global pair of the tile
  // h1 = relu(Σ_{c<j} w1[off_c + x_c] + b1): a thread a (row, unit) keeps
  // the running prefix sum over the targets in column order
  for (int e = tid; e < nv * H; e += nt) {
    const int r = e / H, h = e - r * H;
    const int* x = A.codes + A.idx[base + r] * d;
    float a = 0.f;
    for (int j = 0; j < d; ++j) {
      A.h1[(g0 + (long long)r * d + j) * H + h] = fmaxf(a + th[S.b1 + h], 0.f);
      if (j + 1 < d) a += th[S.w1 + (A.off[j] + x[j]) * H + h];
    }
  }
  __syncthreads();
  // h2 = relu(h1·w2 + b2)
  for (int e = tid; e < RD * H; e += nt) {
    const int p = e / H, h = e - p * H;
    const float* a = A.h1 + (g0 + p) * H;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(a[k], th[S.w2 + k * H + h], s);
    A.h2[(g0 + p) * H + h] = fmaxf(s + th[S.b2 + h], 0.f);
  }
  __syncthreads();
  // the head's logits of the real classes (the padded ones stay 0 here and
  // are never read)
  for (int e = tid; e < RD * K; e += nt) {
    const int p = e / K, k = e - p * K, j = p % d;
    float s = 0.f;
    if (k < A.card[j]) {
      const float* a = A.h2 + (g0 + p) * H;
      const float* w = th + S.wh + (long long)j * H * K + k;
      for (int h = 0; h < H; ++h) s = fmaf(a[h], w[h * K], s);
      s += th[S.bh + j * K + k];
    }
    A.dl[(g0 + p) * K + k] = s;
  }
  __syncthreads();
  // log_softmax over the real classes; the loss term −log p(target) and the
  // logit gradient (softmax − onehot)/N in place of the logits
  for (int p = tid; p < RD; p += nt) {
    const int r = p / d, j = p - r * d;
    const int tgt = A.codes[A.idx[base + r] * d + j];
    const int kc = A.card[j];
    float* l = A.dl + (g0 + p) * K;
    float mx = l[0];
    for (int k = 1; k < kc; ++k) mx = fmaxf(mx, l[k]);
    float se = 0.f;
    for (int k = 0; k < kc; ++k) se += expf(l[k] - mx);
    terms[p] = -((l[tgt] - mx) - logf(se));
    for (int k = 0; k < kc; ++k) {
      const float q = expf(l[k] - mx) / se;
      l[k] = (k == tgt ? q - 1.f : q) * A.invN;
    }
  }
  __syncthreads();
  // ∂pre2 = (wh[j]·∂logits) where h2 > 0
  for (int e = tid; e < RD * H; e += nt) {
    const int p = e / H, h = e - p * H, j = p % d;
    const float* g = A.dl + (g0 + p) * K;
    const float* w = th + S.wh + ((long long)j * H + h) * K;
    float s = 0.f;
    for (int k = 0; k < A.card[j]; ++k) s = fmaf(w[k], g[k], s);
    A.dp2[(g0 + p) * H + h] = A.h2[(g0 + p) * H + h] > 0.f ? s : 0.f;
  }
  __syncthreads();
  // ∂pre1 = (w2·∂pre2) where h1 > 0, into sfx
  for (int e = tid; e < RD * H; e += nt) {
    const int p = e / H, h = e - p * H;
    const float* g = A.dp2 + (g0 + p) * H;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(th[S.w2 + h * H + k], g[k], s);
    A.sfx[(g0 + p) * H + h] = A.h1[(g0 + p) * H + h] > 0.f ? s : 0.f;
  }
  __syncthreads();
  // the tile's partial ∂w2 (h1ᵀ·∂pre2), ∂b2 and ∂b1 over its pairs in order
  const int PW = H * H + 2 * H;
  for (int e = tid; e < PW; e += nt) {
    float s = 0.f;
    if (e < H * H) {
      const int k = e / H, h = e - k * H;
      for (int p = 0; p < RD; ++p) s = fmaf(A.h1[(g0 + p) * H + k], A.dp2[(g0 + p) * H + h], s);
    } else if (e < H * H + H) {
      const int h = e - H * H;
      for (int p = 0; p < RD; ++p) s += A.dp2[(g0 + p) * H + h];
    } else {
      const int h = e - H * H - H;
      for (int p = 0; p < RD; ++p) s += A.sfx[(g0 + p) * H + h];
    }
    A.part[(long long)t * PW + e] = s;
  }
  __syncthreads();
  // ∂pre1 → its suffix sums over the targets: sfx[b, c] = Σ_{j>c} ∂pre1[b, j]
  for (int e = tid; e < nv * H; e += nt) {
    const int r = e / H, h = e - r * H;
    float run = 0.f;
    for (int j = d - 1; j >= 0; --j) {
      float* q = A.sfx + (g0 + (long long)r * d + j) * H + h;
      const float here = *q;
      *q = run;
      run += here;
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int p = 0; p < RD; ++p) s += terms[p];
    A.lpart[t] = s;
  }
  __syncthreads();
}

// Phase 2 on parameter p: its gradient summed in a fixed order, then Adam.
__device__ void synth_adam(const SynthDesc& S, const SynthStepArgs& A, int p) {
  const int d = S.d, H = S.H, K = S.kmax, PW = H * H + 2 * H;
  float g = 0.f;
  if (p < S.b1) {
    const int i = p / H, h = p - i * H;
    int c = d - 1;
    while (A.off[c] > i) --c;
    const int val = i - A.off[c];
    if (c < d - 1)
      for (int b = 0; b < A.B; ++b)
        if (A.codes[A.idx[b] * d + c] == val) g += A.sfx[((long long)b * d + c) * H + h];
  } else if (p < S.w2) {
    for (int t = 0; t < A.tiles; ++t) g += A.part[(long long)t * PW + H * H + H + (p - S.b1)];
  } else if (p < S.b2) {
    for (int t = 0; t < A.tiles; ++t) g += A.part[(long long)t * PW + (p - S.w2)];
  } else if (p < S.wh) {
    for (int t = 0; t < A.tiles; ++t) g += A.part[(long long)t * PW + H * H + (p - S.b2)];
  } else if (p < S.bh) {
    const int q = p - S.wh, j = q / (H * K), rem = q - j * H * K, h = rem / K, k = rem - h * K;
    if (k < A.card[j])
      for (int b = 0; b < A.B; ++b) {
        const long long pr = (long long)b * d + j;
        g = fmaf(A.h2[pr * H + h], A.dl[pr * K + k], g);
      }
  } else {
    const int q = p - S.bh, j = q / K, k = q - j * K;
    if (k < A.card[j])
      for (int b = 0; b < A.B; ++b) g += A.dl[((long long)b * d + j) * K + k];
  }
  const float th = A.theta[p];
  const float mu = __fadd_rn(__fmul_rn(A.omb1, g), __fmul_rn(A.b1, A.m[p]));
  const float nu = __fadd_rn(__fmul_rn(A.omb2, __fmul_rn(g, g)), __fmul_rn(A.b2, A.v[p]));
  const float u = __fdiv_rn(__fdiv_rn(mu, A.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, A.bc2)), A.eps));
  A.m[p] = mu;
  A.v[p] = nu;
  A.theta[p] = __fadd_rn(th, __fmul_rn(-A.lr, u));
}

__global__ void __launch_bounds__(SS_THREADS) synth_step_kernel(SynthDesc S, SynthStepArgs A) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float terms[];  // R·d loss terms of a tile
  for (int t = blockIdx.x; t < A.tiles; t += gridDim.x) synth_tile(S, A, t, terms);
  grid.sync();
  for (int c = blockIdx.x; c < A.chunks; c += gridDim.x) {
    const int p = c * blockDim.x + threadIdx.x;
    if (p < S.P) synth_adam(S, A, p);
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float s = 0.f;
  for (int t = 0; t < A.tiles; ++t) s += A.lpart[t];
  *A.loss = s * A.invN;
}

// Row 29: one Adam step on the batch rows idx[0..B) of codes.  Scratch:
// h1, h2, dp2, sfx (B·d·H floats each), dl (B·d·kmax), part
// (tiles·(H·H + 2H)), lpart (tiles), tiles = ceil(B / R).
extern "C" int synth_adam_step(int d, int D, int H, int kmax, void* theta, void* m, void* v,
                               const void* codes, const void* idx, const void* off,
                               const void* card, int B, float lr, float b1, float omb1, float b2,
                               float omb2, float eps, float bc1, float bc2, void* h1, void* h2,
                               void* dl, void* dp2, void* sfx, void* part, void* lpart,
                               void* loss, int R, int threads, void* stream) {
  if (d < 1 || D < d || H < 1 || kmax < 1 || B < 1 || R < 1 || threads != SS_THREADS)
    return (int)cudaErrorInvalidValue;
  const SynthDesc S = make_sdesc(d, D, H, kmax);
  SynthStepArgs A = {};
  A.theta = (float*)theta;
  A.m = (float*)m;
  A.v = (float*)v;
  A.codes = (const int*)codes;
  A.idx = (const long long*)idx;
  A.off = (const int*)off;
  A.card = (const int*)card;
  A.B = B;
  A.R = R;
  A.tiles = (B + R - 1) / R;
  A.chunks = (S.P + threads - 1) / threads;
  A.lr = lr;
  A.b1 = b1;
  A.omb1 = omb1;
  A.b2 = b2;
  A.omb2 = omb2;
  A.eps = eps;
  A.bc1 = bc1;
  A.bc2 = bc2;
  A.invN = 1.f / (float)((long long)B * d);
  A.h1 = (float*)h1;
  A.h2 = (float*)h2;
  A.dl = (float*)dl;
  A.dp2 = (float*)dp2;
  A.sfx = (float*)sfx;
  A.part = (float*)part;
  A.lpart = (float*)lpart;
  A.loss = (float*)loss;
  const size_t smem = sizeof(float) * (size_t)R * d;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0, resident = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  // The resident blocks of (device, shared memory), asked once.
  static struct { int dev; size_t smem; int blocks; } seen[16];
  static int n_seen = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].smem == smem) resident = seen[i].blocks;
  if (resident == 0) {
    int nsm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, synth_step_kernel, threads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * nsm;
    if (n_seen < 16) seen[n_seen++] = {dev, smem, resident};
  }
  const int want = A.tiles > A.chunks ? A.tiles : A.chunks;
  const int grid = want < resident ? want : resident;
  SynthDesc Sk = S;
  void* args[] = {(void*)&Sk, (void*)&A};
  err = cudaLaunchCooperativeKernel((const void*)synth_step_kernel, dim3(grid), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

struct SynthDrawArgs {
  const float* theta;
  const int *off, *card;
  const unsigned* keys;  // (d, 2): the subkey of each column
  int* out;              // (n, d) class codes
  float* uout;           // (n, kmax): column ucol's uniforms, for the checks; or null
  int n, R, ucol;
};

__global__ void __launch_bounds__(SD_THREADS) synth_draw_kernel(SynthDesc S, SynthDrawArgs A) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = A.R, H = S.H, K = S.kmax, d = S.d;
  float* acc = sm;           // R x H: Σ of the drawn columns' w1 rows
  float* h1 = acc + R * H;   // R x H
  float* h2 = h1 + R * H;    // R x H
  float* pert = h2 + R * H;  // R x kmax: logits + gumbel
  int* pick = (int*)(pert + R * K);
  const int base = blockIdx.x * R;
  const int nv = min(R, A.n - base);
  const float* th = A.theta;
  const float tiny = FLT_MIN, span = 1.0f - FLT_MIN;
  for (int e = tid; e < nv * H; e += nt) acc[e] = 0.f;
  __syncthreads();
  for (int j = 0; j < d; ++j) {
    const int kc = A.card[j];
    const unsigned k0 = A.keys[2 * j], k1 = A.keys[2 * j + 1];
    for (int e = tid; e < nv * H; e += nt) h1[e] = fmaxf(acc[e] + th[S.b1 + e % H], 0.f);
    __syncthreads();
    for (int e = tid; e < nv * H; e += nt) {
      const int r = e / H, h = e - r * H;
      float s = 0.f;
      for (int k = 0; k < H; ++k) s = fmaf(h1[r * H + k], th[S.w2 + k * H + h], s);
      h2[e] = fmaxf(s + th[S.b2 + h], 0.f);
    }
    __syncthreads();
    for (int e = tid; e < nv * K; e += nt) {
      const int r = e / K, k = e - r * K;
      if (k >= kc) continue;
      const float* w = th + S.wh + (long long)j * H * K + k;
      float s = 0.f;
      for (int h = 0; h < H; ++h) s = fmaf(h2[r * H + h], w[h * K], s);
      const float logit = s + th[S.bh + j * K + k];
      const uint32_t bits = random_bits32(k0, k1, (uint64_t)(base + r) * K + k);
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      const float u = fmaxf(tiny, fmaf(f, span, tiny));
      if (A.uout && j == A.ucol) A.uout[(long long)(base + r) * K + k] = u;
      pert[e] = -logf(-logf(u)) + logit;
    }
    __syncthreads();
    for (int r = tid; r < nv; r += nt) {
      const float* q = pert + r * K;
      float best = q[0];
      int bi = 0;
      for (int k = 1; k < kc; ++k)
        if (q[k] > best) {
          best = q[k];
          bi = k;
        }
      pick[r] = bi;
      A.out[(long long)(base + r) * d + j] = bi;
    }
    __syncthreads();
    for (int e = tid; e < nv * H; e += nt) {
      const int r = e / H, h = e - r * H;
      acc[e] += th[S.w1 + (A.off[j] + pick[r]) * H + h];
    }
    __syncthreads();
  }
}

// Row 30: n rows of d columns drawn from θ with the column subkeys `keys`
// ((d, 2) uint32), into out ((n, d) int32).  With uout non-null, column
// ucol's uniform draws of the real classes are written there too ((n, kmax)
// floats; the checks hold them against utils/prng.py:uniform).
extern "C" int synth_draw(int d, int D, int H, int kmax, const void* theta, const void* off,
                          const void* card, const void* keys, void* out, void* uout, int ucol,
                          int n, int R, int threads, void* stream) {
  if (d < 1 || D < d || H < 1 || kmax < 1 || n < 1 || R < 1 || threads != SD_THREADS)
    return (int)cudaErrorInvalidValue;
  const SynthDesc S = make_sdesc(d, D, H, kmax);
  SynthDrawArgs A;
  A.theta = (const float*)theta;
  A.off = (const int*)off;
  A.card = (const int*)card;
  A.keys = (const unsigned*)keys;
  A.out = (int*)out;
  A.uout = (float*)uout;
  A.ucol = ucol;
  A.n = n;
  A.R = R;
  const size_t smem = sizeof(float) * ((size_t)R * (3 * H + kmax) + R);
  cudaError_t err = set_smem(synth_draw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  synth_draw_kernel<<<(n + R - 1) / R, threads, smem, (cudaStream_t)stream>>>(S, A);
  return (int)cudaGetLastError();
}
