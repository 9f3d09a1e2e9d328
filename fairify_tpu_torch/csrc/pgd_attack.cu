// K5 — the PGD attack on the pair property, all steps in one launch.
//
// Replaces fairify_tpu/verify/engine.py:_pgd_attack_kernel.  For each box b
// and restart t (a trajectory), signed-gradient ascent on
//   min(max_a f(x(s, a)), -min_b f(x'(s, b, r))),
//   x = s * (1 - pa) + assign_a,  x' = x + r * ra,
// over the shared coordinates s (clipped to the box) and the RA shift r
// (clipped to [-eps, eps]), then rounding to the lattice and a final
// forward.  Starts: s0 = lo + U[0,1) * (hi - lo) (one fused multiply-add,
// as XLA computes it) and r0 = U[-1,1) * eps, from the threefry device
// function, bit-equal to jax.random.uniform (partitionable path) at flat
// index (b * R + t) * d + i of the (B, R, d) draw, under the two keys that
// jax.random.split gives the launch key (split on the card, so the wrapper
// never waits for it).
//
// The gradient is hand-derived with JAX's tie rules: relu'(0) = 0 (a unit
// passes gradient only where its masked output is positive), min(u, v)
// passes half to each side on a tie, and a max/min over the assignments
// splits its share equally among the tied entries; sign(0) = 0 leaves a
// coordinate where it is.
//
// Bound on the H100: fp32 FMA throughput — per step, 2V forward and 2V
// backward passes of the net per trajectory (about 4 * macs flops each
// way), so 2 * 2V * R * B * steps * 4 * macs in all (~2.4 TFLOP at AC-S1,
// B = 2048, R = 96, V = 2, 60 steps); the inputs and outputs are small.
// At B = 1 (the heuristic retry: 96 trajectories) the launch is bound by
// the latency of one trajectory's 60 dependent steps.
//
// Design (warp_tile.cuh): a trajectory's rows (its x rows, then its x'
// rows) depend on no other trajectory, so each warp carries TTW
// trajectories (TW >= TTW * 2V rows) through every step with __syncwarp
// only.  The block stages the padded net (W for the forward, W^T for the
// backward) with one bulk copy.  Forward and backward ping-pong two
// activation buffers; the backward's ReLU' is the forward's sign bits,
// which each lane keeps for its own (row, unit) entries (the backward tile
// of a layer's inputs is the forward tile of the layer below, so the lane
// holds the same entries).  The wrapper sizes the launch to the work
// (engine.pgd_geometry): one trajectory a warp and one warp a block when
// there are few (B = 1: 96 blocks), full tiles on every SM when there are
// many.
#include "common.cuh"
#include "warp_tile.cuh"

#define K5_MAX_WARPS 8

__device__ __forceinline__ float sgnf(float g) { return g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f); }

// jax.random.uniform's float from 32 random bits: the 23 high bits as the
// mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Unit capacities of the two activation buffers: hidden layer l's output
// goes to buffer l % 2, the backward pass of layer l writes its in_l input
// gradients to buffer (L - 1 - l) % 2.
__host__ __device__ inline void k5_buffers(const PadDesc& pd, int& h0, int& h1) {
  h0 = h1 = 0;
  for (int l = 0; l < pd.L; ++l) {
    if (l + 1 < pd.L) {
      int& h = (l & 1) ? h1 : h0;
      if (pd.out[l] > h) h = pd.out[l];
    }
    int& g = ((pd.L - 1 - l) & 1) ? h1 : h0;
    if (pd.in[l] > g) g = pd.in[l];
  }
}

// Sign-bit words of hidden layer l's forward tile: 2 per lane and pass.
__host__ __device__ inline int k5_bit_words(const PadDesc& pd, int tw) {
  int n = 0;
  for (int l = 0; l + 1 < pd.L; ++l) n += 64 * tile_passes(pd.out[l], tw);
  return n;
}

// Floats of one warp's share: the input tile X, the two activation
// buffers, the logit adjoints and logits (TW each), the sign bits, the
// trajectory state s, r, lo, hi (TTW x d each); rounded up to 16 bytes.
__host__ __device__ inline long long k5_warp_floats(const PadDesc& pd, int ttw, int tw) {
  int h0, h1;
  k5_buffers(pd, h0, h1);
  const long long f = (long long)(pd.in[0] + h0 + h1 + 2) * tw + k5_bit_words(pd, tw) +
                      4LL * ttw * pd.in[0];
  return (f + 3) / 4 * 4;
}

// engine.pgd_smem is the same sum.
static inline long long k5_smem(const PadDesc& pd, int ttw, int tw, int warps) {
  return 4LL * (4 + pd.total + warps * k5_warp_floats(pd, ttw, tw));
}

struct PgdArgs {
  const float* params;
  const float *lo, *hi, *assign, *pam, *ram;
  const uint8_t* valid;
  float eps;
  const int32_t* key;           // the launch key's two words, on the card
  const float* sched;           // decay[steps], r_step[steps]
  int steps, B, R, V, TTW, TW;
  float *fx, *fp, *x, *xp;
};

__global__ void __launch_bounds__(K5_MAX_WARPS * 32, 1) k5_kernel(PadDesc pd, PgdArgs A) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int d = pd.in[0], L = pd.L, V = A.V, TTW = A.TTW, tw = A.TW, smask = swz_mask(tw);
  int h0, h1;
  k5_buffers(pd, h0, h1);
  float* X = P + pd.total + warp * k5_warp_floats(pd, TTW, tw);  // d units x TW
  float* H[2] = {X + d * tw, X + (d + h0) * tw};
  float* CF = H[1] + h1 * tw;  // logit adjoints: unit 0 of a tile
  float* LG = CF + tw;         // logits per row
  uint32_t* BITS = reinterpret_cast<uint32_t*>(LG + tw);
  float* S = reinterpret_cast<float*>(BITS + k5_bit_words(pd, tw));  // TTW x d each
  float* Rv = S + TTW * d;
  float* LO = Rv + TTW * d;
  float* HI = LO + TTW * d;
  int bit_off[MAX_LAYERS];
  for (int l = 0, n = 0; l + 1 < L; ++l) {
    bit_off[l] = n;
    n += 64 * tile_passes(pd.out[l], tw);
  }
  // Forward layer l's tile; the backward pass of layer l (its in_l input
  // gradients) takes the tile of forward layer l - 1 (in_l = out_{l-1}), so
  // a lane holds the same (row, unit) entries as that layer's sign bits.
  const uint32_t tiles_f = pick_tiles(L, tw, [&](int l) { return pd.out[l]; });
  const uint32_t tiles_b = pick_tiles(L, tw, [&](int l) { return pd.in[l]; });
  stage_net(P, A.params, pd.total, bar);
  // jax.random.split(key): the keys of the s and r draws (prng.split).
  const SplitKey sk = split_key((uint32_t)A.key[0], (uint32_t)A.key[1]);
  mbar_wait(bar, 0);

  const long long n_traj = (long long)A.B * A.R;
  const long long tiles = (n_traj + TTW - 1) / TTW;
  const int rows = TTW * 2 * V;
  for (long long tile = (long long)blockIdx.x * nw + warp; tile < tiles;
       tile += (long long)gridDim.x * nw) {
    const long long t0 = tile * TTW;
    const int ntile = (int)min((long long)TTW, n_traj - t0);
    for (int q = lane; q < TTW * d; q += 32) {  // threefry starts
      const int t = q / d, i = q % d;
      const long long tau = t0 + min(t, ntile - 1);
      const int b = (int)(tau / A.R);
      const float lo = A.lo[(size_t)b * d + i], hi = A.hi[(size_t)b * d + i];
      const uint64_t n = (uint64_t)tau * d + i;
      const float us = bits_to_unit(random_bits32(sk.hi0, sk.hi1, n));
      const float ur = fmaxf(-1.f, fmaf(bits_to_unit(random_bits32(sk.lo0, sk.lo1, n)), 2.f, -1.f));
      LO[q] = lo;
      HI[q] = hi;
      S[q] = fmaf(us, __fsub_rn(hi, lo), lo);
      Rv[q] = __fmul_rn(ur, A.eps);
    }
    __syncwarp();
    for (int step = 0; step <= A.steps; ++step) {
      const bool last = step == A.steps;
      if (last) {  // round to the lattice for the final forward
        for (int q = lane; q < TTW * d; q += 32) {
          const int i = q % d;
          S[q] = fminf(fmaxf(rintf(S[q]), LO[q]), HI[q]);
          Rv[q] = __fmul_rn(rintf(Rv[q]), A.ram[i]);
        }
        __syncwarp();
      }
      for (int q = lane; q < rows * d; q += 32) {  // the tile's input rows
        const int row = q / d, i = q % d, t = row / (2 * V), k = row % (2 * V);
        const int a = k < V ? k : k - V;
        float xv = __fadd_rn(__fmul_rn(S[t * d + i], 1.f - A.pam[i]), A.assign[(size_t)a * d + i]);
        if (k >= V) xv = __fadd_rn(xv, __fmul_rn(Rv[t * d + i], A.ram[i]));
        X[act_off(i, row, tw, smask)] = xv;
        if (last && t < ntile)
          (k < V ? A.x : A.xp)[((size_t)(t0 + t) * V + a) * d + i] = xv;
      }
      __syncwarp();
      const float* cur = X;
      for (int l = 0; l < L; ++l) {  // forward, recording ReLU' bits
        const bool hidden = l + 1 < L;
        Epi e;
        e.mode = hidden ? EPI_HIDDEN : EPI_LOGIT;
        e.bias = P + pd.b[l];
        e.mask = P + pd.m[l];
        e.out = H[l & 1];
        e.logit = LG;
        e.nvalid = tw;
        e.bits = hidden ? BITS + bit_off[l] : nullptr;
        e.tw = tw;
        e.smask = smask;
        warp_layer((tiles_f >> (3 * l)) & 7, cur, tw, smask, P + pd.w[l], pd.ldw[l], pd.in[l],
                   pd.out[l], lane, e);
        __syncwarp();
        cur = H[l & 1];
      }
      if (last) {
        for (int q = lane; q < ntile * 2 * V; q += 32) {
          const int t = q / (2 * V), k = q % (2 * V);
          const int a = k < V ? k : k - V;
          (k < V ? A.fx : A.fp)[(size_t)(t0 + t) * V + a] = LG[q];
        }
        __syncwarp();
        break;
      }
      for (int t = lane; t < TTW; t += 32) {  // objective adjoints per row
        const long long tau = t0 + min(t, ntile - 1);
        const uint8_t* vb = A.valid + (size_t)(tau / A.R) * V;
        const float* lx = LG + t * 2 * V;
        const float* lp = lx + V;
        float fxm = -INFINITY, fpm = INFINITY;
        for (int a = 0; a < V; ++a)
          if (vb[a]) {
            fxm = fmaxf(fxm, lx[a]);
            fpm = fminf(fpm, lp[a]);
          }
        const float nfp = -fpm;
        const float gx = fxm < nfp ? 1.f : (fxm == nfp ? 0.5f : 0.f);
        const float gp = nfp < fxm ? 1.f : (fxm == nfp ? 0.5f : 0.f);
        int cx = 0, cp = 0;
        for (int a = 0; a < V; ++a)
          if (vb[a]) {
            cx += lx[a] == fxm;
            cp += lp[a] == fpm;
          }
        for (int a = 0; a < V; ++a) {  // unit 0 of the tile: CF[row]
          CF[t * 2 * V + a] = vb[a] && lx[a] == fxm ? gx / (float)cx : 0.f;
          CF[t * 2 * V + V + a] = vb[a] && lp[a] == fpm ? -gp / (float)cp : 0.f;
        }
      }
      __syncwarp();
      // Backward to the input: G_{l-1} = (G_l W_l^T) * relu'(z_{l-1}) * m.
      const float* gcur = CF;
      for (int l = L - 1; l >= 0; --l) {
        Epi e;
        e.mode = EPI_BACKWARD;
        e.bias = nullptr;
        e.mask = l > 0 ? P + pd.m[l - 1] : nullptr;
        e.out = H[(L - 1 - l) & 1];
        e.logit = nullptr;
        e.nvalid = 0;
        e.bits = l > 0 ? BITS + bit_off[l - 1] : nullptr;
        e.tw = tw;
        e.smask = smask;
        warp_layer((tiles_b >> (3 * l)) & 7, gcur, tw, smask, P + pd.wt[l], pd.ldt[l],
                   pd.out[l], pd.in[l], lane, e);
        __syncwarp();
        gcur = e.out;
      }
      const float dec = A.sched[step], rstep = A.sched[A.steps + step];
      for (int q = lane; q < TTW * d; q += 32) {  // signed step, clipped
        const int t = q / d, i = q % d;
        float gs = 0.f, gr = 0.f;
        for (int a = 0; a < V; ++a) {
          const float gxv = gcur[act_off(i, t * 2 * V + a, tw, smask)];
          const float gpv = gcur[act_off(i, t * 2 * V + V + a, tw, smask)];
          gs += gxv + gpv;
          gr += gpv;
        }
        gs *= 1.f - A.pam[i];
        gr *= A.ram[i];
        const float width = __fsub_rn(HI[q], LO[q]);
        const float alpha = __fmul_rn(fmaxf(__fmul_rn(0.35f, width), 0.5f), dec);
        S[q] = fminf(fmaxf(__fadd_rn(S[q], __fmul_rn(alpha, sgnf(gs))), LO[q]), HI[q]);
        Rv[q] = fminf(fmaxf(__fadd_rn(Rv[q], __fmul_rn(rstep, sgnf(gr))), -A.eps), A.eps);
      }
      __syncwarp();
    }
  }
}

// The launch geometry comes from the wrapper (engine.pgd_geometry:
// trajectories per warp tile `ttw`, rows per tile `tw`, warps per block,
// blocks, shared-memory bytes); it is checked here against the net, V and
// the kernel's limits.
extern "C" int k5_pgd_attack(const void* params, const int* dims, int L, const void* lo,
                             const void* hi, const void* assign, const void* pam,
                             const void* ram, const void* valid, float eps, const void* key,
                             const void* sched,
                             int steps, int B, int R, int V, void* fx, void* fp, void* x,
                             void* xp, int ttw, int tw, int warps, int grid, long long smem,
                             void* stream) {
  const PadDesc pd = make_pad_desc(dims, L);
  if (ttw < 1 || tw % 4 != 0 || tw < ttw * 2 * V || tw > 64 || warps < 1 ||
      warps > K5_MAX_WARPS || grid < 1 || smem != k5_smem(pd, ttw, tw, warps) ||
      smem > SMEM_LIMIT || pd.out[L - 1] != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(k5_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  PgdArgs A;
  A.params = (const float*)params;
  A.lo = (const float*)lo;
  A.hi = (const float*)hi;
  A.assign = (const float*)assign;
  A.pam = (const float*)pam;
  A.ram = (const float*)ram;
  A.valid = (const uint8_t*)valid;
  A.eps = eps;
  A.key = (const int32_t*)key;
  A.sched = (const float*)sched;
  A.steps = steps;
  A.B = B;
  A.R = R;
  A.V = V;
  A.TTW = ttw;
  A.TW = tw;
  A.fx = (float*)fx;
  A.fp = (float*)fp;
  A.x = (float*)x;
  A.xp = (float*)xp;
  if ((long long)B * R > 0)
    k5_kernel<<<grid, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(pd, A);
  return (int)cudaGetLastError();
}
