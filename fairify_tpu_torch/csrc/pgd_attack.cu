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
// index (b * R + t) * d + i of the (B, R, d) draw.
//
// The gradient is hand-derived with JAX's tie rules: relu'(0) = 0 (the
// masked net's activations are stored and a unit passes gradient only
// where its output is positive), min(u, v) passes half to each side on a
// tie, and a max/min over the assignments splits its share equally among
// the tied entries; sign(0) = 0 leaves a coordinate where it is.
//
// Bound on the H100: fp32 FMA throughput — per step, 2V forward and 2V
// backward passes of the net per trajectory (about 4 * macs flops each
// way), so 2 * 2V * R * B * steps * 4 * macs in all (~2.4 TFLOP at AC-S1,
// B = 2048, R = 96, V = 2, 60 steps); the inputs and outputs are small.
//
// Design: persistent blocks (one per SM) walk tiles of TT trajectories
// (TT * 2V rows: the x rows then the x' rows of each trajectory).  The
// packed net, every hidden layer's activations of the tile (kept for the
// backward pass), the two gradient buffers and the trajectory state live
// in dynamic shared memory; each layer forward is common.cuh's
// register-blocked dense_tile and each layer backward its transpose.
#include "common.cuh"

#define K5_THREADS 256
#define K5_ROWS 64  // target rows (trajectories x 2V) per tile

__device__ __forceinline__ float sgnf(float g) { return g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f); }

// jax.random.uniform's float from 32 random bits: the 23 high bits as the
// mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// out[r][i] = sum_j g[r * ldg + j] * W[i * nout + j] for i < nin: the
// transposed layer product of the backward pass, register-blocked like
// dense_tile with the row groups varying fastest across threads (so a
// warp's weight reads are broadcasts).  Rows past T are clamped; epi(s0,
// nrows, i, v) receives the sums of column i for rows s0 .. s0 + nrows - 1.
template <typename Epi>
__device__ __forceinline__ void dense_tile_t(const float* __restrict__ g, int ldg,
                                             const float* __restrict__ W, int nin,
                                             int nout, int T, Epi epi) {
  const int CG = (nin + RT_COLS - 1) / RT_COLS;
  const int RG = (T + RT_ROWS - 1) / RT_ROWS;
  for (int item = threadIdx.x; item < RG * CG; item += blockDim.x) {
    const int rg = item % RG, cg = item / RG, s0 = rg * RT_ROWS;
    int ic[RT_COLS], rr[RT_ROWS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c) ic[c] = min(cg + c * CG, nin - 1);
#pragma unroll
    for (int r = 0; r < RT_ROWS; ++r) rr[r] = min(s0 + r, T - 1);
    float acc[RT_COLS][RT_ROWS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) acc[c][r] = 0.f;
    for (int j = 0; j < nout; ++j) {
      float gv[RT_ROWS], wv[RT_COLS];
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) gv[r] = g[rr[r] * ldg + j];
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c) wv[c] = W[ic[c] * nout + j];
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
        for (int r = 0; r < RT_ROWS; ++r) acc[c][r] = fmaf(gv[r], wv[c], acc[c][r]);
    }
    const int nrows = min(RT_ROWS, T - s0);
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
      if (cg + c * CG < nin) epi(s0, nrows, cg + c * CG, acc[c]);
  }
}

struct PgdArgs {
  const float* params;
  const float *lo, *hi, *assign, *pam, *ram;
  const uint8_t* valid;
  float eps;
  uint32_t ks0, ks1, kr0, kr1;  // the split keys of the launch key (s, r)
  const float* sched;           // decay[steps], r_step[steps]
  int steps, B, R, V, TT;
  float *fx, *fp, *x, *xp;
};

__global__ void __launch_bounds__(K5_THREADS) k5_kernel(NetDesc nd, PgdArgs A) {
  extern __shared__ float smem[];
  const int d = nd.in[0], L = nd.L, V = A.V, TT = A.TT, tid = threadIdx.x, nt = blockDim.x;
  const int rows = TT * 2 * V, rp = (rows + RT_ROWS - 1) / RT_ROWS * RT_ROWS;
  const int dX = d | 1, ldg = nd.ld;
  float* P = smem;
  float* S = P + nd.total;  // trajectory state and box, TT x d each
  float* Rv = S + TT * d;
  float* LO = Rv + TT * d;
  float* HI = LO + TT * d;
  float* X = HI + TT * d;  // rp x dX
  float* ACT = X + rp * dX;
  int aoff[MAX_LAYERS], ast[MAX_LAYERS];
  int acc_off = 0;
  for (int l = 0; l + 1 < L; ++l) {
    ast[l] = nd.out[l] | 1;
    aoff[l] = acc_off;
    acc_off += rp * ast[l];
  }
  float* G0 = ACT + acc_off;  // rp x ldg each
  float* G1 = G0 + rp * ldg;
  float* LG = G1 + rp * ldg;  // rows: logits
  float* CF = LG + rp;        // rows: logit adjoints
  for (int i = tid; i < nd.total; i += nt) P[i] = A.params[i];
  __syncthreads();

  const long long n_traj = (long long)A.B * A.R;
  for (long long t0 = (long long)blockIdx.x * TT; t0 < n_traj; t0 += (long long)gridDim.x * TT) {
    const int ntile = (int)min((long long)TT, n_traj - t0);
    for (int q = tid; q < TT * d; q += nt) {  // threefry starts
      const int t = q / d, i = q % d;
      const long long tau = t0 + min(t, ntile - 1);
      const int b = (int)(tau / A.R);
      const float lo = A.lo[(size_t)b * d + i], hi = A.hi[(size_t)b * d + i];
      const uint64_t n = (uint64_t)tau * d + i;
      const float us = bits_to_unit(random_bits32(A.ks0, A.ks1, n));
      const float ur = fmaxf(-1.f, fmaf(bits_to_unit(random_bits32(A.kr0, A.kr1, n)), 2.f, -1.f));
      LO[q] = lo;
      HI[q] = hi;
      S[q] = fmaf(us, __fsub_rn(hi, lo), lo);
      Rv[q] = __fmul_rn(ur, A.eps);
    }
    __syncthreads();
    for (int step = 0; step <= A.steps; ++step) {
      const bool last = step == A.steps;
      if (last) {  // round to the lattice for the final forward
        for (int q = tid; q < TT * d; q += nt) {
          const int i = q % d;
          S[q] = fminf(fmaxf(rintf(S[q]), LO[q]), HI[q]);
          Rv[q] = __fmul_rn(rintf(Rv[q]), A.ram[i]);
        }
        __syncthreads();
      }
      for (int q = tid; q < rows * d; q += nt) {  // the tile's input rows
        const int row = q / d, i = q % d, t = row / (2 * V), k = row % (2 * V);
        const int a = k < V ? k : k - V;
        float xv = __fadd_rn(__fmul_rn(S[t * d + i], 1.f - A.pam[i]), A.assign[(size_t)a * d + i]);
        if (k >= V) xv = __fadd_rn(xv, __fmul_rn(Rv[t * d + i], A.ram[i]));
        X[row * dX + i] = xv;
      }
      __syncthreads();
      for (int l = 0; l < L; ++l) {  // forward, keeping every hidden layer
        const float* B = P + nd.b[l];
        const float* M = P + nd.m[l];
        const bool hidden = l + 1 < L;
        const float* cur = l == 0 ? X : ACT + aoff[l - 1];
        const int ldc = l == 0 ? dX : ast[l - 1];
        float* nxt = hidden ? ACT + aoff[l] : nullptr;
        const int ldn = hidden ? ast[l] : 0;
        dense_tile(cur, ldc, P + nd.w[l], nd.in[l], nd.out[l], rows,
                   [&](int s0, int nrows, int j, const float* v) {
#pragma unroll
                     for (int r = 0; r < RT_ROWS; ++r) {
                       if (r >= nrows) break;
                       const float z = v[r] + B[j];
                       if (hidden)
                         nxt[(s0 + r) * ldn + j] = fmaxf(z, 0.f) * M[j];
                       else if (j == 0)
                         LG[s0 + r] = z;
                     }
                   });
        __syncthreads();
      }
      if (last) {
        for (int q = tid; q < ntile * 2 * V; q += nt) {
          const int t = q / (2 * V), k = q % (2 * V);
          const long long tau = t0 + t;
          const int a = k < V ? k : k - V;
          const size_t o = (size_t)tau * V + a;
          (k < V ? A.fx : A.fp)[o] = LG[q];
        }
        for (int q = tid; q < ntile * 2 * V * d; q += nt) {
          const int row = q / d, i = q % d, t = row / (2 * V), k = row % (2 * V);
          const long long tau = t0 + t;
          const int a = k < V ? k : k - V;
          (k < V ? A.x : A.xp)[((size_t)tau * V + a) * d + i] = X[row * dX + i];
        }
        __syncthreads();
        break;
      }
      for (int t = tid; t < TT; t += nt) {  // objective adjoints per row
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
        for (int a = 0; a < V; ++a) {
          CF[t * 2 * V + a] = vb[a] && lx[a] == fxm ? gx / (float)cx : 0.f;
          CF[t * 2 * V + V + a] = vb[a] && lp[a] == fpm ? -gp / (float)cp : 0.f;
        }
      }
      __syncthreads();
      // Backward to the input: G_{l-1} = (G_l W_l^T) * relu'(z_{l-1}) * m.
      const float* gcur = CF;
      int ldcur = 1;
      float* bufs[2] = {G0, G1};
      int which = 0;
      for (int l = L - 1; l >= 0; --l) {
        float* gout = bufs[which];
        const bool to_hidden = l > 0;
        const float* act = to_hidden ? ACT + aoff[l - 1] : nullptr;
        const int lda = to_hidden ? ast[l - 1] : 0;
        const float* Mp = to_hidden ? P + nd.m[l - 1] : nullptr;
        dense_tile_t(gcur, ldcur, P + nd.w[l], nd.in[l], nd.out[l], rows,
                     [&](int s0, int nrows, int i, const float* v) {
#pragma unroll
                       for (int r = 0; r < RT_ROWS; ++r) {
                         if (r >= nrows) break;
                         const int row = s0 + r;
                         float gval = v[r];
                         if (to_hidden) gval = act[row * lda + i] > 0.f ? gval * Mp[i] : 0.f;
                         gout[row * ldg + i] = gval;
                       }
                     });
        __syncthreads();
        gcur = gout;
        ldcur = ldg;
        which ^= 1;
      }
      const float dec = A.sched[step], rstep = A.sched[A.steps + step];
      for (int q = tid; q < TT * d; q += nt) {  // signed step, clipped
        const int t = q / d, i = q % d;
        float gs = 0.f, gr = 0.f;
        for (int a = 0; a < V; ++a) {
          const float gxv = gcur[(t * 2 * V + a) * ldg + i];
          const float gpv = gcur[(t * 2 * V + V + a) * ldg + i];
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
      __syncthreads();
    }
  }
}

extern "C" int k5_pgd_attack(const void* params, const int* dims, int L, const void* lo,
                             const void* hi, const void* assign, const void* pam,
                             const void* ram, const void* valid, float eps, unsigned ks0,
                             unsigned ks1, unsigned kr0, unsigned kr1, const void* sched,
                             int steps, int B, int R, int V, void* fx, void* fp, void* x,
                             void* xp, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const int d = nd.in[0];
  int TT = K5_ROWS / (2 * V);
  if (TT < 1) TT = 1;
  const int rows = TT * 2 * V, rp = (rows + RT_ROWS - 1) / RT_ROWS * RT_ROWS;
  int act = 0;
  for (int l = 0; l + 1 < L; ++l) act += rp * (nd.out[l] | 1);
  const size_t smem = sizeof(float) * ((size_t)nd.total + 4 * TT * d + rp * (d | 1) + act +
                                       2 * rp * nd.ld + 2 * rp);
  cudaError_t err = set_smem(k5_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = ((long long)B * R + TT - 1) / TT;
  const int grid = (int)(tiles < nsm ? tiles : nsm);
  PgdArgs A;
  A.params = (const float*)params;
  A.lo = (const float*)lo;
  A.hi = (const float*)hi;
  A.assign = (const float*)assign;
  A.pam = (const float*)pam;
  A.ram = (const float*)ram;
  A.valid = (const uint8_t*)valid;
  A.eps = eps;
  A.ks0 = ks0;
  A.ks1 = ks1;
  A.kr0 = kr0;
  A.kr1 = kr1;
  A.sched = (const float*)sched;
  A.steps = steps;
  A.B = B;
  A.R = R;
  A.V = V;
  A.TT = TT;
  A.fx = (float*)fx;
  A.fp = (float*)fp;
  A.x = (float*)x;
  A.xp = (float*)xp;
  if (grid > 0)
    k5_kernel<<<grid, K5_THREADS, smem, (cudaStream_t)stream>>>(nd, A);
  return (int)cudaGetLastError();
}
