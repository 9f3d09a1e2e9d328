// The lattice kernels' forward (ops/lattice.py, K9a-c): a true-f32 pass
// over a tile of lattice points with the running rigorous round-off bound
//
//   z = h.W + b,   a = |h|.|W| + |b|,   e' = e.|W| + gamma_l * a,
//   gamma_l = 4 (n_in + 4) 2^-24
//
// (hidden layers: h' = relu(z) * m, e' = e' * m).  The three products run
// in one register-blocked pass over the weights, the same blocking as
// common.cuh's dense_tile, with |W| and |h| taken by fabsf on the fly.  The
// bound covers any summation order, so no TF32, no tensor cores and no
// --use_fast_math; the formula is the JAX package's _signed_forward, not
// restructured.
#pragma once

#include "common.cuh"

#define LAT_TMAX 64            // lattice points per tile (rows of a pass)
#define LAT_MAXD 64            // input dims (ops/lattice.py: LAT_MAXD)
#define LAT_MARGIN_BUF 512     // ops/lattice.py: MARGIN_BUF
#define LAT_RA_MAXK 16         // RA axes (ops/lattice.py: LAT_RA_MAXK)
#define LAT_RA_SMEM_MAX (160 * 1024)  // ops/lattice.py: LAT_RA_SMEM_MAX

// One chunk's decode: flat index g -> shared coordinate j is
// (g / stride[j]) % width[j] + lo[j]; input dim k reads coordinate col[k],
// or bases[v * d + k] when col[k] < 0 (PA and peeled prefix dims).
struct LatDesc {
  int start, n_total, chunk, d, n_shared, V;
  int stride[LAT_MAXD], width[LAT_MAXD], lo[LAT_MAXD], col[LAT_MAXD];
};

// The RA tile: k innermost axes of widths w (core width + 2 eps), in-tile
// mixed-radix strides st (ops/lattice.py: _ra_strides).
struct LatRA {
  int k, eps, tile;
  int w[LAT_RA_MAXK], st[LAT_RA_MAXK];
};

// One layer of the signed forward over T rows of (H, E) (row stride ld):
// epi(s0, nrows, j, z, a, ee) gets the pre-bias sums of column j for rows
// s0 .. s0 + nrows - 1.  WITH_E = false skips e.|W| (layer 0: e = 0).
template <bool WITH_E, typename Epi>
__device__ __forceinline__ void signed_dense(const float* __restrict__ H,
                                             const float* __restrict__ E, int ld,
                                             const float* __restrict__ W, int nin,
                                             int nout, int T, Epi epi) {
  const int CG = (nout + RT_COLS - 1) / RT_COLS;
  const int RG = (T + RT_ROWS - 1) / RT_ROWS;
  for (int item = threadIdx.x; item < RG * CG; item += blockDim.x) {
    const int cg = item % CG, s0 = (item / CG) * RT_ROWS;
    int jc[RT_COLS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c) jc[c] = min(cg + c * CG, nout - 1);
    float z[RT_COLS][RT_ROWS], a[RT_COLS][RT_ROWS], ee[RT_COLS][RT_ROWS];
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) z[c][r] = a[c][r] = ee[c][r] = 0.f;
    const float* x = H + s0 * ld;
    const float* ex = E + s0 * ld;
    for (int i = 0; i < nin; ++i) {
      float hv[RT_ROWS], ev[RT_ROWS], wv[RT_COLS], aw[RT_COLS];
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) {
        hv[r] = x[r * ld + i];
        ev[r] = WITH_E ? ex[r * ld + i] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c) {
        wv[c] = W[i * nout + jc[c]];
        aw[c] = fabsf(wv[c]);
      }
#pragma unroll
      for (int c = 0; c < RT_COLS; ++c)
#pragma unroll
        for (int r = 0; r < RT_ROWS; ++r) {
          z[c][r] = fmaf(hv[r], wv[c], z[c][r]);
          a[c][r] = fmaf(fabsf(hv[r]), aw[c], a[c][r]);
          if (WITH_E) ee[c][r] = fmaf(ev[r], aw[c], ee[c][r]);
        }
    }
    const int nrows = min(RT_ROWS, T - s0);
#pragma unroll
    for (int c = 0; c < RT_COLS; ++c)
      if (cg + c * CG < nout) epi(s0, nrows, cg + c * CG, z[c], a[c], ee[c]);
  }
}

// signed_forward for a tile of T input rows held in H0 (row stride nd.ld):
// the logit f and its bound e of each row go to fout[r], eout[r].  H0/E0
// and H1/E1 are ping-pong activation/bound tiles; H0 is overwritten.
// Callers __syncthreads() before (H0 filled) and read fout/eout after the
// final __syncthreads() inside.
__device__ __forceinline__ void signed_forward(const NetDesc& nd, const float* P,
                                               float* H0, float* E0, float* H1,
                                               float* E1, int T, float* fout,
                                               float* eout) {
  const float u32 = 5.9604644775390625e-8f;  // 2^-24
  const int ld = nd.ld;
  float *h = H0, *e = E0, *hn = H1, *en = E1;
  for (int l = 0; l < nd.L; ++l) {
    const float gamma = 4.f * (float)(nd.in[l] + 4) * u32;
    const bool hidden = l < nd.L - 1;
    const float* B = P + nd.b[l];
    const float* M = P + nd.m[l];
    auto epi = [&](int s0, int nrows, int j, const float* z, const float* a,
                   const float* ee) {
      const float bj = B[j], abj = fabsf(bj), mj = M[j];
#pragma unroll
      for (int r = 0; r < RT_ROWS; ++r) {
        if (r >= nrows) break;
        const float zz = z[r] + bj;
        const float aa = a[r] + abj;
        const float ev = ee[r] + gamma * aa;
        if (hidden) {
          hn[(s0 + r) * ld + j] = fmaxf(zz, 0.f) * mj;
          en[(s0 + r) * ld + j] = ev * mj;
        } else if (j == 0) {
          fout[s0 + r] = zz;
          eout[s0 + r] = ev;
        }
      }
    };
    if (l == 0)
      signed_dense<false>(h, e, ld, P + nd.w[l], nd.in[l], nd.out[l], T, epi);
    else
      signed_dense<true>(h, e, ld, P + nd.w[l], nd.in[l], nd.out[l], T, epi);
    __syncthreads();
    float* t = h; h = hn; hn = t;
    t = e; e = en; en = t;
  }
}
