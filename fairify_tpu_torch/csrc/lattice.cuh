// The lattice kernels' forward (ops/lattice.py, K9a-c): a true-f32 pass
// over a tile of lattice points with the running rigorous round-off bound
//
//   z = h.W + b,   a = |h|.|W| + |b|,   e' = e.|W| + gamma_l * a,
//   gamma_l = 4 (n_in + 4) 2^-24
//
// (hidden layers: h' = relu(z) * m, e' = e' * m).  The bound covers any
// summation order, so no TF32, no tensor cores and no --use_fast_math; the
// formula is the JAX package's _signed_forward, not restructured.
//
// Layout (warp_tile.cuh's): a warp carries its own tile of TW lattice
// points through every layer with __syncwarp only.  The activation tile H
// and the bound tile E are unit-major with warp_tile.cuh's swizzle, and the
// weights come from the padded pack's forward part, so a lane's four rows
// are one 16-byte load and its four columns another.  A lane owns RR rows
// x RC columns of a layer's output with three accumulators each (z,
// |h|.|W|, e.|W|; layer 0 skips e.|W|, e = 0 there): 8 x 4, 4 x 4, 4 x 2
// or 4 x 1, the tile with the shortest lane chain for the layer's width.
// Every sum is the index-ordered fmaf chain from 0 over the layer's
// inputs, so f and e do not depend on the tile, the warp or the block.
#pragma once

#include "common.cuh"
#include "warp_tile.cuh"

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

// The signed forward's tile menu: warp_tile.cuh's tiles 1-4 ((8, 4),
// (4, 4), (4, 2), (4, 1)); 8 x 8 would hold 192 accumulators.  A lane's
// instructions per k-step over all its passes: 3 RR RC FMAs and its loads
// (RR / 4 for H, RR / 4 for E, RC / 4 weights, at least one), a load
// counted twice; the cheapest tile, the larger on a tie.
__host__ __device__ inline int signed_pick_tile(int nout, int tw) {
  int best = -1, cost = 0;
  for (int id = 1; id < WT_TILES; ++id) {
    const int rr = tile_rr(id), rc = tile_rc(id);
    if (tw % rr != 0) continue;
    const int c = (tile_items(id, nout, tw) + 31) / 32 *
                  (3 * rr * rc + 2 * (2 * (rr / 4) + (rc + 3) / 4));
    if (best < 0 || c < cost) {
      best = id;
      cost = c;
    }
  }
  return best;
}

// What a layer does with its sums (z, a, ee) of unit j, row r: hidden
// layers write h' = relu(z + b) m and e' = (ee + gamma (a + |b|)) m to the
// next tiles; the output layer writes f = z + b and e' of unit 0 to f[r],
// fe[r].
struct SignedEpi {
  bool hidden;
  float gamma;
  const float* bias;
  const float* mask;
  float *hout, *eout, *f, *fe;
};

template <int RR, int RC, bool WITH_E>
__device__ __forceinline__ void signed_dense(const float* __restrict__ H,
                                             const float* __restrict__ E, int tw, int smask,
                                             const float* __restrict__ W, int ldw, int K,
                                             int nout, int lane, const SignedEpi& ep) {
  constexpr int RCW = RC < 4 ? RC : 4;  // columns per chunk
  constexpr int NP = RR / 4;            // row chunks
  const int CG = (nout + RC - 1) / RC, RG = tw / RR, items = CG * RG;
  for (int item = lane; item < items; item += 32) {
    const int cg = item % CG, rg = item / CG;
    float z[RR][RC], a[RR][RC], ee[RR][RC];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) z[r][c] = a[r][c] = ee[r][c] = 0.f;
    const float* wp = W + RCW * cg;
    for (int k = 0; k < K; ++k) {
      // The operands of k-step k: RR activations and bounds (rows 4 (rg +
      // p RG) .. + 3, their chunk XORed with the swizzle) and RC weights.
      const int s = ((k >> 2) & smask) << 2;
      float hv[RR], ev[RR], wv[RC];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int o = k * tw + ((4 * (rg + p * RG)) ^ s);
        const float4 th = *reinterpret_cast<const float4*>(H + o);
        hv[4 * p] = th.x;
        hv[4 * p + 1] = th.y;
        hv[4 * p + 2] = th.z;
        hv[4 * p + 3] = th.w;
        if (WITH_E) {
          const float4 te = *reinterpret_cast<const float4*>(E + o);
          ev[4 * p] = te.x;
          ev[4 * p + 1] = te.y;
          ev[4 * p + 2] = te.z;
          ev[4 * p + 3] = te.w;
        }
      }
#pragma unroll
      for (int q = 0; q < RC / RCW; ++q) {
        const float* src = wp + k * ldw + RCW * q * CG;
        if constexpr (RCW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          wv[4 * q] = t.x;
          wv[4 * q + 1] = t.y;
          wv[4 * q + 2] = t.z;
          wv[4 * q + 3] = t.w;
        } else if constexpr (RCW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(src);
          wv[2 * q] = t.x;
          wv[2 * q + 1] = t.y;
        } else {
          wv[q] = *src;
        }
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float ah = fabsf(hv[r]);
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const float aw = fabsf(wv[c]);
          z[r][c] = fmaf(hv[r], wv[c], z[r][c]);
          a[r][c] = fmaf(ah, aw, a[r][c]);
          if (WITH_E) ee[r][c] = fmaf(ev[r], aw, ee[r][c]);
        }
      }
    }
    // Epilogue.  Row of acc[r]: 4 (rg + (r / 4) RG) + r % 4; unit of
    // acc[.][c]: RCW (cg + (c / RCW) CG) + c % RCW.
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = RCW * (cg + (c / RCW) * CG) + c % RCW;
      if (j >= nout || (!ep.hidden && j != 0)) continue;
      const float bj = ep.bias[j], abj = fabsf(bj), mj = ep.mask[j];
      float oh[RR], oe[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float zz = z[r][c] + bj;
        const float aa = a[r][c] + abj;
        const float ev = ee[r][c] + ep.gamma * aa;
        oh[r] = fmaxf(zz, 0.f) * mj;
        oe[r] = ev * mj;
        if (!ep.hidden) {
          const int row = 4 * (rg + (r / 4) * RG) + r % 4;
          ep.f[row] = zz;
          ep.fe[row] = ev;
        }
      }
      if (!ep.hidden) continue;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int o = act_off(j, 4 * (rg + p * RG), tw, smask);
        *reinterpret_cast<float4*>(ep.hout + o) =
            make_float4(oh[4 * p], oh[4 * p + 1], oh[4 * p + 2], oh[4 * p + 3]);
        *reinterpret_cast<float4*>(ep.eout + o) =
            make_float4(oe[4 * p], oe[4 * p + 1], oe[4 * p + 2], oe[4 * p + 3]);
      }
    }
  }
}

// One layer with tile `tile` (signed_pick_tile(nout, tw)); layer 0 passes
// with_e = false.
__device__ __forceinline__ void signed_layer(int tile, bool with_e, const float* H,
                                             const float* E, int tw, int smask,
                                             const float* W, int ldw, int K, int nout,
                                             int lane, const SignedEpi& ep) {
  if (with_e) {
    switch (tile) {
      case 1: signed_dense<8, 4, true>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      case 2: signed_dense<4, 4, true>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      case 3: signed_dense<4, 2, true>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      default: signed_dense<4, 1, true>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
    }
  } else {
    switch (tile) {
      case 1: signed_dense<8, 4, false>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      case 2: signed_dense<4, 4, false>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      case 3: signed_dense<4, 2, false>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
      default: signed_dense<4, 1, false>(H, E, tw, smask, W, ldw, K, nout, lane, ep); break;
    }
  }
}
