// Warp-owned CROWN and α-CROWN of one role box: the port's one CROWN on the
// card, shared by K6 (bab_segment.cu), KB (stage0_certify.cu), K8b
// (inter_bounds.cu), row 13's CROWN mode and K7 (role_bounds.cu) through
// their forms stage (role_forms_stage), and by K8a (sign_bound.cu) through
// its helpers.  A block takes its role boxes (KB: all 2V of one box; K7 and
// K8b: several boxes) side by side, and every sum of a role box is carried
// by one warp.
//
// CROWN (ops/crown.py:crown_bounds and the plain set of
// crown_output_form_sets): IBP for layer 0, then for every deeper layer a
// backward pass (triangle ReLU relaxation, adaptive lower slope) from that
// layer to the input, concretized over the role box, intersected with IBP
// and widened outward.  Layer k's backward pass is out_k independent
// columns: column c starts from W_k[:, c] and goes down to the input one
// layer at a time (relax, add the constant terms, multiply by W_j).  A warp
// carries two columns of one role box through every step with __syncwarp
// only; its workspace is the columns' current vectors (two floats per row,
// both columns) and their relaxed copies, not the rows x cols matrix, and
// the first step relaxes W_k as it reads it.  The IBP of layer k is one
// thread per (role box, unit).  Block barriers remain only between layers:
// layer k's widened bounds must exist before layer k + 1's relaxation.
//
// α-CROWN (ops/crown.py:optimize_relaxation on the output logit, with
// alpha_iters > 0): the lower (upper) form's backward pass is a chain of
// vectors, one per hidden layer, because the last layer has one unit.  The
// lower bound depends only on the slopes al and the upper only on au, so
// each (role box, side) is one warp's chain of vectors of width <= maxw:
// alpha_chain_side's forward pass and alpha_step_side's hand-written
// reverse pass through the chain and the concretization — with JAX's tie
// rule, max(a, 0) and min(a, 0) each pass half of the gradient at a == 0 —
// then the signed step α ← clip(α ∓ lr·sign(g), 0, 1), iters times.
//
// Relaxation.  Each unit's relaxation (relax below) is computed once, when
// its bounds are widened, and read by every later column step and α pass
// of the role box.
//
// Sums.  The IBP sums, the row sums of every backward step (a lane per row,
// two columns and both forms at once) and of every α pass are index-ordered
// fmaf chains, except that a layer of at most 16 rows splits each row's sum
// over the two half-warps (even and odd terms, each in index order, added
// even + odd).  The constant terms of every step and every concretization
// are summed where the lane holds the terms: lane-strided partials and a
// warp XOR tree.  So these forms and bounds may differ from the plain
// version's (torch's matmul order) in the last bits; the card's checks hold
// K6 to the plain version's decisions, and KB's margins and the bounds of
// K8b, row 13's CROWN mode and K7 to the plain version's within tolerance.
// No sum depends on the block's geometry (warps, role boxes a block).
#pragma once

#include "common.cuh"

#define CW_FULL 0xffffffffu

// CROWN relaxation of one neuron (ops/crown.py:relu_relaxation), masked:
// upper slope, upper intercept, adaptive lower slope.
struct Relax {
  float us, ui, ls;
  bool unst;
};

__device__ __forceinline__ Relax relax(float lo, float hi, float m) {
  Relax r;
  r.unst = lo < 0.f && hi > 0.f;
  const float den = r.unst ? hi - lo : 1.f;
  const float us = r.unst ? hi / den : (lo >= 0.f ? 1.f : 0.f);
  const float ui = r.unst ? -hi * lo / den : 0.f;
  const float ls = r.unst ? (hi >= -lo ? 1.f : 0.f) : us;
  r.us = us * m;
  r.ui = ui * m;
  r.ls = ls * m;
  return r;
}

// d max(a, 0)/da and d min(a, 0)/da with JAX's tie rule (half at a == 0).
__device__ __forceinline__ float dpos(float a) { return a > 0.f ? 1.f : (a == 0.f ? 0.5f : 0.f); }
__device__ __forceinline__ float dneg(float a) { return a < 0.f ? 1.f : (a == 0.f ? 0.5f : 0.f); }
__device__ __forceinline__ float sgnf(float g) { return g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f); }

__host__ __device__ inline int cw_round4(int v) { return (v + 3) & ~3; }

// One role box's shared workspace: the widened bounds of every layer and
// their CROWN relaxation (relax: upper slope, intercept, lower slope,
// masked; offset nd.n[k]), the current layer's IBP bounds, the box.
struct RoleWs {
  float *wslb, *wsub, *us, *ui, *ls, *zlo, *zhi, *inlo, *inhi;
};

__host__ __device__ inline int role_ws_floats(const NetDesc& nd) {
  return cw_round4(5 * nd.nsum + 2 * nd.maxw + 2 * nd.in[0]);
}

__device__ __forceinline__ RoleWs role_ws(float* base, const NetDesc& nd) {
  RoleWs R;
  R.wslb = base;
  R.wsub = R.wslb + nd.nsum;
  R.us = R.wsub + nd.nsum;
  R.ui = R.us + nd.nsum;
  R.ls = R.ui + nd.nsum;
  R.zlo = R.ls + nd.nsum;
  R.zhi = R.zlo + nd.maxw;
  R.inlo = R.zhi + nd.maxw;
  R.inhi = R.inlo + nd.in[0];
  return R;
}

// One warp's scratch: the larger of crown_columns' (two float2 vectors of
// the columns and their relaxed copies: 8 maxw) and alpha_side's (slopes,
// chain vectors by layer, relaxed vector, two adjoints: 2 nsum + d +
// 3 maxw).
__host__ __device__ inline int warp_ws_floats(const NetDesc& nd) {
  const int a = 8 * nd.maxw, b = 2 * nd.nsum + nd.in[0] + 3 * nd.maxw;
  return cw_round4(a > b ? a : b);
}

// Widen the bounds (zl, zh) of unit c of layer k into R.wslb/R.wsub and
// record their relaxation, before the next layer reads them.
__device__ __forceinline__ void widen_unit(const NetDesc& nd, const float* P, const RoleWs& R,
                                           int k, int c, float zl, float zh) {
  const float slack = SLACK_REL * fmaxf(fabsf(zl), fabsf(zh)) + SLACK_ABS;
  const float lo = zl - slack, hi = zh + slack;
  const int o = nd.n[k] + c;
  R.wslb[o] = lo;
  R.wsub[o] = hi;
  const Relax x = relax(lo, hi, P[nd.m[k] + c]);
  R.us[o] = x.us;
  R.ui[o] = x.ui;
  R.ls[o] = x.ls;
}

// IBP of layer k for every (role box, unit): z bounds of the layer's
// pre-activations from the widened, rectified bounds of layer k - 1 (the
// box at k = 0), into R.zlo/R.zhi; layer 0 (no backward pass) is widened
// straight into R.wslb/R.wsub.  One thread per item; callers sync after.
__device__ void ibp_layer(const NetDesc& nd, const float* P, float* roles, int rws, int nrv,
                          int k) {
  const int nin = nd.in[k], nout = nd.out[k], ld = nd.ldw[k];
  const float* Wk = P + nd.w[k];
  const float* Bk = P + nd.b[k];
  const float* Mp = k > 0 ? P + nd.m[k - 1] : nullptr;
  const int poff = k > 0 ? nd.n[k - 1] : 0;
  for (int q = threadIdx.x; q < nrv * nout; q += blockDim.x) {
    const int rv = q / nout, j = q - rv * nout;
    const RoleWs R = role_ws(roles + rv * rws, nd);
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll 4
    for (int i = 0; i < nin; ++i) {
      float rl, rh;
      if (k == 0) {
        rl = R.inlo[i];
        rh = R.inhi[i];
      } else {
        rl = fmaxf(R.wslb[poff + i], 0.f) * Mp[i];
        rh = fmaxf(R.wsub[poff + i], 0.f) * Mp[i];
      }
      const float w = Wk[i * ld + j];
      const float wp = fmaxf(w, 0.f), wn = fminf(w, 0.f);
      a1 = fmaf(rl, wp, a1);
      a2 = fmaf(rh, wn, a2);
      a3 = fmaf(rh, wp, a3);
      a4 = fmaf(rl, wn, a4);
    }
    const float zl = (a1 + a2) + Bk[j], zh = (a3 + a4) + Bk[j];
    if (k == 0) {
      widen_unit(nd, P, R, 0, j, zl, zh);
    } else {
      R.zlo[j] = zl;
      R.zhi[j] = zh;
    }
  }
}

// Sum over the warp by a XOR tree; every lane gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(CW_FULL, v, o);
  return v;
}

// The next vectors of a column pair: dlo[i] = sum_r W[i, r] xlo[r] and
// dup[i] = sum_r W[i, r] xup[r] (float2: both columns) for i < nin, r < n.
// A lane per row i (up to four rows a pass), each sum the index-ordered
// fmaf chain; with `split`, a layer of at most 16 rows splits each sum over
// the two half-warps (even r, odd r), each an index-ordered chain, added
// even + odd, so every lane works and the halves hit distinct banks.
__device__ void rows_dot2(const float* W, int ld, int nin, const float2* xlo,
                          const float2* xup, int n, float2* dlo, float2* dup,
                          bool split = true) {
  const int lane = threadIdx.x & 31;
  if (split && nin <= 16) {
    const int i = lane & 15, h = lane >> 4;
    const float* w = W + min(i, nin - 1) * ld;
    float a0 = 0.f, a1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll 4
    for (int r = h; r < n; r += 2) {
      const float2 rl = xlo[r], ru = xup[r];
      const float wv = w[r];
      a0 = fmaf(wv, rl.x, a0);
      a1 = fmaf(wv, rl.y, a1);
      u0 = fmaf(wv, ru.x, u0);
      u1 = fmaf(wv, ru.y, u1);
    }
    a0 += __shfl_down_sync(CW_FULL, a0, 16);
    a1 += __shfl_down_sync(CW_FULL, a1, 16);
    u0 += __shfl_down_sync(CW_FULL, u0, 16);
    u1 += __shfl_down_sync(CW_FULL, u1, 16);
    if (h == 0 && i < nin) {
      dlo[i] = make_float2(a0, a1);
      dup[i] = make_float2(u0, u1);
    }
    return;
  }
  for (int i0 = 0; i0 < nin; i0 += 128) {
    const int ni = min(nin - i0, 128);
    const float* wr[4];
    float a0[4], a1[4], u0[4], u1[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wr[m] = W + min(i0 + lane + 32 * m, nin - 1) * ld;
      a0[m] = a1[m] = u0[m] = u1[m] = 0.f;
    }
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float2 rl = xlo[r], ru = xup[r];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (32 * m < ni) {
          const float wv = wr[m][r];
          a0[m] = fmaf(wv, rl.x, a0[m]);
          a1[m] = fmaf(wv, rl.y, a1[m]);
          u0[m] = fmaf(wv, ru.x, u0[m]);
          u1[m] = fmaf(wv, ru.y, u1[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = lane + 32 * m;
      if (i < ni) {
        dlo[i0 + i] = make_float2(a0[m], a1[m]);
        dup[i0 + i] = make_float2(u0[m], u1[m]);
      }
    }
  }
}

// rows_dot2 for one vector: dst[i] = sum_r W[i, r] x[r].
__device__ void rows_dot1(const float* W, int ld, int nin, const float* x, int n, float* dst) {
  const int lane = threadIdx.x & 31;
  if (nin <= 16) {
    const int i = lane & 15, h = lane >> 4;
    const float* w = W + min(i, nin - 1) * ld;
    float a = 0.f;
#pragma unroll 4
    for (int r = h; r < n; r += 2) a = fmaf(w[r], x[r], a);
    a += __shfl_down_sync(CW_FULL, a, 16);
    if (h == 0 && i < nin) dst[i] = a;
    return;
  }
  for (int i0 = 0; i0 < nin; i0 += 128) {
    const int ni = min(nin - i0, 128);
    const float* wr[4];
    float acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wr[m] = W + min(i0 + lane + 32 * m, nin - 1) * ld;
      acc[m] = 0.f;
    }
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float xv = x[r];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (32 * m < ni) acc[m] = fmaf(wr[m][r], xv, acc[m]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (lane + 32 * m < ni) dst[i0 + lane + 32 * m] = acc[m];
  }
}

// Layer k's backward pass (k >= 1) for columns c0 and c0 + 1 (nc of them;
// with nc == 1 the second is a copy of the first and is not written) of
// role box R, on one warp: concretized over the box, intersected with the
// IBP bounds in R.zlo/R.zhi and widened into R.wslb/R.wsub.  With f (the
// output layer, c0 = 0) also the output-logit forms: f[0, d) = A_low,
// f[d, 2d) = A_up, f[2d] = c_low, f[2d + 1] = c_up, f[2d + 2] = lb,
// f[2d + 3] = ub.  The constant terms and the concretization are summed
// where the lane holds the terms (lane-strided partials, a XOR tree).
__device__ void crown_columns(const NetDesc& nd, const float* P, const RoleWs& R, float* ws,
                              int k, int c0, int nc, float* f) {
  const int lane = threadIdx.x & 31, mw = nd.maxw, d = nd.in[0];
  float2* Plo = reinterpret_cast<float2*>(ws);
  float2* Pup = Plo + mw;
  float2* Rlo = Pup + mw;
  float2* Rup = Rlo + mw;
  const int c1 = nc > 1 ? c0 + 1 : c0;
  const float* Wk = P + nd.w[k];
  const int ldk = nd.ldw[k];
  float clo0 = P[nd.b[k] + c0], clo1 = P[nd.b[k] + c1];
  float cup0 = clo0, cup1 = clo1;
  int rows = nd.in[k];
  for (int j = k - 1; j >= 0; --j) {
    const int off = nd.n[j];
    const float* Bj = P + nd.b[j];
    // Relaxation of layer j on the columns' rows (the first step reads
    // them from W_k) and the constant terms: sum ui min(a, 0),
    // sum ui max(u, 0), sum b relaxed(a), sum b relaxed(u) per column.
    float p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) p[q] = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float xus = R.us[off + r], xui = R.ui[off + r], xls = R.ls[off + r];
      float2 a, u;
      if (j == k - 1) {
        a.x = u.x = Wk[r * ldk + c0];
        a.y = u.y = Wk[r * ldk + c1];
      } else {
        a = Plo[r];
        u = Pup[r];
      }
      const float ap0 = fmaxf(a.x, 0.f), an0 = fminf(a.x, 0.f);
      const float ap1 = fmaxf(a.y, 0.f), an1 = fminf(a.y, 0.f);
      const float up0 = fmaxf(u.x, 0.f), un0 = fminf(u.x, 0.f);
      const float up1 = fmaxf(u.y, 0.f), un1 = fminf(u.y, 0.f);
      const float rl0 = ap0 * xls + an0 * xus, rl1 = ap1 * xls + an1 * xus;
      const float ru0 = up0 * xus + un0 * xls, ru1 = up1 * xus + un1 * xls;
      Rlo[r] = make_float2(rl0, rl1);
      Rup[r] = make_float2(ru0, ru1);
      const float bj = Bj[r];
      p[0] = fmaf(xui, an0, p[0]);
      p[1] = fmaf(xui, an1, p[1]);
      p[2] = fmaf(xui, up0, p[2]);
      p[3] = fmaf(xui, up1, p[3]);
      p[4] = fmaf(bj, rl0, p[4]);
      p[5] = fmaf(bj, rl1, p[5]);
      p[6] = fmaf(bj, ru0, p[6]);
      p[7] = fmaf(bj, ru1, p[7]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) p[q] = warp_sum(p[q]);
    clo0 = (clo0 + p[0]) + p[4];
    clo1 = (clo1 + p[1]) + p[5];
    cup0 = (cup0 + p[2]) + p[6];
    cup1 = (cup1 + p[3]) + p[7];
    __syncwarp();
    // Next vectors: P[i] = sum_r W_j[i, r] relaxed[r], i < in_j.
    rows_dot2(P + nd.w[j], nd.ldw[j], nd.in[j], Rlo, Rup, rows, Plo, Pup);
    __syncwarp();
    rows = nd.in[j];
  }
  // Concretize over the box: sum inlo max(a, 0) + inhi min(a, 0) (lower),
  // sum inhi max(u, 0) + inlo min(u, 0) (upper), per column.
  float p[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) p[q] = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float2 a = Plo[i], u = Pup[i];
    const float lo = R.inlo[i], hi = R.inhi[i];
    p[0] = fmaf(lo, fmaxf(a.x, 0.f), p[0]);
    p[1] = fmaf(lo, fmaxf(a.y, 0.f), p[1]);
    p[2] = fmaf(hi, fminf(a.x, 0.f), p[2]);
    p[3] = fmaf(hi, fminf(a.y, 0.f), p[3]);
    p[4] = fmaf(hi, fmaxf(u.x, 0.f), p[4]);
    p[5] = fmaf(hi, fmaxf(u.y, 0.f), p[5]);
    p[6] = fmaf(lo, fminf(u.x, 0.f), p[6]);
    p[7] = fmaf(lo, fminf(u.y, 0.f), p[7]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) p[q] = warp_sum(p[q]);
  if (lane < nc) {
    const int c = c0 + lane;
    const float zl = fmaxf(R.zlo[c], (lane ? p[1] + p[3] : p[0] + p[2]) + (lane ? clo1 : clo0));
    const float zh = fminf(R.zhi[c], (lane ? p[5] + p[7] : p[4] + p[6]) + (lane ? cup1 : cup0));
    widen_unit(nd, P, R, k, c, zl, zh);
    if (f != nullptr) {
      f[2 * d + 0] = clo0;
      f[2 * d + 1] = cup0;
      f[2 * d + 2] = R.wslb[nd.n[k]];
      f[2 * d + 3] = R.wsub[nd.n[k]];
    }
  }
  if (f != nullptr)
    for (int i = lane; i < d; i += 32) {
      f[i] = Plo[i].x;
      f[d + i] = Pup[i].x;
    }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// α-CROWN of the output logit, one side of one role box on one warp
// ---------------------------------------------------------------------------

// Scratch of alpha_side (in the warp's workspace): the slopes of the side
// by neuron (offset nd.n[j]), the pre-relaxation chain vectors by layer
// (offset nd.n[j], the input level at nsum), the relaxed vector, two
// adjoints.
struct AlphaSide {
  float *sl, *C, *N, *g, *h;
};

__device__ __forceinline__ AlphaSide alpha_side_ws(float* ws, const NetDesc& nd) {
  AlphaSide a;
  a.sl = ws;
  a.C = a.sl + nd.nsum;
  a.N = a.C + nd.nsum + nd.in[0];
  a.g = a.N + nd.maxw;
  a.h = a.g + nd.maxw;
  return a;
}

// One evaluation of one side's output form (0: the lower form with slopes
// al, 1: the upper with au), the chain vectors left in aw.C (the input
// level at offset nsum): returns the concretized bound, c the constant.  The
// constant terms and the concretization are summed where the lane holds
// the terms (lane-strided partials, a XOR tree).
__device__ float alpha_chain_side(const NetDesc& nd, const float* P, const RoleWs& R,
                                  const AlphaSide& aw, int side, float& c) {
  const int lane = threadIdx.x & 31, k = nd.L - 1, d = nd.in[0];
  const int nk = nd.in[k];
  for (int r = lane; r < nk; r += 32) aw.C[nd.n[k - 1] + r] = P[nd.w[k] + r * nd.ldw[k]];
  c = P[nd.b[k]];
  __syncwarp();
  for (int j = k - 1; j >= 0; --j) {
    const int n = nd.out[j], off = nd.n[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    // sum ui min(a, 0) (upper side: ui max(u, 0)) and sum b n.
    float s0 = 0.f, s1 = 0.f;
    for (int r = lane; r < n; r += 32) {
      const bool unst = R.wslb[off + r] < 0.f && R.wsub[off + r] > 0.f;
      const float us = R.us[off + r];
      const float ls = (unst ? aw.sl[off + r] : R.ls[off + r]) * Mj[r];
      const float a = aw.C[off + r];
      const float ap = fmaxf(a, 0.f), an = fminf(a, 0.f);
      const float nv = side ? ap * us + an * ls : ap * ls + an * us;
      aw.N[r] = nv;
      s0 = fmaf(R.ui[off + r], side ? ap : an, s0);
      s1 = fmaf(Bj[r], nv, s1);
    }
    c = (c + warp_sum(s0)) + warp_sum(s1);
    __syncwarp();
    // Next chain vector: dst[i] = sum_r W_j[i, r] n[r].
    rows_dot1(P + nd.w[j], nd.ldw[j], nd.in[j], aw.N, n,
              aw.C + (j > 0 ? nd.n[j - 1] : nd.nsum));
    __syncwarp();
  }
  // Concretize: lower side inlo max(a, 0) + inhi min(a, 0); upper side
  // inhi max(u, 0) + inlo min(u, 0).
  float s0 = 0.f, s1 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float a = aw.C[nd.nsum + i];
    s0 = fmaf(side ? R.inhi[i] : R.inlo[i], fmaxf(a, 0.f), s0);
    s1 = fmaf(side ? R.inlo[i] : R.inhi[i], fminf(a, 0.f), s1);
  }
  return (warp_sum(s0) + warp_sum(s1)) + c;
}

// The reverse pass of alpha_chain_side (its chain vectors still in aw.C)
// and the signed step of the side's slopes, sl <- clip(sl - lr
// sign(d(width)/d sl), 0, 1).  Layer j's slopes are stepped after its own
// adjoint has been taken, so every layer's gradient is that of the current
// α.
__device__ void alpha_step_side(const NetDesc& nd, const float* P, const RoleWs& R,
                                const AlphaSide& aw, int side, float lr) {
  const int lane = threadIdx.x & 31, k = nd.L - 1, d = nd.in[0];
  float *g = aw.g, *h = aw.h;
  for (int i = lane; i < d; i += 32) {
    const float a = aw.C[nd.nsum + i];
    g[i] = side ? R.inhi[i] * dpos(a) + R.inlo[i] * dneg(a)
                : R.inlo[i] * dpos(a) + R.inhi[i] * dneg(a);
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    const int n = nd.out[j], nin = nd.in[j], off = nd.n[j], ld = nd.ldw[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    const float* Wj = P + nd.w[j];
    for (int r = lane; r < n; r += 32) {
      float gn = 0.f;  // adjoint of the relaxed vector n_j
#pragma unroll 4
      for (int i = 0; i < nin; ++i) gn = fmaf(Wj[i * ld + r], g[i], gn);
      gn += Bj[r];
      const bool unst = R.wslb[off + r] < 0.f && R.wsub[off + r] > 0.f;
      const float us = R.us[off + r], ui = R.ui[off + r];
      const float ls = (unst ? aw.sl[off + r] : R.ls[off + r]) * Mj[r];
      const float a = aw.C[off + r];
      const float gate = unst ? Mj[r] : 0.f;
      if (side) {
        const float dau = gn * fminf(a, 0.f) * gate;  // d hi / d au
        h[r] = (gn * us + ui) * dpos(a) + (gn * ls) * dneg(a);
        aw.sl[off + r] = fminf(fmaxf(aw.sl[off + r] - lr * sgnf(dau), 0.f), 1.f);
      } else {
        const float dal = gn * fmaxf(a, 0.f) * gate;  // d lo / d al
        h[r] = (gn * ls) * dpos(a) + (gn * us + ui) * dneg(a);
        // The width is hi - lo: its gradient is -dal for al.
        aw.sl[off + r] = fminf(fmaxf(aw.sl[off + r] - lr * sgnf(-dal), 0.f), 1.f);
      }
    }
    __syncwarp();
    float* t = g;
    g = h;
    h = t;
  }
}

// α-CROWN of one side (ops/crown.py:crown_output_form_sets with
// alpha_iters > 0), after the role box's CROWN bounds are in R: iters steps from the adaptive slopes, keeping the best
// bound.  Writes the tuned set's side (ft[side d, side d + d) = A,
// ft[2d + side] = c) and the best bound to *best; the caller widens both
// sides' best bounds and intersects them with the plain set's.
__device__ void alpha_side(const NetDesc& nd, const float* P, const RoleWs& R, float* ws,
                           int side, int iters, float* ft, float* best) {
  const int lane = threadIdx.x & 31, k = nd.L - 1, d = nd.in[0];
  const AlphaSide aw = alpha_side_ws(ws, nd);
  for (int j = 0; j < k; ++j)
    for (int r = lane; r < nd.out[j]; r += 32) {
      const int o = nd.n[j] + r;
      aw.sl[o] = R.wsub[o] >= -R.wslb[o] ? 1.f : 0.f;
    }
  __syncwarp();
  float bestv = side ? INFINITY : -INFINITY, lr = 0.5f, c = 0.f, v;
  for (int it = 0; it < iters; ++it) {
    v = alpha_chain_side(nd, P, R, aw, side, c);
    bestv = side ? fminf(bestv, v) : fmaxf(bestv, v);
    alpha_step_side(nd, P, R, aw, side, lr);
    lr = lr * 0.7f;
  }
  v = alpha_chain_side(nd, P, R, aw, side, c);
  bestv = side ? fminf(bestv, v) : fmaxf(bestv, v);
  for (int i = lane; i < d; i += 32) ft[side * d + i] = aw.C[nd.nsum + i];
  if (lane == 0) {
    ft[2 * d + side] = c;
    *best = bestv;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The forms stage of K6's slot phase, KB, K8b, row 13's CROWN mode and K7:
// every role box's CROWN (and α-CROWN) forms, side by side
// ---------------------------------------------------------------------------

// The output-logit forms of nrv role boxes (R.inlo/R.inhi of each, at roles
// + rv * rws, written by the caller before a __syncthreads()): layer by
// layer the IBP of every (role box, unit), then every backward-pass column
// pair of every role box on a warp (crown_columns); with iters > 0 (and a
// hidden layer) every α side of every role box on a warp (alpha_side).  Set
// 0 (plain) of role box rv lands at F + rv * FS, set 1 (α-tuned) at F +
// (nrv + rv) * FS, each A_low (d), A_up (d), c_low, c_up, lb, ub; with α
// both sets' bounds are the widened best α bounds intersected with the
// plain ones (ops/crown.py:crown_output_form_sets; with `widen` false the
// best α bounds are intersected unwidened, ops/crown.py:
// alpha_crown_output_bounds(widen=False)).  With F null (and iters 0) no
// forms are written: the stage leaves every layer's widened bounds in each
// role box's R.wslb/R.wsub (K8b, row 13's CROWN mode).  warps: the block's
// warps' scratch, wws floats each; best: 2 nrv floats.  About 2L block
// barriers; ends with one.
__device__ void role_forms_stage(const NetDesc& nd, const float* P, float* roles, int rws,
                                 float* warps, int wws, int nrv, float* F, int FS,
                                 float* best, int iters, bool widen = true) {
  const int d = nd.in[0], L = nd.L, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  float* ws = warps + warp * wws;
  for (int k = 0; k < L; ++k) {
    ibp_layer(nd, P, roles, rws, nrv, k);
    __syncthreads();
    if (k == 0) continue;
    const int nout = nd.out[k], npair = (nout + 1) / 2;
    for (int t = warp; t < nrv * npair; t += nw) {
      const int rv = t / npair, c0 = 2 * (t - rv * npair);
      crown_columns(nd, P, role_ws(roles + rv * rws, nd), ws, k, c0, min(2, nout - c0),
                    k == L - 1 && F != nullptr ? F + rv * FS : nullptr);
    }
    __syncthreads();
  }
  if (L == 1 && F != nullptr) {  // the forms of a one-layer net are its weights
    for (int q = tid; q < nrv * d; q += nt) {
      const int rv = q / d, i = q - rv * d;
      float* f = F + rv * FS;
      f[i] = f[d + i] = P[nd.w[0] + i * nd.ldw[0]];
      if (i == 0) {
        const RoleWs R = role_ws(roles + rv * rws, nd);
        f[2 * d + 0] = f[2 * d + 1] = P[nd.b[0]];
        f[2 * d + 2] = R.wslb[nd.n[0]];
        f[2 * d + 3] = R.wsub[nd.n[0]];
      }
    }
    __syncthreads();
  }
  if (iters > 0 && L > 1) {
    for (int t = warp; t < 2 * nrv; t += nw) {
      const int rv = t >> 1, side = t & 1;
      alpha_side(nd, P, role_ws(roles + rv * rws, nd), ws, side, iters, F + (nrv + rv) * FS,
                 best + t);
    }
    __syncthreads();
    for (int rv = tid; rv < nrv; rv += nt) {
      float* fp = F + rv * FS;
      float* ft = F + (nrv + rv) * FS;
      const float blo = best[2 * rv], bhi = best[2 * rv + 1];
      const float slack = SLACK_REL * fmaxf(fabsf(blo), fabsf(bhi)) + SLACK_ABS;
      const float w = widen ? slack : 0.f;
      const float lb = fmaxf(blo - w, fp[2 * d + 2]);
      const float ub = fminf(bhi + w, fp[2 * d + 3]);
      fp[2 * d + 2] = ft[2 * d + 2] = lb;
      fp[2 * d + 3] = ft[2 * d + 3] = ub;
    }
    __syncthreads();
  }
}
