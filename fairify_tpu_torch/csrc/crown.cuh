// Block-wide CROWN device functions: the bounds and output-logit linear
// forms of one role box and the α-CROWN optimiser of those forms, a whole
// block on one role box (K7); K6, KB, K8b and row 13's CROWN mode run the
// same arithmetic warp by warp (crown_warp.cuh).
//
// crown_role_forms mirrors ops/crown.py:crown_bounds + the plain set of
// crown_output_form_sets: IBP for layer 0, then for every deeper layer a
// backward pass (triangle ReLU relaxation, adaptive lower slope) from that
// layer to the input, concretized over the role box, intersected with IBP
// and widened outward.  The whole block works on one role box; the packed
// network, the layer bounds and the backward pass's coefficient matrices
// (A_low/A_up ping-pong) live in shared memory.
//
// alpha_role_forms mirrors ops/crown.py:optimize_relaxation on the output
// logit (alpha_iters > 0): the lower (upper) form's backward pass is a
// chain of vectors, one per hidden layer, because the last layer has one
// unit.  Each iteration evaluates both chains, keeps the best bounds, takes
// the gradient of the summed width with respect to each unstable neuron's
// slope by a hand-written reverse pass through the chains and the
// concretization — with JAX's tie rule, max(a, 0) and min(a, 0) each pass
// half of the gradient at a == 0 — and steps α ← clip(α ∓ lr·sign(g), 0, 1).
#pragma once

#include "common.cuh"

// Largest backward-pass coefficient matrix: layer k's pass starts from
// W_k (in_k x out_k) and shrinks its row count to in_j at step j.
static int crown_max_a(const NetDesc& nd) {
  int best = 1;
  for (int k = 1; k < nd.L; ++k) {
    int rows = 0;
    for (int j = 0; j <= k; ++j) rows = rows > nd.in[j] ? rows : nd.in[j];
    if (rows * nd.out[k] > best) best = rows * nd.out[k];
  }
  return best;
}

// Shared-memory workspace of one role box's CROWN pass.
struct CrownWs {
  float *wslb, *wsub;  // nsum each: widened pre-activation bounds by layer
  float *rlo, *rhi, *zlo, *zhi, *US, *UI, *LS, *clo, *cup;  // maxw each
  float *inlo, *inhi;                                        // d each
  float *Alo[2], *Aup[2];                                    // maxA each
};

static inline int crown_ws_floats(const NetDesc& nd, int maxA) {
  return 2 * nd.nsum + 9 * nd.maxw + 2 * nd.in[0] + 4 * maxA;
}

// Carve the workspace out of shared memory at `base`; returns the end.
__device__ __forceinline__ float* crown_ws_carve(CrownWs& w, float* base,
                                                 const NetDesc& nd, int maxA) {
  const int d = nd.in[0];
  w.wslb = base;
  w.wsub = w.wslb + nd.nsum;
  w.rlo = w.wsub + nd.nsum;
  w.rhi = w.rlo + nd.maxw;
  w.zlo = w.rhi + nd.maxw;
  w.zhi = w.zlo + nd.maxw;
  w.US = w.zhi + nd.maxw;
  w.UI = w.US + nd.maxw;
  w.LS = w.UI + nd.maxw;
  w.clo = w.LS + nd.maxw;
  w.cup = w.clo + nd.maxw;
  w.inlo = w.cup + nd.maxw;
  w.inhi = w.inlo + d;
  w.Alo[0] = w.inhi + d;
  w.Alo[1] = w.Alo[0] + maxA;
  w.Aup[0] = w.Alo[1] + maxA;
  w.Aup[1] = w.Aup[0] + maxA;
  return w.Aup[1] + maxA;
}

// CROWN bounds of every layer over the role box [w.inlo, w.inhi] (written
// by the caller before a __syncthreads()) into w.wslb/w.wsub, and the
// output-logit forms: f[0, d) = A_low, f[d, 2d) = A_up, f[2d] = c_low,
// f[2d + 1] = c_up, f[2d + 2] = lb, f[2d + 3] = ub (the widened output
// bounds).  Ends with a __syncthreads().
__device__ void crown_role_forms(const NetDesc& nd, int maxA, const float* P,
                                 const CrownWs& w, float* f) {
  const int d = nd.in[0], L = nd.L, tid = threadIdx.x, nt = blockDim.x;
  float *wslb = w.wslb, *wsub = w.wsub, *rlo = w.rlo, *rhi = w.rhi;
  float *zlo = w.zlo, *zhi = w.zhi, *US = w.US, *UI = w.UI, *LS = w.LS;
  float *clo = w.clo, *cup = w.cup;
  const float *inlo = w.inlo, *inhi = w.inhi;
  float* const* Alo = w.Alo;
  float* const* Aup = w.Aup;
  for (int i = tid; i < d; i += nt) {
    rlo[i] = inlo[i];
    rhi[i] = inhi[i];
  }
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < L; ++k) {
    const int nin = nd.in[k], nout = nd.out[k];
    const float* Wk = P + nd.w[k];
    const float* Bk = P + nd.b[k];
    for (int j = tid; j < nout; j += nt) {  // IBP of layer k
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float w = Wk[i * nout + j];
        const float wp = fmaxf(w, 0.f), wn = fminf(w, 0.f);
        a1 = fmaf(rlo[i], wp, a1);
        a2 = fmaf(rhi[i], wn, a2);
        a3 = fmaf(rhi[i], wp, a3);
        a4 = fmaf(rlo[i], wn, a4);
      }
      zlo[j] = (a1 + a2) + Bk[j];
      zhi[j] = (a3 + a4) + Bk[j];
    }
    if (k > 0) {
      // Backward pass for layer k: A = W_k, c = b_k, then through layers
      // k-1 .. 0.  A is (rows x cols) row-major, cols = out_k.
      const int cols = nout;
      int rows = nin;
      cur = 0;
      for (int i = tid; i < rows * cols; i += nt) Alo[0][i] = Aup[0][i] = Wk[i];
      for (int c = tid; c < cols; c += nt) clo[c] = cup[c] = Bk[c];
      __syncthreads();
      for (int j = k - 1; j >= 0; --j) {
        const float* Mj = P + nd.m[j];
        for (int r = tid; r < rows; r += nt) {  // relaxation of layer j
          const float lo = wslb[nd.n[j] + r], hi = wsub[nd.n[j] + r];
          const bool unst = lo < 0.f && hi > 0.f;
          const float den = unst ? hi - lo : 1.f;
          const float us = unst ? hi / den : (lo >= 0.f ? 1.f : 0.f);
          const float ui = unst ? -hi * lo / den : 0.f;
          const float ls = unst ? (hi >= -lo ? 1.f : 0.f) : us;
          US[r] = us * Mj[r];
          UI[r] = ui * Mj[r];
          LS[r] = ls * Mj[r];
        }
        __syncthreads();
        const float* Bj = P + nd.b[j];
        float* al = Alo[cur];
        float* au = Aup[cur];
        for (int c = tid; c < cols; c += nt) {
          float s1 = 0.f, s2 = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float a = al[r * cols + c], u = au[r * cols + c];
            const float ap = fmaxf(a, 0.f), an = fminf(a, 0.f);
            const float up = fmaxf(u, 0.f), un = fminf(u, 0.f);
            s1 = fmaf(UI[r], an, s1);
            s2 = fmaf(UI[r], up, s2);
            al[r * cols + c] = ap * LS[r] + an * US[r];
            au[r * cols + c] = up * US[r] + un * LS[r];
          }
          float t1 = 0.f, t2 = 0.f;
          for (int r = 0; r < rows; ++r) {
            t1 = fmaf(Bj[r], al[r * cols + c], t1);
            t2 = fmaf(Bj[r], au[r * cols + c], t2);
          }
          clo[c] = (clo[c] + s1) + t1;
          cup[c] = (cup[c] + s2) + t2;
        }
        __syncthreads();
        const int nrows = nd.in[j];
        const float* Wj = P + nd.w[j];
        float* al2 = Alo[cur ^ 1];
        float* au2 = Aup[cur ^ 1];
        for (int idx = tid; idx < nrows * cols; idx += nt) {
          const int i = idx / cols, c = idx - i * cols;
          float sl = 0.f, su = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float w = Wj[i * rows + r];
            sl = fmaf(w, al[r * cols + c], sl);
            su = fmaf(w, au[r * cols + c], su);
          }
          al2[idx] = sl;
          au2[idx] = su;
        }
        __syncthreads();
        cur ^= 1;
        rows = nrows;
      }
      // Concretize over the role box and intersect with IBP.
      const float* al = Alo[cur];
      const float* au = Aup[cur];
      for (int c = tid; c < cols; c += nt) {
        float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
        for (int i = 0; i < d; ++i) {
          const float a = al[i * cols + c], u = au[i * cols + c];
          s1 = fmaf(inlo[i], fmaxf(a, 0.f), s1);
          s2 = fmaf(inhi[i], fminf(a, 0.f), s2);
          s3 = fmaf(inhi[i], fmaxf(u, 0.f), s3);
          s4 = fmaf(inlo[i], fminf(u, 0.f), s4);
        }
        zlo[c] = fmaxf(zlo[c], (s1 + s2) + clo[c]);
        zhi[c] = fminf(zhi[c], (s3 + s4) + cup[c]);
      }
    }
    __syncthreads();
    const float* Mk = P + nd.m[k];
    for (int j = tid; j < nout; j += nt) {  // widen, record, next input
      const float slack = SLACK_REL * fmaxf(fabsf(zlo[j]), fabsf(zhi[j])) + SLACK_ABS;
      const float lo = zlo[j] - slack, hi = zhi[j] + slack;
      wslb[nd.n[k] + j] = lo;
      wsub[nd.n[k] + j] = hi;
      rlo[j] = fmaxf(lo, 0.f) * Mk[j];
      rhi[j] = fmaxf(hi, 0.f) * Mk[j];
    }
    __syncthreads();
  }
  // Output forms of the last backward pass (one output unit).
  const float* al = L > 1 ? Alo[cur] : P + nd.w[0];
  const float* au = L > 1 ? Aup[cur] : P + nd.w[0];
  for (int i = tid; i < d; i += nt) {
    f[i] = al[i];
    f[d + i] = au[i];
  }
  if (tid == 0) {
    f[2 * d + 0] = L > 1 ? clo[0] : P[nd.b[0]];
    f[2 * d + 1] = L > 1 ? cup[0] : P[nd.b[0]];
    f[2 * d + 2] = wslb[nd.n[L - 1]];
    f[2 * d + 3] = wsub[nd.n[L - 1]];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// α-CROWN of the output logit
// ---------------------------------------------------------------------------

// Shared-memory workspace of the α optimiser.
struct AlphaWs {
  float *al, *au;  // nsum each: slopes of the hidden neurons (offset nd.n[j])
  float *AL, *AU;  // nsum + d each: pre-relaxation chain vectors by layer
                   // (offset nd.n[j]), the input-level vector at nsum
  float *NL, *NU;  // maxw each: the current layer's relaxed vectors
  float *gL, *gU, *hL, *hU;  // maxw each: adjoint ping-pong
  float* red;                // 128: reduction scratch
};

static inline int alpha_ws_floats(const NetDesc& nd) {
  return 4 * nd.nsum + 2 * nd.in[0] + 6 * nd.maxw + 128;
}

__device__ __forceinline__ float* alpha_ws_carve(AlphaWs& a, float* base,
                                                 const NetDesc& nd) {
  const int d = nd.in[0];
  a.al = base;
  a.au = a.al + nd.nsum;
  a.AL = a.au + nd.nsum;
  a.AU = a.AL + nd.nsum + d;
  a.NL = a.AU + nd.nsum + d;
  a.NU = a.NL + nd.maxw;
  a.gL = a.NU + nd.maxw;
  a.gU = a.gL + nd.maxw;
  a.hL = a.gU + nd.maxw;
  a.hU = a.hL + nd.maxw;
  a.red = a.hU + nd.maxw;
  return a.red + 128;
}

// Block-wide sum of four values; every thread gets the same result (the
// per-warp partials are added in one fixed order).
__device__ __forceinline__ float4 block_sum4(float4 v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) {
    red[4 * wid + 0] = v.x;
    red[4 * wid + 1] = v.y;
    red[4 * wid + 2] = v.z;
    red[4 * wid + 3] = v.w;
  }
  __syncthreads();
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < nw; ++i) {
    r.x += red[4 * i + 0];
    r.y += red[4 * i + 1];
    r.z += red[4 * i + 2];
    r.w += red[4 * i + 3];
  }
  __syncthreads();
  return r;
}

// CROWN relaxation of one neuron (ops/crown.py:relu_relaxation), masked.
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

// One evaluation of the lower and upper output forms with slopes (al, au):
// the chain vectors land in aw.AL/aw.AU (input level at offset nsum);
// returns the concretized (lo, hi) and the constants (cL, cU).
__device__ void alpha_chain(const NetDesc& nd, const float* P, const CrownWs& w,
                            const AlphaWs& aw, float& lo, float& hi, float& cL,
                            float& cU) {
  const int k = nd.L - 1, d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int nk = nd.in[k];
  for (int r = tid; r < nk; r += nt)  // W_k is nk x 1
    aw.AL[nd.n[k - 1] + r] = aw.AU[nd.n[k - 1] + r] = P[nd.w[k] + r];
  cL = cU = P[nd.b[k]];
  __syncthreads();
  for (int j = k - 1; j >= 0; --j) {
    const int n = nd.out[j], off = nd.n[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = tid; r < n; r += nt) {
      const Relax x = relax(w.wslb[off + r], w.wsub[off + r], Mj[r]);
      const float lsl = (x.unst ? aw.al[off + r] : x.ls) * Mj[r];
      const float lsu = (x.unst ? aw.au[off + r] : x.ls) * Mj[r];
      const float a = aw.AL[off + r], u = aw.AU[off + r];
      const float ap = fmaxf(a, 0.f), an = fminf(a, 0.f);
      const float up = fmaxf(u, 0.f), un = fminf(u, 0.f);
      const float nl = ap * lsl + an * x.us, nu = up * x.us + un * lsu;
      aw.NL[r] = nl;
      aw.NU[r] = nu;
      acc.x = fmaf(x.ui, an, acc.x);
      acc.y = fmaf(Bj[r], nl, acc.y);
      acc.z = fmaf(x.ui, up, acc.z);
      acc.w = fmaf(Bj[r], nu, acc.w);
    }
    acc = block_sum4(acc, aw.red);
    cL = (cL + acc.x) + acc.y;
    cU = (cU + acc.z) + acc.w;
    // Next chain vectors a[i] = sum_r W_j[i][r] * n[r], one warp per i.
    const int nin = nd.in[j];
    const float* Wj = P + nd.w[j];
    float* dL = aw.AL + (j > 0 ? nd.n[j - 1] : nd.nsum);
    float* dU = aw.AU + (j > 0 ? nd.n[j - 1] : nd.nsum);
    for (int i = wid; i < nin; i += nw) {
      float sl = 0.f, su = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float wv = Wj[i * n + r];
        sl = fmaf(wv, aw.NL[r], sl);
        su = fmaf(wv, aw.NU[r], su);
      }
      for (int o = 16; o > 0; o >>= 1) {
        sl += __shfl_xor_sync(0xffffffffu, sl, o);
        su += __shfl_xor_sync(0xffffffffu, su, o);
      }
      if (lane == 0) {
        dL[i] = sl;
        dU[i] = su;
      }
    }
    __syncthreads();
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < d; i += nt) {
    const float a = aw.AL[nd.nsum + i], u = aw.AU[nd.nsum + i];
    acc.x = fmaf(w.inlo[i], fmaxf(a, 0.f), acc.x);
    acc.y = fmaf(w.inhi[i], fminf(a, 0.f), acc.y);
    acc.z = fmaf(w.inhi[i], fmaxf(u, 0.f), acc.z);
    acc.w = fmaf(w.inlo[i], fminf(u, 0.f), acc.w);
  }
  acc = block_sum4(acc, aw.red);
  lo = (acc.x + acc.y) + cL;
  hi = (acc.z + acc.w) + cU;
}

// Reverse pass of alpha_chain (the chain vectors still in aw.AL/aw.AU):
// d lo/d al and d hi/d au per unstable neuron, then the signed step
// α ← clip(α − lr·sign(∂(hi − lo)/∂α), 0, 1).  Layer j's slopes are
// stepped after its own adjoint has been taken, so every layer's gradient
// is that of the current α.
__device__ void alpha_step(const NetDesc& nd, const float* P, const CrownWs& w,
                           const AlphaWs& aw, float lr) {
  const int k = nd.L - 1, d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  float *gl = aw.gL, *gu = aw.gU, *hl = aw.hL, *hu = aw.hU;
  for (int i = tid; i < d; i += nt) {
    const float a = aw.AL[nd.nsum + i], u = aw.AU[nd.nsum + i];
    gl[i] = w.inlo[i] * dpos(a) + w.inhi[i] * dneg(a);
    gu[i] = w.inhi[i] * dpos(u) + w.inlo[i] * dneg(u);
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const int n = nd.out[j], nin = nd.in[j], off = nd.n[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    const float* Wj = P + nd.w[j];
    for (int r = tid; r < n; r += nt) {
      float gnl = 0.f, gnu = 0.f;  // adjoint of the relaxed vector n_j
      for (int i = 0; i < nin; ++i) {
        const float wv = Wj[i * n + r];
        gnl = fmaf(wv, gl[i], gnl);
        gnu = fmaf(wv, gu[i], gnu);
      }
      gnl += Bj[r];
      gnu += Bj[r];
      const Relax x = relax(w.wslb[off + r], w.wsub[off + r], Mj[r]);
      const float lsl = (x.unst ? aw.al[off + r] : x.ls) * Mj[r];
      const float lsu = (x.unst ? aw.au[off + r] : x.ls) * Mj[r];
      const float a = aw.AL[off + r], u = aw.AU[off + r];
      const float gate = x.unst ? Mj[r] : 0.f;
      const float dal = gnl * fmaxf(a, 0.f) * gate;  // d lo / d al
      const float dau = gnu * fminf(u, 0.f) * gate;  // d hi / d au
      hl[r] = (gnl * lsl) * dpos(a) + (gnl * x.us + x.ui) * dneg(a);
      hu[r] = (gnu * x.us + x.ui) * dpos(u) + (gnu * lsu) * dneg(u);
      // The width is hi - lo: its gradient is -dal for al and dau for au.
      aw.al[off + r] = fminf(fmaxf(aw.al[off + r] - lr * sgnf(-dal), 0.f), 1.f);
      aw.au[off + r] = fminf(fmaxf(aw.au[off + r] - lr * sgnf(dau), 0.f), 1.f);
    }
    __syncthreads();
    float* t = gl;
    gl = hl;
    hl = t;
    t = gu;
    gu = hu;
    hu = t;
  }
}

// ops/crown.py:crown_output_form_sets with alpha_iters > 0, after
// crown_role_forms has filled w (bounds) and fp (the plain set): iters
// signed-gradient steps on α from the adaptive slopes, keeping the best
// bounds; ft receives the tuned set (final α), and both sets' bounds
// become the widened best bounds intersected with the plain ones.
__device__ void alpha_role_forms(const NetDesc& nd, const float* P, const CrownWs& w,
                                 const AlphaWs& aw, int iters, float* fp, float* ft) {
  const int k = nd.L - 1, d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < k; ++j)
    for (int r = tid; r < nd.out[j]; r += nt) {
      const int o = nd.n[j] + r;
      aw.al[o] = aw.au[o] = w.wsub[o] >= -w.wslb[o] ? 1.f : 0.f;
    }
  __syncthreads();
  float best_lo = -INFINITY, best_hi = INFINITY, lr = 0.5f;
  float lo, hi, cL, cU;
  for (int it = 0; it < iters; ++it) {
    alpha_chain(nd, P, w, aw, lo, hi, cL, cU);
    best_lo = fmaxf(best_lo, lo);
    best_hi = fminf(best_hi, hi);
    alpha_step(nd, P, w, aw, lr);
    lr = lr * 0.7f;
  }
  alpha_chain(nd, P, w, aw, lo, hi, cL, cU);
  best_lo = fmaxf(best_lo, lo);
  best_hi = fminf(best_hi, hi);
  const float slack = SLACK_REL * fmaxf(fabsf(best_lo), fabsf(best_hi)) + SLACK_ABS;
  const float lb = fmaxf(best_lo - slack, fp[2 * d + 2]);
  const float ub = fminf(best_hi + slack, fp[2 * d + 3]);
  for (int i = tid; i < d; i += nt) {
    ft[i] = aw.AL[nd.nsum + i];
    ft[d + i] = aw.AU[nd.nsum + i];
  }
  __syncthreads();
  if (tid == 0) {
    ft[2 * d + 0] = cL;
    ft[2 * d + 1] = cU;
    fp[2 * d + 2] = ft[2 * d + 2] = lb;
    fp[2 * d + 3] = ft[2 * d + 3] = ub;
  }
  __syncthreads();
}
