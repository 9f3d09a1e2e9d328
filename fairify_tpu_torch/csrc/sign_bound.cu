// K8a — β-CROWN output bounds under per-neuron sign splits, one box per block.
//
// Replaces fairify_tpu/verify/engine.py:_sign_bound_kernel
// (ops/crown.py:sign_constrained_output_bounds), the bound of Phase S's
// device frontier.  Per box and sign pattern (+1 active, -1 inactive, 0 free
// per hidden neuron), layer by layer: IBP of the layer from the previous
// layer's clamped bounds; for every layer k >= 1 its own CROWN backward pass
// to the input with the β penalties of the splits (A_low -= β_low·s,
// A_up += β_up·s on the z_j coefficients), α/β-optimised over the layer's
// n_k outputs by `alpha_iters` signed-gradient steps on the summed width
// (α from the adaptive slope, clipped to [0, 1], step 0.5·0.7^t; β from 0,
// clipped at 0, step 0.8; the best bounds of all iterates kept), intersected
// with IBP and widened outward; then the split clamps, the feasibility flag,
// the BaBSR scores and the int8 resolved signs.  With alpha_iters = 0 each
// layer takes one pass with the adaptive slopes and β = 0.
//
// The gradient is a hand-written reverse pass.  Layer k's forward keeps, for
// each form, the coefficient matrix before each relaxation step
// (P_j = the form on h_j, n_j x n_k, for j = k-1 .. 0) and the input-level
// matrix (d x n_k).  The reverse pass starts from the concretization,
// d lo/d A_in = lb·dpos(A) + ub·dneg(A), and carries a MATRIX adjoint up
// through each step: through A_{j-1} = W_j·N_j and the constants
// (c += b_j·N_j + ui·min/max(P_j, 0)) to N_j, then per row r of layer j the
// gradients d lo/d α_low = Σ_c G·max(P, 0) and d hi/d α_up = Σ_c G·min(P, 0)
// (unstable alive neurons only), d lo/d β_low = −s·Σ_c G and
// d hi/d β_up = s·Σ_c G (the diagonal row shift), and the adjoint of P_j.
// JAX's tie rules hold: max(a, 0) and min(a, 0) pass half the gradient at
// a = 0, sign(0) = 0, and a stable or masked neuron's α gets none.  Layer
// j's α/β are stepped right after their own gradient is taken (nothing later
// in the reverse pass reads them), so every gradient is that of the current
// iterate, as in JAX.
//
// Bound on the H100: fp32 FMA throughput — per box, per layer k >= 1 and
// per evaluation, two forms of sum_{j<k} in_j * n_j * n_k MACs forward and
// as many in the reverse pass (~1.4 M per evaluation at AC-S1 widths,
// alpha_iters + 1 evaluations); the bytes (box, signs in; bounds, scores
// and resolved signs out) are small.
//
// Design: one block per box.  The packed network, the layer bounds, the
// relaxations, α/β and the per-column constants live in dynamic shared
// memory (~71 KB at AC-S1, three blocks per SM).  The step matrices and
// the adjoint ping-pong buffers do not fit beside them (one layer-1 pass
// alone keeps two 64 x 128 matrices per step), so they live in a per-box
// slice of a global workspace the wrapper allocates (~200 KB per box at
// AC-S1; resident blocks touch ~80 MB of it, mostly in L2).  Recomputing
// the matrices in the reverse pass instead would double the forward work
// per step.  Every product is a true-f32 FMA loop (no tensor cores, so no
// TF32).
#include "common.cuh"
#include "crown.cuh"

#define K8A_THREADS 256
#define BETA_LR 0.8f

struct SignWs {
  float *inlo, *inhi;                            // d each: the box
  float *rlo, *rhi, *zlo, *zhi, *blo, *bhi;      // maxw each
  float *clo, *cup, *elo, *ehi;                  // maxw each: per-column
  float *wslb, *wsub, *US, *UI, *LS, *UN, *S;    // nsum each, by layer
  float *AL, *AU, *BL, *BU;                      // nsum each: α, β
  float* red;                                    // 32
  int* flag;
};

static inline int sign_ws_shared(const NetDesc& nd) {
  return nd.total + 2 * nd.in[0] + 10 * nd.maxw + 11 * nd.nsum + 32 + 1;
}

// Global workspace per box: for each form the stack of step matrices
// (offset n[j]·cols for layer j, n[k]·cols for the input level), then four
// adjoint buffers.  Keep in sync with verify/engine.py:sign_bound_ws_floats.
static inline void sign_ws_global(const NetDesc& nd, int& stk, int& adj) {
  stk = adj = 1;
  for (int k = 1; k < nd.L; ++k) {
    const int cols = nd.out[k];
    int widest = nd.in[0];
    for (int j = 0; j < k; ++j) widest = widest > nd.out[j] ? widest : nd.out[j];
    if (cols * (nd.n[k] + nd.in[0]) > stk) stk = cols * (nd.n[k] + nd.in[0]);
    if (cols * widest > adj) adj = cols * widest;
  }
}

// One evaluation of layer k's two forms with the current α/β: the step
// matrices land in PL/PU, the per-column bounds in w.elo/w.ehi.
__device__ void sb_eval(const NetDesc& nd, const float* P, const SignWs& w, int k,
                        float* PL, float* PU, float* NL, float* NU) {
  const int tid = threadIdx.x, nt = blockDim.x, d = nd.in[0], cols = nd.out[k];
  {
    const int rows = nd.in[k];
    const float* Wk = P + nd.w[k];
    float* pl = PL + nd.n[k - 1] * cols;
    float* pu = PU + nd.n[k - 1] * cols;
    for (int i = tid; i < rows * cols; i += nt) pl[i] = pu[i] = Wk[i];
    for (int c = tid; c < cols; c += nt) w.clo[c] = w.cup[c] = P[nd.b[k] + c];
  }
  __syncthreads();
  for (int j = k - 1; j >= 0; --j) {
    const int rows = nd.out[j], off = nd.n[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    const float* pl = PL + off * cols;
    const float* pu = PU + off * cols;
    for (int c = tid; c < cols; c += nt) {  // relaxation, β shift, constants
      float s1 = 0.f, s2 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int o = off + r;
        const float a = pl[r * cols + c], u = pu[r * cols + c];
        const float ap = fmaxf(a, 0.f), an = fminf(a, 0.f);
        const float up = fmaxf(u, 0.f), un = fminf(u, 0.f);
        const bool unst = w.UN[o] != 0.f;
        const float lsl = (unst ? w.AL[o] : w.LS[o]) * Mj[r];
        const float lsu = (unst ? w.AU[o] : w.LS[o]) * Mj[r];
        const float vl = (ap * lsl + an * w.US[o]) - w.BL[o] * w.S[o];
        const float vu = (up * w.US[o] + un * lsu) + w.BU[o] * w.S[o];
        NL[r * cols + c] = vl;
        NU[r * cols + c] = vu;
        s1 = fmaf(w.UI[o], an, s1);
        s2 = fmaf(w.UI[o], up, s2);
        t1 = fmaf(Bj[r], vl, t1);
        t2 = fmaf(Bj[r], vu, t2);
      }
      w.clo[c] = (w.clo[c] + s1) + t1;
      w.cup[c] = (w.cup[c] + s2) + t2;
    }
    __syncthreads();
    const int nrows = nd.in[j];
    const float* Wj = P + nd.w[j];
    float* dl = PL + (j > 0 ? nd.n[j - 1] : nd.n[k]) * cols;
    float* du = PU + (j > 0 ? nd.n[j - 1] : nd.n[k]) * cols;
    for (int idx = tid; idx < nrows * cols; idx += nt) {  // A_{j-1} = W_j·N_j
      const int i = idx / cols, c = idx - i * cols;
      float sl = 0.f, su = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float wv = Wj[i * rows + r];
        sl = fmaf(wv, NL[r * cols + c], sl);
        su = fmaf(wv, NU[r * cols + c], su);
      }
      dl[idx] = sl;
      du[idx] = su;
    }
    __syncthreads();
  }
  const float* al = PL + nd.n[k] * cols;
  const float* au = PU + nd.n[k] * cols;
  for (int c = tid; c < cols; c += nt) {  // concretize over the box
    float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
    for (int i = 0; i < d; ++i) {
      const float a = al[i * cols + c], u = au[i * cols + c];
      s1 = fmaf(w.inlo[i], fmaxf(a, 0.f), s1);
      s2 = fmaf(w.inhi[i], fminf(a, 0.f), s2);
      s3 = fmaf(w.inhi[i], fmaxf(u, 0.f), s3);
      s4 = fmaf(w.inlo[i], fminf(u, 0.f), s4);
    }
    w.elo[c] = (s1 + s2) + w.clo[c];
    w.ehi[c] = (s3 + s4) + w.cup[c];
  }
  __syncthreads();
}

// Reverse pass of sb_eval (its matrices still in PL/PU) and the signed step
// of every α/β of the layers j < k on the width Σ hi − Σ lo.
__device__ void sb_step(const NetDesc& nd, const float* P, const SignWs& w, int k,
                        const float* PL, const float* PU, float* G0L, float* G0U,
                        float* G1L, float* G1U, float lr) {
  const int tid = threadIdx.x, nt = blockDim.x, d = nd.in[0], cols = nd.out[k];
  const float* al = PL + nd.n[k] * cols;
  const float* au = PU + nd.n[k] * cols;
  for (int idx = tid; idx < d * cols; idx += nt) {
    const int i = idx / cols;
    const float a = al[idx], u = au[idx];
    G0L[idx] = w.inlo[i] * dpos(a) + w.inhi[i] * dneg(a);
    G0U[idx] = w.inhi[i] * dpos(u) + w.inlo[i] * dneg(u);
  }
  __syncthreads();
  float *gl = G0L, *gu = G0U, *hl = G1L, *hu = G1U;
  for (int j = 0; j < k; ++j) {
    const int rows = nd.out[j], nin = nd.in[j], off = nd.n[j];
    const float* Wj = P + nd.w[j];
    const float* Bj = P + nd.b[j];
    const float* Mj = P + nd.m[j];
    for (int idx = tid; idx < rows * cols; idx += nt) {  // adjoint of N_j
      const int r = idx / cols, c = idx - r * cols;
      float a1 = 0.f, a2 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float wv = Wj[i * rows + r];
        a1 = fmaf(wv, gl[i * cols + c], a1);
        a2 = fmaf(wv, gu[i * cols + c], a2);
      }
      hl[idx] = a1 + Bj[r];
      hu[idx] = a2 + Bj[r];
    }
    __syncthreads();
    const float* pl = PL + off * cols;
    const float* pu = PU + off * cols;
    for (int r = tid; r < rows; r += nt) {  // α/β gradients, adjoint of P_j
      const int o = off + r;
      const bool unst = w.UN[o] != 0.f;
      const float m = Mj[r], us = w.US[o], ui = w.UI[o];
      const float lsl = (unst ? w.AL[o] : w.LS[o]) * m;
      const float lsu = (unst ? w.AU[o] : w.LS[o]) * m;
      float gal = 0.f, gau = 0.f, sl = 0.f, su = 0.f;
      for (int c = 0; c < cols; ++c) {
        const float a = pl[r * cols + c], u = pu[r * cols + c];
        const float g1 = hl[r * cols + c], g2 = hu[r * cols + c];
        gal = fmaf(g1, fmaxf(a, 0.f), gal);
        gau = fmaf(g2, fminf(u, 0.f), gau);
        sl += g1;
        su += g2;
        hl[r * cols + c] = (g1 * lsl) * dpos(a) + (g1 * us + ui) * dneg(a);
        hu[r * cols + c] = (g2 * us + ui) * dpos(u) + (g2 * lsu) * dneg(u);
      }
      const float gate = unst ? m : 0.f;
      const float dal = gal * gate;         // d lo / d α_low
      const float dau = gau * gate;         // d hi / d α_up
      const float dbl = (-sl) * w.S[o];     // d lo / d β_low
      const float dbu = su * w.S[o];        // d hi / d β_up
      // The width is Σ hi − Σ lo: its gradient is −dal, dau, −dbl, dbu.
      w.AL[o] = fminf(fmaxf(w.AL[o] - lr * sgnf(-dal), 0.f), 1.f);
      w.AU[o] = fminf(fmaxf(w.AU[o] - lr * sgnf(dau), 0.f), 1.f);
      w.BL[o] = fmaxf(w.BL[o] - BETA_LR * sgnf(-dbl), 0.f);
      w.BU[o] = fmaxf(w.BU[o] - BETA_LR * sgnf(dbu), 0.f);
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

__global__ void __launch_bounds__(K8A_THREADS)
k8a_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ signs, int iters,
           float* __restrict__ gws, int ws_stride, int stk, int adj,
           float* __restrict__ out_lo, float* __restrict__ out_hi,
           uint8_t* __restrict__ feasible, float* __restrict__ scores,
           int8_t* __restrict__ resolved, float* __restrict__ ab, int ab_stride) {
  extern __shared__ float smem[];
  const int d = nd.in[0], L = nd.L, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int nh = L > 1 ? nd.n[L - 1] : 0;  // hidden neurons
  float* P = smem;
  SignWs w;
  w.inlo = P + nd.total;
  w.inhi = w.inlo + d;
  float* q = w.inhi + d;
  float** mw[10] = {&w.rlo, &w.rhi, &w.zlo, &w.zhi, &w.blo, &w.bhi,
                    &w.clo, &w.cup, &w.elo, &w.ehi};
  for (int i = 0; i < 10; ++i) {
    *mw[i] = q;
    q += nd.maxw;
  }
  float** ns[11] = {&w.wslb, &w.wsub, &w.US, &w.UI, &w.LS, &w.UN, &w.S,
                    &w.AL, &w.AU, &w.BL, &w.BU};
  for (int i = 0; i < 11; ++i) {
    *ns[i] = q;
    q += nd.nsum;
  }
  w.red = q;
  w.flag = (int*)(q + 32);
  float* g = gws + (size_t)b * ws_stride;
  float* PL = g;
  float* PU = PL + stk;
  float* G0L = PU + stk;
  float* G0U = G0L + adj;
  float* G1L = G0U + adj;
  float* G1U = G1L + adj;

  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  for (int i = tid; i < d; i += nt) {
    w.inlo[i] = w.rlo[i] = lo[(size_t)b * d + i];
    w.inhi[i] = w.rhi[i] = hi[(size_t)b * d + i];
  }
  if (tid == 0) *w.flag = 0;
  __syncthreads();
  int abo = 0;
  for (int k = 0; k < L; ++k) {
    const int nin = nd.in[k], cols = nd.out[k];
    const float* Wk = P + nd.w[k];
    const float* Bk = P + nd.b[k];
    for (int j = tid; j < cols; j += nt) {  // IBP of layer k
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float wv = Wk[i * cols + j];
        const float wp = fmaxf(wv, 0.f), wn = fminf(wv, 0.f);
        a1 = fmaf(w.rlo[i], wp, a1);
        a2 = fmaf(w.rhi[i], wn, a2);
        a3 = fmaf(w.rhi[i], wp, a3);
        a4 = fmaf(w.rlo[i], wn, a4);
      }
      w.zlo[j] = (a1 + a2) + Bk[j];
      w.zhi[j] = (a3 + a4) + Bk[j];
    }
    if (k > 0) {
      for (int o = tid; o < nd.n[k]; o += nt) {
        w.AL[o] = w.AU[o] = w.wsub[o] >= -w.wslb[o] ? 1.f : 0.f;
        w.BL[o] = w.BU[o] = 0.f;
      }
      for (int c = tid; c < cols; c += nt) {
        w.blo[c] = -INFINITY;
        w.bhi[c] = INFINITY;
      }
      __syncthreads();
      float lr = 0.5f;
      for (int it = 0; it <= iters; ++it) {
        sb_eval(nd, P, w, k, PL, PU, G0L, G0U);
        for (int c = tid; c < cols; c += nt) {
          w.blo[c] = fmaxf(w.blo[c], w.elo[c]);
          w.bhi[c] = fminf(w.bhi[c], w.ehi[c]);
        }
        if (it == iters) break;
        sb_step(nd, P, w, k, PL, PU, G0L, G0U, G1L, G1U, lr);
        lr = lr * 0.7f;
      }
      __syncthreads();
      if (ab != nullptr && iters > 0) {  // the final α/β of layer k's pass
        float* dst = ab + (size_t)b * ab_stride + abo;
        const int n = nd.n[k];
        for (int o = tid; o < n; o += nt) {
          dst[o] = w.AL[o];
          dst[n + o] = w.AU[o];
          dst[2 * n + o] = w.BL[o];
          dst[3 * n + o] = w.BU[o];
        }
        abo += 4 * n;
      }
      for (int c = tid; c < cols; c += nt) {
        w.zlo[c] = fmaxf(w.zlo[c], w.blo[c]);
        w.zhi[c] = fminf(w.zhi[c], w.bhi[c]);
      }
    }
    __syncthreads();
    const float* Mk = P + nd.m[k];
    for (int j = tid; j < cols; j += nt) {  // widen, clamp, record
      const float slack = SLACK_REL * fmaxf(fabsf(w.zlo[j]), fabsf(w.zhi[j])) + SLACK_ABS;
      float zl = w.zlo[j] - slack, zh = w.zhi[j] + slack;
      const int o = nd.n[k] + j;
      if (k < L - 1) {
        const float s = signs[(size_t)b * nh + o];
        const float m = Mk[j];
        if (s > 0.f) zl = fmaxf(zl, 0.f);
        if (s < 0.f) zh = fminf(zh, 0.f);
        if (zl > zh) atomicOr(w.flag, 1);
        zh = fmaxf(zh, zl);  // an empty interval collapses to a point
        const bool unst = zl < 0.f && zh > 0.f;
        const float den = unst ? zh - zl : 1.f;
        scores[(size_t)b * nh + o] = (unst ? zh * (-zl) / den : 0.f) * m;
        const int rs = zl >= 0.f ? 1 : (zh <= 0.f ? -1 : 0);
        resolved[(size_t)b * nh + o] = (int8_t)(m > 0.5f ? rs : 0);
        w.S[o] = s * m;
        const Relax x = relax(zl, zh, m);
        w.US[o] = x.us;
        w.UI[o] = x.ui;
        w.LS[o] = x.ls;
        w.UN[o] = x.unst ? 1.f : 0.f;
        w.rlo[j] = fmaxf(zl, 0.f) * m;
        w.rhi[j] = fmaxf(zh, 0.f) * m;
      }
      w.wslb[o] = zl;
      w.wsub[o] = zh;
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_lo[b] = w.wslb[nd.n[L - 1]];
    out_hi[b] = w.wsub[nd.n[L - 1]];
    feasible[b] = *w.flag ? 0 : 1;
  }
}

extern "C" int k8a_sign_bound(const void* params, const int* dims, int L, const void* lo,
                              const void* hi, const void* signs, int B, int iters,
                              void* ws, int ws_stride, void* out_lo, void* out_hi,
                              void* feasible, void* scores, void* resolved, void* ab,
                              void* stream) {
  const NetDesc nd = make_desc(dims, L);
  int stk, adj;
  sign_ws_global(nd, stk, adj);
  if (ws_stride < 2 * (stk + 2 * adj) || iters < 0) return (int)cudaErrorInvalidValue;
  int ab_stride = 0;
  for (int k = 1; k < L; ++k) ab_stride += 4 * nd.n[k];
  const size_t smem = sizeof(float) * sign_ws_shared(nd);
  cudaError_t err = set_smem(k8a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    k8a_kernel<<<B, K8A_THREADS, smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)lo, (const float*)hi,
        (const float*)signs, iters, (float*)ws, ws_stride, stk, adj, (float*)out_lo,
        (float*)out_hi, (uint8_t*)feasible, (float*)scores, (int8_t*)resolved,
        (float*)ab, ab_stride);
  return (int)cudaGetLastError();
}
