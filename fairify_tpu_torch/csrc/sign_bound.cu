// K8a — β-CROWN output bounds under per-neuron sign splits, one box per block,
// a warp per backward-pass column pair.
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
// Layer k's backward pass is n_k independent columns, for both forms.  A
// warp carries a column pair from W_k down to the input with __syncwarp
// only: per step j it relaxes the columns' vectors (the α/β slopes and the
// split penalty ∓β·s), sums the constant terms and multiplies by W_j.  It
// keeps its columns' pre-relaxation vectors P_j (out_j floats per column
// and form, the input level d) for the gradient.  The gradient is a
// hand-written reverse pass on the same warp: from the concretization,
// d lo/d A_in = lb·dpos(A) + ub·dneg(A), it carries the columns' adjoints
// up through each step (through A_{j-1} = W_j·N_j and the constants
// c += b_j·N_j + ui·min/max(P_j, 0)) and keeps each step's adjoint H_j of
// N_j.  JAX's tie rules hold: max(a, 0) and min(a, 0) pass half the
// gradient at a = 0, sign(0) = 0, and a stable or masked neuron's α gets
// none.  The α/β gradients of a unit of layer j are sums over the columns:
// d lo/d α_low = Σ_c H·max(P, 0), d hi/d α_up = Σ_c H·min(P, 0),
// d lo/d β_low = −s·Σ_c H, d hi/d β_up = s·Σ_c H.  They are taken after the
// pass, by one fixed-order reduction over the columns, and every layer's
// α/β is stepped after it: no step of a reverse pass reads an α/β that an
// earlier step of the same pass updated, so every gradient is that of the
// current iterate, as in JAX.
//
// Sums: every sum is the index-ordered fmaf chain of the block-per-box
// version this replaces — the IBP sums, each column's constant terms (one
// lane per chain), its products with W_j (a lane per output row) and its
// concretization (one lane per chain), the adjoints' products (a lane per
// row), and the gradient sums over the columns in column order.  Where
// W_j has at most 30 rows (the input step at AC-S1), the constant terms
// ride on two more rows of the product's loop instead of a loop of their
// own, and at most 14 rows take a lane per row and column.  The columns go in groups of two per warp; the gradient sums carry
// on from one group to the next.
//
// Bound on the H100: fp32 FMA throughput — per box, per layer k >= 1 and
// per evaluation, two forms of sum_{j<k} in_j * n_j * n_k MACs forward and
// as many in the reverse pass (~1.4 M per evaluation at AC-S1 widths,
// alpha_iters + 1 evaluations); the bytes (box, signs in; bounds, scores
// and resolved signs out) are small.
//
// Design: the net (rows at an odd stride, cuda_build.pack_odd) is staged
// once per block by one bulk copy; the layer bounds, relaxations, α/β and
// the gradient sums are per neuron; each warp's workspace is its column
// pair's vectors, 6-10 KB at AC-S1, carved per layer for the warps that
// have a pair there.  Nothing of the pass touches global
// memory.  The block barriers are the ones between a group's reverse
// passes and its reduction, and the step.  The launch geometry (warps per
// block) comes from the wrapper (engine.sign_bound_geometry) and the entry
// point refuses any other shared-memory size.  The grid covers the batch's
// live rows only; a second small kernel copies the last live row's outputs
// to the padded rows after it (engine._pad repeats that row's inputs).
// Every product is a true-f32 FMA (no tensor cores, so no TF32).
#include "common.cuh"
#include "crown_warp.cuh"
#include "warp_tile.cuh"

#define K8A_MAX_WARPS 16
#define BETA_LR 0.8f

// A warp's workspace at layer k >= 1: a column pair's relaxed vectors or
// adjoints (float2, both forms: 4 maxw), its pre-relaxation vectors
// (4 (n_k + d)) and its adjoints of N_j (4 n_k).
__host__ __device__ inline int sb_wws(const NetDesc& nd, int k) {
  return cw_round4(4 * nd.maxw + 8 * nd.n[k] + 4 * nd.in[0]);
}

// Float offsets of one block's shared memory after the mbarrier's 4: the
// net, the box, six per-layer vectors, eleven per-neuron vectors, the four
// gradient sums, the flag, then the warps' workspaces, carved anew for each
// layer k: as many as the warps that have a column pair there, the most any
// layer needs (engine.sign_bound_smem is the same sum).
struct SbLayout {
  int net, box, lay, neu, acc, flag, warps, total;
};

__host__ __device__ inline SbLayout sb_layout(const NetDesc& nd, int warps) {
  SbLayout o;
  const int d = nd.in[0];
  o.net = 4;
  o.box = o.net + cw_round4(nd.total);
  o.lay = o.box + cw_round4(2 * d);
  o.neu = o.lay + cw_round4(6 * nd.maxw);
  o.acc = o.neu + cw_round4(11 * nd.nsum);
  o.flag = o.acc + cw_round4(4 * nd.nsum);
  o.warps = o.flag + 4;
  int ws = 0;
  for (int k = 1; k < nd.L; ++k) {
    const int busy = min(warps, (nd.out[k] + 1) / 2);
    ws = ws > busy * sb_wws(nd, k) ? ws : busy * sb_wws(nd, k);
  }
  o.total = o.warps + ws;
  return o;
}

struct Sb {
  const float* P;
  float *inlo, *inhi;                              // d each: the box
  float *rlo, *rhi, *zlo, *zhi, *blo, *bhi;        // maxw each
  float *wslb, *wsub, *US, *UI, *LS, *UN, *S;      // nsum each, by layer
  float *AL, *AU, *BL, *BU;                        // nsum each: α, β
  float *GAL, *GAU, *GSL, *GSU;                    // nsum each: gradient sums
  int* flag;
  float* warps;
};

// A warp's workspace at layer k: the scratch x (the relaxed vectors in the
// forward pass, the adjoint in the reverse pass), the pre-relaxation
// vectors p (P_j at offset n[j], the input level at n[k]) and the adjoints
// h of N_j (offset n[j]); float2 = the pair's two columns, l/u the forms.
struct ColWs {
  float2 *xl, *xu, *pl, *pu, *hl, *hu;
};

__device__ __forceinline__ ColWs col_ws(const Sb& s, int warp, const NetDesc& nd, int k) {
  ColWs c;
  const int nk = nd.n[k], d = nd.in[0];
  c.xl = reinterpret_cast<float2*>(s.warps + warp * sb_wws(nd, k));
  c.xu = c.xl + nd.maxw;
  c.pl = c.xu + nd.maxw;
  c.pu = c.pl + nk + d;
  c.hl = c.pu + nk + d;
  c.hu = c.hl + nk;
  return c;
}

// Relaxed coefficient of one column: lower form (slope lsl on a > 0, the
// upper slope on a < 0, minus the split penalty), upper form.
__device__ __forceinline__ float relax_lo(float a, float lsl, float us, float bl, float s) {
  const float ap = fmaxf(a, 0.f), an = fminf(a, 0.f);
  return (ap * lsl + an * us) - bl * s;
}
__device__ __forceinline__ float relax_up(float u, float lsu, float us, float bu, float s) {
  const float up = fmaxf(u, 0.f), un = fminf(u, 0.f);
  return (up * us + un * lsu) + bu * s;
}

// The adjoint of P_j from the adjoint g of N_j (lower form, upper form).
__device__ __forceinline__ float adj_lo(float g, float a, float lsl, float us, float ui) {
  return (g * lsl) * dpos(a) + (g * us + ui) * dneg(a);
}
__device__ __forceinline__ float adj_up(float g, float u, float lsu, float us, float ui) {
  return (g * us + ui) * dpos(u) + (g * lsu) * dneg(u);
}

// One evaluation of columns c0 and c0 + 1 (nc of them; with nc == 1 the
// second is a copy of the first and is not recorded) of layer k's two
// forms with the current α/β: their pre-relaxation vectors land in c.pl /
// c.pu, their bounds tighten s.blo / s.bhi.
__device__ void sb_forward(const NetDesc& nd, const Sb& s, const ColWs& c, int k, int c0,
                           int nc) {
  const int lane = threadIdx.x & 31, d = nd.in[0];
  const int c1 = nc > 1 ? c0 + 1 : c0;
  const float* P = s.P;
  {
    const float* Wk = P + nd.w[k];
    const int ld = nd.ldw[k], off = nd.n[k - 1];
    for (int r = lane; r < nd.in[k]; r += 32) {
      const float2 v = make_float2(Wk[r * ld + c0], Wk[r * ld + c1]);
      c.pl[off + r] = v;
      c.pu[off + r] = v;
    }
  }
  float clo0 = P[nd.b[k] + c0], clo1 = P[nd.b[k] + c1];
  float cup0 = clo0, cup1 = clo1;
  __syncwarp();
  for (int j = k - 1; j >= 0; --j) {
    const int rows = nd.out[j], off = nd.n[j];
    const float* Mj = P + nd.m[j];
    const float* Bj = P + nd.b[j];
    for (int r = lane; r < rows; r += 32) {  // relaxation, β shift
      const int o = off + r;
      const float2 a = c.pl[o], u = c.pu[o];
      const bool unst = s.UN[o] != 0.f;
      const float lsl = (unst ? s.AL[o] : s.LS[o]) * Mj[r];
      const float lsu = (unst ? s.AU[o] : s.LS[o]) * Mj[r];
      const float us = s.US[o], bl = s.BL[o], bu = s.BU[o], sg = s.S[o];
      c.xl[r] = make_float2(relax_lo(a.x, lsl, us, bl, sg), relax_lo(a.y, lsl, us, bl, sg));
      c.xu[r] = make_float2(relax_up(u.x, lsu, us, bu, sg), relax_up(u.y, lsu, us, bu, sg));
    }
    __syncwarp();
    const int nin = nd.in[j], dst = j > 0 ? nd.n[j - 1] : nd.n[k];
    float cs[8];  // s (ui min(a, 0) / ui max(u, 0)) and t (b relaxed): lo0 lo1 up0 up1
    if (nin + 2 <= 32) {
      // W_j's rows i < nin (A_{j-1} = W_j·N_j, the input level at n[k]),
      // row nin b_j·N_j (t) and row nin + 1 ui·min(a, 0) / ui·max(u, 0)
      // (s, from the clamped copies in c.hl / c.hu), each the
      // index-ordered fmaf chain: a lane per row and column where 2 (nin +
      // 2) <= 32 (the input step at AC-S1), else a lane per row.
      for (int r = lane; r < rows; r += 32) {
        const float2 a = c.pl[off + r], u = c.pu[off + r];
        c.hl[r] = make_float2(fminf(a.x, 0.f), fminf(a.y, 0.f));
        c.hu[r] = make_float2(fmaxf(u.x, 0.f), fmaxf(u.y, 0.f));
      }
      __syncwarp();
      const bool split = 2 * (nin + 2) <= 32;
      const int row = split ? lane >> 1 : lane, col = split ? lane & 1 : 0;
      const float* cf = row < nin ? P + nd.w[j] + row * nd.ldw[j]
                                  : (row == nin ? Bj : s.UI + off);
      const float2* vl = row == nin + 1 ? c.hl : c.xl;
      const float2* vu = row == nin + 1 ? c.hu : c.xu;
      float a0 = 0.f, a1 = 0.f, u0 = 0.f, u1 = 0.f;
      if (split && row < nin + 2) {
        const float* fl = reinterpret_cast<const float*>(vl) + col;
        const float* fu = reinterpret_cast<const float*>(vu) + col;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const float wv = cf[r];
          a0 = fmaf(wv, fl[2 * r], a0);
          u0 = fmaf(wv, fu[2 * r], u0);
        }
        if (row < nin) {
          reinterpret_cast<float*>(c.pl + dst + row)[col] = a0;
          reinterpret_cast<float*>(c.pu + dst + row)[col] = u0;
        }
      } else if (!split && row < nin + 2) {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const float wv = cf[r];
          const float2 rl = vl[r], ru = vu[r];
          a0 = fmaf(wv, rl.x, a0);
          a1 = fmaf(wv, rl.y, a1);
          u0 = fmaf(wv, ru.x, u0);
          u1 = fmaf(wv, ru.y, u1);
        }
        if (row < nin) {
          c.pl[dst + row] = make_float2(a0, a1);
          c.pu[dst + row] = make_float2(u0, u1);
        }
      }
      if (split) {  // both columns' sums on the even lane: a1/u1 column 1
        a1 = __shfl_down_sync(CW_FULL, a0, 1);
        u1 = __shfl_down_sync(CW_FULL, u0, 1);
      }
      const float sv[4] = {a0, a1, u0, u1};
      const int ls = split ? 2 * (nin + 1) : nin + 1, lt = split ? 2 * nin : nin;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cs[q] = __shfl_sync(CW_FULL, sv[q], ls);
        cs[4 + q] = __shfl_sync(CW_FULL, sv[q], lt);
      }
    } else {
      // The constant terms, one index-ordered chain a lane: lanes 0-3 sum
      // ui min(a, 0) (lower) / ui max(u, 0) (upper), lanes 4-7 b relaxed;
      // lane bit 0 the column, bit 1 the form.  Then A_{j-1} = W_j·N_j, a
      // lane per row, index order.
      float acc = 0.f;
      if (lane < 8) {
        const int col = lane & 1, up = (lane >> 1) & 1;
        const bool cst = lane < 4;
        const float2* v2 = cst ? (up ? c.pu + off : c.pl + off) : (up ? c.xu : c.xl);
        const float* v = reinterpret_cast<const float*>(v2) + col;
        const float* cf = cst ? s.UI + off : Bj;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          float x = v[2 * r];
          if (cst) x = up ? fmaxf(x, 0.f) : fminf(x, 0.f);
          acc = fmaf(cf[r], x, acc);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) cs[q] = __shfl_sync(CW_FULL, acc, q);
      rows_dot2(P + nd.w[j], nd.ldw[j], nin, c.xl, c.xu, rows, c.pl + dst, c.pu + dst,
                /*split=*/false);
    }
    clo0 = (clo0 + cs[0]) + cs[4];
    clo1 = (clo1 + cs[1]) + cs[5];
    cup0 = (cup0 + cs[2]) + cs[6];
    cup1 = (cup1 + cs[3]) + cs[7];
    __syncwarp();
  }
  // Concretize over the box, one chain a lane: lane bit 0 the column, bits
  // 1-2 the term (inlo max(a, 0), inhi min(a, 0), inhi max(u, 0), inlo
  // min(u, 0)).
  float acc = 0.f;
  if (lane < 8) {
    const int col = lane & 1, q = lane >> 1;
    const float* v = reinterpret_cast<const float*>(q < 2 ? c.pl + nd.n[k] : c.pu + nd.n[k])
                     + col;
    const float* bx = (q == 0 || q == 3) ? s.inlo : s.inhi;
    const bool pos = q == 0 || q == 2;
    for (int i = 0; i < d; ++i) {
      const float x = v[2 * i];
      acc = fmaf(bx[i], pos ? fmaxf(x, 0.f) : fminf(x, 0.f), acc);
    }
  }
  const float a1 = __shfl_sync(CW_FULL, acc, lane & 1);
  const float a2 = __shfl_sync(CW_FULL, acc, 2 + (lane & 1));
  const float a3 = __shfl_sync(CW_FULL, acc, 4 + (lane & 1));
  const float a4 = __shfl_sync(CW_FULL, acc, 6 + (lane & 1));
  if (lane < nc) {
    const int cc = c0 + lane;
    const float elo = (a1 + a2) + (lane ? clo1 : clo0);
    const float ehi = (a3 + a4) + (lane ? cup1 : cup0);
    s.blo[cc] = fmaxf(s.blo[cc], elo);
    s.bhi[cc] = fminf(s.bhi[cc], ehi);
  }
  __syncwarp();
}

// Reverse pass of sb_forward (its vectors still in c.pl / c.pu): the
// adjoints of N_j of the pair's two forms into c.hl / c.hu, for the
// reduction over the columns.
__device__ void sb_reverse(const NetDesc& nd, const Sb& s, const ColWs& c, int k) {
  const int lane = threadIdx.x & 31, d = nd.in[0];
  const float* P = s.P;
  float2* gl = c.xl;
  float2* gu = c.xu;
  for (int i = lane; i < d; i += 32) {
    const float2 a = c.pl[nd.n[k] + i], u = c.pu[nd.n[k] + i];
    const float lo = s.inlo[i], hi = s.inhi[i];
    gl[i] = make_float2(lo * dpos(a.x) + hi * dneg(a.x), lo * dpos(a.y) + hi * dneg(a.y));
    gu[i] = make_float2(hi * dpos(u.x) + lo * dneg(u.x), hi * dpos(u.y) + lo * dneg(u.y));
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    const int rows = nd.out[j], nin = nd.in[j], off = nd.n[j], ld = nd.ldw[j];
    const float* Wj = P + nd.w[j];
    const float* Bj = P + nd.b[j];
    const float* Mj = P + nd.m[j];
    // H[r] = sum_i W_j[i, r] g[i] + b_j[r]: a lane per row r, index order.
    for (int r0 = 0; r0 < rows; r0 += 128) {
      const int nr = min(rows - r0, 128);
      const float* wc[4];
      float h[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wc[m] = Wj + min(r0 + lane + 32 * m, rows - 1);
        h[m][0] = h[m][1] = h[m][2] = h[m][3] = 0.f;
      }
#pragma unroll 2
      for (int i = 0; i < nin; ++i) {
        const float2 g1 = gl[i], g2 = gu[i];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (32 * m < nr) {
            const float wv = wc[m][i * ld];
            h[m][0] = fmaf(wv, g1.x, h[m][0]);
            h[m][1] = fmaf(wv, g1.y, h[m][1]);
            h[m][2] = fmaf(wv, g2.x, h[m][2]);
            h[m][3] = fmaf(wv, g2.y, h[m][3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = r0 + lane + 32 * m;
        if (32 * m < nr && r < rows) {
          const float b = Bj[r];
          c.hl[off + r] = make_float2(h[m][0] + b, h[m][1] + b);
          c.hu[off + r] = make_float2(h[m][2] + b, h[m][3] + b);
        }
      }
    }
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {  // the adjoint of P_j
      const int o = off + r;
      const float2 g1 = c.hl[o], g2 = c.hu[o], a = c.pl[o], u = c.pu[o];
      const bool unst = s.UN[o] != 0.f;
      const float m = Mj[r], us = s.US[o], ui = s.UI[o];
      const float lsl = (unst ? s.AL[o] : s.LS[o]) * m;
      const float lsu = (unst ? s.AU[o] : s.LS[o]) * m;
      gl[r] = make_float2(adj_lo(g1.x, a.x, lsl, us, ui), adj_lo(g1.y, a.y, lsl, us, ui));
      gu[r] = make_float2(adj_up(g2.x, u.x, lsu, us, ui), adj_up(g2.y, u.y, lsu, us, ui));
    }
    __syncwarp();
  }
}

// The gradient sums of every unit of the layers j < k, carried on over
// columns c_first .. c_first + ncol - 1 in column order (column c_first +
// q lies in warp q / 2, slot q % 2).
__device__ void sb_reduce(const NetDesc& nd, const Sb& s, int k, int ncol) {
  for (int o = threadIdx.x; o < nd.n[k]; o += blockDim.x) {
    float gal = s.GAL[o], gau = s.GAU[o], sl = s.GSL[o], su = s.GSU[o];
    for (int q = 0; q < ncol; ++q) {
      const ColWs c = col_ws(s, q >> 1, nd, k);
      const int col = q & 1;
      const float g1 = reinterpret_cast<const float*>(c.hl + o)[col];
      const float g2 = reinterpret_cast<const float*>(c.hu + o)[col];
      const float a = reinterpret_cast<const float*>(c.pl + o)[col];
      const float u = reinterpret_cast<const float*>(c.pu + o)[col];
      gal = fmaf(g1, fmaxf(a, 0.f), gal);
      gau = fmaf(g2, fminf(u, 0.f), gau);
      sl += g1;
      su += g2;
    }
    s.GAL[o] = gal;
    s.GAU[o] = gau;
    s.GSL[o] = sl;
    s.GSU[o] = su;
  }
}

// The signed step of every α/β of the layers j < k on the width Σ hi − Σ lo,
// from the gradient sums, which it clears.
__device__ void sb_step(const NetDesc& nd, const Sb& s, int k, float lr) {
  for (int o = threadIdx.x; o < nd.n[k]; o += blockDim.x) {
    int j = 0;
    while (o >= nd.n[j + 1]) ++j;
    const float m = s.P[nd.m[j] + o - nd.n[j]];
    const bool unst = s.UN[o] != 0.f;
    const float gate = unst ? m : 0.f;
    const float dal = s.GAL[o] * gate;    // d lo / d α_low
    const float dau = s.GAU[o] * gate;    // d hi / d α_up
    const float dbl = (-s.GSL[o]) * s.S[o];  // d lo / d β_low
    const float dbu = s.GSU[o] * s.S[o];     // d hi / d β_up
    // The width is Σ hi − Σ lo: its gradient is −dal, dau, −dbl, dbu.
    s.AL[o] = fminf(fmaxf(s.AL[o] - lr * sgnf(-dal), 0.f), 1.f);
    s.AU[o] = fminf(fmaxf(s.AU[o] - lr * sgnf(dau), 0.f), 1.f);
    s.BL[o] = fmaxf(s.BL[o] - BETA_LR * sgnf(-dbl), 0.f);
    s.BU[o] = fmaxf(s.BU[o] - BETA_LR * sgnf(dbu), 0.f);
    s.GAL[o] = s.GAU[o] = s.GSL[o] = s.GSU[o] = 0.f;
  }
}

__global__ void __launch_bounds__(K8A_MAX_WARPS * 32)
k8a_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ lo,
           const float* __restrict__ hi, const float* __restrict__ signs, int iters,
           float* __restrict__ out_lo, float* __restrict__ out_hi,
           uint8_t* __restrict__ feasible, float* __restrict__ scores,
           int8_t* __restrict__ resolved, float* __restrict__ ab, int ab_stride) {
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], L = nd.L, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  const int nh = L > 1 ? nd.n[L - 1] : 0;  // hidden neurons
  const SbLayout lay = sb_layout(nd, nw);
  Sb s;
  s.P = smem + lay.net;
  s.inlo = smem + lay.box;
  s.inhi = s.inlo + d;
  float* q = smem + lay.lay;
  float** mw[6] = {&s.rlo, &s.rhi, &s.zlo, &s.zhi, &s.blo, &s.bhi};
  for (int i = 0; i < 6; ++i) {
    *mw[i] = q;
    q += nd.maxw;
  }
  q = smem + lay.neu;
  float** ns[11] = {&s.wslb, &s.wsub, &s.US, &s.UI, &s.LS, &s.UN, &s.S,
                    &s.AL, &s.AU, &s.BL, &s.BU};
  for (int i = 0; i < 11; ++i) {
    *ns[i] = q;
    q += nd.nsum;
  }
  q = smem + lay.acc;
  float** gs[4] = {&s.GAL, &s.GAU, &s.GSL, &s.GSU};
  for (int i = 0; i < 4; ++i) {
    *gs[i] = q;
    q += nd.nsum;
  }
  s.flag = reinterpret_cast<int*>(smem + lay.flag);
  s.warps = smem + lay.warps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);

  stage_net(smem + lay.net, params, cw_round4(nd.total), bar);
  for (int i = tid; i < d; i += nt) {
    s.inlo[i] = s.rlo[i] = lo[(size_t)b * d + i];
    s.inhi[i] = s.rhi[i] = hi[(size_t)b * d + i];
  }
  for (int o = tid; o < nd.nsum; o += nt) s.GAL[o] = s.GAU[o] = s.GSL[o] = s.GSU[o] = 0.f;
  if (tid == 0) *s.flag = 0;
  mbar_wait(bar, 0);
  __syncthreads();
  const float* P = s.P;
  int abo = 0;
  for (int k = 0; k < L; ++k) {
    const int nin = nd.in[k], cols = nd.out[k], ld = nd.ldw[k];
    const float* Wk = P + nd.w[k];
    const float* Bk = P + nd.b[k];
    for (int j = tid; j < cols; j += nt) {  // IBP of layer k
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float wv = Wk[i * ld + j];
        const float wp = fmaxf(wv, 0.f), wn = fminf(wv, 0.f);
        a1 = fmaf(s.rlo[i], wp, a1);
        a2 = fmaf(s.rhi[i], wn, a2);
        a3 = fmaf(s.rhi[i], wp, a3);
        a4 = fmaf(s.rlo[i], wn, a4);
      }
      s.zlo[j] = (a1 + a2) + Bk[j];
      s.zhi[j] = (a3 + a4) + Bk[j];
    }
    if (k > 0) {
      for (int o = tid; o < nd.n[k]; o += nt) {
        s.AL[o] = s.AU[o] = s.wsub[o] >= -s.wslb[o] ? 1.f : 0.f;
        s.BL[o] = s.BU[o] = 0.f;
      }
      for (int c = tid; c < cols; c += nt) {
        s.blo[c] = -INFINITY;
        s.bhi[c] = INFINITY;
      }
      __syncthreads();
      const int npair = (cols + 1) / 2;
      float lr = 0.5f;
      for (int it = 0; it <= iters; ++it) {
        const bool last = it == iters;
        for (int p0 = 0; p0 < npair; p0 += nw) {  // column groups of 2 nw
          const int p = p0 + warp;
          if (p < npair) {
            const ColWs c = col_ws(s, warp, nd, k);
            sb_forward(nd, s, c, k, 2 * p, min(2, cols - 2 * p));
            if (!last) sb_reverse(nd, s, c, k);
          }
          if (!last) {
            __syncthreads();
            sb_reduce(nd, s, k, min(cols, 2 * (p0 + nw)) - 2 * p0);
            __syncthreads();
          }
        }
        if (last) break;
        sb_step(nd, s, k, lr);
        __syncthreads();
        lr = lr * 0.7f;
      }
      __syncthreads();
      if (ab != nullptr && iters > 0) {  // the final α/β of layer k's pass
        float* dst = ab + (size_t)b * ab_stride + abo;
        const int n = nd.n[k];
        for (int o = tid; o < n; o += nt) {
          dst[o] = s.AL[o];
          dst[n + o] = s.AU[o];
          dst[2 * n + o] = s.BL[o];
          dst[3 * n + o] = s.BU[o];
        }
        abo += 4 * n;
      }
      for (int c = tid; c < cols; c += nt) {
        s.zlo[c] = fmaxf(s.zlo[c], s.blo[c]);
        s.zhi[c] = fminf(s.zhi[c], s.bhi[c]);
      }
    }
    __syncthreads();
    const float* Mk = P + nd.m[k];
    for (int j = tid; j < cols; j += nt) {  // widen, clamp, record
      const float slack = SLACK_REL * fmaxf(fabsf(s.zlo[j]), fabsf(s.zhi[j])) + SLACK_ABS;
      float zl = s.zlo[j] - slack, zh = s.zhi[j] + slack;
      const int o = nd.n[k] + j;
      if (k < L - 1) {
        const float sg = signs[(size_t)b * nh + o];
        const float m = Mk[j];
        if (sg > 0.f) zl = fmaxf(zl, 0.f);
        if (sg < 0.f) zh = fminf(zh, 0.f);
        if (zl > zh) atomicOr(s.flag, 1);
        zh = fmaxf(zh, zl);  // an empty interval collapses to a point
        const bool unst = zl < 0.f && zh > 0.f;
        const float den = unst ? zh - zl : 1.f;
        scores[(size_t)b * nh + o] = (unst ? zh * (-zl) / den : 0.f) * m;
        const int rs = zl >= 0.f ? 1 : (zh <= 0.f ? -1 : 0);
        resolved[(size_t)b * nh + o] = (int8_t)(m > 0.5f ? rs : 0);
        s.S[o] = sg * m;
        const Relax x = relax(zl, zh, m);
        s.US[o] = x.us;
        s.UI[o] = x.ui;
        s.LS[o] = x.ls;
        s.UN[o] = x.unst ? 1.f : 0.f;
        s.rlo[j] = fmaxf(zl, 0.f) * m;
        s.rhi[j] = fmaxf(zh, 0.f) * m;
      }
      s.wslb[o] = zl;
      s.wsub[o] = zh;
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_lo[b] = s.wslb[nd.n[L - 1]];
    out_hi[b] = s.wsub[nd.n[L - 1]];
    feasible[b] = *s.flag ? 0 : 1;
  }
}

// The padded rows live .. B - 1 (one block each) take row live - 1's
// outputs (engine._pad repeats its inputs there).
__global__ void k8a_fill(int live, int nh, float* __restrict__ out_lo,
                         float* __restrict__ out_hi, uint8_t* __restrict__ feasible,
                         float* __restrict__ scores, int8_t* __restrict__ resolved,
                         float* __restrict__ ab, int ab_stride) {
  const size_t src = live - 1, r = live + blockIdx.x;
  if (threadIdx.x == 0) {
    out_lo[r] = out_lo[src];
    out_hi[r] = out_hi[src];
    feasible[r] = feasible[src];
  }
  for (int o = threadIdx.x; o < nh; o += blockDim.x) {
    scores[r * nh + o] = scores[src * nh + o];
    resolved[r * nh + o] = resolved[src * nh + o];
  }
  if (ab != nullptr)
    for (int o = threadIdx.x; o < ab_stride; o += blockDim.x)
      ab[r * ab_stride + o] = ab[src * ab_stride + o];
}

// Dynamic shared memory of one block (engine.sign_bound_smem).
static inline long long k8a_smem(const NetDesc& nd, int warps) {
  return 4LL * sb_layout(nd, warps).total;
}

// The launch geometry comes from the wrapper (engine.sign_bound_geometry:
// warps per block, shared-memory bytes) and is checked here against the
// net and the kernel's limits.  params is cuda_build.pack_odd's buffer,
// padded to 16 bytes.  Blocks: the live rows, of B.
extern "C" int k8a_sign_bound(const void* params, const int* dims, int L, const void* lo,
                              const void* hi, const void* signs, int B, int live, int iters,
                              void* out_lo, void* out_hi, void* feasible, void* scores,
                              void* resolved, void* ab, int warps, long long smem,
                              void* stream) {
  const NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
  if (iters < 0 || warps < 1 || warps > K8A_MAX_WARPS || smem != k8a_smem(nd, warps) ||
      smem > SMEM_LIMIT || nd.out[L - 1] != 1 || live < 0 || live > B || (B > 0 && live < 1))
    return (int)cudaErrorInvalidValue;
  int ab_stride = 0;
  for (int k = 1; k < L; ++k) ab_stride += 4 * nd.n[k];
  cudaError_t err = set_smem(k8a_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0)
    k8a_kernel<<<live, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)lo, (const float*)hi, (const float*)signs,
        iters, (float*)out_lo, (float*)out_hi, (uint8_t*)feasible, (float*)scores,
        (int8_t*)resolved, (float*)ab, ab_stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nh = L > 1 ? nd.n[L - 1] : 0;
  if (live < B)
    k8a_fill<<<B - live, 128, 0, (cudaStream_t)stream>>>(
        live, nh, (float*)out_lo, (float*)out_hi, (uint8_t*)feasible, (float*)scores,
        (int8_t*)resolved, iters > 0 ? (float*)ab : nullptr, ab_stride);
  return (int)cudaGetLastError();
}
