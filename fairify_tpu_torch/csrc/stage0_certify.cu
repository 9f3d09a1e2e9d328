// KB — stage-0 certificate: CROWN role bounds + tied pair-difference kills.
//
// Replaces the _certify_impl half of fairify_tpu/verify/sweep.py:
// _mega_stage0_kernel (fairify_tpu/verify/engine.py:_certify_impl at
// alpha_iters=0, with ops/crown.py:crown_output_form_sets and
// engine._tied_diff_ub).  Per partition box and for each of the V
// protected-attribute assignments of both roles (x, x'):
//   * IBP for layer 0, then for every deeper layer a CROWN backward pass
//     (triangle ReLU relaxation, adaptive lower slope) concretized over the
//     role box, intersected with IBP and widened outward;
//   * the output-logit linear forms (A_low, c_low, A_up, c_up) of the last
//     backward pass.
// Then, per assignment pair (a, b) and flip direction, the tied difference
// bound max over shared coordinates of (pos form - neg form), widened with
// its own magnitude before the min over form sets, the role deadness tests,
// and the per-box certificate and certified margin.
//
// Bound on the H100: fp32 FMA throughput of the backward passes —
// sum over layers k >= 1, over j < k, of in_j * out_j * out_k MACs per role
// box (~0.8 M at AC-S1 widths, 64,000 role boxes on the adult grid); the
// bytes (role boxes in, two values per box out) are small.
//
// Design: one block per partition box; the packed network, the current
// role box's layer bounds and the backward pass's coefficient matrices
// (A_low/A_up ping-pong) live in dynamic shared memory.  Every product is a
// true-f32 FMA loop (no tensor cores, so no TF32).  The pair stage reads
// the 2V stored forms, one thread per pair, and reduces the certificate
// (any possible flip) and the margin (min) across the block.
#include "common.cuh"

#define KB_THREADS 256
#define KB_FORM 10  // per-form scalars after the two d-vectors

// Largest backward-pass coefficient matrix: layer k's pass starts from
// W_k (in_k x out_k) and shrinks its row count to in_j at step j.
static int max_a(const NetDesc& nd) {
  int best = 1;
  for (int k = 1; k < nd.L; ++k) {
    int rows = 0;
    for (int j = 0; j <= k; ++j) rows = rows > nd.in[j] ? rows : nd.in[j];
    if (rows * nd.out[k] > best) best = rows * nd.out[k];
  }
  return best;
}

__global__ void __launch_bounds__(KB_THREADS)
kb_kernel(NetDesc nd, int maxA, const float* __restrict__ params,
          const float* __restrict__ xlo, const float* __restrict__ xhi,
          const float* __restrict__ plo, const float* __restrict__ phi,
          const float* __restrict__ blo_g, const float* __restrict__ bhi_g,
          const float* __restrict__ assign, const float* __restrict__ pam,
          const float* __restrict__ ram, float eps,
          const uint8_t* __restrict__ valid, const uint8_t* __restrict__ vpair,
          int V, uint8_t* __restrict__ cert, float* __restrict__ margin) {
  extern __shared__ float smem[];
  const int d = nd.in[0], L = nd.L, FS = 2 * d + KB_FORM;
  float* P = smem;
  float* wslb = P + nd.total;
  float* wsub = wslb + nd.nsum;
  float* rlo = wsub + nd.nsum;
  float* rhi = rlo + nd.maxw;
  float* zlo = rhi + nd.maxw;
  float* zhi = zlo + nd.maxw;
  float* US = zhi + nd.maxw;
  float* UI = US + nd.maxw;
  float* LS = UI + nd.maxw;
  float* clo = LS + nd.maxw;
  float* cup = clo + nd.maxw;
  float* inlo = cup + nd.maxw;
  float* inhi = inlo + d;
  float* Alo[2] = {inhi + d, inhi + d + maxA};
  float* Aup[2] = {Alo[1] + maxA, Alo[1] + 2 * maxA};
  float* F = Aup[1] + maxA;  // 2V forms of FS floats
  float* bl = F + 2 * V * FS;
  float* bh = bl + d;
  float* absb = bh + d;
  float* shr = absb + d;
  float* scratch = shr + d;  // 32
  int* flag = (int*)(scratch + 32);

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  for (int i = tid; i < d; i += nt) {
    const float l = blo_g[(size_t)b * d + i], h = bhi_g[(size_t)b * d + i];
    bl[i] = l;
    bh[i] = h;
    absb[i] = fmaxf(fabsf(l), fabsf(h));
    shr[i] = 1.f - pam[i];
  }
  if (tid == 0) *flag = 0;
  __syncthreads();

  // ---- CROWN bounds + output forms for each of the 2V role boxes ----------
  for (int rv = 0; rv < 2 * V; ++rv) {
    const int role = rv / V, v = rv - role * V;
    const float* slo = (role == 0 ? xlo : plo) + ((size_t)b * V + v) * d;
    const float* shi = (role == 0 ? xhi : phi) + ((size_t)b * V + v) * d;
    for (int i = tid; i < d; i += nt) {
      inlo[i] = rlo[i] = slo[i];
      inhi[i] = rhi[i] = shi[i];
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
    float* f = F + rv * FS;
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

  // ---- per-form sums: PA dot products, RA magnitudes, coefficient mags ----
  for (int rv = tid; rv < 2 * V; rv += nt) {
    float* f = F + rv * FS;
    const float* as = assign + (size_t)(rv % V) * d;
    float pl = 0.f, pu = 0.f, rl = 0.f, ru = 0.f, ml = 0.f, mu = 0.f;
    for (int i = 0; i < d; ++i) {
      const float a = f[i], u = f[d + i];
      pl = fmaf(a, as[i], pl);
      pu = fmaf(u, as[i], pu);
      rl = fmaf(fabsf(a), ram[i], rl);
      ru = fmaf(fabsf(u), ram[i], ru);
      ml = fmaf(fabsf(a), absb[i], ml);
      mu = fmaf(fabsf(u), absb[i], mu);
    }
    f[2 * d + 4] = pl;
    f[2 * d + 5] = pu;
    f[2 * d + 6] = eps * rl;
    f[2 * d + 7] = eps * ru;
    f[2 * d + 8] = ml;
    f[2 * d + 9] = mu;
  }
  __syncthreads();

  // ---- pair stage: tied difference bounds, deadness, margin --------------
  float mloc = FLT_MAX;
  for (int pidx = tid; pidx < V * V; pidx += nt) {
    const int a = pidx / V, c = pidx - a * V;
    const float* fx = F + a * FS;        // x role, assignment a
    const float* fp = F + (V + c) * FS;  // x' role, assignment c
    // Direction 1: f(x_a) - f(x'_c) > 0 needs x up-form minus x' low-form.
    const float cu1 = fx[2 * d + 1] + fx[2 * d + 5];
    const float cn1 = (fp[2 * d + 0] + fp[2 * d + 4]) - fp[2 * d + 6];
    // Direction 2: f(x'_c) - f(x_a) > 0 needs x' up-form minus x low-form.
    const float cu2 = (fp[2 * d + 1] + fp[2 * d + 5]) + fp[2 * d + 7];
    const float cn2 = fx[2 * d + 0] + fx[2 * d + 4];
    float m1 = 0.f, g1 = 0.f, m2 = 0.f, g2 = 0.f;
    for (int i = 0; i < d; ++i) {
      const float D1 = (fx[d + i] - fp[i]) * shr[i];
      const float D2 = (fp[d + i] - fx[i]) * shr[i];
      m1 += D1 > 0.f ? D1 * bh[i] : D1 * bl[i];
      m2 += D2 > 0.f ? D2 * bh[i] : D2 * bl[i];
      g1 = fmaf(fabsf(D1), absb[i], g1);
      g2 = fmaf(fabsf(D2), absb[i], g2);
    }
    const float row1 = (m1 + cu1) - cn1;
    const float mag1 = (((g1 + fx[2 * d + 9]) + fp[2 * d + 8]) + fabsf(cu1)) + fabsf(cn1);
    const float w1 = (row1 + SLACK_REL * mag1) + SLACK_ABS;
    const float row2 = (m2 + cu2) - cn2;
    const float mag2 = (((g2 + fp[2 * d + 9]) + fx[2 * d + 8]) + fabsf(cu2)) + fabsf(cn2);
    const float w2 = (row2 + SLACK_REL * mag2) + SLACK_ABS;
    const float lbx = fx[2 * d + 2], ubx = fx[2 * d + 3];
    const float lbp = fp[2 * d + 2], ubp = fp[2 * d + 3];
    const bool t1 = ubx <= 0.f || lbp >= 0.f || w1 <= 0.f;
    const bool t2 = lbx >= 0.f || ubp <= 0.f || w2 <= 0.f;
    const bool ok = vpair[a * V + c] && valid[(size_t)b * V + a] && valid[(size_t)b * V + c];
    if (ok && !(t1 && t2)) atomicOr(flag, 1);
    const float k1 = fmaxf(fmaxf(-ubx, lbp), -w1);
    const float k2 = fmaxf(fmaxf(lbx, -ubp), -w2);
    if (ok) mloc = fminf(mloc, fminf(k1, k2));
  }
  const float mg = block_min(mloc, scratch);
  if (tid == 0) {
    cert[b] = *flag ? 0 : 1;
    margin[b] = mg;
  }
}

extern "C" int kb_stage0_certify(const void* params, const int* dims, int L,
                                 const void* xlo, const void* xhi, const void* plo,
                                 const void* phi, const void* blo, const void* bhi,
                                 const void* assign, const void* pam, const void* ram,
                                 float eps, const void* valid, const void* vpair,
                                 int N, int V, void* cert, void* margin, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const int maxA = max_a(nd), d = nd.in[0];
  const size_t smem = sizeof(float) * (nd.total + 2 * nd.nsum + 9 * nd.maxw + 2 * d
                                       + 4 * maxA + 2 * V * (2 * d + KB_FORM) + 4 * d + 32)
                      + sizeof(int);
  cudaError_t err = set_smem(kb_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    kb_kernel<<<N, KB_THREADS, smem, (cudaStream_t)stream>>>(
        nd, maxA, (const float*)params, (const float*)xlo, (const float*)xhi,
        (const float*)plo, (const float*)phi, (const float*)blo, (const float*)bhi,
        (const float*)assign, (const float*)pam, (const float*)ram, eps,
        (const uint8_t*)valid, (const uint8_t*)vpair, V, (uint8_t*)cert,
        (float*)margin);
  return (int)cudaGetLastError();
}
