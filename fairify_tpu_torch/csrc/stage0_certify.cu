// KB — the certificate: CROWN (or α-CROWN) role bounds + tied
// pair-difference kills, the certified margin and the branching score.
//
// Replaces fairify_tpu/verify/engine.py:_certify_impl (with
// ops/crown.py:crown_output_form_sets and engine._tied_diff_ub) wherever it
// runs on the device: the _certify_impl half of sweep.py:_mega_stage0_kernel
// (row 4), of its family form _mega_family_stage0_kernel (row 5), of
// _family_stage0_kernel (row 7) and of engine._certify_attack_kernel
// (row 15: the chunk loop and the host-frontier BaB), and the certificate
// alone of the mesh path (rows 14 and 6).  Per partition box, per model,
// and for each of the V protected-attribute assignments of both roles
// (x, x'):
//   * IBP for layer 0, then for every deeper layer a CROWN backward pass
//     (triangle ReLU relaxation, adaptive lower slope) concretized over the
//     role box, intersected with IBP and widened outward;
//   * the output-logit linear forms (A_low, c_low, A_up, c_up) of the last
//     backward pass; with alpha_iters > 0 a second form set from the
//     α-CROWN optimiser, whose bounds tighten both sets' role bounds.
// Then, per assignment pair (a, b), flip direction and form set, the tied
// difference bound max over shared coordinates of (pos form - neg form),
// widened with its own magnitude before the min over form sets, the role
// deadness tests, the per-box certificate and certified margin, and per
// shared coordinate the score: the largest |pos - neg| coefficient over
// every set, direction and pair (valid or not, as in the JAX package).
//
// Bound on the H100: fp32 FMA throughput of the backward passes —
// sum over layers k >= 1, over j < k, of in_j * out_j * out_k MACs per role
// box (~0.8 M at AC-S1 widths, 64,000 role boxes on the adult grid) and, with
// α, 2 * alpha_iters + 1 chain evaluations and alpha_iters reverse passes;
// the bytes (role boxes in, 2 + d values per box out) are small.
//
// Design: one block per (box, model): blockIdx.x the box, blockIdx.y the
// model of a stacked family, whose packed net (rows at an odd stride,
// cuda_build.pack_odd_models) starts at m * mstride floats; outputs of
// model m sit at m * N + box.  The net is staged once per block by one bulk
// copy.  The 2V role boxes' CROWN and α-CROWN forms are computed side by
// side by crown_warp.cuh:role_forms_stage, the forms stage K6 runs: a warp
// per backward-pass column pair or α side, about 2L block barriers, no
// coefficient matrix in shared memory.  Then KB's own stages: the per-form
// sums (a thread per form), the pair stage (a thread per pair: tied bounds,
// deadness, the certificate and the margin, a block min), the score (a
// thread per coordinate).  The launch geometry (warps per block) comes from
// the wrapper (engine.kb_geometry) and the entry point refuses any other
// shared-memory size.  Every product is a true-f32 FMA loop (no tensor
// cores, so no TF32).  The model axis only offsets the net and the outputs,
// so a family launch equals the solo launches per model bit for bit.
#include "common.cuh"
#include "crown_warp.cuh"
#include "warp_tile.cuh"

#define KB_MAX_WARPS 16
#define KB_FORM 10  // per-form scalars after the two d-vectors

// Float offsets of one block's shared memory after the mbarrier's 4: the
// net, the 2V role boxes, the warps' scratch, both form sets, the box
// vectors, the α best bounds, the reduction scratch and the flag
// (engine.kb_smem is the same sum).
struct KbLayout {
  int net, roles, rws, warps, wws, F, box, best, red, total;
};

__host__ __device__ inline KbLayout kb_layout(const NetDesc& nd, int V, int warps) {
  KbLayout o;
  const int d = nd.in[0], FS = 2 * d + KB_FORM;
  o.net = 4;
  o.roles = o.net + cw_round4(nd.total);
  o.rws = role_ws_floats(nd);
  o.warps = o.roles + 2 * V * o.rws;
  o.wws = warp_ws_floats(nd);
  o.F = o.warps + warps * o.wws;
  o.box = o.F + cw_round4(2 * 2 * V * FS);
  o.best = o.box + cw_round4(4 * d);
  o.red = o.best + cw_round4(4 * V);
  o.total = o.red + 32 + 4;
  return o;
}

__global__ void __launch_bounds__(KB_MAX_WARPS * 32)
kb_kernel(NetDesc nd, const float* __restrict__ params, long long mstride,
          const float* __restrict__ xlo, const float* __restrict__ xhi,
          const float* __restrict__ plo, const float* __restrict__ phi,
          const float* __restrict__ blo_g, const float* __restrict__ bhi_g,
          const float* __restrict__ assign, const float* __restrict__ pam,
          const float* __restrict__ ram, float eps,
          const uint8_t* __restrict__ valid, const uint8_t* __restrict__ vpair,
          int V, int N, int alpha_iters, uint8_t* __restrict__ cert,
          float* __restrict__ score, float* __restrict__ margin) {
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], FS = 2 * d + KB_FORM, nrv = 2 * V;
  const int ns = (alpha_iters > 0 && nd.L > 1) ? 2 : 1;  // form sets
  const int b = blockIdx.x, m = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const KbLayout o = kb_layout(nd, V, nt >> 5);
  float* P = smem + o.net;
  float* roles = smem + o.roles;
  float* F = smem + o.F;  // ns * 2V forms of FS floats
  float* bl = smem + o.box;
  float* bh = bl + d;
  float* absb = bh + d;
  float* shr = absb + d;
  float* scratch = smem + o.red;  // 32
  int* flag = reinterpret_cast<int*>(scratch + 32);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const size_t out = (size_t)m * N + b;

  stage_net(P, params + (size_t)m * mstride, cw_round4(nd.total), bar);
  for (int q = tid; q < nrv * d; q += nt) {  // the role boxes
    const int rv = q / d, i = q - rv * d;
    const int role = rv / V, v = rv - role * V;
    const size_t src = ((size_t)b * V + v) * d + i;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    R.inlo[i] = (role == 0 ? xlo : plo)[src];
    R.inhi[i] = (role == 0 ? xhi : phi)[src];
  }
  for (int i = tid; i < d; i += nt) {
    const float l = blo_g[(size_t)b * d + i], h = bhi_g[(size_t)b * d + i];
    bl[i] = l;
    bh[i] = h;
    absb[i] = fmaxf(fabsf(l), fabsf(h));
    shr[i] = 1.f - pam[i];
  }
  if (tid == 0) *flag = 0;
  mbar_wait(bar, 0);
  __syncthreads();

  // ---- CROWN (and α-CROWN) bounds + output forms of the 2V role boxes ----
  role_forms_stage(nd, P, roles, o.rws, smem + o.warps, o.wws, nrv, F, FS, smem + o.best,
                   ns == 2 ? alpha_iters : 0);
  // ---- per-form sums: PA dot products, RA magnitudes, coefficient mags ----
  for (int q = tid; q < ns * 2 * V; q += nt) {
    float* f = F + q * FS;
    const float* as = assign + (size_t)((q % (2 * V)) % V) * d;
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
    float w1 = FLT_MAX, w2 = FLT_MAX;
    for (int s = 0; s < ns; ++s) {
      const float* fx = F + (s * 2 * V + a) * FS;      // x role, assignment a
      const float* fp = F + (s * 2 * V + V + c) * FS;  // x' role, assignment c
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
      w1 = fminf(w1, (row1 + SLACK_REL * mag1) + SLACK_ABS);
      const float row2 = (m2 + cu2) - cn2;
      const float mag2 = (((g2 + fp[2 * d + 9]) + fx[2 * d + 8]) + fabsf(cu2)) + fabsf(cn2);
      w2 = fminf(w2, (row2 + SLACK_REL * mag2) + SLACK_ABS);
    }
    const float* fx = F + a * FS;
    const float* fp = F + (V + c) * FS;
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
  // ---- branching score: one thread per shared coordinate ------------------
  for (int i = tid; i < d; i += nt) {
    float sc = 0.f;
    for (int s = 0; s < ns; ++s)
      for (int a = 0; a < V; ++a) {
        const float* fx = F + (s * 2 * V + a) * FS;
        for (int c = 0; c < V; ++c) {
          const float* fp = F + (s * 2 * V + V + c) * FS;
          sc = fmaxf(sc, fabsf((fx[d + i] - fp[i]) * shr[i]));
          sc = fmaxf(sc, fabsf((fp[d + i] - fx[i]) * shr[i]));
        }
      }
    score[out * d + i] = sc;
  }
  const float mg = block_min(mloc, scratch);
  if (tid == 0) {
    cert[out] = *flag ? 0 : 1;
    margin[out] = mg;
  }
}

// Dynamic shared memory of one block (engine.kb_smem).
static inline long long kb_smem(const NetDesc& nd, int V, int warps) {
  return 4LL * kb_layout(nd, V, warps).total;
}

// The launch geometry comes from the wrapper (engine.kb_geometry: warps per
// block, shared-memory bytes) and is checked here against the net and the
// kernel's limits.  params is cuda_build.pack_odd_models's buffer: M packs
// of mstride floats (a multiple of 4), each padded to 16 bytes.  The
// launch covers boxes 0 .. live - 1 of N; fill_past gives the boxes past
// them box live - 1's outputs (engine.fill_past).
extern "C" int kb_stage0_certify(const void* params, const int* dims, int L, long long mstride,
                                 const void* xlo, const void* xhi, const void* plo,
                                 const void* phi, const void* blo, const void* bhi,
                                 const void* assign, const void* pam, const void* ram,
                                 float eps, const void* valid, const void* vpair,
                                 int N, int V, int M, int live, int alpha_iters, void* cert,
                                 void* score, void* margin, int warps, long long smem,
                                 void* stream) {
  const NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
  if (warps < 1 || warps > KB_MAX_WARPS || V < 1 || smem != kb_smem(nd, V, warps) ||
      smem > SMEM_LIMIT || nd.out[L - 1] != 1 || mstride != cw_round4(nd.total) ||
      alpha_iters < 0 || M > 65535 || live < 0 || live > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kb_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0 && M > 0) {
    kb_kernel<<<dim3(live, M), 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, mstride, (const float*)xlo, (const float*)xhi,
        (const float*)plo, (const float*)phi, (const float*)blo, (const float*)bhi,
        (const float*)assign, (const float*)pam, (const float*)ram, eps,
        (const uint8_t*)valid, (const uint8_t*)vpair, V, N, alpha_iters,
        (uint8_t*)cert, (float*)score, (float*)margin);
    fill_past((uint8_t*)cert, M, N, live, 1, stream);
    fill_past((float*)score, M, N, live, nd.in[0], stream);
    fill_past((float*)margin, M, N, live, 1, stream);
  }
  return (int)cudaGetLastError();
}
