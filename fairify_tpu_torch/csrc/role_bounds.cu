// K10, rows 13 and 8 — the output-logit bounds of both roles' boxes.
//
// Replaces fairify_tpu/verify/engine.py:_role_logit_bounds (row 13: the IBP
// path's certificate input in the chunk loop, sweep.py:_stage0_block_submit,
// and in the host frontier's non-fused branch) and
// fairify_tpu/verify/sweep.py:_family_bounds_kernel (row 8: the same mapped
// over a stacked family).  For every role box — B boxes x V protected
// assignments, for the x and the x' role — the widened output-logit bounds,
// in one of two modes:
//   * IBP (use_crown = 0, the mode the sweep and the engine reach): layer by
//     layer the sign-split interval image lo@W+ + hi@W- + b, widened by
//     SLACK_REL * max(|lo|, |hi|) + SLACK_ABS (the same widening as KA's
//     bound half, ops/interval.py:network_bounds), then ReLU and the alive
//     mask on the hidden layers; the output's column 0;
//   * CROWN (use_crown = 1): crown_warp.cuh's CROWN, whose widened output
//     bounds are ops/crown.py:crown_output_bounds (crown_bounds with
//     widening), JAX's other branch of the lax.cond.
//
// Bound on the H100: fp32 FMA throughput — IBP takes 4 FMAs per weight and
// role box (8 * sum(in_l * out_l) flops; 0.82 GFLOP for one 2,048-box AC-S1
// chunk at V = 2, 12 us at the fp32 peak); the bytes (2d floats in, 2 out per
// role box) are under 1 MB.  Each layer depends on the one before, so at
// these sizes the kernel is bound by latency and launch, not by the peak.
//
// Design.  IBP mode (warp_tile.cuh's layout): a persistent grid sized by the
// wrapper (engine.role_bounds_geometry) from the SM count and the blocks an
// SM holds, blockIdx.y the model of a stacked family.  Each block stages
// its model's padded net (cuda_build.pack_padded, forward part) by one bulk
// copy; each warp walks tiles of TW role boxes (the x role's live rows, then
// the x' role's, as one index space) and carries each through every layer
// with __syncwarp only, its lo and hi intervals unit-major in shared memory.
// Each layer is register-blocked: a lane owns 4 role boxes x RC units and,
// per input, loads both intervals' 4 values and RC weights, splits the
// weights into W+ and W- and runs the four sums of each (role box, unit).
// Every sum is the index-ordered fmaf chain from 0, then (a1 + a2) + b, the
// slack, ReLU and the mask, as one thread per unit did before, so the
// bounds do not depend on the tile, the warp or the block, and equal the
// thread-per-unit kernel's bit for bit.  CROWN mode: one block per (box,
// model) runs crown_warp.cuh:role_forms_stage on the box's 2V role boxes
// side by side (the forms stage KB shares; the odd-stride pack,
// cuda_build.pack_odd_models) and writes each one's widened output bounds.
// The launch covers the live boxes only (engine.role_logit_bounds(live=));
// a second small kernel copies box live - 1's outputs to the boxes past it.
// One output buffer (M, 2 roles, 2 (lo, hi), B * V): the lower bound of
// model m, role r, box b, assignment v at ((m * 2 + r) * 2) * B * V + b * V
// + v, its upper bound B * V further.
//
// K7 (k7_alpha_output_bounds) — α-CROWN output bounds of B plain boxes:
// fairify_tpu/ops/crown.py:alpha_crown_output_bounds, run once at its own
// entry point.  Per box, plain CROWN (widened) and then KB's α mode: iters
// signed-gradient steps on the lower slopes of the unstable neurons, a set
// for the lower and one for the upper bound, from the adaptive slopes; the
// best bounds over every iterate, the final one included, widened once
// (unless widen is 0) and intersected with plain CROWN, so never looser than
// it.  Bound on the H100: fp32 FMA throughput of the CROWN backward passes
// and 2 * iters + 1 chain evaluations and iters reverse passes a box; every
// iterate depends on the one before, so at a few boxes an SM the kernel is
// bound by one box's chain of dependent sums, not by the peak.  Design: a
// block takes `per` boxes side by side and runs crown_warp.cuh:
// role_forms_stage on them with a form buffer (a warp per backward-pass
// column pair, then a warp per α side), as KB does for its 2V role boxes;
// the odd-stride net (cuda_build.pack_odd) is staged once per block by one
// bulk copy.  Each box's bounds are its plain set's lb/ub, which the stage
// has intersected with the α best.  The geometry (boxes and warps a block)
// comes from the wrapper (engine.k7_geometry: enough boxes a block that one
// wave of blocks covers B on the card's SMs, at most K7_MAX_WARPS / 2 so
// that each α side has its own warp) and the entry point refuses any other
// shared-memory size.
#include "common.cuh"
#include "crown_warp.cuh"
#include "warp_tile.cuh"

#define K10B_MAX_WARPS 16
#define K7_MAX_WARPS 16

// ---------------------------------------------------------------------------
// IBP mode on warp tiles
// ---------------------------------------------------------------------------

// Unit capacities of the two interval buffers: hidden layer l's output goes
// to buffer l % 2; the tile's role boxes (d units) to buffer 1, which layer
// 0 reads and layer 1 overwrites.
__host__ __device__ inline void rb_buffers(const PadDesc& pd, int& h0, int& h1) {
  h0 = 0;
  h1 = pd.in[0];
  for (int l = 0; l + 1 < pd.L; ++l) {
    int& h = (l & 1) ? h1 : h0;
    if (pd.out[l] > h) h = pd.out[l];
  }
}

// Floats of one warp's tiles: both buffers, lo and hi.
__host__ __device__ inline long long rb_warp_floats(const PadDesc& pd, int tw) {
  int h0, h1;
  rb_buffers(pd, h0, h1);
  return 2LL * (h0 + h1) * tw;
}

// Dynamic shared memory: the mbarrier's 16 bytes, the forward part of the
// padded net, the warps' tiles (engine.role_bounds_smem is the same sum).
static inline long long rb_smem(const PadDesc& pd, int tw, int warps) {
  return 4LL * (4 + pd.fwd + warps * rb_warp_floats(pd, tw));
}

// Columns a lane owns in a layer of nout units and a tile of tw role boxes
// (4 boxes a lane): the RC in {4, 2, 1} with the shortest per-lane chain —
// passes x (16 RC FMAs, 2 RC to split the weights, two 16-byte interval
// loads and one weight load, a load counted twice) — the larger on a tie.
__host__ __device__ inline int rb_pick(int nout, int tw) {
  int best = 4, cost = 0;
  for (int rc = 4; rc >= 1; rc >>= 1) {
    const int items = (nout + rc - 1) / rc * (tw / 4);
    const int c = (items + 31) / 32 * (18 * rc + 6);
    if (rc == 4 || c < cost) {
      best = rc;
      cost = c;
    }
  }
  return best;
}

// One layer of a warp's tile: K inputs (the intervals Alo/Ahi, unit-major),
// nout outputs.  Hidden layers write max(z, 0) * mask of the widened bounds
// z to Olo/Ohi; the last layer writes unit 0's widened bounds of the tile's
// rows r < nvalid to out_lo/out_hi at g0 + r, past the x role's nl rows
// shifted by `skip` (the x' role's block of the output).
template <int RC>
__device__ __forceinline__ void rb_dense(const float* __restrict__ Alo,
                                         const float* __restrict__ Ahi, int tw, int smask,
                                         const float* __restrict__ W, int ldw, int K, int nout,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ mask, float* Olo, float* Ohi,
                                         bool last, float* __restrict__ out_lo,
                                         float* __restrict__ out_hi, long long g0, int nvalid,
                                         long long nl, long long skip, int lane) {
  const int CG = (nout + RC - 1) / RC, items = CG * (tw / 4);
  for (int item = lane; item < items; item += 32) {
    const int cg = item % CG, rg = item / CG;
    float a1[4][RC], a2[4][RC], a3[4][RC], a4[4][RC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) a1[r][c] = a2[r][c] = a3[r][c] = a4[r][c] = 0.f;
    const float* wp = W + RC * cg;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int off = k * tw + ((4 * rg) ^ (((k >> 2) & smask) << 2));
      const float4 l4 = *reinterpret_cast<const float4*>(Alo + off);
      const float4 h4 = *reinterpret_cast<const float4*>(Ahi + off);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
      float w[RC];
      if constexpr (RC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(wp + k * ldw);
        w[0] = t.x;
        w[1] = t.y;
        w[2] = t.z;
        w[3] = t.w;
      } else if constexpr (RC == 2) {
        const float2 t = *reinterpret_cast<const float2*>(wp + k * ldw);
        w[0] = t.x;
        w[1] = t.y;
      } else {
        w[0] = wp[k * ldw];
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float wpos = fmaxf(w[c], 0.f), wneg = fminf(w[c], 0.f);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a1[r][c] = fmaf(lv[r], wpos, a1[r][c]);
          a2[r][c] = fmaf(hv[r], wneg, a2[r][c]);
          a3[r][c] = fmaf(hv[r], wpos, a3[r][c]);
          a4[r][c] = fmaf(lv[r], wneg, a4[r][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = RC * cg + c;
      if (j >= nout || (last && j != 0)) continue;
      const float bj = bias[j];
      float zl[4], zh[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lo = (a1[r][c] + a2[r][c]) + bj, hi = (a3[r][c] + a4[r][c]) + bj;
        const float slack = fmaf(SLACK_REL, fmaxf(fabsf(lo), fabsf(hi)), SLACK_ABS);
        zl[r] = lo - slack;
        zh[r] = hi + slack;
      }
      if (last) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * rg + r;
          if (row < nvalid) {
            const long long g = g0 + row, o = g + (g >= nl ? skip : 0);
            out_lo[o] = zl[r];
            out_hi[o] = zh[r];
          }
        }
      } else {
        const float mj = mask[j];
        const int o = act_off(j, 4 * rg, tw, smask);
        *reinterpret_cast<float4*>(Olo + o) =
            make_float4(fmaxf(zl[0], 0.f) * mj, fmaxf(zl[1], 0.f) * mj,
                        fmaxf(zl[2], 0.f) * mj, fmaxf(zl[3], 0.f) * mj);
        *reinterpret_cast<float4*>(Ohi + o) =
            make_float4(fmaxf(zh[0], 0.f) * mj, fmaxf(zh[1], 0.f) * mj,
                        fmaxf(zh[2], 0.f) * mj, fmaxf(zh[3], 0.f) * mj);
      }
    }
  }
}

// The x role's live rows are xlo/xhi's first nl = live * V, the x' role's
// plo/phi's; compact row g < 2 nl is x row g or x' row g - nl, and its
// lower bound sits at model m's 4 BV block + g (+ 2 BV - nl for the x'
// role), its upper bound BV further.
__global__ void __launch_bounds__(K10B_MAX_WARPS * 32)
k10b_ibp_kernel(PadDesc pd, const float* __restrict__ params, const float* __restrict__ xlo,
                const float* __restrict__ xhi, const float* __restrict__ plo,
                const float* __restrict__ phi, long long BV, long long nl, int tw,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int d = pd.in[0], L = pd.L, smask = swz_mask(tw);
  int h0, h1;
  rb_buffers(pd, h0, h1);
  float* base = P + pd.fwd + warp * rb_warp_floats(pd, tw);
  float* Hlo[2] = {base, base + h0 * tw};
  float* Hhi[2] = {base + (h0 + h1) * tw, base + (2 * h0 + h1) * tw};
  uint32_t picks = 0;  // RC of layer l: 1 << (2 bits at 2 l)
  for (int l = 0; l < L; ++l) picks |= (uint32_t)(31 - __clz(rb_pick(pd.out[l], tw))) << (2 * l);
  stage_net(P, params + (size_t)blockIdx.y * pd.total, pd.fwd, bar);

  const long long rows = 2 * nl, tiles = (rows + tw - 1) / tw;
  const long long stride = (long long)gridDim.x * nw;
  float* olo = out + (size_t)blockIdx.y * 4 * BV;
  float* ohi = olo + BV;
  bool staged = false;
  for (long long t = (long long)blockIdx.x * nw + warp; t < tiles; t += stride) {
    const long long g0 = t * tw;
    const int nvalid = (int)min((long long)tw, rows - g0);
    __syncwarp();  // the previous tile's last reads of buffer 1 are done
    for (int e = lane; e < tw * d; e += 32) {
      const int r = e / d, i = e - r * d;
      float l = 0.f, h = 0.f;
      if (r < nvalid) {
        const long long g = g0 + r;
        const bool xp = g >= nl;
        const long long src = (xp ? g - nl : g) * d + i;
        l = (xp ? plo : xlo)[src];
        h = (xp ? phi : xhi)[src];
      }
      Hlo[1][act_off(i, r, tw, smask)] = l;
      Hhi[1][act_off(i, r, tw, smask)] = h;
    }
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      const int in = (l + 1) & 1, out = l & 1, rc = 1 << ((picks >> (2 * l)) & 3);
      const bool last = l + 1 == L;
      const float* W = P + pd.w[l];
      const float* Bl = P + pd.b[l];
      const float* Ml = P + pd.m[l];
      if (rc == 4)
        rb_dense<4>(Hlo[in], Hhi[in], tw, smask, W, pd.ldw[l], pd.in[l], pd.out[l], Bl, Ml,
                    Hlo[out], Hhi[out], last, olo, ohi, g0, nvalid, nl, 2 * BV - nl, lane);
      else if (rc == 2)
        rb_dense<2>(Hlo[in], Hhi[in], tw, smask, W, pd.ldw[l], pd.in[l], pd.out[l], Bl, Ml,
                    Hlo[out], Hhi[out], last, olo, ohi, g0, nvalid, nl, 2 * BV - nl, lane);
      else
        rb_dense<1>(Hlo[in], Hhi[in], tw, smask, W, pd.ldw[l], pd.in[l], pd.out[l], Bl, Ml,
                    Hlo[out], Hhi[out], last, olo, ohi, g0, nvalid, nl, 2 * BV - nl, lane);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// CROWN mode on crown_warp.cuh's forms stage
// ---------------------------------------------------------------------------

// Float offsets of one CROWN-mode block: the mbarrier's 4, the odd-stride
// net, the 2V role boxes' workspaces, the warps' column-pair scratch
// (engine.role_bounds_smem is the same sum).
struct RcLayout {
  int net, roles, rws, warps, wws, total;
};

__host__ __device__ inline RcLayout rc_layout(const NetDesc& nd, int V, int warps) {
  RcLayout o;
  o.net = 4;
  o.roles = o.net + cw_round4(nd.total);
  o.rws = role_ws_floats(nd);
  o.warps = o.roles + 2 * V * o.rws;
  o.wws = cw_round4(8 * nd.maxw);
  o.total = o.warps + warps * o.wws;
  return o;
}

__global__ void __launch_bounds__(K10B_MAX_WARPS * 32)
k10b_crown_kernel(NetDesc nd, const float* __restrict__ params, long long mstride,
                  const float* __restrict__ xlo, const float* __restrict__ xhi,
                  const float* __restrict__ plo, const float* __restrict__ phi, int B, int V,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], nrv = 2 * V, tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x, m = blockIdx.y;
  const RcLayout o = rc_layout(nd, V, nt >> 5);
  float* P = smem + o.net;
  float* roles = smem + o.roles;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);

  stage_net(P, params + (size_t)m * mstride, cw_round4(nd.total), bar);
  for (int q = tid; q < nrv * d; q += nt) {  // role box rv = role * V + v
    const int rv = q / d, i = q - rv * d;
    const int role = rv / V, v = rv - role * V;
    const size_t src = ((size_t)b * V + v) * d + i;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    R.inlo[i] = (role == 0 ? xlo : plo)[src];
    R.inhi[i] = (role == 0 ? xhi : phi)[src];
  }
  mbar_wait(bar, 0);
  __syncthreads();
  role_forms_stage(nd, P, roles, o.rws, smem + o.warps, o.wws, nrv, nullptr, 0, nullptr, 0);
  for (int rv = tid; rv < nrv; rv += nt) {
    const int role = rv / V, v = rv - role * V;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    const size_t o = ((size_t)m * 2 + role) * 2 * B * V + (size_t)b * V + v;
    out[o] = R.wslb[nd.n[nd.L - 1]];
    out[o + (size_t)B * V] = R.wsub[nd.n[nd.L - 1]];
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// Float offsets of one K7 block: the mbarrier's 4, the odd-stride net, the
// `per` boxes' workspaces, the warps' scratch (a column pair or an α side),
// both form sets of every box (2d + 4 floats each), the α best bounds
// (engine.k7_smem is the same sum).
struct K7Layout {
  int net, roles, rws, warps, wws, F, FS, best, total;
};

__host__ __device__ inline K7Layout k7_layout(const NetDesc& nd, int per, int warps) {
  K7Layout o;
  o.FS = 2 * nd.in[0] + 4;
  o.net = 4;
  o.roles = o.net + cw_round4(nd.total);
  o.rws = role_ws_floats(nd);
  o.warps = o.roles + per * o.rws;
  o.wws = warp_ws_floats(nd);
  o.F = o.warps + warps * o.wws;
  o.best = o.F + cw_round4(2 * per * o.FS);
  o.total = o.best + cw_round4(2 * per);
  return o;
}

__global__ void __launch_bounds__(K7_MAX_WARPS * 32)
k7_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ lo,
          const float* __restrict__ hi, int B, int per, int iters, int widen,
          float* __restrict__ out_lo, float* __restrict__ out_hi) {
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  const K7Layout o = k7_layout(nd, per, nt >> 5);
  float* P = smem + o.net;
  float* roles = smem + o.roles;
  float* F = smem + o.F;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int b0 = blockIdx.x * per, nb = min(per, B - b0);

  stage_net(P, params, cw_round4(nd.total), bar);
  for (int q = tid; q < nb * d; q += nt) {
    const int rv = q / d, i = q - rv * d;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    R.inlo[i] = lo[(size_t)(b0 + rv) * d + i];
    R.inhi[i] = hi[(size_t)(b0 + rv) * d + i];
  }
  mbar_wait(bar, 0);
  __syncthreads();
  role_forms_stage(nd, P, roles, o.rws, smem + o.warps, o.wws, nb, F, o.FS, smem + o.best,
                   iters, widen != 0);
  for (int rv = tid; rv < nb; rv += nt) {
    out_lo[b0 + rv] = F[rv * o.FS + 2 * d + 2];
    out_hi[b0 + rv] = F[rv * o.FS + 2 * d + 3];
  }
}

// Dynamic shared memory of one K7 block (engine.k7_smem).
static inline long long k7_smem(const NetDesc& nd, int per, int warps) {
  return 4LL * k7_layout(nd, per, warps).total;
}

// The launch geometry comes from the wrapper (engine.k7_geometry: boxes a
// block, warps a block, shared-memory bytes) and is checked here against
// the net and the kernel's limits.  params is cuda_build.pack_odd's buffer,
// padded to 16 bytes; lo, hi: (B, d); widen 0 leaves the best α bounds
// unwidened.  Blocks: ceil(B / per).
extern "C" int k7_alpha_output_bounds(const void* params, const int* dims, int L,
                                      const void* lo, const void* hi, int B, int iters,
                                      int widen, void* out_lo, void* out_hi, int per, int warps,
                                      long long smem, void* stream) {
  if (L < 1 || L > MAX_LAYERS || dims[L] != 1 || B < 0 || iters < 0 || per < 1 ||
      warps < 1 || warps > K7_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
  if (smem != k7_smem(nd, per, warps) || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(k7_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    k7_kernel<<<(B + per - 1) / per, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)lo, (const float*)hi, B, per, iters, widen,
        (float*)out_lo, (float*)out_hi);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block in either mode (engine.role_bounds_smem).
static inline long long k10b_smem(const int* dims, int L, int V, int use_crown, int tw,
                                  int warps) {
  if (use_crown) return 4LL * rc_layout(make_desc(dims, L, /*odd_rows=*/true), V, warps).total;
  return rb_smem(make_pad_desc(dims, L), tw, warps);
}

// Rows 13 and 8.  The launch geometry comes from the wrapper
// (engine.role_bounds_geometry) and is checked here against the net and the
// kernel's limits.  IBP: params is cuda_build.pack_padded's buffer (M packs
// back to back), tw role boxes a warp tile, warps a block, grid blocks a
// model.  CROWN: params is cuda_build.pack_odd_models's buffer, warps a
// block, one block per live box and model (tw and grid unused).  Both
// cover the live boxes of B.  out: (M, 2, 2, B * V) floats.
extern "C" int k10_role_bounds(const void* params, const int* dims, int L, const void* xlo,
                               const void* xhi, const void* plo, const void* phi, int B,
                               int V, int M, int live, int use_crown, void* out, int tw,
                               int warps, int grid, long long smem, void* stream) {
  if (L < 1 || dims[L] != 1 || V < 1 || M < 0 || M > 65535 || live < 0 || live > B ||
      (B > 0 && live < 1) || warps < 1 || warps > K10B_MAX_WARPS ||
      (!use_crown && (tw < 4 || tw % 4 != 0 || tw > 64 || grid < 1)) ||
      smem != k10b_smem(dims, L, V, use_crown, tw, warps) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (use_crown) {
    const NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
    if ((err = set_smem(k10b_crown_kernel, (size_t)smem)) != cudaSuccess) return (int)err;
    if (live > 0 && M > 0)
      k10b_crown_kernel<<<dim3((unsigned)live, (unsigned)M), 32 * warps, (size_t)smem,
                          (cudaStream_t)stream>>>(
          nd, (const float*)params, (long long)cw_round4(nd.total), (const float*)xlo,
          (const float*)xhi, (const float*)plo, (const float*)phi, B, V, (float*)out);
  } else {
    const PadDesc pd = make_pad_desc(dims, L);
    if ((err = set_smem(k10b_ibp_kernel, (size_t)smem)) != cudaSuccess) return (int)err;
    if (live > 0 && M > 0)
      k10b_ibp_kernel<<<dim3((unsigned)grid, (unsigned)M), 32 * warps, (size_t)smem,
                        (cudaStream_t)stream>>>(
          pd, (const float*)params, (const float*)xlo, (const float*)xhi, (const float*)plo,
          (const float*)phi, (long long)B * V, (long long)live * V, tw, (float*)out);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // Boxes live .. B - 1 of every (model, role, bound) take box live - 1's V
  // outputs.
  fill_past((float*)out, 4 * M, B, live, V, stream);
  return (int)cudaGetLastError();
}
