// K6 — one device-resident branch-and-bound segment, one launch.
//
// Replaces fairify_tpu/verify/engine.py:_bab_segment_kernel (body
// _bab_segment_impl, with _certify_clip_impl, _tied_diff_ub_keep and, for
// alpha_iters > 0, ops/crown.py:_optimize_relaxation).  The frontier is a
// fixed-capacity slot queue (Qs slots, the last a never-allocated canary
// when integrity is on) updated in place over `rounds` branching rounds:
//   per-slot phase (every live slot): CROWN forms of its 2V role boxes
//     (plain; α-CROWN with alpha_iters signed-gradient steps), the
//     tied-difference bounds of every assignment pair and direction with
//     their keep hulls, the certificate, the inward integer clip, the
//     midpoint probe with its first-flip latch, and the split choice
//     (score x width, widest-dim fallback, first max);
//   compaction phase (block 0): free slots and splitters ranked in slot
//     order, the k-th splitter's upper half written to the k-th free slot,
//     per-root node/split/overflow counters.
// The two phases of a round are separated by grid-wide syncs of a
// cooperative launch (all blocks resident), so a segment never returns to
// the host; at the end block 0 folds every queue buffer and counter into
// the int32 wraparound checksum (resilience/integrity.py:BAB_FOLD_KEYS).
//
// Bound on the H100: fp32 FMA throughput of the CROWN backward passes —
// about 3.3 M flops per role box at AC-S1 widths, 2V role boxes per live
// slot per round, plus the α chains (each step two forward and two reverse
// chain passes, ~50 k flops).  The compaction is O(Qs) integer work.
//
// Design (crown_warp.cuh): a block certifies one live slot at a time, its
// 2V role boxes side by side (crown_warp.cuh:role_forms_stage, the forms
// stage KB shares); blocks take the next slot of the round from
// a counter.  Within a layer every backward-pass column pair of every role
// box is one warp's work (__syncwarp only), every α side of a role box one
// warp's chain, so a slot runs about 2L block barriers instead of a few
// hundred per role box.  The net (rows at an odd stride, cuda_build.
// pack_odd) is staged once per block by one bulk copy; the role boxes'
// bounds and the warps' vectors are small, so two slots stay resident per
// SM at AC-S1 widths, V = 2.  The wrapper sizes the launch
// (engine.bab_geometry) and the entry point refuses any other shared-memory
// size or a grid the card cannot hold resident.  The first-flip scan, the
// split choice and the compaction's ranks are warp ballots and block prefix
// counts with the serial scans' rules.  All products are true-f32 FMA
// loops.
#include <cooperative_groups.h>

#include "common.cuh"
#include "crown_warp.cuh"
#include "warp_tile.cuh"

namespace cg = cooperative_groups;

#define K6_MAX_WARPS 16
#define K6_FORM 10  // per-form scalars after the two d-vectors
#define TINY 1e-12f

struct SegArgs {
  const float* params;
  float *q_lo, *q_hi;
  int* q_root;
  uint8_t *q_live, *found;
  int *wit_a, *wit_b;
  float* wit_pt;
  int *nodes, *splits, *overflow;
  const uint8_t *slot_ok, *root_valid;
  const float *assign, *pam, *ram;
  const uint8_t* vpair;
  const float* bmask;
  float eps;
  int Qs, G, V, rounds, alpha_iters;
  int4* scratch;  // per slot, this round: can, dim, mid (float bits), kept
  int* table;     // Qs: the free slots by rank (compaction)
  int* next;      // rounds: each round's slot counter, zeroed by the caller
  unsigned* fold;
};

// Form layout (KB's): A_low (d), A_up (d), c_low, c_up, lb, ub, then the
// PA dot products, the ε-scaled RA magnitudes and the coefficient
// magnitudes of both forms.
#define F_CL(f, d) f[2 * (d) + 0]
#define F_CU(f, d) f[2 * (d) + 1]
#define F_LB(f, d) f[2 * (d) + 2]
#define F_UB(f, d) f[2 * (d) + 3]
#define F_PL(f, d) f[2 * (d) + 4]
#define F_PU(f, d) f[2 * (d) + 5]
#define F_RL(f, d) f[2 * (d) + 6]
#define F_RU(f, d) f[2 * (d) + 7]
#define F_ML(f, d) f[2 * (d) + 8]
#define F_MU(f, d) f[2 * (d) + 9]

// Float offsets of one block's shared memory after the mbarrier's 4: the
// net, the 2V role boxes, the warps' scratch, then the slot's form sets,
// pair bounds, box vectors, probe activations, validity, α best bounds and
// flags (engine.bab_smem is the same sum).
struct K6Layout {
  int net, roles, rws, warps, wws, F, PW, box, H0, H1, vld, best, flags, total;
};

__host__ __device__ inline K6Layout k6_layout(const NetDesc& nd, int V, int warps) {
  K6Layout o;
  const int d = nd.in[0], FS = 2 * d + K6_FORM;
  o.net = 4;
  o.roles = o.net + cw_round4(nd.total);
  o.rws = role_ws_floats(nd);
  o.warps = o.roles + 2 * V * o.rws;
  o.wws = warp_ws_floats(nd);
  o.F = o.warps + warps * o.wws;
  o.PW = o.F + cw_round4(2 * 2 * V * FS);
  o.box = o.PW + cw_round4(2 * 2 * V * V);
  o.H0 = o.box + cw_round4(7 * d);
  o.H1 = o.H0 + cw_round4(V * nd.maxw);
  o.vld = o.H1 + cw_round4(V * nd.maxw);
  o.best = o.vld + cw_round4(V);
  o.flags = o.best + cw_round4(4 * V);
  o.total = o.flags + 8;
  return o;
}

struct SlotSmem {
  float *P, *roles, *warps, *F, *PW, *bl, *bh, *absb, *shr, *nlo, *nhi, *sc, *H0, *H1, *vld,
      *best;
  int* flags;  // [0] possible, [1] empty, [3] found_now
  int rws, wws;
};

// Pair (a, b), direction dir, form set s: the positive (upper) and the
// negative (lower) form and their constants (engine.certify_clip_impl).
__device__ __forceinline__ void pair_forms(const float* F, int FS, int V, int d, int s,
                                           int dir, int a, int b,
                                           const float*& pos, const float*& neg,
                                           float& cu, float& cn) {
  const float* base = F + (size_t)s * 2 * V * FS;
  if (dir == 0) {  // f(x_a) - f(x'_b) > 0
    pos = base + a * FS;
    neg = base + (V + b) * FS;
    cu = F_CU(pos, d) + F_PU(pos, d);
    cn = (F_CL(neg, d) + F_PL(neg, d)) - F_RL(neg, d);
  } else {  // f(x'_b) - f(x_a) > 0
    pos = base + (V + b) * FS;
    neg = base + a * FS;
    cu = (F_CU(pos, d) + F_PU(pos, d)) + F_RU(pos, d);
    cn = F_CL(neg, d) + F_PL(neg, d);
  }
}

__device__ void slot_phase(const NetDesc& nd, const SegArgs& A, const SlotSmem& S, int slot) {
  const int d = nd.in[0], L = nd.L, V = A.V, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int FS = 2 * d + K6_FORM, nrv = 2 * V;
  const int ns = (A.alpha_iters > 0 && L > 1) ? 2 : 1;
  const int root = A.q_root[slot];
  for (int i = tid; i < d; i += nt) {
    const float l = A.q_lo[(size_t)slot * d + i], h = A.q_hi[(size_t)slot * d + i];
    S.bl[i] = l;
    S.bh[i] = h;
    S.absb[i] = fmaxf(fabsf(l), fabsf(h));
  }
  for (int v = tid; v < V; v += nt) S.vld[v] = A.root_valid[(size_t)root * V + v] ? 1.f : 0.f;
  if (tid == 0) S.flags[0] = S.flags[1] = 0;
  __syncthreads();

  // ---- CROWN (and α-CROWN) forms of the 2V role boxes, side by side -------
  for (int q = tid; q < nrv * d; q += nt) {
    const int rv = q / d, i = q - rv * d;
    const int role = rv / V, v = rv - role * V;
    const RoleWs R = role_ws(S.roles + rv * S.rws, nd);
    const float sh = S.shr[i], av = A.assign[(size_t)v * d + i];
    float lo = S.bl[i] * sh + av, hi = S.bh[i] * sh + av;
    if (role) {
      lo = lo - A.eps * A.ram[i];
      hi = hi + A.eps * A.ram[i];
    }
    R.inlo[i] = lo;
    R.inhi[i] = hi;
  }
  __syncthreads();
  role_forms_stage(nd, S.P, S.roles, S.rws, S.warps, S.wws, nrv, S.F, FS, S.best,
                   ns == 2 ? A.alpha_iters : 0);
  // ---- per-form sums ------------------------------------------------------
  for (int q = tid; q < ns * 2 * V; q += nt) {
    float* f = S.F + q * FS;
    const int v = (q % (2 * V)) % V;
    const float* as = A.assign + (size_t)v * d;
    float pl = 0.f, pu = 0.f, rl = 0.f, ru = 0.f, ml = 0.f, mu = 0.f;
    for (int i = 0; i < d; ++i) {
      const float a = f[i], u = f[d + i];
      pl = fmaf(a, as[i], pl);
      pu = fmaf(u, as[i], pu);
      rl = fmaf(fabsf(a), A.ram[i], rl);
      ru = fmaf(fabsf(u), A.ram[i], ru);
      ml = fmaf(fabsf(a), S.absb[i], ml);
      mu = fmaf(fabsf(u), S.absb[i], mu);
    }
    F_PL(f, d) = pl;
    F_PU(f, d) = pu;
    F_RL(f, d) = A.eps * rl;
    F_RU(f, d) = A.eps * ru;
    F_ML(f, d) = ml;
    F_MU(f, d) = mu;
  }
  __syncthreads();
  // ---- widened tied-difference bound of every (set, direction, a, b) -------
  for (int q = tid; q < ns * 2 * V * V; q += nt) {
    const int b = q % V, a = (q / V) % V, dir = (q / (V * V)) % 2, s = q / (2 * V * V);
    const float *pos, *neg;
    float cu, cn;
    pair_forms(S.F, FS, V, d, s, dir, a, b, pos, neg, cu, cn);
    float m = 0.f, g = 0.f;
    for (int i = 0; i < d; ++i) {
      const float D = (pos[d + i] - neg[i]) * S.shr[i];
      m += D > 0.f ? D * S.bh[i] : D * S.bl[i];
      g = fmaf(fabsf(D), S.absb[i], g);
    }
    const float row = (m + cu) - cn;
    const float mag = (((g + F_MU(pos, d)) + F_ML(neg, d)) + fabsf(cu)) + fabsf(cn);
    S.PW[q] = (row + SLACK_REL * mag) + SLACK_ABS;
  }
  __syncthreads();
  // ---- certificate --------------------------------------------------------
  for (int q = tid; q < V * V; q += nt) {
    const int a = q / V, b = q % V;
    const float* fx = S.F + a * FS;
    const float* fpr = S.F + (V + b) * FS;
    const bool ok = A.vpair[q] && S.vld[a] > 0.f && S.vld[b] > 0.f;
    bool t1 = F_UB(fx, d) <= 0.f || F_LB(fpr, d) >= 0.f;
    bool t2 = F_LB(fx, d) >= 0.f || F_UB(fpr, d) <= 0.f;
    float ub1 = FLT_MAX, ub2 = FLT_MAX;
    for (int s = 0; s < ns; ++s) {
      ub1 = fminf(ub1, S.PW[((s * 2 + 0) * V + a) * V + b]);
      ub2 = fminf(ub2, S.PW[((s * 2 + 1) * V + a) * V + b]);
    }
    t1 = t1 || ub1 <= 0.f;
    t2 = t2 || ub2 <= 0.f;
    if (ok && !(t1 && t2)) atomicOr(&S.flags[0], 1);
  }
  // ---- keep hull, clip and branching score, one thread per coordinate ----
  for (int i = tid; i < d; i += nt) {
    float score = 0.f, keep_lo = 0.f, keep_hi = 0.f;
    for (int s = 0; s < ns; ++s) {
      float skl = FLT_MAX, skh = -FLT_MAX;
      for (int dir = 0; dir < 2; ++dir)
        for (int a = 0; a < V; ++a)
          for (int b = 0; b < V; ++b) {
            const float *pos, *neg;
            float cu, cn;
            pair_forms(S.F, FS, V, d, s, dir, a, b, pos, neg, cu, cn);
            const float D = (pos[d + i] - neg[i]) * S.shr[i];
            const float absD = fabsf(D);
            score = fmaxf(score, absD);
            const float* fx = S.F + a * FS;
            const float* fpr = S.F + (V + b) * FS;
            const bool ok = A.vpair[a * V + b] && S.vld[a] > 0.f && S.vld[b] > 0.f;
            const bool dead = dir == 0 ? (F_UB(fx, d) <= 0.f || F_LB(fpr, d) >= 0.f)
                                       : (F_LB(fx, d) >= 0.f || F_UB(fpr, d) <= 0.f);
            const float w = S.PW[((s * 2 + dir) * V + a) * V + b];
            if (!ok || dead || !(w > 0.f)) continue;
            float shift = w / fmaxf(absD, TINY);
            shift = (shift + SLACK_REL * shift) + SLACK_ABS;
            skl = fminf(skl, D > TINY ? S.bh[i] - shift : S.bl[i]);
            skh = fmaxf(skh, D < -TINY ? S.bl[i] + shift : S.bh[i]);
          }
      keep_lo = s == 0 ? skl : fmaxf(keep_lo, skl);
      keep_hi = s == 0 ? skh : fminf(keep_hi, skh);
    }
    const float nl = fmaxf(S.bl[i], ceilf(keep_lo)), nh = fminf(S.bh[i], floorf(keep_hi));
    S.nlo[i] = nl;
    S.nhi[i] = nh;
    S.sc[i] = score;
    if (nl > nh) atomicOr(&S.flags[1], 1);
  }
  __syncthreads();
  const bool keep = !(S.flags[0] == 0 || S.flags[1] != 0);
  if (tid == 0) atomicAdd(&A.nodes[root], 1);
  if (!keep) {
    if (tid == 0) {
      A.q_live[slot] = 0;
      A.scratch[slot] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  // ---- clip, midpoint probe --------------------------------------------------
  for (int i = tid; i < d; i += nt) {
    S.bl[i] = S.nlo[i];
    S.bh[i] = S.nhi[i];
    A.q_lo[(size_t)slot * d + i] = S.nlo[i];
    A.q_hi[(size_t)slot * d + i] = S.nhi[i];
  }
  __syncthreads();
  for (int q = tid; q < V * d; q += nt) {
    const int v = q / d, i = q % d;
    const float mid = floorf((S.bl[i] + S.bh[i]) * 0.5f);
    S.H0[v * nd.maxw + i] = mid * S.shr[i] + A.assign[(size_t)v * d + i];
  }
  __syncthreads();
  float* cur = S.H0;
  float* nxt = S.H1;
  for (int l = 0; l < L; ++l) {
    const int nin = nd.in[l], nout = nd.out[l];
    const float* W = S.P + nd.w[l];
    const float* B = S.P + nd.b[l];
    const float* M = S.P + nd.m[l];
    for (int q = tid; q < V * nout; q += nt) {
      const int v = q / nout, j = q % nout;
      float z = 0.f;
      for (int i = 0; i < nin; ++i) z = fmaf(cur[v * nd.maxw + i], W[i * nd.ldw[l] + j], z);
      z = z + B[j];
      nxt[v * nd.maxw + j] = l == L - 1 ? z : fmaxf(z, 0.f) * M[j];
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (warp == 0) {
    // First strict flip in (a, b) order (engine.find_flips_impl).
    int hit = -1;
    for (int q0 = 0; q0 < V * V && hit < 0; q0 += 32) {
      const int q = q0 + lane;
      bool flip = false;
      if (q < V * V) {
        const int a = q / V, b = q % V;
        if (A.vpair[q] && S.vld[a] > 0.f && S.vld[b] > 0.f) {
          const float la = cur[a * nd.maxw], lb = cur[b * nd.maxw];
          flip = (la > 0.f && lb < 0.f) || (la < 0.f && lb > 0.f);
        }
      }
      const unsigned m = __ballot_sync(CW_FULL, flip);
      if (m) hit = q0 + __ffs(m) - 1;
    }
    // Split choice: score x width over branchable dims, widest fallback,
    // the first maximum.
    float wmax = 0.f, scmax = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float w = (S.bh[i] - S.bl[i]) * A.bmask[i];
      wmax = fmaxf(wmax, w);
      scmax = fmaxf(scmax, S.sc[i] * w);
    }
    wmax = warp_max(wmax);
    scmax = warp_max(scmax);
    int dim = 0;
    float best = -FLT_MAX;
    for (int i0 = 0; i0 < d; i0 += 32) {
      const int i = i0 + lane;
      float sc = -FLT_MAX;
      if (i < d) {
        const float w = (S.bh[i] - S.bl[i]) * A.bmask[i];
        sc = scmax > 0.f ? S.sc[i] * w : w;
        if (!(A.bmask[i] > 0.f)) sc = -1.f;
      }
      const float m = warp_max(sc);
      if (m > best) {
        best = m;
        dim = i0 + __ffs(__ballot_sync(CW_FULL, sc == m)) - 1;
      }
    }
    if (lane == 0) {
      S.flags[3] = hit >= 0 && !A.found[slot];
      if (hit >= 0) {
        if (!A.found[slot]) {
          A.wit_a[slot] = hit / V;
          A.wit_b[slot] = hit % V;
        }
        A.found[slot] = 1;
      }
      const float mid = floorf((S.bl[dim] + S.bh[dim]) * 0.5f);
      A.scratch[slot] = make_int4(wmax > 0.f ? 1 : 0, dim, __float_as_int(mid), 1);
    }
  }
  __syncthreads();
  if (S.flags[3])
    for (int i = tid; i < d; i += nt)
      A.wit_pt[(size_t)slot * d + i] = floorf((S.bl[i] + S.bh[i]) * 0.5f);
}

// Exclusive count of `f` over the block's threads in thread order; *tot
// gets the block's count.  Two barriers; cnt holds >= 32 ints.
__device__ __forceinline__ int block_excl_count(bool f, int* cnt, int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  const unsigned m = __ballot_sync(CW_FULL, f);
  if (lane == 0) cnt[warp] = __popc(m);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nw; ++w) {
    before += w < warp ? cnt[w] : 0;
    all += cnt[w];
  }
  __syncthreads();
  *tot = all;
  return before + __popc(m & ((1u << lane) - 1u));
}

// Block 0: rank free slots and splitters in slot order, place children.
// Free slots (not live, not latched, not the canary) and splitters are
// disjoint, so a splitter writes its child as soon as it has its rank.
__device__ void compaction(const SegArgs& A, int d) {
  __shared__ int cnt[32];
  const int tid = threadIdx.x, nt = blockDim.x, Qs = A.Qs;
  int nf = 0, tot = 0;
  for (int i0 = 0; i0 < Qs; i0 += nt) {
    const int i = i0 + tid;
    const bool f = i < Qs && !A.q_live[i] && A.slot_ok[i] && !A.found[i];
    const int rank = nf + block_excl_count(f, cnt, &tot);
    if (f) A.table[rank] = i;
    nf += tot;
  }
  int nc = 0;
  for (int i0 = 0; i0 < Qs; i0 += nt) {
    const int i = i0 + tid;
    const bool f = i < Qs && A.scratch[i].x != 0;
    const int rank = nc + block_excl_count(f, cnt, &tot);
    nc += tot;
    if (!f) continue;
    const int root = A.q_root[i];
    if (rank >= nf) {
      atomicAdd(&A.overflow[root], 1);
      continue;
    }
    atomicAdd(&A.splits[root], 1);
    const int dst = A.table[rank];
    const int4 sc = A.scratch[i];
    const float mid = __int_as_float(sc.z);
    for (int j = 0; j < d; ++j) {
      const float lo = A.q_lo[(size_t)i * d + j], hi = A.q_hi[(size_t)i * d + j];
      A.q_lo[(size_t)dst * d + j] = j == sc.y ? mid + 1.f : lo;
      A.q_hi[(size_t)dst * d + j] = hi;
    }
    A.q_hi[(size_t)i * d + sc.y] = mid;
    A.q_root[dst] = root;
    A.q_live[dst] = 1;
  }
  __syncthreads();
}

__device__ void fold_all(const SegArgs& A, int d) {
  unsigned s = 0u;
  const int tid = threadIdx.x, nt = blockDim.x, Qs = A.Qs;
  for (int i = tid; i < Qs * d; i += nt)
    s += (unsigned)(int)A.q_lo[i] + (unsigned)(int)A.q_hi[i] + (unsigned)(int)A.wit_pt[i];
  for (int i = tid; i < Qs; i += nt)
    s += (unsigned)A.q_root[i] + (unsigned)A.q_live[i] + (unsigned)A.found[i] +
         (unsigned)A.wit_a[i] + (unsigned)A.wit_b[i];
  for (int g = tid; g < A.G; g += nt)
    s += (unsigned)A.nodes[g] + (unsigned)A.splits[g] + (unsigned)A.overflow[g];
  atomicAdd(A.fold, s);
}

__global__ void __launch_bounds__(K6_MAX_WARPS * 32)
k6_kernel(NetDesc nd, SegArgs A) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], tid = threadIdx.x, nt = blockDim.x;
  const K6Layout o = k6_layout(nd, A.V, nt >> 5);
  SlotSmem S;
  S.P = smem + o.net;
  S.roles = smem + o.roles;
  S.rws = o.rws;
  S.warps = smem + o.warps;
  S.wws = o.wws;
  S.F = smem + o.F;
  S.PW = smem + o.PW;
  S.bl = smem + o.box;
  S.bh = S.bl + d;
  S.absb = S.bh + d;
  S.shr = S.absb + d;
  S.nlo = S.shr + d;
  S.nhi = S.nlo + d;
  S.sc = S.nhi + d;
  S.H0 = smem + o.H0;
  S.H1 = smem + o.H1;
  S.vld = smem + o.vld;
  S.best = smem + o.best;
  S.flags = reinterpret_cast<int*>(smem + o.flags);
  __shared__ int s_slot;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);

  stage_net(S.P, A.params, cw_round4(nd.total), bar);
  for (int i = tid; i < d; i += nt) S.shr[i] = 1.f - A.pam[i];
  mbar_wait(bar, 0);
  __syncthreads();
  for (int round = 0; round < A.rounds; ++round) {
    for (;;) {
      if (tid == 0) s_slot = atomicAdd(&A.next[round], 1);
      __syncthreads();
      const int slot = s_slot;
      __syncthreads();
      if (slot >= A.Qs) break;
      if (A.q_live[slot]) {
        slot_phase(nd, A, S, slot);
      } else if (tid == 0) {
        A.scratch[slot] = make_int4(0, 0, 0, 0);
      }
    }
    grid.sync();
    if (blockIdx.x == 0) compaction(A, d);
    grid.sync();
  }
  if (blockIdx.x == 0) fold_all(A, d);
}

// Dynamic shared memory of one block (engine.bab_smem).
static inline long long k6_smem(const NetDesc& nd, int V, int warps) {
  return 4LL * k6_layout(nd, V, warps).total;
}

// The launch geometry comes from the wrapper (engine.bab_geometry: warps
// per block, grid, shared-memory bytes); it is checked here against the
// net, the kernel's limits and the card's residency for the cooperative
// launch.  params is cuda_build.pack_odd's buffer, padded to 16 bytes.
extern "C" int k6_bab_segment(const void* params, const int* dims, int L, void* q_lo,
                              void* q_hi, void* q_root, void* q_live, void* found,
                              void* wit_a, void* wit_b, void* wit_pt, void* nodes,
                              void* splits, void* overflow, const void* slot_ok,
                              const void* root_valid, const void* assign, const void* pam,
                              const void* ram, const void* vpair, const void* bmask,
                              float eps, int Qs, int G, int V, int rounds,
                              int alpha_iters, void* scratch, void* table, void* next,
                              void* fold, int warps, int grid, long long smem,
                              void* stream) {
  NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
  if (warps < 1 || warps > K6_MAX_WARPS || grid < 1 || smem != k6_smem(nd, V, warps) ||
      smem > SMEM_LIMIT || nd.out[L - 1] != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(k6_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k6_kernel, 32 * warps,
                                                           (size_t)smem)) != cudaSuccess)
    return (int)err;
  if ((long long)grid > (long long)per_sm * nsm) return (int)cudaErrorCooperativeLaunchTooLarge;
  SegArgs A;
  A.params = (const float*)params;
  A.q_lo = (float*)q_lo;
  A.q_hi = (float*)q_hi;
  A.q_root = (int*)q_root;
  A.q_live = (uint8_t*)q_live;
  A.found = (uint8_t*)found;
  A.wit_a = (int*)wit_a;
  A.wit_b = (int*)wit_b;
  A.wit_pt = (float*)wit_pt;
  A.nodes = (int*)nodes;
  A.splits = (int*)splits;
  A.overflow = (int*)overflow;
  A.slot_ok = (const uint8_t*)slot_ok;
  A.root_valid = (const uint8_t*)root_valid;
  A.assign = (const float*)assign;
  A.pam = (const float*)pam;
  A.ram = (const float*)ram;
  A.vpair = (const uint8_t*)vpair;
  A.bmask = (const float*)bmask;
  A.eps = eps;
  A.Qs = Qs;
  A.G = G;
  A.V = V;
  A.rounds = rounds;
  A.alpha_iters = alpha_iters;
  A.scratch = (int4*)scratch;
  A.table = (int*)table;
  A.next = (int*)next;
  A.fold = (unsigned*)fold;
  void* args[] = {(void*)&nd, (void*)&A};
  err = cudaLaunchCooperativeKernel((const void*)k6_kernel, dim3(grid), dim3(32 * warps), args,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
