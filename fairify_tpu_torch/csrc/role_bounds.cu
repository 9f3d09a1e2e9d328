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
//   * CROWN (use_crown = 1): crown.cuh:crown_role_forms, whose widened
//     output bounds are ops/crown.py:crown_output_bounds (crown_bounds with
//     widening), JAX's other branch of the lax.cond.
//
// Bound on the H100: fp32 FMA throughput — IBP takes 4 FMAs per weight and
// role box (8 * sum(in_l * out_l) flops; 0.82 GFLOP for one 2,048-box AC-S1
// chunk at V = 2, 12 us at the fp32 peak); the bytes (2d floats in, 2 out per
// role box) are under 1 MB.  Each layer depends on the one before, so at
// these sizes the kernel is bound by latency and launch, not by the peak.
//
// K7 (k7_alpha_output_bounds) — α-CROWN output bounds of B plain boxes:
// fairify_tpu/ops/crown.py:alpha_crown_output_bounds.  Per box,
// crown_role_forms (plain CROWN, widened) and then crown.cuh:alpha_role_forms,
// KB's α mode: iters signed-gradient steps on the lower slopes of the
// unstable neurons from the adaptive slopes, the best bounds kept over every
// iterate including the final one, widened once and intersected with plain
// CROWN, so never looser than it.  Bound: fp32 FMA throughput of
// 2 * iters + 1 chain evaluations and iters reverse passes per box on top of
// the CROWN passes; one block per box, the same shared-memory layout.
//
// Design: one block per (box, role), blockIdx.x = 2 * box + role;
// blockIdx.y the model of a stacked family, whose packed net starts at
// m * nd.total floats.  The block stages the packed net in shared memory
// once and walks its box's V role boxes in turn: in IBP mode one thread per
// neuron of the current layer with the layer's input interval in shared
// memory, in CROWN mode the whole block on crown_role_forms.  Output
// (lo, hi) of model m, role r, box b, assignment v at
// (m * 2 + r) * B * V + b * V + v.
#include "common.cuh"
#include "crown.cuh"

#define K10B_IBP_THREADS 128
#define K10B_CROWN_THREADS 256

__global__ void __launch_bounds__(K10B_CROWN_THREADS)
k10b_kernel(NetDesc nd, int maxA, const float* __restrict__ params,
            const float* __restrict__ xlo, const float* __restrict__ xhi,
            const float* __restrict__ plo, const float* __restrict__ phi,
            int nbox, int V, int use_crown, float* __restrict__ out_lo,
            float* __restrict__ out_hi) {
  extern __shared__ float smem[];
  const int d = nd.in[0], L = nd.L, tid = threadIdx.x, nt = blockDim.x;
  const int box = blockIdx.x >> 1, role = blockIdx.x & 1, m = blockIdx.y;
  float* P = smem;
  const float* Pm = params + (size_t)m * nd.total;
  for (int i = tid; i < nd.total; i += nt) P[i] = Pm[i];
  const float* src_lo = role ? plo : xlo;
  const float* src_hi = role ? phi : xhi;
  const size_t out0 = ((size_t)m * 2 + role) * nbox * V + (size_t)box * V;

  if (use_crown) {
    CrownWs ws;
    float* f = crown_ws_carve(ws, P + nd.total, nd, maxA);  // 2d + 4 forms
    for (int v = 0; v < V; ++v) {
      const size_t row = (size_t)box * V + v;
      __syncthreads();  // P staged; the previous role box's forms read
      for (int i = tid; i < d; i += nt) {
        ws.inlo[i] = src_lo[row * d + i];
        ws.inhi[i] = src_hi[row * d + i];
      }
      __syncthreads();
      crown_role_forms(nd, maxA, P, ws, f);
      if (tid == 0) {
        out_lo[out0 + v] = f[2 * d + 2];
        out_hi[out0 + v] = f[2 * d + 3];
      }
    }
    return;
  }

  float* rlo = P + nd.total;  // the current layer's input interval
  float* rhi = rlo + nd.maxw;
  float* zlo = rhi + nd.maxw;  // its widened output interval
  float* zhi = zlo + nd.maxw;
  for (int v = 0; v < V; ++v) {
    const size_t row = (size_t)box * V + v;
    __syncthreads();  // P staged; the previous role box's output read
    for (int i = tid; i < d; i += nt) {
      rlo[i] = src_lo[row * d + i];
      rhi[i] = src_hi[row * d + i];
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int nin = nd.in[l], nout = nd.out[l];
      const float* W = P + nd.w[l];
      const float* Bl = P + nd.b[l];
      for (int j = tid; j < nout; j += nt) {
        float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
        for (int i = 0; i < nin; ++i) {
          const float w = W[i * nout + j];
          const float wp = fmaxf(w, 0.f), wn = fminf(w, 0.f);
          a1 = fmaf(rlo[i], wp, a1);
          a2 = fmaf(rhi[i], wn, a2);
          a3 = fmaf(rhi[i], wp, a3);
          a4 = fmaf(rlo[i], wn, a4);
        }
        const float lo = (a1 + a2) + Bl[j], hi = (a3 + a4) + Bl[j];
        const float slack = SLACK_REL * fmaxf(fabsf(lo), fabsf(hi)) + SLACK_ABS;
        zlo[j] = lo - slack;
        zhi[j] = hi + slack;
      }
      __syncthreads();
      if (l < L - 1) {
        const float* Ml = P + nd.m[l];
        for (int j = tid; j < nout; j += nt) {
          rlo[j] = fmaxf(zlo[j], 0.f) * Ml[j];
          rhi[j] = fmaxf(zhi[j], 0.f) * Ml[j];
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      out_lo[out0 + v] = zlo[0];
      out_hi[out0 + v] = zhi[0];
    }
  }
}

__global__ void __launch_bounds__(K10B_CROWN_THREADS)
k7_kernel(NetDesc nd, int maxA, const float* __restrict__ params,
          const float* __restrict__ lo, const float* __restrict__ hi, int iters,
          float* __restrict__ out_lo, float* __restrict__ out_hi) {
  extern __shared__ float smem[];
  const int d = nd.in[0], tid = threadIdx.x, nt = blockDim.x, b = blockIdx.x;
  float* P = smem;
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  CrownWs ws;
  AlphaWs aw;
  float* fp = crown_ws_carve(ws, P + nd.total, nd, maxA);  // plain set: 2d + 4
  float* ft = fp + 2 * d + 4;                                // tuned set: 2d + 4
  alpha_ws_carve(aw, ft + 2 * d + 4, nd);
  for (int i = tid; i < d; i += nt) {
    ws.inlo[i] = lo[(size_t)b * d + i];
    ws.inhi[i] = hi[(size_t)b * d + i];
  }
  __syncthreads();
  crown_role_forms(nd, maxA, P, ws, fp);
  if (iters > 0 && nd.L > 1) alpha_role_forms(nd, P, ws, aw, iters, fp, ft);
  if (tid == 0) {
    out_lo[b] = fp[2 * d + 2];
    out_hi[b] = fp[2 * d + 3];
  }
}

extern "C" int k7_alpha_output_bounds(const void* params, const int* dims, int L,
                                      const void* lo, const void* hi, int B, int iters,
                                      void* out_lo, void* out_hi, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const int maxA = crown_max_a(nd), d = nd.in[0];
  const size_t smem = sizeof(float) * (nd.total + crown_ws_floats(nd, maxA)
                                       + 2 * (2 * d + 4) + alpha_ws_floats(nd));
  cudaError_t err = set_smem(k7_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    k7_kernel<<<B, K10B_CROWN_THREADS, smem, (cudaStream_t)stream>>>(
        nd, maxA, (const float*)params, (const float*)lo, (const float*)hi, iters,
        (float*)out_lo, (float*)out_hi);
  return (int)cudaGetLastError();
}

extern "C" int k10_role_bounds(const void* params, const int* dims, int L,
                               const void* xlo, const void* xhi, const void* plo,
                               const void* phi, int B, int V, int M, int use_crown,
                               void* out_lo, void* out_hi, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const int maxA = crown_max_a(nd), d = nd.in[0];
  const size_t ws = use_crown ? (size_t)crown_ws_floats(nd, maxA) + 2 * d + 4
                              : (size_t)4 * nd.maxw;
  const size_t smem = sizeof(float) * (nd.total + ws);
  cudaError_t err = set_smem(k10b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && V > 0 && M > 0)
    k10b_kernel<<<dim3(2u * (unsigned)B, (unsigned)M),
                  use_crown ? K10B_CROWN_THREADS : K10B_IBP_THREADS, smem,
                  (cudaStream_t)stream>>>(
        nd, maxA, (const float*)params, (const float*)xlo, (const float*)xhi,
        (const float*)plo, (const float*)phi, B, V, use_crown, (float*)out_lo,
        (float*)out_hi);
  return (int)cudaGetLastError();
}
