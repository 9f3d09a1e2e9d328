// K8b — CROWN pre-activation bounds of every layer, one box per block.
//
// Replaces fairify_tpu/verify/engine.py:_inter_bounds_kernel
// (ops/crown.py:crown_bounds): IBP for layer 0, then for every deeper layer a
// CROWN backward pass (triangle ReLU relaxation, adaptive lower slope)
// concretized over the box, intersected with IBP and widened outward.  The
// engine's Phase L feeds these bounds to the host LP BaB of each sign
// candidate (B = frontier_size boxes per launch), Phase P to the pair LP of
// each unknown root (B = 2V role boxes).
//
// Bound on the H100: fp32 FMA throughput of the backward passes (sum over
// layers k >= 1, over j < k, of in_j * out_j * out_k MACs per box, ~0.8 M at
// AC-S1 widths); the bytes (2d floats in, 2 * sum(n_k) out per box) are small.
//
// Design: crown.cuh:crown_role_forms, the block-wide CROWN of one role box
// (row 13's CROWN mode runs it too) — the packed network, the layer bounds and the backward pass's
// coefficient matrices in dynamic shared memory — and then the block writes
// the widened bounds of every layer out.
#include "common.cuh"
#include "crown.cuh"

#define K8B_THREADS 256

__global__ void __launch_bounds__(K8B_THREADS)
k8b_kernel(NetDesc nd, int maxA, const float* __restrict__ params,
           const float* __restrict__ lo, const float* __restrict__ hi,
           float* __restrict__ out_lb, float* __restrict__ out_ub) {
  extern __shared__ float smem[];
  const int d = nd.in[0], b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* P = smem;
  CrownWs ws;
  float* f = crown_ws_carve(ws, P + nd.total, nd, maxA);  // 2d + 4 forms
  for (int i = tid; i < nd.total; i += nt) P[i] = params[i];
  for (int i = tid; i < d; i += nt) {
    ws.inlo[i] = lo[(size_t)b * d + i];
    ws.inhi[i] = hi[(size_t)b * d + i];
  }
  __syncthreads();
  crown_role_forms(nd, maxA, P, ws, f);
  for (int i = tid; i < nd.nsum; i += nt) {
    out_lb[(size_t)b * nd.nsum + i] = ws.wslb[i];
    out_ub[(size_t)b * nd.nsum + i] = ws.wsub[i];
  }
}

extern "C" int k8b_inter_bounds(const void* params, const int* dims, int L,
                                const void* lo, const void* hi, int B, void* out_lb,
                                void* out_ub, void* stream) {
  const NetDesc nd = make_desc(dims, L);
  const int maxA = crown_max_a(nd), d = nd.in[0];
  const size_t smem = sizeof(float) * (nd.total + crown_ws_floats(nd, maxA) + 2 * d + 4);
  cudaError_t err = set_smem(k8b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    k8b_kernel<<<B, K8B_THREADS, smem, (cudaStream_t)stream>>>(
        nd, maxA, (const float*)params, (const float*)lo, (const float*)hi,
        (float*)out_lb, (float*)out_ub);
  return (int)cudaGetLastError();
}
