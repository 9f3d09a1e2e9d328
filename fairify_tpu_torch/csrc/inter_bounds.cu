// K8b — CROWN pre-activation bounds of every layer, boxes side by side.
//
// Replaces fairify_tpu/verify/engine.py:_inter_bounds_kernel
// (ops/crown.py:crown_bounds): IBP for layer 0, then for every deeper layer a
// CROWN backward pass (triangle ReLU relaxation, adaptive lower slope)
// concretized over the box, intersected with IBP and widened outward.  The
// engine's Phase L feeds these bounds to the host LP BaB of each sign
// candidate (a frontier_size batch a launch, its candidates the live rows),
// Phase P to the pair LP of each unknown root (its 2V role boxes).
//
// Bound on the H100: fp32 FMA throughput of the backward passes (sum over
// layers k >= 1, over j < k, of in_j * out_j * out_k MACs per box, ~0.8 M at
// AC-S1 widths); the bytes (2d floats in, 2 * sum(n_k) out per box) are small.
//
// Design (crown_warp.cuh): a block takes `per` boxes and runs the forms
// stage KB and K6 share, role_forms_stage, without output forms: layer by
// layer the IBP of every (box, unit) with a thread per item, then every
// backward-pass column pair of every box on a warp (crown_columns), which
// widens the layer's bounds into the box's workspace; about 2L block
// barriers, no coefficient matrix in shared memory.  The odd-stride net
// (cuda_build.pack_odd) is staged once per block by one bulk copy.  Then the
// block writes every layer's widened bounds out.  The launch geometry
// (warps and boxes a block) comes from the wrapper
// (engine.inter_bounds_geometry: many boxes take several a block at two
// blocks an SM, a few take one a block and a warp per column pair of the
// widest layer), and the entry point refuses any other shared-memory size.
// The grid covers the live rows only; a second small kernel copies row
// live - 1's outputs to the padded rows past it (engine._pad repeats its
// inputs there).  Sums are crown_warp.cuh's (the constant terms by XOR
// trees), so the bounds may differ from the plain version's in the last
// bits, and do not depend on the geometry.
#include "common.cuh"
#include "crown_warp.cuh"
#include "warp_tile.cuh"

#define K8B_MAX_WARPS 16

// Float offsets of one block's shared memory: the mbarrier's 4, the
// odd-stride net, the boxes' workspaces, the warps' column-pair scratch
// (engine.inter_bounds_smem is the same sum).
struct IbLayout {
  int net, roles, rws, warps, wws, total;
};

__host__ __device__ inline IbLayout ib_layout(const NetDesc& nd, int per, int warps) {
  IbLayout o;
  o.net = 4;
  o.roles = o.net + cw_round4(nd.total);
  o.rws = role_ws_floats(nd);
  o.warps = o.roles + per * o.rws;
  o.wws = cw_round4(8 * nd.maxw);
  o.total = o.warps + warps * o.wws;
  return o;
}

__global__ void __launch_bounds__(K8B_MAX_WARPS * 32)
k8b_kernel(NetDesc nd, const float* __restrict__ params, const float* __restrict__ lo,
           const float* __restrict__ hi, int live, int per, float* __restrict__ out_lb,
           float* __restrict__ out_ub) {
  extern __shared__ __align__(16) float smem[];
  const int d = nd.in[0], ns = nd.nsum, tid = threadIdx.x, nt = blockDim.x;
  const IbLayout o = ib_layout(nd, per, nt >> 5);
  float* P = smem + o.net;
  float* roles = smem + o.roles;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int b0 = blockIdx.x * per, nb = min(per, live - b0);

  stage_net(P, params, cw_round4(nd.total), bar);
  for (int q = tid; q < nb * d; q += nt) {
    const int rv = q / d, i = q - rv * d;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    R.inlo[i] = lo[(size_t)(b0 + rv) * d + i];
    R.inhi[i] = hi[(size_t)(b0 + rv) * d + i];
  }
  mbar_wait(bar, 0);
  __syncthreads();
  role_forms_stage(nd, P, roles, o.rws, smem + o.warps, o.wws, nb, nullptr, 0, nullptr, 0);
  for (int q = tid; q < nb * ns; q += nt) {
    const int rv = q / ns, i = q - rv * ns;
    const RoleWs R = role_ws(roles + rv * o.rws, nd);
    out_lb[(size_t)(b0 + rv) * ns + i] = R.wslb[i];
    out_ub[(size_t)(b0 + rv) * ns + i] = R.wsub[i];
  }
}

// Dynamic shared memory of one block (engine.inter_bounds_smem).
static inline long long k8b_smem(const NetDesc& nd, int per, int warps) {
  return 4LL * ib_layout(nd, per, warps).total;
}

// The launch geometry comes from the wrapper (engine.inter_bounds_geometry:
// warps a block, boxes a block, shared-memory bytes) and is checked here
// against the net and the kernel's limits.  params is cuda_build.pack_odd's
// buffer, padded to 16 bytes.  Blocks: the live rows of B, `per` a block.
extern "C" int k8b_inter_bounds(const void* params, const int* dims, int L, const void* lo,
                                const void* hi, int B, int live, void* out_lb, void* out_ub,
                                int warps, int per, long long smem, void* stream) {
  const NetDesc nd = make_desc(dims, L, /*odd_rows=*/true);
  if (warps < 1 || warps > K8B_MAX_WARPS || per < 1 || smem != k8b_smem(nd, per, warps) ||
      smem > SMEM_LIMIT || live < 0 || live > B || (B > 0 && live < 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(k8b_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0)
    k8b_kernel<<<(live + per - 1) / per, 32 * warps, (size_t)smem, (cudaStream_t)stream>>>(
        nd, (const float*)params, (const float*)lo, (const float*)hi, live, per,
        (float*)out_lb, (float*)out_ub);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fill_past((float*)out_lb, 1, B, live, nd.nsum, stream);
  fill_past((float*)out_ub, 1, B, live, nd.nsum, stream);
  return (int)cudaGetLastError();
}
