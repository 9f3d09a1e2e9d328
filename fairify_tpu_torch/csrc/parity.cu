// KD — the parity pass: pruned-vs-original prediction agreement.
//
// Replaces fairify_tpu/verify/sweep.py:_mega_parity_kernel (the lax.scan of
// _parity_grid_from_keys; one launch per segment) and
// _parity_grid_from_keys itself (the chunk loop, mega_chunks = 0: one launch
// per chunk).  Per partition, regenerate the same sim_size threefry samples
// as the prune pass (same key, same randint), run the forward of the
// original net and of the masked net (hidden layers use the partition's
// alive mask, the last layer stays all ones), and return the fraction of
// samples whose `logit > 0` predictions agree.
//
// Bound on the H100: fp32 FMA throughput — two forwards per sample that
// share layer 0's pre-activation (a mask acts only after the ReLU), 2 *
// sim_size * (2 sum(in_l * out_l) - in_0 * out_0) flops per partition
// (5.73 ms on an 8,192-partition AC-S1 segment at the fp32 peak) — and the
// draw's integer work, as KA; the bytes (boxes, masks in; one float per
// partition out) are negligible.
//
// Design (sim_tile.cuh): KA's warp tiles and geometry.  A warp runs its
// tile's layer 0 once and builds two hidden tiles from it, one masked by
// the net's own mask and one by the partition's alive mask, carries each
// through the remaining layers, and counts the agreeing valid rows of the
// two logits with one ballot.  The parity is agree * (1 / S), equal to the
// one-block-per-partition kernel it replaces bit for bit under every
// geometry.  The launch covers the live rows; fill_past gives the rows past
// them row live - 1's parity.
#include "common.cuh"
#include "sim_tile.cuh"
#include "warp_tile.cuh"

// KD's epilogue.  Hidden: oa = max(z, 0) * ma and, given ob, ob = max(z,
// 0) * mb (layer 0 of both nets).  Logit: unit 0's z to lga and, given
// lgb, to lgb (a net with no hidden layer: both nets are one).
struct ParityEpi : NoItemState {
  const float* bias;
  const float* ma;
  const float* mb;
  float* oa;
  float* ob;
  float* lga;
  float* lgb;
  int tw, smask;
  bool logit;

  template <int RR, int RC>
  __device__ __forceinline__ void apply(int, int j, int rg, int RG, const float (&v)[RR],
                                        uint64_t&) const {
    if (logit) {
      if (j != 0) return;
      const float b0 = bias[0];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int row = 4 * (rg + (r / 4) * RG) + r % 4;
        const float z = v[r] + b0;
        lga[row] = z;
        if (lgb != nullptr) lgb[row] = z;
      }
      return;
    }
    const float bj = bias[j];
    float z[RR], o[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) z[r] = v[r] + bj;
    const float mj = ma[j];
#pragma unroll
    for (int r = 0; r < RR; ++r) o[r] = fmaxf(z[r], 0.f) * mj;
    tile_store<RR>(oa, j, rg, RG, tw, smask, o);
    if (ob != nullptr) {
      const float nj = mb[j];
#pragma unroll
      for (int r = 0; r < RR; ++r) o[r] = fmaxf(z[r], 0.f) * nj;
      tile_store<RR>(ob, j, rg, RG, tw, smask, o);
    }
  }
};

__global__ void __launch_bounds__(SIM_MAX_WARPS * 32, 1)
kd_kernel(PadDesc pd, const float* __restrict__ params, const uint32_t* __restrict__ keys,
          const float* __restrict__ lo, const float* __restrict__ hi,
          const float* __restrict__ alive, int S, int tw, int T, int tpb, long long ntiles,
          float* __restrict__ out, int* ws) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = pd.in[0], L = pd.L, nhid = sim_nhid(pd);
  const SimBlock b = sim_block(P + pd.fwd, pd, SIM_KD, T, tpb, ntiles);
  sim_setup(b, pd, SIM_KD, keys, lo, hi);
  for (int i = tid; i < b.nq * nhid; i += blockDim.x)
    b.extra[i] = alive[(size_t)b.pA * nhid + i];
  stage_net(P, params, pd.fwd, bar);
  mbar_wait(bar, 0);

  const int smask = swz_mask(tw);
  const SimBufs nb = sim_bufs(pd);
  float* O = b.tiles + warp * sim_warp_floats(pd, SIM_KD, tw);
  float* EA = O + nb.o * tw;
  float* EB = EA + nb.e * tw;
  float* lgA = EB + nb.e * tw;
  float* lgB = lgA + tw;
  const uint32_t tiles_f = pick_tiles(L, tw, [&](int l) { return pd.out[l]; });

  for (long long g = sim_next_tile(b, lane); g >= 0; g = sim_next_tile(b, lane)) {
    const int q = (int)(g / T) - b.pA;
    const int r0 = (int)(g - (long long)(b.pA + q) * T) * tw;
    const int nvalid = min(tw, S - r0);
    const float* al = b.extra + q * nhid;
    sim_draw(b, q, d, O, tw, smask, r0, nvalid, lane);
    __syncwarp();
    ParityEpi e;
    e.tw = tw;
    e.smask = smask;
    // Layer 0 once: both nets' hidden tiles (or both logits).
    e.bias = P + pd.b[0];
    e.logit = L == 1;
    e.ma = P + pd.m[0];
    e.mb = al;
    e.oa = EA;
    e.ob = EB;
    e.lga = lgA;
    e.lgb = lgB;
    warp_layer(tiles_f & 7, O, tw, smask, P + pd.w[0], pd.ldw[0], d, pd.out[0], lane, e);
    __syncwarp();
    // Layers 1 .. L - 1 of the original net (pass 0), then of the masked one.
    e.ob = nullptr;
    e.lgb = nullptr;
    for (int pass = 0; pass < 2; ++pass) {
      float* Ep = pass ? EB : EA;
      int aoff = pd.out[0];
      for (int l = 1; l < L; ++l) {
        e.bias = P + pd.b[l];
        e.logit = l + 1 == L;
        e.ma = pass ? al + aoff : P + pd.m[l];
        e.oa = (l & 1) ? O : Ep;
        e.lga = pass ? lgB : lgA;
        warp_layer((tiles_f >> (3 * l)) & 7, (l & 1) ? Ep : O, tw, smask, P + pd.w[l],
                  pd.ldw[l], pd.in[l], pd.out[l], lane, e);
        __syncwarp();
        aoff += pd.out[l];
      }
    }
    const bool agree = lane < nvalid && ((lgA[lane] > 0.f) == (lgB[lane] > 0.f));
    const uint32_t m = __ballot_sync(0xffffffffu, agree);
    if (lane == 0 && m) atomicAdd(&b.cnt[q], __popc(m));
    __syncwarp();
  }
  __syncthreads();
  const float inv = 1.f / (float)S;  // XLA's mean: sum * (1 / S)
  sim_finish(b, 1, T, tpb, ws, [&](int p, int, int c) { out[p] = (float)c * inv; });
}

// The geometry as KA's (verify/pruning.py:sim_geometry with kind "kd").
// `keys`: (at least live) x 2 int64 of uint32 values; `alive`: the live
// rows' hidden alive masks, (at least live) x nhid;
// `ws`: live * 2 zeroed ints when tpb < T; `out`: rows floats.
extern "C" int kd_parity(const void* params, const int* dims, int L, const void* keys,
                         const void* lo, const void* hi, const void* alive, int nhid,
                         int rows, int live, int S, void* out, void* ws, int tw, int warps,
                         int tpb, int grid, long long smem, void* stream) {
  if (L < 1 || L > MAX_LAYERS || dims[L] != 1 || rows < 0 || live > rows ||
      (rows > 0 && live < 1))
    return (int)cudaErrorInvalidValue;
  const PadDesc pd = make_pad_desc(dims, L);
  if (nhid != sim_nhid(pd) || !sim_geometry_ok(pd, SIM_KD, S, live, tw, warps, tpb, grid, smem))
    return (int)cudaErrorInvalidValue;
  const int T = (S + tw - 1) / tw;
  if (tpb < T && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kd_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0)
    kd_kernel<<<(unsigned)grid, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
        pd, (const float*)params, (const uint32_t*)keys, (const float*)lo, (const float*)hi,
        (const float*)alive, S, tw, T, tpb, (long long)live * T, (float*)out, (int*)ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fill_past((float*)out, 1, rows, live, 1, stream);
  return (int)cudaGetLastError();
}

// Registers a thread of KD uses as built, or -1 (verify/pruning.py:sim_regs).
extern "C" int kd_regs(int) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kd_kernel) == cudaSuccess ? a.numRegs : -1;
}
