// KA — the prune pass: simulation statistics + IBP bounds per partition.
//
// Replaces fairify_tpu/verify/pruning.py:_mega_sim_and_bounds (the lax.scan
// over chunks of _sim_and_bounds; one launch per segment) and
// _sim_and_bounds itself (the chunk loop, mega_chunks = 0: one launch per
// chunk; the host then sums the looseness of the real rows in f64, as the
// JAX package does).  Every output is per partition, so a launch over one
// chunk's rows computes exactly that chunk.  Per partition, sim_size
// uniform integer samples from the box (jax.random.randint under the
// partition's threefry key), the masked forward of every sample, each
// neuron's activation count (candidates = never active, pos_prob = count *
// (1 / sim_size), the f32 arithmetic of XLA's mean), the widened IBP
// pre-activation bounds lb@W+ + ub@W- of every layer, and the per-layer sum
// of (ub - lb) (looseness telemetry).
//
// Bound on the H100: fp32 FMA throughput of the forward, 2 * sim_size *
// sum(in_l * out_l) flops per partition (2.06e11 on an 8,192-partition
// AC-S1 segment, 3.08 ms at the fp32 peak), and the draw's integer work
// (two threefry2x32 and three `% span` a value, sim_size * d values a
// partition), which at GC-1's widths (20-50-1) is larger; the bytes are
// boxes in and per-neuron rows out, a few MB.
//
// Design (sim_tile.cuh): warps carry tiles of TW samples of one partition
// through every layer with __syncwarp only, drawing their own inputs, and
// count activations from the epilogue; the net is staged by one bulk copy.
// The IBP half runs on warp 0 of the block that holds the partition's
// first tile, a thread per unit as before (the four index-ordered fmaf
// chains, the widening and the looseness sum), beside the simulation warps.
// Every output equals the one-block-per-partition kernel it replaces bit
// for bit, under every geometry.  One output buffer (rows, 4 nsum + L):
// per row cand | pos | wslb | wsub (nsum each) | loos (L); the launch
// covers the live rows and fill_past gives the rows past them row live - 1's.
//
// ka_sim_stats is the simulation half alone: row 3,
// fairify_tpu/verify/pruning.py:_sim_stats, which harsh_prune_grid launches
// once over the whole grid.  The samples come from the keys and the box
// integers alone, so skipping the IBP half changes no sample, count or
// pos_prob: its candidates equal the full launch's bit for bit.  Output
// (rows, 2 nsum): cand | pos.  Bound: the same forward flops and draw.
#include "common.cuh"
#include "sim_tile.cuh"
#include "warp_tile.cuh"

// KA's epilogue: hidden layers write max(z, 0) * mask to the next buffer;
// every layer counts, per unit, the tile's valid rows whose output (the
// logit itself on the last layer) is nonzero.
struct CountEpi : NoItemState {
  const float* bias;
  const float* mask;
  float* out;
  int* cnt;
  int nvalid, tw, smask;
  bool hidden;

  template <int RR, int RC>
  __device__ __forceinline__ void apply(int, int j, int rg, int RG, const float (&v)[RR],
                                        uint64_t&) const {
    const float bj = bias[j], mj = mask[j];
    float o[RR];
    uint32_t nz = 0;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const float z = v[r] + bj;
      o[r] = hidden ? fmaxf(z, 0.f) * mj : z;
      if (o[r] != 0.f && 4 * (rg + (r / 4) * RG) + r % 4 < nvalid) nz |= 1u << r;
    }
    if (hidden) tile_store<RR>(out, j, rg, RG, tw, smask, o);
    if (nz) atomicAdd(&cnt[j], __popc(nz));
  }
};

// The IBP half for one partition on one warp: per layer a lane per unit
// (strided), the widened bounds to wslb / wsub of the output row, the next
// layer's intervals (ReLU and mask on hidden layers) and, by lane 0 in unit
// order, the looseness sum.  `s`: 5 maxw floats of scratch.
__device__ __forceinline__ void ka_ibp(const PadDesc& pd, const float* P,
                                       const float* __restrict__ lo,
                                       const float* __restrict__ hi, float* s, int maxw,
                                       int nsum, float* __restrict__ orow, int lane) {
  float* blo = s;
  float* bhi = s + maxw;
  float* nlo = s + 2 * maxw;
  float* nhi = s + 3 * maxw;
  float* red = s + 4 * maxw;
  for (int j = lane; j < pd.in[0]; j += 32) {
    blo[j] = lo[j];
    bhi[j] = hi[j];
  }
  __syncwarp();
  int noff = 0;
  for (int l = 0; l < pd.L; ++l) {
    const int nin = pd.in[l], nout = pd.out[l], ldw = pd.ldw[l];
    const float* W = P + pd.w[l];
    const float* B = P + pd.b[l];
    const float* M = P + pd.m[l];
    const bool hidden = l + 1 < pd.L;
    for (int j = lane; j < nout; j += 32) {
      float a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
      for (int i = 0; i < nin; ++i) {
        const float w = W[i * ldw + j];
        const float wp = fmaxf(w, 0.f), wn = fminf(w, 0.f);
        a1 = fmaf(blo[i], wp, a1);
        a2 = fmaf(bhi[i], wn, a2);
        a3 = fmaf(bhi[i], wp, a3);
        a4 = fmaf(blo[i], wn, a4);
      }
      float zlo = (a1 + a2) + B[j], zhi = (a3 + a4) + B[j];
      const float slack = SLACK_REL * fmaxf(fabsf(zlo), fabsf(zhi)) + SLACK_ABS;
      zlo -= slack;
      zhi += slack;
      orow[2 * nsum + noff + j] = zlo;
      orow[3 * nsum + noff + j] = zhi;
      nlo[j] = hidden ? fmaxf(zlo, 0.f) * M[j] : zlo;
      nhi[j] = hidden ? fmaxf(zhi, 0.f) * M[j] : zhi;
      red[j] = zhi - zlo;
    }
    __syncwarp();
    if (lane == 0) {
      float sum = 0.f;
      for (int j = 0; j < nout; ++j) sum += red[j];
      orow[4 * nsum + l] = sum;
    }
    float* t = blo;
    blo = nlo;
    nlo = t;
    t = bhi;
    bhi = nhi;
    nhi = t;
    noff += nout;
    __syncwarp();
  }
}

template <int KIND>
__global__ void __launch_bounds__(SIM_MAX_WARPS * 32, 1)
ka_kernel(PadDesc pd, const float* __restrict__ params, const uint32_t* __restrict__ keys,
          const float* __restrict__ lo, const float* __restrict__ hi, int S, int tw, int T,
          int tpb, long long ntiles, float* __restrict__ out, int* ws) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = pd.in[0], L = pd.L, nsum = sim_nsum(pd), maxw = sim_maxw(pd);
  const int wrow = KIND == SIM_KA ? 4 * nsum + L : 2 * nsum;
  const SimBlock b = sim_block(P + pd.fwd, pd, KIND, T, tpb, ntiles);
  sim_setup(b, pd, KIND, keys, lo, hi);
  stage_net(P, params, pd.fwd, bar);
  mbar_wait(bar, 0);

  const int smask = swz_mask(tw);
  const SimBufs nb = sim_bufs(pd);
  float* O = b.tiles + warp * sim_warp_floats(pd, KIND, tw);
  float* E = O + nb.o * tw;
  const uint32_t tiles_f = pick_tiles(L, tw, [&](int l) { return pd.out[l]; });

  if (KIND == SIM_KA && warp == 0)
    for (int q = 0; q < b.nq; ++q) {
      const int p = b.pA + q;
      if ((long long)p * T >= b.g0)  // the block holds the partition's first tile
        ka_ibp(pd, P, lo + (size_t)p * d, hi + (size_t)p * d, b.extra, maxw, nsum,
               out + (size_t)p * wrow, lane);
    }

  for (long long g = sim_next_tile(b, lane); g >= 0; g = sim_next_tile(b, lane)) {
    const int q = (int)(g / T) - b.pA;
    const int r0 = (int)(g - (long long)(b.pA + q) * T) * tw;
    const int nvalid = min(tw, S - r0);
    sim_draw(b, q, d, O, tw, smask, r0, nvalid, lane);
    __syncwarp();
    int* cq = b.cnt + q * nsum;
    int noff = 0;
    for (int l = 0; l < L; ++l) {
      CountEpi e;
      e.bias = P + pd.b[l];
      e.mask = P + pd.m[l];
      e.out = (l & 1) ? O : E;
      e.cnt = cq + noff;
      e.nvalid = nvalid;
      e.tw = tw;
      e.smask = smask;
      e.hidden = l + 1 < L;
      warp_layer((tiles_f >> (3 * l)) & 7, (l & 1) ? E : O, tw, smask, P + pd.w[l], pd.ldw[l],
                pd.in[l], pd.out[l], lane, e);
      __syncwarp();
      noff += pd.out[l];
    }
  }
  __syncthreads();
  const float inv = 1.f / (float)S;  // XLA's mean: sum * (1 / S)
  sim_finish(b, nsum, T, tpb, ws, [&](int p, int i, int c) {
    float* orow = out + (size_t)p * wrow;
    orow[i] = c == 0 ? 1.f : 0.f;
    orow[nsum + i] = (float)c * inv;
  });
}

template <int KIND>
static int ka_launch(const void* params, const int* dims, int L, const void* keys,
                     const void* lo, const void* hi, int rows, int live, int S, void* out,
                     void* ws, int tw, int warps, int tpb, int grid, long long smem,
                     void* stream) {
  if (L < 1 || L > MAX_LAYERS || rows < 0 || live > rows || (rows > 0 && live < 1))
    return (int)cudaErrorInvalidValue;
  const PadDesc pd = make_pad_desc(dims, L);
  if (!sim_geometry_ok(pd, KIND, S, live, tw, warps, tpb, grid, smem))
    return (int)cudaErrorInvalidValue;
  const int T = (S + tw - 1) / tw;
  if (tpb < T && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(ka_kernel<KIND>, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0)
    ka_kernel<KIND><<<(unsigned)grid, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
        pd, (const float*)params, (const uint32_t*)keys, (const float*)lo, (const float*)hi,
        S, tw, T, tpb, (long long)live * T, (float*)out, (int*)ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nsum = sim_nsum(pd);
  fill_past((float*)out, 1, rows, live, KIND == SIM_KA ? 4 * nsum + L : 2 * nsum, stream);
  return (int)cudaGetLastError();
}

// The launch geometry comes from the wrapper (verify/pruning.py:
// sim_geometry: rows a warp tile `tw`, warps a block, tiles a block `tpb`,
// the grid, the shared-memory bytes); it is checked here.  `ws`: the
// zeroed per-partition counts of a launch whose partitions span blocks
// (tpb < T), live * (nsum + 1) ints, left zeroed.  `keys`: (at least
// live) x 2 int64 of uint32 values; `lo`, `hi`: the live rows' (at least);
// `out`: rows x (4 nsum + L) floats.
extern "C" int ka_sim_and_bounds(const void* params, const int* dims, int L, const void* keys,
                                 const void* lo, const void* hi, int rows, int live, int S,
                                 void* out, void* ws, int tw, int warps, int tpb, int grid,
                                 long long smem, void* stream) {
  return ka_launch<SIM_KA>(params, dims, L, keys, lo, hi, rows, live, S, out, ws, tw, warps,
                           tpb, grid, smem, stream);
}

// Row 3: the same launch without the IBP half; `out`: rows x 2 nsum floats.
extern "C" int ka_sim_stats(const void* params, const int* dims, int L, const void* keys,
                            const void* lo, const void* hi, int rows, int live, int S,
                            void* out, void* ws, int tw, int warps, int tpb, int grid,
                            long long smem, void* stream) {
  return ka_launch<SIM_STATS>(params, dims, L, keys, lo, hi, rows, live, S, out, ws, tw,
                              warps, tpb, grid, smem, stream);
}

// Registers a thread of KA (kind 0) or row 3 (kind 1) uses as built, or -1:
// verify/pruning.py:sim_regs, from which sim_geometry takes the warps an SM
// holds.
extern "C" int ka_regs(int kind) {
  cudaFuncAttributes a;
  const cudaError_t err =
      kind == SIM_KA ? cudaFuncGetAttributes(&a, ka_kernel<SIM_KA>)
                     : cudaFuncGetAttributes(&a, ka_kernel<SIM_STATS>);
  return err == cudaSuccess ? a.numRegs : -1;
}
