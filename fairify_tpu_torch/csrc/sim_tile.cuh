// The simulation tile of KA (sim_and_bounds.cu: rows 1-3) and KD
// (parity.cu: rows 10 and 11): sim_size threefry samples of each
// partition's box through the net, on warp_tile.cuh's warp-owned tiles.
//
// The work unit is a tile of TW sample rows of one partition.  A warp draws
// its tile's inputs itself (lanes over (row, dimension) pairs, each value
// through common.cuh:draw_value with the partition's per-dimension
// constants, which the block computes once), then carries the tile through
// every layer with __syncwarp only (warp_tile.cuh:warp_layer, with the
// kernel's own epilogue functor) and takes its statistics from the
// epilogue: KA's activation counts (a unit counts the rows where its
// output is nonzero) as one popc of a lane's row bits per column and one
// shared-memory atomic add, KD's agreement count as one ballot per tile.
// Rows past sim_size (the last tile of a partition is ragged: S = 1,000 is
// not a multiple of TW) are drawn as 0, carried, and never counted.  Every
// count is an integer, so the order in which tiles, warps and blocks add
// them cannot change it, and the layer sums are warp_tile.cuh's
// index-ordered fmaf chains: the outputs do not depend on the geometry.
//
// The launch geometry (verify/pruning.py:sim_geometry; the C entry points
// check it): the live partitions' tiles form one flat index space g = p * T
// + t (T = ceil(S / TW) tiles a partition), and block b takes the tiles
// [b * tpb, (b + 1) * tpb), tpb <= T, so a block holds tiles of at most two
// partitions (slots q = 0, 1).  Its warps take its tiles one at a time from
// a shared counter.  With tpb = T (many partitions) a block is one
// partition and writes its outputs from its shared counts.  With tpb < T
// (fewer partitions than the card holds blocks, so that the grid fills
// every SM) a partition's tiles spread over several blocks: each adds its
// counts to a per-partition integer buffer in device memory with atomics,
// fences, and counts its arrival; the last block of a partition to arrive
// writes its outputs and leaves the buffer zeroed for the next launch on
// the stream, so one launch stays one launch.
//
// Shared memory, in 4-byte words (verify/pruning.py:sim_smem is the same
// sum): the mbarrier's 4; the forward part of the padded net
// (cuda_build.pack_padded); a head of 4 block scalars and per slot the
// split key (4), the draw constants (3d: minval, span, mult) and the counts
// (KA and row 3: one a unit, nsum; KD: one), then KD's alive masks (nhid a
// slot) or KA's IBP scratch (5 maxw), rounded up to 4; per warp its tiles:
// buffer O (the drawn inputs, then the odd hidden layers' outputs) and
// buffer E (the even hidden layers'), and for KD a second E (the masked
// net's) and the two nets' logits.
#pragma once

#include "common.cuh"
#include "warp_tile.cuh"

#define SIM_MAX_WARPS 16
#define SIM_MAX_TW 32

enum { SIM_KA = 0, SIM_STATS = 1, SIM_KD = 2 };

// Unit capacities of a warp's two activation buffers: O holds the tile's d
// inputs (read by layer 0 only) and the odd hidden layers' outputs, E the
// even hidden layers'.
struct SimBufs {
  int e, o;
};

__host__ __device__ inline SimBufs sim_bufs(const PadDesc& pd) {
  SimBufs b;
  b.e = 0;
  b.o = pd.in[0];
  for (int l = 0; l + 1 < pd.L; ++l) {
    int& h = (l & 1) ? b.o : b.e;
    if (pd.out[l] > h) h = pd.out[l];
  }
  return b;
}

__host__ __device__ inline int sim_nsum(const PadDesc& pd) {
  int n = 0;
  for (int l = 0; l < pd.L; ++l) n += pd.out[l];
  return n;
}

__host__ __device__ inline int sim_nhid(const PadDesc& pd) {
  return sim_nsum(pd) - pd.out[pd.L - 1];
}

__host__ __device__ inline int sim_maxw(const PadDesc& pd) {
  int m = pd.in[0];
  for (int l = 0; l < pd.L; ++l)
    if (pd.out[l] > m) m = pd.out[l];
  return m;
}

// Counts a slot keeps: one a unit (KA, row 3) or the agreement count (KD).
__host__ __device__ inline int sim_counts(const PadDesc& pd, int kind) {
  return kind == SIM_KD ? 1 : sim_nsum(pd);
}

__host__ __device__ inline int sim_head_words(const PadDesc& pd, int kind) {
  int w = 4 + 2 * (4 + 3 * pd.in[0] + sim_counts(pd, kind));
  if (kind == SIM_KD) w += 2 * sim_nhid(pd);
  if (kind == SIM_KA) w += 5 * sim_maxw(pd);
  return (w + 3) / 4 * 4;
}

__host__ __device__ inline long long sim_warp_floats(const PadDesc& pd, int kind, int tw) {
  const SimBufs b = sim_bufs(pd);
  if (kind == SIM_KD) return (long long)(b.o + 2 * b.e + 2) * tw;
  return (long long)(b.o + b.e) * tw;
}

static inline long long sim_smem(const PadDesc& pd, int kind, int tw, int warps) {
  return 4LL * (4 + pd.fwd + sim_head_words(pd, kind) + warps * sim_warp_floats(pd, kind, tw));
}

// The C entry points' check of the wrapper's geometry (tw, warps, tiles a
// block, grid, shared memory) against the net, sim_size and live rows.
static inline bool sim_geometry_ok(const PadDesc& pd, int kind, int S, int live, int tw,
                                   int warps, int tpb, int grid, long long smem) {
  if (S < 1 || live < 0 || tw < 4 || tw % 4 != 0 || tw > SIM_MAX_TW || warps < 1 ||
      warps > SIM_MAX_WARPS || smem != sim_smem(pd, kind, tw, warps) || smem > SMEM_LIMIT)
    return false;
  const long long T = (S + tw - 1) / tw;
  if (tpb < 1 || tpb > T) return false;
  return live == 0 || grid == ((long long)live * T + tpb - 1) / tpb;
}

// ---------------------------------------------------------------------------
// The block's shared state
// ---------------------------------------------------------------------------

struct SimBlock {
  int* scal;       // [0] the next tile, [1] the last-arrival flag
  uint32_t* key;   // 2 slots x 4 words: the partition's split key
  uint32_t* dc;    // 2 slots x 3d: minval[d], span[d], mult[d]
  int* cnt;        // 2 slots x counts
  float* extra;    // KD: 2 slots x nhid alive masks; KA: the IBP scratch
  float* tiles;    // the warps' tiles
  long long g0, g1;  // the block's tiles [g0, g1)
  int pA, nq;        // its first partition, the partitions it holds (1 or 2)
};

__device__ __forceinline__ SimBlock sim_block(float* head, const PadDesc& pd, int kind, int T,
                                              int tpb, long long ntiles) {
  SimBlock b;
  const int d = pd.in[0], C = sim_counts(pd, kind);
  int* w = reinterpret_cast<int*>(head);
  b.scal = w;
  b.key = reinterpret_cast<uint32_t*>(w + 4);
  b.dc = b.key + 8;
  b.cnt = reinterpret_cast<int*>(b.dc + 6 * d);
  b.extra = reinterpret_cast<float*>(b.cnt + 2 * C);
  b.tiles = head + sim_head_words(pd, kind);
  b.g0 = (long long)blockIdx.x * tpb;
  b.g1 = min(b.g0 + tpb, ntiles);
  b.pA = (int)(b.g0 / T);
  b.nq = (int)((b.g1 - 1) / T) - b.pA + 1;
  return b;
}

// Every thread: the slots' keys, draw constants and zeroed counts, and the
// tile counter (published by the stage_net barrier that follows).  `keys`:
// the (rows, 2) int64 key tensor of uint32 values read as 32-bit words,
// the low word of each first.
__device__ __forceinline__ void sim_setup(const SimBlock& b, const PadDesc& pd, int kind,
                                          const uint32_t* __restrict__ keys,
                                          const float* __restrict__ lo,
                                          const float* __restrict__ hi) {
  const int d = pd.in[0], C = sim_counts(pd, kind), tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < b.nq * d; i += nt) {
    const int q = i / d, j = i - q * d;
    const size_t o = (size_t)(b.pA + q) * d + j;
    const DrawDim c = draw_dim((int)lo[o], (int)hi[o] + 1);
    uint32_t* s = b.dc + q * 3 * d;
    s[j] = c.minval;
    s[d + j] = c.span;
    s[2 * d + j] = c.mult;
  }
  for (int i = tid; i < 2 * C; i += nt) b.cnt[i] = 0;
  if (tid < b.nq) {
    const int p = b.pA + tid;
    const SplitKey k = split_key(keys[4 * p], keys[4 * p + 2]);
    uint32_t* s = b.key + 4 * tid;
    s[0] = k.hi0;
    s[1] = k.hi1;
    s[2] = k.lo0;
    s[3] = k.lo1;
  }
  if (tid == 0) b.scal[0] = 0;
}

// The warp's next tile (all lanes), or -1 when the block's tiles are done.
__device__ __forceinline__ long long sim_next_tile(const SimBlock& b, int lane) {
  long long g = 0;
  if (lane == 0) g = b.g0 + atomicAdd(&b.scal[0], 1);
  g = __shfl_sync(0xffffffffu, g, 0);
  return g < b.g1 ? g : -1;
}

// Draw the tile's rows r0 .. r0 + tw - 1 of slot q's partition into X
// (unit-major, act_off): lanes on consecutive rows of one dimension; rows
// at or past nvalid are 0.
__device__ __forceinline__ void sim_draw(const SimBlock& b, int q, int d, float* X, int tw,
                                         int smask, int r0, int nvalid, int lane) {
  const uint32_t* kw = b.key + 4 * q;
  SplitKey k;
  k.hi0 = kw[0];
  k.hi1 = kw[1];
  k.lo0 = kw[2];
  k.lo1 = kw[3];
  const uint32_t* s = b.dc + q * 3 * d;
  // Value e = j * tw + r; e steps by 32, (j, r) by (32 / tw, 32 % tw).
  const int dj = 32 / tw, dr = 32 - dj * tw;
  int j = lane / tw, r = lane - j * tw;
  for (int e = lane; e < tw * d; e += 32) {
    float v = 0.f;
    if (r < nvalid) v = draw_value(k, (uint64_t)(r0 + r) * d + j, s[j], s[d + j], s[2 * d + j]);
    X[act_off(j, r, tw, smask)] = v;
    j += dj;
    r += dr;
    if (r >= tw) {
      r -= tw;
      ++j;
    }
  }
}

// ---------------------------------------------------------------------------
// The end of a block: each slot's counts to its outputs
// ---------------------------------------------------------------------------

// For each partition of the block: if the block held all its tiles, write
// its outputs from the shared counts (write(p, i, count)); else add the
// counts to ws (C + 1 words a partition: the counts, then the arrivals)
// and, in the last block of the partition to arrive, write the outputs
// from ws and zero it.  Every thread; after the block's last tile.
template <class Write>
__device__ __forceinline__ void sim_finish(const SimBlock& b, int C, int T, int tpb,
                                           int* __restrict__ ws, Write write) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int q = 0; q < b.nq; ++q) {
    const int p = b.pA + q;
    const long long t0 = (long long)p * T;
    const int* cq = b.cnt + q * C;
    if (t0 >= b.g0 && t0 + T <= b.g1) {
      for (int i = tid; i < C; i += nt) write(p, i, cq[i]);
      continue;
    }
    int* wp = ws + (size_t)p * (C + 1);
    for (int i = tid; i < C; i += nt)
      if (cq[i]) atomicAdd(&wp[i], cq[i]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const long long arrivals = (t0 + T - 1) / tpb - t0 / tpb + 1;
      b.scal[1] = atomicAdd(&wp[C], 1) == (int)(arrivals - 1);
    }
    __syncthreads();
    if (b.scal[1]) {
      __threadfence();
      for (int i = tid; i < C; i += nt) write(p, i, atomicExch(&wp[i], 0));
      if (tid == 0) atomicExch(&wp[C], 0);
    }
  }
}
