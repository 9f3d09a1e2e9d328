// Warp-owned dense layers for the attack forward (attack_logits.cu), the
// attack with its flip scan (attack_flips.cu) and the PGD attack
// (pgd_attack.cu): the H100 layout of all three.
//
// A warp carries its own tile of TW rows (TW a multiple of 4) through every
// layer of the net.  A row's activations depend only on that row, so the
// layers of a tile need no block barrier, only __syncwarp; the block's one
// barrier is the one that publishes the net staged in shared memory.
//
// Activation tiles are unit-major: unit j of the tile's rows r lies at
// act_off(j, r) = j * TW + (r ^ swizzle(j)), rows of one unit contiguous, so
// a thread's 4 rows are one 16-byte load.  The swizzle XORs the row's
// 4-row chunk with bits of j / 4, which spreads the epilogue's stores (lanes
// on neighbouring column groups write the same rows of units 4 apart) over
// the banks: a 16-way conflict becomes a 2-way one.
//
// Weights come from the padded pack (utils/cuda_build.py:pack_padded): per
// layer W (in x ldw, ldw = out rounded up to 8, zero columns past out), its
// bias and mask (ldw each); then, for the backward pass, W^T (out x ldt,
// ldt = in rounded up to 8).  A thread's columns are 4-wide chunks, so a
// weight fetch is one 16-byte load, and neighbouring lanes take
// neighbouring chunks (conflict-free).
//
// Each layer is register-blocked: a lane owns RR rows x RC columns (tile
// `id` of the menu below, picked per layer from the layer's width and TW for
// the shortest per-lane instruction chain), loads RR / 4 + RC / 4
// vectors per k-step for RR * RC FMAs, and keeps its sums in registers.
// Every sum is the index-ordered fmaf chain from 0 (over the layer's inputs
// forward, over its outputs backward), so a row's result does not depend
// on the tile, the warp or the block that carries it.
#pragma once

#include "common.cuh"

// Dynamic shared memory one block may use on sm_90 (227 KB).
#define SMEM_LIMIT 232448
#define WT_TILES 5

// ---------------------------------------------------------------------------
// The padded pack (host side).
// ---------------------------------------------------------------------------

struct PadDesc {
  int L;
  int in[MAX_LAYERS], out[MAX_LAYERS], ldw[MAX_LAYERS], ldt[MAX_LAYERS];
  int w[MAX_LAYERS], b[MAX_LAYERS], m[MAX_LAYERS], wt[MAX_LAYERS];
  int fwd;    // floats of the forward part (W | b | m per layer)
  int total;  // floats of one model's pack (forward part, then W^T per layer)
};

static inline int round8(int v) { return (v + 7) / 8 * 8; }

static inline PadDesc make_pad_desc(const int* dims, int L) {
  PadDesc pd;
  pd.L = L;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    pd.in[l] = dims[l];
    pd.out[l] = dims[l + 1];
    pd.ldw[l] = round8(dims[l + 1]);
    pd.w[l] = off;
    off += dims[l] * pd.ldw[l];
    pd.b[l] = off;
    off += pd.ldw[l];
    pd.m[l] = off;
    off += pd.ldw[l];
  }
  pd.fwd = off;
  for (int l = 0; l < L; ++l) {
    pd.ldt[l] = round8(dims[l]);
    pd.wt[l] = off;
    off += dims[l + 1] * pd.ldt[l];
  }
  pd.total = off;
  return pd;
}

// Unit capacities of a forward pass's two hidden-activation buffers: hidden
// layer l's output goes to buffer l % 2.
__host__ __device__ inline void hidden_buffers(const PadDesc& pd, int& h0, int& h1) {
  h0 = h1 = 0;
  for (int l = 0; l + 1 < pd.L; ++l) {
    int& h = (l & 1) ? h1 : h0;
    if (pd.out[l] > h) h = pd.out[l];
  }
}

// ---------------------------------------------------------------------------
// The tile menu: (rows, columns) a lane owns, largest first.
// ---------------------------------------------------------------------------

__host__ __device__ inline int tile_rr(int id) { return id < 2 ? 8 : 4; }
__host__ __device__ inline int tile_rc(int id) {
  return id == 0 ? 8 : (id <= 2 ? 4 : (id == 3 ? 2 : 1));
}
__host__ __device__ inline int tile_items(int id, int nout, int tw) {
  return (nout + tile_rc(id) - 1) / tile_rc(id) * (tw / tile_rr(id));
}

// A lane's instructions per k-step over all its passes: RR * RC FMAs and
// RR / 4 + RC / 4 (at least one) loads, a load counted twice.  pick_tile
// takes the cheapest tile (a tie goes to the larger); the warp's time in a
// layer is its lanes' longest instruction chain.  utils/cuda_build.py:
// pick_tile is the same rule.
__host__ __device__ inline int tile_cost(int id, int nout, int tw) {
  const int rr = tile_rr(id), rc = tile_rc(id);
  return (tile_items(id, nout, tw) + 31) / 32 * (rr * rc + 2 * (rr / 4 + (rc + 3) / 4));
}

__host__ __device__ inline int pick_tile(int nout, int tw) {
  int best = -1, cost = 0;
  for (int id = 0; id < WT_TILES; ++id) {
    if (tw % tile_rr(id) != 0) continue;
    const int c = tile_cost(id, nout, tw);
    if (best < 0 || c < cost) {
      best = id;
      cost = c;
    }
  }
  return best;
}

__host__ __device__ inline int tile_passes(int nout, int tw) {
  return (tile_items(pick_tile(nout, tw), nout, tw) + 31) / 32;
}

// XOR mask of the row-chunk swizzle: the largest power of two dividing the
// tile's TW / 4 chunks, less one (so the XOR stays inside the tile).
__host__ __device__ inline int swz_mask(int tw) {
  const int n = tw / 4;
  return (n & -n) - 1;
}

__device__ __forceinline__ int act_off(int j, int r, int tw, int mask) {
  return j * tw + (r ^ (((j >> 2) & mask) << 2));
}

// ---------------------------------------------------------------------------
// One layer of a warp's tile.
// ---------------------------------------------------------------------------

// Store a lane's RR outputs o of unit j (rows 4 (rg + (r / 4) RG) + r % 4)
// as RR / 4 16-byte chunks.
template <int RR>
__device__ __forceinline__ void tile_store(float* out, int j, int rg, int RG, int tw, int smask,
                                           const float (&o)[RR]) {
#pragma unroll
  for (int p = 0; p < RR / 4; ++p)
    *reinterpret_cast<float4*>(out + act_off(j, 4 * (rg + p * RG), tw, smask)) =
        make_float4(o[4 * p], o[4 * p + 1], o[4 * p + 2], o[4 * p + 3]);
}

// A layer's epilogue is a functor E.  For each item (a lane's RR rows x RC
// columns) warp_dense calls st = e.begin(item, lane), then
// e.apply<RR, RC>(c, j, rg, RG, v, st) for each of the item's columns c
// whose unit j is below nout (v: the column's sums; row r of v is 4 (rg +
// (r / 4) RG) + r % 4), then e.end(item, lane, st).  st is 64 bits of
// per-item state in registers (bit r * RC + c: Epi's ReLU' record); an
// epilogue without state derives from NoItemState.
struct NoItemState {
  __device__ __forceinline__ uint64_t begin(int, int) const { return 0; }
  __device__ __forceinline__ void end(int, int, uint64_t) const {}
};

enum { EPI_HIDDEN = 0, EPI_LOGIT = 1, EPI_BACKWARD = 2 };

// The attack forward's and K5's epilogue.  What a layer does with its sums
// v of unit j, row r:
//  EPI_HIDDEN:   out[act_off(j, r)] = max(v + bias[j], 0) * mask[j]; with
//                `bits`, the lane records whether that value is positive
//                (ReLU' of the masked net) in its own word of this pass.
//  EPI_LOGIT:    logit[r] = v + bias[0] for unit 0 and r < nvalid.
//  EPI_BACKWARD: out[act_off(j, r)] = v, or with `bits` (the forward pass's
//                record of this unit, laid out by the same tile, so the lane
//                holds the same (r, j)) v * mask[j] where it was positive
//                and 0 elsewhere.
struct Epi {
  int mode;
  const float* bias;
  const float* mask;
  float* out;
  float* logit;
  int nvalid;
  uint32_t* bits;  // 2 words per lane and pass
  int tw, smask;   // the output tile's rows and swizzle

  __device__ __forceinline__ uint32_t* word(int item, int lane) const {
    return bits + 2 * ((item >> 5) * 32 + lane);
  }
  __device__ __forceinline__ uint64_t begin(int item, int lane) const {
    if (mode != EPI_BACKWARD || bits == nullptr) return 0;
    const uint32_t* bw = word(item, lane);
    return (uint64_t)bw[0] | ((uint64_t)bw[1] << 32);
  }
  __device__ __forceinline__ void end(int item, int lane, uint64_t rec) const {
    if (mode != EPI_HIDDEN || bits == nullptr) return;
    uint32_t* bw = word(item, lane);
    bw[0] = (uint32_t)rec;
    bw[1] = (uint32_t)(rec >> 32);
  }
  template <int RR, int RC>
  __device__ __forceinline__ void apply(int c, int j, int rg, int RG, const float (&v)[RR],
                                        uint64_t& st) const {
    if (mode == EPI_LOGIT) {
      if (j != 0) return;
      const float bj = bias[0];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int row = 4 * (rg + (r / 4) * RG) + r % 4;
        if (row < nvalid) logit[row] = v[r] + bj;
      }
      return;
    }
    float o[RR];
    if (mode == EPI_HIDDEN) {
      const float bj = bias[j], mj = mask[j];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        o[r] = fmaxf(v[r] + bj, 0.f) * mj;
        if (o[r] > 0.f) st |= 1ull << (r * RC + c);
      }
    } else {
      const float mj = bits != nullptr ? mask[j] : 1.f;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        o[r] = v[r];
        if (bits != nullptr) o[r] = (st >> (r * RC + c)) & 1ull ? o[r] * mj : 0.f;
      }
    }
    tile_store<RR>(out, j, rg, RG, tw, smask, o);
  }
};

// The operands of one k-step of an item: RR activations (rows 4 (rg + p RG)
// .. + 3 of the unit at `ak`, its chunk XORed with the swizzle s) and RC
// weights (columns RCW (cg + q CG) .. of the weight row at `wk`).
template <int RR, int RC>
__device__ __forceinline__ void load_step(const float* __restrict__ ak, int s,
                                          const float* __restrict__ wk, int CG, int RG, int rg,
                                          float (&av)[RR], float (&wv)[RC]) {
  constexpr int RCW = RC < 4 ? RC : 4;
#pragma unroll
  for (int p = 0; p < RR / 4; ++p) {
    const float4 t = *reinterpret_cast<const float4*>(ak + ((4 * (rg + p * RG)) ^ s));
    av[4 * p] = t.x;
    av[4 * p + 1] = t.y;
    av[4 * p + 2] = t.z;
    av[4 * p + 3] = t.w;
  }
#pragma unroll
  for (int q = 0; q < RC / RCW; ++q) {
    const float* src = wk + RCW * q * CG;
    if constexpr (RCW == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      wv[4 * q] = t.x;
      wv[4 * q + 1] = t.y;
      wv[4 * q + 2] = t.z;
      wv[4 * q + 3] = t.w;
    } else if constexpr (RCW == 2) {
      const float2 t = *reinterpret_cast<const float2*>(src);
      wv[2 * q] = t.x;
      wv[2 * q + 1] = t.y;
    } else {
      wv[q] = *src;
    }
  }
}

template <int RR, int RC>
__device__ __forceinline__ void fma_step(float (&acc)[RR][RC], const float (&av)[RR],
                                         const float (&wv)[RC]) {
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
}

template <int RR, int RC, class E>
__device__ __forceinline__ void warp_dense(const float* __restrict__ A, int tw, int smask,
                                           const float* __restrict__ W, int ldw, int K,
                                           int nout, int lane, const E& e) {
  constexpr int RCW = RC < 4 ? RC : 4;  // columns per chunk
  // k-steps whose operands load together, ahead of their FMAs: G divides
  // 4, so a group shares one swizzle and its addresses are fixed offsets.
  constexpr int G = RR * RC >= 32 ? 2 : 4;
  const int CG = (nout + RC - 1) / RC, RG = tw / RR, items = CG * RG;
  for (int item = lane; item < items; item += 32) {
    const int cg = item % CG, rg = item / CG;
    float acc[RR][RC];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[r][c] = 0.f;
    const float* wp = W + RCW * cg;
    int k = 0;
    for (; k + G <= K; k += G) {
      const int s = ((k >> 2) & smask) << 2;
      float av[G][RR], wv[G][RC];
#pragma unroll
      for (int u = 0; u < G; ++u)
        load_step<RR, RC>(A + (k + u) * tw, s, wp + (k + u) * ldw, CG, RG, rg, av[u], wv[u]);
#pragma unroll
      for (int u = 0; u < G; ++u) fma_step<RR, RC>(acc, av[u], wv[u]);
    }
    for (; k < K; ++k) {
      float av[RR], wv[RC];
      load_step<RR, RC>(A + k * tw, ((k >> 2) & smask) << 2, wp + k * ldw, CG, RG, rg, av, wv);
      fma_step<RR, RC>(acc, av, wv);
    }
    // Epilogue: unit of acc[.][c] RCW (cg + (c / RCW) CG) + c % RCW.
    uint64_t st = e.begin(item, lane);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = RCW * (cg + (c / RCW) * CG) + c % RCW;
      if (j >= nout) continue;
      float v[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) v[r] = acc[r][c];
      e.template apply<RR, RC>(c, j, rg, RG, v, st);
    }
    e.end(item, lane, st);
  }
}

// The tiles of up to MAX_LAYERS layers of widths n(l), 3 bits a layer, so a
// kernel picks them once and keeps them in one register.
template <typename Width>
__device__ __forceinline__ uint32_t pick_tiles(int L, int tw, Width n) {
  uint32_t t = 0;
  for (int l = 0; l < L; ++l) t |= (uint32_t)pick_tile(n(l), tw) << (3 * l);
  return t;
}

// One layer with tile `tile` (pick_tile(nout, tw)): K inputs (the rows of
// the unit-major tile A), nout outputs, weights W with row stride ldw, the
// epilogue e.
template <class E>
__device__ __forceinline__ void warp_layer(int tile, const float* A, int tw, int smask,
                                           const float* W, int ldw, int K, int nout, int lane,
                                           const E& e) {
  switch (tile) {
    case 0: warp_dense<8, 8>(A, tw, smask, W, ldw, K, nout, lane, e); break;
    case 1: warp_dense<8, 4>(A, tw, smask, W, ldw, K, nout, lane, e); break;
    case 2: warp_dense<4, 4>(A, tw, smask, W, ldw, K, nout, lane, e); break;
    case 3: warp_dense<4, 2>(A, tw, smask, W, ldw, K, nout, lane, e); break;
    default: warp_dense<4, 1>(A, tw, smask, W, ldw, K, nout, lane, e); break;
  }
}

// ---------------------------------------------------------------------------
// Staging: the net by one bulk asynchronous copy completing on an mbarrier
// (Hopper's TMA engine, no tensor map), input rows by 4-byte cp.async.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0 only: arm `bar` for `bytes` (a multiple of 16, both addresses
// 16-byte aligned) and start the copy.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A copy that has not landed after 2^24 polls (seconds; it takes
// microseconds) traps: the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) __trap();
  }
}

// Stage the net: thread 0 initializes the barrier and starts the copy; the
// block's barrier publishes the initialized mbarrier; every thread waits on
// it with mbar_wait(bar, 0) before its first read of the net (work that
// does not read the net, such as a warp's first input rows, goes between).
__device__ __forceinline__ void stage_net(float* dst, const float* src, int floats,
                                          uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar);
    bulk_load(dst, src, (uint32_t)floats * 4u, bar);
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
