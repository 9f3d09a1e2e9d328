// KC — the attack: candidate forwards, strict flips, gap, stats, fold.
//
// Replaces the attack half of fairify_tpu/verify/sweep.py:
// _mega_stage0_kernel (row 4) — engine._attack_logits, _find_flips_dev,
// _attack_gap_impl, sweep._chunk_stats_dev and sweep._fold_dev — and of its
// family forms _mega_family_stage0_kernel (row 5) and _family_stage0_kernel
// (row 7), and of engine._certify_attack_kernel (row 15).  Per box and model:
// the logits of the host-drawn (S, V, d) candidates of both roles; the
// strict-sign flips (x positive / x' negative or the reverse) over valid
// assignment pairs, with the first hit in flat (s, a, b) order as the
// witness (argmax of a bool, 0 when none); the best flip gap; the reason
// code cert + 2*found; the (2, 14) margin/gap histogram increment of real
// rows (idx = sum(v >= edge)), one histogram per model; and the int32 fold
// over cert, wit, reason and the histograms of every model, accumulated with
// wrapping atomicAdd like resilience/integrity.py:fold_host (a wraparound
// sum, so the order of the boxes' and models' contributions does not
// matter).
//
// Bound on the H100: fp32 FMA throughput of the forwards
// (2 * 2 * S * V * sum(in_l * out_l) flops per box and model); the
// candidates are read once (2 * S * V * d floats per box).
//
// Design (warp_tile.cuh): a persistent grid sized by the wrapper
// (engine.attack_flips_geometry), blockIdx.y the model of a stacked family
// (every model attacks the same candidates; outputs at m * N + box).  Each
// block stages its model's padded net with one bulk copy and keeps it for
// every box it takes.  Its warps form groups of `gw`; a group owns one box
// at a time.  The group's warps take the box's TW-row tiles of its 2 S V
// candidate rows (x rows, then x' rows) in turn, double-buffering the next
// tile's rows with cp.async while they carry the current one through every
// layer with __syncwarp only, and write the tile's logits to the group's
// strip of shared memory.  Once the box's tiles are done (__syncwarp, or a
// named barrier of the group's warps when gw > 1), the group's first warp
// scans the S V V triples in flat (s, a, b) order, 32 a chunk: the first
// flip is __ffs of the ballot of the first chunk that has one (the lowest
// flat index, as the old block-wide atomicMin gave it), the gap the
// warp_max of every valid triple's.  A box's histogram bins and fold term go
// to the block's shared counters, which leave with one global atomic per
// bin per block.  The layer sums are the index-ordered fmaf chains of
// warp_tile.cuh, so every output is bit-equal to the one-block-per-box
// kernel this replaces.  Boxes past `live` are not launched: fill_past
// gives their per-box outputs box live - 1's, and the histogram and fold
// cover the live boxes.
#include "common.cuh"
#include "warp_tile.cuh"

#define KC_MAX_WARPS 12
#define KC_MAX_GROUP 8
#define N_EDGES 13
#define N_BINS (N_EDGES + 1)
// Shared memory before the net: the mbarrier (4 floats), then the block's
// counters (2 N_BINS histogram bins and the fold), rounded up to 16 bytes.
#define KC_HEAD 36

// Floats of one warp's tiles (two input tiles, two hidden buffers) and of
// one group's logit strip (2 S V, rounded up to 4).
__host__ __device__ inline long long kc_warp_floats(const PadDesc& pd, int tw) {
  int h0, h1;
  hidden_buffers(pd, h0, h1);
  return (long long)(2 * pd.in[0] + h0 + h1) * tw;
}
__host__ __device__ inline long long kc_strip_floats(int S, int V) {
  return ((long long)2 * S * V + 3) / 4 * 4;
}

// Dynamic shared memory of one block (engine.attack_flips_smem is the same
// sum): head, the padded net's forward part, the warps' tiles, the groups'
// strips.
static inline long long kc_smem(const PadDesc& pd, int S, int V, int tw, int warps, int gw) {
  return 4LL * (KC_HEAD + pd.fwd + warps * kc_warp_floats(pd, tw) +
                (long long)(warps / gw) * kc_strip_floats(S, V));
}

// A tile of the box's candidate rows row0 .. row0 + tw - 1 (x rows xb, then
// x' rows pb, SV each) into the unit-major tile X.
__device__ __forceinline__ void kc_load_rows(float* X, const float* __restrict__ xb,
                                             const float* __restrict__ pb, int SV, int row0,
                                             int d, int tw, int smask, int lane) {
  const int R = 2 * SV;
  for (int e = lane; e < tw * d; e += 32) {
    const int r = e / d, i = e - r * d;
    const int q = row0 + r;
    if (q >= R) break;
    const float* src = q < SV ? xb + (size_t)q * d + i : pb + (size_t)(q - SV) * d + i;
    cp_async4(X + act_off(i, r, tw, smask), src);
  }
}

// The warps of group g (gw of them) meet: named barrier g + 1 (barrier 0
// is __syncthreads'), or __syncwarp for a group of one warp.
__device__ __forceinline__ void group_sync(int g, int gw) {
  if (gw == 1) {
    __syncwarp();
    return;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(gw * 32) : "memory");
}

__global__ void __launch_bounds__(KC_MAX_WARPS * 32, 1)
kc_kernel(PadDesc pd, const float* __restrict__ params, const float* __restrict__ xr,
          const float* __restrict__ pr, const uint8_t* __restrict__ valid,
          const uint8_t* __restrict__ vpair, const uint8_t* __restrict__ cert,
          const float* __restrict__ margin, const uint8_t* __restrict__ okrow,
          const float* __restrict__ edges, int S, int V, int N, int live, int tw, int gw,
          int* __restrict__ wit, int8_t* __restrict__ reason, float* __restrict__ gap,
          int* __restrict__ stats, int* __restrict__ fold) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* cnt = reinterpret_cast<int*>(smem + 4);  // bins, then the fold at 2 N_BINS
  float* P = smem + KC_HEAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int d = pd.in[0], smask = swz_mask(tw), m = blockIdx.y;
  const int SV = S * V, R = 2 * SV, VV = V * V, n3 = S * VV, T = (R + tw - 1) / tw;
  const int groups = nw / gw, g = warp / gw, wg = warp - g * gw;
  int h0, h1;
  hidden_buffers(pd, h0, h1);
  float* base = P + pd.fwd + warp * kc_warp_floats(pd, tw);
  float* X[2] = {base, base + d * tw};
  float* H[2] = {base + 2 * d * tw, base + (2 * d + h0) * tw};
  float* LG = P + pd.fwd + nw * kc_warp_floats(pd, tw) + g * kc_strip_floats(S, V);
  const uint32_t tiles_f = pick_tiles(pd.L, tw, [&](int l) { return pd.out[l]; });
  for (int i = threadIdx.x; i <= 2 * N_BINS; i += blockDim.x) cnt[i] = 0;
  stage_net(P, params + (size_t)m * pd.total, pd.fwd, bar);  // its barrier publishes cnt

  // The warp's items: boxes b = box0, box0 + bstride, ... below live, and in
  // each the tiles t = wg, wg + gw, ... below T.
  const int bstride = gridDim.x * groups;
  const size_t bsz = (size_t)SV * d;
  int b = blockIdx.x * groups + g, t = wg;
  if (b < live && t < T) kc_load_rows(X[0], xr + b * bsz, pr + b * bsz, SV, t * tw, d, tw,
                                      smask, lane);
  cp_async_commit();
  mbar_wait(bar, 0);
  int buf = 0;
  for (; b < live; b += bstride) {
    for (; t < T; t += gw, buf ^= 1) {
      int nb = b, nt = t + gw;
      if (nt >= T) {
        nb = b + bstride;
        nt = wg;
      }
      if (nb < live && nt < T)
        kc_load_rows(X[buf ^ 1], xr + nb * bsz, pr + nb * bsz, SV, nt * tw, d, tw, smask,
                     lane);
      cp_async_commit();
      cp_async_wait1();
      __syncwarp();
      const float* cur = X[buf];
      for (int l = 0; l < pd.L; ++l) {
        Epi e;
        e.mode = l + 1 == pd.L ? EPI_LOGIT : EPI_HIDDEN;
        e.bias = P + pd.b[l];
        e.mask = P + pd.m[l];
        e.out = H[l & 1];
        e.logit = LG + t * tw;
        e.nvalid = min(tw, R - t * tw);
        e.bits = nullptr;
        e.tw = tw;
        e.smask = smask;
        warp_layer((tiles_f >> (3 * l)) & 7, cur, tw, smask, P + pd.w[l], pd.ldw[l], pd.in[l],
                   pd.out[l], lane, e);
        __syncwarp();
        cur = H[l & 1];
      }
    }
    t = wg;
    group_sync(g, gw);  // the box's 2 S V logits are in LG
    if (wg == 0) {
      const float* lx = LG;
      const float* lp = LG + SV;
      const uint8_t* va = valid + (size_t)b * V;
      float gl = -FLT_MAX;
      int first = -1;
      for (int c0 = 0; c0 < n3; c0 += 32) {
        const int idx = c0 + lane;
        bool flip = false;
        if (idx < n3) {
          const int s = idx / VV, rem = idx - s * VV;
          const int a = rem / V, c = rem - a * V;
          const float x = lx[s * V + a], y = lp[s * V + c];
          const bool vx = va[a], vy = va[c], vp = vpair[a * V + c];
          flip = (((x > 0.f) && vx && (y < 0.f) && vy) || ((x < 0.f) && vx && (y > 0.f) && vy)) &&
                 vp;
          if (vx && vy && vp) gl = fmaxf(gl, fmaxf(fminf(x, -y), fminf(-x, y)));
        }
        if (first < 0) {
          const unsigned hits = __ballot_sync(0xffffffffu, flip);
          if (hits) first = c0 + __ffs((int)hits) - 1;
        }
      }
      const float gv = warp_max(gl);
      if (lane == 0) {
        const size_t out = (size_t)m * N + b;
        const bool found = first >= 0;
        const int w = found ? first : 0;
        const int ws = w / VV, wr = w - ws * VV;
        const int wa = wr / V, wb = wr - wa * V;
        wit[3 * out + 0] = ws;
        wit[3 * out + 1] = wa;
        wit[3 * out + 2] = wb;
        const int rc = (int)cert[out] + (found ? 2 : 0);
        reason[out] = (int8_t)rc;
        gap[out] = gv;
        int add = (int)cert[out] + ws + wa + wb + rc;
        if (okrow[b]) {
          int im = 0, ig = 0;
          for (int e = 0; e < N_EDGES; ++e) {
            im += margin[out] >= edges[e];
            ig += gv >= edges[e];
          }
          atomicAdd(&cnt[im], 1);
          atomicAdd(&cnt[N_BINS + ig], 1);
          add += 2;
        }
        atomicAdd(&cnt[2 * N_BINS], add);
      }
    }
    group_sync(g, gw);  // LG is free for the group's next box
  }
  __syncthreads();
  int* st = stats + (size_t)m * 2 * N_BINS;
  for (int i = threadIdx.x; i < 2 * N_BINS; i += blockDim.x)
    if (cnt[i]) atomicAdd(&st[i], cnt[i]);
  if (threadIdx.x == 0 && cnt[2 * N_BINS]) atomicAdd(fold, cnt[2 * N_BINS]);
}

// The launch geometry comes from the wrapper (engine.attack_flips_geometry:
// rows a warp tile `tw`, warps a block, warps a box `gw`, blocks a model,
// shared-memory bytes); it is checked here against the net and the kernel's
// limits.  params is cuda_build.pack_padded's buffer (M packs).  The launch
// covers boxes 0 .. live - 1 of N.
extern "C" int kc_attack_flips(const void* params, const int* dims, int L, const void* xr,
                               const void* pr, const void* valid, const void* vpair,
                               const void* cert, const void* margin, const void* okrow,
                               const void* edges, int N, int S, int V, int M, int live,
                               void* wit, void* reason, void* gap, void* stats, void* fold,
                               int tw, int warps, int gw, int grid, long long smem,
                               void* stream) {
  const PadDesc pd = make_pad_desc(dims, L);
  if (tw < 4 || tw % 4 != 0 || tw > 64 || warps < 1 || warps > KC_MAX_WARPS || gw < 1 ||
      gw > KC_MAX_GROUP || warps % gw != 0 || grid < 1 || S < 1 || V < 1 || M > 65535 ||
      live < 0 || live > N || (long long)S * V * V >= (1LL << 31) ||
      smem != kc_smem(pd, S, V, tw, warps, gw) || smem > SMEM_LIMIT || pd.out[L - 1] != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kc_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (live > 0 && M > 0) {
    kc_kernel<<<dim3((unsigned)grid, (unsigned)M), warps * 32, (size_t)smem,
                (cudaStream_t)stream>>>(
        pd, (const float*)params, (const float*)xr, (const float*)pr, (const uint8_t*)valid,
        (const uint8_t*)vpair, (const uint8_t*)cert, (const float*)margin,
        (const uint8_t*)okrow, (const float*)edges, S, V, N, live, tw, gw, (int*)wit,
        (int8_t*)reason, (float*)gap, (int*)stats, (int*)fold);
    fill_past((int*)wit, M, N, live, 3, stream);
    fill_past((int8_t*)reason, M, N, live, 1, stream);
    fill_past((float*)gap, M, N, live, 1, stream);
  }
  return (int)cudaGetLastError();
}
