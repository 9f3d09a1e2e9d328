// K9a/b/c: the exhaustive lattice scan of Phases E0 and E
// (ops/lattice.py), replacing the JAX package's three obs_jit sites
// fairify_tpu/ops/lattice.py:195 _lattice_scan_kernel (K9a, RA-free),
// :238 _lattice_signs_kernel (K9b, the full sign tensor) and
// :246 _lattice_scan_kernel_ra (K9c, the eps-dilated RA scan).
//
// One C entry point, k9_lattice(mode, ...), launches up to three kernels
// on the caller's stream:
//
//   1. lat_signs_kernel (every mode): warps walk tiles of TW lattice
//      points (below); per assignment v a tile's inputs are decoded from
//      flat indices (mixed radix over the shared dims, int32, indices past
//      the lattice wrapping modulo the widths as in JAX), run through the
//      signed forward (lattice.cuh) and turned into int8 signs (+1 if
//      f > e, -1 if f < -e, else 0), written to the (V, chunk) sign tensor
//      (and f, e on request).  With mode > 0 each in-range point's margin
//      flag (some valid assignment inside the bound) goes to pflag, each
//      64-point tile's margin count to blk and the chunk's count to
//      small[1]; MODE_SCAN also takes the first in-range point with a
//      valid ordered pair (+1, -1), atomicMin into small[0] (order-free:
//      the minimum).
//   2. lat_ra_kernel (MODE_RA): a block per RA tile row (prod(ra_ws)
//      cells): certain-positive and certain-negative planes of the live
//      cells (valid assignment, index < n_total: wrapped duplicates are
//      masked BEFORE the dilation), dilated over +-eps one axis at a time
//      (separable L-inf window) in shared memory (a global scratch slice
//      per block past LAT_RA_SMEM_MAX), then the flip at CORE cells in
//      both directions (x certainly positive for a with a dilated
//      negative partner for b, or certainly negative with a dilated
//      positive partner), atomicMin into small[0].
//   3. lat_compact (mode > 0, one warp): the first LAT_MARGIN_BUF margin
//      indices in index order (ballot + popc prefix over the tiles whose
//      count is nonzero, so a chunk without margins costs one pass over
//      blk), -1-filled; first_flip INT_MAX -> -1; sign columns gathered at
//      clip(margin_idx) and clip(first_flip), so unfilled columns and a
//      chunk without a flip read index 0's column, as JAX's take does.
//
// Bound on the H100: fp32 FMA work, three products per layer (z, |h||W|,
// e|W|) = 6 flops per MAC per point and assignment, less layer 0's e|W|
// (e = 0 there, skipped); the bytes (int8 signs, the tiny outputs) are
// negligible.  No tensor cores, since TF32 breaks the bound.
//
// Design of lat_signs_kernel (lattice.cuh, on warp_tile.cuh's layout): a
// persistent grid sized by the wrapper (ops/lattice.py:lattice_geometry);
// each block stages the padded net's forward part with one bulk copy, and
// each warp walks tiles of TW points.  For every assignment the warp
// decodes its points' inputs (lane per (point, dim)) into its own tile,
// carries them through every layer with __syncwarp only and turns each
// point's (f, e) into its sign; after the last assignment the lanes hold
// one point each and take the margin flags, the counts and the first flip
// from warp ballots.  A point's margin count goes to blk[j / LAT_BLK], the
// 64-point tiles lat_compact walks.
#include "common.cuh"
#include "lattice.cuh"

enum { MODE_SIGNS = 0, MODE_SCAN = 1, MODE_RA = 2 };

#define LAT_TW_MAX 64
#define LAT_MAX_WARPS 12
#define LAT_BLK 64  // points per blk entry (lat_compact's tiles)

// first_flip = none, margin_count = 0, every blk tile empty.
__global__ void lat_init(int* small, int* blk, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    small[0] = INT_MAX;
    small[1] = 0;
  }
  if (i < nblk) blk[i] = 0;
}

// Unit capacities of the two activation buffers (hidden layer l's output,
// and its bounds, go to buffer l % 2).
__host__ __device__ inline void lat_buffers(const PadDesc& pd, int& h0, int& h1) {
  h0 = h1 = 0;
  for (int l = 0; l + 1 < pd.L; ++l) {
    int& h = (l & 1) ? h1 : h0;
    if (pd.out[l] > h) h = pd.out[l];
  }
}

// Floats of one warp's share: the input tile, the two activation and two
// bound tiles, f and e (TW each), the V x TW sign bytes rounded up to 16.
__host__ __device__ inline long long lat_warp_floats(const PadDesc& pd, int tw, int V) {
  int h0, h1;
  lat_buffers(pd, h0, h1);
  return (long long)(pd.in[0] + 2 * (h0 + h1) + 2) * tw + ((V * tw / 4 + 3) & ~3);
}

// Dynamic shared memory: the mbarrier's 16 bytes, the padded net's forward
// part, the warps' tiles (ops/lattice.py:lattice_smem is the same sum).
static inline long long lat_smem(const PadDesc& pd, int tw, int warps, int V) {
  return 4LL * (4 + pd.fwd + warps * lat_warp_floats(pd, tw, V));
}

__global__ void __launch_bounds__(LAT_MAX_WARPS * 32, 1)
    lat_signs_kernel(PadDesc pd, const float* __restrict__ params, LatDesc ds, int tw,
                     const float* __restrict__ bases, const unsigned char* __restrict__ valid,
                     const float* __restrict__ vpair, int mode, signed char* __restrict__ signs,
                     float* __restrict__ fo, float* __restrict__ eo, int* __restrict__ small,
                     unsigned char* __restrict__ pflag, int* __restrict__ blk) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* P = smem + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int V = ds.V, d = ds.d, chunk = ds.chunk, smask = swz_mask(tw);
  int h0, h1;
  lat_buffers(pd, h0, h1);
  float* X = P + pd.fwd + warp * lat_warp_floats(pd, tw, V);
  float* H[2] = {X + d * tw, X + (d + 2 * h0) * tw};
  float* E[2] = {H[0] + h0 * tw, H[1] + h1 * tw};
  float* fb = E[1] + h1 * tw;
  float* eb = fb + tw;
  signed char* sg = reinterpret_cast<signed char*>(eb + tw);
  uint32_t tiles = 0;
  for (int l = 0; l < pd.L; ++l) tiles |= (uint32_t)signed_pick_tile(pd.out[l], tw) << (3 * l);
  stage_net(P, params, pd.fwd, bar);
  mbar_wait(bar, 0);
  const float u32 = 5.9604644775390625e-8f;  // 2^-24
  const unsigned FULL = 0xffffffffu;
  const int ntiles = (chunk + tw - 1) / tw;
  for (int t = blockIdx.x * nw + warp; t < ntiles; t += gridDim.x * nw) {
    const int j0 = t * tw;
    const int Tn = min(tw, chunk - j0);
    for (int v = 0; v < V; ++v) {
      for (int q = lane; q < tw * d; q += 32) {
        const int r = q / d, k = q - r * d;
        const int c = ds.col[k];
        float x;
        if (c >= 0) {
          const int g = ds.start + j0 + r;
          x = (float)((g / ds.stride[c]) % ds.width[c] + ds.lo[c]);
        } else {
          x = bases[v * d + k];
        }
        X[act_off(k, r, tw, smask)] = x;
      }
      __syncwarp();
      const float* h = X;
      const float* e = X;
      for (int l = 0; l < pd.L; ++l) {
        SignedEpi ep;
        ep.hidden = l + 1 < pd.L;
        ep.gamma = 4.f * (float)(pd.in[l] + 4) * u32;
        ep.bias = P + pd.b[l];
        ep.mask = P + pd.m[l];
        ep.hout = H[l & 1];
        ep.eout = E[l & 1];
        ep.f = fb;
        ep.fe = eb;
        signed_layer((tiles >> (3 * l)) & 7, l > 0, h, e, tw, smask, P + pd.w[l], pd.ldw[l],
                     pd.in[l], pd.out[l], lane, ep);
        __syncwarp();
        h = H[l & 1];
        e = E[l & 1];
      }
      for (int r = lane; r < Tn; r += 32) {
        const float f = fb[r], ev = eb[r];
        const signed char s = f > ev ? 1 : (f < -ev ? -1 : 0);
        sg[v * tw + r] = s;
        const size_t o = (size_t)v * chunk + j0 + r;
        signs[o] = s;
        if (fo != nullptr) {
          fo[o] = f;
          eo[o] = ev;
        }
      }
      __syncwarp();
    }
    if (mode == MODE_SIGNS) continue;
    for (int r0 = 0; r0 < tw; r0 += 32) {
      const int r = r0 + lane;
      bool margin = false, flip = false;
      if (r < Tn && ds.start + j0 + r < ds.n_total) {
        for (int v = 0; v < V; ++v)
          if (valid[v] && sg[v * tw + r] == 0) margin = true;
        if (mode == MODE_SCAN)
          for (int a = 0; a < V && !flip; ++a) {
            if (sg[a * tw + r] != 1) continue;
            for (int b = 0; b < V; ++b)
              if (vpair[a * V + b] > 0.f && sg[b * tw + r] == -1) {
                flip = true;
                break;
              }
          }
      }
      if (r < Tn) pflag[j0 + r] = margin ? 1 : 0;
      const unsigned mm = __ballot_sync(FULL, margin), fm = __ballot_sync(FULL, flip);
      if (lane == 0) {
        if (mm) {
          atomicAdd(&blk[(j0 + r0) / LAT_BLK], __popc(mm));
          atomicAdd(&small[1], __popc(mm));
        }
        if (fm) atomicMin(&small[0], j0 + r0 + __ffs(fm) - 1);
      }
    }
  }
}

__global__ void __launch_bounds__(256)
    lat_ra_kernel(LatDesc ds, LatRA ra, const unsigned char* __restrict__ valid,
                  const float* __restrict__ vpair, const signed char* __restrict__ signs,
                  unsigned char* __restrict__ scratch, int* __restrict__ small) {
  extern __shared__ unsigned char smu[];
  const int V = ds.V, tile = ra.tile, chunk = ds.chunk, eps = ra.eps;
  const int plane = V * tile;
  unsigned char* buf = scratch != nullptr ? scratch + (size_t)blockIdx.x * 4 * plane : smu;
  __shared__ int s_min;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int rows = chunk / tile;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int base = row * tile;
    unsigned char *pos = buf, *neg = buf + plane, *tp = buf + 2 * plane,
                  *tn = buf + 3 * plane;
    for (int q = tid; q < plane; q += bd) {
      const int v = q / tile, c = q - v * tile;
      const bool live = valid[v] && ds.start + base + c < ds.n_total;
      const signed char s = signs[(size_t)v * chunk + base + c];
      pos[q] = live && s == 1;
      neg[q] = live && s == -1;
    }
    if (tid == 0) s_min = INT_MAX;
    __syncthreads();
    for (int ax = 0; ax < ra.k; ++ax) {
      const int w = ra.w[ax], st = ra.st[ax];
      for (int q = tid; q < plane; q += bd) {
        const int c = q % tile;
        const int col = (c / st) % w;
        const int d0 = max(-eps, -col), d1 = min(eps, w - 1 - col);
        unsigned char p = 0, n = 0;
        for (int dl = d0; dl <= d1; ++dl) {
          p |= pos[q + dl * st];
          n |= neg[q + dl * st];
        }
        tp[q] = p;
        tn[q] = n;
      }
      __syncthreads();
      unsigned char* t = pos;
      pos = tp;
      tp = t;
      t = neg;
      neg = tn;
      tn = t;
    }
    for (int c = tid; c < tile; c += bd) {
      if (ds.start + base + c >= ds.n_total) continue;
      bool core = true;
      for (int ax = 0; ax < ra.k; ++ax) {
        const int col = (c / ra.st[ax]) % ra.w[ax];
        core = core && col >= eps && col < ra.w[ax] - eps;
      }
      if (!core) continue;
      bool flip = false;
      for (int a = 0; a < V && !flip; ++a) {
        if (!valid[a]) continue;
        const signed char s = signs[(size_t)a * chunk + base + c];
        if (s == 0) continue;
        const unsigned char* partner = s == 1 ? neg : pos;
        for (int b = 0; b < V; ++b)
          if (vpair[a * V + b] > 0.f && partner[b * tile + c]) {
            flip = true;
            break;
          }
      }
      if (flip) atomicMin(&s_min, base + c);
    }
    __syncthreads();
    if (tid == 0 && s_min != INT_MAX) atomicMin(&small[0], s_min);
    __syncthreads();
  }
}

__global__ void lat_compact(int chunk, int T, int V, const int* __restrict__ blk,
                            const unsigned char* __restrict__ pflag,
                            const signed char* __restrict__ signs, int* __restrict__ small,
                            signed char* __restrict__ sign_cols) {
  __shared__ int midx[LAT_MARGIN_BUF];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  const int ntiles = (chunk + T - 1) / T;
  int written = 0;  // warp-uniform
  for (int g0 = 0; g0 < ntiles && written < LAT_MARGIN_BUF; g0 += 32) {
    const int t = g0 + lane;
    unsigned m = __ballot_sync(FULL, t < ntiles && blk[t] > 0);
    while (m != 0u && written < LAT_MARGIN_BUF) {
      const int tile = g0 + __ffs(m) - 1;
      m &= m - 1u;
      const int end = min(tile * T + T, chunk);
      for (int b0 = tile * T; b0 < end && written < LAT_MARGIN_BUF; b0 += 32) {
        const int j = b0 + lane;
        const bool f = j < end && pflag[j] != 0;
        const unsigned mm = __ballot_sync(FULL, f);
        const int p = written + __popc(mm & ((1u << lane) - 1u));
        if (f && p < LAT_MARGIN_BUF) midx[p] = j;
        written += __popc(mm);
      }
    }
  }
  for (int p = written + lane; p < LAT_MARGIN_BUF; p += 32) midx[p] = -1;
  __syncwarp();
  int ff = small[0];
  if (ff == INT_MAX) ff = -1;
  for (int p = lane; p < LAT_MARGIN_BUF; p += 32) small[2 + p] = midx[p];
  const int ncol = LAT_MARGIN_BUF + 1;
  for (int q = lane; q < V * ncol; q += 32) {
    const int v = q / ncol, p = q - v * ncol;
    int idx = p < LAT_MARGIN_BUF ? midx[p] : ff;
    idx = min(max(idx, 0), chunk - 1);
    sign_cols[q] = signs[(size_t)v * chunk + idx];
  }
  if (lane == 0) small[0] = ff;  // idempotent: -1 stays -1
}

// desc: [start, n_total, chunk, d, n_shared, V, stride[n], width[n], lo[n],
// col[d]]; ra_desc: [k, eps, tile, w[k], st[k]] (host memory).  small is
// the int32 buffer [first_flip, margin_count, margin_idx[512]]; pflag
// (chunk bytes), blk (>= chunk / LAT_BLK + 1 ints) and scratch
// (scratch_blocks slices of 4 V tile bytes, or null for shared memory) are
// the caller's.  params is the padded pack (cuda_build.pack_padded); the
// signs kernel's geometry (points per warp tile tw, warps per block, grid,
// shared-memory bytes) comes from ops/lattice.py:lattice_geometry and is
// checked here.
extern "C" int k9_lattice(int mode, const float* params, const int* dims, int L,
                          const int* desc, const int* ra_desc, const float* bases,
                          const unsigned char* valid, const float* vpair,
                          signed char* signs, float* fo, float* eo, int* small,
                          signed char* sign_cols, unsigned char* pflag, int* blk,
                          unsigned char* scratch, int scratch_blocks, int tw, int warps,
                          int grid, long long smem, cudaStream_t stream) {
  const PadDesc pd = make_pad_desc(dims, L);
  LatDesc ds;
  ds.start = desc[0];
  ds.n_total = desc[1];
  ds.chunk = desc[2];
  ds.d = desc[3];
  ds.n_shared = desc[4];
  ds.V = desc[5];
  if (ds.d > LAT_MAXD || ds.n_shared > LAT_MAXD || ds.chunk <= 0 || ds.d != pd.in[0])
    return (int)cudaErrorInvalidValue;
  if (tw < 4 || tw > LAT_TW_MAX || LAT_BLK % tw != 0 || warps < 1 || warps > LAT_MAX_WARPS ||
      grid < 1 || smem != lat_smem(pd, tw, warps, ds.V) || smem > SMEM_LIMIT ||
      pd.out[L - 1] != 1)
    return (int)cudaErrorInvalidValue;
  const int n = ds.n_shared;
  for (int j = 0; j < n; ++j) {
    ds.stride[j] = desc[6 + j];
    ds.width[j] = desc[6 + n + j];
    ds.lo[j] = desc[6 + 2 * n + j];
  }
  for (int k = 0; k < ds.d; ++k) ds.col[k] = desc[6 + 3 * n + k];

  int dev = 0, nsm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = set_smem(lat_signs_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (ds.chunk + LAT_BLK - 1) / LAT_BLK;
  if (mode != MODE_SIGNS) lat_init<<<(nblk + 255) / 256, 256, 0, stream>>>(small, blk, nblk);
  lat_signs_kernel<<<grid, warps * 32, (size_t)smem, stream>>>(
      pd, params, ds, tw, bases, valid, vpair, mode, signs, fo, eo, small, pflag, blk);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == MODE_SIGNS) return (int)err;
  if (mode == MODE_RA) {
    LatRA ra;
    ra.k = ra_desc[0];
    ra.eps = ra_desc[1];
    ra.tile = ra_desc[2];
    if (ra.k > LAT_RA_MAXK || ra.tile <= 0 || ds.chunk % ra.tile != 0)
      return (int)cudaErrorInvalidValue;
    for (int a = 0; a < ra.k; ++a) {
      ra.w[a] = ra_desc[3 + a];
      ra.st[a] = ra_desc[3 + ra.k + a];
    }
    const int rows = ds.chunk / ra.tile;
    const size_t need = (size_t)4 * ds.V * ra.tile;
    size_t smem_ra = 0;
    int grid_ra;
    if (scratch != nullptr) {
      grid_ra = min(rows, scratch_blocks);
    } else {
      if (need > LAT_RA_SMEM_MAX) return (int)cudaErrorInvalidValue;
      smem_ra = need;
      err = set_smem(lat_ra_kernel, smem_ra);
      if (err != cudaSuccess) return (int)err;
      grid_ra = min(rows, 4 * nsm);
    }
    lat_ra_kernel<<<max(grid_ra, 1), 256, smem_ra, stream>>>(ds, ra, valid, vpair, signs,
                                                              scratch, small);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  lat_compact<<<1, 32, 0, stream>>>(ds.chunk, LAT_BLK, ds.V, blk, pflag, signs, small,
                                    sign_cols);
  return (int)cudaGetLastError();
}
