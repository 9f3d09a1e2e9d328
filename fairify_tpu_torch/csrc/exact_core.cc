// Native exact-arithmetic core of the PyTorch port (C ABI, loaded via
// ctypes by fairify_tpu_torch/ops/exact_native.py).  The port's own copy of
// native/exact_core.cc, unchanged but for this header: the port builds and
// loads its own library and imports nothing of the JAX package.
//
// Everything soundness-critical bottoms out in questions about *exact*
// signs of affine/ReLU expressions whose coefficients are float32 (dyadic
// rationals m * 2^e) and whose inputs are integers:
//
//   * sign of the network logit at an integer point (counterexample
//     validation, branch-and-bound leaf decisions) — the quantity the
//     reference's Z3 encoding reasons about (utils/GC-1-Model-Functions.py,
//     z3_net over ToReal(Int) inputs);
//   * exact interval upper bounds per neuron over an integer box (the
//     closed-form equivalent of the reference's per-neuron "singular
//     verification" Z3 queries, utils/prune.py:276-364).
//
// Python's fractions.Fraction computes these exactly but at ~1e4 ops/s; this
// file computes the same values in dyadic fixed-point big-integer arithmetic
// (no gcd, no division — every quantity is m * 2^e with a big-int m), which
// is exact by construction.  It is host code, not a device kernel: the
// loader builds it with g++ at first use and falls back to the Fraction
// path (fairify_tpu_torch/ops/exact.py) when the library is unavailable.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;
using i64 = std::int64_t;

// ---------------------------------------------------------------------------
// Signed big integer: sgn in {-1,0,1}, little-endian 64-bit limbs.
// ---------------------------------------------------------------------------

struct Big {
  int sgn = 0;
  std::vector<u64> m;
};

inline void trim(Big &a) {
  while (!a.m.empty() && a.m.back() == 0) a.m.pop_back();
  if (a.m.empty()) a.sgn = 0;
}

inline int cmp_mag(const std::vector<u64> &a, const std::vector<u64> &b) {
  if (a.size() != b.size()) return a.size() < b.size() ? -1 : 1;
  for (size_t i = a.size(); i-- > 0;) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  return 0;
}

inline std::vector<u64> add_mag(const std::vector<u64> &a, const std::vector<u64> &b) {
  const std::vector<u64> &x = a.size() >= b.size() ? a : b;
  const std::vector<u64> &y = a.size() >= b.size() ? b : a;
  std::vector<u64> r(x.size() + 1, 0);
  u64 carry = 0;
  for (size_t i = 0; i < x.size(); ++i) {
    u128 s = (u128)x[i] + (i < y.size() ? y[i] : 0) + carry;
    r[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  r[x.size()] = carry;
  while (!r.empty() && r.back() == 0) r.pop_back();
  return r;
}

// |a| >= |b| required.
inline std::vector<u64> sub_mag(const std::vector<u64> &a, const std::vector<u64> &b) {
  std::vector<u64> r(a.size(), 0);
  u64 borrow = 0;
  for (size_t i = 0; i < a.size(); ++i) {
    u64 bi = (i < b.size() ? b[i] : 0);
    u64 t = a[i] - bi;
    u64 borrow2 = a[i] < bi;
    u64 t2 = t - borrow;
    borrow2 |= (t < borrow);
    r[i] = t2;
    borrow = borrow2;
  }
  while (!r.empty() && r.back() == 0) r.pop_back();
  return r;
}

inline Big big_add(const Big &a, const Big &b) {
  if (a.sgn == 0) return b;
  if (b.sgn == 0) return a;
  Big r;
  if (a.sgn == b.sgn) {
    r.sgn = a.sgn;
    r.m = add_mag(a.m, b.m);
  } else {
    int c = cmp_mag(a.m, b.m);
    if (c == 0) return r;  // zero
    if (c > 0) {
      r.sgn = a.sgn;
      r.m = sub_mag(a.m, b.m);
    } else {
      r.sgn = b.sgn;
      r.m = sub_mag(b.m, a.m);
    }
  }
  trim(r);
  return r;
}

// Shift left by k bits (k >= 0).
inline void shl_bits(Big &a, u64 k) {
  if (a.sgn == 0 || k == 0) return;
  u64 limbs = k / 64, bits = k % 64;
  size_t n = a.m.size();
  a.m.resize(n + limbs + (bits ? 1 : 0), 0);
  if (bits) {
    for (size_t i = n; i-- > 0;) {
      u64 hi = a.m[i] >> (64 - bits);
      a.m[i + limbs + 1] |= hi;
      a.m[i + limbs] = a.m[i] << bits;
      if (i < limbs) a.m[i] = 0;
    }
    // clear low limbs not covered when limbs > 0
    for (size_t i = 0; i < limbs && i < n; ++i) a.m[i] = 0;
    if (limbs == 0) {
      // already shifted in place above
    }
  } else {
    for (size_t i = n; i-- > 0;) a.m[i + limbs] = a.m[i];
    for (size_t i = 0; i < limbs; ++i) a.m[i] = 0;
  }
  trim(a);
}

// a * s where s fits one limb; ssgn is the sign of s.
inline Big mul_small(const Big &a, u64 s, int ssgn) {
  Big r;
  if (a.sgn == 0 || s == 0 || ssgn == 0) return r;
  r.sgn = a.sgn * ssgn;
  r.m.assign(a.m.size() + 1, 0);
  u64 carry = 0;
  for (size_t i = 0; i < a.m.size(); ++i) {
    u128 p = (u128)a.m[i] * s + carry;
    r.m[i] = (u64)p;
    carry = (u64)(p >> 64);
  }
  r.m[a.m.size()] = carry;
  trim(r);
  return r;
}

// ---------------------------------------------------------------------------
// Dyadic rational: v * 2^e.
// ---------------------------------------------------------------------------

struct Dy {
  Big v;
  i64 e = 0;
};

inline Dy dy_from_i64(i64 x) {
  Dy d;
  if (x == 0) return d;
  d.v.sgn = x < 0 ? -1 : 1;
  u64 mag = x < 0 ? (u64)(-(x + 1)) + 1 : (u64)x;
  d.v.m.push_back(mag);
  return d;
}

// Exact conversion of any finite double (covers all float32 values).
inline Dy dy_from_double(double x) {
  Dy d;
  if (x == 0.0) return d;
  int ex;
  double m = std::frexp(x, &ex);        // x = m * 2^ex, |m| in [0.5, 1)
  double scaled = std::ldexp(m, 53);    // integer-valued, |.| < 2^53
  i64 mi = (i64)scaled;                 // exact
  d = dy_from_i64(mi);
  d.e = (i64)ex - 53;
  return d;
}

inline Dy dy_add(const Dy &a, const Dy &b) {
  if (a.v.sgn == 0) return b;
  if (b.v.sgn == 0) return a;
  Dy r;
  if (a.e == b.e) {
    r.v = big_add(a.v, b.v);
    r.e = a.e;
  } else if (a.e > b.e) {
    Big av = a.v;
    shl_bits(av, (u64)(a.e - b.e));
    r.v = big_add(av, b.v);
    r.e = b.e;
  } else {
    Big bv = b.v;
    shl_bits(bv, (u64)(b.e - a.e));
    r.v = big_add(a.v, bv);
    r.e = a.e;
  }
  return r;
}

// a * w where w came from a double (mantissa fits one limb).
inline Dy dy_mul_f(const Dy &a, const Dy &w) {
  Dy r;
  if (a.v.sgn == 0 || w.v.sgn == 0) return r;
  u64 wm = w.v.m.empty() ? 0 : w.v.m[0];
  r.v = mul_small(a.v, wm, w.v.sgn);
  r.e = a.e + w.e;
  return r;
}

inline int dy_sign(const Dy &a) { return a.v.sgn; }

inline int dy_cmp(const Dy &a, const Dy &b) {
  Dy nb = b;
  nb.v.sgn = -nb.v.sgn;
  return dy_sign(dy_add(a, nb));
}

struct LayerW {
  int in, out;
  std::vector<Dy> w;  // in*out, row-major (i * out + j)
  std::vector<Dy> b;  // out
};

static void build_layers(int n_layers, const int *sizes, const float *w_flat,
                         const float *b_flat, std::vector<LayerW> &layers) {
  layers.resize(n_layers);
  size_t wo = 0, bo = 0;
  for (int l = 0; l < n_layers; ++l) {
    LayerW &L = layers[l];
    L.in = sizes[l];
    L.out = sizes[l + 1];
    L.w.resize((size_t)L.in * L.out);
    L.b.resize(L.out);
    for (size_t k = 0; k < (size_t)L.in * L.out; ++k) L.w[k] = dy_from_double((double)w_flat[wo + k]);
    for (int j = 0; j < L.out; ++j) L.b[j] = dy_from_double((double)b_flat[bo + j]);
    wo += (size_t)L.in * L.out;
    bo += L.out;
  }
}

}  // namespace

extern "C" {

// Exact sign of the first output logit at each integer point.
//   sizes:    n_layers+1 ints
//   w_flat:   concatenated row-major (in x out) float32 weights
//   b_flat:   concatenated float32 biases
//   points:   n_points x sizes[0] int64
//   out_sign: n_points int8 in {-1, 0, 1}
void ft_forward_signs(int n_layers, const int *sizes, const float *w_flat,
                      const float *b_flat, int n_points, const i64 *points,
                      signed char *out_sign) {
  std::vector<LayerW> layers;
  build_layers(n_layers, sizes, w_flat, b_flat, layers);
  int d0 = sizes[0];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int p = 0; p < n_points; ++p) {
    std::vector<Dy> h, z;
    h.assign(d0, Dy());
    for (int i = 0; i < d0; ++i) h[i] = dy_from_i64(points[(size_t)p * d0 + i]);
    for (int l = 0; l < n_layers; ++l) {
      const LayerW &L = layers[l];
      z.assign(L.out, Dy());
      for (int j = 0; j < L.out; ++j) z[j] = L.b[j];
      for (int i = 0; i < L.in; ++i) {
        if (h[i].v.sgn == 0) continue;
        const Dy *wr = &L.w[(size_t)i * L.out];
        for (int j = 0; j < L.out; ++j) {
          if (wr[j].v.sgn == 0) continue;
          z[j] = dy_add(z[j], dy_mul_f(h[i], wr[j]));
        }
      }
      if (l < n_layers - 1) {
        for (int j = 0; j < L.out; ++j)
          if (z[j].v.sgn < 0) z[j] = Dy();
      }
      h.swap(z);
    }
    out_sign[p] = (signed char)dy_sign(h[0]);
  }
}

void ft_certify_dead_batch(int n_layers, const int *sizes, const float *w_flat,
                           const float *b_flat, int n_boxes, const i64 *lo,
                           const i64 *hi, const unsigned char *proposed,
                           unsigned char *certified);

// Exact-rational veto of proposed dead masks (the closed-form equivalent of
// the reference's per-neuron Z3 singular verification; see
// fairify_tpu_torch/ops/exact.py:certify_dead_masks for the argument).
//   lo, hi:    sizes[0] int64 integer box
//   proposed:  concatenated uint8 per hidden layer (sizes[1..n_layers-1])
//   certified: same layout, written 0/1
void ft_certify_dead(int n_layers, const int *sizes, const float *w_flat,
                     const float *b_flat, const i64 *lo, const i64 *hi,
                     const unsigned char *proposed, unsigned char *certified) {
  ft_certify_dead_batch(n_layers, sizes, w_flat, b_flat, 1, lo, hi, proposed, certified);
}

// Batched ft_certify_dead: n_boxes independent integer boxes (lo/hi are
// n_boxes x sizes[0]; proposed/certified are n_boxes x sum(hidden sizes)).
// One weight conversion serves every box — this is the per-partition exact
// certification sweep of the sound-pruning pass.
void ft_certify_dead_batch(int n_layers, const int *sizes, const float *w_flat,
                           const float *b_flat, int n_boxes, const i64 *lo,
                           const i64 *hi, const unsigned char *proposed,
                           unsigned char *certified) {
  std::vector<LayerW> layers;
  build_layers(n_layers, sizes, w_flat, b_flat, layers);
  int d0 = sizes[0];
  size_t stride = 0;
  for (int l = 0; l < n_layers - 1; ++l) stride += sizes[l + 1];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int bx = 0; bx < n_boxes; ++bx) {
    const i64 *blo = lo + (size_t)bx * d0;
    const i64 *bhi = hi + (size_t)bx * d0;
    const unsigned char *bprop = proposed + (size_t)bx * stride;
    unsigned char *bcert = certified + (size_t)bx * stride;
    std::vector<Dy> lb(d0), ub(d0);
    for (int i = 0; i < d0; ++i) {
      lb[i] = dy_from_i64(blo[i]);
      ub[i] = dy_from_i64(bhi[i]);
    }
    size_t off = 0;
    for (int l = 0; l < n_layers - 1; ++l) {
      const LayerW &L = layers[l];
      std::vector<Dy> mn(L.out), mx(L.out);
      for (int j = 0; j < L.out; ++j) {
        mn[j] = L.b[j];
        mx[j] = L.b[j];
      }
      for (int i = 0; i < L.in; ++i) {
        const Dy *wr = &L.w[(size_t)i * L.out];
        for (int j = 0; j < L.out; ++j) {
          const Dy &wij = wr[j];
          if (wij.v.sgn == 0) continue;
          if (wij.v.sgn < 0) {
            mn[j] = dy_add(mn[j], dy_mul_f(ub[i], wij));
            mx[j] = dy_add(mx[j], dy_mul_f(lb[i], wij));
          } else {
            mn[j] = dy_add(mn[j], dy_mul_f(lb[i], wij));
            mx[j] = dy_add(mx[j], dy_mul_f(ub[i], wij));
          }
        }
      }
      lb.assign(L.out, Dy());
      ub.assign(L.out, Dy());
      for (int j = 0; j < L.out; ++j) {
        bool dead = bprop[off + j] && dy_sign(mx[j]) <= 0;
        bcert[off + j] = dead ? 1 : 0;
        if (dead) continue;
        if (dy_sign(mn[j]) > 0) lb[j] = mn[j];
        if (dy_sign(mx[j]) > 0) ub[j] = mx[j];
      }
      off += L.out;
    }
  }
}

// Exact pre-activation (ws) and post-ReLU (pl) bound SIGNS per neuron over an
// integer box, with optional alive masks pinning pruned neurons to [0,0].
// Out arrays are concatenated over ALL layers (sizes[1..n_layers]), int8.
void ft_bound_signs(int n_layers, const int *sizes, const float *w_flat,
                    const float *b_flat, const i64 *lo, const i64 *hi,
                    const unsigned char *alive /* may be null */,
                    signed char *ws_lb_sign, signed char *ws_ub_sign) {
  std::vector<LayerW> layers;
  build_layers(n_layers, sizes, w_flat, b_flat, layers);
  int d0 = sizes[0];
  std::vector<Dy> lb(d0), ub(d0);
  for (int i = 0; i < d0; ++i) {
    lb[i] = dy_from_i64(lo[i]);
    ub[i] = dy_from_i64(hi[i]);
  }
  size_t off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const LayerW &L = layers[l];
    std::vector<Dy> mn(L.out), mx(L.out);
    for (int j = 0; j < L.out; ++j) {
      mn[j] = L.b[j];
      mx[j] = L.b[j];
    }
    for (int i = 0; i < L.in; ++i) {
      const Dy *wr = &L.w[(size_t)i * L.out];
      for (int j = 0; j < L.out; ++j) {
        const Dy &wij = wr[j];
        if (wij.v.sgn == 0) continue;
        if (wij.v.sgn < 0) {
          mn[j] = dy_add(mn[j], dy_mul_f(ub[i], wij));
          mx[j] = dy_add(mx[j], dy_mul_f(lb[i], wij));
        } else {
          mn[j] = dy_add(mn[j], dy_mul_f(lb[i], wij));
          mx[j] = dy_add(mx[j], dy_mul_f(ub[i], wij));
        }
      }
    }
    for (int j = 0; j < L.out; ++j) {
      ws_lb_sign[off + j] = (signed char)dy_sign(mn[j]);
      ws_ub_sign[off + j] = (signed char)dy_sign(mx[j]);
    }
    if (l < n_layers - 1) {
      lb.assign(L.out, Dy());
      ub.assign(L.out, Dy());
      for (int j = 0; j < L.out; ++j) {
        bool dead = alive && !alive[off + j];
        if (dead) continue;
        if (dy_sign(mn[j]) > 0) lb[j] = mn[j];
        if (dy_sign(mx[j]) > 0) ub[j] = mx[j];
      }
    }
    off += L.out;
  }
}

int ft_abi_version(void) { return 1; }

}  // extern "C"
