// Shared pieces of the BP decode kernels (bp_flood.cu, bp_layered.cu,
// bp_compressed.cu): circulant index arithmetic, the check-node (CN)
// updates, the two quantization policies and the two message-storage
// policies, all as template parameters, and the compressed row state's
// pack and reconstruct.
//
// A CN update is run by one thread over one check's edges in edge order:
//   cn.add(t, q)   slot t = 0 .. deg-1 of the row, in order;
//   cn.finish(deg) after the last add;
//   cn.out(t, q)   the CN->VN message of slot t, for the same q.
// A caller may run add and out in two passes that recompute q from the
// same operands (bp_flood.cu and bp_layered.cu for rows of unbounded
// degree), or keep the row's q in registers and run them in one pass
// (both, under a row-degree bound).  A one-pass caller goes through
// add_kept / out_kept,
// which let a CN update keep one value per edge beside q (exact
// sum-product keeps phi(|q|), so it evaluates phi twice per edge, not
// three times, on the same arguments).  Where out reads q only as
// q < 0 (CN::kOutFromSign: every update but exact sum-product), it is
// defined as out_neg(t, q < 0.0f), so a two-pass caller may keep the
// row's signs from the first pass and send out_neg from them.
//
// Signs read `q < 0` (so -0.0 is positive) and messages are formed as
// (total_sign * own_sign) * magnitude, as golden and the plain PyTorch
// version form them: no sign bits are OR-ed into a magnitude.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ldpc {

// (a + b) mod Z and (a - b) mod Z for a, b in [0, Z): a conditional
// add or subtract, never C's `%` (which keeps the sign of a negative
// dividend).  Works for odd Z.
__device__ __forceinline__ int wrap_add(int a, int b, int Z) {
  const int x = a + b;
  return x >= Z ? x - Z : x;
}

__device__ __forceinline__ int wrap_sub(int a, int b, int Z) {
  const int x = a - b;
  return x < 0 ? x + Z : x;
}

// Shift normalization's coordinates: variable v = j*Z + z of the code
// sits at j*Z + (z - col_off[j]) mod Z of the decoder's state.  A null
// col_off means plain coordinates (v itself, no division, no load).
__device__ __forceinline__ int state_index(int v, const int32_t* col_off,
                                           int Z) {
  if (col_off == nullptr) return v;
  const int j = v / Z;
  return j * Z + wrap_sub(v - j * Z, col_off[j], Z);
}

// Normalized / offset min-sum: the golden sequential two-min scan with
// first-occurrence argmin; a single-edge row sends its own magnitude.
// finish() scales the two minima once per row (s1, s2) and out() selects
// between them: the same operations on the same inputs as scaling the
// selected minimum per edge, so the same floats.
struct MinSum {
  static constexpr bool kOutFromSign = true;
  float alpha, beta;
  float min1, min2, s1, s2;
  int argmin, neg;

  __device__ __forceinline__ void begin() {
    min1 = 0.0f;
    min2 = INFINITY;
    argmin = 0;
    neg = 0;
  }
  __device__ __forceinline__ void add(int t, float q) {
    const float mag = fabsf(q);
    neg ^= q < 0.0f;
    if (t == 0) {
      min1 = mag;
    } else if (mag < min1) {
      min2 = min1;
      min1 = mag;
      argmin = t;
    } else {
      min2 = fminf(min2, mag);
    }
  }
  __device__ __forceinline__ void finish(int deg) {
    if (deg == 1) min2 = min1;
    s1 = scaled(min1);
    s2 = scaled(min2);
  }
  // alpha * max(m - beta, 0): the magnitude sent for a scan minimum m
  __device__ __forceinline__ float scaled(float m) const {
    return alpha * fmaxf(m - beta, 0.0f);
  }
  __device__ __forceinline__ float out_neg(int t, bool own_neg) const {
    const float total_sign = neg ? -1.0f : 1.0f;
    const float sign = own_neg ? -1.0f : 1.0f;
    return (total_sign * sign) * (t == argmin ? s2 : s1);
  }
  __device__ __forceinline__ float out(int t, float q) const {
    return out_neg(t, q < 0.0f);
  }
};

// Min-sum of the rescaled contract (golden/decoder.py, rescaled=True):
// alpha 1 and beta 0, so the output is the exclusive minimum itself, with
// no multiply (max(m - 0, 0) == m for the +0.0-or-positive m of fabsf).
// The 1/alpha scaling lives in the channel term, once per variable.
struct MinSumUnit : MinSum {
  __device__ __forceinline__ float out_neg(int t, bool own_neg) const {
    const float total_sign = neg ? -1.0f : 1.0f;
    const float sign = own_neg ? -1.0f : 1.0f;
    return (total_sign * sign) * (t == argmin ? min2 : min1);
  }
  __device__ __forceinline__ float out(int t, float q) const {
    return out_neg(t, q < 0.0f);
  }
};

// Compressed row state of one check (bp_compressed.cu): the two output
// magnitudes m1 = scaled(min1), m2 = scaled(min2), the argmin slot and a
// sign byte whose bit t is the sign of slot t's message, total_sign XOR
// own sign (x < 0, as everywhere here).  reconstruct() rebuilds slot t's
// message exactly as MinSum::out forms it: +-1 * m is +-m, -0.0 included.
__device__ __forceinline__ int pack_signs(int neg, int own, int deg) {
  return neg ? ~own & ((1 << deg) - 1) : own;
}

__device__ __forceinline__ float reconstruct(float m1, float m2, int arg,
                                             int sgn, int t) {
  const float mag = t == arg ? m2 : m1;
  return (sgn >> t) & 1 ? -mag : mag;
}

// Sum-product stability clips, the golden model's SP_MIN_MAG / SP_MAX_MAG.
constexpr float kSpMinMag = 1e-9f;
constexpr float kSpMaxMag = 30.0f;

// phi(x) = -log(tanh(x/2)) on x clipped to [kSpMinMag, kSpMaxMag].  At
// the top clip tanhf rounds to 1 and phi is -0.0; the message's sign
// comes only from the sign product it is multiplied by.
__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, kSpMinMag), kSpMaxMag);
  return -logf(tanhf(x * 0.5f));
}

// Exact sum-product: phi of each |q| summed in edge order, output
// (total_sign * own_sign) * phi(tot - phi_e).  alpha / beta are unused.
struct SumProduct {
  static constexpr bool kOutFromSign = false;  // out reads phi(|q|)
  float alpha, beta;
  float tot;
  int neg;

  __device__ __forceinline__ void begin() {
    tot = 0.0f;
    neg = 0;
  }
  // add / out with phi(|q|) handed over: the one-pass form (add_kept)
  __device__ __forceinline__ float add_phi(int t, float q) {
    const float ph = phi(fabsf(q));
    neg ^= q < 0.0f;
    tot = t == 0 ? ph : tot + ph;  // the first term as is: -0.0 stays -0.0
    return ph;
  }
  __device__ __forceinline__ float out_phi(float q, float ph) const {
    const float total_sign = neg ? -1.0f : 1.0f;
    const float sign = q < 0.0f ? -1.0f : 1.0f;
    return (total_sign * sign) * phi(tot - ph);
  }
  __device__ __forceinline__ void add(int t, float q) { add_phi(t, q); }
  __device__ __forceinline__ void finish(int) {}
  __device__ __forceinline__ float out(int, float q) const {
    return out_phi(q, phi(fabsf(q)));
  }
};

// sumproduct-fast (lambda-min2), golden's contract: the PWL
// ctilde(x) ~ log(1+e^-x) and the pairwise soft-min f(a, b), exact or
// correctly rounded fp32 ops only.  The slopes are powers of two, so the
// products are exact (and -fmad=false keeps every product unfused anyway).
__device__ __forceinline__ float ctilde(float x) {
  return fmaxf(fmaxf(fmaxf(0.6931472f - 0.5f * x, 0.57f - 0.25f * x),
                     0.40f - 0.125f * x),
               0.0f);
}

__device__ __forceinline__ float fpair(float a, float b) {
  const float d1 = ctilde(a + b);
  const float d2 = ctilde(fabsf(a - b));
  return fmaxf(fminf(a, b) + (d1 - d2), 0.0f);
}

// Three-smallest scan in edge order with first-occurrence argmins a1, a2
// (strict <, the two-min scan's ties).  Output magnitude of slot t: degree
// 1: its own |q|; degree 2: t == a1 ? m2 : m1; degree >= 3: t == a1 ?
// f(m2, m3) : t == a2 ? f(m1, m3) : f(m1, m2).  alpha / beta are unused.
struct SumProductFast {
  static constexpr bool kOutFromSign = true;
  float alpha, beta;
  float m1, m2, m3, f12, f13, f23;
  int a1, a2, deg, neg;

  __device__ __forceinline__ void begin() {
    m1 = 0.0f;
    m2 = INFINITY;
    m3 = INFINITY;
    a1 = 0;
    a2 = -1;
    neg = 0;
  }
  __device__ __forceinline__ void add(int t, float q) {
    const float mag = fabsf(q);
    neg ^= q < 0.0f;
    if (t == 0) {
      m1 = mag;
    } else if (mag < m1) {
      m3 = m2;
      m2 = m1;
      a2 = a1;
      m1 = mag;
      a1 = t;
    } else if (mag < m2) {
      m3 = m2;
      m2 = mag;
      a2 = t;
    } else if (mag < m3) {
      m3 = mag;
    }
  }
  __device__ __forceinline__ void finish(int d) {
    deg = d;
    if (d >= 3) {
      f23 = fpair(m2, m3);
      f13 = fpair(m1, m3);
      f12 = fpair(m1, m2);
    }
  }
  __device__ __forceinline__ float out_neg(int t, bool own_neg) const {
    const float total_sign = neg ? -1.0f : 1.0f;
    const float sign = own_neg ? -1.0f : 1.0f;
    float mag;
    if (deg == 1) {
      mag = m1;
    } else if (deg == 2) {
      mag = t == a1 ? m2 : m1;
    } else {
      mag = t == a1 ? f23 : (t == a2 ? f13 : f12);
    }
    return (total_sign * sign) * mag;
  }
  __device__ __forceinline__ float out(int t, float q) const {
    return out_neg(t, q < 0.0f);
  }
};

// The one-pass form of a CN update: add_kept returns one value per edge
// that the caller keeps beside q and hands to out_kept.  Nothing is kept
// but for exact sum-product, whose out reuses phi(|q|) from add.
template <class CN>
__device__ __forceinline__ float add_kept(CN& cn, int t, float q) {
  cn.add(t, q);
  return 0.0f;
}
template <class CN>
__device__ __forceinline__ float out_kept(const CN& cn, int t, float q,
                                          float) {
  return cn.out(t, q);
}
__device__ __forceinline__ float add_kept(SumProduct& cn, int t, float q) {
  return cn.add_phi(t, q);
}
__device__ __forceinline__ float out_kept(const SumProduct& cn, int, float q,
                                          float ph) {
  return cn.out_phi(q, ph);
}

// Quantization policies, applied by the kernels at golden's four points:
// quantize() on the channel LLRs and on each CN output, sat() on each
// VN->CN message fed to the CN, sat_post() on the posterior.  NoQuant is
// the identity (the float decoders, unchanged).
struct NoQuant {
  __device__ __forceinline__ float quantize(float x) const { return x; }
  __device__ __forceinline__ float sat(float x) const { return x; }
  __device__ __forceinline__ float sat_post(float x) const { return x; }
};

// Fixed-point grid k * step, |k| <= kmax = 2^(bits-1)-1 (golden's
// quantize / saturate): k = min(floor(|x| / step + 0.5), kmax), then
// (sign(x) * k) * step, and +0.0 where k == 0.  The limits are computed
// on the host in fp32 as golden computes them.
//
// |x| / step is computed as |x| * inv_step, with no division: step is a
// power of two 2^k and inv_step its exact fp32 reciprocal 2^-k
// (make_quant refuses any other), so the quotient and the product are
// both the correctly rounded (round-to-nearest-even) fp32 value of the
// same real number |x| * 2^-k -- including where that number is
// subnormal or overflows -- hence the same float for every input.
struct Quant {
  float step, inv_step, kmax, lim_msg, lim_post;

  __device__ __forceinline__ float quantize(float x) const {
    const float k = fminf(floorf(fabsf(x) * inv_step + 0.5f), kmax);
    return k == 0.0f ? 0.0f : ((x < 0.0f ? -1.0f : 1.0f) * k) * step;
  }
  __device__ __forceinline__ float sat(float x) const {
    return fminf(fmaxf(x, -lim_msg), lim_msg);
  }
  __device__ __forceinline__ float sat_post(float x) const {
    return fminf(fmaxf(x, -lim_post), lim_post);
  }
};

// The Quant of the grid `step` (host side, fp32): false, and *q untouched,
// unless step is a power of two whose fp32 reciprocal is exact.
inline bool make_quant(float step, float kmax, float lim_msg, float lim_post,
                       Quant* q) {
  int exp;
  if (!(step > 0.0f) || frexpf(step, &exp) != 0.5f) return false;
  const float inv_step = 1.0f / step;
  if (step * inv_step != 1.0f || frexpf(inv_step, &exp) != 0.5f) return false;
  *q = Quant{step, inv_step, kmax, lim_msg, lim_post};
  return true;
}

// Message-storage policies for R: F32Msg keeps float32; Bf16Msg stores
// bf16 rounded to nearest even (as PyTorch's .to(torch.bfloat16) and XLA's
// astype round) and widens on load, exactly.  Compute stays float32.
struct F32Msg {
  using T = float;
  static __device__ __forceinline__ float load(T x) { return x; }
  static __device__ __forceinline__ T store(float x) { return x; }
};

struct Bf16Msg {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(T x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ T store(float x) {
    return __float2bfloat16_rn(x);
  }
};

enum Algo { kMinSum = 0, kSumProduct = 1, kSumProductFast = 2 };

}  // namespace ldpc

extern "C" const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
