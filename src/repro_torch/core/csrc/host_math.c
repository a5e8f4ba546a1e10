/* Host f32 math that the reference takes from XLA:CPU, bit for bit.
 *
 *   rope_cos_sin: cosf / sinf of each f32 angle from the C library. The
 *     jitted reference's f32 cos and sin (repro/nn/rotary.py) equal the C
 *     library's on every entry of its RoPE tables; torch's CPU cos/sin and a
 *     table rounded once from f64 do not.
 *   xla_rsqrt: XLA:CPU's f32 rsqrt of fma(x, scale, add), as the jitted
 *     RMSNorm (repro/nn/norms.py) computes rsqrt(sum * (1 / width) + eps):
 *     XLA folds jnp.mean's divide into a multiply and contracts it with the
 *     add. Its rsqrt is not correctly rounded: the x86 approximate
 *     reciprocal square root
 *     (rsqrtps) refined by two Newton steps with fused multiply-adds,
 *       t = x * e (rounded);  h = e * -0.5;  t = fma(e, t, -1);
 *       e = fma(h, t, e),
 *     with its special inputs: +-0 and subnormals (flushed) give +-inf,
 *     +inf gives 0, negatives and NaN give NaN. The estimate table is the
 *     host CPU's own, so the bits hold on the host that runs the
 *     reference; on a host that is not x86 the function refuses (-1).
 *
 *   xla_tanh: XLA:CPU's f32 tanh (its elemental emitter's rational
 *     approximation, not libm's): x passes through where |x| < 0.0004, the
 *     sign of 1 where |x| >= 20; else, with c = x clamped to +-7.99881172,
 *     c * p(c^2) / q(c^2), each polynomial in Horner form with fused
 *     multiply-adds (LLVM contracts XLA's multiply-adds on the CPU) and one
 *     IEEE divide.
 *   xla_gelu_tanh: jax.nn.gelu(x, approximate=True) as XLA:CPU fuses it,
 *     x * ((tanh(fma(x * x * x, 0.044715, x) * sqrt(2 / pi)) + 1) * 0.5),
 *     with the reference's flush of subnormal operands and results.
 *   xla_tanh_grad, xla_softcap_grad, xla_gelu_tanh_grad: the input
 *     gradients that jax.jit(jax.grad(...)) computes on XLA:CPU for an
 *     incoming gradient g, each from the forward's own t = tanh(...):
 *     jax's tanh JVP h = g * (1 - t), h + h * t (contracted to
 *     fma(h, t, h)); the softcap's h = (g * cap) * (1 - t) and
 *     fma(h, t, h) * f32(1 / cap) (XLA folds the divide); the GELU's
 *     fma(a * 0.0356774069, x2 * 3, fma(g, cdf, a * 0.797884583)) with
 *     x2 = x * x, cdf = (t + 1) * 0.5, a = fma(m, t, m) and
 *     m = ((x * g) * 0.5) * (1 - t): XLA folds sqrt(2 / pi) * 0.044715
 *     into one constant and adds the three terms in this order. Every
 *     operand and result is flushed to zero where subnormal, as XLA:CPU
 *     runs.
 *   xla_exp, xla_logistic, xla_softplus: XLA:CPU's f32 exp (the Cephes
 *     polynomial of its CPU emitter: x clamped to [-87.8, 88.8], n =
 *     floor(fma(x, log2(e), 0.5)) clamped to +-127, a = x - n ln2 in two
 *     fused steps, a degree-5 polynomial in fused Horner form, times 2^n),
 *     logistic(x) = 1 / (exp(-x) + 1), and jax.nn.softplus, max(x, 0) +
 *     log1p(exp(-|x|)) (NaN passes through), whose log1p is XLA's: a
 *     Cephes rational function below sqrt(2) - 1 in magnitude, else the
 *     Cephes log of 1 + x; subnormal operands and results flushed, as
 *     XLA:CPU runs. Each equals jax.jit of the function on 2^20 f32
 *     samples.
 *   xla_log: XLA:CPU's f32 log (the Cephes log above, which its log1p
 *     takes past sqrt(2) - 1), the loss's log-normalizer.
 *   xla_fma: fmaf(a, b, c) elementwise, the multiply-add XLA:CPU contracts
 *     (the RG-LRU scan's a2 * b1 + b2, the causal convolutions' taps).
 *   xla_dot: batched f32 products out[z, i, j] = sum_k a[z, i, k] b[z, k,
 *     j] in one of the orders XLA:CPU's dot emitters sum a short
 *     contraction (measured at K <= 64): term t goes to lane t % lanes, a
 *     chain of fused multiply-adds in k order, and the lanes are summed in
 *     pairs, ((l0 + l1) + (l2 + l3)) ... One lane is a single chain.
 *
 * Built with -O2 -fno-fast-math -ffp-contract=off (repro_torch.core.
 * host_math): no contraction of x * e and no vectorised libmvec calls;
 * fmaf is the C library's correctly rounded fused multiply-add.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

void rope_cos_sin(const float* x, float* c, float* s, long n) {
  for (long i = 0; i < n; ++i) {
    c[i] = cosf(x[i]);
    s[i] = sinf(x[i]);
  }
}

static float tanh_one(float x) {
  const float ax = fabsf(x);
  const float lim = 7.99881172180175781f;
  float c = x < -lim ? -lim : x;
  c = c > lim ? lim : c;
  const float c2 = c * c;
  float p = fmaf(c2, -2.76076847742355e-16f, 2.00018790482477e-13f);
  p = fmaf(c2, p, -8.60467152213735e-11f);
  p = fmaf(c2, p, 5.12229709037114e-08f);
  p = fmaf(c2, p, 1.48572235717979e-05f);
  p = fmaf(c2, p, 6.37261928875436e-04f);
  p = fmaf(c2, p, 4.89352455891786e-03f);
  p = c * p;
  float q = fmaf(c2, 1.19825839466702e-06f, 1.18534705686654e-04f);
  q = fmaf(c2, q, 2.26843463243900e-03f);
  q = fmaf(c2, q, 4.89352518554385e-03f);
  const float r = ax < 0.0004f ? x : p / q;
  return ax >= 20.0f ? copysignf(1.0f, x) : r;
}

void xla_tanh(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = tanh_one(x[i]);
}

static float flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? copysignf(0.0f, x) : x;
}

void xla_gelu_tanh(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) {
    const float v = flush(x[i]);
    const float u = fmaf(v * v * v, 0.044715f, v) * 0.797884583f;
    out[i] = flush(v * ((tanh_one(u) + 1.0f) * 0.5f));
  }
}

void xla_tanh_grad(const float* x, const float* g, float* out, long n) {
  for (long i = 0; i < n; ++i) {
    const float t = tanh_one(flush(x[i]));
    const float h = flush(flush(g[i]) * flush(1.0f - t));
    out[i] = flush(fmaf(h, t, h));
  }
}

void xla_softcap_grad(const float* x, const float* g, float* out, long n,
                      float cap, float recip) {
  for (long i = 0; i < n; ++i) {
    const float t = tanh_one(flush(flush(x[i]) * recip));
    const float h = flush(flush(flush(g[i]) * cap) * flush(1.0f - t));
    out[i] = flush(flush(fmaf(h, t, h)) * recip);
  }
}

void xla_gelu_tanh_grad(const float* x, const float* g, float* out,
                        long n) {
  for (long i = 0; i < n; ++i) {
    const float v = flush(x[i]), gi = flush(g[i]);
    const float x2 = flush(v * v);
    const float u = flush(flush(fmaf(flush(x2 * v), 0.044715f, v))
                          * 0.797884583f);
    const float t = tanh_one(u);
    const float cdf = flush(flush(t + 1.0f) * 0.5f);
    const float m = flush(flush(flush(v * gi) * 0.5f) * flush(1.0f - t));
    const float a = flush(fmaf(m, t, m));
    const float inner = flush(fmaf(gi, cdf, flush(a * 0.797884583f)));
    out[i] = flush(fmaf(flush(a * 0.0356774069f), flush(x2 * 3.0f),
                        inner));
  }
}

static float from_bits(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static uint32_t to_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

static float exp_one(float x) {
  if (x != x) return x;
  x = x < -87.8f ? -87.8f : x;
  x = x > 88.8f ? 88.8f : x;
  float n = floorf(fmaf(x, 1.44269504088896341f, 0.5f));
  n = n < -127.0f ? -127.0f : n;
  n = n > 127.0f ? 127.0f : n;
  float a = fmaf(-0.693359375f, n, x);
  a = fmaf(2.12194440e-4f, n, a);
  float z = fmaf(a, 1.9875691500e-4f, 1.3981999507e-3f);
  z = fmaf(z, a, 8.3334519073e-3f);
  z = fmaf(z, a, 4.1665795894e-2f);
  z = fmaf(z, a, 1.6666665459e-1f);
  z = fmaf(z, a, 5.0000001201e-1f);
  z = fmaf(z, a * a, a);
  z = 1.0f + z;
  return z * from_bits((uint32_t)((int32_t)n + 127) << 23);
}

static float log_one(float x) {
  if (x != x || x < 0.0f) return NAN;
  if (x == 0.0f) return -INFINITY;
  if (isinf(x)) return INFINITY;
  float m = fmaxf(from_bits(0x00800000u), x);
  const float e0 = (float)((int32_t)(to_bits(m) >> 23) - 0x7f);
  m = from_bits((to_bits(m) & ~0x7f800000u) | to_bits(0.5f));
  float e = 1.0f + e0;
  const int small = m < 0.707106781186547524f;
  const float keep = small ? m : 0.0f;
  m = m - 1.0f;
  e = e - (small ? 1.0f : 0.0f);
  m = m + keep;
  const float x2 = m * m;
  const float x3 = x2 * m;
  float y = fmaf(m, 7.0376836292e-2f, -1.1514610310e-1f);
  float y1 = fmaf(m, -1.2420140846e-1f, 1.4249322787e-1f);
  float y2 = fmaf(m, 2.0000714765e-1f, -2.4999993993e-1f);
  y = fmaf(y, m, 1.1676998740e-1f);
  y1 = fmaf(y1, m, -1.6668057665e-1f);
  y2 = fmaf(y2, m, 3.3333331174e-1f);
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, -2.12194440e-4f * e);
  m = fmaf(-0.5f, x2, m);
  m = m + y;
  return fmaf(0.693359375f, e, m);
}

static const float LOG1P_NUM[7] = {
    4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
    6.5787325942061044846969e0f,  2.9911919328553073277375e1f,
    6.0949667980987787057556e1f,  5.7112963590585538103336e1f,
    2.0039553499201281259648e1f};
static const float LOG1P_DEN[7] = {
    1.0f, 1.5062909083469192043167e1f, 8.3047565967967209469434e1f,
    2.2176239823732856465394e2f, 3.0909872225312059774938e2f,
    2.1642788614495947685003e2f, 6.0118660497603843919306e1f};

static float log1p_one(float x) {
  if (fabsf(x) >= 0.41421356237309504880f) return log_one(x + 1.0f);
  float num = 0.0f, den = 0.0f;
  for (int i = 0; i < 7; ++i) {
    num = fmaf(num, x, LOG1P_NUM[i]);
    den = fmaf(den, x, LOG1P_DEN[i]);
  }
  const float x2 = x * x;
  float s = (x * x2) * (num / den);
  s = fmaf(-0.5f, x2, s);
  return x + s;
}

void xla_log(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = log_one(flush(x[i]));
}

void xla_exp(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = flush(exp_one(flush(x[i])));
}

void xla_logistic(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = flush(1.0f / (flush(exp_one(-flush(x[i]))) + 1.0f));
}

void xla_softplus(const float* x, float* out, long n) {
  for (long i = 0; i < n; ++i) {
    const float v = flush(x[i]);
    out[i] = v != v ? v
                    : flush(fmaxf(v, 0.0f) +
                            log1p_one(flush(exp_one(-fabsf(v)))));
  }
}

void xla_fma(const float* a, const float* b, const float* c, float* out,
             long n) {
  for (long i = 0; i < n; ++i) out[i] = fmaf(a[i], b[i], c[i]);
}

void xla_dot(const float* a, const float* b, float* out, long nb, long m,
             long k, long n, long lanes) {
  float* acc = malloc(sizeof(float) * (size_t)(lanes * n > 0 ? lanes * n : 1));
  if (acc == NULL) return;
  for (long z = 0; z < nb; ++z) {
    const float* az = a + z * m * k;
    const float* bz = b + z * k * n;
    float* oz = out + z * m * n;
    for (long i = 0; i < m; ++i) {
      const float* ai = az + i * k;
      for (long x = 0; x < lanes * n; ++x) acc[x] = 0.0f;
      for (long t = 0; t < k; ++t) {
        float* lane = acc + (t % lanes) * n;
        const float* bt = bz + t * n;
        if (t < lanes) {
          for (long j = 0; j < n; ++j) lane[j] = ai[t] * bt[j];
        } else {
          for (long j = 0; j < n; ++j) lane[j] = fmaf(ai[t], bt[j], lane[j]);
        }
      }
      for (long w = lanes; w > 1; w /= 2) {
        for (long q = 0; q < w / 2; ++q) {
          for (long j = 0; j < n; ++j)
            acc[q * n + j] = acc[2 * q * n + j] + acc[(2 * q + 1) * n + j];
        }
      }
      for (long j = 0; j < n; ++j) oz[i * n + j] = acc[j];
    }
  }
  free(acc);
}

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>

__attribute__((target("sse,fma"))) static float rsqrt_one(float x) {
  uint32_t bits;
  memcpy(&bits, &x, 4);
  const uint32_t mag = bits & 0x7fffffffu;
  if (mag > 0x7f800000u) return x;                     /* NaN */
  if (mag < 0x00800000u) return copysignf(INFINITY, x);  /* +-0, subnormal */
  if (bits >> 31) return NAN;                          /* negative */
  if (mag == 0x7f800000u) return 0.0f;                 /* +inf */
  const __m128 v = _mm_set_ss(x);
  __m128 e = _mm_rsqrt_ss(v);
  for (int k = 0; k < 2; ++k) {
    __m128 t = _mm_mul_ss(v, e);
    const __m128 h = _mm_mul_ss(e, _mm_set_ss(-0.5f));
    t = _mm_fmadd_ss(e, t, _mm_set_ss(-1.0f));
    e = _mm_fmadd_ss(h, t, e);
  }
  return _mm_cvtss_f32(e);
}

int xla_rsqrt(const float* x, float* out, long n, float scale, float add) {
  for (long i = 0; i < n; ++i) out[i] = rsqrt_one(fmaf(x[i], scale, add));
  return 0;
}
#else
int xla_rsqrt(const float* x, float* out, long n, float scale, float add) {
  (void)x;
  (void)out;
  (void)n;
  (void)scale;
  (void)add;
  return -1;
}
#endif
