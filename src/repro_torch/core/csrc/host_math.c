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
 *
 * Built with -O2 -fno-fast-math -ffp-contract=off (repro_torch.core.
 * host_math): no contraction of x * e and no vectorised libmvec calls;
 * fmaf is the C library's correctly rounded fused multiply-add.
 */
#include <math.h>
#include <stdint.h>
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
