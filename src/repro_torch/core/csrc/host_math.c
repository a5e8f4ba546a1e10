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
 * Built with -O2 -fno-fast-math -ffp-contract=off (repro_torch.core.
 * host_math): no contraction of x * e and no vectorised libmvec calls.
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
