// Per-pair body of the fused Sph2Pob IoU, shared by every kernel that needs it.
//
// One call takes two spherical boxes in degrees, (theta, phi, alpha, beta) and
// for D == 5 also gamma, and returns their IoU in [0, 1]: degree-space jitter
// and clamp, deg -> rad, the efficient Sph2Pob transform with the in-plane
// angles held as (cos, sin), the rotated-box jitter in (cos, sin) space, the
// Green's-theorem clipped boundary integral over the 8 edges, and
// min(inter, area1, area2) / union.
//
// The arithmetic repeats sph_retina_tpu_torch/ops/fused_iou.py and
// sph_retina_tpu_torch/iou/rotated.py operation for operation and in the same
// order, select for select: near degenerate pairs (identical boxes, touching
// cells) the 1e-4 degree jitter thresholds decide the result, so an operation
// reordered or contracted here moves such a pair across a threshold that the
// plain version does not cross. For the same reason the file must be built
// without --use_fast_math (no __sinf, no flushed denormals) and with
// -fmad=false (see ops/_build.py).
//
// The constants below are the float32 roundings of the plain version's
// Python doubles; tests/test_torch_fused_iou.py parses them and compares.
#pragma once

namespace sph2pob {

// kEps = 1e-4 * 1.2345678, kAngEps = 1e-3 * 1.2345678, kCosEps = 1e-7
constexpr double kEpsD = 1e-4 * 1.2345678;
constexpr double kAngEpsD = 1e-3 * 1.2345678;
constexpr double kCosEpsD = 1e-7;
constexpr float kEps = (float)kEpsD;
constexpr float kEps2 = (float)(2 * kEpsD);
constexpr float kAngEps = (float)kAngEpsD;
constexpr float kCosLo = (float)(-1.0 + kCosEpsD);
constexpr float kCosHi = (float)(1.0 - kCosEpsD);
constexpr float kDeg2Rad = (float)(3.141592653589793 / 180.0);
constexpr float kMinSide1 = (float)(2 * kEpsD / 10.0);
constexpr float kMinSide2 = (float)(kEpsD / 10.0);
// cos and sin of the constant jitter rotations: eps, 5 eps, ang_eps, 2 ang_eps
constexpr float kCosE1 = (float)0.9999999923792118;
constexpr float kSinE1 = (float)0.00012345677968638734;
constexpr float kCosE5 = (float)0.9999998094802994;
constexpr float kSinE5 = (float)0.0006172838607984183;
constexpr float kCosA1 = (float)0.9999992379212704;
constexpr float kSinA1 = (float)0.001234567486387364;
constexpr float kCosA2 = (float)0.9999969516862431;
constexpr float kSinA2 = (float)0.0024691330910994844;

constexpr float kBig = 1e30f;
constexpr float kDivEps = 1e-12f;
constexpr float kHalfPi = (float)(3.141592653589793 / 2.0);
constexpr float kQuarterPi = (float)(3.141592653589793 / 4.0);

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// atan for x >= 0: Cephes atanf range reduction + degree-9 polynomial.
__device__ __forceinline__ float atan_cephes(float x) {
  const bool big = x > 2.414213562373095f;
  const bool mid = x > 0.4142135623730950f;
  const float x_big = -1.0f / (big ? x : 1.0f);
  const float x_mid = (x - 1.0f) / (x + 1.0f);
  const float z_in = big ? x_big : (mid ? x_mid : x);
  const float y0 = big ? kHalfPi : (mid ? kQuarterPi : 0.0f);
  const float z = z_in * z_in;
  const float p =
      (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
       3.33329491539e-1f) * z * z_in + z_in;
  return y0 + p;
}

__device__ __forceinline__ float arccos_poly(float x) {
  x = clampf(x, kCosLo, kCosHi);
  const float t = sqrtf((1.0f - x) / (1.0f + x));
  return 2.0f * atan_cephes(t);
}

// (cos a, sin a) -> (cos(a + delta), sin(a + delta)), delta a constant
__device__ __forceinline__ void rot_shift(float c, float s, float cd, float sd,
                                          float& co, float& so) {
  co = c * cd - s * sd;
  so = s * cd + c * sd;
}

// cos/sin of the signed angle from the frame axis (ax, ay, az) to tangent d
__device__ __forceinline__ void angle_cs(float dx, float dy, float dz, float ax,
                                         float ay, float az, float inv_an,
                                         float rx, float ry, float rz,
                                         float& cos_v, float& sin_v) {
  cos_v = clampf((dx * ax + dy * ay + dz * az) * inv_an, kCosLo, kCosHi);
  const float cxd_x = ay * dz - az * dy;
  const float cxd_y = az * dx - ax * dz;
  const float cxd_z = ax * dy - ay * dx;
  const float sign = (cxd_x * rx + cxd_y * ry + cxd_z * rz < 0.0f) ? 1.0f : -1.0f;
  sin_v = sign * sqrtf(fmaxf(1.0f - cos_v * cos_v, 0.0f));
}

// A planar oriented box: centre, sides, (cos, sin) of its angle.
struct Pob {
  float cx, cy, w, h, c, s;
};

// CCW corners of a box.
__device__ __forceinline__ void corners(const Pob& p, float (&x)[4], float (&y)[4]) {
  const float hw = p.w * 0.5f, hh = p.h * 0.5f;
  const float sx[4] = {1.0f, -1.0f, -1.0f, 1.0f};
  const float sy[4] = {1.0f, 1.0f, -1.0f, -1.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = sx[k] * hw, dy = sy[k] * hh;
    x[k] = p.cx + dx * p.c - dy * p.s;
    y[k] = p.cy + dx * p.s + dy * p.c;
  }
}

// Parameter interval of |u0 + t * d0| <= half.
__device__ __forceinline__ void axis_bounds(float u0, float d0, float half,
                                            float& lo, float& hi) {
  const bool mid = fabsf(d0) <= kDivEps;
  const float safe = mid ? kDivEps : d0;
  const float inv = 1.0f / safe;
  const float t1 = (half - u0) * inv;
  const float t2 = (-half - u0) * inv;
  lo = fminf(t1, t2);
  hi = fmaxf(t1, t2);
  const bool feas = fabsf(u0) <= half;
  lo = mid ? (feas ? -kBig : kBig) : lo;
  hi = mid ? (feas ? kBig : -kBig) : hi;
}

// Sum of shoelace cross terms of P's edges (world-frame corners px, py)
// clipped to box q.
__device__ __forceinline__ float edge_sum_greens(const float (&px)[4],
                                                 const float (&py)[4],
                                                 const Pob& q) {
  const float a = q.w * 0.5f, b = q.h * 0.5f;
  float fx[4], fy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float rx = px[k] - q.cx, ry = py[k] - q.cy;
    fx[k] = rx * q.c + ry * q.s;
    fy[k] = ry * q.c - rx * q.s;
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    const float ux = px[i], uy = py[i];
    const float dxw = px[j] - ux, dyw = py[j] - uy;
    const float uxf = fx[i], uyf = fy[i];
    const float dxf = fx[j] - uxf, dyf = fy[j] - uyf;
    float lox, hix, loy, hiy;
    axis_bounds(uxf, dxf, a, lox, hix);
    axis_bounds(uyf, dyf, b, loy, hiy);
    // both bounds clamped into [0, 1] BEFORE the empty-interval collapse, so
    // that an empty interval gives p == q at a point ON the segment
    const float t_lo = clampf(fmaxf(lox, loy), 0.0f, 1.0f);
    float t_hi = fminf(fminf(hix, hiy), 1.0f);
    t_hi = fmaxf(t_hi, t_lo);
    const float sx0 = ux + t_lo * dxw;
    const float sy0 = uy + t_lo * dyw;
    const float sx1 = ux + t_hi * dxw;
    const float sy1 = uy + t_hi * dyw;
    const float c = sx0 * sy1 - sy0 * sx1;
    acc = (i == 0) ? c : acc + c;
  }
  return acc;
}

// IoU of one pair of spherical boxes, degrees in. D is 4 or 5.
template <int D>
__device__ __forceinline__ float pair_iou(const float (&box1)[D],
                                          const float (&box2)[D]) {
  float b1[D], b2[D];

  // ---- degree-space jitter and clamp ------------------------------------
  bool similar = false;
#pragma unroll
  for (int c = 0; c < D; ++c) similar = similar | (fabsf(box1[c] - box2[c]) < kEps);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    b1[c] = similar ? box1[c] - kEps2 : box1[c];
    b2[c] = similar ? box2[c] + kEps : box2[c];
  }
  b1[0] = clampf(b1[0], kEps2, (float)(360.0 - kEpsD));
  b2[0] = clampf(b2[0], kEps, (float)(360.0 - 2 * kEpsD));
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    b1[c] = clampf(b1[c], kEps2, (float)(180.0 - kEpsD));
    b2[c] = clampf(b2[c], kEps, (float)(180.0 - 2 * kEpsD));
  }
  if (D == 5) {
    b1[D - 1] = clampf(b1[D - 1], (float)(-360.0 + 2 * kEpsD), (float)(360.0 - kEpsD));
    b2[D - 1] = clampf(b2[D - 1], (float)(-360.0 + kEpsD), (float)(360.0 - 2 * kEpsD));
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    b1[c] = b1[c] * kDeg2Rad;
    b2[c] = b2[c] * kDeg2Rad;
  }

  // ---- efficient Sph2Pob transform, angles as (cos, sin) ----------------
  const float sp1 = sinf(b1[1]), cp1 = cosf(b1[1]);
  const float st1 = sinf(b1[0]), ct1 = cosf(b1[0]);
  const float sp2 = sinf(b2[1]), cp2 = cosf(b2[1]);
  const float st2 = sinf(b2[0]), ct2 = cosf(b2[0]);

  // unit centre vectors and longitude tangents
  const float c1x = sp1 * ct1, c1y = sp1 * st1, c1z = cp1;
  const float c2x = sp2 * ct2, c2y = sp2 * st2, c2z = cp2;
  const float d1x = cp1 * ct1, d1y = cp1 * st1, d1z = -sp1;
  const float d2x = cp2 * ct2, d2y = cp2 * st2, d2z = -sp2;

  // frame axis c1 x c2 and in-plane sign reference c1 + c2
  const float ax = c1y * c2z - c1z * c2y;
  const float ay = c1z * c2x - c1x * c2z;
  const float az = c1x * c2y - c1y * c2x;
  const float rx = c1x + c2x, ry = c1y + c2y, rz = c1z + c2z;

  const float arc = arccos_poly(c1x * c2x + c1y * c2y + c1z * c2z);
  const float inv_an = rsqrtf(fmaxf(ax * ax + ay * ay + az * az, 1e-24f));

  float cos1, sin1, cos2, sin2;
  angle_cs(d1x, d1y, d1z, ax, ay, az, inv_an, rx, ry, rz, cos1, sin1);
  angle_cs(d2x, d2y, d2z, ax, ay, az, inv_an, rx, ry, rz, cos2, sin2);
  if (D == 5) {
    // ang -= gamma, by the angle-subtraction identities
    const float cg1 = cosf(b1[D - 1]), sg1 = sinf(b1[D - 1]);
    const float n1c = cos1 * cg1 + sin1 * sg1, n1s = sin1 * cg1 - cos1 * sg1;
    cos1 = n1c;
    sin1 = n1s;
    const float cg2 = cosf(b2[D - 1]), sg2 = sinf(b2[D - 1]);
    const float n2c = cos2 * cg2 + sin2 * sg2, n2s = sin2 * cg2 - cos2 * sg2;
    cos2 = n2c;
    sin2 = n2s;
  }

  Pob p1 = {0.0f, 0.0f, b1[2], b1[3], cos1, sin1};
  Pob p2 = {arc, 0.0f, b2[2], b2[3], cos2, sin2};

  // ---- rotated-box jitter in (cos, sin) space ----------------------------
  {
    const float sin_diff = fabsf(p1.s * p2.c - p1.c * p2.s);
    const bool sim = (fabsf(p1.cx - p2.cx) < kEps) | (fabsf(p1.w - p2.w) < kEps) |
                     (fabsf(p1.h - p2.h) < kEps) | (sin_diff < kEps);
    float cs, ss;
    p1.cx = sim ? p1.cx + kEps : p1.cx;
    p1.cy = sim ? p1.cy + kEps : p1.cy;
    p1.w = sim ? p1.w + kEps2 : p1.w;
    p1.h = sim ? p1.h + kEps2 : p1.h;
    rot_shift(p1.c, p1.s, kCosE1, kSinE1, cs, ss);
    p1.c = sim ? cs : p1.c;
    p1.s = sim ? ss : p1.s;
    p2.cx = sim ? p2.cx + kEps2 : p2.cx;
    p2.cy = sim ? p2.cy + kEps2 : p2.cy;
    p2.w = sim ? p2.w + kEps : p2.w;
    p2.h = sim ? p2.h + kEps : p2.h;
    rot_shift(p2.c, p2.s, kCosE5, kSinE5, cs, ss);
    p2.c = sim ? cs : p2.c;
    p2.s = sim ? ss : p2.s;

    const bool ang_close = fabsf(p1.s * p2.c - p1.c * p2.s) < kAngEps;
    rot_shift(p1.c, p1.s, kCosA1, kSinA1, cs, ss);
    p1.c = ang_close ? cs : p1.c;
    p1.s = ang_close ? ss : p1.s;
    rot_shift(p2.c, p2.s, kCosA2, kSinA2, cs, ss);
    p2.c = ang_close ? cs : p2.c;
    p2.s = ang_close ? ss : p2.s;

    p1.w = fmaxf(p1.w, kMinSide1);
    p1.h = fmaxf(p1.h, kMinSide1);
    p2.w = fmaxf(p2.w, kMinSide2);
    p2.h = fmaxf(p2.h, kMinSide2);
  }

  // ---- Green's-theorem intersection and IoU ------------------------------
  const float area1 = fabsf(p1.w * p1.h);
  const float area2 = fabsf(p2.w * p2.h);
  float x1[4], y1[4], x2[4], y2[4];
  corners(p1, x1, y1);
  corners(p2, x2, y2);
  const float total = edge_sum_greens(x1, y1, p2) + edge_sum_greens(x2, y2, p1);
  float inter = fmaxf(0.5f * total, 0.0f);
  // bounded by each area: a boundary run shared bitwise-exactly is counted
  // twice by the Green's form; the jitter makes that improbable, not impossible
  inter = fminf(fminf(inter, area1), area2);
  const float uni = area1 + area2 - inter;
  return clampf(inter / uni, 0.0f, 1.0f);
}

}  // namespace sph2pob
