// Per-pair body of the fused Sph2Pob IoU, shared by every kernel that needs it.
//
// The IoU of two spherical boxes in degrees, (theta, phi, alpha, beta) and for
// D == 5 also gamma, in [0, 1]: degree-space jitter and clamp, deg -> rad, the
// efficient Sph2Pob transform with the in-plane angles held as (cos, sin), the
// rotated-box jitter in (cos, sin) space, the Green's-theorem clipped boundary
// integral over the 8 edges, and min(inter, area1, area2) / union. It comes in
// three stages, so that a kernel can do the work of one box once and skip the
// pairs that cannot overlap:
//
//   similar<D>(raw1, raw2)  the pair's degree-space jitter flag;
//   side_state<Side, D>     everything of ONE box in one jitter state: clamped
//                           radians, centre vector c, longitude tangent d,
//                           sides w, h, cos/sin gamma, and the cull radius r;
//   disjoint<D>(s1, s2)     the exact cull: true only where the IoU is 0.0;
//   pair_body<D>(s1, s2)    the rest, from the frame axis c1 x c2 to the clamp.
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
// Hoisting. The degree-space jitter moves EVERY component of box 1 by the
// constant -2 eps and of box 2 by +eps, and only its flag belongs to the pair.
// So a box has exactly two possible states on each side, unjittered and
// jittered, and everything side_state computes can be computed once per box,
// side and state, then picked by the pair's flag: the same operations in the
// same order, so the same bits. (The rotated-box jitter that follows depends
// on the pair throughout, but uses constant rotations: it stays in pair_body
// and costs no trigonometry.)
//
// The cull and its margin. In pair_body box 1 is a w1 x h1 rectangle centred
// at (0, 0) and box 2 a w2 x h2 rectangle at (arc, 0), arc =
// arccos_poly(dot(c1, c2)); a rectangle lies inside the disc of radius
// R = sqrt(w^2 + h^2) / 2 about its centre. Where the two rectangles are
// apart, every clipped edge interval in edge_sum_greens is empty, so
// t_hi == t_lo, the clipped end points are equal, and c = sx0*sy1 - sy0*sx1 is
// x*y - y*x, which is exactly 0.0 in IEEE arithmetic without contraction: the
// intersection is 0.0 and so is the IoU (the union is at least the min-side
// clamp's area). disjoint() claims that when arc > R1 + R2 + kCullMargin.
// What the margin has to cover, in radians:
//   - the rotated-box jitter: it moves the centres apart or together by at
//     most |(eps, eps)| = 1.75e-4, and grows each side by at most
//     2 eps + kMinSide1 (box 1) or eps + kMinSide2 (box 2), so R by at most
//     1/sqrt(2) of that: 1.92e-4 and 0.96e-4; the rotations change no R.
//     Together 4.63e-4;
//   - the test is in cosines, on the very dot product that pair_body turns
//     into arc: dot < cos_lb(S), S = r1 + r2 = R1 + R2 + kCullMargin, with
//     cos_lb(x) = 1 - x^2/2 + x^4/24 - x^6/720 <= cos x for every x (the
//     alternating series cut after a negative term), so no trigonometry per
//     box. Rounded in fp32, cos_lb errs by about 2e-7; near 1 an error of
//     delta in a cosine is delta / sin S in the angle, at most 1e-4 for
//     S >= kCullMargin. cos_lb falls below -1 from S = 2.79 on, and falls
//     monotonically, so the test never fires where arc nears pi;
//   - arccos_poly against the true arccos of the same fp32 dot: ~1e-7 for the
//     polynomial and ~5e-7 for its rounding; its clamp at 1 - 1e-7 only raises
//     small arcs; R in fp32: ~1e-6;
//   - the planar clipping's own rounding, ~1e-6 on coordinates below pi.
// About 5.7e-4 in all. kCullMargin = 2e-3 rad (0.11 degree) leaves 3.5 times
// that; it costs the cull nothing measurable. sph2pob_disjoint_plain in
// ops/fused_iou.py is the same predicate in plain PyTorch, and the CPU tests
// hold that wherever it says "disjoint" the plain IoU is exactly 0.0.
//
// The constants below are the float32 roundings of the plain version's
// Python doubles; tests/test_torch_fused_iou.py and
// tests/test_torch_sph2pob_cull.py parse them and compare.
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

// the cull: margin (radians) and the coefficients of cos_lb
constexpr double kCullMarginD = 2e-3;
constexpr float kHalfCullMargin = (float)(kCullMarginD / 2.0);
constexpr float kCosLb6 = (float)(-1.0 / 720.0);
constexpr float kCosLb4 = (float)(1.0 / 24.0);

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

// What one box contributes to a pair, in one side's jitter state. For D == 4
// cg and sg are unused.
struct SideState {
  float cx, cy, cz;  // unit centre vector
  float dx, dy, dz;  // longitude tangent
  float w, h;        // sides, radians
  float cg, sg;      // cos and sin of gamma
  float r;           // cull radius: sqrt(w^2 + h^2) / 2 + kCullMargin / 2
};

// Floats of a SideState that pair_body reads (all but r), and how they are
// kept in shared memory: field k of entry i at base[k * stride + i].
template <int D>
constexpr int kBodyFloats = D == 5 ? 10 : 8;

template <int D>
__device__ __forceinline__ void store_body(float* base, int stride, int i,
                                           const SideState& s) {
  base[0 * stride + i] = s.cx;
  base[1 * stride + i] = s.cy;
  base[2 * stride + i] = s.cz;
  base[3 * stride + i] = s.dx;
  base[4 * stride + i] = s.dy;
  base[5 * stride + i] = s.dz;
  base[6 * stride + i] = s.w;
  base[7 * stride + i] = s.h;
  if (D == 5) {
    base[8 * stride + i] = s.cg;
    base[9 * stride + i] = s.sg;
  }
}

template <int D>
__device__ __forceinline__ SideState load_body(const float* base, int stride,
                                               int i) {
  SideState s;
  s.cx = base[0 * stride + i];
  s.cy = base[1 * stride + i];
  s.cz = base[2 * stride + i];
  s.dx = base[3 * stride + i];
  s.dy = base[4 * stride + i];
  s.dz = base[5 * stride + i];
  s.w = base[6 * stride + i];
  s.h = base[7 * stride + i];
  s.cg = D == 5 ? base[8 * stride + i] : 0.0f;
  s.sg = D == 5 ? base[9 * stride + i] : 0.0f;
  s.r = 0.0f;
  return s;
}

// The degree-space jitter flag of a pair: some component closer than eps.
template <int D>
__device__ __forceinline__ bool similar(const float (&box1)[D],
                                        const float (&box2)[D]) {
  bool sim = false;
#pragma unroll
  for (int c = 0; c < D; ++c) sim = sim | (fabsf(box1[c] - box2[c]) < kEps);
  return sim;
}

// One box (Side 1: boxes1, Side 2: boxes2) in one jitter state: the jitter
// shift, the clamp into the open coordinate ranges, deg -> rad, and what the
// Sph2Pob transform needs of the box alone.
template <int Side, int D>
__device__ __forceinline__ SideState side_state(const float (&box)[D],
                                                bool jitter) {
  float b[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    b[c] = Side == 1 ? (jitter ? box[c] - kEps2 : box[c])
                     : (jitter ? box[c] + kEps : box[c]);
  }
  if (Side == 1) {
    b[0] = clampf(b[0], kEps2, (float)(360.0 - kEpsD));
#pragma unroll
    for (int c = 1; c < 4; ++c) b[c] = clampf(b[c], kEps2, (float)(180.0 - kEpsD));
    if (D == 5)
      b[D - 1] = clampf(b[D - 1], (float)(-360.0 + 2 * kEpsD), (float)(360.0 - kEpsD));
  } else {
    b[0] = clampf(b[0], kEps, (float)(360.0 - 2 * kEpsD));
#pragma unroll
    for (int c = 1; c < 4; ++c) b[c] = clampf(b[c], kEps, (float)(180.0 - 2 * kEpsD));
    if (D == 5)
      b[D - 1] = clampf(b[D - 1], (float)(-360.0 + kEpsD), (float)(360.0 - 2 * kEpsD));
  }
#pragma unroll
  for (int c = 0; c < D; ++c) b[c] = b[c] * kDeg2Rad;

  SideState s;
  const float sp = sinf(b[1]), cp = cosf(b[1]);
  const float st = sinf(b[0]), ct = cosf(b[0]);
  s.cx = sp * ct;
  s.cy = sp * st;
  s.cz = cp;
  s.dx = cp * ct;
  s.dy = cp * st;
  s.dz = -sp;
  s.w = b[2];
  s.h = b[3];
  s.cg = D == 5 ? cosf(b[D - 1]) : 0.0f;
  s.sg = D == 5 ? sinf(b[D - 1]) : 0.0f;
  s.r = 0.5f * sqrtf(b[2] * b[2] + b[3] * b[3]) + kHalfCullMargin;
  return s;
}

// dot(c1, c2), written as pair_body's arccos argument is.
__device__ __forceinline__ float centre_dot(const SideState& s1,
                                            const SideState& s2) {
  return s1.cx * s2.cx + s1.cy * s2.cy + s1.cz * s2.cz;
}

// True only for pairs whose IoU pair_body returns as exactly 0.0: the centres
// lie more than R1 + R2 + kCullMargin apart (see the note at the top). Reads
// c and r of each state.
__device__ __forceinline__ bool disjoint(const SideState& s1,
                                         const SideState& s2) {
  const float sum = s1.r + s2.r;
  const float x = sum * sum;
  const float cos_lb = ((kCosLb6 * x + kCosLb4) * x - 0.5f) * x + 1.0f;
  return centre_dot(s1, s2) < cos_lb;
}

// IoU of one pair from its two states (each picked by the pair's similar()).
template <int D>
__device__ __forceinline__ float pair_body(const SideState& s1,
                                           const SideState& s2) {
  // frame axis c1 x c2 and in-plane sign reference c1 + c2
  const float ax = s1.cy * s2.cz - s1.cz * s2.cy;
  const float ay = s1.cz * s2.cx - s1.cx * s2.cz;
  const float az = s1.cx * s2.cy - s1.cy * s2.cx;
  const float rx = s1.cx + s2.cx, ry = s1.cy + s2.cy, rz = s1.cz + s2.cz;

  const float arc = arccos_poly(centre_dot(s1, s2));
  const float inv_an = rsqrtf(fmaxf(ax * ax + ay * ay + az * az, 1e-24f));

  float cos1, sin1, cos2, sin2;
  angle_cs(s1.dx, s1.dy, s1.dz, ax, ay, az, inv_an, rx, ry, rz, cos1, sin1);
  angle_cs(s2.dx, s2.dy, s2.dz, ax, ay, az, inv_an, rx, ry, rz, cos2, sin2);
  if (D == 5) {
    // ang -= gamma, by the angle-subtraction identities
    const float n1c = cos1 * s1.cg + sin1 * s1.sg, n1s = sin1 * s1.cg - cos1 * s1.sg;
    cos1 = n1c;
    sin1 = n1s;
    const float n2c = cos2 * s2.cg + sin2 * s2.sg, n2s = sin2 * s2.cg - cos2 * s2.sg;
    cos2 = n2c;
    sin2 = n2s;
  }

  Pob p1 = {0.0f, 0.0f, s1.w, s1.h, cos1, sin1};
  Pob p2 = {arc, 0.0f, s2.w, s2.h, cos2, sin2};

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
