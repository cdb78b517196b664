// Pairwise fused Sph2Pob IoU for Hopper (sm_90a):
//   boxes1 (N, D), boxes2 (M, D), fp32 degrees, D in {4, 5}  ->  (N, M) fp32.
//
// Replaces the TPU kernel sph_retina_tpu/ops/pallas_iou.py:
// sph2pob_iou_pairwise_tpu (_pairwise_call / _pairwise_kernel), which tiled
// the output 128 x 128, padded both box sets to tile multiples and fed them
// as transposed (D, N/128, 128) / (D, 1, M) planes. None of that is carried
// over.
//
// What bounds it on this card: the operations of the pairs that can overlap,
// and, where few can, the output store. A pair that reaches the full body
// costs about 810 elementwise fp32 operations once its boxes' states are
// made (counted on the plain version's stages by chip_smoke.py), among them
// ~20 IEEE divisions and reciprocals and 3 to 5 square roots, all issued one
// at a time (-fmad=false). Most pairs of a real input cannot overlap (the
// assignment input: a few gts against 98 208 anchors in spatial order; NMS
// candidates spread over the sphere), and for those the body returns exactly
// 0.0 (sph2pob_pair.cuh, "The cull and its margin"). What is left a culled
// pair is its flag and the cull (~35 operations, and selects and four
// 16-byte shared-memory loads) and its 4-byte store: the N * M * 4
// bytes of output, 100 MB at the assignment shape, are the bytes bound.
//
// The design does work in proportion to the pairs that can overlap:
//   1. Prologue. A block of 256 threads owns a tile of kRows x 128 output
//      elements: two halves of 128 threads, one thread a column in each.
//      Half 0 computes the unjittered state of its column, half 1 the
//      jittered one; the tile's rows get both states from the first 2 * kRows
//      threads. That is 2 * (kRows + 128) calls of side_state, which hold all
//      the trigonometry, where the pairs would make 2 * kRows * 128. Both
//      states are made because each pair's flag picks one (only the flag
//      belongs to the pair, see the header). A row's raw degrees and the
//      (c, r) of its two states make one record in shared memory, read as
//      16-byte broadcast loads; a column's (c, r) of each state is one float4.
//   2. Cull. Each thread walks its half of the tile's rows for its column:
//      the flag, the state it picks, disjoint(). A culled pair stores 0.0f at
//      once; a warp's 32 lanes are neighbours along M, so those stores are
//      coalesced lines. A surviving pair goes into the block's list in shared
//      memory, placed by __ballot_sync / __popc and one shared atomic a warp
//      and row.
//   3. Body. After __syncthreads() all 256 threads stride over the list and
//      run pair_body on both states read from shared memory, every lane busy
//      whatever the spatial pattern of the survivors.
// The ragged edge is masked; the wrapper pads nothing, and nothing N * M-sized
// but the output touches device memory. Survivors are uneven across tiles
// (at the assignment input most tiles have none, and those where gts meet the
// anchors have nearly all), so a tile is small, 16 x 128, and its body has 8
// warps. That does each column's trigonometry 16 times at the assignment
// shape (256, 98208) instead of 256, and gives the serving shape (1000, 1000)
// 504 blocks over 132 SMs. 32-row tiles halve the columns' prologue but give
// the serving shape 256 blocks, of which those holding the clustered NMS
// candidates' survivors run twice as long: on the card they were slower at
// the serving sizes and no faster at the assignment shape (PERF.md, PR 3). At
// most 64 registers a thread keep four blocks, 32 warps, on an SM.
//
// Built by sph_retina_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded through ctypes.
#include <cuda_runtime.h>

#include "sph2pob_pair.cuh"

namespace {

using sph2pob::SideState;

constexpr int kTileM = 128;  // columns of a tile
constexpr int kHalves = 2;   // row halves: a thread a column in each
constexpr int kThreads = kTileM * kHalves;
constexpr int kRows = 16;    // rows of a tile

// A row's record for the cull: the raw degrees, then (cx, cy, cz, r) of
// state 0 and of state 1, padded to whole float4s.
template <int D>
constexpr int kRecFloats = D == 5 ? 16 : 12;

// List entry: column (7 bits), row in the tile (6 bits), jitter flag (bit 13).
constexpr int kRowShift = 7;
constexpr int kFlagShift = 13;

template <int D>
__global__ void __launch_bounds__(kThreads, 4)
pairwise_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
                float* __restrict__ out, long long n, long long m, long long tiles_m) {
  static_assert(kRows <= (1 << (kFlagShift - kRowShift)) && kTileM == (1 << kRowShift),
                "list entries must fit their fields");
  constexpr int kB = sph2pob::kBodyFloats<D>;
  constexpr int kRec = kRecFloats<D>;
  constexpr int kHalfRows = kRows / kHalves;
  __shared__ __align__(16) float rec1[kRows][kRec];
  __shared__ float4 cull2[2][kTileM];  // (cx, cy, cz, r) of each column state
  __shared__ float body1[2][kB * kRows];
  __shared__ float body2[2][kB * kTileM];
  __shared__ unsigned short list[kRows * kTileM];
  __shared__ int count;

  const int t = threadIdx.x, lane = t & 31;
  const int j = t & (kTileM - 1), half = t / kTileM;
  const long long row0 = (blockIdx.x / tiles_m) * kRows;
  const long long col0 = (blockIdx.x % tiles_m) * kTileM;
  const long long col = col0 + j;
  const bool col_ok = col < m;
  const int n_rows = (int)((n - row0 < kRows) ? n - row0 : kRows);

  // ---- 1. prologue: both jitter states of the tile's boxes ----------------
  float raw2[D];
#pragma unroll
  for (int c = 0; c < D; ++c) raw2[c] = col_ok ? __ldg(boxes2 + col * D + c) : 1.0f;
  {  // half 0 makes state 0 of its column, half 1 state 1
    const SideState q = sph2pob::side_state<2, D>(raw2, half != 0);
    sph2pob::store_body<D>(body2[half], kTileM, j, q);
    cull2[half][j] = make_float4(q.cx, q.cy, q.cz, q.r);
  }

#pragma unroll 1
  for (int k = t; k < 2 * n_rows; k += kThreads) {
    const int i = k >> 1;
    const int jit = k & 1;
    float raw1[D];
#pragma unroll
    for (int c = 0; c < D; ++c) raw1[c] = __ldg(boxes1 + (row0 + i) * D + c);
    const SideState s = sph2pob::side_state<1, D>(raw1, jit != 0);
    sph2pob::store_body<D>(body1[jit], kRows, i, s);
    float* rec = rec1[i];
    if (jit == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) rec[c] = raw1[c];
    }
    const int o = D + 4 * jit;
    rec[o] = s.cx;
    rec[o + 1] = s.cy;
    rec[o + 2] = s.cz;
    rec[o + 3] = s.r;
  }
  if (t == 0) count = 0;
  __syncthreads();

  // ---- 2. cull: store the zeros, list the survivors ------------------------
  // (each half walks its half of the rows; a warp lies in one half)
  const int i_end = min(n_rows, (half + 1) * kHalfRows);
#pragma unroll 1
  for (int i = half * kHalfRows; i < i_end; ++i) {
    float rec[kRec];
    const float4* r4 = reinterpret_cast<const float4*>(rec1[i]);
#pragma unroll
    for (int v = 0; v < kRec / 4; ++v) {
      const float4 x = r4[v];
      rec[4 * v] = x.x;
      rec[4 * v + 1] = x.y;
      rec[4 * v + 2] = x.z;
      rec[4 * v + 3] = x.w;
    }
    float raw1[D];
#pragma unroll
    for (int c = 0; c < D; ++c) raw1[c] = rec[c];
    const bool sim = sph2pob::similar<D>(raw1, raw2);
    SideState p, q;
    p.cx = sim ? rec[D + 4] : rec[D];
    p.cy = sim ? rec[D + 5] : rec[D + 1];
    p.cz = sim ? rec[D + 6] : rec[D + 2];
    p.r = sim ? rec[D + 7] : rec[D + 3];
    const float4 cq = cull2[sim ? 1 : 0][j];
    q.cx = cq.x;
    q.cy = cq.y;
    q.cz = cq.z;
    q.r = cq.w;
    bool keep = false;
    if (col_ok) {
      if (sph2pob::disjoint(p, q)) {
        out[(row0 + i) * m + col] = 0.0f;
      } else {
        keep = true;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (ballot != 0u) {  // uniform across the warp
      int base = 0;
      if (lane == 0) base = atomicAdd(&count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep) {
        list[base + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)(
            ((sim ? 1 : 0) << kFlagShift) | (i << kRowShift) | j);
      }
    }
  }
  __syncthreads();

  // ---- 3. body: the survivors, every lane busy ----------------------------
  const int total = count;
#pragma unroll 1
  for (int k = t; k < total; k += kThreads) {
    const int e = list[k];
    const int jj = e & (kTileM - 1);
    const int i = (e >> kRowShift) & ((1 << (kFlagShift - kRowShift)) - 1);
    const int jit = e >> kFlagShift;
    const SideState s1 = sph2pob::load_body<D>(body1[jit], kRows, i);
    const SideState s2 = sph2pob::load_body<D>(body2[jit], kTileM, jj);
    out[(row0 + i) * m + col0 + jj] = sph2pob::pair_body<D>(s1, s2);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). Does not synchronise and allocates nothing. -1: bad D.
extern "C" int sph2pob_iou_pairwise_launch(const void* boxes1, const void* boxes2,
                                           void* out, long long n, long long m,
                                           int d, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const long long tiles_m = (m + kTileM - 1) / kTileM;
  const long long blocks = tiles_m * ((n + kRows - 1) / kRows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p1 = static_cast<const float*>(boxes1);
  const float* p2 = static_cast<const float*>(boxes2);
  float* po = static_cast<float*>(out);
  if (d == 4) {
    pairwise_kernel<4><<<grid, kThreads, 0, s>>>(p1, p2, po, n, m, tiles_m);
  } else if (d == 5) {
    pairwise_kernel<5><<<grid, kThreads, 0, s>>>(p1, p2, po, n, m, tiles_m);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
