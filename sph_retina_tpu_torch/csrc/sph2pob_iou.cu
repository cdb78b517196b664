// Pairwise fused Sph2Pob IoU for Hopper (sm_90a):
//   boxes1 (N, D), boxes2 (M, D), fp32 degrees, D in {4, 5}  ->  (N, M) fp32.
//
// Replaces the TPU kernel sph_retina_tpu/ops/pallas_iou.py:
// sph2pob_iou_pairwise_tpu (_pairwise_call / _pairwise_kernel), which tiled
// the output 128 x 128, padded both box sets to tile multiples and fed them
// as transposed (D, N, 1) / (D, 1, M) planes. None of that is carried over.
//
// What bounds it on this card: arithmetic. A pair costs about 880 elementwise
// fp32 operations (859 for D = 4, 885 for D = 5, counted on the plain version
// by chip_smoke.py), among them 17 reciprocals, 3 divisions, 3 square roots
// and 8 to 12 sin/cos, against 4 bytes written and (N + M) * D * 4 bytes read
// for the whole matrix: at the card's fp32 rate the operations take about ten
// times as long as the store at its memory rate. So nothing N * M-sized but
// the output touches device memory, and the design keeps the per-pair body in
// registers: one thread owns one column (one box of boxes2, loaded once into
// registers) and walks kTileN rows of boxes1 that the block staged in shared
// memory, where every thread of a warp reads the same row (a broadcast, no
// bank conflict). Threads of a warp are neighbours along M, so each row's
// stores are coalesced 128-byte lines. The ragged edge is masked here; the
// wrapper pads nothing. Quantities of one box alone (its sines and cosines)
// cannot be hoisted out of the pair: the degree-space jitter shifts both
// boxes of a near-coincident pair before anything else is computed.
//
// Built by sph_retina_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded through ctypes.
#include <cuda_runtime.h>

#include "sph2pob_pair.cuh"

namespace {

constexpr int kTileM = 128;  // threads of a block, one column each
constexpr int kTileN = 16;   // rows of boxes1 a block walks

template <int D>
__global__ void __launch_bounds__(kTileM)
pairwise_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
                float* __restrict__ out, long long n, long long m, long long tiles_m) {
  __shared__ float rows[kTileN][D];

  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_m) * kTileN;
  const long long col = (tile % tiles_m) * kTileM + threadIdx.x;

  for (int k = threadIdx.x; k < kTileN * D; k += kTileM) {
    const long long r = row0 + k / D;
    rows[k / D][k % D] = r < n ? __ldg(boxes1 + r * D + k % D) : 1.0f;
  }
  __syncthreads();
  if (col >= m) return;

  float b2[D];
#pragma unroll
  for (int c = 0; c < D; ++c) b2[c] = __ldg(boxes2 + col * D + c);

  const int n_rows = (int)((n - row0 < kTileN) ? n - row0 : kTileN);
#pragma unroll 1
  for (int i = 0; i < n_rows; ++i) {
    float b1[D];
#pragma unroll
    for (int c = 0; c < D; ++c) b1[c] = rows[i][c];
    out[(row0 + i) * m + col] = sph2pob::pair_iou<D>(b1, b2);
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
  const long long tiles_n = (n + kTileN - 1) / kTileN;
  const long long blocks = tiles_m * tiles_n;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p1 = static_cast<const float*>(boxes1);
  const float* p2 = static_cast<const float*>(boxes2);
  float* po = static_cast<float*>(out);
  if (d == 4) {
    pairwise_kernel<4><<<grid, kTileM, 0, s>>>(p1, p2, po, n, m, tiles_m);
  } else if (d == 5) {
    pairwise_kernel<5><<<grid, kTileM, 0, s>>>(p1, p2, po, n, m, tiles_m);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
