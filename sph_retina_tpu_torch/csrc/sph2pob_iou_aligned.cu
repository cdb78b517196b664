// Aligned fused Sph2Pob IoU for Hopper (sm_90a):
//   boxes1 (N, D), boxes2 (N, D), fp32 degrees, D in {4, 5}  ->  (N,) fp32,
//   out[i] = IoU(boxes1[i], boxes2[i]).
//
// Replaces the TPU kernel sph_retina_tpu/ops/pallas_iou.py:
// sph2pob_iou_aligned_tpu (_aligned_call / _aligned_kernel), which transposed
// both box sets into (D, N/128, 128) component planes, padded them with 1.0
// to a multiple of block_rows * 128 pairs and walked the planes 32 rows of
// 128 lanes at a time. None of that is carried over: there is no transpose,
// no padding pass and no tile. A 1-D grid, one thread a pair; the thread
// reads its two rows from the row-major (N, D) inputs, runs the per-pair
// body shared with the pairwise kernel (sph2pob_pair.cuh, pair_iou<D>) in
// registers and writes one float.
//
// What bounds it on this card: arithmetic, narrowly. A pair costs about 880
// elementwise fp32 operations (counted on the plain version by
// chip_smoke.py) against 2 * D * 4 bytes read and 4 written, 36 bytes for
// D = 4 and 44 for D = 5: at the card's fp32 rate and its memory rate the two
// bounds lie within a quarter of each other, the operations above. Unlike the
// pairwise kernel nothing is reused between threads, so every input byte is
// read from device memory once and that is all the memory traffic there is.
// Rows of 16 bytes (D = 4) are one float4 load a thread, neighbouring threads
// on neighbouring addresses; rows of 20 bytes (D = 5) cannot be vectorised
// that way and are five scalar loads with a stride of 20 bytes across the
// warp, which the cache lines absorb (a warp's 32 rows are 640 contiguous
// bytes). The output store is coalesced.
//
// A library of its own (not a second entry point of sph2pob_iou.cu), so that
// the two sources compile side by side; built by
// sph_retina_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface, loaded through ctypes.
#include <cuda_runtime.h>

#include <cstdint>

#include "sph2pob_pair.cuh"

namespace {

constexpr int kThreads = 256;

// Vec4: both inputs are 16-byte aligned and D == 4, rows are float4 loads.
template <int D, bool Vec4>
__global__ void __launch_bounds__(kThreads)
aligned_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
               float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float b1[D], b2[D];
  if (Vec4) {
    const float4 v1 = __ldg(reinterpret_cast<const float4*>(boxes1) + i);
    const float4 v2 = __ldg(reinterpret_cast<const float4*>(boxes2) + i);
    b1[0] = v1.x; b1[1] = v1.y; b1[2] = v1.z; b1[3] = v1.w;
    b2[0] = v2.x; b2[1] = v2.y; b2[2] = v2.z; b2[3] = v2.w;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      b1[c] = __ldg(boxes1 + i * D + c);
      b2[c] = __ldg(boxes2 + i * D + c);
    }
  }
  out[i] = sph2pob::pair_iou<D>(b1, b2);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). Does not synchronise and allocates nothing. -1: bad D.
extern "C" int sph2pob_iou_aligned_launch(const void* boxes1, const void* boxes2,
                                          void* out, long long n, int d,
                                          void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p1 = static_cast<const float*>(boxes1);
  const float* p2 = static_cast<const float*>(boxes2);
  float* po = static_cast<float*>(out);
  if (d == 4) {
    const bool aligned16 =
        ((reinterpret_cast<std::uintptr_t>(p1) | reinterpret_cast<std::uintptr_t>(p2)) & 15u) == 0;
    if (aligned16) {
      aligned_kernel<4, true><<<grid, kThreads, 0, s>>>(p1, p2, po, n);
    } else {
      aligned_kernel<4, false><<<grid, kThreads, 0, s>>>(p1, p2, po, n);
    }
  } else if (d == 5) {
    aligned_kernel<5, false><<<grid, kThreads, 0, s>>>(p1, p2, po, n);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
