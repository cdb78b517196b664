// Aligned fused Sph2Pob IoU for Hopper (sm_90a):
//   boxes1 (N, D), boxes2 (N, D), fp32 degrees, D in {4, 5}  ->  (N,) fp32,
//   out[i] = IoU(boxes1[i], boxes2[i]).
//
// Replaces the TPU kernel sph_retina_tpu/ops/pallas_iou.py:
// sph2pob_iou_aligned_tpu (_aligned_call / _aligned_kernel), which transposed
// both box sets into (D, N/128, 128) component planes, padded them with 1.0
// to a multiple of block_rows * 128 pairs and walked the planes 32 rows of
// 128 lanes at a time. None of that is carried over: there is no transpose
// and no padding pass; the thread reads its two rows from the row-major
// (N, D) inputs.
//
// What bounds it on this card: the operations of the pairs that can overlap,
// then the bytes. Every pair costs 90 to 110 elementwise fp32 operations for
// its flag, its two boxes' states and the cull, and one that reaches the full
// body about 800 more (counted on the plain version's stages by
// chip_smoke.py), issued one at a time (-fmad=false); every pair reads
// 2 * D * 4 bytes and writes 4, 36 bytes for D = 4 and 44 for D = 5. The two
// bounds lie within a quarter of each other when every pair runs the body.
// Unlike the pairwise kernel nothing can be hoisted across pairs: every box
// is used once. But a pair whose boxes lie apart returns exactly 0.0
// (sph2pob_pair.cuh, "The cull and its margin"), and in random input more
// than half of them do.
//
// The design: a block owns 256 consecutive pairs, one a thread, or 512, two a
// thread, where the grid still has 4 blocks an SM (N > 269 824: N = 1e6
// runs 1 954 blocks; N = 98 208 keeps 384 blocks rather than 192).
// Each thread reads its pair (one float4 a row for D = 4 where both inputs
// are 16-byte aligned, scalar loads otherwise and for D = 5), builds the one
// state of each box that the pair's jitter flag selects (no more
// trigonometry than the whole body had), and culls: a culled pair stores
// 0.0f at once, a surviving one writes both states into the block's list in
// shared memory, placed by __ballot_sync / __popc and one shared atomic a
// warp and round. Survivors are scattered lane by lane (a warp is almost
// never culled whole), so without the list the body would run with the
// culled lanes idle. After __syncthreads() the block's threads stride over
// the list and run pair_body with every lane busy. Stores of the output are
// coalesced in the cull and mostly so in the body (a warp's survivors keep
// their order).
//
// A library of its own (not a second entry point of sph2pob_iou.cu), so that
// the two sources compile side by side; built by
// sph_retina_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface, loaded through ctypes.
#include <cuda_runtime.h>

#include <cstdint>

#include "sph2pob_pair.cuh"

namespace {

using sph2pob::SideState;

constexpr int kThreads = 256;
// Pairs a thread culls: 2 where the grid still has 4 blocks an SM, else 1.
constexpr long long kTwoPairMinBlocks = 4 * 132;

// Vec4: both inputs are 16-byte aligned and D == 4, rows are float4 loads.
template <int D, bool Vec4, int PairsPerThread>
__global__ void __launch_bounds__(kThreads)
aligned_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
               float* __restrict__ out, long long n) {
  constexpr int kSlots = kThreads * PairsPerThread;
  constexpr int kB = sph2pob::kBodyFloats<D>;
  __shared__ float body1[kB * kSlots];
  __shared__ float body2[kB * kSlots];
  __shared__ unsigned short pair_of[kSlots];
  __shared__ int count;

  const int t = threadIdx.x, lane = t & 31;
  const long long base = (long long)blockIdx.x * kSlots;
  if (t == 0) count = 0;
  __syncthreads();

  // ---- cull: store the zeros, list the survivors with their states -------
#pragma unroll
  for (int k = 0; k < PairsPerThread; ++k) {
    const int p = k * kThreads + t;
    const long long i = base + p;
    bool keep = false;
    SideState s1 = {}, s2 = {};
    if (i < n) {
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
      const bool sim = sph2pob::similar<D>(b1, b2);
      s1 = sph2pob::side_state<1, D>(b1, sim);
      s2 = sph2pob::side_state<2, D>(b2, sim);
      if (sph2pob::disjoint(s1, s2)) {
        out[i] = 0.0f;
      } else {
        keep = true;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (ballot != 0u) {  // uniform across the warp
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&count, __popc(ballot));
      slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(ballot & ((1u << lane) - 1u));
      if (keep) {
        sph2pob::store_body<D>(body1, kSlots, slot, s1);
        sph2pob::store_body<D>(body2, kSlots, slot, s2);
        pair_of[slot] = (unsigned short)p;
      }
    }
  }
  __syncthreads();

  // ---- body: the survivors, every lane busy ------------------------------
  const int total = count;
#pragma unroll 1
  for (int k = t; k < total; k += kThreads) {
    const SideState s1 = sph2pob::load_body<D>(body1, kSlots, k);
    const SideState s2 = sph2pob::load_body<D>(body2, kSlots, k);
    out[base + pair_of[k]] = sph2pob::pair_body<D>(s1, s2);
  }
}

template <int D, bool Vec4>
void launch(long long n, cudaStream_t s, const float* p1, const float* p2, float* po) {
  const long long two = (n + 2 * kThreads - 1) / (2 * kThreads);
  if (two >= kTwoPairMinBlocks) {
    aligned_kernel<D, Vec4, 2><<<(unsigned)two, kThreads, 0, s>>>(p1, p2, po, n);
  } else {
    const unsigned one = (unsigned)((n + kThreads - 1) / kThreads);
    aligned_kernel<D, Vec4, 1><<<one, kThreads, 0, s>>>(p1, p2, po, n);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success). Does not synchronise and allocates nothing. -1: bad D.
extern "C" int sph2pob_iou_aligned_launch(const void* boxes1, const void* boxes2,
                                          void* out, long long n, int d,
                                          void* stream) {
  if (n <= 0) return 0;
  if ((n + kThreads - 1) / kThreads > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p1 = static_cast<const float*>(boxes1);
  const float* p2 = static_cast<const float*>(boxes2);
  float* po = static_cast<float*>(out);
  if (d == 4) {
    const bool aligned16 =
        ((reinterpret_cast<std::uintptr_t>(p1) | reinterpret_cast<std::uintptr_t>(p2)) & 15u) == 0;
    if (aligned16) {
      launch<4, true>(n, s, p1, p2, po);
    } else {
      launch<4, false>(n, s, p1, p2, po);
    }
  } else if (d == 5) {
    launch<5, false>(n, s, p1, p2, po);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
