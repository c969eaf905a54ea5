// Exact per-row top-k threshold shared by every kernel of the port.
//
// Replaces the bisection inside the Pallas kernels of the JAX package
// (whisper_sae_tpu/ops/pallas_topk.py:_mask_kernel,
// ops/pallas_sae.py:_encode_kernel and _fused_loss_kernel): the k-th
// largest value of a row is found exactly by 32 halvings of the int32
// range of the monotone integer view of its f32 bits, so `x >= th`
// selects the k largest entries (more only under exact ties).
//
// Design for Hopper: one warp owns one row and keeps it in registers
// (lane l holds elements j*32 + l, up to kMaxPerLane of them), so each of
// the 32 counting passes reads registers, not shared or device memory.
// Each pass counts with __ballot_sync/__popc; the count is the same in
// every lane, so the branch on it never diverges.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wst {

constexpr int kWarp = 32;
// A row of at most 3072 values (whisper-tiny's H) fits a warp's registers.
constexpr int kMaxPerLane = 96;
constexpr int kMaxRow = kWarp * kMaxPerLane;
constexpr int kIntMin = -2147483647 - 1;

// float order == int order; x ^ 0x7fffffff equals INT_MIN - x - 1 for
// x < 0 without the overflow, and the map is its own inverse.
__device__ __forceinline__ int monotone_int(float v) {
  const int x = __float_as_int(v);
  return x < 0 ? (x ^ 0x7fffffff) : x;
}

__device__ __forceinline__ float monotone_float(int x) {
  return __int_as_float(x < 0 ? (x ^ 0x7fffffff) : x);
}

// Loads row[0:h) into the warp's register slice.  Slots past h hold
// INT_MIN, which no midpoint (always > INT_MIN) counts.
template <int N>
__device__ __forceinline__ void load_row_monotone(const float* row, int h, int lane,
                                                  int (&xi)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWarp + lane;
    xi[j] = c < h ? monotone_int(row[c]) : kIntMin;
  }
}

// Largest lo with count(xi >= lo) >= k, the k-th largest value's monotone
// int.  Same start, midpoint and update as ops/topk.py:topk_threshold.
template <int N>
__device__ __forceinline__ int warp_kth_largest(const int (&xi)[N], int k) {
  int lo = -2147483647, hi = 2147483647;
#pragma unroll 1
  for (int pass = 0; pass < 32; ++pass) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += __popc(__ballot_sync(0xffffffffu, xi[j] >= mid));
    if (cnt >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// relu(pre) where pre is selected, else 0 (select THEN relu, as the
// reference encode orders it).
__device__ __forceinline__ float masked_relu(int x, int th) {
  return x >= th ? fmaxf(monotone_float(x), 0.0f) : 0.0f;
}

}  // namespace wst
