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
// Each pass counts per lane in a register (a compare and an add an
// element) and sums the lanes once with __reduce_add_sync, instead of a
// __ballot_sync and a __popc an element; the sum is the same in every
// lane, so the branch on it never diverges.  The loop stops as soon as
// the count is exactly k: every threshold in (v_{k+1}, v_k] selects the
// same k entries, so the mask is the one the full 32 passes give, though
// the threshold's value may differ from ops/topk.py:topk_threshold's.
// Under a tie at v_k no midpoint counts exactly k, and the loop runs on
// to v_k as before.
//
// Rows wider than a warp's registers (whisper-large 32x: H = 40960, 160
// KB of f32) go to one CTA of kWideThreads threads instead
// (cta_kth_largest): thread t holds elements j*kWideThreads + t, each
// pass counts per thread, sums within the warp (__reduce_add_sync) and
// across the CTA's warps through shared memory, all in int32, and the
// loop stops at the first pass whose CTA total is exactly k, as the warp
// form does.  Integer sums are exact in any order, so every thread sees
// the same total and the CTA leaves the loop together, and the mask is
// the one the warp form and ops/topk.py:topk_threshold give (gaussian
// rows of 40960 at k = 32: ~17 passes, against 32).
//
// Rows wider than a CTA's registers (whisper-tiny 128x: H = 49152,
// whisper-large 64x: 81920; the TPU's blocked encode takes H up to 2^20)
// go to the spill form (spill_kth_largest): the first kMaxWideRow values
// stay in registers as in the CTA form, the next kSpillSmemInts in
// dynamic shared memory (both read once from device memory), and the rest
// is read again from device memory on every pass (a chunk's pre, in the
// L2 where it fits).  Its midpoints, totals and early stop are
// cta_kth_largest's, so its threshold is too.
#pragma once

#include <cuda_bf16.h>
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

// A threshold th with {xi >= th} = the row's k largest entries (with
// every entry tied with the k-th): the first midpoint that counts exactly
// k, else the largest lo with count(xi >= lo) >= k, the k-th largest
// value's monotone int.  Same start, midpoint and update as
// ops/topk.py:topk_threshold.
template <int N>
__device__ __forceinline__ int warp_kth_largest(const int (&xi)[N], int k) {
  int lo = -2147483647, hi = 2147483647;
#pragma unroll 1
  for (int pass = 0; pass < 32; ++pass) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += xi[j] >= mid ? 1 : 0;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (cnt == k) return mid;
    if (cnt > k) {
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

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A latent value in f32, or in bf16 (its bits, rounded to nearest even).
__device__ __forceinline__ void store_latent(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_latent(unsigned short* p, float v) {
  *p = float_to_bf16_bits(v);
}

// -- the CTA-per-row form -------------------------------------------------

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / kWarp;
// 80 values a thread (of at most 128 registers at 512 threads): 40960.
constexpr int kMaxPerThread = 80;
constexpr int kMaxWideRow = kWideThreads * kMaxPerThread;

// Per-thread register counts the wide kernels are instantiated for; a row
// of h values takes the smallest that holds it (wide_per_thread).
__host__ __device__ __forceinline__ int wide_per_thread(int h) {
  return h <= 8 * kWideThreads ? 8 : h <= 16 * kWideThreads ? 16 : h <= 32 * kWideThreads ? 32
                                                                                      : kMaxPerThread;
}

// Launches kernel-template instance KERNEL<N, ...> for the row width h
// (a macro, since a kernel template cannot be passed as an argument).
#define WST_WIDE_DISPATCH(h, LAUNCH)   \
  switch (::wst::wide_per_thread(h)) { \
    case 8: LAUNCH(8); break;          \
    case 16: LAUNCH(16); break;        \
    case 32: LAUNCH(32); break;        \
    default: LAUNCH(80); break;        \
  }

// Element j of thread t is row[j*kWideThreads + t]: loads coalesce.
template <int N>
__device__ __forceinline__ void load_wide_monotone(const float* row, int h, int (&xi)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    xi[j] = c < h ? monotone_int(row[c]) : kIntMin;
  }
}

// One pass's CTA total: each thread's count summed over its warp's lanes,
// then over the CTA's warps through warp_cnt[pass & 1], after one barrier.
__device__ __forceinline__ int cta_total(int cnt, int pass, int (&warp_cnt)[2][kWideWarps]) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  int* buf = warp_cnt[pass & 1];
  if (lane == 0) buf[warp] = cnt;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) total += buf[w];
  return total;
}

// warp_kth_largest over a row spread across the whole CTA (kWideThreads
// threads, every one of which must call it).  warp_cnt is __shared__
// scratch; its two halves alternate between passes, so one
// __syncthreads a pass suffices: a thread can write a half again only
// after every thread has passed the next pass's barrier, that is, after
// every thread has read the half.  Every thread sums the same 16 warp
// counts, so all return at the same pass, and no later pass writes the
// half the others may still be reading.
template <int N>
__device__ __forceinline__ int cta_kth_largest(const int (&xi)[N], int k,
                                               int (&warp_cnt)[2][kWideWarps]) {
  int lo = -2147483647, hi = 2147483647;
#pragma unroll 1
  for (int pass = 0; pass < 32; ++pass) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += xi[j] >= mid ? 1 : 0;
    const int total = cta_total(cnt, pass, warp_cnt);
    if (total == k) return mid;
    if (total > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// -- the spill form ---------------------------------------------------------

// Values of a row in dynamic shared memory past the registers: 224 KB of
// the 227 KB a CTA may opt in to on the H100, so a row of up to
// kMaxWideRow + kSpillSmemInts = 98,304 values is read from device memory
// once.
constexpr int kSpillSmemInts = 56 * 1024;
constexpr int kMaxSpillRow = 1 << 20;  // the TPU's blocked encode: _MAX_H

// cta_kth_largest over a row of h > kMaxWideRow values: thread t's
// registers xi (elements j*kWideThreads + t, all inside the row), the ns
// values sm[0:ns) (monotone ints of row[kMaxWideRow : kMaxWideRow + ns),
// strided over the threads) and row[g0:h) read again each pass (f32).
// Every thread of the CTA calls it after sm is written and a barrier.
template <int N>
__device__ __forceinline__ int spill_kth_largest(const int (&xi)[N], const int* sm, int ns,
                                                 const float* row, int g0, int h, int k,
                                                 int (&warp_cnt)[2][kWideWarps]) {
  int lo = -2147483647, hi = 2147483647;
#pragma unroll 1
  for (int pass = 0; pass < 32; ++pass) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += xi[j] >= mid ? 1 : 0;
#pragma unroll 4
    for (int s = threadIdx.x; s < ns; s += kWideThreads) cnt += sm[s] >= mid ? 1 : 0;
#pragma unroll 4
    for (int c = g0 + threadIdx.x; c < h; c += kWideThreads)
      cnt += monotone_int(__ldg(row + c)) >= mid ? 1 : 0;
    const int total = cta_total(cnt, pass, warp_cnt);
    if (total == k) return mid;
    if (total > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace wst
