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
// whisper-large 64x: 81920, kernel C up to 262,144; the TPU's blocked
// encode takes H up to 2^20) go to the cluster form
// (cluster_kth_largest): a thread-block cluster of C = 2, 4 or 8 CTAs
// holds the row, each CTA a contiguous slice of it, read from device
// memory once -- kClusterRegs values in registers, up to kClusterSmemInts
// more in shared memory (past 8 * kClusterSlice = 327,680 values, the
// rest of a slice is read again each pass).  A pass's warp counts go to
// every CTA of the cluster over distributed shared memory, each
// announced by an arrive on the receiver's mbarrier; every CTA sums the
// same C * 8 counts, so the cluster leaves the loop together, with
// cta_kth_largest's midpoints, totals and stop.  Passes 0 and 1 share one
// sweep (pass 1's mid is one of two, known before pass 0's total), whose
// exchange also brings the row's largest value, and a pass whose mid lies
// above it needs no count.  Once passes have set both lo and hi and at
// most kClusterCand values lie in [lo, hi), the CTAs write those values
// into one list in every CTA's shared memory, each warp's at the prefix
// of the warps' counts at lo and hi apart (the group form's compaction,
// select_decode.cuh: group_kth_largest), and one warp of each CTA
// finishes the passes on its list alone: total = c_hi + the candidates
// >= mid.  The threshold and the pass count are cta_kth_largest's
// (ops/topk.py:cluster_threshold).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

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

// -- the cluster form ------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / kWarp;
// values a thread in registers: 84 of at most 128 registers at two CTAs
// an SM leave the select's temporaries room (88 and 96 spill, -Xptxas -v)
constexpr int kClusterPerThread = 84;
constexpr int kClusterRegs = kClusterThreads * kClusterPerThread;  // 21,504 a CTA
// values a CTA holds on chip: registers, then dynamic shared memory (76
// KB), beside the 34 KB of static state, within half an SM's 228 KB: two
// CTAs an SM
constexpr int kClusterSlice = 40960;
constexpr int kClusterSmemInts = kClusterSlice - kClusterRegs;
constexpr int kClusterRun = 4 * kClusterThreads;  // the shared part's unit: an int4 a thread
constexpr int kClusterMaxCtas = 8;               // the largest portable cluster
constexpr int kClusterCand = 8192;               // candidates of the compaction at most
constexpr int kListChunk = 4 * kWarp;            // the list's sweep: an int4 a lane
// pass 1's mid after pass 0 (mid 0) sets lo = 0, or hi = 0
constexpr int kMidUp = 0x3fffffff, kMidDown = -0x40000000;
constexpr int kMaxBlockedRow = 1 << 20;          // the TPU's blocked encode: _MAX_H
static_assert(kClusterSmemInts > 0 && kClusterSmemInts % kClusterRun == 0, "whole runs");

// The cluster's CTAs for a row of h values: the fewest of 2, 4 and 8
// whose slices hold the row on chip (8 past 8 * kClusterSlice).
__host__ __device__ __forceinline__ int cluster_ctas(int h) {
  return h <= 2 * kClusterSlice ? 2 : h <= 4 * kClusterSlice ? 4 : kClusterMaxCtas;
}
// A CTA's slice: ceil(h / c) rounded up to a multiple of 32 (the last
// slice is the row's rest).
__host__ __device__ __forceinline__ int cluster_slice(int h, int c) {
  const int s = (h + c - 1) / c;
  return (s + kWarp - 1) / kWarp * kWarp;
}
// A CTA's ints of dynamic shared memory: its slice past the registers, up
// to kClusterSmemInts, in whole runs (kIntMin past the slice).
__host__ __device__ __forceinline__ int cluster_smem_ints(int slice) {
  const int s = slice - kClusterRegs;
  const int n = s <= 0 ? 0 : s < kClusterSmemInts ? s : kClusterSmemInts;
  return (n + kClusterRun - 1) / kClusterRun * kClusterRun;
}

// A CTA's static shared state of the cluster select.
struct ClusterSelScratch {
  alignas(16) int cand[kClusterCand];  // the compaction's candidates: the cluster's, in every CTA
  int cnt[2][kClusterMaxCtas * kClusterWarps];  // an exchange's warp counts (halves alternate)
  int first[2][kClusterMaxCtas * kClusterWarps];  // the first exchange's counts at pass 1's mids
  int top[kClusterMaxCtas * kClusterWarps];     // and its warp maxima
  int at_lo[kClusterMaxCtas * kClusterWarps];   // the warp counts of the pass that set lo
  int at_hi[kClusterMaxCtas * kClusterWarps];   // and of the pass that set hi
  uint64_t bar[2];  // an exchange's arrivals, one a warp of the cluster (halves alternate)
  int th;           // the threshold the list's passes found
};

__device__ __forceinline__ int count_ge(int4 v, int mid) {
  return (v.x >= mid ? 1 : 0) + (v.y >= mid ? 1 : 0) + (v.z >= mid ? 1 : 0) + (v.w >= mid ? 1 : 0);
}

// The values of xi >= mid.
__device__ __forceinline__ int count_ge_regs(const int (&xi)[kClusterPerThread], int mid) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kClusterPerThread; ++j) c += xi[j] >= mid ? 1 : 0;
  return c;
}

// The cluster's barrier of exchange ``x`` (a pass's counts, or the
// compaction's list): each warp, by lane r, arrives on CTA r's mbarrier of
// half x & 1, releasing lane r's earlier writes to the cluster; then every
// thread waits for its CTA's to have all nc * kClusterWarps arrivals.  The
// halves' phases complete in exchange order, two exchanges apart.
__device__ __forceinline__ void cluster_exchange_barrier(int x, ClusterSelScratch& sc, int nc) {
  const int lane = threadIdx.x & (kWarp - 1);
  if (lane < nc) wst_hopper::mbar_arrive_release_cluster(wst_hopper::cluster_map(&sc.bar[x & 1], lane));
  wst_hopper::mbar_wait_acquire_cluster(&sc.bar[x & 1], (x >> 1) & 1);
}

// Exchange ``x``'s cluster total: each warp's count goes, by lane r, to
// slot rank * kClusterWarps + warp of CTA r's half x & 1 before the
// exchange's barrier, then each warp sums the slots.  A CTA's half is
// written again two exchanges later, after every warp of the cluster has
// arrived for the one between, that is, after every warp has read it.
__device__ __forceinline__ int cluster_total(int c, int x, ClusterSelScratch& sc, int rank,
                                             int nc) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int n = nc * kClusterWarps;
  c = __reduce_add_sync(0xffffffffu, c);
  int* buf = sc.cnt[x & 1];
  if (lane < nc)
    wst_hopper::st_cluster(wst_hopper::cluster_map(buf + rank * kClusterWarps + warp, lane), c);
  cluster_exchange_barrier(x, sc, nc);
  const int total = (lane < n ? buf[lane] : 0) + (lane + kWarp < n ? buf[lane + kWarp] : 0);
  return __reduce_add_sync(0xffffffffu, total);
}

// The first exchange (x = 0, half 0): each warp's counts at pass 0's mid
// (to sc.cnt[0]) and at both mids pass 1 can take (to sc.first), and its
// largest value (to sc.top); -> the three cluster totals, and in top the
// row's largest value.
__device__ __forceinline__ void cluster_first(const int (&c)[3], int& top, int (&total)[3],
                                              ClusterSelScratch& sc, int rank, int nc) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int slot = rank * kClusterWarps + warp, n = nc * kClusterWarps;
  int* dst[4] = {sc.cnt[0], sc.first[0], sc.first[1], sc.top};
  int v[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = __reduce_add_sync(0xffffffffu, c[i]);
  v[3] = __reduce_max_sync(0xffffffffu, top);
  if (lane < nc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) wst_hopper::st_cluster(wst_hopper::cluster_map(dst[i] + slot, lane), v[i]);
  }
  cluster_exchange_barrier(0, sc, nc);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    total[i] = __reduce_add_sync(0xffffffffu, (lane < n ? dst[i][lane] : 0) +
                                                  (lane + kWarp < n ? dst[i][lane + kWarp] : 0));
  top = __reduce_max_sync(0xffffffffu, max(lane < n ? sc.top[lane] : kIntMin,
                                           lane + kWarp < n ? sc.top[lane + kWarp] : kIntMin));
}

// cta_kth_largest over a row spread across the cluster (every thread of
// every CTA calls it, after the cluster barrier that follows the
// mbarriers' init, and after its slice is loaded): xi, thread t's
// registers (xi[4q + i] is slice element 4 (q * kClusterThreads + t) + i,
// kIntMin past the slice), sm[0:smem_ints) (the next smem_ints elements,
// kIntMin past the slice; thread t counts the int4 runs q *
// kClusterThreads + t) and the slice's elements [g0, len) of src, read
// again each pass; top, the largest of this thread's registers and runs.
// Passes 0 and 1 take one sweep and one exchange: pass 0's mid is 0, and
// pass 1's one of kMidUp and kMidDown by pass 0's total, so the sweep
// counts at all three; the exchange also brings the row's largest value,
// and a later pass whose mid lies above it has the total 0 with no count
// and no exchange (the passes that halve the exponents above the row's
// values).  Warp 0 keeps
// the cluster's warp counts of the passes that set lo and hi.  Once both
// bounds are set and c_lo - c_hi <= kClusterCand, the compaction: warp w
// of CTA r holds its counts at lo and hi apart of the candidates, so their
// exclusive prefix in (CTA, warp) order places each warp's in the list;
// each thread writes its values in [lo, hi) there in its own CTA's list,
// each CTA copies its part to the others' (coalesced), and after the
// compaction's barrier warp 0 of each CTA runs the rest of the passes on
// the list alone.
__device__ __forceinline__ int cluster_kth_largest(const int (&xi)[kClusterPerThread],
                                                   const int* sm, int smem_ints, const float* src,
                                                   int g0, int len, int k, int top,
                                                   ClusterSelScratch& sc) {
  const int t = threadIdx.x, lane = t & (kWarp - 1), warp = t / kWarp;
  const int rank = (int)wst_hopper::cluster_rank(), nc = (int)wst_hopper::cluster_nctas();
  const int n = nc * kClusterWarps;
  const int4* sm4 = reinterpret_cast<const int4*>(sm);
  const int runs = smem_ints / kClusterRun;
  int lo = -2147483647, hi = 2147483647;
  int c_lo = -1, c_hi = -1;  // the totals at lo and hi, once a pass has set each
  // warp 0 keeps the warp counts at the new bound: from's entries, or 0
  auto keep_at = [&](bool at_lo, const int* from) {
    if (warp == 0) {
      int* at = at_lo ? sc.at_lo : sc.at_hi;
      if (lane < n) at[lane] = from ? from[lane] : 0;
      if (lane + kWarp < n) at[lane + kWarp] = from ? from[lane + kWarp] : 0;
    }
  };
  // passes 0 and 1: one sweep, one exchange
  int c3[3] = {count_ge_regs(xi, 0), count_ge_regs(xi, kMidUp), count_ge_regs(xi, kMidDown)};
#pragma unroll 2
  for (int q = 0; q < runs; ++q) {
    const int4 v = sm4[q * kClusterThreads + t];
    c3[0] += count_ge(v, 0);
    c3[1] += count_ge(v, kMidUp);
    c3[2] += count_ge(v, kMidDown);
  }
  for (int s = g0 + t; s < len; s += kClusterThreads) {
    const int v = monotone_int(__ldg(src + s));
    c3[0] += v >= 0 ? 1 : 0;
    c3[1] += v >= kMidUp ? 1 : 0;
    c3[2] += v >= kMidDown ? 1 : 0;
    top = max(top, v);
  }
  int t3[3];
  cluster_first(c3, top, t3, sc, rank, nc);
  if (t3[0] == k) return 0;
  const bool up = t3[0] > k;  // pass 0 set lo = 0 (else hi = 0)
  keep_at(up, sc.cnt[0]);
  if (up) {
    lo = 0;
    c_lo = t3[0];
  } else {
    hi = 0;
    c_hi = t3[0];
  }
  const int mid1 = up ? kMidUp : kMidDown, total1 = up ? t3[1] : t3[2];
  if (total1 == k) return mid1;
  keep_at(total1 > k, sc.first[up ? 0 : 1]);
  if (total1 > k) {
    lo = mid1;
    c_lo = total1;
  } else {
    hi = mid1;
    c_hi = total1;
  }
  int pass = 2, x = 1;  // passes, and exchanges so far
#pragma unroll 1
  for (; pass < 32; ++pass) {
    if (c_lo >= 0 && c_hi >= 0 && c_lo - c_hi <= kClusterCand) break;
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int total = 0;  // no value at or above a mid above top: every warp counts 0
    if (mid <= top) {
      int c = count_ge_regs(xi, mid);
#pragma unroll 4
      for (int q = 0; q < runs; ++q) c += count_ge(sm4[q * kClusterThreads + t], mid);
#pragma unroll 4
      for (int s = g0 + t; s < len; s += kClusterThreads) c += monotone_int(__ldg(src + s)) >= mid ? 1 : 0;
      total = cluster_total(c, x, sc, rank, nc);
      if (total == k) return mid;
      keep_at(total > k, sc.cnt[x & 1]);
      ++x;
    } else {
      keep_at(false, nullptr);
    }
    if (total > k) {
      lo = mid;
      c_lo = total;
    } else {
      hi = mid;
      c_hi = total;
    }
  }
  if (pass == 32) return lo;
  // the compaction: this thread's candidates and their place in the list
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kClusterPerThread; ++j) mine += xi[j] >= lo && xi[j] < hi ? 1 : 0;
#pragma unroll 4
  for (int q = 0; q < runs; ++q) {
    const int4 v = sm4[q * kClusterThreads + t];
    mine += count_ge(v, lo) - count_ge(v, hi);
  }
  for (int s = g0 + t; s < len; s += kClusterThreads) {
    const int x = monotone_int(__ldg(src + s));
    mine += x >= lo && x < hi ? 1 : 0;
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  __syncthreads();  // warp 0's at_lo and at_hi
  const int d0 = lane < n ? sc.at_lo[lane] - sc.at_hi[lane] : 0;
  const int d1 = lane + kWarp < n ? sc.at_lo[lane + kWarp] - sc.at_hi[lane + kWarp] : 0;
  int s0 = d0, s1 = d1;  // inclusive prefixes over entries lane and 32 + lane
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int u0 = __shfl_up_sync(0xffffffffu, s0, off), u1 = __shfl_up_sync(0xffffffffu, s1, off);
    if (lane >= off) {
      s0 += u0;
      s1 += u1;
    }
  }
  s1 += __shfl_sync(0xffffffffu, s0, kWarp - 1);
  // entry e's exclusive (or, past_e, inclusive) prefix: e is the same in every lane
  auto prefix = [&](int e, bool past_e) {
    const int v = e < kWarp ? (past_e ? s0 : s0 - d0) : (past_e ? s1 : s1 - d1);
    return __shfl_sync(0xffffffffu, v, e & (kWarp - 1));
  };
  const int first = rank * kClusterWarps;
  const int seg = prefix(first, false), seg_end = prefix(first + kClusterWarps - 1, true);
  int o = prefix(first + warp, false) + incl - mine;
  auto put = [&](int v) {
    if (v >= lo && v < hi) sc.cand[o++] = v;
  };
#pragma unroll
  for (int j = 0; j < kClusterPerThread; ++j) put(xi[j]);
  for (int q = 0; q < runs; ++q) {
    const int4 v = sm4[q * kClusterThreads + t];
    put(v.x);
    put(v.y);
    put(v.z);
    put(v.w);
  }
  for (int s = g0 + t; s < len; s += kClusterThreads) put(monotone_int(__ldg(src + s)));
  __syncthreads();  // this CTA's part of the list is whole
  for (int r = 1; r < nc; ++r) {
    const uint32_t dst = wst_hopper::cluster_map(sc.cand, (rank + r) % nc);
    for (int i = seg + t; i < seg_end; i += kClusterThreads)
      wst_hopper::st_cluster(dst + 4u * (uint32_t)i, sc.cand[i]);
  }
  // every lane's stores before its warp's arrives (release at cluster scope)
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncwarp();
  cluster_exchange_barrier(x, sc, nc);
  const int m = c_lo - c_hi;
  for (int i = m + t; i < (m + kListChunk - 1) / kListChunk * kListChunk; i += kClusterThreads)
    sc.cand[i] = kIntMin;
  __syncthreads();  // the list is in this CTA's shared memory, in whole chunks
  if (warp == 0) {  // the rest of the passes on the list, warp 0 alone
    const int4* c4 = reinterpret_cast<const int4*>(sc.cand);
    const int chunks = (m + kListChunk - 1) / kListChunk;
    int th = lo;
#pragma unroll 1
    for (; pass < 32; ++pass) {
      const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
      if (mid > top) {  // above the row's largest value: the total is c_hi
        hi = mid;
        continue;
      }
      int c[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int q = 0; q < chunks; ++q) {
        const int4 v = c4[q * kWarp + lane];
        c[0] += v.x >= mid ? 1 : 0;
        c[1] += v.y >= mid ? 1 : 0;
        c[2] += v.z >= mid ? 1 : 0;
        c[3] += v.w >= mid ? 1 : 0;
      }
      // the values >= the compaction's hi: above every later mid
      const int total = c_hi + __reduce_add_sync(0xffffffffu, c[0] + c[1] + c[2] + c[3]);
      if (total == k) {
        th = mid;
        break;
      }
      if (total > k) {
        lo = mid;
      } else {
        hi = mid;
      }
      th = lo;
    }
    if (lane == 0) sc.th = th;
  }
  __syncthreads();
  return sc.th;
}

}  // namespace wst
