// The select-and-sparse-decode steps shared by kernel A's row kernels
// (sae_kernels.cu: sae_select_decode_kernel and its wide form) and the
// coder's TopK modes
// (coder_kernels.cu: coder_select_decode_kernel).
//
// One warp owns one row.  After the threshold (topk_common.cuh), the warp
// writes the row's bf16 latent, marks its features active and compacts
// its positive selections into its list in shared memory, in feature
// order (select_to_list); then it decodes from the W_dec rows of that
// list alone, lanes over the output columns (sparse_decode): 2*k*dout
// FLOPs a row, where a dense decode of the latent spends 2*H*dout on its
// zeros.  A lane keeps kDecTiles f32 sums, so one call decodes at most
// kDecCols columns; wider outputs (the crosscoder's L*D = 1536) are
// decoded in passes of kDecCols columns over the same list.
//
// Rows wider than a warp's registers (H > kMaxRow) and outputs wider than
// one pass (D > kDecCols) take a wide form.  Up to H = kGroupMaxRow (8192:
// whisper-base to -medium 8x, whisper-tiny 16x) the group form
// (group_select_decode, below): persistent CTAs of a few warp groups,
// each group of four warps owning one row at a time, its passes on a
// named barrier of its own, the next row's pre coming into shared memory
// by a bulk copy while the current row selects and decodes.  Wider rows
// (whisper-tiny 32x, 64x) take the CTA-per-row form: one CTA of
// kWideThreads threads owns the row (topk_common.cuh: cta_kth_largest),
// cta_select_to_list compacts its positive selections into one list in
// shared memory, in feature order, and the CTA's warps split the output
// columns into 32-column tiles (wide_tiles), each summing its tiles over
// the whole list with sparse_decode.  In every form a column's sum is the
// same fmaf chain in list order as the warp form's, so the forms give
// the same bits where they hold the same geometry.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"
#include "topk_common.cuh"

namespace wst {

constexpr int kSelWarps = 4;  // rows (one a warp) a CTA of the select-and-decode kernels
constexpr int kSelThreads = kSelWarps * kWarp;
constexpr int kDecCols = 384;  // columns of one decode pass: kDecTiles f32 sums a lane
constexpr int kDecTiles = kDecCols / kWarp;
constexpr int kDecUnroll = 4;  // W_dec rows whose loads are in flight together

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// The row's latent bf16(relu(pre) * [pre >= th]) to hidden_row[0:h);
// active[c] = 1 for each positive one; its positive selections to list as
// (feature << 16 | bf16 bits), in feature order.  Returns their count
// (the same in every lane); the list is complete for the warp on return.
template <int N>
__device__ __forceinline__ int select_to_list(const int (&xi)[N], int th, int h, int lane,
                                              unsigned short* hidden_row, int* active,
                                              unsigned int* list) {
  int nsel = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWarp + lane;
    const float v = c < h ? masked_relu(xi[j], th) : 0.0f;
    const unsigned short bits = float_to_bf16_bits(v);
    if (c < h) hidden_row[c] = bits;
    const bool pos = v > 0.0f;
    const unsigned int m = __ballot_sync(0xffffffffu, pos);
    if (pos) {
      list[nsel + __popc(m & ((1u << lane) - 1u))] = (static_cast<unsigned int>(c) << 16) | bits;
      atomicOr(&active[c], 1);
    }
    nsel += __popc(m);
  }
  __syncwarp();
  return nsel;
}

// acc[t] += sum over the list of hid_j * w[j, col0 + t*kWarp + lane] for t
// < nt <= NT (w: [h, ld] bf16 rows), each sum in list order.  Every load
// of a step is issued before its sums, unconditionally (tiles past nt
// read tile 0 and are not summed): a load under a branch on nt waits for
// the sums before it, one latency each.
template <int NT>
__device__ __forceinline__ void sparse_decode(const unsigned int* list, int nsel,
                                              const unsigned short* w, int ld, int col0, int nt,
                                              int lane, float (&acc)[NT]) {
  const unsigned short* base = w + col0 + lane;
  int s = 0;
  for (; s + kDecUnroll <= nsel; s += kDecUnroll) {
    float hv[kDecUnroll];
    unsigned short wv[kDecUnroll][NT];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const unsigned int e = list[s + u];
      hv[u] = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
      const unsigned short* wr = base + (size_t)(e >> 16) * ld;
#pragma unroll
      for (int t = 0; t < NT; ++t) wv[u][t] = __ldg(wr + (t < nt ? t : 0) * kWarp);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u)
        if (t < nt) acc[t] = fmaf(hv[u], bf16_bits_to_float(wv[u][t]), acc[t]);
    }
  }
  for (; s < nsel; ++s) {
    const unsigned int e = list[s];
    const float hv = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
    const unsigned short* wr = base + (size_t)(e >> 16) * ld;
    unsigned short wv[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) wv[t] = __ldg(wr + (t < nt ? t : 0) * kWarp);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < nt) acc[t] = fmaf(hv, bf16_bits_to_float(wv[t]), acc[t]);
  }
}

// The per-CTA loss partial: thread 0 writes the sum of the kSelWarps rows'
// sq in warp order and adds their selections to *l0 (an int32 atomic,
// order-free).  Every thread of the CTA calls it once.
__device__ __forceinline__ void cta_partial(float sq, int nsel, float* sq_partial, int* l0) {
  __shared__ float row_sq[kSelWarps];
  __shared__ int row_l0[kSelWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) {
    row_sq[warp] = sq;
    row_l0[warp] = nsel;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    int n = 0;
    for (int r = 0; r < kSelWarps; ++r) {
      total += row_sq[r];
      n += row_l0[r];
    }
    sq_partial[blockIdx.x] = total;
    atomicAdd(l0, n);
  }
}

// -- the CTA-per-row form -------------------------------------------------

constexpr int kWideDecTiles = 2;  // 32-column tiles a warp of the wide decode sums at once

// cta_select_to_list's shared scratch for a row of N values a thread:
// each warp's count of positive selections at each j, then their
// exclusive prefix in (j, warp) order, and the total.
template <int N>
struct WideSelScratch {
  int cnt[N * kWideWarps + 1];
};

// select_to_list over a row spread across the CTA (thread t holds element
// c = j*kWideThreads + t, as load_wide_monotone loads it; every thread of
// the CTA calls it): the latent to hidden_row[0:h), active[c] = 1 for
// each positive selection, and those selections to list as (feature <<
// 16 | bf16 bits) in feature order.  Feature order is (j, warp, lane)
// order, so (1) each warp counts its positives at each j with a ballot,
// (2) warp 0 takes the exclusive prefix of those counts in (j, warp)
// order, and (3) each positive lands at its (j, warp) offset plus its
// rank in the warp's ballot.  Returns the count (the same in every
// thread); the list is complete for the CTA on return.
template <int N>
__device__ __forceinline__ int cta_select_to_list(const int (&xi)[N], int th, int h,
                                                  unsigned short* hidden_row, int* active,
                                                  unsigned int* list, WideSelScratch<N>& sc) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    const unsigned int m = __ballot_sync(0xffffffffu, c < h && masked_relu(xi[j], th) > 0.0f);
    if (lane == 0) sc.cnt[j * kWideWarps + warp] = __popc(m);
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
#pragma unroll 1
    for (int i0 = 0; i0 < N * kWideWarps; i0 += kWarp) {  // N * kWideWarps: a multiple of 32
      const int v = sc.cnt[i0 + lane];
      int incl = v;
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      sc.cnt[i0 + lane] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
    }
    if (lane == 0) sc.cnt[N * kWideWarps] = carry;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    const float v = c < h ? masked_relu(xi[j], th) : 0.0f;
    const unsigned short bits = float_to_bf16_bits(v);
    if (c < h) hidden_row[c] = bits;
    const bool pos = v > 0.0f;
    const unsigned int m = __ballot_sync(0xffffffffu, pos);
    if (pos) {
      list[sc.cnt[j * kWideWarps + warp] + __popc(m & ((1u << lane) - 1u))] =
          (static_cast<unsigned int>(c) << 16) | bits;
      atomicOr(&active[c], 1);
    }
  }
  const int nsel = sc.cnt[N * kWideWarps];
  __syncthreads();
  return nsel;
}

// The 32-column tiles [t0, t1) of an output of ntiles tiles that warp
// ``warp`` of a CTA-per-row kernel decodes: contiguous runs of
// ceil(ntiles / kWideWarps) tiles, the last warps' runs short or empty.
__device__ __forceinline__ void wide_tiles(int ntiles, int warp, int& t0, int& t1) {
  const int per = (ntiles + kWideWarps - 1) / kWideWarps;
  t0 = min(warp * per, ntiles);
  t1 = min(t0 + per, ntiles);
}


// -- the group form -------------------------------------------------------
//
// Rows of kMaxRow < H <= kGroupMaxRow (and narrower rows whose output is
// wider than one warp-form pass).  Design for Hopper:
//  - A warp group of kGroupThreads threads owns one row at a time and
//    keeps it in registers, N values a thread (the smallest of 32, 48, 64
//    that holds the row: no padding at 4096, 6144, 8192).  Thread t holds
//    the runs of four values c = q*kGroupSpan + 4t + i (q < N/4, i < 4),
//    so its reads of pre from shared memory are 16 bytes and its latent
//    stores 8, each warp's contiguous.
//  - Each counting pass ends on a named barrier of the group's 128
//    threads (bar.sync 1 + group, 128), never on the CTA's: one row's
//    passes never wait for another row's, and group_rows(N) rows are in
//    flight a CTA.  Once at most kGroupCand values remain between the
//    bisection's bounds, they are compacted into shared memory and the
//    remaining passes count two values a thread, not N
//    (group_kth_largest); the midpoints and totals stay cta_kth_largest's.
//  - CTAs are persistent (group_ctas_sm(N) an SM): group g of CTA b
//    walks rows b + gridDim.x * (g + G*i) of the chunk, so a small chunk
//    spreads over every SM first.  One thread of the group brings the
//    next row's f32 pre into the group's buffer in shared memory by a
//    1-D bulk copy completing on the group's mbarrier as soon as the
//    group has read the current row into registers, so the load overlaps
//    the row's select and decode.
//  - The list of selections is built in feature order, into the group's
//    list in shared memory (H entries at most), from each thread's counts
//    per run column packed four to a word: one warp scan of those words
//    and one barrier (group_select_to_list).
//  - The decode spreads the output over all four warps, two adjacent
//    columns a thread (one 32-bit load of bf16 pairs, each warp's 128
//    bytes contiguous), in passes of kGroupThreads * kGroupDecPairs pairs;
//    the W_dec loads of kGroupDecRows list entries are all issued before
//    their sums.  Each column is the warp form's fmaf chain in list order
//    from 0, then resid = (acc + base) - target, so the latent and resid
//    bits are the warp form's.
//  - The row's sum of squares: each thread's columns in order (passes,
//    then pairs, then the pair's two columns), the warp's lanes by a
//    butterfly, the four warps in order: one partial a row.
// Shared memory is each group's pre buffer and list, 8 bytes a value (48
// KB a group at H = 6144); kGroupRowsSm groups an SM at 128 registers a
// thread.

constexpr int kGroupThreads = 128;  // a warp group: the threads of one row
constexpr int kGroupWarps = kGroupThreads / kWarp;
constexpr int kGroupRun = 4;  // consecutive values of a thread: one 16-byte read
constexpr int kGroupSpan = kGroupThreads * kGroupRun;
constexpr int kGroupMaxPerThread = 64;
constexpr int kGroupMaxRow = kGroupThreads * kGroupMaxPerThread;  // 8192
constexpr int kGroupDecRows = 8;   // list entries whose W_dec loads are in flight together
constexpr int kGroupDecPairs = 4;  // column pairs of a thread in one decode pass
constexpr int kGroupSmemBudget = 192 * 1024;  // dynamic shared memory a CTA at most
constexpr int kGroupRowsCta = 4;     // warp groups a CTA
constexpr int kGroupRowsSm = 4;      // warp groups an SM (65,536 registers: 128 a thread)
// Candidates of the select's second phase (two a thread); 0 keeps every
// pass on the whole row.
constexpr int kGroupCand = 2 * kGroupThreads;

// Per-thread register counts the group form is instantiated for (a half,
// three quarters and all of kGroupMaxPerThread); a row of h <=
// kGroupMaxRow values takes the smallest that holds it.
constexpr int kGroupPer1 = kGroupMaxPerThread / 2, kGroupPer2 = kGroupMaxPerThread * 3 / 4;
__host__ __device__ __forceinline__ int group_per_thread(int h) {
  return h <= kGroupPer1 * kGroupThreads   ? kGroupPer1
         : h <= kGroupPer2 * kGroupThreads ? kGroupPer2
                                           : kGroupMaxPerThread;
}

// Rows (warp groups) a CTA of the group form holds, N values a thread:
// kGroupRowsCta, or fewer where their pre buffers and lists (8 bytes a
// value) would pass kGroupSmemBudget.
__host__ __device__ constexpr int group_rows(int n) {
  return kGroupSmemBudget / (n * kGroupThreads * 8) < kGroupRowsCta
             ? kGroupSmemBudget / (n * kGroupThreads * 8)
             : kGroupRowsCta;
}

// The dynamic shared memory of a CTA at row width h: each group's f32 pre
// buffer and list.
__host__ __device__ __forceinline__ int group_smem_bytes(int n, int h) {
  return group_rows(n) * h * 8;
}

// CTAs of the group form an SM at 128 registers a thread (its
// __launch_bounds__ minimum).
__host__ __device__ constexpr int group_ctas_sm(int n) {
  return kGroupRowsSm / group_rows(n) > 1 ? kGroupRowsSm / group_rows(n) : 1;
}

// Launches kernel-template instance KERNEL<N, ...> of the group form for
// the row width h.
#define WST_GROUP_DISPATCH(h, LAUNCH)                                     \
  switch (::wst::group_per_thread(h)) {                                   \
    case ::wst::kGroupPer1: LAUNCH(::wst::kGroupPer1); break;             \
    case ::wst::kGroupPer2: LAUNCH(::wst::kGroupPer2); break;             \
    default: LAUNCH(::wst::kGroupMaxPerThread); break;                    \
  }

// The CTA-per-row form's instances past the group form (h > kGroupMaxRow).
#define WST_WIDE_DISPATCH_PAST_GROUP(h, LAUNCH) \
  if (::wst::wide_per_thread(h) <= 32) {        \
    LAUNCH(32);                                 \
  } else {                                      \
    LAUNCH(80);                                 \
  }

// Persistent CTAs of the group form for a chunk of n rows: ctas_sm an SM,
// at most one a row (the CTAs' first groups take rows 0 .. grid - 1).
inline int group_grid(int n, int ctas_sm) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
      sms = 132;
  }
  return n < sms * ctas_sm ? n : sms * ctas_sm;
}

// The operands of the group form's select-and-decode (kernel A: no y, dout
// = d, the base b_out; the coder: its modes).
struct GroupArgs {
  const void* x;              // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  const void* y;              // [>= row_offset + rows, dout] f32 or bf16 (not Y_IS_X)
  int y_bf16;
  long long row_offset;       // first row of the batch in x (and y)
  int d, h, dout, k;
  const float* pre;           // [chunk rows, h] f32: the chunk's xc @ W_enc + b_enc
  const unsigned short* w_dec;  // [h, dout] bf16, 4-byte aligned
  const float* b_out;         // [dout] (not SKIP)
  unsigned short* hidden;     // [rows, h] bf16
  float* resid;               // [rows, dout]; SKIP: holds xc @ W_skip + b_out on entry
  float* sq_partial;          // [rows]: one a row
  int* counts;                // [1 + h], zeroed: l0, active
};

__device__ __forceinline__ float row_val(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// The group's row from its buffer in shared memory into registers (thread
// t's runs; INT_MIN past h, which no midpoint counts).
template <int N>
__device__ __forceinline__ void load_group_monotone(const float* buf, int h, int t,
                                                    int (&xi)[N]) {
#pragma unroll
  for (int q = 0; q < N / kGroupRun; ++q) {
    const int c = q * kGroupSpan + kGroupRun * t;
    if (c < h) {  // h is a multiple of 32: a run is wholly in or out
      const float4 v = *reinterpret_cast<const float4*>(buf + c);
      xi[4 * q] = monotone_int(v.x);
      xi[4 * q + 1] = monotone_int(v.y);
      xi[4 * q + 2] = monotone_int(v.z);
      xi[4 * q + 3] = monotone_int(v.w);
    } else {
#pragma unroll
      for (int i = 0; i < kGroupRun; ++i) xi[4 * q + i] = kIntMin;
    }
  }
}

// The select's shared scratch of one group: each pass's warp counts
// (two halves alternating between passes), the second phase's candidates
// and their count (zero between rows).
struct GroupSelScratch {
  int cnt[2][kGroupWarps];
  int cand[kGroupCand > 0 ? kGroupCand : 1];
  int ncand;
};

// cta_kth_largest over the group's row, over the group's named barrier:
// the same midpoints, totals and early stop, so the same threshold.  Once
// passes have set both lo and hi and fewer than kGroupCand values lie in
// [lo, hi) (c_lo - c_hi: the totals that set them), the group compacts
// those values into shared memory, two a thread, and the remaining passes
// count total = c_hi + the candidates >= mid: every later mid lies in
// (lo, hi) of the compaction, where every value >= hi counts and none
// below lo does.
template <int N>
__device__ __forceinline__ int group_kth_largest(const int (&xi)[N], int k, GroupSelScratch& sc,
                                                 int bar_id) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x % kGroupThreads / kWarp;
  int lo = -2147483647, hi = 2147483647;
  int c_lo = -1, c_hi = -1;  // the totals at lo and hi, once a pass has set each
  int pass = 0;
#pragma unroll 1
  for (; pass < 32; ++pass) {
    if (kGroupCand > 0 && c_lo >= 0 && c_hi >= 0 && c_lo - c_hi <= kGroupCand) break;
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) c += xi[j] >= mid ? 1 : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    int* buf = sc.cnt[pass & 1];
    if (lane == 0) buf[warp] = c;
    wst_hopper::named_sync(bar_id, kGroupThreads);
    int total = 0;
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) total += buf[w];
    if (total == k) return mid;
    if (total > k) {
      lo = mid;
      c_lo = total;
    } else {
      hi = mid;
      c_hi = total;
    }
  }
  if (kGroupCand == 0 || pass == 32) return lo;
  // each thread's candidates at the warp's base (one atomic a warp) plus
  // the candidates of the lanes before it
  int mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) mine += xi[j] >= lo && xi[j] < hi ? 1 : 0;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  int base = 0;
  if (lane == kWarp - 1 && incl) base = atomicAdd(&sc.ncand, incl);
  int o = __shfl_sync(0xffffffffu, base, kWarp - 1) + incl - mine;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (xi[j] >= lo && xi[j] < hi) sc.cand[o++] = xi[j];
  wst_hopper::named_sync(bar_id, kGroupThreads);  // the candidates are in shared memory
  constexpr int CT = (kGroupCand > 0 ? kGroupCand : kGroupThreads) / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  int cv[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int e = t + i * kGroupThreads;
    cv[i] = e < c_lo - c_hi ? sc.cand[e] : kIntMin;
  }
  if (t == 0) sc.ncand = 0;  // read by no thread after the barrier above
#pragma unroll 1
  for (; pass < 32; ++pass) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    int c = 0;
#pragma unroll
    for (int i = 0; i < CT; ++i) c += cv[i] >= mid ? 1 : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    int* buf = sc.cnt[pass & 1];
    if (lane == 0) buf[warp] = c;
    wst_hopper::named_sync(bar_id, kGroupThreads);
    int total = c_hi;  // the values >= the compaction's hi: above every later mid
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) total += buf[w];
    if (total == k) return mid;
    if (total > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// masked_relu(x, th) > 0 with th2 = max(th, 1): a selected positive value
// (monotone ints 1 .. 0x7f800000 are the positive floats up to +inf).
__device__ __forceinline__ bool positive_selection(int x, int th2) {
  return x >= th2 && x <= 0x7f800000;
}

// The ints of group_select_to_list's shared scratch: each warp's packed
// counts (four run columns a word), and one more.
template <int N>
__host__ __device__ constexpr int group_scan_entries() {
  return (N / kGroupRun + 3) / 4 * kGroupWarps;
}

// cta_select_to_list over the group's row (every thread of the group
// calls it): the latent to hidden_row[0:h), active[c] = 1 for each
// positive selection, those selections to list in feature order, that is
// in (run column q, warp, lane, i) order.  Each thread counts its
// positives in each run column into 8-bit fields, four columns a word (a
// field holds at most 4 x 32 = 128 a warp); one inclusive scan of those
// words over the warp's lanes gives each lane's offset within its warp's
// part of every column and, in lane 31, the warp's counts, which go to
// sc (group_scan_entries<N>() ints); after one barrier every thread adds
// up the columns before its own and the warps before its own, and writes
// its positives there.  Returns the count; the list is complete on return.
template <int N>
__device__ __forceinline__ int group_select_to_list(const int (&xi)[N], int th, int h,
                                                    unsigned short* hidden_row, int* active,
                                                    unsigned int* list, int* sc, int bar_id) {
  constexpr int Q = N / kGroupRun, P = (Q + 3) / 4;
  const int t = threadIdx.x % kGroupThreads, lane = t % kWarp, warp = t / kWarp;
  // masked_relu(x, th) > 0 exactly when th2 <= x <= +inf's int (no NaN, no
  // zero or negative value, nothing past the row: its slots hold INT_MIN)
  const int th2 = th > 1 ? th : 1;
  unsigned int cnt[P], incl[P];
#pragma unroll
  for (int w = 0; w < P; ++w) cnt[w] = 0u;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    unsigned int p = 0;
#pragma unroll
    for (int i = 0; i < kGroupRun; ++i) p += positive_selection(xi[4 * q + i], th2) ? 1u : 0u;
    cnt[q / 4] += p << (8 * (q % 4));
  }
#pragma unroll
  for (int w = 0; w < P; ++w) {
    incl[w] = cnt[w];
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const unsigned int u = __shfl_up_sync(0xffffffffu, incl[w], off);
      if (lane >= off) incl[w] += u;
    }
    if (lane == kWarp - 1) sc[warp * P + w] = static_cast<int>(incl[w]);
  }
  wst_hopper::named_sync(bar_id, kGroupThreads);
  unsigned int wt[kGroupWarps][P];  // every warp's counts, packed
#pragma unroll
  for (int u = 0; u < kGroupWarps; ++u)
#pragma unroll
    for (int w = 0; w < P; ++w) wt[u][w] = static_cast<unsigned int>(sc[u * P + w]);
  int run = 0;  // the selections of the columns before q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int shift = 8 * (q % 4);
    int before = 0, total = 0;  // column q's selections in the warps before this one, in all
#pragma unroll
    for (int u = 0; u < kGroupWarps; ++u) {
      const int n = static_cast<int>((wt[u][q / 4] >> shift) & 0xffu);
      before += u < warp ? n : 0;
      total += n;
    }
    const int c = q * kGroupSpan + kGroupRun * t;
    const bool in = c < h;
    bool pos[kGroupRun];
    unsigned int bits[kGroupRun];
#pragma unroll
    for (int i = 0; i < kGroupRun; ++i) {
      const int x = xi[4 * q + i];
      pos[i] = positive_selection(x, th2);
      // at th >= 1 a selection is a positive value (its bits as they are)
      // or a NaN (0); below, bf16(masked_relu) as the warp form writes it
      bits[i] = th >= 1 ? (pos[i] ? float_to_bf16_bits(__int_as_float(x)) : 0u)
                        : (in ? float_to_bf16_bits(masked_relu(x, th)) : 0u);
    }
    if (in)
      *reinterpret_cast<uint2*>(hidden_row + c) =
          make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
    // this lane's place: the lanes before it in its warp's part of column q
    int o = run + before + static_cast<int>(((incl[q / 4] - cnt[q / 4]) >> shift) & 0xffu);
#pragma unroll
    for (int i = 0; i < kGroupRun; ++i) {
      if (pos[i]) {
        list[o++] = (static_cast<unsigned int>(c + i) << 16) | bits[i];
        atomicOr(&active[c + i], 1);
      }
    }
    run += total;
  }
  wst_hopper::named_sync(bar_id, kGroupThreads);
  return run;
}

// One decode pass of the group form over pairs [p0, p0 + NP *
// kGroupThreads) of the output (thread t: pairs p0 + t + i*kGroupThreads):
// resid = (sum over the list of hid_j * W_dec[j, c] + base) - target,
// base = resid's row (SKIP, read before it is overwritten) or b_out, the
// target y's row or (Y_IS_X) x's, both loaded before the sums; each new
// residual squared into sq in order.  Every W_dec load of kGroupDecRows
// entries is issued before their sums, unconditionally (a pair past the
// output reads pair p0, an entry past the list repeats the last; neither
// is summed).
template <int NP, bool SKIP, bool Y_IS_X>
__device__ __forceinline__ void group_decode_pass(const GroupArgs& a, const unsigned int* list,
                                                  int nsel, size_t g, size_t src, int p0, int t,
                                                  float& sq) {
  const int npairs = a.dout / 2;
  int pc[NP];
  bool ok[NP];
  float acc[NP][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = p0 + t + i * kGroupThreads;
    ok[i] = p < npairs;
    pc[i] = ok[i] ? p : p0;
    acc[i][0] = acc[i][1] = 0.0f;
  }
  // the base and the target of the thread's columns, loaded before the sums
  float* rrow = a.resid + g * a.dout;
  float base[NP][2], yv[NP][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * pc[i] + j;
      base[i][j] = SKIP ? rrow[c] : a.b_out[c];
      yv[i][j] = Y_IS_X ? row_val(a.x, a.x_bf16, src * a.d + c)
                        : row_val(a.y, a.y_bf16, src * a.dout + c);
    }
  }
  const unsigned int* wd = reinterpret_cast<const unsigned int*>(a.w_dec);
  for (int s = 0; s < nsel; s += kGroupDecRows) {
    float hv[kGroupDecRows];
    unsigned int wv[kGroupDecRows][NP];
#pragma unroll
    for (int u = 0; u < kGroupDecRows; ++u) {
      const unsigned int e = list[min(s + u, nsel - 1)];
      hv[u] = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
      const unsigned int* wr = wd + (size_t)(e >> 16) * npairs;
#pragma unroll
      for (int i = 0; i < NP; ++i) wv[u][i] = __ldg(wr + pc[i]);
    }
#pragma unroll
    for (int u = 0; u < kGroupDecRows; ++u) {
      if (s + u < nsel) {
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[i][0] = fmaf(hv[u], __uint_as_float(wv[u][i] << 16), acc[i][0]);
          acc[i][1] = fmaf(hv[u], __uint_as_float(wv[u][i] & 0xffff0000u), acc[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (ok[i]) {
      const int c = 2 * pc[i];
      float res[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) res[j] = (acc[i][j] + base[i][j]) - yv[i][j];
      *reinterpret_cast<float2*>(rrow + c) = make_float2(res[0], res[1]);
      sq = fmaf(res[0], res[0], sq);
      sq = fmaf(res[1], res[1], sq);
    }
  }
}

// The group form's select-and-decode over a chunk of n rows (the body of
// kernel A's and the coder's group kernels; blockDim.x = kGroupThreads *
// group_rows(N), dynamic shared memory group_smem_bytes(N, h)).  Row
// r of the chunk: pre at row r of a.pre; latent, resid and partial at
// row row0 + r; x and y at row row_offset + row0 + r.
template <int N, bool SKIP, bool Y_IS_X>
__device__ __forceinline__ void group_select_decode(const GroupArgs& a, int row0, int n) {
  constexpr int G = group_rows(N);
  extern __shared__ __align__(16) unsigned char group_smem[];
  __shared__ uint64_t full[G];
  __shared__ GroupSelScratch sel[G];
  __shared__ int scan[G][group_scan_entries<N>() + 1];
  __shared__ float warp_sq[G][kGroupWarps];
  const int grp = threadIdx.x / kGroupThreads, t = threadIdx.x % kGroupThreads;
  const int lane = t % kWarp, warp = t / kWarp, bar_id = 1 + grp;
  float* buf = reinterpret_cast<float*>(group_smem) + (size_t)grp * a.h;
  unsigned int* list = reinterpret_cast<unsigned int*>(group_smem) + (size_t)(G + grp) * a.h;
  const uint32_t bytes = static_cast<uint32_t>(a.h) * 4u;
  const int stride = gridDim.x * G;
  int r = blockIdx.x + gridDim.x * grp;
  if (t == 0) {
    sel[grp].ncand = 0;
    wst_hopper::mbar_init(&full[grp], 1);
    wst_hopper::fence_mbar_init();
    if (r < n) {
      wst_hopper::mbar_expect_tx(&full[grp], bytes);
      wst_hopper::bulk_load_1d(buf, a.pre + (size_t)r * a.h, bytes, &full[grp]);
    }
  }
  wst_hopper::named_sync(bar_id, kGroupThreads);  // the barrier is initialised
#pragma unroll 1
  for (int phase = 0; r < n; r += stride, phase ^= 1) {
    wst_hopper::mbar_wait(&full[grp], phase);
    int xi[N];
    load_group_monotone(buf, a.h, t, xi);
    wst_hopper::named_sync(bar_id, kGroupThreads);  // every thread has read the buffer
    if (t == 0 && r + stride < n) {
      wst_hopper::fence_proxy_async();
      wst_hopper::mbar_expect_tx(&full[grp], bytes);
      wst_hopper::bulk_load_1d(buf, a.pre + (size_t)(r + stride) * a.h, bytes, &full[grp]);
    }
    const int th = group_kth_largest(xi, a.k, sel[grp], bar_id);
    const size_t g = (size_t)row0 + r;
    const int nsel = group_select_to_list(xi, th, a.h, a.hidden + g * a.h, a.counts + 1, list,
                                          scan[grp], bar_id);
    const size_t src = (size_t)(a.row_offset + (long long)g);
    const int npairs = a.dout / 2;
    float sq = 0.0f;
#pragma unroll 1
    for (int p0 = 0; p0 < npairs; p0 += kGroupThreads * kGroupDecPairs) {
#define WST_GROUP_PASS(NP) \
  group_decode_pass<NP, SKIP, Y_IS_X>(a, list, nsel, g, src, p0, t, sq)
      switch ((npairs - p0 + kGroupThreads - 1) / kGroupThreads) {
        case 1: WST_GROUP_PASS(1); break;
        case 2: WST_GROUP_PASS(2); break;
        case 3: WST_GROUP_PASS(3); break;
        default: WST_GROUP_PASS(kGroupDecPairs);
      }
#undef WST_GROUP_PASS
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) warp_sq[grp][warp] = sq;
    wst_hopper::named_sync(bar_id, kGroupThreads);  // also: every thread is done with the list
    if (t == 0) {
      float total = warp_sq[grp][0];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) total += warp_sq[grp][w];
      a.sq_partial[g] = total;
      atomicAdd(a.counts, nsel);
    }
  }
}

}  // namespace wst
