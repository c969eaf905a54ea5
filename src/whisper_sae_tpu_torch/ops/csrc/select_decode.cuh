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
// one pass (D > kDecCols) take the CTA-per-row form (kernel A's
// sae_select_decode_wide_kernel): one CTA of kWideThreads threads owns
// the row (topk_common.cuh: cta_kth_largest), cta_select_to_list
// compacts its positive selections into one list in shared memory, in
// feature order, and the CTA's warps split the output columns into
// 32-column tiles (wide_tiles), each summing its tiles over the whole
// list with sparse_decode.  A column's sum is the same fmaf chain in list
// order as the warp form's, so the two forms give the same bits where
// both hold the geometry.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
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

}  // namespace wst
