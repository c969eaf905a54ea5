// The select-and-sparse-decode steps shared by kernel A's row kernel
// (sae_kernels.cu: sae_select_decode_kernel) and the coder's TopK modes
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
// < nt (w: [h, ld] bf16 rows), each sum in list order.  Every load of a
// step is issued before its sums, unconditionally (tiles past nt read
// tile 0 and are not summed): a load under a branch on nt waits for the
// sums before it, one latency each.
__device__ __forceinline__ void sparse_decode(const unsigned int* list, int nsel,
                                              const unsigned short* w, int ld, int col0, int nt,
                                              int lane, float (&acc)[kDecTiles]) {
  const unsigned short* base = w + col0 + lane;
  int s = 0;
  for (; s + kDecUnroll <= nsel; s += kDecUnroll) {
    float hv[kDecUnroll];
    unsigned short wv[kDecUnroll][kDecTiles];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const unsigned int e = list[s + u];
      hv[u] = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
      const unsigned short* wr = base + (size_t)(e >> 16) * ld;
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) wv[u][t] = __ldg(wr + (t < nt ? t : 0) * kWarp);
    }
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) {
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u)
        if (t < nt) acc[t] = fmaf(hv[u], bf16_bits_to_float(wv[u][t]), acc[t]);
    }
  }
  for (; s < nsel; ++s) {
    const unsigned int e = list[s];
    const float hv = bf16_bits_to_float(static_cast<unsigned short>(e & 0xffffu));
    const unsigned short* wr = base + (size_t)(e >> 16) * ld;
    unsigned short wv[kDecTiles];
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) wv[t] = __ldg(wr + (t < nt ? t : 0) * kWarp);
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t)
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

}  // namespace wst
