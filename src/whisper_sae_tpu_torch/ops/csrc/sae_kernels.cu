// Hand-written Hopper kernels of the TopK-SAE training path.
//
// Kernel A ("sae_fused_loss_fwd"), one C call of four launches:
//   sae_centre_kernel, gemm_kernel<kPre> (encoder_gemm.cu),
//   sae_select_decode_kernel, sae_loss_finalize_kernel;
//   replaces whisper_sae_tpu/ops/pallas_sae.py:_fused_loss_kernel, reached
//   by fused_sae_loss (pallas_call at :249) and, with a row offset into the
//   epoch buffer, by fused_sae_loss_indexed (:424).
// topk_mask_kernel<float>   (kernel C, "topk_mask_fwd")
//   replaces ops/pallas_topk.py:_mask_kernel (topk_mask_pallas, :51);
//   topk_mask_wide_kernel<N> ("topk_mask_wide_fwd") is its form for rows
//   wider than a warp's registers up to a CTA's (H = 40960), and past
//   that the same entry launches blocked_encode.cu's cluster form, up to
//   the TPU kernel's widest row (kMaxMaskRow = 262,144).
// topk_mask_kernel<unsigned short|float>, the same body writing a bf16 or
//   f32 latent at a row offset, is the select of kernel B up to H = 3072
//   ("sae_topk_encode_fwd" in blocked_encode.cu: the centre, the kPre
//   GEMM, then a select by row width, chunk by chunk), which replaces
//   ops/pallas_sae.py:_encode_kernel (fused_topk_encode, :77).
//
// What A computes for each row (B computes the first four, its latent in
// bf16 or f32):
//   xc     = bf16(x - b_pre)
//   pre    = xc @ W_enc + b_enc                  (bf16 products, f32 sums)
//   th     = exact k-th largest of pre           (topk_common.cuh)
//   hid    = bf16(relu(pre) * [pre >= th])
//   resid  = sum_{hid_j > 0} hid_j * W_dec[j, :] + b_out - x    (f32)
//   and sum(resid^2), count(hid > 0), active[j] |= hid_j > 0.
//
// Bound on the H100 at whisper-tiny (D=384, H=3072, k=32; 989 TFLOP/s
// bf16, 3.35 TB/s): the encode product is 2*B*D*H FLOPs (9.7 GFLOP at
// B=4096, 9.8 us) and the function must move x, hid, resid, xc and the
// two weight matrices (B*(4D + 2H + 4D + 2D) + 2*2*D*H bytes: 50 MB at
// B=4096, 15 us), so it is bound by bytes, chiefly the bf16 latent it
// writes for the backward.  The decode reads only the k selected rows
// of W_dec (2*B*k*D FLOPs), not the dense H*D product.
//
// A's route, and its price:
//  1. sae_centre_kernel writes xc once, read at the row offset: it is
//     both an output (the backward's) and the encode's A operand.
//  2. The encode is encoder_gemm.cu's warp-specialised TMA/wgmma GEMM
//     with the kPre epilogue: A = xc [B, D], B = W_enc^T [H, D], pre =
//     acc + b_enc in f32 to a workspace.  Ragged D and H (multiples of
//     32) load as zeros past their ends.
//  3. sae_select_decode_kernel: one warp a row reads its row of pre into
//     registers (96 values a lane), finds the threshold (warp_kth_largest:
//     per-lane counts, stop at count == k), writes the bf16 latent,
//     compacts its positive selections into the warp's slice of shared
//     memory in feature order and decodes from those W_dec rows only,
//     four rows at a time, lanes over D (select_to_list and sparse_decode
//     of select_decode.cuh, which the coder's TopK modes share).  Shared
//     memory is the lists
//     alone (H entries of 4 bytes a warp: 48 KB a CTA at H = 3072), so
//     four CTAs of four warps fit an SM, against the one 16-row CTA an
//     SM that a 192 KB tile of pre in shared memory would allow.
//  4. sae_loss_finalize_kernel sums the per-CTA loss partials.
// The price is the f32 pre's round trip through device memory, 2*B*H*4
// bytes beyond the bound (101 MB, ~0.03 ms at B=4096): the traffic the
// TPU kernel keeps in VMEM.  Keeping it on chip needs a cluster holding a
// 64-row tile's pre (768 KB f32) across DSMEM.
//
// A's wide route ("sae_fused_loss_wide_fwd"), the same function at every
// geometry the JAX package fuses (bf16 W_enc + W_dec within its 48 MiB
// VMEM budget: whisper-base to -medium 8x, whisper-tiny up to 64x), where
// a row of pre outgrows a warp's registers (H > 3072) or the decode one
// pass (D > 384): sae_centre_kernel over all rows, then per chunk of
// rows whose f32 pre fits the top-k encode's budget (its chunk:
// 13,568 rows at H = 6144) the kPre encode and the select-and-decode,
// then sae_loss_finalize_kernel over one partial a row.  The
// select-and-decode is sae_select_decode_group_kernel<N> up to H = 8192
// (select_decode.cuh's group form: persistent CTAs, a warp group a row
// on its own named barrier, the next row's pre brought into shared
// memory by a bulk copy during the current row's select, the decode over
// all four warps, two columns a thread), past it
// sae_select_decode_wide_kernel<N> (one CTA of 512 threads a row: the CTA
// select of topk_common.cuh, the list in feature order, the warps over
// D in 32-column tiles).  Bound at whisper-small 8x (D=768, H=6144,
// k=32, B=4096): the encode's 2*B*D*H = 38.7 GFLOP (0.039 ms) against
// ~100 MB of x, the latent, resid, xc and both weights (0.030 ms):
// operations.  The route adds the f32 pre's round trip (2*4*B*H = 201
// MB, 0.060 ms), as the warp form does.
//
// Cross-CTA reductions: CTAs run concurrently (unlike the TPU grid's
// read-modify-write accumulation, pallas_sae.py:213-223), so l0 and
// active use int32 atomics (order-free, deterministic) and sum(resid^2)
// is written as one partial per CTA and summed in a fixed order by
// sae_loss_finalize_kernel.  No float atomics: the loss has the same
// bits from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "select_decode.cuh"
#include "topk_common.cuh"

// blocked_encode.cu: the rows of a chunk whose f32 pre fits the top-k
// encode's budget at width h (its chunk; kernel A's wide route's)
extern "C" int wst_sae_topk_encode_chunk_rows(int h);
// blocked_encode.cu: one select form (3: the cluster form) on rows [0, rows) of an f32 pre
extern "C" int wst_encode_select_fwd(int form, const float* pre, int rows, int h, int k,
                                     void* out, int out_f32, long long row0, void* stream);

namespace wst {

constexpr int kWarps = 8;  // the warp select (kernels B and C): rows (one a warp) a CTA
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxD = kDecCols;  // kernel A decodes D in one pass (select_decode.cuh)
constexpr int kFinalizeThreads = 256;
constexpr int kCentreThreads = 128;

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(x)[i])
                : static_cast<const float*>(x)[i];
}

// -- kernel A -------------------------------------------------------------

// xc[r, :] = bf16(x[row_offset + r, :] - b_pre), one CTA a row.
__global__ void __launch_bounds__(kCentreThreads) sae_centre_kernel(
    const void* x, int x_bf16, long long row_offset, int d, const float* b_pre,
    unsigned short* xc) {
  const size_t r = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += kCentreThreads) {
    const float xv = load_x(x, x_bf16, (size_t)(row_offset + (long long)r) * d + c);
    xc[r * d + c] = float_to_bf16_bits(xv - b_pre[c]);
  }
}

struct LossArgs {
  const void* x;             // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  long long row_offset;      // first row of this batch in x
  int rows, d, h, k;
  const float* pre;          // [rows, h] f32: xc @ W_enc + b_enc (wide: the chunk's rows)
  const unsigned short* w_dec;  // [h, d] bf16
  const float* b_out;        // [d] = b_dec + b_pre
  unsigned short* hidden;    // [rows, h] bf16
  float* resid;              // [rows, d]
  float* sq_partial;         // [gridDim.x] (wide: [rows], one a row)
  int* counts;               // [1 + h]: l0, active (zeroed)
};

// One warp a row: the threshold, the latent, the decode and the row's
// share of the loss; dynamic shared memory holds each warp's list of
// selections (h entries at most).
__global__ void __launch_bounds__(kSelThreads, 4) sae_select_decode_kernel(LossArgs a) {
  extern __shared__ unsigned int sel_lists[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int g = blockIdx.x * kSelWarps + warp;
  float sq = 0.0f;
  int nsel = 0;
  if (g < a.rows) {  // warp-uniform
    int xi[kMaxPerLane];
    load_row_monotone(a.pre + (size_t)g * a.h, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);
    unsigned int* list = sel_lists + warp * a.h;
    nsel = select_to_list(xi, th, a.h, lane, a.hidden + (size_t)g * a.h, a.counts + 1, list);

    // resid = sum_sel hid_j * W_dec[j, :] + b_out - x, lanes over D
    const int nt = a.d / kWarp;
    float acc[kDecTiles];
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) acc[t] = 0.0f;
    sparse_decode(list, nsel, a.w_dec, a.d, 0, nt, lane, acc);
    float xv[kDecTiles], bo[kDecTiles];
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) {
      const int c = (t < nt ? t : 0) * kWarp + lane;
      xv[t] = load_x(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + c);
      bo[t] = a.b_out[c];
    }
#pragma unroll
    for (int t = 0; t < kDecTiles; ++t) {
      if (t < nt) {
        const float res = (acc[t] + bo[t]) - xv[t];
        a.resid[(size_t)g * a.d + t * kWarp + lane] = res;
        sq = fmaf(res, res, sq);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  cta_partial(sq, nsel, a.sq_partial, a.counts);
}

// Kernel A's CTA-per-row form, for rows wider than the group form holds
// (kGroupMaxRow < h <= kMaxWideRow).  Block b takes
// row row0 + b of the batch (pre holds the chunk's rows from row0): the
// threshold over the row in registers (cta_kth_largest), the latent and
// the list of selections in feature order (cta_select_to_list), the
// decode with the warps over D in 32-column tiles, each column summed in
// list order as the warp form sums it; then sq_partial[row0 + b] = the
// row's sum(resid^2) (each warp's tiles in order, the warps in order),
// and its selections added to l0 (int32).  Dynamic shared memory holds
// the list (h entries at most).
template <int N>
__global__ void __launch_bounds__(kWideThreads, 1) sae_select_decode_wide_kernel(LossArgs a,
                                                                                int row0) {
  extern __shared__ unsigned int wide_list[];
  __shared__ int warp_cnt[2][kWideWarps];
  __shared__ WideSelScratch<N> sc;
  __shared__ float warp_sq[kWideWarps];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const size_t g = (size_t)row0 + blockIdx.x;
  int xi[N];
  load_wide_monotone(a.pre + (size_t)blockIdx.x * a.h, a.h, xi);
  const int th = cta_kth_largest(xi, a.k, warp_cnt);
  const int nsel = cta_select_to_list(xi, th, a.h, a.hidden + g * a.h, a.counts + 1, wide_list, sc);

  int t0, t1;
  wide_tiles(a.d / kWarp, warp, t0, t1);
  const size_t src = (size_t)(a.row_offset + (long long)g) * a.d;
  float sq = 0.0f;
  for (int tb = t0; tb < t1; tb += kWideDecTiles) {
    const int nt = min(kWideDecTiles, t1 - tb);
    float acc[kWideDecTiles];
#pragma unroll
    for (int t = 0; t < kWideDecTiles; ++t) acc[t] = 0.0f;
    sparse_decode(wide_list, nsel, a.w_dec, a.d, tb * kWarp, nt, lane, acc);
#pragma unroll
    for (int t = 0; t < kWideDecTiles; ++t) {
      if (t < nt) {
        const int c = (tb + t) * kWarp + lane;
        const float res = (acc[t] + a.b_out[c]) - load_x(a.x, a.x_bf16, src + c);
        a.resid[g * a.d + c] = res;
        sq = fmaf(res, res, sq);
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) warp_sq[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWideWarps; ++w) total += warp_sq[w];
    a.sq_partial[g] = total;
    atomicAdd(a.counts, nsel);
  }
}

// Kernel A's group form (select_decode.cuh: group_select_decode), for
// rows of at most kGroupMaxRow values: persistent CTAs of group_rows(N)
// warp groups, each group a row at a time, the next row's pre brought in
// by a bulk copy; the coder's TopK modes run the same body.
template <int N>
__global__ void __launch_bounds__(kGroupThreads * group_rows(N), group_ctas_sm(N))
    sae_select_decode_group_kernel(GroupArgs a, int row0, int n) {
  group_select_decode<N, false, true>(a, row0, n);
}

// loss = sum(partials) / (rows * d) and l0 = count / rows, summed in a
// fixed order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(kFinalizeThreads) sae_loss_finalize_kernel(
    const float* partial, int n, const int* counts, int rows, int d, float* loss, float* l0) {
  __shared__ float buf[kFinalizeThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kFinalizeThreads) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kFinalizeThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *loss = buf[0] / static_cast<float>((long long)rows * d);
    *l0 = static_cast<float>(counts[0]) / static_cast<float>(rows);
  }
}

// Kernel C: hidden = relu(pre) * [pre >= k-th largest], one warp per row.
// Bound: bytes (read pre once, write hidden once: 8*B*H bytes, 30 us at
// B=4096, H=3072 on 3.35 TB/s); the TPU kernel's point, one read of pre
// instead of 32, holds here by keeping the row in registers.  OutT =
// unsigned short writes the latent in bf16 (kernel B's select: 6*B*H
// bytes); the caller offsets ``out`` to the chunk's first row.
template <typename OutT>
__global__ void __launch_bounds__(kThreads) topk_mask_kernel(const float* pre, OutT* out,
                                                              int rows, int h, int k) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (r >= rows) return;  // warp-uniform
  int xi[kMaxPerLane];
  load_row_monotone(pre + (size_t)r * h, h, lane, xi);
  const int th = warp_kth_largest(xi, k);
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = j * kWarp + lane;
    if (c < h) store_latent(out + (size_t)r * h + c, masked_relu(xi[j], th));
  }
}

// Kernel C's wide form, for rows wider than one warp's registers
// (kMaxRow < h <= kMaxWideRow): one CTA per row (topk_common.cuh:
// cta_kth_largest), the row read once into registers.  Same bound as
// the warp form: bytes, 8*B*H (1.34 GB at B=8192, H=40960: 0.40 ms).
template <int N>
__global__ void __launch_bounds__(kWideThreads, 1) topk_mask_wide_kernel(const float* pre,
                                                                         float* out, int h,
                                                                         int k) {
  __shared__ int warp_cnt[2][kWideWarps];
  const size_t base = (size_t)blockIdx.x * h;
  int xi[N];
  load_wide_monotone(pre + base, h, xi);
  const int th = cta_kth_largest(xi, k, warp_cnt);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    if (c < h) out[base + c] = masked_relu(xi[j], th);
  }
}

// Select-and-decode launches of kernel A's wide route by form (0: group,
// 1: CTA a row), counted where each launch is made.
long long g_sae_select_launches[2] = {0, 0};

// Kernel C's widest row (pallas_topk.py:supported).
constexpr int kMaxMaskRow = 262144;

}  // namespace wst

extern "C" {

// Largest row count / widths the kernels take (checked again in Python).
int wst_max_row_width() { return wst::kMaxRow; }
int wst_max_d() { return wst::kMaxD; }
// Rows a CTA of the select-and-decode kernels takes (kernel A's and the
// coder's TopK modes'): one loss partial each.
int wst_rows_per_cta() { return wst::kSelWarps; }

// xc[r, :] = bf16(x[row_offset + r, :] - b_pre) for r < rows (xc [rows,
// d] bf16): kernel A's first launch, and the blocked encode's first a
// chunk (blocked_encode.cu).
int wst_sae_centre_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                       const void* b_pre, void* xc, void* stream) {
  wst::sae_centre_kernel<<<rows, wst::kCentreThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, row_offset, d, static_cast<const float*>(b_pre), static_cast<unsigned short*>(xc));
  return (int)cudaGetLastError();
}

// Kernel A: centre, encode (the GEMM's kPre epilogue into ``pre``, an
// f32 [rows, h] workspace), select and decode, then the fixed-order
// finalize into the scalars loss and l0.
int wst_sae_fused_loss_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                           int h, int k, const void* w_enc_t, const void* b_enc,
                           const void* b_pre, const void* w_dec, const void* b_out,
                           void* hidden, void* resid, void* xc, void* pre, void* sq_partial,
                           void* counts, void* loss, void* l0, void* stream) {
  if (rows <= 0 || d <= 0 || d % wst::kWarp || d > wst::kMaxD || h <= 0 || h % wst::kWarp ||
      h > wst::kMaxRow || k < 1 || k > h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = wst_sae_centre_fwd(x, x_bf16, row_offset, rows, d, b_pre, xc, stream);
  if (err) return err;
  err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, rows, h, d, b_enc, 1.0f, 0, pre, nullptr,
                         nullptr, nullptr, stream);
  if (err) return err;
  const wst::LossArgs a{x,
                        x_bf16,
                        row_offset,
                        rows,
                        d,
                        h,
                        k,
                        static_cast<const float*>(pre),
                        static_cast<const unsigned short*>(w_dec),
                        static_cast<const float*>(b_out),
                        static_cast<unsigned short*>(hidden),
                        static_cast<float*>(resid),
                        static_cast<float*>(sq_partial),
                        static_cast<int*>(counts)};
  const size_t smem = (size_t)wst::kSelWarps * h * sizeof(unsigned int);
  err = (int)cudaFuncSetAttribute(wst::sae_select_decode_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = (rows + wst::kSelWarps - 1) / wst::kSelWarps;
  wst::sae_select_decode_kernel<<<blocks, wst::kSelThreads, smem, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  wst::sae_loss_finalize_kernel<<<1, wst::kFinalizeThreads, 0, s>>>(
      static_cast<const float*>(sq_partial), blocks, static_cast<const int*>(counts), rows, d,
      static_cast<float*>(loss), static_cast<float*>(l0));
  return (int)cudaGetLastError();
}

// Kernel A's wide route (d and h multiples of 32, h <=
// wst_max_wide_row_width(), any d): the centre of every row into xc, then
// per chunk of wst_sae_topk_encode_chunk_rows(h) rows the encode (the
// GEMM's kPre epilogue into ``pre``, an f32 [min(rows, chunk), h]
// workspace) and the select-and-decode -- sae_select_decode_group_kernel
// for h <= wst_max_group_row_width(), else sae_select_decode_wide_kernel
// -- then the fixed-order finalize over the rows' partials (sq_partial:
// [rows]).  w_dec must be 4-byte aligned (the group form reads bf16 pairs).
int wst_sae_fused_loss_wide_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                                int h, int k, const void* w_enc_t, const void* b_enc,
                                const void* b_pre, const void* w_dec, const void* b_out,
                                void* hidden, void* resid, void* xc, void* pre, void* sq_partial,
                                void* counts, void* loss, void* l0, void* stream) {
  if (rows <= 0 || d <= 0 || d % wst::kWarp || h <= 0 || h % wst::kWarp ||
      h > wst::kMaxWideRow || k < 1 || k > h || reinterpret_cast<uintptr_t>(w_dec) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = wst_sae_centre_fwd(x, x_bf16, row_offset, rows, d, b_pre, xc, stream);
  if (err) return err;
  const bool group = h <= wst::kGroupMaxRow;
  const wst::LossArgs a{x,
                        x_bf16,
                        row_offset,
                        rows,
                        d,
                        h,
                        k,
                        static_cast<const float*>(pre),
                        static_cast<const unsigned short*>(w_dec),
                        static_cast<const float*>(b_out),
                        static_cast<unsigned short*>(hidden),
                        static_cast<float*>(resid),
                        static_cast<float*>(sq_partial),
                        static_cast<int*>(counts)};
  const wst::GroupArgs ga{x, x_bf16, nullptr, 0, row_offset, d, h, d, k, a.pre, a.w_dec, a.b_out,
                          a.hidden, a.resid, a.sq_partial, a.counts};
  int smem = h * (int)sizeof(unsigned int);
  if (group) {
#define WST_GROUP_SMEM(N)                                                                  \
  smem = wst::group_smem_bytes(N, h);                                                      \
  err = (int)cudaFuncSetAttribute(wst::sae_select_decode_group_kernel<N>,                  \
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
    WST_GROUP_DISPATCH(h, WST_GROUP_SMEM)
#undef WST_GROUP_SMEM
  } else {
#define WST_WIDE_SMEM(N)                                                                   \
  err = (int)cudaFuncSetAttribute(wst::sae_select_decode_wide_kernel<N>,                   \
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
    WST_WIDE_DISPATCH_PAST_GROUP(h, WST_WIDE_SMEM)
#undef WST_WIDE_SMEM
  }
  if (err) return err;
  const int chunk = wst_sae_topk_encode_chunk_rows(h);
  for (int row0 = 0; row0 < rows; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    // the chunk's centred rows: 16-byte aligned (row0 * d * 2 is a multiple of 64), as TMA reads them
    err = wst_enc_gemm_fwd(wst_gemm::kPre, static_cast<unsigned short*>(xc) + (size_t)row0 * d,
                           w_enc_t, n, h, d, b_enc, 1.0f, 0, pre, nullptr, nullptr, nullptr,
                           stream);
    if (err) return err;
    if (group) {
#define WST_LAUNCH_GROUP(N)                                                             \
  wst::sae_select_decode_group_kernel<N><<<wst::group_grid(n, wst::group_ctas_sm(N)),   \
                                           wst::kGroupThreads * wst::group_rows(N), smem, \
                                           s>>>(ga, row0, n)
      WST_GROUP_DISPATCH(h, WST_LAUNCH_GROUP)
#undef WST_LAUNCH_GROUP
    } else {
#define WST_LAUNCH_WIDE(N) \
  wst::sae_select_decode_wide_kernel<N><<<n, wst::kWideThreads, smem, s>>>(a, row0)
      WST_WIDE_DISPATCH_PAST_GROUP(h, WST_LAUNCH_WIDE)
#undef WST_LAUNCH_WIDE
    }
    err = (int)cudaGetLastError();
    if (err) return err;
    ++wst::g_sae_select_launches[group ? 0 : 1];
  }
  wst::sae_loss_finalize_kernel<<<1, wst::kFinalizeThreads, 0, s>>>(
      static_cast<const float*>(sq_partial), rows, static_cast<const int*>(counts), rows, d,
      static_cast<float*>(loss), static_cast<float*>(l0));
  return (int)cudaGetLastError();
}

// The warp select: rows [0, rows) of an f32 pre [rows, h] into rows
// [row0, row0 + rows) of out ([*, h]; f32 when out_f32, else bf16).
// Kernel C is one call (row0 = 0, f32); kernel B calls it once a chunk
// (blocked_encode.cu).
int wst_topk_mask_rows_fwd(const float* pre, int rows, int h, int k, void* out, int out_f32,
                           long long row0, void* stream) {
  const int blocks = (rows + wst::kWarps - 1) / wst::kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    wst::topk_mask_kernel<float><<<blocks, wst::kThreads, 0, s>>>(
        pre, static_cast<float*>(out) + (size_t)row0 * h, rows, h, k);
  } else {
    wst::topk_mask_kernel<unsigned short><<<blocks, wst::kThreads, 0, s>>>(
        pre, static_cast<unsigned short*>(out) + (size_t)row0 * h, rows, h, k);
  }
  return (int)cudaGetLastError();
}

// Kernel C.
int wst_topk_mask_fwd(const void* pre, void* out, int rows, int h, int k, void* stream) {
  return wst_topk_mask_rows_fwd(static_cast<const float*>(pre), rows, h, k, out, 1, 0, stream);
}

// Widest row the CTA-per-row kernels take.
int wst_max_wide_row_width() { return wst::kMaxWideRow; }
// Widest row the wide routes' group form takes (wider: the CTA-per-row form).
int wst_max_group_row_width() { return wst::kGroupMaxRow; }

// Select-and-decode launches kernel A's wide route has made in this
// process in the given form (0: the group form, 1: the CTA-per-row form).
long long wst_sae_select_launches(int form) {
  return form == 0 || form == 1 ? wst::g_sae_select_launches[form] : -1;
}

// Widest row kernel C takes: the TPU kernel's (pallas_topk.py:supported,
// an 8-row f32 + int32 tile within 16 MiB).
int wst_max_mask_row_width() { return wst::kMaxMaskRow; }

// Kernel C's wide form: one CTA per row, the row in registers up to
// wst_max_wide_row_width(), past it blocked_encode.cu's cluster form.
int wst_topk_mask_wide_fwd(const void* pre, void* out, int rows, int h, int k, void* stream) {
  if (rows <= 0 || h <= 0 || h > wst::kMaxMaskRow || k < 1 || k > h)
    return (int)cudaErrorInvalidValue;
  if (h > wst::kMaxWideRow)
    return wst_encode_select_fwd(3, static_cast<const float*>(pre), rows, h, k, out, 1, 0, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WST_LAUNCH_MASK_WIDE(N)                                                        \
  wst::topk_mask_wide_kernel<N><<<rows, wst::kWideThreads, 0, s>>>(                    \
      static_cast<const float*>(pre), static_cast<float*>(out), h, k)
  WST_WIDE_DISPATCH(h, WST_LAUNCH_MASK_WIDE)
#undef WST_LAUNCH_MASK_WIDE
  return (int)cudaGetLastError();
}

}  // extern "C"
