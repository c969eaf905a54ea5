// Hand-written Hopper kernels of the coder families' training forward,
// one C call ("coder_fwd", wst_coder_fwd) that replaces
// whisper_sae_tpu/ops/pallas_sae.py:_fused_coder_kernel, reached by
// _fused_coder_forward (pallas_call at :679; fused_transcoder_loss,
// fused_relu_sae_loss, fused_relu_crosscoder_loss) and, with a row offset
// into the epoch buffers, by _fused_coder_forward_indexed (:1057; the
// three *_indexed entries).
//
// What it computes for each row (no centring: these families have no b_pre):
//   xc    = bf16(x)
//   pre   = xc @ W_enc + b_enc                       (bf16 products, f32 sums)
//   hid   = bf16(topk_mask(pre, k))  or  bf16(relu(pre))
//   pred  = (hid @ W_dec + b_out) [+ xc @ W_skip]    (b_out = b_dec [+ b_skip])
//   resid = pred - f32(y)                            (y = x itself when Y_IS_X)
//   and sum(resid^2), count(hid > 0), active[j] |= hid_j > 0; in ReLU mode
//   also sum(hid) and hsum[j] = sum_b hid_bj over the f32 (unrounded) hid.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for the ReLU
// modes and the crosscoders (2*B*D*H encode plus, for ReLU, the dense
// 2*B*H*dout decode: 19 GFLOP for the ReLU SAE and 77 GFLOP for the ReLU
// crosscoder at B=4096), bytes for the TopK transcoders (their sparse
// decode needs 2*B*k*dout FLOPs; x, y, the weights, the bf16 latent and
// the f32 residual are ~52 MB at B=4096, 16 us).
//
// ReLU modes (k <= 0): five launches, each of the two products on the
// warp-specialised TMA/wgmma GEMM of encoder_gemm.cu.  The latent is about
// half positive, so the decode is a second dense GEMM, and nothing is
// gained by keeping a row's pre on chip (the TopK modes' reason for a row
// kernel, the exact top-k, is absent).
//  1. coder_cast_kernel writes xc = bf16(x[row_offset + r]) once: the
//     backward's operand and the encode's A; and zeroes l0.
//  2. gemm_kernel<kRelu>: A = xc, B = W_enc^T [H, D]; hid =
//     bf16(relu(acc + b_enc)) through the output tile and TMA; from the
//     f32 values, the per-feature sums of each 64 rows (hsum_partial
//     [ceil(B/64), H]) and l0 (an int32 atomic).  Rows past B load as TMA
//     zeros and their acc + b_enc = b_enc, about half positive: the
//     epilogue leaves them out of every sum and of l0.
//  3. gemm_kernel<kResid>: A = hid, B = W_dec^T [dout, H]; resid = acc +
//     b_dec - f32(x) in f32 from the registers, and one sum(resid^2)
//     partial a 128 x 128 output tile.
//  4. coder_hsum_kernel: hsum[j] = the partials of column j, in row order;
//     feature j is active exactly when hsum[j] > 0 (a sum of values >= 0),
//     which the caller reads off hsum.
//  5. coder_sum_kernel: sums[0] = the sq partials, sums[1] = sum(hsum),
//     each in a fixed order.
// The price: hid makes one bf16 round trip through device memory (2*B*H*2
// bytes, 50 MB at B=4096: 15 us at 3.35 TB/s), and at 128 rows the
// decode has 3 output tiles of 48 K blocks each for 132 SMs.
//
// TopK modes (k > 0): kernel A's route (sae_kernels.cu), four launches
// (five with the skip path).
//  1. coder_cast_kernel writes xc as above and zeroes the int32 counts
//     (l0 and the [H] active flags).
//  2. gemm_kernel<kPre> (wst_enc_gemm_fwd): A = xc, B = W_enc^T [H, D];
//     pre = acc + b_enc in f32 to a workspace [B, H].
//  3. Skip mode: gemm_kernel<kPre> again, A = xc, B = W_skip^T [dout, D],
//     bias b_out: the base xc @ W_skip + b_out, f32, straight into resid.
//  4. coder_select_decode_kernel<SKIP, Y_IS_X>: one warp a row loads its
//     pre into registers, finds the threshold (topk_common.cuh), writes
//     the bf16 latent, sets the active flags and compacts its positive
//     selections into its list in shared memory, in feature order; then
//     decodes from those rows of W_dec [H, dout] alone, lanes over dout,
//     in passes of kDecCols = 384 columns (the crosscoder's dout = 1536
//     takes four), from the rounded latent; resid = (decode + base) - y
//     with base = resid's row (Skip) or b_out; one sum(resid^2) partial
//     and an l0 atomic a CTA of four rows (select_decode.cuh, shared with
//     kernel A).
//  5. coder_sum_kernel adds the partials in a fixed order.
// The price is kernel A's: the f32 pre's round trip through device
// memory, 2*B*H*4 bytes beyond the bound (101 MB at B=4096, ~0.03 ms),
// and the decode's gathers, k rows of W_dec a row (32 * 1536 * 2 bytes
// at the crosscoder), served from L2.
//
// The TopK modes' wide route ("coder_wide_fwd", wst_coder_wide_fwd), the
// same function at every geometry the JAX package fuses (bf16 W_enc +
// W_dec [+ W_skip] within its 48 MiB VMEM budget) past the warp select's
// H <= 3072: whisper-small 8x and 16x, whisper-medium 8x, whisper-tiny up
// to 64x, the crosscoders at S = 6144.  The cast over all rows (and, in
// Skip mode, the skip product over all rows into resid), then per chunk
// of rows whose f32 pre fits the blocked encode's budget (kernel B's
// chunk: 13,568 rows at H = 6144) the kPre encode into a [chunk, H]
// workspace and the select-and-decode: up to H = 8192
// coder_select_decode_group_kernel<N, SKIP, Y_IS_X> (kernel A's group
// form, select_decode.cuh: persistent CTAs, a warp group a row on its own
// named barrier, the next row's pre brought in by a bulk copy, the decode
// over the group's four warps, two columns a thread), past it
// coder_select_decode_wide_kernel<N, SKIP, Y_IS_X> (one CTA of 512
// threads a row, the CTA select of topk_common.cuh, the list of
// selections in feature order (cta_select_to_list) and the decode with
// the warps over dout in 32-column tiles (wide_tiles)); in both each
// column is the same fmaf chain in list order as the warp form's, so
// they give the same latent and resid bits where both hold the geometry;
// one loss partial a row, summed by coder_sum_kernel in a fixed order.  Bound of
// the Skip transcoder at whisper-small 8x (D = dout = 768, H = 6144,
// B = 4096): the encode and skip products' 43.5 GFLOP (0.044 ms) against
// ~114 MB moved (0.034 ms): operations.  The route adds the f32 pre's
// round trip (2*4*B*H = 201 MB, 0.060 ms), as the warp form does.  The
// ReLU modes need no wide form: their two GEMMs and the per-feature sums
// take any H.  The TopK modes' earlier form, a row
// kernel of 16-row CTAs (mma.sync from L2, a [16, H] f32 tile of pre in
// shared memory, so one CTA an SM, re-reading both weights every 16 rows,
// and a dense decode of the latent's zeros), took 0.3157 / 0.2900 /
// 1.0914 ms for the Skip / TopK transcoder and the TopK crosscoder at
// B=4096 (PERF.md, rows 6a, 6b, 6d).
//
// Cross-CTA reductions without float atomics (CTAs run concurrently,
// unlike the TPU grid's read-modify-write accumulation at :606-622): l0
// and active are int32 atomics (order-free; ReLU mode needs only l0's);
// sum(resid^2) and the [H] hsum are written as partials and summed in a
// fixed order by coder_sum_kernel and coder_hsum_kernel.  The loss has
// the same bits from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "select_decode.cuh"
#include "topk_common.cuh"

// blocked_encode.cu: the rows of a chunk whose f32 pre fits the blocked
// encode's budget at width h (kernel B's chunk; the wide routes')
extern "C" int wst_sae_topk_encode_chunk_rows(int h);

namespace wst {
namespace coder {

constexpr int kSumThreads = 256;
constexpr int kCastThreads = 256;

__device__ __forceinline__ float load_val(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

struct SelectArgs {
  const void* x;              // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  const void* y;              // [>= row_offset + rows, dout] f32 or bf16 (not Y_IS_X)
  int y_bf16;
  long long row_offset;       // first row of this batch in x (and y)
  int rows, d, h, dout, k;
  const float* pre;           // [rows, h] f32: xc @ W_enc + b_enc (wide: the chunk's rows)
  const unsigned short* w_dec;  // [h, dout] bf16
  const float* b_out;         // [dout] (not SKIP)
  unsigned short* hidden;     // [rows, h] bf16
  float* resid;               // [rows, dout]; SKIP: holds xc @ W_skip + b_out on entry
  float* sq_partial;          // [gridDim.x] (wide: [rows], one a row)
  int* counts;                // [1 + h], zeroed: l0, active
};

// One warp a row: the threshold, the latent, the sparse decode in passes
// of kDecCols columns and the row's share of the loss; dynamic shared
// memory holds each warp's list of selections (h entries at most).
template <bool SKIP, bool Y_IS_X>
__global__ void __launch_bounds__(kSelThreads, 4) coder_select_decode_kernel(SelectArgs a) {
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

    const size_t src = (size_t)(a.row_offset + g);
    float* rrow = a.resid + (size_t)g * a.dout;
    for (int c0 = 0; c0 < a.dout; c0 += kDecCols) {
      const int nt = min(kDecCols, a.dout - c0) / kWarp;
      float acc[kDecTiles];
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) acc[t] = 0.0f;
      sparse_decode(list, nsel, a.w_dec, a.dout, c0, nt, lane, acc);
      float base[kDecTiles], yv[kDecTiles];
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) {
        const int c = c0 + (t < nt ? t : 0) * kWarp + lane;
        base[t] = SKIP ? rrow[c] : a.b_out[c];
        yv[t] = Y_IS_X ? load_val(a.x, a.x_bf16, src * a.d + c)
                       : load_val(a.y, a.y_bf16, src * a.dout + c);
      }
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) {
        if (t < nt) {
          const float res = (acc[t] + base[t]) - yv[t];
          rrow[c0 + t * kWarp + lane] = res;
          sq = fmaf(res, res, sq);
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  cta_partial(sq, nsel, a.sq_partial, a.counts);
}

// The TopK modes' group form (select_decode.cuh: group_select_decode,
// kernel A's body with the modes' base and target), for rows of at most
// kGroupMaxRow values.
template <int N, bool SKIP, bool Y_IS_X>
__global__ void __launch_bounds__(kGroupThreads * group_rows(N), group_ctas_sm(N))
    coder_select_decode_group_kernel(GroupArgs a, int row0, int n) {
  group_select_decode<N, SKIP, Y_IS_X>(a, row0, n);
}

// The TopK modes' CTA-per-row form, for rows wider than the group form
// holds (kGroupMaxRow < h).  Block b takes row row0 + b of the batch (its
// pre at chunk row b, its x and y at row row_offset + row0 + b): the
// threshold over the row in registers (cta_kth_largest), the latent and
// the list of selections in feature order (cta_select_to_list), the
// decode with the warps over dout in 32-column tiles, each column summed
// in list order as the warp form sums it; resid = (decode + base) - y
// with base = resid's row (Skip, read before it is overwritten) or b_out;
// then sq_partial[row0 + b] = the row's sum(resid^2) (each warp's tiles in
// order, the warps in order), and its selections added to l0 (int32).
// Dynamic shared memory holds the list (h entries at most).
template <int N, bool SKIP, bool Y_IS_X>
__global__ void __launch_bounds__(kWideThreads, 1)
    coder_select_decode_wide_kernel(SelectArgs a, int row0) {
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
  wide_tiles(a.dout / kWarp, warp, t0, t1);
  const size_t src = (size_t)(a.row_offset + (long long)g);
  float* rrow = a.resid + g * a.dout;
  float sq = 0.0f;
  for (int tb = t0; tb < t1; tb += kWideDecTiles) {
    const int nt = min(kWideDecTiles, t1 - tb);
    float acc[kWideDecTiles];
#pragma unroll
    for (int t = 0; t < kWideDecTiles; ++t) acc[t] = 0.0f;
    sparse_decode(wide_list, nsel, a.w_dec, a.dout, tb * kWarp, nt, lane, acc);
#pragma unroll
    for (int t = 0; t < kWideDecTiles; ++t) {
      if (t < nt) {
        const int c = (tb + t) * kWarp + lane;
        const float base = SKIP ? rrow[c] : a.b_out[c];
        const float yv = Y_IS_X ? load_val(a.x, a.x_bf16, src * a.d + c)
                                : load_val(a.y, a.y_bf16, src * a.dout + c);
        const float res = (acc[t] + base) - yv;
        rrow[c] = res;
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

// sums[blockIdx.x] = the n_sq partials of block 0 (sum resid^2) or the
// n_hid values of block 1 (sum hid: the per-feature sums), in a fixed
// order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(kSumThreads) coder_sum_kernel(const float* sq_partial, int n_sq,
                                                                const float* hsum, int n_hid,
                                                                float* sums) {
  __shared__ float buf[kSumThreads];
  const float* p = blockIdx.x == 0 ? sq_partial : hsum;
  const int n = blockIdx.x == 0 ? n_sq : n_hid;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += p[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = buf[0];
}

// hsum[j] = sum over blocks of rows of hsum_partial[:, j], in order.
__global__ void __launch_bounds__(kSumThreads) coder_hsum_kernel(const float* partial, int blocks,
                                                                 int h, float* hsum) {
  const int j = blockIdx.x * kSumThreads + threadIdx.x;
  if (j >= h) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * h + j];
  hsum[j] = s;
}

// xc = bf16(x[row_offset : row_offset + rows]), four values a thread (d is
// a multiple of 4, so a group never straddles a row); counts[0 : n_counts]
// = 0 for the launches that follow.
__global__ void __launch_bounds__(kCastThreads) coder_cast_kernel(const void* x, int x_bf16,
                                                                  long long row_offset, int d,
                                                                  long long groups,
                                                                  unsigned short* xc, int* counts,
                                                                  int n_counts) {
  const long long first = (long long)blockIdx.x * kCastThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kCastThreads;
  for (long long i = first; i < n_counts; i += stride) counts[i] = 0;
  const long long src = row_offset * d;
  for (long long i = first; i < groups; i += stride) {
    if (x_bf16) {
      reinterpret_cast<uint2*>(xc)[i] =
          __ldg(reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(x) + src) + i);
    } else {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + src) + i);
      const unsigned int lo = float_to_bf16_bits(v.x) | ((unsigned int)float_to_bf16_bits(v.y) << 16);
      const unsigned int hi = float_to_bf16_bits(v.z) | ((unsigned int)float_to_bf16_bits(v.w) << 16);
      reinterpret_cast<uint2*>(xc)[i] = make_uint2(lo, hi);
    }
  }
}

int cast(const void* x, int x_bf16, long long row_offset, int rows, int d, void* xc,
         void* counts, int n_counts, cudaStream_t s) {
  const long long groups = (long long)rows * d / 4;
  const long long want = (groups + kCastThreads - 1) / kCastThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  coder_cast_kernel<<<blocks, kCastThreads, 0, s>>>(x, x_bf16, row_offset, d, groups,
                                                    static_cast<unsigned short*>(xc),
                                                    static_cast<int*>(counts), n_counts);
  return (int)cudaGetLastError();
}

// The ReLU modes (y is x): cast, encode (kRelu), decode (kResid), hsum, sums.
int relu_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d, int h, int dout,
             const void* w_enc_t, const void* b_enc, const void* w_dec_t, const void* b_out,
             void* hidden, void* resid, void* xc, void* sq_partial, void* hsum_partial,
             void* l0, void* sums, void* hsum, void* stream) {
  if (dout != d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cast(x, x_bf16, row_offset, rows, d, xc, l0, 1, s);
  if (err) return err;
  err = wst_coder_gemm_fwd(wst_gemm::kRelu, xc, w_enc_t, rows, h, d, b_enc, hidden, hsum_partial,
                           l0, nullptr, 0, 0, stream);
  if (err) return err;
  err = wst_coder_gemm_fwd(wst_gemm::kResid, hidden, w_dec_t, rows, dout, h, b_out, resid,
                           sq_partial, nullptr, x, x_bf16, row_offset, stream);
  if (err) return err;
  const int tile = wst_gemm_tile();
  const int hsum_rows = (rows + tile / 2 - 1) / (tile / 2);
  const int sq_parts = (rows + tile - 1) / tile * ((dout + tile - 1) / tile);
  coder_hsum_kernel<<<(h + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      static_cast<const float*>(hsum_partial), hsum_rows, h, static_cast<float*>(hsum));
  coder_sum_kernel<<<2, kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), sq_parts,
                                              static_cast<const float*>(hsum), h,
                                              static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

template <bool SKIP, bool Y_IS_X>
int launch_select(const SelectArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)kSelWarps * a.h * sizeof(unsigned int);
  const cudaError_t err = cudaFuncSetAttribute(coder_select_decode_kernel<SKIP, Y_IS_X>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.rows + kSelWarps - 1) / kSelWarps;
  coder_select_decode_kernel<SKIP, Y_IS_X><<<blocks, kSelThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The TopK modes: cast, encode (kPre), [the skip product (kPre)], select
// and decode, sum.
int topk_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset, int rows,
             int d, int h, int dout, int k, int use_skip, int y_is_x, const void* w_enc_t,
             const void* b_enc, const void* w_dec, const void* b_out, const void* w_skip_t,
             void* hidden, void* resid, void* xc, void* pre, void* sq_partial, void* counts,
             void* sums, void* stream) {
  if (h > kMaxRow || k > h || (y_is_x ? dout != d : y == nullptr) || (use_skip && !w_skip_t))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cast(x, x_bf16, row_offset, rows, d, xc, counts, 1 + h, s);
  if (err) return err;
  err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, rows, h, d, b_enc, 1.0f, 0, pre, nullptr,
                         nullptr, nullptr, stream);
  if (err) return err;
  if (use_skip) {
    err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_skip_t, rows, dout, d, b_out, 1.0f, 0, resid,
                           nullptr, nullptr, nullptr, stream);
    if (err) return err;
  }
  const SelectArgs a{x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k,
                     static_cast<const float*>(pre),
                     static_cast<const unsigned short*>(w_dec),
                     static_cast<const float*>(b_out),
                     static_cast<unsigned short*>(hidden),
                     static_cast<float*>(resid),
                     static_cast<float*>(sq_partial),
                     static_cast<int*>(counts)};
  err = use_skip ? (y_is_x ? launch_select<true, true>(a, s) : launch_select<true, false>(a, s))
                 : (y_is_x ? launch_select<false, true>(a, s) : launch_select<false, false>(a, s));
  if (err) return err;
  const int blocks = (rows + kSelWarps - 1) / kSelWarps;
  coder_sum_kernel<<<1, kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), blocks,
                                              nullptr, 0, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// Select-and-decode launches of the wide route by form (0: group, 1: CTA
// a row), counted where each launch is made.
long long g_select_launches[2] = {0, 0};

// The wide route's select and decode, per chunk of rows: the group form
// up to kGroupMaxRow, past it the CTA-per-row form, the instance for the
// row width and the mode.
template <bool SKIP, bool Y_IS_X>
int launch_select_wide(const SelectArgs& a, int d, const void* xc, const void* w_enc_t,
                       const void* b_enc, cudaStream_t s) {
  const bool group = a.h <= kGroupMaxRow;
  const GroupArgs ga{a.x, a.x_bf16, a.y, a.y_bf16, a.row_offset, a.d, a.h, a.dout, a.k, a.pre,
                     a.w_dec, a.b_out, a.hidden, a.resid, a.sq_partial, a.counts};
  int smem = a.h * (int)sizeof(unsigned int);
  int err = 0;
  if (group) {
#define WST_CODER_GROUP_SMEM(N)                                                             \
  smem = group_smem_bytes(N, a.h);                                                          \
  err = (int)cudaFuncSetAttribute(coder_select_decode_group_kernel<N, SKIP, Y_IS_X>,        \
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
    WST_GROUP_DISPATCH(a.h, WST_CODER_GROUP_SMEM)
#undef WST_CODER_GROUP_SMEM
  } else {
#define WST_CODER_WIDE_SMEM(N)                                                              \
  err = (int)cudaFuncSetAttribute(coder_select_decode_wide_kernel<N, SKIP, Y_IS_X>,         \
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
    WST_WIDE_DISPATCH_PAST_GROUP(a.h, WST_CODER_WIDE_SMEM)
#undef WST_CODER_WIDE_SMEM
  }
  if (err) return err;
  const int chunk = wst_sae_topk_encode_chunk_rows(a.h);
  for (int row0 = 0; row0 < a.rows; row0 += chunk) {
    const int n = a.rows - row0 < chunk ? a.rows - row0 : chunk;
    // the chunk's bf16 rows: 16-byte aligned (row0 * d * 2 is a multiple of 64), as TMA reads them
    err = wst_enc_gemm_fwd(wst_gemm::kPre, static_cast<const unsigned short*>(xc) + (size_t)row0 * d,
                           w_enc_t, n, a.h, d, b_enc, 1.0f, 0, const_cast<float*>(a.pre), nullptr,
                           nullptr, nullptr, s);
    if (err) return err;
    if (group) {
#define WST_LAUNCH_CODER_GROUP(N)                                                    \
  coder_select_decode_group_kernel<N, SKIP, Y_IS_X>                                  \
      <<<group_grid(n, group_ctas_sm(N)), kGroupThreads * group_rows(N), smem, s>>>(ga, row0, n)
      WST_GROUP_DISPATCH(a.h, WST_LAUNCH_CODER_GROUP)
#undef WST_LAUNCH_CODER_GROUP
    } else {
#define WST_LAUNCH_CODER_WIDE(N) \
  coder_select_decode_wide_kernel<N, SKIP, Y_IS_X><<<n, kWideThreads, smem, s>>>(a, row0)
      WST_WIDE_DISPATCH_PAST_GROUP(a.h, WST_LAUNCH_CODER_WIDE)
#undef WST_LAUNCH_CODER_WIDE
    }
    err = (int)cudaGetLastError();
    if (err) return err;
    ++g_select_launches[group ? 0 : 1];
  }
  return 0;
}

// The TopK modes' wide route: cast, [the skip product over all rows
// (kPre)], per chunk the encode (kPre) and the select and decode (the
// group form, or past it the CTA-per-row form), sum.
int topk_wide_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset,
                  int rows, int d, int h, int dout, int k, int use_skip, int y_is_x,
                  const void* w_enc_t, const void* b_enc, const void* w_dec, const void* b_out,
                  const void* w_skip_t, void* hidden, void* resid, void* xc, void* pre,
                  void* sq_partial, void* counts, void* sums, void* stream) {
  if (h > kMaxWideRow || k > h || (y_is_x ? dout != d : y == nullptr) ||
      (use_skip && (!w_skip_t || y_is_x)) || reinterpret_cast<uintptr_t>(w_dec) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cast(x, x_bf16, row_offset, rows, d, xc, counts, 1 + h, s);
  if (err) return err;
  if (use_skip) {
    err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_skip_t, rows, dout, d, b_out, 1.0f, 0, resid,
                           nullptr, nullptr, nullptr, stream);
    if (err) return err;
  }
  const SelectArgs a{x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k,
                     static_cast<const float*>(pre),
                     static_cast<const unsigned short*>(w_dec),
                     static_cast<const float*>(b_out),
                     static_cast<unsigned short*>(hidden),
                     static_cast<float*>(resid),
                     static_cast<float*>(sq_partial),
                     static_cast<int*>(counts)};
  err = use_skip ? launch_select_wide<true, false>(a, d, xc, w_enc_t, b_enc, s)
        : y_is_x ? launch_select_wide<false, true>(a, d, xc, w_enc_t, b_enc, s)
                 : launch_select_wide<false, false>(a, d, xc, w_enc_t, b_enc, s);
  if (err) return err;
  coder_sum_kernel<<<1, kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), rows, nullptr,
                                              0, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace coder
}  // namespace wst

extern "C" {

// The coder forward: sums[0] = sum(resid^2), counts[0] = l0 count; d, h
// and dout multiples of 32.  k > 0 selects TopK: w_dec is W_dec itself
// [h, dout] bf16 (the rows the sparse decode gathers), pre an f32 [rows,
// h] workspace, sq_partial [ceil(rows / wst_rows_per_cta())] (4 rows a
// partial), counts [1 + h] (counts[1 + j] = feature j active), h <= 3072;
// w_skip_t [dout, d] with use_skip.  k <= 0 is ReLU mode (y is x, no skip):
// w_dec is W_dec^T [dout, h], sums[1] = sum(hid) and hsum[h] (feature j is
// active when hsum[j] > 0), with sq_partial [ceil(rows / 128) * ceil(dout /
// 128)], hsum_partial [ceil(rows / 64), h] (wst_gemm_tile() = 128) and
// counts [1].  The counts are zeroed here.
int wst_coder_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset,
                  int rows, int d, int h, int dout, int k, int use_skip, int y_is_x,
                  const void* w_enc_t, const void* b_enc, const void* w_dec, const void* b_out,
                  const void* w_skip_t, void* hidden, void* resid, void* xc, void* pre,
                  void* sq_partial, void* hsum_partial, void* counts, void* sums, void* hsum,
                  void* stream) {
  namespace C = wst::coder;
  if (rows <= 0 || d <= 0 || h <= 0 || dout <= 0 || d % wst::kWarp || h % wst::kWarp ||
      dout % wst::kWarp)
    return (int)cudaErrorInvalidValue;
  if (k <= 0) {
    if (use_skip || !y_is_x) return (int)cudaErrorInvalidValue;
    return C::relu_fwd(x, x_bf16, row_offset, rows, d, h, dout, w_enc_t, b_enc, w_dec, b_out,
                       hidden, resid, xc, sq_partial, hsum_partial, counts, sums, hsum, stream);
  }
  return C::topk_fwd(x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k, use_skip, y_is_x,
                     w_enc_t, b_enc, w_dec, b_out, w_skip_t, hidden, resid, xc, pre, sq_partial,
                     counts, sums, stream);
}

// The TopK modes' wide route (k >= 1; d, h and dout multiples of 32, h
// <= wst_max_wide_row_width()): the arguments of wst_coder_fwd's TopK
// modes, with ``pre`` an f32 [min(rows, wst_sae_topk_encode_chunk_rows(h)),
// h] workspace (the chunk's encode) and sq_partial [rows] (one partial a
// row), w_dec 4-byte aligned.  Skip mode with y given only (the transcoder).
int wst_coder_wide_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset,
                       int rows, int d, int h, int dout, int k, int use_skip, int y_is_x,
                       const void* w_enc_t, const void* b_enc, const void* w_dec,
                       const void* b_out, const void* w_skip_t, void* hidden, void* resid,
                       void* xc, void* pre, void* sq_partial, void* counts, void* sums,
                       void* stream) {
  if (rows <= 0 || d <= 0 || h <= 0 || dout <= 0 || k < 1 || d % wst::kWarp || h % wst::kWarp ||
      dout % wst::kWarp)
    return (int)cudaErrorInvalidValue;
  return wst::coder::topk_wide_fwd(x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k,
                                   use_skip, y_is_x, w_enc_t, b_enc, w_dec, b_out, w_skip_t,
                                   hidden, resid, xc, pre, sq_partial, counts, sums, stream);
}

// Select-and-decode launches the TopK modes' wide route has made in this
// process in the given form (0: the group form, 1: the CTA-per-row form).
long long wst_coder_select_launches(int form) {
  return form == 0 || form == 1 ? wst::coder::g_select_launches[form] : -1;
}

}  // extern "C"
