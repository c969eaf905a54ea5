// Hand-written Hopper kernels of the top-k encode: kernel B and the
// blocked (large-H) encode, one chunk loop with two selects.
//
// Both compute, for each row, the function of the TPU's encode kernels:
//   xc  = bf16(x - b_pre)                          (x f32 or bf16)
//   pre = xc @ W_enc + b_enc                       (bf16 products, f32 sums)
//   th  = exact k-th largest of pre                (topk_common.cuh)
//   out = relu(pre) * [pre >= th]                  (bf16 or f32)
// and take three launches per chunk of rows (encode_chunks):
//   (a) kernel A's centre (wst_sae_centre_fwd, sae_kernels.cu) writes the
//       chunk's xc (bf16 [chunk, D]) into the workspace;
//   (b) the encoder GEMM's kPre epilogue (TMA, wgmma, warp-specialised;
//       the same C entry as kernel A's encode) writes pre = acc + b_enc in
//       f32 from the registers into the workspace ([chunk, H]);
//   (c) a select reads each row of pre once into registers, finds the
//       exact threshold, stopping at the first count of exactly k, and
//       writes the latent at the chunk's row offset.
// Offsets of the [rows, H] arrays are 64-bit: above 13,107 rows a [rows,
// H] f32 array passes 2^31 bytes.
//
// Kernel B, wst_sae_topk_encode_fwd (D <= 384, H <= 3072: the gate of
// cuda_sae.fused_loss_supported), replaces
// whisper_sae_tpu/ops/pallas_sae.py:_encode_kernel (fused_topk_encode ->
// _encode_forward, pallas_call at :77).  Its select is the warp select of
// kernel C (sae_kernels.cu: topk_mask_kernel<bf16|f32>, one warp a row,
// the row in registers), and its chunk is the rows whose f32 pre fits the
// blocked encode's budget (kPreBudget: 27,264 rows at H = 3072).  W_enc
// (2.4 MB) fits the L2, so the GEMM walks row tiles first
// (gemm_kernel<kPre>).  Bound on the H100 at B = 4096 (3.35 TB/s, 989
// TFLOP/s bf16): bytes, x 6.3 MB, W_enc 2.4 MB and the bf16 latent 25 MB
// (0.0101 ms), against the product's 9.7 GFLOP (0.0098 ms).  The route
// adds the f32 pre's round trip, 2*4*B*H bytes (101 MB, 0.030 ms): the
// traffic the TPU kernel keeps in VMEM.  A CTA that kept its rows' pre in shared memory (16 rows
// of f32 at H = 3072 fill 192 KB) fits one CTA an SM and reads all of
// W_enc once every 16 rows; the GEMM reads it once every 128-row tile.
//
// The blocked encode, wst_blocked_encode_fwd, replaces
// pallas_sae.py:_encode_forward_blocked (_encode_kernel_blocked,
// pallas_call at :1392), the branch of fused_topk_encode taken when
// W_enc does not fit on chip (whisper-large 32x: D=1280, H=40960, W_enc
// 105 MB in bf16).  Its select is blocked_select_kernel: one CTA a row
// (cta_kth_largest), and its chunk kChunkRows = 2048 rows.
// Bound on the H100 at bench.py's batch (B=8192; 989 TFLOP/s bf16, 3.35
// TB/s): the product is 2*B*D*H = 859 GFLOP (0.87 ms) and the bisection
// at most 33*B*H integer operations (0.17 ms at 67 T/s), while the bytes
// it must move (x 42 MB, W_enc 105 MB, the bf16 latent 671 MB) take 0.24
// ms: it is bound by operations, 0.87 ms.
// Why the TPU's design does not carry over: the TPU keeps a 256-row block
// of pre (40 MB of int32) in VMEM while W_enc streams past it in [D, 2048]
// tiles.  One row of pre is 160 KB here, and an SM has 228 KB of shared
// memory, so a row block cannot stay on chip.  W_enc^T is larger than
// the L2 and than A, so the GEMM walks column tiles outer
// (gemm_cols_kernel; launch_gemm decides by shape): the chunk's xc (5.2
// MB) stays in L2 and W_enc streams from device memory once a chunk, 0.42
// GB at 8192 rows, against once a 128-row tile (6.7 GB) in the row-tile
// order.  Each output is one CTA's fixed K chain, so the order changes no
// bits.  Beyond the bound: the f32 workspace is written and read back,
// 2*4*B*H bytes (2.7 GB at B=8192, >= 0.80 ms); chunks of 2048 rows keep
// it at 335 MB.  Keeping pre on chip needs a thread-block cluster holding
// a row block's pre across its CTAs' shared memory, with the counts
// reduced over DSMEM: a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "topk_common.cuh"

// sae_kernels.cu: xc = bf16(x[row_offset + r] - b_pre) for r < rows, and
// the warp select of rows [0, rows) of pre into out[row0 : row0 + rows)
extern "C" int wst_sae_centre_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                                  const void* b_pre, void* xc, void* stream);
extern "C" int wst_topk_mask_rows_fwd(const float* pre, int rows, int h, int k, void* out,
                                      int out_f32, long long row0, void* stream);

namespace wst {
namespace blocked {

constexpr int kChunkRows = 2048;  // the blocked encode's chunk
// the f32 pre of one chunk at most: 2048 rows at H = 40960 (335 MB)
constexpr long long kPreBudget = (long long)kChunkRows * kMaxWideRow * sizeof(float);
constexpr int kRowAlign = 128;  // kernel B's chunk: a multiple of the GEMM's tile rows

// Kernel B's chunk: the rows whose f32 pre fits kPreBudget, rounded down
// to a multiple of kRowAlign.
static int warp_chunk_rows(int h) {
  return (int)(kPreBudget / ((long long)h * sizeof(float)) / kRowAlign * kRowAlign);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One CTA per row of the chunk: the row's pre into registers once (as
// monotone ints), the exact threshold, the latent written once.
template <int N, bool F32_OUT>
__global__ void __launch_bounds__(kWideThreads, 1) blocked_select_kernel(const float* pre, int h,
                                                                         int k, void* out,
                                                                         long long row0) {
  __shared__ int warp_cnt[2][kWideWarps];
  int xi[N];
  load_wide_monotone(pre + (size_t)blockIdx.x * h, h, xi);
  const int th = cta_kth_largest(xi, k, warp_cnt);
  const size_t base = (size_t)(row0 + blockIdx.x) * h;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    if (c < h) {
      const float v = masked_relu(xi[j], th);
      if (F32_OUT) {
        static_cast<float*>(out)[base + c] = v;
      } else {
        static_cast<unsigned short*>(out)[base + c] = float_to_bf16_bits(v);
      }
    }
  }
}

// The CTA select of rows [0, n) of pre into out[row0 : row0 + n): the
// blocked encode's (c).
static int cta_select(const float* pre, int n, int h, int k, void* out, int out_f32,
                      long long row0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WST_LAUNCH_SELECT(N)                                                                \
  if (out_f32) {                                                                            \
    blocked_select_kernel<N, true><<<n, kWideThreads, 0, s>>>(pre, h, k, out, row0);        \
  } else {                                                                                  \
    blocked_select_kernel<N, false><<<n, kWideThreads, 0, s>>>(pre, h, k, out, row0);       \
  }
  WST_WIDE_DISPATCH(h, WST_LAUNCH_SELECT)
#undef WST_LAUNCH_SELECT
  return (int)cudaGetLastError();
}

typedef int (*SelectFn)(const float* pre, int n, int h, int k, void* out, int out_f32,
                        long long row0, void* stream);

// Bytes of the workspace for ``rows`` rows in chunks of ``chunk``: one
// chunk's f32 pre [n, h], then its centred bf16 rows [n, d], n =
// min(rows, chunk).
static long long workspace_bytes(int rows, int d, int h, int chunk) {
  const long long n = rows < chunk ? rows : chunk;
  return n * h * (long long)sizeof(float) + n * d * 2;
}

// The encode over all rows, chunk by chunk: (a) the centre, (b) the
// product (the GEMM's kPre epilogue) into the workspace, (c) ``select``
// into out ([rows, h], bf16, or f32 when out_f32).  ws holds
// workspace_bytes(rows, d, h, chunk) bytes; w_enc_t ([h, d] bf16) is
// 16-byte aligned (read by TMA).
static int encode_chunks(const void* x, int x_bf16, int rows, int d, int h, int k,
                         const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                         int out_f32, void* ws, int chunk, SelectFn select, void* stream) {
  const int cap = rows < chunk ? rows : chunk;
  float* pre = static_cast<float*>(ws);
  // 16-byte aligned, as TMA reads it: cap * h * 4 is a multiple of 128
  unsigned short* xc =
      reinterpret_cast<unsigned short*>(static_cast<char*>(ws) + (size_t)cap * h * sizeof(float));
  for (int row0 = 0; row0 < rows; row0 += chunk) {
    const int n = rows - row0 < chunk ? rows - row0 : chunk;
    int err = wst_sae_centre_fwd(x, x_bf16, row0, n, d, b_pre, xc, stream);
    if (err) return err;
    err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, n, h, d, b_enc, 1.0f, 0, pre, nullptr,
                           nullptr, nullptr, stream);
    if (err) return err;
    err = select(pre, n, h, k, out, out_f32, row0, stream);
    if (err) return err;
  }
  return 0;
}

static bool bad_geometry(int rows, int d, int h, int k, int max_h) {
  return rows <= 0 || d <= 0 || d % kWarp || h <= 0 || h % kWarp || h > max_h || k < 1 || k > h;
}

}  // namespace blocked
}  // namespace wst

extern "C" {

// Rows of a chunk of the blocked encode: each chunk is three launches.
int wst_blocked_chunk_rows() { return wst::blocked::kChunkRows; }

// Bytes of the blocked encode's workspace for ``rows`` rows.
long long wst_blocked_workspace_bytes(int rows, int d, int h) {
  return wst::blocked::workspace_bytes(rows, d, h, wst::blocked::kChunkRows);
}

// The blocked encode (d and h multiples of 32, h <= wst_max_wide_row_width()):
// encode_chunks with the CTA select, chunks of kChunkRows; ws holds
// wst_blocked_workspace_bytes(rows, d, h) bytes.
int wst_blocked_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                           const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                           int out_f32, void* ws, void* stream) {
  namespace B = wst::blocked;
  if (B::bad_geometry(rows, d, h, k, wst::kMaxWideRow)) return (int)cudaErrorInvalidValue;
  return B::encode_chunks(x, x_bf16, rows, d, h, k, w_enc_t, b_enc, b_pre, out, out_f32, ws,
                          B::kChunkRows, B::cta_select, stream);
}

// Rows of a chunk of kernel B at width h.
int wst_sae_topk_encode_chunk_rows(int h) { return wst::blocked::warp_chunk_rows(h); }

// Bytes of kernel B's workspace for ``rows`` rows.
long long wst_sae_topk_encode_workspace_bytes(int rows, int d, int h) {
  return wst::blocked::workspace_bytes(rows, d, h, wst::blocked::warp_chunk_rows(h));
}

// Kernel B (d and h multiples of 32, h <= wst_max_row_width()):
// encode_chunks with kernel C's warp select, a bf16 latent (out_f32 = 0)
// or f32; ws holds wst_sae_topk_encode_workspace_bytes(rows, d, h) bytes.
int wst_sae_topk_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                            const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                            int out_f32, void* ws, void* stream) {
  namespace B = wst::blocked;
  if (B::bad_geometry(rows, d, h, k, wst::kMaxRow)) return (int)cudaErrorInvalidValue;
  return B::encode_chunks(x, x_bf16, rows, d, h, k, w_enc_t, b_enc, b_pre, out, out_f32, ws,
                          B::warp_chunk_rows(h), wst_topk_mask_rows_fwd, stream);
}

}  // extern "C"
