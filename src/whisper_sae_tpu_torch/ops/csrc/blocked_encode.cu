// Hand-written Hopper kernels of the top-k encode: one C entry,
// wst_sae_topk_encode_fwd, that is both kernel B and the blocked
// (large-H) encode -- one chunk loop with one select by row width.
//
// It computes, for each row, the function of the TPU's encode kernels:
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
//   (c) a select reads each row of pre from device memory once (past
//       327,680 values: part of it once a pass), finds the exact
//       threshold, stopping at the first count of exactly k, and writes
//       the latent at the chunk's row offset.
// Offsets of the [rows, H] arrays are 64-bit: above 13,107 rows a [rows,
// H] f32 array passes 2^31 bytes.
//
// The select by row width (select_form; ops/_build.py:select_form names
// the same forms), counted by form in g_select_launches:
//   warp   (H <= 3072)  kernel C's warp select (sae_kernels.cu:
//                       topk_mask_kernel<bf16|f32>, one warp a row);
//   group  (H <= 8192)  group_select_kernel: select_decode.cuh's group
//                       form without its decode -- persistent CTAs, a warp
//                       group a row on its own named barrier, the next
//                       row's pre brought into shared memory by a bulk copy
//                       (group_kth_largest), each thread writing its runs
//                       of four values in 8 (bf16) or 16 (f32) bytes;
//   cta    (H <= 40960) blocked_select_kernel: one CTA a row, the row in
//                       registers (cta_kth_largest);
//   cluster (H <= 2^20) cluster_select_kernel: a thread-block cluster of
//                       2, 4 or 8 CTAs a row (cluster_ctas), each CTA a
//                       slice in registers and shared memory, the counts
//                       summed over distributed shared memory, the last
//                       passes on the compacted candidates
//                       (cluster_kth_largest).
// Every form's midpoints, totals and early stop are cta_kth_largest's, so
// the forms give the same mask at any width they share
// (ops/topk.py:cta_threshold is their plain model; group_threshold and
// cluster_threshold add their forms' compaction, which changes neither).
//
// The cluster form replaces a spill form (one CTA a row, 40960
// values in registers, 57,344 in shared memory, the rest read again each
// pass): at [64, 262144] 64 CTAs re-read 163,840 values a row ~17 times,
// and at every width every pass walked the whole row.  Here [64, 262144]
// takes 8 CTAs a row, 512 in all, reads each value once; passes 0 and 1
// take one sweep, passes above the row's largest value none, and the
// compaction the rest, so before the compaction a row costs one sweep
// and exchange over the whole row on unit gaussian rows (two on
// whisper-large 64x's pre), of its ~17 passes; two CTAs an SM (256
// threads of at most 128 registers, 110 KB of shared memory) let one
// row's loads and stores run under another's passes.
//
// The chunk: the rows whose f32 pre fits kPreBudget (335 MB: 2048 rows
// at H = 40960), rounded down to a multiple of the GEMM's 128-row tile
// where that leaves a tile or more (H <= 655,360), else the budget's rows
// as they are (80 at H = 2^20), so the workspace never passes the budget
// plus the chunk's centred rows (encode_chunk_rows: 27,264 rows at H =
// 3072, 4,096 at whisper-large 16x, 1,280 at 65536).
//
// The entry replaces two Pallas kernels, and the Python wrapper
// (ops/cuda_sae.py:fused_topk_encode) counts its launches by the one it
// stands for, by the JAX package's own gate (pallas_sae.py:uses_blocked,
// :1433-1434: bf16 W_enc past 48 MiB):
//
// Kernel B replaces whisper_sae_tpu/ops/pallas_sae.py:_encode_kernel
// (fused_topk_encode -> _encode_forward, pallas_call at :77), which the
// JAX package takes wherever bf16 W_enc fits its 48 MiB of VMEM: every
// Whisper SAE up to H = 65536 at D = 384 (whisper-tiny 128x: H = 49152,
// the cluster form) but whisper-large 16x and wider.  Bound on the H100 at
// whisper-tiny (D=384, H=3072) and B = 4096
// (3.35 TB/s, 989 TFLOP/s bf16): bytes, x 6.3 MB, W_enc 2.4 MB and the
// bf16 latent 25 MB (0.0101 ms), against the product's 9.7 GFLOP (0.0098
// ms).  The route adds the f32 pre's round trip, 2*4*B*H bytes (101 MB,
// 0.030 ms): the traffic the TPU kernel keeps in VMEM.
//
// The blocked encode replaces pallas_sae.py:_encode_forward_blocked
// (_encode_kernel_blocked, pallas_call at :1392), the branch of
// fused_topk_encode taken when W_enc does not fit on chip (whisper-large
// 16x and wider: D=1280, H >= 20480; W_enc 105 MB in bf16 at 32x), up
// to H = 2^20 (pallas_sae.py:_MAX_H).  Bound on the H100 at bench.py's batch (B=8192;
// 989 TFLOP/s bf16, 3.35 TB/s) at whisper-large 32x: the product is
// 2*B*D*H = 859 GFLOP (0.87 ms) and the bisection at most 33*B*H integer
// operations (0.17 ms at 67 T/s), while the bytes it must move (x 42 MB,
// W_enc 105 MB, the bf16 latent 671 MB) take 0.24 ms: it is bound by
// operations, 0.87 ms.
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
// 2*4*B*H bytes (2.7 GB at B=8192, >= 0.80 ms); the chunk keeps it at
// 335 MB.  Keeping a row block's pre on chip (the select's cluster
// holds one row, not the GEMM's tile) would need the GEMM's epilogue to
// feed the cluster select: not done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "select_decode.cuh"
#include "topk_common.cuh"

// sae_kernels.cu: xc = bf16(x[row_offset + r] - b_pre) for r < rows, and
// the warp select of rows [0, rows) of pre into out[row0 : row0 + rows)
extern "C" int wst_sae_centre_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                                  const void* b_pre, void* xc, void* stream);
extern "C" int wst_topk_mask_rows_fwd(const float* pre, int rows, int h, int k, void* out,
                                      int out_f32, long long row0, void* stream);

namespace wst {
namespace blocked {

// the f32 pre of one chunk at most: 2048 rows at H = 40960 (335 MB)
constexpr long long kPreBudget = 2048LL * kMaxWideRow * sizeof(float);
constexpr int kRowAlign = 128;  // a chunk's rows: a multiple of the GEMM's tile rows

// The select's forms by row width (ops/_build.py:SELECT_FORMS).
enum Form { kWarpForm = 0, kGroupForm = 1, kCtaForm = 2, kClusterForm = 3 };

static int select_form(int h) {
  return h <= kMaxRow ? kWarpForm : h <= kGroupMaxRow ? kGroupForm
                                  : h <= kMaxWideRow  ? kCtaForm
                                                      : kClusterForm;
}

// Select launches of the encode in this process, by form.
long long g_select_launches[4] = {0, 0, 0, 0};

// The rows of a chunk at width h: those whose f32 pre fits kPreBudget,
// rounded down to a multiple of kRowAlign where that leaves kRowAlign or
// more, else as they are (at least one).
static int encode_chunk_rows(int h) {
  const long long rows = kPreBudget / ((long long)h * (long long)sizeof(float));
  if (rows >= kRowAlign) return (int)(rows / kRowAlign * kRowAlign);
  return rows > 0 ? (int)rows : 1;
}

// The CTA form: one CTA per row of the chunk, the row's pre into registers
// once (as monotone ints), the exact threshold, the latent written once.
template <int N, typename OutT>
__global__ void __launch_bounds__(kWideThreads, 1) blocked_select_kernel(const float* pre, int h,
                                                                         int k, OutT* out,
                                                                         long long row0) {
  __shared__ int warp_cnt[2][kWideWarps];
  int xi[N];
  load_wide_monotone(pre + (size_t)blockIdx.x * h, h, xi);
  const int th = cta_kth_largest(xi, k, warp_cnt);
  OutT* o = out + (size_t)(row0 + blockIdx.x) * h;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    if (c < h) store_latent(o + c, masked_relu(xi[j], th));
  }
}

__device__ __forceinline__ void store_run(float* p, const float (&v)[kGroupRun]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_run(unsigned short* p, const float (&v)[kGroupRun]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(float_to_bf16_bits(v[0]) | ((unsigned int)float_to_bf16_bits(v[1]) << 16),
                 float_to_bf16_bits(v[2]) | ((unsigned int)float_to_bf16_bits(v[3]) << 16));
}

// The group form without a decode, over a chunk of n rows: persistent
// CTAs of group_rows(N) warp groups (blockDim.x = kGroupThreads *
// group_rows(N), dynamic shared memory group_rows(N) * h * 4 bytes: each
// group's pre buffer).  Group g of CTA b walks rows b + gridDim.x * (g +
// G*i) of the chunk: the next row's pre comes into the group's buffer by
// a bulk copy once every thread of the group holds the current row in
// registers, the select runs on the group's named barrier, and thread t
// writes its runs c = q*kGroupSpan + 4t .. +3 of the latent at row row0 + r.
template <int N, typename OutT>
__global__ void __launch_bounds__(kGroupThreads * group_rows(N), group_ctas_sm(N))
    group_select_kernel(const float* pre, int n, int h, int k, OutT* out, long long row0) {
  constexpr int G = group_rows(N);
  extern __shared__ __align__(16) unsigned char group_smem[];
  __shared__ uint64_t full[G];
  __shared__ GroupSelScratch sel[G];
  const int grp = threadIdx.x / kGroupThreads, t = threadIdx.x % kGroupThreads;
  const int bar_id = 1 + grp;
  float* buf = reinterpret_cast<float*>(group_smem) + (size_t)grp * h;
  const uint32_t bytes = static_cast<uint32_t>(h) * 4u;
  const int stride = gridDim.x * G;
  int r = blockIdx.x + gridDim.x * grp;
  if (t == 0) {
    sel[grp].ncand = 0;
    wst_hopper::mbar_init(&full[grp], 1);
    wst_hopper::fence_mbar_init();
    if (r < n) {
      wst_hopper::mbar_expect_tx(&full[grp], bytes);
      wst_hopper::bulk_load_1d(buf, pre + (size_t)r * h, bytes, &full[grp]);
    }
  }
  wst_hopper::named_sync(bar_id, kGroupThreads);  // the barrier is initialised
#pragma unroll 1
  for (int phase = 0; r < n; r += stride, phase ^= 1) {
    wst_hopper::mbar_wait(&full[grp], phase);
    int xi[N];
    load_group_monotone(buf, h, t, xi);
    wst_hopper::named_sync(bar_id, kGroupThreads);  // every thread has read the buffer
    if (t == 0 && r + stride < n) {
      wst_hopper::fence_proxy_async();
      wst_hopper::mbar_expect_tx(&full[grp], bytes);
      wst_hopper::bulk_load_1d(buf, pre + (size_t)(r + stride) * h, bytes, &full[grp]);
    }
    const int th = group_kth_largest(xi, k, sel[grp], bar_id);
    OutT* o = out + (size_t)(row0 + r) * h;
#pragma unroll
    for (int q = 0; q < N / kGroupRun; ++q) {
      const int c = q * kGroupSpan + kGroupRun * t;
      if (c < h) {  // h is a multiple of 32: a run is wholly in or out
        float v[kGroupRun];
#pragma unroll
        for (int i = 0; i < kGroupRun; ++i) v[i] = masked_relu(xi[kGroupRun * q + i], th);
        store_run(o + c, v);
      }
    }
  }
}

// The first kClusterRegs elements of a slice into registers, in runs of
// four (xi[4q + i] = src[4 (q * kClusterThreads + t) + i]), as raw bits
// (0xffffffff past len, whose monotone int is kIntMin): every load issued
// before any is used, 16 bytes each where VEC, else 4.
template <bool VEC>
__device__ __forceinline__ void load_slice_bits(const float* src, int len, int t,
                                                int (&xi)[kClusterPerThread]) {
#pragma unroll
  for (int q = 0; q < kClusterPerThread / kGroupRun; ++q) {
    const int c = kGroupRun * (q * kClusterThreads + t);
    if (VEC) {
      const int4 v = c < len ? __ldg(reinterpret_cast<const int4*>(src + c)) : make_int4(-1, -1, -1, -1);
      xi[kGroupRun * q] = v.x;
      xi[kGroupRun * q + 1] = v.y;
      xi[kGroupRun * q + 2] = v.z;
      xi[kGroupRun * q + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < kGroupRun; ++i)
        xi[kGroupRun * q + i] = c + i < len ? __float_as_int(__ldg(src + c + i)) : -1;
    }
  }
}

// The slice's next ns elements into sm[0:ns) by asynchronous copies, 16
// bytes each where VEC (ns a multiple of 4), else 4; the caller waits.
template <bool VEC>
__device__ __forceinline__ void copy_slice_async(const float* src, int ns, int t, int* sm) {
  if (VEC) {
    for (int r = t; kGroupRun * r < ns; r += kClusterThreads)
      wst_hopper::cp_async_16(sm + kGroupRun * r, src + kGroupRun * r);
  } else {
    for (int i = t; i < ns; i += kClusterThreads) wst_hopper::cp_async_4(sm + i, src + i);
  }
  wst_hopper::cp_async_commit();
}

// The latent of the registers' elements, in runs of four (none past len).
template <bool VEC, typename OutT>
__device__ __forceinline__ void store_slice(OutT* o, int len, int t,
                                            const int (&xi)[kClusterPerThread], int th) {
#pragma unroll
  for (int q = 0; q < kClusterPerThread / kGroupRun; ++q) {
    const int c = kGroupRun * (q * kClusterThreads + t);
    float v[kGroupRun];
#pragma unroll
    for (int i = 0; i < kGroupRun; ++i) v[i] = masked_relu(xi[kGroupRun * q + i], th);
    if (VEC) {
      if (c < len) store_run(o + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < kGroupRun; ++i)
        if (c + i < len) store_latent(o + c + i, v[i]);
    }
  }
}

// The cluster form over a chunk of rows: cluster i (clusterid.x) of
// cluster_ctas(h) CTAs holds row i, CTA r the slice [r * slice, (r + 1) *
// slice) of it (the last slice the row's rest): the first kClusterRegs
// elements in registers, in runs of four (thread t the runs q *
// kClusterThreads + t), the next ns in dynamic shared memory (smem_ints
// ints, kIntMin past the slice), read from device memory once (every load
// in flight before any is used; 16-byte loads, copies and stores where h
// is a multiple of 4 and the arrays aligned), the rest read again each
// pass.  The cluster barrier is split around the loads (the mbarriers'
// init before them, its wait after) and around the stores (no CTA exits
// while another's remote stores or arrives may still reach it).
template <typename OutT>
__global__ void __launch_bounds__(kClusterThreads, 2)
    cluster_select_kernel(const float* pre, int h, int k, OutT* out, long long row0, int slice,
                          int smem_ints) {
  extern __shared__ __align__(16) int cluster_sm[];
  __shared__ ClusterSelScratch sc;
  const int t = threadIdx.x;
  const int row = (int)wst_hopper::cluster_id_x();
  const int base = (int)wst_hopper::cluster_rank() * slice;
  const int len = h - base < slice ? h - base : slice;  // > 0: h > (C - 1) * slice
  const float* src = pre + (size_t)row * h + base;
  OutT* o = out + (size_t)(row0 + row) * h + base;
  const bool vec = h % kGroupRun == 0 && reinterpret_cast<uintptr_t>(pre) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (t == 0) {
    const int arrivals = (int)wst_hopper::cluster_nctas() * kClusterWarps;
    wst_hopper::mbar_init(&sc.bar[0], arrivals);
    wst_hopper::mbar_init(&sc.bar[1], arrivals);
    wst_hopper::fence_mbar_init();
  }
  wst_hopper::cluster_arrive();
  const int rest = len - kClusterRegs;
  const int ns = rest <= 0 ? 0 : rest < smem_ints ? rest : smem_ints;
  int xi[kClusterPerThread];
  if (vec) {
    copy_slice_async<true>(src + kClusterRegs, ns, t, cluster_sm);
    load_slice_bits<true>(src, len, t, xi);
  } else {
    copy_slice_async<false>(src + kClusterRegs, ns, t, cluster_sm);
    load_slice_bits<false>(src, len, t, xi);
  }
  wst_hopper::cp_async_wait_all();
  __syncthreads();  // the shared part has landed: its monotone ints in place
  int4* sm4 = reinterpret_cast<int4*>(cluster_sm);
  int top = kIntMin;  // the largest of this thread's values (kIntMin past the slice)
  for (int r = t; r < smem_ints / kGroupRun; r += kClusterThreads) {
    const int4 b = sm4[r];
    const int c = kGroupRun * r;
    const int4 x = make_int4(c < ns ? monotone_int(__int_as_float(b.x)) : kIntMin,
                             c + 1 < ns ? monotone_int(__int_as_float(b.y)) : kIntMin,
                             c + 2 < ns ? monotone_int(__int_as_float(b.z)) : kIntMin,
                             c + 3 < ns ? monotone_int(__int_as_float(b.w)) : kIntMin);
    sm4[r] = x;
    top = max(top, max(max(x.x, x.y), max(x.z, x.w)));
  }
#pragma unroll
  for (int j = 0; j < kClusterPerThread; ++j) {
    xi[j] = monotone_int(__int_as_float(xi[j]));
    top = max(top, xi[j]);
  }
  __syncthreads();
  wst_hopper::cluster_wait();  // every CTA's mbarriers are initialised
  const int g0 = kClusterRegs + ns;
  const int th = cluster_kth_largest(xi, cluster_sm, smem_ints, src, g0, len, k, top, sc);
  wst_hopper::cluster_arrive();
  if (vec) {
    store_slice<true>(o, len, t, xi, th);
    for (int r = t; kGroupRun * r < ns; r += kClusterThreads) {
      const int4 x = sm4[r];
      const float v[kGroupRun] = {masked_relu(x.x, th), masked_relu(x.y, th),
                                  masked_relu(x.z, th), masked_relu(x.w, th)};
      store_run(o + kClusterRegs + kGroupRun * r, v);
    }
  } else {
    store_slice<false>(o, len, t, xi, th);
    for (int i = t; i < ns; i += kClusterThreads)
      store_latent(o + kClusterRegs + i, masked_relu(cluster_sm[i], th));
  }
  for (int c = g0 + t; c < len; c += kClusterThreads)
    store_latent(o + c, masked_relu(monotone_int(src[c]), th));
  wst_hopper::cluster_wait();
}

// The launch's cluster, slice and dynamic shared memory at width h.
static cudaLaunchConfig_t cluster_config(int n, int h, cudaStream_t s, cudaLaunchAttribute* attr,
                                         int* slice, int* smem_ints) {
  const int c = cluster_ctas(h);
  *slice = cluster_slice(h, c);
  *smem_ints = cluster_smem_ints(*slice);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * c);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = (size_t)*smem_ints * sizeof(int);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename OutT>
static int cluster_select(const float* pre, int n, int h, int k, OutT* out, long long row0,
                          cudaStream_t s) {
  cudaLaunchAttribute attr;
  int slice, smem_ints;
  const cudaLaunchConfig_t cfg = cluster_config(n, h, s, &attr, &slice, &smem_ints);
  int err = (int)cudaFuncSetAttribute(cluster_select_kernel<OutT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)cfg.dynamicSmemBytes);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, cluster_select_kernel<OutT>, pre, h, k, out, row0, slice,
                                smem_ints);
  return err ? err : (int)cudaGetLastError();
}

template <typename OutT>
static int group_select(const float* pre, int n, int h, int k, OutT* out, long long row0,
                        cudaStream_t s) {
  int err = 0;
#define WST_LAUNCH_GROUP_SELECT(N)                                                              \
  {                                                                                             \
    const int smem = group_rows(N) * h * (int)sizeof(float);                                    \
    err = (int)cudaFuncSetAttribute(group_select_kernel<N, OutT>,                               \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
    if (!err)                                                                                   \
      group_select_kernel<N, OutT><<<group_grid(n, group_ctas_sm(N)),                           \
                                     kGroupThreads * group_rows(N), smem, s>>>(pre, n, h, k,    \
                                                                               out, row0);      \
  }
  WST_GROUP_DISPATCH(h, WST_LAUNCH_GROUP_SELECT)
#undef WST_LAUNCH_GROUP_SELECT
  return err ? err : (int)cudaGetLastError();
}

template <typename OutT>
static int cta_select(const float* pre, int n, int h, int k, OutT* out, long long row0,
                      cudaStream_t s) {
#define WST_LAUNCH_SELECT(N) \
  blocked_select_kernel<N, OutT><<<n, kWideThreads, 0, s>>>(pre, h, k, out, row0)
  WST_WIDE_DISPATCH(h, WST_LAUNCH_SELECT)
#undef WST_LAUNCH_SELECT
  return (int)cudaGetLastError();
}

template <typename OutT>
static int typed_select(int form, const float* pre, int n, int h, int k, OutT* out,
                        long long row0, cudaStream_t s) {
  switch (form) {
    case kGroupForm: return group_select(pre, n, h, k, out, row0, s);
    case kCtaForm: return cta_select(pre, n, h, k, out, row0, s);
    default: return cluster_select(pre, n, h, k, out, row0, s);
  }
}

// The select of rows [0, n) of pre into out[row0 : row0 + n) (bf16, or
// f32 when out_f32) in the form of the row width: the encode's (c).
static int select_rows(const float* pre, int n, int h, int k, void* out, int out_f32,
                       long long row0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int form = select_form(h);
  int err;
  if (form == kWarpForm) {
    err = wst_topk_mask_rows_fwd(pre, n, h, k, out, out_f32, row0, stream);
  } else if (out_f32) {
    err = typed_select(form, pre, n, h, k, static_cast<float*>(out), row0, s);
  } else {
    err = typed_select(form, pre, n, h, k, static_cast<unsigned short*>(out), row0, s);
  }
  if (!err) ++g_select_launches[form];
  return err;
}

// Bytes of the workspace for ``rows`` rows: one chunk's f32 pre [n, h],
// then its centred bf16 rows [n, d], n = min(rows, encode_chunk_rows(h)).
static long long workspace_bytes(int rows, int d, int h) {
  const int chunk = encode_chunk_rows(h);
  const long long n = rows < chunk ? rows : chunk;
  return n * h * (long long)sizeof(float) + n * d * 2;
}

// The encode over all rows, chunk by chunk: (a) the centre, (b) the
// product (the GEMM's kPre epilogue) into the workspace, (c) the select
// into out ([rows, h], bf16, or f32 when out_f32).  ws holds
// workspace_bytes(rows, d, h) bytes; w_enc_t ([h, d] bf16) is 16-byte
// aligned (read by TMA).
static int encode_chunks(const void* x, int x_bf16, int rows, int d, int h, int k,
                         const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                         int out_f32, void* ws, void* stream) {
  const int chunk = encode_chunk_rows(h);
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
    err = select_rows(pre, n, h, k, out, out_f32, row0, stream);
    if (err) return err;
  }
  return 0;
}


}  // namespace blocked
}  // namespace wst

extern "C" {

// Widest row of the encode: the TPU's blocked encode's (pallas_sae.py:_MAX_H).
int wst_max_blocked_row_width() { return wst::kMaxBlockedRow; }

// Rows of a chunk of the encode at width h: each chunk is three launches.
int wst_sae_topk_encode_chunk_rows(int h) { return wst::blocked::encode_chunk_rows(h); }

// Bytes of the encode's workspace for ``rows`` rows.
long long wst_sae_topk_encode_workspace_bytes(int rows, int d, int h) {
  return wst::blocked::workspace_bytes(rows, d, h);
}

// The encode, kernel B's and the blocked encode's (d and h multiples of
// 32, h <= wst_max_blocked_row_width()): encode_chunks in chunks of
// wst_sae_topk_encode_chunk_rows(h), a bf16 latent (out_f32 = 0) or f32;
// ws holds wst_sae_topk_encode_workspace_bytes(rows, d, h) bytes.
int wst_sae_topk_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                            const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                            int out_f32, void* ws, void* stream) {
  if (rows <= 0 || d <= 0 || d % wst::kWarp || h <= 0 || h % wst::kWarp ||
      h > wst::kMaxBlockedRow || k < 1 || k > h)
    return (int)cudaErrorInvalidValue;
  return wst::blocked::encode_chunks(x, x_bf16, rows, d, h, k, w_enc_t, b_enc, b_pre, out,
                                     out_f32, ws, stream);
}

// The select's form at row width h (0 warp, 1 group, 2 CTA, 3 cluster).
int wst_select_form(int h) { return wst::blocked::select_form(h); }

// Select launches the encode has made in this process in the given form
// (one a chunk).
long long wst_encode_select_launches(int form) {
  return form >= 0 && form < 4 ? wst::blocked::g_select_launches[form] : -1;
}

// One select form alone, uncounted, on rows [0, rows) of pre into
// out[row0 : row0 + rows) (bf16, or f32 when out_f32), at a width the
// form holds: the group form (h a multiple of 32 up to 8192) or the CTA
// form (h up to 40960), both for comparisons on the card, or the cluster
// form (40960 < h <= 2^20), kernel C's wide form past 40960
// (sae_kernels.cu).
int wst_encode_select_fwd(int form, const float* pre, int rows, int h, int k, void* out,
                          int out_f32, long long row0, void* stream) {
  namespace B = wst::blocked;
  const bool holds = form == B::kGroupForm  ? h <= wst::kGroupMaxRow && h % wst::kWarp == 0
                     : form == B::kCtaForm   ? h <= wst::kMaxWideRow
                     : form == B::kClusterForm ? h > wst::kMaxWideRow && h <= wst::kMaxBlockedRow
                                             : false;
  if (!holds || rows <= 0 || h <= 0 || k < 1 || k > h) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? B::typed_select(form, pre, rows, h, k, static_cast<float*>(out), row0, s)
                 : B::typed_select(form, pre, rows, h, k, static_cast<unsigned short*>(out),
                                   row0, s);
}

// Clusters of the cluster select at width h (40960 < h <= 2^20) that
// the card can hold at once (cudaOccupancyMaxActiveClusters), or minus a
// CUDA error.
int wst_cluster_select_max_active(int h) {
  namespace B = wst::blocked;
  if (h <= wst::kMaxWideRow || h > wst::kMaxBlockedRow) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  int slice, smem_ints;
  const cudaLaunchConfig_t cfg = B::cluster_config(4096, h, nullptr, &attr, &slice, &smem_ints);
  int err = (int)cudaFuncSetAttribute(B::cluster_select_kernel<float>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)cfg.dynamicSmemBytes);
  int n = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveClusters(&n, B::cluster_select_kernel<float>, &cfg);
  return err ? -err : n;
}

// The cluster select's CTAs a row at width h (cluster_ctas).
int wst_cluster_ctas(int h) { return wst::cluster_ctas(h); }

}  // extern "C"
