// The Whisper encoder's row products on Hopper: one warp-specialised,
// TMA-fed wgmma GEMM, written for sm_90a.
//
// gemm_kernel<kQkv>       ("wst_enc_gemm_fwd", epi 0)
//   after ln_rows_kernel (encoder_kernels.cu) is LN1 + the q/k/v product
//   of the attention block;
// gemm_kernel<kResidual>  ("wst_enc_gemm_fwd", epi 1)
//   is the out-projection with its bias and the residual, and the MLP
//   block's fc2 (with the pre-residual output when it is captured);
// gemm_kernel<kGelu>      ("wst_enc_gemm_fwd", epi 2)
//   is the MLP block's fc1 with its bias and GELU;
// gemm_kernel<kPre>       ("wst_enc_gemm_fwd", epi 3)
//   is the TopK SAE's encode, pre = xc . W_enc + b_enc in f32, the second
//   of kernel A's four launches (sae_kernels.cu), and the coder's TopK
//   modes' encode and skip product (coder_kernels.cu); gemm_cols_kernel<kPre>,
//   the same with the column tiles outer, is the second of the blocked
//   encode's three launches a chunk (blocked_encode.cu);
// gemm_kernel<kRelu>      ("wst_coder_gemm_fwd", epi 4)
//   is the ReLU coder modes' encode, hid = bf16(relu(xc . W_enc + b_enc))
//   with the per-feature sums and l0, and
// gemm_kernel<kResid>     ("wst_coder_gemm_fwd", epi 5)
//   their decode, resid = hid . W_dec + b_dec - x in f32 with the sum of
//   squares: launches 2 and 3 of the ReLU modes of wst_coder_fwd
//   (coder_kernels.cu), which replace pallas_sae.py:_fused_coder_kernel
//   in ReLU mode.
// With attention_kernel.cu's core between them, q/k/v and the
// out-projection replace whisper_sae_tpu/ops/pallas_encoder.py:
// _attention_block_kernel and _attention_block_kernel_tiled
// (fused_attention_block, pallas_call at :340); LN2 (ln_rows_kernel),
// fc1, fc2 and the final-LN capture (ln_rows_kernel) replace
// _mlp_block_kernel (fused_mlp_block, pallas_call at :500), launched
// together by wst_mlp_block_fwd (encoder_kernels.cu).
//
// C[m, n] = A[m, k] . B[n, k]^T: A bf16 rows (the LN'd rows, the
// attention core's output, the MLP's hidden or the SAE's centred rows),
// B the weight in the [N, K] layout, f32 sums.  K and N multiples of 128
// (kPre, kRelu, kResid: K a multiple of 8, N even (kRelu: of 8); the last
// K block and the last column tile are ragged, TMA loads their columns
// past K and rows past N as zeros, and no column past N is stored); rows
// of A past m load as zeros (TMA) and are not stored.  Epilogues with the Pallas kernels' numerics
// (pallas_encoder.py:186-197, :225-229, :396-418; pallas_sae.py:189):
//   kQkv       q = bf16((acc + bq) * head_dim**-0.5), k = bf16(acc),
//              v = bf16(acc + bv), each written [m, d] (N = 3d; a
//              128-column tile lies in one third, as 128 divides d);
//   kResidual  y = bf16(acc + b); out = bf16(x + y); and, when asked,
//              aux = y (fc2's mlp_out capture);
//   kGelu      h = bf16(gelu(acc + b)), the exact erff GELU in f32 (the
//              TPU kernel's erf polynomial is a Mosaic workaround);
//   kPre       pre = acc + b in f32, stored straight from the registers
//              (two f32 a thread and row: each 32-byte sector is written
//              whole), so no output tile takes shared memory and the ring
//              keeps its 6 stages.  pre goes to device memory and back
//              (8 bytes a value): the price of kernel A's route, see
//              sae_kernels.cu.  At K = 384 the f32 output bounds it,
//              not the product: 50 MB at 4096 rows (15 us) against 9.7
//              GFLOP (9.8 us).
//   kRelu      hid = bf16(relu(acc + b)) through the output tile, as kGelu
//              (pallas_sae.py:579, :594); from the f32 values in registers,
//              over the rows below m only (a row past m loads as zeros, so
//              its value is relu(b), about half of it positive):
//              partial[r / 64, c] = the column's sum over the 64 rows of
//              one warpgroup (the f32, unrounded hidden, :604), summed
//              over the thread's two rows, then the warp's eight row pairs
//              by a butterfly, then the warpgroup's four warps in order
//              through shared memory (4 KB: the ring keeps 5 stages);
//              l0 += the positive values, an int32 atomic (order-free).
//              A feature is active exactly when its sum is positive (a
//              sum of values >= 0), so no active vector is kept here.
//   kResid     resid = acc + b - f32(x[row_offset + r, c]) in f32 (:599),
//              stored from the registers as kPre; partial[tile] = the
//              tile's sum of resid^2 over its rows below m: each thread's
//              fmaf chain, a butterfly, then the eight warps in order
//              (a two-slot shared buffer, one barrier a tile).
// No float atomics: two launches give the same bits.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s); every product here
// is bound by operations (the ReLU SAE's encode and decode at 4096 rows
// 9.7 GFLOP each, 9.8 us, the ReLU crosscoder's 38.7 GFLOP each, 39 us).  At whisper-large-v3, 16 clips (24,000 rows,
// D=1280, F=5120): q/k/v 2*24000*1280*3840 = 236 GFLOP, 0.24 ms; the
// out-projection 79 GFLOP, 0.08 ms; fc1 and fc2 315 GFLOP each, 0.32 ms.
// At whisper-tiny, 64 clips (96,000 rows, D=384, F=1536): fc1 and fc2
// 113 GFLOP each, 0.11 ms.  The MLP's hidden makes one bf16 round trip
// through device memory (2 * rows * F * 2 bytes: 0.18 ms at 3.35 TB/s at
// whisper-tiny, 0.15 ms at 16 large-v3 clips), the price of one route for
// every width: a kernel keeping the hidden on chip needs a 64 x D f32
// output accumulator a warpgroup (192 registers a thread at D = 384)
// beside fc1's, and re-reads both weights (2.36 MB at whisper-tiny) for
// every 64 rows, below the card's L2 ridge.
//
// What the design does about it (the usual shape of a Hopper GEMM):
// - One producer warp keeps TMA loads in flight: A and B tiles of 64 K
//   columns (one 128-byte swizzle span a row) from 2-D tensor maps into a
//   ring of 6 stages of 32 KB (5 for kResidual) with full/empty
//   mbarriers.
// - Two consumer warpgroups each own a 64 x 128 half of a 128 x 128
//   output tile and issue wgmma.mma_async m64n128k16 (bf16 in, f32 sums)
//   from shared memory, both operands K-major; one wgmma group stays in
//   flight while the next stage's is issued, and a stage is released as
//   soon as the group that read it has completed.
// - A persistent grid walks the output tiles, N fastest, so the CTAs in
//   flight share A's row tiles in L2.  Where B is larger than the L2 and
//   than A (kPre in the blocked encode, blocked_encode.cu: W_enc^T is 105
//   MB at whisper-large 32x) gemm_cols_kernel walks M fastest instead, so
//   that the CTAs in flight share B's column tiles, every row tile of A
//   stays in L2 and B streams from device memory once, not once a row
//   tile; each output is one CTA's fixed K chain either way, so the order
//   changes no bits.  The order is a template argument, not a run-time
//   one: read at run time it cost the other launches 1-4% on the card
//   (PERF.md).  The q/k/v product runs in clusters
//   of two CTAs that take the same column tile of two row tiles: each
//   producer loads its own A tile and half of the B tile, multicast into
//   both CTAs, so L2 serves 3/4 of the bytes; a stage is refilled once the
//   consumers of both CTAs have released it.  The out-projection and fc2
//   run one CTA alone: clusters did not speed the out-projection up on
//   the card.  fc1 (N = 4D, the widest product) runs one CTA alone too:
//   two CTAs were no faster on the card (PERF.md).
// - fc1's epilogue is issue-bound SIMT work (an erff a value): at
//   whisper-tiny, where K = 384 leaves a tile six k-blocks, it is 42% of
//   the kernel, run between the tiles' products.  Three ways to run it
//   under them were tried on the card and were slower: consumers taking
//   whole tiles in turn (a ping-pong, with an order barrier and
//   setmaxnreg), with one warpgroup a tile (one warp a sub-partition to
//   issue a tile's epilogue: 5% slower) or two (spills at 112 registers:
//   20% slower), and the epilogue deferred under the next tile's first
//   k-blocks in a second accumulator set (ptxas serialises the wgmmas:
//   1.9x).  PERF.md gives the times.
// - The epilogue writes the rounded tile into a swizzled shared buffer
//   and one thread stores it with TMA; the consumers go on to the next
//   tile's products while the store drains, and the producer has run
//   ahead into that tile's stages.  The residual tile of kResidual is
//   prefetched by TMA into its own buffer while the tile's products run.
//   fc2's capture of y needs a third 32 KB tile that shared memory does
//   not have beside 5 stages: each thread writes y over the residual
//   element it has just read (the same address, so no thread reads what
//   another wrote), TMA stores both buffers, and the next residual
//   prefetch waits until that store has read the buffer (bulk_wait_read).
//   The wait is only in the capture mode (the --capture-mlp extraction):
//   it costs 11% of fc2 at whisper-tiny and 2% at large-v3 (PERF.md); a
//   separate capture template with one stage fewer was not tried.
// A 256-column tile halves the re-reads of A but, with room for its
// output buffer, keeps only 3 stages; it was slower on the card.

#include "encoder_gemm.cuh"
#include "hopper_common.cuh"

namespace wst_gemm {

using namespace wst_hopper;

constexpr int kBM = 128;         // rows of an output tile: two warpgroups of 64
constexpr int kBN = 128;         // columns of an output tile: one m64n128k16 wgmma
constexpr int kBK = 64;          // K columns a stage: 128 bytes, one swizzle span
constexpr int kBoxes = kBN / kBK;  // 64-column TMA boxes of an output tile
constexpr int kConsumers = 2;    // consumer warpgroups a CTA
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kAlign = 128;      // N and K must be multiples of this
constexpr int kMaxDevices = 64;  // devices whose launch setup is kept
constexpr long long kL2Bytes = 50ll << 20;  // the H100's L2 cache
constexpr uint32_t kStageBytes = (kBM + kBN) * kBK * sizeof(bf16_t);
constexpr uint32_t kTileBytes = kBM * kBN * sizeof(bf16_t);

// the ring's depth; kResidual gives a stage to the residual tile's
// buffer, kRelu to its column sums
template <int EPI>
struct Stages {
  static constexpr int value = EPI == kResidual || EPI == kRelu ? 5 : 6;
};

// CTAs a cluster (see the note at the top)
template <int EPI>
struct Cluster {
  static constexpr int value = EPI == kQkv ? 2 : 1;
};

// A probe's build (-DWST_GEMM_MAINLOOP_ONLY, never the library's) runs the
// products alone: no epilogue, nothing stored.
#ifdef WST_GEMM_MAINLOOP_ONLY
constexpr bool kEpilogue = false;
#else
constexpr bool kEpilogue = true;
#endif

// Every tile is 1024-byte aligned (the 128-byte swizzle repeats every 8 rows).
template <int EPI>
struct __align__(1024) GemmSmem {
  static constexpr int S = Stages<EPI>::value;
  static constexpr int R = EPI == kResidual ? kBoxes : 1;
  bf16_t a[S][kBM * kBK];       // 16 KB a stage
  bf16_t b[S][kBN * kBK];       // 16 KB a stage
  bf16_t out[kBoxes][kBM * kBK];  // the output tile, as TMA boxes of 64 columns
  bf16_t res[R][EPI == kResidual ? kBM * kBK : 8];  // the residual tile (kResidual)
  // kRelu: each consumer warp's column sums of a tile; kResid: each
  // consumer warp's sum of squares, in two slots (tiles alternate)
  float red[EPI == kRelu ? kConsumers * 4 * kBN : EPI == kResid ? 2 * kConsumers * 4 : 1];
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t res_full;
};

struct Epilogue {
  const float* bias;   // [n] f32 (kQkv: bq, 0, bv)
  float* pre;          // kPre, kResid: the [m, n] f32 output
  float q_scale;       // kQkv: the q third's factor
  int d;               // kQkv: the width of one third
  int aux;             // kResidual: also store y = bf16(acc + b) (through map_o1)
  float* partial;      // kRelu: [ceil(m / 64), n] column sums; kResid: [tiles] sums of squares
  int* l0;             // kRelu: the count of positive values, zeroed by the caller
  const void* x;       // kResid: the target rows [>= row_offset + m, n], f32 or bf16
  int x_bf16;
  long long row_offset;
};

// bf16(a + b) of two packed pairs, each added in f32
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return pack2(bf2f((bf16_t)(a & 0xffffu)) + bf2f((bf16_t)(b & 0xffffu)),
               bf2f((bf16_t)(a >> 16)) + bf2f((bf16_t)(b >> 16)));
}

#define WST_D64                                                                             \
  "{"                                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"         \
  "}"
#define WST_D64_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both from shared memory,
// K-major; ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WST_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WST_D64_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// One CTA: two consumer warpgroups (threads 0 .. 255) and one producer
// warp (256 .. 287).  CLUSTER CTAs (2 for kQkv, else 1) form a
// cluster that walks the cluster tiles c = clusterid, + nclusterid, ...:
// CTA ``rank`` of the cluster takes the output tile of row tile CLUSTER
// (c / n_tiles) + rank and column tile c % n_tiles, or with COLS (column
// tiles outer) row tile CLUSTER (c % m_ctiles) + rank and column tile c /
// m_ctiles (m_ctiles: the cluster row tiles).  gemm_kernel<EPI> runs it
// rows outer, gemm_cols_kernel<EPI> columns outer: two entries, so that
// the order costs the launches that keep rows outer nothing.
// Accumulator layout (wgmma m64n128, f32): thread (warp w of the
// warpgroup, lane l) holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j +
// 2(l%4) + {0, 1} in d[4j + {0, 1}] and d[4j + {2, 3}].
// The output tile (and the residual tile) lie in shared memory as TMA
// writes them: 64-column boxes of 128-byte rows whose 16-byte chunks are
// swizzled by the row (chunk c of row r at c ^ (r % 8)).
template <int EPI, bool COLS>
__device__ __forceinline__ void gemm_tiles(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                           const CUtensorMap& map_o0, const CUtensorMap& map_o1,
                                           const CUtensorMap& map_o2, const CUtensorMap& map_res,
                                           long long m, int n, int k, const Epilogue& ep) {
  using Smem = GemmSmem<EPI>;
  constexpr int STAGES = Smem::S;
  constexpr int CLUSTER = Cluster<EPI>::value;
  constexpr int kBPart = kBN / CLUSTER;  // rows of B each CTA's producer loads
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int rank = CLUSTER > 1 ? (int)cluster_rank() : 0;
  const long long first = CLUSTER > 1 ? cluster_id_x() : blockIdx.x;
  const long long stride = CLUSTER > 1 ? cluster_count_x() : gridDim.x;
  const int n_tiles = (n + kBN - 1) / kBN;
  const long long m_tiles = (m + kBM - 1) / kBM;
  const long long m_ctiles = (m_tiles + CLUSTER - 1) / CLUSTER;
  const long long tiles = m_ctiles * n_tiles;  // cluster tiles
  const int kblocks = (k + kBK - 1) / kBK;
  auto tile_rows = [&](long long tile) {
    return ((COLS ? tile % m_ctiles : tile / n_tiles) * CLUSTER + rank) * kBM;
  };
  auto tile_col = [&](long long tile) {
    return (int)(COLS ? tile / m_ctiles : tile % n_tiles) * kBN;
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], CLUSTER * kConsumers * 4);  // every consumer warp of the cluster
    }
    mbar_init(&s.res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CLUSTER > 1) cluster_sync();  // the peer's barriers exist before any multicast
  else __syncthreads();

  if (wg == kConsumers) {  // the producer warp
    if (tid == kConsumers * 128) {
      int it = 0;
      for (long long tile = first; tile < tiles; tile += stride) {
        const long long row0 = tile_rows(tile);
        const int col0 = tile_col(tile);
        // a row tile wholly past m (the odd one of a pair) reads rows 0 ..; nothing is stored
        const int a_row = (int)(row0 < m ? row0 : 0);
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int st = it % STAGES, round = it / STAGES;
          if (round > 0) mbar_wait(&s.empty[st], (round - 1) & 1);
          mbar_expect_tx(&s.full[st], kStageBytes);
          tma_load_2d(s.a[st], &map_a, &s.full[st], kb * kBK, a_row);
          if (CLUSTER > 1)
            tma_load_2d_multicast(s.b[st] + rank * kBPart * kBK, &map_b, &s.full[st], kb * kBK,
                                  col0 + rank * kBPart, (uint16_t)((1u << CLUSTER) - 1));
          else
            tma_load_2d(s.b[st], &map_b, &s.full[st], kb * kBK, col0);
        }
      }
    }
  } else {
    const int lane = tid & 31, warp = (tid / 32) & 3;
    const int fr = lane >> 2, fc = (lane & 3) * 2;
    const int lr0 = wg * 64 + warp * 16 + fr;  // rows lr0 and lr0 + 8 of a tile
    // this warp is done with stage ``st`` (at CLUSTER = 2 lane r arrives
    // on CTA r's barrier)
    auto release = [&](int st) {
      __syncwarp();
      if (CLUSTER > 1) {
        if (lane < CLUSTER) mbar_arrive_cluster(&s.empty[st], lane);
      } else if (lane == 0) {
        mbar_arrive(&s.empty[st]);
      }
    };
    // kResidual: the residual tile of ``tile`` into s.res (thread 0, once
    // every consumer is done with the buffer)
    auto fetch_res = [&](long long tile) {
      if constexpr (EPI == kResidual && kEpilogue) {
        if (tid != 0 || tile >= tiles) return;
        const long long row0 = tile_rows(tile);
        mbar_expect_tx(&s.res_full, kTileBytes);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx)
          tma_load_2d(s.res[bx], &map_res, &s.res_full, tile_col(tile) + bx * kBK,
                      (int)(row0 < m ? row0 : 0));
      }
    };
    // element (row r, column c) of a tile buffer of 64-column boxes
    auto at = [&](bf16_t (*buf)[kBM * kBK], int r, int c) {
      return buf[c >> 6] + r * kBK + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
    };

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    fetch_res(first);
    int it = 0, local = 0;
    for (long long tile = first; tile < tiles; tile += stride, ++local) {
      const long long row0 = tile_rows(tile);
      const int col0 = tile_col(tile);
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int st = it % STAGES;
        mbar_wait(&s.full[st], (it / STAGES) & 1);
        const uint64_t da = desc_k_major(s.a[st] + wg * 64 * kBK);
        const uint64_t db = desc_k_major(s.b[st]);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_n128(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        wgmma_commit();
        fence_acc(acc);
        if (kb > 0) {  // the previous stage's group has completed: hand its stage back
          wgmma_wait<1>();
          release((it - 1) % STAGES);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release((it - 1) % STAGES);
      if (!kEpilogue) continue;

      if constexpr (EPI == kPre) {  // f32 pairs straight to device memory
        const long long r0 = row0 + lr0;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = col0 + j * 8 + fc;
          if (c >= n) continue;  // n is even, so c + 1 < n too
          const float b0 = __ldg(ep.bias + c), b1 = __ldg(ep.bias + c + 1);
          if (r0 < m)
            *reinterpret_cast<float2*>(ep.pre + r0 * n + c) =
                make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          if (r0 + 8 < m)
            *reinterpret_cast<float2*>(ep.pre + (r0 + 8) * n + c) =
                make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
        }
        continue;
      }

      if constexpr (EPI == kResid) {  // f32 pairs straight to device memory, as kPre
        float sq = 0.0f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int c = col0 + j * 8 + fc;
          if (c >= n) continue;
          const float b0 = __ldg(ep.bias + c), b1 = __ldg(ep.bias + c + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long r = row0 + lr0 + 8 * half;
            if (r >= m) continue;
            const long long xi = (ep.row_offset + r) * n + c;
            float x0, x1;
            if (ep.x_bf16) {
              const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
                  static_cast<const bf16_t*>(ep.x) + xi));
              x0 = bf2f((bf16_t)(v & 0xffffu));
              x1 = bf2f((bf16_t)(v >> 16));
            } else {
              const float2 v = __ldg(reinterpret_cast<const float2*>(
                  static_cast<const float*>(ep.x) + xi));
              x0 = v.x;
              x1 = v.y;
            }
            const float e0 = acc[4 * j + 2 * half] + b0 - x0;
            const float e1 = acc[4 * j + 2 * half + 1] + b1 - x1;
            *reinterpret_cast<float2*>(ep.pre + r * n + c) = make_float2(e0, e1);
            sq = fmaf(e0, e0, sq);
            sq = fmaf(e1, e1, sq);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        float* red = s.red + (local & 1) * (kConsumers * 4);
        if (lane == 0) red[wg * 4 + warp] = sq;
        named_sync(1, kConsumers * 128);
        if (tid == 0) {  // thread 0 has read this slot before any warp passes the next barrier
          float t = 0.0f;
#pragma unroll
          for (int w = 0; w < kConsumers * 4; ++w) t += red[w];
          ep.partial[tile] = t;
        }
        continue;
      }

      // The epilogue: the values, rounded to bf16, into the output-tile
      // buffer once the previous tile's store has read it; then thread 0
      // stores it (rows past m are not written) and fetches the next
      // residual tile, and the consumers go on to the next tile.
      const CUtensorMap* map_o = &map_o0;
      int ocol0 = col0;
      float sc = 1.0f;
      if (EPI == kQkv) {
        const int part = col0 / ep.d;
        map_o = part == 0 ? &map_o0 : part == 1 ? &map_o1 : &map_o2;
        ocol0 = col0 - part * ep.d;
        sc = part == 0 ? ep.q_scale : 1.0f;
      }
      if (tid == 0) bulk_wait_read<0>();
      if (EPI == kResidual) mbar_wait(&s.res_full, local & 1);
      named_sync(1, kConsumers * 128);
      // kRelu: rows below m, the positive values this thread holds there
      const bool v0 = row0 + lr0 < m, v1 = row0 + lr0 + 8 < m;
      int pos = 0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = j * 8 + fc;
        float b0 = 0.0f, b1 = 0.0f;  // n is even: c + 1 is below n with c
        if (col0 + c < n) b0 = __ldg(ep.bias + col0 + c), b1 = __ldg(ep.bias + col0 + c + 1);
        uint32_t* o0 = reinterpret_cast<uint32_t*>(at(s.out, lr0, c));
        uint32_t* o1 = reinterpret_cast<uint32_t*>(at(s.out, lr0 + 8, c));
        if constexpr (EPI == kQkv) {
          *o0 = pack2((acc[4 * j] + b0) * sc, (acc[4 * j + 1] + b1) * sc);
          *o1 = pack2((acc[4 * j + 2] + b0) * sc, (acc[4 * j + 3] + b1) * sc);
        } else if constexpr (EPI == kGelu) {
          *o0 = pack2(gelu(acc[4 * j] + b0), gelu(acc[4 * j + 1] + b1));
          *o1 = pack2(gelu(acc[4 * j + 2] + b0), gelu(acc[4 * j + 3] + b1));
        } else if constexpr (EPI == kResidual) {
          uint32_t* r0 = reinterpret_cast<uint32_t*>(at(s.res, lr0, c));
          uint32_t* r1 = reinterpret_cast<uint32_t*>(at(s.res, lr0 + 8, c));
          const uint32_t y0 = pack2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          const uint32_t y1 = pack2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
          *o0 = add2(*r0, y0);
          *o1 = add2(*r1, y1);
          if (ep.aux) {  // y over the residual this thread has just read
            *r0 = y0;
            *r1 = y1;
          }
        } else if constexpr (EPI == kRelu) {
          const float h00 = fmaxf(acc[4 * j] + b0, 0.0f), h01 = fmaxf(acc[4 * j + 1] + b1, 0.0f);
          const float h10 = fmaxf(acc[4 * j + 2] + b0, 0.0f), h11 = fmaxf(acc[4 * j + 3] + b1, 0.0f);
          *o0 = pack2(h00, h01);
          *o1 = pack2(h10, h11);
          float s0 = (v0 ? h00 : 0.0f) + (v1 ? h10 : 0.0f);
          float s1 = (v0 ? h01 : 0.0f) + (v1 ? h11 : 0.0f);
          pos += (v0 ? (h00 > 0.0f) + (h01 > 0.0f) : 0) + (v1 ? (h10 > 0.0f) + (h11 > 0.0f) : 0);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // the warp's 8 row pairs (lanes of one lane & 3)
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          if (fr == 0) {
            float* red = s.red + (wg * 4 + warp) * kBN;
            red[c] = s0;
            red[c + 1] = s1;
          }
        }
      }
      fence_proxy_async();
      named_sync(1, kConsumers * 128);
      if constexpr (EPI == kRelu) {
        // the warpgroup's 64 rows: its four warps' column sums, in order;
        // the barrier before the next tile's sums keeps these reads first
        const int c = tid & (kBN - 1);
        if (row0 + wg * 64 < m && col0 + c < n) {
          const float* red = s.red + wg * 4 * kBN + c;
          ep.partial[(row0 / 64 + wg) * n + col0 + c] =
              ((red[0] + red[kBN]) + red[2 * kBN]) + red[3 * kBN];
        }
        pos = __reduce_add_sync(0xffffffffu, pos);
        if (lane == 0 && pos) atomicAdd(ep.l0, pos);
      }
      if (tid == 0) {
        if (row0 < m) {
#pragma unroll
          for (int bx = 0; bx < kBoxes; ++bx)
            if (col0 + bx * kBK < n) tma_store_2d(map_o, s.out[bx], ocol0 + bx * kBK, (int)row0);
          if constexpr (EPI == kResidual) {
            if (ep.aux) {
#pragma unroll
              for (int bx = 0; bx < kBoxes; ++bx)
                tma_store_2d(&map_o1, s.res[bx], ocol0 + bx * kBK, (int)row0);
            }
          }
          bulk_commit();
        }
        // the store has read y before the next residual lands in its buffer
        if (EPI == kResidual && ep.aux) bulk_wait_read<0>();
        fetch_res(tile + stride);
      }
    }
    if (tid == 0) bulk_wait<0>();  // every store has landed before the CTA ends
  }
  // no CTA of the cluster leaves while its peer may still arrive on its barriers
  if (CLUSTER > 1) cluster_sync();
}

#define WST_GEMM_PARAMS                                                                     \
  const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,     \
      const __grid_constant__ CUtensorMap map_o0, const __grid_constant__ CUtensorMap map_o1, \
      const __grid_constant__ CUtensorMap map_o2, const __grid_constant__ CUtensorMap map_res, \
      long long m, int n, int k, const Epilogue ep

// Row tiles outer: every launch but the blocked encode's product.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(WST_GEMM_PARAMS) {
  gemm_tiles<EPI, false>(map_a, map_b, map_o0, map_o1, map_o2, map_res, m, n, k, ep);
}

// Column tiles outer, for a B larger than the L2 and than A (see the note
// at the top; launch_gemm decides).
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1) gemm_cols_kernel(WST_GEMM_PARAMS) {
  gemm_tiles<EPI, true>(map_a, map_b, map_o0, map_o1, map_o2, map_res, m, n, k, ep);
}
#undef WST_GEMM_PARAMS

// [rows, cols] bf16 row-major as a 2-D map (innermost first: cols, rows),
// boxes of 64 columns x box_rows rows, 128-byte swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16_t)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The clusters that fit on each device, by epilogue (and one slot for
// gemm_cols_kernel<kPre>), 0 until the first launch there.  File-local: a
// function-local static of a template would be one object across every
// loaded copy of the library.
static int g_fits[kEpilogues + 1][kMaxDevices];

// outs: q, k, v ([m, d] each) for kQkv; for kResidual out ([m, n]), then
// aux ([m, n], or out again when ep.aux is 0), out; its residual ``res``
// is [m, n]; out ([m, n]) three times for kGelu and kRelu; unused for kPre
// and kResid (their f32 output is ep.pre, stored without a tensor map).
template <int EPI>
int launch_gemm(const void* a, const void* b, long long m, int n, int k, void* const* outs,
                const void* res, const Epilogue& ep, cudaStream_t stream) {
  constexpr int CLUSTER = Cluster<EPI>::value;
  auto kernel = gemm_kernel<EPI>;
  int* fits = g_fits[EPI];
  // the tile order (see the note at the top): column tiles outer only
  // where B is larger than the L2 and than A, which only kPre's blocked
  // encode meets (kResid's partials are indexed by tile in row order)
  if constexpr (EPI == kPre) {
    if (n > m && (long long)n * k * (long long)sizeof(bf16_t) > kL2Bytes) {
      kernel = gemm_cols_kernel<EPI>;
      fits = g_fits[kEpilogues];
    }
  }
  const int out_cols = EPI == kQkv ? ep.d : n;
  CUtensorMap ma, mb, mo[3], mr;
  int err = make_map(&ma, a, m, k, kBM);
  if (!err) err = make_map(&mb, b, n, k, kBN / CLUSTER);
  if (EPI == kPre || EPI == kResid) {  // no bf16 output or residual: the maps are never read
    mo[0] = mo[1] = mo[2] = mr = ma;
  } else {
    // one encode a distinct tensor (kGelu and kRelu store one output)
    if (!err) err = make_map(&mo[0], outs[0], m, out_cols, kBM);
    for (int i = 1; i < 3 && !err; ++i)
      if (outs[i] == outs[0]) mo[i] = mo[0];
      else err = make_map(&mo[i], outs[i], m, out_cols, kBM);
    if (EPI == kResidual && !err) err = make_map(&mr, res, m, out_cols, kBM);
    else mr = mo[0];
  }
  if (err) return err;
  const size_t smem = sizeof(GemmSmem<EPI>) + 1024;  // + room to align the base to 1024
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as fit on the card at once, at most one
  // a cluster tile; the attribute and the count are set up once a device
  // (the launch is on the host's path between every two layers)
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (fits[dev] == 0) {
    int sms = 0, fit = 0;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cfg.gridDim = dim3(sms / CLUSTER * CLUSTER);
    if (!err) err = (int)cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err) return err;
    if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
    fits[dev] = fit;
  }
  const int fit = fits[dev];
  const long long tiles = ((m + kBM - 1) / kBM + CLUSTER - 1) / CLUSTER * ((n + kBN - 1) / kBN);
  cfg.gridDim = dim3((unsigned)((tiles < fit ? tiles : fit) * CLUSTER));
  err = (int)cudaLaunchKernelEx(&cfg, kernel, ma, mb, mo[0], mo[1], mo[2], mr, m, n, k, ep);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace wst_gemm

extern "C" {

// C = A . B^T with epilogue ``epi`` (0: q/k/v, 1: bias + residual, 2:
// bias + GELU, 3: bias, f32).  a: [m, k] bf16; b: [n, k] bf16; bias: [n]
// f32; n and k multiples of 128 (epi 3: k a multiple of 8, n even).
// epi 0: n = 3d, outputs out0/out1/out2 = q/k/v [m, d]; epi 1: out0 [m, n]
// = res + y with y = bf16(acc + bias), and out1 [m, n] = y unless it is
// null; epi 2: out0 [m, n] = bf16(gelu(acc + bias)); epi 3: out0 [m, n]
// f32 = acc + bias.
int wst_enc_gemm_fwd(int epi, const void* a, const void* b, long long m, int n, int k,
                     const void* bias, float q_scale, int d, void* out0, void* out1, void* out2,
                     const void* res, void* stream) {
  using namespace wst_gemm;
  if (m <= 0) return 0;
  if (epi < 0 || epi > kPre || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (epi == kPre ? (k % 8 || n % 2) : (k % kAlign || n % kAlign))
    return (int)cudaErrorInvalidValue;
  if (epi == kQkv && (d <= 0 || d % kBN || n != 3 * d)) return (int)cudaErrorInvalidValue;
  Epilogue ep{};
  ep.bias = static_cast<const float*>(bias);
  ep.pre = static_cast<float*>(out0);
  ep.q_scale = q_scale;
  ep.d = d;
  ep.aux = epi == kResidual && out1 != nullptr;
  void* const outs[3] = {out0, epi == kQkv || ep.aux ? out1 : out0, epi == kQkv ? out2 : out0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == kQkv) return launch_gemm<kQkv>(a, b, m, n, k, outs, res, ep, s);
  if (epi == kGelu) return launch_gemm<kGelu>(a, b, m, n, k, outs, res, ep, s);
  if (epi == kPre) return launch_gemm<kPre>(a, b, m, n, k, outs, res, ep, s);
  return launch_gemm<kResidual>(a, b, m, n, k, outs, res, ep, s);
}

// The ReLU coder modes' GEMMs, C = A . B^T with epilogue ``epi``: a [m, k]
// bf16, b [n, k] bf16, bias [n] f32, k a multiple of 8, n of 8.
// epi 4 (kRelu): out [m, n] bf16 = relu(acc + bias); partial [ceil(m /
// 64), n] f32 the column sums over each 64 rows; l0 [1] int32, zeroed by
// the caller, += the positive values.  epi 5 (kResid): out [m, n] f32
// = acc + bias - x[row_offset + r, :] (x f32, or bf16 when x_bf16, with
// rows of n); partial [ceil(m / 128) * ceil(n / 128)] f32 the sums of
// squares of the 128 x 128 tiles, row tiles outer.
int wst_coder_gemm_fwd(int epi, const void* a, const void* b, long long m, int n, int k,
                       const void* bias, void* out, void* partial, void* l0, const void* x,
                       int x_bf16, long long row_offset, void* stream) {
  using namespace wst_gemm;
  if (m <= 0) return 0;
  if ((epi != kRelu && epi != kResid) || k <= 0 || n <= 0 || k % 8 || n % 8)
    return (int)cudaErrorInvalidValue;
  if (epi == kRelu ? l0 == nullptr : (x == nullptr || row_offset < 0))
    return (int)cudaErrorInvalidValue;
  Epilogue ep{};
  ep.bias = static_cast<const float*>(bias);
  ep.pre = static_cast<float*>(out);
  ep.partial = static_cast<float*>(partial);
  ep.l0 = static_cast<int*>(l0);
  ep.x = x;
  ep.x_bf16 = x_bf16;
  ep.row_offset = row_offset;
  void* const outs[3] = {out, out, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == kRelu) return launch_gemm<kRelu>(a, b, m, n, k, outs, nullptr, ep, s);
  return launch_gemm<kResid>(a, b, m, n, k, outs, nullptr, ep, s);
}

// Rows (and columns) of the GEMM's output tile: the kResid partials are
// one a tile, the kRelu partials one a half tile of rows.
int wst_gemm_tile() { return wst_gemm::kBM; }

}  // extern "C"
