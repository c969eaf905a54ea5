#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/whisper_sae_tpu_torch``) on one
NVIDIA GPU (built for the H100, ``sm_90a``).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

0. Build: compile the port's CUDA kernels from ``ops/csrc`` with nvcc.
1. Kernels at whisper-tiny width (D=384, H=3072, k=32), B=128 and B=4096
   (A and B also at 32768: kernel B's two chunks): each kernel against
   its plain PyTorch version on the same card inputs (kernel A sliced and
   at a row offset, B in bf16 and f32, C), with gradients through each
   autograd.Function against the same Function on the CPU (plain
   forward), kernel A's loss and kernel B's latent bit-identical run to
   run, and kernel B's bf16 latent equal to kernel A's on the same rows
   (both select on the kPre pre with the warp select); kernel C's warp and
   wide forms on rows where -0.0 is selected (their -0.0 count logged).
   Tolerances: kernel C exact; A and B compute ``pre`` with tensor-core
   sums in another order than the plain f32 product, so >= 99.9% of rows
   must select the same features, A's loss at rtol 1e-4, l0 and the
   active vector equal on those rows, the latent within bf16 rounding
   (atol 1e-2 * max); gradients at rtol 2e-2.  Each row that selects
   differently is printed with the plain pre's gap between its k-th and
   (k+1)-th values and the row's max |pre_card - pre_plain| (the kPre
   encode's pre); a gap wider than twice that fails.  Where fewer than
   99.9% of A's or B's rows agree, the run logs before it fails the rows
   that differ, the card latent's non-finite and all-zero rows, whether
   the card's centred rows equal the plain ones, the max |pre_card -
   pre_plain| over all rows and whether a relaunch gives the same bits.
1b. The training step's backward over the selected latents
   (``sae_topk_backward``, ``ops/csrc/sae_backward.cu``) at the training
   cells' shapes, each on its route: kernel A's at whisper-tiny 8x (32768
   rows, D=384, H=3072), the composed route's at whisper-large 32x (8192,
   1280, 40960), on the latent, residual and centred rows of the route's
   own forward.  Against its plain version and the dense ``mm_f32``
   products it replaced: bit for bit on inputs of the same selection whose
   f32 sums are exact in any order; on the forward's own values within
   one bf16 step where dpre or the sum is rounded to bf16 (max |gap| <=
   2^-8 max |g|, mean <= 1e-5 max |g|; the composed dW_dec each element
   within 2^-7 of itself), else max |gap| <= 1e-5 max |g|; two calls
   bit-identical.  Then its time beside the plain version's, its bytes
   bound and the dense products' (the yardstick), and each launch's
   device ms (``torch.profiler``).
2. Training through the CLI (``whisper_sae_tpu_torch.train.main``) on a
   synthetic gaussian cache (covariance mostly of rank 64) of 2^18 + 64
   rows x 384 f32 in the JAX
   package's format, with configs/tiny_default.yaml's widths, k, batch 128
   and AMP, 3 epochs (2,048 windowed kernel-A steps and one remainder
   step each) and one dead-feature resample at the third epoch's end.
3. Eval of the trained SAE on held-out rows: bf16 ``topk_sae_apply``
   (kernel B) and the f32 ``TopKSAE`` forward (kernel C).
   Every kernel's launch count is zeroed before phase 2 and must be
   above 0 after phase 3; the sparse backward's must be one a training
   step, none of them on the composed route.  Then the trained SAE's forward on the card is
   held against the same SAE on the CPU on 512 rows.
4. Times: a training step's wall time and, under ``torch.profiler``, the
   device's busy time and heaviest operations; then with CUDA events each
   kernel, its plain version and one PyTorch call as a yardstick (the
   bf16 encode product for A and B, ``torch.topk`` for C -- yardsticks,
   not equivalents), beside the least time the card needs for the same
   work; kernels A and B also at 32768 rows, with each launch's device
   time under ``torch.profiler`` (``split_ms``: A's four launches, B's
   centre, ``gemm_kernel<3>`` and warp select summed over its chunks).

5. Encoder kernels at whisper-tiny width (D=384, 6 heads, F=1536,
   T=1500, 80 mels), 64 clips: the conv stem (three launches: the prep,
   conv1 and conv2 as tap products on the Hopper GEMM of
   ``ops/csrc/encoder_gemm.cu``), LN+QKV, the attention core
   (also launched as the composed route's flash attention), the
   out-projection, the whole attention block and the MLP block in all
   four output modes, each against its plain version on the same card
   inputs at the one-block bar (max|d| <= 2**-6 max|ref|, mean|d| <=
   2**-9 mean|ref|).  LN+QKV, the out-projection and the MLP block (all
   on the same GEMM) also at every width the gate takes (D = 384 ..
   1536, heads of 64, F = 4D) on a ragged 64*1500 - 37 rows and on 100
   rows, the MLP block in all four modes (on the ragged rows against its
   plain version on one row in 16 of every tile and the whole last
   tile), and the stem at every gate width for 80 and 128 mels on 2
   clips; they, the stem and the attention core give the same bits on
   two launches.
6. Extraction through the CLI (``--extract-only --random-whisper``,
   tiny_default.yaml's widths and layers, the synthetic dataset, 128
   clips, bf16): every encoder kernel's launch count is zeroed before
   and checked after (stem once a batch, the attention launches and the
   MLP block once a layer and batch), the plain versions are called no
   time, and the 8 caches hold 128*1500 (encoder) or 128 (decoder) finite
   rows of 384.  The first 2 clips of each cache are held against the
   same extraction on the CPU (plain versions) at the stack bar (2**-4,
   2**-7 per layer); the f32 mode on the card against the CPU at rtol
   1e-3; one bf16 ``encoder_forward(use_fused=False)`` on 2 clips must
   launch the attention core on the flash route once a layer.  Then the
   CLI trains one epoch from the extracted ``encoder:3`` cache (loss
   finite and falling) and the caches are deleted.
7. Times of the extraction slice: ``extract_activations`` at batch 64
   (bf16, all layers captured, decoder on), the CLI extraction end to
   end, the device's busy share under ``torch.profiler`` and the attention
   and MLP blocks' parts of it, the stem's three launches' device ms
   (``torch.profiler``), and each
   encoder kernel beside its plain version, its bound and a library
   yardstick (``torch.matmul`` for the projections, the conv1d pair for
   the stem, ``scaled_dot_product_attention`` for the core -- yardsticks,
   not ports).  The kernels run on weights already in their layout (built
   once per parameter tensor); the preparation's one-off time is printed
   on its own line, and the launches of LN+QKV (LN1, the GEMM), the
   out-projection and the MLP block (LN2, fc1, fc2, the final LN), each
   timed alone, on one line a kernel.
8. The coder kernel (``ops/csrc/coder_kernels.cu``; the encodes, the
   ReLU modes' decode and the Skip mode's skip product on
   ``encoder_gemm.cu``) at whisper-tiny width, B=4096, in its five modes
   (Skip and TopK transcoder, ReLU SAE: D=384, H=3072, k=32; TopK and
   ReLU crosscoder: L*D=1536, S=3072), sliced, at a row offset into a
   larger buffer, on a 1,792-row remainder, on ragged 100- and
   1,000-row windows at an offset (whose pad rows, with pre = b_enc
   about half positive, must count nowhere) and at B=32768 (the ReLU
   modes also at phase 9's batch of 128 rows, sliced and at a row
   offset), against its plain version: TopK modes at kernel A's bars
   (with phase 1's print of each row that selects differently, its gap
   held to twice the row's max |pre_card - pre_plain|: the TopK modes
   select on exactly the kPre pre that phase 1's check recomputes);
   ReLU modes with the latent within bf16 rounding (atol 1e-2 *
   max), sum(resid^2), the L1 and the hidden sums at rtol 1e-4, l0 at
   rel 1e-4 and ``active`` equal on >= 99.9% of features.  Gradients
   through each autograd.Function (sliced and windowed, 1024 rows)
   against the same Function on the CPU at rtol 2e-2 (ReLU modes: >=
   99.99% of each gradient's elements, as a pre within rounding of 0
   moves one feature's column); outputs
   bit-identical run to run.
9. The coder slice through its entry points, every coder launch counter
   and the plain-call counters zeroed first: a ReLU SAE through the CLI
   on phase 2's cache (tiny_default.yaml with ``activation: relu``, one
   epoch); ``launch extract --capture-mlp`` of 64 synthetic clips (4
   layer caches and 4 (mlp_in, mlp_out) pairs of 96,000 rows);
   ``launch train-transcoder`` (Skip, then ``--no-skip``) and
   ``launch train-crosscoder`` (TopK, then ``--relu``), 2 epochs at
   batch 4096 and learning rate 1e-2 (the launcher's 1000-step warmup
   would leave 48 steps at a rate too small to see the loss move).
   Windowed launches must equal the windowed steps, sliced launches be
   at least one an epoch (the remainder), the plain versions run no
   time, the losses be finite and fall, the run files exist; each
   trained family's forward on 512 rows on the card is held against the
   same model on the CPU (loss rtol 1e-3, >= 99% of rows selecting the
   same features).  The caches are deleted.
10. Times of the coder slice: each mode at B=128, 4096 and 32768, sliced
    and at a row offset, beside its plain version, its bound and a library
    yardstick (the bf16 encode product, plus the dense decode product in
    ReLU modes), with each launch's device time under ``torch.profiler``
    (ReLU modes: the cast, ``gemm_kernel<4>``, ``gemm_kernel<5>`` and the
    two sums; TopK modes: the cast, the encode ``gemm_kernel<3>``, in Skip
    mode the skip product -- a second ``gemm_kernel<3>``, told apart by
    its place in the call -- ``coder_select_decode_kernel`` and the sum);
    one training step of phase 9's ReLU SAE at batch 128, and of the Skip
    transcoder, the ReLU crosscoder and the TopK crosscoder at batch 4096
    and 32768, wall and device busy time.
11. Whisper-large 32x (D=1280, H=40960, k=32; bench.py:83-112): the
    blocked encode (``ops/csrc/blocked_encode.cu``: per 2048-row chunk,
    the budget's rows at this width, the centre, the kPre GEMM of ``encoder_gemm.cu`` and the CTA select)
    against its plain version at 8192 rows, 4,200 (two full chunks and a
    ragged one) and a ragged 1,000, for f32 and bf16 rows and both latent
    dtypes, at kernel B's bars (>= 99.9% of rows select the same
    features, values on those rows within 1e-2 * max|ref|), with phase
    1's print of each row that selects differently, its gap held to twice
    the row's max |pre_card - pre_plain| (pre_card: the kPre GEMM on the
    same centred rows, the pre the route selects on); its gradients
    against the CPU on 256 rows (rtol 2e-2, on the rows whose selection
    the two agree on); two launches bit-identical; kernel C's CTA-per-row
    form on [1024, 40960] with tie rows, exact.
12. The whisper-large 32x path through the CLI: a synthetic gaussian
    cache of 6 x 8192 rows x 1280 under ``build/chip_smoke/``, a config
    naming ``openai/whisper-large-v3`` with expansion 32, k 32, batch
    8192, AMP, 2 epochs and ``dead_feature_threshold`` 2, trained by
    ``whisper_sae_tpu_torch.train.main`` with the resample set to fire at
    the last epoch's end (the CLI fixes ``resample_dead_every`` at 5000).
    Every counter is zeroed first; the blocked launches and the sparse
    backward's composed launches must equal the 12 steps, kernels A and B
    and the plain versions run no time, the
    resample runs through kernel C's wide form; the loss falls, decoder
    rows are unit norm, parameters finite; the trained SAE's f32 forward
    on 64 rows on the card agrees with the CPU at phase 11's bars.
13. Times at whisper-large 32x: the blocked encode at 8192 rows beside
    its plain version, its bound and the bf16 ``torch.mm`` of the same
    shape, with each of its three launches' device time under
    ``torch.profiler`` (``split_ms``, a call's four chunks) and the
    product's TFLOP/s; kernel C's wide form on [8192, 40960] beside
    ``torch.topk``; the select's passes a row on that pre (it stops at a
    count of exactly k), which both bounds count; one training step at
    batch 8192 under ``torch.profiler``.

14. Encoder kernels at whisper-large-v3 width (D=1280, 20 heads, F=5120,
    T=1500, 128 mels), 16 clips (the CLI run's batch): the conv stem,
    the MLP block (all four output modes), LN+QKV, the
    attention core (T unpadded, and with keys from 1437 masked; also as
    the flash route), the out-projection and the whole attention block,
    each against its plain version at the one-block bar; the attention
    core, LN+QKV, the out-projection and the MLP block bit-identical run
    to run, the last three also at every width of the gate on 16*1500 -
    37 and 100 rows, as in phase 5.
15. Whisper-large-v3 extraction through the CLI (``--extract-only
    --random-whisper``, weights made on the card from the config's seed,
    the synthetic dataset, 16 clips, bf16, the full 32+32-layer forward,
    encoder layers 0 and 31 and decoder layer 31 captured): every
    encoder wrapper's count is zeroed before and read after (the stem
    once a batch, the attention launches and the MLP block once a layer
    and batch, the plain versions no time);
    the caches hold 16*1500 (16) finite rows of 1280 and agree
    with ``extract_activations`` on 2 clips at the stack bar.  Then, on
    those 2 clips, every layer of the fused route is held against the
    card's composed route (torch products, the attention core on its
    flash route) from the same input, at the stack bar.
16. Times at whisper-large-v3: one 8-clip batch of ``extract_activations``
    (bf16, every layer captured, decoder on) on the host clock and under
    ``torch.profiler``, beside its operation bound, with the heaviest
    device operations, the attention and MLP blocks' parts of the busy
    time, the device's idle gaps (their count and total, the longest,
    and the host operations that ran in them) and the
    encoder's and the decoder's part on the host clock; each encoder
    kernel beside its plain version, its bound and a library yardstick,
    the weight preparation, the kernels' parts and the stem's three
    launches as in phase 7.
17. Out of core through the CLI: a cache of 2 shards (65,536 + 32,768
    rows x 384) trained for one epoch at tiny_default.yaml's widths; the
    CLI streams it batch by batch through the prefetching shard loader,
    as the JAX CLI does: every batch trains (one sliced kernel-A launch
    a step, no windowed launch), the resample set is the bounded
    8 x 8192-row subsample, the loss falls.
18. The launcher's coder jobs past the earlier limits, on synthetic
    caches: ``train-crosscoder --expansion-factor 16`` (L=2, D=384,
    S=6144 > 3072; TopK, then ``--relu``; learning rate 1e-2, for ReLU
    1e-3 and 4 epochs) runs every training step on the coder kernel past
    H = 3072 (windowed launches, all counted in ``.wide_launches``, equal
    to the steps; no sliced launch), as the JAX package fuses it, and
    ``train-transcoder`` above ``--max-resident-gb`` streams chunked
    epochs through the paired reader (windowed coder launches equal to
    the steps).  Losses finite and falling, run files written.
19. Transcription and capture.  (a) Whisper-large-v3 at full width, bf16,
    random weights made on the card: ``greedy_decode_cached`` of 8
    synthetic 30 s clips at ``max_len`` 64; the encoder wrappers' counts
    rise by 1 (stem) and 32 (LN+QKV, the core, the out-projection, the
    MLP block) in the call, no plain version runs; each encoder layer
    is held against the composed route's layer from the same input at
    the stack bar, and the final hidden against the f32 route no farther
    than 1.25 x the composed route's error (over 32 layers the two bf16
    routes part by more than a layer's bar); column 0 is
    the start token and a row is all EOS after its first EOS; teacher-
    forced along the cached tokens, the cached steps' logits are held
    against the full-sequence ``decoder_forward`` + ``decoder_logits``: in
    f32 at rtol 1e-4, atol 1e-5; in bf16 each route against the f32
    logits, the cached no farther than 1.25 x the full sequence; and a
    token may differ from the bf16 reference's argmax only where its
    top-1 to top-2 gap is under twice the step's max |d logit|.  Then clips/s, decoded tokens/s, the encoder's and a
    step's ms on the host clock and as device busy time, the idle share
    and the heaviest device operations (``torch.profiler``).  (b)
    Whisper-tiny, f32, through ``python -m whisper_sae_tpu_torch.launch
    transcribe`` (one wav written with ``utils.wavio`` and 15 synthetic
    clips, one batch of 16, ``max_len`` 224); the same weights on the
    CPU decode the same tokens in the f32 mode, a difference allowed
    only where the same gap rule explains it.  (c) The facades:
    ``extract_features_batch`` (bf16) on (a)'s batch at encoder layers 0
    and 31 and decoder layer 31 bit-equal to ``extract_activations``;
    ``logit_lens`` and ``cross_attention_maps`` at whisper-tiny on the
    card against the CPU at the f32 bars (rtol 1e-4; atol 1e-5, the
    maps 1e-6).
20. Kernel A's wide route (``sae_fused_loss_wide_fwd``), taken wherever
    the JAX package fuses past the warp form's D <= 384, H <= 3072; its
    select-and-decode is the group form up to H = 8192 (a warp group a
    row on its own named barrier, persistent CTAs, the next row's pre
    brought in by a bulk copy), past it the CTA-per-row form
    (``_build.wide_form``).  (a) Against its plain
    version at (D, H) = (512, 4096), (768, 6144), (1024, 8192), (384,
    24576) and (768, 3072), k = 32, 4096 rows (whisper-small 8x also at
    128 and at 32768: three chunks), sliced and at a row offset, at
    phase 1's bars with the gap rule, the loss bit-identical run to run;
    at each geometry the library's launch counts show the form the
    dispatch names, once a chunk, and not the other (both forms driven),
    as does the profiler where it sees the kernels;
    gradients at whisper-small 8x against the CPU; at whisper-tiny its
    latent, residual and centred rows equal to the warp form's bit for
    bit.  (b) Whisper-small 8x through the CLI: tiny_default.yaml with
    ``model_name: openai/whisper-small`` (D=768, H=6144, k=32, batch
    128, AMP) on a synthetic 2^16 + 64-row cache, 2 epochs of 512
    windowed steps and a remainder step, the resample forced at the
    last: every step one kernel-A launch on the wide route (windowed,
    and sliced for the remainders), no plain version, the resample's f32
    encode on kernel C's wide form, the loss finite and falling, decoder rows unit
    norm, the trained SAE on 512 rows against the CPU.  (c) At 128,
    4096 and 32768 rows the wide route and the composed route it
    replaces (kernel B's top-k encode, the ``mm_f32`` decode, the loss) in
    turns (composed / wide / wide / composed), each launch's device ms;
    a CLI step at batch 128 and one at 32768.

21. The coder kernel past H = 3072, at every geometry the JAX package
    fuses there (bf16 weights within its 48 MiB): the TopK modes' wide
    route (``wst_coder_wide_fwd``: the cast, in Skip mode the skip product
    over all rows, per chunk of kernel B's rows the kPre encode and the
    select-and-decode, kernel A's forms: ``coder_select_decode_group_kernel``
    up to H = 8192, ``coder_select_decode_wide_kernel`` past it, then the
    sum), the ReLU modes' one route.  (a) Against its plain version at 4096 rows
    the Skip and TopK transcoders at (D, H) = (768, 6144), (1024, 8192)
    and (384, 24576), the TopK and ReLU crosscoders at L*D = 768 and 1536
    with S = 6144, the ReLU SAE at (768, 6144), and the Skip transcoder at
    whisper-small 8x also at 128 and 32768 rows (three chunks); sliced and
    at a row offset, at phase 8's bars with the gap rule, bit-identical
    run to run, the form the dispatch names in the library's launch
    counts (and the profiler's);
    gradients of the five modes at whisper-small 8x against
    the CPU (512 rows; the TopK modes on the rows selecting alike);
    at (384, 3072) in Skip mode and at L*D = 1536, S = 3072 the wide
    route's latent and resid equal to the warp form's bit for bit.  (b)
    ``launch train-transcoder`` at whisper-small 8x (``--model-name
    openai/whisper-small --expansion-factor 8``: D=768, H=6144, k=32,
    batch 4096, 2 epochs at learning rate 1e-2), the Skip transcoder then
    ``--no-skip``, on a synthetic 8 x 4096-row (mlp_in, mlp_out) cache
    (y = tanh(x W)): every step one windowed launch on the wide route, no
    sliced or composed step, no plain version, losses finite and falling;
    the trained Skip transcoder on 512 rows against the CPU.  (d) The
    kernel and the composed route it replaces (the top-k encode or the
    ReLU encode, then ``mm_f32`` products) in turns, composed / kernel /
    kernel / composed, for the Skip transcoder (128, 4096, 32768 rows),
    the TopK transcoder (4096) and the TopK and ReLU crosscoders at L*D =
    768 (4096, 32768), with each launch's device ms; a launcher step of
    the Skip transcoder at batch 4096.

22. The research loop after extraction at whisper-tiny width (D=384,
    H=3072, k=32), every launch count zeroed first: (a) ``launch
    extract`` of 64 synthetic clips, encoder and decoder layer 3; (b)
    ``launch train --all-layers`` (batch 4096, 2 epochs, a checkpoint an
    epoch) in this process -- kernel A's windowed and sliced launches
    equal to its steps -- then the same command under ``--supervise`` in
    its own process, its child killed with SIGKILL once the first epoch's
    checkpoint is on disk (a FIFO at the second's temporary path holds it
    there): the supervisor log shows two attempts, the rerun resumes
    from epoch 1, the final encoder SAE equals the uninterrupted one at
    rtol 1e-3 (bit-equality printed); (c) ``train.py --profile`` for one
    epoch at batch 128 on 4 clips: the trace parses, with events (kernel
    names logged, kernel A's not required); (d) ``launch analyze`` with
    every output (top-k 20, top-n 100, 16 co-activation features, 4
    features' clips, labels, dashboard), its encode (kernel B writing
    f32, as JAX's TPU encode) timed; (e) ``launch causal-validate`` for
    both components (4 clips, 8 swept features; kernel B in the SAE
    patches) and the identity patch's logits bit-equal to the clean
    forward's.  (d) and (e) read the uninterrupted run's SAEs.  Kernels A
    and B launched, no plain version.  Against the CPU (a side process,
    ``research_cpu_child``, beside (b)-(e), with no CUDA context; its SAE
    encode is kernel B's plain version): the first 12,000-row analyze
    chunk's latent (>= 99.9% of rows alike, the rest within the gap rule,
    values on the rest within 1e-5 of the max), the analyze summary's top
    100 features (>= 99 shared, max activations at rtol 1e-5),
    causal-validate with the card's weights (logit KL within 1e-3
    relative + 1e-6, token agreement equal).

23. The top-k encode and mask at every width the JAX package takes: (a)
    kernel B through ``fused_topk_encode`` in each select form past the
    warp select (``_build.select_form``: the group form at whisper-small
    8x, D=768 H=6144; the CTA form at whisper-large 8x, 1280 x 10240; the
    cluster form at whisper-tiny 128x, 384 x 49152), 4096 rows, bf16 and
    f32 out; the blocked encode at whisper-large 64x (1280 x 81920, the
    cluster form, chunks of 1024 rows); each at kernel B's bars with the
    gap rule, two launches bit-identical, the library's select counts by
    form one a chunk in the named form and none in another; kernel C past
    H = 40960 ([4096, 49152], [1024, 81920], [64, 262144]) exact, with
    rows of ties past the compaction's 8192 candidates, all-equal rows and
    the cluster select alone at k = h, bit-identical over two launches;
    the card's clusters at once (``cudaOccupancyMaxActiveClusters``) for
    each cluster size.  (b-c) The
    main path, every count zeroed first: a whisper-tiny 128x TopK SAE
    (k=32, AMP, batch 4096) trained on a synthetic 48 x 4096-row cache
    for 4 epochs as the launcher's ``train`` job trains one (the SAE
    config of both packages refuses an expansion past 32, so the SAE is a
    ``TopKSAE`` of H = 49152 and the job's steps run through the
    library), kernel B once a step and kernel A never; 4 f32 steps
    (kernel C's cluster form once a step); ``TopKSAE.encode`` (kernel B
    writing f32); 3 AMP steps of a whisper-large 64x SAE through the
    trainer (the blocked encode once a step); every kernel of the path
    launched, the selects all in the cluster form, no plain version.  (d)
    Against the CPU: the train job at batch 256 for 8 steps and 4 f32
    steps of each trained SAE, losses at rtol 1e-3; the encode's f32
    latent (>= 99.9% of rows alike, the gap rule, values within 1e-5 of
    the max) and the f32 forward (``eval_against_cpu``); whisper-large
    64x from the same parameters, 3 steps at batch 64, losses at rtol
    1e-3.  (e) A whisper-large 64x step at batch 4096 under the profiler;
    each kernel beside its plain version, its bound (the select's passes
    and compaction on this pre counted, ``ops.topk.cluster_threshold``)
    and a library yardstick (bf16 ``torch.mm``;
    ``torch.topk`` and a scatter for the mask), kernel B at whisper-small
    8x and large 8x in turns with the same rows in calls of 2048 (the
    blocked encode's chunk there before kernel B and the blocked encode
    took one C entry), the group select at whisper-small 8x in turns with
    the CTA select the blocked encode ran there, the blocked encode at
    large 16x in one 4096-row chunk in turns with calls of 2048, the
    cluster select alone on each encode's pre, each launch's device ms at
    tiny 128x and large 64x (kept only where the parts add up to within
    10% of the call).  The ``kernels`` entries ``fused_topk_encode_wide``,
    ``topk_mask_spill`` and ``fused_topk_encode_blocked_spill`` (the
    names of the spill form they first ran; ``select_form`` names the
    cluster form); ``fused_topk_encode`` and
    ``fused_topk_encode_blocked`` carry ``select_forms``, the library's
    counts by form on phases 2-3's and 12's paths.

24. The native shard reader and the single-device API at whisper-tiny
    width (D=384, H=3072, k=32), kernel A's counts zeroed before each part
    of the path: (a) ``runtime/shard_reader.py``'s ``build_native`` (its
    seconds logged; a fallback to the memmap gather fails the phase), 2-shard
    f32 and bf16 caches of 2^17 + 2^16 rows on which the native gather
    equals the memmap one bit for bit (shuffled, repeated and sorted
    indices, ``out=`` too), both timed in GB/s on one shuffled epoch's
    indices in turns; phase 17's CLI run on the f32 cache, its loader's
    reader native, one sliced kernel-A launch a step; a chunked
    out-of-core epoch (``train(loader, fused=True)``, chunks of 2^16
    rows) on the same cache, one windowed launch a step; each of the two
    also on the memmap gather (the CLI after the native run, the epoch
    before it), with the same metrics, or parameters, bit for bit; act/s
    of all four end to end.  (b) A cache written by ``FeatureCache.save`` read back
    bit for bit; 3 epochs of ``train_epochs_fused`` (AMP, batch 128, 256
    steps an epoch) equal to the sequential ``train_epoch_fused`` loop
    bit for bit in parameters, optimizer and dead-feature state and
    metrics, windowed kernel-A launches 3 x 256; each form's wall ms an
    epoch in turns and its host syncs (``torch.cuda.set_sync_debug_mode``).
    (c) ``TopKSAE.encode_sparse`` of the trained SAE on 4096 rows against
    the CPU: idx equal but on rows the gap rule excuses, values within
    1e-5 of the max; ``scatter_topk`` of it equal to ``topk_hidden_dense``
    on rows with no tie at the threshold; ``sparse_decode`` against the
    dense decode at rtol 1e-5.  Kernel A's entries carry ``at_api_slice``.
25. ``parallel/``, the ``(data, model)`` mesh over ``torch.distributed``
    (one card: it measures correctness and the collectives' cost, not
    scaling).  (a) ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 chip_smoke.py --torchrun-cli ...``: the CLI's
    ``main`` under torchrun (NCCL, a 1x1 mesh) on phase 24's whisper-tiny
    8x config over a 2^16-row cache, one epoch; kernel A's launches above
    0; ``metrics.json`` and ``sae_final.npz`` bit for bit those of the same
    CLI run without torchrun (else the losses at AMP rtol 1e-3, logged).
    (b) Two ranks sharing the card (``torch.multiprocessing`` spawn,
    ``file://`` rendezvous, gloo on CUDA tensors: NCCL refuses two ranks on
    one device; every child joined with a timeout), each run against one
    process on the card with the same seed and batches: dp = 2 at
    whisper-tiny 8x (global batch 4096, 8 steps, then a fused epoch of 2^16
    rows; kernel A launched on each rank, losses at rtol 1e-3, parameters
    bit for bit across ranks); tp = 2 at whisper-large 32x (D=1280,
    H=40960, 20,480 a rank, batch 8192, 6 steps: each step's selection,
    the distributed bisection over the model group, against the blocked
    encode on the same step's gathered parameters on >= 99.9% of rows; the
    losses at rtol 1e-3 against the one-process run, whose selection is
    logged as it drifts; b_dec and b_pre bit for bit across ranks; the
    gathered checkpoint loads into one ``TopKSAE``); dp = 2 extraction
    (whisper-tiny bf16, 64 clips in batches of 32: the caches bit for bit
    those of one process, else within the stack bars with the layers
    logged; the encoder kernels launched on each rank).  (c) Each run's ms
    a step and, from CUDA events around every ``all_reduce``, the
    collectives' ms a step and share by caller (the tp run's 32 bisection
    all-reduces ``topk_threshold_sharded``, the recon's ``forward``, the
    gradient ``_flat_all_reduce``; the dp run's ``reduce_gradients``),
    with the card's name and power limit.  Kernel A's and the encoder
    kernels' entries carry ``at_parallel`` launch counts.

26. The real-audio route (``data/librispeech.py``'s ``LibriSpeechDataset``)
    and the ReLU SAE's model-axis form.  (a) A LibriSpeech-shaped stream of
    128 samples made from a seed (speech-like waveforms of
    ``SyntheticSpeechDataset.waveform``, 2-30 s, as RIFF WAV bytes: most 16
    kHz mono, every eighth 44.1 kHz stereo, every sixteenth a file by path,
    one that does not decode) ingested by ``LibriSpeechDataset._ingest``
    with the mels on the card into 256-mel shards, against the same stream
    featurised on the CPU: the same files and meta json (the bad sample
    skipped), the mels within 1e-4 (max abs).  (b) ``launch extract
    --dataset librispeech_asr --random-whisper`` (whisper-tiny, bf16,
    batch 64, encoder and decoder layers 0-3) from that cache, no stream
    opened: the encoder kernels' launch counts, the transcripts and log,
    the 8 caches' metadata, the first batch's first 8 clips held against
    the plain route on the CPU at the stack bar; one 64-clip batch's wall
    ms.  (c) One 16-clip whisper-large-v3 batch through the launcher from a
    ``_mel128`` cache of the first 16 clips that decode (the stem, the
    launch counts at large-v3 width, the first 2 clips against
    ``extract_activations``).  (d) The CLI with ``dataset_name:
    librispeech_asr`` on (a)'s mel cache: ``--extract-only`` of encoder:3,
    then one epoch at whisper-tiny 8x (batch 128, AMP: every full batch a
    windowed kernel-A launch, the remainder a sliced one), its act/s;
    ``causal-validate`` on (b)'s extraction log, which reads the mel cache
    under the working directory's ``cache/`` keyed by ``--num-samples``, as
    the JAX job does.  (e) The ReLU SAE with tp = 2 (two gloo ranks sharing
    the card, as phase 25b) at whisper-large 32x geometry (D=1280,
    H=40960, batch 8192, 6 steps) against one process: losses within 1e-4
    relative, each rank's w_enc [1280, 20480] with its moments, b_dec bit
    for bit, the gathered checkpoint a single-device file; each rank's
    memory held and peak against the replicated run's, ms a step and the
    all-reduces' share.  Kernel A's and the encoder kernels' entries carry
    ``at_real_audio`` launch counts.

Before them, one line lists the rows of phases 1, 8, 11, 20, 21, 22, 23 and 24 that select
differently from the plain version, with their gaps, and one the
decoded tokens of phase 19 that differ from their reference.  The last two lines
are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Scratch files go under ``build/``.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D, H, K = 384, 3072, 32
BATCHES = (128, 4096)
A_WIDE_BATCH = 32768  # kernel A alone: checked and timed, not trained
# kernel A's four launches, by the profiler's kernel names
A_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_kernel<3>",
           "select_decode": "sae_select_decode_kernel", "finalize": "sae_loss_finalize_kernel"}
# the coder's ReLU modes' five launches, by the same names
RELU_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<4>", "decode": "gemm_kernel<5>",
              "hsum": "coder_hsum_kernel", "sum": "coder_sum_kernel"}
# the coder's TopK modes' four launches (five in Skip mode: the skip
# product, a second gemm_kernel<3>, follows the encode)
TOPK_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<3>",
              "select_decode": "coder_select_decode_kernel", "sum": "coder_sum_kernel"}
SKIP_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<3>",
              "skip_product": "gemm_kernel<3>", "select_decode": "coder_select_decode_kernel",
              "sum": "coder_sum_kernel"}
N_ROWS = (1 << 18) + 64
EPOCHS = 3
RANK = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores (also used here for the bisection's int compares), HBM3
PEAK_BF16, PEAK_ALU, PEAK_BYTES = 989e12, 67e12, 3.35e12
SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/sae_kernels.cu"
# kernel B's three launches a chunk (blocked_encode.cu's chunk loop), by the
# profiler's kernel names
B_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_kernel<3>", "select": "topk_mask_kernel"}
NAMES = ("w_enc", "b_enc", "b_pre", "w_dec", "b_dec")
# extraction slice: whisper-tiny width, 64 clips a batch
ENC_B, ENC_T, ENC_D, ENC_HEADS, ENC_F, N_MELS = 64, 1500, 384, 6, 1536, 80
EXTRACT_CLIPS = 128
ENC_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/encoder_kernels.cu"
# exp per second on the special-function units: 132 SMs x 16 a clock x 1.98 GHz
PEAK_SFU = 132 * 16 * 1.98e9
BLOCK_BAR, STACK_BAR = (2.0**-6, 2.0**-9), (2.0**-4, 2.0**-7)
# coder slice: whisper-tiny width, the launcher's batch and bench.py's
CODER_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/coder_kernels.cu"
CODER_BATCHES = (4096, 32768)
CODER_B = CODER_BATCHES[0]
CODER_TIME_BATCHES = (128, *CODER_BATCHES)  # 128: the CLI's ReLU SAE batch (phase 9)
CODER_MODES = {  # mode: (D, dout, k or None for ReLU, skip, y is x)
    "skip_transcoder": (D, D, K, True, False),
    "topk_transcoder": (D, D, K, False, False),
    "relu_sae": (D, D, None, False, True),
    "topk_crosscoder": (4 * D, 4 * D, K, False, True),
    "relu_crosscoder": (4 * D, 4 * D, None, False, True),
}
LAUNCH_CLIPS = 64
# whisper-large 32x (bench.py:83-112): the blocked encode's geometry
DL, HL, BL = 1280, 40960, 8192
LARGE_STEPS, LARGE_EPOCHS = 6, 2
LARGE_CHECK_ROWS = (BL, 4200, 1000)  # 4200: two full chunks of the blocked encode and a ragged one
BLOCKED_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/blocked_encode.cu"
# the blocked encode's three launches a chunk, by the profiler's kernel names
# (at whisper-large 32x the product walks column tiles first)
BLOCKED_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_cols_kernel<3>",
                 "select": "blocked_select_kernel"}
# the step's backward over the selected latents (sae_backward.cu): kernel
# A's route at the training cells' whisper-tiny 8x batch, the composed
# route at whisper-large 32x's; its launches by the profiler's names
BWD_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/sae_backward.cu"
BWD_CELLS = {"tiny8x": (A_WIDE_BATCH, D, H, False), "large32x": (BL, DL, HL, True)}
BWD_PARTS = {part: f"wst_bwd::{part}_kernel" for part in ("mask", "count", "plan", "seg", "tile")}
BWD_LEAVES = ("dw_enc", "db_enc", "dw_dec")
# the conv stem's three launches (the GEMM's conv row order, epilogues 2
# and 6: kGelu, kGeluPos)
STEM_PARTS = {"prep": "stem_prep_kernel", "conv1": "gemm_conv_kernel<2>",
              "conv2": "gemm_conv_kernel<6>"}
ATTN_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/attention_kernel.cu"
GEMM_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/encoder_gemm.cu"
# every width the fused route's gate takes (ops/encoder.py:fused_encoder_supported)
GATE_WIDTHS = (384, 512, 768, 1024, 1280, 1536)
# whisper-large-v3 extraction: bench.py:388-400 times batches of LG_B = 8
# clips; the CLI extracts LG_CLIPS = 16 in one batch (EXTRACT_BATCH is 64),
# and phase 14 holds the kernels against their plain versions at that batch
LV3 = "openai/whisper-large-v3"
LG_B, LG_CLIPS = 8, 16
LG_ENC_LAYERS, LG_DEC_LAYERS = [0, 31], [31]
# phase 20: kernel A's wide route at every geometry the JAX package fuses
# past the warp form (D > 384 or H > 3072), and whisper-small 8x through
# the CLI: 2^16 + 64 rows (512 windowed steps and a 64-row remainder an epoch)
DS, HS = 768, 6144
WIDE_GEOMS = ((512, 4096), (DS, HS), (1024, 8192), (384, 24576), (768, 3072))
WIDE_BATCHES = (128, 4096, 32768)  # whisper-small 8x; the others at 4096
# the wide routes' select-and-decode by form (_build.wide_form: the group
# form up to H = 8192, the CTA-per-row form past it), by the profiler's names
WIDE_SELECT = {"group": "sae_select_decode_group_kernel", "cta": "sae_select_decode_wide_kernel"}
CODER_WIDE_SELECT = {"group": "coder_select_decode_group_kernel",
                     "cta": "coder_select_decode_wide_kernel"}
# the wide route's launches at whisper-small 8x, by the profiler's kernel
# names (the encode and the select-and-decode once a chunk)
WIDE_PARTS = {"centre": "sae_centre_kernel", "encode": "gemm_kernel<3>",
              "select_decode": WIDE_SELECT["group"], "finalize": "sae_loss_finalize_kernel"}
SMALL_ROWS, SMALL_EPOCHS = (1 << 16) + 64, 2
SELECT_SOURCE = "src/whisper_sae_tpu_torch/ops/csrc/select_decode.cuh"
# phase 21: the coder kernel past H = 3072 at every geometry the JAX package
# fuses (the TopK modes' wide route, the ReLU modes' one route): (mode, D,
# dout, H), the crosscoders on their flattened view (L*D = 768: phase 18's;
# 1536: whisper-tiny's four layers)
CODER_WIDE_GEOMS = (
    ("skip_transcoder", DS, DS, HS), ("topk_transcoder", DS, DS, HS),
    ("skip_transcoder", 1024, 1024, 8192), ("topk_transcoder", 1024, 1024, 8192),
    ("skip_transcoder", 384, 384, 24576), ("topk_transcoder", 384, 384, 24576),
    ("topk_crosscoder", DS, DS, HS), ("relu_crosscoder", DS, DS, HS),
    ("topk_crosscoder", 1536, 1536, HS), ("relu_crosscoder", 1536, 1536, HS),
    ("relu_sae", DS, DS, HS))
CODER_WIDE_BATCHES = (128, 4096, 32768)  # the Skip transcoder at whisper-small 8x; the rest at 4096
# timed in turns with the composed route (phase 21d), at whisper-small 8x
CODER_WIDE_TIMED = {"skip_transcoder": (128, 4096, 32768), "topk_transcoder": (4096,),
                    "topk_crosscoder": (4096, 32768), "relu_crosscoder": (4096, 32768)}
# the wide route's launches, by the profiler's kernel names: the cast, in
# Skip mode the skip product over all rows, then the encode and the
# select-and-decode once a chunk, the sum
CODER_WIDE_PARTS = {"cast": "coder_cast_kernel", "encode": "gemm_kernel<3>",
                    "select_decode": CODER_WIDE_SELECT["group"], "sum": "coder_sum_kernel"}
CODER_WIDE_SKIP_PARTS = {"cast": "coder_cast_kernel", "skip_product": "gemm_kernel<3>",
                         "encode": "gemm_kernel<3>", "select_decode": CODER_WIDE_SELECT["group"],
                         "sum": "coder_sum_kernel"}
ENC_REPLACES = {
    "conv_stem": "src/whisper_sae_tpu/ops/pallas_encoder.py:604",
    "ln_qkv": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "self_attention": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "out_proj": "src/whisper_sae_tpu/ops/pallas_encoder.py:340",
    "mlp_block": "src/whisper_sae_tpu/ops/pallas_encoder.py:500",
    "flash_self_attention": "src/whisper_sae_tpu/models/whisper.py:141",
}


class SmokeFailure(RuntimeError):
    pass


# phases 1, 8, 11, 20, 21, 22, 23 and 24: the rows that select differently from the plain version
GAPS: dict[str, list] = {}
# phases 20 and 21: the select-and-decode form each wide geometry launched
FORMS: dict[str, dict] = {"fused_sae_loss": {}, "coder": {}}
# phase 19: the decoded tokens that differ from their reference
TOKEN_GAPS: dict[str, list] = {}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, tc_flops: float, alu_ops: float) -> tuple[float, str]:
    """Least time (ms): bytes at the memory rate vs operations at their peak."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16, alu_ops / PEAK_ALU)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def enc_bound(nbytes: float, tc_flops: float, exps: float = 0.0) -> tuple[float, str]:
    """Least time (ms) of an encoder kernel: bytes vs bf16 tensor-core
    operations and, for the attention core, exps on the SFUs."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16, exps / PEAK_SFU)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bar_check(got: torch.Tensor, want: torch.Tensor, bar: tuple[float, float], what: str) -> float:
    """max|d| <= bar[0] * max|ref| and mean|d| <= bar[1] * mean|ref|;
    returns max|d|."""
    g, w = got.float(), want.float().to(got.device)
    check(tuple(g.shape) == tuple(w.shape), f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    mx, mn = rel_err(g, w)
    check(mx <= bar[0] and mn <= bar[1],
          f"{what}: max rel {mx:.3g}, mean rel {mn:.3g} above the bar {bar}")
    return float((g - w).abs().max())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|d| / max|ref|, mean|d| / mean|ref|)."""
    d = (got.float() - want.float()).abs()
    return float(d.max() / want.float().abs().max()), float(d.mean() / want.float().abs().mean())


def params(seed: int, dev, d: int = D, h: int = H) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    p = {
        "w_enc": torch.randn(d, h, generator=g) * 0.05,
        "b_enc": torch.randn(h, generator=g) * 0.05,
        "b_pre": torch.randn(d, generator=g) * 0.05,
        "w_dec": torch.randn(h, d, generator=g) * 0.05,
        "b_dec": torch.randn(d, generator=g) * 0.05,
    }
    return {k: v.to(dev) for k, v in p.items()}


def agree(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows whose selections match."""
    return ((a > 0) == (b > 0)).all(dim=1)


def card_pre(xc, we_t, b_enc, what: str) -> torch.Tensor:
    """The encode GEMM's kPre epilogue on the card, f32 [rows, H] =
    xc . we_t^T + b_enc; fails if it does not launch."""
    from whisper_sae_tpu_torch.ops import _build

    rows, d = xc.shape
    pre = torch.empty(rows, we_t.shape[0], device=xc.device)
    check(_build.load_library().wst_enc_gemm_fwd(
        3, xc.data_ptr(), we_t.data_ptr(), rows, we_t.shape[0], d, b_enc.data_ptr(), 1.0, 0,
        pre.data_ptr(), None, None, None, torch.cuda.current_stream().cuda_stream) == 0,
        f"{what}: the kPre GEMM did not launch")
    return pre


def selection_gaps(xc, we_t, b_enc, got_hid, want_hid, k: int, what: str) -> list:
    """Each row whose selection differs from the plain version, with the
    plain pre's gap between its k-th and (k+1)-th values, its k-th value
    and the row's max |pre_card - pre_plain| (pre_card: the encode GEMM's
    kPre epilogue on the same bf16 rows, which gives the same bits every
    launch: the pre that kernel A, the coder's TopK modes and the blocked
    encode select on).  Two features can swap across the boundary only if
    the gap is at most the two versions' difference on both, and a
    selected value can change sign only if it is within it of 0, so the
    gap (or the k-th value) is held to twice the row's difference.  Fails
    on any wider gap: the kernel, not the sum order, would be at fault."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    bad = (~agree(got_hid, want_hid)).nonzero().flatten()
    if bad.numel() == 0:
        return []
    pre_card = card_pre(xc, we_t, b_enc, what)
    return gap_rule(bad, pre_card[bad], (mm_f32(xc, we_t.t()) + b_enc)[bad], k, what)


def gap_rule(bad, pre_card, pre_plain, k: int, what: str) -> list:
    """:func:`selection_gaps`' rule on the rows ``bad`` that select
    differently, given both versions' pre of those rows."""
    top = torch.topk(pre_plain, k + 1, dim=1).values
    gap, kth = top[:, k - 1] - top[:, k], top[:, k - 1]
    diff = (pre_card - pre_plain).abs().max(dim=1).values
    out = []
    for r, g, v, df in zip(bad.tolist(), gap.tolist(), kth.tolist(), diff.tolist()):
        log(f"    {what}: row {r} selects differently: gap {g:.4g} (k-th value {v:.4g}), "
            f"max|pre_card - pre_plain| {df:.4g}")
        check(g <= 2 * df or abs(v) <= 2 * df,
              f"{what}: row {r}'s gap {g:.4g} is wider than the sum order explains ({2 * df:.4g})")
        out.append({"row": r, "gap": g, "kth": v, "max_pre_diff": df})
    return out


def explain_disagreement(what: str, got_hid, want_hid, card_xc, plain_xc, we_t, b_enc,
                         relaunch) -> None:
    """Logs, for a check about to fail on fewer than 99.9% of rows
    agreeing, what tells a fault of the kernel from one of its inputs or
    of the card: the rows that differ; the card latent's non-finite and
    all-zero rows; whether the card's centred rows equal the plain
    version's; the max |pre_card - pre_plain| over all rows (pre_card: the
    kPre GEMM on the card's centred rows); whether one relaunch on the same
    inputs gives the same bits."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    bad = int((~agree(got_hid, want_hid)).sum())
    g = got_hid.float()
    nonfinite = int((~torch.isfinite(g)).any(dim=1).sum())
    zero = int((g == 0).all(dim=1).sum())
    rows = card_xc.shape[0]
    pre_card = card_pre(card_xc, we_t, b_enc, what)
    pre_diff = float((pre_card - (mm_f32(plain_xc, we_t.t()) + b_enc)).abs().max())
    again = relaunch()
    torch.cuda.synchronize()
    log(f"    {what}: {bad} of {rows} rows select differently; the card latent has "
        f"{nonfinite} non-finite and {zero} all-zero rows; card xc == plain xc: "
        f"{torch.equal(card_xc, plain_xc)}; max |pre_card - pre_plain| {pre_diff:.4g}; "
        f"a relaunch gives the same bits: "
        f"{torch.equal(again, got_hid)}")


def grads_close(fn, p, cpu_fn, names, what: str) -> None:
    """Gradients of ``fn`` on the card vs the same Function on the CPU
    (plain forward), rtol 2e-2 (bf16 products, other sum order)."""
    out = {}
    for key, f, src in (("card", fn, p), ("cpu", cpu_fn, {k: v.cpu() for k, v in p.items()})):
        q = {k: v.clone().requires_grad_(True) for k, v in src.items()}
        f(q).backward()
        out[key] = {n: q[n].grad for n in names}
    for n in names:
        want = out["cpu"][n]
        err = float((out["card"][n].cpu() - want).abs().max())
        tol = 2e-2 * float(want.abs().max())
        check(torch.allclose(out["card"][n].cpu(), want, rtol=2e-2, atol=tol),
              f"{what}: d{n} differs from the plain version (max abs {err:.3g} > {tol:.3g})")


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernel_a(cuda_sae, b: int, p: dict, x, buf, errs: dict, wide: bool = False
                   ) -> torch.Tensor:
    """Kernel A (its warp form, or with ``wide`` its wide route) against
    its plain version at ``b`` rows, sliced and at a row offset into an
    epoch buffer; two launches give the same bits.  Returns the sliced
    call's bf16 latent."""
    we_t = cuda_sae._bf16_t(p["w_enc"])
    wd = p["w_dec"].bfloat16()
    b_out = p["b_dec"] + p["b_pre"]
    tag = f"_wide D={we_t.shape[1]} H={we_t.shape[0]}" if wide else ""
    for name, data, off in (("fused_sae_loss", x, 0), ("fused_sae_loss_indexed", buf, b)):
        what = name + tag
        launch = lambda: cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"],  # noqa: E731
                                                     p["b_pre"], wd, b_out, K, wide)
        got = launch()
        want = cuda_sae.fused_sae_loss_plain(data[off:off + b], we_t, p["b_enc"], p["b_pre"],
                                             wd, b_out, K)
        torch.cuda.synchronize()
        ok = agree(got[3], want[3])
        share = float(ok.float().mean())
        if share < 0.999:
            explain_disagreement(f"{what} B={b}", got[3], want[3], got[5], want[5], we_t,
                                 p["b_enc"], lambda: launch()[3])
        check(share >= 0.999, f"{what} B={b}: selection agrees on {share:.4%} of rows")
        GAPS[f"{what} B={b}"] = selection_gaps(got[5], we_t, p["b_enc"], got[3], want[3], K,
                                               f"{what} B={b}")
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        check(rel <= 1e-4, f"{what} B={b}: loss rel err {rel:.3g} > 1e-4")
        hk, hp = got[3][ok] > 0, want[3][ok] > 0
        check(int(hk.sum()) == int(hp.sum()), f"{what} B={b}: l0 differs on agreeing rows")
        check(torch.equal(hk.any(0), hp.any(0)), f"{what} B={b}: active differs on agreeing rows")
        if bool(ok.all()):
            check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
                  f"{what} B={b}: l0/active outputs differ")
        check(torch.equal(got[5], want[5]), f"{what} B={b}: centred rows differ")
        hid_err = float((got[3][ok].float() - want[3][ok].float()).abs().max())
        check(hid_err <= 1e-2 * float(want[3].float().abs().max()),
              f"{what} B={b}: latent off by {hid_err:.3g}")
        key = name + ("_wide" if wide else "")
        errs[key] = max(errs.get(key, 0.0), float((got[4][ok] - want[4][ok]).abs().max()))
        log(f"  {what:24s} B={b:5d}: rows agreeing {share:.4%}, loss {float(got[0]):.7g} "
            f"vs plain {float(want[0]):.7g}, l0 {float(got[1]):.3f}")
        if off == 0:
            hid = got[3]
    a = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    a2 = cuda_sae.fused_sae_loss(x, *(p[n] for n in NAMES), K)
    check(all(torch.equal(u, v) for u, v in zip(a, a2)),
          f"kernel A{tag} B={b}: loss not bit-identical")
    return hid


def check_kernel_b(cuda_sae, lib, b: int, p: dict, x, hid_a, errs: dict) -> None:
    """Kernel B (the centre, the kPre GEMM, the warp select, chunk by
    chunk), called through its entry point ``fused_topk_encode``, against
    its plain version at ``b`` rows, bf16 and f32 latent: one launch of
    kernel B and none of the blocked encode a call; >= 99.9% of rows
    select the same features, values on those rows within 1e-2 * max,
    every differing row through the gap check; the bf16 latent equal to
    kernel A's on the same rows (``hid_a``), bit for bit; a second launch
    (``_topk_encode_launch``) gives the same bits."""
    we_t = cuda_sae._bf16_t(p["w_enc"])
    args = (we_t, p["b_enc"], p["b_pre"], K)
    plain_xc = (x.float() - p["b_pre"]).bfloat16()
    enc = cuda_sae.fused_topk_encode
    for out_dtype in (torch.bfloat16, torch.float32):
        what = f"fused_topk_encode B={b} -> {str(out_dtype)[6:]}"
        before = (enc.launches, enc.blocked_launches)
        got = enc(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
        check((enc.launches, enc.blocked_launches) == (before[0] + 1, before[1]),
              f"{what}: the entry point did not launch kernel B once")
        want = cuda_sae.topk_encode_plain(x, *args, out_dtype)
        torch.cuda.synchronize()
        check(got.dtype == out_dtype and got.shape == (b, H), f"{what}: output")
        ok = agree(got, want)
        share = float(ok.float().mean())
        if share < 0.999:
            card_xc = torch.empty_like(plain_xc)
            check(lib.wst_sae_centre_fwd(x.data_ptr(), int(x.dtype == torch.bfloat16), 0, b, D,
                                         p["b_pre"].data_ptr(), card_xc.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream) == 0,
                  f"{what}: the centre did not launch")
            explain_disagreement(what, got, want, card_xc, plain_xc, we_t, p["b_enc"],
                                 lambda: cuda_sae._topk_encode_launch(x, *args, out_dtype))
        check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
        err = float((got[ok].float() - want[ok].float()).abs().max())
        check(err <= 1e-2 * float(want.float().abs().max()), f"{what}: values off by {err:.3g}")
        errs["fused_topk_encode"] = max(errs.get("fused_topk_encode", 0.0), err)
        GAPS[what] = selection_gaps(plain_xc, we_t, p["b_enc"], got, want, K, what)
        if out_dtype == torch.bfloat16:
            check(torch.equal(got, hid_a), f"{what}: the latent differs from kernel A's")
        check(torch.equal(got, cuda_sae._topk_encode_launch(x, *args, out_dtype)),
              f"{what}: two launches differ")
        log(f"  {what:30s}: rows agreeing {share:.4%}, max abs err {err:.3g}; "
            + ("equal to kernel A's latent, " if out_dtype == torch.bfloat16 else "")
            + "two launches bit-identical")
        del got, want


def kernel_phase(dev, cuda_sae, cuda_topk, topk, lib) -> dict:
    errs: dict[str, float] = {}
    for b in BATCHES:
        p = params(b, dev)
        gen = torch.Generator().manual_seed(b + 1)
        x = torch.randn(b, D, generator=gen).to(dev)
        buf = torch.randn(3 * b, D, generator=gen).to(dev)
        check_kernel_b(cuda_sae, lib, b, p, x, check_kernel_a(cuda_sae, b, p, x, buf, errs), errs)

        # kernel C, exact
        pre = torch.randn(b, H, generator=gen).to(dev)
        pre[:4] = torch.round(pre[:4] * 2) / 2
        got, want = cuda_topk.topk_mask_fwd(pre, K), topk.topk_mask_plain(pre, K)
        check(torch.equal(got, want), f"topk_mask B={b}: differs from the plain version")
        errs["topk_mask"] = 0.0
        log(f"  topk_mask B={b:5d}: equal to the plain version")

        # gradients through each autograd.Function
        if b == BATCHES[-1]:
            grads_close(lambda q: cuda_sae.fused_sae_loss(x, *(q[n] for n in NAMES), K)[0], p,
                        lambda q: cuda_sae.fused_sae_loss(x.cpu(), *(q[n] for n in NAMES), K)[0],
                        NAMES, "fused_sae_loss")
            grads_close(lambda q: cuda_sae.fused_sae_loss_indexed(buf, 1, *(q[n] for n in NAMES), K, b)[0],
                        p, lambda q: cuda_sae.fused_sae_loss_indexed(
                            buf.cpu(), 1, *(q[n] for n in NAMES), K, b)[0],
                        NAMES, "fused_sae_loss_indexed")
            g = torch.randn(b, H, generator=gen)
            grads_close(lambda q: (cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                              torch.float32) * g.to(dev)).sum(), p,
                        lambda q: (cuda_sae.fused_topk_encode(x.cpu(), q["w_enc"], q["b_enc"],
                                                              q["b_pre"], K, torch.float32) * g).sum(),
                        ("w_enc", "b_enc", "b_pre"), "fused_topk_encode")
            pc = pre.clone().requires_grad_(True)
            cuda_topk.topk_mask(pc, K).backward(g.to(dev))
            check(torch.equal(pc.grad, torch.where(want > 0, g.to(dev), 0.0)), "topk_mask: gradient")
            log(f"  gradients B={b}: agree (rtol 2e-2)")
    b = A_WIDE_BATCH
    gen = torch.Generator().manual_seed(b + 1)
    p, x = params(b, dev), torch.randn(b, D, generator=gen).to(dev)
    hid_a = check_kernel_a(cuda_sae, b, p, x, torch.randn(3 * b, D, generator=gen).to(dev), errs)
    check_kernel_b(cuda_sae, lib, b, p, x, hid_a, errs)
    signed_zeros(cuda_topk, topk, dev)
    return errs


def signed_zeros(cuda_topk, topk, dev) -> None:
    """Kernel C's warp and wide forms on rows where -0.0 is selected (few
    positives, the rest +0.0 and -0.0; one row all -0.0): logs how many
    -0.0 their latents hold.  The plain version gives +0.0 there, as
    ``jax.nn.relu`` does; fails if a form's latent differs from it other
    than in that sign."""
    for h in (H, 4160):
        g = torch.Generator().manual_seed(h)
        pre = torch.where(torch.rand(8, h, generator=g) < 0.5, 0.0, -0.0)
        pre[:, torch.randperm(h, generator=g)[:20]] = 1.0
        pre[1] = -0.0
        pre = pre.to(dev)
        got, want = cuda_topk.topk_mask_fwd(pre, K), topk.topk_mask_plain(pre, K)
        check(torch.equal(got, want), f"topk_mask H={h}: signed-zero rows differ")
        neg = int(((got == 0) & torch.signbit(got)).sum())
        check(not bool(torch.signbit(want).any()), "topk_mask_plain gives -0.0")
        log(f"  topk_mask H={h} ({'wide' if h > H else 'warp'} form) on signed-zero rows: "
            f"{neg} -0.0 in the kernel's latent, 0 in the plain version's")


# ---------------------------------------------------------------------------
# phases 2-3: the main path through the CLI, then eval
# ---------------------------------------------------------------------------


def gaussian_rows(n: int, gen: torch.Generator, mix: torch.Tensor) -> torch.Tensor:
    """Gaussian rows whose covariance is mostly of rank ``RANK`` (plus
    isotropic noise), so a k=32 SAE has structure to find."""
    z = torch.randn(n, RANK, generator=gen, device=mix.device)
    return z @ mix + 0.1 * torch.randn(n, mix.shape[1], generator=gen, device=mix.device)


def write_cache(work: Path, dev, cfg_mod, cache_mod) -> torch.Tensor:
    """Write the training cache; returns the mixing matrix for held-out rows."""
    cfg = cfg_mod.ExperimentConfig.from_yaml(ROOT / "configs" / "tiny_default.yaml")
    cache = cache_mod.FeatureCache(work / "cache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    for start in range(0, N_ROWS, 1 << 16):
        writer.append(gaussian_rows(min(1 << 16, N_ROWS - start), gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=N_ROWS // 1500)
    check(meta.num_tokens == N_ROWS and meta.hidden_dim == D, "cache metadata")
    return mix


def write_config(work: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check((cfg["sae"]["k"], cfg["sae"]["expansion_factor"], cfg["training"]["batch_size"],
           cfg["training"]["use_amp"]) == (K, H // D, 128, True), "tiny_default.yaml widths changed")
    cfg["training"].update(epochs=EPOCHS, warmup_steps=200)
    cfg["sae"]["dead_feature_threshold"] = 2
    cfg["data"]["cache_dir"] = str(work / "cache")
    cfg["output_dir"] = str(work / "out")
    path = work / "tiny_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def main_path(work: Path, dev, mix: torch.Tensor, train_mod, sae_mod):
    """Train through the CLI's ``main``, check what it wrote, then eval the
    trained SAE on held-out rows; returns (trainer, sae, held-out rows)."""
    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(write_config(work)), "--layer", "encoder:0",
                                 "--no-wandb"]).values()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    run_dir = trainer.run_dir
    steps_per_epoch = N_ROWS // 128 + 1
    rows = json.loads((run_dir / "metrics.json").read_text())
    check(len(rows) == EPOCHS * steps_per_epoch, f"metrics.json has {len(rows)} rows")
    check(all(set(r) == {"step", "loss", "reconstruction_loss", "sparsity_loss", "l0",
                         "dead_feature_ratio", "learning_rate"} for r in rows), "metrics.json keys")
    losses = np.array([r["loss"] for r in rows])
    check(bool(np.isfinite(losses).all()), "non-finite loss")
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    check(last < 0.8 * first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    check(trainer.num_resampled_total > 0, "no dead-feature resample fired")
    with np.load(run_dir / "sae_final.npz") as z:
        norms = np.linalg.norm(z["w_dec"], axis=1)
        check(z["w_enc"].shape == (D, H), "sae_final.npz shapes")
    check(bool(np.allclose(norms, 1.0, rtol=1e-5)), "decoder rows are not unit norm")
    check((run_dir / "sae_final.pt").exists(), "sae_final.pt missing")
    log(f"  trained {len(rows)} steps in {train_s:.1f} s: loss {first:.5f} -> {last:.5f}, "
        f"resampled {trainer.num_resampled_total} features, "
        f"{EPOCHS * N_ROWS / train_s:,.0f} act/s end to end (cache load and setup included)")

    # eval on held-out rows through the trained SAE
    sae = sae_mod.load_trained_sae(run_dir).eval()
    x = gaussian_rows(8192, torch.Generator(device=dev).manual_seed(99), mix)
    with torch.no_grad():
        out_bf16, active = sae_mod.topk_sae_apply(sae.params, x, K, torch.bfloat16)
        out_f32 = sae(x)
    for name, out in (("bf16", out_bf16), ("f32", out_f32)):
        check(out.hidden.shape == (8192, H) and out.reconstructed.shape == (8192, D),
              f"eval {name}: shapes")
        check(bool(torch.isfinite(out.reconstructed).all()), f"eval {name}: non-finite")
        check(0 < float(out.l0) <= K + 1e-3, f"eval {name}: l0 {float(out.l0)}")
    rel = abs(float(out_bf16.loss) - float(out_f32.loss)) / float(out_f32.loss)
    check(rel < 2e-2, f"eval: bf16 and f32 losses differ by {rel:.3g}")
    log(f"  eval on 8192 held-out rows (right after the resample): loss bf16 "
        f"{float(out_bf16.loss):.5f} / f32 {float(out_f32.loss):.5f}, l0 {float(out_f32.l0):.2f}, "
        f"{int(active.sum())} features active")
    return trainer, sae, x


def eval_against_cpu(sae, x: torch.Tensor, sae_mod) -> None:
    """The trained SAE's f32 forward on the card against the same SAE on
    the CPU (plain versions) on 512 held-out rows: >= 99% of rows select
    the same features, loss at rtol 1e-3."""
    cpu_params = {k: v.detach().cpu() for k, v in sae.params.items()}
    ref, _ = sae_mod.topk_sae_apply(cpu_params, x[:512].cpu(), K, torch.float32)
    with torch.no_grad():
        card, _ = sae_mod.topk_sae_apply(sae.params, x[:512], K, torch.float32)
    share = float(agree(card.hidden.cpu(), ref.hidden).float().mean())
    rel = abs(float(card.loss) - float(ref.loss)) / float(ref.loss)
    check(share >= 0.99 and rel < 1e-3,
          f"eval: card vs CPU on 512 rows: {share:.2%} rows agree, loss rel err {rel:.3g}")
    log(f"  trained SAE on 512 rows, card vs CPU: {share:.2%} rows agree, loss rel err {rel:.2g}")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def step_profile(trainer, rows, steps: int) -> dict:
    """Where a training step's time goes: ``steps`` fused-epoch steps of
    ``trainer`` over ``rows`` (a tensor or an (x, y) pair on the card),
    timed on the host clock without the profiler, then once under
    ``torch.profiler`` for the device's busy time per step and its
    heaviest operations."""
    from torch.profiler import ProfilerActivity, profile

    b = trainer.config.batch_size
    trainer.train_epoch_fused(rows, shuffle=False)  # warm
    t0 = time.perf_counter()
    trainer.train_epoch_fused(rows, shuffle=False)  # ends with its one metrics fetch
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_fused(rows, shuffle=False)
    kernels = device_ops(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"  step at batch {b}: {wall_ms:.3f} ms wall ({b / wall_ms * 1e3:,.0f} act/s)")
    res = {"batch": b, "wall_ms": wall_ms, "busy_ms": busy_ms if busy_ms > 0 else None}
    if busy_ms <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    res["idle_share"] = max(0.0, 1 - busy_ms / wall_ms)
    log(f"  device busy {busy_ms:.3f} ms per step (profiled run), idle share "
        f"{res['idle_share']:.1%} of the unprofiled step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / steps:8.4f} ms/step  {e.count // steps:3d}x  "
            f"{e.key[:90]}")
    return res


def launch_split(fn, parts: dict, calls: int = 10) -> dict:
    """Device ms a call of each kernel of ``parts`` (part: profiler name,
    in the order a call of ``fn`` launches them: kernel A's four, the
    coder's five or four, a chunked route's three a chunk): the device
    time of every launch of it that ``torch.profiler`` saw over ``calls``
    calls, summed and divided by ``calls`` (None where it saw no device
    time).  Where parts share
    a name (the Skip mode's encode and skip product, both gemm_kernel<3>),
    the n-th launch of that name in a call, in time order, is the n-th of
    those parts (the last of them for any later one: the wide route's
    encodes a chunk); a call ends with the last part's launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    us = dict.fromkeys(parts, 0.0)
    last = list(parts.values())[-1]
    seen: dict = {}
    for e in kernels:
        hits = [part for part, kname in parts.items() if kname in e.name]
        if hits:
            kname = parts[hits[0]]
            n = seen.get(kname, 0)
            seen[kname] = n + 1
            us[hits[min(n, len(hits) - 1)]] += e.time_range.elapsed_us()
            if kname == last:
                seen.clear()
    return {part: us[part] / 1e3 / calls if us[part] > 0 else None for part in parts}


def check_select_form(fn, names: dict, counter: str, h: int, rows: int, what: str,
                      calls: int = 3) -> str:
    """The wide route's select-and-decode form that ``calls`` calls of
    ``fn`` (at width ``h``, ``rows`` rows) launch.  The library counts
    each launch where it makes it (its function ``counter``, of the form:
    0 the group form, 1 the CTA-per-row form): once a chunk a call in the form
    ``_build.wide_form(h)`` names, none in the other.  The profiler, by
    the kernel names (``names``: form -> name), must see that form's
    kernel only, at most once a chunk a call.  ``torch.profiler`` now and
    then misses every kernel of a window (PERF.md §7), so a window where
    it saw no select-and-decode is profiled again, once, and a second
    empty window is logged; the library's counts hold either way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_sae_tpu_torch.ops import _build

    forms = tuple(names)
    count = getattr(_build.load_library(), counter)
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        before = [count(i) for i in range(len(forms))]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        made = {form: count(i) - before[i] for i, form in enumerate(forms)}
        seen = {form: sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and name in e.key)
                for form, name in names.items()}
        if any(seen.values()):
            break
    form = _build.wide_form(h)
    chunks = -(-rows // _build.topk_encode_chunk_rows(h))
    check(made == {f: calls * chunks if f == form else 0 for f in forms},
          f"{what}: select-and-decode launches made {made} over {calls} calls, the dispatch "
          f"names {form} ({chunks} a call)")
    if any(seen.values()):
        check(1 <= seen[form] <= calls * chunks and sum(seen.values()) == seen[form],
              f"{what}: the profiler saw select-and-decode launches {seen} over {calls} calls, "
              f"the dispatch names {form} ({chunks} a call)")
    else:
        log(f"  {what}: the profiler saw no kernel in two windows (PERF.md §7); "
            f"the library made {made}")
    return form


def times(dev, cuda_sae, cuda_topk, topk) -> dict:
    from whisper_sae_tpu_torch.ops import _build

    res: dict = {}
    chunk_b = _build.load_library().wst_sae_topk_encode_chunk_rows(H)
    for b in (*BATCHES, A_WIDE_BATCH):
        p = params(7, dev)
        x = torch.randn(b, D, generator=torch.Generator().manual_seed(8)).to(dev)
        buf = torch.cat([torch.randn_like(x), x, torch.randn_like(x)])
        we_t = cuda_sae._bf16_t(p["w_enc"])
        wd, b_out = p["w_dec"].bfloat16(), p["b_dec"] + p["b_pre"]
        xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
        _, _, active, hid, _, _ = cuda_sae._fused_loss_launch(x, 0, b, we_t, p["b_enc"], p["b_pre"],
                                                              wd, b_out, K)
        nnz, n_active = int((hid > 0).sum()), int(active.sum())
        lib_gemm = time_ms(lambda: torch.matmul(xc, w_bf))

        # A: x, W_enc^T, W_dec rows this batch selects, biases in; latent,
        # residual, centred rows, counts out
        a_bytes = (b * D * 4 + D * H * 2 + n_active * D * 2 + (H + 2 * D) * 4
                   + b * H * 2 + b * D * 4 + b * D * 2 + (H + 1) * 4)
        a_bound = bound(a_bytes, 2 * b * D * H + 2 * nnz * D, 32 * b * H)
        a_plain = time_ms(lambda: cuda_sae.fused_sae_loss_plain(x, we_t, p["b_enc"], p["b_pre"], wd,
                                                                b_out, K), iters=5, warmup=1)
        # sliced, and at a row offset into a 3-batch epoch buffer
        for name, data, off in (("fused_sae_loss", x, 0), ("fused_sae_loss_indexed", buf, b)):
            launch = lambda: cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"],  # noqa: E731
                                                         p["b_pre"], wd, b_out, K)
            a_ms = time_ms(launch)
            res[(name, b)] = (a_ms, a_plain, *a_bound, lib_gemm)
            res[("split", name, b)] = split = launch_split(launch, A_PARTS)
            log(f"  {name:24s} B={b:5d}: launches in ms: "
                + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                            for k_, v in split.items()))

        # B: x, W_enc^T and the biases in, the bf16 latent out
        b_bytes = b * D * 4 + D * H * 2 + (H + D) * 4 + b * H * 2
        b_bound = bound(b_bytes, 2 * b * D * H, 32 * b * H)
        launch = lambda: cuda_sae._topk_encode_launch(x, we_t, p["b_enc"], p["b_pre"], K,  # noqa: E731
                                                      torch.bfloat16)
        b_ms = time_ms(launch)
        b_plain = time_ms(lambda: cuda_sae.topk_encode_plain(x, we_t, p["b_enc"], p["b_pre"], K,
                                                             torch.bfloat16), iters=5, warmup=1)
        res[("fused_topk_encode", b)] = (b_ms, b_plain, *b_bound, lib_gemm)
        # each part's device ms a call, over the launches of all its chunks
        res[("split", "fused_topk_encode", b)] = split = launch_split(launch, B_PARTS)
        log(f"  {'fused_topk_encode':24s} B={b:5d} ({-(-b // chunk_b)} chunks): device ms a call: "
            + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                        for k_, v in split.items()))
        if b not in BATCHES:
            continue

        pre = (torch.matmul(xc.float(), w_bf.float()) + p["b_enc"]).contiguous()
        c_bound = bound(2 * b * H * 4, 0, 32 * b * H)
        c_ms = time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K))
        c_plain = time_ms(lambda: topk.topk_mask_plain(pre, K), iters=5, warmup=1)
        c_lib = time_ms(lambda: torch.topk(pre, K))
        res[("topk_mask", b)] = (c_ms, c_plain, *c_bound, c_lib)
    return res


def backward_inputs(cuda_sae, rows: int, d: int, h: int, composed: bool, dev) -> tuple:
    """(hid, d_recon, xc, bf16 W_dec) of the route's forward on gaussian
    rows: kernel A's latent, residual and centred rows; or the top-k
    encode's latent and the ``mm_f32`` decode's residual (the composed
    loss's)."""
    p = params(rows + 1, dev, d, h)
    x = torch.randn(rows, d, generator=torch.Generator().manual_seed(rows + 2)).to(dev)
    we_t, wd_bf = cuda_sae._bf16_t(p["w_enc"]), p["w_dec"].bfloat16()
    if composed:
        hid = cuda_sae._topk_encode_launch(x, we_t, p["b_enc"], p["b_pre"], K, torch.bfloat16)
        resid = cuda_sae.mm_f32(hid, wd_bf) + p["b_dec"] + p["b_pre"] - x
        return hid, resid * (2.0 / resid.numel()), (x - p["b_pre"]).bfloat16(), wd_bf
    _, _, _, hid, resid, xc = cuda_sae._fused_loss_launch(
        x, 0, rows, we_t, p["b_enc"], p["b_pre"], wd_bf, p["b_dec"] + p["b_pre"], K)
    return hid, (resid * (2.0 / resid.numel())).bfloat16(), xc, wd_bf


def exact_backward_inputs(hid, d_recon, xc, wd_bf, seed: int) -> tuple:
    """The same selection with values on which every f32 sum of the
    backward is exact in any order: the latent in {1/4, .., 1}, xc and
    W_dec in {-1/4, .., 1/4} and d_recon on 8 columns a row, in steps of
    1/8 (|dpre| <= 1/2 in steps of 2^-6, bf16-exact; every sum under 2^22
    steps)."""
    g = torch.Generator(device=hid.device).manual_seed(seed)

    def eighths(*shape):
        return torch.randint(-2, 3, shape, generator=g, device=hid.device).float() * 0.125

    rows, d = xc.shape
    vals = ((hid.float() * 64).floor() % 4 + 1) * 0.25
    hid_e = torch.where(hid > 0, vals, 0.0).bfloat16()
    cols = torch.rand(rows, d, generator=g, device=hid.device).topk(8, dim=1).indices
    drec = torch.zeros(rows, d, device=hid.device).scatter_(1, cols, eighths(rows, 8))
    return (hid_e, drec.to(d_recon.dtype), eighths(rows, d).bfloat16(),
            eighths(*wd_bf.shape).bfloat16())


def backward_phase(dev, cuda_sae) -> dict:
    """Phase 1b: the step's backward over the selected latents
    (``sae_topk_backward``) at the training cells' shapes, each on its
    route, against its plain version and the dense ``mm_f32`` products it
    replaced: bit for bit on exact inputs; on the route's own forward
    within one bf16 step where dpre or the sum is rounded to bf16, else
    at 1e-5 of the leaf's max; two calls bit-identical.  Then its time
    beside the plain version's, the bytes bound and the dense products',
    and each launch's device ms."""
    res = {}
    for cell, (rows, d, h, composed) in BWD_CELLS.items():
        args = backward_inputs(cuda_sae, rows, d, h, composed, dev)
        entry = lambda: cuda_sae.sae_topk_backward(*args, composed)  # noqa: E731
        plain = lambda: cuda_sae.sae_topk_backward_plain(*args, composed)  # noqa: E731
        dense = lambda: cuda_sae._dense_topk_backward(*args, composed)  # noqa: E731
        route = "the composed route" if composed else "kernel A's route"
        what = f"sae_topk_backward {cell} ({rows}, {d}, {h}), {route}"
        exact = exact_backward_inputs(*args, seed=rows)
        got = cuda_sae.sae_topk_backward(*exact, composed)
        refs = {"plain": cuda_sae.sae_topk_backward_plain(*exact, composed),
                "dense": cuda_sae._dense_topk_backward(*exact, composed)}
        for ref, want in refs.items():
            for name, g_, w_ in zip(BWD_LEAVES, got, want):
                check(torch.equal(g_, w_), f"{what}: {name} on exact inputs differs from {ref}")
        del exact, got, refs
        got = entry()
        check(all(torch.equal(u, v) for u, v in zip(got, entry())),
              f"{what}: two calls differ")
        gaps = {}
        for ref, want in (("plain", plain()), ("dense", dense())):
            for name, g_, w_ in zip(BWD_LEAVES, got, want):
                top, gap = float(w_.abs().max()), (g_ - w_).abs()
                if name == "dw_dec" and composed:  # the sum rounded to bf16
                    ok = bool((gap <= 2.0 ** -7 * w_.abs() + 1e-5 * top).all())
                elif name == "dw_enc" or composed:  # dpre rounded to bf16 before the sum
                    ok = float(gap.max()) <= 2.0 ** -8 * top and float(gap.mean()) <= 1e-5 * top
                else:
                    ok = float(gap.max()) <= 1e-5 * top
                gaps[f"{name}_{ref}"] = float(gap.max()) / top
                check(ok, f"{what}: {name} against {ref}: max |gap| / max |g| "
                          f"{gaps[f'{name}_{ref}']:.3g}")
            del want
        del got
        nnz = int((args[0] > 0).sum())
        # the latent once, d_recon, xc and W_dec once, dW_enc and dW_dec in f32 out
        nbytes = (rows * h * 2 + rows * d * (4 if composed else 2) + rows * d * 2 + h * d * 2
                  + 2 * h * d * 4 + h * 4)
        r = {"ms": time_ms(entry, iters=10, warmup=2),
             "plain_ms": time_ms(plain, iters=3, warmup=1),
             **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0, 6 * nnz * d))),
             "library_ms": time_ms(dense, iters=10, warmup=2),
             "split_ms": launch_split(entry, BWD_PARTS), "entries": nnz,
             "max_rel_gap": gaps, "batch": rows, "geometry": {"d": d, "h": h, "k": K},
             "composed": composed}
        log(f"  {what}: equal to its plain version and the dense products on exact inputs, "
            f"two calls equal; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}), dense products {r['library_ms']:.4f}; "
            f"device ms a call: " + ", ".join(
                f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                for k_, v in r["split_ms"].items())
            + f"; {nnz} entries; max |gap| / max |g| {json.dumps(gaps)}")
        res[cell] = r
        del args
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 5-7: the extraction slice
# ---------------------------------------------------------------------------


def encoder_inputs(dev, W, CE, arch=None, b: int = ENC_B) -> dict:
    """A bf16 encoder (weights, biases and LN parameters all randomised;
    whisper-tiny unless ``arch`` is given) and a batch of ``b`` random mels
    on the card, with the inputs of every encoder kernel."""
    arch = arch or W.arch_for("openai/whisper-tiny")
    g = torch.Generator().manual_seed(11)
    p = W.init_whisper(g, arch)["encoder"]
    p = W._tree_map(lambda a: a + 0.02 * torch.randn(a.shape, generator=g), p)
    enc = W.params_to(W.cast_params(p, torch.bfloat16), dev)
    lp = W._layer(enc["layers"], 0)
    mel = (torch.randn(b, arch.n_mels, 2 * ENC_T, generator=g) * 0.5).to(dev).bfloat16()
    return {"enc": enc, "lp": lp, "mel": mel, "b": b, "d": arch.d_model, "f": arch.ffn_dim,
            "heads": arch.num_heads, "n_mels": arch.n_mels,
            "stem": (mel, enc["conv1_w"], enc["conv1_b"], enc["conv2_w"], enc["conv2_b"],
                     enc["pos"]),
            "final_ln": (enc["ln_f_g"].float(), enc["ln_f_b"].float())}


# the MLP block's output modes: (capture, final-LN capture, its dtype)
MLP_MODES = ((False, False, torch.bfloat16), (True, False, torch.bfloat16),
             (False, True, torch.bfloat16), (True, True, torch.float32))


def encoder_kernel_phase(dev, W, E, CE, arch=None, b: int = ENC_B) -> tuple[dict, dict]:
    """Phases 5 and 14; returns (max abs errors by kernel, the inputs for
    the times)."""
    inp = encoder_inputs(dev, W, CE, arch, b)
    lp, errs, d, heads = inp["lp"], {}, inp["d"], inp["heads"]
    before = enc_launches(CE)
    x = E.conv_stem_plain(*inp["stem"])
    stem = CE.conv_stem_fwd(*inp["stem"])
    errs["conv_stem"] = bar_check(stem, x, BLOCK_BAR, "conv_stem")
    check(torch.equal(stem, CE.conv_stem_fwd(*inp["stem"])), "conv_stem: two launches differ")
    del stem
    rows = x.view(-1, d)
    qkv = E.ln_qkv_plain(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    got = CE.ln_qkv_fwd(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    errs["ln_qkv"] = max(bar_check(a, w, BLOCK_BAR, f"ln_qkv {n}")
                         for n, a, w in zip("qkv", got, qkv))
    q, k, v = (a.view(b, ENC_T, d) for a in qkv)
    attn = E.self_attention_plain(q, k, v, heads)
    core = CE.self_attention_fwd(q, k, v, heads)
    errs["self_attention"] = bar_check(core, attn, BLOCK_BAR, "self_attention")
    check(torch.equal(core, CE.self_attention_fwd(q, k, v, heads)),
          "self_attention: two launches differ")
    errs["self_attention"] = max(errs["self_attention"], bar_check(
        CE.self_attention_fwd(q, k, v, heads, 1437), E.self_attention_plain(q, k, v, heads, 1437),
        BLOCK_BAR, "self_attention, keys from 1437 masked"))
    errs["flash_self_attention"] = bar_check(CE.flash_self_attention_fwd(q, k, v, heads),
                                             attn, BLOCK_BAR, "flash_self_attention")
    arows = attn.view(-1, d)
    errs["out_proj"] = bar_check(CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                                 E.out_proj_plain(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                                 BLOCK_BAR, "out_proj")
    check(all(torch.equal(a, w) for a, w in zip(got, CE.ln_qkv_fwd(
        rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads))), "ln_qkv: two launches differ")
    check(torch.equal(CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                      CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"])),
          "out_proj: two launches differ")
    sweep = gemm_width_sweep(dev, E, CE, b)
    block = E.attention_block_plain(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)
    block_err = bar_check(CE.attention_block_fwd(x, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads),
                          block, BLOCK_BAR, "attention block")
    brows = block.view(-1, d)
    errs["mlp_block"] = 0.0
    for capture, final_ln, cap_dt in MLP_MODES:
        fl = inp["final_ln"] if final_ln else None
        got = CE.mlp_block_fwd(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
        want = E.mlp_block_plain(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], capture, fl, cap_dt)
        got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
        check(len(got) == len(want) and all(a.dtype == w.dtype for a, w in zip(got, want)),
              f"mlp_block capture={capture} final_ln={final_ln}: outputs differ in kind")
        for a, w in zip(got, want):
            errs["mlp_block"] = max(errs["mlp_block"], bar_check(
                a, w, BLOCK_BAR, f"mlp_block capture={capture} final_ln={final_ln}"))
    for name in sweep:
        errs[name] = max(errs[name], sweep[name])
    torch.cuda.synchronize()
    forms = {k: n - before[k] for k, n in enc_launches(CE).items()
             if k.startswith(("conv_stem", "mlp_block")) and n > before[k]}
    log("  " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f", attention block {block_err:.3g} (max abs err, each within the one-block bar; "
        f"B={b}; stem and MLP forms launched {forms}; the stem, the attention core, LN+QKV, "
        "the out-projection and the MLP block bit-identical run to run)")
    inp.update(x=x, rows=rows, q=q, k=k, v=v, arows=arows, brows=brows)
    return errs, inp


def mlp_sample(n: int) -> torch.Tensor:
    """Rows the width sweep holds against the MLP block's plain version:
    one in 16 of every 128-row tile, at a position that moves from tile
    to tile (all 16 residues over 16 tiles), and the whole last tile."""
    r = torch.arange(n)
    return r[((r + r // 128) % 16 == 0) | (r >= (n - 1) // 128 * 128)]


def gemm_width_sweep(dev, E, CE, b: int) -> dict:
    """LN+QKV, the out-projection and the MLP block (the Hopper GEMM of
    ``ops/csrc/encoder_gemm.cu``) against their plain versions at every
    width of the gate, heads of 64, F = 4D, on a ragged ``b*T - 37`` rows
    and on 100 rows, at the one-block bar, the MLP block in all four
    output modes; two launches equal.  On the ragged rows the MLP block's
    plain version runs on the rows of ``mlp_sample`` (the block is row by
    row; its f32 products on every row of every width would take minutes).
    The conv stem at every width for 80 and 128 mels on 2 clips of 1500
    frames, two launches equal.  Returns the max abs errors."""
    errs = {"ln_qkv": 0.0, "out_proj": 0.0, "mlp_block": 0.0, "conv_stem": 0.0}
    for d in GATE_WIDTHS:
        g = torch.Generator().manual_seed(d)

        def r(*shape, scale=0.05):
            return (torch.randn(*shape, generator=g) * scale).to(dev).bfloat16()

        p = {"wq": r(d, d), "wk": r(d, d), "wv": r(d, d), "wo": r(d, d), "bq": r(d),
             "bv": r(d), "bo": r(d)}
        ln_g, ln_b, heads = 1 + r(d), r(d), d // 64
        mlp = {"w1": r(d, 4 * d, scale=d ** -0.5), "b1": r(4 * d),
               "w2": r(4 * d, d, scale=(4 * d) ** -0.5), "b2": r(d)}
        fl = ((1 + r(d)).float(), r(d).float())
        for n in (b * ENC_T - 37, 100):
            x = r(n, d, scale=1.0)
            got = CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads)
            want = E.ln_qkv_plain(x, ln_g, ln_b, p, heads)
            errs["ln_qkv"] = max([errs["ln_qkv"]] + [bar_check(a, w, BLOCK_BAR, f"ln_qkv {c} D={d} "
                                                               f"rows={n}")
                                                     for c, a, w in zip("qkv", got, want)])
            check(all(torch.equal(a, w) for a, w in zip(got, CE.ln_qkv_fwd(x, ln_g, ln_b, p, heads))),
                  f"ln_qkv D={d} rows={n}: two launches differ")
            out = CE.out_proj_fwd(got[2], x, p["wo"], p["bo"])
            errs["out_proj"] = max(errs["out_proj"], bar_check(
                out, E.out_proj_plain(got[2], x, p["wo"], p["bo"]), BLOCK_BAR,
                f"out_proj D={d} rows={n}"))
            check(torch.equal(out, CE.out_proj_fwd(got[2], x, p["wo"], p["bo"])),
                  f"out_proj D={d} rows={n}: two launches differ")
            del got, want, out
            rows = mlp_sample(n).to(dev)
            # out, ln_f(out) in f32, mlp_in, mlp_out: every mode's outputs
            ref = E.mlp_block_plain(x[rows], ln_g, ln_b, mlp, True, fl, torch.float32)
            for capture, final_ln, cap_dt in MLP_MODES:
                what = f"mlp_block D={d} rows={n} capture={capture} final_ln={final_ln}"
                f_ln = fl if final_ln else None
                got = CE.mlp_block_fwd(x, ln_g, ln_b, mlp, capture, f_ln, cap_dt)
                again = CE.mlp_block_fwd(x, ln_g, ln_b, mlp, capture, f_ln, cap_dt)
                got, again = (o if isinstance(o, tuple) else (o,) for o in (got, again))
                want = ([ref[0]] + ([ref[1].to(cap_dt)] if final_ln else [])
                        + (list(ref[2:]) if capture else []))
                check(len(got) == len(want) and all(a.dtype == w.dtype for a, w in zip(got, want)),
                      f"{what}: outputs differ in kind")
                for a, w, a2 in zip(got, want, again):
                    errs["mlp_block"] = max(errs["mlp_block"], bar_check(a[rows], w, BLOCK_BAR, what))
                    check(torch.equal(a, a2), f"{what}: two launches differ")
                del got, again
            del x, ref
        for n_mels in (80, 128):
            stem = (r(d, n_mels, 3, scale=(3 * n_mels) ** -0.5), r(d),
                    r(d, d, 3, scale=(3 * d) ** -0.5), r(d), r(ENC_T, d))
            mel = r(2, n_mels, 2 * ENC_T, scale=0.5)
            got = CE.conv_stem_fwd(mel, *stem)
            errs["conv_stem"] = max(errs["conv_stem"], bar_check(
                got, E.conv_stem_plain(mel, *stem), BLOCK_BAR, f"conv_stem D={d} mels={n_mels}"))
            check(torch.equal(got, CE.conv_stem_fwd(mel, *stem)),
                  f"conv_stem D={d} mels={n_mels}: two launches differ")
            del stem, mel, got
    log(f"  LN+QKV, out-projection and MLP block (4 modes) at D={list(GATE_WIDTHS)}, rows "
        f"{b * ENC_T - 37} and 100: max abs err {errs['ln_qkv']:.3g} / {errs['out_proj']:.3g} / "
        f"{errs['mlp_block']:.3g}; the stem (80 and 128 mels, 2 clips) {errs['conv_stem']:.3g}; "
        "each within the one-block bar, two launches equal")
    return errs


def extraction_config(work: Path) -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check(cfg["whisper"]["model_name"] == "openai/whisper-tiny" and cfg["training"]["use_amp"]
          and cfg["encoder_layers"] == [0, 1, 2, 3] and cfg["decoder_layers"] == [0, 1, 2, 3],
          "tiny_default.yaml's model, layers or AMP changed")
    cfg["data"].update(dataset_name="synthetic", max_samples=EXTRACT_CLIPS,
                       cache_dir=str(work / "xcache"))
    cfg["training"].update(epochs=1, warmup_steps=100)
    cfg["output_dir"] = str(work / "xout")
    cfg["experiment_name"] = "extract_smoke"
    path = work / "extract_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


ENC_WRAPPERS = ("conv_stem", "ln_qkv", "self_attention", "out_proj", "mlp_block",
                "flash_self_attention")


def enc_source(name: str) -> str:
    if "attention" in name:
        return ATTN_SOURCE
    return ENC_SOURCE if name == "conv_stem" else GEMM_SOURCE


def prep_entry(name: str, parts: dict) -> dict:
    """The ``kernels`` line's extra keys of an encoder kernel: the one-off
    weight preparation, for LN+QKV, the out-projection and the MLP block
    the parts timed alone (the LN launches, the GEMMs), and for the stem
    each launch's device ms (``split_ms``)."""
    key = {"ln_qkv": "qkv", "out_proj": "out_proj", "mlp_block": "mlp", "conv_stem": "stem"}
    out = {}
    if name in key:
        out["weight_prep_ms"] = parts["prep_ms"][key[name]]
    if name in parts["parts_ms"]:
        out["parts_ms"] = parts["parts_ms"][name]
    if name == "conv_stem":
        out["split_ms"] = parts["stem_split_ms"]
    return out


def enc_launches(CE) -> dict:
    """Launches by kernel."""
    return {name: getattr(CE, f"{name}_fwd").launches for name in ENC_WRAPPERS}


def reset_enc_launches(CE) -> None:
    for name in ENC_WRAPPERS:
        getattr(CE, f"{name}_fwd").launches = 0


def extraction_path(work: Path, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE) -> dict:
    """Phase 6; returns launches by kernel and the CLI's end-to-end clips/s."""
    path = extraction_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    reset_enc_launches(CE)
    E.plain_calls.clear()
    t0 = time.perf_counter()
    out = train_mod.main(["--config", str(path), "--extract-only", "--random-whisper",
                          "--no-wandb"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    log(f"  CLI extracted {EXTRACT_CLIPS} clips in {extract_s:.2f} s "
        f"({EXTRACT_CLIPS / extract_s:,.1f} clips/s end to end: mel, forward, transfer, disk); "
        f"launches {launches}, plain-version calls {dict(E.plain_calls)}")
    check(out == {}, "--extract-only trained something")
    batches = -(-EXTRACT_CLIPS // 64)
    layers = len(cfg.encoder_layers)
    want = {"conv_stem": batches, "ln_qkv": layers * batches, "self_attention": layers * batches,
            "out_proj": layers * batches, "mlp_block": layers * batches,
            "flash_self_attention": 0}
    check(launches == want, f"extraction launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"plain versions ran on the card: {E.plain_calls}")

    # the 8 caches, then the first 2 clips against the CPU
    cache = cache_mod.FeatureCache(work / "xcache" / "features", cfg.whisper, cfg.data)
    arch = W.arch_for(cfg.whisper.model_name)
    # the CLI makes the weights on the card from the config's seed
    params = W.params_to(W.init_whisper(torch.Generator(device=dev).manual_seed(cfg.training.seed),
                                        arch), "cpu")
    ds = ds_mod.SyntheticSpeechDataset(EXTRACT_CLIPS, seed=cfg.training.seed, n_mels=arch.n_mels)
    mel2 = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(2)]))
    ref = W.extract_activations(params, mel2, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16)
    worst = {}
    for comp, n_layers, tokens in (("encoder", arch.encoder_layers, ENC_T),
                                   ("decoder", arch.decoder_layers, 1)):
        for layer in range(n_layers):
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples, meta.dtype)
                  == (EXTRACT_CLIPS * tokens, ENC_D, EXTRACT_CLIPS, "float32"),
                  f"{comp}:{layer} metadata {meta}")
            rows, _ = cache.load(comp, layer)
            check(bool(torch.isfinite(rows).all()), f"{comp}:{layer}: non-finite rows")
            bar_check(rows[:2 * tokens], ref[comp][layer].reshape(-1, ENC_D), STACK_BAR,
                      f"{comp}:{layer} first 2 clips, card vs CPU")
            d = (rows[:2 * tokens] - ref[comp][layer].reshape(-1, ENC_D).float()).abs()
            worst[f"{comp}:{layer}"] = float(d.mean() / ref[comp][layer].float().abs().mean())
            del rows
    log(f"  8 caches of 128 clips; first 2 clips vs the CPU, mean rel err by layer: "
        + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + " (stack bar 2**-7)")

    # the f32 mode on the card against the CPU
    p_dev = W.params_to(params, dev)
    f32_card = W.extract_activations(p_dev, mel2.to(dev), arch)
    f32_cpu = W.extract_activations(params, mel2, arch)
    for key, want_t in f32_cpu.items():
        try:
            torch.testing.assert_close(f32_card[key].cpu(), want_t, rtol=1e-3, atol=1e-4)
        except AssertionError as e:
            raise SmokeFailure(f"f32 extraction {key}: card vs CPU: {e}") from None
    log("  f32 extraction on 2 clips: card equals the CPU at rtol 1e-3")

    # the composed route sends its attention core to the kernel (row 11)
    CE.flash_self_attention_fwd.launches = 0
    with torch.no_grad():
        last, outs = W.encoder_forward(W.cast_params(p_dev, torch.bfloat16),
                                       mel2.to(dev).bfloat16(), arch, use_fused=False)
    torch.cuda.synchronize()
    launches["flash_self_attention"] = CE.flash_self_attention_fwd.launches
    check(launches["flash_self_attention"] == arch.encoder_layers,
          f"flash route: {launches['flash_self_attention']} launches")
    check(bool(torch.isfinite(outs.float()).all()), "flash route: non-finite")
    fused = W.extract_activations(p_dev, mel2.to(dev), arch, compute_dtype=torch.bfloat16,
                                  apply_layer_norm=False, with_decoder=False)
    for layer in range(arch.encoder_layers):
        bar_check(outs[layer], fused["encoder"][layer], STACK_BAR,
                  f"composed bf16 route layer {layer} vs fused")
    log(f"  composed bf16 route on 2 clips: {launches['flash_self_attention']} flash-route "
        "launches, layers within the stack bar of the fused route")

    # the two slices meet: train one epoch from the extracted encoder:3 cache
    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:3",
                                 "--no-wandb"]).values()
    train_s = time.perf_counter() - t0
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([r["loss"] for r in rows])
    check(len(rows) == -(-EXTRACT_CLIPS * ENC_T // 128), f"metrics.json has {len(rows)} rows")
    check(bool(np.isfinite(losses).all()), "training on the extracted cache: non-finite loss")
    tenth = max(1, len(losses) // 10)
    first, last_l = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    check(last_l < first, f"training on the extracted cache: loss did not fall "
                          f"({first:.5f} -> {last_l:.5f})")
    log(f"  trained encoder:3 from the extracted cache, {len(rows)} steps in {train_s:.1f} s: "
        f"loss {first:.5f} -> {last_l:.5f}")
    shutil.rmtree(work / "xcache", ignore_errors=True)
    return {"launches": launches, "cli_clips_per_s": EXTRACT_CLIPS / extract_s}


# each encoder block's program span (``models/whisper.py``'s ``_fused_encoder_layers``)
ENC_SPANS = {"attention_block": "encoder.attention", "mlp_block": "encoder.mlp"}
# the device-side spans of profiler ranges: the program's spans and ``dec.<part>``
RANGE_PREFIXES = ("train.", "extract.", "encoder.", "decoder.", "dec.")


def device_ops(events) -> list:
    """The device's own activities (kernels, copies, memsets) among a
    trace's events: the device-side spans of the program's ranges and of
    the ``dec.<part>`` ranges are left out, so nothing is counted twice."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.key.startswith(RANGE_PREFIXES)]


def block_shares(prof, batches: int, busy: float) -> dict:
    """ms a batch of each encoder block's program span (``ENC_SPANS``) on
    the device (from its first kernel's start to its last kernel's end)
    and its share of the busy time; None where the trace has no device
    span for the range (not measured)."""
    from torch.autograd import DeviceType

    res = {}
    for name, key in ENC_SPANS.items():
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.key == key)
        res[name] = {"ms": us / 1e3 / batches, "share": us / 1e3 / batches / busy} if us else None
    log("  the encoder's blocks on the device (each call's span, ms a batch, share of busy): "
        + ", ".join(f"{k} " + (f"{v['ms']:.3f} ({v['share']:.1%})" if v else "not measured")
                    for k, v in res.items()))
    return res


def extraction_times(dev, W) -> dict:
    """Phase 7a: the bench definition (random weights and mel, batch 64,
    bf16, all layers captured in bf16, decoder on), 8 batches timed on the
    host clock; then the device's busy share under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    arch = W.arch_for("openai/whisper-tiny")
    p = W.params_to(W.cast_params(W.init_whisper(torch.Generator().manual_seed(0), arch),
                                  torch.bfloat16), dev)
    mels = torch.randn(8, ENC_B, N_MELS, 2 * ENC_T, generator=torch.Generator().manual_seed(1),
                       device="cpu").to(dev)

    def run(n):
        for i in range(n):
            W.extract_activations(p, mels[i], arch, compute_dtype=torch.bfloat16,
                                  capture_dtype=torch.bfloat16)

    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    clips_s = 8 * ENC_B / dt
    res = {"clips_per_s": clips_s, "tokens_per_s_per_layer": clips_s * ENC_T,
           "batch_ms": 1e3 * dt / 8}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(3)
        torch.cuda.synchronize()
    kernels = device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    res["busy_ms"] = busy
    log(f"  extract_activations, batch 64 bf16: {res['batch_ms']:.3f} ms a batch, "
        f"{clips_s:,.1f} clips/s, {res['tokens_per_s_per_layer']:,.0f} activation tokens/s "
        "per layer")
    if busy <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    log(f"  device busy {busy:.3f} ms a batch (profiled run), idle share "
        f"{max(0.0, 1 - busy / res['batch_ms']):.1%} of the unprofiled batch")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / 3:8.4f} ms/batch  {e.count // 3:3d}x  "
            f"{e.key[:90]}")
    res["blocks"] = block_shares(prof, 3, busy)
    return res


def extraction_breakdown(work: Path, dev, W, cfg_mod, cache_mod, ds_mod) -> dict:
    """Phase 7c: where one 64-clip batch of the CLI's extraction spends
    its time, each stage timed alone on the host clock (ending in a
    synchronise): waveforms, log-mel, upload, the encoder's stem and
    layers (CUDA events), the decoder, the device->host copy of the 8
    captured layers, and the f32 widening plus ``.npy`` writes."""
    arch = W.arch_for("openai/whisper-tiny")
    params = W.init_whisper(torch.Generator().manual_seed(0), arch)
    t0 = time.perf_counter()
    p = W.cast_params(W.params_to(params, dev), torch.bfloat16)
    torch.cuda.synchronize()
    res = {"weights_to_card_ms": 1e3 * (time.perf_counter() - t0)}
    ds = ds_mod.SyntheticSpeechDataset(ENC_B, seed=0, device=dev)

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[name] = 1e3 * (time.perf_counter() - t)
        return out

    stage("warm_mel_ms", lambda: ds_mod.SyntheticSpeechDataset(2, seed=9, device=dev)[0])
    waves = stage("waveforms_ms", lambda: np.stack([ds.waveform(i) for i in range(ENC_B)]))
    mel_np = stage("log_mel_ms", lambda: ds_mod.log_mel_spectrogram(waves, device=dev).cpu().numpy())
    mel = stage("upload_ms", lambda: torch.from_numpy(mel_np).bfloat16().to(dev))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad(), W.f32_matmuls():
        W.encoder_forward(p, mel, arch, capture_final_ln=True)  # warm
        torch.cuda.synchronize()
        ev[0].record()
        x = W.encoder_ops.conv_stem(mel, p["encoder"])
        ev[1].record()
        fl = (p["encoder"]["ln_f_g"].float(), p["encoder"]["ln_f_b"].float())
        _, caps, _ = W._fused_encoder_layers(x, p["encoder"], arch, False, fl, torch.bfloat16)
        ev[2].record()
        bos = torch.full((ENC_B, 1), arch.decoder_start_token_id, device=dev)
        _, dec, _ = W.decoder_forward(p, bos, caps[-1], arch, with_mlp=True)
        ev[3].record()
        torch.cuda.synchronize()
    res["stem_ms"] = ev[0].elapsed_time(ev[1])
    res["encoder_layers_ms"] = ev[1].elapsed_time(ev[2])
    res["decoder_ms"] = ev[2].elapsed_time(ev[3])
    copy_stream = torch.cuda.Stream(dev)  # the extraction loop's pinned side-stream copy
    host = stage("to_host_ms", lambda: tuple(cache_mod._start_pull(a.bfloat16(), copy_stream)()
                                             for a in (caps, dec)))
    cache = cache_mod.FeatureCache(work / "bcache", cfg_mod.WhisperConfig(), cfg_mod.DataConfig())

    def write():
        for comp, stack in zip(("encoder", "decoder"), host):
            wide = stack.float()
            for layer in range(stack.shape[0]):
                w = cache.writer(comp, layer)
                w.append(wide[layer].reshape(-1, ENC_D))
                w.finalize(ENC_B)

    stage("widen_and_write_ms", write)
    shutil.rmtree(work / "bcache", ignore_errors=True)
    log("  one 64-clip batch of the CLI's extraction, stage by stage (ms): "
        + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in res.items()))
    return res


def encoder_kernel_times(inp: dict, E, CE) -> dict:
    """Phases 7b and 16b: each encoder kernel on phase 5's (14's) inputs,
    its plain version, its bound and a library yardstick."""
    import torch.nn.functional as F

    lp, mel, enc = inp["lp"], inp["mel"], inp["enc"]
    rows, arows, brows, q, k, v = (inp[n] for n in ("rows", "arows", "brows", "q", "k", "v"))
    n, t = rows.shape[0], ENC_T
    d, f, b, heads, n_mels = (inp[n_] for n_ in ("d", "f", "b", "heads", "n_mels"))
    bf = 2  # bytes of a bf16 value
    wq = torch.cat([lp["attn"]["wq"], lp["attn"]["wk"], lp["attn"]["wv"]], dim=1)
    fl = inp["final_ln"]
    hq, hk, hv = (a.view(b, t, heads, 64).transpose(1, 2) for a in (q, k, v))
    w1, w2 = enc["conv1_w"], enc["conv2_w"]
    res = {}
    res["conv_stem"] = (
        time_ms(lambda: CE.conv_stem_fwd(*inp["stem"])),
        time_ms(lambda: E.conv_stem_plain(*inp["stem"]), iters=5, warmup=1),
        # conv1 at all 2T mel frames, conv2 at the T output frames
        *enc_bound(b * n_mels * 2 * t * bf + (3 * n_mels * d + 3 * d * d + t * d) * bf
                   + b * t * d * bf, 2 * b * t * d * (6 * n_mels + 3 * d)),
        time_ms(lambda: F.conv1d(F.conv1d(mel, w1, enc["conv1_b"], padding=1), w2,
                                 enc["conv2_b"], stride=2, padding=1)),
    )
    res["ln_qkv"] = (
        time_ms(lambda: CE.ln_qkv_fwd(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads)),
        time_ms(lambda: E.ln_qkv_plain(rows, lp["ln1_g"], lp["ln1_b"], lp["attn"], heads),
                iters=5, warmup=1),
        *enc_bound(4 * n * d * bf + 3 * d * d * bf, 2 * n * d * 3 * d),
        time_ms(lambda: torch.matmul(rows, wq)),
    )
    core = (time_ms(lambda: CE.self_attention_fwd(q, k, v, heads)),
            time_ms(lambda: E.self_attention_plain(q, k, v, heads), iters=3, warmup=1),
            *enc_bound(4 * n * d * bf, 4 * b * t * t * d, b * heads * t * t),
            time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=1.0)))
    res["self_attention"] = core
    res["flash_self_attention"] = (time_ms(lambda: CE.flash_self_attention_fwd(q, k, v, heads)),
                                   *core[1:])
    res["out_proj"] = (
        time_ms(lambda: CE.out_proj_fwd(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"])),
        time_ms(lambda: E.out_proj_plain(arows, rows, lp["attn"]["wo"], lp["attn"]["bo"]),
                iters=5, warmup=1),
        *enc_bound(3 * n * d * bf + d * d * bf, 2 * n * d * d),
        time_ms(lambda: torch.matmul(arows, lp["attn"]["wo"])),
    )
    # the main path's mode: final-LN capture in bf16, no MLP pair
    res["mlp_block"] = (
        time_ms(lambda: CE.mlp_block_fwd(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], False, fl)),
        time_ms(lambda: E.mlp_block_plain(brows, lp["ln2_g"], lp["ln2_b"], lp["mlp"], False, fl),
                iters=5, warmup=1),
        *enc_bound(3 * n * d * bf + 2 * d * f * bf, 4 * n * d * f),
        time_ms(lambda: torch.matmul(torch.matmul(brows, lp["mlp"]["w1"]), lp["mlp"]["w2"])),
    )
    return res


def encoder_prep_and_parts(inp: dict, CE, lib) -> dict:
    """Phases 7b and 16b, beside the kernel times (which run on weights
    prepared by the earlier phases): the weight preparation's one-off time
    (each kernel layout built from the parameters, not taken from the
    cache), and the launches of LN+QKV, the out-projection and the MLP
    block (in the main path's mode: the final-LN capture in bf16), each
    timed alone, weights prepared."""
    lp, enc, rows, arows, brows = (inp[n] for n in ("lp", "enc", "rows", "arows", "brows"))
    a, m = lp["attn"], lp["mlp"]
    n, d = rows.shape
    f = m["w1"].shape[1]
    prep = {
        "qkv": lambda: CE._build_qkv(a["wq"], a["wk"], a["wv"], a["bq"], a["bv"], lp["ln1_g"],
                                     lp["ln1_b"]),
        "out_proj": lambda: CE._build_out_proj(a["wo"], a["bo"]),
        "mlp": lambda: CE._build_mlp(m["w1"], m["b1"], m["w2"], m["b2"], lp["ln2_g"],
                                     lp["ln2_b"]),
        "stem": lambda: CE._build_stem(enc["conv1_w"], enc["conv1_b"], enc["conv2_w"],
                                       enc["conv2_b"], enc["pos"][:ENC_T]),
    }
    prep_ms = {k: time_ms(fn, iters=5, warmup=1) for k, fn in prep.items()}
    wt, bias, g, bln = CE.qkv_weights(a, lp["ln1_g"], lp["ln1_b"])
    wo, bo = CE.out_proj_weights(a["wo"], a["bo"])
    w1t, b1, w2t, b2, g2, bln2 = CE.mlp_weights(m, lp["ln2_g"], lp["ln2_b"])
    fg, fb = (t.float().contiguous() for t in inp["final_ln"])
    xln, q, k, v, out, out2, xln2, cap = (torch.empty_like(rows) for _ in range(8))
    hid = torch.empty((n, f), dtype=rows.dtype, device=rows.device)
    st = torch.cuda.current_stream().cuda_stream
    calls = {
        "ln_qkv": {
            "ln1": lambda: lib.wst_ln_rows_fwd(rows.data_ptr(), n, d, g.data_ptr(),
                                               bln.data_ptr(), xln.data_ptr(), st),
            "qkv_gemm": lambda: lib.wst_enc_gemm_fwd(
                0, xln.data_ptr(), wt.data_ptr(), n, 3 * d, d, bias.data_ptr(), 0.125, d,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, st)},
        "out_proj": {
            "out_proj_gemm": lambda: lib.wst_enc_gemm_fwd(
                1, arows.data_ptr(), wo.data_ptr(), n, d, d, bo.data_ptr(), 1.0, d,
                out.data_ptr(), None, None, rows.data_ptr(), st)},
        "mlp_block": {
            "ln2": lambda: lib.wst_ln_rows_fwd(brows.data_ptr(), n, d, g2.data_ptr(),
                                               bln2.data_ptr(), xln2.data_ptr(), st),
            "fc1_gemm": lambda: lib.wst_enc_gemm_fwd(
                2, xln2.data_ptr(), w1t.data_ptr(), n, f, d, b1.data_ptr(), 1.0, d,
                hid.data_ptr(), None, None, None, st),
            "fc2_gemm": lambda: lib.wst_enc_gemm_fwd(
                1, hid.data_ptr(), w2t.data_ptr(), n, d, f, b2.data_ptr(), 1.0, d,
                out2.data_ptr(), None, None, brows.data_ptr(), st),
            "final_ln": lambda: lib.wst_ln_rows_fwd(out2.data_ptr(), n, d, fg.data_ptr(),
                                                    fb.data_ptr(), cap.data_ptr(), st)},
    }
    parts_ms = {}
    for kernel, parts in calls.items():
        parts_ms[kernel] = {}
        for name, fn in parts.items():
            check(fn() == 0, f"{name}: launch failed")
            parts_ms[kernel][name] = time_ms(fn)
    stem_split = launch_split(lambda: CE.conv_stem_fwd(*inp["stem"]), STEM_PARTS)
    log("  weight preparation, one-off ms a layer (built once per parameter tensor, not in "
        "the kernel times): " + ", ".join(f"{k} {v:.4f}" for k, v in prep_ms.items()))
    for kernel, parts in parts_ms.items():
        log(f"  {kernel}'s launches alone ({n} rows, D={d}), ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    log(f"  conv_stem's three launches, device ms a call ({inp['b']} clips, D={d}; "
        "torch.profiler): " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in stem_split.items()))
    return {"prep_ms": prep_ms, "parts_ms": parts_ms, "stem_split_ms": stem_split}


# ---------------------------------------------------------------------------
# phases 8-10: the coder slice (ReLU SAE, transcoders, crosscoders)
# ---------------------------------------------------------------------------


def coder_inputs(mode: str, n: int, seed: int, dev, geom: tuple | None = None) -> tuple:
    """Rows, targets (None when the rows are their own target) and weights
    of ``mode`` at whisper-tiny width, or at ``geom`` = (D, dout, H),
    drawn on the card from ``seed``."""
    d, dout, k, skip, y_is_x = CODER_MODES[mode]
    h = H
    if geom is not None:
        d, dout, h = geom
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = randn(n, d)
    y = None if y_is_x else randn(n, dout)
    p = {"w_enc": randn(d, h, scale=d ** -0.5), "b_enc": randn(h, scale=0.05),
         "w_dec": randn(h, dout, scale=0.05), "b_dec": randn(dout, scale=0.05)}
    if skip:
        p.update(w_skip=randn(d, dout, scale=0.02), b_skip=randn(dout, scale=0.05))
    return x, y, p, k


def coder_ops(CC, p: dict, k):
    b_out = p["b_dec"] + p["b_skip"] if "w_skip" in p else p["b_dec"]
    return CC.operands(p["w_enc"], p["b_enc"], p["w_dec"], b_out, p.get("w_skip"),
                       topk=k is not None)


def check_coder(got, want, k, what: str) -> float:
    """Phase 8's bars; returns the max abs residual error on agreeing rows."""
    torch.cuda.synchronize()
    check(torch.equal(got.xc, want.xc), f"{what}: bf16 rows differ")
    rel = abs(float(got.sq) - float(want.sq)) / float(want.sq)
    check(rel <= 1e-4, f"{what}: sum of squares rel err {rel:.3g} > 1e-4")
    hmax = float(want.hid.float().abs().max())
    if k is not None:
        ok = agree(got.hid, want.hid)
        share = float(ok.float().mean())
        check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
        hk, hp = got.hid[ok] > 0, want.hid[ok] > 0
        check(int(hk.sum()) == int(hp.sum()) and torch.equal(hk.any(0), hp.any(0)),
              f"{what}: l0/active differ on agreeing rows")
        if bool(ok.all()):
            check(int(got.l0) == int(want.l0) and torch.equal(got.active, want.active),
                  f"{what}: l0/active differ")
    else:
        ok = torch.ones(got.hid.shape[0], dtype=torch.bool, device=got.hid.device)
        for name, a, b in (("l1", got.l1, want.l1), ("hsum", got.hsum, want.hsum)):
            err = float((a - b).abs().max() / b.abs().max())
            check(err <= 1e-4, f"{what}: {name} rel err {err:.3g} > 1e-4")
        share = float((got.active == want.active).float().mean())
        check(share >= 0.999, f"{what}: active equal on {share:.4%} of features")
        rel = abs(int(got.l0) - int(want.l0)) / max(1, int(want.l0))
        check(rel <= 1e-4, f"{what}: l0 rel err {rel:.3g} > 1e-4")
    herr = float((got.hid[ok].float() - want.hid[ok].float()).abs().max())
    check(herr <= 1e-2 * hmax, f"{what}: latent off by {herr:.3g} (max {hmax:.3g})")
    return float((got.resid[ok] - want.resid[ok]).abs().max())


def coder_loss(CC, mode: str, p: dict, x, y, step=None, batch=None):
    """The training loss of ``mode`` through its autograd.Function: the
    sliced entry, or the windowed one when ``step`` is given."""
    k = CODER_MODES[mode][2]
    base = (p["w_enc"], p["b_enc"], p["w_dec"], p["b_dec"])
    if mode == "relu_sae":
        if step is None:
            return CC.fused_relu_sae_loss(x, *base, 0.01)[0]
        return CC.fused_relu_sae_loss_indexed(x, step, *base, 0.01, batch)[0]
    if mode == "relu_crosscoder":
        norms = torch.linalg.vector_norm(p["w_dec"], dim=1)
        if step is None:
            return CC.fused_relu_crosscoder_loss(x, *base, norms, 0.01, 4)[0]
        return CC.fused_relu_crosscoder_loss_indexed(x, step, *base, norms, 0.01, 4, batch)[0]
    skip = (p.get("w_skip"), p.get("b_skip"))
    y_is_x = mode == "topk_crosscoder"
    if step is None:
        return CC.fused_transcoder_loss(x, y, *base, *skip, k, "w_skip" in p, y_is_x)[0]
    return CC.fused_transcoder_loss_indexed(x, y, step, *base, *skip, k, batch, "w_skip" in p,
                                            y_is_x)[0]


def coder_grads_close(CC, mode: str, p: dict, x, y, step, batch, what: str) -> None:
    """Gradients through the Function on the card against the same Function
    on the CPU (plain forward), rtol 2e-2.  ReLU modes: >= 99.99% of each
    gradient's elements (a pre within rounding of 0 takes the other sign
    on one side and moves that feature's column)."""
    out = {}
    for key, src, xs, ys in (("card", p, x, y),
                             ("cpu", {n: v.cpu() for n, v in p.items()}, x.cpu(),
                              None if y is None else y.cpu())):
        q = {n: v.clone().requires_grad_(True) for n, v in src.items()}
        coder_loss(CC, mode, q, xs, ys, step, batch).backward()
        out[key] = {n: q[n].grad for n in q}
    for n, want in out["cpu"].items():
        got = out["card"][n].cpu()
        close = torch.isclose(got, want, rtol=2e-2, atol=2e-2 * float(want.abs().max()))
        share = float(close.float().mean())
        need = 0.9999 if CODER_MODES[mode][2] is None else 1.0
        check(share >= need, f"{what}: d{n} agrees with the CPU on {share:.5%} of elements")


def coder_kernel_phase(dev, CC) -> dict:
    """Phase 8: each mode at B=4096, sliced, at a row offset into a larger
    buffer, on a 1,792-row remainder and on ragged 100- and 1,000-row
    windows at an offset, and at B=32768 (the ReLU modes also at phase
    9's 128 rows, sliced and at a row offset), against its plain version;
    gradients; bit-identical losses run to run."""
    b, tail, wide, small = CODER_BATCHES[0], 1792, CODER_BATCHES[-1], 128
    errs = {}
    for i, mode in enumerate(CODER_MODES):
        xbuf, ybuf, p, k = coder_inputs(mode, 2 * b + tail, 30 + i, dev)
        ops = coder_ops(CC, p, k)
        err = 0.0
        wx, wy, wp, _ = coder_inputs(mode, wide, 40 + i, dev)
        windows = [
            ("sliced", xbuf[:b].contiguous(), None if ybuf is None else ybuf[:b].contiguous(),
             0, b, ops),
            ("offset", xbuf, ybuf, b, b, ops), ("remainder", xbuf, ybuf, 2 * b, tail, ops),
            ("ragged", xbuf, ybuf, 37, 100, ops), ("ragged", xbuf, ybuf, b + 300, 1000, ops),
            ("wide", wx, wy, 0, wide, coder_ops(CC, wp, k))]
        if k is None:  # phase 9's batch: the CLI's 128 rows, sliced and as a windowed step
            windows += [("sliced", xbuf[:small].contiguous(), None, 0, small, ops),
                        ("windowed", xbuf, None, 5 * small, small, ops)]
        for what, x, y, off, rows, o in windows:
            got = CC._coder_launch(x, y, off, rows, o, k)
            win = slice(off, off + rows)
            want = CC.coder_forward_plain(x[win], None if y is None else y[win], o, k)
            tag = f"{mode} {what} [{off}, {off + rows})"
            err = max(err, check_coder(got, want, k, tag))
            if k is not None:
                GAPS[tag] = selection_gaps(got.xc, o.we_t, o.b_enc, got.hid, want.hid, k, tag)
            del got, want
        del wx, wy
        a = CC._coder_launch(xbuf, ybuf, b, b, ops, k)
        a2 = CC._coder_launch(xbuf, ybuf, b, b, ops, k)
        torch.cuda.synchronize()
        check(all(u is None or torch.equal(u, v) for u, v in zip(a, a2)),
              f"{mode}: outputs not bit-identical run to run")
        gb = 1024
        gx, gy = xbuf[:2 * gb].contiguous(), None if ybuf is None else ybuf[:2 * gb].contiguous()
        coder_grads_close(CC, mode, p, gx[:gb], None if gy is None else gy[:gb], None, None,
                          f"{mode} sliced")
        coder_grads_close(CC, mode, p, gx, gy, 1, gb, f"{mode} windowed")
        errs[mode] = err
        also = f", on {small} rows sliced and at offset {5 * small}" if k is None else ""
        log(f"  {mode:16s}: agrees sliced, at offset {b}, on the {tail}-row remainder, on 100 "
            f"and 1,000 rows at an offset and at {wide} rows{also} (resid max abs err "
            f"{err:.3g}); loss bit-identical; gradients agree")
    return errs


def coder_config(work: Path) -> Path:
    """tiny_default.yaml with ``activation: relu``, one epoch, on phase 2's
    cache."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["sae"]["activation"] = "relu"
    cfg["training"].update(epochs=1, warmup_steps=200)
    cfg["data"]["cache_dir"] = str(work / "cache")
    cfg["output_dir"] = str(work / "rout")
    cfg["experiment_name"] = "relu_smoke"
    path = work / "relu_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def check_run(run_dir: Path, final: str, want_rows: int, what: str) -> list[float]:
    """A training run's files, its metric rows and a falling loss."""
    for name in (final, "metrics.json", "training_config.json"):
        check((run_dir / name).exists(), f"{what}: {name} missing")
    rows = json.loads((run_dir / "metrics.json").read_text())
    check(len(rows) == want_rows, f"{what}: metrics.json has {len(rows)} rows, not {want_rows}")
    losses = np.array([r["loss"] for r in rows])
    check(bool(np.isfinite(losses).all()), f"{what}: non-finite loss")
    n = max(1, min(100, len(losses) // 10))
    first, last = float(losses[:n].mean()), float(losses[-n:].mean())
    check(last < first, f"{what}: loss did not fall ({first:.5f} -> {last:.5f})")
    log(f"  {what}: {len(rows)} steps, loss {first:.5f} -> {last:.5f} (means of {n} steps)")
    return [first, last]


def coder_path(work: Path, dev, mix, train_mod, launch_mod, cfg_mod, cache_mod, sae_mod, TC, XC,
               CC, E) -> dict:
    """Phase 9: the ReLU SAE through the CLI, then extraction with the MLP
    pairs, the Skip and TopK transcoders and the TopK and ReLU crosscoders
    through ``whisper_sae_tpu_torch.launch``; launch counts, files, falling
    losses, and each trained family on the card against the CPU."""
    for e in CC.ENTRIES:
        e.launches = 0
    CC.mode_launches.clear()
    CC.plain_calls.clear()
    E.plain_calls.clear()
    res = {"losses": {}}

    t0 = time.perf_counter()
    (trainer,) = train_mod.main(["--config", str(coder_config(work)), "--layer", "encoder:0",
                                 "--no-wandb"]).values()
    res["relu_sae_train_s"] = time.perf_counter() - t0
    relu_dir = trainer.run_dir
    relu_steps = N_ROWS // 128
    res["losses"]["relu_sae"] = check_run(relu_dir, "sae_final.npz", relu_steps + 1,
                                          "ReLU SAE through the CLI")
    rows = json.loads((relu_dir / "metrics.json").read_text())
    check(all(r["sparsity_loss"] > 0 and r["reconstruction_loss"] < r["loss"] for r in rows),
          "ReLU SAE: metrics rows lack the L1 term")

    lcache, lout = work / "lcache", work / "lout"
    t0 = time.perf_counter()
    launch_mod.main(["extract", "--capture-mlp", "--random-whisper", "--dataset", "synthetic",
                     "--max-samples", str(LAUNCH_CLIPS), "--layers-encoder", "0,1,2,3",
                     "--layers-decoder", "", "--cache-dir", str(lcache)])
    res["extract_s"] = time.perf_counter() - t0
    cfg = cfg_mod.ExperimentConfig()
    cache = cache_mod.FeatureCache(lcache / "features", cfg.whisper, cfg.data)
    n_rows = LAUNCH_CLIPS * ENC_T
    for comp in ("encoder", "encoder_mlp_in", "encoder_mlp_out"):
        for layer in range(4):
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim) == (n_rows, D), f"{comp}:{layer}: {meta}")
    check(not cache.has_cache("decoder", 0), "extract wrote a decoder cache")
    log(f"  launch extract --capture-mlp: {LAUNCH_CLIPS} clips in {res['extract_s']:.1f} s, "
        f"4 layer caches and 4 (mlp_in, mlp_out) pairs of {n_rows} rows x {D}")

    epochs, lr = 2, "1e-2"
    steps = n_rows // CODER_B
    common = ["--epochs", str(epochs), "--learning-rate", lr, "--cache-dir", str(lcache),
              "--output-dir", str(lout)]
    jobs = (("skip_transcoder", ["train-transcoder", "--layer-idx", "0"],
             "launch_encoder_transcoder_layer0", "transcoder_final.npz"),
            ("topk_transcoder", ["train-transcoder", "--layer-idx", "0", "--no-skip",
                                 "--experiment-name", "topk"],
             "topk_encoder_transcoder_layer0", "transcoder_final.npz"),
            ("topk_crosscoder", ["train-crosscoder", "--layers", "0,1,2,3"],
             "launch_encoder_crosscoder_l0-1-2-3", "crosscoder_final.npz"),
            ("relu_crosscoder", ["train-crosscoder", "--layers", "0,1,2,3", "--relu",
                                 "--experiment-name", "relu"],
             "relu_encoder_crosscoder_l0-1-2-3", "crosscoder_final.npz"))
    res["job_s"] = {}
    for mode, args, run, final in jobs:
        t0 = time.perf_counter()
        out = launch_mod.main(args + common)
        torch.cuda.synchronize()
        res["job_s"][mode] = time.perf_counter() - t0
        check(out["run_dir"] == str(lout / run) and out["resumed_from"] is None,
              f"{mode}: run {out}")
        res["losses"][mode] = check_run(lout / run, final, epochs * (steps + 1),
                                        f"launch {' '.join(args[:1] + args[3:])}")

    launches = {e.__name__: e.launches for e in CC.ENTRIES}
    by_mode = {f"{entry}[{mode}]": n for (entry, mode), n in sorted(CC.mode_launches.items())}
    log(f"  coder launches: {by_mode}; plain-version calls {dict(CC.plain_calls)}, "
        f"encoder plain calls {dict(E.plain_calls)}")
    windowed = {"relu_sae": relu_steps, "skip_transcoder": epochs * steps,
                "topk_transcoder": epochs * steps, "topk_crosscoder": epochs * steps,
                "relu_crosscoder": epochs * steps}
    for mode, want in windowed.items():
        entry = ("fused_relu_sae_loss" if mode == "relu_sae" else "fused_relu_crosscoder_loss"
                 if mode == "relu_crosscoder" else "fused_transcoder_loss")
        got = CC.mode_launches[(entry + "_indexed", mode)]
        check(got == want, f"{mode}: {got} windowed launches != {want} windowed steps")
        epochs_run = 1 if mode == "relu_sae" else epochs
        check(CC.mode_launches[(entry, mode)] >= epochs_run,
              f"{mode}: {CC.mode_launches[(entry, mode)]} sliced launches, under one an epoch")
    check(sum(CC.plain_calls.values()) == 0 and sum(E.plain_calls.values()) == 0,
          f"plain versions ran on the card: {dict(CC.plain_calls)} {dict(E.plain_calls)}")

    # each trained family on 512 rows: the card against the same model on the CPU
    x_in, _ = cache.load("encoder_mlp_in", 0)
    y_out, _ = cache.load("encoder_mlp_out", 0)
    stack = torch.stack([cache.load("encoder", layer)[0][:512] for layer in range(4)], dim=1)
    rows = gaussian_rows(512, torch.Generator(device=dev).manual_seed(98), mix)
    models = (("relu_sae", lambda d: sae_mod.load_trained_sae(relu_dir, device=d), (rows,)),
              ("skip_transcoder", lambda d: TC.load_trained_transcoder(
                  lout / jobs[0][2], device=d), (x_in[:512], y_out[:512])),
              ("topk_crosscoder", lambda d: XC.load_trained_crosscoder(
                  lout / jobs[2][2], device=d), (stack,)),
              ("relu_crosscoder", lambda d: XC.load_trained_crosscoder(
                  lout / jobs[3][2], device=d), (stack,)))
    for name, load, inputs in models:
        with torch.no_grad():
            card = load(None)(*(a.to(dev) for a in inputs))
            cpu = load("cpu")(*(a.cpu() for a in inputs))
        rel = abs(float(card.loss) - float(cpu.loss)) / float(cpu.loss)
        share = float(agree(card.hidden.cpu(), cpu.hidden).float().mean())
        check(bool(torch.isfinite(card.loss)) and rel < 1e-3 and share >= 0.99,
              f"{name}: card vs CPU on 512 rows: loss rel err {rel:.3g}, {share:.2%} rows agree")
        log(f"  trained {name} on 512 rows, card vs CPU: loss rel err {rel:.2g}, "
            f"{share:.2%} rows select the same features")
    shutil.rmtree(lcache, ignore_errors=True)
    shutil.rmtree(work / "cache", ignore_errors=True)
    res.update(launches=launches, by_mode=dict(CC.mode_launches), relu_trainer=trainer)
    return res


def coder_bound(mode: str, b: int, x, nnz: int, geom: tuple | None = None,
                passes: float | None = None) -> tuple[float, str]:
    """Least time of one coder launch (at whisper-tiny width, or at
    ``geom`` = (D, dout, H)): x (and y) read, the bf16 weights and biases
    read, latent, residual and bf16 rows written; encode, the decode of
    this run's nonzero latents and the skip product on the tensor cores;
    the bisection's compares in TopK modes (32 passes over each pre, or
    ``passes``, this run's passes summed over its rows, each over a row)."""
    d, dout, k, skip, y_is_x = CODER_MODES[mode]
    h = H
    if geom is not None:
        d, dout, h = geom
    nbytes = (b * d * x.element_size() + (0 if y_is_x else b * dout * 4)
              + (d * h + h * dout + (d * dout if skip else 0)) * 2 + (h + dout) * 4
              + b * h * 2 + b * dout * 4 + b * d * 2 + (h + 1) * 4 + (0 if k else h * 4))
    flops = 2 * b * d * h + 2 * nnz * dout + (2 * b * d * dout if skip else 0)
    alu = (32 * b if passes is None else passes) * h if k else b * h
    return bound(nbytes, flops, alu)


def coder_times(dev, CC) -> dict:
    """Phase 10a: each mode at B=128, 4096 and 32768, sliced and at a row
    offset, beside its plain version, its bound and a library yardstick
    (the bf16 encode product, plus the dense decode product in ReLU modes),
    and each of its launches' device ms."""
    res = {}
    for b in CODER_TIME_BATCHES:
        for i, mode in enumerate(CODER_MODES):
            xbuf, ybuf, p, k = coder_inputs(mode, 2 * b, 50 + i, dev)
            ops = coder_ops(CC, p, k)
            x, y = xbuf[:b].contiguous(), None if ybuf is None else ybuf[:b].contiguous()
            out = CC._coder_launch(x, y, 0, b, ops, k)
            nnz = int((out.hid > 0).sum())
            xc, we, wd = x.bfloat16(), p["w_enc"].bfloat16(), p["w_dec"].bfloat16()
            lib = (lambda: torch.matmul(torch.matmul(xc, we), wd)) if k is None else (
                lambda: torch.matmul(xc, we))
            iters = 5 if b > CODER_BATCHES[0] else 20
            sliced = lambda: CC._coder_launch(x, y, 0, b, ops, k)  # noqa: E731
            indexed = lambda: CC._coder_launch(xbuf, ybuf, b, b, ops, k)  # noqa: E731
            res[(mode, b)] = {
                "ms": time_ms(sliced, iters=iters),
                "indexed_ms": time_ms(indexed, iters=iters),
                "plain_ms": time_ms(lambda: CC.coder_forward_plain(x, y, ops, k), iters=3,
                                    warmup=1),
                **dict(zip(("bound_ms", "bound_by"), coder_bound(mode, b, x, nnz))),
                "library_ms": time_ms(lib, iters=iters),
                "nnz_per_row": nnz / b,
            }
            r = res[(mode, b)]
            parts = RELU_PARTS if k is None else SKIP_PARTS if "w_skip" in p else TOPK_PARTS
            r["split_ms"] = launch_split(sliced, parts)
            r["indexed_split_ms"] = launch_split(indexed, parts)
            log(f"  {mode:16s} B={b:5d}: {r['ms']:.4f} ms (at an offset {r['indexed_ms']:.4f}), "
                f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
                f"library {r['library_ms']:.4f}, {r['nnz_per_row']:.1f} nonzero latents a row"
                "; launches in ms: " + ", ".join(
                    f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                    for k_, v in r["split_ms"].items()))
            del xbuf, ybuf, x, y, out
    return res


def coder_step_times(work: Path, dev, TC, XC, CT, cfg_mod, relu_trainer, mix) -> dict:
    """Phase 10b: one training step of phase 9's ReLU SAE at the CLI's batch
    128, and of the Skip transcoder, the ReLU crosscoder and the TopK
    crosscoder under AMP (windowed kernel) at the launcher's batch 4096 and
    bench.py's 32768, wall and device busy time, on random rows on the
    card."""
    g = torch.Generator(device=dev).manual_seed(61)
    log(f"  ReLU SAE (D=384, H=3072), batch {relu_trainer.config.batch_size}:")
    res = {"relu_sae_128": step_profile(relu_trainer, gaussian_rows(
        200 * relu_trainer.config.batch_size, g, mix), 200)}
    for b, steps in ((CODER_B, 20), (CODER_BATCHES[-1], 6)):
        n = steps * b
        cfg = cfg_mod.TrainingConfig(batch_size=b, warmup_steps=10, use_amp=True)
        log(f"  Skip transcoder (D=384, H=3072, k=32), batch {b}:")
        tc = CT.TranscoderTrainer(TC.create_transcoder(D, D, H, k=K, use_skip=True, device=dev),
                                  cfg, run_dir=work / "tstep")
        res[f"skip_transcoder_{b}"] = step_profile(
            tc, (torch.randn(n, D, generator=g, device=dev),
                 torch.randn(n, D, generator=g, device=dev)), steps)
        log(f"  ReLU crosscoder (L=4, D=384, S=3072), batch {b}:")
        xc = CT.CrosscoderTrainer(XC.create_crosscoder(D, 4, H, use_topk=False, device=dev), cfg,
                                  run_dir=work / "xstep")
        res[f"relu_crosscoder_{b}"] = step_profile(
            xc, torch.randn(n, 4, D, generator=g, device=dev), steps)
        del xc
        log(f"  TopK crosscoder (L=4, D=384, S=3072, k=32), batch {b}:")
        xc = CT.CrosscoderTrainer(XC.create_crosscoder(D, 4, H, k=K, use_topk=True, device=dev),
                                  cfg, run_dir=work / "kstep")
        res[f"topk_crosscoder_{b}"] = step_profile(
            xc, torch.randn(n, 4, D, generator=g, device=dev), steps)
        del tc, xc
    return res


# ---------------------------------------------------------------------------
# phases 11-13: whisper-large 32x (the blocked encode, kernel C's wide form)
# ---------------------------------------------------------------------------


def large_kernel_phase(dev, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 11; returns the max abs error by kernel."""
    errs = {"fused_topk_encode_blocked": 0.0, "topk_mask_wide": 0.0}
    p = params(40, dev, DL, HL)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    g = torch.Generator(device=dev).manual_seed(41)
    args = (we_t, p["b_enc"], p["b_pre"], K)
    for rows in LARGE_CHECK_ROWS:
        x32 = torch.randn(rows, DL, generator=g, device=dev)
        for x in (x32, x32.bfloat16()):
            xc = (x.float() - p["b_pre"]).bfloat16()
            for out_dtype in (torch.bfloat16, torch.float32):
                what = f"blocked encode rows={rows} x {x.dtype} -> {out_dtype}"
                got = cuda_sae._topk_encode_launch(x, *args, out_dtype)
                want = cuda_sae.topk_encode_plain(x, *args, out_dtype)
                torch.cuda.synchronize()
                check(got.dtype == out_dtype and got.shape == (rows, HL), f"{what}: output")
                ok = agree(got, want)
                share = float(ok.float().mean())
                check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
                err = float((got[ok].float() - want[ok].float()).abs().max())
                check(err <= 1e-2 * float(want.float().abs().max()), f"{what}: values off by {err:.3g}")
                errs["fused_topk_encode_blocked"] = max(errs["fused_topk_encode_blocked"], err)
                log(f"  {what}: rows agreeing {share:.4%}, max abs err {err:.3g}")
                # the route selects on the kPre GEMM's pre of these rows
                GAPS[what] = selection_gaps(xc, we_t, p["b_enc"], got, want, K, what)
                del got, want
    a = cuda_sae._topk_encode_launch(x32, *args, torch.bfloat16)
    check(torch.equal(a, cuda_sae._topk_encode_launch(x32, *args, torch.bfloat16)),
          "blocked encode: two launches differ")
    del a

    # gradients through _TopKEncode against the CPU, on the rows whose
    # selection the card and the CPU agree on
    x = torch.randn(256, DL, generator=g, device=dev)
    card = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K)
    cpu = cuda_sae.topk_encode_plain(x.cpu(), we_t.cpu(), p["b_enc"].cpu(), p["b_pre"].cpu(), K,
                                     torch.bfloat16)
    ok = agree(card.cpu(), cpu)
    check(float(ok.float().mean()) >= 0.99, f"blocked encode on 256 rows: {int(ok.sum())} agree")
    x = x[ok.to(dev)].contiguous()
    gy = torch.randn(x.shape[0], HL, generator=torch.Generator().manual_seed(42))
    enc = ("w_enc", "b_enc", "b_pre")
    grads_close(lambda q: (cuda_sae.fused_topk_encode(x, q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                      torch.float32) * gy.to(dev)).sum(),
                {n: p[n] for n in enc},
                lambda q: (cuda_sae.fused_topk_encode(x.cpu(), q["w_enc"], q["b_enc"], q["b_pre"], K,
                                                      torch.float32) * gy).sum(),
                enc, "blocked encode")
    log(f"  blocked encode: two launches bit-identical; gradients on {x.shape[0]} agreeing rows "
        "of 256 agree with the CPU (rtol 2e-2)")

    # kernel C's wide form, exact
    pre = torch.randn(1024, HL, generator=g, device=dev)
    pre[:8] = torch.round(pre[:8] * 2) / 2  # exact ties at the threshold
    got = cuda_topk.topk_mask_fwd(pre, K)
    check(torch.equal(got, topk.topk_mask_plain(pre, K)), "topk_mask wide: differs from the plain version")
    check(int((got[8:] > 0).sum(1).min()) == K, "topk_mask wide: not k per row")
    log("  topk_mask wide [1024, 40960] with tie rows: equal to the plain version")
    return errs


def large_config(work: Path) -> Path:
    """tiny_default.yaml at whisper-large-v3's width, expansion 32, k 32,
    batch 8192, AMP, 2 epochs, a dead-feature threshold of 2 steps."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["whisper"]["model_name"] = "openai/whisper-large-v3"
    cfg["sae"].update(expansion_factor=HL // DL, k=K, dead_feature_threshold=2)
    cfg["training"].update(batch_size=BL, use_amp=True, epochs=LARGE_EPOCHS, warmup_steps=2,
                           learning_rate=1e-3)
    cfg["data"]["cache_dir"] = str(work / "lgcache")
    cfg["output_dir"] = str(work / "lgout")
    cfg["experiment_name"] = "large_smoke"
    path = work / "large_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def large_path(work: Path, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk,
               topk) -> dict:
    """Phase 12; returns the trainer, launches by kernel and the losses."""
    path = large_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    check(cfg.whisper.hidden_dim == DL and cfg.sae.get_hidden_dim(DL) == HL, "large config widths")
    cache = cache_mod.FeatureCache(work / "lgcache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0)
    gen = torch.Generator(device=dev).manual_seed(43)
    mix = torch.randn(RANK, DL, generator=gen, device=dev) / RANK ** 0.5
    for _ in range(LARGE_STEPS):
        writer.append(gaussian_rows(BL, gen, mix).cpu().numpy())
    writer.finalize(num_samples=LARGE_STEPS * BL // 1500)
    steps = LARGE_EPOCHS * LARGE_STEPS

    class Trainer(train_mod.SAETrainer):
        """The CLI's trainer with the resample due at the last step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, resample_dead_every=steps, **kw)

    kernels = (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed, cuda_sae.fused_topk_encode,
               cuda_sae.sae_topk_backward)
    for w in kernels:
        w.launches = 0
    cuda_sae.fused_topk_encode.blocked_launches = cuda_sae.sae_topk_backward.composed_launches = 0
    cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    cli_trainer, train_mod.SAETrainer = train_mod.SAETrainer, Trainer
    try:
        t0 = time.perf_counter()
        (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:0",
                                     "--no-wandb"]).values()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        train_mod.SAETrainer = cli_trainer
    launches = {w.__name__: w.launches for w in kernels}
    launches.update(fused_topk_encode_blocked=cuda_sae.fused_topk_encode.blocked_launches,
                    topk_mask=cuda_topk.topk_mask_fwd.launches,
                    topk_mask_wide=cuda_topk.topk_mask_fwd.wide_launches,
                    sae_topk_backward_composed=cuda_sae.sae_topk_backward.composed_launches)
    log(f"  CLI trained {steps} steps at batch {BL} in {train_s:.1f} s (cache load and setup "
        f"included); launches {launches}, plain-version calls {dict(topk.plain_calls)}")
    check(launches["fused_topk_encode_blocked"] == steps,
          f"{launches['fused_topk_encode_blocked']} blocked launches != {steps} steps")
    check(launches["sae_topk_backward"] == launches["sae_topk_backward_composed"] == steps,
          f"sae_topk_backward: {launches['sae_topk_backward']} launches "
          f"({launches['sae_topk_backward_composed']} composed) for {steps} composed steps")
    check(launches["fused_sae_loss"] == launches["fused_sae_loss_indexed"] == 0
          and launches["fused_topk_encode"] == 0, "kernels A or B launched at whisper-large width")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    check(trainer.num_resampled_total > 0 and launches["topk_mask_wide"] > 0,
          "the resample did not run through kernel C's wide form")
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([r["loss"] for r in rows])
    check(len(rows) == steps and bool(np.isfinite(losses).all()), f"metrics: {losses}")
    first, last = float(losses[:3].mean()), float(losses[-3:].mean())
    check(last < first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    with np.load(trainer.run_dir / "sae_final.npz") as z:
        check(z["w_enc"].shape == (DL, HL), "sae_final.npz shapes")
        check(all(bool(np.isfinite(z[n]).all()) for n in z.files), "non-finite parameters")
        check(bool(np.allclose(np.linalg.norm(z["w_dec"], axis=1), 1.0, rtol=1e-5)),
              "decoder rows are not unit norm")
    log(f"  loss {first:.5f} -> {last:.5f} (means of 3 steps), resampled "
        f"{trainer.num_resampled_total} features, decoder rows unit norm")

    # the trained SAE's f32 forward on the card against the CPU
    x = gaussian_rows(64, torch.Generator(device=dev).manual_seed(44), mix)
    with torch.no_grad():
        card = sae_mod.load_trained_sae(trainer.run_dir).eval()(x)
        cpu = sae_mod.load_trained_sae(trainer.run_dir, device="cpu").eval()(x.cpu())
    ok = agree(card.hidden.cpu(), cpu.hidden)
    err = float((card.hidden.cpu()[ok] - cpu.hidden[ok]).abs().max())
    check(float(ok.float().mean()) >= 0.999 and err <= 1e-2 * float(cpu.hidden.abs().max()),
          f"trained SAE, card vs CPU on 64 rows: {int(ok.sum())} rows agree, err {err:.3g}")
    rel = abs(float(card.loss) - float(cpu.loss)) / float(cpu.loss)
    log(f"  trained SAE's f32 forward on 64 rows, card vs CPU: {int(ok.sum())}/64 rows select "
        f"the same features, latent max abs err {err:.3g}, loss rel err {rel:.2g}")
    shutil.rmtree(work / "lgcache", ignore_errors=True)
    return {"trainer": trainer, "launches": launches, "losses": [first, last], "train_s": train_s}


def large_times(work: Path, dev, trainer, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 13: the blocked encode and kernel C's wide form at 8192 rows
    beside their plain versions, bounds and library yardsticks; one
    training step at batch 8192."""
    from whisper_sae_tpu_torch.ops import _build

    p = params(50, dev, DL, HL)
    we_t = cuda_sae._bf16_t(p["w_enc"])
    x = torch.randn(BL, DL, generator=torch.Generator(device=dev).manual_seed(51), device=dev)
    args = (x, we_t, p["b_enc"], p["b_pre"], K, torch.bfloat16)
    xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
    pre = (torch.matmul(xc.float(), w_bf.float()) + p["b_enc"]).contiguous()
    # the select's passes on this pre (it stops at a count of exactly k):
    # a compare and an add an element a pass, and the mask
    chunk = _build.topk_encode_chunk_rows(HL)
    passes = torch.cat([topk.cta_threshold(pre[r0:r0 + chunk], K)[2]
                        for r0 in range(0, BL, chunk)]).double()
    select_ops = float(2 * passes.sum() * HL + BL * HL)
    res = {}
    # x, W_enc^T and the biases in, the bf16 latent out; the product and the select
    b_bound = bound(BL * DL * 4 + DL * HL * 2 + (HL + DL) * 4 + BL * HL * 2, 2 * BL * DL * HL,
                    select_ops)
    launch = lambda: cuda_sae._topk_encode_launch(*args)  # noqa: E731
    split = launch_split(launch, BLOCKED_PARTS)
    chunks = -(-BL // chunk)
    res["fused_topk_encode_blocked"] = {
        "ms": time_ms(launch, iters=10, warmup=2),
        "plain_ms": time_ms(lambda: cuda_sae.topk_encode_plain(*args), iters=2, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), b_bound)),
        "library_ms": time_ms(lambda: torch.mm(xc, w_bf), iters=10, warmup=2),
        # device ms a call of each part, over the launches of all its chunks
        "split_ms": split,
        "select_passes_mean": float(passes.mean()),
        "select_passes_max": int(passes.max()),
    }
    enc_ms = res["fused_topk_encode_blocked"]["split_ms"]["encode"]
    res["fused_topk_encode_blocked"]["encode_tflops"] = (
        2 * BL * DL * HL / enc_ms / 1e9 if enc_ms else None)
    res["topk_mask_wide"] = {
        "ms": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10, warmup=2),
        "plain_ms": time_ms(lambda: topk.topk_mask_plain(pre, K), iters=2, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), bound(2 * BL * HL * 4, 0, select_ops))),
        "library_ms": time_ms(lambda: torch.topk(pre, K), iters=10, warmup=2),
    }
    for name, r in res.items():
        log(f"  {name:26s} B={BL}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}), library {r['library_ms']:.4f}")
    r = res["fused_topk_encode_blocked"]
    log(f"  blocked encode, device ms a call ({chunks} chunks of {chunk} rows): "
        + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                    for k_, v in r["split_ms"].items())
        + (f"; the product at {r['encode_tflops']:.1f} TFLOP/s" if r["encode_tflops"] else ""))
    log(f"  the select ran {r['select_passes_mean']:.2f} passes a row on average, "
        f"{r['select_passes_max']} at most (of 32); the f32 workspace adds "
        f"{1e3 * 2 * 4 * BL * HL / PEAK_BYTES:.4f} ms of HBM traffic beyond the bound")
    del pre, xc, w_bf, x
    log(f"  one training step at batch {BL} (D={DL}, H={HL}, k={K}, AMP):")
    stepper = type(trainer)(trainer.model, trainer.config, run_dir=work / "lgstep")
    rows = gaussian_rows(3 * BL, torch.Generator(device=dev).manual_seed(52),
                         torch.randn(RANK, DL, generator=torch.Generator(device=dev).manual_seed(53),
                                     device=dev) / RANK ** 0.5)
    res["step"] = step_profile(stepper, rows, 3)
    return res


# ---------------------------------------------------------------------------
# phases 14-18: whisper-large-v3 extraction, out of core, wide crosscoders
# ---------------------------------------------------------------------------


def large_extraction_config(work: Path) -> Path:
    """tiny_default.yaml naming whisper-large-v3, 16 synthetic clips, AMP,
    encoder layers 0 and 31 and decoder layer 31 captured."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["whisper"]["model_name"] = LV3
    cfg["encoder_layers"], cfg["decoder_layers"] = LG_ENC_LAYERS, LG_DEC_LAYERS
    cfg["data"].update(dataset_name="synthetic", max_samples=LG_CLIPS,
                       cache_dir=str(work / "lxcache"))
    cfg["training"]["use_amp"] = True
    cfg["output_dir"] = str(work / "lxout")
    cfg["experiment_name"] = "large_extract_smoke"
    path = work / "large_extract_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def large_extraction_path(work: Path, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E,
                          CE) -> dict:
    """Phase 15; returns launches by kernel, the CLI's clips/s and the
    bf16 weights (kept on the card for phase 16)."""
    path = large_extraction_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    arch = W.arch_for(LV3)
    d = arch.d_model
    reset_enc_launches(CE)
    E.plain_calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_mod.main(["--config", str(path), "--extract-only", "--random-whisper",
                          "--no-wandb"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    log(f"  CLI extracted {LG_CLIPS} whisper-large-v3 clips in {extract_s:.2f} s "
        f"({LG_CLIPS / extract_s:,.2f} clips/s end to end: weights made on the card, mel, the "
        f"32+32-layer forward, transfer, disk); launches {launches}, plain-version calls "
        f"{dict(E.plain_calls)}")
    check(out == {}, "--extract-only trained something")
    batches = -(-LG_CLIPS // train_mod.EXTRACT_BATCH)
    per_layer = arch.encoder_layers * batches
    want = {"conv_stem": batches, "ln_qkv": per_layer,
            "self_attention": per_layer, "out_proj": per_layer, "mlp_block": per_layer,
            "flash_self_attention": 0}
    check(launches == want, f"large extraction launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"plain versions ran on the card: {E.plain_calls}")

    # the caches against extract_activations on the first 2 clips, on the
    # weights the CLI made (the same generator, on the card)
    cache = cache_mod.FeatureCache(work / "lxcache" / "features", cfg.whisper, cfg.data)
    params = W.init_whisper(torch.Generator(device=dev).manual_seed(cfg.training.seed), arch)
    pb = W.cast_params(params, torch.bfloat16)
    del params
    ds = ds_mod.SyntheticSpeechDataset(LG_CLIPS, seed=cfg.training.seed, n_mels=arch.n_mels,
                                       device=dev)
    mel2 = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(2)])).to(dev)
    ref = W.extract_activations(pb, mel2, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16)
    for comp, layers, tokens in (("encoder", LG_ENC_LAYERS, ENC_T), ("decoder", LG_DEC_LAYERS, 1)):
        check(not cache.has_cache(comp, 1), f"{comp}:1 was not asked for")
        for layer in layers:
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples, meta.dtype)
                  == (LG_CLIPS * tokens, d, LG_CLIPS, "float32"), f"{comp}:{layer} metadata {meta}")
            rows, _ = cache.load(comp, layer)
            check(bool(torch.isfinite(rows).all()), f"{comp}:{layer}: non-finite rows")
            bar_check(rows[:2 * tokens], ref[comp][layer].reshape(-1, d), STACK_BAR,
                      f"{comp}:{layer} first 2 clips vs extract_activations")
            del rows
    log(f"  caches encoder:{LG_ENC_LAYERS} and decoder:{LG_DEC_LAYERS} of {LG_CLIPS} clips x "
        f"{d}: finite, first 2 clips within the stack bar of extract_activations")
    del ref
    shutil.rmtree(work / "lxcache", ignore_errors=True)

    # every layer of the fused route against the card's composed route,
    # from the same input
    enc = pb["encoder"]
    worst = {}
    with torch.no_grad(), W.f32_matmuls():
        mel = mel2.bfloat16()
        x = W.encoder_ops.conv_stem(mel, enc)
        bar_check(x, W.composed_stem(mel, enc), STACK_BAR, "stem: fused vs composed")
        for i in range(arch.encoder_layers):
            lp = W._layer(enc["layers"], i)
            y = W.encoder_ops.attention_block(x, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                              arch.num_heads)
            y = W.encoder_ops.mlp_block(y.reshape(-1, d), lp["ln2_g"], lp["ln2_b"],
                                        lp["mlp"]).reshape(x.shape)
            want_l = W._encoder_layer(x, lp, arch.num_heads)[0]
            bar_check(y, want_l, STACK_BAR, f"layer {i}: fused vs composed")
            dd = (y.float() - want_l.float()).abs()
            worst[i] = float(dd.mean() / want_l.float().abs().mean())
            x = y
    torch.cuda.synchronize()
    log(f"  2 clips, every layer fused vs composed from the same input: mean rel err max "
        f"{max(worst.values()):.3g} (layer {max(worst, key=worst.get)}), stack bar 2**-7")
    return {"launches": launches, "cli_clips_per_s": LG_CLIPS / extract_s,
            "extract_s": extract_s, "params": pb}


def large_batch_times(dev, W, pb: dict) -> dict:
    """Phase 16a: bench.py's whisper-large-v3 definition (batch 8, bf16,
    every layer captured in bf16, decoder on), 3 batches on the host clock
    after one warm batch, then 2 under ``torch.profiler``; the bound
    counts the encoder's products and the stem (the one-token decoder is
    under 0.1% of it)."""
    from torch.profiler import ProfilerActivity, profile

    arch = W.arch_for(LV3)
    d, t, n_mels = arch.d_model, ENC_T, arch.n_mels
    mels = torch.randn(3, LG_B, n_mels, 2 * t, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)

    def run(n):
        for i in range(n):
            W.extract_activations(pb, mels[i], arch, compute_dtype=torch.bfloat16,
                                  capture_dtype=torch.bfloat16)

    run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    flops = LG_B * (arch.encoder_layers * (24 * t * d * d + 4 * t * t * d)
                    + 2 * t * d * (6 * n_mels + 3 * d))
    res = {"batch_ms": 1e3 * dt / 3, "clips_per_s": 3 * LG_B / dt,
           "bound_ms": 1e3 * flops / PEAK_BF16, "gflop": flops / 1e9}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(2)
        torch.cuda.synchronize()
    kernels = device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    res["busy_ms"] = busy if busy > 0 else None
    log(f"  extract_activations, whisper-large-v3, batch {LG_B} bf16: {res['batch_ms']:.3f} ms a "
        f"batch, {res['clips_per_s']:,.2f} clips/s; operation bound {res['bound_ms']:.3f} ms "
        f"({res['gflop']:,.0f} GFLOP)")
    if busy <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        return res
    res["idle_share"] = max(0.0, 1 - busy / res["batch_ms"])
    log(f"  device busy {busy:.3f} ms a batch (profiled run), idle share "
        f"{res['idle_share']:.1%} of the unprofiled batch")
    res["top"] = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / 2
        res["top"].append([e.key[:60], ms, e.count // 2])
        log(f"    {ms:8.4f} ms/batch  {e.count // 2:3d}x  {e.key[:90]}")
    res["blocks"] = block_shares(prof, 2, busy)
    res["idle"] = idle_breakdown(prof, 2)
    res.update(batch_split(dev, W, pb, mels[0], arch))
    return res


def batch_split(dev, W, pb: dict, mel: torch.Tensor, arch) -> dict:
    """Phase 16a: the same batch's encoder (stem and 32 fused layers with
    the final-LN captures) and its one-token, 32-layer decoder apart, each
    on the host clock ending in a synchronise, 3 runs after a warm one."""
    def clock(fn, n: int = 3):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, out

    with torch.no_grad(), W.f32_matmuls():
        mel = mel.bfloat16()
        enc_ms, enc = clock(lambda: W.encoder_forward(pb, mel, arch, capture_final_ln=True,
                                                      capture_dtype=torch.bfloat16))
        bos = torch.full((mel.shape[0], 1), arch.decoder_start_token_id, device=dev)
        dec_ms, _ = clock(lambda: W.decoder_forward(pb, bos, enc[0], arch, with_mlp=True))
    log(f"  the batch's parts on the host clock: encoder_forward {enc_ms:.3f} ms, "
        f"decoder_forward (one token, {arch.decoder_layers} layers) {dec_ms:.3f} ms")
    return {"encoder_ms": enc_ms, "decoder_ms": dec_ms}


def idle_breakdown(prof, batches: int, top: int = 5, min_us: float = 10.0) -> dict:
    """Where the device idles in a profiled window.  The device's
    activities (kernels, copies, memsets) are merged into busy spans; a
    gap is the time between two spans.  Returns the gaps' count and
    total, the longest ``top`` with the host operations that ran during
    each (innermost CPU events, by overlap), and the host operations
    summed over every gap of at least ``min_us`` -- where no recorded
    operation ran, the host was in Python ("unrecorded").  ms a batch."""
    import bisect
    from collections import Counter

    from torch.autograd import DeviceType

    evs = prof.events()
    spans: list[list[float]] = []
    for s0, e0 in sorted((e.time_range.start, e.time_range.end) for e in device_ops(evs)):
        if spans and s0 <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e0)
        else:
            spans.append([s0, e0])
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] - a[1] >= min_us]
    all_gap_us = sum(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    starts = [g[0] for g in gaps]
    per_gap = [Counter() for _ in gaps]
    for e in evs:
        if e.device_type != DeviceType.CPU or e.cpu_children:
            continue
        s0, e0 = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(starts, e0) - 1
        while i >= 0 and gaps[i][1] > s0:
            o = min(e0, gaps[i][1]) - max(s0, gaps[i][0])
            if o > 0:
                per_gap[i][e.key] += o
            i -= 1
    total = Counter()
    for (g0, g1), c in zip(gaps, per_gap):
        c["unrecorded"] = max(0.0, (g1 - g0) - sum(c.values()))
        total.update(c)
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])[:top]
    res = {
        "gaps": len(spans) - 1, "gap_ms": all_gap_us / 1e3 / batches,
        "gaps_over_min": len(gaps),
        "gap_over_min_ms": sum(g1 - g0 for g0, g1 in gaps) / 1e3 / batches,
        "host_in_gaps_ms": [[k[:60], v / 1e3 / batches] for k, v in total.most_common(8)],
        "longest": [[(gaps[i][1] - gaps[i][0]) / 1e3,
                     [[k[:40], v / 1e3] for k, v in per_gap[i].most_common(3)]] for i in longest],
    }
    log(f"  device idle: {res['gaps']} gaps, {res['gap_ms']:.3f} ms a batch between the first "
        f"and last device activity; {res['gaps_over_min']} gaps of >= {min_us:g} us hold "
        f"{res['gap_over_min_ms']:.3f} ms a batch; host operations in them (ms a batch): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["host_in_gaps_ms"]))
    for ms, ops in res["longest"]:
        log(f"    gap {ms:.4f} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ops))
    return res


def out_of_core_config(work: Path, cache: str = "ocache", name: str = "ooc_smoke") -> Path:
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["training"].update(epochs=1, warmup_steps=100)
    cfg["data"]["cache_dir"] = str(work / cache)
    cfg["output_dir"] = str(work / "oout")
    cfg["experiment_name"] = name
    path = work / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def out_of_core_path(work: Path, dev, train_mod, cfg_mod, cache_mod, cuda_sae, topk) -> dict:
    """Phase 17: a 2-shard cache trained through the CLI, streamed."""
    path = out_of_core_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    cache = cache_mod.FeatureCache(work / "ocache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0, shard_tokens=1 << 16)
    gen = torch.Generator(device=dev).manual_seed(81)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    for rows in (1 << 16, 1 << 15):  # the writer rolls a shard at an append
        writer.append(gaussian_rows(rows, gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=3 * (1 << 15) // 1500)
    check(len(meta.shards) == 2, f"the cache has {len(meta.shards)} shards, not 2")
    run = streamed_cli(path, meta.num_tokens, train_mod, cfg_mod, cache_mod, cuda_sae, topk)
    shutil.rmtree(work / "ocache", ignore_errors=True)
    return {k: run[k] for k in ("launches", "steps", "train_s", "losses")}


def streamed_cli(path: Path, n: int, train_mod, cfg_mod, cache_mod, cuda_sae, topk) -> dict:
    """Train through the CLI (config ``path``) on a cache of ``n`` rows in
    more than one shard, which its ``PrefetchLoader`` streams batch by
    batch: kernel A's counts zeroed first, one sliced launch a step, no
    plain version, the run's files and a falling loss.  Returns the
    launches, steps, seconds, losses, the loader and the trainer."""
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    loaders = []
    real = cache_mod.FeatureCache.get_dataloader

    def spy(self, *a, **kw):
        loaders.append(real(self, *a, **kw))
        return loaders[-1]

    for w in (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed):
        w.launches = 0
    topk.plain_calls.clear()
    cache_mod.FeatureCache.get_dataloader = spy
    try:
        t0 = time.perf_counter()
        (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:0",
                                     "--no-wandb"]).values()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        cache_mod.FeatureCache.get_dataloader = real
    steps = -(-n // cfg.training.batch_size)
    launches = {"fused_sae_loss": cuda_sae.fused_sae_loss.launches,
                "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed.launches}
    (loader,) = loaders
    check(isinstance(loader, cache_mod.PrefetchLoader) and loader.reader.num_rows == n,
          f"the CLI loaded the 2-shard cache as {type(loader).__name__}")
    check(launches == {"fused_sae_loss": steps, "fused_sae_loss_indexed": 0},
          f"streamed launches {launches}, not one sliced launch for each of {steps} steps")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    check(len(trainer._resample_dataset) == 8 * trainer.resample_batch_size,
          f"resample set of {len(trainer._resample_dataset)} rows")
    losses = check_run(trainer.run_dir, "sae_final.npz", steps, "2-shard cache through the CLI")
    log(f"  {n} rows in 2 shards streamed batch by batch ({'native' if loader.reader.native else 'memmap'} "
        f"gather): {steps} steps in {train_s:.1f} s ({n / train_s:,.0f} act/s end to end), "
        f"launches {launches}, resample set {len(trainer._resample_dataset)} rows")
    return {"launches": launches, "steps": steps, "train_s": train_s, "losses": losses,
            "loader": loader, "trainer": trainer}


def wide_coder_path(work: Path, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_topk,
                    topk) -> dict:
    """Phase 18: the crosscoder at S=6144 and the transcoder above
    ``--max-resident-gb``, through the launcher, on synthetic caches."""
    cfg = cfg_mod.ExperimentConfig()
    wcache, wout = work / "wcache", work / "wout"
    cache = cache_mod.FeatureCache(wcache / "features", cfg.whisper, cfg.data)
    n, b, epochs = 8 * CODER_B, CODER_B, 2
    gen = torch.Generator(device=dev).manual_seed(91)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    x0 = gaussian_rows(n, gen, mix)
    x1 = 0.8 * x0 + 0.2 * gaussian_rows(n, gen, mix)
    for layer, rows in ((0, x0), (1, x1)):
        w = cache.writer("encoder", layer)
        w.append(rows.cpu().numpy())
        w.finalize(num_samples=n // 1500)
    wt = torch.randn(D, D, generator=gen, device=dev) / D ** 0.5
    for comp, rows in (("encoder_mlp_in", x0), ("encoder_mlp_out", torch.tanh(x0 @ wt))):
        w = cache.writer(comp, 0, shard_tokens=n // 2)
        for half in rows.split(n // 2):
            w.append(half.cpu().numpy())
        w.finalize(num_samples=n // 1500)
    for e in CC.ENTRIES:
        e.launches = 0
    CC.mode_launches.clear()
    CC.plain_calls.clear()
    cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    common = ["--batch-size", str(b), "--cache-dir", str(wcache), "--output-dir", str(wout)]
    res = {"losses": {}, "job_s": {}}
    s_wide = 16 * D
    # the ReLU crosscoder's loss rises after its first update in the JAX
    # package as in the port (the decoder starts at norm 0.1 a feature and
    # is renormalised to 1), and at 1e-2 overshoots to ~93 and ends 16
    # steps above its first; so it runs 4 epochs at 1e-3 and compares means
    # of 3 steps (both trajectories: tests/test_torch_port_crosscoder_wide.py
    # run as a script)
    for name, extra, eps in (("topk_crosscoder_s6144", ["--learning-rate", "1e-2"], epochs),
                             ("relu_crosscoder_s6144", ["--relu", "--learning-rate", "1e-3"], 4)):
        t0 = time.perf_counter()
        out = launch_mod.main(["train-crosscoder", "--layers", "0,1", "--expansion-factor", "16",
                               "--experiment-name", name, "--epochs", str(eps), *extra, *common])
        torch.cuda.synchronize()
        res["job_s"][name] = time.perf_counter() - t0
        with np.load(Path(out["run_dir"]) / "crosscoder_final.npz") as z:
            check(z["w_enc"].shape == (2, D, s_wide), f"{name}: w_enc {z['w_enc'].shape}")
        res["losses"][name] = check_run(Path(out["run_dir"]), "crosscoder_final.npz",
                                        eps * (n // b), f"launch train-crosscoder S={s_wide}"
                                        + (" --relu" if "--relu" in extra else ""))
    # every TopK and ReLU step on the coder kernel past H = 3072 (windowed:
    # the resident cache, 8 steps an epoch and no remainder)
    res["launches"] = {"topk_crosscoder": CC.fused_transcoder_loss_indexed.wide_launches,
                       "relu_crosscoder": CC.fused_relu_crosscoder_loss_indexed.wide_launches}
    res["topk_mask_wide_launches"] = cuda_topk.topk_mask_fwd.wide_launches
    for mode, entry, eps in (("topk_crosscoder", CC.fused_transcoder_loss_indexed, epochs),
                             ("relu_crosscoder", CC.fused_relu_crosscoder_loss_indexed, 4)):
        steps = eps * (n // b)
        check(entry.wide_launches == entry.launches == CC.mode_launches[(entry.__name__, mode)]
              == steps, f"{mode} at S={s_wide}: {entry.launches} windowed launches ("
              f"{entry.wide_launches} wide) for {steps} steps")
    sliced = sum(e.launches for e in CC.ENTRIES if not e.__name__.endswith("_indexed"))
    check(sliced == 0, f"{sliced} sliced coder launches at S={s_wide}")
    check(sum(CC.plain_calls.values()) == 0 and sum(topk.plain_calls.values()) == 0,
          f"plain versions ran: {dict(CC.plain_calls)} {dict(topk.plain_calls)}")

    chunks = []
    cls = launch_mod.TranscoderTrainer
    real = cls.train_epoch_out_of_core

    def spy(self, reader, *a, **kw):
        chunks.append(reader.num_rows)
        return real(self, reader, *a, **kw)

    cls.train_epoch_out_of_core = spy
    try:
        t0 = time.perf_counter()
        out = launch_mod.main(["train-transcoder", "--layer-idx", "0", "--max-resident-gb",
                               "0.01", "--experiment-name", "ooc", "--learning-rate", "1e-2",
                               "--epochs", str(epochs), *common])
        torch.cuda.synchronize()
        res["job_s"]["skip_transcoder_out_of_core"] = time.perf_counter() - t0
    finally:
        del cls.train_epoch_out_of_core
    windowed = CC.mode_launches[("fused_transcoder_loss_indexed", "skip_transcoder")]
    check(chunks == [n] * epochs, f"out-of-core epochs over {chunks} rows")
    check(windowed == epochs * (n // b), f"{windowed} windowed launches for {epochs * (n // b)} "
                                         "steps")
    res["losses"]["skip_transcoder_out_of_core"] = check_run(
        Path(out["run_dir"]), "transcoder_final.npz", epochs * (n // b),
        "launch train-transcoder above --max-resident-gb")
    log(f"  crosscoders at S={s_wide}: every step on the coder kernel past H = 3072 "
        f"({res['launches']}), kernel C's wide form {res['topk_mask_wide_launches']} times; the "
        f"transcoder streamed {len(chunks)} chunked epochs through the paired reader, {windowed} "
        f"windowed launches")
    shutil.rmtree(wcache, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 19: transcription and capture
# ---------------------------------------------------------------------------

DEC_CLIPS, DEC_LEN, PROF_LEN = 8, 64, 8  # 19a: large-v3 bf16; the profiled call's max_len
TINY = "openai/whisper-tiny"
TR_SYNTH, TR_BATCH, TR_LEN = 15, 16, 224  # 19b: the launcher, one batch of 16
DEC_PARTS = ("encoder_forward", "_decode_step")


def synthetic_audio(n: int, seed: int) -> np.ndarray:
    """``n`` 30 s clips of 0.1 x normal noise at 16 kHz, drawn and scaled
    as the transcribe job's synthetic clips."""
    return np.random.default_rng(seed).standard_normal((n, 30 * 16_000)).astype(np.float32) * 0.1


def frozen_steps(tokens: np.ndarray, eos: int) -> np.ndarray:
    """``[B, L - 1]``: the steps whose token the EOS freeze set."""
    hit = np.cumsum(tokens[:, 1:] == eos, axis=1)
    return np.concatenate([np.zeros((tokens.shape[0], 1), bool), hit[:, :-1] > 0], axis=1)


def token_gaps(tokens: np.ndarray, ref_logits: torch.Tensor, got_logits: torch.Tensor,
               steps: np.ndarray, what: str) -> None:
    """At the ``steps`` ``[L - 1, B]`` checked, a decoded token may differ
    from the reference logits' argmax only where the reference's top-1 to
    top-2 gap is under twice that step's max |d logit| on the row
    (``[L - 1, B, V]`` logits); each such step is logged in TOKEN_GAPS."""
    rows = TOKEN_GAPS.setdefault(what, [])
    ref_arg = ref_logits.argmax(-1).cpu().numpy()
    for t, r in zip(*np.nonzero((ref_arg != tokens[:, 1:].T) & steps)):
        top2 = torch.topk(ref_logits[t, r].float(), 2).values
        gap = float(top2[0] - top2[1])
        delta = float((got_logits[t, r].float().cpu() - ref_logits[t, r].float().cpu()).abs().max())
        rows.append({"step": int(t), "row": int(r), "token": int(tokens[r, t + 1]),
                     "ref": int(ref_arg[t, r]), "gap": gap, "max_abs_d_logit": delta})
        check(gap < 2 * delta, f"{what}: step {t} row {r} decodes {tokens[r, t + 1]} where the "
                               f"reference's argmax {ref_arg[t, r]} leads by {gap:.3g} >= 2 x "
                               f"{delta:.3g}")


def teacher_forced(W, params, arch, enc, tokens: torch.Tensor) -> torch.Tensor:
    """Each cached step's logits along ``tokens``: ``[L - 1, B, V]``."""
    with torch.no_grad(), W.f32_matmuls():
        state = W._decode_state(params, arch, enc, tokens.shape[1])
        return torch.stack([W._decode_step(params, arch, state, tokens[:, t], t)
                            for t in range(tokens.shape[1] - 1)])


@contextlib.contextmanager
def annotated_decode(W):
    """The cached decode's encoder and each of its steps inside a
    ``torch.profiler.record_function`` range ``dec.<name>``, for a profiled
    run only."""
    from torch.profiler import record_function

    saved = {name: getattr(W, name) for name in DEC_PARTS}

    def wrap(name, fn):
        def annotated(*args, **kwargs):
            with record_function(f"dec.{name}"):
                return fn(*args, **kwargs)
        return annotated

    for name, fn in saved.items():
        setattr(W, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(W, name, fn)


def range_busy(prof, name: str) -> float:
    """Device busy ms of the kernels that ran inside the ``name`` ranges'
    device spans (the ranges follow each other on one stream)."""
    import bisect

    from torch.autograd import DeviceType

    evs = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.device_type == DeviceType.CUDA and e.key == name)
    starts = [a for a, _ in spans]
    us = 0.0
    for e in device_ops(evs):
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            us += e.time_range.end - e.time_range.start
    return us / 1e3


def encoder_agreement(W, pb: dict, mel, arch, enc) -> dict:
    """Phase 19a's encoder: each of the fused route's layers against the
    composed route's layer from the same input (the composed route's
    previous layer output) at the stack bar; and the whole stack's final
    hidden, where bf16 rounding in two orders adds up over 32 layers:
    the fused route no farther from the f32 route (the same bf16 weights
    widened, TF32 off) than 1.25 x the composed route is, max and mean."""
    enc_c, comp_layers = W.encoder_forward(pb, mel, arch, use_fused=False)
    x = W.encoder_ops.conv_stem(mel, pb["encoder"])
    bar_check(x, W.composed_stem(mel, pb["encoder"]), STACK_BAR, "decode stem: fused vs composed")
    worst = 0.0
    for i in range(arch.encoder_layers):
        lp = W._layer(pb["encoder"]["layers"], i)
        x_in = comp_layers[i - 1] if i else x
        y = W.encoder_ops.attention_block(x_in, lp["ln1_g"], lp["ln1_b"], lp["attn"],
                                          arch.num_heads)
        y = W.encoder_ops.mlp_block(y.reshape(-1, arch.d_model), lp["ln2_g"], lp["ln2_b"],
                                    lp["mlp"]).reshape(x_in.shape)
        want = W._encoder_layer(x_in, lp, arch.num_heads)[0]
        bar_check(y, want, STACK_BAR, f"decode encoder layer {i}: fused vs composed")
        worst = max(worst, rel_err(y, want)[1])
    del comp_layers
    p32 = {"encoder": W._tree_map(lambda a: a.float(), pb["encoder"])}
    enc_32 = W.encoder_forward(p32, mel.float(), arch)[0]
    res = {"layer_mean_rel_worst": worst, "fused_vs_composed": rel_err(enc, enc_c),
           "fused_vs_f32": rel_err(enc, enc_32), "composed_vs_f32": rel_err(enc_c, enc_32)}
    check(res["fused_vs_f32"][0] <= 1.25 * res["composed_vs_f32"][0]
          and res["fused_vs_f32"][1] <= 1.25 * res["composed_vs_f32"][1],
          f"decode encoder hidden: fused route's error against f32 {res['fused_vs_f32']} above "
          f"1.25 x the composed route's {res['composed_vs_f32']}")
    log(f"  encoder: each layer fused vs composed from the same input within the stack bar "
        f"(worst mean rel {worst:.3g}); the final hidden (max rel, mean rel) fused vs composed "
        f"{tuple(round(v, 5) for v in res['fused_vs_composed'])}, against the f32 route: fused "
        f"{tuple(round(v, 5) for v in res['fused_vs_f32'])}, composed "
        f"{tuple(round(v, 5) for v in res['composed_vs_f32'])}")
    return res


DEC_GAPS = "19a large-v3 bf16: cached tokens vs decoder_forward"


def decoder_agreement(W, pb: dict, arch, enc, tok: np.ndarray, tokl, frozen) -> dict:
    """Phase 19a's decoder, teacher-forced along the cached tokens: the
    cached steps against the full-sequence ``decoder_forward`` +
    ``decoder_logits``, (1) in f32 (the same weights widened, TF32 off)
    at the f32 bar, rtol 1e-4, atol 1e-5; (2) in bf16, where rounding in
    two orders adds up over 32 layers as in the encoder, each route
    against the f32 full-sequence logits: the cached steps no farther
    than 1.25 x the full sequence, max and mean; a token may differ from
    the bf16 full sequence's argmax only where the gap rule explains it."""
    got = teacher_forced(W, pb, arch, enc, tokl)
    ref = W.decoder_logits(pb, W.decoder_forward(pb, tokl[:, :-1], enc, arch)[0])
    ref = ref.transpose(0, 1).contiguous()  # [L - 1, B, V]
    check(bool(torch.isfinite(got).all()), "cached step logits: non-finite values")
    token_gaps(tok, ref, got, ~frozen.T, DEC_GAPS)
    p32 = {"decoder": W._tree_map(lambda a: a.float(), pb["decoder"])}
    enc32 = enc.float()
    got32 = teacher_forced(W, p32, arch, enc32, tokl)
    ref32 = W.decoder_logits(p32, W.decoder_forward(p32, tokl[:, :-1], enc32, arch)[0])
    ref32 = ref32.transpose(0, 1).contiguous()
    err32 = float((got32 - ref32).abs().max())
    check(torch.allclose(got32, ref32, rtol=1e-4, atol=1e-5),
          f"f32 cached step logits vs decoder_forward: max abs err {err32:.3g}")
    del got32
    res = {"f32_max_abs_err": err32, "bf16_cached_vs_full": rel_err(got, ref),
           "bf16_cached_vs_f32": rel_err(got, ref32), "bf16_full_vs_f32": rel_err(ref, ref32)}
    check(res["bf16_cached_vs_f32"][0] <= 1.25 * res["bf16_full_vs_f32"][0]
          and res["bf16_cached_vs_f32"][1] <= 1.25 * res["bf16_full_vs_f32"][1],
          f"bf16 cached steps' error against f32 {res['bf16_cached_vs_f32']} above 1.25 x the "
          f"full sequence's {res['bf16_full_vs_f32']}")
    log(f"  decoder, {tokl.shape[1] - 1} teacher-forced steps: f32 cached vs decoder_forward max "
        f"abs err {err32:.3g}; bf16 (max rel, mean rel) cached vs full "
        f"{tuple(round(v, 5) for v in res['bf16_cached_vs_full'])}, against f32: cached "
        f"{tuple(round(v, 5) for v in res['bf16_cached_vs_f32'])}, full "
        f"{tuple(round(v, 5) for v in res['bf16_full_vs_f32'])}")
    return res


def transcription_path(dev, W, E, CE) -> dict:
    """Phase 19a; returns the launches, the times and (for 19c) the bf16
    weights and mel."""
    arch = W.arch_for(LV3)
    params = W.init_whisper(torch.Generator(device=dev).manual_seed(19), arch)
    pb = W.cast_params(params, torch.bfloat16)
    del params
    mel = W.log_mel_spectrogram(synthetic_audio(DEC_CLIPS, 19), n_mels=arch.n_mels,
                                device=dev).bfloat16()
    eos, start = arch.eos_token_id, arch.decoder_start_token_id
    finished = torch.zeros(3, dtype=torch.bool, device=dev)
    tie = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 0.0, 5.0], [0, 0, 0, 9.0]], device=dev)
    check(W._next_token(tie, -1, finished, eos).tolist() == [1, 0, 3],
          "argmax on the card does not take the first maximum")

    reset_enc_launches(CE)
    E.plain_calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = W.greedy_decode_cached(pb, mel, arch, max_len=DEC_LEN)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    log(f"  greedy_decode_cached, {DEC_CLIPS} clips, max_len {DEC_LEN}, bf16: first call "
        f"{first_s:.2f} s (weight layouts built); launches {launches}, plain-version calls "
        f"{dict(E.plain_calls)}")
    n = arch.encoder_layers
    want = {"conv_stem": 1, "ln_qkv": n, "self_attention": n, "out_proj": n, "mlp_block": n,
            "flash_self_attention": 0}
    check(launches == want, f"decode launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"plain versions ran on the card: {E.plain_calls}")
    tok = tokens.cpu().numpy()
    check(tokens.dtype == torch.int32 and tok.shape == (DEC_CLIPS, DEC_LEN)
          and tokens.device == mel.device, f"tokens {tokens.dtype} {tok.shape} {tokens.device}")
    check(bool((tok[:, 0] == start).all()), "column 0 is not the start token")
    frozen = frozen_steps(tok, eos)
    check(bool((tok[:, 1:][frozen] == eos).all()), "a row left EOS after emitting it")

    with torch.no_grad(), W.f32_matmuls():
        enc = W.encoder_forward(pb, mel, arch)[0]
        enc_err = encoder_agreement(W, pb, mel, arch, enc)
        tokl = tokens.long()
        dec_err = decoder_agreement(W, pb, arch, enc, tok, tokl, frozen)
    log(f"  {int((tok == eos).any(1).sum())} rows reached EOS; tokens differing from "
        f"decoder_forward's argmax: {len(TOKEN_GAPS[DEC_GAPS])}")
    res = {"launches": launches, "first_call_s": first_s, "encoder": enc_err, "decoder": dec_err,
           "pb": pb, "mel": mel}
    res.update(decode_times(W, pb, mel, arch))
    return res


def decode_times(W, pb: dict, mel, arch) -> dict:
    """Phase 19a's times on the host clock (after a warm run, ending in a
    synchronise): a whole decode call and the encoder; a step is (the
    call - the encoder) / 63, the cross K/V and the token choice
    included.  Then an 8-token call under ``torch.profiler`` (a 64-token
    one is ~300,000 events): device busy, the encoder's and the steps'
    parts (``dec.<part>`` ranges), the idle share of the same call
    unprofiled and of a step (its device busy against its host ms), the
    heaviest device operations."""
    from torch.profiler import ProfilerActivity, profile

    steps, prof_steps = DEC_LEN - 1, PROF_LEN - 1

    def clock(fn, n: int = 1) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    with torch.no_grad(), W.f32_matmuls():
        encode = lambda: W.encoder_forward(pb, mel, arch)  # noqa: E731
        encode()
        enc_ms = clock(encode, 3)
    call_ms = clock(lambda: W.greedy_decode_cached(pb, mel, arch, max_len=DEC_LEN))
    short = lambda: W.greedy_decode_cached(pb, mel, arch, max_len=PROF_LEN)  # noqa: E731
    short_ms = clock(short)
    res = {"call_ms": call_ms, "clips_per_s": DEC_CLIPS * 1e3 / call_ms,
           "tokens_per_s": DEC_CLIPS * steps * 1e3 / call_ms, "encoder_host_ms": enc_ms,
           "step_host_ms": (call_ms - enc_ms) / steps, "short_call_ms": short_ms}
    log(f"  decode call {call_ms:.1f} ms: {res['clips_per_s']:.3f} clips/s, "
        f"{res['tokens_per_s']:.1f} decoded tokens/s ({DEC_CLIPS} x {steps}); host clock: "
        f"encoder {enc_ms:.3f} ms, a step {res['step_host_ms']:.3f} ms; the {PROF_LEN}-token call "
        f"{short_ms:.1f} ms")
    with annotated_decode(W), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        short()
        torch.cuda.synchronize()
    kernels = device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log("  device busy time: not measured (the profiler saw no device time)")
        res.update(short_busy_ms=None, encoder_busy_ms=None, step_busy_ms=None,
                   short_idle_share=None, step_idle_share=None)
        return res
    res.update(short_busy_ms=busy, short_idle_share=max(0.0, 1 - busy / short_ms),
               encoder_busy_ms=range_busy(prof, "dec.encoder_forward"),
               step_busy_ms=range_busy(prof, "dec._decode_step") / prof_steps)
    res["step_idle_share"] = max(0.0, 1 - res["step_busy_ms"] / res["step_host_ms"])
    log(f"  the {PROF_LEN}-token call profiled: device busy {busy:.3f} ms (encoder "
        f"{res['encoder_busy_ms']:.3f} ms, a step {res['step_busy_ms']:.4f} ms), idle share "
        f"{res['short_idle_share']:.1%} of the same call unprofiled; a step's idle share "
        f"{res['step_idle_share']:.1%} (its busy ms against its host ms)")
    res["top"] = []
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        res["top"].append([e.key[:60], ms, e.count])
        log(f"    {ms:8.3f} ms/call  {e.count:5d}x  {e.key[:90]}")
    return res


def transcribe_cli_path(work: Path, dev, W, wavio) -> dict:
    """Phase 19b: the launcher's transcribe job (whisper-tiny, f32) in its
    own process, then the same weights and mel decoded on the CPU."""
    import os

    tdir = work / "transcribe"
    clips = tdir / "clips"
    clips.mkdir(parents=True)
    wav = clips / "clip.wav"
    wavio.write_wav(wav, synthetic_audio(1, 7)[0, :10 * 8000], sample_rate=8000)
    out_json = tdir / "transcripts.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisper_sae_tpu_torch.launch", "transcribe",
                           str(clips), "--random-whisper", "--num-synthetic", str(TR_SYNTH),
                           "--batch-size", str(TR_BATCH), "--max-len", str(TR_LEN),
                           "--output", str(out_json)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    job_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"launch transcribe failed: {proc.stderr[-2000:]}")
    saved = json.loads(out_json.read_text())
    names = [str(wav)] + [f"synthetic_{i}" for i in range(TR_SYNTH)]
    check(saved["num_clips"] == TR_BATCH and sorted(saved["transcripts"]) == sorted(names),
          f"transcripts for {sorted(saved['transcripts'])}")
    arch = W.arch_for(TINY)
    eos = arch.eos_token_id
    card = np.full((TR_BATCH, TR_LEN), eos, np.int64)
    for r, name in enumerate(names):
        ids = saved["transcripts"][name]["token_ids"]
        check(1 <= len(ids) <= TR_LEN and ids[0] == arch.decoder_start_token_id, f"{name}: {ids}")
        card[r, :len(ids)] = ids
    log(f"  launch transcribe ({TR_BATCH} clips, whisper-tiny f32, max_len {TR_LEN}): "
        f"{job_s:.2f} s in its own process, the job's elapsed_s {saved['elapsed_s']}; "
        f"{TR_BATCH} transcripts of {min(map(len, (saved['transcripts'][n]['token_ids'] for n in names)))}"
        f"-{max(map(len, (saved['transcripts'][n]['token_ids'] for n in names)))} ids")

    # the job's weights (a CUDA generator seeded 0) and mel, decoded on the CPU
    params = W.init_whisper(torch.Generator(device=dev).manual_seed(0), arch)
    audio, rate = wavio.read_wav(wav)
    rows = [np.pad(wavio.resample(audio, rate, 16_000), (0, 30 * 16_000 - 10 * 16_000))]
    rows += list(synthetic_audio(TR_SYNTH, 0))
    mel = W.log_mel_spectrogram(np.stack(rows), n_mels=arch.n_mels, device=dev)
    pc, mc = W.params_to(params, "cpu"), mel.cpu()
    t0 = time.perf_counter()
    with torch.no_grad(), W.f32_matmuls():
        enc_c = W.encoder_forward(pc, mc, arch)[0]
    cpu = W.greedy_decode_cached(pc, None, arch, max_len=TR_LEN, encoder_hidden=enc_c).numpy()
    cpu_s = time.perf_counter() - t0
    differ = np.nonzero((cpu != card).any(1))[0]
    if len(differ):
        # teacher-forced along the card's tokens on both devices up to each
        # differing row's first difference
        first = {int(r): int(np.nonzero(cpu[r] != card[r])[0][0]) for r in differ}
        upto = max(first.values()) + 1
        rows_t = torch.tensor(sorted(first))
        tok = torch.from_numpy(card[rows_t.numpy(), :upto])
        with torch.no_grad(), W.f32_matmuls():
            enc_g = W.encoder_forward(params, mel[rows_t.to(dev)], arch)[0]
        got = teacher_forced(W, params, arch, enc_g, tok.to(dev)).cpu()
        ref = teacher_forced(W, pc, arch, enc_c[rows_t], tok)
        steps = np.zeros((upto - 1, len(first)), bool)
        for j, r in enumerate(sorted(first)):
            steps[first[r] - 1, j] = True
        token_gaps(card[rows_t.numpy(), :upto], ref, got, steps,
                   "19b whisper-tiny f32: card vs CPU")
    log(f"  the same weights and mel on the CPU (f32, {cpu_s:.1f} s): {TR_BATCH - len(differ)} of "
        f"{TR_BATCH} rows decode the same {TR_LEN} tokens"
        + (f"; rows {differ.tolist()} part where the gap rule explains it" if len(differ) else ""))
    return {"job_s": job_s, "cpu_s": cpu_s, "rows_differing": len(differ),
            "params": params, "mel": mel[:2], "tokens": card[:2]}


def facades_path(W, H, DA, a19: dict, b19: dict) -> dict:
    """Phase 19c."""
    arch = W.arch_for(LV3)
    pb, mel = a19["pb"], a19["mel"]
    enc_layers, dec_layers = [0, arch.encoder_layers - 1], [arch.decoder_layers - 1]
    got = H.extract_features_batch(pb, arch, mel, encoder_layers=enc_layers,
                                   decoder_layers=dec_layers, compute_dtype=torch.bfloat16)
    ref = W.extract_activations(pb, mel, arch, compute_dtype=torch.bfloat16)
    for comp, layers in (("encoder", enc_layers), ("decoder", dec_layers)):
        check(sorted(got[comp]) == layers, f"extract_features_batch {comp} layers {sorted(got[comp])}")
        for i in layers:
            check(np.array_equal(got[comp][i], ref[comp][i].cpu().numpy()),
                  f"extract_features_batch {comp}:{i} differs from extract_activations")
    del ref
    tiny = W.arch_for(TINY)
    params, mel_t = b19["params"], b19["mel"]
    prompt = torch.from_numpy(np.ascontiguousarray(b19["tokens"][:, :4]))
    pc, mc = W.params_to(params, "cpu"), mel_t.cpu()
    lens_g = DA.logit_lens(params, mel_t, tiny, token_ids=prompt.to(mel_t.device))
    lens_c = DA.logit_lens(pc, mc, tiny, token_ids=prompt)
    maps_g = DA.cross_attention_maps(params, mel_t, tiny, token_ids=prompt.to(mel_t.device))
    maps_c = DA.cross_attention_maps(pc, mc, tiny, token_ids=prompt)
    check(torch.equal(lens_g["token_ids"].cpu(), lens_c["token_ids"]),
          "logit_lens token ids: card vs CPU")
    check(torch.allclose(lens_g["probs"].cpu(), lens_c["probs"], rtol=1e-4, atol=0),
          "logit_lens probs: card vs CPU")
    check(torch.allclose(lens_g["logits_last"].cpu(), lens_c["logits_last"], rtol=1e-4, atol=1e-5),
          "logit_lens logits_last: card vs CPU")
    check(torch.allclose(maps_g.cpu(), maps_c, rtol=1e-4, atol=1e-6),
          "cross_attention_maps: card vs CPU")
    err = {"logit_lens_probs": float((lens_g["probs"].cpu() - lens_c["probs"]).abs().max()),
           "cross_attention_maps": float((maps_g.cpu() - maps_c).abs().max())}
    log(f"  extract_features_batch (bf16) encoder {enc_layers} and decoder {dec_layers} bit-equal to "
        f"extract_activations; logit_lens and cross_attention_maps at whisper-tiny, card vs "
        f"CPU, max abs err {err}")
    return err


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 20: kernel A's wide route; a whisper-small 8x TopK SAE through the CLI
# ---------------------------------------------------------------------------


def wide_kernel_phase(dev, cuda_sae) -> dict:
    """Phase 20a: kernel A's wide route against its plain version at every
    geometry of ``WIDE_GEOMS`` (4096 rows; whisper-small 8x also at 128 and
    32768: three chunks), sliced and at a row offset, at phase 1's bars;
    gradients through the Function at whisper-small 8x; at whisper-tiny
    its latent, residual and centred rows equal to the warp form's."""
    errs: dict[str, float] = {}
    for d, h in WIDE_GEOMS:
        for b in WIDE_BATCHES if (d, h) == (DS, HS) else (4096,):
            p = params(d + h + b, dev, d, h)
            gen = torch.Generator(device=dev).manual_seed(d + h + b + 1)
            x = torch.randn(b, d, generator=gen, device=dev)
            buf = torch.randn(3 * b, d, generator=gen, device=dev)
            check_kernel_a(cuda_sae, b, p, x, buf, errs, wide=True)
            if b == 4096:
                args = (cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], p["w_dec"].bfloat16(),
                        p["b_dec"] + p["b_pre"], K, True)
                form = check_select_form(lambda: cuda_sae._fused_loss_launch(x, 0, b, *args),
                                         WIDE_SELECT, "wst_sae_select_launches",
                                         h, b, f"fused_sae_loss_wide D={d} H={h}")
                FORMS["fused_sae_loss"][f"D={d} H={h}"] = form
                log(f"  fused_sae_loss_wide D={d} H={h}: the {form} form's select-and-decode, "
                    "as the dispatch names")
            if (d, h, b) == (DS, HS, 4096):
                # gradients against the CPU on the rows whose selection the
                # card and the CPU agree on (a row selecting differently
                # moves its features' gradients by more than the bar)
                we_t, wd = cuda_sae._bf16_t(p["w_enc"]), p["w_dec"].bfloat16()
                ops = (we_t, p["b_enc"], p["b_pre"], wd, p["b_dec"] + p["b_pre"], K)
                card = cuda_sae._fused_loss_launch(x, 0, b, *ops, True)[3]
                cpu = cuda_sae.fused_sae_loss_plain(x.cpu(), *(t.cpu() for t in ops[:-1]), K)[3]
                ok = agree(card.cpu(), cpu).to(dev)
                xs = x[ok].contiguous()
                n = xs.shape[0]
                check(n >= 0.999 * b, f"wide route vs the CPU on {b} rows: {n} select alike")
                bs = torch.cat([buf[:n], xs, buf[-n:]])
                grads_close(lambda q: cuda_sae.fused_sae_loss(xs, *(q[n_] for n_ in NAMES), K)[0], p,
                            lambda q: cuda_sae.fused_sae_loss(xs.cpu(), *(q[n_] for n_ in NAMES),
                                                              K)[0],
                            NAMES, "fused_sae_loss wide")
                grads_close(lambda q: cuda_sae.fused_sae_loss_indexed(
                                bs, 1, *(q[n_] for n_ in NAMES), K, n)[0], p,
                            lambda q: cuda_sae.fused_sae_loss_indexed(
                                bs.cpu(), 1, *(q[n_] for n_ in NAMES), K, n)[0],
                            NAMES, "fused_sae_loss_indexed wide")
                log(f"  gradients D={d} H={h} on the {n} of {b} rows the card and the CPU select "
                    f"alike: agree (rtol 2e-2)")
                del xs, bs
            del x, buf
    b = 4096
    p = params(b + 5, dev)
    gen = torch.Generator(device=dev).manual_seed(b + 6)
    x, buf = torch.randn(b, D, generator=gen, device=dev), torch.randn(3 * b, D, generator=gen, device=dev)
    we_t, wd, b_out = cuda_sae._bf16_t(p["w_enc"]), p["w_dec"].bfloat16(), p["b_dec"] + p["b_pre"]
    for data, off in ((x, 0), (buf, b)):
        wide, warp = (cuda_sae._fused_loss_launch(data, off, b, we_t, p["b_enc"], p["b_pre"], wd, b_out,
                                                  K, w) for w in (True, False))
        torch.cuda.synchronize()
        check(all(torch.equal(wide[i], warp[i]) for i in (3, 4, 5)),
              f"wide route at D={D} H={H}, offset {off}: latent, resid or xc differ from the warp form's")
        rel = abs(float(wide[0]) - float(warp[0])) / float(warp[0])
        log(f"  wide route at D={D} H={H} B={b}, offset {off}: latent, resid and xc equal to the "
            f"warp form's bit for bit; loss rel diff {rel:.3g} (partials a row against a CTA)")
    return errs


def small_config(work: Path) -> Path:
    """tiny_default.yaml at whisper-small's width (its own expansion 8, k,
    batch 128 and AMP), 2 epochs, a dead-feature threshold of 2 steps."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check((cfg["sae"]["k"], cfg["sae"]["expansion_factor"], cfg["training"]["batch_size"],
           cfg["training"]["use_amp"]) == (K, HS // DS, 128, True), "tiny_default.yaml widths changed")
    cfg["whisper"]["model_name"] = "openai/whisper-small"
    cfg["sae"]["dead_feature_threshold"] = 2
    cfg["training"].update(epochs=SMALL_EPOCHS, warmup_steps=50)
    cfg["data"]["cache_dir"] = str(work / "smcache")
    cfg["output_dir"] = str(work / "smout")
    cfg["experiment_name"] = "small_smoke"
    path = work / "small_smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def small_path(work: Path, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk,
               topk) -> dict:
    """Phase 20b: the whisper-small 8x TopK SAE through the CLI; returns the
    trainer, launches by kernel, the losses and the mixing matrix."""
    path = small_config(work)
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    check(cfg.whisper.hidden_dim == DS and cfg.sae.get_hidden_dim(DS) == HS, "small config widths")
    cache = cache_mod.FeatureCache(work / "smcache" / "features", cfg.whisper, cfg.data)
    writer = cache.writer("encoder", 0)
    gen = torch.Generator(device=dev).manual_seed(70)
    mix = torch.randn(RANK, DS, generator=gen, device=dev) / RANK ** 0.5
    writer.append(gaussian_rows(SMALL_ROWS, gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=SMALL_ROWS // 1500)
    check(meta.num_tokens == SMALL_ROWS and meta.hidden_dim == DS, "small cache metadata")
    windowed = SMALL_EPOCHS * (SMALL_ROWS // 128)
    steps = windowed + SMALL_EPOCHS  # one remainder step an epoch

    class Trainer(train_mod.SAETrainer):
        """The CLI's trainer with the resample due at the last step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, resample_dead_every=steps, **kw)

    a_entries = (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed)
    for w in a_entries:
        w.launches = w.wide_launches = 0
    cuda_sae.fused_topk_encode.launches = cuda_sae.fused_topk_encode.blocked_launches = 0
    cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    cli_trainer, train_mod.SAETrainer = train_mod.SAETrainer, Trainer
    try:
        t0 = time.perf_counter()
        (trainer,) = train_mod.main(["--config", str(path), "--layer", "encoder:0",
                                     "--no-wandb"]).values()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        train_mod.SAETrainer = cli_trainer
    launches = {}
    for w in a_entries:
        launches[w.__name__] = w.launches
        launches[w.__name__ + "_wide"] = w.wide_launches
    launches.update(fused_topk_encode=cuda_sae.fused_topk_encode.launches,
                    fused_topk_encode_blocked=cuda_sae.fused_topk_encode.blocked_launches,
                    topk_mask=cuda_topk.topk_mask_fwd.launches,
                    topk_mask_wide=cuda_topk.topk_mask_fwd.wide_launches)
    log(f"  CLI trained {steps} steps at batch 128 (D={DS}, H={HS}, k={K}, AMP) in {train_s:.1f} s "
        f"(cache load and setup included); launches {launches}, plain-version calls "
        f"{dict(topk.plain_calls)}")
    check(launches["fused_sae_loss_indexed"] == launches["fused_sae_loss_indexed_wide"] == windowed,
          f"windowed launches {launches['fused_sae_loss_indexed']} (wide "
          f"{launches['fused_sae_loss_indexed_wide']}) != {windowed} windowed steps")
    check(launches["fused_sae_loss"] == launches["fused_sae_loss_wide"] == SMALL_EPOCHS,
          f"sliced launches {launches['fused_sae_loss']} (wide {launches['fused_sae_loss_wide']}) "
          f"!= {SMALL_EPOCHS} remainder steps")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    check(trainer.num_resampled_total > 0 and launches["topk_mask_wide"] > 0
          and launches["fused_topk_encode"] == 0,
          "the resample did not run through kernel C's wide form")
    rows = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([r["loss"] for r in rows])
    check(len(rows) == steps and bool(np.isfinite(losses).all()),
          f"metrics: {len(rows)} rows, finite {bool(np.isfinite(losses).all())}")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    check(last < first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    with np.load(trainer.run_dir / "sae_final.npz") as z:
        check(z["w_enc"].shape == (DS, HS), "sae_final.npz shapes")
        check(all(bool(np.isfinite(z[n]).all()) for n in z.files), "non-finite parameters")
        check(bool(np.allclose(np.linalg.norm(z["w_dec"], axis=1), 1.0, rtol=1e-5)),
              "decoder rows are not unit norm")
    log(f"  loss {first:.5f} -> {last:.5f} (means of 50 steps), every step one kernel-A launch on "
        f"the wide route, resampled {trainer.num_resampled_total} features, decoder rows unit norm")
    sae = sae_mod.load_trained_sae(trainer.run_dir).eval()
    eval_against_cpu(sae, gaussian_rows(512, torch.Generator(device=dev).manual_seed(71), mix),
                     sae_mod)
    shutil.rmtree(work / "smcache", ignore_errors=True)
    return {"trainer": trainer, "launches": launches, "losses": [first, last], "train_s": train_s,
            "mix": mix}


def wide_times(dev, cuda_sae, sae_mod, topk) -> dict:
    """Phase 20c at whisper-small 8x, 128 / 4096 / 32768 rows: the wide
    route (sliced and at an offset) and the composed route it replaces at
    these widths (``topk_sae_apply``'s bf16 forward: kernel B's top-k
    encode, the ``mm_f32`` decode, the loss) timed in turns, composed / wide /
    wide / composed; the plain version, the bound, the bf16 encode GEMM
    as the library yardstick, each launch's device ms."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    res: dict = {}
    p = params(60, dev, DS, HS)
    we_t, wd, b_out = cuda_sae._bf16_t(p["w_enc"]), p["w_dec"].bfloat16(), p["b_dec"] + p["b_pre"]
    for b in WIDE_BATCHES:
        gen = torch.Generator(device=dev).manual_seed(61 + b)
        x = torch.randn(b, DS, generator=gen, device=dev)
        buf = torch.cat([torch.randn_like(x), x, torch.randn_like(x)])
        xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
        _, _, active, hid, _, _ = cuda_sae._fused_loss_launch(x, 0, b, we_t, p["b_enc"], p["b_pre"],
                                                              wd, b_out, K, True)
        nnz, n_active = int((hid > 0).sum()), int(active.sum())
        # the select's passes on this pre (it stops at a count of exactly k)
        passes = topk.cta_threshold(mm_f32(xc, we_t.t()) + p["b_enc"], K)[2].double()
        # x, W_enc^T, the W_dec rows this batch selects, biases in; latent,
        # residual, centred rows, counts out; the encode, the sparse decode, the select
        nbytes = (b * DS * 4 + DS * HS * 2 + n_active * DS * 2 + (HS + 2 * DS) * 4
                  + b * HS * 2 + b * DS * 4 + b * DS * 2 + (HS + 1) * 4)
        bound_ms, by = bound(nbytes, 2 * b * DS * HS + 2 * nnz * DS,
                             float(2 * passes.sum() * HS + b * HS))
        wide = lambda: cuda_sae._fused_loss_launch(x, 0, b, we_t, p["b_enc"],  # noqa: E731
                                                   p["b_pre"], wd, b_out, K, True)
        with torch.no_grad():
            composed = lambda: sae_mod.topk_sae_apply(p, x, K, torch.bfloat16)  # noqa: E731
            turns = [time_ms(f) for f in (composed, wide, wide, composed)]
        r = {
            "ms": (turns[1] + turns[2]) / 2, "composed_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": turns,
            "indexed_ms": time_ms(lambda: cuda_sae._fused_loss_launch(
                buf, b, b, we_t, p["b_enc"], p["b_pre"], wd, b_out, K, True)),
            "plain_ms": time_ms(lambda: cuda_sae.fused_sae_loss_plain(
                x, we_t, p["b_enc"], p["b_pre"], wd, b_out, K), iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": time_ms(lambda: torch.matmul(xc, w_bf)),
            "split_ms": launch_split(wide, WIDE_PARTS),
            "select_passes_mean": float(passes.mean()),
        }
        res[b] = r
        log(f"  wide route B={b:5d}: {r['ms']:.4f} ms (turns {turns[1]:.4f}, {turns[2]:.4f}), at an "
            f"offset {r['indexed_ms']:.4f}; composed route {r['composed_ms']:.4f} (turns "
            f"{turns[0]:.4f}, {turns[3]:.4f}); plain {r['plain_ms']:.4f}, bound {bound_ms:.4f} "
            f"({by}), library {r['library_ms']:.4f}; device ms a call: "
            + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                        for k_, v in r["split_ms"].items()))
        del x, buf, xc, hid
    return res


def wide_step_times(work: Path, dev, trainer, mix) -> dict:
    """Phase 20c: a training step of phase 20b's SAE at the CLI's batch of
    128 (100 windowed steps) and at 32768 (3), host clock and device busy."""
    res = {"128": step_profile(trainer, gaussian_rows(
        100 * 128, torch.Generator(device=dev).manual_seed(72), mix), 100)}
    stepper = type(trainer)(trainer.model, trainer.config.model_copy(update={"batch_size": 32768}),
                            run_dir=work / "smstep")
    res["32768"] = step_profile(stepper, gaussian_rows(
        3 * 32768, torch.Generator(device=dev).manual_seed(73), mix), 3)
    return res


# ---------------------------------------------------------------------------
# phase 21: the coder kernel past H = 3072; a whisper-small 8x Skip
# transcoder through the launcher
# ---------------------------------------------------------------------------


def coder_wide_check(CC, mode: str, geom: tuple, b: int, seed: int, dev, errs: dict) -> None:
    """Phase 21a at one geometry and batch: the kernel (the TopK modes'
    wide route) against its plain version, sliced and at a row offset into
    an epoch buffer, at phase 8's bars, each row that selects differently
    through the gap rule; two launches bit-identical."""
    xbuf, ybuf, p, k = coder_inputs(mode, 2 * b + 64, seed, dev, geom)
    ops = coder_ops(CC, p, k)
    wide = k is not None
    err = 0.0
    for what, off in (("sliced", 0), ("offset", b + 64)):
        x = xbuf[:b].contiguous() if off == 0 else xbuf
        y = None if ybuf is None else (ybuf[:b].contiguous() if off == 0 else ybuf)
        got = CC._coder_launch(x, y, off, b, ops, k, wide)
        win = slice(off, off + b)
        want = CC.coder_forward_plain(x[win], None if y is None else y[win], ops, k)
        tag = f"{mode} D={geom[0]} H={geom[2]} B={b} {what}"
        err = max(err, check_coder(got, want, k, tag))
        if wide:
            GAPS[tag] = selection_gaps(got.xc, ops.we_t, ops.b_enc, got.hid, want.hid, k, tag)
        if off:
            again = CC._coder_launch(x, y, off, b, ops, k, wide)
            torch.cuda.synchronize()
            check(all(u is None or torch.equal(u, v) for u, v in zip(got, again)),
                  f"{tag}: outputs not bit-identical run to run")
            if wide and b == 4096:
                form = check_select_form(lambda: CC._coder_launch(x, y, off, b, ops, k, wide),
                                         CODER_WIDE_SELECT, "wst_coder_select_launches",
                                         geom[2], b, tag)
                FORMS["coder"][f"{mode} D={geom[0]} H={geom[2]}"] = form
        del got, want
    errs[mode] = max(errs.get(mode, 0.0), err)
    form = FORMS["coder"].get(f"{mode} D={geom[0]} H={geom[2]}") if wide and b == 4096 else None
    log(f"  {mode:16s} D={geom[0]:4d} dout={geom[1]:4d} H={geom[2]:5d} B={b:5d}: agrees sliced "
        f"and at offset {b + 64} (resid max abs err {err:.3g}), bit-identical run to run"
        + (f"; the {form} form's select-and-decode" if form else ""))


def coder_wide_grads(CC, mode: str, n: int, dev) -> None:
    """Phase 21a: gradients through the Function at whisper-small 8x on the
    card against the same Function on the CPU, on the rows whose selection
    the card and the CPU agree on (a row selecting differently moves its
    features' gradients by more than the bar); the Skip transcoder and the
    ReLU SAE also windowed."""
    x, y, p, k = coder_inputs(mode, n, 300 + len(mode), dev, (DS, DS, HS))
    if k is not None:
        ops = coder_ops(CC, p, k)
        card = CC._coder_launch(x, y, 0, n, ops, k, True).hid
        cpu = CC.coder_forward_plain(x.cpu(), None if y is None else y.cpu(),
                                     coder_ops(CC, {k_: v.cpu() for k_, v in p.items()}, k), k).hid
        ok = agree(card.cpu(), cpu).to(dev)
        check(int(ok.sum()) >= 0.99 * n, f"{mode}: {int(ok.sum())} of {n} rows select alike")
        x, y = x[ok].contiguous(), None if y is None else y[ok].contiguous()
    m = x.shape[0]
    coder_grads_close(CC, mode, p, x, y, None, None, f"{mode} wide sliced")
    if mode in ("skip_transcoder", "relu_sae"):
        xb = torch.cat([x, x.flip(0)])
        yb = None if y is None else torch.cat([y, y.flip(0)])
        coder_grads_close(CC, mode, p, xb, yb, 1, m, f"{mode} wide windowed")


def coder_wide_phase(dev, CC) -> dict:
    """Phase 21a: every geometry of ``CODER_WIDE_GEOMS`` at 4096 rows (the
    Skip transcoder at whisper-small 8x also at 128 and 32768: three
    chunks), gradients at whisper-small 8x, and the wide route equal to
    the warp form bit for bit where both hold the geometry."""
    errs: dict[str, float] = {}
    for i, (mode, d, dout, h) in enumerate(CODER_WIDE_GEOMS):
        first = (mode, d, h) == ("skip_transcoder", DS, HS)
        for b in CODER_WIDE_BATCHES if first else (4096,):
            coder_wide_check(CC, mode, (d, dout, h), b, 200 + 10 * i + b % 7, dev, errs)
    for mode in CODER_MODES:
        coder_wide_grads(CC, mode, 512, dev)
    log("  gradients at D=768 H=6144, 512 rows (the TopK modes on those selecting alike on the "
        "card and the CPU): agree (rtol 2e-2)")
    for mode in ("skip_transcoder", "topk_crosscoder"):  # (384, 3072) and L*D = 1536, S = 3072
        xbuf, ybuf, p, k = coder_inputs(mode, 4096 + 64, 260, dev)
        ops = coder_ops(CC, p, k)
        wide, warp = (CC._coder_launch(xbuf, ybuf, 64, 4096, ops, k, w) for w in (True, False))
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(wide, n), getattr(warp, n))
                   for n in ("hid", "resid", "xc", "l0", "active"))
        check(same, f"{mode} at H={H}: the wide route's latent or resid differ from the warp form's")
        rel = abs(float(wide.sq) - float(warp.sq)) / float(warp.sq)
        log(f"  {mode} at H={H} (D={CODER_MODES[mode][0]}), 4096 rows at offset 64: the wide "
            f"route's latent, resid, bf16 rows, l0 and active equal to the warp form's bit for "
            f"bit; sum of squares rel diff {rel:.3g} (partials a row against a CTA)")
    return errs


def small_coder_path(work: Path, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_sae, cuda_topk,
                     topk, TC) -> dict:
    """Phase 21b: ``launch train-transcoder`` at whisper-small 8x (D=768,
    H=6144, k=32, batch 4096, the Skip transcoder, then ``--no-skip``), 2
    epochs of 8 windowed steps on a synthetic 8 x 4096-row (mlp_in,
    mlp_out) cache; every step one windowed launch on the coder kernel's
    wide route, no sliced launch, no composed step, no plain version;
    losses finite and falling; the trained Skip transcoder on 512 rows on
    the card against the CPU."""
    whisper = cfg_mod.WhisperConfig(model_name="openai/whisper-small")
    scache, sout = work / "sccache", work / "scout"
    cache = cache_mod.FeatureCache(scache / "features", whisper, cfg_mod.DataConfig())
    n, b, epochs = 8 * CODER_B, CODER_B, 2
    gen = torch.Generator(device=dev).manual_seed(93)
    mix = torch.randn(RANK, DS, generator=gen, device=dev) / RANK ** 0.5
    x0 = gaussian_rows(n, gen, mix)
    wt = torch.randn(DS, DS, generator=gen, device=dev) / DS ** 0.5
    for comp, rows in (("encoder_mlp_in", x0), ("encoder_mlp_out", torch.tanh(x0 @ wt))):
        w = cache.writer(comp, 0)
        w.append(rows.cpu().numpy())
        meta = w.finalize(num_samples=n // 1500)
        check((meta.num_tokens, meta.hidden_dim) == (n, DS), f"{comp}: {meta}")
    steps = epochs * (n // b)
    res = {"losses": {}, "job_s": {}, "launches": {}}
    common = ["train-transcoder", "--layer-idx", "0", "--model-name", "openai/whisper-small",
              "--expansion-factor", str(HS // DS), "--batch-size", str(b), "--epochs", str(epochs),
              "--learning-rate", "1e-2", "--cache-dir", str(scache), "--output-dir", str(sout)]
    runs = {}
    for mode, extra in (("skip_transcoder", ["--experiment-name", "small"]),
                        ("topk_transcoder", ["--no-skip", "--experiment-name", "small_topk"])):
        for e in CC.ENTRIES:
            e.launches = e.wide_launches = 0
        CC.mode_launches.clear()
        CC.plain_calls.clear()
        topk.plain_calls.clear()
        enc = cuda_sae.fused_topk_encode
        enc.launches = enc.blocked_launches = 0
        cuda_topk.topk_mask_fwd.launches = cuda_topk.topk_mask_fwd.wide_launches = 0
        t0 = time.perf_counter()
        out = launch_mod.main(common + extra)
        torch.cuda.synchronize()
        res["job_s"][mode] = time.perf_counter() - t0
        runs[mode] = Path(out["run_dir"])
        win, sl = CC.fused_transcoder_loss_indexed, CC.fused_transcoder_loss
        res["launches"][mode] = win.wide_launches
        check(win.launches == win.wide_launches == CC.mode_launches[(win.__name__, mode)] == steps,
              f"{mode}: {win.launches} windowed launches ({win.wide_launches} wide) for {steps} "
              "steps")
        check(sl.launches == 0, f"{mode}: {sl.launches} sliced launches")
        composed = (enc.launches, enc.blocked_launches, cuda_topk.topk_mask_fwd.launches,
                    cuda_topk.topk_mask_fwd.wide_launches)
        check(composed == (0, 0, 0, 0), f"{mode}: the composed route ran: {composed}")
        check(sum(CC.plain_calls.values()) == 0 and sum(topk.plain_calls.values()) == 0,
              f"{mode}: plain versions ran: {dict(CC.plain_calls)} {dict(topk.plain_calls)}")
        res["losses"][mode] = check_run(runs[mode], "transcoder_final.npz", steps,
                                        f"launch train-transcoder D={DS} H={HS} ({mode})")
        with np.load(runs[mode] / "transcoder_final.npz") as z:
            check(z["w_enc"].shape == (DS, HS), f"{mode}: w_enc {z['w_enc'].shape}")
            check(all(bool(np.isfinite(z[n_]).all()) for n_ in z.files),
                  f"{mode}: non-finite parameters")
    x_in, _ = cache.load("encoder_mlp_in", 0)
    y_out, _ = cache.load("encoder_mlp_out", 0)
    with torch.no_grad():
        card = TC.load_trained_transcoder(runs["skip_transcoder"])(x_in[:512].to(dev),
                                                                   y_out[:512].to(dev))
        cpu = TC.load_trained_transcoder(runs["skip_transcoder"], device="cpu")(x_in[:512],
                                                                                y_out[:512])
    rel = abs(float(card.loss) - float(cpu.loss)) / float(cpu.loss)
    share = float(agree(card.hidden.cpu(), cpu.hidden).float().mean())
    check(bool(torch.isfinite(card.loss)) and rel < 1e-3 and share >= 0.99,
          f"trained Skip transcoder: card vs CPU on 512 rows: loss rel err {rel:.3g}, "
          f"{share:.2%} rows agree")
    log(f"  every step one windowed launch on the coder kernel's wide route ({res['launches']}), "
        f"no sliced or composed step, no plain version; the trained Skip transcoder on 512 rows, "
        f"card vs CPU: loss rel err {rel:.2g}, {share:.2%} rows select the same features")
    shutil.rmtree(scache, ignore_errors=True)
    return res


@contextlib.contextmanager
def coder_gate_off(*modules):
    """The coder kernel's gate closed in ``modules``: their losses take the
    composed route that serves past the 48 MiB budget."""
    real = [m.coder_supported for m in modules]
    for m in modules:
        m.coder_supported = lambda *a, **k: False
    try:
        yield
    finally:
        for m, f in zip(modules, real):
            m.coder_supported = f


def coder_wide_times(dev, CC, TC, XC, topk) -> dict:
    """Phase 21d at whisper-small 8x: each mode of ``CODER_WIDE_TIMED`` at
    its batches, the kernel and the composed route it replaces (the Skip
    and TopK transcoders' ``transcoder_loss`` with the coder gate closed:
    the top-k encode, then the ``mm_f32`` decode and skip; the
    crosscoders' ``crosscoder_apply``: the top-k encode or the ``mm_f32``
    ReLU encode, then the ``mm_f32`` decode) in turns, composed / kernel /
    kernel / composed; at an offset, the plain version, the bound, the
    bf16 encode GEMM as the library yardstick, each launch's device ms."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    res: dict = {}
    for mode, batches in CODER_WIDE_TIMED.items():
        d, dout, k, skip, y_is_x = CODER_MODES[mode]
        for b in batches:
            xbuf, ybuf, p, _ = coder_inputs(mode, 2 * b, 400 + b % 11, dev, (DS, DS, HS))
            ops = coder_ops(CC, p, k)
            x, y = xbuf[:b].contiguous(), None if ybuf is None else ybuf[:b].contiguous()
            wide = k is not None
            out = CC._coder_launch(x, y, 0, b, ops, k, wide)
            nnz, n_active = int((out.hid > 0).sum()), int(out.active.sum())
            passes = None
            if wide:  # the select's passes on this pre (it stops at a count of exactly k)
                pre = mm_f32(out.xc, ops.we_t.t()) + ops.b_enc
                passes = float(topk.cta_threshold(pre, k)[2].double().sum())
                del pre
            kernel = lambda: CC._coder_launch(x, y, 0, b, ops, k, wide)  # noqa: E731
            if mode.endswith("transcoder"):
                def composed():
                    with coder_gate_off(TC):
                        return TC.transcoder_loss(p, x, y, K, torch.bfloat16, use_skip=skip)
            else:
                layers = DS // 384
                cp = {"w_enc": p["w_enc"].view(layers, 384, HS), "b_enc": p["b_enc"],
                      "w_dec": p["w_dec"].view(HS, layers, 384), "b_dec": p["b_dec"].view(layers, 384)}
                acts = x.view(b, layers, 384).transpose(0, 1)

                def composed():
                    return XC.crosscoder_apply(cp, acts, k=k, sparsity_weight=0.01,
                                               compute_dtype=torch.bfloat16)
            with torch.no_grad():
                turns = [time_ms(f, iters=10) for f in (composed, kernel, kernel, composed)]
            xc, w_bf = x.bfloat16(), p["w_enc"].bfloat16()
            parts = (CODER_WIDE_SKIP_PARTS if skip else CODER_WIDE_PARTS) if wide else RELU_PARTS
            r = {
                "ms": (turns[1] + turns[2]) / 2, "composed_ms": (turns[0] + turns[3]) / 2,
                "turns_ms": turns,
                "indexed_ms": time_ms(lambda: CC._coder_launch(xbuf, ybuf, b, b, ops, k, wide),
                                      iters=10),
                "plain_ms": time_ms(lambda: CC.coder_forward_plain(x, y, ops, k), iters=3,
                                    warmup=1),
                **dict(zip(("bound_ms", "bound_by"), coder_bound(
                    mode, b, x, nnz, (DS, DS, HS), passes))),
                "library_ms": time_ms(lambda: torch.matmul(xc, w_bf), iters=10),
                "split_ms": launch_split(kernel, parts),
                "nnz_per_row": nnz / b, "active_features": n_active,
            }
            res[(mode, b)] = r
            log(f"  {mode:16s} B={b:5d}: {r['ms']:.4f} ms (turns {turns[1]:.4f}, {turns[2]:.4f}), "
                f"at an offset {r['indexed_ms']:.4f}; composed {r['composed_ms']:.4f} (turns "
                f"{turns[0]:.4f}, {turns[3]:.4f}); plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}), library {r['library_ms']:.4f}; device ms "
                "a call: " + ", ".join(f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                                       for k_, v in r["split_ms"].items()))
            del xbuf, ybuf, x, y, out
    return res


def small_coder_step(work: Path, dev, TC, CT, cfg_mod) -> dict:
    """Phase 21d: one training step of the whisper-small 8x Skip
    transcoder under AMP at the launcher's batch 4096 (20 windowed steps),
    host clock and device busy time."""
    g = torch.Generator(device=dev).manual_seed(94)
    steps, b = 20, CODER_B
    cfg = cfg_mod.TrainingConfig(batch_size=b, warmup_steps=10, use_amp=True)
    tc = CT.TranscoderTrainer(TC.create_transcoder(DS, DS, HS, k=K, use_skip=True, device=dev),
                              cfg, run_dir=work / "scstep")
    check(tc._use_indexed_epoch(), "the whisper-small 8x transcoder trainer is not windowed")
    log(f"  Skip transcoder (D={DS}, H={HS}, k={K}), batch {b}:")
    return step_profile(tc, (torch.randn(steps * b, DS, generator=g, device=dev),
                             torch.randn(steps * b, DS, generator=g, device=dev)), steps)


# ---------------------------------------------------------------------------
# phase 22: the research loop after extraction
# ---------------------------------------------------------------------------

RL_CLIPS, RL_LAYER, RL_BATCH, RL_EPOCHS = 64, 3, 4096, 2
RL_SEED = 42  # the launcher's default: extraction's and causal-validate's weights
RL_SAMPLES, RL_SWEEP = 4, 8
RL_PROF_CLIPS = 4  # train.py --profile: 6,000 rows, 46 steps and a remainder
A_NAMES = tuple(A_PARTS.values())


@contextlib.contextmanager
def timed_calls(owner, name: str, rows=None):
    """Wraps ``owner.name`` to add each call's wall time (after a device
    synchronisation) and, with ``rows``, the rows of its first argument to
    the yielded dict; restores it after."""
    real = getattr(owner, name)
    acc = {"s": 0.0, "calls": 0, "rows": 0}

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        if rows is not None:
            acc["rows"] += rows(*a)
        return out

    setattr(owner, name, wrapped)
    try:
        yield acc
    finally:
        setattr(owner, name, real)


def launch_cmd(*args: str) -> list[str]:
    return [sys.executable, "-m", "whisper_sae_tpu_torch.launch", *args]


def child_processes(pid: int) -> list[int]:
    """The processes ``/proc/<pid>/task/*/children`` names whose parent is
    ``pid`` (some kernels list a child's threads there too: only thread
    group leaders are kept)."""
    out = set()
    for t in Path(f"/proc/{pid}/task").iterdir():
        for c in (t / "children").read_text().split():
            try:
                text = Path(f"/proc/{c}/status").read_text()
            except OSError:  # a thread's id, not a process's
                continue
            status = dict(line.split(":\t", 1) for line in text.splitlines() if ":\t" in line)
            if status.get("Tgid", "").strip() == c and status.get("PPid", "").strip() == str(pid):
                out.add(int(c))
    return sorted(out)


def supervised_train(rl: Path, train_args: list[str], card: str) -> dict:
    """Phase 22b: ``launch train --all-layers --supervise`` in its own
    process.  A FIFO at the second epoch's checkpoint path holds the child
    there once the first epoch's checkpoint is on disk; the phase then
    unlinks it and kills the child (its pid from the supervisor's
    ``/proc/<pid>/task/*/children``, :func:`child_processes`) with SIGKILL.  The supervisor reruns
    the job, which resumes from epoch 1."""
    import os
    import signal

    out = rl / "out"
    run = out / f"launch_encoder_layer{RL_LAYER}"
    run.mkdir(parents=True)
    fifo = run / "checkpoint_epoch2.npz.tmp"
    os.mkfifo(fifo)
    log_path = rl / "supervised.log"
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + (os.pathsep + path if path else "")}
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        sup = subprocess.Popen(launch_cmd(*train_args, "--supervise", "--max-restarts", "1",
                                          "--restart-backoff", "0"),
                               cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                               start_new_session=True)
        try:
            deadline = time.time() + 300
            while not (run / "checkpoint_epoch1.npz").exists():
                check(sup.poll() is None and time.time() < deadline,
                      f"supervised train: no first checkpoint ({log_path.read_text()[-2000:]})")
                time.sleep(0.02)
            killed_s = time.perf_counter() - t0
            children = child_processes(sup.pid)
            check(len(children) == 1, f"supervisor children {children}")
            fifo.unlink()  # the blocked open keeps its inode; the rerun writes a plain file
            os.kill(children[0], signal.SIGKILL)
            rc = sup.wait(timeout=600)
        finally:
            if sup.poll() is None:  # the supervisor and the job it runs
                os.killpg(sup.pid, signal.SIGKILL)
                sup.wait()
    wall = time.perf_counter() - t0
    text = log_path.read_text()
    check(rc == 0, f"supervised train exited {rc}: {text[-3000:]}")
    attempts = json.loads((out / "launch_supervisor_log.json").read_text())
    check([a["returncode"] for a in attempts] == [-signal.SIGKILL, 0],
          f"supervisor attempts {[a['returncode'] for a in attempts]}")
    check(f"checkpoint_epoch1.npz (epoch 1," in text and "resuming from" in text,
          f"the rerun did not resume from epoch 1: {text[-3000:]}")
    log(f"  launch train --all-layers --supervise: the child killed (SIGKILL) {killed_s:.1f} s "
        f"in, after checkpoint_epoch1.npz; the supervisor reran it (attempts "
        f"{[a['returncode'] for a in attempts]}), which resumed from epoch 1; {wall:.1f} s in all "
        f"[{card}]")
    return {"out": out, "wall_s": wall, "killed_after_s": killed_s}


def profile_cli(rl: Path, train_mod, cache_mod, card: str) -> dict:
    """Phase 22c: ``train.py --profile DIR`` for one epoch at batch 128 on
    the first ``RL_PROF_CLIPS`` clips of the extracted encoder cache (a
    trace of every step of all 64 clips is hundreds of MB); the trace
    parses with events."""
    import yaml
    from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig

    src = cache_mod.FeatureCache(rl / "cache" / "features", WhisperConfig(), DataConfig())
    dst = cache_mod.FeatureCache(rl / "prof_cache" / "features", WhisperConfig(), DataConfig())
    writer = dst.writer("encoder", RL_LAYER)
    writer.append(src.load("encoder", RL_LAYER)[0][:RL_PROF_CLIPS * ENC_T])
    writer.finalize(num_samples=RL_PROF_CLIPS)
    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["training"].update(epochs=1, batch_size=128)
    cfg["data"]["cache_dir"] = str(rl / "prof_cache")
    cfg["output_dir"] = str(rl / "prof_out")
    cfg["experiment_name"] = "prof"
    path = rl / "prof.yaml"
    path.write_text(yaml.safe_dump(cfg))
    t0 = time.perf_counter()
    train_mod.main(["--config", str(path), "--layer", f"encoder:{RL_LAYER}", "--no-wandb",
                    "--profile", str(rl / "trace")])
    wall = time.perf_counter() - t0
    traces = list((rl / "trace").glob("trace_*.json"))
    check(len(traces) == 1, f"--profile wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    check(len(events) > 0, "the trace holds no events")
    top = [(n.split("<")[0].split("(")[0][-40:], c) for n, c in
           sorted(kernels.items(), key=lambda kv: -kv[1])[:6]]
    seen_a = {n: sum(c for k_, c in kernels.items() if n in k_) for n in A_NAMES}
    log(f"  train.py --profile (1 epoch, batch 128, {RL_PROF_CLIPS * ENC_T} rows): {wall:.1f} s, trace "
        f"{traces[0].stat().st_size / 2**20:.1f} MiB with {len(events)} events, "
        f"{sum(kernels.values())} kernel events of {len(kernels)} names; kernel A's launches "
        f"seen by name {seen_a}; most frequent {top} [{card}]")
    shutil.rmtree(rl / "trace", ignore_errors=True)
    return {"wall_s": wall, "events": len(events), "kernel_events": sum(kernels.values()),
            "kernel_a_seen": seen_a}


def analyze_path(rl: Path, launch_mod, sae_mod, card: str) -> dict:
    """Phase 22d on the card: ``launch analyze`` with every output on the
    uninterrupted train job's encoder SAE (``ref/``, the one the CPU side
    reads), its encode (kernel B writing f32) timed."""
    out = rl / "ref"
    args = ["analyze", "--layer-idx", str(RL_LAYER), "--top-k", "20", "--top-n", "100",
            "--coactivation", "16", "--clips", "4", "--auto-label", "--dashboard",
            "--cache-dir", str(rl / "cache"), "--output-dir", str(out)]
    t0 = time.perf_counter()
    with timed_calls(sae_mod.TopKSAE, "encode", rows=lambda self, x: int(x.shape[0])) as enc:
        res = launch_mod.main(args)
    wall = time.perf_counter() - t0
    adir = Path(res["analysis_dir"])
    for name in ("summary.json", "tracker_state.json", "coactivation.json", "dashboard.html",
                 "analysis_log.json", "audio/manifest.json"):
        check((adir / name).exists(), f"analyze wrote no {name}")
    n_feat = len(list((adir / "features").glob("feature_*.json")))
    check(n_feat == 100 and res["clips_written"] > 0 and res["coactivation_features"] == 16,
          f"analyze: {n_feat} feature files, {res}")
    rows = RL_CLIPS * ENC_T
    check(enc["rows"] == 2 * rows, f"analyze encoded {enc['rows']} rows, not 2 x {rows}")
    log(f"  launch analyze: {wall:.2f} s; {enc['calls']} encode calls of "
        f"{8 * ENC_T} rows, {enc['rows']:,} rows in {enc['s']:.2f} s "
        f"({enc['rows'] / enc['s']:,.0f} rows/s, {enc['s'] / wall:.1%} of the job's wall); "
        f"{n_feat} feature reports, {res['clips_written']} clips, labels "
        f"{res['auto_labeled_features']} [{card}]")
    return {"wall_s": wall, "encode_s": enc["s"], "encode_rows": enc["rows"],
            "rows_per_s": enc["rows"] / enc["s"], "encode_share": enc["s"] / wall}


def causal_path(rl: Path, launch_mod, card: str) -> dict:
    """Phase 22e on the card: ``launch causal-validate`` for both
    components on the uninterrupted train job's SAEs (``ref/``), the sweep
    timed."""
    res = {}
    for comp in ("encoder", "decoder"):
        t0 = time.perf_counter()
        with timed_calls(launch_mod, "feature_ablation_sweep") as sweep:
            out = launch_mod.main(["causal-validate", "--component", comp, "--layer-idx",
                                   str(RL_LAYER), "--random-whisper", "--num-samples",
                                   str(RL_SAMPLES), "--sweep-features", str(RL_SWEEP),
                                   "--cache-dir", str(rl / "cache"),
                                   "--output-dir", str(rl / "ref")])
        wall = time.perf_counter() - t0
        saved = json.loads((rl / "ref" / f"launch_{comp}_layer{RL_LAYER}" / "analysis"
                            / "causal_validation.json").read_text())
        check(len(saved["ablation_sweep"]) == RL_SWEEP and np.isfinite(saved["logit_kl"]),
              f"causal-validate {comp}: {out}")
        res[comp] = {"wall_s": wall, "s_per_feature": sweep["s"] / RL_SWEEP, "saved": saved}
        log(f"  launch causal-validate --component {comp}: {wall:.2f} s, "
            f"{sweep['s'] / RL_SWEEP:.3f} s a swept feature; logit_kl {saved['logit_kl']:.6g}, "
            f"token agreement {saved['token_agreement']} [{card}]")
    return res


def identity_patch(W, P, ds_mod, dev, params: dict) -> None:
    """Phase 22e: the identity patch's logits equal the clean forward's bit
    for bit on the card (the job's weights ``params`` and mel)."""
    arch = W.arch_for(TINY)
    ds = ds_mod.SyntheticSpeechDataset(RL_SAMPLES, seed=RL_SEED, n_mels=arch.n_mels, device=dev)
    mel = torch.from_numpy(np.stack([ds[i]["input_features"] for i in range(RL_SAMPLES)])).to(dev)
    with torch.no_grad(), W.f32_matmuls():
        enc = W.encoder_forward(params, mel, arch)[0]
        bos = torch.full((RL_SAMPLES, 1), arch.decoder_start_token_id, device=dev)
        clean = W.decoder_logits(params, W.decoder_forward(params, bos, enc, arch)[0][:, 0])
    for what, got in (("encoder", P.patched_logits(params, mel, arch, RL_LAYER, lambda h: h)),
                      ("decoder", P.patched_logits_decoder(params, mel, arch, RL_LAYER,
                                                           lambda h: h))):
        check(torch.equal(got, clean), f"identity patch on {what} layer {RL_LAYER}: logits differ "
              f"from the clean forward (max {float((got - clean).abs().max()):.3g})")
    log(f"  identity patches on encoder and decoder layer {RL_LAYER}: logits bit-equal to the "
        "clean forward")


def research_cpu_child(rl: str) -> None:
    """Phase 22's CPU side, in a process of its own beside the card's (b)
    to (e): ``launch analyze --device cpu`` (the summary), then
    ``causal-validate`` on the CPU for both components, on a copy of the
    uninterrupted train job's SAEs (``ref/``, which the card's jobs read
    too), the Whisper weights the card's job makes (``whisper.pt``, patched
    into ``launch.init_whisper``).  A TopK SAE's f32 encode takes the
    card's route here, in its plain version: kernel B's
    (``fused_topk_encode`` on CPU rows), where the CPU's own route is the
    f32 product.  Opens no CUDA context.  Writes ``cpu.json``.  Run as
    ``python -c "import chip_smoke; chip_smoke.research_cpu_child(DIR)"``."""
    import os

    from whisper_sae_tpu_torch import launch as launch_mod
    from whisper_sae_tpu_torch.causal import patching
    from whisper_sae_tpu_torch.models import sae as sae_mod
    from whisper_sae_tpu_torch.ops import cuda_sae

    def kernel_b_plain(p, x, k):
        return cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], k, torch.float32)

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - 2))
    rl = Path(rl)
    whisper = torch.load(rl / "whisper.pt")
    launch_mod.init_whisper = lambda gen, arch: whisper
    sae_mod.topk_hidden_f32 = patching.topk_hidden_f32 = kernel_b_plain
    res = {}
    for comp in ("encoder", "decoder"):
        src, dst = rl / "ref" / f"launch_{comp}_layer{RL_LAYER}", rl / "cpu_out"
        (dst / src.name).mkdir(parents=True)
        for name in ("sae_final.npz", "training_config.json"):
            shutil.copy(src / name, dst / src.name / name)
    t0 = time.perf_counter()
    launch_mod.analyze(layer_idx=RL_LAYER, top_k=20, top_n=100, cache_dir=rl / "cache",
                       output_dir=rl / "cpu_out", device="cpu")
    res["analyze_s"] = time.perf_counter() - t0
    for comp in ("encoder", "decoder"):
        t0 = time.perf_counter()
        res[comp] = launch_mod.causal_validate(
            component=comp, layer_idx=RL_LAYER, num_samples=RL_SAMPLES, sweep_features=RL_SWEEP,
            random_whisper=True, seed=RL_SEED, cache_dir=rl / "cache",
            output_dir=rl / "cpu_out", device="cpu")
        res[f"causal_{comp}_s"] = time.perf_counter() - t0
    res["cuda_initialized"] = torch.cuda.is_initialized()
    (rl / "cpu.json").write_text(json.dumps(res))


def start_cpu_side(rl: Path) -> subprocess.Popen:
    import os

    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + (os.pathsep + path if path else "")}
    with open(rl / "cpu.log", "w") as f:
        return subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                                 f"chip_smoke.research_cpu_child({str(rl)!r})"],
                                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)


def research_cpu(rl: Path, proc: subprocess.Popen, sae_mod, cache_mod, cuda_sae,
                 card_causal: dict) -> dict:
    """Phase 22d/e against the CPU: the first analyze chunk's latent (here),
    then the CPU side's analyze summary and causal-validate results, all on
    the uninterrupted train job's SAEs (``ref/``)."""
    from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig

    run = rl / "ref" / f"launch_encoder_layer{RL_LAYER}"
    card_sae = sae_mod.load_trained_sae(run)
    q = {k_: v.detach() for k_, v in sae_mod.load_trained_sae(run, device="cpu").params.items()}
    cache = cache_mod.FeatureCache(rl / "cache" / "features", WhisperConfig(), DataConfig())
    rows = cache.load_rows("encoder", RL_LAYER)[0][:8 * ENC_T].float()
    with torch.no_grad():
        got = card_sae.encode(rows.to(card_sae.device))
        want = cuda_sae.topk_encode_plain(rows, cuda_sae._bf16_t(q["w_enc"]), q["b_enc"],
                                          q["b_pre"], K, torch.float32)
    ok = agree(got.cpu(), want)
    share = float(ok.float().mean())
    check(share >= 0.999, f"analyze chunk: {share:.4%} of rows select alike on card and CPU")
    what = "22d analyze chunk: kernel B (f32 out) vs its plain version on the CPU"
    p = {k_: v.detach() for k_, v in card_sae.params.items()}
    GAPS[what] = selection_gaps((rows.to(got.device) - p["b_pre"]).bfloat16(),
                                cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], got,
                                want.to(got.device), K, what)
    err = float((got.cpu()[ok] - want[ok]).abs().max())
    check(err <= 1e-5 * float(want.abs().max()),
          f"analyze chunk: values off by {err:.3g} on rows that select alike")
    log(f"  the first analyze chunk ({rows.shape[0]} rows) card vs CPU: {share:.4%} of rows "
        f"select alike, max |d| {err:.3g} on those")

    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    check(rc == 0, f"the CPU side failed: {(rl / 'cpu.log').read_text()[-3000:]}")
    cpu = json.loads((rl / "cpu.json").read_text())
    check(not cpu["cuda_initialized"], "the CPU side opened a CUDA context")
    tops = {}
    for what_, d in (("card", rl / "ref"), ("cpu", rl / "cpu_out")):
        summary = json.loads((d / run.name / "analysis" / "summary.json").read_text())
        tops[what_] = {f["feature_idx"]: f["max_activation"] for f in summary["top_features"]}
    common = set(tops["card"]) & set(tops["cpu"])
    check(len(common) >= 99, f"analyze top-100 features: {len(common)} shared by card and CPU")
    worst = max(abs(tops["card"][f] - tops["cpu"][f]) / abs(tops["cpu"][f]) for f in common)
    check(worst <= 1e-5, f"analyze max activations: rel err {worst:.3g} > 1e-5")
    log(f"  launch analyze --device cpu ({cpu['analyze_s']:.1f} s; waited {waited:.1f} s for "
        f"the CPU side): {len(common)} of the top 100 features shared, their max activations "
        f"within rel {worst:.3g}")
    for comp in ("encoder", "decoder"):
        card, c = card_causal[comp]["saved"], cpu[comp]
        kl_d = abs(card["logit_kl"] - c["logit_kl"])
        check(kl_d <= 1e-3 * abs(c["logit_kl"]) + 1e-6,
              f"causal {comp}: logit_kl {card['logit_kl']} (card) vs {c['logit_kl']} (CPU)")
        check(card["token_agreement"] == c["token_agreement"],
              f"causal {comp}: token agreement {card['token_agreement']} (card) vs "
              f"{c['token_agreement']} (CPU)")
        cs = {r["feature_idx"]: r["logit_kl"] for r in c["ablation_sweep"]}
        both = [r for r in card["ablation_sweep"] if r["feature_idx"] in cs]
        sweep_d = max((abs(r["logit_kl"] - cs[r["feature_idx"]]) / abs(cs[r["feature_idx"]])
                       for r in both), default=float("nan"))
        log(f"  causal-validate --component {comp} --device cpu ({cpu[f'causal_{comp}_s']:.1f} s):"
            f" logit_kl |d| {kl_d:.3g} ({kl_d / abs(c['logit_kl']):.3g} rel), token agreement "
            f"equal ({c['token_agreement']}); {len(both)} features swept on both, their KLs "
            f"within rel {sweep_d:.3g}")
    return {"cpu_analyze_s": cpu["analyze_s"], "cpu_causal_s": {
        c_: cpu[f"causal_{c_}_s"] for c_ in ("encoder", "decoder")}, "cpu_wait_s": waited,
        "chunk_rows_agreeing": share}


def research_path(work: Path, dev, card: str, launch_mod, train_mod, sae_mod, cache_mod,
                  ds_mod, cuda_sae, cuda_topk, topk, W, P) -> dict:
    """Phase 22: the research loop after extraction at whisper-tiny width
    (D=384, H=3072, k=32): extract, the supervised train job with a kill
    and a resume, the CLI's --profile, analyze, causal-validate; launch
    counts; the card against the CPU."""
    t_phase = time.perf_counter()
    rl = work / "research"
    shutil.rmtree(rl, ignore_errors=True)
    rl.mkdir()
    counted = {"fused_sae_loss": cuda_sae.fused_sae_loss,
               "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed,
               "fused_topk_encode": cuda_sae.fused_topk_encode}
    for w in (*counted.values(), cuda_topk.topk_mask_fwd):
        w.launches = 0
    cuda_sae.fused_topk_encode.blocked_launches = cuda_topk.topk_mask_fwd.wide_launches = 0
    topk.plain_calls.clear()
    res = {}

    t0 = time.perf_counter()
    launch_mod.main(["extract", "--random-whisper", "--dataset", "synthetic", "--max-samples",
                     str(RL_CLIPS), "--layers-encoder", str(RL_LAYER), "--layers-decoder",
                     str(RL_LAYER), "--cache-dir", str(rl / "cache")])
    res["extract_s"] = time.perf_counter() - t0
    log(f"  (a) launch extract: {RL_CLIPS} clips, encoder and decoder layer {RL_LAYER}, "
        f"{res['extract_s']:.2f} s [{card}]")

    train_args = ["train", "--all-layers", "--layers-encoder", str(RL_LAYER), "--layers-decoder",
                  str(RL_LAYER), "--batch-size", str(RL_BATCH), "--epochs", str(RL_EPOCHS),
                  "--checkpoint-every", "1", "--cache-dir", str(rl / "cache")]
    log("  (b) the train job uninterrupted in this process, then supervised and killed once")
    t0 = time.perf_counter()
    ref = launch_mod.main(train_args + ["--output-dir", str(rl / "ref")])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    acts = sum(r["num_tokens"] for r in ref) * RL_EPOCHS
    enc_rows = RL_CLIPS * ENC_T
    want_a = {"fused_sae_loss_indexed": RL_EPOCHS * (enc_rows // RL_BATCH),
              "fused_sae_loss": RL_EPOCHS * 2}  # the encoder's remainder and the decoder's step
    got_a = {n: counted[n].launches for n in want_a}
    check(got_a == want_a, f"the train job's kernel A launches {got_a} != {want_a}")
    log(f"  launch train --all-layers: {ref_s:.2f} s, {acts / ref_s:,.0f} act/s end to end "
        f"[{card}]; kernel A launches {got_a}")
    arch = W.arch_for(TINY)  # causal-validate's weights, made as the job makes them
    whisper = W.init_whisper(torch.Generator(device=dev).manual_seed(RL_SEED), arch)
    torch.save(W.params_to(whisper, "cpu"), rl / "whisper.pt")
    cpu_side = start_cpu_side(rl)  # the CPU comparison runs beside the rest, on these SAEs
    try:
        sup = supervised_train(rl, train_args + ["--output-dir", str(rl / "out")], card)
        run, ref_run = rl / "out" / f"launch_encoder_layer{RL_LAYER}", Path(ref[0]["run_dir"])
        with np.load(run / "sae_final.npz") as z, np.load(ref_run / "sae_final.npz") as zr:
            bit = all(np.array_equal(z[k_], zr[k_]) for k_ in z.files)
            worst = max(float(np.abs(z[k_] - zr[k_]).max() / np.abs(zr[k_]).max())
                        for k_ in z.files)
        lg = [r["loss"] for r in json.loads((run / "metrics.json").read_text())]
        lr_ = [r["loss"] for r in json.loads((ref_run / "metrics.json").read_text())]
        check(len(lg) == len(lr_) and np.allclose(lg, lr_, rtol=1e-3, atol=0),
              "the resumed run's losses differ from the uninterrupted run's at rtol 1e-3")
        check(worst <= 1e-3,
              f"the resumed encoder SAE differs from the uninterrupted one: {worst:.3g}")
        log(f"  the resumed encoder SAE against the uninterrupted one: bit-equal {bit}, max rel "
            f"|d| {worst:.3g}")
        res.update(train_wall_s=sup["wall_s"], train_ref_s=ref_s, train_act_per_s=acts / ref_s,
                   resumed_bit_equal=bit)

        log("  (c) train.py --profile")
        res["profile"] = profile_cli(rl, train_mod, cache_mod, card)
        log("  (d) launch analyze")
        res["analyze"] = analyze_path(rl, launch_mod, sae_mod, card)
        log("  (e) launch causal-validate")
        causal = causal_path(rl, launch_mod, card)
        identity_patch(W, P, ds_mod, dev, whisper)
        launches = {n: w.launches for n, w in counted.items()}
        launches.update(fused_topk_encode_blocked=cuda_sae.fused_topk_encode.blocked_launches,
                        topk_mask=cuda_topk.topk_mask_fwd.launches,
                        topk_mask_wide=cuda_topk.topk_mask_fwd.wide_launches)
        plain = dict(topk.plain_calls)
        log(f"  launches on the research loop (in this process): {launches}; plain-version calls "
            f"{plain}")
        for n in counted:
            check(launches[n] > 0, f"{n}: no launch on the research loop")
        check(sum(plain.values()) == 0, f"plain versions ran on the card: {plain}")
        res.update(launches=launches,
                   causal={c: {k_: v for k_, v in r.items() if k_ != "saved"}
                           for c, r in causal.items()})
        log("  the card against the CPU")
        res.update(research_cpu(rl, cpu_side, sae_mod, cache_mod, cuda_sae, causal))
    finally:
        if cpu_side.poll() is None:  # a check failed while it ran
            cpu_side.kill()
            cpu_side.wait()
    shutil.rmtree(rl, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 23: the top-k encode and mask at every width the JAX package takes
# ---------------------------------------------------------------------------

# kernel B past the warp select, one geometry a select form: whisper-small
# 8x (the group form), whisper-large 8x (the CTA form), whisper-tiny 128x
# (the cluster form); 4096 rows
ENC_FORM_GEOMS = {"group": (768, 6144), "cta": (1280, 10240), "cluster": (384, 49152)}
MASK_SPILL_SHAPES = ((4096, 49152), (1024, 81920), (64, 262144))
DT, HT = 384, 49152  # whisper-tiny 128x: kernel B's cluster form
DG, HG = 1280, 81920  # whisper-large 64x: the blocked encode's cluster form
WB = 4096  # the trainers' batch
TINY_STEPS, TINY_EPOCHS = 48, 4  # the train job: 48 x 4096 rows, 4 epochs
F32_STEPS, LARGE_STEPS64 = 4, 3
REF_B, REF_STEPS = 256, 8  # the card-vs-CPU runs: 8 steps of 256 rows
CLUSTER_PARTS = {"centre": "sae_centre_kernel", "encode": "_kernel<3>",
                 "select": "cluster_select_kernel"}
# a width per cluster size: 2 CTAs a row (whisper-tiny 128x, large 64x), 4
# (whisper-large 128x), 8 (kernel C's widest)
CLUSTER_WIDTHS = (49152, 81920, 163840, 262144)


def encode_check(cuda_sae, x, p: dict, out_dtype, what: str, errs: dict, key: str) -> None:
    """``fused_topk_encode`` on ``x`` against its plain version: >= 99.9% of
    rows select alike, values on them within 1e-2 * max, every other row
    through the gap rule; two launches bit-identical."""
    we_t = cuda_sae._bf16_t(p["w_enc"])
    args = (we_t, p["b_enc"], p["b_pre"], K, out_dtype)
    got = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    want = cuda_sae.topk_encode_plain(x, *args)
    torch.cuda.synchronize()
    check(got.dtype == out_dtype and got.shape == want.shape, f"{what}: output")
    ok = agree(got, want)
    share = float(ok.float().mean())
    check(share >= 0.999, f"{what}: selection agrees on {share:.4%} of rows")
    err = float((got[ok].float() - want[ok].float()).abs().max())
    check(err <= 1e-2 * float(want.float().abs().max()), f"{what}: values off by {err:.3g}")
    errs[key] = max(errs.get(key, 0.0), err)
    GAPS[what] = selection_gaps((x.float() - p["b_pre"]).bfloat16(), we_t, p["b_enc"], got, want,
                                K, what)
    again = cuda_sae.fused_topk_encode(x, p["w_enc"], p["b_enc"], p["b_pre"], K, out_dtype)
    check(torch.equal(got, again), f"{what}: two launches differ")
    log(f"  {what}: rows agreeing {share:.4%}, max abs err {err:.3g}, two launches bit-identical")


def cluster_edge_rows(dev, h: int) -> torch.Tensor:
    """Rows for the cluster select's edges at width h: more than the
    compaction's 8192 candidates tied at the k-th value, all equal, all
    negative, +0.0 and -0.0 straddling the k-th, 15,000 tied at the k-th
    of an otherwise gaussian row."""
    g = torch.Generator(device=dev).manual_seed(h + 7)
    pre = torch.randn(5, h, generator=g, device=dev)
    pre[0, :10000] = pre[0].max()
    pre[1] = 1.5
    pre[2] = -pre[2].abs() - 1
    pre[3] = torch.where(torch.rand(h, generator=g, device=dev) < 0.5, 0.0, -0.0)
    pre[3, :20] = 1.0
    pre[4, 5000:20000] = 2.0
    return pre


def encode_widths_phase(dev, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 23a: kernel B in its group, CTA and cluster forms, the
    blocked encode's cluster form and kernel C's against their plain
    versions, the selects counted by form in the library; the cluster
    select on edge rows (and alone at k = h) exact and bit-identical over
    two launches; the card's clusters at once for each cluster size.
    Returns the max abs error by ``kernels`` entry and the clusters at
    once by width."""
    from whisper_sae_tpu_torch.ops import _build

    lib = _build.load_library()
    errs: dict[str, float] = {"topk_mask_spill": 0.0}
    enc = cuda_sae.fused_topk_encode
    for form, (d, h) in ENC_FORM_GEOMS.items():
        p = params(90 + d, dev, d, h)
        x = torch.randn(WB, d, generator=torch.Generator(device=dev).manual_seed(91), device=dev)
        chunks = -(-WB // _build.topk_encode_chunk_rows(h))
        for out_dtype in (torch.bfloat16, torch.float32):
            before = (enc.launches, enc.blocked_launches, cuda_sae.encode_select_launches())
            encode_check(cuda_sae, x, p, out_dtype,
                         f"kernel B D={d} H={h} ({form}) -> {str(out_dtype)[6:]}", errs,
                         "fused_topk_encode_wide")
            made = {f: n - before[2][f] for f, n in cuda_sae.encode_select_launches().items()}
            check((enc.launches, enc.blocked_launches) == (before[0] + 2, before[1])
                  and made == {f: 2 * chunks if f == form else 0 for f in made},
                  f"kernel B D={d} H={h}: launches {enc.launches - before[0]}, blocked "
                  f"{enc.blocked_launches - before[1]}, selects by form {made}")
        del p, x
    p = params(92, dev, DG, HG)
    x = torch.randn(WB, DG, generator=torch.Generator(device=dev).manual_seed(93), device=dev)
    chunks = -(-WB // _build.topk_encode_chunk_rows(HG))
    for out_dtype in (torch.bfloat16, torch.float32):
        before = (enc.launches, enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"])
        encode_check(cuda_sae, x, p, out_dtype,
                     f"blocked encode D={DG} H={HG} (cluster) -> {str(out_dtype)[6:]}", errs,
                     "fused_topk_encode_blocked_spill")
        check((enc.launches, enc.blocked_launches, cuda_sae.encode_select_launches()["cluster"])
              == (before[0], before[1] + 2, before[2] + 2 * chunks),
              f"blocked encode D={DG} H={HG}: not the blocked route's cluster form")
    del p, x
    stream = torch.cuda.current_stream().cuda_stream
    for rows, h in MASK_SPILL_SHAPES:
        pre = torch.randn(rows, h, generator=torch.Generator(device=dev).manual_seed(h), device=dev)
        pre[:4] = torch.round(pre[:4] * 2) / 2  # exact ties at the threshold
        pre[4:9] = cluster_edge_rows(dev, h)
        before = cuda_topk.topk_mask_fwd.cluster_launches
        got = cuda_topk.topk_mask_fwd(pre, K)
        again = cuda_topk.topk_mask_fwd(pre, K)
        check(cuda_topk.topk_mask_fwd.cluster_launches == before + 2,
              f"topk_mask [{rows}, {h}]: not the cluster form")
        check(torch.equal(got, topk.topk_mask_plain(pre, K)) and torch.equal(got, again),
              f"topk_mask [{rows}, {h}]: differs from the plain version or between launches")
        check(int((got[9:] > 0).sum(1).min()) == K, f"topk_mask [{rows}, {h}]: not k per row")
        edge = cluster_edge_rows(dev, h)
        out = torch.empty_like(edge)
        check(lib.wst_encode_select_fwd(_build.SELECT_FORMS.index("cluster"), edge.data_ptr(), 5,
                                        h, h, out.data_ptr(), 1, 0, stream) == 0,
              f"the cluster select at k = h = {h}: launch")
        check(torch.equal(out, topk.topk_mask_plain(edge, h)),
              f"the cluster select at k = h = {h}: differs from the plain version")
        log(f"  topk_mask [{rows}, {h}] (cluster form, {_build.cluster_ctas(h)} CTAs a row) with "
            "tie and edge rows, and k = h: equal to the plain version, two launches bit-identical")
        del pre, got, again, edge, out
    at_once = {}
    for h in CLUSTER_WIDTHS:
        at_once[h] = int(lib.wst_cluster_select_max_active(h))
        check(lib.wst_cluster_ctas(h) == _build.cluster_ctas(h) and at_once[h] > 0,
              f"the cluster select at H = {h}: {lib.wst_cluster_ctas(h)} CTAs a row, "
              f"{at_once[h]} clusters at once")
    log("  the cluster select's clusters the card holds at once (cudaOccupancyMaxActiveClusters): "
        + ", ".join(f"H = {h}: {at_once[h]} of {_build.cluster_ctas(h)} CTAs" for h in CLUSTER_WIDTHS))
    return {"errs": errs, "max_active_clusters": at_once}


def write_rows(cache_dir: Path, rows: int, gen: torch.Generator, mix: torch.Tensor,
               cfg_mod, cache_mod) -> None:
    """A synthetic ``encoder:0`` cache of ``rows`` gaussian rows at
    whisper-tiny width where the launcher looks for one."""
    cache = cache_mod.FeatureCache(cache_dir / "features", cfg_mod.WhisperConfig(),
                                   cfg_mod.DataConfig())
    writer = cache.writer("encoder", 0)
    for start in range(0, rows, 1 << 16):
        writer.append(gaussian_rows(min(1 << 16, rows - start), gen, mix).cpu().numpy())
    meta = writer.finalize(num_samples=max(1, rows // 1500))
    check(meta.num_tokens == rows and meta.hidden_dim == DT, "phase 23 cache metadata")


def train_job(cfg_mod, cache_mod, sae_mod, train_mod, cache_dir: Path, run_dir: Path,
              batch: int, epochs: int, device: str = "cuda"):
    """A whisper-tiny 128x TopK SAE (k = 32, AMP) trained on the cache as
    the launcher's ``train`` job trains one (``launch.train_sae``: the
    SAE made from its seed, the cache's loader, ``SAETrainer.train`` with
    the cache as the resample set, ``save_final``, ``save_metrics``),
    through the library: the SAE config of both packages refuses an
    expansion past 32 (``config.py:55``), so a 128x SAE is made as a
    ``TopKSAE`` of H = 49152.  Returns the trainer."""
    cache = cache_mod.FeatureCache(cache_dir / "features", cfg_mod.WhisperConfig(),
                                   cfg_mod.DataConfig())
    sae = sae_mod.TopKSAE(DT, HT, K, seed=42, device=device)
    trainer = train_mod.SAETrainer(sae, cfg_mod.TrainingConfig(
        batch_size=batch, learning_rate=1e-3, epochs=epochs, warmup_steps=20, use_amp=True,
        seed=42), run_dir=run_dir)
    loader = cache.get_dataloader("encoder", 0, batch_size=batch, seed=42)
    trainer.set_resample_dataset(loader.data)
    trainer.train(loader, epochs=epochs)
    trainer.save_final()
    trainer.save_metrics()
    return trainer


def main_path_counts(cuda_sae, cuda_topk, topk) -> None:
    for w in (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed):
        w.launches = w.wide_launches = 0
    cuda_sae.fused_topk_encode.launches = cuda_sae.fused_topk_encode.blocked_launches = 0
    m = cuda_topk.topk_mask_fwd
    m.launches = m.wide_launches = m.cluster_launches = 0
    topk.plain_calls.clear()


def widths_path(work: Path, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk,
                topk) -> dict:
    """Phase 23b-c, the main path, every count zeroed first: the
    whisper-tiny 128x TopK SAE trained as the ``train`` job trains (AMP:
    the composed loss around kernel B's cluster form), a few f32 steps
    (kernel C's cluster form), ``TopKSAE.encode`` (kernel B writing f32),
    then whisper-large 64x AMP steps through the trainer (the blocked
    encode's cluster form).  Returns the launches, the trained SAE and the
    rows for the comparisons."""
    from whisper_sae_tpu_torch.ops import _build

    wd = work / "widths"
    shutil.rmtree(wd, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(94)
    mix = torch.randn(RANK, DT, generator=gen, device=dev) / RANK ** 0.5
    write_rows(wd / "cache", TINY_STEPS * WB, gen, mix, cfg_mod, cache_mod)
    enc, mask = cuda_sae.fused_topk_encode, cuda_topk.topk_mask_fwd
    main_path_counts(cuda_sae, cuda_topk, topk)
    forms0 = cuda_sae.encode_select_launches()
    res: dict = {"mix": mix}

    steps = TINY_STEPS * TINY_EPOCHS
    t0 = time.perf_counter()
    job = train_job(cfg_mod, cache_mod, sae_mod, train_mod, wd / "cache", wd / "out", WB,
                    TINY_EPOCHS)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    run = job.run_dir
    amp = (enc.launches, enc.blocked_launches, cuda_sae.fused_sae_loss.launches,
           cuda_sae.fused_sae_loss_indexed.launches)
    check(amp == (steps, 0, 0, 0), f"the tiny 128x train job: kernel B, blocked, kernel A "
          f"(sliced, windowed) launches {amp} for {steps} steps")
    losses = np.array([r["loss"] for r in json.loads((run / "metrics.json").read_text())])
    check(len(losses) == steps and bool(np.isfinite(losses).all()), f"metrics: {losses}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"loss did not fall ({first:.5f} -> {last:.5f})")
    res["losses"] = [first, last]
    log(f"  (b) the train job's steps, whisper-tiny 128x (D={DT}, H={HT}, k={K}, batch {WB}, AMP): "
        f"{steps} steps in {res['train_s']:.1f} s (cache load and saves included), loss "
        f"{first:.5f} -> {last:.5f} (means of 10 steps), kernel B {steps} launches")

    sae = job.model
    with np.load(run / "sae_final.npz") as z:
        check(z["w_enc"].shape == (DT, HT) and all(bool(np.isfinite(z[n_]).all()) for n_ in z.files),
              "sae_final.npz: shapes or non-finite parameters")
    rows = gaussian_rows((F32_STEPS + 1) * WB, gen, mix)
    f32 = train_mod.SAETrainer(sae, cfg_mod.TrainingConfig(
        batch_size=WB, learning_rate=1e-4, warmup_steps=0, use_amp=False), run_dir=wd / "f32")
    before = mask.cluster_launches
    m32 = [m.loss for m in f32.train_epoch_fused(rows[:F32_STEPS * WB], shuffle=False)]
    check(mask.cluster_launches - before == F32_STEPS and all(np.isfinite(m32)),
          f"f32 steps: kernel C's cluster form {mask.cluster_launches - before} launches for "
          f"{F32_STEPS} steps, losses {m32}")
    res["f32_losses"] = m32
    log(f"  f32 steps at batch {WB}: losses {[round(v, 6) for v in m32]}, kernel C's cluster form "
        "once a step")
    held = rows[F32_STEPS * WB:]
    before = enc.launches
    with torch.no_grad():
        latent = sae.encode(held)
    check(enc.launches == before + 1 and latent.dtype == torch.float32,
          "TopKSAE.encode did not take kernel B writing f32")
    res.update(sae=sae, held=held, latent=latent)

    gl = torch.Generator(device=dev).manual_seed(95)
    mix_l = torch.randn(RANK, DG, generator=gl, device=dev) / RANK ** 0.5
    lg = sae_mod.TopKSAE(DG, HG, K, seed=96, device=dev)
    res["large_init"] = {n_: v.detach().cpu().clone() for n_, v in lg.params.items()}
    lrows = gaussian_rows(LARGE_STEPS64 * WB, gl, mix_l)
    trainer = train_mod.SAETrainer(lg, cfg_mod.TrainingConfig(
        batch_size=WB, learning_rate=1e-3, warmup_steps=2, use_amp=True), run_dir=wd / "large")
    before = enc.blocked_launches
    t0 = time.perf_counter()
    ml = [m.loss for m in trainer.train_epoch_fused(lrows, shuffle=False)]
    torch.cuda.synchronize()
    check(enc.blocked_launches - before == LARGE_STEPS64 and all(np.isfinite(ml)),
          f"whisper-large 64x: {enc.blocked_launches - before} blocked launches for "
          f"{LARGE_STEPS64} steps, losses {ml}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  (c) whisper-large 64x (D={DG}, H={HG}, k={K}, batch {WB}, AMP) through the trainer: "
        f"{LARGE_STEPS64} steps in {time.perf_counter() - t0:.2f} s, losses "
        f"{[round(v, 6) for v in ml]}, the blocked encode once a step; card memory peak so far "
        f"{peak_gb:.1f} GiB")
    res.update(large_losses=ml, large_trainer=trainer, large_rows=lrows, large_mix=mix_l)

    made = {f: n - forms0[f] for f, n in cuda_sae.encode_select_launches().items()}
    res["launches"] = {"fused_topk_encode_wide": enc.launches,
                       "topk_mask_spill": mask.cluster_launches,
                       "fused_topk_encode_blocked_spill": enc.blocked_launches}
    res["select_forms"] = made
    tiny_chunks, large_chunks = (-(-WB // _build.topk_encode_chunk_rows(HT)),
                                 -(-WB // _build.topk_encode_chunk_rows(HG)))
    want = (steps + 1) * tiny_chunks + LARGE_STEPS64 * large_chunks
    check(made == {f: want if f == "cluster" else 0 for f in made},
          f"selects by form on the main path {made}: want {want} cluster")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    log(f"  launches on the main path: {res['launches']}, selects by form {made}")
    return res


def widths_against_cpu(work: Path, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae,
                       r: dict) -> dict:
    """Phase 23d, the main path against the CPU (plain versions): (1) the
    tiny 128x train job on 2048 rows at batch 256 (8 steps) on the card
    and on the CPU, losses at rtol 1e-3, then 4 f32 steps of each trained
    SAE at rtol 1e-3; (2) ``TopKSAE.encode``'s f32 latent of the
    main path's SAE against kernel B's plain version (>= 99.9% of rows
    alike, the gap rule, values within 1e-5 * max) and its f32 forward
    (``eval_against_cpu``); (3) whisper-large 64x from the same initial
    parameters, 3 steps at batch 64 on the card and on the CPU, losses at
    rtol 1e-3."""
    wd = work / "widths"
    res: dict = {}
    gen = torch.Generator(device=dev).manual_seed(97)
    write_rows(wd / "ref_cache", REF_STEPS * REF_B, gen, r["mix"], cfg_mod, cache_mod)
    jobs, traj = {}, {}
    t0 = time.perf_counter()
    for where in ("cuda", "cpu"):
        jobs[where] = train_job(cfg_mod, cache_mod, sae_mod, train_mod, wd / "ref_cache",
                                wd / f"ref_{where}", REF_B, 1, device=where)
        traj[where] = [m.loss for m in jobs[where].metrics_history]
    check(len(traj["cuda"]) == len(traj["cpu"]) == REF_STEPS
          and np.allclose(traj["cuda"], traj["cpu"], rtol=1e-3, atol=0),
          f"the train job on the card {traj['cuda']} vs the CPU {traj['cpu']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj["cuda"], traj["cpu"]))
    rows = gaussian_rows(F32_STEPS * REF_B, gen, r["mix"])
    f32 = {}
    for where in ("cuda", "cpu"):
        t = train_mod.SAETrainer(jobs[where].model, cfg_mod.TrainingConfig(
            batch_size=REF_B, learning_rate=1e-4, warmup_steps=0, use_amp=False),
            run_dir=wd / f"f32_{where}")
        f32[where] = [m.loss for m in t.train_epoch_fused(rows.to(where), shuffle=False)]
    check(np.allclose(f32["cuda"], f32["cpu"], rtol=1e-3, atol=0),
          f"f32 steps on the card {f32['cuda']} vs the CPU {f32['cpu']}")
    rel32 = max(abs(a - b) / abs(b) for a, b in zip(f32["cuda"], f32["cpu"]))
    log(f"  (d) the train job (batch {REF_B}, {REF_STEPS} steps), card vs CPU: losses "
        f"within rel {rel:.3g}; then {F32_STEPS} f32 steps within rel {rel32:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")
    res.update(train_rel=rel, f32_rel=rel32)

    sae, held, got = r["sae"], r["held"][:1024], r["latent"][:1024]
    q = {n_: v.detach().cpu() for n_, v in sae.params.items()}
    want = cuda_sae.topk_encode_plain(held.cpu(), cuda_sae._bf16_t(q["w_enc"]), q["b_enc"],
                                      q["b_pre"], K, torch.float32)
    ok = agree(got.cpu(), want)
    share = float(ok.float().mean())
    check(share >= 0.999, f"TopKSAE.encode: {share:.4%} of rows alike on card and CPU")
    what = "23d TopKSAE.encode: kernel B (f32 out) vs its plain version on the CPU"
    p = {n_: v.detach() for n_, v in sae.params.items()}
    GAPS[what] = selection_gaps((held - p["b_pre"]).bfloat16(), cuda_sae._bf16_t(p["w_enc"]),
                                p["b_enc"], got, want.to(dev), K, what)
    err = float((got.cpu()[ok] - want[ok]).abs().max())
    check(err <= 1e-5 * float(want.abs().max()), f"TopKSAE.encode: values off by {err:.3g}")
    log(f"  TopKSAE.encode of 1024 held-out rows, card vs CPU: {share:.4%} alike, max |d| "
        f"{err:.3g} on those")
    eval_against_cpu(sae, held, sae_mod)

    init = r["large_init"]
    lrows = r["large_rows"][:LARGE_STEPS64 * 64]
    lg = {}
    t0 = time.perf_counter()
    for where in ("cuda", "cpu"):
        model = sae_mod.TopKSAE(DG, HG, K, params={n_: v.clone() for n_, v in init.items()},
                                device=where)
        t = train_mod.SAETrainer(model, cfg_mod.TrainingConfig(
            batch_size=64, learning_rate=1e-3, warmup_steps=2, use_amp=True),
            run_dir=wd / f"large_{where}")
        lg[where] = [m.loss for m in t.train_epoch_fused(lrows.to(where), shuffle=False)]
        del model, t
    check(np.allclose(lg["cuda"], lg["cpu"], rtol=1e-3, atol=0),
          f"whisper-large 64x on the card {lg['cuda']} vs the CPU {lg['cpu']}")
    rel_l = max(abs(a - b) / abs(b) for a, b in zip(lg["cuda"], lg["cpu"]))
    log(f"  whisper-large 64x, {LARGE_STEPS64} steps at batch 64 from the same parameters, card vs "
        f"CPU: losses within rel {rel_l:.3g} ({time.perf_counter() - t0:.1f} s)")
    res.update(encode_rows_alike=share, large_rel=rel_l)
    return res


def topk_scatter(pre: torch.Tensor, k: int) -> torch.Tensor:
    """The library yardstick of kernel C: ``torch.topk`` and a scatter of
    the relu'd values (exactly k a row: ties are not kept)."""
    v, i = torch.topk(pre, k, dim=1)
    return torch.zeros_like(pre).scatter_(1, i, v.relu())


def checked_split(fn, parts: dict, ms: float, what: str, calls: int = 5) -> dict | None:
    """``launch_split`` of ``fn``, kept only where its parts add up to
    within 10% of the call's ``ms`` (the profiler has missed launches in a
    long run): taken again once, else None, with a log line."""
    for _ in range(2):
        split = launch_split(fn, parts, calls=calls)
        total = sum(v for v in split.values() if v is not None)
        if abs(total - ms) <= 0.1 * ms:
            return split
        log(f"  {what}: the profiler's split adds up to {total:.4f} of a {ms:.4f} ms call")
    log(f"  {what}: split not measured (the profiler missed launches twice)")
    return None


def select_call(lib, pre: torch.Tensor, form: str, k: int):
    """A call of the select form ``form`` alone on an f32 pre
    (``wst_encode_select_fwd``, a bf16 latent), checked."""
    from whisper_sae_tpu_torch.ops import _build

    rows, h = pre.shape
    out = torch.empty((rows, h), dtype=torch.bfloat16, device=pre.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.wst_encode_select_fwd(_build.SELECT_FORMS.index(form), pre.data_ptr(), rows, h,
                                        k, out.data_ptr(), 0, 0, stream)
        check(err == 0, f"wst_encode_select_fwd ({form} form): error {err}")
    return call


def select_turns(lib, pre: torch.Tensor, forms: tuple, k: int) -> dict:
    """The select forms ``forms`` alone on one f32 pre, in turns a / b / b
    / a: device ms a call of each, and the four turns."""
    a, b = forms
    turns = [time_ms(select_call(lib, pre, f, k)) for f in (a, b, b, a)]
    return {f"{b}_ms": (turns[1] + turns[2]) / 2, f"{a}_ms": (turns[0] + turns[3]) / 2,
            "turns_ms": turns}


def select_ops(topk, pre: torch.Tensor, form: str) -> tuple[float, float]:
    """The integer operations the select of ``form`` needs on this pre
    (its plain model's passes: a compare and an add a value a pass over
    the whole row; for the cluster form only the passes that count, a third
    midpoint in the sweep of passes 0 and 1, the compaction's count and
    write over the row and the later passes that count over its
    candidates), plus a compare a value for the latent; and the mean
    passes a row."""
    rows, h = pre.shape
    if form != "cluster":
        passes = topk.cta_threshold(pre, K)[2].double()
        return float(2 * passes.sum() * h + rows * h), float(passes.mean())
    st: dict = {}
    passes = topk.cluster_threshold(pre, K, stats=st)[2].double()
    full, cand, listed = (st[n_].double() for n_ in ("full_passes", "candidates", "list_passes"))
    ops = 2 * ((full + 1) * h + (cand > 0).double() * 2 * h + listed * cand) + h
    return float(ops.sum()), float(passes.mean())


def widths_times(dev, cuda_sae, cuda_topk, topk) -> dict:
    """Phase 23e: kernel B in each form, the blocked encode at whisper-large
    64x and kernel C past 40960 at the main path's shapes, beside their
    plain versions, bounds (the select's work on this pre counted) and
    library yardsticks; at whisper-small 8x and large 8x kernel B in turns
    with the same rows in calls of 2048 (the blocked encode's chunk there
    before both took one entry: blocked / B / B / blocked), and at
    whisper-small 8x the group select in turns with the CTA select the
    blocked encode ran there; at whisper-large 16x the blocked encode in
    one chunk in turns with calls of 2048 rows; at whisper-tiny 128x and
    large 64x the cluster select alone on the encode's pre and each
    launch's device ms."""
    from whisper_sae_tpu_torch.ops import _build
    from whisper_sae_tpu_torch.utils.device import mm_f32

    lib = _build.load_library()
    res: dict = {}
    geoms = {**{f: (d, h, False) for f, (d, h) in ENC_FORM_GEOMS.items()},
             "blocked_cluster": (DG, HG, True)}
    for form, (d, h, blocked) in geoms.items():
        p = params(98 + d, dev, d, h)
        x = torch.randn(WB, d, generator=torch.Generator(device=dev).manual_seed(99), device=dev)
        we_t = cuda_sae._bf16_t(p["w_enc"])
        args = (x, we_t, p["b_enc"], p["b_pre"], K, torch.bfloat16)
        xc, w_bf = (x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()
        pre = mm_f32(xc, we_t.t()) + p["b_enc"]
        ops, passes = select_ops(topk, pre, _build.select_form(h))
        b_bound = bound(WB * d * 4 + d * h * 2 + (h + d) * 4 + WB * h * 2, 2 * WB * d * h, ops)
        kernel = lambda: cuda_sae._topk_encode_launch(*args)  # noqa: E731
        r = {"plain_ms": time_ms(lambda: cuda_sae.topk_encode_plain(*args), iters=2, warmup=1),
             **dict(zip(("bound_ms", "bound_by"), b_bound)),
             "library_ms": time_ms(lambda: torch.mm(xc, w_bf), iters=10, warmup=2),
             "select_passes_mean": passes, "geometry": {"d": d, "h": h, "k": K},
             "select_form": _build.select_form(h)}
        if form in ("group", "cta"):  # the blocked encode took these widths, 2048 rows a chunk
            old = lambda: [cuda_sae._topk_encode_launch(x[r0:r0 + 2048], *args[1:])  # noqa: E731
                           for r0 in range(0, WB, 2048)]
            turns = [time_ms(f) for f in (old, kernel, kernel, old)]
            r.update(ms=(turns[1] + turns[2]) / 2, blocked_ms=(turns[0] + turns[3]) / 2,
                     turns_ms=turns)
            if form == "group":  # the select the blocked encode ran here, and the new one
                r["select"] = select_turns(lib, pre, ("cta", "group"), K)
        else:
            r["ms"] = time_ms(kernel, iters=10, warmup=2)
            r["select_alone_ms"] = time_ms(select_call(lib, pre, "cluster", K), iters=10, warmup=2)
            r["split_ms"] = checked_split(kernel, CLUSTER_PARTS, r["ms"],
                                          f"{'blocked encode' if blocked else 'kernel B'} H={h}")
        res[form] = r
        sel = r.get("select")
        log(f"  {'blocked encode' if blocked else 'kernel B'} D={d} H={h} ({r['select_form']} "
            f"form) B={WB}: {r['ms']:.4f} ms"
            + (f" (turns {r['turns_ms'][1]:.4f}, {r['turns_ms'][2]:.4f}); in calls of 2048 rows "
               f"(the blocked encode's chunk) {r['blocked_ms']:.4f} (turns {r['turns_ms'][0]:.4f}, "
               f"{r['turns_ms'][3]:.4f})" if "turns_ms" in r else "")
            + (f"; the select alone: group {sel['group_ms']:.4f}, the blocked encode's CTA form "
               f"{sel['cta_ms']:.4f} (turns " + ", ".join(f"{t:.4f}" for t in sel["turns_ms"])
               + ")" if sel else "")
            + (f"; the cluster select alone on its {WB} rows {r['select_alone_ms']:.4f}"
               if "select_alone_ms" in r else "")
            + f"; plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), library "
            f"{r['library_ms']:.4f}; {r['select_passes_mean']:.2f} select passes a row"
            + ("; device ms a call: " + ", ".join(
                f"{k_} {v:.4f}" if v is not None else f"{k_} not measured"
                for k_, v in r["split_ms"].items()) if r.get("split_ms") else ""))
        del p, x, xc, w_bf, pre
    # whisper-large 16x, past the budget: the blocked encode, one 4096-row
    # chunk, in turns with its former 2048-row chunks
    p = params(100, dev, DG, 16 * DG)
    x = torch.randn(WB, DG, generator=torch.Generator(device=dev).manual_seed(101), device=dev)
    args = (cuda_sae._bf16_t(p["w_enc"]), p["b_enc"], p["b_pre"], K, torch.bfloat16)
    new = lambda: cuda_sae._topk_encode_launch(x, *args)  # noqa: E731
    old = lambda: [cuda_sae._topk_encode_launch(x[r0:r0 + 2048], *args)  # noqa: E731
                   for r0 in range(0, WB, 2048)]
    turns = [time_ms(f) for f in (old, new, new, old)]
    res["large_16x"] = {"ms": (turns[1] + turns[2]) / 2, "in_2048_row_calls_ms":
                        (turns[0] + turns[3]) / 2, "turns_ms": turns,
                        "geometry": {"d": DG, "h": 16 * DG, "k": K}}
    log(f"  blocked encode D={DG} H={16 * DG} (whisper-large 16x, CTA form) B={WB}, one chunk: "
        f"{res['large_16x']['ms']:.4f} ms; in calls of 2048 rows "
        f"{res['large_16x']['in_2048_row_calls_ms']:.4f} (turns "
        + ", ".join(f"{t:.4f}" for t in turns) + ")")
    del p, x
    for rows, h in MASK_SPILL_SHAPES:
        pre = torch.randn(rows, h, generator=torch.Generator(device=dev).manual_seed(h + 1),
                          device=dev)
        ops, passes = select_ops(topk, pre, "cluster")
        r = {"ms": time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10, warmup=2),
             "plain_ms": time_ms(lambda: topk.topk_mask_plain(pre, K), iters=2, warmup=1),
             **dict(zip(("bound_ms", "bound_by"), bound(2 * rows * h * 4, 0, ops))),
             "library_ms": time_ms(lambda: topk_scatter(pre, K), iters=10, warmup=2),
             "select_passes_mean": passes}
        res[("mask", rows, h)] = r
        log(f"  topk_mask [{rows}, {h}] (cluster form): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), library "
            f"{r['library_ms']:.4f} (torch.topk and a scatter); {r['select_passes_mean']:.2f} "
            "passes a row")
        del pre
    return res


def widths_entries(path: dict, w23: dict, tm: dict) -> list:
    """Phase 23's ``kernels`` entries: rows 3w, 4s and 5s of PERF.md (their
    names those of the spill form they first ran; ``select_form`` names
    the select past H = 40960, ``max_active_clusters`` the card's clusters
    at once by width)."""
    def pick(r):
        return {k_: r[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    errs, at_once = w23["errs"], {str(h): n for h, n in w23["max_active_clusters"].items()}
    sources = [BLOCKED_SOURCE, SELECT_SOURCE, SOURCE, GEMM_SOURCE]
    mask_main = tm[("mask", *MASK_SPILL_SHAPES[0])]
    return [
        {"name": "fused_topk_encode_wide", "route": "cuda", "source": BLOCKED_SOURCE,
         "sources": sources, "replaces": "src/whisper_sae_tpu/ops/pallas_sae.py:77",
         "launches": path["launches"]["fused_topk_encode_wide"],
         "max_abs_err": errs["fused_topk_encode_wide"], **pick(tm["cluster"]), "batch": WB,
         "geometry": tm["cluster"]["geometry"], "split_ms": tm["cluster"]["split_ms"],
         "select_form": "cluster", "select_alone_ms": tm["cluster"]["select_alone_ms"],
         "select_forms": path["select_forms"],
         **{f"at_{form}_form": {**pick(tm[form]), "geometry": tm[form]["geometry"],
                                "in_2048_row_calls_ms": tm[form]["blocked_ms"],
                                "turns_ms": tm[form]["turns_ms"]} for form in ("group", "cta")},
         "select_alone_at_group_form": tm["group"]["select"]},
        {"name": "topk_mask_spill", "route": "cuda", "source": BLOCKED_SOURCE,
         "sources": [SOURCE, BLOCKED_SOURCE], "replaces": "src/whisper_sae_tpu/ops/pallas_topk.py:51",
         "launches": path["launches"]["topk_mask_spill"], "max_abs_err": errs["topk_mask_spill"],
         **pick(mask_main), "shape": list(MASK_SPILL_SHAPES[0]), "select_form": "cluster",
         "max_active_clusters": at_once,
         **{f"at_{rows}x{h}": pick(tm[("mask", rows, h)]) for rows, h in MASK_SPILL_SHAPES[1:]}},
        {"name": "fused_topk_encode_blocked_spill", "route": "cuda", "source": BLOCKED_SOURCE,
         "sources": sources, "replaces": "src/whisper_sae_tpu/ops/pallas_sae.py:1392",
         "launches": path["launches"]["fused_topk_encode_blocked_spill"],
         "max_abs_err": errs["fused_topk_encode_blocked_spill"], **pick(tm["blocked_cluster"]),
         "batch": WB, "geometry": tm["blocked_cluster"]["geometry"],
         "split_ms": tm["blocked_cluster"]["split_ms"], "select_form": "cluster",
         "select_alone_ms": tm["blocked_cluster"]["select_alone_ms"],
         "at_large_16x": tm["large_16x"]},
    ]


# ---------------------------------------------------------------------------
# phase 24: the native shard reader and the single-device API
# ---------------------------------------------------------------------------

API_SHARD = 1 << 17
API_ROWS = (1 << 17) + (1 << 16)  # two shards
API_CHUNK = 1 << 16  # the chunked epoch's chunks: three, gathered on the loader's thread
CHAIN_ROWS = 1 << 15  # 256 steps an epoch at batch 128
CHAIN_EPOCHS = 3
SPARSE_ROWS = 4096


def with_memmap(rt, fn):
    """``fn()`` with the native library hidden: the readers it opens take
    the memmap fallback, as on a machine without a compiler."""
    real = rt._load_lib
    rt._load_lib = lambda: None
    try:
        return fn()
    finally:
        rt._load_lib = real


def gather_checks(rt, paths: list, dtype: str, n: int) -> dict:
    """The native gather against the memmap one, bit for bit, on shuffled,
    repeated and sorted indices, with and without ``out=``; then both
    timed on one shuffled epoch's indices in turns (native, memmap,
    memmap, native; the shards in the page cache: warm reads)."""
    native, plain = rt.ShardReader(paths, dtype), with_memmap(rt, lambda: rt.ShardReader(paths, dtype))
    check(native.native and not plain.native, f"{dtype} cache: native {native.native}")
    rng = np.random.default_rng(24)
    orders = {"shuffled": rng.permutation(n), "repeated": rng.integers(0, n, n // 2),
              "sorted": np.sort(rng.choice(n, n // 3, replace=False))}
    for name, idx in orders.items():
        got, want = native.gather(idx), plain.gather(idx)
        check(got.dtype == want.dtype and torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"{dtype} {name}: the native gather differs from the memmap one")
        for reader in (native, plain):
            out = torch.empty_like(got)
            check(reader.gather(idx, out=out) is out
                  and torch.equal(out.view(torch.int16), got.view(torch.int16)),
                  f"{dtype} {name}: gather(out=) differs")
    idx = orders["shuffled"]
    secs = {"native": [], "memmap": []}
    for which in ("native", "memmap", "memmap", "native"):
        reader = native if which == "native" else plain
        t0 = time.perf_counter()
        reader.gather(idx)
        secs[which].append(time.perf_counter() - t0)
    gbps = {k: n * native.row_bytes / (sum(v) / len(v)) / 1e9 for k, v in secs.items()}
    log(f"  {dtype}: native gather bit-identical to memmap on shuffled, repeated and sorted "
        f"indices (out= too); one shuffled epoch of {n} rows x {native.row_bytes} B: native "
        f"{gbps['native']:.3f} GB/s, memmap {gbps['memmap']:.3f} GB/s (warm reads, in turns)")
    native.close()
    plain.close()
    return {"gbps": gbps, "seconds": secs}


@contextlib.contextmanager
def host_syncs():
    """Counts the synchronizing CUDA operations inside the block
    (``torch.cuda.set_sync_debug_mode("warn")``); the count and the
    count by the Python line that made each are appended to the yielded
    list at the end."""
    import warnings
    from collections import Counter

    out: list = []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in rec if "synchroniz" in str(w.message)]
    out.extend([len(sites), dict(Counter(sites))])


def kernel_a_launches(cuda_sae) -> dict:
    return {"fused_sae_loss": cuda_sae.fused_sae_loss.launches,
            "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed.launches}


def zero_kernel_a(cuda_sae, topk) -> None:
    for w in (cuda_sae.fused_sae_loss, cuda_sae.fused_sae_loss_indexed):
        w.launches = 0
    topk.plain_calls.clear()


def same_training(a, b, what: str) -> None:
    """Two trainers' parameters, AdamW and dead-feature state bit for bit."""
    for k in a.model.params:
        check(torch.equal(a.model.params[k], b.model.params[k])
              and torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
              and torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), f"{what}: {k} differs")
    check(a.opt_state.count == b.opt_state.count and a.global_step == b.global_step
          and a.epoch == b.epoch, f"{what}: counters differ")
    check(torch.equal(a.model.feature_last_activated, b.model.feature_last_activated)
          and torch.equal(a.model.step_count, b.model.step_count), f"{what}: dead state differs")


def chained_epochs(work: Path, dev, gen, mix, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae,
                   topk) -> dict:
    """Phase 24b: a cache written by ``FeatureCache.save`` read back bit for
    bit; 3 epochs of ``train_epochs_fused`` (AMP, batch 128) against the
    sequential ``train_epoch_fused`` loop from the same parameters, bit
    for bit, windowed kernel-A launches 3 x steps; each form's wall ms an
    epoch (in turns, 3 more epochs each) and host syncs."""
    rows = gaussian_rows(CHAIN_ROWS, gen, mix).cpu().numpy()
    cache = cache_mod.FeatureCache(work / "apisave" / "features", cfg_mod.WhisperConfig(),
                                   cfg_mod.DataConfig())
    meta = cache.save(rows, "encoder", 2, num_samples=CHAIN_ROWS // 1500)
    back, meta2 = cache.load("encoder", 2)
    check(meta.shards == meta2.shards and len(meta.shards) == 1 and meta2.num_tokens == CHAIN_ROWS
          and np.array_equal(back.numpy().view(np.int32), rows.view(np.int32)),
          "FeatureCache.save: the cache does not read back bit for bit")
    data = back.to(dev)
    steps = CHAIN_ROWS // 128

    def fresh(name):
        t = train_mod.SAETrainer(sae_mod.TopKSAE(D, H, K, seed=24), cfg_mod.TrainingConfig(
            batch_size=128, learning_rate=1e-3, epochs=4 * CHAIN_EPOCHS, warmup_steps=100,
            use_amp=True, seed=24), run_dir=work / "apiout" / name)
        t.setup_scheduler(4 * CHAIN_EPOCHS * steps)
        return t

    chained, loop = fresh("chained"), fresh("loop")
    zero_kernel_a(cuda_sae, topk)
    with host_syncs() as syncs_c:
        cm = chained.train_epochs_fused(data, CHAIN_EPOCHS)
    launches = kernel_a_launches(cuda_sae)
    check(launches == {"fused_sae_loss": 0, "fused_sae_loss_indexed": CHAIN_EPOCHS * steps},
          f"chained epochs: kernel A launches {launches}, not {CHAIN_EPOCHS} x {steps} windowed")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    with host_syncs() as syncs_l:
        lm = [m for _ in range(CHAIN_EPOCHS) for m in loop.train_epoch_fused(data)]
    check(cm == lm, "train_epochs_fused's metrics differ from the sequential loop's")
    same_training(chained, loop, "train_epochs_fused against the sequential loop")
    losses = np.array([m.loss for m in cm])
    check(bool(np.isfinite(losses).all()) and losses[-20:].mean() < losses[:20].mean(),
          "chained epochs: the loss did not fall")
    wall = {"chained": [], "loop": []}
    for which in ("chained", "loop", "loop", "chained"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "chained":
            chained.train_epochs_fused(data, CHAIN_EPOCHS)
        else:
            for _ in range(CHAIN_EPOCHS):
                loop.train_epoch_fused(data)
        torch.cuda.synchronize()
        wall[which].append(1e3 * (time.perf_counter() - t0) / CHAIN_EPOCHS)
    ms = {k: sum(v) / len(v) for k, v in wall.items()}
    same_training(chained, loop, "train_epochs_fused against the sequential loop (timed epochs)")
    log(f"  FeatureCache.save: {CHAIN_ROWS} rows read back bit for bit; {CHAIN_EPOCHS} chained "
        f"epochs of {steps} steps bit-identical to the sequential loop, windowed kernel-A "
        f"launches {launches['fused_sae_loss_indexed']}; wall per epoch chained {ms['chained']:.2f} ms "
        f"/ loop {ms['loop']:.2f} ms (in turns); host syncs chained {syncs_c[0]} {syncs_c[1]} / "
        f"loop {syncs_l[0]} {syncs_l[1]}")
    return {"launches": launches, "steps": steps, "epoch_ms": ms, "epoch_ms_turns": wall,
            "host_syncs": {"chained": syncs_c[0], "loop": syncs_l[0]},
            "host_sync_sites": {"chained": syncs_c[1], "loop": syncs_l[1]}, "model": chained.model,
            "losses": [float(losses[:20].mean()), float(losses[-20:].mean())]}


def sparse_encode_check(model, x, sae_mod, topk) -> dict:
    """Phase 24c: ``TopKSAE.encode_sparse`` on the card against the same
    SAE on the CPU: idx equal but on rows the gap rule excuses (a set
    that differs: the gap between the k-th and (k+1)-th plain pre within
    twice the row's max |pre_card - pre_plain|; the same set in another
    order: each swapped pair's plain values within that), values within
    1e-5 of the max; ``scatter_topk`` of it equal to ``topk_hidden_dense``
    (f32 product, kernel C) on rows with no tie at the threshold;
    ``sparse_decode`` against the dense decode at rtol 1e-5 (atol 1e-5 of
    the max)."""
    from whisper_sae_tpu_torch.utils.device import mm_f32

    what = "24c encode_sparse"
    p = {k: v.detach() for k, v in model.params.items()}
    pc = {k: v.cpu() for k, v in p.items()}
    cpu = sae_mod.TopKSAE(D, H, K, params=pc, device="cpu")
    with torch.no_grad():
        vc, ic = model.encode_sparse(x)
        vp, ip = cpu.encode_sparse(x.cpu())
        # both versions' pre, each the product its encode_sparse ran
        pre = mm_f32(x - p["b_pre"], p["w_enc"]) + p["b_enc"]
        pre_card = pre.cpu()
        pre_plain = mm_f32(x.cpu() - pc["b_pre"], pc["w_enc"]) + pc["b_enc"]
    check(vc.shape == (SPARSE_ROWS, K) and ic.shape == (SPARSE_ROWS, K) and vc.is_cuda,
          f"{what}: shapes {tuple(vc.shape)}, {tuple(ic.shape)}")
    icc, vcc = ic.cpu(), vc.cpu()
    bad = (icc != ip).any(dim=1).nonzero().flatten()
    sets = (icc[bad].sort(dim=1).values != ip[bad].sort(dim=1).values).any(dim=1)
    gaps = gap_rule(bad[sets], pre_card[bad[sets]], pre_plain[bad[sets]], K, what) if sets.any() \
        else []
    for r in bad[~sets].tolist():  # the same set in another order
        order = pre_plain[r][icc[r]]
        rise = float((order[1:] - order[:-1]).max())
        diff = float((pre_card[r] - pre_plain[r]).abs().max())
        log(f"    {what}: row {r} orders its selection differently: the largest rise {rise:.4g} "
            f"in the plain pre, max|pre_card - pre_plain| {diff:.4g}")
        check(rise <= 2 * diff, f"{what}: row {r}'s order is wider apart than the sum order explains")
        gaps.append({"row": r, "order_rise": rise, "max_pre_diff": diff})
    GAPS[what] = gaps
    ok = torch.ones(SPARSE_ROWS, dtype=torch.bool)
    ok[bad] = False
    err = float((vcc[ok] - vp[ok]).abs().max())
    check(err <= 1e-5 * float(vp.abs().max()), f"{what}: values differ by {err:.3g}")
    with torch.no_grad():
        dense = topk.scatter_topk(vc, ic, H)
        want = sae_mod.topk_hidden_dense(p, x, K)
        top = torch.topk(pre, K + 1, dim=1).values
        clean = top[:, K - 1] > top[:, K]
        same = torch.equal(dense[clean], want[clean])
        recon = topk.sparse_decode(vc, ic, p["w_dec"], p["b_dec"])
        ref = mm_f32(dense, p["w_dec"]) + p["b_dec"]
        ms = time_ms(lambda: model.encode_sparse(x), iters=10)
    check(same, f"{what}: scatter_topk differs from topk_hidden_dense on rows with no tie")
    check(torch.allclose(recon, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max())),
          f"{what}: sparse_decode differs from the dense decode by "
          f"{float((recon - ref).abs().max()):.3g}")
    log(f"  encode_sparse on {SPARSE_ROWS} rows: {SPARSE_ROWS - bad.numel()} rows' idx equal to "
        f"the CPU's, {bad.numel()} excused by the gap rule; values max abs err {err:.3g}; "
        f"scatter_topk equal to topk_hidden_dense on {int(clean.sum())} rows with no tie at the "
        f"threshold; sparse_decode max abs err {float((recon - ref).abs().max()):.3g}; "
        f"{ms:.4f} ms a call")
    return {"rows_differing": int(bad.numel()), "max_abs_err": err, "ms": ms,
            "decode_max_abs_err": float((recon - ref).abs().max()), "no_tie_rows": int(clean.sum())}


def api_slice_path(work: Path, dev, card: str, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae,
                   topk) -> dict:
    """Phase 24 at whisper-tiny width (D=384, H=3072, k=32): (a) the native
    shard reader built and checked, the CLI streaming a 2-shard f32 cache
    through it and a chunked out-of-core epoch on the same cache; (b)
    chained fused epochs on a cache written by ``FeatureCache.save``;
    (c) the sparse top-k encode.  Kernel A's counts are zeroed before each
    part of the path and read after it; returns them, summed in
    ``launches``."""
    from whisper_sae_tpu_torch.runtime import shard_reader as rt

    t_phase = time.perf_counter()
    loaded = rt._lib is not None  # phase 17's reader built and loaded it at its first use
    t0 = time.perf_counter()
    built = rt.build_native()
    check(built and rt.native_available(),
          f"the native shard reader did not build: {rt.last_build_log.strip()[-400:]}")
    ready_s = time.perf_counter() - t0
    # a fresh build of the same source, into a directory of its own, for its seconds
    shutil.rmtree(work / "wstio_build", ignore_errors=True)
    home, rt.BUILD_DIR = rt.BUILD_DIR, work / "wstio_build"
    try:
        t0 = time.perf_counter()
        fresh = rt._compile()
        build_s = time.perf_counter() - t0
    finally:
        rt.BUILD_DIR = home
    check(fresh is not None, f"a fresh build of wstio.cpp failed: {rt.last_build_log.strip()[-400:]}")
    log(f"  (a) native reader: {rt.library_path().relative_to(ROOT)} "
        f"{'already loaded' if loaded else 'built and loaded'}, ready in {ready_s:.2f} s; a fresh "
        f"build of wstio.cpp takes {build_s:.2f} s (native_available: {rt.native_available()})")
    gen = torch.Generator(device=dev).manual_seed(24)
    mix = torch.randn(RANK, D, generator=gen, device=dev) / RANK ** 0.5
    path = out_of_core_config(work, cache="apicache", name="api_smoke")
    cfg = cfg_mod.ExperimentConfig.from_yaml(path)
    cache = cache_mod.FeatureCache(work / "apicache" / "features", cfg.whisper, cfg.data)
    writers = {dt: cache.writer("encoder", i, shard_tokens=API_SHARD, dtype=dt)
               for i, dt in enumerate(("float32", "bfloat16"))}
    for rows in (API_SHARD, API_ROWS - API_SHARD):  # the writer rolls a shard at an append
        block = gaussian_rows(rows, gen, mix).cpu()
        for w in writers.values():
            w.append(block)
    gathers = {}
    for i, (dt, w) in enumerate(writers.items()):
        meta = w.finalize(num_samples=API_ROWS // 1500)
        check(len(meta.shards) == 2 and meta.num_tokens == API_ROWS,
              f"{dt} cache: {len(meta.shards)} shards, {meta.num_tokens} rows")
        gathers[dt] = gather_checks(rt, [cache.cache_dir / s for s in meta.shards], dt, API_ROWS)

    cli = streamed_cli(path, API_ROWS, train_mod, cfg_mod, cache_mod, cuda_sae, topk)
    check(cli["loader"].reader.native, "the CLI's loader gathers through the memmap fallback")
    cli_launches = cli["launches"]
    log("  the same CLI run on the memmap gather, for comparison:")
    cli_mm = with_memmap(rt, lambda: streamed_cli(path, API_ROWS, train_mod, cfg_mod, cache_mod,
                                                  cuda_sae, topk))
    check(not cli_mm["loader"].reader.native, "the comparison run gathered natively")
    check(cli_mm["trainer"].metrics_history == cli["trainer"].metrics_history,
          "the CLI run's metrics differ between the native and the memmap gather")

    def chunked_epoch():
        loader = cache.get_dataloader("encoder", 0, batch_size=128, seed=24)
        check(isinstance(loader, cache_mod.PrefetchLoader), "the 2-shard cache is not streamed")
        loader.chunk_tokens = API_CHUNK
        trainer = train_mod.SAETrainer(sae_mod.TopKSAE(D, H, K, seed=24), cfg_mod.TrainingConfig(
            batch_size=128, learning_rate=1e-3, epochs=1, warmup_steps=100, use_amp=True,
            seed=24), run_dir=work / "apiout" / "chunked")
        zero_kernel_a(cuda_sae, topk)
        t0 = time.perf_counter()
        trainer.train(loader, fused=True)
        torch.cuda.synchronize()
        return trainer, loader.reader.native, time.perf_counter() - t0, kernel_a_launches(cuda_sae)

    # memmap first here, native first for the CLI: an order effect would cut both ways
    trainer_mm, native_mm, chunked_mm_s, _ = with_memmap(rt, chunked_epoch)
    check(not native_mm, "the comparison epoch gathered natively")
    trainer, native, chunked_s, chunked_launches = chunked_epoch()
    check(native, "the chunked epoch's reader is not native")
    steps = API_ROWS // 128
    check(chunked_launches == {"fused_sae_loss": 0, "fused_sae_loss_indexed": steps},
          f"chunked epoch: kernel A launches {chunked_launches}, not {steps} windowed")
    check(sum(topk.plain_calls.values()) == 0, f"plain versions ran: {dict(topk.plain_calls)}")
    losses = np.array([m.loss for m in trainer.metrics_history])
    check(len(losses) == steps and bool(np.isfinite(losses).all())
          and losses[-50:].mean() < losses[:50].mean(), "chunked epoch: the loss did not fall")
    same_training(trainer, trainer_mm, "the chunked epoch, native against memmap gathers")
    rates = {"cli": {"native": API_ROWS / cli["train_s"], "memmap": API_ROWS / cli_mm["train_s"]},
             "chunked": {"native": API_ROWS / chunked_s, "memmap": API_ROWS / chunked_mm_s}}
    log(f"  chunked out-of-core epoch (train(loader, fused=True), chunks of {API_CHUNK} rows "
        f"gathered on the trainer's gather thread): {steps} steps in {chunked_s:.2f} s native "
        f"({rates['chunked']['native']:,.0f} act/s end to end), {chunked_mm_s:.2f} s memmap "
        f"({rates['chunked']['memmap']:,.0f}), the same parameters bit for bit; launches "
        f"{chunked_launches}.  The CLI run: {rates['cli']['native']:,.0f} act/s native, "
        f"{rates['cli']['memmap']:,.0f} memmap, the same metrics")
    shutil.rmtree(work / "apicache", ignore_errors=True)

    log(f"  (b) chained epochs: {CHAIN_EPOCHS} x train_epochs_fused against the sequential loop")
    chain = chained_epochs(work, dev, gen, mix, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae,
                           topk)
    shutil.rmtree(work / "apisave", ignore_errors=True)
    log("  (c) TopKSAE.encode_sparse on the card against the CPU")
    sparse = sparse_encode_check(chain.pop("model"), gaussian_rows(SPARSE_ROWS, gen, mix),
                                 sae_mod, topk)
    launches = {k: cli_launches[k] + chunked_launches[k] + chain["launches"][k]
                for k in cli_launches}
    for name, n in launches.items():
        check(n > 0, f"{name}: no launch on phase 24's path")
    shutil.rmtree(work / "apiout", ignore_errors=True)
    return {"card": card, "launches": launches, "build_s": build_s,
            "gather_gbps": {dt: g["gbps"] for dt, g in gathers.items()},
            "cli": {"act_per_s": rates["cli"], "train_s": cli["train_s"],
                    "memmap_train_s": cli_mm["train_s"], "steps": cli["steps"],
                    "launches": cli_launches, "losses": cli["losses"]},
            "chunked": {"act_per_s": rates["chunked"], "train_s": chunked_s,
                        "memmap_train_s": chunked_mm_s, "launches": chunked_launches},
            "chained": chain, "sparse": sparse, "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 25: parallel/ -- the (data, model) mesh over torch.distributed
# ---------------------------------------------------------------------------

P25_ROWS = 1 << 16  # the CLI's cache and the dp run's fused epoch
P25_DP_BATCH, P25_DP_STEPS = 4096, 8
P25_TP_BATCH, P25_TP_STEPS = 8192, 6  # whisper-large 32x (bench.py:83-112)
P25_LD, P25_LH = 1280, 40960
P25_CLIPS, P25_CLIP_BATCH = 64, 32
P25_JOIN_S = 420  # every child's join timeout: a hung collective fails the phase
P25_GROUP_S = 300


def p25_config(work: Path, out: str) -> Path:
    """Phase 24's whisper-tiny 8x CLI config (tiny_default.yaml: D=384,
    H=3072, k=32, batch 128, AMP), one epoch, on phase 25's cache."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    cfg["training"].update(epochs=1, warmup_steps=50)
    cfg["data"]["cache_dir"] = str(work / "cache")
    cfg["output_dir"] = str(work / out)
    path = work / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def p25_torchrun_child(argv: list[str]) -> None:
    """``chip_smoke.py --torchrun-cli OUT ARGS``, started by torchrun: the
    CLI's ``main`` with the launch environment torchrun gives, then kernel
    A's launch counts (and the mesh the CLI built) written to OUT."""
    from whisper_sae_tpu_torch import train as train_mod
    from whisper_sae_tpu_torch.ops import cuda_sae, topk
    import torch.distributed as dist

    out, args = Path(argv[0]), argv[1:]
    zero_kernel_a(cuda_sae, topk)
    train_mod.main(args)
    counts = {**kernel_a_launches(cuda_sae), "plain_calls": sum(topk.plain_calls.values()),
              "backend": dist.get_backend(), "world": dist.get_world_size(),
              "device": str(torch.cuda.current_device())}
    out.write_text(json.dumps(counts))
    dist.destroy_process_group()


def p25_cli(work: Path, dev, gen, mix, train_mod, cfg_mod, cache_mod, cuda_sae, topk, card) -> dict:
    """Phase 25a: the CLI under ``torchrun`` (NCCL, one process: a 1x1
    mesh) on a 2^16-row cache, against the same CLI run without torchrun."""
    import os

    write_rows(work / "cache", P25_ROWS, gen, mix, cfg_mod, cache_mod)
    counts_path = work / "torchrun_counts.json"
    cfg = p25_config(work, "torchrun")
    args = ["--config", str(cfg), "--layer", "encoder:0", "--no-wandb"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=1", str(ROOT / "chip_smoke.py"), "--torchrun-cli",
                           str(counts_path), *args], cwd=work, env=env, capture_output=True,
                          text=True, timeout=P25_JOIN_S)
    torchrun_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 25a: torchrun CLI exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check("Mesh: data=1 model=1 (nccl)" in proc.stdout,
          f"phase 25a: the CLI built no 1x1 NCCL mesh:\n{proc.stdout[-2000:]}")
    counts = json.loads(counts_path.read_text())
    log(f"  torchrun CLI: {torchrun_s:.1f} s (one process start, NCCL, 1x1 mesh), "
        f"launches {counts}")
    check(counts["fused_sae_loss_indexed"] > 0 and counts["plain_calls"] == 0,
          f"phase 25a: kernel A not launched under torchrun: {counts}")
    zero_kernel_a(cuda_sae, topk)
    t0 = time.perf_counter()
    train_mod.main(["--config", str(p25_config(work, "single")), "--layer", "encoder:0",
                    "--no-wandb"])
    single_s = time.perf_counter() - t0
    single = kernel_a_launches(cuda_sae)
    run = next((work / "single").glob("*_encoder_layer0")).name
    a = json.loads((work / "torchrun" / run / "metrics.json").read_text())
    b = json.loads((work / "single" / run / "metrics.json").read_text())
    check(len(a) == len(b) == P25_ROWS // 128, f"phase 25a: {len(a)} / {len(b)} metric rows")
    same = a == b
    if not same:
        la, lb = np.array([r["loss"] for r in a]), np.array([r["loss"] for r in b])
        worst = float(np.max(np.abs(la - lb) / np.abs(lb)))
        log(f"  torchrun CLI metrics.json differs from the single-process run's (max rel loss "
            f"{worst:.3e}): the dp step sums its gradients through a flat buffer all-reduced "
            "over a one-rank group; held at the AMP bar")
        check(worst <= 1e-3, f"phase 25a: torchrun losses off by {worst:.3e}")
    with np.load(work / "torchrun" / run / "sae_final.npz") as za, \
            np.load(work / "single" / run / "sae_final.npz") as zb:
        params_same = all(np.array_equal(za[k], zb[k]) for k in za.files)
    log(f"  [{card}] torchrun CLI against the single-process CLI ({single_s:.1f} s in process, "
        f"launches {single}): metrics.json bit for bit {same}, sae_final.npz bit for bit "
        f"{params_same}")
    shutil.rmtree(work / "cache", ignore_errors=True)
    return {"torchrun_s": torchrun_s, "single_s": single_s, "launches": counts,
            "metrics_bit_equal": same, "params_bit_equal": params_same}


def p25_spawn(scenario: str, world: int, work: Path, **kwargs) -> list:
    """``scenario`` in ``world`` processes sharing the card (gloo on CUDA
    tensors, ``file://`` rendezvous); -> each rank's result.  A rank still
    running after the join timeout, or any failing rank, fails the phase."""
    import multiprocessing as mp
    import pickle

    init = work / f"rendezvous_{scenario}"
    init.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=p25_rank, args=(r, world, str(init), scenario, kwargs, str(work)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + P25_JOIN_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        check(not hung, f"phase 25 {scenario}: ranks {hung} still running after {P25_JOIN_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errs = [f.read_text() for f in sorted(work.glob(f"{scenario}_*.err"))]
    check(not errs and all(p.exitcode == 0 for p in procs),
          f"phase 25 {scenario}: exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(work / f"{scenario}_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def p25_rank(rank: int, world: int, init: str, scenario: str, kwargs: dict, work: str) -> None:
    """A rank of ``p25_spawn``: a gloo group named by the caller (two ranks
    on one card: NCCL refuses that), then the scenario."""
    import pickle
    import traceback

    import torch.distributed as dist

    from whisper_sae_tpu_torch.parallel import initialize_if_needed

    try:
        initialize_if_needed(f"file://{init}", world, rank, backend="gloo",
                             timeout_s=P25_GROUP_S)
        result = globals()[scenario](rank, Path(work), **kwargs)
        with open(Path(work) / f"{scenario}_{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (Path(work) / f"{scenario}_{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class CollectiveTimer:
    """CUDA events around every ``torch.distributed.all_reduce`` the port
    makes while ``on``, summed by the calling function (the bisection's
    ``topk_threshold_sharded``, the gradient ``_flat_all_reduce`` /
    ``reduce_gradients``, the recon's ``forward``, ...)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.real = dist, dist.all_reduce
        self.on, self.events = False, []
        dist.all_reduce = self._all_reduce

    def _all_reduce(self, tensor, *a, **kw):
        if not self.on:
            return self.real(tensor, *a, **kw)
        caller = sys._getframe(1).f_code.co_name
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(tensor, *a, **kw)
        end.record()
        self.events.append((caller, start, end))
        return out

    def totals(self) -> dict:
        torch.cuda.synchronize()
        out: dict = {}
        for caller, start, end in self.events:
            ms, n = out.get(caller, (0.0, 0))
            out[caller] = (ms + start.elapsed_time(end), n + 1)
        self.events.clear()
        return out


def p25_params_bits(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def p25_tiny_rows(n: int) -> torch.Tensor:
    """Whisper-tiny-width rows made on the card from a seed: the same on
    every rank and in the parent."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    mix = torch.randn(RANK, D, generator=gen, device="cuda") / RANK ** 0.5
    return gaussian_rows(n, gen, mix)


def p25_trainer(mesh, d: int, h: int, batch: int, run_dir: Path):
    from whisper_sae_tpu_torch.config import TrainingConfig
    from whisper_sae_tpu_torch.models.sae import TopKSAE
    from whisper_sae_tpu_torch.training.trainer import SAETrainer

    sae = TopKSAE(d, h, K, seed=42, device="cuda")
    return SAETrainer(sae, TrainingConfig(batch_size=batch, learning_rate=1e-3, warmup_steps=2,
                                          use_amp=True, seed=42), run_dir=run_dir, mesh=mesh)


def p25_timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def p25_dp(rank: int, work: Path) -> dict:
    """Phase 25b, a rank of dp = 2 at whisper-tiny 8x: 8 steps of the
    global batch 4096 (2048 rows a rank, kernel A), then one fused epoch
    over 2^16 rows (the windowed kernel A at the rank's offsets)."""
    from whisper_sae_tpu_torch.ops import cuda_sae, topk
    from whisper_sae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1)
    timer = CollectiveTimer()
    rows = p25_tiny_rows(P25_ROWS)
    trainer = p25_trainer(mesh, D, H, P25_DP_BATCH, work / f"dp{rank}")
    zero_kernel_a(cuda_sae, topk)
    trainer.train_step(rows[:P25_DP_BATCH])  # warm-up: not checked against the reference
    timer.on = True
    ms_steps, step_ms = p25_timed(lambda: [trainer.train_step(
        rows[i * P25_DP_BATCH:(i + 1) * P25_DP_BATCH]) for i in range(P25_DP_STEPS)])
    step_coll = timer.totals()
    ms_epoch, epoch_ms = p25_timed(lambda: trainer.train_epoch_fused(rows))
    epoch_coll = timer.totals()
    timer.on = False
    return {"losses": [m.loss for m in ms_steps + ms_epoch],
            "launches": kernel_a_launches(cuda_sae), "plain_calls": sum(topk.plain_calls.values()),
            "bits": p25_params_bits(trainer.model.params),
            "step_ms": step_ms / P25_DP_STEPS, "epoch_step_ms": epoch_ms / len(ms_epoch),
            "collectives": {"steps": step_coll, "epoch": epoch_coll},
            "epoch_steps": len(ms_epoch)}


def p25_dp_reference() -> list[float]:
    """The dp run on one process: the same SAE, warm-up step and batches."""
    rows = p25_tiny_rows(P25_ROWS)
    trainer = p25_trainer(None, D, H, P25_DP_BATCH, ROOT / "build" / "chip_smoke" / "p25" / "dp_ref")
    trainer.train_step(rows[:P25_DP_BATCH])
    ms = [trainer.train_step(rows[i * P25_DP_BATCH:(i + 1) * P25_DP_BATCH])
          for i in range(P25_DP_STEPS)]
    ms += trainer.train_epoch_fused(rows)
    return [m.loss for m in ms]


def p25_selection_sig(mask: torch.Tensor, offset: int) -> torch.Tensor:
    """Per row, two sums over the selected features' global indices (a
    row's signature: equal signatures, same features, but for
    collisions no test run has)."""
    idx = torch.arange(mask.shape[1], device=mask.device, dtype=torch.int64) + offset + 1
    m = mask.to(torch.int64)
    return torch.stack([(m * idx).sum(1), (m * (idx * idx % 1000003)).sum(1)], dim=1)


def p25_large_rows(step: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(2500 + step)
    mix = torch.randn(RANK, P25_LD, generator=gen, device="cuda") / RANK ** 0.5
    return gaussian_rows(P25_TP_BATCH, gen, mix)


def p25_tp(rank: int, work: Path) -> dict:
    """Phase 25b, a rank of tp = 2 at whisper-large 32x (20,480 features a
    rank): before each of 6 steps, the signature of the rows' selection
    (the step's own product and the bisection over the model group) and,
    on rank 0, that of the single-device top-k encode (the blocked encode)
    on the same step's gathered parameters; then the step; then the
    gathered checkpoint (rank 0 writes it)."""
    import torch.distributed as dist

    from whisper_sae_tpu_torch.models.sae import topk_hidden_dense
    from whisper_sae_tpu_torch.parallel import make_mesh
    from whisper_sae_tpu_torch.parallel.tp_topk import topk_threshold_sharded
    from whisper_sae_tpu_torch.utils.device import mm_f32

    mesh = make_mesh(1, 2)
    timer = CollectiveTimer()
    trainer = p25_trainer(mesh, P25_LD, P25_LH, P25_TP_BATCH, work / "tp")
    trainer._place_on_mesh()
    torch.cuda.reset_peak_memory_stats()
    losses, sigs, kernel_sigs, step_ms, colls = [], [], [], [], []
    for s in range(P25_TP_STEPS):
        x = p25_large_rows(s)
        full = trainer.full_params()
        if rank == 0:
            with torch.no_grad():
                hidden = topk_hidden_dense(full, x, K, torch.bfloat16)
                kernel_sigs.append(p25_selection_sig(hidden > 0, 0).cpu())
                del hidden
        del full
        p = trainer.model.params
        with torch.no_grad():
            pre = mm_f32((x - p["b_pre"]).bfloat16(), p["w_enc"].bfloat16()) + p["b_enc"]
            xi, th = topk_threshold_sharded(pre, K, mesh.model_group)
            sig = p25_selection_sig((xi >= th) & (pre > 0), mesh.feature_block(P25_LH).start)
            del pre, xi
            dist.all_reduce(sig, group=mesh.model_group)
        sigs.append(sig.cpu())
        timer.on = s > 0  # the first step also warms up
        m, ms = p25_timed(lambda: trainer.train_step(x))
        timer.on = False
        if s > 0:
            step_ms.append(ms)
            colls.append(timer.totals())
        losses.append(m.loss)
    peak = torch.cuda.max_memory_allocated()
    specs = trainer._tp_family().param_specs
    repl = {k: v.detach().cpu().numpy().tobytes() for k, v in trainer.model.params.items()
            if specs[k] is None}
    local = {k: tuple(v.shape) for k, v in trainer.model.params.items()}
    trainer.save_checkpoint("tp.npz")
    full_bits = p25_params_bits(trainer.full_params())
    return {"losses": losses, "sigs": sigs, "kernel_sigs": kernel_sigs, "step_ms": step_ms,
            "collectives": colls,
            "peak_bytes": peak, "replicated": repl, "local_shapes": local, "full_bits": full_bits,
            "ckpt": str(trainer.run_dir / "tp.npz")}


def p25_tp_reference() -> tuple[list, list]:
    """The tp run on one process (the blocked encode route): losses and
    the selection signature of each step's rows before the step."""
    from whisper_sae_tpu_torch.models.sae import topk_hidden_dense

    trainer = p25_trainer(None, P25_LD, P25_LH, P25_TP_BATCH,
                          ROOT / "build" / "chip_smoke" / "p25" / "tp_ref")
    losses, sigs = [], []
    for s in range(P25_TP_STEPS):
        x = p25_large_rows(s)
        with torch.no_grad():
            hidden = topk_hidden_dense(trainer.model.params, x, K, torch.bfloat16)
            sigs.append(p25_selection_sig(hidden > 0, 0).cpu())
            del hidden
        losses.append(trainer.train_step(x).loss)
    return losses, sigs


def p25_extract_run(work: Path, out: str, mesh) -> dict:
    from whisper_sae_tpu_torch.config import DataConfig, WhisperConfig
    from whisper_sae_tpu_torch.data.feature_cache import FeatureCache, extract_and_cache_features
    from whisper_sae_tpu_torch.data.librispeech import (
        AudioBatchLoader, LibriSpeechFeaturesOnly, SyntheticSpeechDataset)
    from whisper_sae_tpu_torch.models import whisper as W
    from whisper_sae_tpu_torch.ops import cuda_encoder as CE, encoder as E

    arch = W.arch_for("openai/whisper-tiny")
    params = W.init_whisper(torch.Generator(device="cuda").manual_seed(0), arch)
    ds = SyntheticSpeechDataset(num_samples=P25_CLIPS, seed=0, n_mels=arch.n_mels, device="cuda")
    cache = FeatureCache(work / out / "features", WhisperConfig(),
                         DataConfig(dataset_name="synthetic", max_samples=P25_CLIPS))
    reset_enc_launches(CE)
    E.plain_calls.clear()
    _, ms = p25_timed(lambda: extract_and_cache_features(
        params, arch, AudioBatchLoader(LibriSpeechFeaturesOnly(ds), batch_size=P25_CLIP_BATCH),
        cache, encoder_layers=[0, 1, 2, 3], decoder_layers=[3], max_samples=P25_CLIPS,
        progress=False, compute_dtype=torch.bfloat16, device="cuda", mesh=mesh))
    return {"launches": enc_launches(CE), "plain_calls": sum(E.plain_calls.values()),
            "ms": ms, "batches": P25_CLIPS // P25_CLIP_BATCH}


def p25_extract(rank: int, work: Path) -> dict:
    """Phase 25b, a rank of dp = 2 extraction (whisper-tiny, bf16, 64 clips
    in batches of 32: 16 clips a rank a batch); rank 0 writes the cache."""
    from whisper_sae_tpu_torch.parallel import make_mesh

    return p25_extract_run(work, "dp_cache", make_mesh(2, 1))


def parallel_path(work: Path, dev, card: str, gen, mix, train_mod, cfg_mod, cache_mod, sae_mod,
                  cuda_sae, topk) -> dict:
    """Phase 25: (a) the CLI under torchrun; (b) two ranks sharing the card
    through the library: dp = 2 training, tp = 2 at whisper-large 32x,
    dp = 2 extraction, each against one process on the card; (c) times."""
    t_phase = time.perf_counter()
    work = work / "p25"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    log("  (a) the CLI under torchrun --nproc_per_node=1 (NCCL) against the CLI alone")
    cli = p25_cli(work, dev, gen, mix, train_mod, cfg_mod, cache_mod, cuda_sae, topk, card)

    log("  (b) dp = 2 sharing the card (gloo on CUDA tensors): whisper-tiny 8x, global batch "
        f"{P25_DP_BATCH}, {P25_DP_STEPS} steps and one fused epoch of {P25_ROWS} rows")
    t0 = time.perf_counter()
    dp = p25_spawn("p25_dp", 2, work)
    dp_s = time.perf_counter() - t0
    ref = p25_dp_reference()
    for r, out in enumerate(dp):
        check(out["launches"]["fused_sae_loss"] > 0 and out["launches"]["fused_sae_loss_indexed"] > 0
              and out["plain_calls"] == 0, f"phase 25 dp: rank {r} launches {out['launches']}")
        got, want = np.array(out["losses"]), np.array(ref)
        check(got.shape == want.shape, f"phase 25 dp: {got.shape} losses, {want.shape} reference")
        worst = float(np.max(np.abs(got - want) / np.abs(want)))
        check(worst <= 1e-3, f"phase 25 dp: rank {r} losses off the reference by {worst:.3e}")
    check(dp[0]["bits"] == dp[1]["bits"], "phase 25 dp: the ranks' parameters differ")
    dp_worst = float(np.max(np.abs(np.array(dp[0]["losses"]) - ref) / np.abs(ref)))
    log(f"  [{card}] dp = 2: {dp_s:.1f} s with the process starts; losses within {dp_worst:.3e} "
        f"of one process; parameters bit for bit across ranks; kernel A launches by rank "
        f"{[o['launches'] for o in dp]}; ms a step {[round(o['step_ms'], 4) for o in dp]} "
        f"(fused epoch {[round(o['epoch_step_ms'], 4) for o in dp]}); collectives "
        f"{json.dumps(p25_coll_summary(dp[0]['collectives']['steps'], dp[0]['step_ms'], P25_DP_STEPS))}")

    log(f"  (b) tp = 2 sharing the card: whisper-large 32x (D={P25_LD}, H={P25_LH}, "
        f"{P25_LH // 2} a rank), batch {P25_TP_BATCH}, {P25_TP_STEPS} steps")
    t0 = time.perf_counter()
    tp = p25_spawn("p25_tp", 2, work)
    tp_s = time.perf_counter() - t0
    ref_losses, ref_sigs = p25_tp_reference()
    agree, drift = [], []
    for s in range(P25_TP_STEPS):
        check(torch.equal(tp[0]["sigs"][s], tp[1]["sigs"][s]),
              f"phase 25 tp: step {s}: the ranks' signatures differ")
        agree.append(float((tp[0]["sigs"][s] == tp[0]["kernel_sigs"][s]).all(dim=1).float().mean()))
        drift.append(float((tp[0]["sigs"][s] == ref_sigs[s]).all(dim=1).float().mean()))
    check(min(agree) >= 0.999, f"phase 25 tp: rows selecting as the blocked encode does on the "
          f"same parameters, by step: {agree}")
    got, want = np.array(tp[0]["losses"]), np.array(ref_losses)
    tp_worst = float(np.max(np.abs(got - want) / np.abs(want)))
    check(tp_worst <= 1e-3, f"phase 25 tp: losses off the reference by {tp_worst:.3e}")
    check(tp[0]["replicated"] == tp[1]["replicated"] and set(tp[0]["replicated"]) == {"b_dec", "b_pre"},
          "phase 25 tp: replicated leaves differ across ranks")
    check(tp[0]["local_shapes"]["w_enc"] == (P25_LD, P25_LH // 2),
          f"phase 25 tp: local w_enc {tp[0]['local_shapes']['w_enc']}")
    from whisper_sae_tpu_torch.utils.checkpoint import load_pytree

    tree, meta = load_pytree(tp[0]["ckpt"])
    single = sae_mod.TopKSAE(P25_LD, P25_LH, K, params=tree["params"], device="cuda")
    check(p25_params_bits(single.params) == tp[0]["full_bits"] == tp[1]["full_bits"]
          and meta["global_step"] == P25_TP_STEPS,
          "phase 25 tp: the gathered checkpoint does not load as the trained SAE")
    del single, tree
    tp_ms = [float(np.mean(o["step_ms"])) for o in tp]
    log(f"  [{card}] tp = 2: {tp_s:.1f} s with the process starts; rows selecting as the "
        f"single-device blocked encode on the same parameters, by step {agree}; as the "
        f"independent one-process run's (its parameters drifting apart by AdamW's ~lr steps "
        f"where the two gradients' signs differ) {drift}; losses within {tp_worst:.3e}; b_dec, "
        f"b_pre bit for bit across ranks; the "
        f"gathered checkpoint loads into one TopKSAE; peak GB by rank "
        f"{[round(o['peak_bytes'] / 1e9, 3) for o in tp]}; ms a step {[round(m, 3) for m in tp_ms]}; "
        f"collectives {json.dumps(p25_coll_summary(p25_merge(tp[0]['collectives']), tp_ms[0], P25_TP_STEPS - 1))}")

    log(f"  (b) dp = 2 extraction sharing the card: whisper-tiny bf16, {P25_CLIPS} clips in "
        f"batches of {P25_CLIP_BATCH}")
    t0 = time.perf_counter()
    ex = p25_spawn("p25_extract", 2, work)
    ex_s = time.perf_counter() - t0
    one = p25_extract_run(work, "one_cache", None)
    for r, out in enumerate(ex):
        check(all(out["launches"][n] > 0 for n in ("conv_stem", "ln_qkv", "self_attention",
                                                   "out_proj", "mlp_block"))
              and out["plain_calls"] == 0, f"phase 25 extraction: rank {r} launches {out['launches']}")
    same_layers, differing = p25_same_caches(work, cfg_mod, cache_mod)
    log(f"  [{card}] dp = 2 extraction: {ex_s:.1f} s with the process starts, ms by rank "
        f"{[round(o['ms'], 1) for o in ex]} (one process {one['ms']:.1f}); encoder launches by "
        f"rank {[o['launches'] for o in ex]}; caches bit for bit: {same_layers}; within the "
        f"stack bars only: {differing}")
    return {"card": card, "cli": cli,
            "dp": {"s": dp_s, "worst_rel": dp_worst, "step_ms": [o["step_ms"] for o in dp],
                   "epoch_step_ms": [o["epoch_step_ms"] for o in dp],
                   "launches": [o["launches"] for o in dp],
                   "collectives": p25_coll_summary(dp[0]["collectives"]["steps"], dp[0]["step_ms"],
                                                   P25_DP_STEPS)},
            "tp": {"s": tp_s, "worst_rel": tp_worst, "agree": agree, "drift": drift,
                   "step_ms": tp_ms,
                   "peak_gb": [o["peak_bytes"] / 1e9 for o in tp],
                   "collectives": p25_coll_summary(p25_merge(tp[0]["collectives"]), tp_ms[0],
                                                   P25_TP_STEPS - 1)},
            "extract": {"s": ex_s, "ms": [o["ms"] for o in ex], "one_ms": one["ms"],
                        "launches": [o["launches"] for o in ex], "bit_equal": same_layers,
                        "within_bars": differing},
            "phase_s": time.perf_counter() - t_phase}


def p25_merge(steps: list) -> dict:
    out: dict = {}
    for d in steps:
        for k, (ms, n) in d.items():
            a, b = out.get(k, (0.0, 0))
            out[k] = (a + ms, b + n)
    return out


def p25_coll_summary(totals: dict, step_ms: float, steps: int) -> dict:
    """ms a step, calls a step and share of the step of each collective."""
    return {k: {"ms": ms / steps, "calls": n / steps, "share": ms / steps / step_ms}
            for k, (ms, n) in totals.items()}


def p25_same_caches(work: Path, cfg_mod, cache_mod) -> tuple[list, list]:
    """The dp cache against the one-process cache, layer by layer: bit for
    bit, else within the stack bars (2^-4 max, 2^-7 mean, relative)."""
    caches = [cache_mod.FeatureCache(work / d / "features", cfg_mod.WhisperConfig(),
                                     cfg_mod.DataConfig(dataset_name="synthetic",
                                                        max_samples=P25_CLIPS))
              for d in ("dp_cache", "one_cache")]
    same, differing = [], []
    for comp, layer in [("encoder", l) for l in range(4)] + [("decoder", 3)]:
        (a, ma), (b, mb) = (c.load(comp, layer) for c in caches)
        check(ma.num_tokens == mb.num_tokens and ma.num_samples == mb.num_samples == P25_CLIPS,
              f"phase 25 extraction: {comp}:{layer} metadata differs")
        if torch.equal(a, b):
            same.append(f"{comp}:{layer}")
            continue
        d = (a.float() - b.float()).abs()
        ref = b.float().abs()
        mx, mean = float(d.max() / ref.max()), float(d.mean() / ref.mean())
        differing.append({"layer": f"{comp}:{layer}", "max_rel": mx, "mean_rel": mean})
        check(mx <= 2 ** -4 and mean <= 2 ** -7,
              f"phase 25 extraction: {comp}:{layer} off the one-process cache ({mx:.3e}, {mean:.3e})")
    return same, differing



# ---------------------------------------------------------------------------
# phase 26: the real-audio route -- LibriSpeech's mel cache (ingest, decode,
# the launcher's and the CLI's non-synthetic datasets) -- and the ReLU SAE's
# model-axis sharding
# ---------------------------------------------------------------------------

P26_CLIPS, P26_SEED, P26_BAD = 128, 26, 5  # sample 5 carries bytes no WAV reader decodes
P26_STEREO = 3  # clips i % 8 == 3: 44.1 kHz stereo (resample and the channel mean run)
P26_BY_PATH = 7  # clips i % 16 == 7: a WAV file by path, no bytes
P26_LG_CLIPS = 16  # the large-v3 batch: the first 16 clips that decode
P26_REF_CLIPS = 8  # clips of the first batch held against the CPU's plain route
P26_CAUSAL = 8  # causal-validate's num_samples
P26_WEIGHT_SEED = 42  # the launcher's default seed: its random Whisper weights
MEL_BAR = 1e-4  # max abs, values of order 1 (tests/test_torch_port_mel.py)


def p26_stream(work: Path, ds_mod, wavio) -> list[dict]:
    """Phase 26a's LibriSpeech-shaped stream of 128 samples made from a
    seed: speech-like waveforms (``SyntheticSpeechDataset.waveform``) of 2
    to 30 s as RIFF WAV bytes, most 16 kHz mono, every eighth 44.1 kHz
    stereo, every sixteenth a file by path; one sample does not decode."""
    rng = np.random.default_rng(P26_SEED)
    wav_dir = work / "wav"
    wav_dir.mkdir(parents=True)
    samples = []
    for i in range(P26_CLIPS):
        sid, cid = 1000 + i % 40, 100 + i // 40
        s = {"id": f"{sid}-{cid}-{i:04d}", "text": f"CLIP {i} OF SPEAKER {sid} CHAPTER {cid}",
             "speaker_id": sid, "chapter_id": cid}
        seconds = float(rng.uniform(2.0, 30.0))
        if i == P26_BAD:
            s["audio"] = {"bytes": b"RIFF\x10\x00\x00\x00WAVEnot a wave", "path": f"{i}.flac"}
            samples.append(s)
            continue

        def wave(seed):
            return ds_mod.SyntheticSpeechDataset(1, duration_s=seconds, seed=seed).waveform(0)

        path = wav_dir / f"{s['id']}.wav"
        if i % 8 == P26_STEREO:
            stereo = np.stack([wavio.resample(wave(P26_SEED * 1000 + i), 16_000, 44_100),
                               0.8 * wavio.resample(wave(P26_SEED * 1000 + 500 + i), 16_000,
                                                    44_100)], axis=1)
            wavio.write_wav(path, stereo, 44_100)
        else:
            wavio.write_wav(path, wave(P26_SEED * 1000 + i), 16_000)
        s["audio"] = ({"bytes": None, "path": str(path)} if i % 16 == P26_BY_PATH
                      else {"bytes": path.read_bytes(), "path": f"{s['id']}.flac"})
        samples.append(s)
    return samples


def p26_dataset(ds_mod, cfg_mod, cache_dir: Path, samples: list, device, n_mels: int = 80,
                max_samples: int | None = None):
    """``LibriSpeechDataset`` over ``cache_dir``; without a cache there it
    ingests ``samples`` (``_ingest``, the log-mel on ``device``) in the
    stream's place."""

    class LocalStream(ds_mod.LibriSpeechDataset):
        def _load_streaming(self):
            self._ingest(iter(samples))

    return LocalStream(cfg_mod.DataConfig(cache_dir=cache_dir, max_samples=max_samples or P26_CLIPS),
                       n_mels=n_mels, device=device)


def p26_ingest(work: Path, dev, ds_mod, cfg_mod, samples: list, card: str) -> dict:
    """Phase 26a: the stream ingested with the mels on the card, against
    the same stream featurised on the CPU."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = p26_dataset(ds_mod, cfg_mod, work / "cache", samples, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = p26_dataset(ds_mod, cfg_mod, work / "cpu_mels", samples, "cpu")
    cpu_s = time.perf_counter() - t0
    good = P26_CLIPS - 1
    stem = f"librispeech_clean_train.100_{P26_CLIPS}"
    names = [sorted(p.name for p in d.iterdir()) for d in (work / "cache", work / "cpu_mels")]
    check(names[0] == names[1] == [f"{stem}_meta.json", f"{stem}_shard00000.npy"],
          f"phase 26a: cache files {names}")
    metas = [json.loads((d / f"{stem}_meta.json").read_text()) for d in (work / "cache",
                                                                           work / "cpu_mels")]
    check(metas[0] == metas[1] and len(metas[0]["items"]) == len(ds) == len(cpu) == good
          and all(it["id"] != samples[P26_BAD]["id"] for it in metas[0]["items"]),
          "phase 26a: meta json differs from the CPU's or kept the sample that does not decode")
    got, want = (np.load(d / f"{stem}_shard00000.npy") for d in (work / "cache", work / "cpu_mels"))
    check(got.shape == want.shape == (good, N_MELS, 3000) and got.dtype == np.float32,
          f"phase 26a: shard {got.shape} {got.dtype}")
    err = float(np.abs(got - want).max())
    check(bool(np.isfinite(got).all()) and err <= MEL_BAR,
          f"phase 26a: card mels off the CPU's by {err:.3g} (bar {MEL_BAR})")
    shutil.rmtree(work / "cpu_mels")
    stereo = sum(1 for i in range(P26_CLIPS) if i % 8 == P26_STEREO and i != P26_BAD)
    log(f"  [{card}] ingest of {P26_CLIPS} samples (2-30 s, {stereo} at 44.1 kHz stereo, one "
        f"that does not decode): {card_s:.2f} s with the mels on the card "
        f"({good / card_s:,.1f} clips/s: decode, resample, log-mel, the shard write), "
        f"{cpu_s:.2f} s on the CPU; {good} mels within {err:.3g} of the CPU's (bar {MEL_BAR})")
    return {"ingest_s": card_s, "clips_per_s": good / card_s, "cpu_s": cpu_s,
            "max_abs_err": err, "clips": good}


def p26_extract_tiny(work: Path, dev, launch_mod, cfg_mod, cache_mod, ds_mod, W, E, CE,
                     samples: list, card: str) -> dict:
    """Phase 26b: ``launch extract --dataset librispeech_asr`` (whisper-tiny,
    bf16, batch 64, every layer, random weights) from 26a's cache."""
    reset_enc_launches(CE)
    E.plain_calls.clear()
    t0 = time.perf_counter()
    out = launch_mod.main(["extract", "--dataset", "librispeech_asr", "--max-samples",
                           str(P26_CLIPS), "--batch-size", "64", "--layers-encoder", "0,1,2,3",
                           "--layers-decoder", "0,1,2,3", "--cache-dir", str(work / "cache"),
                           "--random-whisper", "--device", str(dev)])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    clips = P26_CLIPS - 1
    batches = -(-clips // 64)
    want = {"conv_stem": batches, **{n: 4 * batches for n in ("ln_qkv", "self_attention",
                                                              "out_proj", "mlp_block")},
            "flash_self_attention": 0}
    check(launches == want, f"phase 26b: launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"phase 26b: plain versions ran: {E.plain_calls}")
    features = work / "cache" / "features"
    elog = json.loads((features / "extraction_log.json").read_text())
    texts = json.loads((features / "transcripts.json").read_text())
    want_texts = [s["text"] for i, s in enumerate(samples) if i != P26_BAD]
    check(out["dataset"] == elog["dataset"] == "librispeech_asr"
          and [texts[str(i)] for i in range(clips)] == want_texts,
          "phase 26b: extraction log or transcripts differ from the stream")

    # the first batch's first clips against the plain route on the CPU
    arch = W.arch_for("openai/whisper-tiny")
    gen = torch.Generator(device=dev).manual_seed(P26_WEIGHT_SEED)  # as the job makes them
    p_dev = W.init_whisper(gen, arch)
    mels = ds_mod.LibriSpeechDataset(cfg_mod.DataConfig(cache_dir=work / "cache",
                                                        max_samples=P26_CLIPS))
    mel = torch.from_numpy(np.stack([mels[i]["input_features"] for i in range(min(64, clips))]))
    t0 = time.perf_counter()
    ref = W.extract_activations(W.params_to(p_dev, "cpu"), mel[:P26_REF_CLIPS], arch,
                                compute_dtype=torch.bfloat16, capture_dtype=torch.bfloat16)
    cpu_s = time.perf_counter() - t0
    cache = cache_mod.FeatureCache(features, cfg_mod.WhisperConfig(),
                                   cfg_mod.DataConfig(max_samples=P26_CLIPS))
    worst = {}
    for comp, tokens in (("encoder", ENC_T), ("decoder", 1)):
        for layer in range(4):
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples)
                  == (clips * tokens, ENC_D, clips)
                  and meta.data_config["dataset_name"] == "librispeech_asr",
                  f"phase 26b: {comp}:{layer} metadata {meta}")
            rows, _ = cache.load(comp, layer)
            check(bool(torch.isfinite(rows).all()), f"phase 26b: {comp}:{layer} non-finite")
            n = P26_REF_CLIPS * tokens
            bar_check(rows[:n], ref[comp][layer].reshape(-1, ENC_D), STACK_BAR,
                      f"phase 26b: {comp}:{layer} first {P26_REF_CLIPS} clips, card vs CPU")
            worst[f"{comp}:{layer}"] = rel_err(rows[:n], ref[comp][layer].reshape(-1, ENC_D))[1]
            del rows
    # one batch of 64 clips on the card, as the job runs it
    mel_dev = mel.to(dev)
    batch_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W.extract_activations(p_dev, mel_dev, arch, compute_dtype=torch.bfloat16,
                              capture_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    batch_ms = float(np.mean(batch_ms[1:]))
    del p_dev, mel_dev
    log(f"  [{card}] launch extract --dataset librispeech_asr: {clips} clips in {extract_s:.2f} s "
        f"({clips / extract_s:,.1f} clips/s end to end: mel cache read, forward, transfer, "
        f"disk); a {len(mel)}-clip batch {batch_ms:.2f} ms of wall ({len(mel) * 1e3 / batch_ms:,.1f} "
        f"clips/s); "
        f"launches {launches}; first {P26_REF_CLIPS} clips vs the CPU's plain route "
        f"({cpu_s:.1f} s there), mean rel err by layer "
        + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + " (stack bar 2**-7)")
    return {"launches": launches, "extract_s": extract_s, "clips_per_s": clips / extract_s,
            "batch_ms": batch_ms, "mean_rel_err": worst}


def p26_extract_large(work: Path, dev, launch_mod, cfg_mod, cache_mod, ds_mod, W, E, CE,
                      samples: list, card: str) -> dict:
    """Phase 26c: one 16-clip whisper-large-v3 batch from a ``_mel128``
    cache of the first 16 clips that decode."""
    good = [s for i, s in enumerate(samples) if i != P26_BAD][:P26_LG_CLIPS]
    lg = work / "lcache"
    t0 = time.perf_counter()
    p26_dataset(ds_mod, cfg_mod, lg, good, dev, n_mels=128, max_samples=P26_LG_CLIPS)
    ingest_s = time.perf_counter() - t0
    stem = f"librispeech_clean_train.100_{P26_LG_CLIPS}_mel128"
    check(sorted(p.name for p in lg.iterdir()) == [f"{stem}_meta.json", f"{stem}_shard00000.npy"],
          f"phase 26c: mel128 cache {sorted(p.name for p in lg.iterdir())}")
    reset_enc_launches(CE)
    E.plain_calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launch_mod.main(["extract", "--model-name", LV3, "--dataset", "librispeech_asr",
                     "--max-samples", str(P26_LG_CLIPS), "--batch-size", str(P26_LG_CLIPS),
                     "--layers-encoder", ",".join(map(str, LG_ENC_LAYERS)), "--layers-decoder",
                     ",".join(map(str, LG_DEC_LAYERS)), "--cache-dir", str(lg),
                     "--random-whisper", "--device", str(dev)])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = enc_launches(CE)
    arch = W.arch_for(LV3)
    want = {"conv_stem": 1, **{n: arch.encoder_layers for n in ("ln_qkv", "self_attention",
                                                               "out_proj", "mlp_block")},
            "flash_self_attention": 0}
    check(launches == want, f"phase 26c: launches {launches} != {want}")
    check(sum(E.plain_calls.values()) == 0, f"phase 26c: plain versions ran: {E.plain_calls}")
    cache = cache_mod.FeatureCache(lg / "features", cfg_mod.WhisperConfig(model_name=LV3),
                                   cfg_mod.DataConfig(max_samples=P26_LG_CLIPS))
    pb = W.cast_params(W.init_whisper(torch.Generator(device=dev).manual_seed(P26_WEIGHT_SEED),
                                      arch), torch.bfloat16)
    mels = ds_mod.LibriSpeechDataset(cfg_mod.DataConfig(cache_dir=lg, max_samples=P26_LG_CLIPS),
                                     n_mels=128)
    mel2 = torch.from_numpy(np.stack([mels[i]["input_features"] for i in range(2)])).to(dev)
    check(mel2.shape == (2, 128, 3000), f"phase 26c: mel {tuple(mel2.shape)}")
    ref = W.extract_activations(pb, mel2, arch, compute_dtype=torch.bfloat16,
                                capture_dtype=torch.bfloat16)
    d = arch.d_model
    for comp, layers, tokens in (("encoder", LG_ENC_LAYERS, ENC_T), ("decoder", LG_DEC_LAYERS, 1)):
        for layer in layers:
            meta = cache.load_metadata(comp, layer)
            check((meta.num_tokens, meta.hidden_dim, meta.num_samples)
                  == (P26_LG_CLIPS * tokens, d, P26_LG_CLIPS), f"phase 26c: {comp}:{layer} {meta}")
            rows, _ = cache.load(comp, layer)
            bar_check(rows[:2 * tokens], ref[comp][layer].reshape(-1, d), STACK_BAR,
                      f"phase 26c: {comp}:{layer} first 2 clips vs extract_activations")
            del rows
    del pb, ref
    shutil.rmtree(lg, ignore_errors=True)
    log(f"  [{card}] whisper-large-v3 from the mel128 cache ({P26_LG_CLIPS} clips ingested on the "
        f"card in {ingest_s:.2f} s): launch extract {extract_s:.2f} s ({P26_LG_CLIPS / extract_s:.2f} "
        f"clips/s end to end, weights made on the card); launches {launches}")
    return {"launches": launches, "extract_s": extract_s, "ingest_s": ingest_s}


def p26_cli(work: Path, dev, train_mod, launch_mod, cfg_mod, ds_mod, CE, cuda_sae, topk,
            samples: list, card: str) -> dict:
    """Phase 26d: the CLI with ``dataset_name: librispeech_asr`` on 26a's mel
    cache (its own features beside it): extraction of encoder:3, one epoch
    of windowed kernel-A steps at whisper-tiny 8x (batch 128, AMP), then
    ``causal-validate`` on 26b's extraction log."""
    import yaml

    cli_dir = work / "cli_cache"
    cli_dir.mkdir()
    for f in (work / "cache").glob(f"librispeech_clean_train.100_{P26_CLIPS}*"):
        (cli_dir / f.name).symlink_to(f)
    cfg = yaml.safe_load((ROOT / "configs" / "tiny_default.yaml").read_text())
    check(cfg["data"]["dataset_name"] == "librispeech_asr", "tiny_default.yaml's dataset changed")
    cfg["data"].update(max_samples=P26_CLIPS, cache_dir=str(cli_dir))
    cfg["training"].update(epochs=1, warmup_steps=100)
    cfg["output_dir"] = str(work / "cli_out")
    cfg["experiment_name"] = "real_audio"
    path = work / "real_audio.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--layer", "encoder:3", "--no-wandb", "--device", str(dev)]
    reset_enc_launches(CE)
    t0 = time.perf_counter()
    train_mod.main(args + ["--extract-only", "--random-whisper"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    enc = enc_launches(CE)
    clips = P26_CLIPS - 1
    check(enc["conv_stem"] == 2 and enc["mlp_block"] == 8,
          f"phase 26d: the CLI's extraction launches {enc}")
    zero_kernel_a(cuda_sae, topk)
    t0 = time.perf_counter()
    (trainer,) = train_mod.main(args).values()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel_a_launches(cuda_sae)
    rows = clips * ENC_T
    metrics = json.loads((trainer.run_dir / "metrics.json").read_text())
    losses = np.array([m["loss"] for m in metrics])
    check(launches["fused_sae_loss_indexed"] == rows // 128 and launches["fused_sae_loss"] >= 1
          and len(metrics) == -(-rows // 128) and sum(topk.plain_calls.values()) == 0,
          f"phase 26d: kernel A launches {launches}, {len(metrics)} steps, plain calls "
          f"{dict(topk.plain_calls)}")
    tenth = len(losses) // 10
    check(bool(np.isfinite(losses).all()) and losses[-tenth:].mean() < losses[:tenth].mean(),
          f"phase 26d: loss {losses[:tenth].mean():.5f} -> {losses[-tenth:].mean():.5f}")

    # causal-validate: the JAX job reads the mel cache under the working
    # directory's cache/, keyed by num_samples
    good = [s for i, s in enumerate(samples) if i != P26_BAD][:P26_CAUSAL]
    with contextlib.chdir(work):
        p26_dataset(ds_mod, cfg_mod, Path("cache"), good, dev, max_samples=P26_CAUSAL)
        t0 = time.perf_counter()
        out = launch_mod.main(["causal-validate", "--component", "encoder", "--layer-idx", "3",
                               "--num-samples", str(P26_CAUSAL), "--sweep-features", "2",
                               "--random-whisper", "--cache-dir", str(work / "cache"),
                               "--run-dir", str(trainer.run_dir), "--device", str(dev)])
        causal_s = time.perf_counter() - t0
    saved = json.loads((trainer.run_dir / "analysis" / "causal_validation.json").read_text())
    check(saved["num_samples"] == P26_CAUSAL and np.isfinite(saved["logit_kl"])
          and saved["logit_kl"] >= 0 and 0 <= saved["token_agreement"] <= 1
          and len(saved["ablation_sweep"]) == 2, f"phase 26d: causal-validate {out}")
    log(f"  [{card}] the CLI on the LibriSpeech cache: encoder:3 of {clips} clips extracted in "
        f"{extract_s:.2f} s ({clips / extract_s:,.1f} clips/s), one epoch of {len(metrics)} steps "
        f"in {train_s:.2f} s ({rows / train_s:,.0f} act/s end to end), kernel A launches "
        f"{launches}, loss {losses[:tenth].mean():.5f} -> {losses[-tenth:].mean():.5f}; "
        f"causal-validate {causal_s:.2f} s: logit_kl {saved['logit_kl']:.6g}, token agreement "
        f"{saved['token_agreement']}")
    return {"enc_launches": enc, "launches": launches, "extract_s": extract_s,
            "train_s": train_s, "act_per_s": rows / train_s, "causal_s": causal_s,
            "logit_kl": saved["logit_kl"]}


def p26_relu_trainer(mesh, run_dir: Path):
    """The ReLU SAE at whisper-large 32x (D=1280, H=40960), AMP, batch 8192."""
    from whisper_sae_tpu_torch.config import TrainingConfig
    from whisper_sae_tpu_torch.models.sae import ReLUSAE
    from whisper_sae_tpu_torch.training.trainer import SAETrainer

    sae = ReLUSAE(P25_LD, P25_LH, seed=42, device="cuda")
    return SAETrainer(sae, TrainingConfig(batch_size=P25_TP_BATCH, learning_rate=1e-3,
                                          warmup_steps=2, use_amp=True, seed=42),
                      run_dir=run_dir, mesh=mesh)


def p26_relu_tp(rank: int, work: Path) -> dict:
    """Phase 26e, a rank of the ReLU SAE with tp = 2 (20,480 features a
    rank): 6 steps on phase 25's whisper-large rows, each step's
    all-reduces timed after the first, the peak memory, then the gathered
    checkpoint (rank 0 writes it)."""
    from whisper_sae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 2)
    timer = CollectiveTimer()
    trainer = p26_relu_trainer(mesh, work / "relu_tp")
    trainer._place_on_mesh()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, colls = [], [], []
    for s in range(P25_TP_STEPS):
        x = p25_large_rows(s)
        timer.on = s > 0  # the first step also warms up
        m, ms = p25_timed(lambda: trainer.train_step(x))
        timer.on = False
        if s > 0:
            step_ms.append(ms)
            colls.append(timer.totals())
        losses.append(m.loss)
    peak = torch.cuda.max_memory_allocated()
    specs = trainer._tp_family().param_specs
    out = {"losses": losses, "step_ms": step_ms, "collectives": colls, "peak_bytes": peak,
           "resident_bytes": resident,
           "replicated": {k: v.detach().cpu().numpy().tobytes()
                          for k, v in trainer.model.params.items() if specs[k] is None},
           "local_shapes": {k: tuple(v.shape) for k, v in trainer.model.params.items()},
           "moment_shapes": {k: tuple(v.shape) for k, v in trainer.opt_state.mu.items()}}
    trainer.save_checkpoint("relu_tp.npz")
    out["full_bits"] = p25_params_bits(trainer.full_params())
    out["ckpt"] = str(trainer.run_dir / "relu_tp.npz")
    return out


def p26_relu_reference(work: Path) -> dict:
    """The same ReLU SAE run in this process, replicated: losses, ms a
    step and the memory it holds and peaks at."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = p26_relu_trainer(None, work / "relu_ref")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    losses, step_ms = [], []
    for s in range(P25_TP_STEPS):
        x = p25_large_rows(s)
        m, ms = p25_timed(lambda: trainer.train_step(x))
        losses.append(m.loss)
        step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated() - base
    del trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": float(np.mean(step_ms[1:])), "peak_bytes": peak,
            "resident_bytes": resident}


def p26_relu(work: Path, sae_mod, card: str) -> dict:
    """Phase 26e: the ReLU SAE's model-axis form over two ranks sharing the
    card (gloo), against one process."""
    from whisper_sae_tpu_torch.utils.checkpoint import load_pytree

    t0 = time.perf_counter()
    tp = p25_spawn("p26_relu_tp", 2, work)
    tp_s = time.perf_counter() - t0
    ref = p26_relu_reference(work)
    got, want = np.array(tp[0]["losses"]), np.array(ref["losses"])
    worst = float(np.max(np.abs(got - want) / np.abs(want)))
    check(np.array_equal(got, np.array(tp[1]["losses"])) and worst <= 1e-4,
          f"phase 26e: tp losses {got} against one process's {want} (max rel {worst:.3e})")
    half = P25_LH // 2
    for r, o in enumerate(tp):
        check(o["local_shapes"] == {"w_enc": (P25_LD, half), "b_enc": (half,),
                                    "w_dec": (half, P25_LD), "b_dec": (P25_LD,)}
              and o["moment_shapes"] == o["local_shapes"],
              f"phase 26e: rank {r} holds {o['local_shapes']}, moments {o['moment_shapes']}")
    check(tp[0]["replicated"] == tp[1]["replicated"] and set(tp[0]["replicated"]) == {"b_dec"},
          "phase 26e: b_dec differs across ranks")
    tree, meta = load_pytree(tp[0]["ckpt"])
    single = sae_mod.ReLUSAE(P25_LD, P25_LH, params=tree["params"], device="cuda")
    check(p25_params_bits(single.params) == tp[0]["full_bits"] == tp[1]["full_bits"]
          and meta["global_step"] == P25_TP_STEPS,
          "phase 26e: the gathered checkpoint does not load as the trained ReLU SAE")
    del single, tree
    tp_ms = [float(np.mean(o["step_ms"])) for o in tp]
    coll = p25_coll_summary(p25_merge(tp[0]["collectives"]), tp_ms[0], P25_TP_STEPS - 1)
    share = sum(c["share"] for c in coll.values())
    log(f"  [{card}] ReLU SAE tp = 2 at whisper-large 32x (D={P25_LD}, H={P25_LH}, {half} a "
        f"rank), batch {P25_TP_BATCH}, {P25_TP_STEPS} steps: {tp_s:.1f} s with the process "
        f"starts; losses within {worst:.3e} of one process (by step "
        f"{[float(f'{v:.3g}') for v in np.abs(got - want) / np.abs(want)]}); w_enc by rank "
        f"{[o['local_shapes']['w_enc'] for o in tp]}; b_dec bit for bit across ranks; the "
        f"gathered checkpoint loads into one ReLUSAE; GB held / peak by rank "
        f"{[(round(o['resident_bytes'] / 1e9, 3), round(o['peak_bytes'] / 1e9, 3)) for o in tp]}"
        f" against the replicated one-process run's ({ref['resident_bytes'] / 1e9:.3f}, "
        f"{ref['peak_bytes'] / 1e9:.3f}); ms a step {[round(m, 3) for m in tp_ms]} (one process "
        f"{ref['step_ms']:.3f}); all-reduces {share:.1%} of a step: {json.dumps(coll)}")
    return {"s": tp_s, "worst_rel": worst, "step_ms": tp_ms, "ref_step_ms": ref["step_ms"],
            "peak_gb": [o["peak_bytes"] / 1e9 for o in tp],
            "resident_gb": [o["resident_bytes"] / 1e9 for o in tp],
            "ref_peak_gb": ref["peak_bytes"] / 1e9, "ref_resident_gb": ref["resident_bytes"] / 1e9,
            "collectives": coll, "allreduce_share": share}


def real_audio_path(work: Path, dev, card: str, train_mod, launch_mod, cfg_mod, cache_mod,
                    ds_mod, sae_mod, W, E, CE, cuda_sae, topk, wavio) -> dict:
    """Phase 26: (a) ingest, (b) whisper-tiny and (c) whisper-large-v3
    extraction from the mel cache through the launcher, (d) the CLI and
    causal-validate on it, (e) the ReLU SAE with tp = 2."""
    t_phase = time.perf_counter()
    work = work / "p26"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    samples = p26_stream(work, ds_mod, wavio)
    log(f"  (a) a LibriSpeech-shaped stream of {P26_CLIPS} samples made in "
        f"{time.perf_counter() - t0:.1f} s; LibriSpeechDataset._ingest, mels on the card, "
        "against the same stream on the CPU")
    a = p26_ingest(work, dev, ds_mod, cfg_mod, samples, card)
    log("  (b) launch extract --dataset librispeech_asr: whisper-tiny, bf16, batch 64, every layer")
    b = p26_extract_tiny(work, dev, launch_mod, cfg_mod, cache_mod, ds_mod, W, E, CE, samples,
                         card)
    log(f"  (c) launch extract: whisper-large-v3, one {P26_LG_CLIPS}-clip batch from a mel128 cache")
    c = p26_extract_large(work, dev, launch_mod, cfg_mod, cache_mod, ds_mod, W, E, CE, samples,
                          card)
    log("  (d) the CLI with dataset_name: librispeech_asr, then causal-validate")
    d = p26_cli(work, dev, train_mod, launch_mod, cfg_mod, ds_mod, CE, cuda_sae, topk, samples,
                card)
    log(f"  (e) the ReLU SAE with tp = 2 sharing the card (gloo): whisper-large 32x geometry")
    e = p26_relu(work, sae_mod, card)
    shutil.rmtree(work, ignore_errors=True)
    return {"card": card, "ingest": a, "tiny": b, "large_v3": c, "cli": d, "relu_tp": e,
            "phase_s": time.perf_counter() - t_phase}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from whisper_sae_tpu_torch import train as train_mod
        from whisper_sae_tpu_torch import config as cfg_mod
        from whisper_sae_tpu_torch.data import feature_cache as cache_mod
        from whisper_sae_tpu_torch.models import sae as sae_mod
        from whisper_sae_tpu_torch.ops import _build, cuda_sae, cuda_topk, topk
        from whisper_sae_tpu_torch.data import librispeech as ds_mod
        from whisper_sae_tpu_torch.models import whisper as W
        from whisper_sae_tpu_torch.ops import cuda_encoder as CE
        from whisper_sae_tpu_torch.ops import encoder as E
        from whisper_sae_tpu_torch import launch as launch_mod
        from whisper_sae_tpu_torch.models import crosscoder as XC
        from whisper_sae_tpu_torch.models import transcoder as TC
        from whisper_sae_tpu_torch.ops import cuda_coder as CC
        from whisper_sae_tpu_torch.training import coder_trainers as CT
        from whisper_sae_tpu_torch.models import hooks as H
        from whisper_sae_tpu_torch import decoder_analysis as DA
        from whisper_sae_tpu_torch.utils import wavio
        from whisper_sae_tpu_torch.causal import patching as P
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    check(bool(card), f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    log(f"phase 0: built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  {line.strip()}")
    _build.load_library()

    log("phase 1: kernels against their plain versions")
    errs = kernel_phase(dev, cuda_sae, cuda_topk, topk, _build.load_library())
    log("phase 1b: the step's backward over the selected latents at the training cells' shapes, "
        "each on its route, against its plain version and the dense products, then timed")
    bwd = backward_phase(dev, cuda_sae)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    mix = write_cache(work, dev, cfg_mod, cache_mod)
    wrappers = {
        "fused_sae_loss": cuda_sae.fused_sae_loss,
        "fused_sae_loss_indexed": cuda_sae.fused_sae_loss_indexed,
        "fused_topk_encode": cuda_sae.fused_topk_encode,
        "topk_mask": cuda_topk.topk_mask_fwd,
        "sae_topk_backward": cuda_sae.sae_topk_backward,
    }
    for w in wrappers.values():
        w.launches = 0
    cuda_sae.sae_topk_backward.composed_launches = 0
    log("phases 2-3: train through the CLI, then eval")
    forms0 = cuda_sae.encode_select_launches()
    trainer, sae, held_out = main_path(work, dev, mix, train_mod, sae_mod)
    launches = {name: w.launches for name, w in wrappers.items()}
    b_forms = {f: n - forms0[f] for f, n in cuda_sae.encode_select_launches().items()}
    log(f"  launches on the main path: {launches}")
    eval_against_cpu(sae, held_out, sae_mod)
    for name, n in launches.items():
        check(n > 0, f"{name}: no launch on the main path")
    check(launches["fused_sae_loss_indexed"] == EPOCHS * (N_ROWS // 128),
          "windowed kernel A launches != fused steps")
    check(launches["sae_topk_backward"] == EPOCHS * (N_ROWS // 128 + 1)
          and cuda_sae.sae_topk_backward.composed_launches == 0,
          f"sae_topk_backward: {launches['sae_topk_backward']} launches ("
          f"{cuda_sae.sae_topk_backward.composed_launches} composed) for "
          f"{EPOCHS * (N_ROWS // 128 + 1)} kernel-A steps")

    log("phase 4: times (ms per call; library_ms is a yardstick: the bf16 encode product "
        "for A and B, torch.topk for C -- not equivalents)")
    step_profile(trainer, gaussian_rows(200 * trainer.config.batch_size,
                                        torch.Generator(device=dev).manual_seed(5), mix), 200)
    res = times(dev, cuda_sae, cuda_topk, topk)

    log("phase 5: encoder kernels at whisper-tiny width, 64 clips, against their plain versions")
    enc_errs, enc_inp = encoder_kernel_phase(dev, W, E, CE)

    log("phase 6: extraction through the CLI, then agreement and training from its cache")
    extraction = extraction_path(work, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE)
    replaces = {
        "fused_sae_loss": "src/whisper_sae_tpu/ops/pallas_sae.py:249",
        "fused_sae_loss_indexed": "src/whisper_sae_tpu/ops/pallas_sae.py:424",
        "fused_topk_encode": "src/whisper_sae_tpu/ops/pallas_sae.py:77",
        "topk_mask": "src/whisper_sae_tpu/ops/pallas_topk.py:51",
    }
    kernels = []
    for name in replaces:
        wide = name != "topk_mask"  # kernels A and B: also at A_WIDE_BATCH, with split_ms
        for b in (*BATCHES, A_WIDE_BATCH) if wide else BATCHES:
            ms, plain, bound_ms, by, lib_ms = res[(name, b)]
            log(f"  {name:24s} B={b:5d}: {ms:.4f} ms, plain {plain:.4f}, bound {bound_ms:.4f} "
                f"({by}), library {lib_ms:.4f}")
        ms, plain, bound_ms, by, lib_ms = res[(name, BATCHES[-1])]
        s_ms, s_plain, s_bound, s_by, s_lib = res[(name, BATCHES[0])]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "batch": BATCHES[-1],
            "at_batch_128": {"ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
                             "bound_by": s_by, "library_ms": s_lib},
        }
        if wide:
            w_ms, w_plain, w_bound, w_by, w_lib = res[(name, A_WIDE_BATCH)]
            entry[f"at_batch_{A_WIDE_BATCH}"] = {"ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
                                                 "bound_by": w_by, "library_ms": w_lib}
            entry["split_ms"] = {str(b): res[("split", name, b)]
                                 for b in (*BATCHES, A_WIDE_BATCH)}
        if name == "fused_topk_encode":
            entry["source"] = BLOCKED_SOURCE
            entry["sources"] = [BLOCKED_SOURCE, SOURCE, GEMM_SOURCE]
            entry["route_launches"] = list(B_PARTS.values())
            entry["select_forms"] = b_forms
        kernels.append(entry)
    r = bwd["tiny8x"]
    kernels.append({
        "name": "sae_topk_backward", "route": "cuda", "source": BWD_SOURCE, "replaces": None,
        "launches": launches["sae_topk_backward"], "max_rel_gap": r["max_rel_gap"],
        **{k_: r[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "batch",
                                "split_ms", "entries", "geometry")},
        "at_large32x": {k_: v for k_, v in bwd["large32x"].items() if k_ != "composed"},
    })
    log("phase 7: times of the extraction slice (library_ms: torch.matmul for the "
        "projections, the conv1d pair for the stem, scaled_dot_product_attention for the core "
        "-- yardsticks, not equivalents)")
    ext_times = extraction_times(dev, W)
    log(f"  CLI extraction end to end: {extraction['cli_clips_per_s']:,.1f} clips/s")
    ext_times["breakdown_ms"] = extraction_breakdown(work, dev, W, cfg_mod, cache_mod, ds_mod)
    enc_res = encoder_kernel_times(enc_inp, E, CE)
    enc_parts = encoder_prep_and_parts(enc_inp, CE, _build.load_library())
    for name in ENC_WRAPPERS:
        ms, plain, bound_ms, by, lib_ms = enc_res[name]
        log(f"  {name:24s} B={ENC_B:5d}: {ms:.4f} ms, plain {plain:.4f}, bound {bound_ms:.4f} "
            f"({by}), library {lib_ms:.4f}")
        kernels.append({
            "name": name, "route": "cuda", "source": enc_source(name),
            "replaces": ENC_REPLACES[name],
            "launches": extraction["launches"][name], "max_abs_err": enc_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "batch": ENC_B, **prep_entry(name, enc_parts),
        })
        if name == "conv_stem":
            kernels[-1]["sources"] = [ENC_SOURCE, GEMM_SOURCE]
            kernels[-1]["route_launches"] = list(STEM_PARTS.values())
    log(f"  extraction: {json.dumps({**ext_times, 'cli_clips_per_s': extraction['cli_clips_per_s']})}")

    log("phase 8: the coder kernel at whisper-tiny width, B=4096, against its plain version")
    coder_errs = coder_kernel_phase(dev, CC)
    log("phase 9: ReLU SAE through the CLI; extract, transcoders and crosscoders through "
        "whisper_sae_tpu_torch.launch")
    path9 = coder_path(work, dev, mix, train_mod, launch_mod, cfg_mod, cache_mod, sae_mod, TC, XC,
                       CC, E)
    log("phase 10: times of the coder slice (library_ms: the bf16 encode product, plus the "
        "dense decode product in ReLU modes -- yardsticks, not equivalents)")
    ctimes = coder_times(dev, CC)
    steps10 = coder_step_times(work, dev, TC, XC, CT, cfg_mod, path9.pop("relu_trainer"), mix)
    for mode in CODER_MODES:
        for entry, replaces, key in (
                ("fused", "src/whisper_sae_tpu/ops/pallas_sae.py:679", "ms"),
                ("fused_indexed", "src/whisper_sae_tpu/ops/pallas_sae.py:1057", "indexed_ms")):
            r = ctimes[(mode, CODER_B)]
            name = {"relu_sae": "fused_relu_sae_loss", "relu_crosscoder": "fused_relu_crosscoder_loss"
                    }.get(mode, "fused_transcoder_loss") + ("_indexed" if "indexed" in entry else "")
            kernels.append({
                "name": f"coder_{entry}[{mode}]", "route": "cuda", "source": CODER_SOURCE,
                "replaces": replaces, "launches": path9["by_mode"].get((name, mode), 0),
                "max_abs_err": coder_errs[mode], "ms": r[key], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "batch": CODER_B,
                **{f"at_batch_{b}": {
                    "ms": ctimes[(mode, b)][key], "plain_ms": ctimes[(mode, b)]["plain_ms"],
                    "bound_ms": ctimes[(mode, b)]["bound_ms"],
                    "bound_by": ctimes[(mode, b)]["bound_by"],
                    "library_ms": ctimes[(mode, b)]["library_ms"]}
                   for b in CODER_TIME_BATCHES if b != CODER_B},
            })
            split = "split_ms" if key == "ms" else "indexed_split_ms"
            kernels[-1]["split_ms"] = {str(b): ctimes[(mode, b)][split]
                                       for b in CODER_TIME_BATCHES}
            if mode == "skip_transcoder":
                kernels[-1]["split_note"] = ("encode and skip_product are both gemm_kernel<3>: "
                                             "the second of a call's two is the skip product")
    for k_ in [k_ for k_ in kernels if k_["name"].startswith("coder_")]:
        check(k_["launches"] > 0, f"{k_['name']}: no launch on the coder path")
    log(f"  coder slice: {json.dumps({'steps': steps10, 'losses': path9['losses'], 'job_s': path9['job_s'], 'relu_sae_train_s': path9['relu_sae_train_s'], 'extract_s': path9['extract_s']})}")

    log("phase 11: whisper-large 32x kernels (D=1280, H=40960) against their plain versions")
    large_errs = large_kernel_phase(dev, cuda_sae, cuda_topk, topk)
    log("phase 12: the whisper-large 32x TopK SAE through the CLI")
    forms0 = cuda_sae.encode_select_launches()
    path12 = large_path(work, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk, topk)
    blocked_forms = {f: n - forms0[f] for f, n in cuda_sae.encode_select_launches().items()}
    log("phase 13: times at whisper-large 32x (library_ms: the bf16 torch.mm of the encode "
        "product, torch.topk -- yardsticks, not equivalents)")
    ltimes = large_times(work, dev, path12["trainer"], cuda_sae, cuda_topk, topk)
    for name, replaces in (("fused_topk_encode_blocked", "src/whisper_sae_tpu/ops/pallas_sae.py:1392"),
                           ("topk_mask_wide", "src/whisper_sae_tpu/ops/pallas_topk.py:51")):
        r = ltimes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": BLOCKED_SOURCE if name.endswith("blocked") else SOURCE, "replaces": replaces,
            "launches": path12["launches"][name], "max_abs_err": large_errs[name],
            **{k_: r[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "batch": BL,
        })
        check(kernels[-1]["launches"] > 0, f"{name}: no launch on the whisper-large path")
    kernels[-2]["sources"] = [BLOCKED_SOURCE, GEMM_SOURCE]
    kernels[-2]["select_forms"] = blocked_forms
    kernels[-2].update({k_: ltimes["fused_topk_encode_blocked"][k_] for k_ in (
        "split_ms", "encode_tflops", "select_passes_mean",
        "select_passes_max")})
    for entry in kernels:
        if entry["name"] == "sae_topk_backward":
            entry["at_large32x"]["launches"] = path12["launches"]["sae_topk_backward_composed"]
    log(f"  whisper-large slice: {json.dumps({'step': ltimes['step'], 'losses': path12['losses'], 'train_s': path12['train_s']})}")

    lg_cli_b = min(LG_CLIPS, train_mod.EXTRACT_BATCH)
    log(f"phase 14: encoder kernels at whisper-large-v3 width against their plain versions, "
        f"{lg_cli_b} clips: the batch every launch of phase 15's CLI run takes")
    lv3 = W.arch_for(LV3)
    one_layer = W.WhisperArch(lv3.d_model, 1, 1, lv3.num_heads, lv3.ffn_dim, n_mels=lv3.n_mels,
                              vocab_size=lv3.vocab_size)
    lg_errs, lg_inp = encoder_kernel_phase(dev, W, E, CE, one_layer, lg_cli_b)
    log("phase 15: whisper-large-v3 extraction through the CLI, then every layer against the "
        "composed route")
    path15 = large_extraction_path(work, dev, train_mod, cfg_mod, cache_mod, ds_mod, W, E, CE)
    log("phase 16: times at whisper-large-v3 (library_ms as in phase 7)")
    lg_batch = large_batch_times(dev, W, path15.pop("params"))
    lg_res = encoder_kernel_times(lg_inp, E, CE)
    lg_parts = encoder_prep_and_parts(lg_inp, CE, _build.load_library())
    del lg_inp
    for name in ENC_WRAPPERS:
        ms, plain, bound_ms, by, lib_ms = lg_res[name]
        log(f"  {name:24s} B={lg_cli_b:5d} (large-v3): {ms:.4f} ms, plain {plain:.4f}, bound "
            f"{bound_ms:.4f} ({by}), library {lib_ms:.4f}")
    for entry in kernels:
        name = entry["name"]
        if name in ENC_WRAPPERS:
            ms, plain, bound_ms, by, lib_ms = lg_res[name]
            entry["at_whisper_large_v3"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": lib_ms, "batch": lg_cli_b, "launches": path15["launches"][name],
                "max_abs_err": lg_errs[name], **prep_entry(name, lg_parts)}
    log(f"  whisper-large-v3 extraction: {json.dumps({**lg_batch, 'cli_clips_per_s': path15['cli_clips_per_s'], 'cli_s': path15['extract_s']})}")

    log("phase 17: a 2-shard cache trained through the CLI, out of core")
    ooc = out_of_core_path(work, dev, train_mod, cfg_mod, cache_mod, cuda_sae, topk)
    log("phase 18: train-crosscoder at S=6144 and train-transcoder above --max-resident-gb "
        "through the launcher")
    wide18 = wide_coder_path(work, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_topk, topk)
    log(f"  out of core and wide coders: {json.dumps({'ooc': ooc, 'wide': wide18})}")
    log("phase 19: transcription and capture: (a) whisper-large-v3 bf16 greedy decoding "
        f"({DEC_CLIPS} clips, max_len {DEC_LEN})")
    a19 = transcription_path(dev, W, E, CE)
    for entry in kernels:
        if entry["name"] in ENC_WRAPPERS:
            entry["at_transcription"] = {"launches": a19["launches"][entry["name"]],
                                         "clips": DEC_CLIPS, "max_len": DEC_LEN}
    log(f"  (b) launch transcribe: whisper-tiny f32, {TR_BATCH} clips, max_len {TR_LEN}")
    b19 = transcribe_cli_path(work, dev, W, wavio)
    log("  (c) the capture facades and decoder analysis")
    c19 = facades_path(W, H, DA, a19, b19)
    summary = {k: v for k, v in a19.items() if k not in ("pb", "mel")}
    summary.update(cli_job_s=b19["job_s"], cpu_decode_s=b19["cpu_s"],
                   cli_rows_differing=b19["rows_differing"], facades_max_abs_err=c19)
    del a19, b19
    log(f"  transcription: {json.dumps(summary)}")
    log("phase 20: (a) kernel A's wide route against its plain version")
    wide_errs = wide_kernel_phase(dev, cuda_sae)
    log("  (b) the whisper-small 8x TopK SAE through the CLI")
    path20 = small_path(work, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk, topk)
    log("  (c) times at whisper-small 8x (library_ms: the bf16 encode GEMM, a yardstick, not an "
        "equivalent; composed_ms: the route the wide one replaces at these widths)")
    wtimes = wide_times(dev, cuda_sae, sae_mod, topk)
    wsteps = wide_step_times(work, dev, path20["trainer"], path20["mix"])
    for name, key, replaces in (("fused_sae_loss", "ms", ":249"),
                                ("fused_sae_loss_indexed", "indexed_ms", ":424")):
        at = {b: {"ms": wtimes[b][key], **{k_: wtimes[b][k_] for k_ in (
            "composed_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}} for b in WIDE_BATCHES}
        kernels.append({
            "name": f"{name}_wide", "route": "cuda", "source": SOURCE,
            "sources": [SOURCE, SELECT_SOURCE, GEMM_SOURCE],
            "replaces": f"src/whisper_sae_tpu/ops/pallas_sae.py{replaces}",
            "launches": path20["launches"][f"{name}_wide"], "max_abs_err": wide_errs[f"{name}_wide"],
            **at[4096], "batch": 4096, "geometry": {"d": DS, "h": HS, "k": K},
            **{f"at_batch_{b}": at[b] for b in WIDE_BATCHES if b != 4096},
            "split_ms": {str(b): wtimes[b]["split_ms"] for b in WIDE_BATCHES},
            "route_launches": list(WIDE_PARTS.values()),
            "select_forms": FORMS["fused_sae_loss"],
        })
        check(kernels[-1]["launches"] > 0, f"{name}_wide: no launch on the whisper-small path")
    log(f"  whisper-small slice: {json.dumps({'steps': wsteps, 'losses': path20['losses'], 'train_s': path20['train_s'], 'turns_ms': {b: wtimes[b]['turns_ms'] for b in WIDE_BATCHES}, 'select_passes_mean': {b: wtimes[b]['select_passes_mean'] for b in WIDE_BATCHES}})}")
    log("phase 21: (a) the coder kernel past H = 3072 against its plain version")
    cw_errs = coder_wide_phase(dev, CC)
    log("  (b) the whisper-small 8x transcoders through the launcher")
    path21 = small_coder_path(work, dev, launch_mod, cfg_mod, cache_mod, CC, cuda_sae, cuda_topk,
                              topk, TC)
    log("  (d) times at whisper-small 8x (library_ms: the bf16 encode GEMM, a yardstick, not an "
        "equivalent; composed_ms: the route the kernel replaces at these widths)")
    cw_times = coder_wide_times(dev, CC, TC, XC, topk)
    cw_step = small_coder_step(work, dev, TC, CT, cfg_mod)
    cw_launches = {**path21["launches"], **wide18["launches"]}
    for mode, batches in CODER_WIDE_TIMED.items():
        wide = CODER_MODES[mode][2] is not None
        at = {b: {k_: cw_times[(mode, b)][k_] for k_ in (
            "ms", "composed_ms", "indexed_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for b in batches}
        main_b = 4096
        kernels.append({
            "name": f"coder_wide[{mode}]", "route": "cuda", "source": CODER_SOURCE,
            "sources": [CODER_SOURCE, SELECT_SOURCE, GEMM_SOURCE] if wide else [CODER_SOURCE,
                                                                                GEMM_SOURCE],
            "replaces": "src/whisper_sae_tpu/ops/pallas_sae.py:679",
            "also_replaces": "src/whisper_sae_tpu/ops/pallas_sae.py:1057",
            "launches": cw_launches[mode], "max_abs_err": cw_errs[mode],
            **at[main_b], "batch": main_b, "geometry": {"d": DS, "dout": DS, "h": HS,
                                                        "k": K if wide else None},
            **{f"at_batch_{b}": at[b] for b in batches if b != main_b},
            "split_ms": {str(b): cw_times[(mode, b)]["split_ms"] for b in batches},
            "route_launches": list((CODER_WIDE_SKIP_PARTS if mode == "skip_transcoder"
                                    else CODER_WIDE_PARTS if wide else RELU_PARTS).values()),
            **({"select_forms": {g: f for g, f in FORMS["coder"].items() if g.startswith(mode)}}
               if wide else {}),
        })
        check(kernels[-1]["launches"] > 0, f"coder_wide[{mode}]: no launch on its path")
    log(f"  whisper-small coder slice: {json.dumps({'step': cw_step, 'losses': path21['losses'], 'job_s': path21['job_s'], 'turns_ms': {f'{m}_{b}': cw_times[(m, b)]['turns_ms'] for m, bs in CODER_WIDE_TIMED.items() for b in bs}})}")
    log("phase 22: the research loop after extraction at whisper-tiny width: extract, train "
        "--all-layers --supervise with a kill, train.py --profile, analyze, causal-validate")
    r22 = research_path(work, dev, card, launch_mod, train_mod, sae_mod, cache_mod, ds_mod,
                        cuda_sae, cuda_topk, topk, W, P)
    for entry in kernels:
        if entry["name"] in r22["launches"]:
            entry["at_research_loop"] = {"launches": r22["launches"][entry["name"]]}
    log(f"  research loop [{card}]: {json.dumps({k_: v for k_, v in r22.items() if k_ != 'launches'})}")
    log("phase 23: the top-k encode and mask at every width the JAX package takes: (a) kernel B "
        "in its group, CTA and cluster forms, the blocked encode and kernel C past H = 40960, "
        "against their plain versions")
    w23 = encode_widths_phase(dev, cuda_sae, cuda_topk, topk)
    log("  (b) whisper-tiny 128x trained as the train job trains, f32 steps, TopKSAE.encode; (c) "
        "whisper-large 64x through the trainer")
    t23 = time.perf_counter()
    path23 = widths_path(work, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, cuda_topk,
                         topk)
    for name_, n_ in path23["launches"].items():
        check(n_ > 0, f"{name_}: no launch on phase 23's main path")
    cpu23 = widths_against_cpu(work, dev, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae,
                               path23)
    log("  (e) times (library_ms: the bf16 torch.mm of the encode product, torch.topk and a "
        "scatter for the mask -- yardsticks, not equivalents; at whisper-small 8x and large 8x "
        "kernel B in turns with the same rows in calls of 2048, the blocked encode's chunk there "
        "before both took one entry, and the group select with the CTA select it replaces)")
    step23 = step_profile(path23["large_trainer"], path23["large_rows"], LARGE_STEPS64)
    tm23 = widths_times(dev, cuda_sae, cuda_topk, topk)
    kernels.extend(widths_entries(path23, w23, tm23))
    shutil.rmtree(work / "widths", ignore_errors=True)
    log(f"  widths [{card}]: {json.dumps({'train_s': path23['train_s'], 'losses': path23['losses'], 'f32_losses': path23['f32_losses'], 'large_losses': path23['large_losses'], 'large_step': step23, **cpu23, 'phase_s': time.perf_counter() - t23})}")
    log("phase 24: the native shard reader and the single-device API at whisper-tiny width: (a) "
        "the reader, the CLI streaming a 2-shard cache through it, a chunked out-of-core epoch")
    a24 = api_slice_path(work, dev, card, train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, topk)
    for entry in kernels:
        if entry["name"] in a24["launches"]:
            entry["at_api_slice"] = {"launches": a24["launches"][entry["name"]]}
    log(f"  api slice [{card}]: {json.dumps({k_: v for k_, v in a24.items() if k_ != 'launches'})}")
    log("phase 25: parallel/ -- the (data, model) mesh over torch.distributed: (a) the CLI under "
        "torchrun, (b) two ranks sharing the card (dp, tp at whisper-large 32x, dp extraction), "
        "each against one process; (c) times (two ranks on one card measure correctness and the "
        "collectives' cost, not scaling)")
    p25 = parallel_path(work, dev, card, torch.Generator(device=dev).manual_seed(2025), mix,
                        train_mod, cfg_mod, cache_mod, sae_mod, cuda_sae, topk)
    for entry in kernels:
        name = entry["name"]
        if name in ("fused_sae_loss", "fused_sae_loss_indexed"):
            entry["at_parallel"] = {"torchrun_cli": p25["cli"]["launches"][name],
                                    "dp_by_rank": [l_[name] for l_ in p25["dp"]["launches"]]}
        elif name in ENC_WRAPPERS:
            entry["at_parallel"] = {"dp_extraction_by_rank": [l_[name] for l_ in
                                                              p25["extract"]["launches"]]}
    log(f"  parallel [{card}]: {json.dumps({k_: v for k_, v in p25.items() if k_ != 'card'})}")
    log("phase 26: the real-audio route, LibriSpeech's mel cache: (a) a local WAV stream ingested "
        "with the mels on the card, against the CPU; (b) whisper-tiny and (c) whisper-large-v3 "
        "extraction from it through the launcher; (d) the CLI and causal-validate on it; (e) the "
        "ReLU SAE's model-axis form over two ranks sharing the card")
    p26 = real_audio_path(work, dev, card, train_mod, launch_mod, cfg_mod, cache_mod, ds_mod,
                          sae_mod, W, E, CE, cuda_sae, topk, wavio)
    for entry in kernels:
        name = entry["name"]
        if name in ("fused_sae_loss", "fused_sae_loss_indexed"):
            entry["at_real_audio"] = {"cli_launches": p26["cli"]["launches"][name]}
        elif name in ENC_WRAPPERS:
            entry["at_real_audio"] = {"tiny_launches": p26["tiny"]["launches"][name],
                                      "large_v3_launches": p26["large_v3"]["launches"][name],
                                      "cli_launches": p26["cli"]["enc_launches"][name]}
    log(f"  real audio [{card}]: {json.dumps({k_: v for k_, v in p26.items() if k_ != 'card'})}")
    log(f"  rows selecting differently from the plain version (phases 1, 8, 11, 20, 21, 22, 23 and 24): "
        f"{json.dumps({what: rows for what, rows in GAPS.items() if rows})}; "
        f"checked with none: {sorted(what for what, rows in GAPS.items() if not rows)}")
    log(f"  decoded tokens differing from their reference (phase 19): "
        f"{json.dumps({what: rows for what, rows in TOKEN_GAPS.items() if rows})}; "
        f"checked with none: {sorted(what for what, rows in TOKEN_GAPS.items() if not rows)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-cli"]:  # phase 25a's child, started by torchrun
        p25_torchrun_child(sys.argv[2:])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
