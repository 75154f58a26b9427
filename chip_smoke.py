#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which stops the run with a non-zero exit when it fails:

1. **Card.**  Prints ``nvidia-smi``'s name and power limit and
   ``torch.cuda.get_device_name()``.  Then lowers path 2's functions and
   starts building every CUDA library the run needs (path 2's kDot
   epilogues and the §4.5 library in both dtypes, flash attention, WKV,
   the SSD scan, the masked softmax, RMSNorm and LayerNorm), one
   ``nvcc`` each, all at once, in the background while path 1 runs.
   When they are built, prints each flash-attention, GEMM, SSD, masked
   softmax, RMSNorm and LayerNorm instance's
   registers, stack, static shared memory, local memory, FFMA and
   tensor-core instructions (HMMA: ``mma.sync``; HGMMA: ``wgmma``), from
   ``cuobjdump`` of the built libraries where the toolkit has it; every
   16-bit GEMM instance must show HGMMA, no HMMA and no local memory,
   every f32 one FFMA, no HMMA or HGMMA, no local memory and its
   registers within its launch bound; the chunked SSD instances HMMA;
   no SSD, softmax or norm instance local memory.
2. **Path 1.**  Compiles TinyLlama-1.1B's decoder stack at full width
   (d_model 2048, 32/4 heads, d_ff 5632, 22 layers unrolled, ``ln_f`` and
   the 32000-wide head; random weights drawn on the card from a seeded
   ``torch.Generator``) with ``disc_torch.compile(..., backend="hopper")``,
   once in f32 and once in bf16, and serves requests of S = 37, 200, 731,
   1500, 1999 and then 45 (the bucket of 37: a cache hit).  Each output is
   held against the same model function run eagerly on the card, op by
   op, inside ``plain_versions()`` (no attention or RMSNorm kernel):
   max|Δ|/max|ref| ≤ 1e-3 in f32.  A bf16 output takes the accuracy
   rule alone: held against the function evaluated in f32 over the same
   weights, it may lie at most 1.25 times as far from it as eager's bf16
   output does (its distance from eager is printed: two equally exact
   bf16 evaluations of 22 random layers part by up to ~2e-2 by
   summation order alone).  Checks compiles ==
   distinct buckets, the cluster kernels' runs, and the launch counts of
   the kernels in that run (a kernel that fails raises: the path has no
   per-op fallback to count).  Each bucket's entry is one CUDA graph of
   its padded executor, which reads the request's lengths on the card:
   captured at the bucket's first request, replayed at every later one
   (checked: captures == compiles, the rest replays), the bytes copied
   into the graph a request exactly the padded input plus ``lens`` (no
   weight copied), launch counts counted through replays as the capture
   launched, and every graphed output equal bit for bit to the same
   request run under ``eager_entries()`` (the same kernels launched one
   by one).  One request at S = 37 and 1999, graphed and eager, is timed
   (median of 3 on the host clock) and run once under
   ``torch.profiler`` (wall and device-busy ms), on paths 1 and 2; the
   kLoop, kInput and GEMM kernels the card ran in that traced request
   must equal what the launch counters added (through a replay, the
   capture's counts) and the path's own count a request.
3. **Kernels.**  Holds every kernel program path 1 launched (recorded
   from one extra, uncounted run at S = 1999 under ``eager_entries()``:
   a replay calls no wrapper) against its plain version
   on the same card inputs, through the wrappers the path calls, in f32
   and bf16: at the path's ``n_valid`` and at one below the padded size,
   whose tails must be exactly zero.  kLoop must match bit for bit; a
   kInput sum row may differ by its f32 summation order, bounded
   relative to the row's sum of magnitudes.  Times kernel, plain version
   and (where one exists) a single PyTorch call with CUDA events at the
   path's ``n_valid``, and computes each kernel's bound from the bytes
   it must move; then prints the path's kLoop and kInput device ms a
   request (each program's launches in one request times its ms).  The
   wrappers' host µs a call at S = 37 (bucket 64), 1000 calls back to
   back (``launch_times``), print beside it.  After path 1 in f32, two
   kInput rows beyond the paths: one row of 4 M elements (its columns
   split over programs, the partials combined in a fixed order) and a
   reduce over axis 0 of 2048 x 2048, each held row by row and run twice
   (the same bits), timed beside ``torch.linalg.vecdot``.  Every kLoop
   and kInput launch of the paths must fall in the aligned class
   (``ops.UNALIGNED_LAUNCHES`` 0).
4. **Path 7 (control flow).**  (a) Path 1's model with its 22 layers as
   one ``d.scan``: path 1's weights stacked (L, ...) and the port's
   ``block_apply`` scanned over them with ``torch._higher_order_ops.scan``
   (the reference's ``_run_blocks``), then ``ln_f`` and the head, compiled
   with ``disc_torch.compile(..., backend="hopper")`` in f32 and bf16 and
   run on path 1's requests.  The artifact must hold exactly one
   ``d.scan`` of 22 trips; compiles == buckets; f32 within 1e-3 of path
   1's eager output for the same weights, bf16 under the accuracy rule;
   the cluster kernels outside the scan (``ln_f``'s kLoop at least) run
   and are counted (the scan's bodies run op by op, as the reference's
   executor runs them); graphed as path 1, with path 1's graph checks.
   (b) The control-flow functions of
   ``tests/test_control_flow.py`` at D = 2048 and S = 37, 731 and 1999
   (a while loop, a data-dependent trip count, a scan's carry and its ys,
   a reverse scan, a cond taking both branches, a while inside a scan;
   the doubling carries halve instead, since 2^S overflows f32), each
   under ``"hopper"`` and ``"nimble_vm"``, held against the function run
   by torch itself within 1e-4 max|d|/max|ref| (f32 summation order over
   up to 4 M elements), with each call's ``d.while`` predicate and
   ``d.cond`` index reads printed; under ``"hopper"`` the functions
   holding ``d.while`` / ``d.cond`` must report host entries and no
   capture, the ``d.scan``-only ones one graph a bucket, and
   ``"nimble_vm"`` no capture.  (c) The paper's §5.2 comparison,
   printed only: path 1's and path 7's lowered graphs timed at S = 37,
   731 and 1999 under ``"hopper"`` and ``"eager"`` (each bucket one
   CUDA graph; checked for each: captures == compiles, no host entry,
   the rest replays, each request's graphed output equal bit for bit to
   the same backend under ``eager_entries()``), under
   ``"hopper"`` inside ``eager_entries()`` (the same kernels launched
   one by one) and under ``NimbleVM(sync_per_op=True)``, the VM and the
   eager entries each as a ratio over the graph, with the VM's op
   dispatches, its interpretation seconds and their host share (the
   device time from ``torch.profiler``) at S = 1999.  Path 7's wall
   seconds are printed.
5. **Path 2.**  The same model with a token-major residual stream,
   x (T, 2048): the layer functions composed so that the MLP's
   projections are plain 2-D dots, which the planner fuses with their
   epilogues into kDot clusters (``x @ w_gate`` with ``silu(g) * h``,
   ``h @ w_out`` with the residual add).  Same requests, limits and
   checks as path 1 (graphs included), and kDot cluster runs ==
   GEMM-epilogue launches == the plan's kDots per request times the
   requests; every launch on the
   body of its dtype (``wgmma`` for bf16, ``ffma`` for f32) and no
   operand copied (``ops.OPERAND_COPIES``), every f32 launch on the
   16-byte instance (``ops.FFMA_SCALAR_LAUNCHES`` 0).  Path 2's kLoop
   and kInput programs are held and timed as in phase 3.  Then every
   kLoop and kInput program's generated modules and Triton
   specialisations print beside the instances it launched (plan
   constants, alignment class, operands' 16-byte bases), with each
   kernel's global loads and stores by width from its PTX: a program
   that built more kernels than instances (a recompile for a length)
   fails the run, and so does an aligned instance whose PTX shows no
   16-byte loads (kLoop: and stores).
6. **kDot kernel.**  Every kDot program path 2 launched (recorded at
   T = 1999) against ``matmul_fused_ref`` on the same card inputs: at the
   path's valid M, at a smaller valid M, and once with ragged N and K,
   the valid extents an int32[3] on the card that the kernel reads, as
   the path hands them over; max|Δ|/max|ref| ≤ 1e-5 (f32) and ≤ 8e-3
   (bf16), padded tails exactly zero.  Timed against its plain version and ``torch.matmul`` on the
   same operands (the GEMM alone, without the epilogue); its bound is
   the larger of bytes over 3.35 TB/s and 2·M·N·K over the peak of its
   type (67 TFLOP/s f32 FFMA; 989 TFLOP/s dense bf16 tensor cores).
   Each row prints TFLOP/s, ``bound_share`` (bound ms over ms),
   ``library_ratio`` (ms over ``torch.matmul``'s ms), the body, the
   tile and the K splits (``matmul.gemm_plan``).  Each
   program also runs at path 2's smallest bucket (T = 37 of 64, where
   split-K fills the card), checked the same way, twice (the two
   launches' outputs equal bit for bit), and timed beside
   ``torch.matmul`` (printed).
7. **Library.**  ``core.library.pick`` at shapes from TinyLlama's widths
   that select each of the five §4.5 versions and the vendor entry,
   once through ``pick`` (the counted run), then each version against
   ``matmul_ref`` under the same limits, timed like the kDot kernel,
   with the same body, tile, splits, ``bound_share`` and
   ``library_ratio``.
8. **Path 3 ("serve").**  TinyLlama-1.1B at full width and all 22
   layers (random bf16 weights from a seeded ``torch.Generator``, upcast
   for the f32 run), f32 then bf16, served by
   ``disc_torch.ServeEngine(max_batch=4, max_seq=2048)``
   (FIFO) on the jit pipeline: six requests of 37, 200, 731, 1500, 1999
   and 45 prompt tokens (ids from seeded numpy), 16 new tokens each —
   S buckets 64 to 2048, four slots for six requests.  Every attention
   runs the CUDA C++ flash-attention kernel and every RMSNorm the CUDA
   C++ one.  Each prefill bucket and the decode step is one CUDA graph:
   its first call runs eagerly and is then captured, and every later
   call replays it (``core/graphs.py``).  The same requests run again with
   ``prefill_chunk=512`` (offsets > 0: the kernel's ``q_offset``), once
   more through the same engine code inside ``plain_versions()``, and
   once under ``eager_entries()`` (the same kernels launched one by one,
   no graph).  Checks: prefill compiles == the distinct (B, S) buckets
   used, decode compiles == 1; in the graphed runs captures == compiles,
   every prefill launch and decode step after an entry's first a
   replay, and a decode step copying at most 1 KiB into its graph (its
   prefill copies, capture seconds, input buffers and the pool's bytes
   printed); flash-attention launches == 22 and RMSNorm launches == 45
   per prefill launch and decode step (a replay counts what its capture
   launched); the graphed streams identical to the eager run's, f32
   first-token logits within 1e-6 max|d|/max|ref|; one decode step of
   the graphed and of the eager run under ``torch.profiler`` (wall ms
   beside the card's busy ms, and the port's kernels the card ran in it
   held to the counts above); f32
   token streams identical to the plain versions' (and chunked to
   unchunked) with every token's logits within 1e-3 max|d|/max|ref|.
   In bf16, kernels vs plain versions is the accuracy rule of paths 1-2
   and 4-6: each request's first-token logits, from
   both runs, against the f32 run over the same weights; the kernels'
   may lie at most 1.25 times as far (equally exact kernels read 1.866e-2
   to 2.143e-2 from the plain versions there, PERF.md: a fixed 2e-2
   limit was at its noise floor).  Their logits distance is printed,
   and their streams may part only where the plain run's top-2 margin is
   below 2e-2; chunked vs unchunked keeps the logits within 2e-2 while
   the streams agree.  Prints time to first token and decode ms per
   step.
9. **Serve kernels.**  Flash attention at the path's shapes (prefill
   B=1, S=2048; a 512-row chunk at q_offset 1024; decode B=4 at the
   requests' fills) and RMSNorm on 2048 x 2048 and on a decode step's
   4 x 2048, each against its plain
   version on the same card inputs, with padded and fully masked rows
   checked to be exactly 0; timed against the plain version and a
   PyTorch library call (``F.scaled_dot_product_attention``,
   ``F.rms_norm``), a yardstick the port never calls.  Each
   flash-attention row also prints TFLOP/s, ``library_ratio`` (ms over
   the library call's ms) and, for decode, ``n_split``: the key splits
   of its grid (``ops.decode_splits``).  Each RMSNorm row names its
   ``row_norm.norm_plan``; at the decode rows the kernel and
   ``F.rms_norm`` are also called 1000 times back to back with no flush:
   the wrapper's host µs a call, the device µs a call between two events
   and ``torch.profiler``'s device µs a launch.
10. **Path 4 ("serve", recurrent).**  RWKV-6 3B at full width and all
    32 layers (d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536,
    LayerNorm; random bf16 weights from a seeded ``torch.Generator``,
    upcast for the f32 run), f32 then bf16, served by the same engine
    with the same six requests, unchunked, inside ``plain_versions()``
    and chunked at 512 (the chunked run continues each prompt from the
    cache's state: the WKV kernel's ``s0``).  Every time mix runs the
    CUDA C++ WKV kernel and every LayerNorm the CUDA C++ one.  Checks:
    prefill compiles == distinct (B, S) buckets, decode compiles == 1;
    WKV launches == 32 and LayerNorm launches == 65 per prefill launch
    and decode step, the plain run none; chunked vs unchunked under path
    3's rules in both dtypes, kernels vs plain under them in f32.  In
    bf16 two equally exact evaluations of this random 32-layer model
    part by far more than 2e-2 (PERF.md), so kernels vs plain
    there is an accuracy check: each request's first-token logits, from
    both runs, against the f32 run over the same weights; the kernels'
    may lie at most 1.25 times as far.  Prints time to first token and
    decode ms per step.
11. **Recurrent kernels.**  WKV at B = 1, T = 2048 from a zero state; on
    a 512-step chunk from a non-zero state beside a row of ``lens = 0``
    (whose state must come back bit for bit and whose y must be 0); a
    ragged T = 1999; T = 2048 with harsh decays (scale 3: about a tenth
    at the model's floor e^{-e^4}); and the decode step at B = 4, T = 1.
    Each WKV row names the plan ``rwkv6.wkv_plan`` gave it (instance,
    chunk length, grid).  LayerNorm on 2048 x 2560 and on a decode
    step's 4 x 2560, with its plan and, at the decode rows, launches back
    to back as RMSNorm's in phase 9.  Each against its plain version
    on the same card inputs, timed against the plain version and, for
    LayerNorm, ``F.layer_norm`` (WKV has no PyTorch call).
12. **Path 5 ("serve", hybrid).**  Zamba2-7B at full width (d_model
    3584, 112 Mamba-2 heads of N = P = 64, one shared attention block of
    32 heads of hd 112 every 6 layers, d_ff 14336, vocab 32000, RMSNorm;
    random bf16 weights from a seeded ``torch.Generator``, the LoRA
    ``b_q`` drawn too) served by the same engine with the same six
    requests.  Every Mamba-2 block runs the CUDA C++ SSD kernel, every
    shared block the flash-attention kernel and every norm the RMSNorm
    kernel.  First bf16 at all 81 layers (the config's dtype and depth;
    13 shared-block invocations), unchunked and chunked at 512: SSD,
    flash-attention and RMSNorm launches == 81 / 13 / 176 per prefill
    launch and decode step, compiles == bucket pairs, every request
    finite, and the served-path cache check (``mamba.h`` of layers 0-1,
    on the first prefill launch, the first decode step and the chunked
    run's first launch continuing a prompt; in f32 ``attn.k/v`` of
    invocation 0 too).  The shared block's invocation 0 is replayed
    alone on the residual stream and cache rows those launches gave it,
    kernels vs plain versions: its residual delta and the K/V it writes
    within the kernel tolerance.  Then 15 layers (groups [6, 9]: the
    remainder rule) in f32 and bf16 (bf16 weights upcast for f32), as
    path 4: kernels, plain versions and chunked; f32 streams identical
    to the plain versions' and chunked to unchunked; the bf16 accuracy
    rule against the f32 run.  In bf16 the chunked and unchunked runs
    part like two evaluations of the random model do
    (``ServePath.bf16_chunked_parts``): their agreement is printed.  At
    81 layers the f32 weights alone would be 51 GB beside the bf16 set.
    Every depth also runs unchunked and chunked under ``eager_entries()``,
    as path 3's eager run: the shared-block replay reads its inputs from
    those runs (a Python hook sees no graph replay), the graphed runs'
    streams are held identical to them, and at 81 layers one decode step
    of each unchunked run is profiled as on path 3.
13. **Hybrid kernels.**  The SSD scan at H = 112, N = P = 64, f32 and
    bf16 inputs: prefill B = 1, T = 2048 from a zero state; a 512-step
    chunk from a state at B = 2 beside a row of ``lens = 0`` (its state
    back bit for bit, its y 0); a ragged T = 1999; decode B = 4, T = 1.
    y and the final state (f32 in both dtypes) within 1e-5 of the plain
    chunked version.  Each row names the instance ``mamba2.ssd_plan``
    gave it (decode, or chunked with its head group and blocks); its
    bound divides the recurrence's flops by the peak of the unit the
    instance runs them on (TF32 tensor cores for chunked, f32 FFMA for
    decode), with the FFMA-based bound printed beside it.  Before the
    path phases, each SSD instance's registers, stack and local memory
    and its HMMA / FFMA counts are printed from ``cuobjdump``: none may
    use local memory, and the chunked phases' must show HMMA (TF32
    ``mma.sync``).  Flash attention at hd 112 as phase 9 (prefill
    S = 2048; a 512-row chunk at q_offset 1024; decode B = 4 at group
    1), timed against ``F.scaled_dot_product_attention``, and RMSNorm
    at width 3584 as phase 9.
14. **Path 6 ("serve", MoE).**  DBRX at full width (d_model 6144, 48 / 8
    heads of hd 128, 16 experts of width 10752 with the top 4 taken,
    vocab 100352, RMSNorm; random bf16 weights from a seeded
    ``torch.Generator``, upcast in place for f32) served by the same
    engine with the same six requests.  Every attention runs the flash
    attention kernel at hd 128, every norm the RMSNorm kernel and every
    router the CUDA C++ masked softmax (``n_valid = E``); the expert GEMMs
    are batched ``torch.bmm``.  First bf16 at 8 layers (54.6 GB of
    weights) at capacity factor 4.0 = E / top_k, where no token drops,
    unchunked and chunked at 512; then 4 layers in f32 and bf16 at the
    config's 1.25, kernels and plain versions.  Checks as path 5:
    launches per prefill launch and decode step flash attention L,
    RMSNorm 2L + 1, softmax L, none in plain runs; compiles == bucket
    pairs; f32 streams identical to the plain versions'; the bf16
    accuracy rule against the f32 run; the cache check (``k``/``v`` of
    layer 0, and of layer 1 in f32: in bf16 layer 1 reads layer 0's MoE,
    whose router may swap a near-tie between two evaluations).  Prints
    each first launch's smallest router top-k margin and dropped
    (token, expert) pairs per layer, from the plain runs and from runs
    under ``eager_entries()`` beside the graphed ones (unchunked and
    chunked at 8 layers, unchunked at 4), whose streams the graphed runs
    must match; the accuracy rule reads a graphed run's routing there.
    Paths 4-6 run as CUDA graphs as path 3 does, with the same graph
    checks.  After every serve phase (paths
    3-6) its objects are deleted and, with no gc pass, the card's
    allocated memory must be back within 1 GB of its value before the
    phase.
15. **MoE kernels.**  Flash attention at hd 128 as phase 9 (decode at
    group 6) and RMSNorm at width 6144; the masked softmax at the
    router's 2048 x 16 and 4 x 16 f32 (``n_valid = 16``), at 4096 x 2048
    in f32 and bf16 with ``n_valid`` 1500 and 2048, and at ``n_valid =
    0``, against its plain version (max|d|/max|ref| ≤ 1e-6 f32, ≤ 8e-3
    bf16; padded columns exactly 0), timed against the plain version and
    ``torch.softmax`` over the valid columns.  Each row names its
    ``softmax.softmax_plan``; at 4 x 16 the kernel and ``torch.softmax``
    are also timed 1000 launches back to back with no flush (µs a
    launch), and the wrapper's host µs a call and ``torch.profiler``'s
    device µs a call are printed.  Its
    instances' registers and local memory are printed from
    ``cuobjdump`` (no local memory).
16. **Path 8 (encoder-decoder).**  whisper-tiny at all 4 + 4 layers
    and full width (d_model 384, 6 heads of hd 64, d_ff 1536, vocab
    51865, GELU, LayerNorm; random bf16 weights from a seeded
    ``torch.Generator``, upcast for the f32 run, which goes first), as
    the reference's single-artifact call: ``encode`` over random frames
    (B, 1500, 384) and ``model.greedy_decode`` (``max_new`` 64, EOS -1,
    a 448-row cache), each compiled with ``disc_torch.compile(...,
    pipeline="jit")`` over batches 3, 4 and 2 (buckets 4, 4, 2 of
    granule 2): one CUDA graph per batch bucket, the whole 64-step
    decode in one graph (``models/common.py`` ``greedy_decode`` gates
    every step by a device flag and reads nothing on the host).  Checks:
    captures == compiles == 2 each, the rest replays; launches per
    encode call flash attention 4 and LayerNorm 9, per decode step 8 and
    13; every call's encoder output, tokens, ``n`` and cache bit-equal
    to the same call under ``eager_entries()``; f32 tokens and ``n``
    equal to the plain versions' and the first step's logits within
    1e-3; bf16 the accuracy rule against the f32 run; then an exact
    batch of 2 whose EOS is the first token of row 0's stream that row 1
    emits too: the loop exits early (``n`` < 64, equal to a host loop's
    step count, the same tokens) and its graph replay equals
    ``eager_entries()`` bit for bit, cache included.  Prints encode ms,
    decode ms a step graphed and under ``eager_entries()``, and one
    traced graphed call's wall and device-busy ms, whose flash-attention
    and LayerNorm kernels must equal the count.  Then flash attention at
    whisper's shapes (the encoder's non-causal 1500 x 1500 at B = 4, a
    448-row cross-attention over 1500 frames, a decode step's cross
    attention over 1500 keys with ``lens=None``), with a zero-padded
    batch row that must give 0, and LayerNorm at 384, against their
    plain versions, timed as in phase 9.
17. **Path 9 ("serve", MQA).**  granite-20b at full width (d_model 6144,
    48 heads over one KV head of hd 128, d_ff 24576 GELU, LayerNorm,
    vocab 49152) served by the same engine: bf16 at all 52 layers (40.6
    GB), unchunked and chunked, each graphed and under
    ``eager_entries()``, then 4 layers in f32 and bf16 against the plain
    versions, with path 6's checks (flash attention L, LayerNorm 2L + 1
    a step; the cache check on layers 0-1).  Flash attention's decode at
    a group of 48 and LayerNorm at 6144, as phase 9.
18. **Path 10 ("serve", dense).**  minitron-4b (d_model 3072, 24 / 8
    heads, RMSNorm, vocab 256000) and codeqwen1.5-7b (d_model 4096, 32 /
    32 heads, vocab 92416), each at its 32 layers in bf16, unchunked,
    graphed and under ``eager_entries()``, then at 2 layers in f32,
    whose streams must equal the plain versions' (flash attention L,
    RMSNorm 2L + 1 a step).  Decode at groups 3 and 1 and RMSNorm at
    3072 and 4096, as phase 9.
19. **Path 11 (vision-language).**  llava-next-34b's language model at
    full width (d_model 7168, 56 / 8 heads of hd 128, d_ff 20480,
    RMSNorm, vocab 64000) as ``model.forward(params, {"tokens",
    "image_embeds"})`` on the jit pipeline: random image-token
    embeddings of 576, 1152 and 2880 rows (anyres 1, 2 and 5 tiles; that
    dim exact) before texts of 37 and 731 tokens (bucketed: the padding
    comes last, hidden by the causal mask), B = 1, then two calls in
    captured buckets.  16 layers in bf16 (19.7 GB), then 4 in f32 and
    bf16 against the plain versions: captures == compiles == the
    distinct (image count, text bucket) pairs, the rest replays; flash
    attention L and RMSNorm 2L + 1 a call; each call bit-equal to
    ``eager_entries()``; f32 valid logits within 1e-3 of the plain
    versions', bf16 the text logits under the accuracy rule.  Decode at
    a group of 7 and RMSNorm at 7168, as phase 9.  After each of paths
    8-11 the card's allocated memory must be back within 1 GB.
20. **Path 12 ("serve", MLA).**  DeepSeek-V2 at full width (d_model
    5120, 128 heads of hd 128 with a 64-wide rope part, a 512-wide
    latent KV cache, 160 experts of 1536 top-6 and 2 shared, RMSNorm,
    vocab 102400) served by the same engine at the config's capacity
    1.25: 6 of its 60 layers in bf16 (~51 GB), unchunked and chunked,
    each graphed and under ``eager_entries()``, then 2 layers in f32 and
    bf16 against the plain versions, with path 6's checks (flash
    attention L, RMSNorm 2L + 1, masked softmax L a step; of flash
    attention's launches, its (192, 128) instance L a prefill launch and
    its absorbed MLA decode form L a decode step, counted apart; the
    cache check on ``kv_c`` / ``k_pe`` layers 0-1, layer 1 printed in
    bf16).  Then flash attention's two MLA forms against their plain
    versions on the same card inputs (max|Δ|/max|ref| ≤ 1e-5 f32, 8e-3
    bf16), timed beside ``F.scaled_dot_product_attention`` at MLA's
    scale: the (192, 128) causal prefill at S = 2048 (B = 1, 128 heads)
    and a 512-row chunk at ``q_offset`` 1024, bound by 2 · 320 flops a
    visible pair and head over the dtype's peak; the absorbed decode at
    B = 4 at the path's fills over a 2048-row latent (the library call
    over the concatenated latent as one kv head), bound by the latent's
    bytes or 2 H (576 + 512) flops a valid key over the f32 FFMA peak.
    RMSNorm at 5120 and the router's softmax at 2048 x 160 and 4 x 160,
    as phase 9.  The 2-layer bf16 engine runs once more on a paged pool
    of 16-token blocks (``kv_block_size=16``, the latent's two leaves
    gathered and scattered around the same graphs): streams identical to
    its fixed-row run, the absorbed decode L a step.
21. **Path 13 (obs / ft).**  The observability and fault-tolerance
    planes on TinyLlama-1.1B at full width in f32 (22 layers, random
    weights from a seeded generator).  (a) Path 1's stack through
    ``disc_torch.compile(..., backend="hopper")``, every output held
    bit-equal to an untraced, fault-free artifact's: traced, the miss's
    ``dispatch`` span parents one ``compile.bucket`` and, inside it, one
    ``kernel.cluster`` span a cluster of the first call (the kLoop /
    kInput runs it made, the plan's count), the hit's (a replay) none; a
    transient ``compile.bucket`` fault is retried; a permanent
    ``kernel.cluster`` fault raises a permanent ``CompileError`` after
    one site check with no cluster run and no entry kept, and the next
    call compiles and runs the kernels.  Traced replays at S = 37 read
    nothing back from the card (no ``synchronize``, ``item`` or
    ``tolist``).  (b) Path 3's engine at 2 replicas of 2 slots with
    heartbeats (``heartbeat_deadline_s``), EOS off, the six prompts of
    16 new tokens: untraced (its streams the reference and its launches
    the path's main-path count), traced (every request's async pair, a
    ``serve.prefill`` / ``serve.decode`` span a launch, streams and
    launches identical, the Chrome export written under ``build/`` and
    read back), transient ``serve.launch`` faults (retries 3, streams
    identical), a permanent decode fault (exactly that launch's group
    fails, the rest identical), and replica 1's beats dropped at the
    ``ft.heartbeat`` site past a fake clock's deadline (drained once, its
    requests resumed on replica 0, every stream identical, and
    ``report()["health"]`` with the JAX package's keys).  Card memory
    back within 1 GB after the phase's ``del``.  (c) Printed, not held:
    host µs a ``dispatch`` span at S = 37 and an untraced call, decode
    ms/step with no hook, a tracer and an injector that never fires (in
    turns), and the phase's seconds.
22. **Path 14 (paged KV, speculative decoding).**  Path 3's engine
    (TinyLlama-1.1B at full width, its bf16-valued weights, the six
    prompts, 16 new tokens, EOS off), f32 then bf16, every entry a CUDA
    graph: (a) on a paged pool of 16-token blocks, unconstrained, against
    fixed rows: streams identical, first-token and first-decode-step
    logits within 1e-6, no preemption, no block in use after, the
    allocator consistent; (b) on a pool of 156 blocks (the first four
    prompts' admission footprint; at 160 their decode growth fits
    exactly): preemptions, every request done with its 17 tokens, each
    preempted request's emitted prefix kept, no block in use after, the
    streams equal to (a)'s printed; (c) ``speculative="ngram"`` (k = 4)
    on fixed rows and on the pool: f32 streams identical to (a)'s fixed
    run, bf16 parting only at a top-2 margin below 2e-2, accepted <=
    drafted, verify launches <= decode steps; (d) two proposer objects
    passed through ``ServeConfig(speculative=...)``: an oracle drafting
    the fixed run's own next tokens (every draft accepted, on the pool)
    and an adversary drafting each of them + 1 (none accepted, on fixed
    rows), streams as (c); (e) in every run flash attention 22 and
    RMSNorm 45 a prefill launch, decode step or verify launch, captures
    == compiles, every later launch a replay, a decode or verify step
    copying at most 1 KiB plus the block table (2 KiB) into its graph,
    and one paged decode step and one verify launch traced under
    ``torch.profiler`` at those counts; (f) flash attention at the verify
    shape (B = 4 rows of 5 queries at the rows' fills, causal over the
    2048-row cache) against its plain version, timed beside
    ``F.scaled_dot_product_attention`` (a printed ``[kernels]`` row; in
    the kernels line flash attention keeps the S = 2048 prefill row of
    the earlier paths); (g) the card's allocated memory
    back within 1 GB after each engine's ``del``.  Prints decode ms a
    step paged and fixed, ms a verify launch, accept rates and tokens a
    launch, the gathered bytes a paged step and the graph pools' bytes.
23. **Path 15 (training on one card).**  (a) TinyLlama-1.1B at full
    width and all 22 layers, its config's bf16 params with f32 AdamW
    state, trained 5 steps of B = 4 (halved while the card runs out of
    memory) x 2048 tokens of ``SyntheticLMStream`` by
    ``launch/train.py``'s ``run`` (``TrainConfig(peak_lr 1e-3, warmup
    2)``): every loss and grad norm finite, every parameter leaf changed
    and finite, exactly 22 flash-attention and 45 RMSNorm launches a step
    (the backward is the plain versions' gradient, ``kernels/grad.py``,
    and launches none); ms a step (median of steps 2-5), tokens/s and
    ``torch.cuda.max_memory_allocated`` printed.  (b) One step's loss and
    gradients at 2 layers, full width, f32, B = 2, with the kernels and
    inside ``plain_versions()``: loss within 1e-5 relative, each grad
    leaf max|d|/max|ref| <= 1e-3.  (c) The same at 22 layers in bf16, B
    = 1, against the step in f32 over the upcast weights, at 4 seeds:
    the kernels' gradient (all leaves, relative L2) and token losses at
    most 1.25 x as far from it as the plain versions' (the accuracy
    rule), their mean loss within 3 standard errors of the tokens' mean
    of the f32 one (both paths' signed distances printed).  (d) 20 f32
    steps at 2 layers: the mean of the last 5 losses below the first.
    (e) A bf16 state saved at step 3 by the writer thread under
    ``build/`` and restored into a fresh state: every leaf equal bit for
    bit, the next step's loss within 1e-6 of the saved state's; the save
    and restore seconds.  (f) One step with ``microbatches=2`` and one
    with ``grad_compression="bf16"``: losses finite, the microbatched one
    beside the unbatched.  (g) Each of the six model-layer wrappers on
    card inputs that require grad (TinyLlama's widths; the router 2048 x
    16; WKV and SSD at T = 512): the helper's ``grad_fn``, values equal
    to the kernel's without grad, gradients equal to the plain
    version's, bit for bit, one launch forward and none backward.  (h)
    One more step of (a) under ``torch.profiler``: wall ms and the card's
    busy ms split into the forward kernels, the plain backward
    recompute, cuBLAS, the AdamW passes and the rest.
24. **Path 16 (multi-GPU code on a one-rank mesh).**  Starts a one-rank
    NCCL process group (``make_mesh``), runs (a)–(d) and destroys the
    group, so no later phase sees one.  (a) ``disc_torch.compile`` of
    path 2's token-major stack on the ``"dhlo"`` pipeline, its weights
    taken as arguments with static specs (all 201 of them), on a
    ``("data", "model")`` mesh of shape (1, 1): at 22 layers under
    ``dp``, and at 2 layers under ``fsdp``, ``tp`` and a profile that
    shards ``"T"`` on ``"data"``, in f32 and bf16, at T = 37 and 1999;
    each held against the same stack compiled without a mesh (``dp`` bit
    for bit, the others within 1e-6 / 8e-3 of max|ref|), its captures
    equal to its compiles and its kDot / kLoop / kInput launches equal
    to the run without a mesh; ``report()["sharding"]`` printed, the
    collectives counted by kind and bytes.  (b) Path 3's engine (4 of its
    prompts, ``max_batch=4``) without a mesh, on ``("data",)`` (1,) under
    ``dp`` and on ``("data", "model")`` (1, 1) under ``tp``, in f32 and
    bf16: the streams identical, flash attention 22 and RMSNorm 45
    launches a launch, captures equal to compiles, the card's memory back
    within 1 GB after each engine is deleted; decode ms a step printed
    with and without the mesh.  (c) DBRX at full width, 2 layers, bf16,
    served under ``tp`` on (1, 1), so ``moe_apply`` takes its
    expert-parallel branch: the kernels' streams held against the same
    engine's plain versions under the same mesh (path 6's stream rule),
    the dropped (token, expert) pairs of the first prefill launch
    printed beside the run without a mesh.  (d) Flash attention and kDot
    at the local shapes each rank of a 2- and 4-way ``tp`` layout
    launches (TinyLlama prefill S = 2048 and decode B = 4 at 16 / 8
    query heads and 2 / 1 KV heads; silu·h at N = 2816 / 1408, K = 2048,
    and +res at N = 1024 / 512, K = 5632, T = 1999), each against its
    plain version (1e-5 / 8e-3; kDot by path 2's rule), timed beside the
    plain version and a PyTorch call.
25. Prints the run's seconds in all, the kernels line (each kernel, and
    flash attention's MLA forms as ``flash_attention_mla`` and
    ``flash_attention_mla_decode``), the card line, and the result line
    last.

Run it from a checkout: it builds the kernels from ``src/`` into
``build/torch_kernels/`` and refuses to run without the repository or
without a CUDA device.  ``--layers`` cuts the depth of paths 1, 2 and 7;
paths 3 and 4 always run all their layers (22 and 32), path 5 all 81 in
bf16 and 15 in both dtypes, path 6 8 in bf16 and 4 in both dtypes, path
8 all 4 + 4, path 9 all 52 in bf16 and 4 in both, path 10 all 32 in
bf16 and 2 in f32, path 11 16 in bf16 and 4 in both, path 12 6 of 60 in
bf16 (~8.1 GB of weights a layer; the 60 would need ~483 GB) and 2 in
both, paths 13 and 14 all 22 in f32 (path 14 in bf16 too), path 15
all 22 in bf16 and 2 in its f32 comparisons, and path 16 all 22 under
``dp`` and 2 under its other profiles, 22 in its engines and 2 of
DBRX's 40.  A card run covers a one-rank mesh only: parity over 2 and 4
ranks is held on the CPU (``tests/test_torch_dist.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Callable, NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (700 W): HBM bytes/s, f32 non-tensor flop/s,
# dense bf16 and TF32 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

REQUESTS = (37, 200, 731, 1500, 1999, 45)
# paths 1-2, f32 vs eager (summation order); bf16 takes the accuracy
# rule alone (ACCURACY_RATIO below)
TOL_PATH_F32 = 1e-3
# bf16 runs are held against the same function evaluated in f32 over
# the same bf16-valued weights: eager's bf16 output itself lies up to
# 1.8e-2 from it on an H100 (PERF.md), and the compiled path may lie at
# most this factor further from it than eager does
ACCURACY_RATIO = 1.25
# MoE: a near-tie of the router swaps a few tokens' experts between two
# bf16 evaluations; more than this share of a launch's valid tokens (and
# more than the floor) routed apart in one layer is a fault
ROUTE_PART_FRACTION, ROUTE_PART_FLOOR = 0.1, 8
# kInput vs its plain version, per row, relative to the row's sum of
# magnitudes: f32 sums differ by summation order only; a bf16 result by
# at most one rounding step (2^-7) of the stored value.  kLoop computes
# each op exactly as eager does and must match bit for bit.
TOL_REDUCE_ROW = {"f32": 1e-5, "bf16": 8e-3}
# GEMM kernels vs their plain versions, max|Δ|/max|ref|: f32 differs by
# the summation order over K ≤ 5632; bf16 by about two bf16 roundings
# (2^-8 each) through the accumulator cast and the epilogue
TOL_GEMM = {"f32": 1e-5, "bf16": 8e-3}

KERNELS = {
    "fused_elementwise": {
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_elementwise/fused_elementwise.py",
        "replaces": "src/repro/kernels/fused_elementwise/fused_elementwise.py:51",
    },
    "fused_reduce": {
        "route": "triton",
        "source": "src/repro_torch/kernels/fused_reduce/fused_reduce.py",
        "replaces": "src/repro/kernels/fused_reduce/fused_reduce.py:48",
    },
    "matmul_epilogue": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cuh",
        "replaces": "src/repro/kernels/matmul/matmul.py:116",
    },
    "matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cuh",
        "replaces": "src/repro/kernels/matmul/matmul.py:54",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:94",
    },
    "rmsnorm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:26",
    },
    "layernorm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/layernorm/csrc/layernorm.cu",
        "replaces": "src/repro/kernels/layernorm/layernorm.py:24",
    },
    "rwkv6": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6.py:60",
    },
    "mamba2": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2/csrc/mamba2.cu",
        "replaces": "src/repro/kernels/mamba2/mamba2.py:68",
    },
    "masked_softmax": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/softmax/csrc/softmax.cu",
        "replaces": "src/repro/kernels/softmax/softmax.py:37",
    },
}

class ServePath(NamedTuple):
    """A serve path's config and its per-path rules."""
    arch: str
    # the wrappers it launches and how many launches each makes per
    # prefill launch and decode step (L layers)
    per_step: Callable[[int], dict]
    # weights bf16-valued in both dtypes (then the f32 run evaluates the
    # bf16 run's function in f32: its accuracy reference)
    bf16_weights: bool
    # per dtype, cache leaves the served-path cache check holds other
    # than CACHE_CHECK_LAYERS layers at TOL_SERVE_KERNEL: leaf ->
    # (layers held, limit)
    held: dict = {}
    # the bf16 chunked and unchunked runs part beyond the stream rules:
    # their agreement and the chunked run's first-token accuracy are
    # printed, not held
    bf16_chunked_parts: bool = False
    # replay the shared attention block's invocation 0 (zamba) on its
    # recorded inputs, kernels vs plain versions
    shared_block: bool = False
    # record the MoE routing of every launch (dbrx): each first launch's
    # smallest router top-k margin and dropped (token, expert) pairs are
    # printed, and the bf16 accuracy rule reads where two runs part
    router: bool = False
    # beside the bf16 accuracy rule, the bf16 kernels and plain runs'
    # streams are held to the stream rule (a stream parts only at a
    # near-tie) with their logits distance printed, not held: two equally
    # exact evaluations of few enough layers stay on one stream
    bf16_streams: bool = False
    # (L, prefill launches, decode steps) -> launches of flash attention's
    # MLA forms (MLA_FORM_OF) in a run; every other path launches none
    forms: Callable[[int, int, int], dict] = lambda n, pre, dec: {}


SERVE_PATHS = {
    "path3": ServePath("tinyllama_11b",
                       lambda n: {"flash_attention": n, "rmsnorm": 2 * n + 1},
                       True, bf16_streams=True),
    "path4": ServePath("rwkv6_3b",
                       lambda n: {"rwkv6": n, "layernorm": 2 * n + 1},
                       True),
    # Zamba2: an SSD launch per Mamba layer; one shared-block invocation
    # (attention, its norm) per group of 6, n_inv = max(L // 6, 1); two
    # norms per layer and ln_f.
    # Its shared-block K/V are projections of the residual stream after 6
    # Mamba layers and their MLPs (no attention kernel computes them), so
    # invocation 0 reads depth as the 6th Mamba state does (PERF.md, PR
    # 15): in f32 it is held at the summation-order gap of those layers
    # (read up to 3.0e-5), in bf16 printed; the block itself is held by
    # the shared-block replay.  Its bf16 chunked and unchunked runs are
    # two equally exact evaluations (other GEMM shapes, so other
    # roundings) amplified by depth: 5.8e-2 of max|logit| at the first
    # token at 15 layers, their distances from the f32 run differing by
    # up to 28 % either way (PERF.md, PR 15); the chunked run is held by
    # its continuing launch's cache check in both dtypes and by the exact
    # stream rule in f32
    "path5": ServePath(
        "zamba2_7b",
        lambda n: {"mamba2": n, "flash_attention": max(n // 6, 1),
                   "rmsnorm": 2 * n + max(n // 6, 1) + 1},
        True,
        held={"f32": {"attn.k": (1, 1e-4), "attn.v": (1, 1e-4)},
              "bf16": {"attn.k": (0, None), "attn.v": (0, None)}},
        bf16_chunked_parts=True, shared_block=True),
    # DBRX: per layer one attention, two norms and the router's softmax;
    # ln_f.  In bf16 a layer's MoE output moves by O(1) for a token whose
    # k-th and (k+1)-th router probabilities swap, and two equally exact
    # bf16 evaluations (a kernel and its plain version, or another GEMM
    # shape when chunked) can swap a near-tie: layer 1's K/V, which read
    # layer 0's MoE, are printed there and layer 0's held; the smallest
    # top-k margin is printed with every run
    "path6": ServePath(
        "dbrx_132b",
        lambda n: {"flash_attention": n, "rmsnorm": 2 * n + 1,
                   "masked_softmax": n},
        True,
        held={"bf16": {"k": (1, 8e-3), "v": (1, 8e-3)}},
        bf16_chunked_parts=True, router=True),
    # granite-20b: MQA (one KV head for 48 query heads: a group of 48 in
    # the decode form), a GELU MLP and LayerNorm; per layer one attention
    # and two norms, then ln_f.  At its 52 layers in bf16 the chunked and
    # unchunked runs are two equally exact evaluations of a deep random
    # model, as path 5's are
    "path9": ServePath(
        "granite_20b",
        lambda n: {"flash_attention": n, "layernorm": 2 * n + 1}, True,
        bf16_chunked_parts=True),
    # minitron-4b (24 / 8 heads, RMSNorm at 3072) and codeqwen1.5-7b
    # (32 / 32 heads, RMSNorm at 4096): dense, as path 3
    "path10 minitron": ServePath(
        "minitron_4b",
        lambda n: {"flash_attention": n, "rmsnorm": 2 * n + 1}, True),
    "path10 codeqwen": ServePath(
        "codeqwen15_7b",
        lambda n: {"flash_attention": n, "rmsnorm": 2 * n + 1}, True),
}
# DeepSeek-V2: per layer one MLA attention (a prefill launch takes flash
# attention's (192, 128) instance, a decode step its absorbed MLA decode
# form), two norms and the router's softmax over 160 experts; ln_f.  As
# DBRX's, its bf16 chunked and unchunked runs may route a near-tie apart
# (and at the config's capacity 1.25 they drop other tokens: a launch's
# capacity counts its own tokens); layer 1's latent, which reads layer
# 0's MoE, is printed in bf16 and layer 0's held
SERVE_PATHS["path12"] = ServePath(
    "deepseek_v2_236b",
    lambda n: {"flash_attention": n, "rmsnorm": 2 * n + 1,
               "masked_softmax": n},
    True,
    held={"bf16": {"kv_c": (1, 8e-3), "k_pe": (1, 8e-3)}},
    bf16_chunked_parts=True, router=True,
    forms=lambda n, pre, dec: {"flash_attention_mla": n * pre,
                               "flash_attention_mla_decode": n * dec})
#: flash attention's MLA forms in the kernels line (route, source and
#: TPU kernel flash attention's), each by the counter of
#: ``ops.FORM_LAUNCHES`` that counts it
MLA_FORM_OF = {"flash_attention_mla": "mla",
               "flash_attention_mla_decode": "mla_decode"}
# path 12's depths (full width; ~8.1 GB of bf16 weights per layer: the
# 160 experts 7.55 GB, MLA 0.46 GB, the shared experts 0.09 GB; 2.1 GB in
# the embedding and the head): 6 of its 60 layers in bf16 (~51 GB), then 2
# in f32 and bf16 (~37 / 18 GB, one dtype's set at a time); the 60 layers
# would need ~483 GB.  Both at the config's capacity factor 1.25 (a
# drop-free one would need (160, T, 5120) expert buffers, ~13 GB at T =
# 8192)
PATH12_LAYERS, PATH12_CUT_LAYERS = 6, 2
# path 5's depth in f32 (and its bf16 twin): at 81 layers the f32 weights
# alone are 51 GB beside the bf16 set; 15 layers keep the remainder rule
PATH5_CUT_LAYERS = 15
# path 6's depths (full width; 6.52 GB of bf16 weights per layer, 2.47 GB
# in the embedding and the head): 8 layers in bf16 (54.6 GB), 4 in f32
# and bf16 (57.0 / 28.5 GB); the 40 layers would need 263 GB.  Capacity
# factor of the 8-layer runs: E / top_k = 4.0 makes the capacity equal
# the valid tokens, so no token drops and chunked and unchunked runs
# route alike; the 4-layer runs keep the config's 1.25, where tokens drop
PATH6_LAYERS, PATH6_CUT_LAYERS, PATH6_DROP_FREE_CF = 8, 4, 4.0
# path 9's depths: granite-20b at its 52 layers in bf16 (40.6 GB of
# weights), then 4 layers in f32 and bf16 against the plain versions;
# path 10's: each config at its 32 layers in bf16, then 2 layers in f32
PATH9_CUT_LAYERS, PATH10_CUT_LAYERS = 4, 2
# path 8: whisper-tiny's batches (buckets 4, 4 and 2 of granule 2), new
# tokens a greedy decode and the decoder's cache extent (its 448-token
# context)
WHISPER_BATCHES = (3, 4, 2)
WHISPER_MAX_NEW = 64
WHISPER_CACHE = 448
# path 11: llava-next-34b at 16 of its 60 layers in bf16 (19.7 GB of
# weights; all 60 would need ~69 GB beside the other phases), then 4 in
# f32 and bf16; image tokens of anyres 1, 2 and 5 tiles, text lengths, and
# two calls more in buckets already captured (replays)
LLAVA_LAYERS, LLAVA_CUT_LAYERS = 16, 4
LLAVA_IMAGES = (576, 1152, 2880)
LLAVA_TEXTS = (37, 731)
LLAVA_REPLAYS = ((576, 45), (2880, 731))
# card memory a phase may leave allocated after its objects are deleted,
# before any gc pass (an engine's entries hold it only weakly)
MEM_SLACK_BYTES = 1 << 30
# a graphed run against its eager twin (the same kernels launched one by
# one): f32 first-token logits, max|d|/max|ref|; the bytes a decode step
# may copy into its graph (tokens, lens and active; the cache stays put)
TOL_GRAPHS = 1e-6
DECODE_COPY_BYTES = 1024
# the paths whose kernels and eager runs each put one decode step under
# torch.profiler
PROFILED_PATHS = ("path3", "path5")
#: the device kernel of each counted wrapper on the profiled paths (and
#: on paths 1 and 2's timed requests), as torch.profiler names it: one
#: for each counted launch (flash decode's combine pass and split-K's
#: second pass, ``gemm_finish_kernel``, left out)
TRACE_KERNELS = {
    "flash_attention": r"\b(prefill_kernel|prefill_tc_kernel|decode_kernel)\b",
    "rmsnorm": r"\bnorm_(rows|loop)\b",
    "layernorm": r"\bnorm_(rows|loop)\b",
    "mamba2": r"\bssd_(chunked|decode)\b",
    "kloop": r"^kloop(_\w+)?$",
    "kinput": r"^kinput(_\w+)?$",
    "gemm": r"\bdisc::gemm_(wgmma_)?kernel\b",
}
# host seconds between a profiled step's launches and either edge of the
# profiler's recorded window: the window's device side at times opens
# late, and a trace whose step launched at once after ``prof.step()``
# then lacked the step's first kernels (a graph's replay whole), graphed
# and eager alike; with 5 ms none was lost, and this is four times that
PROFILE_MARGIN_S = 0.02
# paths 1 and 2 (path 7 is path 1's model): one request at S = 37 and
# 1999 timed graphed and eager, synchronised calls a request and mode
# (median), then once under torch.profiler
TIMED_PATHS = ("path1", "path2")
PROFILE_ROUNDS = 3
# a graphed run's eager twin
EAGER_TWIN = {"kernels": "eager", "chunked": "eager chunked"}

# path 3 (serve): prompt lengths, new tokens per request, engine shape
SERVE_PROMPTS = (37, 200, 731, 1500, 1999, 45)
SERVE_NEW_TOKENS = 16
SERVE_BATCH, SERVE_SEQ, SERVE_CHUNK = 4, 2048, 512
# per-token logits, max|d|/max|ref|: kernels vs plain versions (and
# chunked vs unchunked).  f32 differs by summation order only; in bf16
# two equally exact evaluations round differently and 22 layers amplify
# it (PERF.md: up to 1.9e-2 between compiled and eager on paths 1-2)
TOL_SERVE = {"f32": 1e-3, "bf16": 2e-2}
# flash attention / RMSNorm / LayerNorm / WKV output vs plain version at
# the path's shapes: f32 by summation order; bf16 by one output rounding
# (2^-8) where the f32 sums differ
TOL_SERVE_KERNEL = {"f32": 1e-5, "bf16": 8e-3}
# the cache after a serve run's first prefill launch and first decode
# step vs the same launch replayed with the plain versions: the first
# layers' leaves are held to TOL_SERVE_KERNEL, before depth amplifies the
# difference (the deeper layers' are printed)
CACHE_CHECK_LAYERS = 2
# the WKV kernel's final state (f32 in both dtypes) vs its plain version:
# fused multiply-adds and the order of the dot over K
TOL_WKV_STATE = 1e-5
# the SSD kernel's y and final state vs its plain (chunked) version, in
# both dtypes: inputs are widened to f32 at load and every product is
# near-f32 (3 x TF32 on tensor cores; an f32 operand's dropped lo x lo
# term and TF32 truncations ~2^-20 of a product), so summation order,
# the split and the cumulative sum's order differ
TOL_SSD = 1e-5
# the masked softmax kernel vs its plain version: both compute in f32
# with CUDA's IEEE expf and a correctly rounded divide, so only the
# order of the row sum differs; a bf16 output by one rounding (2^-8)
# where the f32 results differ
TOL_SOFTMAX = {"f32": 1e-6, "bf16": 8e-3}

# path 13 (obs / ft): the engine's heartbeat deadline (the drain run
# drives a fake clock past it), the decode steps timed a mode in each of
# OBS_ROUNDS rounds for (c), the S = 37 dispatches timed for (c), and the
# keys of report()["health"] and of its counters, as the JAX package
# gives them
OBS_DEADLINE_S = 30.0
OBS_STEPS, OBS_ROUNDS, OBS_DISPATCHES = 8, 3, 50
HEALTH_KEYS = {"alive_replicas", "replicas", "failed", "counters",
               "compile", "kernel_demotions"}
HEALTH_COUNTERS = {"failed_requests", "retries", "kernel_demotions",
                   "deadline_expirations", "replica_drains"}

# path 14 (paged KV and speculative decoding on path 3's engine): the
# block size; the pressure run's pool in blocks, 156 = the admission
# footprint of the first four prompts (3 + 13 + 46 + 94 blocks of 16), so
# their decode growth must preempt (at 160 their peak footprint, 4 + 14 +
# 47 + 95, fits exactly and nothing preempts); the draft tokens a verify
# launch takes; the bytes a paged decode or verify step may copy into its
# graph beside DECODE_COPY_BYTES (the (4, 128) int32 block table)
PATH14_BLOCK = 16
PATH14_POOL_BLOCKS = 156
PATH14_K = 4
TABLE_COPY_BYTES = SERVE_BATCH * (SERVE_SEQ // PATH14_BLOCK) * 4
# paged vs fixed rows, the same graphs over the same rows: first-token and
# first-decode-step logits, max|d|/max|ref|, in both dtypes
TOL_PAGED = 1e-6
# a speculative bf16 stream may part from the plain decode's only where
# the plain run's top-2 margin (over its max|logit|) is below this: path
# 3's stream rule
TOL_SPEC_MARGIN = 2e-2

# path 15 (training): TinyLlama at full width and depth, B (halved while
# the card runs out of memory) x S tokens a step, the launcher's steps;
# the cut depth of its comparisons, the learning run's steps; the
# kernels' f32 step vs the plain versions' (loss relative, each grad
# leaf max|d|/max|ref|: two f32 evaluations of the same math in other
# orders); a restored state's next loss vs the saved state's
PATH15_BATCH = 4
PATH15_SEQ = 2048
PATH15_STEPS = 5
PATH15_CUT_LAYERS = 2
PATH15_LEARN = 20
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
TOL_CKPT_LOSS = 1e-6
# (c)'s seeds (weights and batch: seed, seed + 1, ...), and how many
# standard errors of the 2048 tokens' mean the kernels' bf16 mean loss
# may lie from the f32 one
PATH15_ACC_SEEDS = 4
ACC_MEAN_SE = 3.0

# §4.5 library phase: a shape from TinyLlama's widths per entry, and the
# entry the reference's selection rules give it
LIBRARY_SHAPES = {
    "library:square_big": (2048, 2048, 5632),
    "library:balanced": (1024, 2048, 256),
    "library:skinny_m": (32, 2048, 2048),
    "library:skinny_n": (512, 2048, 32),
    "library:deep_k": (256, 5632, 256),
    "vendor:torch_matmul": (37, 2048, 2048),
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing --

def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms of ``fn`` per call, each call after an L2 flush (the
    path's callers find a cluster's operands mostly out of the 50 MB L2:
    each layer streams ~150 MB of weights).  A spin kernel ahead of the
    start event keeps the card busy while the host enqueues ``fn``, so the
    interval holds device time, not host launch overhead."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def median_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn()`` over ``reps`` synchronised calls."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2]


def device_events(prof) -> list:
    """The kernels' and copies' own entries of ``torch.profiler``'s
    averages: a PyTorch operator's entry repeats the device time of the
    kernels it launched, and a scheduled profiler's step (``ProfilerStep``)
    records on the card the span of all of them (counting either doubles
    the time)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def kernel_device_us(prof) -> float:
    """Device µs ``torch.profiler`` recorded, from :func:`device_events`."""
    return sum(e.self_device_time_total for e in device_events(prof))


def launch_times(fn, reps: int = 1000) -> dict:
    """``fn`` called ``reps`` times back to back, no flush: the device µs
    a call between two events (the card's issue rate for it, or the
    host's, whichever is slower), the host µs a call before the closing
    synchronise, and ``torch.profiler``'s device µs a call (the kernels'
    own time, or None where the profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    dev = kernel_device_us(prof)
    return dict(back_to_back_us=start.elapsed_time(end) * 1e3 / reps,
                host_us=host * 1e6 / reps,
                device_us=dev / 100 if dev else None)


def unique_bytes(t) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast view reads its
    source once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


# -------------------------------------------------------------- model --

def build(cfg, dtype_name: str, seed: int) -> dict:
    """Path 1: the model's own stack over hidden states (1, S, D)."""
    import torch

    import disc_torch
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init(cfg, gen, "cuda")
    dt = torch.float32 if dtype_name == "f32" else torch.bfloat16

    def make_fn(params):
        def fn(x):
            return T.decoder_logits(cfg, params, x)
        return fn

    fn = make_fn(params)
    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((1, disc_torch.Dim("S", max=2048), cfg.d_model), dt)],
        backend="hopper")
    low = f.lower()
    return dict(fn=fn, f=f, low=low, dt=dt, dim="S", params=params,
                make_fn=make_fn,
                lower_s=time.perf_counter() - t0,
                shape=lambda s: (1, s, cfg.d_model),
                out_shape=lambda s: (1, s, cfg.vocab))


def build_token_major(cfg, dtype_name: str, seed: int) -> dict:
    """Path 2: the layer functions over a token-major residual stream,
    x (T, D), so the MLP's projections are plain 2-D dots (kDot)."""
    import torch

    import disc_torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init(cfg, gen, "cuda")
    dt = torch.float32 if dtype_name == "f32" else torch.bfloat16

    def make_fn(params):
        def fn(x):                               # x (T, 2048)
            pos = torch.arange(x.shape[0], dtype=torch.int32,
                               device=x.device)[None, :]
            for bp in params["blocks"]:
                h = L.norm_apply(cfg, bp["ln1"], x)
                a, _ = L.attn_apply(cfg, bp["attn"], h[None], positions=pos)
                x = x + a[0]
                x = x + L.mlp_apply(cfg, bp["ffn"],
                                    L.norm_apply(cfg, bp["ln2"], x))
            return T.logits_from_hidden(cfg, params,
                                        L.norm_apply(cfg, params["ln_f"], x))
        return fn

    fn = make_fn(params)
    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((disc_torch.Dim("T", max=2048), cfg.d_model), dt)],
        backend="hopper")
    low = f.lower()
    return dict(fn=fn, f=f, low=low, dt=dt, dim="T", params=params,
                make_fn=make_fn,
                lower_s=time.perf_counter() - t0,
                shape=lambda s: (s, cfg.d_model),
                out_shape=lambda s: (s, cfg.vocab))


def to_f32(tree):
    """A parameter tree with every tensor upcast to f32 (exactly)."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def upcast_in_place(tree) -> None:
    """Upcast every tensor of nested dicts and lists to f32 in its place,
    one leaf at a time, so that the bf16 and f32 copies of the weights
    never all live together (path 6: 28.5 + 57.0 GB)."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            upcast_in_place(v)
        else:
            tree[k] = v.float()


def start_cuda_builds(arts: list):
    """Build every CUDA library the run launches, one ``nvcc`` each, all
    started together, in a background thread; returns the thread and the
    dict it fills with its seconds (or its error)."""
    import threading

    import torch

    from repro_torch.core.codegen import kdot_jobs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention.flash_attention import \
        source_job
    from repro_torch.kernels.mamba2.mamba2 import source_job as ssd_job
    from repro_torch.kernels.row_norm import source_job as norm_job
    from repro_torch.kernels.rwkv6.rwkv6 import source_job as wkv_job
    from repro_torch.kernels.softmax.softmax import \
        source_job as softmax_job
    from repro_torch.kernels.matmul.matmul import (INCLUDE_DIRS,
                                                   LIBRARY_TILES,
                                                   identity_program,
                                                   kernel_source)

    jobs = []
    for art in arts:
        jobs += [(p, dt, ("kdot",))
                 for p, dt in kdot_jobs(art["low"].graph, art["low"].plan)]
    jobs += [(identity_program(dt), dt, LIBRARY_TILES)
             for dt in (torch.float32, torch.bfloat16)]
    sources = [(*kernel_source(p, dt, tuple(t)), INCLUDE_DIRS)
               for p, dt, t in jobs]
    gemm_jobs = list(sources)
    sources.append(source_job())   # the flash-attention library (path 3)
    sources.append(wkv_job())      # the WKV library (path 4)
    sources.append(ssd_job())      # the SSD library (path 5)
    sources.append(softmax_job())  # the masked softmax library (path 6)
    sources.append(norm_job("rmsnorm"))    # paths 3, 5 and 6
    sources.append(norm_job("layernorm"))  # path 4
    result: dict = {"sources": len(sources), "gemm_jobs": gemm_jobs}

    def run():
        t0 = time.perf_counter()
        try:
            cuda_build.build(sources)
        except Exception as e:  # reported when the thread is joined
            result["error"] = e
        result["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run, name="nvcc-builds")
    th.start()
    return th, result


def host_ints(v):
    """A length a wrapper was given (an int, or lengths on the card that
    the kernel reads) as host ints: the recorder reads them back once,
    outside any graph."""
    import torch

    if isinstance(v, torch.Tensor):
        vals = v.reshape(-1).tolist()
        return vals[0] if len(vals) == 1 else tuple(vals)
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
        else int(v)


class Recorder:
    """Records the first call of each distinct kernel program (uncounted
    run) so the kernel phase can replay it at the path's shapes.  Run the
    function under ``eager_entries()``: a graph's replay calls no
    wrapper."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr
        from repro_torch.kernels.matmul import ops as mm

        self._saved = (fe.fused_elementwise, fr.fused_reduce,
                       mm.matmul_fused)
        orig_fe, orig_fr, orig_mm = self._saved

        def rec_fe(program, inputs, n_valid, shape):
            key = ("fused_elementwise", program.key, tuple(shape))
            if key not in self.calls:
                self.calls[key] = dict(program=program, inputs=list(inputs),
                                       n_valid=n_valid, shape=tuple(shape),
                                       count=0)
            self.calls[key]["count"] += 1
            return orig_fe(program, inputs, n_valid, shape)

        def rec_fr(program, inputs, n_valid_cols, kind="sum", *, axis=-1,
                   shape, out_dtype=None):
            key = ("fused_reduce", program.key, tuple(shape), kind, axis)
            if key not in self.calls:
                self.calls[key] = dict(program=program, inputs=list(inputs),
                                       n_valid=host_ints(n_valid_cols),
                                       kind=kind,
                                       axis=axis, shape=tuple(shape),
                                       out_dtype=out_dtype, count=0)
            self.calls[key]["count"] += 1
            return orig_fr(program, inputs, n_valid_cols, kind, axis=axis,
                           shape=shape, out_dtype=out_dtype)

        def rec_mm(a, b, extras, program, *, valid_mnk, out_dtypes):
            key = ("matmul_epilogue", program.key, tuple(a.shape),
                   tuple(b.shape))
            if key not in self.calls:
                self.calls[key] = dict(program=program, a=a, b=b,
                                       extras=list(extras),
                                       valid=host_ints(valid_mnk),
                                       out_dtypes=tuple(out_dtypes),
                                       count=0)
            self.calls[key]["count"] += 1
            return orig_mm(a, b, extras, program, valid_mnk=valid_mnk,
                           out_dtypes=out_dtypes)

        fe.fused_elementwise, fr.fused_reduce, mm.matmul_fused = \
            rec_fe, rec_fr, rec_mm
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.fused_elementwise import ops as fe
        from repro_torch.kernels.fused_reduce import ops as fr
        from repro_torch.kernels.matmul import ops as mm

        fe.fused_elementwise, fr.fused_reduce, mm.matmul_fused = self._saved
        return False


def path_phase(path: str, art: dict, dtype_name: str, seed: int,
               cfg, report: dict):
    """Serve ``REQUESTS`` through the compiled function of ``art``, hold
    each against eager, check compiles and kernel launches; returns the
    kernel calls recorded from one extra, uncounted run at 1999 tokens."""
    import torch

    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.core.graphs import eager_entries
    from repro_torch.kernels.select import plain_versions

    fn, f, low, dt = art["fn"], art["f"], art["low"], art["dt"]
    tag = f"[{path} {dtype_name}]"
    templates = low.plan.template_counts()
    print(f"{tag} lowered {cfg.n_layers} layers in {art['lower_s']:.2f} s: "
          f"{low.plan.stats()} templates={templates}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    inputs = {s: torch.randn(art["shape"](s), generator=gen,
                             device="cuda").to(dt) for s in REQUESTS}
    buckets = set()
    kern = f.backend.cluster_kernels
    counters = {"fused_elementwise": fe.LAUNCHES,
                "fused_reduce": fr.LAUNCHES,
                "matmul_epilogue": mm.EPILOGUE_LAUNCHES}
    runs0 = {t: k.runs for t, k in kern.items()}
    for c in (*counters.values(), mm.OPERAND_COPIES,
              mm.FFMA_SCALAR_LAUNCHES, *mm.BODY_LAUNCHES.values(),
              fe.UNALIGNED_LAUNCHES, fr.UNALIGNED_LAUNCHES):
        c.reset()
    rows = []
    st = f.graph_stats
    graph_io = []   # per request: bytes copied into its graph, captured
    for s in REQUESTS:
        before = f.compile_counts()["total"]
        b_in, b_out, caps = st.bytes_in, st.bytes_out, st.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = f(inputs[s])
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        after = f.compile_counts()["total"]
        key = f.policy.bucket(art["dim"], s)
        buckets.add(key)
        rows.append((s, key, dt_s, after - before, y))
        graph_io.append((s, key, st.bytes_in - b_in, st.bytes_out - b_out,
                         st.captures - caps))
        if s == 45:
            check(after == before, f"{tag} {s} compiled anew (bucket {key})")
    launches = {name: c.launches for name, c in counters.items()}
    runs = {t: k.runs - runs0[t] for t, k in kern.items()}
    unaligned = {"fused_elementwise": fe.UNALIGNED_LAUNCHES.launches,
                 "fused_reduce": fr.UNALIGNED_LAUNCHES.launches}
    copies = mm.OPERAND_COPIES.launches
    scalar = mm.FFMA_SCALAR_LAUNCHES.launches
    bodies = {b: c.launches for b, c in mm.BODY_LAUNCHES.items()}
    fn32 = None
    if dt != torch.float32:
        # the same function over the same (bf16-valued) weights and
        # inputs, evaluated in f32: how far each bf16 run is from it
        fn32 = art["make_fn"](to_f32(art["params"]))
    for s, key, dt_s, compiled, y in rows:
        # eager is the plain function, op by op: the serve path's
        # attention and RMSNorm kernels stay out of this comparison
        with torch.no_grad(), plain_versions():
            ref = fn(inputs[s])
            ref32 = None if fn32 is None else fn32(inputs[s].float())
        torch.cuda.synchronize()
        check(tuple(y.shape) == art["out_shape"](s),
              f"{tag} shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{tag} {s}: non-finite output")
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rel = err / scale
        vs32 = ""
        if ref32 is not None:
            s32 = ref32.abs().max().item()
            c32 = (y.float() - ref32).abs().max().item() / s32
            e32 = (ref.float() - ref32).abs().max().item() / s32
            vs32 = f" vs_f32: compiled={c32:.3e} eager={e32:.3e}"
        print(f"{tag} {art['dim']}={s:5d} bucket={key:5d} "
              f"compiled={compiled} latency_s={dt_s:.4f} max|d|={err:.4e} "
              f"max|ref|={scale:.4e} rel={rel:.3e}{vs32}", flush=True)
        if ref32 is None:
            check(rel <= TOL_PATH_F32,
                  f"{tag} {s}: rel {rel:.3e} > {TOL_PATH_F32}")
        else:
            check(c32 <= ACCURACY_RATIO * e32,
                  f"{tag} {s}: {c32:.3e} from the f32 evaluation, eager "
                  f"{e32:.3e}")
        del ref, ref32
    counts = f.compile_counts()
    graph_checks(tag, art, inputs, rows, graph_io)
    print(f"{tag} compile_counts={counts} "
          f"distinct_buckets={sorted(buckets)} cache={f.cache_stats()}",
          flush=True)
    print(f"{tag} cluster runs: " + ", ".join(
        f"{t}={n}" for t, n in runs.items()) + f"; launches={launches}; "
        f"kLoop / kInput launches in the unaligned class {unaligned}",
        flush=True)
    check(not any(unaligned.values()),
          f"{tag} cluster launches in the unaligned class: {unaligned}")
    check(counts["total"] == len(buckets),
          f"{tag} {counts['total']} compiles for {len(buckets)} buckets")
    for template, name in (("kLoop", "fused_elementwise"),
                           ("kInput", "fused_reduce"),
                           ("kDot", "matmul_epilogue")):
        if templates.get(template):
            check(runs[template] > 0
                  and launches[name] == runs[template],
                  f"{tag} {template}: runs={runs[template]} "
                  f"launches={launches}")
        else:
            check(launches[name] == 0, f"{tag} {name} launched off-plan")
    if templates.get("kDot"):
        want = templates["kDot"] * len(REQUESTS)
        body = "ffma" if dt == torch.float32 else "wgmma"
        print(f"{tag} kDot runs {runs['kDot']}, plan predicts "
              f"{templates['kDot']} per request x {len(REQUESTS)} = {want}; "
              f"GEMM launches by body {bodies}, operand copies {copies}, "
              f"element-by-element f32 launches {scalar}",
              flush=True)
        check(runs["kDot"] == want, f"{tag} kDot runs {runs['kDot']} != "
                                    f"the plan's {want}")
        check(bodies[body] == launches["matmul_epilogue"],
              f"{tag} kDot launches {launches['matmul_epilogue']}, on the "
              f"{body} body {bodies}")
        check(copies == 0, f"{tag} the GEMM copied {copies} operands")
        check(scalar == 0, f"{tag} {scalar} f32 GEMM launches on the "
                           f"element-by-element instance")
    report[(path, dtype_name)] = dict(launches=launches, compiles=counts,
                                      lower_s=art["lower_s"])

    if path in TIMED_PATHS:
        request_times(tag, f, inputs, {
            "kloop": launches["fused_elementwise"],
            "kinput": launches["fused_reduce"],
            "kdot": launches["matmul_epilogue"]})
    # extra, uncounted runs record every kernel program at 1999, and at
    # 37 for the wrappers' host cost (eagerly: a replay calls no wrapper)
    with eager_entries(), Recorder() as rec:
        f(inputs[1999])
        torch.cuda.synchronize()
    with eager_entries(), Recorder() as rec37:
        f(inputs[37])
        torch.cuda.synchronize()
    host_phase(rec37.calls, tag)
    return rec.calls


def graph_checks(tag: str, art: dict, inputs: dict, rows: list,
                 graph_io: list) -> None:
    """Paths 1, 2 and 7 under CUDA graphs: one capture a bucket (captures
    == compiles), every other request a replay; the bytes copied into a
    bucket's graph a request are its padded input plus ``lens`` (one
    int32 a symbol) and nothing more, so no weight is copied; and each
    graphed output equals the same kernels launched one by one under
    ``eager_entries()`` bit for bit."""
    import torch

    from repro_torch.core.graphs import eager_entries

    f = art["f"]
    st = f.graph_stats
    rep = f.report()["graphs"]
    counts = f.compile_counts()
    check(not rep["host_entries"] and rep["graphed_entries"] ==
          counts["total"], f"{tag} entries {rep} for compiles {counts}")
    check(st.captures == counts["total"],
          f"{tag} captures {st.captures} != compiles {counts['total']}")
    elt = torch.empty((), dtype=art["dt"]).element_size()
    lens_bytes = 4 * len(f.syms)
    for (s, key, dt_s, compiled, y), (_, _, b_in, _, cap) in zip(rows,
                                                                  graph_io):
        want = math.prod(art["shape"](key)) * elt + lens_bytes
        check(cap == compiled, f"{tag} S={s}: captured {cap}, compiled "
                               f"{compiled}")
        check(b_in == want, f"{tag} S={s}: {b_in} B copied into the graph, "
                            f"the padded input and lens are {want} B")
    check(st.replays == len(rows) - counts["total"],
          f"{tag} replays {st.replays} for {len(rows)} requests and "
          f"{counts['total']} captures")
    same = []
    with eager_entries():
        for s, key, dt_s, compiled, y in rows:
            ye = f(inputs[s])
            torch.cuda.synchronize()
            same.append(bool(torch.equal(y, ye)))
            del ye
    print(f"{tag} graphs: captures {st.captures} (== compiles "
          f"{counts['total']}), replays {st.replays}; bytes copied in a "
          f"request {[io[2] for io in graph_io]} (padded input + lens "
          f"{lens_bytes} B), out {[io[3] for io in graph_io]}; capture s "
          f"{[round(x, 3) for x in st.capture_seconds]}; input buffers "
          f"{st.buffer_bytes} B; pool reserved {rep['pool_bytes']} B; "
          f"graphed == eager_entries() bit for bit {same}", flush=True)
    check(all(same), f"{tag} graphed outputs differ from eager_entries()")


def request_times(tag: str, f, inputs: dict, path_launches: dict) -> None:
    """One request at S = 37 and S = 1999, graphed and under
    ``eager_entries()`` (the same kernels launched one by one): the host
    clock's median of ``PROFILE_ROUNDS`` synchronised calls, and one call
    under ``torch.profiler`` (its wall ms, the profiler's cost included,
    and the ms the card was busy in kernels).  The traced call's kLoop,
    kInput and GEMM kernels as the card ran them (``TRACE_KERNELS``) must
    equal what the launch counters added in that call (a replay adds the
    capture's counts; GEMMs beyond the kDots, the §4.5 library's, add to
    both), and the kLoop, kInput and kDot counts must be the path's own
    a request: ``path_launches`` over its ``REQUESTS``."""
    from repro_torch.core.graphs import eager_entries
    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.matmul import ops as mm

    def count():
        return {"kloop": fe.LAUNCHES.launches,
                "kinput": fr.LAUNCHES.launches,
                "gemm": sum(c.launches for c in mm.BODY_LAUNCHES.values()),
                "kdot": mm.EPILOGUE_LAUNCHES.launches}

    for s in (37, 1999):
        for mode in ("graphed", "eager"):
            ctx = eager_entries if mode == "eager" else contextlib.nullcontext
            counted = {}

            def traced(s=s, counted=counted):
                before = count()
                f(inputs[s])
                counted.update({k: n - before[k]
                                for k, n in count().items()})

            with ctx():
                med = median_ms(lambda: f(inputs[s]), PROFILE_ROUNDS)
                wall, busy, top, seen = profile_ms(traced,
                                                   lambda: f(inputs[s]))
            print(f"{tag} S={s} {mode}: ms a request {med:.3f} (median of "
                  f"{PROFILE_ROUNDS}); under torch.profiler wall "
                  f"{wall:.3f} ms, device busy "
                  f"{'not measured' if busy is None else f'{busy:.3f}'} "
                  f"ms; top kernels {top}", flush=True)
            ran = {k: seen[k] for k in ("kloop", "kinput", "gemm")}
            check(all(counted[k] * len(REQUESTS) == n
                      for k, n in path_launches.items()),
                  f"{tag} S={s} {mode}: the launch counters added "
                  f"{counted} in the traced request, the path counts "
                  f"{path_launches} in {len(REQUESTS)} requests")
            if busy is None:
                print(f"{tag} S={s} {mode}: kernels as the card ran them "
                      f"not measured (the profiler saw no device time)",
                      flush=True)
                continue
            check(ran == {k: counted[k] for k in ran},
                  f"{tag} S={s} {mode}: the card ran {ran} in the traced "
                  f"request, the launch counters added {counted}")
            print(f"{tag} S={s} {mode}: the card ran kLoop / kInput / GEMM "
                  f"{ran} in the traced request (== the counters; kDots "
                  f"{counted['kdot']}; the path's {path_launches} in "
                  f"{len(REQUESTS)} requests)",
                  flush=True)


def retype(program, dt):
    """The same program with its float32 values stored in ``dt``."""
    import dataclasses

    import torch

    from repro_torch.kernels.program import Program

    sw = (lambda d: dt if d == torch.float32 else d)
    steps = tuple(dataclasses.replace(st, dtype=sw(st.dtype),
                                      param=sw(st.param)
                                      if st.opcode == "convert" else st.param)
                  for st in program.steps)
    return Program(tuple(sw(d) for d in program.in_dtypes), steps,
                   program.outs)


def one_call(program, xs):
    """A single PyTorch call computing a one-step kLoop program over its
    inputs (the library call it is timed against), or ``None``."""
    import torch

    fns = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "max": torch.maximum, "min": torch.minimum,
           "exp": torch.exp, "tanh": torch.tanh, "logistic": torch.sigmoid,
           "rsqrt": torch.rsqrt, "sqrt": torch.sqrt, "neg": torch.neg,
           "abs": torch.abs, "log": torch.log}
    if len(program.steps) != 1 or program.outs != (("t", 0),):
        return None
    st = program.steps[0]
    fn = fns.get(st.opcode)
    args = []
    for kind, x in st.args:
        if kind != "in" or program.in_dtypes[x] != st.dtype:
            return None
        args.append(xs[x])
    return None if fn is None else (lambda: fn(*args))


def reduce_rows_ok(program, xs, n_cols, kind, ax, shape, out_k, out_p,
                   dname) -> bool:
    """kInput kernel vs plain version, row by row: max/min exactly; a sum
    within ``TOL_REDUCE_ROW`` of the row's sum of magnitudes; a product
    within it of the product's magnitude."""
    import torch

    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
    from repro_torch.kernels.program import Program, Step

    d = (out_k.float() - out_p.float()).abs()
    if kind in ("max", "min"):
        return d.max().item() == 0
    if kind == "sum":
        src = program.outs[0]
        mag_prog = Program(program.in_dtypes, program.steps + (
            Step("abs", (src,), program.dtype_of(src)),),
            (("t", len(program.steps)),))
        mag = fused_reduce_ref(mag_prog, xs, n_cols, "sum", ax, shape,
                               torch.float32)
    else:
        mag = out_p.float().abs()
    return bool((d <= TOL_REDUCE_ROW[dname] * mag).all())


def kernel_phase(calls: dict, dtype_name: str, launches: dict, rows: list,
                 path: str = "path1"):
    """Each recorded program through the wrapper the path calls, against
    its plain version on the same card inputs; then the path's kLoop and
    kInput device ms a request (each program's launches in one request
    times its ms)."""
    import torch

    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_elementwise.ref import \
        fused_elementwise_ref
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
    from repro_torch.kernels.lengths import device_ints

    def launched(counter, fn):
        before = counter.launches
        out = fn()
        check(counter.launches == before + 1,
              f"wrapper launched {counter.launches - before} kernels")
        return out

    variants = [(dtype_name, c) for k, c in calls.items()
                if k[0] in ("fused_elementwise", "fused_reduce")]
    if dtype_name == "f32":
        # kInput reaches the path in f32 only; hold it in bf16 as well
        variants += [("bf16", dict(c, program=retype(c["program"],
                                                     torch.bfloat16),
                                   inputs=[x.to(torch.bfloat16)
                                           for x in c["inputs"]],
                                   out_dtype=torch.bfloat16))
                     for k, c in calls.items() if k[0] == "fused_reduce"]
    for dname, c in variants:
        prog, xs, shape = c["program"], c["inputs"], c["shape"]
        total = math.prod(shape)
        n_path = c["n_valid"]
        lib_err = None
        if "kind" in c:
            name = "fused_reduce"
            kind, ax, out_dtype = c["kind"], c["axis"] % len(shape), \
                c["out_dtype"]
            # the column counts on the card, as the path hands them over
            on_card = {n: device_ints([n], "cuda")
                       for n in (n_path, shape[ax] - 48)}

            def run_k(n):
                return fr.fused_reduce(prog, xs, on_card[n], kind, axis=ax,
                                       shape=shape, out_dtype=out_dtype)

            def run_p(n):
                return fused_reduce_ref(prog, xs, n, kind, ax, shape,
                                        out_dtype)

            err, scale, ok = 0.0, 0.0, True
            # the path's valid columns, and fewer than the padded size
            for n in sorted({n_path, shape[ax] - 48}):
                out_k = launched(fr.LAUNCHES, lambda: run_k(n))
                out_p = run_p(n)
                torch.cuda.synchronize()
                err = max(err, (out_k.float() - out_p.float())
                          .abs().max().item())
                scale = max(scale, out_p.float().abs().max().item())
                ok = ok and reduce_rows_ok(prog, xs, n, kind, ax, shape,
                                           out_k, out_p, dname)
            tails_ok = True  # masked columns are inside the reduction
            rows_n = total // shape[ax]
            in_bytes = sum(unique_bytes(x) * n_path // shape[ax]
                           if x.stride()[ax] != 0 else unique_bytes(x)
                           for x in [torch.broadcast_to(t, shape) for t in xs])
            out_bytes = rows_n * out_k.element_size()
            ops = (len(prog.steps) + 1) * rows_n * n_path
            lib = None
            st = prog.steps
            if (len(st) == 1 and st[0].opcode == "mul"
                    and st[0].args == (("in", 0), ("in", 0))
                    and kind == "sum" and ax == len(shape) - 1):
                xv = xs[0][..., :n_path]
                lib = lambda: torch.linalg.vecdot(xv, xv, dim=-1)
        else:
            name = "fused_elementwise"

            def run_k(n):
                return fe.fused_elementwise(prog, xs, n, shape)

            def run_p(n):
                return fused_elementwise_ref(prog, xs, n, shape)

            err, scale, tails_ok = 0.0, 0.0, True
            # the path's n_valid, and one below the padded size
            for n in sorted({n_path, total - 3 * shape[-1] - 5}):
                outs_k = launched(fe.LAUNCHES, lambda: run_k(n))
                outs_p = run_p(n)
                torch.cuda.synchronize()
                for a, b in zip(outs_k, outs_p):
                    err = max(err, (a.float() - b.float()).abs().max().item())
                    scale = max(scale, b.float().abs().max().item())
                tails_ok = tails_ok and all(
                    bool((o.reshape(-1)[n:] == 0).all()) for o in outs_k)
            ok = err == 0
            in_bytes = sum(unique_bytes(torch.broadcast_to(t, shape))
                           for t in xs)
            out_bytes = sum(o.numel() * o.element_size() for o in outs_k)
            ops = len(prog.steps) * total
            lib = one_call(prog, xs) if n_path == total else None
            if lib is not None:
                want = run_k(n_path)[0]
                lib_err = (lib().float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: run_k(n_path))
        plain_ms = cuda_ms(lambda: run_p(n_path))
        lib_ms = cuda_ms(lib) if lib is not None else None
        bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_s = ops / F32_FLOPS * 1e3
        bound_ms = max(bytes_s, ops_s)
        row = dict(name=name, **KERNELS[name],
                   launches=launches.get(name, 0) if dname == dtype_name
                   else 0,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by="bytes" if bytes_s >= ops_s else "operations",
                   library_ms=lib_ms)
        detail = dict(path=path, dtype=dname, program=prog.key,
                      shape=list(shape),
                      n_valid=n_path, steps=[s.opcode for s in prog.steps],
                      path_launches_of_program=c["count"]
                      if dname == dtype_name else 0,
                      bytes=in_bytes + out_bytes, max_ref=scale,
                      library_max_abs_err=lib_err)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(ok, f"{name} {dname} {prog.key}: max|d| {err:.3e} "
                  f"(max|ref| {scale:.3e})")
        check(tails_ok, f"{name} {dname} {prog.key}: padded tail not zero")
        rows.append((row, detail))
    per_request = {}
    for row, d in rows:
        if d.get("path") == path and d["dtype"] == dtype_name:
            per_request[row["name"]] = per_request.get(row["name"], 0.0) + \
                d["path_launches_of_program"] * row["ms"]
    print(f"[kernels] {path} {dtype_name} device ms a request at S = 1999 "
          f"(bucket 2048), launches x ms summed over programs: "
          + json.dumps(per_request), flush=True)


def host_phase(calls: dict, tag: str) -> None:
    """The kLoop and kInput wrappers' host µs a call at a recorded
    request (path 1's S = 37: bucket 64), 1000 calls back to back, beside
    the device µs a call (``launch_times``)."""
    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.lengths import device_ints

    for k, c in calls.items():
        if k[0] == "fused_elementwise":
            run = (lambda c=c: fe.fused_elementwise(
                c["program"], c["inputs"], c["n_valid"], c["shape"]))
        elif k[0] == "fused_reduce":
            # the column count on the card, as the path hands it over
            run = (lambda c=c, n=device_ints([c["n_valid"]], "cuda"):
                   fr.fused_reduce(c["program"], c["inputs"], n, c["kind"],
                                   axis=c["axis"], shape=c["shape"],
                                   out_dtype=c["out_dtype"]))
        else:
            continue
        t = launch_times(run)
        print(f"[host] {tag} {k[0]} {c['program'].key} shape="
              f"{list(c['shape'])} host_us={t['host_us']:.2f} "
              f"back_to_back_us={t['back_to_back_us']:.2f} device_us="
              f"{t['device_us']}", flush=True)


def reduce_extra_rows(rows: list) -> None:
    """kInput beyond the paths' shapes, f32, through the wrapper: one row
    of 4 M elements (its columns split over programs, the partials
    combined in a fixed order) and a reduce over axis 0 of 2048 x 2048
    (lanes along the kept axis).  Each against its plain version row by
    row and twice (the same bits), timed beside ``torch.linalg.vecdot``,
    with its bound from the bytes it must move."""
    import torch

    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.fused_reduce.ref import fused_reduce_ref
    from repro_torch.kernels.lengths import device_ints
    from repro_torch.kernels.program import Program, Step

    f32 = torch.float32
    prog = Program((f32,), (Step("mul", (("in", 0), ("in", 0)), f32),),
                   (("t", 0),))
    gen = torch.Generator(device="cuda").manual_seed(23)
    for label, shape, axis, n_cols in (("one_row_4m", (1, 4 << 20), 1,
                                        (4 << 20) - 77),
                                       ("axis0", (2048, 2048), 0, 2048)):
        x = torch.randn(shape, generator=gen, device="cuda")

        def run_k(x=x, shape=shape, axis=axis,
                  n=device_ints([n_cols], "cuda")):
            return fr.fused_reduce(prog, [x], n, "sum", axis=axis,
                                   shape=shape, out_dtype=f32)

        before = fr.LAUNCHES.launches
        out_k, again = run_k(), run_k()
        check(fr.LAUNCHES.launches == before + 2,
              f"fused_reduce {label}: launches")
        out_p = fused_reduce_ref(prog, [x], n_cols, "sum", axis, shape, f32)
        torch.cuda.synchronize()
        check(torch.equal(out_k, again), f"fused_reduce {label}: two runs "
                                         f"gave different bits")
        ok = reduce_rows_ok(prog, [x], n_cols, "sum", axis, shape, out_k,
                            out_p, "f32")
        err = (out_k - out_p).abs().max().item()
        xv = x.narrow(axis, 0, n_cols)
        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(lambda: fused_reduce_ref(prog, [x], n_cols, "sum",
                                                    axis, shape, f32))
        lib_ms = cuda_ms(lambda: torch.linalg.vecdot(xv, xv, dim=axis))
        n_out = out_k.numel()
        byts = n_out * n_cols * 4 + n_out * 4
        bytes_s = byts / HBM_BYTES_PER_S * 1e3
        ops_s = 2 * n_out * n_cols / F32_FLOPS * 1e3
        row = dict(name="fused_reduce", **KERNELS["fused_reduce"],
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bytes_s, ops_s),
                   bound_by="bytes" if bytes_s >= ops_s else "operations",
                   library_ms=lib_ms)
        detail = dict(path="beyond the paths", case=label, dtype="f32",
                      program=prog.key, shape=list(shape), axis=axis,
                      n_valid=n_cols, path_launches_of_program=0,
                      bytes=byts, max_ref=out_p.abs().max().item())
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(ok, f"fused_reduce {label}: max|d| {err:.3e}")
        rows.append((row, detail))


def cluster_builds() -> None:
    """Each kLoop / kInput program's generated modules and Triton
    specialisations after paths 1-2 and their kernel phases, beside the
    instances it launched (plan constants, alignment class, operands'
    16-byte bases: every length is a runtime argument).  Fails where a
    program built more kernels than instances (a recompile for a length)
    or where no kernel of an aligned instance shows 16-byte global loads
    (and, for kLoop, stores) in its PTX."""
    from repro_torch.kernels import triton_build
    from repro_torch.kernels.fused_elementwise import \
        fused_elementwise as fe_k
    from repro_torch.kernels.fused_reduce import fused_reduce as fr_k

    for label, mod, fn in (("kLoop", fe_k, "kloop"),
                           ("kInput", fr_k, "kinput")):
        for key, insts in sorted(mod.INSTANCES.items()):
            names = sorted({i[0] for i in insts})
            kernels = [k for n in names for k in triton_build.compiled(n, fn)]
            ptx = [triton_build.ptx_accesses(k.asm["ptx"]) for k in kernels]
            aligned = sum(1 for i in insts if i[-2])
            print(f"[build] {label} program {key}: modules {len(names)}, "
                  f"Triton specialisations {len(kernels)}, instances "
                  f"{len(insts)} ({aligned} aligned); PTX global accesses "
                  f"{ptx}; registers "
                  f"{[getattr(k, 'n_regs', None) for k in kernels]}",
                  flush=True)
            check(len(kernels) <= len(insts),
                  f"{label} program {key}: {len(kernels)} Triton "
                  f"specialisations for {len(insts)} instances")
            if aligned:
                check(any(c.get("ld.v4") for c in ptx),
                      f"{label} program {key}: no 16-byte loads")
                if label == "kLoop":
                    check(any(c.get("st.v4") for c in ptx),
                          f"{label} program {key}: no 16-byte stores")


def gemm_bound(a_bytes: int, b_bytes: int, other_bytes: int, flops: int,
               dname: str):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the flops over the peak of the type (f32: FFMA, since the work is
    IEEE f32; bf16: the dense tensor-core rate)."""
    bytes_ms = (a_bytes + b_bytes + other_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (F32_FLOPS if dname == "f32" else BF16_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def gemm_phase(calls: dict, dtype_name: str, launches: dict, rows: list):
    """Each recorded kDot program through the wrapper the path calls,
    against ``matmul_fused_ref`` on the same card inputs: at the path's
    valid M, at a smaller valid M, and with ragged N and K, the valid
    extents given as the path gives them (an int32[3] on the card that
    the kernel reads)."""
    import torch

    from repro_torch.kernels.lengths import device_ints
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.matmul import gemm_plan
    from repro_torch.kernels.matmul.ref import matmul_fused_ref

    name = "matmul_epilogue"
    tol = TOL_GEMM[dtype_name]
    for c in [c for k, c in calls.items() if k[0] == name]:
        prog = c["program"]
        gen = torch.Generator(device="cuda").manual_seed(7)
        m, k = c["a"].shape
        n = c["b"].shape[1]
        vm, vn, vk = c["valid"]
        # ragged N and K beside the path's shapes: 2000 x 1000 x 1000
        ra = torch.randn((2000, 1000), generator=gen,
                         device="cuda").to(c["a"].dtype)
        rb = (torch.randn((1000, 1000), generator=gen, device="cuda")
              / 32).to(c["b"].dtype)
        rx = [torch.randn((2000, 1000), generator=gen,
                          device="cuda").to(dt) for dt in prog.in_dtypes[1:]]
        cases = [("path", c["a"], c["b"], c["extras"], (vm, vn, vk)),
                 ("small_m", c["a"], c["b"], c["extras"],
                  (min(vm, 1000), vn, vk)),
                 ("ragged_nk", ra, rb, rx, (1990, 997, 999))]
        err, scale, worst = 0.0, 0.0, 0.0
        for label, a, b, xs, valid in cases:
            before = mm.EPILOGUE_LAUNCHES.launches
            outs_k = mm.matmul_fused(a, b, xs, prog,
                                     valid_mnk=device_ints(valid, "cuda"),
                                     out_dtypes=c["out_dtypes"])
            check(mm.EPILOGUE_LAUNCHES.launches == before + 1,
                  "matmul_fused launched no kernel")
            outs_p = matmul_fused_ref(a, b, xs, prog, valid, c["out_dtypes"])
            torch.cuda.synchronize()
            for ok_, op_ in zip(outs_k, outs_p):
                e = (ok_.float() - op_.float()).abs().max().item()
                sc = op_.float().abs().max().item()
                err, scale = max(err, e), max(scale, sc)
                worst = max(worst, e / sc if sc else e)
                check(not ok_[valid[0]:].any() and not ok_[:, valid[1]:].any(),
                      f"{name} {dtype_name} {prog.key} {label}: padded "
                      f"tail not zero")
            print(f"[gemm] {name} {dtype_name} {prog.key} {label} "
                  f"shape=({a.shape[0]},{a.shape[1]},{b.shape[1]}) "
                  f"valid={valid} rel={worst:.3e}", flush=True)
        a, b, xs = c["a"], c["b"], c["extras"]
        on_card = device_ints((vm, vn, vk), "cuda")

        def run_k():
            return mm.matmul_fused(a, b, xs, prog, valid_mnk=on_card,
                                   out_dtypes=c["out_dtypes"])

        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(lambda: matmul_fused_ref(a, b, xs, prog,
                                                    (vm, vn, vk),
                                                    c["out_dtypes"]))
        # the library call: the GEMM alone, without the epilogue
        lib_ms = cuda_ms(lambda: torch.matmul(a[:vm, :vk], b[:vk, :vn]))
        elt = a.element_size()
        x_bytes = 0
        for x in xs:
            v = torch.broadcast_to(x, (m, n))
            x_bytes += (vm if v.stride(0) else 1) * \
                (vn if v.stride(1) else 1) * v.element_size()
        out_bytes = sum(m * n * torch.empty((), dtype=dt).element_size()
                        for dt in c["out_dtypes"])
        bound_ms, bound_by = gemm_bound(vm * vk * elt, vk * vn * elt,
                                        x_bytes + out_bytes,
                                        2 * vm * vn * vk, dtype_name)
        row = dict(name=name, **KERNELS[name],
                   launches=launches.get(name, 0), max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib_ms)
        plan = gemm_plan(a.dtype, "kdot", m, n, k)   # the padded extents
        detail = dict(dtype=dtype_name, program=prog.key,
                      shape=[m, k, n], valid=[vm, vn, vk],
                      steps=[st.opcode for st in prog.steps],
                      path_launches_of_program=c["count"],
                      bytes=vm * vk * elt + vk * vn * elt + x_bytes
                      + out_bytes, max_ref=scale, max_rel=worst,
                      library_call="torch.matmul, GEMM only, without "
                                   "the epilogue",
                      library_ratio=ms / lib_ms, body=plan.body,
                      tile=list(plan.tile), splits=plan.splits,
                      tflops=2 * vm * vn * vk / ms / 1e9,
                      bound_share=bound_ms / ms)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(worst <= tol, f"{name} {dtype_name} {prog.key}: "
                            f"max|d|/max|ref| {worst:.3e} > {tol}")
        rows.append((row, detail))
        small_bucket(c, dtype_name)


def small_bucket(c: dict, dtype_name: str) -> None:
    """The recorded kDot program at path 2's smallest bucket (T = 37 of
    64, split-K): against its plain version, tails zero, two launches
    bit for bit equal, and timed beside ``torch.matmul`` (printed)."""
    import torch

    from repro_torch.kernels.lengths import device_ints
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.matmul import gemm_plan
    from repro_torch.kernels.matmul.ref import matmul_fused_ref

    prog = c["program"]
    k, n = c["a"].shape[1], c["b"].shape[1]
    m, vm = 64, 37
    _, vn, vk = c["valid"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    a = torch.randn((m, k), generator=gen, device="cuda").to(c["a"].dtype)
    b = c["b"]
    xs = [torch.randn((m, n), generator=gen, device="cuda").to(dt)
          for dt in prog.in_dtypes[1:]]

    on_card = device_ints((vm, vn, vk), "cuda")

    def run():
        return mm.matmul_fused(a, b, xs, prog, valid_mnk=on_card,
                               out_dtypes=c["out_dtypes"])

    outs_k = run()
    again = run()
    outs_p = matmul_fused_ref(a, b, xs, prog, (vm, vn, vk), c["out_dtypes"])
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(outs_k, again)),
          f"kDot {dtype_name} {prog.key} T={vm}: two split-K launches "
          f"differ")
    worst = 0.0
    for ok_, op_ in zip(outs_k, outs_p):
        sc = op_.float().abs().max().item()
        e = (ok_.float() - op_.float()).abs().max().item()
        worst = max(worst, e / sc if sc else e)
        check(not ok_[vm:].any(), f"kDot {prog.key} T={vm}: tail not zero")
    check(worst <= TOL_GEMM[dtype_name],
          f"kDot {dtype_name} {prog.key} T={vm}: rel {worst:.3e}")
    ms = cuda_ms(run)
    lib_ms = cuda_ms(lambda: torch.matmul(a[:vm, :vk], b[:vk, :vn]))
    plan = gemm_plan(a.dtype, "kdot", m, n, k)
    print(f"[gemm] matmul_epilogue {dtype_name} {prog.key} small_bucket "
          f"shape=({m},{k},{n}) valid={(vm, vn, vk)} rel={worst:.3e} "
          f"ms={ms:.5f} library_ms={lib_ms:.5f} "
          f"library_ratio={ms / lib_ms:.3f} body={plan.body} "
          f"tile={list(plan.tile)} splits={plan.splits}", flush=True)


def library_phase(rows: list, report: dict):
    """``pick`` at TinyLlama widths: one counted run through each entry,
    then each library version against ``matmul_ref`` and timed."""
    import torch

    from repro_torch.core.library import pick
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.matmul import gemm_plan
    from repro_torch.kernels.matmul.ref import matmul_ref

    name = "matmul"
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        ops_in = {}
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = (torch.randn((k, n), generator=gen, device="cuda")
                 / 32).to(dt)
            ops_in[want] = (a, b)
        mm.LAUNCHES.reset()
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            choice = pick(m, k, n)
            check(choice.name == want,
                  f"pick{(m, k, n)} = {choice.name}, expected {want}")
            y = choice(*ops_in[want])
            check(tuple(y.shape) == (m, n) and y.dtype == dt,
                  f"{want}: {tuple(y.shape)} {y.dtype}")
        torch.cuda.synchronize()
        launches = mm.LAUNCHES.launches
        n_lib = sum(w.startswith("library:") for w in LIBRARY_SHAPES)
        print(f"[library {dname}] pick ran {len(LIBRARY_SHAPES)} entries, "
              f"{launches} library launches", flush=True)
        check(launches == n_lib,
              f"library: {launches} launches for {n_lib} versions")
        report[("library", dname)] = dict(launches={name: launches})
        for want, (m, k, n) in LIBRARY_SHAPES.items():
            if not want.startswith("library:"):
                continue
            version = want.split(":", 1)[1]
            a, b = ops_in[want]
            got = mm.matmul(a, b, version=version)
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / scale
            ms = cuda_ms(lambda: mm.matmul(a, b, version=version))
            plain_ms = cuda_ms(lambda: matmul_ref(a, b))
            lib_ms = cuda_ms(lambda: torch.matmul(a, b))
            elt = a.element_size()
            bound_ms, bound_by = gemm_bound(m * k * elt, k * n * elt,
                                            m * n * elt, 2 * m * n * k,
                                            dname)
            row = dict(name=name, **KERNELS[name], launches=launches,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
            plan = gemm_plan(dt, version, m, n, k)
            detail = dict(dtype=dname, version=version, shape=[m, k, n],
                          max_ref=scale, max_rel=rel,
                          path_launches_of_program=1,
                          bytes=(m * k + k * n + m * n) * elt,
                          library_ratio=ms / lib_ms, body=plan.body,
                          tile=list(plan.tile), splits=plan.splits,
                          tflops=2 * m * n * k / ms / 1e9,
                          bound_share=bound_ms / ms)
            print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
            check(rel <= TOL_GEMM[dname],
                  f"{want} {dname}: max|d|/max|ref| {rel:.3e}")
            rows.append((row, detail))


# ------------------------------------------------------------- path 7 --

# path 7 (b): the control-flow functions at path 1's width, f32, vs the
# same function run by torch: the compiled path masks a bucket's padding
# and sums in other orders over up to S x D = 4 M elements
CONTROL_FLOW_D = 2048
CONTROL_FLOW_S = (37, 731, 1999)
TOL_CONTROL_FLOW = 1e-4
# path 7 (c): the paper's §5.2 comparison: DISC (``"hopper"``) and its
# per-op counterpart ``"eager"`` (the reference's ``"pallas"`` and
# ``"xla"``), each bucket one CUDA graph, the same kernels launched one by
# one (``eager_entries()``) and the standalone NimbleVM interpreter
BASELINE_BACKENDS = ("hopper", "eager")
# its requests (one a bucket of path 1's, short to long) and timed rounds
# over them (each request's median is printed)
BASELINE_REQUESTS = (37, 731, 1999)
BASELINE_ROUNDS = 3


def build_scan(cfg, art: dict) -> dict:
    """Path 7: path 1's weights stacked (L, ...) and its layers run as one
    ``scan`` of the port's ``block_apply`` (the reference's
    ``_run_blocks``), then ``ln_f`` and the head.  Eager references stay
    path 1's own (layers unrolled over the same weights)."""
    import torch
    from torch._higher_order_ops.scan import scan

    import disc_torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    params = art["params"]
    stacked = torch.utils._pytree.tree_map(lambda *ls: torch.stack(ls),
                                           *params["blocks"])

    def fn(x):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]

        def body(h, bp):
            h, _ = T.block_apply(cfg, bp, h, positions=positions)
            return h, []

        x, _ = scan(body, x, stacked)
        x = L.norm_apply(cfg, params["ln_f"], x)
        return T.logits_from_hidden(cfg, params, x)

    t0 = time.perf_counter()
    f = disc_torch.compile(
        fn, [((1, disc_torch.Dim("S", max=2048), cfg.d_model), art["dt"])],
        backend="hopper")
    low = f.lower()
    return dict(art, f=f, low=low, lower_s=time.perf_counter() - t0)


def scan_phase(cfg, dname: str, art1: dict, seed: int, report: dict):
    """Path 7 (a): one ``d.scan`` of ``cfg.n_layers`` trips, served like
    path 1 and held to path 1's limits against path 1's eager function."""
    art = build_scan(cfg, art1)
    tag = f"[path7 {dname}]"
    scans = [op for op in art["low"].graph.ops if op.opcode == "d.scan"]
    trips = [op.attrs["length_dim"] for op in scans]
    body_ops = [len(op.attrs["body_graph"].ops) for op in scans]
    print(f"{tag} d.scan ops {len(scans)}, trips {trips}, body ops "
          f"{body_ops}, graph ops {len(art['low'].graph.ops)}", flush=True)
    check(len(scans) == 1 and trips == [cfg.n_layers],
          f"{tag} want one d.scan of {cfg.n_layers} trips: {trips}")
    path_phase("path7", art, dname, seed, cfg, report)
    launches = report[("path7", dname)]["launches"]
    check(launches["fused_elementwise"] > 0,
          f"{tag} no kLoop launched outside the scan: {launches}")
    return art


def control_flow_fns(torch):
    """The functions of ``tests/test_control_flow.py`` in torch, each with
    the ``x`` inputs it runs on; the carries that double there halve
    here (2^S overflows f32 at S > 127)."""
    from torch._higher_order_ops.scan import scan
    from torch._higher_order_ops.while_loop import while_loop

    def f32(v, x):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    def i32(v, x):
        return torch.tensor(v, dtype=torch.int32, device=x.device)

    def while_fn(x):
        return while_loop(lambda i, c: i < 7,
                          lambda i, c: (i + 1, c * 1.25 + x.sum()),
                          (i32(0, x), f32(1.0, x)))[1]

    def trip_fn(x):
        return while_loop(lambda i, c: c < x[0, 0],
                          lambda i, c: (i + 1, c * 2.0),
                          (i32(0, x), f32(1.0, x)))[0]

    def scan_carry_fn(x):
        def body(c, xi):
            return c * 0.5 + xi.sum(), c.clone()
        return scan(body, f32(1.0, x), x)[0]

    def scan_ys_fn(x):
        def body(c, xi):
            return c + 1.0, xi * c
        return scan(body, f32(1.0, x), x)[1]

    def reverse_fn(x):
        def body(c, xi):
            return c * 0.5 + xi.sum(), c + xi[0]
        return scan(body, f32(1.0, x), x, reverse=True)

    def cond_fn(x):
        return torch.cond(x.sum() > 0.0, lambda a: a * 2.0,
                          lambda a: a - 1.0, (x,))

    def nested_fn(x):
        def body(c, xi):
            _, acc = while_loop(lambda i, s: i < 3,
                                lambda i, s: (i + 1, s + xi.sum()),
                                (i32(0, x), c))
            return acc.clone(), acc.clone()
        return scan(body, f32(0.0, x), x)[1]

    def thresholds(x):   # trip counts 1, 7 and 20
        out = []
        for t in (1.5, 100.0, 1e6):
            y = x.clone()
            y[0, 0] = t
            out.append(y)
        return out

    return {"while": (while_fn, lambda x: [x]),
            "trip_count": (trip_fn, thresholds),
            "scan_carry": (scan_carry_fn, lambda x: [x]),
            "scan_ys": (scan_ys_fn, lambda x: [x]),
            "reverse_scan": (reverse_fn, lambda x: [x]),
            "cond": (cond_fn, lambda x: [x.abs() + 0.1, -x.abs() - 0.1]),
            "nested": (nested_fn, lambda x: [x])}


def control_flow_phase() -> None:
    """Path 7 (b): each function under ``"hopper"`` and ``"nimble_vm"``
    at S = 37, 731 and 1999, held against torch's own run; each call's
    ``d.while`` predicate and ``d.cond`` index reads printed.  Under
    ``"hopper"`` a function holding ``d.while`` or ``d.cond`` keeps host
    entries and captures nothing, and a ``d.scan``-only one is one CUDA
    graph a bucket; ``"nimble_vm"`` captures nothing."""
    import torch

    import disc_torch
    from repro_torch.core.codegen import (COND_SYNCS, WHILE_SYNCS,
                                          host_control_flow)

    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = {s: torch.randn((s, CONTROL_FLOW_D), generator=gen,
                         device="cuda") * 0.1 for s in CONTROL_FLOW_S}
    spec = [(disc_torch.Dim("S", max=2048), CONTROL_FLOW_D)]
    for name, (fn, variants) in control_flow_fns(torch).items():
        for backend in ("hopper", "nimble_vm"):
            tag = f"[path7 cf {name} {backend}]"
            cf = disc_torch.compile(fn, spec, backend=backend)
            buckets = set()
            for s, x0 in xs.items():
                buckets.add(cf.policy.bucket("S", s))
                for vi, x in enumerate(variants(x0)):
                    WHILE_SYNCS.reset()
                    COND_SYNCS.reset()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = cf(x)
                    torch.cuda.synchronize()
                    dt_s = time.perf_counter() - t0
                    syncs = (WHILE_SYNCS.launches, COND_SYNCS.launches)
                    want = fn(x)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, (tuple, list)) \
                        else (want,)
                    check(len(got) == len(want), f"{tag} outputs")
                    rels = []
                    for g, w in zip(got, want):
                        check(tuple(g.shape) == tuple(w.shape),
                              f"{tag} S={s} shape {tuple(g.shape)} vs "
                              f"{tuple(w.shape)}")
                        check(bool(torch.isfinite(g.float()).all()),
                              f"{tag} S={s}: non-finite output")
                        d = (g.float() - w.float()).abs().max().item()
                        rels.append(d / max(w.float().abs().max().item(),
                                            1e-30))
                    print(f"{tag} S={s:5d} case={vi} latency_s={dt_s:.4f} "
                          f"while_syncs={syncs[0]} cond_syncs={syncs[1]} "
                          f"rel={max(rels):.3e}", flush=True)
                    check(max(rels) <= TOL_CONTROL_FLOW,
                          f"{tag} S={s}: rel {max(rels):.3e} > "
                          f"{TOL_CONTROL_FLOW}")
            check(cf.n_compiles == len(buckets),
                  f"{tag} {cf.n_compiles} compiles for {len(buckets)} "
                  f"buckets")
            rep = cf.report()["graphs"]
            host = backend == "nimble_vm" or \
                bool(host_control_flow(cf.lower().graph))
            print(f"{tag} entries: graphed {rep['graphed_entries']}, host "
                  f"{rep['host_entries']} {rep['host_control_flow']}; "
                  f"captures {rep['captures']}, replays {rep['replays']}",
                  flush=True)
            if host:
                check(rep["host_entries"] == cf.n_compiles
                      and rep["captures"] == rep["graphed_entries"] == 0,
                      f"{tag} host entries expected: {rep}")
            else:
                check(rep["graphed_entries"] == rep["captures"]
                      == cf.n_compiles and not rep["host_entries"],
                      f"{tag} one graph a bucket expected: {rep}")
            del cf


def baseline_graph_check(tag: str, run, inputs: dict, last: dict) -> None:
    """A path 7 (c) runner of ``BASELINE_BACKENDS`` after its timed
    rounds: one graph a bucket (captures == compiles, no host entry),
    every call past a bucket's first a replay, and ``last``, each
    request's last graphed output, equal bit for bit to the same entries
    run under ``eager_entries()``."""
    import torch

    from repro_torch.core.graphs import eager_entries

    st, counts = run.graph_stats, run.compile_counts()
    rep = run.report()["graphs"]
    calls = len(BASELINE_REQUESTS) * (1 + BASELINE_ROUNDS)
    check(not rep["host_entries"] and rep["graphed_entries"] ==
          counts["total"] == st.captures,
          f"{tag} entries {rep}, captures {st.captures} for compiles "
          f"{counts}")
    check(st.replays == calls - counts["total"],
          f"{tag} replays {st.replays} for {calls} calls and "
          f"{counts['total']} captures")
    same = []
    with eager_entries():
        for s in BASELINE_REQUESTS:
            ye = run(inputs[s])
            torch.cuda.synchronize()
            same.append(bool(torch.equal(last[s], ye)))
            del ye
    print(f"{tag} graphs: captures {st.captures} (== compiles "
          f"{counts['total']}), replays {st.replays}; graphed == "
          f"eager_entries() bit for bit at S = {BASELINE_REQUESTS}: {same}",
          flush=True)
    check(all(same), f"{tag} graphed outputs differ from eager_entries()")


def baseline_phase(dname: str, arts: dict, card: str, seed: int) -> None:
    """Path 7 (c), printed only: path 1's and path 7's lowered graphs,
    each request timed (host clock, synchronised; the median of
    ``BASELINE_ROUNDS`` rounds) under the backends of
    ``BASELINE_BACKENDS`` (each bucket one CUDA graph: captures ==
    compiles, no host entry, every call past a bucket's first a replay,
    and each request's last graphed output equal bit for bit to the same
    backend's entries run under ``eager_entries()``), ``"hopper"``
    under ``eager_entries()`` (the same kernels launched one by one) and
    ``NimbleVM(sync_per_op=True)``; at
    S = 1999 the VM's op dispatches, interpretation seconds and their
    host share (1 - the device time ``torch.profiler`` sums / the call's
    seconds)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from disc_torch import NimbleVM
    from repro_torch.core.graphs import eager_entries

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    any_art = next(iter(arts.values()))
    inputs = {s: torch.randn(any_art["shape"](s), generator=gen,
                             device="cuda").to(any_art["dt"])
              for s in BASELINE_REQUESTS}
    at = {}
    for path, art in arts.items():
        low = art["low"]
        runners = {b: low.compile(dataclasses.replace(low.options,
                                                      backend=b))
                   for b in BASELINE_BACKENDS}
        def eager_run(x, run=runners["hopper"]):
            with eager_entries():
                return run(x)

        runners["hopper eager_entries"] = eager_run
        vm = NimbleVM(low.graph, sync_per_op=True)
        runners["NimbleVM(sync_per_op)"] = lambda x, vm=vm: vm(x)[0]
        for name, run in runners.items():
            tag = f"[path7 baseline {dname} {path} {name}]"
            for s in BASELINE_REQUESTS:  # a bucket's first call builds it
                run(inputs[s])
            torch.cuda.synchronize()
            samples = {s: [] for s in BASELINE_REQUESTS}
            last = {}
            for _ in range(BASELINE_ROUNDS):
                for s in BASELINE_REQUESTS:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = last[s] = run(inputs[s])
                    torch.cuda.synchronize()
                    samples[s].append(time.perf_counter() - t0)
                    check(bool(torch.isfinite(y).all()),
                          f"{tag} S={s}: non-finite output")
            if name in BASELINE_BACKENDS:
                baseline_graph_check(tag, run, inputs, last)
            del y, last
            times = [sorted(samples[s])[len(samples[s]) // 2]
                     for s in BASELINE_REQUESTS]
            at[(path, name)] = dict(zip(BASELINE_REQUESTS, times))
            print(f"{tag} ms a request " + " ".join(
                f"S={s}:{t * 1e3:.2f}"
                for s, t in zip(BASELINE_REQUESTS, times))
                + f" | {card}", flush=True)
        # one call's interpretation seconds, the next call's device time
        dispatches, secs0 = vm.stats.op_dispatches, vm.stats.interp_seconds
        vm(inputs[1999])
        torch.cuda.synchronize()
        interp = vm.stats.interp_seconds - secs0
        dispatches = vm.stats.op_dispatches - dispatches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            vm(inputs[1999])
            torch.cuda.synchronize()
        dev_us = kernel_device_us(prof)
        share = (1.0 - dev_us * 1e-6 / interp) if dev_us else None
        print(f"[path7 baseline {dname} {path}] NimbleVM S=1999: "
              f"op_dispatches {dispatches} (graph ops {len(low.graph.ops)}),"
              f" interp_s {interp:.4f}, device_s {dev_us * 1e-6:.4f}, host "
              f"share {'not measured' if share is None else f'{share:.3f}'}"
              f" | {card}", flush=True)
        del runners, vm
    hop = at[("path1", "hopper")][1999]
    ratios = " ".join(
        f"{path}/{name}={at[(path, name)][1999] / hop:.3f}"
        for path, name in at)
    print(f"[path7 baseline {dname}] S=1999 over path1 hopper "
          f"({hop * 1e3:.2f} ms): {ratios} | {card}", flush=True)
    for path in arts:   # the paper's §5.2 ratio, DISC graphed over the VM
        graphed = at[(path, "hopper")]
        print(f"[path7 baseline {dname} {path}] NimbleVM(sync_per_op) / "
              f"hopper graphed " + " ".join(
                  f"S={s}:{at[(path, 'NimbleVM(sync_per_op)')][s] / t:.3f}"
                  for s, t in graphed.items())
              + "; hopper eager_entries / graphed " + " ".join(
                  f"S={s}:{at[(path, 'hopper eager_entries')][s] / t:.3f}"
                  for s, t in graphed.items()) + f" | {card}", flush=True)


# ------------------------------------------------------------- path 3 --

def serve_engine_class():
    """``ServeEngine`` recording, per request and token, the logits row
    the token was taken from (on the host) and the wall time it arrived,
    plus the seconds of every prefill launch and decode step."""
    from repro_torch.serve.engine import ServeEngine

    class Recording(ServeEngine):
        def __init__(self, *a, shared_block: bool = False,
                     router: bool = False, profile: bool = False, **kw):
            super().__init__(*a, **kw)
            self.logits = {}     # (rid, token index) -> (V,) f32 on host
            self.arrived = {}    # rid -> host seconds of its first token
            self.step_s = {"prefill": [], "decode": []}
            self.first = {}      # kind -> (fn, params, args, new cache)
            # with shared_block: kind -> the inputs of the first launch's
            # zamba shared-block invocation 0 (see record_shared_block)
            self.block = {} if shared_block else None
            # with router: per launch, its kind and per MoE layer its
            # routing (see record_router); rid -> the index of the launch
            # that gave the request its first token
            self.routes = [] if router else None
            self.first_launch = {}
            self.host = None     # the last host array moved to the card
            self.t0 = time.perf_counter()
            # with profile: (wall ms, device-busy ms, top kernels, the
            # port's kernels) of the second decode step after every
            # request has its first token, under torch.profiler, the
            # first its warm-up step (both kept out of step_s)
            self.profiled = None if profile else False

        def _tensor(self, a):
            self.host = a
            return super()._tensor(a)

        def _launch(self, kind, fn, *args):
            # the inputs and the new cache of the first launch of a kind;
            # a prefill launch continuing a prompt is kind "prefill_cont":
            # its offsets, the last host array moved to the card, are not
            # all 0 (read on the host: no sync in the timed run)
            if kind == "prefill" and self.host.any():
                kind = "prefill_cont"
            first = kind not in self.first
            inputs = clone_tree(args[1:]) if first else None
            with contextlib.ExitStack() as stack:
                if self.block is not None and first:
                    stack.enter_context(record_shared_block(self.block, kind))
                if self.routes is not None:
                    self.routes.append((kind, []))
                    stack.enter_context(record_router(self.routes[-1][1]))
                out = super()._launch(kind, fn, *args)
            if first:
                self.first[kind] = (fn, args[0], inputs, clone_tree(out[1]))
            return out

        def _next_tokens(self, slots, logits):
            ids = super()._next_tokens(slots, logits)  # synchronises
            now = time.perf_counter() - self.t0
            rows = logits.float().cpu()
            for r, i in enumerate(slots):
                s = self.slots[i]
                self.logits[(s.rid, len(s.generated))] = rows[r]
                self.arrived.setdefault(s.rid, now)
                if self.routes is not None and not s.generated:
                    self.first_launch[s.rid] = len(self.routes) - 1
            return ids

        def _timed(self, kind, fn):
            t = time.perf_counter()
            fn()
            self.step_s[kind].append(time.perf_counter() - t)

        def _prefill_group(self):
            self._timed("prefill", super()._prefill_group)

        def _decode(self):
            if self.profiled is None and not self.queue and all(
                    s is None or s.state == "decode" for s in self.slots):
                self.profiled = profile_ms(super()._decode,
                                           super()._decode)
                return
            self._timed("decode", super()._decode)

    return Recording


def profile_ms(fn, warm, margin_s: float = PROFILE_MARGIN_S):
    """``fn()`` under ``torch.profiler``, between two synchronises, after
    ``warm()`` in the profiler's warm-up step (tracing, its records
    dropped: a trace that starts with the call loses some of its first
    kernels), ``margin_s`` of host time between ``fn``'s launches and
    either edge of the recorded window: its wall ms (the profiler's own
    host cost included), the ms the card spent in kernels (``None`` where
    the profiler saw none), the four kernels that took most of it (name,
    ms, launches), and the launches the card ran of each wrapper's kernel
    in ``TRACE_KERNELS``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin_s)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        time.sleep(margin_s)
        prof.step()
    busy = kernel_device_us(prof)
    events = device_events(prof)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    seen = {k: sum(e.count for e in events if re.search(pattern, e.key))
            for k, pattern in TRACE_KERNELS.items()}
    return (1e3 * wall, busy / 1e3 if busy else None,
            [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
             for e in top], seen)


@contextlib.contextmanager
def record_shared_block(record: dict, kind: str):
    """While open, the first call of zamba's shared block at invocation 0
    is recorded in ``record[kind]``: its residual-stream input and
    keywords, the cache rows included (cloned), and its cfg and params
    (by reference)."""
    from repro_torch.models import zamba

    orig = zamba._shared_attn

    def recording(cfg, params, inv, x, **kw):
        if inv == 0 and kind not in record:
            record[kind] = (cfg, params, x.clone(), clone_tree(kw))
        return orig(cfg, params, inv, x, **kw)

    zamba._shared_attn = recording
    try:
        yield
    finally:
        zamba._shared_attn = orig


@contextlib.contextmanager
def record_router(layers: list):
    """While open, every MoE layer appends its routing to ``layers``, a
    dict per layer: ``ids`` (B, S, k), each token's top-k experts as the
    layer routed them (sorted); ``kept`` the same with each pair that
    the capacity dropped set to E; ``valid`` (B, S); ``margin``, the
    smallest top-k margin p_k - p_(k+1) of the router's probabilities
    over the valid tokens (from ``torch.softmax``: no kernel launch is
    counted); ``dropped``, the dropped (token, expert) pairs.  All stay
    on the card until the run has ended, so the timed launch takes no
    sync."""
    import torch

    from repro_torch.models import layers as L

    apply, experts = L.moe_apply, L._moe_experts_local

    def whole(t):   # a DTensor (path 16's mesh) gathered
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def recording_apply(cfg, p, x, **kw):
        b, s, _ = x.shape
        k = cfg.top_k
        probs = torch.softmax(whole(x).reshape(b * s, -1).float()
                              @ whole(p["router"]), -1)
        top = probs.topk(k + 1, dim=-1).values
        layers.append(dict(shape=(b, s, k), gap=top[:, k - 1] - top[:, k]))
        return apply(cfg, p, x, **kw)

    def recording_experts(cfg, w_in, w_gate, w_out, x_tokens, gates, ids,
                          capacity, valid=None, limit=None):
        t, k = ids.shape
        e = w_in.shape[0]
        ok = torch.ones(t, dtype=torch.bool, device=ids.device) \
            if valid is None else valid
        srt = ids.sort(-1).values
        flat = torch.where(ok[:, None], srt, e).reshape(-1)
        # a pair's slot: its place among its expert's pairs in flat
        # (token, choice) order, as the stable sort gives it
        hot = torch.nn.functional.one_hot(flat, e + 1)
        pos = (hot.cumsum(0) * hot).sum(-1).reshape(t, k) - 1
        keep = ok[:, None] & (pos < (capacity if limit is None else limit))
        rec = layers[-1]
        shape = rec.pop("shape")
        rec.update(ids=srt.reshape(shape), kept=torch.where(
            keep, srt, e).reshape(shape), valid=ok.reshape(shape[:2]),
            margin=torch.where(ok, rec.pop("gap"), float("inf")).min(),
            dropped=(ok[:, None] & ~keep).sum())
        return experts(cfg, w_in, w_gate, w_out, x_tokens, gates, ids,
                       capacity, valid, limit)

    L.moe_apply, L._moe_experts_local = recording_apply, recording_experts
    try:
        yield
    finally:
        L.moe_apply, L._moe_experts_local = apply, experts


def router_line(routes: list) -> str:
    """The recorded routing of each kind's first launch, per layer."""
    firsts = {}
    for kind, layers in routes:
        firsts.setdefault(kind, layers)
    out = []
    for kind, layers in firsts.items():
        margins = [float(f"{r['margin'].item():.2e}") for r in layers]
        dropped = [int(r["dropped"].item()) for r in layers]
        out.append(f"first {kind} launch: smallest top-k margin by layer "
                   f"{margins}, dropped (token, expert) pairs by layer "
                   f"{dropped}")
    return "; ".join(out)


def routing_parts(got, ref, rid: int):
    """The launches that gave request ``rid`` its first token, in two
    runs, compared layer by layer: the valid tokens whose top-k experts
    part, the valid tokens, and whether the last valid token of a row
    (whose state gives the first token) was routed or dropped apart.
    ``None`` where the two launches differ in kind or shape."""
    import torch

    kind_g, lay_g = got.routes[got.first_launch[rid]]
    kind_r, lay_r = ref.routes[ref.first_launch[rid]]
    if kind_g != kind_r or len(lay_g) != len(lay_r):
        return None
    out = []
    for g, r in zip(lay_g, lay_r):
        if g["ids"].shape != r["ids"].shape \
                or not bool((g["valid"] == r["valid"]).all()):
            return None
        valid = g["valid"]
        n = int(((g["ids"] != r["ids"]).any(-1) & valid).sum())
        last = (valid.sum(1) - 1).clamp(min=0)
        rows = torch.arange(valid.shape[0], device=valid.device)
        apart = (g["kept"][rows, last] != r["kept"][rows, last]).any(-1)
        out.append((n, int(valid.sum()),
                    bool((apart & valid.any(1)).any())))
    return out


def clone_tree(tree):
    """A copy of every tensor in nested dicts, lists and tuples (None
    stays None)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return None if tree is None else tree.clone()


def tree_leaves(tree, prefix: str = ""):
    """(dotted name, tensor) of every leaf of nested dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def serve_counters() -> dict:
    """The launch counters of every serve-path kernel, by name."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.layernorm import ops as ln
    from repro_torch.kernels.mamba2 import ops as ssd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.kernels.softmax import ops as sm

    return {"flash_attention": fa.LAUNCHES, "rmsnorm": rms.LAUNCHES,
            "layernorm": ln.LAUNCHES, "rwkv6": wkv.LAUNCHES,
            "mamba2": ssd.LAUNCHES, "masked_softmax": sm.LAUNCHES,
            # of flash attention's launches, the MLA forms'
            **{name: fa.FORM_LAUNCHES[form]
               for name, form in MLA_FORM_OF.items()}}


def path_launches(report: dict, path: str, dname: str) -> dict:
    """Every serve kernel's launches over the counted runs of ``path`` in
    ``dname`` (at every depth it ran)."""
    out = dict.fromkeys(serve_counters(), 0)
    for key, rep in report.items():
        if key[:2] == (path, dname):
            for k, n in rep["launches"].items():
                out[k] = out.get(k, 0) + n
    return out


def serve_run(model, params, cfg_kw: dict, requests: list, plain: bool,
              eager: bool = False, shared_block: bool = False,
              router: bool = False, profile: bool = False):
    """One engine over ``requests`` until done; returns the engine and the
    launches of every serve kernel in its run (counts set to 0 just
    before).  Its prefill and decode entries run as CUDA graphs, or with
    ``plain`` inside ``plain_versions()``, with ``eager`` inside
    ``eager_entries()`` (the kernels launched one by one: the Python hooks
    see every launch only there).  ``shared_block``: record the shared
    block's inputs in each kind's first launch; ``router``: its MoE
    routing; ``profile``: one decode step under ``torch.profiler``."""
    from repro_torch.core.graphs import eager_entries
    from repro_torch.kernels.select import plain_versions
    from repro_torch.serve.engine import ServeConfig

    eng = serve_engine_class()(model, params, ServeConfig(
        max_batch=SERVE_BATCH, max_seq=SERVE_SEQ, **cfg_kw),
        shared_block=shared_block, router=router, profile=profile)
    counters = serve_counters()
    for c in counters.values():
        c.reset()
    eng.t0 = time.perf_counter()
    eng.submit(requests)
    ctx = plain_versions() if plain else eager_entries() if eager \
        else contextlib.nullcontext()
    with ctx:
        eng.run_until_done()
    import torch
    torch.cuda.synchronize()
    return eng, {k: c.launches for k, c in counters.items()}


def rel_err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def compare_streams(tag: str, got, ref, tol: float, exact: bool,
                    held: bool = True, logits_held: bool = True) -> dict:
    """Per request: the token streams and the logits each token came
    from.  ``exact``: streams identical and every logits row within
    ``tol``.  Otherwise rows within ``tol`` while the streams agree, and a
    stream may part only where the reference's top-2 margin (relative to
    its max|logit|) is below ``tol``.  Without ``held`` the agreement is
    printed, not checked; without ``logits_held`` the rows' distance is
    printed, not checked.  Returns agreement lengths."""
    check_ = check if held else (lambda cond, msg: None)
    check_rows = check_ if logits_held else (lambda cond, msg: None)
    agree = {}
    worst = 0.0
    for rid, want in ref.done.items():
        have = got.done.get(rid)
        check(have is not None, f"{tag} request {rid} did not complete")
        n = 0
        while n < min(len(have), len(want)) and have[n] == want[n]:
            n += 1
        agree[rid] = n
        if exact:
            check_(have == want, f"{tag} request {rid}: streams part at "
                                f"token {n}: {have[n:n + 3]} vs "
                                f"{want[n:n + 3]}")
        for t in range(min(n + 1, len(have), len(want))):
            a, b = got.logits[(rid, t)], ref.logits[(rid, t)]
            e = rel_err(a, b)
            worst = max(worst, e)
            check_rows(e <= tol, f"{tag} request {rid} token {t}: logits "
                                f"max|d|/max|ref| {e:.3e} > {tol}")
        if n < min(len(have), len(want)):
            b = ref.logits[(rid, n)]
            top = b.topk(2).values
            margin = ((top[0] - top[1]) / b.abs().max()).item()
            check_(margin < tol, f"{tag} request {rid} parts at token {n} "
                                f"where the reference's top-2 margin is "
                                f"{margin:.3e} >= {tol}")
    print(f"{tag} agreement lengths {agree} of "
          f"{ {r: len(v) for r, v in ref.done.items()} }; worst logits "
          f"rel {worst:.3e}"
          f"{'' if held and logits_held else ' (printed, not held)'}",
          flush=True)
    return agree


def cache_check(tag: str, eng, dname: str, held: dict,
                kinds=("prefill", "decode")) -> None:
    """The first launch of each of ``kinds`` in a run (its first prefill
    launch and first decode step; ``"prefill_cont"``: its first prefill
    launch continuing a prompt), replayed on the same inputs with the
    plain versions: per cache leaf and layer, max|d|/max|ref| (0 where
    both are 0).  The first ``CACHE_CHECK_LAYERS`` layers are held to
    ``TOL_SERVE_KERNEL`` (``held[leaf]``, where given: (layers, limit));
    every layer's is printed, to show how depth amplifies the
    difference."""
    from repro_torch.kernels.select import plain_versions

    tol = TOL_SERVE_KERNEL[dname]
    failed = []
    for kind in kinds:
        fn, params, args, got = eng.first[kind]
        with plain_versions():
            _, want = fn(params, *clone_tree(args))
        for (name, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
            errs = []
            for gl, wl in zip(g.float(), w.float()):
                d, m = (gl - wl).abs().max().item(), wl.abs().max().item()
                errs.append(d / m if m else d)
            print(f"{tag} first {kind} launch, kernels vs plain on its "
                  f"inputs: {name} max|d|/max|ref| by layer "
                  f"{[float(f'{e:.2e}') for e in errs]}", flush=True)
            n_held, limit = held.get(name, (CACHE_CHECK_LAYERS, tol))
            if not all(e <= limit for e in errs[:n_held]):
                failed.append(f"{kind} {name} of its first {n_held} "
                              f"layers {errs[:n_held]} > {limit}")
    check(not failed, f"{tag} first launches, max|d|/max|ref|: "
                      f"{'; '.join(failed)}")


def shared_block_check(tag: str, eng, dname: str, kinds) -> None:
    """Zamba's shared attention block at invocation 0, replayed alone on
    the residual-stream input and cache rows that the first launch of
    each of ``kinds`` gave it, with the kernels (its RMSNorm and flash
    attention) and with the plain versions: its residual delta and the
    K/V it writes, max|d|/max|ref| within ``TOL_SERVE_KERNEL``.  This
    holds the attention output at the served shapes before any later
    layer amplifies a difference."""
    from repro_torch.kernels.select import plain_versions
    from repro_torch.models import zamba

    tol = TOL_SERVE_KERNEL[dname]
    failed = []
    for kind in kinds:
        cfg, params, x, kw = eng.block[kind]
        a, c = zamba._shared_attn(cfg, params, 0, x, **clone_tree(kw))
        with plain_versions():
            a_p, c_p = zamba._shared_attn(cfg, params, 0, x,
                                          **clone_tree(kw))
        errs = {"delta": rel_err(a.float(), a_p.float()),
                **{k: rel_err(c[k].float(), c_p[k].float()) for k in c}}
        print(f"{tag} shared block invocation 0 of the first {kind} "
              f"launch (x {tuple(x.shape)}), kernels vs plain on its "
              f"inputs: max|d|/max|ref| "
              f"{ {k: float(f'{e:.2e}') for k, e in errs.items()} }",
              flush=True)
        failed += [f"{kind} {k} {e:.3e}" for k, e in errs.items()
                   if not e <= tol]
    check(not failed, f"{tag} shared block, max|d|/max|ref| > {tol}: "
                      f"{'; '.join(failed)}")


def serve_phase(path: str, dname: str, seed: int, report: dict,
                accuracy_ref=None, layers=None,
                labels=("kernels", "plain", "chunked"),
                capacity_factor=None):
    """A serve path (3: TinyLlama, 4: RWKV-6 3B, 5: Zamba2-7B, 6: DBRX) in
    one dtype: the runs of ``labels`` (kernels and chunked as CUDA graphs,
    plain versions, and the kernels launched one by one under
    ``eager_entries()``: "eager", "eager chunked"), at ``layers`` (None:
    the config's depth) and ``capacity_factor`` (None: the config's).
    With ``accuracy_ref`` (each request's first-token logits from an f32
    run over the same weights), kernels vs plain is the accuracy check of
    :func:`accuracy_check` instead of the stream rules.  Each engine's
    cache and graphs are freed after its run; at the end
    the phase's objects are deleted and the card's allocated memory must
    be back within ``MEM_SLACK_BYTES`` of its value before the phase,
    with no gc pass.  Returns the config, the decode fills of the first
    four requests, and the kernels run's first-token logits."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Request
    from repro_torch.models.registry import get_model

    mem0 = torch.cuda.memory_allocated()
    sp = SERVE_PATHS[path]
    cfg = dataclasses.replace(get_config(sp.arch), dtype=dname)
    tag = f"[{path} {dname}]"
    if layers is not None:   # the depth joins the tag
        cfg = dataclasses.replace(cfg, n_layers=layers)
        tag = f"[{path} {dname} {layers}L]"
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        tag = f"{tag[:-1]} cf {capacity_factor}]"
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wcfg = dataclasses.replace(cfg, dtype="bf16") if sp.bf16_weights else cfg
    params = get_model(wcfg).init(gen, "cuda")
    if "lora" in params:
        # the reference's zero b_q would hide a dropped LoRA delta
        b_q = params["lora"]["b_q"]
        params["lora"]["b_q"] = (0.1 * torch.randn(
            b_q.shape, generator=gen, device="cuda")).to(b_q.dtype)
    if wcfg.dtype != dname:
        upcast_in_place(params)
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def requests():
        return [Request(rid=i, tokens=p, max_new_tokens=SERVE_NEW_TOKENS)
                for i, p in enumerate(prompts)]

    launches = dict.fromkeys(serve_counters(), 0)
    runs = {}
    chunk = {"prefill_chunk": SERVE_CHUNK}
    # label -> (engine options, plain versions, eager entries); the other
    # runs' entries are CUDA graphs
    settings = {"kernels": ({}, False, False), "plain": ({}, True, False),
                "chunked": (chunk, False, False),
                "paged": ({"kv_block_size": PATH14_BLOCK}, False, False),
                "eager": ({}, False, True),
                "eager chunked": (chunk, False, True)}
    for label in labels:
        kw, plain, eager = settings[label]
        # the Python hooks see an entry's first call and its capture pass,
        # never a replay: they record only where every launch runs its
        # Python
        eng, counted = serve_run(
            model, params, kw, requests(), plain, eager,
            shared_block=sp.shared_block and eager,
            router=sp.router and (plain or eager),
            profile=path in PROFILED_PATHS and label in ("kernels", "eager"))
        runs[label] = eng
        st = eng.stats
        steps = st["prefill_calls"] + st["decode_steps"]
        cc = eng.compile_counts()
        print(f"{tag} {label}: prefill_calls={st['prefill_calls']} "
              f"decode_steps={st['decode_steps']} "
              f"tokens={st['tokens_generated']} "
              f"bucket_pairs={sorted(eng._bucket_pairs)} compiles={cc} "
              f"launches={counted}", flush=True)
        graph_line(f"{tag} {label}", eng, graphed=not (plain or eager))
        # the logits and first launches stay on record; the cache and the
        # graphs (their inputs, outputs and pool: ~18 GB at 81 layers) leave
        # the card before the next run (a later plain call of the engine's
        # artifacts compiles an entry again, which runs eagerly there)
        for fn in (eng._prefill_fn, eng._decode_fn):
            eng.compile_cache.drop_fingerprint(fn._fingerprint)
        eng.cache = eng.pool = None
        torch.cuda.empty_cache()
        if eng.routes is not None:
            print(f"{tag} {label}: {router_line(eng.routes)}", flush=True)
        check(len(eng.done) == len(SERVE_PROMPTS) and not eng.failed,
              f"{tag} {label}: {len(eng.done)} done, failed {eng.failed}")
        check(cc["prefill"]["total"] == len(eng._bucket_pairs)
              == st["prefill_bucket_pairs"],
              f"{tag} {label}: {cc['prefill']} prefill compiles for "
              f"{len(eng._bucket_pairs)} (B, S) buckets")
        check(cc["decode"]["total"] == 1,
              f"{tag} {label}: {cc['decode']} decode compiles")
        if plain:
            check(not any(counted.values()),
                  f"{tag} plain run launched kernels: {counted}")
            continue
        want = dict.fromkeys(counted, 0)
        want.update({k: n * steps
                     for k, n in sp.per_step(cfg.n_layers).items()})
        want.update(sp.forms(cfg.n_layers, st["prefill_calls"],
                             st["decode_steps"]))
        check(counted == want, f"{tag} {label}: launches {counted}, the "
                               f"path predicts {want}")
        if not eager:   # the main path's launches: its graph replays
            for k in launches:
                launches[k] += counted[k]
        ttft = [round(eng.arrived[r], 4) for r in range(len(SERVE_PROMPTS))]
        dec = eng.step_s["decode"]
        print(f"{tag} {label}: time to first token s {ttft}; decode "
              f"ms/step mean {1e3 * sum(dec) / len(dec):.2f} median "
              f"{1e3 * sorted(dec)[len(dec) // 2]:.2f} "
              f"min {1e3 * min(dec):.2f} max {1e3 * max(dec):.2f} over "
              f"{len(dec)} steps; prefill s "
              f"{[round(x, 4) for x in eng.step_s['prefill']]}",
              flush=True)
        if eng.profiled:
            wall, busy, top, seen = eng.profiled
            share = "not measured" if busy is None else \
                f"{1 - busy / wall:.3f}"
            print(f"{tag} {label}: one decode step under torch.profiler: "
                  f"wall {wall:.3f} ms, device busy "
                  f"{'not measured' if busy is None else f'{busy:.3f}'} "
                  f"ms, idle share {share}; most device time (kernel, ms, "
                  f"launches): {top}", flush=True)
            # the port's kernels as the card ran them in that step, held
            # to the path's count: in a graphed run the launch counters
            # add what the capture counted, the trace sees the replay
            step = sp.per_step(cfg.n_layers)
            if busy is not None:
                ran = {k: seen[k] for k in step}
                check(ran == step, f"{tag} {label}: the profiled decode "
                                   f"step ran {ran}, the path predicts "
                                   f"{step}")
                print(f"{tag} {label}: the profiled decode step ran the "
                      f"port's kernels {ran} (the path's count)", flush=True)
        for rid, toks in eng.done.items():
            # 16 new tokens after the prompt's first, or fewer up to EOS
            check(all(0 <= t < cfg.vocab for t in toks)
                  and (len(toks) == SERVE_NEW_TOKENS + 1
                       or toks[-1] == eng.scfg.eos_id),
                  f"{tag} {label} request {rid}: tokens {toks}")
        check(all(bool(torch.isfinite(x).all())
                  for x in eng.logits.values()),
              f"{tag} {label}: non-finite logits")
    held = sp.held.get(dname, {})
    cache_check(f"{tag} kernels", runs["kernels"], dname, held)
    if "chunked" in runs:
        cache_check(f"{tag} chunked", runs["chunked"], dname, held,
                    kinds=("prefill_cont",))
    if sp.shared_block:
        shared_block_check(f"{tag} eager", runs["eager"], dname,
                           ("prefill", "decode"))
        shared_block_check(f"{tag} eager chunked", runs["eager chunked"],
                           dname, ("prefill_cont",))
    for graphed, eager in (("kernels", "eager"),
                           ("chunked", "eager chunked")):
        if eager in runs:
            graphs_vs_eager(f"{tag} {graphed} vs {eager}", runs[graphed],
                            runs[eager], dname)
    tol = TOL_SERVE[dname]
    exact = dname == "f32"
    parts = dname == "bf16" and sp.bf16_chunked_parts
    if "plain" in runs and accuracy_ref is None:
        compare_streams(f"{tag} kernels vs plain", runs["kernels"],
                        runs["plain"], tol, exact)
    elif "plain" in runs:
        accuracy_check(f"{tag} kernels vs plain", runs, accuracy_ref)
        if sp.bf16_streams:
            compare_streams(f"{tag} kernels vs plain", runs["kernels"],
                            runs["plain"], tol, exact, logits_held=False)
        if parts and "chunked" in runs:
            accuracy_check(f"{tag} chunked vs plain", runs, accuracy_ref,
                           label="chunked", held=False)
    if "chunked" in runs:
        compare_streams(f"{tag} chunked vs unchunked", runs["chunked"],
                        runs["kernels"], tol, exact, held=not parts)
    if "paged" in runs:
        # the paged pool gathers the same rows into the same graphs
        check(runs["paged"].done == runs["kernels"].done,
              f"{tag} paged: streams part from the fixed rows': "
              f"{runs['paged'].done} vs {runs['kernels'].done}")
        print(f"{tag} paged vs fixed rows: streams identical; "
              f"kv_preemptions {runs['paged'].stats['kv_preemptions']}, "
              f"kv_peak_occupancy "
              f"{runs['paged'].stats['kv_peak_occupancy']}", flush=True)
    report[(path, dname, cfg.n_layers)] = dict(launches=launches)
    fills = [n + SERVE_NEW_TOKENS // 2 for n in SERVE_PROMPTS[:SERVE_BATCH]]
    first = {rid: runs["kernels"].logits[(rid, 0)]
             for rid in runs["kernels"].done}
    # the engines, their recorded launches and the weights leave the card
    # as soon as they are deleted: no gc pass
    del runs, eng, params
    mem = torch.cuda.memory_allocated()
    print(f"{tag} card memory allocated: {mem0} B before the phase, {mem} "
          f"B after its objects were deleted", flush=True)
    check(mem <= mem0 + MEM_SLACK_BYTES,
          f"{tag} {mem - mem0} B still allocated after the phase")
    torch.cuda.empty_cache()
    return cfg, fills, first


def graph_line(tag: str, eng, graphed: bool) -> None:
    """A run's graph entries: in a graphed run captures == compiles, every
    prefill launch and decode step after an entry's first (which runs
    eagerly and is then captured) a replay, and a decode step copies at
    most ``DECODE_COPY_BYTES`` into its graph (the cache stays in place);
    its prefill copies, capture seconds, the entries' input buffers and
    pool bytes are printed.  Other runs capture nothing."""
    import torch

    pre, dec = eng._prefill_fn.graph_stats, eng._decode_fn.graph_stats
    if not graphed:
        check(pre.captures == dec.captures == 0,
              f"{tag}: captured outside the graphed runs")
        return
    cc, st = eng.compile_counts(), eng.stats
    check(pre.captures == cc["prefill"]["total"]
          and dec.captures == cc["decode"]["total"],
          f"{tag}: captures {pre.captures} / {dec.captures}, compiles {cc}")
    check(pre.replays + pre.captures == st["prefill_calls"]
          and dec.replays + dec.captures == st["decode_steps"],
          f"{tag}: replays {pre.replays} / {dec.replays} and captures for "
          f"{st['prefill_calls']} prefill launches and "
          f"{st['decode_steps']} decode steps")
    per_step = dec.bytes_in / st["decode_steps"]
    limit = DECODE_COPY_BYTES + (eng.alloc.table().nbytes if eng.paged
                                 else 0)
    check(per_step <= limit,
          f"{tag}: a decode step copies {per_step:.0f} B into its graph")
    print(f"{tag}: graphs: captures prefill {pre.captures} decode "
          f"{dec.captures} (== compiles); replays prefill {pre.replays} "
          f"decode {dec.replays}; decode bytes copied a step in "
          f"{per_step:.0f} out "
          f"{dec.bytes_out / max(dec.replays, 1):.0f}; prefill "
          f"bytes copied in {pre.bytes_in} out {pre.bytes_out}; capture s "
          f"prefill {[round(x, 3) for x in pre.capture_seconds]} decode "
          f"{[round(x, 3) for x in dec.capture_seconds]}; input buffers "
          f"{pre.buffer_bytes + dec.buffer_bytes} B; pool reserved "
          f"{eng.compile_cache.graph_pool.reserved_bytes} B; card memory "
          f"allocated {torch.cuda.memory_allocated()} B", flush=True)


def graphs_vs_eager(tag: str, got, ref, dname: str) -> None:
    """A graphed run against the same engine under ``eager_entries()``
    (the same kernels launched one by one): identical token streams, and
    in f32 each request's first-token logits within ``TOL_GRAPHS`` of
    max|ref| (bf16: printed); every token's distance printed."""
    check(got.done == ref.done,
          f"{tag}: streams part: {got.done} vs {ref.done}")
    first = max(rel_err(got.logits[(r, 0)], ref.logits[(r, 0)])
                for r in ref.done)
    worst = max(rel_err(got.logits[k], ref.logits[k]) for k in ref.logits)
    print(f"{tag}: streams identical; first-token logits max|d|/max|ref| "
          f"{first:.3e}, every token's {worst:.3e}"
          f"{'' if dname == 'f32' else ' (printed, not held)'}", flush=True)
    if dname == "f32":
        check(first <= TOL_GRAPHS, f"{tag}: first-token logits "
                                   f"{first:.3e} > {TOL_GRAPHS}")


def accuracy_check(tag: str, runs: dict, ref: dict,
                   label: str = "kernels", held: bool = True) -> None:
    """bf16 kernels vs plain versions where two bf16 evaluations of the
    model part too far for the stream rules (RWKV-6 3B and Zamba2-7B
    with random weights: PERF.md, PRs 14-15): each request's first-token
    logits, from the ``label`` run (the kernels run, or the chunked one)
    and from the plain run, against ``ref``, the f32 run over the same
    weights.  The ``label`` run's may lie at most ``ACCURACY_RATIO``
    times as far from it as the plain versions' do, the rule paths 1-2
    hold their bf16 outputs to (printed, not checked, without
    ``held``).  For a MoE (the runs recorded their routing), a request
    whose last prompt token, the state its first token comes from, is
    routed to another expert set or dropped from another expert in the
    two runs, in any layer, is printed, not held: the output is
    discontinuous where a near-tie of the router swaps, and which of two
    equally exact evaluations swaps it like the f32 run is chance
    (PERF.md §6).  A near-tie moves a few tokens; more than
    ``ROUTE_PART_FRACTION`` of a launch's valid tokens routed apart in
    one layer fails.  A graphed run's routing is its eager twin's (the
    hooks see no replay), whose streams :func:`graphs_vs_eager` holds
    equal."""
    failed = []
    for rid, want in sorted(ref.items()):
        got, plain = (runs[k].logits[(rid, 0)] for k in (label, "plain"))
        e_k, e_p = rel_err(got, want), rel_err(plain, want)
        note = "" if held else ", printed, not held"
        bad = held and e_k > ACCURACY_RATIO * e_p
        routed = runs.get(EAGER_TWIN[label], runs[label])
        if routed.routes is not None:
            parts = routing_parts(routed, runs["plain"], rid)
            note = f"; routing by layer (tokens apart, valid, last token " \
                   f"apart) {parts}"
            if parts is None or any(last for _, _, last in parts):
                note += ", printed, not held"
                bad = False
            for n, v, _ in parts or ():
                if n > max(ROUTE_PART_FLOOR, ROUTE_PART_FRACTION * v):
                    failed.append(f"request {rid}: {n} of {v} tokens "
                                  f"routed apart in one layer")
        print(f"{tag} request {rid}: first-token logits vs f32 "
              f"max|d|/max|ref| {label} {e_k:.3e} plain {e_p:.3e} "
              f"({label} vs plain {rel_err(got, plain):.3e}; ratio "
              f"{e_k / e_p:.3f}{note})", flush=True)
        if bad:
            failed.append(f"request {rid}: {label} {e_k:.3e}, plain "
                          f"{e_p:.3e}")
    check(not failed,
          f"{tag}: from f32, more than {ACCURACY_RATIO} x the plain "
          f"versions' or routed apart: {'; '.join(failed)}")


def attention_bound(q_shape, kv_rows: int, hkv: int, pairs: int, elt: int,
                    dname: str):
    """(bound_ms, bound_by, bytes, flops) of one attention call: q and o
    once, the K and V rows the call needs once; 4 * hd flops per visible
    (query, key) pair and head (q.k and p.v)."""
    b, h, sq, hd = q_shape
    nbytes = (2 * b * h * sq * hd + 2 * kv_rows * hkv * hd) * elt
    flops = 4 * hd * h * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (F32_FLOPS if dname == "f32" else BF16_FLOPS) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def flash_resources() -> str:
    """``cuda_build.resources`` of the flash-attention library, as one
    JSON object; printed, not checked."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention.flash_attention import \
        source_job

    return json.dumps(cuda_build.resources(source_job()))


def ffma_register_cap(kname: str) -> int:
    """The registers a thread of the f32 instance ``gemm_kernel<BM, BN,
    BK, TM, TN, STAGES, MINB, VEC>`` may use under its launch bound:
    65536 / (threads x MINB), in steps of 8, at most 255."""
    import re

    # cu++filt writes each argument as "(int)128"
    bm, bn, _, tm, tn, _, minb = (
        int(x) for x in re.findall(r"\d+", kname[kname.index("<"):])[:7])
    threads = (bm // tm) * (bn // tn)
    return min(255, 65536 // (threads * minb) // 8 * 8)


def gemm_resources(jobs: list) -> str:
    """``cuda_build.resources`` of every GEMM library the run built, as
    one JSON object.  Checks that every 16-bit instance (the wgmma body)
    runs HGMMA and no HMMA and uses no local memory, and that every f32
    instance (the FFMA body, both of a tile's instances) runs FFMA and
    no HMMA or HGMMA, uses no local memory and keeps its registers within
    its launch bound."""
    from repro_torch.kernels import cuda_build

    res = {}
    for job in jobs:
        res[job[0]] = inst = cuda_build.resources(job)
        ffma = 0
        for kname, r in inst.items():
            if "gemm_wgmma_kernel" in kname:
                check(r["hgmma"] > 0 and r["hmma"] == 0 and r["local"] == 0,
                      f"GEMM instance {job[0]} {kname}: {r}")
            elif kname.startswith("gemm_kernel<"):
                ffma += 1
                check(r["ffma"] > 0 and r["hmma"] == 0 and r["hgmma"] == 0
                      and r["local"] == 0
                      and r["reg"] <= ffma_register_cap(kname),
                      f"GEMM instance {job[0]} {kname}: {r}, registers "
                      f"capped at {ffma_register_cap(kname)}")
        check(ffma > 0 or "_float32_" not in job[0],
              f"GEMM library {job[0]}: no f32 instance in {sorted(inst)}")
    return json.dumps(res)


def serve_kernel_phase(cfg, dname: str, fills, report: dict, rows: list,
                       path: str = "path3",
                       forms=("prefill", "chunk", "decode")):
    """Flash attention (at ``cfg``'s heads, the cases of ``forms``) and the
    config's norm (RMSNorm or LayerNorm, at its width) at the serve path's
    shapes, each against its plain version on the same card inputs, timed
    against the plain version and a PyTorch library call."""
    import torch
    import torch.nn.functional as F

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(17)
    launches = path_launches(report, path, dname)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def token_major_q(b, s):  # the path's q: a (B, H, S, hd) view
        return rnd(b, s, h, hd).transpose(1, 2)

    s_max = SERVE_SEQ
    cases = []
    # prefill B=1, S=2048 at q_offset 0 (bucket 2048, causal over the
    # cache); a second, padded batch row (zero q and cache, as the
    # dispatch pads a bucket) must give 0
    q = token_major_q(2, s_max)
    k, v = rnd(2, hkv, s_max, hd), rnd(2, hkv, s_max, hd)
    q[1].zero_()
    k[1].zero_()
    v[1].zero_()
    causal_mask = torch.ones(s_max, s_max, dtype=torch.bool,
                             device="cuda").tril()
    cases.append(dict(
        form="prefill",
        label=f"prefill S={s_max} q_offset=0", q=q[:1], k=k[:1], v=v[:1],
        args=dict(lens=None, causal=True, q_offset=0), kv_rows=s_max,
        pairs=s_max * (s_max + 1) // 2,
        lib=lambda q=q[:1], k=k[:1], v=v[:1]: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        zero_check=(q, k, v, dict(lens=None, causal=True, q_offset=0),
                    [1])))
    # a 512-row chunk at q_offset 1024 against the 2048-row cache; a
    # second row with lens 0 is fully masked and must give 0
    off = s_max // 2
    q = token_major_q(2, SERVE_CHUNK)
    k, v = rnd(2, hkv, s_max, hd), rnd(2, hkv, s_max, hd)
    qo = torch.tensor([off, off], dtype=torch.int32, device="cuda")
    keys = torch.arange(s_max, device="cuda")[None, :]
    chunk_mask = keys <= (off + torch.arange(SERVE_CHUNK, device="cuda"))[
        :, None]
    cases.append(dict(
        form="chunk",
        label=f"prefill chunk S={SERVE_CHUNK} q_offset={off}", q=q[:1],
        k=k[:1], v=v[:1], args=dict(lens=None, causal=True, q_offset=qo[:1]),
        kv_rows=off + SERVE_CHUNK,
        pairs=sum(off + i + 1 for i in range(SERVE_CHUNK)),
        lib=lambda q=q[:1], k=k[:1], v=v[:1]: F.scaled_dot_product_attention(
            q, k, v, attn_mask=chunk_mask, enable_gqa=True),
        zero_check=(q, k, v, dict(lens=torch.tensor(
            [s_max, 0], dtype=torch.int32, device="cuda"), causal=True,
            q_offset=qo), [1])))
    # decode B=4 at the requests' fills (+1: the token being written)
    lens = torch.tensor([f + 1 for f in fills], dtype=torch.int32,
                        device="cuda")
    q = rnd(SERVE_BATCH, 1, h, hd).transpose(1, 2)
    k, v = (rnd(SERVE_BATCH, hkv, s_max, hd) for _ in range(2))
    dec_mask = (keys < lens[:, None])[:, None, None, :]
    cases.append(dict(
        form="decode",
        label=f"decode B={SERVE_BATCH} lens={lens.tolist()}", q=q, k=k, v=v,
        args=dict(lens=lens), decode=True, kv_rows=int(lens.sum()),
        pairs=int(lens.sum()),
        lib=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=dec_mask, enable_gqa=True),
        zero_check=(q, k, v, dict(lens=torch.tensor(
            [5, 0, 9, 0], dtype=torch.int32, device="cuda")), [1, 3])))
    flash_rows([c for c in cases if c["form"] in forms], dname, hkv,
               launches["flash_attention"], rows)
    # the norm over the rows of a 2048-token prefill and of a decode step
    # at B = 4, at the model's width
    norm_kernel_rows(cfg.norm, cfg.d_model, dname, gen, launches[cfg.norm],
                     rows)


def flash_rows(cases: list, dname: str, hkv: int, launches: int,
               rows: list) -> None:
    """Each flash-attention case (q, k, v, the wrapper's arguments, the
    K / V rows and (query, key) pairs its bound counts, its library call)
    against its plain version on the same card inputs; the rows of
    ``zero_check``'s call (padded with zeros, or with ``lens`` 0) must be
    exactly 0.  Timed against the plain version and the library call."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.select import plain_versions

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    elt = torch.empty((), dtype=dt).element_size()
    tol = TOL_SERVE_KERNEL[dname]
    for c in cases:
        if c.get("decode"):
            def run(c=c):
                return fa.flash_decode(c["q"], c["k"], c["v"],
                                       c["args"]["lens"])
        else:
            def run(c=c):
                return fa.flash_attention(c["q"], c["k"], c["v"],
                                          **c["args"])

        def plain(run=run):
            with plain_versions():
                return run()

        before = fa.LAUNCHES.launches
        got = run()
        check(fa.LAUNCHES.launches == before + 1,
              "flash attention wrapper launched no kernel")
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"flash_attention {dname} {c['label']}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        rel = err / scale
        zq, zk, zv, zargs, zrows = c["zero_check"]
        if c.get("decode"):
            zo = fa.flash_decode(zq, zk, zv, zargs["lens"])
        else:
            zo = fa.flash_attention(zq, zk, zv, **zargs)
        zero_ok = all(not zo[i].any() for i in zrows) \
            and bool(torch.isfinite(zo).all())
        ms = cuda_ms(run)
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(c["lib"])
        lib_err = rel_err(c["lib"]().float(), want.float())
        bound_ms, bound_by, nbytes, flops = attention_bound(
            tuple(c["q"].shape), c["kv_rows"], hkv, c["pairs"], elt, dname)
        row = dict(name="flash_attention", **KERNELS["flash_attention"],
                   launches=launches, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib_ms)
        detail = dict(dtype=dname,
                      case=f"{c['label']} hd={c['q'].shape[-1]}",
                      max_ref=scale, max_rel=rel, bytes=nbytes,
                      flops=flops, tflops=flops / ms / 1e9,
                      library_ratio=ms / lib_ms,
                      path_launches_of_program=launches,
                      library_call="F.scaled_dot_product_attention",
                      library_max_rel=lib_err, zero_rows_ok=zero_ok)
        if c.get("decode"):   # the split-key grid's plan for this cache
            detail["n_split"] = fa.decode_splits(
                c["k"].shape[2], c["k"].shape[0], hkv,
                torch.cuda.get_device_properties(0).multi_processor_count)[0]
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(rel <= tol, f"flash_attention {dname} {c['label']}: "
                          f"max|d|/max|ref| {rel:.3e} > {tol}")
        check(zero_ok, f"flash_attention {dname} {c['label']}: padded or "
                       f"fully masked rows not 0")
        rows.append((row, detail))


def mla_kernel_phase(cfg, dname: str, fills, report: dict, rows: list):
    """Flash attention's MLA forms at DeepSeek-V2's widths (128 heads, q/k
    192, v 128; the latent 512 + 64), each against its plain version on
    the same card inputs and timed (L2 flushed) beside it and
    ``F.scaled_dot_product_attention`` at the same scale: the (192, 128)
    instance's causal prefill at S = 2048 (B = 1) and a 512-row chunk at
    ``q_offset`` 1024 against the 2048-row cache, then the absorbed
    decode at B = 4 at the path's decode fills over a 2048-row latent
    (the library call over the concatenated latent as one kv head).
    Bounds: prefill ``2 (192 + 128) H`` flops a visible (query, key) pair
    over the dtype's tensor-core peak, or q, o, K and V once over the HBM
    rate; the decode the latent's valid rows (and q, o) once over the HBM
    rate, or ``2 H (576 + 512)`` flops a valid key over the card's peak
    for the inputs' type (f32 FFMA; bf16 tensor cores), whatever unit the
    body runs on."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.select import plain_versions

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    elt = torch.empty((), dtype=dt).element_size()
    h, hd, rdim, lat = cfg.n_heads, cfg.hd, cfg.mla_rope_dim, cfg.mla_kv_lora
    dqk = hd + rdim
    scale = 1.0 / math.sqrt(dqk)
    tol = TOL_SERVE_KERNEL[dname]
    launches = path_launches(report, "path12", dname)
    gen = torch.Generator(device="cuda").manual_seed(28)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    s_max, off = SERVE_SEQ, SERVE_SEQ // 2
    cases = []
    # the model's layouts: q_eff, k_eff and v token-major, (B, H, S, d)
    # views
    q = rnd(1, s_max, h, dqk).transpose(1, 2)
    k = rnd(1, s_max, h, dqk).transpose(1, 2)
    v = rnd(1, s_max, h, hd).transpose(1, 2)
    pairs = s_max * (s_max + 1) // 2
    cases.append(dict(
        name="flash_attention_mla", label=f"mla prefill S={s_max} q_offset=0",
        run=lambda: fa.flash_attention(q, k, v, None, causal=True,
                                       scale=scale),
        lib=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   scale=scale),
        nbytes=(2 * s_max * h * dqk + 2 * s_max * h * hd) * elt,
        flops=2 * (dqk + hd) * h * pairs,
        peak=F32_FLOPS if dname == "f32" else BF16_FLOPS))
    qc = rnd(1, SERVE_CHUNK, h, dqk).transpose(1, 2)
    qo = torch.tensor([off], dtype=torch.int32, device="cuda")
    keys = torch.arange(s_max, device="cuda")[None, :]
    chunk_mask = keys <= (off + torch.arange(SERVE_CHUNK, device="cuda"))[
        :, None]
    pairs = sum(off + i + 1 for i in range(SERVE_CHUNK))
    cases.append(dict(
        name="flash_attention_mla",
        label=f"mla prefill chunk S={SERVE_CHUNK} q_offset={off}",
        run=lambda: fa.flash_attention(qc, k, v, None, causal=True,
                                       q_offset=qo, scale=scale),
        lib=lambda: F.scaled_dot_product_attention(
            qc, k, v, attn_mask=chunk_mask, scale=scale),
        nbytes=(SERVE_CHUNK * h * (dqk + hd)
                + (off + SERVE_CHUNK) * h * (dqk + hd)) * elt,
        flops=2 * (dqk + hd) * h * pairs,
        peak=F32_FLOPS if dname == "f32" else BF16_FLOPS))
    # the absorbed decode: q_abs, q_pe (B, 1, H, .) and the cache's leaves
    # as layer slices of a stacked cache
    lens = torch.tensor([f + 1 for f in fills], dtype=torch.int32,
                        device="cuda")
    q_abs, q_pe = rnd(SERVE_BATCH, 1, h, lat), rnd(SERVE_BATCH, 1, h, rdim)
    kv_c = rnd(2, SERVE_BATCH, s_max, lat)[1]
    k_pe = rnd(2, SERVE_BATCH, s_max, rdim)[1]
    q_cat = torch.cat([q_abs, q_pe], -1).transpose(1, 2)    # (B, H, 1, 576)
    k_cat = torch.cat([kv_c, k_pe], -1)[:, None]            # (B, 1, S, 576)
    dec_mask = (keys < lens[:, None])[:, None, None, :]
    n_keys = int(lens.sum())
    cases.append(dict(
        name="flash_attention_mla_decode",
        label=f"mla decode B={SERVE_BATCH} lens={lens.tolist()}",
        run=lambda: fa.mla_decode(q_abs, q_pe, kv_c, k_pe, lens, scale),
        lib=lambda: F.scaled_dot_product_attention(
            q_cat, k_cat, kv_c[:, None], attn_mask=dec_mask, scale=scale,
            enable_gqa=True).transpose(1, 2),
        nbytes=(n_keys * (lat + rdim)
                + SERVE_BATCH * h * (2 * lat + rdim)) * elt,
        flops=2 * h * (lat + rdim + lat) * n_keys,
        peak=F32_FLOPS if dname == "f32" else BF16_FLOPS,
        split=fa.decode_splits(
            s_max, SERVE_BATCH, 1,
            torch.cuda.get_device_properties(0).multi_processor_count)[0]))
    for c in cases:
        def plain(c=c):
            with plain_versions():
                return c["run"]()

        before = fa.FORM_LAUNCHES[MLA_FORM_OF[c["name"]]].launches
        got = c["run"]()
        check(fa.FORM_LAUNCHES[MLA_FORM_OF[c["name"]]].launches
              == before + 1, f"{c['name']}: the wrapper launched no kernel")
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"{c['name']} {dname} {c['label']}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        scale_ref = want.float().abs().max().item()
        rel = err / scale_ref
        ms, plain_ms, lib_ms = cuda_ms(c["run"]), cuda_ms(plain), \
            cuda_ms(c["lib"])
        lib_err = rel_err(c["lib"]().float(), want.float())
        bytes_ms = c["nbytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["flops"] / c["peak"] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        row = dict(name=c["name"], **KERNELS["flash_attention"],
                   launches=launches[c["name"]], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib_ms)
        detail = dict(dtype=dname, case=c["label"], max_ref=scale_ref,
                      max_rel=rel, bytes=c["nbytes"], flops=c["flops"],
                      tflops=c["flops"] / ms / 1e9,
                      library_ratio=ms / lib_ms,
                      path_launches_of_program=launches[c["name"]],
                      library_call="F.scaled_dot_product_attention",
                      library_max_rel=lib_err)
        if "split" in c:
            detail["n_split"] = c["split"]
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(rel <= tol, f"{c['name']} {dname} {c['label']}: "
                          f"max|d|/max|ref| {rel:.3e} > {tol}")
        rows.append((row, detail))


def norm_kernel_rows(kind: str, d: int, dname: str, gen, launches: int,
                     rows: list):
    """RMSNorm (``kind`` "rmsnorm", eps 1e-6) or LayerNorm ("layernorm",
    eps 1e-5, rows off zero mean as a residual stream is) at width ``d``
    over the rows of a 2048-token prefill and of a decode step at B = 4,
    the weights f32 as in the models; each against its plain version on
    the same card inputs, timed against it and against ``F.rms_norm`` /
    ``F.layer_norm`` (weights in x's dtype), with the plan
    ``row_norm.norm_plan`` gave it.  The decode rows are also called back
    to back (``launch_times``): the wrapper's and the library call's host
    µs a call and device µs a launch."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.layernorm import ops as ln
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.row_norm import norm_plan
    from repro_torch.kernels.select import plain_versions

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    elt = torch.empty((), dtype=dt).element_size()
    tol = TOL_SERVE_KERNEL[dname]
    ops = rms if kind == "rmsnorm" else ln
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
    w_lib, bias_lib = w.to(dt), bias.to(dt)
    for n_rows, case in ((SERVE_SEQ, f"{SERVE_SEQ}x{d}"),
                         (SERVE_BATCH, f"decode {SERVE_BATCH}x{d}")):
        x = torch.randn((n_rows, d), generator=gen, device="cuda")
        if kind == "rmsnorm":
            x = x.to(dt)

            def run(x=x):
                return rms.rmsnorm(x, w, eps=1e-6)

            def lib(x=x):
                return F.rms_norm(x, (d,), weight=w_lib, eps=1e-6)

            # x read and y written once, the weight read once; square,
            # sum, scale and weight an element on f32 FFMA
            nbytes = 2 * x.numel() * elt + d * 4
            flops = 4 * x.numel()
        else:
            x = (x + 3.0).to(dt)

            def run(x=x):
                return ln.layernorm(x, w, bias, eps=1e-5)

            def lib(x=x):
                return F.layer_norm(x, (d,), weight=w_lib, bias=bias_lib,
                                    eps=1e-5)

            nbytes = 2 * x.numel() * elt + 2 * d * 4
            flops = 7 * x.numel()

        def plain(run=run):
            with plain_versions():
                return run()

        before = ops.LAUNCHES.launches
        got = run()
        check(ops.LAUNCHES.launches == before + 1,
              f"{kind} wrapper launched no kernel")
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"{kind} {dname} {case}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        row = dict(name=kind, **KERNELS[kind], launches=launches,
                   max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=cuda_ms(lib))
        # the decode rows: launches back to back (no flush), the
        # wrappers' host µs a call, printed only
        extra = {}
        if n_rows == SERVE_BATCH:
            extra = dict(kernel_launch=launch_times(run),
                         library_launch=launch_times(lib))
        detail = dict(dtype=dname, case=case,
                      plan=norm_plan(n_rows, d, elt, True, sms,
                                     layernorm=kind == "layernorm")._asdict(),
                      **extra, max_ref=scale, max_rel=err / scale,
                      bytes=nbytes, flops=flops,
                      path_launches_of_program=launches,
                      library_call=("F.rms_norm (weight" if kind == "rmsnorm"
                                    else "F.layer_norm (weight and bias")
                      + " in the input's dtype)",
                      library_max_rel=rel_err(lib().float(), want.float()))
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(err / scale <= tol, f"{kind} {dname} {case}: max|d|/max|ref| "
                                  f"{err / scale:.3e} > {tol}")
        rows.append((row, detail))


def wkv_cost(b: int, h: int, n: int, steps: list, t: int, elt: int,
             with_s0: bool):
    """(bound_ms, bound_by, bytes, flops) of one WKV call: r, k, v (elt
    bytes) and w (f32) of the valid steps read once, y (all T steps,
    zero past a row's length) and the final state written once, s0 read
    once where given.  Per state element and valid step, on f32 FFMA in
    both dtypes: in f32 5 flops (r*s + y, k*v, w*s + kv), since the bonus
    factors out of the dot, y = r.s + (sum_k r_k u_k k_k) v; in bf16 7
    (k*v, u*kv + s, r*tmp + y, w*s + kv), since k*v is rounded per
    element, as the model's decode step rounds it."""
    valid = sum(steps)
    nbytes = (valid * h * n * (3 * elt + 4) + b * t * h * n * elt
              + b * h * n * n * 4 * (2 if with_s0 else 1) + h * n * 4)
    flops = (5 if elt == 4 else 7) * h * n * n * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def rwkv_kernel_phase(cfg, dname: str, report: dict, rows: list):
    """The WKV and LayerNorm kernels at path 4's shapes, each against its
    plain version on the same card inputs, timed against the plain
    version (and ``F.layer_norm`` for LayerNorm: ``norm_kernel_rows``)."""
    import torch

    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.kernels.rwkv6.rwkv6 import wkv_plan
    from repro_torch.kernels.select import plain_versions

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    elt = torch.empty((), dtype=dt).element_size()
    h, n, d = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(23)
    tol = TOL_SERVE_KERNEL[dname]
    launches = path_launches(report, "path4", dname)

    def inputs(b, t, decay_scale=1.0):
        """r, k, v as the path's (B, H, T, N) views of token-major
        projections; w the f32 decay exp(-exp(clip(x s, -8, 4))), s the
        decay scale."""
        def proj():
            return torch.randn((b, t, h, n), generator=gen, device="cuda") \
                .to(dt).transpose(1, 2)

        w = torch.exp(-torch.exp((decay_scale * torch.randn(
            (b, t, h, n), generator=gen, device="cuda")).clamp(-8, 4)))
        return (proj(), proj(), proj(), w.transpose(1, 2),
                0.1 * torch.randn((h, n), generator=gen, device="cuda"))

    def state(b):
        return torch.randn((b, h, n, n), generator=gen, device="cuda")

    cases = []
    r, k, v, w, u = inputs(1, SERVE_SEQ)
    cases.append(dict(label=f"prefill B=1 T={SERVE_SEQ} s0=0",
                      args=(r, k, v, w, u, None, None), steps=[SERVE_SEQ]))
    r, k, v, w, u = inputs(2, SERVE_CHUNK)
    s0 = state(2)
    lens = torch.tensor([SERVE_CHUNK, 0], dtype=torch.int32, device="cuda")
    cases.append(dict(label=f"chunk B=2 T={SERVE_CHUNK} from s0, lens "
                            f"{lens.tolist()}",
                      args=(r, k, v, w, u, s0, lens), steps=[SERVE_CHUNK, 0],
                      zero_row=1))
    cases.append(dict(label="ragged B=1 T=1999 s0=0",
                      args=(*inputs(1, 1999), None, None), steps=[1999]))
    cases.append(dict(label=f"harsh decays (scale 3) B=1 T={SERVE_SEQ} "
                            f"s0=0",
                      args=(*inputs(1, SERVE_SEQ, 3.0), None, None),
                      steps=[SERVE_SEQ]))
    r, k, v, w, u = inputs(SERVE_BATCH, 1)
    cases.append(dict(label=f"decode B={SERVE_BATCH} T=1 from s0",
                      args=(r, k, v, w, u, state(SERVE_BATCH), None),
                      steps=[1] * SERVE_BATCH))

    for c in cases:
        def run(c=c):
            return wkv.rwkv6(*c["args"])

        def plain(run=run):
            with plain_versions():
                return run()

        before = wkv.LAUNCHES.launches
        y, s1 = run()
        check(wkv.LAUNCHES.launches == before + 1,
              "rwkv6 wrapper launched no kernel")
        y_p, s1_p = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(s1).all()),
              f"rwkv6 {dname} {c['label']}: non-finite output")
        err = (y.float() - y_p.float()).abs().max().item()
        scale = y_p.float().abs().max().item()
        s_rel = rel_err(s1, s1_p)
        zero_ok = True
        if "zero_row" in c:
            z, s0 = c["zero_row"], c["args"][5]
            zero_ok = (not y[z].any()) and torch.equal(s1[z], s0[z])
        b, _, t, _ = c["args"][0].shape
        plan = wkv_plan(b, h, t, n)
        bound_ms, bound_by, nbytes, flops = wkv_cost(
            b, h, n, c["steps"], t, elt, c["args"][5] is not None)
        ms = cuda_ms(run)
        row = dict(name="rwkv6", **KERNELS["rwkv6"],
                   launches=launches["rwkv6"], max_abs_err=err, ms=ms,
                   plain_ms=cuda_ms(plain, reps=3), bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        detail = dict(dtype=dname, case=c["label"], max_ref=scale,
                      max_rel=err / scale, state_max_rel=s_rel,
                      bytes=nbytes, flops=flops, tflops=flops / ms / 1e9,
                      plan=plan._asdict(),
                      path_launches_of_program=launches["rwkv6"],
                      library_call="none", zero_row_ok=zero_ok)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(err / scale <= tol, f"rwkv6 {dname} {c['label']}: "
                                  f"max|d|/max|ref| {err / scale:.3e} > "
                                  f"{tol}")
        check(s_rel <= TOL_WKV_STATE, f"rwkv6 {dname} {c['label']}: state "
                                      f"max|d|/max|ref| {s_rel:.3e}")
        check(zero_ok, f"rwkv6 {dname} {c['label']}: the lens = 0 row's y "
                       f"is not 0 or its state moved")
        rows.append((row, detail))

    # LayerNorm over the rows of a 2048-token prefill and of a decode step
    # at B = 4
    norm_kernel_rows("layernorm", d, dname, gen, launches["layernorm"],
                     rows)


def ssd_cost(b: int, h: int, n: int, p: int, steps: list, t: int,
             elt: int, with_s0: bool, peak: float = F32_FLOPS):
    """(bound_ms, bound_by, bytes, flops) of one SSD call: x (elt bytes),
    the f32 decay a and the row's b and c (elt bytes) of the valid steps
    read once, y (f32, all T steps, zero past a row's length) and the
    final state written once, s0 read once where given.  The recurrent
    form needs 4 N P flops per head and valid step (b x^T, a h + ., c^T
    h), over ``peak``: the rate of the unit the instance runs its
    products on (TF32 tensor cores for the chunked one, f32 FFMA for
    decode)."""
    valid = sum(steps)
    nbytes = (valid * h * (p * elt + 4) + valid * 2 * n * elt
              + b * t * h * p * 4 + b * h * n * p * 4 * (2 if with_s0 else 1))
    flops = 4 * n * p * h * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def ssd_resources() -> str:
    """``cuda_build.resources`` of the SSD library, as one JSON object.
    Checks that no instance uses local memory (none spills) and that the
    chunked instance's products run on tensor cores (HMMA: TF32
    ``mma.sync``)."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.mamba2.mamba2 import source_job

    res = cuda_build.resources(source_job())
    for kname, r in res.items():
        check(r["local"] == 0, f"SSD instance {kname}: {r}")
        if kname.startswith("ssd_chunked<"):
            check(r["hmma"] > 0, f"SSD instance {kname}: no HMMA, {r}")
    check(any(k.startswith("ssd_decode<") for k in res)
          and any(k.startswith("ssd_chunked<") for k in res),
          f"SSD library: instances {sorted(res)}")
    return json.dumps(res)


def softmax_resources() -> str:
    """``cuda_build.resources`` of the masked softmax library, as one JSON
    object; checks that no instance uses local memory."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.softmax.softmax import source_job

    res = cuda_build.resources(source_job())
    for kname, r in res.items():
        check(r["local"] == 0, f"masked softmax instance {kname}: {r}")
    return json.dumps(res)


def norm_resources(kind: str) -> str:
    """``cuda_build.resources`` of ``kind``'s norm library (``rmsnorm`` or
    ``layernorm``), as one JSON object; checks that no instance uses local
    memory (none spills) and that both instances are there."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.row_norm import source_job

    res = cuda_build.resources(source_job(kind))
    for kname, r in res.items():
        check(r["local"] == 0, f"{kind} instance {kname}: {r}")
    check(any(k.startswith("norm_rows<") for k in res)
          and any(k.startswith("norm_loop<") for k in res),
          f"{kind} library: instances {sorted(res)}")
    return json.dumps(res)


def ssd_kernel_phase(cfg, dname: str, report: dict, rows: list):
    """The SSD kernel at path 5's shapes against its plain (chunked)
    version on the same card inputs, timed against it (no PyTorch call
    computes the scan)."""
    import torch

    from repro_torch.kernels.mamba2 import ops as ssd
    from repro_torch.kernels.mamba2.mamba2 import ssd_plan
    from repro_torch.kernels.select import plain_versions

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    elt = torch.empty((), dtype=dt).element_size()
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    h = 2 * cfg.d_model // p
    gen = torch.Generator(device="cuda").manual_seed(29)
    launches = path_launches(report, "path5", dname)

    def inputs(b, t):
        """The path's views: x (B, H, T, P) of a token-major projection,
        the decay a (B, H, T) = exp(-softplus(.)) of a (B, T, H) one, b
        and c the halves of a (B, T, 2N) projection."""
        x = torch.randn((b, t, h, p), generator=gen, device="cuda") \
            .to(dt).transpose(1, 2)
        a = torch.exp(-torch.nn.functional.softplus(torch.randn(
            (b, t, h), generator=gen, device="cuda"))).transpose(1, 2)
        bc = torch.randn((b, t, 2 * n), generator=gen, device="cuda").to(dt)
        return x, a, bc[..., :n], bc[..., n:]

    def state(b):
        return torch.randn((b, h, n, p), generator=gen, device="cuda")

    cases = [dict(label=f"prefill B=1 T={SERVE_SEQ} s0=0",
                  args=(*inputs(1, SERVE_SEQ), None, None),
                  steps=[SERVE_SEQ])]
    lens = torch.tensor([SERVE_CHUNK, 0], dtype=torch.int32, device="cuda")
    cases.append(dict(label=f"chunk B=2 T={SERVE_CHUNK} from s0, lens "
                            f"{lens.tolist()}",
                      args=(*inputs(2, SERVE_CHUNK), state(2), lens),
                      steps=[SERVE_CHUNK, 0], zero_row=1))
    cases.append(dict(label="ragged B=1 T=1999 s0=0",
                      args=(*inputs(1, 1999), None, None), steps=[1999]))
    cases.append(dict(label=f"decode B={SERVE_BATCH} T=1 from s0",
                      args=(*inputs(SERVE_BATCH, 1), state(SERVE_BATCH),
                            None),
                      steps=[1] * SERVE_BATCH))

    for c in cases:
        def run(c=c):
            return ssd.mamba2_scan(*c["args"])

        def plain(run=run):
            with plain_versions():
                return run()

        before = ssd.LAUNCHES.launches
        y, s1 = run()
        check(ssd.LAUNCHES.launches == before + 1,
              "mamba2 wrapper launched no kernel")
        y_p, s1_p = plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(s1).all()),
              f"mamba2 {dname} {c['label']}: non-finite output")
        err = (y - y_p).abs().max().item()
        scale = y_p.abs().max().item()
        s_rel = rel_err(s1, s1_p)
        zero_ok = True
        if "zero_row" in c:
            z, s0 = c["zero_row"], c["args"][4]
            zero_ok = (not y[z].any()) and torch.equal(s1[z], s0[z])
        b, _, t, _ = c["args"][0].shape
        plan = ssd_plan(b, h, t, n, p)
        cost = (b, h, n, p, c["steps"], t, elt, c["args"][4] is not None)
        bound_ms, bound_by, nbytes, flops = ssd_cost(
            *cost, peak=F32_FLOPS if plan.instance == "decode"
            else TF32_FLOPS)
        ms = cuda_ms(run)
        row = dict(name="mamba2", **KERNELS["mamba2"],
                   launches=launches["mamba2"], max_abs_err=err, ms=ms,
                   plain_ms=cuda_ms(plain, reps=5), bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        detail = dict(dtype=dname, case=c["label"], max_ref=scale,
                      max_rel=err / scale, state_max_rel=s_rel,
                      bytes=nbytes, flops=flops, tflops=flops / ms / 1e9,
                      bound_ffma_ms=ssd_cost(*cost)[0],
                      plan=plan._asdict(),
                      path_launches_of_program=launches["mamba2"],
                      library_call="none", zero_row_ok=zero_ok)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(err / scale <= TOL_SSD, f"mamba2 {dname} {c['label']}: y "
                                      f"max|d|/max|ref| {err / scale:.3e} "
                                      f"> {TOL_SSD}")
        check(s_rel <= TOL_SSD, f"mamba2 {dname} {c['label']}: state "
                                f"max|d|/max|ref| {s_rel:.3e} > {TOL_SSD}")
        check(zero_ok, f"mamba2 {dname} {c['label']}: the lens = 0 row's y "
                       f"is not 0 or its state moved")
        rows.append((row, detail))


def softmax_kernel_phase(report: dict, rows: list, path: str = "path6",
                         wide: bool = True):
    """The masked softmax kernel at ``path``'s router shapes (the f32
    logits of a (1, 2048) prefill bucket, 2048 x E, and of a decode step,
    4 x E, at ``n_valid = E``: 16 on path 6, 160 on path 12), with
    ``wide`` at 4096 x 2048 in f32 and bf16 with ``n_valid`` 1500 and
    2048, and once at ``n_valid = 0`` (every row 0), each against its
    plain version on the same card inputs, padded columns exactly 0;
    timed against the plain version and ``torch.softmax`` over the valid
    columns, a yardstick the port never calls."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.select import plain_versions
    from repro_torch.kernels.softmax import ops as sm
    from repro_torch.kernels.softmax.softmax import softmax_plan

    gen = torch.Generator(device="cuda").manual_seed(23)
    e = get_config(SERVE_PATHS[path].arch).n_experts
    launches = {d: path_launches(report, path, d)["masked_softmax"]
                for d in ("f32", "bf16")}
    cases = [((SERVE_SEQ, e), "f32", e), ((SERVE_BATCH, e), "f32", e)]
    if wide:
        cases += [((4096, 2048), d, n) for d in ("f32", "bf16")
                  for n in (1500, 2048)]
        cases.append(((4096, 2048), "f32", 0))
    for (r, c), dname, n in cases:
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        elt = torch.empty((), dtype=dt).element_size()
        on_path = c == e
        x = (3 * torch.randn((r, c), generator=gen, device="cuda")).to(dt)

        def run(x=x, n=n):
            return sm.masked_softmax(x, n)

        def plain(run=run):
            with plain_versions():
                return run()

        before = sm.LAUNCHES.launches
        got = run()
        check(sm.LAUNCHES.launches == before + 1,
              "masked softmax wrapper launched no kernel")
        want = plain()
        torch.cuda.synchronize()
        zero_ok = (not got[:, n:].any() and (n > 0 or not got.any())
                   and bool(torch.isfinite(got).all()))
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        rel = err / scale if scale else err
        # the valid columns read once, every column written once; max,
        # subtract, exp, sum and divide per valid element on f32 FFMA
        nbytes = r * (n + c) * elt
        flops = 5 * r * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        lib = (lambda x=x, n=n: torch.softmax(x[:, :n], -1)) if n else None
        row = dict(name="masked_softmax", **KERNELS["masked_softmax"],
                   launches=launches[dname], max_abs_err=err, ms=cuda_ms(run),
                   plain_ms=cuda_ms(plain), bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=cuda_ms(lib) if lib else None)
        # the decode router's shape: launches back to back (no flush) and
        # the wrapper's host µs a call, printed only
        extra = {}
        if r == SERVE_BATCH and on_path:
            extra = dict(kernel_launch=launch_times(run),
                         library_launch=launch_times(lib))
        detail = dict(dtype=dname, case=f"{r}x{c} n_valid={n}"
                      + (f" ({path[4:]} router)" if on_path else ""),
                      plan=softmax_plan(r, c, elt)._asdict(), **extra,
                      max_ref=scale, max_rel=rel, bytes=nbytes, flops=flops,
                      path_launches_of_program=launches[dname] if on_path
                      else 0,
                      library_call="torch.softmax over the valid columns",
                      library_max_rel=rel_err(lib().float(),
                                              want[:, :n].float())
                      if lib else None, zero_cols_ok=zero_ok)
        print(f"[kernels] {json.dumps(dict(row, **detail))}", flush=True)
        check(rel <= TOL_SOFTMAX[dname],
              f"masked_softmax {dname} {detail['case']}: max|d|/max|ref| "
              f"{rel:.3e} > {TOL_SOFTMAX[dname]}")
        check(zero_ok, f"masked_softmax {dname} {detail['case']}: padded "
                       f"columns (or a row without a valid column) not 0")
        rows.append((row, detail))


# ------------------------------------------------- path 8: whisper-tiny --

def whisper_artifacts(cfg, model, eos_id: int):
    """Whisper's encoder and its whole greedy decode, each compiled on the
    jit pipeline with one entry (one CUDA graph) per batch bucket of 2:
    ``tests/test_system.py``'s single-artifact specs, ``enc_out`` in the
    model's dtype."""
    import torch

    import disc_torch
    from disc_torch import ArgSpec, BucketPolicy, Dim, TreeSpec
    from repro_torch.models import whisper
    from repro_torch.models.common import dtype_of

    dt = dtype_of(cfg)
    dim_b = Dim("B", max=8)
    policy = BucketPolicy(kind="multiple", granule=2)
    frames = ArgSpec((dim_b, cfg.encoder_len, cfg.d_model), dt)
    enc = disc_torch.compile(
        lambda params, frames: whisper.encode(cfg, params, frames),
        specs=[None, frames], pipeline="jit", name=f"{cfg.name}_encode",
        policy=policy)

    def step(params, cache, toks, lens, enc_out):
        return model.greedy_decode(params, cache, toks, lens,
                                   enc_out=enc_out, max_new=WHISPER_MAX_NEW,
                                   eos_id=eos_id)

    dec = disc_torch.compile(
        step, specs=[None, TreeSpec({1: "B"}),
                     ArgSpec((dim_b, 1), torch.int32, name="tokens"),
                     ArgSpec((dim_b,), torch.int32, name="lens"), frames],
        pipeline="jit", name=f"{cfg.name}_greedy_eos{eos_id}", policy=policy)
    return enc, dec


def host_greedy(model, params, cache, toks, lens, enc_out, max_new: int,
                eos_id: int):
    """The reference's early-exit loop on the host: decode steps, the
    kernels launched one by one, until every row has emitted ``eos_id``
    (one read of the done mask a step).  Returns (tokens, steps, cache)."""
    import torch

    b = toks.shape[0]
    buf = torch.full((b, max_new), eos_id, dtype=torch.int32, device="cuda")
    done = torch.zeros((b,), dtype=torch.bool, device="cuda")
    cur, n = toks, 0
    while n < max_new and not bool(done.all()):
        logits, cache = model.decode_step(params, cache, cur, lens,
                                          enc_out=enc_out)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        buf[:, n] = nxt
        done = done | (nxt == eos_id)
        cur, lens, n = nxt[:, None], lens + 1, n + 1
    return buf, n, cache


def trees_equal(a, b) -> bool:
    """Every tensor leaf of two trees equal bit for bit."""
    from torch.utils import _pytree

    la, lb = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and bool((x == y).all()) for x, y in zip(la, lb))


def whisper_phase(dname: str, weights: dict, seed: int, report: dict,
                  accuracy_ref=None):
    """Path 8 in one dtype: whisper-tiny (all 4 + 4 layers, full width) as
    the reference's single-artifact call.  ``encode`` over frames
    (B, 1500, 384) and ``model.greedy_decode`` (``max_new`` 64, EOS -1)
    compiled on the jit pipeline, batches 3, 4 and 2 (buckets 4, 4, 2):
    captures == compiles == 2 each, the rest replays, launches per encode
    call flash attention n_enc and LayerNorm 2 n_enc + 1, per decode step
    2 n_dec and 3 n_dec + 1; every call's outputs bit-equal to the same
    call under ``eager_entries()``; in f32 tokens and ``n`` equal to the
    plain versions' and the first step's logits within ``TOL_PATH_F32``
    of them, in bf16 the accuracy rule against the f32 run over the same
    weights (``accuracy_ref``).  Then an exact batch of 2 whose EOS is the
    first token of row 0's stream that row 1 emits too, so that the loop
    exits early: ``n`` below ``max_new`` and equal to the host loop's
    step count, the tokens equal to it, and the tokens, ``n`` and cache
    of its graph replay bit-equal to ``eager_entries()``.  Prints encode
    ms, decode ms a step graphed and under ``eager_entries()``, and one
    traced graphed call's wall and device-busy ms (its kernels held to the
    launch counts).  Returns the first-step logits."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import eager_entries
    from repro_torch.kernels.select import plain_versions
    from repro_torch.models import whisper
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config("whisper_tiny"), dtype=dname)
    model = get_model(cfg)
    params = weights if dname == "bf16" else to_f32(weights)
    dt = torch.float32 if dname == "f32" else torch.bfloat16
    tag = f"[path8 {dname}]"
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    inputs = []  # per batch: frames (bf16-valued in both dtypes), tokens
    for b in WHISPER_BATCHES:
        frames = torch.randn((b, cfg.encoder_len, cfg.d_model),
                             generator=gen, device="cuda")
        toks = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                             device="cuda", dtype=torch.int32)
        inputs.append((frames.to(torch.bfloat16).to(dt), toks))

    def fresh(b):   # a zero cache and lens 1 (one token in the prompt)
        return (model.init_cache(b, WHISPER_CACHE, "cuda"),
                torch.ones((b,), dtype=torch.int32, device="cuda"))

    enc_c, dec_c = whisper_artifacts(cfg, model, -1)

    def run_all():
        out = []
        for frames, toks in inputs:
            b = toks.shape[0]
            enc = enc_c(params, frames)[:b]   # the bucket's rows beyond b
            cache, lens = fresh(b)
            out.append((enc, dec_c(params, cache, toks, lens, enc)))
        return out

    counters = serve_counters()
    for c in counters.values():
        c.reset()
    graphed = run_all()
    torch.cuda.synchronize()
    counted = {k: c.launches for k, c in counters.items()}
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    per_call = {"flash_attention": n_enc + 2 * n_dec * WHISPER_MAX_NEW,
                "layernorm": 2 * n_enc + 1
                + (3 * n_dec + 1) * WHISPER_MAX_NEW}
    want = dict.fromkeys(counted, 0)
    want.update({k: n * len(inputs) for k, n in per_call.items()})
    check(counted == want, f"{tag} launches {counted}, the path predicts "
                           f"{want}")
    report[("path8", dname, n_dec)] = dict(launches=counted)
    for name, art in (("encode", enc_c), ("greedy_decode", dec_c)):
        st = art.graph_stats
        check(st.captures == art.n_compiles == 2
              and st.replays == len(inputs) - st.captures,
              f"{tag} {name}: captures {st.captures}, compiles "
              f"{art.n_compiles}, replays {st.replays} for {len(inputs)} "
              f"calls in 2 buckets")
        print(f"{tag} {name}: graphs: captures {st.captures} (== compiles "
              f"{art.n_compiles}), replays {st.replays}; bytes copied in "
              f"{st.bytes_in} out {st.bytes_out}; capture s "
              f"{[round(x, 3) for x in st.capture_seconds]}", flush=True)
    with eager_entries():
        eager = run_all()
    for (_, toks), g, e in zip(inputs, graphed, eager):
        check(trees_equal(g, e), f"{tag} B={toks.shape[0]}: graphed encode "
                                 f"/ decode not bit-equal to "
                                 f"eager_entries()")
    for (_, toks), (_, (buf, n, _)) in zip(inputs, graphed):
        b = toks.shape[0]
        check(int(n) == WHISPER_MAX_NEW
              and 0 <= int(buf[:b].min()) and int(buf[:b].max()) < cfg.vocab,
              f"{tag} B={b}: n {int(n)}, tokens out of range")
    print(f"{tag} graphed == eager_entries() bit for bit at B "
          f"{list(WHISPER_BATCHES)}; launches {counted} (the path's "
          f"count)", flush=True)
    del eager
    # the plain versions: tokens and n in f32; the first step's logits
    before = {k: c.launches for k, c in counters.items()}
    with plain_versions():
        plain = run_all()
    check({k: c.launches for k, c in counters.items()} == before,
          f"{tag} plain run launched kernels")
    if dname == "f32":
        for (_, toks), (_, (buf, n, _)), (_, (buf_p, n_p, _)) in zip(
                inputs, graphed, plain):
            b = toks.shape[0]
            check(int(n) == int(n_p) and torch.equal(buf[:b], buf_p[:b]),
                  f"{tag} B={b}: tokens differ from the plain versions' "
                  f"at {(buf[:b] != buf_p[:b]).nonzero()[:3].tolist()}")
        print(f"{tag} tokens and n equal to the plain versions' at B "
              f"{list(WHISPER_BATCHES)}", flush=True)
    frames, toks = inputs[0]
    b = toks.shape[0]
    cache, lens = fresh(b)
    first, _ = model.decode_step(params, cache, toks, lens,
                                 enc_out=graphed[0][0])
    first = first[:, 0].float()
    with plain_versions():
        enc_p = whisper.encode(cfg, params, frames)
        first_p, _ = model.decode_step(params, cache, toks, lens,
                                       enc_out=enc_p)
    first_p = first_p[:, 0].float()
    e = rel_err(first, first_p)
    if accuracy_ref is None:
        print(f"{tag} first-step logits vs plain max|d|/max|ref| {e:.3e}",
              flush=True)
        check(e <= TOL_PATH_F32, f"{tag} first-step logits {e:.3e} > "
                                 f"{TOL_PATH_F32}")
    else:
        e_k, e_p = rel_err(first, accuracy_ref), rel_err(first_p,
                                                        accuracy_ref)
        print(f"{tag} first-step logits vs f32 max|d|/max|ref| kernels "
              f"{e_k:.3e} plain {e_p:.3e} (kernels vs plain {e:.3e}; ratio "
              f"{e_k / e_p:.3f})", flush=True)
        check(e_k <= ACCURACY_RATIO * e_p,
              f"{tag} first-step logits from f32 {e_k:.3e} > "
              f"{ACCURACY_RATIO} x the plain versions' {e_p:.3e}")
    del plain
    # the early exit: batch 2 (bucket 2, no padded row)
    frames, toks = inputs[-1]
    enc = graphed[-1][0]
    s0, s1 = (graphed[-1][1][0][r].tolist() for r in (0, 1))
    eos = next((t for t in s0 if t in s1), s0[0])
    cache, lens = fresh(2)
    buf_h, n_h, cache_h = host_greedy(model, params, cache, toks, lens, enc,
                                      WHISPER_MAX_NEW, eos)
    _, dec_eos = whisper_artifacts(cfg, model, eos)
    for _ in range(2):   # its capture, then a replay
        cache, lens = fresh(2)
        out = dec_eos(params, cache, toks, lens, enc)
    with eager_entries():
        cache, lens = fresh(2)
        out_e = dec_eos(params, cache, toks, lens, enc)
    buf, n, cache = out
    st = dec_eos.graph_stats
    check(st.captures == 1 and st.replays == 1,
          f"{tag} early exit: captures {st.captures} replays {st.replays}")
    check(int(n) == n_h < WHISPER_MAX_NEW and torch.equal(buf, buf_h),
          f"{tag} early exit at EOS {eos}: n {int(n)}, the host loop's "
          f"{n_h} steps (of {WHISPER_MAX_NEW})")
    check(trees_equal(out, out_e), f"{tag} early exit: the graph's tokens, "
                                   f"n or cache not bit-equal to "
                                   f"eager_entries()")
    print(f"{tag} early exit at EOS {eos}: n {int(n)} == the host loop's "
          f"steps, tokens equal; replay == eager_entries() bit for bit "
          f"(cache too); the host loop's cache "
          f"{'bit-equal' if trees_equal(cache, cache_h) else 'differs'}",
          flush=True)
    del out, out_e, cache, cache_h, dec_eos
    # times at B = 4 (a replay of bucket 4's graphs)
    frames, toks = inputs[1]
    enc = graphed[1][0]
    enc_ms = median_ms(lambda: enc_c(params, frames))

    def decode_call():
        cache, lens = fresh(4)
        return dec_c(params, cache, toks, lens, enc)

    dec_ms = median_ms(decode_call)
    with eager_entries():
        eager_ms = median_ms(decode_call, reps=1)
    wall, busy, top, seen = profile_ms(decode_call, decode_call)
    traced = {k: seen[k] for k in ("flash_attention", "layernorm")}
    step = {"flash_attention": 2 * n_dec * WHISPER_MAX_NEW,
            "layernorm": (3 * n_dec + 1) * WHISPER_MAX_NEW}
    if busy is not None:
        check(traced == step, f"{tag} the traced greedy decode ran "
                              f"{traced}, the path predicts {step}")
    print(f"{tag} B=4: encode {enc_ms:.3f} ms graphed; greedy decode of "
          f"{WHISPER_MAX_NEW} steps {dec_ms:.3f} ms graphed "
          f"({dec_ms / WHISPER_MAX_NEW:.4f} ms a step), {eager_ms:.3f} ms "
          f"under eager_entries() ({eager_ms / WHISPER_MAX_NEW:.4f} ms a "
          f"step); one traced graphed call: wall {wall:.3f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'} ms "
          f"({'' if busy is None else f'{busy / WHISPER_MAX_NEW:.4f} '}ms "
          f"a step), kernels {traced}; most device time (kernel, ms, "
          f"launches): {top}", flush=True)
    del graphed, enc_c, dec_c, enc, inputs, params
    mem = torch.cuda.memory_allocated()
    print(f"{tag} card memory allocated: {mem0} B before the phase, {mem} "
          f"B after its objects were deleted; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check(mem <= mem0 + MEM_SLACK_BYTES,
          f"{tag} {mem - mem0} B still allocated after the phase")
    torch.cuda.empty_cache()
    return first


def whisper_kernel_phase(dname: str, report: dict, rows: list) -> None:
    """Flash attention at whisper's new shapes (hd 64, 6 heads, 1500
    frames): the encoder's non-causal self-attention at 1500 x 1500 (B =
    4), the decoder's cross-attention of a 448-token forward over 1500
    frames, and a decode step's cross-attention over 1500 keys with
    ``lens=None`` (B = 4); and LayerNorm at width 384; each against its
    plain version, timed against it and the library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config

    cfg = get_config("whisper_tiny")
    dt = torch.float32 if dname == "f32" else torch.bfloat16
    h, hd, frames = cfg.n_heads, cfg.hd, cfg.encoder_len
    gen = torch.Generator(device="cuda").manual_seed(18)
    launches = path_launches(report, "path8", dname)

    def rnd(b, s, heads):   # a (B, heads, S, hd) view of a token-major x
        return torch.randn((b, s, heads, hd), generator=gen,
                           device="cuda").to(dt).transpose(1, 2)

    def padded(b, sq):
        """q (B, H, Sq, hd) and K / V of 1500 frames, with one more batch
        row of zeros (a padded bucket row: its output must be 0)."""
        q, k, v = rnd(b + 1, sq, h), rnd(b + 1, frames, h), \
            rnd(b + 1, frames, h)
        for t in (q, k, v):
            t[b].zero_()
        return q, k, v

    cases = []
    for label, b, sq in (("encoder self non-causal", 4, frames),
                         ("cross S=448", 1, 448)):
        q, k, v = padded(b, sq)
        cases.append(dict(
            label=f"{label} {sq}x{frames} B={b}", q=q[:b], k=k[:b], v=v[:b],
            args=dict(lens=None, causal=False), kv_rows=b * frames,
            pairs=b * sq * frames,
            lib=lambda q=q[:b], k=k[:b], v=v[:b]:
                F.scaled_dot_product_attention(q, k, v),
            zero_check=(q, k, v, dict(lens=None, causal=False), [b])))
    q, k, v = padded(4, 1)
    cases.append(dict(
        label=f"decode cross lens=None B=4 over {frames}", q=q[:4], k=k[:4],
        v=v[:4], args=dict(lens=None), decode=True, kv_rows=4 * frames,
        pairs=4 * frames,
        lib=lambda q=q[:4], k=k[:4], v=v[:4]:
            F.scaled_dot_product_attention(q, k, v),
        zero_check=(q, k, v, dict(lens=None), [4])))
    flash_rows(cases, dname, h, launches["flash_attention"], rows)
    norm_kernel_rows("layernorm", cfg.d_model, dname, gen,
                     launches["layernorm"], rows)


# ------------------------------------------ path 11: llava-next-34b --

def llava_artifact(cfg, model):
    """``model.forward(params, {"tokens", "image_embeds"})`` on the jit
    pipeline: the text dim bucketed (its padding comes last, where the
    causal mask hides it), the image-token dim exact (a zero-padded image
    row would sit before the text and be attended to)."""
    import torch

    import disc_torch
    from disc_torch import ArgSpec, Dim
    from repro_torch.models.common import dtype_of

    def fwd(params, tokens, image_embeds):
        return model.forward(params, {"tokens": tokens,
                                      "image_embeds": image_embeds})

    return disc_torch.compile(
        fwd, specs=[None,
                    ArgSpec((1, Dim("T", max=1024)), torch.int64,
                            name="tokens"),
                    ArgSpec((1, Dim("I", max=cfg.max_image_tokens,
                                    bucket="exact"), cfg.d_model),
                            dtype_of(cfg), name="image_embeds")],
        pipeline="jit", name=f"{cfg.name}_forward")


def llava_phase(dname: str, layers: int, weights: dict, seed: int,
                report: dict, plain: bool = True, accuracy_ref=None):
    """Path 11 in one dtype at ``layers``: llava-next-34b's forward with
    image-token prefixes (576, 1152 and 2880: anyres 1, 2 and 5 tiles)
    and texts of 37 and 731 tokens at B = 1, then (576, 45) and (2880,
    731) again (replays).  Checks captures == compiles == the distinct
    (image count, text bucket) pairs, the rest replays; flash attention n
    and RMSNorm 2n + 1 launches a call; every call's logits bit-equal to
    the same call under ``eager_entries()``; with ``plain``, the valid
    logits in f32 within ``TOL_PATH_F32`` of the plain versions', in bf16
    each call's text logits under the accuracy rule against
    ``accuracy_ref`` (the f32 run's over the same weights).  Returns the
    text rows' logits of each call, in order, from an f32 run with
    ``plain`` (the bf16 run's accuracy reference), else nothing."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import eager_entries
    from repro_torch.kernels.select import plain_versions
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config("llava_next_34b"), dtype=dname,
                              n_layers=layers)
    model = get_model(cfg)
    params = weights if dname == "bf16" else to_f32(weights)
    dt = torch.float32 if dname == "f32" else torch.bfloat16
    tag = f"[path11 {dname} {layers}L]"
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    pairs = [(i, t) for i in LLAVA_IMAGES for t in LLAVA_TEXTS] + \
        list(LLAVA_REPLAYS)
    art = llava_artifact(cfg, model)
    counters = serve_counters()
    launched = dict.fromkeys(counters, 0)
    text_logits, errs, times, buckets = [], {}, {}, set()
    for i, (n_img, n_txt) in enumerate(pairs):
        img = torch.randn((1, n_img, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16).to(dt)
        toks = torch.randint(0, cfg.vocab, (1, n_txt), generator=gen,
                             device="cuda")
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = art(params, toks, img)
        torch.cuda.synchronize()
        times.setdefault((n_img, n_txt), []).append(
            round(1e3 * (time.perf_counter() - t), 3))
        for k, c in counters.items():
            launched[k] += c.launches - before[k]
        valid = n_img + n_txt
        # the jit pipeline returns the bucket's padded rows too
        check(got.shape[0] == 1 and got.shape[1] >= valid
              and bool(torch.isfinite(got[:, :valid]).all()),
              f"{tag} ({n_img}, {n_txt}): logits {tuple(got.shape)} or "
              f"non-finite")
        buckets.add((n_img, got.shape[1] - n_img))
        with eager_entries():
            check(torch.equal(got, art(params, toks, img)),
                  f"{tag} ({n_img}, {n_txt}): graphed logits not bit-equal "
                  f"to eager_entries()")
        text = got[0, n_img:valid].to(torch.float32, copy=True)
        if dname == "f32" and plain:
            text_logits.append(text)
        if plain:
            with plain_versions():
                want = art(params, toks, img)[:, :valid].float()
            e = rel_err(got[:, :valid].float(), want)
            if accuracy_ref is None:
                check(e <= TOL_PATH_F32, f"{tag} ({n_img}, {n_txt}): "
                                         f"logits vs plain {e:.3e} > "
                                         f"{TOL_PATH_F32}")
                errs[(n_img, n_txt)] = float(f"{e:.3e}")
            else:
                ref = accuracy_ref[i]
                e_k, e_p = rel_err(text, ref), rel_err(
                    want[0, n_img:], ref)
                errs[(n_img, n_txt)] = (float(f"{e_k:.3e}"),
                                        float(f"{e_p:.3e}"))
                check(e_k <= ACCURACY_RATIO * e_p,
                      f"{tag} ({n_img}, {n_txt}): text logits from f32 "
                      f"{e_k:.3e} > {ACCURACY_RATIO} x the plain versions' "
                      f"{e_p:.3e}")
            del want
        del got, text
    calls = len(pairs)
    want = dict.fromkeys(launched, 0)
    want.update({"flash_attention": layers * calls,
                 "rmsnorm": (2 * layers + 1) * calls})
    check(launched == want, f"{tag} launches {launched}, the path predicts "
                            f"{want}")
    report[("path11", dname, layers)] = dict(launches=launched)
    st = art.graph_stats
    check(st.captures == art.n_compiles == len(buckets)
          and st.replays == calls - st.captures,
          f"{tag} captures {st.captures}, compiles {art.n_compiles}, "
          f"replays {st.replays} for {calls} calls in {len(buckets)} "
          f"(image count, text bucket) pairs")
    print(f"{tag} graphs: captures {st.captures} (== compiles == "
          f"{len(buckets)} pairs), replays {st.replays}; every call "
          f"bit-equal to eager_entries(); launches {launched}; ms a call "
          f"(first: the eager run and capture) {times}; "
          f"{'vs plain max|d|/max|ref| ' + str(errs) if accuracy_ref is None and plain else ''}"
          f"{'text logits vs f32 (kernels, plain) ' + str(errs) if accuracy_ref is not None else ''}",
          flush=True)
    del art, params
    mem = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in text_logits)
    print(f"{tag} card memory allocated: {mem0} B before the phase, {mem} "
          f"B after its objects were deleted (the kept text logits not "
          f"counted); {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(mem <= mem0 + MEM_SLACK_BYTES,
          f"{tag} {mem - mem0} B still allocated after the phase")
    torch.cuda.empty_cache()
    return text_logits


def summary(rows: list, report: dict) -> list:
    """One entry per kernel: its most-launched f32 program at the path's
    shapes stands for it; ``launches`` sums every path's counted runs."""
    out = []
    for name in [*KERNELS, *MLA_FORM_OF]:
        mine = [(r, d) for r, d in rows if r["name"] == name]
        if not mine:
            continue
        row, _ = max(mine, key=lambda rd: (rd[1]["dtype"] == "f32",
                                           rd[1]["path_launches_of_program"],
                                           rd[1]["bytes"]))
        row = dict(row, launches=sum(rep["launches"].get(name, 0)
                                     for rep in report.values()))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder layers to unroll (default: all 22)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    import dataclasses

    from repro_torch.configs import get_config

    builds = None  # (thread, result) of the background nvcc builds
    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"[card] {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {kind}", flush=True)
        # the eager references contract in full f32: no TF32, and no
        # reduced-precision (bf16) reduction inside a bf16 GEMM
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        base = get_config("tinyllama_11b")
        cfgs = {d: dataclasses.replace(base, n_layers=args.layers, dtype=d)
                for d in ("f32", "bf16")}
        report: dict = {}
        rows: list = []
        path2 = {d: build_token_major(cfgs[d], d, args.seed)
                 for d in cfgs}
        builds = start_cuda_builds(list(path2.values()))
        print(f"[build] {builds[1]['sources']} CUDA sources building in "
              f"parallel", flush=True)
        for dname, cfg in cfgs.items():
            t0 = time.perf_counter()
            art = build(cfg, dname, args.seed)
            calls = path_phase("path1", art, dname, args.seed, cfg, report)
            kernel_phase(calls, dname, report[("path1", dname)]["launches"],
                         rows)
            if dname == "f32":
                reduce_extra_rows(rows)
            del calls
            print(f"[phase path1 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            # path 7 (a) and (c) on path 1's weights and lowered graph
            t0 = time.perf_counter()
            art7 = scan_phase(cfg, dname, art, args.seed, report)
            baseline_phase(dname, {"path1": art, "path7": art7}, card,
                           args.seed)
            del art, art7
            print(f"[phase path7 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        control_flow_phase()
        print(f"[phase path7 control flow] {time.perf_counter() - t0:.1f} s",
              flush=True)
        builds[0].join()
        built = builds[1]
        if "error" in built:
            raise PhaseError(f"CUDA build failed: {built['error']}")
        print(f"[build] {built['sources']} CUDA sources built in "
              f"{built['seconds']:.1f} s (nvcc, in parallel)", flush=True)
        try:
            res = flash_resources()
        except (OSError, subprocess.SubprocessError) as e:
            res = f"not available ({e})"
        print(f"[build] flash_attention instances: {res}", flush=True)
        try:
            res = gemm_resources(built["gemm_jobs"])
        except (OSError, subprocess.SubprocessError) as e:
            res = f"not available ({e})"
        print(f"[build] GEMM instances: {res}", flush=True)
        print_resources()
        for dname, cfg in cfgs.items():
            t0 = time.perf_counter()
            calls = path_phase("path2", path2[dname], dname, args.seed, cfg,
                               report)
            gemm_phase(calls, dname, report[("path2", dname)]["launches"],
                       rows)
            kernel_phase(calls, dname, report[("path2", dname)]["launches"],
                         rows, path="path2")
            del calls
            path2[dname] = None
            print(f"[phase path2 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        cluster_builds()
        t0 = time.perf_counter()
        library_phase(rows, report)
        print(f"[phase library] {time.perf_counter() - t0:.1f} s",
              flush=True)
        first_f32 = None  # path 3's bf16 accuracy reference
        for dname in ("f32", "bf16"):
            t0 = time.perf_counter()
            cfg, fills, first = serve_phase(
                "path3", dname, args.seed, report, accuracy_ref=first_f32,
                labels=("kernels", "plain", "chunked", "eager"))
            first_f32 = first
            serve_kernel_phase(cfg, dname, fills, report, rows)
            print(f"[phase path3 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        first_f32 = None  # path 4's bf16 accuracy reference
        for dname in ("f32", "bf16"):
            t0 = time.perf_counter()
            cfg, _, first = serve_phase("path4", dname, args.seed, report,
                                        accuracy_ref=first_f32)
            first_f32 = first
            rwkv_kernel_phase(cfg, dname, report, rows)
            print(f"[phase path4 {dname}] {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
        # path 5: the config's dtype at its full depth, then the cut depth
        # in both dtypes (f32 first: the bf16 run's accuracy reference)
        t0 = time.perf_counter()
        serve_phase("path5", "bf16", args.seed, report,
                    layers=get_config("zamba2_7b").n_layers,
                    labels=("kernels", "chunked", "eager", "eager chunked"))
        torch.cuda.empty_cache()
        print(f"[phase path5 bf16 81L] {time.perf_counter() - t0:.1f} s",
              flush=True)
        first_f32 = None
        for dname in ("f32", "bf16"):
            t0 = time.perf_counter()
            cfg, fills, first = serve_phase(
                "path5", dname, args.seed, report, accuracy_ref=first_f32,
                layers=PATH5_CUT_LAYERS,
                labels=("kernels", "plain", "chunked", "eager",
                        "eager chunked"))
            first_f32 = first
            ssd_kernel_phase(cfg, dname, report, rows)
            serve_kernel_phase(cfg, dname, fills, report, rows,
                               path="path5")
            print(f"[phase path5 {dname} {PATH5_CUT_LAYERS}L] "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()
        # path 6: bf16 at 8 layers, drop-free, kernels and chunked; then 4
        # layers in both dtypes at the config's capacity (f32 first: the
        # bf16 run's accuracy reference)
        t0 = time.perf_counter()
        serve_phase("path6", "bf16", args.seed, report, layers=PATH6_LAYERS,
                    labels=("kernels", "chunked", "eager", "eager chunked"),
                    capacity_factor=PATH6_DROP_FREE_CF)
        print(f"[phase path6 bf16 {PATH6_LAYERS}L] "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        first_f32 = None
        for dname in ("f32", "bf16"):
            t0 = time.perf_counter()
            cfg, fills, first = serve_phase(
                "path6", dname, args.seed, report, accuracy_ref=first_f32,
                layers=PATH6_CUT_LAYERS, labels=("kernels", "plain", "eager"))
            first_f32 = first
            serve_kernel_phase(cfg, dname, fills, report, rows,
                               path="path6")
            print(f"[phase path6 {dname} {PATH6_CUT_LAYERS}L] "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        softmax_kernel_phase(report, rows)
        print(f"[phase softmax] {time.perf_counter() - t0:.1f} s",
              flush=True)
        new_paths(args.seed, report, rows)
        t0 = time.perf_counter()
        obs_phase(args.seed, report)
        print(f"[phase path13] {time.perf_counter() - t0:.1f} s", flush=True)
        paged_phase(args.seed, report)
        train_phase(args.seed, report)
        mesh_phase(args.seed, report)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if builds is not None:
            builds[0].join()
    print(f"[run] {time.perf_counter() - t_run:.1f} s in all, the CUDA "
          f"builds included", flush=True)
    return finish(rows, report, card, kind)


def new_paths(seed: int, report: dict, rows: list) -> None:
    """Paths 8-12 and their kernel rows, each phase's seconds printed."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"[phase {name}] {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
        return out

    fills = [n + SERVE_NEW_TOKENS // 2 for n in SERVE_PROMPTS[:SERVE_BATCH]]
    # path 8: whisper-tiny's weights drawn in bf16 (its dtype), upcast for
    # the f32 run, which goes first: the bf16 run's accuracy reference
    gen = torch.Generator(device="cuda").manual_seed(seed)
    weights = get_model(get_config("whisper_tiny")).init(gen, "cuda")
    first = None
    for dname in ("f32", "bf16"):
        def path8(dname=dname, ref=first):
            out = whisper_phase(dname, weights, seed, report,
                                accuracy_ref=ref)
            whisper_kernel_phase(dname, report, rows)
            return out
        first = phase(f"path8 {dname}", path8)
    del weights, first
    # path 9: granite-20b at all 52 layers in bf16, unchunked and chunked;
    # then the cut depth in both dtypes against the plain versions
    phase("path9 bf16 52L", lambda: serve_phase(
        "path9", "bf16", seed, report,
        layers=get_config("granite_20b").n_layers,
        labels=("kernels", "chunked", "eager", "eager chunked")))
    first = None
    for dname in ("f32", "bf16"):
        def path9(dname=dname, ref=first):
            cfg, _, out = serve_phase(
                "path9", dname, seed, report, accuracy_ref=ref,
                layers=PATH9_CUT_LAYERS, labels=("kernels", "plain", "eager"))
            serve_kernel_phase(cfg, dname, fills, report, rows, path="path9",
                               forms=("decode",))
            return out
        first = phase(f"path9 {dname} {PATH9_CUT_LAYERS}L", path9)
    del first
    # path 10: minitron-4b and codeqwen1.5-7b at their 32 layers in bf16,
    # graphed and under eager_entries(); then 2 layers in f32 against the
    # plain versions
    for path in ("path10 minitron", "path10 codeqwen"):
        def full(path=path):
            cfg, _, _ = serve_phase(path, "bf16", seed, report,
                                    labels=("kernels", "eager"))
            serve_kernel_phase(cfg, "bf16", fills, report, rows, path=path,
                               forms=("decode",))
        phase(f"{path} bf16", full)

        def cut(path=path):
            cfg, _, _ = serve_phase(path, "f32", seed, report,
                                    layers=PATH10_CUT_LAYERS,
                                    labels=("kernels", "plain"))
            serve_kernel_phase(cfg, "f32", fills, report, rows, path=path,
                               forms=("decode",))
        phase(f"{path} f32 {PATH10_CUT_LAYERS}L", cut)
    # path 11: llava-next-34b's forward with image prefixes, 16 layers in
    # bf16, then 4 in f32 and bf16 against the plain versions (the f32 run
    # first: the bf16 run's accuracy reference)
    base = get_config("llava_next_34b")
    for layers in (LLAVA_LAYERS, LLAVA_CUT_LAYERS):
        cfg = dataclasses.replace(base, n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        weights = get_model(cfg).init(gen, "cuda")
        if layers == LLAVA_LAYERS:
            phase(f"path11 bf16 {layers}L", lambda: llava_phase(
                "bf16", layers, weights, seed, report, plain=False))
            del weights
            continue
        ref = phase(f"path11 f32 {layers}L", lambda: llava_phase(
            "f32", layers, weights, seed, report))
        phase(f"path11 bf16 {layers}L", lambda: llava_phase(
            "bf16", layers, weights, seed, report, accuracy_ref=ref))
        del ref, weights
        for dname in ("f32", "bf16"):
            phase(f"path11 kernels {dname}", lambda: serve_kernel_phase(
                dataclasses.replace(cfg, dtype=dname), dname, fills, report,
                rows, path="path11", forms=("decode",)))
    # path 12: DeepSeek-V2 at 6 layers in bf16, unchunked and chunked,
    # graphed and under eager_entries(); then 2 layers in f32 and bf16
    # against the plain versions (the f32 run first: the bf16 run's
    # accuracy reference); then its MLA kernel rows and RMSNorm at 5120
    phase(f"path12 bf16 {PATH12_LAYERS}L", lambda: serve_phase(
        "path12", "bf16", seed, report, layers=PATH12_LAYERS,
        labels=("kernels", "chunked", "eager", "eager chunked")))
    first = None
    for dname in ("f32", "bf16"):
        # in bf16 the engine runs once more on a paged pool of 16-token
        # blocks: its latent cache's two leaves gathered and scattered
        # around the same graphs
        def path12(dname=dname, ref=first):
            cfg, _, out = serve_phase(
                "path12", dname, seed, report, accuracy_ref=ref,
                layers=PATH12_CUT_LAYERS,
                labels=("kernels", "plain", "eager")
                + (("paged",) if dname == "bf16" else ()))
            mla_kernel_phase(cfg, dname, fills, report, rows)
            norm_kernel_rows(cfg.norm, cfg.d_model, dname,
                             torch.Generator(device="cuda").manual_seed(12),
                             path_launches(report, "path12",
                                           dname)[cfg.norm], rows)
            return out
        first = phase(f"path12 {dname} {PATH12_CUT_LAYERS}L", path12)
    del first
    phase("path12 softmax", lambda: softmax_kernel_phase(
        report, rows, path="path12", wide=False))


# ------------------------------------------------------ path 13: obs / ft --

@contextlib.contextmanager
def counting_reads(counts: dict):
    """Count every ``torch.cuda.synchronize``, ``Tensor.item`` and
    ``Tensor.tolist`` call in the block (each reads the card back)."""
    import torch

    saved = [(torch.cuda, "synchronize"), (torch.Tensor, "item"),
             (torch.Tensor, "tolist")]
    old = [getattr(o, n) for o, n in saved]

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for (o, n), fn in zip(saved, old):
        setattr(o, n, counted(n, fn))
    try:
        yield counts
    finally:
        for (o, n), fn in zip(saved, old):
            setattr(o, n, fn)


def ancestors(tr, e) -> list:
    """The names of the spans that enclose the event ``e``, innermost
    first."""
    out = []
    while e["parent"] != -1:
        e = tr.events[e["parent"]]
        out.append(e)
    return out


def obs_phase(seed: int, report: dict) -> None:
    """Path 13: the observability and fault-tolerance planes on path 1's
    compiled stack and path 3's engine, TinyLlama-1.1B at full width in
    f32 (random weights from a seeded generator).  (a) spans and faults
    of ``disc_torch.compile``, (b) the engine's spans, faults and a
    replica drain, (c) the hooks' cost, printed.  After (b) the card's
    allocated memory must be back within 1 GB of its value before the
    engine, with no gc pass."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("tinyllama_11b"), dtype="f32")
    mem = torch.cuda.memory_allocated
    mem_a = mem()
    launches = obs_compile(cfg, seed)
    # (a)'s lowering (the FX trace of the bridge) leaves reference cycles
    # that hold the weights it closed over until a gc pass: printed, and
    # collected before (b), whose engine is held to the rule
    left = mem() - mem_a
    gc.collect()
    mem0 = mem()
    launches.update(obs_serve(cfg, seed))
    report[("path13", "f32")] = dict(launches=launches)
    mem1 = mem()
    print(f"[path13 f32] card memory allocated: (a) left {left} B until a "
          f"gc pass, {mem0 - mem_a} B after it (printed, not held); (b) "
          f"{mem0} B before the engine, {mem1} B after its objects were "
          f"deleted", flush=True)
    check(mem1 <= mem0 + MEM_SLACK_BYTES,
          f"[path13 f32] {mem1 - mem0} B still allocated after (b)")


def obs_compile(cfg, seed: int) -> dict:
    """Path 13 (a): path 1's stack through ``disc_torch.compile`` (a CUDA
    graph a bucket) under a tracer and injected faults, every output held
    bit-equal to an untraced, fault-free artifact's.  Returns the kLoop /
    kInput / kDot launches of the traced miss and hit."""
    import torch

    import disc_torch
    from repro_torch.errors import CompileError, DiscError
    from repro_torch.ft import faults
    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.obs import trace as obs_trace

    from repro_torch.models import transformer as T

    tag = "[path13 f32 compile]"
    sync = torch.cuda.synchronize
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                    "cuda")

    def fn(x):
        return T.decoder_logits(cfg, params, x)

    specs = [((1, disc_torch.Dim("S", max=2048), cfg.d_model),
              torch.float32)]
    ref_f = disc_torch.compile(fn, specs, backend="hopper")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    xs = {s: torch.randn((1, s, cfg.d_model), generator=gen, device="cuda")
          for s in (37, 200, 731)}
    ref = {s: ref_f(x) for s, x in xs.items()}   # untraced, fault-free
    f = disc_torch.compile(fn, specs, backend="hopper")
    templates = f.lower().plan.template_counts()
    kern = f.backend.cluster_kernels
    counters = {"fused_elementwise": fe.LAUNCHES,
                "fused_reduce": fr.LAUNCHES,
                "matmul_epilogue": mm.EPILOGUE_LAUNCHES}
    for c in counters.values():
        c.reset()
    runs0 = sum(k.runs for k in kern.values())
    with obs_trace.tracing() as tr:
        y_miss = f(xs[37])          # miss: compile, first call, capture
        first = sum(k.runs for k in kern.values()) - runs0
        y_hit = f(xs[37])           # hit: a replay
    launches = {k: c.launches for k, c in counters.items()}
    sync()
    disp = tr.spans("dispatch")
    comp = tr.spans("compile.bucket")
    clus = tr.spans("kernel.cluster")
    check([d["args"]["cache_hit"] for d in disp] == [False, True],
          f"{tag} dispatch spans {[d['args'] for d in disp]}")
    miss, hit = (tr.events.index(d) for d in disp)
    check(len(comp) == 1 and comp[0]["parent"] == miss,
          f"{tag} {len(comp)} compile.bucket spans, not one under the miss")
    check(not [e for e in tr.events if e["parent"] == hit],
          f"{tag} the hit's dispatch span encloses events")
    check(all(tr.events[miss] in ancestors(tr, c) for c in clus),
          f"{tag} a kernel.cluster span outside the miss")
    clustered = sum(n for t, n in templates.items() if t in kern)
    check(len(clus) == first == clustered,
          f"{tag} {len(clus)} kernel.cluster spans, the first call ran "
          f"{first} clusters, the plan has {clustered}")
    check(all(
        launches[n] for t, n in (("kLoop", "fused_elementwise"),
                                 ("kInput", "fused_reduce"),
                                 ("kDot", "matmul_epilogue"))
        if templates.get(t)), f"{tag} launches {launches}")
    check(torch.equal(y_miss, ref[37]) and torch.equal(y_hit, ref[37]),
          f"{tag} traced S = 37 not bit-equal to the untraced run")
    print(f"{tag} traced miss + hit at S = 37: dispatch spans "
          f"{len(disp)}, compile.bucket {len(comp)} (under the miss), "
          f"kernel.cluster {len(clus)} (under the miss; the first call's "
          f"cluster runs {first}, the plan's {templates}), none under the "
          f"hit; launches {launches}; bit-equal to the untraced run",
          flush=True)

    # (c) host µs a dispatch span at S = 37 (replays), traced and not,
    # with an injector that never fires; no hook reads the card back
    reads: dict = {}
    with obs_trace.tracing() as tr, faults.inject(
            faults.FaultSpec("kernel.cluster", match="never")), \
            counting_reads(reads):
        for _ in range(OBS_DISPATCHES):
            f(xs[37])
    sync()
    spans = tr.spans("dispatch")
    span_us = sorted(1e6 * d["dur"] for d in spans)
    entry_us = sorted(1e6 * d["args"]["entry_seconds"] for d in spans)
    t0 = time.perf_counter()
    for _ in range(OBS_DISPATCHES):
        f(xs[37])
    plain_us = 1e6 * (time.perf_counter() - t0) / OBS_DISPATCHES
    sync()
    check(len(spans) == OBS_DISPATCHES and not reads,
          f"{tag} {len(spans)} dispatch spans for {OBS_DISPATCHES} calls; "
          f"reads of the card in traced replays {reads}")
    print(f"{tag} (c) host µs a dispatch span at S = 37 (replays, traced, "
          f"an injector that never fires): median {span_us[len(span_us) // 2]:.1f}, "
          f"min {span_us[0]:.1f}; entry_seconds median "
          f"{entry_us[len(entry_us) // 2]:.1f} µs; untraced host µs a call "
          f"{plain_us:.1f}; card reads in the traced replays: none",
          flush=True)

    # a transient compile.bucket fault on a miss: retried invisibly
    with faults.inject(faults.FaultSpec("compile.bucket", times=1,
                                        transient=True)) as inj:
        y = f(xs[200])
    check(inj.fired["compile.bucket"] == 1
          and f.cache_stats()["retries"] == 1
          and torch.equal(y, ref[200]),
          f"{tag} transient compile.bucket: fired {inj.fired}, "
          f"{f.cache_stats()}, bit-equal {torch.equal(y, ref[200])}")
    # a permanent kernel.cluster fault on a miss: a classified error, no
    # cluster run (through the kernel or per op), no entry kept; the next
    # call compiles and runs the kernels
    runs0 = sum(k.runs for k in kern.values())
    compiles = f.compile_counts()["total"]
    err = None   # the error's class and transience (not the error: its
    with faults.inject(faults.FaultSpec("kernel.cluster")) as inj:
        try:     # traceback would hold this frame's tensors)
            f(xs[731])
        except DiscError as e:
            err = (type(e).__name__, e.transient, isinstance(e, CompileError))
    check(err is not None and err[2] and not err[1],
          f"{tag} permanent kernel.cluster fault raised {err}")
    check(inj.calls["kernel.cluster"] == 1
          and sum(k.runs for k in kern.values()) == runs0
          and f.compile_counts()["total"] == compiles,
          f"{tag} after the kernel fault: site calls {inj.calls}, runs "
          f"{sum(k.runs for k in kern.values()) - runs0}, compiles "
          f"{f.compile_counts()}")
    y = f(xs[731])
    check(torch.equal(y, ref[731]),
          f"{tag} S = 731 after the kernel fault not bit-equal")
    print(f"{tag} transient compile.bucket fault at S = 200: retried "
          f"(retries {f.cache_stats()['retries']}), bit-equal; permanent "
          f"kernel.cluster fault at S = 731: {err[0]} "
          f"(transient={err[1]}), one site check, no cluster run, "
          f"no entry kept; the next call bit-equal", flush=True)
    del params, fn, ref_f, f, ref, xs, y, y_miss, y_hit
    return launches


def obs_serve(cfg, seed: int) -> dict:
    """Path 13 (b) and (c): path 3's engine at 2 replicas of 2 slots with
    heartbeats, untraced and traced, under launch faults and a replica
    drain; every surviving stream identical to the untraced, fault-free
    run's.  Returns that run's serve-kernel launches."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import Request
    from repro_torch.ft import faults
    from repro_torch.models.registry import get_model
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    tag = "[path13 f32 serve]"
    sync = torch.cuda.synchronize
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, "cuda")
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]
    # no EOS: every stream runs its 16 new tokens, and (c)'s batch stays
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=2, replicas=2, max_seq=SERVE_SEQ, eos_id=-1,
        heartbeat_deadline_s=OBS_DEADLINE_S))
    counters = serve_counters()

    def run(rid0, beat=None):
        """Serve the prompts as rids rid0.. with both replicas beating
        before each step (``beat(step)`` instead where given); returns
        the streams by prompt index and the serve launches."""
        for c in counters.values():
            c.reset()
        eng.reset_stats()
        eng.submit([Request(rid=rid0 + i, tokens=p,
                            max_new_tokens=SERVE_NEW_TOKENS)
                    for i, p in enumerate(prompts)])
        step = 0
        while eng.queue or any(s is not None for s in eng.slots):
            if beat is None:
                eng.heartbeat(0)
                eng.heartbeat(1)
            else:
                beat(step)
            eng.step()
            step += 1
        sync()
        return ({rid - rid0: t for rid, t in eng.done.items()
                 if rid0 <= rid < rid0 + len(prompts)},
                {k: c.launches for k, c in counters.items()})

    t0 = time.perf_counter()
    base, launches = run(0)
    st = dict(eng.stats)
    check(len(base) == len(prompts) and not eng.failed
          and all(len(t) == SERVE_NEW_TOKENS + 1 for t in base.values()),
          f"{tag} fault-free run: {len(base)} done, failed {eng.failed}")
    steps = st["prefill_calls"] + st["decode_steps"]
    check(launches["flash_attention"] == cfg.n_layers * steps
          and launches["rmsnorm"] == (2 * cfg.n_layers + 1) * steps,
          f"{tag} launches {launches} for {st['prefill_calls']} prefill "
          f"launches and {st['decode_steps']} decode steps")
    print(f"{tag} untraced fault-free: prefill_calls "
          f"{st['prefill_calls']} decode_steps {st['decode_steps']} "
          f"launches {launches} ({time.perf_counter() - t0:.1f} s, "
          f"captures included)", flush=True)

    # a traced run: the same streams and launches, each request's async
    # pair, a serve span a launch; the Chrome export read back
    with obs_trace.tracing() as tr:
        got, counted = run(100)
    reqs = tr.find("request")
    rids = {str(100 + i) for i in range(len(prompts))}
    pre, dec = tr.spans("serve.prefill"), tr.spans("serve.decode")
    check(got == base and counted == launches,
          f"{tag} traced run: streams equal {got == base}, launches "
          f"{counted} vs {launches}")
    check({e["id"] for e in reqs if e["ph"] == "b"} == rids
          == {e["id"] for e in reqs if e["ph"] == "e"},
          f"{tag} request async pairs {[(e['ph'], e['id']) for e in reqs]}")
    check(len(pre) == eng.stats["prefill_calls"]
          and len(dec) == eng.stats["decode_steps"]
          and all(s["args"] == {"attempts": 1, "error": False}
                  for s in pre + dec),
          f"{tag} {len(pre)} / {len(dec)} serve spans for "
          f"{eng.stats['prefill_calls']} / {eng.stats['decode_steps']}")
    out = ROOT / "build" / "path13_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    tr.export_chrome_trace(out)
    doc = json.loads(out.read_text())
    check(len(doc["traceEvents"]) == len(tr.events)
          and doc["otherData"]["dropped"] == 0,
          f"{tag} the Chrome export holds {len(doc['traceEvents'])} of "
          f"{len(tr.events)} events")
    print(f"{tag} traced: streams and launches identical; {len(rids)} "
          f"request pairs, serve.prefill {len(pre)}, serve.decode "
          f"{len(dec)}, {len(tr.events)} events exported to {out} and "
          f"read back", flush=True)

    # transient launch faults: retried, the streams unchanged
    with faults.inject(
            faults.FaultSpec("serve.launch", match="decode", at=[0, 3],
                             transient=True),
            faults.FaultSpec("serve.launch", match="prefill", at=[1],
                             transient=True)) as inj:
        got, _ = run(200)
    check(got == base and eng.stats["retries"] == 3 and not eng.failed,
          f"{tag} transient launch faults: streams equal {got == base}, "
          f"retries {eng.stats['retries']}, failed {eng.failed}")
    print(f"{tag} transient serve.launch faults (decode at 0, 3; prefill "
          f"at 1): fired {inj.fired['serve.launch']}, retries "
          f"{eng.stats['retries']}, streams identical", flush=True)

    # a permanent decode fault: only that launch's group fails
    groups = []
    decode = eng._decode

    def recording_decode():
        groups.append({eng.slots[i].rid for i, s in enumerate(eng.slots)
                       if s is not None and s.state == "decode"})
        decode()

    eng._decode = recording_decode
    with faults.inject(faults.FaultSpec("serve.launch", match="decode",
                                        at=[2])):
        got, _ = run(300)
    del eng._decode
    failed = set(eng.failed)
    check(failed == groups[2] and failed and all(
        "LaunchError(decode)" in eng.failed[r] for r in failed)
        and len(got) + len(failed) == len(prompts)
        and all(got[i] == base[i] for i in got),
        f"{tag} permanent decode fault: failed {sorted(failed)}, the "
        f"launch group {sorted(groups[2])}, {len(got)} done")
    print(f"{tag} permanent decode fault (the third decode launch): "
          f"failed {sorted(failed)} == its group; the other "
          f"{len(got)} streams identical", flush=True)

    # (c) decode ms/step: no tracer, a tracer, an injector that never
    # fires, in turns over one full batch
    eng.reset_stats()
    eng.submit([Request(rid=400 + i, tokens=prompts[i % 2],
                        max_new_tokens=3 * OBS_STEPS * OBS_ROUNDS + 8)
                for i in range(4)])
    while eng.queue or any(s is None or s.state != "decode"
                           for s in eng.slots):
        eng.heartbeat(0)
        eng.heartbeat(1)
        eng.step()
    modes = {"none": contextlib.nullcontext,
             "tracer": obs_trace.tracing,
             "injector": lambda: faults.inject(faults.FaultSpec(
                 "serve.launch", match="never"))}
    times = {m: [] for m in modes}
    for _ in range(OBS_ROUNDS):
        for m, ctx in modes.items():
            with ctx():
                for _ in range(OBS_STEPS):
                    eng.heartbeat(0)
                    eng.heartbeat(1)
                    sync()
                    t = time.perf_counter()
                    eng.step()
                    times[m].append(1e3 * (time.perf_counter() - t))
    check(all(s is not None and s.state == "decode" for s in eng.slots),
          f"{tag} (c) a request left the timed batch")
    print(f"{tag} (c) decode ms/step, 4 rows graphed, median / min of "
          f"{OBS_STEPS * OBS_ROUNDS}: " + "; ".join(
              f"{m} {sorted(v)[len(v) // 2]:.3f} / {min(v):.3f}"
              for m, v in times.items()), flush=True)
    while eng.queue or any(s is not None for s in eng.slots):
        eng.heartbeat(0)
        eng.heartbeat(1)
        eng.step()

    # replica 1 stops beating (its beats dropped at the ft.heartbeat
    # site): it drains, its requests resume on replica 0 through a
    # prefill of prompt + generated tokens, the streams identical in f32
    now = [0.0]
    eng._clock = lambda: now[0]
    drained = {}

    def beat(step):
        now[0] += 1.0
        if not drained and any(
                s is not None and len(s.generated) >= 2
                for s in eng.slots[2:]):
            drained.update({s.rid: len(s.generated)
                            for s in eng.slots[2:] if s is not None})
            faults.install(faults.FaultInjector(
                [faults.FaultSpec("ft.heartbeat", match="replica1")]))
            now[0] += OBS_DEADLINE_S + 1.0
        eng.heartbeat(0)
        eng.heartbeat(1)

    try:
        got, _ = run(500, beat=beat)
    finally:
        faults.clear()
    health = eng.report()["health"]
    check(eng.stats["replica_drains"] == 1
          and eng._replica_alive == [True, False]
          and not [r for r in eng.failed if r >= 500] and got == base
          and max(drained.values(), default=0) >= 2,
          f"{tag} drain: drains {eng.stats['replica_drains']}, alive "
          f"{eng._replica_alive}, failed {eng.failed}, streams equal "
          f"{got == base}, drained {drained}")
    check(set(health) == HEALTH_KEYS
          and set(health["counters"]) == HEALTH_COUNTERS
          and health["kernel_demotions"] == []
          and health["alive_replicas"] == 1,
          f"{tag} report()['health'] {health}")
    print(f"{tag} replica 1 silent past {OBS_DEADLINE_S} s: drained, its "
          f"requests {drained} (rid: tokens generated) resumed on replica "
          f"0, every stream identical; health keys {sorted(health)}",
          flush=True)
    del eng, params, model
    return launches


# ------------------------------------- path 14: paged KV, speculative --

def path14_engine_class():
    """The recording engine of the serve paths, also keeping the emitted
    prefix of every request it preempts (rid -> one list a preemption)."""
    Recording = serve_engine_class()

    class Spied(Recording):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.carried = {}

        def _preempt(self, i, *, drain=False):
            s = self.slots[i]
            self.carried.setdefault(s.rid, []).append(list(s.generated))
            return super()._preempt(i, drain=drain)

    return Spied


def path14_run(tag: str, model, params, cfg_kw: dict, requests: list,
               profile: bool = False) -> dict:
    """One graphed engine of path 3's shape over ``requests``, with no EOS
    (every stream runs its 16 new tokens, so the pressure run's schedule
    follows from the prompt lengths alone): its streams,
    stats, logits, step seconds, launches (counts set to 0 just before),
    the graphs' checks and the pool's, recorded; then the engine is
    deleted and the card's allocated memory must be back within
    ``MEM_SLACK_BYTES`` of its value before the engine, with no gc
    pass."""
    import torch

    from repro_torch.serve.engine import ServeConfig

    mem0 = torch.cuda.memory_allocated()
    eng = path14_engine_class()(model, params, ServeConfig(
        max_batch=SERVE_BATCH, max_seq=SERVE_SEQ, eos_id=-1, **cfg_kw),
        profile=profile)
    counters = serve_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    eng.t0 = t0
    eng.submit(requests)
    eng.run_until_done()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = {k: c.launches for k, c in counters.items()}
    st, cc = dict(eng.stats), eng.compile_counts()
    check(len(eng.done) == len(requests) and not eng.failed,
          f"{tag}: {len(eng.done)} done, failed {eng.failed}")
    # launches: path 3's count a prefill launch, decode step or verify
    steps = st["prefill_calls"] + st["decode_steps"]
    want = {k: 0 for k in counted}
    want.update({k: n * steps for k, n in
                 SERVE_PATHS["path3"].per_step(model.cfg.n_layers).items()})
    check(counted == want, f"{tag}: launches {counted}, the path predicts "
                           f"{want}")
    # graphs: captures == compiles, every later launch a replay, and a
    # decode or verify step copies at most DECODE_COPY_BYTES (+ the block
    # table when paged) into its graph
    table = TABLE_COPY_BYTES if eng.paged else 0
    spec = eng._verify_fn is not None
    # a speculative engine's decode launches are its verify launches
    calls = {"prefill": st["prefill_calls"],
             "decode": 0 if spec else st["decode_steps"],
             "verify": st["decode_steps"]}
    # (a comprehension: no local outlives it holding an artifact, whose
    # compile cache holds the engine's graphs and cache)
    stats_of = {kind: fn.graph_stats
                for kind, fn in (("prefill", eng._prefill_fn),
                                 ("decode", eng._decode_fn),
                                 ("verify", eng._verify_fn))
                if fn is not None}
    graphs = {}
    for kind, g in stats_of.items():
        check(g.captures == cc[kind]["total"]
              and g.replays + g.captures == calls[kind],
              f"{tag}: {kind} captures {g.captures} replays {g.replays}, "
              f"compiles {cc[kind]}, calls {calls[kind]}")
        per = g.bytes_in / max(calls[kind], 1)
        if kind != "prefill":
            check(per <= DECODE_COPY_BYTES + table,
                  f"{tag}: a {kind} step copies {per:.0f} B into its graph")
        graphs[kind] = dict(captures=g.captures, replays=g.replays,
                            bytes_in_a_call=round(per, 1))
    out = dict(done=dict(eng.done), stats=st, compiles=cc,
               logits=eng.logits, step_s=eng.step_s, launches=counted,
               profiled=eng.profiled, carried=eng.carried, graphs=graphs,
               pool_bytes=eng.compile_cache.graph_pool.reserved_bytes,
               seconds=seconds)
    if eng.paged:
        try:
            eng.alloc.assert_consistent()
        except AssertionError as e:
            raise PhaseError(f"{tag}: block allocator inconsistent: {e}")
        out["used_blocks"] = eng.alloc.used_blocks
        # the rows a paged step gathers: every slot's max_seq positions of
        # every pool leaf (read once and written once by the gather)
        out["gather_bytes"] = sum(
            leaf.element_size() * leaf.numel() // leaf.shape[1]
            * SERVE_BATCH * (SERVE_SEQ // PATH14_BLOCK)
            for leaf in eng.pool.tree.values())
    dec = eng.step_s["decode"]
    print(f"{tag}: prefill_calls {st['prefill_calls']} decode_steps "
          f"{st['decode_steps']} tokens {st['tokens_generated']} compiles "
          f"{cc} graphs {graphs} launches "
          f"{ {k: v for k, v in counted.items() if v} }; decode ms/step "
          f"median {1e3 * sorted(dec)[len(dec) // 2]:.2f} min "
          f"{1e3 * min(dec):.2f} over {len(dec)} steps; graph pool "
          f"reserved {out['pool_bytes']} B; {seconds:.1f} s", flush=True)
    del eng
    mem = torch.cuda.memory_allocated()
    check(mem <= mem0 + MEM_SLACK_BYTES,
          f"{tag}: {mem - mem0} B still allocated after the engine")
    print(f"{tag}: card memory allocated {mem0} B before the engine, {mem} "
          f"B after it was deleted", flush=True)
    return out


def spec_streams(tag: str, got: dict, ref: dict, exact: bool) -> bool:
    """A speculative run's streams against the plain decode's (``ref`` a
    :func:`path14_run` result): identical where ``exact`` (f32); else a
    stream may part only at a token where the plain run's top-2 margin is
    below ``TOL_SPEC_MARGIN`` (path 3's bf16 rule).  Returns whether every
    stream is identical."""
    agree = {}
    for rid, want in ref["done"].items():
        have = got["done"][rid]
        n = 0
        while n < min(len(have), len(want)) and have[n] == want[n]:
            n += 1
        agree[rid] = n
        if have == want:
            continue
        check(not exact, f"{tag} request {rid}: streams part at token {n}: "
                         f"{have[n:n + 3]} vs {want[n:n + 3]}")
        b = ref["logits"][(rid, n)]
        top = b.topk(2).values
        margin = ((top[0] - top[1]) / b.abs().max()).item()
        check(margin < TOL_SPEC_MARGIN,
              f"{tag} request {rid} parts at token {n} where the plain "
              f"run's top-2 margin is {margin:.3e} >= {TOL_SPEC_MARGIN}")
    same = got["done"] == ref["done"]
    print(f"{tag} vs plain decode: "
          f"{'streams identical' if same else f'agreement {agree}'}",
          flush=True)
    return same


def paged_phase(seed: int, report: dict) -> None:
    """Path 14: paged KV and speculative decoding on path 3's engine
    (TinyLlama-1.1B at full width, path 3's bf16-valued weights, its six
    prompts and 16 new tokens), f32 then bf16, every entry a CUDA graph.
    (a) paged at an unconstrained pool vs fixed rows, (b) pool pressure,
    (c) the n-gram proposer on fixed rows and on the pool, (d) an oracle
    and an adversary proposer, (e) the graphs' checks in every run and
    one traced paged decode step and verify launch, (f) flash attention
    at the verify shape vs its plain version, (g) card memory after every
    run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Request
    from repro_torch.models.registry import get_model

    base = get_config("tinyllama_11b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = get_model(dataclasses.replace(base, dtype="bf16")).init(gen, "cuda")
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, base.vocab, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def requests():
        return [Request(rid=i, tokens=p, max_new_tokens=SERVE_NEW_TOKENS)
                for i, p in enumerate(prompts)]

    paged = {"kv_block_size": PATH14_BLOCK}
    fills = [n + SERVE_NEW_TOKENS // 2 for n in SERVE_PROMPTS[:SERVE_BATCH]]
    for dname in ("f32", "bf16"):
        t_phase = time.perf_counter()
        tag = f"[path14 {dname}]"
        cfg = dataclasses.replace(base, dtype=dname)
        model = get_model(cfg)
        params = to_f32(bf16) if dname == "f32" else bf16
        exact = dname == "f32"
        runs = {}

        def run(label, kw, profile=False):
            runs[label] = path14_run(f"{tag} {label}", model, params, kw,
                                     requests(), profile=profile)
            return runs[label]

        # (a) paged at an unconstrained pool vs fixed rows
        fixed = run("fixed", {})
        pg = run("paged", paged, profile=True)
        check(pg["done"] == fixed["done"],
              f"{tag} (a) paged streams part from the fixed rows'")
        worst = max(rel_err(pg["logits"][key], fixed["logits"][key])
                    for key in fixed["logits"] if key[1] <= 1)
        check(worst <= TOL_PAGED, f"{tag} (a) first-token / first-decode "
                                  f"logits {worst:.3e} > {TOL_PAGED}")
        check(pg["stats"]["kv_preemptions"] == 0
              and pg["stats"]["kv_blocks_in_use"] == 0
              and pg["used_blocks"] == 0,
              f"{tag} (a) preemptions {pg['stats']['kv_preemptions']}, "
              f"blocks in use {pg['stats']['kv_blocks_in_use']}")
        print(f"{tag} (a) paged vs fixed rows: streams identical, "
              f"first-token and first-decode-step logits max|d|/max|ref| "
              f"{worst:.3e}; kv_preemptions 0, blocks in use 0 after, "
              f"allocator consistent; peak occupancy "
              f"{pg['stats']['kv_peak_occupancy']:.4f}", flush=True)

        # (b) pool pressure
        pr = run("pressure", dict(paged, kv_pool_blocks=PATH14_POOL_BLOCKS))
        st = pr["stats"]
        check(st["kv_preemptions"] > 0, f"{tag} (b) no preemption at "
                                        f"{PATH14_POOL_BLOCKS} blocks")
        check(all(len(t) == SERVE_NEW_TOKENS + 1
                  for t in pr["done"].values()),
              f"{tag} (b) stream lengths "
              f"{ {r: len(t) for r, t in pr['done'].items()} }")
        for rid, prefixes in pr["carried"].items():
            for pre in prefixes:
                check(pr["done"][rid][:len(pre)] == pre,
                      f"{tag} (b) request {rid} lost its emitted prefix "
                      f"{pre}")
        check(pr["used_blocks"] == 0, f"{tag} (b) {pr['used_blocks']} "
                                      f"blocks in use after the run")
        same = sum(pr["done"][r] == fixed["done"][r] for r in fixed["done"])
        print(f"{tag} (b) pool of {PATH14_POOL_BLOCKS} blocks: "
              f"kv_preemptions {st['kv_preemptions']} kv_evictions "
              f"{st['kv_evictions']} (preempted {sorted(pr['carried'])}, "
              f"prefixes kept), peak occupancy "
              f"{st['kv_peak_occupancy']:.4f}, every request done at its "
              f"length; {same} of {len(fixed['done'])} streams equal (a)'s",
              flush=True)

        # (c) the n-gram proposer on fixed rows and on the pool
        spec = {"speculative": "ngram", "speculative_k": PATH14_K}
        for label, kw in (("ngram fixed", spec),
                          ("ngram paged", dict(paged, **spec))):
            r = run(label, kw, profile=label == "ngram paged")
            s = r["stats"]
            spec_streams(f"{tag} (c) {label}", r, fixed, exact)
            check(0 <= s["spec_accepted_tokens"] <= s["spec_drafted_tokens"]
                  and s["decode_steps"] <= fixed["stats"]["decode_steps"],
                  f"{tag} (c) {label}: accepted "
                  f"{s['spec_accepted_tokens']} drafted "
                  f"{s['spec_drafted_tokens']}, verify launches "
                  f"{s['decode_steps']} vs decode steps "
                  f"{fixed['stats']['decode_steps']}")

        # (d) an oracle drafting the plain run's own next tokens, and an
        # adversary drafting each of them + 1
        by_prompt = {tuple(p): fixed["done"][i]
                     for i, p in enumerate(prompts)}
        vocab = cfg.vocab

        class Oracle:
            def propose(self, history, k):
                for prompt, stream in by_prompt.items():
                    if tuple(history[:len(prompt)]) == prompt:
                        n = len(history) - len(prompt)
                        return np.asarray(stream[n:n + k], np.int32)
                raise PhaseError(f"{tag} (d) a history of no prompt")

        class Adversary(Oracle):
            def propose(self, history, k):
                return (super().propose(history, k) + 1) % vocab

        for label, kw in (("oracle paged", dict(paged, speculative=Oracle(),
                                                speculative_k=PATH14_K)),
                          ("adversary fixed", dict(speculative=Adversary(),
                                                   speculative_k=PATH14_K))):
            r = run(label, kw)
            s = r["stats"]
            same = spec_streams(f"{tag} (d) {label}", r, fixed, exact)
            if label.startswith("oracle"):
                check(not same or s["spec_accepted_tokens"]
                      == s["spec_drafted_tokens"] > 0,
                      f"{tag} (d) oracle: accepted "
                      f"{s['spec_accepted_tokens']} of "
                      f"{s['spec_drafted_tokens']} drafted")
            else:
                check(s["spec_drafted_tokens"] > 0
                      and s["spec_accepted_tokens"] == 0,
                      f"{tag} (d) adversary: accepted "
                      f"{s['spec_accepted_tokens']} of "
                      f"{s['spec_drafted_tokens']} drafted")
            print(f"{tag} (d) {label}: drafted {s['spec_drafted_tokens']} "
                  f"accepted {s['spec_accepted_tokens']}, verify launches "
                  f"{s['decode_steps']} (~ceil(16 / (k + 1)) = "
                  f"{-(-SERVE_NEW_TOKENS // (PATH14_K + 1))} a request "
                  f"when every draft is right)", flush=True)

        # (e) one traced paged decode step and one traced verify launch,
        # each at path 3's counts
        step = SERVE_PATHS["path3"].per_step(cfg.n_layers)
        for label in ("paged", "ngram paged"):
            kind = "verify launch" if "ngram" in label else "decode step"
            check(bool(runs[label]["profiled"]),
                  f"{tag} (e) {label}: no {kind} was traced")
            wall, busy, top, seen = runs[label]["profiled"]
            ran = {k: seen[k] for k in step}
            if busy is not None:
                check(ran == step, f"{tag} (e) the traced {kind} ran "
                                   f"{ran}, the path predicts {step}")
            print(f"{tag} (e) one traced {label} {kind}: wall {wall:.3f} "
                  f"ms, device busy "
                  f"{'not measured' if busy is None else f'{busy:.3f}'} "
                  f"ms; ran the port's kernels {ran}; most device time "
                  f"{top}", flush=True)

        # the printed numbers
        def med(label):
            d = runs[label]["step_s"]["decode"]
            return 1e3 * sorted(d)[len(d) // 2]

        acc = {}
        for label in ("ngram fixed", "ngram paged", "oracle paged",
                      "adversary fixed"):
            s = runs[label]["stats"]
            acc[label] = dict(
                accept_rate=round(s["spec_accepted_tokens"]
                                  / max(s["spec_drafted_tokens"], 1), 4),
                # the tokens after each prompt's first, a verify launch
                tokens_a_launch=round(
                    (s["tokens_generated"] - len(prompts))
                    / max(s["decode_steps"], 1), 4),
                verify_ms_median=round(med(label), 3))
        gb = pg["gather_bytes"]
        print(f"{tag} decode ms/step median: paged {med('paged'):.3f}, "
              f"fixed {med('fixed'):.3f}; pressure {med('pressure'):.3f}; "
              f"speculative {acc}; gather bytes a paged step {gb} read + "
              f"{gb} written ({2 * gb / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"3.35 TB/s); graph pool reserved: fixed "
              f"{fixed['pool_bytes']} B, paged {pg['pool_bytes']} B, ngram "
              f"paged {runs['ngram paged']['pool_bytes']} B", flush=True)
        launches = dict.fromkeys(serve_counters(), 0)
        for r in runs.values():
            for k, n in r["launches"].items():
                launches[k] += n
        report[("path14", dname)] = dict(launches=launches)
        # flash attention's launches at the verify shape: a verify launch
        # runs it once a layer
        at_verify = cfg.n_layers * sum(
            runs[label]["stats"]["decode_steps"]
            for label in ("ngram fixed", "ngram paged", "oracle paged",
                          "adversary fixed"))
        del runs, pg, fixed, pr, params
        torch.cuda.empty_cache()

        # (f) flash attention at the verify shape vs its plain version
        verify_kernel_rows(cfg, dname, fills, at_verify)
        print(f"[phase path14 {dname}] {time.perf_counter() - t_phase:.1f} "
              f"s (target under 90 s)", flush=True)
    del bf16
    torch.cuda.empty_cache()


def verify_kernel_rows(cfg, dname: str, fills, launches: int) -> None:
    """Flash attention at a verify launch's shape: B = 4 rows of k + 1 = 5
    queries at ``q_offset`` = the rows' fills, causal against the
    2048-row cache (``lens=None``), against its plain version on the same
    card inputs, timed beside ``F.scaled_dot_product_attention``; rows of
    ``lens`` 0 must give 0.  ``launches``: the path's launches at this
    shape."""
    import torch
    import torch.nn.functional as F

    dt = torch.float32 if dname == "f32" else torch.bfloat16
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(19)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    w = PATH14_K + 1
    q = rnd(SERVE_BATCH, w, h, hd).transpose(1, 2)
    k, v = (rnd(SERVE_BATCH, hkv, SERVE_SEQ, hd) for _ in range(2))
    qo = torch.tensor(fills, dtype=torch.int32, device="cuda")
    keys = torch.arange(SERVE_SEQ, device="cuda")
    mask = (keys[None, None, :] <= (qo[:, None] + torch.arange(
        w, device="cuda")[None, :])[:, :, None])[:, None]
    case = dict(
        form="verify", label=f"verify B={SERVE_BATCH} S={w} q_offset={fills}",
        q=q, k=k, v=v, args=dict(lens=None, causal=True, q_offset=qo),
        kv_rows=sum(f + w for f in fills),
        pairs=sum(f + i + 1 for f in fills for i in range(w)),
        lib=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   enable_gqa=True),
        zero_check=(q, k, v, dict(lens=torch.tensor(
            [SERVE_SEQ, 0, SERVE_SEQ, 0], dtype=torch.int32, device="cuda"),
            causal=True, q_offset=qo), [1, 3]))
    # printed, not a candidate for the kernels line, where flash
    # attention's row stays the prefill at S = 2048 of the earlier paths
    flash_rows([case], dname, hkv, launches, [])


def train_launches() -> dict:
    """The launch counters of the two kernels a TinyLlama train step runs."""
    return {k: c for k, c in serve_counters().items()
            if k in ("flash_attention", "rmsnorm")}


def state_leaves(tree) -> list:
    """The tensor leaves of a port tree (params, grads, a train state) in
    the reference's order."""
    from repro_torch.optim.adamw import tree_leaves as leaves

    return leaves(tree)


def train_inputs(cfg, b: int, s: int, seed: int, step: int = 0) -> dict:
    """``SyntheticLMStream``'s batch ``step`` on the card."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMStream

    stream = SyntheticLMStream(vocab=cfg.vocab, batch=b, seq_len=s,
                               seed=seed)
    return {k: torch.from_numpy(v).cuda()
            for k, v in stream.batch_at(step).items()}


def through_helper(t) -> bool:
    """True when ``t``'s graph reaches ``kernels/grad.py``'s node within
    a view or two (the softmax wrapper reshapes its rows back)."""
    fns = [t.grad_fn]
    for _ in range(3):
        if any(type(f).__name__ == "PlainGradBackward" for f in fns):
            return True
        fns = [n for f in fns if f is not None for n, _ in f.next_functions]
    return False


def train_phase(seed: int, report: dict) -> None:
    """Path 15: training on one card (the module docstring's phase 23),
    (a) to (h), and the phase's seconds."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    base = get_config("tinyllama_11b")
    cut = {d: dataclasses.replace(base, n_layers=PATH15_CUT_LAYERS, dtype=d)
           for d in ("f32", "bf16")}
    state, model, tcfg, b = train_full_width(base, seed, report)
    train_profile(model, tcfg, state, base, b, seed)
    del state
    torch.cuda.empty_cache()
    train_kernels_vs_plain(cut["f32"], seed)
    train_accuracy(dataclasses.replace(base, dtype="bf16"), seed)
    train_learning(cut["f32"], seed)
    train_checkpoint(cut["bf16"], seed)
    train_options(cut["f32"], seed)
    train_grad_phase(base, seed)
    torch.cuda.empty_cache()
    used = torch.cuda.memory_allocated()
    print(f"[path15] card memory allocated after the path: {used} B",
          flush=True)
    print(f"[phase path15] {time.perf_counter() - t_phase:.1f} s (target "
          f"about 120 s)", flush=True)


def train_full_width(base, seed: int, report: dict):
    """(a) TinyLlama-1.1B at all 22 layers in bf16 through
    ``launch/train.py``'s ``run``: 5 steps of B x 2048 tokens (B = 4,
    halved while the card runs out of memory), f32 AdamW state.  Returns
    the trained state, the model, its train config and B, for (h)."""
    import statistics

    import torch

    from repro_torch.launch import train as launcher
    from repro_torch.train.step import TrainConfig

    b = PATH15_BATCH
    while True:
        args = launcher.parser().parse_args(
            ["--arch", "tinyllama_11b", "--steps", str(PATH15_STEPS),
             "--batch", str(b), "--seq", str(PATH15_SEQ), "--warmup", "2",
             "--seed", str(seed)])
        counters = train_launches()
        for c in counters.values():
            c.reset()
        try:
            out = launcher.run(args)
        except torch.cuda.OutOfMemoryError:
            out = None
        if out is not None:
            break
        torch.cuda.empty_cache()
        check(b > 1, "path15 (a): B = 1 does not fit the card")
        b //= 2
        print(f"[path15 bf16 22L] B = {2 * b} did not fit the card: "
              f"halved to B = {b}", flush=True)
    launches = {k: c.launches for k, c in counters.items()}
    tag = f"[path15 bf16 {base.n_layers}L]"
    steps = PATH15_STEPS
    check(launches == {"flash_attention": base.n_layers * steps,
                       "rmsnorm": (2 * base.n_layers + 1) * steps},
          f"{tag} launches {launches}, want {base.n_layers} flash "
          f"attention and {2 * base.n_layers + 1} RMSNorm a step")
    report[("path15", "bf16")] = dict(launches=launches)
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"{tag} losses {out['losses']}, grad norms {out['grad_norms']}")
    state, model = out["state"], out["model"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = model.init(gen, "cuda")
    changed = finite = 0
    leaves = state_leaves(state.params)
    for p, p0 in zip(leaves, state_leaves(init)):
        changed += int(not torch.equal(p, p0))
        finite += int(bool(torch.isfinite(p).all()))
    del init
    check(changed == finite == len(leaves),
          f"{tag} of {len(leaves)} parameter leaves {changed} changed, "
          f"{finite} finite")
    ms = 1e3 * statistics.median(out["step_seconds"][1:])
    tokens = b * PATH15_SEQ
    print(f"{tag} B={b} S={PATH15_SEQ}: ms/step median of steps 2-"
          f"{steps} {ms:.1f} (steps {[round(1e3 * t, 1) for t in out['step_seconds']]}), "
          f"tokens/s {tokens / ms * 1e3:.0f}, peak memory "
          f"{out['peak_bytes']} B ({out['peak_bytes'] / 2**30:.2f} GiB); "
          f"losses {[round(x, 4) for x in out['losses']]}; grad norms "
          f"{[round(x, 4) for x in out['grad_norms']]}; launches "
          f"{launches} ({base.n_layers} / {2 * base.n_layers + 1} a step); "
          f"{changed} of {len(leaves)} leaves changed, all finite",
          flush=True)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=steps)
    return state, model, tcfg, b


def train_profile(model, tcfg, state, cfg, b: int, seed: int) -> None:
    """(h) One more bf16 step of (a) under ``torch.profiler``: its wall ms
    and the card's busy ms split into the forward kernels (flash
    attention, RMSNorm), the plain versions' backward recompute (the
    ``plain_grad_recompute`` range of ``kernels/grad.py``, its GEMMs
    included), cuBLAS (every other GEMM: the projections and the head,
    forward and backward), the AdamW passes (the ``train_step.update``
    range) and the rest (elementwise, the loss, the embedding's
    backward)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.step import make_train_step

    step = make_train_step(model, tcfg)
    batch = train_inputs(cfg, b, PATH15_SEQ, seed, PATH15_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    ours = "|".join(TRACE_KERNELS[k] for k in ("flash_attention", "rmsnorm"))
    gemm = re.compile(r"gemm|nvjet|cutlass|xmma|cublas", re.I)
    split = dict.fromkeys(("forward kernels", "plain backward recompute",
                           "cuBLAS", "AdamW", "other"), 0.0)
    linked = 0

    def ranges(e):
        names = set()
        while e is not None:
            names.add(e.name)
            e = e.cpu_parent
        return names

    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        linked += len(e.kernels)
        up = ranges(e)
        for k in e.kernels:
            ms = k.duration / 1e3
            if re.search(ours, k.name):
                split["forward kernels"] += ms
            elif "plain_grad_recompute" in up:
                split["plain backward recompute"] += ms
            elif "train_step.update" in up:
                split["AdamW"] += ms
            elif gemm.search(k.name):
                split["cuBLAS"] += ms
            else:
                split["other"] += ms
    # the card's own events: kernels and copies, not the spans the
    # profiler draws on the card for a host range (record_function)
    spans = {"plain_grad_recompute", "train_step.update"}
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in spans
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")) / 1e3
    tag = f"[path15 bf16 {cfg.n_layers}L traced step]"
    check(linked, f"{tag} wall {wall:.1f} ms, device busy {busy:.1f} ms: "
          f"the trace links no kernel to its operator, so no split")
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in split.items())
    print(f"{tag} wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}% of wall), of it {parts}; "
          f"{sum(split.values()):.1f} ms linked to an operator", flush=True)
    check(math.isfinite(float(metrics["loss"])), f"{tag} loss not finite")


def train_params(cfg, seed: int):
    import torch

    from repro_torch.models.registry import get_model

    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return model, model.init(gen, "cuda")


def train_kernels_vs_plain(cfg, seed: int) -> None:
    """(b) One step's loss and gradients at 2 layers, full width, f32,
    B = 2, S = 2048, with the kernels and inside ``plain_versions()``."""
    from repro_torch.kernels.select import plain_versions
    from repro_torch.train.step import value_and_grad

    model, params = train_params(cfg, seed)
    batch = train_inputs(cfg, 2, PATH15_SEQ, seed)
    counters = train_launches()
    before = {k: c.launches for k, c in counters.items()}
    loss, grads = value_and_grad(model.loss, params, batch)
    ran = {k: c.launches - before[k] for k, c in counters.items()}
    with plain_versions():
        ploss, pgrads = value_and_grad(model.loss, params, batch)
    tag = f"[path15 f32 {cfg.n_layers}L]"
    check(ran == {"flash_attention": cfg.n_layers,
                  "rmsnorm": 2 * cfg.n_layers + 1},
          f"{tag} kernel launches {ran}")
    e_loss = abs(float(loss) - float(ploss)) / abs(float(ploss))
    errs = [rel_err(g.float(), p.float())
            for g, p in zip(state_leaves(grads), state_leaves(pgrads))]
    worst = max(errs)
    print(f"{tag} kernels vs plain versions, B=2 S={PATH15_SEQ}: loss "
          f"{float(loss):.6f} vs {float(ploss):.6f} (rel {e_loss:.2e}, "
          f"limit {TOL_TRAIN_LOSS}); grad leaves max|d|/max|ref| worst "
          f"{worst:.2e} of {len(errs)} (limit {TOL_TRAIN_GRAD}); launches "
          f"{ran}", flush=True)
    check(e_loss <= TOL_TRAIN_LOSS, f"{tag} loss rel {e_loss:.2e}")
    check(worst <= TOL_TRAIN_GRAD, f"{tag} grad leaf rel {worst:.2e}")


def token_losses(model, params, batch):
    """Each token's f32 cross entropy (the terms the loss averages), no
    grad."""
    import torch

    with torch.no_grad():
        logits = model.forward(params, batch).float()
        gold = torch.gather(logits, -1, batch["labels"][..., None].long())
        return torch.logsumexp(logits, -1) - gold[..., 0]


def train_accuracy(cfg, seed: int) -> None:
    """(c) One bf16 step at all 22 layers, B = 1, S = 2048, with the
    kernels and with the plain versions, each against the same step in
    f32 over the upcast weights (plain versions), at ``PATH15_ACC_SEEDS``
    seeds (weights and batch), each held: the kernels' gradient (all
    leaves as one vector, relative L2 distance) and 2048 tokens' losses
    (relative L2 distance) at most ``ACCURACY_RATIO`` times as far from
    it as the plain versions'; the kernels' mean loss (the tokens'
    mean) within ``ACC_MEAN_SE`` standard errors of that mean of the
    f32 one, so no bias beyond the tokens' rounding noise (a mean of
    2048 terms of either sign, its distance alone is that noise's luck:
    each seed prints both paths' signed distances)."""
    import torch

    from repro_torch.kernels.select import plain_versions
    from repro_torch.train.step import value_and_grad

    tag = f"[path15 bf16 {cfg.n_layers}L accuracy]"
    for s in range(seed, seed + PATH15_ACC_SEEDS):
        model, params = train_params(cfg, s)
        batch = train_inputs(cfg, 1, PATH15_SEQ, s)
        with plain_versions():
            p32 = to_f32(params)
            ref_loss, ref = value_and_grad(model.loss, p32, batch)
            ref_tokens = token_losses(model, p32, batch)
            del p32
        ref = [g.float() for g in state_leaves(ref)]
        norm = math.sqrt(sum(float(g.square().sum()) for g in ref))
        out = {}
        for label in ("kernels", "plain"):
            ctx = (plain_versions() if label == "plain"
                   else contextlib.nullcontext())
            with ctx:
                loss, grads = value_and_grad(model.loss, params, batch)
                tokens = token_losses(model, params, batch)
            dist = math.sqrt(sum(float((g.float() - r).square().sum())
                                 for g, r in zip(state_leaves(grads), ref)))
            d = (tokens - ref_tokens).flatten().double()
            out[label] = dict(
                grad=dist / norm,
                tokens=float((tokens - ref_tokens).norm()
                             / ref_tokens.norm()),
                loss=float(loss) - float(ref_loss), mean=float(d.mean()),
                se=float(d.std() / math.sqrt(d.numel())))
            del grads
        k, p = out["kernels"], out["plain"]
        z = abs(k["mean"]) / k["se"]
        print(f"{tag} seed {s} B=1 S={PATH15_SEQ}, against the f32 step "
              f"(loss {float(ref_loss):.6f}): gradient rel L2 kernels "
              f"{k['grad']:.3e} plain {p['grad']:.3e} (ratio "
              f"{k['grad'] / p['grad']:.3f}); token losses rel L2 kernels "
              f"{k['tokens']:.3e} plain {p['tokens']:.3e} (ratio "
              f"{k['tokens'] / p['tokens']:.3f}); limit {ACCURACY_RATIO}; "
              f"mean loss - f32: kernels {k['loss']:+.3e} (tokens' mean "
              f"{k['mean']:+.3e}, standard error {k['se']:.3e}, {z:.2f} SE, "
              f"limit {ACC_MEAN_SE}) plain {p['loss']:+.3e} (tokens' mean "
              f"{p['mean']:+.3e}, standard error {p['se']:.3e}, "
              f"{abs(p['mean']) / p['se']:.2f} SE)", flush=True)
        check(k["grad"] <= ACCURACY_RATIO * p["grad"]
              and k["tokens"] <= ACCURACY_RATIO * p["tokens"],
              f"{tag} seed {s}: kernels further from f32 than "
              f"{ACCURACY_RATIO} x the plain versions")
        check(z <= ACC_MEAN_SE, f"{tag} seed {s}: the kernels' mean loss "
              f"{z:.2f} standard errors from the f32 one")
        del model, params, ref, ref_tokens
        torch.cuda.empty_cache()


def train_learning(cfg, seed: int) -> None:
    """(d) 20 steps at 2 layers, f32, B = 2, S = 2048 on the stream's
    batches 0-19: the mean of the last 5 losses must lie below the
    first."""
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        train_state_for)

    model, params = train_params(cfg, seed)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=PATH15_LEARN)
    state = train_state_for(params, tcfg)
    step = make_train_step(model, tcfg)
    losses = []
    for i in range(PATH15_LEARN):
        state, metrics = step(state, train_inputs(cfg, 2, PATH15_SEQ, seed,
                                                  i))
        losses.append(float(metrics["loss"]))
    tail = sum(losses[-5:]) / 5
    print(f"[path15 f32 {cfg.n_layers}L learning] losses "
          f"{[round(x, 4) for x in losses]}: mean of the last 5 {tail:.4f} "
          f"vs the first {losses[0]:.4f}", flush=True)
    check(all(map(math.isfinite, losses)) and tail < losses[0],
          f"[path15 learning] the last 5 losses' mean {tail} not below the "
          f"first {losses[0]}")


def train_checkpoint(cfg, seed: int) -> None:
    """(e) 3 steps at 2 layers in bf16 (f32 AdamW state), saved at step 3
    by a writer thread under ``build/``, restored into a fresh state:
    every leaf equal bit for bit; then one step from each, losses within
    ``TOL_CKPT_LOSS`` (the embedding's backward adds with atomics, so the
    bits of the update may differ, not the forward's loss)."""
    import shutil

    import torch

    from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                        wait_for_writers)
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        train_state_for)

    model, params = train_params(cfg, seed)
    tcfg = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    state = train_state_for(params, tcfg)
    step = make_train_step(model, tcfg)
    for i in range(3):
        state, _ = step(state, train_inputs(cfg, 2, PATH15_SEQ, seed, i))
    ckpt = ROOT / "build" / "path15_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_checkpoint(ckpt, 3, state, journal={"data_step": 3},
                    blocking=False)
    staged = time.perf_counter() - t
    wait_for_writers()
    written = time.perf_counter() - t
    _, fresh = train_params(cfg, seed + 1)
    like = train_state_for(fresh, tcfg)
    t = time.perf_counter()
    restored, journal = restore_checkpoint(ckpt, like)
    torch.cuda.synchronize()
    read = time.perf_counter() - t
    a, b = state_leaves(list(state)), state_leaves(list(restored))
    same = sum(int(x.dtype == y.dtype and x.device == y.device
                   and torch.equal(x, y)) for x, y in zip(a, b))
    batch = train_inputs(cfg, 2, PATH15_SEQ, seed, 3)
    _, m1 = step(state, batch)
    _, m2 = step(restored, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    e = abs(l1 - l2) / abs(l1)
    size = sum(p.stat().st_size for p in ckpt.rglob("*") if p.is_file())
    shutil.rmtree(ckpt, ignore_errors=True)
    tag = f"[path15 bf16 {cfg.n_layers}L checkpoint]"
    print(f"{tag} {size} B: save {staged:.2f} s staged + written by "
          f"{written:.2f} s, restore {read:.2f} s; {same} of {len(a)} leaves "
          f"equal bit for bit; journal {journal}; next step's loss "
          f"{l1:.6f} vs restored {l2:.6f} (rel {e:.2e}, limit "
          f"{TOL_CKPT_LOSS})", flush=True)
    check(same == len(a) == len(b) and journal == {"data_step": 3},
          f"{tag} {same} of {len(a)} leaves restored equal")
    check(e <= TOL_CKPT_LOSS, f"{tag} loss rel {e:.2e}")


def train_options(cfg, seed: int) -> None:
    """(f) One step with ``microbatches=2`` and one with
    ``grad_compression="bf16"`` at 2 layers, f32, B = 2, S = 2048, from
    the same weights, beside the plain step."""
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        train_state_for)

    batch = train_inputs(cfg, 2, PATH15_SEQ, seed)
    losses = {}
    for label, kw in (("unbatched", {}), ("microbatches=2",
                                          dict(microbatches=2)),
                      ("grad_compression=bf16",
                       dict(grad_compression="bf16"))):
        model, params = train_params(cfg, seed)
        tcfg = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10, **kw)
        state, metrics = make_train_step(model, tcfg)(
            train_state_for(params, tcfg), batch)
        losses[label] = float(metrics["loss"])
        del state, params
    mb = losses["microbatches=2"]
    print(f"[path15 f32 {cfg.n_layers}L options] losses {losses}; "
          f"microbatched vs unbatched rel "
          f"{abs(mb - losses['unbatched']) / abs(losses['unbatched']):.2e}",
          flush=True)
    check(all(map(math.isfinite, losses.values())),
          f"[path15 options] losses {losses}")


def train_grad_cases(cfg) -> list:
    """(name, wrapper call, inputs) at one card shape of each of the six
    model-layer wrappers: TinyLlama's widths, the MoE router (2048 x 16),
    WKV (RWKV-6 3B's 40 heads) and SSD (Zamba2-7B's 112 heads) at T =
    512."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.layernorm import ops as ln
    from repro_torch.kernels.mamba2 import ops as ssd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.kernels.softmax import ops as sm

    gen = torch.Generator(device="cuda").manual_seed(23)
    bf = torch.bfloat16

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(dtype).requires_grad_()

    def decay(*shape):
        x = torch.rand(shape, generator=gen, device="cuda") * 0.5 + 0.45
        return x.requires_grad_()

    d, s, t = cfg.d_model, PATH15_SEQ, 512
    return [
        ("rmsnorm", rms, lambda a: rms.rmsnorm(a[0], a[1], eps=1e-6),
         [rnd(1, s, d, dtype=bf), rnd(d)]),
        ("layernorm", ln, lambda a: ln.layernorm(a[0], a[1], a[2], eps=1e-5),
         [rnd(1, s, d, dtype=bf), rnd(d), rnd(d)]),
        ("flash_attention", fa,
         lambda a: fa.flash_attention(a[0], a[1], a[2], None, causal=True),
         [rnd(1, cfg.n_heads, s, cfg.hd, dtype=bf),
          rnd(1, cfg.n_kv_heads, s, cfg.hd, dtype=bf),
          rnd(1, cfg.n_kv_heads, s, cfg.hd, dtype=bf)]),
        ("masked_softmax", sm, lambda a: sm.masked_softmax(a[0], 16),
         [rnd(s, 16)]),
        ("rwkv6", wkv, lambda a: wkv.rwkv6(*a)[0],
         [rnd(1, 40, t, 64, scale=0.5), rnd(1, 40, t, 64, scale=0.5),
          rnd(1, 40, t, 64), decay(1, 40, t, 64), rnd(40, 64, scale=0.1)]),
        ("mamba2", ssd, lambda a: ssd.mamba2_scan(*a)[0],
         [rnd(1, 112, t, 64, dtype=bf), decay(1, 112, t),
          rnd(1, t, 64, dtype=bf, scale=0.3),
          rnd(1, t, 64, dtype=bf, scale=0.3)]),
    ]


def train_grad_phase(cfg, seed: int) -> None:
    """(g) Each of the six model-layer wrappers called on card inputs that
    require grad: the output carries ``kernels/grad.py``'s ``grad_fn``,
    its values equal the kernel's without grad bit for bit, one launch is
    counted (none by the backward), and ``torch.autograd.grad`` equals
    the plain version's own gradient at the same inputs bit for bit."""
    import torch

    from repro_torch.kernels.select import plain_versions

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    for name, ops, call, inputs in train_grad_cases(cfg):
        n = [ops.LAUNCHES.launches]
        out = call(inputs)
        n.append(ops.LAUNCHES.launches)
        with torch.no_grad():
            nograd = call([x.detach() for x in inputs])
        n.append(ops.LAUNCHES.launches)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(
            out.dtype)
        got = torch.autograd.grad(out, inputs, g)
        n.append(ops.LAUNCHES.launches)
        leaves = [x.detach().requires_grad_() for x in inputs]
        with plain_versions():
            want = torch.autograd.grad(call(leaves), leaves, g)
        n.append(ops.LAUNCHES.launches)
        # forward, without grad, backward, the plain version's own
        ran = tuple(b - a for a, b in zip(n, n[1:]))
        helper = through_helper(out)
        same_values = torch.equal(out.detach(), nograd)
        same_grads = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"[path15 grad {name}] inputs "
              f"{[tuple(x.shape) for x in inputs]}: grad_fn "
              f"{type(out.grad_fn).__name__} (reaches the helper's: "
              f"{helper}); values == the kernel's without grad: "
              f"{same_values}; grads == the plain version's: {same_grads}; "
              f"launches forward, without grad, backward, plain {ran}",
              flush=True)
        check(helper and same_values and all(same_grads)
              and ran == (1, 1, 0, 0),
              f"[path15 grad {name}] helper {helper}, values "
              f"{same_values}, grads {same_grads}, launches {ran}")


def print_resources() -> None:
    """The SSD, masked softmax, RMSNorm and LayerNorm instances' resources
    (``cuobjdump``), checked where the toolkit has it."""
    for name, fn in (("SSD", ssd_resources),
                     ("masked softmax", softmax_resources),
                     ("RMSNorm", lambda: norm_resources("rmsnorm")),
                     ("LayerNorm", lambda: norm_resources("layernorm"))):
        try:
            res = fn()
        except (OSError, subprocess.SubprocessError) as e:
            res = f"not available ({e})"
        print(f"[build] {name} instances: {res}", flush=True)


# ------------------------------------- path 16: a one-rank mesh ---------

#: path 16 (a): requests of the token-major stack, the cut depth of its
#: fsdp / tp / "T"-on-"data" runs, the profiles held at full depth
PATH16_REQUESTS = (37, 1999)
PATH16_CUT_LAYERS = 2
PATH16_FULL_PROFILES = ("dp",)
PATH16_CUT_PROFILES = ("fsdp", "tp", "tokens")
#: (a) the meshed runs against the run without a mesh, max|d|/max|ref|
TOL_MESH = {"f32": 1e-6, "bf16": 8e-3}
#: (b) the prompts of path 3 its engines serve; (c) DBRX's depth, its
#: prompts and new tokens (its rule reads the first token)
PATH16_PROMPTS = 4
PATH16_DBRX_LAYERS = 2
PATH16_DBRX_PROMPTS = (37, 200, 731, 45)
PATH16_DBRX_NEW = 4
#: (d) the tp ways whose local shapes the kernel rows take
PATH16_WAYS = (2, 4)


def cluster_counters() -> dict:
    """The launch counters of the cluster kernels, by kernel name."""
    from repro_torch.kernels.fused_elementwise import ops as fe
    from repro_torch.kernels.fused_reduce import ops as fr
    from repro_torch.kernels.matmul import ops as mm

    return {"fused_elementwise": fe.LAUNCHES, "fused_reduce": fr.LAUNCHES,
            "matmul_epilogue": mm.EPILOGUE_LAUNCHES}


def token_major_args_fn(cfg, params):
    """Path 2's token-major stack with its weights taken as arguments
    (``params`` flattened, then x): closed-over weights would be graph
    constants, which no profile lays out."""
    import torch
    from torch.utils import _pytree

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    _, spec = _pytree.tree_flatten(params)

    def fn(*args):
        p = _pytree.tree_unflatten(list(args[:-1]), spec)
        x = args[-1]
        pos = torch.arange(x.shape[0], dtype=torch.int32,
                           device=x.device)[None, :]
        for bp in p["blocks"]:
            h = L.norm_apply(cfg, bp["ln1"], x)
            a, _ = L.attn_apply(cfg, bp["attn"], h[None], positions=pos)
            x = x + a[0]
            x = x + L.mlp_apply(cfg, bp["ffn"],
                                L.norm_apply(cfg, bp["ln2"], x))
        return T.logits_from_hidden(cfg, p, L.norm_apply(cfg, p["ln_f"], x))

    return fn


def mesh_phase(seed: int, report: dict) -> None:
    """Path 16 (the module docstring's phase 24), (a) to (d), in a
    one-rank NCCL group destroyed at its end, and the phase's seconds."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    check(not dist.is_initialized(),
          "path16: a process group is already initialized")
    mesh2 = make_mesh((1, 1), ("data", "model"))
    mesh1 = make_mesh((1,), ("data",))
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"path16: a {dist.get_backend()} group of "
          f"{dist.get_world_size()} ranks, not one-rank NCCL")
    print(f"[path16] one-rank {dist.get_backend()} group; meshes "
          f"{mesh2} and {mesh1}", flush=True)
    try:
        mesh_compile_phase(mesh2, seed, report)
        mesh_serve_phase(mesh1, mesh2, seed, report)
        mesh_dbrx_phase(mesh2, seed, report)
        mesh_kernel_rows(mesh_kdot_calls(seed), report)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "path16: the group outlived the path")
    print(f"[phase path16] {time.perf_counter() - t_phase:.1f} s (target "
          f"about 90 s)", flush=True)


def mesh_compile_phase(mesh, seed: int, report: dict) -> None:
    """(a) the token-major stack under each profile against the same
    stack compiled without a mesh."""
    import dataclasses

    import torch
    from torch.utils import _pytree

    import disc_torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    base = get_config("tinyllama_11b")
    tokens = disc_torch.get_profile("dp").replace(
        name="tokens", dim_axes=(("T", ("data",)),))
    counters = cluster_counters()
    for dname in ("f32", "bf16"):
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        for layers, profiles in ((base.n_layers, PATH16_FULL_PROFILES),
                                 (PATH16_CUT_LAYERS, PATH16_CUT_PROFILES)):
            cfg = dataclasses.replace(base, n_layers=layers, dtype=dname)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            params = T.init(cfg, gen, "cuda")
            ws, _ = _pytree.tree_flatten(params)
            fn = token_major_args_fn(cfg, params)
            specs = [(tuple(w.shape), w.dtype) for w in ws] + [
                ((disc_torch.Dim("T", max=2048), cfg.d_model), dt)]
            xs = {t: torch.randn((t, cfg.d_model), generator=gen,
                                 device="cuda").to(dt)
                  for t in PATH16_REQUESTS}

            def run(tag, **opts):
                t0 = time.perf_counter()
                f = disc_torch.compile(fn, specs=specs,
                                       options=disc_torch.CompileOptions(
                                           backend="hopper", **opts))
                lower_s = time.perf_counter() - t0
                for c in counters.values():
                    c.reset()
                outs = {t: f(*ws, x) for t, x in xs.items()}
                torch.cuda.synchronize()
                launched = {k: c.launches for k, c in counters.items()}
                rep = f.report()
                print(f"[path16 (a) {dname} {layers}L {tag}] lowered in "
                      f"{lower_s:.2f} s, {len(ws)} weight arguments; "
                      f"{time.perf_counter() - t0:.2f} s with the "
                      f"requests; compiles={rep['compiles']} "
                      f"captures={rep['graphs']['captures']} "
                      f"launches={launched}", flush=True)
                check(rep["graphs"]["captures"] == rep["compiles"]["total"]
                      == len(PATH16_REQUESTS),
                      f"path16 (a) {dname} {tag}: {rep['graphs']['captures']}"
                      f" captures for {rep['compiles']} compiles")
                return f, outs, launched, rep

            _, ref, ref_launched, _ = run("no mesh")
            for prof in profiles:
                f, outs, launched, rep = run(
                    prof, mesh=mesh,
                    sharding_profile=tokens if prof == "tokens" else prof)
                tag = f"path16 (a) {dname} {layers}L {prof}"
                for t in PATH16_REQUESTS:
                    got, want = outs[t], ref[t]
                    check(got.shape == want.shape
                          and bool(torch.isfinite(got).all()),
                          f"{tag} T={t}: shape {tuple(got.shape)} or "
                          f"non-finite")
                    err = rel_err(got.float(), want.float())
                    print(f"[{tag}] T={t} max|d|/max|ref| {err:.3e} "
                          f"(bit-equal: {bool(torch.equal(got, want))})",
                          flush=True)
                    if prof == "dp":
                        check(bool(torch.equal(got, want)),
                              f"{tag} T={t}: not bit-equal to the run "
                              f"without a mesh")
                    check(err <= TOL_MESH[dname],
                          f"{tag} T={t}: {err:.3e} > {TOL_MESH[dname]}")
                check(launched == ref_launched,
                      f"{tag}: launches {launched} where the run without a "
                      f"mesh made {ref_launched}")
                print(f"[{tag}] report sharding: "
                      f"{json.dumps(rep['sharding'])}; placement "
                      f"{rep['placement']['device_target']}", flush=True)
                report[("path16", dname, f"a {layers}L {prof}")] = {
                    "launches": launched}
            del params, ws, fn, xs, ref
            torch.cuda.empty_cache()


def mesh_serve_phase(mesh1, mesh2, seed: int, report: dict) -> None:
    """(b) path 3's engine without a mesh, under dp and under tp."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Request
    from repro_torch.models.registry import get_model

    runs_kw = (("no mesh", {}),
               ("dp (1,)", {"mesh": mesh1, "sharding_profile": "dp"}),
               ("tp (1, 1)", {"mesh": mesh2, "sharding_profile": "tp"}))
    for dname in ("f32", "bf16"):
        cfg = dataclasses.replace(get_config("tinyllama_11b"), dtype=dname)
        model = get_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = get_model(dataclasses.replace(cfg, dtype="bf16")).init(
            gen, "cuda")
        if dname == "f32":
            upcast_in_place(params)
        rs = np.random.RandomState(seed)
        prompts = [rs.randint(0, cfg.vocab, size=n).astype(np.int32)
                   for n in SERVE_PROMPTS[:PATH16_PROMPTS]]
        done, step_ms = {}, {}
        for label, kw in runs_kw:
            mem0 = torch.cuda.memory_allocated()
            tag = f"[path16 (b) {dname} {label}]"
            eng, counted = serve_run(
                model, params, kw,
                [Request(rid=i, tokens=p, max_new_tokens=SERVE_NEW_TOKENS)
                 for i, p in enumerate(prompts)], plain=False)
            st = eng.stats
            n = st["prefill_calls"] + st["decode_steps"]
            cc = eng.compile_counts()
            captures = sum(fn.report()["graphs"]["captures"]
                           for fn in (eng._prefill_fn, eng._decode_fn))
            compiles = cc["prefill"]["total"] + cc["decode"]["total"]
            step_ms[label] = statistics.median(eng.step_s["decode"]) * 1e3
            print(f"{tag} prefill_calls={st['prefill_calls']} "
                  f"decode_steps={st['decode_steps']} compiles={compiles} "
                  f"captures={captures} launches={counted} decode "
                  f"{step_ms[label]:.3f} ms/step (median)", flush=True)
            if "mesh" in kw:
                print(f"{tag} prefill report sharding: "
                      f"{json.dumps(eng._prefill_fn.report()['sharding'])}",
                      flush=True)
            check(len(eng.done) == len(prompts) and not eng.failed,
                  f"{tag} {len(eng.done)} done, failed {eng.failed}")
            check(counted["flash_attention"] == cfg.n_layers * n
                  and counted["rmsnorm"] == (2 * cfg.n_layers + 1) * n,
                  f"{tag} launches {counted} for {n} launches")
            check(captures == compiles,
                  f"{tag} {captures} captures for {compiles} compiles")
            done[label] = {r: list(v) for r, v in eng.done.items()}
            report[("path16", dname, f"b {label}")] = {"launches": counted}
            del eng
            torch.cuda.empty_cache()
            left = torch.cuda.memory_allocated() - mem0
            check(left <= MEM_SLACK_BYTES,
                  f"{tag} {left} B still allocated after del")
        for label, _ in runs_kw[1:]:
            check(done[label] == done["no mesh"],
                  f"[path16 (b) {dname} {label}] streams differ from the "
                  f"run without a mesh")
        print(f"[path16 (b) {dname}] streams identical; decode ms/step "
              + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()),
              flush=True)
        del params
        torch.cuda.empty_cache()


def mesh_kdot_calls(seed: int) -> dict:
    """(d)'s inputs: path 2's stack (2 layers, full width) run once at T
    = 1999 per dtype with its kernels launched one by one under the
    recorder: its kDot calls by dtype (silu·h and +res)."""
    import dataclasses

    import torch
    from torch.utils import _pytree

    import disc_torch
    from repro_torch.configs import get_config
    from repro_torch.core.graphs import eager_entries
    from repro_torch.models import transformer as T

    out = {}
    for dname in ("f32", "bf16"):
        cfg = dataclasses.replace(get_config("tinyllama_11b"),
                                  n_layers=PATH16_CUT_LAYERS, dtype=dname)
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = T.init(cfg, gen, "cuda")
        fn = token_major_args_fn(cfg, params)
        ws, _ = _pytree.tree_flatten(params)
        f = disc_torch.compile(
            fn, [(tuple(w.shape), w.dtype) for w in ws]
            + [((disc_torch.Dim("T", max=2048), cfg.d_model), dt)],
            backend="hopper")
        x = torch.randn((max(PATH16_REQUESTS), cfg.d_model), generator=gen,
                        device="cuda").to(dt)
        with eager_entries(), Recorder() as rec:
            f(*ws, x)
        out[dname] = [c for k, c in rec.calls.items()
                      if k[0] == "matmul_epilogue"]
    return out


def mesh_dbrx_phase(mesh, seed: int, report: dict) -> None:
    """(c) DBRX at full width and 2 layers under tp on (1, 1), so
    ``moe_apply`` takes its expert-parallel branch: in bf16 the kernels
    (graphed, and one by one under ``eager_entries()``) and the plain
    versions, held as path 6 holds its bf16 runs: each request's
    first-token logits by the accuracy rule against the plain versions'
    run in f32 over the upcast weights under the same mesh, a request
    whose routing parts at a near-tie printed, not held; the dropped
    pairs of the first prefill launch printed beside a run without a
    mesh."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Request
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config("dbrx_132b"),
                              n_layers=PATH16_DBRX_LAYERS, dtype="bf16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = get_model(cfg).init(gen, "cuda")
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in PATH16_DBRX_PROMPTS]
    experts = L._moe_experts_local
    dropped: list = []

    def recording(cfg_, w_in, w_gate, w_out, x, gates, ids, capacity,
                  valid=None, limit=None):
        # the eager calls (an entry's first call, not its capture pass):
        # the (token, expert) pairs over capacity, counted on the card
        if not torch.cuda.is_current_stream_capturing():
            e = w_in.shape[0]
            ok = torch.ones(ids.shape[0], dtype=torch.bool,
                            device=ids.device) if valid is None else valid
            flat = torch.where(ok[:, None] & (ids >= 0) & (ids < e), ids,
                               e).reshape(-1)
            counts = torch.zeros(e + 1, dtype=flat.dtype,
                                 device=flat.device).scatter_add_(
                0, flat, torch.ones_like(flat))[:e]
            cap = capacity if limit is None else limit
            dropped.append((counts - cap).clamp(min=0).sum())
        return experts(cfg_, w_in, w_gate, w_out, x, gates, ids, capacity,
                       valid, limit)

    tp = {"mesh": mesh, "sharding_profile": "tp"}
    runs = {}
    first_drops = {}
    for label, kw, plain, eager, dname in (
            ("kernels", tp, False, False, "bf16"),
            ("eager", tp, False, True, "bf16"),
            ("plain", tp, True, False, "bf16"),
            ("no mesh", {}, False, False, "bf16"),
            ("f32 plain", tp, True, False, "f32")):
        if dname == "f32":
            upcast_in_place(params)
        model = get_model(dataclasses.replace(cfg, dtype=dname))
        dropped.clear()
        L._moe_experts_local = recording
        try:
            eng, counted = serve_run(
                model, params, kw,
                [Request(rid=i, tokens=p, max_new_tokens=PATH16_DBRX_NEW)
                 for i, p in enumerate(prompts)], plain=plain,
                eager=eager, router=(plain or eager) and dname == "bf16")
        finally:
            L._moe_experts_local = experts
        first_drops[label] = [int(d.item())
                              for d in dropped[:PATH16_DBRX_LAYERS]]
        tag = f"[path16 (c) {dname} {PATH16_DBRX_LAYERS}L {label}]"
        st = eng.stats
        n = st["prefill_calls"] + st["decode_steps"]
        print(f"{tag} prefill_calls={st['prefill_calls']} "
              f"decode_steps={st['decode_steps']} launches={counted}; "
              f"first prefill launch dropped (token, expert) pairs by "
              f"layer {first_drops[label]}", flush=True)
        check(len(eng.done) == len(prompts) and not eng.failed,
              f"{tag} {len(eng.done)} done, failed {eng.failed}")
        if plain:
            check(not any(counted.values()),
                  f"{tag} plain run launched kernels: {counted}")
        else:
            check(counted["masked_softmax"] == cfg.n_layers * n
                  and counted["flash_attention"] == cfg.n_layers * n,
                  f"{tag} launches {counted} for {n} launches")
            report[("path16", "bf16", f"c {label}")] = {"launches": counted}
        # the logits, streams and routing stay on record; the engine's
        # cache, graphs and laid-out weights leave the card
        for fn in (eng._prefill_fn, eng._decode_fn):
            eng.compile_cache.drop_fingerprint(fn._fingerprint)
        eng.cache = eng.params = eng.first = None
        runs[label] = eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    ref = {rid: runs["f32 plain"].logits[(rid, 0)] for rid in
           range(len(prompts))}
    accuracy_check(f"[path16 (c) bf16 {PATH16_DBRX_LAYERS}L tp kernels vs "
                   f"plain]", runs, ref)
    graphs_vs_eager(f"[path16 (c) bf16 {PATH16_DBRX_LAYERS}L]",
                    runs["kernels"], runs["eager"], "bf16")
    print(f"[path16 (c)] dropped pairs of the first prefill launch by "
          f"layer: under the mesh (capacity per data shard, rounded up to "
          f"8) {first_drops['kernels']}, without {first_drops['no mesh']}",
          flush=True)
    del runs
    torch.cuda.empty_cache()


def mesh_kernel_rows(calls: dict, report: dict) -> None:
    """(d) flash attention and kDot at the local shapes each rank of a
    2- and 4-way tp layout launches, against their plain versions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config

    cfg = get_config("tinyllama_11b")
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    fills = [n + SERVE_NEW_TOKENS // 2
             for n in SERVE_PROMPTS[:SERVE_BATCH]]
    rows16: list = []
    for dname in ("f32", "bf16"):
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(16)
        launches = sum(rep["launches"].get("flash_attention", 0)
                       for key, rep in report.items()
                       if key[:2] == ("path16", dname))

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        for ways in PATH16_WAYS:
            h_loc = h // ways
            kv_loc = max(1, hkv // ways)
            s_max = SERVE_SEQ
            q = rnd(2, s_max, h_loc, hd).transpose(1, 2)
            k, v = rnd(2, kv_loc, s_max, hd), rnd(2, kv_loc, s_max, hd)
            q[1].zero_()
            k[1].zero_()
            v[1].zero_()
            lens = torch.tensor([f + 1 for f in fills], dtype=torch.int32,
                                device="cuda")
            qd = rnd(SERVE_BATCH, 1, h_loc, hd).transpose(1, 2)
            kd, vd = (rnd(SERVE_BATCH, kv_loc, s_max, hd) for _ in range(2))
            keys = torch.arange(s_max, device="cuda")[None, :]
            dec_mask = (keys < lens[:, None])[:, None, None, :]
            cases = [
                dict(form="prefill",
                     label=f"{ways}-way tp prefill S={s_max} heads "
                           f"{h_loc}/{kv_loc}",
                     q=q[:1], k=k[:1], v=v[:1],
                     args=dict(lens=None, causal=True, q_offset=0),
                     kv_rows=s_max, pairs=s_max * (s_max + 1) // 2,
                     lib=lambda q=q[:1], k=k[:1], v=v[:1]:
                     F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True),
                     zero_check=(q, k, v, dict(lens=None, causal=True,
                                               q_offset=0), [1])),
                dict(form="decode",
                     label=f"{ways}-way tp decode B={SERVE_BATCH} "
                           f"lens={lens.tolist()} heads {h_loc}/{kv_loc}",
                     q=qd, k=kd, v=vd, args=dict(lens=lens), decode=True,
                     kv_rows=int(lens.sum()), pairs=int(lens.sum()),
                     lib=lambda q=qd, k=kd, v=vd:
                     F.scaled_dot_product_attention(q, k, v,
                                                    attn_mask=dec_mask,
                                                    enable_gqa=True),
                     zero_check=(qd, kd, vd, dict(lens=torch.tensor(
                         [5, 0, 9, 0], dtype=torch.int32, device="cuda")),
                         [1, 3]))]
            flash_rows(cases, dname, kv_loc, launches, rows16)
        kdot_local_rows(calls[dname], dname, report, rows16)
    print(f"[path16 (d)] {len(rows16)} kernel rows at the local shapes of "
          f"{PATH16_WAYS}-way tp layouts", flush=True)


def kdot_local_rows(calls: list, dname: str, report: dict,
                    rows16: list) -> None:
    """Each recorded kDot program (silu·h, +res) at the local N of each
    tp way (the weight's and the epilogue operands' columns split, each
    rank's shard contiguous), against ``matmul_fused_ref``."""
    import torch

    from repro_torch.kernels.lengths import device_ints
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.matmul.ref import matmul_fused_ref

    name = "matmul_epilogue"
    tol = TOL_GEMM[dname]
    launches = sum(rep["launches"].get(name, 0)
                   for key, rep in report.items()
                   if key[:2] == ("path16", dname))
    for c in calls:
        prog = c["program"]
        m, k = c["a"].shape
        n = c["b"].shape[1]
        vm, vn, vk = c["valid"]
        for ways in PATH16_WAYS:
            nl = n // ways
            a = c["a"]
            b = c["b"][:, :nl].contiguous()
            xs = [torch.broadcast_to(x, (m, n))[:, :nl].contiguous()
                  if x.dim() == 2 and x.shape[-1] == n else x
                  for x in c["extras"]]
            valid = (vm, min(vn, nl), vk)
            on_card = device_ints(valid, "cuda")

            def run_k(a=a, b=b, xs=xs, on_card=on_card):
                return mm.matmul_fused(a, b, xs, prog, valid_mnk=on_card,
                                       out_dtypes=c["out_dtypes"])

            def run_p(a=a, b=b, xs=xs, valid=valid):
                return matmul_fused_ref(a, b, xs, prog, valid,
                                        c["out_dtypes"])

            before = mm.EPILOGUE_LAUNCHES.launches
            got = run_k()
            check(mm.EPILOGUE_LAUNCHES.launches == before + 1,
                  "matmul_fused launched no kernel")
            want = run_p()
            torch.cuda.synchronize()
            err, scale, worst = 0.0, 0.0, 0.0
            for g, w in zip(got, want):
                e = (g.float() - w.float()).abs().max().item()
                sc = w.float().abs().max().item()
                err, scale = max(err, e), max(scale, sc)
                worst = max(worst, e / sc if sc else e)
                check(bool(torch.isfinite(g).all()) and not g[vm:].any(),
                      f"{name} {dname} {prog.key} {ways}-way: non-finite "
                      f"or padded rows not zero")
            ms = cuda_ms(run_k)
            plain_ms = cuda_ms(run_p)
            lib_ms = cuda_ms(lambda a=a, b=b, nl=valid[1]:
                             torch.matmul(a[:vm, :vk], b[:vk, :nl]))
            elt = a.element_size()
            x_bytes = sum((vm if torch.broadcast_to(x, (m, nl)).stride(0)
                           else 1) * valid[1] * x.element_size()
                          for x in xs)
            out_bytes = sum(m * nl * torch.empty((), dtype=dt).element_size()
                            for dt in c["out_dtypes"])
            flops = 2 * vm * valid[1] * vk
            bound_ms, bound_by = gemm_bound(vm * vk * elt,
                                            vk * valid[1] * elt,
                                            x_bytes + out_bytes, flops,
                                            dname)
            row = dict(name=name, **KERNELS[name], launches=launches,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
            detail = dict(dtype=dname, program=prog.key,
                          case=f"{ways}-way tp local N",
                          shape=[m, k, nl], valid=list(valid),
                          steps=[st.opcode for st in prog.steps],
                          max_ref=scale, max_rel=worst,
                          library_call="torch.matmul, GEMM only, without "
                                       "the epilogue",
                          library_ratio=ms / lib_ms,
                          tflops=flops / ms / 1e9,
                          bound_share=bound_ms / ms,
                          path_launches_of_program=0)
            print(f"[kernels] {json.dumps(dict(row, **detail))}",
                  flush=True)
            check(worst <= tol, f"{name} {dname} {prog.key} {ways}-way: "
                                f"max|d|/max|ref| {worst:.3e} > {tol}")
            rows16.append((row, detail))


def finish(rows: list, report: dict, card: str, kind: str) -> int:
    """The kernels line, the card line and the result line, last."""
    import torch

    print(json.dumps({"kernels": summary(rows, report)}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
