#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_hc_bench_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. **device**: ``nvidia-smi``'s name and power limit, and the build of
   every CUDA kernel from ``tpu_hc_bench_torch/csrc`` (``nvcc``,
   ``sm_90a``), with its time.
2. **kernels**: each kernel against its plain PyTorch version on the
   card, at the serving lane's llama_1b shapes, with the tolerance
   stated: paged decode attention (f32, bf16 and int8 pools, 1 and 2
   pages per block, each call two kernels: the split and the merge, held
   against the split plain version at the same splits; then a long
   context, 8 rows of 2048-4096 keys over a 2-layer f32 pool, where bytes
   set the bound; then a bf16 pool's p rounded to bf16 before P V, on a
   row of three keys that one warp's chunk holds: within
   ``PAGED_ROUNDING_TOL`` of the plain version, which the unrounded
   result misses; then head dims off the template list, 80 and 96 in f32
   and bf16 and 20 in bf16 (the next listed case masked, scalar loads at
   20 bf16), against the split plain version), and the fused
   residual+norm at 1, 8, 32, 64 and 512 rows of 2048, f32 and bf16,
   rmsnorm and layernorm, in both designs (``"cluster"``, ``"warp"``;
   each record names the one ``norm_design`` picks): y bit-equal, out
   within ``NORM_TOL``; beside it the two-launch library route
   (``torch.add`` then ``F.rms_norm``/``F.layer_norm``), the library
   norm alone on a precomputed y, and the launch floor (an empty launch,
   and an empty cluster of 8 CTAs).  Times are CUDA events, median of 50
   calls after warmup,
   with the L2 cache flushed before each call and the card then held in
   a ~0.2 ms spin, so the host's Python and launch overhead (enqueued
   meanwhile) stays out of the device time; ``library_ms`` times one
   PyTorch call of the same function, which the port never calls.
3. **parity**: llama_1b at full width, seeded weights: two prompts
   prefilled, then 4 decode steps on a fixed token feed; the ``paged``
   program's logits against the ``gather`` program's.
4. **serve**: ``ServeEngine`` on llama_1b with ``--decode_attention=
   paged``, 16 poisson requests at 64 req/s; the kernels' launch counts
   are zeroed just before the run and read just after it (31
   ``fused_residual_norm`` launches a decode step, the design
   ``norm_design`` picks at 8 rows).
5. **conv**: ``fused_bn_relu_conv`` against its plain version at the two
   ResNet-50 shapes it serves, ``[128,28,28,128]->128`` and
   ``[128,14,14,256]->256``, in float32 and bf16, and in bf16 at the two
   shapes just outside ``eligible``'s window (``56x56x64``, ``7x7x512``).
   Beside the kernel: the plain version, ``library_ms`` (one cuDNN
   ``F.conv2d`` of a precomputed ``relu(y1*a+b)``) and ``unfused_ms``
   (the port's off-window composition: BN-apply+relu, cuDNN conv, stats
   from the rounded output); each record names the kernel design that
   ran (``conv_design``: the wgmma kernel for bf16) and its TFLOP/s and
   share of the bound.
6. **train parity**: resnet50 at full width, float32, batch 16 at
   224x224, seeded weights (BN scales and shifts perturbed, so every
   gradient is live); the fused and unfused routes from one
   ``state_dict``, one momentum-SGD step each: loss, logits, every
   gradient and the BN running statistics, the gradients against the
   noise floor of the unfused model run again in NCHW memory.
7. **train**: the training lane's main path, ``python -m
   tpu_hc_bench_torch 1 1 128 sock --model=resnet50 --use_fp16=true``
   through ``launcher.main``, first with ``--fused_conv=true`` (the
   kernel's count zeroed just before, and it must equal 8 launches a
   step just after), then with ``--fused_conv=false``.
8. **flash**: the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain versions on the same inputs, at the GPT-2 shape
   ``[16, 1024, 12, 64]`` causal in bf16 (q, k, v views of one fused
   projection, as the model hands them over) and in float32, at
   llama_1b's ``[2, 2048, 32, 64]`` causal in bf16 (the GQA-repeated
   K/V of phase 17's main path), at an unaligned non-causal ``[4, 1000,
   6, 128]`` in bf16, at vit_b16's and vit_l16's ``[64, 197, 12, 64]``
   and ``[64, 197, 16, 64]`` non-causal in bf16 (phase 18's main path:
   69 valid rows in the last query tile, 5 in the last key tile), at
   BERT-base's non-causal ``[128, 128, 12, 64]`` in bf16, at bert_tiny's
   head dim
   32 (``[128, 128, 4, 32]``, zero-padded to 64 as ``flash_attention``
   pads it), at head dim 256 (``[2, 512, 8, 256]`` causal, bf16 and
   float32: the FMA kernels at 32-row tiles) and at head dim 320
   (``[2, 256, 4, 320]`` causal, both dtypes, zero-padded to 512: the
   same kernels over two 256-wide chunks); ``library_ms`` is
   ``F.scaled_dot_product_attention``'s
   forward, and its backward alone (the median of five medians: its
   spread is wide).  Each plain version runs at its kernel's tiles
   (``fwd_blocks``, ``bwd_blocks``), the backward passes take the
   forward kernel's o and lse; each record names the design the wrapper
   reports for its launch (bf16: wgmma) and its TFLOP/s and share of the
   bound.  Then b * h = 65540 (``[16385, 40, 4, 64]`` causal bf16): the
   three kernels at once, the first and last batch rows against the
   plain versions run on those rows alone.  Last, the padded route:
   ``flash_attention`` at bert_tiny's ``[128, 128, 4, 32]`` and at a
   non-causal bf16 ``[2, 300, 4, 192]`` through autograd, one launch of
   each kernel, o and the gradients at the caller's width with the bits
   of the kernels on inputs zero-padded to 64 (256), and within the
   tolerance of the plain versions at the caller's width.
9. **lm_train_parity**: gpt2 (batch 2 x seq 1024) and bert_base (batch
   8 x seq 128, the MLM batch) at full width in float32, dropout off,
   three arms from one ``state_dict``, one momentum-SGD step each:
   ``dense``, ``flash``, and ``flash`` with ``--fused_xent``; flash held
   against dense and the fused loss against the unfused one: loss,
   logits, the gradients' global norm and the parameters after the step,
   with each arm's kernel launches.
10. **lm_train**: the LM lanes' main paths through ``launcher.main``:
   ``python -m tpu_hc_bench_torch 1 1 16 sock --model=gpt2
   --use_fp16=true --attention_impl=flash --fused_xent=true`` (every
   count zeroed just before, and each flash kernel must show 12 launches
   a step and each xent kernel one just after), then gpt2 ``flash``
   unfused and ``dense``, then ``bert_base`` at batch 128 with
   ``--attention_impl=flash`` and ``--fused_xent=true|false``; peak
   memory of each.
11. **xent**: the cross-entropy forward and backward kernels against
   their plain versions at GPT-2's logits ``[16384, 50257]`` float32 (the
   main path), BERT-base's ``[16384, 30522]`` float32, llama_1b's
   ``[4096, 32000]`` float32 and a bf16 ``[4096, 50257]``; ``library_ms`` is ``F.cross_entropy(reduction=
   "none")``'s forward, and its backward alone.
12. **pool**: ``max_pool``'s backward kernel, which no model runs: three
   forward-and-backward calls through the op at googlenet/resnet's stem
   pool ``[128, 64, 112, 112]`` bf16 3x3/2 SAME (its launches counted),
   then the kernel against its plain version there, at the branch pool
   ``[256, 256, 28, 28]`` bf16 3x3/1 SAME, a ragged float32 ``[2, 8, 13,
   15]`` and a bf16 input where most windows tie; ``library_ms`` is
   ``F.max_pool2d``'s backward alone (timing only: it routes ties to the
   first max); each record names the kernel's case (16-byte vectors or
   scalar accesses; the 3x3/2, 3x3/1 or generic window) and its GB/s and
   share of the bound.

13. **dp**: data-parallel training over ``torch.distributed`` (every
   count zeroed just before each run and read just after): (a)
   ``python -m tpu_hc_bench_torch 1 1 128 ib --model=resnet50
   --use_fp16=true --fused_conv=true`` through ``launcher.main``, the
   fast arm in a one-rank NCCL group: images/s and step ms beside phase
   7's ``sock`` run (the bucket path's cost at world 1), the gradient
   buckets, the all-reduce calls a step and the fused conv's launches (8
   a step); (b) phase 6's seeded resnet50 in float32 at batch 16, two
   steps through the one-worker step (twice) and through the fast arm
   with ``--overlap_grad_comm`` on and off, cuDNN deterministic: every
   parameter and BN statistic bit-equal to the one-worker step where
   that step is bit-equal to itself, else within ``DP_NOISE_FACTOR`` x
   its run-to-run floor (the record says which); then accumulation 2 on
   the fast arm, finite, 16 conv launches a step; (c) ``1 1 16 ib
   --model=gpt2 --attention_impl=flash --fused_xent=true``: 12 launches
   of each flash kernel and one of each xent kernel a step; (d) with two
   cards or more, ``1 0 128 ib`` across all of them (scaling efficiency
   against (a)), then ``--overlap_grad_comm`` on, off, off, on at a
   25 MiB threshold (several buckets), and the OSU all-reduce sweep;
   with one card, one record naming the card count it lacked.

14. **realdata**: the reference's real-data command on the committed
   fixture of ImageNet-schema shards
   (``tpu_hc_bench_torch/data/testdata/imagenet_tiny``), every count
   zeroed just before each run and read just after: (a) the port's
   pipeline against the JAX pipeline's crops (``expected_crops.npz``):
   the decoder and reader that ran, bit-equal with libjpeg, with nvJPEG
   a mean difference within ``NVJPEG_MEAN_TOL``; (b) ``python -m
   tpu_hc_bench_torch 1 1 128 ib --model=resnet50 --use_fp16=true
   --fused_conv=true --data_dir=<fixture>`` with the reference's whole
   flag line (all but ``--device=cpu``), 10 + 30 steps: images/s
   against phase 7's, the decode pool's counters, the input wait a
   step, 8 conv launches a step; (c) the same with
   ``--datasets_repeat_cached_sample``, (d) ``--forward_only`` (the
   model's parameters and BN buffers bit-equal after the run), each 10
   + 30 steps; (e) ``--eval`` on the validation shard; (f) three steps
   each of adam, adamw and rmsprop at batch 32 against the plain
   optimizer on the same gradients; (g) gpt2 on a uint16 token corpus
   written here, 10 + 30 steps, against phase 10's first run, 12
   launches of each flash kernel and one of each xent kernel a step.

15. **slice7**: sync-BN, the decoder, the input service and
   checkpoints: (a) ``--variable_update=replicated`` (every BatchNorm's
   statistics all-reduced) against ``psum`` in a one-rank NCCL group,
   phase 6's seeded resnet50 in float32 at batch 16, two steps each,
   cuDNN deterministic: bit-equal (sync over one rank is the identity),
   and the all-reduce calls a step of each; (b) phase 14 (a): the
   decoder ``jpeg_decoder()`` picks (``pil`` where libjpeg's headers are
   missing) bit-equal to the JAX pipeline's crops, nvJPEG forced by
   name within ``NVJPEG_MEAN_TOL``; (c) phase 14 (b) again, on that
   decoder: images/s, the pool's ms a batch, the input wait a step; (d)
   the same with ``--input_service=on`` at world 1: images/s against
   (c) and the ring's stall, wait and occupancy counters; (e) resnet50
   bf16 batch 128 ``--fused_conv=true --train_dir=<dir>
   --save_model_steps=25``, 10 + 50 steps with synchronous saves, then
   ``--resume=must`` for 10 + 50 more with async saves, then ``--eval``
   on the fixture's validation shard from the same ``--train_dir``: the
   saved and restored fingerprints equal, each save's blocking ms,
   images/s against phase 7; (c)-(e) every count zeroed just before each
   run, 8 conv launches a step; (f) with two cards or more, ``1 0 128
   ib`` on the fixture with ``--input_service=auto`` (the service
   engages) and ``off``, images/s and the decode pool's width, then
   ``replicated`` on the auto run: its parameters differ from psum's
   and its loss is finite; with one card, one record naming the card
   count it lacked.

16. **serve2**: the serving lane's second slice, run right after phase 4
   on its llama_1b model; every count zeroed just before each run and
   read just after, row 1 held to L and row 2 to 2L - 1 launches a decode
   step: (a) gpt2 at full width, float32, seeded weights (a position
   table of 1024 rows for phase 4's 576-token context): phase 3's fixed
   feed through the ``paged`` program against the ``gather`` one within
   ``GPT2_PARITY_TOL``; (b) gpt2 served on phase 4's trace
   (``--decode_attention=paged``), 12 and 23 launches a step, the design
   ``norm_design`` picks at 8 rows of 768; (e) that engine on one shared
   100-token prompt (16 requests, 32 outputs) under ``--kv_reserve=
   worst``, ``lazy`` and ``lazy`` + ``--prefix_cache=on`` in virtual time
   (``SERVE2_VCOSTS``): tokens equal across the arms, prefix hits and
   copy-on-write copies, lazy's ``pages_peak`` under worst's; (f) gpt2
   with ``--kv_pages``, ``--shed=deadline``, ``--kv_preempt=on`` and
   ``--deadline_ms`` under ``SERVE2_F``'s plan in virtual time: sheds,
   preempts, requeues and the one quarantine the plan forces; then
   ``python -m tpu_hc_bench_torch serve --model=gpt2`` in a subprocess
   with ``--serve_faults=sigterm@`` (a real SIGTERM): exit 75 and a
   journal, and ``--serve_resume`` exits 0 having served exactly the
   journaled requests; (c) llama_1b under ``--quant=int8_kv`` on phase
   4's trace, 16 launches a step on int8 pools: the pool bytes against
   f32's, the share of tokens equal to phase 4's, and the fixed feed's
   logits against the f32 program's within ``INT8_KV_REL_TOL``; (d)
   llama_1b under ``--quant=int8_w``: tokens/s against phase 4 and the
   weight bytes.

17. **slice9**: the decoder lane's rest, every training run through
   ``launcher.main`` with every count zeroed just before and read just
   after, and its peak memory: (a) llama_1b at full width, bf16, flash,
   batch 2 x 2048, 5 + 20 steps, ``--fused_xent`` false and true (16
   launches of each flash kernel a step, one of each xent kernel with
   the fused loss), the loss falling below the first step's, whose
   logits and loss are held to the dense arm's within
   ``SLICE9_FIRST_LOGITS_TOL`` and ``SLICE9_FIRST_LOSS_TOL`` (the
   kernels themselves are held at llama_1b's shapes in phases 8 and
   11); (b) the
   same with ``--gradient_checkpointing`` (the forward kernel 32 a step,
   the final loss within ``SLICE9_REMAT_LOSS_TOL`` of (a)'s, less
   memory), and at the end of the phase the largest power-of-two batch
   that fits under remat, with its sequences/s; (c) gpt2_moe, bf16,
   flash, batch 8 x 1024, ``--moe_impl=einsum`` and ``ragged`` (12 a
   step), aux loss and einsum's drop fraction; (d) gpt2_moe at
   ``--gradient_accumulation_steps=8`` through a one-rank NCCL group,
   ``--accum_dtype=f32`` against ``bf16`` within
   ``SLICE9_ACCUM_LOSS_TOL``, each arm's final loss at least
   ``SLICE9_ACCUM_MOVED`` times that far from a ``--forward_only`` run's
   on the same batch (the loss with no update); (e) gpt2 and llama_1b
   with ``--scan_layers`` against unrolled from one seed, each run at
   one launch of each flash kernel a layer and step; (f) gpt2_moe served
   in float32 on phase 4's trace: paged against gather on phase 3's
   feed, rows 1 and 2 at 12 and 23 launches a decode step, the ragged
   route's host syncs a decode step, and the greedy tokens against the
   full forward's argmax.

18. **zoo**: the image zoo, every training run through
   ``launcher.main`` with every count zeroed just before and read just
   after, and its peak memory: (a) vit_b16 at full width, bf16, batch
   64, 10 + 30 steps, ``--attention_impl=flash`` (12 launches of rows
   3, 4a, 4b a step) and ``dense`` (none), the first training-mode loss
   on the runs' batch, flash against dense from one seed, within
   ``ZOO_VIT_FIRST_LOSS_TOL``; (b) the same with
   ``--gradient_checkpointing`` (row 3 24 a step, the final loss within
   ``ZOO_REMAT_LOSS_TOL`` of (a)'s flash run, less memory), then batches
   128 to ``ZOO_MAX_BATCH`` under remat until one does not fit, each
   with its images/s; (c) vit_l16, flash, batch 64 (halved until it
   fits), 5 + 15 (24 launches of each a step); (d) every other image
   member once at ``ZOO_BATCHES``, 2 + 5 steps, resnet18 and
   resnet50_v2 again with ``--use_space_to_depth``: images/s, ms a
   step, MFU, peak memory, a finite final loss, no kernel of the table
   launched, and the first bf16 loss within ``ZOO_BF16_LOSS_TOL`` of
   the float32 forward of the same seeded model on the same batch; (e)
   nasnet's and lenet's device idle share and kernels a step over
   ``ZOO_STEPS`` under ``torch.profiler``.

19. **slice11**: the speech and recommendation members and the classify
   mode, every training run through ``launcher.main`` with every count
   zeroed just before and read just after, and its peak memory: (a)
   deepspeech2 at full width, bf16, batch 256, ``--rnn_impl=hoisted``,
   2 + 5 steps: examples/s, ms a step, MFU, and over the same steps
   under ``torch.profiler`` (the device alone) kernels a step and the
   device's idle share; the first bf16 CTC loss against the float32
   forward of the same weights within ``SLICE11_BF16_LOSS_TOL``; (b)
   ``bidi`` and ``flax`` at batch 256, 1 + 3: ms a step against (a),
   the first loss of each on (a)'s weights within
   ``SLICE11_ARM_LOSS_TOL`` of hoisted's; (c) ncf at full width, bf16,
   batch 2^20, 2 + 5, then ``--eval`` top-1 on 2 batches; (d) the
   classify mode, float32 at full width: resnet50 and deepspeech2 each
   serving 32 Poisson requests at 8 in flight, every request completed,
   classify steps and no decode step, p99 ttft equal to p99 e2e,
   requests/s and e2e percentiles; ncf refused; (e) no kernel of the
   table launched over (a)-(d).

20. **slice12**: the serving lane's observability, every run with every
   count zeroed just before and read just after: (a) phase 4's llama_1b
   engine (full width, f32, paged, ``--hbm_budget=auto``) serves phase
   4's 16 requests twice in virtual time (``SERVE2_VCOSTS``, so both
   runs see the same batches), once with no writer and the flight
   recorder off, once through ``cli.run_serve`` with ``--metrics_dir``
   and ``--flight_recorder=on``: tokens and launch counts equal between
   the runs (16 paged calls and 31 norm launches a decode step), every
   file of the run dir parses, ``serve_summary`` equals the returned
   summary, ``python -m tpu_hc_bench_torch.obs summarize`` exits 0 and
   prints the serve lines, the budget line names the warmed ladder's
   measured peak against the card's memory; real wall tokens/s of both
   runs and the obs calls' host time a decode step (the writer, the
   sketches, the signal engine, the spans and the heartbeat, each timed
   where it is called); (b) resnet50 classify, 32 requests at 8 in
   flight, with ``--metrics_dir``: ``classify`` spans and records, no
   table kernel; (c) a SIGTERM drain (``sigterm@`` delivered to this
   process) with ``--metrics_dir``: the journal in the run dir, the
   streams closed and parsing, ``timeline_dump.json``; (d) gpt2_moe
   under ``--accum_dtype=bf16`` at phase 17 (d)'s settings, 1 + 2
   steps: the run's peak memory, each optimizer step's allocation before,
   after and at its peak, what a step holds beyond the larger of before
   and after (no float32 gradient tree: under a quarter of the float32
   parameter bytes), and a finite loss.
21. **slice13**: the training lane's guards and observability, every
   driver run through ``launcher.main`` with every count zeroed just
   before and read just after, cuDNN deterministic in (a)-(d) so runs
   compare bit for bit: (0) the fused conv (row 7) against its plain
   version on a ``y1`` with NaN entries at both bf16 shapes and in f32
   (NaN in the same places of y2, s1 and s2, the rest to phase 5's
   tolerance), and NaN through the flash forward (the wgmma and FMA
   designs) and the xent forward; (a) resnet50 bf16 ``--fused_conv`` at
   batch 128, obs off, then on (``--metrics_dir``,
   ``--flight_recorder=on``, ``--trace_dir``, ``--profile_steps=3:5``,
   ``--hbm_budget=auto``, ``--fabric_ceiling`` on a one-card OSU sweep
   written first): bit-equal losses and equal row-7 launches, the obs
   calls' host time a step, the Kineto trace's four buckets and top
   device ops (the fused conv kernel among them), MFU measured against
   analytic, the budget line, JAX's ceiling line for a world with no
   all-reduce, ``obs summarize`` exits 0; (b) ``nan_loss@3
   --on_nonfinite=skip`` on resnet50 ends bit-equal to the fault-free
   run one step shorter (guard on against guard off, both step times),
   ``abort`` stops with JAX's message, and vit_b16 on the flash kernels
   at the step: eight steps poisoned at 5 against seven clean steps whose
   dropout generator skipped step 5's draws, bit-equal, and under
   ``flag`` a bad step counted and applied; (c) ``--on_nonfinite=
   rewind`` restores, replays and completes with goodput below 1 in the
   summary, and a run poisoned on every step ends on
   ``--max_bad_steps``; (d) ``sigterm@3`` exits 75 with an emergency
   checkpoint and its fingerprint line, and ``--resume=auto`` ends on the
   uninterrupted run's fingerprint; (e) ``hang@2:120
   --step_timeout_s=8`` in a process of its own (the ``trivial`` model)
   exits 70 with the thread dump, fired within the poll bound, while
   (f) ``python -m tpu_hc_bench_torch.utils.sanity`` exits 0 in
   another.
22. **slice14**: sequence parallelism and zero1, every driver run
   through ``launcher.main`` with every count zeroed just before and
   read just after: (a) the degenerate seq axis on one card (``1 1 B
   ib``, a one-rank group): gpt2 16 x 1024 bf16 with ``--fused_xent``
   and llama_1b 2 x 2048 bf16, each under ``dense``, ``ring``, ``flash``
   and ``ulysses_flash`` from one seed; ``ulysses_flash``'s losses
   bit-equal to ``flash``'s (its exchanges are copies at world 1),
   ``ring``'s within ``SLICE14_RING_FIRST_TOL`` of ``dense``'s at the
   first step and ``SLICE14_RING_LAST_TOL`` at the last; sequences/s of
   each pair (the SP machinery's cost at world 1), rows 3, 4a and 4b
   launched a layer a step on the flash arms only, rows 5 and 6 a step
   on gpt2's; (b) zero1 against psum at world 1 on resnet50, bf16 batch
   128 ``--fused_conv=true``, cuDNN deterministic: losses and the final
   parameters' fingerprint bit-equal, images/s, the optimizer's bytes
   and collectives a step, row 7's 8 launches a step; (c) with two
   cards or more, llama_1b at 2048 tokens a shard over sp 2 (and sp 4,
   dp 2 x sp 2 on four cards) with ``ring`` and ``ulysses_flash``
   (``--gradient_checkpointing`` where the ring's saved folds pass
   ``SLICE14_REMAT_GB``): sequences/s and rank 0's peak memory; then
   resnet50 zero1 against psum over every card (images/s, the
   optimizer's bytes a rank).
23. **slice15**: elastic resume, multislice, tensor and expert
   parallelism: (a) gpt2 16 x 1024 bf16 flash ``--fused_xent`` through
   the TP layers in a one-rank model group (``parallel.tensor``: the
   model cut one way, its collectives copies) against the plain model,
   3 + 10 steps each from one seed: every loss bit-equal (else within
   ``SLICE15_TP1_TOL`` at the last step), sequences/s of each, rows 3,
   4a, 4b, 5 and 6 launched on both; (b) two CPU workers (``1 2 2 ib
   --device=cpu``, gloo) write a resnet50 zero1 checkpoint at batch 2 in
   1 + 1 steps; here its resume at world 1 without ``--resume=elastic``
   raises ``TopologyMismatchError`` naming both sides, then
   ``restore_elastic`` on the card gives the saved parameters'
   fingerprint and the optimizer's real elements bit for bit, then the
   launcher resumes it with ``--resume=elastic`` (bf16, fused conv): the
   plan line ``[2, k]->[1, k']``, the saved fingerprint, row 7's 8
   launches a step; (c)-(f) with two cards or more: gpt2 and llama_1b
   under ``--model_parallel`` (tp 2 at world 2, dp 2 x tp 2 at world 4,
   llama_1b at tp 2 and tp 4), gpt2_moe under ``--expert_parallel`` 2
   and 4 (sequences/s, rank 0's peak, the final loss against the
   world-1 run where the rows are the same), resnet50 ``dcn
   --num_slices=2`` against ``ib`` on four cards (images/s, final
   losses), and resnet50 zero1 saved at world 4, restored elastically
   at 2 and saved, restored at 4 (this script's ``--elastic-worker``
   processes): the parameters' fingerprint and every optimizer shard
   bit-equal over the round trip.
24. **slice16**: pipeline parallelism and the 3-D hybrids: (a) gpt2 16
   x 1024 bf16 flash through ``parallel.pipeline``'s GPipe schedule at
   one stage (``SLICE16_M`` microbatches, no hops) against the plain
   step, dropout off in both, 3 + 10 steps from one seed: every loss
   bit-equal or within ``SLICE16_ONE_STAGE_TOL``, sequences/s of each,
   rows 3, 4a and 4b 12 x M launches a step on the pipeline, 12 on the
   plain; (b) two CPU workers (``1 2 4 ib --device=cpu
   --pipeline_parallel=2``) write a llama_tiny checkpoint, the card
   resumes it at world 1 as plain data parallelism (the restored
   fingerprint the saved one), and the card's save resumes on two CPU
   workers at pp 2 likewise; (c)-(d) with two cards or more, (e)-(f)
   with four, each run through the launcher's path in this script's
   ``--launch-worker`` processes (every kernel's count zeroed before
   and read after, in each): gpt2 at pp 2, pp 4 and dp 2 x pp 2; llama_1b
   4 x 2048 at pp 2 and pp 4 against its world-1 runs, the one-batch
   step and the same M microbatches by accumulation (final loss within
   ``SLICE16_LLAMA_TOL`` of the latter); gpt2 at pp 2 x tp 2 and llama_1b 2 x 2048
   ``ulysses_flash`` at sp 2 x tp 2 (sequences/s, each rank's peak and
   launches, the banner lines); llama_1b saved at pp 2, restored at pp 4
   and saved (``--pp-ckpt-worker`` processes, no step), restored at
   world 1: the fingerprints of the parameters and of the optimizer
   state equal throughout.

Then the kernel table line (each kernel's design beside its numbers,
``dp_launches``: its launches in phase 13's main-path runs (a) and (c),
``realdata_launches``: its launches in phase 14's runs (b)-(e) and (g),
``slice7_launches``: its launches in phase 15's runs (c)-(e), and
``serve2_launches``: its launches in phase 16's runs (b)-(f) in this
process, ``slice9_launches``: its launches in phase 17's runs (a)-(c)
and (f), ``zoo_launches``: its launches in phase 18's runs (a)-(d),
``slice11_launches``: its launches in phase 19's runs (a)-(d),
``slice12_launches``: its launches in phase 20's runs (a)-(d),
``slice13_launches``: its launches in phase 21's runs (a)-(d),
``slice14_launches``: its launches in phase 22's runs (a) and (b),
``slice15_launches``: its launches in phase 23's runs (a) and (b),
``slice16_launches``: its launches in phase 24's run (a), every
kernel's count set to 0 before each and read after it),
the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
package beside it, the script exits non-zero and prints no result.

``python3 chip_smoke.py --only dp`` runs the build and phase 13 alone,
beside a one-worker ``sock`` run at its step counts (no kernel table):
the data-parallel path on a machine with several cards.  ``--only
realdata`` runs the build and phase 14 alone, beside phase 7's fused
run and phase 10's first run; ``--only slice7`` the build and phase 15
alone, beside phase 7's fused run (with several cards, (f) runs);
``--only serve2`` the build and phase 16 alone, beside phase 4's run;
``--only slice9`` the build and phase 17 alone; ``--only zoo`` the
build, phase 8 at ViT's two shapes, then phase 18; ``--only slice11``
the build and phase 19 alone; ``--only slice12`` the build, phase 4 and
phase 20; ``--only slice13`` the build and phase 21; ``--only slice14``
the build and phase 22 (with several cards, (c) runs); ``--only slice15``
the build and phase 23 (with several cards, (c)-(f) run); ``--only
slice16`` the build and phase 24 (with two cards or more, (c)-(d) run,
with four (e)-(f)).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
# paged attention against its split plain version: f32 and int8 sums in
# another order (<= 4096 keys), absolute; bf16 relative to the output's
# largest magnitude: out is rounded to 2^-8 of it, and p is rounded to
# bf16 against another running max; lse absolute, f32 on both sides
PAGED_TOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 1e-2}
PAGED_LSE_TOL = 1e-4
# the rounding case: three keys, one split and one warp chunk, so the
# kernel rounds p against the plain version's max; f32 sums of three
# products in another order (rounded and unrounded p differ by ~1.6e-4)
PAGED_ROUNDING_TOL = 1e-6
# (case, layers, rows, table slots, (shortest, longest) row, pools): the
# serving lane's llama_1b decode shape (16-token pages, 576-key tables,
# one padded row and one full table), then a long context where bytes set
# the bound (a 2-layer pool of 2049 pages, ~270 MB at f32)
PAGED_CASES = (("llama_1b", 16, 8, 36, (1, 576), ("f32", "bf16", "int8")),
               ("long_context", 2, 8, 256, (2048, 4096), ("f32",)))
# the fused residual+norm's out: f32 statistics over 2048 values in
# another order (f32, absolute); one rounding of out to bf16, relative to
# its largest magnitude (bf16); y is bit-equal in both
NORM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
NORM_HIDDEN = 2048                 # llama_1b
HOST_CALLS = 200                   # wrapper calls enqueued back to back
NORM_ROWS = (1, 8, 32, 64, 512)    # decode batches, then a prefill's rows
# (dtype, hidden, rows): rows of 32 KB, the widest the warp design takes
# (16 warps of 4 vectors), past which norm_design turns to the cluster
# design; rmsnorm
NORM_WIDE = (("float32", 8192, 1), ("float32", 8192, 8),
             ("bfloat16", 16384, 1), ("bfloat16", 16384, 8))
# paged decode attention at head dims off the kernels' template list, at
# llama_1b's decode shape otherwise: (head dim, pool), each against the
# split plain version; bf16 at 20 is 40 bytes a row, the scalar loads
PAGED_OFF_LIST = ((80, "f32"), (96, "f32"), (80, "bf16"), (96, "bf16"),
                  (20, "bf16"))
PARITY_TOL = 1e-3                  # 16 layers of f32 at width 2048
# fused conv, each relative to the output's largest magnitude: y2 (f32:
# sums of 9 x Cin terms in another order; bf16: one ulp of the largest
# value is 2^-7 of it, and the f32 sums may round across a tie) and the
# per-channel stats (f32 sums over N*H*W pixels in another order)
CONV_Y_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CONV_STATS_TOL = 1e-4
# (shape N, H, Cin, Cout; dtypes): the main path's two shapes, then the
# window's neighbours, where eligible() keeps the unfused route
CONV_CASES = (((128, 28, 128, 128), ("float32", "bfloat16")),
              ((128, 14, 256, 256), ("float32", "bfloat16")),
              ((128, 56, 64, 64), ("bfloat16",)),
              ((128, 7, 512, 512), ("bfloat16",)))
CONV_MAIN_CASE = ((128, 14, 256, 256), "bfloat16")  # 5 of the 8 launches
# train parity at full width, float32 (fused vs unfused resnet50): loss,
# logits and running stats relative to their largest magnitude (53
# BatchNorms over batch 16 in another summation order); the gradients'
# global norm error within 3x the noise floor of the same math through
# other kernels (phase_train_parity says why), or 1e-3 where that floor
# is lower
TRAIN_LOSS_TOL = 1e-4
TRAIN_LOGITS_TOL = 1e-3
TRAIN_STATS_TOL = 1e-3
TRAIN_GRAD_TOL = 1e-3
TRAIN_GRAD_NOISE_FACTOR = 3.0
TRAIN_BATCH = 128                  # bench.py's protocol: batch 128,
TRAIN_WARMUP = 50                  # 50 warmup and 100 timed steps
TRAIN_BATCHES = 100
PARITY_BATCH = 16
FUSED_LAUNCHES_PER_STEP = 8        # resnet50: 3 blocks at 28x28x128,
                                   # 5 at 14x14x256
TIMED_ITERS = 50
WARMUP_ITERS = 5
# the card spins this many cycles (~0.2 ms) after each L2 flush, before the
# start event: the host enqueues the timed call meanwhile, so its Python
# and launch overhead stays out of the device time
HEAD_START_CYCLES = 400_000
# flash kernels vs their plain versions, relative to the output's largest
# magnitude: f32 sums over <= 1024 keys in another order; bf16 outputs are
# rounded to 2^-8 of their magnitude, and P and dS are rounded to bf16
# before their products, where a last-bit difference in the f32 score
# can flip a rounding
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# (b, s, h, d, dtype, causal): the main path's shape first; llama_1b's
# (batch 2 x seq 2048, 32 heads after the GQA repeat); head dim 32
# (bert_tiny's widths, batch 128 x seq 128) runs zero-padded to 64; head
# dim 256 runs the FMA kernels at 32-row tiles in both dtypes, and head
# dim 320 the same kernels zero-padded to 512 (two 256-wide chunks);
# last, vit_b16's and vit_l16's batch 64 x 197 tokens
FLASH_CASES = ((16, 1024, 12, 64, "bfloat16", True),
               (2, 2048, 32, 64, "bfloat16", True),         # llama_1b
               (16, 1024, 12, 64, "float32", True),
               (4, 1000, 6, 128, "bfloat16", False),
               (128, 128, 12, 64, "bfloat16", False),       # bert_base
               (128, 128, 4, 32, "bfloat16", False),        # bert_tiny
               (2, 512, 8, 256, "bfloat16", True),
               (2, 512, 8, 256, "float32", True),
               (2, 256, 4, 320, "bfloat16", True),
               (2, 256, 4, 320, "float32", True),
               (64, 197, 12, 64, "bfloat16", False),       # vit_b16
               (64, 197, 16, 64, "bfloat16", False))       # vit_l16
# phase 18's kernel cases: ViT's 197 tokens, non-causal (69 valid rows in
# the last 128-row query tile, 5 in the last 64-wide key tile)
VIT_FLASH_CASES = FLASH_CASES[-2:]
# b * h just above 65535 (the grid's y limit): the three kernels at once,
# the first and last batch rows held to the plain version on them alone
FLASH_WIDE_CASE = (16385, 40, 4, 64, "bfloat16", True)
FLASH_WIDE_ROWS = (0, 16384)
# flash_attention at head dims the kernels do not take: bert_tiny's
# widths (batch 128 x seq 128, 4 heads of 32), zero-padded to 64 inside,
# and head dim 192 at a ragged sequence, zero-padded to 256
FLASH_PADDED_CASES = ((128, 128, 4, 32, "bfloat16", False),
                      (2, 300, 4, 192, "bfloat16", False))
SDPA_BWD_REPEATS = 5               # SDPA's backward spread 0.30-0.71 ms
PLAIN_ITERS = 10                   # the plain version loops over tiles
FLASH_KERNELS = {                  # kernel -> (row name, Pallas call)
    "fwd": ("flash_attention_fwd", "tpu_hc_bench/ops/flash_attention.py:134"),
    "dq": ("flash_attention_dq", "tpu_hc_bench/ops/flash_attention.py:249"),
    "dkv": ("flash_attention_dkv",
            "tpu_hc_bench/ops/flash_attention.py:265"),
}
# gpt2 flash vs dense at full width in float32 (12 layers, batch 2 x 1024):
# loss relative, logits relative to their largest magnitude, gradient
# global norm ||g_flash - g_dense|| / ||g_dense||, parameters after one
# step relative to their largest magnitude; the two arms differ only in
# the attention's summation order (f32 throughout)
LM_LOSS_TOL = 1e-5
LM_LOGITS_TOL = 1e-4
LM_GRAD_TOL = 1e-4
LM_PARAM_TOL = 1e-5
LM_LAYERS = 12                     # one launch of each flash kernel a layer
# (model, batch, arms): each arm (attention_impl, fused_xent) from one
# state_dict, the first the reference; the comparisons (arm, against):
# flash against dense and the fused loss against the unfused one
LM_PARITY = (("gpt2", 2, (("dense", False), ("flash", False),
                          ("flash", True))),
             ("bert_base", 8, (("dense", False), ("flash", False),
                               ("flash", True))))
LM_PARITY_PAIRS = ((1, 0), (2, 1))
# the LM lanes' main paths through launcher.main: (model, batch,
# attention_impl, fused_xent); batch 16 is the tune space's gpt2
# microbatch, 128 its bert_base one; the first run is the slice's main
# path, whose launches the kernel table reports
LM_RUNS = (("gpt2", 16, "flash", True), ("gpt2", 16, "flash", False),
           ("gpt2", 16, "dense", False), ("bert_base", 128, "flash", True),
           ("bert_base", 128, "flash", False))
LM_WARMUP = 10
LM_BATCHES = 30
# phase 13 (dp): the runs' warmup and timed steps, cut from the lanes'
# 50 + 100 for the time limit
DP_WARMUP = 20
DP_BATCHES = 60
DP_LM_BATCH = 16
DP_LM_WARMUP = 3
DP_LM_BATCHES = 10
DP_PARITY_STEPS = 2
DP_ACCUM = 2
DP_NOISE_FACTOR = 3.0              # where the one-worker step is not
                                   # bit-equal to itself
DP_OSU_MAX_BYTES = 64 << 20
DP_SMALL_THRESHOLD = 25 << 20      # several buckets in resnet50's 102 MB
# softmax_xent against its plain version: loss and lse relative to their
# largest magnitude (f32 logsumexps over the vocab in another order);
# dlogits relative to its largest magnitude, 1e-5 in f32, one bf16 ulp
# (2^-7 of the largest) in bf16, where an f32 value a last bit apart can
# round the other way
XENT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# (rows, vocab, dtype): GPT-2's logits (the main path), BERT-base's,
# llama_1b's (batch 2 x seq 2048, untied 32000 head), bf16
XENT_CASES = ((16384, 50257, "float32"), (16384, 30522, "float32"),
              (4096, 32000, "float32"), (4096, 50257, "bfloat16"))
XENT_KERNELS = {                   # kernel -> (row name, Pallas call)
    "fwd": ("softmax_xent_fwd", "tpu_hc_bench/ops/xent.py:99"),
    "bwd": ("softmax_xent_bwd", "tpu_hc_bench/ops/xent.py:151"),
}
# max_pool's backward against its plain version: the same f32 sums in the
# same order, so 1e-6 of the largest magnitude in f32 and one ulp in bf16
# (2^-7 of the largest) bound a last-bit difference
POOL_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# ([B, C, H, W], window, strides, padding, dtype, tied): the stem pool of
# googlenet/resnet (the op's main case), the branch pool, a ragged f32
# input, and a bf16 input of few values, where most windows tie
POOL_CASES = (((128, 64, 112, 112), (3, 3), (2, 2), "SAME", "bfloat16",
               False),
              ((256, 256, 28, 28), (3, 3), (1, 1), "SAME", "bfloat16",
               False),
              ((2, 8, 13, 15), (3, 3), (2, 2), "SAME", "float32", False),
              ((8, 64, 56, 56), (3, 3), (2, 2), "SAME", "bfloat16", True))
POOL_PATH_STEPS = 3                # max_pool forward + backward calls

# phase 14 (realdata): the reference's real-data command on the committed
# fixture of ImageNet-schema shards; (b)-(e) and (g) at these depths
# (b), and phase 15's (c)-(d): cut from the lane's 50 + 100 for the
# script's time limit (to 20 + 50, then to 10 + 30 as phase 23 came)
REAL_BATCHES = {"b": (10, 30), "c": (10, 30), "d": (10, 30), "e": (5, 20),
                "g": (10, 30)}
# the reference's flag line, less --device=cpu (here the caller's CPU)
REFERENCE_LINE = [
    "--data_name=imagenet", "--data_format=NCHW", "--optimizer=momentum",
    "--forward_only=False", "--mkl=TRUE", "--variable_update=horovod",
    "--horovod_device=cpu", "--local_parameter_device=cpu",
    "--num_intra_threads=7", "--num_inter_threads=2", "--kmp_blocktime=1",
    "--kmp_affinity=granularity=fine,compact,1,0"]
FIXTURE_SIZE, FIXTURE_BATCH = 64, 16     # expected_crops.npz's crops
# the fixture's crops against the JAX pipeline's (libjpeg): bit-equal with
# the port's libjpeg decoder; with nvJPEG the mean |difference| over every
# pixel, within 12 levels: the fixture's noise JPEGs have 4:2:0 chroma of
# full-band noise, where nvJPEG's chroma upsampling and IDCT rounding part
# from libjpeg's (9.65-9.91 levels, max 88-94, on a first card run)
NVJPEG_MEAN_TOL = 12.0
# each decoder's crops of the fixture against the JAX pipeline's: libjpeg
# is that pipeline's decoder, and pil decodes with PIL's libjpeg-turbo
# at the same DCT scale into the same crop and resize (bit-equal to
# libjpeg at scales 1-8 in the CPU tests); nvJPEG as above
DECODER_MEAN_TOL = {"libjpeg": 0.0, "pil": 0.0, "nvjpeg": NVJPEG_MEAN_TOL}
OPT_BATCH = 32
OPT_STEPS = 3
# each optimizer against the plain one (optax's formulas written out) on
# the same gradients, relative to the parameters' scale: the CPU tests'
# tolerances (tests/test_torch_realdata.py OPT_TOL)
OPT_TOL = {"adam": 1e-5, "adamw": 1e-5, "rmsprop": 2.4e-7}
TOKEN_CORPUS = 1 << 21                    # gpt2 tokens in train.bin

# phase 15 (slice7): (c) and (d) at phase 14 (b)'s depth; (e) the
# checkpoint legs (save, then resume), (f) across cards
SLICE7_BATCHES = {"e": (10, 50), "f": (20, 60)}
SLICE7_SAVE_STEPS = 25
# phase 16 (serve2): phase 4's trace; gpt2 fits it (512 + 64 <= 1024)
SERVE2_TRACE = ("--max_prompt_len=512", "--max_output_len=64",
                "--max_in_flight=8", "--kv_page_size=16",
                "--num_requests=16", "--arrival=poisson",
                "--arrival_rate=64", "--seed=0")
GPT2_PARITY_TOL = 1e-3             # 12 layers of f32 at width 768
# int8_kv's logits against the f32 program's, relative to the f32
# logits' largest magnitude: each K/V value rounds within amax/254 of its
# page, and the error passes through 16 layers
INT8_KV_REL_TOL = 0.05
SLICE13_OBS_STEPS = (3, 10)         # phase 21 (a): warmup, timed steps
SLICE13_PROFILE = "3:5"             # (a)'s profiler window
SLICE13_SKIP = (2, 6, 3)            # (b): warmup, timed steps, poisoned
SLICE13_VIT = (32, 8, 5)            # (b) vit_b16: batch, steps, poisoned
SLICE13_SMALL_BATCH = 32            # (b)'s abort, (c), (d), (e)
SLICE13_REWIND = 8                  # (c): timed steps
SLICE13_SIGTERM = (6, 3)            # (d): timed steps, the SIGTERM's step
SLICE13_HANG = (8.0, 120)           # (e): --step_timeout_s, hang seconds
# phase 22 (slice14): sequence parallelism and zero1; (warmup, timed)
SLICE14_STEPS = (3, 10)
# (a): model, batch, layers, extra flags; each at its registry length
SLICE14_LM = (("gpt2", 16, 12, ("--fused_xent=true",)),
              ("llama_1b", 2, 16, ()))
# (a) ring (float32 folds, float32 probabilities) against dense (bf16
# probabilities) from one seed: the first step's loss, relative, and the
# last one after the updates have compounded it
SLICE14_RING_FIRST_TOL = 5e-3
SLICE14_RING_LAST_TOL = 2e-2
SLICE14_ZERO1_STEPS = (3, 20)      # (b) resnet50, batch 128
SLICE14_SHARD_TOKENS = 2048        # (c) llama_1b tokens a rank's shard
SLICE14_SHARD_BATCH = 2
# (c): the ring keeps a float32 [b, h, s/n, s/n] tensor a fold, n folds a
# layer; above this many GB of them a run recomputes each layer
SLICE14_REMAT_GB = 40.0
SLICE14_MULTI = ((2, 2), (4, 4), (4, 2))   # (c): (cards, sp)
# phase 23 (slice15): elastic resume, multislice, TP and EP
SLICE15_STEPS = (3, 10)            # (warmup, timed) of every run
SLICE15_GPT2_BATCH = 16            # (a), (c): gpt2 16 x 1024
SLICE15_LLAMA_BATCH = 2            # (c): llama_1b 2 x 2048
SLICE15_MOE_BATCH = 8              # (d): gpt2_moe 8 x 1024
# (a): the TP layers at tp 1 order no product differently, so the losses
# are held bit-equal; this is the bound if a product did
SLICE15_TP1_TOL = 1e-3
# (b): the CPU workers' zero1 checkpoint (resnet50, batch 2, 1 + 1 steps)
SLICE15_CPU_WORKERS = 2
SLICE15_RESUME_BATCH = 32          # (b): the card's resumed steps
# (c)/(d): (model, batch, world, flag, degree); (e) resnet50 batch 128 a
# card at 2 slices of 2; (f) resnet50 batch 32 zero1 4 -> 2 -> 4
SLICE15_TP = (("gpt2", SLICE15_GPT2_BATCH, 2, "model_parallel", 2),
              ("gpt2", SLICE15_GPT2_BATCH, 4, "model_parallel", 2),
              ("llama_1b", SLICE15_LLAMA_BATCH, 2, "model_parallel", 2),
              ("llama_1b", SLICE15_LLAMA_BATCH, 4, "model_parallel", 4),
              ("gpt2_moe", SLICE15_MOE_BATCH, 2, "expert_parallel", 2),
              ("gpt2_moe", SLICE15_MOE_BATCH, 4, "expert_parallel", 4))
SLICE15_ELASTIC_BATCH = 32
# phase 24 (slice 16): pipeline parallelism and the 3-D hybrids
SLICE16_STEPS = (3, 10)            # (warmup, timed) of every run
SLICE16_GPT2_BATCH = 16            # (a), (c), (e): gpt2 16 x 1024
SLICE16_M = 4                      # (a): microbatches of the one stage
SLICE16_ONE_STAGE_TOL = 1e-3       # (a): microbatched products take other
                                   # cuBLAS shapes than the whole batch's
SLICE16_CPU_WORKERS = 2            # (b): llama_tiny at pp 2 on the CPU
SLICE16_LLAMA_BATCH = 4            # (d): llama_1b 4 x 2048 (pp 4 needs
                                   # M = 4 to divide the batch)
SLICE16_LLAMA_TOL = 1e-3           # (d): final loss against world 1 at
                                   # the same M microbatches (accumulation:
                                   # M alone moves llama_1b's 13th loss by
                                   # ~8e-3 from the one-batch step)
SLICE16_SPTP_BATCH = 2             # (e): llama_1b 2 x 2048 at sp 2 x tp 2
SLICE16_CKPT_STEPS = (1, 1)        # (f): the pp 2 run that saves
SLICE16_LLAMA = "llama_1b"         # (d)-(f)
SLICE16_LAYERS = {"gpt2": 12, "llama_1b": 16}
SERVE2_SHARED = (16, 100, 32)      # (e): requests of one 100-token prompt
                                   # (6 pages + a 4-token tail), outputs
# (e) and (f) in virtual time: modeled seconds a step, so the arms see
# the same batches and (f)'s plan forces the same dispositions every run
SERVE2_VCOSTS = {"prefill": 0.03, "decode": 0.02, "page_copy": 0.001}
# (f): a burst of phase 4's 16 requests into 3 worst-case tables' pages,
# 20 withheld from t = 0.5 s, request 2 poisoned, a 3 s deadline: in
# these modeled costs 7 sheds (both causes), 9 preempts, 4 requeues and
# 1 quarantine (a CPU rehearsal of the same schedule; the dispositions
# depend on the clock and the plan, not on the weights)
SERVE2_F = dict(kv_pages=1 + 3 * 36,
                plan="nan_logits@2,pool_squeeze@0.5:20", deadline_ms=3000.0)
SERVE2_SIGTERM = (32, 0.3)         # (f) subprocess: requests, SIGTERM at s

# phase 17 (slice9): the decoder lane's rest; (warmup, timed) steps
SLICE9_LLAMA_BATCH = 2             # llama_1b: batch 2 x seq 2048
SLICE9_MOE_BATCH = 8               # gpt2_moe: batch 8 x seq 1024
SLICE9_STEPS = (5, 20)             # short: the script's time limit
# llama_1b's first forward, bf16 flash against bf16 dense from one seed
# (summation order and bf16 rounding through 16 layers): the loss
# relative, the logits relative to their largest magnitude
SLICE9_FIRST_LOSS_TOL = 1e-3
SLICE9_FIRST_LOGITS_TOL = 5e-2
# (b) remat recomputes the same products: its final loss against (a)'s
SLICE9_REMAT_LOSS_TOL = 1e-3
SLICE9_SEARCH_STEPS = (2, 3)       # (b)'s batch search, each batch
SLICE9_MAX_BATCH = 64
SLICE9_ACCUM = 8                   # (d): microbatch 1 of 1024 tokens
SLICE9_ACCUM_STEPS = (3, 10)
# (d) bf16 accumulation against f32 after 13 steps: each microbatch's
# gradient rounded to bf16 (2^-8 relative), relative final-loss change;
# each arm's final loss must also lie SLICE9_ACCUM_MOVED times as far
# from the loss with no update (a forward-only run on the same batch)
SLICE9_ACCUM_LOSS_TOL = 2e-3
SLICE9_ACCUM_MOVED = 5.0
SLICE9_SCAN_STEPS = (3, 10)        # (e): scanned against unrolled
SLICE9_SCAN_GPT2_BATCH = 8
SLICE9_SCAN_LOSS_TOL = 1e-3
SLICE9_GREEDY_CHECKS = 4           # (f): requests held to the forward

# phase 18 (zoo): the image zoo; (warmup, timed) steps
ZOO_VIT_BATCH = 64
ZOO_VIT_STEPS = (10, 30)           # (a), (b)
ZOO_VIT_L_STEPS = (5, 15)          # (c)
ZOO_STEPS = (2, 5)                 # (d), and (e)'s profiled steps
ZOO_SEARCH_STEPS = (1, 2)          # (b)'s batch search, each batch
ZOO_MAX_BATCH = 1024               # 4096 fits too; the searches at 2048
                                   # and 4096 cost ~34 s of the limit
ZOO_VIT_LAYERS = {"vit_b16": 12, "vit_l16": 24}
# (a) vit_b16's first forward on the runs' batch, bf16 flash against bf16
# dense from one seed, dropout drawn alike (summation order and bf16
# rounding through 12 layers): the loss relative
ZOO_VIT_FIRST_LOSS_TOL = 2e-3     # 1.54e-4 measured
# (b) remat recomputes the same products with the forward's masks: its
# final loss against (a)'s flash run
ZOO_REMAT_LOSS_TOL = 1e-3
# (d) each member's first bf16 loss against the float32 forward of the
# same seeded model on the same batch (bf16 activations through up to
# ~100 layers; BatchNorm renormalizes each), relative; measured up to
# 1.3e-2 (nasnetlarge at batch 16), 2.4e-3 elsewhere
ZOO_BF16_LOSS_TOL = 5e-2
# (d) the members at the JAX package's plain batches (BASELINE.md's zoo
# table, a configuration here), each once, then resnet18 and resnet50_v2
# again with --use_space_to_depth
ZOO_BATCHES = {"trivial": 512, "lenet": 2048, "alexnet": 512,
               "overfeat": 256, "googlenet": 256, "mobilenet": 256,
               "densenet40_k12": 512, "densenet100_k12": 256,
               "nasnet": 128, "nasnetlarge": 16, "resnet18": 256,
               "resnet34": 256, "resnet50_v2": 128, "resnet101_v2": 128,
               "resnet152_v2": 128, "resnet20_cifar": 1024,
               "resnet32_cifar": 1024, "resnet44_cifar": 512,
               "resnet56_cifar": 512, "resnet110_cifar": 256,
               "vgg11": 128, "vgg16": 128, "vgg19": 128,
               "inception3": 128, "inception4": 64}
ZOO_S2D = ("resnet18", "resnet50_v2")
ZOO_IDLE = ("nasnet", "lenet")     # (e): host-bound members profiled
# phase 19 (slice11): the speech and recommendation members and the
# classify mode, at the JAX package's tuned plain batches
# (tpu_hc_bench/tune/space.py), a configuration here; (warmup, timed)
SLICE11_DS2_BATCH = 256
SLICE11_DS2_STEPS = (2, 5)         # (a), and its profiled steps
SLICE11_ARM_STEPS = (1, 3)         # (b)
SLICE11_NCF_BATCH = 1048576
SLICE11_NCF_STEPS = (2, 5)         # (c)
SLICE11_NCF_EVAL = (1, 2)          # (c)'s --eval batches
# (a) the first bf16 CTC loss against the float32 forward of the same
# weights on the same batch (bf16 through a 5-layer, 75-frame recurrence)
SLICE11_BF16_LOSS_TOL = 5e-2
# (b) each arm's first bf16 loss against hoisted's on one set of weights:
# bidi runs the same products batched over the directions, flax keeps
# the carry in float32 (Flax's GRUCell)
SLICE11_ARM_LOSS_TOL = 2e-2
# (d) the classify mode: resnet50 and deepspeech2 at full width, float32
SLICE11_SERVE_MODELS = ("resnet50", "deepspeech2")
SLICE11_SERVE_TRACE = ["--num_requests=32", "--max_in_flight=8",
                       "--arrival=poisson", "--arrival_rate=64"]
# phase 20 (slice12): (c)'s SIGTERM in engine seconds (virtual time, as
# (a)); (d) phase 17 (d)'s run at 1 + 2 steps, and the share of the
# float32 parameter bytes the optimizer step may add over the bf16
# gradients (one parameter's float32 gradient at a time: gpt2_moe's
# largest, the embedding, is 0.15 of 1.05 GB)
SLICE12_SIGTERM_S = 0.3
SLICE12_ACCUM_STEPS = (1, 2)
SLICE12_STEP_SHARE = 0.25



T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's record also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event timing of single calls on the card, L2 flushed before
    each; a spin after the flush gives the host a head start, so a call
    whose host work fits in it is timed by its device work alone."""

    def __init__(self, torch, device):
        self.torch = torch
        # larger than the H100's 50 MB L2
        self.flush = torch.empty(128 << 20, dtype=torch.uint8,
                                 device=device)

    def median_ms(self, fn, iters: int = TIMED_ITERS) -> float:
        torch = self.torch
        for _ in range(WARMUP_ITERS):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(HEAD_START_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev, timer, smi) -> dict:
    """Phase 2; returns the main-path numbers of each kernel."""
    import numpy as np
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops.fused_residual_ln import (
        fused_residual_norm, fused_residual_norm_plain)
    from tpu_hc_bench_torch.ops.paged_attention import (
        KERNELS as PAGED_KERNELS, paged_decode_attention,
        paged_decode_attention_plain, paged_splits)

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    out_main = {}
    for case in PAGED_CASES:
        name, L, b, w, (lo, hi), kinds = case
        heads, kvh, d, ps = 32, 8, 64, 16           # llama_1b
        pages = 1 + b * w
        layer = L - 1 if name == "long_context" else 5
        lengths = rng.integers(lo, hi + 1, (b,)).astype(np.int32)
        tables = (1 + rng.permutation(b * w)).reshape(b, w).astype(np.int32)
        if name == "llama_1b":
            lengths[3] = 0                              # a padded row
            lengths[0] = w * ps                         # a full table
            tables[3] = 0                               # padded: trash page
        tables_d, lengths_d = t(tables), t(lengths)
        tokens = int(lengths.sum())
        pages_read = int(sum(-(-int(n) // ps) for n in lengths))
        visible = torch.from_numpy(lengths > 0).to(dev)
        for kind in kinds:
            elt = {"f32": 4, "bf16": 2, "int8": 1}[kind]
            shape = (L, pages, ps, kvh, d)
            if kind == "int8":
                kp, vp = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                        device=dev) for _ in range(2))
                sc = {"k_scales": 0.02 * torch.rand((L, pages), device=dev),
                      "v_scales": 0.02 * torch.rand((L, pages), device=dev)}
            else:
                dt = torch.float32 if kind == "f32" else torch.bfloat16
                kp, vp = (torch.randn(shape, device=dev).to(dt)
                          for _ in range(2))
                sc = {}
            q = torch.randn((b, heads, d), device=dev).to(
                torch.bfloat16 if kind == "bf16" else torch.float32)
            for ppb in (1, 2):
                splits = paged_splits(b, kvh, w, ps, ppb, sm_count)

                def kernel():
                    return paged_decode_attention(
                        q, kp, vp, tables_d, lengths_d, pages_per_block=ppb,
                        layer=layer, return_lse=True, **sc)

                def plain():
                    return paged_decode_attention_plain(
                        q, kp, vp, tables_d, lengths_d, pages_per_block=ppb,
                        layer=layer, return_lse=True, splits=splits, **sc)

                got, lse = kernel()
                want, want_lse = plain()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                rel = rel_err(got, want)
                lse_err = float((lse - want_lse)[visible].abs().max())
                pad_ok = bool((got[~visible] == 0).all()
                              and torch.isfinite(lse).all()
                              and (lse[~visible] < -1e29).all())
                ms = timer.median_ms(kernel)
                plain_ms = timer.median_ms(plain, PLAIN_ITERS)
                nbytes = (2 * tokens * kvh * d * elt
                          + 2 * b * heads * d * q.element_size()
                          + b * heads * 4 + b * w * 4 + b * 4
                          + (2 * pages_read * 4 if kind == "int8" else 0))
                bound_ms, bound_by = bound(nbytes, 4.0 * tokens * heads * d)
                tol = PAGED_TOL[kind]
                rec = {"phase": "kernel", "name": "paged_decode_attention",
                       "case": name, "pool": kind, "q_dtype": str(
                           q.dtype).replace("torch.", ""),
                       "pages_per_block": ppb, "splits": splits,
                       "design": "split+merge", "kernels": list(PAGED_KERNELS),
                       "shape": {"b": b, "heads": heads, "kv_heads": kvh,
                                 "d": d, "page_size": ps, "w": w,
                                 "pool_pages": pages, "layers": L},
                       "lengths": lengths.tolist(), "max_abs_err": err,
                       "rel_err": rel, "lse_max_abs_err": lse_err,
                       "tol": tol, "padded_row_ok": pad_ok, "ms": ms,
                       "plain_ms": plain_ms, "plain_note": "split plain "
                       "version at the kernels' splits",
                       "gbytes_per_s": nbytes / ms / 1e6,
                       "pct_of_bound": 100.0 * bound_ms / ms,
                       "mbytes": nbytes / 1e6, "bound_ms": bound_ms,
                       "bound_by": bound_by, "nvidia_smi": smi}
                if ppb == 1 and kind in ("f32", "bf16"):
                    # yardstick: SDPA over a pre-gathered dense cache
                    kd = kp[layer][tables_d.long()].reshape(b, w * ps, kvh, d)
                    vd = vp[layer][tables_d.long()].reshape(b, w * ps, kvh, d)
                    kd = kd.repeat_interleave(heads // kvh, 2).transpose(1, 2)
                    vd = vd.repeat_interleave(heads // kvh, 2).transpose(1, 2)
                    kd, vd = kd.contiguous().to(q.dtype), vd.contiguous().to(
                        q.dtype)
                    mask = (torch.arange(w * ps, device=dev)[None, :]
                            < lengths_d[:, None])[:, None, None, :]
                    q4 = q[:, :, None, :]
                    rec["library_ms"] = timer.median_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, kd, vd, attn_mask=mask))
                    rec["library_note"] = ("SDPA on a pre-gathered dense "
                                           "cache")
                    del kd, vd
                    if (name, kind) == ("llama_1b", "f32"):
                        out_main["paged_decode_attention"] = rec
                emit(rec)
                if not ((err <= tol if kind != "bf16" else rel <= tol)
                        and lse_err <= PAGED_LSE_TOL and pad_ok):
                    raise AssertionError(f"paged_decode_attention {name} "
                                         f"{kind} ppb={ppb} disagrees: {rec}")
            del kp, vp, sc
            torch.cuda.empty_cache()
    paged_rounding_check(torch, dev, smi)

    paged_off_list_check(torch, dev, timer, smi)
    out_main["fused_residual_norm"] = phase_norm(torch, dev, timer, smi)
    return out_main


def paged_off_list_check(torch, dev, timer, smi) -> None:
    """Phase 2: paged decode attention at head dims off the template list
    (``PAGED_OFF_LIST``), llama_1b's other widths, against the split
    plain version at the rule's splits, within PAGED_TOL."""
    import numpy as np

    from tpu_hc_bench_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain, paged_splits)

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(2)
    b, heads, kvh, ps, w, L = 8, 32, 8, 16, 36, 2
    pages = 1 + b * w
    lengths = rng.integers(1, w * ps + 1, (b,)).astype(np.int32)
    lengths[3] = 0
    tables = (1 + rng.permutation(b * w)).reshape(b, w).astype(np.int32)
    tables[3] = 0
    tables_d, lengths_d = (torch.from_numpy(a).to(dev)
                           for a in (tables, lengths))
    splits = paged_splits(b, kvh, w, ps, 1, sm_count)
    for d, kind in PAGED_OFF_LIST:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        kp, vp = (torch.randn((L, pages, ps, kvh, d), device=dev).to(dt)
                  for _ in range(2))
        q = torch.randn((b, heads, d), device=dev).to(dt)

        def kernel():
            return paged_decode_attention(q, kp, vp, tables_d, lengths_d,
                                          layer=1, return_lse=True)

        got, lse = kernel()
        want, want_lse = paged_decode_attention_plain(
            q, kp, vp, tables_d, lengths_d, layer=1, return_lse=True,
            splits=splits)
        torch.cuda.synchronize()
        live = lengths_d > 0
        err = (rel_err(got, want) if kind == "bf16"
               else float((got.float() - want.float()).abs().max()))
        lse_err = float((lse - want_lse)[live].abs().max())
        row_bytes = d * kp.element_size()
        rec = {"phase": "kernel", "name": "paged_decode_attention",
               "case": f"head_dim_{d}", "pool": kind, "d": d,
               "template_case": next(t for t in (16, 32, 64, 128, 256)
                                     if t >= d),
               "loads": "16-byte" if row_bytes % 16 == 0 else "scalar",
               "splits": splits, "max_abs_err": err, "lse_max_abs_err":
               lse_err, "tol": PAGED_TOL[kind], "ms": timer.median_ms(kernel),
               "nvidia_smi": smi}
        emit(rec)
        if not (err <= PAGED_TOL[kind] and lse_err <= PAGED_LSE_TOL
                and bool((got[~live] == 0).all())):
            raise AssertionError(f"paged at head dim {d} disagrees: {rec}")
        del kp, vp


def phase_norm(torch, dev, timer, smi) -> dict:
    """Phase 2: the fused residual+norm in both designs at NORM_ROWS rows
    of llama_1b's 2048, f32 and bf16, rmsnorm and layernorm, and at the
    NORM_WIDE rows, each against its plain version (y bit-equal, out
    within NORM_TOL); beside each, the plain version, the two-launch
    library route (``torch.add`` then
    ``F.rms_norm``/``F.layer_norm``), the library norm alone on a
    precomputed y, the launch floor (an empty launch, and an empty
    cluster of 8 CTAs), the byte bound, and the host's time to enqueue
    one wrapper call (HOST_CALLS back to back).  Returns the main path's
    record: 8 rows, f32, rmsnorm, the design ``norm_design`` picks."""
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops.fused_residual_ln import (
        DESIGNS, empty_launch, fused_residual_norm, fused_residual_norm_plain,
        norm_design, norm_launch)

    floor = {"empty_ms": timer.median_ms(lambda: empty_launch(dev)),
             "empty_cluster8_ms": timer.median_ms(
                 lambda: empty_launch(dev, 8))}
    emit({"phase": "kernel", "name": "launch_floor", **floor,
          "nvidia_smi": smi})
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    main = None
    cases = [(dname, NORM_HIDDEN, rows, kind)
             for dname in ("float32", "bfloat16") for rows in NORM_ROWS
             for kind in ("rmsnorm", "layernorm")]
    cases += [(dname, hidden, rows, "rmsnorm")
              for dname, hidden, rows in NORM_WIDE]
    for dname, hidden, rows, kind in cases:
        dtype = getattr(torch, dname)
        res, x = (torch.randn((rows, hidden), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        g = torch.randn((hidden,), generator=gen, device=dev).to(dtype)
        bta = (torch.randn((hidden,), generator=gen, device=dev).to(dtype)
               if kind == "layernorm" else None)
        eps = 1e-6 if kind == "layernorm" else 1e-5
        wy, wo = fused_residual_norm_plain(res, x, g, bta, kind=kind)
        if kind == "rmsnorm":
            norm = lambda y: F.rms_norm(y, (hidden,), g, eps)  # noqa: E731
        else:
            norm = lambda y: F.layer_norm(  # noqa: E731
                y, (hidden,), g, bta, eps)
        yc = res + x
        elt = res.element_size()
        nbytes = 4 * rows * hidden * elt + hidden * elt * (
            2 if bta is not None else 1)
        bound_ms, bound_by = bound(nbytes, 5.0 * rows * hidden)
        common = {
            "plain_ms": timer.median_ms(lambda: fused_residual_norm_plain(
                res, x, g, bta, kind=kind)),
            "library_ms": timer.median_ms(lambda: norm(torch.add(res, x))),
            "library_note": "torch.add then F.rms_norm or F.layer_norm: "
                            "two launches",
            "norm_alone_ms": timer.median_ms(lambda: norm(yc)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            **floor}
        rule = norm_design(rows, hidden, dtype)
        for design in DESIGNS:
            launch = norm_launch(hidden, dtype, design)
            if launch is None:          # the design does not take the width
                continue

            def kernel():
                return fused_residual_norm(res, x, g, bta, kind=kind,
                                           design=design)

            y, o = kernel()
            torch.cuda.synchronize()
            y_equal = bool(torch.equal(y, wy))
            err = float((o.float() - wo.float()).abs().max())
            rel = rel_err(o, wo)
            ms = timer.median_ms(kernel)
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                kernel()
            host_us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
            torch.cuda.synchronize()
            rec = {"phase": "kernel", "name": "fused_residual_norm",
                   "kind": kind, "dtype": dname, "rows": rows,
                   "hidden": hidden, "design": design,
                   "norm_design": rule, "launch": launch._asdict(),
                   "y_bit_equal": y_equal, "max_abs_err": err,
                   "rel_err": rel, "tol": NORM_TOL[dname],
                   "ms": ms, "host_us_per_call": host_us, **common,
                   "pct_of_bound": 100.0 * bound_ms / ms,
                   "gbytes_per_s": nbytes / ms / 1e6,
                   "nvidia_smi": smi}
            emit(rec)
            ok = y_equal and (err if dname == "float32"
                              else rel) <= NORM_TOL[dname]
            if not ok:
                raise AssertionError(f"fused_residual_norm disagrees: {rec}")
            if ((dname, hidden, rows, kind) == (
                    "float32", NORM_HIDDEN, 8, "rmsnorm")
                    and design == rule):
                main = rec
        del res, x, yc
    return main


def paged_rounding_check(torch, dev, smi) -> None:
    """Phase 2's bf16 rounding case: an f32 q over a bf16 pool (out f32),
    one row of three keys scored about 0, -1 and -2 (p no bf16 value)."""
    from tpu_hc_bench_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    d, ps = 16, 4
    q = torch.zeros((1, 1, d), device=dev)
    q[0, 0, 0] = 1.0
    k = torch.zeros((1, ps, 1, d), device=dev)
    k[0, :3, 0, 0] = torch.tensor([0.0, -1.0, -2.0], device=dev) * d ** 0.5
    v = torch.zeros((1, ps, 1, d), device=dev)
    v[0, :3, 0, 0] = torch.tensor([1.0, 2.0, 4.0], device=dev)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    ln = torch.tensor([3], dtype=torch.int32, device=dev)
    kb, vb = k.bfloat16(), v.bfloat16()
    got = paged_decode_attention(q, kb, vb, tbl, ln)
    want = paged_decode_attention_plain(q, kb, vb, tbl, ln)
    exact = paged_decode_attention_plain(q, k, v, tbl, ln)
    torch.cuda.synchronize()
    rec = {"phase": "kernel", "name": "paged_decode_attention",
           "case": "bf16_p_rounding", "max_abs_err": float(
               (got - want).abs().max()),
           "unrounded_err": float((got - exact).abs().max()),
           "tol": PAGED_ROUNDING_TOL, "nvidia_smi": smi}
    emit(rec)
    if not (got.dtype == torch.float32
            and rec["max_abs_err"] <= PAGED_ROUNDING_TOL
            < rec["unrounded_err"]):
        raise AssertionError(f"paged bf16 p rounding disagrees: {rec}")


def phase_parity(torch, dev, model) -> None:
    """Phase 3: paged vs gather program logits at full width."""
    import numpy as np

    from tpu_hc_bench_torch.serve import decode as decode_mod

    family = decode_mod.build_family(model)
    ps, w, b, steps = 16, 36, 2, 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, model.vocab_size, n).astype(np.int32)
               for n in (100, 37)]
    feed = rng.integers(1, model.vocab_size, (steps, b)).astype(np.int32)
    tables = np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    logits = {}
    for arm in ("gather", "paged"):
        kv = decode_mod.init_kv_state(family, 1 + b * w, ps, device=dev)
        prefill = decode_mod.build_prefill_fn(family, ps, w)
        decode = decode_mod.build_decode_fn(family, ps, w, attention=arm)
        lengths = np.zeros((b,), np.int32)
        for i, prompt in enumerate(prompts):
            toks = np.zeros((1, 128), np.int32)
            toks[0, :len(prompt)] = prompt
            prefill(kv, t(toks), len(prompt), t(tables[i]))
            lengths[i] = len(prompt)
        out = []
        for s in range(steps):
            _, lg, kv = decode(kv, t(feed[s]), t(tables), t(lengths),
                               t(np.ones((b,), bool)))
            out.append(lg)
            lengths += 1
        logits[arm] = torch.stack(out)
        del kv
    ref, got = logits["gather"], logits["paged"]
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * PARITY_TOL
    argmax_ok = bool((got.argmax(-1) == ref.argmax(-1))[clear].all())
    rec = {"phase": "parity", "model": "llama_1b", "prompts": [100, 37],
           "decode_steps": steps, "shape": list(got.shape),
           "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": err, "tol": PARITY_TOL,
           "argmax_equal_where_top2_gap_gt_2tol": argmax_ok}
    emit(rec)
    if not (rec["finite"] and err <= PARITY_TOL and argmax_ok
            and rec["shape"] == [steps, b, model.vocab_size]):
        raise AssertionError(f"paged program disagrees with gather: {rec}")


PHASE4_FLAGS = ["--model=llama_1b", "--decode_attention=paged",
                "--max_prompt_len=512", "--max_output_len=64",
                "--max_in_flight=8", "--kv_page_size=16",
                "--num_requests=16", "--arrival=poisson",
                "--arrival_rate=64", "--seed=0"]


def phase_serve(torch, model) -> dict:
    """Phase 4: the main path; returns each kernel's launch count."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.ops.fused_residual_ln import (
        fused_residual_norm, norm_design)
    from tpu_hc_bench_torch.ops.paged_attention import paged_decode_attention
    from tpu_hc_bench_torch.serve import cli

    cfg = flags.parse_flags(PHASE4_FLAGS)
    engine, requests = cli.build_engine_and_requests(
        cfg, lambda m: print(m, file=sys.stderr, flush=True), model=model)
    tap = TokenTap()
    paged_decode_attention.launches = 0
    fused_residual_norm.launches = 0
    summary = engine.run(requests, writer=tap)
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "fused_residual_norm": fused_residual_norm.launches}
    torch.cuda.synchronize()
    steps = summary["decode_steps"]
    layers = model.num_layers
    rec = {"phase": "serve", "launches": launches,
           "fused_residual_norm_design": fused_residual_norm.design,
           "expected": {"paged_decode_attention": layers * steps,
                        "fused_residual_norm": (2 * layers - 1) * steps},
           **{k: summary[k] for k in (
               "requests", "completed", "wall_s", "tokens", "tokens_per_s",
               "decode_steps", "prefill_steps", "p50_ttft_ms",
               "p99_ttft_ms", "p50_e2e_ms", "p99_e2e_ms", "p50_queue_ms",
               "p99_queue_ms", "max_in_flight", "kv_pages",
               "kv_page_size", "decode_attention")}}
    emit(rec)
    if not (summary["completed"] == summary["requests"] == 16 and steps > 0
            and all(v > 0 for v in launches.values())
            and launches == rec["expected"]
            and fused_residual_norm.design == norm_design(
                8, model.hidden, torch.float32)):
        raise AssertionError(f"serve run off its kernels: {rec}")
    return launches, {"tokens": tap.tokens, "summary": summary,
                      "weight_bytes": engine.weight_bytes,
                      "kv_pool_bytes": engine.kv_pool_bytes}


class TokenTap:
    """An engine writer that keeps each served request's tokens and
    every record by kind."""

    def __init__(self):
        self.tokens: dict[int, list[int]] = {}
        self.kinds: dict[str, int] = {}

    def event(self, kind: str, **fields) -> None:
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        if kind == "request":
            self.tokens[fields["id"]] = fields["generated"]


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def phase_conv(torch, dev, timer, smi) -> dict:
    """Phase 5; returns the main-path row of the fused conv."""
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops.fused_conv import (
        conv_design, eligible, fused_bn_relu_conv, fused_bn_relu_conv_plain)

    torch.backends.cudnn.benchmark = True       # as the train driver
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    main_row = None
    for (n, h, cin, cout), dtypes in CONV_CASES:
        for dname in dtypes:
            dtype = getattr(torch, dname)
            y1 = torch.randn((n, h, h, cin), generator=gen,
                             device=dev).to(dtype)
            a = 0.5 + torch.rand((cin,), generator=gen, device=dev)
            b = 0.2 * torch.randn((cin,), generator=gen, device=dev)
            w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                 * (2.0 / (9 * cin)) ** 0.5).to(dtype)

            def kernel():
                return fused_bn_relu_conv(y1, a, b, w)

            def plain():
                return fused_bn_relu_conv_plain(y1, a, b, w)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(g, wt) for g, wt in zip(got, want)]
            abs_err = float((got[0].float() - want[0].float()).abs().max())
            # NCHW channels_last views of the same bytes, for cuDNN
            x_nchw = y1.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            av, bv = a.view(1, -1, 1, 1), b.view(1, -1, 1, 1)
            xn = torch.relu(x_nchw.float() * av + bv).to(dtype)

            def unfused():
                y = F.conv2d(torch.relu(x_nchw.float() * av + bv).to(dtype),
                             w_oihw, padding=1)
                yf = y.float()
                return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))

            ms, plain_ms = timer.median_ms(kernel), timer.median_ms(plain)
            library_ms = timer.median_ms(
                lambda: F.conv2d(xn, w_oihw, padding=1))
            unfused_ms = timer.median_ms(unfused)
            elt = y1.element_size()
            nbytes = (n * h * h * (cin + cout) * elt + 9 * cin * cout * elt
                      + 2 * cin * 4 + 2 * cout * 4)
            ops = 2.0 * n * h * h * cout * 9 * cin
            peak = BF16_OPS_PER_S if dname == "bfloat16" else F32_OPS_PER_S
            bound_ms, bound_by = bound(nbytes, ops, peak)
            rec = {"phase": "conv", "name": "fused_bn_relu_conv",
                   "shape": [n, h, h, cin], "cout": cout, "dtype": dname,
                   "design": conv_design(dtype, h, cin, cout),
                   "eligible": eligible((n, h, h, cin), (3, 3), 1, cin),
                   "max_abs_err": abs_err, "y2_rel_err": errs[0],
                   "s1_rel_err": errs[1], "s2_rel_err": errs[2],
                   "tol": {"y2": CONV_Y_TOL[dname], "stats": CONV_STATS_TOL},
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_note": "cuDNN F.conv2d of a precomputed xn",
                   "unfused_ms": unfused_ms,
                   "kernel_over_unfused": ms / unfused_ms,
                   "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
                   "tflops": ops / ms / 1e9,
                   "pct_of_bound": 100.0 * bound_ms / ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "peak_ops_per_s": peak, "nvidia_smi": smi}
            emit(rec)
            if not (errs[0] <= CONV_Y_TOL[dname]
                    and max(errs[1:]) <= CONV_STATS_TOL):
                raise AssertionError(f"fused_bn_relu_conv disagrees: {rec}")
            if ((n, h, cin, cout), dname) == CONV_MAIN_CASE:
                main_row = rec
    return main_row


def norm_err(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of two dicts."""
    num = sum(float(((got[k].float() - want[k].float()) ** 2).sum())
              for k in want)
    den = sum(float((want[k].float() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def seeded_resnet50(torch, dev):
    """resnet50 in float32 from seed 0 with every BatchNorm's scale and
    shift perturbed (seed 1), so every gradient is live; and its spec."""
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.models.resnet import BatchNorm

    ref, spec = create_model("resnet50", torch.float32, device=dev, seed=0,
                             train=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(
                    m.weight.shape, generator=gen, device=dev))
                m.bias.copy_(0.1 * torch.randn(
                    m.bias.shape, generator=gen, device=dev))
    return ref, spec


def phase_train_parity(torch, dev, smi) -> None:
    """Phase 6: fused vs unfused resnet50, float32, one step each.

    The gradients of a full-width resnet50 at initialisation are ill
    conditioned in float32 (the BatchNorm backward subtracts near-equal
    means), so the fused route's gradient error is held against a noise
    floor measured in the same run: the unfused model again in NCHW
    memory, the same math through other cuDNN kernels."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops.fused_conv import fused_bn_relu_conv
    from tpu_hc_bench_torch.train import step as step_mod

    cfg = flags.BenchmarkConfig(init_learning_rate=0.1).resolve()
    ref, spec = seeded_resnet50(torch, dev)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    images, labels = to_device(SyntheticImages(
        PARITY_BATCH, spec.input_shape, spec.num_classes, seed=0).batch(),
        dev)
    out = {}
    launches = 0
    for arm, fused, fmt in (
            ("unfused", False, torch.channels_last),
            ("unfused_nchw", False, torch.contiguous_format),
            ("fused", True, torch.channels_last)):
        model = ref if arm == "unfused" else create_model(
            "resnet50", torch.float32, device=dev, fused_conv=fused,
            train=True)[0]
        model.load_state_dict(state)
        model = model.to(memory_format=fmt)
        opt = step_mod.make_optimizer(cfg, model.parameters())
        before = fused_bn_relu_conv.launches
        logits = model(images.contiguous(memory_format=fmt))
        loss = step_mod.loss_fn(logits, labels)
        loss.backward()
        opt.step()
        launches += fused_bn_relu_conv.launches - before
        out[arm] = (logits.detach(), float(loss.detach()),
                    {k: p.grad for k, p in model.named_parameters()},
                    dict(model.named_buffers()))
        del model, opt
    torch.cuda.synchronize()
    lr, sr, gr, br = out["unfused"]
    rec = {"phase": "train_parity", "model": "resnet50", "dtype": "float32",
           "batch": PARITY_BATCH, "image": list(spec.input_shape),
           "kernel_launches": launches, "loss": sr, "nvidia_smi": smi,
           "finite": bool(torch.isfinite(out["fused"][0]).all())}
    for arm in ("fused", "unfused_nchw"):
        lf, sf, gf, bf = out[arm]
        per_tensor = {k: rel_err(gf[k], gr[k]) for k in gr}
        worst = max(per_tensor, key=per_tensor.get)
        rec[arm] = {"loss_rel_err": abs(sf - sr) / abs(sr),
                    "logits_rel_err": rel_err(lf, lr),
                    "grad_norm_err": norm_err(gf, gr),
                    "grad_rel_err_worst_tensor": [worst, per_tensor[worst]],
                    "running_stats_rel_err": max(
                        rel_err(bf[k], br[k]) for k in br)}
    fused, noise = rec["fused"], rec["unfused_nchw"]
    grad_tol = max(TRAIN_GRAD_TOL,
                   TRAIN_GRAD_NOISE_FACTOR * noise["grad_norm_err"])
    rec["tol"] = {"loss": TRAIN_LOSS_TOL, "logits": TRAIN_LOGITS_TOL,
                  "stats": TRAIN_STATS_TOL, "grad_norm": grad_tol,
                  "grad_norm_rule": f"max({TRAIN_GRAD_TOL}, "
                                    f"{TRAIN_GRAD_NOISE_FACTOR} x the "
                                    "unfused_nchw noise floor)"}
    emit(rec)
    if not (rec["finite"] and fused["loss_rel_err"] <= TRAIN_LOSS_TOL
            and fused["logits_rel_err"] <= TRAIN_LOGITS_TOL
            and fused["grad_norm_err"] <= grad_tol
            and fused["running_stats_rel_err"] <= TRAIN_STATS_TOL
            and launches == FUSED_LAUNCHES_PER_STEP):
        raise AssertionError(f"fused resnet50 disagrees with unfused: {rec}")


def phase_train(torch, smi) -> tuple[int, float]:
    """Phase 7: the training lane's main path, both arms; returns the
    kernel's launch count and the images/s of the fused arm."""
    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.ops.fused_conv import fused_bn_relu_conv

    steps = TRAIN_WARMUP + TRAIN_BATCHES
    fused_launches = fused_rate = None
    for arm in ("fused", "unfused"):
        fused = arm == "fused"
        argv = ["1", "1", str(TRAIN_BATCH), "sock", "--model=resnet50",
                "--use_fp16=true", f"--fused_conv={str(fused).lower()}",
                f"--num_warmup_batches={TRAIN_WARMUP}",
                f"--num_batches={TRAIN_BATCHES}", "--display_every=10"]
        lines: list[str] = []

        def tee(m: str) -> None:
            lines.append(m)
            print(m, file=sys.stderr, flush=True)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_bn_relu_conv.launches = 0
        rc = launcher.main(argv, print_fn=tee)
        launches = fused_bn_relu_conv.launches
        res = json.loads(lines[-1])
        expected = FUSED_LAUNCHES_PER_STEP * steps if fused else 0
        rec = {"phase": "train", "arm": arm, "argv": argv, "rc": rc,
               "launches": launches, "expected_launches": expected,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "nvidia_smi": smi,
               **{k: res[k] for k in (
                   "total_images_per_sec", "images_per_sec_per_chip",
                   "mean_step_ms", "p50_step_ms", "mfu", "final_loss",
                   "global_batch", "device_kind")}}
        emit(rec)
        if not (rc == 0 and launches == expected
                and res["total_images_per_sec"] > 0
                and math.isfinite(res["final_loss"])
                and res["global_batch"] == TRAIN_BATCH):
            raise AssertionError(f"train run ({arm}) failed: {rec}")
        if fused:
            fused_launches = launches
            fused_rate = res["total_images_per_sec"]
    return fused_launches, fused_rate


def _attn_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a head attends to: what the kernels must do."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def _flash_case_inputs(torch, F, fa_mod, gen, dev, b, s, h, d, dtype):
    """q, k, v (views of one fused projection) and dO at the kernels' head
    dim, zero-padded as ``flash_attention`` pads, and the scale of the
    original head dim."""
    dp = fa_mod.padded_head_dim(d)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    if dp != d:
        qkv, do = F.pad(qkv, (0, dp - d)), F.pad(do, (0, dp - d))
    q, k, v = qkv.to(dtype).unbind(2)
    return q, k, v, do, d ** -0.5


def phase_flash(torch, dev, timer, smi, cases=FLASH_CASES,
                extras: bool = True) -> dict:
    """Phase 8 (``cases``; with ``extras`` the wide and padded routes
    after them); returns the main-path row of each flash kernel."""
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops import flash_attention as fa_mod

    fa = fa_mod.flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = {}
    for b, s, h, d, dname, causal in cases:
        dtype = getattr(torch, dname)
        q, k, v, do, scale = _flash_case_inputs(torch, F, fa_mod, gen, dev,
                                                b, s, h, d, dtype)
        # the backward passes take the forward kernel's o and lse, as in
        # training; each plain version runs at its kernel's tiles
        o_fwd, lse_fwd = fa_mod.flash_fwd(q, k, v, causal, scale)
        delta = fa_mod.delta_rows(o_fwd, do)
        bwd_args = (q, k, v, do, lse_fwd, delta, causal, scale)
        bq, bk = fa_mod.fwd_blocks(dtype, d)
        blocks = fa_mod.bwd_blocks(dtype, d)
        calls = {
            "fwd": (lambda: fa_mod.flash_fwd(q, k, v, causal, scale),
                    lambda: fa_mod.flash_fwd_plain(q, k, v, causal, scale,
                                                   block_q=bq, block_k=bk)),
            "dq": (lambda: fa_mod.flash_dq(*bwd_args),
                   lambda: fa_mod.flash_dq_plain(
                       *bwd_args, block_q=blocks["dq"][0],
                       block_k=blocks["dq"][1])),
            "dkv": (lambda: fa_mod.flash_dkv(*bwd_args),
                    lambda: fa_mod.flash_dkv_plain(
                        *bwd_args, block_q=blocks["dkv"][0],
                        block_k=blocks["dkv"][1])),
        }
        # the yardstick: SDPA on [b, h, s, d] copies at the original head
        # dim, forward, and its backward alone (all three gradients), the
        # backward timed SDPA_BWD_REPEATS times for its spread
        qt, kt, vt = (t[..., :d].transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        lib_fwd = timer.median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do[..., :d].transpose(1, 2).contiguous()
        lib_bwds = [timer.median_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
            for _ in range(SDPA_BWD_REPEATS)]
        lib_bwd = statistics.median(lib_bwds)
        del out, qt, kt, vt, dot
        # the function's own work at the original head dim
        pairs = b * h * _attn_pairs(s, s, causal)
        elt = q.element_size()
        tile = b * s * h * d * elt                      # one [b,s,h,d]
        rows_f32 = b * h * s * 4                        # lse or delta
        work = {"fwd": (4 * tile + rows_f32, 4.0 * pairs * d),
                "dq": (5 * tile + 2 * rows_f32, 6.0 * pairs * d),
                "dkv": (6 * tile + 2 * rows_f32, 8.0 * pairs * d)}
        peak = BF16_OPS_PER_S if dname == "bfloat16" else F32_OPS_PER_S
        for name, (kernel, plain) in calls.items():
            fa.designs[name] = None
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            design = fa.designs[name]
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want))
            if name == "fwd":       # lse in absolute terms, f32 both sides
                errs[1] = float((got[1] - want[1]).abs().max())
            ms = timer.median_ms(kernel)
            plain_ms = timer.median_ms(plain, PLAIN_ITERS)
            nbytes, ops = work[name]
            bound_ms, bound_by = bound(nbytes, ops, peak)
            rec = {"phase": "flash", "name": FLASH_KERNELS[name][0],
                   "shape": [b, s, h, d], "dtype": dname, "causal": causal,
                   "kernel_head_dim": q.shape[-1], "design": design,
                   "plain_blocks": [bq, bk] if name == "fwd"
                   else list(blocks[name]),
                   "max_abs_err": abs_err, "rel_errs": errs,
                   "tol": FLASH_TOL[dname], "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_fwd if name == "fwd" else lib_bwd,
                   "library_note": ("SDPA forward" if name == "fwd" else
                                    "SDPA backward alone (dq, dk and dv), "
                                    "median of the repeats"),
                   "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
                   "tflops": ops / ms / 1e9,
                   "pct_of_bound": 100.0 * bound_ms / ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "nvidia_smi": smi}
            if name != "fwd":
                rec["library_ms_repeats"] = lib_bwds
            emit(rec)
            want_design = (fa_mod.fwd_design(dtype, d) if name == "fwd"
                           else fa_mod.bwd_design(dtype, d))
            if design != want_design:
                raise AssertionError(f"flash {name} ran {design}: {rec}")
            if not max(errs) <= FLASH_TOL[dname]:
                raise AssertionError(f"flash {name} disagrees: {rec}")
            if (b, s, h, d, dname, causal) == FLASH_CASES[0]:
                rows[FLASH_KERNELS[name][0]] = rec
        del q, k, v, do, o_fwd, lse_fwd, delta, calls, bwd_args
        torch.cuda.empty_cache()
    if extras:
        phase_flash_wide(torch, dev, timer, smi, fa_mod)
        for case in FLASH_PADDED_CASES:
            phase_flash_padded(torch, dev, smi, fa_mod, case)
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    return rows


def phase_flash_padded(torch, dev, smi, fa_mod, case) -> None:
    """Phase 8, the padded route: ``flash_attention`` at a head dim the
    kernels do not take (32, 192) through autograd, one launch of each
    kernel; o and the gradients at the caller's width with the bits of
    the kernels called on inputs zero-padded to ``padded_head_dim`` (so
    the wrapper padded and sliced back), and within FLASH_TOL of the
    plain versions at the unpadded width (each at its kernel's tiles)."""
    import torch.nn.functional as F

    b, s, h, d, dname, causal = case
    dtype = getattr(torch, dname)
    fa = fa_mod.flash_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    before = dict(fa.launches)
    x = qkv.clone().requires_grad_()
    o = fa(*x.unbind(2), causal=causal)
    o.backward(do)
    torch.cuda.synchronize()
    launched = {k: fa.launches[k] - before[k] for k in before}
    grads = x.grad.unbind(2)
    # the kernels on explicitly padded inputs, with the scale of d
    dp = fa_mod.padded_head_dim(d)
    scale = 1.0 / d ** 0.5
    pq, pk, pv = F.pad(qkv, (0, dp - d)).unbind(2)
    pdo = F.pad(do, (0, dp - d))
    po, plse = fa_mod.flash_fwd(pq, pk, pv, causal, scale)
    pargs = (pq, pk, pv, pdo, plse, fa_mod.delta_rows(po, pdo), causal,
             scale)
    padded = (po, fa_mod.flash_dq(*pargs), *fa_mod.flash_dkv(*pargs))
    same_bits = all(torch.equal(g, p[..., :d])
                    for g, p in zip((o.detach(), *grads), padded))
    # the plain versions at the unpadded width
    q, k, v = qkv.unbind(2)
    bq, bk = fa_mod.fwd_blocks(dtype, d)
    blocks = fa_mod.bwd_blocks(dtype, d)
    want_o, lse = fa_mod.flash_fwd_plain(q, k, v, causal, block_q=bq,
                                         block_k=bk)
    args = (q, k, v, do, lse, fa_mod.delta_rows(want_o, do), causal)
    want_dq = fa_mod.flash_dq_plain(*args, block_q=blocks["dq"][0],
                                    block_k=blocks["dq"][1])
    want_dk, want_dv = fa_mod.flash_dkv_plain(*args,
                                              block_q=blocks["dkv"][0],
                                              block_k=blocks["dkv"][1])
    errs = {name: rel_err(g, w) for name, g, w in
            zip(("o", "dq", "dk", "dv"), (o.detach(), *grads),
                (want_o, want_dq, want_dk, want_dv))}
    rec = {"phase": "flash_padded", "shape": [b, s, h, d], "dtype": dname,
           "causal": causal, "kernel_head_dim": dp,
           "launches": launched, "out_shapes": [list(o.shape),
                                                list(x.grad.shape)],
           "same_bits_as_padded_kernels": same_bits, "rel_errs": errs,
           "tol": FLASH_TOL[dname], "designs": dict(fa.designs),
           "nvidia_smi": smi}
    emit(rec)
    ok = (launched == dict.fromkeys(launched, 1) and same_bits
          and tuple(o.shape) == (b, s, h, d) and x.grad.shape == qkv.shape
          and max(errs.values()) <= FLASH_TOL[dname])
    if not ok:
        raise AssertionError(f"flash padded route: {rec}")
    del qkv, do, x, o, grads, padded, pq, pk, pv, pdo, po, plse, pargs
    torch.cuda.empty_cache()


def phase_flash_wide(torch, dev, timer, smi, fa_mod) -> None:
    """Phase 8: b * h above 65535 through the three kernels;
    the first and last batch rows against the plain versions run on those
    rows alone (each plain version at its kernel's tiles)."""
    b, s, h, d, dname, causal = FLASH_WIDE_CASE
    dtype = getattr(torch, dname)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    o, lse = fa_mod.flash_fwd(q, k, v, causal)
    delta = fa_mod.delta_rows(o, do)
    args = (q, k, v, do, lse, delta, causal)
    dq = fa_mod.flash_dq(*args)
    dk, dv = fa_mod.flash_dkv(*args)
    torch.cuda.synchronize()
    sel = list(FLASH_WIDE_ROWS)
    bq, bk = fa_mod.fwd_blocks(dtype, d)
    blocks = fa_mod.bwd_blocks(dtype, d)
    qs, ks, vs, dos = (t[sel] for t in (q, k, v, do))
    want_o, want_lse = fa_mod.flash_fwd_plain(qs, ks, vs, causal,
                                              block_q=bq, block_k=bk)
    rows = (qs, ks, vs, dos, lse[sel].contiguous(),
            delta[sel].contiguous(), causal)
    want_dq = fa_mod.flash_dq_plain(*rows, block_q=blocks["dq"][0],
                                    block_k=blocks["dq"][1])
    want_dk, want_dv = fa_mod.flash_dkv_plain(*rows,
                                              block_q=blocks["dkv"][0],
                                              block_k=blocks["dkv"][1])
    errs = {"o": rel_err(o[sel], want_o),
            "lse": float((lse[sel] - want_lse).abs().max()),
            "dq": rel_err(dq[sel], want_dq), "dk": rel_err(dk[sel], want_dk),
            "dv": rel_err(dv[sel], want_dv)}
    ms = {"fwd": timer.median_ms(lambda: fa_mod.flash_fwd(q, k, v, causal)),
          "dq": timer.median_ms(lambda: fa_mod.flash_dq(*args)),
          "dkv": timer.median_ms(lambda: fa_mod.flash_dkv(*args))}
    rec = {"phase": "flash_wide", "shape": [b, s, h, d], "dtype": dname,
           "causal": causal, "batch_x_heads": b * h,
           "rows_checked": sel, "rel_errs": errs,
           "tol": FLASH_TOL[dname], "ms": ms,
           "designs": dict(fa_mod.flash_attention.designs),
           "nvidia_smi": smi}
    emit(rec)
    if not max(errs.values()) <= FLASH_TOL[dname]:
        raise AssertionError(f"flash at b*h {b * h} disagrees: {rec}")
    del qkv, do, q, k, v, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()


def phase_lm_train_parity(torch, dev, smi) -> None:
    """Phase 9: gpt2 and bert_base, float32, one SGD step per arm of
    ``LM_PARITY`` from one ``state_dict``."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops.flash_attention import flash_attention
    from tpu_hc_bench_torch.ops.xent import softmax_xent
    from tpu_hc_bench_torch.train import step as step_mod

    for name, batch_size, arms in LM_PARITY:
        cfg = flags.BenchmarkConfig(model=name).resolve()
        ref, spec = create_model(name, torch.float32, "dense", device=dev,
                                 seed=0)
        state = {k: v.clone() for k, v in ref.state_dict().items()}
        batch = tokens_to_device(SyntheticTokens(
            batch_size, spec.input_shape[0], vocab_size=spec.vocab_size,
            seed=0, causal_lm=spec.causal_lm).batch(), dev)
        out, launches = [], []
        for i, (impl, fused) in enumerate(arms):
            model = ref if i == 0 else create_model(
                name, torch.float32, impl, device=dev)[0]
            model.load_state_dict(state)
            model.eval()                                # dropout off
            opt = step_mod.make_optimizer(cfg, model.parameters())
            before = {**flash_attention.launches,
                      **{"xent_" + k: n
                         for k, n in softmax_xent.launches.items()}}
            logits = model(batch[0])
            loss = step_mod.lm_loss_fn(logits, *batch[1:], fused)
            loss.backward()
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            opt.step()
            after = {**flash_attention.launches,
                     **{"xent_" + k: n
                        for k, n in softmax_xent.launches.items()}}
            launches.append({k: after[k] - before[k] for k in before})
            out.append((logits.detach(), float(loss.detach()), grads,
                        {k: p.detach() for k, p in model.named_parameters()}))
            del model, opt, logits, loss
        torch.cuda.synchronize()
        rec = {"phase": "lm_train_parity", "model": name,
               "dtype": "float32", "batch": batch_size,
               "seq": spec.input_shape[0], "dropout": "off",
               "loss": out[0][1], "nvidia_smi": smi,
               "tol": {"loss": LM_LOSS_TOL, "logits": LM_LOGITS_TOL,
                       "grad_norm": LM_GRAD_TOL, "params": LM_PARAM_TOL},
               "arms": [], "ok": True}
        for i, j in LM_PARITY_PAIRS:
            (lf, sf, gf, pf), (lr, sr, gr, pr) = out[i], out[j]
            impl, fused = arms[i]
            expected = {k: (LM_LAYERS if impl == "flash" else 0)
                        for k in flash_attention.launches}
            expected.update({"xent_" + k: int(fused)
                             for k in softmax_xent.launches})
            cmp = {"arm": {"attention_impl": impl, "fused_xent": fused},
                   "against": {"attention_impl": arms[j][0],
                               "fused_xent": arms[j][1]},
                   "launches": launches[i],
                   "finite": bool(torch.isfinite(lf).all()),
                   "loss_rel_err": abs(sf - sr) / abs(sr),
                   "logits_rel_err": rel_err(lf, lr),
                   "grad_norm_err": norm_err(gf, gr),
                   "params_rel_err": max(rel_err(pf[k], pr[k])
                                         for k in pr)}
            rec["arms"].append(cmp)
            rec["ok"] &= (cmp["finite"]
                          and cmp["loss_rel_err"] <= LM_LOSS_TOL
                          and cmp["logits_rel_err"] <= LM_LOGITS_TOL
                          and cmp["grad_norm_err"] <= LM_GRAD_TOL
                          and cmp["params_rel_err"] <= LM_PARAM_TOL
                          and launches[i] == expected)
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"{name} arms disagree: {rec}")
        del ref, out, state, batch
        torch.cuda.empty_cache()


def phase_lm_train(torch, smi) -> tuple[dict, float]:
    """Phase 10: the LM lanes' main paths, the runs of ``LM_RUNS``;
    returns each flash and xent kernel's launch count from the first,
    and its sequences/s."""
    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.models import get_model_spec
    from tpu_hc_bench_torch.ops.flash_attention import flash_attention
    from tpu_hc_bench_torch.ops.xent import softmax_xent

    steps = LM_WARMUP + LM_BATCHES
    main_launches = None
    for name, batch_size, impl, fused in LM_RUNS:
        argv = ["1", "1", str(batch_size), "sock", f"--model={name}",
                "--use_fp16=true", f"--attention_impl={impl}",
                f"--fused_xent={str(fused).lower()}",
                f"--num_warmup_batches={LM_WARMUP}",
                f"--num_batches={LM_BATCHES}", "--display_every=10"]
        lines: list[str] = []

        def tee(m: str) -> None:
            lines.append(m)
            print(m, file=sys.stderr, flush=True)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for counts in (flash_attention.launches, softmax_xent.launches):
            counts.update(dict.fromkeys(counts, 0))
        rc = launcher.main(argv, print_fn=tee)
        launches = {**{FLASH_KERNELS[k][0]: n
                       for k, n in flash_attention.launches.items()},
                    **{XENT_KERNELS[k][0]: n
                       for k, n in softmax_xent.launches.items()}}
        res = json.loads(lines[-1])
        expected = {**{FLASH_KERNELS[k][0]: LM_LAYERS * steps
                       if impl == "flash" else 0 for k in FLASH_KERNELS},
                    **{XENT_KERNELS[k][0]: steps if fused else 0
                       for k in XENT_KERNELS}}
        seq = get_model_spec(name).input_shape[0]
        rec = {"phase": "lm_train", "model": name, "attention_impl": impl,
               "fused_xent": fused, "argv": argv, "rc": rc,
               "launches": launches, "expected_launches": expected,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "nvidia_smi": smi,
               **{k: res[k] for k in (
                   "total_images_per_sec", "images_per_sec_per_chip",
                   "mean_step_ms", "p50_step_ms", "mfu", "final_loss",
                   "global_batch", "device_kind")}}
        rec["tokens_per_sec"] = res["total_images_per_sec"] * seq
        emit(rec)
        if not (rc == 0 and launches == expected
                and res["total_images_per_sec"] > 0
                and math.isfinite(res["final_loss"])
                and res["global_batch"] == batch_size
                and res["fused_xent"] == fused
                and res["attention_impl"] == impl):
            raise AssertionError(f"{name} train run ({impl}, fused_xent="
                                 f"{fused}) failed: {rec}")
        if main_launches is None:
            main_launches = launches
            main_rate = res["total_images_per_sec"]
    return main_launches, main_rate


def phase_xent(torch, dev, timer, smi) -> dict:
    """Phase 11; returns the main-path row of each xent kernel."""
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops import xent

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = {}
    for n, v, dname in XENT_CASES:
        dtype = getattr(torch, dname)
        logits = (2.0 * torch.randn((n, v), generator=gen, device=dev)).to(
            dtype)
        labels = torch.randint(0, v, (n,), generator=gen, device=dev)
        g = torch.rand((n,), generator=gen, device=dev) / n
        g[::7] = 0.0                                    # unweighted rows
        want_loss, want_lse = xent.xent_fwd_plain(logits, labels)
        calls = {
            "fwd": (lambda: xent.xent_fwd(logits, labels),
                    lambda: xent.xent_fwd_plain(logits, labels)),
            "bwd": (lambda: xent.xent_bwd(logits, labels, want_lse, g),
                    lambda: xent.xent_bwd_plain(logits, labels, want_lse,
                                                g)),
        }
        # the yardstick: F.cross_entropy(reduction="none"), forward, and
        # its backward alone
        xl = logits.detach().requires_grad_()
        lib_fwd = timer.median_ms(
            lambda: F.cross_entropy(xl, labels, reduction="none"))
        out = F.cross_entropy(xl, labels, reduction="none")
        lib_bwd = timer.median_ms(lambda: torch.autograd.grad(
            out, xl, g, retain_graph=True))
        del out, xl
        elt = logits.element_size()
        work = {"fwd": (n * v * elt + n * 8 + 2 * n * 4, 4.0 * n * v),
                "bwd": (2 * n * v * elt + n * 8 + 2 * n * 4, 4.0 * n * v)}
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
            tol = XENT_TOL["float32"] if name == "fwd" else XENT_TOL[dname]
            zero_rows_ok = (name == "fwd" or bool((got[0][::7] == 0).all()))
            ms = timer.median_ms(kernel)
            plain_ms = timer.median_ms(plain, PLAIN_ITERS)
            nbytes, ops = work[name]
            bound_ms, bound_by = bound(nbytes, ops)
            rec = {"phase": "xent", "name": XENT_KERNELS[name][0],
                   "shape": [n, v], "dtype": dname, "max_abs_err": abs_err,
                   "rel_errs": errs, "tol": tol,
                   "zero_weight_rows_exact": zero_rows_ok, "ms": ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_fwd if name == "fwd" else lib_bwd,
                   "library_note": ("F.cross_entropy(reduction='none') "
                                    + ("forward" if name == "fwd" else
                                       "backward alone")),
                   "gbytes": nbytes / 1e9, "bound_ms": bound_ms,
                   "bound_by": bound_by, "nvidia_smi": smi}
            emit(rec)
            if not (max(errs) <= tol and zero_rows_ok):
                raise AssertionError(f"softmax_xent {name} disagrees: {rec}")
            if (n, v, dname) == XENT_CASES[0]:
                rows[XENT_KERNELS[name][0]] = rec
        del logits, labels, g, want_loss, want_lse, calls
        torch.cuda.empty_cache()
    xent.softmax_xent.launches.update(
        dict.fromkeys(xent.softmax_xent.launches, 0))
    return rows


def pool_design(c: int, dname: str, win, st) -> str:
    """The pool kernel's case: 16-byte vectors over the channels (scalar
    accesses where C is not a multiple of the vector) and the template
    case of the window (3x3/2, 3x3/1) or the generic one."""
    vec = 8 if dname == "bfloat16" else 4
    case = (f"{win[0]}x{win[1]}/{st[0]}" if tuple(win) == (3, 3)
            and st[0] == st[1] and st[0] in (1, 2) else "generic")
    return f"{'vector' if c % vec == 0 else 'scalar'} {case}"


def phase_pool(torch, dev, timer, smi) -> tuple[dict, int]:
    """Phase 12: ``max_pool``'s backward kernel, which no model runs: the
    op's own path at its main case (forward and backward through the
    entry point, its launches counted), then the kernel against its plain
    version at every case.  Returns the main row and the path's
    launches."""
    import torch.nn.functional as F

    from tpu_hc_bench_torch.ops import pool_bwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cl = torch.channels_last
    row = path_launches = None
    for shape, win, st, pad, dname, tied in POOL_CASES:
        dtype = getattr(torch, dname)
        if tied:
            x = torch.randint(-4, 4, shape, generator=gen, device=dev)
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        x = x.to(dtype).contiguous(memory_format=cl)
        y = pool_bwd._pool_fwd(x, win, st, pad)
        dy = torch.randn(y.shape, generator=gen, device=dev).to(
            dtype).contiguous(memory_format=cl)
        if row is None:
            # the op's path, as a user calls it
            pool_bwd.max_pool.launches = 0
            for _ in range(POOL_PATH_STEPS):
                xr = x.detach().requires_grad_()
                pool_bwd.max_pool(xr, win, st, pad).backward(dy)
            torch.cuda.synchronize()
            path_launches = pool_bwd.max_pool.launches
            if path_launches != POOL_PATH_STEPS:
                raise AssertionError(f"max_pool path launched the kernel "
                                     f"{path_launches} times, not "
                                     f"{POOL_PATH_STEPS}")

        def kernel():
            return pool_bwd.max_pool_bwd_kernel(x, y, dy, win, st, pad)

        def plain():
            return pool_bwd.max_pool_bwd_plain(x, y, dy, win, st, pad)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        ms = timer.median_ms(kernel)
        plain_ms = timer.median_ms(plain, PLAIN_ITERS)
        # the yardstick: F.max_pool2d's backward alone (first-max
        # routing, so timing only), on the padded input
        _, _, (top, bottom, left, right) = pool_bwd.pool_dims(
            shape[2:], win, st, pad)
        xp = F.pad(x, (left, right, top, bottom),
                   value=float("-inf")).requires_grad_()
        out = F.max_pool2d(xp, win, st)
        library_ms = timer.median_ms(lambda: torch.autograd.grad(
            out, xp, dy, retain_graph=True))
        del xp, out
        elt = x.element_size()
        nbytes = 2 * x.numel() * elt + 2 * y.numel() * elt
        bound_ms, bound_by = bound(nbytes,
                                   2.0 * y.numel() * win[0] * win[1])
        rec = {"phase": "pool", "name": "max_pool_bwd", "shape": list(shape),
               "window": list(win), "strides": list(st), "padding": pad,
               "dtype": dname, "tied_input": tied, "max_abs_err": abs_err,
               "rel_err": err, "tol": POOL_TOL[dname], "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_note": "F.max_pool2d backward alone (first max)",
               "design": pool_design(shape[1], dname, win, st),
               "mbytes": nbytes / 1e6, "gbytes_per_s": nbytes / ms / 1e6,
               "pct_of_bound": 100.0 * bound_ms / ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "nvidia_smi": smi}
        if tied:
            # the share of windows whose max appears more than once
            taps = F.unfold(F.pad(x.float(), (left, right, top, bottom),
                                  value=float("-inf")), win, stride=st)
            taps = taps.view(shape[0], shape[1], win[0] * win[1], -1)
            hits = (taps == y.float().flatten(2)[:, :, None, :]).sum(2)
            rec["tied_window_share"] = float((hits > 1).float().mean())
            del taps, hits
        emit(rec)
        if not err <= POOL_TOL[dname]:
            raise AssertionError(f"max_pool backward disagrees: {rec}")
        if row is None:
            row = rec
        del x, y, dy, got, want
        torch.cuda.empty_cache()
    return row, path_launches


def _counters():
    """Every kernel wrapper's launch counter (the module-level objects
    that hold them)."""
    from tpu_hc_bench_torch.ops import pool_bwd
    from tpu_hc_bench_torch.ops.flash_attention import flash_attention
    from tpu_hc_bench_torch.ops.fused_conv import fused_bn_relu_conv
    from tpu_hc_bench_torch.ops.fused_residual_ln import fused_residual_norm
    from tpu_hc_bench_torch.ops.paged_attention import paged_decode_attention
    from tpu_hc_bench_torch.ops.xent import softmax_xent

    return {"paged_decode_attention": paged_decode_attention,
            "fused_residual_norm": fused_residual_norm,
            "fused_bn_relu_conv": fused_bn_relu_conv,
            "max_pool_bwd": pool_bwd.max_pool}, \
        flash_attention, softmax_xent


def _zero_counts() -> None:
    """Every kernel's launch count to 0, the nine rows of the table."""
    single, flash, xent = _counters()
    for fn in single.values():
        fn.launches = 0
    for counts in (flash.launches, xent.launches):
        counts.update(dict.fromkeys(counts, 0))


def _read_counts() -> dict:
    """Every kernel's launch count, by the table's row names."""
    single, flash, xent = _counters()
    return {**{name: fn.launches for name, fn in single.items()},
            **{FLASH_KERNELS[k][0]: n for k, n in flash.launches.items()},
            **{XENT_KERNELS[k][0]: n for k, n in xent.launches.items()}}


def _launch(argv: list[str]) -> tuple[int, dict]:
    """``launcher.main(argv)``; its exit code and result line."""
    from tpu_hc_bench_torch import launcher

    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    rc = launcher.main(argv, print_fn=tee)
    return rc, json.loads(lines[-1])


DP_RESULT_KEYS = ("total_workers", "global_batch", "total_images_per_sec",
                  "images_per_sec_per_chip", "mean_step_ms", "p50_step_ms",
                  "mfu", "final_loss", "grad_buckets", "allreduce_per_step",
                  "variable_update", "overlap_grad_comm", "device_kind")


def phase_dp_parity(torch, dev, smi) -> None:
    """Phase 13 (b): the fast arm at world 1 against the one-worker step,
    float32, and the accumulation arm."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops.fused_conv import fused_bn_relu_conv
    from tpu_hc_bench_torch.parallel import distributed
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    ref, spec = seeded_resnet50(torch, dev)
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    del ref
    batch = to_device(SyntheticImages(
        PARITY_BATCH, spec.input_shape, spec.num_classes, seed=0).batch(),
        dev)

    def run(fabric, overlap="on", accum=1):
        model = create_model("resnet50", torch.float32, device=dev,
                             fused_conv=True, train=True)[0]
        model.load_state_dict(init)
        cfg = flags.BenchmarkConfig(
            init_learning_rate=0.1, batch_size=PARITY_BATCH,
            overlap_grad_comm=overlap,
            gradient_accumulation_steps=accum).resolve()
        if fabric is not None:
            distributed.init_single("nccl")
        try:
            state = step_mod.make_train_state(model, cfg, fabric)
            before = fused_bn_relu_conv.launches
            losses = []
            for _ in range(DP_PARITY_STEPS):
                state, metrics = step_mod.train_step(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            return ({k: v.detach().clone()
                     for k, v in model.state_dict().items()},
                    [float(x) for x in losses],
                    (fused_bn_relu_conv.launches - before) / DP_PARITY_STEPS,
                    state.dp.allreduce_calls if state.dp else 0)
        finally:
            if fabric is not None:
                dist.destroy_process_group()

    det = torch.backends.cudnn.deterministic
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        one = run(None)
        again = run(None)
        arms = {"overlap_on": run(Fabric.ICI, "on"),
                "overlap_off": run(Fabric.ICI, "off")}
        accum = run(Fabric.ICI, "on", DP_ACCUM)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench

    def equal(a, b) -> bool:
        return all(torch.equal(a[k], b[k]) for k in b)

    deterministic = equal(again[0], one[0]) and again[1] == one[1]
    floor = norm_err(again[0], one[0])
    rec = {"phase": "dp", "part": "b_world1_parity", "model": "resnet50",
           "dtype": "float32", "batch": PARITY_BATCH,
           "steps": DP_PARITY_STEPS, "losses": one[1],
           "one_worker_bit_equal_to_itself": deterministic,
           "run_to_run_floor": floor,
           "rule": ("bit-equal" if deterministic else
                    f"within {DP_NOISE_FACTOR} x the run-to-run floor"),
           "nvidia_smi": smi, "arms": {}, "ok": True}
    for name, (state, losses, conv, calls) in arms.items():
        err = norm_err(state, one[0])
        ok = (equal(state, one[0]) and losses == one[1] if deterministic
              else err <= DP_NOISE_FACTOR * floor)
        rec["arms"][name] = {"bit_equal": equal(state, one[0]),
                             "losses": losses, "norm_err": err,
                             "conv_launches_per_step": conv,
                             "allreduce_per_step": calls, "ok": ok}
        rec["ok"] &= ok and conv == FUSED_LAUNCHES_PER_STEP
    state, losses, conv, calls = accum
    rec["accumulation"] = {
        "steps": DP_ACCUM, "losses": losses,
        "finite": all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(t).all()) for t in state.values()),
        "conv_launches_per_step": conv,
        "expected_per_step": DP_ACCUM * FUSED_LAUNCHES_PER_STEP,
        "allreduce_per_step": calls}
    rec["ok"] &= (rec["accumulation"]["finite"]
                  and conv == DP_ACCUM * FUSED_LAUNCHES_PER_STEP)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the fast arm disagrees at world 1: {rec}")


def phase_dp(torch, dev, smi, sock_rate: float, sock_run: str) -> dict:
    """Phase 13: data parallel; returns the kernels' launches in its
    main-path runs (a) and (c).  ``sock_rate`` is the images/s of the
    one-worker ``sock`` run named by ``sock_run``."""
    # (a) resnet50, the fast arm in a one-rank NCCL group
    steps = DP_WARMUP + DP_BATCHES
    argv = ["1", "1", str(TRAIN_BATCH), "ib", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true",
            f"--num_warmup_batches={DP_WARMUP}",
            f"--num_batches={DP_BATCHES}", "--display_every=10"]
    torch.cuda.empty_cache()
    _zero_counts()
    rc, res = _launch(argv)
    counts_a = _read_counts()
    conv = counts_a["fused_bn_relu_conv"]
    rate_a = res["total_images_per_sec"]
    rec = {"phase": "dp", "part": "a_resnet50_world1_nccl", "argv": argv,
           "rc": rc, "steps": steps, "launches": counts_a,
           "conv_launches": conv,
           "conv_launches_per_step": conv / steps,
           "expected_per_step": FUSED_LAUNCHES_PER_STEP,
           "sock_images_per_sec": sock_rate, "sock_run": sock_run,
           "images_per_sec_vs_sock": rate_a / sock_rate,
           "nvidia_smi": smi, **{k: res[k] for k in DP_RESULT_KEYS}}
    emit(rec)
    if not (rc == 0 and conv == FUSED_LAUNCHES_PER_STEP * steps
            and res["total_workers"] == 1 and res["grad_buckets"] >= 1
            and res["allreduce_per_step"] >= res["grad_buckets"] + 2
            and rate_a > 0 and math.isfinite(res["final_loss"])):
        raise AssertionError(f"dp resnet50 run failed: {rec}")
    torch.cuda.empty_cache()

    # (b) bit-equality with the one-worker step, and accumulation
    phase_dp_parity(torch, dev, smi)
    torch.cuda.empty_cache()

    # (c) gpt2 with the flash and xent kernels
    steps = DP_LM_WARMUP + DP_LM_BATCHES
    argv = ["1", "1", str(DP_LM_BATCH), "ib", "--model=gpt2",
            "--use_fp16=true", "--attention_impl=flash", "--fused_xent=true",
            f"--num_warmup_batches={DP_LM_WARMUP}",
            f"--num_batches={DP_LM_BATCHES}", "--display_every=5"]
    _zero_counts()
    rc, res = _launch(argv)
    counts_c = _read_counts()
    expected = {**{FLASH_KERNELS[k][0]: LM_LAYERS * steps
                   for k in FLASH_KERNELS},
                **{XENT_KERNELS[k][0]: steps for k in XENT_KERNELS}}
    launches = {k: counts_c[k] for k in expected}
    rec = {"phase": "dp", "part": "c_gpt2_world1_nccl", "argv": argv,
           "rc": rc, "steps": steps, "launches": counts_c,
           "expected_launches": expected, "nvidia_smi": smi,
           **{k: res[k] for k in DP_RESULT_KEYS}}
    emit(rec)
    if not (rc == 0 and launches == expected
            and math.isfinite(res["final_loss"])):
        raise AssertionError(f"dp gpt2 run failed: {rec}")
    # what the main path's runs (a) and (c) launched, every kernel read
    dp_launches = {k: counts_a[k] + counts_c[k] for k in counts_a}
    torch.cuda.empty_cache()

    # (d) across every card of this machine
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "dp", "part": "d_multi_card", "ran": False,
              "cards": cards,
              "reason": f"needs 2 or more cards; this machine has {cards}"})
        return dp_launches
    phase_dp_multi(torch, smi, cards, rate_a)
    return dp_launches


def phase_dp_multi(torch, smi, cards: int, rate_one: float) -> None:
    """Phase 13 (d): the OSU all-reduce sweep, then resnet50 over every
    card, one process a card, at the default threshold with the sweep as
    ``--fabric_ceiling`` and a profiled window (phase 21 (g): the
    ceiling-utilization and collective-overlap lines), then
    ``--overlap_grad_comm`` on, off, off, on at ``DP_SMALL_THRESHOLD``
    (several buckets)."""
    import tempfile

    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.microbench import osu

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/sweep.json"
        rc = osu.main(["--op", "allreduce", "--nproc", str(cards),
                       "--max_bytes", str(DP_OSU_MAX_BYTES),
                       "--json", path],
                      print_fn=lambda m: print(m, file=sys.stderr))
        with open(path) as f:
            rows = json.load(f)["sweeps"]["allreduce"]
        emit({"phase": "dp", "part": "d_osu_allreduce", "cards": cards,
              "rc": rc, "rows": rows, "nvidia_smi": smi})
        if rc != 0:
            raise AssertionError(f"the OSU sweep across {cards} cards "
                                 "failed")
        base = ["1", "0", str(TRAIN_BATCH), "ib", "--model=resnet50",
                "--use_fp16=true", "--fused_conv=true",
                f"--num_warmup_batches={DP_WARMUP}",
                f"--num_batches={DP_BATCHES}", "--display_every=10"]
        obs = [f"--fabric_ceiling={path}", f"--trace_dir={tmp}/trace",
               "--profile_steps=11:13", f"--metrics_dir={tmp}/metrics"]
        arms = [obs] + [[f"--overlap_grad_comm={o}",
                         f"--fusion_threshold_bytes={DP_SMALL_THRESHOLD}"]
                        for o in ("on", "off", "off", "on")]
        for extra in arms:
            argv = base + extra
            lines: list[str] = []

            def tee(m: str) -> None:
                lines.append(m)
                print(m, file=sys.stderr, flush=True)

            rc = launcher.main(argv, print_fn=tee)
            res = json.loads(next(ln for ln in reversed(lines)
                                  if ln.startswith("{")))
            rec = {"phase": "dp", "part": "d_multi_card", "ran": True,
                   "cards": cards, "argv": argv, "rc": rc,
                   "scaling_efficiency":
                       res["images_per_sec_per_chip"] / rate_one,
                   "nvidia_smi": smi, **{k: res[k] for k in DP_RESULT_KEYS}}
            if extra is obs:
                rec["ceiling_lines"] = [
                    ln for ln in lines if ln.startswith(
                        ("fabric ceiling", "fabric:", "collective "
                                                      "exposure"))]
                rec["trace_lines"] = [ln for ln in lines if ln.strip()
                                      .split(" ")[0] in (
                    "compute", "collective", "host-transfer",
                    "idle-bubble", "total")]
            emit(rec)
            if not (rc == 0 and res["total_workers"] == cards
                    and math.isfinite(res["final_loss"])
                    and (extra is not obs or rec["ceiling_lines"])):
                raise AssertionError(f"dp run across {cards} cards "
                                     f"failed: {rec}")


def _fixture():
    from pathlib import Path

    from tpu_hc_bench_torch.data import imagenet

    return Path(imagenet.__file__).resolve().parent / "testdata" / \
        "imagenet_tiny"


def realdata_decode(smi) -> str:
    """Phase 14 (a): the port's pipeline on the fixture against the JAX
    pipeline's crops (``expected_crops.npz``), with the decoder
    ``native.jpeg_decoder()`` picks, then with nvJPEG forced by name;
    returns the decoder picked."""
    import numpy as np

    from tpu_hc_bench_torch.data.imagenet import ImageNetDataset

    fx = _fixture()
    want = np.load(fx / "expected_crops.npz")
    picked = None
    for forced in (None, "nvjpeg"):
        got = {}
        for name, split, n in (("train", "train", 2),
                               ("eval", "validation", 1)):
            ds = ImageNetDataset(fx, FIXTURE_BATCH, image_size=FIXTURE_SIZE,
                                 split=split, train=name == "train", seed=0,
                                 wire_dtype="uint8", decoder=forced)
            it = iter(ds)
            batches = [next(it) for _ in range(n)]
            it.close()
            got[name] = (np.stack([b[0] for b in batches]),
                         np.stack([b[1] for b in batches]))
        diff = np.concatenate([
            np.abs(got["train"][0].astype(np.int16)
                   - want["train_images"].astype(np.int16)).ravel(),
            np.abs(got["eval"][0][0].astype(np.int16)
                   - want["eval_images"].astype(np.int16)).ravel()])
        labels_equal = bool(
            (got["train"][1] == want["train_labels"]).all()
            and (got["eval"][1][0] == want["eval_labels"]).all())
        stats = ds.stats()
        decoder = stats["decoder"]
        picked = picked or decoder
        mean_tol = DECODER_MEAN_TOL[decoder]
        rec = {"phase": "realdata", "part": "a_decode_parity",
               "decoder": decoder,
               "how": "forced by name" if forced else "jpeg_decoder()'s pick",
               "reader": stats["reader"],
               "pil_fallbacks": stats["pil_fallbacks"],
               "max_abs_diff": int(diff.max()),
               "mean_abs_diff": float(diff.mean()),
               "tol": ("bit-equal" if mean_tol == 0
                       else f"mean_abs_diff <= {mean_tol}"),
               "labels_equal": labels_equal, "nvidia_smi": smi}
        emit(rec)
        ok = diff.max() == 0 if mean_tol == 0 else diff.mean() <= mean_tol
        if not (ok and labels_equal and stats["reader"] == "native"
                and stats["pil_fallbacks"] == 0
                and decoder == (forced or decoder)):
            raise AssertionError(f"real-data decode parity failed: {rec}")
    return picked


def _real_argv(part: str, batch: int, *extra: str) -> list[str]:
    warmup, timed = REAL_BATCHES[part]
    return ["1", "1", str(batch), "ib", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true", f"--data_dir={_fixture()}",
            *REFERENCE_LINE, f"--num_warmup_batches={warmup}",
            f"--num_batches={timed}", "--display_every=10", *extra]


REAL_KEYS = ("total_images_per_sec", "mean_step_ms", "p50_step_ms", "mfu",
             "final_loss", "global_batch", "forward_only", "eval_top_1",
             "data", "variable_update", "resume", "checkpoint")


def _real_run(part: str, argv: list[str], steps: int, smi,
              phase: str = "realdata", **ctx):
    """One main-path run: every count set to 0 just before, read just
    after; 8 fused-conv launches a step."""
    _zero_counts()
    rc, res = _launch(argv)
    counts = _read_counts()
    conv = counts["fused_bn_relu_conv"]
    rec = {"phase": phase, "part": part, "argv": argv, "rc": rc,
           "steps": steps, "launches": counts,
           "conv_launches_per_step": conv / steps,
           "expected_per_step": FUSED_LAUNCHES_PER_STEP, "nvidia_smi": smi,
           **ctx, **{k: res[k] for k in REAL_KEYS}}
    emit(rec)
    data = res["data"] or {"reader": "native"}      # None: synthetic
    if not (rc == 0 and conv == FUSED_LAUNCHES_PER_STEP * steps
            and res["total_images_per_sec"] > 0
            and math.isfinite(res["final_loss"])
            and data["reader"] == "native"
            and data.get("pil_fallbacks", 0) == 0):
        raise AssertionError(f"real-data run {part} failed: {rec}")
    return res, counts


def _forward_only_run(torch, smi, argv: list[str], steps: int):
    """(d): the run through the launcher, its model's parameters and BN
    buffers snapshotted at creation and compared bit for bit after."""
    from tpu_hc_bench_torch.train import driver

    made = []
    create = driver.create_model

    def create_and_keep(*a, **kw):
        model, spec = create(*a, **kw)
        made.append((model, {k: v.clone()
                             for k, v in model.state_dict().items()}))
        return model, spec

    driver.create_model = create_and_keep
    try:
        res, counts = _real_run("d_forward_only", argv, steps, smi)
    finally:
        driver.create_model = create
    model, before = made[0]
    changed = [k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])]
    emit({"phase": "realdata", "part": "d_forward_only_state",
          "tensors": len(before), "changed": changed})
    if changed or not res["forward_only"]:
        raise AssertionError(f"forward-only changed the state: {changed}")
    return res, counts


def _plain_update(torch, name: str, p, g, st: dict, t: int, lr: float):
    """optax's update of ``p`` by ``g``, written out (float32 tensors;
    the bias corrections in float64)."""
    if name == "rmsprop":
        nu = st.setdefault("nu", torch.zeros_like(p))
        nu.copy_(0.1 * (g * g) + 0.9 * nu)
        return p - lr * (g * torch.rsqrt(nu + 1.0))
    m = st.setdefault("m", torch.zeros_like(p))
    v = st.setdefault("v", torch.zeros_like(p))
    m.copy_(0.1 * g + 0.9 * m)
    v.copy_(0.001 * (g * g) + 0.999 * v)
    u = (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
    if name == "adamw":
        u = u + 1e-4 * p
    return p - lr * u


def realdata_optimizers(torch, dev, smi) -> None:
    """(f): three steps of each optax optimizer on real batches, resnet50
    bf16 at batch 32; each step's update against the plain one on the
    same gradients."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.feed import DeviceFeeder
    from tpu_hc_bench_torch.data.imagenet import ImageNetDataset
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    lr = 0.01
    for name in ("adam", "adamw", "rmsprop"):
        cfg = flags.BenchmarkConfig(optimizer=name, init_learning_rate=lr,
                                    use_fp16=True).resolve()
        model, spec = create_model("resnet50", torch.bfloat16, device=dev,
                                   seed=0, train=True)
        state = step_mod.make_train_state(model, cfg)
        ds = ImageNetDataset(_fixture(), OPT_BATCH,
                             image_size=spec.input_shape[0], seed=0,
                             wire_dtype="uint8")
        feeder = DeviceFeeder(iter(ds), dev)
        batches = iter(feeder)
        params = [p for p in model.parameters()]
        ref_state = [{} for _ in params]
        losses, errs = [], []
        for t in range(1, OPT_STEPS + 1):
            state.optimizer.zero_grad(set_to_none=True)
            loss = step_mod.batch_loss(model, next(batches))
            loss.backward()
            with torch.no_grad():
                want = [_plain_update(torch, name, p.detach().clone(),
                                      p.grad, s, t, lr)
                        for p, s in zip(params, ref_state)]
            state.optimizer.step()
            err = max(float((p.detach() - w).abs().max())
                      / max(float(w.abs().max()), 1.0)
                      for p, w in zip(params, want))
            losses.append(float(loss))
            errs.append(err)
        batches.close()
        feeder.close()
        rec = {"phase": "realdata", "part": "f_optimizer", "optimizer": name,
               "batch": OPT_BATCH, "steps": OPT_STEPS, "losses": losses,
               "max_rel_err_per_step": errs, "tol": OPT_TOL[name],
               "nvidia_smi": smi}
        emit(rec)
        if not (all(math.isfinite(x) for x in losses)
                and max(errs) <= OPT_TOL[name]):
            raise AssertionError(f"optimizer {name} failed: {rec}")
        del model, state
        torch.cuda.empty_cache()


def realdata_text(torch, smi, lm_rate: float) -> tuple[dict, dict]:
    """(g): gpt2 on a uint16 token corpus written here with numpy; 12
    launches of each flash kernel and one of each xent kernel a step."""
    from pathlib import Path

    import numpy as np

    from tpu_hc_bench_torch.data.tokens import write_token_file
    from tpu_hc_bench_torch.models import get_model_spec

    spec = get_model_spec("gpt2")
    corpus = Path(__file__).resolve().parent / "build" / "realdata_tokens"
    write_token_file(corpus / "train.bin", np.random.default_rng(0).integers(
        0, spec.vocab_size, TOKEN_CORPUS), spec.vocab_size)
    warmup, timed = REAL_BATCHES["g"]
    steps = warmup + timed
    argv = ["1", "1", "16", "sock", "--model=gpt2", "--use_fp16=true",
            "--attention_impl=flash", "--fused_xent=true",
            f"--data_dir={corpus}", f"--num_warmup_batches={warmup}",
            f"--num_batches={timed}", "--display_every=10"]
    _zero_counts()
    rc, res = _launch(argv)
    counts = _read_counts()
    expected = {**{FLASH_KERNELS[k][0]: LM_LAYERS * steps
                   for k in FLASH_KERNELS},
                **{XENT_KERNELS[k][0]: steps for k in XENT_KERNELS}}
    rate = res["total_images_per_sec"]
    rec = {"phase": "realdata", "part": "g_gpt2_corpus", "argv": argv,
           "rc": rc, "steps": steps, "launches": counts,
           "expected_launches": expected, "sequences_per_sec": rate,
           "synthetic_sequences_per_sec": lm_rate,
           "vs_synthetic": rate / lm_rate, "nvidia_smi": smi,
           **{k: res[k] for k in ("mean_step_ms", "p50_step_ms",
                                   "final_loss", "data")}}
    emit(rec)
    if not (rc == 0 and {k: counts[k] for k in expected} == expected
            and math.isfinite(res["final_loss"])
            and res["data"]["reader"] == "memmap"):
        raise AssertionError(f"real-data gpt2 run failed: {rec}")
    return res, counts


def phase_realdata(torch, dev, smi, sock_rate: float,
                   lm_rate: float) -> dict:
    """Phase 14; returns every kernel's launches summed over the main-path
    runs (b)-(e) and (g).  ``sock_rate``: phase 7's synthetic images/s,
    ``lm_rate``: phase 10's gpt2 sequences/s."""
    emit({"phase": "realdata", "part": "a_decoder_picked",
          "decoder": realdata_decode(smi)})
    torch.cuda.empty_cache()
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # (b) the reference's command on real data
    b = REAL_BATCHES["b"]
    res, counts = _real_run(
        "b_reference_line", _real_argv("b", TRAIN_BATCH), sum(b), smi,
        synthetic_images_per_sec=sock_rate)
    rate_b = res["total_images_per_sec"]
    emit({"phase": "realdata", "part": "b_vs_synthetic",
          "images_per_sec": rate_b, "synthetic_images_per_sec": sock_rate,
          "ratio": rate_b / sock_rate,
          "input_wait_ms_per_step": res["data"]["input_wait_ms_per_step"],
          "decode_wall_s": res["data"]["decode_wall_s"],
          "decode_workers": res["data"]["decode_workers"],
          "decoder": res["data"]["decoder"]})
    add(counts)
    torch.cuda.empty_cache()
    # (c) the host taken out
    res, counts = _real_run(
        "c_repeat_cached_sample", _real_argv(
            "c", TRAIN_BATCH, "--datasets_repeat_cached_sample=true"),
        sum(REAL_BATCHES["c"]), smi, synthetic_images_per_sec=sock_rate)
    emit({"phase": "realdata", "part": "c_vs_synthetic",
          "ratio": res["total_images_per_sec"] / sock_rate})
    add(counts)
    torch.cuda.empty_cache()
    # (d) forward-only
    res, counts = _forward_only_run(torch, smi, _real_argv(
        "d", TRAIN_BATCH, "--forward_only=true"), sum(REAL_BATCHES["d"]))
    emit({"phase": "realdata", "part": "d_vs_b",
          "ratio": res["total_images_per_sec"] / rate_b})
    add(counts)
    torch.cuda.empty_cache()
    # (e) eval on the validation shard (the random init's top-1)
    res, counts = _real_run("e_eval", _real_argv("e", TRAIN_BATCH,
                                                 "--eval=true"),
                            sum(REAL_BATCHES["e"]), smi)
    if res["data"]["split"] != "validation" or res["eval_top_1"] is None:
        raise AssertionError(f"eval did not read the validation split: "
                             f"{res['data']}")
    add(counts)
    torch.cuda.empty_cache()
    # (f) the optax optimizers (not a main path: not counted)
    realdata_optimizers(torch, dev, smi)
    # (g) the text arm on a token corpus
    _, counts = realdata_text(torch, smi, lm_rate)
    add(counts)
    torch.cuda.empty_cache()
    return total


def slice7_replicated(torch, dev, smi) -> None:
    """Phase 15 (a): ``--variable_update=replicated`` (sync-BN) against
    ``psum`` in a one-rank NCCL group, phase 6's seeded resnet50 in
    float32 at batch 16, two steps each, cuDNN deterministic: bit-equal
    where psum is bit-equal to itself (sync over one rank is the
    identity), and the all-reduce calls a step of each arm."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import distributed
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    ref, spec = seeded_resnet50(torch, dev)
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    del ref
    batch = to_device(SyntheticImages(
        PARITY_BATCH, spec.input_shape, spec.num_classes, seed=0).batch(),
        dev)

    def run(update: str):
        model = create_model("resnet50", torch.float32, device=dev,
                             fused_conv=True, train=True)[0]
        model.load_state_dict(init)
        cfg = flags.BenchmarkConfig(init_learning_rate=0.1,
                                    batch_size=PARITY_BATCH,
                                    variable_update=update).resolve()
        distributed.init_single("nccl")
        try:
            state = step_mod.make_train_state(model, cfg, Fabric.ICI)
            losses = []
            for _ in range(DP_PARITY_STEPS):
                state, metrics = step_mod.train_step(state, batch)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            return ({k: v.detach().clone()
                     for k, v in model.state_dict().items()}, losses,
                    state.dp.allreduce_calls)
        finally:
            dist.destroy_process_group()

    det = torch.backends.cudnn.deterministic
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        psum, again, rep = run("psum"), run("psum"), run("replicated")
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench

    def equal(a, b) -> bool:
        return all(torch.equal(a[k], b[k]) for k in b)

    deterministic = equal(again[0], psum[0]) and again[1] == psum[1]
    floor = norm_err(again[0], psum[0])
    err = norm_err(rep[0], psum[0])
    bit_equal = equal(rep[0], psum[0]) and rep[1] == psum[1]
    rec = {"phase": "slice7", "part": "a_replicated_vs_psum_world1",
           "model": "resnet50", "dtype": "float32", "batch": PARITY_BATCH,
           "steps": DP_PARITY_STEPS, "losses_psum": psum[1],
           "losses_replicated": rep[1], "bit_equal": bit_equal,
           "psum_bit_equal_to_itself": deterministic,
           "run_to_run_floor": floor, "norm_err": err,
           "allreduce_per_step": {"psum": psum[2], "replicated": rep[2]},
           "rule": ("bit-equal" if deterministic else
                    f"within {DP_NOISE_FACTOR} x the run-to-run floor"),
           "nvidia_smi": smi}
    emit(rec)
    ok = bit_equal if deterministic else err <= DP_NOISE_FACTOR * floor
    if not (ok and rep[2] > psum[2]):
        raise AssertionError(f"replicated disagrees with psum at world 1: "
                             f"{rec}")


def _fingerprints_equal(a: dict | None, b: dict | None) -> bool:
    return bool(a and b and a["fingerprint"] == b["fingerprint"])


def phase_slice7(torch, dev, smi, sock_rate: float) -> dict:
    """Phase 15; returns every kernel's launches summed over the
    main-path runs (c)-(e).  ``sock_rate``: phase 7's synthetic
    images/s."""
    import shutil
    from pathlib import Path

    slice7_replicated(torch, dev, smi)
    torch.cuda.empty_cache()
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # (b) is phase 14 (a) (the decoder picked); under --only slice7 here
    emit({"phase": "slice7", "part": "b_decoder_picked",
          "decoder": realdata_decode(smi)})
    # (c) the reference line on the decoder picked
    warmup, timed = REAL_BATCHES["b"]
    res_c, counts = _real_run("c_reference_line", _real_argv(
        "b", TRAIN_BATCH), warmup + timed, smi, phase="slice7",
        synthetic_images_per_sec=sock_rate)
    rate_c = res_c["total_images_per_sec"]
    add(counts)
    torch.cuda.empty_cache()
    # (d) the same through the input service at world 1
    res, counts = _real_run("d_input_service", _real_argv(
        "b", TRAIN_BATCH, "--input_service=on"), warmup + timed, smi,
        phase="slice7")
    d = res["data"]
    emit({"phase": "slice7", "part": "d_vs_c",
          "images_per_sec": res["total_images_per_sec"],
          "per_process_images_per_sec": rate_c,
          "ratio": res["total_images_per_sec"] / rate_c,
          "input_wait_ms_per_step": d["input_wait_ms_per_step"],
          "per_process_input_wait_ms_per_step":
              res_c["data"]["input_wait_ms_per_step"],
          "per_process_decode_ms_per_batch":
              1e3 * res_c["data"]["decode_wall_s"]
              / max(res_c["data"]["batches"], 1),
          "ring": {k: d[k] for k in (
              "ring_depth", "ring_occ_p50", "ring_occ_p99",
              "consumer_wait_s", "producer_stall_s")},
          "service": d["service"]})
    if not (d["input_service"] and d["service"]["errors"] == 0):
        raise AssertionError(f"the input service did not serve: {d}")
    add(counts)
    torch.cuda.empty_cache()
    # (e) checkpoints: save, resume, eval from one --train_dir
    ckdir = Path(__file__).resolve().parent / "build" / "slice7_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    warmup, timed = SLICE7_BATCHES["e"]
    base = ["1", "1", str(TRAIN_BATCH), "ib", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true", f"--train_dir={ckdir}",
            f"--save_model_steps={SLICE7_SAVE_STEPS}",
            f"--num_warmup_batches={warmup}", f"--num_batches={timed}",
            "--display_every=10"]
    try:
        first, counts = _real_run(
            "e_train_sync_saves", base + ["--async_checkpoint=false"],
            warmup + timed, smi, phase="slice7",
            synthetic_images_per_sec=sock_rate)
        add(counts)
        second, counts = _real_run(
            "e_resume_async_saves", base + ["--resume=must"],
            warmup + timed, smi, phase="slice7",
            synthetic_images_per_sec=sock_rate)
        add(counts)
        ev_warm, ev_timed = REAL_BATCHES["e"]
        ev, counts = _real_run(
            "e_eval_restored", _real_argv("e", TRAIN_BATCH, "--eval=true",
                                          f"--train_dir={ckdir}"),
            ev_warm + ev_timed, smi, phase="slice7")
        add(counts)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    rec = {"phase": "slice7", "part": "e_checkpoints",
           "saved_fingerprint": first["checkpoint"]["fingerprint"],
           "restored_fingerprint": second["resume"]["fingerprint"],
           "restored_step": second["resume"]["restored_step"],
           "eval_restored_step": ev["resume"]["restored_step"],
           "sync_save_blocking_ms": [
               x["blocking_ms"] for x in first["checkpoint"]["saves"]],
           "async_save_blocking_ms": [
               x["blocking_ms"] for x in second["checkpoint"]["saves"]],
           "images_per_sec": [first["total_images_per_sec"],
                              second["total_images_per_sec"]],
           "synthetic_images_per_sec": sock_rate,
           "vs_synthetic": [first["total_images_per_sec"] / sock_rate,
                            second["total_images_per_sec"] / sock_rate],
           "eval_top_1": ev["eval_top_1"], "nvidia_smi": smi}
    emit(rec)
    if not (_fingerprints_equal(first["checkpoint"], second["resume"])
            and _fingerprints_equal(second["checkpoint"], ev["resume"])
            and second["resume"]["restored_step"] == warmup + timed
            and not any(x["async"] for x in first["checkpoint"]["saves"])
            and all(x["async"] for x in second["checkpoint"]["saves"])):
        raise AssertionError(f"the checkpoint round trip failed: {rec}")
    torch.cuda.empty_cache()
    # (f) across the cards of this machine
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "slice7", "part": "f_multi_card", "ran": False,
              "cards": cards,
              "reason": f"needs 2 or more cards; this machine has {cards}"})
    else:
        slice7_multi_card(torch, smi, cards, ckdir)
    return total


def slice7_multi_card(torch, smi, cards: int, ckdir) -> None:
    """Phase 15 (f): ``1 0 128 ib`` on the fixture across every card,
    with ``--input_service=auto`` (the service engages: several workers
    on one host) and ``off``, then ``replicated`` against ``psum`` on
    the auto run: the parameters differ (sync-BN), the loss is
    finite."""
    import shutil

    warmup, timed = SLICE7_BATCHES["f"]
    base = ["1", "0", str(TRAIN_BATCH), "ib", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true",
            f"--data_dir={_fixture()}", *REFERENCE_LINE,
            f"--num_warmup_batches={warmup}", f"--num_batches={timed}",
            "--display_every=10"]
    runs = {}
    try:
        for name, extra in (
                ("auto", ["--input_service=auto",
                          f"--train_dir={ckdir}/psum"]),
                ("off", ["--input_service=off"]),
                ("auto_replicated", [
                    "--input_service=auto",
                    "--variable_update=replicated",
                    f"--train_dir={ckdir}/replicated"])):
            argv = base + extra
            rc, res = _launch(argv)
            d = res["data"]
            rec = {"phase": "slice7", "part": "f_multi_card", "ran": True,
                   "run": name, "cards": cards, "argv": argv, "rc": rc,
                   "input_service": d["input_service"],
                   "decode_workers": (d["service"]["decode_workers"]
                                      if d["input_service"]
                                      else d["decode_workers"]),
                   "nvidia_smi": smi,
                   **{k: res[k] for k in DP_RESULT_KEYS}}
            emit(rec)
            runs[name] = res
            if not (rc == 0 and res["total_workers"] == cards
                    and math.isfinite(res["final_loss"])
                    and d["input_service"] == (name != "off")):
                raise AssertionError(f"slice7 run across {cards} cards "
                                     f"failed: {rec}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    apart = not _fingerprints_equal(runs["auto"]["checkpoint"],
                                    runs["auto_replicated"]["checkpoint"])
    emit({"phase": "slice7", "part": "f_replicated_vs_psum",
          "cards": cards, "parameters_differ": apart,
          "final_loss": {k: runs[k]["final_loss"]
                         for k in ("auto", "auto_replicated")},
          "auto_vs_off_images_per_sec":
              runs["auto"]["total_images_per_sec"]
              / runs["off"]["total_images_per_sec"]})
    if not apart:
        raise AssertionError("replicated trained the same parameters as "
                             "psum across the cards")



def serve2_feed(torch, dev, model, arm: str, quant: str = "off"):
    """Phase 3's fixed feed (two prompts, 4 decode steps) through one
    program pair of ``model``; the stacked logits ``[4, 2, vocab]``."""
    import numpy as np

    from tpu_hc_bench_torch.serve import decode as decode_mod

    family = decode_mod.build_family(model, quant=quant)
    ps, w, b, steps = 16, 36, 2, 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, model.vocab_size, n).astype(np.int32)
               for n in (100, 37)]
    feed = rng.integers(1, model.vocab_size, (steps, b)).astype(np.int32)
    tables = np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w)
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    kv = decode_mod.init_kv_state(family, 1 + b * w, ps, quant=quant,
                                  device=dev)
    prefill = decode_mod.build_prefill_fn(family, ps, w, quant=quant)
    decode = decode_mod.build_decode_fn(family, ps, w, attention=arm,
                                        quant=quant)
    lengths = np.zeros((b,), np.int32)
    for i, prompt in enumerate(prompts):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :len(prompt)] = prompt
        prefill(kv, t(toks), len(prompt), t(tables[i]))
        lengths[i] = len(prompt)
    out = []
    for s in range(steps):
        _, lg, kv = decode(kv, t(feed[s]), t(tables), t(lengths),
                           t(np.ones((b,), bool)))
        out.append(lg)
        lengths += 1
    del kv, family
    return torch.stack(out)


def serve2_engine(model, name: str, *extra: str):
    """A ``--decode_attention=paged`` engine over ``model`` on phase 4's
    trace (``extra`` flags added), and the trace."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.serve import cli

    cfg = flags.parse_flags([f"--model={name}", "--decode_attention=paged",
                             *SERVE2_TRACE, *extra])
    return cli.build_engine_and_requests(
        cfg, lambda m: print(m, file=sys.stderr, flush=True), model=model)


def serve2_run(torch, engine, requests, layers: int, **run_kw):
    """One run, every count zeroed just before and read just after: the
    summary, the token tap and the counts, held to ``layers`` row-1
    launches and ``2 layers - 1`` row-2 launches a decode step."""
    tap = TokenTap()
    _zero_counts()
    summary = engine.run(requests, writer=tap, **run_kw)
    torch.cuda.synchronize()
    counts = _read_counts()
    steps = summary["decode_steps"]
    want = {"paged_decode_attention": layers * steps,
            "fused_residual_norm": (2 * layers - 1) * steps}
    if not (steps > 0 and all(counts[k] == v for k, v in want.items())
            and not any(n for k, n in counts.items() if k not in want)):
        raise AssertionError(f"serve2 run off its kernels: {counts}, "
                             f"expected {want} in {steps} decode steps")
    return summary, tap, counts


def _token_share(got: dict, want: dict) -> float:
    """The share of generated positions equal between two runs."""
    same = total = 0
    for rid, ref in want.items():
        other = got.get(rid, [])
        total += len(ref)
        same += sum(a == b for a, b in zip(ref, other))
    return same / max(total, 1)


SERVE2_KEYS = ("requests", "completed", "wall_s", "tokens", "tokens_per_s",
               "decode_steps", "prefill_steps", "p50_ttft_ms", "p99_ttft_ms",
               "p50_e2e_ms", "p99_e2e_ms", "kv_pages", "kv_pool_bytes",
               "weight_bytes", "quant")


def phase_serve2(torch, dev, smi, llama, phase4: dict) -> dict:
    """Phase 16: the serving lane's second slice; returns every kernel's
    launches summed over its in-process runs (b)-(f).  ``llama`` and
    ``phase4`` are phase 4's model and its run (tokens, summary)."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops.fused_residual_ln import (
        fused_residual_norm, norm_design)
    from tpu_hc_bench_torch.serve import faults as faults_mod
    from tpu_hc_bench_torch.serve.arrivals import Request
    from tpu_hc_bench_torch.serve.engine import VirtualClock

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # (a) gpt2 at full width: the paged program against the gather one
    t0 = time.perf_counter()
    gpt2, _ = create_model("gpt2", device=dev, seed=0, seq_len=576)
    torch.cuda.synchronize()
    emit({"phase": "serve2", "part": "a_model", "name": "gpt2",
          "params": sum(p.numel() for p in gpt2.parameters()),
          "position_rows": gpt2.wpe.weight.shape[0],
          "init_s": time.perf_counter() - t0, "nvidia_smi": smi})
    ref = serve2_feed(torch, dev, gpt2, "gather")
    got = serve2_feed(torch, dev, gpt2, "paged")
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * GPT2_PARITY_TOL
    rec = {"phase": "serve2", "part": "a_gpt2_parity",
           "shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": err, "tol": GPT2_PARITY_TOL,
           "argmax_equal_where_top2_gap_gt_2tol": bool(
               (got.argmax(-1) == ref.argmax(-1))[clear].all()),
           "nvidia_smi": smi}
    emit(rec)
    if not (rec["finite"] and err <= GPT2_PARITY_TOL
            and rec["argmax_equal_where_top2_gap_gt_2tol"]):
        raise AssertionError(f"gpt2 paged program disagrees: {rec}")
    del ref, got
    torch.cuda.empty_cache()

    # (b) gpt2 serving on phase 4's trace
    engine, requests = serve2_engine(gpt2, "gpt2")
    summary, _, counts = serve2_run(torch, engine, requests, 12)
    add(counts)
    rec = {"phase": "serve2", "part": "b_gpt2_serve", "launches": counts,
           "norm_design_8x768": norm_design(8, 768, torch.float32),
           "norm_design_last_launch": fused_residual_norm.design,
           "nvidia_smi": smi, **{k: summary[k] for k in SERVE2_KEYS}}
    emit(rec)
    if summary["completed"] != 16:
        raise AssertionError(f"gpt2 serve incomplete: {rec}")

    # (e) one gpt2 engine, three KV arms, on one shared prompt
    n, plen, out = SERVE2_SHARED
    block = np.random.default_rng(3).integers(
        1, gpt2.vocab_size, plen).astype(np.int32)
    shared = [Request(rid=i, arrival_s=i / 64, prompt=block.copy(),
                      output_len=out) for i in range(n)]
    arms = {}
    for arm, kw in (("worst", dict(kv_reserve="worst")),
                    ("lazy", dict(kv_reserve="lazy")),
                    ("lazy_prefix", dict(kv_reserve="lazy",
                                         prefix_cache="on"))):
        s, tap, counts = serve2_run(torch, engine, shared, 12,
                                    clock=VirtualClock(SERVE2_VCOSTS), **kw)
        add(counts)
        arms[arm] = (s, tap)
        kvf = s["kv_pool"]
        emit({"phase": "serve2", "part": "e_kv_arm", "arm": arm,
              "completed": s["completed"], "decode_steps": s["decode_steps"],
              "pages_peak": kvf["pages_peak"], "kv_pool_util": kvf["util"],
              "pages_grown": kvf["pages_grown"],
              "cow_copies": kvf["cow_copies"],
              "prefix_hits": kvf["prefix_hits"],
              "prefix_lookups": kvf["prefix_lookups"],
              "prefix_hit_frac": kvf["prefix_hit_frac"],
              "prefix_pages_shared": kvf["prefix_pages_shared"],
              "launches": counts, "nvidia_smi": smi})
    worst, lazy, pre = (arms[a][0]["kv_pool"] for a in
                        ("worst", "lazy", "lazy_prefix"))
    equal = all(arms[a][1].tokens == arms["worst"][1].tokens
                for a in arms)
    rec = {"phase": "serve2", "part": "e_kv_arms", "tokens_equal": equal,
           "completed": [arms[a][0]["completed"] for a in arms],
           "pages_peak": [worst["pages_peak"], lazy["pages_peak"],
                          pre["pages_peak"]],
           "prefix_hits": pre["prefix_hits"], "cow_copies": pre["cow_copies"],
           "nvidia_smi": smi}
    emit(rec)
    if not (equal and all(c == n for c in rec["completed"])
            and pre["prefix_hits"] > 0 and pre["cow_copies"] > 0
            and lazy["pages_peak"] < worst["pages_peak"]):
        raise AssertionError(f"the KV arms disagree: {rec}")
    del engine
    torch.cuda.empty_cache()

    # (f) degradation in virtual time, then a real SIGTERM and a resume
    engine, requests = serve2_engine(
        gpt2, "gpt2", f"--kv_pages={SERVE2_F['kv_pages']}")
    burst = [Request(rid=r.rid, arrival_s=0.0, prompt=r.prompt,
                     output_len=r.output_len) for r in requests]
    s, tap, counts = serve2_run(
        torch, engine, burst, 12, clock=VirtualClock(SERVE2_VCOSTS),
        faults=faults_mod.parse_serve_plan(SERVE2_F["plan"]),
        shed="deadline", kv_preempt="on",
        deadline_ms=SERVE2_F["deadline_ms"])
    add(counts)
    deg = s["degrade"]
    rec = {"phase": "serve2", "part": "f_degrade", **SERVE2_F,
           "completed": s["completed"], "degrade": deg,
           "records": tap.kinds, "launches": counts, "nvidia_smi": smi}
    emit(rec)
    if not (sum(deg["shed"].values()) > 0 and deg["preempts"] > 0
            and deg["requeues"] > 0 and deg["quarantined"] == 1
            and s["completed"] + sum(deg["shed"].values())
            + deg["quarantined"] == len(burst)):
        raise AssertionError(f"the plan did not force its dispositions: "
                             f"{rec}")
    del engine, gpt2
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    jdir = root / "build" / "serve2_journal"
    shutil.rmtree(jdir, ignore_errors=True)
    journal = jdir / "serve_journal.json"
    nreq, at = SERVE2_SIGTERM
    argv = [sys.executable, "-m", "tpu_hc_bench_torch", "serve",
            "--model=gpt2", "--decode_attention=paged",
            *[a for a in SERVE2_TRACE if not a.startswith("--num_requests")],
            f"--num_requests={nreq}", f"--serve_journal={journal}",
            "--serve_step_timeout_s=120"]

    def served(out: str) -> tuple[int, int]:
        import re

        m = re.search(r"serve: (\d+)/(\d+) requests", out)
        return (int(m.group(1)), int(m.group(2))) if m else (-1, -1)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    first = subprocess.run(argv + [f"--serve_faults=sigterm@{at}"],
                           cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
    unfinished = (json.loads(journal.read_text())["unfinished"]
                  if journal.exists() else -1)
    second = subprocess.run(argv + [f"--serve_resume={journal}"], cwd=root,
                            env=env, capture_output=True, text=True,
                            timeout=600)
    shutil.rmtree(jdir, ignore_errors=True)
    rec = {"phase": "serve2", "part": "f_sigterm_resume",
           "rc": [first.returncode, second.returncode],
           "served": [served(first.stdout), served(second.stdout)],
           "journal_unfinished": unfinished, "requests": nreq,
           "sigterm_at_s": at, "nvidia_smi": smi}
    emit(rec)
    done1, total1 = rec["served"][0]
    if not (first.returncode == 75 and second.returncode == 0
            and total1 == nreq and unfinished >= 1
            and done1 + unfinished == nreq
            and rec["served"][1] == (unfinished, unfinished)):
        raise AssertionError(
            f"drain/resume failed: {rec}\n{first.stdout[-2000:]}"
            f"{first.stderr[-2000:]}\n{second.stdout[-2000:]}"
            f"{second.stderr[-2000:]}")

    # (c) llama_1b under int8_kv on phase 4's trace
    layers = llama.num_layers
    engine, requests = serve2_engine(llama, "llama_1b", "--quant=int8_kv")
    s, tap, counts = serve2_run(torch, engine, requests, layers)
    add(counts)
    f32 = serve2_feed(torch, dev, llama, "paged")
    q8 = serve2_feed(torch, dev, llama, "paged", quant="int8_kv")
    err = float((q8 - f32).abs().max())
    scale = float(f32.abs().max())
    base = phase4["summary"]
    rec = {"phase": "serve2", "part": "c_llama_int8_kv",
           "pool_dtype": str(engine._kv[0].dtype),
           "kv_pool_bytes": s["kv_pool_bytes"],
           "kv_scale_bytes": s["kv_scale_bytes"],
           "f32_kv_pool_bytes": phase4["kv_pool_bytes"],
           "pool_bytes_ratio": s["kv_pool_bytes"] / phase4["kv_pool_bytes"],
           "feed_max_abs_err": err, "feed_f32_max_abs": scale,
           "feed_rel_tol": INT8_KV_REL_TOL,
           "feed_argmax_equal_share": float(
               (q8.argmax(-1) == f32.argmax(-1)).float().mean()),
           "token_share_equal_phase4": _token_share(tap.tokens,
                                                    phase4["tokens"]),
           "phase4_tokens_per_s": base["tokens_per_s"], "launches": counts,
           "nvidia_smi": smi, **{k: s[k] for k in SERVE2_KEYS}}
    emit(rec)
    if not (rec["pool_dtype"] == "torch.int8" and s["completed"] == 16
            and bool(torch.isfinite(q8).all())
            and err <= INT8_KV_REL_TOL * scale):
        raise AssertionError(f"int8_kv run failed: {rec}")
    del engine, f32, q8
    torch.cuda.empty_cache()

    # (d) llama_1b under int8_w on phase 4's trace
    engine, requests = serve2_engine(llama, "llama_1b", "--quant=int8_w")
    s, tap, counts = serve2_run(torch, engine, requests, layers)
    add(counts)
    # the cast eager PyTorch pays at each product: every int8 projection
    # of one decode step cast to float32 once, timed alone
    leaves = engine.family.qweights.values()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cast_ms = []
    for _ in range(5):
        start.record()
        for leaf in leaves:
            leaf["q"].to(torch.float32)
        end.record()
        end.synchronize()
        cast_ms.append(start.elapsed_time(end))
    rec = {"phase": "serve2", "part": "d_llama_int8_w",
           "cast_ms_a_step": statistics.median(cast_ms),
           "wall_ms_per_decode_step": 1e3 * s["wall_s"] / s["decode_steps"],
           "phase4_wall_ms_per_decode_step": 1e3 * base["wall_s"]
           / base["decode_steps"],
           "f32_weight_bytes": phase4["weight_bytes"],
           "weight_bytes_ratio": s["weight_bytes"] / phase4["weight_bytes"],
           "phase4_tokens_per_s": base["tokens_per_s"],
           "tokens_per_s_ratio": s["tokens_per_s"] / base["tokens_per_s"],
           "token_share_equal_phase4": _token_share(tap.tokens,
                                                    phase4["tokens"]),
           "launches": counts, "nvidia_smi": smi,
           **{k: s[k] for k in SERVE2_KEYS}}
    emit(rec)
    if s["completed"] != 16:
        raise AssertionError(f"int8_w run incomplete: {rec}")
    del engine
    torch.cuda.empty_cache()
    return total

def _slice9_run(torch, part: str, argv: list[str], smi: str,
                expect: dict | None = None,
                phase: str = "slice9") -> tuple[dict, dict, list]:
    """One training run of phase 17 (or 18) through ``launcher.main``:
    every count zeroed just before and read just after, peak memory from
    a reset; ``expect``: each listed kernel's count (the rest must be
    0).  Returns the result line, the counts and the record."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rc, res = _launch(argv)
    counts = _read_counts()
    rec = {"phase": phase, "part": part, "argv": argv, "rc": rc,
           "launches": counts, "expected_launches": expect,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "nvidia_smi": smi,
           **{k: res.get(k) for k in (
               "total_images_per_sec", "mean_step_ms", "p50_step_ms", "mfu",
               "final_loss", "global_batch", "gradient_accumulation_steps",
               "extra", "device_kind")}}
    rec["sequences_per_sec"] = res.get("total_images_per_sec")
    emit(rec)
    ok = (rc == 0 and math.isfinite(res["final_loss"])
          and res["total_images_per_sec"] > 0)
    if expect is not None:
        ok = ok and all(counts[k] == expect.get(k, 0) for k in counts)
    if not ok:
        raise AssertionError(f"{phase} run {part} failed: {rec}")
    return res, counts, rec


def _slice9_argv(fabric: str, batch: int, model: str, steps: tuple,
                 *extra: str) -> list[str]:
    warmup, timed = steps
    return ["1", "1", str(batch), fabric, f"--model={model}",
            "--use_fp16=true", "--attention_impl=flash",
            f"--num_warmup_batches={warmup}", f"--num_batches={timed}",
            "--display_every=10", *extra]


def _slice9_expect(layers: int, steps: int, fused: bool,
                   fwd_per_layer: int = 1) -> dict:
    return {FLASH_KERNELS["fwd"][0]: fwd_per_layer * layers * steps,
            FLASH_KERNELS["dq"][0]: layers * steps,
            FLASH_KERNELS["dkv"][0]: layers * steps,
            **{XENT_KERNELS[k][0]: steps if fused else 0
               for k in XENT_KERNELS}}


def slice9_first_loss(torch, dev, smi) -> float:
    """(a)'s first-step check: llama_1b's logits and loss on the runs'
    batch, bf16, flash against dense from one seed (forward only; these
    launches are not counted)."""
    from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    losses, logits = {}, {}
    for impl in ("dense", "flash"):
        model, spec = create_model("llama_1b", torch.bfloat16, impl,
                                   device=dev, seed=0, train=True)
        tokens, targets, weights = tokens_to_device(SyntheticTokens(
            SLICE9_LLAMA_BATCH, spec.input_shape[0], seed=0,
            vocab_size=spec.vocab_size, causal_lm=True).batch(), dev)
        with torch.no_grad():
            logits[impl] = model(tokens)
            losses[impl] = float(step_mod.lm_loss_fn(logits[impl], targets,
                                                     weights))
        del model
        torch.cuda.empty_cache()
    rel = abs(losses["flash"] - losses["dense"]) / abs(losses["dense"])
    logits_rel = rel_err(logits["flash"], logits["dense"])
    finite = bool(torch.isfinite(logits["flash"]).all())
    del logits
    torch.cuda.empty_cache()
    rec = {"phase": "slice9", "part": "a_first_loss", "losses": losses,
           "rel_err": rel, "tol": SLICE9_FIRST_LOSS_TOL,
           "logits_rel_err": logits_rel,
           "logits_tol": SLICE9_FIRST_LOGITS_TOL, "nvidia_smi": smi}
    emit(rec)
    if not (finite and math.isfinite(losses["flash"])
            and rel <= SLICE9_FIRST_LOSS_TOL
            and logits_rel <= SLICE9_FIRST_LOGITS_TOL):
        raise AssertionError(f"llama_1b flash first forward off dense: "
                             f"{rec}")
    return losses["flash"]


def slice9_serve(torch, dev, smi) -> dict:
    """(f): gpt2_moe served, float32, on phase 4's trace; returns the
    run's counts."""
    import numpy as np

    from tpu_hc_bench_torch.models import create_model, moe

    t0 = time.perf_counter()
    model, _ = create_model("gpt2_moe", device=dev, seed=0, seq_len=576)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = serve2_feed(torch, dev, model, "gather")
    got = serve2_feed(torch, dev, model, "paged")
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * GPT2_PARITY_TOL
    parity = {"max_abs_err": err, "tol": GPT2_PARITY_TOL,
              "finite": bool(torch.isfinite(got).all()),
              "argmax_equal_where_top2_gap_gt_2tol": bool(
                  (got.argmax(-1) == ref.argmax(-1))[clear].all())}
    del ref, got
    engine, requests = serve2_engine(model, "gpt2_moe")
    reads0 = moe.host_reads
    summary, tap, counts = serve2_run(torch, engine, requests,
                                      model.num_layers)
    reads = moe.host_reads - reads0
    steps, prefills = summary["decode_steps"], summary["prefill_steps"]
    syncs_per_step = (reads - model.num_layers * prefills) / steps
    # greedy decode against the full forward's argmax (ragged, as served)
    for layer in model.layers:
        layer.moe.impl = "ragged"
    agree = checked = 0
    for r in requests[:SLICE9_GREEDY_CHECKS]:
        gen = tap.tokens[r.rid]
        seq = np.concatenate([r.prompt, np.asarray(gen[:-1], np.int32)])
        with torch.no_grad():
            lg = model(torch.from_numpy(seq[None].astype(np.int64)).to(dev))
        pred = lg[0, len(r.prompt) - 1:].float()
        top2 = pred.topk(2, dim=-1).values
        clear_tok = ((top2[:, 0] - top2[:, 1]) > 2 * GPT2_PARITY_TOL).cpu()
        same = (pred.argmax(-1).cpu() == torch.tensor(gen))
        agree += int(same[clear_tok].sum())
        checked += int(clear_tok.sum())
    rec = {"phase": "slice9", "part": "f_gpt2_moe_serve",
           "params": sum(p.numel() for p in model.parameters()),
           "init_s": init_s, "parity": parity, "launches": counts,
           "expected_launches": {
               "paged_decode_attention": model.num_layers * steps,
               "fused_residual_norm": (2 * model.num_layers - 1) * steps},
           "ragged_host_reads": reads,
           "host_syncs_per_decode_step": syncs_per_step,
           "greedy_checked_tokens": checked, "greedy_equal_tokens": agree,
           "nvidia_smi": smi,
           **{k: summary[k] for k in SERVE2_KEYS if k in summary},
           "p99_e2e_ms": summary["p99_e2e_ms"]}
    emit(rec)
    del engine, model
    torch.cuda.empty_cache()
    if not (parity["finite"] and err <= GPT2_PARITY_TOL
            and parity["argmax_equal_where_top2_gap_gt_2tol"]
            and summary["completed"] == summary["requests"]
            and checked > 0 and agree == checked
            and syncs_per_step == rec["expected_launches"][
                "paged_decode_attention"] / steps):
        raise AssertionError(f"gpt2_moe serving failed: {rec}")
    return counts


def slice9_batch_search(torch, smi, rate_b2: float) -> None:
    """(b) continued: llama_1b under remat at batches 4, 8, ... until one
    does not fit (the card's OutOfMemoryError ends the search), each
    with its sequences/s."""
    import gc

    found = []
    batch = 2 * SLICE9_LLAMA_BATCH
    while batch <= SLICE9_MAX_BATCH:
        argv = _slice9_argv("sock", batch, "llama_1b", SLICE9_SEARCH_STEPS,
                            "--gradient_checkpointing=true")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            rc, res = _launch(argv)
        except torch.cuda.OutOfMemoryError:
            gc.collect()
            torch.cuda.empty_cache()
            emit({"phase": "slice9", "part": "b_batch_search",
                  "batch": batch, "fits": False, "nvidia_smi": smi})
            break
        if rc != 0 or not math.isfinite(res["final_loss"]):
            raise AssertionError(f"remat batch {batch} run failed: {res}")
        found.append((batch, res["total_images_per_sec"]))
        emit({"phase": "slice9", "part": "b_batch_search", "batch": batch,
              "fits": True, "sequences_per_sec": res["total_images_per_sec"],
              "mfu": res["mfu"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "nvidia_smi": smi})
        batch *= 2
    emit({"phase": "slice9", "part": "b_largest_batch",
          "batch": found[-1][0] if found else SLICE9_LLAMA_BATCH,
          "sequences_per_sec": found[-1][1] if found else rate_b2,
          "searched_up_to": SLICE9_MAX_BATCH, "nvidia_smi": smi})


def phase_slice9(torch, dev, smi) -> dict:
    """Phase 17: the decoder lane's rest; returns every kernel's
    launches summed over the main-path runs (a)-(c) and (f)."""
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    steps = sum(SLICE9_STEPS)
    llama_layers, moe_layers = 16, 12
    # (a) llama_1b training, plain and --fused_xent
    first = slice9_first_loss(torch, dev, smi)
    runs = {}
    for fused in (False, True):
        res, counts, rec = _slice9_run(
            torch, f"a_llama_1b_fused_xent_{str(fused).lower()}",
            _slice9_argv("sock", SLICE9_LLAMA_BATCH, "llama_1b", SLICE9_STEPS,
                         f"--fused_xent={str(fused).lower()}"),
            smi, _slice9_expect(llama_layers, steps, fused))
        if not res["final_loss"] < first:
            raise AssertionError(f"llama_1b loss did not fall: {rec}")
        runs[fused] = rec
        add(counts)
    # (b) --gradient_checkpointing at (a)'s batch: the same losses, less
    # memory, the forward kernel twice a layer
    res_b, counts, rec_b = _slice9_run(
        torch, "b_llama_1b_remat",
        _slice9_argv("sock", SLICE9_LLAMA_BATCH, "llama_1b", SLICE9_STEPS,
                     "--fused_xent=true", "--gradient_checkpointing=true"),
        smi, _slice9_expect(llama_layers, steps, True, fwd_per_layer=2))
    add(counts)
    rel = abs(res_b["final_loss"] - runs[True]["final_loss"]) / abs(
        runs[True]["final_loss"])
    rec = {"phase": "slice9", "part": "b_remat_vs_a",
           "final_loss_rel_err": rel, "tol": SLICE9_REMAT_LOSS_TOL,
           "peak_mem_gb": rec_b["peak_mem_gb"],
           "peak_mem_gb_a": runs[True]["peak_mem_gb"], "nvidia_smi": smi}
    emit(rec)
    if not (rel <= SLICE9_REMAT_LOSS_TOL
            and rec_b["peak_mem_gb"] < runs[True]["peak_mem_gb"]):
        raise AssertionError(f"remat run off (a): {rec}")
    # (c) gpt2_moe training, einsum and ragged
    for impl in ("einsum", "ragged"):
        res, counts, rec = _slice9_run(
            torch, f"c_gpt2_moe_{impl}",
            _slice9_argv("sock", SLICE9_MOE_BATCH, "gpt2_moe", SLICE9_STEPS,
                         f"--moe_impl={impl}"),
            smi, _slice9_expect(moe_layers, steps, False))
        add(counts)
        extra = res["extra"] or {}
        if not (math.isfinite(extra.get("moe_aux_loss", math.nan))
                and (impl == "ragged") == (extra["moe_drop_fraction"] == 0)):
            raise AssertionError(f"gpt2_moe {impl} aux/drops off: {extra}")
    # (d) accumulation 8 into bf16 against f32 (a one-rank NCCL group),
    # and the loss with no update on the same batch (forward only)
    frozen, _, _ = _slice9_run(
        torch, "d_gpt2_moe_no_update",
        _slice9_argv("sock", SLICE9_MOE_BATCH, "gpt2_moe",
                     SLICE9_ACCUM_STEPS, "--forward_only=true"),
        smi, {FLASH_KERNELS["fwd"][0]: moe_layers * sum(SLICE9_ACCUM_STEPS)})
    accum = {}
    for dt in ("f32", "bf16"):
        res, counts, rec = _slice9_run(
            torch, f"d_gpt2_moe_accum_{dt}",
            _slice9_argv("ib", SLICE9_MOE_BATCH, "gpt2_moe",
                         SLICE9_ACCUM_STEPS,
                         f"--gradient_accumulation_steps={SLICE9_ACCUM}",
                         f"--accum_dtype={dt}"),
            smi, _slice9_expect(moe_layers,
                                SLICE9_ACCUM * sum(SLICE9_ACCUM_STEPS),
                                False))
        accum[dt] = rec
    ref = accum["f32"]["final_loss"]
    rel = abs(accum["bf16"]["final_loss"] - ref) / abs(ref)
    moved = {k: abs(v["final_loss"] - frozen["final_loss"])
             / abs(frozen["final_loss"]) for k, v in accum.items()}
    rec = {"phase": "slice9", "part": "d_accum_bf16_vs_f32",
           "final_loss": {k: v["final_loss"] for k, v in accum.items()},
           "final_loss_rel_diff": rel, "tol": SLICE9_ACCUM_LOSS_TOL,
           "no_update_loss": frozen["final_loss"],
           "rel_diff_from_no_update": moved,
           "min_rel_diff_from_no_update":
               SLICE9_ACCUM_MOVED * SLICE9_ACCUM_LOSS_TOL,
           "peak_mem_gb": {k: v["peak_mem_gb"] for k, v in accum.items()},
           "sequences_per_sec": {k: v["sequences_per_sec"]
                                 for k, v in accum.items()},
           "nvidia_smi": smi}
    emit(rec)
    if not (rel <= SLICE9_ACCUM_LOSS_TOL
            and min(moved.values())
            >= SLICE9_ACCUM_MOVED * SLICE9_ACCUM_LOSS_TOL):
        raise AssertionError(f"bf16 accumulation off f32: {rec}")
    # (e) --scan_layers against unrolled from the same seed
    for name, batch, layers in (("gpt2", SLICE9_SCAN_GPT2_BATCH, 12),
                                ("llama_1b", SLICE9_LLAMA_BATCH,
                                 llama_layers)):
        losses = {}
        for scan in (False, True):
            res, _, _ = _slice9_run(
                torch, f"e_{name}_scan_{str(scan).lower()}",
                _slice9_argv("sock", batch, name, SLICE9_SCAN_STEPS,
                             f"--scan_layers={str(scan).lower()}"), smi,
                _slice9_expect(layers, sum(SLICE9_SCAN_STEPS), False))
            losses[scan] = res["final_loss"]
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        rec = {"phase": "slice9", "part": f"e_{name}_scan_vs_unrolled",
               "final_loss": {"unrolled": losses[False],
                              "scan": losses[True]},
               "rel_err": rel, "tol": SLICE9_SCAN_LOSS_TOL,
               "nvidia_smi": smi}
        emit(rec)
        if rel > SLICE9_SCAN_LOSS_TOL:
            raise AssertionError(f"{name} scanned off unrolled: {rec}")
    # (f) gpt2_moe served
    add(slice9_serve(torch, dev, smi))
    # (b) continued: the largest remat batch that fits
    slice9_batch_search(torch, smi, rec_b["sequences_per_sec"])
    return total


def _zoo_argv(model: str, batch: int, steps: tuple, *extra: str,
              fabric: str = "sock") -> list[str]:
    warmup, timed = steps
    return ["1", "1", str(batch), fabric, f"--model={model}",
            "--use_fp16=true", f"--num_warmup_batches={warmup}",
            f"--num_batches={timed}", "--display_every=10", *extra]


def _zoo_expect(layers: int, steps: int, remat: bool = False) -> dict:
    """Rows 3/4a/4b's launches in a flash ViT run: one a layer and step,
    the forward twice under remat; every other kernel none."""
    return {FLASH_KERNELS["fwd"][0]: (2 if remat else 1) * layers * steps,
            FLASH_KERNELS["dq"][0]: layers * steps,
            FLASH_KERNELS["dkv"][0]: layers * steps}


def zoo_first_losses(torch, dev, name: str, batch: int,
                     arms: tuple, s2d: bool = False) -> dict:
    """The first training-mode loss of ``name`` seeded as the runs seed
    it (weights and dropout from seed 0) on the runs' first batch, once
    per ``(dtype, attention_impl)`` arm (forward only; these launches
    are not counted)."""
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    losses = {}
    # one forward a shape: cuDNN's heuristic picks, no algorithm search
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        for dname, impl in arms:
            model, spec = create_model(name, getattr(torch, dname), impl,
                                       device=dev, seed=0, train=True,
                                       space_to_depth=s2d)
            batch_t = to_device(SyntheticImages(
                batch, spec.input_shape, 1000, 0).batch(), dev)
            with torch.no_grad():
                losses[f"{dname}_{impl}"] = float(
                    step_mod.batch_loss(model, batch_t))
            del model, batch_t
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = bench
    return losses


def zoo_vit(torch, dev, smi, add) -> None:
    """(a)-(c): vit_b16 flash and dense, remat and its batch search,
    vit_l16."""
    import gc

    steps = sum(ZOO_VIT_STEPS)
    layers = ZOO_VIT_LAYERS["vit_b16"]
    first = zoo_first_losses(torch, dev, "vit_b16", ZOO_VIT_BATCH,
                             (("bfloat16", "flash"), ("bfloat16", "dense")))
    rel = abs(first["bfloat16_flash"] - first["bfloat16_dense"]) / abs(
        first["bfloat16_dense"])
    rec = {"phase": "zoo", "part": "a_vit_b16_first_loss", "losses": first,
           "rel_err": rel, "tol": ZOO_VIT_FIRST_LOSS_TOL, "nvidia_smi": smi}
    emit(rec)
    if not (math.isfinite(first["bfloat16_flash"])
            and rel <= ZOO_VIT_FIRST_LOSS_TOL):
        raise AssertionError(f"vit_b16 flash first loss off dense: {rec}")
    runs = {}
    for impl in ("flash", "dense"):
        _, counts, runs[impl] = _slice9_run(
            torch, f"a_vit_b16_{impl}",
            _zoo_argv("vit_b16", ZOO_VIT_BATCH, ZOO_VIT_STEPS,
                      f"--attention_impl={impl}"), smi,
            _zoo_expect(layers, steps) if impl == "flash" else {},
            phase="zoo")
        add(counts)
    # (b) remat at (a)'s batch: the same losses, less memory, row 3 twice
    _, counts, rec_b = _slice9_run(
        torch, "b_vit_b16_remat",
        _zoo_argv("vit_b16", ZOO_VIT_BATCH, ZOO_VIT_STEPS,
                  "--attention_impl=flash", "--gradient_checkpointing=true"),
        smi, _zoo_expect(layers, steps, remat=True), phase="zoo")
    add(counts)
    a = runs["flash"]
    rel = abs(rec_b["final_loss"] - a["final_loss"]) / abs(a["final_loss"])
    rec = {"phase": "zoo", "part": "b_remat_vs_a", "final_loss_rel_err": rel,
           "tol": ZOO_REMAT_LOSS_TOL, "peak_mem_gb": rec_b["peak_mem_gb"],
           "peak_mem_gb_a": a["peak_mem_gb"], "nvidia_smi": smi}
    emit(rec)
    if not (rel <= ZOO_REMAT_LOSS_TOL
            and rec_b["peak_mem_gb"] < a["peak_mem_gb"]):
        raise AssertionError(f"vit_b16 remat off (a): {rec}")
    found = [(ZOO_VIT_BATCH, rec_b["total_images_per_sec"])]
    batch = 2 * ZOO_VIT_BATCH
    while batch <= ZOO_MAX_BATCH:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            rc, res = _launch(_zoo_argv(
                "vit_b16", batch, ZOO_SEARCH_STEPS, "--attention_impl=flash",
                "--gradient_checkpointing=true"))
        except torch.cuda.OutOfMemoryError:
            gc.collect()
            torch.cuda.empty_cache()
            emit({"phase": "zoo", "part": "b_batch_search", "batch": batch,
                  "fits": False, "nvidia_smi": smi})
            break
        if rc != 0 or not math.isfinite(res["final_loss"]):
            raise AssertionError(f"remat batch {batch} run failed: {res}")
        found.append((batch, res["total_images_per_sec"]))
        emit({"phase": "zoo", "part": "b_batch_search", "batch": batch,
              "fits": True, "images_per_sec": res["total_images_per_sec"],
              "mfu": res["mfu"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "nvidia_smi": smi})
        batch *= 2
    emit({"phase": "zoo", "part": "b_largest_batch", "batch": found[-1][0],
          "images_per_sec": found[-1][1], "searched_up_to": ZOO_MAX_BATCH,
          "nvidia_smi": smi})
    # (c) vit_l16 at (a)'s batch, or the largest power of two below it
    # that fits
    batch, layers = ZOO_VIT_BATCH, ZOO_VIT_LAYERS["vit_l16"]
    while True:
        try:
            _, counts, _ = _slice9_run(
                torch, f"c_vit_l16_batch_{batch}",
                _zoo_argv("vit_l16", batch, ZOO_VIT_L_STEPS,
                          "--attention_impl=flash"), smi,
                _zoo_expect(layers, sum(ZOO_VIT_L_STEPS)), phase="zoo")
            add(counts)
            break
        except torch.cuda.OutOfMemoryError:
            gc.collect()
            torch.cuda.empty_cache()
            if batch == 1:
                raise
            batch //= 2


def zoo_members(torch, dev, smi, add) -> None:
    """(d): every other image member once at its batch (resnet18 and
    resnet50_v2 again with --use_space_to_depth): no kernel of the table
    launches; the first bf16 loss against the float32 forward."""
    runs = [(name, batch, False) for name, batch in ZOO_BATCHES.items()]
    runs += [(name, ZOO_BATCHES[name], True) for name in ZOO_S2D]
    for name, batch, s2d in runs:
        first = zoo_first_losses(torch, dev, name, batch,
                                 (("bfloat16", "dense"),
                                  ("float32", "dense")), s2d)
        ref = first["float32_dense"]
        rel = abs(first["bfloat16_dense"] - ref) / abs(ref)
        extra = ["--use_space_to_depth=true"] if s2d else []
        part = f"d_{name}" + ("_s2d" if s2d else "")
        res, counts, rec = _slice9_run(
            torch, part, _zoo_argv(name, batch, ZOO_STEPS, *extra), smi, {},
            phase="zoo")
        add(counts)
        out = {"phase": "zoo", "part": part + "_summary", "model": name,
               "batch": batch, "space_to_depth": s2d,
               "images_per_sec": res["total_images_per_sec"],
               "ms_per_step": res["mean_step_ms"], "mfu": res["mfu"],
               "peak_mem_gb": rec["peak_mem_gb"],
               "final_loss": res["final_loss"], "first_loss": first,
               "first_loss_bf16_vs_f32_rel": rel, "tol": ZOO_BF16_LOSS_TOL,
               "nvidia_smi": smi}
        emit(out)
        if not (math.isfinite(ref) and rel <= ZOO_BF16_LOSS_TOL):
            raise AssertionError(f"{name} bf16 first loss off f32: {out}")


def _busy_s(torch, prof) -> float:
    """Device busy seconds of a profile: the union of its kernel
    intervals (one stream)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            busy, end = busy + t1 - t0, t1
        elif t1 > end:
            busy, end = busy + t1 - end, t1
    return busy * 1e-6


def zoo_idle(torch, dev, smi) -> None:
    """(e): the host-bound members' device idle share over timed steps:
    the step loop of the runs (bf16, momentum SGD, one synthetic batch),
    ``ZOO_STEPS`` warmup then timed steps under ``torch.profiler``
    tracing the device alone (host-side tracing of nasnet's ~18k
    launches a step would slow the host it measures)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    for name in ZOO_IDLE:
        batch = ZOO_BATCHES[name]
        cfg = flags.parse_benchmark_flags(["--use_fp16=true",
                                           f"--model={name}"])
        model, spec = create_model(name, torch.bfloat16, device=dev, seed=0,
                                   train=True)
        state = step_mod.make_train_state(model, cfg)
        batch_t = to_device(SyntheticImages(batch, spec.input_shape, 1000,
                                            0).batch(), dev)
        warmup, timed = ZOO_STEPS
        for _ in range(warmup):
            step_mod.train_step(state, batch_t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(timed):
                step_mod.train_step(state, batch_t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = _busy_s(torch, prof)
        kernels = sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        rec = {"phase": "zoo", "part": f"e_{name}_idle", "batch": batch,
               "profiled_steps": timed, "step_ms": 1e3 * wall / timed,
               "device_busy_ms_per_step": 1e3 * busy / timed,
               "device_idle_share": (1.0 - busy / wall) if busy else None,
               "kernels_per_step": kernels / timed, "nvidia_smi": smi}
        emit(rec)
        del state, model, batch_t, prof
        torch.cuda.empty_cache()
        if not busy:
            raise AssertionError(f"the profiler saw no device time: {rec}")


def phase_zoo(torch, dev, smi) -> dict:
    """Phase 18: the image zoo; returns every kernel's launches summed
    over the main-path runs (a)-(d)."""
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    zoo_vit(torch, dev, smi, add)
    zoo_members(torch, dev, smi, add)
    zoo_idle(torch, dev, smi)
    return total


def _slice11_batch(torch, dev, name: str, batch: int, model):
    """The runs' synthetic batch of ``name`` (seed 0) on the card."""
    from tpu_hc_bench_torch.data import synthetic
    from tpu_hc_bench_torch.models import get_model_spec
    from tpu_hc_bench_torch.models.deepspeech import max_label_for

    spec = get_model_spec(name)
    if spec.ctc:
        frames, freq = spec.input_shape
        return synthetic.speech_to_device(synthetic.SyntheticSpeech(
            batch, frames, freq, max_label_for(frames)).batch(), dev)
    return synthetic.ids_to_device(synthetic.SyntheticIds(
        batch, model.num_users, model.num_items).batch(), dev)


def slice11_first_losses(torch, dev, arms: tuple) -> dict:
    """deepspeech2's first training-mode CTC loss on the runs' batch, per
    ``(dtype, rnn_impl)`` arm, every arm on the first arm's weights (seed
    0, as the runs); forward only, cuDNN's heuristic picks."""
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    losses, state = {}, None
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        for dname, impl in arms:
            model, _ = create_model("deepspeech2", getattr(torch, dname),
                                    device=dev, seed=0, train=True,
                                    rnn_impl=impl)
            if state is None:
                state = {k: t.clone() for k, t in model.state_dict().items()}
            model.load_state_dict(state)
            batch = _slice11_batch(torch, dev, "deepspeech2",
                                   SLICE11_DS2_BATCH, model)
            with torch.no_grad():
                losses[f"{dname}_{impl}"] = float(
                    step_mod.batch_loss(model, batch, ctc=True))
            del model, batch
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = bench
    return losses


def _slice11_argv(model: str, batch: int, steps: tuple,
                  *extra: str) -> list[str]:
    warmup, timed = steps
    return ["1", "1", str(batch), "sock", f"--model={model}",
            "--use_fp16=true", f"--num_warmup_batches={warmup}",
            f"--num_batches={timed}", "--display_every=10", *extra]


def slice11_profile(torch, dev, smi) -> dict:
    """(a) continued: deepspeech2 hoisted's step loop (bf16, momentum
    SGD, the runs' batch) under ``torch.profiler`` tracing the device
    alone: kernels a step and the device's idle share over the timed
    steps."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod

    cfg = flags.parse_benchmark_flags(["--use_fp16=true",
                                       "--model=deepspeech2"])
    model, _ = create_model("deepspeech2", torch.bfloat16, device=dev,
                            seed=0, train=True)
    state = step_mod.make_train_state(model, cfg)
    batch = _slice11_batch(torch, dev, "deepspeech2", SLICE11_DS2_BATCH,
                           model)
    warmup, timed = SLICE11_DS2_STEPS
    for _ in range(warmup):
        step_mod.train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(timed):
            step_mod.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_s(torch, prof)
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    rec = {"phase": "slice11", "part": "a_deepspeech2_idle",
           "batch": SLICE11_DS2_BATCH, "profiled_steps": timed,
           "step_ms": 1e3 * wall / timed,
           "device_busy_ms_per_step": 1e3 * busy / timed,
           "device_idle_share": (1.0 - busy / wall) if busy else None,
           "kernels_per_step": kernels / timed, "nvidia_smi": smi}
    emit(rec)
    del state, model, batch, prof
    torch.cuda.empty_cache()
    if not busy:
        raise AssertionError(f"the profiler saw no device time: {rec}")
    return rec


def slice11_deepspeech(torch, dev, smi, add) -> None:
    """(a), (b): deepspeech2 trained in its three --rnn_impl arms."""
    first = slice11_first_losses(torch, dev, (
        ("bfloat16", "hoisted"), ("float32", "hoisted"),
        ("bfloat16", "bidi"), ("bfloat16", "flax")))
    ref = first["bfloat16_hoisted"]
    rel = {"bf16_vs_f32": abs(ref - first["float32_hoisted"])
           / abs(first["float32_hoisted"]),
           **{impl: abs(first[f"bfloat16_{impl}"] - ref) / abs(ref)
              for impl in ("bidi", "flax")}}
    rec = {"phase": "slice11", "part": "ab_first_losses", "losses": first,
           "rel_err": rel, "tol": {"bf16_vs_f32": SLICE11_BF16_LOSS_TOL,
                                   "arms": SLICE11_ARM_LOSS_TOL},
           "nvidia_smi": smi}
    emit(rec)
    if not (all(math.isfinite(v) for v in first.values())
            and rel["bf16_vs_f32"] <= SLICE11_BF16_LOSS_TOL
            and max(rel["bidi"], rel["flax"]) <= SLICE11_ARM_LOSS_TOL):
        raise AssertionError(f"deepspeech2 first losses off: {rec}")
    runs = {}
    for impl, steps in (("hoisted", SLICE11_DS2_STEPS),
                        ("bidi", SLICE11_ARM_STEPS),
                        ("flax", SLICE11_ARM_STEPS)):
        part = ("a" if impl == "hoisted" else "b") + f"_deepspeech2_{impl}"
        res, counts, runs[impl] = _slice9_run(
            torch, part, _slice11_argv("deepspeech2", SLICE11_DS2_BATCH,
                                       steps, f"--rnn_impl={impl}"),
            smi, {}, phase="slice11")
        add(counts)
    a = runs["hoisted"]
    emit({"phase": "slice11", "part": "ab_summary",
          "examples_per_sec": {k: r["total_images_per_sec"]
                               for k, r in runs.items()},
          "ms_per_step": {k: r["mean_step_ms"] for k, r in runs.items()},
          "step_vs_hoisted": {k: r["mean_step_ms"] / a["mean_step_ms"]
                              for k, r in runs.items()},
          "mfu": {k: r["mfu"] for k, r in runs.items()},
          "peak_mem_gb": {k: r["peak_mem_gb"] for k, r in runs.items()},
          "nvidia_smi": smi})
    slice11_profile(torch, dev, smi)


def slice11_ncf(torch, dev, smi, add) -> None:
    """(c): ncf trained at batch 2^20, then --eval's top-1 (binary
    accuracy) on 2 batches."""
    res, counts, rec = _slice9_run(
        torch, "c_ncf", _slice11_argv("ncf", SLICE11_NCF_BATCH,
                                      SLICE11_NCF_STEPS), smi, {},
        phase="slice11")
    add(counts)
    res, counts, rec = _slice9_run(
        torch, "c_ncf_eval", _slice11_argv("ncf", SLICE11_NCF_BATCH,
                                           SLICE11_NCF_EVAL,
                                           "--eval=true"), smi, {},
        phase="slice11")
    add(counts)
    top1 = res["eval_top_1"]
    emit({"phase": "slice11", "part": "c_ncf_eval_top_1", "top_1": top1,
          "nvidia_smi": smi})
    if top1 is None or not 0.0 <= top1 <= 1.0:
        raise AssertionError(f"ncf eval top-1 off: {res}")


def slice11_classify(torch, smi, add) -> None:
    """(d): the classify mode, float32 at full width, 32 Poisson requests
    at 8 in flight each; ncf refused.  cuDNN's heuristic picks the
    convs (an algorithm search at each of resnet50's shapes and buckets
    would dominate the phase)."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.serve import cli

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        for name in SLICE11_SERVE_MODELS:
            cfg = flags.parse_flags([f"--model={name}",
                                     *SLICE11_SERVE_TRACE])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine, requests = cli.build_engine_and_requests(
                cfg, lambda m: print(m, file=sys.stderr, flush=True))
            build_s = time.perf_counter() - t0
            _zero_counts()
            summary = engine.run(requests)
            torch.cuda.synchronize()
            counts = _read_counts()
            add(counts)
            rec = {"phase": "slice11", "part": f"d_classify_{name}",
                   "build_and_warm_s": build_s, "launches": counts,
                   "requests_per_s": summary["completed"]
                   / summary["wall_s"],
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "nvidia_smi": smi,
                   **{k: summary[k] for k in (
                       "requests", "completed", "wall_s", "classify_steps",
                       "decode_steps", "prefill_steps", "p50_e2e_ms",
                       "p99_e2e_ms", "p50_ttft_ms", "p99_ttft_ms",
                       "p99_queue_ms", "max_in_flight", "weight_bytes")}}
            emit(rec)
            del engine
            if not (summary["completed"] == summary["requests"] == 32
                    and summary["classify_steps"] > 0
                    and summary["decode_steps"] == 0
                    and summary["p99_ttft_ms"] == summary["p99_e2e_ms"]
                    and not any(counts.values())):
                raise AssertionError(f"classify serving failed: {rec}")
        try:
            cli.build_engine_and_requests(
                flags.parse_flags(["--model=ncf", *SLICE11_SERVE_TRACE]),
                lambda m: None)
        except ValueError as e:
            emit({"phase": "slice11", "part": "d_classify_ncf_refused",
                  "error": str(e), "nvidia_smi": smi})
        else:
            raise AssertionError("ncf classify was not refused")
    finally:
        torch.backends.cudnn.benchmark = bench
        torch.cuda.empty_cache()


def phase_slice11(torch, dev, smi) -> dict:
    """Phase 19: deepspeech2 in its three arms, ncf, the classify mode;
    returns every kernel's launches summed over (a)-(d), all 0."""
    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    slice11_deepspeech(torch, dev, smi, add)
    slice11_ncf(torch, dev, smi, add)
    slice11_classify(torch, smi, add)
    emit({"phase": "slice11", "part": "e_launches", "launches": total,
          "nvidia_smi": smi})
    if any(total.values()):
        raise AssertionError(f"a table kernel ran in phase 19: {total}")
    return total


class ObsTimer:
    """Host seconds in the serving lane's obs calls, each wrapped where
    the engine calls it (module functions, class methods, one writer's
    ``event``); ``restore`` puts the originals back."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._undo: list = []

    def wrap(self, owner, name: str, key: str) -> None:
        orig = getattr(owner, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.seconds[key] = (self.seconds.get(key, 0.0)
                                     + time.perf_counter() - t0)

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def wrap_engine_calls(self) -> None:
        from tpu_hc_bench_torch.obs import fleet, requests, signals, sketch
        from tpu_hc_bench_torch.obs import timeline

        self.wrap(timeline, "record_span", "spans")
        self.wrap(timeline, "instant", "spans")
        self.wrap(sketch.QuantileSketch, "add", "sketches")
        self.wrap(signals.SignalEngine, "observe", "signals")
        self.wrap(signals, "append_events", "signals")
        self.wrap(fleet.FleetWriter, "heartbeat", "heartbeat")
        self.wrap(requests, "components_ms", "records")

    def restore(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


def _parsed_run_dir(run_dir) -> dict:
    """Every file of a serve run dir parsed (JSON, or JSON lines): name
    -> lines; raises on a line that does not parse."""
    out = {}
    for path in sorted(Path(run_dir).iterdir()):
        text = path.read_text()
        if path.suffix == ".json":
            json.loads(text)
            out[path.name] = 1
        else:
            out[path.name] = len([json.loads(ln)
                                  for ln in text.splitlines() if ln])
    return out


def slice12_serve(torch, smi, model) -> dict:
    """Phase 20 (a) and (c) over phase 4's model; returns their
    launches."""
    import dataclasses
    import shutil

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.obs import metrics as obs_metrics
    from tpu_hc_bench_torch.serve import cli, slo
    from tpu_hc_bench_torch.serve.engine import VirtualClock

    root = Path(__file__).resolve().parent
    base = root / "build" / "slice12"
    shutil.rmtree(base, ignore_errors=True)
    run_dir = str(base / "a")
    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    cfg = flags.parse_flags([*PHASE4_FLAGS, f"--metrics_dir={run_dir}",
                             "--flight_recorder=on", "--hbm_budget=auto"])
    engine, requests = cli.build_engine_and_requests(cfg, tee, model=model)
    layers = model.num_layers
    runs, total = {}, {}
    for arm in ("off", "on"):
        engine.cfg = dataclasses.replace(cfg, flight_recorder=arm)
        timer = ObsTimer()
        timer.wrap_engine_calls()
        tap = TokenTap()
        writer = tap if arm == "off" else cli.serve_writer(cfg, run_dir)
        if arm == "on":
            timer.wrap(writer, "event", "writer")
        _zero_counts()
        t0 = time.perf_counter()
        try:
            if arm == "off":
                summary = engine.run(requests, writer=tap,
                                     clock=VirtualClock(SERVE2_VCOSTS))
            else:
                summary = cli.run_serve(engine, requests, writer,
                                        clock=VirtualClock(SERVE2_VCOSTS))
            torch.cuda.synchronize()
        finally:
            timer.restore()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        runs[arm] = (summary, counts, wall, timer.seconds, tap.tokens)
    (s_off, c_off, w_off, obs_off, tok_off), (s_on, c_on, w_on, obs_on,
                                               _) = runs["off"], runs["on"]
    _, records = obs_metrics.read_run(run_dir)
    tok_on = {r["id"]: r["generated"] for r in records
              if r["kind"] == "request"}
    steps = s_on["decode_steps"]
    want = {"paged_decode_attention": layers * steps,
            "fused_residual_norm": (2 * layers - 1) * steps}
    files = _parsed_run_dir(run_dir)
    (final,) = [{k: v for k, v in r.items() if k != "kind"}
                for r in records if r["kind"] == "serve_summary"]
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.obs", "summarize",
         run_dir], cwd=root, capture_output=True, text=True, timeout=300)
    serve_lines = slo.slo_lines(slo.fold_serve_records(records))
    budget = engine.compile_record.get("hbm_budget") or {}
    card_bytes = torch.cuda.mem_get_info()[1]
    hbm_lines = [ln for ln in lines if "hbm budget" in ln]
    rec = {"phase": "slice12", "part": "a_obs_off_on",
           "tokens_equal": tok_on == tok_off, "launches": c_on,
           "launches_off": c_off, "expected": want,
           "decode_steps": [s_off["decode_steps"], steps],
           "wall_s_real": [w_off, w_on],
           "tokens_per_s_real": [s_off["tokens"] / w_off,
                                 s_on["tokens"] / w_on],
           "obs_host_s": {"off": obs_off, "on": obs_on},
           "obs_host_ms_per_decode_step": {
               "off": 1e3 * sum(obs_off.values()) / max(1, steps),
               "on": 1e3 * sum(obs_on.values()) / max(1, steps)},
           "files": files, "summarize_rc": proc.returncode,
           "summary_equal": final == json.loads(json.dumps(s_on)),
           "hbm_lines": hbm_lines, "hbm_budget_bytes":
               budget.get("budget_bytes"), "card_bytes": card_bytes,
           "measured": budget.get("measured"),
           "decode_peak_bytes": s_on["decode_peak_bytes"],
           "signals_fired": s_on["signals_fired"],
           "kernel_library": engine.compile_record["kernel_library"],
           "nvidia_smi": smi,
           **{k: s_on[k] for k in SERVE2_KEYS}}
    emit(rec)
    missing = [ln for ln in serve_lines if ln not in proc.stdout]
    if not (rec["tokens_equal"] and c_on == c_off == {
                **dict.fromkeys(c_on, 0), **want}
            and s_off["decode_steps"] == steps > 0
            and s_on["completed"] == 16 and rec["summary_equal"]
            and {"manifest.json", "metrics.jsonl", "metrics.0.jsonl",
                 "spans.0.jsonl"} <= set(files)
            and ("signals.jsonl" in files) == bool(s_on["signals_fired"])
            and proc.returncode == 0 and not missing
            and budget.get("budget_bytes") == card_bytes
            and (budget.get("measured") or {}).get("total_bytes", 0) > 0
            and len(hbm_lines) == 1
            and hbm_lines[0].startswith("hbm budget: measured peak")):
        raise AssertionError(f"phase 20 (a) failed: {rec}, summarize "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}, "
                             f"missing {missing}")

    # (c) a SIGTERM drain into the metrics dir
    drain_dir = str(base / "c")
    engine.cfg = dataclasses.replace(
        cfg, metrics_dir=drain_dir,
        serve_faults=f"sigterm@{SLICE12_SIGTERM_S}")
    writer = cli.serve_writer(engine.cfg, drain_dir)
    _zero_counts()
    summary = cli.run_serve(engine, requests, writer,
                            clock=VirtualClock(SERVE2_VCOSTS))
    torch.cuda.synchronize()
    counts = _read_counts()
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    files = _parsed_run_dir(drain_dir)
    journal = str(Path(drain_dir) / "serve_journal.json")
    steps = summary["decode_steps"]
    rec = {"phase": "slice12", "part": "c_sigterm_drain",
           "drained": summary.get("drained"), "completed":
               summary["completed"], "decode_steps": steps,
           "files": files, "writer_closed": not writer.enabled,
           "launches": counts, "nvidia_smi": smi}
    emit(rec)
    engine.cfg = cfg
    drained = summary.get("drained") or {}
    if not (drained.get("journal") == journal
            and summary["completed"] + drained.get("unfinished", 0) == 16
            and drained.get("unfinished", 0) > 0
            and {"serve_journal.json", "timeline_dump.json",
                 "metrics.jsonl", "spans.0.jsonl"} <= set(files)
            and rec["writer_closed"]
            and counts["paged_decode_attention"] == layers * steps
            and counts["fused_residual_norm"] == (2 * layers - 1) * steps):
        raise AssertionError(f"phase 20 (c) failed: {rec}")
    del engine
    torch.cuda.empty_cache()
    return total


def slice12_classify(torch, smi) -> dict:
    """Phase 20 (b): resnet50 classify requests with ``--metrics_dir``;
    returns the launches (all 0)."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.obs import metrics as obs_metrics
    from tpu_hc_bench_torch.obs import timeline
    from tpu_hc_bench_torch.serve import cli

    run_dir = str(Path(__file__).resolve().parent / "build" / "slice12"
                  / "b")
    cfg = flags.parse_flags(["--model=resnet50", *SLICE11_SERVE_TRACE,
                             f"--metrics_dir={run_dir}"])
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        engine, requests = cli.build_engine_and_requests(
            cfg, lambda m: print(m, file=sys.stderr, flush=True))
        writer = cli.serve_writer(cfg, run_dir)
        _zero_counts()
        summary = cli.run_serve(engine, requests, writer)
        torch.cuda.synchronize()
        counts = _read_counts()
    finally:
        torch.backends.cudnn.benchmark = bench
    files = _parsed_run_dir(run_dir)
    _, records = obs_metrics.read_run(run_dir)
    spans = [s["name"] for s in timeline.read_spans(run_dir)[0]]
    rec = {"phase": "slice12", "part": "b_classify_resnet50",
           "files": files, "launches": counts,
           "request_records": sum(r["kind"] == "request" for r in records),
           "classify_spans": spans.count("classify"),
           "classify_steps": summary["classify_steps"],
           "p99_e2e_ms": summary["p99_e2e_ms"],
           "completed": summary["completed"], "nvidia_smi": smi}
    emit(rec)
    del engine
    torch.cuda.empty_cache()
    if not (summary["completed"] == rec["request_records"] == 32
            and rec["classify_spans"] == summary["classify_steps"] > 0
            and not any(counts.values())
            and {"manifest.json", "metrics.jsonl", "metrics.0.jsonl",
                 "spans.0.jsonl"} <= set(files)):
        raise AssertionError(f"phase 20 (b) failed: {rec}")
    return counts


def slice12_accum(torch, smi) -> dict:
    """Phase 20 (d): gpt2_moe under ``--accum_dtype=bf16`` at phase 17
    (d)'s settings, every count zeroed just before and read just after.
    Each optimizer step is measured where it runs: the allocation
    before and after it and its peak, so the run's peak is the largest
    of the peaks read before each reset; returns the launches."""
    from tpu_hc_bench_torch.train import step as step_mod

    seen: list[dict] = []
    peaks: list[int] = []
    apply = step_mod.apply_bf16_grads

    def measured(opt, params, grads):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        f32_bytes = 4 * sum(p.numel() for p in params)
        apply(opt, params, grads)
        torch.cuda.synchronize()
        seen.append({"before": before, "after": torch.cuda.memory_allocated(),
                     "peak": torch.cuda.max_memory_allocated(),
                     "f32_param_bytes": f32_bytes})

    argv = _slice9_argv("ib", SLICE9_MOE_BATCH, "gpt2_moe",
                        SLICE12_ACCUM_STEPS,
                        f"--gradient_accumulation_steps={SLICE9_ACCUM}",
                        "--accum_dtype=bf16")
    expect = _slice9_expect(12, SLICE9_ACCUM * sum(SLICE12_ACCUM_STEPS),
                            False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_mod.apply_bf16_grads = measured
    _zero_counts()
    try:
        rc, res = _launch(argv)
    finally:
        step_mod.apply_bf16_grads = apply
    counts = _read_counts()
    peaks.append(torch.cuda.max_memory_allocated())
    # what a step holds beyond the allocation it starts and ends with:
    # the first step also creates the float32 momentum trace, which it
    # keeps (in ``after``), so it is not counted against the step
    added = max(s["peak"] - max(s["before"], s["after"]) for s in seen)
    f32_bytes = seen[0]["f32_param_bytes"] if seen else 0
    rec = {"phase": "slice12", "part": "d_accum_bf16", "argv": argv,
           "rc": rc, "launches": counts, "expected_launches": expect,
           "optimizer_steps": len(seen),
           "steps_gb": [{k: v / 1e9 for k, v in st.items()} for st in seen],
           "run_peak_gb": max(peaks) / 1e9,
           "step_added_gb": added / 1e9,
           "f32_gradient_tree_gb": f32_bytes / 1e9,
           "step_share_limit": SLICE12_STEP_SHARE,
           "final_loss": res.get("final_loss"),
           "sequences_per_sec": res.get("total_images_per_sec"),
           "extra": res.get("extra"), "nvidia_smi": smi}
    emit(rec)
    if not (rc == 0 and len(seen) == sum(SLICE12_ACCUM_STEPS)
            and all(counts[k] == expect.get(k, 0) for k in counts)
            and added < SLICE12_STEP_SHARE * f32_bytes
            and math.isfinite(res["final_loss"])):
        raise AssertionError(f"phase 20 (d) failed: {rec}")
    return counts


def phase_slice12_rest(torch, smi, total: dict) -> dict:
    """Phase 20 (b) and (d), after phase 4's model is gone; ``total``
    holds (a) and (c)'s launches (``slice12_serve``), and the sum over
    (a)-(d) is returned."""
    for counts in (slice12_classify(torch, smi), slice12_accum(torch, smi)):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    emit({"phase": "slice12", "part": "e_launches", "launches": total,
          "nvidia_smi": smi})
    return total


# --- phase 21 (slice13): the training lane's guards and observability ------


def _nan_mask_check(torch, got, want, tol: float, exact=None) -> dict:
    """NaN in ``got`` where ``exact`` (a bool mask broadcast over the
    last dim; else where ``want`` has it), ``want``'s NaN a superset of
    it (cuDNN's transform algorithms spread a NaN over a whole tile),
    and the values finite in both within ``tol`` of ``want``'s largest
    finite magnitude."""
    g, w = got.float(), want.float()
    mask = torch.isnan(w) if exact is None else exact.expand_as(g)
    same = bool(torch.equal(torch.isnan(g), mask))
    within = bool((torch.isnan(w) | ~mask).all())
    fin = torch.isfinite(w) & torch.isfinite(g)
    scale = float(w[fin].abs().max()) if bool(fin.any()) else 1.0
    err = (float((g[fin] - w[fin]).abs().max()) if bool(fin.any())
           else 0.0) / max(scale, 1e-30)
    return {"nan_same": same, "plain_nan_covers": within,
            "nan_count": int(mask.sum()),
            "plain_nan_count": int(torch.isnan(w).sum()), "rel_err": err,
            "ok": same and within and err <= tol}


def _conv_nan_pixels(torch, y1, a, b):
    """``[N, H, W, 1]``: the output pixels of a 3x3 SAME conv whose
    window holds a NaN of ``relu(y1 * a + b)`` (every output channel of
    such a pixel is NaN, exactly)."""
    import torch.nn.functional as F

    bad = torch.isnan(y1.float() * a + b).any(-1).float()[:, None]
    return (F.max_pool2d(bad, 3, stride=1, padding=1) > 0)[:, 0, :, :,
                                                           None]


def slice13_nan(torch, dev, smi) -> None:
    """Phase 21 (0): row 7 with NaN entries in ``y1`` at its two bf16
    shapes and in f32: NaN in y2 exactly at the pixels whose 3x3 window
    holds one (every channel), in every channel of s1 and s2, where the
    plain version has NaN too (cuDNN's transform algorithms spread a
    NaN over their whole tile, so its NaN may reach further), and the
    values finite in both to phase 5's tolerance; then NaN through the
    online softmax of the flash forward (both designs) and the xent
    forward."""
    from tpu_hc_bench_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from tpu_hc_bench_torch.ops.fused_conv import (
        fused_bn_relu_conv, fused_bn_relu_conv_plain)
    from tpu_hc_bench_torch.ops.xent import softmax_xent, softmax_xent_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    cases = [((128, 28, 128, 128), "bfloat16"),
             ((128, 14, 256, 256), "bfloat16"),
             ((128, 28, 128, 128), "float32")]
    for (n, h, cin, cout), dname in cases:
        dtype = getattr(torch, dname)
        y1 = torch.randn((n, h, h, cin), generator=gen, device=dev)
        y1[0, 3, 4, 5] = float("nan")
        y1[n - 1, h - 1, 0, cin - 1] = float("nan")
        y1 = y1.to(dtype)
        a = 0.5 + torch.rand((cin,), generator=gen, device=dev)
        b = 0.2 * torch.randn((cin,), generator=gen, device=dev)
        w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
             * (2.0 / (9 * cin)) ** 0.5).to(dtype)
        got = fused_bn_relu_conv(y1, a, b, w)
        want = fused_bn_relu_conv_plain(y1, a, b, w)
        exact = _conv_nan_pixels(torch, y1, a, b)
        torch.cuda.synchronize()
        outs = {name: _nan_mask_check(torch, g, wt, tol, ex)
                for name, g, wt, tol, ex in zip(
                    ("y2", "s1", "s2"), got, want,
                    (CONV_Y_TOL[dname], CONV_STATS_TOL, CONV_STATS_TOL),
                    (exact, exact.any().reshape(1), exact.any().reshape(1)))}
        rec = {"phase": "slice13", "part": "0_conv_nan", "shape":
               [n, h, h, cin, cout], "dtype": dname, **outs,
               "nvidia_smi": smi,
               "ok": all(o["ok"] for o in outs.values())
               and outs["y2"]["nan_count"] > 0}
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"phase 21 (0): the fused conv drops NaN: "
                                 f"{rec}")
    for b_, s_, h_, d_, dname in ((4, 256, 8, 64, "bfloat16"),
                                  (2, 128, 4, 256, "float32")):
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((b_, s_, h_, d_), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        q[1, 7, 2, 3] = float("nan")
        got = flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        chk = _nan_mask_check(torch, got, want, FLASH_TOL[dname])
        emit({"phase": "slice13", "part": "0_flash_nan", "shape":
              [b_, s_, h_, d_], "dtype": dname, **chk, "nvidia_smi": smi})
        if not (chk["ok"] and chk["nan_count"] > 0):
            raise AssertionError(f"phase 21 (0): flash drops NaN: {chk}")
    logits = torch.randn((512, 50257), generator=gen, device=dev)
    logits[5, 100] = float("nan")
    labels = torch.randint(0, 50257, (512,), generator=gen, device=dev)
    chk = _nan_mask_check(torch, softmax_xent(logits, labels),
                          softmax_xent_plain(logits, labels),
                          XENT_TOL["float32"])
    emit({"phase": "slice13", "part": "0_xent_nan", **chk,
          "nvidia_smi": smi})
    if not (chk["ok"] and chk["nan_count"] == 1):
        raise AssertionError(f"phase 21 (0): xent drops NaN: {chk}")


class _LossSpy:
    """Every train step's loss (a device copy, no sync) while
    installed; the steps' time stays the driver's."""

    def __init__(self):
        from tpu_hc_bench_torch.train import step as step_mod

        self.mod, self.real, self.losses = step_mod, step_mod.train_step, []

        def spy(state, batch):
            state, m = self.real(state, batch)
            self.losses.append(m["loss"].detach().clone())
            return state, m

        step_mod.train_step = spy

    def restore(self) -> list[float]:
        self.mod.train_step = self.real
        return [float(x) for x in self.losses]


def _slice13_run(torch, argv: list[str], expect_rc: int = 0):
    """``launcher.main(argv)`` with every count zeroed just before and
    read just after: ``(rc, lines, counts, seconds, losses)``; raises
    unless it exits ``expect_rc``."""
    from tpu_hc_bench_torch import launcher

    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    spy = _LossSpy()
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        rc = launcher.main(argv, print_fn=tee)
    finally:
        losses = spy.restore()
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    if rc != expect_rc:
        raise AssertionError(f"phase 21: {argv} exited {rc}, not "
                             f"{expect_rc}: {lines[-5:]}")
    return rc, lines, counts, seconds, losses


def _result(lines: list[str]) -> dict:
    return json.loads(next(ln for ln in reversed(lines)
                           if ln.startswith("{")))


def _fp_line(lines: list[str]) -> str | None:
    return next((ln.split(": ", 1)[1] for ln in lines
                 if ln.startswith("state fingerprint:")), None)


def _resnet_argv(batch: int, warm: int, steps: int, *extra: str) -> list:
    return ["1", "1", str(batch), "sock", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true",
            f"--num_warmup_batches={warm}", f"--num_batches={steps}",
            *extra]


def _osu_sweep(torch, path: str) -> None:
    """A one-card all-reduce sweep export (JAX's schema) at ``path``."""
    import torch.distributed as dist

    from tpu_hc_bench_torch.microbench import osu
    from tpu_hc_bench_torch.parallel import distributed

    distributed.init_single("nccl")
    try:
        rows = osu.run_sweep("allreduce", max_bytes=1 << 20)
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(osu.sweep_json({"allreduce": rows},
                                 torch.cuda.get_device_name(0)), f)


def slice13_obs(torch, smi, base: Path, add) -> None:
    """Phase 21 (a) and (g)'s one-card line: resnet50 bf16 fused at batch
    128, obs off, then on (--metrics_dir, --flight_recorder=on,
    --trace_dir, --profile_steps, --hbm_budget=auto, --fabric_ceiling);
    bit-equal losses and equal row-7 launches, the obs host time a
    step, the trace's buckets and top device ops, MFU measured against
    analytic, the budget line, ``obs summarize``."""
    from tpu_hc_bench_torch.obs import (fleet, goodput, memory, metrics,
                                        timeline, trace)

    run_dir, trace_dir = base / "a_metrics", base / "a_trace"
    sweep = str(base / "sweep.json")
    _osu_sweep(torch, sweep)
    warm, steps = SLICE13_OBS_STEPS
    runs = {}
    for arm in ("off", "on"):
        extra = ["--display_every=5"]
        timer = ObsTimer()
        if arm == "on":
            extra += [f"--metrics_dir={run_dir}", "--flight_recorder=on",
                      f"--trace_dir={trace_dir}",
                      f"--profile_steps={SLICE13_PROFILE}",
                      "--hbm_budget=auto", f"--fabric_ceiling={sweep}"]
            timer.wrap(metrics.MetricsWriter, "event", "writer")
            timer.wrap(fleet.FleetWriter, "heartbeat", "heartbeat")
            timer.wrap(memory.MemoryLedger, "sample", "memory")
            timer.wrap(goodput.PhaseTracker, "enter", "phases")
            timer.wrap(goodput.PhaseTracker, "flush", "phases")
            timer.wrap(timeline, "record_span", "spans")
            timer.wrap(timeline, "flush", "spans")
        else:
            extra += ["--flight_recorder=off"]
        try:
            runs[arm] = _slice13_run(
                torch, _resnet_argv(TRAIN_BATCH, warm, steps, *extra))
        finally:
            timer.restore()
        runs[arm] = (*runs[arm], dict(timer.seconds))
        add(runs[arm][2])
    (_, off_lines, off_counts, off_s, off_losses, _) = runs["off"]
    (_, on_lines, on_counts, on_s, on_losses, obs_s) = runs["on"]
    res_off, res_on = _result(off_lines), _result(on_lines)
    summary = [json.loads(ln) for ln in
               (run_dir / "metrics.jsonl").read_text().splitlines()
               if '"kind": "summary"' in ln][-1]
    tsum = trace.summarize_trace_dir(str(trace_dir))
    ops, counts = trace.device_op_times(str(trace_dir))
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    conv_ops = {k: v for k, v in ops.items() if "fused_conv" in k
                or "fused_bn_relu_conv" in k}
    summ = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.obs", "summarize",
         str(run_dir), "--fabric_ceiling", sweep],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=120)
    timed = warm + steps
    rec = {"phase": "slice13", "part": "a_obs_off_on", "model": "resnet50",
           "batch": TRAIN_BATCH, "warmup": warm, "steps": steps,
           "losses_bit_equal": off_losses == on_losses,
           "losses": on_losses, "launches_off": off_counts,
           "launches_on": on_counts,
           "conv_launches_equal": (off_counts["fused_bn_relu_conv"]
                                   == on_counts["fused_bn_relu_conv"]
                                   == FUSED_LAUNCHES_PER_STEP * timed),
           "step_ms_off": res_off["mean_step_ms"],
           "step_ms_on": res_on["mean_step_ms"],
           "obs_host_s": obs_s,
           "obs_host_ms_per_step": 1e3 * sum(obs_s.values()) / timed,
           "trace_buckets_us": tsum.totals, "trace_steps": len(tsum.steps),
           "trace_step_source": tsum.step_source,
           "top_device_ops_us": [[k[:80], v] for k, v in top],
           "fused_conv_ops_us": {k[:80]: v for k, v in conv_ops.items()},
           "collective_ops_us": {k[:120]: v for k, v in ops.items()
                                 if trace.bucket_of(k) == "collective"},
           "mfu": summary.get("mfu"), "mfu_source": summary.get("mfu_source"),
           "mfu_measured": summary.get("mfu_measured"),
           "mfu_analytic": summary.get("mfu_analytic"),
           "aten_flops_per_step": summary.get("aten_flops_per_step"),
           "kernel_flops_per_step": summary.get("kernel_flops_per_step"),
           "analytic_flops_per_step": summary.get("analytic_flops_per_step"),
           "flops_disagreement": summary.get("flops_disagreement"),
           "goodput": res_on["goodput"],
           "goodput_phases": res_on["goodput_phases"],
           "peak_hbm_bytes": res_on["peak_hbm_bytes"],
           "budget_lines": [ln for ln in on_lines if ln.startswith(
               ("hbm budget", "WARNING: --hbm_budget"))],
           "ceiling_lines": [ln for ln in on_lines
                             if ln.startswith(("fabric ceiling", "fabric:"))],
           "summarize_rc": summ.returncode,
           "summarize": summ.stdout.splitlines()[-40:],
           "nvidia_smi": smi, "t_off_s": off_s, "t_on_s": on_s}
    text = summ.stdout
    rec["ok"] = (rec["losses_bit_equal"] and rec["conv_launches_equal"]
                 and len(on_losses) == timed and summ.returncode == 0
                 and "goodput:" in text and "flops source:" in text
                 and "memory: peak" in text and bool(conv_ops)
                 and sum(tsum.totals.values()) > 0
                 and rec["mfu_measured"] is not None
                 and bool(rec["budget_lines"])
                 and bool(rec["ceiling_lines"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (a) failed: {rec}")


def slice13_vit_skip(torch, dev, smi, add) -> None:
    """Phase 21 (b), vit_b16 on the flash kernels at the step: a skip
    run of eight steps poisoned at step 5 ends bit-equal to seven clean
    steps whose dropout generator skipped step 5's draws (a forward
    pass in training mode: a skipped step consumes its draws, as JAX's
    folds its key by the loop index); the guard on and off step times
    over steps 3-8; then under ``flag`` (rewind's detection) the step
    is counted and applied."""
    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.data.synthetic import SyntheticImages, to_device
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    batch_n, steps, bad = SLICE13_VIT
    finals, times = {}, {}
    _zero_counts()
    for arm in ("skip", "clean", "off"):
        model, spec = create_model("vit_b16", torch.bfloat16, "flash",
                                   device=dev, seed=0, train=True)
        cfg = flags.BenchmarkConfig(
            model="vit_b16", batch_size=batch_n, use_fp16=True,
            attention_impl="flash",
            on_nonfinite="abort" if arm == "off" else "skip").resolve()
        state = step_mod.make_train_state(model, cfg)
        batch = to_device(SyntheticImages(batch_n, spec.input_shape,
                                          spec.num_classes, 0).batch(), dev)
        nonfinite = []
        t0 = None
        for i in range(1, steps + 1):
            if i == 3:      # steps 1-2 make the state and its held copy
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i == bad and arm == "skip":
                state, m = step_mod.train_step(
                    state, (batch[0] * float("nan"), batch[1]))
            elif i == bad and arm == "clean":
                step_mod.forward_step(state, batch)
                continue
            else:
                state, m = step_mod.train_step(state, batch)
            if "nonfinite" in m:
                nonfinite.append(m["nonfinite"])
        torch.cuda.synchronize()
        times[arm] = 1e3 * (time.perf_counter() - t0) / (steps - 2)
        finals[arm] = ckpt.fingerprint(state.model.state_dict())
        if arm == "skip":
            skipped = int(torch.stack(nonfinite).sum())
        del model, state
        torch.cuda.empty_cache()
    counts = _read_counts()
    add(counts)
    model, spec = create_model("vit_b16", torch.bfloat16, "flash",
                               device=dev, seed=0, train=True)
    cfg = flags.BenchmarkConfig(model="vit_b16", batch_size=batch_n,
                                use_fp16=True, attention_impl="flash",
                                on_nonfinite="rewind",
                                train_dir="unused").resolve()
    state = step_mod.make_train_state(model, cfg)
    state, m = step_mod.train_step(state, (batch[0] * float("nan"),
                                           batch[1]))
    flagged = int(m["nonfinite"])
    applied = any(bool(torch.isnan(p).any()) for p in model.parameters())
    del model, state
    torch.cuda.empty_cache()
    rec = {"phase": "slice13", "part": "b_vit_b16_skip", "batch": batch_n,
           "steps": steps, "poisoned_step": bad, "skipped": skipped,
           "bit_equal_to_shorter_run": finals["skip"] == finals["clean"],
           "fingerprints": finals,
           "step_ms_guard_on": times["skip"], "step_ms_guard_off":
               times["off"], "flag_counted": flagged,
           "flag_applied": applied, "launches": counts, "nvidia_smi": smi}
    rec["ok"] = (rec["bit_equal_to_shorter_run"] and skipped == 1
                 and flagged == 1 and applied
                 and counts["flash_attention_fwd"] > 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (b) vit_b16 failed: {rec}")


def slice13_guards(torch, smi, base: Path, add) -> None:
    """Phase 21 (b) resnet50, (c) and (d), cuDNN deterministic so runs
    compare bit for bit: skip ends on the fault-free run one step
    shorter (guard on against off), abort stops with JAX's message,
    rewind restores, replays and completes with goodput below 1 and a
    run poisoned on every step ends on --max_bad_steps, sigterm exits
    75 with an emergency checkpoint and --resume=auto ends on the
    uninterrupted run's fingerprint."""
    from tpu_hc_bench_torch.resilience import guards

    warm, steps, bad = SLICE13_SKIP
    _, skip_lines, c1, _, skip_losses = _slice13_run(torch, _resnet_argv(
        TRAIN_BATCH, warm, steps, "--display_every=1",
        f"--train_dir={base / 'b_skip'}", f"--inject_fault=nan_loss@{bad}",
        "--on_nonfinite=skip"))
    _, clean_lines, c2, _, clean_losses = _slice13_run(torch, _resnet_argv(
        TRAIN_BATCH, warm, steps - 1, "--display_every=1",
        f"--train_dir={base / 'b_clean'}"))
    add(c1)
    add(c2)
    skip_res, clean_res = _result(skip_lines), _result(clean_lines)
    try:
        _slice13_run(torch, _resnet_argv(
            SLICE13_SMALL_BATCH, 1, 3, "--display_every=1",
            "--inject_fault=nan_loss@2"))
        abort_msg = None
    except guards.NonFiniteError as e:
        abort_msg = str(e)
    add(_read_counts())
    rec = {"phase": "slice13", "part": "b_resnet50_skip",
           "batch": TRAIN_BATCH, "steps": steps, "poisoned_step": bad,
           "fingerprint_skip": skip_res["checkpoint"]["fingerprint"],
           "fingerprint_shorter": clean_res["checkpoint"]["fingerprint"],
           "bit_equal_to_shorter_run": skip_res["checkpoint"]["fingerprint"]
           == clean_res["checkpoint"]["fingerprint"],
           "skip_line": [ln for ln in skip_lines if "nonfinite:" in ln],
           "step_ms_guard_on": skip_res["mean_step_ms"],
           "step_ms_guard_off": clean_res["mean_step_ms"],
           "abort_message": abort_msg, "launches": {"skip": c1,
                                                    "clean": c2},
           "nvidia_smi": smi}
    rec["ok"] = (rec["bit_equal_to_shorter_run"] and bool(rec["skip_line"])
                 and abort_msg is not None and abort_msg.startswith(
                     "non-finite loss at display step(s) [2, 3]")
                 and c1["fused_bn_relu_conv"] == FUSED_LAUNCHES_PER_STEP
                 * (warm + steps))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (b) resnet50 failed: {rec}")
    # (c) rewind, then the budget
    steps_c = SLICE13_REWIND
    _, rw_lines, c3, _, _ = _slice13_run(torch, _resnet_argv(
        SLICE13_SMALL_BATCH, 1, steps_c, "--display_every=2",
        f"--train_dir={base / 'c_rewind'}", "--save_model_steps=2",
        "--on_nonfinite=rewind", "--inject_fault=nan_loss@3",
        f"--metrics_dir={base / 'c_metrics'}"))
    add(c3)
    summ = subprocess.run(
        [sys.executable, "-m", "tpu_hc_bench_torch.obs", "summarize",
         str(base / "c_metrics")], cwd=str(Path(__file__).resolve().parent),
        capture_output=True, text=True, timeout=120)
    rw_res = _result(rw_lines)
    spec = ",".join(f"nan_loss@{i}" for i in range(1, 9))
    try:
        _slice13_run(torch, _resnet_argv(
            SLICE13_SMALL_BATCH, 1, 8, "--display_every=2",
            f"--train_dir={base / 'c_budget'}", "--on_nonfinite=rewind",
            "--max_bad_steps=2", f"--inject_fault={spec}"))
        budget_msg = None
    except guards.GuardBudgetError as e:
        budget_msg = str(e)
    add(_read_counts())
    goodput_lines = [ln for ln in summ.stdout.splitlines()
                     if "goodput:" in ln or "rewind" in ln]
    rec = {"phase": "slice13", "part": "c_rewind",
           "batch": SLICE13_SMALL_BATCH, "steps": steps_c,
           "rewind_lines": [ln for ln in rw_lines if ln.startswith("rewind")],
           "final_loss": rw_res["final_loss"], "goodput": rw_res["goodput"],
           "goodput_phases": rw_res["goodput_phases"],
           "summarize_rc": summ.returncode, "summarize_goodput":
               goodput_lines, "budget_message": budget_msg,
           "nvidia_smi": smi}
    rec["ok"] = (bool(rec["rewind_lines"])
                 and math.isfinite(rw_res["final_loss"])
                 and rw_res["goodput"] < 1.0 and summ.returncode == 0
                 and any(ln.strip().startswith("goodput:")
                         for ln in goodput_lines)
                 and budget_msg is not None
                 and "consecutive rewinds without a clean window" in
                 budget_msg)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (c) failed: {rec}")
    # (d) preemption and resume
    k, at = SLICE13_SIGTERM
    split = base / "d_split"
    _, pre_lines, c4, _, _ = _slice13_run(torch, _resnet_argv(
        SLICE13_SMALL_BATCH, 0, k, "--display_every=1",
        f"--train_dir={split}", f"--inject_fault=sigterm@{at}"),
        expect_rc=75)
    _, res_lines, c5, _, _ = _slice13_run(torch, _resnet_argv(
        SLICE13_SMALL_BATCH, 0, k - at, "--display_every=1",
        f"--train_dir={split}", "--resume=auto"))
    _, whole_lines, c6, _, _ = _slice13_run(torch, _resnet_argv(
        SLICE13_SMALL_BATCH, 0, k, "--display_every=1",
        f"--train_dir={base / 'd_whole'}"))
    for c in (c4, c5, c6):
        add(c)
    resumed, whole = _result(res_lines), _result(whole_lines)
    rec = {"phase": "slice13", "part": "d_sigterm_resume",
           "batch": SLICE13_SMALL_BATCH, "steps": k, "sigterm_at": at,
           "rc": 75, "emergency_fingerprint": _fp_line(pre_lines),
           "restored_fingerprint": _fp_line(res_lines),
           "resumed_final": resumed["checkpoint"]["fingerprint"],
           "uninterrupted_final": whole["checkpoint"]["fingerprint"],
           "preempt_line": [ln for ln in pre_lines
                            if ln.startswith("preempted after")],
           "nvidia_smi": smi}
    rec["ok"] = (rec["emergency_fingerprint"] is not None
                 and rec["emergency_fingerprint"]
                 == rec["restored_fingerprint"]
                 and rec["resumed_final"] == rec["uninterrupted_final"]
                 and bool(rec["preempt_line"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (d) failed: {rec}")


def slice13_processes(smi) -> None:
    """Phase 21 (e) and (f), each in a process of its own, side by side:
    a hang ends with exit 70 and the thread dump within the timeout's
    bound (the ``trivial`` model: the watchdog watches the step clock
    whatever the model, and a process of resnet50 spends ~30 s before
    its first timed step), and ``python -m
    tpu_hc_bench_torch.utils.sanity`` exits 0."""
    import re

    root = str(Path(__file__).resolve().parent)
    san = subprocess.Popen([sys.executable, "-m",
                            "tpu_hc_bench_torch.utils.sanity"], cwd=root,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    timeout_s, hang_s = SLICE13_HANG
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "tpu_hc_bench_torch", "1", "1", "32",
             "sock", "--model=trivial", "--num_warmup_batches=1",
             "--num_batches=4", "--display_every=1",
             f"--inject_fault=hang@2:{hang_s}",
             f"--step_timeout_s={timeout_s}"],
            cwd=root, capture_output=True, text=True, timeout=hang_s + 120)
        wall = time.perf_counter() - t0
        san_out, _ = san.communicate(timeout=300)
    finally:
        if san.poll() is None:
            san.kill()
            san.wait()
    fired = re.search(r"no step completed in ([0-9.]+)s", run.stderr)
    age = float(fired.group(1)) if fired else None
    rec = {"phase": "slice13", "part": "e_hang", "rc": run.returncode,
           "timeout_s": timeout_s, "fired_after_s": age,
           "process_wall_s": wall,
           "thread_dump": "Current thread" in run.stderr
           or "Thread 0x" in run.stderr, "nvidia_smi": smi}
    # the monitor polls every timeout/4: it fires within that of the bound
    rec["ok"] = (run.returncode == 70 and rec["thread_dump"]
                 and age is not None
                 and timeout_s <= age <= 1.25 * timeout_s + 1.0
                 and wall < hang_s)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (e) failed: {rec}, "
                             f"{run.stderr[-2000:]}")
    rec = {"phase": "slice13", "part": "f_sanity", "rc": san.returncode,
           "report": san_out.splitlines()[-12:], "nvidia_smi": smi,
           "ok": san.returncode == 0}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 21 (f) failed: {rec}")


def phase_slice13(torch, dev, smi) -> dict:
    """Phase 21: the training lane's guards and observability; returns
    every kernel's launches summed over the main-path runs (a)-(d)."""
    import shutil

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    base = Path(__file__).resolve().parent / "build" / "slice13"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    slice13_nan(torch, dev, smi)
    det = torch.backends.cudnn.deterministic
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        slice13_obs(torch, smi, base, add)
        slice13_guards(torch, smi, base, add)
        slice13_vit_skip(torch, dev, smi, add)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    torch.cuda.empty_cache()
    slice13_processes(smi)
    emit({"phase": "slice13", "part": "g_launches", "launches": total,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return total


def _ring_fold_gb(batch: int, heads: int, layers: int, shard: int,
                  sp: int) -> float:
    """What autograd keeps of the ring's folds (a float32 ``[b, h, s/n,
    s/n]`` probability tensor a fold, ``sp`` folds a layer), GB."""
    return 4 * batch * heads * shard * shard * sp * layers / 1e9


def _slice14_run(torch, part: str, argv: list[str], smi: str,
                 expect: dict | None):
    """``_slice9_run`` under phase 22's name, with every train step's
    loss: ``(result, counts, record, losses)``."""
    spy = _LossSpy()
    try:
        res, counts, rec = _slice9_run(torch, part, argv, smi, expect,
                                       phase="slice14")
    finally:
        losses = spy.restore()
    return res, counts, rec, losses


def slice14_degenerate(torch, smi, add) -> None:
    """Phase 22 (a): the degenerate seq axis on one card through the
    launcher on ``ib`` (a one-rank group): each member's ``ring`` against
    ``dense`` and ``ulysses_flash`` against ``flash`` from one seed,
    sequences/s of each, the flash and xent launches."""
    warm, timed = SLICE14_STEPS
    steps = warm + timed
    for model, batch, layers, extra in SLICE14_LM:
        fused = "--fused_xent=true" in extra
        runs = {}
        for impl in ("dense", "ring", "flash", "ulysses_flash"):
            flash = impl in ("flash", "ulysses_flash")
            expect = {**{FLASH_KERNELS[k][0]: layers * steps if flash else 0
                         for k in FLASH_KERNELS},
                      **{XENT_KERNELS[k][0]: steps if fused else 0
                         for k in XENT_KERNELS}}
            argv = ["1", "1", str(batch), "ib", f"--model={model}",
                    "--use_fp16=true", f"--attention_impl={impl}",
                    f"--num_warmup_batches={warm}",
                    f"--num_batches={timed}", "--display_every=10", *extra]
            res, counts, rec, losses = _slice14_run(
                torch, f"a_{model}_{impl}", argv, smi, expect)
            if (res["sequence_parallel"], res["attention_impl"]) != (1,
                                                                    impl):
                raise AssertionError(f"phase 22 (a): {rec}")
            add(counts)
            runs[impl] = (res, rec, losses)
        for arm, base in (("ring", "dense"), ("ulysses_flash", "flash")):
            (r_a, rec_a, l_a), (r_b, rec_b, l_b) = runs[arm], runs[base]
            first = abs(l_a[0] - l_b[0]) / abs(l_b[0])
            last = abs(l_a[-1] - l_b[-1]) / abs(l_b[-1])
            rec = {"phase": "slice14", "part": f"a_{model}_{arm}_vs_{base}",
                   "batch": batch, "steps": steps,
                   "first_loss": [l_a[0], l_b[0]],
                   "last_loss": [l_a[-1], l_b[-1]],
                   "first_loss_rel": first, "last_loss_rel": last,
                   "losses_bit_equal": l_a == l_b,
                   "sequences_per_sec": {arm: r_a["total_images_per_sec"],
                                         base: r_b["total_images_per_sec"]},
                   "rate_ratio": r_a["total_images_per_sec"]
                   / r_b["total_images_per_sec"],
                   "peak_mem_gb": {arm: rec_a["peak_mem_gb"],
                                   base: rec_b["peak_mem_gb"]},
                   "launches": {arm: rec_a["launches"],
                                base: rec_b["launches"]},
                   "nvidia_smi": smi}
            if arm == "ring":
                rec["tol"] = [SLICE14_RING_FIRST_TOL, SLICE14_RING_LAST_TOL]
                rec["ok"] = (first <= SLICE14_RING_FIRST_TOL
                             and last <= SLICE14_RING_LAST_TOL)
            else:
                rec["ok"] = (l_a == l_b and len(l_a) == steps
                             and r_a["final_loss"] == r_b["final_loss"])
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"phase 22 (a) failed: {rec}")


def slice14_zero1(torch, smi, base: Path, add) -> None:
    """Phase 22 (b): zero1 at world 1 on resnet50 (bf16, batch 128,
    ``--fused_conv=true``, a one-rank group on ``ib``) against psum,
    cuDNN deterministic: the losses and the final parameters'
    fingerprint bit-equal, images/s and the optimizer's bytes."""
    warm, timed = SLICE14_ZERO1_STEPS
    steps = warm + timed
    runs = {}
    for vu in ("psum", "zero1"):
        argv = ["1", "1", str(TRAIN_BATCH), "ib", "--model=resnet50",
                "--use_fp16=true", "--fused_conv=true",
                f"--variable_update={vu}", f"--num_warmup_batches={warm}",
                f"--num_batches={timed}", "--display_every=10",
                f"--train_dir={base / vu}"]
        res, counts, rec, losses = _slice14_run(
            torch, f"b_resnet50_{vu}", argv, smi,
            {"fused_bn_relu_conv": FUSED_LAUNCHES_PER_STEP * steps})
        add(counts)
        runs[vu] = (res, losses)
    (z, zl), (p, pl) = runs["zero1"], runs["psum"]
    rec = {"phase": "slice14", "part": "b_zero1_vs_psum",
           "images_per_sec": {"psum": p["total_images_per_sec"],
                              "zero1": z["total_images_per_sec"]},
           "optimizer_state_bytes": {"psum": p["optimizer_state_bytes"],
                                     "zero1": z["optimizer_state_bytes"]},
           "collectives_per_step": {"psum": p["allreduce_per_step"],
                                    "zero1": z["allreduce_per_step"]},
           "fingerprints": [z["checkpoint"]["fingerprint"],
                            p["checkpoint"]["fingerprint"]],
           "losses_bit_equal": zl == pl, "steps": len(zl),
           "nvidia_smi": smi}
    rec["ok"] = (zl == pl and len(zl) == steps
                 and rec["fingerprints"][0] == rec["fingerprints"][1]
                 and z["optimizer_state_bytes"]
                 == p["optimizer_state_bytes"] > 0)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 22 (b) failed: {rec}")


def slice14_multi(torch, smi, cards: int) -> None:
    """Phase 22 (c), with two cards or more: llama_1b at 2048 tokens a
    shard over sp 2 (and sp 4, dp 2 x sp 2 on four cards), ``ring`` and
    ``ulysses_flash`` (the ring with each layer recomputed where its
    saved folds would pass ``SLICE14_REMAT_GB``): peak memory (rank 0)
    and sequences/s; then resnet50 zero1 against psum over every card."""
    from tpu_hc_bench_torch import launcher

    if cards < 2:
        emit({"phase": "slice14", "part": "c_multi_card", "ran": False,
              "cards": cards, "nvidia_smi": smi})
        return

    def launch(argv: list[str]) -> tuple[int, dict]:
        lines: list[str] = []

        def tee(m: str) -> None:
            lines.append(m)
            print(m, file=sys.stderr, flush=True)

        rc = launcher.main(argv, print_fn=tee)
        if rc != 0 or not any(ln.startswith("{") for ln in lines):
            raise AssertionError(f"phase 22 (c): {argv} exited {rc}: "
                                 f"{lines[-5:]}")
        return rc, _result(lines)

    warm, timed = SLICE14_STEPS
    keys = ("total_workers", "global_batch", "total_images_per_sec",
            "mean_step_ms", "final_loss", "sequence_parallel",
            "attention_impl", "peak_hbm_bytes", "device_kind")
    for world, sp in SLICE14_MULTI:
        if world > cards:
            continue
        for impl in ("ring", "ulysses_flash"):
            folds = _ring_fold_gb(SLICE14_SHARD_BATCH, 32, 16,
                                  SLICE14_SHARD_TOKENS, sp)
            remat = impl == "ring" and folds > SLICE14_REMAT_GB
            argv = ["1", str(world), str(SLICE14_SHARD_BATCH), "ib",
                    "--model=llama_1b", "--use_fp16=true",
                    f"--sequence_parallel={sp}", f"--attention_impl={impl}",
                    f"--seq_len={SLICE14_SHARD_TOKENS * sp}",
                    f"--num_warmup_batches={warm}",
                    f"--num_batches={timed}", "--display_every=10",
                    f"--gradient_checkpointing={str(remat).lower()}"]
            t0 = time.perf_counter()
            rc, res = launch(argv)
            rec = {"phase": "slice14", "part": f"c_llama_1b_w{world}_sp{sp}"
                                               f"_{impl}",
                   "argv": argv, "rc": rc, "cards": cards,
                   "ring_fold_gb": folds if impl == "ring" else None,
                   "remat": remat, "seconds": time.perf_counter() - t0,
                   "sequences_per_sec": res.get("total_images_per_sec"),
                   "nvidia_smi": smi, **{k: res.get(k) for k in keys}}
            rec["ok"] = (rc == 0 and res["total_workers"] == world
                         and res["sequence_parallel"] == sp
                         and res["global_batch"]
                         == SLICE14_SHARD_BATCH * world // sp
                         and math.isfinite(res["final_loss"]))
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"phase 22 (c) failed: {rec}")
    warm, timed = SLICE14_ZERO1_STEPS
    runs = {}
    for vu in ("psum", "zero1"):
        argv = ["1", "0", str(TRAIN_BATCH), "ib", "--model=resnet50",
                "--use_fp16=true", "--fused_conv=true",
                f"--variable_update={vu}", f"--num_warmup_batches={warm}",
                f"--num_batches={timed}", "--display_every=10"]
        rc, res = launch(argv)
        runs[vu] = res
        if res["total_workers"] != cards:
            raise AssertionError(f"phase 22 (c) resnet50 {vu}: {res}")
    z, p = runs["zero1"], runs["psum"]
    rec = {"phase": "slice14", "part": "c_resnet50_zero1_vs_psum",
           "cards": cards,
           "images_per_sec": {"psum": p["total_images_per_sec"],
                              "zero1": z["total_images_per_sec"]},
           "optimizer_state_bytes": {"psum": p["optimizer_state_bytes"],
                                     "zero1": z["optimizer_state_bytes"]},
           "final_loss": {"psum": p["final_loss"],
                          "zero1": z["final_loss"]},
           "peak_hbm_bytes": {"psum": p["peak_hbm_bytes"],
                              "zero1": z["peak_hbm_bytes"]},
           "nvidia_smi": smi}
    rec["ok"] = (math.isfinite(z["final_loss"])
                 and z["optimizer_state_bytes"]
                 <= 1.01 * p["optimizer_state_bytes"] / cards)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 22 (c) zero1 failed: {rec}")


def phase_slice14(torch, dev, smi) -> dict:
    """Phase 22: sequence parallelism and zero1; returns every kernel's
    launches summed over the main-path runs (a) and (b)."""
    import shutil

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    base = Path(__file__).resolve().parent / "build" / "slice14"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    slice14_degenerate(torch, smi, add)
    torch.cuda.empty_cache()
    det = torch.backends.cudnn.deterministic
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        slice14_zero1(torch, smi, base, add)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    slice14_multi(torch, smi, torch.cuda.device_count())
    emit({"phase": "slice14", "part": "d_launches", "launches": total,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return total


def _slice15_tp1_arm(torch, dev, cfg, tp_arm: bool) -> dict:
    """One arm of phase 23 (a): gpt2 built from the seed, plain or cut
    one way over the one-rank world group (``parallel.tensor``), 3 + 10
    steps on the synthetic batch; every count zeroed just before and
    read just after."""
    import torch.distributed as dist

    from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import tensor
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, spec = create_model("gpt2", torch.bfloat16, "flash", device=dev,
                               seed=cfg.seed, train=True)
    tp = (tensor.shard_model_(model, dist.group.WORLD, "tp",
                              dist.group.WORLD) if tp_arm else None)
    state = step_mod.make_train_state(model, cfg, Fabric.ICI, None, tp)
    batch = tokens_to_device(SyntheticTokens(
        SLICE15_GPT2_BATCH, spec.input_shape[0], seed=cfg.seed,
        vocab_size=spec.vocab_size, causal_lm=True).batch(), dev)
    warm, timed = SLICE15_STEPS
    losses = []
    _zero_counts()
    try:
        for _ in range(warm):
            state, m = step_mod.train_step(state, batch)
            losses.append(m["loss"].detach().clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = step_mod.train_step(state, batch)
            losses.append(m["loss"].detach().clone())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
    finally:
        state.dp.grads.close()
    rec = {"losses": [float(x) for x in losses],
           "sequences_per_sec": SLICE15_GPT2_BATCH * timed / dt,
           "mean_step_ms": 1e3 * dt / timed,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "split_params": len(tp.rules) if tp else 0}
    del state, model
    torch.cuda.empty_cache()
    return rec


def slice15_tp1(torch, dev, smi, add) -> float:
    """Phase 23 (a): gpt2 16 x 1024 bf16 flash ``--fused_xent`` through
    the TP layers at tp 1 against the plain model, from one seed; returns
    the plain run's last loss (the world-1 reference of (c))."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.parallel import distributed

    cfg = flags.BenchmarkConfig(
        model="gpt2", batch_size=SLICE15_GPT2_BATCH, use_fp16=True,
        attention_impl="flash", fused_xent=True).resolve()
    steps = sum(SLICE15_STEPS)
    expect = {**{FLASH_KERNELS[k][0]: 12 * steps for k in FLASH_KERNELS},
              **{XENT_KERNELS[k][0]: steps for k in XENT_KERNELS}}
    distributed.init_single("nccl")
    try:
        plain = _slice15_tp1_arm(torch, dev, cfg, False)
        tp1 = _slice15_tp1_arm(torch, dev, cfg, True)
    finally:
        dist.destroy_process_group()
    for arm in (plain, tp1):
        add(arm["launches"])
    last = abs(tp1["losses"][-1] - plain["losses"][-1]) / abs(
        plain["losses"][-1])
    rec = {"phase": "slice15", "part": "a_gpt2_tp1_vs_plain",
           "batch": SLICE15_GPT2_BATCH, "steps": steps,
           "losses": {"plain": plain["losses"], "tp1": tp1["losses"]},
           "losses_bit_equal": tp1["losses"] == plain["losses"],
           "last_loss_rel": last, "tol": SLICE15_TP1_TOL,
           "sequences_per_sec": {"plain": plain["sequences_per_sec"],
                                 "tp1": tp1["sequences_per_sec"]},
           "rate_ratio": tp1["sequences_per_sec"]
           / plain["sequences_per_sec"],
           "mean_step_ms": {"plain": plain["mean_step_ms"],
                            "tp1": tp1["mean_step_ms"]},
           "peak_mem_gb": {"plain": plain["peak_mem_gb"],
                           "tp1": tp1["peak_mem_gb"]},
           "split_params": tp1["split_params"],
           "launches": {"plain": plain["launches"],
                        "tp1": tp1["launches"]},
           "expected_launches": expect, "nvidia_smi": smi}
    rec["ok"] = (all(arm["launches"][k] == expect.get(k, 0)
                     for arm in (plain, tp1) for k in arm["launches"])
                 and len(tp1["losses"]) == steps
                 and all(math.isfinite(x) for x in tp1["losses"])
                 and (rec["losses_bit_equal"] or last <= SLICE15_TP1_TOL)
                 and tp1["split_params"] == 12 * 6)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 23 (a) failed: {rec}")
    return plain["losses"][-1]


def _tee_launch(argv: list[str], phase: str) -> tuple[int, dict, list]:
    """``launcher.main(argv)`` with its lines kept (and passed to
    stderr): ``(rc, result line, lines)``; raises unless it exits 0."""
    from tpu_hc_bench_torch import launcher

    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    rc = launcher.main(argv, print_fn=tee)
    if rc != 0 or not any(ln.startswith("{") for ln in lines):
        raise AssertionError(f"{phase}: {argv} exited {rc}: {lines[-5:]}")
    return rc, _result(lines), lines


def slice15_elastic(torch, dev, smi, base: Path, add) -> None:
    """Phase 23 (b): two CPU workers write a resnet50 zero1 checkpoint;
    the card refuses it without ``--resume=elastic``, restores it
    elastically bit for bit, and the launcher resumes it."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags, launcher
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import distributed
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    d = base / "b_zero1"
    t0 = time.perf_counter()
    _, saved, _ = _tee_launch(
        ["1", str(SLICE15_CPU_WORKERS), "2", "ib", "--model=resnet50",
         "--device=cpu", "--variable_update=zero1",
         "--num_warmup_batches=1", "--num_batches=1", "--display_every=1",
         f"--train_dir={d}"], "phase 23 (b) CPU workers")
    cpu_s = time.perf_counter() - t0
    saved_fp = saved["checkpoint"]["fingerprint"]
    step, payload = ckpt.load_payload(d)
    topo = ckpt.read_topology(d)
    argv = ["1", "1", str(SLICE15_RESUME_BATCH), "ib", "--model=resnet50",
            "--use_fp16=true", "--fused_conv=true", "--variable_update=zero1",
            "--num_warmup_batches=1", "--num_batches=2", "--display_every=1",
            f"--train_dir={d}"]
    refused = None
    try:
        launcher.main(argv, print_fn=lambda m: None)
    except ckpt.TopologyMismatchError as e:
        refused = str(e)
    cfg = flags.BenchmarkConfig(
        model="resnet50", batch_size=SLICE15_RESUME_BATCH, use_fp16=True,
        fused_conv=True, variable_update="zero1").resolve()
    distributed.init_single("nccl")
    try:
        model, _ = create_model("resnet50", torch.bfloat16, device=dev,
                                seed=5, train=True, fused_conv=True)
        state = step_mod.make_train_state(model, cfg, Fabric.ICI)
        ckpt.restore_elastic(state, d, topo, 1)
        restored_fp = ckpt.fingerprint(model.state_dict())
        shards = payload["optimizer"]["zero1_shards"]
        mine = state.optimizer.state_dict()
        opt_equal = all(
            torch.equal(mine["state"][i]["momentum_buffer"].cpu(),
                        torch.cat([s["state"][i]["momentum_buffer"]
                                   for s in shards])[:p.numel()])
            for i, p in enumerate(state.dp.grads.params))
        state.dp.grads.close()
        del state, model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _, res, lines = _tee_launch(argv + ["--resume=elastic"],
                                "phase 23 (b) resume")
    counts = _read_counts()
    add(counts)
    steps = 1 + 2
    plan = [ln for ln in lines if ln.startswith("elastic resume:")]
    rec = {"phase": "slice15", "part": "b_elastic_cpu2_to_card1",
           "cpu_workers_s": cpu_s, "saved_step": step,
           "saved_topology": topo, "refused": refused, "plan": plan,
           "saved_fingerprint": saved_fp, "restored_fingerprint":
           restored_fp, "optimizer_real_elements_bit_equal": opt_equal,
           "resume": res.get("resume"), "images_per_sec":
           res["total_images_per_sec"], "final_loss": res["final_loss"],
           "launches": counts,
           "expected_launches": {"fused_bn_relu_conv":
                                 FUSED_LAUNCHES_PER_STEP * steps},
           "nvidia_smi": smi}
    rec["ok"] = (refused is not None and "saved world=2" in refused
                 and "live world=1" in refused
                 and "--resume=elastic" in refused
                 and restored_fp == saved_fp and opt_equal
                 and len(plan) == 1 and "[2, k]->[1, k']" in plan[0]
                 and f"state fingerprint: {saved_fp}" in lines
                 and res["resume"]["elastic"] is True
                 and all(counts[k] == rec["expected_launches"].get(k, 0)
                         for k in counts)
                 and math.isfinite(res["final_loss"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 23 (b) failed: {rec}")


def _elastic_worker(src: str, dst: str, out: str) -> int:
    """One rank of phase 23 (f) (``chip_smoke.py --elastic-worker SRC
    DST OUT``, started by ``spawn_local``): restore the zero1 checkpoint
    under ``SRC`` elastically at this world, keep the fingerprint and the
    optimizer shards in ``OUT.rank<k>.pt``, save under ``DST`` (unless
    it is ``-``)."""
    import torch
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import distributed
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    worker = distributed.worker_from_env()
    # the card; the CPU only in a rehearsal of the phase without one
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(worker.local_rank)
    distributed.init_group(distributed.backend_for(True, dev), worker)
    try:
        cfg = flags.BenchmarkConfig(
            model="resnet50", batch_size=SLICE15_ELASTIC_BATCH,
            use_fp16=True, fused_conv=True, variable_update="zero1",
            device=dev.type).resolve()
        model, _ = create_model("resnet50", torch.bfloat16, device=dev,
                                seed=7, train=True, fused_conv=True)
        state = step_mod.make_train_state(model, cfg, Fabric.ICI)
        saved = ckpt.read_topology(src)
        action, plan = ckpt.check_topology(saved, ckpt.topology_record(
            worker.world_size, cfg), src, elastic=True)
        ckpt.restore_elastic(state, src, saved, worker.world_size,
                             rank=worker.rank)
        opt = state.optimizer.state_dict()
        rec = {"fingerprint": ckpt.fingerprint(model.state_dict()),
               "plan": [action, plan], "step": state.step,
               "shards": {i: {k: v.cpu() for k, v in st.items()
                              if isinstance(v, torch.Tensor)}
                          for i, st in opt["state"].items()}}
        if dst != "-":
            ckpt.save(state, dst, topology=ckpt.topology_record(
                worker.world_size, cfg), write=worker.rank == 0)
            distributed.barrier()
        torch.save(rec, f"{out}.rank{worker.rank}.pt")
        state.dp.grads.close()
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_self(world: int, args: list[str], on_line, phase: str) -> None:
    """``world`` processes of this script (``args`` after its path), one
    a card, over a fresh file store; raises unless all exit 0."""
    import tempfile

    from tpu_hc_bench_torch.parallel import distributed

    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    workers = [distributed.Worker(r, r, world, f"file://{tmp}/store")
               for r in range(world)]
    rc = distributed.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), *args], workers,
        on_line)
    if rc != 0:
        raise AssertionError(f"{phase}: {world} workers exited {rc}")


def _spawn_elastic(world: int, src: Path, dst: str, out: Path) -> list:
    """Phase 23 (f): ``world`` ``--elastic-worker`` processes, one a
    card; each rank's record."""
    import torch

    _spawn_self(world, ["--elastic-worker", str(src), dst, str(out)],
                lambda m: print(m, file=sys.stderr, flush=True),
                "phase 23 (f) elastic")
    return [torch.load(f"{out}.rank{r}.pt") for r in range(world)]


def slice15_multi(torch, smi, cards: int, base: Path,
                  gpt2_world1_loss: float) -> None:
    """Phase 23 (c)-(f), with two cards or more."""
    import shutil

    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    if cards < 2:
        emit({"phase": "slice15", "part": "cf_multi_card", "ran": False,
              "cards": cards, "nvidia_smi": smi})
        return
    warm, timed = SLICE15_STEPS
    steps = [f"--num_warmup_batches={warm}", f"--num_batches={timed}",
             "--display_every=10"]
    keys = ("total_workers", "global_batch", "total_images_per_sec",
            "mean_step_ms", "final_loss", "model_parallel",
            "expert_parallel", "num_slices", "peak_hbm_bytes",
            "device_kind", "extra")
    world1 = {"gpt2": gpt2_world1_loss}
    for model, batch, world, flag, deg in SLICE15_TP:
        if world > cards:
            continue
        lm = ["--use_fp16=true", "--attention_impl=flash",
              *(["--fused_xent=true"] if model == "gpt2" else [])]
        if model not in world1:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _, res1, _ = _tee_launch(["1", "1", str(batch), "ib",
                                      f"--model={model}", *lm, *steps],
                                     "phase 23 (c) world 1")
            world1[model] = res1["final_loss"]
            emit({"phase": "slice15", "part": f"world1_{model}",
                  "sequences_per_sec": res1["total_images_per_sec"],
                  "peak_gb": (res1["peak_hbm_bytes"] or 0) / 1e9,
                  "nvidia_smi": smi,
                  **{k: res1.get(k) for k in keys}})
        argv = ["1", str(world), str(batch), "ib", f"--model={model}", *lm,
                f"--{flag}={deg}", *steps]
        t0 = time.perf_counter()
        _, res, lines = _tee_launch(argv, "phase 23 (c)/(d)")
        dp = world // deg
        rel = (abs(res["final_loss"] - world1[model]) / abs(world1[model])
               if dp == 1 else None)
        rec = {"phase": "slice15",
               "part": f"{'c' if flag == 'model_parallel' else 'd'}_"
                       f"{model}_w{world}_{flag}{deg}",
               "argv": argv, "seconds": time.perf_counter() - t0,
               "cards": cards, "sequences_per_sec":
               res["total_images_per_sec"],
               "peak_gb": (res["peak_hbm_bytes"] or 0) / 1e9,
               "world1_final_loss": world1[model],
               "final_loss_rel_world1": rel,
               "banner": [ln for ln in lines
                          if " parallel: mesh data=" in ln],
               "nvidia_smi": smi, **{k: res.get(k) for k in keys}}
        rec["ok"] = (res["total_workers"] == world
                     and res[flag] == deg
                     and res["global_batch"] == batch * dp
                     and math.isfinite(res["final_loss"])
                     and (rel is None or rel <= 0.05))
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"phase 23 (c)/(d) failed: {rec}")
    if cards < 4:
        return
    res = {}
    resnet = ["--model=resnet50", "--use_fp16=true", "--fused_conv=true",
              *steps]
    for fabric, extra in (("ib", []), ("dcn", ["--num_slices=2"])):
        _, res[fabric], lines = _tee_launch(
            ["1", "4", str(TRAIN_BATCH), fabric, *resnet, *extra],
            "phase 23 (e)")
        if fabric == "dcn":
            banner = [ln for ln in lines if ln.startswith("multislice:")]
    rel = abs(res["dcn"]["final_loss"] - res["ib"]["final_loss"]) / abs(
        res["ib"]["final_loss"])
    rec = {"phase": "slice15", "part": "e_resnet50_dcn2_vs_ib",
           "images_per_sec": {f: r["total_images_per_sec"]
                              for f, r in res.items()},
           "final_loss": {f: r["final_loss"] for f, r in res.items()},
           "final_loss_rel": rel, "banner": banner,
           "allreduce_per_step": {f: r["allreduce_per_step"]
                                  for f, r in res.items()},
           "nvidia_smi": smi}
    rec["ok"] = (res["dcn"]["num_slices"] == 2 and rel <= 1e-2
                 and banner == ["multislice: 2 slices x virtual slices on "
                                "1 host(s) — data axis = dcn(2) x data(2)"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 23 (e) failed: {rec}")
    d4 = base / "f_z4"
    _tee_launch(["1", "4", str(SLICE15_ELASTIC_BATCH), "ib", *resnet,
                 "--variable_update=zero1", f"--train_dir={d4}"],
                "phase 23 (f) save")
    _, payload = ckpt.load_payload(d4)
    fp4 = ckpt.fingerprint(payload["model"])
    shards4 = payload["optimizer"]["zero1_shards"]
    r2 = _spawn_elastic(2, d4, str(base / "f_z2"), base / "f_r2")
    r4 = _spawn_elastic(4, base / "f_z2", "-", base / "f_r4")
    n_params = len(shards4[0]["state"])

    def same_real(a, b) -> bool:
        """Two stacks of one tensor's shards: equal up to the shorter,
        zero padding past it."""
        m = min(a.numel(), b.numel())
        return (torch.equal(a[:m], b[:m]) and not a[m:].any()
                and not b[m:].any())

    real2 = all(same_real(
        torch.cat([r["shards"][i]["momentum_buffer"] for r in r2]),
        torch.cat([s["state"][i]["momentum_buffer"] for s in shards4]))
        for i in range(n_params))
    back4 = all(torch.equal(r4[k]["shards"][i]["momentum_buffer"],
                            shards4[k]["state"][i]["momentum_buffer"])
                for k in range(4) for i in range(n_params))
    d2 = base / "f_launcher"
    shutil.copytree(d4, d2)
    _, res2, lines = _tee_launch(
        ["1", "2", str(SLICE15_ELASTIC_BATCH), "ib", *resnet,
         "--variable_update=zero1", "--resume=elastic", f"--train_dir={d2}"],
        "phase 23 (f) launcher resume")
    rec = {"phase": "slice15", "part": "f_zero1_elastic_4_2_4",
           "fingerprints": {"saved4": fp4,
                            "at2": sorted({r["fingerprint"] for r in r2}),
                            "at4": sorted({r["fingerprint"] for r in r4})},
           "plans": {"at2": r2[0]["plan"], "at4": r4[0]["plan"]},
           "real_elements_at2_bit_equal": real2,
           "shards_after_round_trip_bit_equal": back4,
           "launcher_plan": [ln for ln in lines
                             if ln.startswith("elastic resume:")],
           "launcher_resume": res2.get("resume"),
           "launcher_images_per_sec": res2["total_images_per_sec"],
           "nvidia_smi": smi}
    rec["ok"] = (rec["fingerprints"]["at2"] == [fp4]
                 and rec["fingerprints"]["at4"] == [fp4] and real2 and back4
                 and r2[0]["plan"][0] == r4[0]["plan"][0] == "reshard"
                 and res2["resume"]["elastic"] is True)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 23 (f) failed: {rec}")


def phase_slice15(torch, dev, smi) -> dict:
    """Phase 23: elastic resume, multislice, TP and EP; returns every
    kernel's launches summed over the main-path runs (a) and (b)."""
    import shutil

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    base = Path(__file__).resolve().parent / "build" / "slice15"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        gpt2_loss = slice15_tp1(torch, dev, smi, add)
        torch.cuda.empty_cache()
        slice15_elastic(torch, dev, smi, base, add)
        torch.cuda.empty_cache()
        t_ab = time.perf_counter() - t0
        slice15_multi(torch, smi, torch.cuda.device_count(), base,
                      gpt2_loss)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "slice15", "part": "g_launches", "launches": total,
          "seconds_ab": t_ab, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    return total


def _slice16_one_stage_arm(torch, dev, cfg, staged: bool) -> dict:
    """One arm of phase 24 (a): gpt2 from the seed, its plain step or the
    GPipe schedule of ``parallel.pipeline`` in a one-rank pipe group (M
    microbatches, no hops), dropout off in both (the arms would draw
    their masks in other orders), 3 + 10 steps; every count zeroed just
    before and read just after."""
    from tpu_hc_bench_torch.data.synthetic import (SyntheticTokens,
                                                   tokens_to_device)
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import pipeline
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, spec = create_model("gpt2", torch.bfloat16, "flash", device=dev,
                               seed=cfg.seed, train=True)
    pipe = (pipeline.make_pipeline(None, model.num_layers, SLICE16_M)
            if staged else None)
    state = step_mod.make_train_state(model, cfg, Fabric.ICI, None, None,
                                      pipe)
    state.model.eval()
    batch = tokens_to_device(SyntheticTokens(
        SLICE16_GPT2_BATCH, spec.input_shape[0], seed=cfg.seed,
        vocab_size=spec.vocab_size, causal_lm=True).batch(), dev)
    warm, timed = SLICE16_STEPS
    losses = []
    _zero_counts()
    try:
        for _ in range(warm):
            state, m = step_mod.train_step(state, batch)
            losses.append(m["loss"].detach().clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = step_mod.train_step(state, batch)
            losses.append(m["loss"].detach().clone())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
    finally:
        state.dp.grads.close()
    rec = {"losses": [float(x) for x in losses],
           "sequences_per_sec": SLICE16_GPT2_BATCH * timed / dt,
           "mean_step_ms": 1e3 * dt / timed,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    del state, model
    torch.cuda.empty_cache()
    return rec


def slice16_one_stage(torch, dev, smi, add) -> float:
    """Phase 24 (a): gpt2 16 x 1024 bf16 flash through the GPipe schedule
    at one stage (M = 4) against the plain step, from one seed; returns
    the plain run's rate."""
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.parallel import distributed

    cfg = flags.BenchmarkConfig(model="gpt2", batch_size=SLICE16_GPT2_BATCH,
                                use_fp16=True, attention_impl="flash"
                                ).resolve()
    steps = sum(SLICE16_STEPS)
    distributed.init_single("nccl")
    try:
        plain = _slice16_one_stage_arm(torch, dev, cfg, False)
        staged = _slice16_one_stage_arm(torch, dev, cfg, True)
    finally:
        dist.destroy_process_group()
    for arm in (plain, staged):
        add(arm["launches"])
    expect = {"plain": {FLASH_KERNELS[k][0]: 12 * steps
                        for k in FLASH_KERNELS},
              "staged": {FLASH_KERNELS[k][0]: 12 * SLICE16_M * steps
                         for k in FLASH_KERNELS}}
    last = abs(staged["losses"][-1] - plain["losses"][-1]) / abs(
        plain["losses"][-1])
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(staged["losses"], plain["losses"]))
    rec = {"phase": "slice16", "part": "a_gpt2_one_stage_vs_plain",
           "batch": SLICE16_GPT2_BATCH, "microbatches": SLICE16_M,
           "steps": steps, "dropout": "off in both arms",
           "losses": {"plain": plain["losses"], "staged": staged["losses"]},
           "losses_bit_equal": staged["losses"] == plain["losses"],
           "last_loss_rel": last, "worst_loss_rel": worst,
           "tol": SLICE16_ONE_STAGE_TOL,
           "sequences_per_sec": {"plain": plain["sequences_per_sec"],
                                 "staged": staged["sequences_per_sec"]},
           "rate_ratio": staged["sequences_per_sec"]
           / plain["sequences_per_sec"],
           "mean_step_ms": {"plain": plain["mean_step_ms"],
                            "staged": staged["mean_step_ms"]},
           "peak_mem_gb": {"plain": plain["peak_mem_gb"],
                           "staged": staged["peak_mem_gb"]},
           "launches": {"plain": plain["launches"],
                        "staged": staged["launches"]},
           "expected_launches": expect, "nvidia_smi": smi}
    rec["ok"] = (all(arm["launches"][k] == expect[name].get(k, 0)
                     for name, arm in (("plain", plain),
                                       ("staged", staged))
                     for k in arm["launches"])
                 and all(math.isfinite(x) for x in staged["losses"])
                 and (rec["losses_bit_equal"]
                      or worst <= SLICE16_ONE_STAGE_TOL))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 24 (a) failed: {rec}")
    return plain["sequences_per_sec"]


def slice16_interchange(torch, smi, base: Path) -> None:
    """Phase 24 (b): two CPU workers write a llama_tiny checkpoint at pp
    2; the card resumes it at world 1 as plain data parallelism, and its
    own save resumes on two CPU workers at pp 2, each restore's
    fingerprint the saved one."""
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    d = base / "b_pp2"
    common = ["--model=llama_tiny", "--num_warmup_batches=1",
              "--num_batches=2", "--display_every=1", f"--train_dir={d}"]
    cpu = ["1", str(SLICE16_CPU_WORKERS), "4", "ib", "--device=cpu",
           "--pipeline_parallel=2", *common]
    t0 = time.perf_counter()
    _, saved, _ = _tee_launch(cpu, "phase 24 (b) CPU workers")
    cpu_s = time.perf_counter() - t0
    topo = ckpt.read_topology(d)
    _, card, card_lines = _tee_launch(["1", "1", "4", "ib", *common,
                                       "--resume=must"],
                                      "phase 24 (b) card")
    _, back, back_lines = _tee_launch(cpu + ["--resume=must"],
                                      "phase 24 (b) CPU workers resume")
    rec = {"phase": "slice16", "part": "b_pp2_cpu_to_card_dp_and_back",
           "cpu_workers_s": cpu_s, "saved_topology": topo,
           "saved_fingerprint": saved["checkpoint"]["fingerprint"],
           "card_restored_fingerprint": _fp_line(card_lines),
           "card_saved_fingerprint": card["checkpoint"]["fingerprint"],
           "cpu_restored_fingerprint": _fp_line(back_lines),
           "card_resume": card.get("resume"),
           "cpu_resume": back.get("resume"), "nvidia_smi": smi}
    rec["ok"] = (topo["pipeline_parallel"] == 2
                 and topo["mesh"] == {"data": 1, "pipe": 2}
                 and rec["card_restored_fingerprint"]
                 == rec["saved_fingerprint"]
                 and rec["cpu_restored_fingerprint"]
                 == rec["card_saved_fingerprint"]
                 and card["resume"]["restored_step"] == 3
                 and back["resume"]["restored_step"] == 6
                 and card["pipeline_parallel"] == 1
                 and back["pipeline_parallel"] == 2
                 and math.isfinite(back["final_loss"]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 24 (b) failed: {rec}")


def _launch_worker(out: str, argv: list[str]) -> int:
    """One rank of phase 24 (c)-(e) (``chip_smoke.py --launch-worker OUT
    ARGV...``, started by ``spawn_local``): ``launcher.main(argv)`` as a
    spawned worker of the launcher runs it, with every kernel's count
    zeroed just before and read just after, and the card's peak, kept
    in ``OUT.rank<k>.pt``."""
    import torch

    from tpu_hc_bench_torch import launcher
    from tpu_hc_bench_torch.parallel import distributed

    worker = distributed.worker_from_env()
    # the card; the CPU only in a rehearsal of the phase without one
    card = torch.cuda.is_available()
    if card:
        torch.cuda.set_device(worker.local_rank)
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rc = launcher.main(argv, print_fn=lambda m: print(m, flush=True))
    torch.save({"rc": rc, "counts": _read_counts(),
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if card else 0.0)},
               f"{out}.rank{worker.rank}.pt")
    return rc


def _spawn_launch(world: int, argv: list[str], out: Path, phase: str
                  ) -> tuple[dict, list, list]:
    """``world`` ``--launch-worker`` processes, one a card: rank 0's
    result line and lines, and each rank's record."""
    import torch

    lines: list[str] = []

    def tee(m: str) -> None:
        lines.append(m)
        print(m, file=sys.stderr, flush=True)

    _spawn_self(world, ["--launch-worker", str(out), *argv], tee, phase)
    if not any(ln.startswith("{") for ln in lines):
        raise AssertionError(f"{phase}: {argv}: no result: {lines[-5:]}")
    return (_result(lines), lines,
            [torch.load(f"{out}.rank{r}.pt") for r in range(world)])


def _pp_ckpt_worker(src: str, dst: str, out: str, pp: str,
                    model_name: str) -> int:
    """One rank of phase 24 (f) (``chip_smoke.py --pp-ckpt-worker SRC DST
    OUT PP MODEL``): the decoder's stage at ``PP`` stages on the card,
    restored from ``SRC`` (the host layout), its gathered fingerprints
    kept in ``OUT.rank<k>.pt``, saved under ``DST``; no step taken."""
    import torch
    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import distributed, pipeline
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    worker = distributed.worker_from_env()
    # the card; the CPU only in a rehearsal of the phase without one
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(worker.local_rank)
    distributed.init_group(distributed.backend_for(True, dev), worker)
    pp = int(pp)
    try:
        cfg = flags.BenchmarkConfig(
            model=model_name, batch_size=SLICE16_LLAMA_BATCH, use_fp16=True,
            attention_impl="flash", pipeline_parallel=pp,
            device=dev.type).resolve()
        mesh = distributed.build_mesh(pipeline_parallel=pp,
                                      force_seq_axis=False)
        model, _ = create_model(model_name, torch.bfloat16, "flash",
                                device=dev, seed=3, train=True,
                                pipeline=(pp, mesh.pipe_index))
        pipe = pipeline.make_pipeline(mesh, model.num_layers,
                                      pipeline.default_microbatches(
                                          cfg.batch_size, pp))
        state = step_mod.make_train_state(model, cfg, Fabric.ICI, mesh,
                                          None, pipe)
        topo = ckpt.topology_record(worker.world_size, cfg, mesh=mesh.shape)
        action, plan = ckpt.check_topology(ckpt.read_topology(src), topo,
                                           src)
        ckpt.restore(state, src, rank=worker.rank)
        opt = pipeline.full_optimizer_state(state.optimizer, model, None,
                                            pipe)
        rec = {"plan": [action, plan], "step": state.step,
               "layers": len(model.layers),
               "fingerprint": ckpt.model_fingerprint(state),
               "optimizer": ckpt.fingerprint(opt["state"])}
        ckpt.save(state, dst, topology=topo, write=worker.rank == 0)
        distributed.barrier()
        torch.save(rec, f"{out}.rank{worker.rank}.pt")
        state.dp.grads.close()
    finally:
        dist.destroy_process_group()
    return 0


def _slice16_rec(part: str, argv, res: dict, lines: list, ranks: list,
                 expect: dict, smi: str, **extra) -> dict:
    """A multi-card run's record: rate, each rank's peak and launches
    against ``expect``, the banner lines."""
    rec = {"phase": "slice16", "part": part, "argv": argv,
           "sequences_per_sec": res["total_images_per_sec"],
           "mean_step_ms": res["mean_step_ms"],
           "final_loss": res["final_loss"],
           "global_batch": res["global_batch"],
           "total_workers": res["total_workers"],
           "pipeline_parallel": res["pipeline_parallel"],
           "num_microbatches": res["num_microbatches"],
           "model_parallel": res["model_parallel"],
           "sequence_parallel": res["sequence_parallel"],
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
           "launches_by_rank": [r["counts"] for r in ranks],
           "expected_launches_a_rank": expect,
           "banner": [ln for ln in lines if ln.startswith(
               ("pipeline:", "tensor parallel:", "sequence parallel:"))],
           "nvidia_smi": smi, **extra}
    rec["ok"] = (all(r["rc"] == 0 for r in ranks)
                 and all(r["counts"][k] == expect.get(k, 0)
                         for r in ranks for k in r["counts"])
                 and math.isfinite(res["final_loss"]))
    return rec


def slice16_multi(torch, smi, cards: int, base: Path) -> None:
    """Phase 24 (c)-(f), with two cards or more (each run through the
    launcher's path in processes of its own, one a card)."""
    import shutil

    import torch.distributed as dist

    from tpu_hc_bench_torch import flags
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.parallel import distributed, pipeline
    from tpu_hc_bench_torch.parallel.fabric import Fabric
    from tpu_hc_bench_torch.train import step as step_mod
    from tpu_hc_bench_torch.utils import checkpoint as ckpt

    if cards < 2:
        emit({"phase": "slice16", "part": "cf_multi_card", "ran": False,
              "cards": cards, "nvidia_smi": smi})
        return
    warm, timed = SLICE16_STEPS
    steps = sum(SLICE16_STEPS)
    flags_ = [f"--num_warmup_batches={warm}", f"--num_batches={timed}",
              "--display_every=10"]
    gpt2 = ["--model=gpt2", "--use_fp16=true", "--attention_impl=flash"]
    llama = [f"--model={SLICE16_LLAMA}", "--use_fp16=true",
             "--attention_impl=flash"]
    n_gpt2, n_llama = SLICE16_LAYERS["gpt2"], SLICE16_LAYERS[SLICE16_LLAMA]

    def flash(n: int) -> dict:
        return {FLASH_KERNELS[k][0]: n for k in FLASH_KERNELS}

    def run(part, world, batch, extra, expect, **kw):
        argv = ["1", str(world), str(batch), "ib", *extra, *flags_]
        t0 = time.perf_counter()
        res, lines, ranks = _spawn_launch(world, argv, base / part,
                                          f"phase 24 {part}")
        rec = _slice16_rec(part, argv, res, lines, ranks, expect, smi,
                           seconds=time.perf_counter() - t0, **kw)
        return rec, res

    # (c) gpt2 16 x 1024 at pp 2, pp 4 and dp 2 x pp 2
    for world, pp in ((2, 2), (4, 4), (4, 2)):
        if world > cards:
            continue
        m = pipeline.default_microbatches(SLICE16_GPT2_BATCH, pp)
        rec, res = run(f"c_gpt2_w{world}_pp{pp}", world, SLICE16_GPT2_BATCH,
                       gpt2 + [f"--pipeline_parallel={pp}"],
                       flash(n_gpt2 // pp * m * steps))
        rec["ok"] = (rec["ok"] and res["pipeline_parallel"] == pp
                     and res["num_microbatches"] == m
                     and res["global_batch"] == SLICE16_GPT2_BATCH
                     * world // pp
                     and f"pipeline: {pp} stages x {m} microbatches "
                         f"({n_gpt2 // pp} layers/stage)" in rec["banner"])
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"phase 24 (c) failed: {rec}")
    # (d) llama_1b 4 x 2048 at pp 2 and pp 4 against world 1, same rows:
    # the one-batch step and the M-microbatch one (accumulation)
    m_llama = pipeline.default_microbatches(SLICE16_LLAMA_BATCH, 2)
    world1 = {}
    for arm, extra in (("plain", []), ("accum", [
            f"--gradient_accumulation_steps={m_llama}"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        _, res1, _ = _tee_launch(["1", "1", str(SLICE16_LLAMA_BATCH), "ib",
                                  *llama, *flags_, *extra],
                                 f"phase 24 (d) world 1 {arm}")
        counts1 = _read_counts()
        n = n_llama * steps * (m_llama if arm == "accum" else 1)
        rec1 = {"phase": "slice16", "part": f"d_llama_1b_world1_{arm}",
                "sequences_per_sec": res1["total_images_per_sec"],
                "mean_step_ms": res1["mean_step_ms"],
                "final_loss": res1["final_loss"],
                "gradient_accumulation_steps":
                    res1["gradient_accumulation_steps"],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts1, "nvidia_smi": smi}
        rec1["ok"] = all(counts1[k] == flash(n).get(k, 0) for k in counts1)
        emit(rec1)
        if not rec1["ok"]:
            raise AssertionError(f"phase 24 (d) failed: {rec1}")
        world1[arm] = res1
    torch.cuda.empty_cache()
    for pp in (2, 4):
        if pp > cards:
            continue
        m = pipeline.default_microbatches(SLICE16_LLAMA_BATCH, pp)
        if m != m_llama:
            raise AssertionError(f"phase 24 (d): pp {pp} runs {m} "
                                 f"microbatches, the reference {m_llama}")
        rec, res = run(f"d_llama_1b_pp{pp}", pp, SLICE16_LLAMA_BATCH,
                       llama + [f"--pipeline_parallel={pp}"],
                       flash(n_llama // pp * m * steps),
                       world1_final_loss={k: v["final_loss"]
                                          for k, v in world1.items()},
                       world1_sequences_per_sec=world1["plain"][
                           "total_images_per_sec"])
        rel = {k: abs(res["final_loss"] - v["final_loss"])
               / abs(v["final_loss"]) for k, v in world1.items()}
        rec["final_loss_rel_world1"] = rel
        rec["ok"] = (rec["ok"] and rel["accum"] <= SLICE16_LLAMA_TOL
                     and res["global_batch"] == SLICE16_LLAMA_BATCH)
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"phase 24 (d) failed: {rec}")
    if cards < 4:
        return
    # (e) the hybrids on four cards
    m = pipeline.default_microbatches(SLICE16_GPT2_BATCH, 2)
    rec, res = run("e_gpt2_pp2_tp2", 4, SLICE16_GPT2_BATCH,
                   gpt2 + ["--pipeline_parallel=2", "--model_parallel=2"],
                   flash(n_gpt2 // 2 * m * steps))
    rec["ok"] = (rec["ok"] and "tensor parallel: 2-way (hybrid with PP)"
                 in rec["banner"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 24 (e) failed: {rec}")
    rec, res = run("e_llama_1b_sp2_tp2", 4, SLICE16_SPTP_BATCH,
                   [f"--model={SLICE16_LLAMA}", "--use_fp16=true",
                    "--attention_impl=ulysses_flash",
                    "--sequence_parallel=2", "--model_parallel=2"],
                   flash(n_llama * steps))
    rec["ok"] = (rec["ok"] and "tensor parallel: 2-way (hybrid with SP)"
                 in rec["banner"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 24 (e) failed: {rec}")
    # (f) llama_1b checkpoints pp 2 -> pp 4 -> world 1 (host layout)
    d2, d4 = base / "f_pp2", base / "f_pp4"
    res2, _, _ = _spawn_launch(
        2, ["1", "2", str(SLICE16_LLAMA_BATCH), "ib", *llama,
            "--pipeline_parallel=2",
            f"--num_warmup_batches={SLICE16_CKPT_STEPS[0]}",
            f"--num_batches={SLICE16_CKPT_STEPS[1]}", f"--train_dir={d2}"],
        base / "f_save", "phase 24 (f) pp 2 save")
    step2, payload = ckpt.load_payload(d2)
    saved = (ckpt.fingerprint(payload["model"]),
             ckpt.fingerprint(payload["optimizer"]["state"]))
    del payload
    _spawn_self(4, ["--pp-ckpt-worker", str(d2), str(d4),
                    str(base / "f_r4"), "4", SLICE16_LLAMA],
                lambda m: print(m, file=sys.stderr, flush=True),
                "phase 24 (f) pp 4")
    r4 = [torch.load(f"{base / 'f_r4'}.rank{r}.pt") for r in range(4)]
    shutil.rmtree(d2, ignore_errors=True)
    _, payload = ckpt.load_payload(d4)
    saved4 = (ckpt.fingerprint(payload["model"]),
              ckpt.fingerprint(payload["optimizer"]["state"]))
    del payload
    torch.cuda.empty_cache()
    distributed.init_single("nccl")
    try:
        cfg = flags.BenchmarkConfig(model=SLICE16_LLAMA, use_fp16=True,
                                    batch_size=SLICE16_LLAMA_BATCH).resolve()
        model, _ = create_model(SLICE16_LLAMA, torch.bfloat16, "flash",
                                device="cuda", seed=5, train=True)
        state = step_mod.make_train_state(model, cfg, Fabric.ICI)
        ckpt.restore(state, d4)
        world1 = (ckpt.fingerprint(model.state_dict()),
                  ckpt.fingerprint(state.optimizer.state_dict()["state"]))
        state.dp.grads.close()
        del state, model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    shutil.rmtree(d4, ignore_errors=True)
    rec = {"phase": "slice16", "part": "f_llama_1b_pp2_pp4_world1",
           "saved_step": step2, "fingerprints": {
               "pp2_saved": saved, "pp4_restored": sorted(
                   {(r["fingerprint"], r["optimizer"]) for r in r4}),
               "pp4_saved": saved4, "world1_restored": world1},
           "pp4_plans": r4[0]["plan"], "pp4_layers": [r["layers"]
                                                      for r in r4],
           "pp2_fingerprint_line": res2["checkpoint"]["fingerprint"],
           "nvidia_smi": smi}
    rec["ok"] = (rec["fingerprints"]["pp4_restored"] == [saved]
                 and saved4 == saved and world1 == saved
                 and res2["checkpoint"]["fingerprint"] == saved[0]
                 and r4[0]["plan"][0] == "noop"
                 and rec["pp4_layers"] == [n_llama // 4] * 4)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"phase 24 (f) failed: {rec}")


def phase_slice16(torch, dev, smi) -> dict:
    """Phase 24: pipeline parallelism and the 3-D hybrids; returns every
    kernel's launches summed over the main-path run (a)."""
    import shutil

    total: dict = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    base = Path(__file__).resolve().parent / "build" / "slice16"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        slice16_one_stage(torch, dev, smi, add)
        torch.cuda.empty_cache()
        slice16_interchange(torch, smi, base)
        torch.cuda.empty_cache()
        t_ab = time.perf_counter() - t0
        slice16_multi(torch, smi, torch.cuda.device_count(), base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "slice16", "part": "g_launches", "launches": total,
          "seconds_ab": t_ab, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    return total


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of the port on "
                                "the GPUs of this machine.")
    p.add_argument("--only", choices=("dp", "realdata", "slice7",
                                      "serve2", "slice9", "zoo", "slice11",
                                      "slice12", "slice13", "slice14",
                                      "slice15", "slice16"),
                   default=None,
                   help="dp: the build, then phase 13 alone (beside a "
                        "one-worker sock run at its step counts); "
                        "realdata: the build, then phase 14 alone (beside "
                        "phase 7's fused run and phase 10's first run); "
                        "slice7: the build, then phase 15 alone (beside "
                        "phase 7's fused run); serve2: the build, then "
                        "phase 16 alone (beside phase 4's run); slice9: "
                        "the build, then phase 17 alone; zoo: the build, "
                        "phase 8 at ViT's shapes, then phase 18; slice11: "
                        "the build, then phase 19 alone; slice12: the "
                        "build, phase 4, then phase 20; slice13: the "
                        "build, then phase 21 alone; slice14: the build, "
                        "then phase 22 alone; slice15: the build, then "
                        "phase 23 alone; slice16: the build, then phase "
                        "24 alone")
    only = p.parse_args(argv).only
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    try:
        import tpu_hc_bench_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpu_hc_bench_torch package is missing "
              f"beside this script: {e}", file=sys.stderr)
        return 2
    from tpu_hc_bench_torch.models import create_model
    from tpu_hc_bench_torch.ops import _build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    _, build_s, log = _build.build()
    _build.load_library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})
    if only == "dp":
        argv = ["1", "1", str(TRAIN_BATCH), "sock", "--model=resnet50",
                "--use_fp16=true", "--fused_conv=true",
                f"--num_warmup_batches={DP_WARMUP}",
                f"--num_batches={DP_BATCHES}", "--display_every=10"]
        rc, res = _launch(argv)
        if rc != 0:
            raise AssertionError(f"the sock run failed: {res}")
        phase_dp(torch, dev, smi, res["total_images_per_sec"],
                 f"1 1 {TRAIN_BATCH} sock, {DP_WARMUP} + {DP_BATCHES} steps")
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "realdata":
        _, res = _launch(["1", "1", str(TRAIN_BATCH), "sock",
                          "--model=resnet50", "--use_fp16=true",
                          "--fused_conv=true",
                          f"--num_warmup_batches={TRAIN_WARMUP}",
                          f"--num_batches={TRAIN_BATCHES}"])
        _, lm = _launch(["1", "1", "16", "sock", "--model=gpt2",
                         "--use_fp16=true", "--attention_impl=flash",
                         "--fused_xent=true",
                         f"--num_warmup_batches={LM_WARMUP}",
                         f"--num_batches={LM_BATCHES}"])
        phase_realdata(torch, dev, smi, res["total_images_per_sec"],
                       lm["total_images_per_sec"])
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice7":
        _, res = _launch(["1", "1", str(TRAIN_BATCH), "sock",
                          "--model=resnet50", "--use_fp16=true",
                          "--fused_conv=true",
                          f"--num_warmup_batches={TRAIN_WARMUP}",
                          f"--num_batches={TRAIN_BATCHES}"])
        phase_slice7(torch, dev, smi, res["total_images_per_sec"])
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "serve2":
        model, _ = create_model("llama_1b", device=dev, seed=0)
        _, phase4 = phase_serve(torch, model)
        phase_serve2(torch, dev, smi, model, phase4)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "zoo":
        timer = Timer(torch, dev)
        phase_flash(torch, dev, timer, smi, VIT_FLASH_CASES, extras=False)
        del timer
        torch.cuda.empty_cache()
        phase_zoo(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice11":
        phase_slice11(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice12":
        model, _ = create_model("llama_1b", device=dev, seed=0)
        phase_serve(torch, model)
        total = slice12_serve(torch, smi, model)
        del model
        torch.cuda.empty_cache()
        phase_slice12_rest(torch, smi, total)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice16":
        phase_slice16(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice15":
        phase_slice15(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice14":
        phase_slice14(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice13":
        phase_slice13(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    if only == "slice9":
        phase_slice9(torch, dev, smi)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    timer = Timer(torch, dev)
    main_rows = phase_kernels(torch, dev, timer, smi)
    main_rows["fused_bn_relu_conv"] = phase_conv(torch, dev, timer, smi)
    del timer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, _ = create_model("llama_1b", device=dev, seed=0)
    torch.cuda.synchronize()
    emit({"phase": "model", "name": "llama_1b",
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": time.perf_counter() - t0})
    phase_parity(torch, dev, model)
    torch.cuda.empty_cache()
    launches, phase4 = phase_serve(torch, model)
    serve2_launches = phase_serve2(torch, dev, smi, model, phase4)
    del model, phase4
    torch.cuda.empty_cache()

    phase_train_parity(torch, dev, smi)
    torch.cuda.empty_cache()
    launches["fused_bn_relu_conv"], sock_rate = phase_train(torch, smi)
    torch.cuda.empty_cache()

    timer = Timer(torch, dev)
    main_rows.update(phase_flash(torch, dev, timer, smi))
    del timer
    torch.cuda.empty_cache()
    phase_lm_train_parity(torch, dev, smi)
    torch.cuda.empty_cache()
    lm_launches, lm_rate = phase_lm_train(torch, smi)
    launches.update(lm_launches)
    torch.cuda.empty_cache()

    timer = Timer(torch, dev)
    main_rows.update(phase_xent(torch, dev, timer, smi))
    main_rows["max_pool_bwd"], launches["max_pool_bwd"] = phase_pool(
        torch, dev, timer, smi)
    del timer
    torch.cuda.empty_cache()
    dp_launches = phase_dp(torch, dev, smi, sock_rate,
                           f"phase 7, {TRAIN_WARMUP} + {TRAIN_BATCHES} steps")
    realdata_launches = phase_realdata(torch, dev, smi, sock_rate, lm_rate)
    slice7_launches = phase_slice7(torch, dev, smi, sock_rate)
    torch.cuda.empty_cache()
    slice9_launches = phase_slice9(torch, dev, smi)
    torch.cuda.empty_cache()
    zoo_launches = phase_zoo(torch, dev, smi)
    torch.cuda.empty_cache()
    slice11_launches = phase_slice11(torch, dev, smi)
    torch.cuda.empty_cache()
    model, _ = create_model("llama_1b", device=dev, seed=0)
    slice12_launches = slice12_serve(torch, smi, model)
    del model
    torch.cuda.empty_cache()
    slice12_launches = phase_slice12_rest(torch, smi, slice12_launches)
    torch.cuda.empty_cache()
    slice13_launches = phase_slice13(torch, dev, smi)
    torch.cuda.empty_cache()
    slice14_launches = phase_slice14(torch, dev, smi)
    torch.cuda.empty_cache()
    slice15_launches = phase_slice15(torch, dev, smi)
    torch.cuda.empty_cache()
    slice16_launches = phase_slice16(torch, dev, smi)

    sources = {
        "paged_decode_attention": (
            "tpu_hc_bench_torch/csrc/paged_attention.cu",
            "tpu_hc_bench/ops/paged_attention.py:156"),
        "fused_residual_norm": (
            "tpu_hc_bench_torch/csrc/fused_residual_norm.cu",
            "tpu_hc_bench/ops/fused_residual_ln.py:53"),
        "fused_bn_relu_conv": (
            "tpu_hc_bench_torch/csrc/fused_conv_sm90.cu",
            "tpu_hc_bench/ops/fused_conv.py:147"),
        "flash_attention_fwd": ("tpu_hc_bench_torch/csrc/flash_fwd_sm90.cu",
                                FLASH_KERNELS["fwd"][1]),
        **{FLASH_KERNELS[k][0]: ("tpu_hc_bench_torch/csrc/flash_bwd_sm90.cu",
                                 FLASH_KERNELS[k][1]) for k in ("dq", "dkv")},
        **{row: ("tpu_hc_bench_torch/csrc/xent.cu", replaces)
           for row, replaces in XENT_KERNELS.values()},
        "max_pool_bwd": ("tpu_hc_bench_torch/csrc/pool_bwd.cu",
                         "tpu_hc_bench/ops/pool_bwd.py:186"),
    }
    designs = {
        "paged_decode_attention": "split+merge (split kernel over "
                                  "paged_splits ranges, merge kernel)",
        "fused_residual_norm": (
            f"{main_rows['fused_residual_norm']['design']} (norm_design at "
            f"8 rows of 2048 f32)"),
        "fused_bn_relu_conv": main_rows["fused_bn_relu_conv"]["design"],
        **{FLASH_KERNELS[k][0]: main_rows[FLASH_KERNELS[k][0]]["design"]
           for k in FLASH_KERNELS},
        "softmax_xent_fwd": "one block a row, scalar loads",
        "softmax_xent_bwd": "rows x 2048-column chunks, scalar loads",
        "max_pool_bwd": main_rows["max_pool_bwd"]["design"],
    }
    table = []
    for name, (source, replaces) in sources.items():
        r = main_rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"],
                      "design": designs[name],
                      "dp_launches": dp_launches[name],
                      "realdata_launches": realdata_launches[name],
                      "slice7_launches": slice7_launches[name],
                      "serve2_launches": serve2_launches.get(name, 0),
                      "slice9_launches": slice9_launches.get(name, 0),
                      "zoo_launches": zoo_launches.get(name, 0),
                      "slice11_launches": slice11_launches.get(name, 0),
                      "slice12_launches": slice12_launches.get(name, 0),
                      "slice13_launches": slice13_launches.get(name, 0),
                      "slice14_launches": slice14_launches.get(name, 0),
                      "slice15_launches": slice15_launches.get(name, 0),
                      "slice16_launches": slice16_launches.get(name, 0)})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(_elastic_worker(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--launch-worker"]:
        sys.exit(_launch_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--pp-ckpt-worker"]:
        sys.exit(_pp_ckpt_worker(*sys.argv[2:7]))
    sys.exit(main())
