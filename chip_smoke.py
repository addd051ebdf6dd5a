#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's VCMR serving path, VSM train step, TVC
caption serving, TVC train step, four-task pretraining, TVC finetuning
and captioning as programs, VCMR and VR finetuning from a reference
``.pt`` as programs, VideoQA and VIOLIN finetuning and inference as
programs, data-parallel training and multi-process serving, ZeRO-1,
pipeline, tensor and sequence parallelism on ranks that share the card,
VCMR serving as a program, data preparation from raw files through
the prepro entry points to serving, and kernel components on one GPU and
check them.

    python3 chip_smoke.py                  # on a machine with one CUDA card
    python3 chip_smoke.py --json-out F     # also write the full record to F
    python3 chip_smoke.py --rehearse       # CPU, tiny config, plain versions
    python3 chip_smoke.py --times KERNEL [ROOT]  # daln, bwd3 or fwd of one

What the card run does, in order (any failure exits non-zero):

1. builds the port's CUDA kernels from ``hero_tpu_torch/ops/csrc`` (one
   nvcc per source, all at once);
2. holds every kernel against its plain PyTorch version at the serving
   path's shapes (#1 also at the first and the last call of packed query
   rows, (64, 30, 768): the last holds the partial rows, the pad slots
   and the all-pad rows), in fp32 (tight) and bf16, including a fully masked row
   that must come out finite, and times kernel, plain version and one
   PyTorch library call (the yardstick);
3. initialises the flagship HERO weights (hidden 768, f-encoder 6 layers,
   c-encoder 3 layers, 12 heads, vocab 50272, 4352-d features) from a seed
   with numpy, in the JAX layout, and loads them through the bridge;
4. times phase 1 (embedding a 2000-video corpus in the packed TV layout,
   batches of 50) and phase 2 (512 queries in batches of 64) in bf16;
5. runs the whole serving path -- ``validate_full_vcmr`` with synthetic
   ground truth -- with every kernel launch counter at 0 before and read
   after, and checks the submission and metrics;
6. checks, in fp32, that a small corpus ranked through the kernels on the
   card gives the same top-10 videos per query as the plain path on the
   CPU, with scores within tolerance;
7. the train phase: holds the training kernels (the forward with dropout
   and saved probabilities, the attention and LayerNorm backwards, the
   Philox masks) against their plain versions in fp32 and bf16 at the
   train step's shapes, and the bf16 packed forward and backward at the
   tensor-core kernels' tile edges (``check_packed_edges``: 1 to 1024
   keys and rows, the forward past its old 752 keys, its probabilities
   fed to the backward, exactly 0 wherever the plain ones are, both
   mask modes and the causal bias, bf16 and fp32, one query over each
   key count, fully masked rows, the keep bits read back from both
   kernels); times the
   VSM train step at ``bench.py``'s layout (32 TV videos a step, the
   packed bucket and its overflow bucket, bf16, dropout 0.1,
   ``drop_svmr_prob`` 0.8) as the median of 3 runs of 20 fit and 8
   overflow steps with the launch counters read from 0 around them;
   checks that the loss falls over 20 steps on one batch; holds one
   fp32 train step through the kernels against the plain path on the
   CPU; and, in bf16 with dropout on both buckets at full depth, holds
   one step's loss and gradients through the tensor-core attention
   kernels against the same step with the plain attention versions on
   the card, within the bf16 step's own distance from the fp32 step;
8. the TVC phase, at ``config/hero_tvc.json``'s model (the flagship
   backbone and a 2-layer decoder): holds the head-major attention
   kernel (#4) against its plain version at the decode step's shapes
   (greedy 32 rows, beam-3 96 rows, 30 keys; causal Lq = Lk = 31; a
   fully masked row; its dropout bits against the plain Philox mask) and
   #2 at the decoder's causal and cross-attention shapes; holds the bf16
   #4 and #5 at their tile edges (``check_mha_edges``: 1 to 1000 keys, 1
   to 65 queries, head_dim 32, 64 and 128, the backward to 1024 rows in
   bf16 and fp32, the fp32 forward past its old 14,464 keys, rate 0 and
   0.1, fully masked rows, keep bits read back from both kernels, repeats
   of the backward bit-identical); builds 64
   synthetic TV videos with 4 clips each in an in-memory store; times
   greedy ``generate_clip_captions`` over all 256 clips in bf16 (8
   videos = 32 caption rows a batch, 30 steps; median of 3 runs after a
   warm-up batch, launch counters read from 0 around the first) and one
   beam-3 pass over 2 batches; checks the records (every clip once, the
   schema, ids cut at EOS); and, in fp32 on one batch, that the card's
   greedy ids equal the plain path's on the CPU and a teacher-forced
   replay through ``decode``, both up to the first step whose reference
   top-2 logit gap is below ``TVC_GAP_TOL``; and, in bf16 on one batch,
   that the ids through #4 equal those with #4's plain version on the
   card up to the first step whose plain top-2 gap is below
   ``TVC_BF16_GAP_TOL`` (the fp32 checks reach only the CUDA-core #4);
9. the TVC train phase, at the same model with dropout 0.1 and bf16
   compute on fp32 parameters: holds #2 (causal self-attention 62 -> 62
   and cross-attention 62 -> 100, with dropout and saved probabilities)
   and #3 at the decoder's shapes against their plain versions in fp32
   and bf16; gives the 64 TV videos 2-6 synthetic captions each (lengths
   N(14, 4) clipped to [5, 60], in an in-memory caption store with the
   caption store's BOS/EOS shift) and times
   ``drivers/train_tvc.make_tvc_train_step`` with
   ``config/train-tvc.json``'s options on 4 videos x 2 captions a step
   (cap_len 62, seg_len 100) as the median of 3 runs of 20 steps after 3
   warm-up steps, the launch counters read from 0 around the runs;
   checks that the loss falls over 20 steps on one batch (dropout off,
   lr 1e-4, warm-up 1), holds one fp32 step on the card against the
   plain path on the CPU (loss, every gradient, every new parameter) and
   one bf16 step through the kernels against the plain attention
   versions on the card, as in 7;
10. the pretraining phase: ``config/pretrain-tv.json`` read through the
   port's options minus its paths (packed 8 x (16 f + 122 t) rows, 100
   frames, 5 queries of 32 tokens, 42 MLM slots a row, 32 videos a
   micro-batch, accumulation 2, the 2:2:1:2 MLM/MFM-NCE/FOM/VSM mix,
   ``drop_svmr_prob`` 0.8) over 256 TV videos with random token ids in
   in-memory stores; holds #1 and #3 at the f-encoder's (256, 138, 768)
   and the VSM queries' (160, 32, 768), #2 at the queries' and #6/#7 at
   img_ln's (4096, 4352), the f-encoder's (35328, 768), the LM head's
   (10752, 768) and the FOM head's (3200, 1536) against their plain
   versions; drives ``drivers/pretrain.run_pretrain`` (the MetaLoader,
   the task datasets, the prefetch to the card, the curriculum,
   validation) at the flagship model, bf16, dropout 0.1: warm-up steps
   until every task has run, then 3 runs of 14 optimizer steps timed on
   the host clock, the launch counters read from 0 around them (prints
   ``pretrain_examples_per_s``, the median, each task's step ms and
   launches per step and the task sequence); holds one step of each of
   MLM, MFM-NCE, MFFR, FOM, VSM, VSM with hard negatives and VSM with one
   sampled negative with every encoder layer rematerialised equal to the
   plain step bit for bit (bf16, dropout on, 8 videos) and times remat
   on and off at 32 videos (step ms, peak memory); holds one bf16 step of
   each, dropout on, through the kernels against the plain attention
   versions (``bf16_step_check``, 8 videos); checks that each task's
   loss falls over 20 steps on one batch (dropout off); and holds one
   fp32 step of each on the card against the CPU (2 + 1 layers, 4
   videos: loss, every gradient, every new parameter);
11. the pretrain_main phase, pretraining as a program: writes those 256
   videos to a sub store and a feature store on disk (the port's
   ``HeroStoreWriter``) and checks that every ``VideoFeatSubTokDataset``
   item read back through the native reader equals the in-memory one
   bit for bit; writes a JAX-layout init checkpoint (``save_params`` of
   the flagship init at another seed); runs ``drivers/pretrain.main`` on
   ``config/pretrain-tv.json`` with the stores, the checkpoint and a
   flagship model config substituted, 6 steps (validation and a model
   checkpoint at 3 and 6, ``restore.npz`` at 4), the launch counters
   from 0 around it (run A); runs it again in another directory, stopped
   by SIGTERM after step 3 (``restore.npz`` must hold step 3), and once
   more to resume to step 6 (run B); checks that A's and B's
   ``model_step_6.npz`` are equal bit for bit, that A's file bridged
   back equals A's final state bit for bit, and that A started from the
   checkpoint (every parameter within 1e-5 of it, the poolers, which no
   loss reads, decayed by ``lr * wd`` a step as JAX's AdamW decays them);
   prints
   a ``pretrain_main`` line (videos/s of A's steps 2, 3 and 6 from disk,
   the card synchronised before and after them only, beside the
   in-memory rate; each save's ms and bytes, the restore's ms, the
   readers, free disk);
12. the tvc_program phase, TVC finetuning and captioning as programs at
   ``config/hero_tvc.json``'s model: keeps pretrain_main's stores and
   run A's last checkpoint (the rest of its files go); writes a caption
   store over 16 of its videos (``cap.db`` with 2-6 captions a video of
   ids from a 10-id band,
   ``clip.db`` with 4 clips a video, ``meta.json``), a reference jsonl
   and a 3-clip ``--target_clip`` jsonl; holds #2 at the program's
   unpacked f-encoder rows (32 of 16 f + 120 t a video:
   ``config/train-tvc.json``'s ``max_txt_len`` 60, ``sub_ctx_len`` 1),
   the train step's (128, 136, 768) with dropout and saved probabilities
   and a validation batch's (256, 136, 768), and #3 at (128, 136, 768)
   against their plain versions; runs ``drivers/train_tvc.main`` on
   ``config/train-tvc.json`` with the paths substituted and pretrain_main's
   checkpoint, 8 steps (validation, which captions every clip in fp32,
   at 8, ``restore.npz`` at 4 and 8), in this process with the launch
   counters from 0 (run A); checks every step's loss finite,
   ``tvc_gen_8.jsonl`` (every clip once, finite scores) and A's last
   model file bridged back equal to its final state; runs it again in
   a subprocess stopped by SIGTERM after step 4 and resumes it with
   ``python -m hero_tpu_torch.drivers.train_tvc`` (run B); checks that
   A's and B's ``model_step_8.npz``, ``restore.npz`` and step-8 captions
   are equal bit for bit; runs ``python -m hero_tpu_torch.drivers.inf_tvc
   --reference`` on A's directory (every clip once, ``METEOR`` and
   ``METEOR_variant`` in the scores file, the captions those of A's
   step-8 validation) and holds its submission equal to
   ``drivers/inf_tvc.main`` in this process (fp32, the launch counters
   from 0); runs ``main`` in bf16, on the ``--target_clip`` jsonl (exactly
   its 3 clips) and with ``--beam 3`` on it; prints a ``tvc_program``
   line (caption rows/s of A's steps 2-3 and 6-7 from disk beside the
   TVC train phase's in-memory rate, each save's ms and bytes, the
   restore's ms, the inf_tvc subprocess's wall s, the fp32 and bf16
   decodes' captions/s, the scores, the launches) and deletes the
   directory;
13. the vcmr_program phase, VCMR and VR finetuning and VR serving as
   programs from the reference checkpoint at ``config/hero_finetune.json``'s
   model: writes pretrain_main's last checkpoint as a reference-layout
   ``.pt`` (``data/testing.reference_state_dict``, the word rows cut to
   RoBERTa's 50265 as in the released ``hero-tv-ht100.pt``, saved as
   ``{"model": sd}``) and holds ``load_checkpoint_into`` of it equal to
   that of the ``.npz`` bit for bit on every key but the 7 padded word
   and LM-bias rows, which are 0, with ``vocab_padded`` True (the load's
   ms and the file's bytes); writes TVR-layout query stores with span
   targets (512 train queries over 192 of the 256 videos, 128 val
   queries over the other 64) and MSR-VTT ones keyed by ``sen_id`` (768
   and 128); holds #2 and #3 at the programs' f-encoder rows against
   their plain versions: TVR's (1024, 77, 768) and MSR-VTT video-only's
   (96, 161, 768), in fp32 and bf16; runs
   ``drivers/train_vcmr.main`` on ``config/train-tvr.json`` with the
   paths substituted, the ``.pt``, 4 steps, validation and checkpoints
   at 4, warm-up 2 and hard negatives from step 2, in this process
   with the launch counters from 0 (run A: every loss finite,
   ``results_{4,8}_all.json`` with VCMR, SVMR and VR, the model file
   marked ``vocab_padded``); again in a subprocess stopped by SIGTERM
   after step 2 and resumed by ``python -m
   hero_tpu_torch.drivers.train_vcmr`` (run B: A's and B's
   ``model_step_4.npz`` and ``restore.npz`` equal bit for bit); ``python
   -m hero_tpu_torch.drivers.eval_vcmr --checkpoint 4`` on A's directory
   (its results equal A's step-4 validation: the same ids, scores within
   1e-4); ``drivers/train_vr.main`` on
   ``config/train-msrvtt_video_only.json`` with the paths substituted,
   the ``.pt``, 4 steps, in this process with the counters from 0; and
   ``drivers/eval_vr.main`` in this process on its directory (VR and no
   VCMR, equal to its step-4 validation; counters from 0); prints a
   ``vcmr_program`` line (queries/s of TVR's steps 2-3 and VR's
   2-3 from disk, each save's ms and bytes, the restore's ms, the
   ``.pt``'s load ms and bytes, the eval_vcmr subprocess's wall s, the
   launches of #1-#7 on each path);
14. the qa_program phase, VideoQA (TVQA) and VIOLIN finetuning and
   inference as programs from vcmr_program's ``.pt`` (which has no QA
   head: the heads start from the seeded init) at
   ``config/hero_finetune.json``'s model: writes TVQA-layout question
   stores over the 256 videos (256 train questions over 192 of them and
   32 val over the other 64, ``[q] + 5 answers`` ids, an answer index
   and a ``ts`` span) and VIOLIN statement stores (192 and 32 ``_0`` /
   ``_1`` pairs, one true); holds #2 and #3 at the program's unpacked
   f-encoder rows (a micro-batch of 4 questions x 5 answers x 32 subs of
   16 frames + 120 tokens: (640, 136, 768)) and at its fused c-encoder
   rows ((20, 132, 768): 100 frames + 32 QA tokens behind the mask
   ``[frames | pad frames | tokens | pad tokens]``, a video of fewer
   than 100 frames in the batch), and #1 and #3 at the ``--pack_subs``
   rows ((160, 200, 768)), in fp32 and bf16, and #6 and #7 at the
   step's LayerNorm widths, against their plain versions; holds one
   fp32 step of the VideoQA loss and one of the VIOLIN loss on the card
   against the CPU (2 + 1 layers, one question or pair on its first 8
   sub rows: the loss, every gradient, every new parameter) and one bf16
   step of each, dropout on, through the kernels against the plain
   attention versions (``bf16_step_check``, 2 questions or pairs), the
   output biases of the
   heads held to analytic bounds (``zero_sum_bound``,
   ``violin_bias_bound``); runs ``drivers/train_videoqa.main`` on
   ``config/train-tvqa.json`` with the paths substituted and the ``.pt``,
   4 steps, validation and checkpoints at 4, in this process with
   the launch counters from 0 (run A: every loss finite, the model file
   marked ``vocab_padded``); again in a subprocess stopped by SIGTERM
   after step 2 and resumed by ``python -m
   hero_tpu_torch.drivers.train_videoqa`` (run B: A's and B's
   ``model_step_4.npz``, ``restore.npz`` and step-4 validation equal bit
   for bit); ``python -m hero_tpu_torch.drivers.eval_videoqa
   --checkpoint 4`` on A's directory (its answers and accuracy equal A's
   step-4 validation); ``drivers/train_violin.main`` on
   ``config/train-violin.json`` with the paths substituted, 4 steps, and
   ``drivers/eval_violin.main`` on its directory, in this process with
   the counters from 0 around each (its predictions and accuracy equal
   the step-4 validation); prints a ``qa_program`` line (questions/s of
   TVQA's steps 2-3 and statement pairs/s of VIOLIN's 2-3 from
   disk, each save's ms and bytes, the restore's ms, the eval_videoqa
   subprocess's wall s, the step checks, the launches of #1-#7 on each
   path);
15. the dp phase, data-parallel training and multi-process serving
   (``hero_tpu_torch/parallel/dist.py``), its ranks subprocesses with
   RANK, WORLD_SIZE and a ``file://`` store in the environment: 2 ranks
   on the one card over gloo (each told ``cuda:0``) hold the VSM train
   step at ``bench.py``'s layout as 2 x 16 videos, the fit bucket, dropout
   off, against the primary's one-process 32-video step from the same
   weights (fp32 by ``step_parity``'s rule, bf16 by
   ``bf16_step_check``'s, the one-process fp32 step the yardstick), take
   2 bf16 steps with dropout 0.1 (every loss finite, the replicas'
   parameters bit-identical, the ranks' first dropout masks different),
   time a step on 2 ranks and on one process and the gradients'
   all-reduce (ms and bytes), hold each mode beyond data parallelism at
   the fit bucket (ZeRO-1 over the 2 ranks; 2 pipeline stages with 2
   micro-batches, 2 tensor-parallel and 2 sequence-parallel ranks of one
   data rank: ``parallel/pipeline.py``, ``parallel/mesh.py``) against
   the same one-process step, fp32 and bf16 with dropout off, time a
   bf16 dropout step of each after a warm-up step (ms, collective and
   transfer bytes, each
   rank's peak memory; ZeRO-1's beside the replicated steps, equal bit
   for bit after every step), then run ``drivers/train_vcmr.main`` on
   ``config/train-tvr.json`` from vcmr_program's ``.pt`` with
   ``distributed_eval``, 4 steps (run A: only the primary writes),
   ``drivers/eval_vcmr.main`` on A's directory, run B: the same run
   with ``--zero1`` and SIGTERM to rank 1 alone after step 2 (both ranks
   stop after step 2), resumed on both ranks in the same processes, A's
   and B's ``model_step_4.npz`` and ``restore.npz`` equal bit for bit,
   and run C: the same run with ``--pp_stages 2`` (the f-encoder
   pipelined, its validation too; every loss finite, its files every
   key and shape of A's); this
   process runs ``eval_vcmr.main`` on A's directory in one process (the
   metrics within the 0.05 of the per-rank rounding, the merged
   submission the one-process one query by query, scores within 1e-4);
   then one rank a card over nccl (a world of 1 on one card) times the
   all-reduce of the gradients' size; this process holds #1-#3, #6 and
   #7 at the modes' shapes against their plain versions; prints a ``dp``
   line (the card, the gloo and nccl times, the modes, the checks, each
   rank's launches of #1-#7, also in the ``kernels`` line);
16. the serving_full phase, VCMR serving in full: runs
   ``validate_full_vcmr`` on the 512 queries and the resident 2000-video
   corpus with ``pack_queries`` (4 segments a row, 64 rows a call: the
   whole set encoded packed, then ranked in batch slices) and one row a
   query, 3 runs each in turns (wall s and queries/s of the whole call,
   packed rows and slot fill, the packed call's launches, whose #1
   launches must exceed the one-row call's and its #2 launches fall
   short of them, and how many queries keep an identical bf16 top-10
   videos); checks in fp32 on the small corpus that the packed call's
   submission keeps the top-10 videos and the VCMR (video, st, ed)
   predictions up to near-ties (``ranked_match``); runs ``validate_full_vcmr`` with
   ``corpus_chunk_videos=500`` (wall s beside the resident main path's),
   and in fp32 on the small corpus in chunks of 10 against the resident
   corpus (every id equal, scores within 1e-4); writes the pretraining phase's 256 videos and 512 synthetic
   queries (``query_data.jsonl`` with them) as herostore databases, a
   ``log/hps.json`` and a flagship ``ckpt/model_step_5.npz`` in the JAX
   layout, runs ``python -m hero_tpu_torch.drivers.eval_vcmr`` on them in
   a subprocess (packed queries on), checks its results file (the
   reference schema, every query once) and holds it and its printed
   metrics equal to ``drivers/eval_vcmr.main`` run in this process with
   the launch counters from 0; prints a ``serving_full`` line;
17. the prepro phase, data preparation with the port: writes the raw
   inputs of 32 TV videos (60-100 frames at 1.5 s; SlowFast (n, 2304)
   and ResNet (n, 2048) float16 ``.npz``; a subtitle jsonl in
   ``data/occupancy.sample_tv_video``'s distribution; 2 TVR queries a
   video; 16 TVQA questions; a TVC clip a video), runs
   ``python -m hero_tpu_torch.prepro.convert_videodb``, ``prepro_sub``,
   ``prepro_query`` (TVR and TVQA) and ``prepro_tvc`` with
   ``--tokenizer hash`` (each timed), checks the stores (the video rows
   the ``.npz`` concatenation bit for bit, the frames partitioned among
   the unique subs and the unmatched frames, the query and QA ids the
   hash tokenizer's, ``emit_sub_len_sidecar`` equal to the prepro-written
   sidecar), sizes a ``--pack_subs`` bucket with ``prepro.suggest_bucket``
   (and the QA and caption budgets with ``suggest_downstream_lens``),
   serves the 64 queries over ``load_data.load_video_sub_dataset`` in
   that bucket through ``train_vcmr.build_eval_inputs`` and
   ``validate_full_vcmr`` in bf16 with the launch counters from 0, checks
   in fp32 that the kernel path ranks 16 of the videos as the plain path
   on the CPU does, and holds #1 at the bucket's f-encoder rows and #2 at
   the c-encoder's against their plain versions; prints a ``prepro``
   line;
18. the components phase (``tools/component_bench.py`` and the DALN
   checks of ``tools/kernel_smoke.py`` and ``tools/tpu_kernel_drive.py``):
   holds #6 and #7 at their edges (``check_ln_edges``: widths 1 to
   14528 about the 16-byte access and the warp's share, rows about the
   backward's row groups, fp32 and bf16, backward repeats bit-identical)
   and #8 and #9 at theirs (``check_daln_edges``: the same widths and
   widths of a part of a Philox quad, rows about #9's row groups, fp32
   and bf16 at rates 0 and 0.1, keep bits read back, views off the
   16-byte alignment, mixed y/x dtypes, repeats bit-identical);
   holds every kernel the components launch against its plain version in
   fp32 and bf16 at the components' shapes: #2 and #3 at the f-encoder's
   (256, 56, 768) with dropout and the c-encoder's (32, 100, 768), #4 and
   #5 at (256, 12, 56, 64) (#5 also causal 31 -> 31 and 62 -> 100, with a
   fully masked row), #6 and #7 at (14336, 768), (3200, 768) and
   (256, 4352), #8 and #9 at (14336, 768) and (256, 4352) (#8/#9's Philox
   bits equal the plain mask, the keep rate lies in its band, a repeat is
   bit-identical, the dropped entries of y do not reach the output), then
   drives every component once with
   the counters from 0 and times it: the FFN matmul pair,
   ``layer_norm``, ``multi_head_attention`` and its plain version,
   ``dropout_add_layer_norm`` and the unfused chain, the 6-layer
   f-encoder with and without dropout and the 3-layer c-encoder,
   forward and forward+backward.

It prints one ``phases`` JSON line, one train JSON line with
``train_examples_per_s``, one TVC JSON line with ``tvc_captions_per_s``,
one TVC train JSON line with ``tvc_train_captions_per_s``, one
``pretrain`` JSON line with ``pretrain_examples_per_s``, one
``pretrain_main`` JSON line, one ``tvc_program`` JSON line, one
``vcmr_program`` JSON line, one ``qa_program`` JSON line, one ``dp``
JSON line, one ``serving_full`` JSON line, one ``prepro`` JSON line, one
``components`` JSON line, one ``kernels`` JSON line (all nine kernels,
launches by path; #6, #7 and #9 with the device ms of their row pass and
of the column pass, from profiler traces, those the run's own traces
missed traced again in a fresh process at the end; #8 and #9 with the unfused chain's ms and their own
at rate 0), the card's name and power limit (nvidia-smi), and as
the last line ``{"ok": true, "device": {...}}``.  ``--profile`` adds
torch.profiler breakdowns of a phase-1 batch, a query batch, one
fit-bucket train step, one greedy TVC batch, one TVC train step, one
optimizer step of each pretraining task and one packed and one unpacked
pass over the 512 queries to the JSON record, and fails if a CUDA-core attention kernel (packed or
head-major) ran in any of these bf16 windows, or if the greedy window ran
no ``mha_attention_mma_kernel``.  ``--times KERNEL [ROOT]`` does nothing
but time one kernel group of the ``hero_tpu_torch`` under ROOT (this
checkout by default, with the library call beside it) and print one JSON
line: run on two checkouts in turns, it compares them on one card.
``daln`` times #8 and #9 at rates 0 and 0.1; ``bwd3`` times #3
(``BWD3_TIME_SHAPES``, fp32 and bf16, dropout 0.1) with each shape's
bound and SDPA's backward; ``fwd`` times #1/#2 (bf16) at every path shape
(``FWD_TIME_SHAPES``) with masks modelled on the path's and with every
key valid, with the share of chunks the skip rule leaves out, and #5
(bf16, dropout 0.1) at ``MHA_BWD_TIME_SHAPES``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA cores, no tensor cores
N_VIDEOS, VIDEO_BS = 2000, 50
N_QUERIES, QUERY_BS, QUERY_SLOTS = 512, 64, 30
PHASE_RUNS = 3                     # timed runs of each phase; median kept


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

SLOW_MS = 5.0      # a call slower than this is timed over fewer calls


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.  A function whose second
    call takes more than ``SLOW_MS`` on the host clock (the plain
    versions with Philox dropout, 5-250 ms) is timed over enough calls
    for ~100 ms, at least 3, after those two.

    A spin kernel holds the card while the host queues the calls, so a
    call whose launch costs the host more than the card's work (the
    30-key attention, the plain versions' many small ops) is timed on the
    card, not at the host's launch rate.  The spin is lengthened until
    the start event is still pending when the last call is queued.  A
    function that launches more kernels than the card's launch queue
    holds (the plain Philox dropout: hundreds of elementwise launches a
    call) blocks the host behind the spin; it is timed without the spin,
    and its card time, far above its launch cost, is then what the
    events measure."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    if once > SLOW_MS:
        iters, warmup = max(3, min(iters, int(100.0 / once))), 2
    for _ in range(warmup - 2):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 22                                   # clock cycles
    while spin <= 1 << 30:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        spin *= 4
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the CUDA-core attention kernels, which only fp32 calls may take
CUDA_CORE_ATTENTION = ("attention_kernel", "attention_bwd_kernel",
                       "mha_attention_kernel", "mha_attention_bwd_kernel")


def _kernel_class(name):
    # the tensor-core kernels (bf16) and the CUDA-core ones (fp32) apart
    if "mha_attention_bwd_mma" in name:
        return "mha_attention_bwd_mma_kernel"
    if "mha_attention_mma" in name:
        return "mha_attention_mma_kernel"
    if "mha_attention_bwd" in name:
        return "mha_attention_bwd_kernel"
    if "mha_attention" in name:
        return "mha_attention_kernel"
    if "packed_attention_bwd" in name and "_mma_kernel" in name:
        return "attention_bwd_mma_kernel"     # #3's dQ and dK/dV kernels
    if "packed_attention_mma" in name:
        return "attention_mma_kernel"
    if "packed_attention_bwd" in name:
        return "attention_bwd_kernel"
    if "packed_attention" in name:
        return "attention_kernel"
    if "layer_norm_bwd" in name:       # the row pass and the column pass
        return "layer_norm_bwd_kernels"
    if "layer_norm_rows" in name:
        return "layer_norm_kernel"
    if any(t in name.lower() for t in ("gemm", "cutlass", "sm90_xmma",
                                       "nvjet", "cublas")):
        return "matmul"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def profile_breakdown(torch, fn, iters=3):
    """Device time of ``fn`` by kernel class over ``iters`` calls, from a
    torch.profiler trace, beside the host wall time of the same window:
    the idle share is 1 - busy / wall (one stream, so kernels do not
    overlap).  Every traced window is a bf16 path, whose attention (packed
    and head-major) must run on the tensor-core kernels: a CUDA-core
    attention kernel in the trace fails the run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_kernel, n_events = {}, {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_events += 1
        ms = ev.time_range.elapsed_us() / 1e3 / iters
        cls = _kernel_class(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_kernel[ev.name[:80]] = by_kernel.get(ev.name[:80], 0.0) + ms
    if not n_events:
        return {"device_events": 0, "note": "the trace holds no device "
                "events: device time not measured"}
    cuda_core = {c for c in CUDA_CORE_ATTENTION if c in by_class}
    if cuda_core:
        raise AssertionError(f"a bf16 window ran the CUDA-core attention "
                             f"kernels {sorted(cuda_core)}: {by_kernel}")
    busy = sum(by_class.values())
    wall_ms = wall * 1e3 / iters
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"device_events": n_events, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_class": by_class, "top_kernels_ms": dict(top)}


TRACE_PADS_S = (0.02, 0.1, 0.3)   # host wait inside each trace of a call,
                                  # before and after; one trace a pad
# the kernels of the LayerNorm calls whose device time kernel_ms_by_name
# splits, by row key: the row pass, and the column pass (the reduction of
# the backward's partials; the forward has none)
SPLIT_PARTS = {
    "layer_norm": {"row_pass_ms": "layer_norm_rows"},
    "layer_norm_bwd": {"row_pass_ms": "layer_norm_bwd_rows",
                       "reduce_ms": "layer_norm_bwd_cols"},
    "daln_bwd": {"row_pass_ms": "layer_norm_bwd_rows",
                 "reduce_ms": "layer_norm_bwd_cols"}}


def kernel_ms_by_name(torch, fn, parts, spec=None, iters=20):
    """Mean device ms of one launch of each kernel whose name holds a
    fragment of ``parts`` ({row key: name fragment}; ``fn`` launches each
    once), from a torch.profiler trace of ``iters`` calls after a
    warm-up, with ``"trace_attempts"``: the traces it took.

    The profiler keeps a device event only inside its capture window, on
    the host's clock.  In a process that has run for minutes, traces have
    been seen to drop every launch of one kernel or of all, one trace in
    two or every trace of a call.  So the window opens a pad of
    ``TRACE_PADS_S`` before the first call and closes as long after the
    card has finished, and a trace that misses a kernel of ``parts`` is
    taken again with the next, longer pad.  If every pad misses, the
    times are None and the result holds ``"split_pending": spec``
    (``[kind of SPLIT_PARTS, n, d, ...]``), which
    :func:`resolve_pending_splits` traces again in a fresh process;
    without ``spec`` it holds ``"trace_events"``, the device events of
    the last trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}
    for attempt, pad in enumerate(TRACE_PADS_S, 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        total = {key: 0.0 for key in parts}
        count = {key: 0 for key in parts}
        seen = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            seen[ev.name[:60]] = seen.get(ev.name[:60], 0) + 1
            for key, frag in parts.items():
                if frag in ev.name:
                    total[key] += ev.time_range.elapsed_us() / 1e3
                    count[key] += 1
        if all(count.values()):
            return {**{key: total[key] / count[key] for key in parts},
                    "trace_attempts": attempt}
    missed = {key: None for key in parts}
    if spec is not None:
        return {**missed, "trace_attempts": len(TRACE_PADS_S),
                "split_pending": list(spec)}
    return {**missed, "trace_attempts": len(TRACE_PADS_S),
            "trace_events": seen}


SPLIT_PROBE = """
import json, sys
from chip_smoke import split_probe
print(json.dumps(split_probe(json.loads(sys.argv[1]))))
"""


def split_probe(specs):
    """:func:`kernel_ms_by_name` of each spec's call, in this process, on
    seeded bf16 inputs of the spec's shape (the kernels' time does not
    depend on the values)."""
    import torch
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    out = []
    for kind, n, d, *rest in specs:
        gen = torch.Generator(device=dev).manual_seed(n + d)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        y, x, g = (torch.randn((n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        fn = {"layer_norm": lambda: lnm.layer_norm_cuda(x, w, b),
              "layer_norm_bwd": lambda: lnm.layer_norm_bwd_cuda(x, w, g),
              "daln_bwd": lambda: lnm.dropout_add_layer_norm_bwd_cuda(
                  y, x, w, g, *rest)}[kind]
        out.append(kernel_ms_by_name(torch, fn, SPLIT_PARTS[kind]))
        del y, x, g
    return out


def resolve_pending_splits(record, here):
    """Trace again, in one fresh process, the calls of every row of
    ``record`` that :func:`kernel_ms_by_name` left ``"split_pending"``,
    and fill their times in (``"split_traced_in"``: ``"a fresh
    process"``).  The run fails if the fresh process's trace of a call
    holds device events but none of a kernel it names; a trace that
    holds no device event at all leaves the times None, with the reason
    in ``"split_not_measured"``.  Returns the number of pending rows."""
    rows = []

    def walk(node):
        if isinstance(node, dict):
            if "split_pending" in node:
                rows.append(node)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(record)
    if not rows:
        return 0
    specs = sorted({json.dumps(r["split_pending"]) for r in rows})
    proc = subprocess.run([sys.executable, "-c", SPLIT_PROBE,
                           json.dumps([json.loads(s) for s in specs])],
                          cwd=here, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh process tracing the splits exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    found = dict(zip(specs, json.loads(proc.stdout.strip().splitlines()[-1])))
    for row in rows:
        spec = row.pop("split_pending")
        got = dict(found[json.dumps(spec)])
        events = got.pop("trace_events", None)
        if events:
            raise AssertionError(f"{spec}: traces in a fresh process held "
                                 f"device events but not every kernel of "
                                 f"{SPLIT_PARTS[spec[0]]}: {events}")
        if events is not None:
            row["split_not_measured"] = (
                f"{got['trace_attempts']} traces in the run's process and "
                f"as many in a fresh one held no device event")
        row["trace_attempts"] += got.pop("trace_attempts")
        row.update(got, split_traced_in="a fresh process")
    return len(rows)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def _bf16_tol(ref):
    # kernel and plain version read the same bf16 inputs, compute in fp32
    # and round once: they differ by at most one bf16 ulp of the output,
    # <= 2^-7 * max|out|
    return float(ref.float().abs().max()) * 2.0 ** -7


def check_attention(torch, F, att, B, L, D, H, mask, seg_mode,
                    timing_dtype):
    """Hold the attention kernel against ``packed_reference`` at (B, L, D)
    with the path's own mask / segment ids; row 0 fully masked."""
    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(B * L)
    mask = mask.clone()
    mask[0] = -1 if seg_mode else 0            # fully masked row
    kw = {"seg": mask} if seg_mode else {"kv_mask": mask}
    launch = att.seg_attention_cuda if seg_mode else att.valid_attention_cuda
    rows, record = {}, {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-4,
             "fp32: reassociated 64-term dots and <=104-term softmax/P.V "
             "sums, ~200 ulp at |out|~4"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        out = launch(q, k, v, H, mask)[0]
        ref = att.packed_reference(q, k, v, H, **kw)
        err = float((out.float() - ref.float()).abs().max())
        tol = tol_fn(ref)
        # the fully masked row: the -1e4 added to every key cancels in the
        # softmax, so the row is finite and equals unmasked attention up to
        # the fp32 rounding of s - 1e4 (half an ulp of 1e4 = 2^-11 in s,
        # ~2^-10 relative in the probabilities)
        free = att.packed_reference(q[:1], k[:1], v[:1], H)[0]
        row_err = float((out[0].float() - free.float()).abs().max())
        row_tol = 2.0 ** -9 * float(v[0].float().abs().max()) + tol
        rec = {"max_abs_err": err, "tol": tol, "tol_reason": why,
               "masked_row_err": row_err, "masked_row_tol": row_tol}
        ok = (err <= tol and row_err <= row_tol
              and bool(torch.isfinite(out).all()))
        if dtype == torch.float32:
            # the plain version on the card can round exactly as the
            # kernel does (same fma order in cuBLAS, the same warp-shuffle
            # softmax); the CPU's sums are another order altogether
            cpu = att.packed_reference(
                *(t.cpu() for t in (q, k, v)), H,
                **{n: m.cpu() for n, m in kw.items()})
            rec["cpu_plain_err"] = float((out.cpu() - cpu).abs().max())
            ok = ok and rec["cpu_plain_err"] <= tol
        rec["ok"] = ok
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v, ref)
        if not ok:
            raise AssertionError(f"attention {[B, L, D]} {dtype}: {rec}")
    q, k, v, _ = rows[timing_dtype]
    ms = time_ms(torch, lambda: launch(q, k, v, H, mask))
    plain_ms = time_ms(torch, lambda: att.packed_reference(q, k, v, H, **kw))
    d = D // H
    if seg_mode:
        allowed = (mask[:, :, None] == mask[:, None, :]) & (mask >= 0)[:, :,
                                                                      None]
    else:
        allowed = (mask[:, None, :] > 0).expand(B, L, L)
    bias = torch.where(allowed, 0.0, -1e4).to(q.dtype)[:, None]

    def heads(t):
        return t.view(B, L, H, d).transpose(1, 2)

    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=bias))
    elt = q.element_size()
    n_bytes = 4 * B * L * D * elt + B * L * 4
    n_flops = 4 * B * H * L * L * d
    b_ms, by = bound_ms(n_bytes, n_flops, str(timing_dtype).split(".")[1])
    return {"shape": [B, L, D], "heads": H, "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_layer_norm(torch, F, lnm, n, d, x_bf16):
    dev = x_bf16.device
    gen = torch.Generator(device=dev).manual_seed(n + d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    record = {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-4,
             "fp32: reassociated row sums of up to 4352 terms"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        x = x_bf16.to(dtype)
        out = lnm.layer_norm_cuda(x, w, b)
        ref = lnm.layer_norm_reference(x, w, b)
        err = float((out.float() - ref.float()).abs().max())
        tol = tol_fn(ref)
        record[str(dtype).split(".")[1]] = {"max_abs_err": err, "tol": tol,
                                            "tol_reason": why,
                                            "ok": err <= tol}
        if err > tol:
            raise AssertionError(f"layer_norm {[n, d]} {dtype}: err "
                                 f"{err:.3g} (tol {tol:.3g})")
    x = x_bf16
    ms = time_ms(torch, lambda: lnm.layer_norm_cuda(x, w, b))
    split = kernel_ms_by_name(torch, lambda: lnm.layer_norm_cuda(x, w, b),
                              SPLIT_PARTS["layer_norm"], ["layer_norm", n, d])
    plain_ms = time_ms(torch, lambda: lnm.layer_norm_reference(x, w, b))
    w16, b16 = w.to(x.dtype), b.to(x.dtype)
    lib_ms = time_ms(torch, lambda: F.layer_norm(x, (d,), w16, b16, 1e-5))
    # ~8 fp32 operations per element on the CUDA cores (no tensor-core
    # work): two passes of sums, the centring, the scale and the affine
    b_ms, by = bound_ms(2 * n * d * x.element_size() + 2 * d * 4,
                        8 * n * d, "float32")
    return {"shape": [n, d], "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "reduce_ms": None, **split}


# the LayerNorm rows' device ms of the row pass and of the column pass
# (the reduction of the backward's partials; None for the forward, which
# has none), from a profiler trace beside the event timing, the traces
# that took, and, where the run's own traces missed a kernel, the mark
# that resolve_pending_splits reads and what it found (kernel_ms_by_name)
SPLIT_KEYS = ("row_pass_ms", "reduce_ms", "trace_attempts", "split_pending",
              "split_traced_in", "split_not_measured")
# #8/#9's rows also carry the unfused chain's ms and their own at rate 0
DALN_KEYS = ("chain_ms", "rate0_ms")


def check_kernels(torch, first_batch, query_masks, packed_calls, cfg):
    """Every kernel of the path at the path's shapes (bf16 timings);
    ``packed_calls``: the segment ids of the first and the last call of
    packed query rows (the last holds the partial rows and the all-pad
    rows that pad the row count to a whole call)."""
    import torch.nn.functional as F
    from hero_tpu_torch.models.model import gather_sub_frames
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads
    b = {k: torch.from_numpy(v).to(dev) for k, v in first_batch.items()}
    B, S, Lt = b["sub_input_ids"].shape
    Fs = b["sub_frame_idx"].shape[2]
    seg = torch.cat([b["sub_frame_seg"], b["sub_txt_seg"]],
                    dim=2).reshape(B * S, Fs + Lt)
    qm = torch.from_numpy(query_masks).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the two 4352-wide LayerNorm inputs: the gathered per-slot frame
    # features (img_ln) and the clip features (frame_transform)
    feats = b["c_v_feats"].reshape(-1, cfg.vfeat_dim)
    img_rows = (gather_sub_frames(b["c_v_feats"], b["sub_frame_idx"])
                * b["sub_frame_mask"][..., None].half()
                ).reshape(-1, cfg.vfeat_dim)
    # one entry per kernel; its first shape is the one its top-level
    # numbers are taken at, every shape is checked and timed
    kernels = [
        ("attention_seg", "attention.cu", "attention.py:304",
         "_fwd3_seg_kernel", "seg_attention_cuda",
         "F.scaled_dot_product_attention, additive mask",
         [check_attention(torch, F, att, B * S, Fs + Lt, D, H, seg, True,
                          torch.bfloat16),
          *(check_attention(torch, F, att, seg_ids.shape[0],
                            seg_ids.shape[1], D, H,
                            torch.from_numpy(seg_ids).to(dev), True,
                            torch.bfloat16) | {"mode": f"packed queries, "
                                                       f"{which} call"}
            for which, seg_ids in zip(("first", "last"), packed_calls))]),
        ("attention_valid", "attention.cu", "attention.py:277",
         "_fwd3_kernel", "valid_attention_cuda",
         "F.scaled_dot_product_attention, additive mask",
         [check_attention(torch, F, att, B, b["c_attn_masks"].shape[1], D,
                          cfg.c_config.num_attention_heads,
                          b["c_attn_masks"], False, torch.bfloat16),
          check_attention(torch, F, att, qm.shape[0], qm.shape[1], D, H, qm,
                          False, torch.bfloat16)]),
        ("layer_norm", "layernorm.cu", "layernorm.py:53", "_fwd_kernel",
         "layer_norm_cuda", "F.layer_norm (bf16 weights)",
         [check_layer_norm(torch, F, lnm, feats.shape[0], cfg.vfeat_dim,
                           feats.to(torch.bfloat16)),
          check_layer_norm(torch, F, lnm, img_rows.shape[0], cfg.vfeat_dim,
                           img_rows.to(torch.bfloat16)),
          check_layer_norm(torch, F, lnm, B * S * (Fs + Lt), D,
                           torch.randn((B * S * (Fs + Lt), D), generator=gen,
                                       device=dev).to(torch.bfloat16))]),
    ]
    out = []
    for name, src, tpu, tpu_fn, counter, lib_call, shapes in kernels:
        main = shapes[0]
        out.append({"name": name, "route": "cuda",
                    "source": f"hero_tpu_torch/ops/csrc/{src}",
                    "replaces": f"hero_tpu/ops/{tpu}", "tpu_kernel": tpu_fn,
                    "counter": counter, "library_call": lib_call,
                    **{k: main[k] for k in (
                        "shape", "dtype", "max_abs_err", "tol", "ms",
                        "plain_ms", "bound_ms", "bound_by", "library_ms")},
                    **{k: main[k] for k in SPLIT_KEYS if k in main},
                    "shapes": shapes})
    return out


# ---------------------------------------------------------------------------
# training kernel checks
# ---------------------------------------------------------------------------

TRAIN_SEED = 2 ** 33 + 12345       # Philox key of the kernel checks
# the kernels the train steps (VSM and TVC) launch, and the components
TRAIN_KERNELS = ("seg_attention_cuda", "valid_attention_cuda",
                 "attention_bwd_cuda", "layer_norm_cuda",
                 "layer_norm_bwd_cuda")
COMPONENT_KERNELS = ("valid_attention_cuda", "attention_bwd_cuda",
                     "mha_attention_cuda", "mha_attention_bwd_cuda",
                     "layer_norm_cuda", "layer_norm_bwd_cuda",
                     "dropout_add_layer_norm_cuda",
                     "dropout_add_layer_norm_bwd_cuda")
TRAIN_RATE = 0.1                   # the model's dropout rate


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _train_tol(ref, dtype):
    """fp32: sums of <= 144 products (attention) or <= 4352 terms (LN)
    taken in other orders, ~1e-4 of the largest value; bf16: both sides
    read the same bf16 inputs, compute in fp32 and round once: one bf16
    ulp of the largest value."""
    top = float(ref.float().abs().max())
    if dtype == "float32":
        return 1e-4 * max(1.0, top)
    return top * 2.0 ** -7


def check_attention_train(torch, F, att, B, L, D, H, mask, seg_mode):
    """The forward with dropout and saved probabilities and the backward
    kernel, in fp32 and bf16, at rate 0 and 0.1, against the plain
    versions on the same inputs, the saved p exactly 0 wherever the plain
    p is; determinism; bf16 timings at rate 0.1; the share of chunks the
    skip rule leaves out at this mask (``skip_share``)."""
    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(7 * B + L)
    kw = {"seg": mask} if seg_mode else {"kv_mask": mask}
    launch = att.seg_attention_cuda if seg_mode else att.valid_attention_cuda
    d = D // H
    checks, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        dout = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
        for rate in (0.0, TRAIN_RATE):
            out, probs = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)
            ref, rprobs = att.packed_forward_reference(
                q, k, v, H, dropout_rate=rate, seed=TRAIN_SEED,
                save_probs=True, **kw)
            grads = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            rgrads = att.packed_backward_reference(probs, q, k, v, dout, H,
                                                   rate, TRAIN_SEED)
            again = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            out2 = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)[0]
            rec = {"fwd_err": _err(out, ref), "fwd_tol": _train_tol(ref, name),
                   "probs_err": _err(probs, rprobs),
                   "probs_tol": _train_tol(rprobs, name),
                   # the forward skips chunks no row of a tile attends:
                   # its p is exactly 0 wherever the plain p is
                   "zeros_exact": bool(((rprobs == 0) <= (probs == 0)).all()),
                   "bwd_err": max(_err(a, b) for a, b in zip(grads, rgrads)),
                   "bwd_tol": min(_train_tol(b, name) for b in rgrads),
                   "deterministic": bool(torch.equal(out, out2) and all(
                       torch.equal(a, b) for a, b in zip(grads, again)))}
            rec["ok"] = (rec["fwd_err"] <= rec["fwd_tol"]
                         and rec["probs_err"] <= rec["probs_tol"]
                         and rec["zeros_exact"]
                         and rec["bwd_err"] <= rec["bwd_tol"]
                         and rec["deterministic"]
                         and all(bool(torch.isfinite(g).all())
                                 for g in grads))
            checks[f"{name}_rate{rate}"] = rec
            if not rec["ok"]:
                raise AssertionError(f"attention training kernels "
                                     f"{[B, L, D]} {name} rate {rate}: "
                                     f"{rec}")
        rows[name] = (q, k, v, dout)
    q, k, v, dout = rows["bfloat16"]
    rate = TRAIN_RATE
    probs = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)[1]
    fwd_ms = time_ms(torch, lambda: launch(q, k, v, H, mask, rate,
                                           TRAIN_SEED, True))
    fwd_plain = time_ms(torch, lambda: att.packed_forward_reference(
        q, k, v, H, dropout_rate=rate, seed=TRAIN_SEED, save_probs=True,
        **kw))
    bwd_ms = time_ms(torch, lambda: att.attention_bwd_cuda(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    bwd_plain = time_ms(torch, lambda: att.packed_backward_reference(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    if seg_mode:
        allowed = ((mask[:, :, None] == mask[:, None, :])
                   & (mask >= 0)[:, :, None])
    else:
        allowed = (mask[:, None, :] > 0).expand(B, L, L)
    bias = torch.where(allowed, 0.0, -1e4).to(q.dtype)[:, None]

    def heads(t):
        return t.reshape(B, L, H, d).transpose(1, 2).detach(
            ).requires_grad_(True)

    hq, hk, hv = heads(q), heads(k), heads(v)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias,
                                                 dropout_p=rate)
    hdo = dout.reshape(B, L, H, d).transpose(1, 2)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        hq.detach(), hk.detach(), hv.detach(), attn_mask=bias,
        dropout_p=rate))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (hq, hk, hv), hdo, retain_graph=True))
    elt = q.element_size()
    p_bytes = B * H * L * L * elt
    fb, fby = bound_ms(4 * B * L * D * elt + B * L * 4 + p_bytes,
                       4 * B * H * L * L * d, "bfloat16")
    bb, bby = bound_ms(p_bytes + 7 * B * L * D * elt, 8 * B * H * L * L * d,
                       "bfloat16")
    bf = checks["bfloat16_rate0.1"]
    return (
        {"shape": [B, L, D], "mode": "train: dropout 0.1, probs saved",
         "max_abs_err": bf["fwd_err"], "tol": bf["fwd_tol"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fb, "bound_by": fby,
         "library_ms": lib_fwd, "checks": checks,
         "skip_share": skip_share(np, mask.cpu().numpy(), L, False,
                                  seg_mode)},
        {"shape": [B, L, D], "heads": H, "dtype": "bfloat16",
         "mask": "segment" if seg_mode else "validity",
         "max_abs_err": bf["bwd_err"], "tol": bf["bwd_tol"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bb, "bound_by": bby,
         "library_ms": lib_bwd, "checks": checks})


def check_dropout_masks(torch, att, drop, shape):
    """The keep mask the kernels draw equals the plain Philox mask, keeps
    Bernoulli(0.9) within 4 sigma, and is the same for one seed."""
    B, H, L = shape
    dev = torch.device("cuda")
    got = att.dropout_keep_mask_cuda(TRAIN_SEED, B, H, L, L, TRAIN_RATE, dev)
    want = drop.attention_keep_mask(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                    device=dev)
    again = att.dropout_keep_mask_cuda(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                       dev)
    n = got.numel()
    keep = float(got.float().mean())
    sigma = (TRAIN_RATE * (1 - TRAIN_RATE) / n) ** 0.5
    rec = {"shape": [B, H, L, L], "identical_to_plain": bool(
        torch.equal(got, want)), "keep_rate": keep, "sigma": sigma,
        "same_for_one_seed": bool(torch.equal(got, again))}
    rec["ok"] = (rec["identical_to_plain"] and rec["same_for_one_seed"]
                 and abs(keep - (1 - TRAIN_RATE)) <= 4 * sigma)
    if not rec["ok"]:
        raise AssertionError(f"dropout mask: {rec}")
    return rec


def check_layer_norm_bwd(torch, F, lnm, n, d):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n + 3 * d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    x32 = torch.randn((n, d), generator=gen, device=dev) * 2.0 + 0.5
    g32 = torch.randn((n, d), generator=gen, device=dev)
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        x, g = x32.to(dtype), g32.to(dtype)
        got = lnm.layer_norm_bwd_cuda(x, w, g)
        want = lnm.layer_norm_bwd_reference(x, w, g)
        again = lnm.layer_norm_bwd_cuda(x, w, g)
        rec = {"dx_err": _err(got[0], want[0]),
               "dx_tol": _train_tol(want[0], name),
               "dwdb_err": max(_err(got[1], want[1]), _err(got[2], want[2])),
               # fp32 sums of n terms |g xhat| <~ 8 in another order
               "dwdb_tol": 1e-6 * n,
               "deterministic": all(bool(torch.equal(a, b))
                                    for a, b in zip(got, again))}
        rec["ok"] = (rec["dx_err"] <= rec["dx_tol"]
                     and rec["dwdb_err"] <= rec["dwdb_tol"]
                     and rec["deterministic"])
        checks[name] = rec
        if not rec["ok"]:
            raise AssertionError(f"layer_norm backward {[n, d]} {name}: "
                                 f"{rec}")
    x, g = x32.to(torch.bfloat16), g32.to(torch.bfloat16)
    ms = time_ms(torch, lambda: lnm.layer_norm_bwd_cuda(x, w, g))
    split = kernel_ms_by_name(torch, lambda: lnm.layer_norm_bwd_cuda(x, w, g),
                              SPLIT_PARTS["layer_norm_bwd"],
                              ["layer_norm_bwd", n, d])
    plain_ms = time_ms(torch, lambda: lnm.layer_norm_bwd_reference(x, w, g))
    xl = x.detach().requires_grad_(True)
    wl = w.to(x.dtype).requires_grad_(True)
    bl = torch.zeros_like(wl).requires_grad_(True)
    with torch.enable_grad():
        y = F.layer_norm(xl, (d,), wl, bl, 1e-5)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        y, (xl, wl, bl), g, retain_graph=True))
    # read x and g, write dx (bf16); w read and dw/db written in fp32;
    # ~12 fp32 operations per element on the CUDA cores
    b_ms, by = bound_ms(3 * n * d * x.element_size() + 3 * d * 4,
                        12 * n * d, "float32")
    return {"shape": [n, d], "dtype": "bfloat16",
            "max_abs_err": checks["bfloat16"]["dx_err"],
            "tol": checks["bfloat16"]["dx_tol"], "checks": checks, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, **split}


def check_train_kernels(torch, b_fit, b_over, cfg, kernels):
    """Every kernel of the train step at its shapes.  Adds the training
    forward shapes to the forward kernels' rows of ``kernels`` and returns
    the rows of the two backward kernels."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import dropout as drop
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads

    def seg_of(b):
        B, S, Lt = b["sub_input_ids"].shape
        Fs = b["sub_frame_idx"].shape[2]
        seg = np.concatenate([b["sub_frame_seg"], b["sub_txt_seg"]], 2)
        return torch.from_numpy(seg.reshape(B * S, Fs + Lt)).to(dev)

    qm = b_fit["query_attn_masks"]
    qm = torch.from_numpy(qm.reshape(-1, qm.shape[-1])).to(dev)
    cm = torch.from_numpy(b_fit["c_attn_masks"]).to(dev)
    fwd, bwd = {"attention_seg": [], "attention_valid": []}, []
    for key, mask, seg_mode in (
            ("attention_seg", seg_of(b_fit), True),
            ("attention_seg", seg_of(b_over), True),
            ("attention_valid", cm, False),
            ("attention_valid", qm, False)):
        f_row, b_row = check_attention_train(
            torch, F, att, mask.shape[0], mask.shape[1], D, H, mask,
            seg_mode)
        fwd[key].append(f_row)
        bwd.append(b_row)
    for row in kernels:
        if row["name"] in fwd:
            row["shapes"] += fwd[row["name"]]
    masks = check_dropout_masks(torch, att, drop, (128, H, 104))
    B, S = b_fit["sub_mask"].shape
    Fs_fit = b_fit["sub_frame_idx"].shape[2]
    F_ = b_fit["c_attn_masks"].shape[1]
    Lf = b_fit["sub_input_ids"].shape[2] + Fs_fit
    Lo = b_over["sub_input_ids"].shape[2] + b_over["sub_frame_idx"].shape[2]
    ln = [check_layer_norm_bwd(torch, F, lnm, n, d) for n, d in (
        (B * F_, cfg.vfeat_dim),                 # frame_transform LN
        (B * S * Fs_fit, cfg.vfeat_dim),         # img_ln, fit bucket
        (B * S * Lf, D),                         # f-encoder LNs, fit
        (B * S * Lo, D))]                        # f-encoder LNs, overflow
    return [
        {"name": "attention_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/attention.cu",
         "replaces": "hero_tpu/ops/attention.py:342",
         "tpu_kernel": "_bwd3_kernel", "counter": "attention_bwd_cuda",
         "library_call": "autograd of F.scaled_dot_product_attention "
                         "(additive mask, dropout_p 0.1): its backward",
         **{k: bwd[0][k] for k in (
             "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "shapes": bwd, "dropout_masks": masks},
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/layernorm.cu",
         "replaces": "hero_tpu/ops/layernorm.py:64",
         "tpu_kernel": "_bwd_kernel", "counter": "layer_norm_bwd_cuda",
         "library_call": "autograd of F.layer_norm (bf16 weights): its "
                         "backward",
         **{k: ln[0][k] for k in (
             "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms") + SPLIT_KEYS
            if k in ln[0]},
         "shapes": ln}]


# Shapes at the packed kernels' tile edges (16-key chunks, 16-row warp
# tiles, 64-row blocks, the bf16 forward's whole-head limit of 112 keys
# and its streamed 48- and 112-key tiles, the fp32 forward's and the
# backward's 64-row tiles): key counts, the
# old fp32 forward's limit at head_dim 64 (417 keys), and rows at and past
# the ceilings the backward had before it streamed its tiles (fp32 154,
# bf16 240) and the bf16 forward's (752 keys at head_dim 64); fp32 at
# ``EDGE_F32`` of them.
EDGE_KEYS = (1, 17, 63, 65, 112, 113, 200, 417)
EDGE_BWD = (154, 240, 241, 256, 400, 753, 1024)
EDGE_F32 = (113, 753, 1024)


def _edge_segments(B, L, seed):
    """Segment ids (B, L): runs of 3-20 slots with -1 pad slots between."""
    r = np.random.RandomState(seed)
    seg = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos, s = int(r.randint(0, 3)), 0
        while pos < L - 3:
            n = int(r.randint(3, 21))
            seg[b, pos:pos + n] = s
            pos, s = pos + n + int(r.randint(0, 3)), s + 1
    return seg


def check_packed_edges(torch, att, drop):
    """The packed forward (#1/#2) and backward (#3) at the tile-edge
    shapes, 12 heads of 64 (the flagship's) at every length, against the plain versions on the same inputs, with the
    train tolerances (one bf16 ulp of the largest value; fp32 1e-4 of
    it): self-attention at every ``EDGE_KEYS`` and ``EDGE_BWD`` length in
    both mask modes, and the causal bias over each of those key counts
    with a third as many query rows, rate 0 and 0.1, the forward kernel's
    saved probabilities (past the 752 keys it once refused) exactly 0
    wherever the plain ones are and fed to the backward, batch row 0
    fully masked (finite), in bf16 and (at ``EDGE_F32``) fp32; one query
    over each key count (Lq = 1); and the keep bits read back from the
    kernels (value rows e_j give drop(p), output-gradient rows e_i give
    dv = drop(p)^T) equal to the plain Philox mask."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    H, d = 12, 64
    D = H * d
    gen = torch.Generator(device=dev).manual_seed(91)
    rows = []

    def one(B, Lq, Lk, seg_mode, rate, causal=False, dtype=torch.bfloat16):
        name = str(dtype).split(".")[1]
        q = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        kv = torch.randn((B, Lk, 3 * D), generator=gen, device=dev).to(dtype)
        k, v = kv[..., :D], kv[..., D:2 * D]
        if seg_mode:
            qkv = torch.cat([q, kv[..., :2 * D]], -1)
            q, k, v = qkv.split(D, dim=-1)      # strided self-attention
            mask = torch.from_numpy(_edge_segments(B, Lk, Lk)).to(dev)
            mask[0] = -1
            kw = {"seg": mask}
            launch = att.seg_attention_cuda
        else:
            lens = torch.randint(1, Lk + 1, (B, 1), generator=gen,
                                 device=dev)
            mask = (torch.arange(Lk, device=dev)[None] < lens).float()
            mask[0] = 0.0
            kw = {"kv_mask": mask, "causal": causal}
            launch = functools.partial(att.valid_attention_cuda,
                                       causal=causal)
        ref, probs = att.packed_forward_reference(
            q, k, v, H, dropout_rate=rate, seed=TRAIN_SEED, save_probs=True,
            **kw)
        rec = {"shape": [B, Lq, Lk, D], "dtype": name,
               "mask": "segment" if seg_mode else "validity",
               "causal": causal, "rate": rate}
        out, probs_k = launch(q, k, v, H, mask, rate, TRAIN_SEED, True)
        rec.update(fwd_err=_err(out, ref), fwd_tol=_train_tol(ref, name),
                   probs_err=_err(probs_k, probs),
                   probs_tol=_train_tol(probs, name),
                   zeros_exact=bool(((probs == 0) <= (probs_k == 0)).all()))
        ok = (rec["fwd_err"] <= rec["fwd_tol"]
              and rec["probs_err"] <= rec["probs_tol"]
              and rec["zeros_exact"] and bool(torch.isfinite(out).all()))
        dout = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        grads = att.attention_bwd_cuda(probs_k, q, k, v, dout, H, rate,
                                       TRAIN_SEED)
        rgrads = att.packed_backward_reference(probs_k, q, k, v, dout, H,
                                               rate, TRAIN_SEED)
        again = att.attention_bwd_cuda(probs_k, q, k, v, dout, H, rate,
                                       TRAIN_SEED)
        rec["bwd_err"] = max(_err(a, b) for a, b in zip(grads, rgrads))
        rec["bwd_tol"] = min(_train_tol(b, name) for b in rgrads)
        rec["deterministic"] = all(torch.equal(a, b)
                                   for a, b in zip(grads, again))
        rec["ok"] = (ok and rec["bwd_err"] <= rec["bwd_tol"]
                     and rec["deterministic"]
                     and all(bool(torch.isfinite(g).all()) for g in grads))
        rows.append(rec)
        if not rec["ok"]:
            raise AssertionError(f"packed attention edge shape: {rec}")

    for L in EDGE_KEYS + EDGE_BWD:
        for dtype in ((torch.bfloat16, torch.float32) if L in EDGE_F32
                      else (torch.bfloat16,)):
            for rate in (0.0, TRAIN_RATE):
                for seg_mode in (False, True):
                    one(2, L, L, seg_mode, rate, dtype=dtype)
                one(2, max(1, L // 3), L, False, rate, True, dtype)
    for Lk in EDGE_KEYS:
        one(4, 1, Lk, False, TRAIN_RATE)

    B, L = 2, 60
    q, k, _ = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(
        torch.bfloat16).split(D, dim=-1)
    v = torch.eye(L, d, device=dev, dtype=torch.bfloat16).repeat(
        1, H).expand(B, L, D)
    keep = drop.attention_keep_mask(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                    device=dev)
    out, probs = att.valid_attention_cuda(
        q, k, v, H, torch.ones((B, L), device=dev), TRAIN_RATE, TRAIN_SEED,
        True)
    dv = att.attention_bwd_cuda(probs, q, k, v, v, H, TRAIN_RATE,
                                TRAIN_SEED)[2]
    fwd_bits = out.view(B, L, H, d).transpose(1, 2)[..., :L] != 0
    bwd_bits = dv.view(B, L, H, d).transpose(1, 2)[..., :L] != 0
    masks = {"shape": [B, H, L, L],
             "forward_equals_plain": bool(torch.equal(fwd_bits, keep)),
             "backward_equals_plain": bool(torch.equal(
                 bwd_bits, keep.transpose(-1, -2)))}
    if not (masks["forward_equals_plain"]
            and masks["backward_equals_plain"]):
        raise AssertionError(f"packed attention keep bits: {masks}")
    torch.cuda.synchronize()
    return {"cases": rows, "n_cases": len(rows), "keep_bits": masks,
            "seconds": time.perf_counter() - t0}


# Shapes at the bf16 head-major kernels' tile edges (16-key chunks, 64-key
# streamed tiles, 16-row warp tiles, 64-row forward blocks): every query
# count of MHA_EDGE_QUERIES over every key count of MHA_EDGE_KEYS at
# head_dim 64, and (B, H, Lq, Lk, head_dim, causal, backward, dtype)
# beside them: a forward past the packed forward's old 752 keys, head_dim
# 32 and 128, the backward at and past the ceilings of the whole-head
# kernels it replaced (fp32 154 rows, bf16 400 at head_dim 64 and 208 at
# 128) to 1024 rows, and the fp32 forward past its old 14,464 keys.
MHA_EDGE_KEYS = (1, 16, 17, 64, 65, 129)
MHA_EDGE_QUERIES = (1, 16, 17, 65)
MHA_EDGE_EXTRA = ((2, 2, 3, 1000, 64, False, False, "bfloat16"),
                  (3, 2, 17, 65, 32, True, True, "bfloat16"),
                  (3, 2, 17, 65, 128, True, True, "bfloat16"),
                  (2, 4, 154, 154, 64, True, True, "bfloat16"),
                  (2, 2, 400, 400, 64, False, True, "bfloat16"),
                  (2, 2, 401, 401, 64, True, True, "bfloat16"),
                  (2, 2, 1024, 1024, 64, False, True, "bfloat16"),
                  (2, 2, 208, 208, 128, True, True, "bfloat16"),
                  (2, 2, 209, 209, 128, False, True, "bfloat16"),
                  (2, 2, 401, 401, 64, True, True, "float32"),
                  (2, 2, 1024, 1024, 64, False, True, "float32"),
                  (2, 2, 1, 14465, 64, False, False, "float32"))


def check_mha_edges(torch, att, drop):
    """The head-major forward (#4) and backward (#5) at their tile edges,
    against the plain versions on the same inputs with the train
    tolerances (one bf16 ulp of each output's largest value; fp32 1e-4
    of it), at rate 0 and 0.1: every ``MHA_EDGE_QUERIES`` x
    ``MHA_EDGE_KEYS`` pair at head_dim 64, causal and not, in bf16, and
    ``MHA_EDGE_EXTRA`` in its dtypes; the last batch
    row fully masked (finite, and the unmasked attention up to the
    rounding of s - 1e4, as in :func:`check_mha` and
    :func:`check_mha_bwd`); every backward repeated bit for bit; and the
    keep bits read back from both kernels (value rows e_j give drop(p),
    output-gradient rows e_i give dv = drop(p)^T) equal to the plain
    Philox mask."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(93)
    rows = []

    def over_tol(got, want, name):
        # the worst |got - want| / the tolerance of max |want| of the
        # outputs; a gradient that is exactly 0 (one key: dq) must be 0
        return max(_err(a, w) / max(_train_tol(w, name), 1e-30)
                   for a, w in zip(got, want))

    def one(B, H, Lq, Lk, d, causal, rate, backward, name="bfloat16"):
        dt = getattr(torch, name)
        q, g = (torch.randn((B, H, Lq, d), generator=gen, device=dev).to(dt)
                for _ in range(2))
        k, v = (torch.randn((B, H, Lk, d), generator=gen, device=dev).to(dt)
                for _ in range(2))
        lens = torch.randint(1, Lk + 1, (B, 1), generator=gen, device=dev)
        mask = (torch.arange(Lk, device=dev)[None] < lens).float()
        mask[-1] = 0.0
        out = att.mha_attention_cuda(q, k, v, mask, rate, TRAIN_SEED, causal)
        ref = att.mha_reference(q, k, v, mask, rate, TRAIN_SEED, causal)
        rec = {"shape": [B, H, Lq, Lk, d], "dtype": name, "causal": causal,
               "rate": rate,
               "fwd_err_over_tol": over_tol([out[:-1]], [ref[:-1]], name),
               "finite": bool(torch.isfinite(out).all())}
        ok = rec["fwd_err_over_tol"] <= 1.0 and rec["finite"]
        if not rate:
            free = att.mha_reference(q[-1:], k[-1:], v[-1:], causal=causal)
            rec["masked_row_err"] = _err(out[-1:], free)
            rec["masked_row_tol"] = (2.0 ** -9 * float(v[-1].float().abs().max())
                                     + _train_tol(ref[:-1], name))
            ok = ok and rec["masked_row_err"] <= rec["masked_row_tol"]
        if backward:
            args = (q, k, v, mask, g, rate, TRAIN_SEED, causal)
            grads = att.mha_attention_bwd_cuda(*args)
            want = att.mha_backward_reference(*args)
            again = att.mha_attention_bwd_cuda(*args)
            top = max(float(w.float().abs().max()) for w in want)
            rec["bwd_err_over_tol"] = over_tol([a[:-1] for a in grads],
                                               [w[:-1] for w in want], name)
            rec["bwd_masked_row_err"] = max(_err(a[-1], w[-1])
                                            for a, w in zip(grads, want))
            rec["bwd_masked_row_tol"] = 2.0 ** -6 * max(1.0, top)
            rec["deterministic"] = all(torch.equal(a, b)
                                       for a, b in zip(grads, again))
            ok = (ok and rec["bwd_err_over_tol"] <= 1.0
                  and rec["bwd_masked_row_err"] <= rec["bwd_masked_row_tol"]
                  and rec["deterministic"]
                  and all(bool(torch.isfinite(x).all()) for x in grads))
        rec["ok"] = ok
        rows.append(rec)
        if not ok:
            raise AssertionError(f"head-major attention edge shape: {rec}")

    for Lq in MHA_EDGE_QUERIES:
        for Lk in MHA_EDGE_KEYS:
            for causal in (False, True):
                for rate in (0.0, TRAIN_RATE):
                    one(3, 2, Lq, Lk, 64, causal, rate, True)
    for B, H, Lq, Lk, d, causal, backward, name in MHA_EDGE_EXTRA:
        for rate in (0.0, TRAIN_RATE):
            one(B, H, Lq, Lk, d, causal, rate, backward, name)

    B, H, L, d, dt = 2, 12, 60, 64, torch.bfloat16
    q, k = (torch.randn((B, H, L, d), generator=gen, device=dev).to(dt)
            for _ in range(2))
    eye = torch.eye(L, d, device=dev, dtype=dt).expand(B, H, L, d)
    ones = torch.ones((B, L), device=dev)
    keep = drop.attention_keep_mask(TRAIN_SEED, B, H, L, L, TRAIN_RATE,
                                    device=dev)
    out = att.mha_attention_cuda(q, k, eye, ones, TRAIN_RATE, TRAIN_SEED)
    dv = att.mha_attention_bwd_cuda(q, k, eye, ones, eye, TRAIN_RATE,
                                    TRAIN_SEED)[2]
    masks = {"shape": [B, H, L, L],
             "forward_equals_plain": bool(torch.equal(out[..., :L] != 0,
                                                      keep)),
             "backward_equals_plain": bool(torch.equal(
                 dv[..., :L] != 0, keep.transpose(-1, -2)))}
    if not (masks["forward_equals_plain"]
            and masks["backward_equals_plain"]):
        raise AssertionError(f"head-major attention keep bits: {masks}")
    return {"cases": rows, "n_cases": len(rows), "keep_bits": masks,
            "worst_fwd_err_over_tol": max(r["fwd_err_over_tol"]
                                          for r in rows),
            "worst_bwd_err_over_tol": max(r.get("bwd_err_over_tol", 0.0)
                                          for r in rows)}


# The LayerNorm kernels' edges (#6, #7): widths about the 16-byte access (8
# bf16, 4 fp32), a warp's 96 accesses and the path's 768 and 4352, widths
# that take single-element accesses, and the widest row the wrappers take
# (16 fp32 bytes a column within 227 KB); row counts about the backward's
# row groups P: one, P - 1, P, P + 1, and 2P + 1, whose last group is short.
LN_EDGE_WIDTHS = (1, 7, 8, 9, 255, 256, 257, 767, 768, 769, 1536, 4351,
                  4352, 4353, 227 * 1024 // 16)


def check_ln_edges(torch, lnm):
    """#6 and #7 at their edges (``LN_EDGE_WIDTHS`` x the row counts about
    ``lnm.LN_BWD_GROUPS``), fp32 and bf16, against the plain versions on
    the same inputs: the forward within 1e-4 (fp32) or one bf16 ulp of
    its largest value, dx within ``_train_tol``, dw and db within 1e-6 per
    row (fp32 sums in another order; 4 rows' worth below 4 rows, where one
    term's rounding of xhat outweighs the order), and every backward
    repeated bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(71)
    P = lnm.LN_BWD_GROUPS
    rows = (1, P - 1, P, P + 1, 2 * P + 1)
    cases = []
    for d in LN_EDGE_WIDTHS:
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        for n in rows:
            x32 = torch.randn((n, d), generator=gen, device=dev) * 2.0 + 0.5
            g32 = torch.randn((n, d), generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                x, g = x32.to(dtype), g32.to(dtype)
                out = lnm.layer_norm_cuda(x, w, b)
                ref = lnm.layer_norm_reference(x, w, b)
                got = lnm.layer_norm_bwd_cuda(x, w, g)
                want = lnm.layer_norm_bwd_reference(x, w, g)
                again = lnm.layer_norm_bwd_cuda(x, w, g)
                fwd_tol = 1e-4 if name == "float32" else _bf16_tol(ref)
                rec = {"shape": [n, d], "dtype": name,
                       "fwd_err": _err(out, ref), "fwd_tol": fwd_tol,
                       "dx_err": _err(got[0], want[0]),
                       "dx_tol": _train_tol(want[0], name),
                       "dwdb_err": max(_err(got[1], want[1]),
                                       _err(got[2], want[2])),
                       "dwdb_tol": 1e-6 * max(n, 4),
                       "deterministic": all(bool(torch.equal(a, c))
                                            for a, c in zip(got, again)),
                       "finite": bool(torch.isfinite(out).all()) and all(
                           bool(torch.isfinite(a).all()) for a in got)}
                rec["ok"] = (rec["fwd_err"] <= rec["fwd_tol"]
                             and rec["dx_err"] <= rec["dx_tol"]
                             and rec["dwdb_err"] <= rec["dwdb_tol"]
                             and rec["deterministic"] and rec["finite"])
                cases.append(rec)
                if not rec["ok"]:
                    raise AssertionError(f"LayerNorm edge shape: {rec}")

    def worst(err, tol):
        return max(c[err] / c[tol] if c[tol] else float(c[err] > 0)
                   for c in cases)
    return {"cases": cases, "n_cases": len(cases),
            "worst_fwd_err_over_tol": worst("fwd_err", "fwd_tol"),
            "worst_dx_err_over_tol": worst("dx_err", "dx_tol"),
            "worst_dwdb_err_over_tol": worst("dwdb_err", "dwdb_tol")}


# The fused kernels' edges (#8, #9): the LayerNorm edge widths, widths
# that are a multiple of 4 but not of 8 (16-byte accesses in fp32, single
# elements in bf16: 4, 12, 772) or below one Philox quad (1, 3), and one
# single-element width for each count of accesses a thread (NV: 2047 ->
# 4, 4095 -> 8, 4353 -> 16, 14527 -> 32, at 16 warps a row); row counts
# about #9's row groups P.
DALN_EDGE_WIDTHS = (1, 3, 4, 7, 8, 9, 12, 255, 256, 257, 767, 768, 769, 772,
                    2047, 4095, 4351, 4352, 4353, 14527, 227 * 1024 // 16)


def _over(err, tol):
    return err / tol if tol else float(err > 0)


def _daln_case(torch, lnm, y, x, w, b, g, rate):
    """#8 and #9 on one input against their plain versions: the record
    (errors and tolerances: out within ``_train_tol`` of its dtype; the
    larger of the dy and dx errors within the smaller of their
    tolerances, or with mixed y/x dtypes each within its own dtype's;
    dw/db within 1e-6 a row, fp32 sums in another order, 4 rows' worth
    below 4 rows, where one term's rounding of shat outweighs the order;
    and whether repeats are bit-identical), #8's output and #9's (dy, dx,
    dw, db)."""
    n = x.numel() // x.shape[-1]
    out = lnm.dropout_add_layer_norm_cuda(y, x, w, b, rate, TRAIN_SEED)
    ref = lnm.dropout_add_layer_norm_reference(y, x, w, b, rate, TRAIN_SEED)
    got = lnm.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, TRAIN_SEED)
    want = lnm.dropout_add_layer_norm_bwd_reference(y, x, w, g, rate,
                                                    TRAIN_SEED)
    again = lnm.dropout_add_layer_norm_bwd_cuda(y, x, w, g, rate, TRAIN_SEED)
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    rec = {"fwd_err": _err(out, ref),
           "fwd_tol": _train_tol(ref, name[ref.dtype]),
           "dy_err": _err(got[0], want[0]),
           "dy_tol": _train_tol(want[0], name[want[0].dtype]),
           "dx_err": _err(got[1], want[1]),
           "dx_tol": _train_tol(want[1], name[want[1].dtype]),
           "dwdb_err": max(_err(a, c) for a, c in zip(got[2:], want[2:])),
           "dwdb_tol": 1e-6 * max(n, 4),
           "deterministic": bool(torch.equal(
               out, lnm.dropout_add_layer_norm_cuda(y, x, w, b, rate,
                                                    TRAIN_SEED))) and all(
               bool(torch.equal(a, c)) for a, c in zip(got, again)),
           "finite": bool(torch.isfinite(out).all()) and all(
               bool(torch.isfinite(a).all()) for a in got)}
    # (d = 1: s - mean, and so dy and dx, are 0, and their tolerances too)
    if got[0].dtype == got[1].dtype:
        rec["bwd_over_tol"] = _over(max(rec["dy_err"], rec["dx_err"]),
                                    min(rec["dy_tol"], rec["dx_tol"]))
    else:
        rec["bwd_over_tol"] = max(_over(rec["dy_err"], rec["dy_tol"]),
                                  _over(rec["dx_err"], rec["dx_tol"]))
    rec["ok"] = (all(_over(rec[f"{k}_err"], rec[f"{k}_tol"]) <= 1.0
                     for k in ("fwd", "dwdb"))
                 and rec["bwd_over_tol"] <= 1.0
                 and rec["deterministic"] and rec["finite"])
    return rec, out, got


def check_daln_edges(torch, lnm, drop):
    """#8 and #9 at their edges (``DALN_EDGE_WIDTHS`` x the row counts
    about ``lnm.DALN_BWD_GROUPS``), fp32 and bf16, rates 0 and 0.1,
    against the plain versions on the same inputs (``_daln_case``).  In
    fp32 at rate 0.1 the keep bits are read back: #9's dy is keep * dx /
    (1 - rate) bit for bit with the plain row mask, and adding 100 to the
    entries of y that it drops leaves #8's output and #9's dx
    bit-identical.  Beside them, at three widths: a view of every input
    off the 16-byte alignment gives the aligned call's results bit for
    bit, and mixed y/x dtypes (bf16 and fp32 either way) match the plain
    versions."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(73)
    P = lnm.DALN_BWD_GROUPS
    scale = drop.keep_scale(TRAIN_RATE)
    cases = []

    def inputs(n, d):
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        y, x, g = (torch.randn((n, d), generator=gen, device=dev)
                   for _ in range(3))
        return y, x * 2.0 + 0.5, w, b, g

    def record(rec, **what):
        rec = {**what, **rec}
        cases.append(rec)
        if not rec["ok"]:
            raise AssertionError(f"dropout_add_layer_norm edge case: {rec}")

    for d in DALN_EDGE_WIDTHS:
        for n in (1, P - 1, P, P + 1, 2 * P + 1):
            y32, x32, w, b, g32 = inputs(n, d)
            for dtype in (torch.float32, torch.bfloat16):
                y, x, g = (t.to(dtype) for t in (y32, x32, g32))
                for rate in (0.0, TRAIN_RATE):
                    rec, out, got = _daln_case(torch, lnm, y, x, w, b, g,
                                               rate)
                    if dtype == torch.float32 and rate:
                        keep = drop.row_keep_mask(TRAIN_SEED, n, d, rate,
                                                  device=dev)
                        y2 = torch.where(keep, y, y + 100.0)
                        rec["dy_is_keep_dx"] = bool(torch.equal(
                            got[0], torch.where(keep, got[1] * scale, 0.0)))
                        rec["dropped_unread"] = bool(torch.equal(
                            out, lnm.dropout_add_layer_norm_cuda(
                                y2, x, w, b, rate, TRAIN_SEED))) and bool(
                            torch.equal(got[1],
                                        lnm.dropout_add_layer_norm_bwd_cuda(
                                            y2, x, w, g, rate,
                                            TRAIN_SEED)[1]))
                        rec["ok"] = (rec["ok"] and rec["dy_is_keep_dx"]
                                     and rec["dropped_unread"])
                    record(rec, shape=[n, d], dtype=str(dtype).split(".")[1],
                           rate=rate)

    def off_alignment(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for d in (768, 769, 4352):
        n = P + 1
        y32, x32, w, b, g32 = inputs(n, d)
        for dtype in (torch.float32, torch.bfloat16):
            y, x, g = (t.to(dtype) for t in (y32, x32, g32))
            out = lnm.dropout_add_layer_norm_cuda(y, x, w, b, TRAIN_RATE,
                                                  TRAIN_SEED)
            got = lnm.dropout_add_layer_norm_bwd_cuda(y, x, w, g, TRAIN_RATE,
                                                      TRAIN_SEED)
            vy, vx, vw, vb, vg = (off_alignment(t) for t in (y, x, w, b, g))
            rec, v_out, v_got = _daln_case(torch, lnm, vy, vx, vw, vb, vg,
                                           TRAIN_RATE)
            rec["same_as_aligned"] = bool(torch.equal(out, v_out)) and all(
                bool(torch.equal(a, c)) for a, c in zip(got, v_got))
            rec["ok"] = rec["ok"] and rec["same_as_aligned"]
            record(rec, shape=[n, d], dtype=str(dtype).split(".")[1],
                   rate=TRAIN_RATE, mode="misaligned views")
        for ydt, xdt in ((torch.bfloat16, torch.float32),
                         (torch.float32, torch.bfloat16)):
            y, x, g = y32.to(ydt), x32.to(xdt), g32.to(xdt)
            for rate in (0.0, TRAIN_RATE):
                rec, out, got = _daln_case(torch, lnm, y, x, w, b, g, rate)
                rec["dtypes_kept"] = (out.dtype == xdt and got[0].dtype == ydt
                                      and got[1].dtype == xdt)
                rec["ok"] = rec["ok"] and rec["dtypes_kept"]
                record(rec, shape=[n, d], rate=rate,
                       dtype=f"y {str(ydt).split('.')[1]}, x "
                             f"{str(xdt).split('.')[1]}")

    def worst(*keys):
        return max(_over(c[f"{k}_err"], c[f"{k}_tol"]) for c in cases
                   for k in keys)
    return {"cases": cases, "n_cases": len(cases),
            "worst_fwd_err_over_tol": worst("fwd"),
            "worst_bwd_err_over_tol": max(c["bwd_over_tol"]
                                          for c in cases),
            "worst_dwdb_err_over_tol": worst("dwdb")}


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

def make_corpus(n_videos, video_bs, shape, seed=3):
    """TV-distribution videos in the packed layout, ``video_bs`` per batch."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import tv_vsm_batch
    r = np.random.RandomState(seed)
    batches, dropped = [], []
    for i in range(n_videos // video_bs):
        videos = [sample_tv_video(r) for _ in range(video_bs)]
        b, drop = tv_vsm_batch(videos, shape, seed=seed + 1 + i)
        # serving reads the backbone keys only
        batches.append({k: v for k, v in b.items()
                        if k.startswith(("sub_", "c_"))})
        dropped.append(drop)
    return batches, float(np.mean(dropped))


def make_queries(n_queries, query_bs, slots, vocab, video_ids, interval,
                 seed=0):
    """Query batches with TVR-like lengths N(15, 4) clipped to [5, slots]
    and synthetic ground truth (a random video and span per query)."""
    r = np.random.RandomState(seed)
    lens = np.clip(np.round(r.normal(15.0, 4.0, n_queries)), 5,
                   slots).astype(np.int64)
    ids = r.randint(3, vocab, (n_queries, slots)).astype(np.int32)
    masks = (np.arange(slots)[None, :] < lens[:, None]).astype(np.float32)
    gt = [video_ids[r.randint(len(video_ids))] for _ in range(n_queries)]
    types = ("v", "t", "vt")
    query_data = {}
    for q in range(n_queries):
        st = int(r.randint(0, 50))
        ed = st + int(r.randint(2, 16))
        query_data[q] = {"desc_id": q, "desc": "", "vid_name": gt[q],
                         "ts": [st * interval, ed * interval],
                         "type": types[q % 3]}
    batches = [{"qids": list(range(s, s + query_bs)),
                "vids": gt[s:s + query_bs],
                "query_input_ids": ids[s:s + query_bs],
                "query_attn_masks": masks[s:s + query_bs]}
               for s in range(0, n_queries, query_bs)]
    return batches, query_data


def counters():
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    return {"seg_attention_cuda": att.seg_attention_cuda,
            "valid_attention_cuda": att.valid_attention_cuda,
            "attention_bwd_cuda": att.attention_bwd_cuda,
            "mha_attention_cuda": att.mha_attention_cuda,
            "mha_attention_bwd_cuda": att.mha_attention_bwd_cuda,
            "layer_norm_cuda": lnm.layer_norm_cuda,
            "layer_norm_bwd_cuda": lnm.layer_norm_bwd_cuda,
            "dropout_add_layer_norm_cuda": lnm.dropout_add_layer_norm_cuda,
            "dropout_add_layer_norm_bwd_cuda":
                lnm.dropout_add_layer_norm_bwd_cuda}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_submission(sub, metrics, n_queries, n_videos, opts):
    for task in ("VCMR", "SVMR", "VR"):
        if len(sub[task]) != n_queries:
            raise AssertionError(f"{task}: {len(sub[task])} entries")
        for e in sub[task]:
            preds = np.asarray(e["predictions"], np.float64)
            want = (min(100, n_videos) if task == "VR"
                    else opts.max_after_nms)
            if preds.shape != (want, 4) or not np.isfinite(preds).all():
                raise AssertionError(f"{task} entry {e['desc_id']}: "
                                     f"predictions {preds.shape}")
            if np.any(np.diff(preds[:, 3]) > 0) and task != "SVMR":
                raise AssertionError(f"{task} scores not sorted")
            if task == "VR" and len(set(preds[:, 0])) != want:
                raise AssertionError("VR repeats a video")
            if task == "VCMR" and np.any(preds[:, 2] <= preds[:, 1]):
                raise AssertionError("VCMR span with ed <= st")
    for task in ("VCMR", "SVMR", "VR"):
        vals = list(metrics[task].values())
        if not vals or not all(0.0 <= v <= 100.0 for v in vals):
            raise AssertionError(f"{task} metrics out of range: "
                                 f"{metrics[task]}")


def integration_check(torch, cfg, flat, vsm, opts, batches, queries,
                      device_kernel, device_plain):
    """fp32: the scorer's top-10 videos through the kernels on the card
    equal those of the plain path on the CPU; scores within tolerance."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import (embed_video_corpus,
                                                     make_query_scorer)
    outs = {}
    for dev in (device_kernel, device_plain):
        params = load_jax_params(flat, device=dev, heads=False)
        embs, masks = embed_video_corpus(params, cfg, batches, torch.float32,
                                         dev)
        score, _ = make_query_scorer(params, cfg, vsm, opts, embs, masks,
                                     torch.float32)
        res = score(torch.from_numpy(queries["query_input_ids"]),
                    torch.from_numpy(queries["query_attn_masks"]))
        outs[dev] = (embs.cpu(), res[2].cpu(), res[3].cpu())
    (ek, sk, ik), (ep, sp, ip) = outs[device_kernel], outs[device_plain]
    emb_err = float((ek - ep).abs().max())
    k = min(10, ik.shape[1])
    # exp(q2c_alpha * s) multiplies the ~1e-6 fp32 noise of the cosine s
    # by q2c_alpha = 20
    rtol = 1e-3
    score_rel = float(((sk[:, :k] - sp[:, :k]).abs()
                       / sp[:, :k].abs().clamp(min=1e-30)).max())
    same = bool(torch.equal(ik[:, :k], ip[:, :k]))
    rec = {"n_videos": int(ek.shape[0]), "n_queries": int(ik.shape[0]),
           "top_k": k, "top_idx_equal": same, "score_max_rel_err": score_rel,
           "score_rtol": rtol, "frame_emb_max_abs_err": emb_err}
    if not same or score_rel > rtol:
        raise AssertionError(f"fp32 kernel path vs plain CPU path: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_BS = 32                      # videos a step (bench.py)
TRAIN_SAMPLED = 32 * 32            # videos bench.py samples to route
WARMUP_STEPS, FIT_STEPS, OVER_STEPS, TRAIN_RUNS = 3, 20, 8, 3
SIGNAL_STEPS, SIGNAL_LR = 20, 1e-4
BENCH_VSM = dict(lw_neg_ctx=8.0, lw_neg_q=8.0, lw_st_ed=0.01)


def make_train_buckets(vfeat_dim, batch, n_sampled):
    """bench.py's layout: TV videos from RandomState(0), routed to
    TV_PACKED when they pack drop-free and to TV_PACKED_OVERFLOW
    otherwise; one batch of ``batch`` videos per bucket (cycled), seed 2.
    Returns (fit batch, overflow batch, overflow share, subs dropped,
    the fit videos)."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import (TV_PACKED, TV_PACKED_OVERFLOW,
                                               partition_videos,
                                               tv_vsm_batch)
    r = np.random.RandomState(0)
    videos = [sample_tv_video(r) for _ in range(n_sampled)]
    fit, over = partition_videos(videos, TV_PACKED)
    p_over = len(over) / len(videos)

    def mk(vs, shape):
        shape = dataclasses.replace(shape, batch=batch, vfeat_dim=vfeat_dim)
        return tv_vsm_batch([vs[i % len(vs)] for i in range(batch)], shape,
                            seed=2)

    (b_fit, d_fit), (b_over, d_over) = mk(fit, TV_PACKED), mk(
        over, TV_PACKED_OVERFLOW)
    return b_fit, b_over, p_over, (1 - p_over) * d_fit + p_over * d_over, fit


def vsm_loss_fn(cfg, vsm, dtype, train):
    from hero_tpu_torch.models.pretrain import forward_vsm

    def loss_fn(params, batch, seed):
        a, b, c = forward_vsm(params, cfg, vsm, batch, train=train,
                              seed=seed, dtype=dtype)
        return a + b + c, {"loss_st_ed": a, "loss_neg_ctx": b,
                           "loss_neg_q": c}
    return loss_fn


def train_throughput(torch, cfg, flat, b_fit, b_over, p_over, dev, dtype,
                     steps, sync, profile):
    """bench.py's measurement on the port: warm-up steps on both buckets,
    then ``TRAIN_RUNS`` runs of (fit steps, overflow steps), each bucket
    timed on the host clock up to a synchronise, amortised by the
    overflow share; the median run.  The launch counts are read from 0
    around the timed runs (the train step's main-path run)."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    warmup, n_fit, n_over, n_runs = steps
    vsm = VsmConfig(drop_svmr_prob=0.8, **BENCH_VSM)
    spec = TrainSpec(learning_rate=3e-5, warmup_steps=10000,
                     num_train_steps=100000, grad_norm=2.0)
    step = make_train_step(vsm_loss_fn(cfg, vsm, dtype, True), spec)
    bf, bo = batch_to_device(b_fit, dev), batch_to_device(b_over, dev)
    st = {"state": TrainState.create(load_jax_params(flat, device=dev,
                                                     heads=False)),
          "seed": 1000}

    def run(batch, n):
        for _ in range(n):
            st["state"], m = step(st["state"], batch, st["seed"])
            st["seed"] += 1
        return m

    for _ in range(warmup):
        run(bf, 1)
        m = run(bo, 1)
    warm_loss = float(m["loss"])
    reset_counts()
    run(bf, 1)
    sync()
    per_fit = read_counts()
    reset_counts()
    run(bo, 1)
    sync()
    per_over = read_counts()
    reset_counts()
    runs, fit_s, over_s = [], [], []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        run(bf, n_fit)
        sync()
        t1 = time.perf_counter()
        m = run(bo, n_over)
        sync()
        t2 = time.perf_counter()
        t_fit, t_over = (t1 - t0) / n_fit, (t2 - t1) / n_over
        fit_s.append(t_fit)
        over_s.append(t_over)
        runs.append(b_fit["sub_mask"].shape[0]
                    / ((1 - p_over) * t_fit + p_over * t_over))
    launches = read_counts()
    final = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"train step metrics not finite: {final}")
    rec = {"train_examples_per_s": float(np.median(runs)),
           "runs_examples_per_s": runs, "fit_step_s": fit_s,
           "overflow_step_s": over_s, "overflow_video_frac": p_over,
           "steps_per_run": [n_fit, n_over], "warmup_loss": warm_loss,
           "last_metrics": final, "launches_per_fit_step": per_fit,
           "launches_per_overflow_step": per_over,
           "main_path_launches": launches}
    if profile:
        rec["profile_fit_step"] = profile_breakdown(
            torch, lambda: step(st["state"], bf, 7))
    return rec


def step_rates(torch):
    """``--times steps``: ``train_examples_per_s`` (:func:`train_throughput`
    at ``bench.py``'s layout) and ``tvc_train_captions_per_s``
    (:func:`tvc_train_rate`) of the ``hero_tpu_torch`` on ``sys.path``,
    measured as the full run measures them, with the count of parameter
    leaves each step's AdamW loops over."""
    from hero_tpu_torch.config.model_config import (flagship_config,
                                                    flagship_tvc_config)
    from hero_tpu_torch.convert import from_jax
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.models.tvc import init_flat_tvc_params
    from hero_tpu_torch.training.optim import tree_leaves

    def sync():
        torch.cuda.synchronize()

    cfg = flagship_config()
    flat = init_flat_params(cfg, VsmConfig(**BENCH_VSM), seed=0)
    b_fit, b_over, p_over, _, _ = make_train_buckets(
        cfg.vfeat_dim, TRAIN_BS, TRAIN_SAMPLED)
    train = train_throughput(
        torch, cfg, flat, b_fit, b_over, p_over, "cuda", torch.bfloat16,
        (WARMUP_STEPS, FIT_STEPS, OVER_STEPS, TRAIN_RUNS), sync, False)
    vsm_leaves = len(tree_leaves(from_jax.load_jax_params(
        flat, device="meta", heads=False)))
    del flat
    tcfg = flagship_tvc_config()
    tvc_flat = init_flat_tvc_params(tcfg, seed=0)
    store, _, _ = make_tvc_data(TVC_VIDEOS, tcfg.vfeat_dim)
    ds = tvc_train_data(store, tcfg.f_config.vocab_size)
    tvc = tvc_train_rate(torch, tcfg, tvc_flat, ds, "cuda", torch.bfloat16,
                         sync, False)[0]
    tvc_leaves = len(tree_leaves(from_jax.load_jax_tvc_params(
        tvc_flat, device="meta")))
    return {"train_examples_per_s": train["train_examples_per_s"],
            "runs_examples_per_s": train["runs_examples_per_s"],
            "vsm_step_leaves": vsm_leaves,
            "tvc_train_captions_per_s": tvc["tvc_train_captions_per_s"],
            "runs_captions_per_s": tvc["runs_captions_per_s"],
            "tvc_step_leaves": tvc_leaves}


def learning_signal(torch, cfg, flat, b_fit, dev, dtype, n_steps):
    """On one fixed batch with dropout and drop_svmr off (train=False),
    lr 1e-4 from the first step (warm-up 1): the loss of the last step
    must be below the first."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    spec = TrainSpec(learning_rate=SIGNAL_LR, warmup_steps=1,
                     num_train_steps=1000, grad_norm=2.0)
    step = make_train_step(vsm_loss_fn(cfg, VsmConfig(**BENCH_VSM), dtype,
                                       False), spec)
    state = TrainState.create(load_jax_params(flat, device=dev,
                                              heads=False))
    batch = batch_to_device(b_fit, dev)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, batch, None)
        losses.append(float(m["loss"]))
    rec = {"lr": SIGNAL_LR, "warmup_steps": 1, "losses": losses,
           "ok": losses[-1] < losses[0]}
    if not rec["ok"]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return rec


def train_parity(torch, cfg, videos, dev_kernel, dev_plain):
    """fp32, dropout off: one whole train step through the kernels on the
    card against the plain path on the CPU, at the flagship widths with
    the f-encoder cut to 2 layers and the c-encoder to 1, on a batch of 4
    fit-bucket videos (:func:`step_parity`)."""
    from hero_tpu_torch.data.synthetic import TV_PACKED, tv_vsm_batch
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.training.step import TrainSpec
    small = cfg.replace(
        f_config=cfg.f_config.replace(num_hidden_layers=2),
        c_config=cfg.c_config.replace(num_hidden_layers=1))
    vsm = VsmConfig(**BENCH_VSM)
    flat = init_flat_params(small, vsm, seed=1)
    shape = dataclasses.replace(TV_PACKED, batch=4, vfeat_dim=cfg.vfeat_dim)
    batch, _ = tv_vsm_batch(videos[:4], shape, seed=2)
    spec = TrainSpec(learning_rate=1e-4, warmup_steps=1,
                     num_train_steps=1000, grad_norm=2.0)
    return step_parity(torch, flat, batch,
                       vsm_loss_fn(small, vsm, torch.float32, False), spec,
                       dev_kernel, dev_plain, heads=False,
                       what="fp32 train step")


def step_parity(torch, flat, batch, loss_fn, spec, dev_kernel, dev_plain,
                heads, what, load=None, zero_grads=None):
    """One train step of ``loss_fn`` from the weights ``flat`` on the host
    ``batch``, on ``dev_kernel`` (the kernels) and ``dev_plain`` (the
    plain path): the loss, every gradient and every updated parameter
    must agree (fp32 sums in other orders; AdamW's first step bounds a
    parameter's move by its gradients' noise).  ``load(flat, device)``
    bridges the weights (default the pretraining tree, with or without
    its task ``heads``).  ``zero_grads`` ({leaf: bound}) names the leaves
    whose exact gradient is 0 (:func:`zero_sum_bound`): on each path
    their gradient must lie within the bound, in place of the relative
    rule, which a gradient of pure rounding has no scale for."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers.common import CURRICULUM_KEYS
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import (TrainState, loss_and_grads,
                                              make_train_step)
    if load is None:
        def load(f, device):
            return load_jax_params(f, device=device, heads=heads)
    out = {}
    for dev in (dev_kernel, dev_plain):
        params = load(flat, dev)
        b = to_device(batch, dev, host_keys=CURRICULUM_KEYS)
        loss, _, grads = loss_and_grads(loss_fn, params, b, None)
        state, m = make_train_step(loss_fn, spec)(TrainState.create(params),
                                                   b, None)
        out[dev] = (float(loss), [g.cpu() for g in optim.tree_leaves(grads)],
                    [p.cpu() for p in optim.tree_leaves(state.params)],
                    float(m["loss"]), float(m["grad_norm"]))
    (lk, gk, pk, mk, nk), (lp, gp, pp, mp, np_) = out[dev_kernel], out[
        dev_plain]
    worst_g, worst_p = parity_worst(optim.tree_paths(load(flat, "cpu")),
                                    gk, gp, pk, pp, spec, zero_grads, what)
    rec = {"depth": [2, 1], "batch": int(np.shape(batch["sub_mask"])[0]),
           "loss": [lk, lp],
           "loss_rel_err": abs(lk - lp) / abs(lp), "loss_rtol": 1e-5,
           "step_loss": [mk, mp], "grad_norm": [nk, np_],
           "worst_grad_err_over_tol": worst_g,
           "worst_param_err_over_tol": worst_p}
    rec["ok"] = (rec["loss_rel_err"] <= 1e-5 and worst_g[0] <= 1.0
                 and worst_p[0] <= 1.0
                 and abs(nk - np_) <= 1e-4 * abs(np_))
    if not rec["ok"]:
        raise AssertionError(f"{what}, kernels vs plain: {rec}")
    return rec


def parity_worst(paths, gk, gp, pk, pp, spec, zero_grads, what):
    """:func:`step_parity`'s rule over the leaves: the gradients ``gk``
    against ``gp`` and the updated parameters ``pk`` against ``pp``;
    returns the worst (error / tolerance, leaf) of each."""
    from hero_tpu_torch.training import optim
    adam = spec.adamw
    sf = math.sqrt(1 - adam.beta2) / (1 - adam.beta1)
    zero_grads = dict(zero_grads or {})
    worst_g, worst_p = (0.0, ""), (0.0, "")
    for path, a, b, pa, pb in zip(paths, gk, gp, pk, pp):
        g_err = float((a - b).abs().max())
        # fp32 sums in other orders, and the atomics of the card's
        # scatter-adds (the embedding and gather backwards): within 1e-3
        # of the leaf's largest gradient
        g_tol = 1e-3 * float(b.abs().max()) + 1e-7
        # AdamW's first step moves an element by lr'*sf*g/(|g| + eps)
        # (lr' = lr * lr_mul outside v_encoder), whose slope in g is at
        # most lr'*sf/eps: the gradients' noise (4x the measured
        # difference) moves it by at most that much, and never by more
        # than 2*lr'*sf
        lr = spec.learning_rate * (adam.lr_mul if optim.is_top(path)
                                   else 1.0)
        p_tol = lr * sf * min(2.0, 4 * g_err / adam.eps) + 1e-6
        p_err = float((pa - pb).abs().max())
        name = "/".join(path)
        if name in zero_grads:
            g_ratio = (max(float(a.abs().max()), float(b.abs().max()))
                       / zero_grads.pop(name))
        else:
            g_ratio = g_err / g_tol
        worst_g = max(worst_g, (g_ratio, name))
        worst_p = max(worst_p, (p_err / p_tol, name))
    if zero_grads:
        raise ValueError(f"{what}: no leaf {sorted(zero_grads)}")
    return worst_g, worst_p


@contextlib.contextmanager
def plain_packed_attention():
    """Within the context the packed attention wrappers compute with their
    plain versions, on the card as on the CPU, and count no launches: the
    reference path of :func:`bf16_step_check`."""
    from hero_tpu_torch.ops import attention as att
    names = ("seg_attention_cuda", "valid_attention_cuda",
             "attention_bwd_cuda")
    saved = {n: getattr(att, n) for n in names}

    def seg(q, k, v, n_heads, seg, dropout_rate=0.0, seed=None,
            save_probs=False):
        return att.packed_forward_reference(
            q, k, v, n_heads, seg=seg, dropout_rate=dropout_rate, seed=seed,
            save_probs=save_probs)

    def valid(q, k, v, n_heads, kv_mask, dropout_rate=0.0, seed=None,
              save_probs=False, causal=False):
        return att.packed_forward_reference(
            q, k, v, n_heads, kv_mask=kv_mask, dropout_rate=dropout_rate,
            seed=seed, save_probs=save_probs, causal=causal)

    att.seg_attention_cuda, att.valid_attention_cuda = seg, valid
    att.attention_bwd_cuda = att.packed_backward_reference
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(att, n, f)


def bf16_step_check(torch, make_loss_fn, params, batches, seed, paths,
                    zero_grads=None, bounds=None):
    """bf16 with dropout, at the main path's model and batches: the loss
    and every gradient of one step through the tensor-core packed
    attention kernels against the same step with the plain attention
    versions, on the card at the same inputs and Philox seed.  The fp32
    step (the CUDA-core kernels, which the fp32 parity holds against the
    CPU) measures the bf16 step's own rounding, and the kernels' step
    must stay within a few times it: for the loss and each gradient
    leaf, |kernels - plain| <= 4 |plain - fp32| + 2^-9 |fp32| (max over
    the leaf).  A perturbation of one bf16 ulp anywhere in the step
    spreads through the later bf16 roundings, so the two bf16 steps
    differ by about as much as either differs from fp32 (up to 2.05x it,
    leaf by leaf, on an NVIDIA H100 80GB HBM3); a wrong row or key in a
    kernel moves its terms by their own size, far above that.

    A leaf of a few elements has a single draw of that noise, whose ratio
    to the other path's single draw has no useful bound; such leaves get
    an analytic bound instead, and every other leaf keeps the rule above.
    ``zero_grads`` ({leaf: bound}) names the leaves whose exact gradient
    is 0 (:func:`zero_sum_bound`): on each path their gradient must lie
    within the bound.  ``bounds(batch)`` ({leaf: tol}) gives the leaves
    whose |kernels - plain| is bounded from the two paths' own outputs
    (:func:`violin_bias_bound`)."""
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import loss_and_grads

    def step(dtype, batch):
        loss, _, grads = loss_and_grads(make_loss_fn(dtype), params, batch,
                                        seed)
        return float(loss), [g.float() for g in optim.tree_leaves(grads)]

    recs = []
    for batch in batches:
        lk, gk = step(torch.bfloat16, batch)
        with plain_packed_attention():
            lp, gp = step(torch.bfloat16, batch)
        lr, gr = step(torch.float32, batch)
        worst = bf16_worst(paths, gk, gp, gr, zero_grads,
                           bounds(batch) if bounds else None)
        rec = {"loss": [lk, lp, lr], "loss_kernel_vs_plain": abs(lk - lp),
               "loss_tol": 4 * abs(lp - lr) + 2.0 ** -9 * abs(lr),
               "worst_grad_err_over_tol": worst}
        rec["ok"] = (rec["loss_kernel_vs_plain"] <= rec["loss_tol"]
                     and worst[0] <= 1.0
                     and all(math.isfinite(x) for x in rec["loss"]))
        recs.append(rec)
        del gk, gp, gr
    if not all(r["ok"] for r in recs):
        raise AssertionError(f"bf16 step, kernels vs plain: {recs}")
    return recs


def bf16_worst(paths, gk, gp, gr, zero_grads=None, fixed=None):
    """:func:`bf16_step_check`'s rule over the leaves: the bf16 gradients
    ``gk`` against the bf16 ``gp``, whose distance from the fp32 ``gr``
    sets the tolerance; returns the worst (error / tolerance, leaf)."""
    zero, fixed = dict(zero_grads or {}), dict(fixed or {})
    worst = (0.0, "")
    for path, a, b, r in zip(paths, gk, gp, gr):
        if path in zero:
            ratio = (max(float(a.abs().max()), float(b.abs().max()))
                     / zero.pop(path))
        else:
            tol = fixed.pop(path, None)
            if tol is None:
                tol = (4 * float((b - r).abs().max())
                       + 2.0 ** -9 * float(r.abs().max()))
            ratio = float((a - b).abs().max()) / max(tol, 1e-30)
        worst = max(worst, (ratio, path))
    if zero or fixed:
        raise ValueError(f"bf16 step: no leaf {sorted({**zero, **fixed})}")
    return worst


def vsm_bf16_step(torch, cfg, flat, b_fit, b_over, dev):
    """:func:`bf16_step_check` on the VSM train step of
    :func:`train_throughput`: the flagship model and both of its buckets
    (fit and overflow), dropout on."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models.pretrain import VsmConfig
    from hero_tpu_torch.training import optim
    vsm = VsmConfig(drop_svmr_prob=0.8, **BENCH_VSM)
    params = load_jax_params(flat, device=dev, heads=False)
    paths = ["/".join(p) for p in optim.tree_paths(params)]
    return bf16_step_check(
        torch, lambda dt: vsm_loss_fn(cfg, vsm, dt, True), params,
        [batch_to_device(b, dev) for b in (b_fit, b_over)], 7, paths)


# ---------------------------------------------------------------------------
# TVC caption serving
# ---------------------------------------------------------------------------

TVC_VIDEOS, TVC_CLIPS, TVC_BS = 64, 4, 8   # videos, clips a video, batch
TVC_MAX_STEP, TVC_BOS, TVC_EOS, TVC_BEAM = 30, 0, 2, 3
TVC_SEG_LEN = 100                  # seg_len = max_clip_len (train-tvc.json)
TVC_CLIP_FRAMES = (2, 40)          # clip lengths in frames, 1.5 s apart
TVC_RUNS = 3
# fp32 greedy ids are compared up to the first step at which the
# reference's top-2 logit gap is below this (logits are O(1); the two
# paths' fp32 logits differ by ~1e-5)
TVC_GAP_TOL = 1e-3


class MemVideoStore:
    """In-memory video store for ``TvcClipDataset``: the packed backbone
    arrays of each video (``tv_vsm_batch`` in ``shape``'s layout), its
    frame count and the 1.5 s frame interval."""

    def __init__(self, videos, shape, seed):
        from hero_tpu_torch.data.synthetic import tv_vsm_batch
        b, self.dropped = tv_vsm_batch(videos, shape, seed=seed)
        self.vids = [f"tv{i:04d}" for i in range(len(videos))]
        self._items = {vid: {k: v[i] for k, v in b.items()
                             if k.startswith(("sub_", "c_"))}
                       for i, vid in enumerate(self.vids)}
        self._n = {vid: v.n_frames for vid, v in zip(self.vids, videos)}
        self.img_db = types.SimpleNamespace(frame_interval=1.5)

    def video_item(self, vid):
        return {k: v.copy() for k, v in self._items[vid].items()}

    def nframes(self, vid):
        return self._n[vid]


def make_tvc_data(n_videos, vfeat_dim, seed=21):
    """``n_videos`` TV videos in the packed ``TV_PACKED`` layout, each with
    ``TVC_CLIPS`` clips of 2-40 frames at random starts: (the video store,
    the clips (vid, clip id, ts, None) in corpus order, the share of subs
    the packer dropped)."""
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.synthetic import TV_PACKED
    r = np.random.RandomState(seed)
    videos = [sample_tv_video(r) for _ in range(n_videos)]
    shape = dataclasses.replace(TV_PACKED, batch=n_videos, n_queries=1,
                                vfeat_dim=vfeat_dim)
    store = MemVideoStore(videos, shape, seed + 1)
    clips = []
    for vid in store.vids:
        for c in range(TVC_CLIPS):
            n = int(r.randint(TVC_CLIP_FRAMES[0], TVC_CLIP_FRAMES[1] + 1))
            n = min(n, store.nframes(vid))
            st = int(r.randint(0, store.nframes(vid) - n + 1))
            clips.append((vid, f"{vid}c{c}", [st * 1.5, (st + n) * 1.5],
                          None))
    return store, clips, store.dropped


def tvc_dataset(store, clips):
    from hero_tpu_torch.data.downstream_tasks import TvcClipDataset
    return TvcClipDataset(store, clips, clips_per_item=TVC_CLIPS,
                          seg_len=TVC_SEG_LEN)


def _mha_case(torch, B, H, Lq, Lk, d, kind, dtype, gen, dev):
    q = torch.randn((B, H, Lq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, H, Lk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    if kind == "step":             # decode step t: keys <= t valid
        t = torch.randint(0, Lk, (B, 1), generator=gen, device=dev)
        mask = (torch.arange(Lk, device=dev)[None] <= t).float()
    elif kind == "step0":          # the first step: key 0 only
        mask = (torch.arange(Lk, device=dev) == 0).float()[None].repeat(B, 1)
    else:
        mask = torch.ones((B, Lk), device=dev)
    mask[-1] = 0.0                 # a fully masked row
    return q, k, v, mask


def _sdpa_bias(torch, mask, Lq, causal, dtype):
    """The additive (B, 1, Lq, Lk) mask that gives
    ``F.scaled_dot_product_attention`` the kernels' function."""
    B, Lk = mask.shape
    allowed = (mask[:, None, :] > 0).expand(B, Lq, Lk)
    if causal:
        row = torch.arange(Lq, device=mask.device)[:, None]
        allowed = allowed & (torch.arange(Lk, device=mask.device)[None]
                             <= row + (Lk - Lq))
    return torch.where(allowed, 0.0, -1e4).to(dtype)[:, None]


def check_mha(torch, F, att, B, H, Lq, Lk, d, kind, causal):
    """Hold the head-major kernel (#4) against ``mha_reference``: fp32
    within 1e-5 and bf16 within one bf16 ulp on the rows with a valid key;
    the fully masked last row finite and equal to the unmasked attention
    up to the rounding of s - 1e4.  bf16 timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * Lq + Lk)
    record, rows = {}, {}
    for dtype, tol_fn, why in (
            (torch.float32, lambda ref: 1e-5,
             "fp32: 64-term dots and <= 56-term softmax/P.V sums in "
             "another order, outputs O(1)"),
            (torch.bfloat16, _bf16_tol, "bf16: one bf16 ulp of max|out|")):
        q, k, v, mask = _mha_case(torch, B, H, Lq, Lk, d, kind, dtype, gen,
                                  dev)
        out = att.mha_attention_cuda(q, k, v, mask, causal=causal)
        ref = att.mha_reference(q, k, v, mask, causal=causal)
        err = _err(out[:-1], ref[:-1])
        tol = tol_fn(ref)
        free = att.mha_reference(q[-1:], k[-1:], v[-1:], causal=causal)
        row_err = _err(out[-1:], free)
        row_tol = 2.0 ** -9 * float(v[-1].float().abs().max()) + tol
        rec = {"max_abs_err": err, "tol": tol, "tol_reason": why,
               "masked_row_err": row_err, "masked_row_tol": row_tol,
               "finite": bool(torch.isfinite(out).all())}
        rec["ok"] = err <= tol and row_err <= row_tol and rec["finite"]
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v, mask)
        if not rec["ok"]:
            raise AssertionError(f"mha attention {[B, H, Lq, Lk, d]} "
                                 f"{kind} causal={causal} {dtype}: {rec}")
    q, k, v, mask = rows[torch.bfloat16]
    ms = time_ms(torch, lambda: att.mha_attention_cuda(q, k, v, mask,
                                                       causal=causal))
    plain_ms = time_ms(torch, lambda: att.mha_reference(q, k, v, mask,
                                                        causal=causal))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias))
    elt = q.element_size()
    b_ms, by = bound_ms(2 * B * H * (Lq + Lk) * d * elt + B * Lk * 4,
                        4 * B * H * Lq * Lk * d, "bfloat16")
    return {"shape": [B, H, Lq, Lk, d], "mode": f"{kind}"
            + (", causal" if causal else ""), "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_mha_dropout(torch, att, drop, B, H, Lk, d):
    """The kernel's in-kernel keep bits at the decode shape: with value
    rows e_j its output holds drop(p), whose zeros must equal the plain
    Philox mask bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, 1, d), generator=gen, device=dev)
    k = torch.randn((B, H, Lk, d), generator=gen, device=dev)
    v = torch.eye(Lk, d, device=dev).expand(B, H, Lk, d)
    mask = torch.ones((B, Lk), device=dev)
    out = att.mha_attention_cuda(q, k, v, mask, TRAIN_RATE, TRAIN_SEED)
    got = out[..., :Lk] != 0
    want = drop.attention_keep_mask(TRAIN_SEED, B, H, 1, Lk, TRAIN_RATE,
                                    device=dev)
    ref = att.mha_reference(q, k, v, mask, TRAIN_RATE, TRAIN_SEED)
    rec = {"shape": [B, H, 1, Lk], "identical_to_plain": bool(
        torch.equal(got, want)), "keep_rate": float(got.float().mean()),
        "max_abs_err": _err(out, ref), "tol": 1e-5}
    rec["ok"] = rec["identical_to_plain"] and rec["max_abs_err"] <= 1e-5
    if not rec["ok"]:
        raise AssertionError(f"mha attention dropout: {rec}")
    return rec


def check_packed_tvc(torch, F, att, B, Lq, Lk, D, H, causal):
    """#2 at a TVC decoder shape against ``packed_reference``: causal
    self-attention (Lq == Lk) or the decode step's cross-attention
    (Lq = 1 over a clip), the last row a padded clip slot with no valid
    key.  fp32 1e-4 and bf16 one ulp on the other rows; bf16 timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3 * B + Lq + Lk)
    lens = torch.randint(2, Lk + 1, (B, 1), generator=gen, device=dev)
    mask = (torch.arange(Lk, device=dev)[None] < lens).float()
    mask[-1] = 0.0
    record, rows = {}, {}
    for dtype, tol_fn in ((torch.float32, lambda ref: 1e-4),
                          (torch.bfloat16, _bf16_tol)):
        q = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        kv = torch.randn((B, Lk, 2 * D), generator=gen, device=dev).to(dtype)
        k, v = kv.split(D, dim=-1)
        out = att.valid_attention_cuda(q, k, v, H, mask, causal=causal)[0]
        ref = att.packed_reference(q, k, v, H, kv_mask=mask, causal=causal)
        rec = {"max_abs_err": _err(out[:-1], ref[:-1]), "tol": tol_fn(ref),
               "finite": bool(torch.isfinite(out).all())}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"] and rec["finite"]
        record[str(dtype).split(".")[1]] = rec
        rows[dtype] = (q, k, v)
        if not rec["ok"]:
            raise AssertionError(f"packed attention {[B, Lq, Lk, D]} "
                                 f"causal={causal} {dtype}: {rec}")
    q, k, v = rows[torch.bfloat16]
    ms = time_ms(torch, lambda: att.valid_attention_cuda(q, k, v, H, mask,
                                                         causal=causal))
    plain_ms = time_ms(torch, lambda: att.packed_reference(
        q, k, v, H, kv_mask=mask, causal=causal))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)
    d = D // H

    def heads(t):
        return t.unflatten(-1, (H, d)).transpose(1, 2)

    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=bias))
    elt = q.element_size()
    b_ms, by = bound_ms(2 * B * (Lq + Lk) * D * elt + B * Lk * 4,
                        4 * B * H * Lq * Lk * d, "bfloat16")
    return {"shape": [B, Lq, Lk, D], "mode": "tvc causal self-attention"
            if causal else "tvc cross-attention", "dtype": "bfloat16",
            "max_abs_err": record["bfloat16"]["max_abs_err"],
            "tol": record["bfloat16"]["tol"], "checks": record, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def check_tvc_kernels(torch, cfg, kernels):
    """#4 at the decode shapes and #2 at the decoder's shapes.  Adds #2's
    rows to ``kernels`` and returns #4's row."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import dropout as drop
    d_cfg = cfg.d_config
    D, H = d_cfg.hidden_size, d_cfg.num_attention_heads
    d = D // H
    greedy, beam = TVC_BS * TVC_CLIPS, TVC_BS * TVC_CLIPS * TVC_BEAM
    L = TVC_MAX_STEP + 1
    # the decode step attends over all TVC_MAX_STEP cache slots
    shapes = [check_mha(torch, F, att, greedy, H, 1, TVC_MAX_STEP, d,
                        "step", False),
              check_mha(torch, F, att, beam, H, 1, TVC_MAX_STEP, d, "step0",
                        False),
              check_mha(torch, F, att, greedy, H, L, L, d, "valid", True)]
    masks = check_mha_dropout(torch, att, drop, greedy, H, TVC_MAX_STEP, d)
    for row in kernels:
        if row["name"] == "attention_valid":
            row["shapes"] += [
                check_packed_tvc(torch, F, att, greedy, L, L, D, H, True),
                check_packed_tvc(torch, F, att, greedy, 1, TVC_SEG_LEN, D,
                                 H, False)]
    return {"name": "mha_attention", "route": "cuda",
            "source": "hero_tpu_torch/ops/csrc/attention.cu",
            "replaces": "hero_tpu/ops/attention.py:121",
            "tpu_kernel": "_fwd_kernel", "counter": "mha_attention_cuda",
            "library_call": "F.scaled_dot_product_attention, additive mask",
            **{k: shapes[0][k] for k in (
                "shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")},
            "shapes": shapes, "dropout_masks": masks}


def gap_rule(ids, logits, ref_ids, tol):
    """``ids`` (N, T) must equal ``ref_ids`` up to the first step at which
    the reference's top-2 gap of ``logits`` (N, T, V) is below ``tol``.
    Returns (ok, rows stopped early by a small gap, steps compared)."""
    top2 = logits.float().topk(2, dim=-1).values
    small = (top2[..., 0] - top2[..., 1]) < tol
    ok, stopped, compared = True, 0, 0
    for row in range(ids.shape[0]):
        hits = small[row].nonzero()
        stop = int(hits[0, 0]) if len(hits) else ids.shape[1]
        stopped += stop < ids.shape[1]
        compared += stop
        ok = ok and bool((ids[row, :stop] == ref_ids[row, :stop]).all())
    return ok, stopped, compared


def tvc_replay(torch, tvc, params, cfg, batch, ids):
    """Teacher-forced logits (N, T, V) of the prefix [BOS, ids[:, :-1]]
    through ``decode``: step t sees positions <= t by the causal bias."""
    enc = tvc.encode(params, cfg, batch, dtype=torch.float32)
    prefix = torch.cat([torch.full_like(ids[:, :1], TVC_BOS), ids[:, :-1]],
                       dim=1)
    return tvc.decode(params, cfg, enc, batch["seg_mask"], prefix,
                      dtype=torch.float32)


def tvc_fp32_checks(torch, cfg, flat, store, clips, dev_kernel, dev_plain):
    """fp32, one batch: (a) the card's KV-cached greedy ids equal the
    plain path's on the CPU, and (b) they equal a teacher-forced replay
    through ``decode`` on the card (#4 against #2's causal mode), both
    under the gap rule."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.data.downstream_tasks import build_tvc_clip_batch
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models import tvc
    ds = tvc_dataset(store, clips[:TVC_BS * TVC_CLIPS])
    batch = build_tvc_clip_batch(ds, list(range(len(ds))))
    out = {}
    with torch.inference_mode():
        for dev in (dev_kernel, dev_plain):
            params = load_jax_tvc_params(flat, device=dev)
            b = batch_to_device(batch, dev)
            ids = tvc.greedy_decode(params, cfg, b, max_step=TVC_MAX_STEP,
                                    bos=TVC_BOS, eos=TVC_EOS,
                                    dtype=torch.float32)
            out[dev] = (ids, tvc_replay(torch, tvc, params, cfg, b, ids))
            del params
    (ik, lk), (ip, lp) = out[dev_kernel], out[dev_plain]
    ok_cpu, stop_cpu, n_cpu = gap_rule(ik.cpu(), lp.cpu(), ip.cpu(),
                                       TVC_GAP_TOL)
    ok_rep, stop_rep, n_rep = gap_rule(ik, lk, lk.argmax(-1).int(),
                                       TVC_GAP_TOL)
    rec = {"rows": int(ik.shape[0]), "steps": TVC_MAX_STEP,
           "gap_tol": TVC_GAP_TOL,
           "card_vs_cpu_equal": ok_cpu, "card_vs_cpu_rows_stopped": stop_cpu,
           "card_vs_cpu_steps_compared": n_cpu,
           "ids_identical_to_cpu": bool(torch.equal(ik.cpu(), ip.cpu())),
           "kv_vs_replay_equal": ok_rep, "kv_vs_replay_rows_stopped":
           stop_rep, "kv_vs_replay_steps_compared": n_rep,
           "logits_max_abs_err_vs_cpu": _err(lk.cpu(), lp.cpu())}
    if not (ok_cpu and ok_rep):
        raise AssertionError(f"fp32 TVC greedy ids: {rec}")
    return rec


# bf16 greedy ids through #4 are compared with those of the same batch
# with #4's plain version up to the first step at which the plain run's
# top-2 logit gap is below this.  The logits are bf16, 2^-6 apart near
# the top ones (which lie in [2, 4)).  A probe call before this check
# existed (the smoke's 8 greedy batches, 256 rows, 30 steps; NVIDIA H100
# 80GB HBM3, 700 W) found the two runs' logits within 0.0195 of each other
# up to the first step where their ids differ, and the plain gap there 0,
# 2^-6 or 2^-5: one bf16 ulp of #4's output, carried through the decoder,
# swaps two logits at most 2.5 ulps apart.  0.05 (above 3 ulps) covers
# that; 32% of all steps have a gap below it.
TVC_BF16_GAP_TOL = 0.05


@contextlib.contextmanager
def plain_mha_attention():
    """Within the context the head-major forward wrapper computes with its
    plain version, on the card as on the CPU, and counts no launches: the
    reference path of :func:`tvc_bf16_decode_check`."""
    from hero_tpu_torch.ops import attention as att
    saved = att.mha_attention_cuda

    def plain(q, k, v, kv_mask, dropout_rate=0.0, seed=None, causal=False):
        return att.mha_reference(q, k, v, kv_mask, dropout_rate, seed,
                                 causal)

    att.mha_attention_cuda = plain
    try:
        yield
    finally:
        att.mha_attention_cuda = saved


def greedy_with_logits(torch, tvc, params, cfg, batch, dtype):
    """``tvc.greedy_decode``'s ids (N, T) and the logits (N, T, V) of its
    steps, read by wrapping the module's step function for the call."""
    steps, step = [], tvc._step

    def recorded(*a, **kw):
        out = step(*a, **kw)
        steps.append(out.float())
        return out

    tvc._step = recorded
    try:
        with torch.inference_mode():
            ids = tvc.greedy_decode(params, cfg, batch, max_step=TVC_MAX_STEP,
                                    bos=TVC_BOS, eos=TVC_EOS, dtype=dtype)
    finally:
        tvc._step = step
    return ids, torch.stack(steps, dim=1)


def tvc_bf16_decode_check(torch, tvc, params, cfg, batch, rehearse):
    """bf16, one greedy batch (the fp32 id checks reach only the
    CUDA-core #4): the ids through the tensor-core #4 equal those of the
    same batch with #4's plain version on the card, up to the first step
    whose plain top-2 logit gap is below ``TVC_BF16_GAP_TOL``; the kernel
    run launches #4 at every step of every decoder layer."""
    before = read_counts()["mha_attention_cuda"]
    ik, lk = greedy_with_logits(torch, tvc, params, cfg, batch,
                                torch.bfloat16)
    launched = read_counts()["mha_attention_cuda"] - before
    with plain_mha_attention():
        ip, lp = greedy_with_logits(torch, tvc, params, cfg, batch,
                                    torch.bfloat16)
    ok, stopped, compared = gap_rule(ik, lp, ip, TVC_BF16_GAP_TOL)
    want = 0 if rehearse else TVC_MAX_STEP * cfg.d_config.num_hidden_layers
    # where the two runs' ids first differ: the plain top-2 gap there and
    # how far apart the logits were up to it (what the tolerance rests on)
    top2 = lp.topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    first = []
    for row in range(ik.shape[0]):
        diff = (ik[row] != ip[row]).nonzero()
        if len(diff):
            t = int(diff[0, 0])
            first.append({"row": row, "step": t,
                          "plain_gap": float(gaps[row, t]),
                          "logits_err_to_step": _err(lk[row, :t + 1],
                                                     lp[row, :t + 1])})
    rec = {"rows": int(ik.shape[0]), "steps": TVC_MAX_STEP,
           "gap_tol": TVC_BF16_GAP_TOL, "ids_equal_under_gap_rule": ok,
           "rows_stopped": stopped, "steps_compared": compared,
           "rows_identical": int((ik == ip).all(dim=1).sum()),
           "first_divergence": first,
           "logits_max_abs_err_step0": _err(lk[:, 0], lp[:, 0]),
           "mha_launches": launched, "mha_launches_expected": want}
    # on the card the rule must have compared something
    rec["ok"] = ok and launched == want and (rehearse or compared > 0)
    if not rec["ok"]:
        raise AssertionError(f"bf16 TVC greedy ids, #4 vs plain: {rec}")
    return rec


def check_records(records, clips, max_step, eos):
    """Every clip exactly once, in the reference schema, its ids cut at
    the first EOS."""
    want = {(vid, cid): ts for vid, cid, ts, _ in clips}
    got = [(r["vid_name"], r["clip_id"]) for r in records]
    if len(got) != len(want) or set(got) != set(want):
        raise AssertionError(f"records cover {len(set(got))} of "
                             f"{len(want)} clips in {len(got)} records")
    for r in records:
        if set(r) != {"vid_name", "clip_id", "ts", "descs"} or len(
                r["descs"]) != 1 or set(r["descs"][0]) != {"desc"}:
            raise AssertionError(f"record schema: {r}")
        toks = [int(t) for t in r["descs"][0]["desc"].split()]
        if eos in toks or len(toks) > max_step or r["ts"] != want[
                (r["vid_name"], r["clip_id"])]:
            raise AssertionError(f"record not cut at EOS: {r}")


def tvc_phase(torch, cfg, flat, store, clips, dev, dtype, sync, rehearse,
              profile):
    """``generate_clip_captions`` greedy over every clip (median of
    ``TVC_RUNS`` timed runs after a warm-up batch; launch counters read
    from 0 around the first), one beam pass over two batches, the record
    checks, and the fp32 checks."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.data.downstream_tasks import build_tvc_clip_batch
    from hero_tpu_torch.drivers.inf_tvc import (cut_at_eos,
                                                generate_clip_captions)
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models import tvc
    bs = 2 if rehearse else TVC_BS
    params = load_jax_tvc_params(flat, device=dev)
    kw = dict(bos=TVC_BOS, eos=TVC_EOS, batch_size=bs,
              max_gen_step=TVC_MAX_STEP, dtype=dtype, device=dev)
    ds = tvc_dataset(store, clips)
    generate_clip_captions(params, cfg,                         # warm-up
                           tvc_dataset(store, clips[:bs * TVC_CLIPS]), **kw)
    sync()
    runs = []
    for i in range(TVC_RUNS):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        records = generate_clip_captions(params, cfg, ds, **kw)
        sync()
        runs.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_counts()
    check_records(records, clips, TVC_MAX_STEP, TVC_EOS)
    # the records of the first batch are its greedy ids cut at EOS
    b0 = build_tvc_clip_batch(ds, list(range(bs)))
    with torch.inference_mode():
        ids0 = tvc.greedy_decode(params, cfg, batch_to_device(b0, dev),
                                 max_step=TVC_MAX_STEP, bos=TVC_BOS,
                                 eos=TVC_EOS, dtype=dtype).cpu()
    for ri, rec in enumerate(records[:bs * TVC_CLIPS]):
        want = " ".join(map(str, cut_at_eos(ids0[ri].tolist(), TVC_EOS)))
        if rec["descs"][0]["desc"] != want:
            raise AssertionError(f"record {ri} is not its ids cut at EOS")
    n_batches = -(-len(ds) // bs)
    n_layers = cfg.d_config.num_hidden_layers
    want_mha = n_batches * TVC_MAX_STEP * n_layers
    if not rehearse and (launches["mha_attention_cuda"] != want_mha or
                         launches["valid_attention_cuda"] < want_mha):
        raise AssertionError(f"TVC launches {launches}, want "
                             f"mha_attention_cuda == {want_mha}")
    beam_clips = clips[:2 * bs * TVC_CLIPS]
    t0 = time.perf_counter()
    beam_records = generate_clip_captions(
        params, cfg, tvc_dataset(store, beam_clips), beam=TVC_BEAM, **kw)
    sync()
    beam_s = time.perf_counter() - t0
    check_records(beam_records, beam_clips, TVC_MAX_STEP, TVC_EOS)
    n_caps = len(records)
    t_med = float(np.median(runs))
    rec = {"clips": n_caps, "batch": bs, "rows_per_batch": bs * TVC_CLIPS,
           "max_gen_step": TVC_MAX_STEP, "tvc_captions_per_s": n_caps / t_med,
           "wall_s": t_med, "wall_s_runs": runs,
           "runs_captions_per_s": [n_caps / t for t in runs],
           "main_path_launches": launches, "mha_launches_expected": want_mha,
           "beam": TVC_BEAM, "beam_clips": len(beam_records),
           "beam_wall_s": beam_s,
           "beam_captions_per_s": len(beam_records) / beam_s,
           "distinct_descs": len({r["descs"][0]["desc"] for r in records})}
    if profile:
        b = batch_to_device(b0, dev)

        def greedy_batch():
            with torch.inference_mode():
                tvc.greedy_decode(params, cfg, b, max_step=TVC_MAX_STEP,
                                  bos=TVC_BOS, eos=TVC_EOS, dtype=dtype)

        prof = profile_breakdown(torch, greedy_batch, iters=2)
        if prof["device_events"] and "mha_attention_mma_kernel" not in \
                prof["device_ms_by_class"]:
            raise AssertionError(f"the greedy window ran no "
                                 f"mha_attention_mma_kernel: {prof}")
        rec["profile_greedy_batch"] = prof
    rec["bf16_decode"] = tvc_bf16_decode_check(
        torch, tvc, params, cfg, batch_to_device(b0, dev), rehearse)
    del params
    rec["fp32"] = tvc_fp32_checks(torch, cfg, flat, store, clips,
                                  "cpu" if rehearse else "cuda", "cpu")
    return rec


# ---------------------------------------------------------------------------
# TVC training
# ---------------------------------------------------------------------------

TVC_TRAIN_VIDEOS = 4                             # a step: 4 x 2 caption rows
TVC_CAPS_RANGE = (2, 6)                          # captions a video
TVC_TRAIN_STEPS = (3, 20, 3)                     # warm-up, steps a run, runs
TVC_PAD = 1


class MemCaptionStore:
    """In-memory caption store answering as ``TvcCaptionStore`` does:
    ``vid2caps``, ``pad``/``bos``/``eos``, and ``store[cid]`` with the
    BOS/EOS shift and the ``max_txt_len`` truncation of its
    ``__getitem__``."""

    def __init__(self, caps, max_txt_len):
        self.caps = caps
        self.max_txt_len = max_txt_len
        self.pad, self.bos, self.eos = TVC_PAD, TVC_BOS, TVC_EOS
        self.vid2caps = {}
        for cid, c in caps.items():
            self.vid2caps.setdefault(c["vid"], []).append(cid)

    def __getitem__(self, cid):
        d = dict(self.caps[cid])
        cap = list(d["input_ids"])
        input_ids, tgt_ids = [self.bos] + cap, cap + [self.eos]
        if self.max_txt_len != -1:
            input_ids = input_ids[:self.max_txt_len]
            tgt_ids = tgt_ids[:self.max_txt_len]
        d["input_ids"], d["tgt_ids"] = input_ids, tgt_ids
        return d


def make_tvc_captions(store, vocab, max_txt_len, seed=31):
    """2-6 synthetic captions a video, lengths N(14, 4) clipped to
    [5, 60] tokens, each over a clip of 2-40 frames inside its video."""
    r = np.random.RandomState(seed)
    caps = {}
    for vid in store.vids:
        for c in range(int(r.randint(TVC_CAPS_RANGE[0],
                                     TVC_CAPS_RANGE[1] + 1))):
            n_tok = int(np.clip(round(r.normal(14.0, 4.0)), 5, 60))
            n = min(int(r.randint(TVC_CLIP_FRAMES[0],
                                  TVC_CLIP_FRAMES[1] + 1)),
                    store.nframes(vid))
            st = int(r.randint(0, store.nframes(vid) - n + 1))
            caps[f"{vid}k{c}"] = {
                "vid": vid, "ts": [st * 1.5, (st + n) * 1.5],
                "input_ids": r.randint(3, vocab, n_tok).tolist()}
    return MemCaptionStore(caps, max_txt_len)


def tvc_train_data(store, vocab):
    """The synthetic captions of ``store``'s videos and
    ``drivers/train_tvc.tvc_train_dataset`` over them, with
    ``config/train-tvc.json``'s options (cap_len 62, seg_len 100,
    caps_per_video 2, seed 77)."""
    from hero_tpu_torch.drivers import train_tvc
    opts = train_tvc.load_train_opts()
    cap_db = make_tvc_captions(store, vocab, opts["max_txt_len"])
    return train_tvc.tvc_train_dataset(store, cap_db, opts)


def tvc_train_batches(ds, n_videos):
    """The batches of ``n_videos`` videos of ``ds`` through
    ``build_tvc_batch``, host meta dropped."""
    from hero_tpu_torch.data.downstream_tasks import build_tvc_batch
    out = []
    for s in range(0, len(ds) - n_videos + 1, n_videos):
        b = build_tvc_batch(ds, list(range(s, s + n_videos)))
        out.append({k: v for k, v in b.items() if not k.startswith("__")})
    return out


def check_decoder_train(torch, F, att, B, Lq, Lk, D, H, causal, mode=None):
    """#2 with dropout 0.1, saved probabilities and (self-attention) the
    causal bias, and #3 from those probabilities, at a TVC train decoder
    shape (or another Lq -> Lk shape, labelled ``mode``), fp32 and bf16
    at rate 0 and 0.1, against the plain versions, the saved p exactly 0
    wherever the plain p is; the last batch row a padded clip slot with
    no valid key (finite); repeats identical.  bf16 timings at rate
    0.1."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11 * B + Lq + Lk)
    lens = torch.randint(2, Lk + 1, (B, 1), generator=gen, device=dev)
    mask = (torch.arange(Lk, device=dev)[None] < lens).float()
    mask[-1] = 0.0
    d = D // H
    checks, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        kv = torch.randn((B, Lk, 2 * D), generator=gen, device=dev).to(dtype)
        k, v = kv.split(D, dim=-1)
        dout = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        for rate in (0.0, TRAIN_RATE):
            out, probs = att.valid_attention_cuda(q, k, v, H, mask, rate,
                                                  TRAIN_SEED, True, causal)
            ref, rprobs = att.packed_forward_reference(
                q, k, v, H, kv_mask=mask, dropout_rate=rate,
                seed=TRAIN_SEED, save_probs=True, causal=causal)
            grads = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            rgrads = att.packed_backward_reference(probs, q, k, v, dout, H,
                                                   rate, TRAIN_SEED)
            again = att.attention_bwd_cuda(probs, q, k, v, dout, H, rate,
                                           TRAIN_SEED)
            rec = {"fwd_err": _err(out[:-1], ref[:-1]),
                   "fwd_tol": _train_tol(ref, name),
                   "probs_err": _err(probs[:-1], rprobs[:-1]),
                   "probs_tol": _train_tol(rprobs, name),
                   "zeros_exact": bool(((rprobs == 0) <= (probs == 0)).all()),
                   "bwd_err": max(_err(a, b) for a, b in zip(grads, rgrads)),
                   "bwd_tol": min(_train_tol(b, name) for b in rgrads),
                   "finite": all(bool(torch.isfinite(t).all())
                                 for t in (out, probs, *grads)),
                   "deterministic": all(torch.equal(a, b)
                                        for a, b in zip(grads, again))}
            rec["ok"] = (rec["fwd_err"] <= rec["fwd_tol"]
                         and rec["probs_err"] <= rec["probs_tol"]
                         and rec["zeros_exact"]
                         and rec["bwd_err"] <= rec["bwd_tol"]
                         and rec["finite"] and rec["deterministic"])
            checks[f"{name}_rate{rate}"] = rec
            if not rec["ok"]:
                raise AssertionError(f"decoder attention {[B, Lq, Lk, D]} "
                                     f"causal={causal} {name} rate {rate}: "
                                     f"{rec}")
        rows[name] = (q, k, v, dout)
    q, k, v, dout = rows["bfloat16"]
    rate = TRAIN_RATE
    probs = att.valid_attention_cuda(q, k, v, H, mask, rate, TRAIN_SEED,
                                     True, causal)[1]
    fwd_ms = time_ms(torch, lambda: att.valid_attention_cuda(
        q, k, v, H, mask, rate, TRAIN_SEED, True, causal))
    fwd_plain = time_ms(torch, lambda: att.packed_forward_reference(
        q, k, v, H, kv_mask=mask, dropout_rate=rate, seed=TRAIN_SEED,
        save_probs=True, causal=causal))
    bwd_ms = time_ms(torch, lambda: att.attention_bwd_cuda(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    bwd_plain = time_ms(torch, lambda: att.packed_backward_reference(
        probs, q, k, v, dout, H, rate, TRAIN_SEED))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)

    def heads(t):
        return t.unflatten(-1, (H, d)).transpose(1, 2).detach(
            ).requires_grad_(True)

    hq, hk, hv = heads(q), heads(k), heads(v)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias,
                                                 dropout_p=rate)
    hdo = dout.unflatten(-1, (H, d)).transpose(1, 2)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        hq.detach(), hk.detach(), hv.detach(), attn_mask=bias,
        dropout_p=rate))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (hq, hk, hv), hdo, retain_graph=True))
    elt = q.element_size()
    p_bytes = B * H * Lq * Lk * elt
    fb, fby = bound_ms(2 * B * (Lq + Lk) * D * elt + B * Lk * 4 + p_bytes,
                       4 * B * H * Lq * Lk * d, "bfloat16")
    bb, bby = bound_ms(p_bytes + (3 * Lq + 4 * Lk) * B * D * elt,
                       8 * B * H * Lq * Lk * d, "bfloat16")
    bf = checks["bfloat16_rate0.1"]
    mode = (mode or ("tvc train: causal self-attention" if causal
                     else "tvc train: cross-attention")) + ", dropout 0.1"
    shape = [B, Lq, Lk, D]
    return (
        {"shape": shape, "mode": mode + ", probs saved",
         "max_abs_err": bf["fwd_err"], "tol": bf["fwd_tol"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fb, "bound_by": fby,
         "library_ms": lib_fwd, "checks": checks},
        {"shape": shape, "mode": mode, "max_abs_err": bf["bwd_err"],
         "tol": bf["bwd_tol"], "ms": bwd_ms, "plain_ms": bwd_plain,
         "bound_ms": bb, "bound_by": bby, "library_ms": lib_bwd,
         "checks": checks})


def check_tvc_train_kernels(torch, cfg, ds, kernels):
    """#2 and #3 at the TVC train step's decoder shapes (8 caption rows of
    ``ds``, causal 62 -> 62 and cross 62 -> 100); adds the rows to
    ``kernels``."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    d_cfg = cfg.d_config
    D, H = d_cfg.hidden_size, d_cfg.num_attention_heads
    B = TVC_TRAIN_VIDEOS * ds.caps_per_video
    new = [check_decoder_train(torch, F, att, B, ds.cap_len, ds.cap_len, D,
                               H, True),
           check_decoder_train(torch, F, att, B, ds.cap_len, ds.seg_len, D,
                               H, False)]
    for row in kernels:
        if row["name"] == "attention_valid":
            row["shapes"] += [f for f, _ in new]
        elif row["name"] == "attention_bwd":
            row["shapes"] += [b for _, b in new]


def tvc_learning_signal(torch, cfg, params, batch, dtype, n_steps):
    """On one batch with dropout off, lr 1e-4 from the first step (warm-up
    1): the loss of the last step must be below the first."""
    from hero_tpu_torch.drivers import train_tvc
    from hero_tpu_torch.training.step import TrainState, make_train_step
    opts = dict(train_tvc.load_train_opts(), learning_rate=SIGNAL_LR,
                warmup_steps=1)
    step = make_train_step(train_tvc.make_loss_fn(cfg, opts["lsr"], dtype,
                                                  train=False),
                           train_tvc.train_spec(opts))
    state = TrainState.create(params)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, batch, None)
        losses.append(float(m["loss"]))
    rec = {"lr": SIGNAL_LR, "warmup_steps": 1, "losses": losses,
           "ok": losses[-1] < losses[0]}
    if not rec["ok"]:
        raise AssertionError(f"the TVC loss did not fall: {losses}")
    return rec


def tvc_train_parity(torch, cfg, batch, caps_per_video, dev_kernel,
                     dev_plain):
    """fp32, dropout off: one TVC train step through the kernels on the
    card against the plain path on the CPU, at the flagship widths with
    the f-encoder cut to 2 layers, the c-encoder to 1 and the decoder to
    1, on 2 videos' caption rows (:func:`step_parity`: the loss, every
    gradient and every updated parameter)."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.drivers import train_tvc
    from hero_tpu_torch.models.tvc import init_flat_tvc_params
    small = cfg.replace(
        f_config=cfg.f_config.replace(num_hidden_layers=2),
        c_config=cfg.c_config.replace(num_hidden_layers=1),
        d_config=cfg.d_config.replace(num_hidden_layers=1))
    opts = dict(train_tvc.load_train_opts(), learning_rate=SIGNAL_LR,
                warmup_steps=1)
    rows = caps_per_video * 2
    half = {k: (v[:2] if k.startswith(("sub_", "c_")) else v[:rows])
            for k, v in batch.items()}
    rec = step_parity(
        torch, init_flat_tvc_params(small, seed=1), half,
        train_tvc.make_loss_fn(small, opts["lsr"], torch.float32,
                               train=False),
        train_tvc.train_spec(opts), dev_kernel, dev_plain, heads=None,
        what="fp32 TVC train step",
        load=lambda f, d: load_jax_tvc_params(f, device=d))
    return dict(rec, depth=[2, 1, 1], caption_rows=rows)


def tvc_train_rate(torch, cfg, flat, ds, dev, dtype, sync, rehearse):
    """The TVC train step (``drivers/train_tvc.make_tvc_train_step`` with
    ``config/train-tvc.json``'s options, bf16, dropout 0.1) on 4 videos x
    2 captions a step: the median of ``TVC_TRAIN_STEPS[2]`` runs of
    ``TVC_TRAIN_STEPS[1]`` steps after the warm-up, the launch counters
    read from 0 around the timed runs.  Returns (record, the step, its
    state holder, the host batches, the device batches)."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.drivers import train_tvc
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.training.step import TrainState
    n_videos = 2 if rehearse else TVC_TRAIN_VIDEOS
    host = tvc_train_batches(ds, n_videos)
    batches = [batch_to_device(b, dev) for b in host]
    warmup, n_steps, n_runs = (1, 2, 1) if rehearse else TVC_TRAIN_STEPS
    opts = train_tvc.load_train_opts()
    step = train_tvc.make_tvc_train_step(cfg, opts, dtype)
    st = {"state": TrainState.create(load_jax_tvc_params(flat, device=dev)),
          "i": 0}

    def run(n):
        for _ in range(n):
            b = batches[st["i"] % len(batches)]
            st["state"], m = step(st["state"], b, 5000 + st["i"])
            st["i"] += 1
        return m

    m = run(warmup)
    warm_loss = float(m["loss"])
    reset_counts()
    run(1)
    sync()
    per_step = read_counts()
    reset_counts()
    runs = []
    rows = int(host[0]["cap_input_ids"].shape[0])
    for _ in range(n_runs):
        t0 = time.perf_counter()
        m = run(n_steps)
        sync()
        runs.append(rows * n_steps / (time.perf_counter() - t0))
    launches = read_counts()
    final = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"TVC train metrics not finite: {final}")
    rec = {"tvc_train_captions_per_s": float(np.median(runs)),
           "runs_captions_per_s": runs, "steps_per_run": n_steps,
           "caption_rows_per_step": rows, "videos_per_step": n_videos,
           "batches": len(batches), "warmup_loss": warm_loss,
           "last_metrics": final, "launches_per_step": per_step,
           "main_path_launches": launches,
           "layout": f"{n_videos} videos x {ds.caps_per_video} captions, "
                     f"cap_len {ds.cap_len}, seg_len {ds.seg_len}, "
                     "videos packed 4x(16 f + 88 t)",
           "captions": len(ds.caption_db.caps)}
    return rec, step, st, host, batches


def tvc_train_phase(torch, cfg, flat, ds, dev, dtype, sync, rehearse,
                    profile):
    """:func:`tvc_train_rate`, then the learning signal, the fp32
    card-vs-CPU step and the bf16 kernels-vs-plain step."""
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.drivers import train_tvc
    from hero_tpu_torch.training import optim
    rec, step, st, host, batches = tvc_train_rate(torch, cfg, flat, ds, dev,
                                                  dtype, sync, rehearse)
    opts = train_tvc.load_train_opts()
    if profile:
        rec["profile_step"] = profile_breakdown(
            torch, lambda: step(st["state"], batches[0], 7), iters=2)
    del st
    params = load_jax_tvc_params(flat, device=dev)
    rec["learning_signal"] = tvc_learning_signal(
        torch, cfg, params, batches[0], dtype,
        4 if rehearse else SIGNAL_STEPS)
    del params
    rec["fp32"] = tvc_train_parity(torch, cfg, host[0], ds.caps_per_video,
                                   "cpu" if rehearse else "cuda", "cpu")
    params = load_jax_tvc_params(flat, device=dev)
    rec["bf16_step"] = bf16_step_check(
        torch, lambda dt: train_tvc.make_loss_fn(cfg, opts["lsr"], dt,
                                                 train=True),
        params, batches[:1], 5000,
        ["/".join(p) for p in optim.tree_paths(params)])
    del params
    return rec


# ---------------------------------------------------------------------------
# pretraining: config/pretrain-tv.json's four-task recipe through
# drivers/pretrain.run_pretrain
# ---------------------------------------------------------------------------

PRETRAIN_VIDEOS = 256                  # TV videos in the in-memory stores
PRETRAIN_STEPS, PRETRAIN_RUNS = 14, 3  # optimizer steps a timed run, runs
PRETRAIN_TASKS = ("mlm", "mfm-nce", "fom", "vsm")   # the recipe's mix
# the checks' tasks: the mix, MFFR, VSM with hard negatives and VSM with
# one sampled negative (use_all_neg=False) under hard negatives
CHECK_TASKS = ("mlm", "mfm-nce", "mffr", "fom", "vsm", "vsm-hard",
               "vsm-sampled")
CHECK_BS = 8              # videos a batch of the bf16 and remat checks
PARITY_BS = 4             # videos a batch of the fp32 card-vs-CPU step
HARD = {"use_hard_negative": np.asarray(True),
        "hard_pool_size": np.asarray(20),
        "hard_neg_weight": np.asarray(10.0, np.float32),
        "lw_st_ed": np.asarray(0.01, np.float32)}


class MemSubStore:
    """In-memory sub store for ``VideoFeatSubTokDataset`` (the attributes
    ``hero_tpu_torch/data/video.py`` lists): the subs of TV-shaped videos
    (``occupancy.sample_tv_video``) with random token ids, each matched to
    a run of frames after the previous sub's (a sub past the clip's end
    keeps its text and no frame)."""

    def __init__(self, videos, vocab, seed):
        r = np.random.RandomState(seed)
        self.cls_, self.pad, self.sep, self.mask = 0, 1, 2, vocab - 8
        self.v_range = (3, vocab - 8)
        self.id2len, self.vid2dur, self.vid2idx = {}, {}, {}
        self.vid_sub2frame, self.vid2sub_lens, self._ex = {}, {}, {}
        for i, v in enumerate(videos):
            vid = f"tv{i:04d}"
            self.id2len[vid] = v.n_frames
            self.vid2dur[vid] = v.n_frames * 1.5
            self.vid2idx[vid] = i
            toks = [r.randint(*self.v_range, size=n - 1).tolist()
                    for n in v.sub_txt_lens]          # lens count the SEP
            f0, s2f = 0, []
            for s, n in enumerate(v.sub_n_frames):
                s2f.append((s, [f for f in range(f0, f0 + n)
                                if f < v.n_frames]))
                f0 += n
            self.vid_sub2frame[vid] = s2f
            self.vid2sub_lens[vid] = [len(t) for t in toks]
            self._ex[vid] = {"input_ids": toks}

    def __getitem__(self, vid):
        return self._ex[vid]


class MemFeatStore:
    """In-memory feature store: (n_frames, vdim) float16 features."""

    def __init__(self, sub_store, vdim, seed):
        r = np.random.RandomState(seed)
        self.name2nframe = dict(sub_store.id2len)
        self._f = {vid: r.randn(n, vdim).astype(np.float16)
                   for vid, n in self.name2nframe.items()}

    def __getitem__(self, vid):
        return self._f[vid]


def pretrain_setup(here, vfeat_dim, vocab, n_videos):
    """``config/pretrain-tv.json`` read through the port's options, minus
    its paths (no checkpoint, no output directory, the single target);
    and its packed ``VideoFeatSubTokDataset`` over ``n_videos`` TV videos
    (``RandomState(41)``) in the in-memory stores."""
    from hero_tpu_torch.config.opts import get_pretrain_args
    from hero_tpu_torch.data.occupancy import sample_tv_video
    from hero_tpu_torch.data.video import VideoFeatSubTokDataset
    from hero_tpu_torch.drivers.common import shapes_from_opts
    opts = get_pretrain_args(["--config", os.path.join(
        here, "config", "pretrain-tv.json")])
    for k in ("checkpoint", "output_dir", "targets", "sub_txt_db",
              "vfeat_db"):
        setattr(opts, k, None)
    opts.vfeat_dim = vfeat_dim
    r = np.random.RandomState(41)
    subs = MemSubStore([sample_tv_video(r) for _ in range(n_videos)],
                       vocab, 42)
    db = VideoFeatSubTokDataset(subs, MemFeatStore(subs, vfeat_dim, 43),
                                shapes_from_opts(opts),
                                max_txt_len=opts.max_txt_len,
                                sub_ctx_len=opts.sub_ctx_len,
                                pack=opts.pack_subs)
    return opts, db


def pretrain_schedule(opts, n_steps):
    """The task of each of the first ``n_steps`` optimizer steps, as
    ``run_pretrain``'s MetaLoader draws them."""
    from hero_tpu_torch.data.loader import MetaLoader
    from hero_tpu_torch.drivers.pretrain import DEFAULT_TASKS
    accum = max(opts.gradient_accumulation_steps, 1)
    it = iter(MetaLoader({t: (iter(int, 1), r)
                          for t, r in DEFAULT_TASKS.items()},
                         accum_steps=accum, seed=opts.seed))
    return [next(it)[0] for _ in range(n_steps * accum)][::accum]


def pretrain_batches(opts, db, n_videos):
    """One host micro-batch of each check task, ``n_videos`` videos: the
    task datasets' first items, VSM with the curriculum's hard negatives
    in the ``-hard`` and ``-sampled`` cases."""
    from hero_tpu_torch.data import pretrain_tasks as pt
    from hero_tpu_torch.drivers.pretrain import build_task_datasets
    ds = {t: d for t, (d, _) in build_task_datasets(
        opts, {"": db}, {"mlm@": 1, "mfm-nce@": 1, "fom@": 1,
                         "vsm@": 1}).items()}
    out = {}
    for task in CHECK_TASKS:
        base = task.split("-")[0] if task.startswith("vsm") else task
        src = ds["mfm-nce" if base == "mffr" else base]
        b = pt.build_batch(src, list(range(n_videos)))
        if task in ("vsm-hard", "vsm-sampled"):
            b.update(HARD)
        out[task] = b
    return out


def check_loss_fn(cfg, opts, task, dtype, train):
    """``drivers/pretrain.make_loss`` of a check task (``vsm-sampled``:
    VSM with ``use_all_neg=False``)."""
    from hero_tpu_torch.drivers.common import vsm_config_from_opts
    from hero_tpu_torch.drivers.pretrain import make_loss
    vsm = vsm_config_from_opts(opts)
    if task == "vsm-sampled":
        vsm = vsm.replace(use_all_neg=False)
    return make_loss(task.split("-")[0] if task.startswith("vsm") else task,
                     cfg, vsm, mask_prob=opts.mask_prob, dtype=dtype,
                     train=train)


def check_pretrain_kernels(torch, cfg, host, kernels):
    """#1, #3, #6 and #7 at the pretraining step's new shapes (a packed
    MLM batch of 32 videos: f-encoder rows (256, 16 + 122); the VSM
    queries (160, 32); the LayerNorms of img_ln, the f-encoder, the LM
    head and the FOM head), and #2 at the VSM query shape, added to the
    rows of ``kernels``."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads
    b = host["mlm"]
    B, S, Lt = b["sub_input_ids"].shape
    Fs, M = b["sub_frame_idx"].shape[2], b["mlm_mask_pos"].shape[2]
    seg = torch.from_numpy(np.concatenate(
        [b["sub_frame_seg"], b["sub_txt_seg"]], 2).reshape(B * S, Fs + Lt)
    ).to(dev)
    qm = host["vsm"]["query_attn_masks"]
    qm = torch.from_numpy(qm.reshape(-1, qm.shape[-1])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(23)

    def pre(row, what):
        return {**row, "mode": f"pretrain: {what}"
                + (f", {row['mode']}" if "mode" in row else "")}

    f_fwd, f_bwd = check_attention_train(torch, F, att, B * S, Fs + Lt, D, H,
                                         seg, True)
    q_fwd, q_bwd = check_attention_train(torch, F, att, qm.shape[0],
                                         qm.shape[1], D, H, qm, False)
    F_ = b["c_attn_masks"].shape[1]
    ln_shapes = (("img_ln", B * S * Fs, cfg.vfeat_dim),
                 ("f-encoder", B * S * (Fs + Lt), D),
                 ("lm_head", B * S * M, D),
                 ("fom_output", B * F_, 2 * cfg.c_config.hidden_size))
    new = {
        "attention_seg": [
            pre(check_attention(torch, F, att, B * S, Fs + Lt, D, H, seg,
                                True, torch.bfloat16), "f-encoder"),
            pre(f_fwd, "f-encoder")],
        "attention_valid": [pre(q_fwd, "VSM queries")],
        "attention_bwd": [pre(f_bwd, "f-encoder"),
                          pre(q_bwd, "VSM queries")],
        "layer_norm": [pre(check_layer_norm(
            torch, F, lnm, n, w, torch.randn((n, w), generator=gen,
                                             device=dev).to(torch.bfloat16)),
            what) for what, n, w in ln_shapes],
        "layer_norm_bwd": [pre(check_layer_norm_bwd(torch, F, lnm, n, w),
                               what) for what, n, w in ln_shapes]}
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])


def pretrain_throughput(torch, cfg, opts, db, dev, dtype, sync, rehearse):
    """``run_pretrain`` on the four-task mix: warm-up steps until every task
    has run once, then ``PRETRAIN_RUNS`` runs of ``PRETRAIN_STEPS``
    optimizer steps timed on the host clock up to a synchronise, the
    launch counters read from 0 around the runs and per step.  Returns
    (record, final train state)."""
    from hero_tpu_torch.drivers.pretrain import run_pretrain
    n_steps, n_runs = (2, 1) if rehearse else (PRETRAIN_STEPS, PRETRAIN_RUNS)
    sched = pretrain_schedule(opts, 200)
    warm = next(i + 1 for i in range(len(sched))
                if set(sched[:i + 1]) >= set(PRETRAIN_TASKS))
    opts.num_train_steps = warm + n_runs * n_steps
    accum = max(opts.gradient_accumulation_steps, 1)
    log_ = {"task": [], "s": [], "launches": [], "loss": [], "marks": []}
    prev = {}

    def on_step(step, task, metrics):
        nonlocal prev
        if step == warm:
            sync()
            reset_counts()
            prev = read_counts()
            log_["marks"].append(time.perf_counter())
            return
        if step < warm:
            return
        now = read_counts()
        log_["launches"].append({k: now[k] - prev[k] for k in now})
        prev = now
        log_["task"].append(task)
        log_["loss"].append(metrics["loss"])
        if (step - warm) % n_steps == 0:
            sync()
        log_["s"].append(time.perf_counter())
        if (step - warm) % n_steps == 0:
            log_["marks"].append(log_["s"][-1])

    t0 = time.perf_counter()
    state = run_pretrain(opts, {"": db}, cfg=cfg, device=dev, dtype=dtype,
                         on_step=on_step)
    sync()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    for k in launches:
        launches[k] = sum(step[k] for step in log_["launches"])
    marks, times = log_["marks"], [log_["marks"][0]] + log_["s"]
    videos = n_steps * accum * opts.train_batch_size
    runs = [videos / (b - a) for a, b in zip(marks, marks[1:])]
    losses = [float(x) for x in log_["loss"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pretraining losses not finite: {losses}")
    step_ms, per_step = {}, {}
    for i, task in enumerate(log_["task"]):
        step_ms.setdefault(task, []).append(1e3 * (times[i + 1] - times[i]))
        per_step.setdefault(task, log_["launches"][i])
    rec = {"pretrain_examples_per_s": float(np.median(runs)),
           "runs_examples_per_s": runs, "warmup_steps": warm,
           "steps_per_run": n_steps, "videos_per_step": accum
           * opts.train_batch_size,
           "task_sequence": log_["task"],
           "step_ms": {t: float(np.mean(v)) for t, v in step_ms.items()},
           "step_ms_all": step_ms, "launches_per_step": per_step,
           "losses": losses, "main_path_launches": launches,
           "run_pretrain_s": total_s,
           "subs_dropped": db.trunc_counts["subs_dropped"]}
    return rec, state


def pretrain_learning_signal(torch, cfg, opts, batches, dev, dtype, n_steps):
    """Each task on one fixed batch, dropout off, lr 1e-4 from the first
    step: the last step's loss must be below the first's."""
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers.common import (CURRICULUM_KEYS,
                                               vsm_config_from_opts)
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.drivers.pretrain import init_params
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    spec = TrainSpec(learning_rate=SIGNAL_LR, warmup_steps=1,
                     num_train_steps=1000, grad_norm=opts.grad_norm)
    params = load_jax_params(init_params(opts, cfg,
                                         vsm_config_from_opts(opts)),
                             device=dev)
    out = {}
    for task in ("mlm", "mfm-nce", "mffr", "fom", "vsm"):
        step = make_train_step(check_loss_fn(cfg, opts, task, dtype, False),
                               spec)
        state = TrainState.create(params)
        batch = to_device(batches[task], dev, host_keys=CURRICULUM_KEYS)
        losses = []
        for _ in range(n_steps):
            state, m = step(state, batch, None)
            losses.append(float(m["loss"]))
        out[task] = losses
        del state
    bad = {t: v for t, v in out.items() if not v[-1] < v[0]}
    if bad:
        raise AssertionError(f"the loss did not fall: {bad}")
    return {"lr": SIGNAL_LR, "steps": n_steps, "losses": out}


def pretrain_parity(torch, cfg, opts, batches, dev_kernel, dev_plain):
    """fp32, dropout off: one train step of each check task through the
    kernels on the card against the plain path on the CPU, the f-encoder
    cut to 2 layers and the c-encoder to 1, on ``PARITY_BS`` videos
    (:func:`step_parity`'s rule)."""
    from hero_tpu_torch.drivers.common import vsm_config_from_opts
    from hero_tpu_torch.models.pretrain import init_flat_params
    from hero_tpu_torch.training.step import TrainSpec
    small = cfg.replace(
        f_config=cfg.f_config.replace(num_hidden_layers=2),
        c_config=cfg.c_config.replace(num_hidden_layers=1))
    flat = init_flat_params(small, vsm_config_from_opts(opts), seed=1)
    spec = TrainSpec(learning_rate=1e-4, warmup_steps=1,
                     num_train_steps=1000, grad_norm=opts.grad_norm)
    out = {}
    for task in CHECK_TASKS:
        b = {k: v[:PARITY_BS] if np.ndim(v) else v
             for k, v in batches[task].items()}
        out[task] = step_parity(
            torch, flat, b, check_loss_fn(small, opts, task, torch.float32,
                                          False),
            spec, dev_kernel, dev_plain, heads=True, what=f"{task} step")
    return out


def pretrain_bf16_steps(torch, cfg, opts, state, batches, dev):
    """:func:`bf16_step_check` on one batch of ``CHECK_BS`` videos of each
    check task, dropout on, at the trained state's parameters."""
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers.common import CURRICULUM_KEYS
    from hero_tpu_torch.training import optim
    paths = ["/".join(p) for p in optim.tree_paths(state.params)]
    out = {}
    for task in CHECK_TASKS:
        b = to_device(batches[task], dev, host_keys=CURRICULUM_KEYS)
        out[task] = bf16_step_check(
            torch, lambda dt: check_loss_fn(cfg, opts, task, dt, True),
            state.params, [b], 9, paths)[0]
    return out


def pretrain_remat(torch, cfg, opts, state, batches, full, dev, sync,
                   rehearse):
    """Each check task's step with every encoder layer rematerialised
    equals the plain step bit for bit (bf16, dropout on, ``CHECK_BS``
    videos): loss and every gradient.  Then, at a full micro-batch of each
    recipe task, the step time and peak memory with remat off and on."""
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers.common import CURRICULUM_KEYS
    from hero_tpu_torch.models import transformer
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import loss_and_grads
    paths = ["/".join(p) for p in optim.tree_paths(state.params)]
    bits = {}
    for task in CHECK_TASKS:
        b = to_device(batches[task], dev, host_keys=CURRICULUM_KEYS)
        fn = check_loss_fn(cfg, opts, task, torch.bfloat16 if dev == "cuda"
                           else torch.float32, True)
        runs = []
        for remat in (False, True):
            transformer.set_remat(remat)
            try:
                loss, _, grads = loss_and_grads(fn, state.params, b, 13)
            finally:
                transformer.set_remat(False)
            runs.append((loss, optim.tree_leaves(grads)))
        (l0, g0), (l1, g1) = runs
        diff = [p for p, a, c in zip(paths, g0, g1) if not torch.equal(a, c)]
        bits[task] = {"loss": [float(l0), float(l1)],
                      "loss_equal": bool(torch.equal(l0, l1)),
                      "grads_differing": diff}
        if not bits[task]["loss_equal"] or diff:
            raise AssertionError(f"remat step of {task} is not the plain "
                                 f"step bit for bit: {bits[task]}")
        del runs, g0, g1
    cost = {}
    if not rehearse:
        for task in PRETRAIN_TASKS:
            b = to_device(full[task], dev, host_keys=CURRICULUM_KEYS)
            fn = check_loss_fn(cfg, opts, task, torch.bfloat16, True)
            cost[task] = {}
            for remat in (False, True):
                transformer.set_remat(remat)
                try:
                    loss_and_grads(fn, state.params, b, 14)
                    sync()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    for i in range(3):
                        loss_and_grads(fn, state.params, b, 15 + i)
                    sync()
                    ms = (time.perf_counter() - t0) / 3 * 1e3
                finally:
                    transformer.set_remat(False)
                cost[task]["remat" if remat else "plain"] = {
                    "micro_step_ms": ms,
                    "peak_gib": (torch.cuda.max_memory_allocated() - base)
                    / 2 ** 30}
    return {"bit_equal": bits, "cost_full_micro_batch": cost}


def pretrain_profile(torch, cfg, opts, state, full, dev):
    """torch.profiler windows of one optimizer step (two micro-batches of
    ``opts.train_batch_size`` videos) of each recipe task."""
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers.common import CURRICULUM_KEYS, Curriculum
    from hero_tpu_torch.drivers.pretrain import train_spec_from_opts
    from hero_tpu_torch.training.step import make_train_step
    accum = max(opts.gradient_accumulation_steps, 1)
    cur = Curriculum(opts).at(0)
    out = {}
    for task in PRETRAIN_TASKS:
        step = make_train_step(check_loss_fn(cfg, opts, task, torch.bfloat16,
                                             True),
                               train_spec_from_opts(opts), accum_steps=accum)
        host = {k: np.stack([v] * accum) for k, v in full[task].items()}
        host.update({k: np.broadcast_to(v, (accum,)) for k, v in cur.items()})
        b = to_device(host, dev, host_keys=CURRICULUM_KEYS)
        out[task] = profile_breakdown(torch, lambda: step(state, b, 21),
                                      iters=2)
    return out


def pretrain_phase(torch, here, cfg, dev, dtype, sync, rehearse, profile,
                   kernels):
    """The pretraining path and its checks (see the module docstring);
    the kernel checks at its shapes join the rows of ``kernels``.  Each
    stage's seconds are in ``stage_s``."""
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    opts, db = pretrain_setup(here, cfg.vfeat_dim, cfg.f_config.vocab_size,
                              8 if rehearse else PRETRAIN_VIDEOS)
    if rehearse:
        opts.train_batch_size = 2
    full = pretrain_batches(opts, db, opts.train_batch_size)
    small = pretrain_batches(opts, db, 2 if rehearse else CHECK_BS)
    stage("data")
    if not rehearse:
        check_pretrain_kernels(torch, cfg, full, kernels)
        log("pretraining kernel checks passed")
    stage("kernel_checks")
    rec = {"stage_s": stage_s,
           "recipe": {k: getattr(opts, k) for k in (
               "train_batch_size", "gradient_accumulation_steps",
               "drop_svmr_prob", "mask_prob", "learning_rate",
               "warmup_steps", "lw_neg_ctx", "lw_neg_q", "lw_st_ed",
               "hard_negtiave_start_step", "use_all_neg", "pack_subs")},
           "shapes": dataclasses.asdict(db.shapes)}
    train, state = pretrain_throughput(torch, cfg, opts, db, dev, dtype,
                                       sync, rehearse)
    rec.update(train)
    stage("run_pretrain")
    if profile:
        rec["profile"] = pretrain_profile(torch, cfg, opts, state, full, dev)
        stage("profile")
    rec["remat"] = pretrain_remat(torch, cfg, opts, state, small, full, dev,
                                  sync, rehearse)
    stage("remat")
    rec["bf16_step"] = (None if rehearse else pretrain_bf16_steps(
        torch, cfg, opts, state, small, dev))
    del state
    stage("bf16_step")
    rec["learning_signal"] = pretrain_learning_signal(
        torch, cfg, opts, full, dev, dtype, 4 if rehearse else SIGNAL_STEPS)
    stage("learning_signal")
    rec["fp32"] = pretrain_parity(torch, cfg, opts, small,
                                  "cpu" if rehearse else "cuda", "cpu")
    stage("fp32")
    return rec, db


# ---------------------------------------------------------------------------
# pretraining as a program: drivers/pretrain.main from stores on disk, a
# JAX-layout init checkpoint, and a SIGTERM-interrupted run resumed
# ---------------------------------------------------------------------------

MAIN_STEPS, MAIN_SIGTERM_AT = 6, 3    # optimizer steps; SIGTERM after
MAIN_VALID_STEPS, MAIN_SAVE_STEPS = 3, 4
# restore.npz every 4 steps: the SIGTERM after step 3 writes its own
# restore.npz (a save step would have written it already)
# timed windows of run A, (first, last step]: steps 2-3 and 6 follow a
# step with no validation or checkpoint; the card is synchronised at the
# windows' edges only, as the in-memory runs are
MAIN_WINDOWS = ((1, 3), (5, 6))
MAIN_FREE_BYTES = 8 << 30      # disk the phase's files take, with room


def write_pretrain_stores(db, root):
    """The pretraining phase's in-memory sub and feature stores as
    herostore databases under ``root`` (the port's writer, the JAX
    package's layout); returns (sub dir, feature dir)."""
    from hero_tpu_torch.data.store import HeroStoreWriter
    subs, feats = db.txt_db, db.img_db
    sub_dir, feat_dir = (os.path.join(root, "sub_db"),
                         os.path.join(root, "video_db"))
    with HeroStoreWriter(sub_dir) as w:
        for vid in subs.id2len:
            w.put(vid, {"input_ids": subs[vid]["input_ids"],
                        "unique_sub2frames": subs.vid_sub2frame[vid],
                        "unmatched_frames": []})
    with HeroStoreWriter(feat_dir) as w:
        for vid in feats.name2nframe:
            w.put(vid, feats[vid])
    sidecars = {
        (sub_dir, "meta.json"): {"CLS": subs.cls_, "SEP": subs.sep,
                                 "PAD": subs.pad, "MASK": subs.mask,
                                 "v_range": list(subs.v_range)},
        (sub_dir, "vid2len.json"): subs.id2len,
        (sub_dir, "vid2sub_len.json"): subs.vid2sub_lens,
        (sub_dir, "vid2dur_idx.json"): {"tv": {
            vid: [subs.vid2dur[vid], subs.vid2idx[vid]]
            for vid in subs.id2len}},
        (feat_dir, "id2nframe.json"): feats.name2nframe}
    for (d, name), obj in sidecars.items():
        with open(os.path.join(d, name), "w") as f:
            json.dump(obj, f)
    return sub_dir, feat_dir


def disk_items_equal(db, disk):
    """Every video's ``VideoFeatSubTokDataset`` item from the stores on
    disk equals the in-memory one, bit for bit; returns the count."""
    for vid in db.vids:
        got, want = disk.video_item(vid), db.video_item(vid)
        if list(got) != list(want):
            raise AssertionError(f"{vid}: keys {list(got)} != {list(want)}")
        for k, w in want.items():
            g = got[k]
            same = (g.dtype == w.dtype and np.array_equal(g, w)
                    if isinstance(w, np.ndarray) else g == w)
            if not same:
                raise AssertionError(f"{vid}/{k}: the item from disk differs")
    return len(db.vids)


def main_config(here, root, name, sub_dir, feat_dir, model_json, ckpt,
                cfg, rehearse):
    """``config/pretrain-tv.json`` with the stores, the init checkpoint, a
    flagship model config and ``root/name`` substituted, cut to
    ``MAIN_STEPS`` steps; returns its path."""
    with open(os.path.join(here, "config", "pretrain-tv.json")) as f:
        raw = json.load(f)
    raw["targets"][0].update(sub_txt_db=sub_dir, vfeat_db=feat_dir)
    raw.update(model_config=model_json, checkpoint=ckpt,
               output_dir=os.path.join(root, name), vfeat_dim=cfg.vfeat_dim,
               num_train_steps=MAIN_STEPS, valid_steps=MAIN_VALID_STEPS,
               save_steps=MAIN_SAVE_STEPS, n_val_batches=1)
    if rehearse:
        raw.update(train_batch_size=2, val_batch_size=2)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _records(out_dir):
    with open(os.path.join(out_dir, "log", "checkpoints.json")) as f:
        return json.load(f)


def pretrain_main_phase(torch, here, cfg, db, dev, sync, rehearse, root):
    """``drivers/pretrain.main`` at ``config/pretrain-tv.json``'s recipe
    from herostore databases on disk under ``root`` (see the module
    docstring; the caller removes ``root``, whose stores and run A's last
    checkpoint the tvc_program phase reads); returns (record, the launch
    counts of run A)."""
    import signal
    from hero_tpu_torch.config.opts import get_pretrain_args
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.store import SubTokStore, VideoFeatStore
    from hero_tpu_torch.data.video import VideoFeatSubTokDataset
    from hero_tpu_torch.drivers import pretrain as drv
    from hero_tpu_torch.drivers.common import vsm_config_from_opts
    from hero_tpu_torch.models.pretrain import init_flat_params
    from hero_tpu_torch.training.optim import get_lr, tree_leaves, tree_paths
    from hero_tpu_torch.training.save import save_params
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    disk = None
    try:
        free = shutil.disk_usage(root).free
        if not rehearse and free < MAIN_FREE_BYTES:
            raise AssertionError(f"{free} bytes free under {root}; the "
                                 f"phase needs {MAIN_FREE_BYTES}")
        rec = {"stage_s": stage_s, "free_bytes_before": free, "dir": root}
        sub_dir, feat_dir = write_pretrain_stores(db, root)
        rec["store_bytes"] = sum(
            os.path.getsize(os.path.join(d, n))
            for d in (sub_dir, feat_dir) for n in os.listdir(d))
        stage("write_stores")
        disk = VideoFeatSubTokDataset(
            SubTokStore(sub_dir, max_clip_len=db.shapes.n_frames),
            VideoFeatStore(feat_dir, max_clip_len=db.shapes.n_frames),
            db.shapes, max_txt_len=db.max_txt_len,
            sub_ctx_len=db.sub_ctx_len, pack=db.pack)
        rec["readers"] = [disk.txt_db.store.reader, disk.img_db.store.reader]
        if not rehearse and rec["readers"] != ["native", "native"]:
            raise AssertionError(f"store readers {rec['readers']}: the "
                                 "native reader did not build")
        rec["items_equal"] = disk_items_equal(db, disk)
        stage("items")

        opts = get_pretrain_args(["--config", os.path.join(
            here, "config", "pretrain-tv.json")])
        init = init_flat_params(cfg, vsm_config_from_opts(opts),
                                seed=opts.seed + 1)
        init_path = os.path.join(root, "init.npz")
        save_params(init_path, init)
        model_json = os.path.join(root, "model.json")
        with open(model_json, "w") as f:
            json.dump(cfg.to_dict(), f)
        cfg_a, cfg_b = (main_config(here, root, n, sub_dir, feat_dir,
                                    model_json, init_path, cfg, rehearse)
                        for n in ("a", "b"))
        opts_a = get_pretrain_args(["--config", cfg_a])
        stage("init_checkpoint")

        # run A: uninterrupted, the launch counters from 0 around it
        handler = signal.getsignal(signal.SIGTERM)
        edges = {s for w in MAIN_WINDOWS for s in w}
        marks = {}

        def timed(step, task, metrics):
            if step in edges:
                sync()
                marks[step] = time.perf_counter()

        reset_counts()
        sync()
        t_a = time.perf_counter()
        state_a = drv.main(opts_a, device=dev, on_step=timed)
        sync()
        rec["run_a_s"] = time.perf_counter() - t_a
        launches = read_counts()
        if signal.getsignal(signal.SIGTERM) is not handler:
            raise AssertionError("main left its SIGTERM handler installed")
        out_a, out_b = (os.path.join(root, n) for n in ("a", "b"))
        rec["run_a_records"] = _records(out_a)
        stage("run_a")

        # run B: SIGTERM after step 3, then resumed to step 6
        def interrupt(step, task, metrics):
            if step == MAIN_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)

        t_b = time.perf_counter()
        state_b = drv.main(get_pretrain_args(["--config", cfg_b]),
                           device=dev, on_step=interrupt)
        if state_b.global_step != MAIN_SIGTERM_AT:
            raise AssertionError(f"SIGTERM after step {MAIN_SIGTERM_AT}: "
                                 f"main returned at {state_b.global_step}")
        del state_b
        with np.load(os.path.join(out_b, "restore.npz")) as z:
            rec["restore_step_after_sigterm"] = int(z["__step__"])
        if rec["restore_step_after_sigterm"] != MAIN_SIGTERM_AT:
            raise AssertionError(f"restore.npz after SIGTERM holds step "
                                 f"{rec['restore_step_after_sigterm']}")
        rec["run_b_interrupted_records"] = _records(out_b)
        state_b = drv.main(get_pretrain_args(["--config", cfg_b]),
                           device=dev)
        sync()
        rec["run_b_s"] = time.perf_counter() - t_b
        rec["run_b_resumed_records"] = _records(out_b)
        if state_b.global_step != MAIN_STEPS:
            raise AssertionError(f"resumed run ended at "
                                 f"{state_b.global_step}")
        del state_b
        stage("run_b")

        # A's and B's last checkpoints bit for bit; A's file bridged back
        # is A's final state bit for bit; the weights came from the init
        # checkpoint (within the 6 steps' reach; the poolers, which no
        # loss reads, decayed by lr * wd a step as JAX's AdamW decays them)
        name = f"model_step_{MAIN_STEPS}.npz"
        a = _npz(os.path.join(out_a, "ckpt", name))
        b = _npz(os.path.join(out_b, "ckpt", name))
        differ = sorted(k for k in a if k not in b or a[k].dtype
                        != b[k].dtype or not np.array_equal(a[k], b[k]))
        if differ or set(a) != set(b):
            raise AssertionError(f"resumed checkpoint differs from the "
                                 f"uninterrupted one at {differ[:5]}")
        back = load_jax_params({k: v for k, v in a.items()
                                if not k.startswith("__")}, device=dev)
        differ = ["/".join(p) for p, x, y in zip(
            tree_paths(back), tree_leaves(back),
            tree_leaves(state_a.params)) if not torch.equal(x, y)]
        if differ:
            raise AssertionError(f"checkpoint bridged back differs from "
                                 f"the final state at {differ[:5]}")
        del back, state_a
        spec = drv.train_spec_from_opts(opts_a)
        keep = np.float32(1.0)
        for step in range(1, MAIN_STEPS + 1):
            keep *= np.float32(1.0 - spec.adamw.weight_decay * get_lr(
                step, spec.learning_rate, spec.warmup_steps,
                spec.num_train_steps, spec.lr_schedule))
        rec["poolers_decayed"] = all(
            np.array_equal(a[k], init[k]) if k.endswith("/bias")
            else np.allclose(a[k], init[k] * keep, rtol=1e-6, atol=0)
            for k in init if "pooler" in k.split("/"))
        rec["max_abs_from_init"] = max(float(np.abs(a[k] - init[k]).max())
                                       for k in init)
        if not rec["poolers_decayed"] or rec["max_abs_from_init"] > 1e-5:
            raise AssertionError(
                f"run A's weights are not the init checkpoint's: poolers "
                f"decayed {rec['poolers_decayed']}, max |diff| "
                f"{rec['max_abs_from_init']}")
        rec["resume_bit_equal"] = True
        rec["checkpoint_bridged_equal"] = True
        stage("compare")

        videos = (opts_a.train_batch_size
                  * opts_a.gradient_accumulation_steps)
        rec["videos_per_step"] = videos
        rec["windows"] = [list(w) for w in MAIN_WINDOWS]
        rec["window_ms"] = [1e3 * (marks[b] - marks[a])
                            for a, b in MAIN_WINDOWS]
        rec["main_examples_per_s"] = (
            sum(b - a for a, b in MAIN_WINDOWS) * videos
            / (1e-3 * sum(rec["window_ms"])))
        rec["free_bytes_after"] = shutil.disk_usage(root).free
        return rec, launches
    finally:
        if disk is not None:
            disk.txt_db.store.close()
            disk.img_db.store.close()


# ---------------------------------------------------------------------------
# tvc_program: drivers/train_tvc and drivers/inf_tvc from stores on disk
# ---------------------------------------------------------------------------

PROGRAM_TVC_VIDEOS = 64             # of pretrain_main's videos on disk
PROGRAM_TVC_STEPS, PROGRAM_TVC_SIGTERM_AT = 8, 4
# one validation, at the last step (it was at 4 and 8 too); restore.npz
# at 4 and 8
PROGRAM_TVC_VALID_STEPS, PROGRAM_TVC_SAVE_STEPS = 8, 4
PROGRAM_TVC_WARMUP = 2
PROGRAM_TVC_TARGETS = 3             # clips of the --target_clip jsonl
# caption ids from 3 up to this (10 ids): 8 steps then learn to emit more
# than EOS; over the whole vocabulary every caption came out empty
PROGRAM_TVC_VOCAB = 13
# steps timed from disk: 2-3 and 6-7, away from the validations and the
# saves after steps 4 and 8
PROGRAM_TVC_WINDOWS = ((1, 3), (5, 7))
PROGRAM_TVC_FREE_BYTES = 8 << 30    # the two runs' checkpoints, with room
# the kernels of the unpacked program: the train step (run A, its fp32
# validations included) and the fp32 inf_tvc run; unpacked f-encoder rows
# take the validity-mask forward, so #1 runs on neither
PROGRAM_TVC_TRAIN_KERNELS = ("valid_attention_cuda", "attention_bwd_cuda",
                             "mha_attention_cuda", "layer_norm_cuda",
                             "layer_norm_bwd_cuda")
PROGRAM_TVC_INF_KERNELS = ("valid_attention_cuda", "mha_attention_cuda",
                           "layer_norm_cuda")

# one run of drivers/train_tvc.main that SIGTERM stops, in a fresh
# interpreter (tvc_train_program); its record goes to the JSON file
# argv[2]
TVC_TRAIN_RUN = """
import json, sys
from chip_smoke import tvc_train_program
from hero_tpu_torch.utils.logger import configure_stdout
cfg, out_json, device, stop_at = sys.argv[1:5]
configure_stdout()
res = tvc_train_program(cfg, device, int(stop_at))
with open(out_json, "w") as f:
    json.dump(res, f)
"""


def tvc_train_program(cfg, device, stop_at):
    """One run of ``drivers/train_tvc.main`` on the config at ``cfg``: the
    launch counters from 0 around it, the card synchronised at the
    windows' edges only, SIGTERM after step ``stop_at`` (0: never).
    Returns the final step, the losses, the edges' clocks, the counts and
    whether the last model file bridged back is the final state, bit for
    bit."""
    import signal
    import torch
    from hero_tpu_torch.config.opts import get_tvc_args
    from hero_tpu_torch.convert.from_jax import load_jax_tvc_params
    from hero_tpu_torch.drivers import train_tvc
    from hero_tpu_torch.training.optim import tree_leaves
    edges = {s for w in PROGRAM_TVC_WINDOWS for s in w}
    losses, marks = [], {}

    def on_step(step, task, metrics):
        losses.append(metrics["loss"].detach())
        if step in edges:
            if device == "cuda":
                torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)

    reset_counts()
    opts = get_tvc_args(["--config", cfg])
    state = train_tvc.main(opts, device=device, on_step=on_step,
                           dtype=torch.bfloat16 if device == "cuda"
                           else torch.float32)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_counts()
    with np.load(os.path.join(opts.output_dir, "ckpt",
                              f"model_step_{state.global_step}.npz")) as z:
        back = load_jax_tvc_params({k: z[k] for k in z.files
                                    if not k.startswith("__")},
                                   device=device)
    return {"global_step": state.global_step,
            "losses": [float(x) for x in losses], "marks": marks,
            "launches": launches,
            "bridged_equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(back), tree_leaves(state.params)))}

# drivers/inf_tvc.main on the CPU in fp32 (the rehearsal's stand-in for
# the command line, which serves on the card)
TVC_INF_CPU = """
import sys
from hero_tpu_torch.drivers import inf_tvc
inf_tvc.configure_stdout()
inf_tvc.main(inf_tvc.build_argparser().parse_args(sys.argv[1:]),
             device="cpu")
"""


def write_caption_store(db, vids, root):
    """A TVC caption store under ``root/cap_db`` over ``vids`` of ``db``:
    ``cap.db`` with 2-6 captions a video as ``make_tvc_captions`` draws
    them (``config/train-tvc.json``'s ``max_txt_len``; ids below
    ``PROGRAM_TVC_VOCAB``), ``clip.db`` with
    ``TVC_CLIPS`` clips a video (2-40 frames each) whose ground truth is
    one of the video's captions as text, ``meta.json``; the ground truth
    as a reference jsonl and a ``--target_clip`` jsonl of the first
    ``PROGRAM_TVC_TARGETS`` clips.  Returns (store dir, reference path,
    target path, clip count, caption count)."""
    from hero_tpu_torch.data.store import HeroStoreWriter
    store = types.SimpleNamespace(vids=vids, nframes=db.nframes)
    caps = make_tvc_captions(store, PROGRAM_TVC_VOCAB, 60).caps
    r = np.random.RandomState(61)
    cap_root = os.path.join(root, "cap_db")
    os.makedirs(cap_root)
    vid2caps, cap2vid, vid2clips, clip2vid, clips = {}, {}, {}, {}, []
    with HeroStoreWriter(os.path.join(cap_root, "cap.db")) as w:
        for k, (key, c) in enumerate(caps.items()):
            cid = str(100000 + k)
            w.put(cid, {"input_ids": c["input_ids"], "ts": c["ts"],
                        "clip_id": cid})
            vid2caps.setdefault(c["vid"], []).append(cid)
            cap2vid[cid] = c["vid"]
    with HeroStoreWriter(os.path.join(cap_root, "clip.db")) as w:
        for vid in vids:
            texts = [" ".join(map(str, caps[k]["input_ids"]))
                     for k in caps if caps[k]["vid"] == vid]
            for c in range(TVC_CLIPS):
                n = min(int(r.randint(TVC_CLIP_FRAMES[0],
                                      TVC_CLIP_FRAMES[1] + 1)),
                        db.nframes(vid))
                st = int(r.randint(0, db.nframes(vid) - n + 1))
                cid = str(len(clips))
                rec = {"vid_name": vid, "ts": [st * 1.5, (st + n) * 1.5],
                       "captions": [{"id": cid,
                                     "text": texts[c % len(texts)]}]}
                w.put(cid, rec)
                vid2clips.setdefault(vid, []).append(cid)
                clip2vid[cid] = vid
                clips.append((cid, rec))
    sidecars = {("", "meta.json"): {"PAD": TVC_PAD, "BOS": TVC_BOS,
                                    "EOS": TVC_EOS},
                ("cap.db", "vid2caps.json"): vid2caps,
                ("cap.db", "cap2vid.json"): cap2vid,
                ("clip.db", "vid2clips.json"): vid2clips,
                ("clip.db", "clip2vid.json"): clip2vid}
    for (d, name), obj in sidecars.items():
        with open(os.path.join(cap_root, d, name), "w") as f:
            json.dump(obj, f)
    ref, target = (os.path.join(root, n) for n in ("tvc_reference.jsonl",
                                                   "tvc_target.jsonl"))
    with open(ref, "w") as f:
        for cid, rec in clips:
            f.write(json.dumps({"clip_id": int(cid), "descs": [
                {"desc": c["text"]} for c in rec["captions"]]}) + "\n")
    with open(target, "w") as f:
        for cid, rec in clips[:PROGRAM_TVC_TARGETS]:
            f.write(json.dumps({"vid_name": rec["vid_name"],
                                "clip_id": int(cid), "ts": rec["ts"]})
                    + "\n")
    return cap_root, ref, target, len(clips), len(cap2vid)


def tvc_run_config(here, root, name, paths, tcfg, rehearse):
    """``config/train-tvc.json`` with the stores, the caption store, the
    checkpoint, a model config and ``root/name`` substituted, cut to
    ``PROGRAM_TVC_STEPS`` steps; returns its path."""
    sub_dir, feat_dir, cap_dir, ckpt = paths
    with open(os.path.join(here, "config", "train-tvc.json")) as f:
        raw = json.load(f)
    model_json = os.path.join(root, "tvc_model.json")
    with open(model_json, "w") as f:
        json.dump(tcfg.to_dict(), f)
    raw.update(sub_txt_db=sub_dir, vfeat_db=feat_dir, cap_db=cap_dir,
               checkpoint=ckpt, model_config=model_json,
               output_dir=os.path.join(root, name), vfeat_dim=tcfg.vfeat_dim,
               num_train_steps=PROGRAM_TVC_STEPS,
               valid_steps=PROGRAM_TVC_VALID_STEPS,
               save_steps=PROGRAM_TVC_SAVE_STEPS,
               warmup_steps=PROGRAM_TVC_WARMUP)
    if rehearse:
        raw.update(train_batch_size=2, val_batch_size=2, max_gen_step=5)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def check_tvc_program_kernels(torch, tcfg, train_batch, val_batch, kernels):
    """#2 and #3 at the program's unpacked f-encoder rows (16 frames + 120
    tokens: ``config/train-tvc.json``'s ``max_txt_len`` 60 with
    ``sub_ctx_len`` 1 gives 32 rows of 136 slots a video, and unpacked
    rows take the validity mask, not segment ids): the train step's
    (128, 136, 768) forward with dropout and saved probabilities and its
    backward, and a validation batch's (256, 136, 768) forward, with the
    batches' own masks; added to the rows of ``kernels``."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    D, H = tcfg.f_config.hidden_size, tcfg.f_config.num_attention_heads

    def mask_of(b):
        m = np.concatenate([b["sub_frame_mask"], b["sub_txt_mask"]], 2)
        return torch.from_numpy(
            m.reshape(-1, m.shape[-1]).astype(np.float32)).to(dev)

    def prog(row, what):
        return {**row, "mode": f"tvc_program: {what}"
                + (f", {row['mode']}" if "mode" in row else "")}

    tm, vm = mask_of(train_batch), mask_of(val_batch)
    fwd, bwd = check_attention_train(torch, F, att, tm.shape[0], tm.shape[1],
                                     D, H, tm, False)
    new = {"attention_valid": [
        prog(fwd, "f-encoder"),
        prog(check_attention(torch, F, att, vm.shape[0], vm.shape[1], D, H,
                             vm, False, torch.bfloat16),
             "f-encoder, a validation batch")],
        "attention_bwd": [prog(bwd, "f-encoder")]}
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])


def _program_saves(run, records):
    return [dict(r, run=run, kind=kind) for kind in ("model", "restore")
            for r in records[kind]]


def tvc_program_phase(torch, here, tcfg, main_root, db, dev, sync,
                      rehearse, kernels, train_rate):
    """TVC finetuning and captioning as programs (see the module
    docstring) over ``PROGRAM_TVC_VIDEOS`` of the videos pretrain_main
    wrote under ``main_root``, from its run A's last checkpoint.  Returns
    (record, the launch counts of run A, those of the in-process fp32
    ``inf_tvc`` run)."""
    from hero_tpu_torch.data.downstream_tasks import (TvcCaptionStore,
                                                      TvcClipDataset,
                                                      build_tvc_batch,
                                                      build_tvc_clip_batch)
    from hero_tpu_torch.drivers import common
    from hero_tpu_torch.drivers import inf_tvc, train_tvc
    from hero_tpu_torch.config.opts import get_tvc_args
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    # pretrain_main's files but its stores and run A's last checkpoint
    shutil.rmtree(os.path.join(main_root, "b"), ignore_errors=True)
    ckpt = os.path.join(main_root, "a", "ckpt",
                        f"model_step_{MAIN_STEPS}.npz")
    for d, _, files in os.walk(os.path.join(main_root, "a")):
        for n in files:
            if os.path.join(d, n) != ckpt and n.endswith(".npz"):
                os.remove(os.path.join(d, n))
    root = os.path.join(main_root, "tvc")
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if not rehearse and free < PROGRAM_TVC_FREE_BYTES:
        raise AssertionError(f"{free} bytes free under {root}; the phase "
                             f"needs {PROGRAM_TVC_FREE_BYTES}")
    vids = list(db.vids)[:PROGRAM_TVC_VIDEOS]
    cap_dir, ref, target, n_clips, n_caps = write_caption_store(db, vids,
                                                                root)
    paths = (os.path.join(main_root, "sub_db"),
             os.path.join(main_root, "video_db"), cap_dir, ckpt)
    cfg_a, cfg_b = (tvc_run_config(here, root, n, paths, tcfg, rehearse)
                    for n in ("a", "b"))
    opts = get_tvc_args(["--config", cfg_a])
    video_db = common.load_video_sub_dataset(opts,
                                             common.shapes_from_opts(opts))
    cap_db = TvcCaptionStore(cap_dir, max_txt_len=opts.max_txt_len)
    train_ds = train_tvc.tvc_train_dataset(video_db, cap_db, vars(opts))
    val_ds = TvcClipDataset.from_caption_db(video_db, cap_db,
                                            seg_len=opts.max_clip_len)
    rec = {"stage_s": stage_s, "free_bytes_before": free,
           "videos": len(vids), "clips": n_clips, "captions": n_caps,
           "steps": PROGRAM_TVC_STEPS, "model": "config/hero_tvc.json"
           if not rehearse else "rehearsal",
           "f_encoder_rows": [opts.train_batch_size
                              * video_db.shapes.n_subs,
                              video_db.shapes.frames_per_sub
                              + video_db.shapes.txt_len]}
    stage("write_stores")
    if not rehearse:
        check_tvc_program_kernels(
            torch, tcfg, build_tvc_batch(
                train_ds, list(range(opts.train_batch_size))),
            build_tvc_clip_batch(val_ds, list(range(opts.val_batch_size))),
            kernels)
        log("tvc_program kernel checks passed")
    stage("kernel_checks")
    env = dict(os.environ, HF_HUB_OFFLINE="1")

    def run(cmd, what):
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        return proc

    def train_run(cfg, name, stop_at):
        # a run SIGTERM stops runs in a subprocess; the others here
        if not stop_at:
            return tvc_train_program(cfg, dev, 0)
        out = os.path.join(root, f"{name}.out.json")
        run([sys.executable, "-c", TVC_TRAIN_RUN, cfg, out, dev,
             str(stop_at)], f"train_tvc run {name}")
        with open(out) as f:
            return json.load(f)

    # run A: uninterrupted
    out_a, out_b = (os.path.join(root, n) for n in ("a", "b"))
    t_a = time.perf_counter()
    res_a = train_run(cfg_a, "a", 0)
    rec["run_a_s"] = time.perf_counter() - t_a
    rec["losses"] = res_a["losses"]
    if (len(res_a["losses"]) != PROGRAM_TVC_STEPS
            or not all(math.isfinite(x) for x in res_a["losses"])):
        raise AssertionError(f"run A's losses: {res_a['losses']}")
    if not res_a["bridged_equal"]:
        raise AssertionError("run A's last model file bridged back differs "
                             "from its final state")
    rec["checkpoint_bridged_equal"] = True
    marks = {int(k): v for k, v in res_a["marks"].items()}
    rows = opts.train_batch_size * train_ds.caps_per_video
    rec["window_ms"] = [1e3 * (marks[b] - marks[a])
                        for a, b in PROGRAM_TVC_WINDOWS]
    rec["caption_rows_per_step"] = rows
    rec["caption_rows_per_s"] = (
        sum(b - a for a, b in PROGRAM_TVC_WINDOWS) * rows
        / (1e-3 * sum(rec["window_ms"])))
    rec["tvc_train_captions_per_s"] = train_rate
    records_a = _records(out_a)
    stage("run_a")

    # every clip once in both validations, with finite scores
    rec["scores"] = {}
    for step in sorted({PROGRAM_TVC_VALID_STEPS, PROGRAM_TVC_STEPS}):
        with open(os.path.join(out_a, f"tvc_gen_{step}.jsonl")) as f:
            gen = [json.loads(line) for line in f]
        ids = sorted(int(r["clip_id"]) for r in gen)
        if ids != list(range(n_clips)):
            raise AssertionError(f"tvc_gen_{step}: {len(gen)} records, "
                                 "not every clip once")
        scores = train_tvc.score_clip_captions(gen, val_ds)
        if set(scores) != {"Bleu@4", "ROUGE-L", "CIDEr"} or not all(
                math.isfinite(v) for v in scores.values()):
            raise AssertionError(f"tvc_gen_{step} scores {scores}")
        rec["scores"][f"tvc_gen_{step}"] = scores
        rec["scores"][f"tvc_gen_{step}_tokens_mean"] = float(np.mean(
            [len(r["descs"][0]["desc"].split()) for r in gen]))
    for n in ("restore_backup.npz",
              f"ckpt/model_step_{PROGRAM_TVC_SAVE_STEPS}.npz"):
        if os.path.exists(os.path.join(out_a, n)):
            os.remove(os.path.join(out_a, n))      # disk for run B
    stage("check_a")

    # run B: SIGTERM after step 4, then the command line resumes it
    t_b = time.perf_counter()
    res_b = train_run(cfg_b, "b", PROGRAM_TVC_SIGTERM_AT)
    if res_b["global_step"] != PROGRAM_TVC_SIGTERM_AT:
        raise AssertionError(f"SIGTERM after step {PROGRAM_TVC_SIGTERM_AT}: "
                             f"main returned at {res_b['global_step']}")
    records_b1 = _records(out_b)
    if rehearse:
        run([sys.executable, "-c", TVC_TRAIN_RUN, cfg_b,
             os.path.join(root, "b2.out.json"), dev, "0"], "resume")
    else:
        run([sys.executable, "-m", "hero_tpu_torch.drivers.train_tvc",
             "--config", cfg_b], "python -m hero_tpu_torch.drivers.train_tvc")
    rec["run_b_s"] = time.perf_counter() - t_b
    records_b2 = _records(out_b)
    rec["restore_ms"] = records_b2["restore_ms"]
    rec["saves"] = (_program_saves("run_a", records_a)
                    + _program_saves("run_b_interrupted", records_b1)
                    + _program_saves("run_b_resumed", records_b2))
    stage("run_b")
    for name in (f"ckpt/model_step_{PROGRAM_TVC_STEPS}.npz", "restore.npz"):
        a = _npz(os.path.join(out_a, name))
        b = _npz(os.path.join(out_b, name))
        differ = sorted(k for k in a if k not in b or a[k].dtype
                        != b[k].dtype or not np.array_equal(a[k], b[k]))
        if differ or set(a) != set(b):
            raise AssertionError(f"resumed {name} differs from the "
                                 f"uninterrupted one at {differ[:5]}")
    gen = [os.path.join(d, f"tvc_gen_{PROGRAM_TVC_STEPS}.jsonl")
           for d in (out_a, out_b)]
    with open(gen[0]) as fa, open(gen[1]) as fb:
        if fa.read() != fb.read():
            raise AssertionError("the resumed run's captions differ")
    rec["resume_bit_equal"] = True
    shutil.rmtree(out_b)
    stage("compare")

    # inf_tvc in a subprocess, then in this process
    sub = os.path.join(out_a, "tvc_submission.jsonl")
    argv = ["--output_dir", out_a, "--checkpoint", str(PROGRAM_TVC_STEPS)]
    cmd = ([sys.executable, "-c", TVC_INF_CPU] if rehearse else
           [sys.executable, "-m", "hero_tpu_torch.drivers.inf_tvc"])
    t_p = time.perf_counter()
    proc = run(cmd + argv + ["--reference", ref, "--submission", sub],
               "inf_tvc")
    rec["inf_tvc_wall_s"] = time.perf_counter() - t_p
    with open(sub) as f:
        written = [json.loads(line) for line in f]
    if sorted(r["clip_id"] for r in written) != list(range(n_clips)):
        raise AssertionError("inf_tvc: not every clip once")
    with open(sub + ".scores.json") as f:
        scores = json.load(f)
    if not {"METEOR", "METEOR_variant"} <= set(scores) or json.loads(
            proc.stdout.strip().splitlines()[-1]) != scores:
        raise AssertionError(f"inf_tvc scores {scores}")
    rec["inf_scores"] = scores
    rec["inf_tokens_mean"] = float(np.mean(
        [len(r["descs"][0]["desc"].split()) for r in written]))
    # the program's captions from A's last model file are A's last
    # validation's, from the same weights in the same dtype
    with open(os.path.join(out_a, f"tvc_gen_{PROGRAM_TVC_STEPS}.jsonl")) as f:
        if [json.loads(line) for line in f] != written:
            raise AssertionError("inf_tvc's captions differ from the last "
                                 "validation's")
    rec["inf_equals_validation"] = True
    stage("inf_program")

    generate = inf_tvc.generate_clip_captions
    decode_s = []

    def timed_generate(*a, **k):         # main's decode alone, timed
        sync()
        t = time.perf_counter()
        out = generate(*a, **k)
        sync()
        decode_s.append(time.perf_counter() - t)
        return out

    def in_process(extra, dtype):
        args = inf_tvc.build_argparser().parse_args(
            argv + ["--submission", os.path.join(root, "sub.jsonl")]
            + extra)
        sync()
        t = time.perf_counter()
        inf_tvc.generate_clip_captions = timed_generate
        try:
            out = inf_tvc.main(args, device=dev, dtype=dtype)
        finally:
            inf_tvc.generate_clip_captions = generate
        sync()
        return out, time.perf_counter() - t, decode_s[-1]

    reset_counts()
    got, wall, dec = in_process([], torch.float32)
    inf_launches = read_counts()
    if json.loads(json.dumps(got)) != written:
        raise AssertionError("the program's submission differs from the "
                             "in-process run's")
    rec["submission_equal"] = True
    rec["fp32_main_s"], rec["fp32_decode_s"] = wall, dec
    rec["fp32_captions_per_s"] = n_clips / dec
    got, wall, dec = in_process([], torch.bfloat16)
    if sorted(r["clip_id"] for r in got) != list(range(n_clips)):
        raise AssertionError("bf16 inf_tvc: not every clip once")
    rec["bf16_main_s"], rec["bf16_decode_s"] = wall, dec
    rec["bf16_captions_per_s"] = n_clips / dec
    want = list(range(PROGRAM_TVC_TARGETS))
    for what, extra in (("target_clip", ["--target_clip", target]),
                        ("target_clip_beam3", ["--target_clip", target,
                                               "--beam", str(TVC_BEAM)])):
        got = in_process(extra, torch.float32)[0]
        if sorted(r["clip_id"] for r in got) != want:
            raise AssertionError(f"{what}: {[r['clip_id'] for r in got]}")
        rec[f"{what}_records"] = len(got)
    stage("inf_in_process")
    return rec, res_a["launches"], inf_launches


# ---------------------------------------------------------------------------
# vcmr_program: drivers/train_vcmr, train_vr, eval_vcmr and eval_vr from a
# reference-layout .pt checkpoint and stores on disk
# ---------------------------------------------------------------------------

PT_ROWS = 50265                     # word rows of the released .pt (RoBERTa)
PADDED_KEYS = ("v_encoder/f_encoder/embeddings/word_emb",
               "v_encoder/f_encoder/lm_head/bias")
PROGRAM_VCMR_STEPS, PROGRAM_VCMR_SIGTERM_AT = 4, 2
PROGRAM_VCMR_VALID_STEPS = PROGRAM_VCMR_SAVE_STEPS = 4
PROGRAM_VCMR_WARMUP = 2
PROGRAM_VCMR_HARD_AT = 2            # hard negatives from this step on
PROGRAM_VR_STEPS = 4
# steps timed from disk, away from the validation and saves after step 4:
# 2-3 of TVR and of VR
PROGRAM_VCMR_WINDOWS = PROGRAM_VR_WINDOWS = ((1, 3),)
# train and val queries: TVR's over the first 192 and the last 64 of
# pretrain_main's videos, MSR-VTT's likewise; an epoch covers the steps
PROGRAM_VCMR_QUERIES = (512, 128)
PROGRAM_VR_QUERIES = (768, 128)
PROGRAM_VCMR_TRAIN_VIDEOS = 192
PROGRAM_VCMR_FREE_BYTES = 12 << 30  # the .pt and the runs' files, with room
# the kernels of the unpacked programs: the train steps (their bf16
# validations included) and the in-process eval_vr; #1 takes only
# --pack_subs rows
PROGRAM_VCMR_TRAIN_KERNELS = ("valid_attention_cuda", "attention_bwd_cuda",
                              "layer_norm_cuda", "layer_norm_bwd_cuda")
PROGRAM_VCMR_EVAL_KERNELS = ("valid_attention_cuda", "layer_norm_cuda")

# one run of a finetune program's main (drivers/train_vcmr, train_vr,
# train_videoqa) in a fresh interpreter (its SIGTERM hook needs a main
# thread): the launch counters from 0 around it, the card synchronised at
# the windows' edges (argv[6], JSON) only, SIGTERM after step argv[5] (0:
# never); the losses, the edges' clocks and the counts go to the JSON
# file argv[3]
PROGRAM_TRAIN_RUN = """
import json, sys
from chip_smoke import train_program
from hero_tpu_torch.utils.logger import configure_stdout
program, cfg, out_json, device, stop_at, windows = sys.argv[1:7]
configure_stdout()
res = train_program(program, cfg, device, int(stop_at), json.loads(windows))
with open(out_json, "w") as f:
    json.dump(res, f)
"""


def train_program(program, cfg, device, stop_at, windows):
    """One run of a finetune program's main (the body of
    :data:`PROGRAM_TRAIN_RUN`; in this process for a run that is not
    stopped, and for a rank of the dp phase): ``program``'s main on the
    config at ``cfg``, the counters from 0 around it, SIGTERM after step
    ``stop_at`` (0: never).  Returns the final step, the losses, the
    windows' clocks and the counts."""
    import importlib
    import signal
    import torch
    from hero_tpu_torch.config import opts as opts_lib
    parse = {"train_vcmr": opts_lib.get_vcmr_args,
             "train_vr": opts_lib.get_vr_args,
             "train_videoqa": opts_lib.get_videoqa_args}[program]
    drv = importlib.import_module("hero_tpu_torch.drivers." + program)
    edges = {s for w in windows for s in w}
    losses, marks = [], {}

    def on_step(step, task, metrics):
        losses.append(metrics["loss"].detach())
        if step in edges:
            if device == "cuda":
                torch.cuda.synchronize()
            marks[step] = time.perf_counter()
        if step == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)

    reset_counts()
    state = drv.main(parse(["--config", cfg]), device=device,
                     on_step=on_step,
                     dtype=torch.bfloat16 if device == "cuda"
                     else torch.float32)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"global_step": state.global_step,
            "losses": [float(x) for x in losses], "marks": marks,
            "launches": read_counts()}

# an eval program's main (drivers/eval_vcmr, eval_videoqa) on the CPU in
# fp32: the rehearsal's stand-in for the command line, which serves on
# the card
PROGRAM_EVAL_CPU = """
import importlib, sys, torch
drv = importlib.import_module("hero_tpu_torch.drivers." + sys.argv[1])
drv.configure_stdout()
drv.main(drv.build_argparser().parse_args(sys.argv[2:]), device="cpu",
         dtype=torch.float32)
"""


def write_program_queries(db, vids, vocab, root, name, n_train, n_val,
                          seed, msrvtt=False):
    """A train and a val query store (``write_query_store``) under
    ``root``: ``n_train`` queries over the first
    ``PROGRAM_VCMR_TRAIN_VIDEOS`` of ``vids`` (three quarters of fewer)
    and ``n_val`` over the rest, TVR-like lengths and span targets
    (``make_queries``); ``msrvtt`` keys the rows by ``sen_id`` as
    MSR-VTT's store does.  Returns (train dir, val dir)."""
    cut = min(PROGRAM_VCMR_TRAIN_VIDEOS, len(vids) * 3 // 4)
    dirs = []
    for split, n, part, sd in (("train", n_train, vids[:cut], seed),
                               ("val", n_val, vids[cut:], seed + 1)):
        qb, qdata = make_queries(n, n, QUERY_SLOTS, vocab, part, 1.5,
                                 seed=sd)
        if msrvtt:
            qdata = {q: dict(r, sen_id=q) for q, r in qdata.items()}
        dirs.append(write_query_store(qb[0], qdata, db.txt_db, root,
                                      f"{name}_{split}"))
    return tuple(dirs)


def vcmr_run_config(here, root, name, base, over, rehearse):
    """``config/<base>`` with ``over`` (the paths, the cut) and
    ``root/name`` substituted; returns its path."""
    with open(os.path.join(here, "config", base)) as f:
        raw = json.load(f)
    raw.update(over, output_dir=os.path.join(root, name))
    if rehearse:
        raw.update(train_batch_size=4, vcmr_eval_video_batch_size=4,
                   vcmr_eval_batch_size=16)
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def check_vcmr_program_kernels(torch, cfg, tvr_batch, vr_batch, kernels):
    """#2 and #3 at the programs' f-encoder rows with the batches' own
    masks: TVR's (1024, 77, 768) (32 queries a micro-batch, each on its
    video's 32 rows of 16 frames + 61 tokens) and MSR-VTT video-only's
    (96, 161, 768) (one row of 100 frames + 61 tokens a video), forward
    with dropout and saved probabilities and backward, against their
    plain versions, in fp32 and bf16; added to the rows of
    ``kernels``."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads

    def mask_of(b):
        m = np.concatenate([b["sub_frame_mask"], b["sub_txt_mask"]], -1)
        return torch.from_numpy(
            m.reshape(-1, m.shape[-1]).astype(np.float32)).to(dev)

    def prog(row, what):
        return {**row, "mode": f"vcmr_program: {what}"
                + (f", {row['mode']}" if "mode" in row else "")}

    tm, vm = mask_of(tvr_batch), mask_of(vr_batch)
    t_fwd, t_bwd = check_attention_train(torch, F, att, tm.shape[0],
                                         tm.shape[1], D, H, tm, False)
    v_fwd, v_bwd = check_attention_train(torch, F, att, vm.shape[0],
                                         vm.shape[1], D, H, vm, False)
    new = {"attention_valid": [prog(t_fwd, "TVR f-encoder"),
                               prog(v_fwd, "MSR-VTT video-only f-encoder")],
           "attention_bwd": [prog(t_bwd, "TVR f-encoder"),
                             prog(v_bwd, "MSR-VTT video-only f-encoder")]}
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])
    return {"tvr_rows": list(tm.shape), "vr_rows": list(vm.shape)}


def check_dp_kernels(torch, cfg, b_fit, kernels):
    """#1-#3, #6 and #7 at the shapes :func:`dp_modes` gives them at the
    fit bucket, against their plain versions, added to the rows of
    ``kernels``: PP, a stage's f-encoder micro-batch, #1/#3 at (64, 104,
    768) and #6/#7 over its (6656, 768) rows; TP, a model rank's 6 heads
    at width 384, #1/#3 at the f-encoder's (128, 104, 384) and #2/#3 at
    the c-encoder's (32, 100, 384); SP, a seq rank's 50 frames against
    the 100 keys, #2/#3 at (32, 50->100, 768) and #6/#7 over its (1600,
    768) rows.  Returns the shapes."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads
    B, S = b_fit["sub_mask"].shape
    seg = np.concatenate([b_fit["sub_frame_seg"], b_fit["sub_txt_seg"]], 2)
    seg = torch.from_numpy(seg.reshape(B * S, -1)).to(dev)
    cm = torch.from_numpy(b_fit["c_attn_masks"]).to(dev)
    n_tp = DP_MODES["tp"][1]
    half = seg.shape[0] // DP_PP_MICRO
    frames = cm.shape[1] // DP_MODES["sp"][1]

    def dp(row, what):
        return {**row, "mode": f"dp {what}, {row['mode']}"
                if "mode" in row else f"dp {what}"}

    new = {"attention_seg": [], "attention_valid": [], "attention_bwd": [],
           "layer_norm": [], "layer_norm_bwd": []}
    for key, mask, seg_mode, width, heads, what in (
            ("attention_seg", seg[:half], True, D, H,
             "pp: a stage's f-encoder micro-batch"),
            ("attention_seg", seg, True, D // n_tp, H // n_tp,
             "tp: a model rank's f-encoder heads"),
            ("attention_valid", cm, False, D // n_tp, H // n_tp,
             "tp: a model rank's c-encoder heads")):
        f_row, b_row = check_attention_train(
            torch, F, att, mask.shape[0], mask.shape[1], width, heads, mask,
            seg_mode)
        new[key].append(dp(f_row, what))
        new["attention_bwd"].append(dp(b_row, what))
    what = "sp: a seq rank's frames against every frame"
    f_row, b_row = check_decoder_train(torch, F, att, B, frames,
                                       cm.shape[1], D, H, False, what)
    new["attention_valid"].append(dp(f_row, what))
    new["attention_bwd"].append(dp(b_row, what))
    gen = torch.Generator(device=dev).manual_seed(16)
    for n, what in ((half * seg.shape[1], "pp: a stage's f-encoder rows"),
                    (B * frames, "sp: a seq rank's c-encoder rows")):
        x = torch.randn((n, D), generator=gen, device=dev).to(torch.bfloat16)
        new["layer_norm"].append(dp(check_layer_norm(torch, F, lnm, n, D, x),
                                    what))
        new["layer_norm_bwd"].append(dp(check_layer_norm_bwd(torch, F, lnm,
                                                             n, D), what))
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])
    return {k: [r["shape"] for r in v] for k, v in new.items()}


def same_ranking(a, b, tasks, rtol):
    """Two submissions: the same query ids in every list, (video, st, ed)
    equal and scores within ``rtol``; returns the largest relative score
    difference."""
    worst = 0.0
    if set(a) != set(b) or set(a) != {"video2idx", *tasks}:
        raise AssertionError(f"submission keys {sorted(a)} vs {sorted(b)}")
    for task in tasks:
        if [e["desc_id"] for e in a[task]] != [e["desc_id"]
                                                for e in b[task]]:
            raise AssertionError(f"{task}: the query ids differ")
        for ea, eb in zip(a[task], b[task]):
            pa, pb = (np.asarray(e["predictions"], np.float64)
                      for e in (ea, eb))
            if pa.shape != pb.shape or not np.array_equal(pa[:, :3],
                                                          pb[:, :3]):
                raise AssertionError(f"{task} {ea['desc_id']}: the "
                                     "predictions differ")
            rel = np.abs(pa[:, 3] - pb[:, 3]) / np.maximum(
                np.abs(pb[:, 3]), 1e-12)
            worst = max(worst, float(rel.max(initial=0.0)))
    if worst > rtol:
        raise AssertionError(f"scores differ by {worst} (rtol {rtol})")
    return worst


def vcmr_program_phase(torch, here, cfg, main_root, db, dev, sync,
                       rehearse, kernels):
    """VCMR and VR finetuning and VR serving as programs (see the module
    docstring) from a reference-layout ``.pt`` of pretrain_main's run A
    checkpoint, over the videos it wrote under ``main_root``.  Returns
    (record, {path: launch counts})."""
    from hero_tpu_torch.config.opts import get_vcmr_args
    from hero_tpu_torch.data.downstream_tasks import (VcmrDataset,
                                                      VrDataset,
                                                      build_batch)
    from hero_tpu_torch.data.store import MsrvttQueryTokStore, QueryTokStore
    from hero_tpu_torch.data.testing import reference_state_dict
    from hero_tpu_torch.drivers import common, eval_vr
    from hero_tpu_torch.drivers.eval_vcmr import build_argparser
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    # tvc_program's files go; pretrain_main's stores and checkpoint stay
    shutil.rmtree(os.path.join(main_root, "tvc"), ignore_errors=True)
    npz = os.path.join(main_root, "a", "ckpt",
                       f"model_step_{MAIN_STEPS}.npz")
    root = os.path.join(main_root, "vcmr")
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if not rehearse and free < PROGRAM_VCMR_FREE_BYTES:
        raise AssertionError(f"{free} bytes free under {root}; the phase "
                             f"needs {PROGRAM_VCMR_FREE_BYTES}")
    vocab = cfg.f_config.vocab_size
    rec = {"stage_s": stage_s, "free_bytes_before": free,
           "model": "config/hero_finetune.json" if not rehearse
           else "rehearsal"}

    # the .pt: pretrain_main's checkpoint in the reference layout, the
    # word rows cut to RoBERTa's 50265 as in the released file
    pt = os.path.join(root, "hero-tv-ht100.pt")
    tree = {k: v for k, v in _npz(npz).items() if not k.startswith("__")}
    t = time.perf_counter()
    torch.save({"model": reference_state_dict(tree, PT_ROWS)}, pt)
    rec["pt_write_s"] = time.perf_counter() - t
    rec["pt_bytes"] = os.path.getsize(pt)
    del tree
    stage("write_pt")
    init = init_flat_params(cfg, VsmConfig(), seed=1)
    info = {}
    t = time.perf_counter()
    from_pt = common.load_checkpoint_into(init, pt, vocab, info=info)
    rec["pt_load_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    from_npz = common.load_checkpoint_into(init, npz)
    rec["npz_load_ms"] = 1e3 * (time.perf_counter() - t)
    if info != {"vocab_padded": True} or sorted(from_pt) != sorted(from_npz):
        raise AssertionError(f"the .pt load: info {info}, keys differ "
                             f"{sorted(set(from_pt) ^ set(from_npz))[:5]}")
    for k, want in from_npz.items():
        got = from_pt[k]
        if k in PADDED_KEYS:
            same = (np.array_equal(got[:PT_ROWS], want[:PT_ROWS])
                    and not got[PT_ROWS:].any())
        else:
            same = got.dtype == want.dtype and np.array_equal(got, want)
        if not same:
            raise AssertionError(f"the .pt load differs from the .npz's "
                                 f"at {k}")
    rec["pt_load_equal"] = True
    rec["pt_padded_rows"] = vocab - PT_ROWS
    del from_pt, from_npz, init
    stage("hold_pt_load")

    # the stores: TVR and MSR-VTT query stores over pretrain_main's videos
    vids = list(db.vids)
    sub_dir = os.path.join(main_root, "sub_db")
    feat_dir = os.path.join(main_root, "video_db")
    nq_t, nq_v = (48, 16) if rehearse else PROGRAM_VCMR_QUERIES
    tvr_train, tvr_val = write_program_queries(db, vids, vocab - 8, root,
                                               "tvr", nq_t, nq_v, 71)
    nr_t, nr_v = (48, 16) if rehearse else PROGRAM_VR_QUERIES
    msr_train, msr_val = write_program_queries(db, vids, vocab - 8, root,
                                               "msrvtt", nr_t, nr_v, 73,
                                               msrvtt=True)
    model_json = os.path.join(main_root, "model.json")
    tvr_over = dict(sub_txt_db=sub_dir, vfeat_db=feat_dir,
                    train_query_txt_db=tvr_train, val_query_txt_db=tvr_val,
                    model_config=model_json, checkpoint=pt,
                    vfeat_dim=cfg.vfeat_dim,
                    num_train_steps=PROGRAM_VCMR_STEPS,
                    valid_steps=PROGRAM_VCMR_VALID_STEPS,
                    save_steps=PROGRAM_VCMR_SAVE_STEPS,
                    warmup_steps=PROGRAM_VCMR_WARMUP,
                    hard_negtiave_start_step=[PROGRAM_VCMR_HARD_AT])
    cfg_a, cfg_b = (vcmr_run_config(here, root, n, "train-tvr.json",
                                    tvr_over, rehearse) for n in ("a", "b"))
    cfg_vr = vcmr_run_config(
        here, root, "vr", "train-msrvtt_video_only.json",
        dict(vfeat_db=feat_dir, train_query_txt_db=msr_train,
             val_query_txt_db=msr_val, model_config=model_json,
             checkpoint=pt, vfeat_dim=cfg.vfeat_dim,
             num_train_steps=PROGRAM_VR_STEPS,
             valid_steps=PROGRAM_VR_STEPS, save_steps=PROGRAM_VR_STEPS,
             warmup_steps=PROGRAM_VCMR_WARMUP), rehearse)
    opts_a, opts_vr = (get_vcmr_args(["--config", c])
                       for c in (cfg_a, cfg_vr))
    rec["tvr"] = {k: getattr(opts_a, k) for k in (
        "train_batch_size", "gradient_accumulation_steps", "learning_rate",
        "drop_svmr_prob", "lw_st_ed", "lw_neg_ctx", "lw_neg_q",
        "hard_negtiave_start_step", "max_txt_len", "max_clip_len")}
    rec["vr"] = {k: getattr(opts_vr, k) for k in (
        "task", "train_batch_size", "gradient_accumulation_steps",
        "learning_rate", "lw_neg_ctx", "lw_neg_q", "max_clip_len",
        "full_eval_tasks")}
    stage("write_stores")
    if not rehearse:
        def first_batch(opts, ds_cls, store_cls):
            shapes = common.shapes_from_opts(opts).replace(n_queries=1)
            video_db = common.load_task_video_dataset(opts, shapes)
            ds = ds_cls(list(video_db.vids), video_db,
                        store_cls(opts.train_query_txt_db,
                                  max_txt_len=opts.max_txt_len),
                        sampled_by_q=True, seed=opts.seed)
            return build_batch(ds, list(range(opts.train_batch_size)))
        rec.update(check_vcmr_program_kernels(
            torch, cfg, first_batch(opts_a, VcmrDataset, QueryTokStore),
            first_batch(opts_vr, VrDataset, MsrvttQueryTokStore), kernels))
        log("vcmr_program kernel checks passed")
    stage("kernel_checks")
    env = dict(os.environ, HF_HUB_OFFLINE="1")

    def run(cmd, what):
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        return proc

    def train_run(program, cfg_path, name, stop_at, windows):
        # a run SIGTERM stops runs in a subprocess; the others here
        if stop_at:
            out = os.path.join(root, f"{name}.out.json")
            run([sys.executable, "-c", PROGRAM_TRAIN_RUN, program, cfg_path,
                 out, dev, str(stop_at), json.dumps(windows)],
                f"{program} run {name}")
            with open(out) as f:
                res = json.load(f)
        else:
            res = train_program(program, cfg_path, dev, 0, windows)
        if not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"{program} run {name}: losses "
                                 f"{res['losses']}")
        return res

    def rate(res, windows, per_step):
        marks = {int(k): v for k, v in res["marks"].items()}
        ms = [1e3 * (marks[b] - marks[a]) for a, b in windows]
        return ms, (sum(b - a for a, b in windows) * per_step
                    / (1e-3 * sum(ms)))

    def results(out_dir, step, tasks):
        with open(os.path.join(out_dir, f"results_{step}_all.json")) as f:
            sub = json.load(f)
        if set(sub) != {"video2idx", *tasks} or not all(sub[t]
                                                         for t in tasks):
            raise AssertionError(f"results_{step}_all.json: "
                                 f"{sorted(sub)}")
        return sub

    # TVR run A: uninterrupted
    out_a, out_b = (os.path.join(root, n) for n in ("a", "b"))
    t_a = time.perf_counter()
    res_a = train_run("train_vcmr", cfg_a, "a", 0, PROGRAM_VCMR_WINDOWS)
    rec["run_a_s"] = time.perf_counter() - t_a
    if res_a["global_step"] != PROGRAM_VCMR_STEPS or len(
            res_a["losses"]) != PROGRAM_VCMR_STEPS:
        raise AssertionError(f"TVR run A: {res_a['global_step']} steps")
    rec["tvr_losses"] = res_a["losses"]
    per_step = opts_a.train_batch_size * opts_a.gradient_accumulation_steps
    rec["tvr_window_ms"], rec["tvr_queries_per_s"] = rate(
        res_a, PROGRAM_VCMR_WINDOWS, per_step)
    tasks = ("VCMR", "SVMR", "VR")
    for step in sorted({PROGRAM_VCMR_VALID_STEPS, PROGRAM_VCMR_STEPS}):
        results(out_a, step, tasks)
    with open(os.path.join(out_a, "log", "log.txt")) as f:
        rec["tvr_validation_log"] = [ln.strip() for ln in f
                                     if "] VR:" in ln or "] VCMR:" in ln]
    model_a = os.path.join(out_a, "ckpt",
                           f"model_step_{PROGRAM_VCMR_STEPS}.npz")
    with np.load(model_a) as z:
        rec["model_vocab_padded"] = bool(z["__vocab_padded__"])
    if not rec["model_vocab_padded"]:
        raise AssertionError("the model file lost the .pt's pad marker")
    records_a = _records(out_a)
    stage("tvr_run_a")

    # TVR run B: SIGTERM after step 2, then the command line resumes it
    t_b = time.perf_counter()
    res_b = train_run("train_vcmr", cfg_b, "b", PROGRAM_VCMR_SIGTERM_AT,
                      ())
    if res_b["global_step"] != PROGRAM_VCMR_SIGTERM_AT:
        raise AssertionError(f"SIGTERM after step {PROGRAM_VCMR_SIGTERM_AT}:"
                             f" main returned at {res_b['global_step']}")
    records_b1 = _records(out_b)
    if rehearse:
        run([sys.executable, "-c", PROGRAM_TRAIN_RUN, "train_vcmr", cfg_b,
             os.path.join(root, "b2.out.json"), dev, "0", "[]"], "resume")
    else:
        run([sys.executable, "-m", "hero_tpu_torch.drivers.train_vcmr",
             "--config", cfg_b],
            "python -m hero_tpu_torch.drivers.train_vcmr")
    rec["run_b_s"] = time.perf_counter() - t_b
    records_b2 = _records(out_b)
    rec["restore_ms"] = records_b2["restore_ms"]
    rec["saves"] = (_program_saves("run_a", records_a)
                    + _program_saves("run_b_interrupted", records_b1)
                    + _program_saves("run_b_resumed", records_b2))
    stage("tvr_run_b")
    for name in (f"ckpt/model_step_{PROGRAM_VCMR_STEPS}.npz",
                 "restore.npz"):
        a = _npz(os.path.join(out_a, name))
        b = _npz(os.path.join(out_b, name))
        differ = sorted(k for k in a if k not in b or a[k].dtype
                        != b[k].dtype or not np.array_equal(a[k], b[k]))
        if differ or set(a) != set(b):
            raise AssertionError(f"resumed {name} differs from the "
                                 f"uninterrupted one at {differ[:5]}")
    rec["resume_bit_equal"] = True
    rec["resume_results_equal"] = (
        results(out_b, PROGRAM_VCMR_STEPS, tasks)
        == results(out_a, PROGRAM_VCMR_STEPS, tasks))
    shutil.rmtree(out_b)
    for n in ("restore.npz", "restore_backup.npz"):
        if os.path.exists(os.path.join(out_a, n)):
            os.remove(os.path.join(out_a, n))      # disk for the VR run
    stage("tvr_compare")

    # eval_vcmr in a subprocess on A's directory: A's last validation
    cmd = ([sys.executable, "-c", PROGRAM_EVAL_CPU, "eval_vcmr"] if rehearse
           else [sys.executable, "-m", "hero_tpu_torch.drivers.eval_vcmr"])
    t_e = time.perf_counter()
    run(cmd + ["--output_dir", out_a, "--checkpoint",
               str(PROGRAM_VCMR_STEPS)], "eval_vcmr")
    rec["eval_vcmr_wall_s"] = time.perf_counter() - t_e
    with open(os.path.join(out_a, f"results_{PROGRAM_VCMR_STEPS}"
                                  "_val_all.json")) as f:
        served = json.load(f)
    rec["eval_vcmr_max_rel_score_diff"] = same_ranking(
        served, results(out_a, PROGRAM_VCMR_STEPS, tasks), tasks, 1e-4)
    rec["eval_vcmr_equal"] = True
    stage("eval_vcmr")

    # train_vr: MSR-VTT video-only, one 161-slot row a video
    t_v = time.perf_counter()
    res_vr = train_run("train_vr", cfg_vr, "vr", 0, PROGRAM_VR_WINDOWS)
    rec["vr_run_s"] = time.perf_counter() - t_v
    if res_vr["global_step"] != PROGRAM_VR_STEPS:
        raise AssertionError(f"train_vr: {res_vr['global_step']} steps")
    rec["vr_losses"] = res_vr["losses"]
    out_vr = os.path.join(root, "vr")
    per_step = (opts_vr.train_batch_size
                * opts_vr.gradient_accumulation_steps)
    rec["vr_window_ms"], rec["vr_queries_per_s"] = rate(
        res_vr, PROGRAM_VR_WINDOWS, per_step)
    vr_sub = results(out_vr, PROGRAM_VR_STEPS, ("VR",))
    rec["vr_saves"] = _program_saves("vr", _records(out_vr))
    stage("train_vr")

    # eval_vr in this process, the launch counters from 0
    reset_counts()
    sync()
    t_i = time.perf_counter()
    metrics, sub = eval_vr.main(build_argparser().parse_args(
        ["--output_dir", out_vr, "--checkpoint", str(PROGRAM_VR_STEPS)]),
        device=dev, dtype=torch.float32 if rehearse else torch.bfloat16)
    sync()
    rec["eval_vr_s"] = time.perf_counter() - t_i
    eval_launches = read_counts()
    if "VCMR" in sub or "VR" not in metrics:
        raise AssertionError(f"eval_vr: {sorted(sub)}, {sorted(metrics)}")
    rec["eval_vr_max_rel_score_diff"] = same_ranking(
        json.loads(json.dumps(sub)), vr_sub, ("VR",), 1e-4)
    rec["vr_metrics"] = metrics["VR"]
    stage("eval_vr")
    return rec, {"vcmr_program": res_a["launches"],
                 "vr_program": res_vr["launches"],
                 "vr_eval": eval_launches}


# ---------------------------------------------------------------------------
# qa_program: drivers/train_videoqa, eval_videoqa, train_violin and
# eval_violin from the reference-layout .pt and stores on disk
# ---------------------------------------------------------------------------

PROGRAM_QA_STEPS, PROGRAM_QA_SIGTERM_AT = 4, 2
PROGRAM_QA_VALID_STEPS = PROGRAM_QA_SAVE_STEPS = 4
PROGRAM_QA_WARMUP = 2
PROGRAM_VIOLIN_STEPS = 4
# steps timed from disk, away from the validation and saves after step 4:
# 2-3 of TVQA and of VIOLIN
PROGRAM_QA_WINDOWS = PROGRAM_VIOLIN_WINDOWS = ((1, 3),)
# TVQA questions and VIOLIN statement pairs, train over the first 192 of
# pretrain_main's videos and val over the other 64
PROGRAM_QA_QUESTIONS = (256, 32)
PROGRAM_VIOLIN_PAIRS = (192, 32)
PROGRAM_QA_ANSWERS = 5              # config/train-tvqa.json's num_answers
PROGRAM_QA_FREE_BYTES = 12 << 30    # the runs' checkpoints, with room
PROGRAM_QA_CHECK_ITEMS = 2          # questions (pairs) of the bf16 checks


def write_qa_stores(db, vids, vocab, root, sizes):
    """TVQA-layout question stores and VIOLIN statement stores under
    ``root`` (``QueryTokStore``'s layout, the special ids of ``db``'s sub
    store in ``meta.json``): ``sizes`` = ((train, val) questions, (train,
    val) statement pairs), train over the first
    ``PROGRAM_VCMR_TRAIN_VIDEOS`` of ``vids`` (three quarters of fewer)
    and val over the rest.  A question holds ``[q] + 5 answers`` of ids
    below ``vocab`` (TVQA-like lengths: questions N(15, 4) tokens,
    answers N(7, 3)), an answer index and a ``ts`` span inside the video;
    a statement pair ``{i}_0`` / ``{i}_1`` (N(20, 5) tokens each) has one
    true statement.  Returns {store name: directory}."""
    from hero_tpu_torch.data.store import HeroStoreWriter
    r = np.random.RandomState(83)
    cut = min(PROGRAM_VCMR_TRAIN_VIDEOS, len(vids) * 3 // 4)
    subs = db.txt_db
    meta = {"CLS": subs.cls_, "SEP": subs.sep, "PAD": subs.pad,
            "MASK": subs.mask, "v_range": list(subs.v_range)}

    def ids(mean, sd, lo, hi):
        n = int(np.clip(round(r.normal(mean, sd)), lo, hi))
        return r.randint(3, vocab, n).tolist()

    def write(name, recs):
        d = os.path.join(root, name)
        id2len, q2v = {}, {}
        with HeroStoreWriter(d) as w:
            for qid, vid, rec, n in recs:
                w.put(qid, rec)
                id2len[qid], q2v[qid] = n, vid
        for fname, obj in (("id2len.json", id2len),
                           ("query2video.json", q2v), ("meta.json", meta)):
            with open(os.path.join(d, fname), "w") as f:
                json.dump(obj, f)
        return d

    dirs = {}
    (nq_t, nq_v), (np_t, np_v) = sizes
    for split, nq, npair, part in (("train", nq_t, np_t, vids[:cut]),
                                   ("val", nq_v, np_v, vids[cut:])):
        recs = []
        for i in range(nq):
            vid = part[i % len(part)]
            dur = db.nframes(vid) * 1.5
            st = float(r.uniform(0, 0.8 * dur))
            q = ids(15, 4, 5, 30)
            answers = [ids(7, 3, 1, 20) for _ in range(PROGRAM_QA_ANSWERS)]
            recs.append((f"q{split}{i}", vid, {
                "input_ids": [q] + answers,
                "target": int(r.randint(PROGRAM_QA_ANSWERS)),
                "ts": [st, min(dur, st + float(r.uniform(3, 20)))]}, len(q)))
        dirs[f"tvqa_{split}"] = write(f"tvqa_{split}", recs)
        recs = []
        for i in range(npair):
            vid = part[i % len(part)]
            first = int(r.randint(2))
            for suffix, tgt in (("_0", first), ("_1", 1 - first)):
                s_ids = ids(20, 5, 6, 40)
                recs.append((f"s{split}{i}{suffix}", vid,
                             {"input_ids": s_ids, "target": tgt},
                             len(s_ids)))
        dirs[f"violin_{split}"] = write(f"violin_{split}", recs)
    return dirs


def check_qa_program_kernels(torch, cfg, qa_batch, packed_batch, kernels):
    """The kernels at TVQA's shapes, with the batches' own masks, against
    their plain versions; added to the rows of ``kernels``: #2 and #3 at
    the unpacked f-encoder rows (a micro-batch of 4 questions x 5 answers
    x 32 subs of 16 frames + 120 tokens: (640, 136, 768)) and at the fused
    c-encoder rows (20 rows of 100 frames + 32 QA tokens: (20, 132, 768),
    the mask ``[frames | pad frames | tokens | pad tokens]``, not a
    prefix), and #1 and #3 at the ``--pack_subs`` rows (8 rows of 16
    frames + 184 tokens a copy: (160, 200, 768)), in fp32 and bf16; #6 and
    #7 at the step's LayerNorm widths (img_ln, the f- and c-encoders, the
    heads' MLP LayerNorms over the span rows and the answer rows).
    Returns the shapes."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads

    def on_dev(m, dtype=np.float32):
        return torch.from_numpy(
            np.ascontiguousarray(m.reshape(-1, m.shape[-1]).astype(dtype))
        ).to(dev)

    def prog(row, what):
        return {**row, "mode": f"qa_program: {what}"
                + (f", {row['mode']}" if "mode" in row else "")}

    fm = on_dev(np.concatenate([qa_batch["sub_frame_mask"],
                                qa_batch["sub_txt_mask"]], -1))
    frames = qa_batch["c_attn_masks"]
    if not (frames.sum(-1) < frames.shape[-1]).any():
        raise AssertionError("no video of the micro-batch has fewer frames "
                             "than max_clip_len: the c-encoder mask would "
                             "be a prefix")
    cm = on_dev(np.concatenate([frames, qa_batch["qa_attn_masks"]], -1))
    seg = on_dev(np.concatenate([packed_batch["sub_frame_seg"],
                                 packed_batch["sub_txt_seg"]], -1), np.int32)
    f_fwd, f_bwd = check_attention_train(torch, F, att, fm.shape[0],
                                         fm.shape[1], D, H, fm, False)
    c_fwd, c_bwd = check_attention_train(torch, F, att, cm.shape[0],
                                         cm.shape[1], D, H, cm, False)
    p_fwd, p_bwd = check_attention_train(torch, F, att, seg.shape[0],
                                         seg.shape[1], D, H, seg, True)
    B, S, Fs = qa_batch["sub_frame_idx"].shape
    Nv = qa_batch["targets"].shape[0]
    F_ = frames.shape[1]
    D2 = 2 * cfg.c_config.hidden_size
    gen = torch.Generator(device=dev).manual_seed(29)
    ln_shapes = (("img_ln", B * S * Fs, cfg.vfeat_dim),
                 ("f-encoder", fm.numel(), D),
                 ("c-encoder", cm.numel(), D),
                 ("st_ed_pred_head", Nv * F_, D2),
                 ("qa_pred_head", B, D2))
    new = {
        "attention_valid": [prog(f_fwd, "TVQA f-encoder"),
                            prog(c_fwd, "TVQA fused c-encoder")],
        "attention_seg": [prog(p_fwd, "TVQA --pack_subs f-encoder")],
        "attention_bwd": [prog(f_bwd, "TVQA f-encoder"),
                          prog(c_bwd, "TVQA fused c-encoder"),
                          prog(p_bwd, "TVQA --pack_subs f-encoder")],
        "layer_norm": [prog(check_layer_norm(
            torch, F, lnm, n, w, torch.randn((n, w), generator=gen,
                                             device=dev).to(torch.bfloat16)),
            what) for what, n, w in ln_shapes],
        "layer_norm_bwd": [prog(check_layer_norm_bwd(torch, F, lnm, n, w),
                                what) for what, n, w in ln_shapes]}
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])
    return {"f_encoder_rows": list(fm.shape), "c_encoder_rows":
            list(cm.shape), "packed_rows": list(seg.shape),
            "ln_rows": {what: [n, w] for what, n, w in ln_shapes}}


def qa_batch_of(ds, n, violin=False):
    """The first ``n`` items of ``ds`` as a flattened host batch (VIOLIN's
    targets one per row), ``__`` entries dropped."""
    from hero_tpu_torch.data.downstream_tasks import build_batch
    b = {k: v for k, v in build_batch(ds, list(range(n)),
                                      flatten_rows=True).items()
         if not k.startswith("__")}
    if violin:
        b["targets"] = b["targets"].reshape(-1)
    return b


def zero_sum_bound(rows, row_len, weight, bf16):
    """The bound on a gradient whose exact value is 0: that of a bias
    which adds one constant to every logit of a softmax row (the answer
    head's over the answers, the span head's over the frames).  It is
    the sum over ``rows`` rows of ``row_len`` terms weight * (softmax -
    one-hot) / rows, at most 2 * weight in magnitude together, whose
    exact sum is 0.  Each row's softmax sums to 1 within 4 * row_len
    fp32 ulps (u = 2^-24), and the fp32 sum of the terms errs by at most
    their count times u times their magnitude.  On a bf16 path each term
    is also rounded to bf16 where it enters the bf16 logits (2^-9 of
    itself: 2^-8 * weight together), and the sum once more where it
    leaves the bf16 bias (no more than that again)."""
    u = 2.0 ** -24
    bound = weight * (4 * row_len + 2 * rows * row_len) * u
    return bound + (weight * 2.0 ** -7 if bf16 else 0.0)


def violin_bias_bound(torch, cfg, params, seed):
    """``bounds`` of :func:`bf16_step_check` for the VIOLIN loss: the
    output bias of ``violin_pred_head`` is one element, whose gradient is
    the sum over the N rows of d_i = (sigmoid(x_i) - t_i) / N, x_i the
    row's bf16 logit.  Between the kernels' step and the plain one it
    moves by at most sum |d_i(kernels) - d_i(plain)|, from the two
    steps' own logits (the same forward, dropout seed and grad mode),
    plus the roundings of either path: each d_i to bf16 (2^-9 of
    itself), the sum to bf16 (2^-9 of it), and the fp32 loss's
    derivative and sum (8 + N ulps of sum |d_i|)."""
    from hero_tpu_torch.models.violin import forward_violin
    from hero_tpu_torch.training.step import loss_and_grads
    leaf = "head/violin_pred_head/linear_2/bias"

    def logits(p, b, sd):
        x = forward_violin(p, cfg, b, compute_loss=False, train=True,
                           seed=sd, dtype=torch.bfloat16)[..., 0].float()
        return x.sum(), {"x": x}

    def bounds(batch):
        xk = loss_and_grads(logits, params, batch, seed)[1]["x"]
        with plain_packed_attention():
            xp = loss_and_grads(logits, params, batch, seed)[1]["x"]
        t = batch["targets"].reshape(-1).float()
        n = t.numel()
        dk, dp = (torch.sigmoid(xk) - t) / n, (torch.sigmoid(xp) - t) / n
        mag = float(dk.abs().sum() + dp.abs().sum())
        return {leaf: float((dk - dp).abs().sum())
                + 2.0 ** -9 * (mag + float(dk.sum().abs() + dp.sum().abs()))
                + (8 + n) * 2.0 ** -24 * mag}
    return bounds


def qa_step_checks(torch, cfg, qa, vl, dev, dev_kernel, dev_plain):
    """For the VideoQA loss (``qa_loss + lw_st_ed * st_ed_loss``) and the
    VIOLIN loss: one fp32 step through the kernels on ``dev_kernel``
    against the plain path on ``dev_plain`` at the flagship widths cut to
    2 + 1 layers on one question (pair) cut to its first 8 sub rows,
    dropout off, with ``config/train-*.json``'s ``lr_mul``
    (:func:`step_parity`); and one
    bf16 step with dropout at full depth through the kernels against the
    plain attention versions on ``dev`` on ``PROGRAM_QA_CHECK_ITEMS``
    questions (pairs) (:func:`bf16_step_check`).  ``qa`` / ``vl``: (the
    run's options, its dataset).  The VideoQA heads' output biases shift
    every logit of a softmax row alike, so their exact gradients are 0
    and are held to :func:`zero_sum_bound`; VIOLIN's one-element output
    bias is held to :func:`violin_bias_bound` in bf16."""
    from hero_tpu_torch.convert import from_jax
    from hero_tpu_torch.data.loader import to_device
    from hero_tpu_torch.drivers import common, train_videoqa, train_violin
    from hero_tpu_torch.models.videoqa import init_hero_for_videoqa
    from hero_tpu_torch.models.violin import init_hero_for_violin
    from hero_tpu_torch.training import optim
    small = cfg.replace(
        f_config=cfg.f_config.replace(num_hidden_layers=2),
        c_config=cfg.c_config.replace(num_hidden_layers=1))
    (qopts, qds), (vopts, vds) = qa, vl
    A = qopts.num_answers

    def qa_loss(c, dt, train):
        return train_videoqa.make_loss_fn(c, A, qopts.lw_st_ed, dt,
                                          train=train)

    def vl_loss(c, dt, train):
        return train_violin.make_loss_fn(c, dt, train=train)

    def fp32_batch(ds, violin):
        # one question (pair) on its first 8 sub rows: the CPU side of
        # the check runs in fp32 at flagship width
        b = qa_batch_of(ds, 1, violin)
        return {k: v[:, :8] if k.startswith("sub_") else v
                for k, v in b.items()}

    def qa_zero_grads(batch, bf16):
        # the answer bias over the A answers and the span bias (start,
        # end) over the frames, of each question; lw_st_ed / 2 weighs
        # each of start and end
        nv = batch["targets"].shape[0]
        frames = batch["c_attn_masks"].shape[-1]
        return {"head/qa_pred_head/linear_2/bias":
                zero_sum_bound(nv, A, 1.0, bf16),
                "head/st_ed_pred_head/linear_2/bias":
                zero_sum_bound(nv, frames, qopts.lw_st_ed / 2, bf16)}

    rec = {"fp32": {}, "bf16_step": {}}
    for name, init, load, loss, opts, ds, violin in (
            ("videoqa", init_hero_for_videoqa,
             from_jax.load_jax_videoqa_params, qa_loss, qopts, qds, False),
            ("violin", init_hero_for_violin,
             from_jax.load_jax_violin_params, vl_loss, vopts, vds, True)):
        spec = common.train_spec(dict(vars(opts), learning_rate=1e-4,
                                      warmup_steps=1))
        batch = fp32_batch(ds, violin)
        rec["fp32"][name] = step_parity(
            torch, init(small, seed=1), batch,
            loss(small, torch.float32, False), spec, dev_kernel, dev_plain,
            heads=None, what=f"fp32 {name} step",
            load=lambda f, d, load=load: load(f, device=d),
            zero_grads=None if violin else qa_zero_grads(batch, False))
        params = load(init(cfg, seed=1), device=dev)
        batch = qa_batch_of(ds, PROGRAM_QA_CHECK_ITEMS, violin)
        rec["bf16_step"][name] = bf16_step_check(
            torch, lambda dt, loss=loss: loss(cfg, dt, True), params,
            [to_device(batch, dev)], 11,
            ["/".join(p) for p in optim.tree_paths(params)],
            zero_grads=None if violin else qa_zero_grads(batch, True),
            bounds=(violin_bias_bound(torch, cfg, params, 11) if violin
                    else None))[0]
        del params
    return rec


def qa_program_phase(torch, here, cfg, main_root, db, dev, sync, rehearse,
                     kernels):
    """VideoQA and VIOLIN finetuning and inference as programs (see the
    module docstring) from the reference-layout ``.pt`` the vcmr_program
    phase wrote under ``main_root``, over pretrain_main's videos.
    Returns (record, {path: launch counts})."""
    from hero_tpu_torch.config.opts import get_videoqa_args, get_violin_args
    from hero_tpu_torch.data.downstream_tasks import build_batch
    from hero_tpu_torch.drivers import common, eval_violin
    from hero_tpu_torch.drivers import train_videoqa, train_violin
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    # vcmr_program's runs go; its .pt and pretrain_main's stores stay
    vroot = os.path.join(main_root, "vcmr")
    pt = os.path.join(vroot, "hero-tv-ht100.pt")
    for n in os.listdir(vroot):
        if os.path.join(vroot, n) != pt:
            path = os.path.join(vroot, n)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
    root = os.path.join(main_root, "qa")
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if not rehearse and free < PROGRAM_QA_FREE_BYTES:
        raise AssertionError(f"{free} bytes free under {root}; the phase "
                             f"needs {PROGRAM_QA_FREE_BYTES}")
    sizes = (((16, 8), (12, 6)) if rehearse
             else (PROGRAM_QA_QUESTIONS, PROGRAM_VIOLIN_PAIRS))
    stores = write_qa_stores(db, list(db.vids), cfg.f_config.vocab_size - 8,
                             root, sizes)
    model_json = os.path.join(main_root, "model.json")
    common_over = dict(sub_txt_db=os.path.join(main_root, "sub_db"),
                       vfeat_db=os.path.join(main_root, "video_db"),
                       model_config=model_json, checkpoint=pt,
                       vfeat_dim=cfg.vfeat_dim,
                       warmup_steps=PROGRAM_QA_WARMUP)
    if rehearse:
        # the plain Philox dropout is slow on the CPU: 2 items of 4 rows
        common_over.update(train_batch_size=2, val_batch_size=4,
                           bucket_n_subs=4)
    qa_over = dict(common_over, train_query_txt_db=stores["tvqa_train"],
                   val_query_txt_db=stores["tvqa_val"],
                   num_train_steps=PROGRAM_QA_STEPS,
                   valid_steps=PROGRAM_QA_VALID_STEPS,
                   save_steps=PROGRAM_QA_SAVE_STEPS)
    cfg_a, cfg_b = (vcmr_run_config(here, root, n, "train-tvqa.json",
                                    qa_over, False) for n in ("a", "b"))
    cfg_vl = vcmr_run_config(
        here, root, "violin", "train-violin.json",
        dict(common_over, train_query_txt_db=stores["violin_train"],
             val_query_txt_db=stores["violin_val"],
             num_train_steps=PROGRAM_VIOLIN_STEPS,
             valid_steps=PROGRAM_VIOLIN_STEPS,
             save_steps=PROGRAM_VIOLIN_STEPS), False)
    qopts = get_videoqa_args(["--config", cfg_a])
    vopts = get_violin_args(["--config", cfg_vl])
    rec = {"stage_s": stage_s, "free_bytes_before": free,
           "model": "config/hero_finetune.json" if not rehearse
           else "rehearsal",
           "questions": list(sizes[0]), "statement_pairs": list(sizes[1])}
    rec["tvqa"] = {k: getattr(qopts, k) for k in (
        "train_batch_size", "gradient_accumulation_steps", "learning_rate",
        "lr_mul", "lw_st_ed", "num_answers", "max_txt_len", "sub_ctx_len",
        "bucket_query_len", "val_batch_size")}
    rec["violin"] = {k: getattr(vopts, k) for k in (
        "train_batch_size", "gradient_accumulation_steps", "learning_rate",
        "lr_mul", "max_txt_len", "sub_ctx_len", "val_batch_size")}
    stage("write_stores")

    def dataset(opts, task, pack=False):
        if pack:
            opts = types.SimpleNamespace(**dict(vars(opts), pack_subs=True))
        video_db = common.load_video_sub_dataset(
            opts, common.shapes_from_opts(opts))
        mod = train_videoqa if task == "videoqa" else train_violin
        make = (mod.videoqa_dataset if task == "videoqa"
                else mod.violin_dataset)
        return make(video_db, opts.train_query_txt_db, opts)

    qds, vds = dataset(qopts, "videoqa"), dataset(vopts, "violin")
    if not rehearse:
        n = qopts.train_batch_size
        rec.update(check_qa_program_kernels(
            torch, cfg, qa_batch_of(qds, n),
            build_batch(dataset(qopts, "videoqa", pack=True),
                        list(range(n)), flatten_rows=True), kernels))
        log("qa_program kernel checks passed")
    stage("kernel_checks")
    rec.update(qa_step_checks(torch, cfg, (qopts, qds), (vopts, vds), dev,
                              "cpu" if rehearse else "cuda", "cpu"))
    del qds, vds
    if dev == "cuda":
        # the fp32 steps' blocks stay cached in this process: hand them
        # back before the programs' processes take the card
        torch.cuda.empty_cache()
    stage("step_checks")
    env = dict(os.environ, HF_HUB_OFFLINE="1")

    def run(cmd, what):
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        return proc

    def train_run(cfg_path, name, stop_at, windows):
        # a run SIGTERM stops runs in a subprocess; the others here
        if stop_at:
            out = os.path.join(root, f"{name}.out.json")
            run([sys.executable, "-c", PROGRAM_TRAIN_RUN, "train_videoqa",
                 cfg_path, out, dev, str(stop_at), json.dumps(windows)],
                f"train_videoqa run {name}")
            with open(out) as f:
                res = json.load(f)
        else:
            res = train_program("train_videoqa", cfg_path, dev, 0, windows)
        if not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"train_videoqa run {name}: losses "
                                 f"{res['losses']}")
        return res

    def rate(marks, windows, per_step):
        marks = {int(k): v for k, v in marks.items()}
        ms = [1e3 * (marks[b] - marks[a]) for a, b in windows]
        return ms, (sum(b - a for a, b in windows) * per_step
                    / (1e-3 * sum(ms)))

    def validation(out_dir, step, n):
        with open(os.path.join(out_dir, f"val_results_{step}.json")) as f:
            val = json.load(f)
        if val["log"]["n_ex"] != n or len(val["results"]) != n:
            raise AssertionError(f"val_results_{step}.json: {val['log']}")
        return val

    def vocab_padded(out_dir, step):
        with np.load(os.path.join(out_dir, "ckpt",
                                  f"model_step_{step}.npz")) as z:
            if not bool(z["__vocab_padded__"]):
                raise AssertionError("the model file lost the .pt's pad "
                                     "marker")
        return True

    # TVQA run A: uninterrupted
    out_a, out_b = (os.path.join(root, n) for n in ("a", "b"))
    t_a = time.perf_counter()
    res_a = train_run(cfg_a, "a", 0, PROGRAM_QA_WINDOWS)
    rec["run_a_s"] = time.perf_counter() - t_a
    if res_a["global_step"] != PROGRAM_QA_STEPS or len(
            res_a["losses"]) != PROGRAM_QA_STEPS:
        raise AssertionError(f"TVQA run A: {res_a['global_step']} steps")
    rec["tvqa_losses"] = res_a["losses"]
    per_step = qopts.train_batch_size * qopts.gradient_accumulation_steps
    rec["tvqa_window_ms"], rec["tvqa_questions_per_s"] = rate(
        res_a["marks"], PROGRAM_QA_WINDOWS, per_step)
    n_val = sizes[0][1]
    rec["tvqa_validation"] = [validation(out_a, s, n_val)["log"] for s in
                              sorted({PROGRAM_QA_VALID_STEPS,
                                      PROGRAM_QA_STEPS})]
    rec["model_vocab_padded"] = vocab_padded(out_a, PROGRAM_QA_STEPS)
    records_a = _records(out_a)
    stage("tvqa_run_a")

    # TVQA run B: SIGTERM after step 2, then the command line resumes it
    t_b = time.perf_counter()
    res_b = train_run(cfg_b, "b", PROGRAM_QA_SIGTERM_AT, ())
    if res_b["global_step"] != PROGRAM_QA_SIGTERM_AT:
        raise AssertionError(f"SIGTERM after step {PROGRAM_QA_SIGTERM_AT}: "
                             f"main returned at {res_b['global_step']}")
    records_b1 = _records(out_b)
    if rehearse:
        run([sys.executable, "-c", PROGRAM_TRAIN_RUN, "train_videoqa", cfg_b,
             os.path.join(root, "b2.out.json"), dev, "0", "[]"], "resume")
    else:
        run([sys.executable, "-m", "hero_tpu_torch.drivers.train_videoqa",
             "--config", cfg_b],
            "python -m hero_tpu_torch.drivers.train_videoqa")
    rec["run_b_s"] = time.perf_counter() - t_b
    records_b2 = _records(out_b)
    rec["restore_ms"] = records_b2["restore_ms"]
    rec["saves"] = (_program_saves("run_a", records_a)
                    + _program_saves("run_b_interrupted", records_b1)
                    + _program_saves("run_b_resumed", records_b2))
    stage("tvqa_run_b")
    for name in (f"ckpt/model_step_{PROGRAM_QA_STEPS}.npz", "restore.npz"):
        a = _npz(os.path.join(out_a, name))
        b = _npz(os.path.join(out_b, name))
        differ = sorted(k for k in a if k not in b or a[k].dtype
                        != b[k].dtype or not np.array_equal(a[k], b[k]))
        if differ or set(a) != set(b):
            raise AssertionError(f"resumed {name} differs from the "
                                 f"uninterrupted one at {differ[:5]}")
    rec["resume_bit_equal"] = True
    rec["resume_validation_equal"] = (
        validation(out_b, PROGRAM_QA_STEPS, n_val)
        == validation(out_a, PROGRAM_QA_STEPS, n_val))
    if not rec["resume_validation_equal"]:
        raise AssertionError("the resumed run's last validation differs")
    shutil.rmtree(out_b)
    for n in ("restore.npz", "restore_backup.npz"):
        if os.path.exists(os.path.join(out_a, n)):
            os.remove(os.path.join(out_a, n))      # disk for VIOLIN
    stage("tvqa_compare")

    # eval_videoqa in a subprocess on A's directory: A's last validation
    cmd = ([sys.executable, "-c", PROGRAM_EVAL_CPU, "eval_videoqa"]
           if rehearse
           else [sys.executable, "-m", "hero_tpu_torch.drivers.eval_videoqa"])
    t_e = time.perf_counter()
    proc = run(cmd + ["--output_dir", out_a, "--checkpoint",
                      str(PROGRAM_QA_STEPS)], "eval_videoqa")
    rec["eval_videoqa_wall_s"] = time.perf_counter() - t_e
    with open(os.path.join(out_a, f"qa_results_{PROGRAM_QA_STEPS}"
                                  "_all.json")) as f:
        answers = json.load(f)
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    val = validation(out_a, PROGRAM_QA_STEPS, n_val)
    if answers != val["results"] or printed != val["log"]:
        raise AssertionError(f"eval_videoqa {printed} differs from A's "
                             f"step-{PROGRAM_QA_STEPS} validation "
                             f"{val['log']}")
    rec["eval_videoqa_equal"] = True
    rec["eval_videoqa_log"] = printed
    shutil.rmtree(out_a)
    stage("eval_videoqa")

    # VIOLIN: train_violin.main, then eval_violin.main, in this process
    edges = {s for w in PROGRAM_VIOLIN_WINDOWS for s in w}
    losses, marks = [], {}

    def on_step(step, task, metrics):
        losses.append(metrics["loss"].detach())
        if step in edges:
            sync()
            marks[step] = time.perf_counter()

    reset_counts()
    t_v = time.perf_counter()
    state = train_violin.main(vopts, device=dev, on_step=on_step,
                              dtype=torch.float32 if rehearse
                              else torch.bfloat16)
    sync()
    rec["violin_run_s"] = time.perf_counter() - t_v
    violin_launches = read_counts()
    losses = [float(x) for x in losses]
    if state.global_step != PROGRAM_VIOLIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"train_violin: {state.global_step} steps, "
                             f"losses {losses}")
    del state
    rec["violin_losses"] = losses
    per_step = vopts.train_batch_size * vopts.gradient_accumulation_steps
    rec["violin_window_ms"], rec["violin_pairs_per_s"] = rate(
        marks, PROGRAM_VIOLIN_WINDOWS, per_step)
    out_vl = os.path.join(root, "violin")
    rec["violin_saves"] = _program_saves("violin", _records(out_vl))
    rec["violin_model_vocab_padded"] = vocab_padded(out_vl,
                                                    PROGRAM_VIOLIN_STEPS)
    stage("train_violin")
    reset_counts()
    sync()
    t_i = time.perf_counter()
    log_vl, results = eval_violin.main(
        eval_violin.build_argparser().parse_args(
            ["--output_dir", out_vl, "--checkpoint",
             str(PROGRAM_VIOLIN_STEPS)]),
        device=dev, dtype=torch.float32 if rehearse else torch.bfloat16)
    sync()
    rec["eval_violin_s"] = time.perf_counter() - t_i
    eval_launches = read_counts()
    val = validation(out_vl, PROGRAM_VIOLIN_STEPS, 2 * sizes[1][1])
    if ({str(k): v for k, v in results.items()} != val["results"]
            or log_vl != val["log"]):
        raise AssertionError(f"eval_violin {log_vl} differs from its "
                             f"step-{PROGRAM_VIOLIN_STEPS} validation "
                             f"{val['log']}")
    rec["eval_violin_equal"] = True
    rec["eval_violin_log"] = log_vl
    shutil.rmtree(out_vl)
    stage("eval_violin")
    return rec, {"qa_program": res_a["launches"],
                 "violin_program": violin_launches,
                 "violin_eval": eval_launches}


# ---------------------------------------------------------------------------
# dp: data-parallel training and multi-process serving (parallel/dist)
# ---------------------------------------------------------------------------

DP_WORLD = 2                        # ranks that share the one card (gloo)
DP_SPEC = dict(learning_rate=1e-4, warmup_steps=1, num_train_steps=1000,
               grad_norm=2.0)
DP_DROPOUT_STEPS = 2
DP_TIMED_STEPS = 1                  # timed steps after one warm-up
DP_SEED = 100
DP_SIGTERM_RANK = 1                 # the one rank run B's SIGTERM goes to
DP_TIMEOUT_S = 900                  # a world's time limit
DP_FREE_BYTES = 12 << 30            # run A's, B's and C's files, with room
# the grids of the modes beyond data parallelism (parallel/dist.init_grid):
# ZeRO-1 over the 2 data ranks, and 2 pipeline stages (2 micro-batches),
# 2 model (tensor-parallel) and 2 seq (sequence-parallel) ranks of one
# data rank
DP_MODES = {"zero1": ("data", 1), "pp": ("stage", 2), "tp": ("model", 2),
            "sp": ("seq", 2)}
DP_PP_MICRO = 2

# one rank of a dp world (dp_rank); the rank, the world, the store and the
# backend come from the environment the phase sets
DP_RANK_RUN = """
import sys
from chip_smoke import dp_rank
dp_rank(*sys.argv[1:])
"""


def rehearsal_config(f_layers=1):
    """The rehearsal's tiny model (hidden 64, one layer each; the
    f-encoder ``f_layers``)."""
    from hero_tpu_torch.config.model_config import (HeroConfig,
                                                    TransformerConfig)
    base = TransformerConfig(hidden_size=64, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=128)
    return HeroConfig(f_config=base.replace(num_hidden_layers=f_layers),
                      c_config=base,
                      q_config=base.replace(num_hidden_layers=0,
                                            type_vocab_size=1),
                      vfeat_dim=64)


def dp_rank(role, out_json, rehearse, *args):
    """One rank of the dp phase (:data:`DP_RANK_RUN`), its record to
    ``out_json``.  ``role`` "steps" (gloo, the ranks sharing the card;
    ``args`` the configs of runs A and B and A's directory): the
    data-parallel VSM step against this process's one-process step
    (:func:`dp_parity`), three dropout steps (:func:`dp_dropout`), the
    step and all-reduce times (:func:`dp_times`), the modes beyond data
    parallelism (:func:`dp_modes`), then ``train_vcmr`` run A,
    ``eval_vcmr`` on its directory, run B (``--zero1``), stopped by
    SIGTERM to rank :data:`DP_SIGTERM_RANK` alone after step 2 and then
    resumed, and run C (``--pp_stages 2``), with each stage's seconds
    (``stage_s``); "nccl" (one rank a card; ``args`` the gradients'
    element count): the all-reduce's time alone."""
    import torch
    from hero_tpu_torch.config.model_config import flagship_config
    from hero_tpu_torch.parallel import dist
    rehearse = rehearse == "1"
    dev = dist.init_distributed("cpu" if rehearse else "cuda")
    rec = {"rank": dist.rank(), "world": dist.world_size(),
           "backend": dist.backend(), "device": str(dev)}
    if role == "nccl":
        rec["times"] = timed_all_reduce(
            torch, [torch.ones(int(args[0]), device=dev)], dev)
    else:
        cfg_a, cfg_b, cfg_c, out_a = args
        stage_s, t_stage = {}, time.perf_counter()
        rec["stage_s"] = stage_s

        def stage(name):
            nonlocal t_stage
            now = time.perf_counter()
            stage_s[name] = now - t_stage
            t_stage = now

        cfg = rehearsal_config(2) if rehearse else flagship_config()
        setup = dp_setup(cfg, dev, rehearse)
        stage("setup")
        rec["parity"] = dp_parity(torch, cfg, *setup, dev)
        stage("parity")
        rec["dropout"] = dp_dropout(torch, cfg, *setup, dev)
        stage("dropout")
        rec["times"] = dp_times(torch, cfg, *setup, dev)
        stage("times")
        rec["modes"] = dp_modes(torch, cfg, *setup, dev)
        stage("modes")
        del setup
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec["run_a"] = train_program("train_vcmr", cfg_a, dev.type, 0,
                                     PROGRAM_VCMR_WINDOWS)
        stage("run_a")
        rec["eval"] = dp_eval(torch, out_a, "val", dev)
        stage("eval")
        t0 = time.perf_counter()
        rec["run_b_stopped"] = train_program(
            "train_vcmr", cfg_b, dev.type,
            PROGRAM_VCMR_SIGTERM_AT if dist.rank() == DP_SIGTERM_RANK else 0,
            ())
        rec["run_b_resumed"] = train_program("train_vcmr", cfg_b, dev.type,
                                             0, ())
        rec["run_b_s"] = time.perf_counter() - t0
        stage("run_b")
        t0 = time.perf_counter()
        rec["run_c"] = train_program("train_vcmr", cfg_c, dev.type, 0, ())
        rec["run_c_s"] = time.perf_counter() - t0
        stage("run_c")
    dist.shutdown_distributed()
    with open(out_json, "w") as f:
        json.dump(rec, f)


def dp_setup(cfg, dev, rehearse):
    """(VSM options, the seeded flagship weights on ``dev``, bench.py's
    fit batch of the whole world): the same on every rank.  (The
    2-rank parity holds the fit bucket alone, to keep the smoke under
    1000 s: the ranks' step does not depend on the bucket's shape.)"""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    vsm = VsmConfig(**BENCH_VSM)
    params = load_jax_params(init_flat_params(cfg, vsm, seed=0), device=dev,
                             heads=False)
    b_fit = make_train_buckets(cfg.vfeat_dim, 4 if rehearse else TRAIN_BS,
                               64 if rehearse else TRAIN_SAMPLED)[0]
    return vsm, params, {"fit": b_fit}


def dp_parity(torch, cfg, vsm, params, buckets, dev):
    """The fit bucket's VSM step, dropout off, fp32 then bf16: the ranks'
    step on their rows (the gradients summed over the ranks) against the
    primary's one-process step on the whole batch from the same weights,
    by the primary while the other ranks wait.  fp32 by
    :func:`step_parity`'s rule (loss, every gradient and new parameter,
    grad norm); bf16 by :func:`bf16_step_check`'s, the one-process fp32
    step as the yardstick of the bf16 rounding."""
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.parallel import dist
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              loss_and_grads,
                                              make_train_step)
    spec = TrainSpec(**DP_SPEC)
    paths = optim.tree_paths(params)
    names = ["/".join(p) for p in paths]
    out, fp32 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, b in buckets.items():
            fn = vsm_loss_fn(cfg, vsm, dtype, False)
            mine = batch_to_device(dist.shard_rows(b), dev)
            with dist.data_parallel(dist.data_group()):
                _, _, g = loss_and_grads(fn, params, mine, None)
            gk = [x.float() for x in
                  optim.tree_leaves(dist.all_reduce_grads(g))]
            st, m = make_train_step(fn, spec)(TrainState.create(params),
                                              mine, None)
            lk, nk, pk = (float(m["loss"]), float(m["grad_norm"]),
                          optim.tree_leaves(st.params))
            del g, st, mine
            if dist.is_primary():
                whole = batch_to_device(b, dev)
                _, _, g1 = loss_and_grads(fn, params, whole, None)
                gp = [x.float() for x in optim.tree_leaves(g1)]
                st1, m1 = make_train_step(fn, spec, group=dist.ALONE)(
                    TrainState.create(params), whole, None)
                lp, np_ = float(m1["loss"]), float(m1["grad_norm"])
                pp = optim.tree_leaves(st1.params)
                rec = {"videos": int(b["sub_mask"].shape[0]),
                       "loss": [lk, lp], "grad_norm": [nk, np_]}
                if tag == "fp32":
                    wg, wp = parity_worst(paths, gk, gp, pk, pp, spec, None,
                                          f"dp {tag} {name}")
                    rec.update(loss_rel_err=abs(lk - lp) / abs(lp),
                               worst_grad_err_over_tol=wg,
                               worst_param_err_over_tol=wp)
                    rec["ok"] = (rec["loss_rel_err"] <= 1e-5
                                 and wg[0] <= 1.0 and wp[0] <= 1.0
                                 and abs(nk - np_) <= 1e-4 * abs(np_))
                    fp32[name] = (lp, gp)
                else:
                    lr, gr = fp32.pop(name)
                    worst = bf16_worst(names, gk, gp, gr)
                    rec.update(loss=[lk, lp, lr],
                               loss_ranks_vs_one=abs(lk - lp),
                               loss_tol=4 * abs(lp - lr)
                               + 2.0 ** -9 * abs(lr),
                               worst_grad_err_over_tol=worst)
                    rec["ok"] = (rec["loss_ranks_vs_one"] <= rec["loss_tol"]
                                 and worst[0] <= 1.0
                                 and all(math.isfinite(x)
                                         for x in rec["loss"]))
                out[f"{tag}_{name}"] = rec
                del whole, g1, gp, st1, pp
            del gk, pk
            dist.barrier()
    return out


def dp_dropout(torch, cfg, vsm, params, buckets, dev):
    """Three bf16 steps of the fit bucket with dropout 0.1 (and the span
    skip at 0.8) on the ranks' rows: every loss finite, the replicas'
    parameters identical bit for bit (``dist.check_replicas``), and the
    first dropout mask of the first step (its crc) differs between the
    ranks."""
    import zlib
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.models import nn
    from hero_tpu_torch.parallel import dist
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    fn = vsm_loss_fn(cfg, dataclasses.replace(vsm, drop_svmr_prob=0.8),
                     torch.bfloat16, True)
    step = make_train_step(fn, TrainSpec(**DP_SPEC))
    mine = batch_to_device(dist.shard_rows(buckets["fit"]), dev)
    first, orig = [], nn.dropout

    def spy(x, rate, seed):
        y = orig(x, rate, seed)
        if not first and rate > 0 and seed is not None:
            first.append(zlib.crc32((y == 0).to(torch.uint8).cpu().numpy()
                                    .tobytes()))
        return y

    nn.dropout = spy
    try:
        state, losses = TrainState.create(params), []
        for i in range(DP_DROPOUT_STEPS):
            state, m = step(state, mine, DP_SEED + i)
            losses.append(float(m["loss"]))
    finally:
        nn.dropout = orig
    dist.check_replicas(state.params)
    crcs = dist.host_allgather(first[0])
    return {"losses": losses,
            "finite": all(math.isfinite(x) for x in losses),
            "replicas_equal": True, "first_mask_crc": crcs,
            "masks_differ": len(set(crcs)) == len(crcs)}


def dp_times(torch, cfg, vsm, params, buckets, dev):
    """The bf16 VSM train step of the fit bucket with dropout: ms a step
    (median of :data:`DP_TIMED_STEPS` after a warm-up, every rank
    synchronised and the card idle at each start) on the ranks' rows,
    with each rank's launches and all-reduce bytes a step; the primary's
    one-process step on the whole batch while the others wait; and one
    all-reduce of the gradients' size (``dist.timed_all_reduce``)."""
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.parallel import dist
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              make_train_step)
    fn = vsm_loss_fn(cfg, vsm, torch.bfloat16, True)
    spec = TrainSpec(**DP_SPEC)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(step, batch, together):
        state, ms = TrainState.create(params), []
        for i in range(DP_TIMED_STEPS + 1):
            if together:
                dist.barrier()
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch, DP_SEED + i)
            float(m["loss"])
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        return state, float(np.median(ms[1:])), ms

    n_steps = DP_TIMED_STEPS + 1
    mine = batch_to_device(dist.shard_rows(buckets["fit"]), dev)
    reset_counts()
    bytes0 = dist.STATS["all_reduce_bytes"]
    state, ranks_ms, runs = timed(make_train_step(fn, spec), mine, True)
    rec = {"videos": int(buckets["fit"]["sub_mask"].shape[0]),
           "step_ms": ranks_ms, "step_ms_runs": runs,
           "launches": read_counts(), "steps_counted": n_steps,
           "all_reduce_bytes_per_step":
               (dist.STATS["all_reduce_bytes"] - bytes0) / n_steps}
    del mine
    rec.update(timed_all_reduce(torch, optim.tree_leaves(state.params),
                                dev))
    del state
    if dist.is_primary():
        whole = batch_to_device(buckets["fit"], dev)
        _, rec["one_process_step_ms"], rec["one_process_runs"] = timed(
            make_train_step(fn, spec, group=dist.ALONE), whole, False)
        del whole
    dist.barrier()
    return rec


def _mode_grid(mode):
    """Set the grid, the pipeline and sequence parallelism of ``mode`` (a
    key of :data:`DP_MODES`; None: the plain world)."""
    from hero_tpu_torch.parallel import dist, pipeline
    axis, inner = DP_MODES[mode] if mode else ("data", 1)
    dist.init_grid(axis, inner)
    pipeline.enable_pipeline(axis == "stage", DP_PP_MICRO)
    dist.enable_seq_parallel(axis == "seq")


def dp_modes(torch, cfg, vsm, params, buckets, dev):
    """The modes beyond data parallelism (:data:`DP_MODES`) at the fit
    bucket, from the same flagship weights, on the ranks' grid of each:

    - parity, dropout off: one fp32 and one bf16 step of each mode (the
      gradients summed over the data ranks and gathered whole, the new
      parameters gathered) against the primary's one-process step on the
      whole batch, fp32 by :func:`step_parity`'s rule, bf16 by
      :func:`bf16_step_check`'s (the one-process fp32 step the yardstick
      of the bf16 rounding);
    - times, bf16 with dropout: ms a step (median of
      :data:`DP_TIMED_STEPS` after a warm-up, the ranks synchronised and
      the card idle at each start), the bytes of every collective and
      stage transfer a step (``dist.STATS``), the rank's peak memory
      (``torch.cuda.max_memory_allocated``) and its launches;
    - ZeRO-1 against the 2-rank replicated step over the same timed
      steps: the parameters equal bit for bit after every step, and the
      replicated step's ms and peak memory beside ZeRO-1's."""
    from hero_tpu_torch.evaluation.vcmr_eval import batch_to_device
    from hero_tpu_torch.parallel import dist
    from hero_tpu_torch.training import optim
    from hero_tpu_torch.training.step import (TrainSpec, TrainState,
                                              gather_params, gather_state,
                                              loss_and_grads,
                                              make_train_step, shard_state)
    spec = TrainSpec(**DP_SPEC)
    b = buckets["fit"]
    paths = optim.tree_paths(params)
    names = ["/".join(p) for p in paths]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    ref = {}
    _mode_grid(None)
    if dist.is_primary():
        whole = batch_to_device(b, dev)
        for dtype in (torch.float32, torch.bfloat16):
            fn = vsm_loss_fn(cfg, vsm, dtype, False)
            _, _, g1 = loss_and_grads(fn, params, whole, None)
            st1, m1 = make_train_step(fn, spec, group=dist.ALONE)(
                TrainState.create(params), whole, None)
            # on the host: out of the peak memory the modes report
            ref[dtype] = (float(m1["loss"]), float(m1["grad_norm"]),
                          [x.float().cpu() for x in optim.tree_leaves(g1)],
                          [x.cpu() for x in optim.tree_leaves(st1.params)])
            del g1, st1
        del whole
    dist.barrier()
    out = {}
    for mode in DP_MODES:
        _mode_grid(mode)
        zero1 = mode == "zero1"
        mine = batch_to_device(dist.shard_rows(b), dev)
        rec = {"grid": [dist.data_world(), dist.inner_world()],
               "rows": int(mine["sub_mask"].shape[0])}
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            fn = vsm_loss_fn(cfg, vsm, dtype, False)
            state = shard_state(TrainState.create(params), zero1)
            with dist.data_parallel(dist.data_group()):
                _, _, g = loss_and_grads(fn, state.params, mine, None)
            if dist.data_group() is not None:
                g = dist.all_reduce_grads(g, dist.data_group())
            gk = [x.float() for x in optim.tree_leaves(gather_params(g))]
            st, m = make_train_step(fn, spec, zero1=zero1)(state, mine,
                                                            None)
            lk, nk = float(m["loss"]), float(m["grad_norm"])
            pk = optim.tree_leaves(gather_state(st, zero1).params)
            del g, st, state
            if dist.is_primary():
                lp, np_, gp, pp = ref[dtype]
                gp, pp = ([x.to(dev) for x in t] for t in (gp, pp))
                r = {"loss": [lk, lp], "grad_norm": [nk, np_]}
                if tag == "fp32":
                    wg, wp = parity_worst(paths, gk, gp, pk, pp, spec, None,
                                          f"dp {mode} {tag}")
                    r.update(loss_rel_err=abs(lk - lp) / abs(lp),
                             worst_grad_err_over_tol=wg,
                             worst_param_err_over_tol=wp)
                    r["ok"] = (r["loss_rel_err"] <= 1e-5 and wg[0] <= 1.0
                               and wp[0] <= 1.0
                               and abs(nk - np_) <= 1e-4 * abs(np_))
                else:
                    lr, _, gr, _ = ref[torch.float32]
                    worst = bf16_worst(names, gk, gp,
                                       [x.to(dev) for x in gr])
                    r.update(loss=[lk, lp, lr], loss_mode_vs_one=abs(lk - lp),
                             loss_tol=4 * abs(lp - lr) + 2.0 ** -9 * abs(lr),
                             worst_grad_err_over_tol=worst)
                    r["ok"] = (r["loss_mode_vs_one"] <= r["loss_tol"]
                               and worst[0] <= 1.0
                               and all(math.isfinite(x) for x in r["loss"]))
                rec[tag] = r
                del gp, pp
            del gk, pk
            dist.barrier()
        fn = vsm_loss_fn(cfg, vsm, torch.bfloat16, True)
        runs = {"mode": make_train_step(fn, spec, zero1=zero1)}
        if zero1:
            runs["replicated"] = make_train_step(fn, spec)
        ms = {k: [] for k in runs}
        # ZeRO-1's parameters after each step, on the host (out of the
        # peak memory the runs report)
        kept, equal = [], []
        for k in runs:
            # one run's state at a time: the peak is its own
            state = shard_state(TrainState.create(params),
                                zero1 and k == "mode")
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            bytes0 = dist.STATS["collective_bytes"]
            if k == "mode":
                reset_counts()
            for i in range(DP_TIMED_STEPS + 1):
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                state, m = runs[k](state, mine, DP_SEED + i)
                float(m["loss"])
                sync()
                ms[k].append(1e3 * (time.perf_counter() - t0))
                leaves = [t.cpu() for t in optim.tree_leaves(
                    state.params)] if zero1 else []
                if k == "replicated":
                    # the replicated run goes second, against ZeRO-1's
                    # step i
                    equal.append(all(torch.equal(a, c)
                                     for a, c in zip(leaves, kept[i])))
                else:
                    kept.append(leaves)
            steps = DP_TIMED_STEPS + 1
            rec[k] = {"step_ms": float(np.median(ms[k][1:])),
                      "step_ms_runs": ms[k],
                      "collective_bytes_per_step":
                          (dist.STATS["collective_bytes"] - bytes0) / steps,
                      "max_memory_allocated": (
                          torch.cuda.max_memory_allocated(dev) if cuda
                          else None)}
            if k == "mode":
                rec["launches"] = read_counts()
                rec["steps_counted"] = steps
            del state
        if zero1:
            rec["bit_equal_by_step"] = equal
        out[mode] = rec
        del kept, mine
        if cuda:
            torch.cuda.empty_cache()
    _mode_grid(None)
    return out


def timed_all_reduce(torch, leaves, dev, repeats=5):
    """ms (median of ``repeats`` after a warm-up) and bytes of
    ``dist.all_reduce_flat`` over ``leaves`` (the gradients' sizes), every
    rank synchronised and the card idle at each start."""
    from hero_tpu_torch.parallel import dist
    leaves = [t.detach() for t in leaves]
    ms = []
    for _ in range(repeats + 1):
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce_flat(leaves)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"all_reduce_ms": float(np.median(ms[1:])),
            "all_reduce_bytes": 4 * sum(t.numel() for t in leaves)}


def dp_eval(torch, out_dir, split, dev):
    """``drivers/eval_vcmr.main`` on the run at ``out_dir``, checkpoint
    ``PROGRAM_VCMR_STEPS``, on this process's world (bf16 on the card,
    fp32 on the CPU), the counters from 0 around it: its metrics, wall s
    and launches."""
    from hero_tpu_torch.drivers import eval_vcmr
    args = eval_vcmr.build_argparser().parse_args(
        ["--output_dir", out_dir, "--checkpoint", str(PROGRAM_VCMR_STEPS),
         "--split", split])
    reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    metrics, _ = eval_vcmr.main(args, device=dev, dtype=(
        torch.bfloat16 if dev.type == "cuda" else torch.float32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"wall_s": time.perf_counter() - t0, "metrics": metrics,
            "launches": read_counts()}


def launch_world(here, root, name, world, backend, argvs, rehearse):
    """``world`` ranks, rank r running ``argvs[r]`` from ``here`` with
    RANK, WORLD_SIZE, LOCAL_RANK (0 for ranks that share the card), a
    ``file://`` store under ``root`` and the backend in the environment;
    every rank's output to ``root/name_r.log``.  Raises with the logs
    when a rank fails or the world outlasts :data:`DP_TIMEOUT_S`."""
    from hero_tpu_torch.parallel import dist
    procs = []
    for r in range(world):
        env = dict(os.environ, HF_HUB_OFFLINE="1", RANK=str(r),
                   WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r if backend == "nccl" else 0))
        env[dist.INIT_METHOD_ENV] = "file://" + os.path.join(
            root, f"store_{name}")
        env[dist.BACKEND_ENV] = backend
        if rehearse:
            env["OMP_NUM_THREADS"] = "1"
        log_f = open(os.path.join(root, f"{name}_{r}.log"), "w")
        procs.append((subprocess.Popen(argvs[r], cwd=here, env=env,
                                       stdout=log_f,
                                       stderr=subprocess.STDOUT), log_f))
    deadline, codes = time.time() + DP_TIMEOUT_S, []
    for p, log_f in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
        log_f.close()
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if codes != [0] * world:
        logs = "\n".join(f"--- rank {r}: {c} ---\n" + open(os.path.join(
            root, f"{name}_{r}.log")).read()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f"dp world {name} ({backend}): {codes}\n{logs}")


def by_query(sub, tasks):
    """A submission with each task's rows in query order."""
    return {"video2idx": sub["video2idx"],
            **{t: sorted(sub[t], key=lambda e: e["desc_id"]) for t in tasks}}


def dp_phase(torch, here, cfg, main_root, db, dev, sync, rehearse):
    """Data-parallel training and multi-process serving
    (``parallel/dist``; see the module docstring) on ranks that share the
    card over gloo, and one rank a card over nccl; ``train_vcmr`` from
    vcmr_program's ``.pt`` over pretrain_main's videos.  Returns (record,
    {path: launch counts})."""
    from hero_tpu_torch.config.opts import get_vcmr_args
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    # qa_program's files go; the .pt and pretrain_main's stores stay
    shutil.rmtree(os.path.join(main_root, "qa"), ignore_errors=True)
    root = os.path.join(main_root, "dp")
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if not rehearse and free < DP_FREE_BYTES:
        raise AssertionError(f"{free} bytes free under {root}; the phase "
                             f"needs {DP_FREE_BYTES}")
    rec = {"stage_s": stage_s, "free_bytes_before": free,
           "card": None if rehearse else gpu_identity(),
           "note": "the gloo ranks share one card: their times are no "
                   "scaling claim"}
    vocab = cfg.f_config.vocab_size
    nq_t, nq_v = (48, 16) if rehearse else PROGRAM_VCMR_QUERIES
    tvr_train, tvr_val = write_program_queries(db, list(db.vids), vocab - 8,
                                               root, "tvr", nq_t, nq_v, 71)
    over = dict(sub_txt_db=os.path.join(main_root, "sub_db"),
                vfeat_db=os.path.join(main_root, "video_db"),
                train_query_txt_db=tvr_train, val_query_txt_db=tvr_val,
                model_config=os.path.join(main_root, "model.json"),
                checkpoint=os.path.join(main_root, "vcmr",
                                        "hero-tv-ht100.pt"),
                vfeat_dim=cfg.vfeat_dim, num_train_steps=PROGRAM_VCMR_STEPS,
                valid_steps=PROGRAM_VCMR_VALID_STEPS,
                save_steps=PROGRAM_VCMR_SAVE_STEPS,
                warmup_steps=PROGRAM_VCMR_WARMUP,
                hard_negtiave_start_step=[PROGRAM_VCMR_HARD_AT],
                distributed_eval=True)
    cfg_a, cfg_b, cfg_c = (
        vcmr_run_config(here, root, n, "train-tvr.json", dict(over, **mode),
                        rehearse)
        for n, mode in (("a", {}), ("b", {"zero1": True}),
                        ("c", {"pp_stages": 2,
                               "pp_microbatches": DP_PP_MICRO})))
    opts_a = get_vcmr_args(["--config", cfg_a])
    out_a, out_b, out_c = (os.path.join(root, n) for n in ("a", "b", "c"))
    flag = "1" if rehearse else "0"
    if dev == "cuda":
        torch.cuda.empty_cache()
    stage("write_stores")

    # the step world: parity, dropout, times, the modes, then train_vcmr
    # run A, eval_vcmr on its directory and runs B and C
    t = time.perf_counter()
    launch_world(here, root, "steps", DP_WORLD, "gloo", [
        [sys.executable, "-c", DP_RANK_RUN, "steps",
         os.path.join(root, f"steps_{r}.json"), flag, cfg_a, cfg_b, cfg_c,
         out_a]
        for r in range(DP_WORLD)], rehearse)
    rec["steps_world_s"] = time.perf_counter() - t
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(root, f"steps_{r}.json")) as f:
            ranks.append(json.load(f))
    stage("steps_world")
    parity = ranks[0]["parity"]
    if not parity or not all(v["ok"] for v in parity.values()):
        raise AssertionError(f"dp step against one process: {parity}")
    drop = [r["dropout"] for r in ranks]
    if not (all(d["finite"] and d["replicas_equal"] for d in drop)
            and drop[0]["masks_differ"]):
        raise AssertionError(f"dp dropout steps: {drop}")
    modes = ranks[0]["modes"]
    bad = {m: {t: r[t] for t in ("fp32", "bf16")}
           for m, r in modes.items() if not (r["fp32"]["ok"]
                                             and r["bf16"]["ok"])}
    if bad:
        raise AssertionError(f"dp modes against one process: {bad}")
    z_equal = [r["modes"]["zero1"]["bit_equal_by_step"] for r in ranks]
    if not all(all(e) and len(e) == DP_TIMED_STEPS + 1 for e in z_equal):
        raise AssertionError(f"ZeRO-1 steps against the replicated steps: "
                             f"{z_equal}")
    for r in ranks:
        run = r["run_a"]
        if run["global_step"] != PROGRAM_VCMR_STEPS or not all(
                math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"dp train_vcmr run A: {run}")
    with open(os.path.join(out_a, "log", "log.txt")) as f:
        done = sum("training done at step" in ln for ln in f)
    if done != 1:
        raise AssertionError(f"run A's log.txt has {done} end lines: one "
                             "writer (the primary) was expected")
    rec.update(parity=parity, dropout=drop,
               modes={m: {k: [r["modes"][m][k] for r in ranks]
                          if k in ("mode", "replicated", "rows") else v
                          for k, v in modes[m].items() if k != "launches"}
                      for m in modes},
               gloo={k: ranks[0]["times"][k] for k in (
                   "videos", "step_ms", "step_ms_runs",
                   "one_process_step_ms", "one_process_runs",
                   "all_reduce_ms", "all_reduce_bytes",
                   "all_reduce_bytes_per_step")}
               | {"world": DP_WORLD,
                  "step_ms_by_rank": [r["times"]["step_ms"] for r in ranks]},
               rank_stage_s=[r["stage_s"] for r in ranks],
               tvr_losses=ranks[0]["run_a"]["losses"],
               tvr=dict(train_batch_size=opts_a.train_batch_size,
                        gradient_accumulation_steps=(
                            opts_a.gradient_accumulation_steps)))

    # eval_vcmr in this process on A's directory against the two ranks'
    tasks = ("VCMR", "SVMR", "VR")
    one = dp_eval(torch, out_a, "one", torch.device(dev))
    with open(os.path.join(out_a, f"results_{PROGRAM_VCMR_STEPS}_one_all"
                                  ".json")) as f:
        sub_one = by_query(json.load(f), tasks)
    with open(os.path.join(out_a, f"results_{PROGRAM_VCMR_STEPS}_val_all"
                                  ".json")) as f:
        sub_ranks = by_query(json.load(f), tasks)
    two = [r["eval"] for r in ranks]
    if two[0]["metrics"] != two[1]["metrics"]:
        raise AssertionError("the ranks' merged metrics differ")
    diffs = {f"{t}/{k}": abs(two[0]["metrics"][t][k] - v)
             for t in tasks for k, v in one["metrics"][t].items()}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    if worst[1] > 0.05:
        raise AssertionError(f"2-rank eval_vcmr metrics off the 1-process "
                             f"ones by {worst}")
    rec["eval"] = {"wall_s_1": one["wall_s"],
                   "wall_s_by_rank": [e["wall_s"] for e in two],
                   "max_metric_diff": worst,
                   "max_rel_score_diff": same_ranking(sub_ranks, sub_one,
                                                      tasks, 1e-4),
                   "submission_bit_equal": sub_ranks == sub_one,
                   "queries": len(sub_one["VR"])}
    stage("eval")

    # run B: SIGTERM to one rank after step 2 stopped both; resumed, its
    # files equal A's bit for bit
    stopped = [r["run_b_stopped"]["global_step"] for r in ranks]
    if stopped != [PROGRAM_VCMR_SIGTERM_AT] * DP_WORLD:
        raise AssertionError(f"SIGTERM to rank {DP_SIGTERM_RANK} after step "
                             f"{PROGRAM_VCMR_SIGTERM_AT}: the ranks stopped "
                             f"at {stopped}")
    resumed = [r["run_b_resumed"]["global_step"] for r in ranks]
    if resumed != [PROGRAM_VCMR_STEPS] * DP_WORLD:
        raise AssertionError(f"run B resumed to {resumed}")
    rec["run_b_s"] = ranks[0]["run_b_s"]
    for name in (f"ckpt/model_step_{PROGRAM_VCMR_STEPS}.npz",
                 "restore.npz"):
        a = _npz(os.path.join(out_a, name))
        b = _npz(os.path.join(out_b, name))
        differ = sorted(k for k in a if k not in b or a[k].dtype
                        != b[k].dtype or not np.array_equal(a[k], b[k]))
        if differ or set(a) != set(b):
            raise AssertionError(f"dp: resumed {name} differs from the "
                                 f"uninterrupted one at {differ[:5]}")
    rec["stopped_at"] = stopped
    rec["resume_bit_equal"] = True
    shutil.rmtree(out_b)
    stage("run_b")

    # run C: the f-encoder pipelined over the 2 ranks, its validation too;
    # every loss finite, the files every key and shape of run A's
    steps_c = [r["run_c"]["global_step"] for r in ranks]
    losses_c = ranks[0]["run_c"]["losses"]
    if steps_c != [PROGRAM_VCMR_STEPS] * DP_WORLD or not all(
            math.isfinite(x) for x in losses_c):
        raise AssertionError(f"dp train_vcmr run C (--pp_stages 2): "
                             f"{steps_c}, losses {losses_c}")
    for name in (f"ckpt/model_step_{PROGRAM_VCMR_STEPS}.npz",
                 "restore.npz"):
        a = _npz(os.path.join(out_a, name))
        c = _npz(os.path.join(out_c, name))
        if {k: v.shape for k, v in a.items()} != {
                k: v.shape for k, v in c.items()} or not all(
                np.isfinite(v).all() for v in c.values()
                if v.dtype.kind == "f"):
            raise AssertionError(f"dp run C's {name}: not run A's keys and "
                                 "shapes, or not finite")
    if not os.path.exists(os.path.join(
            out_c, f"results_{PROGRAM_VCMR_STEPS}_all.json")):
        raise AssertionError("dp run C wrote no step-4 validation")
    rec["run_c"] = {"losses": losses_c, "run_c_s": ranks[0]["run_c_s"],
                    "files_like_run_a": True}
    shutil.rmtree(out_c)
    stage("run_c")

    # one rank a card over nccl: the all-reduce of the gradients' size
    paths = {}
    if not rehearse:
        n_cards = torch.cuda.device_count()
        launch_world(here, root, "nccl", n_cards, "nccl", [
            [sys.executable, "-c", DP_RANK_RUN, "nccl",
             os.path.join(root, f"nccl_{r}.json"), flag,
             str(rec["gloo"]["all_reduce_bytes"] // 4)]
            for r in range(n_cards)], rehearse)
        with open(os.path.join(root, "nccl_0.json")) as f:
            nccl = json.load(f)
        rec["nccl"] = {**nccl["times"], "world": nccl["world"],
                       "backend": nccl["backend"]}
        stage("nccl_world")
    for r, res in enumerate(ranks):
        paths[f"dp_step_rank{r}"] = res["times"]["launches"]
        paths[f"dp_train_vcmr_rank{r}"] = res["run_a"]["launches"]
        paths[f"dp_eval_vcmr_rank{r}"] = res["eval"]["launches"]
        paths[f"dp_train_vcmr_resumed_rank{r}"] = (
            res["run_b_resumed"]["launches"])
        paths[f"dp_train_vcmr_pp_rank{r}"] = res["run_c"]["launches"]
        for m, mrec in res["modes"].items():
            paths[f"dp_step_{m}_rank{r}"] = mrec["launches"]
    rec["launches_by_rank"] = paths
    return rec, paths


# ---------------------------------------------------------------------------
# serving_full: packed queries, the chunked corpus and drivers/eval_vcmr
# ---------------------------------------------------------------------------

PACK_SEGS, PACK_ROWS = 4, 64       # pack_queries' segments a row, rows a call
CHUNK_VIDEOS = 500                 # corpus_chunk_videos of the chunked run
SMALL_CHUNK = 10                   # the same on the small fp32 corpus
PROGRAM_STEP, PROGRAM_SEED = 5, 5  # the program's checkpoint: step, init seed
PROGRAM_QUERIES = 512


def packed_layout(query_batches):
    """(ids, lens, packed row count, share of slots filled) of the query
    set under ``pack_queries`` (``PACK_SEGS`` a row of the batches'
    slots)."""
    from hero_tpu_torch.data.packing import pack_queries
    ids = np.concatenate([b["query_input_ids"] for b in query_batches])
    slots = ids.shape[1]
    lens = np.concatenate([b["query_attn_masks"].sum(1)
                           for b in query_batches]).astype(np.int64)
    _, n_rows = pack_queries([int(x) for x in lens], slots, PACK_SEGS)
    return ids, lens, n_rows, float(lens.sum()) / (n_rows * slots)


def packed_opts(opts):
    """``opts`` with ``pack_queries`` on at ``PACK_SEGS`` / ``PACK_ROWS``."""
    return dataclasses.replace(opts, pack_queries=True,
                               query_pack_segs=PACK_SEGS,
                               query_pack_rows_per_call=PACK_ROWS)


def vr_ids(sub):
    """Each query's VR ranking: the video indices, best first."""
    return [[p[0] for p in e["predictions"]] for e in sub["VR"]]


def ranked_match(ka, sa, kb, sb, rtol):
    """Two rankings (unique keys, their scores, best first) agree up to
    near-ties: a key in both has scores within ``rtol``, and a key in one
    only lies within ``rtol`` of the other's last kept score (it was cut
    at the boundary).  Within ties the order is free."""
    da, db = dict(zip(ka, sa)), dict(zip(kb, sb))
    if not len(da) == len(db) == len(ka) == len(kb):
        return False
    for k in da.keys() & db.keys():
        if abs(da[k] - db[k]) > rtol * abs(db[k]):
            return False
    for d, last in ((da, min(sb)), (db, min(sa))):
        for k in d.keys() - (da.keys() & db.keys()):
            if d[k] - last > rtol * abs(last):
                return False
    return True


def packed_fp32_check(torch, cfg, flat, vsm, opts, batches, query_batches,
                      query_data, dev):
    """fp32 on ``dev``: ``validate_full_vcmr`` with ``pack_queries`` gives
    the unpacked call's top-10 videos, and its VCMR (video, st, ed)
    predictions up to near-ties (``ranked_match``; the exact equality is
    reported), video scores within the fp32 rtol."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
    params = load_jax_params(flat, device=dev, heads=False)
    n_videos = sum(b["c_attn_masks"].shape[0] for b in batches)
    video_ids = [f"s{i}" for i in range(n_videos)]
    v2i = {v: i for i, v in enumerate(video_ids)}
    u, p = (validate_full_vcmr(params, cfg, vsm, o, batches, query_batches,
                               video_ids, v2i, query_data,
                               dtype=torch.float32, device=dev)[1]
            for o in (opts, packed_opts(opts)))
    k = min(10, n_videos)
    rtol = 1e-3      # exp(q2c_alpha * s): 20x the fp32 noise of s

    def ranking(sub, task, q):
        preds = sub[task][q]["predictions"]
        return [tuple(x[:3]) for x in preds], [x[3] for x in preds]

    n_q = len(u["VCMR"])
    pairs = [(ranking(u, "VCMR", q), ranking(p, "VCMR", q))
             for q in range(n_q)]
    rec = {"queries": n_q, "top_k": k,
           "top_idx_equal": [r[:k] for r in vr_ids(u)]
           == [r[:k] for r in vr_ids(p)],
           "flat_idx_equal_queries": sum(a[0] == b[0] for a, b in pairs),
           "flat_idx_equal_up_to_ties": all(
               ranked_match(*a, *b, rtol) for a, b in pairs),
           "score_rtol": rtol}
    for name, task in (("video_score_max_rel_err", "VR"),
                       ("span_score_max_rel_err", "VCMR")):
        err = 0.0
        for q in range(n_q):
            da, db = (dict(zip(*ranking(sub, task, q))) for sub in (u, p))
            for key in da.keys() & db.keys():
                err = max(err, abs(da[key] - db[key])
                          / max(abs(da[key]), 1e-30))
        rec[name] = err
    if not (rec["top_idx_equal"] and rec["flat_idx_equal_up_to_ties"]
            and rec["video_score_max_rel_err"] <= rtol):
        raise AssertionError(f"fp32 packed vs unpacked queries: {rec}")
    return rec


def same_submission(a, b):
    """Two submissions of the same queries: whether every prediction's
    (video, st, ed) is equal, whether every score is too, and the largest
    relative score error."""
    out = {"ids_equal": True, "scores_bit_equal": True,
           "score_max_rel_err": 0.0}
    for task in ("VCMR", "SVMR", "VR"):
        for ea, eb in zip(a[task], b[task], strict=True):
            pa = np.asarray(ea["predictions"], np.float64)
            pb = np.asarray(eb["predictions"], np.float64)
            if ea["desc_id"] != eb["desc_id"] or pa.shape != pb.shape \
                    or not np.array_equal(pa[:, :3], pb[:, :3]):
                out["ids_equal"] = out["scores_bit_equal"] = False
                continue
            out["scores_bit_equal"] &= np.array_equal(pa[:, 3], pb[:, 3])
            out["score_max_rel_err"] = max(out["score_max_rel_err"], float(
                np.max(np.abs(pa[:, 3] - pb[:, 3])
                       / np.maximum(np.abs(pb[:, 3]), 1e-30), initial=0.0)))
    return out


def chunked_fp32_check(torch, cfg, flat, vsm, opts, batches, query_batches,
                       query_data, dev):
    """fp32 on ``dev``, the small corpus in chunks of ``SMALL_CHUNK``
    against the resident corpus: every (video, st, ed) of the submission
    equal, the scores within rtol 1e-4 (cuBLAS picks its kernels by shape,
    so a chunk's products may sum in another order); whether every score
    is bit-equal is reported."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
    params = load_jax_params(flat, device=dev, heads=False)
    n_videos = sum(b["c_attn_masks"].shape[0] for b in batches)
    video_ids = [f"s{i}" for i in range(n_videos)]
    v2i = {v: i for i, v in enumerate(video_ids)}
    subs = []
    for chunk in (0, SMALL_CHUNK):
        _, sub, met = validate_full_vcmr(
            params, cfg, vsm,
            dataclasses.replace(opts, corpus_chunk_videos=chunk), batches,
            query_batches, video_ids, v2i, query_data, dtype=torch.float32,
            device=dev)
        subs.append((sub, met))
    (rsub, rmet), (csub, cmet) = subs
    rtol = 1e-4
    rec = {"videos": n_videos, "chunk": SMALL_CHUNK, "score_rtol": rtol,
           **same_submission(csub, rsub), "metrics_equal": cmet == rmet}
    if not rec["ids_equal"] or rec["score_max_rel_err"] > rtol:
        raise AssertionError(f"fp32 chunked vs resident corpus: {rec}")
    return rec


def write_query_store(query_batch, query_data, subs, root,
                      name="query_db"):
    """One query batch and its ground truth as a herostore query database
    ``root/name`` (``QueryTokStore``'s layout: token ids without the CLS
    the dataset puts first, ``id2len.json``, ``query2video.json``,
    ``meta.json``, ``query_data.jsonl``); returns its directory."""
    from hero_tpu_torch.data.store import HeroStoreWriter
    q_dir = os.path.join(root, name)
    id2len, q2v = {}, {}
    with HeroStoreWriter(q_dir) as w:
        for qi, qid in enumerate(query_batch["qids"]):
            n = int(query_batch["query_attn_masks"][qi].sum()) - 1
            ids = query_batch["query_input_ids"][qi, :n].tolist()
            rec = query_data[qid]
            w.put(str(qid), {"input_ids": ids, "target": rec["ts"]})
            id2len[str(qid)], q2v[str(qid)] = n, rec["vid_name"]
    sidecars = {"id2len.json": id2len, "query2video.json": q2v,
                "meta.json": {"CLS": subs.cls_, "SEP": subs.sep,
                              "PAD": subs.pad, "MASK": subs.mask,
                              "v_range": list(subs.v_range)}}
    for name, obj in sidecars.items():
        with open(os.path.join(q_dir, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(q_dir, "query_data.jsonl"), "w") as f:
        for qid in query_batch["qids"]:
            f.write(json.dumps(query_data[qid]) + "\n")
    return q_dir


def serve_run_dir(here, root, cfg, sub_dir, feat_dir, q_dir, rehearse):
    """A run directory as training leaves it: ``log/hps.json`` (the
    options of ``config/pretrain-tv.json`` minus its paths, the stores
    and the eval options: video batches of 50, query batches of 64,
    packed queries), a model config and ``ckpt/model_step_N.npz`` of the
    whole JAX tree (the numpy init at ``PROGRAM_SEED``); returns the
    directory."""
    from hero_tpu_torch.config.opts import get_vcmr_args
    from hero_tpu_torch.drivers.common import vsm_config_from_opts
    from hero_tpu_torch.models.pretrain import init_flat_params
    from hero_tpu_torch.training.save import save_params
    with open(os.path.join(here, "config", "pretrain-tv.json")) as f:
        raw = json.load(f)
    for k in ("targets", "targets_ratio", "checkpoint"):
        raw.pop(k)
    out = os.path.join(root, "run")
    model_json = os.path.join(root, "model.json")
    with open(model_json, "w") as f:
        json.dump(cfg.to_dict(), f)
    raw.update(sub_txt_db=sub_dir, vfeat_db=feat_dir, val_query_txt_db=q_dir,
               model_config=model_json, output_dir=out,
               vfeat_dim=cfg.vfeat_dim, bucket_query_len=QUERY_SLOTS,
               vcmr_eval_video_batch_size=10 if rehearse else VIDEO_BS,
               vcmr_eval_batch_size=16 if rehearse else QUERY_BS,
               pack_queries=True, query_pack_segs=PACK_SEGS,
               query_pack_rows_per_call=PACK_ROWS)
    exp = os.path.join(root, "serve.json")
    with open(exp, "w") as f:
        json.dump(raw, f)
    opts = get_vcmr_args(["--config", exp])
    for d in ("log", "ckpt"):
        os.makedirs(os.path.join(out, d))
    with open(os.path.join(out, "log", "hps.json"), "w") as f:
        json.dump(vars(opts), f)
    save_params(os.path.join(out, "ckpt", f"model_step_{PROGRAM_STEP}.npz"),
                init_flat_params(cfg, vsm_config_from_opts(opts),
                                 seed=PROGRAM_SEED))
    return out


def _printed_metrics(stdout):
    """The metrics JSON the program prints last (``indent=2``)."""
    lines = stdout.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    return json.loads("\n".join(lines[start:]))


def serving_program(torch, here, cfg, db, dev, sync, rehearse):
    """``python -m hero_tpu_torch.drivers.eval_vcmr`` in a subprocess over
    the pretraining phase's videos written to disk and a query store,
    from a JAX-layout checkpoint (see the module docstring); then
    ``drivers/eval_vcmr.main`` in this process with the launch counters
    from 0.  Returns (record, its launches)."""
    from hero_tpu_torch.drivers import eval_vcmr as drv
    from hero_tpu_torch.drivers.common import eval_opts_from
    stage_s, t0 = {}, time.perf_counter()

    def stage(name):
        nonlocal t0
        now = time.perf_counter()
        stage_s[name] = now - t0
        t0 = now

    root = tempfile.mkdtemp(prefix="eval_vcmr_")
    try:
        sub_dir, feat_dir = write_pretrain_stores(db, root)
        n_q = 48 if rehearse else PROGRAM_QUERIES
        qb, qdata = make_queries(n_q, n_q, QUERY_SLOTS,
                                 cfg.f_config.vocab_size - 8, list(db.vids),
                                 1.5, seed=51)
        q_dir = write_query_store(qb[0], qdata, db.txt_db, root)
        out = serve_run_dir(here, root, cfg, sub_dir, feat_dir, q_dir,
                            rehearse)
        stage("write")
        argv = ["--output_dir", out, "--checkpoint", str(PROGRAM_STEP)]
        cmd = [sys.executable, "-m", "hero_tpu_torch.drivers.eval_vcmr"]
        if rehearse:     # the CLI serves on the card; the rehearsal asks
            cmd = [sys.executable, "-c",            # for the CPU in fp32
                   "import sys, torch\n"
                   "from hero_tpu_torch.drivers import eval_vcmr as e\n"
                   "e.configure_stdout()\n"
                   "e.main(e.build_argparser().parse_args(sys.argv[1:]), "
                   "device='cpu', dtype=torch.float32)"]
        t_p = time.perf_counter()
        proc = subprocess.run(cmd + argv, cwd=here, capture_output=True,
                              text=True, timeout=600)
        rec = {"stage_s": stage_s, "queries": n_q,
               "videos": len(db.vids),
               "program_wall_s": time.perf_counter() - t_p}
        if proc.returncode != 0:
            raise AssertionError(f"eval_vcmr exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        stage("program")
        path = os.path.join(out, f"results_{PROGRAM_STEP}_val_all.json")
        with open(path) as f:
            written = json.load(f)
        if set(written) != {"VCMR", "SVMR", "VR", "video2idx"}:
            raise AssertionError(f"results keys {sorted(written)}")
        for task in ("VCMR", "SVMR", "VR"):
            ids = sorted(e["desc_id"] for e in written[task])
            if ids != list(range(n_q)):
                raise AssertionError(f"{task}: not every query once")
        printed = _printed_metrics(proc.stdout)
        reset_counts()
        sync()
        t_i = time.perf_counter()
        metrics, sub = drv.main(drv.build_argparser().parse_args(argv),
                                device=dev,
                                dtype=torch.float32 if rehearse
                                else torch.bfloat16)
        sync()
        rec["in_process_wall_s"] = time.perf_counter() - t_i
        launches = read_counts()
        stage("in_process")
        check_submission(sub, metrics, n_q, len(db.vids),
                         eval_opts_from(drv.load_serve_opts(out)))
        rec["submission_equal"] = json.loads(json.dumps(sub)) == written
        rec["metrics_equal"] = (json.loads(json.dumps(metrics, default=float))
                                == printed)
        if not (rec["submission_equal"] and rec["metrics_equal"]):
            raise AssertionError(f"the program's results differ from the "
                                 f"in-process run's: {rec}")
        rec["metrics"] = {t: metrics[t] for t in ("VCMR", "SVMR", "VR")}
        return rec, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serving_full_phase(torch, here, cfg, flat, params, vsm, opts, batches,
                       query_batches, video_ids, video2idx, query_data,
                       small, db, dev, dtype, sync, rehearse, profile,
                       record):
    """Packed queries and the chunked corpus at the serving phase's
    flagship layout, their fp32 checks on the small corpus, and the
    eval_vcmr program (see the module docstring); with ``profile``, a
    trace of one packed and one unpacked ``validate_full_vcmr`` call.
    Returns
    (record, {path: launches})."""
    from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
    small_batches, small_q, small_qd = small
    rec, paths = {}, {}
    t_phase = time.perf_counter()
    _, _, n_rows, fill = packed_layout(query_batches)
    n_q = sum(len(b["qids"]) for b in query_batches)
    popts = packed_opts(opts)

    def serve(o):
        return validate_full_vcmr(
            params, cfg, vsm, o, batches, query_batches, video_ids,
            video2idx, query_data, dtype=dtype, device=dev)[1:]

    serve(popts)                                                # warm-up
    sync()
    reset_counts()
    sub, metrics = serve(popts)
    sync()
    paths["serving_packed"] = launches = read_counts()
    check_submission(sub, metrics, n_q, len(video_ids), popts)
    # the packed query encoders' attention is #1 in segment mode; the
    # one-row-a-query encoders' is #2 (the main path's counts)
    one_row = record["main_path_launches"]
    query_seg = (launches["seg_attention_cuda"]
                 - one_row["seg_attention_cuda"])
    if not rehearse and not (
            query_seg > 0 and launches["valid_attention_cuda"]
            < one_row["valid_attention_cuda"]):
        raise AssertionError(f"the packed queries did not run #1 in segment "
                             f"mode: {launches} vs one row a query "
                             f"{one_row}")
    runs = {"unpacked": [], "packed": []}
    subs = {}
    for i in range(PHASE_RUNS):
        order = (("unpacked", opts), ("packed", popts))
        for name, o in order if i % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            subs[name] = serve(o)[0]
            sync()
            runs[name].append(time.perf_counter() - t0)
    if profile:
        rec["profile"] = {
            "packed_call": profile_breakdown(torch, lambda: serve(popts), 1),
            "unpacked_call": profile_breakdown(torch, lambda: serve(opts),
                                               1)}
    k = min(10, len(video_ids))
    same_top = sum(a[:k] == b[:k] for a, b in zip(
        vr_ids(subs["unpacked"]), vr_ids(subs["packed"]), strict=True))
    med = {n: float(np.median(r)) for n, r in runs.items()}
    rec["packed"] = {
        "timed": "validate_full_vcmr end to end: phase 1, phase 2, the "
                 "host's decoding and metrics",
        "queries": n_q, "videos": len(video_ids), "segs": PACK_SEGS,
        "rows_per_call": PACK_ROWS, "packed_rows": n_rows,
        "slot_fill": fill, "unpacked_rows": n_q,
        "wall_s": med["packed"], "unpacked_wall_s": med["unpacked"],
        "queries_per_s": n_q / med["packed"],
        "unpacked_queries_per_s": n_q / med["unpacked"],
        "wall_s_runs": runs["packed"],
        "unpacked_wall_s_runs": runs["unpacked"],
        "phase2_queries_per_s": record["phases"]["phase2"]["queries_per_s"],
        "bf16_top10_identical": int(same_top),
        "query_encoder_seg_launches": query_seg,
        "launches": launches}
    rec["packed_fp32"] = packed_fp32_check(
        torch, cfg, flat, vsm, opts, small_batches, small_q, small_qd,
        "cpu" if rehearse else "cuda")
    log(f"packed queries: validate_full_vcmr {med['packed']:.3f} s vs "
        f"{med['unpacked']:.3f} s one row a query")

    chunk = 10 if rehearse else CHUNK_VIDEOS
    reset_counts()
    sync()
    t0 = time.perf_counter()
    _, sub, metrics = validate_full_vcmr(
        params, cfg, vsm, dataclasses.replace(opts, corpus_chunk_videos=chunk),
        batches, query_batches, video_ids, video2idx, query_data,
        dtype=dtype, device=dev)
    sync()
    paths["serving_chunked"] = read_counts()
    check_submission(sub, metrics, n_q, len(video_ids), opts)
    rec["chunked"] = {"videos": len(video_ids), "chunk": chunk,
                      "wall_s": time.perf_counter() - t0,
                      "resident_wall_s": record["main_path_wall_s"],
                      "launches": paths["serving_chunked"]}
    rec["chunked_fp32"] = chunked_fp32_check(
        torch, cfg, flat, vsm, opts, small_batches, small_q, small_qd,
        "cpu" if rehearse else "cuda")
    log(f"chunked corpus: {rec['chunked']['wall_s']:.2f} s vs "
        f"{rec['chunked']['resident_wall_s']:.2f} s resident")

    rec["program"], paths["eval_vcmr"] = serving_program(
        torch, here, cfg, db, dev, sync, rehearse)
    rec["program"]["launches"] = paths["eval_vcmr"]
    log(f"eval_vcmr program: {rec['program']['program_wall_s']:.1f} s")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, paths


# ---------------------------------------------------------------------------
# prepro: raw files -> the port's prepro entry points -> stores -> the
# suggested bucket -> VCMR serving
# ---------------------------------------------------------------------------

PREPRO_VIDEOS = 32
PREPRO_FRAMES = (60, 100)           # frames a video, 1.5 s apart
PREPRO_QUERIES = 2                  # TVR queries a video
PREPRO_QA = 16                      # TVQA questions, 5 answers each
PREPRO_CHECK_VIDEOS = 16            # videos of the fp32 ranking check
PREPRO_SEED = 17
SLOWFAST_DIM = 2304                 # of the 4352-d features; ResNet 2048


def _words(r, mean, lo, hi, caps=False):
    """Text of lognormal(ln mean, 0.4) words clipped to [lo, hi] (the hash
    tokenizer gives one id a word); ``caps``: ALL-CAPS with an HTML
    entity, which the tokenizers normalise."""
    n = int(np.clip(r.lognormal(np.log(mean), 0.40), lo, hi))
    text = " ".join(f"w{int(i)}" for i in r.randint(0, 20000, n))
    return f"{text.upper()} &amp; NO" if caps else text


def write_prepro_raw(root, vfeat_dim, n_videos, seed=PREPRO_SEED):
    """The raw inputs of the prepro phase under ``root``: per video a
    SlowFast (n, 2304) and a ResNet (n, 2048) float16 ``.npz``, n in
    ``PREPRO_FRAMES``; a subtitle jsonl in ``occupancy.sample_tv_video``'s
    TV distribution (a sub every lognormal(ln 4.3, 0.35) s clipped to
    [2, 12], lasting 0.7-1.0 of the gap, lognormal(ln 14, 0.4) words
    clipped to [4, 60], every fifth ALL-CAPS); a TVR query jsonl of
    ``PREPRO_QUERIES`` queries a video (N(15, 4) words in [5, 29], a span,
    a type); a TVQA jsonl (``PREPRO_QA`` questions, 5 answers) and a TVC
    caption jsonl (a clip a video, 1-3 captions).  Returns {vid: the
    expected (n, vfeat_dim) float16 rows}."""
    r = np.random.RandomState(seed)
    sf_dim = vfeat_dim * SLOWFAST_DIM // 4352
    for d in ("slowfast", "resnet"):
        os.makedirs(os.path.join(root, d))
    rows, subs, queries, qa, caps = {}, [], [], [], []
    for i in range(n_videos):
        vid = f"tv{i:03d}"
        n = int(r.randint(PREPRO_FRAMES[0], PREPRO_FRAMES[1] + 1))
        sf = r.standard_normal((n, sf_dim)).astype(np.float16)
        rn = r.standard_normal((n, vfeat_dim - sf_dim)).astype(np.float16)
        np.savez(os.path.join(root, "slowfast", f"{vid}.npz"), features=sf)
        np.savez(os.path.join(root, "resnet", f"{vid}.npz"), features=rn)
        rows[vid] = np.concatenate([sf, rn], -1)
        duration, track, t = n * 1.5, [], float(r.uniform(0.0, 2.0))
        while t < duration:
            gap = float(np.clip(r.lognormal(np.log(4.3), 0.35), 2.0, 12.0))
            ed = t + gap * float(r.uniform(0.7, 1.0))
            track.append({"text": _words(r, 14.0, 4, 60,
                                         caps=len(track) % 5 == 4),
                          "start": round(t, 3),
                          "end": round(min(ed, duration), 3)})
            t += gap
        subs.append({"vid_name": vid, "sub": track})
        for q in range(PREPRO_QUERIES):
            st = 1.5 * int(r.randint(0, n - 16))
            queries.append({
                "desc_id": len(queries), "vid_name": vid,
                "desc": " ".join(f"w{int(k)}" for k in r.randint(
                    0, 20000, int(np.clip(round(r.normal(15, 4)), 5, 29)))),
                "ts": [st, st + 1.5 * int(r.randint(2, 16))],
                "type": ("v", "t", "vt")[len(queries) % 3]})
        if i < PREPRO_QA:
            qa.append({"qid": f"tvqa{i}", "vid_name": vid,
                       "q": _words(r, 10.0, 3, 30),
                       "answers": [_words(r, 6.0, 1, 20) for _ in range(5)],
                       "answer_idx": int(r.randint(5)),
                       "ts": [3.0, 3.0 + 1.5 * int(r.randint(4, 30))]})
        st = 1.5 * int(r.randint(0, n - 30))
        caps.append({"vid_name": vid, "clip_id": f"{vid}_c0",
                     "duration": duration,
                     "ts": [st, st + 1.5 * int(r.randint(4, 30))],
                     "descs": [{"desc_id": 10 * i + c,
                                "desc": _words(r, 12.0, 4, 40)}
                               for c in range(int(r.randint(1, 4)))]})
    for name, items in (("subs.jsonl", subs), ("queries.jsonl", queries),
                        ("tvqa.jsonl", qa), ("captions.jsonl", caps)):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in items)
    return rows, queries, qa


def run_entry_point(here, name, args):
    """``python -m hero_tpu_torch.prepro.<name> args`` in a subprocess;
    returns (wall s, stdout).  A failure fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"hero_tpu_torch.prepro.{name}", *args],
        cwd=here, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"prepro.{name} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return wall, proc.stdout


def check_prepro_stores(root, rows, queries, qa):
    """What the entry points wrote: the video store's rows equal the
    ``.npz`` concatenation bit for bit; every frame of every video lies in
    exactly one unique sub or among the unmatched frames (the prepro
    alignment's partition); the query and QA ids are the hash
    tokenizer's; ``emit_sub_len_sidecar`` rewrites the prepro-written
    ``vid2sub_len.json`` byte for byte."""
    from hero_tpu_torch.data.store import HeroStore, VideoFeatStore
    from hero_tpu_torch.prepro.build_dbs import emit_sub_len_sidecar
    from hero_tpu_torch.prepro.tokenize import hash_tokenizer
    tok = hash_tokenizer()
    video = VideoFeatStore(os.path.join(root, "video_db"))
    if video.name2nframe != {v: x.shape[0] for v, x in rows.items()}:
        raise AssertionError("id2nframe.json differs from the features")
    for vid, want in rows.items():
        got = video[vid]
        if got.dtype != np.float16 or not np.array_equal(
                got.view(np.uint16), want.view(np.uint16)):
            raise AssertionError(f"video store rows of {vid} differ")
    sub_dir = os.path.join(root, "sub_db")
    subs = HeroStore(sub_dir)
    unmatched = 0
    for vid, want in rows.items():
        ex = subs[vid]
        frames = [f for _, fs in ex["unique_sub2frames"] for f in fs]
        unmatched += len(ex["unmatched_frames"])
        if (len(frames) != len(set(frames)) or sorted(
                frames + list(ex["unmatched_frames"]))
                != list(range(want.shape[0]))):
            raise AssertionError(f"{vid}: the subs do not partition the "
                                 f"frames")
    subs.close()
    q_store = HeroStore(os.path.join(root, "query_db"))
    for q in queries:
        if q_store[str(q["desc_id"])]["input_ids"] != tok(q["desc"]):
            raise AssertionError(f"query {q['desc_id']}: ids differ")
    qa_store = HeroStore(os.path.join(root, "qa_db"))
    for q in qa:
        if qa_store[q["qid"]]["input_ids"] != [tok(q["q"])] + [
                tok(a) for a in q["answers"]]:
            raise AssertionError(f"question {q['qid']}: ids differ")
    path = os.path.join(sub_dir, "vid2sub_len.json")
    with open(path, "rb") as f:
        written = f.read()
    os.remove(path)
    emit_sub_len_sidecar(sub_dir)
    with open(path, "rb") as f:
        if f.read() != written:
            raise AssertionError("emit_sub_len_sidecar differs from the "
                                 "prepro-written vid2sub_len.json")
    return {"video_rows_bit_equal": True, "frames_partitioned": True,
            "unmatched_frames": unmatched, "query_ids_equal": len(queries),
            "qa_ids_equal": len(qa), "sidecar_equal": True}


def prepro_phase(torch, here, cfg, flat, params, vsm, opts, dev, dtype,
                 sync, rehearse, kernels):
    """The raw inputs (:func:`write_prepro_raw`) through the four prepro
    entry points as ``python -m`` subprocesses with ``--tokenizer hash``
    (each timed), the stores checked (:func:`check_prepro_stores`), the
    ``--pack_subs`` bucket ``prepro.suggest_bucket`` sizes from the sub
    store (``suggest_packed_shapes``; and ``suggest_downstream_lens`` of
    the QA and caption stores), then ``validate_full_vcmr`` over ``load_data.load_video_sub_dataset``
    and the query store through ``train_vcmr.build_eval_inputs``, with
    the launch counters from 0; in fp32 the kernel path's top-10 videos
    those of the plain path on the CPU (``integration_check``, the first
    ``PREPRO_CHECK_VIDEOS`` videos).  With ``kernels``, #1 at the
    bucket's f-encoder rows and #2 at the c-encoder's are held against
    their plain versions and timed.  Returns (record, launches)."""
    import torch.nn.functional as F
    from hero_tpu_torch.data import load_data
    from hero_tpu_torch.data.downstream_tasks import suggest_downstream_lens
    from hero_tpu_torch.data.store import QueryTokStore
    from hero_tpu_torch.data.video import (FixedShapes, stack_items,
                                           video_fits_bucket)
    from hero_tpu_torch.drivers.train_vcmr import build_eval_inputs
    from hero_tpu_torch.evaluation.vcmr_eval import validate_full_vcmr
    from hero_tpu_torch.prepro import suggest_bucket
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="prepro_")
    try:
        n_videos = 8 if rehearse else PREPRO_VIDEOS
        rows, queries, qa = write_prepro_raw(root, cfg.vfeat_dim, n_videos)
        rec = {"videos": n_videos, "frames": sum(
            x.shape[0] for x in rows.values()), "queries": len(queries),
               "raw_s": time.perf_counter() - t_phase}

        def path(name):
            return os.path.join(root, name)

        walls, out = {}, {}
        for name, key, args in (
                ("convert_videodb", "convert_videodb",
                 ["--slowfast_dir", path("slowfast"), "--resnet_dir",
                  path("resnet"), "--output", path("video_db")]),
                ("prepro_sub", "prepro_sub",
                 ["--sub_jsonl", path("subs.jsonl"), "--vid2nframe",
                  path("video_db/id2nframe.json"), "--output",
                  path("sub_db"), "--tokenizer", "hash"]),
                ("prepro_query", "prepro_query_tvr",
                 ["--query_jsonl", path("queries.jsonl"), "--task", "tvr",
                  "--output", path("query_db"), "--tokenizer", "hash"]),
                ("prepro_query", "prepro_query_tvqa",
                 ["--query_jsonl", path("tvqa.jsonl"), "--task", "tvqa",
                  "--output", path("qa_db"), "--tokenizer", "hash"]),
                ("prepro_tvc", "prepro_tvc",
                 ["--caption_jsonl", path("captions.jsonl"), "--output",
                  path("tvc_db"), "--tokenizer", "hash"])):
            walls[key], out[key] = run_entry_point(here, name, args)
        if out["convert_videodb"].strip() != (f"converted {n_videos} videos "
                                              f"(0 corrupted)"):
            raise AssertionError(out["convert_videodb"])
        rec["entry_point_wall_s"] = walls
        rec["store_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs
            if "_db" in os.path.relpath(d, root))
        rec["checks"] = check_prepro_stores(root, rows, queries, qa)

        # the flags suggest_bucket prints for a --pack_subs run, as the
        # drivers' options turn them into a bucket (common.shapes_from_opts)
        flags = suggest_bucket.suggest(suggest_bucket.build_argparser(
            ).parse_args(["--sub_txt_db", path("sub_db"), "--pack"]))
        rec["bucket"] = flags
        shapes = FixedShapes(
            n_subs=flags["bucket_n_subs"], txt_len=flags["bucket_txt_len"],
            frames_per_sub=flags["bucket_frames_per_sub"],
            n_frames=flags["max_clip_len"], n_queries=1,
            query_len=QUERY_SLOTS, vfeat_dim=cfg.vfeat_dim)
        rec["downstream_lens"] = {
            "tvqa": suggest_downstream_lens("tvqa", path("qa_db")),
            "tvc": suggest_downstream_lens("tvc", path("tvc_db"))}
        video_db = load_data.load_video_sub_dataset(
            path("video_db"), path("sub_db"), shapes,
            max_clip_len=flags["max_clip_len"], max_txt_len=60, pack=True)
        opts = dataclasses.replace(opts, max_clip_len=flags["max_clip_len"])
        rec["videos_in_bucket"] = sum(video_fits_bucket(video_db, v)
                                      for v in video_db.vids)
        if rec["videos_in_bucket"] < 0.99 * n_videos:
            raise AssertionError(f"the suggested bucket holds "
                                 f"{rec['videos_in_bucket']} of {n_videos}")
        query_db = QueryTokStore(path("query_db"), max_txt_len=60)
        eval_opts = types.SimpleNamespace(vcmr_eval_video_batch_size=VIDEO_BS,
                                          vcmr_eval_batch_size=QUERY_BS)
        rec["setup_s"] = time.perf_counter() - t_phase

        vb, qb, video_ids, v2i, qdata = build_eval_inputs(video_db, query_db,
                                                          eval_opts)
        batches, query_batches = list(vb), list(qb)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        _, sub_out, metrics = validate_full_vcmr(
            params, cfg, vsm, opts, batches, query_batches, video_ids, v2i,
            qdata, dtype=dtype, device=dev)
        sync()
        rec["serve_wall_s"] = time.perf_counter() - t0
        launches = read_counts()
        check_submission(sub_out, metrics, len(queries), n_videos, opts)
        rec["metrics"] = {t: metrics[t] for t in ("VCMR", "SVMR", "VR")}
        rec["launches"] = launches
        if video_db.truncation_report()["subs_dropped"]:
            raise AssertionError(f"the bucket dropped subs: "
                                 f"{video_db.truncation_report()}")
        check = stack_items([video_db.video_item(v)
                             for v in video_ids[:PREPRO_CHECK_VIDEOS]])
        rec["integration_fp32"] = integration_check(
            torch, cfg, flat, vsm, opts, [check], query_batches[0],
            "cpu" if rehearse else "cuda", "cpu")
        b = batches[0]
        B, S, Lt = b["sub_input_ids"].shape
        Fs = b["sub_frame_idx"].shape[2]
        rec["f_encoder_rows"] = [B * S, Fs + Lt, cfg.f_config.hidden_size]
        if kernels is not None:
            att_dev = torch.device("cuda")
            from hero_tpu_torch.ops import attention as att
            D = cfg.f_config.hidden_size
            seg = torch.from_numpy(np.concatenate(
                [b["sub_frame_seg"], b["sub_txt_seg"]], 2).reshape(
                    B * S, Fs + Lt)).to(att_dev)
            cm = torch.from_numpy(b["c_attn_masks"]).to(att_dev)
            new = {"attention_seg": check_attention(
                       torch, F, att, B * S, Fs + Lt, D,
                       cfg.f_config.num_attention_heads, seg, True,
                       torch.bfloat16) | {
                           "mode": "prepro: the suggested packed bucket's "
                                   "f-encoder"},
                   "attention_valid": check_attention(
                       torch, F, att, B, cm.shape[1], D,
                       cfg.c_config.num_attention_heads, cm, False,
                       torch.bfloat16) | {"mode": "prepro: c-encoder"}}
            for row in kernels:
                if row["name"] in new:
                    row["shapes"].append(new[row["name"]])
        rec["phase_s"] = time.perf_counter() - t_phase
        return rec, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# components: tools/component_bench.py and the DALN checks of
# tools/kernel_smoke.py and tools/tpu_kernel_drive.py
# ---------------------------------------------------------------------------

COMP_ROWS, COMP_LEN = 256, 56          # f-encoder token rows at bench shape
COMP_CLIPS, COMP_CLIP_LEN = 32, 100    # c-encoder clips
DALN_SHAPES = ((COMP_ROWS * COMP_LEN, 768), (COMP_ROWS, 4352))
DALN_KEEP_BANDS = {(1024, 768): (0.88, 0.92), (256, 4352): (0.87, 0.93)}


def mha_bwd_bound(B, H, Lq, Lk, d, elt):
    """(bound ms, bound_by) of #5 at (B, H, Lq, Lk, d) of ``elt``-byte
    elements: q and dO read and dq written (Lq rows), k and v read and dk
    and dv written (Lk rows), each once, the fp32 key mask read; the
    probabilities recomputed (2 Lq Lk d flops a head), dp, dv, dq and dk
    (2 Lq Lk d each) on the tensor cores."""
    return bound_ms((3 * Lq + 4 * Lk) * B * H * d * elt + B * Lk * 4,
                    10 * B * H * Lq * Lk * d, "bfloat16")


def check_mha_bwd(torch, F, att, B, H, Lq, Lk, d, causal):
    """#5 against ``mha_backward_reference``, fp32 and bf16 at rate 0 and
    0.1, with a partial key mask and a fully masked last batch row
    (finite, and the unmasked attention's gradients up to the rounding of
    s - 1e4); repeats identical.  bf16 timings at rate 0.1 against the
    plain backward and SDPA's autograd backward."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * Lq + Lk + 1)
    lens = torch.randint(1, Lk + 1, (B, 1), generator=gen, device=dev)
    mask = (torch.arange(Lk, device=dev)[None] < lens).float()
    mask[-1] = 0.0
    checks, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q = torch.randn((B, H, Lq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, H, Lk, d), generator=gen, device=dev).to(
            dtype) for _ in range(2))
        g = torch.randn((B, H, Lq, d), generator=gen, device=dev).to(dtype)
        for rate in (0.0, TRAIN_RATE):
            got = att.mha_attention_bwd_cuda(q, k, v, mask, g, rate,
                                             TRAIN_SEED, causal)
            want = att.mha_backward_reference(q, k, v, mask, g, rate,
                                              TRAIN_SEED, causal)
            again = att.mha_attention_bwd_cuda(q, k, v, mask, g, rate,
                                               TRAIN_SEED, causal)
            top = max(float(w.float().abs().max()) for w in want)
            rec = {"err": max(_err(a[:-1], w[:-1])
                              for a, w in zip(got, want)),
                   "tol": min(_train_tol(w[:-1], name) for w in want),
                   # the masked row's probabilities carry the rounding of
                   # s - 1e4 (~2^-10 relative)
                   "masked_row_err": max(_err(a[-1], w[-1])
                                         for a, w in zip(got, want)),
                   "masked_row_tol": 2.0 ** -6 * max(1.0, top),
                   "finite": all(bool(torch.isfinite(a).all())
                                 for a in got),
                   "deterministic": all(torch.equal(a, b)
                                        for a, b in zip(got, again))}
            rec["ok"] = (rec["err"] <= rec["tol"] and rec["finite"]
                         and rec["masked_row_err"] <= rec["masked_row_tol"]
                         and rec["deterministic"])
            checks[f"{name}_rate{rate}"] = rec
            if not rec["ok"]:
                raise AssertionError(f"mha backward {[B, H, Lq, Lk, d]} "
                                     f"causal={causal} {name} rate {rate}: "
                                     f"{rec}")
        rows[name] = (q, k, v, g)
    q, k, v, g = rows["bfloat16"]
    rate = TRAIN_RATE
    ms = time_ms(torch, lambda: att.mha_attention_bwd_cuda(
        q, k, v, mask, g, rate, TRAIN_SEED, causal))
    plain_ms = time_ms(torch, lambda: att.mha_backward_reference(
        q, k, v, mask, g, rate, TRAIN_SEED, causal))
    bias = _sdpa_bias(torch, mask, Lq, causal, q.dtype)
    hq, hk, hv = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias,
                                                 dropout_p=rate)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (hq, hk, hv), g, retain_graph=True))
    b_ms, by = mha_bwd_bound(B, H, Lq, Lk, d, q.element_size())
    bf = checks["bfloat16_rate0.1"]
    return {"shape": [B, H, Lq, Lk, d],
            "mode": ("causal, " if causal else "") + "dropout 0.1",
            "dtype": "bfloat16", "max_abs_err": bf["err"], "tol": bf["tol"],
            "checks": checks, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


def check_daln(torch, lnm, drop, n, d):
    """#8 and #9 against their plain versions at (n, d), fp32 and bf16 at
    rate 0 and 0.1; the kernels' Philox bits equal the plain row mask
    (#9's dy is keep * dx / (1 - rate) bit for bit, and adding 100 to the
    entries of y that the plain mask drops leaves #8's output and #9's dx
    bit-identical); the plain mask's keep rate at 0.1 within its band
    (``tools/tpu_kernel_drive.py``: [0.88, 0.92] at (1024, 768), and
    [0.87, 0.93] at (256, 4352), ``tools/kernel_smoke.py``'s band) or else
    within 4 sigma of 0.9; a repeat bit-identical.  bf16 timings at rate
    0.1 against the plain versions and the unfused chain (``nn.dropout``,
    the add and ``layer_norm``, fwd and fwd+bwd through its kernels), and
    at rate 0 (``rate0_ms``: no draw, so the difference is the draw's
    cost); #9's row pass and column pass from a profiler trace."""
    from hero_tpu_torch.models import nn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n + 7 * d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    y32, x32, g32 = (torch.randn((n, d), generator=gen, device=dev)
                     for _ in range(3))
    keep = drop.row_keep_mask(TRAIN_SEED, n, d, TRAIN_RATE, device=dev)
    rate_obs = float(keep.float().mean())
    lo, hi = DALN_KEEP_BANDS.get((n, d), (
        0.9 - 4 * (0.09 / (n * d)) ** 0.5, 0.9 + 4 * (0.09 / (n * d)) ** 0.5))
    dy, dx = lnm.dropout_add_layer_norm_bwd_cuda(y32, x32, w, g32, TRAIN_RATE,
                                                 TRAIN_SEED)[:2]
    masks = {"identical_to_plain": bool(torch.equal(dy, torch.where(
        keep, dx * drop.keep_scale(TRAIN_RATE), 0.0))),
        "keep_rate": rate_obs, "keep_band": [lo, hi]}
    y2 = torch.where(keep, y32, y32 + 100.0)
    out = lnm.dropout_add_layer_norm_cuda(y32, x32, w, b, TRAIN_RATE,
                                          TRAIN_SEED)
    masks["perturbed_dropped_identical"] = bool(torch.equal(
        out, lnm.dropout_add_layer_norm_cuda(y2, x32, w, b, TRAIN_RATE,
                                             TRAIN_SEED)) and torch.equal(
        dx, lnm.dropout_add_layer_norm_bwd_cuda(y2, x32, w, g32, TRAIN_RATE,
                                                TRAIN_SEED)[1]))
    masks["ok"] = (masks["identical_to_plain"] and lo <= rate_obs <= hi
                   and masks["perturbed_dropped_identical"])
    if not masks["ok"]:
        raise AssertionError(f"dropout_add_layer_norm mask {[n, d]}: "
                             f"{masks}")
    checks = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        y, x, g = (t.to(dtype) for t in (y32, x32, g32))
        for rate in (0.0, TRAIN_RATE):
            rec = _daln_case(torch, lnm, y, x, w, b, g, rate)[0]
            checks[f"{name}_rate{rate}"] = rec
            if not rec["ok"]:
                raise AssertionError(f"dropout_add_layer_norm {[n, d]} "
                                     f"{name} rate {rate}: {rec}")
    y, x, g = (t.to(torch.bfloat16) for t in (y32, x32, g32))
    rate = TRAIN_RATE
    (fwd0, bwd0), (fwd_ms, bwd_ms) = (daln_times(torch, lnm, y, x, w, b, g,
                                                 r) for r in (0.0, rate))
    split = kernel_ms_by_name(
        torch, lambda: lnm.dropout_add_layer_norm_bwd_cuda(
            y, x, w, g, rate, TRAIN_SEED),
        SPLIT_PARTS["daln_bwd"], ["daln_bwd", n, d, rate, TRAIN_SEED])
    fwd_plain = time_ms(torch, lambda: lnm.dropout_add_layer_norm_reference(
        y, x, w, b, rate, TRAIN_SEED))
    bwd_plain = time_ms(torch, lambda:
                        lnm.dropout_add_layer_norm_bwd_reference(
                            y, x, w, g, rate, TRAIN_SEED))
    fwd_chain = time_ms(torch, lambda: lnm.layer_norm(
        nn.dropout(y, rate, TRAIN_SEED) + x, w, b))
    yl, xl, wl, bl = (t.detach().requires_grad_(True) for t in (y, x, w, b))
    with torch.enable_grad():
        chain_out = lnm.layer_norm(nn.dropout(yl, rate, TRAIN_SEED) + xl, wl,
                                   bl)
    bwd_chain = time_ms(torch, lambda: torch.autograd.grad(
        chain_out, (yl, xl, wl, bl), g, retain_graph=True))
    (fb, fby), (bb, bby) = daln_bounds(n, d, y.element_size(), rate)
    bf = checks["bfloat16_rate0.1"]
    common = {"shape": [n, d], "dtype": "bfloat16", "library_ms": None,
              "checks": checks, "dropout_masks": masks}
    return ({**common, "mode": "dropout 0.1", "max_abs_err": bf["fwd_err"],
             "tol": bf["fwd_tol"], "ms": fwd_ms, "rate0_ms": fwd0,
             "plain_ms": fwd_plain, "bound_ms": fb, "bound_by": fby,
             "chain_ms": fwd_chain},
            {**common, "mode": "dropout 0.1",
             "max_abs_err": max(bf["dy_err"], bf["dx_err"]),
             "tol": min(bf["dy_tol"], bf["dx_tol"]), "ms": bwd_ms,
             "rate0_ms": bwd0,
             "plain_ms": bwd_plain, "bound_ms": bb, "bound_by": bby,
             "chain_ms": bwd_chain, **split})


# #8/#9's work an element on the CUDA cores: ~10 fp32 operations forward
# (s, the two row sums, the affine) and ~26 backward (s in each of three
# passes, the paired sums, ds, dy, the dw/db sums); at a rate above 0 the
# keep bits: one Philox4x32-10 call (10 rounds of 4 multiplies, 2
# three-way xors and 2 key adds: 80 integer operations) per four columns,
# and about 4 for each column's keep bit (the compare, its place in the
# mask, reading it back), 24 an element.  All are
# taken at the fp32 peak (67e12 a second), which the integer work cannot
# reach (the H100 runs 32-bit integer operations at half the fp32 lane
# rate), so the bound stays a lower bound.
DALN_FWD_OPS, DALN_BWD_OPS, DALN_DRAW_OPS = 10, 26, 80 // 4 + 4


def daln_bounds(n, d, elt, rate):
    """(bound ms, bound_by) of #8 and of #9 at (n, d) of ``elt``-byte
    elements: y and x read and out written, w and b read (fp32) forward;
    y, x, g read and dy, dx written, w read and dw, db written backward."""
    draw = DALN_DRAW_OPS if rate else 0
    return (bound_ms(3 * n * d * elt + 2 * d * 4,
                     (DALN_FWD_OPS + draw) * n * d, "float32"),
            bound_ms(5 * n * d * elt + 3 * d * 4,
                     (DALN_BWD_OPS + draw) * n * d, "float32"))


def daln_times(torch, lnm, y, x, w, b, g, rate):
    """Device ms of one #8 and one #9 launch at ``rate`` (``time_ms``)."""
    return (time_ms(torch, lambda: lnm.dropout_add_layer_norm_cuda(
                y, x, w, b, rate, TRAIN_SEED)),
            time_ms(torch, lambda: lnm.dropout_add_layer_norm_bwd_cuda(
                y, x, w, g, rate, TRAIN_SEED)))


def daln_ab(torch, lnm):
    """#8 and #9 of the imported package, bf16, at ``DALN_SHAPES`` and
    (1024, 768): device ms at rates 0 (no draw) and 0.1.  For an A/B of
    two checkouts on one card (``--times daln ROOT``, in turns); checks
    nothing."""
    dev = torch.device("cuda")
    rows = []
    for n, d in DALN_SHAPES + ((1024, 768),):
        gen = torch.Generator(device=dev).manual_seed(n + 7 * d)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        y, x, g = (torch.randn((n, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        row = {"shape": [n, d]}
        for rate in (0.0, TRAIN_RATE):
            row[f"fwd_ms_rate{rate}"], row[f"bwd_ms_rate{rate}"] = (
                daln_times(torch, lnm, y, x, w, b, g, rate))
        rows.append(row)
    return rows


# #3's shapes for ``--times bwd3``: (B, Lq, Lk, width, heads), every path
# shape of PERF.md's #3 rows (the VSM train step's four, the TVC
# decoder's causal and cross-attention, the components', pretraining's,
# the programs', the dp modes') and square heads at and past the old
# ceilings (fp32 154, bf16 240 rows at head_dim 64)
BWD3_TIME_SHAPES = (
    (128, 104, 104, 768, 12), (128, 144, 144, 768, 12),
    (32, 100, 100, 768, 12), (64, 30, 30, 768, 12),
    (8, 62, 62, 768, 12), (8, 62, 100, 768, 12),
    (256, 56, 56, 768, 12), (256, 138, 138, 768, 12),
    (160, 32, 32, 768, 12), (128, 136, 136, 768, 12),
    (1024, 77, 77, 768, 12), (96, 161, 161, 768, 12),
    (640, 136, 136, 768, 12), (20, 132, 132, 768, 12),
    (160, 200, 200, 768, 12), (64, 104, 104, 768, 12),
    (128, 104, 104, 384, 6), (32, 100, 100, 384, 6),
    (32, 50, 100, 768, 12),
    (16, 154, 154, 768, 12), (16, 240, 240, 768, 12),
    (16, 241, 241, 768, 12), (16, 256, 256, 768, 12),
    (16, 400, 400, 768, 12), (16, 1024, 1024, 768, 12))


def bwd3_times(torch, att, library):
    """#3 of the imported package at ``BWD3_TIME_SHAPES`` in bf16 and
    fp32, dropout 0.1 and (``ms_rate0``) none: device ms (``time_ms``)
    or the error a shape raised, the bound (``check_attention_train``'s
    count: p, q, k, v and dO read once, dq, dk, dv written once; 8 Lq Lk
    d flops a head) and, with ``library``, SDPA's backward on the same
    inputs (autograd of ``F.scaled_dot_product_attention`` with an
    additive zero mask and dropout_p 0.1).  The probabilities are a
    softmax of random scores, so none is 0 and every element draws its
    keep bit (the most the kernels draw; a path's masks give zeros that
    draw nothing, as the smoke's own rows at the batches' masks show).
    Checks nothing: an A/B of two checkouts on one card (``--times bwd3
    ROOT``, in turns)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    rows = []
    for B, Lq, Lk, D, H in BWD3_TIME_SHAPES:
        d = D // H
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            gen = torch.Generator(device=dev).manual_seed(B + Lq + 3 * Lk)
            q, dout = (torch.randn((B, Lq, D), generator=gen,
                                   device=dev).to(dtype) for _ in range(2))
            k, v = torch.randn((B, Lk, 2 * D), generator=gen,
                               device=dev).to(dtype).split(D, dim=-1)
            probs = torch.softmax(torch.randn(
                (B, H, Lq, Lk), generator=gen, device=dev), -1).to(dtype)
            elt = q.element_size()
            b_ms, by = bound_ms(
                (B * H * Lq * Lk + (3 * Lq + 4 * Lk) * B * D) * elt,
                8 * B * H * Lq * Lk * d, name)
            row = {"shape": [B, Lq, Lk, D], "heads": H, "dtype": name,
                   "bound_ms": b_ms, "bound_by": by}
            try:
                for key, rate in (("ms", TRAIN_RATE), ("ms_rate0", 0.0)):
                    row[key] = time_ms(torch, lambda: att.attention_bwd_cuda(
                        probs, q, k, v, dout, H, rate, TRAIN_SEED))
            except (ValueError, RuntimeError) as e:
                row["refused"] = str(e)
            if library:
                hq, hk, hv = (t.reshape(B, -1, H, d).transpose(1, 2).detach(
                    ).requires_grad_(True) for t in (q, k, v))
                bias = torch.zeros((B, 1, Lq, Lk), device=dev, dtype=dtype)
                with torch.enable_grad():
                    out = F.scaled_dot_product_attention(
                        hq, hk, hv, attn_mask=bias, dropout_p=TRAIN_RATE)
                hdo = dout.reshape(B, Lq, H, d).transpose(1, 2)
                row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                    out, (hq, hk, hv), hdo, retain_graph=True))
                del out
            rows.append(row)
            log("bwd3", json.dumps(row))
            del q, dout, k, v, probs
            torch.cuda.empty_cache()
    return rows


# #1/#2's shapes for ``--times fwd``: every path shape of PERF.md's #1/#2
# rows as (name, B, Lq, Lk, width, heads, mask, causal, rate).  The masks
# are modelled on the paths', not taken from their batches (the smoke's
# own rows at the batches' masks give the share the skip rule leaves out
# there): mask "packed F T" is packed f-encoder rows ([F frame slots | T
# text slots], 4 subs a row, each sub's frames and tokens one segment, pad
# slots -1),
# "queries N" packed query rows of 30 slots (1-N queries a row, pad slots;
# "queries 0": one row of queries, the rest all-pad rows), "frames" a
# valid prefix of frames, "tokens" a valid prefix of tokens, "unpacked F
# T" [frames | tokens] each a valid prefix, "fused" the fused c-encoder's
# [frames, pad frames, QA tokens, pad], "all" every key valid; rate 0.1
# saves the probabilities (training), rate 0 does not (serving).
FWD_TIME_SHAPES = (
    ("serving f-encoder", 200, 104, 104, 768, 12, "packed 16 88", False, 0.0),
    ("packed queries, first call", 64, 30, 30, 768, 12, "queries 4", False,
     0.0),
    ("packed queries, last call", 64, 30, 30, 768, 12, "queries 0", False,
     0.0),
    ("train f-encoder", 128, 104, 104, 768, 12, "packed 16 88", False, 0.1),
    ("train f-encoder overflow", 128, 144, 144, 768, 12, "packed 24 120",
     False, 0.1),
    ("pretrain f-encoder", 256, 138, 138, 768, 12, "packed 18 120", False,
     0.0),
    ("pretrain f-encoder train", 256, 138, 138, 768, 12, "packed 18 120",
     False, 0.1),
    ("qa --pack_subs f-encoder train", 160, 200, 200, 768, 12,
     "packed 40 160", False, 0.1),
    ("dp PP f-encoder train", 64, 104, 104, 768, 12, "packed 16 88", False,
     0.1),
    ("dp TP f-encoder train", 128, 104, 104, 384, 6, "packed 16 88", False,
     0.1),
    ("prepro f-encoder", 256, 96, 96, 768, 12, "packed 16 80", False, 0.0),
    ("serving c-encoder", 50, 100, 100, 768, 12, "frames", False, 0.0),
    ("serving queries", 64, 30, 30, 768, 12, "tokens", False, 0.0),
    ("train c-encoder", 32, 100, 100, 768, 12, "frames", False, 0.1),
    ("train queries", 64, 30, 30, 768, 12, "tokens", False, 0.1),
    ("tvc causal", 32, 31, 31, 768, 12, "all", True, 0.0),
    ("tvc cross", 32, 1, 100, 768, 12, "frames", False, 0.0),
    ("tvc train causal", 8, 62, 62, 768, 12, "all", True, 0.1),
    ("tvc train cross", 8, 62, 100, 768, 12, "frames", False, 0.1),
    ("components f-encoder", 256, 56, 56, 768, 12, "all", False, 0.0),
    ("components f-encoder train", 256, 56, 56, 768, 12, "all", False, 0.1),
    ("components c-encoder train", 32, 100, 100, 768, 12, "all", False,
     0.1),
    ("pretrain VSM queries train", 160, 32, 32, 768, 12, "tokens", False,
     0.1),
    ("tvc_program f-encoder train", 128, 136, 136, 768, 12,
     "unpacked 16 120", False, 0.1),
    ("tvc_program validation f-encoder", 256, 136, 136, 768, 12,
     "unpacked 16 120", False, 0.0),
    ("vcmr_program TVR f-encoder train", 1024, 77, 77, 768, 12,
     "unpacked 16 61", False, 0.1),
    ("vcmr_program MSR-VTT f-encoder train", 96, 161, 161, 768, 12,
     "unpacked 40 121", False, 0.1),
    ("qa_program TVQA f-encoder train", 640, 136, 136, 768, 12,
     "unpacked 16 120", False, 0.1),
    ("qa_program fused c-encoder train", 20, 132, 132, 768, 12, "fused",
     False, 0.1),
    ("dp TP c-encoder train", 32, 100, 100, 384, 6, "frames", False, 0.1),
    ("dp SP seq rank train", 32, 50, 100, 768, 12, "frames", False, 0.1),
    ("prepro c-encoder", 32, 100, 100, 768, 12, "frames", False, 0.0),
)
# #5's shapes for ``--times fwd``: (name, B, H, Lq, Lk, head_dim, causal),
# dropout 0.1: the components' and TVC's, and past the old ceilings
MHA_BWD_TIME_SHAPES = (
    ("components", 256, 12, 56, 56, 64, False),
    ("tvc causal", 32, 12, 31, 31, 64, True),
    ("tvc cross", 8, 12, 62, 100, 64, False),
    ("square 400", 4, 12, 400, 400, 64, False),
    ("square 401", 4, 12, 401, 401, 64, False),
    ("square 1024", 2, 12, 1024, 1024, 64, True),
)


def fwd_time_mask(np, kind, B, Lk, seed):
    """The key mask of ``FWD_TIME_SHAPES``' ``kind`` for B rows of Lk
    slots: int32 segment ids (the packed kinds) or float validity."""
    r = np.random.RandomState(seed)
    words = kind.split()
    if words[0] == "packed":
        nf, nt = int(words[1]), int(words[2])
        seg = np.full((B, Lk), -1, np.int32)
        for b in range(B):
            cuts = np.sort(r.choice(np.arange(1, nf), 3, replace=False))
            fl = np.diff(np.concatenate([[0], cuts, [nf]]))
            used = int(r.randint(nt * 3 // 4, nt + 1))
            cuts = np.sort(r.choice(np.arange(4, used - 3), 3,
                                    replace=False))
            tl = np.diff(np.concatenate([[0], cuts, [used]]))
            f0, t0 = 0, nf
            for s in range(4):
                seg[b, f0:f0 + fl[s]] = s
                seg[b, t0:t0 + tl[s]] = s
                f0, t0 = f0 + fl[s], t0 + tl[s]
        return seg
    if words[0] == "queries":
        seg = np.full((B, Lk), -1, np.int32)
        rows = 1 if words[1] == "0" else B
        for b in range(rows):
            pos, s = 0, 0
            for _ in range(int(r.randint(1, max(2, int(words[1]) + 1)))):
                n = int(r.randint(4, 12))
                if pos + n > Lk:
                    break
                seg[b, pos:pos + n] = s
                pos, s = pos + n, s + 1
        return seg
    if words[0] == "all":
        return np.ones((B, Lk), np.float32)
    if words[0] == "unpacked":
        nf, nt = int(words[1]), int(words[2])
        m = np.zeros((B, Lk), np.float32)
        fl = r.randint(nf // 2, nf + 1, B)
        tl = r.randint(nt // 3, nt + 1, B)
        for b in range(B):
            m[b, :fl[b]] = 1.0
            m[b, nf:nf + tl[b]] = 1.0
        return m
    if words[0] == "fused":
        m = np.zeros((B, Lk), np.float32)
        for b in range(B):
            m[b, :int(r.randint(50, 101))] = 1.0
            m[b, 100:100 + int(r.randint(10, 33))] = 1.0
        return m
    lo = Lk // 2 if words[0] == "frames" else 4
    lens = r.randint(lo, Lk + 1, B)
    return (np.arange(Lk)[None] < lens[:, None]).astype(np.float32)


def skip_share(np, mask, Lq, causal, seg):
    """The share of (16-row tile, 16-key chunk) pairs that the bf16
    forward's skip rule leaves out at these masks (segment ids if
    ``seg``, else key validity), computed here from the rule, not counted
    by the kernel: no row of the tile attends a key of the chunk, every
    row of the tile attends some key, and the chunk is one of the first
    64.  The kernel marks a chunk only once its rows' running max holds an
    attended key, and not where scores spread past its 1000 margin
    (``kSkipGap``), so it skips at most this share."""
    B, Lk = mask.shape
    nt, nc = (Lq + 15) // 16, (Lk + 15) // 16
    if seg:
        rows = mask[:, :Lq]
        allowed = (rows[:, :, None] == mask[:, None]) & (rows >= 0)[:, :, None]
    else:
        allowed = np.broadcast_to(mask[:, None] > 0, (B, Lq, Lk))
    if causal:
        allowed = allowed & (np.arange(Lk)[None]
                             <= np.arange(Lq)[:, None] + (Lk - Lq))
    attends = np.ones((B, 16 * nt), bool)
    attends[:, :Lq] = allowed.any(2)
    tile_ok = attends.reshape(B, nt, 16).all(2)
    grid = np.zeros((B, 16 * nt, 16 * nc), bool)
    grid[:, :Lq, :Lk] = allowed
    dead = ~grid.reshape(B, nt, 16, nc, 16).any((2, 4))
    dead[:, :, 64:] = False
    return float((dead & tile_ok[:, :, None]).sum()) / (B * nt * nc)


def fwd_times(torch, att, library):
    """#1/#2 (bf16) of the imported package at ``FWD_TIME_SHAPES`` with the
    masks modelled on the path's and with every key valid (one segment, no
    pad slot), and #5 (bf16, dropout 0.1) at ``MHA_BWD_TIME_SHAPES``:
    device ms (``time_ms``) or the error a shape raised, the bound (#1/#2:
    q, k, v and the output once, the mask, the saved p in training, 4 Lq
    Lk d flops a head; #5: ``mha_bwd_bound``), the share of chunks the
    skip rule leaves out at the modelled masks (``skip_share``) and, with
    ``library``, SDPA on the same inputs (the additive mask; #5: its
    backward with dropout 0.1).  Checks nothing: an A/B of two checkouts
    on one card (``--times fwd ROOT``, in turns)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    dtype = torch.bfloat16
    rows = []
    for name, B, Lq, Lk, D, H, kind, causal, rate in FWD_TIME_SHAPES:
        d = D // H
        gen = torch.Generator(device=dev).manual_seed(B + Lq + 3 * Lk)
        q = torch.randn((B, Lq, D), generator=gen, device=dev).to(dtype)
        k, v = torch.randn((B, Lk, 2 * D), generator=gen,
                           device=dev).to(dtype).split(D, dim=-1)
        mask_np = fwd_time_mask(np, kind, B, Lk, B + Lk)
        seg_mode = mask_np.dtype == np.int32
        dense = (np.zeros((B, Lk), np.int32) if seg_mode
                 else np.ones((B, Lk), np.float32))
        save = rate > 0
        n_bytes = (2 * B * Lq * D + 2 * B * Lk * D) * 2 + B * Lk * 4 + (
            B * H * Lq * Lk * 2 if save else 0)
        b_ms, by = bound_ms(n_bytes, 4 * B * H * Lq * Lk * d, "bfloat16")
        row = {"name": name, "shape": [B, Lq, Lk, D], "heads": H,
               "mask": kind, "causal": causal, "rate": rate,
               "bound_ms": b_ms, "bound_by": by,
               "skip_share": skip_share(np, mask_np, Lq, causal, seg_mode)}
        for key, m_np in (("ms", mask_np), ("dense_ms", dense)):
            mask = torch.from_numpy(m_np).to(dev)
            launch = (att.seg_attention_cuda if seg_mode else
                      functools.partial(att.valid_attention_cuda,
                                        causal=causal))
            try:
                row[key] = time_ms(torch, lambda: launch(
                    q, k, v, H, mask, rate, TRAIN_SEED, save))
            except (ValueError, RuntimeError) as e:
                row[key] = None
                row["refused"] = str(e)
        if library:
            m = torch.from_numpy(mask_np).to(dev)
            if seg_mode:
                sq = m[:, :Lq]
                allowed = (sq[:, :, None] == m[:, None, :]) & (
                    sq >= 0)[:, :, None]
            else:
                allowed = (m[:, None, :] > 0).expand(B, Lq, Lk)
            if causal:
                allowed = allowed & (torch.arange(Lk, device=dev)[None]
                                     <= torch.arange(Lq, device=dev)[:, None]
                                     + (Lk - Lq))
            bias = torch.where(allowed, 0.0, -1e4).to(dtype)[:, None]

            def heads(t, n):
                return t.reshape(B, n, H, d).transpose(1, 2)
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    heads(q, Lq), heads(k, Lk), heads(v, Lk),
                    attn_mask=bias, dropout_p=rate))
        rows.append(row)
        log("fwd", json.dumps(row))
        del q, k, v
        torch.cuda.empty_cache()
    bwd = []
    for name, B, H, Lq, Lk, d, causal in MHA_BWD_TIME_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(B + Lq + 3 * Lk)
        q, g = (torch.randn((B, H, Lq, d), generator=gen, device=dev).to(
            dtype) for _ in range(2))
        k, v = (torch.randn((B, H, Lk, d), generator=gen, device=dev).to(
            dtype) for _ in range(2))
        mask = torch.ones((B, Lk), device=dev)
        b_ms, by = mha_bwd_bound(B, H, Lq, Lk, d, q.element_size())
        row = {"name": name, "shape": [B, H, Lq, Lk, d], "causal": causal,
               "rate": TRAIN_RATE, "bound_ms": b_ms, "bound_by": by}
        try:
            row["ms"] = time_ms(torch, lambda: att.mha_attention_bwd_cuda(
                q, k, v, mask, g, TRAIN_RATE, TRAIN_SEED, causal))
        except (ValueError, RuntimeError) as e:
            row["ms"] = None
            row["refused"] = str(e)
        if library:
            hq, hk, hv = (t.detach().requires_grad_(True) for t in (q, k, v))
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(
                    hq, hk, hv, dropout_p=TRAIN_RATE, is_causal=causal)
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (hq, hk, hv), g, retain_graph=True))
            del out
        bwd.append(row)
        log("mha_bwd", json.dumps(row))
    return {"fwd": rows, "mha_bwd": bwd}


def _component_row(row, what):
    return {**row, "mode": f"components: {what}"
            + (f", {row['mode']}" if "mode" in row else "")}


def check_component_kernels(torch, cfg, ds, kernels):
    """Every kernel of the component path at that path's shapes: #2, #3,
    #4, #6 and #7's rows are added to ``kernels``; returns the rows of
    #5, #8 and #9 (#5 also at the TVC shapes: causal 31 -> 31 and the
    cross-attention ``ds.cap_len`` -> ``ds.seg_len``)."""
    import torch.nn.functional as F
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import dropout as drop
    from hero_tpu_torch.ops import layernorm as lnm
    dev = torch.device("cuda")
    D, H = cfg.f_config.hidden_size, cfg.f_config.num_attention_heads
    d = D // H
    gen = torch.Generator(device=dev).manual_seed(17)
    f_mask = torch.ones((COMP_ROWS, COMP_LEN), device=dev)
    c_mask = torch.ones((COMP_CLIPS, COMP_CLIP_LEN), device=dev)
    f_fwd, f_bwd = check_attention_train(torch, F, att, COMP_ROWS, COMP_LEN,
                                         D, H, f_mask, False)
    c_fwd, c_bwd = check_attention_train(torch, F, att, COMP_CLIPS,
                                         COMP_CLIP_LEN, D, H, c_mask, False)
    ln_shapes = (("f-encoder", COMP_ROWS * COMP_LEN, D),
                 ("c-encoder", COMP_CLIPS * COMP_CLIP_LEN, D),
                 ("unfused chain", COMP_ROWS, cfg.vfeat_dim))
    new = {
        "attention_valid": [
            _component_row(check_attention(
                torch, F, att, COMP_ROWS, COMP_LEN, D, H, f_mask, False,
                torch.bfloat16), "f-encoder"),
            _component_row(f_fwd, "f-encoder"),
            _component_row(c_fwd, "c-encoder")],
        "attention_bwd": [_component_row(f_bwd, "f-encoder"),
                          _component_row(c_bwd, "c-encoder")],
        "mha_attention": [_component_row(check_mha(
            torch, F, att, COMP_ROWS, H, COMP_LEN, COMP_LEN, d, "valid",
            False), "multi_head_attention")],
        "layer_norm": [_component_row(check_layer_norm(
            torch, F, lnm, n, w, torch.randn((n, w), generator=gen,
                                             device=dev).to(torch.bfloat16)),
            what) for what, n, w in ln_shapes],
        "layer_norm_bwd": [_component_row(check_layer_norm_bwd(
            torch, F, lnm, n, w), what) for what, n, w in ln_shapes]}
    for row in kernels:
        row["shapes"] += new.get(row["name"], [])
    mha = [check_mha_bwd(torch, F, att, COMP_ROWS, H, COMP_LEN, COMP_LEN, d,
                         False),
           check_mha_bwd(torch, F, att, 32, H, TVC_MAX_STEP + 1,
                         TVC_MAX_STEP + 1, d, True),
           check_mha_bwd(torch, F, att, 8, H, ds.cap_len, ds.seg_len, d,
                         False)]
    daln = [check_daln(torch, lnm, drop, n, w)
            for n, w in DALN_SHAPES + ((1024, 768),)]
    keys = ("shape", "dtype", "max_abs_err", "tol", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    return [
        {"name": "mha_attention_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/attention.cu",
         "replaces": "hero_tpu/ops/attention.py:138",
         "tpu_kernel": "_bwd_kernel", "counter": "mha_attention_bwd_cuda",
         "library_call": "autograd of F.scaled_dot_product_attention "
                         "(additive mask, dropout_p 0.1): its backward",
         **{k: mha[0][k] for k in keys}, "shapes": mha},
        {"name": "dropout_add_layer_norm", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/layernorm.cu",
         "replaces": "hero_tpu/ops/layernorm.py:175",
         "tpu_kernel": "_daln_fwd_kernel",
         "counter": "dropout_add_layer_norm_cuda",
         "library_call": None, "chain": "nn.dropout, add, layer_norm",
         **{k: daln[0][0][k] for k in keys + ("chain_ms", "rate0_ms")},
         "shapes": [f for f, _ in daln]},
        {"name": "dropout_add_layer_norm_bwd", "route": "cuda",
         "source": "hero_tpu_torch/ops/csrc/layernorm.cu",
         "replaces": "hero_tpu/ops/layernorm.py:195",
         "tpu_kernel": "_daln_bwd_kernel",
         "counter": "dropout_add_layer_norm_bwd_cuda",
         "library_call": None,
         "chain": "autograd of nn.dropout, add, layer_norm: its backward",
         **{k: daln[0][1][k] for k in keys + ("chain_ms", "rate0_ms")
            + SPLIT_KEYS if k in daln[0][1]},
         "shapes": [b for _, b in daln]}]


def make_components(torch, cfg, enc_params, dev, dtype, small):
    """``tools/component_bench.py``'s components on the port, each a
    (name, fn) whose call runs it once: the FFN matmul pair,
    ``layer_norm``, ``multi_head_attention`` and its plain version,
    ``dropout_add_layer_norm`` and the unfused chain, the 6-layer
    f-encoder and the 3-layer c-encoder, forward and forward+backward."""
    from hero_tpu_torch.models import nn, transformer
    from hero_tpu_torch.ops import attention as att
    from hero_tpu_torch.ops import layernorm as lnm
    gen = torch.Generator(device=dev).manual_seed(99)
    D, I = cfg.f_config.hidden_size, cfg.f_config.intermediate_size
    H = cfg.f_config.num_attention_heads
    d = D // H
    rows, L = (8, 12) if small else (COMP_ROWS, COMP_LEN)
    clips, Lc = (4, 16) if small else (COMP_CLIPS, COMP_CLIP_LEN)
    vfeat = cfg.vfeat_dim

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    x = rnd(rows * L, D)
    w1, w2 = rnd(D, I, scale=0.02), rnd(I, D, scale=0.02)
    lw = torch.ones(D, device=dev)
    lb = torch.zeros(D, device=dev)
    q = rnd(rows, H, L, d)
    m = torch.ones((rows, L), device=dev)
    xf, mf = rnd(rows, L, D), torch.ones((rows, L), device=dev)
    xc, mc = rnd(clips, Lc, D), torch.ones((clips, Lc), device=dev)
    f_enc = enc_params["f"]
    c_enc = enc_params["c"]

    def grad_of(fn, *args):
        leaves = [a.detach().requires_grad_(True) for a in args]

        def run():
            with torch.enable_grad():
                out = fn(*leaves)
                return torch.autograd.grad(out.float().sum(), leaves)
        return run

    def daln(n, width):
        y, r = rnd(n, width), rnd(n, width)
        w, b = torch.ones(width, device=dev), torch.zeros(width, device=dev)

        def fused(y, r, w, b):
            return lnm.dropout_add_layer_norm(y, r, w, b, TRAIN_RATE,
                                              TRAIN_SEED)

        def chain(y, r, w, b):
            return lnm.layer_norm(nn.dropout(y, TRAIN_RATE, TRAIN_SEED) + r,
                                  w, b)
        tag = f"({n},{width})"
        return [(f"dropout_add_layer_norm {tag} fwd",
                 lambda: fused(y, r, w, b)),
                (f"dropout_add_layer_norm {tag} fwd+bwd",
                 grad_of(fused, y, r, w, b)),
                (f"unfused chain {tag} fwd", lambda: chain(y, r, w, b)),
                (f"unfused chain {tag} fwd+bwd", grad_of(chain, y, r, w, b))]

    def enc(p, c, mask, train):
        return lambda t: transformer.encoder(
            p, t, c, kv_mask=mask, train=train, seed=3 if train else None,
            dtype=dtype)

    f_cfg, c_cfg = cfg.f_config, cfg.c_config
    comps = [
        ("ffn matmul pair", lambda: torch.matmul(torch.matmul(x, w1), w2)),
        ("layer_norm fwd", lambda: lnm.layer_norm(xf, lw, lb)),
        ("layer_norm fwd+bwd", grad_of(lambda t: lnm.layer_norm(t, lw, lb),
                                       xf)),
        ("multi_head_attention fwd",
         lambda: att.multi_head_attention(q, q, q, m)),
        ("multi_head_attention fwd+bwd",
         grad_of(lambda t: att.multi_head_attention(t, t, t, m), q)),
        ("mha_reference fwd", lambda: att.mha_reference(q, q, q, m)),
        ("mha_reference fwd+bwd",
         grad_of(lambda t: att.mha_reference(t, t, t, m), q)),
        *daln(rows * L, D), *daln(rows, vfeat),
        ("f_enc 6L fwd no-dropout",
         lambda: enc(f_enc, f_cfg, mf, False)(xf)),
        ("f_enc 6L fwd+bwd no-dropout",
         grad_of(enc(f_enc, f_cfg, mf, False), xf)),
        ("f_enc 6L fwd train(dropout)",
         lambda: enc(f_enc, f_cfg, mf, True)(xf)),
        ("f_enc 6L fwd+bwd train(dropout)",
         grad_of(enc(f_enc, f_cfg, mf, True), xf)),
        ("c_enc 3L fwd+bwd", grad_of(enc(c_enc, c_cfg, mc, False), xc)),
    ]
    shapes = {"ffn": [rows * L, D, I], "layer_norm": [rows, L, D],
              "attention": [rows, H, L, d], "daln": [[rows * L, D],
                                                     [rows, vfeat]],
              "f_enc": [rows, L, D], "c_enc": [clips, Lc, D]}
    return comps, shapes


ACT_ROWS, ACT_LEN = 8, 64          # the activation checks' f-encoder rows


def check_acts_and_poolers(torch, cfg, flat, dev_kernel, dev_plain):
    """In fp32, dropout off, on ``dev_kernel`` (#2, #3, #6, #7 on the
    card) against ``dev_plain`` (the CPU): the first f-encoder layer and
    the tied LM head under each ``hidden_act`` of ``nn.ACT2FN`` on
    (``ACT_ROWS``, ``ACT_LEN``) rows with pad keys (the logits, and for
    the smooth activations the input's gradient of a fixed random
    projection of them: relu's derivative jumps at 0, where fp32 sums in
    another order move a pre-activation across), and the f- and c-encoder
    poolers (``transformer.pooler``) on the same rows.  Each result
    within 2e-5 of its largest magnitude (at least 1): fp32 sums in other
    orders.  Returns {check: max |diff| / tol}."""
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.models import nn, transformer
    full = load_jax_params(flat, device="cpu")
    fe = full["v_encoder"]["f_encoder"]
    part = {"layer": fe["encoder"]["layers"][0], "lm_head": fe["lm_head"],
            "word_emb": fe["embeddings"]["word_emb"],
            "f_pooler": fe["pooler"],
            "c_pooler": full["v_encoder"]["c_encoder"]["pooler"]}
    del full
    D = cfg.f_config.hidden_size
    r = np.random.RandomState(61)
    x = torch.from_numpy(r.randn(ACT_ROWS, ACT_LEN, D).astype(np.float32))
    mask = torch.from_numpy((np.arange(ACT_LEN)[None] < r.randint(
        ACT_LEN // 2, ACT_LEN + 1, (ACT_ROWS, 1))).astype(np.float32))
    xc = torch.from_numpy(r.randn(ACT_ROWS, ACT_LEN,
                                  cfg.c_config.hidden_size)
                          .astype(np.float32))

    def run(dev, act):
        p = nn.tree_to(part, dev)
        fcfg = cfg.f_config.replace(hidden_act=act, hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0)
        xi = x.to(dev).requires_grad_(True)
        h = transformer.encoder_layer(p["layer"], xi, fcfg,
                                      kv_mask=mask.to(dev))
        logits = transformer.lm_head(p["lm_head"], p["word_emb"], h, fcfg)
        w = torch.Generator(device="cpu").manual_seed(62)
        proj = torch.randn(logits.shape[-1], generator=w).to(dev)
        out = {"logits": logits.detach()}
        if act != "relu":
            (out["grad_x"],) = torch.autograd.grad((logits @ proj).sum(),
                                                   xi)
        if act == "gelu":
            out["f_pooler"] = transformer.pooler(p["f_pooler"], x.to(dev))
            out["c_pooler"] = transformer.pooler(p["c_pooler"], xc.to(dev))
        return {k: v.detach().float().cpu() for k, v in out.items()}

    rec = {}
    for act in nn.ACT2FN:
        got, want = run(dev_kernel, act), run(dev_plain, act)
        for k, w in want.items():
            tol = 2e-5 * max(1.0, float(w.abs().max()))
            err = float((got[k] - w).abs().max())
            rec[f"{act} {k}" if "pooler" not in k else k] = err / tol
            if not err <= tol:
                raise AssertionError(f"hidden_act {act}, {k}: max |diff| "
                                     f"{err} > {tol}")
    return rec


def components_phase(torch, cfg, params, dev, dtype, sync, rehearse):
    """Drive every component once with the launch counters read from 0
    around (the component path), then time each with ``time_ms``."""
    enc_params = {"f": params["v_encoder"]["f_encoder"]["encoder"],
                  "c": params["v_encoder"]["c_encoder"]["encoder"]}
    comps, shapes = make_components(torch, cfg, enc_params, dev, dtype,
                                    rehearse)
    reset_counts()
    for _, fn in comps:
        fn()
    sync()
    launches = read_counts()
    rec = {"shapes": shapes, "main_path_launches": launches}
    if not rehearse:
        times = {name: time_ms(torch, fn) for name, fn in comps}
        n_ffn = shapes["ffn"]
        rec["ms"] = times
        rec["ffn_tflops"] = (4 * n_ffn[0] * n_ffn[1] * n_ffn[2]
                             / times["ffn matmul pair"] / 1e9)
    return rec


def gpu_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json-out", default=None,
                    help="also write the full record (JSON) to this file")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at a tiny size with the plain "
                         "versions; prints no result line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one phase-1 batch, one query batch, "
                         "one fit-bucket train step, one greedy TVC "
                         "batch, one TVC train step, one optimizer step "
                         "of each pretraining task and one packed and "
                         "one unpacked pass over the queries with "
                         "torch.profiler and record device time by kernel "
                         "class (in the --json-out record)")
    ap.add_argument("--times", nargs="+", metavar=("KERNEL", "ROOT"),
                    help="only time KERNEL of the hero_tpu_torch package "
                         "under ROOT (default: this checkout, with the "
                         "library call beside it) and print one JSON line: "
                         "daln (#8 and #9, bf16, rates 0 and 0.1), bwd3 (#3, "
                         "bf16 and fp32, dropout 0.1, BWD3_TIME_SHAPES) or "
                         "fwd (#1/#2, bf16, FWD_TIME_SHAPES, the modelled "
                         "masks and every key valid; #5, bf16, dropout 0.1, "
                         "MHA_BWD_TIME_SHAPES) or steps (train_examples_per_s "
                         "and tvc_train_captions_per_s as the full run "
                         "measures them); an A/B of two checkouts on one "
                         "card, run in turns")
    args = ap.parse_args(argv)
    if args.times and (args.times[0] not in ("daln", "bwd3", "fwd", "steps")
                       or len(args.times) > 2):
        ap.error("--times takes daln, bwd3, fwd or steps and at most one "
                 "ROOT")

    import torch
    rehearse = args.rehearse
    if not rehearse and not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this check "
            "needs one CUDA card")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if args.times:
        what = args.times[0]
        root = os.path.abspath(args.times[1] if len(args.times) > 1 else here)
        sys.path.insert(0, root)
        from hero_tpu_torch.ops import attention as att
        from hero_tpu_torch.ops import layernorm as lnm
        library = root == here
        rows = {"daln": lambda: {"daln": daln_ab(torch, lnm)},
                "bwd3": lambda: {"bwd3": bwd3_times(torch, att, library)},
                "fwd": lambda: fwd_times(torch, att, library),
                "steps": lambda: {"steps": step_rates(torch)}}[what]()
        print(json.dumps({"root": root, "kernel": what,
                          "package": os.path.dirname(att.__file__), **rows,
                          "card": gpu_identity()}))
        return 0
    sys.path.insert(0, here)
    from hero_tpu_torch.config.model_config import (flagship_config,
                                                    flagship_tvc_config)
    from hero_tpu_torch.convert.from_jax import load_jax_params
    from hero_tpu_torch.data.synthetic import TV_PACKED
    from hero_tpu_torch.evaluation.vcmr_eval import (VcmrEvalOpts,
                                                     embed_video_corpus,
                                                     make_query_scorer,
                                                     validate_full_vcmr)
    from hero_tpu_torch.models.pretrain import VsmConfig, init_flat_params
    from hero_tpu_torch.models.tvc import init_flat_tvc_params
    from hero_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    record = {"phase_end_s": {}}

    def mark(phase):
        record["phase_end_s"][phase] = time.perf_counter() - t_start
    if rehearse:
        dev, dtype = "cpu", torch.float32
        cfg = rehearsal_config()
        n_videos, video_bs, n_queries, query_bs = 20, 10, 32, 16
    else:
        dev, dtype = "cuda", torch.bfloat16
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("fp32 matmuls must not run in TF32")
        record["versions"] = {"python": sys.version.split()[0],
                              "torch": torch.__version__,
                              "cuda": torch.version.cuda}
        # the kernels build (one nvcc a source) while the corpus, the
        # queries and the weights are made on the host
        t_build = time.perf_counter()

        def build():
            cuda_build.build()
            return time.perf_counter() - t_build
        build_pool = concurrent.futures.ThreadPoolExecutor(1)
        built = build_pool.submit(build)
        cfg = flagship_config()
        n_videos, video_bs = N_VIDEOS, VIDEO_BS
        n_queries, query_bs = N_QUERIES, QUERY_BS

    vsm = VsmConfig(lw_neg_ctx=8.0, lw_neg_q=8.0, lw_st_ed=0.01)
    opts = VcmrEvalOpts(max_vcmr_video=100, min_pred_l=2, max_pred_l=16,
                        max_before_nms=200, vfeat_interval=1.5,
                        max_clip_len=100)
    shape = dataclasses.replace(TV_PACKED, batch=video_bs, n_queries=1,
                                vfeat_dim=cfg.vfeat_dim)
    t0 = time.perf_counter()
    batches, dropped = make_corpus(n_videos, video_bs, shape)
    video_ids = [f"video{i:05d}" for i in range(n_videos)]
    video2idx = {v: i for i, v in enumerate(video_ids)}
    query_batches, query_data = make_queries(
        n_queries, query_bs, QUERY_SLOTS, 50265, video_ids,
        opts.vfeat_interval)
    flat = init_flat_params(cfg, vsm, seed=0)
    params = load_jax_params(flat, device=dev, heads=False)
    record["setup_s"] = time.perf_counter() - t0
    record["subs_dropped_frac"] = dropped
    log(f"setup (corpus, queries, weights) {record['setup_s']:.1f} s")
    if not rehearse:
        record["build_s"] = built.result()
        build_pool.shutdown()
        log(f"kernels built in {record['build_s']:.1f} s, beside the setup")

    if not rehearse:
        from hero_tpu_torch.evaluation.vcmr_eval import pack_query_arrays
        ids, lens, _, _ = packed_layout(query_batches)
        p_seg = pack_query_arrays(ids, lens, PACK_SEGS, PACK_ROWS)[1]
        record["kernels"] = check_kernels(
            torch, batches[0], query_batches[0]["query_attn_masks"],
            (p_seg[:PACK_ROWS], p_seg[-PACK_ROWS:]), cfg)
        log("kernel checks passed")

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    # phase 1 and phase 2 alone, timed, with per-batch launch counts
    embed_video_corpus(params, cfg, batches[:1], dtype, dev)     # warm-up
    sync()
    reset_counts()
    embed_video_corpus(params, cfg, batches[:1], dtype, dev)
    sync()
    per_video_batch = read_counts()
    p1_runs = []
    for _ in range(PHASE_RUNS):
        frame_embs = frame_masks = None
        t0 = time.perf_counter()
        frame_embs, frame_masks = embed_video_corpus(params, cfg, batches,
                                                     dtype, dev)
        sync()
        p1_runs.append(time.perf_counter() - t0)
    scorer, _ = make_query_scorer(params, cfg, vsm, opts, frame_embs,
                                  frame_masks, dtype)
    qb0 = query_batches[0]

    def run_query_batch(qb):
        out = scorer(torch.from_numpy(qb["query_input_ids"]),
                     torch.from_numpy(qb["query_attn_masks"]))
        return [x.cpu() for x in out]

    run_query_batch(qb0)                                         # warm-up
    reset_counts()
    run_query_batch(qb0)
    per_query_batch = read_counts()
    p2_runs = []
    for _ in range(PHASE_RUNS):
        t0 = time.perf_counter()
        for qb in query_batches:
            run_query_batch(qb)
        sync()
        p2_runs.append(time.perf_counter() - t0)
    if args.profile and not rehearse:
        record["profile"] = {
            "phase1_batch": profile_breakdown(
                torch, lambda: embed_video_corpus(params, cfg, batches[:1],
                                                  dtype, dev)),
            "phase2_batch": profile_breakdown(
                torch, lambda: run_query_batch(qb0))}
    del frame_embs, frame_masks, scorer
    t_p1, t_p2 = float(np.median(p1_runs)), float(np.median(p2_runs))
    record["phases"] = {
        "phase1": {"videos": n_videos, "batch": video_bs, "wall_s": t_p1,
                   "wall_s_runs": p1_runs, "videos_per_s": n_videos / t_p1,
                   "launches_per_batch": per_video_batch},
        "phase2": {"queries": n_queries, "batch": query_bs, "wall_s": t_p2,
                   "wall_s_runs": p2_runs, "queries_per_s": n_queries / t_p2,
                   "launches_per_batch": per_query_batch}}

    # the serving path end to end, counters from 0
    reset_counts()
    t0 = time.perf_counter()
    val_log, submission, metrics = validate_full_vcmr(
        params, cfg, vsm, opts, batches, query_batches, video_ids,
        video2idx, query_data, dtype=dtype, device=dev)
    sync()
    record["main_path_wall_s"] = time.perf_counter() - t0
    launches = read_counts()
    record["main_path_launches"] = launches
    check_submission(submission, metrics, n_queries, n_videos, opts)
    record["metrics"] = {t: metrics[t] for t in ("VCMR", "SVMR", "VR")}
    serving = ("seg_attention_cuda", "valid_attention_cuda",
               "layer_norm_cuda")
    if not rehearse and min(launches[k] for k in serving) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")

    small = dataclasses.replace(shape, batch=10)
    small_batches, _ = make_corpus(20, 10, small, seed=11)
    small_q, small_qd = make_queries(16, 16, QUERY_SLOTS, 50265,
                                     [f"s{i}" for i in range(20)], 1.5,
                                     seed=12)
    record["integration_fp32"] = integration_check(
        torch, cfg, flat, vsm, opts, small_batches, small_q[0],
        "cpu" if rehearse else "cuda", "cpu")
    log(f"serving phases done at {time.perf_counter() - t_start:.1f} s")
    mark("serving")

    # the VSM train step at bench.py's layout
    t0 = time.perf_counter()
    train_bs = 4 if rehearse else TRAIN_BS
    b_fit, b_over, p_over, t_dropped, fit_videos = make_train_buckets(
        cfg.vfeat_dim, train_bs, 64 if rehearse else TRAIN_SAMPLED)
    record["train_setup_s"] = time.perf_counter() - t0
    if not rehearse:
        record["kernels"] += check_train_kernels(torch, b_fit, b_over, cfg,
                                                 record["kernels"])
        log("training kernel checks passed")
        from hero_tpu_torch.ops import attention as att
        from hero_tpu_torch.ops import dropout as drop
        record["edge_checks"] = check_packed_edges(torch, att, drop)
        log(f"{record['edge_checks']['n_cases']} tile-edge checks of the "
            f"packed attention kernels passed")
    steps = ((1, 2, 1, 1) if rehearse
             else (WARMUP_STEPS, FIT_STEPS, OVER_STEPS, TRAIN_RUNS))
    train = train_throughput(torch, cfg, flat, b_fit, b_over, p_over, dev,
                             dtype, steps, sync,
                             args.profile and not rehearse)
    train["subs_dropped_frac"] = t_dropped
    train_launches = train["main_path_launches"]
    if not rehearse and min(train_launches[k] for k in TRAIN_KERNELS) == 0:
        raise AssertionError(f"a kernel of the train step was never "
                             f"launched: {train_launches}")
    record["train"] = train
    log(f"train step: {train['train_examples_per_s']:.1f} examples/s")
    record["learning_signal"] = learning_signal(
        torch, cfg, flat, b_fit, dev, dtype, SIGNAL_STEPS)
    record["train_parity_fp32"] = train_parity(
        torch, cfg, fit_videos, "cpu" if rehearse else "cuda", "cpu")
    record["train_bf16_step"] = vsm_bf16_step(torch, cfg, flat, b_fit,
                                              b_over, dev)
    log(f"train phases done at {time.perf_counter() - t_start:.1f} s")
    mark("train")

    # TVC caption serving at config/hero_tvc.json's model
    t0 = time.perf_counter()
    tcfg = (cfg.replace(d_config=cfg.f_config) if rehearse
            else flagship_tvc_config())
    tvc_flat = init_flat_tvc_params(tcfg, seed=0)
    store, clips, tvc_dropped = make_tvc_data(
        5 if rehearse else TVC_VIDEOS, tcfg.vfeat_dim)
    record["tvc_setup_s"] = time.perf_counter() - t0
    if not rehearse:
        record["kernels"].append(check_tvc_kernels(torch, tcfg,
                                                   record["kernels"]))
        from hero_tpu_torch.ops import attention as att
        from hero_tpu_torch.ops import dropout as drop
        record["mha_edge_checks"] = check_mha_edges(torch, att, drop)
        log(f"TVC kernel checks and {record['mha_edge_checks']['n_cases']} "
            f"tile-edge checks of the head-major kernels passed")
    tvc = tvc_phase(torch, tcfg, tvc_flat, store, clips, dev, dtype, sync,
                    rehearse, args.profile and not rehearse)
    tvc["subs_dropped_frac"] = tvc_dropped
    tvc_launches = tvc["main_path_launches"]
    if not rehearse and min(tvc_launches[k] for k in (
            "seg_attention_cuda", "valid_attention_cuda",
            "mha_attention_cuda", "layer_norm_cuda")) == 0:
        raise AssertionError(f"a kernel of TVC serving was never "
                             f"launched: {tvc_launches}")
    record["tvc"] = tvc
    mark("tvc")
    log(f"TVC: {tvc['tvc_captions_per_s']:.1f} captions/s greedy, "
        f"{tvc['beam_captions_per_s']:.1f} beam {TVC_BEAM}")

    # TVC training at the same model, on the same videos
    tvc_ds = tvc_train_data(store, tcfg.f_config.vocab_size)
    if not rehearse:
        check_tvc_train_kernels(torch, tcfg, tvc_ds, record["kernels"])
        log("TVC train kernel checks passed")
    tvc_train = tvc_train_phase(torch, tcfg, tvc_flat, tvc_ds, dev, dtype,
                                sync, rehearse, args.profile and not rehearse)
    tt_launches = tvc_train["main_path_launches"]
    if not rehearse and min(tt_launches[k] for k in TRAIN_KERNELS) == 0:
        raise AssertionError(f"a kernel of the TVC train step was never "
                             f"launched: {tt_launches}")
    record["tvc_train"] = tvc_train
    mark("tvc_train")
    log(f"TVC train: {tvc_train['tvc_train_captions_per_s']:.1f} "
        f"captions/s")

    # pretraining: config/pretrain-tv.json's recipe through run_pretrain
    pre, pre_db = pretrain_phase(torch, here, cfg, dev, dtype, sync,
                                 rehearse, args.profile and not rehearse,
                                 record["kernels"] if not rehearse else None)
    pre_launches = pre["main_path_launches"]
    if not rehearse and min(pre_launches[k] for k in TRAIN_KERNELS) == 0:
        raise AssertionError(f"a kernel of the pretraining step was never "
                             f"launched: {pre_launches}")
    record["pretrain"] = pre
    mark("pretrain")
    log(f"pretrain: {pre['pretrain_examples_per_s']:.1f} videos/s, done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # pretraining as a program: drivers/pretrain.main from stores on disk;
    # then TVC finetuning and captioning as programs from those stores and
    # pretrain_main's checkpoint
    main_root = tempfile.mkdtemp(prefix="pretrain_main_")
    try:
        pmain, pmain_launches = pretrain_main_phase(
            torch, here, cfg, pre_db, dev, sync, rehearse, main_root)
        if not rehearse and min(pmain_launches[k]
                                for k in TRAIN_KERNELS) == 0:
            raise AssertionError(f"a kernel of pretraining's main was never "
                                 f"launched: {pmain_launches}")
        record["pretrain_main"] = pmain
        mark("pretrain_main")
        log(f"pretrain main: {pmain['main_examples_per_s']:.1f} videos/s "
            f"from disk, resumed run bit-equal, done at "
            f"{time.perf_counter() - t_start:.1f} s")
        tprog, tprog_train, tprog_inf = tvc_program_phase(
            torch, here, tcfg, main_root, pre_db, dev, sync, rehearse,
            record["kernels"] if not rehearse else None,
            tvc_train["tvc_train_captions_per_s"])
        for counts, needed in ((tprog_train, PROGRAM_TVC_TRAIN_KERNELS),
                               (tprog_inf, PROGRAM_TVC_INF_KERNELS)):
            if not rehearse and min(counts[k] for k in needed) == 0:
                raise AssertionError(f"a kernel of the TVC programs was "
                                     f"never launched: {counts}")
        record["tvc_program"] = tprog
        mark("tvc_program")
        log(f"tvc_program: {tprog['caption_rows_per_s']:.1f} caption "
            f"rows/s from disk, resumed run bit-equal, done at "
            f"{time.perf_counter() - t_start:.1f} s")
        vprog, vprog_paths = vcmr_program_phase(
            torch, here, cfg, main_root, pre_db, dev, sync, rehearse,
            record["kernels"] if not rehearse else None)
        record["vcmr_program"] = vprog
        mark("vcmr_program")
        log(f"vcmr_program: {vprog['tvr_queries_per_s']:.1f} TVR and "
            f"{vprog['vr_queries_per_s']:.1f} VR queries/s from disk, .pt "
            f"loaded in {vprog['pt_load_ms']:.0f} ms, resumed run "
            f"bit-equal, done at {time.perf_counter() - t_start:.1f} s")
        # VideoQA and VIOLIN from the .pt vcmr_program wrote
        qprog, qprog_paths = qa_program_phase(
            torch, here, cfg, main_root, pre_db, dev, sync, rehearse,
            record["kernels"] if not rehearse else None)
        record["qa_program"] = qprog
        mark("qa_program")
        log(f"qa_program: {qprog['tvqa_questions_per_s']:.1f} TVQA "
            f"questions/s and {qprog['violin_pairs_per_s']:.1f} VIOLIN "
            f"pairs/s from disk, resumed run bit-equal, done at "
            f"{time.perf_counter() - t_start:.1f} s")
        # the VSM step, train_vcmr and eval_vcmr on several ranks
        dp, dp_paths = dp_phase(torch, here, cfg, main_root, pre_db, dev,
                                sync, rehearse)
        if not rehearse:
            dp["mode_kernels"] = check_dp_kernels(torch, cfg, b_fit,
                                                  record["kernels"])
    finally:
        shutil.rmtree(main_root, ignore_errors=True)
    for name, counts in {**vprog_paths, **qprog_paths}.items():
        needed = (PROGRAM_VCMR_EVAL_KERNELS if name.endswith("_eval")
                  else PROGRAM_VCMR_TRAIN_KERNELS)
        if not rehearse and min(counts[k] for k in needed) == 0:
            raise AssertionError(f"a kernel of {name} was never launched: "
                                 f"{counts}")
    for name, counts in dp_paths.items():
        needed = (PROGRAM_VCMR_EVAL_KERNELS if "eval" in name
                  else TRAIN_KERNELS if name.startswith("dp_step")
                  else PROGRAM_VCMR_TRAIN_KERNELS)
        if not rehearse and min(counts[k] for k in needed) == 0:
            raise AssertionError(f"a kernel of {name} was never launched: "
                                 f"{counts}")
    record["dp"] = dp
    mark("dp")
    log(f"dp: {DP_WORLD} gloo ranks on one card {dp['gloo']['step_ms']:.1f} "
        f"ms a step, one process {dp['gloo']['one_process_step_ms']:.1f} "
        f"ms, resumed run bit-equal, done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # serving in full: packed queries, the chunked corpus, the program
    full, full_paths = serving_full_phase(
        torch, here, cfg, flat, params, vsm, opts, batches, query_batches,
        video_ids, video2idx, query_data, (small_batches, small_q, small_qd),
        pre_db, dev, dtype, sync, rehearse, args.profile and not rehearse,
        record)
    del pre_db
    for name, counts in full_paths.items():
        if not rehearse and min(counts[k] for k in serving) == 0:
            raise AssertionError(f"a kernel of {name} was never launched: "
                                 f"{counts}")
    record["serving_full"] = full
    mark("serving_full")

    # data preparation: raw files through the port's prepro entry points,
    # the stores, the suggested bucket, then VCMR serving over them
    prep, prep_launches = prepro_phase(
        torch, here, cfg, flat, params, vsm, opts, dev, dtype, sync,
        rehearse, record["kernels"] if not rehearse else None)
    if not rehearse and min(prep_launches[k] for k in serving) == 0:
        raise AssertionError(f"a kernel of the prepro path was never "
                             f"launched: {prep_launches}")
    record["prepro"] = prep
    mark("prepro")
    log(f"prepro: {prep['videos']} videos through the entry points "
        f"{prep['entry_point_wall_s']} s, bucket {prep['bucket']}, phase "
        f"{prep['phase_s']:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # the components of tools/component_bench.py
    if not rehearse:
        from hero_tpu_torch.ops import layernorm as lnm
        record["ln_edge_checks"] = check_ln_edges(torch, lnm)
        log(f"{record['ln_edge_checks']['n_cases']} edge checks of the "
            f"LayerNorm kernels passed")
        from hero_tpu_torch.ops import dropout as drop
        record["daln_edge_checks"] = check_daln_edges(torch, lnm, drop)
        log(f"{record['daln_edge_checks']['n_cases']} edge checks of the "
            f"fused dropout-add-LayerNorm kernels passed")
        record["kernels"] += check_component_kernels(torch, cfg, tvc_ds,
                                                     record["kernels"])
        log("component kernel checks passed")
    record["act_checks"] = check_acts_and_poolers(
        torch, cfg, flat, dev, "cpu")
    log(f"{len(record['act_checks'])} activation and pooler checks "
        f"passed, worst {max(record['act_checks'].values()):.3f} of tol")
    comps = components_phase(torch, cfg, params, dev, dtype, sync, rehearse)
    comp_launches = comps["main_path_launches"]
    if not rehearse and min(comp_launches[k] for k in COMPONENT_KERNELS) == 0:
        raise AssertionError(f"a kernel of the components was never "
                             f"launched: {comp_launches}")
    record["components"] = comps
    mark("components")
    if not rehearse:
        record["splits_traced_again"] = resolve_pending_splits(record, here)
        log(f"{record['splits_traced_again']} LayerNorm rows traced again "
            f"in a fresh process")
    record["total_s"] = time.perf_counter() - t_start

    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"phases": record["phases"],
                      "main_path_wall_s": record["main_path_wall_s"],
                      "integration_fp32": record["integration_fp32"]}))
    print(json.dumps({
        "train_examples_per_s": train["train_examples_per_s"],
        "runs_examples_per_s": train["runs_examples_per_s"],
        "layout": "packed 4x(16f+88t) + overflow 4x(24f+120t), "
                  f"{train_bs} videos a step",
        "overflow_video_frac": p_over,
        "launches_per_fit_step": train["launches_per_fit_step"],
        "launches_per_overflow_step": train["launches_per_overflow_step"],
        "learning_signal_losses": [record["learning_signal"]["losses"][i]
                                   for i in (0, -1)],
        "train_parity_fp32": {k: record["train_parity_fp32"][k] for k in (
            "loss_rel_err", "worst_grad_err_over_tol",
            "worst_param_err_over_tol", "ok")},
        "bf16_step": record["train_bf16_step"]}))
    print(json.dumps({
        "tvc_captions_per_s": tvc["tvc_captions_per_s"],
        "runs_captions_per_s": tvc["runs_captions_per_s"],
        "clips": tvc["clips"], "rows_per_batch": tvc["rows_per_batch"],
        "max_gen_step": TVC_MAX_STEP,
        "beam_captions_per_s": tvc["beam_captions_per_s"],
        "beam": TVC_BEAM, "beam_clips": tvc["beam_clips"],
        "launches": tvc_launches, "fp32": tvc["fp32"],
        "bf16_decode": tvc["bf16_decode"]}))
    print(json.dumps({
        "tvc_train_captions_per_s": tvc_train["tvc_train_captions_per_s"],
        "runs_captions_per_s": tvc_train["runs_captions_per_s"],
        "layout": tvc_train["layout"],
        "steps_per_run": tvc_train["steps_per_run"],
        "launches_per_step": tvc_train["launches_per_step"],
        "learning_signal_losses": [tvc_train["learning_signal"]["losses"][i]
                                   for i in (0, -1)],
        "fp32": {k: tvc_train["fp32"][k] for k in (
            "loss_rel_err", "worst_grad_err_over_tol",
            "worst_param_err_over_tol", "ok")},
        "bf16_step": tvc_train["bf16_step"]}))
    print(json.dumps({"pretrain": {
        "pretrain_examples_per_s": pre["pretrain_examples_per_s"],
        "runs_examples_per_s": pre["runs_examples_per_s"],
        "videos_per_step": pre["videos_per_step"],
        "step_ms": pre["step_ms"],
        "launches_per_step": pre["launches_per_step"],
        "task_sequence": pre["task_sequence"],
        "warmup_steps": pre["warmup_steps"],
        "learning_signal_losses": {
            t: [v[0], v[-1]]
            for t, v in pre["learning_signal"]["losses"].items()},
        "fp32": {t: {k: r[k] for k in (
            "loss_rel_err", "worst_grad_err_over_tol",
            "worst_param_err_over_tol", "ok")}
            for t, r in pre["fp32"].items()},
        "bf16_step": pre["bf16_step"] and {
            t: {"worst_grad_err_over_tol": r["worst_grad_err_over_tol"],
                "loss_kernel_vs_plain": r["loss_kernel_vs_plain"],
                "loss_tol": r["loss_tol"]}
            for t, r in pre["bf16_step"].items()},
        "remat_bit_equal": {t: r["loss_equal"] and not r["grads_differing"]
                            for t, r in pre["remat"]["bit_equal"].items()},
        "remat_cost": pre["remat"]["cost_full_micro_batch"]}}))
    saves = [dict(r, run=run, kind=kind)
             for run in ("run_a", "run_b_interrupted", "run_b_resumed")
             for kind in ("model", "restore")
             for r in pmain[f"{run}_records"][kind]]
    print(json.dumps({"pretrain_main": {
        "main_examples_per_s": pmain["main_examples_per_s"],
        "pretrain_examples_per_s": pre["pretrain_examples_per_s"],
        "videos_per_step": pmain["videos_per_step"],
        "windows": pmain["windows"], "window_ms": pmain["window_ms"],
        "saves": saves,
        "restore_ms": pmain["run_b_resumed_records"]["restore_ms"],
        "readers": pmain["readers"], "items_equal": pmain["items_equal"],
        "resume_bit_equal": pmain["resume_bit_equal"],
        "checkpoint_bridged_equal": pmain["checkpoint_bridged_equal"],
        "max_abs_from_init": pmain["max_abs_from_init"],
        "free_bytes_before": pmain["free_bytes_before"],
        "free_bytes_after": pmain["free_bytes_after"],
        "store_bytes": pmain["store_bytes"],
        "launches": pmain_launches, "stage_s": pmain["stage_s"]}}))
    print(json.dumps({"tvc_program": {
        k: tprog[k] for k in (
            "caption_rows_per_s", "tvc_train_captions_per_s",
            "caption_rows_per_step", "window_ms", "f_encoder_rows",
            "videos", "clips", "captions", "steps", "losses", "saves",
            "restore_ms", "inf_tvc_wall_s", "fp32_captions_per_s",
            "bf16_captions_per_s", "fp32_main_s", "bf16_main_s",
            "inf_tokens_mean", "inf_equals_validation",
            "checkpoint_bridged_equal",
            "fp32_decode_s", "bf16_decode_s", "scores", "inf_scores",
            "resume_bit_equal", "submission_equal", "target_clip_records",
            "target_clip_beam3_records", "run_a_s", "run_b_s", "stage_s",
            "free_bytes_before")}
        | {"launches_train": tprog_train, "launches_inf": tprog_inf}}))
    print(json.dumps({"vcmr_program": {
        k: vprog[k] for k in (
            "tvr_queries_per_s", "vr_queries_per_s", "tvr_window_ms",
            "vr_window_ms", "tvr", "vr", "tvr_losses", "vr_losses",
            "pt_bytes", "pt_write_s", "pt_load_ms", "npz_load_ms",
            "pt_load_equal", "pt_padded_rows", "model_vocab_padded",
            "tvr_rows", "vr_rows",
            "saves", "vr_saves", "restore_ms", "resume_bit_equal",
            "resume_results_equal", "eval_vcmr_wall_s", "eval_vcmr_equal",
            "eval_vcmr_max_rel_score_diff", "eval_vr_s",
            "eval_vr_max_rel_score_diff", "vr_metrics", "run_a_s",
            "run_b_s", "vr_run_s", "stage_s", "free_bytes_before")
        if k in vprog} | {"launches": {
            name: {k: c[k] for k in list(c)[:7]}
            for name, c in vprog_paths.items()}}}))
    print(json.dumps({"qa_program": {
        k: qprog[k] for k in (
            "tvqa_questions_per_s", "violin_pairs_per_s", "tvqa_window_ms",
            "violin_window_ms", "tvqa", "violin", "questions",
            "statement_pairs", "tvqa_losses", "violin_losses",
            "f_encoder_rows", "c_encoder_rows", "packed_rows", "ln_rows",
            "model_vocab_padded", "violin_model_vocab_padded", "saves",
            "violin_saves", "restore_ms", "resume_bit_equal",
            "resume_validation_equal", "tvqa_validation",
            "eval_videoqa_wall_s", "eval_videoqa_equal", "eval_videoqa_log",
            "eval_violin_s", "eval_violin_equal", "eval_violin_log",
            "run_a_s", "run_b_s", "violin_run_s", "stage_s",
            "free_bytes_before")
        if k in qprog}
        | {"fp32": {t: {k: r[k] for k in (
            "loss_rel_err", "worst_grad_err_over_tol",
            "worst_param_err_over_tol", "ok")}
            for t, r in qprog["fp32"].items()},
           "bf16_step": {t: {k: r[k] for k in (
               "loss", "loss_kernel_vs_plain", "loss_tol",
               "worst_grad_err_over_tol")}
               for t, r in qprog["bf16_step"].items()},
           "launches": {name: {k: c[k] for k in list(c)[:7]}
                        for name, c in qprog_paths.items()}}}))
    print(json.dumps({"dp": {k: dp[k] for k in (
        "card", "note", "gloo", "nccl", "parity", "dropout", "modes", "eval",
        "stopped_at", "resume_bit_equal", "run_c", "tvr", "tvr_losses",
        "steps_world_s", "run_b_s", "stage_s", "mode_kernels") if k in dp}
        | {"launches_by_rank": {name: {k: c[k] for k in list(c)[:7]}
                                for name, c in dp_paths.items()}}}))
    print(json.dumps({"serving_full": {
        "packed": full["packed"], "packed_fp32": full["packed_fp32"],
        "chunked": full["chunked"], "chunked_fp32": full["chunked_fp32"],
        "program": {k: v for k, v in full["program"].items()
                    if k != "metrics"},
        "phase_s": full["phase_s"]}}))
    print(json.dumps({"prepro": {k: prep[k] for k in (
        "videos", "frames", "queries", "entry_point_wall_s", "store_bytes",
        "checks", "bucket", "downstream_lens", "videos_in_bucket",
        "f_encoder_rows", "serve_wall_s", "metrics", "integration_fp32",
        "launches", "raw_s", "setup_s", "phase_s")}}))
    print(json.dumps({"components": {
        "ms": comps.get("ms"), "ffn_tflops": comps.get("ffn_tflops"),
        "shapes": comps["shapes"], "launches": comp_launches,
        "act_checks_over_tol": record["act_checks"]}}))
    if rehearse:
        log(f"rehearsal passed in {record['total_s']:.1f} s")
        return 0
    paths = {"serving": launches, "train": train_launches,
             "tvc": tvc_launches, "tvc_train": tt_launches,
             "pretrain": pre_launches, "pretrain_main": pmain_launches,
             "tvc_program": tprog_train, "tvc_program_inf": tprog_inf,
             **vprog_paths, **qprog_paths, **dp_paths, **full_paths,
             "prepro": prep_launches, "components": comp_launches}
    kernels = [{k: row[k] for k in (
        "name", "route", "source", "replaces", "tpu_kernel", "shape", "dtype",
        "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
        | {"launches": sum(p[row["counter"]] for p in paths.values()),
           "launches_by_path": {name: p[row["counter"]]
                                for name, p in paths.items()},
           "shapes": [{k: sh[k] for k in (
               "shape", "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")} | {k: sh[k] for k in (
                   "mode",) + DALN_KEYS + SPLIT_KEYS if k in sh}
               for sh in row["shapes"]]}
        | {k: row[k] for k in DALN_KEYS + SPLIT_KEYS if k in row}
        for row in record["kernels"]]
    idle = [row["name"] for row in kernels if row["launches"] == 0]
    if idle or len(kernels) != 9:
        raise AssertionError(f"{len(kernels)} kernel rows, never launched: "
                             f"{idle}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
