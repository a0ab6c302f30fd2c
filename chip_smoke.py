#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``unicore_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed phase raises, so the exit
code is non-zero:

1. build — compile every kernel of the serve and training paths from
   ``unicore_tpu_torch/csrc/`` with ``nvcc`` for sm_90a (one process per
   source — paged attention, the fp32 flash kernels, the bf16 and fp16
   flash forward, the bf16 and fp16 flash backward, softmax_dropout,
   rounding, ema — started together), and beside them the data tier's
   record reader (``record_reader.c``, no kernel) with the host C
   compiler.
2. kernel — the paged-attention kernel vs its plain PyTorch version at
   the serve path's shapes (B=16, H=12, D=64, page size 16, fp32): pure
   decode (T=1), full prefill chunks (T=32) and a mixed batch with -1
   tail positions and an inactive row, random page permutations.  Every
   output finite, max |kernel - plain| <= 1e-4 at every position, two
   kernel calls bit for bit.  Times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` over the gathered K/V (a yardstick
   the port never calls) beside the least time the card could take and
   its share of it, with the split plan used, the kernel's time at 1, 2,
   4 and 8 splits (each held to plain too) and the recorded time of the
   kernel this design replaced.
3. serve — a seeded random ``transformer_lm_base`` (12 layers, width 768,
   FFN 3072, 12 heads, vocab 30522, rotary, context 512) behind
   ``ServeEngine(num_pages=512, page_size=16, max_batch=16)``: 16 greedy
   requests with 16-448-token prompts, then 4 whose prompts open with 128
   tokens of an earlier one.  Checks finish reasons, an idle pool, a
   prefix hit, and that the kernel launched once per layer per ragged
   dispatch; counts the dispatches whose longest row spans more than
   one split.
4. solo — for 3 requests, one of them a prefix-cache hit, the
   full-forward greedy decode equals the engine's tokens.
5. profile — device busy and idle time of a decode-heavy window, the
   paged-attention kernels' time in it, and the kernels that take the
   most time (``torch.profiler``).
   serve_sampling — the serve phase's engine configuration and requests
   sampled (temperature 0.8, top-k 40 on every other request, seeds
   1106 + i): fresh engines in turns greedy, sampled, sampled, greedy
   (decode-step medians), then sampled under seeded chaos preemption;
   the sampled runs token-identical, paged attention once per layer per
   dispatch; threefry's bits and gumbels of the requests' step keys and
   ``sample_tokens``/``sample_token`` tokens on fixed fp32 logits equal
   to the CPU's; the launches and device ms of each pick mode.
6. flash — the flash-attention kernels vs their plain versions at the
   BERT shapes (B=16, H=12, T=512, D=64, bias [1, 12, 512, 512], 0-200
   padded keys per row, dropout 0.1, q/k/v read from one fused
   [B, T, 3, H, D] projection): in bf16 and in fp16 the three
   tensor-core kernels of that type (the forward; dk/dv; dq with the
   dbias partials), in fp32 the four fp32 kernels (the forward; dk/dv,
   dq, dbias).  Each against its plain version on the same tensors,
   which in bf16 and fp16 rounds p, p_drop and dS as the kernels do: out
   within 1e-4 in fp32, 1e-2 of its max in bf16 and 5e-3 in fp16, lse
   within 1e-4 (fp32) or 2e-4, each grad within 1e-3 of its max in fp32,
   2e-2 in bf16, 5e-3 in fp16; two forward and two backward calls bit
   for bit; the fp16 keep pattern equal to bf16's on the same seeds; the
   bf16 and fp16 kernels timed in turns (bf16, fp16, fp16, bf16).
   Kernel times from ``torch.profiler`` beside each kernel's bound and
   achieved TFLOP/s on unpadded pairs, the backward kernels' sum
   beside the bound of the whole backward; the wrapper's whole backward,
   plain and SDPA (same bias + pad mask and dropout, forward and forward
   + backward, pinned to its memory-efficient backend, TF32 off) times
   from CUDA events; beside them SDPA with its default backend (named)
   and pinned to cuDNN attention, or cuDNN's refusal of the call.
   flash_causal — rows 3 and 8's kernels on the LM's causal
   call at transformer_lm_base's shape (the same B, H, T, D, padding
   and dropout): bf16 with the [1, 12, 512, 512] rel-pos bias, bf16
   without a bias (rotary), fp16 and fp32 with the bias, each held as
   above; the forward's keep bits read back exactly (q = k = 0 and a v
   that spells four keys' bits in each output element) and compared
   with the plain mask on every admitted pair; dbias exactly 0 above
   the diagonal (the dq kernel writes its skipped tiles' partials as
   0); times beside the causal ops bound and the bytes bound, the plain
   versions and SDPA with the causal mask folded into its additive mask.
   flash_cross — the same checks at cross-attention's Tq != Tk (B 8, H
   12, D 64, a [1, 12, Tq, Tk] bias, up to 40% of each row's keys
   padded, dropout 0.1): Tq/Tk 256/512, 128/1024 and 512/128 (one block
   in the reference's geometry, rows 3 and 8) in bf16, fp16 and fp32,
   1024/128 (its joint backward, row 4) and 256/4096 (two key blocks:
   its two-pass dq and dk/dv and the dbias pass, rows 5-7) in bf16 and
   fp16; the forward's keep bits read back exactly at the reference's
   geometry for (Tq, Tk); SDPA's default backend and cuDNN timed at
   256/512.
7. train — the port's CLI, in process, trains a seeded random
   ``bert_base`` (12 layers, width 768, T=512, vocab 30522) under
   ``--bf16`` for 20 updates of batch 16 on a synthetic corpus (2,048
   records of 128-510 Zipf(1.1) tokens, written with the port's
   ``IndexedRecordWriter``).  The first update's masked-token loss lies in
   9-11.5 nats and the mean of the last 5 is below it; the three bf16
   flash kernels (forward, dk/dv, dq) launched once per layer per update,
   the fp32 flash kernels never, softmax_dropout's plain route never.
   Reports step time, samples/s and
   tokens/s, then the device idle share and top kernels of a
   ``torch.profiler`` window of 3 more updates, its launch count beside
   the count recorded before the bf16 Dense and GELU repair.
   train_fp16 — the same model, corpus and flags under --fp16 (initial
   loss scale 128): 20 updates in 21 dispatches, dispatch 7 forced to
   overflow (an inf in the master position embedding): skipped, params
   and moments unchanged, the update count held, the scale halved; the
   first loss in 9-11.5 nats and falling; loss_scale logged per step;
   the fp16 flash kernels once per layer per dispatch and no other flash
   kernel; a synchronous save at update 10 resumed in a fresh trainer
   for 5 updates with the same scale and growth tracker and losses
   within 1e-3 relative.  Step time, samples/s, peak memory (training's,
   and with the save's staging) and a profiled window of 3 updates,
   each beside the train phase's bf16 figures.
   checkpoint — the same model and flags: run A takes 10 updates with
   ``--save-interval-updates 5`` (async save); run B, a fresh trainer,
   restores A's ``checkpoint_1_5.pt`` and runs to update 10.  Every
   file's ``.sum`` sidecar verifies, B's losses of updates 6-10 lie within
   1e-3 relative of A's (bit-equality reported), the flash kernels
   launched once per layer per update in both runs; reports the save's
   step-path stall, the file's bytes, the background write's and the
   restore's seconds.
   bert_large_train — the port's CLI trains full-width ``bert_large``
   (24 layers, width 1024, FFN 4096, 16 heads of 64) under ``--bf16`` on
   the train phase's corpus, batch 16 x 512, Adam (0.9, 0.98) eps 1e-6,
   lr 1e-4 after 2 warmup updates, for 6 updates: every loss finite and
   the last below the first, 24 + 24 + 24 bf16 flash launches every
   update and no other flash kernel; step median, peak memory, a profiled
   window of 3 more updates (device busy, idle share, launches) and one
   Adam step's launches and device ms.  Then a classification head (2
   classes) registered at full width: the head's logits and grads on the
   card against the same head on the CPU fed the same card features
   (one bf16 ulp of each tensor's largest magnitude for the logits, two
   for the grads), the model's ``classification_head_name`` call equal
   to the head's, and pooler dropout at rate 0.1 on the card (kept share
   within 4 sigma of 0.9, survivors x / bf16(0.9) exactly).
   xlm_train — first rows 3 and 8 at xlm's attention call (B 16, H 16, T
   512, D 80, a [1, 16, 512, 512] bias, bf16: the D = 128 kernel build
   with 48 zero columns) held against their plain versions as the flash
   phase holds them, the forward's keep bits read back exactly, timed
   beside their bounds, the plain versions and SDPA (cuDNN among its
   backends), then the same B, H, T at D = 64 timed beside them; then
   ``xlm`` (16 layers, width 1280, FFN 5120, 16 heads of 80) trained as
   bert_large_train, 16 + 16 + 16 flash launches an update.
8. flash_multiblock — the same checks at the shapes the JAX package
   sends to its multi-block kernels (rows 2 and 4-7 of the TPU kernel
   table): T=1024 without a bias (one key block: the joint dq/dk/dv
   backward) and T=2048 with a [1, H, T, T] bias (two-pass dq, dk/dv and
   the dbias pass), bf16 and fp16, dropout 0.1, against the plain
   version and SDPA, the two types also in turns.
9. head — the BERT masked-LM head at bert_base's shape (2,048 slots x
   768, tied vocab 30,522, bias, bf16): the chunked cross-entropy's fp32
   product of bf16 operands, the kernels it ran, the nll within 1e-3
   nats of the fp32 product, its forward + backward time beside the
   same head with each product rounded to bf16 first.
10. softmax_dropout — the forward and backward kernels vs their plain
   versions at the Evoformer's three attention shapes (row with pair
   bias [1, 128, 8, 256, 256], column [1, 256, 8, 128, 128], triangle
   [1, 256, 4, 256, 256]; mask [1, G, 1, 1, K] fp32, bias [1, 1, H, Q,
   K]) in fp32, bf16 and fp16, and at Uni-Mol's (x and its pair bias
   [16, 64, 256, 256], no mask) in bf16 and fp16; dropout 0.1.  out and
   the softmax within 1e-5 (fp32), 2e-2 of each tensor's max (bf16) or
   one fp16 ulp at every element (fp16), dx within 2e-3 of its max
   (fp16), equal keep patterns, two calls bit for bit; the backward's dx
   and dbias held exactly on its keep bits (``check_backward``: element
   by element against the plain backward of the kernel's softmax, within
   a bound a wrong bit exceeds wherever g is not 0), a bias of x's shape
   getting dx itself; times beside the bytes bound (the backward's
   beside the recorded time of the element-by-element backward it
   replaced), the plain version and ``torch.softmax`` of the pre-added
   scores (and its backward) — not the same function, no dropout; the
   bf16 and fp16 kernels timed in turns (bf16, fp16, fp16, bf16) at the
   triangle and Uni-Mol shapes.  Then
   softmax_dropout_route: an Evoformer row attention at R = 200 (off the
   kernels' grid) takes the reference's jnp route, the plain version on
   the card, counted apart from the kernels, equal to the CPU.
11. rounding — the fp32 -> bf16 stochastic-rounding kernel (one launch
   over a table of tensors) vs its plain version, bit for bit, on both
   reference layouts (r_blk 8 and 256), a size that is not a multiple of
   1024, NaN and ±Inf; the mean of 2^24 draws of one value within 3
   sigma of it; then the table of every evoformer_base leaf under its
   own seed, bit for bit per-leaf plain, timed in one launch against
   its bound and against one single-entry launch a leaf; times beside
   the bound.  Then ema: the EMA kernel over the same leaves in one
   launch, bit for bit the CPU formula and the plain version on the
   card, timed beside its bytes bound, the plain version and
   ``torch._foreach_lerp_``.
12. evoformer_train — the port's CLI, in process, trains a seeded random
   ``evoformer_base`` (8 blocks, c_m 256, c_z 128, 8 MSA and 4 pair
   heads) on S=128 MSA rows x R=256 residues under ``--bf16 --bf16-sr
   --optim-bf16-moments`` with dropout 0.1: 10 updates of batch 1 on 8
   records written by the port's ``make_data``.  Every loss finite, the
   mean of the last 3 below the first; softmax_dropout forward and
   backward 32 launches per update each and its plain route never,
   rounding one table launch per 800 entries of the SR sync and of the
   moments (3 per update for 688 leaves), flash none.  Reports step
   time, residue pairs/s and peak memory, then the idle share, the
   softmax_dropout kernels' time and the top kernels of a
   ``torch.profiler`` window of 2 more updates.
13. evoformer_unifold — the same model and shape under Uni-Fold's recipe
   (``--bf16 --bf16-sr --dropout 0.1``, Adam (0.9, 0.999) eps 1e-6,
   ``--clip-norm 0 --per-sample-clip-norm 0.1 --ema-decay 0.999``, lr
   1e-3 on ``exponential_decay`` (warmup 4, ratio 0.95 per 50,000),
   batch 1, ``--update-freq 2``): 10 updates on 20 records, saving at
   update 5.  Losses finite and falling, the logged lr the schedule's
   closed form, launches exact per update (softmax_dropout 4 x blocks x
   2 each way, one SR table launch per example, one EMA launch, no
   flash, no plain route), each update's EMA bit for bit the CPU
   formula on the same tensors, the update-5 file's EMA the trainer's;
   step time, samples/s, peak memory, then a profile window of 2 updates
   with the EMA's and the per-sample clip's device and host time.  The
   file resumed in a fresh trainer ends at update 10 with params and EMA
   bit-equal to the first run's; a ``--load-from-ema`` start holds the
   file's EMA as params; then one master weight poisoned with inf under
   ``--bf16`` and no scaler: FloatingPointError, and the NaN detector
   names that weight's module and leaf and no module before it.
14. mol_train_fp16 — the port's CLI, in process, trains a seeded random
   ``unimol_base`` (15 layers, width 512, FFN 2048, 64 heads of 8, 64
   pair channels, 128 Gaussian kernels) under ``--fp16
   --fp16-init-scale 4 --fp16-scale-window 256 --max-atoms 256``, batch
   16, Adam (0.9, 0.99), lr 1e-4, dropout 0.1, loss weights 1 / 5 / 10,
   for 20 updates on 1,024 molecules of 16-256 atoms written by the
   port's ``make_data``.  Every applied update's loss finite, the mean
   of the last 5 below the first, at most 4 skips, every dispatch 15
   fp16 softmax_dropout forward and 15 backward launches, the plain
   route and flash never.  Reports step times, molecules/s, peak memory,
   the loss-scale sequence, the real-atom share of the padded rows, then
   the idle share, the softmax_dropout kernels' time and the top kernels
   of a ``torch.profiler`` window of 3 more updates.
   data_workers — the data pipeline's modes on both models at full
   width, in turns: the train phase's bert_base (--bf16, batch 16 x
   512) for 8 updates under (a) ``--num-workers 0`` (the prefetch pump
   still on, buffer 10), (e) ``--num-workers 0 --data-buffer-size 0``
   (no pump: the inline loading every other training phase uses), (b)
   no data flag (the reference's defaults: 1 thread worker, a buffer of
   10), (c) 4 thread workers, (d) 4 forked worker processes; (d) again
   with a pool worker SIGKILLed after update 1 and SIGTERM after update
   4; then mol_train_fp16's unimol_base for 8 updates under (a), (e),
   (c) and (d).
   Every mode's losses and sample sizes bit-equal to (a)'s, each batch's
   sha256 equal, the iterator state after update 8 equal; flash 12 + 12
   + 12 (BERT) and softmax_dropout 15 + 15 (Uni-Mol) launches an update;
   the killed worker's pool respawned once (``status()``: respawns=1),
   the batches still (a)'s; the SIGTERM'd run returns normally (the
   CLI's exit 0) with checkpoint_last.pt's iterator position (a)'s at
   update 4 and no worker alive or listed as a child within 5 s.  Per
   mode: step median and spread, the host ms the loop waited for each
   batch, the pool's fork seconds, and a profiled window of 3 updates
   pulled through the mode's pipeline.
15. lm_train — the port's CLI, in process, trains a seeded
   random ``transformer_lm_base`` (12 layers, width 768, FFN 3072, 12
   heads of 64, T=512, vocab 30522, the reference's rel-pos bias and
   learned positions) under ``--bf16``, Adam, clip 1.0, lr 5e-4 on
   ``fixed``, dropout 0.1, batch 16, on 512 records of the BERT phase's
   Zipf law written by the LM's ``make_data``: run A 20 updates saving at
   10, run B a fresh trainer resuming that file to 20.  First loss in
   9-11.5 nats, the last 5 below it; every update of both runs 12 + 12
   + 12 bf16 flash launches (forward, dk/dv, dq) and no other flash
   kernel; B's losses and final params bit-equal to A's.  Step median,
   tokens/s (unpadded target tokens; the padded-slot rate beside it),
   peak memory, then a profiled window of 3 updates.
   lm_serve_checkpoint — 10 ``--rotary True`` updates of the same model
   saved without the optimizer state (36 flash launches an update, no
   bias), served by ``unicore_tpu_torch.serve``'s ``--checkpoint
   --dict --prompts`` in process: 8 prompts of 16-200 tokens, 16 greedy
   tokens each, every stream equal to ``solo_greedy`` of the loaded
   model (a divergence passes only at an fp32 tie, top-2 gap < 1e-4),
   and the oracle held once to the plain versions (the shortest prompt
   and its stream in one forward on the CPU: logits within 1e-3 of their
   max, plain's greedy tokens the served ones but at a top-2 gap within
   twice that distance); a 2-update rel-pos file refused with the JAX
   decoder's message.
   lm_generate — inside lm_serve_checkpoint, on the same loaded model:
   ``examples/lm/generate.py`` ``generate()`` (the dense KV-cache decode,
   fp32) on those 8 prompts right-padded (the ragged prefill) and on an
   unpadded 8 x 64 batch, 32 greedy tokens at capacity 512: every row
   equal to ``solo_greedy`` and to the engine's greedy stream (ties as
   above), no flash or paged kernel inside ``generate()``; a sampled
   call (temperature 0.8, top-k 40, ``PRNGKey(18)``) twice the same.
   Prefill ms, decode-step median, tokens/s, one decode step's and one
   sampled pick's launches, the cache's bytes, peak memory.
   lm_optim_fp16 — the same model under ``--fp16`` (initial loss scale
   128), 10 updates a run, saving at 5, once per optimizer and
   schedule: (a) Adam on ``fixed``, (b) SGD, momentum 0.9, weight decay
   0.01, on ``cosine`` with warmup, (c) Adagrad on ``inverse_sqrt`` with
   warmup, (d) Adadelta on ``tri_stage --phase-ratio "(0.2, 0.3,
   0.5)"``, (e) SGD on ``triangular``; a fresh trainer resumes (a)-(d)
   from update 5.  Then ``reduce_lr_on_plateau`` at 2 layers over 5
   epochs of 32 records with validation (``--lr-threshold 0.5``).  Every
   loss finite, run a's first in 9-11.5 nats and the last 5 below it,
   every applied update moving the params (leaves moved reported), every
   dispatch 12 + 12 + 12 fp16 flash launches (2 a kernel at 2 layers)
   and no other flash kernel, softmax_dropout's plain route never, the
   lr of each update and the lr logged after it the port's scheduler on
   the host for that update count (replayed through the epoch ends for
   reduce_lr_on_plateau, whose lr shrinks), each resumed run's losses
   and final params bit-equal.  Per run: losses, loss_scale sequence,
   step median, tokens/s, peak memory, and one optimizer step's launches
   and device time.
   lm_run_control — the lm_train model and flags with validation on
   (24 valid records), ``--validate-interval-updates 4
   --batch-size-valid 8 --max-valid-steps 1 --curriculum 1 --log-memory
   2 --save-interval-updates 4``, to update 12: run a gets SIGTERM from
   a hook after update 6 and returns with the handlers restored, having
   saved at 4 and 6 and validated at 4 only; resumed from its save dir
   at update 6, it reaches 12 with losses, valid losses and params
   bit-equal to the uninterrupted run b; validation and saves at 4, 8,
   12; every validation pass 2 batches of 8 and 24 bf16 flash forward
   launches (row 3c at batch 8), every update 36 bf16 flash launches;
   b's mem_gb records at dispatches 2-12 within its peak.  Run c
   (``--stop-time-hours`` at b's training time after update 6) stops
   before 12 and saves there; run d (``--stop-min-lr 1e-6``, lr 5e-4
   shrunk 10x an epoch, 3 batches an epoch) stops after the epoch and at
   the lr the port's scheduler on the host predicts; run e
   (``--profile``, 3 updates) writes a Chrome trace holding flash kernel
   events.  Reports the validation passes' ms, mem_gb beside the peak,
   the update c stopped at and the trace's size and events.
   cross_decoder — a 12-layer decoder at transformer_lm_base's widths
   built with cross-attention over the output of a 12-layer encoder at
   bert_base's (post-LN, rel-pos): batch 8, encoder T 512 and decoder T
   256 with padded tails, bf16, dropout 0.1, 4 forward and backward
   passes of a seeded loss: each pass 12 bf16 flash forwards and
   backwards at (512, 512), at (256, 256) causal and at (256, 512), and
   no other flash call; pass ms, device time, launches, peak memory;
   then batch 2, dropout 0, fp32 on the card and on the CPU (plain
   versions): the output and every gradient within 1e-3 of the CPU
   tensor's largest magnitude.
   return_attn — a bert_base encoder layer with ``return_attn=True`` in
   bf16 (batch 8 x 512): one softmax_dropout forward and backward launch
   and no flash; the probabilities equal the plain version's under the
   same seed (keep pattern exact, values within 2e-2 of the largest).
   lm_checkpoint_activations — lm_train's model and flags, 8 updates a
   run, without ``--checkpoint-activations``, with, with, without:
   losses and final params bit-equal, flash forwards per update 24 with
   the flag (the recompute) and 12 without, 12 + 12 backward either way;
   peak memory, step median and device time per update of each run.
   bert_checkpoint_activations — the train phase's bert_base, 4 updates
   without and with the flag: losses and params bit-equal, the forward
   launches doubled.
16. the ``kernels`` line (rows 1-11 of the TPU kernel table, row 1's
   launches from serve and serve_sampling, rows 2-10
   once for the bf16 kernels and once for the fp16 ones, the flash rows'
   launches from the train and train_fp16 phases, the softmax_dropout
   rows' from evoformer_train (bf16) and mol_train_fp16 (fp16), rows
   9-11 with evoformer_unifold's beside them; the backward rows carry
   the row's whole backward time beside the bound of the backward as one
   function; rows 3 and 8 again for the LM's causal call, launches
   from lm_train, lm_run_control's beside them (its validation passes'
   apart), and the fp16 rows 3 and 8 with lm_optim_fp16's causal
   launches beside train_fp16's; rows 3 and 8 once more for
   cross-attention's call at Tq 256, Tk 512, launches from
   cross_decoder, with every flash_cross case beside them; rows 3 and
   8 once more for xlm's call at D = 80, launches from xlm_train, the D
   = 64 call's times beside them (bert_large_train's launches beside
   BERT's rows 3 and 8); the
   checkpoint-activation runs' and return_attn's launches beside the
   rows they ran, and data_workers' beside BERT's rows 3 and 8 and the
   fp16 rows 9 and 10; last the EMA kernel, which replaces no
   ``pallas_call``),
   the card's name and power limit, and the closing ``{"ok": true, ...}``
   line.

Exits non-zero without a card, and without the repository around it.
"""

import gc
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

PAGE_SIZE, HEADS, HEAD_DIM, BATCH, CHUNK = 16, 12, 64, 16, 32
NUM_PAGES, CONTEXT = 512, 512
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 (and fp16) tensor cores, dense
TOL = 1e-4                  # fp32, summation order differs
FLASH_B, FLASH_H, FLASH_T, FLASH_D, FLASH_P = 16, 12, 512, 64, 0.1
TRAIN_UPDATES, TRAIN_BATCH = 20, 16
# the training phases load their batches inline on the loop's thread, no
# workers and no prefetch pump (the data modes are data_workers')
INLINE_DATA = ("--num-workers", "0", "--data-buffer-size", "0")
TRAIN_FLASH = ("flash_fwd_bf16", "flash_bwd_dkdv", "flash_bwd_dq")
TRAIN_FLASH_FP16 = ("flash_fwd_fp16", "flash_bwd_dkdv_fp16",
                    "flash_bwd_dq_fp16")


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


STARTED = time.perf_counter()


def emit(phase, **fields):
    """Print one phase line, with the seconds since the script started
    (``elapsed_s``: the time budget of each phase is the difference)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - STARTED}),
          flush=True)


def time_ms(fn, flush, iters=30):
    """Median device time of one call, by CUDA events around each call,
    with L2 flushed before it (the serve step finds the pools cold:
    twelve layers' pools are ~600 MB)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def make_case(rng, kind):
    """Operands of one ragged step at the serve path's shapes.  Rows get
    disjoint pages from a random permutation of the pool (page 0, the
    trash page, is never handed out); table rows pad with page 0."""
    T = 1 if kind == "decode" else CHUNK
    width = CONTEXT // PAGE_SIZE
    lengths = rng.integers(T + 16, CONTEXT - 32, size=BATCH).astype(np.int32)
    positions = np.full((BATCH, T), -1, np.int32)
    for b in range(BATCH):
        positions[b] = np.arange(lengths[b] - T, lengths[b])
    if kind == "mixed":
        for b in range(4, 10):   # decode rows
            positions[b, 1:] = -1
            positions[b, 0] = lengths[b] - 1
        positions[10, 20:] = -1  # a short tail chunk
        lengths[10] = positions[10, 19] + 1
        lengths[11] = 0          # an inactive row
        positions[11] = -1
    perm = rng.permutation(NUM_PAGES - 1) + 1
    table = np.zeros((BATCH, width), np.int32)
    used = 0
    for b in range(BATCH):
        n = -(-int(lengths[b]) // PAGE_SIZE)
        table[b, :n] = perm[used:used + n]
        used += n
    slots = NUM_PAGES * PAGE_SIZE
    k = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    v = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    q = rng.standard_normal((BATCH, T, HEADS, HEAD_DIM), dtype=np.float32)
    return q, k, v, table, positions, lengths


def bound(case):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    over HBM bandwidth and its fp32 operations over the fp32 rate.  The
    bytes: each row's K and V columns that some query admits — the first
    ``min(len_b, max_t positions[b, t] + 1)`` of the row — once, the table
    entries of their pages, q, positions and lengths read and out written.
    The operations: per admitted (query, column) pair and head, a dot
    product of D for the score and D multiply-adds for the output."""
    q, _, _, _, positions, lengths = case
    cols = np.minimum(lengths.astype(np.int64),
                      positions.max(axis=1).astype(np.int64) + 1).clip(min=0)
    pages = -(-cols // PAGE_SIZE)
    nbytes = (int(cols.sum()) * HEADS * HEAD_DIM * 4 * 2
              + 2 * q.nbytes + 4 * int(pages.sum()) + positions.nbytes
              + lengths.nbytes)
    admitted = np.minimum(positions + 1, lengths[:, None]).clip(min=0)
    flops = int(admitted.sum()) * HEADS * HEAD_DIM * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# the single-block paged-attention kernel this design replaced, at these
# cases, as the smoke measured it before the redesign (H100 80GB HBM3,
# 700 W): reported beside this run's time, not measured by it
PA_REPLACED_MS = {"decode": 0.0679, "prefill": 0.2357, "mixed": 0.2106}


def plan_sweep(pa, operands, want, scale, flush):
    """The kernel's time at 1, 2, 4 and 8 splits of the table, through its
    C entry (the wrapper always takes ``split_plan``'s): the evidence for
    the plan.  Each plan's output is held within TOL of plain."""
    q, k, v, table, positions, lengths = operands
    B, T, H, D = q.shape
    cols = table.shape[1] * PAGE_SIZE
    fn = pa._kernel()
    tickets = torch.zeros(B * H, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for splits in (1, 2, 4, 8):
        per = -(-cols // splits)
        out = torch.empty_like(q)
        ws = torch.empty(B * H * splits * T * (D + 2), device="cuda")

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     table.data_ptr(), positions.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
                     tickets.data_ptr(), B, T, H, D, table.shape[1],
                     PAGE_SIZE, splits, per, scale, stream)
            if err:
                raise AssertionError(f"{splits} splits: CUDA error {err}")

        call()
        err = float((out - want).abs().max())
        if err > TOL:
            raise AssertionError(f"{splits} splits: max |kernel - plain| "
                                 f"{err} > {TOL}")
        times[f"{splits}x{per}"] = time_ms(call, flush)
    return times


def kernel_phase(pa, flush):
    import torch.nn.functional as F

    rng = np.random.default_rng(20261016)
    scale = HEAD_DIM ** -0.5
    cases = {}
    for kind in ("decode", "prefill", "mixed"):
        case = make_case(rng, kind)
        q, k, v, table, positions, lengths = (
            torch.from_numpy(x).cuda() for x in case)

        def kernel():
            return pa.ragged_paged_attention(
                q, k, v, table, positions, lengths, page_size=PAGE_SIZE,
                scale=scale)

        def plain():
            return pa.paged_attention_plain(
                q, k, v, table, positions, lengths, PAGE_SIZE, scale)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{kind}: non-finite attention output")
        if not torch.equal(got, again):
            raise AssertionError(f"{kind}: two kernel calls differ")
        err = float((got - want).abs().max())
        if err > TOL:
            raise AssertionError(f"{kind}: max |kernel - plain| {err} > {TOL}")
        # the library yardstick: SDPA over the gathered K/V, position mask
        kg = pa.gather_slots(k, table, PAGE_SIZE).transpose(1, 2).contiguous()
        vg = pa.gather_slots(v, table, PAGE_SIZE).transpose(1, 2).contiguous()
        qh = q.transpose(1, 2).contiguous()
        cols = torch.arange(kg.shape[2], device="cuda")
        mask = ((cols[None, None, :] <= positions[:, :, None])
                & (cols[None, None, :] < lengths[:, None, None]))[:, None]

        def library():
            return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  scale=scale)

        bound_ms, bound_by = bound(case)
        splits, split_cols = pa.split_plan(BATCH, HEADS,
                                           table.shape[1] * PAGE_SIZE)
        ms = time_ms(kernel, flush)
        cases[kind] = {
            "T": int(q.shape[1]), "max_abs_err": err, "bit_identical": True,
            "ms": ms, "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "splits": splits, "split_cols": split_cols,
            "plans_ms": plan_sweep(pa, (q, k, v, table, positions, lengths),
                                   want, scale, flush),
            "replaced_ms_recorded": PA_REPLACED_MS[kind],
            "tokens": int(lengths.sum()),
        }
        emit("kernel", case=kind, **cases[kind])
    return cases


def longest_rows(engine):
    """Wrap the engine's step to note each dispatch's longest row (its
    host ``lengths``, which read nothing from the card); returns the list
    it fills."""
    longest = []
    step = engine._step

    def noting(tokens, positions, tables, slot_mapping, lengths, *rest):
        longest.append(int(lengths.max()))
        return step(tokens, positions, tables, slot_mapping, lengths, *rest)

    engine._step = noting
    return longest


def serve_phase(pa):
    from unicore_tpu_torch.examples.lm.model import build_model
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    t0 = time.perf_counter()
    model = build_model("transformer_lm_base", vocab_size=30522, seed=0,
                        device="cuda")
    engine = ServeEngine(model, device="cuda", num_pages=NUM_PAGES,
                         page_size=PAGE_SIZE, max_batch=BATCH)
    build_s = time.perf_counter() - t0
    vocab, layers = model.vocab_size, model.decoder_layers
    rng = np.random.default_rng(1106)
    # warm-up (cuBLAS handles, the kernel library's first load), outside
    # the counted run
    engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
    first = [Request(prompt=rng.integers(1, vocab, size=int(n)).tolist(),
                     max_new_tokens=32, eos_id=2, request_id=f"a{i}")
             for i, n in enumerate(rng.integers(16, 449, size=16))]
    donor = max(first, key=lambda r: len(r.prompt)).prompt[:128]
    second = [Request(prompt=donor + rng.integers(
                          1, vocab, size=int(n)).tolist(),
                      max_new_tokens=32, eos_id=2, request_id=f"b{i}")
              for i, n in enumerate(rng.integers(16, 64, size=4))]
    before, decode_steps0 = dict(engine.stats), len(engine.decode_ms)
    longest = longest_rows(engine)
    pa.ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    results = engine.generate(first) + engine.generate(second)
    wall_s = time.perf_counter() - t0
    launches = pa.ragged_paged_attention.launches
    stats = {k: engine.stats[k] - before.get(k, 0)
             for k in ("ragged_dispatches", "decode_tokens",
                       "decode_time_s", "prefix_hits",
                       "prefix_tokens_saved")}
    dispatches = stats["ragged_dispatches"]
    reasons = sorted({r.finish_reason for r in results})
    if not set(reasons) <= {"eos", "length", "capacity"}:
        raise AssertionError(f"unexpected finish reasons {reasons}")
    if not engine.pool.is_idle():
        raise AssertionError("pool not idle after the run")
    engine.pool.check_invariants()
    if stats["prefix_hits"] < 1:
        raise AssertionError("no prefix hit in the second generate()")
    if launches != layers * dispatches or dispatches == 0:
        raise AssertionError(f"{launches} kernel launches for {dispatches} "
                             f"ragged dispatches of {layers} layers")
    ttft = np.array([r.ttft_ms for r in results])
    split_cols = pa.split_plan(BATCH, model.decoder_attention_heads,
                               engine.table_width * PAGE_SIZE)[1]
    emit("serve", model="transformer_lm_base", setup_s=build_s,
         requests=len(results), finish_reasons=reasons,
         generated_tokens=sum(len(r.tokens) for r in results),
         wall_s=wall_s, ragged_dispatches=dispatches, launches=launches,
         multi_split_dispatches=sum(n > split_cols for n in longest),
         evictions=engine.stats["evictions"],
         prefix_hits=stats["prefix_hits"],
         prefix_tokens_saved=stats["prefix_tokens_saved"],
         decode_tokens_per_s=stats["decode_tokens"] / stats["decode_time_s"],
         ttft_p50_ms=float(np.percentile(ttft, 50)),
         ttft_p99_ms=float(np.percentile(ttft, 99)),
         decode_step_median_ms=float(np.median(
             list(engine.decode_ms)[decode_steps0:])))
    return model, first, second, results, launches


def held_to_solo(label, got, solo, margins):
    """``got`` equals the solo decode ``solo`` (with its per-step top-2
    margins), or first differs at a step whose top-2 logit gap is below
    1e-4 — a tie under fp32 summation order — and is reported."""
    diverge = next((i for i, (x, y) in enumerate(zip(solo, got)) if x != y),
                   None)
    if diverge is None and len(solo) != len(got):
        raise AssertionError(f"{label}: lengths differ")
    if diverge is not None and margins[diverge] >= 1e-4:
        raise AssertionError(f"{label}: diverges from the solo decode at "
                             f"step {diverge} (margin {margins[diverge]})")
    return {"equal": diverge is None, "tie_at": diverge,
            "min_margin": float(min(margins))}


def solo_phase(model, first, second, results):
    """The port's full-forward greedy decode equals the engine's tokens,
    for the shortest and the longest prompt of the first call and the
    longest of the second — a prefix-cache hit, whose prefill starts past
    the shared pages and whose attention reads pages another sequence
    wrote.  A divergence passes only at a step whose top-2 logit gap is
    below 1e-4 — a tie under fp32 summation order — and is reported."""
    from unicore_tpu_torch.examples.lm.model import solo_greedy

    by_id = {r.request_id: r for r in results}
    picks = [min(first, key=lambda r: len(r.prompt)),
             max(first, key=lambda r: len(r.prompt)),
             max(second, key=lambda r: len(r.prompt))]
    report = []
    for req in picks:
        solo, margins = solo_greedy(model, req.prompt, req.max_new_tokens,
                                    eos_id=req.eos_id)
        got = by_id[req.request_id].tokens
        report.append({"request": req.request_id,
                       "prompt_len": len(req.prompt), "tokens": len(got),
                       **held_to_solo(req.request_id, got, solo, margins)})
    emit("solo", checks=report)


def profile_phase(model):
    """Where a decode-heavy window's time goes: ``torch.profiler`` over 8
    requests (64-token prompts, 16 new tokens each) — device busy time
    (the sum of kernel times; one stream, so no overlap) against wall
    time, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    engine = ServeEngine(model, device="cuda", num_pages=NUM_PAGES,
                         page_size=PAGE_SIZE, max_batch=BATCH)
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(1, model.vocab_size, 64).tolist(),
                    max_new_tokens=16, request_id=f"p{i}") for i in range(8)]
    engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
    dispatches0 = engine.stats["ragged_dispatches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    paged = [e for e in kernels if "paged_" in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit("profile", window="8 requests x 16 new tokens, 64-token prompts",
         ragged_dispatches=engine.stats["ragged_dispatches"] - dispatches0,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
         kernel_launches=sum(e.count for e in kernels),
         paged_attention_ms=sum(e.self_device_time_total
                                for e in paged) / 1e3,
         paged_attention_launches=sum(e.count for e in paged),
         top_kernels=[{"name": e.key[:80], "count": e.count,
                       "ms": e.self_device_time_total / 1e3} for e in top])


def device_launches(fn):
    """Kernel launches and device ms of one call of ``fn`` (after a warm
    call), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return {"launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3}


SAMPLE_TEMP, SAMPLE_TOP_K, SAMPLE_SEED = 0.8, 40, 1106


def serve_sampling_phase(model, pa, first, second, greedy_results):
    """The serve phase's engine configuration and requests, sampled:
    temperature 0.8 on all, top-k 40 on every other one, seeds 1106 + i.
    Fresh engines in turns greedy, sampled, sampled, greedy (each its
    decode-step median), then a sampled run under seeded chaos
    preemption: the three sampled runs token-identical, paged attention
    once per layer per dispatch.  Then the card against the CPU:
    threefry's bits and gumbels of the requests' first step keys bit for
    bit, and ``sample_tokens``/``sample_token`` tokens on fixed fp32
    logits; and the launches and device ms that each pick mode adds to a
    step."""
    import dataclasses
    import random

    from unicore_tpu_torch.serve import threefry
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.sampling import (sample_token,
                                                  sample_tokens, step_keys)
    from unicore_tpu_torch.serve.scheduler import Request

    layers, vocab = model.decoder_layers, model.vocab_size
    reqs = first + second
    sampled = [dataclasses.replace(
        r, temperature=SAMPLE_TEMP, top_k=SAMPLE_TOP_K if i % 2 else 0,
        seed=SAMPLE_SEED + i) for i, r in enumerate(reqs)]

    def run(batch, chaos=False):
        engine = ServeEngine(
            model, device="cuda", num_pages=NUM_PAGES, page_size=PAGE_SIZE,
            max_batch=BATCH, chaos_rate=0.25 if chaos else 0.0,
            chaos_rng=random.Random(18) if chaos else None)
        engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
        d0 = len(engine.decode_ms)
        dispatches0 = engine.stats["ragged_dispatches"]
        evictions0 = engine.scheduler.num_evictions
        pa.ragged_paged_attention.launches = 0
        results = (engine.generate(batch[:len(first)])
                   + engine.generate(batch[len(first):]))
        launches = pa.ragged_paged_attention.launches
        if not engine.pool.is_idle():
            raise AssertionError("pool not idle after a sampled run")
        return {"tokens": [r.tokens for r in results],
                "reasons": sorted({r.finish_reason for r in results}),
                "step_ms": float(np.median(list(engine.decode_ms)[d0:])),
                "dispatches": (engine.stats["ragged_dispatches"]
                               - dispatches0), "launches": launches,
                "evictions": engine.scheduler.num_evictions - evictions0}

    turns = []
    greedy_a = run(reqs)
    turns.append(("greedy", greedy_a["step_ms"]))
    sampled_a = run(sampled)
    turns.append(("sampled", sampled_a["step_ms"]))
    sampled_b = run(sampled)
    turns.append(("sampled", sampled_b["step_ms"]))
    launches = sampled_a["launches"] + sampled_b["launches"]
    greedy_b = run(reqs)
    turns.append(("greedy", greedy_b["step_ms"]))
    chaos = run(sampled, chaos=True)
    dispatches = sampled_a["dispatches"] + sampled_b["dispatches"]
    if launches != layers * dispatches or dispatches == 0:
        raise AssertionError(f"{launches} paged-attention launches for "
                             f"{dispatches} sampled dispatches of {layers} "
                             "layers")
    for name, r in (("sampled run b", sampled_b), ("chaos run", chaos)):
        if r["tokens"] != sampled_a["tokens"]:
            raise AssertionError(f"{name}: tokens differ from run a")
    if chaos["evictions"] < 1:
        raise AssertionError("the chaos run evicted nothing")
    if sampled_a["tokens"] == greedy_a["tokens"]:
        raise AssertionError("sampling changed no token")
    for r in (greedy_a, greedy_b, sampled_a, chaos):
        if not set(r["reasons"]) <= {"eos", "length", "capacity"}:
            raise AssertionError(f"unexpected finish reasons {r['reasons']}")
    # the card against the CPU on the requests' first 8 step keys
    seeds = torch.arange(len(sampled)).repeat_interleave(8) + SAMPLE_SEED
    steps = torch.arange(8).repeat(len(sampled))
    keys = step_keys(seeds, steps)
    keys_card = step_keys(seeds.cuda(), steps.cuda())
    bits_equal = torch.equal(keys_card.cpu(), keys) and torch.equal(
        threefry.random_bits(keys_card, (vocab,)).cpu(),
        threefry.random_bits(keys, (vocab,)))
    gumbel_equal = torch.equal(
        threefry.gumbel(keys_card, (vocab,)).cpu().view(torch.int32),
        threefry.gumbel(keys, (vocab,)).view(torch.int32))
    x = torch.randn(BATCH, vocab,
                    generator=torch.Generator().manual_seed(18)) * 4
    temps = torch.tensor([0.0, SAMPLE_TEMP, 1.3, SAMPLE_TEMP] * (BATCH // 4))
    top_k = torch.tensor([0, SAMPLE_TOP_K, 1, vocab] * (BATCH // 4))
    pick_keys = keys[:BATCH]
    tokens_equal = {}
    for use_top_k in (True, False):
        tokens_equal[f"sample_tokens(use_top_k={use_top_k})"] = torch.equal(
            sample_tokens(x.cuda(), pick_keys.cuda(), temps.cuda(),
                          top_k.cuda(), use_top_k=use_top_k).cpu(),
            sample_tokens(x, pick_keys, temps, top_k, use_top_k=use_top_k))
    for temp in (SAMPLE_TEMP, 1.3):
        for k in (0, SAMPLE_TOP_K):
            key = threefry.PRNGKey(18)
            tokens_equal[f"sample_token(t={temp}, k={k})"] = torch.equal(
                sample_token(x.cuda(), key=key.cuda(), temperature=temp,
                             top_k=k).cpu(),
                sample_token(x, key=key, temperature=temp, top_k=k))
    if not (bits_equal and gumbel_equal and all(tokens_equal.values())):
        raise AssertionError(f"card vs CPU: bits {bits_equal}, gumbels "
                             f"{gumbel_equal}, tokens {tokens_equal}")
    # what each pick mode costs a step, on [16, V] logits
    xc, tc, kc = x.cuda(), temps.cuda(), top_k.cuda()
    sc, stc = seeds[:BATCH].cuda(), steps[:BATCH].cuda()
    picks = {mode: device_launches(
        lambda mode=mode: ServeEngine._pick_tokens(xc, sc, stc, tc, kc,
                                                   mode))
        for mode in ("greedy", "temp", "topk")}
    return {
        "model": "transformer_lm_base", "card": card(),
        "requests": len(sampled), "temperature": SAMPLE_TEMP,
        "top_k_on_every_other": SAMPLE_TOP_K,
        "decode_step_ms_turns": turns,
        "sampled_dispatches": dispatches, "paged_launches": launches,
        "chaos_evictions": chaos["evictions"],
        "reproducible": True, "chaos_identical": True,
        "greedy_equal_serve_phase": greedy_a["tokens"] == [
            r.tokens for r in greedy_results],
        "tokens_differing_from_greedy": sum(
            a != b for s, g in zip(sampled_a["tokens"], greedy_a["tokens"])
            for a, b in zip(s, g)),
        "card_vs_cpu": {"bits_equal": bits_equal,
                        "gumbel_equal": gumbel_equal,
                        "keys": int(keys.shape[0]), "columns": vocab,
                        "tokens_equal": tokens_equal},
        "pick_per_step": picks,
        "sampling_adds_launches": picks["topk"]["launches"]
                                  - picks["greedy"]["launches"]}


def flash_operands(rng, dtype, shape=(FLASH_B, FLASH_H, FLASH_T, FLASH_D),
                   with_bias=True, tk=None):
    """Operands of one attention layer of the BERT training path: q/k/v
    as the fused projection's strided views, the batch-broadcast rel-pos
    bias, 0-200 padded keys per row, per-row dropout seeds, and dO.
    With ``tk`` (cross-attention, Tq = shape[2] queries over tk keys): q
    from the query side's projection and k/v from the encoder side's,
    each a contiguous [B, T, H, D], a [1, H, Tq, Tk] bias, and up to 40%
    of each row's keys padded."""
    B, H, T, D = shape

    def dev(a):
        return torch.from_numpy(a).cuda().to(dtype)

    if tk is None:
        tk = T
        qkv = dev(rng.standard_normal((B, T, 3, H, D), dtype=np.float32))
        q, k, v = qkv.unbind(2)
        most = 200
    else:
        q, k, v = (dev(rng.standard_normal((B, t, H, D), dtype=np.float32))
                   for t in (T, tk, tk))
        most = 2 * tk // 5
    bias = (dev(rng.standard_normal((1, H, T, tk), dtype=np.float32))
            if with_bias else None)
    npad = rng.integers(0, most + 1, size=B)
    pad = np.zeros((B, tk), np.int32)
    for b in range(B):
        pad[b, tk - npad[b]:] = 1
    seed = rng.integers(-2 ** 31, 2 ** 31 - 1, size=B).astype(np.int32)
    dout = dev(rng.standard_normal((B, T, H, D), dtype=np.float32))
    return (q, k, v, bias, torch.from_numpy(pad).cuda(),
            torch.from_numpy(seed).cuda(), dout, npad)


# the kernels of each operand type: bf16 and fp16 (the training paths)
# take the tensor-core forward and the two tensor-core backward kernels of
# their type, fp32 the fp32 FMA forward and the three fp32 FMA backward
# kernels
FWD_KERNEL = {torch.float32: "flash_fwd", torch.bfloat16: "flash_fwd_bf16",
              torch.float16: "flash_fwd_fp16"}
BWD_KERNELS = {torch.float32: ("flash_dkdv", "flash_dq", "flash_dbias"),
               torch.bfloat16: ("flash_bwd_dkdv", "flash_bwd_dq"),
               torch.float16: ("flash_bwd_dkdv_fp16", "flash_bwd_dq_fp16")}
# max |kernel - plain| allowed, as a share of the plain tensor's max, of
# the tensor-core kernels' out and grads (fp16 keeps 3 more mantissa
# bits than bf16); fp32 is held to TOL and 1e-3 of the max
FLASH_REL_TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float16: (5e-3, 5e-3)}
# the library yardstick's backend: the one that takes an additive mask
# and dropout (SDPA's default moved between backends from call to call)
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def flash_bounds(npad, itemsize, shape, with_bias, causal=False, tk=None):
    """{kernel: (bound_ms, bound_by, flops)}: each kernel's operations on
    the keys this run's data leaves unpadded (a padded key adds exactly
    nothing to any output; under ``causal`` only keys at or below the
    query count, about half) over the tensor-core rate of its operand type,
    against the bytes the function needs read once and written once: q,
    dO, lse and delta of every query, k and v of the unpadded keys only,
    the [H, Tq, Tk] bias only where some row of the batch admits the pair
    (under ``causal`` the lower triangle, cut at the row with the most
    unpadded keys), and every output whole (out and dq of the Tq
    queries, dk and dv of the Tk keys).  dbias counts once, as one fp32
    [H, Tq, Tk]: the bf16 dq kernel's per-group partials are its design,
    not the function's output.  ``backward`` is the whole backward as one
    function: 10 units of flops per unpadded pair and D, q/k/v/dO read
    once.  ``tk``: the key count where it is not shape[2]."""
    B, H, T, D = shape
    tk = T if tk is None else tk
    live = (tk - npad).astype(np.int64)         # unpadded keys of each row
    most = int(live.max())                      # the bias serves every row
    pairs = H * T * int(live.sum())             # unpadded (q, k) pairs
    bias_pairs = T * most                       # bias elements read
    if causal:  # query q admits keys 0..min(q, live - 1)
        pairs = H * int((live * (live + 1) // 2 + (T - live) * live).sum())
        bias_pairs = most * (most + 1) // 2 + (T - most) * most
    rate = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    act = B * T * H * D * itemsize              # one of q, dO, out, dq
    act_k = B * tk * H * D * itemsize           # one of dk, dv
    kv = int(live.sum()) * H * D * itemsize     # k or v of the unpadded keys
    rows = B * H * T * 4                        # one of lse, delta
    bias = H * bias_pairs * itemsize if with_bias else 0
    small = B * tk * 4 + B * 4                  # pad, seeds
    dbias = H * T * tk * 4 if with_bias else 0  # one fp32 [H, Tq, Tk]
    fixed = 2 * kv + bias + small               # every kernel reads these
    work = {  # kernel: (flops per unpadded pair / D, bytes)
        "flash_fwd": (4, 2 * act + fixed + rows),
        "flash_fwd_bf16": (4, 2 * act + fixed + rows),
        "flash_dkdv": (8, 2 * act + 2 * act_k + fixed + 2 * rows),
        "flash_dq": (6, 3 * act + fixed + 2 * rows),
        "flash_dbias": (4, 2 * act + fixed + 2 * rows + dbias),
        "flash_bwd_dkdv": (8, 2 * act + 2 * act_k + fixed + 2 * rows),
        "flash_bwd_dq": (6, 3 * act + fixed + 2 * rows + dbias),
        "backward": (10, 3 * act + 2 * act_k + fixed + 2 * rows + dbias),
    }
    for name in TRAIN_FLASH:  # the fp16 kernels do the bf16 ones' work
        work[name.replace("_bf16", "") + "_fp16"] = work[name]
    out = {}
    for name, (per_pair, nbytes) in work.items():
        flops = per_pair * pairs * D
        t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops)
    return out


def kernel_times_ms(fn, flush, names, iters=10, windows=2):
    """Mean device time of each named kernel over ``iters`` calls of
    ``fn`` (``torch.profiler``; L2 flushed before each call).  A window
    whose trace lacks a named kernel (the card's profiler has dropped a
    window's kernel records) is profiled again, up to ``windows`` in
    all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times, seen = {}, []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            seen.append(f"{e.key[:60]} x{e.count}")
            for name in names:
                if f"{name}_kernel" in e.key:
                    times[name] = e.self_device_time_total / 1e3 / e.count
        missing = [n for n in names if n not in times]
        if not missing:
            return times
        print(f"kernel_times_ms: no device time for {missing} in a "
              f"window that saw {seen}", file=sys.stderr, flush=True)
    raise AssertionError(f"profiler saw no device time for {missing} in "
                         f"{windows} windows")


def sdpa_yardsticks(sdpa, sdpa_fwd_bwd, operands, flush, iters):
    """SDPA on the same call with its default backend (named as
    ``torch._fused_sdp_choice`` picks it) and pinned to cuDNN attention,
    forward and forward + backward; where cuDNN refuses this bias,
    padding and dropout, its refusal instead of times."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qh, kh, vh, mask, scale = operands
    names = {int(v.value): k for k, v in SDPBackend.__members__.items()}
    choice = int(torch._fused_sdp_choice(qh, kh, vh, mask, FLASH_P, False,
                                         scale=scale))
    out = {"default": {"backend": names.get(choice, str(choice)),
                       "fwd_ms": time_ms(sdpa, flush, iters=iters),
                       "fwd_bwd_ms": time_ms(sdpa_fwd_bwd, flush,
                                             iters=iters)}}
    with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
        try:  # the yardstick's own dispatch: cuDNN may refuse the call
            sdpa_fwd_bwd()
        except RuntimeError as e:
            out["cudnn"] = {"refused": str(e).strip().splitlines()[0][:200]}
        else:
            out["cudnn"] = {"fwd_ms": time_ms(sdpa, flush, iters=iters),
                            "fwd_bwd_ms": time_ms(sdpa_fwd_bwd, flush,
                                                  iters=iters)}
    return out


def flash_case(flush, dtype, shape, with_bias, rng, iters, causal=False,
               tk=None, yardsticks=True):
    """The flash kernels of one call vs their plain versions on the same
    tensors — in bf16 and fp16 the plain versions round p, p_drop and dS
    as the kernels do: the forward (out within 1e-4 in fp32, and within
    FLASH_REL_TOL of its max in bf16 and fp16; lse within 1e-4 and 2e-4),
    the backward fed the plain forward's lse and delta (each grad within
    1e-3 of its max in fp32, FLASH_REL_TOL in bf16 and fp16); two forward
    and two backward calls bit for bit; kernel
    times (``torch.profiler``) beside their bounds, the plain versions'
    and SDPA's (same bias + pad mask and dropout rate, its
    memory-efficient backend; a yardstick the port never calls).
    ``iters``: kernel, plain and SDPA timing iterations.  ``causal``: the
    LM's call, the causal mask folded into SDPA's too, and with a bias
    the kernels' dbias exactly 0 above the diagonal (the dq kernel's
    partials of the key tiles it skips are written 0).  ``tk``:
    cross-attention's key count, Tq = shape[2] (see ``flash_operands``).
    ``yardsticks`` False: SDPA with its default backend and cuDNN's are
    not timed (the pinned backend is)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from unicore_tpu_torch.ops import flash_attention as fa

    B, H, T, D = shape
    q, k, v, bias, pad, seed, dout, npad = flash_operands(rng, dtype, shape,
                                                          with_bias, tk)
    tk = T if tk is None else tk
    label = f"{dtype} {shape}" + ("" if tk == T else f" Tk={tk}")
    geom = fa.geometry(T, tk, bias)
    scale = D ** -0.5
    args = (pad, FLASH_P, seed, causal, scale, geom)

    def kernel_fwd():
        return fa.flash_fwd_cuda(q, k, v, bias, *args)

    def plain_fwd():
        return fa.flash_fwd_plain(q, k, v, bias, *args)

    (out_k, lse_k), again = kernel_fwd(), kernel_fwd()
    out_p, lse_p = plain_fwd()
    torch.cuda.synchronize()
    for what, a, b in zip(("out", "lse"), (out_k, lse_k), again):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two forward calls "
                                 f"differ in {what}")
    delta = (dout.float() * out_p.float()).sum(dim=-1).transpose(
        1, 2).contiguous()

    def kernel_bwd():
        return fa.flash_bwd_cuda(q, k, v, bias, *args, lse_p, delta, dout,
                                 with_bias)

    def plain_bwd():
        return fa.flash_bwd_plain(q, k, v, bias, *args, lse_p, delta, dout,
                                  with_bias)

    got, again, want = kernel_bwd(), kernel_bwd(), plain_bwd()
    torch.cuda.synchronize()
    for what, a, b in zip(("dq", "dk", "dv", "dbias"), got, again):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{label}: two backward calls "
                                 f"differ in {what}")
    if causal and with_bias:  # the dq kernel writes skipped tiles' 0s
        above = torch.ones(T, T, dtype=torch.bool, device="cuda").triu(1)
        nonzero = int((got[3][:, above] != 0).sum())
        if nonzero:
            raise AssertionError(f"{label}: {nonzero} dbias "
                                 "elements above the diagonal are not 0")
    fp32 = dtype == torch.float32
    errs = {}
    for what, g, w in zip(("out", "lse", "dq", "dk", "dv", "dbias"),
                          (out_k, lse_k) + got, (out_p, lse_p) + want):
        if w is None:
            continue
        g, w = g.float(), w.float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{label} {what}: non-finite values")
        err = float((g - w).abs().max())
        scale_w = float(w.abs().max())
        rel_out, rel_grad = FLASH_REL_TOL.get(dtype, (None, 1e-3))
        if what == "out":
            tol = TOL if fp32 else rel_out * scale_w
        elif what == "lse":
            tol = TOL if fp32 else 2e-4
        else:
            tol = rel_grad * scale_w
        if err > tol:
            raise AssertionError(f"{label} {what}: max |kernel - "
                                 f"plain| {err} > {tol}")
        errs[what] = err
    fwd = FWD_KERNEL[dtype]
    bwd = tuple(n for n in BWD_KERNELS[dtype]
                if with_bias or n != "flash_dbias")
    kernel_iters, plain_iters, sdpa_iters = iters
    ms = kernel_times_ms(lambda: (kernel_fwd(), kernel_bwd()), flush,
                         (fwd,) + bwd, kernel_iters)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = torch.where(pad[:, None, None, :] > 0, -1e30, 0.0).to(dtype)
    if with_bias:
        mask = bias + mask
    if causal:
        mask = mask + torch.full((T, T), -1e30, device=mask.device).triu(
            1).to(dtype)

    def sdpa():
        return F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, dropout_p=FLASH_P, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qh, kh, vh), dout.transpose(1, 2))

    groups = None if fp32 else fa.pick_groups(B, T, H, D, with_bias)
    bounds = flash_bounds(npad, q.element_size(), shape, with_bias, causal,
                          tk)
    with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
        sdpa_ms = {"sdpa_fwd_ms": time_ms(sdpa, flush, iters=sdpa_iters),
                   "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, flush,
                                              iters=sdpa_iters)}
    sdpa_ms["sdpa_other"] = (sdpa_yardsticks(
        sdpa, sdpa_fwd_bwd, (qh, kh, vh, mask, scale), flush, sdpa_iters)
        if yardsticks else None)
    shape_report = {"B": B, "H": H, "T": T, "D": D, "bias": with_bias}
    if tk != T:
        shape_report.update(Tq=T, Tk=tk)
    report = {
        "dtype": str(dtype).replace("torch.", ""),
        "shape": shape_report,
        "causal": causal,
        "reference_blocks": list(geom), "dq_groups": groups,
        "max_abs_err": errs, "fwd_bit_identical": True,
        "bwd_bit_identical": True,
        "kernels": {n: {"ms": ms[n], "bound_ms": bounds[n][0],
                        "bound_by": bounds[n][1],
                        # on the unpadded pairs the bound counts
                        "tflops": bounds[n][2] / ms[n] / 1e9}
                    for n in ms},
        "bwd_kernels_ms": sum(ms[n] for n in bwd),
        # the least time of the whole backward, beside bwd_kernels_ms
        "bwd_bound_ms": bounds["backward"][0],
        "bwd_bound_by": bounds["backward"][1],
        # the wrapper's whole backward: the kernels, the dbias partials'
        # sum and the allocations (CUDA events)
        "bwd_call_ms": time_ms(kernel_bwd, flush, iters=kernel_iters),
        "plain_fwd_ms": time_ms(plain_fwd, flush, iters=plain_iters),
        "plain_bwd_ms": time_ms(plain_bwd, flush, iters=plain_iters),
        **sdpa_ms, "sdpa_backend": SDPA_BACKEND,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "padded_keys": int(npad.sum()),
    }
    if causal and with_bias:
        report["dbias_above_diagonal_nonzero"] = 0
    del q, k, v, bias, dout, out_p, lse_p, got, again, want, mask
    torch.cuda.empty_cache()
    return report


def dtype_turns(flush, shape, with_bias, seed_rng, iters=10):
    """The bf16 and the fp16 tensor-core kernels on the same operands
    (rounded to each type), timed in turns in one call — bf16, fp16,
    fp16, bf16 — each turn the three kernels' mean device time over
    ``iters`` calls (``torch.profiler``), so that a difference between the
    types reads apart from the card's drift."""
    from unicore_tpu_torch.ops import flash_attention as fa

    T, D = shape[2], shape[3]
    calls = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, bias, pad, seed, dout, _ = flash_operands(
            np.random.default_rng(seed_rng), dtype, shape, with_bias)
        args = (pad, FLASH_P, seed, False, D ** -0.5, fa.geometry(T, T, bias))
        out, lse = fa.flash_fwd_cuda(q, k, v, bias, *args)
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(
            1, 2).contiguous()
        calls[dtype] = (lambda q=q, k=k, v=v, bias=bias, args=args, lse=lse,
                        delta=delta, dout=dout: (
            fa.flash_fwd_cuda(q, k, v, bias, *args),
            fa.flash_bwd_cuda(q, k, v, bias, *args, lse, delta, dout,
                              with_bias)))
    turns = []
    for dtype in (torch.bfloat16, torch.float16, torch.float16,
                  torch.bfloat16):
        names = (FWD_KERNEL[dtype],) + BWD_KERNELS[dtype]
        turns.append({"dtype": str(dtype).replace("torch.", ""),
                      **kernel_times_ms(calls[dtype], flush, names, iters)})
    del calls
    torch.cuda.empty_cache()
    return turns


def same_keep_pattern(shape, with_bias, seed_rng):
    """Whether bf16 and fp16 operands drawn from the same seed get the
    same dropout keep pattern: the same per-row seeds and the same
    reference block geometry (both bias types are 2 bytes), hence the
    same mask — which each kernel's agreement with its plain version
    then shows the kernel draws."""
    from unicore_tpu_torch.ops import flash_attention as fa

    B, H, T, _ = shape
    masks = []
    for dtype in (torch.bfloat16, torch.float16):
        ops = flash_operands(np.random.default_rng(seed_rng), dtype, shape,
                             with_bias)
        geom = fa.geometry(T, T, ops[3])
        masks.append(fa.keep_mask(ops[5], H, T, T, geom, 1.0 - FLASH_P))
    return bool(torch.equal(*masks))


def flash_phase(flush):
    """The flash kernels vs their plain versions at the BERT shapes, in
    fp32, bf16 and fp16 (the same operands, rounded to each type);
    returns {dtype: report}."""
    reports = {}
    shape = (FLASH_B, FLASH_H, FLASH_T, FLASH_D)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        report = flash_case(flush, dtype, shape, True,
                            np.random.default_rng(512), (10, 10, 20))
        if dtype == torch.float16:
            report["keep_pattern_equals_bf16"] = same_keep_pattern(
                shape, True, 512)
            if not report["keep_pattern_equals_bf16"]:
                raise AssertionError("fp16 and bf16 keep patterns differ")
            report["turns_ms"] = dtype_turns(flush, shape, True, 512)
        emit("flash", **report)
        reports[report["dtype"]] = report
    return reports


# (name, (B, H, T, D), with a [1, H, T, T] bias): T=1024 has one key
# block in the reference's geometry (its joint dq/dk/dv backward), T=2048
# with a bias two (its two-pass dq and dk/dv and the dbias pass)
MB_CASES = (("t1024_nobias", (4, 12, 1024, 64), False),
            ("t2048_bias", (2, 12, 2048, 64), True))


def flash_multiblock_phase(flush):
    """The flash kernels at the shapes that take the JAX package's
    multi-block kernels (rows 2 and 4-7), bf16 and fp16, dropout 0.1;
    returns {case: report}, the fp16 cases' names ending in _fp16."""
    from unicore_tpu_torch.ops import flash_attention as fa

    reports = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float16, "_fp16")):
        for name, shape, with_bias in MB_CASES:
            T, D = shape[2], shape[3]
            geom = fa.pick_blocks(T, T, 2 if with_bias else 0)
            n_q, n_k = T // geom[0], T // geom[1]
            # the JAX backward's routing
            # (ops/pallas/flash_attention.py:870-896)
            joint = n_k == 1 and n_q > 1 and 2 * T * D * 4 <= (6 << 20)
            if n_q == 1 or joint == with_bias:
                raise AssertionError(f"{name}: reference blocks {geom} do "
                                     "not take the multi-block kernels "
                                     "meant")
            report = flash_case(flush, dtype, shape, with_bias,
                                np.random.default_rng(T), (5, 3, 10))
            report["joint_backward"] = joint
            if suffix:
                report["keep_pattern_equals_bf16"] = same_keep_pattern(
                    shape, with_bias, T)
                if not report["keep_pattern_equals_bf16"]:
                    raise AssertionError(f"{name}: fp16 and bf16 keep "
                                         "patterns differ")
                report["turns_ms"] = dtype_turns(flush, shape, with_bias, T,
                                                 iters=5)
            emit("flash_multiblock", case=name + suffix, **report)
            reports[name + suffix] = report
    return reports


# (name, operand type, with the [1, H, T, T] rel-pos bias, timing iters):
# the LM's causal call at transformer_lm_base's shape — bf16 with the
# rel-pos bias and without one (rotary), fp16 and fp32 once each
CAUSAL_CASES = (("bf16_bias", torch.bfloat16, True, (10, 5, 10)),
                ("bf16_nobias", torch.bfloat16, False, (10, 5, 10)),
                ("fp16_bias", torch.float16, True, (5, 3, 5)),
                ("fp32_bias", torch.float32, True, (5, 3, 5)))
def keep_bits(dtype, shape, with_bias, seed_rng, causal=True, tk=None):
    """The forward kernel's keep bits read back exactly
    (``fa.kernel_keep_bits``) under the case's tail padding and per-row
    seeds (and causal, or at cross-attention's ``tk`` keys).  Returns the
    count of admitted (query, key) pairs read and of those whose bit
    differs from the plain version's mask (the reference's draw); a key
    the causal or padding mask excludes must read 0."""
    from unicore_tpu_torch.ops import flash_attention as fa

    B, H, T, D = shape
    tk = T if tk is None else tk
    _, _, _, bias, pad, seed, _, _ = flash_operands(
        np.random.default_rng(seed_rng), dtype, shape, with_bias,
        None if tk == T else tk)
    bits, admitted = fa.kernel_keep_bits((B, T, H, D), tk, dtype, bias, pad,
                                         seed, FLASH_P, causal)
    want = fa.keep_mask(seed, H, T, tk, fa.geometry(T, tk, bias),
                        1.0 - FLASH_P) & admitted
    return {"pairs_read": int(admitted.sum()) * H,
            "bits_differ": int((bits != want).sum()),
            "excluded_read_nonzero": int((bits & ~admitted).sum())}


def flash_causal_phase(flush):
    """Rows 3 and 8's kernels on the LM's causal call at
    transformer_lm_base's shape (B 16, H 12, T 512, D 64, 0-200 padded
    keys a row, dropout 0.1): each case held against the plain version
    as ``flash_case`` holds it, its forward's keep bits read back exactly
    (``keep_bits``), the dbias above the diagonal exactly 0 (the
    dq kernel's partials of the key tiles it skips are written 0), times
    beside the causal bound and SDPA with the same mask folded in;
    returns {case: report}."""
    shape = (FLASH_B, FLASH_H, FLASH_T, FLASH_D)
    reports = {}
    for name, dtype, with_bias, iters in CAUSAL_CASES:
        report = flash_case(flush, dtype, shape, with_bias,
                            np.random.default_rng(4096), iters, causal=True)
        keep = keep_bits(dtype, shape, with_bias, 4096)
        if keep["bits_differ"] or keep["excluded_read_nonzero"]:
            raise AssertionError(f"{name}: keep bits {keep}")
        report["keep_bits"] = keep
        emit("flash_causal", case=name, card=card(), **report)
        reports[name] = report
    return reports


# cross-attention's call: Tq decoder queries over Tk encoder keys, B 8,
# H 12, D 64, a [1, H, Tq, Tk] bias, up to 40% of each row's keys padded,
# dropout 0.1: (name, Tq, Tk, operand types, the reference's (query,
# key) block counts at that bias, timing iters).  256/512, 128/1024 and
# 512/128 take one reference block (rows 3 and 8); 1024/128 two query
# blocks over one key block (its joint backward, row 4; forward row 2);
# 256/4096 two key blocks of 2,048 (its two-pass dq and dk/dv and the
# dbias pass, rows 5-7; forward row 2).  SDPA's default backend and
# cuDNN are timed at 256/512.
CROSS_B = 8
CROSS_TYPES = (torch.bfloat16, torch.float16, torch.float32)
CROSS_CASES = (("q256_k512", 256, 512, CROSS_TYPES, (1, 1), (10, 3, 10)),
               ("q128_k1024", 128, 1024, CROSS_TYPES, (1, 1), (10, 3, 5)),
               ("q512_k128", 512, 128, CROSS_TYPES, (1, 1), (10, 3, 5)),
               ("q1024_k128", 1024, 128, CROSS_TYPES[:2], (2, 1),
                (5, 2, 3)),
               ("q256_k4096", 256, 4096, CROSS_TYPES[:2], (1, 2),
                (5, 2, 3)))


def flash_cross_phase(flush):
    """The flash kernels at cross-attention's Tq != Tk (CROSS_CASES), each
    case in its types held against the plain version as ``flash_case``
    holds it (forward; dk/dv over key tiles; dq with the dbias partials
    over query tiles), its forward's keep bits read back exactly at the
    reference's geometry for (Tq, Tk) (``keep_bits``), times beside the
    bytes and operations bounds, the plain versions and SDPA with the
    same mask; returns {case: {dtype: report}}."""
    from unicore_tpu_torch.ops import flash_attention as fa

    reports = {}
    for name, tq, tk, dtypes, blocks, iters in CROSS_CASES:
        shape = (CROSS_B, FLASH_H, tq, FLASH_D)
        reports[name] = {}
        for dtype in dtypes:
            itemsize = torch.tensor([], dtype=dtype).element_size()
            bq, bk = fa.pick_blocks(tq, tk, itemsize)
            if (tq // bq, tk // bk) != blocks:
                raise AssertionError(f"{name}: reference blocks {(bq, bk)} "
                                     f"are not the {blocks} meant")
            report = flash_case(flush, dtype, shape, True,
                                np.random.default_rng(tq + tk), iters,
                                tk=tk, yardsticks=name == "q256_k512")
            keep = keep_bits(dtype, shape, True, tq + tk, causal=False,
                             tk=tk)
            if keep["bits_differ"] or keep["excluded_read_nonzero"]:
                raise AssertionError(f"{name} {dtype}: keep bits {keep}")
            report["keep_bits"] = keep
            emit("flash_cross", case=name, card=card(), **report)
            reports[name][report["dtype"]] = report
    return reports


# the Evoformer's attention shapes at S=128, R=256 (c_m 256 over 8 heads,
# c_z 128 over 4): (name, x [1, G, H, Q, K], with the pair bias), and
# Uni-Mol's scores at --max-atoms 256, batch 16, 64 heads ([B, H, N, N],
# its per-batch pair bias of the same shape, no mask)
SD_P = 0.1
SD_CASES = (("row", (1, 128, 8, 256, 256), True),
            ("column", (1, 256, 8, 128, 128), False),
            ("triangle", (1, 256, 4, 256, 256), True),
            ("unimol", (16, 64, 256, 256), True))
SD_DTYPES = {"unimol": (torch.bfloat16, torch.float16)}  # else all three
SD_TURNS = ("triangle", "unimol")  # bf16 and fp16 timed in turns
# the element-by-element backward this kernel replaced, at these cases,
# as PERF.md's row 10 records it in brackets (H100 80GB HBM3, 700 W):
# reported beside this run's time, not measured by it
SD_BWD_REPLACED_MS = {"float32": {"row": 0.341, "column": 0.162,
                             "triangle": 0.342},
                 "bfloat16": {"row": 0.287, "column": 0.136,
                              "triangle": 0.287}}


def sd_operands(name, shape, with_bias, dtype):
    """x, g, mask and bias of one softmax_dropout case, drawn in fp32 from
    a generator seeded by the case and rounded to ``dtype`` (so the types
    see the same values).  Evoformer cases: an fp32 MSA / pair mask (a
    random tail of keys per group at -1e9) and the pair bias [1, 1, H, Q,
    K]; Uni-Mol: no mask, the bias of x's shape."""
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if name == "unimol":
        bias = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x, g, None, bias
    _, G, H, Q, K = shape
    valid = torch.randint(K // 2, K + 1, (G,), generator=gen, device="cuda")
    cols = torch.arange(K, device="cuda")
    mask = torch.where(cols[None, :] < valid[:, None], 0.0,
                       -1e9).reshape(1, G, 1, 1, K)
    bias = (torch.randn((1, 1, H, Q, K), generator=gen,
                        device="cuda").to(dtype) if with_bias else None)
    return x, g, mask, bias


def ulp_distance(a, b, dtype=torch.float16):
    """max |a - b| over the elements in ``dtype``'s ulps at b's magnitude
    (its subnormal spacing below its least normal: fp16's 2^-24)."""
    fi = torch.finfo(dtype)
    mag = b.float().abs()
    ulp = torch.where(mag < fi.tiny, torch.full_like(mag, fi.tiny * fi.eps),
                      torch.exp2(torch.floor(torch.log2(mag))) * fi.eps)
    return float(((a.float() - b.float()).abs() / ulp).max())


def softmax_dropout_phase(flush):
    """The softmax_dropout kernels vs their plain versions at the
    Evoformer shapes (fp32, bf16, fp16) and Uni-Mol's (bf16, fp16);
    returns {dtype: {case: report}, "turns": {case: [...]}}."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    reports = {}
    for name, shape, with_bias in SD_CASES:
        for dtype in SD_DTYPES.get(name, (torch.float32, torch.bfloat16,
                                          torch.float16)):
            dt = str(dtype).replace("torch.", "")
            x, g, mask, bias = sd_operands(name, shape, with_bias, dtype)
            q_blk = sd.pick_q_blk_for(x, mask, bias)
            seed = torch.tensor([1234567], dtype=torch.int32, device="cuda")

            def kernel_fwd():
                return sd.softmax_dropout_fwd_cuda(x, mask, bias, SD_P, seed,
                                                   q_blk, True)

            def plain_fwd():
                return sd.softmax_dropout_fwd_plain(x, mask, bias, SD_P,
                                                    seed, q_blk, True)

            (out_k, sm_k), (out_p, sm_p) = kernel_fwd(), plain_fwd()

            def kernel_bwd():
                return sd.softmax_dropout_bwd_cuda(g, sm_k, SD_P, seed,
                                                   q_blk)

            def plain_bwd():
                return sd.softmax_dropout_bwd_plain(g, sm_p, SD_P, seed,
                                                    q_blk)

            dx_k, dx_p = kernel_bwd(), plain_bwd()
            again = (*kernel_fwd(), kernel_bwd())
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(
                    again, (out_k, sm_k, dx_k))):
                raise AssertionError(f"{dt} {name}: two calls differ")
            del again
            if not torch.equal(out_k == 0, out_p == 0):
                n = int(((out_k == 0) != (out_p == 0)).sum())
                raise AssertionError(f"{dt} {name}: keep patterns differ "
                                     f"at {n} elements")
            # dx and dbias exactly on the backward's keep bits: against the
            # plain backward of the kernel's own softmax, element by element
            # (a non-finite element fails too); a bias of x's shape gets
            # dx itself
            dbias = (sd._reduce_to(dx_k, bias.shape, bias.dtype)
                     if with_bias else None)
            if with_bias and bias.shape == x.shape \
                    and dbias.data_ptr() != dx_k.data_ptr():
                raise AssertionError(f"{dt} {name}: dbias is not dx")
            errs = sd.check_backward(dx_k, g, sm_k, SD_P, seed, q_blk,
                                     dbias=dbias)
            ulps = {}
            for what, a, b in (("out", out_k, out_p),
                               ("softmax", sm_k, sm_p), ("dx", dx_k, dx_p)):
                a, b = a.float(), b.float()
                if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                    raise AssertionError(f"{dt} {name} {what}: non-finite")
                err = float((a - b).abs().max())
                scale = float(b.abs().max())
                if dtype == torch.float16 and what != "dx":
                    ulps[what] = ulp_distance(a, b)
                    ok = ulps[what] <= 1.0
                    limit = "one fp16 ulp"
                else:
                    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
                           torch.float16: 2e-3}[dtype]
                    tol = tol if dtype == torch.float32 else tol * scale
                    ok, limit = err <= tol, tol
                if not ok:
                    raise AssertionError(f"{dt} {name} {what}: max |kernel "
                                         f"- plain| {err} > {limit}")
                errs[what if what != "dx" else "dx_vs_plain"] = err
            ms = kernel_times_ms(
                lambda: (kernel_fwd(), kernel_bwd()), flush,
                ("softmax_dropout_fwd", "softmax_dropout_bwd"), iters=10)
            # the library yardstick: torch's softmax of the scores with
            # mask and bias already added, and its backward — not the same
            # function (no dropout, no fused adds); the port never calls it
            pre = x.float()
            for op in (mask, bias):
                if op is not None:
                    pre = pre + op.float()
            pre = pre.to(dtype)
            y_lib = torch.softmax(pre, dim=-1)
            item = x.element_size()
            nbytes = {"fwd": (3 * x.numel() * item
                              + sum(op.numel() * op.element_size()
                                    for op in (mask, bias) if op is not None)),
                      "bwd": 3 * x.numel() * item}
            bound = {kind: n / HBM_BYTES_PER_S * 1e3
                     for kind, n in nbytes.items()}
            report = {
                "shape": list(shape), "q_blk": q_blk, "max_abs_err": errs,
                "dropped_share": float((out_k == 0).float().mean()),
                "fwd_ms": ms["softmax_dropout_fwd"],
                "bwd_ms": ms["softmax_dropout_bwd"],
                "bound_fwd_ms": bound["fwd"],
                "bound_bwd_ms": bound["bwd"],
                "fwd_share_of_bound": bound["fwd"]
                / ms["softmax_dropout_fwd"],
                "bwd_share_of_bound": bound["bwd"]
                / ms["softmax_dropout_bwd"],
                "plain_fwd_ms": time_ms(plain_fwd, flush, iters=3),
                "plain_bwd_ms": time_ms(plain_bwd, flush, iters=3),
                "library_fwd_ms": time_ms(
                    lambda: torch.softmax(pre, dim=-1), flush, iters=10),
                "library_bwd_ms": time_ms(
                    lambda: torch._softmax_backward_data(g, y_lib, -1,
                                                         dtype),
                    flush, iters=10),
            }
            if ulps:
                report["max_fp16_ulps"] = ulps
            recorded = SD_BWD_REPLACED_MS.get(dt, {}).get(name)
            if recorded is not None:
                report["replaced_bwd_ms_recorded"] = recorded
            emit("softmax_dropout", dtype=dt, case=name, **report)
            reports.setdefault(dt, {})[name] = report
            del x, g, mask, bias, out_k, sm_k, out_p, sm_p, dx_k, dx_p
            del pre, y_lib, dbias
            torch.cuda.empty_cache()
    reports["turns"] = {name: softmax_dropout_turns(flush, name)
                        for name in SD_TURNS}
    emit("softmax_dropout_turns", turns=reports["turns"])
    return reports


def softmax_dropout_turns(flush, name):
    """The bf16 and fp16 kernels on one case's operands (the same values
    rounded to each type), forward and backward timed in turns in one
    call — bf16, fp16, fp16, bf16 — each turn the two kernels' mean device
    time over 10 calls."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    shape, with_bias = {n: (s, b) for n, s, b in SD_CASES}[name]
    calls = {}
    for dtype in (torch.bfloat16, torch.float16):
        x, g, mask, bias = sd_operands(name, shape, with_bias, dtype)
        seed = torch.tensor([1234567], dtype=torch.int32, device="cuda")
        q_blk = sd.pick_q_blk_for(x, mask, bias)
        _, sm = sd.softmax_dropout_fwd_cuda(x, mask, bias, SD_P, seed, q_blk,
                                            True)
        calls[dtype] = (lambda x=x, g=g, mask=mask, bias=bias, seed=seed,
                        q_blk=q_blk, sm=sm: (
            sd.softmax_dropout_fwd_cuda(x, mask, bias, SD_P, seed, q_blk,
                                        True),
            sd.softmax_dropout_bwd_cuda(g, sm, SD_P, seed, q_blk)))
    turns = []
    for dtype in (torch.bfloat16, torch.float16, torch.float16,
                  torch.bfloat16):
        turns.append({"dtype": str(dtype).replace("torch.", ""),
                      **kernel_times_ms(calls[dtype], flush, (
                          "softmax_dropout_fwd", "softmax_dropout_bwd"))})
    del calls
    torch.cuda.empty_cache()
    return turns


def softmax_dropout_route_case(flush):
    """An Evoformer row attention at R = 200 (keys off the kernels' 128
    grid), bf16, mask and pair bias, dropout 0.1, through the public
    ``softmax_dropout`` with autograd: the reference's dispatch sends it
    to its jnp path, so the card runs the plain version as torch ops —
    counted in ``plain_route`` (forward and backward once each), no
    kernel launched — and it equals the same call on the CPU (equal keep
    pattern; out, dx and dbias within 1e-2 of each tensor's max)."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    shape = (1, 16, 8, 200, 200)
    gen = torch.Generator(device="cuda").manual_seed(200)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    mask = torch.where(torch.rand((1, 16, 1, 1, 200), generator=gen,
                                  device="cuda") > 0.1, 0.0, -1e9)
    bias = torch.randn((1, 1, 8, 200, 200), generator=gen,
                       device="cuda").bfloat16()
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def run(x, mask, bias, g):
        x, bias = (t.detach().requires_grad_() for t in (x, bias))
        out = sd.softmax_dropout(x, SD_P, mask=mask, bias=bias, seed=4242)
        return (out, *torch.autograd.grad(out, (x, bias), g))

    if sd.route(x, mask, bias) != "plain":
        raise AssertionError("k = 200 must take the plain route")
    before = dict(sd.launches), dict(sd.plain_route)
    got = run(x, mask, bias, g)
    torch.cuda.synchronize()
    ran = {n: (sd.launches[n] - before[0][n], sd.plain_route[n] - before[1][n])
           for n in sd.launches}
    if ran != {"softmax_dropout_fwd": (0, 1), "softmax_dropout_bwd": (0, 1)}:
        raise AssertionError(f"(launches, plain route) {ran}")
    want = run(*(t.cpu() for t in (x, mask, bias, g)))
    if not torch.equal(got[0].cpu() == 0, want[0] == 0):
        raise AssertionError("plain route: keep patterns differ from CPU")
    errs = {}
    for what, a, b in zip(("out", "dx", "dbias"), got, want):
        a, b = a.detach().float().cpu(), b.detach().float()
        err = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and err <= 1e-2 * float(
                b.abs().max())):
            raise AssertionError(f"plain route {what}: max |card - cpu| "
                                 f"{err}")
        errs[what] = err
    return {"shape": list(shape), "route": "plain", "calls": ran,
            "max_abs_err": errs,
            "fwd_bwd_ms": time_ms(lambda: run(x, mask, bias, g), flush,
                                  iters=5)}


# (name, elements): Evoformer leaves (65,536: r_blk 8; 262,144, the
# largest leaf: r_blk 256), a size not a multiple of 1024, and 16M
SR_SIZES = (("leaf_65536", 1 << 16), ("leaf_262144", 1 << 18),
            ("odd_1000003", 1000003), ("large_16777216", 1 << 24))


def rounding_phase(flush):
    """The stochastic-rounding kernel vs its plain version, bit for bit,
    and the mean of 2^24 draws of one value; returns {case: report}."""
    from unicore_tpu_torch.ops import rounding as sr

    gen = torch.Generator(device="cuda").manual_seed(11)
    seed = torch.tensor([-987654], dtype=torch.int32, device="cuda")
    cases = {}
    for name, n in SR_SIZES:
        x = (torch.randn(n, generator=gen, device="cuda")
             * torch.exp(4 * torch.randn(n, generator=gen, device="cuda")))
        x[:6] = torch.tensor([float("nan"), -float("nan"), float("inf"),
                              -float("inf"), 0.0, -0.0], device="cuda")
        got = sr.fp32_to_bf16_sr_cuda(x, seed)
        want = sr.fp32_to_bf16_sr_plain(x, seed)
        torch.cuda.synchronize()
        diff = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        if diff:
            raise AssertionError(f"rounding {name}: {diff} elements differ "
                                 "from the plain version")
        ms = kernel_times_ms(lambda: sr.fp32_to_bf16_sr_cuda(x, seed),
                             flush, ("fp32_to_bf16_sr",), iters=20)
        cases[name] = {
            "n": n, "r_blk": sr.pick_layout(n)[1], "mismatches": diff,
            "ms": ms["fp32_to_bf16_sr"],
            "bound_ms": 6 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "plain_ms": time_ms(lambda: sr.fp32_to_bf16_sr_plain(x, seed),
                                flush, iters=5),
            "library_ms": None,
        }
        emit("rounding", case=name, **cases[name])
    # unbiased: the mean of 2^24 draws of one value lies within 3 sigma
    x0 = 1.2345678
    xs = torch.full((1 << 24,), x0, device="cuda")
    mean = float(sr.fp32_to_bf16_sr_cuda(xs, seed).double().mean())
    x32 = float(np.float32(x0))
    lo = float(torch.tensor(x32).view(torch.int32).bitwise_and(
        -65536).view(torch.float32))
    ulp = 2.0 ** -7                    # bf16 spacing in [1, 2)
    p_up = (x32 - lo) / ulp
    sigma = ulp * np.sqrt(p_up * (1 - p_up) / xs.numel())
    if abs(mean - x32) > 3 * sigma:
        raise AssertionError(f"SR mean {mean} of {x32}: off by "
                             f"{abs(mean - x32) / sigma:.2f} sigma")
    emit("rounding_mean", value=x32, draws=xs.numel(), mean=mean,
         sigma=sigma, off_sigmas=abs(mean - x32) / sigma)
    cases["table"] = rounding_table_case(flush)
    emit("rounding", case="table", **cases["table"])
    return cases


def evoformer_leaf_sizes():
    """The parameter leaves' sizes of the smoke's ``evoformer_base`` (8
    blocks, c_m 256, c_z 128, 8 MSA and 4 pair heads; the corpus's 8
    MSA letters and 8 pair bins), in the trainer's order."""
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel

    with torch.device("meta"):
        model = EvoformerModel(8, 8, evoformer_layers=8, msa_embed_dim=256,
                               pair_embed_dim=128, msa_attention_heads=8,
                               pair_attention_heads=4, opm_hidden_dim=16)
    return [p.numel() for p in model.parameters()]


def rounding_table_case(flush):
    """The optimizer's SR sync at ``evoformer_base``: every leaf in one
    table launch, bit for bit the per-leaf plain version under each
    leaf's seed; its time beside the bytes bound and beside the old
    design, one single-entry launch a leaf over the same leaves, both
    measured here (device time by the profiler, the call's whole time
    by CUDA events)."""
    from unicore_tpu_torch.ops import prng
    from unicore_tpu_torch.ops import rounding as sr

    sizes = evoformer_leaf_sizes()
    gen = torch.Generator(device="cuda").manual_seed(688)
    xs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    xs[0][:4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                              -0.0], device="cuda")
    seeds = prng.draw_seeds(gen, (len(sizes),))
    outs = [torch.empty(n, dtype=torch.bfloat16, device="cuda")
            for n in sizes]
    before = sr.launches["fp32_to_bf16_sr"]
    sr.fp32_to_bf16_sr_multi(xs, seeds, outs)
    table_launches = sr.launches["fp32_to_bf16_sr"] - before
    want = [torch.empty_like(o) for o in outs]
    sr.fp32_to_bf16_sr_multi_plain(xs, seeds, want)
    torch.cuda.synchronize()
    diff = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
               for a, b in zip(outs, want))
    if diff:
        raise AssertionError(f"rounding table: {diff} elements differ from "
                             "the per-leaf plain version")

    def table():
        sr.fp32_to_bf16_sr_multi(xs, seeds, outs)

    def per_leaf():
        for i, (x, out) in enumerate(zip(xs, outs)):
            sr.fp32_to_bf16_sr_cuda(x, seeds[i:i + 1], out)

    def device_ms(fn, launches, iters):
        """Device time of the kernel's ``launches`` in one call of fn."""
        return launches * kernel_times_ms(fn, flush, ("fp32_to_bf16_sr",),
                                          iters)["fp32_to_bf16_sr"]

    n = sum(sizes)
    return {
        "leaves": len(sizes), "n": n, "mismatches": diff,
        "launches_per_call": table_launches,
        "ms": device_ms(table, table_launches, 20),
        "bound_ms": 6 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "per_leaf_launches_ms": device_ms(per_leaf, len(sizes), 3),
        "call_ms": time_ms(table, flush, iters=20),
        "per_leaf_call_ms": time_ms(per_leaf, flush, iters=3),
        "plain_ms": time_ms(lambda: sr.fp32_to_bf16_sr_multi_plain(
            xs, seeds, want), flush, iters=2),
        "library_ms": None,
    }


EMA_DECAY = 0.999  # Uni-Fold's --ema-decay


def ema_case(flush):
    """The EMA kernel over every ``evoformer_base`` leaf in one launch:
    bit for bit the CPU formula (``ema_update_plain`` on host copies of
    the same tensors), timed beside its bytes bound (8 read, 4 written
    per element), the plain version on the card, and
    ``torch._foreach_lerp_`` (one PyTorch call, the EMA of
    ``torch.optim.swa_utils``; it rounds otherwise)."""
    from unicore_tpu_torch.ops import ema

    sizes = evoformer_leaf_sizes()
    gen = torch.Generator(device="cuda").manual_seed(999)
    params = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    start = [p + 0.01 * torch.randn(n, generator=gen, device="cuda")
             for p, n in zip(params, sizes)]
    got = [e.clone() for e in start]
    before = ema.launches["ema_update"]
    ema.ema_update_(got, params, EMA_DECAY)
    launches = ema.launches["ema_update"] - before
    want = ema.ema_update_plain([e.cpu() for e in start],
                                [p.cpu() for p in params], EMA_DECAY)
    on_card = ema.ema_update_plain([e.clone() for e in start], params,
                                   EMA_DECAY)
    torch.cuda.synchronize()
    diff = sum(int((a.cpu().view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(got, want))
    diff_card = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                    for a, b in zip(got, on_card))
    if diff or diff_card:
        raise AssertionError(f"ema_update: {diff} elements differ from the "
                             f"CPU formula, {diff_card} from the plain "
                             "version on the card")
    emas = [e.clone() for e in start]
    n = sum(sizes)
    lerp_w = float(np.float32(1.0) - np.float32(EMA_DECAY))
    return {
        "leaves": len(sizes), "n": n, "decay": EMA_DECAY,
        "mismatches_cpu_formula": diff, "mismatches_plain_on_card": diff_card,
        "launches_per_call": launches,
        "ms": launches * kernel_times_ms(
            lambda: ema.ema_update_(emas, params, EMA_DECAY), flush,
            ("ema_update",), 20)["ema_update"],
        "bound_ms": 12 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "call_ms": time_ms(lambda: ema.ema_update_(emas, params, EMA_DECAY),
                           flush, iters=20),
        "plain_ms": time_ms(lambda: ema.ema_update_plain(emas, params,
                                                         EMA_DECAY),
                            flush, iters=3),
        "library_ms": time_ms(lambda: torch._foreach_lerp_(emas, params,
                                                           lerp_w),
                              flush, iters=20),
    }


HEAD_N, HEAD_D, HEAD_V = 2048, 768, 30522


def head_phase(flush):
    """The BERT masked-LM head at ``bert_base``'s shape under ``--bf16``
    (2,048 slots, width 768, tied [30,522, 768] embedding, a bias): the
    chunked cross-entropy forms each chunk's logits and dk as an fp32
    product of the bf16 operands.  Reports the kernels that product ran
    on the card, checks the per-row nll within 1e-3 nats of the fp32
    product of the same values (TF32 off), and times the head's forward
    and backward beside the same head with each product rounded to bf16
    first (the head before that repair)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.ops import fused_cross_entropy as fce

    gen = torch.Generator(device="cuda").manual_seed(HEAD_V)
    f = torch.randn((HEAD_N, HEAD_D), generator=gen,
                    device="cuda").bfloat16()
    k = (0.05 * torch.randn((HEAD_V, HEAD_D), generator=gen,
                            device="cuda")).bfloat16()
    b = (0.1 * torch.randn(HEAD_V, generator=gen, device="cuda")).bfloat16()
    t = torch.randint(0, HEAD_V, (HEAD_N,), generator=gen, device="cuda")
    w = (torch.rand(HEAD_N, generator=gen, device="cuda") < 0.6).float()
    chunk = fce._resolve_chunk(HEAD_N, HEAD_V)
    if chunk is None:
        raise AssertionError("the BERT head must take the chunked path")
    params = [a.requires_grad_() for a in (f, k, b)]

    def head():
        nll = fce.fused_linear_cross_entropy(f, k, t, bias=b, tied=True)
        return (nll, *torch.autograd.grad((nll * w).sum(), params))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        product = fce.mm32(f[:chunk].detach(), k.detach().t())
        torch.cuda.synchronize()
    kernels = sorted({e.key[:100] for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA})
    if product.dtype != torch.float32:
        raise AssertionError(f"mm32 gave {product.dtype}")
    nll = head()[0].detach()
    logits = f.detach().float() @ k.detach().float().t() + b.detach().float()
    want = torch.logsumexp(logits, -1) - logits.gather(-1, t[:, None])[:, 0]
    err = float((nll - want).abs().max())
    if not (torch.isfinite(nll).all() and err <= 1e-3):
        raise AssertionError(f"head nll off the fp32 product by {err}")
    report = {"rows": HEAD_N, "width": HEAD_D, "vocab": HEAD_V,
              "chunk": chunk, "product": "torch.mm(out_dtype=torch.float32)",
              "product_kernels": kernels, "max_abs_err_nll": err,
              "fwd_bwd_ms": time_ms(head, flush, iters=10)}
    mm32 = fce.mm32
    fce.mm32 = lambda a, c: (a @ c).float()  # rounded to bf16 first
    try:
        report["rounded_products_fwd_bwd_ms"] = time_ms(head, flush,
                                                        iters=10)
    finally:
        fce.mm32 = mm32
    return report


def write_corpus(path):
    """dict.txt whose dictionary, with the task's five specials, has
    30,522 entries, and 2,048 train records of 128-510 tokens drawn from
    a Zipf(1.1) law over the words (plus 64 valid records): the LM's
    ``make_data`` at seed 2048."""
    from unicore_tpu_torch.examples.lm import make_data

    make_data.write_corpus(path, words=30522 - 5, seed=2048)


def bert_args(corpus, logdir, updates, precision=("--bf16",),
              arch="bert_base", warmup=4):
    """The command line of the train, checkpoint and train_fp16 phases:
    full-width ``arch`` (bert_base unless given) under ``precision``
    (--bf16 unless given) on the corpus ``write_corpus`` wrote."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [
        corpus, "--user-dir",
        os.path.join(here, "unicore_tpu_torch", "examples", "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch",
        arch, "--pre-tokenized", "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6",
        "--clip-norm", "1.0", "--lr-scheduler", "polynomial_decay",
        "--lr", "1e-4", "--warmup-updates", str(warmup),
        "--total-num-update", str(TRAIN_UPDATES),
        "--batch-size", str(TRAIN_BATCH), "--update-freq", "1",
        "--seed", "1", *precision, "--max-update", str(updates),
        "--log-interval", "1", "--log-format", "none",
        "--tensorboard-logdir", logdir, "--disable-validation",
        *INLINE_DATA,
    ]


def reset_peak_memory():
    """Free what earlier phases left for the collector, then start the
    card's peak-memory count; returns the bytes still allocated, in GB."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def profile_updates(trainer, n=3, named=()):
    """Device busy and idle time, launches and top kernels of ``n`` more
    updates of ``trainer`` on epoch 2's first batches, under
    ``torch.profiler``; with ``named``, each named kernel's device time
    in the window too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    itr = trainer.get_train_iterator(epoch=2).next_epoch_itr()
    batches = [next(itr) for _ in range(n)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step([b])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {name: sum(e.self_device_time_total for e in kernels
                     if f"{name}_kernel" in e.key) / 1e3 for name in named}
    return {**({"named_ms": out} if named else {}),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def train_phase():
    """The port's CLI trains full-width bert_base under --bf16; returns
    the flash launch counts of its 20 updates and its step, memory and
    profile figures."""
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp)
        corpus_s = time.perf_counter() - t0
        logdir = os.path.join(tmp, "log")
        step_s = []
        train_step = trainer_mod.Trainer.train_step

        def timed(self, samples):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_step(self, samples)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out

        trainer_mod.Trainer.train_step = timed
        for counts in (fa.launches, sd.plain_route):
            for name in counts:
                counts[name] = 0
        start_gb = reset_peak_memory()
        t0 = time.perf_counter()
        try:
            loop = cli_main(bert_args(tmp, logdir, TRAIN_UPDATES)
                            + ["--no-save"])
        finally:
            trainer_mod.Trainer.train_step = train_step
        run_s = time.perf_counter() - t0
        launches = dict(fa.launches)
        if any(sd.plain_route.values()):
            raise AssertionError(f"softmax_dropout took the plain route on "
                                 f"the card: {sd.plain_route}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(logdir, "train_inner.jsonl")) as f:
            records = [json.loads(line) for line in f]
        nats = [r["loss"] * np.log(2) for r in records]  # logged in bits
        layers = loop.trainer.model.encoder_layers
        if len(nats) != TRAIN_UPDATES or not np.isfinite(nats).all():
            raise AssertionError(f"losses {nats}")
        if not 9.0 <= nats[0] <= 11.5:
            raise AssertionError(f"first loss {nats[0]} nats not in 9-11.5")
        if not np.mean(nats[-5:]) < nats[0]:
            raise AssertionError(f"loss did not fall: {nats}")
        # once per layer per update: the forward and the bf16 backward's
        # two kernels; the fp32 backward's three never
        want = {n: layers * TRAIN_UPDATES if n in TRAIN_FLASH else 0
                for n in launches}
        if launches != want:
            raise AssertionError(f"flash launches {launches}, want {want} "
                                 f"({layers} layers x {TRAIN_UPDATES} "
                                 "updates)")
        warm = np.array(step_s[2:])
        med_s = float(np.median(warm))
        report = {"step_ms_median": med_s * 1e3,
                  "samples_per_s": TRAIN_BATCH / med_s,
                  "tokens_per_s": TRAIN_BATCH * 512 / med_s,
                  "peak_mem_gb": peak_gb, "mem_at_start_gb": start_gb}
        emit("train", model="bert_base", dtype="bf16", batch=TRAIN_BATCH,
             seq_len=512, updates=TRAIN_UPDATES, corpus_s=corpus_s,
             run_s=run_s, losses_nats=[round(x, 4) for x in nats],
             first_loss_nats=nats[0], last5_mean_nats=float(np.mean(nats[-5:])),
             step_ms_all=[s * 1e3 for s in step_s], launches=launches,
             **report)

        # where a step's time goes: 3 more updates under the profiler
        prof = profile_updates(loop.trainer)
        emit("train_profile", window="3 updates, batch 16 x 512, bf16",
             # the parent tree's count, before the reference's Dense and
             # GELU rounding (PERF.md §5; chip_compare.py's train turns
             # measure both trees in one call)
             kernel_launches_recorded_before_c4=5397, **prof)
    return {"launches": launches, **report,
            **{k: v for k, v in prof.items() if k != "top_kernels"}}


CKPT_UPDATES, CKPT_EVERY = 10, 5
CKPT_TOL = 1e-3  # relative, per update: the card's reductions may differ


def checkpoint_phase():
    """Run A: the train phase's bert_base, 10 updates with a save every 5
    (the default async writer).  Run B: a fresh trainer restores A's
    ``checkpoint_1_5.pt`` and runs to update 10.  Raises unless every
    file's sidecar verifies and B's updates 6-10 are within CKPT_TOL of
    A's; reports whether they are bit-equal, the save's step-path stall,
    the file's bytes, the background write's and the restore's
    seconds, and the flash launches of both runs."""
    from unicore_tpu_torch import checkpoint_utils as cu
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.ops import flash_attention as fa

    Trainer, Manager = trainer_mod.Trainer, cu.CheckpointManager
    real = {"step": Trainer.train_step, "load": Trainer.load_checkpoint,
            "save": Manager.save, "write": Manager._write_and_finalize}
    losses, stall_ms, write_s, restore_s = [], [], [], []

    def step(self, samples):
        out = real["step"](self, samples)
        losses[-1].append(float(out[0]["loss"]) / float(out[0]["sample_size"]))
        return out

    def load(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["load"](self, *args, **kwargs)
        torch.cuda.synchronize()
        if out is not None:
            restore_s.append(time.perf_counter() - t0)
        return out

    def save(self, *args, **kwargs):
        saves, stall = self.saves, self.stall_s
        real["save"](self, *args, **kwargs)
        if self.saves > saves:
            stall_ms.append((self.stall_s - stall) * 1e3)

    def write(self, *args, **kwargs):  # on the writer's thread
        t0 = time.perf_counter()
        real["write"](self, *args, **kwargs)
        write_s.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp)
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        restore = os.path.join(a, f"checkpoint_1_{CKPT_EVERY}.pt")
        Trainer.train_step, Trainer.load_checkpoint = step, load
        Manager.save, Manager._write_and_finalize = save, write
        for name in fa.launches:
            fa.launches[name] = 0
        try:
            losses.append([])
            run_a = cli_main(bert_args(tmp, os.path.join(tmp, "log_a"),
                                       CKPT_UPDATES) + [
                "--save-interval-updates", str(CKPT_EVERY), "--save-dir", a,
                "--tmp-save-dir", a, "--no-last-checkpoints"])
            losses.append([])
            run_b = cli_main(bert_args(tmp, os.path.join(tmp, "log_b"),
                                       CKPT_UPDATES) + [
                "--restore-file", restore, "--save-dir", b, "--no-save"])
        finally:
            Trainer.train_step, Trainer.load_checkpoint = real["step"], \
                real["load"]
            Manager.save, Manager._write_and_finalize = real["save"], \
                real["write"]
        launches = dict(fa.launches)
        files = sorted(f for f in os.listdir(a) if f.endswith(".pt"))
        integrity = {f: cu.file_integrity(os.path.join(a, f)) for f in files}
        if files != [f"checkpoint_1_{CKPT_UPDATES}.pt",
                     f"checkpoint_1_{CKPT_EVERY}.pt"] or any(
                v != "ok" for v in integrity.values()):
            raise AssertionError(f"checkpoint files {integrity}")
        file_bytes = os.path.getsize(restore)
        la, lb = np.array(losses[0]), np.array(losses[1])
        if (len(la), len(lb)) != (CKPT_UPDATES, CKPT_UPDATES - CKPT_EVERY) \
                or not np.isfinite(la).all() or not np.isfinite(lb).all():
            raise AssertionError(f"losses A {la}, B {lb}")
        rel = np.abs(lb - la[CKPT_EVERY:]) / np.abs(la[CKPT_EVERY:])
        if not rel.max() <= CKPT_TOL:
            raise AssertionError(f"resumed losses {lb} off run A's "
                                 f"{la[CKPT_EVERY:]} by {rel.max()}")
        if run_b.trainer.get_num_updates() != CKPT_UPDATES or len(
                restore_s) != 1:
            raise AssertionError("run B did not resume from update "
                                 f"{CKPT_EVERY}")
        layers = run_a.trainer.model.encoder_layers
        runs = CKPT_UPDATES + CKPT_UPDATES - CKPT_EVERY
        want = {n: layers * runs if n in TRAIN_FLASH else 0
                for n in launches}
        if launches != want:
            raise AssertionError(f"flash launches {launches}, want {want}")
        with torch.no_grad():
            diff = max(float((p - q).abs().max()) for p, q in zip(
                run_a.trainer.model.parameters(),
                run_b.trainer.model.parameters()))
    return {"model": "bert_base", "dtype": "bf16", "batch": TRAIN_BATCH,
            "seq_len": 512, "updates": CKPT_UPDATES,
            "save_interval_updates": CKPT_EVERY, "async_save": True,
            "files": integrity, "file_bytes": file_bytes,
            "save_stall_ms": stall_ms, "background_write_s": write_s,
            "restore_s": restore_s[0], "losses_a_nats": la.tolist(),
            "losses_b_nats": lb.tolist(), "max_rel_diff": float(rel.max()),
            "tolerance": CKPT_TOL,
            "bit_equal": bool((lb == la[CKPT_EVERY:]).all()),
            "params_max_abs_diff_at_end": diff, "launches": launches}


FP16_FLAGS = ("--fp16", "--fp16-init-scale", "128")  # the reference's
FP16_SKIP_AT = 7    # the dispatch whose update is forced to overflow
FP16_SAVE_AT = 10   # the update saved, then resumed in a fresh trainer
FP16_RESUMED = 5    # updates the resumed trainer takes
FP16_TOL = 1e-3     # relative, per resumed update


def train_fp16_phase(bf16):
    """The port's CLI trains full-width bert_base under --fp16 (initial
    loss scale 128, the reference's default) for 20 updates on the train
    phase's corpus and flags, saving at update 10.  At dispatch 7 the
    position embedding's first row is set to inf in the master weights:
    that update must be skipped (params and Adam moments unchanged, the
    update count held, the scale halved), then the row is restored and
    training goes on.  A fresh trainer then resumes the update-10 file for
    5 updates: the same scale and growth tracker as run A had there, and
    losses within FP16_TOL of run A's.  Checks the falling loss, a
    loss_scale per logged step, and the fp16 flash kernels once per layer
    per dispatch with no bf16 or fp32 flash launch; reports step, memory
    and profile figures beside ``bf16``'s (the train phase's); returns
    the fp16 kernels' launch counts."""
    from unicore_tpu_torch import checkpoint_utils as cu
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.ops import flash_attention as fa

    Trainer = trainer_mod.Trainer
    real = {"step": Trainer.train_step, "load": Trainer.load_checkpoint}
    run = {"name": "a", "dispatches": 0}
    step_s, losses, scalers, skip = [], {"a": {}, "b": {}}, {}, {}
    peaks = []  # run A's running peak device memory after each dispatch

    def scaler_of(trainer):
        return (float(trainer.scaler["scale"]),
                int(trainer.scaler["growth_tracker"]))

    def poisoned_step(self, samples):
        row = self.model.embed_positions.weight
        # snapshots on the host: the card's peak memory stays training's
        params = [p.detach().cpu() for p in self.model.parameters()]
        moments = [m.cpu() for m in self.optimizer.exp_avg
                   + self.optimizer.exp_avg_sq]
        before = (scaler_of(self), self.get_num_updates())
        with torch.no_grad():
            clean = row.detach().clone()
            row[0].fill_(float("inf"))
        poisoned = row.detach().cpu()
        out = real["step"](self, samples)
        after = (scaler_of(self), self.get_num_updates())
        skip.update({
            "dispatch": run["dispatches"], "scale_before": before[0][0],
            "scale_after": after[0][0], "tracker_after": after[0][1],
            "num_updates_before": before[1], "num_updates_after": after[1],
            "params_unchanged": all(
                torch.equal(p.detach().cpu(), poisoned if p is row else q)
                for p, q in zip(self.model.parameters(), params)),
            "moments_unchanged": all(torch.equal(m.cpu(), n) for m, n in zip(
                self.optimizer.exp_avg + self.optimizer.exp_avg_sq,
                moments)),
        })
        with torch.no_grad():
            row.copy_(clean)
        return out

    def step(self, samples):
        run["dispatches"] += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        forced = run["name"] == "a" and run["dispatches"] == FP16_SKIP_AT
        if forced:
            out = poisoned_step(self, samples)
        else:
            out = real["step"](self, samples)
        torch.cuda.synchronize()
        # the forced overflow's dispatch times its checks' host copies
        step_s.append(None if forced else time.perf_counter() - t)
        if run["name"] == "a":
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        n = self.get_num_updates()
        if not forced:
            losses[run["name"]][n] = (float(out[0]["loss"])
                                      / float(out[0]["sample_size"]))
        if run["name"] == "a" and n == FP16_SAVE_AT:
            scalers["a"] = scaler_of(self)
            # training's own peak, before the save stages the
            # checkpoint's leaves on the card
            scalers["peak_before_save_gb"] = (
                torch.cuda.max_memory_allocated() / 1e9)
        return out

    def load(self, *args, **kwargs):
        out = real["load"](self, *args, **kwargs)
        if out is not None:
            scalers["b"] = scaler_of(self)
            scalers["b_dispatches"] = self._dispatch_count
        return out

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp)
        save = os.path.join(tmp, "a")
        logdir = os.path.join(tmp, "log_a")
        Trainer.train_step, Trainer.load_checkpoint = step, load
        try:
            for name in fa.launches:
                fa.launches[name] = 0
            start_gb = reset_peak_memory()
            t0 = time.perf_counter()
            loop = cli_main(bert_args(tmp, logdir, TRAIN_UPDATES, FP16_FLAGS)
                            + ["--save-interval-updates", str(FP16_SAVE_AT),
                               "--save-dir", save, "--tmp-save-dir", save,
                               "--no-last-checkpoints",
                               # a background write would share the host
                               # with the steps it times
                               "--async-save", "off"])
            run_s = time.perf_counter() - t0
            launches = dict(fa.launches)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            dispatches, run_step_s = run["dispatches"], list(step_s)
            run_peaks = list(peaks)
            prof = profile_updates(loop.trainer)
            run.update(name="b", dispatches=0)
            restore = os.path.join(save, f"checkpoint_1_{FP16_SAVE_AT}.pt")
            saved = cu.load_checkpoint_to_cpu(restore)
            resumed = cli_main(bert_args(
                tmp, os.path.join(tmp, "log_b"),
                FP16_SAVE_AT + FP16_RESUMED, FP16_FLAGS) + [
                    "--restore-file", restore, "--save-dir",
                    os.path.join(tmp, "b"), "--no-save"])
        finally:
            Trainer.train_step, Trainer.load_checkpoint = real["step"], \
                real["load"]
        with open(os.path.join(logdir, "train_inner.jsonl")) as f:
            records = [json.loads(line) for line in f]
    layers = loop.trainer.model.encoder_layers
    # a skipped step logs no loss (its meters reset to None)
    nats = [r["loss"] * np.log(2) for r in records
            if r.get("loss") is not None]
    if len(nats) != TRAIN_UPDATES or not np.isfinite(nats).all():
        raise AssertionError(f"fp16 losses {nats}")
    if not 9.0 <= nats[0] <= 11.5:
        raise AssertionError(f"fp16 first loss {nats[0]} nats not in 9-11.5")
    if not np.mean(nats[-5:]) < nats[0]:
        raise AssertionError(f"fp16 loss did not fall: {nats}")
    scales = [r.get("loss_scale") for r in records]
    if len(records) != dispatches or None in scales:
        raise AssertionError(f"loss_scale not logged per step: {records}")
    skips = sum(int(r.get("n_skipped") or 0) for r in records)
    want = {n: layers * dispatches if n in TRAIN_FLASH_FP16 else 0
            for n in launches}
    if launches != want:
        raise AssertionError(f"fp16 flash launches {launches}, want {want} "
                             f"({layers} layers x {dispatches} dispatches)")
    if not (skip.get("dispatch") == FP16_SKIP_AT and skips == 1
            and skip["scale_after"] == skip["scale_before"] / 2
            and skip["num_updates_after"] == skip["num_updates_before"]
            and skip["params_unchanged"] and skip["moments_unchanged"]):
        raise AssertionError(f"forced overflow not skipped as it should be: "
                             f"{skip}, {skips} skips logged")
    file_scaler = (float(saved["model"]["scaler"]["scale"]),
                   int(saved["model"]["scaler"]["growth_tracker"]))
    if not scalers["a"] == file_scaler == scalers["b"]:
        raise AssertionError(f"resumed scaler {scalers}, file {file_scaler}")
    la, lb = losses["a"], losses["b"]
    resumed_at = sorted(lb)
    if resumed_at != list(range(FP16_SAVE_AT + 1,
                                FP16_SAVE_AT + FP16_RESUMED + 1)) \
            or resumed.trainer.get_num_updates() != FP16_SAVE_AT + \
            FP16_RESUMED:
        raise AssertionError(f"resumed updates {resumed_at}")
    rel = max(abs(lb[n] - la[n]) / abs(la[n]) for n in resumed_at)
    if not rel <= FP16_TOL:
        raise AssertionError(f"resumed fp16 losses {lb} off run A's {la} "
                             f"by {rel}")
    warm = np.array([t for t in run_step_s[2:] if t is not None])
    med_s = float(np.median(warm))
    keys = ("step_ms_median", "samples_per_s", "tokens_per_s", "peak_mem_gb",
            "mem_at_start_gb", "device_busy_ms", "device_idle_share",
            "kernel_launches")
    emit("train_fp16", model="bert_base", dtype="fp16", batch=TRAIN_BATCH,
         seq_len=512, updates=TRAIN_UPDATES, dispatches=dispatches,
         run_s=run_s, losses_nats=[round(x, 4) for x in nats],
         first_loss_nats=nats[0], last5_mean_nats=float(np.mean(nats[-5:])),
         loss_scale_per_step=scales, skips=skips, forced_skip=skip,
         step_ms_median=med_s * 1e3,
         step_ms_all=[None if t is None else t * 1e3 for t in run_step_s],
         samples_per_s=TRAIN_BATCH / med_s,
         tokens_per_s=TRAIN_BATCH * 512 / med_s,
         peak_mem_gb=scalers["peak_before_save_gb"],
         peak_mem_gb_with_save=peak_gb, mem_at_start_gb=start_gb,
         peak_mem_gb_by_dispatch=run_peaks, launches=launches,
         resume={"at_update": FP16_SAVE_AT, "scaler_run_a": scalers["a"],
                 "scaler_file": file_scaler, "scaler_resumed": scalers["b"],
                 "dispatch_count_resumed": scalers["b_dispatches"],
                 "losses_a_nats": [la[n] for n in resumed_at],
                 "losses_b_nats": [lb[n] for n in resumed_at],
                 "max_rel_diff": rel, "tolerance": FP16_TOL},
         bf16={k: bf16[k] for k in keys})
    emit("train_fp16_profile", window="3 updates, batch 16 x 512, fp16",
         **prof, bf16={k: bf16[k] for k in keys[5:]})
    return launches


LM_UPDATES, LM_SAVE_AT, LM_SERVE_UPDATES = 20, 10, 10
LM_RECORDS = 512  # 20 updates of 16 take 320: one epoch, no wrap


# the optimizer and schedule of the lm_train phase
LM_ADAM = ("--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
           "--adam-eps", "1e-6", "--lr-scheduler", "fixed", "--lr", "5e-4")


def lm_args(corpus, logdir, updates, *extra, precision="--bf16",
            optim=LM_ADAM, validate=False):
    """The command line of the LM phases: full-width transformer_lm_base
    under ``precision`` (clip 1.0, dropout 0.1, batch 16 x 512; Adam with
    lr 5e-4 on ``fixed`` unless ``optim`` names another optimizer and
    schedule), validation off unless ``validate``, on the corpus
    ``make_data`` wrote."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [
        corpus, "--user-dir",
        os.path.join(here, "unicore_tpu_torch", "examples", "lm"),
        "--task", "lm", "--loss", "lm_cross_entropy", "--arch",
        "transformer_lm_base", *optim, "--clip-norm", "1.0", "--dropout",
        "0.1", "--batch-size", str(TRAIN_BATCH), "--update-freq", "1",
        "--seed", "1", precision, "--max-update", str(updates),
        "--log-interval", "1", "--log-format", "none",
        "--tensorboard-logdir", logdir,
        *(() if validate else ("--disable-validation",)),
        *INLINE_DATA, *extra]


def lm_corpus(path):
    """The BERT phase's synthetic Zipf(1.1) corpus law (128-510 tokens a
    record, 30,518 words: vocabulary 30,522 with the four specials),
    written by the LM's ``make_data``; returns its seconds."""
    from unicore_tpu_torch.examples.lm import make_data

    t0 = time.perf_counter()
    make_data.write_corpus(path, train=LM_RECORDS, valid=8, seed=2048)
    return time.perf_counter() - t0


def lm_train_phase():
    """The port's CLI trains full-width transformer_lm_base (rel-pos
    bias and learned positions, the reference's defaults) under --bf16:
    run A takes 20 updates saving at 10; run B, a fresh trainer, restores
    the update-10 file and runs to 20.  Raises unless the first loss lies
    in 9-11.5 nats and the last 5 average below it, every update of both
    runs launches the three bf16 flash kernels once a layer each (36) and
    no other flash kernel, and B's losses and final params equal A's bit
    for bit.  Reports the step median, tokens/s, peak memory and a
    profiled window of 3 more updates; returns the launch counts of run
    A and its report.  tokens/s counts the unpadded target tokens (the
    loss's sample_size) of the warm steps over their summed time."""
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    Trainer = trainer_mod.Trainer
    train_step = Trainer.train_step
    runs = []

    def step(self, samples):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, samples)
        torch.cuda.synchronize()
        runs[-1].append({
            "s": time.perf_counter() - t,
            "nats": float(out[0]["loss"]) / float(out[0]["sample_size"]),
            # the unpadded target tokens of the update
            "tokens": float(out[0]["sample_size"]),
            "launches": {k: fa.launches[k] - before[k] for k in before}})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        corpus_s = lm_corpus(tmp)
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        restore = os.path.join(a, f"checkpoint_1_{LM_SAVE_AT}.pt")
        for counts in (fa.launches, sd.plain_route):
            for name in counts:
                counts[name] = 0
        Trainer.train_step = step
        start_gb = reset_peak_memory()
        try:
            runs.append([])
            t0 = time.perf_counter()
            run_a = cli_main(lm_args(
                tmp, os.path.join(tmp, "log_a"), LM_UPDATES,
                "--save-interval-updates", str(LM_SAVE_AT), "--save-dir", a,
                "--tmp-save-dir", a, "--no-last-checkpoints"))
            run_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launches = dict(fa.launches)
            runs.append([])
            run_b = cli_main(lm_args(
                tmp, os.path.join(tmp, "log_b"), LM_UPDATES,
                "--restore-file", restore, "--save-dir", b, "--no-save"))
        finally:
            Trainer.train_step = train_step
        if any(sd.plain_route.values()):
            raise AssertionError(f"softmax_dropout took the plain route: "
                                 f"{sd.plain_route}")
        model = run_a.trainer.model
        layers = model.decoder_layers
        if model.decoder.relative_attention_bias is None \
                or model.embed_positions is None:
            raise AssertionError("transformer_lm_base without --rotary "
                                 "lacks rel-pos or learned positions")
        per_update = {n: layers if n in TRAIN_FLASH else 0
                      for n in fa.launches}
        for run in runs:
            for u, r in enumerate(run):
                if r["launches"] != per_update:
                    raise AssertionError(
                        f"update {u + 1}: flash launches {r['launches']}, "
                        f"want {per_update}")
        nats = [r["nats"] for r in runs[0]]
        resumed = [r["nats"] for r in runs[1]]
        if len(nats) != LM_UPDATES or not np.isfinite(nats).all():
            raise AssertionError(f"losses {nats}")
        if not 9.0 <= nats[0] <= 11.5:
            raise AssertionError(f"first loss {nats[0]} nats not in 9-11.5")
        if not np.mean(nats[-5:]) < nats[0]:
            raise AssertionError(f"loss did not fall: {nats}")
        if resumed != nats[LM_SAVE_AT:]:
            raise AssertionError(f"resumed losses {resumed} differ from "
                                 f"run A's {nats[LM_SAVE_AT:]}")
        with torch.no_grad():
            params_equal = all(torch.equal(p, q) for p, q in zip(
                run_a.trainer.model.parameters(),
                run_b.trainer.model.parameters()))
        if not params_equal:
            raise AssertionError("run B's params at update 20 differ from "
                                 "run A's")
        warm = np.array([r["s"] for r in runs[0][2:]])
        med_s = float(np.median(warm))
        tokens = sum(r["tokens"] for r in runs[0][2:])
        report = {"step_ms_median": med_s * 1e3,
                  "samples_per_s": TRAIN_BATCH / med_s,
                  # unpadded target tokens over the same steps' time
                  "tokens_per_s": tokens / float(warm.sum()),
                  "tokens_per_update": tokens / len(warm),
                  # every slot of the 16 x 512 batch, padding included
                  "padded_slots_per_s": TRAIN_BATCH * FLASH_T / med_s,
                  "peak_mem_gb": peak_gb, "mem_at_start_gb": start_gb}
        emit("lm_train", model="transformer_lm_base", dtype="bf16",
             batch=TRAIN_BATCH, seq_len=FLASH_T, updates=LM_UPDATES,
             corpus_records=LM_RECORDS, corpus_s=corpus_s, run_s=run_s,
             losses_nats=nats, resumed_from=LM_SAVE_AT,
             resumed_losses_bit_equal=True, params_bit_equal=params_equal,
             flash_launches_per_update=per_update, launches=launches,
             step_ms_all=[r["s"] * 1e3 for r in runs[0]], card=card(),
             **report)
        prof = profile_updates(run_a.trainer, named=TRAIN_FLASH)
        emit("lm_train_profile", window="3 updates, batch 16 x 512, bf16",
             **prof)
    return {"launches": launches, **report,
            **{k: v for k, v in prof.items() if k != "top_kernels"}}


def lm_serve_checkpoint_phase():
    """10 ``--rotary True`` updates of the lm_train phase's model and
    flags, saved without the optimizer state; ``python -m
    unicore_tpu_torch.serve --checkpoint`` on that file serves 8 prompts
    of 16-200 corpus tokens greedily (16 new tokens each), in process on
    the card, and each stream equals ``solo_greedy`` of the loaded model
    (a divergence passes only at a top-2 logit gap below 1e-4, an fp32
    tie, and is reported).  Then the update-10 file of a rel-pos run
    (2 updates) is refused with the JAX decoder's message."""
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.deploy import load_serve_model
    from unicore_tpu_torch.examples.lm.model import solo_greedy
    from unicore_tpu_torch.modules.transformer_decoder import (
        DECODE_REL_POS_REFUSAL)
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import paged_attention as pa
    from unicore_tpu_torch.serve.cli import main as serve_main

    with tempfile.TemporaryDirectory() as tmp:
        lm_corpus(tmp)
        save, relpos = os.path.join(tmp, "rotary"), os.path.join(tmp, "rp")
        for name in fa.launches:
            fa.launches[name] = 0
        t0 = time.perf_counter()
        run = cli_main(lm_args(
            tmp, os.path.join(tmp, "log"), LM_SERVE_UPDATES, "--rotary",
            "True", "--save-dir", save, "--tmp-save-dir", save,
            "--no-save-optimizer-state"))
        train_s = time.perf_counter() - t0
        train_launches = dict(fa.launches)
        layers = run.trainer.model.decoder_layers
        want = {n: layers * LM_SERVE_UPDATES if n in TRAIN_FLASH else 0
                for n in train_launches}
        if train_launches != want:
            raise AssertionError(f"rotary run flash launches "
                                 f"{train_launches}, want {want}")
        if run.trainer.model.embed_positions is not None or \
                run.trainer.model.decoder.relative_attention_bias is not None:
            raise AssertionError("--rotary True kept another position "
                                 "scheme")
        path = os.path.join(save, "checkpoint_last.pt")
        dict_path = os.path.join(tmp, "dict.txt")
        rng = np.random.default_rng(515)
        prompts = [rng.integers(4, 30522, size=int(n)).tolist()
                   for n in rng.integers(16, 201, size=8)]
        prompt_file = os.path.join(tmp, "prompts.txt")
        with open(prompt_file, "w") as f:
            f.writelines(" ".join(map(str, p)) + "\n" for p in prompts)
        out = os.path.join(tmp, "serve.json")
        pa.ragged_paged_attention.launches = 0
        t0 = time.perf_counter()
        serve_main(["--checkpoint", path, "--dict", dict_path, "--prompts",
                    prompt_file, "--max-new-tokens", "16", "--num-pages",
                    str(NUM_PAGES), "--page-size", str(PAGE_SIZE),
                    "--max-batch", "8", "--device", "cuda", "--json", out])
        serve_s = time.perf_counter() - t0
        paged_launches = pa.ragged_paged_attention.launches
        with open(out) as f:
            served = json.load(f)
        if not served["pool_clean"] or \
                not served["device"].startswith("cuda"):
            raise AssertionError(f"serve report {served['device']}, pool "
                                 f"clean {served['pool_clean']}")
        want_paged = layers * served["stats"]["ragged_dispatches"]
        if paged_launches != want_paged:
            raise AssertionError(f"served run paged launches "
                                 f"{paged_launches}, want {want_paged}")
        model = load_serve_model(path, dict_path).cuda()
        checks = []
        for res, prompt in zip(served["results"], prompts):
            if res["prompt"] != prompt:
                raise AssertionError(f"{res['request_id']}: prompt differs")
            solo, margins = solo_greedy(model, prompt, 16)
            got = res["tokens"]
            checks.append({"prompt_len": len(prompt), "tokens": len(got),
                           **held_to_solo(res["request_id"], got, solo,
                                          margins)})
        # the oracle runs the port's kernels; hold it once to the plain
        # versions: the shortest prompt and its served stream in one
        # forward on the CPU, where every wrapper runs its plain version
        short = min(range(len(prompts)), key=lambda i: len(prompts[i]))
        stream = served["results"][short]["tokens"]
        toks = torch.tensor([prompts[short] + stream])
        with torch.no_grad():
            card_logits = model(toks.cuda())[0].float().cpu()
            plain_logits = load_serve_model(path, dict_path)(toks)[0].float()
        picked = plain_logits[len(prompts[short]) - 1:-1]
        oracle_err = float((card_logits - plain_logits).abs().max())
        oracle_tol = 1e-3 * float(plain_logits.abs().max())
        top2 = torch.topk(picked, 2).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        # a token may differ only where the plain top-2 gap lies within
        # twice the card's distance from plain
        greedy = picked.argmax(-1).tolist()
        differ = [i for i, (x, y) in enumerate(zip(greedy, stream))
                  if x != y and gaps[i] >= 2 * oracle_err]
        if oracle_err > oracle_tol or differ:
            raise AssertionError(
                f"card forward vs plain: logits {oracle_err} (tol "
                f"{oracle_tol}), served tokens off plain's greedy at "
                f"{differ}")
        oracle = {"prompt_len": len(prompts[short]), "tokens": len(stream),
                  "logits_max_abs_err": oracle_err, "tol": oracle_tol,
                  "min_gap": float(min(gaps))}
        # lm_generate: the same model and prompts through generate()
        emit("lm_generate", **lm_generate_case(model, prompts))
        del model
        # a rel-pos file: the reference's defaults, 2 updates
        cli_main(lm_args(tmp, os.path.join(tmp, "log_rp"), 2, "--save-dir",
                         relpos, "--tmp-save-dir", relpos,
                         "--no-save-optimizer-state"))
        try:  # the refusal is the expected outcome, raised as SystemExit
            serve_main(["--checkpoint",
                        os.path.join(relpos, "checkpoint_last.pt"),
                        "--dict", dict_path, "--prompts", prompt_file,
                        "--device", "cuda", "--json", out])
        except SystemExit as e:
            refusal = str(e)
        else:
            raise AssertionError("a rel-pos checkpoint was served")
        if refusal != DECODE_REL_POS_REFUSAL:
            raise AssertionError(f"rel-pos refusal {refusal!r}")
        file_bytes = os.path.getsize(path)
        del run
    return {"model": "transformer_lm_base", "rotary": True,
            "updates": LM_SERVE_UPDATES, "train_s": train_s,
            "flash_launches": train_launches, "card": card(),
            "file_bytes": file_bytes, "requests": len(served["results"]),
            "serve_s": serve_s, "paged_launches": paged_launches,
            "stats": served["stats"], "solo_checks": checks,
            "oracle_vs_plain": oracle, "relpos_refusal": refusal}


GEN_NEW, GEN_CAP, GEN_BATCH = 32, 512, 8


def lm_generate_case(model, prompts):
    """``generate()`` (the dense-cache decode) on the served checkpoint's
    fp32 model: the 8 right-padded prompts of 16-200 tokens (the ragged
    prefill) and an unpadded 8 x 64 batch (``_prefill``), 32 greedy
    tokens each at capacity 512.  Every row equals ``solo_greedy`` of its
    prompt and the engine's greedy stream (a divergence passes only at a
    top-2 gap below 1e-4); no flash or paged kernel runs inside
    ``generate()``; a sampled call (temperature 0.8, top-k 40,
    ``PRNGKey(18)``) twice gives the same tokens.  Reports the prefill
    ms, the decode-step median (each model call synchronized), decode
    tokens/s, the launches of one decode step and of one sampled pick,
    the cache's bytes and the peak memory."""
    from unicore_tpu_torch.examples.lm import generate as gen
    from unicore_tpu_torch.examples.lm.model import solo_greedy
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import paged_attention as pa
    from unicore_tpu_torch.serve import threefry
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.sampling import sample_token
    from unicore_tpu_torch.serve.scheduler import Request

    rng = np.random.default_rng(1807)
    padded = np.full((GEN_BATCH, max(map(len, prompts))), model.padding_idx,
                     np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    unpadded = rng.integers(4, model.vocab_size, size=(GEN_BATCH, 64))
    batches = {"padded": (padded, list(prompts)),
               "unpadded": (unpadded, unpadded.tolist())}
    # every model call of generate(), synchronized and timed
    calls = {n: getattr(gen, n) for n in ("_prefill", "_prefill_ragged",
                                         "_step", "_step_ragged")}
    times = []

    def timed(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append((name, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    report, outs = {}, {}
    gen.generate(model, unpadded[:, :8], 2, max_len=GEN_CAP)  # warm-up
    for name, fn in calls.items():
        setattr(gen, name, timed(name, fn))
    try:
        for label, (batch, _) in batches.items():
            times.clear()
            pa.ragged_paged_attention.launches = 0
            for name in fa.launches:
                fa.launches[name] = 0
            base_gb = reset_peak_memory()
            t0 = time.perf_counter()
            outs[label] = gen.generate(model, batch, GEN_NEW,
                                       max_len=GEN_CAP).cpu()
            wall_s = time.perf_counter() - t0
            kernels = pa.ragged_paged_attention.launches + sum(
                fa.launches.values())
            if kernels:
                raise AssertionError(f"generate() launched {kernels} flash "
                                     "or paged-attention kernels")
            steps = [ms for n, ms in times if n.startswith("_step")]
            prefill = [ms for n, ms in times if n.startswith("_prefill")]
            if len(prefill) != 1 or len(steps) != GEN_NEW - 1:
                raise AssertionError(f"{label}: calls {times}")
            report[label] = {
                "path": "_prefill_ragged" if label == "padded"
                        else "_prefill",
                "wall_s": wall_s, "prefill_ms": prefill[0],
                "decode_step_median_ms": float(np.median(steps)),
                "decode_tokens_per_s": GEN_BATCH * len(steps)
                                       / (sum(steps) / 1e3),
                "tokens_per_s_end_to_end": GEN_BATCH * GEN_NEW / wall_s,
                "allocated_before_gb": base_gb,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        sampled = [gen.generate(model, padded, GEN_NEW,
                                temperature=SAMPLE_TEMP, top_k=SAMPLE_TOP_K,
                                rng=threefry.PRNGKey(18),
                                max_len=GEN_CAP).cpu() for _ in range(2)]
    finally:
        for name, fn in calls.items():
            setattr(gen, name, fn)
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("two sampled generate() calls differ")
    # each row against solo_greedy and the engine's greedy stream
    engine = ServeEngine(model, device="cuda", num_pages=NUM_PAGES,
                         page_size=PAGE_SIZE, max_batch=GEN_BATCH)
    checks = []
    for label, (_, rows) in batches.items():
        streams = engine.generate([
            Request(prompt=p, max_new_tokens=GEN_NEW,
                    request_id=f"{label}{i}") for i, p in enumerate(rows)])
        for i, (p, res) in enumerate(zip(rows, streams)):
            got = outs[label][i, len(p):len(p) + GEN_NEW].tolist()
            solo, margins = solo_greedy(model, p, GEN_NEW)
            checks.append({
                "batch": label, "prompt_len": len(p),
                "generate": held_to_solo(f"generate {label}{i}", got,
                                         solo, margins),
                "engine": held_to_solo(f"engine {label}{i}", res.tokens,
                                       solo, margins),
                "generate_equals_engine": got == res.tokens})
    # one decode step and one sampled pick, profiled
    lengths = torch.tensor([len(p) for p in prompts], device="cuda")
    cache = gen.init_cache(model, GEN_BATCH, GEN_CAP)
    with torch.no_grad():
        logit, cache = gen._prefill_ragged(
            model, cache, torch.from_numpy(padded).cuda(), lengths)
        tok = logit.argmax(-1)
        step = device_launches(
            lambda: gen._step_ragged(model, cache, tok, lengths))
    key = threefry.PRNGKey(18, device="cuda")
    pick = device_launches(lambda: sample_token(
        logit, key=key, temperature=SAMPLE_TEMP, top_k=SAMPLE_TOP_K))
    return {"model": "transformer_lm_base", "dtype": "float32",
            "card": card(), "batch": GEN_BATCH, "new_tokens": GEN_NEW,
            "capacity": GEN_CAP, "calls": report, "checks": checks,
            "all_equal": all(c["generate"]["equal"]
                             and c["generate_equals_engine"]
                             for c in checks),
            "sampled_reproducible": True,
            "sampled_tokens_off_greedy": int(
                (sampled[0] != outs["padded"]).sum()),
            "decode_step": step, "sampled_pick": pick,
            "cache_bytes": sum(b.nbytes for kv in cache.kv for b in kv)}


EVO_UPDATES, EVO_S, EVO_R = 10, 128, 256


LM_OPTIM_UPDATES, LM_OPTIM_SAVE_AT = 10, 5
# run: (optimizer and schedule flags, whether a fresh trainer resumes its
# midpoint file); every optimizer of the port and five schedules
LM_OPTIM_RUNS = {
    "a_adam_fixed": (LM_ADAM, True),
    "b_sgd_cosine": (("--optimizer", "sgd", "--momentum", "0.9",
                      "--weight-decay", "0.01", "--lr-scheduler", "cosine",
                      "--lr", "0.05", "--warmup-updates", "3",
                      "--warmup-init-lr", "0.005"), True),
    "c_adagrad_inverse_sqrt": (("--optimizer", "adagrad", "--lr-scheduler",
                                "inverse_sqrt", "--lr", "3e-3",
                                "--warmup-updates", "3", "--warmup-init-lr",
                                "3e-4"), True),
    "d_adadelta_tri_stage": (("--optimizer", "adadelta", "--lr-scheduler",
                              "tri_stage", "--lr", "1.0", "--phase-ratio",
                              "(0.2, 0.3, 0.5)"), True),
    "e_sgd_triangular": (("--optimizer", "sgd", "--lr-scheduler",
                          "triangular", "--lr", "0.01", "--max-lr", "0.05",
                          "--lr-period-updates", "6"), False),
}
# reduce_lr_on_plateau needs valid losses: 2 layers, 32 train records (2
# updates an epoch) and 16 valid ones, 5 epochs; a valid loss counts as
# better only 50% below the best, so the lr shrinks at every later epoch
# end
LM_PLATEAU_LR = 0.05
LM_PLATEAU = ("--optimizer", "sgd", "--momentum", "0.9", "--lr-scheduler",
              "reduce_lr_on_plateau", "--lr", str(LM_PLATEAU_LR),
              "--warmup-updates", "1", "--warmup-init-lr", "0.01",
              "--lr-threshold", "0.5", "--lr-patience", "0")
LM_PLATEAU_EPOCHS, LM_PLATEAU_LAYERS = 5, 2


def host_scheduler(argv):
    """The port's scheduler, built on the host from a run's command line
    over a stand-in optimizer: the schedule the logged lr must equal."""
    from unicore_tpu_torch import options
    from unicore_tpu_torch.optim.lr_scheduler import build_lr_scheduler

    class Opt:
        lr = None

        def set_lr(self, lr):
            self.lr = lr

        def get_lr(self):
            return self.lr

    args = options.parse_args_and_arch(options.get_training_parser(argv),
                                       argv)
    return build_lr_scheduler(args, Opt(), args.max_update or None)


OPT_PROFILE_SPINS = 32


def optimizer_step_profile(trainer):
    """Kernel launches and device ms of one ``optimizer.step()`` on the
    trainer's current gradients (``torch.profiler``); it moves the
    params."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # in a process that profiled before, the first kernels of a window
        # can go unrecorded (15 of them in one full smoke run): spin kernels
        # open the window, and only the step's kernels are counted
        for _ in range(OPT_PROFILE_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        trainer.optimizer.step()
        torch.cuda.synchronize()
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kernels = [e for e in cuda if "spin_kernel" not in e.key]
    return {"launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "spins_recorded": sum(e.count for e in cuda) - sum(
                e.count for e in kernels),
            "optimizer": type(trainer.optimizer).__name__,
            "leaves": len(trainer.optimizer.params)}


def lm_optim_fp16_phase():
    """The port's CLI trains full-width transformer_lm_base under --fp16
    (initial loss scale 128, clip 1.0, dropout 0.1, batch 16 x 512) once
    per optimizer and schedule of ``LM_OPTIM_RUNS``, 10 updates each,
    saving at update 5; a fresh trainer resumes each optimizer's update-5
    file to update 10.  Then ``reduce_lr_on_plateau`` at 2 layers over 5
    epochs of a 32-record corpus with validation.  Raises unless every
    loss is finite; run a's first loss lies in 9-11.5 nats and its last 5
    average below it; every applied update moves the params and a
    skipped one leaves them; every dispatch launches the three fp16 flash
    kernels once a layer each and no other flash kernel; softmax_dropout
    never takes its plain route; the lr each update used and the lr
    logged after it equal the port's scheduler evaluated on the host for
    that update count (replayed through the epoch ends and valid losses
    for reduce_lr_on_plateau, whose lr must shrink); each resumed run's
    losses and final params equal its first run's bit for bit.  Reports
    per run the losses, loss_scale sequence, step median, tokens/s, peak
    memory and one optimizer step's launches and device time; returns run
    a's flash launch counts."""
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.examples.lm import make_data
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    Trainer = trainer_mod.Trainer
    real = {"step": Trainer.train_step, "lr_step": Trainer.lr_step}
    events = []  # the current run's updates and epoch ends, in order

    def fingerprint(params):
        """Per leaf, the sum of its fp32 bit patterns: any change to a
        leaf moves it."""
        return torch.stack([p.detach().view(torch.int32).sum(
            dtype=torch.int64) for p in params]).cpu()

    def step(self, samples):
        params = self._master_params()
        before = fingerprint(params)
        counts = dict(fa.launches)
        n = self.get_num_updates()
        # the update's own lr: train_step asks the scheduler the same
        lr_used = self.lr_scheduler.step_update(n)
        scale = float(self.scaler["scale"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["step"](self, samples)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        applied = self.get_num_updates() == n + 1
        moved = fingerprint(params) != before
        graded = torch.stack([
            p.grad.ne(0).any() if p.grad is not None
            else torch.zeros((), dtype=torch.bool, device=p.device)
            for p in params]).cpu()
        events.append({
            "kind": "update", "s": dt, "updates_before": n,
            "applied": applied, "lr_used": lr_used, "scale": scale,
            "nats": float(out[0]["loss"]) / float(out[0]["sample_size"]),
            "tokens": float(out[0]["sample_size"]),
            # an applied update moves the params (a leaf whose every
            # change is below half an ulp may stay), a skipped one none
            "moved_ok": bool(moved.any()) == applied,
            "leaves_moved": int(moved.sum()),
            "leaves_with_grad": int(graded.sum()),
            "launches": {k: fa.launches[k] - counts[k] for k in counts}})
        return out

    def lr_step(self, epoch, val_loss=None):
        events.append({"kind": "epoch_end", "epoch": epoch,
                       "val_loss": val_loss,
                       "updates": self.get_num_updates()})
        return real["lr_step"](self, epoch, val_loss)

    def logged(logdir):
        with open(os.path.join(logdir, "train_inner.jsonl")) as f:
            return [json.loads(line) for line in f]

    def check_run(name, trainer, run, records, sched):
        """The per-update checks of one run against the host scheduler
        ``sched`` (already at the run's first update count)."""
        layers = trainer.model.decoder_layers
        per_update = {n: layers if n in TRAIN_FLASH_FP16 else 0
                      for n in fa.launches}
        host = {}
        for ev in run:
            if ev["kind"] == "epoch_end":  # the next update's lr is held
                sched.step(ev["epoch"], ev["val_loss"])
                sched.step_update(ev["updates"])
                continue
            n = ev["updates_before"]
            want = sched.step_update(n)
            if ev["lr_used"] != want:
                raise AssertionError(f"{name}: update {n + 1} ran at lr "
                                     f"{ev['lr_used']}, the host's {want}")
            if ev["applied"]:
                host[n + 1] = sched.step_update(n + 1)
            if ev["launches"] != per_update:
                raise AssertionError(f"{name}: update {n + 1} flash launches "
                                     f"{ev['launches']}, want {per_update}")
            if not ev["moved_ok"]:
                raise AssertionError(f"{name}: update {n + 1} (applied "
                                     f"{ev['applied']}) moved "
                                     f"{ev['leaves_moved']} leaves wrongly")
            if not np.isfinite(ev["nats"]):
                raise AssertionError(f"{name}: loss {ev['nats']}")
        lrs = [(r["step"], r["lr"]) for r in records
               if r.get("lr") is not None]
        for n, lr in lrs:
            if n in host and lr != host[n]:
                raise AssertionError(f"{name}: logged lr {lr} at update "
                                     f"{n}, the host's {host[n]}")
        if not lrs or any(n not in host for n, _ in lrs):
            raise AssertionError(f"{name}: logged lr steps {lrs}, host "
                                 f"{sorted(host)}")
        return lrs

    def summary(run, records, peak_gb):
        ups = [e for e in run if e["kind"] == "update"]
        warm = [e for e in ups[2:] if e["applied"]]
        med_s = float(np.median([e["s"] for e in warm]))
        return {
            "losses_nats": [e["nats"] for e in ups],
            "leaves_moved": [e["leaves_moved"] for e in ups],
            "leaves_with_grad": [e["leaves_with_grad"] for e in ups],
            "skipped": [i + 1 for i, e in enumerate(ups) if not e["applied"]],
            "loss_scale_per_step": [r.get("loss_scale") for r in records],
            "lr_per_update": [e["lr_used"] for e in ups],
            "step_ms_median": med_s * 1e3,
            "step_ms_all": [e["s"] * 1e3 for e in ups],
            "tokens_per_s": (sum(e["tokens"] for e in warm)
                             / sum(e["s"] for e in warm)),
            "samples_per_s": TRAIN_BATCH / med_s, "peak_mem_gb": peak_gb}

    argv_of = {}
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        lm_corpus(tmp)
        for counts in (fa.launches, sd.plain_route):
            for k in counts:
                counts[k] = 0
        Trainer.train_step, Trainer.lr_step = step, lr_step
        try:
            for name, (optim, resumed) in LM_OPTIM_RUNS.items():
                a = os.path.join(tmp, name, "a")
                argv_of[name] = lm_args(
                    tmp, os.path.join(tmp, name, "log_a"), LM_OPTIM_UPDATES,
                    "--save-interval-updates", str(LM_OPTIM_SAVE_AT),
                    "--save-dir", a, "--tmp-save-dir", a,
                    "--no-last-checkpoints", precision="--fp16", optim=optim)
                events.clear()
                reset_peak_memory()
                run_a = cli_main(argv_of[name])
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                if name == "a_adam_fixed":
                    launches = dict(fa.launches)
                first = list(events)
                records = logged(os.path.join(tmp, name, "log_a"))
                sched = host_scheduler(argv_of[name])
                lrs = check_run(name, run_a.trainer, first, records, sched)
                out = summary(first, records, peak_gb)
                out["logged_lr"] = lrs
                if resumed:
                    events.clear()
                    restore = os.path.join(
                        a, f"checkpoint_1_{LM_OPTIM_SAVE_AT}.pt")
                    argv_b = lm_args(
                        tmp, os.path.join(tmp, name, "log_b"),
                        LM_OPTIM_UPDATES, "--restore-file", restore,
                        "--save-dir", os.path.join(tmp, name, "b"),
                        "--no-save", precision="--fp16", optim=optim)
                    run_b = cli_main(argv_b)
                    second = list(events)
                    sched = host_scheduler(argv_b)
                    sched.step_update(LM_OPTIM_SAVE_AT)
                    check_run(name + " resumed", run_b.trainer, second,
                              logged(os.path.join(tmp, name, "log_b")),
                              sched)
                    # a dispatch skipped at update 5 saves the file again
                    # (the update count still hits the interval), so B
                    # starts after A's last dispatch at update 5
                    want = [e["nats"] for e in first
                            if e["kind"] == "update"
                            and e["updates_before"] >= LM_OPTIM_SAVE_AT]
                    got = [e["nats"] for e in second
                           if e["kind"] == "update"]
                    if (len(got) < LM_OPTIM_UPDATES - LM_OPTIM_SAVE_AT
                            or got != want[len(want) - len(got):]):
                        raise AssertionError(f"{name}: resumed losses {got} "
                                             f"differ from run A's {want}")
                    with torch.no_grad():
                        same = all(torch.equal(p, q) for p, q in zip(
                            run_a.trainer.model.parameters(),
                            run_b.trainer.model.parameters()))
                    if not same:
                        raise AssertionError(f"{name}: resumed params at "
                                             "update 10 differ")
                    out["resumed_bit_equal"] = True
                    del run_b
                out["optimizer_step"] = optimizer_step_profile(run_a.trainer)
                report[name] = out
                emit("lm_optim_fp16", run=name, model="transformer_lm_base",
                     dtype="fp16", batch=TRAIN_BATCH, seq_len=FLASH_T,
                     updates=LM_OPTIM_UPDATES, argv=argv_of[name][5:],
                     card=card(), **out)
                del run_a
                gc.collect()
                torch.cuda.empty_cache()
            nats = report["a_adam_fixed"]["losses_nats"]
            if not 9.0 <= nats[0] <= 11.5:
                raise AssertionError(f"run a's first loss {nats[0]} nats "
                                     "not in 9-11.5")
            if not np.mean(nats[-5:]) < nats[0]:
                raise AssertionError(f"run a's loss did not fall: {nats}")
            # reduce_lr_on_plateau: a short corpus, validation, 4 epochs
            plateau = os.path.join(tmp, "plateau")
            make_data.write_corpus(plateau, train=32, valid=16, seed=2049)
            argv = lm_args(
                plateau, os.path.join(plateau, "log"), 0, "--max-epoch",
                str(LM_PLATEAU_EPOCHS), "--decoder-layers",
                str(LM_PLATEAU_LAYERS), "--save-dir", plateau, "--no-save",
                precision="--fp16", optim=LM_PLATEAU, validate=True)
            events.clear()
            reset_peak_memory()
            run_p = cli_main(argv)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            run = list(events)
        finally:
            Trainer.train_step, Trainer.lr_step = real["step"], \
                real["lr_step"]
        records = logged(os.path.join(plateau, "log"))
        lrs = check_run("plateau", run_p.trainer, run, records,
                        host_scheduler(argv))
        ends = [e for e in run if e["kind"] == "epoch_end"]
        after = [lr for n, lr in lrs if n > ends[0]["updates"]]
        if not after or min(after) >= LM_PLATEAU_LR:
            raise AssertionError(f"reduce_lr_on_plateau never shrank the "
                                 f"lr: {lrs}")
        out = summary(run, records, peak_gb)
        out.update(logged_lr=lrs, epoch_ends=ends,
                   layers=LM_PLATEAU_LAYERS, epochs=LM_PLATEAU_EPOCHS,
                   shrunk_to=min(after))
        report["plateau"] = out
        emit("lm_optim_fp16_plateau", model="transformer_lm_base",
             dtype="fp16", argv=argv[5:], card=card(), **out)
    if any(sd.plain_route.values()):
        raise AssertionError(f"softmax_dropout took the plain route: "
                             f"{sd.plain_route}")
    emit("lm_optim_fp16_summary", card=card(), runs={
        name: {k: r[k] for k in ("step_ms_median", "tokens_per_s",
                                 "peak_mem_gb", "loss_scale_per_step")}
        | ({"optimizer_step": r["optimizer_step"]}
           if "optimizer_step" in r else {})
        for name, r in report.items()})
    return launches


def evoformer_train_phase():
    """The port's CLI trains full-width evoformer_base under --bf16
    --bf16-sr --optim-bf16-moments; returns the launch counts of its 10
    updates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.examples.evoformer.make_data import write_corpus
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import rounding as sr
    from unicore_tpu_torch.ops import softmax_dropout as sd

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, n_res=EVO_R, n_seqs=EVO_S, train=8, valid=1,
                     seed=7)
        corpus_s = time.perf_counter() - t0
        logdir = os.path.join(tmp, "log")
        step_s = []
        train_step = trainer_mod.Trainer.train_step

        def timed(self, samples):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_step(self, samples)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out

        trainer_mod.Trainer.train_step = timed
        for counts in (fa.launches, sd.launches, sd.plain_route,
                       sr.launches):
            for name in counts:
                counts[name] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            loop = cli_main([
                tmp, "--user-dir",
                os.path.join(here, "unicore_tpu_torch", "examples",
                             "evoformer"),
                "--task", "evoformer", "--loss", "evoformer_mse", "--arch",
                "evoformer_base", "--bf16", "--bf16-sr",
                "--optim-bf16-moments", "--dropout", "0.1",
                "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
                "--lr", "2e-3", "--clip-norm", "1.0", "--lr-scheduler",
                "fixed", "--batch-size", "1", "--update-freq", "1",
                "--seed", "1", "--max-update", str(EVO_UPDATES),
                "--log-interval", "1", "--log-format", "none",
                "--tensorboard-logdir", logdir, "--disable-validation",
                "--required-batch-size-multiple", "1", *INLINE_DATA,
                "--no-save",
            ])
        finally:
            trainer_mod.Trainer.train_step = train_step
        run_s = time.perf_counter() - t0
        launches = {**sd.launches, **sr.launches,
                    "flash": sum(fa.launches.values()),
                    "softmax_dropout_plain_route": sum(
                        sd.plain_route.values())}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(logdir, "train_inner.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        trainer = loop.trainer
        blocks = trainer.model.evoformer_layers
        sizes = [p.numel() for p in trainer.model.parameters()]
        leaves = len(sizes)
        if sizes != evoformer_leaf_sizes():
            raise AssertionError("the trainer's leaves are not the rounding "
                                 "phase's table")
        if len(losses) != EVO_UPDATES or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        if not np.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        cap = sr.capacity()
        want = {"softmax_dropout_fwd": 4 * blocks * EVO_UPDATES,
                "softmax_dropout_bwd": 4 * blocks * EVO_UPDATES,
                # a table launch per capacity's worth of entries: the SR
                # sync of every leaf, then both moments of every leaf
                "fp32_to_bf16_sr": (-(-leaves // cap) + -(-2 * leaves // cap))
                * EVO_UPDATES,
                "flash": 0, "softmax_dropout_plain_route": 0}
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        med_s = float(np.median(step_s[2:]))
        emit("evoformer_train", model="evoformer_base", dtype="bf16",
             flags="--bf16 --bf16-sr --optim-bf16-moments --dropout 0.1",
             msa_rows=EVO_S, residues=EVO_R, batch=1, blocks=blocks,
             parameters=sum(p.numel() for p in trainer.model.parameters()),
             parameter_leaves=leaves, updates=EVO_UPDATES,
             corpus_s=corpus_s, run_s=run_s, losses_mse=losses,
             first_loss=losses[0], last3_mean=float(np.mean(losses[-3:])),
             step_ms_median=med_s * 1e3, step_ms_all=[s * 1e3 for s in step_s],
             residue_pairs_per_s=EVO_R * EVO_R / med_s, peak_mem_gb=peak_gb,
             launches=launches)

        # where a step's time goes: 2 more updates under the profiler
        itr = trainer.get_train_iterator(epoch=3).next_epoch_itr()
        batches = [next(itr) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                trainer.train_step([b])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        emit("evoformer_profile",
             window="2 updates, S=128 x R=256, bf16, SR",
             wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
             kernel_launches=sum(e.count for e in kernels),
             # both windows' updates, whether or not in the top 10
             softmax_dropout_ms={
                 kind: sum(e.self_device_time_total for e in kernels
                           if f"softmax_dropout_{kind}_kernel" in e.key)
                 / 1e3 for kind in ("fwd", "bwd")},
             top_kernels=[{"name": e.key[:80], "count": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top])
    return launches


UNIFOLD_UPDATES, UNIFOLD_SAVE_AT, UNIFOLD_FREQ = 10, 5, 2
# Uni-Fold's train scripts, as far as the port's flags reach; the warmup
# cut from 1000 updates to 4 so that a 10-update run leaves it
UNIFOLD_FLAGS = (
    "--bf16", "--bf16-sr", "--dropout", "0.1", "--optimizer", "adam",
    "--adam-betas", "(0.9, 0.999)", "--adam-eps", "1e-6",
    "--clip-norm", "0.0", "--per-sample-clip-norm", "0.1",
    "--ema-decay", str(EMA_DECAY), "--lr", "1e-3",
    "--lr-scheduler", "exponential_decay", "--warmup-updates", "4",
    "--decay-ratio", "0.95", "--decay-steps", "50000",
    "--batch-size", "1", "--update-freq", str(UNIFOLD_FREQ))
UNIFOLD_POISON = "blocks.3.row_attn.q_proj.weight"


def unifold_args(corpus, logdir, *extra):
    here = os.path.dirname(os.path.abspath(__file__))
    return [
        corpus, "--user-dir",
        os.path.join(here, "unicore_tpu_torch", "examples", "evoformer"),
        "--task", "evoformer", "--loss", "evoformer_mse", "--arch",
        "evoformer_base", *UNIFOLD_FLAGS, "--seed", "1",
        "--log-interval", "1", "--log-format", "none",
        "--tensorboard-logdir", logdir, "--disable-validation",
        "--required-batch-size-multiple", "1", *INLINE_DATA, *extra]


def unifold_detector(trainer):
    """Poison one named master weight with inf under --bf16 and no
    scaler: the step must raise FloatingPointError, and the detector's
    log must name that weight's module and leaf and no module that runs
    before it.  Returns the detector's lines."""
    from unicore_tpu_torch.nan_detector import flax_module_path

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("unicore_tpu_torch.nan_detector")
    handler = Keep(level=logging.INFO)
    log.addHandler(handler)
    itr = trainer.get_train_iterator(epoch=1).next_epoch_itr()
    group = [next(itr) for _ in range(UNIFOLD_FREQ)]
    with torch.no_grad():
        dict(trainer.model.named_parameters())[UNIFOLD_POISON][0, 0] = \
            float("inf")
    try:
        trainer.train_step(group)
        raised = False
    except FloatingPointError:
        raised = True
    finally:
        log.removeHandler(handler)
    module = flax_module_path(UNIFOLD_POISON.rsplit(".", 1)[0])
    leaf = f"params/{module}/kernel (1 values)"
    named = [ln.split(" in ", 1)[1].split(" (")[0] for ln in lines
             if "non-finite output in" in ln]
    upstream = ("msa_embed/", "pair_embed/", "blocks_0/", "blocks_1/",
                "blocks_2/")
    leaves = [ln for ln in lines if "train state leaf" in ln]
    if not raised or f"{module}/__call__/0" not in named or any(
            n.startswith(upstream) for n in named) or len(leaves) != 1 \
            or not leaves[0].endswith(leaf):
        raise AssertionError(f"NaN detector: raised {raised}, log {lines}")
    return {"poisoned": UNIFOLD_POISON, "raised": raised,
            "modules_named": len(named), "first_modules": named[:6],
            "leaves": leaves}


def evoformer_unifold_phase():
    """The port's CLI trains full-width evoformer_base under Uni-Fold's
    recipe (UNIFOLD_FLAGS) for 10 updates, saving at update 5; returns
    the launch counts of those updates and the phase's figures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.examples.evoformer.make_data import write_corpus
    from unicore_tpu_torch.ops import ema
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import rounding as sr
    from unicore_tpu_torch.ops import softmax_dropout as sd
    from unicore_tpu_torch.optim.lr_scheduler.schedules import (
        exponential_decay)

    Trainer = trainer_mod.Trainer
    real = {"step": Trainer.train_step, "clip": Trainer._add_clipped,
            "ema": trainer_mod.ema_update_}
    step_s, per_step, updates = [], [], []

    def counts():
        return {**sd.launches, **sr.launches, **ema.launches,
                "flash": sum(fa.launches.values()),
                "softmax_dropout_plain_route": sum(sd.plain_route.values())}

    def timed(self, samples):
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real["step"](self, samples)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        after = counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    def kept(emas, params, decay):  # each update's tensors, on the card
        start = [e.clone() for e in emas]
        out = real["ema"](emas, params, decay)
        updates.append((start, [p.detach().clone() for p in params],
                        [e.clone() for e in emas]))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, n_res=EVO_R, n_seqs=EVO_S,
                     train=UNIFOLD_UPDATES * UNIFOLD_FREQ, valid=1, seed=7)
        corpus_s = time.perf_counter() - t0
        a, b, c = (os.path.join(tmp, x) for x in "abc")
        restore = os.path.join(a, f"checkpoint_1_{UNIFOLD_SAVE_AT}.pt")
        for table in (fa.launches, sd.launches, sd.plain_route, sr.launches,
                      ema.launches):
            for name in table:
                table[name] = 0
        start_gb = reset_peak_memory()
        Trainer.train_step, trainer_mod.ema_update_ = timed, kept
        t0 = time.perf_counter()
        try:
            run_a = cli_main(unifold_args(
                tmp, os.path.join(a, "log"), "--max-update",
                str(UNIFOLD_UPDATES), "--save-interval-updates",
                str(UNIFOLD_SAVE_AT), "--save-dir", a, "--tmp-save-dir", a))
        finally:
            Trainer.train_step, trainer_mod.ema_update_ = real["step"], \
                real["ema"]
        run_s = time.perf_counter() - t0
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trainer = run_a.trainer
        blocks, leaves = trainer.model.evoformer_layers, len(trainer.ema)
        with open(os.path.join(a, "log", "train_inner.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["loss"] for r in records]
        if len(losses) != UNIFOLD_UPDATES or not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        if not np.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        lrs = [r["lr"] for r in records]
        want_lr = [exponential_decay(r["step"], base_lr=1e-3,
                                     decay_ratio=0.95, decay_steps=50000,
                                     warmup_updates=4) for r in records]
        if not np.allclose(lrs, want_lr, rtol=1e-12, atol=0):
            raise AssertionError(f"lr {lrs}, closed form {want_lr}")
        # per update: both passes of the 4 attentions of every block for
        # each of the 2 examples; one SR table launch per example; one EMA
        # table launch
        want_step = {
            "softmax_dropout_fwd": 4 * blocks * UNIFOLD_FREQ,
            "softmax_dropout_bwd": 4 * blocks * UNIFOLD_FREQ,
            "fp32_to_bf16_sr": -(-leaves // sr.capacity()) * UNIFOLD_FREQ,
            "ema_update": -(-leaves // ema.capacity()),
            "flash": 0, "softmax_dropout_plain_route": 0}
        want = {k: v * UNIFOLD_UPDATES for k, v in want_step.items()}
        if launches != want or any(
                {k: d[k] for k in want_step} != want_step for d in per_step):
            raise AssertionError(f"launches {launches}, want {want}; per "
                                 f"update {per_step}")
        # each update's EMA: the CPU formula on the same tensors, bit for bit
        if len(updates) != UNIFOLD_UPDATES:
            raise AssertionError(f"{len(updates)} EMA updates")
        ema_mismatches = 0
        for start, params, after in updates:
            want_ema = ema.ema_update_plain([e.cpu() for e in start],
                                            [p.cpu() for p in params],
                                            EMA_DECAY)
            ema_mismatches += sum(
                int((x.cpu().view(torch.int32) != y.view(torch.int32)).sum())
                for x, y in zip(after, want_ema))
        if ema_mismatches:
            raise AssertionError(f"EMA: {ema_mismatches} elements differ "
                                 "from the CPU formula")
        file_ema = trainer.model.named_from_flax(
            load_checkpoint_to_cpu(restore)["model"]["ema"])
        names = trainer._param_names()
        at_save = updates[UNIFOLD_SAVE_AT - 1][2]
        if not all(torch.equal(file_ema[n], e.cpu())
                   for n, e in zip(names, at_save)):
            raise AssertionError("the update-5 file's EMA is not the "
                                 "trainer's")
        end_params = [p.detach().clone() for p in trainer._master_params()]
        end_ema = [e.clone() for e in trainer.ema]
        del updates[:]
        med_s = float(np.median(step_s[2:]))
        emit("evoformer_unifold", card=card(), model="evoformer_base",
             dtype="bf16",
             flags=" ".join(UNIFOLD_FLAGS), msa_rows=EVO_S, residues=EVO_R,
             blocks=blocks, parameter_leaves=leaves, updates=UNIFOLD_UPDATES,
             corpus_s=corpus_s, run_s=run_s, losses_mse=losses, lrs=lrs,
             step_ms_median=med_s * 1e3,
             step_ms_all=[x * 1e3 for x in step_s],
             samples_per_s=UNIFOLD_FREQ / med_s,
             residue_pairs_per_s=UNIFOLD_FREQ * EVO_R * EVO_R / med_s,
             peak_mem_gb=peak_gb, mem_at_start_gb=start_gb,
             launches=launches, launches_per_update=want_step,
             ema_bit_for_bit_updates=UNIFOLD_UPDATES)

        # 3 more updates with no check's copies and no save's writer
        # thread beside them: the step, and the host time of each
        # per-sample clip and EMA call (no sync inside either)
        host = {"per_sample_clip": [], "ema_update": []}

        def clip_timed(self, *args):
            t = time.perf_counter()
            out = real["clip"](self, *args)
            host["per_sample_clip"].append((time.perf_counter() - t) * 1e3)
            return out

        def ema_timed(*args):
            t = time.perf_counter()
            out = real["ema"](*args)
            host["ema_update"].append((time.perf_counter() - t) * 1e3)
            return out

        itr = trainer.get_train_iterator(epoch=2).next_epoch_itr()
        groups = [[next(itr) for _ in range(UNIFOLD_FREQ)] for _ in range(5)]
        clean_ms = []
        Trainer._add_clipped, trainer_mod.ema_update_ = clip_timed, ema_timed
        try:
            for group in groups[:3]:
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer.train_step(group)
                torch.cuda.synchronize()
                clean_ms.append((time.perf_counter() - t) * 1e3)
        finally:
            Trainer._add_clipped, trainer_mod.ema_update_ = real["clip"], \
                real["ema"]

        # where a step's time goes, and the EMA's and the clip's shares:
        # 2 more updates under the profiler, both parts in named ranges
        def clip(self, *args):
            with record_function("per_sample_clip"):
                return real["clip"](self, *args)

        def ema_range(*args):
            with record_function("ema_update"):
                return real["ema"](*args)

        Trainer._add_clipped, trainer_mod.ema_update_ = clip, ema_range
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for group in groups[3:]:
                    trainer.train_step(group)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            Trainer._add_clipped, trainer_mod.ema_update_ = real["clip"], \
                real["ema"]
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        # each range twice: on the host (its host time and the device time
        # of the kernels launched inside it) and on the device (the span
        # from its first kernel's start to its last kernel's end)
        ranges = {}
        for e in events:
            if e.key in ("per_sample_clip", "ema_update"):
                side = "device" if e.device_type == DeviceType.CUDA else "host"
                ranges[f"{e.key}/{side}"] = {
                    "count": e.count, "host_ms": e.cpu_time_total / 1e3,
                    "device_ms": e.device_time_total / 1e3}
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        emit("evoformer_unifold_profile", card=card(),
             window="2 updates, 2 examples each, S=128 x R=256, bf16, SR",
             clean_step_ms=clean_ms, clean_host_ms=host,
             wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
             kernel_launches=sum(e.count for e in kernels),
             ema_kernel_ms=sum(e.self_device_time_total for e in kernels
                               if "ema_update_kernel" in e.key) / 1e3,
             ranges=ranges,
             top_kernels=[{"name": e.key[:80], "count": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top])
        del run_a, trainer
        gc.collect()
        torch.cuda.empty_cache()

        # the file of update 5, resumed in a fresh trainer to update 10
        run_b = cli_main(unifold_args(
            tmp, os.path.join(b, "log"), "--max-update",
            str(UNIFOLD_UPDATES), "--restore-file", restore, "--save-dir", b,
            "--no-save"))
        tb = run_b.trainer
        resumed_equal = tb.get_num_updates() == UNIFOLD_UPDATES and all(
            torch.equal(x.detach(), y) for x, y in zip(
                tb._master_params(), end_params)) and all(
            torch.equal(x, y) for x, y in zip(tb.ema, end_ema))
        with open(os.path.join(b, "log", "train_inner.jsonl")) as f:
            losses_b = [json.loads(line)["loss"] for line in f]
        if not resumed_equal:
            diff = max(float((x.detach() - y).abs().max()) for x, y in zip(
                tb._master_params(), end_params))
            raise AssertionError(f"resumed run: {tb.get_num_updates()} "
                                 f"updates, params off by {diff}; losses "
                                 f"{losses_b} against {losses[5:]}")
        del run_b, tb, end_params, end_ema
        gc.collect()
        torch.cuda.empty_cache()

        # a --load-from-ema start from the same file: its EMA as params
        run_c = cli_main(unifold_args(
            tmp, os.path.join(c, "log"), "--max-update",
            str(UNIFOLD_SAVE_AT), "--restore-file", restore,
            "--load-from-ema", "--save-dir", c, "--no-save"))
        tc = run_c.trainer
        from_ema = all(
            torch.equal(p.detach().cpu(), file_ema[n])
            and torch.equal(e.cpu(), file_ema[n])
            for n, p, e in zip(names, tc._master_params(), tc.ema))
        if not from_ema:
            raise AssertionError("--load-from-ema: params are not the "
                                 "file's EMA")
        detector = unifold_detector(tc)
        del run_c, tc
        gc.collect()
        torch.cuda.empty_cache()
    emit("evoformer_unifold_checks", resumed_at=UNIFOLD_SAVE_AT,
         resumed_bit_equal=resumed_equal, losses_b_mse=losses_b,
         losses_b_equal=losses_b == losses[UNIFOLD_SAVE_AT:],
         load_from_ema=from_ema, detector=detector)
    return launches


MOL_UPDATES, MOL_BATCH, MOL_ATOMS, MOL_MOLECULES = 20, 16, 256, 1024
MOL_MAX_SKIPS = 4  # at least 16 of the first 20 dispatches apply


def mol_args(corpus, logdir):
    """Uni-Mol's published pretraining recipe as far as the task's and
    loss's flags reach: unimol_base at --max-atoms 256 under --fp16 with
    the recipe's loss scaler (initial scale 4, window 256), Adam (0.9,
    0.99) eps 1e-6, weight decay 1e-4, clip 1.0, lr 1e-4 on
    polynomial_decay, dropout and attention dropout 0.1, loss weights
    token 1, coordinate 5, distance 10; batch 16, 20 updates, no
    validation."""
    here = os.path.dirname(os.path.abspath(__file__))
    return [
        corpus, "--user-dir",
        os.path.join(here, "unicore_tpu_torch", "examples", "mol"),
        "--task", "mol", "--loss", "unimol", "--arch", "unimol_base",
        "--max-atoms", str(MOL_ATOMS), "--fp16", "--fp16-init-scale", "4",
        "--fp16-scale-window", "256", "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.99)", "--adam-eps", "1e-6",
        "--weight-decay", "1e-4", "--clip-norm", "1.0",
        "--lr-scheduler", "polynomial_decay", "--lr", "1e-4",
        "--warmup-updates", "4", "--total-num-update", str(MOL_UPDATES),
        "--dropout", "0.1", "--attention-dropout", "0.1",
        "--masked-token-loss", "1", "--masked-coord-loss", "5",
        "--masked-dist-loss", "10", "--batch-size", str(MOL_BATCH),
        "--update-freq", "1", "--seed", "1", "--max-update", str(MOL_UPDATES),
        "--log-interval", "1", "--log-format", "none",
        "--tensorboard-logdir", logdir, "--disable-validation",
        "--required-batch-size-multiple", "1", *INLINE_DATA,
        "--no-save"]


def mol_train_fp16_phase():
    """The port's CLI trains a seeded random unimol_base (15 layers, width
    512, FFN 2048, 64 heads of 8, 64 pair channels, 128 Gaussian kernels)
    under --fp16 at --max-atoms 256 on 1,024 synthetic molecules of
    16-256 atoms (the port's make_data).  Checks: every applied update's
    loss finite, the mean of the last 5 below the first, at most 4 skips
    in reaching 20 updates, each dispatch 15 softmax_dropout forward and
    15 backward launches (one a layer, fp16 scores [16, 64, 256, 256]),
    the plain route and the flash kernels never.  Reports step times,
    molecules/s, peak memory, the loss-scale sequence, the real-atom share
    of the padded rows, and a profiled window of 3 updates; returns the
    softmax_dropout launch counts."""
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.examples.mol.make_data import write_corpus
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    Trainer = trainer_mod.Trainer
    train_step = Trainer.train_step
    steps = []

    def timed(self, samples):
        before = dict(sd.launches)
        scale = float(self.scaler["scale"])
        n = self.get_num_updates()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, samples)
        torch.cuda.synchronize()
        toks = np.asarray(samples[0]["net_input"]["src_tokens"])
        steps.append({
            "s": time.perf_counter() - t, "scale": scale,
            "applied": self.get_num_updates() > n,
            "launches": {k: sd.launches[k] - before[k] for k in before},
            "real_share": float((toks != self.task.dictionary.pad()).mean()),
            "width": int(toks.shape[1])})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train=MOL_MOLECULES, valid=8, min_atoms=16,
                     max_atoms=MOL_ATOMS, atom_types=8, seed=7)
        corpus_s = time.perf_counter() - t0
        logdir = os.path.join(tmp, "log")
        Trainer.train_step = timed
        for counts in (fa.launches, sd.launches, sd.plain_route):
            for name in counts:
                counts[name] = 0
        start_gb = reset_peak_memory()
        t0 = time.perf_counter()
        try:
            loop = cli_main(mol_args(tmp, logdir))
        finally:
            Trainer.train_step = train_step
        run_s = time.perf_counter() - t0
        launches = {**sd.launches, "flash": sum(fa.launches.values()),
                    "softmax_dropout_plain_route": sum(
                        sd.plain_route.values())}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run_steps = list(steps)
        with open(os.path.join(logdir, "train_inner.jsonl")) as f:
            records = [json.loads(line) for line in f]
        prof = profile_updates(loop.trainer, named=(
            "softmax_dropout_fwd", "softmax_dropout_bwd"))
    trainer = loop.trainer
    layers = trainer.model.encoder_layers
    dispatches = len(run_steps)
    skips = sum(not st["applied"] for st in run_steps)
    # a skipped step logs no loss
    losses = [r["loss"] for r in records if r.get("loss") is not None]
    if len(losses) != MOL_UPDATES or not np.isfinite(losses).all():
        raise AssertionError(f"mol losses {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"mol loss did not fall: {losses}")
    if skips > MOL_MAX_SKIPS or dispatches != MOL_UPDATES + skips:
        raise AssertionError(f"{skips} skips in {dispatches} dispatches")
    per_step = {"softmax_dropout_fwd": layers, "softmax_dropout_bwd": layers}
    bad = [i for i, st in enumerate(run_steps) if st["launches"] != per_step]
    if bad:
        raise AssertionError(f"softmax_dropout launches per dispatch "
                             f"{[run_steps[i]['launches'] for i in bad]}, "
                             f"want {per_step}")
    want = {**{k: v * dispatches for k, v in per_step.items()}, "flash": 0,
            "softmax_dropout_plain_route": 0}
    if launches != want:
        raise AssertionError(f"mol launches {launches}, want {want}")
    if any(st["width"] != MOL_ATOMS for st in run_steps):
        raise AssertionError("a batch not padded to --max-atoms")
    warm = np.array([st["s"] for st in run_steps[2:]])
    med_s = float(np.median(warm))
    stats = {k: records[-1].get(k) for k in (
        "token_loss", "coord_loss", "dist_loss", "coord_rmsd")}
    emit("mol_train_fp16", model="unimol_base", dtype="fp16",
         flags="--fp16 --fp16-init-scale 4 --fp16-scale-window 256 "
               "--max-atoms 256 --dropout 0.1 --attention-dropout 0.1",
         batch=MOL_BATCH, max_atoms=MOL_ATOMS, layers=layers,
         parameters=sum(p.numel() for p in trainer.model.parameters()),
         molecules=MOL_MOLECULES, updates=MOL_UPDATES,
         dispatches=dispatches, skips=skips, corpus_s=corpus_s,
         run_s=run_s, losses=losses, first_loss=losses[0],
         last5_mean=float(np.mean(losses[-5:])), last_stats=stats,
         loss_scale_per_step=[st["scale"] for st in run_steps],
         step_ms_median=med_s * 1e3,
         step_ms_spread=[float(np.min(warm)) * 1e3,
                         float(np.percentile(warm, 25)) * 1e3,
                         float(np.percentile(warm, 75)) * 1e3,
                         float(np.max(warm)) * 1e3],
         step_ms_all=[st["s"] * 1e3 for st in run_steps],
         molecules_per_s=MOL_BATCH / med_s,
         real_atom_share=float(np.mean([st["real_share"]
                                        for st in run_steps])),
         peak_mem_gb=peak_gb, mem_at_start_gb=start_gb,
         launches=launches, launches_per_update=per_step)
    emit("mol_train_fp16_profile",
         window="3 updates, batch 16 x 256 atoms, fp16", **prof)
    return launches


# data_workers: each mode's data flags, run in turns on one corpus
DW_UPDATES = 8
DW_MODES = {"a": ("--num-workers", "0"),
            "e": INLINE_DATA,  # no pump either: the port before A4
            "b": (),  # the reference's defaults: 1 thread worker, buffer 10
            "c": ("--num-workers", "4", "--worker-impl", "thread"),
            "d": ("--num-workers", "4", "--worker-impl", "process")}
DW_KILL_AT, DW_SIGTERM_AT = 1, 4  # run d_sigterm's updates
# launches an update: a flash forward and backward a layer (12 layers);
# a softmax_dropout forward and backward a layer (15 layers)
DW_LAUNCHES = {"bert": {n: 12 for n in TRAIN_FLASH},
               "mol": {"softmax_dropout_fwd": 15, "softmax_dropout_bwd": 15}}
DW_REAP_S = 5.0


def with_data_mode(argv, mode):
    """``argv`` with its data flags replaced by mode ``mode``'s."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--num-workers", "--worker-impl", "--data-buffer-size"):
            skip = True
        else:
            out.append(a)
    return out + list(DW_MODES[mode])


def batch_digest(sample):
    """sha256 over a collated batch's arrays, leaf by leaf in key order
    (names, dtypes, shapes and bytes)."""
    import hashlib

    h = hashlib.sha256()

    def walk(d, prefix=""):
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                a = np.ascontiguousarray(v)
                h.update(f"{prefix}{k}:{a.dtype}:{a.shape}".encode())
                h.update(a.tobytes())

    walk(sample)
    return h.hexdigest()


def live_children(pids):
    """Those of ``pids`` still alive (a zombie counts as gone), read from
    ``/proc/<pid>/stat``, and those still listed as this process's
    children in ``/proc/self/task/*/children``."""
    import glob

    alive = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    alive.append(pid)
        except FileNotFoundError:
            pass
    listed = set()
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            listed.update(int(p) for p in f.read().split())
    return alive, sorted(listed & set(pids))


def pipeline_profile(trainer, n=3):
    """``n`` updates of epoch 2 pulled through the run's own data
    pipeline (its workers, impl and buffer) under ``torch.profiler``,
    after one warm update: device busy and idle share, launches, and the
    host seconds each ``next`` waited for its batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    epoch_itr = trainer.get_train_iterator(epoch=2)
    try:
        stream = epoch_itr.next_epoch_itr()
        trainer.train_step([next(stream)])
        torch.cuda.synchronize()
        waits = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                t = time.perf_counter()
                batch = next(stream)
                waits.append(time.perf_counter() - t)
                trainer.train_step([batch])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        epoch_itr.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "batch_wait_ms": [w * 1e3 for w in waits]}


def mode_report(rec, prof):
    """A mode's step and batch-wait figures (updates 3 on: the first two
    warm the card) and its profiled window."""
    warm = np.array(rec["step_s"][2:]) * 1e3
    waits = np.array(rec["wait_s"][2:len(rec["step_s"])]) * 1e3
    out = {"step_ms_median": float(np.median(warm)),
           "step_ms_spread": [float(warm.min()), float(warm.max())],
           "batch_wait_ms_median": float(np.median(waits)),
           "batch_wait_ms_max": float(waits.max()),
           "batch_wait_ms_first": rec["wait_s"][0] * 1e3,
           "profile": prof}
    if rec["pools"]:
        out["pool_fork_s"] = [p["fork_s"] for p in rec["pools"]]
    return out


def held_equal(label, rec, ref, n):
    """Run ``rec``'s first ``n`` updates hold ``ref``'s: batch digests
    equal, then losses and sample sizes bit-equal, then launches per
    update equal; a failure names the first update that differs."""
    for key in ("digest", "loss", "launches"):
        got, want = rec[key][:n], ref[key][:n]
        if got != want:
            i = next(i for i, (g, w) in enumerate(zip(got + [None] * n,
                                                      want)) if g != w)
            raise AssertionError(f"{label}: {key} of update {i + 1}: "
                                 f"{got[i:i + 1]} != {want[i]}")


def data_workers_phase():
    """The port's data workers on the card's training paths, at full
    width: full-width bert_base (--bf16, batch 16 x 512) for 8 updates
    under (a) --num-workers 0 (buffer 10: the pump still runs), (e)
    --num-workers 0 --data-buffer-size 0 (no pump), (b) no data flag
    (the reference's defaults: 1 thread worker, a buffer of 10), (c) 4
    thread workers and (d) 4 worker processes, run in turns; then (d)
    again with one pool worker SIGKILLed after update 1 and SIGTERM
    after update 4; then unimol_base (--fp16, --max-atoms 256, batch 16)
    for 8 updates under (a), (e), (c) and (d).  Checks: every mode's per-update losses and sample
    sizes bit-equal to (a)'s, each batch's sha256 equal, the iterator
    state after update 8 equal, flash 12 + 12 + 12 (BERT) and
    softmax_dropout 15 + 15 (Uni-Mol) launches an update; the killed
    worker's pool respawned once (``status()`` says respawns=1) with
    batches still (a)'s; the SIGTERM'd run returns (the CLI's exit 0)
    with checkpoint_last.pt's iterator position (a)'s at update 4, and
    no worker process alive or listed as a child within 5 s.  Reports
    per mode the step median and spread, the host ms the loop waited
    for each batch, the pool's fork seconds, and a profiled window of 3
    updates pulled through the mode's pipeline (busy, idle share,
    launches, batch waits).  Returns the launches of all runs by
    kernel."""
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu
    from unicore_tpu_torch.examples.mol.make_data import write_corpus as \
        write_mol_corpus

    launches = {"bert": Counter(), "mol": Counter()}
    report = {"bert": {}, "mol": {}}
    with tempfile.TemporaryDirectory() as tmp:
        bert_dir, mol_dir = os.path.join(tmp, "bert"), os.path.join(tmp,
                                                                     "mol")
        write_corpus(bert_dir)
        write_mol_corpus(mol_dir, train=MOL_MOLECULES, valid=8,
                         min_atoms=16, max_atoms=MOL_ATOMS, atom_types=8,
                         seed=7)
        runs = {}
        for model, modes in (("bert", "aebcd"), ("mol", "aecd")):
            for mode in modes:
                logdir = os.path.join(tmp, f"log_{model}_{mode}")
                argv = (bert_args(bert_dir, logdir, DW_UPDATES)
                        + ["--no-save"] if model == "bert"
                        else mol_args(mol_dir, logdir)
                        + ["--max-update", str(DW_UPDATES)])
                loop, rec = observe_cli(with_data_mode(argv, mode))
                prof = pipeline_profile(loop.trainer)
                del loop
                reset_peak_memory()
                runs[model, mode] = rec
                for step in rec["launches"]:
                    launches[model].update(step)
                report[model][mode] = mode_report(rec, prof)
        for model, modes in (("bert", "aebcd"), ("mol", "aecd")):
            ref = runs[model, "a"]
            n = len(ref["loss"])  # dispatches: an fp16 skip adds one
            if max(ref["state"]) != DW_UPDATES or (
                    model == "bert" and n != DW_UPDATES):
                raise AssertionError(f"{model} (a): {n} dispatches, "
                                     f"{max(ref['state'])} updates")
            per_update = DW_LAUNCHES[model]
            if any(step != per_update for step in ref["launches"]):
                raise AssertionError(f"{model} (a) launches "
                                     f"{ref['launches']}, want {per_update}"
                                     " an update")
            for mode in modes[1:]:
                rec = runs[model, mode]
                held_equal(f"{model} ({mode})", rec, ref, n)
                if len(rec["loss"]) != n:
                    raise AssertionError(f"{model} ({mode}): "
                                         f"{len(rec['loss'])} dispatches, "
                                         f"want {n}")
                if rec["state"][DW_UPDATES] != ref["state"][DW_UPDATES]:
                    raise AssertionError(
                        f"{model} ({mode}) iterator state "
                        f"{rec['state'][DW_UPDATES]}, want "
                        f"{ref['state'][DW_UPDATES]}")
            pids = [p for m in modes for pool in runs[model, m]["pools"]
                    for p in pool["pids"]]
            alive, listed = live_children(pids)
            if alive or listed:
                raise AssertionError(f"{model}: workers left {alive} "
                                     f"{listed}")

        # (d) once more: a worker killed mid-epoch, then SIGTERM
        save = os.path.join(tmp, "save_d")
        argv = with_data_mode(bert_args(bert_dir, os.path.join(
            tmp, "log_bert_d_sigterm"), DW_UPDATES), "d") + [
            "--save-dir", save, "--tmp-save-dir", save]
        t0 = time.perf_counter()
        loop, rec = observe_cli(argv, kill_at=DW_KILL_AT,
                                     sigterm_at=DW_SIGTERM_AT)
        run_s = time.perf_counter() - t0
        del loop
        reset_peak_memory()
        for step in rec["launches"]:
            launches["bert"].update(step)
        pids = [p for pool in rec["pools"] for p in pool["pids"]]
        deadline = time.monotonic() + DW_REAP_S
        while True:
            alive, listed = live_children(pids)
            if not (alive or listed) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        ref = runs["bert", "a"]
        held_equal("bert (d, killed + SIGTERM)", rec, ref, DW_SIGTERM_AT)
        if len(rec["loss"]) != DW_SIGTERM_AT:
            raise AssertionError(f"SIGTERM after update {DW_SIGTERM_AT}: "
                                 f"{len(rec['loss'])} updates ran")
        if rec["respawns"] != 1 or "respawns=1" not in rec["status"]:
            raise AssertionError(f"respawns {rec['respawns']}, status "
                                 f"{rec['status']}")
        saved = load_checkpoint_to_cpu(os.path.join(
            save, "checkpoint_last.pt"))["extra_state"]["train_iterator"]
        if saved != ref["state"][DW_SIGTERM_AT]:
            raise AssertionError(f"saved iterator {saved}, want "
                                 f"{ref['state'][DW_SIGTERM_AT]}")
        if alive or listed:
            raise AssertionError(f"workers alive {alive} or listed "
                                 f"{listed} {DW_REAP_S} s after SIGTERM")
        report["bert"]["d_sigterm"] = {
            "run_s": run_s, "killed_pid": rec["killed"],
            "respawns": rec["respawns"], "status": rec["status"],
            "pool_fork_s": [p["fork_s"] for p in rec["pools"]],
            "workers": len(pids), "saved_iterator": saved,
            "batch_wait_ms": [w * 1e3 for w in rec["wait_s"]],
            "step_ms": [s * 1e3 for s in rec["step_s"]]}
    emit("data_workers", card=card(), updates=DW_UPDATES,
         modes={k: " ".join(v) or "(no data flag)"
                for k, v in DW_MODES.items()},
         bert={"model": "bert_base", "dtype": "bf16", "batch": TRAIN_BATCH,
               "seq_len": 512, **report["bert"]},
         mol={"model": "unimol_base", "dtype": "fp16", "batch": MOL_BATCH,
              "max_atoms": MOL_ATOMS, **report["mol"]},
         launches={k: dict(v) for k, v in launches.items()})
    return {k: dict(v) for k, v in launches.items()}


# lm_run_control: run a and b's flags (validation every 4 updates at
# batch 8, at most 2 batches; epoch 1 unshuffled; mem_gb every 2
# dispatches; a checkpoint every 4 updates)
RC_FLAGS = ("--validate-interval-updates", "4", "--batch-size-valid", "8",
            "--max-valid-steps", "1", "--curriculum", "1", "--log-memory",
            "2", "--save-interval-updates", "4")
RC_UPDATES, RC_SIGTERM_AT, RC_VALID_RECORDS = 12, 6, 24
RC_STOP_AFTER = 6  # run c's --stop-time-hours: run b's time at update 6
RC_VALID_BATCHES = 2  # --max-valid-steps 1: batch indices 0 and 1
# run d: lr 5e-4 shrunk 10x an epoch from epoch 1, on 3 batches an epoch
RC_MIN_LR = 1e-6
RC_ANNEAL = ("--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
             "--adam-eps", "1e-6", "--lr-scheduler", "fixed", "--lr", "5e-4",
             "--force-anneal", "1", "--lr-shrink", "0.1")
RC_ANNEAL_RECORDS = 3 * TRAIN_BATCH
RC_PROFILE_UPDATES = 3


def observe_cli(argv, sigterm_at=None, kill_at=None):
    """Run the port's CLI on ``argv`` in this process and record what it
    did: each update's loss (nats, and the summed loss and sample size
    as exact floats), its batch's sha256, flash launches (and every
    flash and softmax_dropout kernel that launched), seconds (the card
    synchronized before and after) and training time
    (``cumulative_training_time``) after it, the iterator's state after
    it, the host seconds the loop waited for each batch
    (``_EpochStream.__next__``), each worker pool's fork seconds and
    PIDs, the card's memory at the start and its peak over the run (GB),
    the updates it validated and saved at, each validation pass's summed
    loss and sample size, flash launches and ms, the epochs it trained
    and the update count it started from.  ``kill_at``: once that update
    has run, SIGKILL one worker of the newest pool; ``sigterm_at``: the
    process sends itself SIGTERM once that update has run.  Returns
    (loop, record)."""
    import signal

    from unicore_tpu_torch import checkpoint_utils
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.data import iterators
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    Trainer, Loop = trainer_mod.Trainer, cli.TrainLoop
    Manager = checkpoint_utils.CheckpointManager
    Stream = iterators._EpochStream
    real = {"train_step": Trainer.train_step,
            "valid_step": Trainer.valid_step, "run": Loop.run,
            "train_epoch": Loop.train_epoch, "validate": Loop.validate,
            "validate_and_save": Loop.validate_and_save,
            "save": Manager.save, "next": Stream.__next__,
            "make_pool": Stream._make_pool}
    rec = {"nats": [], "loss": [], "digest": [], "update_launches": [],
           "launches": [], "step_s": [], "train_s": [], "state": {},
           "wait_s": [], "pools": [], "validated": [], "saved": [],
           "valid": [], "epochs": []}
    pooled = []  # the streams that forked a pool

    def train_step(self, samples):
        rec["digest"].append(batch_digest(samples[0]))
        before = {**fa.launches, **sd.launches}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["train_step"](self, samples)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        loss, size = float(out[0]["loss"]), float(out[0]["sample_size"])
        rec["loss"].append((loss, size))
        rec["nats"].append(loss / size)
        rec["update_launches"].append(
            {k: fa.launches[k] - before[k] for k in fa.launches})
        rec["launches"].append({
            k: v - before[k] for k, v in {**fa.launches,
                                          **sd.launches}.items()
            if v != before[k]})
        rec["train_s"].append(self.cumulative_training_time())
        if self.get_num_updates() == kill_at:
            rec["killed"] = next(iter(pooled[-1]._pool._processes.values())
                                 ).pid
            os.kill(rec["killed"], signal.SIGKILL)
        if self.get_num_updates() == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    def stream_next(stream):
        t0 = time.perf_counter()
        try:
            return real["next"](stream)
        finally:
            rec["wait_s"].append(time.perf_counter() - t0)

    def make_pool(stream):
        t0 = time.perf_counter()
        pool = real["make_pool"](stream)
        rec["pools"].append({"fork_s": time.perf_counter() - t0, "pids": [
            p.pid for p in pool._processes.values()]})
        if stream not in pooled:
            pooled.append(stream)
        return pool

    def validate_and_save(loop, epoch_itr, end_of_epoch):
        out = real["validate_and_save"](loop, epoch_itr, end_of_epoch)
        rec["state"][loop.trainer.get_num_updates()] = epoch_itr.state_dict()
        rec["status"] = epoch_itr.status()
        return out

    def valid_step(self, sample):
        out = real["valid_step"](self, sample)
        rec["valid"][-1]["loss"] += float(out[0]["loss"])
        rec["valid"][-1]["sample_size"] += float(out[0]["sample_size"])
        rec["valid"][-1]["batches"] += 1
        return out

    def run(loop, epoch_itr):
        rec["start_update"] = loop.trainer.get_num_updates()
        return real["run"](loop, epoch_itr)

    def train_epoch(loop, epoch_itr):
        out = real["train_epoch"](loop, epoch_itr)
        rec["epochs"].append(epoch_itr.epoch)
        return out

    def validate(loop, epoch_itr):
        rec["validated"].append(loop.trainer.get_num_updates())
        rec["valid"].append({"loss": 0.0, "sample_size": 0.0, "batches": 0})
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["validate"](loop, epoch_itr)
        torch.cuda.synchronize()
        rec["valid"][-1]["ms"] = (time.perf_counter() - t0) * 1e3
        rec["valid"][-1]["launches"] = {
            k: fa.launches[k] - before[k] for k in before
            if fa.launches[k] != before[k]}
        return out

    def save(manager, trainer, epoch_itr, val_loss, do_save=True):
        if do_save and not manager.args.no_save:
            rec["saved"].append(trainer.get_num_updates())
        return real["save"](manager, trainer, epoch_itr, val_loss,
                            do_save=do_save)

    Trainer.train_step, Trainer.valid_step = train_step, valid_step
    Loop.run, Loop.train_epoch, Loop.validate = run, train_epoch, validate
    Loop.validate_and_save, Manager.save = validate_and_save, save
    Stream.__next__, Stream._make_pool = stream_next, make_pool
    rec["start_gb"] = reset_peak_memory()
    try:
        loop = cli.cli_main(argv)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        Trainer.train_step = real["train_step"]
        Trainer.valid_step = real["valid_step"]
        Loop.run, Loop.train_epoch = real["run"], real["train_epoch"]
        Loop.validate, Manager.save = real["validate"], real["save"]
        Loop.validate_and_save = real["validate_and_save"]
        Stream.__next__, Stream._make_pool = real["next"], real["make_pool"]
    rec["respawns"] = sum(s.respawns for s in pooled)
    return loop, rec


def replay_stop_min_lr(argv, updates_per_epoch, stop_min_lr):
    """The epochs a run of ``argv`` trains before ``--stop-min-lr`` stops
    it, and the lr it stops at, from the port's scheduler on the host
    driven through the trainer's calls (construction, each epoch's begin,
    each update, each epoch's end)."""
    sched = host_scheduler(argv)
    lr, n, epoch = sched.step_update(0), 0, 0
    while lr > stop_min_lr:
        epoch += 1
        sched.step_begin_epoch(epoch)
        sched.step_update(n)
        for _ in range(updates_per_epoch):
            n += 1
            sched.step_update(n)
        sched.step(epoch, None)
        lr = sched.step_update(n)
    return epoch, lr


def lm_run_control_phase():
    """The port's CLI runs full-width transformer_lm_base (--bf16, the
    lm_train phase's flags) under the run-control flags of ``RC_FLAGS``
    with validation on, on the LM corpus with 24 valid records:

    - run a to --max-update 12 gets SIGTERM after update 6: it returns
      (exit 0) with the handlers restored, having validated at 4 and
      saved at 4 and at 6 (no validation at the signal); a second run on
      its save dir resumes at update 6 and reaches 12;
    - run b, uninterrupted, the same flags: the resumed run's losses,
      valid losses and final params bit-equal to b's, validation and
      saves at 4, 8 and 12; each validation pass 2 batches of 8 and 12
      bf16 flash forward launches a batch (row 3c at batch 8), each
      update 12 + 12 + 12 bf16 flash launches, no other flash kernel;
      the mem_gb records (every 2 dispatches) at most the run's peak
      (the resumed run's params moved off the card before run b);
    - run c, run b's flags and --stop-time-hours at run b's training
      time after update 6: stops before update 12 and saves there;
    - run d, --stop-min-lr 1e-6 under fixed with --force-anneal 1
      --lr-shrink 0.1 on 3 batches an epoch: stops after the epoch and
      at the lr that the port's scheduler on the host predicts;
    - run e, --profile for 3 updates: a Chrome trace under
      <save-dir>/torch_trace/ holding flash kernel events.

    Reports the updates each run validated and saved at, the validation
    passes' launches and ms, mem_gb against the peak, the update run c
    stopped at, run d's epochs and lr, and the trace's size and flash
    kernel events; returns the flash launch counts of runs a, a resumed
    and b, and of their validation passes."""
    import signal

    from unicore_tpu_torch.examples.lm import make_data
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    def argv(tmp, name, updates, *extra, validate=True, **kw):
        save = os.path.join(tmp, name)
        return lm_args(tmp, os.path.join(tmp, "log_" + name), updates,
                       "--save-dir", save, "--tmp-save-dir", save, *extra,
                       validate=validate, **kw)

    handlers = signal.getsignal(signal.SIGTERM), signal.getsignal(
        signal.SIGINT)
    with tempfile.TemporaryDirectory() as tmp:
        make_data.write_corpus(tmp, train=LM_RECORDS,
                               valid=RC_VALID_RECORDS, seed=2048)
        for counts in (fa.launches, sd.plain_route):
            for name in counts:
                counts[name] = 0
        t0 = time.perf_counter()
        run_a, a = observe_cli(argv(tmp, "a", RC_UPDATES, *RC_FLAGS),
                               sigterm_at=RC_SIGTERM_AT)
        a_s = time.perf_counter() - t0
        if (signal.getsignal(signal.SIGTERM), signal.getsignal(
                signal.SIGINT)) != handlers:
            raise AssertionError("the CLI left its signal handlers behind")
        del run_a
        resumed_loop, resumed = observe_cli(
            argv(tmp, "a", RC_UPDATES, *RC_FLAGS))
        # the resumed run's params leave the card, so run b's mem_gb and
        # peak are its own
        resumed_params = [p.detach().cpu()
                          for p in resumed_loop.trainer.model.parameters()]
        del resumed_loop
        run_b, b = observe_cli(argv(tmp, "b", RC_UPDATES, *RC_FLAGS))
        peak_gb = b["peak_gb"]
        launches = dict(fa.launches)
        with open(os.path.join(tmp, "log_b", "train_inner.jsonl")) as f:
            # the meter reads None at the dispatches that log no mem_gb
            mem = [(r["step"], r["mem_gb"]) for r in map(json.loads, f)
                   if r.get("mem_gb") is not None]

        layers = run_b.trainer.model.decoder_layers
        per_update = {n: layers if n in TRAIN_FLASH else 0
                      for n in fa.launches}
        per_pass = {"flash_fwd_bf16": layers * RC_VALID_BATCHES}
        for name, r in (("a", a), ("a resumed", resumed), ("b", b)):
            for u, got in enumerate(r["update_launches"]):
                if got != per_update:
                    raise AssertionError(f"run {name} update {u + 1}: flash "
                                         f"launches {got}, want {per_update}")
            for v in r["valid"]:
                if (v["launches"] != per_pass
                        or v["batches"] != RC_VALID_BATCHES):
                    raise AssertionError(f"run {name}: a validation pass "
                                         f"{v}, want {per_pass}")
        if any(sd.plain_route.values()):
            raise AssertionError(f"softmax_dropout took the plain route: "
                                 f"{sd.plain_route}")
        if (len(a["nats"]) != RC_SIGTERM_AT or a["validated"] != [4]
                or a["saved"] != [4, RC_SIGTERM_AT]):
            raise AssertionError(
                f"run a: {len(a['nats'])} updates, validated at "
                f"{a['validated']}, saved at {a['saved']}; want "
                f"{RC_SIGTERM_AT}, [4], [4, {RC_SIGTERM_AT}]")
        if (resumed["start_update"] != RC_SIGTERM_AT
                or resumed["validated"] != [8, 12]
                or resumed["saved"] != [8, 12]):
            raise AssertionError(
                f"run a resumed from update {resumed['start_update']}, "
                f"validated at {resumed['validated']}, saved at "
                f"{resumed['saved']}")
        if b["validated"] != [4, 8, 12] or b["saved"] != [4, 8, 12]:
            raise AssertionError(f"run b validated at {b['validated']}, "
                                 f"saved at {b['saved']}")
        if a["nats"] + resumed["nats"] != b["nats"]:
            raise AssertionError(f"run a then resumed {a['nats']} + "
                                 f"{resumed['nats']} != run b {b['nats']}")
        nll = [v["loss"] / v["sample_size"] for v in a["valid"]
               + resumed["valid"]]
        want_nll = [v["loss"] / v["sample_size"] for v in b["valid"]]
        if nll != want_nll:
            raise AssertionError(f"valid losses {nll} != run b's "
                                 f"{want_nll}")
        params_equal = all(torch.equal(p, q.detach().cpu()) for p, q in zip(
            resumed_params, run_b.trainer.model.parameters()))
        if not params_equal:
            raise AssertionError("resumed params at update 12 differ from "
                                 "run b's")
        if (not mem or [s for s, _ in mem] != list(range(2, RC_UPDATES + 1,
                                                         2))
                or not all(0 < g <= peak_gb + 0.005 for _, g in mem)):
            raise AssertionError(f"mem_gb records {mem}, peak {peak_gb}")
        nats = b["nats"]
        if not 9.0 <= nats[0] <= 11.5 or not np.isfinite(nats).all():
            raise AssertionError(f"run b's losses {nats}")
        del resumed_params, run_b
        gc.collect()
        torch.cuda.empty_cache()

        # below the time of 12 updates: run b's training time at update 6
        stop_hours = b["train_s"][RC_STOP_AFTER - 1] / 3600.0
        _, c = observe_cli(argv(tmp, "c", RC_UPDATES, *RC_FLAGS,
                                "--stop-time-hours", repr(stop_hours)))
        stopped = len(c["nats"])
        if not 0 < stopped < RC_UPDATES or c["saved"][-1:] != [stopped]:
            raise AssertionError(f"run c stopped after {stopped} updates, "
                                 f"saved at {c['saved']}")

        anneal = os.path.join(tmp, "anneal")
        make_data.write_corpus(anneal, train=RC_ANNEAL_RECORDS, valid=8,
                               seed=2050)
        argv_d = lm_args(anneal, os.path.join(anneal, "log"), 100,
                         "--stop-min-lr", repr(RC_MIN_LR), "--save-dir",
                         anneal, "--no-save", optim=RC_ANNEAL)
        run_d, d = observe_cli(argv_d)
        want_epochs, want_lr = replay_stop_min_lr(
            argv_d, RC_ANNEAL_RECORDS // TRAIN_BATCH, RC_MIN_LR)
        lr_d = run_d.trainer.get_lr()
        if d["epochs"] != list(range(1, want_epochs + 1)) or lr_d != want_lr:
            raise AssertionError(f"run d trained epochs {d['epochs']} and "
                                 f"stopped at lr {lr_d}; the host schedule "
                                 f"says {want_epochs} epochs, lr {want_lr}")
        del run_d

        _, e = observe_cli(argv(tmp, "e", RC_PROFILE_UPDATES, "--profile",
                                "--no-save", validate=False))
        trace = os.path.join(tmp, "e", "torch_trace", "trace.json")
        trace_bytes = os.path.getsize(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        flash_events = sum(1 for ev in events if ev.get("cat") == "kernel"
                           and "flash_" in ev.get("name", ""))
        if len(e["nats"]) != RC_PROFILE_UPDATES or not flash_events:
            raise AssertionError(f"run e: {len(e['nats'])} updates, "
                                 f"{flash_events} flash kernel events")
        del events
    valid_launches = {k: sum(v["launches"].get(k, 0)
                             for r in (a, resumed, b) for v in r["valid"])
                      for k in fa.launches}
    emit("lm_run_control", model="transformer_lm_base", dtype="bf16",
         batch=TRAIN_BATCH, batch_valid=8, seq_len=FLASH_T, flags=RC_FLAGS,
         card=card(),
         runs={"a": {k: a[k] for k in ("validated", "saved")},
               "a_resumed": {"from": resumed["start_update"],
                             "validated": resumed["validated"],
                             "saved": resumed["saved"]},
               "b": {k: b[k] for k in ("validated", "saved")}},
         sigterm_after=RC_SIGTERM_AT, run_a_s=a_s,
         resumed_bit_equal={"losses": True, "valid_losses": True,
                            "params": params_equal},
         losses_nats=nats, valid_nll=want_nll,
         flash_launches_per_update=per_update,
         flash_launches_per_valid_pass=per_pass,
         valid_pass_ms=[v["ms"] for r in (a, resumed, b)
                        for v in r["valid"]],
         valid_launches=valid_launches, mem_gb=mem, peak_mem_gb=peak_gb,
         mem_at_start_gb=a["start_gb"],
         run_b_mem_at_start_gb=b["start_gb"],
         stop_time={"stop_time_hours": stop_hours,
                    "run_b_training_s": b["train_s"],
                    "stopped_at": stopped,
                    "validated": c["validated"], "saved": c["saved"],
                    "training_s": c["train_s"]},
         stop_min_lr={"stop_min_lr": RC_MIN_LR, "epochs": d["epochs"],
                      "updates": len(d["nats"]), "lr": lr_d,
                      "host_epochs": want_epochs, "host_lr": want_lr},
         profile={"updates": RC_PROFILE_UPDATES, "trace_bytes": trace_bytes,
                  "flash_kernel_events": flash_events,
                  "want_flash_kernel_events":
                      RC_PROFILE_UPDATES * 3 * layers})
    return {"launches": launches, "valid_launches": valid_launches}


CROSS_ENC_T, CROSS_DEC_T, CROSS_PASSES = 512, 256, 4
CROSS_LAYERS = 12
# max |card - CPU| of the decoder's output and of each gradient, as a
# share of the CPU tensor's largest magnitude (fp32, TF32 off, rel-pos
# tables at normal(1)): what this comparison allows, beside the error it
# measures (PERF.md gives both readings)
CROSS_CPU_REL = 1e-4


def cross_stacks(seed, dtype, device, dropout, table_std=0.02):
    """A ``bert_base``-width encoder (12 layers, 768, FFN 3072, 12
    heads, post-LN, rel-pos, context 512) and a ``transformer_lm_base``-
    width decoder (the same widths, pre-LN, rel-pos, causal) built with
    cross-attention, their weights drawn on the CPU from ``seed`` as the
    JAX package initializes (normal(0.02) weights, zero biases, unit
    LayerNorm scales; the rel-pos tables at normal(``table_std``)), then
    moved to ``device`` in ``dtype``, in training mode."""
    from torch import nn

    from unicore_tpu_torch.modules import (LayerNorm, TransformerDecoder,
                                           TransformerEncoder)

    gen = torch.Generator().manual_seed(seed)
    kw = dict(embed_dim=768, ffn_embed_dim=3072, attention_heads=12,
              emb_dropout=dropout, dropout=dropout,
              attention_dropout=dropout)
    enc = TransformerEncoder(encoder_layers=CROSS_LAYERS,
                             max_seq_len=CROSS_ENC_T, post_ln=True, **kw)
    dec = TransformerDecoder(decoder_layers=CROSS_LAYERS,
                             max_seq_len=CROSS_DEC_T,
                             encoder_attn=True, **kw)
    with torch.no_grad():
        for mod in (enc, dec):
            for m in mod.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.02, generator=gen)
                    m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            mod.relative_attention_bias.weight.normal_(0.0, table_std,
                                                       generator=gen)
    return enc.to(device, dtype).train(), dec.to(device, dtype).train()


def cross_inputs(bsz, seed, dtype, device):
    """Embeddings of both sides (normal), the encoder's padding (a tail of
    0-200 keys a row), the decoder's (a tail of 0-64 a row) and the
    loss's weights, drawn on the CPU from ``seed``."""
    rng = np.random.default_rng(seed)
    enc_x = rng.standard_normal((bsz, CROSS_ENC_T, 768), dtype=np.float32)
    dec_x = rng.standard_normal((bsz, CROSS_DEC_T, 768), dtype=np.float32)
    w = rng.standard_normal((bsz, CROSS_DEC_T, 768), dtype=np.float32)
    enc_pad = np.zeros((bsz, CROSS_ENC_T), np.int32)
    dec_pad = np.zeros((bsz, CROSS_DEC_T), np.int32)
    for b in range(bsz):
        enc_pad[b, CROSS_ENC_T - rng.integers(0, 201):] = 1
        dec_pad[b, CROSS_DEC_T - rng.integers(0, 65):] = 1

    def t(a, cast=True):
        a = torch.from_numpy(a).to(device)
        return a.to(dtype) if cast else a

    return t(enc_x), t(dec_x), t(w, False), t(enc_pad, False), t(dec_pad,
                                                                 False)


def cross_pass(enc, dec, inputs, generator):
    """One forward and backward of the seeded loss ``sum(out * w)``
    through both stacks; returns the loss, the decoder's output and the
    flash launches of each stage (the encoder's forward, the decoder's,
    the backward)."""
    from unicore_tpu_torch.ops import flash_attention as fa

    enc_x, dec_x, w, enc_pad, dec_pad = inputs
    marks = [dict(fa.launches)]
    memory = enc(enc_x, padding_mask=enc_pad, generator=generator)
    marks.append(dict(fa.launches))
    out = dec(dec_x, padding_mask=dec_pad, generator=generator,
              encoder_out=memory, encoder_padding_mask=enc_pad)
    marks.append(dict(fa.launches))
    loss = (out.float() * w).sum()
    loss.backward()
    marks.append(dict(fa.launches))
    stages = {name: {k: after[k] - before[k] for k in before
                     if after[k] != before[k]}
              for name, before, after in zip(
                  ("encoder", "decoder", "backward"), marks, marks[1:])}
    return loss.detach(), out.detach(), stages


def cross_decoder_phase():
    """Full-width cross-attention on the card: the ``cross_stacks``
    encoder over 512 tokens with a padded tail feeding the decoder's 256
    through every layer's cross-attention, batch 8, bf16, dropout 0.1,
    ``CROSS_PASSES`` forward and backward passes of a seeded loss.  Every
    pass launches the bf16 flash forward 12 times in the encoder (one a
    layer, at (512, 512)) and 24 in the decoder (its causal
    self-attention at (256, 256) and its cross-attention at (256, 512),
    one each a layer), and the two backward kernels 36 times each, one
    pair for each forward call, and nothing else of flash; the
    cross-attention's share is 12 of each.  Reports the pass's ms, device
    time and launches (``torch.profiler``, one pass) and peak memory.
    Then batch 2, dropout 0, fp32 (TF32 off), rel-pos tables at
    normal(1), on the card and on the CPU (every wrapper there runs its
    plain version): the decoder's output and every gradient within
    CROSS_CPU_REL of the CPU tensor's largest magnitude; returns the
    cross-attention calls' launches and all of the phase's."""
    from unicore_tpu_torch.ops import flash_attention as fa

    start_gb = reset_peak_memory()
    enc, dec = cross_stacks(19, torch.bfloat16, "cuda", 0.1)
    inputs = cross_inputs(8, 19, torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    pass_ms, losses = [], []
    want_stages = {"encoder": {"flash_fwd_bf16": CROSS_LAYERS},
                   "decoder": {"flash_fwd_bf16": 2 * CROSS_LAYERS},
                   "backward": {"flash_bwd_dkdv": 3 * CROSS_LAYERS,
                                "flash_bwd_dq": 3 * CROSS_LAYERS}}
    for name in fa.launches:
        fa.launches[name] = 0
    for i in range(CROSS_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, stages = cross_pass(enc, dec, inputs, gen)
        losses.append(float(loss))
        torch.cuda.synchronize()
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        if stages != want_stages:
            raise AssertionError(f"pass {i + 1}: flash launches {stages}, "
                                 f"want {want_stages}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    launches = {k: v for k, v in fa.launches.items() if v}
    cross = {n: CROSS_PASSES * CROSS_LAYERS for n in TRAIN_FLASH}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = device_launches(lambda: cross_pass(enc, dec, inputs, gen))
    del enc, dec, inputs
    torch.cuda.empty_cache()

    # batch 2, dropout 0, fp32: the card against the CPU's plain versions
    outs, grads = {}, {}
    for device in ("cuda", "cpu"):
        enc, dec = cross_stacks(19, torch.float32, device, 0.0,
                                table_std=1.0)
        inputs = cross_inputs(2, 20, torch.float32, device)
        _, outs[device], _ = cross_pass(enc, dec, inputs, None)
        grads[device] = {f"{side}.{n}": p.grad
                         for side, mod in (("enc", enc), ("dec", dec))
                         for n, p in mod.named_parameters()}
    errs = {}
    for name, got, want in [("out", outs["cuda"], outs["cpu"])] + [
            (n, grads["cuda"][n], g) for n, g in grads["cpu"].items()]:
        err = float((got.cpu() - want).abs().max())
        # a k_proj bias adds q.b to a whole row of scores, which the
        # softmax cancels: its gradient is rounding noise, held on the
        # scale of its kernel's gradient
        ref = (grads["cpu"][name[:-len("bias")] + "weight"]
               if name.endswith("k_proj.bias") else want)
        scale = float(ref.abs().max())
        errs[name] = err / scale if scale else err
        if not (torch.isfinite(got).all() and err <= CROSS_CPU_REL * scale):
            raise AssertionError(f"{name}: max |card - CPU| {err} > "
                                 f"{CROSS_CPU_REL} x {scale}")
    worst = max(errs, key=errs.get)
    emit("cross_decoder", card=card(), batch=8, dtype="bf16",
         encoder={"layers": CROSS_LAYERS, "width": 768, "T": CROSS_ENC_T},
         decoder={"layers": CROSS_LAYERS, "width": 768, "T": CROSS_DEC_T},
         dropout=0.1, losses=losses, pass_ms=pass_ms,
         pass_ms_median=float(np.median(pass_ms[1:])),
         flash_launches_per_pass=want_stages, launches=launches,
         cross_attention_launches=cross,
         pass_device_ms=prof["device_ms"], pass_launches=prof["launches"],
         peak_mem_gb=peak_gb, mem_at_start_gb=start_gb,
         cpu_check={"batch": 2, "dtype": "fp32", "dropout": 0.0,
                    "table_std": 1.0, "bound_rel": CROSS_CPU_REL,
                    "out_rel_err": errs["out"], "worst": worst,
                    "worst_rel_err": errs[worst], "tensors": len(errs)})
    del enc, dec, inputs, grads, outs
    torch.cuda.empty_cache()
    return {"cross_attention": cross, "all": launches}


def return_attn_phase():
    """A ``bert_base`` encoder layer (768, FFN 3072, 12 heads, post-LN,
    dropout 0.1) with ``return_attn=True`` on the card in bf16: batch 8 x
    512, a tail of 0-200 padded keys a row, a [1, 12, 512, 512] bias.
    One forward and backward launches the softmax_dropout forward and
    backward kernels once each, at [8, 12, 512, 512] with no mask and no
    bias, and no flash kernel.  Both are held on the path's own tensors
    under the same seed: the returned scores through the forward kernel
    again give ``probs`` bit for bit and, against the plain forward, the
    same keep pattern and out and softmax within one bf16 ulp at every
    element; the gradient the path's backward kernel returned (hooked on
    the scores) equals the kernel's again on the gradient it was given
    (hooked on ``probs``) and the kernel's own softmax, and is held
    against the plain backward by ``check_backward``.  Reports the
    errors and the call's ms."""
    from unicore_tpu_torch.modules import TransformerEncoderLayer
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import prng
    from unicore_tpu_torch.ops import softmax_dropout as sd

    torch.manual_seed(7)
    layer = TransformerEncoderLayer(768, 3072, 12, post_ln=True).to(
        "cuda", torch.bfloat16).train()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (8, 512, 768), dtype=np.float32)).cuda().to(torch.bfloat16)
    x.requires_grad_()
    bias = torch.from_numpy(rng.standard_normal(
        (1, 12, 512, 512), dtype=np.float32)).cuda().to(torch.bfloat16)
    pad = np.zeros((8, 512), np.int32)
    for b in range(8):
        pad[b, 512 - rng.integers(0, 201):] = 1
    pad = torch.from_numpy(pad).cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = gen.get_state()
    seen = {}

    def call(hook=False):
        out, weights, probs = layer(x, bias, pad, gen, return_attn=True)
        if hook:  # dx into the scores, g into the probabilities
            weights.register_hook(lambda d: seen.__setitem__("dx", d))
            probs.register_hook(lambda g: seen.__setitem__("g", g))
        (out.float().sum() + probs.float().sum()).backward()
        return weights.detach(), probs.detach()

    for counts in (sd.launches, fa.launches, sd.plain_route):
        for name in counts:
            counts[name] = 0
    weights, probs = call(hook=True)
    torch.cuda.synchronize()
    used = {k: v for k, v in {**sd.launches, **fa.launches}.items() if v}
    want = {"softmax_dropout_fwd": 1, "softmax_dropout_bwd": 1}
    if used != want:
        raise AssertionError(f"launches {used}, want {want}")
    if any(sd.plain_route.values()):
        raise AssertionError(f"plain route taken: {sd.plain_route}")
    # the same seed: the layer's first draw is the softmax's
    replay = torch.Generator(device="cuda")
    replay.set_state(state)
    seed = prng.draw_seeds(replay, (1,))
    q_blk = sd.pick_q_blk_for(weights, None, None)
    out_k, sm_k = sd.softmax_dropout_fwd_cuda(weights, None, None, 0.1, seed,
                                              q_blk, True)
    out_p, sm_p = sd.softmax_dropout_fwd_plain(weights, None, None, 0.1,
                                               seed, q_blk, True)
    dx, g = seen["dx"], seen["g"]
    dx_k = sd.softmax_dropout_bwd_cuda(g, sm_k, 0.1, seed, q_blk)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, probs) and torch.equal(dx_k, dx)):
        raise AssertionError("the kernels on the path's own inputs do not "
                             "give the path's probs and dx again")
    same_keep = bool(torch.equal(probs == 0, out_p == 0))
    ulps = {"out": ulp_distance(probs, out_p, torch.bfloat16),
            "softmax": ulp_distance(sm_k, sm_p, torch.bfloat16)}
    if not same_keep or max(ulps.values()) > 1.0:
        raise AssertionError(f"forward vs plain: keep pattern equal "
                             f"{same_keep}, bf16 ulps {ulps} (bound 1)")
    errs = sd.check_backward(dx, g, sm_k, 0.1, seed, q_blk)
    errs["out"] = float((probs.float() - out_p.float()).abs().max())
    errs["softmax"] = float((sm_k.float() - sm_p.float()).abs().max())
    if not all(torch.isfinite(t).all() for t in (probs, sm_k, dx)):
        raise AssertionError("non-finite probs, softmax or dx")
    ms = time_ms(call, torch.empty(0, device="cuda"), iters=10)
    emit("return_attn", card=card(), layer="bert_base", batch=8, T=512,
         dtype="bf16", kernel_shape=list(weights.shape), q_blk=q_blk,
         launches=want, keep_pattern_equal=True, max_bf16_ulps=ulps,
         ulp_bound=1.0, max_abs_err=errs, fwd_bwd_ms=ms, l2_flushed=False)
    del layer, x, bias, weights, probs, out_k, sm_k, out_p, sm_p, dx, g
    del dx_k, seen
    torch.cuda.empty_cache()
    return want


CA_UPDATES, CA_BERT_UPDATES = 8, 4


def lm_checkpoint_activations_phase():
    """``--checkpoint-activations`` in full-width training: the lm_train
    phase's transformer_lm_base (--bf16, batch 16 x 512, dropout 0.1),
    8 updates a run in turns without the flag, with it, with it, without
    it; then bert_base (the train phase's flags) 4 updates without and
    with it.  Losses and final params bit-equal across the flag; per
    update the flash forward runs twice a layer with the flag (the
    recompute) and the two backward kernels once.  Reports each run's
    peak memory, step median and device time per update (a profiled
    window of 2 more updates); returns the launch counts of the first
    run with the flag on, LM and BERT."""
    flag = ("--checkpoint-activations",)

    def recorded(argv):
        """``observe_cli`` on ``argv``; also each update's flash launches
        without the kernels it did not launch, and their sum."""
        loop, rec = observe_cli(argv)
        rec["launches"] = [{k: v for k, v in u.items() if v}
                           for u in rec["update_launches"]]
        rec["launches_total"] = dict(sum(map(Counter, rec["launches"]),
                                         Counter()))
        return loop, rec

    out = {"lm": [], "bert": []}
    with tempfile.TemporaryDirectory() as tmp:
        lm_corpus(tmp)
        params = {}
        for i, on in enumerate((False, True, True, False)):
            loop, rec = recorded(lm_args(
                tmp, os.path.join(tmp, f"log_lm{i}"), CA_UPDATES, "--no-save",
                *(flag if on else ())))
            layers = loop.trainer.model.decoder_layers
            want = {"flash_fwd_bf16": layers * (2 if on else 1),
                    "flash_bwd_dkdv": layers, "flash_bwd_dq": layers}
            if any(r != want for r in rec["launches"]):
                raise AssertionError(f"LM run {i} (flag {on}): launches "
                                     f"{rec['launches']}, want {want}")
            if loop.trainer.model.decoder.checkpoint_activations is not on:
                raise AssertionError("the flag did not reach the decoder")
            prof = profile_updates(loop.trainer, n=2, named=TRAIN_FLASH)
            params[i] = [p.detach().cpu()
                         for p in loop.trainer.model.parameters()]
            out["lm"].append({
                "flag": on, "losses_nats": rec["nats"],
                "step_ms_median": float(np.median(rec["step_s"][2:])) * 1e3,
                "step_ms_all": [x * 1e3 for x in rec["step_s"]],
                "peak_mem_gb": rec["peak_gb"], "mem_at_start_gb":
                rec["start_gb"],
                "peak_rise_gb": rec["peak_gb"] - rec["start_gb"],
                "launches_per_update": want,
                "launches": rec["launches_total"],
                "device_ms_per_update": prof["device_busy_ms"] / 2,
                "profile_launches_per_update": prof["kernel_launches"] / 2,
                "flash_ms_per_update": {k: v / 2 for k, v in
                                        prof["named_ms"].items()}})
            del loop
            torch.cuda.empty_cache()
        for i in (1, 2, 3):
            if out["lm"][i]["losses_nats"] != out["lm"][0]["losses_nats"]:
                raise AssertionError(f"LM run {i} losses differ from run 0")
            if not all(torch.equal(a, b)
                       for a, b in zip(params[i], params[0])):
                raise AssertionError(f"LM run {i} params differ from run 0")
        del params
        emit("lm_checkpoint_activations", card=card(),
             model="transformer_lm_base", dtype="bf16", batch=TRAIN_BATCH,
             seq_len=FLASH_T, updates=CA_UPDATES, runs=out["lm"],
             losses_and_params_bit_equal=True)
        bert = os.path.join(tmp, "bert")
        os.makedirs(bert)
        write_corpus(bert)
        params = {}
        for on in (False, True):
            loop, rec = recorded(bert_args(
                bert, os.path.join(tmp, f"log_bert{on}"), CA_BERT_UPDATES)
                + ["--no-save", *(flag if on else ())])
            layers = loop.trainer.model.encoder_layers
            want = {"flash_fwd_bf16": layers * (2 if on else 1),
                    "flash_bwd_dkdv": layers, "flash_bwd_dq": layers}
            if any(r != want for r in rec["launches"]):
                raise AssertionError(f"BERT (flag {on}): launches "
                                     f"{rec['launches']}, want {want}")
            params[on] = [p.detach().cpu()
                          for p in loop.trainer.model.parameters()]
            out["bert"].append({
                "flag": on, "losses_nats": rec["nats"],
                "step_ms_median": float(np.median(rec["step_s"][1:])) * 1e3,
                "peak_mem_gb": rec["peak_gb"],
                "peak_rise_gb": rec["peak_gb"] - rec["start_gb"],
                "launches_per_update": want,
                "launches": rec["launches_total"]})
            del loop
            torch.cuda.empty_cache()
        if out["bert"][0]["losses_nats"] != out["bert"][1]["losses_nats"] \
                or not all(torch.equal(a, b)
                           for a, b in zip(params[False], params[True])):
            raise AssertionError("BERT losses or params differ across the "
                                 "flag")
        emit("bert_checkpoint_activations", card=card(), model="bert_base",
             dtype="bf16", batch=TRAIN_BATCH, updates=CA_BERT_UPDATES,
             runs=out["bert"], losses_and_params_bit_equal=True)
    return {"lm": out["lm"][1]["launches"],
            "bert": out["bert"][1]["launches"]}


# the reference's larger BERT configurations (examples/bert/model.py):
# arch -> (layers, width, heads); a few updates each, warmup 2
ARCHS = {"bert_large": (24, 1024, 16), "xlm": (16, 1280, 16)}
ARCH_UPDATES, ARCH_WARMUP = 6, 2
# xlm's attention call: B 16, H 16, T 512, D 80 with its [1, 16, 512,
# 512] rel-pos bias, bf16; the same B, H, T at D 64 beside it
XLM_FLASH_SHAPE, XLM_D64_SHAPE = (16, 16, 512, 80), (16, 16, 512, 64)
HEAD_NAME, HEAD_CLASSES, POOLER_P = "smoke", 2, 0.1
# max |card - CPU| of the classification head, a share of each tensor's
# largest magnitude: the logits one bf16 ulp there (2^-7 bounds the ulp
# of any element), the grads two (each sums 16 rows' bf16 products in
# cuBLAS's order on the card and another on the CPU)
HEAD_REL_TOL = {"logits": 2.0 ** -7, "grads": 2.0 ** -6}


def xlm_flash_case(flush):
    """Rows 3 and 8 at xlm's head dim of 80 (the D = 128 kernel build
    with 48 zero columns): the forward and the backward's two kernels
    against their plain versions at xlm's attention call, as
    ``flash_case`` holds them, SDPA (cuDNN among its backends) on the
    same call, the forward's keep bits read back exactly; then the same
    B, H, T at D = 64, held and timed the same way, so the two head dims
    read side by side.  Returns {"d80": report, "d64": report}."""
    d80 = flash_case(flush, torch.bfloat16, XLM_FLASH_SHAPE, True,
                     np.random.default_rng(80), (10, 3, 10))
    keep = keep_bits(torch.bfloat16, XLM_FLASH_SHAPE, True, 80,
                     causal=False)
    if keep["bits_differ"] or keep["excluded_read_nonzero"]:
        raise AssertionError(f"xlm D = 80: keep bits {keep}")
    d80["keep_bits"] = keep
    d64 = flash_case(flush, torch.bfloat16, XLM_D64_SHAPE, True,
                     np.random.default_rng(80), (10, 3, 10))
    ratio = {n: d80["kernels"][n]["ms"] / d64["kernels"][n]["ms"]
             for n in TRAIN_FLASH}
    emit("xlm_flash", card=card(), d80=d80, d64=d64, d80_over_d64=ratio)
    return {"d80": d80, "d64": d64}


def classification_head_check(trainer):
    """A classification head (``HEAD_CLASSES`` outputs) registered on the
    trained model's bf16 copy, at full width: the [CLS] features of one
    batch from the card's encoder (``classification_head_name`` forces
    the features path), the head's logits and the grads of sum(logits *
    w) for the features and the head's weights on the card, against the
    same head on the CPU fed the same features, within HEAD_REL_TOL; the
    model's own call with ``classification_head_name`` gives the card
    head's logits.  Then pooler dropout at rate ``POOLER_P`` from a card
    generator: the kept share within 4 sigma of 1 - rate over 2^22
    draws, the survivors the inputs divided by bf16(1 - rate), the rest
    0, and the same generator state the same mask."""
    import copy

    from unicore_tpu_torch.ops.dropout import bernoulli_dropout

    model = trainer.compute_model
    model.eval()
    head = model.register_classification_head(HEAD_NAME, HEAD_CLASSES)
    itr = trainer.get_train_iterator(epoch=3).next_epoch_itr()
    toks = torch.as_tensor(next(itr)["net_input"]["src_tokens"]).cuda()
    with torch.no_grad():
        feats = model(toks, features_only=True)
        via_model = model(toks, classification_head_name=HEAD_NAME)
    w = torch.randn(feats.shape[0], HEAD_CLASSES,
                    generator=torch.Generator().manual_seed(2))
    sides = {}
    for device, h in (("cuda", head), ("cpu", copy.deepcopy(head).cpu())):
        x = feats.to(device).detach().requires_grad_()
        h.zero_grad()
        logits = h(x)
        (logits.float() * w.to(device)).sum().backward()
        sides[device] = {"logits": logits.detach()[:, :], "features": x.grad,
                         **{n: p.grad for n, p in h.named_parameters()}}
    if not torch.equal(via_model, sides["cuda"]["logits"]):
        raise AssertionError("the model's classification call differs "
                             "from its head's")
    errs = {}
    for name, got in sides["cuda"].items():
        want = sides["cpu"][name].float()
        got = got.float().cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"head {name}: shape {tuple(got.shape)} "
                                 "or non-finite values")
        tol = HEAD_REL_TOL["logits" if name == "logits" else "grads"]
        err = float((got - want).abs().max())
        if err > tol * float(want.abs().max()):
            raise AssertionError(f"head {name}: max |card - CPU| {err} > "
                                 f"{tol} of {float(want.abs().max())}")
        errs[name] = err / float(want.abs().max())
    x = torch.randn(4096, 1024, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    state = gen.get_state()
    dropped = bernoulli_dropout(x, POOLER_P, gen)
    gen.set_state(state)
    again = bernoulli_dropout(x, POOLER_P, gen)
    kept = dropped != 0
    share = float(kept.double().mean())
    sigma = (POOLER_P * (1 - POOLER_P) / x.numel()) ** 0.5
    scale = torch.tensor(1 - POOLER_P, dtype=torch.bfloat16, device="cuda")
    exact = bool(torch.equal(dropped[kept], (x / scale)[kept]))
    if abs(share - (1 - POOLER_P)) > 4 * sigma or not exact or \
            not torch.equal(dropped, again):
        raise AssertionError(f"pooler dropout: kept {share}, survivors "
                             f"scaled exactly {exact}")
    del model.classification_heads[HEAD_NAME]
    model.train()
    return {"num_classes": HEAD_CLASSES, "features": list(feats.shape),
            "dtype": str(feats.dtype).replace("torch.", ""),
            "max_err_share_of_max": errs, "tolerance": HEAD_REL_TOL,
            "model_call_equals_head": True,
            "pooler_dropout": {"rate": POOLER_P, "kept_share": share,
                               "draws": x.numel(), "sigma": sigma,
                               "survivors_scaled_exactly": exact,
                               "same_state_same_mask": True}}


def bert_arch_train(arch, corpus, logdir):
    """The port's CLI trains full-width ``arch`` under --bf16 (batch 16
    x 512, Adam (0.9, 0.98), eps 1e-6, lr 1e-4 after 2 warmup updates,
    polynomial decay over 20) for
    ``ARCH_UPDATES`` updates: every loss finite and the last below the
    first, every update's flash launches once a layer for each bf16
    kernel and no other flash kernel, softmax_dropout's plain route
    never.  Returns (the run's report, its trainer)."""
    from unicore_tpu_torch import trainer as trainer_mod
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    layers, width, heads = ARCHS[arch]
    steps = []
    train_step = trainer_mod.Trainer.train_step

    def timed(self, samples):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, samples)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t,
                      {k: fa.launches[k] - before[k] for k in before}))
        return out

    for counts in (fa.launches, sd.plain_route):
        for name in counts:
            counts[name] = 0
    trainer_mod.Trainer.train_step = timed
    start_gb = reset_peak_memory()
    t0 = time.perf_counter()
    try:
        loop = cli_main(bert_args(corpus, logdir, ARCH_UPDATES, arch=arch,
                                  warmup=ARCH_WARMUP)
                        + ["--no-save"])
    finally:
        trainer_mod.Trainer.train_step = train_step
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(sd.plain_route.values()):
        raise AssertionError(f"{arch}: softmax_dropout took the plain route "
                             f"{sd.plain_route}")
    model = loop.trainer.model
    got = (model.encoder_layers, model.encoder_embed_dim,
           model.flax_heads)
    if got != (layers, width, heads):
        raise AssertionError(f"{arch}: built {got}, the preset is "
                             f"{(layers, width, heads)}")
    per_update = {n: layers if n in TRAIN_FLASH else 0 for n in fa.launches}
    for i, (_, launches) in enumerate(steps):
        if launches != per_update:
            raise AssertionError(f"{arch} update {i + 1}: flash launches "
                                 f"{launches}, want {per_update}")
    with open(os.path.join(logdir, "train_inner.jsonl")) as f:
        nats = [json.loads(line)["loss"] * np.log(2) for line in f]
    if len(nats) != ARCH_UPDATES or not np.isfinite(nats).all():
        raise AssertionError(f"{arch}: losses {nats}")
    if not nats[-1] < nats[0]:
        raise AssertionError(f"{arch}: loss did not fall: {nats}")
    med_s = float(np.median([s for s, _ in steps[2:]]))
    return {
        "model": arch, "layers": layers, "width": width, "heads": heads,
        "head_dim": width // heads, "dtype": "bf16", "batch": TRAIN_BATCH,
        "seq_len": 512, "updates": ARCH_UPDATES,
        "params": sum(p.numel() for p in model.parameters()),
        "run_s": run_s, "losses_nats": nats,
        "step_ms_all": [s * 1e3 for s, _ in steps],
        "step_ms_median": med_s * 1e3,
        "samples_per_s": TRAIN_BATCH / med_s,
        "peak_mem_gb": peak_gb, "mem_at_start_gb": start_gb,
        "flash_launches_per_update": per_update,
        "launches": dict(fa.launches)}, loop.trainer


def bert_archs_phase():
    """bert_large_train, then xlm_train, on one corpus (``write_corpus``):
    each ``bert_arch_train`` and a ``torch.profiler`` window of 3 more
    updates (device busy, idle share, launches, top kernels), then one
    Adam step's launches and device ms at that width.  bert_large_train
    adds the classification-head check (``classification_head_check``),
    xlm_train first the D = 80 kernels (``xlm_flash_case``).  Returns
    {arch: the flash launch counts of its run}, with xlm's kernel
    reports under "xlm_flash"."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp)
        corpus_s = time.perf_counter() - t0
        for arch in ARCHS:
            t0 = time.perf_counter()
            extra = {}
            if arch == "xlm":
                flush = torch.empty(256 << 20, dtype=torch.uint8,
                                    device="cuda")
                out["xlm_flash"] = xlm_flash_case(flush)
                del flush
                torch.cuda.empty_cache()
            report, trainer = bert_arch_train(
                arch, tmp, os.path.join(tmp, f"log_{arch}"))
            prof = profile_updates(trainer)
            extra["optimizer_step"] = optimizer_step_profile(trainer)
            if arch == "bert_large":
                extra["classification_head"] = classification_head_check(
                    trainer)
            out[arch] = report["launches"]
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            emit(f"{arch}_train", card=card(), corpus_s=corpus_s,
                 phase_s=time.perf_counter() - t0, **report, **extra,
                 profile={"window": "3 updates, batch 16 x 512, bf16",
                          **prof})
    return out


PALLAS = "unicore_tpu/ops/pallas/"


def flash_row(row, name, replaces, case, launches):
    """A kernels-line row of a bf16 or fp16 flash kernel from one case's
    report."""
    fwd = name.startswith("flash_fwd")
    errs = (("out",) if fwd else ("dk", "dv") if "dkdv" in name
            else ("dq", "dbias"))
    kern = case["kernels"][name]
    entry = {
        "row": row, "name": name, "dtype": case["dtype"], "route": "cuda",
        "source": "unicore_tpu_torch/csrc/" + (
            "flash_attention_fwd.cu" if fwd else "flash_attention_bwd.cu"),
        "replaces": PALLAS + replaces, "launches": launches,
        "max_abs_err": max(case["max_abs_err"][e] for e in errs
                           if e in case["max_abs_err"]),
        "ms": kern["ms"],
        # the plain backward computes every gradient at once
        "plain_ms": case["plain_fwd_ms" if fwd else "plain_bwd_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        # no library call computes a backward pass alone
        "library_ms": case["sdpa_fwd_ms"] if fwd else None,
        "sdpa_fwd_bwd_ms": case["sdpa_fwd_bwd_ms"],
        "sdpa_backend": case["sdpa_backend"],
        "sdpa_other": case["sdpa_other"],
        "tflops": kern["tflops"], "shape": case["shape"],
    }
    if not fwd:  # the row's whole backward: every kernel beside one bound
        entry["bwd_kernels_ms"] = case["bwd_kernels_ms"]
        entry["bwd_bound_ms"] = case["bwd_bound_ms"]
        entry["bwd_bound_by"] = case["bwd_bound_by"]
    return entry


def kernels_line(res):
    """One row per TPU kernel of the table in PERF.md (rows 1-11), from
    ``res``, the phases' results by name (see ``main``); a row
    realized by two CUDA kernels (4, 8) has one entry for each, and the
    flash rows (2-8) and the softmax_dropout rows (9-10) one for each of
    the bf16 and the fp16 instantiations.  A flash row's launches count
    its CUDA kernel on the BERT training path of its type (the train
    phase for bf16, train_fp16 for fp16); a softmax_dropout row's on the
    Evoformer's bf16 path or Uni-Mol's fp16 one.  Rows 9-11 in bf16 also
    give their launches on Uni-Fold's recipe (evoformer_unifold).  Last,
    the EMA kernel, which no ``pallas_call`` stands behind (row null): the
    JAX trainer's EMA is XLA code in its jitted step.  Rows 3 and 8 have
    a second bf16 entry each for the LM's causal call (flash_causal's
    bf16 case with the rel-pos bias; its launches from lm_train, the
    rotary run's beside them, and every causal case's times).  The fp16
    rows 3 and 8 also give their causal launches inside the LM's --fp16
    step (lm_optim_fp16, run a).  The LM's causal rows also give
    lm_run_control's launches, its validation passes' apart (row 3's
    forward at the validation batch), and lm_checkpoint_activations'
    first run with the flag on; BERT's rows 3 and 8 the
    bert_checkpoint_activations run's with it.  Rows 3 and 8 have a third
    bf16 entry each for cross-attention's call at Tq != Tk (flash_cross at
    Tq 256, Tk 512; its launches from cross_decoder's cross-attention),
    the forward's entry carrying every flash_cross case and type (rows
    2 and 4-7 at Tq != Tk among them).  Rows 9 and 10 in bf16 give
    return_attn's launches beside the Evoformer's, and data_workers'
    beside train's (BERT, rows 3 and 8) and mol_train_fp16's (rows 9 and
    10 in fp16)."""
    decode = res["cases"]["decode"]
    rows = [{
        "row": 1, "name": "ragged_paged_attention", "route": "cuda",
        "source": "unicore_tpu_torch/csrc/paged_attention.cu",
        "replaces": PALLAS + "paged_attention.py:65",
        "launches": res["serve_launches"],
        "launches_by_phase": {"serve": res["serve_launches"],
                              "serve_sampling": res["sampling_launches"]},
        "max_abs_err": max(c["max_abs_err"] for c in res["cases"].values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        # this run's numbers only: the recorded times stay on the phase line
        "cases": {kind: {key: c[key] for key in (
            "ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err",
            "share_of_bound", "splits", "split_cols")}
            for kind, c in res["cases"].items()},
    }]
    # the training path runs bf16: its numbers lead, fp32 rides along
    multiblock = res["multiblock"]
    hb, joint, two_pass = (res["flash"]["bfloat16"],
                           multiblock["t1024_nobias"],
                           multiblock["t2048_bias"])
    table = (  # row, kernel, replaces (file:line of the body), case
        (2, "flash_fwd_bf16", "flash_attention.py:241", two_pass),
        (3, "flash_fwd_bf16", "flash_attention.py:121", hb),
        (4, "flash_bwd_dkdv", "flash_attention.py:406", joint),
        (4, "flash_bwd_dq", "flash_attention.py:406", joint),
        (5, "flash_bwd_dq", "flash_attention.py:362", two_pass),
        (6, "flash_bwd_dkdv", "flash_attention.py:298", two_pass),
        (7, "flash_bwd_dq", "flash_attention.py:488", two_pass),
        (8, "flash_bwd_dkdv", "flash_attention.py:164", hb),
        (8, "flash_bwd_dq", "flash_attention.py:164", hb))
    for row, name, replaces, case in table:
        entry = flash_row(row, name, replaces, case,
                          res["train_launches"][name])
        if case is hb:  # the fp32 kernels at the same shape
            fp32 = res["flash"]["float32"]["kernels"]
            keep = (("flash_fwd",) if name == "flash_fwd_bf16"
                    else BWD_KERNELS[torch.float32])
            entry["fp32"] = {n: {"ms": fp32[n]["ms"],
                                 "bound_ms": fp32[n]["bound_ms"]}
                             for n in keep}
            entry["launches_by_phase"] = {
                "train": res["train_launches"][name],
                "bert_checkpoint_activations (flag on, 4 updates)":
                    res["ca_launches"]["bert"][name],
                "data_workers (BERT: 5 modes x 8 updates, then 4)":
                    res["dw_launches"]["bert"][name],
                f"bert_large_train (H 16, {ARCH_UPDATES} updates)":
                    res["archs"]["bert_large"][name]}
        rows.append(entry)
    # the LM's causal call: causal at :142 (forward) and :199 (backward)
    lead = res["causal"]["bf16_bias"]
    for row, name, replaces in (
            (3, "flash_fwd_bf16", "flash_attention.py:142"),
            (8, "flash_bwd_dkdv", "flash_attention.py:199"),
            (8, "flash_bwd_dq", "flash_attention.py:199")):
        entry = flash_row(row, name, replaces, lead, res["lm_launches"][name])
        entry["causal"] = True
        entry["launches_by_phase"] = {
            "lm_train": res["lm_launches"][name],
            "lm_serve_checkpoint (rotary)": res["rotary_launches"][name],
            "lm_run_control": res["rc_launches"]["launches"][name],
            "lm_run_control (validation passes)":
                res["rc_launches"]["valid_launches"][name],
            "lm_checkpoint_activations (flag on, 8 updates)":
                res["ca_launches"]["lm"][name]}
        rows.append(entry)
    # every causal case's kernels, once, on the forward's row
    rows[-3]["causal_cases"] = {
        case: {"dtype": r["dtype"], "bias": r["shape"]["bias"],
               "kernels": r["kernels"], "plain_fwd_ms": r["plain_fwd_ms"],
               "plain_bwd_ms": r["plain_bwd_ms"],
               "bwd_kernels_ms": r["bwd_kernels_ms"],
               "bwd_bound_ms": r["bwd_bound_ms"],
               "sdpa_fwd_ms": r["sdpa_fwd_ms"],
               "sdpa_fwd_bwd_ms": r["sdpa_fwd_bwd_ms"],
               "max_abs_err": r["max_abs_err"]}
        for case, r in res["causal"].items()}
    # cross-attention's call at Tq != Tk: Tq 256 over Tk 512 keys (rows 3
    # and 8), launched by cross_decoder's cross-attention
    lead = res["cross"]["q256_k512"]["bfloat16"]
    for row, name, replaces in (
            (3, "flash_fwd_bf16", "flash_attention.py:121"),
            (8, "flash_bwd_dkdv", "flash_attention.py:164"),
            (8, "flash_bwd_dq", "flash_attention.py:164")):
        entry = flash_row(row, name, replaces, lead,
                          res["cross_launches"]["cross_attention"][name])
        entry["cross"] = True
        entry["launches_by_phase"] = {
            "cross_decoder (cross-attention)":
                res["cross_launches"]["cross_attention"][name],
            "cross_decoder (encoder, self and cross)":
                res["cross_launches"]["all"][name]}
        rows.append(entry)
    # every flash_cross case and type, once, on the forward's row
    rows[-3]["cross_cases"] = {
        f"{case}/{dt}": {
            "shape": r["shape"], "reference_blocks": r["reference_blocks"],
            "kernels": r["kernels"], "plain_fwd_ms": r["plain_fwd_ms"],
            "plain_bwd_ms": r["plain_bwd_ms"],
            "bwd_kernels_ms": r["bwd_kernels_ms"],
            "bwd_bound_ms": r["bwd_bound_ms"],
            "sdpa_fwd_ms": r["sdpa_fwd_ms"],
            "sdpa_fwd_bwd_ms": r["sdpa_fwd_bwd_ms"],
            "sdpa_other": r["sdpa_other"], "max_abs_err": r["max_abs_err"],
            "keep_bits": r["keep_bits"]}
        for case, by_type in res["cross"].items() for dt, r in by_type.items()}
    # xlm's call at head dim 80 (B 16, H 16, T 512), launched by xlm_train,
    # with the same B, H, T at D = 64 beside it
    xlm = res["archs"]["xlm_flash"]
    for row, name, replaces in (
            (3, "flash_fwd_bf16", "flash_attention.py:121"),
            (8, "flash_bwd_dkdv", "flash_attention.py:164"),
            (8, "flash_bwd_dq", "flash_attention.py:164")):
        entry = flash_row(row, name, replaces, xlm["d80"],
                          res["archs"]["xlm"][name])
        entry["head_dim"] = 80
        entry["launches_by_phase"] = {
            f"xlm_train ({ARCH_UPDATES} updates)": res["archs"]["xlm"][name]}
        entry["d64_same_bht"] = {
            "ms": xlm["d64"]["kernels"][name]["ms"],
            "bound_ms": xlm["d64"]["kernels"][name]["bound_ms"],
            "plain_ms": xlm["d64"]["plain_fwd_ms" if row == 3
                                  else "plain_bwd_ms"]}
        rows.append(entry)
    rows[-3]["keep_bits"] = xlm["d80"]["keep_bits"]
    # the fp16 kernels at the same shapes, on the --fp16 path
    fp16 = {id(hb): res["flash"]["float16"],
            id(joint): multiblock["t1024_nobias_fp16"],
            id(two_pass): multiblock["t2048_bias_fp16"]}
    for row, name, replaces, case in table:
        name16 = name.replace("_bf16", "") + "_fp16"
        entry = flash_row(row, name16, replaces, fp16[id(case)],
                          res["fp16_launches"][name16])
        if case is hb:  # the LM's causal call runs them in its fp16 step
            entry["launches_by_phase"] = {
                "train_fp16": res["fp16_launches"][name16],
                "lm_optim_fp16 (run a, causal)":
                    res["lm_fp16_launches"][name16]}
        rows.append(entry)
    # softmax_dropout: bf16 on the Evoformer's path, led by its triangle
    # attention (the largest); fp16 on Uni-Mol's, at its scores' shape
    by_type = {dt: r for dt, r in res["sd"].items() if dt != "turns"}
    for dt, lead, path_launches in (
            ("bfloat16", "triangle", res["evo_launches"]),
            ("float16", "unimol", res["mol_launches"])):
        main = by_type[dt][lead]
        for row, kind, body, errs in ((9, "fwd", ":64", ("out", "softmax")),
                                      (10, "bwd", ":87", ("dx", "dbias"))):
            name = f"softmax_dropout_{kind}"
            callers = ({"evoformer_train": res["evo_launches"][name],
                        "evoformer_unifold": res["unifold_launches"][name],
                        "return_attn": res["ra_launches"][name]}
                       if dt == "bfloat16"
                       else {"mol_train_fp16": res["mol_launches"][name],
                             "data_workers (Uni-Mol: 4 modes x 8 updates)":
                                 res["dw_launches"]["mol"][name]})
            rows.append({"launches_by_phase": callers,
                "row": row, "name": name, "dtype": dt, "route": "cuda",
                "source": "unicore_tpu_torch/csrc/softmax_dropout.cu",
                "replaces": PALLAS + "softmax_dropout.py" + body,
                "launches": path_launches[name],
                "max_abs_err": max(c["max_abs_err"].get(e, 0.0)
                                   for c in by_type[dt].values()
                                   for e in errs),
                "ms": main[f"{kind}_ms"],
                "plain_ms": main[f"plain_{kind}_ms"],
                "bound_ms": main[f"bound_{kind}_ms"], "bound_by": "bytes",
                # torch's softmax (backward) of pre-added scores: no dropout
                "library_ms": main[f"library_{kind}_ms"],
                "shape": main["shape"],
                "turns_ms": [[t["dtype"], t[name]]
                             for t in res["sd"]["turns"][lead]],
                "cases": {f"{t}/{case}": {
                    "ms": r[f"{kind}_ms"], "bound_ms": r[f"bound_{kind}_ms"],
                    "plain_ms": r[f"plain_{kind}_ms"],
                    "library_ms": r[f"library_{kind}_ms"]}
                    for t, by_case in by_type.items()
                    for case, r in by_case.items()},
            })
    # the SR sync of every evoformer_base leaf in one table launch
    table = res["sr"]["table"]
    rows.append({
        "row": 11, "name": "fp32_to_bf16_sr", "route": "cuda",
        "source": "unicore_tpu_torch/csrc/rounding.cu",
        "replaces": PALLAS + "rounding.py:34",
        "launches": res["evo_launches"]["fp32_to_bf16_sr"],
        "max_abs_err": 0.0,  # bit for bit (the phase raises otherwise)
        "ms": table["ms"], "plain_ms": table["plain_ms"],
        "bound_ms": table["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_phase": {
            "evoformer_train": res["evo_launches"]["fp32_to_bf16_sr"],
            "evoformer_unifold": res["unifold_launches"]["fp32_to_bf16_sr"]},
        "per_leaf_launches_ms": table["per_leaf_launches_ms"],
        "cases": res["sr"],
    })
    ema = res["ema_report"]
    rows.append({
        "row": None, "name": "ema_update", "dtype": "float32",
        "route": "cuda", "source": "unicore_tpu_torch/csrc/ema.cu",
        # no pallas_call: the EMA update of the JAX trainer's jitted step
        "replaces": "unicore_tpu/trainer.py:1136",
        "launches": res["unifold_launches"]["ema_update"],
        "launches_by_phase": {
            "evoformer_unifold": res["unifold_launches"]["ema_update"]},
        "max_abs_err": 0.0,  # bit for bit (the phase raises otherwise)
        "ms": ema["ms"], "plain_ms": ema["plain_ms"],
        "bound_ms": ema["bound_ms"], "bound_by": "bytes",
        # torch._foreach_lerp_: the same EMA in one call, rounded otherwise
        "library_ms": ema["library_ms"], "case": ema,
    })
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from unicore_tpu_torch.ops import build
    from unicore_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = build.build(["paged_attention", "flash_attention",
                          "flash_attention_fwd", "flash_attention_bwd",
                          "softmax_dropout", "rounding", "ema",
                          "record_reader"])
    emit("build", kernels={
        name: {"seconds": r["seconds"],
               "ptxas": [ln.strip() for ln in r["log"].splitlines()
                         if "registers" in ln or "smem" in ln]}
        for name, r in report.items()})
    res = {}  # the phases' results that the kernels line reads
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res["cases"] = kernel_phase(pa, flush)
    model, first, second, results, res["serve_launches"] = serve_phase(pa)
    solo_phase(model, first, second, results)
    profile_phase(model)
    sampling = serve_sampling_phase(model, pa, first, second, results)
    emit("serve_sampling", **sampling)
    res["sampling_launches"] = sampling["paged_launches"]
    del model
    torch.cuda.empty_cache()
    res["flash"] = flash_phase(flush)
    res["causal"] = flash_causal_phase(flush)
    res["cross"] = flash_cross_phase(flush)
    res["multiblock"] = flash_multiblock_phase(flush)
    emit("head", **head_phase(flush))
    res["sd"] = softmax_dropout_phase(flush)
    emit("softmax_dropout_route", **softmax_dropout_route_case(flush))
    res["sr"] = rounding_phase(flush)
    res["ema_report"] = ema_case(flush)
    emit("ema", card=card(), **res["ema_report"])
    del flush
    torch.cuda.empty_cache()
    train = train_phase()
    res["train_launches"] = train["launches"]
    torch.cuda.empty_cache()
    res["fp16_launches"] = train_fp16_phase(train)
    torch.cuda.empty_cache()
    emit("checkpoint", **checkpoint_phase())
    torch.cuda.empty_cache()
    res["archs"] = bert_archs_phase()
    torch.cuda.empty_cache()
    res["evo_launches"] = evoformer_train_phase()
    torch.cuda.empty_cache()
    res["unifold_launches"] = evoformer_unifold_phase()
    torch.cuda.empty_cache()
    res["mol_launches"] = mol_train_fp16_phase()
    torch.cuda.empty_cache()
    res["dw_launches"] = data_workers_phase()
    torch.cuda.empty_cache()
    res["lm_launches"] = lm_train_phase()["launches"]
    torch.cuda.empty_cache()
    lm_serve = lm_serve_checkpoint_phase()
    emit("lm_serve_checkpoint", **lm_serve)
    res["rotary_launches"] = lm_serve["flash_launches"]
    torch.cuda.empty_cache()
    res["lm_fp16_launches"] = lm_optim_fp16_phase()
    torch.cuda.empty_cache()
    res["rc_launches"] = lm_run_control_phase()
    torch.cuda.empty_cache()
    res["cross_launches"] = cross_decoder_phase()
    res["ra_launches"] = return_attn_phase()
    res["ca_launches"] = lm_checkpoint_activations_phase()
    print(json.dumps({"kernels": kernels_line(res)}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
