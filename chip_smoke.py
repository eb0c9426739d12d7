#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepsc_gan_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 2] [--epochs 3]
                          [--star-epochs 2]

Phases, each printing its lines; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the serving and training paths (K1-K6),
   compiled by nvcc from the sources in this checkout (all nvcc processes
   started together); ptxas's registers, spills and performance warnings
   for each;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the paths give it, in f32 and bf16, with the tolerance
   stated (every f32 K1 and K2 at the main model's heads on the narrow
   kernels, csrc/attention_narrow.cu, `design` narrow cuda-core f32); the
   kernel's time, its host enqueue time, the plain version's
   time, one PyTorch library call's (a yardstick the port never calls), and
   the least time the card could take; beside each time, its device time
   (`device_ms` ...: the calls queued behind a spin of the device, so the
   host's pace does not enter); for K1-K4 and K6, which units multiply
   (`design`: mma or wgmma bf16, or cuda-core f32); K6 also with ties
   (both dtypes), k = 1 and 8, and every logit below 0 over a vocab that is
   not a multiple of its 128-row tiles, its indices equal to the plain
   version's in every case; K5 on the unstacked ring, also at L = 1 and 2
   and at an odd number of sequences; K2 bitwise equal over two calls and
   with and without dbias; K4 in its dh-only mode (no dW/db) at the
   training shape, its dh bitwise equal to the full mode's; K1 and K2
   also past 32 queries and keys (N = 64, Lq = Lk = 128: the long-length
   kernels; the bf16 K2 there, and at 63 x 64, the resident kernel), K2
   there bitwise equal over calls too; K6's and K2's `design` read from
   the names of the device kernels one call ran (torch.profiler) and held
   to the wrappers' route (a mismatch fails); the widened
   shapes: the f32 K2 at 16 heads of 16 (the narrow kernel, a block a
   row and head), K1/K2 at 8 heads of 24, 64 and
   128 and at 32 heads of 16, K3/K4 and K6 at D = 200 and 512, K6 at k =
   9, 16 (with ties) and 64, K5 at D = 96 and 512 (the wide kernels where
   the tuned ones do not take the shape); and at the shapes of the
   widened train paths of phase 15: K1/K2 at 8 heads of 64 and of 25,
   the chunked K1/K2 at one head of 512 (Lq = Lk = 32) and 2 heads of 320
   (31 x 31 and 31 x 32), K3/K4 at D = 640 and K4's dh-only mode there
   (in bf16 K4 off the tuned widths, K1 past 256-wide heads and K1/K2 at
   every other wide shape run their tensor-core kernels: `design` wgmma,
   mma or wide mma bf16); the bf16 K6 on its tensor-core wide kernel at
   every k of 9, 16, 64 and D of 200, 512, and at the wide beam, each in
   the dyadic, tie and negative modes (`design` wide wgmma bf16); past
   k = 64 the bf16 K6 on that kernel's long path (k = 100 at
   D = 200 and at the beam-100 path's N = 64 x 100, D = 128; k = 256 at
   D = 200 and 512; `design` long-path wgmma bf16); K6 on the select
   kernels (csrc/topk_select.cu): in bf16 at k = 1,000 (D = 200) and at
   V = 32,000 (k = 100), in f32 at every k of 9, 16, 64, 1,000 and D of
   200, 512 and at the wide beam, each in the three modes, and at k = V
   (a full sort of each row, N = 64) in both dtypes and the three modes
   (`design` select wgmma bf16 or select cuda-core f32); the f32 K1 at
   every wide shape above on the tiled kernel (csrc/attention_tiled.cu,
   `design` tiled cuda-core f32); the bf16 K2 past 128 queries or keys on
   the cluster kernel (256 x 256 with and without dbias, 255 x 256,
   31 x 256 and 512 x 512, bitwise over calls; `design` cluster mma bf16)
   and at 1,024 x 1,024 on the long-length kernels; each row prints its
   seconds;
4. serving paths, each through the port's CLI on the trained transceiver
   (results/plain_best_params.pkl) in bf16, SNR 0..18 dB, synthetic
   batches of 64; every launch count is set to 0 just before a path and
   read just after, and must equal what the path makes; the BLEU table
   must be 19 finite values in [0, 1]:
   a. the full-prefix greedy sweep (--batches batches; 244 K1 per batch);
   b. the KV-cached greedy sweep, --kv-cache (--batches batches; 4 K1 per
      batch, the encoder);
   c. beam search, --eval-mode beam --beam-size 4 (KV-cached), one batch,
      one decode call per SNR (4 K1 and 30 K6 per call);
   then at f32 on one batch: the full-prefix greedy ids through the kernels
   equal the plain versions'; the KV greedy ids equal the full-prefix ids;
   the beam sweep's ids with K6 scoring equal those with its plain version;
   the KV beam's ids equal the full-prefix beam's at three SNRs;
5. training path: the port's CLI trains the full-width transceiver in bf16
   from a random init (--seed) on the synthetic set for --epochs epochs,
   through its default path (every training phase here: path scan32, 32
   steps a call as replays of one captured CUDA graph of the step);
   launch counts as above (per step: 12 K1, 12 K2, 1 K3, 1 K4); every loss
   finite and the last 20 below the first 20 on average; then one f32 step
   through the kernels and one through the plain versions from the same
   weights, noise and dropout masks: the same loss and gradients;
6. star training: the CLI trains the full-width single-block star
   transceiver (--variant star) in bf16 from a random init on the
   synthetic set at seq_len 31 for --star-epochs epochs, scoring the
   un-shifted target (per step: 16 K5, 1 K3, 1 K4, no K1 or K2); losses as
   in 5; then an f32 star step through K5 and the CE kernels against one
   through the plain versions;
7. star serving: the CLI's one-shot sweep (--variant star, no
   --params-pkl: it loads what phase 6 saved and says so) over --batches
   batches in bf16, 16 K5 per call and nothing else; then at f32 on one
   batch the one-shot ids through K5 equal the plain version's, for the
   trained star weights and for a random multi-layer star (star_multi, 64
   K5 per call);
8. fading: the CLI's full-prefix greedy sweep through Rayleigh, the KV
   sweep through Rician with the MMSE equalizer and the beam through
   Rician (one batch) on the trained weights, each call launching what its
   AWGN path's launches; then at f32 on one batch the Rayleigh greedy ids
   through K1 equal the plain version's on the same draws;
9. attack training: `cli train --train-mode attack --adv-weight 0.5
   --pnr-db 0` at full width in bf16 from a random init for
   ATTACK_EPOCHS epochs (per step: 36 K1, 31 K2, 3 K3, 3 K4 of which 1
   in the dh-only mode); every loss finite and the mean of the last 16
   adversarial losses below that of the first 16; then an f32 attack step
   through the kernels against one through the plain versions: the
   perturbation and the losses; the gradients within 1e-4 of the plain
   step given the kernels' perturbation and ReLU decisions (they are not
   continuous in them: a ReLU flips), and within 3 times the plain step's
   own gap under a 1e-5 jitter of its perturbation on each path's own;
10. attack evaluation in bf16 at PNR 0 dB on the trained weights:
   `--eval-mode teacher_forced` (28 K1, 7 K2 per call), `pgd` (116 K1,
   7 K2; every eps* in [0, 1]) and `greedy_attack` (252 K1, 7 K2) through
   AWGN, `teacher_forced` through Rayleigh, and the star `teacher_forced`
   on the star weights phase 6 saved (32 K5 per call); 19 rows of finite
   values each; then an f32 teacher-forced call through K1/K2 against one
   through the plain versions (losses, ids but for near-ties, and the
   attacked logits within 3 times the plain call's own gap under a 1e-5
   jitter of its perturbation);
11. long lengths: `cli train --seq-len 64` for one epoch in bf16 from a
   random init (K1's long-length kernel, the resident K2; per step as
   in 5); every loss finite and the last 20 below the first 20 on average;
   the same at `--seq-len 256` (12 K2 a step, every one on the cluster
   kernel); then the beam-100 path: `cli evaluate --eval-mode beam
   --beam-size 100` on the trained weights, one batch of 64 at 9 dB (one
   decode call: 30 K6 at N = 64 x 100, every one on the tensor-core wide
   kernel's long path, and the encoder's 4 K1), one finite row;
12. GAN training: `cli train --variant gan --train-mode gan` at full width
   in bf16 from a random init, AWGN, GAN_EPOCHS epochs (per step: 20 K1,
   20 K2, 2 K3, 2 K4); the losses, g_losses and d_losses finite, the mean
   of the last 16 receiver losses below that of the first 16; then an f32
   GAN step through the kernels against one through the plain versions on
   the kernel run's ReLU decisions: the three losses and the gradients of
   the three phases;
13. GAN evaluation on what phase 12 saved, bf16, PNR 0 dB: the
   teacher-forced table (20 K1, 7 K2 per call), `pgd` (the same step for a
   GAN model; one batch) and the `greedy_gan` sweep (252 K1, 7 K2); 19
   rows of finite values each; then at f32 the greedy_gan ids and noa
   through K1/K2 equal the plain versions' on the same ReLU decisions and
   perturbation, at three SNRs;
14. gan_star: `cli train --variant gan_star --train-mode gan` (24 K5, 2
   K3, 2 K4 per step), then its greedy_gan sweep (24 K5 per call);
15. widened paths: `cli train` with an encoder of 8 heads of 64
   and a decoder of 8 heads of 25 (every K1-K4 launch on the wide
   kernels: K1/K2 on the tensor-core wide kernels,
   csrc/attention_wide_mma.cu), and its ms a step, `cli evaluate
   --eval-mode beam --beam-size 9` on what it
   saved (K6's wide kernels), `cli train --variant star` at d_model 96
   (K5's wide kernel), exact launch counts; then heads wider than 256:
   `cli train` with an encoder of one head of 512 and a decoder of 2 heads
   of 320 (K1 and K2 on their tensor-core chunked kernels,
   csrc/attention_chunked.cu; K3 and K4 on their tensor-core wide kernels,
   csrc/ce_wide_fwd.cu and csrc/ce_wide_bwd.cu, at D = 640), exact launch
   counts, and its ms a step; then at f32 on what both saved: `cli
   evaluate --dtype float32 --eval-mode beam --beam-size 9` on the widened
   model (f32_wide_beam: the encoder's 4 K1 a call on the tiled kernel, 30
   K6 a call on the select kernels at N = 64 x 9, D = 200, k = 9) and the
   full-prefix greedy sweep on the wide-heads model (f32_wide_heads_greedy:
   244 K1 a call on the tiled kernel past 256-wide heads), exact launch
   counts, and each decode's ids through the kernels against the plain
   versions' at 0, 9 and 18 dB (near-ties aside: the beam's at its first
   differing choice, `same_beam_ids_but_near_ties`); then `cli train
   --dtype float32` of the wide-heads and the widened models (one epoch
   each) and of the main model (F32_MAIN_EPOCHS epochs: d_model 128, its
   K3 and K4 at D = 128), every K3 and K4 on the tiled kernels
   (csrc/ce_fwd_tiled.cu, csrc/ce_bwd_tiled.cu), exact launch counts,
   losses finite and falling, each path's ms a step; and an f32
   wide-heads step against the plain one;
16. MINE: `cli train --train-mode mine` at full width in bf16 from a
   random init, MINE_EPOCHS epochs (per step: 16 K1, 12 K2, no K3/K4);
   every ce and mi finite, the mean of the last 16 ce below that of the
   first 16; then an f32 MINE step through the kernels against one through
   the plain versions on the same draws, permutation and ReLU decisions:
   ce and mi within rtol 1e-5, both networks' gradients within 1e-4 of
   their largest;
17. resume: `cli train` at f32 with --ema-decay through the graphed
   scan32 path: 2 epochs, then `--resume` to RESUME_EPOCHS, bitwise equal
   to RESUME_EPOCHS straight epochs (every tensor of the last checkpoint:
   params, Adam moments and counts, the update count, the EMA shadow, the
   generator's state);
18. the levers: one bf16 epoch of `cli train --remat --fuse-qkv
   --aug-crop 0.3 --aug-synth 0.3` on a corpus the script writes from
   --seed, through the graphed path (per step: 24 K1, each recomputed
   layer's K1 twice, 12 K2, 1 K3, 1 K4); GRAPH_K f32 graphed remat steps
   against GRAPH_K graphed steps without (losses rtol 1e-6, gradients
   within 1e-6 of their largest, the generator's state equal; whether
   bitwise printed); what --remat and --fuse-qkv each cost alone on the
   graphed bf16 path at batch 64 and 1,024 (peak memory of an eager step
   and of a graphed call, ms a step); and `cli train --profile` of one
   graphed epoch of PROFILE_STEPS steps, whose trace must hold 12 K1 a
   step;
19. the captured graph of the train step, vanilla and star at full width:
   the card's optimizer update (GRAPH_K graphed f32 steps under noam with
   the EMA, and two GAN steps' selective updates) against the CPU's Adam
   on the same gradients (params, moments, EMA within 1e-5 of their
   largest, counts equal); GRAPH_K f32 steps in one graphed call equal
   GRAPH_K eager steps (losses rtol 1e-5, params and Adam moments within
   1e-5 of their largest; whether bitwise equal printed), two replays'
   draws differ and each equals the eager step's; bf16 wall ms a step
   eager against graphed over GRAPH_RUNS runs each, and a profiled graphed
   call whose trace holds GRAPH_K times a step's launches of every kernel
   the eager step launched;
20. profile: device time by kernel over one bf16 call of the full-prefix
   sweep, of the KV sweep, of the beam and of the star sweep, over one
   bf16 train step of each codec (with K3's and K4's share of it), over
   one bf16 attack train step and one teacher-forced FGM call, over one
   GAN train step, one GAN teacher-forced call and one greedy_gan call,
   over one MINE step, and the device's idle share in each
   (torch.profiler); the star sweep call must run no roll kernel (K5
   reads the ring unstacked);
21. similarity: `cli evaluate --metric both` (the KV greedy sweep on the
   trained weights, bf16) with DEEPSC_BERT_PATH at a BERT-base-shaped
   random checkpoint the phase writes from --seed (12 layers of 768, 12
   heads, ff 3072, safetensors written by hand): 4 K1 per call, the BLEU
   column equal to the BLEU-only run's, the similarity column the mean of
   its calls; two calls' scores within 1e-4 of the CPU Similarity's on the
   same sentences; a BERT-base forward's device and wall time;
22. transmit: `cli transmit` at f32 on the trained weights, 6 dB, four
   sentences: exactly 244 K1 (the full-prefix greedy decode at one noise
   level); the ids equal the plain versions' on the same draws but for
   near-ties (`same_ids_but_near_ties`, each row up to its first
   difference);
23. export: `cli export` of the KV greedy sweep at full width, f32 and
   bf16, symbolic b and s, each in a background job started after the
   build (tracing takes minutes; it runs beside phases 3-22); each
   artifact loaded by a fresh python3 that imports only torch and called
   at (B, S) = (4, 2) and (3, 5); its ids equal the eager plain-version KV
   sweep's on the same draws (f32 exactly, bf16 but for near-ties); export
   seconds, MB, load and call seconds;
24. baseline: `cli baseline` (64-QAM, block_k 512, 6 turbo iterations) on
   256 Zipf sentences the phase writes, at 0, 6, 12 and 18 dB, the BCJR on
   the card: rows equal to the CPU run's, clean BLEU 1.0 at 18 dB and the
   attacked column below it; seconds per SNR point; a profiled BCJR call
   (its kernels and the device's idle share);
25. preprocess: `cli preprocess` on a corpus the phase writes; the outputs
   read back and decoded equal the tokenized sentences, split 90/10;
26. routes, run right after phase 2, before the export jobs start (no
   other process on the card, no earlier profile in this process: later,
   the card's profiler has recorded no kernel at all of such calls): one
   bf16 call of K6 at every k of 9, 16, 64 and D of 200, 512 and at the
   wide beam, in each input mode, at k = 100 and 256 and D of 128, 200,
   and at k = 1,000, V = 32,000 and k = V in each mode; one f32 call of K6
   at every k of 9, 16, 64, 1,000 and D of 200, 512, at the wide beam and
   at k = V in each mode; one bf16 call of K2 at 128 x 128 and 63 x 64,
   256 x 256, 255 x 256 and 31 x 256, with and without dbias; one f32
   call of K1 at every wide shape of the kernel rows; profiled: each must
   run its route's kernel (the tensor-core wide K6, its long path past
   k = 64, the select K6, the resident K2, the cluster K2, the tiled K1;
   torch.profiler's names printed), and the kernel rows of those cases
   take the design so read; so does one f32 call of K3 and K4 at D = 128,
   200, 512, 640, 264 and 136 (the tiled kernels) and of K4's dh-only mode
   at 128 and 640;
27. native: the port's native library (`native/`, g++) built, a failed
   build failing the run; one bf16 greedy sweep call's sentences (19 x 64
   pairs, the trained weights) scored by BleuScore natively and in
   Python: the scores equal (1e-12), the host ms of each way;
28. dp: two ranks on the one card (`parallel/launch.py:run_ranks`; the
   backend `parallel/mesh.py` picks, gloo for ranks that share a card) at
   the main model's full width, global batch 64: two f32 plain steps, one
   f32 FGM (adv weight 0.5), GAN, MINE and star step, each against the
   single-process step on the card (losses within 1e-4 relative, the
   averaged gradients and the params within 1e-4 of their norms; MINE's
   T by its gradients), two bf16 plain steps (losses within
   DP_BF16_LOSS_TOL); each rank's launches equal to the single step's
   (K1-K4, K5 for star) and every rank ending with rank 0's parameters;
   one f32 plain step in a one-rank group (NCCL, a card of its own)
   against the single step; the dp step's ms a step beside the single
   step's (on one card: the collectives' cost, not scaling);
29. snr_parallel: two ranks, the f32 greedy, KV and beam sweeps at 0, 6,
   12 and 18 dB on the trained weights split over them: the gathered ids
   equal the single-process sweeps'; each rank launched K1 (and K6);
30. the seconds of each phase as one line, the kernels as one JSON line
   (the wide kernels as entries of their own, launches from phase 15; the
   chunked wide K1/K2 too, launches and rows from its heads-wider-than-256
   path; the long-path K6 and the cluster K2, launches from the beam-100
   path and the seq-len-256 epoch; the select K6 and the tiled K1,
   launches from phase 15's f32 paths; the tiled K3 and K4, launches from
   every f32 path; the six kernels' launches include every rank's of
   phases 28 and 29), then `{"ok": true, "device":
   {...}}` as the last line.

Needs CUDA: without it the script exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import random
import re
import shlex
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist

from deepsc_gan_tpu_torch import cli, native
from deepsc_gan_tpu_torch.baselines import turbo
from deepsc_gan_tpu_torch.baselines.pipeline import classical_sweep
from deepsc_gan_tpu_torch.data import preprocess
from deepsc_gan_tpu_torch.data.augment import load_train_dataset
from deepsc_gan_tpu_torch.data.loader import eval_batches, synthetic_sentences
from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate import beam as beam_module
from deepsc_gan_tpu_torch.evaluate.beam import (
    _vocab_table,
    make_beam_decode,
    make_beam_decode_kv,
    make_beam_decode_sweep,
)
from deepsc_gan_tpu_torch.evaluate import greedy, metrics
from deepsc_gan_tpu_torch.evaluate.greedy import (
    make_greedy_decode_gan,
    make_greedy_decode_sweep,
)
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.evaluate.metrics import SNR_to_noise
from deepsc_gan_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    exact_f32_matmuls,
    write_safetensors,
)
from deepsc_gan_tpu_torch.models.channel import draw_channel, snr_to_noise
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from deepsc_gan_tpu_torch.parallel import mesh as pmesh
from deepsc_gan_tpu_torch.parallel import sharding
from deepsc_gan_tpu_torch.parallel.launch import run_ranks
from deepsc_gan_tpu_torch.train import gan_steps, mine_steps, steps
from deepsc_gan_tpu_torch.utils.config import (
    Config,
    default_seq_len,
    is_star,
)
from deepsc_gan_tpu_torch.utils.convert import (
    is_tied,
    load_into,
    load_params_pickle,
)

PARAMS = "results/plain_best_params.pkl"
STAR_CKPT = "log/chip_smoke/star_ckpt"
SNRS = list(range(0, 19))
HEADS, DH = 8, 16
# H100 SXM data sheet: HBM rate, dense bf16 tensor-core rate, f32 rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: f32 differs only in summation order and expf
# (a few ulps of O(1) values); bf16 may also round a probability or the
# output one bf16 step (2^-8 relative) the other way, on outputs of
# magnitude up to ~4 -> 2^-8 * 4 * 2 steps. The CE gradients (dh, dW, db)
# are held relative to their largest reference value.
TOL = {torch.float32: 1e-5, torch.bfloat16: 3.2e-2}
# K4 also against the softmax part of its plain version (the gradients
# without the label term), relative to that part's largest value: beside
# the label term it is ~1e-4 of the largest dW at the training shape, so
# TOL above would not see it. Sound kernels read 1.1e-4 to 1.7e-4 (f32,
# the CUDA-core K4 before the tiled one; the tiled K4's rows read 8.9e-6 to
# 9.5e-5) and 2.5e-4 to 4.0e-4 (bf16) on these inputs; K4 with its softmax
# term scaled by 1.01 reads 1.0e-2 or more, without it 1.0
# (scripts/ce_bwd_planted_faults.py, PERF.md).
SOFTMAX_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-3}
TRAIN_SHAPES = (("encoder", 32, 32), ("decoder_self", 31, 31),
                ("decoder_cross", 31, 32))
# K1/K2 past 32 queries and keys (in bf16 K1's long-length kernel and the
# resident K2; in f32 the narrow kernels' key tiles), at N = bs; the K2
# also at the seq-len-64 epoch's decoder cross-attention (LONG_CROSS)
LONG_LEN = 128
LONG_CASE = f"long_{LONG_LEN}"
LONG_CROSS = ("long_63x64", 63, 64)
# the vanilla train epoch that runs them end to end
LONG_SEQ = 64
KERNELS = (attn.KERNEL, attn.KERNEL_BWD, ce.KERNEL_FWD, ce.KERNEL_BWD,
           star.KERNEL, topk.KERNEL)
# the libraries of the wide kernels: the shapes the tuned kernels
# above do not take (the bf16 wide K1/K2 up to 256-wide heads, the bf16 K1
# past them, the bf16 wide K3, K4 and K6 on the tensor cores in libraries
# of their own), and the bf16 K2 past 32 queries or keys up to 128
# (csrc/attention_bwd_resident.cu), and the f32 K1/K2 at the tuned heads
# (csrc/attention_narrow.cu)
WIDE_LIBRARIES = (attn.KERNEL_BWD_TILED, ce.KERNEL_FWD_TILED,
                  attn.KERNEL_NARROW, star.KERNEL_WIDE,
                  topk.KERNEL_SELECT, attn.KERNEL_CHUNKED, ce.KERNEL_WIDE_BWD,
                  attn.KERNEL_WIDE_MMA, ce.KERNEL_WIDE_FWD,
                  topk.KERNEL_WIDE_MMA, attn.KERNEL_RESIDENT,
                  attn.KERNEL_CLUSTER, attn.KERNEL_TILED,
                  ce.KERNEL_BWD_TILED)
# the K4 launches among ce_bwd's that ran in the dh-only mode
DH_ONLY = "ce_bwd_dh_only"
# the K6 launches on the tensor-core wide kernel's long path (k past 64),
# and the K2 launches on the cluster kernel
LONG_LIST = "topk_long_list"
CLUSTER = "attention_bwd_cluster"
# the K6 launches on the select kernels (csrc/topk_select.cu), and the K1
# launches on the tiled f32 kernel (csrc/attention_tiled.cu)
SELECT = "topk_select"
TILED = "attention_tiled"
# the K2 launches on the tiled f32 kernels (csrc/attention_bwd_tiled.cu),
# and the K4 and K3 launches on the tiled kernels (csrc/ce_bwd_tiled.cu,
# csrc/ce_fwd_tiled.cu: every f32 one)
TILED_BWD = "attention_bwd_tiled"
CE_TILED = "ce_bwd_tiled"
CE_TILED_FWD = "ce_fwd_tiled"
# the K1 and K2 launches on the narrow f32 kernels (csrc/attention_narrow.cu:
# every f32 one at the tuned heads)
NARROW = "attention_narrow"
NARROW_BWD = "attention_narrow_bwd"
# the f32 K6 launches of the tuned kernel, on the 128 x 128 tile
# (csrc/topk.cu `topk_tiled_kernel`)
TOPK_TILED = "topk_tiled"
# the launches among each kernel's that went to its wide kernels
WIDE = {attn.KERNEL: "attention_fwd_wide", attn.KERNEL_BWD:
        "attention_bwd_wide", ce.KERNEL_FWD: "ce_fwd_wide",
        ce.KERNEL_BWD: "ce_bwd_wide", star.KERNEL: "star_wide",
        topk.KERNEL: "topk_wide"}
COUNTERS = KERNELS + (DH_ONLY,) + tuple(WIDE.values()) + (
    LONG_LIST, CLUSTER, SELECT, TILED, TILED_BWD, CE_TILED, CE_TILED_FWD,
    NARROW, NARROW_BWD, TOPK_TILED)
BEAM = 4
# `cli train`'s default steps a call (one captured CUDA graph of the step,
# replayed): what the train phases run
SCAN_STEPS = 32
# the graph phase: K steps a call, and runs of each side timed
GRAPH_K = 4
GRAPH_TIMED_K = 32
GRAPH_RUNS = 3
# the widened shapes: K1/K2 heads x head width, K3/K4/K6 widths,
# K6 list lengths, K5 widths
WIDE_HEADS = ((8, 24), (8, 64), (8, 128), (32, 16))
WIDE_D = (200, 512)
WIDE_K = (9, 16, 64)
# past the tensor-core wide K6's lists of 64 and the resident K2's lengths
# (attn.L_RES): the bf16 shapes its long path and the cluster K2
# take (the route phase's K6 at every k of PAST_LIST_KS and D of
# PAST_LIST_D; K2 at PAST_RESIDENT and the cross shapes of the seq-len-256
# epoch, and at CLUSTER_LEN), and past them the shapes other kernels take
# (K6 at k = PAST_K6 and past V = 25,000 at PAST_V: the select kernels,
# csrc/topk_select.cu, as every f32 K6 past k = 8 at SELECT_KS; K2 at
# PAST_CLUSTER: the long-length kernels)
PAST_LIST_K = 100
PAST_LIST_KS = (100, 256)
PAST_LIST_D = (128, 200)
PAST_RESIDENT = 256
PAST_RESIDENT_CROSS = (("long_255x256", 255, 256), ("long_31x256", 31, 256))
CLUSTER_LEN = 512
PAST_K6 = 1000
PAST_V = 32000
SELECT_KS = WIDE_K + (PAST_K6,)
PAST_CLUSTER = 1024
# the beam-100 path: `cli evaluate --eval-mode beam --beam-size BEAM100` at
# one SNR (its K6 at N = bs x BEAM100, D = 128, k = BEAM100), and the
# seq-len-256 train epoch
BEAM100 = 100
BEAM100_SNR = 9
SEQ256 = 256
# timed calls of the K6 rows in the tie and negative modes (their routes
# and indices are held in full, their plain versions called once for
# that and not timed; their times are not in the kernels line)
MODE_ITERS = 10
# timed calls of the f32 K3/K4 rows off the tuned widths (K4 takes 2.4 to
# 4.3 ms a call at D = 264 to 640 on an H100 80GB HBM3 at 700 W), and of
# the K6 rows at k = PAST_K6 and k = V
WIDE_F32_CE_ITERS = 10
LONG_K_ITERS = 5
WIDE_STAR_D = (96, 512)
# the widened CLI paths' own shapes (phase_wide): the encoder at 8 heads of
# 64 (d_model 512) and the decoder at 8 heads of 25 (d_model 200), N = bs;
# the beam's K6 at N = bs x WIDE_BEAM, D = WIDE_PATH_D, k = WIDE_BEAM
WIDE_PATH = (("wide_enc_8x64", 8, 64, 32, 32),
             ("wide_dec_self_8x25", 8, 25, 31, 31),
             ("wide_dec_cross_8x25", 8, 25, 31, 32))
WIDE_PATH_D = 200
WIDE_BEAM = 9
# heads wider than 256 (the chunked wide K1/K2 kernels) at the shapes the
# wide-heads train path (phase_wide_heads) gives them: its encoder at one
# head of 512, its decoder at 2 heads of 320, N = bs; its CE (the wide
# K3/K4) at D = WIDE_HEADS_D, N = bs x 31
WIDE_HEADS_PATH = (("wh_enc_1x512", 1, 512, 32, 32),
                   ("wh_dec_self_2x320", 2, 320, 31, 31),
                   ("wh_dec_cross_2x320", 2, 320, 31, 32))
WIDE_HEADS_D = 640
# widths off the tensor-core kernels' steps past 256 (the chunked K1/K2 at
# one head of 300: 16-byte staging does not apply; the wide K3/K4 at D =
# 264, off the 16-column k-step), N = bs and bs x 31
OFF_STEP_HEADS = ("wh_off_1x300", 1, 300, 31, 31)
OFF_STEP_D = 264
# an f32 CE width off the tiled kernels' 128-column tiles and 16-column
# chunks, a tuned width before them (the f32 K3/K4 rows), and every row of
# the f32 CE rows' inputs whose cotangent is zero (ce_inputs)
ODD_F32_D = 136
ZERO_G_EVERY = 16
# a spin of the device (about 0.1 s) that the timed calls queue up behind
SPIN_CYCLES = 200_000_000
# what multiplies, by kernel and dtype (csrc/attention_fwd.cu,
# csrc/attention_bwd.cu, csrc/ce_fwd.cu, csrc/ce_bwd.cu, csrc/topk.cu); on
# the wide paths, the CUDA-core wide kernels but for the bf16 K1/K2 up to
# 256-wide heads (csrc/attention_wide_mma.cu), the bf16 K1/K2 past them
# (csrc/attention_chunked.cu) and the bf16 wide K3/K4 (csrc/ce_wide_fwd.cu,
# csrc/ce_wide_bwd.cu), redesigned on the tensor cores
WGMMA = {torch.bfloat16: "wgmma bf16", torch.float32: "cuda-core f32"}
MMA = {torch.bfloat16: "mma bf16", torch.float32: "cuda-core f32"}
# the f32 K1 and K2 off the tuned shapes (csrc/attention_tiled.cu,
# csrc/attention_bwd_tiled.cu), every f32 K3 and K4 (csrc/ce_fwd_tiled.cu,
# csrc/ce_bwd_tiled.cu; K4 in bf16 past 5,120 columns too), the tuned f32
# K6 (csrc/topk.cu) and K6 on the select kernels (csrc/topk_select.cu)
TILED_DESIGN = "tiled cuda-core f32"
DESIGN = {attn.KERNEL: MMA, attn.KERNEL_BWD: MMA, ce.KERNEL_FWD: WGMMA,
          ce.KERNEL_BWD: WGMMA,
          topk.KERNEL: {torch.bfloat16: WGMMA[torch.bfloat16],
                        torch.float32: TILED_DESIGN}}
WIDE_DESIGN = "wide cuda-core f32"
WIDE_MMA_DESIGN = "wide mma bf16"
# every f32 K1 and K2 at the tuned heads (csrc/attention_narrow.cu)
NARROW_DESIGN = "narrow cuda-core f32"
TILED_CE_DESIGN = {torch.bfloat16: "tiled cuda-core bf16",
                   torch.float32: TILED_DESIGN}
SELECT_DESIGN = {torch.bfloat16: "select wgmma bf16",
                 torch.float32: "select cuda-core f32"}
# this slice's routes as the device kernels that ran name them
# (torch.profiler): the design of each, by a fragment of its kernels' names
ROUTES = {topk.KERNEL: (("topk_long_emit_kernel", "long-path wgmma bf16"),
                        ("topk_select_logits_mma",
                         SELECT_DESIGN[torch.bfloat16]),
                        ("topk_select_logits_f32",
                         SELECT_DESIGN[torch.float32]),
                        ("topk_wide_mma", "wide wgmma bf16"),
                        ("topk_tiled_kernel", TILED_DESIGN)),
          star.KERNEL: (("star_group_kernel", "group wide"),
                        ("star_head_kernel", "head wide"),
                        ("star_satellite_kernel", "tuned")),
          attn.KERNEL: (("attention_fwd_tiled_kernel", TILED_DESIGN),
                        ("attention_narrow_fwd_kernel", NARROW_DESIGN)),
          attn.KERNEL_BWD: (("attention_bwd_resident_kernel",
                             "resident mma bf16"),
                            ("attention_bwd_cluster_kernel",
                             "cluster mma bf16"),
                            ("attention_bwd_tiled_dq_kernel", TILED_DESIGN),
                            ("attention_narrow_bwd_kernel", NARROW_DESIGN),
                            ("attention_narrow_dq_kernel", NARROW_DESIGN)),
          ce.KERNEL_FWD: (("ce_fwd_tiled_kernel", TILED_DESIGN),),
          ce.KERNEL_BWD: (("ce_bwd_tiled_p_kernel", TILED_DESIGN),)}


# the card's name and power limit as nvidia-smi gives them (phase_device)
CARD = {}


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi.stdout.strip()}")
    CARD["smi"] = smi.stdout.strip()
    # f32 matrix products in full f32: the f32 comparisons below rely on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def _kernel_name(mangled):
    """"ce_dh_wgmma_kernel<2>" from its Itanium-mangled name."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    m = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    return name + (f"<{', '.join(re.findall(r'Li(\d+)E', m.group(1)))}>"
                   if m else "")


def ptxas_report(log):
    """Lines "kernel: registers, spills" and ptxas's performance warnings
    from nvcc's -Xptxas -v output."""
    out, name, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[1]
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spills}")
        elif "Performance Loss" in line:
            kernel = _kernel_name(line.rsplit("'", 2)[-2])
            warning = line.split(": ", 1)[1].split(" in the")[0]
            out.append(f"{kernel}: {warning}")
    return out


def phase_build():
    """Build every kernel; print nvcc's time for each and ptxas's report
    (registers and spills per kernel, performance warnings)."""
    seconds = build.build(KERNELS + WIDE_LIBRARIES, force=True)
    for name, s in seconds.items():
        print(f"[build] csrc/{name}.cu: nvcc {s:.2f} s")
    for name in KERNELS + WIDE_LIBRARIES:
        for line in ptxas_report(build.LOGS[name]):
            print(f"[ptxas] {name}: {line}")


def cuda_ms(fn, iters, warm=3):
    """(device ms per call between CUDA events, host ms per call to enqueue
    it) over `iters` back-to-back calls after `warm` calls. When the two
    are close, the host, not the device, set the pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms(fn, iters):
    """Device ms per call over `iters` back-to-back calls queued behind a
    spin of the device (SPIN_CYCLES), so the events time the device running
    them, not the host enqueuing them. Where the enqueue outlasts the spin
    (a call that waits for the device, as a large allocation does): the
    time the device ran kernels over the calls, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        return profiler_device_ms(fn, iters)
    return start.elapsed_time(end) / iters


def profiler_device_ms(fn, iters):
    """ms a call in which the device ran a kernel (the union of the kernels'
    intervals), over `iters` calls under torch.profiler; None if it
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    return _busy_us(spans) / 1e3 / iters if spans else None


def ran_kernels(call):
    """The names of the device kernels two calls of `call` launched, after
    a short spin of the device (torch.profiler; every library is built
    before the first call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


# profiles of a call that may hold no device kernel at all before a route
# check fails: the card's profiler once recorded none for 3 profiles in a
# row, at a bf16 cluster K2 route check (PERF.md §7)
BLIND_PROFILES = 8


def routed_design(kernel, label, call, want):
    """(the design of the kernel that ran in `call` of K6 or K2, from its
    profiled name (ROUTES); the names); raises where the design is not
    `want`, the design the wrapper's route predicates choose. The card's
    profiler has left out kernels of a call (PERF.md): a call whose
    profile shows another design is profiled again, three times at most,
    and one whose profile holds no device kernel at all (not even the
    spin) again, BLIND_PROFILES times at most."""
    blind = other = 0
    while True:
        names = ran_kernels(call)
        if not names:
            blind += 1
            if blind < BLIND_PROFILES:
                continue
            raise AssertionError(f"{kernel} {label}: the profiler recorded "
                                 f"no device kernel in {blind} profiles of "
                                 f"the call (not even the spin); the route "
                                 f"is {want}")
        got = next((design for fragment, design in ROUTES[kernel]
                    if any(fragment in name for name in names)), None)
        if got == want:
            return got, names
        other += 1
        if other == 3:
            raise AssertionError(f"{kernel} {label}: the device ran {names} "
                                 f"({got}); the route is {want}")


def phase_routes(seed, bs):
    """The routes of the kernels redesigned in the latest slices, from
    torch.profiler's kernel names, before the export jobs start and before
    any other profile in this process (with those jobs on the card, and
    once after them, the profiler recorded no kernel of some or all
    calls): one call of the bf16 K6 at every k of WIDE_K and D of WIDE_D
    and at the wide beam, in each input mode, at every k of PAST_LIST_KS
    and D of PAST_LIST_D, at k = PAST_K6, past V = 25,000 and at k = V; of
    the f32 K6 at every k of SELECT_KS and D of WIDE_D and at the wide
    beam, in each input mode, and at k = V, and at the tuned kernel's rows
    (`tiled_topk_rows`); of K5 at every D of WIDE_STAR_D in both dtypes; of
    the bf16 K2 past 32 queries
    and keys (LONG_CASE, LONG_CROSS) and past 128 (PAST_RESIDENT,
    PAST_RESIDENT_CROSS) with and without dbias; of the f32 K1 and K2 (no
    dbias) at every wide shape the kernel rows hold (WIDE_HEADS, WIDE_PATH,
    WIDE_HEADS_PATH, OFF_STEP_HEADS); of the f32 K1 and K2 (with and
    without dbias) at the main model's heads at the training shapes
    (TRAIN_SHAPES, N = bs), K1 at the serving ones (N = 19 bs), K1 and K2
    past 32 (LONG_CASE, K2 also at LONG_CROSS) and both at 16 heads of 16;
    and of the f32 K3 and K4 at the main
    model's D = 128, WIDE_PATH_D, 512, WIDE_HEADS_D, OFF_STEP_D and
    ODD_F32_D, and K4 in its dh-only mode at D = 128 and WIDE_HEADS_D.
    Each must run its route's kernel (the tensor-core wide K6, its long
    path past k = 64, the select K6, the tuned f32 K6's tile, the wide
    K5's group of lanes a row, the resident K2, the cluster K2, the tiled
    K1, K2, K3 and K4, the narrow K1 and K2). -> {(kernel, case, dtype):
    (design, names)}, the design the kernel rows of those cases take
    (`set_designs`)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    modes = ("dyadic", "tie", "negative")
    v = Config().vocab_size
    seen = {}
    cases = [(f"k{k}_d{d}_{mode}", bs * BEAM, d, k, mode, bf16, None)
             for mode in modes for d in WIDE_D for k in WIDE_K]
    cases += [(f"k{k}_d{d}_{mode}", bs * BEAM, d, k, mode, f32, None)
              for mode in modes for d in WIDE_D for k in SELECT_KS]
    cases += [("wide_beam" + ("" if mode == "dyadic" else f"_{mode}"),
               bs * WIDE_BEAM, WIDE_PATH_D, WIDE_BEAM, mode, dtype, None)
              for mode in modes for dtype in (bf16, f32)]
    cases += [(f"k{k}_d{d}_route", bs * BEAM, d, k, "dyadic", bf16, None)
              for k in PAST_LIST_KS for d in PAST_LIST_D]
    cases += [(f"k{PAST_K6}_{mode}", bs * BEAM, WIDE_PATH_D, PAST_K6, mode,
               bf16, None) for mode in modes]
    cases += [(f"v{PAST_V}_{mode}", bs * BEAM, 128, PAST_LIST_K, mode, bf16,
               PAST_V) for mode in modes]
    cases += [(f"k_vocab_{mode}", bs, 128, v, mode, dtype, None)
              for mode in modes for dtype in (bf16, f32)]
    # the tuned f32 K6 (the 128 x 128 tile) at the kernel rows' shapes
    cases += [(label, n, d, k, mode, f32, None)
              for label, n, d, k, mode in tiled_topk_rows(bs)]
    for label, n, d, k, mode, dtype, vocab in cases:
        h, W, b = topk_inputs(n, d, k, mode, dtype, gen, vocab)
        seen[(topk.KERNEL, label, dtype)] = routed_design(
            topk.KERNEL, label, lambda: topk.topk_logits(h, W, b, k),
            topk_design(dtype, d, k, W.shape[0]))
    for d in WIDE_STAR_D:
        for dtype in (bf16, f32):
            ring = star_ring(bs, default_seq_len("star"), d, dtype, gen)
            seen[(star.KERNEL, f"star_d{d}", dtype)] = routed_design(
                star.KERNEL, f"star_d{d}",
                lambda: star.star_satellite(*ring, HEADS),
                star_design(dtype, d))
    for label, lq, lk in ((LONG_CASE, LONG_LEN, LONG_LEN), LONG_CROSS,
                          (f"long_{PAST_RESIDENT}", PAST_RESIDENT,
                           PAST_RESIDENT), *PAST_RESIDENT_CROSS):
        q, k, v, bias = attention_inputs(bs, lq, lk, bf16, gen, lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        for dbias in (False, True):
            seen[(attn.KERNEL_BWD, label + ("+dbias" if dbias else ""),
                  bf16)] = routed_design(
                attn.KERNEL_BWD, label,
                lambda: attn.attention_bwd(q, k, v, bias, g, HEADS,
                                           DH ** 0.5, dbias),
                k2_design(bf16, lq, lk, HEADS, DH))
    for label, heads, dh, lq, lk in [(f"wide_{heads}x{dh}", heads, dh, 31,
                                      31) for heads, dh in WIDE_HEADS] + \
            list(WIDE_PATH) + list(WIDE_HEADS_PATH) + [OFF_STEP_HEADS]:
        q, k, v, bias = attention_inputs(bs, lq, lk, f32, gen, lq == lk,
                                         heads, dh)
        seen[(attn.KERNEL, label, f32)] = routed_design(
            attn.KERNEL, label,
            lambda: attn.attention_fwd(q, k, v, bias, heads, dh ** 0.5),
            _attention_design(attn.KERNEL, f32, heads, dh))
        g = torch.randn(q.shape, generator=gen, device="cuda")
        seen[(attn.KERNEL_BWD, label, f32)] = routed_design(
            attn.KERNEL_BWD, label,
            lambda: attn.attention_bwd(q, k, v, bias, g, heads, dh ** 0.5,
                                       False),
            k2_design(f32, lq, lk, heads, dh))
    # the f32 K1 and K2 at the main model's heads (the narrow kernels) at
    # the kernel rows' shapes: training, serving, past 32, 16 heads
    narrow = [(f"train_{label}", bs, lq, lk, HEADS, DH, True)
              for label, lq, lk in TRAIN_SHAPES]
    narrow += [(label, len(SNRS) * bs, lq, lk, HEADS, DH, False)
               for label, lq, lk in TRAIN_SHAPES]
    narrow += [(LONG_CASE, bs, LONG_LEN, LONG_LEN, HEADS, DH, True),
               (LONG_CROSS[0], bs, *LONG_CROSS[1:], HEADS, DH, True),
               ("f32_k2_16x16", bs, 31, 31, 16, 16, True)]
    for label, n, lq, lk, heads, dh, bwd in narrow:
        q, k, v, bias = attention_inputs(n, lq, lk, f32, gen, lq == lk,
                                         heads, dh)
        if label != LONG_CROSS[0]:
            seen[(attn.KERNEL, label, f32)] = routed_design(
                attn.KERNEL, label,
                lambda: attn.attention_fwd(q, k, v, bias, heads, dh ** 0.5),
                _attention_design(attn.KERNEL, f32, heads, dh))
        if not bwd:
            continue
        g = torch.randn(q.shape, generator=gen, device="cuda")
        for dbias in (False, True):
            seen[(attn.KERNEL_BWD, label + ("+dbias" if dbias else ""),
                  f32)] = routed_design(
                attn.KERNEL_BWD, label,
                lambda: attn.attention_bwd(q, k, v, bias, g, heads,
                                           dh ** 0.5, dbias),
                k2_design(f32, lq, lk, heads, dh))
    cfg = Config()
    main_d = cfg.decoder_d_model
    for d, dh_only in ((main_d, False), (WIDE_PATH_D, False),
                       (WIDE_D[1], False), (WIDE_HEADS_D, False),
                       (OFF_STEP_D, False), (ODD_F32_D, False),
                       (main_d, True), (WIDE_HEADS_D, True)):
        h, W, b, labels, g = ce_inputs(f32, gen, bs * (cfg.seq_len - 1), d,
                                       cfg.vocab_size)
        lse = ce.ce_fwd_reference(h, W, b, labels)[1]
        label = f"ce_dh_only_d{d}" if dh_only else f"ce_d{d}"
        if d == main_d:
            label = label.replace(f"_d{d}", "")  # the kernel rows' names
        seen[(ce.KERNEL_BWD, label, f32)] = routed_design(
            ce.KERNEL_BWD, label,
            lambda: ce.ce_bwd(h, W, b, labels, lse, g, dh_only=dh_only),
            _ce_design(ce.KERNEL_BWD, f32, d))
        if not dh_only:
            seen[(ce.KERNEL_FWD, label, f32)] = routed_design(
                ce.KERNEL_FWD, label, lambda: ce.ce_fwd(h, W, b, labels),
                _ce_design(ce.KERNEL_FWD, f32, d))
    for (kernel, label, dtype), (design, names) in seen.items():
        # the port's kernels among them (not the spin, not PyTorch's fill)
        short = sorted(m.group(1) for m in (
            re.search(r"(\w+(?:<[\w, ]*>)?)\(", x) for x in names
            if "at::" not in x) if m and m.group(1) != "spin_kernel")
        print(f"[routes] {kernel} {label} "
              f"{str(dtype).replace('torch.', '')}: {design} "
              f"({', '.join(short)})")
    return seen


def set_designs(rows, seen):
    """The kernel rows of the cases `phase_routes` profiled take the design
    it read."""
    for row in rows:
        key = (row["kernel"], row["case"], getattr(torch, row["dtype"]))
        if key in seen:
            row["design"] = seen[key][0]


def attention_inputs(n, lq, lk, dtype, gen, causal, heads=HEADS, dh=DH):
    """q, k, v ~ N(0, 1) and a bias with padding (a random key length per
    row), the causal block where lq == lk, and two fully blocked query
    rows: every key of batch row 0, and every key of query 3 in row 1."""
    dev = "cuda"
    hd = heads * dh
    q = torch.randn((n, lq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((n, lk, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((n, lk, hd), generator=gen, device=dev).to(dtype)
    lens = torch.randint(1, lk + 1, (n,), generator=gen, device=dev)
    mask = (torch.arange(lk, device=dev)[None, :] >= lens[:, None]).float()
    mask = mask[:, None, :].expand(n, lq, lk).clone()
    if causal:
        mask = torch.maximum(mask, torch.triu(
            torch.ones((lq, lk), device=dev), diagonal=1))
    mask[0] = 1.0
    mask[1, 3] = 1.0
    return q, k, v, (mask * -1e9).contiguous()


def bound(nbytes, ops, dtype):
    """(least ms the card could take, "bytes" or "operations"): the bytes
    the function must move over the HBM rate, or its operations over the
    peak rate of their type, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def _abs_diff(a, b):
    """|a - b| in f32, 0 where both hold the same non-finite value (equal
    infinities in the same place), NaN where either is NaN."""
    a, b = a.float(), b.float()
    same = (a == b) & ~torch.isfinite(b)
    return torch.where(same, torch.zeros_like(a), (a - b).abs())


def _scale(x):
    """max |x| over its finite values, at least 1e-30."""
    x = x.float().abs()
    x = x[torch.isfinite(x)]
    return max(x.max().item() if x.numel() else 0.0, 1e-30)


def _worst(errs):
    """The largest of `errs`, NaN if any is NaN (Python's max may drop
    it)."""
    errs = list(errs)
    return math.nan if any(math.isnan(e) for e in errs) else max(errs,
                                                                 default=0.0)


def max_err(got, want, relative=False):
    """max |got - want| over tensors (None pairs skipped), over the largest
    finite |want| when `relative`; NaN where any difference is NaN, so that
    every gate that reads it fails. Two non-finite values count as equal
    only when they are the same value in the same place."""
    return _worst(_abs_diff(a, b).max().item()
                  / (_scale(b) if relative else 1.0)
                  for a, b in zip(got, want) if b is not None)


def softmax_part_err(got, want, softmax):
    """Largest over K4's outputs of max |got - want| over the largest value
    of the softmax part of `want` (`softmax`); NaN as `max_err`."""
    return _worst(_abs_diff(a, b).max().item() / _scale(c)
                  for a, b, c in zip(got, want, softmax))


# when the last kernel row ended (phase_kernels starts it)
_ROW_CLOCK = [0.0]


def kernel_row(kernel, case, dtype, err, tol, call, plain, library, nbytes,
               ops, iters, ops_dtype=None, plain_iters=None, **extra):
    """Check `err` against `tol`, time the kernel, its plain version (over
    `plain_iters` calls, default `iters`: fewer where a call takes a tenth
    of a second; 0: not timed, the plain version having been called once
    for the check) and the library call, print and return the row, with
    its `seconds` since the last row ended (its inputs, checks and times)
    and the `timed_seconds` of its timing alone. The operations are
    counted at the peak rate of `ops_dtype` (default: the row's dtype)."""
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{kernel} {case} {dtype}: max err {err} > "
                             f"{tol}")
    t0 = time.perf_counter()
    plain_iters = iters if plain_iters is None else plain_iters
    ms, host_ms = cuda_ms(call, iters)
    plain_ms = (cuda_ms(plain, plain_iters, warm=min(3, plain_iters))[0]
                if plain_iters else None)
    library_ms = cuda_ms(library, iters)[0] if library else None
    bound_ms, bound_by = bound(nbytes, ops, ops_dtype or dtype)
    row = {"kernel": kernel, "case": case,
           "dtype": str(dtype).replace("torch.", ""), **extra,
           "max_abs_err": err, "tol": tol, "ms": ms,
           "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops,
           "device_ms": device_ms(call, iters),
           "library_device_ms": device_ms(library, iters) if library
           else None}
    now = time.perf_counter()
    row["timed_seconds"], row["seconds"] = now - t0, now - _ROW_CLOCK[0]
    _ROW_CLOCK[0] = now
    print("[kernel] " + json.dumps(row))
    return row


def _sdpa_views(q, k, v, heads=HEADS):
    return [t.view(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
            for t in (q, k, v)]


def _attention_design(kernel, dtype, heads, dh):
    """What multiplies in the kernel that takes `heads` heads of `dh`."""
    if attn.uses_narrow(dtype, heads, dh):
        return NARROW_DESIGN
    if attn.uses_tiled(dtype, heads, dh):
        return TILED_DESIGN
    if attn.is_chunked_mma(dtype, heads, dh):
        return MMA[dtype]
    if attn.is_wide_mma(dtype, heads, dh):
        return WIDE_MMA_DESIGN
    return DESIGN[kernel][dtype]


def _ce_design(kernel, dtype, d):
    """What multiplies in the K3 or K4 kernel that takes width d."""
    if (ce.uses_tensor_core_bwd if kernel == ce.KERNEL_BWD
            else ce.uses_tensor_core_fwd)(dtype, d):
        return WGMMA[dtype]
    if (ce.uses_tiled_bwd if kernel == ce.KERNEL_BWD
            else ce.uses_tiled_fwd)(dtype, d):
        return TILED_CE_DESIGN[dtype]
    return DESIGN[kernel][dtype]


def ce_routes(dtype, d, fwd, bwd, dh_only=0):
    """The K3 and K4 counters of `fwd` K3 and `bwd` K4 launches (`dh_only`
    of them in K4's dh-only mode) at width d in `dtype` (a torch dtype or
    a Config's name of one): with their wide and tiled sub-counters, as the
    wrappers' routes count them."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    wide = ce.is_wide(dtype, d)
    return {ce.KERNEL_FWD: fwd, ce.KERNEL_BWD: bwd, DH_ONLY: dh_only,
            WIDE[ce.KERNEL_FWD]: fwd * wide, WIDE[ce.KERNEL_BWD]: bwd * wide,
            CE_TILED_FWD: fwd * ce.uses_tiled_fwd(dtype, d),
            CE_TILED: bwd * ce.uses_tiled_bwd(dtype, d)}


def _ce_launch(kernel, dtype, n, d, v, device):
    """The tiling the library of `kernel` (K3 or K4) at width d reports
    (rows of h and of W per tile, blocks per SM) and the vocab splits the
    wrapper takes from it; for the tensor-core wide K3 and K4 also their
    plan (K4's splits count the SMs in clusters)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if kernel == ce.KERNEL_FWD and ce.uses_tensor_core_fwd(dtype, d):
        dp = ce.padded_width(d)
        tiles = ce.tiling(ce.KERNEL_WIDE_FWD, dtype, dp, device)
        return {"tiling": list(tiles), "plan": ce.wide_fwd_plan(dp)._asdict(),
                "splits": ce.vocab_splits(n, v, sms, *tiles)}
    if kernel == ce.KERNEL_BWD and ce.uses_tensor_core_bwd(dtype, d):
        dp = ce.padded_width(d)
        plan = ce.wide_bwd_plan(dp)
        tiles = ce.tiling(ce.KERNEL_WIDE_BWD, dtype, dp, device)
        return {"tiling": list(tiles), "plan": plan._asdict(),
                "splits": ce.vocab_splits(n, v, max(1, sms // plan.cluster),
                                          *tiles)}
    if kernel == ce.KERNEL_BWD and ce.uses_tiled_bwd(dtype, d):
        tiles = ce.tiling(ce.KERNEL_BWD_TILED, dtype, d, device)
        return {"tiling": list(tiles), "workspace": list(
            ce.tiled_workspace(n, v)),
            "splits": ce.tiled_splits(n, d, v, sms, tiles[2])}
    if kernel == ce.KERNEL_FWD and ce.uses_tiled_fwd(dtype, d):
        kernel = ce.KERNEL_FWD_TILED
    tiles = ce.tiling(kernel, dtype, d, device)
    return {"tiling": list(tiles),
            "splits": ce.vocab_splits(n, v, sms, *tiles)}


def attention_case(label, n, lq, lk, dtype, gen, iters, heads=HEADS,
                   dh=DH):
    """K1 at one shape (at `heads` heads of `dh`: the wide kernels where
    the tuned ones do not take them)."""
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk, heads,
                                     dh)
    scale = math.sqrt(dh)
    out = attn.attention_fwd(q, k, v, bias, heads, scale)
    ref = attn.attention_fwd_reference(q, k, v, bias, heads, scale)
    torch.cuda.synchronize()
    # yardstick: one library call with the same additive mask (the port
    # never calls it)
    qh, kh, vh = _sdpa_views(q, k, v, heads)
    mask4 = bias[:, None].to(dtype)
    elt = q.element_size()
    return kernel_row(
        attn.KERNEL, label, dtype, max_err([out], [ref]), TOL[dtype],
        lambda: attn.attention_fwd(q, k, v, bias, heads, scale),
        lambda: attn.attention_fwd_reference(q, k, v, bias, heads, scale),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4,
                                               scale=1.0 / scale),
        (q.numel() + k.numel() + v.numel() + q.numel()) * elt
        + bias.numel() * 4, 2 * 2 * n * heads * lq * lk * dh, iters,
        n=n, lq=lq, lk=lk, heads=heads, dh=dh,
        design=_attention_design(attn.KERNEL, dtype, heads, dh))


def attention_bwd_case(label, n, lq, lk, dtype, gen, iters, dbias,
                       heads=HEADS, dh=DH, plain_iters=None):
    """K2 at one shape, with or without dbias (at `heads` heads of `dh`:
    the wide kernels where the tuned ones do not take them; the plain
    version timed over `plain_iters` calls, default `iters`)."""
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk, heads,
                                     dh)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = math.sqrt(dh)
    got = attn.attention_bwd(q, k, v, bias, g, heads, scale, dbias)
    want = attn.attention_bwd_reference(q, k, v, bias, g, heads, scale,
                                        dbias)
    torch.cuda.synchronize()
    if (got[3] is None) != (not dbias):
        raise AssertionError("attention_bwd: dbias returned when not asked "
                             "for, or missing")
    # yardstick: the backward of one library call with the same mask
    leaves = [t.detach().requires_grad_(True)
              for t in _sdpa_views(q, k, v, heads)]
    out = F.scaled_dot_product_attention(*leaves,
                                         attn_mask=bias[:, None].to(dtype),
                                         scale=1.0 / scale)
    gh = _sdpa_views(g, g, g, heads)[0]
    elt = q.element_size()
    tile = bias.numel() * 4
    nbytes = (2 * q.numel() + 2 * k.numel()) * elt + tile \
        + (q.numel() + 2 * k.numel()) * elt + (tile if dbias else 0)
    return kernel_row(
        attn.KERNEL_BWD, label + ("+dbias" if dbias else ""), dtype,
        max_err(got, want), TOL[dtype],
        lambda: attn.attention_bwd(q, k, v, bias, g, heads, scale, dbias),
        lambda: attn.attention_bwd_reference(q, k, v, bias, g, heads, scale,
                                             dbias),
        lambda: torch.autograd.grad(out, leaves, gh, retain_graph=True),
        nbytes, 5 * 2 * n * heads * lq * lk * dh, iters,
        n=n, lq=lq, lk=lk, heads=heads, dh=dh, dbias=dbias,
        design=k2_design(dtype, lq, lk, heads, dh), plain_iters=plain_iters)


def k2_design(dtype, lq, lk, heads, dh):
    """What multiplies in the K2 kernel that takes Lq x Lk at `heads` heads
    of `dh`."""
    if attn.uses_resident(dtype, lq, lk, heads, dh):
        return "resident mma bf16"
    if attn.uses_cluster(dtype, lq, lk, heads, dh):
        return "cluster mma bf16"
    return _attention_design(attn.KERNEL_BWD, dtype, heads, dh)


def attention_bwd_bitwise(label, n, lq, lk, dtype, gen, heads=HEADS, dh=DH):
    """K2 twice without dbias and once with it on the same inputs (at
    `heads` heads of `dh`): dq, dk and dv must be bitwise equal in all three
    (no atomics, a fixed order of every sum, and the same per-head
    arithmetic whether a block holds one head or all of them)."""
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk, heads,
                                     dh)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = math.sqrt(dh)
    calls = [attn.attention_bwd(q, k, v, bias, g, heads, scale, dbias)[:3]
             for dbias in (False, False, True)]
    torch.cuda.synchronize()
    same = [all(torch.equal(a, b) for a, b in zip(calls[0], other))
            for other in calls[1:]]
    print(f"[kernel] {attn.KERNEL_BWD} {label} {dtype}: bitwise equal "
          f"twice without dbias {same[0]}, with and without {same[1]}")
    if not all(same):
        raise AssertionError(f"{attn.KERNEL_BWD} {label} {dtype}: calls on "
                             f"the same inputs differ")


def ce_inputs(dtype, gen, n, d, v, zero_rows=False):
    """h ~ N(0, 1) (n, d) and the tied table W ~ N(0, 0.1^2) (v, d) in
    `dtype`; b ~ N(0, 0.1^2), uniform labels, cotangents in [0, 1); with
    `zero_rows`, zero in every ZERO_G_EVERY-th row (a padded row's: its dh
    row must be 0, and it adds nothing to dW and db; no draw more)."""
    h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    W = (0.1 * torch.randn((v, d), generator=gen, device="cuda")).to(dtype)
    b = 0.1 * torch.randn(v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    g = torch.rand(n, generator=gen, device="cuda")
    if zero_rows:
        g[::ZERO_G_EVERY] = 0.0
    return h, W, b, labels, g


def zero_rows_check(label, dtype, dh, g):
    """The rows of zero cotangent have dh rows of exact zeros."""
    if torch.count_nonzero(dh[g == 0]).item():
        raise AssertionError(f"ce_bwd {label} {dtype}: a row of zero "
                             f"cotangent has a nonzero dh")


def ce_cases(dtype, gen, iters, n, d, v, label="ce"):
    """K3 and K4 at the training path's shape (tied layout: W is (V, D)),
    or at another width D (the wide kernels where the tuned ones do not
    take it; the f32 ones off the tuned widths, which take milliseconds a
    call, timed over WIDE_F32_CE_ITERS calls); K4 also bitwise over two
    calls; in f32 (the tiled kernels) with rows of zero cotangent, whose dh
    rows must be exactly 0."""
    f32 = dtype == torch.float32
    if f32 and ce.is_wide(dtype, d):
        iters = min(iters, WIDE_F32_CE_ITERS)
    h, W, b, labels, g = ce_inputs(dtype, gen, n, d, v, zero_rows=f32)
    got = ce.ce_fwd(h, W, b, labels)
    want = ce.ce_fwd_reference(h, W, b, labels)
    lse = want[1]
    dgot = ce.ce_bwd(h, W, b, labels, lse, g)
    again = ce.ce_bwd(h, W, b, labels, lse, g)
    dwant = ce.ce_bwd_reference(h, W, b, labels, lse, g)
    softmax_err = softmax_part_err(
        dgot, dwant, ce.ce_bwd_reference(h, W, b, labels, lse, g, True))
    torch.cuda.synchronize()
    if not softmax_err <= SOFTMAX_TOL[dtype]:
        raise AssertionError(f"ce_bwd {dtype}: err {softmax_err} of the "
                             f"softmax part > {SOFTMAX_TOL[dtype]}")
    # no atomics, one order of sums: two calls give the same bits
    if not all(torch.equal(x, y) for x, y in zip(dgot, again)):
        raise AssertionError(f"ce_bwd {label} {dtype}: calls on the same "
                             f"inputs differ")
    zero_rows_check(label, dtype, dgot[0], g)
    elt = h.element_size()
    ins = (n * d + v * d) * elt + v * 4 + n * 4
    shape = {"n": n, "d": d, "v": v}
    # what multiplies; rows of h and of W per tile and blocks per SM, as
    # each library reports them, and the vocab splits the wrapper took
    launch = {kernel: {"design": _ce_design(kernel, dtype, d),
                       **_ce_launch(kernel, dtype, n, d, v, h.device)}
              for kernel in (ce.KERNEL_FWD, ce.KERNEL_BWD)}
    # yardsticks: PyTorch's cross entropy over materialized logits, and
    # its backward
    leaves = [t.detach().requires_grad_(True) for t in (h, W, b)]
    loss = F.cross_entropy((leaves[0] @ leaves[1].t()).float() + leaves[2],
                           labels, reduction="none")
    rows = [kernel_row(
        ce.KERNEL_FWD, label, dtype, max_err(got, want), TOL[dtype],
        lambda: ce.ce_fwd(h, W, b, labels),
        lambda: ce.ce_fwd_reference(h, W, b, labels),
        lambda: F.cross_entropy((h @ W.t()).float() + b, labels,
                                reduction="none"),
        ins + 2 * n * 4, 2 * n * d * v, iters, **shape,
        **launch[ce.KERNEL_FWD])]
    # one recompute of the logits and the two products
    rows.append(kernel_row(
        ce.KERNEL_BWD, label, dtype, max_err(dgot, dwant, relative=True),
        TOL[dtype],
        lambda: ce.ce_bwd(h, W, b, labels, lse, g),
        lambda: ce.ce_bwd_reference(h, W, b, labels, lse, g),
        lambda: torch.autograd.grad(loss, leaves, g, retain_graph=True),
        ins + 2 * n * 4 + (n * d + v * d + v) * 4, 6 * n * d * v, iters,
        **shape, **launch[ce.KERNEL_BWD], softmax_err=softmax_err,
        softmax_tol=SOFTMAX_TOL[dtype]))
    return rows


def ce_dh_only_case(dtype, gen, iters, n, d, v, label="ce_dh_only"):
    """K4 in its dh-only mode at the training path's shape (or another
    width d): dh bitwise equal to the full mode's, and against the plain
    version's dh relative to its largest value (and on the softmax part,
    SOFTMAX_TOL), in f32 with rows of zero cotangent (their dh rows 0); no
    dW or db returned. The library yardstick is PyTorch's
    cross entropy's backward with respect to h alone. The f32 wide K4 is
    timed over WIDE_F32_CE_ITERS calls."""
    f32 = dtype == torch.float32
    if f32 and ce.is_wide(dtype, d):
        iters = min(iters, WIDE_F32_CE_ITERS)
    h, W, b, labels, g = ce_inputs(dtype, gen, n, d, v, zero_rows=f32)
    lse = ce.ce_fwd_reference(h, W, b, labels)[1]
    full = ce.ce_bwd(h, W, b, labels, lse, g)
    got = ce.ce_bwd(h, W, b, labels, lse, g, dh_only=True)
    want = ce.ce_bwd_reference(h, W, b, labels, lse, g, dh_only=True)
    part = ce.ce_bwd_reference(h, W, b, labels, lse, g, softmax_only=True,
                               dh_only=True)
    torch.cuda.synchronize()
    if got[1] is not None or got[2] is not None:
        raise AssertionError("ce_bwd dh_only returned dW or db")
    if not torch.equal(got[0], full[0]):
        raise AssertionError(f"ce_bwd dh_only {dtype}: dh differs from the "
                             f"full mode's")
    zero_rows_check(label, dtype, got[0], g)
    softmax_err = softmax_part_err(got[:1], want[:1], part[:1])
    if not softmax_err <= SOFTMAX_TOL[dtype]:
        raise AssertionError(f"ce_bwd dh_only {dtype}: err {softmax_err} of "
                             f"the softmax part > {SOFTMAX_TOL[dtype]}")
    leaf = h.detach().requires_grad_(True)
    loss = F.cross_entropy((leaf @ W.t()).float() + b, labels,
                           reduction="none")
    elt = h.element_size()
    # reads h, W, b, labels, lse, g; writes dh (f32); a logits recompute
    # and the product P W
    return kernel_row(
        ce.KERNEL_BWD, label, dtype,
        max_err(got[:1], want[:1], relative=True), TOL[dtype],
        lambda: ce.ce_bwd(h, W, b, labels, lse, g, dh_only=True),
        lambda: ce.ce_bwd_reference(h, W, b, labels, lse, g, dh_only=True),
        lambda: torch.autograd.grad(loss, [leaf], g, retain_graph=True),
        (n * d + v * d) * elt + v * 4 + 3 * n * 4 + n * d * 4,
        4 * n * d * v, iters, n=n, d=d, v=v,
        design=_ce_design(ce.KERNEL_BWD, dtype, d), softmax_err=softmax_err,
        softmax_tol=SOFTMAX_TOL[dtype])


def dyadic(shape, scale, gen, dtype):
    """Random integers in [-scale, scale] over 8 * scale, for a power of
    two `scale`: exact in bf16. With h and b at scale 8 and W at scale 2,
    every logit h . W_v + b_v (D = 128) is a multiple of 2^-10 below 2.2 in
    magnitude, exact in f32 whatever the order of the sums: the kernel and
    its plain version must then rank the logits alike, exact ties (of which
    these inputs have many) included."""
    x = torch.randint(-scale, scale + 1, shape, generator=gen, device="cuda")
    return (x.float() / (8 * scale)).to(dtype)


def topk_inputs(n, d, k, mode, dtype, gen, v=None):
    """h (N, D), W (V, D) and b (V,) of K6's cases (see topk_case; V the
    vocab's unless given)."""
    v = v or Config().vocab_size
    if mode == "tie":
        h = torch.ones((n, d), device="cuda", dtype=dtype)
        W = torch.zeros((v, d), device="cuda", dtype=dtype)
        b = torch.zeros(v, device="cuda")
        b[[v - 3, 7, v // 2, 130, 64]] = 1.0
        if k > 8:  # more equal maxima than the tuned kernel's list holds
            b[torch.arange(9, min(v, 9 + 7 * k), 7)] = 1.0
        return h, W, b
    h = dyadic((n, d), 8, gen, dtype)
    W = dyadic((v, d), 2, gen, dtype)
    b = dyadic((v,), 8, gen, torch.float32)
    if mode == "negative":
        b -= 3.0
        if not (h.float() @ W.float().t() + b).amax().item() < 0:
            raise AssertionError("topk negative: a logit is not below 0")
    return h, W, b


def tiled_topk_rows(bs):
    """The K6 rows of the tuned kernel (phase_kernels, widened_cases), as
    (label, N, D, k, mode): the CLI's beam, the beam sweep, k = 1 and 8,
    every logit below 0, equal maxima, and the widened decoder's D."""
    n = bs * BEAM
    return (("beam", n, 128, BEAM, "dyadic"),
            ("beam_sweep", len(SNRS) * n, 128, BEAM, "dyadic"),
            ("k1", n, 128, 1, "dyadic"), ("k8", n, 128, 8, "dyadic"),
            ("negative", n, 128, 8, "negative"), ("tie", n, 128, 8, "tie"),
            (f"d{WIDE_PATH_D}", n, WIDE_PATH_D, BEAM, "dyadic"))


def star_ring(b, length, d, dtype, gen):
    """K5's ring at B sequences of L rows of width D: q, kh, vh, ke, ve
    (B, L, D) and ks, vs (B, D) ~ N(0, 1)."""
    return [torch.randn((b, length, d) if i < 5 else (b, d), generator=gen,
                        device="cuda").to(dtype) for i in range(7)]


def topk_design(dtype, d, k, v):
    """What multiplies in the K6 kernel that takes width d and k over V = v
    rows of W."""
    if topk.uses_long_list(dtype, d, k, v):
        return "long-path wgmma bf16"
    if topk.uses_select(dtype, d, k, v):
        return SELECT_DESIGN[dtype]
    if topk.uses_tensor_core(dtype, d, k, v):
        return "wide wgmma bf16"
    return WIDE_DESIGN if topk.is_wide(d, k) else DESIGN[topk.KERNEL][dtype]


def topk_case(label, n, dtype, gen, iters, k=BEAM, mode="dyadic", d=None,
              plain_iters=None, v=None):
    """K6 at one shape (W the (V, D) table, V = 22,234: its last vocab tile
    of 128 rows is ragged). `mode`: "dyadic", exact logits with many ties;
    "tie", every logit equal to the bias, which is 1 at indices in
    different vocab splits and 0 elsewhere; "negative", the dyadic logits
    less 3, so every logit is below 0 and a padded vocab column (zero
    logit) in the list would show. `d` (default the decoder's 128) and k
    past 8 take the wide kernels where the tuned one does not; the plain
    version is timed over `plain_iters` calls (default `iters`). `v`: a
    vocab of another size (V = 32,000: past the long path's)."""
    d = d or Config().decoder_d_model
    h, W, b = topk_inputs(n, d, k, mode, dtype, gen, v)
    v = W.shape[0]
    vals, idx, lse = topk.topk_logits(h, W, b, k)
    ref = topk.topk_logits_reference(h, W, b, k)
    torch.cuda.synchronize()
    if not torch.equal(idx, ref[1]):
        rows = (idx != ref[1]).any(dim=1).sum().item()
        raise AssertionError(f"topk {label} {dtype}: indices differ from "
                             f"the plain version in {rows} rows")

    def library():
        logits = (h @ W.t()).float() + b
        return torch.topk(logits, k), torch.logsumexp(logits, dim=-1)

    # rows of h and of W per tile and blocks per SM, as the library reports
    # them (the tensor-core wide kernel's by k), and the vocab splits the
    # wrapper took from them
    tiles = (ce.tiling(topk.KERNEL_WIDE_MMA, dtype, k, h.device)
             if topk.uses_tensor_core(dtype, d, k, v) else
             ce.tiling(topk.KERNEL_SELECT if topk.uses_select(dtype, d, k, v)
                       else topk.KERNEL, dtype, d, h.device))
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = ce.vocab_splits(n, v, sms, *tiles)
    extra = {}
    if topk.uses_long_list(dtype, d, k, v):
        # the long path: the partial kernel's splits, the emission's, a
        # row's candidate slots
        plan = topk.long_plan(n, v, k, sms, tiles, topk.emit_tiling(h.device))
        splits, extra = plan.splits, {"long_plan": plan._asdict()}
    elt = h.element_size()
    return kernel_row(
        topk.KERNEL, label, dtype, max_err([vals, lse], [ref[0], ref[2]]),
        TOL[dtype], lambda: topk.topk_logits(h, W, b, k),
        lambda: topk.topk_logits_reference(h, W, b, k), library,
        (n * d + v * d) * elt + v * 4 + n * k * 8 + n * 4, 2 * n * d * v,
        iters, n=n, d=d, v=v, k=k, mode=mode,
        design=topk_design(dtype, d, k, v), tiling=list(tiles),
        splits=splits,
        plain_iters=plain_iters, **extra)


def star_case(label, b, length, dtype, gen, iters, d=HEADS * DH):
    """K5 at B sequences of L rows of D = 128 (8 heads of 16; another D in
    8 heads: the wide kernel where the tuned one does not take it): the
    ring q, kh, vh, ke, ve (B, L, D) and ks, vs (B, D) ~ N(0, 1)."""
    ring = star_ring(b, length, d, dtype, gen)
    q, kh, vh, ke, ve, ks, vs = ring
    out = star.star_satellite(*ring, HEADS)
    ref = star.ring_reference(*ring, HEADS)
    torch.cuda.synchronize()
    # yardstick: one library call over the five stacked contexts of each
    # row (stacked here, outside the timing)
    n = b * length
    k5, v5 = (star.contexts(x, xe, xs).view(5, n, HEADS, d // HEADS)
              .permute(1, 2, 0, 3) for x, xe, xs in ((kh, ke, ks),
                                                      (vh, ve, vs)))
    qh = q.view(n, HEADS, 1, d // HEADS)
    # bytes: the ring, read once (q, kh, vh, ke, ve: N x D each; ks, vs:
    # B x D each), and the output; operations: the 5 dot products and the
    # weighted sum of 5 (an f32 multiply-add each), on the f32 cores
    elt = q.element_size()
    return kernel_row(
        star.KERNEL, label, dtype, max_err([out], [ref]), TOL[dtype],
        lambda: star.star_satellite(*ring, HEADS),
        lambda: star.ring_reference(*ring, HEADS),
        lambda: F.scaled_dot_product_attention(qh, k5, v5),
        (6 * n * d + 2 * b * d) * elt, 2 * 2 * 5 * n * d, iters,
        ops_dtype=torch.float32, b=b, l=length, n=n, d=d, heads=HEADS,
        design=star_design(dtype, d))


def star_design(dtype, d):
    """The K5 kernel that takes width d in HEADS heads: the tuned one, or
    the wide kernels' path (a group of lanes per row, a warp per row and
    head)."""
    if star.takes_width(d, HEADS):
        return "tuned"
    return f"{star.wide_plan(d, HEADS, dtype.itemsize).path} wide"


def phase_kernels(seed, n, bs, iters):
    """Every kernel at the serving paths' shapes (K1, N = 19 SNRs x bs; K6
    at N = bs x 4 beams, the CLI's beam, and 19 x bs x 4, the beam sweep;
    K5 at N = 19 x bs x 31, the star sweep's decoder) and the training
    path's (K1-K2 at N = bs; K3-K4 and K5 at bs x 31 rows), and K5 at
    bs - 1 sequences; K6 also at k = 1
    and 8, with exact ties and with every logit below 0; K5 also at L = 1
    and 2; K2 bitwise equal between calls with and without dbias."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = Config()
    rows = []
    _ROW_CLOCK[0] = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for label, lq, lk in TRAIN_SHAPES:
            rows.append(attention_case(label, n, lq, lk, dtype, gen, iters))
        for label, lq, lk in TRAIN_SHAPES:
            rows.append(attention_case("train_" + label, bs, lq, lk, dtype,
                                       gen, iters))
            for dbias in (False, True):
                rows.append(attention_bwd_case("train_" + label, bs, lq, lk,
                                               dtype, gen, iters, dbias))
        # past 32: query tiles, key tiles streamed
        rows.append(attention_case(LONG_CASE, bs, LONG_LEN, LONG_LEN, dtype,
                                   gen, iters))
        for dbias in (False, True):
            rows.append(attention_bwd_case(LONG_CASE, bs, LONG_LEN, LONG_LEN,
                                           dtype, gen, iters, dbias))
            rows.append(attention_bwd_case(LONG_CROSS[0], bs,
                                           *LONG_CROSS[1:], dtype, gen,
                                           iters, dbias))
        rows += ce_cases(dtype, gen, iters, bs * (cfg.seq_len - 1),
                         cfg.decoder_d_model, cfg.vocab_size)
        rows.append(ce_dh_only_case(dtype, gen, iters, bs * (cfg.seq_len - 1),
                                    cfg.decoder_d_model, cfg.vocab_size))
        rows.append(topk_case("beam", bs * BEAM, dtype, gen, iters))
        rows.append(topk_case("beam_sweep", n * BEAM, dtype, gen, iters))
        for k in (1, 8):
            rows.append(topk_case(f"k{k}", bs * BEAM, dtype, gen, iters, k))
        rows.append(topk_case("negative", bs * BEAM, dtype, gen, iters, 8,
                              "negative"))
        rows.append(topk_case("tie", bs * BEAM, dtype, gen, iters, 8, "tie"))
        star_len = default_seq_len("star")
        rows.append(star_case("star_train", bs, star_len, dtype, gen,
                              iters))
        rows.append(star_case("star_sweep", n, star_len, dtype, gen, iters))
        # an odd number of sequences; L = 1 and 2, where the neighbours
        # coincide
        rows.append(star_case("odd_rows", bs - 1, star_len, dtype, gen,
                              iters))
        for length in (1, 2):
            rows.append(star_case(f"L{length}", bs, length, dtype, gen,
                                  iters))
        for label, lq, lk in [("train_" + label, lq, lk)
                              for label, lq, lk in TRAIN_SHAPES] + [
                                  (LONG_CASE, LONG_LEN, LONG_LEN),
                                  LONG_CROSS]:
            attention_bwd_bitwise(label, bs, lq, lk, dtype, gen)
        rows += widened_cases(dtype, gen, iters, bs)
    return rows


def widened_cases(dtype, gen, iters, bs):
    """The shapes the kernels took only after their wide paths,
    each against its plain version with its time and bound: the f32 K2 at
    16 heads of 16 (the narrow kernel; the lane-per-query kernel before it
    did not fit the card's shared memory there); K1/K2 at head widths 24,
    64 and 128 and at 32 heads (the decoder self-attention's shape, N =
    bs); K3/K4 at D = 200 and 512 (N = bs x 31); K5 at D = 96 and 512 (the star train
    step's ring); K6 at k = 9, 16 and 64 (with exact ties past the tuned
    list's 8) and at D = 200 and 512; K1/K2 and K6 at the shapes the
    widened CLI paths of `phase_wide` give them (WIDE_PATH, WIDE_BEAM);
    the chunked K1/K2 (K2 bitwise over calls, in bf16 also with dbias) and
    the wide K3/K4 at the shapes of `phase_wide_heads` (WIDE_HEADS_PATH,
    WIDE_HEADS_D), and at widths off their steps (OFF_STEP_HEADS,
    OFF_STEP_D; the f32 K3/K4 also at ODD_F32_D); the f32 K2 (the tiled
    kernels) bitwise over calls at every wide shape."""
    cfg = Config()
    rows = []
    if dtype == torch.float32:
        rows.append(attention_bwd_case("f32_k2_16x16", bs, 31, 31, dtype,
                                       gen, iters, False, 16, 16))
    for label, heads, dh, lq, lk in [(f"wide_{heads}x{dh}", heads, dh, 31,
                                      31) for heads, dh in WIDE_HEADS] + \
            list(WIDE_PATH) + list(WIDE_HEADS_PATH):
        rows.append(attention_case(label, bs, lq, lk, dtype, gen, iters,
                                   heads, dh))
        rows.append(attention_bwd_case(label, bs, lq, lk, dtype, gen, iters,
                                       False, heads, dh))
        if dtype == torch.float32 and (label, heads, dh, lq, lk) not in \
                WIDE_HEADS_PATH:
            # the tiled f32 K2 (the wide-heads shapes below)
            attention_bwd_bitwise(label, bs, lq, lk, dtype, gen, heads, dh)
    for label, heads, dh, lq, lk in list(WIDE_HEADS_PATH) + [OFF_STEP_HEADS]:
        if label == OFF_STEP_HEADS[0]:
            rows.append(attention_case(label, bs, lq, lk, dtype, gen, iters,
                                       heads, dh))
            rows.append(attention_bwd_case(label, bs, lq, lk, dtype, gen,
                                           iters, False, heads, dh))
        # the bf16 chunked K2 with dbias (the f32 chunked kernels' dbias,
        # sums of dp of 512 products, is held relative to its largest value
        # by the card tests)
        if dtype == torch.bfloat16:
            rows.append(attention_bwd_case(label, bs, lq, lk, dtype, gen,
                                           iters, True, heads, dh))
        attention_bwd_bitwise(label, bs, lq, lk, dtype, gen, heads, dh)
    for d in WIDE_D:
        rows += ce_cases(dtype, gen, iters, bs * (cfg.seq_len - 1), d,
                         cfg.vocab_size, label=f"ce_d{d}")
        rows.append(topk_case(f"d{d}", bs * BEAM, dtype, gen, iters, d=d))
    rows += ce_cases(dtype, gen, iters, bs * (cfg.seq_len - 1), WIDE_HEADS_D,
                     cfg.vocab_size, label=f"ce_d{WIDE_HEADS_D}")
    rows.append(ce_dh_only_case(dtype, gen, iters, bs * (cfg.seq_len - 1),
                                WIDE_HEADS_D, cfg.vocab_size,
                                label=f"ce_dh_only_d{WIDE_HEADS_D}"))
    rows += ce_cases(dtype, gen, iters, bs * (cfg.seq_len - 1), OFF_STEP_D,
                     cfg.vocab_size, label=f"ce_d{OFF_STEP_D}")
    if dtype == torch.float32:
        # from a generator of its own: the later rows' draws stay as they
        # were before this row was added
        odd = torch.Generator(device="cuda").manual_seed(
            gen.initial_seed() + ODD_F32_D)
        rows += ce_cases(dtype, odd, iters, bs * (cfg.seq_len - 1),
                         ODD_F32_D, cfg.vocab_size, label=f"ce_d{ODD_F32_D}")
    for k in WIDE_K:
        rows.append(topk_case(f"k{k}", bs * BEAM, dtype, gen, iters, k,
                              "tie" if k == WIDE_K[1] else "dyadic"))
    rows.append(topk_case("wide_beam", bs * WIDE_BEAM, dtype, gen, iters,
                          WIDE_BEAM, d=WIDE_PATH_D))
    modes = ("dyadic", "tie", "negative")
    if dtype == torch.bfloat16:
        # the tensor-core wide K6 at every list length and width of the
        # widened shapes, and at the wide beam, in all three input modes
        # (the tie and negative modes timed over fewer calls, their plain
        # versions not timed)
        for mode in modes:
            timed = iters if mode == "dyadic" else min(iters, MODE_ITERS)
            plain = None if mode == "dyadic" else 0
            for d in WIDE_D:
                for k in WIDE_K:
                    rows.append(topk_case(f"k{k}_d{d}_{mode}", bs * BEAM,
                                          dtype, gen, timed, k, mode, d,
                                          plain_iters=plain))
            if mode != "dyadic":
                rows.append(topk_case(f"wide_beam_{mode}", bs * WIDE_BEAM,
                                      dtype, gen, timed, WIDE_BEAM, mode,
                                      WIDE_PATH_D, plain_iters=plain))
        # past its lists of 64: its long path (k = 100 and 256, and the
        # beam-100 path's call; their plain versions, k rounds each, timed
        # over 2 calls, the beam-100 one over 1); K2 past the resident
        # kernel's lengths: the cluster kernel (bitwise over calls too),
        # and past it the long-length kernels (the plain version at 1,024 x
        # 1,024 not timed)
        rows.append(topk_case(f"k{PAST_LIST_K}", bs * BEAM, dtype, gen,
                              iters, PAST_LIST_K, d=WIDE_PATH_D,
                              plain_iters=2))
        for d in WIDE_D:
            rows.append(topk_case(f"k{PAST_LIST_KS[-1]}_d{d}", bs * BEAM,
                                  dtype, gen, iters, PAST_LIST_KS[-1],
                                  d=d, plain_iters=2))
        rows.append(topk_case("beam100", bs * BEAM100, dtype, gen, iters,
                              BEAM100, plain_iters=1))
        # past k = 256 and past V = 25,000: the select kernels
        for mode in modes:
            plain = 2 if mode == "dyadic" else 0
            rows.append(topk_case(f"k{PAST_K6}_{mode}", bs * BEAM, dtype,
                                  gen, min(iters, LONG_K_ITERS), PAST_K6,
                                  mode, WIDE_PATH_D, plain_iters=plain))
            rows.append(topk_case(f"v{PAST_V}_{mode}", bs * BEAM, dtype, gen,
                                  iters if mode == "dyadic"
                                  else min(iters, MODE_ITERS), PAST_LIST_K,
                                  mode, 128, plain_iters=plain, v=PAST_V))
        for dbias in (False, True):
            rows.append(attention_bwd_case(f"long_{PAST_RESIDENT}", bs,
                                           PAST_RESIDENT, PAST_RESIDENT,
                                           dtype, gen, iters, dbias))
        for label, lq, lk in PAST_RESIDENT_CROSS:
            rows.append(attention_bwd_case(label, bs, lq, lk, dtype, gen,
                                           iters, False))
        rows.append(attention_bwd_case(f"long_{CLUSTER_LEN}", bs,
                                       CLUSTER_LEN, CLUSTER_LEN, dtype, gen,
                                       iters, False, plain_iters=5))
        rows.append(attention_bwd_case(f"long_{PAST_CLUSTER}", bs,
                                       PAST_CLUSTER, PAST_CLUSTER, dtype,
                                       gen, min(iters, 5), False,
                                       plain_iters=0))
        for label, lq, lk in ((f"long_{PAST_RESIDENT}", PAST_RESIDENT,
                               PAST_RESIDENT), *PAST_RESIDENT_CROSS,
                              (f"long_{CLUSTER_LEN}", CLUSTER_LEN,
                               CLUSTER_LEN)):
            attention_bwd_bitwise(label, bs, lq, lk, dtype, gen)
    else:
        # every f32 wide K6 on the select kernels: at every k of SELECT_KS
        # and D of WIDE_D, and at the wide beam, in all three input modes
        # (the tie and negative modes timed over fewer calls, their plain
        # versions not timed; k = PAST_K6's plain version over 2 calls)
        for mode in modes:
            timed = iters if mode == "dyadic" else min(iters, MODE_ITERS)
            plain = None if mode == "dyadic" else 0
            for d in WIDE_D:
                for k in SELECT_KS:
                    rows.append(topk_case(
                        f"k{k}_d{d}_{mode}", bs * BEAM, dtype, gen,
                        min(timed, LONG_K_ITERS) if k == PAST_K6 else timed,
                        k, mode, d,
                        plain_iters=2 if k == PAST_K6 and plain is None
                        else plain))
            if mode != "dyadic":
                rows.append(topk_case(f"wide_beam_{mode}", bs * WIDE_BEAM,
                                      dtype, gen, timed, WIDE_BEAM, mode,
                                      WIDE_PATH_D, plain_iters=plain))
    # k = V (a full sort of each row's logits, the select kernels), bs rows
    # at D = 128, in all three modes; the plain version (V rounds, seconds a
    # call) called once for the check and not timed
    for mode in ("dyadic", "tie", "negative"):
        rows.append(topk_case(f"k_vocab_{mode}", bs, dtype, gen,
                              min(iters, LONG_K_ITERS), cfg.vocab_size,
                              mode, 128, plain_iters=0))
    for d in WIDE_STAR_D:
        rows.append(star_case(f"star_d{d}", bs, default_seq_len("star"),
                              dtype, gen, iters, d))
    return rows


def reset_launches():
    attn.reset_launches()
    ce.reset_launches()
    star.reset_launches()
    topk.reset_launches()


def launches():
    """Launches of K1-K6 since the last reset, how many of K4's ran in its
    dh-only mode, how many of each went to its wide kernels, and how many
    of K6's went to the tensor-core wide kernel's lists past 64 and to the
    select kernels, of K2's to the cluster kernel, of K1's and K2's to the
    tiled and the narrow f32 kernels, of K3's and K4's to the tiled
    kernels and of K6's to the tuned kernel's f32 tile."""
    return {attn.KERNEL: attn.launches, attn.KERNEL_BWD: attn.bwd_launches,
            ce.KERNEL_FWD: ce.fwd_launches, ce.KERNEL_BWD: ce.bwd_launches,
            star.KERNEL: star.launches, topk.KERNEL: topk.launches,
            DH_ONLY: ce.bwd_dh_only_launches,
            WIDE[attn.KERNEL]: attn.wide_launches,
            WIDE[attn.KERNEL_BWD]: attn.wide_bwd_launches,
            WIDE[ce.KERNEL_FWD]: ce.wide_fwd_launches,
            WIDE[ce.KERNEL_BWD]: ce.wide_bwd_launches,
            WIDE[star.KERNEL]: star.wide_launches,
            WIDE[topk.KERNEL]: topk.wide_launches,
            LONG_LIST: topk.long_list_launches,
            CLUSTER: attn.cluster_bwd_launches,
            SELECT: topk.select_launches,
            TILED: attn.tiled_launches,
            TILED_BWD: attn.tiled_bwd_launches,
            CE_TILED: ce.tiled_bwd_launches,
            CE_TILED_FWD: ce.tiled_fwd_launches,
            NARROW: attn.narrow_launches,
            NARROW_BWD: attn.narrow_bwd_launches,
            TOPK_TILED: topk.tiled_launches}


def with_narrow(expected):
    """`expected` with every K1 and K2 launch on the narrow f32 kernels too
    (an f32 path of the main model: its heads are the tuned ones)."""
    expected[NARROW] = expected[attn.KERNEL]
    expected[NARROW_BWD] = expected[attn.KERNEL_BWD]
    return expected


def check_launches(path, got, expected):
    print(f"[{path}] launches {json.dumps(got)} (expected "
          f"{json.dumps(expected)})")
    if got != expected:
        raise AssertionError(f"{path} path launched {got}, expected "
                             f"{expected}")


@contextlib.contextmanager
def stderr_copy():
    """Yields a StringIO that receives what the block writes to stderr;
    the text goes on to stderr after the block."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            yield buf
    finally:
        sys.stderr.write(buf.getvalue())


VANILLA = ("--variant", "transformer", "--params-pkl", PARAMS)


def phase_serve(tag, flags, seed, batches, bs, per_call, model=VANILLA,
                width=2, dtype="bfloat16"):
    """One serving path through `cli evaluate` in `dtype`, 19 SNRs (`model`:
    the variant and where its weights come from; the vanilla transceiver's
    trained weights by default): the launch counts must equal `per_call`
    times the decode calls; the table 19 rows of `width` finite values,
    each BLEU in [0, 1] (a sweep's rows [snr, BLEU]; an attack table's
    [snr, clean BLEU, attacked BLEU, loss clean, loss attacked]). ->
    (launch counts, steady seq/s: the fastest call's, the CLI's result,
    what it wrote to stderr)."""
    reset_launches()
    t0 = time.perf_counter()
    with stderr_copy() as err:
        res = cli.main(["evaluate", *model, *flags, "--dtype", dtype,
                        "--bs", str(bs), "--eval-batches", str(batches),
                        "--seed", str(seed), "--snr-lo", str(SNRS[0]),
                        "--snr-hi", str(SNRS[-1]), "--device", "cuda",
                        "--log-save-path", f"log/chip_smoke/{tag}"])
    wall = time.perf_counter() - t0
    got = launches()
    secs = res["decode_seconds"]
    check_launches(tag, got, {name: n * len(secs)
                              for name, n in per_call.items()})
    table = res["table"]
    if len(table) != len(SNRS) or [r[0] for r in table] != SNRS or not all(
            len(r) == width and all(math.isfinite(x) for x in r)
            and all(0.0 <= x <= 1.0 for x in r[1:3 if width == 5 else 2])
            for r in table):
        raise AssertionError(f"{tag}: bad table {table}")
    if width < 5:
        print(f"[{tag}] BLEU-1" + ("" if width == 2 else ", similarity")
              + " " + " ".join(f"{r[0]:.0f}dB=" + "/".join(
                  f"{x:.4f}" for x in r[1:]) for r in table))
    else:
        print(f"[{tag}] SNR: BLEU-1 clean/attacked, loss clean/attacked: "
              + "; ".join(f"{r[0]:.0f}dB {r[1]:.4f}/{r[2]:.4f} "
                          f"{r[3]:.3f}/{r[4]:.3f}" for r in table))
    per_call_seqs = res["sequences"] / len(secs)
    steady = per_call_seqs / min(secs)
    print(f"[{tag}] {res['sequences']} sequences in {len(secs)} decode "
          f"calls: call seconds {secs}; {res['sequences'] / sum(secs):.1f} "
          f"seq/s over all calls, {steady:.1f} seq/s in the fastest; wall "
          f"{wall:.2f} s")
    return got, steady, res, err.getvalue()


def phase_serving(seed, batches, bs):
    """The three serving paths (full-prefix greedy, KV greedy, KV beam);
    -> their launch counts by path."""
    cfg = Config()
    none = {name: 0 for name in COUNTERS}
    # full prefix: the encoder's self-attention per layer, then the
    # decoder's self and cross per layer at each of max_length steps
    full = dict(none, **{attn.KERNEL: cfg.encoder_num_layer
                         + 2 * cfg.decoder_num_layer * cfg.max_length})
    serve, full_rate, *_ = phase_serve("main", ["--eval-mode", "greedy"],
                                       seed, batches, bs, full)
    # KV: only the encoder prefill goes through K1
    encoder = dict(none, **{attn.KERNEL: cfg.encoder_num_layer})
    kv, kv_rate, *_ = phase_serve(
        "kv", ["--eval-mode", "greedy", "--kv-cache"], seed, batches, bs,
        encoder)
    print(f"[kv] steady {kv_rate:.1f} seq/s against the full-prefix "
          f"sweep's {full_rate:.1f} ({kv_rate / full_rate:.2f}x)")
    beam, beam_rate, *_ = phase_serve(
        "beam", ["--eval-mode", "beam", "--beam-size", str(BEAM)], seed, 1,
        bs, dict(encoder, **{topk.KERNEL: cfg.max_length}))
    print(f"[beam] steady {beam_rate:.1f} seq/s")
    return {"serve": serve, "kv": kv, "beam": beam}


def phase_beam100(seed, bs):
    """The beam-100 path: `cli evaluate --eval-mode beam --beam-size
    BEAM100` (KV-cached) on the trained weights in bf16, one batch of bs at
    one SNR (BEAM100_SNR): one decode call of max_length K6 launches at
    N = bs x BEAM100, D = 128, k = BEAM100, every one on the tensor-core
    wide kernel's long path (LONG_LIST), and the encoder's K1; the
    table one row of finite values, its BLEU in [0, 1]. -> (its launch
    counts, the decode call's seconds)."""
    cfg = Config()
    if not topk.uses_long_list(torch.bfloat16, cfg.decoder_d_model,
                               BEAM100, cfg.vocab_size):
        raise AssertionError(f"K6 at k = {BEAM100} is not routed to the "
                             f"long lists")
    expected = {name: 0 for name in COUNTERS}
    expected.update({attn.KERNEL: cfg.encoder_num_layer,
                     topk.KERNEL: cfg.max_length,
                     WIDE[topk.KERNEL]: cfg.max_length,
                     LONG_LIST: cfg.max_length})
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["evaluate", *VANILLA, "--eval-mode", "beam",
                    "--beam-size", str(BEAM100), "--dtype", "bfloat16",
                    "--bs", str(bs), "--eval-batches", "1", "--seed",
                    str(seed), "--snr-lo", str(BEAM100_SNR), "--snr-hi",
                    str(BEAM100_SNR), "--device", "cuda",
                    "--log-save-path", "log/chip_smoke/beam100"])
    wall = time.perf_counter() - t0
    got = launches()
    check_launches("beam100", got, expected)
    table, secs = res["table"], res["decode_seconds"]
    if len(table) != 1 or table[0][0] != BEAM100_SNR or not all(
            math.isfinite(x) for x in table[0]) \
            or not 0.0 <= table[0][1] <= 1.0 or len(secs) != 1:
        raise AssertionError(f"beam100: bad table {table} or calls {secs}")
    print(f"[beam100] beam {BEAM100}, {res['sequences']} sequences at "
          f"{BEAM100_SNR} dB: BLEU-1 {table[0][1]:.4f}; the decode call "
          f"{secs[0]:.3f} s; wall {wall:.2f} s")
    return got, secs[0]


def phase_train(seed, epochs, bs, variant="transformer",
                checkpoint="log/chip_smoke/ckpt", extra=(), tag=None,
                wide=(), k1_passes=1, sub=(), dtype="bfloat16"):
    """A training path: `cli train --variant <variant>` (and `extra`
    flags) at full width in `dtype` from a random init on the synthetic set,
    the params saved under `checkpoint`, through the default path (SCAN_STEPS
    steps a call: replays of one captured CUDA graph of the step). Per step
    the vanilla transceiver launches K1 and K2 once per attention, the star
    one K5 once per cycle of its encoder and its decoder; both K3 and K4
    once, on the routes of the decoder's width in `dtype` (`ce_routes`);
    every launch of the kernels in `wide` on their wide kernels; K1
    `k1_passes` times per attention (2 with --remat: each layer's forward
    runs again in the backward); for each (counter, kernel) of `sub`, every
    launch of the kernel counted in the counter too (CLUSTER: the cluster
    K2; TILED, TILED_BWD: the tiled K1 and K2; NARROW, NARROW_BWD: the
    narrow f32 K1 and K2)."""
    tag = tag or ("train" if variant == "transformer"
                  else f"{variant}_train")
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["train", "--variant", variant, "--train-mode",
                    "plain", "--dtype", dtype, "--bs", str(bs),
                    "--epochs", str(epochs), "--seed", str(seed),
                    "--device", "cuda", "--log-every", "64",
                    "--log-save-path", f"log/chip_smoke/{tag}",
                    "--checkpoint-path", checkpoint, *extra])
    wall = time.perf_counter() - t0
    got = launches()
    if res["path"] != f"scan{SCAN_STEPS}":
        raise AssertionError(f"{tag}: cli train ran path {res['path']}, "
                             f"not the default scan{SCAN_STEPS}")
    cfg = Config()
    n = res["steps"]
    d = (int(extra[list(extra).index("--decoder-d-model") + 1])
         if "--decoder-d-model" in extra else cfg.decoder_d_model)
    expected = {name: 0 for name in COUNTERS}
    expected.update(ce_routes(dtype, d, n, n))
    if variant == "transformer":
        per_step = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
        expected.update({attn.KERNEL: k1_passes * per_step * n,
                         attn.KERNEL_BWD: per_step * n})
    else:
        expected[star.KERNEL] = 2 * cfg.cycle_num * n
    for kernel in wide:
        expected[WIDE[kernel]] = expected[kernel]
    for counter, kernel in sub:
        expected[counter] = expected[kernel]
    check_launches(tag, got, expected)
    losses = res["losses"]
    first, last = losses[:20].mean().item(), losses[-20:].mean().item()
    print(f"[{tag}] path {res['path']}: {n} steps in {epochs} epochs; loss "
          f"first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; mean of the first 20 "
          f"{first:.4f}, of the last 20 {last:.4f}")
    if len(losses) != n or not torch.isfinite(losses).all():
        raise AssertionError("a train loss is not finite")
    if not last < first:
        raise AssertionError(f"the loss did not fall: {first} -> {last}")
    per_epoch = n // epochs
    steady = res["epoch_seconds"][1:] or res["epoch_seconds"]
    ms_step = sum(steady) / len(steady) / per_epoch * 1e3
    rate = sum(res["sents_per_sec"][1:] or res["sents_per_sec"]) \
        / len(steady)
    print(f"[{tag}] epoch seconds {res['epoch_seconds']}; steady (epochs "
          f"after the first) {ms_step:.3f} ms/step, {rate:.1f} sentences/s;"
          f" first epoch {res['sents_per_sec'][0]:.1f} sentences/s; wall "
          f"{wall:.2f} s")
    return got, {"ms_per_step": ms_step, "sents_per_sec": rate,
                 "steps": n, "loss_first20": first, "loss_last20": last}


def _train_batch(cfg, seed):
    inp, _ = next(iter(load_train_dataset(cfg, seed)))
    return torch.from_numpy(inp).to("cuda", torch.long)


def variant_model(cfg, variant, plain=False):
    """The transceiver of `variant` through the kernels, or through their
    plain versions when `plain`."""
    if not is_star(variant):
        return make_model(cfg, variant, attention=attn.plain_attention
                          if plain else attn.fused_attention)
    return make_model(cfg, variant, satellite=star.plain_satellite if plain
                      else star.satellite_attention)


def phase_step_parity(seed, bs, variant="transformer", widths=(),
                      counted=()):
    """One f32 train step at full width through the kernels and one
    through the plain versions: the same weights (init from `seed`),
    noise and dropout masks (one generator seed, drawn in the same
    order). A star step scores the un-shifted target. `widths`: the
    model's CLI width flags (WIDE_HEADS_WIDTHS: the wide-heads model);
    `counted`: the sub-counters that step must launch too (its wide and
    tiled K1/K2 kernels'; K3's and K4's follow from the width,
    `ce_routes`)."""
    is_star = variant != "transformer"
    cfg = Config(dtype="float32", bs=bs, seq_len=default_seq_len(variant),
                 **width_fields(widths))
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    out = []
    for plain in (False, True):
        model = steps.init_params(variant_model(cfg, variant, plain), seed)
        model = model.cuda().train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(model, cfg, plain=plain,
                                     full_target=is_star)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        _, loss = step(state, inp, inp, gen, n_std)
        torch.cuda.synchronize()
        out.append((loss.item(), model, launches()))
    (lk, mk, ck), (lp, mp, cp) = out
    trained = (star.KERNEL,) if is_star else (attn.KERNEL, attn.KERNEL_BWD)
    trained += tuple(name for name, k in ce_routes(
        cfg.dtype, cfg.decoder_d_model, 1, 1).items() if k) + tuple(counted)
    if sum(cp.values()) or any(ck[name] == 0 for name in trained) \
            or any(ck[name] for name in COUNTERS if name not in trained):
        raise AssertionError(f"step parity launches: kernels {ck}, plain "
                             f"{cp}")
    worst, worst_name = 0.0, ""
    for (name, a), b in zip(mk.named_parameters(), mp.parameters()):
        err = max_err([a.grad], [b.grad], relative=True)
        if err > worst:
            worst, worst_name = err, name
    print(f"[parity] {variant}{' ' + ' '.join(widths) if widths else ''} "
          f"f32 step: loss kernels {lk:.7f} plain "
          f"{lp:.7f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}); worst grad err / max|ref| "
          f"{worst:.2e} ({worst_name}); launches {json.dumps(ck)}")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"f32 step loss {lk} vs plain {lp}")
    if not worst <= 1e-4:
        raise AssertionError(f"f32 step grad {worst_name}: {worst} > 1e-4 "
                             f"of max|ref|")


@contextlib.contextmanager
def tapped(replay=(None, None)):
    """`steps.fgm_normalize` (the train step's), `steps.fgm_perturbation`
    (the eval steps'), `greedy.fgm_normalize` (the attacked and GAN greedy
    decodes') and `torch.relu` wrapped for the block: the
    perturbations they return and every ReLU input are appended to the
    yielded (perturbations, ReLU inputs) lists. `replay`, such a pair from
    another run (or None in either place): the perturbations returned are
    that run's, and each ReLU keeps the elements that run's kept (input
    above 0), in call order."""
    perts, inputs = [], []
    normalize, perturb = steps.fgm_normalize, steps.fgm_perturbation
    greedy_normalize = greedy.fgm_normalize
    relu = torch.relu
    given_r = iter(replay[0] or ())
    given_x = iter(replay[1] or ())

    def fgm(grad, epsilon=1.0, group=None):
        r = normalize(grad, epsilon, group)
        if replay[0] is not None:
            r = next(given_r)
        perts.append(r)
        return r

    def fgm_perturbation(loss_of, x, epsilon=1.0):
        r, loss = perturb(loss_of, x, epsilon)
        if replay[0] is not None:
            r = next(given_r)
        perts.append(r)
        return r, loss

    def relu_tap(x):
        inputs.append(x.detach())
        if replay[1] is not None:
            return x * (next(given_x) > 0).to(x.dtype)
        return relu(x)

    steps.fgm_normalize, steps.fgm_perturbation = fgm, fgm_perturbation
    greedy.fgm_normalize = fgm
    torch.relu = relu_tap
    try:
        yield perts, inputs
    finally:
        steps.fgm_normalize, steps.fgm_perturbation = normalize, perturb
        greedy.fgm_normalize = greedy_normalize
        torch.relu = relu


def phase_attack_step_parity(seed, bs):
    """One f32 FGM step (adv_weight 0.5, PNR 0 dB) at full width through
    the kernels and one through the plain versions, from the same weights
    (init from `seed`), draws and dropout masks: `attack_step_launches`
    through the kernels (K4 dh-only in phase 1), none through the plain
    versions; both losses within rtol 1e-5; phase 1's perturbation and
    every ReLU input within 1e-4 of their largest element.

    The gradients are not continuous where a ReLU input sits at its kink,
    and at this width some inputs lie within the paths' f32 difference of
    0: their sign, and so the gradient through them, differs between the
    paths (printed: how many, the gradient gap they make, and the gap a
    perturbation scaled by 1 + 1e-5 N(0, 1) makes in the plain step). So
    the gradients through the kernels are held within 1e-4 of their
    largest to the plain step that takes the kernel run's perturbation and
    ReLU decisions (its losses within rtol 1e-5 too), and on each path's
    own perturbation and decisions within 3 times that jitter's gap. Both
    paths must have run at least one ReLU, or the replay held nothing."""
    cfg = Config(dtype="float32", bs=bs)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))

    def run(plain, replay=(None, None)):
        model = steps.init_params(variant_model(cfg, "transformer", plain),
                                  seed).cuda().train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_attack_step(model, cfg, adv_weight=0.5,
                                            plain=plain)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        with tapped(replay) as taps:
            _, losses = step(state, inp, inp, gen, 0.0, n_std, 1.0)
        torch.cuda.synchronize()
        return [x.item() for x in losses], model, launches(), taps

    def grad_gap(a, b):
        return max((max_err([p.grad], [q.grad], relative=True), name)
                   for (name, p), q in zip(a.named_parameters(),
                                           b.parameters()))

    lk, mk, ck, (rk, xk) = run(False)
    lp, mp, cp, (rp, xp) = run(True)
    ls, ms, _, _ = run(True, (rk, xk))
    noise = torch.randn(rp[0].shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    _, mj, _, _ = run(True, ([rp[0] * (1.0 + 1e-5 * noise)], None))
    want = {name: 0 for name in COUNTERS}
    want.update(attack_step_launches(cfg, 0.5))
    check_launches("f32 attack step", ck, with_narrow(want))
    if sum(cp.values()):
        raise AssertionError(f"the plain attack step launched {cp}")
    if not (len(xk) == len(xp) > 0 and len(rk) == 1):
        raise AssertionError(f"{len(xk)} and {len(xp)} ReLU calls, "
                             f"{len(rk)} perturbations")
    r_err = max_err(rk, rp, relative=True)
    x_err = max(max_err([a], [b], relative=True) for a, b in zip(xk, xp))
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xk, xp))
    elements = sum(a.numel() for a in xk)
    rel = [abs(a - b) / abs(b) for a, b in zip(lk + lk, lp + ls)]
    same, own, jitter = grad_gap(mk, ms), grad_gap(mk, mp), grad_gap(mp, mj)
    print(f"[parity] f32 attack step: losses (clean, adversarial) kernels "
          f"{lk}, plain {lp}, plain on the kernel run's perturbation and "
          f"ReLU decisions {ls} (rel {', '.join(f'{r:.2e}' for r in rel)}); "
          f"perturbation err / max|ref| {r_err:.2e}; {len(xk)} ReLU calls: "
          f"inputs err / max|ref| {x_err:.2e}, {flips} of {elements} "
          f"change sign between the paths; worst grad err / max|ref| on the "
          f"same perturbation and ReLU decisions {same[0]:.2e} ({same[1]}), "
          f"on each path's own {own[0]:.2e} ({own[1]}); the plain step's "
          f"with its perturbation scaled by 1 + 1e-5 N(0, 1) "
          f"{jitter[0]:.2e} ({jitter[1]})")
    if not all(r <= 1e-5 for r in rel):
        raise AssertionError(f"f32 attack step losses {lk} vs plain {lp}, "
                             f"{ls}")
    if not (r_err <= 1e-4 and x_err <= 1e-4):
        raise AssertionError(f"f32 attack step: perturbation err {r_err}, "
                             f"ReLU inputs err {x_err} > 1e-4 of max|ref|")
    if not same[0] <= 1e-4:
        raise AssertionError(f"f32 attack step grad {same[1]}: {same[0]} > "
                             f"1e-4 of max|ref|")
    if not own[0] <= 3 * jitter[0]:
        raise AssertionError(f"f32 attack step grad on each path's own "
                             f"{own[1]}: {own[0]} > 3 x the plain step's "
                             f"jitter gap {jitter[0]}")


def same_ids(tag, got, want):
    same = torch.equal(got, want)
    print(f"[f32] {tag}: {same} ({(got != want).sum().item()} of "
          f"{got.numel()} ids differ)")
    if not same:
        raise AssertionError(f"f32 {tag}: the ids differ")


def phase_f32_ids(seed, bs):
    """One batch at f32 on the card, all 19 SNRs, same weights and noise:
    the full-prefix greedy sweep through K1 and through its plain version;
    the KV sweep against the full-prefix one; the beam sweep scored by K6
    (every launch on the tuned kernel's f32 tile) and by its plain version;
    the KV beam against the full-prefix beam at three SNRs. -> the launch
    counts of the beam sweep through K6 (the f32_beam_sweep path)."""
    params = load_params_pickle(PARAMS)
    cfg = Config(dtype="float32", bs=bs, tie_embeddings=is_tied(params))
    model_k, model_p = (
        load_into(make_model(cfg, attention=a), params).cuda().eval()
        for a in (attn.fused_attention, attn.attention_fwd_reference))
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    n_stds = torch.tensor([SNR_to_noise(s) for s in SNRS],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((len(SNRS), bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    args = (inp, 0.0, n_stds, noise)
    ids_full = make_greedy_decode_sweep(model_k, cfg)(*args)
    same_ids("greedy, kernel vs plain attention", ids_full,
             make_greedy_decode_sweep(model_p, cfg)(*args))
    same_ids("greedy, KV vs full prefix",
             make_greedy_decode_kv_sweep(model_k, cfg)(*args), ids_full)

    reset_launches()
    beam_k = make_beam_decode_sweep(model_k, cfg, BEAM)(*args)
    counts = launches()
    beam_p = make_beam_decode_sweep(
        model_k, cfg, BEAM, topk=topk.topk_logits_reference)(*args)
    k6 = counts[topk.KERNEL]
    if (k6, counts[TOPK_TILED], topk.launches) != (cfg.max_length,) * 3:
        raise AssertionError(f"beam sweep: {k6} K6 launches with K6 "
                             f"({counts[TOPK_TILED]} on the f32 tile), "
                             f"{topk.launches - k6} with the plain scorer")
    same_ids(f"beam sweep ({len(SNRS)} x {bs} x {BEAM} rows), K6 vs plain "
             f"scorer", beam_k, beam_p)
    kv, full = (make(model_k, cfg, BEAM) for make in (make_beam_decode_kv,
                                                      make_beam_decode))
    for s in (0, 9, 18):
        a = (inp, 0.0, float(n_stds[s]), noise[s])
        same_ids(f"beam at {SNRS[s]} dB, KV vs full prefix", kv(*a),
                 full(*a))
    return counts


def phase_star_serving(seed, batches, bs):
    """The star one-shot sweep through `cli evaluate --variant star` with
    no --params-pkl: it must load the params the star training phase saved
    (and say so); 16 K5 per call (8 cycles of the encoder on the bs rows, 8
    of the decoder on the 19 x bs rows) and nothing else. -> its launch
    counts."""
    saved = f"{STAR_CKPT}/star_params.pkl"
    per_call = {name: 0 for name in COUNTERS}
    per_call[star.KERNEL] = 2 * Config().cycle_num
    got, rate, res, err = phase_serve(
        "star_serve", ["--eval-mode", "greedy"], seed, batches, bs, per_call,
        model=("--variant", "star", "--checkpoint-path", STAR_CKPT))
    if res["params_path"] != saved or f"params from {saved}" not in err:
        raise AssertionError(f"star_serve: loaded {res['params_path']}, "
                             f"not the trained {saved}")
    print(f"[star_serve] params from {saved}; steady {rate:.1f} seq/s")
    return got


def recorded_logits(model):
    """A list that gets every output of `model.final_projection` (the f32
    vocab logits) from now on."""
    seen, project = [], model.final_projection

    def record(x):
        out = project(x)
        seen.append(out)
        return out

    model.final_projection = record
    return seen


def same_ids_but_near_ties(tag, got, want, got_logits, want_logits):
    """The one-shot ids `got` (K5) against `want` (plain), each the argmax
    of its path's f32 logits. The two paths' logits differ by f32 rounding
    alone, by delta at most, which must be within the f32 tolerance of the
    largest logit; two candidates whose plain logits lie within 2 delta of
    each other may then swap. An id that differs counts as a fault unless
    the plain logits of the two picks are that close; such near-ties are
    counted and printed."""
    delta = (got_logits - want_logits).abs().max().item()
    scale = want_logits.abs().max().item()
    diff = (got != want).reshape(-1)
    picks = want_logits.reshape(diff.numel(), -1)[diff]
    gap = (picks.gather(1, want.reshape(-1)[diff].long()[:, None])
           - picks.gather(1, got.reshape(-1)[diff].long()[:, None]))
    near = int((gap <= 2 * delta).sum().item())
    faults = int(diff.sum().item()) - near
    print(f"[f32] {tag}: {faults == 0 and delta <= TOL[torch.float32] * scale}"
          f" ({int(diff.sum().item())} of {got.numel()} ids differ, {near} "
          f"at near-ties within 2 x {delta:.3g}; logits differ by "
          f"{delta:.3g} of max {scale:.3g})")
    if not delta <= TOL[torch.float32] * scale:
        raise AssertionError(f"f32 {tag}: logits differ by {delta} > "
                             f"{TOL[torch.float32]} x {scale}")
    if faults:
        raise AssertionError(f"f32 {tag}: {faults} ids differ away from a "
                             f"near-tie")


def phase_star_f32_ids(seed, bs):
    """One batch at f32 on the card, all 19 SNRs, same weights and noise:
    the one-shot ids through K5 and through its plain version, for the
    star weights the training phase saved and for a random star_multi
    (flax's initialisers from `seed`); ids may differ only at near-ties of
    the logits (`same_ids_but_near_ties`)."""
    params = load_params_pickle(f"{STAR_CKPT}/star_params.pkl")
    seq_len = default_seq_len("star")
    base = Config(dtype="float32", bs=bs, seq_len=seq_len)
    inp = torch.as_tensor(eval_batches(base.test_save_path, seq_len,
                                       base.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    n_stds = torch.tensor([SNR_to_noise(s) for s in SNRS],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((len(SNRS), bs, seq_len, base.channel_dim),
                        generator=gen, device="cuda")
    for variant in ("star", "star_multi"):
        cfg = base.replace(tie_embeddings=is_tied(params)) \
            if variant == "star" else base
        ids, logits = [], []
        for plain in (False, True):
            model = variant_model(cfg, variant, plain)
            model = load_into(model, params) if variant == "star" \
                else steps.init_params(model, seed)
            model = model.cuda().eval()
            seen = recorded_logits(model)
            sweep = make_greedy_decode_sweep(model, cfg, "oneshot")
            reset_launches()
            ids.append(sweep(inp, 0.0, n_stds, noise))
            torch.cuda.synchronize()
            logits.append(seen[0][:, :ids[-1].shape[-1]])
            layers = 1 if variant == "star" else cfg.encoder_num_layer
            want = 0 if plain else 2 * layers * cfg.cycle_num
            if launches() != dict({n: 0 for n in COUNTERS},
                                  **{star.KERNEL: want}):
                raise AssertionError(f"{variant} one-shot sweep (plain "
                                     f"{plain}): launches {launches()}")
        same_ids_but_near_ties(
            f"{variant} one-shot sweep ({len(SNRS)} x {bs} rows, "
            f"{2 * layers * cfg.cycle_num} K5 per call), K5 vs plain",
            *ids, *logits)
        del logits


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profiled(tag, fn):
    """Run `fn` (synchronized) under torch.profiler and print its wall
    time, device time by kernel, and the share of the wall time in which
    the device ran no kernel. Returns the rows by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events only; a record_function range mirrored onto the
    # device (Optimizer.step, say) is an annotation, not a kernel
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"[profile] {tag}: the profiler recorded no device activity: "
              f"device time not measured")
        return []
    by_name = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + dur, cnt + 1)
    total = sum(t for t, _ in by_name.values())
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    print(f"[profile] {tag}: wall {wall_us / 1e3:.2f} ms, kernels "
          f"{len(kernels)}, device busy {busy / 1e3:.2f} ms "
          f"(idle share {1 - busy / wall_us:.3f}), kernel time "
          f"{total / 1e3:.2f} ms")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (tot, cnt) in rows[:20]:
        print(f"[profile] {tag}: {tot / total:6.1%} {tot / 1e3:8.3f} ms "
              f"{cnt:6d} x {tot / cnt:8.2f} us  {name[:90]}")
    return rows


def phase_profile(seed, bs):
    """One bf16 call (19 SNRs x bs rows) of the full-prefix sweep and of the
    KV sweep, and one bf16 beam call (bs rows x 4 beams at one SNR) of the
    trained weights; one bf16 call of the star one-shot sweep of the star
    weights the training phase saved; and one bf16 train step at full width
    of the vanilla and of the star transceiver; each after a warm-up."""
    cfg, model = cli.load_model(Config(bs=bs), PARAMS, torch.device("cuda"))
    sweep = make_greedy_decode_sweep(model, cfg)
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    n_stds = torch.tensor([SNR_to_noise(s) for s in SNRS],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((len(SNRS), bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    for tag, fn in (("one sweep call", sweep),
                    ("one KV sweep call", make_greedy_decode_kv_sweep(model,
                                                                      cfg))):
        fn(inp, 0.0, n_stds, noise)
        torch.cuda.synchronize()
        profiled(tag, lambda: fn(inp, 0.0, n_stds, noise))
    beam = make_beam_decode_kv(model, cfg, BEAM)
    args = (inp, 0.0, float(n_stds[9]), noise[9])
    beam(*args)
    torch.cuda.synchronize()
    profiled("one beam call", lambda: beam(*args))

    seq_len = default_seq_len("star")
    cfg, model = cli.load_model(Config(bs=bs, seq_len=seq_len),
                                f"{STAR_CKPT}/star_params.pkl",
                                torch.device("cuda"), variant="star")
    sweep = make_greedy_decode_sweep(model, cfg, "oneshot")
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    noise = torch.randn((len(SNRS), bs, seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    sweep(inp, 0.0, n_stds, noise)
    torch.cuda.synchronize()
    rows = profiled("one star sweep call",
                    lambda: sweep(inp, 0.0, n_stds, noise))
    # K5 reads the ring unstacked: no roll, and the concatenations left are
    # the relay's
    rolls, cats = (sum(c for name, (_, c) in rows if word in name)
                   for word in ("roll_cuda_kernel", "CatArrayBatchedCopy"))
    print(f"[profile] one star sweep call: {rolls} roll kernels, {cats} "
          f"concatenation kernels")
    if rows and rolls:
        raise AssertionError(f"the star sweep call ran {rolls} roll kernels")

    for variant in ("transformer", "star"):
        profile_train_step(variant, seed, bs, gen)
    profile_attack(seed, bs, gen)
    profile_gan(seed, bs, gen)
    profile_mine(seed, bs, gen)


def profile_mine(seed, bs, gen):
    """One bf16 MINE step at full width from a random init after a
    warm-up, timed without the profiler, then profiled (kernels, device
    time, idle share)."""
    cfg = Config(bs=bs)
    model = steps.init_params(make_model(cfg), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    mine, mine_state = mine_steps.create_mine_state(cfg, seed, device="cuda")
    step = mine_steps.make_mine_train_step(model, mine, cfg)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))

    def fn():
        return step(state, mine_state, inp, inp, gen, n_std)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    print(f"[profile] one MINE train step without the profiler: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    profiled("one MINE train step", fn)


def profile_gan(seed, bs, gen):
    """One bf16 GAN train step at full width from a random init, and one
    bf16 GAN teacher-forced call and one greedy_gan call (6 dB, bs rows) on
    the weights the GAN training phase saved; each after a warm-up, timed
    without the profiler, then profiled."""
    cfg = Config(bs=bs)
    model = steps.init_params(make_model(cfg, "gan"), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = gan_steps.make_gan_train_step(model, cfg)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    cfg_e, model_e = cli.load_model(Config(bs=bs),
                                    f"{GAN_CKPT}/gan_params.pkl",
                                    torch.device("cuda"), variant="gan")
    tf_step = gan_steps.make_gan_eval_step(model_e, cfg_e)
    decode = make_greedy_decode_gan(model_e, cfg_e)
    batch = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                         cfg.vocab_size, bs, 1, seed)[0],
                            dtype=torch.long, device="cuda")
    noise = torch.randn((2, bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    for tag, fn in (
            ("one GAN train step",
             lambda: step(state, inp, inp, gen, n_std)),
            ("one GAN teacher-forced call",
             lambda: tf_step(batch, batch, gen, 0.0, SNR_to_noise(6), 1.0)),
            ("one greedy_gan call",
             lambda: decode(batch, 0.0, SNR_to_noise(6), noise, None,
                            1.0))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"[profile] {tag} without the profiler: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        profiled(tag, fn)


def profile_attack(seed, bs, gen):
    """One bf16 FGM train step (adv_weight 0.5, PNR 0 dB) at full width
    from a random init, and one bf16 teacher-forced FGM call on the
    trained weights at 6 dB; each after a warm-up, timed without the
    profiler, then profiled."""
    cfg = Config(bs=bs)
    model = steps.init_params(make_model(cfg), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_attack_step(model, cfg, adv_weight=0.5)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    cfg_e, model_e = cli.load_model(Config(bs=bs), PARAMS,
                                    torch.device("cuda"))
    tf_step = steps.make_eval_step(model_e, cfg_e)
    batch = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                         cfg.vocab_size, bs, 1, seed)[0],
                            dtype=torch.long, device="cuda")
    for tag, fn in (
            ("one attack train step",
             lambda: step(state, inp, inp, gen, 0.0, n_std, 1.0)),
            ("one teacher-forced FGM call",
             lambda: tf_step(batch, batch, gen, 0.0, SNR_to_noise(6), 1.0))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"[profile] {tag} without the profiler: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        rows = profiled(tag, fn)
        total = sum(t for _, (t, _) in rows)
        dh = sum(t for name, (t, _) in rows if "ce_dh_" in name)
        dw = sum(c for name, (_, c) in rows if "ce_dw_" in name)
        print(f"[profile] {tag}: K4's dh kernels {dh / 1e3:.3f} ms "
              f"({dh / total if total else 0.0:.1%} of the device time), "
              f"{dw} dW kernels")


def profile_train_step(variant, seed, bs, gen):
    """One bf16 train step of `variant` at full width after a warm-up,
    timed without the profiler, then profiled."""
    is_star = variant != "transformer"
    cfg = Config(bs=bs, seq_len=default_seq_len(variant))
    model = steps.init_params(make_model(cfg, variant), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(model, cfg, full_target=is_star)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    for _ in range(3):
        step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    tag = "one star train step" if is_star else "one train step"
    print(f"[profile] {tag} without the profiler: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    rows = profiled(tag, lambda: step(state, inp, inp, gen, n_std))
    total = sum(t for _, (t, _) in rows)
    for kernel, prefixes in ((ce.KERNEL_FWD, ("ce_fwd_",)),
                             (ce.KERNEL_BWD, ("ce_dh_", "ce_dw_"))):
        # kernel names as the profiler reports them, e.g.
        # "(anonymous namespace)::ce_dh_wgmma_kernel<2>(...)"
        mine = [(name, t, c) for name, (t, c) in rows
                if any(p in name for p in prefixes)]
        t = sum(t for _, t, _ in mine)
        print(f"[profile] {tag}: {kernel} {t / 1e3:.3f} ms in "
              f"{sum(c for *_, c in mine)} kernels, "
              f"{t / total if total else 0.0:.1%} of the step's device time")


def _sum_counts(*counts):
    return {name: sum(c[name] for c in counts) for name in COUNTERS}


def phase_fading(seed, batches, bs):
    """The serving paths through fading channels on the trained weights:
    the full-prefix greedy sweep through Rayleigh, the KV sweep through
    Rician with the MMSE equalizer, and the KV beam through Rician (one
    batch); each call launches what its AWGN path's call launches (fading
    adds no kernel). -> their launch counts summed."""
    cfg = Config()
    none = {name: 0 for name in COUNTERS}
    full = dict(none, **{attn.KERNEL: cfg.encoder_num_layer
                         + 2 * cfg.decoder_num_layer * cfg.max_length})
    encoder = dict(none, **{attn.KERNEL: cfg.encoder_num_layer})
    greedy, *_ = phase_serve(
        "fading_greedy", ["--eval-mode", "greedy", "--channel", "Rayleigh"],
        seed, batches, bs, full)
    kv, *_ = phase_serve(
        "fading_kv", ["--eval-mode", "greedy", "--kv-cache", "--channel",
                      "Rician", "--equalizer", "MMSE"], seed, batches, bs,
        encoder)
    beam, *_ = phase_serve(
        "fading_beam", ["--eval-mode", "beam", "--beam-size", str(BEAM),
                        "--channel", "Rician"], seed, 1, bs,
        dict(encoder, **{topk.KERNEL: cfg.max_length}))
    return _sum_counts(greedy, kv, beam)


def phase_fading_f32_ids(seed, bs):
    """One batch at f32, all 19 SNRs through a Rayleigh channel, the same
    weights, noise and fades: the full-prefix greedy ids through K1 equal
    the plain version's."""
    params = load_params_pickle(PARAMS)
    cfg = Config(dtype="float32", bs=bs, tie_embeddings=is_tied(params),
                 channel="Rayleigh")
    model_k, model_p = (
        load_into(make_model(cfg, attention=a), params).cuda().eval()
        for a in (attn.fused_attention, attn.attention_fwd_reference))
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    n_stds = torch.tensor([SNR_to_noise(s) for s in SNRS],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise, fade = draw_channel(gen, (bs, cfg.seq_len, cfg.channel_dim),
                               "Rayleigh", lead=(len(SNRS),))
    args = (inp, 0.0, n_stds, noise, fade)
    same_ids("Rayleigh greedy sweep, kernel vs plain attention",
             make_greedy_decode_sweep(model_k, cfg)(*args),
             make_greedy_decode_sweep(model_p, cfg)(*args))


def attack_step_launches(cfg, adv_weight):
    """K1-K4 launches of one FGM train step of the vanilla transceiver.
    Phase 1: a forward (K1 per attention, K3) and the backward to the
    received y alone (K4 dh-only; K2 per attention on the path to y, which
    leaves out decoder layer 1's self-attention). Phase 2: one forward and
    backward, two with adv_weight < 1."""
    per_forward = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
    passes = 1 if adv_weight >= 1.0 else 2
    return {attn.KERNEL: per_forward * (1 + passes),
            attn.KERNEL_BWD: 2 * cfg.decoder_num_layer - 1
            + per_forward * passes,
            **ce_routes(cfg.dtype, cfg.decoder_d_model, 1 + passes,
                        1 + passes, 1)}


# epochs of the attack training phase: one epoch is 64 steps at bs 64
ATTACK_EPOCHS = 1


def phase_attack_train(seed, epochs, bs, adv_weight=0.5):
    """`cli train --train-mode attack --adv-weight 0.5 --pnr-db 0` at full
    width in bf16 from a random init on the synthetic set: the launch
    counts are `attack_step_launches` per step; every clean and adversarial
    loss finite, and the mean of the last 16 adversarial losses below that
    of the first 16."""
    tag = "attack_train"
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "attack", "--adv-weight", str(adv_weight), "--pnr-db",
                    "0", "--dtype", "bfloat16", "--bs", str(bs), "--epochs",
                    str(epochs), "--seed", str(seed), "--device", "cuda",
                    "--log-every", "64", "--log-save-path",
                    f"log/chip_smoke/{tag}", "--checkpoint-path",
                    f"log/chip_smoke/{tag}_ckpt"])
    wall = time.perf_counter() - t0
    got = launches()
    n = res["steps"]
    expected = {name: 0 for name in COUNTERS}
    expected.update({name: k * n for name, k in
                     attack_step_launches(Config(), adv_weight).items()})
    check_launches(tag, got, expected)
    adv, clean = res["losses"], res["clean_losses"]
    if len(adv) != n or len(clean) != n or not (
            torch.isfinite(adv).all() and torch.isfinite(clean).all()):
        raise AssertionError(f"{tag}: a loss is not finite")
    first, last = adv[:16].mean().item(), adv[-16:].mean().item()
    steady = res["epoch_seconds"][1:] or res["epoch_seconds"]
    ms_step = sum(steady) / len(steady) / (n // epochs) * 1e3
    print(f"[{tag}] {n} steps; adversarial loss mean of the first 16 "
          f"{first:.4f}, of the last 16 {last:.4f}; clean loss first "
          f"{clean[0]:.4f} last {clean[-1]:.4f}; epoch seconds "
          f"{res['epoch_seconds']}; steady {ms_step:.3f} ms/step; wall "
          f"{wall:.2f} s")
    if not last < first:
        raise AssertionError(f"{tag}: the adversarial loss did not fall: "
                             f"{first} -> {last}")
    return got


def eval_step_launches(cfg, mode, iters=10):
    """K1-K2 launches of one teacher-forced attack call (`mode`
    teacher_forced or pgd) or one attacked greedy decode (greedy_attack) of
    the vanilla transceiver: the encoder once; the gradient's decoder pass
    and its backward (K2 per attention on the path to the channel, which
    leaves out decoder layer 1's self-attention); then the clean and the
    attacked decoder passes, PGD's bisection passes and its re-evaluation,
    or the greedy decoder's max_length full-prefix steps."""
    dec = 2 * cfg.decoder_num_layer
    passes = {"teacher_forced": 2, "pgd": 3 + iters,
              "greedy_attack": cfg.max_length}[mode]
    return {attn.KERNEL: cfg.encoder_num_layer + dec * (1 + passes),
            attn.KERNEL_BWD: dec - 1}


def phase_attack_eval(seed, batches, bs):
    """The attack evaluations through `cli evaluate` on the trained weights
    in bf16 at PNR 0 dB: the teacher-forced FGM table, the PGD table (every
    eps* in [0, 1]) and the attacked greedy decode through AWGN, the FGM
    table again through Rayleigh, and the star FGM table on the star
    weights the star training phase saved (K5 only: 8 cycles of the
    encoder, then three decoder passes of 8). -> their launch counts
    summed."""
    cfg = Config()
    none = {name: 0 for name in COUNTERS}
    counts = []
    for tag, flags in (("attack_tf", ["--eval-mode", "teacher_forced"]),
                       ("attack_pgd", ["--eval-mode", "pgd"]),
                       ("attack_greedy", ["--eval-mode", "greedy_attack"]),
                       ("attack_tf_rayleigh", ["--eval-mode",
                                               "teacher_forced", "--channel",
                                               "Rayleigh"])):
        mode = flags[1]
        got, _, res, _ = phase_serve(
            tag, flags + ["--pnr-db", "0"], seed, batches, bs,
            dict(none, **eval_step_launches(cfg, mode)),
            width=2 if mode == "greedy_attack" else 5)
        if mode == "pgd":
            eps = res["eps_star"]
            print(f"[{tag}] eps* over {len(eps)} calls: min {min(eps):.4f} "
                  f"max {max(eps):.4f}")
            if len(eps) != len(res["decode_seconds"]) or not all(
                    0.0 <= e <= 1.0 for e in eps):
                raise AssertionError(f"{tag}: eps* {eps}")
        counts.append(got)
    got, *_ = phase_serve(
        "attack_tf_star", ["--eval-mode", "teacher_forced", "--pnr-db", "0"],
        seed, batches, bs, dict(none, **{star.KERNEL: 4 * cfg.cycle_num}),
        model=("--variant", "star", "--checkpoint-path", STAR_CKPT), width=5)
    counts.append(got)
    return _sum_counts(*counts)


def phase_attack_f32(seed, bs):
    """One f32 teacher-forced FGM call on the trained weights through K1/K2
    and through their plain versions, the same draws: both losses within
    rtol 1e-5; the clean ids equal but for near-ties of the logits
    (`same_ids_but_near_ties`). The perturbation comes from a gradient,
    which is not continuous where a ReLU input sits at its kink, and it
    enters the channel scaled to the noise's power, so its f32 rounding
    reaches the attacked logits enlarged (printed: how many ReLU inputs
    change sign between the paths, and what the perturbation and the
    attacked logits differ by). So the perturbation through the kernels is
    held within 1e-4 of its largest to the plain call that takes the
    kernel call's ReLU decisions, and the attacked ids as the clean ones
    to the plain call that also takes its perturbation (the losses of
    both within rtol 1e-5). On each path's own perturbation the attacked
    logits are held within 3 times what the plain call's own move by when
    its perturbation is scaled by 1 + 1e-5 N(0, 1). Both paths must have
    run at least one ReLU, or the replay held nothing."""
    params = load_params_pickle(PARAMS)
    cfg = Config(dtype="float32", bs=bs, tie_embeddings=is_tied(params))
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    n_std = SNR_to_noise(6)

    def run(plain, replay=(None, None)):
        model = load_into(variant_model(cfg, "transformer", plain),
                          params).cuda().eval()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        with tapped(replay) as taps:
            out = steps.make_eval_step(model, cfg)(inp, inp, gen, 0.0,
                                                   n_std, 1.0)
        torch.cuda.synchronize()
        want = {name: 0 for name in COUNTERS}
        if not plain:
            want = with_narrow(dict(want, **eval_step_launches(
                cfg, "teacher_forced")))
        check_launches(f"f32 teacher-forced (plain {plain})", launches(),
                       want)
        return out, taps

    (ck, ak, clk, alk), (rk, xk) = run(False)
    (cp, ap, clp, alp), (rp, xp) = run(True)
    (cs, as_, _, _), (rs, _) = run(True, (None, xk))
    (ct, at, _, alt), _ = run(True, (rk, xk))
    if not (len(xk) == len(xp) > 0 and len(rk) == len(rp) == 1):
        raise AssertionError(f"{len(xk)} and {len(xp)} ReLU calls, "
                             f"{len(rk)} and {len(rp)} perturbations")
    noise = torch.randn(rp[0].shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed))
    (_, _, _, alj), _ = run(True, ([rp[0] * (1.0 + 1e-5 * noise)], None))
    own_l, jitter_l = max_err([alk], [alp]), max_err([alp], [alj])
    rel = [abs(a.item() - b.item()) / abs(b.item())
           for a, b in ((ck, cp), (ak, ap), (ck, cs), (ak, as_), (ck, ct),
                        (ak, at))]
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xk, xp))
    own_r, same_r = (max_err(rk, r, relative=True) for r in (rp, rs))
    print(f"[f32] teacher-forced FGM call: losses (clean, attacked) kernels "
          f"{ck.item():.7f}, {ak.item():.7f}; plain {cp.item():.7f}, "
          f"{ap.item():.7f}; plain on the kernel call's ReLU decisions "
          f"{cs.item():.7f}, {as_.item():.7f}, and its perturbation "
          f"{ct.item():.7f}, {at.item():.7f} (rel "
          f"{', '.join(f'{r:.2e}' for r in rel)}); {len(xk)} ReLU calls, "
          f"{flips} inputs change sign between the paths; perturbation err "
          f"/ max|ref| {own_r:.2e} on each path's own decisions, "
          f"{same_r:.2e} on the same; attacked logits differ by "
          f"{own_l:.3g} on each path's own, "
          f"{(alk.argmax(-1) != alp.argmax(-1)).sum().item()} ids; the "
          f"plain call's with its perturbation scaled by 1 + 1e-5 N(0, 1) "
          f"by {jitter_l:.3g}")
    if not all(r <= 1e-5 for r in rel):
        raise AssertionError(f"f32 teacher-forced losses differ: {rel}")
    if not same_r <= 1e-4:
        raise AssertionError(f"f32 teacher-forced perturbation: {same_r} > "
                             f"1e-4 of max|ref|")
    if not own_l <= 3 * jitter_l:
        raise AssertionError(f"f32 teacher-forced attacked logits on each "
                             f"path's own: {own_l} > 3 x the plain call's "
                             f"jitter gap {jitter_l}")
    same_ids_but_near_ties(
        f"teacher-forced clean ids ({bs} x {cfg.seq_len - 1}), K1/K2 vs "
        f"plain", clk.argmax(-1), clp.argmax(-1), clk, clp)
    same_ids_but_near_ties(
        f"teacher-forced attacked ids ({bs} x {cfg.seq_len - 1}), K1/K2 vs "
        f"plain on the same ReLU decisions and perturbation", alk.argmax(-1),
        alt.argmax(-1), alk, alt)


def gan_step_launches(cfg):
    """K1-K4 launches of one GAN train step of the vanilla GAN transceiver
    (fused CE): the forward runs the encoder once and the decoder on both
    branches (K1 per attention, K3 per branch); the backward of CE_r runs
    through branch r and the encoder, that of CE_p through branch p and
    the generator only (K2 per attention on each, K4 per branch)."""
    dec = 2 * cfg.decoder_num_layer
    return {attn.KERNEL: cfg.encoder_num_layer + 2 * dec,
            attn.KERNEL_BWD: cfg.encoder_num_layer + 2 * dec,
            **ce_routes(cfg.dtype, cfg.decoder_d_model, 2, 2)}


def gan_eval_launches(cfg, mode):
    """K1-K2 launches of one GAN evaluation call of the vanilla GAN
    transceiver: the encoder once; the gradient's decoder pass (which also
    gives the clean logits) and its backward to the received y_r (K2 per
    attention on the path to it: decoder layer 1's self-attention is not);
    then the attacked decoder pass (teacher_forced, and pgd, which runs the
    same step for a GAN model) or the max_length full-prefix steps of the
    greedy decoder (greedy_gan)."""
    dec = 2 * cfg.decoder_num_layer
    passes = cfg.max_length if mode == "greedy_gan" else 1
    return {attn.KERNEL: cfg.encoder_num_layer + dec * (1 + passes),
            attn.KERNEL_BWD: dec - 1}


GAN_CKPT = "log/chip_smoke/gan_ckpt"
GAN_STAR_CKPT = "log/chip_smoke/gan_star_ckpt"
# epochs of the GAN training phases: one epoch is 64 steps at bs 64
GAN_EPOCHS = 1


def phase_gan_train(seed, epochs, bs, variant="gan"):
    """`cli train --variant <gan|gan_star> --train-mode gan` at full width
    in bf16 from a random init (seed) on the synthetic set, AWGN: the
    launch counts per step (`gan_step_launches`; gan_star: K5 once per cycle
    of the encoder and of both decoder branches, K3 and K4 per branch);
    every loss, g_loss and d_loss finite; the mean of the last 16 receiver
    losses below that of the first 16. -> (launch counts, ms per step)."""
    tag = f"{variant}_train"
    checkpoint = GAN_CKPT if variant == "gan" else GAN_STAR_CKPT
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["train", "--variant", variant, "--train-mode", "gan",
                    "--dtype", "bfloat16", "--bs", str(bs), "--epochs",
                    str(epochs), "--seed", str(seed), "--device", "cuda",
                    "--log-every", "64", "--log-save-path",
                    f"log/chip_smoke/{tag}", "--checkpoint-path",
                    checkpoint])
    wall = time.perf_counter() - t0
    got = launches()
    cfg = Config()
    n = res["steps"]
    expected = {name: 0 for name in COUNTERS}
    if variant == "gan":
        per_step = gan_step_launches(cfg)
    else:
        per_step = {star.KERNEL: 3 * cfg.cycle_num,
                    **ce_routes(cfg.dtype, cfg.decoder_d_model, 2, 2)}
    expected.update({name: k * n for name, k in per_step.items()})
    check_launches(tag, got, expected)
    losses = [res[k] for k in ("losses", "g_losses", "d_losses")]
    if any(len(x) != n or not torch.isfinite(x).all() for x in losses):
        raise AssertionError(f"{tag}: a loss is not finite")
    loss = losses[0]
    first, last = loss[:16].mean().item(), loss[-16:].mean().item()
    steady = res["epoch_seconds"][1:] or res["epoch_seconds"]
    ms_step = sum(steady) / len(steady) / (n // epochs) * 1e3
    print(f"[{tag}] {n} steps ({3 * n} Adam updates); receiver loss mean of "
          f"the first 16 {first:.4f}, of the last 16 {last:.4f}; g_loss "
          f"first {losses[1][0]:.4f} last {losses[1][-1]:.4f}; d_loss first "
          f"{losses[2][0]:.4f} last {losses[2][-1]:.4f}; epoch seconds "
          f"{res['epoch_seconds']}; {ms_step:.3f} ms/step; wall {wall:.2f} s")
    if not last < first:
        raise AssertionError(f"{tag}: the receiver loss did not fall: "
                             f"{first} -> {last}")
    return got, ms_step


@contextlib.contextmanager
def gan_grads():
    """Records the gradients each phase of a GAN step applies (the dicts
    `gan_steps.selective_update` is given), in phase order."""
    seen, update = [], gan_steps.selective_update

    def record(state, grads, mask):
        seen.append({n: None if g is None else g.detach().clone()
                     for n, g in grads.items()})
        return update(state, grads, mask)

    gan_steps.selective_update = record
    try:
        yield seen
    finally:
        gan_steps.selective_update = update


def phase_gan_step_parity(seed, bs):
    """One f32 GAN step at full width through the kernels and one through
    the plain versions, from the same weights (init from `seed`), draws
    and dropout masks: `gan_step_launches` through the kernels, none
    through the plain versions; the three losses within rtol 1e-5; the
    gradients of the three phases within 1e-4 of their largest, the plain
    step taking the kernel run's ReLU decisions (`tapped`: at this width
    some ReLU inputs lie within the paths' f32 difference of 0, and a sign
    flips a gradient term; printed, with the gap on each path's own
    decisions). Both paths must have run a ReLU."""
    cfg = Config(dtype="float32", bs=bs)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))

    def run(plain, replay=(None, None)):
        model = steps.init_params(variant_model(cfg, "gan", plain),
                                  seed).cuda().train()
        state = steps.create_train_state(model, cfg)
        step = gan_steps.make_gan_train_step(model, cfg, plain=plain)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        with tapped(replay) as taps, gan_grads() as grads:
            _, losses = step(state, inp, inp, gen, n_std)
        torch.cuda.synchronize()
        return [x.item() for x in losses], grads, launches(), taps

    def grad_gap(a, b):
        return max((max_err([a[i][n]], [b[i][n]], relative=True), f"{i}:{n}")
                   for i in range(3) for n in a[i] if b[i][n] is not None)

    lk, gk, ck, (_, xk) = run(False)
    lp, gp, cp, (_, xp) = run(True)
    ls, gs, _, _ = run(True, (None, xk))
    want = {name: 0 for name in COUNTERS}
    want.update(gan_step_launches(cfg))
    check_launches("f32 GAN step", ck, with_narrow(want))
    if sum(cp.values()):
        raise AssertionError(f"the plain GAN step launched {cp}")
    if not len(xk) == len(xp) > 0:
        raise AssertionError(f"{len(xk)} and {len(xp)} ReLU calls")
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xk, xp))
    rel = [abs(a - b) / abs(b) for a, b in zip(lk + lk, lp + ls)]
    same, own = grad_gap(gk, gs), grad_gap(gk, gp)
    print(f"[parity] f32 GAN step: losses (loss, g_loss, d_loss) kernels "
          f"{lk}, plain {lp}, plain on the kernel run's ReLU decisions {ls} "
          f"(rel {', '.join(f'{r:.2e}' for r in rel)}); {len(xk)} ReLU "
          f"calls, {flips} inputs change sign between the paths; worst grad "
          f"err / max|ref| on the same ReLU decisions {same[0]:.2e} "
          f"({same[1]}), on each path's own {own[0]:.2e} ({own[1]}); "
          f"launches {json.dumps(ck)}")
    if not all(r <= 1e-5 for r in rel):
        raise AssertionError(f"f32 GAN step losses {lk} vs plain {lp}, {ls}")
    if not same[0] <= 1e-4:
        raise AssertionError(f"f32 GAN step grad {same[1]}: {same[0]} > "
                             f"1e-4 of max|ref|")


def phase_gan_eval(seed, batches, bs):
    """The GAN evaluations through `cli evaluate --variant gan` on the
    weights the GAN training phase saved, bf16, PNR 0 dB: the
    teacher-forced table (the GAN FGM step), `pgd` (which runs the same
    step for a GAN model; one batch) and the `greedy_gan` sweep; 19 finite
    rows each and `gan_eval_launches` per call. -> their launch counts
    summed."""
    cfg = Config()
    none = {name: 0 for name in COUNTERS}
    model = ("--variant", "gan", "--checkpoint-path", GAN_CKPT)
    counts = []
    for tag, mode, n_batches in (("gan_tf", "teacher_forced", batches),
                                 ("gan_pgd", "pgd", 1),
                                 ("gan_greedy", "greedy_gan", batches)):
        got, _, res, _ = phase_serve(
            tag, ["--eval-mode", mode, "--pnr-db", "0"], seed, n_batches, bs,
            dict(none, **gan_eval_launches(cfg, mode)), model=model,
            width=2 if mode == "greedy_gan" else 5)
        if res["params_path"] != f"{GAN_CKPT}/gan_params.pkl":
            raise AssertionError(f"{tag}: loaded {res['params_path']}")
        counts.append(got)
    return _sum_counts(*counts)


def phase_gan_f32_ids(seed, bs):
    """One batch at f32 on the trained GAN weights, three SNRs, the same
    draws: `greedy_gan` through K1/K2 and through their plain versions.
    The perturbation comes from a gradient (a ReLU input at its kink flips
    a term), so the plain decode takes the kernel call's ReLU decisions and
    perturbation (`tapped`); then the ids and noa are identical."""
    params = load_params_pickle(f"{GAN_CKPT}/gan_params.pkl")
    cfg = Config(dtype="float32", bs=bs, tie_embeddings=is_tied(params))
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((2, bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    models = [load_into(variant_model(cfg, "gan", plain),
                        params).cuda().eval() for plain in (False, True)]

    def run(plain, replay=(None, None)):
        reset_launches()
        with tapped(replay) as taps:
            out = make_greedy_decode_gan(models[plain], cfg)(
                inp, 0.0, SNR_to_noise(snr), noise, None, 1.0)
        torch.cuda.synchronize()
        want = {name: 0 for name in COUNTERS}
        if not plain:
            want = with_narrow(dict(want, **gan_eval_launches(
                cfg, "greedy_gan")))
        check_launches(f"f32 greedy_gan {snr} dB (plain {plain})",
                       launches(), want)
        return out, taps

    for snr in (0, 9, 18):
        (ids_k, noa_k), taps = run(False)
        if not (len(taps[0]) == 1 and taps[1]):
            raise AssertionError("greedy_gan: no perturbation or no ReLU "
                                 "recorded")
        (ids_p, noa_p), _ = run(True, taps)
        same_ids(f"greedy_gan ids at {snr} dB, K1/K2 vs plain on the same "
                 f"ReLU decisions and perturbation", ids_k, ids_p)
        same_ids(f"greedy_gan noa at {snr} dB", noa_k, noa_p)


def phase_gan_star(seed, epochs, batches, bs):
    """gan_star: `cli train --variant gan_star --train-mode gan` (it
    counts as a star variant: seq_len 31, the un-shifted target), then the
    `greedy_gan` sweep of what it saved (one-shot decoding; per call 8
    cycles of the encoder, 8 of the gradient's decoder pass and 8 of the
    one-shot decode, all K5). -> their launch counts summed."""
    trained, ms_step = phase_gan_train(seed, epochs, bs, "gan_star")
    none = {name: 0 for name in COUNTERS}
    got, *_ = phase_serve(
        "gan_star_greedy", ["--eval-mode", "greedy_gan", "--pnr-db", "0"],
        seed, batches, bs, dict(none, **{star.KERNEL: 3 * Config().cycle_num}),
        model=("--variant", "gan_star", "--checkpoint-path", GAN_STAR_CKPT))
    return _sum_counts(trained, got), ms_step


def _graph_batches(cfg, seed, k):
    """(k, B, L) synthetic training batches on the card."""
    ds = load_train_dataset(cfg, seed)
    rows = [torch.from_numpy(inp) for (inp, _), _ in zip(ds, range(k))]
    return torch.stack(rows).to("cuda", torch.long)


@contextlib.contextmanager
def recorded_draws():
    """-> (draws, replays): every draw of a train step in order, the
    tensors themselves (the channel noise through `steps._draw`, each
    dropout mask through `bernoulli_`); and, for one graphed multi-step
    call, after each replay the values of the draws made while the graph
    was captured (tensors the graph keeps alive and each replay writes)."""
    from deepsc_gan_tpu_torch.train import graphed

    seen, replays = [], []
    draw, bernoulli = steps._draw, torch.Tensor.bernoulli_
    replay = graphed.GraphedStep.replay

    def draw_rec(*a, **kw):
        out = draw(*a, **kw)
        seen.append(out[0])
        return out

    def bernoulli_rec(self, *a, **kw):
        seen.append(bernoulli(self, *a, **kw))
        return seen[-1]

    def replay_rec(self, *a, **kw):
        out = replay(self, *a, **kw)
        # the warm-up step's draws, then the capture's
        replays.append([t.clone() for t in seen[len(seen) // 2:]])
        return out

    steps._draw, torch.Tensor.bernoulli_ = draw_rec, bernoulli_rec
    graphed.GraphedStep.replay = replay_rec
    try:
        yield seen, replays
    finally:
        steps._draw, torch.Tensor.bernoulli_ = draw, bernoulli
        graphed.GraphedStep.replay = replay


def _graph_run(cfg, variant, seed, inps, graphed):
    """K steps of `variant` from the init of `seed` and one generator seed:
    one multi-step call (graphed) or K eager steps -> (losses (K,), model,
    state)."""
    full = is_star(variant)
    model = steps.init_params(variant_model(cfg, variant), seed).cuda()
    state = steps.create_train_state(model.train(), cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    if graphed:
        multi = steps.make_train_multi_step(model, cfg, full_target=full)
        state, losses = multi(state, inps, inps, gen, n_std)
    else:
        step = steps.make_train_step(model, cfg, full_target=full)
        losses = torch.stack([step(state, x, x, gen, n_std)[1]
                              for x in inps])
    torch.cuda.synchronize()
    return losses, model, state


def graph_parity(seed, bs, variant):
    """GRAPH_K f32 steps at full width (dropout 0.1) through one graphed
    multi-step call and through GRAPH_K eager steps from the same init and
    generator seed: the losses within rtol 1e-5, every parameter and Adam
    moment within 1e-5 of its largest value (whether bitwise equal is
    printed); the graph's channel noise and dropout masks of two replays
    differ and each equals the eager step's draw at that point."""
    cfg = Config(dtype="float32", bs=bs, seq_len=default_seq_len(variant))
    inps = _graph_batches(cfg, seed, GRAPH_K)
    with recorded_draws() as (drawn, _):
        eager = _graph_run(cfg, variant, seed, inps, False)
    with recorded_draws() as (_, replayed):
        graphed = _graph_run(cfg, variant, seed, inps, True)
    loss_err = ((graphed[0] - eager[0]).abs() / eager[0].abs()).max().item()
    worst, worst_name, bitwise = 0.0, "", torch.equal(graphed[0], eager[0])
    for (name, a), b in zip(graphed[1].named_parameters(),
                            eager[1].parameters()):
        sa, sb = graphed[2].optimizer.state[a], eager[2].optimizer.state[b]
        for what, x, y in (("param", a, b),
                           ("exp_avg", sa["exp_avg"], sb["exp_avg"]),
                           ("exp_avg_sq", sa["exp_avg_sq"],
                            sb["exp_avg_sq"])):
            err = max_err([x], [y], relative=True)
            bitwise = bitwise and torch.equal(x, y)
            if err > worst:
                worst, worst_name = err, f"{name} {what}"
    per_step = len(drawn) // GRAPH_K
    fresh = len(replayed) == GRAPH_K - 1 and len(replayed[0]) == per_step \
        and not torch.equal(replayed[0][0], replayed[1][0]) \
        and not torch.equal(replayed[0][-1], replayed[1][-1])
    same_draws = all(torch.equal(a, b) for r, replay in enumerate(replayed)
                     for a, b in zip(replay, drawn[(r + 1) * per_step:]))
    print(f"[graph] {variant} f32, {GRAPH_K} steps: losses graphed "
          f"{graphed[0].tolist()} eager {eager[0].tolist()} (max rel "
          f"{loss_err:.2e}); worst param/moment err / max|ref| {worst:.2e} "
          f"({worst_name}); bitwise equal {bitwise}; counts "
          f"{graphed[2].step}/{eager[2].step}; {per_step} draws a step, "
          f"replays' draws fresh {fresh}, equal to the eager draws "
          f"{same_draws}")
    if not loss_err <= 1e-5 or not worst <= 1e-5:
        raise AssertionError(f"{variant}: graphed steps differ from eager "
                             f"ones: loss {loss_err}, {worst_name} {worst}")
    if graphed[2].step != eager[2].step or not fresh or not same_draws:
        raise AssertionError(f"{variant}: a replay's draws are not fresh or "
                             f"not the eager step's")
    return {"bitwise": bitwise, "loss_rel_err": loss_err,
            "param_moment_err": worst}


def host_grads(model):
    return [None if p.grad is None else p.grad.detach().cpu().clone()
            for p in model.parameters()]


def update_gap(got_model, got_state, ref_model, ref_state):
    """-> (the worst |got - ref| / max|ref| over the params, the Adam
    moments and the EMA shadow, where, whether every count is equal)."""
    worst, worst_name = 0.0, ""
    counts = got_state.step == ref_state.step
    for (name, a), b in zip(got_model.named_parameters(),
                            ref_model.parameters()):
        sa, sb = got_state.optimizer.state[a], ref_state.optimizer.state[b]
        pairs = [("param", a, b)] + [(key, sa[key], sb[key])
                                     for key in ("exp_avg", "exp_avg_sq")]
        if ref_state.ema is not None:
            pairs.append(("ema", got_state.ema[name], ref_state.ema[name]))
        for what, x, y in pairs:
            err = max_err([x.cpu()], [y.cpu()], relative=True)
            if err > worst:
                worst, worst_name = err, f"{name} {what}"
        counts = counts and sa["step"].item() == sb["step"].item()
    return worst, worst_name, counts


def _check_update(tag, updates, want, got_model, got_state, ref_model,
                  ref_state):
    worst, name, counts = update_gap(got_model, got_state, ref_model,
                                     ref_state)
    print(f"[graph] {tag}: {updates} updates, the card's against the CPU's "
          f"on the same gradients: worst param/moment/EMA err / max|ref| "
          f"{worst:.2e} ({name}); counts {got_state.step}/{ref_state.step},"
          f" every Adam count equal {counts}")
    if updates != want or not counts or not worst <= 1e-5:
        raise AssertionError(f"{tag}: the card's update differs from the "
                             f"CPU's: {name} {worst}, counts equal {counts}")
    return worst


def graph_update_parity(seed, bs):
    """GRAPH_K f32 vanilla steps at full width under noam (warmup 40: the
    rate moves visibly every count) with the EMA shadow, through one
    graphed multi-step call (the fused capturable Adam, its rate written
    before each replay, its count on the card), each step's gradients read
    back after it; the same gradients applied from the same init by the
    CPU's Adam (`TrainState.apply_gradients` with a float rate, the update
    tests/test_torch_multistep.py holds to the JAX package's multi-step):
    params, Adam moments and the EMA shadow within 1e-5 of their largest
    value, every count equal. Both sides take the card's gradients, so the
    update alone is compared; the kernels' gradients are held to the plain
    versions' by phase_step_parity."""
    from deepsc_gan_tpu_torch.train import graphed

    cfg = Config(dtype="float32", bs=bs, schedule="noam", warmup_steps=40,
                 ema_decay=0.9)
    inps = _graph_batches(cfg, seed, GRAPH_K)
    seen = []
    warm_up, replay = graphed.warm_up, graphed.GraphedStep.replay

    def warm_up_rec(step, state, *a, **kw):
        out = warm_up(step, state, *a, **kw)
        seen.append(host_grads(state.model))
        return out

    def replay_rec(self, state, *a, **kw):
        out = replay(self, state, *a, **kw)
        seen.append(host_grads(state.model))
        return out

    graphed.warm_up, graphed.GraphedStep.replay = warm_up_rec, replay_rec
    try:
        _, model, state = _graph_run(cfg, "transformer", seed, inps, True)
    finally:
        graphed.warm_up, graphed.GraphedStep.replay = warm_up, replay
    ref_model = steps.init_params(variant_model(cfg, "transformer"), seed)
    ref = steps.create_train_state(ref_model.train(), cfg)
    for grads in seen:
        for p, g in zip(ref_model.parameters(), grads):
            p.grad = g
        ref.apply_gradients()
    return _check_update("transformer f32 noam+EMA graphed", len(seen),
                         GRAPH_K, model, state, ref_model, ref)


def gan_update_parity(seed, bs, n_steps=2):
    """`n_steps` f32 GAN steps at full width on the card under noam
    (warmup 40) with the EMA shadow: three selective updates a step over
    one shared Adam, its device counts written before each. The same
    gradients and masks applied from the same init by `selective_update`
    over the CPU's Adam, the EMA after every third (the update
    tests/test_torch_gan.py holds to JAX's GAN step): params, Adam moments
    and the EMA shadow within 1e-5 of their largest value, every count
    equal."""
    cfg = Config(dtype="float32", bs=bs, schedule="noam", warmup_steps=40,
                 ema_decay=0.9)
    inps = _graph_batches(cfg, seed, n_steps)
    n_std = float(snr_to_noise(cfg.train_snr))
    updates, update = [], gan_steps.selective_update

    def record(state, grads, mask):
        updates.append(({n: None if g is None else g.detach().cpu().clone()
                         for n, g in grads.items()}, mask))
        return update(state, grads, mask)

    model = steps.init_params(variant_model(cfg, "gan"), seed).cuda()
    state = steps.create_train_state(model.train(), cfg)
    step = gan_steps.make_gan_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gan_steps.selective_update = record
    try:
        for x in inps:
            state, _ = step(state, x, x, gen, n_std)
        torch.cuda.synchronize()
    finally:
        gan_steps.selective_update = update
    ref_model = steps.init_params(variant_model(cfg, "gan"), seed)
    ref = steps.create_train_state(ref_model.train(), cfg)
    for i, (grads, mask) in enumerate(updates):
        update(ref, grads, mask)
        if i % 3 == 2:
            gan_steps._ema(ref)
    return _check_update(f"GAN f32 noam+EMA, {n_steps} steps", len(updates),
                         3 * n_steps, model, state, ref_model, ref)


# the main kernel of each kernel's launch as the profiler names it, and
# how many it runs per launch
_TRACE_NAMES = {attn.KERNEL: "attention_fwd_mma_kernel",
                attn.KERNEL_BWD: "attention_bwd_mma_kernel",
                ce.KERNEL_FWD: "ce_fwd_wgmma_kernel",
                ce.KERNEL_BWD: "ce_dw_wgmma_kernel",
                star.KERNEL: "star_satellite_kernel"}


def graph_timing(seed, bs, variant, gen):
    """bf16 at full width: the wall ms a step of GRAPH_RUNS runs of
    GRAPH_TIMED_K eager steps and of GRAPH_RUNS graphed calls of as many
    steps (each run synchronized at its end, after a warm-up); then one
    graphed call of GRAPH_K steps profiled: its trace must hold GRAPH_K
    times one step's launches of every kernel the eager step launched (the
    replays ran them; a trace without device activity fails), and its idle
    share; and one eager step profiled for its idle share."""
    cfg = Config(bs=bs, seq_len=default_seq_len(variant))
    full = is_star(variant)
    n_std = float(snr_to_noise(cfg.train_snr))
    inps = _graph_batches(cfg, seed, GRAPH_TIMED_K)
    model = steps.init_params(make_model(cfg, variant), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(model, cfg, full_target=full)
    multi = steps.make_train_multi_step(model, cfg, full_target=full)
    multi(state, inps[:GRAPH_K], inps[:GRAPH_K], gen, n_std)  # capture
    step(state, inps[0], inps[0], gen, n_std)
    times = {"eager": [], "graphed": []}
    for _ in range(GRAPH_RUNS):
        for side in ("eager", "graphed"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "eager":
                for x in inps:
                    step(state, x, x, gen, n_std)
            else:
                multi(state, inps, inps, gen, n_std)
            torch.cuda.synchronize()
            times[side].append((time.perf_counter() - t0) * 1e3
                               / GRAPH_TIMED_K)
    reset_launches()
    step(state, inps[0], inps[0], gen, n_std)
    torch.cuda.synchronize()
    one = launches()
    tag = f"{variant} bf16"
    eager_rows = profiled(f"one eager {tag} train step",
                          lambda: step(state, inps[0], inps[0], gen, n_std))
    rows = profiled(f"one graphed {tag} call of {GRAPH_K} steps",
                    lambda: multi(state, inps[:GRAPH_K], inps[:GRAPH_K], gen,
                                  n_std))
    want = {kernel: GRAPH_K * n for kernel, n in one.items() if n}
    counted = {kernel: sum(c for name, (_, c) in rows if word in name)
               for kernel, word in _TRACE_NAMES.items() if kernel in want}
    print(f"[graph] {tag}: ms a step over {GRAPH_RUNS} runs of "
          f"{GRAPH_TIMED_K} steps: eager {times['eager']}, graphed "
          f"{times['graphed']}; the profiled call's kernels by name "
          f"{json.dumps(counted)} (want {json.dumps(want)})")
    if not rows or counted != want:
        raise AssertionError(f"{tag}: the graphed call's trace holds "
                             f"{counted}, not {want}")
    return {"ms_per_step": times, "trace_counts": counted,
            "eager_rows": len(eager_rows), "graphed_rows": len(rows)}


def phase_graph(seed, bs):
    """The captured CUDA graph of the train step (`make_train_multi_step`,
    the default `cli train` path) at full width, vanilla and star: f32
    parity with the eager steps and fresh draws per replay
    (`graph_parity`); bf16 wall time a step eager against graphed, and the
    trace of a graphed call (`graph_timing`). First the card's optimizer
    update, graphed and in the GAN's selective updates, against the CPU's
    on the same gradients (`graph_update_parity`, `gan_update_parity`)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"update_err": {"transformer_graphed": graph_update_parity(seed,
                                                                     bs),
                          "gan": gan_update_parity(seed, bs)}}
    for variant in ("transformer", "star"):
        out[variant] = dict(graph_parity(seed, bs, variant),
                            **graph_timing(seed, bs, variant, gen))
    return out


# the widened paths' models (phase_wide, phase_wide_heads): their widths as
# CLI flags and where their training saves them
WIDE_CKPT = "log/chip_smoke/wide_ckpt"
WIDE_WIDTHS = ["--encoder-d-model", "512", "--encoder-d-ff", "1024",
               "--decoder-d-model", str(WIDE_PATH_D), "--decoder-d-ff",
               str(2 * WIDE_PATH_D)]
WIDE_HEADS_CKPT = "log/chip_smoke/wide_heads_ckpt"
WIDE_HEADS_WIDTHS = ["--encoder-d-model", "512", "--encoder-num-heads", "1",
                     "--encoder-d-ff", "1024", "--decoder-d-model", "640",
                     "--decoder-num-heads", "2", "--decoder-d-ff", "1280"]
# the SNRs of the f32 id checks on the widened models, and the two paths
F32_WIDE_SNRS = (0, 9, 18)
F32_WIDE_PATHS = ("f32_wide_beam", "f32_wide_heads_greedy")


def phase_wide(seed, bs):
    """The widened kernels on paths through the CLI, bf16, from random
    inits (each widening accepted at command start): `cli train` of a
    transceiver with an encoder of 8 heads of 64 (d_model 512) and a
    decoder of 8 heads of 25 (d_model 200) for one epoch (every K1/K2 and
    K3/K4 launch on its wide kernels; per step as the default's), `cli
    evaluate --eval-mode beam --beam-size 9` on what it saved (K6's wide
    kernels, 30 a call; K1 of its encoder), and `cli train --variant star`
    at d_model 96 (8 heads of 12: K5's wide kernel, 16 a step). Prints the
    widened epoch's ms a step. -> the launch counts by path."""
    cfg = Config()
    ckpt, widths = WIDE_CKPT, WIDE_WIDTHS
    got, stats = phase_train(seed, 1, bs, extra=widths, checkpoint=ckpt,
                             tag="wide_train", wide=(attn.KERNEL,
                                                     attn.KERNEL_BWD))
    print(f"[wide] {stats['ms_per_step']:.3f} ms a step over the epoch of "
          f"{stats['steps']} steps (the graph's warm-up and capture in it), "
          f"bf16")
    beam_k = WIDE_BEAM
    per_call = {name: 0 for name in COUNTERS}
    per_call.update({attn.KERNEL: cfg.encoder_num_layer,
                     WIDE[attn.KERNEL]: cfg.encoder_num_layer,
                     topk.KERNEL: cfg.max_length,
                     WIDE[topk.KERNEL]: cfg.max_length})
    beam, *_ = phase_serve("wide_beam", ["--eval-mode", "beam",
                                         "--beam-size", str(beam_k)],
                           seed, 1, bs, per_call,
                           model=("--variant", "transformer",
                                  "--checkpoint-path", ckpt, *widths))
    star_got, _ = phase_train(seed, 1, bs, "star",
                              "log/chip_smoke/wide_star_ckpt",
                              extra=["--encoder-d-model", "96",
                                     "--decoder-d-model", "96"],
                              tag="wide_star_train", wide=(star.KERNEL,))
    return _sum_counts(got, beam, star_got)


def phase_wide_heads(seed, bs):
    """Heads wider than 256 on a path: `cli train` in bf16 for one epoch
    from a random init with an encoder of one head of 512 (d_model 512) and
    a decoder of 2 heads of 320 (d_model 640): every K1 and K2 launch on
    the tensor-core chunked kernels, K3 and K4 on their tensor-core wide
    kernels (D = 640); per step as the default's. Prints the epoch's ms a step. -> its launch
    counts."""
    got, stats = phase_train(seed, 1, bs, extra=WIDE_HEADS_WIDTHS,
                             checkpoint=WIDE_HEADS_CKPT,
                             tag="wide_heads_train",
                             wide=(attn.KERNEL, attn.KERNEL_BWD))
    print(f"[wide_heads] {stats['ms_per_step']:.3f} ms a step over the "
          f"epoch of {stats['steps']} steps (the graph's warm-up and capture "
          f"in it), bf16")
    return got


def width_fields(widths):
    """Config fields of a widened model given as CLI width flags."""
    return {flag[2:].replace("-", "_"): int(value)
            for flag, value in zip(widths[::2], widths[1::2])}


def wide_config(widths, params, **fields):
    """The Config of a widened model given as CLI width flags, its
    tie_embeddings read from `params`."""
    return Config(tie_embeddings=is_tied(params), **width_fields(widths),
                  **fields)


def recording(fn, seen):
    """`fn` whose every call's arguments and result are appended to
    `seen`."""
    def call(*args):
        out = fn(*args)
        seen.append((args, out))
        return out
    return call


def beam_steps(model, cfg, k, scorer, args):
    """The KV beam decode at one noise level with each step's two
    selections recorded: -> (ids (B, T+1), [(h_flat, vals, idx) of the
    scorer's call], [(candidate scores (B, k k), top positions) of the
    second stage's `take_top`])."""
    stage1, stage2 = [], []
    take_top = beam_module.take_top
    beam_module.take_top = recording(take_top, stage2)
    try:
        ids = make_beam_decode_kv(model, cfg, k,
                                  topk=recording(scorer, stage1))(*args)
    finally:
        beam_module.take_top = take_top
    return (ids, [(a[0].float(), out[0], out[1]) for a, out in stage1],
            [(a[0], out[1]) for a, out in stage2])


def same_beam_ids_but_near_ties(tag, k, got, want, W, b):
    """Beam ids through the kernels (`got`: beam_steps' result) against the
    plain versions' (`want`). The two paths' logits differ by f32 rounding
    alone: at each step by delta, the largest difference of the scorer's
    values where both paths' lists agree, which must be within the f32
    tolerance of the largest value. A row whose ids differ counts as a
    fault unless, at its first step where the paths chose differently, the
    choice was a near-tie: in the scorer's list of one of its beams, the
    plain logits (from the plain path's hidden state) of the two
    candidates at the first differing place lie within 2 delta; or, the
    lists agreeing, in the second stage the plain scores of the two
    candidates at the first differing place lie within 2 delta of the
    step's candidate scores. Such near-ties are counted and printed."""
    ids_g, s1_g, s2_g = got
    ids_w, s1_w, s2_w = want
    rows = ids_g.shape[0]
    deltas, deltas2, scale = [], [], 0.0
    for (hg, vg, ig), (hw, vw, iw), (cg, _), (cw, _) in zip(s1_g, s1_w,
                                                            s2_g, s2_w):
        same = ig == iw
        deltas.append(((vg - vw).abs() * same).max().item())
        rows_same = same.reshape(rows, -1).all(1)
        deltas2.append(((cg - cw).abs()[rows_same].max().item()
                        if rows_same.any() else 0.0))
        scale = max(scale, vw.abs().max().item())
    delta = max(deltas)
    diff = (ids_g != ids_w).any(1).nonzero().reshape(-1).tolist()
    near, faults = 0, []
    for r in diff:
        for s, ((_, vg, ig), (hw, vw, iw), (cg, pg), (cw, pw)) in enumerate(
                zip(s1_g, s1_w, s2_g, s2_w)):
            ig_r, iw_r = (x.reshape(rows, k, k)[r] for x in (ig, iw))
            if not torch.equal(ig_r, iw_r):
                beam, pos = (ig_r != iw_r).nonzero()[0].tolist()
                x, y = int(ig_r[beam, pos]), int(iw_r[beam, pos])
                h = hw.reshape(rows, k, -1)[r, beam]
                lx, ly = (h @ W[[x, y]].float().t() + b[[x, y]]).tolist()
                ok = ly - lx <= 2 * deltas[s]
                break
            if not torch.equal(pg[r], pw[r]):
                pos = int((pg[r] != pw[r]).nonzero()[0])
                x, y = int(pg[r, pos]), int(pw[r, pos])
                ok = (cw[r, y] - cw[r, x]).item() <= 2 * deltas2[s]
                break
        else:
            ok = False
        near += ok
        if not ok:
            faults.append(r)
    print(f"[f32] {tag}: {not faults and delta <= TOL[torch.float32] * scale}"
          f" ({len(diff)} of {rows} rows differ, {near} at near-ties within "
          f"2 x delta; scorer values differ by {delta:.3g} of max "
          f"{scale:.3g})")
    if not delta <= TOL[torch.float32] * scale:
        raise AssertionError(f"f32 {tag}: scorer values differ by {delta} "
                             f"> {TOL[torch.float32]} x {scale}")
    if faults:
        raise AssertionError(f"f32 {tag}: rows {faults} differ away from a "
                             f"near-tie")


def phase_f32_wide(seed, bs):
    """The f32 paths of the widened models, on what phase_wide and
    phase_wide_heads saved, each through `cli evaluate --dtype float32`
    with exact launch counts, then its ids through the kernels against the
    plain versions at F32_WIDE_SNRS, one batch of bs, same weights and
    noise:
    - f32_wide_beam: `--eval-mode beam --beam-size WIDE_BEAM` on the
      widened model (encoder 8 heads of 64, decoder 8 of 25, D = 200), one
      batch at 19 SNRs: a decode call an SNR, each the encoder's K1 on the
      tiled kernel and max_length K6 on the select kernels (N = bs x
      WIDE_BEAM, k = WIDE_BEAM); the KV beam through K1 and K6 against the
      plain attention and scorer (`same_beam_ids_but_near_ties`);
    - f32_wide_heads_greedy: the full-prefix greedy sweep on the
      wide-heads model (encoder one head of 512, decoder 2 of 320), one
      batch: every K1 (encoder_num_layer + 2 decoder_num_layer max_length
      a call) on the tiled kernel past 256-wide heads; the greedy decode
      through K1 against the plain attention
      (`same_greedy_ids_but_near_ties`).
    -> {path: launch counts}."""
    cfg = Config()
    none = {name: 0 for name in COUNTERS}
    enc = cfg.encoder_num_layer
    beam_call = dict(none, **{attn.KERNEL: enc, WIDE[attn.KERNEL]: enc,
                              TILED: enc, topk.KERNEL: cfg.max_length,
                              WIDE[topk.KERNEL]: cfg.max_length,
                              SELECT: cfg.max_length})
    by_path = {}
    by_path["f32_wide_beam"], rate, *_ = phase_serve(
        "f32_wide_beam", ["--eval-mode", "beam", "--beam-size",
                          str(WIDE_BEAM)], seed, 1, bs, beam_call,
        model=("--variant", "transformer", "--checkpoint-path", WIDE_CKPT,
               *WIDE_WIDTHS), dtype="float32")
    print(f"[f32_wide_beam] steady {rate:.1f} seq/s")
    k1 = enc + 2 * cfg.decoder_num_layer * cfg.max_length
    greedy_call = dict(none, **{attn.KERNEL: k1, WIDE[attn.KERNEL]: k1,
                                TILED: k1})
    by_path["f32_wide_heads_greedy"], rate, *_ = phase_serve(
        "f32_wide_heads_greedy", ["--eval-mode", "greedy"], seed, 1, bs,
        greedy_call, model=("--variant", "transformer", "--checkpoint-path",
                            WIDE_HEADS_CKPT, *WIDE_HEADS_WIDTHS),
        dtype="float32")
    print(f"[f32_wide_heads_greedy] steady {rate:.1f} seq/s")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for tag, ckpt, widths in (("f32_wide_beam", WIDE_CKPT, WIDE_WIDTHS),
                              ("f32_wide_heads_greedy", WIDE_HEADS_CKPT,
                               WIDE_HEADS_WIDTHS)):
        params = load_params_pickle(f"{ckpt}/transformer_params.pkl")
        wcfg = wide_config(widths, params, dtype="float32", bs=bs)
        model_k, model_p = (
            load_into(make_model(wcfg, attention=a), params).cuda().eval()
            for a in (attn.fused_attention, attn.attention_fwd_reference))
        inp = torch.as_tensor(eval_batches(
            wcfg.test_save_path, wcfg.seq_len, wcfg.vocab_size, bs, 1,
            seed)[0], dtype=torch.long, device="cuda")
        for snr in F32_WIDE_SNRS:
            noise = torch.randn((bs, wcfg.seq_len, wcfg.channel_dim),
                                generator=gen, device="cuda")
            if tag == "f32_wide_beam":
                args = (inp, 0.0, SNR_to_noise(snr), noise)
                reset_launches()
                got = beam_steps(model_k, wcfg, WIDE_BEAM, topk.topk_logits,
                                 args)
                k6 = (topk.launches, topk.select_launches, attn.launches,
                      attn.tiled_launches)
                want = beam_steps(model_p, wcfg, WIDE_BEAM,
                                  topk.topk_logits_reference, args)
                if k6 != (wcfg.max_length, wcfg.max_length, enc, enc) or \
                        topk.launches != wcfg.max_length:
                    raise AssertionError(f"{tag}: launches {k6} through the "
                                         f"kernels, {topk.launches} after "
                                         f"the plain run")
                W, b = _vocab_table(model_p, torch.float32)
                same_beam_ids_but_near_ties(
                    f"{tag} at {snr} dB ({bs} x {WIDE_BEAM} beams), K1 and "
                    f"K6 vs plain", WIDE_BEAM, got, want, W, b)
            else:
                reset_launches()
                ids_k, logits_k = greedy_logits(model_k, wcfg, inp, snr,
                                                noise)
                if (attn.launches, attn.tiled_launches) != (k1, k1):
                    raise AssertionError(f"{tag}: {attn.launches} K1, "
                                         f"{attn.tiled_launches} tiled, "
                                         f"want {k1}")
                ids_p, logits_p = greedy_logits(model_p, wcfg, inp, snr,
                                                noise)
                same_greedy_ids_but_near_ties(
                    f"{tag} at {snr} dB ({bs} sentences), K1 vs plain",
                    ids_k, ids_p, logits_k, logits_p)
    return by_path


# where the f32 train epochs of the widened models and of the main model
# save them, those paths, and the main model's epochs there
# (phase_f32_wide_train)
F32_WIDE_HEADS_CKPT = "log/chip_smoke/f32_wide_heads_ckpt"
F32_WIDE_CKPT = "log/chip_smoke/f32_wide_ckpt"
F32_CKPT = "log/chip_smoke/f32_ckpt"
F32_TRAIN_PATHS = ("f32_wide_heads_train", "f32_wide_train", "f32_train")
F32_MAIN_EPOCHS = 2


def phase_f32_wide_train(seed, bs):
    """The widened models and the main model trained at f32, `cli train
    --dtype float32` from a random init through the default graphed path,
    exact launch counts, losses finite and falling; every K3 and K4 on the
    tiled kernels (csrc/ce_fwd_tiled.cu, csrc/ce_bwd_tiled.cu):
    - f32_wide_heads_train, one epoch: the wide-heads model
      (WIDE_HEADS_WIDTHS: encoder one head of 512, decoder 2 of 320,
      D = 640): per step 12 K1 on the tiled kernel, 12 K2 on the tiled
      kernels (csrc/attention_bwd_tiled.cu), K3 and K4 at D = 640;
    - f32_wide_train, one epoch: the widened model (WIDE_WIDTHS: encoder 8
      heads of 64, decoder 8 of 25, D = 200): 12 tiled K1 and 12 tiled K2
      a step, K3 and K4 at D = 200;
    - f32_train, F32_MAIN_EPOCHS epochs: the main model (d_model 128, 8
      heads of 16: the narrow f32 K1/K2, csrc/attention_narrow.cu, 12 of
      each a step), K3 and K4 at D = 128;
    then one f32 step of the wide-heads model through the kernels against
    one through the plain versions (`phase_step_parity`). Prints each
    path's ms a step (the widened ones over their one epoch, the graph's
    warm-up and capture in it; the main model's over its epochs after the
    first). -> {path: launch counts}."""
    by_path = {}
    tiled = ((TILED, attn.KERNEL), (TILED_BWD, attn.KERNEL_BWD))
    for tag, widths, ckpt, epochs, wide, sub in (
            ("f32_wide_heads_train", WIDE_HEADS_WIDTHS, F32_WIDE_HEADS_CKPT,
             1, (attn.KERNEL, attn.KERNEL_BWD), tiled),
            ("f32_wide_train", WIDE_WIDTHS, F32_WIDE_CKPT, 1,
             (attn.KERNEL, attn.KERNEL_BWD), tiled),
            ("f32_train", [], F32_CKPT, F32_MAIN_EPOCHS, (),
             ((NARROW, attn.KERNEL), (NARROW_BWD, attn.KERNEL_BWD)))):
        by_path[tag], stats = phase_train(seed, epochs, bs, extra=widths,
                                          checkpoint=ckpt, tag=tag,
                                          wide=wide, sub=sub,
                                          dtype="float32")
        print(f"[{tag}] {stats['ms_per_step']:.3f} ms a step over " + (
            f"the epoch of {stats['steps']} steps (the graph's warm-up and "
            f"capture in it)" if epochs == 1 else
            f"the epochs after the first of {epochs}") + ", f32")
    phase_step_parity(seed, bs, widths=WIDE_HEADS_WIDTHS, counted=(
        WIDE[attn.KERNEL], WIDE[attn.KERNEL_BWD], TILED, TILED_BWD))
    return by_path


# epochs of the MINE training phase: one epoch is 64 steps at bs 64
MINE_EPOCHS = 1


def mine_step_launches(cfg):
    """K1/K2 launches of one MINE step of the vanilla transceiver: a
    forward (K1 per attention) and its backward (K2 per attention), then
    the encoder's forward again for T's update; no K3/K4 (the CE takes
    materialized logits, as the JAX MINE step)."""
    per_forward = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
    return {attn.KERNEL: per_forward + cfg.encoder_num_layer,
            attn.KERNEL_BWD: per_forward}


def phase_mine_train(seed, epochs, bs):
    """`cli train --train-mode mine` at full width in bf16 from a random
    init on the synthetic set (path mine, one eager step a call): the
    launch counts are `mine_step_launches` per step; every ce and mi
    finite, and the mean of the last 16 ce below that of the first 16."""
    tag = "mine_train"
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "mine", "--dtype", "bfloat16", "--bs", str(bs),
                    "--epochs", str(epochs), "--seed", str(seed), "--device",
                    "cuda", "--log-every", "64", "--log-save-path",
                    f"log/chip_smoke/{tag}", "--checkpoint-path",
                    f"log/chip_smoke/{tag}_ckpt"])
    wall = time.perf_counter() - t0
    got = launches()
    n = res["steps"]
    if res["path"] != "mine":
        raise AssertionError(f"{tag}: cli train ran path {res['path']}")
    expected = {name: 0 for name in COUNTERS}
    expected.update({name: k * n for name, k in
                     mine_step_launches(Config()).items()})
    check_launches(tag, got, expected)
    ces, mis = res["losses"], res["mis"]
    if len(ces) != n or len(mis) != n or not (
            torch.isfinite(ces).all() and torch.isfinite(mis).all()):
        raise AssertionError(f"{tag}: a ce or mi is not finite")
    first, last = ces[:16].mean().item(), ces[-16:].mean().item()
    steady = res["epoch_seconds"][1:] or res["epoch_seconds"]
    ms_step = sum(steady) / len(steady) / (n // epochs) * 1e3
    print(f"[{tag}] {n} steps; ce mean of the first 16 {first:.4f}, of the "
          f"last 16 {last:.4f}; mi first {mis[0]:.5f} last {mis[-1]:.5f} "
          f"(mean of the last 16 {mis[-16:].mean().item():.5f}); epoch "
          f"seconds {res['epoch_seconds']}; {ms_step:.3f} ms/step; wall "
          f"{wall:.2f} s")
    if not last < first:
        raise AssertionError(f"{tag}: the ce did not fall: {first} -> "
                             f"{last}")
    return got


def phase_mine_step_parity(seed, bs):
    """One f32 MINE step at full width through the kernels and one through
    the plain versions, from the same weights (the transceiver's init from
    `seed`, T's from seed + 1), draws, permutation and dropout masks, the
    plain step on the kernel run's ReLU decisions (`tapped`: T's ReLUs
    among them): `mine_step_launches` through the kernels, none through
    the plain versions; ce and mi within rtol 1e-5; each of the
    transceiver's gradients (its update's) within 1e-4 of its largest, and
    T's (its update's, clipped) within 1e-4 of the largest over T (fc2's
    bias has the gradient 1 - sum softmax, zero but for rounding: the DV
    bound does not move when T shifts). Both paths must have run a
    ReLU."""
    cfg = Config(dtype="float32", bs=bs)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))

    def run(plain, replay=(None, None)):
        model = steps.init_params(variant_model(cfg, "transformer", plain),
                                  seed).cuda().train()
        state = steps.create_train_state(model, cfg)
        mine, mine_state = mine_steps.create_mine_state(cfg, seed + 1,
                                                        device="cuda")
        step = mine_steps.make_mine_train_step(model, mine, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        with tapped(replay) as taps:
            _, _, out = step(state, mine_state, inp, inp, gen, n_std)
        torch.cuda.synchronize()
        return [x.item() for x in out], (model, mine), launches(), taps

    def grad_gap(a, b):
        gaps = [(max_err([p.grad], [q.grad], relative=True), name)
                for (name, p), q in zip(a[0].named_parameters(),
                                        b[0].parameters())]
        largest = max(q.grad.abs().max().item() for q in b[1].parameters())
        gaps += [(max_err([p.grad], [q.grad]) / largest, "T." + name)
                 for (name, p), q in zip(a[1].named_parameters(),
                                         b[1].parameters())]
        return max(gaps)

    lk, nk, ck, (_, xk) = run(False)
    lp, np_, cp, (_, xp) = run(True)
    ls, ns, _, _ = run(True, (None, xk))
    want = {name: 0 for name in COUNTERS}
    want.update(mine_step_launches(cfg))
    check_launches("f32 MINE step", ck, with_narrow(want))
    if sum(cp.values()):
        raise AssertionError(f"the plain MINE step launched {cp}")
    if not len(xk) == len(xp) > 0:
        raise AssertionError(f"{len(xk)} and {len(xp)} ReLU calls")
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xk, xp))
    rel = [abs(a - b) / abs(b) for a, b in zip(lk + lk, lp + ls)]
    same, own = grad_gap(nk, ns), grad_gap(nk, np_)
    print(f"[parity] f32 MINE step: (ce, mi) kernels {lk}, plain {lp}, plain "
          f"on the kernel run's ReLU decisions {ls} (rel "
          f"{', '.join(f'{r:.2e}' for r in rel)}); {len(xk)} ReLU calls, "
          f"{flips} inputs change sign between the paths; worst grad err / "
          f"max|ref| (transceiver and T) on the same ReLU decisions "
          f"{same[0]:.2e} ({same[1]}), on each path's own {own[0]:.2e} "
          f"({own[1]}); launches {json.dumps(ck)}")
    if not all(r <= 1e-5 for r in rel):
        raise AssertionError(f"f32 MINE step (ce, mi) {lk} vs plain {lp}, "
                             f"{ls}")
    if not same[0] <= 1e-4:
        raise AssertionError(f"f32 MINE step grad {same[1]}: {same[0]} > "
                             f"1e-4 of max|ref|")


# the resume phase: epochs of the straight run (the split run resumes at 2)
RESUME_EPOCHS = 3


def _checkpoint_payload(directory, epoch):
    return torch.load(os.path.join(directory, "transformer", str(epoch),
                                   "state.pt"), weights_only=True)


def phase_resume(seed, bs):
    """Exact resume through the graphed scan32 path at f32 with --ema-decay
    0.99 (32 divides the synthetic set's 64 batches an epoch): `cli train`
    for RESUME_EPOCHS epochs straight, and for 2 epochs then `--resume` to
    RESUME_EPOCHS (a fresh graph captured at epoch 2 from the restored
    state, params, Adam moments and device counts, EMA shadow and
    generator state); the last checkpoints must be bitwise equal in every
    tensor. -> the three runs' launch counts (per step as the
    default's)."""
    import shutil

    tag = "resume"
    straight, split = (f"log/chip_smoke/{tag}_{name}_ckpt"
                       for name in ("straight", "split"))
    for d in (straight, split):
        shutil.rmtree(d, ignore_errors=True)
    common = ["train", "--variant", "transformer", "--dtype", "float32",
              "--bs", str(bs), "--seed", str(seed), "--device", "cuda",
              "--ema-decay", "0.99", "--ckpt-every", "1", "--log-every",
              "64", "--log-save-path", f"log/chip_smoke/{tag}"]
    reset_launches()
    t0 = time.perf_counter()
    runs = [cli.main(common + ["--checkpoint-path", ckpt, *extra])
            for ckpt, extra in (
                (straight, ["--epochs", str(RESUME_EPOCHS)]),
                (split, ["--epochs", "2"]),
                (split, ["--epochs", str(RESUME_EPOCHS), "--resume"]))]
    wall = time.perf_counter() - t0
    got = launches()
    cfg = Config()
    n = sum(r["steps"] for r in runs)
    per_step = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
    expected = {name: 0 for name in COUNTERS}
    expected.update({attn.KERNEL: per_step * n, attn.KERNEL_BWD: per_step * n,
                     **ce_routes(torch.float32, cfg.decoder_d_model, n, n)})
    check_launches(tag, got, with_narrow(expected))
    if [r["path"] for r in runs] != [f"scan{SCAN_STEPS}"] * 3 or \
            runs[2]["start_epoch"] != 2:
        raise AssertionError(f"{tag}: paths {[r['path'] for r in runs]}, "
                             f"resumed at {runs[2]['start_epoch']}")
    a = _checkpoint_payload(straight, RESUME_EPOCHS)
    b = _checkpoint_payload(split, RESUME_EPOCHS)
    differ = [] if a.keys() == b.keys() else ["keys"]
    tensors = 0
    for key in a:
        if isinstance(a[key], dict):
            for name in a[key]:
                tensors += 1
                if not torch.equal(a[key][name], b[key][name]):
                    differ.append(f"{key}/{name}")
        elif a[key] != b[key]:
            differ.append(key)
    print(f"[{tag}] f32 graphed, EMA 0.99: {RESUME_EPOCHS} epochs straight "
          f"({runs[0]['steps']} steps) against 2 + --resume "
          f"({runs[1]['steps']} + {runs[2]['steps']}): {tensors} tensors "
          f"of the epoch-{RESUME_EPOCHS} checkpoint, update count "
          f"{a['step']}/{b['step']}; bitwise equal {not differ} "
          f"{differ[:5]}; wall {wall:.2f} s")
    if differ or "ema" not in a:
        raise AssertionError(f"{tag}: the resumed run differs from the "
                             f"straight one in {differ[:10]}")
    return got


LEVERS_CORPUS = "log/chip_smoke/levers_corpus.pkl"
# the --profile run: one graphed epoch of this many steps
PROFILE_STEPS = 4


def write_corpus(path, n, seed):
    """A training pickle of `n` synthetic sentences (token lists, the
    `results`' data layout) made from `seed`."""
    cfg = Config()
    rows = synthetic_sentences(n, cfg.seq_len, cfg.vocab_size, seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump([row[row != 0].tolist() for row in rows], f)
    return path


def remat_graph_parity(seed, bs):
    """GRAPH_K f32 vanilla steps at full width (dropout 0.1) in one graphed
    call with remat (each layer recomputed in the backward inside the
    captured graph, its kept dropout masks read back) and one without,
    from the same init, batches and generator seed: the losses within rtol
    1e-6, the last step's gradients within 1e-6 of their largest, the
    generator's state equal after (whether bitwise printed); K1 twice as
    often with remat, K2 as often."""
    cfg = Config(dtype="float32", bs=bs)
    inps = _graph_batches(cfg, seed, GRAPH_K)
    n_std = float(snr_to_noise(cfg.train_snr))
    out = []
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        model = steps.init_params(variant_model(c, "transformer"),
                                  seed).cuda().train()
        state = steps.create_train_state(model, c)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        multi = steps.make_train_multi_step(model, c)
        reset_launches()
        state, losses = multi(state, inps, inps, gen, n_std)
        torch.cuda.synchronize()
        out.append((losses, model, gen.get_state(), launches()))
    (lr, mr, gr, cr), (lp, mp, gp, cp) = out
    loss_err = ((lr - lp).abs() / lp.abs()).max().item()
    worst, worst_name = 0.0, ""
    bitwise = torch.equal(lr, lp)
    for (name, a), b in zip(mr.named_parameters(), mp.parameters()):
        err = max_err([a.grad], [b.grad], relative=True)
        bitwise = bitwise and torch.equal(a.grad, b.grad)
        if err > worst:
            worst, worst_name = err, name
    same_gen = torch.equal(gr, gp)
    print(f"[levers] f32 graphed remat, {GRAPH_K} steps: losses {lr.tolist()}"
          f" against {lp.tolist()} (max rel {loss_err:.2e}); worst grad err"
          f" / max|ref| {worst:.2e} ({worst_name}); bitwise equal {bitwise};"
          f" generator state equal {same_gen}; K1/K2 launches "
          f"{cr[attn.KERNEL]}/{cr[attn.KERNEL_BWD]} against "
          f"{cp[attn.KERNEL]}/{cp[attn.KERNEL_BWD]}")
    if not (loss_err <= 1e-6 and worst <= 1e-6 and same_gen):
        raise AssertionError(f"graphed remat steps differ: loss {loss_err}, "
                             f"{worst_name} {worst}, generator {same_gen}")
    if cr[attn.KERNEL] != 2 * cp[attn.KERNEL] or \
            cr[attn.KERNEL_BWD] != cp[attn.KERNEL_BWD]:
        raise AssertionError(f"remat launches {cr}, without {cp}")
    return {"bitwise": bitwise, "loss_rel_err": loss_err,
            "grad_err": worst}


# the levers' cost: batch sizes, and what each configuration switches on
LEVER_BS = (64, 1024)
LEVERS = ("default", "remat", "fuse_qkv")


def _peak_mib(fn):
    """MiB allocated at the peak of `fn()` above what was allocated before
    it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def levers_cost(seed):
    """What `--remat` and `--fuse-qkv` each change alone on the default
    train path (bf16, full width, vanilla), at each batch size of LEVER_BS:
    the peak memory of one eager step above the model and its optimizer
    state, the peak of the first graphed call of GRAPH_K steps (warm-up,
    capture and replays; the graph's pool in it), and the wall ms a step
    of GRAPH_RUNS graphed calls of GRAPH_TIMED_K steps, the three
    configurations taking turns within each run. -> {bs: {lever: ...}}."""
    out = {}
    for bs in LEVER_BS:
        cfg = Config(bs=bs)
        inps = _graph_batches(cfg, seed, GRAPH_TIMED_K)
        inps = inps.repeat(-(-GRAPH_TIMED_K // len(inps)), 1, 1)[
            :GRAPH_TIMED_K]
        n_std = float(snr_to_noise(cfg.train_snr))
        calls, got = {}, {}
        for lever in LEVERS:
            c = cfg if lever == "default" else cfg.replace(**{lever: True})
            model = steps.init_params(variant_model(c, "transformer"),
                                      seed).cuda().train()
            state = steps.create_train_state(model, c)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            step = steps.make_train_step(model, c)
            multi = steps.make_train_multi_step(model, c)
            eager = _peak_mib(lambda: step(state, inps[0], inps[0], gen,
                                           n_std))
            graph = _peak_mib(lambda: multi(state, inps[:GRAPH_K],
                                            inps[:GRAPH_K], gen, n_std))
            calls[lever] = (multi, state, gen)
            got[lever] = {"eager_step_peak_mib": eager,
                          "graphed_call_peak_mib": graph, "ms_per_step": []}
        for _ in range(GRAPH_RUNS):
            for lever, (multi, state, gen) in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                multi(state, inps, inps, gen, n_std)
                torch.cuda.synchronize()
                got[lever]["ms_per_step"].append(
                    (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED_K)
        print(f"[levers] bf16 bs {bs}, each lever alone, graphed: "
              f"{json.dumps(got)}")
        out[bs] = got
        del calls
        torch.cuda.empty_cache()
    return out


def phase_profile_run(seed, bs):
    """`cli train --profile DIR` for one bf16 epoch of PROFILE_STEPS steps
    through the graphed path (`--scan-steps PROFILE_STEPS` on a corpus of
    as many batches: the warm-up step, the capture and the replays all in
    the traced epoch): DIR/trace.json must hold 12 K1 kernels a step. ->
    its launch counts."""
    import shutil

    tag = "profile_run"
    trace_dir = f"log/chip_smoke/{tag}_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    corpus = write_corpus(f"log/chip_smoke/{tag}_corpus.pkl",
                          PROFILE_STEPS * bs, seed)
    reset_launches()
    res = cli.main(["train", "--variant", "transformer", "--dtype",
                    "bfloat16", "--bs", str(bs), "--seed", str(seed),
                    "--device", "cuda", "--epochs", "1", "--scan-steps",
                    str(PROFILE_STEPS), "--train-save-path", corpus,
                    "--profile", trace_dir, "--log-save-path",
                    f"log/chip_smoke/{tag}", "--checkpoint-path",
                    f"log/chip_smoke/{tag}_ckpt"])
    got = launches()
    cfg = Config()
    per_step = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
    n = res["steps"]
    expected = {name: 0 for name in COUNTERS}
    expected.update({attn.KERNEL: per_step * n, attn.KERNEL_BWD: per_step * n,
                     ce.KERNEL_FWD: n, ce.KERNEL_BWD: n})
    check_launches(tag, got, expected)
    path = os.path.join(trace_dir, "trace.json")
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    k1 = sum(_TRACE_NAMES[attn.KERNEL] in name for name in names)
    steps_traced = sum(name == "train_step" for name in names)
    print(f"[{tag}] path {res['path']}, {n} steps: {path} "
          f"{os.path.getsize(path)} bytes, {len(names)} events, "
          f"{steps_traced} train_step regions, {k1} K1 kernels (want "
          f"{per_step * n})")
    if res["path"] != f"scan{PROFILE_STEPS}" or k1 != per_step * n:
        raise AssertionError(f"{tag}: the trace holds {k1} K1 kernels, not "
                             f"{per_step * n}")
    return got


def phase_levers(seed, bs):
    """The training levers: one bf16 epoch of `cli train --remat
    --fuse-qkv --aug-crop 0.3 --aug-synth 0.3` from a random init on a
    corpus of 4,096 sentences written from `seed`, through the graphed
    scan32 path (K1 twice per attention a step: remat), its loss falling;
    then `remat_graph_parity`, `levers_cost` and `phase_profile_run`. ->
    (the levers run's launch counts, the profile run's, the parity's and
    the cost's numbers)."""
    corpus = write_corpus(LEVERS_CORPUS, 4096, seed)
    got, _ = phase_train(seed, 1, bs, extra=[
        "--remat", "--fuse-qkv", "--aug-crop", "0.3", "--aug-synth", "0.3",
        "--train-save-path", corpus], checkpoint="log/chip_smoke/levers_ckpt",
        tag="levers_train", k1_passes=2)
    numbers = {"remat_parity": remat_graph_parity(seed, bs),
               "cost": levers_cost(seed)}
    return got, phase_profile_run(seed, bs), numbers


# --- the evaluation metrics and the other commands -------------------------

BERT_DIR = "log/chip_smoke/bert_base"
# BERT-base's shape (bert-base-uncased's config.json), random weights
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512)
# the similarity calls also scored on the CPU: (batch index, SNR index)
SIM_CPU_CALLS = ((0, 0), (0, len(SNRS) - 1))
SIM_TOL = 1e-4


def write_bert_base(directory, seed):
    """A BERT-base-shaped checkpoint from `seed` in a Hugging Face
    directory: config.json, a vocab.txt of the specials then the identity
    vocab's words (so every transceiver word is one WordPiece), and
    model.safetensors written by hand (N(0, 0.02) matrices, LayerNorms at
    1 and 0, as BERT's initialiser)."""
    cfg = BertConfig(**BERT_BASE)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg.to_json(), f)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(4, Config().vocab_size)]
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    gen = torch.Generator().manual_seed(seed)
    tensors = {}
    for name, t in BertEncoder(cfg).state_dict().items():
        if "LayerNorm" in name:
            tensors["bert." + name] = (torch.ones_like(t) if name.endswith(
                "weight") else torch.zeros_like(t))
        else:
            tensors["bert." + name] = 0.02 * torch.randn(t.shape,
                                                         generator=gen)
    write_safetensors(os.path.join(directory, "model.safetensors"),
                      tensors)
    return sum(t.numel() for t in tensors.values())


def phase_similarity(seed, batches, bs):
    """`cli evaluate --metric both` (the KV greedy sweep on the trained
    weights, bf16) with DEEPSC_BERT_PATH at a BERT-base-shaped random
    checkpoint: the table [snr, BLEU, similarity], the BLEU column equal to
    the BLEU-only run's, the similarity column the mean of its calls'
    scores; the card's scores of SIM_CPU_CALLS within SIM_TOL of the CPU
    Similarity's on the same sentences; the BERT forward's device and wall
    time. -> the sweep's launch counts."""
    t0 = time.perf_counter()
    n_params = write_bert_base(BERT_DIR, seed)
    print(f"[similarity] BERT-base-shaped checkpoint, {n_params:,} params, "
          f"written in {time.perf_counter() - t0:.1f} s")
    calls = []
    score = metrics.Similarity.compute_score

    def recording(self, real, predicted):
        out = score(self, real, predicted)
        calls.append((list(real), list(predicted), out))
        return out

    flags = ["--eval-mode", "greedy", "--kv-cache"]
    encoder = dict({n: 0 for n in COUNTERS},
                   **{attn.KERNEL: Config().encoder_num_layer})
    os.environ["DEEPSC_BERT_PATH"] = BERT_DIR
    metrics.Similarity.compute_score = recording
    try:
        got, _, res, err = phase_serve("similarity", flags + [
            "--metric", "both"], seed, batches, bs, encoder, width=3)
    finally:
        metrics.Similarity.compute_score = score
        del os.environ["DEEPSC_BERT_PATH"]
    if "unavailable" in err:
        raise AssertionError("similarity: the BERT checkpoint was not used")
    _, _, bleu_only, _ = phase_serve("similarity_bleu", flags, seed,
                                     batches, bs, encoder)
    table = res["table"]
    if len(calls) != len(SNRS) * batches:
        raise AssertionError(f"similarity: {len(calls)} scorer calls, "
                             f"expected {len(SNRS) * batches}")
    for si, row in enumerate(table):
        # the sweep scores batch by batch, every SNR point of a batch
        mean = float(torch.tensor([x for c in calls[si::len(SNRS)]
                                   for x in c[2]],
                                  dtype=torch.float64).mean())
        if row[1] != bleu_only["table"][si][1] or abs(row[2] - mean) > 1e-12 \
                or not -1.0 - 1e-6 <= row[2] <= 1.0 + 1e-6:
            raise AssertionError(f"similarity: row {row} against BLEU "
                                 f"{bleu_only['table'][si]} and mean {mean}")
    print("[similarity] BERT similarity " + " ".join(
        f"{r[0]:.0f}dB={r[2]:.4f}" for r in table))
    t0 = time.perf_counter()
    cpu = metrics.Similarity(BERT_DIR, device="cpu")
    worst = 0.0
    for bi, si in SIM_CPU_CALLS:
        real, predicted, want = calls[bi * len(SNRS) + si]
        got_cpu = cpu.compute_score(real, predicted)
        worst = max(worst, max(abs(a - b) for a, b in zip(want, got_cpu)))
    print(f"[similarity] card vs CPU scores over {len(SIM_CPU_CALLS)} calls "
          f"of {bs} sentence pairs: max |diff| {worst:.3g} (tolerance "
          f"{SIM_TOL}; CPU {time.perf_counter() - t0:.1f} s)")
    if not worst <= SIM_TOL:
        raise AssertionError(f"similarity: card and CPU scores differ by "
                             f"{worst} > {SIM_TOL}")
    sim = metrics.Similarity(BERT_DIR, device="cuda")
    real, predicted, _ = calls[0]
    ids, mask = sim.tokenizer.encode_batch(real, sim.max_len)
    ids, mask = ids.cuda(), mask.cuda()

    def forward():
        with torch.inference_mode(), exact_f32_matmuls():
            sim.model(ids, mask)

    dev_ms, host_ms = cuda_ms(forward, 10)
    t0 = time.perf_counter()
    for _ in range(5):
        sim.compute_score(real, predicted)
    wall = (time.perf_counter() - t0) * 1e3 / 5
    print(f"[similarity] BERT-base forward of {len(real)} x {sim.max_len} "
          f"tokens, f32 without TF32: device {dev_ms:.3f} ms (host enqueue "
          f"{host_ms:.3f} ms); a compute_score call (two forwards, "
          f"tokenizing, normalising) wall {wall:.2f} ms")
    return got


TRANSMIT_TEXTS = ("w12 w345 w6789 w22000 w17, w4.",
                  "W901 w55 w56 w57 w58 w59 w60 w61?",
                  "w1000 w2000 w3000 w4000 w5000 w6000 w7000 w8000 w9000 "
                  "w10000 w11000 w12000 w13000 w14000 w15000 w16000 w17000 "
                  "w18000 w19000 w20000 w21000 w22000 w100 w200 w300 w400 "
                  "w500 w600 w700 w800 w900 w999 w998",
                  "w7 w8 w9")


def greedy_logits(model, cfg, inp, snr, noise):
    """The full-prefix greedy decode at one noise level with its f32 logits
    recorded: -> (ids (B, T+1), logits (B, T, V))."""
    seen = recorded_logits(model)
    ids = greedy.make_greedy_decode(model, cfg)(inp, 0.0, SNR_to_noise(snr),
                                                noise)
    return ids, torch.cat([x.float() for x in seen], dim=1)


def same_greedy_ids_but_near_ties(tag, got, want, got_logits, want_logits):
    """`same_ids_but_near_ties` for greedy decodes, whose later steps follow
    their own picks: each row is held up to its first differing step."""
    diff = got[:, 1:] != want[:, 1:]
    steps = diff.shape[1]
    first = torch.where(diff.any(1), diff.int().argmax(1), steps)
    keep = torch.arange(steps, device=got.device)[None] <= first[:, None]
    same_ids_but_near_ties(tag, torch.where(keep, got[:, 1:], want[:, 1:]),
                           want[:, 1:],
                           torch.where(keep[..., None], got_logits,
                                       want_logits), want_logits)


def phase_transmit(seed):
    """`cli transmit` at f32 on the trained weights, 6 dB: K1 launched
    encoder_num_layer + 2 decoder_num_layer max_length times (the
    full-prefix greedy decode at one noise level), and nothing else; the
    ids equal, but for near-ties, the plain versions' on the same draws;
    the CLI's ids equal its kernel decode's repeated outside the CLI. ->
    the launch counts."""
    cfg = Config()
    want = with_narrow(dict({n: 0 for n in COUNTERS}, **{
        attn.KERNEL: cfg.encoder_num_layer
        + 2 * cfg.decoder_num_layer * cfg.max_length}))
    argv = ["transmit", *VANILLA, "--dtype", "float32", "--seed", str(seed),
            "--snr", "6", "--device", "cuda"]
    for t in TRANSMIT_TEXTS:
        argv += ["--text", t]
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(argv)
    wall = time.perf_counter() - t0
    got = launches()
    check_launches("transmit", got, want)
    params = load_params_pickle(PARAMS)
    cfg = Config(dtype="float32", tie_embeddings=is_tied(params))
    inp = res["inp"].cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise, _ = draw_channel(gen, (inp.shape[0], cfg.seq_len,
                                  cfg.channel_dim))
    out = []
    for a in (attn.fused_attention, attn.attention_fwd_reference):
        model = load_into(make_model(cfg, attention=a), params).cuda().eval()
        out.append(greedy_logits(model, cfg, inp, 6.0, noise))
    if not torch.equal(out[0][0].cpu(), res["ids"]):
        raise AssertionError("transmit: the CLI's ids are not its kernel "
                             "decode's")
    same_greedy_ids_but_near_ties(
        f"transmit ({inp.shape[0]} sentences), K1 vs plain", out[0][0],
        out[1][0], out[0][1], out[1][1])
    for t, r in zip(res["texts"], res["received"]):
        print(f"[transmit] tx> {t}\n[transmit] rx> {r}")
    print(f"[transmit] wall {wall:.2f} s")
    return got


EXPORT_CALLS = ((4, 2), (3, 5))
EXPORT_DTYPES = ("float32", "bfloat16")
EXPORT_DIR = "log/chip_smoke/export"
EXPORT_TIMEOUT = 900
# run in a fresh interpreter: loads an artifact and calls it; torch only
EXPORT_LOADER = """
import json, sys, time, torch
art, inputs, out, report = sys.argv[1:5]
t0 = time.perf_counter()
program = torch.export.load(art).module()
t1 = time.perf_counter()
outs = [program(*x) for x in torch.load(inputs)]
torch.cuda.synchronize()
t2 = time.perf_counter()
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "deepsc_gan_tpu_torch", "deepsc_gan_tpu", "jax", "transformers"))
assert not bad, bad
torch.save(outs, out)
json.dump({"load_s": t1 - t0, "calls_s": t2 - t1}, open(report, "w"))
"""


def export_inputs(seed):
    """The artifacts' inputs at EXPORT_CALLS (sentences of the evaluation
    set, standard normals from a generator seeded with `seed`, SNR points
    0, 4, 8, ... dB), saved for the loader; -> them."""
    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inputs = []
    for b, s in EXPORT_CALLS:
        inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                           cfg.vocab_size, b, 1, seed)[0],
                              dtype=torch.long, device="cuda")
        noise = torch.randn((s, b, cfg.seq_len, cfg.channel_dim),
                            generator=gen, device="cuda")
        n_stds = torch.tensor([SNR_to_noise(x) for x in SNRS[::4][:s]],
                              dtype=torch.float32, device="cuda")
        inputs.append((inp, noise, torch.tensor(0.0, device="cuda"),
                       n_stds))
    os.makedirs(EXPORT_DIR, exist_ok=True)
    torch.save(inputs, os.path.join(EXPORT_DIR, "inputs.pt"))
    return inputs


def start_exports(seed):
    """Start, for each of EXPORT_DTYPES, `python3 -m deepsc_gan_tpu_torch.cli
    export` of the KV greedy sweep at full width on the trained weights
    (symbolic b and s), then a fresh python3 that imports only torch, loads
    the artifact and calls it at EXPORT_CALLS: one background shell each,
    tracing on its own core while the other phases run (a full-width
    export traces for minutes). -> {dtype: (process, its log, paths)}."""
    export_inputs(seed)
    jobs = {}
    for dtype in EXPORT_DTYPES:
        paths = {n: os.path.join(EXPORT_DIR, f"{n}_{dtype}{ext}")
                 for n, ext in (("kv", ".pt2"), ("outputs", ".pt"),
                                ("report", ".json"), ("log", ".log"))}
        export = [sys.executable, "-m", "deepsc_gan_tpu_torch.cli",
                  "export", *VANILLA, "--dtype", dtype, "--device", "cuda",
                  "--out", paths["kv"]]
        load = [sys.executable, "-c", EXPORT_LOADER, paths["kv"],
                os.path.join(EXPORT_DIR, "inputs.pt"), paths["outputs"],
                paths["report"]]
        log = open(paths["log"], "w")
        proc = subprocess.Popen(
            ["bash", "-c", f"{shlex.join(export)} && {shlex.join(load)}"],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        jobs[dtype] = (proc, log, paths)
    return jobs


def stop_exports(jobs):
    for proc, log, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


def phase_export(jobs):
    """Wait for the export jobs (`start_exports`); each artifact's ids at
    EXPORT_CALLS equal the eager plain-version KV sweep's on the same
    draws, f32 exactly, bf16 but for near-ties (judged on the eager
    full-prefix decoder's logits of the same prefix); the export seconds,
    the artifact's MB and the fresh process's load and call seconds."""
    params = load_params_pickle(PARAMS)
    inputs = torch.load(os.path.join(EXPORT_DIR, "inputs.pt"))
    for dtype, (proc, log, paths) in jobs.items():
        t0 = time.perf_counter()
        rc = proc.wait(timeout=EXPORT_TIMEOUT)
        waited = time.perf_counter() - t0
        log.flush()
        with open(paths["log"]) as f:
            text = f.read()
        print(text.strip())
        if rc:
            raise AssertionError(f"export {dtype}: the job exited {rc}")
        line = next(x for x in text.splitlines() if x.startswith("[export] "
                                                                   + EXPORT_DIR))
        seconds = float(re.search(r"; ([0-9.]+) s$", line).group(1))
        with open(paths["report"]) as f:
            report = json.load(f)
        outs = torch.load(paths["outputs"])
        cfg = Config(dtype=dtype, tie_embeddings=is_tied(params))
        model = load_into(make_model(cfg, attention=attn.plain_attention),
                          params).cuda().eval()
        sweep = make_greedy_decode_kv_sweep(model, cfg)
        for (inp, noise, _, n_stds), got in zip(inputs, outs):
            want = sweep(inp, 0.0, n_stds, noise)
            tag = (f"export {dtype}, artifact vs eager plain KV sweep at "
                   f"(B, S) = ({inp.shape[0]}, {n_stds.shape[0]})")
            if dtype == "float32" or torch.equal(got, want):
                same_ids(tag, got, want)
            else:
                export_near_ties(tag, model, cfg, inp, noise, n_stds, got,
                                 want)
        mb = os.path.getsize(paths["kv"]) / 1e6
        print(f"[export] {dtype}: {seconds:.1f} s to export and save, "
              f"{mb:.1f} MB; a fresh python3 (torch only) loaded it in "
              f"{report['load_s']:.1f} s and made {len(EXPORT_CALLS)} calls "
              f"in {report['calls_s']:.2f} s; this phase waited "
              f"{waited:.1f} s for the job")


def export_near_ties(tag, model, cfg, inp, noise, n_stds, got, want):
    """bf16 artifact ids against the eager ones where they differ: each
    row held up to its first differing step, where the two picks must be
    within 2 x TOL[bf16] of the largest logit of the eager full-prefix
    decoder run on the common prefix."""
    s, b = n_stds.shape[0], inp.shape[0]
    got, want = got.reshape(s * b, -1), want.reshape(s * b, -1)
    diff = got != want
    rows = diff.any(1).nonzero()[:, 0]
    with torch.inference_mode():
        mask = greedy.create_padding_mask(inp, cfg.pad_idx)
        tx = model.encode(inp, mask)
        y = model.transmit(tx[None], noise, n_stds.reshape(s, 1, 1, 1))
        mem = model.channel_decode(y.reshape((s * b,) + tx.shape[1:]))
        masks = mask.repeat(s, 1, 1, 1)
        causal = greedy.create_look_ahead_mask(want.shape[1], inp.device)
        for r in rows.tolist():
            j = int(diff[r].int().argmax())
            buf = want[r:r + 1].long().clone()
            buf[0, j:] = cfg.pad_idx
            comb = torch.maximum(greedy.create_padding_mask(buf, cfg.pad_idx),
                                 causal)
            h = model._semantic_decode(buf, mem[r:r + 1], comb,
                                       masks[r:r + 1], apply_final=False)
            logits = model.final_projection(h[:, j - 1])[0].float()
            gap = abs(float(logits[want[r, j]] - logits[got[r, j]]))
            limit = 2 * TOL[torch.bfloat16] * float(logits.abs().max())
            if gap > limit:
                raise AssertionError(f"{tag}: row {r} step {j}: picks "
                                     f"{int(want[r, j])} and {int(got[r, j])}"
                                     f" apart by {gap} > {limit}")
    print(f"[export] {tag}: {len(rows)} of {s * b} rows differ, each at a "
          f"near-tie of the eager logits")


BASELINE_SENTENCES = 256
BASELINE_WORDS = 2000
BASELINE_SNRS = (0, 6, 12, 18)


def write_baseline_sentences(path, seed):
    """BASELINE_SENTENCES sentences of 5 to 29 words drawn from `seed`,
    words Zipf-distributed over BASELINE_WORDS (p ~ 1 / rank)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, BASELINE_WORDS + 1)
    p /= p.sum()
    sents = [" ".join(f"w{int(i)}" for i in rng.choice(
        BASELINE_WORDS, size=int(rng.integers(5, 30)), p=p))
        for _ in range(BASELINE_SENTENCES)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(sents, f)
    return sents


def phase_baseline(seed):
    """`cli baseline` (64-QAM, block_k 512, 6 turbo iterations, PNR 10 dB)
    on BASELINE_SENTENCES Zipf sentences over BASELINE_SNRS, the BCJR on the
    card: the rows equal the port's pipeline run on the CPU on the same
    sentences and draws; clean BLEU 1.0 at the top SNR and the attacked
    column below the clean one there; seconds per SNR point; one BCJR
    call profiled."""
    data = "log/chip_smoke/baseline/sentences.pkl"
    sents = write_baseline_sentences(data, seed)
    snrs = ",".join(str(x) for x in BASELINE_SNRS)
    res = cli.main(["baseline", "--data", data, "--out",
                    "log/chip_smoke/baseline/classical.pkl", "--snrs", snrs,
                    "--baseline-seed", str(seed), "--device", "cuda"])
    rows = res["rows"]
    t0 = time.perf_counter()
    want = classical_sweep(sents, BASELINE_SNRS, seed=seed, device="cpu",
                           verbose=False)
    cpu_s = time.perf_counter() - t0
    print(f"[baseline] rows [snr, attacked, clean]: {rows}")
    print(f"[baseline] card seconds per SNR point {res['seconds']}; the CPU "
          f"run {cpu_s:.1f} s for {len(BASELINE_SNRS)} points")
    if rows != want:
        raise AssertionError(f"baseline: card rows {rows} != CPU rows {want}")
    top = rows[-1]
    if top[2] != 1.0 or not top[1] < top[2]:
        raise AssertionError(f"baseline: at {top[0]} dB clean {top[2]} "
                             f"(want 1.0), attacked {top[1]}")
    llrs = [torch.randn((len(sents), 512), generator=torch.Generator(
        device="cuda").manual_seed(seed + i), device="cuda") for i in range(3)]
    turbo.bcjr(*llrs)
    profiled(f"baseline: one BCJR call, {len(sents)} blocks of 512",
             lambda: turbo.bcjr(*llrs))


PREPROCESS_LINES = (
    "<p>Résumé of the sitting; naïve, café?</p>",
    "The House rose and observed a minute' s silence.",
    "this is all in accordance with the principles that we have upheld!",
    "too short here",
)


def phase_preprocess(seed):
    """`cli preprocess` on a corpus the phase writes from `seed` (two
    files; tags, accents, punctuation, lengths in and out of range,
    duplicates): the vocab, train and test files read back; every id list
    decodes to its sentence's tokens; 90/10 by round."""
    rnd = random.Random(seed)
    words = [f"word{i}" for i in range(300)]
    root = "log/chip_smoke/preprocess"
    corpus = os.path.join(root, "en")
    os.makedirs(corpus, exist_ok=True)
    lines = list(PREPROCESS_LINES)
    for _ in range(400):
        n = rnd.randint(2, 34)
        lines.append(" ".join(rnd.choice(words) for _ in range(n))
                     + rnd.choice([".", "?", "!", ", ok.", ""]))
    lines += lines[:20]  # duplicates
    for k in range(2):
        with open(os.path.join(corpus, f"part{k}.txt"), "w") as f:
            f.write("\n".join(lines[k::2]))
    out = {n: os.path.join(root, f) for n, f in (
        ("vocab", "vocab.json"), ("train", "train.pkl"), ("test", "test.pkl"))}
    cli.main(["preprocess", "--input-data-dir", corpus, "--output-vocab",
              out["vocab"], "--output-train-dir", out["train"],
              "--output-test-dir", out["test"], "--device", "cuda"])
    vocab = Vocab.load(out["vocab"])
    with open(out["train"], "rb") as f:
        train = pickle.load(f)
    with open(out["test"], "rb") as f:
        test = pickle.load(f)
    sents = preprocess.dedupe(
        s for k in range(2) for s in preprocess.process_file(
            os.path.join(corpus, f"part{k}.txt")))
    toks = [preprocess.tokenize(s, punct_to_keep=preprocess.PUNCT_TO_KEEP,
                                punct_to_remove=preprocess.PUNCT_TO_REMOVE)
            for s in sents]
    if [vocab.decode(ids, stop_at_end=False) for ids in train + test] \
            != toks or len(train) != round(0.9 * len(toks)):
        raise AssertionError("preprocess: the outputs do not round-trip")
    print(f"[preprocess] {len(lines)} lines -> {len(toks)} sentences "
          f"({len(train)} train, {len(test)} test), vocab {len(vocab)}; "
          f"round trip ok")


# ---------------------------------------------------------------------------
# The native passes and the parallel runs (deepsc_gan_tpu_torch/native/,
# deepsc_gan_tpu_torch/parallel/)

NATIVE_REPEATS = 5


def phase_native(seed, bs):
    """The native library built with g++ (a failed build fails the run);
    one bf16 full-prefix greedy sweep call on the trained weights (one
    batch, 19 SNRs) decoded to sentences and scored by BleuScore both ways:
    the scores equal (within 1e-12), and the host seconds of each way."""
    path = native.build()
    if not native.available():
        raise AssertionError("the native library did not load")
    print(f"[native] built {path.relative_to(os.getcwd())}")
    params = load_params_pickle(PARAMS)
    cfg = Config(bs=bs, tie_embeddings=is_tied(params))
    model = load_into(make_model(cfg), params).cuda().eval()
    inp = eval_batches(cfg.test_save_path, cfg.seq_len, cfg.vocab_size, bs,
                       1, seed)[0]
    n_stds = torch.tensor([SNR_to_noise(s) for s in SNRS],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((len(SNRS), bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    ids = make_greedy_decode_sweep(model, cfg)(
        torch.as_tensor(inp, dtype=torch.long, device="cuda"), 0.0, n_stds,
        noise).cpu().numpy()
    s2t = SeqToText(Vocab.identity(cfg.vocab_size), cfg.end_idx)
    ref = [s2t.sequence_to_text(row[1:]) for row in inp] * len(SNRS)
    hyp = [s2t.sequence_to_text(row[1:]) for point in ids for row in point]
    scores, seconds = {}, {}
    for way in (True, False):
        scorer = metrics.BleuScore(1.0, 0.0, 0.0, 0.0, native=way)
        best = math.inf
        for _ in range(NATIVE_REPEATS):
            t0 = time.perf_counter()
            scores[way] = scorer.compute_score(ref, hyp)
            best = min(best, time.perf_counter() - t0)
        seconds[way] = best
    err = max_err([torch.tensor(scores[True], dtype=torch.float64)],
                  [torch.tensor(scores[False], dtype=torch.float64)])
    print(f"[native] BLEU of one greedy sweep call ({len(hyp)} sentence "
          f"pairs): native {seconds[True] * 1e3:.3f} ms, Python "
          f"{seconds[False] * 1e3:.3f} ms on the host (best of "
          f"{NATIVE_REPEATS}; {CARD['smi']}); mean BLEU "
          f"{np.mean(scores[True]):.6f}, max |native - Python| {err:.2e}")
    if not err <= 1e-12:
        raise AssertionError(f"native BLEU differs from the Python path by "
                             f"{err}")
    return {"native_ms": seconds[True] * 1e3,
            "python_ms": seconds[False] * 1e3, "pairs": len(hyp)}


DP_RANKS = 2
DP_STEPS = 2
DP_TIMED_STEPS = 10
DP_VARIANT = {"plain": "transformer", "attack": "transformer", "gan": "gan",
              "mine": "transformer", "star": "star"}
# f32: the losses within DP_TOL relative; the gradients (averaged over
# the ranks, as Adam takes them) and the params after the steps within
# DP_TOL of their norm. Held by norm, not element by element: Adam's step
# of an element whose gradient is near its rounding level is decided by
# the gradient's last bits (at full width 3.8 % of the elements have
# 0 < |g| < 1e-6), so two sum orders move such elements apart by up to
# 2 lr, a local effect the norm shows at its size; a missing cross-rank
# term moves every element and reads 1e-2 or more. MINE's T is held by its
# gradients alone: the DV bound is blind to a shift of T, so its output
# bias's gradient is 0 up to rounding and Adam moves it +-lr by the
# rounding's sign (1.1e-4 of T's norm after one step, its gradients 4e-6:
# this phase on an H100, PERF.md §6); its params' gap is printed.
DP_TOL = 1e-4
# bf16 plain steps: the losses within this relative gap. Two half-batches
# may round apart from one batch in bf16; on the card the second step's
# loss read 9.7e-6 apart (this phase on an H100, PERF.md §6), and a
# missing cross-rank term reads 1e-2 or more
DP_BF16_LOSS_TOL = 1e-3
SNR_PARALLEL_POINTS = (0, 6, 12, 18)


def _dp_step(mode, model, mine, cfg, mesh, star_target):
    if mesh is None:
        return {"plain": lambda: steps.make_train_step(
                    model, cfg, full_target=star_target),
                "star": lambda: steps.make_train_step(
                    model, cfg, full_target=star_target),
                "attack": lambda: steps.make_train_attack_step(
                    model, cfg, adv_weight=0.5),
                "gan": lambda: gan_steps.make_gan_train_step(model, cfg),
                "mine": lambda: mine_steps.make_mine_train_step(
                    model, mine, cfg)}[mode]()
    return {"plain": lambda: sharding.make_parallel_train_step(
                model, cfg, mesh, full_target=star_target),
            "star": lambda: sharding.make_parallel_train_step(
                model, cfg, mesh, full_target=star_target),
            "attack": lambda: sharding.make_parallel_attack_step(
                model, cfg, mesh, adv_weight=0.5),
            "gan": lambda: sharding.make_parallel_gan_step(model, cfg, mesh),
            "mine": lambda: sharding.make_parallel_mine_step(
                model, mine, cfg, mesh)}[mode]()


def _grad_recorder(prefix, module, grads):
    """An optimizer pre-step hook: `module`'s gradients of the last update
    (host copies)."""

    def hook(opt, args, kwargs):
        for name, p in module.named_parameters():
            if p.grad is not None:
                grads[prefix + name] = p.grad.detach().float().cpu()

    return hook


def _spread(module, mesh):
    """The largest gap between this rank's parameters and the dp group's
    first rank's (0 on every rank when they are equal)."""
    worst = torch.zeros((), device="cuda")
    src = dist.get_global_rank(mesh.dp_group, 0)
    for p in module.parameters():
        first = p.detach().clone()
        dist.broadcast(first, src=src, group=mesh.dp_group)
        worst = torch.maximum(worst, (first - p.detach()).abs().max())
    return float(worst)


def dp_run(mode, dtype, seed, bs, n_steps, mesh=None, full=True):
    """`n_steps` steps of `mode` at the main model's full width (star: the
    single-block star codec) in `dtype`, from a random init (`seed`), on
    the first batches of the synthetic training set; single-process or
    data-parallel over `mesh`. -> {"losses", "counts", "params", "mine",
    "grads" (host copies; when `full`), "spread" (dp)}."""
    variant = DP_VARIANT[mode]
    cfg = Config(dtype=dtype, bs=bs, seq_len=default_seq_len(variant))
    model = steps.init_params(make_model(cfg, variant), seed).cuda().train()
    if mesh is not None:
        sharding.replicate(model, mesh)
    state = steps.create_train_state(model, cfg)
    mine = mine_state = None
    if mode == "mine":
        mine, mine_state = mine_steps.create_mine_state(cfg, seed,
                                                        device="cuda")
        if mesh is not None:
            sharding.replicate(mine, mesh)
    step = _dp_step(mode, model, mine, cfg, mesh, is_star(variant))
    grads = {}
    state.optimizer.register_step_pre_hook(_grad_recorder("", model, grads))
    if mine is not None:
        mine_state.optimizer.register_step_pre_hook(
            _grad_recorder("T.", mine, grads))
    data = iter(load_train_dataset(cfg, seed))
    batches = [torch.from_numpy(next(data)[0]).to("cuda", torch.long)
               for _ in range(n_steps)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    losses = []
    reset_launches()
    for inp in batches:
        if mode in ("plain", "star"):
            state, out = step(state, inp, inp, gen, n_std)
        elif mode == "attack":
            state, out = step(state, inp, inp, gen, 0.0, n_std, 1.0)
        elif mode == "gan":
            state, out = step(state, inp, inp, gen, n_std)
        else:
            state, mine_state, out = step(state, mine_state, inp, inp, gen,
                                          n_std)
        losses.append(out)
    torch.cuda.synchronize()
    got = {"counts": launches(),
           "losses": [[float(x) for x in (out if isinstance(out, tuple)
                                          else (out,))] for out in losses]}
    if mesh is not None:
        got["spread"] = max(_spread(model, mesh), _spread(mine, mesh)
                            if mine is not None else 0.0)
    if full:
        got.update(
            params={n: p.detach().float().cpu()
                    for n, p in model.named_parameters()},
            mine=None if mine is None else {
                n: p.detach().float().cpu()
                for n, p in mine.named_parameters()},
            grads=grads)
    return got


def dp_step_ms(seed, bs, mesh=None):
    """Wall ms a step (host clock, the card synchronized at both ends) of
    DP_TIMED_STEPS eager bf16 plain steps at full width after two warm-up
    steps; single-process or data-parallel over `mesh`."""
    cfg = Config(bs=bs)
    model = steps.init_params(make_model(cfg), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = _dp_step("plain", model, None, cfg, mesh, False)
    data = iter(load_train_dataset(cfg, seed))
    inp = torch.from_numpy(next(data)[0]).to("cuda", torch.long)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    for _ in range(2):
        step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED_STEPS):
        step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS


def snr_sweeps(seed, bs, mesh=None):
    """The f32 greedy, KV and beam sweeps on the trained weights over
    SNR_PARALLEL_POINTS, one batch, the noise drawn from `seed`;
    single-process or split over the mesh's snr axis. -> {sweep: (ids,
    launch counts)}."""
    params = load_params_pickle(PARAMS)
    cfg = Config(dtype="float32", bs=bs, tie_embeddings=is_tied(params))
    model = load_into(make_model(cfg), params).cuda().eval()
    inp = torch.as_tensor(eval_batches(cfg.test_save_path, cfg.seq_len,
                                       cfg.vocab_size, bs, 1, seed)[0],
                          dtype=torch.long, device="cuda")
    points = SNR_PARALLEL_POINTS
    n_stds = torch.tensor([SNR_to_noise(s) for s in points],
                          dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((len(points), bs, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    if mesh is None:
        sweeps = {"greedy": make_greedy_decode_sweep(model, cfg),
                  "kv": make_greedy_decode_kv_sweep(model, cfg),
                  "beam": make_beam_decode_sweep(model, cfg, BEAM)}
    else:
        sweeps = {"greedy": sharding.make_parallel_greedy_sweep(model, cfg,
                                                                mesh),
                  "kv": sharding.make_parallel_greedy_kv_sweep(model, cfg,
                                                               mesh),
                  "beam": sharding.make_parallel_beam_sweep(model, cfg, mesh,
                                                            BEAM)}
    out = {}
    for name, sweep in sweeps.items():
        reset_launches()
        ids = sweep(inp, 0.0, n_stds, noise).cpu()
        out[name] = (ids, launches())
    return out


def parallel_rank(rank, spec):
    """One rank of the dp or snr_parallel phase's group (spawned by
    `run_ranks`): the runs of `spec["runs"]` (dp_run over a dp mesh of
    every rank), the step timing, and the SNR-parallel sweeps over an snr
    mesh. Full host copies come back from rank 0 only."""
    backend = pmesh.initialize_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": backend, "world": pmesh.world_size(),
           "device": str(torch.cuda.current_device()), "runs": {}}
    if spec.get("runs") or spec.get("timing"):
        mesh = pmesh.make_mesh(dp=pmesh.world_size())
        for key, kw in spec.get("runs", {}).items():
            out["runs"][key] = dp_run(mesh=mesh, full=rank == 0, **kw)
        if spec.get("timing"):
            out["ms"] = dp_step_ms(mesh=mesh, **spec["timing"])
    if spec.get("sweeps"):
        mesh = pmesh.make_mesh(dp=1, snr=pmesh.world_size())
        out["sweeps"] = snr_sweeps(mesh=mesh, **spec["sweeps"])
    return out


def _norm_gap(got, want):
    """||got - want|| / ||want|| over the tensors of two name -> tensor
    maps (f64 sums), and the largest |got - want| over the largest
    |want|."""
    diff = sum(float(((got[n].double() - w.double()) ** 2).sum())
               for n, w in want.items())
    norm = sum(float((w.double() ** 2).sum()) for w in want.values())
    worst = max(float((got[n] - w).abs().max()) for n, w in want.items())
    return (diff / max(norm, 1e-300)) ** 0.5, worst / max(
        float(w.abs().max()) for w in want.values())


def dp_compare(tag, ref, got, tol):
    """A dp run against the single-process one at f32 (see DP_TOL); ->
    (the worst loss gap, the gradients' and each network's params' norm
    gaps)."""
    lr = np.asarray(ref["losses"], np.float64)
    lg = np.asarray(got["losses"], np.float64)
    loss_gap = float(np.max(np.abs(lg - lr) / np.abs(lr)))
    grads = {n: g for n, g in ref["grads"].items() if not n.startswith("T.")}
    gaps = {"grads": _norm_gap(got["grads"], grads),
            "params": _norm_gap(got["params"], ref["params"])}
    shown = {}
    if ref["mine"] is not None:
        gaps["T grads"] = _norm_gap(got["grads"], {
            n: g for n, g in ref["grads"].items() if n.startswith("T.")})
        shown["T params (not held)"] = _norm_gap(got["mine"], ref["mine"])
    print(f"[dp] {tag}: losses {lr.tolist()} vs {lg.tolist()} (worst rel "
          f"{loss_gap:.2e}); " + "; ".join(
              f"{name} gap / norm {g[0]:.2e} (largest element gap / "
              f"largest value {g[1]:.2e})"
              for name, g in {**gaps, **shown}.items()))
    if not (loss_gap <= tol and all(g[0] <= tol for g in gaps.values())):
        raise AssertionError(f"dp {tag}: loss {loss_gap}, norm gaps "
                             f"{ {k: g[0] for k, g in gaps.items()} }")
    return loss_gap, gaps


def _check_rank_counts(tag, ref, got, trained):
    """Each rank launched what the single-process step launches a step
    (its rows are half the batch; the launches are as many), every kernel
    of `trained` among them."""
    if got["counts"] != ref["counts"] or not all(
            got["counts"][k] > 0 for k in trained):
        raise AssertionError(f"dp {tag}: rank launches {got['counts']}, "
                             f"single {ref['counts']}")


def phase_dp(seed, bs):
    """DP_RANKS ranks on the one card over the backend `parallel/mesh.py`
    chooses (gloo: they share the card), at the main model's full width,
    global batch `bs`: DP_STEPS f32 plain steps, and one f32 FGM (adv
    weight 0.5, PNR 0 dB), GAN, MINE and star step, each against the
    single-process step on the card (DP_TOL), every rank's launches equal
    to the single step's (K1-K4; K5 for star) and every rank ending with
    the same parameters; DP_STEPS bf16 plain steps, the losses within
    DP_BF16_LOSS_TOL; one f32 plain step in a one-rank group (NCCL: a card
    of its own) against the single step; the dp step's ms against the
    single step's. -> the launches of every rank's runs, summed."""
    runs = {f"{mode}_f32": dict(mode=mode, dtype="float32", seed=seed,
                                bs=bs, n_steps=DP_STEPS if mode == "plain"
                                else 1) for mode in DP_VARIANT}
    runs["plain_bf16"] = dict(mode="plain", dtype="bfloat16", seed=seed,
                              bs=bs, n_steps=DP_STEPS)
    refs = {key: dp_run(**kw) for key, kw in runs.items()}
    single_ms = dp_step_ms(seed, bs)
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, DP_RANKS,
                      {"runs": runs, "timing": dict(seed=seed, bs=bs)})
    print(f"[dp] {DP_RANKS} ranks spawned and run: "
          f"{time.perf_counter() - t0:.1f} s")
    backends = {r["backend"] for r in ranks}
    print(f"[dp] backend {backends} for {DP_RANKS} ranks on "
          f"{torch.cuda.device_count()} card(s) (parallel/mesh.py: NCCL "
          f"where every rank has a card of its own, else gloo); devices "
          f"{[r['device'] for r in ranks]}")
    if backends != {"nccl" if DP_RANKS <= torch.cuda.device_count()
                    else "gloo"}:
        raise AssertionError(f"dp backend {backends}")
    total = {name: 0 for name in COUNTERS}
    for key, ref in refs.items():
        mode = runs[key]["mode"]
        trained = ((star.KERNEL,) if mode == "star" else
                   (attn.KERNEL, attn.KERNEL_BWD))
        if mode != "mine":
            trained += (ce.KERNEL_FWD, ce.KERNEL_BWD)
        for r, out in enumerate(ranks):
            got = out["runs"][key]
            _check_rank_counts(f"{key} rank {r}", ref, got, trained)
            total = _sum_counts(total, got["counts"])
            if got["spread"] != 0.0:
                raise AssertionError(f"dp {key}: rank {r}'s parameters "
                                     f"differ from rank 0's by "
                                     f"{got['spread']}")
        got = ranks[0]["runs"][key]
        if runs[key]["dtype"] == "float32":
            dp_compare(key, ref, got, DP_TOL)
            continue
        lr = np.asarray(ref["losses"], np.float64)[:, 0]
        lg = np.asarray(got["losses"], np.float64)[:, 0]
        gap = float(np.max(np.abs(lg - lr) / np.abs(lr)))
        print(f"[dp] {key}: losses {lr.tolist()} vs {lg.tolist()} (worst "
              f"rel {gap:.2e}, tolerance {DP_BF16_LOSS_TOL})")
        if not gap <= DP_BF16_LOSS_TOL:
            raise AssertionError(f"dp {key}: loss gap {gap}")
    print(f"[dp] launches of every rank's runs: {json.dumps(total)}")
    ms = [r["ms"] for r in ranks]
    print(f"[dp] bf16 plain eager step at full width, global batch {bs}: "
          f"dp {DP_RANKS} ranks {max(ms):.3f} ms a step (ranks "
          f"{', '.join(f'{m:.3f}' for m in ms)}), single process "
          f"{single_ms:.3f} ms ({CARD['smi']}); on one card the ranks "
          f"share it, so the gap is the collectives' overhead (gloo through "
          f"the host), not scaling")
    one = run_ranks(parallel_rank, 1, {"runs": {"plain_f32": runs[
        "plain_f32"]}})[0]
    print(f"[dp] one-rank group: backend {one['backend']}")
    if one["backend"] != "nccl":
        raise AssertionError(f"one-rank group on {one['backend']}")
    _check_rank_counts("plain_f32 nccl", refs["plain_f32"],
                       one["runs"]["plain_f32"], (attn.KERNEL,))
    dp_compare("plain_f32, one-rank NCCL group", refs["plain_f32"],
               one["runs"]["plain_f32"], DP_TOL)
    return total, {"dp_ms": max(ms), "single_ms": single_ms}


def phase_snr_parallel(seed, bs):
    """DP_RANKS ranks on the card, the f32 greedy, KV and beam sweeps over
    SNR_PARALLEL_POINTS split over them: the gathered ids equal the
    single-process sweeps'; each rank launched K1 (and K6 for the beam).
    -> the launches of every rank's sweeps, summed."""
    ref = snr_sweeps(seed, bs)
    ranks = run_ranks(parallel_rank, DP_RANKS,
                      {"sweeps": dict(seed=seed, bs=bs)})
    total = {name: 0 for name in COUNTERS}
    for r, out in enumerate(ranks):
        for name, (ids, counts) in out["sweeps"].items():
            same_ids(f"snr_parallel {name} rank {r} ({len(SNR_PARALLEL_POINTS)}"
                     f" SNRs over {DP_RANKS} ranks)", ids, ref[name][0])
            want = (attn.KERNEL,) + ((topk.KERNEL,) if name == "beam"
                                     else ())
            if not all(counts[k] > 0 for k in want):
                raise AssertionError(f"snr_parallel {name} rank {r}: "
                                     f"launches {counts}")
            total = _sum_counts(total, counts)
    print(f"[snr_parallel] launches of every rank's sweeps: "
          f"{json.dumps(total)}")
    return total


KERNEL_INFO = {
    attn.KERNEL: ("deepsc_gan_tpu/ops/pallas/attention.py:125",
                  "decoder_self", "serving: decoder self-attention, bf16, "
                  "N=19x64 Lq=Lk=31 H=8 Dh=16"),
    attn.KERNEL_BWD: ("deepsc_gan_tpu/ops/pallas/attention.py:147",
                      "train_decoder_self", "training: decoder "
                      "self-attention backward, bf16, N=64 Lq=Lk=31 H=8 "
                      "Dh=16, no dbias"),
    ce.KERNEL_FWD: ("deepsc_gan_tpu/ops/pallas/ce.py:95", "ce",
                    "training: N=1984 D=128 V=22234, bf16"),
    ce.KERNEL_BWD: ("deepsc_gan_tpu/ops/pallas/ce.py:166,189", "ce",
                    "training: N=1984 D=128 V=22234, bf16"),
    star.KERNEL: ("deepsc_gan_tpu/ops/pallas/star.py:107", "star_sweep",
                  "star serving: decoder satellite update, bf16, "
                  "B=19x64 L=31 D=128 H=8; bound from the unstacked ring's "
                  "bytes (6 N D + 2 B D elements)"),
    topk.KERNEL: ("deepsc_gan_tpu/ops/pallas/topk.py:94", "beam",
                  "beam: N=64x4 D=128 V=22234 k=4, bf16"),
}


# the wide kernels, by the kernel whose shapes they widen: (their
# source, the case of their bf16 row shown, what it is)
WIDE_INFO = {
    attn.KERNEL: (attn.KERNEL_WIDE_MMA, "wide_dec_self_8x25", "the wide "
                  "train path's decoder self-attention: K1 at 8 heads of "
                  "25, bf16, N=64 Lq=Lk=31 (the tensor-core wide kernels; "
                  "f32 on csrc/attention_tiled.cu, its own entry)"),
    attn.KERNEL_BWD: (attn.KERNEL_WIDE_MMA, "wide_dec_self_8x25", "the wide "
                      "train path's decoder self-attention backward: K2 at "
                      "8 heads of 25, bf16, N=64 Lq=Lk=31, no dbias (the "
                      "tensor-core wide kernels; f32 on "
                      "csrc/attention_bwd_tiled.cu, its own entry)"),
    ce.KERNEL_FWD: (ce.KERNEL_WIDE_FWD, "ce_d200", "the wide train path's "
                    "CE: K3 at N=1984 D=200 V=22234, bf16 (the tensor-core "
                    "wide kernel; every f32 K3 on csrc/ce_fwd_tiled.cu, its "
                    "own entry)"),
    ce.KERNEL_BWD: (ce.KERNEL_WIDE_BWD, "ce_d200", "the wide train path's "
                    "CE: K4 at N=1984 D=200 V=22234, bf16 (the tensor-core "
                    "wide kernels; every f32 K4 on csrc/ce_bwd_tiled.cu, "
                    "its own entry)"),
    star.KERNEL: (star.KERNEL_WIDE, "star_d96", "the wide star train "
                  "path's ring: K5 at B=64 L=31 D=96 H=8, bf16 (a group "
                  "of 12 lanes a row); `cases`: D = 512 (a warp a row) in "
                  "bf16, D = 96 and 512 in f32"),
    topk.KERNEL: (topk.KERNEL_WIDE_MMA, "wide_beam", "the wide beam path: "
                  "K6 at N=64x9 D=200 V=22234 k=9, bf16 (the tensor-core "
                  "wide kernel; k 65 to 256 its long path, f32 and bf16 "
                  "past it the select kernels, entries of their own); "
                  "`cases`: k = 16 and 64 at D = 200 and 512, N=64x4"),
}


def kernels_line(rows, by_path):
    """One entry per kernel, from its bf16 row at the path shape that
    matters most; `launches_by_path` counts each path's run (serve: the
    full-prefix greedy sweep, kv, beam, train, star_train, star_serve,
    fading: its three sweeps, attack_train, attack_eval: its five tables
    and decodes, long_len: the vanilla train epoch at seq_len LONG_SEQ,
    gan_train, gan_eval: its three tables and sweeps, gan_star: its
    training and its greedy_gan sweep, seq256: the train epoch at seq_len
    SEQ256, beam100: the beam-100 call, dp and snr_parallel: every rank's
    runs of phases 28 and 29) and `launches` their sum. K1's and
    K2's entries also hold their long-length row (`long`: N = 64, L =
    LONG_LEN), K4's its dh-only mode (`dh_only`: the K4 launches that ran
    in it, and its bf16 row at the training shape); the chunked K1/K2's and
    the wide K3/K4's hold in `cases` their rows at the wide-heads path's
    shapes."""
    out = []
    for kernel, (replaces, case, at) in KERNEL_INFO.items():
        row = next(r for r in rows if r["kernel"] == kernel
                   and r["case"] == case and r["dtype"] == "bfloat16")
        paths = {path: got[kernel] for path, got in by_path.items()}
        out.append({
            "name": kernel, "route": "cuda",
            **({"design": row["design"]} if "design" in row else {}),
            "source": f"deepsc_gan_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"], "at": at})
    for kernel in (attn.KERNEL, attn.KERNEL_BWD):
        row = next(r for r in rows if r["kernel"] == kernel
                   and r["case"] == LONG_CASE and r["dtype"] == "bfloat16"
                   and not r.get("dbias"))
        out[[e["name"] for e in out].index(kernel)]["long"] = {
            key: row[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms")}
        out[[e["name"] for e in out].index(kernel)]["long"]["at"] = (
            f"past 32 queries and keys: N={row['n']} Lq=Lk={LONG_LEN} H=8 "
            f"Dh=16, bf16" + ("; the resident kernel (its own entry); "
                              "library: SDPA backward" if kernel ==
                              attn.KERNEL_BWD else
                              "; the long-length kernel; library: SDPA"))
    # the resident K2 (csrc/attention_bwd_resident.cu): every K2 launch of
    # the seq-len-64 epoch
    row = next(r for r in rows if r["kernel"] == attn.KERNEL_BWD
               and r["case"] == LONG_CASE and r["dtype"] == "bfloat16"
               and not r["dbias"])
    n = by_path["long_len"][attn.KERNEL_BWD]
    out.append({
        "name": attn.KERNEL_RESIDENT, "route": "cuda",
        "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_RESIDENT}.cu",
        "replaces": KERNEL_INFO[attn.KERNEL_BWD][0], "launches": n,
        "launches_by_path": {"long_len": n}, **_timing(row),
        "cases": {label: _timing(next(
            r for r in rows if r["kernel"] == attn.KERNEL_BWD
            and r["case"] == label and r["dtype"] == "bfloat16"))
            for label in (LONG_CASE + "+dbias", LONG_CROSS[0],
                          LONG_CROSS[0] + "+dbias")},
        "at": f"the bf16 K2 past 32 queries or keys up to {attn.L_RES}: "
              f"N={row['n']} Lq=Lk={LONG_LEN} H=8 Dh=16, no dbias; `cases`: "
              f"with dbias, and {LONG_CROSS[1]} x {LONG_CROSS[2]} (the "
              f"seq-len-{LONG_SEQ} epoch's decoder cross-attention); "
              f"library: SDPA backward"})
    # the long-path K6 (csrc/topk_wide_mma.cu past k = 64):
    # every K6 launch of the beam-100 path
    row = next(r for r in rows if r["kernel"] == topk.KERNEL
               and r["case"] == "beam100" and r["dtype"] == "bfloat16")
    n = by_path["beam100"][LONG_LIST]
    out.append({
        "name": LONG_LIST, "route": "cuda", "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{topk.KERNEL_WIDE_MMA}.cu",
        "replaces": KERNEL_INFO[topk.KERNEL][0], "launches": n,
        "launches_by_path": {"beam100": n}, **_timing(row),
        "cases": {label: _timing(next(
            r for r in rows if r["kernel"] == topk.KERNEL
            and r["case"] == label and r["dtype"] == "bfloat16"))
            for label in [f"k{PAST_LIST_K}"] + [
                f"k{PAST_LIST_KS[-1]}_d{d}" for d in WIDE_D]},
        "at": f"the bf16 K6 past k = 64 (the long path): the "
              f"beam-100 path's call, N={row['n']} D={row['d']} V=22234 "
              f"k={BEAM100}; `cases`: k={PAST_LIST_K} at N=64x4 D=200, "
              f"k={PAST_LIST_KS[-1]} at D=200 and 512; library: torch.topk "
              f"+ logsumexp"})
    # the cluster K2 (csrc/attention_bwd_cluster.cu): every K2 launch of
    # the seq-len-256 epoch
    row = next(r for r in rows if r["kernel"] == attn.KERNEL_BWD
               and r["case"] == f"long_{PAST_RESIDENT}"
               and r["dtype"] == "bfloat16" and not r["dbias"])
    n = by_path["seq256"][CLUSTER]
    out.append({
        "name": attn.KERNEL_CLUSTER, "route": "cuda",
        "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_CLUSTER}.cu",
        "replaces": KERNEL_INFO[attn.KERNEL_BWD][0], "launches": n,
        "launches_by_path": {"seq256": n}, **_timing(row),
        "cases": {label: _timing(next(
            r for r in rows if r["kernel"] == attn.KERNEL_BWD
            and r["case"] == label and r["dtype"] == "bfloat16"))
            for label in [f"long_{PAST_RESIDENT}+dbias"] + [
                label for label, *_ in PAST_RESIDENT_CROSS] + [
                f"long_{CLUSTER_LEN}"]},
        "at": f"the bf16 K2 past {attn.L_RES} queries or keys up to "
              f"{attn.L_CLUSTER}: N={row['n']} Lq=Lk={PAST_RESIDENT} H=8 "
              f"Dh=16, no dbias (the seq-len-{SEQ256} epoch's encoder); "
              f"`cases`: with dbias, the epoch's decoder shapes, "
              f"{CLUSTER_LEN} x {CLUSTER_LEN}; library: SDPA backward"})
    # the select K6 (csrc/topk_select.cu): every K6 launch of the f32 wide
    # beam path
    f32_rows = {(r["kernel"], r["case"]): r for r in rows
                if r["dtype"] == "float32"}
    bf16_rows = {(r["kernel"], r["case"]): r for r in rows
                 if r["dtype"] == "bfloat16"}
    row = f32_rows[(topk.KERNEL, "wide_beam")]
    n = by_path["f32_wide_beam"][SELECT]
    cases = {f"{label}_float32": _timing(f32_rows[(topk.KERNEL, label)])
             for label in [f"k{k}_d{d}_dyadic" for d in WIDE_D
                           for k in SELECT_KS] + ["k_vocab_dyadic"]}
    cases.update({f"{label}_bfloat16": _timing(bf16_rows[(topk.KERNEL,
                                                          label)])
                  for label in (f"k{PAST_K6}_dyadic", f"v{PAST_V}_dyadic",
                                "k_vocab_dyadic")})
    out.append({
        "name": SELECT, "route": "cuda", "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{topk.KERNEL_SELECT}.cu",
        "replaces": KERNEL_INFO[topk.KERNEL][0], "launches": n,
        "launches_by_path": {"f32_wide_beam": n}, **_timing(row),
        "cases": cases,
        "at": f"every f32 K6 off the tuned shapes and the bf16 K6 past "
              f"k = 256 or V = 25,000 (the select kernels): the f32 wide "
              f"beam path's call, N={row['n']} D={row['d']} V=22234 "
              f"k={WIDE_BEAM}; `cases`: f32 at k = {SELECT_KS} and D = "
              f"{WIDE_D}, N=64x4, and k = V at N=64, D=128; bf16 at "
              f"k = {PAST_K6} (D=200), at V = {PAST_V} (k={PAST_LIST_K}, "
              f"D=128) and k = V; library: torch.topk + logsumexp"})
    # the tiled f32 K1 (csrc/attention_tiled.cu): every K1 launch of the
    # f32 wide paths
    row = f32_rows[(attn.KERNEL, WIDE_HEADS_PATH[0][0])]
    paths = {path: by_path[path][TILED]
             for path in F32_WIDE_PATHS + F32_TRAIN_PATHS}
    labels = [label for label, *_ in WIDE_HEADS_PATH + WIDE_PATH] + [
        f"wide_{heads}x{dh}" for heads, dh in WIDE_HEADS] + [
            OFF_STEP_HEADS[0]]
    out.append({
        "name": TILED, "route": "cuda", "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_TILED}.cu",
        "replaces": KERNEL_INFO[attn.KERNEL][0],
        "launches": sum(paths.values()), "launches_by_path": paths,
        **_timing(row),
        "cases": {label: _timing(f32_rows[(attn.KERNEL, label)])
                  for label in labels},
        "at": "every f32 K1 off the tuned head widths and counts (the "
              "tiled kernel): the wide-heads model's encoder, one head of "
              "512, N=64 Lq=Lk=32 shown; `cases`: its decoder (2 heads of "
              "320), the widened model's (8 heads of 64 and of 25), 8 "
              "heads of 24, 64, 128, 32 heads of 16 and one head of 300; "
              "library: SDPA (f32, no TF32)"})
    # the tiled f32 K2 (csrc/attention_bwd_tiled.cu): every K2 launch of
    # the f32 train paths
    row = f32_rows[(attn.KERNEL_BWD, WIDE_HEADS_PATH[0][0])]
    paths = {path: by_path[path][TILED_BWD] for path in F32_TRAIN_PATHS}
    out.append({
        "name": TILED_BWD, "route": "cuda", "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_BWD_TILED}.cu",
        "replaces": KERNEL_INFO[attn.KERNEL_BWD][0],
        "launches": sum(paths.values()), "launches_by_path": paths,
        **_timing(row),
        "cases": {label: _timing(f32_rows[(attn.KERNEL_BWD, label)])
                  for label in labels},
        "at": "every f32 K2 off the tuned head widths and counts (the "
              "tiled kernels), no dbias: the wide-heads model's encoder, "
              "one head of 512, N=64 Lq=Lk=32 shown; `cases`: the shapes "
              "of the tiled K1's entry; library: SDPA's backward (f32, no "
              "TF32)"})
    # the narrow f32 K1 and K2 (csrc/attention_narrow.cu): every f32 K1 and
    # K2 launch of the main model's paths (f32_train, resume, transmit)
    for name, kernel, labels in (
            (NARROW, attn.KERNEL,
             ["train_encoder", "train_decoder_cross"]
             + [label for label, *_ in TRAIN_SHAPES] + [LONG_CASE]),
            (NARROW_BWD, attn.KERNEL_BWD,
             [f"train_{label}{plus}" for label, *_ in TRAIN_SHAPES
              for plus in ("", "+dbias") if label != "decoder_self"
              or plus] + [LONG_CASE, LONG_CASE + "+dbias", LONG_CROSS[0],
                          LONG_CROSS[0] + "+dbias", "f32_k2_16x16"])):
        row = f32_rows[(kernel, "train_decoder_self")]
        paths = {path: got[name] for path, got in by_path.items()
                 if got.get(name)}
        out.append({
            "name": name, "route": "cuda", "design": row["design"],
            "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_NARROW}.cu",
            "replaces": KERNEL_INFO[kernel][0],
            "launches": sum(paths.values()), "launches_by_path": paths,
            **_timing(row),
            "cases": {label: _timing(f32_rows[(kernel, label)])
                      for label in labels},
            "at": "every f32 " + ("K1" if kernel == attn.KERNEL else "K2")
                  + " at the tuned heads (the narrow kernels): the main "
                  "model's decoder self-attention, 8 heads of 16, N=64 "
                  "Lq=Lk=31 shown; `cases`: the training path's other "
                  "shapes" + (
                      ", the serving path's (N=19x64) and 128 x 128; "
                      "library: SDPA (f32, no TF32)"
                      if kernel == attn.KERNEL else
                      " and each with dbias (+dbias), 128 x 128 and 63 x "
                      "64 (both ways), 16 heads of 16; library: SDPA's "
                      "backward (f32, no TF32)")})
    # the tuned f32 K6 on the 128 x 128 tile (csrc/topk.cu): every f32 K6
    # launch at k up to 8 and the tuned widths (the f32 beam sweep's)
    row = f32_rows[(topk.KERNEL, "beam_sweep")]
    paths = {path: got[TOPK_TILED] for path, got in by_path.items()
             if got.get(TOPK_TILED)}
    out.append({
        "name": TOPK_TILED, "route": "cuda", "design": row["design"],
        "source": f"deepsc_gan_tpu_torch/csrc/{topk.KERNEL}.cu",
        "replaces": KERNEL_INFO[topk.KERNEL][0],
        "launches": sum(paths.values()), "launches_by_path": paths,
        **_timing(row),
        "cases": {label: _timing(f32_rows[(topk.KERNEL, label)])
                  for label, *_ in tiled_topk_rows(
                      row["n"] // (len(SNRS) * BEAM))
                  if label != "beam_sweep"},
        "at": f"every f32 K6 at k up to 8 and D a multiple of 8 up to 256 "
              f"(the tuned kernel's 128 x 128 tile): the f32 beam sweep's "
              f"call, N={row['n']} D={row['d']} V=22234 k={BEAM} shown; "
              f"`cases`: the CLI's beam (N=64x4), k = 1 and 8, every logit "
              f"below 0, equal maxima, D = {WIDE_PATH_D}; library: "
              f"torch.topk + logsumexp"})
    # the tiled K4 (csrc/ce_bwd_tiled.cu) and K3 (csrc/ce_fwd_tiled.cu):
    # every f32 K4 and K3 launch of the paths (the f32 train epochs, the
    # resume run's)
    widths = [f"ce_d{d}" for d in (WIDE_PATH_D, WIDE_D[1], WIDE_HEADS_D,
                                   OFF_STEP_D, ODD_F32_D)]
    for name, kernel, source, labels in (
            (CE_TILED, ce.KERNEL_BWD, ce.KERNEL_BWD_TILED,
             widths + ["ce_dh_only", f"ce_dh_only_d{WIDE_HEADS_D}"]),
            (CE_TILED_FWD, ce.KERNEL_FWD, ce.KERNEL_FWD_TILED, widths)):
        row = f32_rows[(kernel, "ce")]
        paths = {path: got[name] for path, got in by_path.items()
                 if got.get(name)}
        out.append({
            "name": name, "route": "cuda", "design": row["design"],
            "source": f"deepsc_gan_tpu_torch/csrc/{source}.cu",
            "replaces": KERNEL_INFO[kernel][0],
            "launches": sum(paths.values()), "launches_by_path": paths,
            **_timing(row),
            "cases": {label: _timing(f32_rows[(kernel, label)])
                      for label in labels},
            "at": f"every f32 {'K4' if kernel == ce.KERNEL_BWD else 'K3'}: "
                  f"the main model's CE, N={row['n']} D={row['d']} V=22234, "
                  f"f32 shown; `cases`: D = {WIDE_PATH_D}, {WIDE_D[1]}, "
                  f"{WIDE_HEADS_D}, {OFF_STEP_D} and {ODD_F32_D}" + (
                      f", and the dh-only mode at D = {row['d']} and "
                      f"{WIDE_HEADS_D}; library: F.cross_entropy's backward "
                      f"(cuBLAS SGEMMs)" if kernel == ce.KERNEL_BWD else
                      "; library: F.cross_entropy over h @ W^T")})
    dh = next(r for r in rows if r["case"] == "ce_dh_only"
              and r["dtype"] == "bfloat16")
    paths = {path: got[DH_ONLY] for path, got in by_path.items()}
    out[[e["name"] for e in out].index(ce.KERNEL_BWD)]["dh_only"] = {
        "replaces": "deepsc_gan_tpu/ops/pallas/ce.py:166",
        "launches": sum(paths.values()), "launches_by_path": paths,
        **{key: dh[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")},
        "at": "attack training phase 1: N=1984 D=128 V=22234, bf16; "
              "library: F.cross_entropy's backward to h alone"}
    for kernel in (attn.KERNEL, attn.KERNEL_BWD):
        cases = {label: next(r for r in rows if r["kernel"] == kernel
                             and r["case"] == label
                             and r["dtype"] == "bfloat16"
                             and not r.get("dbias"))
                 for label, *_ in WIDE_HEADS_PATH}
        row = cases[WIDE_HEADS_PATH[0][0]]
        n = by_path["wide_heads"][WIDE[kernel]]
        out.append({
            "name": WIDE[kernel] + "_chunked", "route": "cuda",
            "design": row["design"],
            "source": f"deepsc_gan_tpu_torch/csrc/{attn.KERNEL_CHUNKED}.cu",
            "replaces": KERNEL_INFO[kernel][0], "launches": n,
            "launches_by_path": {"wide_heads": n}, **_timing(row),
            "cases": {label: _timing(r) for label, r in cases.items()},
            "at": "heads wider than 256 (the tensor-core chunked kernels) at "
                  "the wide-heads train path's shapes, bf16, N=64: its "
                  "encoder (one head of 512, Lq=Lk=32) shown; `cases`: the "
                  "encoder, the decoder's self (2 heads of 320, Lq=Lk=31) "
                  "and cross (Lq=31, Lk=32) attentions, each launched once a "
                  "layer" + (
                      ", no dbias (+dbias: with it); library: SDPA backward"
                      if kernel == attn.KERNEL_BWD else "; library: SDPA")})
        if kernel == attn.KERNEL_BWD:
            out[-1]["cases"].update({
                label + "+dbias": _timing(next(
                    r for r in rows if r["kernel"] == kernel
                    and r["case"] == label + "+dbias"
                    and r["dtype"] == "bfloat16"))
                for label, *_ in WIDE_HEADS_PATH})
    for kernel, (library, case, at) in WIDE_INFO.items():
        row = next(r for r in rows if r["kernel"] == kernel
                   and r["case"] == case and r["dtype"] == "bfloat16")
        # the wide-heads path's K1/K2 launches all ran the chunked kernels,
        # the beam-100 path's K6 the long lists, the f32 wide paths' K1 the
        # tiled kernel and their K6 the select kernels, the f32 train
        # paths' K1, K2, K3 and K4 the tiled kernels (their entries above),
        # the other paths' the register-held ones and the lists up to 64
        paths = {path: got[WIDE[kernel]] for path, got in by_path.items()
                 if (path != "wide_heads"
                     or kernel not in (attn.KERNEL, attn.KERNEL_BWD))
                 and (path != "beam100" or kernel != topk.KERNEL)
                 and (path not in F32_WIDE_PATHS
                      or kernel not in (attn.KERNEL, topk.KERNEL))
                 and path not in F32_TRAIN_PATHS}
        out.append({
            "name": WIDE[kernel], "route": "cuda", "design": row["design"],
            "source": f"deepsc_gan_tpu_torch/csrc/{library}.cu",
            "replaces": KERNEL_INFO[kernel][0],
            "launches": sum(paths.values()), "launches_by_path": paths,
            **_timing(row), "at": at})
        if kernel == topk.KERNEL:
            out[-1]["cases"] = {label: _timing(next(
                r for r in rows if r["kernel"] == kernel
                and r["case"] == label and r["dtype"] == "bfloat16"))
                for label in (f"k{k}_d{d}_dyadic" for d in WIDE_D
                              for k in WIDE_K if k != WIDE_BEAM)}
        if kernel == star.KERNEL:
            # the D = 512 rows in bf16, every wide row in f32
            out[-1]["cases"] = {
                f"{label}_{dtype}": _timing(next(
                    r for r in rows if r["kernel"] == kernel
                    and r["case"] == label and r["dtype"] == dtype))
                for label, dtype in [(f"star_d{WIDE_STAR_D[1]}",
                                      "bfloat16")] + [
                    (f"star_d{d}", "float32") for d in WIDE_STAR_D]}
        if kernel in (ce.KERNEL_FWD, ce.KERNEL_BWD):
            # the wide-heads path's CE runs at D = WIDE_HEADS_D; K4 also at
            # D = 512 and in its dh-only mode at WIDE_HEADS_D
            labels = [f"ce_d{d}" for d in WIDE_D if d != WIDE_PATH_D] + [
                f"ce_d{WIDE_HEADS_D}"]
            if kernel == ce.KERNEL_BWD:
                labels.append(f"ce_dh_only_d{WIDE_HEADS_D}")
            out[-1]["cases"] = {label: _timing(next(
                r for r in rows if r["kernel"] == kernel
                and r["case"] == label and r["dtype"] == "bfloat16"))
                for label in labels}
    return out


def _timing(row):
    """A kernel row's error, times and bound, as the kernels line gives
    them."""
    return {key: row[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "device_ms", "library_device_ms")}


# seconds of each phase of this run, by name (`timed`)
PHASE_SECONDS = {}


@contextlib.contextmanager
def timed(name):
    """Adds the block's seconds (host clock) to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
            + time.perf_counter() - t0


def run_phases(args, jobs, routes):
    """Phases 3 to 25 and 27 to 29; -> the kernels line's entries (their
    designs from `routes`, phase 26's)."""
    seed, bs = args.seed, args.bs
    with timed("kernels"):
        rows = phase_kernels(seed, len(SNRS) * bs, bs, args.iters)
        set_designs(rows, routes)
    with timed("serving"):
        by_path = phase_serving(seed, args.batches, bs)
        by_path["f32_beam_sweep"] = phase_f32_ids(seed, bs)
    with timed("train"):
        by_path["train"], _ = phase_train(seed, args.epochs, bs)
        phase_step_parity(seed, bs, counted=(NARROW, NARROW_BWD))
    with timed("star"):
        by_path["star_train"], _ = phase_train(seed, args.star_epochs, bs,
                                               "star", STAR_CKPT)
        phase_step_parity(seed, bs, "star")
        by_path["star_serve"] = phase_star_serving(seed, args.batches, bs)
        phase_star_f32_ids(seed, bs)
    with timed("fading"):
        by_path["fading"] = phase_fading(seed, args.batches, bs)
        phase_fading_f32_ids(seed, bs)
    with timed("attack"):
        by_path["attack_train"] = phase_attack_train(seed, ATTACK_EPOCHS,
                                                     bs)
        phase_attack_step_parity(seed, bs)
        by_path["attack_eval"] = phase_attack_eval(seed, args.batches, bs)
        phase_attack_f32(seed, bs)
    with timed("long"):
        by_path["long_len"], _ = phase_train(
            seed, 1, bs, extra=("--seq-len", str(LONG_SEQ)),
            checkpoint="log/chip_smoke/long_ckpt", tag="long_len")
        by_path["seq256"], seq256 = phase_train(
            seed, 1, bs, extra=("--seq-len", str(SEQ256)),
            checkpoint="log/chip_smoke/seq256_ckpt", tag="seq256",
            sub=((CLUSTER, attn.KERNEL_BWD),))
        print(f"[seq256] {seq256['ms_per_step']:.3f} ms a step over the "
              f"epoch of {seq256['steps']} steps (the graph's warm-up and "
              f"capture in it), bf16")
        by_path["beam100"], _ = phase_beam100(seed, bs)
    with timed("gan"):
        by_path["gan_train"], _ = phase_gan_train(seed, GAN_EPOCHS, bs)
        phase_gan_step_parity(seed, bs)
        by_path["gan_eval"] = phase_gan_eval(seed, args.batches, bs)
        phase_gan_f32_ids(seed, bs)
        by_path["gan_star"], _ = phase_gan_star(seed, GAN_EPOCHS,
                                                args.batches, bs)
    with timed("wide"):
        by_path["wide"] = phase_wide(seed, bs)
        by_path["wide_heads"] = phase_wide_heads(seed, bs)
    with timed("f32_wide"):
        by_path.update(phase_f32_wide(seed, bs))
    with timed("f32_wide_train"):
        by_path.update(phase_f32_wide_train(seed, bs))
    with timed("mine"):
        by_path["mine_train"] = phase_mine_train(seed, MINE_EPOCHS, bs)
        phase_mine_step_parity(seed, bs)
    with timed("native"):
        native_ms = phase_native(seed, bs)
    with timed("dp"):
        by_path["dp"], dp_ms = phase_dp(seed, bs)
    with timed("snr_parallel"):
        by_path["snr_parallel"] = phase_snr_parallel(seed, bs)
    print(f"[parallel] {json.dumps({'native': native_ms, 'dp': dp_ms})} "
          f"({CARD['smi']})")
    with timed("resume"):
        by_path["resume"] = phase_resume(seed, bs)
    with timed("levers"):
        by_path["levers"], by_path["profile_run"], levers = phase_levers(
            seed, bs)
        print(f"[levers] {json.dumps(levers)}")
    with timed("graph"):
        graph = phase_graph(seed, bs)
        print(f"[graph] {json.dumps(graph)}")
    with timed("profile"):
        phase_profile(seed, bs)
    t1 = time.perf_counter()
    with timed("similarity"):
        by_path["similarity"] = phase_similarity(seed, args.batches, bs)
    with timed("transmit"):
        by_path["transmit"] = phase_transmit(seed)
    with timed("baseline"):
        phase_baseline(seed)
    with timed("preprocess"):
        phase_preprocess(seed)
    with timed("export"):
        phase_export(jobs)
    print(f"[commands] similarity, transmit, baseline, preprocess and "
          f"export phases: {time.perf_counter() - t1:.1f} s")
    return kernels_line(rows, by_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--star-epochs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name = phase_device()
    with timed("build"):
        phase_build()
    with timed("routes"):
        routes = phase_routes(args.seed, args.bs)
    jobs = start_exports(args.seed)
    try:
        kernels = run_phases(args, jobs, routes)
    finally:
        stop_exports(jobs)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print("[phases] seconds " + json.dumps(
        {key: round(value, 1) for key, value in PHASE_SECONDS.items()}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
