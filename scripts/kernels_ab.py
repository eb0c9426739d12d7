#!/usr/bin/env python3
"""The port's kernels of two checkouts, timed in turns on one card.

    python3 scripts/kernels_ab.py OLD NEW
        [--cases ce,attention,attention_bwd,topk,star,wide_ce,
                 wide_heads_attention,wide_attention,wide_train,
                 wide_heads_train,wide_topk,long_attention_bwd,
                 wide_beam_eval,long_train,past_list_topk,
                 past_resident_bwd,beam100_eval,seq256_train,
                 select_topk,tiled_attention,f32_wide_beam_eval,
                 f32_wide_heads_eval,f32_wide_attention_bwd,
                 f32_wide_heads_train,f32_ce,f32_train,f32_wide_train,
                 f32_attention,f32_greedy_eval,f32_topk,star_wide]
        [--turns ABBA] [--iters 50]

OLD and NEW are roots of checkouts of the repo (for instance a parent commit
unpacked with `git archive <commit> chip_smoke.py deepsc_gan_tpu_torch` into
a directory that .gitignore lists, and `.`). Turn A runs OLD, turn B runs
NEW, each in a process of its own from its checkout's root, which builds
that checkout's kernels and runs its own `chip_smoke` cases, in bf16 and
f32: each kernel against its plain version, with the time per call between
CUDA events, the host's enqueue time, the plain version's time and the
library call's. Cases:
- `ce`: K3 and K4 at the training path's shape (N = 1,984, D = 128,
  V = 22,234);
- `attention`: K1 at the serving path's shapes (N = 19 x 64 = 1,216) and
  the training path's (N = 64), encoder (Lq = Lk = 32), decoder self
  (31, 31) and cross (31, 32) attention, 8 heads of 16;
- `attention_bwd`: K2 at the training path's shapes (N = 64, the three
  attentions above, no dbias);
- `topk`: K6 at the CLI's beam (N = 64 x 4 = 256) and the beam sweep's
  (N = 19 x 256 = 4,864), k = 4;
- `star`: the whole satellite update `StarAttention.satellite` (its
  projections, the contexts and K5) of a bf16 bank at D = 128, 8 heads,
  L = 31, on the star sweep decoder's B = 19 x 64 without autograd, and on
  the train step's B = 64 forward and backward. The update, not K5 alone,
  because K5's inputs may differ between checkouts (stacked contexts in
  older ones, the unstacked ring now); no plain version or library call;
- `wide_ce`: K3 and K4 in bf16 at widths the tuned kernels do not take,
  N = 1,984, V = 22,234: D = 200 (the wide train path's decoder), 512 and
  640 (the wide-heads path's), and K4's dh-only mode at D = 640;
- `wide_heads_attention`: K1 and K2 (no dbias) in bf16 at heads wider
  than 256, the wide-heads train path's shapes (N = 64;
  chip_smoke.WIDE_HEADS_PATH): its encoder (one head of 512, Lq = Lk = 32)
  and its decoder's self (2 heads of 320, 31 x 31) and cross (31 x 32)
  attentions;
- `wide_attention`: K1 and K2 (no dbias) in bf16 at the widened train
  path's shapes (N = 64; chip_smoke.WIDE_PATH): its encoder (8 heads of
  64, Lq = Lk = 32) and its decoder's self (8 heads of 25, 31 x 31) and
  cross (31 x 32) attentions, and at 32 heads of 16 (31 x 31);
- `wide_train`: the widened train path end to end, `cli train` in bf16
  from a random init (seed 0, batch 64, the default graphed path) with
  chip_smoke.phase_wide's widths (encoder 8 heads of 64, decoder 8 heads
  of 25) for 3 epochs of 64 steps: each epoch's seconds and the ms a step
  over the epochs after the first (host clock; the graph's capture is in
  the first), as the row's `ms`; no device time;
- `wide_heads_train`: the same for the wide-heads train path
  (chip_smoke.phase_wide_heads's widths: encoder one head of 512, decoder
  2 heads of 320, d_model 640);
- `wide_topk`: K6 in bf16 where the tuned kernel does not take the call:
  the wide beam (N = 64 x 9, D = 200, k = 9), k = 16 and 64 at N = 64 x 4
  and D = 200, and D = 512 at k = 4 and 64, V = 22,234, dyadic inputs;
- `long_attention_bwd`: K2 in bf16 past 32 queries and keys (N = 64, 8
  heads of 16, no dbias): 128 x 128 and 63 x 64 (`cli train --seq-len
  64`'s decoder cross-attention);
- `wide_beam_eval`: the wide beam end to end, `cli evaluate --eval-mode
  beam --beam-size 9` in bf16 on a random init of the widened transceiver
  (encoder 8 heads of 64, decoder 8 heads of 25: d_model 200), one batch
  of 64 at 19 SNRs: each decode call's seconds, and the mean over the
  calls after the first as the row's `ms` (host clock);
- `long_train`: `cli train --seq-len 128` in bf16 from a random init (seed
  0, batch 64, the default graphed path) for 2 epochs of 64 steps: the
  ms a step of the second epoch as the row's `ms` (host clock; the graph's
  capture is in the first);
- `past_list_topk`: K6 in bf16 past k = 64, V = 22,234, dyadic inputs:
  k = 100 at N = 64 x 4 and D = 200, k = 256 at D = 200 and 512, and the
  beam-100 path's call (N = 64 x 100, D = 128, k = 100); the kernel's time
  alone (no plain version or library call), and whether its indices equal
  the plain version's (one call of it);
- `past_resident_bwd`: K2 in bf16 past 128 queries or keys (N = 64, 8
  heads of 16, no dbias): 256 x 256, 255 x 256 and 31 x 256 (`cli train
  --seq-len 256`'s encoder, decoder self- and cross-attention shapes at
  its decoder's 255 and the 31 of the default) and 512 x 512; the
  kernel's time alone;
- `beam100_eval`: `cli evaluate --eval-mode beam --beam-size 100` in bf16
  on results/plain_best_params.pkl (of the checkout that runs the script),
  one batch of 64 at 0, 1 and 2 dB: each decode call's seconds, and the
  mean over the calls after the first as the row's `ms` (host clock);
- `seq256_train`: `cli train --seq-len 256` in bf16 from a random init
  (seed 0, batch 64, the default graphed path) for 2 epochs of 64 steps:
  the ms a step of the second epoch as the row's `ms` (host clock);
- `select_topk`: K6 where the select kernels take the call, dyadic inputs
  at V = 22,234 unless said: f32 at the wide beam (N = 64 x 9, D = 200,
  k = 9), at N = 64 x 4 and D = 200 for k = 16, 64 and 1,000, and D = 512
  for k = 64 and 1,000; bf16 at k = 1,000 (D = 200) and at V = 32,000
  (k = 100, D = 128); the kernel's time alone (k = 1,000 over 10 calls at
  most), and whether its indices equal the plain version's (one call);
- `tiled_attention`: K1 in f32 at the shapes the tiled kernel takes (N =
  64): chip_smoke.WIDE_HEADS_PATH, WIDE_PATH, WIDE_HEADS at 31 x 31 and
  OFF_STEP_HEADS, with its plain version and SDPA (f32) as in
  chip_smoke.attention_case;
- `f32_wide_beam_eval`: `wide_beam_eval` at `--dtype float32`;
- `f32_wide_heads_eval`: `cli evaluate` (the full-prefix greedy sweep) at
  `--dtype float32` on a random init of the wide-heads transceiver
  (`wide_heads_train`'s widths), one batch of 64 at 19 SNRs: the decode
  call's seconds as the row's `ms`;
- `f32_wide_attention_bwd`: K2 in f32 (no dbias) at every wide shape of
  chip_smoke's kernel rows (N = 64): WIDE_HEADS_PATH, WIDE_PATH, WIDE_HEADS
  at 31 x 31 and OFF_STEP_HEADS, with its plain version and SDPA's
  backward (f32) as in chip_smoke.attention_bwd_case, and each kernel's
  device time;
- `f32_wide_heads_train`: `wide_heads_train` at `--dtype float32`;
- `f32_ce`: K3 and K4 in f32 at every width of chip_smoke's f32 CE rows,
  N = 1,984, V = 22,234: D = 128 (the main model's), 200 (the widened
  decoder's), 264, 512, 640 (the wide-heads model's) and 136, and K4's
  dh-only mode at D = 128 (the FGM steps') and 640, with their plain
  versions and library calls as in chip_smoke.ce_cases (each checkout's
  own inputs: chip_smoke.ce_inputs, whose cotangents have zero rows in
  newer checkouts), and each K3 and K4 kernel's device time;
- `f32_train`: `wide_train` at `--dtype float32` on the main model (no
  width flags: d_model 128, 8 heads of 16);
- `f32_wide_train`: `wide_train` at `--dtype float32`;
- `f32_attention`: K1 and K2 in f32 at the main model's heads (8 of 16):
  K1 at the serving path's N = 1,216 and the training path's N = 64 at
  chip_smoke.TRAIN_SHAPES, K2 there at N = 64 with and without dbias;
  past 32 queries and keys (N = 64) K1 and K2 (both ways) at
  chip_smoke.LONG_CASE, K2 (both ways) at chip_smoke.LONG_CROSS; and K1
  and K2 (no dbias) at 16 heads of 16, 31 x 31; with their plain versions
  and SDPA f32 (its backward for K2) as in chip_smoke.attention_case and
  attention_bwd_case, and each kernel's device time;
- `f32_greedy_eval`: `cli evaluate --dtype float32 --eval-mode greedy`
  (the full-prefix greedy sweep) on results/plain_best_params.pkl (of the
  checkout that runs the script), one batch of 64 at 19 SNRs, twice: the
  second call's seconds as the row's `ms` (the first builds the
  libraries' state and PyTorch's);
- `f32_topk`: K6 in f32 where the tuned kernel takes the call (V =
  22,234, dyadic inputs unless said): the CLI's beam (N = 64 x 4, D = 128,
  k = 4), the beam sweep's (N = 19 x 256), k = 1 and 8, k = 8 with every
  logit below 0 and with equal maxima, and D = 200 (k = 4), with their
  plain versions and library calls as in chip_smoke.topk_case, and each
  kernel's device time; the sha256 of the beam sweep call's vals and idx
  on N(0, 1) operands (the logits' bits, to compare between checkouts);
  then end to end on results/plain_best_params.pkl in f32: the beam sweep
  call (`make_beam_decode_sweep`, 19 SNRs x 64 x 4 beams, the f32 ids
  phase's call), its seconds (host clock, the second of two calls) as the
  row's `ms` and its device time over 2 calls (chip_smoke.device_ms); and
  `cli evaluate --dtype float32 --eval-mode beam` at 0, 1 and 2 dB (one
  batch of 64): the mean of the calls after the first as the row's `ms`;
- `star_wide`: K5 where the wide kernel takes the width (B = 64, L = 31,
  8 heads): D = 96 and 512 in bf16 and f32, with their plain versions and
  library calls as in chip_smoke.star_case, and each kernel's device
  time; then the widened star train path end to end, `cli train
  --variant star` in bf16 at d_model 96 (chip_smoke.phase_wide's, 16 K5 a
  step) from a random init (seed 0, batch 64, the default graphed path)
  for 2 epochs of 64 steps: the ms a step of the second epoch as the
  row's `ms` (host clock; the graph's capture is in the first).
Each turn then takes the device time per call of every kernel the bf16
wrapper (for `star`, the update) launches at each shape, and the number of
kernels, from torch.profiler over 20 calls. Prints
every row with its checkout and turn, then the median of each number by
checkout, and the card's name and power limit. Needs CUDA; imports nothing
of either checkout itself.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CASES = ("ce", "attention", "attention_bwd", "topk", "star", "wide_ce",
         "wide_heads_attention", "wide_attention", "wide_train",
         "wide_heads_train", "wide_topk", "long_attention_bwd",
         "wide_beam_eval", "long_train", "past_list_topk",
         "past_resident_bwd", "beam100_eval", "seq256_train", "select_topk",
         "tiled_attention", "f32_wide_beam_eval", "f32_wide_heads_eval",
         "f32_wide_attention_bwd", "f32_wide_heads_train", "f32_ce",
         "f32_train", "f32_wide_train", "f32_attention", "f32_greedy_eval",
         "f32_topk", "star_wide")
PARAMS = Path(__file__).resolve().parent.parent / "results" \
    / "plain_best_params.pkl"

TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

args = json.loads(sys.argv[1])
cases, iters = args["cases"], args["iters"]
N, D, V = 1984, 128, 22234
SERVE, TRAIN, BEAM = 19 * 64, 64, 256


def device_us(kernel, case, call, dtype="bfloat16"):
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    by_name, count = {}, 0
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            us = (e.time_range.end - e.time_range.start) / 20
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            count += 1
    print("DEVICE " + json.dumps({"kernel": kernel, "case": case,
                                  "dtype": dtype,
                                  "device_us": sum(by_name.values()),
                                  "kernels": count / 20,
                                  "by_name": by_name}), flush=True)


def row(r):
    print("ROW " + json.dumps(r), flush=True)


cs.phase_device()
build.build([name for case, names in (
    ("ce", [ce.KERNEL_FWD, ce.KERNEL_BWD]), ("attention", [attn.KERNEL]),
    ("attention_bwd", [attn.KERNEL_BWD]), ("topk", [topk.KERNEL]),
    ("star", ["star_satellite"]), ("f32_topk", [topk.KERNEL]),
    ("star_wide", ["star_wide"])) if case in cases for name in names])
bf16 = torch.bfloat16
if "ce" in cases:
    for dtype in (bf16, torch.float32):
        gen = torch.Generator("cuda").manual_seed(0)
        for r in cs.ce_cases(dtype, gen, iters, N, D, V):
            row(r)
    gen = torch.Generator("cuda").manual_seed(1)
    h, W, b, labels, g = cs.ce_inputs(bf16, gen, N, D, V)
    lse = ce.ce_fwd(h, W, b, labels)[1]
    device_us(ce.KERNEL_FWD, "ce", lambda: ce.ce_fwd(h, W, b, labels))
    device_us(ce.KERNEL_BWD, "ce",
              lambda: ce.ce_bwd(h, W, b, labels, lse, g))
if "attention" in cases:
    shapes = [(label, SERVE, lq, lk) for label, lq, lk in cs.TRAIN_SHAPES]
    shapes += [("train_" + label, TRAIN, lq, lk)
               for label, lq, lk in cs.TRAIN_SHAPES]
    for dtype in (bf16, torch.float32):
        gen = torch.Generator("cuda").manual_seed(0)
        for label, n, lq, lk in shapes:
            row(cs.attention_case(label, n, lq, lk, dtype, gen, iters))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, n, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(n, lq, lk, bf16, gen, lq == lk)
        device_us(attn.KERNEL, label,
                  lambda: attn.attention_fwd(q, k, v, bias, cs.HEADS, 4.0))
if "attention_bwd" in cases:
    for dtype in (bf16, torch.float32):
        gen = torch.Generator("cuda").manual_seed(0)
        for label, lq, lk in cs.TRAIN_SHAPES:
            row(cs.attention_bwd_case("train_" + label, TRAIN, lq, lk, dtype,
                                      gen, iters, False))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, lq, lk in cs.TRAIN_SHAPES:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, bf16, gen, lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        device_us(attn.KERNEL_BWD, "train_" + label,
                  lambda: attn.attention_bwd(q, k, v, bias, g, cs.HEADS, 4.0,
                                             False))
if "star" in cases:
    from deepsc_gan_tpu_torch.models.star import StarAttention
    for label, b, train in (("star_sweep", SERVE, False),
                            ("star_train", TRAIN, True)):
        torch.manual_seed(0)
        att = StarAttention(D, cs.HEADS, dtype=bf16).cuda()
        gen = torch.Generator("cuda").manual_seed(2)
        h, e, gout = (torch.randn((b, 31, D), generator=gen, device="cuda")
                      .to(bf16) for _ in range(3))
        s = torch.randn((b, D), generator=gen, device="cuda").to(bf16)
        if train:
            leaves = [t.requires_grad_(True) for t in (h, e, s)]
            leaves += list(att.parameters())

            def call():
                return torch.autograd.grad(att.satellite(h, e, s), leaves,
                                           gout)
        else:
            def call():
                with torch.no_grad():
                    return att.satellite(h, e, s)
        ms, host_ms = cs.cuda_ms(call, iters)
        row({"kernel": "satellite_update", "case": label,
             "dtype": "bfloat16", "ms": ms, "host_enqueue_ms": host_ms,
             "device_ms": cs.device_ms(call, iters)})
        device_us("satellite_update", label, call)
if "wide_ce" in cases:
    gen = torch.Generator("cuda").manual_seed(0)
    for d in (200, 512, 640):
        for r in cs.ce_cases(bf16, gen, iters, N, d, V, label=f"ce_d{d}"):
            row(r)
    row(cs.ce_dh_only_case(bf16, gen, iters, N, 640, V))
    gen = torch.Generator("cuda").manual_seed(1)
    for d in (200, 512, 640):
        h, W, b, labels, g = cs.ce_inputs(bf16, gen, N, d, V)
        lse = ce.ce_fwd(h, W, b, labels)[1]
        device_us(ce.KERNEL_BWD, f"ce_d{d}",
                  lambda: ce.ce_bwd(h, W, b, labels, lse, g))
    device_us(ce.KERNEL_BWD, "ce_dh_only_d640",
              lambda: ce.ce_bwd(h, W, b, labels, lse, g, dh_only=True))
if "wide_heads_attention" in cases:
    gen = torch.Generator("cuda").manual_seed(0)
    for label, heads, dh, lq, lk in cs.WIDE_HEADS_PATH:
        row(cs.attention_case(label, TRAIN, lq, lk, bf16, gen, iters, heads,
                              dh))
        row(cs.attention_bwd_case(label, TRAIN, lq, lk, bf16, gen, iters,
                                  False, heads, dh))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, heads, dh, lq, lk in cs.WIDE_HEADS_PATH:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, bf16, gen,
                                            lq == lk, heads, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        device_us(attn.KERNEL, label,
                  lambda: attn.attention_fwd(q, k, v, bias, heads,
                                             dh ** 0.5))
        device_us(attn.KERNEL_BWD, label,
                  lambda: attn.attention_bwd(q, k, v, bias, g, heads,
                                             dh ** 0.5, False))
if "wide_attention" in cases:
    shapes = list(cs.WIDE_PATH) + [("wide_32x16", 32, 16, 31, 31)]
    gen = torch.Generator("cuda").manual_seed(0)
    for label, heads, dh, lq, lk in shapes:
        row(cs.attention_case(label, TRAIN, lq, lk, bf16, gen, iters, heads,
                              dh))
        row(cs.attention_bwd_case(label, TRAIN, lq, lk, bf16, gen, iters,
                                  False, heads, dh))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, heads, dh, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, bf16, gen,
                                            lq == lk, heads, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        device_us(attn.KERNEL, label,
                  lambda: attn.attention_fwd(q, k, v, bias, heads,
                                             dh ** 0.5))
        device_us(attn.KERNEL_BWD, label,
                  lambda: attn.attention_bwd(q, k, v, bias, g, heads,
                                             dh ** 0.5, False))
TRAIN_WIDTHS = {
    "wide_train": ["--encoder-d-model", "512", "--encoder-d-ff", "1024",
                   "--decoder-d-model", str(cs.WIDE_PATH_D),
                   "--decoder-d-ff", str(2 * cs.WIDE_PATH_D)],
    "wide_heads_train": ["--encoder-d-model", "512", "--encoder-num-heads",
                         "1", "--encoder-d-ff", "1024", "--decoder-d-model",
                         "640", "--decoder-num-heads", "2", "--decoder-d-ff",
                         "1280"]}
TRAIN_WIDTHS["f32_wide_heads_train"] = TRAIN_WIDTHS["wide_heads_train"]
TRAIN_WIDTHS["f32_wide_train"] = TRAIN_WIDTHS["wide_train"]
TRAIN_WIDTHS["f32_train"] = []
for case, widths in TRAIN_WIDTHS.items():
    if case not in cases:
        continue
    from deepsc_gan_tpu_torch import cli
    dtype = "float32" if case.startswith("f32") else "bfloat16"
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "plain", "--dtype", dtype, "--bs", str(TRAIN),
                    "--epochs", "3", "--seed", "0", "--device", "cuda",
                    "--log-every", "64", "--log-save-path",
                    f"log/kernels_ab/{case}", "--checkpoint-path",
                    f"log/kernels_ab/{case}_ckpt", *widths])
    seconds = res["epoch_seconds"]
    steps = res["steps"] // len(seconds)
    row({"kernel": "cli_train", "case": case, "dtype": dtype,
         "path": res["path"], "epoch_seconds": seconds,
         "ms": sum(seconds[1:]) / len(seconds[1:]) / steps * 1e3})
if "wide_topk" in cases:
    shapes = (("wide_beam", 64 * 9, 200, 9), ("k16_d200", BEAM, 200, 16),
              ("k64_d200", BEAM, 200, 64), ("d512", BEAM, 512, 4),
              ("k64_d512", BEAM, 512, 64))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, n, d, k in shapes:
        row(cs.topk_case(label, n, bf16, gen, iters, k, d=d))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, n, d, k in shapes:
        h = cs.dyadic((n, d), 8, gen, bf16)
        W = cs.dyadic((V, d), 2, gen, bf16)
        b = cs.dyadic((V,), 8, gen, torch.float32)
        device_us(topk.KERNEL, label,
                  lambda: topk.topk_logits(h, W, b, k))
if "long_attention_bwd" in cases:
    shapes = (("long_128", 128, 128), ("long_63x64", 63, 64))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, lq, lk in shapes:
        row(cs.attention_bwd_case(label, TRAIN, lq, lk, bf16, gen, iters,
                                  False))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, bf16, gen,
                                            lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
        device_us(attn.KERNEL_BWD, label,
                  lambda: attn.attention_bwd(q, k, v, bias, g, cs.HEADS, 4.0,
                                             False))
for case, dtype in (("wide_beam_eval", "bfloat16"),
                    ("f32_wide_beam_eval", "float32")):
    if case not in cases:
        continue
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["evaluate", "--variant", "transformer", "--eval-mode",
                    "beam", "--beam-size", "9", "--dtype", dtype,
                    "--bs", str(TRAIN), "--eval-batches", "1", "--seed", "0",
                    "--snr-lo", "0", "--snr-hi", "18", "--device", "cuda",
                    "--encoder-d-model", "512", "--encoder-d-ff", "1024",
                    "--decoder-d-model", str(cs.WIDE_PATH_D),
                    "--decoder-d-ff", str(2 * cs.WIDE_PATH_D),
                    "--checkpoint-path", "log/kernels_ab/no_ckpt",
                    "--log-save-path", f"log/kernels_ab/{case}"])
    seconds = res["decode_seconds"]
    row({"kernel": "cli_evaluate", "case": case, "dtype": dtype,
         "decode_seconds": seconds,
         "ms": sum(seconds[1:]) / len(seconds[1:]) * 1e3})
if "f32_wide_heads_eval" in cases:
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["evaluate", "--variant", "transformer", "--eval-mode",
                    "greedy", "--dtype", "float32", "--bs", str(TRAIN),
                    "--eval-batches", "1", "--seed", "0", "--snr-lo", "0",
                    "--snr-hi", "18", "--device", "cuda",
                    *TRAIN_WIDTHS["wide_heads_train"],
                    "--checkpoint-path", "log/kernels_ab/no_ckpt",
                    "--log-save-path", "log/kernels_ab/f32_wide_heads_eval"])
    seconds = res["decode_seconds"]
    row({"kernel": "cli_evaluate", "case": "f32_wide_heads_eval",
         "dtype": "float32", "decode_seconds": seconds,
         "ms": sum(seconds) / len(seconds) * 1e3})
if "select_topk" in cases:
    f32 = torch.float32
    shapes = (("wide_beam", 64 * 9, 200, 9, f32, V),
              ("k16_d200", BEAM, 200, 16, f32, V),
              ("k64_d200", BEAM, 200, 64, f32, V),
              ("k1000_d200", BEAM, 200, 1000, f32, V),
              ("k64_d512", BEAM, 512, 64, f32, V),
              ("k1000_d512", BEAM, 512, 1000, f32, V),
              ("k1000_d200", BEAM, 200, 1000, bf16, V),
              ("v32000_k100", BEAM, 128, 100, bf16, 32000))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, n, d, k, dtype, v in shapes:
        h = cs.dyadic((n, d), 8, gen, dtype)
        W = cs.dyadic((v, d), 2, gen, dtype)
        b = cs.dyadic((v,), 8, gen, torch.float32)

        def call():
            return topk.topk_logits(h, W, b, k)

        same = torch.equal(call()[1], topk.topk_logits_reference(h, W, b,
                                                                 k)[1])
        n_iters = min(iters, 10) if k >= 1000 else iters
        ms, host_ms = cs.cuda_ms(call, n_iters)
        row({"kernel": topk.KERNEL, "case": label,
             "dtype": str(dtype).replace("torch.", ""), "ms": ms,
             "host_enqueue_ms": host_ms,
             "device_ms": cs.device_ms(call, n_iters),
             "indices_equal": same})
if "tiled_attention" in cases:
    shapes = list(cs.WIDE_HEADS_PATH) + list(cs.WIDE_PATH) + [
        (f"wide_{heads}x{dh}", heads, dh, 31, 31)
        for heads, dh in cs.WIDE_HEADS] + [cs.OFF_STEP_HEADS]
    gen = torch.Generator("cuda").manual_seed(0)
    for label, heads, dh, lq, lk in shapes:
        row(cs.attention_case(label, TRAIN, lq, lk, torch.float32, gen,
                              iters, heads, dh))
if "f32_ce" in cases:
    f32 = torch.float32
    widths = (128, 200, 264, 512, 640, 136)
    gen = torch.Generator("cuda").manual_seed(0)
    for d in widths:
        for r in cs.ce_cases(f32, gen, iters, N, d, V,
                             label="ce" if d == D else f"ce_d{d}"):
            row(r)
    for d in (128, 640):
        row(cs.ce_dh_only_case(f32, gen, iters, N, d, V,
                               label="ce_dh_only" if d == D
                               else f"ce_dh_only_d{d}"))
    gen = torch.Generator("cuda").manual_seed(1)
    for d in widths:
        h, W, b, labels, g = cs.ce_inputs(f32, gen, N, d, V)
        lse = ce.ce_fwd(h, W, b, labels)[1]
        label = "ce" if d == D else f"ce_d{d}"
        device_us(ce.KERNEL_FWD, label, lambda: ce.ce_fwd(h, W, b, labels),
                  "float32")
        device_us(ce.KERNEL_BWD, label,
                  lambda: ce.ce_bwd(h, W, b, labels, lse, g), "float32")
        if d in (128, 640):
            device_us(ce.KERNEL_BWD, label.replace("ce", "ce_dh_only"),
                      lambda: ce.ce_bwd(h, W, b, labels, lse, g,
                                        dh_only=True), "float32")
if "f32_wide_attention_bwd" in cases:
    f32 = torch.float32
    shapes = list(cs.WIDE_HEADS_PATH) + list(cs.WIDE_PATH) + [
        (f"wide_{heads}x{dh}", heads, dh, 31, 31)
        for heads, dh in cs.WIDE_HEADS] + [cs.OFF_STEP_HEADS]
    gen = torch.Generator("cuda").manual_seed(0)
    for label, heads, dh, lq, lk in shapes:
        row(cs.attention_bwd_case(label, TRAIN, lq, lk, f32, gen, iters,
                                  False, heads, dh))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, heads, dh, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, f32, gen,
                                            lq == lk, heads, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        device_us(attn.KERNEL_BWD, label,
                  lambda: attn.attention_bwd(q, k, v, bias, g, heads,
                                             dh ** 0.5, False), "float32")
if "f32_attention" in cases:
    f32 = torch.float32
    k1 = [(label, SERVE, lq, lk, cs.HEADS, cs.DH)
          for label, lq, lk in cs.TRAIN_SHAPES]
    k1 += [("train_" + label, TRAIN, lq, lk, cs.HEADS, cs.DH)
           for label, lq, lk in cs.TRAIN_SHAPES]
    k1 += [(cs.LONG_CASE, TRAIN, cs.LONG_LEN, cs.LONG_LEN, cs.HEADS, cs.DH),
           ("f32_k1_16x16", TRAIN, 31, 31, 16, 16)]
    k2 = [("train_" + label, lq, lk, cs.HEADS, cs.DH, dbias)
          for label, lq, lk in cs.TRAIN_SHAPES for dbias in (False, True)]
    k2 += [(cs.LONG_CASE, cs.LONG_LEN, cs.LONG_LEN, cs.HEADS, cs.DH, dbias)
           for dbias in (False, True)]
    k2 += [(cs.LONG_CROSS[0], *cs.LONG_CROSS[1:], cs.HEADS, cs.DH, dbias)
           for dbias in (False, True)]
    k2 += [("f32_k2_16x16", 31, 31, 16, 16, False)]
    gen = torch.Generator("cuda").manual_seed(0)
    for label, n, lq, lk, heads, dh in k1:
        row(cs.attention_case(label, n, lq, lk, f32, gen, iters, heads, dh))
    for label, lq, lk, heads, dh, dbias in k2:
        row(cs.attention_bwd_case(label, TRAIN, lq, lk, f32, gen, iters,
                                  dbias, heads, dh))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, n, lq, lk, heads, dh in k1:
        q, k, v, bias = cs.attention_inputs(n, lq, lk, f32, gen, lq == lk,
                                            heads, dh)
        device_us(attn.KERNEL, label,
                  lambda: attn.attention_fwd(q, k, v, bias, heads,
                                             dh ** 0.5), "float32")
    for label, lq, lk, heads, dh, dbias in k2:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, f32, gen,
                                            lq == lk, heads, dh)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        device_us(attn.KERNEL_BWD, label + ("+dbias" if dbias else ""),
                  lambda: attn.attention_bwd(q, k, v, bias, g, heads,
                                             dh ** 0.5, dbias), "float32")
if "f32_greedy_eval" in cases:
    from deepsc_gan_tpu_torch import cli
    for _ in range(2):
        res = cli.main(["evaluate", "--variant", "transformer",
                        "--params-pkl", args["params"], "--eval-mode",
                        "greedy", "--dtype", "float32", "--bs", str(TRAIN),
                        "--eval-batches", "1", "--seed", "0", "--snr-lo",
                        "0", "--snr-hi", "18", "--device", "cuda",
                        "--log-save-path", "log/kernels_ab/f32_greedy_eval"])
    seconds = res["decode_seconds"]
    row({"kernel": "cli_evaluate", "case": "f32_greedy_eval",
         "dtype": "float32", "decode_seconds": seconds,
         "ms": sum(seconds) / len(seconds) * 1e3})
if "f32_topk" in cases:
    import hashlib
    f32 = torch.float32
    shapes = (("beam", BEAM, D, 4, "dyadic"),
              ("beam_sweep", 19 * BEAM, D, 4, "dyadic"),
              ("k1", BEAM, D, 1, "dyadic"), ("k8", BEAM, D, 8, "dyadic"),
              ("negative", BEAM, D, 8, "negative"),
              ("tie", BEAM, D, 8, "tie"), ("d200", BEAM, 200, 4, "dyadic"))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, n, d, k, mode in shapes:
        row(cs.topk_case(label, n, f32, gen, iters, k, mode, d=d))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, n, d, k, mode in shapes:
        h, W, b = cs.topk_inputs(n, d, k, mode, f32, gen)
        device_us(topk.KERNEL, label, lambda: topk.topk_logits(h, W, b, k),
                  "float32")
    gen = torch.Generator("cuda").manual_seed(2)
    h = torch.randn((19 * BEAM, D), generator=gen, device="cuda")
    W = 0.3 * torch.randn((V, D), generator=gen, device="cuda")
    b = 0.1 * torch.randn(V, generator=gen, device="cuda")
    vals, idx, _ = topk.topk_logits(h, W, b, 4)
    print("BITS " + json.dumps({
        name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
        for name, t in (("vals", vals), ("idx", idx))}), flush=True)
    import time
    params = cs.load_params_pickle(args["params"])
    cfg = cs.Config(dtype="float32", bs=TRAIN,
                    tie_embeddings=cs.is_tied(params))
    model = cs.load_into(cs.make_model(cfg, attention=attn.fused_attention),
                         params).cuda().eval()
    inp = torch.as_tensor(cs.eval_batches(cfg.test_save_path, cfg.seq_len,
                                          cfg.vocab_size, TRAIN, 1, 0)[0],
                          dtype=torch.long, device="cuda")
    n_stds = torch.tensor([cs.SNR_to_noise(x) for x in cs.SNRS],
                          dtype=torch.float32, device="cuda")
    noise = torch.randn((len(cs.SNRS), TRAIN, cfg.seq_len, cfg.channel_dim),
                        generator=gen, device="cuda")
    sweep = cs.make_beam_decode_sweep(model, cfg, 4)

    def call():
        return sweep(inp, 0.0, n_stds, noise)

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    row({"kernel": "beam_sweep_call", "case": "f32_beam_sweep",
         "dtype": "float32", "ms": seconds * 1e3,
         "device_ms": cs.device_ms(call, 2)})
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["evaluate", "--variant", "transformer", "--params-pkl",
                    args["params"], "--eval-mode", "beam", "--beam-size",
                    "4", "--dtype", "float32", "--bs", str(TRAIN),
                    "--eval-batches", "1", "--seed", "0", "--snr-lo", "0",
                    "--snr-hi", "2", "--device", "cuda", "--log-save-path",
                    "log/kernels_ab/f32_beam_eval"])
    seconds = res["decode_seconds"]
    row({"kernel": "cli_evaluate", "case": "f32_beam_eval",
         "dtype": "float32", "decode_seconds": seconds,
         "ms": sum(seconds[1:]) / len(seconds[1:]) * 1e3})
if "star_wide" in cases:
    gen = torch.Generator("cuda").manual_seed(0)
    for d in (96, 512):
        for dtype in (bf16, torch.float32):
            row(cs.star_case(f"star_d{d}", TRAIN, 31, dtype, gen, iters,
                             d=d))
    gen = torch.Generator("cuda").manual_seed(1)
    for d in (96, 512):
        for dtype in (bf16, torch.float32):
            ring = [torch.randn((TRAIN, 31, d) if i < 5 else (TRAIN, d),
                                generator=gen, device="cuda").to(dtype)
                    for i in range(7)]
            device_us("star_satellite", f"star_d{d}",
                      lambda: cs.star.star_satellite(*ring, cs.HEADS),
                      str(dtype).replace("torch.", ""))
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["train", "--variant", "star", "--train-mode", "plain",
                    "--dtype", "bfloat16", "--bs", str(TRAIN), "--epochs",
                    "2", "--seed", "0", "--device", "cuda",
                    "--encoder-d-model", "96", "--decoder-d-model", "96",
                    "--log-every", "64", "--log-save-path",
                    "log/kernels_ab/star_wide_train", "--checkpoint-path",
                    "log/kernels_ab/star_wide_train_ckpt"])
    seconds = res["epoch_seconds"]
    steps = res["steps"] // len(seconds)
    row({"kernel": "cli_train", "case": "star_wide_train",
         "dtype": "bfloat16", "path": res["path"], "epoch_seconds": seconds,
         "ms": seconds[-1] / steps * 1e3})
if "long_train" in cases:
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "plain", "--dtype", "bfloat16", "--bs", str(TRAIN),
                    "--epochs", "2", "--seed", "0", "--device", "cuda",
                    "--seq-len", "128", "--log-every", "64",
                    "--log-save-path", "log/kernels_ab/long_train",
                    "--checkpoint-path", "log/kernels_ab/long_train_ckpt"])
    seconds = res["epoch_seconds"]
    steps = res["steps"] // len(seconds)
    row({"kernel": "cli_train", "case": "long_train", "dtype": "bfloat16",
         "path": res["path"], "epoch_seconds": seconds,
         "ms": seconds[-1] / steps * 1e3})
if "past_list_topk" in cases:
    shapes = (("k100_d200", BEAM, 200, 100), ("k256_d200", BEAM, 200, 256),
              ("k256_d512", BEAM, 512, 256), ("beam100", 64 * 100, D, 100))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, n, d, k in shapes:
        h = cs.dyadic((n, d), 8, gen, bf16)
        W = cs.dyadic((V, d), 2, gen, bf16)
        b = cs.dyadic((V,), 8, gen, torch.float32)

        def call():
            return topk.topk_logits(h, W, b, k)

        same = torch.equal(call()[1], topk.topk_logits_reference(h, W, b,
                                                                 k)[1])
        ms, host_ms = cs.cuda_ms(call, iters)
        row({"kernel": topk.KERNEL, "case": label, "dtype": "bfloat16",
             "ms": ms, "host_enqueue_ms": host_ms,
             "device_ms": cs.device_ms(call, iters), "indices_equal": same})
        device_us(topk.KERNEL, label, call)
if "past_resident_bwd" in cases:
    shapes = (("long_256", 256, 256), ("long_255x256", 255, 256),
              ("long_31x256", 31, 256), ("long_512", 512, 512))
    gen = torch.Generator("cuda").manual_seed(0)
    for label, lq, lk in shapes:
        q, k, v, bias = cs.attention_inputs(TRAIN, lq, lk, bf16, gen,
                                            lq == lk)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)

        def call():
            return attn.attention_bwd(q, k, v, bias, g, cs.HEADS, 4.0, False)

        ms, host_ms = cs.cuda_ms(call, iters)
        row({"kernel": attn.KERNEL_BWD, "case": label, "dtype": "bfloat16",
             "ms": ms, "host_enqueue_ms": host_ms,
             "device_ms": cs.device_ms(call, iters)})
        device_us(attn.KERNEL_BWD, label, call)
if "beam100_eval" in cases:
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["evaluate", "--variant", "transformer", "--params-pkl",
                    args["params"], "--eval-mode", "beam", "--beam-size",
                    "100", "--dtype", "bfloat16", "--bs", str(TRAIN),
                    "--eval-batches", "1", "--seed", "0", "--snr-lo", "0",
                    "--snr-hi", "2", "--device", "cuda", "--log-save-path",
                    "log/kernels_ab/beam100_eval"])
    seconds = res["decode_seconds"]
    row({"kernel": "cli_evaluate", "case": "beam100_eval",
         "dtype": "bfloat16", "decode_seconds": seconds,
         "ms": sum(seconds[1:]) / len(seconds[1:]) * 1e3})
if "seq256_train" in cases:
    from deepsc_gan_tpu_torch import cli
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "plain", "--dtype", "bfloat16", "--bs", str(TRAIN),
                    "--epochs", "2", "--seed", "0", "--device", "cuda",
                    "--seq-len", "256", "--log-every", "64",
                    "--log-save-path", "log/kernels_ab/seq256_train",
                    "--checkpoint-path", "log/kernels_ab/seq256_train_ckpt"])
    seconds = res["epoch_seconds"]
    steps = res["steps"] // len(seconds)
    row({"kernel": "cli_train", "case": "seq256_train", "dtype": "bfloat16",
         "path": res["path"], "epoch_seconds": seconds,
         "ms": seconds[-1] / steps * 1e3})
if "topk" in cases:
    shapes = (("beam", BEAM), ("beam_sweep", 19 * BEAM))
    for dtype in (bf16, torch.float32):
        gen = torch.Generator("cuda").manual_seed(0)
        for label, n in shapes:
            row(cs.topk_case(label, n, dtype, gen, iters))
    gen = torch.Generator("cuda").manual_seed(1)
    for label, n in shapes:
        h = cs.dyadic((n, D), 8, gen, bf16)
        W = cs.dyadic((V, D), 2, gen, bf16)
        b = cs.dyadic((V,), 8, gen, torch.float32)
        device_us(topk.KERNEL, label, lambda: topk.topk_logits(h, W, b, 4))
"""


def run_turn(root: Path, cases, iters: int) -> list:
    """One checkout's rows: ("ROW" or "DEVICE", dict) for each such line."""
    proc = subprocess.run(
        [sys.executable, "-c", TURN,
         json.dumps({"cases": list(cases), "iters": iters,
                     "params": str(PARAMS)})],
        cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed (exit {proc.returncode}):"
                           f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = []
    for line in proc.stdout.splitlines():
        if line.startswith("[device]"):
            print(f"  {line}")
        for tag in ("ROW ", "DEVICE ", "BITS "):
            if line.startswith(tag):
                out.append((tag.strip(), json.loads(line[len(tag):])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {', '.join(CASES)}")
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases takes {', '.join(CASES)}, not {args.cases}")
    roots = {"A": args.old.resolve(), "B": args.new.resolve()}
    print(f"A = {roots['A']}\nB = {roots['B']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}")
    seen = {}
    for i, turn in enumerate(args.turns):
        for tag, row in run_turn(roots[turn], cases, args.iters):
            print(f"[turn {i} {turn}] {tag} {json.dumps(row)}")
            if tag == "BITS":
                continue
            key = (turn, row["kernel"], row["case"], row["dtype"])
            if tag == "ROW":
                for field in ("ms", "host_enqueue_ms", "plain_ms",
                              "library_ms", "device_ms"):
                    if row.get(field) is not None:
                        seen.setdefault(key + (field,), []).append(
                            row[field])
            else:
                seen.setdefault(key + ("device_us",), []).append(
                    row["device_us"])
    print("medians by checkout:")
    for key in sorted(seen):
        vals = seen[key]
        print(f"  {' '.join(key)}: {statistics.median(vals)!r} "
              f"(of {len(vals)}: {vals})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
