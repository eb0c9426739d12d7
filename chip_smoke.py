#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepsc_gan_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 2] [--epochs 3]

Phases, each printing its lines; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the serving and training paths (K1-K4),
   compiled by nvcc from the sources in this checkout (all nvcc processes
   started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the two paths give it, in f32 and bf16, with the tolerance
   stated; the kernel's time, its host enqueue time, the plain version's
   time, one PyTorch library call's (a yardstick the port never calls), and
   the least time the card could take;
4. serving path: the port's CLI runs the greedy BLEU-vs-SNR sweep (SNR
   0..18 dB) of the trained transceiver (results/plain_best_params.pkl) in
   bf16 on synthetic batches of 64 made from --seed; every launch count is
   set to 0 just before and read just after, and must equal what the path
   makes; then one batch is decoded at f32 through the kernels and through
   the plain versions, and the ids must be identical;
5. training path: the port's CLI trains the full-width transceiver in bf16
   from a random init (--seed) on the synthetic set for --epochs epochs;
   launch counts as above (per step: 12 K1, 12 K2, 1 K3, 1 K4); every loss
   finite and the last 20 below the first 20 on average; then one f32 step
   through the kernels and one through the plain versions from the same
   weights, noise and dropout masks: the same loss and gradients;
6. profile: device time by kernel over one bf16 sweep call and over one
   bf16 train step, and the device's idle share in each (torch.profiler);
7. the kernels as one JSON line, then `{"ok": true, "device": {...}}` as
   the last line.

Needs CUDA: without it the script exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.data.loader import eval_batches
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.data.loader import train_dataset
from deepsc_gan_tpu_torch.evaluate.metrics import SNR_to_noise
from deepsc_gan_tpu_torch.models.channel import snr_to_noise
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils.config import Config
from deepsc_gan_tpu_torch.utils.convert import (
    is_tied,
    load_into,
    load_params_pickle,
)

PARAMS = "results/plain_best_params.pkl"
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
TRAIN_SHAPES = (("encoder", 32, 32), ("decoder_self", 31, 31),
                ("decoder_cross", 31, 32))
KERNELS = (attn.KERNEL, attn.KERNEL_BWD, ce.KERNEL_FWD, ce.KERNEL_BWD)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi.stdout.strip()}")
    # f32 matrix products in full f32: the f32 comparisons below rely on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    seconds = build.build(KERNELS, force=True)
    for name, s in seconds.items():
        print(f"[build] csrc/{name}.cu: nvcc {s:.2f} s")


def cuda_ms(fn, iters):
    """(device ms per call between CUDA events, host ms per call to enqueue
    it) over `iters` back-to-back calls after a warm-up. When the two are
    close, the host, not the device, set the pace."""
    for _ in range(3):
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


def attention_inputs(n, lq, lk, dtype, gen, causal):
    """q, k, v ~ N(0, 1) and a bias with padding (a random key length per
    row), the causal block where lq == lk, and two fully blocked query
    rows: every key of batch row 0, and every key of query 3 in row 1."""
    dev = "cuda"
    hd = HEADS * DH
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


def max_err(got, want, relative=False):
    """max |got - want| over tensors (None pairs skipped), over max |want|
    when `relative`."""
    err = 0.0
    for a, b in zip(got, want):
        if b is None:
            continue
        e = (a.float() - b.float()).abs().max().item()
        if relative:
            e /= max(b.float().abs().max().item(), 1e-30)
        err = max(err, e)
    return err


def kernel_row(kernel, case, dtype, err, tol, call, plain, library, nbytes,
               ops, iters, **extra):
    """Check `err` against `tol`, time the kernel, its plain version and
    the library call, print and return the row."""
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{kernel} {case} {dtype}: max err {err} > "
                             f"{tol}")
    ms, host_ms = cuda_ms(call, iters)
    plain_ms, _ = cuda_ms(plain, iters)
    library_ms = cuda_ms(library, iters)[0] if library else None
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    row = {"kernel": kernel, "case": case,
           "dtype": str(dtype).replace("torch.", ""), **extra,
           "max_abs_err": err, "tol": tol, "ms": ms,
           "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": ops}
    print("[kernel] " + json.dumps(row))
    return row


def _sdpa_views(q, k, v):
    return [t.view(t.shape[0], t.shape[1], HEADS, DH).transpose(1, 2)
            for t in (q, k, v)]


def attention_case(label, n, lq, lk, dtype, gen, iters):
    """K1 at one shape."""
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk)
    scale = math.sqrt(DH)
    out = attn.attention_fwd(q, k, v, bias, HEADS, scale)
    ref = attn.attention_fwd_reference(q, k, v, bias, HEADS, scale)
    torch.cuda.synchronize()
    # yardstick: one library call with the same additive mask (the port
    # never calls it)
    qh, kh, vh = _sdpa_views(q, k, v)
    mask4 = bias[:, None].to(dtype)
    elt = q.element_size()
    return kernel_row(
        attn.KERNEL, label, dtype, max_err([out], [ref]), TOL[dtype],
        lambda: attn.attention_fwd(q, k, v, bias, HEADS, scale),
        lambda: attn.attention_fwd_reference(q, k, v, bias, HEADS, scale),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4,
                                               scale=1.0 / scale),
        (q.numel() + k.numel() + v.numel() + q.numel()) * elt
        + bias.numel() * 4, 2 * 2 * n * HEADS * lq * lk * DH, iters,
        n=n, lq=lq, lk=lk)


def attention_bwd_case(label, n, lq, lk, dtype, gen, iters, dbias):
    """K2 at one shape, with or without dbias."""
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = math.sqrt(DH)
    got = attn.attention_bwd(q, k, v, bias, g, HEADS, scale, dbias)
    want = attn.attention_bwd_reference(q, k, v, bias, g, HEADS, scale,
                                        dbias)
    torch.cuda.synchronize()
    if (got[3] is None) != (not dbias):
        raise AssertionError("attention_bwd: dbias returned when not asked "
                             "for, or missing")
    # yardstick: the backward of one library call with the same mask
    leaves = [t.detach().requires_grad_(True) for t in _sdpa_views(q, k, v)]
    out = F.scaled_dot_product_attention(*leaves,
                                         attn_mask=bias[:, None].to(dtype),
                                         scale=1.0 / scale)
    gh = _sdpa_views(g, g, g)[0]
    elt = q.element_size()
    tile = bias.numel() * 4
    nbytes = (2 * q.numel() + 2 * k.numel()) * elt + tile \
        + (q.numel() + 2 * k.numel()) * elt + (tile if dbias else 0)
    return kernel_row(
        attn.KERNEL_BWD, label + ("+dbias" if dbias else ""), dtype,
        max_err(got, want), TOL[dtype],
        lambda: attn.attention_bwd(q, k, v, bias, g, HEADS, scale, dbias),
        lambda: attn.attention_bwd_reference(q, k, v, bias, g, HEADS, scale,
                                             dbias),
        lambda: torch.autograd.grad(out, leaves, gh, retain_graph=True),
        nbytes, 5 * 2 * n * HEADS * lq * lk * DH, iters,
        n=n, lq=lq, lk=lk, dbias=dbias)


def ce_cases(dtype, gen, iters, n, d, v):
    """K3 and K4 at the training path's shape (tied layout: W is (V, D))."""
    h = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    W = (0.1 * torch.randn((v, d), generator=gen, device="cuda")).to(dtype)
    b = 0.1 * torch.randn(v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    g = torch.rand(n, generator=gen, device="cuda")
    got = ce.ce_fwd(h, W, b, labels)
    want = ce.ce_fwd_reference(h, W, b, labels)
    lse = want[1]
    dgot = ce.ce_bwd(h, W, b, labels, lse, g)
    dwant = ce.ce_bwd_reference(h, W, b, labels, lse, g)
    torch.cuda.synchronize()
    elt = h.element_size()
    ins = (n * d + v * d) * elt + v * 4 + n * 4
    shape = {"n": n, "d": d, "v": v}
    # yardsticks: PyTorch's cross entropy over materialized logits, and
    # its backward
    leaves = [t.detach().requires_grad_(True) for t in (h, W, b)]
    loss = F.cross_entropy((leaves[0] @ leaves[1].t()).float() + leaves[2],
                           labels, reduction="none")
    rows = [kernel_row(
        ce.KERNEL_FWD, "ce", dtype, max_err(got, want), TOL[dtype],
        lambda: ce.ce_fwd(h, W, b, labels),
        lambda: ce.ce_fwd_reference(h, W, b, labels),
        lambda: F.cross_entropy((h @ W.t()).float() + b, labels,
                                reduction="none"),
        ins + 2 * n * 4, 2 * n * d * v, iters, **shape)]
    # one recompute of the logits and the two products
    rows.append(kernel_row(
        ce.KERNEL_BWD, "ce", dtype, max_err(dgot, dwant, relative=True),
        TOL[dtype],
        lambda: ce.ce_bwd(h, W, b, labels, lse, g),
        lambda: ce.ce_bwd_reference(h, W, b, labels, lse, g),
        lambda: torch.autograd.grad(loss, leaves, g, retain_graph=True),
        ins + 2 * n * 4 + (n * d + v * d + v) * 4, 6 * n * d * v, iters,
        **shape))
    return rows


def phase_kernels(seed, n, bs, iters):
    """Every kernel at the serving path's shapes (K1, N = 19 SNRs x bs)
    and the training path's (K1-K2 at N = bs; K3-K4 at bs x 31 rows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = Config()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, lq, lk in TRAIN_SHAPES:
            rows.append(attention_case(label, n, lq, lk, dtype, gen, iters))
        for label, lq, lk in TRAIN_SHAPES:
            rows.append(attention_case("train_" + label, bs, lq, lk, dtype,
                                       gen, iters))
            for dbias in (False, True):
                rows.append(attention_bwd_case("train_" + label, bs, lq, lk,
                                               dtype, gen, iters, dbias))
        rows += ce_cases(dtype, gen, iters, bs * (cfg.seq_len - 1),
                         cfg.decoder_d_model, cfg.vocab_size)
    return rows


def reset_launches():
    attn.reset_launches()
    ce.reset_launches()


def launches():
    """Launches of K1-K4 since the last reset."""
    return {attn.KERNEL: attn.launches, attn.KERNEL_BWD: attn.bwd_launches,
            ce.KERNEL_FWD: ce.fwd_launches, ce.KERNEL_BWD: ce.bwd_launches}


def check_launches(path, got, expected):
    print(f"[{path}] launches {json.dumps(got)} (expected "
          f"{json.dumps(expected)})")
    if got != expected:
        raise AssertionError(f"{path} path launched {got}, expected "
                             f"{expected}")


def phase_main_path(seed, batches, bs):
    """The serving path: the greedy sweep through the CLI."""
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["evaluate", "--variant", "transformer",
                    "--eval-mode", "greedy", "--params-pkl", PARAMS,
                    "--dtype", "bfloat16", "--bs", str(bs),
                    "--eval-batches", str(batches), "--seed", str(seed),
                    "--snr-lo", str(SNRS[0]), "--snr-hi", str(SNRS[-1]),
                    "--device", "cuda", "--log-save-path", "log/chip_smoke"])
    wall = time.perf_counter() - t0
    got = launches()
    cfg = Config()
    # encoder: one self-attention per layer, once per batch; decoder: self
    # and cross per layer at each of max_length steps
    k1 = (cfg.encoder_num_layer
          + 2 * cfg.decoder_num_layer * cfg.max_length) * batches
    check_launches("main", got, {attn.KERNEL: k1, attn.KERNEL_BWD: 0,
                                 ce.KERNEL_FWD: 0, ce.KERNEL_BWD: 0})
    table = res["table"]
    if len(table) != len(SNRS) or not all(
            math.isfinite(b) and 0.0 <= b <= 1.0 for _, b in table):
        raise AssertionError(f"bad BLEU table {table}")
    print("[main] BLEU-1 " + " ".join(f"{s:.0f}dB={b:.4f}" for s, b in table))
    secs = res["decode_seconds"]
    per_batch = res["sequences"] / len(secs)
    print(f"[main] {res['sequences']} sequences in {len(secs)} sweep calls: "
          f"call seconds {secs}; {res['sequences'] / sum(secs):.1f} seq/s "
          f"over all calls, {per_batch / min(secs):.1f} seq/s in the "
          f"fastest; wall {wall:.2f} s")
    return got


def phase_train(seed, epochs, bs):
    """The training path: `cli train` at full width in bf16 from a random
    init on the synthetic set."""
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["train", "--variant", "transformer", "--train-mode",
                    "plain", "--dtype", "bfloat16", "--bs", str(bs),
                    "--epochs", str(epochs), "--seed", str(seed),
                    "--device", "cuda", "--log-every", "64",
                    "--log-save-path", "log/chip_smoke/train",
                    "--checkpoint-path", "log/chip_smoke/ckpt"])
    wall = time.perf_counter() - t0
    got = launches()
    cfg = Config()
    n = res["steps"]
    per_step = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
    check_launches("train", got, {
        attn.KERNEL: per_step * n, attn.KERNEL_BWD: per_step * n,
        ce.KERNEL_FWD: n, ce.KERNEL_BWD: n})
    losses = res["losses"]
    first, last = losses[:20].mean().item(), losses[-20:].mean().item()
    print(f"[train] {n} steps in {epochs} epochs; loss first {losses[0]:.4f}"
          f" last {losses[-1]:.4f}; mean of the first 20 {first:.4f}, of "
          f"the last 20 {last:.4f}")
    if len(losses) != n or not torch.isfinite(losses).all():
        raise AssertionError("a train loss is not finite")
    if not last < first:
        raise AssertionError(f"the loss did not fall: {first} -> {last}")
    per_epoch = n // epochs
    steady = res["epoch_seconds"][1:] or res["epoch_seconds"]
    ms_step = sum(steady) / len(steady) / per_epoch * 1e3
    rate = sum(res["sents_per_sec"][1:] or res["sents_per_sec"]) \
        / len(steady)
    print(f"[train] epoch seconds {res['epoch_seconds']}; steady (epochs "
          f"after the first) {ms_step:.3f} ms/step, {rate:.1f} sentences/s;"
          f" first epoch {res['sents_per_sec'][0]:.1f} sentences/s; wall "
          f"{wall:.2f} s")
    return got, {"ms_per_step": ms_step, "sents_per_sec": rate,
                 "steps": n, "loss_first20": first, "loss_last20": last}


def _train_batch(cfg, seed):
    ds = train_dataset(cfg.train_save_path, cfg.seq_len, cfg.vocab_size,
                       cfg.bs, seed)
    inp, _ = next(iter(ds))
    return torch.from_numpy(inp).to("cuda", torch.long)


def phase_step_parity(seed, bs):
    """One f32 train step at full width through the kernels and one
    through the plain versions: the same weights (init from `seed`),
    noise and dropout masks (one generator seed, drawn in the same
    order)."""
    cfg = Config(dtype="float32", bs=bs)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    out = []
    for plain in (False, True):
        attention = attn.plain_attention if plain else attn.fused_attention
        model = steps.init_params(make_model(cfg, attention=attention), seed)
        model = model.cuda().train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(model, cfg, plain=plain)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches()
        _, loss = step(state, inp, inp, gen, n_std)
        torch.cuda.synchronize()
        out.append((loss.item(), model, launches()))
    (lk, mk, ck), (lp, mp, cp) = out
    if sum(cp.values()) or 0 in ck.values():
        raise AssertionError(f"step parity launches: kernels {ck}, plain "
                             f"{cp}")
    worst, worst_name = 0.0, ""
    for (name, a), b in zip(mk.named_parameters(), mp.parameters()):
        err = max_err([a.grad], [b.grad], relative=True)
        if err > worst:
            worst, worst_name = err, name
    print(f"[parity] f32 step: loss kernels {lk:.7f} plain {lp:.7f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}); worst grad err / max|ref| "
          f"{worst:.2e} ({worst_name}); launches {json.dumps(ck)}")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"f32 step loss {lk} vs plain {lp}")
    if not worst <= 1e-4:
        raise AssertionError(f"f32 step grad {worst_name}: {worst} > 1e-4 "
                             f"of max|ref|")


def phase_f32_ids(seed, bs):
    """One batch at f32 through the kernel and through the plain version
    on the card, same weights and noise: the ids must be identical."""
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
    ids_k = make_greedy_decode_sweep(model_k, cfg)(inp, 0.0, n_stds, noise)
    ids_p = make_greedy_decode_sweep(model_p, cfg)(inp, 0.0, n_stds, noise)
    same = torch.equal(ids_k, ids_p)
    diff = (ids_k != ids_p).sum().item()
    print(f"[f32] kernel ids == plain ids: {same} ({diff} of "
          f"{ids_k.numel()} differ)")
    if not same:
        raise AssertionError("f32 decode through the kernel differs from "
                             "the plain version")


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
    """One bf16 sweep call (19 SNRs x bs rows) of the trained weights, and
    one bf16 train step at full width, each after a warm-up."""
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
    sweep(inp, 0.0, n_stds, noise)
    torch.cuda.synchronize()
    profiled("one sweep call", lambda: sweep(inp, 0.0, n_stds, noise))

    cfg = Config(bs=bs)
    model = steps.init_params(make_model(cfg), seed).cuda().train()
    state = steps.create_train_state(model, cfg)
    step = steps.make_train_step(model, cfg)
    inp = _train_batch(cfg, seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    for _ in range(3):
        step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, inp, inp, gen, n_std)
    torch.cuda.synchronize()
    print(f"[profile] one train step without the profiler: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    profiled("one train step", lambda: step(state, inp, inp, gen, n_std))


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
}


def kernels_line(rows, serve, train):
    """One entry per kernel, from its bf16 row at the path shape that
    matters most; `launches` is the training path's count (this slice's
    main path), `launches_by_path` both paths'."""
    out = []
    for kernel, (replaces, case, at) in KERNEL_INFO.items():
        row = next(r for r in rows if r["kernel"] == kernel
                   and r["case"] == case and r["dtype"] == "bfloat16")
        out.append({
            "name": kernel, "route": "cuda",
            "source": f"deepsc_gan_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": train[kernel],
            "launches_by_path": {"serve": serve[kernel],
                                 "train": train[kernel]},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "at": at})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    rows = phase_kernels(args.seed, len(SNRS) * args.bs, args.bs,
                         args.iters)
    serve = phase_main_path(args.seed, args.batches, args.bs)
    phase_f32_ids(args.seed, args.bs)
    train, _ = phase_train(args.seed, args.epochs, args.bs)
    phase_step_parity(args.seed, args.bs)
    phase_profile(args.seed, args.bs)
    kernels = kernels_line(rows, serve, train)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
