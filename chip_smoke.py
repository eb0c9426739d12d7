#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepsc_gan_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 2]

Phases, each printing its lines; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the serving path, compiled by nvcc from the
   sources in this checkout (all nvcc processes started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, with the tolerance stated; the
   kernel's time, the plain version's, one PyTorch library call's (a
   yardstick the port never calls), and the least time the card could take;
4. main path: the port's CLI runs the greedy BLEU-vs-SNR sweep (SNR 0..18
   dB) of the trained transceiver (results/plain_best_params.pkl) in bf16
   on synthetic batches of 64 made from --seed; every kernel's launch count
   is set to 0 just before and read just after, and must equal what the
   path makes; then one batch is decoded at f32 through the kernels and
   through the plain versions, and the ids must be identical;
5. profile: device time by kernel over one bf16 sweep call, and the
   device's idle share in it (torch.profiler);
6. the kernels as one JSON line, then `{"ok": true, "device": {...}}` as
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
from deepsc_gan_tpu_torch.evaluate.metrics import SNR_to_noise
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
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
# magnitude up to ~4 -> 2^-8 * 4 * 2 steps
TOL = {torch.float32: 1e-5, torch.bfloat16: 3.2e-2}


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
    seconds = build.build([attn.KERNEL], force=True)
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


def attention_case(label, n, lq, lk, dtype, gen, iters):
    q, k, v, bias = attention_inputs(n, lq, lk, dtype, gen, lq == lk)
    scale = math.sqrt(DH)
    out = attn.fused_attention(q, k, v, bias, HEADS, scale)
    ref = attn.attention_fwd_reference(q, k, v, bias, HEADS, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"attention kernel {label} {dtype}: max abs "
                             f"err {err} > {TOL[dtype]}")
    ms, host_ms = cuda_ms(
        lambda: attn.fused_attention(q, k, v, bias, HEADS, scale), iters)
    plain_ms, _ = cuda_ms(
        lambda: attn.attention_fwd_reference(q, k, v, bias, HEADS, scale),
        iters)
    # yardstick: one library call with the same additive mask (the port
    # never calls it)
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], HEADS, DH).transpose(1, 2)
                  for t in (q, k, v))
    mask4 = bias[:, None].to(dtype)
    library_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask4, scale=1.0 / scale), iters)
    elt = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elt \
        + bias.numel() * 4
    ops = 2 * 2 * n * HEADS * lq * lk * DH
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "n": n, "lq": lq, "lk": lk, "max_abs_err": err,
           "tol": TOL[dtype], "ms": ms, "host_enqueue_ms": host_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "ops": ops}
    print("[kernel] " + json.dumps(row))
    return row


def phase_kernels(seed, n, iters):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, lq, lk in (("encoder", 32, 32), ("decoder_self", 31, 31),
                              ("decoder_cross", 31, 32)):
            rows.append(attention_case(label, n, lq, lk, dtype, gen, iters))
    return rows


def phase_main_path(seed, batches, bs):
    attn.reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["evaluate", "--variant", "transformer",
                    "--eval-mode", "greedy", "--params-pkl", PARAMS,
                    "--dtype", "bfloat16", "--bs", str(bs),
                    "--eval-batches", str(batches), "--seed", str(seed),
                    "--snr-lo", str(SNRS[0]), "--snr-hi", str(SNRS[-1]),
                    "--device", "cuda", "--log-save-path", "log/chip_smoke"])
    wall = time.perf_counter() - t0
    launches = attn.launches
    cfg = Config()
    # encoder: one self-attention per layer, once per batch; decoder: self
    # and cross per layer at each of max_length steps
    expected = (cfg.encoder_num_layer
                + 2 * cfg.decoder_num_layer * cfg.max_length) * batches
    print(f"[main] attention_fwd launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"attention kernel launched {launches} times "
                             f"on the main path, expected {expected}")
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
    return launches


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


def phase_profile(seed, bs):
    """Device time by kernel over one bf16 sweep call (19 SNRs x bs rows),
    from torch.profiler, and the share of the call's wall time in which
    the device ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(inp, 0.0, n_stds, noise)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler recorded no device activity: "
              "device time not measured")
        return
    by_name = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + dur, cnt + 1)
    total = sum(t for t, _ in by_name.values())
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    print(f"[profile] one sweep call: wall {wall_us / 1e3:.2f} ms, kernels "
          f"{len(kernels)}, device busy {busy / 1e3:.2f} ms "
          f"(idle share {1 - busy / wall_us:.3f}), kernel time "
          f"{total / 1e3:.2f} ms")
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {tot / total:6.1%} {tot / 1e3:8.3f} ms "
              f"{cnt:6d} x {tot / cnt:8.2f} us  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    rows = phase_kernels(args.seed, len(SNRS) * args.bs, args.iters)
    launches = phase_main_path(args.seed, args.batches, args.bs)
    phase_f32_ids(args.seed, args.bs)
    phase_profile(args.seed, args.bs)
    # the serving path's dominant call: decoder self-attention in bf16
    main_row = next(r for r in rows if r["case"] == "decoder_self"
                    and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "deepsc_gan_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "deepsc_gan_tpu/ops/pallas/attention.py:125",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": "decoder self-attention, bf16, N=%d Lq=Lk=31 H=8 Dh=16"
              % main_row["n"]}]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
