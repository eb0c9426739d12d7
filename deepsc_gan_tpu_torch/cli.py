"""Command-line entry points of the port: the greedy BLEU-vs-SNR sweep of
the vanilla transceiver (the JAX package's `cli evaluate --variant
transformer --eval-mode greedy`, without `--kv-cache`) and its plain
teacher-forced training (`cli train --variant transformer --train-mode
plain`, one device, one step per call).

  python -m deepsc_gan_tpu_torch.cli evaluate --variant transformer \
      --eval-mode greedy --params-pkl results/plain_best_params.pkl \
      --snr-lo 0 --snr-hi 18 --eval-batches 8
  python -m deepsc_gan_tpu_torch.cli train --variant transformer \
      --train-mode plain --epochs 3

Weights come from a params pickle in the `results/*_params.pkl` format
(whether the decoder is tied is read from the tree); without one the model
is initialised at random from `--seed` (flax's initialisers). Data come
from `--test-save-path` / `--train-save-path`, or from synthetic sentences
made from `--seed` when the file does not exist; the vocab from
`--vocab-path`, or an identity vocab. Channel noise and dropout masks are
drawn from a `torch.Generator` seeded with `--seed`. Training logs the loss
every `--log-every` steps and sentences/s per epoch to
`<log-save-path>/train.jsonl`, and saves the params (the EMA shadow when
`--ema-decay` is on) as `<checkpoint-path>/<variant>_params.pkl` in the
`results/*_params.pkl` format. Runs on CUDA unless `--device` names another
device.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import torch

from deepsc_gan_tpu_torch.data.loader import eval_batches, train_dataset
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.evaluate.evaluator import (
    save_result_table,
    snr_sweep_bleu_fast,
)
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.models.channel import snr_to_noise
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.train.steps import (
    create_train_state,
    eval_params,
    init_params,
    make_train_step,
)
from deepsc_gan_tpu_torch.utils.config import (
    Config,
    add_config_args,
    config_from_args,
)
from deepsc_gan_tpu_torch.utils.convert import (
    is_tied,
    load_into,
    load_params_pickle,
    state_dict_to_flax,
)
from deepsc_gan_tpu_torch.utils.device import resolve_device
from deepsc_gan_tpu_torch.utils.logging import MetricLogger


def load_model(cfg: Config, params_pkl, device, seed: int = 0):
    """(cfg, model) on `device`, in eval mode: weights from `params_pkl`
    (cfg's tie_embeddings set from the tree), else a random init from
    `seed`."""
    if params_pkl:
        params = load_params_pickle(params_pkl)
        cfg = cfg.replace(tie_embeddings=is_tied(params))
        model = load_into(make_model(cfg), params)
    else:
        print("[cli] no --params-pkl; using random init", file=sys.stderr)
        model = init_params(make_model(cfg), seed)
    return cfg, model.to(device).eval()


def cmd_evaluate(args) -> dict:
    """Run the sweep; -> {"table", "sequences", "decode_seconds",
    "device"}. decode_seconds holds one entry per batch: the sweep call
    up to its ids on the host."""
    device = resolve_device(args.device)
    cfg, model = load_model(config_from_args(args), args.params_pkl, device,
                            args.seed)
    vocab = (Vocab.load(cfg.vocab_path) if os.path.exists(cfg.vocab_path)
             else Vocab.identity(cfg.vocab_size))
    batches = eval_batches(cfg.test_save_path, cfg.seq_len, cfg.vocab_size,
                           cfg.bs, args.eval_batches, args.seed)
    snrs = list(range(args.snr_lo, args.snr_hi + 1))
    sweep = make_greedy_decode_sweep(model, cfg)
    seconds = []

    def timed_sweep(*a):
        t0 = time.perf_counter()
        ids = sweep(*a).cpu()
        seconds.append(time.perf_counter() - t0)
        return ids

    gen = torch.Generator(device=device).manual_seed(args.seed)
    table = snr_sweep_bleu_fast(timed_sweep, batches, vocab, cfg, gen,
                                snrs=snrs, pnr_db=args.pnr_db)
    for snr, bleu in table:
        print(f"SNR={snr:.0f}dB {bleu:.4f}")
    save_result_table(table, os.path.join(
        cfg.log_save_path, f"test-{args.variant}-{args.eval_mode}.pkl"))
    return {"table": table, "device": str(device),
            "sequences": len(snrs) * sum(len(b) for b in batches),
            "decode_seconds": seconds}


def save_params_pickle(path: str, params, cfg: Config, recipe: dict) -> str:
    """Write `{"params": flax tree of numpy arrays, "recipe": recipe}` (the
    `results/*_params.pkl` format) from a state_dict-like mapping."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": state_dict_to_flax(params, cfg),
                     "recipe": recipe}, f)
    return path


def cmd_train(args) -> dict:
    """Train for cfg.epochs epochs; -> {"losses" (every step's, on the
    host), "steps", "epoch_seconds", "sents_per_sec", "params_path",
    "device"}."""
    device = resolve_device(args.device)
    cfg, model = load_model(config_from_args(args), args.params_pkl, device,
                            args.seed)
    model.train()
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    ds = train_dataset(cfg.train_save_path, cfg.seq_len, cfg.vocab_size,
                       cfg.bs, args.seed)
    n_std = float(snr_to_noise(cfg.train_snr))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] variant={args.variant} mode={args.train_mode} "
          f"device={device} params={n_params:,}")
    logger = MetricLogger(os.path.join(cfg.log_save_path, "train.jsonl"))
    losses, epoch_seconds, rates = [], [], []
    for epoch in range(cfg.epochs):
        ds.set_epoch(epoch)
        t0 = time.perf_counter()
        for inp, _ in ds:
            batch = torch.from_numpy(inp).to(device, torch.long)
            state, loss = step(state, batch, batch, gen, n_std)
            losses.append(loss)
            if state.step % args.log_every == 0:
                logger.log(epoch=epoch, step=state.step, loss=loss)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        epoch_seconds.append(dt)
        rates.append(len(ds) * cfg.bs / dt)
        logger.log(epoch=epoch, epoch_time=dt, sents_per_sec=rates[-1])
    logger.close()
    path = save_params_pickle(
        os.path.join(cfg.checkpoint_path, f"{args.variant}_params.pkl"),
        eval_params(state), cfg,
        {"variant": args.variant, "train_mode": args.train_mode,
         "epochs": cfg.epochs, "steps": state.step, "seed": args.seed,
         "tie_embeddings": cfg.tie_embeddings, "schedule": cfg.schedule,
         "lr": cfg.lr, "ema_decay": cfg.ema_decay, "dtype": cfg.dtype})
    print(f"[train] done: {state.step} steps; params -> {path}")
    return {"losses": torch.stack(losses).float().cpu() if losses
            else torch.zeros(0), "steps": state.step,
            "epoch_seconds": epoch_seconds, "sents_per_sec": rates,
            "params_path": path, "device": str(device)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="deepsc_gan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("evaluate")
    add_config_args(p)
    p.add_argument("--variant", default="transformer",
                   choices=["transformer"])
    p.add_argument("--eval-mode", default="greedy", choices=["greedy"])
    p.add_argument("--params-pkl", default=None,
                   help="flax params pickle (results/*_params.pkl format)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pnr-db", type=float, default=0.0)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--snr-lo", type=int, default=0)
    p.add_argument("--snr-hi", type=int, default=18)

    t = sub.add_parser("train")
    add_config_args(t)
    t.add_argument("--variant", default="transformer",
                   choices=["transformer"])
    t.add_argument("--train-mode", default="plain", choices=["plain"])
    t.add_argument("--params-pkl", default=None,
                   help="start from these weights (results/*_params.pkl "
                        "format)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=10)
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return cmd_train(args) if args.cmd == "train" else cmd_evaluate(args)


if __name__ == "__main__":
    main()
