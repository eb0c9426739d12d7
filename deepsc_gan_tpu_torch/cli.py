"""Command-line entry point of the port: the greedy BLEU-vs-SNR sweep of the
vanilla transceiver (the JAX package's `cli evaluate --variant transformer
--eval-mode greedy`, without `--kv-cache`).

  python -m deepsc_gan_tpu_torch.cli evaluate --variant transformer \
      --eval-mode greedy --params-pkl results/plain_best_params.pkl \
      --snr-lo 0 --snr-hi 18 --eval-batches 8

Weights come from a params pickle in the `results/*_params.pkl` format
(whether the decoder is tied is read from the tree); without one the model
is initialised at random from `--seed`. Test data come from
`--test-save-path`, or from synthetic sentences made from `--seed` when the
file does not exist; the vocab from `--vocab-path`, or an identity vocab.
The channel noise is drawn from a `torch.Generator` seeded with `--seed`.
Runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from deepsc_gan_tpu_torch.data.loader import eval_batches
from deepsc_gan_tpu_torch.data.vocab import Vocab
from deepsc_gan_tpu_torch.evaluate.evaluator import (
    save_result_table,
    snr_sweep_bleu_fast,
)
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.utils.config import (
    Config,
    add_config_args,
    config_from_args,
)
from deepsc_gan_tpu_torch.utils.convert import (
    is_tied,
    load_into,
    load_params_pickle,
)
from deepsc_gan_tpu_torch.utils.device import resolve_device


def load_model(cfg: Config, params_pkl, device, seed: int = 0):
    """(cfg, model) on `device`, in eval mode: weights from `params_pkl`
    (cfg's tie_embeddings set from the tree), else a random init from
    `seed`."""
    if params_pkl:
        params = load_params_pickle(params_pkl)
        cfg = cfg.replace(tie_embeddings=is_tied(params))
        model = load_into(make_model(cfg), params)
    else:
        print("[eval] no --params-pkl; using random init", file=sys.stderr)
        torch.manual_seed(seed)
        model = make_model(cfg)
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
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return cmd_evaluate(args)


if __name__ == "__main__":
    main()
