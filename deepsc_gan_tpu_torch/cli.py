"""Command-line entry points of the port: the BLEU-vs-SNR sweeps and the
teacher-forced attack tables (the JAX package's `cli evaluate`, scored by
`--metric bleu|similarity|both`), `transmit` (sentences through the
transceiver at one SNR), `export` (the serving sweep through
`torch.export`), `preprocess` (the corpus pipeline), `baseline` (the
classical Huffman + turbo + QAM curve), and teacher-forced training, plain, FGM-adversarial, the GAN's three phases or
MINE (`cli train --train-mode plain|attack|gan|mine`, one device; plain
mode K = `--scan-steps` steps a call, 32 by default as in the JAX CLI, on
CUDA K replays of one captured CUDA graph of the step; the others one step
a call), of the vanilla transceiver (`--variant transformer`), the star
ones (`--variant star`, the single-block SE/SD codec, or `star_multi`) and
the GAN ones (`--variant gan` around the vanilla codec, `gan_star` around
SE/SD, a star variant; `--train-mode gan` trains only these; `mine` only
the vanilla transceiver, as the JAX MINE step runs for it alone). The
evaluation modes:
- `greedy`: the greedy sweep, full-prefix or `--kv-cache`; a star decoder
  is decoded in one shot (position i predicts token i), with or without
  `--kv-cache`;
- `beam`, with `--beam-size` and `--beam-impl kv|full` (no star);
- `greedy_attack`: greedy decoding through a channel carrying the FGM
  perturbation of each batch, at `--pnr-db`; `greedy_gan` the same (the
  JAX package's GAN decode, which also returns the clean teacher-forced
  argmax);
- `teacher_forced` and `pgd`: the teacher-forced FGM and PGD attack
  tables, [snr, clean BLEU, attacked BLEU, loss clean, loss attacked] per
  SNR, written to `<log-save-path>/eval-<variant>.pkl` (the others write
  `test-<variant>-<eval-mode>.pkl`); for a GAN variant both run its FGM
  step (`train/gan_steps.py:make_gan_eval_step`), as the JAX CLI does.
`--channel AWGN|Rayleigh|Rician`, with `--equalizer` and
`--fading-per-sample`, applies to every mode and to training. Star
decoders score the un-shifted target in training and in the attacks. An
unset `--seq-len` is 31 for the star variants and 32 for the vanilla one.
Before any model is built, a run on CUDA stops with a message naming the
flag when a kernel it would launch does not take its shapes
(`ops/envelope.py`).

  python -m deepsc_gan_tpu_torch.cli evaluate --variant transformer \
      --eval-mode greedy --kv-cache \
      --params-pkl results/plain_best_params.pkl --eval-batches 8
  python -m deepsc_gan_tpu_torch.cli evaluate --eval-mode beam \
      --beam-size 4 --params-pkl results/plain_best_params.pkl
  python -m deepsc_gan_tpu_torch.cli evaluate --eval-mode teacher_forced \
      --pnr-db 0 --channel Rayleigh --params-pkl results/plain_best_params.pkl
  python -m deepsc_gan_tpu_torch.cli train --variant transformer \
      --train-mode plain --epochs 3
  python -m deepsc_gan_tpu_torch.cli train --train-mode attack \
      --adv-weight 0.5 --pnr-db 0 --epochs 3
  python -m deepsc_gan_tpu_torch.cli train --variant star --epochs 2
  python -m deepsc_gan_tpu_torch.cli evaluate --variant star
  python -m deepsc_gan_tpu_torch.cli train --variant gan --train-mode gan
  python -m deepsc_gan_tpu_torch.cli evaluate --variant gan \
      --eval-mode greedy_gan
  python -m deepsc_gan_tpu_torch.cli evaluate --metric both  # + BERT
  python -m deepsc_gan_tpu_torch.cli transmit --snr 6 --text "the house"
  python -m deepsc_gan_tpu_torch.cli export --out model_decode.pt2
  python -m deepsc_gan_tpu_torch.cli preprocess --input-data-dir data/txt/en
  python -m deepsc_gan_tpu_torch.cli baseline --data sentences.pkl

Weights come from a params pickle in the `results/*_params.pkl` format
(whether the decoder is tied is read from the tree): `--params-pkl`, or for
`evaluate` the `<checkpoint-path>/<variant>_params.pkl` that `train` saves
when it exists, else the latest epoch checkpoint under
`<checkpoint-path>/<variant>/` (its EMA shadow when it holds one); without
any of them the model is initialised at random from `--seed` (flax's
initialisers). The evaluation set is `--test-save-path`, or
synthetic sentences made from seed 0 when the file does not exist (as the
JAX CLI); the training set `--train-save-path`, or synthetic sentences made
from `--seed`. The vocab comes from `--vocab-path`, or is an identity vocab.
Channel draws and dropout masks come from a `torch.Generator` seeded with
`--seed`. The greedy sweeps decode every SNR point of a batch in one call;
beam search, the attacked decode and the attack tables make one call per
(SNR, batch). Training logs the loss (with `--train-mode attack`, the clean
and the adversarial one; with `gan`, the receiver's loss, g_loss and
d_loss) every `--log-every` steps (plain mode at K steps a call: every
`--log-every` calls, the call's last loss) and sentences/s per epoch to `<log-save-path>/train.jsonl`, and saves the params (the EMA
shadow when `--ema-decay` is on) as `<checkpoint-path>/<variant>_params.pkl`
in the `results/*_params.pkl` format. It also saves an epoch checkpoint
every `--ckpt-every` epochs and after the last (`utils/checkpoint.py`:
`<checkpoint-path>/<variant>/<epoch>/`, the newest 5 kept; the port's own
format, not Orbax's), and `--resume` continues from the latest one,
bit-identical to the run that was not stopped: the params, Adam's moments
and counts, the update count, the EMA shadow and the training generator's
state are restored, and each epoch's shuffle (and augmentation) is a
function of (seed, epoch). With `--scan-steps K` this holds when K divides
an epoch's batches (the K-stacks run on across epoch boundaries, and a
resumed run starts a new stack); resume on the device type that saved
(the generator's state is the device's). In `mine` mode T, MINE's
statistics network, restarts fresh on resume and is not saved, as in the
JAX package. `--profile DIR` traces the first epoch (torch.profiler, a
Chrome trace in `DIR/trace.json`). The training set takes `--aug-crop`,
`--aug-concat`, `--aug-synth` (`data/augment.py`); `--remat` and
`--fuse-qkv` change how the models compute, not what (the Config
docstring lists the flags accepted without effect). Runs on CUDA unless
`--device` names another device.

Parallel runs, one process a rank under a launcher, each rank on
`cuda:LOCAL_RANK % device_count` (`parallel/`): `train --distributed --dp
N` trains data-parallel (the rows of each global batch split over N ranks,
the gradients averaged; one eager step a call, as the JAX CLI's dp path),
`evaluate --distributed --snr-parallel N` splits the greedy, KV and beam
sweeps' SNR points over N ranks; `--dp x --snr-parallel` must be the
launcher's world size. The backend is NCCL where every rank has a card of
its own, gloo where ranks share one or on the CPU. Only rank 0 prints and
writes logs, tables and checkpoints. `--tp` and `--pp` above 1 stop with
the ROADMAP item that will bring them.

  torchrun --nproc-per-node 2 -m deepsc_gan_tpu_torch.cli train \
      --distributed --dp 2 --epochs 3
  torchrun --nproc-per-node 2 -m deepsc_gan_tpu_torch.cli evaluate \
      --distributed --snr-parallel 2 --snr-lo 0 --snr-hi 17 --kv-cache
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import sys
import time

import torch
import torch.distributed as dist

from deepsc_gan_tpu_torch.baselines.pipeline import classical_sweep
from deepsc_gan_tpu_torch.data import preprocess
from deepsc_gan_tpu_torch.data.augment import load_train_dataset
from deepsc_gan_tpu_torch.data.loader import eval_batches, stacked_batches
from deepsc_gan_tpu_torch.data.vocab import SeqToText, Vocab
from deepsc_gan_tpu_torch.evaluate.beam import (
    make_beam_decode,
    make_beam_decode_kv,
    make_beam_decode_sweep,
)
from deepsc_gan_tpu_torch.evaluate.evaluator import (
    METRICS,
    save_result_table,
    snr_sweep_bleu,
    snr_sweep_bleu_fast,
    teacher_forced_sweep,
)
from deepsc_gan_tpu_torch.evaluate.greedy import (
    make_greedy_decode,
    make_greedy_decode_attack,
    make_greedy_decode_gan,
    make_greedy_decode_sweep,
)
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.evaluate.metrics import SNR_to_noise
from deepsc_gan_tpu_torch.models.channel import draw_channel, snr_to_noise
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops.attention_kernel import plain_attention
from deepsc_gan_tpu_torch.ops.envelope import check_envelope
from deepsc_gan_tpu_torch.ops.star_kernel import plain_satellite
from deepsc_gan_tpu_torch.ops.topk_kernel import topk_logits_reference
from deepsc_gan_tpu_torch.parallel import mesh as pmesh
from deepsc_gan_tpu_torch.parallel import sharding
from deepsc_gan_tpu_torch.train.gan_steps import (
    make_gan_eval_step,
    make_gan_train_step,
)
from deepsc_gan_tpu_torch.train.mine_steps import (
    create_mine_state,
    make_mine_train_step,
)
from deepsc_gan_tpu_torch.train.steps import (
    create_train_state,
    eval_params,
    init_params,
    make_eval_step,
    make_eval_step_pgd,
    make_train_attack_step,
    make_train_multi_step,
    make_train_step,
)
from deepsc_gan_tpu_torch.utils.checkpoint import CheckpointManager
from deepsc_gan_tpu_torch.utils.config import (
    VARIANTS,
    Config,
    add_config_args,
    config_from_args,
    default_seq_len,
    is_gan,
    is_star,
)
from deepsc_gan_tpu_torch.utils.convert import (
    is_tied,
    load_into,
    load_params_pickle,
    state_dict_to_flax,
)
from deepsc_gan_tpu_torch.utils.device import resolve_device
from deepsc_gan_tpu_torch.utils.logging import MetricLogger
from deepsc_gan_tpu_torch.utils.profiling import annotate, trace


def variant_config(args) -> Config:
    """Config from args, an unset --seq-len resolved for the variant (JAX
    CLI `_variant_config`)."""
    cfg = config_from_args(args)
    if args.seq_len is None:
        cfg = cfg.replace(seq_len=default_seq_len(args.variant))
    return cfg


def load_model(cfg: Config, params_pkl, device, seed: int = 0,
               variant: str = "transformer", state_dict=None, **ops):
    """(cfg, model of `variant`) on `device`, in eval mode: weights from
    `params_pkl` (cfg's tie_embeddings set from the tree), else from
    `state_dict` (an epoch checkpoint's; tied when it holds the decoder's
    `final_bias`), else a random init from `seed`. `ops` (`attention`,
    `satellite`) go to `make_model`."""
    if params_pkl:
        params = load_params_pickle(params_pkl)
        cfg = cfg.replace(tie_embeddings=is_tied(params))
        model = load_into(make_model(cfg, variant, **ops), params)
    elif state_dict is not None:
        cfg = cfg.replace(
            tie_embeddings="semantic_decoder.final_bias" in state_dict)
        model = make_model(cfg, variant, **ops)
        model.load_state_dict(state_dict, strict=True)
    else:
        print("[cli] no params pickle; using random init", file=sys.stderr)
        model = init_params(make_model(cfg, variant, **ops), seed)
    return cfg, model.to(device).eval()


def evaluate_params_path(args, cfg: Config):
    """`--params-pkl`, else the `<checkpoint-path>/<variant>_params.pkl`
    that `cli train` saves when it exists (as the JAX CLI restores what its
    `train` wrote), else None."""
    if args.params_pkl:
        return args.params_pkl
    saved = os.path.join(cfg.checkpoint_path, f"{args.variant}_params.pkl")
    return saved if os.path.exists(saved) else None


def latest_checkpoint_params(cfg: Config, variant: str):
    """(the latest epoch checkpoint's directory, the parameters evaluation
    uses from it: the EMA shadow when it holds one) under
    `<checkpoint-path>/<variant>/`, as the JAX CLI's `_restore_latest`;
    (None, None) when there is none."""
    directory = os.path.join(cfg.checkpoint_path, variant)
    if not os.path.isdir(directory):
        return None, None
    mgr = CheckpointManager(directory)
    epoch = mgr.latest_epoch()
    if epoch is None:
        return None, None
    return os.path.join(directory, str(epoch)), mgr.eval_params(epoch)


def restore_model(args, cfg: Config, device, tag: str, **ops):
    """(cfg, model in eval mode on `device`, where its weights came from or
    None) for `evaluate`, `transmit` and `export`: `--params-pkl`, else the
    params `train` saved, else the latest epoch checkpoint (its EMA shadow
    when it holds one), else a random init from --seed. `ops` (export: the
    plain versions) go to `make_model`."""
    pickled = evaluate_params_path(args, cfg)
    checkpoint, restored = ((None, None) if pickled
                            else latest_checkpoint_params(cfg, args.variant))
    params_path = pickled or checkpoint
    if params_path:
        print(f"[{tag}] params from {params_path}", file=sys.stderr)
    cfg, model = load_model(cfg, pickled, device, args.seed, args.variant,
                            restored, **ops)
    return cfg, model, params_path


def load_vocab(cfg: Config) -> Vocab:
    """`--vocab-path`, or the identity vocab when the file does not
    exist (the JAX CLI's `_load_vocab`)."""
    return (Vocab.load(cfg.vocab_path) if os.path.exists(cfg.vocab_path)
            else Vocab.identity(cfg.vocab_size))


def parallel_mesh(args, cfg: Config, device, snr_parallel: int = 1):
    """The run's (snr, dp) mesh, or None for a single process: the JAX
    CLI's checks (--tp and --pp are not in the port; bs divisible by --dp),
    then with --distributed the launcher's process group joined; --dp x
    --snr-parallel must equal its world size. SystemExit otherwise."""
    if cfg.tp > 1:
        raise SystemExit(f"--tp {cfg.tp}: the vocab-parallel CE is not in "
                         "the port yet (ROADMAP §A.2.2); run with --tp 1")
    if cfg.pp > 1:
        raise SystemExit(f"--pp {cfg.pp}: GPipe is not in the port yet "
                         "(ROADMAP §A.2.3); run with --pp 1")
    if cfg.dp < 1 or snr_parallel < 1:
        raise SystemExit("--dp and --snr-parallel must be at least 1")
    if cfg.bs % cfg.dp:
        raise SystemExit(f"batch size {cfg.bs} not divisible by --dp "
                         f"{cfg.dp}")
    if args.distributed:
        pmesh.initialize_distributed(device.type)
    world = pmesh.world_size()
    want = cfg.dp * snr_parallel
    if want != world:
        have = (f"the process group has {world}" if dist.is_initialized()
                else "there is no process group")
        raise SystemExit(
            f"--dp {cfg.dp} x --snr-parallel {snr_parallel} = {want} ranks, "
            f"but {have}: start one process a rank under a launcher and "
            f"pass --distributed, e.g. torchrun --nproc-per-node {want} -m "
            f"deepsc_gan_tpu_torch.cli {args.cmd} --distributed ...")
    if not dist.is_initialized():
        return None
    return pmesh.make_mesh(dp=cfg.dp, snr=snr_parallel)


class _Quiet:
    """The metric logger of a rank other than 0: logs nothing."""

    def log(self, **metrics):
        return metrics

    def close(self) -> None:
        pass


EVAL_MODES = ("greedy", "beam", "greedy_attack", "greedy_gan",
              "teacher_forced", "pgd")


def cmd_evaluate(args) -> dict:
    """Run the sweep or the attack table; -> {"table", "sequences",
    "decode_seconds", "params_path", "device", "eps_star"}. decode_seconds
    holds one entry per call (a greedy sweep call per batch; a beam,
    attacked decode or attack-table call per SNR and batch), up to its
    result on the host; eps_star the PGD strength of each `pgd` call."""
    star = is_star(args.variant)
    if star and args.eval_mode == "beam":
        raise SystemExit(
            "beam search requires an autoregressive decoder; star decoders "
            "are non-autoregressive (position i predicts token i from the "
            "channel signal) — use --eval-mode greedy, which decodes "
            "them in one shot")
    device = resolve_device(args.device)
    cfg = variant_config(args)
    snrs = list(range(args.snr_lo, args.snr_hi + 1))
    if args.snr_parallel > 1:
        if args.eval_mode not in ("greedy", "beam"):
            raise SystemExit("--snr-parallel splits the greedy and beam "
                             "sweeps (--eval-mode greedy or beam)")
        if len(snrs) % args.snr_parallel:
            raise SystemExit(
                f"--snr-parallel {args.snr_parallel} must divide the "
                f"number of SNR points ({len(snrs)})")
        if args.eval_mode == "beam" and args.beam_impl == "full":
            raise SystemExit("--snr-parallel beam runs the KV-cached "
                             "serving impl (--beam-impl kv)")
    mesh = parallel_mesh(args, cfg, device, args.snr_parallel)
    if mesh is not None and device.type == "cuda":
        device = pmesh.rank_device()
    lead = pmesh.rank() == 0
    check_envelope(cfg, args.variant, args.eval_mode, args.beam_size,
                   args.kv_cache, args.beam_impl, device)
    cfg, model, params_path = restore_model(args, cfg, device, "eval")
    vocab = load_vocab(cfg)
    # seed 0, as the JAX CLI's test set (its `_load_dataset` default)
    batches = eval_batches(cfg.test_save_path, cfg.seq_len, cfg.vocab_size,
                           cfg.bs, args.eval_batches)
    seconds, eps_star = [], []

    def timed(fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            if isinstance(out, tuple) and len(out) > 2:  # an attack table's
                if len(out) > 4:
                    eps_star.append(float(out[4]))
                out = (float(out[0]), float(out[1])) + out[2:4]
            elif isinstance(out, tuple):  # greedy_gan: (ids, noa)
                out = tuple(x.cpu() for x in out)
            else:
                out = out.cpu()
            seconds.append(time.perf_counter() - t0)
            return out
        return call

    gen = torch.Generator(device=device).manual_seed(args.seed)
    position_mode = "oneshot" if star else "step"
    name = f"test-{args.variant}-{args.eval_mode}.pkl"
    if args.eval_mode in ("teacher_forced", "pgd"):
        # a GAN model's teacher-forced table is its own FGM step, for pgd
        # too (the JAX CLI tests for a GAN variant first)
        if is_gan(args.variant):
            make = make_gan_eval_step
        elif args.eval_mode == "pgd":
            make = make_eval_step_pgd
        else:
            make = make_eval_step
        table = teacher_forced_sweep(
            timed(make(model, cfg, full_target=star)), batches, vocab, cfg,
            gen, snrs=snrs, pnr_db=args.pnr_db, epsilon=args.epsilon,
            metric=args.metric)
        for row in table if lead else ():
            print(f"SNR={row[0]:.0f}dB metrics(clean|attacked)="
                  + " ".join(f"{m:.4f}" for m in row[1:-2])
                  + f" loss={row[-2]:.4f}/{row[-1]:.4f}")
        name = f"eval-{args.variant}.pkl"
    else:
        if args.eval_mode == "beam" and args.snr_parallel > 1:
            # every SNR point of a batch in one call, the points split
            # over the snr ranks (the JAX CLI's sharded beam sweep)
            sweep = sharding.make_parallel_beam_sweep(model, cfg, mesh,
                                                      args.beam_size)
            table = snr_sweep_bleu_fast(timed(sweep), batches, vocab, cfg,
                                        gen, snrs=snrs, pnr_db=args.pnr_db,
                                        metric=args.metric)
        elif args.eval_mode == "beam":
            make = make_beam_decode if args.beam_impl == "full" \
                else make_beam_decode_kv
            table = snr_sweep_bleu(timed(make(model, cfg, args.beam_size)),
                                   batches, vocab, cfg, gen, snrs=snrs,
                                   pnr_db=args.pnr_db, metric=args.metric)
        elif args.eval_mode in ("greedy_attack", "greedy_gan"):
            make = make_greedy_decode_gan if args.eval_mode == "greedy_gan" \
                else make_greedy_decode_attack
            decode = make(model, cfg, position_mode=position_mode,
                          full_target=star)
            table = snr_sweep_bleu(timed(decode), batches, vocab, cfg, gen,
                                   snrs=snrs, pnr_db=args.pnr_db, draws=2,
                                   decode_extra_args=(args.epsilon,),
                                   metric=args.metric)
        else:
            # the KV decoder is autoregressive: a star decoder is decoded in
            # one shot with or without --kv-cache, as the JAX CLI does
            if star:
                sweep = make_greedy_decode_sweep(model, cfg, "oneshot")
            elif args.kv_cache:
                sweep = make_greedy_decode_kv_sweep(model, cfg)
            else:
                sweep = make_greedy_decode_sweep(model, cfg)
            if args.snr_parallel > 1:
                sweep = sharding.sharded_sweep(sweep, mesh)
            table = snr_sweep_bleu_fast(timed(sweep), batches, vocab, cfg,
                                        gen, snrs=snrs, pnr_db=args.pnr_db,
                                        metric=args.metric)
        if lead:
            for snr, *ms in table:
                print(f"SNR={snr:.0f}dB "
                      + " ".join(f"{m:.4f}" for m in ms))
    if lead:
        save_result_table(table, os.path.join(cfg.log_save_path, name))
    return {"table": table, "device": str(device),
            "sequences": len(snrs) * sum(len(b) for b in batches),
            "decode_seconds": seconds, "params_path": params_path,
            "eps_star": eps_star}


def save_params_pickle(path: str, params, cfg: Config, recipe: dict) -> str:
    """Write `{"params": flax tree of numpy arrays, "recipe": recipe}` (the
    `results/*_params.pkl` format) from a state_dict-like mapping."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": state_dict_to_flax(params, cfg),
                     "recipe": recipe}, f)
    return path


# The JAX MINE step shifts the target and was initialised for the vanilla
# symbols' width: every other variant fails in it (CPU run of
# deepsc_gan_tpu/train/mine_steps.py:make_mine_train_step on tiny_cfg)
MINE_REFUSAL = (
    "--train-mode mine trains the vanilla transceiver only (--variant "
    "transformer), as the JAX package's MINE step does: it always shifts the "
    "target, so the star decoders, which score the un-shifted one, fail "
    "there with 'Incompatible shapes for broadcasting: (4, 11, 1), "
    "(4, 12, 1)', and a GAN transceiver fails in MINE's fc0 (initialised for "
    "a (192, 256) kernel, given 536 inputs)")


def resume_from_checkpoint(cfg: Config, variant: str, state, gen) -> int:
    """Restore `state` and the generator `gen` from the latest epoch
    checkpoint under `<checkpoint-path>/<variant>/` -> its epoch, the first
    to train; SystemExit when there is none or nothing is left to train."""
    directory = os.path.join(cfg.checkpoint_path, variant)
    mgr = CheckpointManager(directory)
    latest = mgr.latest_epoch()
    if latest is None:
        raise SystemExit(f"--resume: no checkpoint under {directory}")
    mgr.restore(state, latest)
    gen.set_state(mgr.extra(latest)["generator"])
    if latest >= cfg.epochs:
        raise SystemExit(
            f"--resume: checkpoint is at epoch {latest}, nothing left to "
            f"train (--epochs {cfg.epochs})")
    print(f"[train] resumed epoch {latest} from {directory} (step "
          f"{state.step})")
    return latest


def cmd_train(args) -> dict:
    """Train to epoch cfg.epochs (from the latest checkpoint's with
    --resume); -> {"losses" (every step's of this run, on the host; with
    --train-mode attack the adversarial ones, with gan the receiver's, with
    mine the CE), "clean_losses" (attack: phase 1's clean losses),
    "g_losses", "d_losses" (gan), "mis" (mine: the MI estimates), "steps"
    (this run's), "start_epoch", "epoch_seconds", "sents_per_sec", "path",
    "params_path", "device"}. A GAN step makes three optimizer updates;
    the recipe saved with the params counts both.

    Plain mode runs `--scan-steps` K steps a call (`make_train_multi_step`:
    on CUDA K replays of one captured graph of the step), path `scanK`, as
    the JAX CLI's `lax.scan` path: K-stacks of batches that run on across
    epoch boundaries, len(ds) // K * K steps an epoch, a loss logged when
    (step // K) % --log-every == 0; `--scan-steps 1`, the attack and the
    GAN modes run one step a call (path `single`), MINE one step a call
    (path `mine`), a loss logged every --log-every steps. Step numbers in
    the log count from the first epoch, resumed runs included.

    With a process group (`--distributed`; `parallel_mesh`) every mode
    runs its data-parallel step (`parallel/sharding.py`), one eager step a
    call (path `dpN:<mode>`): each rank loads the same global batches and
    trains on its rows; the parameters start from rank 0's; only rank 0
    prints and writes the log, the checkpoints and the params ("params_path"
    None on the others)."""
    mode = args.train_mode
    if mode == "gan" and not is_gan(args.variant):
        raise SystemExit(f"--train-mode gan needs a GAN transceiver "
                         f"(--variant gan or gan_star), not "
                         f"{args.variant!r}")
    if mode == "mine" and args.variant != "transformer":
        raise SystemExit(MINE_REFUSAL)
    device = resolve_device(args.device)
    cfg = variant_config(args)
    mesh = parallel_mesh(args, cfg, device)
    if mesh is not None and device.type == "cuda":
        device = pmesh.rank_device()
    lead = pmesh.rank() == 0
    check_envelope(cfg, args.variant, "mine" if mode == "mine" else None,
                   device=device)
    cfg, model = load_model(cfg, args.params_pkl, device, args.seed,
                            args.variant)
    model.train()
    if mesh is not None:
        sharding.replicate(model, mesh)
    state = create_train_state(model, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    start_epoch = 0
    if args.resume:
        start_epoch = resume_from_checkpoint(cfg, args.variant, state, gen)
    star = is_star(args.variant)
    scan_k = max(1, args.scan_steps)
    scan = mode == "plain" and scan_k > 1 and mesh is None
    mine_state = None
    if mode == "mine":
        mine, mine_state = create_mine_state(cfg, args.seed, device=device)
    if mesh is not None:
        if mode == "attack":
            step = sharding.make_parallel_attack_step(
                model, cfg, mesh, full_target=star,
                adv_weight=args.adv_weight)
        elif mode == "gan":
            step = sharding.make_parallel_gan_step(model, cfg, mesh,
                                                   full_target=star)
        elif mode == "mine":
            step = sharding.make_parallel_mine_step(
                model, sharding.replicate(mine, mesh), cfg, mesh)
        else:
            step = sharding.make_parallel_train_step(model, cfg, mesh,
                                                     full_target=star)
    elif mode == "attack":
        step = make_train_attack_step(model, cfg, full_target=star,
                                      adv_weight=args.adv_weight)
    elif mode == "gan":
        step = make_gan_train_step(model, cfg, full_target=star)
    elif mode == "mine":
        step = make_mine_train_step(model, mine, cfg)
    elif scan:
        step = make_train_multi_step(model, cfg, full_target=star)
    else:
        step = make_train_step(model, cfg, full_target=star)
    if mesh is not None:
        path = f"dp{mesh.dp}:{mode}"
    else:
        path = f"scan{scan_k}" if scan else ("mine" if mode == "mine"
                                             else "single")
    ds = load_train_dataset(cfg, args.seed)
    if args.resume and scan and len(ds) % scan_k:
        print(f"[train] --resume: not bit-identical to a run not stopped: "
              f"--scan-steps {scan_k} does not divide the epoch's {len(ds)} "
              f"batches (the stacks run across epochs; a resumed run starts "
              f"a new one)", file=sys.stderr)
    n_std = float(snr_to_noise(cfg.train_snr))
    n_params = sum(p.numel() for p in model.parameters())
    if lead:
        print(f"[train] variant={args.variant} mode={mode} path={path} "
              f"device={device} params={n_params:,}")
        logger = MetricLogger(os.path.join(cfg.log_save_path,
                                           "train.jsonl"))
        ckpt = CheckpointManager(
            os.path.join(cfg.checkpoint_path, args.variant), max_to_keep=5)
    else:
        logger, ckpt = _Quiet(), None
    losses, clean_losses, g_losses, d_losses, mis = [], [], [], [], []
    epoch_seconds, rates = [], []
    stacker = stacked_batches(ds, scan_k) if scan else None
    per_epoch = max(1, len(ds) // scan_k) * scan_k if scan else len(ds)
    step_i = start_epoch * per_epoch
    profiling = contextlib.ExitStack()
    if args.profile:
        profiling.enter_context(trace(args.profile))
        print(f"[train] profiling epoch {start_epoch} -> {args.profile}")
    with profiling:
        for epoch in range(start_epoch, cfg.epochs):
            traced = bool(args.profile) and epoch == start_epoch

            def region():
                return (annotate("train_step") if traced
                        else contextlib.nullcontext())

            ds.set_epoch(epoch)
            t0 = time.perf_counter()
            epoch_sents = per_epoch * cfg.bs
            if scan:
                for _ in range(per_epoch // scan_k):
                    batch = torch.from_numpy(next(stacker)).to(device,
                                                                torch.long)
                    with region():
                        state, stacked = step(state, batch, batch, gen,
                                              n_std)
                    losses.extend(stacked.unbind(0))
                    step_i += scan_k
                    if (step_i // scan_k) % args.log_every == 0:
                        logger.log(epoch=epoch, step=step_i,
                                   loss=stacked[-1])
            else:
                for inp, _ in ds:
                    batch = torch.from_numpy(inp).to(device, torch.long)
                    extra = {}
                    with region():
                        if mode == "attack":
                            state, (clean, loss) = step(
                                state, batch, batch, gen, args.pnr_db, n_std,
                                args.epsilon)
                            clean_losses.append(clean)
                            extra = {"clean_loss": clean}
                        elif mode == "gan":
                            state, (loss, g_loss, d_loss) = step(
                                state, batch, batch, gen, n_std)
                            g_losses.append(g_loss)
                            d_losses.append(d_loss)
                            extra = {"g_loss": g_loss, "d_loss": d_loss}
                        elif mode == "mine":
                            state, mine_state, (loss, mi) = step(
                                state, mine_state, batch, batch, gen, n_std)
                            mis.append(mi)
                            extra = {"mi": mi}
                        else:
                            state, loss = step(state, batch, batch, gen,
                                               n_std)
                    losses.append(loss)
                    step_i += 1
                    if step_i % args.log_every == 0:
                        logger.log(epoch=epoch, step=step_i, loss=loss,
                                   **extra)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            profiling.close()  # trace exactly the first epoch
            epoch_seconds.append(dt)
            rates.append(epoch_sents / dt)
            logger.log(epoch=epoch, epoch_time=dt, sents_per_sec=rates[-1])
            if lead and ((epoch + 1) % args.ckpt_every == 0
                         or epoch + 1 == cfg.epochs):
                ckpt.save(epoch + 1, state, {"generator": gen.get_state()})
    if lead:
        ckpt.close()
    logger.close()
    steps_taken = len(losses)
    recipe = {"variant": args.variant, "train_mode": mode,
              "epochs": cfg.epochs, "start_epoch": start_epoch,
              "steps": steps_taken, "seed": args.seed,
              "scan_steps": scan_k if scan else 1,
              "tie_embeddings": cfg.tie_embeddings, "schedule": cfg.schedule,
              "lr": cfg.lr, "ema_decay": cfg.ema_decay, "dtype": cfg.dtype,
              "channel": cfg.channel, "remat": cfg.remat,
              "fuse_qkv": cfg.fuse_qkv, "aug_crop": cfg.aug_crop,
              "aug_concat": cfg.aug_concat, "aug_synth": cfg.aug_synth,
              "rng_impl": cfg.rng_impl, "ce_chunk": cfg.ce_chunk,
              "shuffle_size": cfg.shuffle_size,
              "input_data_dir": cfg.input_data_dir}
    if mode == "attack":
        recipe.update(adv_weight=args.adv_weight, pnr_db=args.pnr_db,
                      epsilon=args.epsilon)
    if mode == "gan":
        recipe.update(gan_lambda=cfg.gan_lambda, gan_pnr_db=cfg.gan_pnr_db,
                      g_loss_ceiling=cfg.g_loss_ceiling,
                      optimizer_updates=state.step)
    if mode == "mine":
        recipe.update(mine_lambda=cfg.mine_lambda)
    if mesh is not None:
        recipe.update(dp=mesh.dp)
    path_pkl = None
    if lead:
        path_pkl = save_params_pickle(
            os.path.join(cfg.checkpoint_path, f"{args.variant}_params.pkl"),
            eval_params(state), cfg, recipe)
        print(f"[train] done: {steps_taken} steps; params -> {path_pkl}")

    def host(xs):
        return torch.stack(xs).float().cpu() if xs else torch.zeros(0)

    return {"losses": host(losses), "clean_losses": host(clean_losses),
            "g_losses": host(g_losses), "d_losses": host(d_losses),
            "mis": host(mis), "steps": steps_taken,
            "start_epoch": start_epoch, "epoch_seconds": epoch_seconds,
            "sents_per_sec": rates, "path": path, "params_path": path_pkl,
            "device": str(device)}


def cmd_transmit(args) -> dict:
    """Send sentences through the transceiver at --snr and print what the
    receiver decodes (the JAX CLI's `transmit`): each sentence normalised,
    tokenized, encoded and padded (or cut) to seq_len, then the full-prefix
    greedy decode at one noise level (a star decoder in one shot), its
    channel drawn from a generator seeded with --seed, the leading <START>
    stripped. -> {"texts", "received", "inp", "ids", "device"}."""
    device = resolve_device(args.device)
    cfg = variant_config(args)
    check_envelope(cfg, args.variant, "transmit", device=device)
    texts = args.text if args.text else [line.strip() for line in sys.stdin
                                         if line.strip()]
    if not texts:
        raise SystemExit("transmit: no input sentences (pass --text or "
                         "pipe non-empty lines on stdin)")
    cfg, model, _ = restore_model(args, cfg, device, "transmit")
    vocab = load_vocab(cfg)
    rows = []
    for t in texts:
        toks = preprocess.tokenize(
            preprocess.normalize_string(t),
            punct_to_keep=preprocess.PUNCT_TO_KEEP,
            punct_to_remove=preprocess.PUNCT_TO_REMOVE)
        ids = vocab.encode(toks)[:cfg.seq_len]
        rows.append(ids + [cfg.pad_idx] * (cfg.seq_len - len(ids)))
    inp = torch.tensor(rows, dtype=torch.long, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    noise, fade = draw_channel(gen, (len(rows), cfg.seq_len,
                                     cfg.channel_dim),
                               cfg.channel, cfg.fading_per_sample)
    decode = make_greedy_decode(model, cfg,
                                "oneshot" if is_star(args.variant) else "step")
    out = decode(inp, args.pnr_db, SNR_to_noise(args.snr), noise,
                 fade).cpu()
    s2t = SeqToText(vocab, cfg.end_idx)
    received = []
    for t, row in zip(texts, out.tolist()):
        if row and row[0] == cfg.start_idx:
            row = row[1:]
        received.append(s2t.sequence_to_text(row))
        print(f"tx[{args.snr:g}dB]> {t}")
        print(f"rx[{args.snr:g}dB]> {received[-1]}")
    return {"texts": texts, "received": received, "inp": inp.cpu(),
            "ids": out, "device": str(device)}


class ServingSweep(torch.nn.Module):
    """The serving sweep as a module for `torch.export`: `forward(inp,
    noise, pnr_db, n_stds[, fade]) -> ids (S, B, max_length + 1)`, the
    channel's standard normals given as inputs; `model` is a submodule, so
    its weights go into the exported program."""

    def __init__(self, model, sweep):
        super().__init__()
        self.model = model
        self.sweep = sweep

    def forward(self, inp, noise, pnr_db, n_stds, fade=None):
        return self.sweep(inp, pnr_db, n_stds, noise, fade)


# Example sizes of the symbolic batch and sweep-length dims: at least 2
# (torch.export fixes a dim whose example size is 0 or 1), and apart, so
# the two are not taken for one.
EXPORT_EXAMPLE_B, EXPORT_EXAMPLE_S = 3, 2


def export_decoder(variant: str, decoder: str) -> str:
    """`--decoder` resolved: auto is kv for an autoregressive variant and
    full (the one-shot sweep) for a star one; SystemExit for kv or beam on
    a star variant, with the JAX CLI's message."""
    star = is_star(variant)
    if decoder == "auto":
        decoder = "full" if star else "kv"
    if decoder in ("kv", "beam") and star:
        raise SystemExit(f"--decoder {decoder} requires an autoregressive "
                         "decoder (vanilla transformer/gan); star decoders "
                         "are non-autoregressive — their one-shot sweep IS "
                         "the serving path (--decoder auto/full)")
    return decoder


def cmd_export(args) -> dict:
    """Serialise the serving sweep with `torch.export` (weights in the
    program) to --out, loadable by `torch.export.load` in a process that
    imports only torch. The model is built with the plain attention, top-K
    and star functions, so the artifact holds no kernel of the port (the
    JAX CLI traces its artifact through the XLA paths for the same reason).
    The draws are inputs: `(inp[b, L] int64, noise[s, b, L, C] f32, pnr_db
    f32, n_stds[s] f32[, fade]) -> ids[s, b, max_length+1] int32`, fade
    [s, 2] (or [s, b, 1, 2] per sample) for a fading channel. -> {"out",
    "mb", "seconds", "decoder", "signature", "program" (the
    ExportedProgram), "device"}."""
    device = resolve_device(args.device)
    cfg = variant_config(args)
    decoder = export_decoder(args.variant, args.decoder)
    cfg, model, _ = restore_model(args, cfg, device, "export",
                                  attention=plain_attention,
                                  satellite=plain_satellite)
    if decoder == "kv":
        sweep = make_greedy_decode_kv_sweep(model, cfg)
    elif decoder == "beam":
        sweep = make_beam_decode_sweep(model, cfg, args.beam_size,
                                       topk=topk_logits_reference)
    else:
        sweep = make_greedy_decode_sweep(
            model, cfg, "oneshot" if is_star(args.variant) else "step")
    fading = cfg.channel != "AWGN"
    if args.static_shapes:
        b, s = cfg.bs, args.snr_points
        b_str, s_str = str(b), str(s)
    else:
        b, s = EXPORT_EXAMPLE_B, EXPORT_EXAMPLE_S
        b_str, s_str = "b", "s"
    L, C = cfg.seq_len, cfg.channel_dim
    f32 = {"dtype": torch.float32, "device": device}
    example = [torch.zeros((b, L), dtype=torch.long, device=device),
               torch.zeros((s, b, L, C), **f32), torch.zeros((), **f32),
               torch.ones((s,), **f32)]
    fade_shape = (s, b, 1, 2) if cfg.fading_per_sample else (s, 2)
    if fading:
        example.append(torch.zeros(fade_shape, **f32))
    dynamic = None
    if not args.static_shapes:
        bd, sd = torch.export.Dim("b"), torch.export.Dim("s")
        dynamic = {"inp": {0: bd}, "noise": {0: sd, 1: bd}, "pnr_db": None,
                   "n_stds": {0: sd}}
        if fading:
            dynamic["fade"] = ({0: sd, 1: bd} if cfg.fading_per_sample
                               else {0: sd})
    t0 = time.perf_counter()
    program = torch.export.export(ServingSweep(model, sweep), tuple(example),
                                  dynamic_shapes=dynamic)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.export.save(program, args.out)
    seconds = time.perf_counter() - t0
    mb = os.path.getsize(args.out) / 1e6
    n_params = sum(p.numel() for p in model.parameters())
    fade_sig = ""
    if fading:
        fade_sig = (f", fade[{s_str},{b_str},1,2] f32"
                    if cfg.fading_per_sample else f", fade[{s_str},2] f32")
    signature = (f"(inp[{b_str},{L}] i64, noise[{s_str},{b_str},{L},{C}] "
                 f"f32, pnr_db f32, n_stds[{s_str}] f32{fade_sig}) -> "
                 f"ids[{s_str},{b_str},{cfg.max_length + 1}] i32")
    print(f"[export] {args.out}: {mb:.1f} MB, {n_params:,} params baked in, "
          f"decoder {decoder}, signature {signature}; the channel's "
          f"standard normals are inputs (the JAX artifact takes a seed: its "
          f"RNG is not the port's); plain attention/top-K/star inside; "
          f"{seconds:.1f} s")
    return {"out": args.out, "mb": mb, "seconds": seconds,
            "decoder": decoder, "signature": signature, "program": program,
            "device": str(device)}


def cmd_preprocess(args) -> dict:
    """The corpus pipeline of `data/preprocess.py` (host only; --device is
    resolved as every entry point's, and nothing runs on it)."""
    resolve_device(args.device)
    return preprocess.run(args)


def cmd_baseline(args) -> dict:
    """The classical Huffman + turbo + QAM BLEU-vs-SNR sweep on the raw
    sentences of the pickle --data, its BCJR decoder on the device; the
    rows [snr, bleu_attacked, bleu_clean] pickled to --out. -> {"rows",
    "seconds" (per SNR), "device"}."""
    device = resolve_device(args.device)
    with open(args.data, "rb") as f:
        sentences = pickle.load(f)
    seconds = []
    rows = classical_sweep(
        sentences, [float(x) for x in args.snrs.split(",")],
        block_k=args.block_k, iters=args.iters, mod_bits=args.mod_bits,
        pnr_db=args.baseline_pnr_db, seed=args.baseline_seed, device=device,
        seconds=seconds)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(rows, f)
    print(f"wrote {args.out}")
    return {"rows": rows, "seconds": seconds, "device": str(device)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="deepsc_gan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("evaluate")
    add_config_args(p)
    p.add_argument("--variant", default="transformer", choices=VARIANTS)
    p.add_argument("--eval-mode", default="greedy", choices=EVAL_MODES)
    p.add_argument("--kv-cache", action="store_true",
                   help="greedy: the KV-cached decoder (same ids at f32; a "
                        "star decoder is decoded in one shot either way)")
    p.add_argument("--beam-size", type=int, default=4)
    p.add_argument("--beam-impl", default="kv", choices=["kv", "full"],
                   help="beam: KV-cached (serving) or full-prefix (oracle)")
    p.add_argument("--params-pkl", default=None,
                   help="flax params pickle (results/*_params.pkl format); "
                        "default <checkpoint-path>/<variant>_params.pkl "
                        "when it exists")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pnr-db", type=float, default=0.0)
    p.add_argument("--epsilon", type=float, default=1.0,
                   help="FGM strength (cancelled by the normalization, "
                        "quirk Q7: --pnr-db sets the attack's power)")
    p.add_argument("--metric", default="bleu", choices=METRICS,
                   help="the table's text metric column(s), BLEU then the "
                        "similarity: BERT's from local weights "
                        "(DEEPSC_BERT_PATH, a Hugging Face directory, "
                        "default bert-base-uncased in the local cache; "
                        "never fetched), else the unigram cosine with a "
                        "warning")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--snr-lo", type=int, default=0)
    p.add_argument("--snr-hi", type=int, default=18)
    p.add_argument("--snr-parallel", type=int, default=1,
                   help="greedy (full-prefix or --kv-cache) and beam (KV) "
                        "modes: split the sweep's SNR points over this many "
                        "ranks (it must divide their count; one process a "
                        "rank, --distributed)")
    _distributed_arg(p)

    t = sub.add_parser("train")
    add_config_args(t)
    t.add_argument("--variant", default="transformer", choices=VARIANTS)
    t.add_argument("--train-mode", default="plain",
                   choices=["plain", "attack", "gan", "mine"],
                   help="gan: the three-phase GAN step (--variant gan or "
                        "gan_star; --gan-lambda, --gan-pnr-db, "
                        "--g-loss-ceiling); mine: MINE joint training "
                        "(--variant transformer only; --mine-lambda)")
    t.add_argument("--adv-weight", type=float, default=1.0,
                   help="attack: the update's weight on the adversarial "
                        "loss (the rest on the clean one); 1 is the "
                        "reference's adversarial-only update")
    t.add_argument("--pnr-db", type=float, default=0.0,
                   help="attack: perturbation-to-noise ratio in dB")
    t.add_argument("--epsilon", type=float, default=1.0,
                   help="attack: FGM strength (cancelled, quirk Q7)")
    t.add_argument("--params-pkl", default=None,
                   help="start from these weights (results/*_params.pkl "
                        "format)")
    t.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--scan-steps", type=int, default=32,
                   help="plain mode: K steps a call, on CUDA K replays of "
                        "one captured CUDA graph of the step (the JAX CLI's "
                        "lax.scan path); 1 = one eager step a call. Under "
                        "--dp (a process group) every step is an eager "
                        "call and no CUDA graph is captured, as the JAX "
                        "CLI's dp path runs no scan")
    _distributed_arg(t)
    t.add_argument("--ckpt-every", type=int, default=10,
                   help="save an epoch checkpoint every N epochs under "
                        "<checkpoint-path>/<variant>/<epoch>/ (the last "
                        "epoch always saves; the newest 5 kept)")
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint (params, "
                        "Adam moments and counts, update count, EMA, the "
                        "generator's state; bit-identical to the run not "
                        "stopped, with --scan-steps K when K divides an "
                        "epoch's batches, and it says at the start when K "
                        "does not); mine mode: MINE restarts fresh")
    t.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the first epoch with torch.profiler into "
                        "DIR/trace.json (a Chrome trace)")

    tx = sub.add_parser(
        "transmit", help="send text through the transceiver at --snr and "
                         "print what the receiver decodes")
    add_config_args(tx)
    _model_args(tx)
    tx.add_argument("--snr", type=float, default=6.0)
    tx.add_argument("--pnr-db", type=float, default=0.0)
    tx.add_argument("--text", action="append",
                    help="sentence to transmit (repeatable; default: the "
                         "non-empty lines of stdin)")

    ex = sub.add_parser(
        "export",
        help="serialise the serving sweep, weights included, with "
             "torch.export (a .pt2 that torch.export.load reads in a "
             "process importing only torch). Signature: (inp[b, L] int64, "
             "noise[s, b, L, C] f32, pnr_db f32, n_stds[s] f32[, fade]) -> "
             "ids[s, b, max_length+1] int32: the channel's standard "
             "normals are inputs (torch.export cannot seed a generator "
             "inside the program; the JAX artifact takes a seed instead, "
             "and its RNG is not the port's). The artifact runs the plain "
             "attention, top-K and star functions, not the CUDA kernels")
    add_config_args(ex)
    _model_args(ex)
    ex.add_argument("--decoder", default="auto",
                    choices=["auto", "kv", "beam", "full"],
                    help="auto = KV-cached greedy for autoregressive "
                         "variants, the one-shot sweep for star; kv; beam "
                         "(KV-cached beam search); full (full-prefix "
                         "greedy)")
    ex.add_argument("--beam-size", type=int, default=4,
                    help="--decoder beam: beam width")
    ex.add_argument("--snr-points", type=int, default=19,
                    help="sweep length s with --static-shapes (otherwise "
                         "b and s are symbolic, any size from 1)")
    ex.add_argument("--static-shapes", action="store_true",
                    help="pin b (= --bs) and s (= --snr-points)")
    ex.add_argument("--out", default="model_decode.pt2")

    pp = sub.add_parser("preprocess", help="Europarl preprocessing (host)")
    preprocess.add_args(pp)
    _device_arg(pp)

    bl = sub.add_parser(
        "baseline", help="classical Huffman + turbo + QAM BLEU-vs-SNR sweep "
                         "(the BCJR decoder on the device)")
    bl.add_argument("--data", required=True,
                    help="pickle of raw sentences (a list of str)")
    bl.add_argument("--out", default="log/classical-log.pkl")
    bl.add_argument("--block-k", type=int, default=512)
    bl.add_argument("--iters", type=int, default=6)
    bl.add_argument("--mod-bits", type=int, default=6, help="6 = 64-QAM")
    bl.add_argument("--baseline-pnr-db", type=float, default=10.0)
    bl.add_argument("--snrs", default=",".join(str(x) for x in range(19)))
    bl.add_argument("--baseline-seed", type=int, default=0)
    _device_arg(bl)
    return parser


def _distributed_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="join the process group a launcher (torchrun) "
                        "describes in the environment (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL where "
                        "every rank has a card of its own, else gloo; "
                        "each rank on cuda:LOCAL_RANK % device_count")


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")


def _model_args(p: argparse.ArgumentParser) -> None:
    """The flags that say which transceiver `transmit` and `export` run
    and where its weights come from (as `evaluate`)."""
    p.add_argument("--variant", default="transformer", choices=VARIANTS)
    p.add_argument("--params-pkl", default=None,
                   help="flax params pickle (results/*_params.pkl format); "
                        "default <checkpoint-path>/<variant>_params.pkl "
                        "when it exists, else the latest epoch checkpoint, "
                        "else a random init from --seed")
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)


COMMANDS = {"evaluate": cmd_evaluate, "train": cmd_train,
            "transmit": cmd_transmit, "export": cmd_export,
            "preprocess": cmd_preprocess, "baseline": cmd_baseline}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
