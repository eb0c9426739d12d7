"""Whether the kernels a command will launch take its shapes, checked when
the command starts, before any model is built.

The kernels refuse shapes outside their envelope (each wrapper raises on
CUDA; nothing falls back to a plain version), while the JAX package's
Pallas kernels refuse none. So `cli train`, `cli evaluate` and
`cli transmit` ask `check_envelope` first and stop with a message that
names the flag, rather than mid-run after the weights are loaded. Each kernel has a tuned path
and a wide one that takes what the tuned one does not, so what is left to
refuse is narrow: a K1/K2 or K5 head count that does not divide the width
(the models refuse it too when built), K6 a beam outside 1..V; K1/K2 take
any head width, K3/K4 any width, and no length is refused. On the CPU the
plain versions take any shape and nothing is refused.

Which kernels run, by variant and mode:
- vanilla (`transformer`, `gan`): K1 in every attention of the encoder
  (seq_len keys) and of a full-prefix decoder (teacher-forced: seq_len - 1
  queries; decoding: max_length + 1; the KV decoders' steps are plain
  PyTorch); K2 wherever a backward runs (training, plain, attack or GAN:
  every attention; the attack evaluations, `greedy_gan` and the GAN
  teacher-forced step: the decoder's); K3 and K4 in training with
  cfg.fused_ce; K6 in beam search; `transmit` (`cli transmit`, the
  full-prefix greedy decode at one noise level): K1 as the full-prefix
  greedy sweep; MINE training (`mine`, vanilla only):
  K1 and K2 at the training shapes (the encoder's K1 twice a step, its
  recompute for T's update), no K3 or K4 (the CE takes materialized
  logits);
- star (`star`, `star_multi`, `gan_star`): K5 in every satellite update of
  the encoder and the decoder; K3 and K4 in training.

Which design takes each call is `kernel_designs`: the source of each
kernel this run launches, read from the route predicates its wrapper
takes (`attention_kernel.uses_narrow`, `uses_tiled`, `is_wide_mma`,
`is_chunked_mma`, `uses_resident`, `uses_cluster`; `ce_kernel.
uses_tiled_fwd`, `uses_tiled_bwd`, `uses_tensor_core_fwd`,
`uses_tensor_core_bwd`; `topk_kernel.uses_select`, `uses_long_list`,
`uses_tensor_core`; `star_kernel.takes_width`, `wide_plan`), so it cannot
drift from the wrappers. Every design takes any length (the K1/K2 ones
past a block's shared memory through a scratch), K3/K4 any width and K6
any k up to V, so none refuses a shape the check lets through; were one to,
the run would still stop at that kernel's wrapper (which raises on a shape
it does not take), only later.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from deepsc_gan_tpu_torch.utils.config import Config, is_star, torch_dtype

# the eval modes whose attack gradient runs a backward through the decoder
ATTACK_MODES = ("greedy_attack", "greedy_gan", "teacher_forced", "pgd")


def _attention_errors(side: str, d_model: int, heads: int) -> List[str]:
    """K1 and K2 at `heads` heads of d_model / heads (any length)."""
    dh = d_model // heads if heads > 0 and d_model % heads == 0 else 0
    if not attn.takes_head_dim(dh):
        return [f"--{side}-d-model {d_model} / --{side}-num-heads {heads}: "
                f"the attention kernels K1/K2 take a number of heads that "
                f"divides the width"]
    return []


def envelope_errors(cfg: Config, variant: str, eval_mode: Optional[str],
                    beam_size: int = 4, kv_cache: bool = False,
                    beam_impl: str = "kv", device="cuda") -> List[str]:
    """-> one message per flag whose value a kernel of this run does not
    take (empty: every kernel takes the run's shapes). `eval_mode` None is
    `cli train`, "mine" `cli train --train-mode mine` (the same attention
    shapes, forward and backward), "transmit" `cli transmit`; else the
    `cli evaluate` mode, with
    `kv_cache` (greedy) and `beam_impl` (beam) saying which decoder runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return []
    train = eval_mode in (None, "mine")
    errors = []
    if is_star(variant):
        for side, d, heads in (("encoder", cfg.encoder_d_model,
                                cfg.encoder_num_heads),
                               ("decoder", cfg.decoder_d_model,
                                cfg.decoder_num_heads)):
            if not star.takes_heads(d, heads):
                errors.append(
                    f"--{side}-d-model {d} / --{side}-num-heads {heads}: the "
                    f"star satellite kernel K5 takes a number of heads that "
                    f"divides D")
    else:
        errors += _attention_errors("encoder", cfg.encoder_d_model,
                                    cfg.encoder_num_heads)
        # the decoder's attentions run K1 (and K2) in training, the attack
        # modes and the full-prefix decoders
        full_prefix = (eval_mode == "greedy" and not kv_cache) or (
            eval_mode == "beam" and beam_impl == "full") \
            or eval_mode in ("greedy_attack", "greedy_gan", "transmit")
        if train or eval_mode in ATTACK_MODES or full_prefix:
            errors += _attention_errors("decoder", cfg.decoder_d_model,
                                        cfg.decoder_num_heads)
    if eval_mode == "beam" and not 1 <= beam_size <= cfg.vocab_size:
        errors.append(f"--beam-size {beam_size}: the beam scorer K6 takes "
                      f"1 to the vocab size {cfg.vocab_size}")
    return errors


def _csrc(name: str) -> str:
    return f"csrc/{name}.cu"


def attention_designs(dtype, heads: int, dh: int, lq: int, lk: int
                      ) -> Dict[str, str]:
    """{"K1": source, "K2": source} of the attention kernels' calls at
    `heads` heads of `dh`, Lq x Lk, in `dtype`, by the wrappers' routes."""
    if attn.uses_narrow(dtype, heads, dh):
        return {"K1": _csrc(attn.KERNEL_NARROW),
                "K2": _csrc(attn.KERNEL_NARROW)}
    if attn.uses_tiled(dtype, heads, dh):
        return {"K1": _csrc(attn.KERNEL_TILED),
                "K2": _csrc(attn.KERNEL_BWD_TILED)}
    for takes, name in ((attn.is_wide_mma, attn.KERNEL_WIDE_MMA),
                        (attn.is_chunked_mma, attn.KERNEL_CHUNKED)):
        if takes(dtype, heads, dh):
            return {"K1": _csrc(name), "K2": _csrc(name)}
    if attn.uses_resident(dtype, lq, lk, heads, dh):
        bwd = attn.KERNEL_RESIDENT
    elif attn.uses_cluster(dtype, lq, lk, heads, dh):
        bwd = attn.KERNEL_CLUSTER
    else:
        bwd = attn.KERNEL_BWD
    return {"K1": _csrc(attn.KERNEL), "K2": _csrc(bwd)}


def ce_designs(dtype, d: int) -> Dict[str, str]:
    """{"K3": source, "K4": source} at width d in `dtype`."""
    if ce.uses_tiled_fwd(dtype, d):
        fwd = ce.KERNEL_FWD_TILED
    elif ce.uses_tensor_core_fwd(dtype, d):
        fwd = ce.KERNEL_WIDE_FWD
    else:
        fwd = ce.KERNEL_FWD
    if ce.uses_tiled_bwd(dtype, d):
        bwd = ce.KERNEL_BWD_TILED
    elif ce.uses_tensor_core_bwd(dtype, d):
        bwd = ce.KERNEL_WIDE_BWD
    else:
        bwd = ce.KERNEL_BWD
    return {"K3": _csrc(fwd), "K4": _csrc(bwd)}


def topk_design(dtype, d: int, k: int, v: int) -> str:
    """K6's source at width d, k and V = v in `dtype`."""
    if topk.uses_select(dtype, d, k, v):
        return _csrc(topk.KERNEL_SELECT)
    if topk.uses_long_list(dtype, d, k, v):
        return _csrc(topk.KERNEL_WIDE_MMA) + " (long path)"
    if topk.uses_tensor_core(dtype, d, k, v):
        return _csrc(topk.KERNEL_WIDE_MMA)
    return _csrc(topk.KERNEL)


def star_design(dtype, d: int, heads: int) -> str:
    """K5's source at width d in `heads` heads."""
    if star.takes_width(d, heads):
        return _csrc(star.KERNEL)
    size = torch.empty((), dtype=dtype).element_size()
    return (f"{_csrc(star.KERNEL_WIDE)} "
            f"({star.wide_plan(d, heads, size).path} path)")


def kernel_designs(cfg: Config, variant: str, eval_mode: Optional[str],
                   beam_size: int = 4, kv_cache: bool = False,
                   beam_impl: str = "kv") -> Dict[str, str]:
    """The kernels a run launches on CUDA and the source of the design
    that takes each ("K1 encoder", "K2 decoder self", "K3", "K6", "K5
    decoder", ...), by the same arguments as `envelope_errors`, read from
    the wrappers' route predicates at the run's shapes (training: the
    shifted target's seq_len - 1 decoder positions; decoding:
    max_length + 1). A run whose shapes the envelope refuses has no
    entry for the refused kernel."""
    dt = torch_dtype(cfg.dtype)
    train = eval_mode in (None, "mine")
    out = {}
    if is_star(variant):
        for side, d, heads in (("encoder", cfg.encoder_d_model,
                                cfg.encoder_num_heads),
                               ("decoder", cfg.decoder_d_model,
                                cfg.decoder_num_heads)):
            if star.takes_heads(d, heads):
                out[f"K5 {side}"] = star_design(dt, d, heads)
    else:
        backward = train or eval_mode in ATTACK_MODES
        decode = cfg.max_length + 1
        dec_len = cfg.seq_len - 1 if backward else decode
        full_prefix = (eval_mode == "greedy" and not kv_cache) or (
            eval_mode == "beam" and beam_impl == "full") \
            or eval_mode in ("greedy_attack", "greedy_gan", "transmit")
        sides = [("encoder", cfg.encoder_d_model, cfg.encoder_num_heads,
                  ((cfg.seq_len, cfg.seq_len),))]
        if backward or full_prefix:
            sides.append(("decoder", cfg.decoder_d_model,
                          cfg.decoder_num_heads,
                          ((dec_len, dec_len), (dec_len, cfg.seq_len))))
        for side, d, heads, lengths in sides:
            if _attention_errors(side, d, heads):
                continue
            for (lq, lk), part in zip(lengths, ("self", "cross")):
                label = side if side == "encoder" else f"{side} {part}"
                got = attention_designs(dt, heads, d // heads, lq, lk)
                out[f"K1 {label}"] = got["K1"]
                # the encoder's backward runs in training alone
                if train or side == "decoder" and backward:
                    out[f"K2 {label}"] = got["K2"]
    if train and cfg.fused_ce and eval_mode != "mine":
        out.update(ce_designs(dt, cfg.decoder_d_model))
    if eval_mode == "beam" and 1 <= beam_size <= cfg.vocab_size \
            and not is_star(variant):
        out["K6"] = topk_design(dt, cfg.decoder_d_model, beam_size,
                                cfg.vocab_size)
    return out


def check_envelope(cfg: Config, variant: str, eval_mode: Optional[str],
                   beam_size: int = 4, kv_cache: bool = False,
                   beam_impl: str = "kv", device="cuda") -> None:
    """`envelope_errors`, raising SystemExit with every message when there
    is one."""
    errors = envelope_errors(cfg, variant, eval_mode, beam_size, kv_cache,
                             beam_impl, device)
    if errors:
        raise SystemExit("the CUDA kernels do not take this configuration:\n"
                         + "\n".join(f"  {e}" for e in errors))
