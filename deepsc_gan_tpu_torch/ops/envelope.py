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

Which design takes each call, and why none of them refuses a shape the
check lets through:
- K1: at the tuned heads (8, 16 or 32 wide, at most 16) in bf16 the tuned
  kernel (any length: the long-length kernel past 32), in f32 the narrow
  kernel (csrc/attention_narrow.cu: a block a row, head and 32 queries, key
  tiles streamed, any length); other heads in bf16 the tensor-core wide (up
  to 256 wide) or chunked kernels, in f32 the tiled kernel
  (csrc/attention_tiled.cu; any length, its logits in a scratch where a
  row of keys outgrows a block's shared memory);
- K2: at the tuned heads in bf16 the tuned kernel, past 32 queries or keys
  the resident, cluster and long-length kernels, in f32 the narrow kernels
  (a block a row and head, up to 128 queries and keys holding the head
  whole, past them a dq and a dk/dv kernel through a statistics scratch;
  shared memory a block that no length raises past 124 KB); the wide
  kernels at other heads: in bf16 the
  tensor-core wide or chunked kernels, in f32 the tiled kernels
  (csrc/attention_bwd_tiled.cu; any length, S and dP formed in its
  scratch where a row of keys outgrows a block's shared memory);
- K3/K4: at any width. Every f32 call on the tiled kernels, one 128 x 128
  CUDA-core tile (K3 csrc/ce_fwd_tiled.cu, K4 csrc/ce_bwd_tiled.cu: P once
  into an (N, V) workspace, then dh and dW); bf16 on the tensor cores, the
  tuned kernels at D a multiple of 16 up to 256, else the wide ones (K4 up
  to 5,120 columns, the tiled kernels past them);
- K6: `--beam-size` k in 1..V at any width: the tuned kernel up to k = 8,
  in bf16 the tensor-core wide kernel up to 64 and its long path up to
  256 (V up to 25,000), every other call (every f32 one, bf16 past them)
  the select kernels (csrc/topk_select.cu: any k up to V, a row's keys in
  a scratch where they outgrow a block's shared memory);
- K5: the tuned kernel, else the wide one, at any head count dividing D.
This list is kept by hand beside the paths: were it to miss a kernel, the
run would still stop at that kernel's wrapper (which raises on a shape it
does not take), only later.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.utils.config import Config, is_star

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
