"""Whether the kernels a command will launch take its shapes, checked when
the command starts, before any model is built.

The kernels refuse shapes outside their envelope (each wrapper raises on
CUDA; nothing falls back to a plain version), while the JAX package's
Pallas kernels refuse none. So `cli train` and `cli evaluate` ask
`check_envelope` first and stop with a message that names the flag, rather
than mid-run after the weights are loaded. The envelopes are the ones the
kernel modules export (`attention_kernel.HEAD_DIMS`, `MAX_HEADS`;
`ce_kernel.MAX_D`, `D_STEP`; `topk_kernel.MAX_K`, `D_STEP`;
`star_kernel.takes_width`), and the f32 K2's shared memory is the one its
built library computes (`attention_kernel.smem_bytes`). K1 and K2 take any
number of queries and keys (past 32, their long-length kernels), so no
length is refused. On the CPU the plain versions take any shape and
nothing is refused.

Which kernels run, by variant and mode:
- vanilla (`transformer`, `gan`): K1 in every attention of the encoder
  (seq_len keys) and of a full-prefix decoder (teacher-forced: seq_len - 1
  queries; decoding: max_length + 1; the KV decoders' steps are plain
  PyTorch); K2 wherever a backward runs (training, plain, attack or GAN:
  every attention; the attack evaluations, `greedy_gan` and the GAN
  teacher-forced step: the decoder's); K3 and K4 in training with
  cfg.fused_ce; K6 in beam search;
- star (`star`, `star_multi`, `gan_star`): K5 in every satellite update of
  the encoder and the decoder; K3 and K4 in training.
This list is kept by hand beside the paths: were it to miss a kernel, the
run would still stop at that kernel's wrapper (which raises on a shape it
does not take), only later.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from deepsc_gan_tpu_torch.utils.config import Config, is_star, torch_dtype

# the eval modes whose attack gradient runs a backward through the decoder
ATTACK_MODES = ("greedy_attack", "greedy_gan", "teacher_forced", "pgd")


def _attention_errors(side: str, d_model: int, heads: int, calls,
                      backward: bool, dtype, smem_limit) -> List[str]:
    """K1 (and K2 when `backward`) over `calls` [(lq, lk, length flag)] at
    `heads` heads of d_model / heads."""
    flags = f"--{side}-d-model {d_model} / --{side}-num-heads {heads}"
    dh = d_model // heads if heads > 0 and d_model % heads == 0 else 0
    errors = []
    if dh not in attn.HEAD_DIMS:
        errors.append(f"{flags}: the attention kernels K1/K2 take head "
                      f"widths {attn.HEAD_DIMS}")
    if heads > attn.MAX_HEADS:
        errors.append(f"--{side}-num-heads {heads}: K1/K2 take at most "
                      f"{attn.MAX_HEADS} heads")
    for lq, lk, flag in calls:
        if backward and dtype == torch.float32 and not errors:
            need = attn.smem_bytes(attn.KERNEL_BWD, torch.float32, lq,
                                   lk, heads, dh)
            limit = smem_limit()
            if need > limit:
                errors.append(
                    f"--dtype float32 with {flags} and {flag}: the f32 K2 "
                    f"needs {need} bytes of shared memory a block for "
                    f"{lq} x {lk} at {heads} heads of {dh}; the card allows "
                    f"{limit} (use --dtype bfloat16, fewer heads or a "
                    f"shorter --seq-len)")
    return errors


def envelope_errors(cfg: Config, variant: str, eval_mode: Optional[str],
                    beam_size: int = 4, kv_cache: bool = False,
                    beam_impl: str = "kv", device="cuda",
                    smem_limit: Optional[int] = None) -> List[str]:
    """-> one message per flag whose value a kernel of this run does not
    take (empty: every kernel takes the run's shapes). `eval_mode` None is
    `cli train`; else the `cli evaluate` mode, with `kv_cache` (greedy) and
    `beam_impl` (beam) saying which decoder runs. `smem_limit` is the
    card's shared memory per block (default: the device's)."""
    device = torch.device(device)
    if device.type != "cuda":
        return []
    dtype = torch_dtype(cfg.dtype)

    def limit():
        if smem_limit is not None:
            return smem_limit
        return torch.cuda.get_device_properties(device) \
            .shared_memory_per_block_optin

    train = eval_mode is None
    errors = []
    if is_star(variant):
        for side, d, heads in (("encoder", cfg.encoder_d_model,
                                cfg.encoder_num_heads),
                               ("decoder", cfg.decoder_d_model,
                                cfg.decoder_num_heads)):
            if not star.takes_width(d, heads):
                errors.append(
                    f"--{side}-d-model {d} / --{side}-num-heads {heads}: the "
                    f"star satellite kernel K5 takes D in {star.WIDTHS} and "
                    f"a head width that is a power of two of at least "
                    f"D / 32")
    else:
        seq = f"--seq-len {cfg.seq_len}"
        errors += _attention_errors(
            "encoder", cfg.encoder_d_model, cfg.encoder_num_heads,
            [(cfg.seq_len, cfg.seq_len, seq)], train, dtype, limit)
        calls = []
        if train or eval_mode in ATTACK_MODES:
            t = cfg.seq_len - 1
            calls += [(t, t, seq), (t, cfg.seq_len, seq)]
        full_prefix = (eval_mode == "greedy" and not kv_cache) or (
            eval_mode == "beam" and beam_impl == "full") \
            or eval_mode in ("greedy_attack", "greedy_gan")
        if full_prefix:
            t = cfg.max_length + 1
            flag = f"--max-length {cfg.max_length}"
            calls += [(t, t, flag), (t, cfg.seq_len, f"{flag} / {seq}")]
        if calls:
            errors += _attention_errors(
                "decoder", cfg.decoder_d_model, cfg.decoder_num_heads, calls,
                train or eval_mode in ATTACK_MODES, dtype, limit)
    d = cfg.decoder_d_model
    if train and cfg.fused_ce and (d % ce.D_STEP[dtype] or d > ce.MAX_D):
        errors.append(f"--decoder-d-model {d} with --dtype {cfg.dtype}: the "
                      f"CE kernels K3/K4 take a multiple of "
                      f"{ce.D_STEP[dtype]} up to {ce.MAX_D}")
    if eval_mode == "beam":
        if d % topk.D_STEP or d > ce.MAX_D:
            errors.append(f"--decoder-d-model {d}: the beam scorer K6 takes "
                          f"a multiple of {topk.D_STEP} up to {ce.MAX_D}")
        if not 1 <= beam_size <= min(topk.MAX_K, cfg.vocab_size):
            errors.append(f"--beam-size {beam_size}: the beam scorer K6 "
                          f"takes 1 to {topk.MAX_K}")
    return errors


def check_envelope(cfg: Config, variant: str, eval_mode: Optional[str],
                   beam_size: int = 4, kv_cache: bool = False,
                   beam_impl: str = "kv", device="cuda",
                   smem_limit: Optional[int] = None) -> None:
    """`envelope_errors`, raising SystemExit with every message when there
    is one."""
    errors = envelope_errors(cfg, variant, eval_mode, beam_size, kv_cache,
                             beam_impl, device, smem_limit)
    if errors:
        raise SystemExit("the CUDA kernels do not take this configuration:\n"
                         + "\n".join(f"  {e}" for e in errors))
