"""The check at command start (`ops/envelope.py`): on CUDA, a flag whose
value a kernel of the run does not take is refused with a message naming
the flag, before any model is built; on the CPU, where the plain versions
take any shape, nothing is refused; the default configuration passes for
every variant and mode.

The f32 K2's shared-memory size comes from its built library, which the
CPU cannot build: here a stand-in gives it, growing with the heads as the
kernel's layout does (two score tiles a head) and crossing the card's
limit between 8 and 16 heads. The card test
`test_envelope_reads_the_f32_backward_size_from_the_library` holds the
check to the library's own sizes."""

import pytest
import torch

from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops.envelope import (
    check_envelope,
    envelope_errors,
)
from deepsc_gan_tpu_torch.utils.config import (
    Config,
    default_seq_len,
    is_star,
)

# Hopper's shared memory per block (227 KiB), what an H100 reports as
# shared_memory_per_block_optin
SMEM = 232448
MODES = [None, "greedy", "beam", "greedy_attack", "greedy_gan",
         "teacher_forced", "pgd"]
# the stand-in's bytes a head: 8 heads fit SMEM, 16 do not
BYTES_PER_HEAD = SMEM // 12


@pytest.fixture(autouse=True)
def library_sizes(monkeypatch):
    """-> the (kernel, dtype, lq, lk, heads, dh) the check asked the
    stand-in for."""
    asked = []

    def smem_bytes(kernel, dtype, lq, lk, heads, dh):
        asked.append((kernel, dtype, lq, lk, heads, dh))
        return BYTES_PER_HEAD * heads

    monkeypatch.setattr(attn, "smem_bytes", smem_bytes)
    return asked

# name -> (variant, eval mode (None: train), Config fields, extra keywords
# of the check, the flag the message must name)
REFUSED = {
    "beam_size_9": ("transformer", "beam", {}, dict(beam_size=9),
                    "--beam-size 9"),
    "gan_star_d_model_96": ("gan_star", None,
                            dict(encoder_d_model=96, decoder_d_model=96), {},
                            "--encoder-d-model 96"),
    "head_width_64": ("transformer", None,
                      dict(encoder_d_model=512, encoder_num_heads=8), {},
                      "--encoder-d-model 512 / --encoder-num-heads 8"),
    "heads_32": ("transformer", "greedy",
                 dict(decoder_d_model=256, decoder_num_heads=32), {},
                 "--decoder-num-heads 32"),
    "beam_size_12": ("transformer", "beam", {}, dict(beam_size=12),
                     "--beam-size 12"),
    "star_d_model_96": ("star", "teacher_forced",
                        dict(encoder_d_model=96, decoder_d_model=96), {},
                        "--encoder-d-model 96"),
    "ce_width_512": ("transformer", None,
                     dict(decoder_d_model=512, decoder_num_heads=16), {},
                     "--decoder-d-model 512"),
    "f32_k2_16x16": ("transformer", None,
                     dict(dtype="float32", seq_len=32, encoder_d_model=256,
                          encoder_num_heads=16, decoder_d_model=256,
                          decoder_num_heads=16), {}, "--dtype float32"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_on_cuda_with_the_flag_named(case):
    variant, mode, fields, extra, flag = REFUSED[case]
    cfg = Config(seq_len=default_seq_len(variant)).replace(**fields)
    with pytest.raises(SystemExit) as exc:
        check_envelope(cfg, variant, mode, device="cuda", smem_limit=SMEM,
                       **extra)
    assert flag in str(exc.value.code)


@pytest.mark.parametrize("case", list(REFUSED))
def test_accepted_on_cpu(case):
    variant, mode, fields, extra, _ = REFUSED[case]
    cfg = Config(seq_len=default_seq_len(variant)).replace(**fields)
    assert envelope_errors(cfg, variant, mode, device="cpu", **extra) == []
    check_envelope(cfg, variant, mode, device=torch.device("cpu"), **extra)


# K1 and K2 take any length: what the check once refused (past 32
# queries or keys) runs, in every mode that launches them
ACCEPTED = {
    "seq_len_40": ("transformer", "teacher_forced", dict(seq_len=40)),
    "max_length_40": ("transformer", "greedy", dict(max_length=40)),
    "gan_seq_len_64": ("gan", None, dict(seq_len=64)),
    "greedy_gan_seq_len_128": ("gan", "greedy_gan",
                               dict(seq_len=128, max_length=127)),
}


@pytest.mark.parametrize("case", list(ACCEPTED))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_long_lengths_accepted_on_cuda(case, dtype, library_sizes):
    """No length refused; at f32 where a backward runs, the check asks the
    library for the f32 K2's shared memory at the long shape."""
    variant, mode, fields = ACCEPTED[case]
    cfg = Config(dtype=dtype).replace(**fields)
    assert envelope_errors(cfg, variant, mode, smem_limit=SMEM) == []
    asked = [a[2:4] for a in library_sizes]
    assert (dtype == "float32" and mode != "greedy") == bool(asked)
    assert all(max(a) > 32 for a in asked)


@pytest.mark.parametrize("variant", ["transformer", "star", "star_multi",
                                     "gan", "gan_star"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_default_configuration_passes(variant, dtype):
    cfg = Config(seq_len=default_seq_len(variant), dtype=dtype)
    for mode in MODES:
        if mode == "beam" and is_star(variant):
            continue
        for kv in (False, True):
            assert envelope_errors(cfg, variant, mode, kv_cache=kv,
                                   beam_impl="full" if kv else "kv",
                                   smem_limit=SMEM) == [], (variant, mode)


def test_f32_backward_shape_boundary(library_sizes):
    """The f32 K2 at 16 heads of 16: refused only where a backward runs
    (training, the attack tables), and not in bf16 or without a
    backward; 8 heads of 16 (the default) fits. The check asks the
    library for the f32 K2 at the decoder's first teacher-forced shape
    (the encoder runs no backward there) and stops at its first refusal."""
    wide = dict(decoder_d_model=256, decoder_num_heads=16)
    f32 = Config(dtype="float32").replace(**wide)
    errors = envelope_errors(f32, "transformer", "teacher_forced",
                             smem_limit=SMEM)
    assert len(errors) == 1 and "--dtype float32" in errors[0]
    assert f"needs {BYTES_PER_HEAD * 16} bytes" in errors[0]
    assert library_sizes == [(attn.KERNEL_BWD, torch.float32, 31, 31, 16,
                              16)]
    assert not envelope_errors(f32.replace(decoder_num_heads=8),
                               "transformer", "teacher_forced",
                               smem_limit=SMEM)
    assert not envelope_errors(f32, "transformer", "greedy",
                               smem_limit=SMEM)
    assert not envelope_errors(f32.replace(dtype="bfloat16"), "transformer",
                               "teacher_forced", smem_limit=SMEM)


@pytest.mark.parametrize("cmd,mode", [("evaluate", "greedy"),
                                      ("evaluate", "pgd"),
                                      ("train", None)])
def test_cli_refuses_before_building_a_model(tmp_path, monkeypatch, cmd,
                                             mode):
    monkeypatch.setattr(cli, "resolve_device",
                        lambda _: torch.device("cuda"))

    def refuse(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(cli, "make_model", refuse)
    monkeypatch.setattr(cli, "load_model", refuse)
    argv = [cmd, "--encoder-num-heads", "32", "--log-save-path",
            str(tmp_path), "--checkpoint-path", str(tmp_path)]
    if mode:
        argv += ["--eval-mode", mode]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert "--encoder-num-heads 32" in str(exc.value.code)
