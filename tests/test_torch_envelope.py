"""The check at command start (`ops/envelope.py`): on CUDA, a flag whose
value a kernel of the run does not take is refused with a message naming
the flag, before any model is built; on the CPU, where the plain versions
take any shape, nothing is refused; the default configuration passes for
every variant and mode, and so do the shapes the kernels once refused and
now take (`ACCEPTED`: any length, head width and head count dividing the
width, CE width, star width, beam size).

The check asks no kernel library anything (the f32 K2 at the tuned heads,
whose shared memory it once read from its library, runs the narrow
kernels, whose blocks hold one head whatever the length): here every
library load is recorded, and none may happen."""

import pytest
import torch

from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops.envelope import (
    check_envelope,
    envelope_errors,
)
from deepsc_gan_tpu_torch.utils.config import (
    Config,
    default_seq_len,
    is_star,
)

MODES = [None, "greedy", "beam", "greedy_attack", "greedy_gan",
         "teacher_forced", "pgd"]


@pytest.fixture(autouse=True)
def library_sizes(monkeypatch):
    """-> the names of the kernel libraries the check asked to load (it
    must ask none; a load raises here, as it would on the CPU)."""
    asked = []

    def load(name):
        asked.append(name)
        raise RuntimeError(f"the envelope check loaded {name}")

    monkeypatch.setattr(build, "load", load)
    return asked

# chip_smoke.py's f32 paths on the widened model (encoder 8 heads of 64,
# decoder 8 of 25) and on the wide-heads one (encoder one head of 512,
# decoder 2 of 320)
WIDE_PATH_F32 = dict(dtype="float32", encoder_d_model=512, encoder_d_ff=1024,
                     decoder_d_model=200, decoder_d_ff=400)
WIDE_HEADS_F32 = dict(dtype="float32", encoder_d_model=512,
                      encoder_num_heads=1, encoder_d_ff=1024,
                      decoder_d_model=640, decoder_num_heads=2,
                      decoder_d_ff=1280)

# name -> (variant, eval mode (None: train), Config fields, extra keywords
# of the check, the flag the message must name): what no kernel takes
REFUSED = {
    "beam_size_0": ("transformer", "beam", {}, dict(beam_size=0),
                    "--beam-size 0"),
    "beam_size_past_vocab": ("transformer", "beam", {},
                             dict(beam_size=22235), "--beam-size 22235"),
    "gan_star_heads_7": ("gan_star", None, dict(encoder_num_heads=7), {},
                         "--encoder-d-model 128 / --encoder-num-heads 7"),
    "heads_not_dividing": ("transformer", "greedy",
                           dict(decoder_num_heads=3), {},
                           "--decoder-num-heads 3"),
    "star_heads_5": ("star", "teacher_forced",
                     dict(decoder_d_model=96, decoder_num_heads=5), {},
                     "--decoder-d-model 96 / --decoder-num-heads 5"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_on_cuda_with_the_flag_named(case):
    variant, mode, fields, extra, flag = REFUSED[case]
    cfg = Config(seq_len=default_seq_len(variant)).replace(**fields)
    with pytest.raises(SystemExit) as exc:
        check_envelope(cfg, variant, mode, device="cuda", **extra)
    assert flag in str(exc.value.code)


@pytest.mark.parametrize("case", list(REFUSED))
def test_accepted_on_cpu(case):
    variant, mode, fields, extra, _ = REFUSED[case]
    cfg = Config(seq_len=default_seq_len(variant)).replace(**fields)
    assert envelope_errors(cfg, variant, mode, device="cpu", **extra) == []
    check_envelope(cfg, variant, mode, device=torch.device("cpu"), **extra)


# K1 and K2 take any length: what the check once refused (past 32
# queries or keys) runs, in every mode that launches them
LONG = {
    "seq_len_40": ("transformer", "teacher_forced", dict(seq_len=40)),
    "max_length_40": ("transformer", "greedy", dict(max_length=40)),
    "gan_seq_len_64": ("gan", None, dict(seq_len=64)),
    "greedy_gan_seq_len_128": ("gan", "greedy_gan",
                               dict(seq_len=128, max_length=127)),
}
# what the check refused until each kernel had a wide path (name ->
# (variant, eval mode, Config fields, extra keywords of the check)): the
# f32 K2 at 16 heads of 16 (the narrow kernels take it; before them the
# short kernel's shared memory did not fit and the check read the
# long-length kernels' size); K1/K2 at head widths other than 8, 16 and 32
# and past 16 heads; K3,
# K4 and K6 at widths off their tuned steps or past 256; K5 at any width
# and head count dividing it; K6 past k = 8
WIDENED = {
    "f32_k2_16x16": ("transformer", None,
                     dict(dtype="float32", seq_len=32, encoder_d_model=256,
                          encoder_num_heads=16, decoder_d_model=256,
                          decoder_num_heads=16), {}),
    "f32_k2_16x16_len_31": ("transformer", "teacher_forced",
                            dict(dtype="float32", decoder_d_model=256,
                                 decoder_num_heads=16), {}),
    "head_width_64": ("transformer", None,
                      dict(encoder_d_model=512, encoder_num_heads=8), {}),
    "head_width_24": ("transformer", "pgd",
                      dict(decoder_d_model=192, decoder_num_heads=8), {}),
    "head_width_128_heads_32": ("gan", None,
                                dict(encoder_d_model=4096,
                                     encoder_num_heads=32), {}),
    "heads_32": ("transformer", "greedy",
                 dict(decoder_d_model=256, decoder_num_heads=32), {}),
    "ce_width_512": ("transformer", None,
                     dict(decoder_d_model=512, decoder_num_heads=16), {}),
    "ce_width_200": ("transformer", None,
                     dict(decoder_d_model=200, decoder_num_heads=8), {}),
    "star_d_model_96": ("star", "teacher_forced",
                        dict(encoder_d_model=96, decoder_d_model=96), {}),
    "gan_star_d_model_96": ("gan_star", None,
                            dict(encoder_d_model=96, decoder_d_model=96),
                            {}),
    "star_d_model_512": ("star_multi", "greedy",
                         dict(encoder_d_model=512, decoder_d_model=512),
                         {}),
    "beam_size_9": ("transformer", "beam", {}, dict(beam_size=9)),
    "beam_size_16_d_200": ("transformer", "beam",
                           dict(decoder_d_model=200, decoder_num_heads=8),
                           dict(beam_size=16)),
    "beam_size_64": ("transformer", "beam", {}, dict(beam_size=64)),
    # heads wider than 256: the chunked wide kernels
    "head_width_512": ("transformer", None,
                       dict(encoder_d_model=512, encoder_num_heads=1), {}),
    "decoder_head_width_384": ("transformer", "teacher_forced",
                               dict(decoder_d_model=384,
                                    decoder_num_heads=1), {}),
    # the select K6 (every f32 beam past k = 8, any beam up to V) and the
    # tiled f32 K1 (every f32 head shape off the tuned ones)
    "f32_beam_size_1000": ("transformer", "beam", dict(dtype="float32"),
                           dict(beam_size=1000)),
    "beam_size_vocab": ("transformer", "beam", {}, dict(beam_size=22234)),
    "f32_wide_beam_9": ("transformer", "beam", WIDE_PATH_F32,
                        dict(beam_size=9)),
    "f32_wide_heads_greedy": ("transformer", "greedy", WIDE_HEADS_F32, {}),
}
ACCEPTED = {**{name: (*case, {}) for name, case in LONG.items()},
            **WIDENED}


@pytest.mark.parametrize("case", list(LONG))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_long_lengths_accepted_on_cuda(case, dtype, library_sizes):
    """No length refused, in either dtype, and no library asked: at f32 the
    narrow kernels take every length at the tuned heads (K1 streams key
    tiles, K2 past 32 passes the row statistics between its two kernels),
    so no size depends on the length."""
    variant, mode, fields = LONG[case]
    cfg = Config(dtype=dtype).replace(**fields)
    assert envelope_errors(cfg, variant, mode) == []
    assert library_sizes == []
    heads, dh = cfg.decoder_num_heads, cfg.decoder_d_model \
        // cfg.decoder_num_heads
    assert attn.uses_narrow(torch.float32, heads, dh)


@pytest.mark.parametrize("case", list(ACCEPTED))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_widened_shapes_accepted_on_cuda(case, dtype):
    """Every shape of `ACCEPTED` passes the check on CUDA in both dtypes
    (a case that sets its dtype keeps it), for train and every eval mode
    the case names, with the KV and the full-prefix decoders."""
    variant, mode, fields, extra = ACCEPTED[case]
    cfg = Config(seq_len=default_seq_len(variant), dtype=dtype) \
        .replace(**fields)
    for kv in (False, True):
        assert envelope_errors(cfg, variant, mode, kv_cache=kv,
                               beam_impl="full" if kv else "kv",
                               **extra) == [], case


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
                                   beam_impl="full" if kv else "kv") == [], \
                (variant, mode)


def test_f32_backward_shape_boundary(library_sizes):
    """The f32 K2 at the edge of the tuned heads: 16 heads of 16 (the short
    lane-per-query kernel once did not fit the card's shared memory there)
    and of 32, at the training and the full-prefix lengths, run the narrow
    kernels and pass the check without a library asked; 17 heads, or heads
    of 24, run the tiled ones and pass too; bf16 stays on its tuned
    kernels. Only a head count that does not divide the width is
    refused."""
    for heads, dh, narrow in ((16, 16, True), (16, 32, True), (8, 16, True),
                              (17, 16, False), (8, 24, False)):
        f32 = Config(dtype="float32").replace(
            decoder_d_model=heads * dh, decoder_num_heads=heads,
            encoder_d_model=heads * dh, encoder_num_heads=heads)
        for mode in (None, "teacher_forced", "greedy", "greedy_attack"):
            assert envelope_errors(f32, "transformer", mode) == [], \
                (heads, dh, mode)
        assert attn.uses_narrow(torch.float32, heads, dh) == narrow
        assert attn.uses_tiled(torch.float32, heads, dh) == (not narrow)
        assert not attn.uses_narrow(torch.bfloat16, heads, dh)
    assert library_sizes == []
    bad = Config(dtype="float32").replace(decoder_d_model=250,
                                          decoder_num_heads=16)
    errors = envelope_errors(bad, "transformer", "teacher_forced")
    assert len(errors) == 1 and "--decoder-num-heads 16" in errors[0]


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
    argv = [cmd, "--encoder-num-heads", "3", "--log-save-path",
            str(tmp_path), "--checkpoint-path", str(tmp_path)]
    if mode:
        argv += ["--eval-mode", mode]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert "--encoder-num-heads 3" in str(exc.value.code)


@pytest.mark.parametrize("argv", [
    ["--dtype", "float32", "--eval-mode", "beam", "--beam-size", "1000"],
    ["--dtype", "float32", "--eval-mode", "greedy", "--encoder-d-model",
     "512", "--encoder-num-heads", "1", "--encoder-d-ff", "1024",
     "--decoder-d-model", "640", "--decoder-num-heads", "2",
     "--decoder-d-ff", "1280"],
    ["--dtype", "float32", "--eval-mode", "beam", "--beam-size", "9",
     "--encoder-d-model", "512", "--encoder-d-ff", "1024",
     "--decoder-d-model", "200", "--decoder-d-ff", "400"]])
def test_cli_f32_select_and_tiled_runs_pass_the_envelope(tmp_path,
                                                         monkeypatch, argv):
    """`cli evaluate --dtype float32 --beam-size 1000` (the select K6), the
    f32 greedy sweep of the wide-heads model (the tiled K1 past 256-wide
    heads) and the f32 beam-9 of the widened one pass the check on CUDA
    and go on to build the model."""
    monkeypatch.setattr(cli, "resolve_device",
                        lambda _: torch.device("cuda"))

    def built(*a, **k):
        raise RuntimeError("a model was built")

    monkeypatch.setattr(cli, "make_model", built)
    monkeypatch.setattr(cli, "load_model", built)
    with pytest.raises(RuntimeError, match="a model was built"):
        cli.main(["evaluate", *argv, "--log-save-path", str(tmp_path),
                  "--checkpoint-path", str(tmp_path)])


def _src(name):
    return f"csrc/{name}.cu"


# (dtype, d_model, heads): the tuned heads, heads up to 256 wide, heads
# past 256, more than 16 heads, a width off 8 columns
DESIGN_WIDTHS = [(dt, d, h) for dt in ("float32", "bfloat16")
                 for d, h in ((128, 8), (128, 4), (512, 8), (200, 8),
                              (512, 1), (640, 2), (512, 32), (264, 1))]
# seq_len: the tuned length, past 32, past 128, past 512 (decoder lengths
# are one shorter)
DESIGN_LENGTHS = (32, 64, 256, 640)


@pytest.mark.parametrize("dtype,d,heads", DESIGN_WIDTHS)
@pytest.mark.parametrize("seq_len", DESIGN_LENGTHS)
def test_kernel_designs_follow_the_route_predicates(dtype, d, heads,
                                                    seq_len):
    """Each design `kernel_designs` names for a training run and a beam
    run holds exactly where the wrappers' route predicate for it holds."""
    from deepsc_gan_tpu_torch.ops import ce_kernel as ce
    from deepsc_gan_tpu_torch.ops import topk_kernel as topk
    from deepsc_gan_tpu_torch.ops.envelope import kernel_designs

    cfg = Config(dtype=dtype, encoder_d_model=d, decoder_d_model=d,
                 encoder_num_heads=heads, decoder_num_heads=heads,
                 seq_len=seq_len, max_length=seq_len - 2)
    dt, dh = getattr(torch, dtype), d // heads
    got = kernel_designs(cfg, "transformer", None)
    assert set(got) == {f"K{k} {s}" for k in (1, 2) for s in (
        "encoder", "decoder self", "decoder cross")} | {"K3", "K4"}
    lengths = {"encoder": (seq_len, seq_len),
               "decoder self": (seq_len - 1, seq_len - 1),
               "decoder cross": (seq_len - 1, seq_len)}
    for label, (lq, lk) in lengths.items():
        k1, k2 = got[f"K1 {label}"], got[f"K2 {label}"]
        assert (k1 == _src(attn.KERNEL_NARROW)) == attn.uses_narrow(
            dt, heads, dh)
        assert (k1 == _src(attn.KERNEL_TILED)) == attn.uses_tiled(
            dt, heads, dh)
        assert (k2 == _src(attn.KERNEL_BWD_TILED)) == attn.uses_tiled(
            dt, heads, dh)
        assert (k1 == _src(attn.KERNEL_WIDE_MMA)) == attn.is_wide_mma(
            dt, heads, dh)
        assert (k1 == _src(attn.KERNEL_CHUNKED)) == attn.is_chunked_mma(
            dt, heads, dh)
        assert (k1 == _src(attn.KERNEL)) == (
            dt == torch.bfloat16 and not attn.is_wide(heads, dh))
        assert (k2 == _src(attn.KERNEL_RESIDENT)) == attn.uses_resident(
            dt, lq, lk, heads, dh)
        assert (k2 == _src(attn.KERNEL_CLUSTER)) == attn.uses_cluster(
            dt, lq, lk, heads, dh)
    assert (got["K3"] == _src(ce.KERNEL_FWD_TILED)) == ce.uses_tiled_fwd(
        dt, d)
    assert (got["K3"] == _src(ce.KERNEL_WIDE_FWD)) == \
        ce.uses_tensor_core_fwd(dt, d)
    assert (got["K4"] == _src(ce.KERNEL_BWD_TILED)) == ce.uses_tiled_bwd(
        dt, d)
    assert (got["K4"] == _src(ce.KERNEL_WIDE_BWD)) == \
        ce.uses_tensor_core_bwd(dt, d)
    for k in (1, 4, 9, 64, 100, 1000, 22234):
        beam = kernel_designs(cfg, "transformer", "beam", beam_size=k)
        assert set(beam) == {"K1 encoder", "K6"}
        v = cfg.vocab_size
        assert (beam["K6"] == _src(topk.KERNEL_SELECT)) == \
            topk.uses_select(dt, d, k, v)
        assert beam["K6"].endswith("(long path)") == topk.uses_long_list(
            dt, d, k, v)
        assert beam["K6"].startswith(_src(topk.KERNEL_WIDE_MMA)) == \
            topk.uses_tensor_core(dt, d, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,heads", [(128, 8), (96, 8), (512, 8), (200, 5)])
def test_star_designs_follow_the_route_predicates(dtype, d, heads):
    from deepsc_gan_tpu_torch.ops import star_kernel as star
    from deepsc_gan_tpu_torch.ops.envelope import kernel_designs

    cfg = Config(dtype=dtype, encoder_d_model=d, decoder_d_model=d,
                 encoder_num_heads=heads, decoder_num_heads=heads,
                 seq_len=31)
    got = kernel_designs(cfg, "star", None)
    size = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    for side in ("encoder", "decoder"):
        design = got[f"K5 {side}"]
        assert (design == _src(star.KERNEL)) == star.takes_width(d, heads)
        if not star.takes_width(d, heads):
            assert design == (f"{_src(star.KERNEL_WIDE)} "
                              f"({star.wide_plan(d, heads, size).path} "
                              f"path)")
    assert "K1 encoder" not in got and "K6" not in got


def test_every_design_named_is_a_source_of_the_port():
    from deepsc_gan_tpu_torch.ops.envelope import kernel_designs

    seen = set()
    for dtype, d, heads in DESIGN_WIDTHS:
        for seq_len in DESIGN_LENGTHS:
            cfg = Config(dtype=dtype, encoder_d_model=d, decoder_d_model=d,
                         encoder_num_heads=heads, decoder_num_heads=heads,
                         seq_len=seq_len, max_length=seq_len - 2)
            for mode, k in ((None, 4), ("beam", 4), ("beam", 9),
                            ("beam", 100),
                            ("beam", 1000), ("teacher_forced", 4)):
                seen |= set(kernel_designs(cfg, "transformer", mode,
                                           k).values())
            seen |= set(kernel_designs(cfg, "star", None).values())
    for design in seen:
        assert (build.CSRC.parent / design.split(" ")[0]).exists(), design
    # every library of csrc/ takes some call of these runs
    assert {design.split(" ")[0] for design in seen} == {
        f"csrc/{p.name}" for p in build.CSRC.glob("*.cu")}
