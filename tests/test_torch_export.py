"""`cli export` of the port on the CPU at tiny widths: the serving sweep
through `torch.export` with symbolic batch and sweep length, loaded back
and called at (B, S) = (4, 2), (3, 5) and (1, 1), its ids equal to the
eager sweep's on the same draws (the KV greedy sweep for the vanilla and
GAN transceivers, the one-shot sweep for star, the beam and the
full-prefix sweeps, a fading channel's fade as an input); `--static-shapes`
pins the signature; a star variant is refused kv and beam; the artifact
loads and runs in a process that imports only torch."""

import os
import subprocess
import sys

import pytest
import torch

from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.evaluate.beam import make_beam_decode_sweep
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.evaluate.kv_decode import (
    make_greedy_decode_kv_sweep,
)
from deepsc_gan_tpu_torch.utils.config import is_star
import test_torch_model  # noqa: F401  (one PyTorch thread per worker)

# one layer and three decode steps: tracing time grows with the ops traced
FLAGS = ["--vocab-size", "40", "--seq-len", "6", "--max-length", "3",
         "--encoder-num-layer", "1", "--decoder-num-layer", "1",
         "--encoder-d-model", "16", "--decoder-d-model", "16",
         "--encoder-d-ff", "32", "--decoder-d-ff", "32",
         "--encoder-num-heads", "2", "--decoder-num-heads", "2",
         "--cycle-num", "1", "--channel-hidden", "24", "--channel-dim", "8",
         "--channel-dec-hidden", "32", "--dtype", "float32", "--seed", "5"]
CALLS = ((4, 2), (3, 5), (1, 1))


def _export(path, *argv):
    """-> (the CLI's result, the eager model of the same weights, its
    config)."""
    argv = ["export", "--device", "cpu", "--out", str(path), *FLAGS, *argv]
    res = cli.main(argv)
    args = cli.build_parser().parse_args(argv)
    cfg, model, _ = cli.restore_model(args, cli.variant_config(args),
                                      torch.device("cpu"), "test")
    return res, model, cfg


def _inputs(cfg, b, s, seed, fading=False):
    g = torch.Generator().manual_seed(seed)
    inp = torch.randint(4, cfg.vocab_size, (b, cfg.seq_len), generator=g)
    inp[:, 0] = cfg.start_idx
    inp[:, -1] = cfg.end_idx
    inp[0, -2:] = cfg.pad_idx
    noise = torch.randn((s, b, cfg.seq_len, cfg.channel_dim), generator=g)
    n_stds = 0.05 + torch.rand((s,), generator=g)
    args = [inp, noise, torch.tensor(0.0), n_stds]
    if fading:
        args.append(torch.randn((s, 2), generator=g))
    return args


def _check_calls(program, sweep, cfg, fading=False, calls=CALLS):
    """`program` (an ExportedProgram, or the path of a saved one) called at
    `calls` against the eager `sweep` on the same inputs."""
    if not isinstance(program, torch.export.ExportedProgram):
        program = torch.export.load(str(program))
    program = program.module()
    for i, (b, s) in enumerate(calls):
        inp, noise, pnr, n_stds, *fade = _inputs(cfg, b, s, i, fading)
        got = program(inp, noise, pnr, n_stds, *fade)
        want = sweep(inp, 0.0, n_stds, noise, *fade)
        assert got.shape == (s, b, cfg.max_length + 1)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (b, s)


@pytest.fixture(scope="module")
def kv_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "kv.pt2"
    res, model, cfg = _export(path)
    return path, res, model, cfg


def test_round_trip_transformer_kv(kv_artifact):
    path, res, model, cfg = kv_artifact
    assert res["decoder"] == "kv"
    assert res["signature"] == ("(inp[b,6] i64, noise[s,b,6,8] f32, pnr_db "
                                "f32, n_stds[s] f32) -> ids[s,b,4] i32")
    _check_calls(path, make_greedy_decode_kv_sweep(model, cfg), cfg)


@pytest.mark.parametrize("variant", ["star", "gan"])
def test_round_trip_other_variants(tmp_path, variant):
    """star at f32; the GAN transceiver in bf16 with --fuse-qkv (the weights
    cast at every use inside the traced program, the projections packed)."""
    extra = ["--dtype", "bfloat16", "--fuse-qkv"] if variant == "gan" else []
    res, model, cfg = _export(tmp_path / "a.pt2", "--variant", variant,
                              *extra)
    if is_star(variant):
        assert res["decoder"] == "full"
        sweep = make_greedy_decode_sweep(model, cfg, "oneshot")
    else:
        assert res["decoder"] == "kv"
        sweep = make_greedy_decode_kv_sweep(model, cfg)
    _check_calls(tmp_path / "a.pt2", sweep, cfg)


@pytest.mark.parametrize("decoder", ["beam", "full"])
def test_beam_and_full_prefix_equal_eager(tmp_path, decoder):
    """--decoder beam against the eager KV beam sweep; --decoder full
    (through a Rayleigh channel: the fade is an input) against the eager
    full-prefix sweep."""
    extra = (["--decoder", "beam", "--beam-size", "3"] if decoder == "beam"
             else ["--decoder", "full", "--channel", "Rayleigh"])
    res, model, cfg = _export(tmp_path / "a.pt2", *extra)
    if decoder == "beam":
        sweep = make_beam_decode_sweep(model, cfg, 3)
    else:
        assert res["signature"].endswith(
            "n_stds[s] f32, fade[s,2] f32) -> ids[s,b,4] i32")
        sweep = make_greedy_decode_sweep(model, cfg)
    # the program in memory: the round trips above read saved ones
    _check_calls(res["program"], sweep, cfg, fading=decoder == "full",
                 calls=CALLS[1:])


def test_static_shapes_pin_the_signature(tmp_path):
    res, model, cfg = _export(tmp_path / "s.pt2", "--static-shapes", "--bs",
                              "4", "--snr-points", "3")
    assert res["signature"].startswith("(inp[4,6] i64, noise[3,4,6,8] f32")
    program = res["program"].module()
    inp, noise, pnr, n_stds = _inputs(cfg, 4, 3, 0)
    assert torch.equal(program(inp, noise, pnr, n_stds),
                       make_greedy_decode_kv_sweep(model, cfg)(
                           inp, 0.0, n_stds, noise))
    with pytest.raises(Exception):
        program(*_inputs(cfg, 3, 3, 1))


@pytest.mark.parametrize("decoder", ["kv", "beam"])
def test_star_refuses_autoregressive_decoders(tmp_path, decoder):
    with pytest.raises(SystemExit, match="requires an autoregressive"):
        cli.main(["export", "--device", "cpu", "--variant", "star",
                  "--decoder", decoder, "--out", str(tmp_path / "x.pt2"),
                  *FLAGS])
    assert not (tmp_path / "x.pt2").exists()


def test_artifact_runs_in_a_torch_only_process(kv_artifact, tmp_path):
    """A fresh interpreter loads the artifact and decodes with torch alone:
    no module of the port (or of JAX) is imported, and the ids equal the
    eager sweep's."""
    path, _, model, cfg = kv_artifact
    inputs = _inputs(cfg, 3, 2, 7)
    torch.save(inputs, tmp_path / "in.pt")
    code = (
        "import sys, torch\n"
        "p = torch.export.load(sys.argv[1]).module()\n"
        "torch.save(p(*torch.load(sys.argv[2])), sys.argv[3])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'deepsc_gan_tpu_torch', 'deepsc_gan_tpu', 'jax'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code, str(path),
                    str(tmp_path / "in.pt"), str(tmp_path / "out.pt")],
                   cwd=tmp_path, env=env, check=True, timeout=300)
    inp, noise, _, n_stds = inputs
    assert torch.equal(torch.load(tmp_path / "out.pt"),
                       make_greedy_decode_kv_sweep(model, cfg)(
                           inp, 0.0, n_stds, noise))
