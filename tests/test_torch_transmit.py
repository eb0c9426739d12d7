"""`cli transmit` of the port against the JAX CLI's `transmit` on the CPU
at f32: the same weights, a written vocab, sentences from `--text` and
from stdin, and the channel noise the JAX decode draws from its key fed to
the port: the same tx/rx lines."""

import io
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu import cli as jax_cli
from deepsc_gan_tpu_torch import cli
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params

WORDS = ["the", "house", "rose", "and", "observed", "a", "minute", "s",
         "silence", "this", "is", "all", "in", "accordance", "with",
         "principles", "that", "we", "have", "always", "upheld", ";", ","]


def _lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("tx[", "rx["))]


@pytest.mark.parametrize("variant", ["transformer", "star"])
def test_transmit_prints_what_jax_prints(tiny_cfg, tmp_path, monkeypatch,
                                         capsys, variant):
    jcfg = tiny_cfg.replace(cycle_num=2)
    _, params = flax_params(jcfg, seed=2, variant=variant)
    t2i = {"<PAD>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    for w in WORDS:
        t2i[w] = len(t2i)
    vocab = tmp_path / "vocab.json"
    vocab.write_text(json.dumps({"token_to_idx": t2i}))
    pkl = tmp_path / "params.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params)}, f)
    flags = [*TINY_FLAGS, "--cycle-num", "2", "--variant", variant,
             "--vocab-path", str(vocab), "--seed", "3", "--snr", "4",
             "--checkpoint-path", str(tmp_path / "none")]
    texts = ["The House rose, and observed a minute's silence.",
             "This is all in accordance with the principles; unknown!",
             "silence", "we have always upheld"]
    monkeypatch.setattr(jax_cli, "_restore_latest",
                        lambda cfg, v, state, tag: state.replace(
                            params=params))
    jax_cli.main(["transmit", *flags, *sum((["--text", t] for t in texts),
                                           [])])
    want = _lines(capsys.readouterr().out)
    assert len(want) == 2 * len(texts)

    def jax_noise(gen, shape, kind="AWGN", per_sample=False, lead=()):
        assert kind == "AWGN" and not lead
        noise = jax.random.normal(jax.random.PRNGKey(3), shape, jnp.float32)
        return torch.tensor(np.asarray(noise)), None

    monkeypatch.setattr(cli, "draw_channel", jax_noise)
    # the sentences as --text, then as stdin lines (blank ones skipped)
    stdin = "\n".join(["", f"  {texts[0]}  "] + texts[1:] + [" "]) + "\n"
    for argv, inp in ((sum((["--text", t] for t in texts), []), ""),
                      ([], stdin)):
        monkeypatch.setattr("sys.stdin", io.StringIO(inp))
        res = cli.main(["transmit", "--device", "cpu", "--params-pkl",
                        str(pkl), *flags, *argv])
        assert _lines(capsys.readouterr().out) == want
        assert res["ids"].shape == (len(texts), jcfg.max_length + 1)


def test_transmit_refuses_no_input(monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n  \n"))
    with pytest.raises(SystemExit, match="no input"):
        cli.main(["transmit", "--device", "cpu", *TINY_FLAGS])
