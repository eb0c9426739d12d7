"""The training levers of the port on the CPU: `fuse_qkv` (the attention
projections that share an input as one matmul) against the JAX package
with `set_qkv_fusion(True)`, forward and gradients, vanilla and star;
`remat` (each vanilla layer recomputed in the backward, its dropout masks
kept) against the same step without it, dropout on; and `cli train
--profile`, whose trace holds the first epoch's steps."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsc_gan_tpu.ops.attention import set_qkv_fusion
from deepsc_gan_tpu.ops.masks import create_masks as jax_create_masks
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.models import star as port_star
from deepsc_gan_tpu_torch.models import transformer
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention as port_attention
from deepsc_gan_tpu_torch.ops import layers
from deepsc_gan_tpu_torch.ops.masks import create_masks
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_mine import _corpus, assert_close_to_largest
from test_torch_model import flax_params, port_config
from test_torch_star import star_params
from test_torch_train import N_STD, _batches

# variant -> the packed projections of one forward at tiny_cfg: vanilla,
# Q/K/V of 2 encoder and 2 decoder self-attentions and K/V of 2
# cross-attentions; star (cycle_num 2), per cycle 3 in the satellite update
# (Q/K/V on h, K/V on e and on s) and 1 in the relay, in the encoder and
# the decoder, and the decoder's target self-attention
PACKED = {"transformer": 6, "star": 2 * (2 * 4) + 1}


@pytest.fixture
def count_packed(monkeypatch):
    calls = []
    real = layers.project_packed

    def counted(x, denses):
        calls.append(len(denses))
        return real(x, denses)

    monkeypatch.setattr(port_attention, "project_packed", counted)
    monkeypatch.setattr(port_star, "project_packed", counted)
    return calls


@pytest.mark.parametrize("variant", ["transformer", "star"])
def test_fuse_qkv_matches_jax(tiny_cfg, tiny_batch, variant, count_packed):
    """The teacher-forced loss (materialized logits) and its gradient with
    respect to every parameter, the port with cfg.fuse_qkv against the JAX
    package traced under set_qkv_fusion(True): the loss within rtol 1e-5,
    each gradient within 1e-5 of its largest element; the parameter tree
    is the same as without fusion."""
    star = variant == "star"
    cfg = tiny_cfg.replace(encoder_dropout=0.0, decoder_dropout=0.0,
                           fused_ce=False, fuse_qkv=True)
    jmodel, params = (star_params(cfg, 3, variant) if star
                      else flax_params(cfg, seed=3))
    inp = jnp.asarray(tiny_batch)
    tar_inp = inp[:, :-1]
    tar_real = inp if star else inp[:, 1:]
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(
        key, (cfg.bs, cfg.seq_len, cfg.channel_dim), jnp.float32))
    masks = jax_create_masks(inp, tar_inp, cfg.pad_idx)
    p0 = jnp.zeros((cfg.bs, cfg.seq_len, cfg.channel_dim))
    jloss = jsteps.make_forward_loss(jmodel, cfg, "AWGN",
                                     jsteps._loss_kwargs(cfg))
    set_qkv_fusion(True)
    try:
        want, grads = jax.value_and_grad(lambda p: jloss(
            p, inp, tar_inp, tar_real, key, key, p0, 0.0, N_STD,
            *masks))(params)
    finally:
        set_qkv_fusion(False)

    tcfg = port_config(cfg)
    model = convert.load_into(make_model(tcfg, variant), params)
    t = torch.tensor(np.asarray(inp)).long()
    tm = create_masks(t, t[:, :-1], cfg.pad_idx)
    loss = steps.make_forward_loss(model, tcfg, steps._loss_kwargs(tcfg))(
        t, t[:, :-1], t if star else t[:, 1:], torch.tensor(noise), N_STD,
        *tm, None)
    loss.backward()
    assert len(count_packed) == PACKED[variant]
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert_close_to_largest({n: p.grad for n, p in model.named_parameters()},
                            grads, cfg, "grads")


def _remat_step(cfg, remat, batches, n_std=N_STD):
    """Two plain steps with dropout 0.3 from the init of seed 1 and one
    generator seed -> (losses, model, the generator, the layer calls)."""
    model = steps.init_params(make_model(cfg.replace(remat=remat)), 1)
    state = steps.create_train_state(model.train(), cfg)
    step = steps.make_train_step(model, cfg)
    gen = torch.Generator().manual_seed(4)
    calls = []
    for layer in list(model.semantic_encoder.layers) \
            + list(model.semantic_decoder.layers):
        def counted(*a, _forward=layer.forward):
            calls.append(1)
            return _forward(*a)
        layer.forward = counted
    losses = []
    for inp in batches:
        t = torch.from_numpy(inp).long()
        state, loss = step(state, t, t, gen, n_std)
        losses.append(loss.item())
    return losses, model, gen, len(calls)


def test_remat_step_equals_the_step_without(tiny_cfg):
    """With dropout on: the losses within rtol 1e-6, every gradient of the
    last step within 1e-6 of its largest element, and the generator's
    state equal after two steps (the recompute drew nothing and used the
    masks of the first forward); each layer ran twice a step."""
    cfg = port_config(tiny_cfg.replace(encoder_dropout=0.3,
                                       decoder_dropout=0.3))
    batches = _batches(tiny_cfg, 2)
    want, ref, ref_gen, ref_calls = _remat_step(cfg, False, batches)
    got, model, gen, calls = _remat_step(cfg, True, batches)
    assert model.semantic_encoder.remat and model.semantic_decoder.remat
    assert (ref_calls, calls) == (2 * 4, 2 * 2 * 4)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        scale = max(q.grad.abs().max().item(), 1e-30)
        assert (p.grad - q.grad).abs().max().item() <= 1e-6 * scale, name
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_remat_off_autograd_is_the_plain_forward(tiny_cfg, tiny_batch):
    """Without autograd (serving) a remat model runs its layers once and
    gives the model's output without remat."""
    cfg = port_config(tiny_cfg)
    outs = []
    for remat in (False, True):
        model = steps.init_params(make_model(cfg.replace(remat=remat)),
                                  2).eval()
        t = torch.tensor(np.asarray(tiny_batch)).long()
        with torch.no_grad():
            outs.append(model.encode(t, create_masks(t, t[:, :-1])[0]))
    assert torch.equal(outs[0], outs[1])


def test_mask_tape_replays_its_masks():
    gen = torch.Generator().manual_seed(0)
    tape = layers.MaskTape(gen)
    x = torch.ones((4, 5))
    first = [layers.dropout(x, 0.5, tape) for _ in range(2)]
    state = gen.get_state()
    tape.recorded = True
    tape.rewind()
    again = [layers.dropout(x, 0.5, tape) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(gen.get_state(), state)
    plain = torch.Generator().manual_seed(0)
    assert torch.equal(first[0], layers.dropout(x, 0.5, plain))
    assert not torch.equal(first[0], first[1])
    assert transformer.MaskTape is layers.MaskTape


def test_cli_profile_traces_the_first_epoch(tmp_path):
    """`cli train --profile DIR` for two epochs of 8 steps: DIR/trace.json
    is a Chrome trace holding 8 `train_step` regions (the first epoch's
    steps, each with the step's operations), and the run's results are
    those of the run without the profiler."""
    flags = ["train", "--device", "cpu", *TINY_FLAGS, "--bs", "8",
             "--epochs", "2", "--scan-steps", "1", "--log-every", "1000",
             "--train-save-path", _corpus(tmp_path),
             "--log-save-path", str(tmp_path / "log")]
    traced = cli.main(flags + ["--profile", str(tmp_path / "prof"),
                               "--checkpoint-path", str(tmp_path / "a")])
    plain = cli.main(flags + ["--checkpoint-path", str(tmp_path / "b")])
    assert torch.equal(traced["losses"], plain["losses"])
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert names.count("train_step") == 8
    assert any(n.startswith("aten::") for n in names)
    assert any("Optimizer.step" in n for n in names)
