"""The PyTorch port's CUDA kernels on the card (marker `cuda`; they skip
without a CUDA device). This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.train import steps
from deepsc_gan_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

TINY = Config(vocab_size=40, bs=4, seq_len=12, max_length=11,
              encoder_num_layer=2, decoder_num_layer=2,
              encoder_d_model=16, decoder_d_model=16,
              encoder_d_ff=32, decoder_d_ff=32,
              encoder_num_heads=2, decoder_num_heads=2,
              channel_hidden=24, channel_dim=8, channel_dec_hidden=32,
              dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, lq, lk, h, dh, dtype, device):
    """q, k, v ~ N(0, 1); a random 0 / -1e9 bias with one query row of
    every key blocked."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, ln, h * dh),
                                                    np.float32))
               .to(device, dtype) for ln in (lq, lk, lk))
    bias = np.where(rng.random((n, lq, lk)) < 0.3, -1e9, 0.0)
    bias[0, 1, :] = -1e9
    return q, k, v, torch.from_numpy(bias.astype(np.float32)).to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("lq,lk,h,dh", [(32, 32, 8, 16), (31, 31, 8, 16),
                                        (31, 32, 8, 16), (12, 11, 2, 8),
                                        (20, 20, 4, 32)])
def test_kernel_matches_plain_version(cuda, dtype, tol, lq, lk, h, dh):
    """At the serving path's shapes and a few others the kernel takes
    (tolerances as in chip_smoke.py)."""
    q, k, v, bias = _inputs(0, 64, lq, lk, h, dh, dtype, cuda)
    attn.reset_launches()
    out = attn.fused_attention(q, k, v, bias, h, math.sqrt(dh))
    ref = attn.attention_fwd_reference(q, k, v, bias, h, math.sqrt(dh))
    torch.cuda.synchronize()
    assert attn.launches == 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, bias = _inputs(1, 4, 31, 31, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), v, bias, 8, 4.0)
    with pytest.raises(ValueError, match="width"):
        attn.fused_attention(q, k, v, bias, 2, 8.0)  # Dh = 64


def test_tiny_sweep_kernel_ids_equal_plain_ids(cuda):
    """A whole sweep at f32 on the card through the kernel and through the
    plain version, same random weights and noise: identical ids."""
    torch.manual_seed(0)
    model_k = make_model(TINY).to(cuda).eval()
    model_p = make_model(TINY, attention=attn.attention_fwd_reference)
    model_p.load_state_dict(model_k.state_dict())
    model_p.to(cuda).eval()
    rng = np.random.default_rng(2)
    inp = torch.from_numpy(rng.integers(1, 40, (4, 12))).to(cuda)
    inp[:, 8:] = 0
    n_stds = torch.tensor([1.0, 0.5, 0.1], device=cuda)
    noise = torch.randn((3, 4, 12, 8), device=cuda)
    attn.reset_launches()
    ids_k = make_greedy_decode_sweep(model_k, TINY)(inp, 0.0, n_stds, noise)
    assert attn.launches == 2 + 2 * 2 * 11
    ids_p = make_greedy_decode_sweep(model_p, TINY)(inp, 0.0, n_stds, noise)
    assert torch.equal(ids_k, ids_p)


def _err(got, ref, relative=False):
    """max |got - ref|, over max |ref| when `relative`."""
    err = (got.float() - ref.float()).abs().max().item()
    return err / max(ref.float().abs().max().item(), 1e-30) if relative \
        else err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("lq,lk", [(32, 32), (31, 31), (31, 32)])
@pytest.mark.parametrize("dbias", [False, True])
def test_attention_bwd_kernel_matches_plain_version(cuda, dtype, tol, lq, lk,
                                                    dbias):
    """K2 against its plain version at the training path's shapes (batch
    64, 8 heads of 16), with and without dbias."""
    q, k, v, bias = _inputs(3, 64, lq, lk, 8, 16, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    attn.reset_launches()
    got = attn.attention_bwd(q, k, v, bias, g, 8, 4.0, dbias)
    want = attn.attention_bwd_reference(q, k, v, bias, g, 8, 4.0, dbias)
    torch.cuda.synchronize()
    assert attn.bwd_launches == 1
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _err(a, b) <= tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,v", [(100, 16, 1000), (128, 128, 1024)])
def test_ce_kernels_match_plain_versions(cuda, dtype, tol, n, d, v):
    """K3 and K4 against their plain versions at a padded shape (rows and
    vocab not multiples of the 64-tiles) and an exact one: ce and lse
    absolute, dh, dW and db relative to the largest reference value."""
    gen = torch.Generator(cuda).manual_seed(5)
    h = torch.randn((n, d), device=cuda, generator=gen).to(dtype)
    W = (0.3 * torch.randn((v, d), device=cuda, generator=gen)).to(dtype)
    b = 0.1 * torch.randn(v, device=cuda, generator=gen)
    labels = torch.randint(0, v, (n,), device=cuda, generator=gen)
    g = torch.rand(n, device=cuda, generator=gen)
    ce.reset_launches()
    cel, lse = ce.ce_fwd(h, W, b, labels)
    grads = ce.ce_bwd(h, W, b, labels, lse, g)
    ref_ce, ref_lse = ce.ce_fwd_reference(h, W, b, labels)
    ref_grads = ce.ce_bwd_reference(h, W, b, labels, ref_lse, g)
    torch.cuda.synchronize()
    assert (ce.fwd_launches, ce.bwd_launches) == (1, 1)
    assert _err(cel, ref_ce) <= tol and _err(lse, ref_lse) <= tol
    for name, a, r in zip(("dh", "dW", "db"), grads, ref_grads):
        assert a.shape == r.shape and a.dtype == torch.float32
        assert _err(a, r, relative=True) <= tol, name


def test_tiny_train_step_kernels_equal_plain_step(cuda):
    """One f32 train step at tiny widths on the card through the kernels
    and through the plain versions, same weights, noise and dropout masks:
    the loss within rtol 1e-5, every gradient within 1e-4 of the largest
    reference gradient."""
    cfg = TINY.replace(bs=8)
    models = []
    for plain in (False, True):
        attention = attn.plain_attention if plain else attn.fused_attention
        model = steps.init_params(make_model(cfg, attention=attention), 3)
        models.append(model.to(cuda).train())
    rng = np.random.default_rng(6)
    inp = torch.from_numpy(rng.integers(4, 40, (8, 12))).to(cuda)
    inp[:, 0] = 1
    inp[:, 9:] = 0
    losses = []
    for model, plain in zip(models, (False, True)):
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(model, cfg, plain=plain)
        attn.reset_launches()
        ce.reset_launches()
        gen = torch.Generator(cuda).manual_seed(7)
        _, loss = step(state, inp, inp, gen, 0.5)
        torch.cuda.synchronize()
        launches = (attn.launches, attn.bwd_launches, ce.fwd_launches,
                    ce.bwd_launches)
        assert launches == ((0, 0, 0, 0) if plain else (6, 6, 1, 1))
        losses.append(loss.item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-4, name
