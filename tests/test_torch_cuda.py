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
