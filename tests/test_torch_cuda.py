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

from deepsc_gan_tpu_torch.evaluate.beam import make_beam_decode_sweep
from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode_sweep
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import build
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from deepsc_gan_tpu_torch.ops.envelope import envelope_errors
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


@pytest.fixture(scope="session")
def built():
    """Every kernel library of csrc/, built before the first card test, all
    nvcc processes started together: no test's call, nor a profile of it,
    then spans a compiler run (the card's torch.profiler recorded none or
    some of the kernels of calls profiled while libraries were being built
    in the same process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))


@pytest.fixture
def cuda(built):
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
    bias[0, min(1, lq - 1), :] = -1e9
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


def _blocked_inputs(n, lq, lk, h, dh, dtype, device, seed=12):
    """`_inputs`, and every key of batch row n - 1 blocked too."""
    q, k, v, bias = _inputs(seed, n, lq, lk, h, dh, dtype, device)
    bias[-1] = -1e9
    return q, k, v, bias


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n", [1, 37, 1216])
def test_kernel_takes_every_batch_row_offset(cuda, dtype, tol, n):
    """K1 at Lq = Lk = 31 for one batch row, an odd number (each row's
    31 x 31 f32 bias tile starts at another offset from a 16-byte boundary)
    and the serving sweep's 19 x 64, with fully blocked query rows (a
    blocked row's weights stay near-uniform, as the plain version's)."""
    q, k, v, bias = _blocked_inputs(n, 31, 31, 8, 16, dtype, cuda)
    attn.reset_launches()
    out = attn.attention_fwd(q, k, v, bias, 8, 4.0)
    ref = attn.attention_fwd_reference(q, k, v, bias, 8, 4.0)
    torch.cuda.synchronize()
    assert attn.launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _err(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("h", [2, 3, 8, 16])
@pytest.mark.parametrize("dh", [8, 16, 32])
def test_kernel_takes_every_head_width_and_count(cuda, dtype, tol, h, dh):
    """K1 at every head width it takes (Dh = 8: half a bf16 mma k-step;
    32: two) and 2 to 16 heads, Lq = Lk = 31, with blocked rows."""
    q, k, v, bias = _blocked_inputs(33, 31, 31, h, dh, dtype, cuda)
    out = attn.attention_fwd(q, k, v, bias, h, math.sqrt(dh))
    ref = attn.attention_fwd_reference(q, k, v, bias, h, math.sqrt(dh))
    torch.cuda.synchronize()
    assert _err(out, ref) <= tol


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, bias = _inputs(1, 4, 31, 31, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), v, bias, 8, 4.0)
    # 5 heads do not divide a width of 128
    q, k, v, bias = _inputs(1, 4, 31, 31, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="5 heads"):
        attn.fused_attention(q, k, v, bias, 5, 8.0)


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
@pytest.mark.parametrize("n,lq,lk,h,dh", [
    (64, 32, 32, 8, 16), (64, 31, 31, 8, 16), (64, 31, 32, 8, 16),
    (64, 31, 31, 8, 8), (64, 31, 31, 8, 32), (64, 20, 20, 16, 16),
    (64, 1, 31, 8, 16), (64, 17, 31, 8, 16), (64, 17, 9, 16, 32),
    (1, 31, 31, 8, 16), (1216, 31, 31, 8, 16)])
@pytest.mark.parametrize("dbias", [False, True])
def test_attention_bwd_kernel_matches_plain_version(cuda, dtype, tol, n, lq,
                                                    lk, h, dh, dbias):
    """K2 against its plain version at the training path's shapes (batch
    64, 8 heads of 16), at head widths 8 and 32, 16 heads, one query and
    17 (a second m-tile of one row), one batch row and the serving batch,
    with and without dbias (with it a block holds every head of its row)."""
    q, k, v, bias = _inputs(3, n, lq, lk, h, dh, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    scale = math.sqrt(dh)
    attn.reset_launches()
    got = attn.attention_bwd(q, k, v, bias, g, h, scale, dbias)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, dbias)
    torch.cuda.synchronize()
    assert attn.bwd_launches == 1
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _err(a, b) <= tol, name


@pytest.mark.parametrize("lq,lk,h,dh", [(31, 31, 8, 16), (32, 32, 8, 16),
                                        (17, 9, 16, 32)])
def test_attention_bwd_bf16_is_bitwise_deterministic(cuda, lq, lk, h, dh):
    """The bf16 K2 twice without dbias and once with it (a block of one
    head, then of all heads): dq, dk and dv bitwise equal."""
    q, k, v, bias = _inputs(5, 64, lq, lk, h, dh, torch.bfloat16, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)).to(
                        torch.bfloat16)
    calls = [attn.attention_bwd(q, k, v, bias, g, h, 4.0, dbias)[:3]
             for dbias in (False, False, True)]
    torch.cuda.synchronize()
    for other in calls[1:]:
        for a, b in zip(calls[0], other):
            assert torch.equal(a, b)


# past 32 queries or keys: the long-length kernels (query tiles, key tiles
# streamed with an online softmax); 31 x 64 and 64 x 31 are the two
# cross-attention shapes, one side within a tile and the other past it
LONG = [(33, 33), (48, 48), (64, 64), (100, 100), (128, 128), (256, 256),
        (31, 64), (64, 31)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("lq,lk", LONG)
def test_kernel_takes_any_length(cuda, dtype, tol, lq, lk):
    """K1 past 32 queries and keys against its plain version (8 heads of
    16), with blocked keys and fully blocked query rows."""
    q, k, v, bias = _blocked_inputs(16, lq, lk, 8, 16, dtype, cuda)
    attn.reset_launches()
    out = attn.attention_fwd(q, k, v, bias, 8, 4.0)
    ref = attn.attention_fwd_reference(q, k, v, bias, 8, 4.0)
    torch.cuda.synchronize()
    assert attn.launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _err(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("lq,lk,h,dh", [(40, 40, 16, 32), (70, 50, 2, 8),
                                        (17, 90, 3, 32)])
def test_long_kernel_takes_every_head_width(cuda, dtype, tol, lq, lk, h, dh):
    """K1 and K2 (with dbias) past 32 at head widths 8 and 32, 2, 3 and 16
    heads, and a query tile of fewer than 16 rows."""
    q, k, v, bias = _blocked_inputs(8, lq, lk, h, dh, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(8)).to(dtype)
    scale = math.sqrt(dh)
    out = attn.attention_fwd(q, k, v, bias, h, scale)
    ref = attn.attention_fwd_reference(q, k, v, bias, h, scale)
    got = attn.attention_bwd(q, k, v, bias, g, h, scale, True)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, True)
    torch.cuda.synchronize()
    assert _err(out, ref) <= tol
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _err(a, b) <= tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("lq,lk", LONG)
@pytest.mark.parametrize("dbias", [False, True])
def test_attention_bwd_takes_any_length(cuda, dtype, tol, lq, lk, dbias):
    """K2 past 32 queries and keys against its plain version, with and
    without dbias (8 heads of 16; blocked keys and rows)."""
    q, k, v, bias = _blocked_inputs(16, lq, lk, 8, 16, dtype, cuda)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk", [(128, 128), (31, 64), (64, 31)])
def test_attention_bwd_long_is_bitwise_deterministic(cuda, dtype, lq, lk):
    """The long-length K2 twice without dbias and once with it: dq, dk and
    dv bitwise equal (no atomics; dbias changes no other output)."""
    q, k, v, bias = _inputs(5, 16, lq, lk, 8, 16, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)).to(dtype)
    calls = [attn.attention_bwd(q, k, v, bias, g, 8, 4.0, dbias)[:3]
             for dbias in (False, False, True)]
    torch.cuda.synchronize()
    for other in calls[1:]:
        for a, b in zip(calls[0], other):
            assert torch.equal(a, b)


def _ce_inputs(device, dtype, n, d, v, seed=5):
    """h ~ N(0, 1), W ~ N(0, 0.3^2), b ~ N(0, 0.1^2), uniform labels and
    cotangents in [0, 1)."""
    gen = torch.Generator(device).manual_seed(seed)
    h = torch.randn((n, d), device=device, generator=gen).to(dtype)
    W = (0.3 * torch.randn((v, d), device=device, generator=gen)).to(dtype)
    b = 0.1 * torch.randn(v, device=device, generator=gen)
    labels = torch.randint(0, v, (n,), device=device, generator=gen)
    g = torch.rand(n, device=device, generator=gen)
    return h, W, b, labels, g


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,v", [(100, 16, 1000), (128, 128, 1024),
                                   (1984, 128, 22234)])
def test_ce_kernels_match_plain_versions(cuda, dtype, tol, n, d, v):
    """K3 and K4 against their plain versions at a padded shape (rows and
    vocab not multiples of the 64-tiles), an exact one and the training
    path's (64 x 31 rows, the vocab of 22,234): ce and lse absolute, dh, dW
    and db relative to the largest reference value."""
    h, W, b, labels, g = _ce_inputs(cuda, dtype, n, d, v)
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("n,d,v", [(100, 16, 1000), (128, 128, 1024),
                                   (1984, 128, 22234)])
def test_ce_bwd_softmax_part_matches_plain_version(cuda, dtype, tol, n, d,
                                                   v):
    """K4's dh, dW and db against its plain version relative to the
    largest value of the plain version's softmax part (P without the label
    term), which beside the label term can be too small for the test above
    to see."""
    h, W, b, labels, g = _ce_inputs(cuda, dtype, n, d, v)
    lse = ce.ce_fwd_reference(h, W, b, labels)[1]
    got = ce.ce_bwd(h, W, b, labels, lse, g)
    want = ce.ce_bwd_reference(h, W, b, labels, lse, g)
    part = ce.ce_bwd_reference(h, W, b, labels, lse, g, softmax_only=True)
    torch.cuda.synchronize()
    for name, a, r, c in zip(("dh", "dW", "db"), got, want, part):
        assert (a - r).abs().max().item() <= tol * c.abs().max().item(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_kernels_are_deterministic(cuda, dtype):
    """Two calls of K3 and of K4 on the same inputs at the training path's
    shape give bitwise-equal outputs (no atomics; every sum across blocks
    in a fixed order)."""
    h, W, b, labels, g = _ce_inputs(cuda, dtype, 1984, 128, 22234, seed=11)
    first = ce.ce_fwd(h, W, b, labels)
    second = ce.ce_fwd(h, W, b, labels)
    grads = [ce.ce_bwd(h, W, b, labels, first[1], g) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    for a, c in zip(*grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("kernel,dtype,tile_n,vocab_rows",
                         [(ce.KERNEL_FWD_TILED, torch.float32, 128, 128),
                          (ce.KERNEL_FWD, torch.bfloat16, 64, 128),
                          (ce.KERNEL_BWD_TILED, torch.float32, 128, 128),
                          (ce.KERNEL_BWD, torch.bfloat16, 64, 64),
                          (topk.KERNEL, torch.float32, 128, 128),
                          (topk.KERNEL, torch.bfloat16, 64, 128)])
def test_ce_tiling_comes_from_the_kernels(cuda, kernel, dtype, tile_n,
                                          vocab_rows):
    """Each CE library and K6's report the tiles of the kernel that takes
    the vocab splits (the f32 CE's tiled kernels and the f32 K6 128 x 128;
    else 64 rows of h and 128 vocab rows for the bf16 forward and the bf16
    K6, else 64) and
    how many of its blocks fit an SM at D = 128; at the training path's
    shape its splits' blocks fit in one wave."""
    rows, tile_v, blocks = ce.tiling(kernel, dtype, 128, torch.device(cuda))
    assert (rows, tile_v) == (tile_n, vocab_rows) and blocks >= 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if kernel == ce.KERNEL_BWD_TILED:
        splits = ce.tiled_splits(1984, 128, 22234, sms, blocks)
    else:
        splits = ce.vocab_splits(1984, 22234, sms, rows, tile_v, blocks)
    assert splits == 1 or -(-1984 // rows) * splits <= blocks * sms


@pytest.mark.parametrize("d", [8, 24])
def test_ce_wrappers_take_a_bf16_width_off_the_wgmma_step(cuda, d):
    """The tuned bf16 kernels take D a multiple of 16 (one wgmma k-step):
    D = 8 or 24 goes to the wide kernels, counted as theirs, and matches
    the plain versions."""
    h, W, b, labels, g = _ce_inputs(cuda, torch.bfloat16, 64, d, 300)
    ce.reset_launches()
    cel, lse = ce.ce_fwd(h, W, b, labels)
    grads = ce.ce_bwd(h, W, b, labels, lse, g)
    want = ce.ce_fwd_reference(h, W, b, labels)
    want_grads = ce.ce_bwd_reference(h, W, b, labels, want[1], g)
    torch.cuda.synchronize()
    assert (ce.fwd_launches, ce.bwd_launches) == (1, 1)
    assert (ce.wide_fwd_launches, ce.wide_bwd_launches) == (1, 1)
    assert _err(cel, want[0]) <= 3.2e-2 and _err(lse, want[1]) <= 3.2e-2
    for a, r in zip(grads, want_grads):
        assert _err(a, r, relative=True) <= 3.2e-2


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,v,k", [(100, 16, 1000, 4), (256, 128, 1024, 8),
                                     (7, 8, 17, 1)])
def test_topk_kernel_matches_plain_version(cuda, dtype, tol, n, d, v, k):
    """K6 against its plain version at padded shapes (rows and vocab not
    multiples of the 64-tiles) and an exact one: the same indices, vals and
    lse within the tolerance."""
    gen = torch.Generator(cuda).manual_seed(8)
    h = torch.randn((n, d), device=cuda, generator=gen).to(dtype)
    W = (0.3 * torch.randn((v, d), device=cuda, generator=gen)).to(dtype)
    b = 0.1 * torch.randn(v, device=cuda, generator=gen)
    topk.reset_launches()
    vals, idx, lse = topk.topk_logits(h, W, b, k)
    rv, ri, rl = topk.topk_logits_reference(h, W, b, k)
    torch.cuda.synchronize()
    assert topk.launches == 1
    assert vals.shape == (n, k) and idx.dtype == torch.int32
    assert torch.equal(idx, ri)
    assert _err(vals, rv) <= tol and _err(lse, rl) <= tol


def _dyadic(gen, shape, scale, dtype, device):
    """Integers in [-scale, scale] over 8 * scale: exact in bf16, and with
    h at scale 8, W at 2 and b at 8 every logit (D = 128) is exact in f32
    whatever the order of the sums (as chip_smoke.py's `dyadic`)."""
    x = torch.randint(-scale, scale + 1, shape, device=device, generator=gen)
    return (x.float() / (8 * scale)).to(dtype)


def _topk_dyadic(device, dtype, n, v, seed, shift=0.0):
    gen = torch.Generator(device).manual_seed(seed)
    return (_dyadic(gen, (n, 128), 8, dtype, device),
            _dyadic(gen, (v, 128), 2, dtype, device),
            _dyadic(gen, (v,), 8, torch.float32, device) + shift)


def _topk_equal(got, want, tol):
    """The same indices, vals and lse within `tol`."""
    assert torch.equal(got[1], want[1])
    assert _err(got[0], want[0]) <= tol and _err(got[2], want[2]) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("v", [1000, 22234])
def test_topk_kernel_keeps_padded_vocab_columns_out(cuda, dtype, tol, v):
    """Every logit below 0 (the dyadic logits less 3) over a vocab that is
    not a multiple of the kernels' tiles (64 rows f32, 128 bf16): a padded
    column, whose logit would be 0, enters neither the list nor lse."""
    h, W, b = _topk_dyadic(cuda, dtype, 100, v, 13, shift=-3.0)
    assert (h.float() @ W.float().t() + b).amax().item() < 0
    got = topk.topk_logits(h, W, b, 8)
    want = topk.topk_logits_reference(h, W, b, 8)
    torch.cuda.synchronize()
    assert int(got[1].max()) < v
    _topk_equal(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n", [100, 256])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_topk_kernel_takes_every_list_length(cuda, dtype, tol, n, k):
    """K6 at k = 1 to 4 and 8 (the bf16 kernel keeps lists of 1, 2, 4 or
    8: the smallest that holds k),
    at a row count that is not a multiple of 64 and at the beam's 256, on
    exact logits with many ties: the same indices as the plain version."""
    h, W, b = _topk_dyadic(cuda, dtype, n, 22234, 14)
    topk.reset_launches()
    got = topk.topk_logits(h, W, b, k)
    want = topk.topk_logits_reference(h, W, b, k)
    torch.cuda.synchronize()
    assert topk.launches == 1 and got[0].shape == (n, k)
    _topk_equal(got, want, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_is_deterministic(cuda, dtype):
    """Two calls of K6 at the beam sweep's shape (19 x 64 x 4 rows) give
    bitwise-equal outputs (no atomics; lists and sums merged in a fixed
    order)."""
    gen = torch.Generator(cuda).manual_seed(15)
    h = torch.randn((4864, 128), device=cuda, generator=gen).to(dtype)
    W = (0.3 * torch.randn((22234, 128), device=cuda, generator=gen)) \
        .to(dtype)
    b = 0.1 * torch.randn(22234, device=cuda, generator=gen)
    first = topk.topk_logits(h, W, b, 4)
    second = topk.topk_logits(h, W, b, 4)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_ties_go_to_the_lowest_index(cuda, dtype):
    """Equal maxima far apart in the vocab (in different vocab splits of
    the kernel at N = 256): the lowest indices first."""
    n, d, v = 256, 128, 22234
    h = torch.ones((n, d), device=cuda, dtype=dtype)
    W = torch.zeros((v, d), device=cuda, dtype=dtype)
    b = torch.zeros(v, device=cuda)
    b[[21000, 5, 11000, 64]] = 1.0
    vals, idx, _ = topk.topk_logits(h, W, b, 6)
    ref = topk.topk_logits_reference(h, W, b, 6)
    assert torch.equal(idx, ref[1])
    assert idx[0].tolist() == [5, 64, 11000, 21000, 0, 1]
    assert torch.equal(vals, ref[0])


def test_topk_wrapper_raises_on_an_unsupported_k(cuda):
    """k outside 1..V (k = 9 and more go to the wide kernels)."""
    h = torch.randn((4, 16), device=cuda)
    W = torch.randn((40, 16), device=cuda)
    b = torch.zeros(40, device=cuda)
    for k in (0, 41):
        with pytest.raises(ValueError, match="k"):
            topk.topk_logits(h, W, b, k)


def test_tiny_beam_kernel_ids_equal_plain_ids(cuda):
    """A beam-4 sweep at f32 on the card with candidates scored by K6 and
    by its plain version, same weights and noise: identical ids."""
    torch.manual_seed(1)
    model = make_model(TINY).to(cuda).eval()
    rng = np.random.default_rng(3)
    inp = torch.from_numpy(rng.integers(3, 40, (4, 12))).to(cuda)
    inp[:, 0] = 1
    inp[:, 9:] = 0
    n_stds = torch.tensor([1.0, 0.3], device=cuda)
    noise = torch.randn((2, 4, 12, 8), device=cuda)
    topk.reset_launches()
    ids_k = make_beam_decode_sweep(model, TINY, 4)(inp, 0.0, n_stds, noise)
    assert topk.launches == TINY.max_length
    ids_p = make_beam_decode_sweep(
        model, TINY, 4, topk=topk.topk_logits_reference)(inp, 0.0, n_stds,
                                                         noise)
    assert topk.launches == TINY.max_length
    assert torch.equal(ids_k, ids_p)


def _ring(device, dtype, b, l, d, seed=9):
    """The satellite ring q, kh, vh, ke, ve (b, l, d) and ks, vs (b, d)
    ~ N(0, 1)."""
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn((b, l, d) if i < 5 else (b, d), device=device,
                        generator=gen).to(dtype) for i in range(7)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("b,l,d,h", [(64, 31, 128, 8), (1216, 31, 128, 8),
                                     (1, 1987, 128, 8), (3, 5, 64, 4),
                                     (2, 9, 256, 8), (2, 7, 128, 32),
                                     (64, 1, 128, 8), (64, 2, 128, 8),
                                     (37, 1, 64, 4), (37, 2, 256, 8),
                                     (40000, 1, 128, 8), (20000, 2, 128, 8),
                                     (5000, 9, 64, 4)])
def test_star_kernel_matches_plain_version(cuda, dtype, tol, b, l, d, h):
    """K5 on the unstacked ring against its plain version (stack, roll,
    `satellite_reference`) at the star paths' shapes (the train step's B =
    64, a row a warp, and the sweep decoder's 19 x 64, L = 31, runs of 8
    rows a warp), at L = 1 and 2 (the neighbours coincide) in both, at a
    run that does not divide L, and at the other widths and head layouts
    it takes."""
    ring = _ring(cuda, dtype, b, l, d)
    star.reset_launches()
    out = star.star_satellite(*ring, h)
    ref = star.ring_reference(*ring, h)
    torch.cuda.synchronize()
    assert star.launches == 1
    assert out.shape == (b, l, d) and out.dtype == dtype
    assert _err(out, ref) <= tol


def test_star_wrapper_raises_on_an_unsupported_shape(cuda):
    ring = _ring(cuda, torch.float32, 2, 4, 128)
    with pytest.raises(ValueError, match="divides D"):
        star.star_satellite(*ring, 3)         # heads that do not divide D
    with pytest.raises(ValueError, match="divides D"):
        star.star_satellite(*(t[..., :96].contiguous() for t in ring),
                            5)                # D 96, 5 heads
    with pytest.raises(ValueError, match="shapes"):
        star.star_satellite(*ring[:5], ring[1], ring[6], 8)  # ks (B, L, D)
    with pytest.raises(ValueError, match="contiguous"):
        star.star_satellite(ring[0], ring[1].transpose(0, 1).contiguous()
                            .transpose(0, 1), *ring[2:], 8)
    with pytest.raises(TypeError, match="dtype"):
        star.star_satellite(*(t.half() for t in ring), 8)


TINY_STAR = TINY.replace(encoder_d_model=64, decoder_d_model=64,
                         encoder_num_heads=4, decoder_num_heads=4,
                         cycle_num=2)


@pytest.mark.parametrize("variant", ["star", "star_multi"])
def test_tiny_star_train_step_kernel_equals_plain_step(cuda, variant):
    """One f32 star step at small widths (D = 64, the narrowest K5 takes)
    through K5 and the CE kernels and through the plain versions, same
    weights, noise and dropout masks: the loss within rtol 1e-5, every
    gradient within 1e-4 of the largest reference gradient."""
    cfg = TINY_STAR.replace(bs=8)
    rng = np.random.default_rng(6)
    inp = torch.from_numpy(rng.integers(4, 40, (8, 12))).to(cuda)
    inp[:, 0] = 1
    inp[:, 9:] = 0
    losses, models = [], []
    for plain in (False, True):
        satellite = star.plain_satellite if plain else star.satellite_attention
        model = steps.init_params(make_model(cfg, variant,
                                             satellite=satellite), 3)
        model = model.to(cuda).train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(model, cfg, plain=plain,
                                     full_target=True)
        star.reset_launches()
        ce.reset_launches()
        gen = torch.Generator(cuda).manual_seed(7)
        _, loss = step(state, inp, inp, gen, 0.5)
        torch.cuda.synchronize()
        layers = 1 if variant == "star" else cfg.encoder_num_layer
        want = (0, 0, 0) if plain else (2 * layers * cfg.cycle_num, 1, 1)
        assert (star.launches, ce.fwd_launches, ce.bwd_launches) == want
        losses.append(loss.item())
        models.append(model)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-4, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,v", [(100, 16, 1000), (1984, 128, 22234)])
def test_ce_bwd_dh_only_mode(cuda, dtype, tol, n, d, v):
    """K4's dh-only mode: dh bitwise equal to the full mode's (the same dh
    kernel and split sum), within tol of the plain version's relative to
    its largest value, no dW or db returned, one K4 launch counted as
    dh-only, and no dW/db kernel on the device (torch.profiler; in f32 the
    tiled kernels' names)."""
    from torch.profiler import ProfilerActivity, profile

    h, W, b, labels, g = _ce_inputs(cuda, dtype, n, d, v)
    lse = ce.ce_fwd_reference(h, W, b, labels)[1]
    full = ce.ce_bwd(h, W, b, labels, lse, g)
    ce.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ce.ce_bwd(h, W, b, labels, lse, g, dh_only=True)
        torch.cuda.synchronize()
    want = ce.ce_bwd_reference(h, W, b, labels, lse, g, dh_only=True)
    assert got[1] is None and got[2] is None and want[1:] == (None, None)
    assert (ce.bwd_launches, ce.bwd_dh_only_launches) == (1, 1)
    assert torch.equal(got[0], full[0])
    assert _err(got[0], want[0], relative=True) <= tol
    names = [e.name for e in prof.events()]
    prefix = "ce_bwd_tiled_" if dtype == torch.float32 else "ce_"
    assert any(prefix + "dh" in name for name in names), names
    assert not any(prefix + "dw" in name for name in names), names


def test_softmax_xent_with_a_fixed_table_runs_dh_only(cuda):
    """The CE Function asks K4 for dh alone when neither W nor b needs a
    gradient, and the full mode otherwise; dh is the same either way."""
    h, W, b, labels, g = _ce_inputs(cuda, torch.bfloat16, 256, 128, 4096)
    grads = []
    for fixed in (True, False):
        hl = h.detach().requires_grad_(True)
        Wl, bl = (t.detach().requires_grad_(not fixed) for t in (W, b))
        ce.reset_launches()
        loss = ce.softmax_xent(hl, Wl, bl, labels.to(torch.int32))
        (loss * g).sum().backward()
        torch.cuda.synchronize()
        assert (ce.bwd_launches, ce.bwd_dh_only_launches) == (1, int(fixed))
        assert (Wl.grad is None) == fixed
        grads.append(hl.grad)
    assert torch.equal(*grads)


@pytest.mark.parametrize("heads,dh", [(16, 16), (8, 16), (8, 32), (16, 32)])
def test_envelope_accepts_every_f32_tuned_head_count(cuda, heads, dh):
    """`cli train` at f32 (seq_len 32) at 8 or 16 heads of 16 or 32: the
    check at command start refuses nothing, and the narrow K2 takes the
    encoder's 32 x 32 call at every such head count (its blocks hold one
    head: no shared-memory size depends on the heads; the lane-per-query
    K2 before it did not fit 16 heads and took its long-length kernels)."""
    cfg = Config(dtype="float32").replace(
        encoder_d_model=heads * dh, encoder_num_heads=heads,
        decoder_d_model=heads * dh, decoder_num_heads=heads)
    assert envelope_errors(cfg, "transformer", None, device=cuda) == []
    assert attn.uses_narrow(torch.float32, heads, dh)
    q, k, v, bias = _blocked_inputs(8, 32, 32, heads, dh, torch.float32,
                                    cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    scale = math.sqrt(dh)
    got = attn.attention_bwd(q, k, v, bias, g, heads, scale, False)
    want = attn.attention_bwd_reference(q, k, v, bias, g, heads, scale,
                                        False)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert _err(a, b) <= 1e-5


@pytest.mark.parametrize("kind,eq,per_sample", [("Rayleigh", None, False),
                                                ("Rician", "MMSE", True),
                                                ("Rayleigh", "LS", True)])
def test_fading_transmit_on_cuda_equals_cpu(cuda, kind, eq, per_sample):
    """`transmit` through a fading channel on the card equals the CPU's on
    the same draws, with a sweep's noise-level axis."""
    from deepsc_gan_tpu_torch.models.channel import draw_channel

    cfg = TINY.replace(channel=kind, equalizer=eq,
                       fading_per_sample=per_sample)
    model = make_model(cfg)
    gen = torch.Generator().manual_seed(4)
    tx = torch.randn((4, 12, cfg.channel_dim), generator=gen)
    noise, fade = draw_channel(gen, tx.shape, kind, per_sample, (3,))
    n_stds = torch.tensor([0.9, 0.3, 0.05]).reshape(3, 1, 1, 1)
    want = model.transmit(tx[None], noise, n_stds, fade=fade)
    got = model.to(cuda).transmit(tx[None].to(cuda), noise.to(cuda),
                                  n_stds.to(cuda), fade=fade.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_tiny_attack_step_kernels_equal_plain_step(cuda):
    """One f32 FGM step (adv_weight 0.5) at tiny widths through the kernels
    and through the plain versions, same weights, draws and dropout masks:
    both losses within rtol 1e-5, every gradient within 1e-4 of the largest
    reference gradient; phase 1 runs K4 in its dh-only mode."""
    cfg = TINY.replace(bs=8)
    rng = np.random.default_rng(6)
    inp = torch.from_numpy(rng.integers(4, 40, (8, 12))).to(cuda)
    inp[:, 0] = 1
    inp[:, 9:] = 0
    out, models = [], []
    for plain in (False, True):
        attention = attn.plain_attention if plain else attn.fused_attention
        model = steps.init_params(make_model(cfg, attention=attention), 3)
        model = model.to(cuda).train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_attack_step(model, cfg, adv_weight=0.5,
                                            plain=plain)
        attn.reset_launches()
        ce.reset_launches()
        gen = torch.Generator(cuda).manual_seed(7)
        _, (clean, adv) = step(state, inp, inp, gen, 0.0, 0.5, 1.0)
        torch.cuda.synchronize()
        launches = (attn.launches, attn.bwd_launches, ce.fwd_launches,
                    ce.bwd_launches, ce.bwd_dh_only_launches)
        # phase 1: 6 K1, 3 K2 (decoder layer 1's self-attention is off the
        # path to y), K3, K4 dh-only; phase 2: two forwards and backwards
        assert launches == ((0,) * 5 if plain else (18, 15, 3, 3, 1))
        out.append((clean.item(), adv.item()))
        models.append(model)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-4, name


# ---- the f32 K1 and K2 at the tuned heads on the narrow kernels, and the
# wide kernels of K1/K2, K3/K4, K5 and K6 ----


def test_f32_k2_whose_short_kernel_does_not_fit_takes_the_long_kernels(
        cuda):
    """16 heads of 16 at Lq = Lk = 31 in f32, where the lane-per-query K2's
    block (all heads of a row) did not fit the card: the narrow kernel
    takes it, one block a row and head, with and without dbias, against
    the plain version, and counts a narrow launch (no wide one)."""
    q, k, v, bias = _blocked_inputs(64, 31, 31, 16, 16, torch.float32, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    for dbias in (False, True):
        attn.reset_launches()
        got = attn.attention_bwd(q, k, v, bias, g, 16, 4.0, dbias)
        want = attn.attention_bwd_reference(q, k, v, bias, g, 16, 4.0, dbias)
        torch.cuda.synchronize()
        assert (attn.bwd_launches, attn.wide_bwd_launches,
                attn.narrow_bwd_launches) == (1, 0, 1)
        for a, r in zip(got, want):
            if r is not None:
                assert _err(a, r) <= 1e-5


# the narrow f32 K1/K2 (csrc/attention_narrow.cu): the main model's shapes
# (training N = 64 and serving N = 1,216), 16 heads of 16 and of 32, heads
# of 8, one query, one key, past 32 of either (one and several key or
# query tiles; K2's pair of kernels), and key rows past two tiles
NARROW_SHAPES = [(8, 16, 64, 31, 31), (8, 16, 64, 32, 32),
                 (8, 16, 64, 31, 32), (8, 16, 1216, 31, 31),
                 (16, 16, 64, 31, 31), (16, 32, 8, 31, 31),
                 (2, 8, 8, 7, 9), (1, 32, 4, 1, 1), (8, 16, 64, 1, 31),
                 (8, 16, 16, 128, 128), (8, 16, 16, 63, 64),
                 (8, 32, 4, 31, 70), (3, 8, 4, 70, 20), (8, 16, 2, 300, 300),
                 (8, 32, 4, 128, 128), (4, 8, 4, 129, 40)]


@pytest.mark.parametrize("h,dh,n,lq,lk", NARROW_SHAPES)
def test_narrow_attention_matches_plain_version(cuda, h, dh, n, lq, lk):
    """The f32 K1 and K2 (with and without dbias) at the tuned heads, with
    fully blocked rows: within 1e-5 of the plain versions (dbias of its
    largest value); the device ran the narrow kernels alone
    (torch.profiler's names, `_ran_route`: K1 one kernel, K2 one up to 32
    queries and keys, else a dq and a dk/dv kernel, and the dbias sum),
    each call counted as a narrow launch and not a wide one; two calls give
    the same bits, and K2's dq, dk and dv the same with or without
    dbias."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, torch.float32, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    scale = math.sqrt(dh)
    assert attn.uses_narrow(torch.float32, h, dh)
    attn.reset_launches()
    out = _ran_route(lambda: attn.attention_fwd(q, k, v, bias, h, scale),
                     ["attention_narrow_fwd_kernel"])
    assert (attn.launches, attn.wide_launches, attn.narrow_launches) == (
        1, 0, 1)
    assert _err(out, attn.attention_fwd_reference(q, k, v, bias, h,
                                                  scale)) <= 1e-5
    assert torch.equal(out, attn.attention_fwd(q, k, v, bias, h, scale))
    bwd = (["attention_narrow_dq_kernel", "attention_narrow_dkv_kernel"]
           if attn.is_long(lq, lk) else ["attention_narrow_bwd_kernel"])
    calls = []
    for dbias in (False, True, False):
        attn.reset_launches()
        calls.append(_ran_route(
            lambda: attn.attention_bwd(q, k, v, bias, g, h, scale, dbias),
            bwd + (["attention_narrow_dbias_kernel"] if dbias else [])))
        assert (attn.bwd_launches, attn.wide_bwd_launches,
                attn.narrow_bwd_launches) == (1, 0, 1)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, True)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), calls[1], want):
        tol = 1e-5 * (r.abs().max().item() if name == "dbias" else 1.0)
        assert _err(a, r) <= tol, name
    for other in calls[1:]:
        assert all(torch.equal(a, b) for a, b in zip(calls[0][:3],
                                                     other[:3]))


def test_narrow_bwd_scratch_comes_from_the_library(cuda):
    """The wrapper's narrow K2 scratch (`narrow_bwd_scratch_floats`) is the
    library's own size at every shape kind: short or long, with or without
    dbias."""
    for n, lq, lk, heads in ((64, 31, 31, 8), (64, 32, 32, 16),
                             (64, 128, 128, 8), (16, 63, 64, 8),
                             (2, 5, 70, 2), (3, 70, 5, 4)):
        for dbias in (False, True):
            assert attn.narrow_bwd_scratch_floats(n, lq, lk, heads, dbias) \
                == attn.library_narrow_bwd_scratch_floats(n, lq, lk, heads,
                                                          dbias)


def test_narrow_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    """When a narrow kernel reports a failed launch, its wrapper raises and
    counts nothing: no fall-back to the plain versions."""
    q, k, v, bias = _inputs(3, 4, 31, 31, 8, 16, torch.float32, cuda)
    g = torch.randn(q.shape, device=cuda)
    for kernel in (attn.KERNEL, attn.KERNEL_BWD):
        attn._bind_narrow(kernel)
        monkeypatch.setitem(attn._BOUND, (attn.KERNEL_NARROW, kernel),
                            lambda *args: 1)
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_fwd(q, k, v, bias, 8, 4.0)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_bwd(q, k, v, bias, g, 8, 4.0, True)
    assert (attn.launches, attn.bwd_launches, attn.narrow_launches,
            attn.narrow_bwd_launches) == (0, 0, 0, 0)


WIDE_HEADS = [(32, 16), (8, 24), (8, 25), (4, 64), (32, 64), (2, 128),
              (32, 128), (1, 256), (3, 5), (2, 320), (1, 257)]


# the modules whose launch counters a profiled call may move
_COUNTED = (attn, ce, star, topk)


def _counts_restorer():
    """A function that puts every kernel launch counter back to its value
    now."""
    counts = [{name: value for name, value in vars(mod).items()
               if name.endswith("launches") and isinstance(value, int)}
              for mod in _COUNTED]

    def restore():
        for mod, saved in zip(_COUNTED, counts):
            for name, value in saved.items():
                setattr(mod, name, value)
    return restore


def _ran(call):
    """(what `call` returns, the names of the device kernels it launched,
    from torch.profiler). The card's profiler now and then records no
    device kernel at all for a whole profile, in short runs of consecutive
    profiles, whatever the activities (scripts/profiler_probe.py): a
    profile that holds no device kernel is taken again, with the launch
    counters put back first, three times at most. A profile that records
    any kernel is returned as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    restore = _counts_restorer()
    for _ in range(3):
        restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)}
        if names:
            break
    return out, names


def _wide_kernels(dtype, h, dh, lq, lk):
    """The device kernels the wide K1 and K2 (with dbias) launch: in bf16
    at heads up to 256 wide the tensor-core wide kernels
    (csrc/attention_wide_mma.cu), wider bf16 heads the tensor-core chunked
    kernels (csrc/attention_chunked.cu; K2 of both a single kernel up to 32
    queries and keys, a dq and a dk/dv kernel past them, and the dbias sum
    they share, csrc/mma_row.cuh), f32 the tiled forward
    (csrc/attention_tiled.cu) and the tiled backward
    (csrc/attention_bwd_tiled.cu: the dq kernel, the dk/dv kernel and the
    dbias sum)."""
    for pre, takes in (("wide_mma", attn.is_wide_mma),
                       ("chunked_mma", attn.is_chunked_mma)):
        if takes(dtype, h, dh):
            bwd = ([f"{pre}_bwd_dq_kernel", f"{pre}_bwd_dkv_kernel"]
                   if attn.is_long(lq, lk) else [f"{pre}_bwd_kernel"])
            fwd = ("attention_fwd_chunked_mma_kernel"
                   if pre == "chunked_mma" else "wide_mma_fwd_kernel")
            return [fwd], bwd + ["mma_dbias_kernel"]
    return ["attention_fwd_tiled_kernel"], [
        f"attention_bwd_tiled_{kind}_kernel"
        for kind in ("dq", "dkv", "dbias")]


def _assert_ran(names, want):
    assert len(names) == len(want) and all(
        sum(w in name for name in names) == 1 for w in want), (names, want)


def _ran_checked(call, check):
    """`_ran(call)`, profiled again (three times at most) while
    `check(names)` raises: the card's profiler has left out some kernels of
    a call (PERF.md), not only all of them. A route that is wrong fails all
    three, with the last check's error. The launch counters are put back
    before each profile, so they count the call once. -> what `call`
    returns."""
    restore = _counts_restorer()
    for attempt in range(3):
        restore()
        out, names = _ran(call)
        try:
            check(names)
            break
        except AssertionError:
            if attempt == 2:
                raise
    return out


def _ran_route(call, want):
    """`_ran_checked` for the kernel names `want` exactly (`_assert_ran`)."""
    return _ran_checked(call, lambda names: _assert_ran(names, want))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("h,dh", WIDE_HEADS)
@pytest.mark.parametrize("lq,lk", [(31, 31), (31, 32), (40, 33), (70, 97)])
def test_wide_attention_matches_plain_version(cuda, dtype, tol, h, dh, lq,
                                              lk):
    """K1 and K2 at head widths other than 8, 16 and 32 (not multiples of
    the mma k-step too) and past 16 heads, through the wide kernels, with
    fully blocked rows, up to 32 queries and keys and past them (70 x 97:
    three query tiles, four streamed key tiles): the forward, and dq, dk,
    dv and dbias, against the plain versions; launches counted as the wide
    kernels', and the device kernels that ran are the ones the dtype and
    width route to (torch.profiler's names)."""
    q, k, v, bias = _blocked_inputs(5, lq, lk, h, dh, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    scale = math.sqrt(dh)
    attn.reset_launches()
    want_fwd, want_bwd = _wide_kernels(dtype, h, dh, lq, lk)
    out = _ran_route(lambda: attn.attention_fwd(q, k, v, bias, h, scale),
                     want_fwd)
    got = _ran_route(lambda: attn.attention_bwd(q, k, v, bias, g, h, scale,
                                                True), want_bwd)
    assert (attn.launches, attn.wide_launches, attn.bwd_launches,
            attn.wide_bwd_launches) == (1, 1, 1, 1)
    assert _err(out, attn.attention_fwd_reference(q, k, v, bias, h,
                                                  scale)) <= tol
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, True)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _err(a, r) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,dh", [(32, 64), (2, 320), (8, 25), (8, 64)])
def test_wide_attention_bwd_is_bitwise_deterministic(cuda, dtype, h, dh):
    """Two wide K2 calls, and one with dbias, give the same dq, dk, dv
    (at 2 heads of 320 in bf16, the chunked kernels; at the widened path's
    8 heads of 25 and of 64 in bf16, the tensor-core wide kernels; in f32
    the tiled kernels)."""
    q, k, v, bias = _inputs(5, 16, 31, 31, h, dh, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)).to(dtype)
    scale = math.sqrt(dh)
    calls = [attn.attention_bwd(q, k, v, bias, g, h, scale, dbias)[:3]
             for dbias in (False, False, True)]
    torch.cuda.synchronize()
    for other in calls[1:]:
        assert all(torch.equal(a, b) for a, b in zip(calls[0], other))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("h,dh,n,lq,lk", [(1, 512, 64, 32, 32),
                                          (2, 320, 64, 31, 31),
                                          (2, 320, 64, 31, 32),
                                          (1, 512, 3, 70, 45),
                                          (2, 264, 16, 31, 32),
                                          (1, 1024, 8, 32, 32),
                                          (2, 320, 8, 1, 1),
                                          (1, 512, 8, 33, 33),
                                          (1, 320, 4, 128, 128),
                                          (1, 300, 64, 31, 31),
                                          (3, 300, 4, 40, 33)])
def test_attention_past_256_wide_heads_matches_plain_version(
        cuda, dtype, tol, h, dh, n, lq, lk):
    """K1 and K2 at heads wider than 256 (bf16: the tensor-core chunked
    kernels, the logits' k-steps split over warps, 512 output columns a
    K1 block and 128 a K2 block; f32: the tiled kernels, a head walked in
    chunks of 64 or 128 columns) at the train path's N = 64, at Dh =
    264 (off the mma k-step), 300 (off the 16-byte staging step) and 1,024
    (two K1 column groups), at one query and key and past 32 of them (two
    passes over the key tiles), with fully blocked rows: the forward, dq,
    dk and
    dv against the plain versions within the tolerances of chip_smoke.py,
    dbias within them times its largest value (dbias sums p (dp -
    rowsum), dp a dot of Dh N(0, 1) products: at Dh = 512 |dp| reaches
    ~90, where an f32 ulp is ~1e-5); every launch counted as the wide
    kernels'."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, dtype, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(8)).to(dtype)
    scale = math.sqrt(dh)
    attn.reset_launches()
    out = attn.fused_attention(q, k, v, bias, h, scale)
    got = attn.attention_bwd(q, k, v, bias, g, h, scale, True)
    torch.cuda.synchronize()
    assert (attn.launches, attn.wide_launches, attn.bwd_launches,
            attn.wide_bwd_launches) == (1, 1, 1, 1)
    assert _err(out, attn.attention_fwd_reference(q, k, v, bias, h,
                                                  scale)) <= tol
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, True)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert _err(a, r, relative=name == "dbias") <= tol, name


@pytest.mark.parametrize("h,dh,lq,lk", [(1, 512, 32, 32), (2, 320, 31, 31),
                                        (2, 320, 31, 32), (1, 300, 31, 31),
                                        (2, 320, 70, 45)])
def test_chunked_bf16_k2_is_bitwise_deterministic(cuda, h, dh, lq, lk):
    """The bf16 K2 past 256-wide heads (csrc/attention_chunked.cu) at the
    wide-heads path's shapes, off the staging step and past 32: two calls
    give the same dq, dk, dv bits, and so does a call with dbias (whose
    dbias is its plain version's within 3.2e-2 of its largest value); its
    device kernels are the chunked tensor-core ones."""
    q, k, v, bias = _blocked_inputs(8, lq, lk, h, dh, torch.bfloat16, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(9)).to(
                        torch.bfloat16)
    scale = math.sqrt(dh)
    calls = []
    for dbias in (False, False, True):
        got = _ran_route(lambda d=dbias: attn.attention_bwd(
            q, k, v, bias, g, h, scale, d),
            _wide_kernels(torch.bfloat16, h, dh, lq, lk)[1]
            [:None if dbias else -1])
        calls.append(got)
    for other in calls[1:]:
        assert all(torch.equal(a, b) for a, b in zip(calls[0][:3],
                                                     other[:3]))
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, True)
    assert _err(calls[2][3], want[3], relative=True) <= 3.2e-2


def test_tensor_core_wrappers_raise_instead_of_falling_back(cuda,
                                                            monkeypatch):
    """When the bf16 wide K3 (csrc/ce_wide_fwd.cu) or the chunked K2
    reports a failed launch, the wrapper raises and counts nothing: no
    fall-back to the plain versions or to the CUDA-core kernels."""
    h, W, b, labels, _ = _ce_inputs(cuda, torch.bfloat16, 64, 200, 300)
    ce._bind_wide_fwd()
    monkeypatch.setitem(ce._BOUND, (ce.KERNEL_WIDE_FWD, torch.bfloat16),
                        lambda *args: 1)
    ce.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ce.ce_fwd(h, W, b, labels)
    assert ce.fwd_launches == 0
    q, k, v, bias = _inputs(3, 4, 31, 31, 2, 320, torch.bfloat16, cuda)
    attn._bind_tensor_core(attn.KERNEL_CHUNKED, attn.KERNEL_BWD)
    monkeypatch.setitem(attn._BOUND, (attn.KERNEL_CHUNKED, attn.KERNEL_BWD),
                        lambda *args: 1)
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_bwd(q, k, v, bias, q, 2, 16.0, False)
    assert attn.bwd_launches == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,v", [(100, 200, 1000), (1984, 512, 22234),
                                   (70, 12, 300), (64, 264, 129),
                                   (1984, 200, 22234), (300, 520, 3000),
                                   (1984, 640, 22234)])
def test_wide_ce_kernels_match_plain_versions(cuda, dtype, tol, n, d, v):
    """K3 and K4 past D = 256 and off the tuned steps (D streamed in
    chunks, the last one ragged), through the wide kernels (bf16 K3 and K4
    on the tensor cores: D = 12 from zero-padded copies, 200, 512 and 640
    (K4 in one block), 520 too): ce and lse
    absolute, dh, dW and db relative to the largest reference value and
    on the softmax part (tol 1e-3 f32, 2e-3 bf16, as chip_smoke.py's), and
    from K3's lse relative to the largest reference value; the dh-only
    mode's dh bitwise the full mode's; two calls of each bitwise equal.
    Every f32 call runs the tiled kernels (csrc/ce_fwd_tiled.cu,
    csrc/ce_bwd_tiled.cu), D = 200 too: a tuned width (a multiple of 8 up
    to 256), so not counted as wide."""
    _wide_ce_check(cuda, dtype, tol, n, d, v)


@pytest.mark.parametrize("n,d,v", [(130, 1000, 2000), (200, 2048, 1500),
                                   (64, 4104, 200), (64, 5128, 200)])
def test_wide_bf16_ce_kernels_match_plain_versions_past_640(cuda, n, d, v):
    """The checks above in bf16 at the widths past the wide-heads path's:
    K4 on the tensor cores over clusters of 2 (D = 1,000), 4 (2,048: past
    a whole tile of 64 rows in shared memory, 256 KB) and 7 (4,104, the
    last block with fewer slabs) blocks, and at 5,128, past the clusters'
    5,120, on the tiled CUDA-core kernels (csrc/ce_bwd_tiled.cu). K4 is
    given the plain version's lse, so that the checks hold K4 alone:
    logits of these inputs reach 40 (sums of
    1,000 and more products), where the wide K3's lse is a few 1e-5 off
    the plain version's and shifts every P of its row; K4 given K3's lse
    is held relative to the largest reference value. (In f32 the wide
    K3's ce is 5e-5 off at D = 1,000, beyond the 1e-5 that holds it at
    the widths above.)"""
    _wide_ce_check(cuda, torch.bfloat16, 3.2e-2, n, d, v)


def _wide_ce_check(cuda, dtype, tol, n, d, v):
    """K3 against its plain version; K4 against its plain version on the
    same inputs, the plain version's lse (as chip_smoke.py gives both),
    relative to the largest reference value and on the softmax part; and
    the chain that training runs, K4 given K3's lse, relative to the
    largest reference value (as the tuned widths' test holds it) and, in
    f32, on the softmax part too. In bf16 the softmax-part gate holds only
    where K4's lse is the plain version's to its last bits: near a P close
    to 1 (W ~ N(0, 0.3^2) here) a K3 whose lse differs there (its sums in
    another order; on the tensor cores up to 1.1e-5 at D = 640) flips the
    bf16 rounding of that P and moves dh by one bf16 step of it, 3.7e-3 of
    the softmax part at D = 512."""
    wide = int(ce.is_wide(dtype, d))
    h, W, b, labels, g = _ce_inputs(cuda, dtype, n, d, v)
    ce.reset_launches()
    cel, lse = ce.ce_fwd(h, W, b, labels)
    ref_ce, ref_lse = ce.ce_fwd_reference(h, W, b, labels)
    grads = ce.ce_bwd(h, W, b, labels, ref_lse, g)
    dh_only = ce.ce_bwd(h, W, b, labels, ref_lse, g, dh_only=True)
    again = ce.ce_bwd(h, W, b, labels, ref_lse, g)
    chained = ce.ce_bwd(h, W, b, labels, lse, g)
    fwd_again = ce.ce_fwd(h, W, b, labels)
    ref = ce.ce_bwd_reference(h, W, b, labels, ref_lse, g)
    part = ce.ce_bwd_reference(h, W, b, labels, ref_lse, g, True)
    torch.cuda.synchronize()
    assert (ce.fwd_launches, ce.bwd_launches, ce.wide_fwd_launches,
            ce.wide_bwd_launches, ce.bwd_dh_only_launches) == \
        (2, 4, 2 * wide, 4 * wide, 1)
    assert torch.equal(cel, fwd_again[0]) and torch.equal(lse, fwd_again[1])
    assert _err(cel, ref_ce) <= tol and _err(lse, ref_lse) <= tol
    soft = {torch.float32: 1e-3, torch.bfloat16: 2e-3}[dtype]
    for name, a, r, c, x in zip(("dh", "dW", "db"), grads, ref, part,
                                chained):
        assert a.shape == r.shape and a.dtype == torch.float32, name
        assert _err(a, r, relative=True) <= tol, name
        assert (a - r).abs().max().item() <= soft * c.abs().max().item(), \
            name
        assert x.shape == r.shape and x.dtype == torch.float32, name
        assert _err(x, r, relative=True) <= tol, f"{name} from K3's lse"
        assert dtype == torch.bfloat16 or (x - r).abs().max().item() <= \
            soft * c.abs().max().item(), f"{name} from K3's lse"
    assert dh_only[1] is None and torch.equal(dh_only[0], grads[0])
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.parametrize("dp", [8, 16, 200, 264, 512, 520, 640, 768, 1000,
                                2048, 4104, 5120, 5128])
def test_wide_bwd_plan_comes_from_the_library(cuda, dp):
    """`ce.wide_bwd_plan`, which the wrapper cuts the vocab by, equals the
    bf16 wide K4 library's own plan (slabs, cluster, slabs a block, NC,
    stages, shared memory), and both refuse past 5,120 columns; the
    library's shared memory fits the card."""
    want = ce.wide_bwd_plan(dp)
    if want is None:
        with pytest.raises(ValueError):
            ce.library_plan(dp)
        return
    assert ce.library_plan(dp) == want
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert want.smem <= limit


@pytest.mark.parametrize("dp", [8, 16, 200, 264, 512, 640, 1000, 5128])
def test_wide_fwd_plan_and_tiling_come_from_the_library(cuda, dp):
    """`ce.wide_fwd_plan` (k-chunks, stages, shared memory) equals the bf16
    wide K3 library's own plan, and the tiling the wrapper cuts the vocab
    by is the library's: 64 rows of h, 128 of W, and the blocks of its
    kernel that fit an SM (three: one block's softmax under the others'
    products) at every width; its splits' blocks fit one wave at the
    training shape."""
    want = ce.wide_fwd_plan(dp)
    assert ce.library_plan(dp, ce.KERNEL_WIDE_FWD) == want
    rows, tile_v, blocks = ce.tiling(ce.KERNEL_WIDE_FWD, torch.bfloat16, dp,
                                     torch.device(cuda))
    assert (rows, tile_v, blocks) == (64, ce.FWD_TILE, 3)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = ce.vocab_splits(1984, 22234, sms, rows, tile_v, blocks)
    assert 31 * splits <= blocks * sms


def _wide_topk_inputs(device, dtype, n, d, v, seed, mode):
    gen = torch.Generator(device).manual_seed(seed)
    if mode == "tie":
        h = torch.ones((n, d), device=device, dtype=dtype)
        W = torch.zeros((v, d), device=device, dtype=dtype)
        b = torch.zeros(v, device=device)
        b[[v - 3, 7, v // 2, 130, 64, 5000 % v]] = 1.0
        return h, W, b
    # dyadic values: every logit exact in f32 whatever the order of the
    # sums, many exact ties (h at 8, W at 2 over d / 16 keeps them exact)
    return (_dyadic(gen, (n, d), 8, dtype, device),
            _dyadic(gen, (v, d), 2, dtype, device),
            _dyadic(gen, (v,), 8, torch.float32, device)
            - (3.0 if mode == "negative" else 0.0))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("n,d,k", [(256, 128, 9), (256, 128, 16),
                                   (100, 128, 64), (256, 200, 4),
                                   (64, 512, 8), (4864, 128, 9),
                                   (576, 200, 9)])
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
def test_wide_topk_matches_plain_version(cuda, dtype, tol, n, d, k, mode):
    """K6 past k = 8 and at D past 256 (the wide kernels: per-split lists,
    then a merge) and at D = 200 (the tuned kernel) at V = 22,234, with exact ties, with
    every logit below 0 and with few distinct maxima: the plain version's
    indices, vals and lse."""
    h, W, b = _wide_topk_inputs(cuda, dtype, n, d, 22234, 3, mode)
    topk.reset_launches()
    got = topk.topk_logits(h, W, b, k)
    want = topk.topk_logits_reference(h, W, b, k)
    again = topk.topk_logits(h, W, b, k)
    torch.cuda.synchronize()
    # D = 200 is a multiple of the tuned kernel's 8: at k <= 8 it stays
    assert (topk.launches, topk.wide_launches) == (2,
                                                   2 * topk.is_wide(d, k))
    assert got[0].shape == (n, k) and got[1].dtype == torch.int32
    assert int(got[1].max()) < 22234
    _topk_equal(got, want, tol)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _device_kernels(names, fragment):
    """The profiled kernel names that hold `fragment`."""
    return sorted(name for name in names if fragment in name)


@pytest.mark.parametrize("n,d,k", [(256, 128, 4), (4864, 128, 4),
                                   (256, 128, 1), (256, 128, 8),
                                   (256, 200, 4), (100, 8, 3),
                                   (130, 256, 2)])
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
def test_tiled_f32_topk_matches_plain_version(cuda, n, d, k, mode):
    """The f32 K6 at k up to 8 and D a multiple of 8 up to 256 on the 128 x
    128 tile (csrc/topk.cu `topk_tiled_kernel`): at the beam rows of
    chip_smoke.py (N = 256 and the sweep's 4,864 at D = 128, k = 4; k = 1
    and 8; D = 200) and ragged rows (N = 100 and 130 at D = 8 and 256),
    with exact ties, every logit equal to its bias and every logit below
    0: the device ran the tiled kernel and the splits' merge and no other
    K6 kernel (torch.profiler's names), the call counted as a tiled
    launch; the plain version's indices, vals and lse within 1e-5; two
    calls give the same bits."""
    h, W, b = _wide_topk_inputs(cuda, torch.float32, n, d, 22234, 5, mode)
    assert not topk.is_wide(d, k)
    topk.reset_launches()

    def check(names):
        assert _device_kernels(names, "topk") == sorted(
            _device_kernels(names, "topk_tiled_kernel")
            + _device_kernels(names, "topk_combine_kernel"))
        assert len(_device_kernels(names, "topk_tiled_kernel")) == 1

    got = _ran_checked(lambda: topk.topk_logits(h, W, b, k), check)
    assert (topk.launches, topk.tiled_launches, topk.wide_launches) == \
        (1, 1, 0)
    want = topk.topk_logits_reference(h, W, b, k)
    _topk_equal(got, want, 1e-5)
    again = topk.topk_logits(h, W, b, k)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("n,d,k", [(576, 200, 9), (256, 128, 9),
                                   (256, 128, 16), (256, 128, 64),
                                   (256, 512, 4), (256, 512, 64),
                                   (100, 25, 9), (1, 200, 16),
                                   (64, 1000, 33), (4864, 128, 9)])
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
def test_tensor_core_wide_topk_matches_plain_version(cuda, n, d, k, mode):
    """The bf16 K6 calls the tuned kernel does not take, up to k = 64
    (csrc/topk_wide_mma.cu: the wide beam's 576 x 200 at k = 9, k = 16 and
    64, D = 512, D = 25 off the TMA's 8 columns, one row, k = 33, the beam
    sweep's rows), with exact ties, every logit below 0 and few distinct
    maxima at V = 22,234: the plain version's indices, vals and lse within
    3.2e-2; the device ran the tensor-core kernel and its split merge
    (torch.profiler's names), each call counted as a wide launch, two calls
    the same bits."""
    h, W, b = _wide_topk_inputs(cuda, torch.bfloat16, n, d, 22234, 3, mode)
    assert topk.uses_tensor_core(torch.bfloat16, d, k, 22234)
    topk.reset_launches()

    def check(names):
        assert _device_kernels(names, "topk") == sorted(
            _device_kernels(names, "topk_wide_mma"))
        assert len(_device_kernels(names, "topk_wide_mma_kernel<")) == 1
        assert len(_device_kernels(names, "topk_wide_mma_merge_kernel")) \
            == 1

    got = _ran_checked(lambda: topk.topk_logits(h, W, b, k), check)
    again = topk.topk_logits(h, W, b, k)
    assert (topk.launches, topk.wide_launches) == (2, 2)
    want = topk.topk_logits_reference(h, W, b, k)
    assert got[0].shape == (n, k) and got[1].dtype == torch.int32
    _topk_equal(got, want, 3.2e-2)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("k,blocks", [(1, 3), (9, 3), (16, 3), (17, 2),
                                      (32, 2), (33, 2), (64, 2)])
def test_wide_mma_topk_plan_and_tiling_come_from_the_library(cuda, k,
                                                             blocks):
    """`topk.wide_mma_plan` (list length, stages, shared memory) equals the
    tensor-core wide K6 library's own plan, fits a block of the card, and
    the tiling the wrapper cuts the vocab by is the library's: 64 rows of
    h, 128 of W and the blocks an SM the design counts on (three with
    lists of 16, two with longer ones); past k = 64 the library
    refuses."""
    want = topk.wide_mma_plan(k)
    assert topk.library_plan(k) == want
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert want.smem <= limit
    assert ce.tiling(topk.KERNEL_WIDE_MMA, torch.bfloat16, k,
                     torch.device(cuda)) == (64, topk.MMA_TILE, blocks)
    with pytest.raises(ValueError):
        topk.library_plan(topk.K_LIST + 1)


RESIDENT_SHAPES = [(64, 128, 128, 8, 16), (64, 63, 64, 8, 16),
                   (64, 64, 63, 8, 16), (16, 33, 33, 8, 16),
                   (16, 128, 31, 16, 8), (8, 20, 100, 4, 32),
                   (16, 100, 70, 8, 16), (4, 127, 128, 8, 16),
                   (3, 128, 128, 2, 32), (5, 97, 40, 1, 8)]


@pytest.mark.parametrize("n,lq,lk,h,dh", RESIDENT_SHAPES)
@pytest.mark.parametrize("dbias", [False, True])
def test_resident_k2_matches_plain_version(cuda, n, lq, lk, h, dh, dbias):
    """The bf16 K2 past 32 queries or keys up to 128 of both
    (csrc/attention_bwd_resident.cu), with fully blocked rows, at every
    head width and a few head counts, lengths off 16 and Lq != Lk: dq, dk,
    dv (and dbias) within 3.2e-2 of the plain version; the device ran the
    resident kernel (and the dbias sum over heads), counted as one K2
    launch; two calls, and a call with dbias, give the same dq, dk, dv
    bits."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, torch.bfloat16, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(8)).to(
                        torch.bfloat16)
    scale = math.sqrt(dh)
    assert attn.uses_resident(torch.bfloat16, lq, lk, h, dh)
    attn.reset_launches()
    got = _ran_route(lambda: attn.attention_bwd(q, k, v, bias, g, h, scale,
                                                dbias),
                     ["attention_bwd_resident_kernel"]
                     + (["mma_dbias_kernel"] if dbias else []))
    assert (attn.bwd_launches, attn.wide_bwd_launches) == (1, 0)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, dbias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        if r is None:
            assert a is None
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _err(a, r) <= 3.2e-2, name
    for other in (attn.attention_bwd(q, k, v, bias, g, h, scale, dbias),
                  attn.attention_bwd(q, k, v, bias, g, h, scale,
                                     not dbias)):
        assert all(torch.equal(a, c) for a, c in zip(got[:3], other[:3]))


@pytest.mark.parametrize("lq,lk", [(33, 33), (64, 64), (128, 128), (63, 64),
                                   (128, 33), (20, 100), (1, 128)])
@pytest.mark.parametrize("dh", [8, 16, 32])
def test_resident_plan_comes_from_the_library(cuda, lq, lk, dh):
    """The resident K2 block's shared memory and threads
    (`attn.resident_smem_bytes`, `attn.resident_threads`) are the
    library's own, the shared memory fits a block of the card and at
    least one block fits an SM (one at 128 x 128, as designed)."""
    smem, threads, blocks = attn.resident_plan(lq, lk, dh)
    assert (smem, threads) == (attn.resident_smem_bytes(lq, lk, dh),
                               attn.resident_threads(lq, lk))
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert smem <= limit and blocks >= 1
    if (lq, lk) == (128, 128):
        assert blocks == 1


def test_resident_and_wide_mma_wrappers_raise_instead_of_falling_back(
        cuda, monkeypatch):
    """When the tensor-core wide K6 or the resident K2 reports a failed
    launch, the wrapper raises and counts nothing: no fall-back to the
    plain versions or to the older kernels."""
    h, W, b = _wide_topk_inputs(cuda, torch.bfloat16, 64, 200, 3000, 3,
                                "dyadic")
    topk._bind_wide_mma()
    monkeypatch.setitem(topk._BOUND, (topk.KERNEL_WIDE_MMA, torch.bfloat16),
                        lambda *args: 1)
    topk.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        topk.topk_logits(h, W, b, 9)
    assert topk.launches == 0
    q, k, v, bias = _inputs(3, 4, 64, 64, 8, 16, torch.bfloat16, cuda)
    attn._bind_resident()
    monkeypatch.setitem(attn._BOUND, (attn.KERNEL_RESIDENT, attn.KERNEL_BWD),
                        lambda *args: 1)
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_bwd(q, k, v, bias, q, 8, 4.0, False)
    assert attn.bwd_launches == 0


# the bf16 K6 past k = 64: csrc/topk_wide_mma.cu's long path (N = 64 x 4;
# the beam path's N = 64 x k at D = 128 for beams of 100, 128 and 256, and
# N = 1,024, where the partial kernel's splits are raised to hold 2 k keys
# and cut again so that each owns a vocab tile)
LONG_LIST_SHAPES = [(256, d, k) for k in (65, 100, 128, 256)
                    for d in (128, 200, 512)] + [
                        (6400, 128, k) for k in (100, 128, 256)] + [
                        (1024, 200, 256)]


@pytest.mark.parametrize("n,d,k", LONG_LIST_SHAPES)
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
def test_long_list_topk_matches_plain_version(cuda, n, d, k, mode):
    """The bf16 K6 past k = 64 up to 256 (the tensor-core wide kernel's
    long path) at D = 128, 200 and 512 and at the beam-100 path's rows,
    with exact ties (six equal maxima, then zeros whose keys differ by
    index alone: thousands of candidates reach a row's bound), every logit
    below 0 and dyadic logits at
    V = 22,234: the plain version's indices, vals and lse within 3.2e-2;
    the device ran the long path's kernels (lists of 16, the threshold,
    the emission, the select, the fallback: torch.profiler's names), the
    call counted as a wide and a long-path launch; two calls give the same
    bits."""
    h, W, b = _wide_topk_inputs(cuda, torch.bfloat16, n, d, 22234, 5, mode)
    assert topk.uses_long_list(torch.bfloat16, d, k, 22234)
    topk.reset_launches()

    def check(names):
        assert len(_device_kernels(names, "topk_wide_mma_kernel<16>")) == 1
        for kernel in ("threshold", "emit", "final", "fallback"):
            assert len(_device_kernels(
                names, f"topk_long_{kernel}_kernel")) == 1, kernel
        assert not _device_kernels(names, "topk_wide_mma_merge_kernel")

    got = _ran_checked(lambda: topk.topk_logits(h, W, b, k), check)
    assert (topk.launches, topk.wide_launches,
            topk.long_list_launches) == (1, 1, 1)
    want = topk.topk_logits_reference(h, W, b, k)
    assert got[0].shape == (n, k) and got[1].dtype == torch.int32
    _topk_equal(got, want, 3.2e-2)
    again = topk.topk_logits(h, W, b, k)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("n,k", [(512, 256), (6400, 100)])
def test_long_path_fallback_matches_plain_version(cuda, n, k):
    """Every logit equal (keys that differ by index alone): a row's bound
    lets through more candidates than its slots hold (a row's 16 best of
    each split are its lowest indices), so every row takes the fallback
    (its logits on the CUDA cores and the same select): the plain
    version's indices (0..k-1), vals and lse."""
    h = torch.ones((n, 200), device=cuda, dtype=torch.bfloat16)
    W = torch.zeros((22234, 200), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(22234, device=cuda)
    got = topk.topk_logits(h, W, b, k)
    want = topk.topk_logits_reference(h, W, b, k)
    _topk_equal(got, want, 3.2e-2)
    assert torch.equal(got[1][0].long(), torch.arange(k, device=cuda))


@pytest.mark.parametrize("k", [65, 100, 128, 129, 256])
def test_long_path_plan_comes_from_the_library(cuda, k):
    """Past k = 64: `topk.wide_mma_plan` equals the library's plan (the
    long path's partial kernel, lists of 16), fits a block of the card at
    three blocks an SM (the library's tiling), and the emission kernel
    takes at least as many (its tiling, which `topk.long_plan` reads)."""
    want = topk.wide_mma_plan(k)
    assert topk.library_plan(k) == want
    assert want.list_length == topk.SELECT_LIST
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert want.smem <= limit
    assert ce.tiling(topk.KERNEL_WIDE_MMA, torch.bfloat16, k,
                     torch.device(cuda)) == (64, topk.MMA_TILE, 3)
    rows, vocab_rows, blocks = topk.emit_tiling(torch.device(cuda))
    assert (rows, vocab_rows) == (64, topk.MMA_TILE) and blocks >= 3


# K6 on the select kernels (csrc/topk_select.cu): every f32 call of the
# wide kernels (the wide beam's 576 x 200 at k = 9, k = 16 to 1,000 at
# D = 200 and 512, k = V, D = 25, one row past 256), and bf16 past
# k = 256 or past the long path's V = 25,000 (k = 1,000, V = 32,000 at
# k = 65 and 100, k = V, D = 25 off the TMA's 8 columns)
SELECT_SHAPES = [
    (torch.float32, 576, 200, 22234, 9), (torch.float32, 256, 200, 22234, 16),
    (torch.float32, 256, 512, 22234, 64),
    (torch.float32, 256, 200, 22234, 1000),
    (torch.float32, 256, 512, 22234, 1000),
    (torch.float32, 64, 200, 22234, 22234), (torch.float32, 100, 25, 1000, 17),
    (torch.float32, 1, 200, 22234, 257),
    (torch.bfloat16, 256, 200, 22234, 1000),
    (torch.bfloat16, 256, 128, 32000, 100),
    (torch.bfloat16, 64, 200, 32000, 65),
    (torch.bfloat16, 64, 128, 22234, 22234),
    (torch.bfloat16, 100, 25, 1000, 300),
    (torch.bfloat16, 256, 512, 22234, 257)]


@pytest.mark.parametrize("dtype,n,d,v,k", SELECT_SHAPES)
@pytest.mark.parametrize("mode", ["dyadic", "tie", "negative"])
def test_select_topk_matches_plain_version(cuda, dtype, n, d, v, k, mode):
    """K6 on the select kernels (the logits once into an (N, V) workspace,
    f32 on the CUDA cores and bf16 on the tensor cores, then a block per
    row's radix select and sort) with exact ties (a few equal maxima, then
    keys that differ by index alone: k = V sorts them all), every logit
    below 0 and dyadic logits: the plain version's indices, vals and lse
    within the tolerances of chip_smoke.py; the device ran the select
    kernels and no other K6 kernel (torch.profiler's names), the call
    counted as a wide and a select launch; two calls give the same bits."""
    h, W, b = _wide_topk_inputs(cuda, dtype, n, d, v, 7, mode)
    assert topk.uses_select(dtype, d, k, v)
    topk.reset_launches()
    logits = "mma" if dtype == torch.bfloat16 else "f32"

    def check(names):
        assert len(_device_kernels(
            names, f"topk_select_logits_{logits}")) == 1
        assert len(_device_kernels(names, "topk_select_kernel")) == 1
        assert _device_kernels(names, "topk") == _device_kernels(
            names, "topk_select")

    got = _ran_checked(lambda: topk.topk_logits(h, W, b, k), check)
    assert (topk.launches, topk.wide_launches, topk.select_launches,
            topk.long_list_launches) == (1, 1, 1, 0)
    want = topk.topk_logits_reference(h, W, b, k)
    assert got[0].shape == (n, k) and got[1].dtype == torch.int32
    _topk_equal(got, want, 1e-5 if dtype == torch.float32 else 3.2e-2)
    again = topk.topk_logits(h, W, b, k)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_topk_keys_past_shared_memory(cuda, dtype):
    """k = 30,000 of V = 32,000: a row's keys pass what a block's shared
    memory holds (`topk.select_keys_spill`), so the select sorts them in
    the caller's scratch row: the indices of a stable descending sort of
    the plain logits (ties to the lowest index; dyadic logits, exact in
    f32), their values, and lse within the tolerance."""
    n, d, v, k = 4, 64, 32000, 30000
    limit = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    assert topk.select_keys_spill(k, limit)
    assert not topk.select_keys_spill(22234, limit)
    h, W, b = _wide_topk_inputs(cuda, dtype, n, d, v, 11, "dyadic")
    vals, idx, lse = topk.topk_logits(h, W, b, k)
    logits = h.float() @ W.float().t() + b
    want_vals, want_idx = torch.sort(logits, dim=1, descending=True,
                                     stable=True)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), want_idx[:, :k])
    assert torch.equal(vals, want_vals[:, :k])
    tol = 1e-5 if dtype == torch.float32 else 3.2e-2
    assert _err(lse, torch.logsumexp(logits, dim=1)) <= tol


def test_select_and_tiled_wrappers_raise_instead_of_falling_back(
        cuda, monkeypatch):
    """When the select K6 or the tiled K1 reports a failed launch, the
    wrapper raises and counts nothing: no fall-back to the plain versions
    or to the older kernels."""
    h, W, b = _wide_topk_inputs(cuda, torch.float32, 64, 200, 3000, 3,
                                "dyadic")
    topk._bind_select(torch.float32)
    monkeypatch.setitem(topk._BOUND, (topk.KERNEL_SELECT, torch.float32),
                        lambda *args: 1)
    topk.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        topk.topk_logits(h, W, b, 9)
    assert topk.launches == 0
    q, k, v, bias = _inputs(3, 4, 31, 31, 8, 25, torch.float32, cuda)
    size = attn._bind_tiled()[1]
    monkeypatch.setitem(attn._BOUND, (attn.KERNEL_TILED, attn.KERNEL),
                        (lambda *args: 1, size))
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_fwd(q, k, v, bias, 8, 5.0)
    assert attn.launches == 0


# the f32 K1 on the tiled kernel (csrc/attention_tiled.cu): the widened and
# wide-heads paths' shapes (8 x 64, 8 x 25, 32 x 16, one head of 512, 2 of
# 320, one of 300), heads of 5, 24, 128, 257 and 1,024, one query and key,
# past 32 of them, and keys past a block's shared memory (S in scratch)
TILED_SHAPES = [(8, 64, 64, 32, 32), (8, 25, 64, 31, 31),
                (8, 25, 64, 31, 32), (32, 16, 64, 31, 31),
                (8, 24, 64, 31, 31), (8, 128, 64, 31, 31),
                (1, 512, 64, 32, 32), (2, 320, 64, 31, 31),
                (2, 320, 64, 31, 32), (1, 300, 64, 31, 31),
                (3, 5, 4, 70, 97), (1, 1024, 8, 32, 32), (2, 320, 8, 1, 1),
                (1, 257, 4, 128, 128), (2, 64, 1, 20, 7000)]


@pytest.mark.parametrize("h,dh,n,lq,lk", TILED_SHAPES)
def test_tiled_attention_matches_plain_version(cuda, h, dh, n, lq, lk):
    """The f32 K1 at head widths and counts the tuned kernel does not take,
    with fully blocked rows: the plain version's output within 1e-5; the
    device ran the tiled kernel alone (torch.profiler's names,
    `_ran_route`), the call
    counted as a wide and a tiled launch; two calls give the same bits;
    past about 3,000 keys the logits go to a scratch the wrapper sizes
    from the library."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, torch.float32, cuda)
    scale = math.sqrt(dh)
    assert attn.uses_tiled(torch.float32, h, dh)
    assert (attn.tiled_scratch_floats(n, lq, lk, h, dh) > 0) == (lk > 3000)
    attn.reset_launches()
    out = _ran_route(lambda: attn.attention_fwd(q, k, v, bias, h, scale),
                     ["attention_fwd_tiled_kernel"])
    assert (attn.launches, attn.wide_launches, attn.tiled_launches) == (
        1, 1, 1)
    assert _err(out, attn.attention_fwd_reference(q, k, v, bias, h,
                                                  scale)) <= 1e-5
    again = attn.attention_fwd(q, k, v, bias, h, scale)
    assert torch.equal(out, again)


# the f32 K2 on the tiled kernels (csrc/attention_bwd_tiled.cu): the kernel
# rows' shapes (the widened and wide-heads paths', 8 heads of 24 and 128,
# one head of 300), heads of 5, 257 and 1,024, one query and key, past 32
# of them, and keys past a block's shared memory (S and dP formed in the
# scratch)
TILED_BWD_SHAPES = [(8, 64, 64, 32, 32), (8, 25, 64, 31, 31),
                    (8, 25, 64, 31, 32), (32, 16, 64, 31, 31),
                    (8, 24, 64, 31, 31), (8, 128, 64, 31, 31),
                    (1, 512, 64, 32, 32), (2, 320, 64, 31, 31),
                    (2, 320, 64, 31, 32), (1, 300, 64, 31, 31),
                    (3, 5, 4, 70, 97), (1, 1024, 8, 32, 32),
                    (2, 320, 8, 1, 1), (1, 257, 4, 128, 128),
                    (1, 64, 2, 20, 3000)]


@pytest.mark.parametrize("h,dh,n,lq,lk", TILED_BWD_SHAPES)
@pytest.mark.parametrize("dbias", [False, True])
def test_tiled_attention_bwd_matches_plain_version(cuda, h, dh, n, lq, lk,
                                                   dbias):
    """The f32 K2 at head widths and counts the tuned kernel does not take,
    with fully blocked rows, with and without dbias: dq, dk and dv within
    1e-5 of the plain version's, dbias within 1e-5 of its largest value
    (dbias sums p (dp - rowsum) over the heads, dp a dot of Dh N(0, 1)
    products: at Dh = 512 |dp| reaches ~90); the device ran the tiled
    kernels alone (torch.profiler's names, `_ran_route`: the dq kernel, the
    dk/dv kernel and, with dbias, the sum over heads); the call counted as
    a wide and a tiled launch; two calls give the same bits, and dq, dk, dv
    are those of the call with the other dbias setting."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, torch.float32, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(10))
    scale = math.sqrt(dh)
    assert attn.uses_tiled(torch.float32, h, dh)
    attn.reset_launches()
    got = _ran_route(lambda: attn.attention_bwd(q, k, v, bias, g, h, scale,
                                                dbias),
                     _wide_kernels(torch.float32, h, dh, lq, lk)[1]
                     [:None if dbias else -1])
    assert (attn.bwd_launches, attn.wide_bwd_launches,
            attn.tiled_bwd_launches, attn.launches) == (1, 1, 1, 0)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, dbias)
    assert (got[3] is None) == (not dbias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        if r is None:
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _err(a, r, relative=name == "dbias") <= 1e-5, name
    again = attn.attention_bwd(q, k, v, bias, g, h, scale, dbias)
    other = attn.attention_bwd(q, k, v, bias, g, h, scale, not dbias)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], other[:3]))
    assert not dbias or torch.equal(got[3], again[3])


def _tiled_ce_kernels(n, d, v, dh_only):
    """The device kernels the tiled K4 launches (csrc/ce_bwd_tiled.cu): P,
    the dh product, (not in the dh-only mode) the dW product, and the sum
    of the splits' partials where the dh product has more than one vocab
    split or the dW product more than one row split."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = ce.tiling(ce.KERNEL_BWD_TILED, torch.float32, d,
                       torch.device("cuda"))[2]
    splits = ce.tiled_splits(n, d, v, sms, blocks)
    dw_splits = 1 if dh_only else ce.tiled_dw_splits(n, d, v, sms, blocks)
    return (["ce_bwd_tiled_p_kernel", "ce_bwd_tiled_dh_kernel"]
            + (["ce_bwd_tiled_sum_kernel"] if max(splits, dw_splits) > 1
               else [])
            + ([] if dh_only else ["ce_bwd_tiled_dw_kernel"]))


# the f32 K3 and K4 on the tiled kernels: the kernel rows' widths (the
# main model's D = 128, the widened decoder's 200, the wide-heads path's
# 640, 512, 264 and 136) and ragged rows, vocab and widths (D off 4
# columns, less than one chunk of 16, N and V off the 128-row tiles, one
# row of one vocab entry)
TILED_CE_SHAPES = [(1984, 128, 22234), (1984, 200, 22234), (1984, 640, 22234),
                   (1984, 512, 22234), (1984, 264, 22234), (1984, 136, 22234),
                   (100, 8, 1000), (70, 12, 300), (300, 520, 3000),
                   (129, 602, 257), (1, 3, 1)]


@pytest.mark.parametrize("n,d,v", TILED_CE_SHAPES)
@pytest.mark.parametrize("dh_only", [False, True])
def test_tiled_ce_bwd_matches_plain_version(cuda, n, d, v, dh_only):
    """Every f32 K4 on the tiled kernels (TILED_CE_SHAPES), in both modes,
    with rows of zero cotangent (every 16th from the 8th): dh, dW and db within 1e-5 of the plain
    version's largest value and on the softmax part within 1e-3 of that
    part's (chip_smoke.py's gates), the zero rows' dh exactly 0; the device
    ran the tiled kernels alone (torch.profiler's names, `_ran_route`); the
    call counted as a tiled launch, and as a wide one off the tuned widths;
    two calls give the same bits, and the dh-only mode's dh is the full
    mode's."""
    h, W, b, labels, g = _ce_inputs(cuda, torch.float32, n, d, v)
    g[7::16] = 0.0
    labels = labels.int()  # as the CE Function passes them: no cast kernel
    lse = ce.ce_fwd_reference(h, W, b, labels)[1]
    assert ce.uses_tiled_bwd(torch.float32, d)
    ce.reset_launches()
    got = _ran_route(lambda: ce.ce_bwd(h, W, b, labels, lse, g,
                                       dh_only=dh_only),
                     _tiled_ce_kernels(n, d, v, dh_only))
    assert (ce.bwd_launches, ce.wide_bwd_launches, ce.tiled_bwd_launches,
            ce.bwd_dh_only_launches) == (
                1, int(ce.is_wide(torch.float32, d)), 1, int(dh_only))
    assert torch.count_nonzero(got[0][g == 0]) == 0
    want = ce.ce_bwd_reference(h, W, b, labels, lse, g, dh_only=dh_only)
    part = ce.ce_bwd_reference(h, W, b, labels, lse, g, True, dh_only)
    for name, a, r, c in zip(("dh", "dW", "db"), got, want, part):
        if r is None:
            assert a is None, name
            continue
        assert a.shape == r.shape and a.dtype == torch.float32, name
        err = _err(a, r, relative=True)
        assert err <= 1e-5, (name, err)
        err = (a - r).abs().max().item() / c.abs().max().item()
        assert err <= 1e-3, (name, "softmax part", err)
    again = ce.ce_bwd(h, W, b, labels, lse, g, dh_only=dh_only)
    other = ce.ce_bwd(h, W, b, labels, lse, g, dh_only=not dh_only)
    assert all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))
    assert torch.equal(got[0], other[0])


@pytest.mark.parametrize("n,d,v", TILED_CE_SHAPES)
def test_tiled_ce_fwd_matches_plain_version(cuda, n, d, v):
    """Every f32 K3 on the tiled kernel (csrc/ce_fwd_tiled.cu) at
    TILED_CE_SHAPES: ce and lse within 1e-5 of the plain version's
    (chip_smoke.py's gate), relative to the largest reference value where
    it is past 1 (W ~ N(0, 0.3^2) here: at D = 602 ce reaches 32, whose f32
    step is 3.8e-6, and the kernel's sums over d run in another order than
    cuBLAS's); the device ran the partial kernel and the split merge alone
    (`_ran_route`); the call counted as a tiled launch, and as a wide one
    off the tuned widths; two calls give the same bits."""
    h, W, b, labels, _ = _ce_inputs(cuda, torch.float32, n, d, v)
    labels = labels.int()
    assert ce.uses_tiled_fwd(torch.float32, d)
    ce.reset_launches()
    got = _ran_route(lambda: ce.ce_fwd(h, W, b, labels),
                     ["ce_fwd_tiled_kernel", "ce_fwd_tiled_combine_kernel"])
    assert (ce.fwd_launches, ce.wide_fwd_launches, ce.tiled_fwd_launches) \
        == (1, int(ce.is_wide(torch.float32, d)), 1)
    want = ce.ce_fwd_reference(h, W, b, labels)
    for name, a, r in zip(("ce", "lse"), got, want):
        assert a.shape == r.shape and a.dtype == torch.float32, name
        tol = 1e-5 * max(1.0, r.abs().max().item())
        assert _err(a, r) <= tol, (name, _err(a, r), tol)
    again = ce.ce_fwd(h, W, b, labels)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_tiled_fwd_tiling_comes_from_the_library(cuda):
    """The tiled K3's library reports its 128 x 128 tiles and how many of
    its blocks fit an SM (two: 128 registers a thread); at the training
    path's shape its vocab splits each own tiles and their blocks fit one
    wave."""
    rows, cols, blocks = ce.tiling(ce.KERNEL_FWD_TILED, torch.float32, 128,
                                   torch.device(cuda))
    assert (rows, cols) == (ce.TILED_TILE, ce.TILED_TILE) and blocks == 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = ce.vocab_splits(1984, 22234, sms, rows, cols, blocks)
    assert 16 * splits <= blocks * sms
    assert all(a < b for a, b in ce.tiled_split_ranges(22234, splits))


def test_tiled_bwd_tiling_comes_from_the_library(cuda):
    """The tiled K4's library reports its 128 x 128 tiles and how many dh
    blocks fit an SM; at the wide-heads path's shape the dh product's
    splits each own vocab tiles and their blocks fit one wave."""
    rows, cols, blocks = ce.tiling(ce.KERNEL_BWD_TILED, torch.float32, 640,
                                   torch.device(cuda))
    assert (rows, cols) == (ce.TILED_TILE, ce.TILED_TILE) and blocks >= 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = ce.tiled_splits(1984, 640, 22234, sms, blocks)
    assert splits == 1 or 16 * 5 * splits <= blocks * sms
    assert all(a < b for a, b in ce.tiled_split_ranges(22234, splits))


def test_tiled_bwd_wrappers_raise_instead_of_falling_back(cuda,
                                                          monkeypatch):
    """When the tiled K2, the tiled K4 or the tiled K3 reports a failed
    launch, the wrapper raises and counts nothing: no fall-back to the
    plain versions or to the older kernels."""
    q, k, v, bias = _inputs(3, 4, 31, 31, 8, 25, torch.float32, cuda)
    attn._bind_tiled_bwd()
    monkeypatch.setitem(attn._BOUND, (attn.KERNEL_BWD_TILED, attn.KERNEL_BWD),
                        lambda *args: 1)
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_bwd(q, k, v, bias, q, 8, 5.0, False)
    assert attn.bwd_launches == 0
    h, W, b, labels, g = _ce_inputs(cuda, torch.float32, 64, 640, 300)
    ce._bind_tiled_bwd(torch.float32)
    monkeypatch.setitem(ce._BOUND, (ce.KERNEL_BWD_TILED, torch.float32),
                        lambda *args: 1)
    ce.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ce.ce_bwd(h, W, b, labels, torch.zeros_like(g), g)
    assert ce.bwd_launches == 0
    ce._bind_tiled_fwd()
    monkeypatch.setitem(ce._BOUND, (ce.KERNEL_FWD_TILED, torch.float32),
                        lambda *args: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ce.ce_fwd(h, W, b, labels.int())
    assert ce.fwd_launches == 0


# the bf16 K2 past 128 queries or keys (csrc/attention_bwd_cluster.cu):
# the seq-len-256 epoch's shapes, 129 x 129 and 512 x 512, head widths 8
# and 32, and rows x heads below the SMs (a cluster of 2 to 8 blocks)
CLUSTER_SHAPES = [(16, 129, 129, 8, 16), (64, 256, 256, 8, 16),
                  (64, 255, 256, 8, 16), (64, 31, 256, 8, 16),
                  (64, 256, 31, 8, 16), (16, 512, 512, 8, 16),
                  (4, 512, 512, 4, 32), (3, 200, 300, 2, 8),
                  (1, 256, 256, 8, 16), (8, 300, 49, 2, 32)]


@pytest.mark.parametrize("n,lq,lk,h,dh", CLUSTER_SHAPES)
@pytest.mark.parametrize("dbias", [False, True])
def test_cluster_k2_matches_plain_version(cuda, n, lq, lk, h, dh, dbias):
    """The bf16 K2 past 128 queries or keys up to 512 of both, with fully
    blocked rows, lengths off 16 and Lq != Lk, a block per row's head or a
    cluster of blocks: dq, dk, dv (and dbias) within 3.2e-2 of the plain
    version; the device ran the cluster kernel (and the dbias sum over
    heads), counted as one K2 launch and one cluster launch; two calls, and
    a call with dbias, give the same dq, dk, dv bits."""
    q, k, v, bias = _blocked_inputs(n, lq, lk, h, dh, torch.bfloat16, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(8)).to(
                        torch.bfloat16)
    scale = math.sqrt(dh)
    assert attn.uses_cluster(torch.bfloat16, lq, lk, h, dh)
    attn.reset_launches()
    got = _ran_route(lambda: attn.attention_bwd(q, k, v, bias, g, h, scale,
                                                dbias),
                     ["attention_bwd_cluster_kernel"]
                     + (["mma_dbias_kernel"] if dbias else []))
    assert (attn.bwd_launches, attn.wide_bwd_launches,
            attn.cluster_bwd_launches) == (1, 0, 1)
    want = attn.attention_bwd_reference(q, k, v, bias, g, h, scale, dbias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        if r is None:
            assert a is None
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert _err(a, r) <= 3.2e-2, name
    for other in (attn.attention_bwd(q, k, v, bias, g, h, scale, dbias),
                  attn.attention_bwd(q, k, v, bias, g, h, scale,
                                     not dbias)):
        assert all(torch.equal(a, c) for a, c in zip(got[:3], other[:3]))


@pytest.mark.parametrize("lq,lk", [(129, 129), (256, 256), (255, 256),
                                   (31, 256), (256, 31), (512, 512),
                                   (300, 49), (1, 512)])
@pytest.mark.parametrize("dh", [8, 16, 32])
def test_cluster_plan_comes_from_the_library(cuda, lq, lk, dh):
    """The cluster K2's shared memory, threads, slices and slice rows
    (`attn.cluster_plan`) are the library's own and fit a block of the
    card; its cluster size (`attn.cluster_size`) is the library's on this
    card's SMs."""
    plan = attn.library_cluster_plan(lq, lk, dh)
    assert plan == attn.cluster_plan(lq, lk, dh)
    props = torch.cuda.get_device_properties(cuda)
    assert plan[0] <= props.shared_memory_per_block_optin
    for n, heads in ((64, 8), (16, 8), (1, 1), (3, 16)):
        assert attn.library_cluster_size(n, heads, lq, lk) == \
            attn.cluster_size(n, heads, lq, lk, props.multi_processor_count)


def test_cluster_k2_wrapper_raises_instead_of_falling_back(cuda,
                                                           monkeypatch):
    """When the cluster K2 reports a failed launch, the wrapper raises and
    counts nothing: no fall-back to the plain version or to the older
    kernels."""
    q, k, v, bias = _inputs(3, 2, 256, 256, 8, 16, torch.bfloat16, cuda)
    attn._bind_cluster()
    monkeypatch.setitem(attn._BOUND, (attn.KERNEL_CLUSTER, attn.KERNEL_BWD),
                        lambda *args: 1)
    attn.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        attn.attention_bwd(q, k, v, bias, q, 8, 4.0, False)
    assert (attn.bwd_launches, attn.cluster_bwd_launches) == (0, 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("b,l,d,h", [(64, 31, 96, 8), (64, 31, 512, 8),
                                     (1216, 31, 96, 8), (37, 1, 96, 3),
                                     (37, 2, 512, 16), (64, 31, 128, 64),
                                     (5, 9, 100, 5), (3, 4, 1024, 2),
                                     (7, 31, 100, 4), (3, 2, 45, 3),
                                     (5, 7, 130, 65), (2, 3, 544, 2)])
def test_wide_star_kernel_matches_plain_version(cuda, dtype, tol, b, l, d,
                                                h):
    """K5 at widths outside {64, 128, 256} and head layouts the tuned
    kernel does not take (head widths 2, 12, 20, 32, 64, 512), through the
    wide kernels, at L = 1 and 2 too: the plain version's output; the
    device ran the kernel of `star.wide_plan`'s path (a group of lanes per
    row, or a warp per row and head) and nothing else; two calls give the
    same bits."""
    ring = _ring(cuda, dtype, b, l, d)
    star.reset_launches()
    path = star.wide_plan(d, h, ring[0].element_size()).path
    out = _ran_route(lambda: star.star_satellite(*ring, h),
                     [f"star_{path}_kernel"])
    ref = star.ring_reference(*ring, h)
    torch.cuda.synchronize()
    assert (star.launches, star.wide_launches) == (1, 1)
    assert out.shape == (b, l, d) and out.dtype == dtype
    assert _err(out, ref) <= tol
    assert torch.equal(out, star.star_satellite(*ring, h))


@pytest.mark.parametrize("d,h", [(96, 8), (100, 4), (512, 8), (45, 3),
                                 (33, 3), (130, 65), (544, 2), (1024, 2),
                                 (128, 64), (512, 16), (64, 1)])
def test_wide_star_plan_comes_from_the_library(cuda, d, h):
    """`star.wide_plan` (which the CPU emulation in tests/test_torch_star.py
    follows) is the library's `deepsc_star_wide_plan`, in both dtypes."""
    for size in (4, 2):
        assert star.library_plan(d, h, size) == star.wide_plan(d, h, size)


# ---- multi-step training: one captured CUDA graph of the step, replayed
# (train/steps.py:make_train_multi_step, train/graphed.py) ----


def _multi_inputs(cuda, cfg, k, seed=6):
    rng = np.random.default_rng(seed)
    inps = torch.from_numpy(rng.integers(4, cfg.vocab_size,
                                         (k, cfg.bs, cfg.seq_len))).to(cuda)
    inps[:, :, 0] = 1
    inps[:, :, 9:] = 0
    return inps


def _trained(cuda, cfg, variant, k, graphed, seed=7):
    """(losses (k,), model, state) of k steps from one init and one
    generator seed: one multi-step call (graphed on the card) or k eager
    steps."""
    model = steps.init_params(make_model(cfg, variant), 3).to(cuda).train()
    state = steps.create_train_state(model, cfg)
    gen = torch.Generator(cuda).manual_seed(seed)
    inps = _multi_inputs(cuda, cfg, k)
    star_target = variant != "transformer"
    if graphed:
        multi = steps.make_train_multi_step(model, cfg,
                                            full_target=star_target)
        state, losses = multi(state, inps, inps, gen, 0.5)
    else:
        step = steps.make_train_step(model, cfg, full_target=star_target)
        losses = torch.stack([step(state, x, x, gen, 0.5)[1] for x in inps])
    torch.cuda.synchronize()
    return losses, model, state


@pytest.mark.parametrize("variant", ["transformer", "star"])
def test_graphed_steps_equal_eager_steps(cuda, variant):
    """K = 4 steps at f32 with dropout 0.1 through one multi-step call
    (warm-up, capture, 3 replays) and through 4 eager steps, same init and
    generator seed: the losses within rtol 1e-5; params, Adam moments and
    counts within 1e-5 of their largest value; the count 4 on both."""
    cfg = (TINY_STAR if variant == "star" else TINY).replace(
        bs=8, encoder_dropout=0.1, decoder_dropout=0.1)
    got = _trained(cuda, cfg, variant, 4, True)
    want = _trained(cuda, cfg, variant, 4, False)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5)
    assert got[2].step == want[2].step == 4
    for (name, a), b in zip(got[1].named_parameters(),
                            want[1].parameters()):
        assert _err(a, b, relative=True) <= 1e-5, name
        for key in ("exp_avg", "exp_avg_sq", "step"):
            sa, sb = got[2].optimizer.state[a][key], \
                want[2].optimizer.state[b][key]
            assert _err(sa, sb, relative=True) <= 1e-5, (name, key)


def _recorded_draws(monkeypatch):
    """-> the list each draw of a train step goes to, in order: the channel
    noise (`steps._draw`) and every dropout mask (`bernoulli_`), the tensors
    themselves. A tensor made while a graph is captured stays alive in the
    graph's memory, so it holds each replay's values after the replay."""
    seen = []
    real_draw, real_bernoulli = steps._draw, torch.Tensor.bernoulli_

    def draw(*a, **kw):
        out = real_draw(*a, **kw)
        seen.append(out[0])
        return out

    def bernoulli(self, *a, **kw):
        seen.append(real_bernoulli(self, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(steps, "_draw", draw)
    monkeypatch.setattr(torch.Tensor, "bernoulli_", bernoulli)
    return seen


def test_graphed_replays_draw_fresh_noise_and_masks(cuda, monkeypatch):
    """Each replay draws its channel noise and dropout masks anew from the
    registered generator: two replays' differ, and each equals what the
    eager step draws at that point of the generator's stream."""
    from deepsc_gan_tpu_torch.train import graphed

    cfg = TINY.replace(bs=8, encoder_dropout=0.1, decoder_dropout=0.1)
    seen = _recorded_draws(monkeypatch)
    replays = []
    real_replay = graphed.GraphedStep.replay

    def replay(self, *a, **kw):
        out = real_replay(self, *a, **kw)
        per_step = len(seen) // 2  # the warm-up step's, then the capture's
        replays.append([t.clone() for t in seen[per_step:]])
        return out

    monkeypatch.setattr(graphed.GraphedStep, "replay", replay)
    _trained(cuda, cfg, "transformer", 3, True)
    assert len(replays) == 2  # step 1 is the eager warm-up
    seen.clear()
    _trained(cuda, cfg, "transformer", 3, False)
    per_step = len(seen) // 3
    assert per_step == len(replays[0]) > 1
    assert not torch.equal(replays[0][0], replays[1][0])  # the noise
    assert not torch.equal(replays[0][-1], replays[1][-1])  # a mask
    for r, drawn in enumerate(replays):
        for a, b in zip(drawn, seen[(r + 1) * per_step:]):
            assert torch.equal(a, b)


def _same_updates(got_model, got_state, want_model, want_state, tol=1e-5):
    """Every parameter, Adam moment and count, and the EMA shadow, of two
    trained states within `tol` of the reference's largest value; the
    counts equal."""
    assert got_state.step == want_state.step
    for (name, a), b in zip(got_model.named_parameters(),
                            want_model.parameters()):
        sa, sb = got_state.optimizer.state[a], want_state.optimizer.state[b]
        pairs = [("param", a, b)] + [(key, sa[key], sb[key])
                                     for key in ("exp_avg", "exp_avg_sq")]
        if want_state.ema is not None:
            pairs.append(("ema", got_state.ema[name], want_state.ema[name]))
        for what, x, y in pairs:
            assert _err(x.cpu(), y.cpu(), relative=True) <= tol, (name, what)
        assert sa["step"].item() == sb["step"].item(), name


def _host_grads(model):
    return [None if p.grad is None else p.grad.detach().cpu().clone()
            for p in model.parameters()]


# name -> (variant, Config fields): the noam rate moves every count
UPDATE_CASES = {
    "ema_noam": ("transformer", dict(ema_decay=0.9, schedule="noam",
                                     warmup_steps=40)),
    "star_full_target": ("star", dict(schedule="noam", warmup_steps=40)),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_graphed_updates_equal_the_cpu_updates(cuda, case, monkeypatch):
    """K = 4 f32 steps through one graphed multi-step call (the fused
    capturable Adam, its rate written before each replay, its count on the
    card), each step's gradients read back after it; the same gradients
    applied from the same init by the CPU's Adam (`apply_gradients`, the
    update test_torch_multistep.py holds to the JAX package's multi-step):
    params, Adam moments and the EMA shadow within 1e-5 of their largest
    value; every count equal. The gradients are the card's own on both
    sides, so what is compared is the update alone."""
    from deepsc_gan_tpu_torch.train import graphed

    variant, fields = UPDATE_CASES[case]
    cfg = (TINY_STAR if variant == "star" else TINY).replace(bs=8,
                                                             **fields)
    seen = []
    real_warm_up, real_replay = graphed.warm_up, graphed.GraphedStep.replay

    def warm_up(step, state, *a, **kw):
        out = real_warm_up(step, state, *a, **kw)
        seen.append(_host_grads(state.model))
        return out

    def replay(self, state, *a, **kw):
        out = real_replay(self, state, *a, **kw)
        seen.append(_host_grads(state.model))
        return out

    monkeypatch.setattr(graphed, "warm_up", warm_up)
    monkeypatch.setattr(graphed.GraphedStep, "replay", replay)
    _, model, state = _trained(cuda, cfg, variant, 4, True)
    assert len(seen) == 4
    ref_model = steps.init_params(make_model(cfg, variant), 3).train()
    ref = steps.create_train_state(ref_model, cfg)
    for grads in seen:
        for p, g in zip(ref_model.parameters(), grads):
            p.grad = g
        ref.apply_gradients()
    _same_updates(model, state, ref_model, ref)


def test_gan_updates_on_the_card_equal_the_cpu_updates(cuda, monkeypatch):
    """Two f32 GAN steps on the card under noam with the EMA shadow: three
    selective updates a step over one shared Adam, the device count written
    before each. The same gradients and masks applied from the same init by
    `selective_update` over the CPU's Adam, the EMA after every third (the
    update test_torch_gan.py holds to JAX's GAN step): params, Adam moments
    and the EMA shadow within 1e-5 of their largest value; every count
    equal."""
    from deepsc_gan_tpu_torch.train import gan_steps

    cfg = TINY.replace(bs=8, schedule="noam", warmup_steps=40,
                       ema_decay=0.9)
    updates = []
    real_update = gan_steps.selective_update

    def selective_update(state, grads, mask):
        updates.append(({n: None if g is None else g.detach().cpu().clone()
                         for n, g in grads.items()}, mask))
        return real_update(state, grads, mask)

    monkeypatch.setattr(gan_steps, "selective_update", selective_update)
    model = steps.init_params(make_model(cfg, "gan"), 3).to(cuda).train()
    state = steps.create_train_state(model, cfg)
    step = gan_steps.make_gan_train_step(model, cfg)
    gen = torch.Generator(cuda).manual_seed(7)
    for x in _multi_inputs(cuda, cfg, 2):
        state, _ = step(state, x, x, gen, 0.5)
    torch.cuda.synchronize()
    assert len(updates) == 6 and state.step == 6
    ref_model = steps.init_params(make_model(cfg, "gan"), 3).train()
    ref = steps.create_train_state(ref_model, cfg)
    for i, (grads, mask) in enumerate(updates):
        real_update(ref, grads, mask)
        if i % 3 == 2:
            gan_steps._ema(ref)
    _same_updates(model, state, ref_model, ref)


def test_graphed_dispatch_counts_exact_launches(cuda):
    """After a graphed call of K = 5 steps, and after a second one, each
    kernel's count is K per call times its launches in one eager step (the
    capture's counts taken back, each replay's added)."""
    cfg = TINY.replace(bs=8)
    model = steps.init_params(make_model(cfg), 3).to(cuda).train()
    state = steps.create_train_state(model, cfg)
    multi = steps.make_train_multi_step(model, cfg)
    gen = torch.Generator(cuda).manual_seed(1)
    inps = _multi_inputs(cuda, cfg, 5)
    attn.reset_launches()
    ce.reset_launches()
    for call in (1, 2):
        multi(state, inps, inps, gen, 0.5)
        torch.cuda.synchronize()
        per_step = cfg.encoder_num_layer + 2 * cfg.decoder_num_layer
        assert (attn.launches, attn.bwd_launches) == \
            (5 * call * per_step,) * 2
        assert (ce.fwd_launches, ce.bwd_launches) == (5 * call,) * 2
    assert state.step == 10 and len(multi.graphs) == 1


def test_graphed_step_recaptures_for_a_new_shape(cuda):
    """A batch of another length gets a graph of its own; the first graph
    still serves its shape. A call with another generator than the
    capture's raises before any step."""
    cfg = TINY.replace(bs=8)
    model = steps.init_params(make_model(cfg), 3).to(cuda).train()
    state = steps.create_train_state(model, cfg)
    multi = steps.make_train_multi_step(model, cfg)
    gen = torch.Generator(cuda).manual_seed(1)
    inps = _multi_inputs(cuda, cfg, 3)
    for batch in (inps, inps[:, :, :10].contiguous(), inps):
        _, losses = multi(state, batch, batch, gen, 0.5)
        torch.cuda.synchronize()
        assert torch.isfinite(losses).all()
    assert len(multi.graphs) == 2 and state.step == 9
    # the graph draws from the generator it was captured with
    with pytest.raises(ValueError, match="generator"):
        multi(state, inps, inps, torch.Generator(cuda).manual_seed(1), 0.5)
    assert state.step == 9


def test_graph_capture_failure_raises(cuda):
    """A step that synchronizes with the host inside the capture (here a
    hook reading a value back) makes the graphed call raise; nothing falls
    back to eager steps."""
    cfg = TINY.replace(bs=8)
    model = steps.init_params(make_model(cfg), 3).to(cuda).train()
    def read_back(mod, args, out):
        float(out.detach().sum())  # a host sync: refused while capturing

    model.channel_encoder.register_forward_hook(read_back)
    state = steps.create_train_state(model, cfg)
    multi = steps.make_train_multi_step(model, cfg)
    inps = _multi_inputs(cuda, cfg, 3)
    with pytest.raises(RuntimeError):
        multi(state, inps, inps, torch.Generator(cuda).manual_seed(1), 0.5)
    torch.cuda.synchronize()
    assert state.step == 1  # the eager warm-up step, and no other


# ---- training around the step: MINE, remat, fuse_qkv, resume through the
# graph, --profile ----


def _mine_step(cuda, cfg, plain, inp, relu_replay=None):
    """One f32 MINE step at tiny widths through the kernels (or the plain
    versions) from init 3, T from init 4, generator seed 7 -> ((ce, mi),
    transceiver, T, launches (K1, K2, K3, K4))."""
    from deepsc_gan_tpu_torch.train import mine_steps

    attention = attn.plain_attention if plain else attn.fused_attention
    model = steps.init_params(make_model(cfg, attention=attention), 3)
    model = model.to(cuda).train()
    state = steps.create_train_state(model, cfg)
    mine, mine_state = mine_steps.create_mine_state(cfg, 4, device=cuda)
    step = mine_steps.make_mine_train_step(model, mine, cfg)
    attn.reset_launches()
    ce.reset_launches()
    gen = torch.Generator(cuda).manual_seed(7)
    _, _, (ce_loss, mi) = step(state, mine_state, inp, inp, gen, 0.5)
    torch.cuda.synchronize()
    return ((ce_loss.item(), mi.item()), model, mine,
            (attn.launches, attn.bwd_launches, ce.fwd_launches,
             ce.bwd_launches))


def test_tiny_mine_step_kernels_equal_plain_step(cuda):
    """One f32 MINE step at tiny widths through the kernels and through the
    plain versions, same weights, draws, permutation and dropout masks: ce
    and mi within rtol 1e-5; every gradient of the transceiver within 1e-4
    of its largest reference value, every gradient of T within 1e-4 of the
    largest of T's (fc2's bias has the gradient 1 - sum softmax, zero but
    for rounding: the DV bound does not move when T shifts). Launches: K1
    in every attention of the forward and in the encoder's recompute for
    T's update (2 + 4 + 2), K2 in every attention's backward, no K3/K4."""
    cfg = TINY.replace(bs=8, mine_lambda=0.5)
    rng = np.random.default_rng(6)
    inp = torch.from_numpy(rng.integers(4, 40, (8, 12))).to(cuda)
    inp[:, 0] = 1
    inp[:, 9:] = 0
    got = _mine_step(cuda, cfg, False, inp)
    want = _mine_step(cuda, cfg, True, inp)
    assert got[3] == (8, 6, 0, 0)
    assert want[3] == (0, 0, 0, 0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for (name, a), b in zip(got[1].named_parameters(),
                            want[1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-4, name
    largest = max(p.grad.abs().max().item() for p in want[2].parameters())
    for (name, a), b in zip(got[2].named_parameters(),
                            want[2].parameters()):
        assert _err(a.grad, b.grad) <= 1e-4 * largest, name


def _remat_multi(cuda, cfg, remat, k=3):
    cfg = cfg.replace(remat=remat)
    model = steps.init_params(make_model(cfg), 3).to(cuda).train()
    state = steps.create_train_state(model, cfg)
    gen = torch.Generator(cuda).manual_seed(7)
    multi = steps.make_train_multi_step(model, cfg)
    attn.reset_launches()
    state, losses = multi(state, *(_multi_inputs(cuda, cfg, k),) * 2, gen,
                          0.5)
    torch.cuda.synchronize()
    return losses, model, gen, (attn.launches, attn.bwd_launches)


def test_graphed_remat_steps_equal_graphed_steps(cuda):
    """Three f32 steps with dropout 0.3 in one graphed call, with and
    without remat (the layers recomputed inside the captured graph, their
    kept masks read back): losses within rtol 1e-6, the last step's
    gradients within 1e-6 of their largest, the generator's state equal
    after; with remat each K1 launches twice a step."""
    cfg = TINY.replace(bs=8, encoder_dropout=0.3, decoder_dropout=0.3)
    got = _remat_multi(cuda, cfg, True)
    want = _remat_multi(cuda, cfg, False)
    assert want[3] == (18, 18) and got[3] == (36, 18)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-6)
    for (name, a), b in zip(got[1].named_parameters(),
                            want[1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-6, name
    assert torch.equal(got[2].get_state(), want[2].get_state())


@pytest.mark.parametrize("variant", ["transformer", "star"])
def test_fuse_qkv_on_the_card_equals_unfused(cuda, variant):
    """One f32 eager step with the packed projections against one without,
    same weights and draws: the loss within rtol 1e-5, every gradient
    within 1e-4 of its largest; the same kernel launches."""
    base = (TINY_STAR if variant == "star" else TINY).replace(bs=8)
    out = []
    for fuse in (True, False):
        cfg = base.replace(fuse_qkv=fuse)
        model = steps.init_params(make_model(cfg, variant), 3)
        model = model.to(cuda).train()
        state = steps.create_train_state(model, cfg)
        step = steps.make_train_step(model, cfg,
                                     full_target=variant == "star")
        attn.reset_launches()
        star.reset_launches()
        gen = torch.Generator(cuda).manual_seed(7)
        x = _multi_inputs(cuda, cfg, 1)[0]
        _, loss = step(state, x, x, gen, 0.5)
        torch.cuda.synchronize()
        out.append((loss.item(), model, (attn.launches, attn.bwd_launches,
                                         star.launches)))
    assert out[0][2] == out[1][2] and sum(out[0][2]) > 0
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for (name, a), b in zip(out[0][1].named_parameters(),
                            out[1][1].parameters()):
        assert _err(a.grad, b.grad, relative=True) <= 1e-4, name


def _tiny_corpus(path, n=64, seed=6):
    rng = np.random.default_rng(seed)
    rows = [[1] + rng.integers(4, 40, int(k)).tolist() + [2]
            for k in rng.integers(4, 10, n)]
    with open(path, "wb") as f:
        import pickle
        pickle.dump(rows, f)
    return str(path)


TINY_CLI = ["--vocab-size", "40", "--seq-len", "12", "--max-length", "11",
            "--encoder-num-layer", "2", "--decoder-num-layer", "2",
            "--encoder-d-model", "16", "--decoder-d-model", "16",
            "--encoder-d-ff", "32", "--decoder-d-ff", "32",
            "--encoder-num-heads", "2", "--decoder-num-heads", "2",
            "--channel-hidden", "24", "--channel-dim", "8",
            "--channel-dec-hidden", "32", "--dtype", "float32", "--bs", "8"]


def test_graphed_resume_is_bitwise_the_straight_run(cuda, tmp_path):
    """`cli train --scan-steps 4` on the card (replays of a captured graph
    whose generator is registered) with the EMA shadow: two epochs, then
    `--resume` for two more, bitwise equal to four straight epochs (every
    tensor of the epoch-4 checkpoint, the generator's state included)."""
    from deepsc_gan_tpu_torch import cli

    corpus = _tiny_corpus(tmp_path / "train.pkl")

    def run(ckpt, *extra):
        return cli.main(["train", "--device", "cuda", *TINY_CLI,
                         "--scan-steps", "4", "--ema-decay", "0.9",
                         "--ckpt-every", "2", "--log-every", "1000",
                         "--train-save-path", corpus,
                         "--log-save-path", str(tmp_path / "log"),
                         "--checkpoint-path", ckpt, *extra])

    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    assert run(straight, "--epochs", "4")["path"] == "scan4"
    run(split, "--epochs", "2")
    assert run(split, "--epochs", "4", "--resume")["start_epoch"] == 2
    a, b = (torch.load(f"{d}/transformer/4/state.pt", weights_only=True)
            for d in (straight, split))
    assert a.keys() == b.keys() and a["step"] == b["step"] == 32
    for key in a:
        if isinstance(a[key], dict):
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (key, name)


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_profile_trace_holds_the_kernels(cuda, tmp_path, scan_steps):
    """`cli train --profile` on the card, eager and graphed (the capture
    inside the traced epoch): the trace holds K1's kernel (at f32 the
    narrow kernel) once per attention and step of the first epoch."""
    import json

    from deepsc_gan_tpu_torch import cli

    prof = tmp_path / "prof"
    res = cli.main(["train", "--device", "cuda", *TINY_CLI, "--epochs", "2",
                    "--scan-steps", str(scan_steps), "--log-every", "1000",
                    "--train-save-path",
                    _tiny_corpus(tmp_path / "train.pkl", n=32),
                    "--log-save-path", str(tmp_path / "log"),
                    "--checkpoint-path", str(tmp_path / "ck"),
                    "--profile", str(prof)])
    assert res["steps"] == 8
    with open(prof / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    k1 = sum("attention_narrow_fwd_kernel" in n for n in names)
    assert k1 == 4 * 6


def _tiny_bert_dir(directory, seed=0):
    """A tiny random BERT in a Hugging Face directory, written with the
    port's own safetensors writer (the card's machine has no
    transformers)."""
    import json

    from deepsc_gan_tpu_torch.models.bert import (
        BertConfig,
        BertEncoder,
        write_safetensors,
    )

    cfg = BertConfig(vocab_size=60, hidden_size=32, num_hidden_layers=12,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=40)
    (directory / "config.json").write_text(json.dumps(cfg.to_json()))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(4, 40)]
    (directory / "vocab.txt").write_text("\n".join(words) + "\n")
    gen = torch.Generator().manual_seed(seed)
    write_safetensors(str(directory / "model.safetensors"), {
        name: 0.5 * torch.randn(t.shape, generator=gen)
        for name, t in BertEncoder(cfg).state_dict().items()})
    return str(directory)


def test_bert_on_the_card_equals_the_cpu(cuda, tmp_path):
    """Every hidden state of the port's BERT on the card within 1e-4 of the
    CPU's (f32 without TF32), pads in the mask; and the similarity scores
    within 1e-4."""
    from deepsc_gan_tpu_torch.evaluate.metrics import Similarity
    from deepsc_gan_tpu_torch.models.bert import exact_f32_matmuls, load_bert

    d = _tiny_bert_dir(tmp_path)
    cpu, card = load_bert(d, "cpu"), load_bert(d, cuda)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 60, (16, 24), generator=g)
    mask = (torch.arange(24)[None] < torch.randint(3, 25, (16, 1),
                                                   generator=g)).long()
    with torch.inference_mode(), exact_f32_matmuls():
        want = cpu(ids, mask)
        got = card(ids.to(cuda), mask.to(cuda))
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-4
    real = ["w5 w6 w7 w8", "w9 w10", "w11 w12 w13", "w30 w31 w32 w33 w34"]
    pred = ["w5 w6 w9 w8", "w9", "w11 w12 w13", "w4 w31"]
    a = Similarity(d, device="cuda").compute_score(real, pred)
    b = Similarity(d, device="cpu").compute_score(real, pred)
    assert max(abs(x - y) for x, y in zip(a, b)) <= 1e-4


def test_bcjr_on_the_card_equals_the_cpu(cuda):
    """The max-log BCJR's LLRs on the card within 1e-5 of their largest of
    the CPU's, and the turbo decoder's bits equal, at block_k 512."""
    from deepsc_gan_tpu_torch.baselines import turbo

    rng = np.random.default_rng(0)
    ls, lp, la = (torch.from_numpy(3 * rng.standard_normal(
        (32, 512)).astype(np.float32)) for _ in range(3))
    want = turbo.bcjr(ls, lp, la)
    got = turbo.bcjr(ls.to(cuda), lp.to(cuda), la.to(cuda)).cpu()
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    codecs = [turbo.TurboCodec(block_k=512, iters=6, seed=1, device=d)
              for d in ("cpu", cuda)]
    bits = rng.integers(0, 2, 16 * 512 - 7).astype(np.uint8)
    sym, n = codecs[0].encode(bits)
    llr = turbo.TurboCodec.awgn_llr(sym, 0.5,
                                    torch.Generator().manual_seed(2))
    hard = [c.decode(llr, n) for c in codecs]
    assert np.array_equal(hard[0], hard[1])


EXPORT_TINY = ["--vocab-size", "40", "--seq-len", "12", "--max-length", "11",
               "--encoder-num-layer", "2", "--decoder-num-layer", "2",
               "--encoder-d-model", "16", "--decoder-d-model", "16",
               "--encoder-d-ff", "32", "--decoder-d-ff", "32",
               "--encoder-num-heads", "2", "--decoder-num-heads", "2",
               "--channel-hidden", "24", "--channel-dim", "8",
               "--channel-dec-hidden", "32", "--dtype", "float32"]


def test_export_on_the_card_decodes_the_plain_ids(cuda, tmp_path):
    """`cli export` on the card (the KV sweep, symbolic b and s), loaded
    from the file: its ids equal the eager sweep's through the plain
    attention at two (B, S), and it launched no kernel."""
    from deepsc_gan_tpu_torch import cli
    from deepsc_gan_tpu_torch.evaluate.kv_decode import (
        make_greedy_decode_kv_sweep,
    )

    out = str(tmp_path / "kv.pt2")
    argv = ["export", "--device", "cuda", "--out", out, *EXPORT_TINY]
    attn.reset_launches()
    cli.main(argv)
    assert attn.launches == 0
    args = cli.build_parser().parse_args(argv)
    cfg, model, _ = cli.restore_model(args, cli.variant_config(args), cuda,
                                      "test", attention=attn.plain_attention)
    program = torch.export.load(out).module()
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, s in ((4, 2), (3, 5)):
        inp = torch.randint(4, 40, (b, 12), generator=g, device=cuda)
        inp[:, 0] = 1
        noise = torch.randn((s, b, 12, 8), generator=g, device=cuda)
        n_stds = 0.05 + torch.rand((s,), generator=g, device=cuda)
        got = program(inp, noise, torch.tensor(0.0, device=cuda), n_stds)
        want = make_greedy_decode_kv_sweep(model, cfg)(inp, 0.0, n_stds,
                                                       noise)
        assert torch.equal(got, want)


def test_transmit_on_the_card(cuda, tmp_path):
    """`cli transmit` on the card at f32: K1 launched encoder layers + 2
    decoder layers x max_length times; the ids equal the plain attention's
    on the same draws."""
    from deepsc_gan_tpu_torch import cli
    from deepsc_gan_tpu_torch.evaluate.greedy import make_greedy_decode
    from deepsc_gan_tpu_torch.models.channel import draw_channel

    argv = ["transmit", "--device", "cuda", "--seed", "4", "--snr", "9",
            "--checkpoint-path", str(tmp_path), "--text", "w5 w6 w7, w8.",
            "--text", "w30 w31 w9?", *EXPORT_TINY]
    attn.reset_launches()
    res = cli.main(argv)
    assert attn.launches == 2 + 2 * 2 * 11
    args = cli.build_parser().parse_args(argv)
    cfg, model, _ = cli.restore_model(args, cli.variant_config(args), cuda,
                                      "test", attention=attn.plain_attention)
    gen = torch.Generator(device=cuda).manual_seed(4)
    noise, _ = draw_channel(gen, (2, 12, 8))
    want = make_greedy_decode(model, cfg)(res["inp"].to(cuda), 0.0,
                                          1.0 / math.sqrt(10 ** 0.9), noise)
    assert torch.equal(res["ids"], want.cpu())
    assert len(res["received"]) == 2


@pytest.mark.parametrize("case", ["plain", "attack", "gan", "mine", "star"])
def test_dp_step_on_the_card_matches_the_single_step(cuda, case):
    """Two ranks on cuda:0 over gloo (`parallel/mesh.py`'s rule: they share
    the card), the f32 dp step of `case` at bs 8 against the single-process
    step on the card; each rank launched K1-K4 (K5 for star) every step,
    as the single step does."""
    import torch_parallel_worker as worker
    from deepsc_gan_tpu_torch.parallel.launch import run_ranks

    cfg = TINY.replace(bs=8, cycle_num=2)
    # MINE one step, as on the CPU: T's Adam turns rounding-level
    # gradients (its fc2 bias's is 0 up to rounding) into +-lr steps
    steps_n = 1 if case == "mine" else 2
    kw = dict(case=case, seed=1, batches=[worker.scaled_batch(cfg, 10 + i)
                                          for i in range(steps_n)])
    spec = {"device": "cuda", "cfg": cfg, "steps": {case: kw}}
    ranks = run_ranks(worker.rank_main, 2, spec)
    ref = worker.run_case(cfg=cfg, device="cuda", **kw)
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo" and out["world"] == 2
        got = out["steps"][case]
        worker.assert_close_to(ref, got, f"{case} rank {r}",
                               1 if case == "mine" else None, tol=1e-4)
        assert got["counts"] == ref["counts"], (got["counts"],
                                                ref["counts"])
        trained = ("K5",) if case == "star" else ("K1", "K2")
        assert all(got["counts"][k] > 0 for k in trained), got["counts"]
