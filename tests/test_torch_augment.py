"""The port's training-data augmentation (`data/augment.py`) against the
JAX package's: the same corpus, seed and epoch give bitwise-equal batches
for every mix of the crop, concat and synth probabilities; all zero gives
the plain shuffled `Dataset`; and `load_train_dataset` loads what the JAX
CLI's `_load_train_dataset` loads, the synthetic fallback included."""

import pickle

import numpy as np
import pytest

from deepsc_gan_tpu import cli as jax_cli
from deepsc_gan_tpu.data import augment as jax_augment
from deepsc_gan_tpu_torch.data import augment, loader
from test_torch_model import port_config

# name -> (crop, concat, synth)
MIXES = {"crop": (0.5, 0.0, 0.0), "concat": (0.0, 0.5, 0.0),
         "synth": (0.0, 0.0, 0.5), "all": (0.2, 0.3, 0.25),
         "crop_synth": (0.6, 0.0, 0.3), "certain_synth": (0.0, 0.0, 1.0)}


def _raw(n=50, seed=3):
    """Token lists of 4 to 20 words, framed <START> ... <END>."""
    rng = np.random.default_rng(seed)
    return [[1] + rng.integers(4, 40, size=int(k)).tolist() + [2]
            for k in rng.integers(4, 21, size=n)]


def _epochs(ds, epochs):
    out = []
    for epoch in epochs:
        ds.set_epoch(epoch)
        out += [(inp.copy(), tar.copy()) for inp, tar in ds]
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("seed", [0, 11])
def test_augmented_batches_equal_jax(tiny_cfg, mix, seed):
    crop, concat, synth = MIXES[mix]
    cfg = tiny_cfg.replace(bs=8, aug_crop=crop, aug_concat=concat,
                           aug_synth=synth)
    raw = _raw()
    want = jax_augment.make_train_dataset(raw, cfg, seed=seed)
    got = augment.make_train_dataset(raw, port_config(cfg), seed=seed)
    assert isinstance(got, augment.AugmentedDataset)
    assert len(got) == len(want) == 50 // 8
    # epochs out of order, and one repeated: each a function of the epoch
    _assert_same_batches(_epochs(got, [0, 1, 2, 1, 5]),
                         _epochs(want, [0, 1, 2, 1, 5]))
    # and before any set_epoch: the seed's own stream
    fresh = augment.make_train_dataset(raw, port_config(cfg), seed=seed)
    fresh_jax = jax_augment.make_train_dataset(raw, cfg, seed=seed)
    _assert_same_batches(list(fresh), list(fresh_jax))


def test_zero_probabilities_give_the_plain_dataset(tiny_cfg):
    cfg = tiny_cfg.replace(bs=8)
    raw = _raw(seed=4)
    got = augment.make_train_dataset(raw, port_config(cfg), seed=2)
    assert isinstance(got, loader.Dataset)
    want = jax_augment.make_train_dataset(raw, cfg, seed=2)
    plain = loader.Dataset(loader.pad_sequences(raw, cfg.seq_len),
                           batch_size=8, seed=2)
    _assert_same_batches(_epochs(got, [0, 3]), _epochs(want, [0, 3]))
    _assert_same_batches(_epochs(got, [0, 3]), _epochs(plain, [0, 3]))


@pytest.mark.parametrize("exists", [True, False])
def test_load_train_dataset_matches_the_jax_cli(tiny_cfg, tmp_path, exists):
    """The pickle through the augmentation (or, when it does not exist, the
    synthetic set of 4,096 sentences, which ignores the aug_* fields), as
    the JAX CLI's `_load_train_dataset`."""
    path = tmp_path / "train.pkl"
    if exists:
        with open(path, "wb") as f:
            pickle.dump(_raw(seed=5), f)
    cfg = tiny_cfg.replace(bs=8, train_save_path=str(path), aug_crop=0.3,
                           aug_concat=0.2)
    got = augment.load_train_dataset(port_config(cfg), seed=7)
    want = jax_cli._load_train_dataset(cfg, 7)
    assert isinstance(got, augment.AugmentedDataset if exists
                      else loader.Dataset)
    _assert_same_batches(_epochs(got, [0, 1]), _epochs(want, [0, 1]))
