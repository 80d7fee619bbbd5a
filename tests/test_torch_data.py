"""``repro_torch.data`` against ``repro.data``: the synthetic token
pipeline's tokens, labels and mask bit for bit, and the five cases of
``tests/test_data.py`` on the port."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import SyntheticTokenDataset as JDataset
from repro.data import make_batch_specs as jmake_batch_specs
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import SyntheticTokenDataset, make_batch_specs


@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("vocab,seq,batch", [(1000, 16, 8), (128256, 32, 4),
                                             (512, 64, 2)])
def test_batches_bit_identical_to_the_reference(seed, vocab, seq, batch):
    ours = SyntheticTokenDataset(vocab, seq, batch, seed=seed)
    ref = JDataset(vocab, seq, batch, seed=seed)
    for step in (0, 1, 7, 1000):
        got, want = ours.train_inputs(step), ref.train_inputs(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_slices_bit_identical_to_the_reference(n_hosts):
    ours = SyntheticTokenDataset(500, 8, 8, seed=5)
    ref = JDataset(500, 8, 8, seed=5)
    for h in range(n_hosts):
        np.testing.assert_array_equal(ours.host_slice(3, h, n_hosts),
                                      ref.host_slice(3, h, n_hosts))
    with pytest.raises(ValueError, match="does not split"):
        ours.host_slice(3, 0, 3)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "whisper_tiny"])
def test_batch_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    shape = SHAPES["train_4k"]
    got = make_batch_specs(cfg, shape)
    want = jmake_batch_specs(jcfg, shape)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k][0] == tuple(spec.shape), k
        assert got[k][1] == getattr(torch, str(spec.dtype)), k


# ---- mirrors of tests/test_data.py ----------------------------------------

def test_deterministic_and_stateless():
    ds = SyntheticTokenDataset(vocab_size=1000, seq_len=16, global_batch=8,
                               seed=42)
    a = ds.batch_at(7)
    b = ds.batch_at(7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ds.batch_at(8), a)


def test_skip_to_step_is_free():
    """Resuming at step k sees the same data as a run that walked to k."""
    ds = SyntheticTokenDataset(vocab_size=500, seq_len=8, global_batch=4)
    walked = [ds.batch_at(i) for i in range(5)]
    np.testing.assert_array_equal(ds.batch_at(4), walked[4])


def test_host_slices_tile_the_global_batch():
    ds = SyntheticTokenDataset(vocab_size=500, seq_len=8, global_batch=8)
    full = ds.batch_at(3)
    parts = [ds.host_slice(3, h, 4) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_zipf_skew():
    ds = SyntheticTokenDataset(vocab_size=1000, seq_len=256, global_batch=8)
    toks = ds.batch_at(0)
    # Zipf: token 0 much more frequent than the tail
    assert (toks == 0).mean() > (toks >= 500).mean()
    assert toks.min() >= 0 and toks.max() < 1000


def test_train_inputs_mask_and_labels():
    ds = SyntheticTokenDataset(vocab_size=100, seq_len=8, global_batch=2)
    b = ds.train_inputs(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["mask"][:, -1] == 0).all()
    assert (b["mask"][:, :-1] == 1).all()
