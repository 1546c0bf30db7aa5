"""The port's synthetic LM data stream (``repro_torch.data``) against the
JAX package's (``repro.data``): every batch bit for bit over seeds, steps
and host slices, with the modality extras, and the prefetching iterator;
plus the reference's own data tests, mirrored."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402

EXTRAS = {"patch_embeds": ((4, 8), np.float32), "frames": ((16, 8), np.float32)}


def _same_batch(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_batches_bit_identical_to_jax(seed, hosts):
    host, n = hosts
    kw = dict(vocab=1000, seq_len=48, global_batch=8, seed=seed, motif_len=6, n_motifs=16)
    ours = SyntheticLMData(DataConfig(**kw), host_index=host, n_hosts=n, extras=EXTRAS)
    ref = JData(JDataConfig(**kw), host_index=host, n_hosts=n, extras=EXTRAS)
    assert ours.local_batch == ref.local_batch == 8 // n
    for step in (0, 1, 17, 5000):
        _same_batch(ours.batch_at(step), ref.batch_at(step))


def test_full_vocab_batch_bit_identical_to_jax():
    """Qwen2's 151,936-token vocabulary at one card's 2 x 4,096 batch."""
    kw = dict(vocab=151936, seq_len=4096, global_batch=2)
    _same_batch(SyntheticLMData(DataConfig(**kw)).batch_at(3),
                JData(JDataConfig(**kw)).batch_at(3))


def test_prefetch_iterator_matches_batch_at_and_jax():
    cfg = dict(vocab=64, seq_len=8, global_batch=2)
    data, ref = SyntheticLMData(DataConfig(**cfg)), JData(JDataConfig(**cfg))
    it = data.iterate(start_step=10, prefetch=3)
    for want_step in (10, 11, 12, 13):
        step, batch = next(it)
        assert step == want_step
        _same_batch(batch, data.batch_at(want_step))
        _same_batch(batch, ref.batch_at(want_step))
    it.close()


def test_deterministic_in_seed_and_step():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=7)
    d1, d2 = SyntheticLMData(cfg), SyntheticLMData(cfg)
    np.testing.assert_array_equal(d1.batch_at(123)["tokens"], d2.batch_at(123)["tokens"])
    assert not np.array_equal(d1.batch_at(123)["tokens"], d1.batch_at(124)["tokens"])


def test_host_sharding_partitions_batch():
    cfg = DataConfig(vocab=256, seq_len=16, global_batch=8, seed=1)
    h0 = SyntheticLMData(cfg, host_index=0, n_hosts=2)
    h1 = SyntheticLMData(cfg, host_index=1, n_hosts=2)
    assert h0.local_batch == h1.local_batch == 4
    assert not np.array_equal(h0.batch_at(5)["tokens"], h1.batch_at(5)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLMData(DataConfig(vocab=256, seq_len=16, global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["loss_mask"].dtype == np.float32 and (b["loss_mask"] == 1).all()
