"""The generator: deterministic per seed, the stated range and mean."""

import numpy as np
import pytest
import torch

from bench_torch import harness, traffic


@pytest.mark.parametrize("mix", ["wsj0_2mix_tt_b256", "wsj0_2mix_tr_b32"])
def test_lengths_range_mean_and_sizes_shared_across_seeds(mix):
    spec = harness._json(harness.HERE / "traffic" / f"{mix}.json")
    a = traffic.utterance_samples(spec, 1)
    b = traffic.utterance_samples(spec, 2**31 + 11)
    sr = spec["sample_rate"]
    for lengths in (a, b):
        assert len(lengths) == spec["utterances"]
        assert lengths.min() >= spec["min_seconds"] * sr and lengths.max() <= spec["max_seconds"] * sr
        assert np.all(np.diff(lengths) >= 0)
        assert lengths.mean() / sr == pytest.approx(6.0, abs=0.01)
    # one length a bin: two seeds' sets differ by under a bin
    bin_samples = (spec["max_seconds"] - spec["min_seconds"]) * sr / spec["utterances"]
    assert np.abs(a - b).max() <= bin_samples + 1
    assert not np.array_equal(a, b)


def _small(**kw):
    spec = {"utterances": 7, "batch": 3, "min_seconds": 0.1, "max_seconds": 0.3,
            "pad_quantum_seconds": 0.05, "sample_rate": 8000, "num_speakers": 2, "sources": True}
    spec.update(kw)
    return spec


def test_corpus_is_deterministic_per_seed():
    cpu = torch.device("cpu")
    one, again, other = (traffic.corpus(_small(), s, cpu) for s in (2**31 + 3, 2**31 + 3, 8))
    assert np.array_equal(one.order, again.order)
    for x, y in zip(one.batches, again.batches):
        assert np.array_equal(x.mix, y.mix) and np.array_equal(x.sources, y.sources)
    assert any(not np.array_equal(x.mix, y.mix) for x, y in zip(one.batches, other.batches))


def test_corpus_batches_sorted_padded_and_mixed():
    c = traffic.corpus(_small(), 5, torch.device("cpu"))
    assert [len(b.sample_lengths) for b in c.batches] == [3, 3, 1]
    assert sorted(c.order.tolist()) == [0, 1, 2]
    for b in c.batches:
        assert b.mix.shape[1] % 400 == 0 and b.mix.shape[1] >= b.sample_lengths.max()
        assert np.allclose(b.mix, b.sources.sum(axis=1), atol=1e-7)
        for row, n in enumerate(b.sample_lengths):
            assert not b.mix[row, n:].any() and b.mix[row, :n].any()
    assert traffic.corpus(_small(sources=False), 5, torch.device("cpu")).batches[0].sources is None


def test_streams_and_negative_seed():
    spec = {"streams": 3, "stream_seconds": 0.5, "hop_seconds": 0.1, "context_seconds": 0.2,
            "sample_rate": 8000, "num_speakers": 2}
    s = traffic.streams(spec, 2**32 + 1, torch.device("cpu"))
    assert s.mixes.shape == (3, 4000) and (s.hop, s.context) == (800, 1600)
    assert np.array_equal(s.mixes, traffic.streams(spec, 2**32 + 1, torch.device("cpu")).mixes)
    with pytest.raises(ValueError):
        traffic.streams(spec, -1, torch.device("cpu"))
