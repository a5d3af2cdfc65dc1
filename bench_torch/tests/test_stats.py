"""Percentiles are taken over every sample, never as medians of chunks."""

import numpy as np
import pytest

from bench_torch.stats import percentile


@pytest.mark.parametrize("q", [0, 5, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy(q):
    values = list(np.random.default_rng(q).exponential(size=1001))
    assert percentile(values, q) == pytest.approx(float(np.percentile(values, q)), rel=1e-12)


def test_percentile_is_over_all_samples_not_chunks():
    # 95 fast hops then 5 slow ones in one chunk: the p95 of all 200 samples
    # sees the slow tail, a median of per-chunk p95s would not
    values = [1.0] * 100 + [1.0] * 90 + [50.0] * 10
    chunk_p95s = [percentile(values[:100], 95), percentile(values[100:], 95)]
    assert percentile(values, 95) == pytest.approx(np.percentile(values, 95))
    assert percentile(values, 95) > 1.0
    assert np.median(chunk_p95s) != percentile(values, 95)


def test_percentile_refuses_nothing_and_out_of_range():
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile([1.0], 101)
