"""The routing table (ops/routing.py): each decision per platform and shape,
and the callers that consult it. The platform is faked; no kernel runs."""

import jax.numpy as jnp
import pytest

from ranklib_tpu.ops import histogram as H
from ranklib_tpu.ops import routing


@pytest.fixture
def on(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(routing, "platform", lambda: name)
    return set_platform


@pytest.mark.parametrize("platform,dims,want", [
    ("gpu", (9, 10), True), ("gpu", (127, 128), True),
    ("gpu", (128, 129), False), ("gpu", (499, 500), False),
    ("cpu", (9, 10), False),
])
def test_scoring_kernel_route(on, platform, dims, want):
    on(platform)
    assert routing.scoring_kernel(*dims) is want


@pytest.mark.parametrize("platform,want", [
    ("gpu", jnp.bfloat16), ("cpu", jnp.float32)])
def test_predicate_dtype(on, platform, want):
    on(platform)
    assert routing.predicate_dtype() == want


def test_rankboost_weak_search_width(monkeypatch):
    """RankBoost's weak search histograms T+1 bins (no padding to 256)."""
    from ranklib_tpu.metrics.base import create_scorer
    from ranklib_tpu.models.rankboost import RankBoost
    from tests.fixtures import synth_dataset

    seen = []
    real = H.hist_xla

    def spy(binned_T, grad, mask, n_bins):
        seen.append(int(n_bins))
        return real(binned_T, grad, mask, n_bins)

    monkeypatch.setattr(H, "hist_xla", spy)
    ds = synth_dataset(n_queries=6, n_features=5, seed=1)
    RankBoost(n_rounds=2, n_threshold=10).fit(ds, create_scorer("NDCG@10"))
    assert seen and all(b <= 11 for b in seen)


def test_platform_is_jax_backend():
    import jax

    assert routing.platform() == jax.default_backend() == "cpu"
    assert not routing.scoring_kernel(9, 10)
