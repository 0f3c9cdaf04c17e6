"""Flat routing-point router: brute matmul scan + the 4 probe-ranking rules.

Reference parity: ``src/hnsw_router.h``. The reference wraps an hnswlib graph
walk over <=10M routing points labeled with shard ids, then folds the
returned neighbors into per-shard ``min_dist`` and ``frequency``
(``hnsw_router.h:106-119``) and ranks shards with one of four rules:

- ``RoutingQuery``  — all shards sorted by min distance (``:59-64``).
- ``PyramidRoutingQuery`` — only shards seen among the neighbors (``:66-74``).
- ``SPANNRoutingQuery``   — shards within ``(1+eps) * d_closest`` (``:76-85``).
- ``FrequencyQuery``      — shards by vote frequency (``:87-103``).

Redesign: the graph walk is replaced by an exact batched top-T scan of the
routing points (distance matmul + top-k). This returns the *true* T nearest
routing points — i.e. the output HNSW approximates — so all four ranking rules
apply unchanged, as pure array ops. Probe orders use -1 padding where a rule
cuts the list short (Pyramid/SPANN).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import Metric, topk_neighbors


@functools.partial(jax.jit, static_argnames=("num_shards",))
def _fold_votes(neigh_dists, neigh_shards, num_shards: int):
    """Per-query per-shard (min_dist, frequency) from the top-T neighbor list
    (reference hnsw_router.h:106-119)."""
    m, t = neigh_dists.shape
    row = jnp.arange(m)[:, None]
    min_d = jnp.full((m, num_shards), jnp.inf, jnp.float32)
    min_d = min_d.at[row, neigh_shards].min(neigh_dists)
    freq = jnp.zeros((m, num_shards), jnp.int32)
    freq = freq.at[row, neigh_shards].add(1)
    return min_d, freq


def rank_min_dist(min_d: np.ndarray) -> np.ndarray:
    """All shards by min distance; unseen (inf) shards trail (hnsw_router.h:59-64)."""
    return np.argsort(min_d, axis=1, kind="stable").astype(np.int32)


def rank_pyramid(min_d: np.ndarray) -> np.ndarray:
    """Only shards seen among the neighbors (hnsw_router.h:66-74); -1 padded.

    Set-identical to the reference. Intra-list order deviates deliberately:
    the reference emits seen shards in shard-index order but consumes the
    list as a SET (try_increasing_num_shards=false, routes.cpp:74); we emit
    min-dist order, which is strictly better under prefix sweeps.
    """
    order = np.argsort(min_d, axis=1, kind="stable").astype(np.int32)
    seen = np.isfinite(np.take_along_axis(min_d, order, axis=1))
    return np.where(seen, order, -1)


def rank_spann(min_d: np.ndarray, eps: float = 0.6) -> np.ndarray:
    """Shards with min_dist <= (1+eps)*closest (hnsw_router.h:76-85); -1 padded.

    Matches the reference's handling of non-negative distances (L2^2; MIPS
    distances are shifted by the caller if negative values are possible).
    Set-identical to the reference; emitted in min-dist order rather than its
    shard-index order (the list is consumed as a set — see rank_pyramid).
    """
    order = np.argsort(min_d, axis=1, kind="stable").astype(np.int32)
    sorted_d = np.take_along_axis(min_d, order, axis=1)
    closest = sorted_d[:, :1]
    keep = sorted_d <= (1.0 + eps) * closest
    keep &= np.isfinite(sorted_d)
    return np.where(keep, order, -1)


def rank_frequency(freq: np.ndarray, min_d: np.ndarray) -> np.ndarray:
    """Reference FrequencyQuery (hnsw_router.h:87-103): ONLY the single
    highest-frequency shard goes first (ties -> lowest index, matching the
    reference's strict ``>`` scan); every remaining shard — seen or not — is
    ordered purely by min_dist."""
    m, s = freq.shape
    finite_d = np.where(np.isfinite(min_d), min_d, np.float64(3e38))
    top = np.argmax(freq, axis=1)
    key = finite_d.copy()
    key[np.arange(m), top] = -np.inf
    return np.argsort(key, axis=1, kind="stable").astype(np.int32)


class FlatRouter:
    """Routing points + shard labels; exact top-T scan + 4 ranking rules."""

    def __init__(
        self,
        routing_points: np.ndarray,
        shard_labels: np.ndarray,
        num_shards: Optional[int] = None,
        metric: Metric = "l2",
    ) -> None:
        self.points = jnp.asarray(routing_points, jnp.float32)
        self.labels = jnp.asarray(shard_labels, jnp.int32)
        self.labels_np = np.asarray(shard_labels, np.int32)
        self.num_shards = int(num_shards or self.labels_np.max() + 1)
        self.metric: Metric = metric

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def query_votes(
        self, queries: np.ndarray, num_voting_neighbors: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query per-shard (min_dist [m,s], frequency [m,s])."""
        t = min(num_voting_neighbors, len(self))
        dists, ids = topk_neighbors(
            jnp.asarray(queries, jnp.float32), self.points, t, metric=self.metric
        )
        shards = self.labels[ids]
        min_d, freq = _fold_votes(dists, shards, self.num_shards)
        return np.asarray(min_d), np.asarray(freq)

    def query(
        self,
        queries: np.ndarray,
        num_voting_neighbors: int = 120,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
    ) -> np.ndarray:
        """Probe order [m, s] (possibly -1-padded) under the given rule."""
        min_d, freq = self.query_votes(queries, num_voting_neighbors)
        if rule == "min_dist":
            return rank_min_dist(min_d)
        if rule == "pyramid":
            return rank_pyramid(min_d)
        if rule == "spann":
            return rank_spann(min_d, eps=spann_eps)
        if rule == "frequency":
            return rank_frequency(freq, min_d)
        raise ValueError(f"unknown probe rule {rule!r}")

    # -- persistence (sidecar format kept simple; reference saves the hnswlib
    #    index + a partition file, hnsw_router.h:37-53) ----------------------
    def save(self, path: str) -> None:
        np.savez(
            path,
            points=np.asarray(self.points),
            labels=self.labels_np,
            num_shards=self.num_shards,
            metric=self.metric,
        )

    @classmethod
    def load(cls, path: str) -> "FlatRouter":
        z = np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False)
        return cls(
            z["points"], z["labels"], int(z["num_shards"]), str(z["metric"])
        )


def centroid_router(
    points: np.ndarray, clusters, metric: Metric = "l2"
) -> FlatRouter:
    """One centroid per shard — the reference's single-center routing baseline
    (analyze_approximation_losses.cpp:92-142)."""
    cents = np.stack(
        [
            np.asarray(points[np.asarray(c, np.int64)]).mean(axis=0)
            if len(c)
            else np.zeros(points.shape[1], np.float32)
            for c in clusters
        ]
    ).astype(np.float32)
    if metric == "mips":
        norms = np.sqrt(np.maximum((cents**2).sum(1), 1e-12))
        cents = cents / norms[:, None]
    labels = np.arange(len(clusters), dtype=np.int32)
    return FlatRouter(cents, labels, num_shards=len(clusters), metric=metric)
