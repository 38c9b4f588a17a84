"""The ``pio_ann_*`` metric family (port of ``predictionio_tpu/ann/metrics.py``,
under the reference's names).

One instrument set serves both surfaces: the query server registers it so
traffic through a pinned index is visible (probes, candidates scored,
sampled recall), and the stream pipeline registers it so index refreshes
and rebuilds ride the same registry. Registration is eager: the family
exists, at zero, from process start.
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.metrics import MetricsRegistry


class AnnInstruments:
    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.queries = r.counter(
            "pio_ann_queries_total",
            "queries answered through the ANN index (candidate generation "
            "skipped the exact O(corpus) scan)",
        )
        self.fallbacks = r.counter(
            "pio_ann_fallback_total",
            "queries an ANN-capable lane answered exactly instead "
            "(k wider than the probe pool, or a filtered int8 index)",
        )
        self.probes = r.counter("pio_ann_probes_total", "clusters probed, summed over queries")
        self.candidates = r.counter(
            "pio_ann_candidates_total",
            "real (non-pad) candidate items scored, summed over queries",
        )
        self.candidates_frac = r.gauge(
            "pio_ann_candidates_frac",
            "candidates scored per query as a fraction of the corpus "
            "(mean over the last fetched batch)",
        )
        self.recall_sampled = r.gauge(
            "pio_ann_recall_sampled",
            "recall@k of the ANN top-k vs a shadow exact top-k on sampled batches (EWMA)",
        )
        self.recall_samples = r.counter(
            "pio_ann_recall_samples_total",
            "batches shadow-scored exactly for the recall proxy",
        )
        self.index_items = r.gauge(
            "pio_ann_index_items", "corpus items covered by the pinned index", labelnames=("version",)
        )
        self.index_clusters = r.gauge(
            "pio_ann_index_clusters", "clusters in the pinned index", labelnames=("version",)
        )
        self.refreshes = r.counter(
            "pio_ann_refreshes_total",
            "incremental index refreshes (rebucket onto existing centroids) "
            "published by the stream layer",
        )
        self.rebuilds = r.counter(
            "pio_ann_rebuilds_total", "full index rebuilds (drift guard or geometry change)"
        )
        # version-labelled index gauges ever set here: sync_indexes zeroes
        # the retired ones
        self._known_versions: set[str] = set()

    def set_index(self, version: str, items: float, clusters: float) -> None:
        self.index_items.set(float(items), version=version)
        self.index_clusters.set(float(clusters), version=version)
        self._known_versions = self._known_versions | {version}

    def sync_indexes(self, indexes: dict[str, tuple[float, float]]) -> None:
        """Reconcile the version-labelled gauges with the indexes pinned
        now: set every live series, zero every known version no longer
        pinned, so a reloaded lane's old version stops showing as pinned."""
        for version, (items, clusters) in indexes.items():
            self.set_index(version, items, clusters)
        for stale in self._known_versions - set(indexes):
            self.index_items.set(0.0, version=stale)
            self.index_clusters.set(0.0, version=stale)
        self._known_versions = set(indexes)
