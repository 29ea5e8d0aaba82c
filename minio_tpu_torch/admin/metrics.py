"""Prometheus metrics (``minio_tpu/admin/metrics.py``, the metrics-v2
catalog of cmd/metrics-v2.go), for the families whose sources the port
has.

A process-wide registry of counters and histograms (``GLOBAL``), rendered
in the Prometheus text format at ``/minio-tpu/metrics`` with the gauge
families computed at scrape time from the live server:

  mt_up, mt_uptime_seconds
  mt_s3_*                 per-API requests, errors, rx/tx bytes, TTFB
                          (``s3/server.py``), and the last-minute per-API
                          windows
  mt_tpu_*                codec ops, bytes, kernel seconds, batch blocks,
                          errors (``ops/codec.py``); the ``backend`` label
                          is ``cuda``, ``cpu`` or ``mesh``
  mt_drive_op_seconds     commit phases (``storage/xl_storage.py``)
  mt_cluster_*            drives online and offline, raw capacity
  mt_node_disk_*          per-drive last-minute latency and the slow flag
  mt_put_pipeline_*       writer queues and the last streaming PUT's
                          overlap
  mt_heal_*               the heal sweep's counters and rates

Family names are the reference's, so its dashboards read the port.  A
family that nothing fills is not rendered.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

_START = time.time()

# cmd/metrics-v2.go:69 defaultHistogramBuckets
TTFB_BUCKETS = (0.001, 0.003, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# mt_tpu_kernel_seconds: device ops in microseconds, plain versions on
# the host in tens of milliseconds
KERNEL_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# mt_tpu_batch_blocks: erasure blocks per codec op
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0)


class Metrics:
    def __init__(self):
        self._mu = threading.Lock()
        self._counters: dict[tuple, float] = defaultdict(float)
        # histogram key -> [bucket counts..., +Inf count, sum]
        self._hists: dict[tuple, list] = {}

    def inc(self, name: str, labels: dict[str, str] | None = None,
            value: float = 1.0) -> None:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._mu:
            self._counters[key] += value

    def observe(self, name: str, labels: dict[str, str] | None = None,
                value: float = 0.0,
                buckets: tuple = TTFB_BUCKETS) -> None:
        key = (name, tuple(sorted((labels or {}).items())), buckets)
        with self._mu:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0] * (len(buckets) + 1) + [0.0]
            for i, ub in enumerate(buckets):
                if value <= ub:
                    h[i] += 1
            h[len(buckets)] += 1          # +Inf and _count
            h[-1] += value                # _sum

    def snapshot(self) -> dict[tuple, float]:
        with self._mu:
            return dict(self._counters)

    def hist_snapshot(self) -> dict[tuple, list]:
        with self._mu:
            return {k: list(v) for k, v in self._hists.items()}


GLOBAL = Metrics()


def _escape_label(v) -> str:
    """Backslash, double quote and newline escaped, as the text format
    requires."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Full precision (``%g`` would quantise large byte counters)."""
    return str(int(v)) if v == int(v) else repr(v)


def _fmt_labels(labels: tuple, extra: str = "") -> str:
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    if extra:
        inner = f"{inner},{extra}" if inner else extra
    return "{" + inner + "}" if inner else ""


def render(layer=None, healer=None, config=None, api_stats=None) -> str:
    """The exposition document: counters, histograms and live gauges.
    ``config`` gives the slow-drive knobs at scrape time; ``api_stats``
    is the server's last-minute per-API ``OpWindows``.  Codec ops whose
    device time is still being measured are settled first (those whose
    kernels have finished)."""
    from ..ops import codec
    codec.settle_observations()
    lines = [
        "# HELP mt_up Server is up.",
        "# TYPE mt_up gauge",
        "mt_up 1",
        "# HELP mt_uptime_seconds Process uptime.",
        "# TYPE mt_uptime_seconds gauge",
        f"mt_uptime_seconds {time.time() - _START:.1f}",
    ]
    counters = GLOBAL.snapshot()
    hists = GLOBAL.hist_snapshot()
    # a histogram owns its base name and the derived sample names; a
    # colliding counter is dropped rather than corrupt the family
    seen_names = set()
    reserved = set()
    for (hname, _, _) in hists:
        reserved.update((hname, f"{hname}_bucket", f"{hname}_sum",
                         f"{hname}_count"))
    for (name, labels), value in sorted(counters.items()):
        if name in reserved:
            continue
        if name not in seen_names:
            lines.append(f"# TYPE {name} counter")
            seen_names.add(name)
        lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    for (name, labels, buckets), h in sorted(hists.items()):
        if name not in seen_names:
            lines.append(f"# TYPE {name} histogram")
            seen_names.update((name, f"{name}_bucket", f"{name}_sum",
                               f"{name}_count"))
        for i, ub in enumerate(buckets):
            le = 'le="%g"' % ub
            lines.append(f"{name}_bucket{_fmt_labels(labels, le)} {h[i]}")
        le_inf = 'le="+Inf"'
        lines.append(f"{name}_bucket{_fmt_labels(labels, le_inf)}"
                     f" {h[len(buckets)]}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(h[-1])}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {h[len(buckets)]}")
    sources = []
    if layer is not None:
        sources += [lambda: _cluster_gauges(layer),
                    lambda: _disk_lastminute_gauges(layer, config),
                    lambda: _put_pipeline_gauges(layer)]
    if api_stats is not None:
        sources.append(lambda: _s3_lastminute_gauges(api_stats))
    if healer is not None:
        sources += [lambda: _heal_counters(healer),
                    lambda: _progress_gauges("mt_heal", healer.progress)]
    for fam in sources:
        try:
            lines += fam()
        except Exception:  # noqa: BLE001 — a scrape must never fail
            pass
    return "\n".join(lines) + "\n"


def _collect_disks_with_set(layer) -> list[tuple[int, object]]:
    """(set index, drive) for every drive of the layer; the walk is the
    storage layer's (``health.disks_by_set``), shared with slow-drive
    detection."""
    from ..storage.health import disks_by_set
    return [(si, d) for si, dlist in enumerate(disks_by_set(layer))
            for d in dlist]


def _collect_disks(layer) -> list:
    return [d for _, d in _collect_disks_with_set(layer)]


def _cluster_gauges(layer) -> list[str]:
    """Drives online (those that answer ``disk_info``; an offline one's
    health proxy refuses it) and offline, and their raw capacity."""
    disks = _collect_disks(layer)
    total = free = online = 0
    for d in disks:
        try:
            info = d.disk_info()
        except Exception:  # noqa: BLE001 — an offline drive
            continue
        online += 1
        total += info.total
        free += info.free
    return [
        "# TYPE mt_cluster_disk_online_total gauge",
        f"mt_cluster_disk_online_total {online}",
        "# TYPE mt_cluster_disk_offline_total gauge",
        f"mt_cluster_disk_offline_total {len(disks) - online}",
        "# TYPE mt_cluster_capacity_raw_total_bytes gauge",
        f"mt_cluster_capacity_raw_total_bytes {total}",
        "# TYPE mt_cluster_capacity_raw_free_bytes gauge",
        f"mt_cluster_capacity_raw_free_bytes {free}",
    ]


def _heal_counters(healer) -> list[str]:
    st = healer.stats
    return [
        "# TYPE mt_heal_objects_scanned_total counter",
        f"mt_heal_objects_scanned_total {st.objects_scanned}",
        "# TYPE mt_heal_objects_healed_total counter",
        f"mt_heal_objects_healed_total {st.objects_healed}",
        "# TYPE mt_heal_objects_failed_total counter",
        f"mt_heal_objects_failed_total {st.objects_failed}",
        "# TYPE mt_heal_cycles_total counter",
        f"mt_heal_cycles_total {st.cycles}",
        "# TYPE mt_heal_mrf_queued_total counter",
        f"mt_heal_mrf_queued_total {st.mrf_queued}",
        "# TYPE mt_heal_mrf_healed_total counter",
        f"mt_heal_mrf_healed_total {st.mrf_healed}",
        "# TYPE mt_heal_mrf_dropped_total counter",
        f"mt_heal_mrf_dropped_total {st.mrf_dropped}",
    ]


def _fmt_rate(v: float) -> str:
    return f"{v:.3f}".rstrip("0").rstrip(".") or "0"


def _progress_gauges(prefix: str, progress) -> list[str]:
    """Objects/s and bytes/s of the running cycle (else the last one's)
    and whether a cycle runs."""
    ops, bps = progress.rates()
    return [
        f"# TYPE {prefix}_objects_per_second gauge",
        f"{prefix}_objects_per_second {_fmt_rate(ops)}",
        f"# TYPE {prefix}_bytes_per_second gauge",
        f"{prefix}_bytes_per_second {_fmt_rate(bps)}",
        f"# TYPE {prefix}_cycle_active gauge",
        f"{prefix}_cycle_active {1 if progress.active else 0}",
    ]


def _disk_lastminute_gauges(layer, config=None) -> list[str]:
    """Per-drive last-minute latency and the slow flag (flagged, never
    ejected)."""
    from ..obs.lastminute import drive_windows
    from ..storage.health import slow_drive_knobs, slow_drives_for_layer
    wins = drive_windows(_collect_disks(layer))
    if not wins:
        return []
    lines = [
        "# TYPE mt_node_disk_latency_ops gauge",
        "# TYPE mt_node_disk_latency_ns gauge",
        "# TYPE mt_node_disk_latency_avg_ns gauge",
        "# TYPE mt_node_disk_latency_bytes gauge",
    ]
    for drive in sorted(wins):
        for op, (c, t, b) in sorted(wins[drive].totals().items()):
            lbl = _fmt_labels((("drive", drive), ("op", op)))
            lines.append(f"mt_node_disk_latency_ops{lbl} {c}")
            lines.append(f"mt_node_disk_latency_ns{lbl} {t}")
            lines.append(f"mt_node_disk_latency_avg_ns{lbl}"
                         f" {t // max(c, 1)}")
            lines.append(f"mt_node_disk_latency_bytes{lbl} {b}")
    multiple, min_samples = slow_drive_knobs(config)
    verdicts = slow_drives_for_layer(layer, multiple=multiple,
                                     min_samples=min_samples)
    if verdicts:
        lines += ["# TYPE mt_node_disk_latency_p50_ns gauge",
                  "# TYPE mt_node_disk_latency_p99_ns gauge",
                  "# TYPE mt_node_disk_slow gauge"]
        for drive in sorted(verdicts):
            v = verdicts[drive]
            dl = _fmt_labels((("drive", drive),))
            lines.append(f"mt_node_disk_latency_p50_ns{dl} {v['p50_ns']}")
            lines.append(f"mt_node_disk_latency_p99_ns{dl}"
                         f" {wins[drive].p99_all() if drive in wins else 0}")
            lines.append(f"mt_node_disk_slow{dl} {1 if v['slow'] else 0}")
    return lines


def _put_pipeline_gauges(layer) -> list[str]:
    """Per-drive writer queue depth, enqueue stalls and settled ops, and
    per set the last streaming PUT's overlap efficiency (the slowest
    stage's seconds over the wall: 1.0 when the pipeline hid all but the
    slowest stage) and wall seconds per batch.  A set whose writer plane
    never carried an op renders nothing."""
    drives: list[tuple[str, dict]] = []
    effs: list[tuple[int, dict]] = []
    for si, leaf in enumerate(getattr(layer, "sets", [layer])):
        plane = leaf._write_plane
        if not plane.used:
            continue
        drives += sorted(plane.stats().items())
        ps = leaf.pipe_stats
        if ps.get("wall_s"):
            effs.append((si, ps))
    lines: list[str] = []
    if drives:
        lines += ["# TYPE mt_put_pipeline_queue_depth gauge",
                  "# TYPE mt_put_pipeline_enqueue_stalls_total counter",
                  "# TYPE mt_put_pipeline_writes_total counter"]
        for ep, st in drives:
            lbl = _fmt_labels((("drive", ep),))
            lines.append(f"mt_put_pipeline_queue_depth{lbl}"
                         f" {st['queue_depth']}")
            lines.append(f"mt_put_pipeline_enqueue_stalls_total{lbl}"
                         f" {st['stalls']}")
            lines.append(f"mt_put_pipeline_writes_total{lbl} {st['ops']}")
    if effs:
        lines += ["# TYPE mt_put_pipeline_overlap_efficiency gauge",
                  "# TYPE mt_put_pipeline_batch_wall_seconds gauge"]
        for si, ps in effs:
            lbl = _fmt_labels((("set", str(si)),))
            lines.append(f"mt_put_pipeline_overlap_efficiency{lbl}"
                         f" {_fmt_value(ps['overlap_efficiency'])}")
            lines.append(f"mt_put_pipeline_batch_wall_seconds{lbl}"
                         f" {_fmt_value(ps['wall_s'] / max(1, ps['batches']))}")
    return lines


def _s3_lastminute_gauges(api_stats) -> list[str]:
    """Per-S3-API last-minute request count, mean and p99 latency, and
    bytes."""
    totals = api_stats.totals()
    if not totals:
        return []
    lines = [
        "# TYPE mt_s3_api_last_minute_requests gauge",
        "# TYPE mt_s3_api_last_minute_avg_ns gauge",
        "# TYPE mt_s3_api_last_minute_p99_ns gauge",
        "# TYPE mt_s3_api_last_minute_bytes gauge",
    ]
    for api in sorted(totals):
        c, t, b = totals[api]
        al = _fmt_labels((("api", api),))
        w = api_stats.windows.get(api)
        lines.append(f"mt_s3_api_last_minute_requests{al} {c}")
        lines.append(f"mt_s3_api_last_minute_avg_ns{al} {t // max(c, 1)}")
        lines.append(f"mt_s3_api_last_minute_p99_ns{al}"
                     f" {w.p99() if w is not None else 0}")
        lines.append(f"mt_s3_api_last_minute_bytes{al} {b}")
    return lines
