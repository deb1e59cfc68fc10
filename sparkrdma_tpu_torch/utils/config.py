"""TpuShuffleConf — all framework tunables, range-clamped.

TPU-native analogue of RdmaShuffleConf.scala (reference: RdmaShuffleConf.scala:47-126).
Every getter clamps out-of-range values back to the default, silently,
exactly like the reference's ``getConfKey`` helpers (:47-58). Keys are
prefixed ``tpu.shuffle.`` (reference prefix: ``spark.shuffle.rdma.``).

The defaults reproduce the reference's tuned 100GbE operating point
(queue depths 2048/4096, 4 KiB RPC segments, 8 MiB blocks, 128 MiB
in-flight cap, 25 GiB in-memory budget), plus TPU-only knobs for the
device exchange plane (bucket sizes, mesh axes).

A copy of the JAX package's ``utils/config.py``: the same keys, defaults
and clamping, so one conf dict serves both packages. One getter differs:
``transport=auto`` raises where g++ is present but the native plane
fails to build, where the JAX getter quietly picks ``python``.
"""

from __future__ import annotations

import enum
import os
from typing import Dict, Optional

from sparkrdma_tpu_torch.utils.units import parse_bytes


class ShuffleWriterMethod(enum.Enum):
    """Reference: ShuffleWriterMethod enum, RdmaShuffleConf.scala:24-28."""

    WRAPPER = "wrapper"
    CHUNKED_PARTITION_AGG = "chunkedpartitionagg"

    @classmethod
    def parse(cls, s: str) -> "ShuffleWriterMethod":
        s = s.strip().lower()
        for m in cls:
            if m.value == s:
                return m
        raise ValueError(
            f"unknown shuffle writer method {s!r}; "
            f"expected one of {[m.value for m in cls]}"
        )


PREFIX = "tpu.shuffle."

# -- declared-knobs registry ----------------------------------------------
# Every tpu.shuffle.* key the framework understands, by suffix. This is
# the single source of truth the knob-registry analysis pass resolves
# reads against (the JAX package's analysis/knobs.py): a literal key that
# is not here — in library code, tests, or benches — fails the lint, so
# typo'd knobs die in CI instead of silently falling back to defaults.
# Keep entries in the same order as the property getters below.
DECLARED_KNOBS: Dict[str, str] = {
    "recvQueueDepth": "receive queue depth (transport)",
    "sendQueueDepth": "send queue depth (transport)",
    "recvWrSize": "RPC segment size in bytes",
    "cpuList": "worker thread placement list",
    "shuffleWriteMethod": "writer strategy (wrapper|chunkedpartitionagg)",
    "shuffleWriteChunkSize": "chunked-agg chunk size",
    "shuffleWriteFlushSize": "wrapper writer flush size",
    "shuffleWriteBlockSize": "writer block size",
    "shuffleWriteMaxInMemoryStoragePerExecutor": "in-memory write budget",
    "shuffleReadBlockSize": "reader block size",
    "maxBytesInFlight": "reader in-flight byte cap",
    "maxAggBlock": "aggregation block size",
    "maxAggPrealloc": "preallocated agg buffers per executor",
    "collectShuffleReadStats": "collect reader fetch-time stats",
    "fetchTimeNumBuckets": "reader stats: histogram buckets",
    "fetchTimeBucketSizeInMs": "reader stats: bucket width",
    "obs.traceEnabled": "record spans in the per-role tracers",
    "obs.traceMaxSpans": "retained spans per tracer",
    "obs.critpath.enabled": "per-job critical-path TimeBreakdown",
    "obs.telemetry.enabled": "heartbeat loops + driver TelemetryHub",
    "obs.telemetry.intervalMs": "heartbeat period / ring bucket width",
    "obs.telemetry.ringSize": "windows retained per executor",
    "obs.telemetry.httpPort": "OpenMetrics scrape port (0 = off)",
    "obs.telemetry.stragglerZ": "robust z threshold for stragglers",
    "obs.telemetry.flightWindows": "ring windows per flight record",
    "obs.telemetry.flightDir": "flight-record output directory",
    "obs.telemetry.openmetricsFile": "periodic OpenMetrics file egress",
    "obs.profile.enabled": "always-on wall-clock sampling profiler",
    "obs.profile.hz": "profiler sampling rate (samples/s per thread)",
    "obs.profile.maxFrames": "deepest stack recorded per sample",
    "obs.profile.windowMs": "recent-sample window (flight records, "
                            "gap-frame annotation)",
    "obs.slo.enabled": "SLO burn-rate engine on the telemetry hub",
    "obs.slo.evalIntervalMs": "min period between SLO evaluations",
    "obs.slo.taskP99Ms": "p99 task-latency objective target (0 = off)",
    "obs.slo.queueWaitP99Ms": "p99 admission-wait objective (0 = off)",
    "obs.slo.errorRatio": "fetch error-ratio budget (bad/total)",
    "obs.slo.throughputFloorMBps": "write-throughput floor (0 = off)",
    "obs.slo.fastWindows": "fast-burn horizon in ring windows",
    "obs.slo.slowWindows": "slow-burn horizon in ring windows",
    "obs.slo.fastBurn": "burn-rate multiple that pages",
    "obs.slo.slowBurn": "burn-rate multiple that warns",
    "obs.journal.enabled": "HLC-ordered cluster event journal",
    "obs.journal.ringSize": "events retained per process journal",
    "obs.journal.flightEvents": "merged events per flight record",
    "obs.capacity.enabled": "USE-method capacity plane on the hub",
    "obs.capacity.evalIntervalMs": "min period between USE evaluations",
    "driverHost": "driver RPC host",
    "driverPort": "driver RPC port (0 = ephemeral, written back)",
    "executorPort": "executor listener port (0 = ephemeral)",
    "portMaxRetries": "bind retries above the base port",
    "connectTimeoutMs": "connection establishment timeout",
    "teardownListenTimeoutMs": "listener teardown join timeout",
    "maxConnectionAttempts": "connect attempts per channel",
    "partitionLocationFetchTimeoutMs": "driver location-fetch timeout",
    "resilience.checksums": "crc32c publish/verify per block",
    "resilience.maxFetchAttempts": "total attempts per group READ",
    "resilience.retryBackoffMs": "retry backoff base",
    "resilience.retryBackoffMaxMs": "retry backoff ceiling",
    "resilience.fetchDeadlineMs": "wall budget per group (0 = none)",
    "resilience.circuitFailureThreshold": "failures that open a breaker",
    "resilience.circuitOpenMs": "open-circuit fail-fast window",
    "faultPlan": "fault-injection plan spec (testing/faults.py)",
    "faultPlanSeed": "fault-plan RNG seed",
    "map.parallelism": "bounded map-task pool size",
    "map.pipelineDepth": "map pipeline inter-stage queue bound",
    "map.deviceSort": "sort + range-partition map shards on-device",
    "map.incrementalPublish": "publish sealed writer blocks early",
    "reduce.parallelism": "reduce decode-pool size",
    "reduce.pipelineDepth": "reduce pipeline inter-stage queue bound",
    "reduce.doubleBufferStaging": "overlap staging and device merge",
    "block.format": "block payload encoding: auto|columnar|pickle",
    "block.columnarBatchRows": "records per columnar frame batch",
    "push.enabled": "push-based merge of sealed blocks",
    "push.maxBufferBytes": "merge-endpoint buffered push budget",
    "publish.checksumWorkers": "publish checksum pool size (0 = inline)",
    "planner.enabled": "adaptive reduce-partition planner",
    "planner.hotFactor": "hot-partition isolation threshold",
    "planner.sampleSize": "keys sampled per shard for planning",
    "reader.sortSpillThreshold": "external-sorter in-memory record cap",
    "transport": "host data plane: auto|python|native",
    "fileFastPath": "native same-host READ_FILE fast path",
    "forceSendfile": "serve file regions via sendfile to loopback",
    "fileWorkers": "native same-host file-task workers",
    "mappedFetch": "zero-copy mmap delivery on native transport",
    "native.readBackend": "submission-plane backend: auto|iouring|pread|mapped",
    "native.consumeWorkers": "completion-consume lanes on the native CQ",
    "exchange.bucketMin": "smallest padded exchange bucket",
    "exchange.bucketMax": "largest padded exchange bucket",
    "hbm.slabBytes": "HBM staging slab size",
    "hbm.maxBytes": "HBM shuffle-staging budget",
    "hbm.hostSpillMaxBytes": "host-RAM cap for spilled slabs",
    "hbm.spillDir": "disk-tier spill directory",
    "deviceFetch.enabled": "HBM->HBM device fetch plane",
    "deviceFetch.minBlockBytes": "device-plane minimum block size",
    "collective.enabled": "whole-stage collective shuffle compiler",
    "collective.minBlocks": "device blocks needed to engage the compiler",
    "collective.schedule": "collective schedule: auto|ring|a2a",
    "collective.waveBytes": "max payload bytes per DMA wave",
    "collective.fusedMerge": "allow fetch+merge fusion in one epoch",
    "collective.laneBalance": "planner balances DMA lanes, not just bytes",
    "collective.pipelineDepth": "in-flight DMA waves in the double-buffered pipeline",
    "collective.autoTune": "attribution-driven per-stage waveBytes self-tuning",
    "tenancy.enabled": "multi-tenant serving layer",
    "tenancy.maxConcurrentJobs": "admission in-flight job cap",
    "tenancy.admitTimeoutMs": "admission queue deadline",
    "tenancy.weights": "fair-share weights, e.g. alice:4,bob:1",
    "tenancy.defaultWeight": "weight for unnamed tenants",
    "tenancy.quantumMs": "DRR credit per round (ms per unit weight)",
    "tenancy.mempoolQuotaBytes": "per-tenant mempool byte quota (0 = off)",
    "tenancy.hbmQuotaBytes": "per-tenant HBM byte quota (0 = off)",
    "tenancy.pageCacheQuotaBytes": "per-tenant mapped-fetch byte quota (0 = off)",
    "tenancy.quotaBlockMaxMs": "max quota backpressure stall",
    "elastic.replicas": "map-output replicas pushed to peers (0 = off)",
    "elastic.speculation": "clone straggler tasks onto healthy peers",
    "elastic.speculationCheckMs": "straggler poll period while reducing",
    "elastic.maxRecoveries": "executor-loss recoveries per stage",
    "metastore.peers": "logical metadata peers the registry shards over",
    "metastore.vnodes": "virtual nodes per metadata peer on the hash ring",
    "metastore.rangeSize": "consecutive partitions sharing one shard key",
    "metastore.leaseTtlMs": "shard lease time-to-live",
    "metastore.replicas": "follower copies per metadata shard (0 = off)",
    "metastore.maxWriteAttempts": "epoch-fenced write attempts before failing",
    "metastore.retryBackoffMs": "base backoff between stale-epoch retries",
}

# Knob families with a free segment (``<seg>`` = one dot-free token),
# e.g. per-tenant quota overrides scanned by tenancy/quota.py.
PATTERN_KNOBS = (
    "tenancy.quota.<seg>.mempoolBytes",
    "tenancy.quota.<seg>.hbmBytes",
    "tenancy.quota.<seg>.pageCacheBytes",
    "obs.slo.tenant.<seg>.taskP99Ms",
)


class TpuShuffleConf:
    """Dict-backed configuration with clamped typed getters.

    Construct from any mapping of ``tpu.shuffle.*`` keys. Unknown keys are
    kept (so higher layers can define their own), typed getters clamp to
    [min, max] with silent fallback to the default — reference behavior at
    RdmaShuffleConf.scala:47-58.
    """

    def __init__(self, conf: Optional[Dict[str, object]] = None):
        self._conf: Dict[str, str] = {}
        if conf:
            for k, v in conf.items():
                self._conf[str(k)] = str(v)

    # -- raw access -------------------------------------------------------
    def set(self, key: str, value: object) -> "TpuShuffleConf":
        self._conf[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    def contains(self, key: str) -> bool:
        return key in self._conf

    def to_dict(self) -> Dict[str, str]:
        return dict(self._conf)

    def unknown_keys(self) -> list:
        """``tpu.shuffle.*`` keys present but not declared — the
        runtime complement of the knob-registry lint: surface typo'd
        keys in a live conf instead of silently using defaults."""
        import re

        pats = [
            re.compile(
                "^" + re.escape(p).replace(re.escape("<seg>"), r"[^.]+") + "$"
            )
            for p in PATTERN_KNOBS
        ]
        out = []
        for key in self._conf:
            if not key.startswith(PREFIX):
                continue
            suffix = key[len(PREFIX):]
            if suffix in DECLARED_KNOBS:
                continue
            if any(p.match(suffix) for p in pats):
                continue
            out.append(key)
        return sorted(out)

    # -- clamped typed getters (RdmaShuffleConf.scala:47-58) --------------
    def _int(self, key: str, default: int, lo: int, hi: int) -> int:
        raw = self._conf.get(PREFIX + key)
        if raw is None:
            return default
        try:
            v = int(raw)
        except ValueError:
            return default
        return v if lo <= v <= hi else default

    def _bytes(self, key: str, default: str, lo: int, hi: int) -> int:
        raw = self._conf.get(PREFIX + key, default)
        try:
            v = parse_bytes(raw)
        except ValueError:
            v = parse_bytes(default)
        if not (lo <= v <= hi):
            v = parse_bytes(default)
        return v

    def _float(self, key: str, default: float, lo: float, hi: float) -> float:
        raw = self._conf.get(PREFIX + key)
        if raw is None:
            return default
        try:
            v = float(raw)
        except ValueError:
            return default
        return v if lo <= v <= hi else default

    def _bool(self, key: str, default: bool) -> bool:
        raw = self._conf.get(PREFIX + key)
        if raw is None:
            return default
        return raw.strip().lower() in ("1", "true", "yes", "on")

    # -- transport queue shape (RdmaShuffleConf.scala:72-74) --------------
    @property
    def recv_queue_depth(self) -> int:
        return self._int("recvQueueDepth", 2048, 256, 65535)

    @property
    def send_queue_depth(self) -> int:
        return self._int("sendQueueDepth", 4096, 256, 65535)

    @property
    def recv_wr_size(self) -> int:
        """RPC segment size in bytes (reference default 4 KiB)."""
        return int(self._bytes("recvWrSize", "4k", 2048, 1 << 20))

    # -- worker thread placement (RdmaShuffleConf.scala:79) ---------------
    @property
    def cpu_list(self) -> str:
        return self._conf.get(PREFIX + "cpuList", "")

    # -- writer strategy (RdmaShuffleConf.scala:84-93) --------------------
    @property
    def shuffle_writer_method(self) -> ShuffleWriterMethod:
        raw = self._conf.get(PREFIX + "shuffleWriteMethod", "wrapper")
        try:
            return ShuffleWriterMethod.parse(raw)
        except ValueError:
            return ShuffleWriterMethod.WRAPPER

    @property
    def shuffle_write_chunk_size(self) -> int:
        return self._bytes("shuffleWriteChunkSize", "128k", 4096, 1 << 30)

    @property
    def shuffle_write_flush_size(self) -> int:
        return self._bytes("shuffleWriteFlushSize", "256k", 4096, 1 << 30)

    @property
    def shuffle_write_block_size(self) -> int:
        return self._bytes("shuffleWriteBlockSize", "8m", 65536, 1 << 31)

    @property
    def shuffle_write_max_inmemory_per_executor(self) -> int:
        return self._bytes(
            "shuffleWriteMaxInMemoryStoragePerExecutor", "25g", 0, 1 << 44
        )

    # -- read path (RdmaShuffleConf.scala:99-104) -------------------------
    @property
    def shuffle_read_block_size(self) -> int:
        return self._bytes("shuffleReadBlockSize", "8m", 65536, 1 << 31)

    @property
    def max_bytes_in_flight(self) -> int:
        return self._bytes("maxBytesInFlight", "128m", 65536, 1 << 40)

    @property
    def max_agg_block(self) -> int:
        return self._bytes("maxAggBlock", "2m", 65536, 1 << 31)

    @property
    def max_agg_prealloc(self) -> int:
        return self._int("maxAggPrealloc", 0, 0, 1 << 20)

    # -- reader stats (RdmaShuffleConf.scala:106-113) ---------------------
    @property
    def collect_shuffle_read_stats(self) -> bool:
        return self._bool("collectShuffleReadStats", False)

    @property
    def fetch_time_num_buckets(self) -> int:
        return self._int("fetchTimeNumBuckets", 5, 1, 1000)

    @property
    def fetch_time_bucket_size_ms(self) -> int:
        return self._int("fetchTimeBucketSizeInMs", 300, 1, 1 << 30)

    # -- observability (obs/: metrics registry + span tracer) -------------
    @property
    def trace_enabled(self) -> bool:
        """Record spans in the per-role tracers (obs/trace.py). Metrics
        counters are always on; only span recording is gated."""
        return self._bool("obs.traceEnabled", True)

    @property
    def trace_max_spans(self) -> int:
        """Bound on retained spans per tracer (oldest evicted first)."""
        return self._int("obs.traceMaxSpans", 20000, 100, 1 << 24)

    @property
    def critpath_enabled(self) -> bool:
        """Build the per-job critical-path TimeBreakdown after every
        ``run_job`` (obs/critpath.py / obs/attr.py). Requires span
        recording; a no-op when ``obs.traceEnabled`` is false."""
        return self._bool("obs.critpath.enabled", True)

    # -- cluster telemetry plane (obs/telemetry.py) -----------------------
    @property
    def telemetry_enabled(self) -> bool:
        """Run the executor heartbeat loops + driver TelemetryHub."""
        return self._bool("obs.telemetry.enabled", True)

    @property
    def telemetry_interval_ms(self) -> int:
        """Heartbeat period; also the hub's ring-buffer wall-bucket width."""
        return self._int("obs.telemetry.intervalMs", 1000, 10, 600000)

    @property
    def telemetry_ring_size(self) -> int:
        """Windows retained per executor on the driver (bounded memory)."""
        return self._int("obs.telemetry.ringSize", 128, 8, 65536)

    @property
    def telemetry_http_port(self) -> int:
        """OpenMetrics scrape port on the driver; 0 disables the server."""
        return self._int("obs.telemetry.httpPort", 0, 0, 65535)

    @property
    def telemetry_straggler_z(self) -> float:
        """Robust z-score threshold for the straggler/skew detector."""
        return float(self._int("obs.telemetry.stragglerZ", 3, 1, 1000))

    @property
    def telemetry_flight_windows(self) -> int:
        """Ring windows per executor dumped into a flight record."""
        return self._int("obs.telemetry.flightWindows", 16, 1, 65536)

    @property
    def telemetry_flight_dir(self) -> str:
        """Directory for flight-record JSONs; "" = system temp dir."""
        return str(self.get(PREFIX + "obs.telemetry.flightDir", "") or "")

    @property
    def telemetry_openmetrics_file(self) -> str:
        """If set, the hub rewrites this file with the OpenMetrics
        exposition once per interval (scrape-less egress)."""
        return str(self.get(PREFIX + "obs.telemetry.openmetricsFile", "") or "")

    # -- continuous profiling plane (obs/profiler.py) ---------------------
    @property
    def profile_enabled(self) -> bool:
        """Wall-clock sampling profiler (one timer thread per process)."""
        return self._bool("obs.profile.enabled", True)

    @property
    def profile_hz(self) -> int:
        """Sampling rate. 19 Hz default: high enough to attribute
        ≥100 ms gaps, low enough for the ≤2% overhead gate, and prime
        so it can't phase-lock with periodic workload timers."""
        return self._int("obs.profile.hz", 19, 1, 997)

    @property
    def profile_max_frames(self) -> int:
        """Deepest stack recorded per sample (leaf-most frames kept)."""
        return self._int("obs.profile.maxFrames", 48, 4, 512)

    @property
    def profile_window_ms(self) -> int:
        """Trailing window served to flight records and critical-path
        gap-frame annotation."""
        return self._int("obs.profile.windowMs", 2000, 100, 600000)

    # -- SLO engine + automated diagnosis (obs/slo.py, obs/diagnose.py) ---
    @property
    def slo_enabled(self) -> bool:
        """Evaluate declared objectives on the driver TelemetryHub."""
        return self._bool("obs.slo.enabled", True)

    @property
    def slo_eval_interval_ms(self) -> int:
        """Minimum period between SLO evaluation passes (the engine
        rides the heartbeat ingest path on this cadence)."""
        return self._int("obs.slo.evalIntervalMs", 2000, 100, 600000)

    @property
    def slo_task_p99_ms(self) -> int:
        """p99 task-latency objective target in ms; 0 leaves the
        objective uninstalled (no false pages on unknown workloads)."""
        return self._int("obs.slo.taskP99Ms", 0, 0, 600000)

    @property
    def slo_queue_wait_p99_ms(self) -> int:
        """p99 admission queue-wait objective target in ms; 0 = off."""
        return self._int("obs.slo.queueWaitP99Ms", 0, 0, 600000)

    @property
    def slo_error_ratio(self) -> float:
        """Error budget for the fetch error-ratio objective
        (bad READs / total READs)."""
        return self._float("obs.slo.errorRatio", 0.02, 1e-6, 1.0)

    @property
    def slo_throughput_floor_mbps(self) -> float:
        """Active-window write-throughput floor in MB/s; 0 = off."""
        return self._float("obs.slo.throughputFloorMBps", 0.0, 0.0, 1e9)

    @property
    def slo_fast_windows(self) -> int:
        """Fast-burn (page) horizon in ring windows."""
        return self._int("obs.slo.fastWindows", 8, 1, 65536)

    @property
    def slo_slow_windows(self) -> int:
        """Slow-burn (warn) horizon in ring windows."""
        return self._int("obs.slo.slowWindows", 32, 1, 65536)

    @property
    def slo_fast_burn(self) -> float:
        """Burn-rate multiple of the error budget that pages."""
        return self._float("obs.slo.fastBurn", 8.0, 1.0, 1e6)

    @property
    def slo_slow_burn(self) -> float:
        """Burn-rate multiple of the error budget that warns."""
        return self._float("obs.slo.slowBurn", 2.0, 1.0, 1e6)

    def slo_tenant_task_p99_ms(self, tenant: str) -> int:
        """Per-tenant p99 task-latency target; falls back to the global
        ``obs.slo.taskP99Ms`` (0 = no objective for that tenant)."""
        return self._int(f"obs.slo.tenant.{tenant}.taskP99Ms",
                         self.slo_task_p99_ms, 0, 600000)

    # -- cluster event journal + capacity plane (obs/journal.py,
    #    obs/capacity.py; docs/OBSERVABILITY.md)
    @property
    def journal_enabled(self) -> bool:
        """HLC-ordered cluster event journal; off leaves every
        ``journal.emit`` call site a single None check."""
        return self._bool("obs.journal.enabled", True)

    @property
    def journal_ring_size(self) -> int:
        """Events retained per process journal (hub merge keeps 4x)."""
        return self._int("obs.journal.ringSize", 512, 8, 65536)

    @property
    def journal_flight_events(self) -> int:
        """Merged journal events attached to each flight record."""
        return self._int("obs.journal.flightEvents", 64, 1, 4096)

    @property
    def capacity_enabled(self) -> bool:
        """USE-method capacity accounting on the telemetry hub."""
        return self._bool("obs.capacity.enabled", True)

    @property
    def capacity_eval_interval_ms(self) -> int:
        """Minimum period between hub-side USE evaluations."""
        return self._int("obs.capacity.evalIntervalMs", 2000, 10, 3600000)

    # -- endpoints / connection management (RdmaShuffleConf.scala:118-126)
    @property
    def driver_host(self) -> str:
        return self._conf.get(PREFIX + "driverHost", "127.0.0.1")

    @property
    def driver_port(self) -> int:
        return self._int("driverPort", 0, 0, 65535)

    def set_driver_port(self, port: int) -> None:
        """Write back the negotiated listener port so executors inherit it.

        Reference: the single mutable key, RdmaShuffleConf.scala:67 /
        RdmaShuffleManager.scala:183-184.
        """
        self._conf[PREFIX + "driverPort"] = str(port)

    @property
    def executor_port(self) -> int:
        return self._int("executorPort", 0, 0, 65535)

    @property
    def port_max_retries(self) -> int:
        return self._int("portMaxRetries", 16, 1, 1024)

    @property
    def connect_timeout_ms(self) -> int:
        """CM-event analogue timeout (reference rdmaCmEventTimeout 20s)."""
        return self._int("connectTimeoutMs", 20000, 100, 1 << 30)

    @property
    def teardown_timeout_ms(self) -> int:
        return self._int("teardownListenTimeoutMs", 50, 1, 1 << 30)

    @property
    def max_connection_attempts(self) -> int:
        return self._int("maxConnectionAttempts", 5, 1, 100)

    @property
    def fetch_location_timeout_ms(self) -> int:
        """Timeout for driver location fetches (fetcher iterator wrapper)."""
        return self._int("partitionLocationFetchTimeoutMs", 30000, 100, 1 << 30)

    # -- resilience (retry / checksums / circuit breaker; docs/RESILIENCE.md)
    @property
    def resilience_checksums(self) -> bool:
        """Compute per-block crc32c at publish time and validate on
        fetch (utils/checksum.py). Mismatch = retryable fault."""
        return self._bool("resilience.checksums", True)

    @property
    def max_fetch_attempts(self) -> int:
        """Total attempts per group READ before FetchFailedError:
        initial, same-source retry, re-resolve failover, split."""
        return self._int("resilience.maxFetchAttempts", 4, 1, 100)

    @property
    def retry_backoff_ms(self) -> int:
        """Base of the exponential retry backoff (deterministic jitter)."""
        return self._int("resilience.retryBackoffMs", 50, 1, 1 << 20)

    @property
    def retry_backoff_max_ms(self) -> int:
        return self._int("resilience.retryBackoffMaxMs", 2000, 1, 1 << 24)

    @property
    def fetch_deadline_ms(self) -> int:
        """Wall budget per group across ALL its retries; 0 = unbounded."""
        return self._int("resilience.fetchDeadlineMs", 0, 0, 1 << 30)

    @property
    def circuit_failure_threshold(self) -> int:
        """Consecutive failures that open a peer's circuit breaker."""
        return self._int("resilience.circuitFailureThreshold", 3, 1, 1 << 16)

    @property
    def circuit_open_ms(self) -> int:
        """How long an open circuit fails fast before a half-open probe."""
        return self._int("resilience.circuitOpenMs", 5000, 1, 1 << 30)

    # -- fault injection (testing/faults.py) ------------------------------
    @property
    def fault_plan(self) -> str:
        """Fault-plan spec installed at manager init (empty = none);
        grammar in testing/faults.py. Chaos runs set this plus
        ``faultPlanSeed`` so failures reproduce exactly."""
        return str(self.get(PREFIX + "faultPlan", "") or "")

    @property
    def fault_plan_seed(self) -> int:
        return self._int("faultPlanSeed", 0, 0, 1 << 31)

    # -- map plane (pipelined device-accelerated producer; DESIGN.md) -----
    @property
    def map_parallelism(self) -> int:
        """Bounded map-task pool size per executor process. Map tasks
        dispatch through this pool instead of a sequential loop, so one
        executor overlaps several shards' sort/stage/publish stages."""
        return self._int("map.parallelism", 2, 1, 64)

    @property
    def map_pipeline_depth(self) -> int:
        """Bound on items queued between pipeline stages (sort ->
        stage-into-registered -> publish). Depth 1 still overlaps
        adjacent stages; deeper queues absorb stage-time jitter at the
        cost of holding more shards' staging memory live."""
        return self._int("map.pipelineDepth", 2, 1, 64)

    @property
    def map_device_sort(self) -> bool:
        """Sort + range-partition map shards ON-DEVICE (MapShardSorter:
        device_sort + searchsorted against the reducer edges) instead of
        the host O(N log N) np.sort the map plane was losing on."""
        return self._bool("map.deviceSort", True)

    @property
    def map_incremental_publish(self) -> bool:
        """Chunked-agg incremental publish: sealed (non-tail, immutable)
        writer blocks publish their locations as map tasks commit, so
        location upload overlaps remaining map compute; the map-barrier
        count still rides ONLY the final publish (num_map_outputs=0 on
        incremental segments), so the driver never answers fetches from
        a partial location set."""
        return self._bool("map.incrementalPublish", False)

    # -- reduce plane (pipelined consume; DESIGN.md §16) ------------------
    @property
    def reduce_parallelism(self) -> int:
        """Decode-pool size of the reduce pipeline: workers doing
        checksum verify + decompress + deserialize off the fetch
        thread. 1 degenerates to the serial decode order exactly (the
        sequencer preserves delivery order at ANY parallelism)."""
        return self._int("reduce.parallelism", 2, 1, 64)

    @property
    def reduce_pipeline_depth(self) -> int:
        """Bound on items queued between reduce-pipeline stages (fetch
        -> decode pool -> stage -> merge/deliver). Depth 1 still
        overlaps adjacent stages; deeper queues absorb jitter at the
        cost of holding more fetched groups' memory live."""
        return self._int("reduce.pipelineDepth", 2, 1, 64)

    @property
    def reduce_double_buffer_staging(self) -> bool:
        """Run host->HBM staging and device merge on separate pipeline
        threads so the host->device transfer of group k+1 rides under the
        merge of group k (double-buffered staging). Off serializes
        stage and merge on one thread."""
        return self._bool("reduce.doubleBufferStaging", True)

    # -- block payload format (shuffle/columnar.py; DESIGN.md §25) --------
    @property
    def block_format(self) -> str:
        """Per-shuffle block payload encoding negotiation: ``pickle``
        is the legacy frame stream (the universal fallback),
        ``columnar`` batches fixed-width numpy tuples into zero-copy
        column-vector frames (per-batch pickle fallback for anything
        the layout cannot carry), ``auto`` sniffs the first record and
        picks. Unknown values fall back to ``auto``."""
        raw = (self._conf.get(PREFIX + "block.format") or "auto").strip().lower()
        return raw if raw in ("auto", "columnar", "pickle") else "auto"

    @property
    def block_columnar_batch_rows(self) -> int:
        """Records accumulated per columnar frame batch: larger batches
        amortize the header and widen the column vectors the collective
        waves DMA; smaller batches bound the writer's batching memory."""
        return self._int("block.columnarBatchRows", 4096, 16, 1 << 22)

    # -- push-based merge plane (shuffle/merge.py; DESIGN.md §18) ---------
    @property
    def push_enabled(self) -> bool:
        """Push sealed chunked-agg writer blocks toward their reducer's
        executor as maps commit; complete pid coverage seals into ONE
        merged segment the reduce path prefers over N per-map fetches.
        Best-effort everywhere: a dropped/late/over-budget push just
        leaves the original per-map locations authoritative."""
        return self._bool("push.enabled", True)

    @property
    def push_max_buffer_bytes(self) -> int:
        """Per-executor budget for buffered pushed-but-unsealed block
        payloads in its MergeEndpoint. A push that would exceed it is
        dropped (its partition falls back to original locations)."""
        return self._bytes("push.maxBufferBytes", "256m", 1 << 16, 1 << 40)

    @property
    def publish_checksum_workers(self) -> int:
        """Shard ``publish_partition_locations``' checksum/validation
        work across a small pool when a publish carries at least
        2x this many locations; 0 computes inline on the publishing
        thread (the pre-PR-7 behavior)."""
        return self._int("publish.checksumWorkers", 4, 0, 32)

    # -- adaptive partition planner (shuffle/planner.py) ------------------
    @property
    def planner_enabled(self) -> bool:
        """Re-plan reduce partition ranges from the map stage's
        per-partition byte statistics before reduce launch: hot
        partitions are isolated (splits), tiny neighbors coalesced —
        contiguous-range rule, so ordering workloads stay correct."""
        return self._bool("planner.enabled", True)

    @property
    def planner_hot_factor(self) -> float:
        """A partition is *hot* (isolated into its own reduce range)
        when its bytes exceed this multiple of the mean reducer load."""
        raw = self._conf.get(PREFIX + "planner.hotFactor")
        try:
            v = float(raw) if raw is not None else 1.5
        except ValueError:
            v = 1.5
        return v if 1.0 <= v <= 100.0 else 1.5

    @property
    def planner_sample_size(self) -> int:
        """Keys sampled per shard for the device planner's quantile
        edges (models/terasort.py adaptive sort)."""
        return self._int("planner.sampleSize", 4096, 64, 1 << 24)

    # -- reduce-side ordering ---------------------------------------------
    @property
    def sort_spill_threshold(self) -> int:
        """Records held in memory before the reader's external sorter
        spills a sorted run to scratch (the ExternalSorter role)."""
        return self._int("reader.sortSpillThreshold", 1 << 20, 1024, 1 << 31)

    # -- transport selection ----------------------------------------------
    @property
    def transport(self) -> str:
        """Host transport data plane: ``auto`` (default), ``python`` or
        ``native`` (C++ epoll loop, sparkrdma_tpu_torch/native/transport.cpp).
        Both speak the same wire format and interoperate. ``auto``
        resolves to native as in the JAX package: where g++ is present
        (``transport_lib.toolchain_available()``), and then a failed
        build raises ``NativeBuildError`` instead of hiding the breakage
        behind the python plane; without g++, ``auto`` is ``python``.
        ``transport=python`` is the escape hatch back to the pure-Python
        plane."""
        raw = (self._conf.get(PREFIX + "transport", "auto") or "auto").lower()
        if raw not in ("python", "native", "auto"):
            raw = "auto"
        if raw == "auto":
            from sparkrdma_tpu_torch.native import transport_lib

            if not transport_lib.toolchain_available():
                return "python"
            transport_lib.require()
            return "native"
        return raw

    @property
    def file_fastpath(self) -> bool:
        """Allow the native client's same-host READ_FILE fast path for
        plain (buffer-destination) READs. Off forces every such READ
        through the streamed socket path — the bench's remote-path
        simulation knob. Mapped READs always probe the file path."""
        return self._bool("fileFastPath", True)

    @property
    def force_sendfile(self) -> bool:
        """Server-side: serve file-backed regions via sendfile even to
        loopback peers. Normally loopback keeps the userspace send
        (measured faster without a DMA NIC); tests and benches of the
        sendfile mechanism itself enable this."""
        return self._bool("forceSendfile", False)

    @property
    def file_workers(self) -> int:
        """Same-host file-task worker threads in the native plane.
        Concurrent read groups overlap their page-cache copies — the
        analogue of the reference striping WR lists over multiple QPs
        (RdmaChannel.java:54-56). Default 2: measured on the bench rig,
        2 workers move ~1.5x one worker even at nproc=1 (kernel-side
        parallelism); more shows no further gain there."""
        return self._int("fileWorkers", 2, 1, 16)

    @property
    def mapped_fetch(self) -> bool:
        """Use mapped delivery (zero-copy page-cache mmap on same-host
        peers) for device-block fetches on the native transport. The
        streamed fallback still lands in one malloc'd blob, so this is
        never slower than the buffer path; off restores pooled
        registered destination buffers."""
        return self._bool("mappedFetch", True)

    @property
    def native_read_backend(self) -> str:
        """Submission-plane backend for same-host file reads in the
        native transport (DESIGN.md §24). ``auto`` probes io_uring at
        runtime and falls back to pread; ``iouring`` requests it
        explicitly (still degrades cleanly on ENOSYS/old kernels);
        ``pread`` is the preadv2-scatter path; ``mapped`` copies
        through mmap+MAP_POPULATE windows. Every backend produces
        byte-identical results."""
        raw = (
            self._conf.get(PREFIX + "native.readBackend", "auto") or "auto"
        ).lower()
        if raw not in ("auto", "iouring", "pread", "mapped"):
            raw = "auto"
        return raw

    @property
    def native_consume_workers(self) -> int:
        """Consume lanes draining the native completion queue: checksum
        verify + decode run in parallel per source-ordered lane
        (completions are routed by channel, so per-source order is
        preserved and the reduce pipeline's sequencer keeps delivery
        byte-identical). Default min(cores-1, 4), floor 1 — a 1-core
        rig degenerates to the old inline consume."""
        cores = os.cpu_count() or 1
        return self._int(
            "native.consumeWorkers", min(max(cores - 1, 1), 4), 1, 16
        )

    # -- TPU device exchange plane (new; no reference analogue) -----------
    @property
    def exchange_bucket_min(self) -> int:
        """Smallest padded block bucket for the static-shape exchange program."""
        return self._bytes("exchange.bucketMin", "64k", 1024, 1 << 31)

    @property
    def exchange_bucket_max(self) -> int:
        return self._bytes("exchange.bucketMax", "8m", 1024, 1 << 33)

    @property
    def hbm_slab_bytes(self) -> int:
        """Size of each HBM staging slab owned by the device buffer manager."""
        return self._bytes("hbm.slabBytes", "64m", 1 << 16, 1 << 33)

    @property
    def hbm_max_bytes(self) -> int:
        """HBM budget for shuffle staging (analogue of the 25g host budget)."""
        return self._bytes("hbm.maxBytes", "2g", 0, 1 << 40)

    @property
    def hbm_host_spill_max_bytes(self) -> int:
        """Host-RAM cap for slabs spilled out of HBM; overflow cascades
        to disk (tier 3 of SURVEY §7.3(4)). 0 = unbounded host tier."""
        return self._bytes("hbm.hostSpillMaxBytes", "0", 0, 1 << 44)

    @property
    def device_fetch_enabled(self) -> bool:
        """Device fetch plane (shuffle/device_fetch.py): publish HBM
        arena coordinates next to the host triple and let reduce tasks
        pull arena-resident blocks HBM->HBM (Pallas remote copy on TPU
        meshes, ``jax.device_put`` emulation elsewhere) instead of
        through host sockets. The host path always remains the
        fallback; disabling only suppresses device locations and
        planner pulls."""
        return self._bool("deviceFetch.enabled", True)

    @property
    def device_fetch_min_block_bytes(self) -> int:
        """Blocks smaller than this skip the device plane: per-pull
        dispatch overhead beats the HBM bandwidth win on tiny blocks,
        and small blocks churn arena slabs (min slab class 16 KiB)."""
        return self._bytes("deviceFetch.minBlockBytes", "16k", 0, 1 << 33)

    @property
    def collective_enabled(self) -> bool:
        """Whole-stage collective shuffle (shuffle/collective.py):
        compile a reduce stage's device-resident location set into
        batched DMA waves instead of per-block planner pulls. Device
        blocks the compiler cannot place (too few, wrong dtype, evicted
        mid-stage) silently degrade to the per-block planner or the
        host triple — results are byte-identical either way."""
        return self._bool("collective.enabled", True)

    @property
    def collective_min_blocks(self) -> int:
        """Device-resident blocks a stage must publish before the
        compiler engages; below this the per-block planner wins (a
        one-block "wave" is pure dispatch overhead)."""
        return self._int("collective.minBlocks", 2, 1, 1 << 20)

    @property
    def collective_schedule(self) -> str:
        """Wave schedule: ``ring`` orders waves lane-major around the
        source ring (one lane in flight — the flow-controlled
        schedule), ``a2a`` interleaves lanes round-robin (dense
        all-to-all), ``auto`` picks a2a when the stage spans more than
        two source lanes."""
        raw = (self.get(PREFIX + "collective.schedule", "auto") or "auto").lower()
        return raw if raw in ("auto", "ring", "a2a") else "auto"

    @property
    def collective_wave_bytes(self) -> int:
        """Payload cap per DMA wave — the device plane's
        maxBytesInFlight analogue: bounds the stacked landing buffer
        and keeps one slow wave from serializing the whole stage."""
        return self._bytes("collective.waveBytes", "64m", 1 << 16, 1 << 33)

    @property
    def collective_fused_merge(self) -> bool:
        """Allow fetch->merge fusion: a partition whose every block
        arrives in one wave lands as ONE merged slab (concatenated in
        deterministic source order) with no intermediate HBM round
        trip. Fusion changes the *shape* of the result (one buffer per
        partition instead of per block), so callers opt in per fetch;
        this knob is the global off-switch."""
        return self._bool("collective.fusedMerge", True)

    @property
    def collective_lane_balance(self) -> bool:
        """Adaptive planner balances per-lane (source executor) DMA
        bytes, not just totals: a partition concentrated in one lane
        costs a longer DMA epoch than the same bytes spread across
        lanes, so reduce-range cuts weigh the max lane load."""
        return self._bool("collective.laneBalance", True)

    @property
    def collective_pipeline_depth(self) -> int:
        """Waves the schedule compiler keeps in flight at once: wave
        N+1's remote DMAs are dispatched while wave N still merges
        (one DMA-semaphore array per in-flight wave). ``1`` disables
        pipelining (issue, wait, adopt, repeat — the pre-pipeline
        behavior); every depth is byte-identical, only the overlap
        changes."""
        return self._int("collective.pipelineDepth", 2, 1, 8)

    @property
    def collective_auto_tune(self) -> bool:
        """Let the compiler's wave controller re-derive the effective
        ``collective.waveBytes`` per (shuffle, stage-shape) from its
        own wave stats plus the job's TimeBreakdown / profiler gap
        frames (shuffle/autotune.py): a stage that ran as one monolithic
        wave is re-cut so the pipeline has waves to overlap, a
        dispatch-bound stage coarsens. The tuned choice is remembered,
        so the second identical stage of a job already runs tuned.
        Never shrinks a wave below the stage's largest partition group
        (fusion needs a partition's rows in ONE wave)."""
        return self._bool("collective.autoTune", True)

    @property
    def hbm_spill_dir(self) -> str:
        """Directory for the disk tier's spill files. Default ("") uses
        the system temp dir — NOTE: on hosts where /tmp is tmpfs that
        is still RAM; point this at real storage when using
        hbm.hostSpillMaxBytes to protect host memory."""
        return str(self.get(PREFIX + "hbm.spillDir", "") or "")

    # -- tenancy (multi-tenant serving; sparkrdma_tpu_torch/tenancy) ------------
    @property
    def tenancy_enabled(self) -> bool:
        """Serve concurrent jobs through the tenancy layer: admission
        control on the driver, deficit-round-robin fair-share dispatch
        on the bounded map/reduce pools, and (when quotas are set)
        per-tenant byte backpressure. With a single (default) tenant
        every mechanism degenerates to the pre-tenancy behavior, so
        this is safe to leave on."""
        return self._bool("tenancy.enabled", True)

    @property
    def tenancy_max_concurrent_jobs(self) -> int:
        """Jobs admitted in-flight before new ones queue (FIFO)."""
        return self._int("tenancy.maxConcurrentJobs", 8, 1, 4096)

    @property
    def tenancy_admit_timeout_ms(self) -> int:
        """Queue-with-deadline: a job still queued after this raises
        AdmissionTimeout instead of camping on the admission queue."""
        return self._int("tenancy.admitTimeoutMs", 30000, 1, 1 << 31)

    @property
    def tenancy_weights(self) -> Dict[str, int]:
        """Fair-share weights, e.g. ``"alice:4,bob:1"``. Tenants not
        named get ``tenancy.defaultWeight``."""
        from sparkrdma_tpu_torch.tenancy import parse_weights

        return parse_weights(str(self.get(PREFIX + "tenancy.weights", "") or ""))

    @property
    def tenancy_default_weight(self) -> int:
        return self._int("tenancy.defaultWeight", 1, 1, 1000)

    @property
    def tenancy_quantum_ms(self) -> int:
        """DRR credit per round in milliseconds of task runtime (per
        unit weight). Smaller = finer cross-tenant interleave."""
        return self._int("tenancy.quantumMs", 20, 1, 60000)

    @property
    def tenancy_mempool_quota_bytes(self) -> int:
        """Per-tenant byte quota on held mempool buffers (0 = off).
        Per-tenant overrides: ``tenancy.quota.<tenant>.mempoolBytes``."""
        return self._bytes("tenancy.mempoolQuotaBytes", "0", 0, 1 << 44)

    @property
    def tenancy_hbm_quota_bytes(self) -> int:
        """Per-tenant byte quota on held HBM-arena capacity (0 = off).
        Per-tenant overrides: ``tenancy.quota.<tenant>.hbmBytes``."""
        return self._bytes("tenancy.hbmQuotaBytes", "0", 0, 1 << 44)

    @property
    def tenancy_pagecache_quota_bytes(self) -> int:
        """Per-tenant byte quota on in-flight zero-copy mapped fetches
        (0 = off). Mapped delivery bypasses the mempool, so without
        this a mapped-heavy tenant's page-cache footprint is invisible
        to the other quotas. Per-tenant overrides:
        ``tenancy.quota.<tenant>.pageCacheBytes``."""
        return self._bytes("tenancy.pageCacheQuotaBytes", "0", 0, 1 << 44)

    @property
    def tenancy_quota_block_max_ms(self) -> int:
        """Upper bound on one quota backpressure stall; past it the
        charge is admitted anyway (tenant.quota_overruns) — the quota
        is backpressure, never a wedge."""
        return self._int("tenancy.quotaBlockMaxMs", 60000, 1, 1 << 31)

    # -- elastic (executor loss, speculation; sparkrdma_tpu_torch/elastic) ------
    @property
    def elastic_replicas(self) -> int:
        """Best-effort copies of each committed map output pushed to
        this many ring peers (elastic/replication.py). 0 disables the
        replication plane; with it on, losing an executor costs zero
        recompute for every map a replica covers."""
        return self._int("elastic.replicas", 0, 0, 16)

    @property
    def elastic_speculation(self) -> bool:
        """Clone in-flight reduce ranges of a telemetry-flagged
        straggler onto a healthy peer; first finisher wins, the loser
        drains through the reader abort latch."""
        return self._bool("elastic.speculation", False)

    @property
    def elastic_speculation_check_ms(self) -> int:
        """How often the cluster driver polls straggler verdicts while
        reduce tasks are in flight."""
        return self._int("elastic.speculationCheckMs", 200, 10, 1 << 31)

    @property
    def elastic_max_recoveries(self) -> int:
        """Executor-loss recovery rounds per stage before the job
        fails. Each round re-runs only the dead executor's unaccounted
        maps on survivors and re-issues its reduce ranges."""
        return self._int("elastic.maxRecoveries", 2, 0, 64)

    # -- metastore (control-plane HA; sparkrdma_tpu_torch/metastore) ------------
    @property
    def metastore_peers(self) -> int:
        """Logical metadata peers the locations registry shards over
        (metastore/shardmap.py). Each peer serves its shards under a
        lease; killing one remaps only its ranges."""
        return self._int("metastore.peers", 4, 1, 64)

    @property
    def metastore_vnodes(self) -> int:
        """Virtual nodes per peer on the consistent-hash ring; more
        vnodes, smoother spread and smaller movement per kill."""
        return self._int("metastore.vnodes", 16, 1, 256)

    @property
    def metastore_range_size(self) -> int:
        """Consecutive partitions sharing one shard key, so a reduce
        task's ``[start, end)`` resolve touches few shards."""
        return self._int("metastore.rangeSize", 8, 1, 4096)

    @property
    def metastore_lease_ttl_ms(self) -> int:
        """Shard lease time-to-live. A lapsed lease takes over under a
        bumped epoch; writes routed under the old one are fenced."""
        return self._int("metastore.leaseTtlMs", 5000, 10, 1 << 31)

    @property
    def metastore_replicas(self) -> int:
        """Follower copies per metadata shard. Writes apply to primary
        + followers; reads serve the primary only. At >= 1 a metadata
        peer's death costs zero metadata loss."""
        return self._int("metastore.replicas", 1, 0, 4)

    @property
    def metastore_max_write_attempts(self) -> int:
        """Stale-epoch publish/resolve attempts (re-route + retry
        through the resilience retry ladder) before surfacing the error."""
        return self._int("metastore.maxWriteAttempts", 4, 1, 64)

    @property
    def metastore_retry_backoff_ms(self) -> int:
        """Base backoff between stale-epoch retries (jittered,
        exponential, capped at 8x)."""
        return self._int("metastore.retryBackoffMs", 2, 1, 1 << 31)
