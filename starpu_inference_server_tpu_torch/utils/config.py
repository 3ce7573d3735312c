"""Runtime configuration: strict single-YAML schema -> RuntimeConfig.

Counterpart of ``starpu_inference_server_tpu/utils/config.py``: the same
dataclasses, the same strict keys with did-you-mean errors, the same
required keys and cross-field invariants, so every file in ``configs/``
parses to equal values in both packages.

Differences in the port:

- :func:`parse_config` takes a mapping; :func:`load_config` imports
  ``yaml`` inside the function, so the engine path runs where PyYAML is
  not installed.
- TPU-only keys are accepted so every config parses, and are documented
  no-ops here: ``devices.use_tpu`` (the port runs on ``cuda`` unless the
  caller asks for ``cpu``), ``xla_env`` (there is no XLA),
  ``profiler_port`` (no ``jax.profiler`` server) and the model option
  ``pin_cache_layouts`` (a TPU layout workaround with no CUDA meaning).
- ``metrics_port: 0`` is accepted and binds an ephemeral port (the bound
  one is logged), so servers that start one after another in one process
  do not contend for 9090; the JAX package refuses 0.
"""

from __future__ import annotations

import dataclasses
import difflib
import enum
import math
import os
from typing import Any, List, Mapping, Sequence, Tuple

from .dtypes import canonical_dtype_name, element_size
from .exceptions import (
    InvalidConfigValueError,
    MissingConfigKeyError,
    UnknownConfigKeyError,
)
from .logger import Verbosity

MIN_MESSAGE_BYTES = 32 * 1024 * 1024  # reference: runtime_config.hpp:359-438


class BatchingStrategyKind(enum.Enum):
    DISABLED = "disabled"
    FIXED = "fixed"
    ADAPTIVE = "adaptive"


class QuantMode(enum.Enum):
    NONE = "none"
    INT8 = "int8"
    INT4 = "int4"
    # INT8 weights + dynamic per-token INT8 activations: dense layers run
    # the s8 x s8 -> s32 MXU path (2x bf16 rate on v5e-class chips)
    W8A8 = "w8a8"
    # INT4 weights + dynamic per-token INT8 activations: the same s8xs8
    # MXU contraction reading quarter-width weights (BASELINE config 5)
    W4A8 = "w4a8"


class SchedulerPolicy(enum.Enum):
    """Lane-picking policy; the TPU re-design of StarPU's scheduler choice
    (lws/eager/heft; reference: docs/server_guide.md:235-248)."""

    ROUND_ROBIN = "round_robin"   # ~ eager
    LEAST_LOADED = "least_loaded"  # ~ lws
    EWMA = "ewma"                  # ~ heft (latency-aware)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str
    dims: Tuple[int, ...]   # per-sample dims, no batch dim
    dtype: str              # canonical wire name, e.g. "FP32"

    @property
    def elements_per_sample(self) -> int:
        return int(math.prod(self.dims)) if self.dims else 1

    @property
    def bytes_per_sample(self) -> int:
        return self.elements_per_sample * element_size(self.dtype)


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    family: str                       # model-registry key, e.g. "resnet18"
    params: str = "random"            # "random" or a checkpoint path
    compute_dtype: str = "BF16"       # dtype of activations/matmuls
    quantization: QuantMode = QuantMode.NONE
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class MeshSettings:
    """Logical device mesh (reference has none; SURVEY.md section 2.9)."""

    data: int = 1
    model: int = 1
    expert: int = 1
    pipe: int = 1
    # GPipe microbatch count when pipe > 1; bubble fraction is
    # (pipe-1)/(microbatches+pipe-1)
    microbatches: int = 4

    @property
    def size(self) -> int:
        return self.data * self.model * self.expert * self.pipe


@dataclasses.dataclass(frozen=True)
class DeviceSettings:
    use_tpu: bool = True  # accepted, no-op in the port
    device_ids: Tuple[int, ...] = ()
    lanes_per_device: int = 1   # ~ STARPU_NWORKER_PER_CUDA
    scheduler: SchedulerPolicy = SchedulerPolicy.EWMA
    mesh: MeshSettings = dataclasses.field(default_factory=MeshSettings)


@dataclasses.dataclass(frozen=True)
class AdaptiveBatchingSettings:
    """AIMD-like pressure controller knobs
    (reference: batching_strategy.cpp:63-357)."""

    entry_ticks: int = 4
    exit_horizon_ticks: int = 8
    pressure_high: float = 0.75
    pressure_low: float = 0.25
    pressure_severe: float = 0.95
    min_congested_coalesce_ms: float = 0.5


@dataclasses.dataclass(frozen=True)
class FixedBatchingSettings:
    batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class CongestionSettings:
    """EWMA congestion detector knobs
    (reference: docs/congestion_detection.md:27-196).

    Note on ``rho_high``: here rho = EWMA(arrival rate)/EWMA(completion
    rate), so steady balanced load sits at rho ~= 1.0; the entry
    threshold defaults slightly above 1 (the reference's 0.9 default
    applies to its capacity-based mu estimate)."""

    enabled: bool = True
    tick_interval_ms: float = 100.0
    ewma_alpha: float = 0.3
    rho_high: float = 1.1
    fill_high: float = 0.7
    latency_slo_ms: float = 150.0
    slo_entry_fraction: float = 0.9
    slo_exit_fraction: float = 0.8
    entry_horizon_ticks: int = 2
    exit_horizon_ticks: int = 5


@dataclasses.dataclass(frozen=True)
class DistributedSettings:
    """Multi-host bring-up: with a coordinator, ``num_processes``
    launchers (the JAX package's ``jax.distributed`` processes), this one
    ``process_id``, join at ``coordinator_address``
    (``parallel/launch.py:serve_mesh``; :func:`resolve_distributed` fills
    the auto-detected values). Empty coordinator = single host. No
    reference counterpart (the reference is single-node; SURVEY.md
    section 5.8)."""

    coordinator_address: str = ""
    num_processes: int = 0   # 0 = auto-detect
    process_id: int = -1     # -1 = auto-detect


# (rank, size) variables of the cluster environments jax.distributed reads,
# in its order: Open MPI, then SLURM
CLUSTER_VARIABLES = (("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
                     ("SLURM_PROCID", "SLURM_NTASKS"))


def resolve_distributed(settings: DistributedSettings,
                        environ: Mapping[str, str] = None) -> DistributedSettings:
    """``settings`` with ``process_id: -1`` and ``num_processes: 0`` read
    from the environment (``os.environ`` by default), as
    ``jax.distributed.initialize`` reads them: ``OMPI_COMM_WORLD_RANK`` /
    ``OMPI_COMM_WORLD_SIZE``, else ``SLURM_PROCID`` / ``SLURM_NTASKS``.
    Without a coordinator nothing is resolved (no coordinator is
    auto-detected). Raises InvalidConfigValueError naming the variables when a value
    is unset and neither set is present, and when ``process_id`` is not
    below ``num_processes``."""
    if not settings.coordinator_address:
        return settings
    env = os.environ if environ is None else environ
    pid, n = settings.process_id, settings.num_processes
    if pid < 0 or n <= 0:
        found = next(((env[r], env[w]) for r, w in CLUSTER_VARIABLES if r in env and w in env),
                     None)
        if found is None:
            names = " or ".join(f"{r} / {w}" for r, w in CLUSTER_VARIABLES)
            raise InvalidConfigValueError(
                f"distributed: process_id {pid} and num_processes {n} are to be auto-detected, "
                f"but neither {names} is set")
        pid = int(found[0]) if pid < 0 else pid
        n = int(found[1]) if n <= 0 else n
    if not 0 <= pid < n:
        raise InvalidConfigValueError(f"distributed: process_id {pid} is not below num_processes {n}")
    return dataclasses.replace(settings, num_processes=n, process_id=pid)


@dataclasses.dataclass(frozen=True)
class ServerSettings:
    address: str = "0.0.0.0:8001"
    max_message_bytes: int = 0  # 0 = auto-derive
    num_workers: int = 0        # 0 = clamp(cpu_count, 2..8)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    name: str
    model: ModelSettings
    inputs: Tuple[TensorSpec, ...]
    outputs: Tuple[TensorSpec, ...]
    pool_size: int
    batch_coalesce_timeout_ms: float
    batching_strategy: BatchingStrategyKind
    max_batch_size: int = 1
    adaptive_batching: AdaptiveBatchingSettings = dataclasses.field(
        default_factory=AdaptiveBatchingSettings
    )
    fixed_batching: FixedBatchingSettings = dataclasses.field(
        default_factory=FixedBatchingSettings
    )
    batch_bucket_sizes: Tuple[int, ...] = ()
    max_queue_size: int = 512
    max_inflight_tasks: int = 16
    devices: DeviceSettings = dataclasses.field(default_factory=DeviceSettings)
    congestion: CongestionSettings = dataclasses.field(
        default_factory=CongestionSettings
    )
    server: ServerSettings = dataclasses.field(default_factory=ServerSettings)
    distributed: DistributedSettings = dataclasses.field(
        default_factory=DistributedSettings
    )
    warmup_request_nb: int = 1
    verbosity: Verbosity = Verbosity.INFO
    seed: int = 42
    metrics_enabled: bool = True
    metrics_port: int = 9090
    profiler_port: int = 0  # accepted, no-op in the port (TPU profiler server)
    trace_enabled: bool = False
    trace_output: str = ""
    # accepted, no-op in the port (XLA environment pass-through)
    xla_env: Mapping[str, str] = dataclasses.field(default_factory=dict)

    # ---- derived values -------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Precompiled batch-size buckets, ascending; always ends at
        max_batch_size. The TPU replacement for the reference's in-place
        StarPU vector resize (starpu_vector_resize_utils.hpp)."""
        if self.batch_bucket_sizes:
            return self.batch_bucket_sizes
        buckets: List[int] = []
        b = 1
        while b < self.max_batch_size:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_batch_size)
        return tuple(buckets)

    def bucket_for(self, batch: int) -> int:
        """Smallest bucket >= batch."""
        for b in self.buckets:
            if b >= batch:
                return b
        return self.buckets[-1]

    @property
    def resolved_max_message_bytes(self) -> int:
        """Auto message size from I/O bytes x max batch, min 32 MiB
        (reference: runtime_config.hpp:359-438)."""
        if self.server.max_message_bytes > 0:
            return self.server.max_message_bytes
        io_bytes = sum(t.bytes_per_sample for t in self.inputs) + sum(
            t.bytes_per_sample for t in self.outputs
        )
        return max(MIN_MESSAGE_BYTES, 2 * io_bytes * self.max_batch_size)


# ---------------------------------------------------------------------------
# Strict parsing helpers
# ---------------------------------------------------------------------------

def _check_keys(section: str, mapping: Mapping[str, Any], allowed: Sequence[str]) -> None:
    for key in mapping:
        if key not in allowed:
            suggestion = next(
                iter(difflib.get_close_matches(str(key), allowed, n=1)), None
            )
            where = f"{section}.{key}" if section else str(key)
            raise UnknownConfigKeyError(where, suggestion)


def _require(mapping: Mapping[str, Any], key: str) -> Any:
    if key not in mapping or mapping[key] is None:
        raise MissingConfigKeyError(key)
    return mapping[key]


def _as_positive_int(name: str, value: Any) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise InvalidConfigValueError(f"{name} must be a positive integer, got {value!r}")
    return value


def _as_port(name: str, value: Any) -> int:
    """A TCP port, or 0 for an ephemeral one."""
    if isinstance(value, bool) or not isinstance(value, int) or not 0 <= value <= 65535:
        raise InvalidConfigValueError(f"{name} must be a port in [0, 65535], got {value!r}")
    return value


def _as_nonneg_number(name: str, value: Any) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)) or value < 0:
        raise InvalidConfigValueError(f"{name} must be a non-negative number, got {value!r}")
    return float(value)


def _as_fraction(name: str, value: Any) -> float:
    v = _as_nonneg_number(name, value)
    if v > 1.0:
        raise InvalidConfigValueError(f"{name} must be in [0,1], got {value!r}")
    return v


def _parse_enum(name: str, value: Any, enum_cls):
    try:
        return enum_cls(str(value).strip().lower())
    except ValueError:
        valid = ", ".join(e.value for e in enum_cls)
        raise InvalidConfigValueError(
            f"{name} must be one of {{{valid}}}, got {value!r}"
        ) from None


def _parse_tensor_specs(section: str, raw: Any) -> Tuple[TensorSpec, ...]:
    if not isinstance(raw, list) or not raw:
        raise InvalidConfigValueError(f"{section} must be a non-empty list")
    specs = []
    for i, entry in enumerate(raw):
        if not isinstance(entry, Mapping):
            raise InvalidConfigValueError(f"{section}[{i}] must be a mapping")
        _check_keys(f"{section}[{i}]", entry, ["name", "dims", "dtype"])
        name = str(_require(entry, "name"))
        dims_raw = _require(entry, "dims")
        if not isinstance(dims_raw, list) or not all(
            isinstance(d, int) and not isinstance(d, bool) and d > 0 for d in dims_raw
        ):
            raise InvalidConfigValueError(
                f"{section}[{i}].dims must be a list of positive ints (per-sample "
                f"dims, no batch dim), got {dims_raw!r}"
            )
        dtype = canonical_dtype_name(str(_require(entry, "dtype")))
        specs.append(TensorSpec(name=name, dims=tuple(dims_raw), dtype=dtype))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise InvalidConfigValueError(f"duplicate tensor names in {section}: {names}")
    return tuple(specs)


def _parse_model(raw: Any) -> ModelSettings:
    if isinstance(raw, str):
        return ModelSettings(family=raw)
    if not isinstance(raw, Mapping):
        raise InvalidConfigValueError("model must be a string or mapping")
    allowed = ["family", "params", "compute_dtype", "quantization", "options"]
    _check_keys("model", raw, allowed)
    family = str(_require(raw, "family"))
    params = str(raw.get("params", "random"))
    if params != "random" and not os.path.exists(params):
        # reference checks the model path exists (config_loader.cpp:173-200)
        raise InvalidConfigValueError(f"model.params path does not exist: {params}")
    compute_dtype = canonical_dtype_name(str(raw.get("compute_dtype", "BF16")))
    quant = _parse_enum("model.quantization", raw.get("quantization", "none"), QuantMode)
    options = dict(raw.get("options", {}) or {})
    return ModelSettings(
        family=family,
        params=params,
        compute_dtype=compute_dtype,
        quantization=quant,
        options=options,
    )


def _parse_devices(raw: Any) -> DeviceSettings:
    if raw is None:
        return DeviceSettings()
    allowed = ["use_tpu", "device_ids", "lanes_per_device", "scheduler", "mesh"]
    _check_keys("devices", raw, allowed)
    mesh_raw = raw.get("mesh") or {}
    _check_keys(
        "devices.mesh", mesh_raw,
        ["data", "model", "expert", "pipe", "microbatches"],
    )
    mesh = MeshSettings(
        data=_as_positive_int("devices.mesh.data", mesh_raw.get("data", 1)),
        model=_as_positive_int("devices.mesh.model", mesh_raw.get("model", 1)),
        expert=_as_positive_int("devices.mesh.expert", mesh_raw.get("expert", 1)),
        pipe=_as_positive_int("devices.mesh.pipe", mesh_raw.get("pipe", 1)),
        microbatches=_as_positive_int(
            "devices.mesh.microbatches", mesh_raw.get("microbatches", 4)
        ),
    )
    ids = raw.get("device_ids", []) or []
    if not isinstance(ids, list) or not all(
        isinstance(d, int) and not isinstance(d, bool) and d >= 0 for d in ids
    ):
        raise InvalidConfigValueError(f"devices.device_ids must be a list of ints, got {ids!r}")
    return DeviceSettings(
        use_tpu=bool(raw.get("use_tpu", True)),
        device_ids=tuple(ids),
        lanes_per_device=_as_positive_int(
            "devices.lanes_per_device", raw.get("lanes_per_device", 1)
        ),
        scheduler=_parse_enum("devices.scheduler", raw.get("scheduler", "ewma"), SchedulerPolicy),
        mesh=mesh,
    )


def _parse_adaptive(raw: Any) -> AdaptiveBatchingSettings:
    if raw is None:
        return AdaptiveBatchingSettings()
    allowed = [
        "entry_ticks",
        "exit_horizon_ticks",
        "pressure_high",
        "pressure_low",
        "pressure_severe",
        "min_congested_coalesce_ms",
    ]
    _check_keys("adaptive_batching", raw, allowed)
    return AdaptiveBatchingSettings(
        entry_ticks=_as_positive_int("adaptive_batching.entry_ticks", raw.get("entry_ticks", 4)),
        exit_horizon_ticks=_as_positive_int(
            "adaptive_batching.exit_horizon_ticks", raw.get("exit_horizon_ticks", 8)
        ),
        pressure_high=_as_fraction("adaptive_batching.pressure_high", raw.get("pressure_high", 0.75)),
        pressure_low=_as_fraction("adaptive_batching.pressure_low", raw.get("pressure_low", 0.25)),
        pressure_severe=_as_fraction(
            "adaptive_batching.pressure_severe", raw.get("pressure_severe", 0.95)
        ),
        min_congested_coalesce_ms=_as_nonneg_number(
            "adaptive_batching.min_congested_coalesce_ms",
            raw.get("min_congested_coalesce_ms", 0.5),
        ),
    )


def _parse_fixed(raw: Any) -> FixedBatchingSettings:
    if raw is None:
        return FixedBatchingSettings()
    _check_keys("fixed_batching", raw, ["batch_size"])
    return FixedBatchingSettings(
        batch_size=_as_positive_int("fixed_batching.batch_size", raw.get("batch_size", 8))
    )


def _parse_congestion(raw: Any) -> CongestionSettings:
    if raw is None:
        return CongestionSettings()
    allowed = [
        "enabled",
        "tick_interval_ms",
        "ewma_alpha",
        "rho_high",
        "fill_high",
        "latency_slo_ms",
        "slo_entry_fraction",
        "slo_exit_fraction",
        "entry_horizon_ticks",
        "exit_horizon_ticks",
    ]
    _check_keys("congestion", raw, allowed)
    return CongestionSettings(
        enabled=bool(raw.get("enabled", True)),
        tick_interval_ms=_as_nonneg_number(
            "congestion.tick_interval_ms", raw.get("tick_interval_ms", 100.0)
        ),
        ewma_alpha=_as_fraction("congestion.ewma_alpha", raw.get("ewma_alpha", 0.3)),
        rho_high=_as_nonneg_number("congestion.rho_high", raw.get("rho_high", 1.1)),
        fill_high=_as_fraction("congestion.fill_high", raw.get("fill_high", 0.7)),
        latency_slo_ms=_as_nonneg_number(
            "congestion.latency_slo_ms", raw.get("latency_slo_ms", 150.0)
        ),
        slo_entry_fraction=_as_fraction(
            "congestion.slo_entry_fraction", raw.get("slo_entry_fraction", 0.9)
        ),
        slo_exit_fraction=_as_fraction(
            "congestion.slo_exit_fraction", raw.get("slo_exit_fraction", 0.8)
        ),
        entry_horizon_ticks=_as_positive_int(
            "congestion.entry_horizon_ticks", raw.get("entry_horizon_ticks", 2)
        ),
        exit_horizon_ticks=_as_positive_int(
            "congestion.exit_horizon_ticks", raw.get("exit_horizon_ticks", 5)
        ),
    )


def _parse_server(raw: Any) -> ServerSettings:
    if raw is None:
        return ServerSettings()
    _check_keys("server", raw, ["address", "max_message_bytes", "num_workers"])
    max_bytes = raw.get("max_message_bytes", 0)
    if isinstance(max_bytes, bool) or not isinstance(max_bytes, int) or max_bytes < 0:
        raise InvalidConfigValueError(
            f"server.max_message_bytes must be a non-negative int, got {max_bytes!r}"
        )
    workers = raw.get("num_workers", 0)
    if isinstance(workers, bool) or not isinstance(workers, int) or workers < 0:
        raise InvalidConfigValueError(
            f"server.num_workers must be a non-negative int, got {workers!r}"
        )
    return ServerSettings(
        address=str(raw.get("address", "0.0.0.0:8001")),
        max_message_bytes=max_bytes,
        num_workers=workers,
    )


def _parse_distributed(raw: Any) -> DistributedSettings:
    if raw is None:
        return DistributedSettings()
    _check_keys(
        "distributed", raw, ["coordinator_address", "num_processes", "process_id"]
    )
    return DistributedSettings(
        coordinator_address=str(raw.get("coordinator_address", "") or ""),
        num_processes=int(raw.get("num_processes", 0) or 0),
        process_id=int(raw.get("process_id", -1)),
    )


_TOP_LEVEL_KEYS = [
    "name",
    "model",
    "inputs",
    "outputs",
    "pool_size",
    "max_batch_size",
    "batch_coalesce_timeout_ms",
    "batching_strategy",
    "adaptive_batching",
    "fixed_batching",
    "batch_bucket_sizes",
    "max_queue_size",
    "max_inflight_tasks",
    "devices",
    "congestion",
    "server",
    "distributed",
    "warmup_request_nb",
    "verbosity",
    "seed",
    "metrics_enabled",
    "metrics_port",
    "profiler_port",
    "trace_enabled",
    "trace_output",
    "xla_env",
]

# reference: config_loader.cpp:82-115
_REQUIRED_KEYS = [
    "name",
    "model",
    "inputs",
    "outputs",
    "pool_size",
    "batch_coalesce_timeout_ms",
    "batching_strategy",
]


def parse_config(raw: Mapping[str, Any]) -> RuntimeConfig:
    if not isinstance(raw, Mapping):
        raise InvalidConfigValueError("config root must be a mapping")
    _check_keys("", raw, _TOP_LEVEL_KEYS)
    for key in _REQUIRED_KEYS:
        _require(raw, key)

    max_batch = _as_positive_int("max_batch_size", raw.get("max_batch_size", 1))
    buckets_raw = raw.get("batch_bucket_sizes", []) or []
    if not isinstance(buckets_raw, list) or not all(
        isinstance(b, int) and not isinstance(b, bool) and b > 0 for b in buckets_raw
    ):
        raise InvalidConfigValueError(
            f"batch_bucket_sizes must be a list of positive ints, got {buckets_raw!r}"
        )
    buckets = tuple(sorted(set(buckets_raw)))
    if buckets and buckets[-1] != max_batch:
        raise InvalidConfigValueError(
            f"batch_bucket_sizes must end at max_batch_size={max_batch}, got {buckets}"
        )

    cfg = RuntimeConfig(
        name=str(_require(raw, "name")),
        model=_parse_model(_require(raw, "model")),
        inputs=_parse_tensor_specs("inputs", _require(raw, "inputs")),
        outputs=_parse_tensor_specs("outputs", _require(raw, "outputs")),
        pool_size=_as_positive_int("pool_size", _require(raw, "pool_size")),
        batch_coalesce_timeout_ms=_as_nonneg_number(
            "batch_coalesce_timeout_ms", _require(raw, "batch_coalesce_timeout_ms")
        ),
        batching_strategy=_parse_enum(
            "batching_strategy", _require(raw, "batching_strategy"), BatchingStrategyKind
        ),
        max_batch_size=max_batch,
        adaptive_batching=_parse_adaptive(raw.get("adaptive_batching")),
        fixed_batching=_parse_fixed(raw.get("fixed_batching")),
        batch_bucket_sizes=buckets,
        max_queue_size=_as_positive_int("max_queue_size", raw.get("max_queue_size", 512)),
        max_inflight_tasks=_as_positive_int(
            "max_inflight_tasks", raw.get("max_inflight_tasks", 16)
        ),
        devices=_parse_devices(raw.get("devices")),
        congestion=_parse_congestion(raw.get("congestion")),
        server=_parse_server(raw.get("server")),
        distributed=_parse_distributed(raw.get("distributed")),
        warmup_request_nb=_as_positive_int(
            "warmup_request_nb", raw.get("warmup_request_nb", 1)
        ),
        verbosity=Verbosity.parse(raw.get("verbosity", "info")),
        seed=int(raw.get("seed", 42)),
        metrics_enabled=bool(raw.get("metrics_enabled", True)),
        metrics_port=_as_port("metrics_port", raw.get("metrics_port", 9090)),
        profiler_port=int(raw.get("profiler_port", 0) or 0),
        trace_enabled=bool(raw.get("trace_enabled", False)),
        trace_output=str(raw.get("trace_output", "") or ""),
        xla_env={str(k): str(v) for k, v in (raw.get("xla_env") or {}).items()},
    )

    _validate_invariants(cfg)
    return cfg


def _validate_invariants(cfg: RuntimeConfig) -> None:
    """Cross-field invariants (reference: runtime_config.hpp:302-357)."""
    if cfg.max_queue_size < cfg.max_batch_size:
        raise InvalidConfigValueError(
            f"max_queue_size ({cfg.max_queue_size}) must be >= "
            f"max_batch_size ({cfg.max_batch_size})"
        )
    if cfg.max_inflight_tasks < cfg.pool_size:
        raise InvalidConfigValueError(
            f"max_inflight_tasks ({cfg.max_inflight_tasks}) must be >= "
            f"pool_size ({cfg.pool_size})"
        )
    if cfg.batching_strategy is BatchingStrategyKind.FIXED:
        if cfg.fixed_batching.batch_size > cfg.max_batch_size:
            raise InvalidConfigValueError(
                f"fixed_batching.batch_size ({cfg.fixed_batching.batch_size}) "
                f"must be <= max_batch_size ({cfg.max_batch_size})"
            )
    ab = cfg.adaptive_batching
    if ab.pressure_low >= ab.pressure_high:
        raise InvalidConfigValueError(
            "adaptive_batching.pressure_low must be < pressure_high"
        )
    if ab.pressure_high > ab.pressure_severe:
        raise InvalidConfigValueError(
            "adaptive_batching.pressure_high must be <= pressure_severe"
        )
    cg = cfg.congestion
    if cg.slo_exit_fraction > cg.slo_entry_fraction:
        raise InvalidConfigValueError(
            "congestion.slo_exit_fraction must be <= slo_entry_fraction"
        )


def load_config(path: str) -> RuntimeConfig:
    """Load + strictly validate a YAML config file
    (reference: load_config, config_loader.cpp:451)."""
    if not os.path.exists(path):
        raise InvalidConfigValueError(f"config file not found: {path}")
    import yaml

    with open(path, "r", encoding="utf-8") as fh:
        raw = yaml.safe_load(fh)
    if raw is None:
        raise InvalidConfigValueError(f"config file is empty: {path}")
    return parse_config(raw)
