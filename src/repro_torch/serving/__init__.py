"""Forecast serving: the port of the JAX package's ``repro.serving``.

* ``cache``     -- warm-key cache over the engine's serving hooks (kernel
                   libraries loaded, inputs resident), keyed on (config,
                   chunk_len, scored, the full EngineConfig, batch);
                   ``persist_dir`` keeps the kernel libraries, so a fresh
                   process loads them instead of running ``nvcc``;
* ``scheduler`` -- async request scheduler: QoS-aware queue, warm engines
                   per shape key (LRU-evicted under a byte budget),
                   bounded worker threads, same-shape request coalescing
                   onto one batched rollout, retries, circuit breakers
                   and stream resume;
* ``transport`` / ``service`` / ``client``
                -- chunk-streamed delivery: NDJSON over stdlib HTTP, the
                   reference's wire format byte for byte, so either
                   package's client reads either package's replica;
* ``bundle``    -- content-addressed warm-start bundles: the kernel
                   libraries and geometry plans, so a fresh replica boots
                   with no ``nvcc`` and no plan construction;
* ``observability`` -- the metrics registry behind ``/v1/stats`` and
                   ``/metrics``, span traces, ``torch.profiler`` hooks
                   and the flight recorder;
* ``faults``    -- deterministic fault injection, error classification,
                   circuit breakers and the replica health machine.

Launch with ``python -m repro_torch.launch.service``.

The client side (``spec``/``transport``/``client``) imports neither torch
nor the model stack, so the heavy server-side modules are re-exported
lazily (PEP 562) and ``ForecastClient`` is not re-exported at all -- the
client doubles as a ``python -m repro_torch.serving.client`` entry point.
Import it from ``repro_torch.serving.client`` directly.
"""

from repro_torch.serving.bundle import (  # noqa: F401
    BundleError,
    WarmStartBundle,
)
from repro_torch.serving.cache import (  # noqa: F401
    ExecutableCache,
    ExecutableKey,
    ReadOnlyCacheMiss,
)
from repro_torch.serving.faults import (  # noqa: F401
    NULL_FAULTS,
    CircuitBreaker,
    CircuitOpenError,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    ReplicaHealth,
    classify_error,
)
from repro_torch.serving.observability import (  # noqa: F401
    FlightRecorder,
    Observability,
    ObservabilityConfig,
)
from repro_torch.serving.spec import RequestSpec  # noqa: F401
from repro_torch.serving.transport import (  # noqa: F401
    ServedForecast,
    ServingError,
    StreamInterrupted,
)

_LAZY = {
    "ForecastScheduler": "repro_torch.serving.scheduler",
    "ForecastStream": "repro_torch.serving.scheduler",
    "ModelPool": "repro_torch.serving.scheduler",
    "QueueFull": "repro_torch.serving.scheduler",
    "ReplayGone": "repro_torch.serving.scheduler",
    "build_bundle": "repro_torch.serving.scheduler",
    "ForecastService": "repro_torch.serving.service",
    # pack/boot build through the scheduler stack (torch); the manifest
    # types above stay importable in a light client process
    "boot_scheduler": "repro_torch.serving.bundle",
    "pack": "repro_torch.serving.bundle",
}


def __getattr__(name: str):
    """PEP 562 lazy re-export of the torch-heavy server-side symbols."""
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
