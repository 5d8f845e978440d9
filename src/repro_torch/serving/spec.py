"""Request schema + validation -- the wire contract of the service.

Kept dependency-light on purpose: the thin client imports this module
(plus ``transport``) to build and validate requests, so constructing a
``RequestSpec`` must not drag torch or the model stack into the process.
The heavier imports (configs, perturbation rules, engine config) happen
lazily inside the methods that need them.

The fields, defaults and JSON form are the JAX package's
(``repro.serving.spec``), so a request written for a reference replica is
valid here and the two serialize to the same body.
"""

from __future__ import annotations

import dataclasses

PRECISIONS = ("float32", "bfloat16")
KERNEL_MODES = ("auto", "reference", "pallas")
PRIORITIES = ("interactive", "batch")
#: the port's ``KernelConfig`` mode of each explicit ``kernels`` value
_KERNEL_PATHS = {"reference": "reference", "pallas": "kernel"}


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One forecast request -- also the JSON schema of POST /v1/forecast.

    The **shape key** (``engine_key``) is every field that selects a
    different warm engine: config, members, lead_chunk, precision, the
    perturbation settings, spectra and the kernel substrate.
    ``sample``/``seed`` pick the initial condition and noise stream
    within a warm engine; ``scored``/``return_state`` select what the
    stream carries.

    ``kernels`` selects the substrate for the model's hot contractions,
    with the reference's three values: "auto" is the config's own path
    (the hand-written CUDA kernels on the card, their plain versions on
    the CPU, as the port's serve CLI runs it), "reference" the plain
    FFT/einsum path over the full psi tensor, and "pallas" the port's
    counterpart of the Pallas path, the hand-written CUDA kernels
    (``KernelConfig`` mode "kernel").  It flows through
    ``EngineConfig.kernels`` into the executable-cache key, so warm
    requests run on the kernel libraries loaded for their substrate.

    ``coalesce`` (default True) lets the scheduler batch this request
    with queued same-shape requests into one shared rollout dispatch
    (``batch_key``: the warm engine plus rollout length and score set).
    Coalescing keeps each request's own member init, draws and scores;
    the products run at another batch size, so a coalesced request
    matches its serial run to the reference's dispatch bar (rtol 1e-4),
    not bitwise.  A member waits up to the server's ``batch_window_ms``
    for companions; ``coalesce: false`` opts a latency-critical request
    out.

    **QoS fields** -- ``priority`` ("interactive" beats "batch" at
    pickup, subject to the scheduler's aging knob), ``deadline_ms``
    (wall-clock budget from submit; an expired request is shed with a
    terminal ``error`` carrying ``reason: "deadline"`` instead of
    burning a rollout) and ``degrade`` (opt-in: near the deadline the
    scheduler may serve ``degraded_members()`` members instead of
    missing it, reported honestly in start/done events).  None of the
    three enters ``engine_key``/``batch_key`` -- QoS must route traffic,
    never fragment the warm-engine cache.

    ``profile`` (default False) opts this request's rollout into a
    ``torch.profiler`` trace when the server was launched with
    ``--profile-dir`` (inert otherwise); the Chrome trace path is linked
    into the request's span tree and ``done`` event.  Like the QoS
    fields it never enters ``engine_key``/``batch_key`` -- a profiled
    request runs the same warm engine and stays bit-identical.

    ``max_retries`` (default 0) is the fault-tolerance budget: how many
    times the scheduler may re-dispatch this request after a
    *transient* failure (see ``faults.classify_error``) with bounded
    exponential backoff before giving up.  Retries are reported in the
    ``done`` event (``retries`` field, only when > 0) and metered.
    Like the QoS fields it rides the wire but never enters
    ``engine_key``/``batch_key`` -- a retried request re-dispatches on
    the same warm engine, and determinism makes the replayed chunks
    bit-identical.
    """

    config: str = "smoke"
    members: int = 2
    lead_steps: int = 4
    lead_chunk: int = 2
    precision: str = "float32"
    kernels: str = "auto"
    perturb: str = "none"
    perturb_amplitude: float = 0.05
    bred_cycles: int = 3
    ensemble_transform: bool = False
    spectra: bool = False
    scored: bool = True
    sample: int = 0
    seed: int = 7
    return_state: bool = False
    coalesce: bool = True
    priority: str = "batch"
    deadline_ms: float | None = None
    degrade: bool = False
    profile: bool = False
    max_retries: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "RequestSpec":
        """Build a spec from a JSON object, rejecting unknown fields by
        name (a typo must 400, not silently take a default)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(
                f"unknown request field(s) {unknown}; "
                f"expected a subset of {sorted(names)}")
        return cls(**d)

    def to_dict(self) -> dict:
        """The spec as a JSON-ready dict (the POST body, exactly)."""
        return dataclasses.asdict(self)

    def perturbation_config(self):
        """The ``PerturbationConfig`` this spec's perturb fields select."""
        from repro_torch.inference import PerturbationConfig
        return PerturbationConfig(kind=self.perturb,
                                  amplitude=self.perturb_amplitude,
                                  bred_cycles=self.bred_cycles,
                                  ensemble_transform=self.ensemble_transform)

    def engine_config(self):
        """The ``EngineConfig`` a warm engine for this spec runs with."""
        from repro_torch.inference import EngineConfig
        from repro_torch.kernels import autotune
        from repro_torch.kernels.config import KernelConfig
        # "pallas" names the port's hand-written kernels ("kernel"); the
        # installed tunings ride the config, hence engine_key and every
        # cache key derived from it
        kernels = autotune.resolve_kernel_config(
            None if self.kernels == "auto" else KernelConfig(
                sht=_KERNEL_PATHS[self.kernels],
                disco=_KERNEL_PATHS[self.kernels]))
        return EngineConfig(members=self.members,
                            lead_chunk=self.lead_chunk,
                            compute_dtype=self.precision,
                            perturb=self.perturbation_config(),
                            spectra=self.spectra,
                            kernels=kernels)

    def engine_key(self) -> tuple:
        """The warm-engine (shape) key: every field that selects a
        different warm engine."""
        return (self.config, self.engine_config())

    def batch_key(self) -> tuple:
        """Requests that may share one coalesced rollout dispatch: same
        warm engine, same rollout length, same score set.
        ``sample``/``seed``/``return_state`` stay free -- they are
        per-request inputs of the shared batched rollout."""
        return (self.engine_key(), self.lead_steps, self.scored)

    def degraded_members(self) -> int:
        """The validated floor of the member count -- what an opted-in
        near-deadline request is served with instead of missing.  The
        smallest count >= 2 that still passes the perturbation rules
        (centered noise needs an even count, ensemble transform needs
        enough independent draws); >= 2 keeps the forecast a real
        ensemble, so scores stay probabilistic.  Falls back to the
        requested count when nothing smaller validates."""
        from repro_torch.inference import perturbations as perturblib
        pcfg = self.perturbation_config()
        for m in range(2, self.members):
            if not perturblib.validate_member_count(m, centered=True,
                                                    cfg=pcfg):
                return m
        return self.members

    _INT_FIELDS = ("members", "lead_steps", "lead_chunk", "bred_cycles",
                   "sample", "seed", "max_retries")
    _BOOL_FIELDS = ("ensemble_transform", "spectra", "scored",
                    "return_state", "coalesce", "degrade", "profile")
    _STR_FIELDS = ("config", "precision", "perturb", "kernels", "priority")

    def _type_problems(self) -> list[str]:
        """JSON is typed; the spec must be too -- members=2.0 or
        lead_steps=true would otherwise survive until mid-rollout."""
        problems = []
        for name in self._INT_FIELDS:
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int):
                problems.append(f"{name} must be an integer, got {v!r}")
        for name in self._BOOL_FIELDS:
            if not isinstance(getattr(self, name), bool):
                problems.append(f"{name} must be a boolean, "
                                f"got {getattr(self, name)!r}")
        for name in self._STR_FIELDS:
            if not isinstance(getattr(self, name), str):
                problems.append(f"{name} must be a string, "
                                f"got {getattr(self, name)!r}")
        v = self.perturb_amplitude
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            problems.append(f"perturb_amplitude must be a number, got {v!r}")
        v = self.deadline_ms
        if v is not None and (isinstance(v, bool)
                              or not isinstance(v, (int, float))):
            problems.append(
                f"deadline_ms must be a number or null, got {v!r}")
        return problems

    def validate(self) -> None:
        """Raise ValueError listing every problem (nothing built yet)."""
        problems = self._type_problems()
        if problems:
            # type errors first; the value checks below assume them
            raise ValueError("; ".join(problems))
        from repro_torch.configs import fcn3 as fcn3cfg
        from repro_torch.inference import perturbations as perturblib
        if self.config not in fcn3cfg.NAMED_CONFIGS:
            problems.append(
                f"unknown config {self.config!r}; expected one of "
                f"{sorted(fcn3cfg.NAMED_CONFIGS)}")
        if self.lead_steps < 1:
            problems.append(f"lead_steps must be >= 1, got {self.lead_steps}")
        if self.lead_chunk < 1:
            problems.append(f"lead_chunk must be >= 1, got {self.lead_chunk}")
        if self.precision not in PRECISIONS:
            problems.append(
                f"precision must be one of {PRECISIONS}, "
                f"got {self.precision!r}")
        if self.kernels not in KERNEL_MODES:
            problems.append(
                f"kernels must be one of {KERNEL_MODES}, "
                f"got {self.kernels!r}")
        if self.priority not in PRIORITIES:
            problems.append(
                f"priority must be one of {PRIORITIES}, "
                f"got {self.priority!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            problems.append(
                f"deadline_ms must be positive, got {self.deadline_ms}")
        if not 0 <= self.max_retries <= 8:
            problems.append(
                f"max_retries must be in [0, 8], got {self.max_retries}")
        try:
            pcfg = self.perturbation_config()
        except ValueError as e:
            problems.append(str(e))
        else:
            # the engine always centers the conditioning noise
            problems += perturblib.validate_member_count(
                self.members, centered=True, cfg=pcfg)
        if problems:
            raise ValueError("; ".join(problems))
