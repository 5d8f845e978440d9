"""Ensemble forecast engine: the autoregressive FCN3 rollout with in-loop
scoring (paper Section 5 / Appendix G.4).

Per lead: AR(1) spherical noise to the grid (inverse SHT), antithetic
centering, one FCN3 step over all members at once (the members are a
leading batch dim, where the JAX engine ``vmap``s), the noise transition,
and fair CRPS / ensemble-mean RMSE / spread / spread-skill ratio / rank
histogram against the verifying state; ``spectra=True`` adds per-degree
energy spectra.  Raw member fields never leave the device.  The rollout
is a plain loop under ``torch.inference_mode``; it yields one result per
``lead_chunk`` leads.

Design points:

* **Coalesced requests.**  ``stream_batched`` rolls B same-shape requests
  through one step over a leading request axis (the carries are (B, E,
  ...)); noise centering, scores and draws stay per request, so each
  request matches its own serial rollout (to rounding: the products run
  at another batch size).  ``stream`` is the B = 1 case.  ``survivors``
  shrinks a running batch onto the requests still wanted.
* **Precision policy** (``compute_dtype="bfloat16"``), as the JAX engine
  computes it: the parameters, the geometry buffers and the carried state
  are rounded to bf16, every product runs in fp32 on the widened values
  (the kernels take fp32 operands), the step's output is rounded back to
  bf16 each lead, and the scores and the noise process stay fp32.
* **Initial-condition perturbations** (``EngineConfig.perturb``,
  ``repro_torch.inference.perturbations``): obs-error sampling or bred
  vectors, made on the device by ``init_carry``.  Their draws come from a
  stream apart from the noise process's, so ``kind="none"`` and ``"obs"``
  leave the noise draws unchanged.
* **Overlapped host transfers.**  ``_ChunkStager`` materializes chunk k+1's
  aux/truth on a worker thread while chunk k computes; host data goes
  through pinned memory and a non-blocking copy on a copy stream, and the
  compute stream waits on the copy's event.  Device data (and callables,
  which may read it) is read on the copy stream only after it has waited
  for the compute stream's work launched before the chunk was scheduled.
  Each (distinct source, step)
  is staged once per rollout (the ``h2d_chunks``/``h2d_steps`` counters).

Noise draws come from a ``NoiseSource``: ``GeneratorNoise`` (a
``torch.Generator``, the default) or ``InjectedNoise`` (given draws, so a
test can replay the JAX reference's threefry stream).

Serving hooks (``repro_torch.serving``): ``plan_exports`` (the geometry
plans a warm-start bundle packs), ``estimated_bytes`` (the engine pool's
memory budget) and the counterpart of the JAX engine's ``compile_chunk``
/ ``has_chunk_executable``.  The port compiles no chunk program: warming
a key loads the kernel libraries its path launches
(``kernel_libraries``, loaded by the serving cache) and makes the
adapted buffers and precision casts resident (``make_resident``), and
never runs a rollout; ``mark_warm`` / ``is_warm`` keep the warmed
(scored, chunk_len, batch) keys.

Member sharding (paper G.1, ``EngineConfig.member_axes``, the JAX
engine's ``_constrain``): with a ``DeviceMesh`` each rank of the group
over those axes (several axes flattened onto the member dim,
``compat.mesh_group``) rolls out its block of the members
(``dist_crps.member_block``: whole +/- pairs where there are enough, so
any E >= R splits, unevenly if need be).  Every rank draws the whole
(E, ...) noise from the same ``NoiseSource``, so the draws equal one
process's, and carries every member's coefficients; under centering a
member's grid noise is its even partner's, negated for the odd one, so a
rank transforms only the even members of the pairs it touches (one path:
without ``member_axes`` the block is all E members, and the engine
transforms ceil(E/2) members' noise a lead, not E).  A rank
that holds the odd member of a pair that straddles ranks transforms its
partner's coefficients in place of its own: one inverse SHT of
``n_proc`` fields a lead, the count it would have spent on its own, and
no collective.  Perturbed members are made whole-ensemble-equal the same
way (``InitialConditionPerturbation.members(block=...)``).  The scores
cross ranks each lead: one ragged all-to-all over the group gathers
every member on the rank's block of the H*W points of each channel
(``dist_crps.scatter_points``, Algorithm 3's step 1); the fair CRPS runs
through the CRPS kernel there (``dist_crps_channels``), and the weighted
squared error of the mean, the unbiased variance, the per-ring rank
counts (contracted with the ring weights) and the spectra's member sums
are psummed before any square root or division.  Every rank returns the
same scores; ``final_state`` holds the rank's members and
``final_noise`` every member's coefficients.  The collectives go through
``distributed.compat`` and are timed there.

Not ported: the JAX engine's ``lower/export/import_chunk`` (no program to
lower or export), ``donate`` and ``static_buffers`` (XLA-only).
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, Protocol

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.fcn3 import FCN3
from repro_torch.core.sphere import disco as discolib
from repro_torch.core.sphere import legendre as leg
from repro_torch.distributed import compat
from repro_torch.distributed.dist_crps import (dist_crps_channels,
                                               member_block, scatter_points)
from repro_torch.evaluation import metrics
from repro_torch.inference import perturbations as perturblib
from repro_torch.kernels.config import KernelConfig, library_of

#: salt that seeds the perturbation draws' generator apart from the noise
#: process's (the JAX engine's ``fold_in`` salt)
_PERTURB_SALT = 0x5EED

#: score names an engine forecast can emit, in emission order.
SCORE_NAMES = ("crps", "ens_rmse", "spread", "ssr", "rank_hist",
               "spectrum", "spectrum_truth")

#: the step's compute dtypes: fp32, or the bf16 policy
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def in_scan_rank_histogram(ens: torch.Tensor, target: torch.Tensor,
                           area_weights: torch.Tensor) -> torch.Tensor:
    """(C, E+1) area-weighted rank histogram.

    Ranks are comparison counts, binned by one ``torch.bincount`` over
    (channel, latitude ring, rank) segments -- O(E) memory per grid point
    and no (H, W, E+1) one-hot -- then contracted with the ring weights
    exactly as ``metrics.rank_histogram_per_channel``.
    """
    e = ens.shape[0]
    rank = (ens < target[None]).sum(dim=0)                     # (C, H, W)
    c, h, _ = rank.shape
    seg = rank + (e + 1) * torch.arange(
        c * h, device=rank.device).reshape(c, h, 1)
    counts = torch.bincount(seg.reshape(-1), minlength=c * h * (e + 1))
    return metrics.ring_contract(counts.reshape(c, h, e + 1), area_weights)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Forecast-engine hyperparameters.

    members:       ensemble size E (antithetic pairs when ``centered``).
    lead_chunk:    leads per yielded result block (and per staged chunk).
    centered:      antithetic noise centering (paper E.3).
    compute_dtype: "float32" or "bfloat16" (the bf16 policy, see the
                   module docstring); scores always accumulate in fp32.
    perturb:       initial-condition perturbation of the members (paper
                   App. E); "none" replicates the analysis state.  Pass a
                   data-derived ``InitialConditionPerturbation`` to the
                   engine for climatological scaling -- the fallback
                   sampler uses channel_std=1 and the generic spectrum.
    spectra:       add the per-degree energy spectra "spectrum" (member
                   mean) and "spectrum_truth" (when truth is given).
    kernels:       path of the model's hot contractions; None keeps the
                   model's own ``FCN3Config.kernels``, another config
                   re-homes the engine's model view (and its buffer
                   layout) on that path.
    member_axes:   mesh axes of the leading ensemble dim (paper G.1), e.g.
                   ("model",); several axes all shard the member dim.
                   The engine then needs the ``mesh`` that names them
                   (see the module docstring); None runs every member in
                   this process.
    """

    members: int = 4
    lead_chunk: int = 8
    centered: bool = True
    compute_dtype: str = "float32"
    perturb: perturblib.PerturbationConfig = perturblib.PerturbationConfig()
    spectra: bool = False
    kernels: KernelConfig | None = None
    member_axes: tuple | None = None

    def __post_init__(self):
        if self.members < 1:
            raise ValueError(f"members must be >= 1, got {self.members}")
        if self.lead_chunk < 1:
            raise ValueError(
                f"lead_chunk must be >= 1, got {self.lead_chunk}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}, got "
                             f"{self.compute_dtype!r}")
        if self.member_axes is not None and not (
                isinstance(self.member_axes, tuple) and self.member_axes
                and all(isinstance(a, str) for a in self.member_axes)):
            raise ValueError(f"member_axes must be a non-empty tuple of mesh "
                             f"axis names, got {self.member_axes!r}")

    @property
    def tdtype(self) -> torch.dtype:
        """The carried state's torch dtype."""
        return COMPUTE_DTYPES[self.compute_dtype]


@dataclasses.dataclass
class ForecastResult:
    """Scores for a contiguous block of lead times.

    lead_steps: (T,) 0-based lead indices; lead i verifies at t0 + 6h*(i+1).
    scores: fp32, keyed by name (see ``SCORE_NAMES``): per-channel (T, C)
      "crps"/"ens_rmse"/"spread"/"ssr" and the (T, C, E+1) "rank_hist"
      when truth is given; (T, C, L) "spectrum" and "spectrum_truth" with
      ``spectra=True``.  Empty when neither applies.
    diagnostics: the engine's ``diagnostics`` output, stacked over leads.
    final_state / final_noise: the ensemble carry after the last lead of
      the rollout (set on the final block only).
    """

    lead_steps: np.ndarray
    scores: dict[str, torch.Tensor]
    diagnostics: Any | None = None
    final_state: torch.Tensor | None = None
    final_noise: torch.Tensor | None = None


def _tree_map(fn: Callable[[list], torch.Tensor], trees: list):
    """``fn`` over the leaves of same-structured trees (tensor, dict, list
    or tuple), leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, list(ts)) for ts in zip(*trees))
    return fn(trees)


def _concat_results(parts: list[ForecastResult]) -> ForecastResult:
    diag = None
    if parts[0].diagnostics is not None:
        diag = _tree_map(torch.cat, [p.diagnostics for p in parts])
    return ForecastResult(
        lead_steps=np.concatenate([p.lead_steps for p in parts]),
        scores={k: torch.cat([p.scores[k] for p in parts])
                for k in parts[0].scores},
        diagnostics=diag,
        final_state=parts[-1].final_state,
        final_noise=parts[-1].final_noise)


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of a (nested dict) tree."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


def _cast_floats(tree, dtype: torch.dtype):
    """Every floating leaf of a (nested dict) tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


class NoiseSource(Protocol):
    """Where the noise process's white draws come from (the engine's
    rollout and the trainer's both read them)."""

    def initial(self, model: FCN3, batch_shape: tuple[int, ...],
                buffers: dict) -> torch.Tensor:
        """z_hat at lead 0: (*batch_shape, n_proc, L, M) complex64."""

    def eta(self, model: FCN3, n: int, z_hat: torch.Tensor, buffers: dict
            ) -> torch.Tensor:
        """The white draw of the AR(1) update after lead ``n``."""

    def perturbation_draws(self) -> perturblib.PerturbationDraws:
        """The initial-condition perturbations' draws, a stream apart
        from the noise process's."""


class GeneratorNoise:
    """Draws from a ``torch.Generator`` (on the model's device); the
    perturbations draw from a second generator seeded from its seed and
    ``_PERTURB_SALT``, so they take nothing from the noise stream."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def initial(self, model, batch_shape, buffers):
        """Initial noise state drawn from the generator."""
        return model.noise.init_state(self.generator, batch_shape, buffers)

    def eta(self, model, n, z_hat, buffers):
        """White spectral draws for lead ``n``."""
        return model.noise.sample_coeffs(self.generator, z_hat.shape[:-3],
                                         buffers)

    def perturbation_draws(self):
        """A generator of its own, seeded from this one's seed."""
        g = torch.Generator(device=self.generator.device)
        g.manual_seed(self.generator.initial_seed() ^ _PERTURB_SALT)
        return perturblib.GeneratorDraws(g)


class InjectedNoise:
    """Given draws: ``z_hat0`` (*batch, n_proc, L, M), ``etas[n]`` per
    lead, and ``perturb``, the perturbations' coefficients (K, C, L, M)."""

    def __init__(self, z_hat0, etas, perturb=None):
        self.z_hat0 = z_hat0
        self.etas = etas
        self.perturb = perturb

    def initial(self, model, batch_shape, buffers):
        """The injected initial noise state."""
        z = torch.as_tensor(self.z_hat0).to(model.device)
        if tuple(z.shape[:-3]) != tuple(batch_shape):
            raise ValueError(f"injected z_hat0 has batch {tuple(z.shape[:-3])}"
                             f", the caller wants {tuple(batch_shape)}")
        return z

    def eta(self, model, n, z_hat, buffers):
        """The injected white draws of lead ``n``."""
        return torch.as_tensor(self.etas[n]).to(z_hat.device)

    def perturbation_draws(self):
        """The injected perturbation coefficients."""
        if self.perturb is None:
            raise ValueError("perturbed members need injected perturbation "
                             "coefficients (InjectedNoise(perturb=...))")
        return perturblib.InjectedDraws(self.perturb)


class _ChunkStager:
    """Double-buffered staging of per-chunk inputs.

    ``get(i)`` hands back chunk i's staged inputs and schedules chunk i+1
    on a worker thread, so the host work and the copy overlap chunk i's
    compute.  Staged chunks wait until consumed, so no chunk is staged
    twice: bred init ``peek``s chunk 0 for its aux fields, and the coming
    ``get(0)`` takes the same copy.  ``mark()`` runs on the consumer's
    thread when a chunk is scheduled, and its result is handed to
    ``stage_fn(start, k, mark)`` (the engine's event on the compute
    stream).
    """

    def __init__(self, bounds: list[tuple[int, int]],
                 stage_fn: Callable[[int, int, Any], dict],
                 mark: Callable[[], Any] = lambda: None):
        self._bounds = bounds
        self._stage_fn = stage_fn
        self._mark = mark
        self._ready: dict[int, dict] = {}
        self._futures: dict[int, Future] = {}
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="h2d-stager")

    def _materialize(self, i: int, mark: Any) -> dict:
        return self._stage_fn(*self._bounds[i], mark)

    def _take(self, i: int) -> dict:
        xs = self._ready.pop(i, None)
        if xs is not None:
            return xs
        fut = self._futures.pop(i, None)
        return (fut.result() if fut is not None
                else self._materialize(i, self._mark()))

    def peek(self, i: int) -> dict:
        """Stage chunk i now and keep it for the coming ``get(i)``."""
        self._ready.setdefault(i, self._take(i))
        return self._ready[i]

    def get(self, i: int) -> dict:
        """Staged inputs of chunk i; prefetches chunk i+1."""
        xs = self._take(i)
        j = i + 1
        if j < len(self._bounds) and j not in self._ready \
                and j not in self._futures:
            self._futures[j] = self._ex.submit(self._materialize, j,
                                               self._mark())
        return xs

    def close(self) -> None:
        """Stop the worker after its current chunk; a chunk never taken
        is dropped."""
        for fut in self._futures.values():
            fut.cancel()
        self._ex.shutdown(wait=True)


class ForecastEngine:
    """Autoregressive ensemble forecaster for an FCN3 model.

        eng = ForecastEngine(model, EngineConfig(members=8))
        res = eng.forecast(buffers, state0, aux, noise, truth=truth)
        res.scores["crps"]          # (T, C) fair CRPS per lead/channel

    ``aux``/``truth`` are stacked (T, ., H, W) tensors or arrays, or
    ``fn(step) -> (., H, W)`` callables (then ``steps=`` is required).
    ``diagnostics`` (optional) maps each lead's fp32 ensemble state to a
    tensor or a dict/list of tensors, stacked over leads into
    ``ForecastResult.diagnostics``.

    Under the bf16 policy the model runs on a bf16 copy of its parameters
    through ``torch.func.functional_call``, which swaps them into the
    module for the call: one engine drives its model from one thread.

    With ``cfg.member_axes``, ``mesh`` is the ``DeviceMesh`` they name
    (construction is then collective over the world when several axes
    need a group of their own); every rank of the group runs the same
    calls, and ``diagnostics`` sees the rank's members.
    """

    def __init__(self, model: FCN3, cfg: EngineConfig,
                 diagnostics: Callable[[torch.Tensor], Any] | None = None,
                 perturbation: perturblib.InitialConditionPerturbation
                 | None = None, mesh=None):
        if cfg.kernels is not None and cfg.kernels != model.cfg.kernels:
            # a view on the other path: the same parameters and geometry
            # plans, another config (hence another buffer layout)
            model = copy.copy(model)
            model.cfg = dataclasses.replace(model.cfg, kernels=cfg.kernels)
        self.model = model
        self.cfg = cfg
        self.diagnostics = diagnostics
        #: the member group, this rank's members [lo, hi) and every
        #: rank's member count (None: all members in this process)
        self.group, self.block, self.counts = None, (0, cfg.members), None
        if cfg.member_axes is not None:
            if mesh is None:
                raise ValueError(f"member_axes {cfg.member_axes} need the "
                                 "mesh that names them")
            self.group = compat.mesh_group(mesh, cfg.member_axes)
            n = compat.axis_size(self.group)
            blocks = [member_block(cfg.members, q, n) for q in range(n)]
            self.block = blocks[compat.axis_index(self.group)]
            self.counts = [hi - lo for lo, hi in blocks]
        elif mesh is not None:
            raise ValueError("a mesh without member_axes: the engine has "
                             "no other placement")
        # the model's device with its index ("cuda" alone never equals a
        # tensor's device), to tell staged sources already on it
        self._device = model.device
        if model.device.type == "cuda" and model.device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self.noise_buffers = model.noise_buffers()
        self.area_weights = torch.from_numpy(
            model.grid_in.area_weights_2d().astype(np.float32)).to(
                model.device)
        # EngineConfig.perturb alone decides whether and how members are
        # perturbed; an explicit sampler only brings data-derived
        # spectrum and std, so its config must match exactly
        if perturbation is not None and perturbation.cfg != cfg.perturb:
            raise ValueError(
                "EngineConfig.perturb and the explicit perturbation "
                "sampler's config disagree; build both from the same "
                "PerturbationConfig")
        if perturbation is None and cfg.perturb.active:
            perturbation = perturblib.InitialConditionPerturbation(
                model.in_sht, cfg.perturb, model.grid_in.area_weights_2d(),
                device=model.device)
        self.perturbation = perturbation
        self._wpct: torch.Tensor | None = None
        self._copy_stream = None
        self._cast_cache: dict[str, tuple] = {}
        #: warmed (scored, chunk_len, batch) keys (``mark_warm``)
        self._warm: set[tuple] = set()
        self.dispatch_counts = {"chunks": 0, "h2d_chunks": 0,
                                "h2d_steps": 0, "shrinks": 0}
        # the stager's worker ticks the staging counts
        self._count_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._count_lock:
            self.dispatch_counts[name] += n

    def dispatch_stats(self) -> dict:
        """Copy of the counters: "chunks" dispatched, "h2d_chunks" /
        "h2d_steps" staged (one per staged chunk and per (distinct aux
        source, step) per rollout, or staging is duplicating copies) and
        "shrinks" of a coalesced rollout."""
        with self._count_lock:
            return dict(self.dispatch_counts)

    def _layout_matches(self, buffers: dict) -> bool:
        """Whether ``buffers`` are in this engine's DISCO layout."""
        want = self.model.cfg.kernels.disco == "kernel"
        return ("psi_band" in buffers["enc"]) == want

    def _param_stamp(self) -> tuple:
        return tuple((id(p), p._version)
                     for p in self.model.parameters())

    def _adapt_buffers(self, buffers: dict) -> dict:
        """The caller's buffers in this engine's layout: an engine
        re-homed by ``EngineConfig.kernels`` rebuilds them when the
        layout differs (geometry is deterministic, so the rebuild is
        exact), once per incoming object."""
        if self._layout_matches(buffers):
            return buffers
        entry = self._cast_cache.get("layout")
        if entry is None or entry[0] is not buffers:
            entry = (buffers, self.model.make_buffers())
            self._cast_cache["layout"] = entry
        return entry[1]

    def _prepare_inputs(self, buffers: dict) -> tuple[dict | None, dict]:
        """(params, buffers) of the step under the kernel-layout and
        precision policies: params None means the model's own fp32
        parameters; under bf16 a bf16 copy of the parameters (recast when
        any parameter changed) and of the buffers (recast per incoming
        object)."""
        buffers = self._adapt_buffers(buffers)
        dt = self.cfg.tdtype
        if dt == torch.float32:
            return None, buffers
        named = dict(self.model.named_parameters())
        stamp = self._param_stamp()
        entry = self._cast_cache.get("params")
        with torch.no_grad():
            if entry is None or entry[0] != stamp:
                entry = (stamp, {k: p.detach().to(dt)
                                 for k, p in named.items()})
                self._cast_cache["params"] = entry
            params = entry[1]
            bentry = self._cast_cache.get("buffers")
            if bentry is None or bentry[0] is not buffers:
                bentry = (buffers, _cast_floats(buffers, dt))
                self._cast_cache["buffers"] = bentry
        return params, bentry[1]

    def _apply(self, params: dict | None, buffers: dict, s: torch.Tensor,
               cond: torch.Tensor) -> torch.Tensor:
        """One model step on the prepared params/buffers."""
        if params is None:
            return self.model(buffers, s, cond)
        return torch.func.functional_call(self.model, params,
                                          (buffers, s, cond))

    @property
    def spectral_wpct(self) -> torch.Tensor:
        """The IO-resolution forward-SHT table of the spectra (fp32,
        built at first use: 1.5 GB at 721x1440)."""
        if self._wpct is None:
            wpct, _ = self.model.in_sht.tables()
            self._wpct = torch.from_numpy(wpct.astype(np.float32)).to(
                self.model.device)
        return self._wpct

    # -- serving hooks ---------------------------------------------------
    def kernel_libraries(self) -> tuple[tuple[str, tuple], ...]:
        """``kernel_libraries`` of this engine's model (its config's
        kernel paths and tiles)."""
        return kernel_libraries(self.model)

    def make_resident(self, buffers: dict) -> None:
        """Set up everything the step reads besides the caller's own
        tensors, without running it: the buffers in this engine's layout,
        the bf16 copies under the bf16 policy and the spectra's table."""
        self._prepare_inputs(buffers)
        if self.cfg.spectra:
            self.spectral_wpct  # noqa: B018 -- built at first use

    def is_resident(self, buffers: dict) -> bool:
        """Whether ``make_resident(buffers)`` has nothing left to do."""
        if not self._layout_matches(buffers):
            entry = self._cast_cache.get("layout")
            if entry is None or entry[0] is not buffers:
                return False
            buffers = entry[1]
        if self.cfg.tdtype != torch.float32:
            params = self._cast_cache.get("params")
            bufs = self._cast_cache.get("buffers")
            if (params is None or params[0] != self._param_stamp()
                    or bufs is None or bufs[0] is not buffers):
                return False
        return not self.cfg.spectra or self._wpct is not None

    def mark_warm(self, scored: bool, chunk_len: int,
                  batch: int | None = None) -> None:
        """Record a warmed (scored, chunk_len, batch) key."""
        with self._count_lock:
            self._warm.add((scored, chunk_len, batch))

    def is_warm(self, scored: bool, chunk_len: int, buffers: dict,
                batch: int | None = None) -> bool:
        """Whether the key was warmed and its inputs are still resident
        for these ``buffers`` (the JAX engine's ``has_chunk_executable``)."""
        with self._count_lock:
            warmed = (scored, chunk_len, batch) in self._warm
        return warmed and self.is_resident(buffers)

    def estimated_bytes(self) -> int:
        """Estimated device bytes of this engine's warm state.

        The engine's own tensors, counted from ``nbytes``: the noise
        tables, the area weights, the layout and precision copies and the
        spectra's table (the model's parameters and geometry buffers are
        shared by every engine on the model and are not counted).  Then,
        per warm (scored, chunk_len, batch) key, the working set of its
        N = batch x members member-states: the carries (state and noise
        coefficients, in and out), the staged inputs (two chunks of aux,
        and truth when scored) and the step's live set at its peak
        (``_step_peak_bytes``).  The serving pool evicts engines on this
        number; ``chip_smoke.py``'s ``[service]`` phase fails if it and
        the model's bytes fall below the measured peak."""
        total = _tree_nbytes(self.noise_buffers) + self.area_weights.nbytes
        for entry in list(self._cast_cache.values()):
            total += _tree_nbytes(entry[1])
        if self._wpct is not None:
            total += self._wpct.nbytes
        m, cfg = self.model, self.cfg
        h, w = m.grid_in.nlat, m.grid_in.nlon
        item = torch.tensor([], dtype=cfg.tdtype).element_size()
        with self._count_lock:
            warm = list(self._warm)
        for scored, k, batch in warm:
            n = (batch or 1) * cfg.members
            state = n * m.cfg.n_state * h * w * item
            noise = n * m.noise.n_proc * m.in_sht.lmax * m.in_sht.mmax * 8
            xs = ((batch or 1) * k * (m.cfg.n_aux
                                      + (m.cfg.n_state if scored else 0))
                  * h * w * 4)
            total += 2 * (state + noise) + 2 * xs + self._step_peak_bytes(n)
        return int(total)

    def _step_peak_bytes(self, n: int) -> int:
        """fp32 bytes one step over ``n`` member-states holds at its
        peak, in the decoder.  Either the bilinear upsample
        (``interp.BilinearResample``): the latent, its longitudinal pass
        on the latent rows and two pole rows at the IO width, and at the
        IO grid two weighted row gathers and their sum, live together.
        Or the DISCO decoders: the upsampled latent, one contraction
        chunk (capped at ``Z_CHUNK_BYTES``) and its merge.  At fcn3_full
        the upsample is the larger, 10.0 GB a member-state."""
        m = self.model
        c = m.cfg.c_latent
        h, w = m.grid_in.nlat, m.grid_in.nlon
        hl, wl = m.grid_latent.nlat, m.grid_latent.nlon
        io = n * c * h * w * 4
        upsample = n * c * (hl * wl + (hl + 2) * w) * 4 + 3 * io
        chunk = min(discolib.Z_CHUNK_BYTES, n * c * m.n_basis * h * w * 4)
        return max(upsample, io + 2 * chunk)

    def plan_exports(self) -> list[dict]:
        """Serializable geometry-plan payloads for warm-start bundles, as
        the JAX engine exports them: the three DISCO plans (encoder,
        latent, decoder; deduplicated by ``DiscoPlan.plan_key``) and the
        Legendre tables of the IO and latent SHTs (deduplicated by
        ``legendre.table_key``).  A replica installs them with
        ``core.sphere.disco.install_plan`` and
        ``legendre.install_legendre_table`` instead of building them.
        Plain scalars and numpy arrays (npz-friendly)."""
        m = self.model
        payloads: list[dict] = []
        seen: set = set()
        for plan in (m.enc_plan, m.latent_plan, m.dec_plan):
            key = ("disco",) + plan.plan_key()
            if key in seen:
                continue
            seen.add(key)
            payloads.append({"kind": "disco", **discolib.export_plan(plan)})
        for sht in (m.in_sht, m.latent_sht):
            colat = np.ascontiguousarray(sht.grid.colat, np.float64)
            key = ("legendre",) + leg.table_key(sht.lmax, sht.mmax, colat)
            if key in seen:
                continue
            seen.add(key)
            payloads.append({
                "kind": "legendre", "lmax": sht.lmax, "mmax": sht.mmax,
                "colat": colat,
                "table": leg.cached_legendre_table(sht.lmax, sht.mmax,
                                                   colat)})
        return payloads

    # ------------------------------------------------------------------
    def init_carry(self, state0, noise: NoiseSource,
                   buffers: dict | None = None,
                   aux0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(E, C, H, W) member states in the compute dtype and the lead-0
        noise coefficients, from one (C, H, W) analysis state; with
        ``member_axes`` the rank's members (E_loc, C, H, W) and every
        member's coefficients.

        With an active perturbation the members are perturbed on the
        device; bred vectors also need ``buffers`` and ``aux0`` (the
        frozen conditioning fields of the breeding rollouts, which run the
        control dynamics in fp32 with zero noise channels).  A rank makes
        the members a whole ensemble would hold in its block; bred
        vectors cost it the control's rollout plus one per draw its
        members take (every draw under the ensemble transform, which
        mixes them).
        """
        e, m = self.cfg.members, self.model
        lo, hi = self.block
        z_hat = noise.initial(m, (e,), self.noise_buffers)
        s0 = torch.as_tensor(state0).to(m.device).float()
        pc = self.cfg.perturb
        if not pc.active:
            s = s0.expand((hi - lo,) + tuple(s0.shape))
            return s.to(self.cfg.tdtype).contiguous(), z_hat
        step_fn = None
        if pc.kind == "bred":
            if buffers is None or aux0 is None:
                raise ValueError("bred perturbations need buffers= and aux0=")
            params, pbufs = self._prepare_inputs(buffers)
            cond = torch.cat([aux0.float(), torch.zeros(
                (m.cfg.n_noise,) + tuple(s0.shape[-2:]), device=m.device)])

            def step_fn(s):
                return self._apply(params, pbufs, s, cond).float()

        pert = self.perturbation
        # the noise process runs on in_sht: reuse its table when the
        # sampler shares that SHT
        sht_buffers = self.noise_buffers if pert.sht is m.in_sht else None
        s = pert.members(noise.perturbation_draws(), s0, e, step_fn,
                         sht_buffers=sht_buffers,
                         block=self.block)
        return s.to(self.cfg.tdtype), z_hat

    def noise_fields(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Grid-space conditioning noise as the step sees it, centered over
        the member dim (the fourth from the end): this engine's block of
        members (all of them without ``member_axes``) from every member's
        coefficients, as ``center_noise`` of the whole ensemble's fields
        would give them."""
        to_grid, nb = self.model.noise.to_grid, self.noise_buffers
        lo, hi = self.block
        if not self.cfg.centered:
            return to_grid(z_hat[..., lo:hi, :, :, :], nb)
        # member j takes the field of pair j // 2's even member, negated
        # when j is odd
        p0 = lo // 2
        z = to_grid(z_hat[..., 2 * p0:hi:2, :, :, :], nb)
        j = torch.arange(lo, hi, device=z.device)
        sign = (1 - 2 * (j % 2)).to(z.dtype)
        return z.index_select(-4, j // 2 - p0) * sign.reshape(-1, 1, 1, 1)

    def scores(self, sf: torch.Tensor, truth: torch.Tensor | None
               ) -> dict[str, torch.Tensor]:
        """One lead's in-loop reductions of one request's fp32 members
        (E, C, H, W): the five scores when truth is given, and the spectra
        with ``spectra=True``; each per channel.  With ``member_axes``
        ``sf`` is the rank's members and the scores are the whole
        ensemble's (``_group_scores``)."""
        if self.group is not None:
            return self._group_scores(sf, truth)
        aw = self.area_weights
        out = {}
        if truth is not None:
            out = {
                "crps": metrics.crps(sf, truth, aw),
                "ens_rmse": metrics.ensemble_skill(sf, truth, aw),
                "spread": metrics.ensemble_spread(sf, aw),
                "ssr": metrics.spread_skill_ratio(sf, truth, aw),
                "rank_hist": in_scan_rank_histogram(sf, truth, aw),
            }
        if self.cfg.spectra:
            out["spectrum"] = metrics.ensemble_spectrum(sf,
                                                        self.spectral_wpct)
            if truth is not None:
                out["spectrum_truth"] = metrics.angular_psd(
                    truth, self.spectral_wpct)
        return out

    def _group_scores(self, sf: torch.Tensor, truth: torch.Tensor | None
                      ) -> dict[str, torch.Tensor]:
        """``scores`` of the whole ensemble from this rank's members
        (E_loc, C, H, W), the same on every rank of the member group.

        Every member is gathered on this rank's block of the H*W points
        of each channel (one ragged all-to-all); the fair CRPS is the
        CRPS kernel's there, and the weighted squared error of the
        ensemble mean, the unbiased variance and the per-ring rank counts
        (rings are point index // W, and a block may end mid-ring) are
        summed over the group before the square roots; the spectra are
        the members' sums, summed over the group and divided by E."""
        g, e, aw = self.group, self.cfg.members, self.area_weights
        c, h, w = sf.shape[1:]
        parts, out = [], {}
        if truth is not None:
            ens, (lo, hi) = scatter_points(sf.reshape(sf.shape[0], c, h * w),
                                           g, self.counts)
            obs = truth.reshape(c, h * w)[:, lo:hi]
            wts = aw.reshape(-1)[lo:hi]
            den = aw.sum()
            out["crps"] = dist_crps_channels(
                ens, obs, wts, g,
                blocks=self.model.cfg.kernels.blocks_for("crps")) / den
            rank = (ens < obs[None]).sum(dim=0)                # (C, S_r)
            r0, nr = lo // w, (hi - 1) // w - lo // w + 1
            ring = torch.arange(lo, hi, device=sf.device) // w - r0
            seg = rank + (e + 1) * (ring[None] + nr * torch.arange(
                c, device=sf.device)[:, None])
            counts = torch.bincount(seg.reshape(-1),
                                    minlength=c * nr * (e + 1))
            parts += [((ens.mean(dim=0) - obs) ** 2 * wts).sum(dim=-1),
                      (torch.var(ens, dim=0, correction=1) * wts).sum(dim=-1),
                      metrics.ring_contract(counts.reshape(c, nr, e + 1),
                                            aw[r0:r0 + nr]).reshape(-1)]
        if self.cfg.spectra:
            spec = metrics.angular_psd(sf, self.spectral_wpct).sum(dim=0)
            parts.append(spec.reshape(-1))
        sums = compat.psum(torch.cat(parts), g) if parts else None
        if truth is not None:
            sq, var, rh = sums[:c], sums[c:2 * c], sums[2 * c:c * (e + 3)]
            out["ens_rmse"] = torch.sqrt(sq / den)
            out["spread"] = torch.sqrt(var / den)
            out["ssr"] = ((e + 1.0) / e) ** 0.5 * out["spread"] \
                / out["ens_rmse"]
            out["rank_hist"] = rh.reshape(c, e + 1)
        if self.cfg.spectra:
            out["spectrum"] = sums[-spec.numel():].reshape(spec.shape) / e
            if truth is not None:
                out["spectrum_truth"] = metrics.angular_psd(
                    truth, self.spectral_wpct)
        return out

    def step(self, params: dict | None, buffers: dict, s: torch.Tensor,
             z_hat: torch.Tensor, aux: torch.Tensor, eta: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One lead of (B, E, ...) carries with (B, n_aux, H, W) aux: the
        conditioned model step (its output rounded to the compute dtype),
        then the noise transition."""
        z = self.noise_fields(z_hat)
        cond = torch.cat([aux[:, None].expand(z.shape[:2] + aux.shape[1:]),
                          z], dim=2).to(self.cfg.tdtype)
        s = self._apply(params, buffers, s, cond).to(self.cfg.tdtype)
        return s, self.model.noise.step_with(z_hat, eta)

    # ------------------------------------------------------------------
    def _chunk_bounds(self, steps: int) -> list[tuple[int, int]]:
        """(start, k) of each chunk of a ``steps``-long rollout."""
        if steps < 1:
            raise ValueError(f"need at least one lead step, got {steps}")
        return [(start, min(self.cfg.lead_chunk, steps - start))
                for start in range(0, steps, self.cfg.lead_chunk)]

    def chunk_lengths(self, steps: int) -> list[int]:
        """Distinct chunk lengths of a ``steps``-long rollout: the full
        ``lead_chunk`` and the shorter final chunk when uneven."""
        return list(dict.fromkeys(k for _, k in self._chunk_bounds(steps)))

    def _stage(self, src, start: int, k: int, after=None) -> torch.Tensor:
        """(k, ...) fp32 of one source on the model's device.  Values made
        on the device stay there; host values go through pinned memory
        and a non-blocking copy (the caller orders it on the streams).

        ``after`` (an event on the compute stream, or None) is waited on
        before a device array or a callable is read: either may hold
        device data that the compute stream is still writing."""
        dev = self._device
        if after is not None and (callable(src) or (
                isinstance(src, torch.Tensor) and src.device == dev)):
            torch.cuda.current_stream(dev).wait_event(after)
        if callable(src):
            vals = [torch.as_tensor(src(n)) for n in range(start, start + k)]
        else:
            vals = list(torch.as_tensor(src[start:start + k]))
        if vals[0].device == dev:
            if dev.type == "cuda":
                # read on this stream: the caller may free the source
                # before it is done
                for v in vals:
                    v.record_stream(torch.cuda.current_stream(dev))
            return torch.stack(vals).float()
        host = torch.empty((k,) + tuple(vals[0].shape), dtype=torch.float32,
                           pin_memory=dev.type == "cuda")
        for i, v in enumerate(vals):
            host[i].copy_(v)
        return host.to(dev, non_blocking=True)

    def _mark(self):
        """An event on the current (compute) stream, recorded when a chunk
        is scheduled: the staging of device data waits on it.  None on the
        CPU."""
        dev = self.model.device
        if dev.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return event

    def _on_copy_stream(self, fn: Callable[[], dict]) -> dict:
        """``fn()`` run on the engine's copy stream, with an event the
        compute stream waits on before it reads the result (``_ready``);
        on the CPU just ``fn()``."""
        dev = self.model.device
        if dev.type != "cuda":
            return fn()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            xs = fn()
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return {**xs, "_event": event}

    def _ready(self, xs: dict) -> dict:
        """Staged inputs safe to read on the current stream."""
        event = xs.get("_event")
        out = {k: v for k, v in xs.items() if k != "_event"}
        if event is not None:
            cur = torch.cuda.current_stream(self.model.device)
            cur.wait_event(event)
            for v in out.values():
                v.record_stream(cur)
        return out

    # ------------------------------------------------------------------
    def stream(self, buffers: dict, state0, aux, noise: NoiseSource,
               steps: int | None = None, truth=None, on_span=None
               ) -> Iterator[ForecastResult]:
        """Roll one forecast, yielding one ForecastResult per lead chunk.

        ``on_span`` (optional) is an observability hook ``fn(name, t0, t1,
        args)`` called around each chunk's staging with ``perf_counter``
        bounds; it never touches the staged values.
        """
        for block in self.stream_batched(
                buffers, [state0], [aux], [noise], steps=steps,
                truths=None if truth is None else [truth], on_span=on_span):
            yield block[0]

    def forecast(self, buffers: dict, state0, aux, noise: NoiseSource,
                 steps: int | None = None, truth=None) -> ForecastResult:
        """Run the whole rollout and concatenate the per-chunk results."""
        return _concat_results(list(self.stream(
            buffers, state0, aux, noise, steps=steps, truth=truth)))

    def stream_batched(self, buffers: dict, state0s, auxs,
                       noises: list[NoiseSource], steps: int | None = None,
                       truths=None,
                       survivors: Callable[[], list[int]] | None = None,
                       on_span=None) -> Iterator[list[ForecastResult]]:
        """Roll B same-shape requests through one step over a leading
        request axis, yielding one request-ordered ``list[ForecastResult]``
        per chunk.

        state0s / auxs / noises (and truths when scoring): one entry per
        request, each as ``stream`` takes it; sources shared between
        requests (the same object) are staged once.  Member init, noise
        draws, centering and scores stay per request.

        ``survivors`` (optional) is polled at every chunk boundary and
        returns the original indices of the requests still wanted; on a
        strict non-empty subset the rollout shrinks onto them (their
        carries sliced out; ``dispatch_stats()["shrinks"]`` ticks) and
        the yielded lists keep length B with ``None`` in dropped slots.
        """
        b = len(state0s)
        if b < 1:
            raise ValueError("need at least one request to batch")
        if len(auxs) != b or len(noises) != b or (
                truths is not None and len(truths) != b):
            raise ValueError(
                f"state0s/auxs/noises{'/truths' if truths is not None else ''}"
                f" must all have one entry per request (got {b} states, "
                f"{len(auxs)} aux, {len(noises)} noise sources)")
        if steps is None:
            if any(callable(a) for a in auxs):
                raise ValueError("steps= is required when aux is a callable")
            steps = len(auxs[0])
        bounds = self._chunk_bounds(steps)
        params, pbufs = self._prepare_inputs(buffers)
        scored = truths is not None
        dev = self.model.device

        def stage(start: int, k: int, after) -> dict:
            t0 = time.perf_counter() if on_span is not None else 0.0
            staged: dict[int, torch.Tensor] = {}

            def once(src):
                if id(src) not in staged:
                    staged[id(src)] = self._stage(src, start, k, after)
                return staged[id(src)]

            xs = {"aux": torch.stack([once(a) for a in auxs])}
            if scored:
                xs["truth"] = torch.stack([once(t) for t in truths])
            self._count("h2d_chunks")
            self._count("h2d_steps", k * len({id(a) for a in auxs}))
            if on_span is not None:
                on_span("stage_h2d", t0, time.perf_counter(),
                        {"start": start, "steps": k, "batch": b})
            return xs

        stager = _ChunkStager(
            bounds, lambda start, k, after: self._on_copy_stream(
                lambda: stage(start, k, after)), self._mark)
        try:
            aux0s = [None] * b
            if self.cfg.perturb.kind == "bred":
                # the breeding rollouts run under the first lead's aux,
                # taken from the staged first chunk (no second copy)
                aux0 = self._ready(stager.peek(0))["aux"][:, 0]
                aux0s = list(aux0)
            with torch.inference_mode():
                carries = [self.init_carry(s0, nz, buffers, a0)
                           for s0, nz, a0 in zip(state0s, noises, aux0s)]
                s = torch.stack([c[0] for c in carries])
                z_hat = torch.stack([c[1] for c in carries])
            del carries
            active = list(range(b))    # original indices still rolled
            members = self.block[1] - self.block[0]
            for i, (start, k) in enumerate(bounds):
                # inference mode and the chunk's span per chunk, never
                # held across a yield (the caller's code would run inside
                # them)
                with telemetry.span("engine.chunk", start=start, steps=k,
                                    batch=len(active)):
                    with torch.inference_mode():
                        if survivors is not None:
                            want = set(survivors())
                            alive = [j for j in active if j in want]
                            if alive and len(alive) < len(active):
                                pos = torch.tensor([active.index(j)
                                                    for j in alive],
                                                   device=dev)
                                s, z_hat = s[pos], z_hat[pos]
                                active = alive
                                self._count("shrinks")
                        with telemetry.span("engine.stage_wait"):
                            xs = self._ready(stager.get(i))
                        if len(active) < b:
                            idx = torch.tensor(active, device=dev)
                            xs = {kk: v[idx] for kk, v in xs.items()}
                        per_lead: list[list[dict]] = []
                        for j in range(k):
                            with telemetry.span(
                                    "engine.lead",
                                    member_leads=len(active) * members):
                                eta = torch.stack([
                                    noises[r].eta(self.model, start + j,
                                                  z_hat[p],
                                                  self.noise_buffers)
                                    for p, r in enumerate(active)])
                                s, z_hat = self.step(params, pbufs, s, z_hat,
                                                     xs["aux"][:, j], eta)
                                sf = s.float()
                                per_lead.append([self._lead_out(
                                    sf[p],
                                    xs["truth"][p, j] if scored else None)
                                    for p in range(len(active))])
                        self._count("chunks")
                    last = i + 1 == len(bounds)
                    block: list[ForecastResult | None] = [None] * b
                    for p, r in enumerate(active):
                        outs = [lead[p] for lead in per_lead]
                        block[r] = ForecastResult(
                            lead_steps=np.arange(start, start + k),
                            scores={n: torch.stack([o[n] for o in outs])
                                    for n in SCORE_NAMES if n in outs[0]},
                            diagnostics=(_tree_map(torch.stack,
                                                   [o["diag"] for o in outs])
                                         if self.diagnostics is not None
                                         else None),
                            final_state=s[p] if last else None,
                            final_noise=z_hat[p] if last else None)
                yield block
        finally:
            stager.close()

    def _lead_out(self, sf: torch.Tensor, truth: torch.Tensor | None
                  ) -> dict:
        """One request's per-lead outputs: its scores and diagnostics."""
        with telemetry.span("engine.scores"):
            out = self.scores(sf, truth)
        if self.diagnostics is not None:
            out["diag"] = self.diagnostics(sf)
        return out

    def forecast_batched(self, buffers: dict, state0s, auxs,
                         noises: list[NoiseSource], steps: int | None = None,
                         truths=None) -> list[ForecastResult]:
        """Run the whole coalesced rollout; one concatenated
        ``ForecastResult`` per request, in request order."""
        per_request: list[list[ForecastResult]] = [[] for _ in state0s]
        for block in self.stream_batched(buffers, state0s, auxs, noises,
                                         steps=steps, truths=truths):
            for parts, res in zip(per_request, block):
                parts.append(res)
        return [_concat_results(parts) for parts in per_request]


def kernel_libraries(model: FCN3) -> tuple[tuple[str, tuple], ...]:
    """The kernel libraries a forecast step of ``model`` launches on its
    device, as ``kernels.build`` ``(name, defines)`` pairs: the Legendre
    kernel on the SHT path "kernel", the band contraction on the DISCO
    path "kernel", each at its ``KernelConfig.blocks`` tile; none on the
    CPU, where the wrappers run their plain versions."""
    if model.device.type != "cuda":
        return ()
    kc = model.cfg.kernels
    return tuple(library_of(op, kc.blocks_for(op))
                 for op, on in (("legendre", kc.sht == "kernel"),
                                ("disco", kc.disco == "kernel")) if on)


def members_noise(model: FCN3, seed: int) -> GeneratorNoise:
    """The default noise source: a generator on the model's device."""
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    return GeneratorNoise(g)
