"""Per-card tile autotuner for the port's CUDA kernels: the counterpart of
the JAX package's ``repro.kernels.autotune``.

Each tunable kernel family (``config.BLOCK_OPS``) compiles its tile from
``#define TUNE_<NAME>`` constants (``csrc/*.cu``), whose defaults are the
tiles tuned by hand on the H100 (``config.BLOCK_DEFAULTS``).  The right
tile depends on the card and the shape, so this module measures it:

* **Candidate lattice** -- per family, the cross product of a few values
  of each constant (``_LATTICE``), filtered by ``feasible``, which
  mirrors the sources' ``static_assert``s (shared memory of a block,
  registers at the blocks an SM the source asks for, the mma's tile
  sizes, whole warps) so that every candidate builds.  The committed
  tile is always candidate 0 and the rest come in a fixed order
  (``candidates``): the fewest constants changed first, then the
  smallest change, then the dims themselves.
* **Sweep** -- ``sweep_op`` builds every candidate's library (one
  ``nvcc`` each, in parallel), times each on the card (CUDA events after
  a warm-up, the median of ``iters`` calls) on operands of the family's
  shapes (``OpRunner``), and picks the fastest; ties go to the committed
  tile, then to the lexicographically smallest dims, so ``best_us <=
  default_us`` by construction.  The timer and the runner are
  injectable (the CPU tests); without an injected timer a sweep needs a
  card and raises without one.  No plain version is ever timed.
* **Tuning cache** -- winners persist as one canonical JSON file per
  (op, shapes, dtype) in a ``TuningCache`` directory, content-addressed
  by sha1 over (lattice version, op, shapes, dtype, the card's name, the
  torch and CUDA versions, the committed library's file name, which
  hashes the family's source and headers): a new card, toolchain or
  kernel source tunes again instead of serving a stale winner.  Corrupt,
  stale or invalid entries read as absent.
* **Serving resolution** -- ``install_tuning_cache`` makes a cache
  process-active; ``resolve_kernel_config`` (called by
  ``serving.spec.RequestSpec.engine_config``) attaches each family's
  best tile as ``KernelConfig.blocks``, upstream of every engine key, so
  a tuned engine is its own cache entry and launches its own libraries
  (``ForecastEngine.kernel_libraries``).  ``serving.bundle`` packs the
  entries and their libraries, so a replica booted from a bundle serves
  the tuned kernels with no sweep and no ``nvcc``.

``model_op_shapes`` picks, per family, the shape on which FCN3's paths
spend the most kernel time; ``lm_op_shapes`` the SSD shape of an LM
prefill.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import statistics

from repro_torch.kernels.config import (BLOCK_DEFAULTS, BLOCK_OPS,
                                        BLOCK_SOURCES, BlockConfig,
                                        KernelConfig, library_of)

#: bump when the lattice or the entry schema changes incompatibly; part
#: of every entry's token, so old caches read as stale, not wrong
LATTICE_VERSION = "1"

#: the shape fields of each family, in order (``sweep_op``'s ``shapes``
#: and every entry's ``shapes``): the JAX package's four, and the
#: transpose's, which are the band contraction's
OP_SHAPE_FIELDS = {
    "legendre": ("b", "k", "n", "m"),
    "disco": ("b", "h", "s", "w_in", "k", "d", "stride"),
    "disco_bwd": ("b", "h", "s", "w_in", "k", "d", "stride"),
    "crps": ("e", "n"),
    "ssd": ("bc", "l", "h", "p", "g", "n"),
}

#: candidate values of each constant (cross product, then ``feasible``)
_LATTICE = {
    "legendre": {"TB": (16, 32, 64), "TN": (32, 64, 128),
                 "TK": (8, 16, 32), "STAGES": (2, 3, 4)},
    "disco": {"TBP": (8, 16), "CH": (64, 128, 256), "STAGES": (2, 3, 4),
              "MIN_BLOCKS": (1, 2, 3)},
    "disco_bwd": {"CH": (32, 48, 64), "STAGES": (2, 3, 4),
                  "MIN_BLOCKS": (2, 3, 4)},
    "crps": {"THREADS": (128, 256, 512, 1024)},
    "ssd": {"HEADS_PER_BLOCK": (6, 8, 12, 24), "THREADS": (512, 768)},
}

#: dynamic shared memory one block may take on the H100 (227 KB) and the
#: registers of an SM
SMEM_LIMIT = 232448
REGS_PER_SM = 65536


def _shape_dict(op: str, shapes) -> dict:
    if op not in OP_SHAPE_FIELDS:
        raise ValueError(f"unknown op {op!r}; expected {BLOCK_OPS}")
    fields = OP_SHAPE_FIELDS[op]
    shapes = tuple(int(s) for s in shapes)
    if len(shapes) != len(fields):
        raise ValueError(f"op {op!r} expects shapes {fields}, got {shapes}")
    return dict(zip(fields, shapes))


# ---------------------------------------------------------------------------
# Feasibility: the sources' static_asserts, in Python
# ---------------------------------------------------------------------------

def _legendre_ok(d: dict) -> bool:
    tb, tn, tk, stages = d["TB"], d["TN"], d["TK"], d["STAGES"]
    if not (tb >= 16 and tb % 16 == 0 and tn >= 32 and tn % 32 == 0
            and tk >= 8 and tk % 8 == 0 and stages >= 2):
        return False
    threads = 64 * (tb // 16) * (tn // 32)
    px = tk * tb * 2 // threads
    stage = tk * tb * 8 + tk * tn * 8          # the real path's, the larger
    return (threads <= 1024 and 4 * stages * stage <= SMEM_LIMIT
            and (threads // 2) % tb == 0 and (tk * tb * 2) % threads == 0
            and (threads // 2) % tn == 0 and (tk * tn) % threads == 0
            and px >= 1 and threads % tn == 0 and tk * tn >= threads)


def disco_smem_bytes(dims: dict, stride: int) -> int:
    """``disco_band_smem_bytes`` of ``csrc/disco_band.cu`` at ``dims``."""
    window = -(-(127 * stride + dims["CH"] + 3) // 4) * 4    # TW = 128
    return 4 * dims["STAGES"] * (dims["CH"] * 8 + dims["TBP"] * window)


def _deltas(taps: int, s: int) -> int:
    return (taps + 9 * s - 2) // (8 * s)


def disco_bwd_smem_bytes(dims: dict, stride: int) -> int:
    """``disco_band_bwd_smem_bytes`` of ``csrc/disco_band_bwd.cu``."""
    ch = dims["CH"]
    if stride <= 2:
        window = ((256 // stride + 8 * _deltas(ch, stride) + 6) // 4 | 1) * 4
    else:
        window = ((256 + 8 * 3 + 6) // 4 | 1) * 4             # DM_ANY = 3
    return 4 * dims["STAGES"] * (ch + 32 * stride + 16 * window)


def _disco_ok(d: dict, stride: int) -> bool:
    tbp, ch, mb = d["TBP"], d["CH"], d["MIN_BLOCKS"]
    return (256 % tbp == 0 and tbp % 2 == 0 and ch >= 8 and ch % 8 == 0
            and d["STAGES"] >= 2 and mb >= 1
            and REGS_PER_SM // (256 * mb) >= 4 * tbp + 48
            and disco_smem_bytes(d, 2) <= SMEM_LIMIT
            and disco_smem_bytes(d, stride) <= SMEM_LIMIT)


def _disco_bwd_ok(d: dict, stride: int) -> bool:
    ch, mb = d["CH"], d["MIN_BLOCKS"]
    return (ch >= 8 and ch % 8 == 0 and d["STAGES"] >= 2 and mb >= 1
            and REGS_PER_SM // (256 * mb) >= 64
            and _deltas(ch, 3) <= 3 and _deltas(ch, 4) <= 3
            and disco_bwd_smem_bytes(d, 1) <= SMEM_LIMIT
            and disco_bwd_smem_bytes(d, 2) <= SMEM_LIMIT
            and disco_bwd_smem_bytes(d, stride) <= SMEM_LIMIT)


def _ssd_ok(d: dict) -> bool:
    threads = d["THREADS"]
    s_warps = threads // 32 - 8
    return (threads % 32 == 0 and threads <= 1024 and threads // 32 >= 16
            and s_warps % 2 == 0 and 128 % (s_warps // 2) == 0
            and (128 // (s_warps // 2)) % 8 == 0
            and d["HEADS_PER_BLOCK"] >= 1)


def feasible(op: str, dims: dict, shapes) -> bool:
    """Whether ``dims`` (a full tile of ``op``) builds and launches at
    ``shapes``: the source's ``static_assert``s, and for the band kernels
    the shared memory at the shape's stride."""
    s = _shape_dict(op, shapes)
    if sorted(dims) != sorted(BLOCK_DEFAULTS[op]):
        return False
    if op == "legendre":
        return _legendre_ok(dims)
    if op == "disco":
        return _disco_ok(dims, s["stride"])
    if op == "disco_bwd":
        return _disco_bwd_ok(dims, s["stride"])
    if op == "crps":
        t = dims["THREADS"]
        return 32 <= t <= 1024 and t % 32 == 0
    return _ssd_ok(dims)


def _distance(op: str, dims: dict) -> tuple:
    default = BLOCK_DEFAULTS[op]
    changed = [n for n in dims if dims[n] != default[n]]
    return (len(changed),
            round(sum(abs(math.log2(dims[n] / default[n])) for n in changed),
                  9),
            tuple(sorted(dims.items())))


def candidates(op: str, shapes, max_candidates: int | None = 8
               ) -> list[dict]:
    """Feasible tiles of ``op`` at ``shapes``, the committed one first.

    Deterministic: the cross product of ``_LATTICE[op]`` filtered by
    ``feasible``, sorted by the number of constants changed, then the
    size of the change (the sum of |log2| of each ratio to the default),
    then the dims; ``max_candidates`` (None: no cap) counts the default.
    """
    if op not in BLOCK_OPS:
        raise ValueError(f"unknown op {op!r}; expected {BLOCK_OPS}")
    default = dict(BLOCK_DEFAULTS[op])
    names = sorted(_LATTICE[op])
    pool = []
    for values in itertools.product(*(_LATTICE[op][n] for n in names)):
        dims = dict(zip(names, values))
        if dims != default and feasible(op, dims, shapes):
            pool.append(dims)
    pool.sort(key=lambda d: _distance(op, d))
    if max_candidates is not None:
        pool = pool[:max(max_candidates - 1, 0)]
    return [default] + pool


def blocks_of(op: str, dims: dict) -> BlockConfig | None:
    """None for the committed tile, else its ``BlockConfig`` holding the
    dims that differ from it (one tile, one config)."""
    default = BLOCK_DEFAULTS[op]
    changed = {n: v for n, v in dims.items() if v != default[n]}
    return BlockConfig.make(op, **changed) if changed else None


def library_for(op: str, dims: dict) -> tuple[str, tuple]:
    """``(source, defines)`` of the library of ``op`` at ``dims``."""
    return library_of(op, blocks_of(op, dims))


# ---------------------------------------------------------------------------
# Operands and the call of each family
# ---------------------------------------------------------------------------

def _fcn3_table(shapes: dict):
    """The forward SHT table (H, L, M) of a named FCN3 configuration with
    these dims, fp32 (its zeros -- the orders above each degree, and
    the near-pole rows of the high orders, which underflow -- set the
    Legendre kernel's work, so it is tuned on a model's own table)."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    want = (shapes["k"], shapes["n"], shapes["m"])
    for make in fcn3cfg.NAMED_CONFIGS.values():
        geo = fcn3.geometry(make())
        for sht in (geo["in_sht"], geo["latent_sht"]):
            if (sht.grid.nlat, sht.lmax, sht.mmax) == want:
                return sht.tables()[0].astype("float32")
    raise ValueError(f"no FCN3 configuration has an SHT table of shape "
                     f"{want}; the Legendre kernel tunes on a model's table")


def _fcn3_band(shapes: dict):
    """The DISCO plan of a named FCN3 configuration whose band has these
    dims (the band's live taps set the kernels' work, so the band
    kernels are tuned on a model's own band, not on a random one)."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    from repro_torch.core.sphere import disco as discolib
    want = (shapes["k"], shapes["h"], shapes["s"], shapes["d"])
    for make in fcn3cfg.NAMED_CONFIGS.values():
        geo = fcn3.geometry(make())
        for name in ("enc", "latent", "dec"):
            gi, go = geo[name][:2]
            if (go.nlat != shapes["h"] or gi.nlon != shapes["w_in"]
                    or gi.nlon // go.nlon != shapes["stride"]):
                continue
            plan = discolib.make_disco_plan(*geo[name])
            if tuple(plan.banded_split()[0].shape) == want:
                return plan
    raise ValueError(f"no FCN3 configuration has a DISCO band of shape "
                     f"{shapes}; the band kernels tune on a model's band")


class OpRunner:
    """Operands of one family at ``shapes`` on ``device`` (made at the
    first call, from a fixed seed) and the call of its wrapper.

    ``runner(blocks)`` is a zero-argument callable launching the kernel
    at the tile ``blocks`` (None: the committed one) and returning its
    output; ``plain()`` the plain version's output on the same operands
    (for checks on the card: it is never timed).  crps runs its forward
    and its backward kernel (one source, one tile); the band families
    read a named FCN3 configuration's band (``_fcn3_band``) and legendre
    contracts complex64 rows (the SHT's) with its forward table
    (``_fcn3_table``).
    """

    def __init__(self, op: str, shapes, device="cuda"):
        self.op = op
        self.shapes = _shape_dict(op, shapes)
        self.device = device
        self._ops: dict | None = None

    def operands(self) -> dict:
        """The operands, made at the first call."""
        if self._ops is None:
            self._ops = self._make()
        return self._ops

    def _make(self) -> dict:
        import torch
        s, dev = self.shapes, torch.device(self.device)
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        if self.op == "legendre":
            from repro_torch.core.sphere.sht import order_extents
            table = _fcn3_table(s)
            x = (s["b"], s["k"], s["m"])
            return {"x": torch.complex(randn(*x), randn(*x)),
                    "table": torch.from_numpy(table).to(dev),
                    "extents": torch.from_numpy(order_extents(table)).to(
                        dev)}
        if self.op in ("disco", "disco_bwd"):
            from repro_torch.kernels.disco.ops import LiveTaps, RowTaps
            plan = _fcn3_band(s)
            bufs = plan.banded_buffers(dev)
            out = {"psi_band": bufs["psi_band"], "lat_idx": bufs["lat_idx"],
                   "taps": LiveTaps.of(bufs), "stride": s["stride"],
                   "h_in": plan.grid_in.nlat}
            if self.op == "disco":
                out["x"] = randn(s["b"], plan.grid_in.nlat, s["w_in"])
            else:
                out["rows"] = RowTaps.of(bufs)
                out["g"] = randn(s["b"], s["k"], s["h"],
                                 s["w_in"] // s["stride"])
            return out
        if self.op == "crps":
            return {"ens": randn(s["e"], s["n"]), "obs": randn(s["n"]),
                    "g": randn(s["n"])}
        bc, ll, h, p, g, n = (s[f] for f in OP_SHAPE_FIELDS["ssd"])
        da = -torch.rand((bc, ll, h), generator=gen, device=dev) * 0.2
        return {"x": randn(bc, ll, h, p), "da_cs": torch.cumsum(da, dim=1),
                "b": randn(bc, ll, g, n), "c": randn(bc, ll, g, n)}

    def __call__(self, blocks: BlockConfig | None):
        """A zero-argument call of the kernel at ``blocks``."""
        op = self.op

        def run():
            o = self.operands()
            if op == "legendre":
                from repro_torch.kernels.legendre import ops
                return ops.legendre_contract(o["x"], o["table"],
                                             o["extents"], blocks)
            if op == "disco":
                from repro_torch.kernels.disco import ops
                return ops.disco_band_contract(o["x"], o["psi_band"],
                                               o["lat_idx"], o["taps"],
                                               o["stride"], blocks)
            if op == "disco_bwd":
                from repro_torch.kernels.disco import ops
                return ops.disco_band_transpose(
                    o["g"], o["psi_band"], o["lat_idx"], o["taps"],
                    o["rows"], o["h_in"], o["stride"], blocks)
            if op == "crps":
                from repro_torch.kernels.crps import ops
                return (ops.crps_fused(o["ens"], o["obs"], True, blocks),
                        ops.crps_fused_bwd(o["g"], o["ens"], o["obs"], True,
                                           blocks))
            from repro_torch.kernels.ssd import ops
            return ops.ssd_intra_chunk(o["x"], o["da_cs"], o["b"], o["c"],
                                       blocks)
        return run

    def plain(self):
        """The plain version's output on the same operands."""
        o, op = self.operands(), self.op
        if op == "legendre":
            from repro_torch.kernels.legendre.ref import legendre_contract_ref
            return legendre_contract_ref(o["x"], o["table"])
        if op == "disco":
            from repro_torch.kernels.disco.ref import \
                disco_gather_band_contract_ref
            return disco_gather_band_contract_ref(o["x"], o["psi_band"],
                                                  o["lat_idx"], o["stride"])
        if op == "disco_bwd":
            from repro_torch.kernels.disco.ref import disco_band_transpose_ref
            return disco_band_transpose_ref(o["g"], o["psi_band"],
                                            o["lat_idx"], o["h_in"],
                                            o["stride"])
        if op == "crps":
            from repro_torch.kernels.crps.ref import (crps_fused_bwd_ref,
                                                      crps_fused_ref)
            return (crps_fused_ref(o["ens"], o["obs"], True),
                    crps_fused_bwd_ref(o["g"], o["ens"], o["obs"], True))
        from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
        return ssd_intra_chunk_ref(o["x"], o["da_cs"], o["b"], o["c"])


def cuda_timer(warmup: int = 1, iters: int = 5):
    """The default ``sweep_op`` timer: the median device seconds of
    ``iters`` calls after ``warmup`` (CUDA events on the current stream;
    the first call of a library also loads it)."""
    import torch

    def timer(dims: dict, fn) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        return statistics.median(times)

    return timer


# ---------------------------------------------------------------------------
# The environment an entry is scoped by
# ---------------------------------------------------------------------------

def device_name() -> str:
    """The card's name (``torch.cuda.get_device_name(0)``), or "cpu"."""
    import torch
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


def environment() -> dict:
    """``gpu``, ``torch`` and ``cuda`` of this process."""
    import torch
    return {"gpu": device_name(), "torch": torch.__version__,
            "cuda": torch.version.cuda or "none"}


def source_of(op: str) -> str:
    """The committed library's file name of ``op``'s family: it hashes
    the family's source and the shared headers."""
    from repro_torch.kernels import build
    return build.library_file(BLOCK_SOURCES[op])


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def sweep_op(op: str, shapes, *, dtype: str = "float32", timer=None,
             runner=None, max_candidates: int | None = 8,
             cache: "TuningCache | None" = None, force: bool = False,
             warmup: int = 1, iters: int = 5, device="cuda") -> dict:
    """Tune ``op`` at ``shapes``: time the candidate tiles, pick the
    winner, persist it in ``cache``.

    Returns the entry (what ``TuningCache`` stores) with ``swept``::

        {op, shapes, dtype, gpu, torch, cuda, lattice, source, dims,
         library, default_us, best_us, candidates: [{dims, us}], swept}

    ``swept`` is False when ``cache`` already held a valid entry (nothing
    was built or timed).  ``timer(dims, fn) -> seconds`` and
    ``runner(blocks) -> fn`` are injectable; by default the candidates'
    libraries are built in parallel and timed with ``cuda_timer`` on an
    ``OpRunner``'s operands, which needs a card.  The winner is the
    fastest candidate; ties prefer the committed tile, then the
    lexicographically smallest dims.
    """
    from repro_torch.kernels import build
    if cache is not None and not force:
        hit = cache.get(op, shapes, dtype)
        if hit is not None:
            return {**hit, "swept": False}
    if dtype != "float32":
        raise ValueError(f"the kernels take float32 operands, not {dtype}")
    cands = candidates(op, shapes, max_candidates=max_candidates)
    if timer is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"sweeping {op} needs a CUDA card (or an "
                               "injected timer): nothing else is timed")
        build.build_all([library_for(op, d) for d in cands])
        timer = cuda_timer(warmup=warmup, iters=iters)
    if runner is None:
        runner = OpRunner(op, shapes, device)
    default = dict(BLOCK_DEFAULTS[op])
    table = []
    for dims in cands:
        seconds = float(timer(dims, runner(blocks_of(op, dims))))
        table.append({"dims": dims, "us": round(seconds * 1e6, 3)})
    winner = min(table, key=lambda r: (r["us"], r["dims"] != default,
                                       tuple(sorted(r["dims"].items()))))
    entry = {
        "op": op, "shapes": [int(v) for v in shapes], "dtype": dtype,
        **environment(), "lattice": LATTICE_VERSION,
        "source": source_of(op), "dims": winner["dims"],
        "library": build.library_file(*library_for(op, winner["dims"])),
        "default_us": table[0]["us"], "best_us": winner["us"],
        "candidates": table,
    }
    if cache is not None:
        cache.put(entry)
    return {**entry, "swept": True}


# ---------------------------------------------------------------------------
# Persistent tuning cache
# ---------------------------------------------------------------------------

_ENTRY_KEYS = ("op", "shapes", "dtype", "gpu", "torch", "cuda", "lattice",
               "source", "dims", "library", "default_us", "best_us",
               "candidates")


class TuningCache:
    """Content-addressed winners on disk: one JSON file per (op, shapes,
    dtype), scoped through the file name's token by the card, the torch
    and CUDA versions, the lattice version and the family's committed
    library (its source and headers).

    Reads are forgiving: a corrupt, truncated, stale or invalid entry
    (unknown or infeasible dims, a library name that does not match its
    dims) reads as absent, so a serving process falls back to the
    committed tiles.  Writes are atomic (a temporary file renamed) and
    canonical, so identical sweeps write identical bytes.
    """

    def __init__(self, root: str | os.PathLike):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._memo: list[tuple[str, dict]] | None = None

    @staticmethod
    def entry_token(op: str, shapes, dtype: str, env: dict,
                    source: str) -> str:
        """sha1 over (lattice, op, shapes, dtype, card, torch, CUDA,
        source), 16 hex digits."""
        shape_s = ",".join(str(int(v)) for v in shapes)
        tag = (f"v{LATTICE_VERSION}|{op}|{shape_s}|{dtype}|gpu={env['gpu']}"
               f"|torch={env['torch']}|cuda={env['cuda']}|src={source}")
        return hashlib.sha1(tag.encode("utf-8")).hexdigest()[:16]

    def entry_path(self, op: str, shapes, dtype: str = "float32") -> str:
        """Where this process's entry for (op, shapes, dtype) lives."""
        token = self.entry_token(op, shapes, dtype, environment(),
                                 source_of(op))
        return os.path.join(self.root, f"tune_{token}.json")

    def _load(self, path: str) -> dict | None:
        """One entry, or None for anything unusable."""
        from repro_torch.kernels import build
        try:
            with open(path) as f:
                entry = json.load(f)
            if not isinstance(entry, dict) or any(k not in entry
                                                  for k in _ENTRY_KEYS):
                return None
            op = entry["op"]
            if op not in BLOCK_OPS:
                return None
            env = environment()
            if (any(entry[k] != env[k] for k in env)
                    or entry["lattice"] != LATTICE_VERSION
                    or entry["source"] != source_of(op)):
                return None
            dims = {**BLOCK_DEFAULTS[op], **entry["dims"]}
            BlockConfig.make(op, **entry["dims"])   # validates the names
            if (not feasible(op, dims, entry["shapes"])
                    or entry["library"] != build.library_file(
                        *library_for(op, dims))):
                return None
            return entry
        except (OSError, ValueError, TypeError, KeyError):
            return None

    def get(self, op: str, shapes, dtype: str = "float32") -> dict | None:
        """The usable entry for (op, shapes, dtype), or None."""
        path = self.entry_path(op, shapes, dtype)
        return self._load(path) if os.path.exists(path) else None

    def put(self, entry: dict) -> str:
        """Persist one entry (atomic, canonical bytes); returns its path."""
        entry = {k: entry[k] for k in _ENTRY_KEYS}
        token = self.entry_token(entry["op"], entry["shapes"],
                                 entry["dtype"], entry, entry["source"])
        path = os.path.join(self.root, f"tune_{token}.json")
        blob = json.dumps(entry, sort_keys=True, indent=1)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(blob)
        os.replace(tmp, path)
        self._memo = None
        return path

    def entries(self) -> list[tuple[str, dict]]:
        """Every usable (file name, entry) pair, sorted by file name;
        scanned once per instance (``put`` rescans)."""
        if self._memo is None:
            try:
                names = sorted(os.listdir(self.root))
            except OSError:
                names = []
            out = []
            for name in names:
                if name.startswith("tune_") and name.endswith(".json"):
                    entry = self._load(os.path.join(self.root, name))
                    if entry is not None:
                        out.append((name, entry))
            self._memo = out
        return list(self._memo)

    def best_for(self, op: str) -> BlockConfig | None:
        """The tile that serves ``op``: the winner of the entry tuned at
        the largest slab (the product of its shapes), None when there is
        none or when that winner is the committed tile."""
        best, rank = None, None
        for name, entry in self.entries():
            if entry["op"] == op:
                r = (math.prod(entry["shapes"]), name)
                if rank is None or r > rank:
                    best, rank = entry, r
        return None if best is None else blocks_of(op, best["dims"])

    def stats(self) -> dict:
        """The directory, the usable entries and their count per op."""
        ops: dict[str, int] = {}
        for _, entry in self.entries():
            ops[entry["op"]] = ops.get(entry["op"], 0) + 1
        return {"dir": self.root, "entries": sum(ops.values()), "ops": ops}


# ---------------------------------------------------------------------------
# The process-active cache and KernelConfig resolution
# ---------------------------------------------------------------------------

_ACTIVE: TuningCache | None = None


def install_tuning_cache(cache: "TuningCache | str | os.PathLike | None"
                         ) -> TuningCache | None:
    """Make ``cache`` (a ``TuningCache`` or its directory; None
    uninstalls) the process-active tunings and return the previous one.
    Every ``RequestSpec.engine_config`` built afterwards resolves them."""
    global _ACTIVE
    previous = _ACTIVE
    if cache is not None and not isinstance(cache, TuningCache):
        cache = TuningCache(cache)
    _ACTIVE = cache
    return previous


def active_tuning_cache() -> TuningCache | None:
    """The process-active ``TuningCache``, or None."""
    return _ACTIVE


def resolve_kernel_config(kernels: KernelConfig | None
                          ) -> KernelConfig | None:
    """``kernels`` with the active cache's winners as ``blocks``.

    No active cache, no tuned family, or ``kernels`` with blocks of its
    own: returned unchanged (None stays None).  Otherwise a config with
    one ``BlockConfig`` per tuned family (None becomes ``KernelConfig()``
    with them: an installed cache reaches "auto" requests too).
    """
    if _ACTIVE is None or (kernels is not None and kernels.blocks):
        return kernels
    blocks = [bc for bc in map(_ACTIVE.best_for, BLOCK_OPS)
              if bc is not None]
    if not blocks:
        return kernels
    return dataclasses.replace(kernels or KernelConfig(),
                               blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# Shapes from a model, work per call, display
# ---------------------------------------------------------------------------

def model_op_shapes(model, members: int = 2) -> dict:
    """The shape of each FCN3 family on which ``model`` (an ``FCN3``)
    spends the most kernel time, with ``members`` members.

    legendre: the latent forward SHT of a global block, members x its
    input channels (latent and conditioning); disco: the latent band at
    ``apply_disco_conv``'s widest chunk of planes (the forecast launches
    it at 8 blocks x 3 chunks a lead, the encoder band 3 times); disco_bwd:
    the same band in training; crps: the nodal score over the whole
    state, training's.
    """
    from repro_torch.core.sphere.disco import Z_CHUNK_BYTES
    cfg = model.cfg
    sht = model.latent_sht
    c_in = cfg.c_latent + cfg.cond_embed
    shapes = {"legendre": (members * c_in, sht.grid.nlat, sht.lmax,
                           sht.mmax)}
    plan = model.latent_plan
    k, h, s, d = plan.banded_split()[0].shape
    w_in = plan.grid_in.nlon
    planes = max(1, Z_CHUNK_BYTES // (4 * k * h * (w_in // plan.stride)))
    band = (min(members * c_in, planes), h, s, w_in, k, d, plan.stride)
    shapes["disco"] = shapes["disco_bwd"] = band
    shapes["crps"] = (members, cfg.n_state * cfg.nlat * cfg.nlon)
    return shapes


def lm_op_shapes(arch, batch: int, seq_len: int) -> dict:
    """``{"ssd": shapes}`` of an LM prefill of ``arch`` (an
    ``ArchConfig`` with an SSM) at ``batch`` sequences of ``seq_len``."""
    ssm = arch.ssm
    nc = -(-seq_len // ssm.chunk)
    return {"ssd": (batch * nc, ssm.chunk, ssm.n_heads, ssm.head_dim,
                    ssm.n_groups, ssm.d_state)}


def op_flops_bytes(op: str, shapes) -> tuple[float, float]:
    """(FLOPs, float32 bytes) of one call at ``shapes``, dense (the JAX
    package's counts; the transpose does the band contraction's work)."""
    s = _shape_dict(op, shapes)
    if op == "legendre":
        flops = 2.0 * s["b"] * s["k"] * s["n"] * s["m"]
        mem = 4.0 * (s["b"] * s["k"] * s["m"] + s["k"] * s["n"] * s["m"]
                     + s["b"] * s["n"] * s["m"])
    elif op in ("disco", "disco_bwd"):
        w_out = s["w_in"] // s["stride"]
        flops = 2.0 * s["b"] * s["k"] * s["h"] * s["s"] * s["d"] * w_out
        mem = 4.0 * (s["b"] * s["h"] * s["s"] * s["w_in"]
                     + s["k"] * s["h"] * s["s"] * s["d"]
                     + s["b"] * s["k"] * s["h"] * w_out)
    elif op == "crps":
        flops = 3.0 * s["e"] * s["e"] * s["n"]
        mem = 4.0 * (s["e"] * s["n"] + 2 * s["n"])
    else:
        per = (2.0 * s["l"] * s["l"] * s["n"] + 2.0 * s["l"] * s["l"] * s["p"]
               + 2.0 * s["l"] * s["p"] * s["n"])
        flops = s["bc"] * s["h"] * per
        mem = 4.0 * s["bc"] * (2 * s["l"] * s["h"] * s["p"]
                               + s["l"] * s["h"]
                               + 2 * s["l"] * s["g"] * s["n"]
                               + s["h"] * s["p"] * s["n"])
    return flops, mem


def format_blocks(op: str, dims: dict | None = None) -> str:
    """One token for a CSV column (no commas): ``STAGES2.TB32.TK16.TN64``
    for the committed Legendre tile."""
    full = {**BLOCK_DEFAULTS[op], **(dims or {})}
    return ".".join(f"{name}{value}" for name, value in sorted(full.items()))
