"""The port's kernel-tile autotuner (``repro_torch.kernels.autotune``) and
its CLI (``repro_torch.launch.tune``), on the CPU.

* **Candidates** -- the committed tile first, a fixed order, the cap,
  and feasibility that prunes what the CUDA sources' ``static_assert``s
  refuse (the shared memory of a block, registers, whole mma tiles),
  the band kernels' at the shape's stride.
* **Sweep** -- through injected timers (no kernel runs): the fastest
  wins, ties go to the committed tile and then to the smallest dims, a
  cache hit sweeps nothing; without a card and without a timer a sweep
  raises.
* **Tuning cache** -- identical sweeps write identical bytes; corrupt
  entries, entries of another card, torch version, lattice or kernel
  source, and invalid dims read as absent; ``best_for`` serves the
  largest slab and returns None for a committed-tile winner.
* **Resolution** -- no cache is the identity; an installed one attaches
  ``blocks`` and changes ``RequestSpec.engine_key``; the install returns
  the previous cache.
* **Against the JAX package** -- ``op_flops_bytes`` of the shared
  families, ``model_op_shapes`` at ``fcn3_smoke`` (legendre's table
  dims and crps equal; the port slabs legendre over the global block's
  input channels and tunes disco at the latent band: differences by
  design, ROADMAP C).
* **The CLI** -- its CSV header and rows, ``sweeps=0`` on a second run,
  ``--device cpu`` refused.
* **Tiles change no number on the CPU** -- every family's wrapper, the
  FCN3 step and the SSD scan give exactly the untuned result under a
  tuned ``KernelConfig`` (the plain versions run there).
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.kernels import autotune as jautotune
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core.fcn3 import FCN3
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.autotune import OpRunner, TuningCache
from repro_torch.kernels.config import (BLOCK_DEFAULTS, BLOCK_OPS,
                                        BlockConfig, KernelConfig)
from repro_torch.launch import tune
from repro_torch.models import ssm as ssmlib
from repro_torch.serving.spec import RequestSpec

#: small shapes of the families (the runners of legendre and the band
#: families take fcn3_smoke's, whose table and band ``OpRunner`` finds
#: among the named configs)
SHAPES = {"legendre": (8, 16, 9, 9), "crps": (2, 300),
          "ssd": (4, 16, 4, 8, 1, 8)}
CRPS = (4, 300)


def fake_timer(us_for):
    """A sweep timer that never runs the kernel: ``us_for(dims)`` -> us."""
    def timer(dims, fn):
        return us_for(dims) * 1e-6
    return timer


def faster_than_default(dims, op="crps"):
    return 9.0 if dims == BLOCK_DEFAULTS[op] else 5.0


@pytest.fixture(autouse=True)
def no_leaked_cache():
    """Every test starts and ends with no process-active tuning cache."""
    previous = autotune.install_tuning_cache(None)
    yield
    autotune.install_tuning_cache(previous)


@pytest.fixture(scope="module")
def smoke_model():
    return FCN3(tcfgs.NAMED_CONFIGS["smoke"](), device="cpu")


@pytest.fixture(scope="module")
def smoke_shapes(smoke_model):
    return autotune.model_op_shapes(smoke_model, members=2)


class TestCandidates:
    @pytest.mark.parametrize("op", BLOCK_OPS)
    def test_default_first_and_deterministic(self, op, smoke_shapes):
        shapes = SHAPES.get(op) or smoke_shapes[op]
        cands = autotune.candidates(op, shapes, max_candidates=None)
        assert cands[0] == BLOCK_DEFAULTS[op]
        assert cands == autotune.candidates(op, shapes, max_candidates=None)
        seen = [tuple(sorted(d.items())) for d in cands]
        assert len(seen) == len(set(seen)) and len(cands) > 1
        assert all(autotune.feasible(op, d, shapes) for d in cands)
        # the fewest constants changed first
        default = BLOCK_DEFAULTS[op]
        changed = [sum(d[n] != default[n] for n in d) for d in cands]
        assert changed == sorted(changed)

    def test_max_candidates_caps(self):
        shapes = SHAPES["legendre"]
        four = autotune.candidates("legendre", shapes, max_candidates=4)
        assert len(four) == 4
        assert four == autotune.candidates("legendre", shapes,
                                           max_candidates=None)[:4]
        assert autotune.candidates("legendre", shapes, max_candidates=1) \
            == [BLOCK_DEFAULTS["legendre"]]

    @pytest.mark.parametrize("op,dims", [
        # 2 stages of 32-deep slabs of a 64 x 128 tile: 384 KB
        ("legendre", {"TB": 64, "TN": 128, "TK": 32, "STAGES": 2}),
        # rows of the tile not a multiple of the mma's 16
        ("legendre", {"TB": 24, "TN": 64, "TK": 16, "STAGES": 2}),
        # 3 blocks an SM leave 85 registers for 64 accumulators and more
        ("disco", {"TBP": 16, "CH": 128, "STAGES": 3, "MIN_BLOCKS": 3}),
        # the generic path's pieces would need 4 Toeplitz offsets
        ("disco_bwd", {"CH": 72, "STAGES": 3, "MIN_BLOCKS": 3}),
        ("crps", {"THREADS": 96 + 1}),
        # C B^T takes 16 warps
        ("ssd", {"HEADS_PER_BLOCK": 24, "THREADS": 384}),
    ])
    def test_feasibility_prunes(self, op, dims, smoke_shapes):
        shapes = SHAPES.get(op) or smoke_shapes[op]
        assert not autotune.feasible(op, dims, shapes)
        assert dims not in autotune.candidates(op, shapes, None)

    def test_runner_needs_a_model_table_or_band(self, smoke_shapes):
        for op, shapes in (("legendre", SHAPES["legendre"]),
                           ("disco", smoke_shapes["disco"][:1]
                            + (7,) + smoke_shapes["disco"][2:])):
            with pytest.raises(ValueError, match="no FCN3 configuration"):
                OpRunner(op, shapes, "cpu").operands()

    def test_band_feasibility_reads_the_stride(self, smoke_shapes):
        dims = BLOCK_DEFAULTS["disco_bwd"]
        wide = smoke_shapes["disco_bwd"][:-1] + (1000,)
        assert autotune.feasible("disco_bwd", dims, smoke_shapes["disco_bwd"])
        assert not autotune.feasible("disco_bwd", dims, wide)
        assert autotune.disco_bwd_smem_bytes(dims, 1000) > autotune.SMEM_LIMIT

    def test_committed_shared_memory(self):
        # the comments of csrc/disco_band_bwd.cu: 63,360 bytes at stride 1
        assert autotune.disco_bwd_smem_bytes(BLOCK_DEFAULTS["disco_bwd"],
                                             1) == 63360


class TestSweepWinner:
    def test_fastest_wins(self):
        entry = autotune.sweep_op(
            "crps", CRPS,
            timer=fake_timer(lambda d: 5.0 if d["THREADS"] == 512 else 9.0))
        assert entry["dims"] == {"THREADS": 512}
        assert entry["swept"] is True
        assert entry["best_us"] < entry["default_us"]
        assert [c["dims"] for c in entry["candidates"]] == \
            autotune.candidates("crps", CRPS)

    def test_tie_prefers_default(self):
        entry = autotune.sweep_op("crps", CRPS, timer=fake_timer(
            lambda d: 7.0))
        assert entry["dims"] == BLOCK_DEFAULTS["crps"]
        assert entry["best_us"] == entry["default_us"]
        assert entry["library"] == autotune.source_of("crps")

    def test_tie_among_non_defaults_is_lexicographic(self):
        entry = autotune.sweep_op("crps", CRPS,
                                  timer=fake_timer(faster_than_default))
        assert entry["dims"] == {"THREADS": 128}

    def test_best_never_worse_than_default(self):
        for us in (lambda d: 1.0 if d == BLOCK_DEFAULTS["crps"] else 0.5,
                   lambda d: 0.5 if d == BLOCK_DEFAULTS["crps"] else 1.0):
            entry = autotune.sweep_op("crps", CRPS, timer=fake_timer(us))
            assert entry["best_us"] <= entry["default_us"]

    def test_cache_hit_skips_sweep(self, tmp_path):
        cache = TuningCache(tmp_path)
        calls = []

        def counting(dims, fn):
            calls.append(dims)
            return 1e-6

        first = autotune.sweep_op("crps", CRPS, timer=counting, cache=cache)
        assert first["swept"] is True and calls
        calls.clear()
        second = autotune.sweep_op("crps", CRPS, timer=counting,
                                   cache=cache)
        assert second["swept"] is False and not calls
        assert second["dims"] == first["dims"]
        third = autotune.sweep_op("crps", CRPS, timer=counting, cache=cache,
                                  force=True)
        assert third["swept"] is True and calls

    def test_injected_runner_gets_each_tile(self):
        seen = []

        def runner(blocks):
            seen.append(blocks)
            return lambda: None

        autotune.sweep_op("ssd", SHAPES["ssd"], runner=runner,
                          timer=fake_timer(lambda d: 1.0), max_candidates=3)
        assert seen[0] is None                    # the committed library
        assert all(isinstance(b, BlockConfig) and not b.is_default()
                   for b in seen[1:]) and len(seen) == 3

    def test_no_card_and_no_timer_raises(self):
        assert not torch.cuda.is_available()
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            autotune.sweep_op("crps", CRPS)


class TestTuningCache:
    def _sweep_into(self, root) -> TuningCache:
        cache = TuningCache(root)
        autotune.sweep_op("crps", CRPS, cache=cache,
                          timer=fake_timer(faster_than_default))
        return cache

    def _edit(self, cache, **fields):
        path = cache.entry_path("crps", CRPS)
        with open(path) as f:
            entry = json.load(f)
        entry.update(fields)
        with open(path, "w") as f:
            json.dump(entry, f)
        return TuningCache(cache.root)

    def test_identical_sweeps_write_identical_bytes(self, tmp_path):
        a = self._sweep_into(tmp_path / "a")
        b = self._sweep_into(tmp_path / "b")
        (name_a, _), = a.entries()
        (name_b, _), = b.entries()
        assert name_a == name_b
        blobs = [open(os.path.join(c.root, n), "rb").read()
                 for c, n in ((a, name_a), (b, name_b))]
        assert hashlib.sha256(blobs[0]).digest() == \
            hashlib.sha256(blobs[1]).digest()

    def test_corrupt_entry_reads_as_absent(self, tmp_path):
        cache = self._sweep_into(tmp_path)
        with open(cache.entry_path("crps", CRPS), "w") as f:
            f.write("{not json")
        fresh = TuningCache(cache.root)
        assert fresh.get("crps", CRPS) is None
        assert fresh.entries() == [] and fresh.best_for("crps") is None
        autotune.install_tuning_cache(fresh)
        assert autotune.resolve_kernel_config(None) is None

    @pytest.mark.parametrize("field,value", [
        ("gpu", "NVIDIA H100 80GB HBM3"), ("torch", "0.0.0-stale"),
        ("cuda", "0.0"), ("lattice", "0"),
        ("source", "libcrps-000000000000.so")])
    def test_stale_entry_reads_as_absent(self, tmp_path, field, value):
        fresh = self._edit(self._sweep_into(tmp_path), **{field: value})
        assert fresh.get("crps", CRPS) is None
        assert fresh.entries() == [] and fresh.best_for("crps") is None

    def test_another_card_looks_elsewhere(self, tmp_path, monkeypatch):
        cache = self._sweep_into(tmp_path)
        here = cache.entry_path("crps", CRPS)
        monkeypatch.setattr(autotune, "device_name",
                            lambda: "NVIDIA H100 80GB HBM3")
        assert cache.entry_path("crps", CRPS) != here
        assert TuningCache(cache.root).get("crps", CRPS) is None
        assert TuningCache(cache.root).entries() == []

    @pytest.mark.parametrize("dims", [
        {"THREADS": -8}, {"THREADS": 100}, {"BLOCKS": 256},
        {"THREADS": "256"}])
    def test_invalid_dims_read_as_absent(self, tmp_path, dims):
        fresh = self._edit(self._sweep_into(tmp_path), dims=dims)
        assert fresh.get("crps", CRPS) is None

    def test_library_must_match_its_dims(self, tmp_path):
        fresh = self._edit(self._sweep_into(tmp_path),
                           library=autotune.source_of("crps"))
        assert fresh.get("crps", CRPS) is None

    def test_best_for_serves_largest_slab(self, tmp_path):
        cache = TuningCache(tmp_path)
        for shapes, fast in (((4, 300), 128), ((4, 70000), 1024)):
            autotune.sweep_op("crps", shapes, cache=cache, timer=fake_timer(
                lambda d, fast=fast: 1.0 if d["THREADS"] == fast else 9.0))
        assert cache.best_for("crps") == BlockConfig.make("crps",
                                                          THREADS=1024)
        assert cache.stats() == {"dir": str(tmp_path), "entries": 2,
                                 "ops": {"crps": 2}}

    def test_best_for_default_winner_is_none(self, tmp_path):
        cache = TuningCache(tmp_path)
        autotune.sweep_op("crps", CRPS, cache=cache,
                          timer=fake_timer(lambda d: 3.0))
        assert cache.get("crps", CRPS) is not None
        assert cache.best_for("crps") is None


class TestResolution:
    def _tuned_cache(self, root) -> TuningCache:
        cache = TuningCache(root)
        autotune.sweep_op("crps", CRPS, cache=cache,
                          timer=fake_timer(faster_than_default))
        return cache

    def test_no_cache_is_identity(self):
        assert autotune.resolve_kernel_config(None) is None
        kc = KernelConfig(sht="reference", disco="reference")
        assert autotune.resolve_kernel_config(kc) is kc

    def test_installed_cache_attaches_blocks(self, tmp_path):
        autotune.install_tuning_cache(self._tuned_cache(tmp_path))
        resolved = autotune.resolve_kernel_config(None)
        assert isinstance(resolved, KernelConfig)
        assert resolved.blocks_for("crps") == BlockConfig.make(
            "crps", THREADS=128)
        assert resolved.blocks_for("legendre") is None
        pinned = KernelConfig(blocks=(BlockConfig.make("crps",
                                                       THREADS=512),))
        assert autotune.resolve_kernel_config(pinned) is pinned
        ref = autotune.resolve_kernel_config(KernelConfig("reference",
                                                          "reference"))
        assert ref.sht == "reference" and ref.blocks == resolved.blocks

    def test_engine_key_rides_tunings(self, tmp_path):
        spec = RequestSpec(config="smoke", members=2, lead_steps=2,
                           lead_chunk=2)
        untuned = spec.engine_key()
        autotune.install_tuning_cache(self._tuned_cache(tmp_path))
        tuned = spec.engine_key()
        assert tuned != untuned
        assert tuned[1].kernels.blocks == (BlockConfig.make(
            "crps", THREADS=128),)
        assert spec.batch_key() != (untuned, spec.lead_steps, spec.scored)
        autotune.install_tuning_cache(None)
        assert spec.engine_key() == untuned

    def test_install_returns_previous(self, tmp_path):
        cache = TuningCache(tmp_path)
        assert autotune.install_tuning_cache(cache) is None
        assert autotune.active_tuning_cache() is cache
        assert autotune.install_tuning_cache(str(tmp_path)) is cache
        assert autotune.active_tuning_cache().root == str(tmp_path)


class TestAgainstReference:
    @pytest.mark.parametrize("op,shapes", [
        ("legendre", (16, 32, 17, 17)), ("legendre", (1354, 360, 360, 360)),
        ("disco", (8, 32, 5, 128, 3, 9, 2)),
        ("disco", (295, 360, 7, 720, 7, 209, 1)),
        ("crps", (4, 4096)), ("crps", (2, 74753280)),
        ("ssd", (6, 16, 2, 8, 1, 4)), ("ssd", (512, 128, 24, 64, 1, 128)),
    ])
    def test_op_flops_bytes(self, op, shapes):
        assert autotune.op_flops_bytes(op, shapes) == \
            jautotune.op_flops_bytes(op, shapes)
        if op == "disco":
            assert autotune.op_flops_bytes("disco_bwd", shapes) == \
                jautotune.op_flops_bytes(op, shapes)

    def test_shape_fields(self):
        for op, fields in jautotune.OP_SHAPE_FIELDS.items():
            assert autotune.OP_SHAPE_FIELDS[op] == fields
        assert autotune.OP_SHAPE_FIELDS["disco_bwd"] == \
            jautotune.OP_SHAPE_FIELDS["disco"]

    def test_model_op_shapes_at_smoke(self, smoke_model, smoke_shapes):
        jcfg = jcfgs.NAMED_CONFIGS["smoke"]()
        want = jautotune.model_op_shapes(JFCN3(jcfg), members=2)
        cfg = smoke_model.cfg
        # the table dims agree; the port slabs the global block's input
        # channels (latent and conditioning), the reference the latent's
        assert smoke_shapes["legendre"][1:] == want["legendre"][1:]
        assert want["legendre"][0] == 2 * jcfg.c_latent
        assert smoke_shapes["legendre"][0] == 2 * (cfg.c_latent
                                                   + cfg.cond_embed)
        assert smoke_shapes["crps"] == want["crps"]
        # disco: the reference's fields, at the latent band (the
        # reference tunes the encoder's)
        band = smoke_model.latent_plan.banded_split()[0]
        b, h, s, w_in, k, d, stride = smoke_shapes["disco"]
        assert len(want["disco"]) == 7
        assert (k, h, s, d) == band.shape and stride == 1
        assert w_in == cfg.latent_nlon
        assert 1 <= b <= 2 * (cfg.c_latent + cfg.cond_embed)
        assert smoke_shapes["disco_bwd"] == smoke_shapes["disco"]

    def test_lm_op_shapes(self):
        from repro_torch.configs.archs import get_arch
        assert autotune.lm_op_shapes(get_arch("mamba2-130m"), 2, 32768) == {
            "ssd": (512, 128, 24, 64, 1, 128)}


class TestCLI:
    ARGV = ["--op", "legendre", "--shape", "8,16,9,9", "--op", "crps",
            "--shape", "2,300", "--max-candidates", "4"]

    def test_csv_rows_and_second_run_sweeps_nothing(self, tmp_path, capsys):
        argv = self.ARGV + ["--tuning-dir", str(tmp_path)]
        timer = fake_timer(lambda d: faster_than_default(
            d, "crps" if "THREADS" in d else "legendre"))
        tune.main(argv, timer=timer)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == tune.HEADER == \
            "op,shapes,swept,candidates,default_us,best_us,speedup,blocks"
        assert lines[1].startswith("legendre,8x16x9x9,1,4,9.0,5.0,1.80x,")
        assert lines[2] == "crps,2x300,1,4,9.0,5.0,1.80x,THREADS128"
        assert lines[-1] == f"sweeps=2 entries=2 dir={tmp_path}"
        tune.main(argv, timer=timer)
        lines = capsys.readouterr().out.splitlines()
        assert [ln.split(",")[2] for ln in lines[1:3]] == ["0", "0"]
        assert lines[-1] == f"sweeps=0 entries=2 dir={tmp_path}"

    def test_cpu_refused_and_no_card_refused(self, tmp_path, capsys):
        with pytest.raises(SystemExit) as e:
            tune.main(self.ARGV + ["--device", "cpu"])
        assert e.value.code == 2
        assert "nothing to tune" in capsys.readouterr().err
        with pytest.raises(SystemExit) as e:
            tune.main(self.ARGV + ["--tuning-dir", str(tmp_path)])
        assert "no CUDA card" in capsys.readouterr().err


#: a non-default tile of every family (the plain versions ignore them)
TUNED = KernelConfig(blocks=tuple(
    BlockConfig.make(op, **dict([d]))
    for op, d in (("legendre", ("TB", 16)), ("disco", ("CH", 64)),
                  ("disco_bwd", ("CH", 48)), ("crps", ("THREADS", 512)),
                  ("ssd", ("HEADS_PER_BLOCK", 12)))))


class TestTilesChangeNothingOnTheCPU:
    @pytest.mark.parametrize("op", BLOCK_OPS)
    def test_wrapper(self, op, smoke_shapes):
        runner = OpRunner(op, smoke_shapes.get(op) or SHAPES[op], "cpu")
        want = runner(None)()
        got = runner(TUNED.blocks_for(op))()
        plain = runner.plain()
        for w, g, p in zip(*(x if isinstance(x, tuple) else (x,)
                             for x in (want, got, plain))):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            torch.testing.assert_close(g, p, rtol=0, atol=0)

    def test_fcn3_step(self, smoke_model):
        model = smoke_model
        gen = torch.Generator().manual_seed(0)
        model.init(gen)
        buffers = model.make_buffers()
        cfg = model.cfg
        state = torch.randn((1, cfg.n_state, cfg.nlat, cfg.nlon),
                            generator=gen)
        cond = torch.randn((1, cfg.n_cond_in, cfg.nlat, cfg.nlon),
                           generator=gen)
        with torch.no_grad():
            want = model(buffers, state, cond)
            model.cfg = dataclasses.replace(cfg, kernels=TUNED)
            try:
                got = model(buffers, state, cond)
            finally:
                model.cfg = cfg
        assert torch.equal(got, want)

    def test_ssd_scan(self):
        r = np.random.default_rng(3)
        x, b, c = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((2, 32, 4, 8), (2, 32, 1, 8), (2, 32, 1, 8)))
        da = -torch.from_numpy(r.random((2, 32, 4)).astype(np.float32))
        want = dispatch.ssd_chunked(x, da, b, c, 16, KernelConfig())
        got = dispatch.ssd_chunked(x, da, b, c, 16, TUNED)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        ref = ssmlib.ssd_chunked(x, da, b, c, 16)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
