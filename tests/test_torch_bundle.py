"""Warm-start bundles of the port (``repro_torch.serving.bundle``) and the
geometry-plan install they rest on (ROADMAP A5), on ``fcn3_smoke`` and
the CPU.

* A5: the JAX package's ``export_plan`` payloads and Legendre tables
  install in the port, and the port's plans then equal the reference's
  exactly (psi, its banded split and every layout the kernels read);
  the port's own payloads survive the bundle's npz format;
* a bundle packed, verified and booted in this process serves its shape
  bit for bit as a direct engine does, with no miss; a readonly replica
  refuses a config whose plans it lacks, a changed file (naming it) and
  a foreign environment;
* kernel tunings (ROADMAP A11): a bundle packed with a tuning cache
  installed carries its entries under ``tunings/`` and each winner's
  library under ``blobs/`` (fake libraries here: the CPU has no nvcc),
  verifies, installs the tunings at boot and serves under the tuned
  keys; a tuning whose library is not packed is refused.  Library file
  names: none with no defines changes the committed kernel's name, a
  variant gets its own, and the build passes its ``-D`` flags.
"""

import hashlib
import json
import os
import shutil
import tarfile
import threading

import numpy as np
import pytest
from _torch_threads import few_torch_threads  # noqa: F401

from repro.configs import fcn3 as jcfgs
from repro.core.fcn3 import FCN3 as JFCN3
from repro.core.sphere import disco as jdisco
from repro.core.sphere import legendre as jleg
from repro.serving import bundle as jbundle
from repro_torch.configs import fcn3 as tcfgs
from repro_torch.core import fcn3 as tfcn3
from repro_torch.core.sphere import disco as tdisco
from repro_torch.core.sphere import legendre as tleg
from repro_torch.inference.engine import ForecastEngine, members_noise
from repro_torch.kernels import autotune, build
from repro_torch.kernels.config import BlockConfig
from repro_torch.launch import bundle as bundle_cli
from repro_torch.serving import bundle as bundlelib
from repro_torch.serving.cache import ExecutableCache, ReadOnlyCacheMiss
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.client import ForecastClient
from repro_torch.serving.scheduler import ModelPool
from repro_torch.serving.service import ForecastService
from repro_torch.serving.spec import RequestSpec

SPEC = RequestSpec(config="smoke", members=2, lead_steps=2, lead_chunk=2,
                   scored=True, return_state=True)
WAIT_S = 120.0
PLAN_ARRAYS = ("psi", "lat_idx", "psi_band", "wrap_rows", "psi_wrap")


@pytest.fixture(autouse=True)
def fresh_geometry_caches():
    """Each test starts from empty plan and table caches in the port and
    leaves them as it found them (installs are process-wide)."""
    saved = (dict(tdisco._PLAN_OVERRIDES), dict(tleg._TABLE_OVERRIDES))
    tdisco._PLAN_OVERRIDES.clear()
    tleg._TABLE_OVERRIDES.clear()
    tdisco._cached_plan.cache_clear()
    tleg._cached_table.cache_clear()
    yield
    tdisco._PLAN_OVERRIDES.clear()
    tdisco._PLAN_OVERRIDES.update(saved[0])
    tleg._TABLE_OVERRIDES.clear()
    tleg._TABLE_OVERRIDES.update(saved[1])


def _result(stream):
    box: dict = {}

    def run():
        try:
            box["value"] = stream.result()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive(), "stream hung"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _jax_payloads():
    """The JAX model's plan exports, as the reference's engine makes them
    (its three DISCO plans, its two Legendre tables)."""
    m = JFCN3(jcfgs.fcn3_smoke())
    out = [{"kind": "disco", **jdisco.export_plan(p)}
           for p in (m.enc_plan, m.latent_plan, m.dec_plan)]
    for sht in (m.in_sht, m.latent_sht):
        colat = np.ascontiguousarray(sht.grid.colat, np.float64)
        out.append({"kind": "legendre", "lmax": sht.lmax, "mmax": sht.mmax,
                    "colat": colat, "table": jleg.cached_legendre_table(
                        sht.lmax, sht.mmax, colat)})
    return out


def _port_plans():
    m = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu")
    return m, (m.enc_plan, m.latent_plan, m.dec_plan)


class TestPlanInstall:
    def test_reference_payloads_install_in_the_port(self):
        payloads = _jax_payloads()
        for p in payloads:
            bundlelib._install_plan_payload(p)
        keys = tfcn3.geometry_keys(tcfgs.fcn3_smoke())
        assert all((tdisco if kind == "disco" else tleg).is_installed(key)
                   for kind, key in keys)
        model, plans = _port_plans()
        # built nothing: every plan is the installed object
        assert tdisco._cached_plan.cache_info().currsize == 0
        for plan, p in zip(plans, payloads[:3]):
            assert tdisco._PLAN_OVERRIDES[plan.plan_key()] is plan
            assert tuple(p["key"]) == plan.plan_key()
            band, rows, wrap = plan.banded_split()
            for name, got in zip(PLAN_ARRAYS, (plan.psi, plan.lat_idx,
                                               band, rows, wrap)):
                np.testing.assert_array_equal(got, p[name], err_msg=name)
                assert got.dtype == np.asarray(p[name]).dtype, name
        for sht, p in zip((model.in_sht, model.latent_sht), payloads[3:]):
            np.testing.assert_array_equal(
                tleg.cached_legendre_table(sht.lmax, sht.mmax,
                                           sht.grid.colat), p["table"])
        assert tleg._cached_table.cache_info().currsize == 0

    def test_installed_plans_give_the_built_buffers(self):
        # the kernels' layouts (live taps, lists by input row, order
        # extents) are derived from the installed arrays: equal to a
        # freshly built model's
        built = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu").make_buffers()
        tdisco._cached_plan.cache_clear()
        tleg._cached_table.cache_clear()
        for p in _jax_payloads():
            bundlelib._install_plan_payload(p)
        got = tfcn3.FCN3(tcfgs.fcn3_smoke(), device="cpu").make_buffers()
        for part in ("enc", "latent", "dec", "latent_sht"):
            assert set(got[part]) == set(built[part])
            for name, t in got[part].items():
                assert t.dtype == built[part][name].dtype
                assert bool((t == built[part][name]).all()), (part, name)

    def test_port_round_trip_through_npz(self, tmp_path):
        model, plans = _port_plans()
        eng = ForecastEngine(model, SPEC.engine_config())
        payloads = eng.plan_exports()
        assert [p["kind"] for p in payloads] == ["disco"] * 3 + ["legendre"] * 2
        for i, p in enumerate(payloads):
            path = str(tmp_path / f"plan_{i}.npz")
            bundlelib._save_plan_npz(path, p)
            # the reference's reader takes the port's file as it is
            ref = jbundle._load_plan_npz(path)
            back = bundlelib._load_plan_npz(path)
            assert set(ref) == set(back) == set(p)
            bundlelib._install_plan_payload(back)
        for plan in plans:
            inst = tdisco._PLAN_OVERRIDES[plan.plan_key()]
            assert inst is not plan
            for a, b in zip(inst.banded_split(), plan.banded_split()):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(inst.psi, plan.psi)
            for name, arr in plan.live_taps().items():
                np.testing.assert_array_equal(inst.live_taps()[name], arr)
            assert (inst.stride, inst.affine, inst.n_basis) == (
                plan.stride, plan.affine, plan.n_basis)

    def test_table_shape_checked(self):
        colat = np.linspace(0.1, 3.0, 5)
        with pytest.raises(ValueError, match="does not match key"):
            tleg.install_legendre_table(4, 3, colat, np.zeros((5, 4, 4)))


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bundles") / "smoke-bundle")
    return bundlelib.pack([SPEC], out=out, max_batch=2, device="cpu")


#: the tile the tuned bundle's fake sweep picks for the Legendre kernel
TUNED = BlockConfig.make("legendre", TB=16)


@pytest.fixture(scope="module")
def tuned_bundle_dir(tmp_path_factory, bundle_dir):
    """A bundle of SPEC packed with a tuning cache installed: one
    Legendre entry whose (fake-timed) winner is ``TUNED``, its library a
    fake file in a build directory of its own (no nvcc on the CPU)."""
    root = tmp_path_factory.mktemp("tuned")
    cache = autotune.TuningCache(root / "tunings")
    timer = (lambda dims, fn: 1e-3 if dims == TUNED.sizes() else 2e-3)
    entry = autotune.sweep_op("legendre", (8, 16, 9, 9), cache=cache,
                              timer=timer, max_candidates=4)
    assert entry["dims"] == TUNED.sizes()
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "BUILD_DIR", root / "build")
    build.BUILD_DIR.mkdir()
    build.library_path("legendre", TUNED.defines()).write_bytes(b"\x7fELF")
    previous = autotune.install_tuning_cache(cache)
    try:
        return bundlelib.pack([SPEC], out=str(root / "tuned-bundle"),
                              max_batch=2, device="cpu")
    finally:
        autotune.install_tuning_cache(previous)
        mp.undo()


def _copy(bundle_dir, tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(bundle_dir, dst)
    return str(dst)


class TestBundle:
    def test_manifest(self, bundle_dir):
        b = bundlelib.WarmStartBundle.load(bundle_dir)
        m = b.manifest
        assert m["format"] == bundlelib.BUNDLE_FORMAT
        assert m["environment"]["device"] == "cpu"
        assert m["tunings"] == [] and m["libraries"] == []
        assert not any(rel.startswith("xla/") for rel in m["files"])
        (eng,) = m["engines"]
        assert eng["spec"] == SPEC.to_dict()
        assert [p["batch"] for p in eng["programs"]] == [None, 2]
        assert len(m["plans"]) == 5
        # no kernel library on the CPU: the wrappers run plain versions
        assert not [f for f in m["files"] if f.startswith("blobs/")]
        b.verify(device="cpu")
        assert b.specs() == [SPEC]

    def test_boot_serves_bit_identically_with_no_miss(self, bundle_dir):
        pool = ModelPool(device="cpu")
        sched = bundlelib.boot_scheduler(bundle_dir, pool=pool)
        try:
            info = sched.bundle_info
            assert info["programs"] == info["disk_hits"] == 2
            assert info["plans"] == 5
            # the model was built over the installed plans
            assert tdisco._cached_plan.cache_info().currsize == 0
            srv = ForecastService(scheduler=sched).make_server(port=0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                c = ForecastClient(port=srv.server_address[1],
                                   timeout=WAIT_S)
                res = c.forecast(SPEC)
                assert c.health()["bundle_id"] == info["bundle_id"]
                stats = c.stats()
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=10)
            assert res.timing["compile_s"] == 0.0
            assert stats["cache"]["readonly"] is True
            assert stats["cache"]["misses"] == 0
            assert stats["bundle"]["bundle_id"] == info["bundle_id"]
            # another config's plans are not in the bundle: refused
            # before anything is built
            with pytest.raises(Exception) as e:
                _result(sched.submit(RequestSpec(config="small")))
            assert "ReadOnlyCacheMiss" in str(e.value)
            with pytest.raises(ReadOnlyCacheMiss):
                sched.warmup(RequestSpec(config="small"))
        finally:
            sched.close(timeout=30)
        b = pool.get("smoke")
        want = ForecastEngine(b.model, SPEC.engine_config()).forecast(
            b.buffers, b.ds.state(SPEC.sample, 0),
            lambda n: b.ds.aux_fields(6.0 * (n + 1)),
            members_noise(b.model, SPEC.seed), steps=SPEC.lead_steps,
            truth=lambda n: b.ds.state(SPEC.sample, n + 1))
        for name, arr in want.scores.items():
            np.testing.assert_array_equal(res.scores[name], arr.numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(res.final_state,
                                      want.final_state.numpy())

    def test_changed_file_refused_by_name(self, bundle_dir, tmp_path):
        path = _copy(bundle_dir, tmp_path)
        with open(os.path.join(path, "plans", "plan_00_disco.npz"),
                  "ab") as f:
            f.write(b"\0")
        with pytest.raises(bundlelib.BundleError,
                           match="sha256 mismatch for 'plans/plan_00_disco"):
            bundlelib.WarmStartBundle.load(path).verify(device="cpu")

    def test_tuned_bundle_packs_verifies_and_installs(self,
                                                      tuned_bundle_dir):
        b = bundlelib.WarmStartBundle.load(tuned_bundle_dir)
        m = b.manifest
        (rel,) = m["tunings"]
        lib = build.library_file("legendre", TUNED.defines())
        assert rel.startswith("tunings/tune_") and rel in m["files"]
        assert m["libraries"] == [{"file": f"blobs/{lib}",
                                   "name": "legendre",
                                   "defines": [["TUNE_TB", 16]]}]
        assert f"blobs/{lib}" in m["files"]
        # the bundled engines were warmed with the tuned tile
        tuned = SPEC.engine_config()
        assert tuned.kernels is None      # no cache installed here
        b.verify(device="cpu")
        previous = autotune.install_tuning_cache(None)
        try:
            assert b.install_tunings() == 1
            active = autotune.active_tuning_cache()
            assert active.root == os.path.join(b.root, "tunings")
            assert active.best_for("legendre") == TUNED
            assert SPEC.engine_config().kernels.blocks == (TUNED,)
            assert SPEC.engine_key() != (SPEC.config, tuned)
        finally:
            autotune.install_tuning_cache(previous)

    def test_tuned_bundle_boots_under_the_tuned_keys(self, tuned_bundle_dir,
                                                     bundle_dir):
        previous = autotune.install_tuning_cache(None)
        sched = None
        try:
            sched = bundlelib.boot_scheduler(
                tuned_bundle_dir, pool=ModelPool(device="cpu"))
            info = sched.bundle_info
            assert info["tunings"] == 1
            assert info["programs"] == info["disk_hits"] == 2
            assert SPEC.engine_config().kernels.blocks == (TUNED,)
            res = _result(sched.submit(SPEC))
            assert res.timing["compile_s"] == 0.0
            assert sched.cache.stats()["misses"] == 0
        finally:
            if sched is not None:
                sched.close(timeout=30)
            autotune.install_tuning_cache(previous)
        # a bundle without tunings uninstalls a leftover cache
        autotune.install_tuning_cache(os.path.join(tuned_bundle_dir,
                                                   "tunings"))
        try:
            assert bundlelib.WarmStartBundle.load(
                bundle_dir).install_tunings() == 0
            assert autotune.active_tuning_cache() is None
        finally:
            autotune.install_tuning_cache(previous)

    def test_tuning_without_its_library_refused(self, tuned_bundle_dir,
                                                tmp_path):
        path = _copy(tuned_bundle_dir, tmp_path)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        rel = f"blobs/{build.library_file('legendre', TUNED.defines())}"
        os.remove(os.path.join(path, rel))
        del m["files"][rel]
        m["libraries"] = []
        m["bundle_id"] = bundlelib.hashlib.sha256(
            bundlelib._canonical(m)).hexdigest()
        with open(mpath, "w") as f:
            json.dump(m, f)
        with pytest.raises(bundlelib.BundleError,
                           match=f"launches '{rel}', which the bundle "
                                 "does not pack"):
            bundlelib.WarmStartBundle.load(path).verify(device="cpu",
                                                        deep=False)

    def test_foreign_environment_and_edited_manifest_refused(
            self, bundle_dir, tmp_path):
        path = _copy(bundle_dir, tmp_path)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        m["environment"]["torch"] = "0.0.0"
        with open(mpath, "w") as f:
            json.dump(m, f)
        with pytest.raises(bundlelib.BundleError) as e:
            bundlelib.WarmStartBundle.load(path).verify(device="cpu")
        assert "content address" in str(e.value)
        assert "environment mismatch on 'torch'" in str(e.value)
        with pytest.raises(bundlelib.BundleError, match="'device'"):
            bundlelib.WarmStartBundle.load(bundle_dir).verify(
                device="cuda")

    def test_library_that_will_not_load_refused(self, bundle_dir, tmp_path):
        path = _copy(bundle_dir, tmp_path)
        b = bundlelib.WarmStartBundle.load(path)
        rel = f"blobs/{build.library_file('legendre')}"
        with open(os.path.join(path, rel), "wb") as f:
            f.write(b"not a shared object")
        b.manifest["files"][rel] = {"sha256": "", "bytes": 19}
        cache = ExecutableCache(persist_dir=b.blobs_dir, readonly=True)
        faults = FaultInjector()
        cache.bind_faults(faults)
        with pytest.raises(bundlelib.BundleError,
                           match="cannot load its kernel libraries"
                                 r" \['legendre'\].*failed to load"):
            b.install_libraries(cache)
        assert faults.stats()["occurrences"] == {"cache_read": 1,
                                                 "import_chunk": 1}
        assert not build.is_loaded("legendre")
        assert b.install_plans() == 5

    def test_reference_bundle_format_refused(self, bundle_dir, tmp_path):
        path = _copy(bundle_dir, tmp_path)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        m["format"] = jbundle.BUNDLE_FORMAT
        with open(mpath, "w") as f:
            json.dump(m, f)
        with pytest.raises(bundlelib.BundleError, match="not supported"):
            bundlelib.WarmStartBundle.load(path)

    def test_tar_archive_loads_and_verifies(self, bundle_dir, tmp_path):
        tar = str(tmp_path / "b.tar")
        with tarfile.open(tar, "w") as tf:
            for name in sorted(os.listdir(bundle_dir)):
                tf.add(os.path.join(bundle_dir, name), arcname=name)
        b = bundlelib.WarmStartBundle.load(tar)
        b.verify(device="cpu")
        assert b.bundle_id == bundlelib.WarmStartBundle.load(
            bundle_dir).bundle_id

    def test_cli_verify_and_inspect(self, bundle_dir, tmp_path, capsys):
        with pytest.raises(SystemExit) as e:
            bundle_cli.main(["verify", bundle_dir, "--device", "cpu"])
        assert e.value.code == 0
        assert "[bundle] OK" in capsys.readouterr().out
        with pytest.raises(SystemExit) as e:
            bundle_cli.main(["inspect", bundle_dir])
        assert json.loads(capsys.readouterr().out)["plans"]
        path = _copy(bundle_dir, tmp_path)
        os.remove(os.path.join(path, "plans", "plan_04_legendre.npz"))
        with pytest.raises(SystemExit) as e:
            bundle_cli.main(["verify", path, "--device", "cpu"])
        assert e.value.code == 1
        assert "missing bundle file" in capsys.readouterr().out


class TestLibraryNames:
    """Variant libraries (``kernels.build``): the committed kernels keep
    their names, so existing caches and bundles stay valid."""

    @pytest.mark.parametrize("name", build.SOURCES)
    def test_no_defines_is_the_committed_name(self, name):
        sha = hashlib.sha1((build.CSRC / f"{name}.cu").read_bytes())
        for header in sorted(build.CSRC.glob("*.cuh")):
            sha.update(header.read_bytes())
        want = f"lib{name}-{sha.hexdigest()[:12]}.so"
        assert build.library_file(name) == want
        assert build.library_file(name, ()) == want
        assert build.label(name) == name

    def test_variants_get_distinct_names(self):
        a = build.library_file("legendre", (("TUNE_TB", 16),))
        b = build.library_file("legendre", (("TUNE_TB", 64),))
        c = build.library_file("legendre", (("TUNE_TK", 8),
                                            ("TUNE_TB", 16)))
        names = {build.library_file("legendre"), a, b, c}
        assert len(names) == 4
        assert all(n.startswith("liblegendre-") for n in names)
        # the defines are sorted before they are hashed
        assert c == build.library_file("legendre", (("TUNE_TB", 16),
                                                    ("TUNE_TK", 8)))
        assert build.label("legendre", (("TUNE_TK", 8), ("TUNE_TB", 16))
                           ) == "legendre[TUNE_TB=16,TUNE_TK=8]"

    def test_command_carries_the_defines(self, monkeypatch):
        monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
        out = build.BUILD_DIR / "x.so"
        plain = build._command("crps", out)
        tuned = build._command("crps", out, (("TUNE_THREADS", 512),))
        assert not any(a.startswith("-D") for a in plain)
        assert "-DTUNE_THREADS=512" in tuned
        assert [a for a in tuned if a != "-DTUNE_THREADS=512"] == plain

    @pytest.mark.parametrize("defines", [(("tune_tb", 16),),
                                         (("TUNE TB", 16),),
                                         (("TUNE_TB", "16"),),
                                         (("TUNE_TB", True),),
                                         (("TUNE_TB", 16), ("TUNE_TB", 32))])
    def test_bad_defines_refused(self, defines):
        with pytest.raises(ValueError):
            build.library_file("legendre", defines)
