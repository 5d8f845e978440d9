"""Launch the forecast service (paper Section 5, served) on the card.

Starts the HTTP front end over the async scheduler: requests queue,
engines stay warm per shape key (LRU-evicted under
``--engine-budget-mb``), keys are warmed once (kernel libraries loaded,
the engine's inputs resident; optionally persisted), same-shape requests
coalesce into one batched rollout (``--max-batch``/``--batch-window-ms``),
pickup is QoS-aware (request ``priority``/``deadline_ms``/``degrade``
fields; ``--aging-ms``/``--degrade-margin-ms`` tune the policy), and
every response streams scores chunk-by-chunk as NDJSON -- the JAX
package's ``repro.launch.service``, flag for flag, on ``--device``
(``cuda`` unless ``cpu`` is asked for).

  PYTHONPATH=src python -m repro_torch.launch.service --config smoke \
      --port 8771 --device cpu

then, from anywhere::

  python -m repro_torch.serving.client --port 8771 --members 2 --lead-steps 4

``--persist-dir D`` keeps the kernel libraries the warmed keys load
(``lib<name>-<sha>.so``), so a restarted service loads them instead of
running ``nvcc``.  ``--warm SPEC_JSON`` warms a request shape before the
server accepts traffic.

``--bundle PATH`` boots a zero-cold-start replica from a warm-start
bundle built by ``python -m repro_torch.launch.bundle build``: the
manifest is verified against this process (torch and CUDA versions, the
device, the source fingerprint, file hashes -- any mismatch refuses with
a diagnostic instead of silently building), the packed geometry plans
are installed, and every bundled engine is pre-warmed from the bundle's
libraries over a *readonly* cache before the server accepts traffic.

``--tuning-dir D`` installs a kernel ``TuningCache`` (built by
``python -m repro_torch.launch.tune``): every engine resolves the tuned
tiles, which ride the engine keys, and launches their libraries.
``--tune`` first sweeps the preloaded config's shapes into it (cache
hits skip the sweep; ``--tune`` alone means ``--tuning-dir .tuning``);
it needs the card.  Both are refused beside ``--bundle``: a bundle
replica installs the tunings the bundle packs.
"""

from __future__ import annotations

import argparse
import json
import logging

from repro_torch.configs import fcn3 as fcn3cfg

_log = logging.getLogger("repro_torch.launch.service")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8771,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--config", nargs="+", default=["smoke"],
                    choices=sorted(fcn3cfg.NAMED_CONFIGS),
                    help="configs to preload (model + params built at "
                         "startup, not on first request)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint for the first --config entry")
    ap.add_argument("--max-concurrency", type=int, default=1,
                    help="worker threads running device work")
    ap.add_argument("--queue-size", type=int, default=64,
                    help="pending requests before 503")
    ap.add_argument("--max-batch", type=int, default=1,
                    help="coalesce up to this many queued same-shape "
                         "requests into one batched rollout dispatch "
                         "(1 disables coalescing)")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="how long a picked request waits for same-shape "
                         "companions before rolling (latency spent to "
                         "fill batches; 0 coalesces only what is "
                         "already queued)")
    ap.add_argument("--engine-budget-mb", type=float, default=None,
                    help="LRU-evict cold engines when the pool's "
                         "estimated bytes exceed this budget "
                         "(default: unbounded)")
    ap.add_argument("--aging-ms", type=float, default=2000.0,
                    help="a batch-priority request waiting this long is "
                         "promoted to interactive at pickup "
                         "(anti-starvation; 0 restores pure FIFO)")
    ap.add_argument("--degrade-margin-ms", type=float, default=None,
                    help="opted-in requests within this margin of their "
                         "deadline serve the validated member-count "
                         "floor instead of missing (default: within "
                         "25%% of the total deadline budget)")
    ap.add_argument("--persist-dir", default=None,
                    help="persist the kernel libraries warmed keys load "
                         "(lib<name>-<sha>.so) here, so a restarted "
                         "service skips nvcc")
    ap.add_argument("--tuning-dir", default=None, metavar="DIR",
                    help="install this kernel TuningCache (built by "
                         "repro_torch.launch.tune): every engine resolves "
                         "the tuned tiles, which ride the engine keys")
    ap.add_argument("--tune", action="store_true",
                    help="sweep the preloaded config's kernel tiles into "
                         "--tuning-dir before warmup (cache hits skip the "
                         "sweep; implies --tuning-dir .tuning when unset)")
    ap.add_argument("--bundle", default=None, metavar="PATH",
                    help="boot from a warm-start bundle (dir or .tar "
                         "built by repro_torch.launch.bundle): verify, "
                         "install plans, pre-warm every bundled engine "
                         "from its kernel libraries; refuses on any "
                         "mismatch instead of building")
    ap.add_argument("--warm", action="append", default=[],
                    metavar="SPEC_JSON",
                    help="RequestSpec JSON to warm before serving "
                         "(repeatable), e.g. "
                         "'{\"members\": 4, \"lead_steps\": 8}'")
    ap.add_argument("--trace-dir", default=None,
                    help="dump every served request's span tree as "
                         "Chrome/Perfetto trace JSON into this directory "
                         "(traces are also served from memory at "
                         "GET /v1/trace/<request_id>)")
    ap.add_argument("--profile-dir", default=None,
                    help="enable the opt-in per-request torch.profiler "
                         "hook: requests sending 'profile': true get "
                         "their rollout captured as a Chrome trace under "
                         "this directory (inert when unset)")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="POINT:SPEC",
                    help="arm a deterministic fault (repeatable), e.g. "
                         "'rollout_chunk:n=2' (fail exactly the 2nd "
                         "chunk), 'import_chunk:first=3,kind=permanent' "
                         "or 'stream_write:p=0.1,seed=7'; see "
                         "repro_torch.serving.faults.FaultSpec.  Unarmed "
                         "points cost nothing")
    ap.add_argument("--retry-backoff-ms", type=float, default=50.0,
                    help="base delay for per-request transient retries "
                         "(exponential: base * 2^(attempt-1), capped)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive build/warm failures on one "
                         "engine key before its circuit opens (requests "
                         "shed with reason=circuit_open, no build)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                    help="seconds an open circuit waits before letting "
                         "one half-open probe through")
    ap.add_argument("--resume-grace-s", type=float, default=15.0,
                    help="seconds a disconnected client may reclaim its "
                         "stream via GET /v1/stream/<id>?from=<seq> "
                         "before the request is cancelled")
    ap.add_argument("--no-tracing", action="store_true",
                    help="disable request tracing and the flight "
                         "recorder (metrics stay on -- they back "
                         "/v1/stats); the instrumented path is free "
                         "when disabled, so this mainly declutters")
    ap.add_argument("--log-level", default="INFO",
                    help="level for the repro_torch.* loggers on stderr")
    ap.add_argument("--device", default="cuda",
                    help="torch device the replica runs on; 'cpu' must "
                         "be asked for")
    args = ap.parse_args(argv)
    if args.bundle and args.persist_dir:
        ap.error("--bundle and --persist-dir are mutually exclusive: a "
                 "bundle replica serves a readonly library set")
    if args.bundle and (args.tune or args.tuning_dir):
        ap.error("--bundle and --tune/--tuning-dir are mutually "
                 "exclusive: a bundle replica resolves the tunings "
                 "packed in the bundle")
    if args.tune and not args.tuning_dir:
        args.tuning_dir = ".tuning"
    from repro_torch.serving.cache import ExecutableCache
    from repro_torch.serving.observability import (ObservabilityConfig,
                                                   setup_logging)
    from repro_torch.serving.scheduler import (ForecastScheduler, ModelPool,
                                               RequestSpec)
    from repro_torch.serving.service import ForecastService

    # Logs go to stderr: stdout stays clean for scripted capture.
    setup_logging(args.log_level)
    obs_config = ObservabilityConfig(
        enabled=not args.no_tracing,
        trace_dir=args.trace_dir, profile_dir=args.profile_dir)

    warm_specs = []
    for raw in args.warm:
        try:
            spec = RequestSpec.from_dict(json.loads(raw))
            spec.validate()
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            ap.error(f"--warm {raw!r}: {e}")
        warm_specs.append(spec)

    faults = None
    if args.fault:
        from repro_torch.serving.faults import FaultInjector
        try:
            faults = FaultInjector.from_args(args.fault)
        except ValueError as e:
            ap.error(f"--fault: {e}")
        _log.warning("fault injection ARMED: %s (do not deploy this "
                     "replica to production)", args.fault)

    try:
        pool = ModelPool({args.config[0]: args.ckpt} if args.ckpt else None,
                         device=args.device)
    except RuntimeError as e:   # no card and no --device cpu
        ap.error(str(e))

    if args.tuning_dir:
        # before any engine exists: RequestSpec.engine_config() resolves
        # the active cache, so the warmups below already load the tuned
        # libraries under the tuned keys
        from repro_torch.kernels import autotune
        cache = autotune.TuningCache(args.tuning_dir)
        autotune.install_tuning_cache(cache)
        if args.tune:
            if pool.device.type != "cuda":
                ap.error("--tune times the kernels on the card; on the CPU "
                         "the plain versions run, whatever the tile")
            from repro_torch.launch import tune
            model = pool.get(args.config[0]).model
            entries = tune.run(autotune.model_op_shapes(model), cache,
                               device=pool.device, out=_log.info)
            _log.info("tuning ready: sweeps=%d %s",
                      sum(e["swept"] for e in entries), cache.stats())
        else:
            _log.info("tuning cache installed: %s", cache.stats())

    sched_kwargs = dict(
        max_concurrency=args.max_concurrency, queue_size=args.queue_size,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        engine_budget_bytes=(int(args.engine_budget_mb * 2**20)
                             if args.engine_budget_mb is not None
                             else None),
        aging_ms=args.aging_ms,
        degrade_margin_ms=args.degrade_margin_ms,
        observability=obs_config,
        faults=faults,
        retry_backoff_ms=args.retry_backoff_ms,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        resume_grace_s=args.resume_grace_s,
        # readiness gate: /readyz stays 503 ("starting") until preload
        # + warmup below finish, so LB traffic probes never route to a
        # replica that would eat a cold build
        ready=False)
    if args.bundle:
        # Zero-cold-start boot: verify + install plans + pre-warm every
        # bundled engine from its libraries (readonly cache -- anything
        # the bundle lacks refuses instead of building).
        from repro_torch.serving.bundle import (WarmStartBundle,
                                                boot_scheduler)
        b = WarmStartBundle.load(args.bundle)
        _log.info("booting from bundle %s (%s) ...",
                  b.bundle_id[:12], args.bundle)
        scheduler = boot_scheduler(b, pool=pool, **sched_kwargs)
        info = scheduler.bundle_info
        _log.info("bundle boot OK: %s engine(s), %s program(s), "
                  "%s from the bundle, %s plan(s) installed in %ss, "
                  "%s kernel librar(ies) loaded, %s tuning(s), boot_s=%s",
                  info["engines"], info["programs"], info["disk_hits"],
                  info["plans"], info["plans_install_s"],
                  info["libraries"], info["tunings"], info["boot_s"])
    else:
        scheduler = ForecastScheduler(
            pool=pool, cache=ExecutableCache(args.persist_dir),
            **sched_kwargs)
    for name in args.config:
        _log.info("preloading config %r ...", name)
        pool.get(name)
    for spec in warm_specs:
        out = scheduler.warmup(spec)
        _log.info("warmed %s: compile_s=%.2f (%s)", spec.to_dict(),
                  out["compile_s"],
                  [o["source"] for o in out["outcomes"]])
        if args.max_batch > 1:
            # also warm the full-batch coalesced keys, so the first
            # burst of same-shape traffic pays zero warm-up
            outb = scheduler.warmup(spec, batch=args.max_batch)
            _log.info("warmed batch=%d: compile_s=%.2f (%s)",
                      args.max_batch, outb["compile_s"],
                      [o["source"] for o in outb["outcomes"]])

    # Preload + warmup done: flip /readyz from "starting" to "ready".
    scheduler.mark_ready()

    service = ForecastService(scheduler=scheduler)
    server = service.make_server(args.host, args.port)
    host, port = server.server_address[:2]
    _log.info("listening on http://%s:%s (POST /v1/forecast, "
              "GET /v1/stats, GET /metrics, GET /healthz, GET /readyz)",
              host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        _log.info("shutting down")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
