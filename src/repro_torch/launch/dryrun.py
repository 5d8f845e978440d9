"""Dry run of the production cases: one step on fake tensors, as rank 0
of a fake world of ranks, read against the H100 model.

Every (architecture x input shape) case and the FCN3 cases run against
the production meshes -- 16 x 16 = 256 ranks, and 2 x 16 x 16 = 512 with
``--multi-pod`` -- as rank 0 of a world on torch's ``fake`` process group
(``FakeStore``: every collective returns at once, with outputs of the
right shape).  Parameters, optimizer state, geometry buffers and inputs
are fake tensors (``launch/counting.py``); the geometry plans are built
in numpy, as always, and their tensors made fake with their non-zeros
counted.  Nothing is allocated on a card and no kernel launches: each
kernel wrapper counts its call (``kernels/tally.py``).  The record of a
case gives, for rank 0:

* FLOPs: the kernels' (by family, with their calls) and the aten ops';
* bytes, the kernels' and the eager aten ops';
* the collectives' output bytes by kind (``coll_breakdown``) and by
  kind, group size and nodes spanned (``collectives``);
* the live set's peak (``peak_memory_per_device``) and what it holds at
  the peak (``memory_analysis``: parameters, gradients, optimizer,
  buffers, inputs, activations);
* ``model_flops`` by the JAX package's conventions (6 N D, 2 N D; for
  FCN3 the weight-reuse estimate 6 N 0.05 pixels b e t) and the roofline
  terms of ``launch/roofline.py``.

Usage::

  python -m repro_torch.launch.dryrun --arch fcn3 --shape train --reduced-fcn3
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape prefill_32k
  python -m repro_torch.launch.dryrun --arch fcn3 --shape train --multi-pod
  python -m repro_torch.launch.dryrun --all --reduced-fcn3 --out r.jsonl --jobs 2

``--fcn3-sharding`` says what the model axis carries: ``domain``
(latitude: ``distributed.domain.DomainFCN3`` and the trainer's domain
step) or ``ensemble`` (the members: ``TrainConfig.member_axes``).
Refused, one line each naming the ROADMAP item (``--all`` counts them
apart from failures): ``channel`` and an ensemble that does not split
over the model axis in ``ensemble`` mode (A10.3).  An LM train step is
the loss, its backward (with the layers checkpointed, as the JAX
``LM``'s: each SSD forward kernel is counted twice, the backward
kernels once), the gradients' all-reduce over the data ranks and the
Adam update (``train/lm.py``).  ``--moe-dispatch`` (dense or scatter) is the
MoE layers' dispatch; the experts are whole on every rank (the JAX dry
run places them over the model axis: a difference by design, ROADMAP
C).  ``--all`` runs every case in a process of its own;
the fake default group is process-wide, and ``run_case`` destroys it
before it returns.

The fake tensors stand on the card's device where there is a card, on
``cpu`` elsewhere (``counting.dry_run_device``); the counts are the same.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

from repro_torch.configs import archs as archlib
from repro_torch.configs import fcn3 as fcn3cfg
from repro_torch.configs import shapes as shapelib
from repro_torch.launch import counting
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as roof

FCN3_SHAPES = {
    # (batch, ensemble, rollout): Table 3 stage-1 train step and a 16-member
    # inference step at full 721x1440 resolution (the JAX package's cases)
    "train": dict(batch=16, ensemble=16, rollout=1, mode="train"),
    "rollout4": dict(batch=4, ensemble=2, rollout=4, mode="train"),
    "inference": dict(batch=1, ensemble=16, rollout=1, mode="infer"),
}
FCN3_MODES = ("domain", "channel", "ensemble")


class Refused(NotImplementedError):
    """A case the port does not run yet; its message names the ROADMAP
    item."""


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as ``rank`` of a world of ``world_size`` ranks on the
    ``fake`` process group; destroyed on leaving."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already up; a dry "
                           "run makes a fake world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _count(params) -> float:
    return float(sum(p.numel() for p in params.values()))


def active_param_count(cfg, params: dict) -> float:
    """Non-embedding active parameters (the 6 N_active D convention)."""
    total = _count(params)
    total -= cfg.vocab_size * cfg.d_model * 2  # embed + lm_head
    if cfg.moe:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        expert = sum(float(p.numel()) for name, p in params.items()
                     if any(n in name for n in ("w_gate", "w_up", "w_down"))
                     and p.dim() >= 3 and e in p.shape)
        total -= expert * (1.0 - k / e)
    return total


def fcn3_model_flops(cfg, n_params: float, b: int, e: int, t: int) -> float:
    """The JAX package's FCN3 estimate: every weight fires at each latent
    pixel with a weight-reuse factor of 0.05 (only the conv and spectral
    weights multiply per pixel; the pointwise MLPs dominate the count),
    6 N D for a train step."""
    pixels = cfg.latent_nlat * cfg.latent_nlon
    return 6.0 * n_params * 0.05 * pixels * b * e * t


def _local(n: int, parts: int) -> int:
    """A dim of ``n`` over ``parts`` ranks: split where it divides, whole
    where it does not (the reference's ``sanitize_specs``)."""
    return n // parts if n % parts == 0 else n


@dataclasses.dataclass
class Case:
    """A built case: the step, its fake arguments, the model FLOPs and
    what the record adds about it (``info``: parameters, row blocks)."""

    step: object
    args: tuple
    model_flops: float
    info: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# FCN3
# ---------------------------------------------------------------------------

def build_fcn3_case(shape_name: str, mesh, dry: counting.DryRun,
                    reduced: bool = False, fcn3_mode: str = "domain",
                    fcn3_dtype: str = "float32", *, cfg=None,
                    sizes: tuple[int, int, int] | None = None,
                    tcfg=None) -> Case:
    """One FCN3 step on fake tensors inside ``dry``.

    ``shape_name`` picks ``FCN3_SHAPES`` (``sizes`` = (batch, ensemble,
    rollout) overrides it, ``cfg`` the model config, ``tcfg`` the
    ``TrainConfig``); on a ``mesh`` the step is rank 0's of the domain
    decomposition or of ensemble parallelism (``fcn3_mode``), without one
    the single process's."""
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import domain as domlib
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.optim import adam as adamlib
    from repro_torch.train import trainer as trlib
    if fcn3_mode not in FCN3_MODES:
        raise ValueError(f"--fcn3-sharding {fcn3_mode}")
    if fcn3_mode == "channel":
        raise Refused("--fcn3-sharding channel: the port places no sharded "
                      "parameters yet (ROADMAP A10.3)")
    sh = FCN3_SHAPES[shape_name]
    b, e, t = sizes or (sh["batch"], sh["ensemble"], sh["rollout"])
    if cfg is None:
        cfg = fcn3cfg.fcn3_small() if reduced else fcn3cfg.fcn3_full()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[fcn3_dtype]
    dev = dry.device
    model = FCN3(cfg, device=dev)
    if dt != torch.float32:
        # the JAX config's dtype: parameters (and below, the inputs) in it
        for mod in model.modules():
            for name, p in mod._parameters.items():
                mod._parameters[name] = torch.nn.Parameter(
                    p.detach().to(dt), requires_grad=p.requires_grad)
    params = dict(model.named_parameters())
    n_params = _count(params)
    mf = fcn3_model_flops(cfg, n_params, b, e, t)
    dry.label(params, "parameters")
    dp = meshlib.data_axes(mesh) if mesh is not None else ()
    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp)
    n_mp = mesh.size(mesh.mesh_dim_names.index("model")) if mesh else 1
    mp_rank = mesh.get_local_rank("model") if mesh else 0
    domain = mesh is not None and fcn3_mode == "domain"
    rows = ((0, cfg.nlat) if not domain else
            domlib.row_block(cfg.nlat, mp_rank, n_mp))
    hw = (rows[1] - rows[0], cfg.nlon)
    noise = GeneratorNoise(torch.Generator())
    info = {"io_rows": rows, "params": n_params}

    def fields(lead, channels):
        x = torch.empty(lead + (channels,) + hw, dtype=dt, device=dev)
        dry.label(x, "inputs")
        return x

    if sh["mode"] == "train":
        if mesh is not None and not domain and e % n_mp:
            raise Refused(
                f"--fcn3-sharding ensemble: {e} members do not split over "
                f"the model axis's {n_mp} ranks; the reference replicates "
                "such a dim (sanitize_specs), the port's trainer places no "
                "replicated member axis yet (ROADMAP A10.3)")
        if tcfg is None:
            tcfg = trlib.TrainConfig(
                ensemble_size=e, rollout_steps=t,
                member_axes=(("model", dp if len(dp) > 1 else dp[0])
                             if mesh is not None and not domain else None))
        tr = trlib.EnsembleTrainer(model, tcfg,
                                   fcn3cfg.channel_weights(cfg.n_levels),
                                   mesh)
        buffers = (tr.domain.make_buffers() if tr.domain is not None
                   else model.make_buffers())
        buffers.update(tr.make_loss_buffers())
        buffers = dry.fake(buffers)
        dry.label(buffers, "buffers")
        b_loc = _local(b, n_dp)
        batch = {"state": fields((b_loc,), cfg.n_state),
                 "targets": fields((b_loc, t), cfg.n_state),
                 "aux": fields((b_loc, t), cfg.n_aux)}
        opt_state = tr.optimizer.init(params)
        dry.label(opt_state, "optimizer")
        if tr.domain is not None:
            info["latent_rows"] = tr.domain.lat_block

        def train_step(buffers, opt_state, batch):
            loss, aux, grads = tr.loss_and_grads(buffers, batch, noise)
            dry.label(grads, "gradients")
            adamlib.global_norm(grads)
            tr.optimizer.update(params, grads, opt_state)
            return loss

        return Case(train_step, (buffers, opt_state, batch), mf, info)

    # inference: one forward of the members, without gradients
    if domain:
        d = domlib.DomainFCN3(model, mesh.get_group("model"))
        buffers, fwd = d.make_buffers(), d
        info["latent_rows"] = d.lat_block
        e_loc, b_loc = _local(e, n_dp), b
    else:
        buffers, fwd = model.make_buffers(), model
        e_loc = _local(e, n_mp) if mesh is not None else e
        b_loc = _local(b, n_dp) if mesh is not None else b
    buffers = dry.fake(buffers)
    dry.label(buffers, "buffers")
    state = fields((e_loc, b_loc), cfg.n_state)
    cond = fields((e_loc, b_loc), cfg.n_cond_in)

    @torch.no_grad()
    def infer_step(buffers, state, cond):
        return fwd(buffers, state, cond)

    return Case(infer_step, (buffers, state, cond), mf / 6.0 * 2.0, info)


# ---------------------------------------------------------------------------
# LMs
# ---------------------------------------------------------------------------

def build_lm_case(arch: str, shape_name, mesh, dry: counting.DryRun,
                  moe_dispatch: str = "dense", cfg=None) -> Case:
    """One LM step on fake tensors inside ``dry``: the train step, the
    prefill or one decode step on rank 0's slice of the batch (the batch
    over the data axes; the port's LM has no tensor parallelism, so the
    model axis holds replicas).

    A MoE architecture's layers take ``moe_dispatch``: ``scatter``
    dispatches over the data ranks where the batch splits over them
    (``moe.scatter_group``), each rank's capacity from its own slice; a
    batch that does not split is whole on every rank and takes the dense
    path, as the JAX package's ``apply_moe`` chooses.  The experts are
    whole on every rank, where the JAX dry run places them over the model
    axis (``distributed/sharding.py``'s expert rule).  ``shape_name``
    names one of ``shapes.INPUT_SHAPES`` or is an ``InputShape`` of its
    own (the smoke test's)."""
    from repro_torch.distributed import compat
    from repro_torch.models import moe as moelib
    from repro_torch.models.transformer import LM
    shape = (shapelib.INPUT_SHAPES[shape_name]
             if isinstance(shape_name, str) else shape_name)
    if cfg is None:
        cfg = shapelib.adapt_arch_for_shape(archlib.get_arch(arch), shape)
    dp = meshlib.data_axes(mesh) if mesh is not None else ()
    if cfg.moe and moe_dispatch != "dense":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch, dp_axes=dp))
    model = LM(cfg, device=dry.device)
    params = dict(model.named_parameters())
    dry.label(params, "parameters")
    n_active = active_param_count(cfg, params)
    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp)
    b = _local(shape.global_batch, n_dp)
    moe_group = None
    if cfg.moe and dp:
        moe_group = moelib.scatter_group(
            cfg.moe, compat.mesh_group(mesh, dp), shape.global_batch,
            1 if shape.mode == "decode" else shape.seq_len)
    info = {"params": _count(params), "active_params": n_active,
            "local_batch": b}
    if cfg.moe:
        info["moe_dispatch"] = "scatter" if moe_group is not None else "dense"
    if shape.mode == "train":
        from repro_torch.optim import adam as adamlib
        from repro_torch.train import lm as lmtrain
        specs = shapelib.input_specs(
            cfg, dataclasses.replace(shape, global_batch=b))
        batch = {k: torch.empty_like(v, device=dry.device)
                 for k, v in specs.items()}
        dry.label(batch, "inputs")
        model.requires_grad_(True)
        opt = adamlib.Adam(lr=1e-4)
        opt_state = opt.init(params)
        dry.label(opt_state, "optimizer")
        data_group = compat.mesh_group(mesh, dp) if dp else None

        def train_step(opt_state, batch):
            loss, _, grads = lmtrain.loss_and_grads(model, batch, data_group,
                                                    moe_group)
            dry.label(grads, "gradients")
            opt.update(params, grads, opt_state)
            return loss

        mf = roof.model_flops_train(n_active,
                                    shape.global_batch * shape.seq_len)
        return Case(train_step, (opt_state, batch), mf, info)
    if shape.mode == "prefill":
        specs = shapelib.input_specs(
            cfg, dataclasses.replace(shape, global_batch=b))
        # the tokens, and the patches (vlm) or encoder frames (audio)
        batch = {k: torch.empty_like(v, device=dry.device)
                 for k, v in specs.items() if k != "labels"}
        dry.label(batch, "inputs")
        mf = roof.model_flops_decode(n_active,
                                     shape.global_batch * shape.seq_len)
        return Case(lambda batch: model(**batch, moe_group=moe_group),
                    (batch,), mf, info)
    tokens = torch.empty((b, 1), dtype=torch.int32, device=dry.device)
    cache = model.init_cache(b, shape.seq_len)
    extra = {}
    if cfg.family == "audio":
        extra["enc_states"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                          device=dry.device)
    dry.label((tokens, extra), "inputs")
    dry.label(cache, "buffers")
    mf = roof.model_flops_decode(n_active, shape.global_batch)
    return Case(lambda tokens, cache, extra: model.decode_step(
        tokens, cache, shape.seq_len - 1, moe_group=moe_group, **extra),
        (tokens, cache, extra), mf, info)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def record(case: Case, rl: roof.Roofline, counts: counting.Counts) -> dict:
    """One case's record: the roofline's keys and the counts behind
    them."""
    rec = rl.to_dict()
    rec.update(
        kernels=counts.kernels, kernel_flops=counts.kernel_flops,
        aten_flops=counts.aten_flops, kernel_bytes=counts.kernel_bytes,
        aten_bytes=counts.aten_bytes,
        aten_top_bytes=dict(sorted(counts.aten_op_bytes.items(),
                                   key=lambda kv: -kv[1])[:8]),
        collectives=[{"kind": k, "group": g, "nodes": n, "calls": c,
                      "bytes": by}
                     for (k, g, n), (c, by) in sorted(
                         counts.collectives.items())],
        memory_analysis=counts.at_peak, **case.info)
    return rec


def run_case(arch: str, shape_name: str, multi_pod: bool,
             reduced_fcn3: bool = False, fcn3_mode: str = "domain",
             fcn3_dtype: str = "float32", moe_dispatch: str = "dense",
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """Rank 0's counted step of one case on the production mesh (or a
    ``("data", "model")`` mesh of ``mesh_shape``); the fake world is gone
    when it returns."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        axes = ("data", "model")
    chips = math.prod(mesh_shape)
    device = counting.dry_run_device()
    t0 = time.time()
    with fake_world(chips):
        mesh = meshlib.make_mesh(mesh_shape, axes, device.type)
        with counting.DryRun(device) as dry:
            if arch == "fcn3":
                case = build_fcn3_case(shape_name, mesh, dry, reduced_fcn3,
                                       fcn3_mode, fcn3_dtype)
            else:
                case = build_lm_case(arch, shape_name, mesh, dry,
                                     moe_dispatch)
            t_build = time.time() - t0
            rl, counts = roof.analyze(f"{arch}/{shape_name}", case.step,
                                      case.args, chips, case.model_flops,
                                      dry)
    rec = record(case, rl, counts)
    rec.update(arch=arch, shape=shape_name,
               mesh="x".join(map(str, mesh_shape)), rank=0,
               device=device.type, fcn3_sharding=fcn3_mode,
               build_s=round(t_build, 2),
               run_s=round(time.time() - t0 - t_build, 2))
    return rec


ALL_ARCH_NAMES = sorted(archlib.ARCHS)


def _all_cases(meshes=("single", "multi")) -> list[tuple[str, str, bool]]:
    cases = []
    for arch in ALL_ARCH_NAMES:
        for shape in shapelib.INPUT_SHAPES:
            for m in meshes:
                cases.append((arch, shape, m == "multi"))
    for shape in FCN3_SHAPES:
        for m in meshes:
            cases.append(("fcn3", shape, m == "multi"))
    return cases


#: the exit code of a refused case
REFUSED = 3


def build_parser() -> argparse.ArgumentParser:
    """The JAX dry run's flags."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="append each record to this JSON-lines file "
                         "(--all: dryrun_results.jsonl by default)")
    ap.add_argument("--reduced-fcn3", action="store_true",
                    help="use the ~1-degree FCN3 (fcn3_small)")
    ap.add_argument("--moe-dispatch", default="dense",
                    choices=("dense", "scatter"))
    ap.add_argument("--fcn3-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--fcn3-sharding", default="domain", choices=FCN3_MODES,
                    help="domain = latitude over the model axis; ensemble = "
                         "the members over it; channel is refused (A10.3)")
    return ap


def _run_all(args) -> int:
    """Every case in a process of its own, ``args.jobs`` at a time."""
    procs: list = []
    ok, refused, failed = [], [], []
    with open(args.out or "dryrun_results.jsonl", "w") as f:
        def drain(block=False):
            for p, case in list(procs):
                if block:
                    p.wait()
                if p.poll() is None:
                    continue
                procs.remove((p, case))
                out, _ = p.communicate()
                tag = f"{case[0]}/{case[1]}/{'multi' if case[2] else 'single'}"
                if p.returncode == 0:
                    line = next(ln for ln in out.splitlines()
                                if ln.startswith("RESULT_JSON:"))
                    rec = json.loads(line[len("RESULT_JSON:"):])
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    ok.append(tag)
                    print(f"[ok] {tag} bottleneck={rec['bottleneck']} "
                          f"build={rec['build_s']}s run={rec['run_s']}s",
                          flush=True)
                elif p.returncode == REFUSED:
                    refused.append(tag)
                    why = next((ln for ln in out.splitlines()
                                if ln.startswith("DRYRUN REFUSED")), "")
                    print(f"[refused] {tag} {why}", flush=True)
                else:
                    failed.append(tag)
                    print(f"[FAIL] {tag}\n{out[-2000:]}", flush=True)

        for case in _all_cases():
            while len(procs) >= args.jobs:
                drain(block=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", case[0], "--shape", case[1],
                   "--moe-dispatch", args.moe_dispatch,
                   "--fcn3-sharding", args.fcn3_sharding,
                   "--fcn3-dtype", args.fcn3_dtype]
            if case[2]:
                cmd.append("--multi-pod")
            if args.reduced_fcn3:
                cmd.append("--reduced-fcn3")
            procs.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), case))
        while procs:
            drain(block=True)
    print(f"\n{len(ok)} ok, {len(refused)} refused, {len(failed)} failed")
    if failed:
        print("failures:", failed)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    """Run one case (print its record) or ``--all``."""
    args = build_parser().parse_args(argv)
    if args.all:
        return _run_all(args)
    if args.arch is None or args.shape is None:
        raise SystemExit("--arch and --shape, or --all")
    try:
        rec = run_case(args.arch, args.shape, args.multi_pod,
                       args.reduced_fcn3, fcn3_mode=args.fcn3_sharding,
                       fcn3_dtype=args.fcn3_dtype,
                       moe_dispatch=args.moe_dispatch)
    except Refused as exc:
        print(f"DRYRUN REFUSED: {args.arch}/{args.shape}: {exc}")
        return REFUSED
    print(json.dumps(rec, indent=1))
    print("RESULT_JSON:" + json.dumps(rec))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"\nDRYRUN OK: {args.arch}/{args.shape} mesh={rec['mesh']} "
          f"bottleneck={rec['bottleneck']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
