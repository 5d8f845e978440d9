"""The forecast mode: one ensemble forecast request streamed through
``ForecastEngine.stream``, closed loop, one client.

Set-up makes the inputs, builds the model and its engine, loads the
seed's weights and takes the stream's first chunk.  The window takes
later chunks until ``--seconds`` have passed and ends on a chunk
boundary (``--trace 1``: a profiled run of ``trace_chunks`` chunks
instead).  ``correct`` then holds the engine's own outputs to the plain
reference: the perturbed members' first lead, and lead ``k`` (drawn from
the seed among the window's first leads) stepped by the reference from
the engine's lead ``k - 1`` with the noise of lead ``k`` worked out
again from the injected draws; with truth, lead ``k``'s scores too.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from perfbench import device as card
from perfbench import harness, inputs
from perfbench.reference import fcn3 as ref


@dataclasses.dataclass
class Inputs:
    """What the seed makes for one forecast."""

    cfg: ref.ModelConfig
    state0: torch.Tensor
    aux_pool: list
    truth_pool: list | None
    noise: inputs.NoiseDraws
    perturb: torch.Tensor
    check_lead: int
    check_pair: int

    def aux(self, n: int):
        """The aux fields of lead ``n`` (host)."""
        return self.aux_pool[n % len(self.aux_pool)]

    def truth(self, n: int):
        """The verifying state of lead ``n`` (host)."""
        return self.truth_pool[n % len(self.truth_pool)]


def make_inputs(cell: harness.Cell, seed: int, dev: torch.device) -> Inputs:
    """The state, the aux and truth pools and the draws of ``seed``."""
    tr = cell.traffic
    e = cell.config["ensemble_members"]
    cfg = ref.ModelConfig.of(cell.config["model"])
    fields = inputs.Fields(cfg, dev)
    sample = inputs.sub_seed(seed, "sample") % 1_000_000
    pool = tr["pool"]
    traj = fields.trajectory(seed, sample, pool if tr["scored"] else 0)
    t_hours = 6.0 * (sample % 1460)
    out = Inputs(
        cfg=cfg, state0=traj[0],
        aux_pool=[fields.aux(t_hours + 6.0 * n) for n in range(pool)],
        truth_pool=[t.cpu() for t in traj[1:]] if tr["scored"] else None,
        noise=inputs.NoiseDraws(cfg, seed, "forecast", (e,), dev),
        perturb=inputs.perturbation_coeffs(cfg, seed, (e + 1) // 2, dev),
        check_lead=2 + inputs.sub_seed(seed, "check") % tr["check_span"],
        check_pair=inputs.sub_seed(seed, "pair") % max(1, e // 2))
    del traj, fields
    return out


class Program:
    """The port's engine on one forecast, its outputs captured where the
    check needs them: every member at leads 0, k - 1 and k, and each
    lead's finiteness per member."""

    def __init__(self, cell: harness.Cell, inp: Inputs, seed: int,
                 dev: torch.device):
        from repro_torch.core.fcn3 import FCN3, FCN3Config
        from repro_torch.inference import perturbations as perturblib
        from repro_torch.inference.engine import (EngineConfig,
                                                  ForecastEngine,
                                                  InjectedNoise)
        tr = cell.traffic
        self.model = FCN3(FCN3Config(**cell.config["model"]), device=dev)
        inputs.load_weights(self.model, inputs.draw_weights(inp.cfg, seed,
                                                            dev))
        self.buffers = self.model.make_buffers()
        self.captured: dict[int, torch.Tensor] = {}
        self.keep = (0, inp.check_lead - 1, inp.check_lead)
        self.slots: dict[int, torch.Tensor] | None = None
        self._lead = 0
        self.engine = ForecastEngine(self.model, EngineConfig(
            members=cell.config["ensemble_members"], lead_chunk=tr["lead_chunk"],
            centered=tr["centered"],
            perturb=perturblib.PerturbationConfig(
                kind="obs", amplitude=tr["amplitude"]),
            spectra=tr["spectra"]), diagnostics=self._diagnose)
        self.stream = self.engine.stream(
            self.buffers, inp.state0, inp.aux,
            InjectedNoise(inp.noise.z_hat0(), inp.noise, inp.perturb),
            steps=tr["leads"], truth=inp.truth if tr["scored"] else None)

    def _diagnose(self, sf: torch.Tensor) -> torch.Tensor:
        i = self._lead
        self._lead += 1
        if self.slots is None:
            # lead 0 goes to the host; the checked leads' buffers are held
            # from the first lead on, so the peak is the same whichever
            # lead the seed checks
            self.slots = {0: torch.empty(sf.shape, dtype=sf.dtype,
                                         pin_memory=sf.is_cuda)}
            self.slots.update({n: torch.empty_like(sf)
                               for n in self.keep[1:]})
        if i in self.slots:
            self.slots[i].copy_(sf, non_blocking=True)
            self.captured[i] = self.slots[i]
        return torch.isfinite(sf).flatten(1).all(dim=1)

    def close(self) -> None:
        """End the stream and free the program's state."""
        self.stream.close()
        del self.stream, self.engine, self.buffers, self.model


def lead_scores(blocks: list, n: int) -> dict[str, torch.Tensor]:
    """Lead ``n``'s scores from the chunks the stream yielded."""
    for blk in blocks:
        hit = [i for i, s in enumerate(blk.lead_steps) if s == n]
        if hit:
            return {k: v[hit[0]].clone() for k, v in blk.scores.items()}
    raise ValueError(f"lead {n} was not yielded")


def rms_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| over ||want|| (2-norms over every entry)."""
    got = got.to(device=want.device, dtype=want.dtype)
    return float((got - want).norm() / want.norm())


def reference_outputs(cell: harness.Cell, inp: Inputs, seed: int,
                      prev: torch.Tensor, dev: torch.device,
                      dtype: torch.dtype) -> dict:
    """The reference's lead 0 of the checked pair of perturbed members
    and its lead k of every member stepped from ``prev`` (the program's
    lead k - 1), in ``dtype``, and the geometry it used."""
    tr = cell.traffic
    e, k = cell.config["ensemble_members"], inp.check_lead
    geo = ref.Geometry.create(inp.cfg, dev, dtype, ("wpct", "pct")
                              if tr["scored"] or tr["spectra"] else ("pct",))
    P = {n: p.to(dtype) for n, p in
         inputs.draw_weights(inp.cfg, seed, dev).items()}

    def cond(n):
        aux = torch.as_tensor(inp.aux(n), device=dev, dtype=dtype)
        z = ref.noise_fields(geo, inp.noise.z_hat(n), tr["centered"])
        return torch.cat([aux[None].expand((e,) + aux.shape), z], dim=1)

    pair = pair_of(inp, e)
    members0 = ref.obs_members(geo, inp.state0, inp.perturb, e,
                               tr["amplitude"])[pair]
    return {"lead0": ref.step(geo, P, members0, cond(0)[pair]),
            "lead": ref.step(geo, P, prev, cond(k)), "geo": geo}


def pair_of(inp: Inputs, e: int) -> slice:
    """The members of lead 0 the check steps again: one antithetic pair
    drawn from the seed (both signs of one perturbation draw)."""
    lo = 2 * inp.check_pair
    return slice(lo, min(e, lo + 2))


def reference_readings(cell: harness.Cell, inp: Inputs, seed: int,
                       got: dict, dev: torch.device, control: bool = False
                       ) -> tuple[dict[str, float], dict | None]:
    """The numbers that decide ``correct``, against the reference in
    float64: ``start_err`` (lead 0 of one antithetic pair of perturbed
    members, drawn from the seed), ``step_err``
    (lead k from the program's lead k - 1), each ||got - want|| /
    ||want|| over every member and point, and, with truth or spectra,
    ``score_err``: the worst over lead k's scores of max |got - want| /
    max |want|, the reference scoring the judged side's own members.
    ``got``: the program's ``lead0`` / ``prev`` / ``lead`` states and
    ``scores``.  With ``control``, also the same numbers of the
    reference in float32 with TF32 products put in the program's place
    (the control; else None)."""
    tr = cell.traffic
    k = inp.check_lead
    scored = tr["scored"] or tr["spectra"]
    truth = (torch.as_tensor(inp.truth(k), device=dev)
             if tr["scored"] else None)
    prev = got["prev"].to(dev)
    with torch.no_grad():
        want = reference_outputs(cell, inp, seed, prev, dev, torch.float64)
        geo = want.pop("geo")

        def judged(g):
            out = {"start_err": rms_err(g["lead0"], want["lead0"]),
                   "step_err": rms_err(g["lead"], want["lead"])}
            if scored:
                w_s = ref.scores(geo, g["lead"].to(dev), truth,
                                 tr["spectra"])
                out["score_err"] = max(card.rel_err(g["scores"][n], w_s[n])
                                       for n in w_s)
            return out

        got = dict(got, lead0=got["lead0"][pair_of(
            inp, cell.config["ensemble_members"])])
        readings = judged(got)
        ctl = None
        if control:
            del geo
            card.free(dev)
            with card.tf32():
                cgot = reference_outputs(cell, inp, seed, prev, dev,
                                         torch.float32)
                if scored:
                    cgot["scores"] = ref.scores(cgot.pop("geo"),
                                                cgot["lead"], truth,
                                                tr["spectra"])
            geo = ref.Geometry.create(inp.cfg, dev, torch.float64)
            ctl = judged(cgot)
    return readings, ctl


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t0: float, fault=None) -> dict:
    """One run of a forecast cell; returns ``harness.emit``'s arguments.
    ``fault`` (tests only) breaks the engine under the timed path."""
    dev = torch.device(device)
    tr = cell.traffic
    e = cell.config["ensemble_members"]
    card.reset_peak(dev)
    card.fp32_only()
    inp = make_inputs(cell, seed, dev)
    prog = Program(cell, inp, seed, dev)
    if fault is not None:
        fault(prog.engine)
    blocks = [next(prog.stream)]
    card.sync(dev)
    setup_s = time.perf_counter() - t0

    window = []
    with card.Profiled(trace) as prof:
        tw = time.perf_counter()
        while True:
            with torch.profiler.record_function("bench.chunk"):
                blk = next(prog.stream)
                card.sync(dev)
            window.append(blk)
            if (len(window) >= tr["trace_chunks"] if trace
                    else time.perf_counter() - tw >= seconds):
                break
        window_s = time.perf_counter() - tw
    traced = prof.trace(window_s)
    blocks += window
    while inp.check_lead not in prog.captured:
        blocks.append(next(prog.stream))
    card.sync(dev)
    peak = card.peak_bytes(dev)
    leads = sum(len(b.lead_steps) for b in window)
    failed = sum(int((~b.diagnostics).sum()) for b in window)
    got = {"lead0": prog.captured[0],
           "prev": prog.captured[inp.check_lead - 1],
           "lead": prog.captured[inp.check_lead]}
    if tr["scored"] or tr["spectra"]:
        got["scores"] = lead_scores(blocks, inp.check_lead)
    prog.close()
    del prog, blocks, window
    card.free(dev)
    t_ref = time.perf_counter()
    readings, _ = reference_readings(cell, inp, seed, got, dev)
    print(f"reference check {time.perf_counter() - t_ref:.3f} s, lead "
          f"{inp.check_lead}", file=sys.stderr)
    correct, checks = harness.judge(readings, cell.limits)

    return harness.result(
        cell, correct=correct, attempted=e * leads, failed=failed,
        checks=checks, device=card.record(dev, peak),
        values={"setup_s": setup_s, "peak_mem_gb": peak / 1e9,
                "member_leads_per_s": e * leads / window_s},
        traced=traced, work={"member_leads": e * leads})
