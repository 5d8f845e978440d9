"""LM serving steps: prefill and decode at the zoo's input shapes.

The port's counterpart of the JAX package's ``launch/dryrun.py``
``build_lm_case``: the same ``prefill`` (full-sequence logits) and
``serve_step`` (one token against the cache) at the same
``configs/shapes.py`` shapes, run eagerly on real tensors instead of
lowered and compiled, for every architecture of the zoo.  The VLM's ``patches`` and the audio encoder's ``enc_frames`` (for
decode: its ``enc_states``) are stubs of their front ends, drawn from
``--seed`` on the device at ``input_specs``' shapes; the VLM's text is
the sequence less its patches.  Weights are random, drawn from
``--seed``; the dry run on fake tensors is ``launch/dryrun.py``.

Runs on the CUDA card unless ``--device cpu`` is given.  ``--batch`` and
``--seq-len`` cut the shape (``--smoke`` defaults them to 2 and 128);
prints one line per phase with seconds, tokens/s, peak device memory and
the SSD kernel's launches; a MoE prefill's line adds the share of its
(token, k) pairs that their experts' capacity dropped.  ``--profile`` runs the phase once more under
``torch.profiler`` and prints the device's busy share of that run and
its kernels by summed kernel time (``[profile]`` lines).

  PYTHONPATH=src python -m repro_torch.launch.lm --arch mamba2-130m \
      --smoke --shape prefill_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.lm --arch zamba2-2.7b \
      --smoke --shape decode_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.lm --arch deepseek-v2-236b \
      --smoke --shape prefill_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.lm --arch mamba2-130m \
      --shape decode_32k --decode-steps 32
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch

from repro_torch.configs import archs, shapes
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import moe
from repro_torch.models.transformer import LM
from repro_torch.runtime import resolve_device

#: the cuts ``--smoke`` takes unless --batch / --seq-len say otherwise
SMOKE_BATCH, SMOKE_SEQ_LEN = 2, 128
#: the zoo's architectures, every one of which the port builds
ARCHS = sorted(archs.ARCHS)


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers.  A MoE stack keeps its
    ``n_dense_layers`` and needs the rest a positive multiple of
    ``moe_every`` (whole units); another cut raises ``ValueError``."""
    if cfg.family == "moe":
        rest = layers - cfg.n_dense_layers
        if rest <= 0 or rest % cfg.moe_every:
            raise ValueError(
                f"{cfg.name}: {layers} layers is no MoE stack: it keeps "
                f"the {cfg.n_dense_layers} dense layers and needs the rest "
                f"a positive multiple of moe_every {cfg.moe_every}")
    return dataclasses.replace(cfg, n_layers=layers)


def build_model(arch: str, smoke: bool = False, shape: str = "prefill_32k",
                seed: int = 0, device: str = "cuda",
                kernels: KernelConfig | None = None,
                layers: int | None = None) -> LM:
    """``arch`` (or its smoke variant) adapted to ``shape``, cut to
    ``layers`` decoder (or SSM) layers where given (``cut_depth``), with
    random weights drawn on the device from ``seed``."""
    dev = resolve_device(device)
    cfg = archs.smoke_config(arch) if smoke else archs.get_arch(arch)
    cfg = shapes.adapt_arch_for_shape(cfg, shapes.INPUT_SHAPES[shape])
    if layers:
        cfg = cut_depth(cfg, layers)
    model = LM(cfg, device=dev, kernels=kernels)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    return model


def prefill(model: LM, tokens: torch.Tensor, **extra) -> torch.Tensor:
    """Full-sequence logits (B, S, V_pad), the dry run's ``prefill``;
    ``extra``: ``patches`` (vlm) or ``enc_frames`` (audio)."""
    return model(tokens, **extra)


def serve_step(model: LM, tokens: torch.Tensor, cache: dict, pos: int,
               **extra) -> tuple[torch.Tensor, dict]:
    """One token (B, 1) against ``cache``, the dry run's ``serve_step``;
    ``extra``: ``enc_states`` (audio)."""
    return model.decode_step(tokens, cache, pos, **extra)


def random_tokens(model: LM, shape: tuple[int, ...], seed: int
                  ) -> torch.Tensor:
    """Token ids below the unpadded vocabulary, drawn on the device."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return torch.randint(0, model.cfg.vocab_size, shape, generator=gen,
                         device=model.device)


def front_end_inputs(model: LM, batch: int, mode: str, seed: int) -> dict:
    """The stubs of the front ends at ``input_specs``' shapes, standard
    normal draws on the device: ``patches`` (B, n_patches, D) for a VLM
    prefill, ``enc_frames`` (prefill) or ``enc_states`` (decode) (B,
    encoder_seq, D) for audio; nothing for the other families."""
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def normal(n):
        return torch.randn((batch, n, cfg.d_model), generator=gen,
                           device=model.device)
    if cfg.family == "vlm" and mode == "prefill":
        return {"patches": normal(cfg.n_patches)}
    if cfg.family == "audio":
        key = "enc_frames" if mode == "prefill" else "enc_states"
        return {key: normal(cfg.encoder_seq)}
    return {}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "n/a"
    return f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_prefill(model: LM, batch: int, seq_len: int, seed: int = 1,
                report=print) -> dict:
    """One timed prefill of random tokens (and the front ends' stubs; a
    VLM's text is ``seq_len`` less its patches); returns the logits and
    what the ``[prefill]`` line reports."""
    dev = model.device
    extra = front_end_inputs(model, batch, "prefill", seed)
    n_text = seq_len - (extra["patches"].shape[1] if "patches" in extra
                        else 0)
    tokens = random_tokens(model, (batch, n_text), seed)
    _sync(dev)
    _reset_peak(dev)
    before = ssd_ops.launches, ssd_ops.state_launches
    kept = []          # each MoE layer's kept pairs and all its pairs
    t0 = time.perf_counter()
    with moe.observe(lambda r: kept.append((r.keep.sum(), r.keep.numel()))):
        logits = prefill(model, tokens, **extra)
    _sync(dev)
    sec = time.perf_counter() - t0
    out = {"seconds": sec, "tokens_per_s": batch * seq_len / sec,
           "peak_mem_gb": _peak(dev),
           "ssd_launches": ssd_ops.launches - before[0],
           "ssd_state_launches": ssd_ops.state_launches - before[1],
           "logits": logits}
    drops = ""
    if kept:
        pairs = sum(n for _, n in kept)
        out["moe_pairs"] = pairs
        out["moe_dropped"] = pairs - int(sum(int(k) for k, _ in kept))
        out["moe_drop_share"] = out["moe_dropped"] / pairs
        drops = (f" moe_drop_share={out['moe_drop_share']:.4f} "
                 f"(of {pairs} pairs in {len(kept)} MoE layers)")
    report(f"[prefill] arch={model.cfg.name} batch={batch} seq_len={seq_len} "
           f"seconds={sec:.3f} tokens_per_s={out['tokens_per_s']:.1f} "
           f"peak_mem_gb={out['peak_mem_gb']} "
           f"ssd_launches={out['ssd_launches']} "
           f"ssd_state_launches={out['ssd_state_launches']} "
           f"logits={tuple(logits.shape)}{drops}")
    return out


def run_decode(model: LM, batch: int, seq_len: int, steps: int,
               seed: int = 2, report=print) -> dict:
    """``steps`` greedy decode steps from an empty cache (a random first
    token each sequence); returns the last logits and what the
    ``[decode]`` line reports."""
    dev = model.device
    cache = model.init_cache(batch, seq_len)
    tokens = random_tokens(model, (batch, 1), seed)
    extra = front_end_inputs(model, batch, "decode", seed)
    _sync(dev)
    _reset_peak(dev)
    before = ssd_ops.launches
    t0 = time.perf_counter()
    for pos in range(steps):
        logits, cache = serve_step(model, tokens, cache, pos, **extra)
        tokens = logits[:, -1, :model.cfg.vocab_size].argmax(-1, keepdim=True)
    _sync(dev)
    sec = time.perf_counter() - t0
    out = {"seconds": sec, "ms_per_step": 1e3 * sec / steps,
           "tokens_per_s": batch * steps / sec, "peak_mem_gb": _peak(dev),
           "ssd_launches": ssd_ops.launches - before, "logits": logits,
           "cache": cache}
    report(f"[decode] arch={model.cfg.name} batch={batch} steps={steps} "
           f"seconds={sec:.3f} ms_per_step={out['ms_per_step']:.3f} "
           f"tokens_per_s={out['tokens_per_s']:.1f} "
           f"peak_mem_gb={out['peak_mem_gb']} "
           f"ssd_launches={out['ssd_launches']}")
    return out


def report_profile(prof, wall_s: float, report=print, top: int = 8) -> dict:
    """Device busy time of a profiled run and its ``top`` kernels by
    summed kernel time, from the profiler's device events; prints
    ``[profile]`` lines and returns the totals.

    The busy time is the union of the intervals of every kernel, copy
    and set on every stream, overlaps counted once.  The ranges of
    ``record_function`` (the port's spans), mirrored on the device's
    timeline as user annotations, are no work of the card's and are
    left out.  The per-name table sums each name's kernel time, so
    kernels on overlapping streams each count there."""
    events = prof.events()
    ranges = {e.name for e in events if e.is_user_annotation}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and e.name not in ranges]
    if not kernels:
        report("[profile] the profiler saw no device events")
        return {"busy_s": None, "wall_s": wall_s}
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    busy_s = busy_us / 1e6
    summed_us = sum(us for _, us in by_name.values())
    report(f"[profile] wall_s={wall_s:.3f} device_busy_s={busy_s:.3f} "
           f"busy_share={busy_s / wall_s:.3f} kernel_launches={len(kernels)}")
    report(f"[profile] by summed kernel time ({summed_us / 1e3:.3f} ms in "
           "all, overlapping streams each counted):")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in ranked[:top]:
        report(f"[profile]   {us / 1e3:10.3f} ms "
               f"{100.0 * us / summed_us:5.1f}% x{count:<6d} {name[:90]}")
    return {"busy_s": busy_s, "wall_s": wall_s}


def build_parser() -> argparse.ArgumentParser:
    """The LM CLI's argument parser."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCHS)
    ap.add_argument("--shape", default="prefill_32k",
                    choices=("prefill_32k", "decode_32k"))
    ap.add_argument("--batch", type=int, default=None,
                    help="cut of the shape's global batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="cut of the shape's sequence (prefill) or cache "
                         "(decode) length")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for")
    ap.add_argument("--profile", action="store_true",
                    help="run the phase again under torch.profiler")
    return ap


def main(argv: list[str] | None = None) -> None:
    """Run the LM CLI."""
    args = build_parser().parse_args(argv)
    shape = shapes.INPUT_SHAPES[args.shape]
    batch = args.batch or (SMOKE_BATCH if args.smoke else shape.global_batch)
    seq_len = args.seq_len or (SMOKE_SEQ_LEN if args.smoke
                               else shape.seq_len)
    model = build_model(args.arch, args.smoke, args.shape, args.seed,
                        args.device)
    print(f"[lm] arch={model.cfg.name} layers={model.cfg.n_layers} "
          f"shape={shape.name} batch={batch} "
          f"(of {shape.global_batch}) seq_len={seq_len} (of "
          f"{shape.seq_len}) params={model.param_count()} "
          f"device={model.device}")
    def run():
        if shape.mode == "prefill":
            return run_prefill(model, batch, seq_len, seed=args.seed + 1)
        return run_decode(model, batch, seq_len, args.decode_steps,
                          seed=args.seed + 2)

    run()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if model.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            out = run()
        report_profile(prof, out["seconds"])


if __name__ == "__main__":
    main()
