#!/usr/bin/env python3
"""Drive the PyTorch port of FCN3 on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   host checks of index arithmetic in numpy (``[host]`` lines: the
   attention's query tiles at zamba2-2.7b's prefill and the SSD kernel's
   grid at its 80 heads, a ragged last head tile of 8), and the ``nvcc``
   build of every kernel source (one process each, in parallel);
2. the main path: ``repro_torch.launch.serve``'s scored ensemble forecast
   (calibrated init, then members x leads against synthetic truth) with
   every kernel launch counter set to 0 just before and read just after;
   every kernel must have launched, every score must be finite; the last
   (steady) lead runs under ``torch.profiler``: the device's busy share of
   it and its kernels by device time (``[profile]`` lines); its scores and
   final members (host copies) and its parameters (a reference-format
   checkpoint) are kept for phases 2d and 5b (e);
2a. the kernel tiles on this card (``[tune]`` lines): every tunable
   family (``kernels/autotune.py``: the Legendre contraction, the band
   contraction and its transpose, CRPS, the SSD step) swept through
   ``launch/tune.py``'s ``run`` into a temporary ``TuningCache``, at
   ``model_op_shapes`` of [main]'s model (2 members) and the LM
   prefill's SSD shape, ``TUNE_CANDIDATES`` tiles each (the committed
   one among them), every variant library built first, all at once;
   each family's line gives its shapes, candidates, ``default_us``,
   ``best_us``, the winning dims and its library's ptxas registers and
   spills; every candidate is held to the plain version on the sweep's
   operands at ``REL_TOL`` (the transpose to the committed kernel; phase
   7 holds its winner to the plain output), ``best_us <= default_us``,
   and the same sweep again must sweep nothing; then [main]'s forecast
   once more through ``RequestSpec.engine_config`` with the cache
   installed (the tuned libraries), held to [main]'s states and scores
   at the dispatch bar, its seconds per lead beside [main]'s;
2b. the engine's other paths on the same model (``[engine]`` lines), with
   both forecast kernels' counts and the plain-version guard set to 0
   just before and read just after: E1 two coalesced requests
   (``forecast_batched``: other samples and seeds, one host aux callable,
   2 members, 3 leads in chunks of 2, obs perturbations, spectra, scored)
   against request 0 alone at the reference's dispatch bar, with seconds
   per lead, member-leads per second, peaks and staging counters; E2 the
   bf16 policy against fp32 from the same draws (bf16 state within 0.15,
   fp32 finite scores) and one bf16 lead's GEMM kernels and product
   dtypes (``[profile]``); E3 bred init (4 members, ensemble transform):
   pairs centered on the analysis, the transform's draws orthonormal;
2d. the WB2 evaluation CLI (``[evaluate]`` lines):
   ``repro_torch.launch.evaluate`` at ``fcn3_full`` from [main]'s
   parameters, 2 members x 2 leads x 2 initial conditions, with both
   forecast kernels' counts and the plain-version guard set to 0 just
   before and read just after: seconds per initial condition, peak,
   launches (band and Legendre > 0), no plain version on a CUDA tensor,
   every table entry finite (run after 2b, before 2c);
2c. the forecast service at ``fcn3_full`` (``[service]`` lines), the
   forecast's model freed first, with both forecast kernels' counts and
   the plain-version guard set to 0 just before and read just after: the
   geometry plans built from empty caches (``plans_build_s``); a
   warm-start bundle packed for 2 members x 2 leads (chunks of 2) at
   batch 1 and 2 with [tune]'s cache installed (its entries under
   ``tunings/``, the winners' libraries in ``blobs/``); a readonly
   replica booted from it, its tunings installed, in this process as a
   fresh one would (plan caches emptied, loaded libraries forgotten):
   no nvcc run, the libraries loaded from the bundle; behind the port's
   HTTP service, R1 alone and then R2 with R3 (other samples and seeds)
   coalesced into one batch of 2, through the port's client; R1 equal
   to a direct engine on the replica's model bitwise, R2/R3 to their
   serial runs at the dispatch bar; ``/v1/stats`` (one batch of 2, a
   readonly cache with no miss, the bundle block) and ``/metrics``;
   every request's ``compile_s`` 0.0; per-request times, member-leads
   per second alone and coalesced, and ``estimated_bytes`` against the
   measured peak;
3. a small-input check: one ``fcn3_smoke`` step on the card through the
   kernels against the port's reference (FFT/einsum) path;
4. training: ``repro_torch.launch.train``'s path at ``fcn3_full`` (stage
   ``pretrain_stage2``, 2 members, batch 1, rollout 1, 2 steps, 1
   calibration round), with every launch counter set to 0 just before
   and read just after; every kernel entry point (band contraction and
   its transpose, Legendre, CRPS forward and backward) must have
   launched, loss and gradient norm must be finite, the parameters must
   have changed, and no plain version (``kernels/*/ref.py``) may have
   been called on a CUDA tensor;
5. a small-input gradient check: one ``fcn3_smoke`` train step's
   gradients through the kernels against the reference path's;
5b. distribution (``[dist]`` lines), every rank a process on the card
   over gloo (NCCL refuses two ranks on one device): (a) the selftest
   (``repro_torch.distributed.selftest --device cuda``, 8 ranks), each
   rank launching the Legendre, band and CRPS kernels; (b) Algorithms 1
   and 2 at the ``fcn3_full`` latent, ``DIST_CHANNELS`` of its 641
   channels, over lat 2 x lon 2 ranks, against the single-process
   kernel path (1e-4 of max |plain|), and each rank's band kernel on its
   masked band against the plain version; per rank the seconds,
   collective seconds, launches (> 0), plain calls on CUDA tensors (0)
   and peak; (c) ``launch/train.py --mesh-model 2`` at ``fcn3_full``,
   one member per rank, from the training phase's initial parameters
   (a checkpoint) and its first step's draws, one step
   (``DIST_TRAIN_STEPS``): the loss within
   ``DIST_LOSS_RTOL``, the gradients within the gradient bar, the
   parameters bitwise equal on both ranks after the step; per rank the
   step's seconds, its share in collectives, the CRPS launches (> 0) and
   the peak; (d) the domain-decomposed step (``--fcn3-sharding
   domain``, latitude over the model axis): (d1) ``launch/train.py
   --mesh-model 2`` at ``fcn3_full`` on the training cell's settings and
   initial parameters, both members on each rank's 360 / 361 IO rows,
   one step held to the first step as (c) is; per rank the step's
   seconds, its
   share in collectives, its halo bytes, its peak and the launches of
   the band forward, transpose, Legendre and CRPS kernels (> 0, no
   plain version on a CUDA tensor); (d2) one ``fcn3_small`` forward over
   4 ranks (181 rows: 45 / 45 / 45 / 46) gathered against the single
   process at the dispatch bar; (d3) the band kernel on rank 0's
   row-sliced encoder, latent and decoder bands and its transpose on
   the latent and decoder ones (the encoders' inputs take no gradient)
   at the largest planes (d1) launched them with, through the checks of
   phase 7 (times, bounds, the ``F.conv1d`` / ``F.conv_transpose1d``
   yardsticks, the plain version), the CRPS kernels at the points of
   rank 0's loss terms and of its eval step, and the Legendre kernel on
   rank 0's padded tables (the latent SHT's and the spectral loss's at
   the IO grid) at the pencils (d1) gave it; (d4) in (d1)'s ranks after
   their steps, ``eval_step`` (2 members) on each rank's rows at the
   initial parameters, against the training phase's single-process eval
   step on the same batch and draws (``EVAL_RTOL``), with its launches;
   (e) the engine's ``member_axes``: [main]'s scored forecast (its
   parameters, sample, noise seed, 3 leads) over 2 ranks, one member
   each (the +/- pair straddles), each lead's scores against [main]'s
   and each rank's final member against [main]'s at the dispatch bar,
   with per rank the seconds a lead, the share in collectives, the score
   all-to-all's bytes, the peak and the launches (the CRPS forward on
   both ranks), then the CRPS kernel against its plain version at rank
   0's operand shape; (f) channel parallelism: ``launch/train.py
   --fcn3-sharding channel --mesh-model 2`` at ``fcn3_full``'s widths
   cut to ``CHANNEL_BLOCKS`` blocks, from the training phase's initial
   parameters and first step's draws, one step against one process's
   first step of the same model on the card (loss ``DIST_LOSS_RTOL``,
   the gathered gradients at the gradient bar, the split leaves' updated
   blocks equal to the slices of one process's updated leaves wherever
   its gradient exceeds the bar's atol), per rank the step's seconds,
   its share in collectives, its bytes by kind, launches and peak; then
   in the same world one ``fcn3_smoke`` channel step (every block's
   conv, spectral filter and MLP split) against one process on the
   card; (g) the expert placement: the smoke MoE LMs of
   ``tests/test_torch_moe.py``, both dispatches, on a (data 2, model 2)
   world of 4 ranks, the experts over the model axis against whole
   experts in the same world and one process on each data slice, with
   the all-gather's bytes and the kept pairs per rank; then at full
   width one MoE layer of ``deepseek-v2-236b`` (160 experts at d_model
   5120, the dense dispatch) on 2 ranks, whole on each rank in turn,
   then 80 experts a rank placed over the model axis, outputs and aux
   at ``EXPERT_RTOL``, the input, router, shared and block gradients at
   the gradient bar.  A world's start costs 15-35 s of host time, so the
   later parts ride earlier worlds of the same size as follow-ons
   (``run_world_then``): (g) and (d2) in (b)'s world after its checks;
   (f), (g) at full width, (d1) with (d4) and (e) in (c)'s, each after
   the previous part's state is freed.
   The plans reach the ranks through ``export_plan`` / ``install_plan``
   payloads, installed once a process, not built again;
[examples] ``examples/quickstart_torch.py`` and
   ``examples/storm_case_study_torch.py`` on the card, each to its last
   line (the storm case through the engine's ``diagnostics`` callback),
   with every launch counter and the plain-version guard read just
   before and just after: every FCN3 kernel launched, no plain version;
6. the LM path: ``repro_torch.launch.lm`` at the full width of
   ``mamba2-130m`` (24 layers, d_model 768, vocab 50432, d_state 128,
   random weights): one prefill at ``prefill_32k`` with its batch cut
   32 -> 2 (both SSD launch counts set to 0 just before and read just
   after: exactly 24 of each kernel, one per layer; logits finite), a
   second prefill
   for the steady time, 32 decode steps at ``decode_32k``'s batch of
   128 from an empty cache, and the prefill's logits for 256 tokens of
   2 sequences against 256 recurrent decode steps (``LM_CONSIST_TOL``);
   no plain version may run on a CUDA tensor;
6a. LM training (``[lm-train]`` lines): (a) ``mamba2-130m`` at its
   published widths trains for ``LM_TRAIN_STEPS`` Adam steps on one
   batch of ``LM_TRAIN_BATCH`` x 4096 (``train_4k``'s sequence, its
   batch of 256 cut) with remat, through ``train/lm.py``, every launch
   counter set to 0 before each step and read after it: 48 launches of
   each SSD forward kernel (remat runs each twice) and 24 of each
   backward kernel a step, the loss finite and falling, no plain version
   on a CUDA tensor; per step its seconds and tokens/s, the peak; the
   same step dry-run (calls = launches, the live-set peak within
   ``DRYRUN_PEAK_BAND``); (b) both SSD backward kernels against autograd
   of their plain versions in float64 at the gradient bar, at
   ``SSD_BWD_CHECKS`` (a second run bitwise the same, every gradient
   finite), timed beside the plain version, their bounds and their first
   design's time (``SSD_BWD_FIRST_MS``: the intra-chunk backward at most
   2 kernel launches a call, counted in a CUDA graph of one, faster than
   its first design everywhere and at most half of it at (a)'s shape); (c) one
   loss and backward of each family's smoke config on the card against
   the CPU (``LM_TRAIN_LOSS_RTOL``, the gradient bar); the model and
   optimizer freed before 6b;
6b. the attention LMs (``[lm-hybrid]`` lines), with the plain-version
   guard set to 0 just before and read just after: ``zamba2-2.7b`` at
   its published widths (54 Mamba-2 layers, 9 units closed by the shared
   attention block, random weights): one prefill at ``prefill_32k`` with
   its batch cut 32 -> 1 (both SSD launch counts set to 0 just before and
   read just after: exactly 54 of each; logits finite), a second for the
   steady time, a third under ``torch.profiler`` (busy share, kernels by
   device time, device time by kind of kernel) and one unit's attention
   timed alone, 32 decode steps at ``decode_32k`` with its batch cut 128
   -> 4, twice, 4 more under ``torch.profiler`` (busy share, device time
   by kind of kernel), and prefill against recurrent decode over 2 x 256
   tokens (``LM_CONSIST_TOL``); then, each at its published widths
   (``ATTN_FAMILY_CHECKS``), ``mistral-nemo-12b`` cut to 2 of its 40
   layers (G = 4 query heads a KV head), ``whisper-small`` (the encoder
   and cross-attention) and ``llava-next-34b`` cut to 2 of its 60 layers
   (patches put before the tokens): a prefill at batch 1 and prefill
   against decode over 2 x 128 tokens; then the ``mamba2-130m`` and
   ``zamba2-2.7b`` smoke widths with the SSD kernel against the
   reference scan, and both SSD kernels against their
   plain versions on the operands of the hybrid prefill's first layer
   (path ``lm_hybrid`` in the kernels JSON);
6c. the MoE LMs (``[lm-moe]`` lines), with every launch counter and the
   plain-version guard read just before and just after: each of
   ``MOE_CHECKS`` at its published widths, cut in depth only --
   ``deepseek-v2-236b`` (3 of its 60 layers: the dense one and 2 MoE;
   MLA, 160 experts top-6, 2 shared) and ``llama4-maverick-400b-a17b``
   (2 of its 48: one unit of a dense and a MoE layer; 128 experts top-1,
   1 shared; 74.7 GB of parameters, drawn in place) -- through
   ``launch/lm.py``: a prefill at batch 1 (4096 and 2048 tokens) whose
   dense dispatch is held on the card to its invariants (each kept pair
   in exactly one slot, no slot with two pairs, the kept pairs those the
   host recounts from ``gate_idx``), a steady prefill with its share of
   dropped (token, k) pairs at capacity_factor 1.25, decode at 4 x
   32768 twice, and prefill vs decode over 2 x 128 tokens at the
   capacity where nothing drops (``LM_CONSIST_TOL``); per model the host
   seconds of each part and the peak; the MoE path launches no kernel of
   the port (its products are einsums) and no plain version;
7. every kernel against its plain torch version, on the card: the
   Legendre kernel at each table the forecast used (its largest batch),
   the band contraction timed at every distinct (psi, stride, batch) the
   forecast launched it with and held to its plain version at the
   largest batch of each geometry, the transpose (with its launches per
   shape, which must add up to the training phase's count) and CRPS
   kernels at each distinct shape training launched them with, the
   transpose once more at stride 3 on a small synthetic band (no fcn3
   geometry has that stride: its generic path), the SSD kernel on the
   operands of the prefill's first layer and the inter-chunk recurrence
   kernel on that layer's states; timings (CUDA
   events, median), the ``library_ms`` yardstick at every band shape
   (``conv_transpose1d`` takes seconds a call: one timed call, at each
   band's widest training shape only, the latent's 295 planes and the
   decoder's 56: the narrower ones and (d3)'s row slices repeat the same
   work)
   and the least time the card could take, in fp32 (``bound_ms``) and
   on the TF32 tensor cores in 3xTF32 (``bound_tc_ms``);
[dryrun] the dry run (``repro_torch.launch.dryrun``: one step on fake
   tensors, every kernel call and collective counted, no launch) held to
   the card where its inputs still live, each dry run with no kernel
   launch and no plain version inside it: (ii) right after [main], one
   forward of ``MEMBERS`` members at ``fcn3_full`` against one forward of
   [main]'s model (CUDA events, median of 3; launches and
   ``max_memory_allocated`` over one call); (i) after the training phase,
   the training cell's step against the steady step's launches (the
   counters read before and after it, not reset) and the phase's peak;
   each family's calls must equal its launches and the live-set peak lie
   within ``DRYRUN_PEAK_BAND`` of ``max_memory_allocated``, with the
   roofline terms, the bound and bound / measured printed; (iii) after
   [dist], (d1)'s step as rank 0 of a fake 1 x 2 mesh, whose
   ``all_to_all_v`` bytes must equal (d1) rank 0's ``timed_bytes`` in
   every step (the other kinds printed beside (d1)'s); then the CLI's
   ``--arch fcn3 --shape train`` (rank 0 of 16 x 16, domain) with
   ``--out``: collective bytes > 0, finite terms; (iv) after (f), its
   step as rank 0 of a fake 1 x 2 mesh, held to (f) rank 0's launches
   and peak as (i) is, its all-reduce and all-gather bytes equal to
   (f)'s.  Phase 7's rows at a shape (i) or (ii) counted must carry the
   same FLOPs and bytes a call;
8. the ``kernels`` JSON line (each entry with [tune]'s ``tuned_dims``,
   ``tuned_ms`` and ``default_ms`` at ``tuned_at``, null for the
   recurrence and the backwards, whose tiles are not tuned; the SSD
   backwards with [lm-train]'s (b) rows), then the result line.

Exits non-zero without CUDA, and in a directory without the repository.
"""

from __future__ import annotations

import atexit
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: kernel vs plain: max |kernel - plain| <= REL_TOL * max |plain|
#: (fp32 sums of up to S*D = 3.3k terms in another order)
REL_TOL = 1e-4
#: the main path: fcn3_full at its published widths, 2 members x 3 leads
#: (the third one profiled), after the serve CLI's 4 LSUV calibration
#: rounds (the bf16 bar below is the reference test's, on a model
#: calibrated with 4 rounds)
CONFIG, MEMBERS, LEAD_STEPS = "full", 2, 3
CALIBRATION_ROUNDS = 4
#: the engine phase at fcn3_full, on phase 2's model: E1 two coalesced
#: requests (2 members each, 3 leads in chunks of 2, obs perturbations of
#: amplitude 0.05, spectra) against request 0 alone; E2 the bf16 policy
#: against fp32 (2 members, 3 leads); E3 bred init (4 members, ensemble
#: transform) and one lead
ENGINE_MEMBERS, ENGINE_LEADS, ENGINE_SAMPLES = 2, 3, (123, 321)
#: batched vs serial: the reference's dispatch bar
#: (tests/test_kernel_dispatch.py:289); the rank frequencies of nearly tied
#: members are held to the state bar, as in tests/test_torch_fcn3.py
STATE_RTOL, STATE_ATOL, SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5, 1e-4, 1e-6
#: bf16 vs fp32 final state (tests/test_inference_engine.py:142-160)
BF16_BAR = 0.15
#: bred pairs' mean vs state0, relative to max |state0|; the ensemble
#: transform's output Gram matrix vs the identity
PAIR_TOL, ORTHO_TOL = 1e-6, 1e-4
#: the service phase at fcn3_full: a bundle for this request shape (the
#: serial and the batch-2 keys), R1 (sample 0, seed 7) alone, then R2 and
#: R3 (other samples and seeds) together, coalesced within the window
SERVICE_SPEC = {"members": 2, "lead_steps": 2, "lead_chunk": 2,
                "return_state": True}
SERVICE_REQUESTS = ((0, 7), (123, 11), (321, 13))
SERVICE_WINDOW_MS, SERVICE_TIMEOUT_S = 5000.0, 600.0
#: the training path: fcn3_full, all 10 blocks, Table 3's second stage
#: with its own ensemble of 2; batch 32 -> 1, rollout 4 -> 1 and
#: calibration rounds 4 -> 1 are the cuts
TRAIN_STAGE, TRAIN_ENSEMBLE, TRAIN_BATCH, TRAIN_ROLLOUT = (
    "pretrain_stage2", 2, 1, 1)
TRAIN_CALIBRATION_ROUNDS = 1
TRAIN_STEPS = 2
#: gradient bar of tests/test_kernel_dispatch.py's grad-parity test
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
#: the distributed phase, every rank a process on the one card over gloo
#: (NCCL refuses two ranks on one device): (a) the selftest's world of 8;
#: (b) Algorithms 1 and 2 at the fcn3_full latent (360x720 Gauss, the
#: global block's lmax = mmax = 360, the latent DISCO plan) over (lat 2,
#: lon 2) = 4 ranks on 82 channels, a multiple of both axes: the
#: channels are independent planes, and the latent's 641 (padded to 644)
#: took 45.6 s of the script's time, its reference paths and plain
#: versions growing with them (cut to 164, then to 82 for the script's
#: time; PERF.md)
DIST_BACKEND, DIST_GRID, DIST_CHANNELS = "gloo", (2, 2), 82
#: (c) and (d1) take 1 step each, the one held to the training phase's
#: first step; a second, steady step (12-14 s a rank in (c), 27-28 s in
#: (d1), on one H100 80GB HBM3 at 700 W) checked nothing the first does
#: not (cut for the script's time; PERF.md)
DIST_TRAIN_RANKS, DIST_TRAIN_STEPS = 2, 1
#: (d3)'s transposes on rank 0's rows are timed at their shape, but held
#: to the plain version on their first DIST_PLAIN_PLANES planes only (the
#: planes are independent): the whole plain version took 33 s there and
#: repeats the whole band's, timed in phase 7
DIST_PLAIN_PLANES = 8
#: the single-process loss vs the distributed one
DIST_LOSS_RTOL = 1e-5
#: (d2) the domain step's forward at fcn3_small over 4 ranks (ragged IO
#: rows 45/45/45/46 and latent rows 22/23/22/23), 2 samples
DIST_SMALL_CONFIG, DIST_SMALL_RANKS = "small", 4
#: (d4) the domain eval step in (d1)'s ranks at the initial parameters, 2
#: members, its noise drawn from this seed; the training phase's single
#: process runs the same eval on the same batch
DOMAIN_EVAL_MEMBERS, DOMAIN_EVAL_SEED = 2, 2024
#: the domain eval against the single process (tests/test_torch_train.py)
EVAL_RTOL = 1e-4
#: (e) the engine's member_axes: [main]'s scored forecast (its parameters,
#: sample, noise seed, 2 members, 3 leads) over 2 ranks, one member each
#: (the +/- pair straddles the ranks)
DIST_ENGINE_RANKS = 2
#: (f) channel parallelism (``launch/train.py --fcn3-sharding channel``)
#: over 2 ranks of the card at fcn3_full's widths, from the training
#: phase's initial parameters and first step's batch and draws, held to
#: one process's first step of the same model on the card.  Its depth is
#: cut to CHANNEL_BLOCKS of the 10 blocks (block 0 global, block 1
#: local): a channel rank holds every member on the whole fields, as one
#: process does (the training phase's single process peaks at 48.76 GB,
#: PERF.md), and two such ranks do not fit the card's 80 GB side by side
#: (PERF.md).  At fcn3_full the 641 latent channels (a prime) keep every
#: conv and spectral weight whole, so the same world then takes one
#: fcn3_smoke channel step (its 34 channels split the global block's
#: spectral filter, the local block's DISCO conv and both MLPs; a
#: Legendre launch on a rank's block of channels), held to one process
#: on the card; its noise drawn from CHANNEL_SMALL_SEED
CHANNEL_RANKS, CHANNEL_BLOCKS, CHANNEL_SMALL_SEED = 2, 2, 11
#: (g) the expert placement: the smoke widths of tests/test_torch_moe.py's
#: MoE LMs, each with the dense and the scatter dispatch, on 4 ranks of the
#: card (data 2 x model 2: the experts over the model axis, a rank's slice
#: of EXPERT_TOKENS' batch over the data axis), against whole experts in
#: the same world and one process with whole experts on each data slice
EXPERT_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
EXPERT_MESH, EXPERT_TOKENS = (2, 2), (4, 64)
#: the placed experts against whole ones: outputs and aux relative
EXPERT_RTOL = 1e-5
#: (g) at full width, in (c)'s world of 2 ranks after (f): one MoE layer
#: of this arch (its 160 experts at d_model 5120; depth 60 -> 1 layer) on
#: EXPERT_FULL_TOKENS tokens, its experts whole on each rank in turn, then
#: placed over the 2 model ranks (80 a rank), the dense dispatch (a
#: world of one data rank has no scatter)
EXPERT_FULL_ARCH, EXPERT_FULL_TOKENS = "deepseek-v2-236b", 1024
#: phase 2d: launch/evaluate.py at fcn3_full from [main]'s parameters
EVAL_MEMBERS, EVAL_LEADS, EVAL_ICS = 2, 2, 2
#: two values closer than this, relative, are counted as a near-tie
#: (8 units in the last place of fp32)
TIE_REL = 8 * 2.0 ** -23
#: CRPS kernel vs plain: relative error (a handful of fp32 terms)
CRPS_REL_TOL = 1e-5
#: [dryrun]: a dry run's live-set peak against the card's
#: max_memory_allocated over the same work: within these factors
DRYRUN_PEAK_BAND = (0.5, 2.0)
#: [tune]: every tunable kernel family swept at fcn3_full's
#: model_op_shapes (2 members) and the LM prefill's SSD shape, at most
#: this many tiles each (the committed one among them; all libraries
#: built in parallel), each tile's time the median of TUNE_ITERS calls
#: after one warm-up
TUNE_CANDIDATES, TUNE_ITERS = 4, 5
#: the family each kernel of the kernels line launches with its tile
TUNE_FAMILY = {"legendre_contract": "legendre",
               "disco_band_contract": "disco",
               "disco_band_transpose": "disco_bwd", "crps_fused": "crps",
               "ssd_intra_chunk": "ssd"}
#: the LM path: mamba2-130m at its published widths; prefill_32k with its
#: global batch cut 32 -> 2 (logits 2 x 32768 x 50432 fp32 = 13.2 GB);
#: decode_32k's batch of 128 for 32 steps from an empty cache
LM_ARCH, LM_PREFILL_BATCH, LM_DECODE_STEPS = "mamba2-130m", 2, 32
#: prefill (two chunks of 128, through the kernel) vs the recurrence, 256
#: tokens of 2 sequences: max |diff| <= LM_CONSIST_TOL * max |logits|.
#: Both paths are fp32 but sum in other orders: the chunked path takes
#: exp(cs_l - cs_s) of cumsums that reach hundreds within a chunk (an
#: absolute error of ~300 * 6e-8 = 2e-5 in the exponent), the recurrence
#: multiplies 128 per-step decays; ~1e-5 relative per layer, through 24
#: residual layers, with a margin of ~10x
LM_CONSIST_TOKENS, LM_CONSIST_TOL = 256, 1e-3
#: the hybrid LM path: zamba2-2.7b at its published widths (54 Mamba-2
#: layers of 80 SSD heads, 9 units each closed by the one shared
#: attention block, d_model 2560, vocab 32000); prefill_32k with its
#: batch cut 32 -> 1 (logits 1 x 32768 x 32000 fp32 = 4.2 GB), decode_32k
#: with its batch cut 128 -> 4 (KV caches 24.5 GB; 785 GB at 128) for
#: LM_DECODE_STEPS steps; prefill vs recurrence over 2 x 256 tokens (two
#: chunks of 128) at LM_CONSIST_TOL
HYBRID_ARCH, HYBRID_PREFILL_BATCH, HYBRID_DECODE_BATCH = "zamba2-2.7b", 1, 4
#: decode steps of the hybrid under torch.profiler
HYBRID_PROFILED_STEPS = 4
#: the other attention families, each at its published widths: (arch,
#: decoder layers kept (None: all), prefill length at batch 1, tokens of
#: the prefill vs decode check over 2 sequences at LM_CONSIST_TOL).
#: mistral-nemo-12b cut to 2 of its 40 layers (the script's time, not
#: memory, forces the cut: the times are a 2-layer slice's): dense GQA
#: with G = 4 (32 query heads over 8 KV heads of 128, rope theta 1e6,
#: vocab 131072), a prefill at 1 x 4096.  whisper-small, all 12 encoder and 12 decoder
#: layers: the audio path (the non-causal encoder over 1500 frames,
#: cross-attention in the prefill and, through ``enc_states``, in every
#: decode step), prefill_32k's sequence at batch 1.  llava-next-34b cut
#: to 2 of its 60 layers (the 60 are 137 GB fp32, more than the card
#: holds): the VLM path, its 2880 patches put before 29,888 tokens at
#: prefill_32k's sequence, batch 1, G = 7; decode takes no patches, so
#: its prefill vs decode runs on text alone
ATTN_FAMILY_CHECKS = (("mistral-nemo-12b", 2, 4096, 128),
                      ("whisper-small", None, 32768, 128),
                      ("llava-next-34b", 2, 32768, 128))

#: [lm-train]: mamba2-130m at its published widths (24 layers, d_model 768,
#: 24 SSD heads, d_state 128, chunk 128) trains on train_4k's sequence of
#: 4096 tokens with its global batch cut 256 -> 8 (one card and the
#: script's time), LM_TRAIN_STEPS Adam steps with remat on one batch (the
#: loss must fall)
LM_TRAIN_BATCH, LM_TRAIN_STEPS, LM_TRAIN_LR = 8, 2, 1e-4
#: (b) both SSD backward kernels against autograd of their plain versions:
#: (tag, the intra-chunk step's (BC, L, H, P, G, N), the recurrence's (B,
#: nc, H, P, N), dA scale): (a)'s shape (8 sequences of 32 chunks), the
#: prefill's (PERF.md's SSD row), zamba2-2.7b's 80 heads a group (past the
#: forward's head tile of 24) and chunks whose |dA| sums pass 88
SSD_BWD_CHECKS = (
    ("train", (256, 128, 24, 64, 1, 128), (8, 32, 24, 64, 128), 0.1),
    ("prefill", (512, 128, 24, 64, 1, 128), (2, 256, 24, 64, 128), 0.1),
    ("zamba2-80-heads", (256, 128, 80, 64, 1, 64), (2, 128, 80, 64, 64),
     0.1),
    ("large-decay", (8, 128, 24, 64, 1, 128), (8, 4, 24, 64, 128), 2.0))
#: the backward kernels' first design (fp32 on the CUDA cores; the
#: intra-chunk step's in four launches with a (BC, H, L, L) scratch), ms
#: at SSD_BWD_CHECKS on one H100 80GB HBM3 at 700 W (PERF.md): each row
#: prints it beside its time, and the redesigned intra-chunk backward must
#: beat it at every check and take at most half of it at "train"
SSD_BWD_FIRST_MS = {
    "ssd_intra_chunk_bwd": {"train": 5.431, "prefill": 10.508,
                            "zamba2-80-heads": 15.996, "large-decay": 1.306},
    "ssd_chunk_recurrence_bwd": {"train": 0.330, "prefill": 0.628,
                                 "zamba2-80-heads": 0.507,
                                 "large-decay": 0.104}}
#: (c) one loss and backward of each family's smoke config, on the card
#: against the same model on the CPU: the loss at LM_TRAIN_LOSS_RTOL, the
#: gradients at the gradient bar
LM_FAMILY_ARCHS = ("mamba2-130m", "zamba2-2.7b", "mistral-nemo-12b",
                   "llava-next-34b", "whisper-small", "deepseek-v2-236b")
LM_TRAIN_LOSS_RTOL = 1e-4

#: [lm-moe]: the two MoE architectures at their published widths, each
#: cut in depth only: (arch, layers kept, prefill length at batch 1).
#: deepseek-v2-236b keeps its one dense layer and 2 of its 59 MoE layers
#: (9.33e9 parameters, 37.3 GB fp32); its prefill is 1 x 4096, not
#: prefill_32k's 32768: the dense dispatch's (T, E, C) tensors grow with
#: T^2 (C = 1536 and 32 GB each at 32768; C = 192 and 0.50 GB at 4096).
#: llama4-maverick-400b-a17b keeps one unit of its 24, a dense layer then
#: a MoE layer (18.68e9 parameters, 74.7 GB fp32 of the card's 85 GB);
#: its prefill is 1 x 2048 (logits 1.66 GB)
MOE_CHECKS = (("deepseek-v2-236b", 3, 4096),
              ("llama4-maverick-400b-a17b", 2, 2048))
#: decode_32k's batch cut 128 -> 4 against its 32768 cache slots, for
#: LM_DECODE_STEPS steps; prefill vs decode over 2 x MOE_CONSIST_TOKENS
#: tokens at LM_CONSIST_TOL, at capacity_factor n_experts / top_k (C >=
#: T on both paths: no pair drops; at 1.25 the decode's C = 1 drops pairs
#: the prefill keeps, by design, in the JAX package too)
MOE_DECODE_BATCH, MOE_CONSIST_TOKENS = 4, 128


def log(msg: str) -> None:
    """Print one line and flush it (the output is read as it arrives)."""
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Recorder:
    """Wraps the kernel wrappers' module attributes to note the operands
    of every call (the wrappers still count the launches): the Legendre
    kernel at its largest batch per table, the band contraction, its
    transpose and the CRPS kernels at every distinct shape (the band
    contraction and its transpose with their launches per shape), the SSD
    kernel at its first call.  Tables and filters are told apart by shape
    (and the table's strides), never by address: the bf16 policy hands
    the kernels a fresh widened copy at every call, and only the first
    operands of each key are kept."""

    def __init__(self):
        from repro_torch.kernels.crps import ops as crps_ops
        from repro_torch.kernels.disco import ops as disco_ops
        from repro_torch.kernels.legendre import ops as legendre_ops
        from repro_torch.kernels.ssd import ops as ssd_ops
        self.disco: dict = {}
        self.legendre: dict = {}
        self.transpose: dict = {}
        self.crps: dict = {}
        self.ssd: tuple | None = None
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (disco_ops, "disco_band_contract"),
            (disco_ops, "disco_band_transpose"),
            (legendre_ops, "legendre_contract"),
            (crps_ops, "crps_fused"), (crps_ops, "crps_fused_bwd"),
            (ssd_ops, "ssd_intra_chunk"))]
        orig = {name: fn for _, name, fn in self._saved}

        def disco(x, psi_band, lat_idx, taps, stride=1, blocks=None):
            key = (tuple(psi_band.shape), stride, tuple(x.shape))
            ent = self.disco.setdefault(key, {
                "psi": psi_band, "lat_idx": lat_idx, "taps": taps,
                "stride": stride, "shape": tuple(x.shape), "launches": 0})
            ent["launches"] += 1
            return orig["disco_band_contract"](x, psi_band, lat_idx, taps,
                                               stride, blocks)

        def transpose(g, psi_band, lat_idx, taps, rows, h_in, stride=1,
                      blocks=None):
            key = (tuple(psi_band.shape), stride, tuple(g.shape))
            ent = self.transpose.setdefault(key, {
                "psi": psi_band, "lat_idx": lat_idx, "taps": taps,
                "rows": rows, "h_in": h_in, "stride": stride,
                "shape": tuple(g.shape), "launches": 0})
            ent["launches"] += 1
            return orig["disco_band_transpose"](g, psi_band, lat_idx, taps,
                                                rows, h_in, stride, blocks)

        def legendre(x, table, extents, blocks=None):
            key = (tuple(table.shape), table.stride())
            ent = self.legendre.setdefault(key, {"table": table, "b": 0,
                                                 "extents": extents,
                                                 "shape": None,
                                                 "dtype": x.dtype})
            if x.shape[0] > ent["b"]:
                ent["b"], ent["shape"] = x.shape[0], tuple(x.shape)
            return orig["legendre_contract"](x, table, extents, blocks)

        def crps(ens, obs, fair=False, blocks=None):
            self.crps.setdefault((tuple(ens.shape), fair),
                                 {"shape": tuple(ens.shape), "fair": fair})
            return orig["crps_fused"](ens, obs, fair, blocks)

        def crps_bwd(g, ens, obs, fair=False, blocks=None):
            self.crps.setdefault((tuple(ens.shape), fair),
                                 {"shape": tuple(ens.shape), "fair": fair})
            return orig["crps_fused_bwd"](g, ens, obs, fair, blocks)

        def ssd(x, da_cs, b_mat, c_mat, blocks=None):
            if self.ssd is None:   # the operands of the first call
                self.ssd = (x, da_cs, b_mat, c_mat)
            return orig["ssd_intra_chunk"](x, da_cs, b_mat, c_mat, blocks)

        wrappers = {"disco_band_contract": disco,
                    "disco_band_transpose": transpose,
                    "legendre_contract": legendre, "crps_fused": crps,
                    "crps_fused_bwd": crps_bwd, "ssd_intra_chunk": ssd}
        for mod, name, _ in self._saved:
            setattr(mod, name, wrappers[name])

    def close(self) -> None:
        """Put the original wrappers back."""
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class PlainGuard:
    """Counts calls of every plain version (the functions defined in
    ``repro_torch/kernels/*/ref.py``) that get a CUDA tensor, wherever
    they were imported to."""

    def __init__(self):
        import importlib
        import pkgutil
        import repro_torch
        for info in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."):
            importlib.import_module(info.name)
        self.counts: dict[str, int] = {}
        refs = {}
        for mod in ("legendre", "disco", "crps", "ssd"):
            ref = importlib.import_module(f"repro_torch.kernels.{mod}.ref")
            for name, fn in vars(ref).items():
                if (name.endswith("_ref") and callable(fn)
                        and getattr(fn, "__module__", "") == ref.__name__):
                    refs[id(fn)] = self._counting(f"{mod}.{name}", fn)
        self._saved = []
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith("repro_torch"):
                continue
            for name, val in list(vars(mod).items()):
                if id(val) in refs:
                    self._saved.append((mod, name, val))
                    setattr(mod, name, refs[id(val)])

    def _counting(self, label: str, fn):
        import torch
        self.counts[label] = 0

        def wrapped(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                self.counts[label] += 1
            return fn(*args, **kwargs)
        return wrapped

    def close(self) -> None:
        """Put the plain versions back."""
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def errors(got, ref) -> tuple[float, float]:
    """Max abs error and that error relative to max |ref|."""
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def check_legendre(table, extents, shape, dtype, name) -> dict:
    """Legendre kernel vs its plain version at one main-path shape."""
    import torch
    from repro_torch.kernels.legendre import ops
    from repro_torch.kernels.legendre.ref import legendre_contract_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    got = ops.legendre_contract(x, table, extents)
    torch.cuda.synchronize()
    ref = legendre_contract_ref(x, table)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(got, ref)
    del got, ref
    b, k, m = shape
    n = table.shape[1]
    parts = 2 if x.is_complex() else 1     # real and imaginary rows
    ms = cuda_ms(lambda: ops.legendre_contract(x, table, extents), reps=10)
    plain_ms = cuda_ms(lambda: legendre_contract_ref(x, table), reps=5)
    # yardstick: torch.bmm on m-major operands, permuted beforehand
    xr = torch.view_as_real(x) if parts == 2 else x[..., None]
    xm = xr.permute(2, 0, 3, 1).reshape(m, parts * b, k)
    tm = table.permute(2, 0, 1).contiguous()
    lib_ms = cuda_ms(lambda: torch.bmm(xm, tm), reps=10)
    del xm, tm
    # the tables are zero for m > l: count the products the data needs
    w = ops.work(shape, n, x.is_complex(), int((table != 0).sum()),
                 extents.numel())
    flops, flops_dense, nbytes = w["flops"], w["flops_dense"], w["bytes"]
    row = dict(shape=f"x{shape} {str(dtype).split('.')[-1]} "
               f"table{tuple(table.shape)}", what=name,
               call=("legendre_contract", ops.call_key(x, table)),
               max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, flops=flops,
               flops_dense=flops_dense, bytes=nbytes, **bound(flops, nbytes))
    log(f"[kernel] legendre {name} {row['shape']}: abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bmm_ms={lib_ms:.3f} bound_ms={row['bound_ms']:.3f} "
        f"bound_tc_ms={row['bound_tc_ms']:.3f} "
        f"tflops={flops / ms / 1e9:.2f} dense_tflops={flops_dense / ms / 1e9:.2f}")
    if not rel_err <= REL_TOL:
        raise AssertionError(f"legendre {name}: kernel disagrees with its "
                             f"plain version (rel {rel_err:.3e})")
    return row


def check_disco(ent, name, full: bool, library: bool = True) -> dict:
    """Banded DISCO kernel at one main-path shape: its time and, with
    ``library``, the ``conv1d`` yardstick's, and with ``full`` (the
    largest batch of each geometry) the plain version's and the kernel
    against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.disco import ops
    from repro_torch.kernels.disco.ref import disco_gather_band_contract_ref
    psi, lat_idx, taps, stride, shape = (ent["psi"], ent["lat_idx"],
                                         ent["taps"], ent["stride"],
                                         ent["shape"])
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(shape, generator=g, device="cuda")
    b, h_in, w_in = shape
    k, h_out, s, d = psi.shape
    w_out = w_in // stride

    def kernel():
        return ops.disco_band_contract(x, psi, lat_idx, taps, stride)

    ms = cuda_ms(kernel, reps=5)
    abs_err = rel_err = plain_ms = lib_err = lib_ms = xp = None
    if library:
        # yardstick: one grouped conv1d over the rolled, gathered,
        # wrap-padded rows computes the same band correlation (cuDNN,
        # TF32 off)
        xr = torch.roll(x, d // 2, dims=-1)
        xg = xr.index_select(-2, lat_idx.reshape(-1).long()).reshape(
            b, h_out, s, w_in)
        del xr
        xp = torch.cat([xg, xg[..., :d - 1]], dim=-1).reshape(
            b, h_out * s, -1)
        del xg
        wt = psi.permute(1, 0, 2, 3).reshape(h_out * k, s, d).contiguous()

        def lib():
            return F.conv1d(xp, wt, stride=stride, groups=h_out)
        lib_ms = cuda_ms(lib, reps=3)
    if full:
        # the plain version: one timed call (seconds at these shapes),
        # whose output the kernel is held to, at the largest batch of each
        # geometry only (the narrower batches repeat its work)
        refs = []
        plain_ms = cuda_ms(lambda: refs.append(
            disco_gather_band_contract_ref(x, psi, lat_idx, stride)),
            reps=1, warmup=0)
        ref = refs.pop()
        got = kernel()
        abs_err, rel_err = errors(got, ref)
        deterministic = torch.equal(got, kernel())
        del got
        if library:
            lib_out = lib().reshape(b, h_out, k, w_out).permute(0, 2, 1, 3)
            lib_err = errors(lib_out, ref)[1]
            del lib_out
        del ref
        if not (rel_err <= REL_TOL and deterministic):
            raise AssertionError(f"disco {name}: kernel disagrees with its "
                                 f"plain version (rel {rel_err:.3e}) or is "
                                 f"not deterministic ({deterministic})")
    del xp
    # the taps this filter really has
    w = ops.work(shape, tuple(psi.shape), stride, int((psi != 0).sum()))
    flops, flops_dense, nbytes = w["flops"], w["flops_dense"], w["bytes"]
    row = dict(shape=f"x{shape} psi{tuple(psi.shape)} stride{stride}",
               call=("disco_band_contract",
                     (tuple(shape), tuple(psi.shape), stride)),
               what=name, launches=ent["launches"], max_abs_err=abs_err,
               max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_rel_err=lib_err, flops=flops,
               flops_dense=flops_dense, bytes=nbytes, **bound(flops, nbytes))
    log(f"[kernel] disco {name} {row['shape']}: launches={ent['launches']} "
        f"ms={ms:.3f} bound_ms={row['bound_ms']:.3f} "
        f"bound_tc_ms={row['bound_tc_ms']:.3f} "
        f"tflops={flops / ms / 1e9:.2f} conv1d_ms="
        + (f"{lib_ms:.3f}" if library else "not-timed")
        + (f" plain_ms={plain_ms:.3f} abs_err={abs_err:.3e} "
           f"rel_err={rel_err:.3e}" if full else "")
        + (f" (conv1d rel_err {lib_err:.1e})" if full and library else ""))
    return row


def check_transpose(ent, name, library: bool = True,
                    band: dict | None = None, tuned=None,
                    plain_planes: int | None = None) -> dict:
    """Band transpose kernel vs its plain version at one training shape,
    its launches there, and with ``library`` the ``conv_transpose1d``
    yardstick's time (one call: it takes seconds, see PERF.md; timed once
    per band, at its widest shape: the others repeat the same work).

    ``band``: one dict per band, checked widest shape first.  The widest
    keeps its g and the plain version's output there; a narrower shape
    takes the first planes of both (the planes are independent), so the
    plain version runs, and is timed, once per band.  ``tuned``: the
    winning tile of [tune] at this shape (a ``BlockConfig``), held to the
    same plain output.  ``plain_planes``: the plain version runs, untimed,
    on g's first planes only, and the kernel's first planes are held to
    it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.disco import ops
    from repro_torch.kernels.disco.ref import disco_band_transpose_ref
    psi, lat_idx, stride, shape, h_in = (ent["psi"], ent["lat_idx"],
                                         ent["stride"], ent["shape"],
                                         ent["h_in"])
    taps, lists = ent["taps"], ent["rows"]
    b, k, h_out, w_out = shape
    _, _, s, d = psi.shape
    w_in = w_out * stride
    reuse = band is not None and "ref" in band
    if reuse:
        g = band["g"][:b].contiguous()
    else:
        g = torch.randn(shape, generator=torch.Generator(
            device="cuda").manual_seed(13), device="cuda")

    def kernel():
        return ops.disco_band_transpose(g, psi, lat_idx, taps, lists, h_in,
                                        stride)

    def plain():
        return disco_band_transpose_ref(g, psi, lat_idx, h_in, stride)

    out = kernel()
    got = out[:plain_planes] if plain_planes else out
    plain_ms = None
    if reuse:
        ref = band["ref"][:b]
    elif plain_planes:
        ref = disco_band_transpose_ref(g[:plain_planes].contiguous(), psi,
                                       lat_idx, h_in, stride)
    else:
        # the plain version: one timed call (seconds at these shapes)
        refs = []
        plain_ms = cuda_ms(lambda: refs.append(plain()), reps=1, warmup=0)
        ref = refs.pop()
        if band is not None:
            band.update(g=g, ref=ref)
    abs_err, rel_err = errors(got, ref)
    deterministic = torch.equal(out, kernel())
    del got, out
    tuned_err = None
    if tuned is not None:
        tuned_err = errors(ops.disco_band_transpose(
            g, psi, lat_idx, taps, lists, h_in, stride, tuned), ref)[1]
    ms = cuda_ms(kernel, reps=5)
    lib_ms = lib_err = None
    # the grouped conv1d of check_disco, transposed: one conv_transpose1d
    # onto the wrap-padded gathered rows (cuDNN, TF32 off); folding the
    # pad back and adding rows is not timed
    wt = psi.permute(1, 0, 2, 3).reshape(h_out * k, s, d).contiguous()
    gl = g.permute(0, 2, 1, 3).reshape(b, h_out * k, w_out)

    def lib():
        return F.conv_transpose1d(gl, wt, stride=stride, groups=h_out)

    try:
        if library:
            # one timed call (no warm-up: at the decoder a call takes
            # 35-44 s, cuDNN's benchmark mode is off), its output checked
            outs = []
            lib_ms = cuda_ms(lambda: outs.append(lib()), reps=1, warmup=0)
            gxp = outs.pop()
            fold = gxp[..., :w_in].clone()
            fold[..., :gxp.shape[-1] - w_in] += gxp[..., w_in:]
            del gxp
            gxr = torch.zeros((b, h_in, w_in), device="cuda").index_add_(
                1, lat_idx.reshape(-1).long(),
                fold.reshape(b, h_out * s, w_in))
            del fold
            lib_err = errors(torch.roll(gxr, -(d // 2), dims=-1), ref)[1]
            del gxr
    except RuntimeError as exc:  # the yardstick only; never in the port
        log(f"[kernel] conv_transpose1d yardstick failed: {exc}")
    del gl, ref
    torch.cuda.empty_cache()
    # the taps this filter really has; g, the live taps and their lists
    # in, gx out
    w = ops.transpose_work(shape, tuple(psi.shape), h_in, stride,
                           int((psi != 0).sum()), ops.list_numel(taps, lists))
    flops, flops_dense, nbytes = w["flops"], w["flops_dense"], w["bytes"]
    row = dict(shape=f"g{shape} psi{tuple(psi.shape)} stride{stride}",
               call=("disco_band_transpose",
                     (tuple(shape), tuple(psi.shape), h_in, stride)),
               what=name, launches=ent["launches"], max_abs_err=abs_err,
               max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_rel_err=lib_err, flops=flops,
               flops_dense=flops_dense, bytes=nbytes,
               tflops=flops / ms / 1e9, dense_band_tflops=flops_dense / ms
               / 1e9, plain_planes=plain_planes, **bound(flops, nbytes))
    row["ms_over_bound"] = ms / row["bound_ms"]
    if tuned is not None:
        row["tuned_rel_err"] = tuned_err
        log(f"[kernel] transpose {name}: the tuned tile {dict(tuned.dims)} "
            f"vs plain rel_err={tuned_err:.3e} (bar {REL_TOL})")
        if not tuned_err <= REL_TOL:
            raise AssertionError(f"transpose {name}: the tuned tile "
                                 f"disagrees with plain (rel {tuned_err})")
    plain_txt = ("(the widest shape's)" if reuse else
                 f"(untimed, on the first {plain_planes} planes)"
                 if plain_planes else f"{plain_ms:.3f}")
    log(f"[kernel] transpose {name} {row['shape']}: "
        f"launches={ent['launches']} abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_txt} "
        f"conv_transpose1d_ms={lib_ms if library else 'not-timed'} "
        f"(rel_err {lib_err}) "
        f"bound_ms={row['bound_ms']:.3f} "
        f"ms/bound_ms={row['ms_over_bound']:.2f} "
        f"bound_tc_ms={row['bound_tc_ms']:.3f} "
        f"tflops={row['tflops']:.2f} "
        f"dense_band_tflops={row['dense_band_tflops']:.2f}")
    if not (rel_err <= REL_TOL and deterministic):
        raise AssertionError(f"transpose {name}: kernel disagrees with its "
                             f"plain version (rel {rel_err:.3e}) or is not "
                             f"deterministic ({deterministic})")
    return row


def check_crps(ent) -> list[dict]:
    """CRPS forward and backward kernels vs their plain versions at one
    training shape.  No single torch call computes CRPS: no yardstick."""
    import torch
    from repro_torch.kernels.crps import ops
    from repro_torch.kernels.crps.ref import crps_fused_bwd_ref, crps_fused_ref
    (e, n), fair = ent["shape"], ent["fair"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    ens = torch.randn((e, n), generator=gen, device="cuda")
    obs = torch.randn((n,), generator=gen, device="cuda")
    g = torch.randn((n,), generator=gen, device="cuda")
    rows = []
    for what, kernel, plain in (
            ("forward", lambda: ops.crps_fused(ens, obs, fair),
             lambda: crps_fused_ref(ens, obs, fair)),
            ("backward", lambda: ops.crps_fused_bwd(g, ens, obs, fair),
             lambda: crps_fused_bwd_ref(g, ens, obs, fair))):
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, ref)
        del got, ref
        ms = cuda_ms(kernel, reps=10)
        plain_ms = cuda_ms(plain, reps=5)
        w = ops.work(e, n, backward=what == "backward")
        flops, nbytes = w["flops"], w["bytes"]
        row = dict(shape=f"ens({e}, {n}) fair={fair}", what=what,
                   call=("crps_fused" if what == "forward"
                         else "crps_fused_bwd", ((e, n), fair)),
                   max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                   plain_ms=plain_ms, library_ms=None, flops=flops,
                   bytes=nbytes, **bound(flops, nbytes))
        log(f"[kernel] crps {what} {row['shape']}: abs_err={abs_err:.3e} "
            f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms=none (no single torch call computes CRPS) "
            f"bound_ms={row['bound_ms']:.3f} "
            f"GB/s={nbytes / ms / 1e6:.0f}")
        if not rel_err <= CRPS_REL_TOL:
            raise AssertionError(f"crps {what}: kernel disagrees with its "
                                 f"plain version (rel {rel_err:.3e})")
        rows.append(row)
    return rows


def check_ssd(ins, batch: int) -> tuple[dict, tuple]:
    """SSD intra-chunk kernel vs its plain version on the operands of the
    prefill's first layer (``batch`` sequences); also times the chunked
    scan around it.  No single torch call computes the masked, decayed
    intra-chunk product: no yardstick.  Returns the row and the layer's
    (states, chunk decays) for ``check_ssd_state``."""
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    x, da_cs, b, c = ins
    bc, l, h, p = x.shape
    g, n = b.shape[2:]
    got = ops.ssd_intra_chunk(x, da_cs, b, c)
    torch.cuda.synchronize()
    ref = ssd_intra_chunk_ref(x, da_cs, b, c)
    torch.cuda.synchronize()
    errs = [errors(a, r) for a, r in zip(got, ref)]
    abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    states = got[1].reshape(batch, bc // batch, h, p, n)
    deterministic = all(torch.equal(a, r) for a, r in zip(
        got, ops.ssd_intra_chunk(x, da_cs, b, c)))
    del got, ref
    ms = cuda_ms(lambda: ops.ssd_intra_chunk(x, da_cs, b, c), reps=10)
    plain_ms = cuda_ms(lambda: ssd_intra_chunk_ref(x, da_cs, b, c), reps=3)
    decay = torch.exp(da_cs[:, -1, :]).reshape(batch, bc // batch,
                                                h).contiguous()
    # the whole chunked scan around the kernel
    da = torch.diff(da_cs, dim=1, prepend=torch.zeros_like(da_cs[:, :1]))
    seq = (batch, bc // batch * l)
    chunked_ms = cuda_ms(lambda: ops.ssd_chunked_kernel(
        x.reshape(seq + (h, p)), da.reshape(seq + (h,)),
        b.reshape(seq + (g, n)), c.reshape(seq + (g, n)), l), reps=5)
    del da
    # the work the data needs (the causal taps)
    w = ops.work(tuple(x.shape), g, n)
    flops, flops_dense, nbytes = w["flops"], w["flops_dense"], w["bytes"]
    row = dict(shape=f"x{tuple(x.shape)} B,C{tuple(b.shape)}", what="prefill",
               call=("ssd_intra_chunk", (tuple(x.shape), tuple(b.shape))),
               max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
               plain_ms=plain_ms, library_ms=None, flops=flops,
               flops_dense=flops_dense, bytes=nbytes,
               tflops=flops / ms / 1e9, chunked_scan_ms=chunked_ms,
               **bound(flops, nbytes))
    row["ms_over_bound"] = ms / row["bound_ms"]
    log(f"[kernel] ssd {row['shape']}: abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms=none (no single torch call computes the masked, "
        f"decayed intra-chunk product) bound_ms={row['bound_ms']:.3f} "
        f"({row['bound_by']}) ms/bound_ms={row['ms_over_bound']:.2f} "
        f"bound_tc_ms={row['bound_tc_ms']:.3f} "
        f"ms/bound_tc_ms={ms / row['bound_tc_ms']:.2f} "
        f"tflops={row['tflops']:.2f} "
        f"dense_tflops={flops_dense / ms / 1e9:.2f} "
        f"chunked_scan_ms={chunked_ms:.3f}")
    if not (finite and rel_err <= REL_TOL and deterministic):
        raise AssertionError(f"ssd: kernel disagrees with its plain version "
                             f"(rel {rel_err:.3e}, finite={finite}) or is "
                             f"not deterministic ({deterministic})")
    return row, (states, decay)


def check_ssd_state(states, decay, launches: int) -> dict:
    """The inter-chunk recurrence kernel vs its plain loop on one prefill
    layer's chunk states (a random incoming state).  It is bound by
    bytes; no single torch call computes the recurrence: no yardstick."""
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import chunk_recurrence_ref
    init = torch.randn(states[:, 0].shape, generator=torch.Generator(
        device="cuda").manual_seed(15), device="cuda")
    got = ops.chunk_recurrence(states, decay, init)
    torch.cuda.synchronize()
    ref = chunk_recurrence_ref(states, decay, init)
    torch.cuda.synchronize()
    errs = [errors(a, r) for a, r in zip(got, ref)]
    abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
    deterministic = all(torch.equal(a, r) for a, r in zip(
        got, ops.chunk_recurrence(states, decay, init)))
    del got, ref
    ms = cuda_ms(lambda: ops.chunk_recurrence(states, decay, init), reps=10)
    plain_ms = cuda_ms(lambda: chunk_recurrence_ref(states, decay, init),
                       reps=5)
    # states and the incoming state in, prev and the final state out
    w = ops.state_work(tuple(states.shape))
    flops, nbytes = w["flops"], w["bytes"]
    row = dict(shape=f"states{tuple(states.shape)}", what="prefill",
               call=("ssd_chunk_recurrence", (tuple(states.shape),)),
               launches=launches, max_abs_err=abs_err, max_rel_err=rel_err,
               ms=ms, plain_ms=plain_ms, library_ms=None, flops=flops,
               bytes=nbytes, **bound(flops, nbytes))
    row["ms_over_bound"] = ms / row["bound_ms"]
    log(f"[kernel] ssd_state {row['shape']}: launches={launches} "
        f"abs_err={abs_err:.3e} rel_err={rel_err:.3e} ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f} (the loop of two launches a chunk) "
        f"library_ms=none (no single torch call computes the recurrence) "
        f"bound_ms={row['bound_ms']:.3f} ({row['bound_by']}) "
        f"ms/bound_ms={row['ms_over_bound']:.2f} "
        f"GB/s={nbytes / ms / 1e6:.0f}")
    if not (rel_err <= 1e-6 and deterministic):
        raise AssertionError(f"ssd_state: kernel disagrees with its plain "
                             f"loop (rel {rel_err:.3e}) or is not "
                             f"deterministic ({deterministic})")
    return row


def any_stride_transpose(stride: int) -> dict:
    """A small synthetic band (holes, dead slices, a slice wider than a
    staged piece, any lat_idx) for the transpose at a stride no fcn3
    geometry has: its generic path, held to its plain version by
    ``check_transpose``."""
    import numpy as np
    import torch
    from repro_torch.core.sphere import disco
    from repro_torch.kernels.disco import ops
    rng = np.random.default_rng(16)
    k, h_out, s, d, h_in, w_out = 7, 13, 5, 151, 17, 300
    psi = rng.standard_normal((k, h_out, s, d)).astype(np.float32)
    psi[rng.random(psi.shape) < 0.3] = 0
    psi[..., :60] = 0
    psi[..., 90:] = 0
    psi[:, 3, 2, 5:148] = rng.standard_normal((k, 143))
    psi[:, 4] = 0
    lat_idx = rng.integers(0, h_in, (h_out, s)).astype(np.int32)
    taps = disco.band_live_taps(psi)
    rows = disco.band_row_taps(lat_idx, taps, h_in)

    def dev(a):
        return torch.from_numpy(a).to("cuda")
    return {"psi": dev(psi), "lat_idx": dev(lat_idx),
            "taps": ops.LiveTaps.of({n: dev(a) for n, a in taps.items()}),
            "rows": ops.RowTaps.of({n: dev(a) for n, a in rows.items()}),
            "h_in": h_in, "stride": stride, "shape": (19, k, h_out, w_out),
            "launches": 0}


def host_checks(report) -> None:
    """Index arithmetic of this run's new shapes, in numpy before the
    first card call: the attention's query tiles at zamba2-2.7b's prefill
    (each row once, every key its rows may see, a tile's scores within
    ``TILE_SCORE_BYTES``), and the SSD kernel's grid at its 80 heads
    (``csrc/ssd.cu``: block -> chunk, group, head tile; heads in tiles of
    ``HEADS_PER_BLOCK`` = 24, the last one ragged)."""
    import numpy as np
    from repro_torch.configs import archs
    from repro_torch.kernels.config import BLOCK_DEFAULTS
    from repro_torch.models import attention as attn
    cfg = archs.get_arch(HYBRID_ARCH)
    s, h = 32768, cfg.n_heads
    rows = attn.query_rows(HYBRID_PREFILL_BATCH, h, s)
    tiles = list(attn.query_tiles(s, s, rows, True, 0, True))
    tile_bytes = 4 * HYBRID_PREFILL_BATCH * h * rows * s
    seen = np.zeros(s, np.int64)
    for q0, q1, k0, k1 in tiles:
        seen[q0:q1] += 1
        if not (k0 == 0 and k1 == q1):
            raise AssertionError(f"causal tile {q0}:{q1} reads keys "
                                 f"{k0}:{k1}, want 0:{q1}")
    full = 4 * HYBRID_PREFILL_BATCH * h * s * s
    if not ((seen == 1).all() and tile_bytes <= attn.TILE_SCORE_BYTES
            and 2 * tile_bytes < 10e9):
        raise AssertionError(f"query tiles: rows {rows}, {tile_bytes} B a "
                             f"tile, rows covered {np.unique(seen)}")
    report(f"[host] attention at {HYBRID_ARCH} prefill 1 x {s}, {h} heads: "
           f"{rows} query rows a tile, {len(tiles)} tiles a layer, "
           f"{tile_bytes / 2**30:.1f} GiB of scores a tile (~"
           f"{2 * tile_bytes / 2**30:.1f} GiB with the probabilities) "
           f"against {full / 1e9:.1f} GB untiled")
    # csrc/ssd.cu's launch and block prologue, emulated
    ssm = cfg.ssm
    hpb = BLOCK_DEFAULTS["ssd"]["HEADS_PER_BLOCK"]
    heads, g = ssm.n_heads, ssm.n_groups
    rep = heads // g
    ht = min(hpb, rep)
    n_tiles = (rep + ht - 1) // ht
    bc = 3                       # a few chunks; the grid repeats per chunk
    cover = np.zeros((bc, heads), np.int64)
    sizes = []
    for block in range(bc * g * n_tiles):
        per_chunk = g * n_tiles
        c, grp, tile = (block // per_chunk, (block % per_chunk) // n_tiles,
                        block % n_tiles)
        h0 = grp * rep + tile * ht
        nh = min(ht, rep - tile * ht)
        if c == 0:
            sizes.append(nh)
        cover[c, h0:h0 + nh] += 1
    if not ((cover == 1).all() and sizes == [24, 24, 24, 8]):
        raise AssertionError(f"SSD grid at H={heads}: tiles {sizes}, heads "
                             f"covered {np.unique(cover)}")
    report(f"[host] SSD grid at H={heads}, G={g}: {n_tiles} head tiles a "
           f"group of {sizes} heads (HEADS_PER_BLOCK={hpb}), every head of "
           f"every chunk once; {s // ssm.chunk * n_tiles} blocks a "
           f"sequence")


def lm_small_input_check(arch: str = LM_ARCH) -> float:
    """An architecture's smoke widths on the card: the SSD kernel path vs
    the reference scan, from the same weights and tokens."""
    import torch
    from repro_torch.configs import archs
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.models.transformer import LM
    cfg = archs.smoke_config(arch)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(8))
    outs = []
    for mode in ("kernel", "reference"):
        model = LM(cfg, device="cuda", kernels=KernelConfig(ssd=mode))
        model.init(torch.Generator(device="cuda").manual_seed(9))
        outs.append(model(tokens))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    return float((outs[0] - outs[1]).abs().max())


def lm_phase(report) -> dict:
    """The mamba2-130m serving path at full width: prefill (counted),
    prefill again (steady), decode, and prefill vs recurrence."""
    import torch
    from repro_torch.configs import shapes
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import lm as lm_mod
    pre = shapes.INPUT_SHAPES["prefill_32k"]
    dec = shapes.INPUT_SHAPES["decode_32k"]
    t0 = time.time()
    model = lm_mod.build_model(LM_ARCH, shape=pre.name, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    report(f"[lm] arch={cfg.name} layers={cfg.n_layers} "
           f"d_model={cfg.d_model} vocab={cfg.padded_vocab} "
           f"d_state={cfg.ssm.d_state} heads={cfg.ssm.n_heads} "
           f"chunk={cfg.ssm.chunk} params={model.param_count()} "
           f"setup_s={time.time() - t0:.1f}")
    out = {"n_layers": cfg.n_layers}
    ssd_ops.reset_launches()
    first = lm_mod.run_prefill(model, LM_PREFILL_BATCH, pre.seq_len, seed=1,
                               report=report)
    out["launches"] = ssd_ops.launches
    out["state_launches"] = ssd_ops.state_launches
    logits = first.pop("logits")
    out["logits_shape"] = tuple(logits.shape)
    out["logits_finite"] = bool(torch.isfinite(logits).all())
    out["logits_max"] = float(logits.abs().max())
    del logits
    out["prefill"] = first
    steady = lm_mod.run_prefill(model, LM_PREFILL_BATCH, pre.seq_len, seed=1,
                                report=report)
    del steady["logits"]
    out["prefill_steady"] = steady
    torch.cuda.empty_cache()
    out["decode_finite"] = True
    for key in ("decode", "decode_steady"):
        d = lm_mod.run_decode(model, dec.global_batch, dec.seq_len,
                              LM_DECODE_STEPS, seed=2, report=report)
        out["decode_finite"] &= bool(torch.isfinite(d.pop("logits")).all())
        del d["cache"]
        out[key] = d
    torch.cuda.empty_cache()
    # prefill logits vs the recurrence over the same tokens
    before = ssd_ops.launches
    c = _consistency(model, LM_CONSIST_TOKENS, seed=3)
    out["consist_launches"] = ssd_ops.launches - before
    out["consist_err"], out["consist_scale"] = c["err"], c["scale"]
    del model
    torch.cuda.empty_cache()
    return out


def _consistency(model, n_tokens: int, seed: int) -> dict:
    """Prefill logits of 2 x ``n_tokens`` random tokens against as many
    decode steps through the caches: the largest difference and the
    largest logit.  An audio model's prefill takes encoder frames, and
    its decode steps the encoder's output over them."""
    import torch
    from repro_torch.launch import lm as lm_mod
    tokens = lm_mod.random_tokens(model, (2, n_tokens), seed=seed)
    pre, dec = {}, {}
    if model.cfg.family == "audio":
        pre = lm_mod.front_end_inputs(model, 2, "prefill", seed)
        dec = {"enc_states": model.encode_audio(pre["enc_frames"])}
    full = model(tokens, **pre)
    cache = model.init_cache(2, n_tokens)
    diffs = []
    for t in range(n_tokens):
        step, cache = model.decode_step(tokens[:, t:t + 1], cache, t, **dec)
        diffs.append((step[:, 0] - full[:, t]).abs().max())
    out = {"err": float(torch.stack(diffs).max()),
           "scale": float(full.abs().max())}
    del full, cache
    return out


def _profile_split(prof) -> dict:
    """Device time (ms) of a profiled run by kind of kernel: the two SSD
    kernels, cuBLAS GEMMs, softmax, copies (memcpy, ``copy_``, ``cat``),
    the rest."""
    import torch
    split = dict.fromkeys(("ssd_intra_chunk", "ssd_state", "gemm",
                           "softmax", "copy", "other"), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("ssd_intra_chunk" if "ssd_intra_chunk" in name
                else "ssd_state" if "ssd_state" in name
                else "gemm" if "gemm" in name
                else "softmax" if "softmax" in name
                else "copy" if "copy" in name else "other")
        split[kind] += e.time_range.elapsed_us() / 1e3
    return split


def lm_hybrid_phase(report) -> dict:
    """zamba2-2.7b's serving path at full width: prefill (counted),
    prefill again (steady), one more under torch.profiler (device
    activity), the shared block's attention timed alone, decode twice,
    and prefill vs recurrence; with the host seconds of each part."""
    import torch
    from repro_torch.configs import shapes
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import lm as lm_mod
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    pre = shapes.INPUT_SHAPES["prefill_32k"]
    dec = shapes.INPUT_SHAPES["decode_32k"]
    t0 = time.time()
    model = lm_mod.build_model(HYBRID_ARCH, shape=pre.name, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = model.param_count()
    report(f"[lm-hybrid] arch={cfg.name} layers={cfg.n_layers} "
           f"units={model.n_units} (a shared attention block every "
           f"{cfg.attn_every}) d_model={cfg.d_model} heads={cfg.n_heads} "
           f"kv_heads={cfg.n_kv_heads} head_dim={cfg.head_dim} "
           f"ssd_heads={cfg.ssm.n_heads} d_state={cfg.ssm.d_state} "
           f"chunk={cfg.ssm.chunk} vocab={cfg.padded_vocab} "
           f"params={n_params} ({4 * n_params / 1e9:.2f} GB fp32) "
           f"setup_s={time.time() - t0:.1f}; cuts: prefill_32k batch "
           f"{pre.global_batch} -> {HYBRID_PREFILL_BATCH}, decode_32k batch "
           f"{dec.global_batch} -> {HYBRID_DECODE_BATCH}, random weights "
           f"(seed 0), no depth cut")
    out = {"n_layers": cfg.n_layers, "units": model.n_units,
           "params": n_params}
    parts = out["parts_s"] = {"setup": time.time() - t0}
    t0 = time.time()
    ssd_ops.reset_launches()
    first = lm_mod.run_prefill(model, HYBRID_PREFILL_BATCH, pre.seq_len,
                               seed=1, report=report)
    out["launches"] = ssd_ops.launches
    out["state_launches"] = ssd_ops.state_launches
    logits = first.pop("logits")
    out["logits_shape"] = tuple(logits.shape)
    out["logits_finite"] = bool(torch.isfinite(logits).all())
    out["logits_max"] = float(logits.abs().max())
    del logits
    out["prefill"] = first
    steady = lm_mod.run_prefill(model, HYBRID_PREFILL_BATCH, pre.seq_len,
                                seed=1, report=report)
    del steady["logits"]
    out["prefill_steady"] = steady
    parts["prefills"] = time.time() - t0
    t0 = time.time()
    # device activity only: the report reads the device's events, and
    # recording host ops would slow the launch of 7,000 kernels
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_run = lm_mod.run_prefill(model, HYBRID_PREFILL_BATCH,
                                      pre.seq_len, seed=1, report=report)
    del prof_run["logits"]
    out["profile"] = lm_mod.report_profile(prof, prof_run["seconds"],
                                           report, top=10)
    out["split_ms"] = _profile_split(prof)
    del prof
    # one unit's attention alone (the shared block's GQA at the prefill's
    # shape, its projections included), for the profile's split
    h = torch.randn((HYBRID_PREFILL_BATCH, pre.seq_len, cfg.d_model),
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    h = cm.rmsnorm(model.shared_attn.ln_attn, h, cfg.norm_eps)
    p = model.shared_attn.attn.params()
    acfg = cfg.attn_config()
    out["attn_unit_ms"] = cuda_ms(lambda: attn.apply_gqa_train(p, acfg, h),
                                  reps=3)
    del h
    torch.cuda.empty_cache()
    parts["profile"] = time.time() - t0
    t0 = time.time()
    out["decode_finite"] = True
    for key in ("decode", "decode_steady"):
        d = lm_mod.run_decode(model, HYBRID_DECODE_BATCH, dec.seq_len,
                              LM_DECODE_STEPS, seed=2, report=report)
        out["decode_finite"] &= bool(torch.isfinite(d.pop("logits")).all())
        out["cache_gb"] = sum(t.numel() * t.element_size() for t in
                              d.pop("cache")["shared_attn"]["self"].values()
                              ) / 1e9
        out[key] = d
    torch.cuda.empty_cache()
    # HYBRID_PROFILED_STEPS decode steps under torch.profiler after one
    # warm step, from a fresh cache: the device's busy share of a step and
    # its time by kind of kernel
    cache = model.init_cache(HYBRID_DECODE_BATCH, dec.seq_len)
    tok = lm_mod.random_tokens(model, (HYBRID_DECODE_BATCH, 1), seed=2)
    model.decode_step(tok, cache, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for pos in range(1, 1 + HYBRID_PROFILED_STEPS):
            model.decode_step(tok, cache, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    del cache
    out["decode_profile"] = lm_mod.report_profile(prof, wall, report, top=8)
    out["decode_split_ms"] = _profile_split(prof)
    del prof
    torch.cuda.empty_cache()
    parts["decode"] = time.time() - t0
    t0 = time.time()
    before = ssd_ops.launches
    c = _consistency(model, LM_CONSIST_TOKENS, seed=3)
    out["consist_launches"] = ssd_ops.launches - before
    out["consist_err"], out["consist_scale"] = c["err"], c["scale"]
    parts["consistency"] = time.time() - t0
    del model
    torch.cuda.empty_cache()
    return out


def attention_family_phase(report, arch: str, layers: int | None,
                           prefill_len: int, consist_tokens: int) -> dict:
    """``arch`` at its published widths (``layers`` of its decoder layers
    where given): a prefill at 1 x ``prefill_len`` with its front end's
    stubs, and prefill vs decode over 2 x ``consist_tokens`` tokens."""
    import torch
    from repro_torch.configs import archs
    from repro_torch.launch import lm as lm_mod
    t0 = time.time()
    resident = torch.cuda.memory_allocated() / 1e9
    model = lm_mod.build_model(arch, shape="prefill_32k", seed=0,
                               device="cuda", layers=layers)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = model.param_count()
    front = (f" encoder_layers={cfg.n_encoder_layers} encoder_seq="
             f"{cfg.encoder_seq}" if cfg.family == "audio" else
             f" patches={cfg.n_patches}" if cfg.family == "vlm" else "")
    report(f"[lm-hybrid] {cfg.family} arch={cfg.name} layers={cfg.n_layers} "
           f"(of {archs.get_arch(arch).n_layers}){front} "
           f"d_model={cfg.d_model} heads={cfg.n_heads} "
           f"kv_heads={cfg.n_kv_heads} (G={cfg.n_heads // cfg.n_kv_heads}) "
           f"head_dim={cfg.head_dim} rope_theta={cfg.rope_theta:g} "
           f"vocab={cfg.padded_vocab} params={n_params} "
           f"({4 * n_params / 1e9:.2f} GB fp32) resident_before_gb="
           f"{resident:.2f} setup_s={time.time() - t0:.1f}")
    out = {"arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "params": n_params, "prefill_len": prefill_len,
           "consist_tokens": consist_tokens,
           "want_logits": (1, prefill_len, cfg.padded_vocab)}
    pf = lm_mod.run_prefill(model, 1, prefill_len, seed=1, report=report)
    logits = pf.pop("logits")
    out["logits_shape"] = tuple(logits.shape)
    out["logits_finite"] = bool(torch.isfinite(logits).all())
    del logits
    out["prefill"] = pf
    c = _consistency(model, consist_tokens, seed=3)
    out["consist_err"], out["consist_scale"] = c["err"], c["scale"]
    out["phase_s"] = time.time() - t0
    del model
    torch.cuda.empty_cache()
    return out


def _dispatch_invariants(found: list):
    """An ``moe.observe`` callback: each dense MoE layer's dispatch held
    on the card to its invariants -- every kept (token, k) pair holds
    exactly one slot, a dropped pair none, no slot holds two pairs -- and
    its kept pairs to what the host recomputes from ``gate_idx`` (each
    pair's rank in its expert, token-major, against the capacity).  One
    dict per layer lands in ``found``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    def check(r) -> None:
        disp = r.dispatch
        # slots each (token, expert) holds vs the kept pairs routed there
        per_te = disp.sum(-1)                                   # (T, E)
        want_te = (F.one_hot(r.gate_idx, r.n_experts)
                   * r.keep[..., None]).sum(1).to(per_te.dtype)
        gi = r.gate_idx.cpu().numpy()
        flat = gi.reshape(-1)
        rank = np.zeros(flat.size, dtype=np.int64)
        seen = np.zeros(r.n_experts, dtype=np.int64)
        for i, e in enumerate(flat):
            rank[i] = seen[e]
            seen[e] += 1
        host_keep = (rank < r.cap).reshape(gi.shape)
        found.append({
            "tokens": gi.shape[0], "pairs": int(r.keep.numel()),
            "cap": r.cap, "kept": int(r.keep.sum()),
            "host_kept": int(host_keep.sum()),
            "keep_equal": bool((r.keep.cpu().numpy() == host_keep).all()),
            "one_slot_each": bool(torch.equal(per_te, want_te)),
            "max_pairs_a_slot": float(disp.sum(0).max()),
            "dispatch_sum": float(disp.sum()),
            "values_01": bool(((disp == 0) | (disp == 1)).all())})
    return check


def _ssd_bwd_operands(intra: tuple, rec: tuple, da_scale: float, seed: int):
    """Random operands of both backward kernels on the card: the
    intra-chunk step's (x, da_cs, B, C) and output gradients at ``intra``
    = (BC, L, H, P, G, N); the recurrence's states, decays (exp of each
    chunk's dA sum) and incoming state with its output gradients at
    ``rec`` = (B, nc, H, P, N).  ``da_scale`` 2.0: chunks whose |dA| sums
    pass 88."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    bc, l, h, p, g, n = intra
    da = -randn(bc, l, h).abs() * da_scale
    da_cs = torch.cumsum(da, dim=1)
    ins = (randn(bc, l, h, p), da_cs, randn(bc, l, g, n), randn(bc, l, g, n))
    cots = (randn(bc, l, h, p), randn(bc, h, p, n))
    b, nc, hh, pp, nn = rec
    decay = torch.exp(-(randn(b, nc, hh).abs() * da_scale * l))
    rins = (randn(b, nc, hh, pp, nn), decay, randn(b, hh, pp, nn))
    rcots = (randn(b, nc, hh, pp, nn), randn(b, hh, pp, nn))
    return ins, cots, rins, rcots


def kernel_launches(fn) -> int:
    """The kernels one call of ``fn`` enqueues: the call captured into a
    CUDA graph (nothing runs), its kernel nodes counted through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  torch.profiler is no
    count here: in a window of one call after the dry run's fake tensors
    it saw 0 or 1 of the call's 2 kernels on the H100, now and then."""
    import ctypes
    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0     # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


def check_ssd_bwd(tag: str, intra: tuple, rec: tuple, da_scale: float
                  ) -> tuple[dict, dict]:
    """Both SSD backward kernels against autograd of their plain versions
    at the gradient bar, run twice (bitwise the same), timed beside the
    plain version (its forward and autograd's backward), their bounds and
    their first design's time (SSD_BWD_FIRST_MS); every gradient finite;
    the kernels one call launches counted in a CUDA graph of it
    (``launches_per_call``).  No single torch call computes either: no
    yardstick."""
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import (chunk_recurrence_ref,
                                             ssd_intra_chunk_ref)
    ins, cots, rins, rcots = _ssd_bwd_operands(intra, rec, da_scale,
                                               seed=len(tag))

    def plain_intra(dt=torch.float32):
        ts = [t.detach().to(dt).requires_grad_(True) for t in ins]
        return torch.autograd.grad(ssd_intra_chunk_ref(*ts), ts,
                                   [c.to(dt) for c in cots])

    def plain_rec(dt=torch.float32):
        ts = [t.detach().to(dt).requires_grad_(True) for t in rins]
        return torch.autograd.grad(chunk_recurrence_ref(*ts), ts,
                                   [c.to(dt) for c in rcots])

    prev = ops.chunk_recurrence(*rins)[0]
    kernels = {
        "ssd_intra_chunk_bwd": (
            lambda: ops.ssd_intra_chunk_bwd(*ins, *cots), plain_intra,
            ops.bwd_work(tuple(ins[0].shape), intra[4], intra[5]),
            ("ssd_intra_chunk_bwd",
             (tuple(ins[0].shape), tuple(ins[2].shape))),
            f"x{tuple(ins[0].shape)} B,C{tuple(ins[2].shape)}"),
        "ssd_chunk_recurrence_bwd": (
            # dstates, ddecay, dinit: autograd's order is states, decay,
            # init
            lambda: ops.chunk_recurrence_bwd(rcots[0], rcots[1], prev,
                                             rins[1]), plain_rec,
            ops.state_bwd_work(tuple(rins[0].shape)),
            ("ssd_chunk_recurrence_bwd", (tuple(rins[0].shape),)),
            f"states{tuple(rins[0].shape)}")}
    def excess(got, want):
        # the largest |got - want| beyond rtol |want|: within atol passes
        return max(float(((a.double() - r).abs() - GRAD_RTOL * r.abs()
                          ).max()) for a, r in zip(got, want))

    rows = {}
    for name, (run, plain, w, call, shape) in kernels.items():
        got = run()
        again = run()
        torch.cuda.synchronize()
        per_call = kernel_launches(run)
        # the yardstick: autograd of the plain version in float64; the
        # float32 plain version rounds about as much as the kernel does
        want = plain(torch.float64)
        worst_plain = excess(plain(), want)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = excess(got, want)
        abs_err = max(float((a.double() - r).abs().max())
                      for a, r in zip(got, want))
        rel_err = max(errors(a.double(), r)[1] for a, r in zip(got, want))
        del got, again, want
        torch.cuda.empty_cache()
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(plain, reps=2)
        flops, nbytes = w["flops"], w["bytes"]
        first_ms = SSD_BWD_FIRST_MS[name][tag]
        row = dict(shape=shape, what=tag, call=call, max_abs_err=abs_err,
                   max_rel_err=rel_err, excess=worst,
                   plain_fp32_excess=worst_plain, ms=ms, plain_ms=plain_ms,
                   library_ms=None, flops=flops, bytes=nbytes,
                   deterministic=bitwise, launches_per_call=per_call,
                   **bound(flops, nbytes))
        row["ms_over_bound"] = ms / row["bound_ms"]
        log(f"[lm-train] (b) {name} {tag} {shape}: vs float64 autograd "
            f"of the plain version abs_err={abs_err:.3e} rel_err="
            f"{rel_err:.3e} excess over rtol {worst:.3e} (rtol={GRAD_RTOL}"
            f" atol={GRAD_ATOL}; the float32 plain version's "
            f"{worst_plain:.3e}) finite={finite} bitwise_rerun={bitwise} "
            f"kernel_ms={ms:.3f} "
            f"plain_ms={plain_ms:.3f} (autograd of the plain version) "
            f"library_ms=none bound_ms={row['bound_ms']:.3f} "
            f"({row['bound_by']}) bound_tc_ms={row['bound_tc_ms']:.3f} "
            f"ms/bound_ms={row['ms_over_bound']:.2f} "
            f"tflops={flops / ms / 1e9:.2f} GB/s={nbytes / ms / 1e6:.0f} "
            f"launches_per_call={per_call} first_design_ms={first_ms:.3f} "
            f"({first_ms / ms:.2f}x)")
        if not (finite and bitwise and worst <= GRAD_ATOL and per_call >= 1):
            raise AssertionError(f"{name} {tag}: off the gradient bar "
                                 f"({worst:.3e} past rtol), finite={finite},"
                                 f" bitwise={bitwise}, launches a call "
                                 f"{per_call}")
        if name == "ssd_intra_chunk_bwd" and not (
                per_call <= 2 and ms < first_ms
                and (tag != "train" or ms <= 0.5 * first_ms)):
            raise AssertionError(f"{name} {tag}: {ms:.3f} ms in {per_call} "
                                 f"launches against the first design's "
                                 f"{first_ms:.3f} ms (at most 2 launches, "
                                 f"faster, half at train)")
        rows[name] = row
    del ins, cots, rins, rcots, prev
    torch.cuda.empty_cache()
    return rows["ssd_intra_chunk_bwd"], rows["ssd_chunk_recurrence_bwd"]


def dryrun_lm_train(guard) -> dict:
    """[lm-train]'s step dry-run on one rank: mamba2-130m, LM_TRAIN_BATCH x
    4096, remat."""
    import dataclasses
    from repro_torch.configs import archs, shapes
    from repro_torch.launch import dryrun
    shape = dataclasses.replace(shapes.INPUT_SHAPES["train_4k"],
                                global_batch=LM_TRAIN_BATCH)
    return dry_count("mamba2-130m/lm-train", lambda dry, mesh: (
        dryrun.build_lm_case(LM_ARCH, shape, mesh, dry,
                             cfg=archs.get_arch(LM_ARCH))), guard)


def lm_train_phase(report, guard) -> dict:
    """(a) mamba2-130m at its published widths trains for LM_TRAIN_STEPS
    Adam steps on one batch of LM_TRAIN_BATCH x 4096 (train_4k's
    sequence) with remat, each step's launches counted, then the same
    step dry-run and held to them; (b) both SSD backward kernels against
    autograd of their plain versions at SSD_BWD_CHECKS; (c) one loss and
    backward of each family's smoke config on the card against the CPU."""
    import torch
    from repro_torch.configs import archs, shapes
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import lm as lm_mod
    from repro_torch.models.transformer import LM
    from repro_torch.optim import adam as adamlib
    from repro_torch.train import lm as lmtrain
    out: dict = {"parts_s": {}}
    t0 = time.time()
    seq = shapes.INPUT_SHAPES["train_4k"].seq_len
    model = lm_mod.build_model(LM_ARCH, shape="train_4k", seed=0,
                               device="cuda")
    opt = adamlib.Adam(lr=LM_TRAIN_LR)
    state = opt.init(dict(model.named_parameters()))
    tokens = lm_mod.random_tokens(model, (LM_TRAIN_BATCH, seq), seed=4)
    batch = {"tokens": tokens, "labels": tokens}
    cfg = model.cfg
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    guard.counts = dict.fromkeys(guard.counts, 0)
    steps = []
    for i in range(LM_TRAIN_STEPS):
        ssd_ops.reset_launches()
        t1 = time.time()
        state, diag = lmtrain.train_step(model, opt, state, batch)
        torch.cuda.synchronize()
        sec = time.time() - t1
        steps.append({
            "seconds": sec, "loss": float(diag["loss"]),
            "grad_norm": float(diag["grad_norm"]),
            "launches": {"ssd_intra_chunk": ssd_ops.launches,
                         "ssd_chunk_recurrence": ssd_ops.state_launches,
                         "ssd_intra_chunk_bwd": ssd_ops.bwd_launches,
                         "ssd_chunk_recurrence_bwd":
                         ssd_ops.state_bwd_launches}})
        report(f"[lm-train] step {i} loss={steps[-1]['loss']:.6f} "
               f"|g|={steps[-1]['grad_norm']:.6f} step_s={sec:.3f} "
               f"tokens_per_s={LM_TRAIN_BATCH * seq / sec:.0f} "
               f"launches={steps[-1]['launches']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["plain"] = dict(guard.counts)
    out.update(steps=steps, setup_s=setup_s, resident_gb=resident,
               n_layers=cfg.n_layers, params=model.param_count(),
               cfg=cfg)
    del model, opt, state, batch, tokens, diag
    gc.collect()
    torch.cuda.empty_cache()
    out["parts_s"]["(a) train"] = time.time() - t0
    # the same step counted on fake tensors: its calls against a step's
    # launches, its live-set peak against the card's
    t0 = time.time()
    out["dry"] = dryrun_lm_train(guard)
    out["parts_s"]["(a) dry run"] = time.time() - t0

    t0 = time.time()
    out["bwd_rows"] = [check_ssd_bwd(*c) for c in SSD_BWD_CHECKS]
    out["parts_s"]["(b) kernels"] = time.time() - t0

    # (c) each family's smoke config: loss and gradients on the card
    # against the CPU from the same weights and inputs
    t0 = time.time()
    fams = []
    for arch in LM_FAMILY_ARCHS:
        scfg = archs.smoke_config(arch)
        gen = torch.Generator().manual_seed(5)
        cpu = LM(scfg, device="cpu")
        cpu.init(gen)
        card = LM(scfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        s_text = 64 - (scfg.n_patches if scfg.family == "vlm" else 0)
        tok = torch.randint(0, scfg.vocab_size, (2, s_text), generator=gen)
        b = {"tokens": tok, "labels": tok}
        if scfg.family == "vlm":
            b["patches"] = torch.randn((2, scfg.n_patches, scfg.d_model),
                                       generator=gen)
        if scfg.family == "audio":
            b["enc_frames"] = torch.randn(
                (2, scfg.encoder_seq, scfg.d_model), generator=gen)
        ssd_ops.reset_launches()
        loss, _, grads = lmtrain.loss_and_grads(
            card, {k: v.cuda() for k, v in b.items()})
        torch.cuda.synchronize()
        bwd = ssd_ops.bwd_launches
        ref, _, ref_grads = lmtrain.loss_and_grads(cpu, b)
        rel = abs(float(loss) - float(ref)) / abs(float(ref))
        worst = max(float(((g.cpu() - ref_grads[k]).abs()
                           - GRAD_RTOL * ref_grads[k].abs()).max())
                    for k, g in grads.items())
        fams.append({"arch": arch, "family": scfg.family,
                     "loss": float(loss), "cpu_loss": float(ref),
                     "rel": rel, "grad_worst": worst, "ssd_bwd": bwd})
        report(f"[lm-train] (c) {scfg.family} {arch} smoke: loss on the card "
               f"{float(loss):.6f} on the CPU {float(ref):.6f} rel={rel:.2e} "
               f"(bar {LM_TRAIN_LOSS_RTOL:g}); gradients: worst excess over "
               f"rtol {GRAD_RTOL} = {worst:.2e} (atol {GRAD_ATOL}); SSD "
               f"backward launches {bwd}")
        del cpu, card, grads, ref_grads
    torch.cuda.empty_cache()
    out["families"] = fams
    out["parts_s"]["(c) families"] = time.time() - t0
    return out


def lm_moe_phase(report, arch: str, layers: int, prefill_len: int) -> dict:
    """``arch`` at its published widths, ``layers`` of its layers: a
    prefill at 1 x ``prefill_len`` (its dispatch held to its invariants),
    a steady one, decode at ``MOE_DECODE_BATCH`` x 32768 twice, and
    prefill vs decode over 2 x ``MOE_CONSIST_TOKENS`` tokens at the
    capacity where nothing drops; with the host seconds of each part and
    the phase's peak."""
    import dataclasses
    import torch
    from repro_torch.configs import archs, shapes
    from repro_torch.launch import lm as lm_mod
    from repro_torch.models import moe
    dec = shapes.INPUT_SHAPES["decode_32k"]
    full = archs.get_arch(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    t0 = time.time()
    model = lm_mod.build_model(arch, shape="prefill_32k", seed=0,
                               device="cuda", layers=layers)
    torch.cuda.synchronize()
    cfg, mc = model.cfg, model.cfg.moe
    n_params = model.param_count()
    n_moe = len(model.layers)
    stack = (f"{len(getattr(model, 'dense_layers', ()))} dense + {n_moe} MoE"
             if cfg.moe_every == 1 else
             f"{model.n_units} unit(s) of {cfg.moe_every - 1} dense + 1 MoE")
    attn_txt = (f"MLA heads={cfg.n_heads} kv_lora={cfg.kv_lora_rank} "
                f"q_lora={cfg.q_lora_rank}" if cfg.mla else
                f"GQA heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}")
    report(f"[lm-moe] arch={cfg.name} layers={cfg.n_layers} (of "
           f"{full.n_layers}: {stack}) d_model={cfg.d_model} {attn_txt} "
           f"dense_d_ff={cfg.d_ff} experts={mc.n_experts}x{mc.d_ff} "
           f"top_k={mc.top_k} shared={mc.n_shared}x{mc.shared_width} "
           f"vocab={cfg.padded_vocab} params={n_params} "
           f"({4 * n_params / 1e9:.2f} GB fp32) resident_before_gb="
           f"{resident:.2f} setup_s={time.time() - t0:.1f}; cuts: depth "
           f"{full.n_layers} -> {cfg.n_layers}, prefill 1 x {prefill_len} "
           f"(prefill_32k: {shapes.INPUT_SHAPES['prefill_32k'].global_batch}"
           f" x 32768), decode_32k batch {dec.global_batch} -> "
           f"{MOE_DECODE_BATCH}, random weights (seed 0), widths all "
           f"published")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_moe": n_moe,
           "params": n_params, "prefill_len": prefill_len,
           "resident_gb": resident,
           "want_logits": (1, prefill_len, cfg.padded_vocab),
           "capacity_factor": mc.capacity_factor}
    parts = out["parts_s"] = {"setup": time.time() - t0}
    t0 = time.time()
    found: list = []
    with moe.observe(_dispatch_invariants(found)):
        first = lm_mod.run_prefill(model, 1, prefill_len, seed=1,
                                   report=report)
    out["invariants"] = found
    logits = first.pop("logits")
    out["logits_shape"] = tuple(logits.shape)
    out["logits_finite"] = bool(torch.isfinite(logits).all())
    # no |logits| temporary (1.66 GB at llama4's head) beside 74.7 GB
    lo, hi = torch.aminmax(logits)
    out["logits_max"] = max(-float(lo), float(hi))
    del logits
    out["prefill"] = first
    parts["prefill_checked"] = time.time() - t0
    t0 = time.time()
    steady = lm_mod.run_prefill(model, 1, prefill_len, seed=1, report=report)
    del steady["logits"]
    out["prefill_steady"] = steady
    parts["prefill_steady"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    out["decode_finite"] = True
    for key in ("decode", "decode_steady"):
        d = lm_mod.run_decode(model, MOE_DECODE_BATCH, dec.seq_len,
                              LM_DECODE_STEPS, seed=2, report=report)
        out["decode_finite"] &= bool(torch.isfinite(d.pop("logits")).all())
        out["cache_gb"] = sum(
            t.numel() * t.element_size() for t in
            _cache_leaves(d.pop("cache"))) / 1e9
        out[key] = d
    torch.cuda.empty_cache()
    parts["decode"] = time.time() - t0
    t0 = time.time()
    # nothing drops at capacity_factor E / k (C >= T on both paths)
    cf = mc.n_experts / mc.top_k
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=cf))
    try:
        c = _consistency(model, MOE_CONSIST_TOKENS, seed=3)
    finally:
        model.cfg = cfg
    out["consist_cf"] = cf
    out["consist_err"], out["consist_scale"] = c["err"], c["scale"]
    parts["consistency"] = time.time() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cache_leaves(tree) -> list:
    """The tensors of a nested cache."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _cache_leaves(v)]
    return [tree]


def bound(flops: float, nbytes: float) -> dict:
    """Least time on the card (``repro_torch.launch.roofline.bound``: the
    H100's data-sheet peaks)."""
    from repro_torch.launch import roofline
    return roofline.bound(flops, nbytes)


def small_input_check() -> float:
    """fcn3_smoke on the card: kernel path vs the reference path."""
    import dataclasses
    import torch
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.kernels.config import KernelConfig
    outs = []
    for mode in ("kernel", "reference"):
        cfg = dataclasses.replace(cfgs.fcn3_smoke(),
                                  kernels=KernelConfig(mode, mode))
        model = FCN3(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(3))
        g = torch.Generator(device="cuda").manual_seed(4)
        state = torch.randn((2, cfg.n_state, cfg.nlat, cfg.nlon),
                            generator=g, device="cuda")
        cond = torch.randn((2, cfg.n_cond_in, cfg.nlat, cfg.nlon),
                           generator=g, device="cuda")
        with torch.inference_mode():
            outs.append(model(model.make_buffers(), state, cond))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    return float((outs[0] - outs[1]).abs().max())


def small_gradient_check() -> float:
    """One fcn3_smoke train step's gradients on the card: kernel path vs
    the reference path, from the same init, batch and noise draws."""
    import dataclasses
    import torch
    from repro_torch.configs import fcn3 as cfgs
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.kernels.config import KernelConfig
    from repro_torch.train import trainer as trlib
    grads = []
    for mode in ("kernel", "reference"):
        cfg = dataclasses.replace(cfgs.fcn3_smoke(),
                                  kernels=KernelConfig(mode, mode))
        model = FCN3(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(5))
        tr = trlib.EnsembleTrainer(
            model, trlib.TrainConfig(ensemble_size=2, rollout_steps=2,
                                     fair_crps=True, noise_centering=True),
            cfgs.channel_weights(cfg.n_levels))
        batch = next(iter(dlib.Loader(dlib.SyntheticERA5(cfg, "cuda"),
                                      global_batch=1, rollout=2)))
        buffers = dict(model.make_buffers(), **tr.make_loss_buffers())
        _, _, g = tr.loss_and_grads(
            buffers, batch,
            GeneratorNoise(torch.Generator(device="cuda").manual_seed(6)))
        grads.append(g)
    worst = 0.0
    for name, gk in grads[0].items():
        gr = grads[1][name]
        torch.testing.assert_close(gk, gr, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda m, n=name: f"{n}: {m}")
        worst = max(worst, float((gk - gr).abs().max()))
    return worst


def _timed_blocks(blocks) -> tuple[list, list[float]]:
    """Drain a result stream; the host seconds per lead of each block
    (synced at each block)."""
    import torch
    out, per_lead = [], []
    torch.cuda.synchronize()
    t = time.time()
    for block in blocks:
        torch.cuda.synchronize()
        now = time.time()
        first = block[0] if isinstance(block, list) else block
        per_lead += [(now - t) / len(first.lead_steps)] * len(
            first.lead_steps)
        out.append(block)
        t = now
    return out, per_lead


def _gemm_profile(eng, buffers, state0, aux, noise) -> dict:
    """One bf16 lead under ``torch.profiler`` (the GEMM kernels by device
    time) and a dispatch hook (every product's operand dtypes)."""
    import collections
    import torch
    from repro_torch.runtime import ProductDtypes
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof, ProductDtypes() as products:
        eng.forecast(buffers, state0, aux, noise, steps=1)
        torch.cuda.synchronize()
    gemms = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        low = e.name.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "gemm" in low or "xmma" in low):
            gemms[e.name][0] += 1
            gemms[e.name][1] += e.time_range.elapsed_us() / 1e3
    return {"gemms": sorted(gemms.items(), key=lambda kv: -kv[1][1]),
            "products": dict(products.counts)}


def engine_phase(run, report) -> dict:
    """The forecast engine's remaining paths at fcn3_full on the serve
    phase's model: coalesced requests (E1), the bf16 policy (E2) and bred
    init (E3).  Raises on any failed check; returns the numbers the
    ``[engine]`` lines print."""
    import numpy as np
    import torch
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference import perturbations as perturblib
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              members_noise)
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    model, ds, buffers = run.model, run.ds, run.buffers
    grid, static = ds.grid, ds.static_aux

    def aux(n):
        # host fields, as a deployment reads them: staged through pinned
        # memory and the engine's copy stream
        cz = dlib.cos_zenith_angle(grid.colat, grid.lons, 6.0 * (n + 1))
        return np.concatenate([static, cz[None].astype(np.float32)])

    def truth_of(sample):
        return lambda n: ds.state(sample, n + 1)

    out: dict = {}
    state0s = [ds.state(s, 0) for s in ENGINE_SAMPLES]
    truths = [truth_of(s) for s in ENGINE_SAMPLES]

    # -- E1: two coalesced requests against request 0 alone --------------
    pcfg = perturblib.PerturbationConfig(kind="obs", amplitude=0.05)
    t0 = time.time()
    pert = perturblib.InitialConditionPerturbation.from_dataset(
        model.in_sht, pcfg, ds)
    eng = ForecastEngine(model, EngineConfig(
        members=ENGINE_MEMBERS, lead_chunk=2, perturb=pcfg, spectra=True),
        perturbation=pert)
    eng.spectral_wpct   # the spectra's 1.5 GB table, built once
    torch.cuda.synchronize()
    out["e1_setup_s"] = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    blocks, out["batched_lead_s"] = _timed_blocks(eng.stream_batched(
        buffers, state0s, [aux, aux],
        [members_noise(model, 11), members_noise(model, 12)],
        steps=ENGINE_LEADS, truths=truths))
    out["batched_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["batched_stats"] = eng.dispatch_stats()
    batched = [[b[r] for b in blocks] for r in range(2)]
    torch.cuda.reset_peak_memory_stats()
    serial, out["serial_lead_s"] = _timed_blocks(eng.stream(
        buffers, state0s[0], aux, members_noise(model, 11),
        steps=ENGINE_LEADS, truth=truths[0]))
    out["serial_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    got, want = batched[0][-1], serial[-1]
    worst = {"state": errors(got.final_state, want.final_state)[0]}
    torch.testing.assert_close(got.final_state, want.final_state,
                               rtol=STATE_RTOL, atol=STATE_ATOL)
    for name in want.scores:
        g = torch.cat([b.scores[name] for b in batched[0]])
        w = torch.cat([b.scores[name] for b in serial])
        atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
        torch.testing.assert_close(g, w, rtol=SCORE_RTOL, atol=atol,
                                   msg=lambda m, n=name: f"{n}: {m}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"E1 score {name} not finite")
        worst[name] = errors(g, w)[0]
    out["e1_worst"] = worst
    # the counts were set to 0 just before the phase: E1's launches
    out["e1_launches"] = {"disco_band_contract": disco_ops.launches,
                          "legendre_contract": legendre_ops.launches}
    spec = torch.cat([b.scores["spectrum"] for b in batched[1]])
    if tuple(spec.shape) != (ENGINE_LEADS, model.cfg.n_state,
                             model.in_sht.lmax):
        raise AssertionError(f"spectrum shape {tuple(spec.shape)}")
    if not torch.isfinite(batched[1][-1].final_state).all():
        raise AssertionError("E1 request 1's final state is not finite")
    del blocks, batched, serial, got, want, eng, pert
    gc.collect()
    torch.cuda.empty_cache()

    # -- E2: the bf16 policy against fp32, from the same draws ------------
    finals = {}
    for dt in ("float32", "bfloat16"):
        eng = ForecastEngine(model, EngineConfig(
            members=ENGINE_MEMBERS, lead_chunk=1, compute_dtype=dt))
        torch.cuda.reset_peak_memory_stats()
        res, out[f"{dt}_lead_s"] = _timed_blocks(eng.stream(
            buffers, state0s[0], aux, members_noise(model, 21),
            steps=ENGINE_LEADS, truth=truths[0]))
        out[f"{dt}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        finals[dt] = res[-1].final_state
        for block in res:
            for name, v in block.scores.items():
                if v.dtype != torch.float32 or not torch.isfinite(v).all():
                    raise AssertionError(f"E2 {dt} score {name}: {v.dtype}, "
                                         "not fp32 and finite")
        if dt == "bfloat16":
            out["profile"] = _gemm_profile(eng, buffers, state0s[0], aux,
                                           members_noise(model, 22))
        del res, eng
    if finals["bfloat16"].dtype != torch.bfloat16:
        raise AssertionError(f"bf16 final state is "
                             f"{finals['bfloat16'].dtype}")
    out["bf16_vs_fp32"] = float((finals["bfloat16"].float()
                                 - finals["float32"]).abs().max())
    if not out["bf16_vs_fp32"] < BF16_BAR:
        raise AssertionError(f"bf16 final state {out['bf16_vs_fp32']:.3f} "
                             f"from fp32 (bar {BF16_BAR})")
    bf16_products = [k for k in out["profile"]["products"]
                     if "bfloat16" in k[1]]
    if bf16_products:
        raise AssertionError(f"a product took a bf16 operand: "
                             f"{bf16_products}")
    del finals
    gc.collect()
    torch.cuda.empty_cache()

    # -- E3: bred init, ensemble transform, one lead ----------------------
    pcfg = perturblib.PerturbationConfig(kind="bred",
                                         ensemble_transform=True)
    pert = perturblib.InitialConditionPerturbation.from_dataset(
        model.in_sht, pcfg, ds)
    eng = ForecastEngine(model, EngineConfig(members=4, lead_chunk=1,
                                             perturb=pcfg),
                         perturbation=pert)
    s0 = torch.as_tensor(state0s[0]).cuda().float()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.time()
    with torch.inference_mode():
        members, _ = eng.init_carry(s0, members_noise(model, 31), buffers,
                                    torch.from_numpy(aux(0)).cuda())
    torch.cuda.synchronize()
    out["bred_init_s"] = time.time() - t
    # one lead through the engine (its first block makes the members again)
    res, lead_s = _timed_blocks(eng.stream(
        buffers, state0s[0], aux, members_noise(model, 31), steps=1,
        truth=truths[0]))
    out["bred_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["bred_lead_s"] = [lead_s[0] - out["bred_init_s"]]
    pair_err = float(((members[0::2] + members[1::2]) / 2 - s0).abs().max())
    out["bred_pair_rel"] = pair_err / float(s0.abs().max())
    p = members[0::2] - s0
    out["bred_cosine"] = float(torch.nn.functional.cosine_similarity(
        p[0].flatten(), p[1].flatten(), dim=0))
    # the transform on its own: its output's Gram matrix in the
    # area-weighted inner product, formed here from the output
    q = pert.orthogonalize(p)
    w = pert.area_weights / pert.area_weights.sum()
    flat = (q * w.sqrt()).reshape(q.shape[0], -1)
    out["bred_gram_err"] = float((flat @ flat.T - torch.eye(
        q.shape[0], device=q.device)).abs().max())
    out["bred_crps"] = float(res[-1].scores["crps"].mean())
    if not out["bred_pair_rel"] <= PAIR_TOL:
        raise AssertionError(f"bred pairs off state0: {out['bred_pair_rel']}")
    if not out["bred_gram_err"] <= ORTHO_TOL:
        raise AssertionError(f"transformed draws not orthonormal: "
                             f"{out['bred_gram_err']}")
    if not torch.isfinite(res[-1].final_state).all():
        raise AssertionError("E3 final state is not finite")
    return out


def _geometry_caches_cleared() -> None:
    """Empty the port's plan and table caches and its installed plans, as
    a fresh process has them."""
    from repro_torch.core.sphere import disco as discolib
    from repro_torch.core.sphere import legendre as leg
    discolib._cached_plan.cache_clear()
    discolib._PLAN_OVERRIDES.clear()
    leg._cached_table.cache_clear()
    leg._TABLE_OVERRIDES.clear()


def _build_plans(config: str) -> float:
    """Seconds to build the geometry plans a bundle installs instead: the
    three DISCO plans (psi and banded split) and the two Legendre tables
    of ``config``, from empty caches."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    from repro_torch.core.sphere import disco as discolib
    from repro_torch.core.sphere import legendre as leg
    _geometry_caches_cleared()
    t0 = time.time()
    geo = fcn3.geometry(fcn3cfg.NAMED_CONFIGS[config]())
    for name in ("enc", "latent", "dec"):
        discolib.make_disco_plan(*geo[name]).banded_split()
    for sht in (geo["in_sht"], geo["latent_sht"]):
        leg.cached_legendre_table(sht.lmax, sht.mmax, sht.grid.colat)
    return time.time() - t0


def service_phase(report, config: str = "full", device: str = "cuda",
                  guard: PlainGuard | None = None) -> dict:
    """The forecast service at ``config``: pack a warm-start bundle, boot
    a readonly replica from it (no nvcc), serve R1 alone and then R2 with
    R3 coalesced over HTTP, and hold them to direct engines on the
    replica's model.  Raises on any failed check; returns the numbers the
    ``[service]`` lines print.  The launch counters and ``guard``'s
    counts are set to 0 when the replica has booted and read when the
    last served request has ended (``launches``, ``plain``); the boot's
    own (the model's calibration) are ``boot_launches``/``boot_plain``,
    and the pack's plain calls ``pack_plain``."""
    import tempfile
    import threading

    import numpy as np
    import torch
    from repro_torch.inference.engine import ForecastEngine, members_noise
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.serving import bundle as bundlelib
    from repro_torch.serving.client import ForecastClient
    from repro_torch.serving.scheduler import ModelPool
    from repro_torch.serving.service import ForecastService
    from repro_torch.serving.spec import RequestSpec
    from repro_torch.telemetry import parse_prometheus, prom_value

    def counts() -> tuple[dict, dict]:
        """(launches, plain calls on CUDA tensors) since the last reset."""
        return ({"disco_band_contract": disco_ops.launches,
                 "legendre_contract": legendre_ops.launches},
                dict(guard.counts) if guard is not None else {})

    def reset_counts() -> None:
        disco_ops.reset_launches()
        legendre_ops.reset_launches()
        if guard is not None:
            guard.counts = dict.fromkeys(guard.counts, 0)

    cuda = torch.device(device).type == "cuda"
    base = dict(SERVICE_SPEC, config=config)
    # R1 opts out of coalescing: it runs alone without waiting out the
    # batch window for a companion
    specs = [RequestSpec(**base, sample=sm, seed=sd, coalesce=i > 0)
             for i, (sm, sd) in enumerate(SERVICE_REQUESTS)]
    out: dict = {"plans_build_s": _build_plans(config)}
    reset_counts()
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="service-bundle-",
                                     dir=root) as tmp:
        # -- pack: the serial and the batch-2 keys ------------------------
        t0 = time.time()
        path = bundlelib.pack([RequestSpec(**base)], out=f"{tmp}/bundle",
                              max_batch=2, device=device)
        out["pack_s"] = time.time() - t0
        manifest = bundlelib.WarmStartBundle.load(path).manifest
        files = manifest["files"]
        out["tunings"] = len(manifest["tunings"])
        # the libraries in blobs/: the manifest names a variant's defines
        listed = {lib["file"]: (lib["name"],
                                tuple(tuple(d) for d in lib["defines"]))
                  for lib in manifest["libraries"]}
        packed = [listed.get(f, (Path(f).name[3:].rpartition("-")[0], ()))
                  for f in sorted(files) if f.startswith("blobs/")]
        out["bundle"] = {
            kind: (len([f for f in files if f.startswith(kind)]),
                   sum(v["bytes"] for f, v in files.items()
                       if f.startswith(kind)))
            for kind in ("plans/", "blobs/")}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # -- boot a readonly replica, as a fresh process would -----------
        _geometry_caches_cleared()
        build.reset_registry()
        nvcc_before = build.nvcc_runs
        _, out["pack_plain"] = counts()
        reset_counts()
        t0 = time.time()
        pool = ModelPool(device=device)
        sched = bundlelib.boot_scheduler(
            path, pool=pool, max_concurrency=1, max_batch=2,
            batch_window_ms=SERVICE_WINDOW_MS)
        out["boot_s"] = time.time() - t0
        out["nvcc_during_boot"] = build.nvcc_runs - nvcc_before
        out["boot_launches"], out["boot_plain"] = counts()
        reset_counts()
        out["libraries"] = {build.label(*lib): build.is_loaded(*lib) and (
            Path(build.library_path(*lib)).parent == Path(path, "blobs"))
            for lib in packed}
        try:
            srv = ForecastService(scheduler=sched).make_server(
                "127.0.0.1", 0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                client = ForecastClient(port=srv.server_address[1],
                                        timeout=SERVICE_TIMEOUT_S)
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                served = [client.forecast(specs[0])]
                pair: list = [None, None]

                def one(i):
                    pair[i] = client.forecast(specs[1 + i])

                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(SERVICE_TIMEOUT_S)
                if any(t.is_alive() for t in threads) or None in pair:
                    raise AssertionError("a coalesced request did not end")
                served += pair
                out["serve_s"] = time.time() - t0
                out["launches"], out["plain"] = counts()
                out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                  if cuda else 0.0)
                stats = client.stats()
                metrics = parse_prometheus(client.metrics())
            finally:
                t0 = time.time()
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=60)
        finally:
            sched.close(timeout=120)
            out["close_s"] = time.time() - t0
        out["info"] = sched.bundle_info
    out["stats"] = stats
    out["served"] = served
    out["blocks"] = (specs[0].engine_config().kernels.blocks
                     if specs[0].engine_config().kernels else ())
    # -- checks -------------------------------------------------------------
    active = autotune.active_tuning_cache()
    if active is not None and (out["info"]["tunings"] != out["tunings"]
                               or active.stats()["entries"]
                               != out["tunings"]):
        raise AssertionError(f"the bundle packed {out['tunings']} tunings, "
                             f"the replica installed "
                             f"{out['info']['tunings']}")
    if out["nvcc_during_boot"]:
        raise AssertionError(f"nvcc ran {out['nvcc_during_boot']} time(s) "
                             "during the bundle boot")
    if cuda and not (out["libraries"] and all(out["libraries"].values())):
        raise AssertionError(f"kernel libraries not loaded from the bundle:"
                             f" {out['libraries']}")
    if stats["batches"].get("2") != 1:
        raise AssertionError(f"want one coalesced batch of 2, got "
                             f"{stats['batches']}")
    cache = stats["cache"]
    if not (cache["readonly"] and cache["misses"] == 0
            and stats["bundle"]):
        raise AssertionError(f"the replica's cache: {cache}, bundle "
                             f"{stats['bundle']}")
    for name, want in (("requests_served_total", stats["served"]),
                       ("cache_misses_total", 0),
                       ("batches_total", 1)):
        labels = {"size": "2"} if name == "batches_total" else {}
        got = prom_value(metrics, f"fcn3_serving_{name}", **labels)
        if got != want:
            raise AssertionError(f"/metrics {name} = {got}, want {want}")
    for spec, res in zip(specs, served):
        if res.timing["compile_s"] != 0.0:
            raise AssertionError(f"request {res.request_id} warmed a key: "
                                 f"compile_s={res.timing['compile_s']}")
        for name, v in res.scores.items():
            if not np.isfinite(v).all() or v.shape[0] != spec.lead_steps:
                raise AssertionError(f"{res.request_id} score {name}: "
                                     f"{v.shape}, not finite")
    if [r.batch_size for r in served] != [1, 2, 2]:
        raise AssertionError(f"batch sizes {[r.batch_size for r in served]}")
    # -- direct engines on the replica's model ----------------------------
    t0 = time.time()
    b = pool.get(config)
    direct = []
    for spec in specs:
        eng = ForecastEngine(b.model, spec.engine_config())
        direct.append(eng.forecast(
            b.buffers, b.ds.state(spec.sample, 0),
            lambda n: b.ds.aux_fields(6.0 * (n + 1)),
            members_noise(b.model, spec.seed), steps=spec.lead_steps,
            truth=lambda n, sm=spec.sample: b.ds.state(sm, n + 1)))
    want = direct[0]
    if not np.array_equal(served[0].final_state,
                          want.final_state.cpu().numpy()) or not all(
            np.array_equal(served[0].scores[k], v.cpu().numpy())
            for k, v in want.scores.items()):
        raise AssertionError("R1 differs from a direct engine on the "
                             "replica's model and seed")
    worst = {}
    for res, want in zip(served[1:], direct[1:]):
        fs = want.final_state.cpu().numpy()
        np.testing.assert_allclose(res.final_state, fs, rtol=STATE_RTOL,
                                   atol=STATE_ATOL)
        worst["state"] = max(worst.get("state", 0.0),
                             float(np.abs(res.final_state - fs).max()))
        for name, v in want.scores.items():
            v = v.cpu().numpy()
            atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
            np.testing.assert_allclose(res.scores[name], v, rtol=SCORE_RTOL,
                                       atol=atol, err_msg=name)
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(res.scores[name] - v).max()))
    out["coalesced_vs_serial"] = worst
    out["direct_s"] = time.time() - t0
    # the pool's budget: every engine's estimate (one engine here, its
    # serial and batch-2 keys) and the model they share
    out["estimated_bytes"] = sum(e["estimated_bytes"]
                                 for e in stats["engines"])
    out["model_bytes"] = (
        sum(p.nbytes for p in b.model.parameters())
        + sum(t.nbytes for part in b.buffers.values() for t in part.values()))
    if cuda and not out["peak_gb"] < 80:
        raise AssertionError(f"service peak {out['peak_gb']:.2f} GB")
    if cuda and (out["estimated_bytes"] + out["model_bytes"]) / 1e9 < \
            out["peak_gb"]:
        raise AssertionError(
            f"estimated_bytes {out['estimated_bytes'] / 1e9:.3f} GB + model "
            f"{out['model_bytes'] / 1e9:.3f} GB is under the measured peak "
            f"{out['peak_gb']:.3f} GB")
    for window, plain in (("pack", out["pack_plain"]),
                          ("boot", out["boot_plain"]),
                          ("served requests", out["plain"])):
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on CUDA tensors in "
                                 f"the service's {window}: {plain}")
    for name, n in out["launches"].items():
        if cuda and n <= 0:
            raise AssertionError(f"{name} never launched in the served "
                                 "requests")
    del direct, b, pool
    return out


def evaluate_phase(report, ckpt: str, guard) -> dict:
    """Phase 2d: ``launch/evaluate.py`` at ``CONFIG`` from [main]'s
    parameters (``ckpt``), with both forecast kernels' counts and the
    plain guard set to 0 just before and read just after; its seconds,
    the seconds of each initial condition (from its own lines), peak,
    launches, plain calls on CUDA tensors, and whether every table entry
    is finite."""
    import re
    import numpy as np
    import torch
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import evaluate
    ic_done = []

    def rep(line: str) -> None:
        line = line.strip()
        if line:
            report(line if line.startswith("[") else f"[evaluate] {line}")
        m = re.match(r"\[evaluate\] ic \d+/\d+ \(([\d.]+)s\)", line)
        if m:
            ic_done.append(float(m.group(1)))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    guard.counts = dict.fromkeys(guard.counts, 0)
    t0 = time.time()
    results = evaluate.main(
        ["--config", CONFIG, "--ckpt", ckpt, "--members", str(EVAL_MEMBERS),
         "--lead-steps", str(EVAL_LEADS), "--initial-conditions",
         str(EVAL_ICS)], report=rep)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    return {"seconds": seconds, "setup_s": seconds - ic_done[-1],
            "ic_s": [b - a for a, b in zip([0.0] + ic_done[:-1], ic_done)],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {"disco_band_contract": disco_ops.launches,
                         "legendre_contract": legendre_ops.launches},
            "plain": dict(guard.counts),
            "finite": all(np.isfinite(np.asarray(v, np.float64)).all()
                          for lead in results.values()
                          for v in lead.values()),
            "entries": sum(np.size(v) for lead in results.values()
                           for v in lead.values())}


def train_phase(report, keep: str | None = None, steps_done=None) -> dict:
    """The fcn3_full training path with fresh launch counts; returns the
    summary the ``[train]`` lines print.  ``steps_done()`` is called once
    the timed steps are over.  With ``keep`` (a directory), the initial
    parameters are checkpointed there and, after the timed steps, the
    first step is taken again (``step0``), for the distributed phase."""
    import torch
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.train import checkpoint as ckptlib
    torch.cuda.reset_peak_memory_stats()
    for mod in (disco_ops, legendre_ops, crps_ops):
        mod.reset_launches()
    t0 = time.time()
    run = train_mod.setup(CONFIG, TRAIN_STAGE, TRAIN_BATCH, TRAIN_ENSEMBLE,
                          TRAIN_ROLLOUT, seed=0, device="cuda",
                          calibration_rounds=TRAIN_CALIBRATION_ROUNDS,
                          report=report)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    before = {k: p.detach().cpu().clone()
              for k, p in run.model.named_parameters()}
    step0 = {}
    if keep is not None:
        step0["ckpt"] = ckptlib.save_checkpoint(
            keep, 0, dict(run.model.named_parameters()))
    stamps, snaps = [time.time()], [launch_counts()]
    history = train_mod.run_steps(
        run, TRAIN_STEPS,
        report=lambda line: (stamps.append(time.time()),
                             snaps.append(launch_counts()), report(line)))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"disco_band_contract": disco_ops.launches,
                "disco_band_transpose": disco_ops.transpose_launches,
                "legendre_contract": legendre_ops.launches,
                "crps_fused": crps_ops.launches,
                "crps_fused_bwd": crps_ops.bwd_launches}
    changed = sum(int(not torch.equal(p.detach().cpu(), before[k]))
                  for k, p in run.model.named_parameters())
    n_params = len(before)
    if steps_done is not None:
        steps_done()
    if keep is not None:
        step0.update(_first_step_again(run, before))
        report(f"[train] step 0 again from the initial parameters, outside "
               f"the timed steps: loss={step0['loss']:.7f} (the timed step "
               f"{history[0]['loss']:.7f})")
    del run, before
    return {"setup_s": setup_s, "step0": step0,
            "step_s": [b - a for a, b in zip(stamps[:-1], stamps[1:])],
            "peak_mem_gb": peak_gb,
            "launches": launches, "history": history,
            "step_launches": _launched(snaps[-2], snaps[-1]),
            "changed": changed, "n_params": n_params}


def _first_step_again(run, params: dict) -> dict:
    """The first training step's loss and gradients (to the host) again:
    the initial ``params`` loaded back, the loader's first training batch
    (its second: the first calibrates) and ``run_steps``' draws for step
    0; before it, the eval step on the same parameters and batch ((d4)'s
    reference).  With the shares of near-ties (within TIE_REL of each
    other) of the step's two members, and of member 0 and the truth: where
    the fair CRPS's gradient takes the sign of a rounding error."""
    import torch
    from repro_torch.core import crps as crpslib
    from repro_torch.inference.engine import GeneratorNoise
    with torch.no_grad():
        for k, p in run.model.named_parameters():
            p.copy_(params[k])
    it = iter(run.batches)
    next(it)
    batch = next(it)
    # (d4)'s single-process side: the eval step on the initial parameters
    # and this batch, from DOMAIN_EVAL_SEED's draws
    t0 = time.time()
    gen = torch.Generator(device=run.model.device)
    gen.manual_seed(DOMAIN_EVAL_SEED)
    ev = run.trainer.eval_step(run.buffers, batch, GeneratorNoise(gen),
                               n_members=DOMAIN_EVAL_MEMBERS)
    ev = {k: float(v) for k, v in ev.items()}
    eval_s = time.time() - t0
    gen = torch.Generator(device=run.model.device)
    gen.manual_seed(1000)
    objective, ties = crpslib.fcn3_objective, []

    def count_ties(ens, obs, *args):
        with torch.no_grad():
            u0, u1 = ens[0].detach(), ens[1].detach()
            ties.append((
                float(((u0 - u1).abs() <= TIE_REL * torch.maximum(
                    u0.abs(), u1.abs())).float().mean()),
                float(((u0 - obs).abs() <= TIE_REL
                       * obs.abs()).float().mean())))
        return objective(ens, obs, *args)
    crpslib.fcn3_objective = count_ties
    try:
        loss, _, grads = run.trainer.loss_and_grads(
            run.buffers, batch, GeneratorNoise(gen))
    finally:
        crpslib.fcn3_objective = objective
    return {"loss": float(loss), "ties": ties[0],
            "grads": {k: g.cpu() for k, g in grads.items()},
            "eval": ev, "eval_s": eval_s}


def _plan_payloads(names: tuple[str, ...], shts: tuple[str, ...],
                   path: str) -> float:
    """Pickle the export payloads of the fcn3_full DISCO plans ``names``
    and Legendre tables ``shts`` (from this process's caches) to
    ``path``, so that ranks install them instead of building them;
    returns the bytes written."""
    import pickle
    import numpy as np
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    from repro_torch.core.sphere import disco as discolib
    from repro_torch.core.sphere import legendre as leg
    geo = fcn3.geometry(fcn3cfg.NAMED_CONFIGS[CONFIG]())
    payloads = [{"kind": "disco",
                 **discolib.export_plan(discolib.make_disco_plan(*geo[n]))}
                for n in names]
    for n in shts:
        t = geo[n]
        colat = np.ascontiguousarray(t.grid.colat, np.float64)
        payloads.append({"kind": "legendre", "lmax": t.lmax,
                         "mmax": t.mmax, "colat": colat,
                         "table": leg.cached_legendre_table(t.lmax, t.mmax,
                                                            colat)})
    with open(path, "wb") as f:
        pickle.dump(payloads, f, protocol=5)
    return Path(path).stat().st_size


#: the payload files installed in this process
_INSTALLED: set = set()


def _install_payloads(path: str) -> None:
    """Install ``_plan_payloads``' plans and tables in this process, as a
    replica installs a bundle's (once a file: a world's later parts find
    them installed)."""
    import pickle
    from repro_torch.serving.bundle import _install_plan_payload
    if path in _INSTALLED:
        return
    with open(path, "rb") as f:
        for p in pickle.load(f):
            _install_plan_payload(p)
    _INSTALLED.add(path)


def _replicas_equal(tensors) -> bool:
    """Whether this rank's tensors equal rank 0's bit for bit (rank 0's
    broadcast a bucket at a time)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compat import buckets
    equal = True
    for _, flat in buckets(tensors):
        ref = flat.clone()
        dist.broadcast(ref, 0)
        equal &= torch.equal(flat, ref)
    return equal


def then_parts(rank: int, world_size: int, then) -> dict:
    """A world's follow-on parts on this rank, after its own part's state
    is freed (a world's start costs 15-35 s of the script's time): each
    (key, fn, args) of ``then`` runs as ``fn(rank, world_size, *args)``,
    its result and seconds under ``key``."""
    import torch
    out = {}
    for key, fn, args in then:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        out[key] = {"result": fn(rank, world_size, *args),
                    "seconds": time.time() - t0}
    return out


def run_world_then(fn, ranks: int, args: tuple, then=(), **kw
                   ) -> tuple[list, dict, float]:
    """``run_world`` of ``fn(rank, world_size, *args, then)``: the ranks'
    own results, each follow-on's (results in rank order, seconds of its
    slowest rank) by key, and the world's seconds less the follow-ons'."""
    from repro_torch.distributed.world import run_world
    t0 = time.time()
    res = run_world(fn, ranks, (*args, tuple(then)), **kw)
    own_s = time.time() - t0
    parts = {}
    for key, _, _ in then:
        got = [r["then"][key] for r in res]
        parts[key] = ([g["result"] for g in got],
                      max(g["seconds"] for g in got))
        own_s -= parts[key][1]
    for r in res:
        del r["then"]
    return res, parts, own_s


def dist_geometry_rank(rank: int, world_size: int, plans: str,
                       then=()) -> dict:
    """Phase (b), on one rank of the (lat, lon) mesh: Algorithms 1 and 2
    at the fcn3_full latent with the Legendre and band kernels inside,
    against the single-process kernel path, and the band kernel on this
    rank's masked band against its plain version; then the world's
    follow-on parts ``then`` (``then_parts``)."""
    import torch
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    from repro_torch.core.sphere import disco as discolib
    from repro_torch.distributed import compat, dist_disco, dist_sht
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.disco.ref import disco_gather_band_contract_ref
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.kernels.legendre.ref import legendre_contract_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import set_precision
    set_precision()
    t0 = time.time()
    _install_payloads(plans)
    cfg = fcn3cfg.NAMED_CONFIGS[CONFIG]()
    geo = fcn3.geometry(cfg)
    plan, t = discolib.make_disco_plan(*geo["latent"]), geo["latent_sht"]
    mesh = make_mesh(DIST_GRID, ("lat", "lon"), "cuda")
    la, lo = mesh.get_coordinate()
    lat_g, lon_g = mesh.get_group("lat"), mesh.get_group("lon")
    dev = torch.device("cuda")
    h, w = t.grid.nlat, t.grid.nlon
    hl, wl = h // DIST_GRID[0], w // DIST_GRID[1]
    m0, m1 = dist_sht.order_block(t.mmax, DIST_GRID[1], lo)
    local_sht = dist_sht.local_sht_buffers(t, m0, m1, dev)
    local_band = dist_disco.local_band_buffers(plan, la, DIST_GRID[0], dev)
    x = torch.randn((1, DIST_CHANNELS, h, w), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(17))
    xb = x[..., la * hl:(la + 1) * hl, lo * wl:(lo + 1) * wl].contiguous()
    setup_s = time.time() - t0
    guard = PlainGuard()
    legendre_ops.reset_launches()
    disco_ops.reset_launches()
    compat.start_timing()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    c = dist_sht.dist_sht_forward(xb, local_sht, t.mmax, lat_g, lon_g)
    u = dist_sht.dist_sht_inverse(c, local_sht, w, lat_g, lon_g)
    torch.cuda.synchronize()
    sht_s = time.time() - t0
    d = dist_disco.dist_disco_conv(xb, local_band, plan.stride, lat_g, lon_g)
    torch.cuda.synchronize()
    out = {"coord": (la, lo), "setup_s": setup_s, "sht_s": sht_s,
           "disco_s": time.time() - t0 - sht_s,
           "collective_s": compat.timed_seconds(),
           "launches": {"legendre_contract": legendre_ops.launches,
                        "disco_band_contract": disco_ops.launches},
           "plain": sum(guard.counts.values()),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "live_taps": (int(local_band["tap_ent"].shape[0]),
                         int(plan.live_taps()["tap_ent"].shape[0]))}
    guard.close()
    # the single-process kernel path on the whole field, this rank's block
    bufs = t.buffers(dev)
    c_ref = dispatch.sht_forward(x, bufs["wpct"], bufs["wpct_ext"])
    u_ref = dispatch.sht_inverse(c_ref, bufs["pct"], w, bufs["pct_ext"])
    c_ref = c_ref[..., la * hl:(la + 1) * hl, m0:m1]
    u_ref = u_ref[..., la * hl:(la + 1) * hl, lo * wl:(lo + 1) * wl]
    out["sht_forward"] = errors(c, c_ref)[1]
    out["sht_inverse"] = errors(u, u_ref)[1]
    del c, u, c_ref, u_ref, bufs
    d_ref = dispatch.disco_conv_banded_buffers(x, plan.banded_buffers(dev),
                                               plan.stride)
    out["disco"] = errors(d, d_ref[..., la * hl:(la + 1) * hl,
                                   lo * wl:(lo + 1) * wl])[1]
    del d, d_ref
    # the band kernel on the masked band at the planes dist_disco_conv
    # hands it (this rank's channel block after the longitude all-to-all,
    # its input rows, every longitude), against its plain version a chunk
    # of planes at a time
    cw = DIST_CHANNELS // DIST_GRID[1]
    xm = x[0, lo * cw:(lo + 1) * cw, la * hl:(la + 1) * hl].contiguous()
    taps = disco_ops.LiveTaps.of(local_band)
    got = disco_ops.disco_band_contract(xm, local_band["psi_band"],
                                        local_band["lat_idx"], taps, 1)
    err, top = 0.0, 0.0
    for i in range(0, cw, 46):
        ref = disco_gather_band_contract_ref(
            xm[i:i + 46], local_band["psi_band"], local_band["lat_idx"], 1)
        err = max(err, float((got[i:i + 46] - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    out["masked_band"] = err / top
    out["masked_band_shape"] = tuple(xm.shape)
    del xm, got, ref
    # the Legendre kernel on this rank's order-sliced tables with the
    # extents of the slice, at the shapes dist_sht gives it (this rank's
    # channel block after the latitude all-to-all, every latitude or
    # degree, its orders), against its plain version
    gen = torch.Generator(device=dev).manual_seed(18)
    ch = DIST_CHANNELS // DIST_GRID[0]
    for name, table, ext in (
            ("legendre_forward", local_sht["wpct"], local_sht["wpct_ext"]),
            ("legendre_inverse", local_sht["pct"].permute(1, 0, 2),
             dispatch.transposed_extents(local_sht["pct_ext"]))):
        k, _, mloc = table.shape
        xc = torch.complex(*(torch.randn((ch, k, mloc), device=dev,
                                         generator=gen) for _ in range(2)))
        out[name] = errors(dispatch.legendre(xc, table, ext),
                           legendre_contract_ref(xc, table))[1]
    out["legendre_shape"] = (ch, k, mloc)
    del xc
    out["gloo_cuda"] = _collective_probe(
        lat_g, (1, cw, 1, h, w), dev)
    del x, xb, local_sht, local_band
    out["then"] = then_parts(rank, world_size, then)
    return out


def _collective_probe(group, shape, dev) -> dict:
    """Which collectives the process group takes on CUDA tensors
    (``"ok"``, or the first line of what it raises), and the median
    seconds of three calls, each, of ``compat.psum_scatter`` (all-to-all
    plus a local sum) and of ``reduce_scatter_tensor`` (where it is
    taken) over dim -2 of ``shape``, with their max abs difference."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat
    r = dist.get_world_size(group)
    small = torch.arange(4.0 * r, device=dev)
    ops = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(small), small, group=group),
        "all_reduce": lambda: dist.all_reduce(small.clone(), group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            small.new_empty(4), small, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            small.new_empty(4 * r * r), small, group=group)}
    took = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            took[name] = "ok"
        except Exception as e:  # what the backend refuses is the finding
            took[name] = (str(e).strip().splitlines() or [type(e).__name__]
                          )[0][:200]
    x = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(19))

    def psum_scatter():
        return compat.psum_scatter(x, group, x.dim() - 2)

    def reduce_scatter():
        send = x.movedim(-2, 0).contiguous()
        recv = send.new_empty((send.shape[0] // r,) + send.shape[1:])
        dist.reduce_scatter_tensor(recv, send, group=group)
        return recv.movedim(0, -2)

    fns = {"psum_scatter": psum_scatter}
    if took["reduce_scatter_tensor"] == "ok":
        fns["reduce_scatter_tensor"] = reduce_scatter
    secs: dict = {k: [] for k in fns}
    res = {}
    for _ in range(4):            # the first round warms up
        for k, fn in fns.items():
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = fn()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
    out = {"took": took, "shape": tuple(shape),
           "seconds": {k: statistics.median(v[1:]) for k, v in secs.items()}}
    if len(res) == 2:
        out["max_abs_diff"] = float((res["psum_scatter"]
                                     - res["reduce_scatter_tensor"]).abs()
                                    .max())
    return out


def dist_train_rank(rank: int, world_size: int, plans: str,
                    argv: list[str], then=()) -> dict:
    """Phases (c) and (d1), on one rank: ``launch/train.py``'s CLI with
    ``--mesh-model`` (the process group is this world's); returns its
    step diagnostics, kernel launches, plain calls on CUDA tensors, peak
    memory, whether its parameters equal rank 0's after the step, and
    (rank 0) the first step's reduced gradients; then, with the plans
    installed once and the step's state freed, the world's follow-on
    parts ``then`` (``then_parts``)."""
    import torch
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.train import trainer as trlib
    _install_payloads(plans)
    guard = PlainGuard()
    rec = Recorder()
    for mod in (crps_ops, disco_ops, legendre_ops):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    kept: dict = {}
    grads_of = trlib.EnsembleTrainer.loss_and_grads

    def loss_and_grads(self, *args):
        loss, aux, grads = grads_of(self, *args)
        if "trainer" not in kept:
            # the first step's buffers and batch, for (d4)
            kept["buffers"], kept["batch"] = args[0], args[1]
            # rank 0's reduced gradients to the host (its first step's
            # time grows by the copy; a device copy would raise its peak)
            kept["trainer"] = self
            kept["grads"] = ({k: g.cpu() for k, g in grads.items()}
                             if rank == 0 else None)
        return loss, aux, grads
    trlib.EnsembleTrainer.loss_and_grads = loss_and_grads
    history = train_mod.main(argv)
    torch.cuda.synchronize()
    out = {"history": history,
           "launches": {"disco_band_contract": disco_ops.launches,
                        "disco_band_transpose": disco_ops.transpose_launches,
                        "legendre_contract": legendre_ops.launches,
                        "crps_fused": crps_ops.launches,
                        "crps_fused_bwd": crps_ops.bwd_launches},
           "plain": dict(guard.counts),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           # the band kernels' launches by (psi, stride, operand) shape,
           # and the Legendre kernel's largest operand by table shape and
           # layout (the inverse SHT's table is a transposed view)
           "shapes": {kind: {k: e["launches"] for k, e in ents.items()}
                      for kind, ents in (("disco", rec.disco),
                                         ("transpose", rec.transpose))},
           "legendre": {(tuple(e["table"].shape),
                         e["table"].is_contiguous()): e["shape"]
                        for e in rec.legendre.values()},
           # the CRPS kernels' operand shapes
           "crps": list(rec.crps.values())}
    rec.close()
    dom = kept["trainer"].domain
    if dom is not None:
        out["rows"] = (dom.io_block, dom.lat_block)
        out["eval"] = _domain_eval(kept, argv[argv.index("--init-from") + 1],
                                   guard)
    guard.close()
    model = kept["trainer"].model
    out["params_equal"] = _replicas_equal(
        [p.detach() for p in model.parameters()])
    out["grads"] = kept["grads"]
    # the step's model, trainer, buffers and recorded operands go before
    # the world's next part starts
    del model, rec
    kept.clear()
    trlib.EnsembleTrainer.loss_and_grads = grads_of
    out["then"] = then_parts(rank, world_size, then)
    return out


def _domain_eval(kept: dict, init_from: str, guard) -> dict:
    """(d4), on one rank of (d1) after its steps: the initial parameters
    loaded back and ``eval_step`` (2 members, DOMAIN_EVAL_SEED's draws) on
    the rank's rows of the first step's batch, with the launch counts and
    the plain guard set to 0 just before and read just after; its values,
    seconds, collective seconds, launches, plain calls on CUDA tensors,
    peak and the CRPS kernel's operand shapes."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import train as train_mod
    trainer = kept["trainer"]
    train_mod.load_init(trainer.model, init_from)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(DOMAIN_EVAL_SEED)
    rec = Recorder()
    guard.counts = dict.fromkeys(guard.counts, 0)
    for mod in (crps_ops, disco_ops, legendre_ops):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compat.start_timing()
    t0 = time.time()
    ev = trainer.eval_step(kept["buffers"], kept["batch"], GeneratorNoise(gen),
                           n_members=DOMAIN_EVAL_MEMBERS)
    ev = {k: float(v) for k, v in ev.items()}
    out = {"values": ev, "seconds": time.time() - t0,
           "collective_s": compat.timed_seconds(),
           "launches": {"disco_band_contract": disco_ops.launches,
                        "legendre_contract": legendre_ops.launches,
                        "crps_fused": crps_ops.launches},
           "plain": dict(guard.counts),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "crps": list(rec.crps.values())}
    rec.close()
    return out


def dist_engine_rank(rank: int, world_size: int, plans: str,
                     ckpt: str) -> dict:
    """Phase (e), on one rank: [main]'s scored forecast (its parameters
    from ``ckpt``, its sample, noise seed and leads) through the engine
    with ``member_axes=("model",)`` on a (1, R) mesh, this rank rolling
    its block of the members, with every launch count and the plain guard
    set to 0 just before the rollout and read just after; returns the
    block, each lead's seconds and scores (host copies), the final
    members, the collective seconds, the bytes the score all-to-alls
    received, the peak, the launches, the plain calls on CUDA tensors and
    the CRPS kernel's operand shapes."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.inference.engine import (EngineConfig, ForecastEngine,
                                              members_noise)
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    _install_payloads(plans)
    t0 = time.time()
    run = serve_mod.setup(CONFIG, device="cuda", ckpt=ckpt)
    mesh = make_mesh((1, world_size), ("data", "model"), "cuda")
    eng = ForecastEngine(run.model, EngineConfig(
        members=MEMBERS, lead_chunk=1, member_axes=("model",)), mesh=mesh)
    ds = run.ds
    guard = PlainGuard()
    rec = Recorder()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    for mod in (crps_ops, disco_ops, legendre_ops):
        mod.reset_launches()
    compat.start_timing()
    stamps, scores, final = [time.time()], [], None
    for block in eng.stream(run.buffers, run.state0,
                            lambda n: ds.aux_fields(6.0 * (n + 1)),
                            members_noise(run.model, 7), steps=LEAD_STEPS,
                            truth=lambda n: ds.state(run.sample, n + 1)):
        scores.append({k: v.cpu() for k, v in block.scores.items()})
        stamps.append(time.time())
        if block.final_state is not None:
            final = block.final_state.cpu()
    torch.cuda.synchronize()
    out = {"block": eng.block, "setup_s": setup_s,
           "lead_s": [b - a for a, b in zip(stamps[:-1], stamps[1:])],
           "rollout_s": time.time() - stamps[0],
           "collective_s": compat.timed_seconds(),
           "a2a_bytes": compat.timed_bytes(),
           "kind_bytes": compat.timed_kinds(), "scores": scores,
           "final_state": final,
           "launches": {"disco_band_contract": disco_ops.launches,
                        "legendre_contract": legendre_ops.launches,
                        "crps_fused": crps_ops.launches},
           "plain": dict(guard.counts),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "crps": list(rec.crps.values())}
    rec.close()
    guard.close()
    return out


def _nonzero(kinds: dict) -> dict:
    """A rank's bytes by kind of collective, the kinds it used."""
    return {k: v for k, v in kinds.items() if v}


def _worst(got, want, rtol: float, atol: float) -> tuple[float, float]:
    """Max |got - want| and the worst |diff| / (atol + rtol |want|)."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / (atol + rtol * want.abs())).max())


def engine_dist_phase(report, forecast: dict, plans: str,
                      part: tuple | None = None) -> dict:
    """(e) the engine's ``member_axes``: [main]'s forecast over
    DIST_ENGINE_RANKS ranks, each lead's scores held to [main]'s and each
    rank's final members to [main]'s at the dispatch bar, then the CRPS
    kernel against its plain version at rank 0's operand shapes; raises
    on any failed check.  ``part``: the ranks' results and seconds where
    (e) rode another world."""
    import torch
    from repro_torch.distributed.world import run_world
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    if part is None:
        res = run_world(dist_engine_rank, DIST_ENGINE_RANKS,
                        (plans, forecast["ckpt"]), backend=DIST_BACKEND,
                        timeout=900.0)
        phase_s = time.time() - t0
    else:
        res, phase_s = part
    worst: dict[str, tuple[float, float]] = {}

    def note(name, got, want, rtol, atol):
        err = _worst(got, want, rtol, atol)
        old = worst.get(name, (0.0, 0.0))
        worst[name] = (max(old[0], err[0]), max(old[1], err[1]))

    for i, r in enumerate(res):
        lo, hi = r["block"]
        share = r["collective_s"] / r["rollout_s"]
        report(f"[dist] (e) rank {i}: members [{lo}, {hi}) of {MEMBERS}, "
               f"setup_s={r['setup_s']:.1f} lead_s="
               f"{[round(x, 3) for x in r['lead_s']]} rollout_s="
               f"{r['rollout_s']:.3f} collective_s={r['collective_s']:.3f} "
               f"(share {share:.3f}) score_a2a_bytes={r['a2a_bytes']} "
               f"bytes_by_kind={_nonzero(r['kind_bytes'])} "
               f"({r['a2a_bytes'] / LEAD_STEPS / 1e6:.1f} MB a lead) "
               f"launches={r['launches']} plain_calls_on_cuda={r['plain']} "
               f"peak_mem_gb={r['peak_gb']:.2f}")
        for t, sc in enumerate(r["scores"]):
            for name, v in sc.items():
                atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
                note(name, v[0], forecast["scores"][name][t], SCORE_RTOL,
                     atol)
        note("state", r["final_state"], forecast["final_state"][lo:hi],
             STATE_RTOL, STATE_ATOL)
    report(f"[dist] (e) vs [main], every lead, max_abs_err (worst |diff| / "
           f"(atol + rtol |ref|)): " + " ".join(
               f"{k}={a:.3e} ({w:.3f})" for k, (a, w) in worst.items())
           + f" (state rtol={STATE_RTOL} atol={STATE_ATOL}; scores "
             f"rtol={SCORE_RTOL} atol={SCORE_ATOL}, rank_hist atol="
             f"{STATE_ATOL}); phase {phase_s:.1f} s")
    for i, r in enumerate(res):
        if min(r["launches"].values()) <= 0 or any(r["plain"].values()):
            raise AssertionError(f"(e) rank {i}: launches {r['launches']}, "
                                 f"plain {r['plain']}")
    if set(worst) != {"crps", "ens_rmse", "spread", "ssr", "rank_hist",
                      "state"} or max(w for _, w in worst.values()) > 1.0:
        raise AssertionError(f"(e) disagrees with [main]: {worst}")
    rows = []
    for ent in res[0]["crps"]:
        rows += [dict(row, kernel="crps_fused", path="dist_engine")
                 for row in check_crps(ent)]
    return {"engine_s": phase_s, "engine": [
        {k: v for k, v in r.items() if k not in ("scores", "final_state")}
        for r in res], "engine_rows": rows}


def _cut_config(blocks: int):
    """CONFIG's model with ``blocks`` processor blocks (the first ones:
    block 0 global, the rest local)."""
    import dataclasses
    from repro_torch.configs import fcn3 as fcn3cfg
    return dataclasses.replace(fcn3cfg.NAMED_CONFIGS[CONFIG](),
                               n_blocks=blocks)


def _with_config(cfg):
    """``launch/train.py``'s CONFIG as ``cfg`` (a context)."""
    import contextlib
    from repro_torch.launch import train as train_mod

    @contextlib.contextmanager
    def patched():
        before = train_mod.CONFIGS[CONFIG]
        train_mod.CONFIGS[CONFIG] = lambda: cfg
        try:
            yield
        finally:
            train_mod.CONFIGS[CONFIG] = before
    return patched()


def _smoke_step(trainer, model, seed: int):
    """One fcn3_smoke loss and gradient step of ``trainer`` on the
    loader's first training batch, from ``seed``'s draws."""
    import torch
    from repro_torch.data import era5_synthetic as dlib
    from repro_torch.inference.engine import GeneratorNoise
    ds = dlib.SyntheticERA5(model.cfg, device=model.device)
    it = iter(dlib.Loader(ds, global_batch=TRAIN_BATCH,
                          rollout=TRAIN_ROLLOUT, seed=0))
    next(it)
    bufs = dict(model.make_buffers(), **trainer.make_loss_buffers())
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return trainer.loss_and_grads(bufs, next(it), GeneratorNoise(gen))


def _channel_part(rank: int, world_size: int, argv: list[str],
                  small_ckpt: str) -> dict:
    """(f), on one rank of (c)'s world: ``launch/train.py``'s CLI in
    channel mode at the cut config (the process group is this world's),
    then one fcn3_smoke channel step; each with its launches, plain calls
    on CUDA tensors, the step's diagnostics, peak, this rank's gradients
    (every leaf on rank 0, the split leaves' blocks on the others) and
    its updated blocks of the split leaves."""
    import torch
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as train_mod
    from repro_torch.train import trainer as trlib
    guard = PlainGuard()
    kept: dict = {}
    grads_of = trlib.EnsembleTrainer.loss_and_grads

    def loss_and_grads(self, *args):
        loss, aux, grads = grads_of(self, *args)
        if "trainer" not in kept:
            # this rank's first-step gradients to the host: rank 0's every
            # leaf, the others' the split leaves' blocks (the step's time
            # grows by the copies)
            kept["trainer"] = self
            kept["grads"] = {k: g.cpu() for k, g in grads.items()
                             if rank == 0 or k in self.split}
        return loss, aux, grads
    trlib.EnsembleTrainer.loss_and_grads = loss_and_grads
    for mod in _kernel_modules():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _with_config(_cut_config(CHANNEL_BLOCKS)):
        history = train_mod.main(argv)
    torch.cuda.synchronize()
    tr = kept.pop("trainer")
    out = {"history": history, "launches": launch_counts(),
           "plain": dict(guard.counts),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "grads": kept.pop("grads"), "split": sorted(tr.split),
           "specs": tr.channel.specs, "model_rank": tr.par.model_rank,
           "blocks": {k: p.detach().cpu()
                      for k, p in tr.model.named_parameters()
                      if k in tr.split}}
    del tr
    trlib.EnsembleTrainer.loss_and_grads = grads_of
    gc.collect()
    torch.cuda.empty_cache()
    # the smoke step, with the counters and the guard set to 0 before it
    for mod in _kernel_modules():
        mod.reset_launches()
    guard.counts = dict.fromkeys(guard.counts, 0)
    cfg = fcn3cfg.fcn3_smoke()
    model = FCN3(cfg, device="cuda")
    train_mod.load_init(model, small_ckpt)
    tcfg = train_mod.stage_to_tcfg(train_mod.STAGES[TRAIN_STAGE],
                                   TRAIN_ENSEMBLE, TRAIN_ROLLOUT)
    mesh = meshlib.make_mesh((1, world_size), train_mod.MESH_AXES, "cuda")
    tr = trlib.EnsembleTrainer(model, tcfg,
                               fcn3cfg.channel_weights(cfg.n_levels), mesh,
                               placement="channel")
    loss, _, grads = _smoke_step(tr, model, CHANNEL_SMALL_SEED)
    torch.cuda.synchronize()
    out["small"] = {"loss": float(loss), "launches": launch_counts(),
                    "plain": dict(guard.counts), "split": sorted(tr.split),
                    "specs": tr.channel.specs,
                    "grads": {k: g.cpu() for k, g in grads.items()}}
    guard.close()
    return out


def _kernel_modules():
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return crps_ops, disco_ops, legendre_ops, ssd_ops


def _whole(parts: list[dict], specs: dict) -> dict:
    """Every rank's gradients (or blocks) in rank order -> whole leaves:
    a split leaf's blocks concatenated along its split dim, the others
    rank 0's."""
    import torch
    out = {}
    for k, g in parts[0].items():
        spec = specs.get(k, ())
        dims = [d for d, e in enumerate(spec) if e is not None]
        out[k] = (torch.cat([p[k] for p in parts], dim=dims[0]) if dims
                  else g)
    return out


def _single_first_step(cfg, ckpt: str) -> dict:
    """One process's first training step of ``cfg`` on the card from the
    checkpoint ``ckpt``: the training cell's batch and draws (as
    ``run_steps`` takes them), its loss, gradients and the leaves after
    one Adam update (to the host)."""
    import torch
    from repro_torch.inference.engine import GeneratorNoise
    from repro_torch.launch import train as train_mod
    with _with_config(cfg):
        run = train_mod.setup(CONFIG, TRAIN_STAGE, TRAIN_BATCH,
                              TRAIN_ENSEMBLE, TRAIN_ROLLOUT, seed=0,
                              device="cuda", init_from=ckpt,
                              report=lambda line: None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1000)
    loss, _, grads = run.trainer.loss_and_grads(
        run.buffers, next(run.batches), GeneratorNoise(gen))
    params = dict(run.model.named_parameters())
    run.optimizer_state = run.trainer.optimizer.update(
        params, grads, run.opt_state, norm=run.trainer.grad_norm(grads))
    out = {"loss": float(loss),
           "grads": {k: g.cpu() for k, g in grads.items()},
           "updated": {k: p.detach().cpu() for k, p in params.items()}}
    del run, grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _grad_worst(got: dict, ref: dict) -> tuple:
    """The worst |diff| / (atol + rtol |ref|) over every leaf, where, and
    the relative error over all (``_vs_first_step``'s measures)."""
    worst, at, sq, sq_ref = 0.0, None, 0.0, 0.0
    for k, want in ref.items():
        diff = (got[k] - want).abs()
        ratio = diff / (GRAD_ATOL + GRAD_RTOL * want.abs())
        if float(ratio.max()) > worst:
            i = int(ratio.argmax())
            worst, at = float(ratio.max()), (
                k, float(want.reshape(-1)[i]), float(diff.reshape(-1)[i]))
        sq += float((diff.double() ** 2).sum())
        sq_ref += float((want.double() ** 2).sum())
    return worst, at, math.sqrt(sq / sq_ref)


def channel_reference(report, step0: dict, tmp: str) -> dict:
    """(f)'s single-process side, on the card before (c)'s world starts:
    the training phase's initial parameters cut to CHANNEL_BLOCKS blocks
    (a checkpoint), one process's first step of that model, fresh
    fcn3_smoke parameters (a checkpoint) and one process's smoke step;
    with the channel CLI's argv."""
    import torch
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.launch import train as train_mod
    from repro_torch.train import checkpoint as ckptlib
    from repro_torch.train import trainer as trlib
    t0 = time.time()
    cut = _cut_config(CHANNEL_BLOCKS)
    # the training phase's initial parameters, cut to the kept blocks
    params, _, _ = ckptlib.restore_checkpoint(step0["ckpt"])
    keep = {f"blocks.{i}." for i in range(CHANNEL_BLOCKS)}
    params = {k: v for k, v in params.items()
              if not k.startswith("blocks.") or k[:k.index(".", 7) + 1]
              in keep}
    ckpt = ckptlib.save_checkpoint(os.path.join(tmp, "channel"), 0, params)
    del params
    single = _single_first_step(cut, ckpt)
    # fcn3_smoke: fresh parameters from a seed, and one process's step
    small_model = FCN3(fcn3cfg.fcn3_smoke(), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    small_model.init(gen)
    small_ckpt = ckptlib.save_checkpoint(
        os.path.join(tmp, "channel_smoke"), 0,
        dict(small_model.named_parameters()))
    tcfg = train_mod.stage_to_tcfg(train_mod.STAGES[TRAIN_STAGE],
                                   TRAIN_ENSEMBLE, TRAIN_ROLLOUT)
    small_tr = trlib.EnsembleTrainer(
        small_model, tcfg, fcn3cfg.channel_weights(small_model.cfg.n_levels))
    loss, _, grads = _smoke_step(small_tr, small_model, CHANNEL_SMALL_SEED)
    small_ref = {"loss": float(loss),
                 "grads": {k: g.cpu() for k, g in grads.items()}}
    del small_model, small_tr, loss, grads
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.time() - t0
    argv = ["--config", CONFIG, "--stage", TRAIN_STAGE, "--ensemble",
            str(TRAIN_ENSEMBLE), "--batch", str(TRAIN_BATCH), "--rollout",
            str(TRAIN_ROLLOUT), "--steps", str(DIST_TRAIN_STEPS),
            "--mesh-model", str(CHANNEL_RANKS), "--dist-backend",
            DIST_BACKEND, "--init-from", ckpt, "--device", "cuda",
            "--fcn3-sharding", "channel"]
    report(f"[dist] (f) launch/train.py {' '.join(argv)} on {CHANNEL_RANKS}"
           f" ranks of one card, fcn3_{CONFIG}'s widths cut to "
           f"{CHANNEL_BLOCKS} of its "
           f"{fcn3cfg.NAMED_CONFIGS[CONFIG]().n_blocks} blocks, in (c)'s world "
           f"after its step; then one fcn3_smoke channel step there; one "
           f"process's steps on the card {ref_s:.1f} s")
    return {"ckpt": ckpt, "small_ckpt": small_ckpt, "single": single,
            "small_ref": small_ref, "argv": argv, "cut": cut, "tcfg": tcfg,
            "ref_s": ref_s}


def channel_report(report, res: list, world_s: float, ref: dict, guard
                   ) -> dict:
    """(f) and [dryrun] (iv) from the ranks' ``"channel"`` parts: each
    held to one process on the card, then the channel step counted as
    rank 0 of a fake 1 x CHANNEL_RANKS mesh and held to rank 0's
    launches, peak and collective bytes; raises on any failed check."""
    from repro_torch.launch import dryrun
    t0 = time.time()
    single, small_ref = ref["single"], ref["small_ref"]
    cut, tcfg = ref["cut"], ref["tcfg"]
    order = sorted(range(len(res)), key=lambda i: res[i]["model_rank"])
    specs = res[0]["specs"]
    grads = _whole([res[i]["grads"] for i in order], specs)
    blocks = {i: res[i]["blocks"] for i in order}
    loss = res[0]["history"][0]["loss"]
    loss_rel = abs(loss - single["loss"]) / abs(single["loss"])
    worst, at, rel_all = _grad_worst(grads, single["grads"])
    # the split leaves' updated blocks against the slices of one process's
    # updated leaves: Adam's first step moves each entry by lr times the
    # sign of its gradient, so an entry may differ only where that sign
    # is below the gradient bar's atol on one process
    flips, unresolved = 0, 0
    for i, part in blocks.items():
        for k, blk_ in part.items():
            d = [d for d, e in enumerate(specs[k]) if e is not None][0]
            n = blk_.shape[d]
            want = single["updated"][k].narrow(d, res[i]["model_rank"] * n,
                                               n)
            g = single["grads"][k].narrow(d, res[i]["model_rank"] * n, n)
            moved = (blk_ - want).abs() > 1e-7
            flips += int(moved.sum())
            unresolved += int((moved & (g.abs() > GRAD_ATOL)).sum())
    split_n = sum(int(single["grads"][k].numel()) for k in res[0]["split"])
    for i, r in enumerate(res):
        h = r["history"][0]
        report(f"[dist] (f) rank {i} (model rank {r['model_rank']}): "
               f"step_s={round(h['seconds'], 3)} collective_s="
               f"{round(h['collective_s'], 3)} (share "
               f"{round(h['collective_s'] / h['seconds'], 3)}) "
               f"bytes_by_kind={_nonzero(h['kind_bytes'])} loss="
               f"{h['loss']:.7f} |g|={h['grad_norm']:.6f} split_leaves="
               f"{len(r['split'])} ({split_n:,} parameters) launches="
               f"{_nonzero(r['launches'])} plain_calls_on_cuda={r['plain']} "
               f"peak_mem_gb={r['peak_gb']:.2f}")
    report(f"[dist] (f) first step vs one process's (the same "
           f"{CHANNEL_BLOCKS}-block model on the card): loss {loss:.7f} vs "
           f"{single['loss']:.7f} (rel {loss_rel:.2e}, bar "
           f"{DIST_LOSS_RTOL:g}); gradients gathered: |diff| / |ref| over "
           f"all = {rel_all:.2e}, worst |diff| / (atol + rtol |ref|) = "
           f"{worst:.3f} at {at[0]} (ref {at[1]:.4e}, diff {at[2]:.3e}; "
           f"rtol={GRAD_RTOL}, atol={GRAD_ATOL}); updated split blocks vs "
           f"one process's updated slices: {flips} of {split_n} entries "
           f"differ, {unresolved} of them where one process's gradient "
           f"exceeds atol; in the ranks {world_s:.1f} s")
    # the smoke step
    sm = [res[i]["small"] for i in order]
    s_grads = _whole([p["grads"] for p in sm], sm[0]["specs"])
    s_rel = abs(sm[0]["loss"] - small_ref["loss"]) / abs(small_ref["loss"])
    s_worst, s_at, s_all = _grad_worst(s_grads, small_ref["grads"])
    for i in order:
        report(f"[dist] (f) fcn3_smoke rank {i}: split_leaves="
               f"{len(res[i]['small']['split'])} loss="
               f"{res[i]['small']['loss']:.7f} launches="
               f"{_nonzero(res[i]['small']['launches'])} plain_calls_on_cuda="
               f"{res[i]['small']['plain']}")
    report(f"[dist] (f) fcn3_smoke vs one process on the card: loss rel "
           f"{s_rel:.2e} (bar {DIST_LOSS_RTOL:g}); gradients |diff| / |ref| "
           f"= {s_all:.2e}, worst {s_worst:.3f} at {s_at[0]}")
    for i, r in enumerate(res):
        fam = ("disco_band_contract", "disco_band_transpose",
               "legendre_contract", "crps_fused", "crps_fused_bwd")
        if (min(r["launches"][f] for f in fam) <= 0
                or min(r["small"]["launches"][f] for f in fam) <= 0):
            raise AssertionError(f"(f) rank {i} launches {r['launches']}, "
                                 f"smoke {r['small']['launches']}")
        if any(r["plain"].values()) or any(r["small"]["plain"].values()):
            raise AssertionError(f"(f) rank {i}: plain {r['plain']}, "
                                 f"smoke {r['small']['plain']}")
        if len(r["small"]["split"]) != 9:
            raise AssertionError(f"(f) rank {i}: fcn3_smoke split "
                                 f"{r['small']['split']}")
    if not (loss_rel <= DIST_LOSS_RTOL and worst <= 1.0 and unresolved == 0
            and s_rel <= DIST_LOSS_RTOL and s_worst <= 1.0):
        raise AssertionError(f"(f) disagrees with one process: loss rel "
                             f"{loss_rel:.3e}, gradient {worst:.3f}, "
                             f"updates {unresolved}; smoke {s_rel:.3e}, "
                             f"{s_worst:.3f}")
    # [dryrun] (iv): the same step counted as rank 0 of a fake mesh
    t2 = time.time()
    dry = dry_count("fcn3/channel-1x2", lambda d, mesh: (
        dryrun.build_fcn3_case(
            "train", mesh, d, fcn3_mode="channel", cfg=cut,
            sizes=(TRAIN_BATCH, TRAIN_ENSEMBLE, TRAIN_ROLLOUT), tcfg=tcfg)),
        guard, world=(CHANNEL_RANKS, (1, CHANNEL_RANKS)))
    h0 = res[0]["history"][0]
    step_launches = _nonzero(res[0]["launches"])
    held = dryrun_hold(report, f"(iv) channel step, {CHANNEL_BLOCKS}-block "
                       f"fcn3_{CONFIG}, rank 0 of a fake 1 x {CHANNEL_RANKS} "
                       f"mesh", dry, step_launches, h0["seconds"],
                       res[0]["peak_gb"])
    pred, got = dry["counts"].collective_bytes(), _nonzero(h0["kind_bytes"])
    report(f"[dryrun] (iv) collective bytes (predicted / (f) rank 0's): "
           + " ".join(f"{k} {pred.get(k, 0)} / {got.get(k, 0)}"
                      for k in sorted(set(pred) | set(got))))
    for k in ("all_reduce", "all_gather"):
        if pred.get(k, 0) != got.get(k, 0):
            raise AssertionError(f"(iv): predicted {k} bytes {pred.get(k)} "
                                 f"are not (f)'s {got.get(k)}")
    return {"channel": [{k: v for k, v in r.items()
                         if k not in ("grads", "blocks", "small", "specs")}
                        for r in res],
            "channel_small": [r["small"]["launches"] for r in res],
            "channel_s": ref["ref_s"] + world_s + time.time() - t0,
            "channel_world_s": world_s,
            "dryrun_iv_s": time.time() - t2, "held_iv": held}


def expert_rank(rank: int, world_size: int, cases: list) -> list:
    """(g), on one rank of a (data 2, model 2) mesh: for each (arch,
    dispatch, numpy parameters, tokens) case, the smoke MoE LM on this
    rank's slice of the batch with whole experts, then with its experts
    placed over the model axis: logits, aux, loss and gradients (the
    placed stacks' blocks), the placed run's collective bytes by kind,
    its kept pairs per MoE layer, launches and plain calls."""
    import dataclasses
    import torch
    from repro_torch.configs import archs
    from repro_torch.distributed import compat
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import lm_params_from_numpy
    from repro_torch.models.transformer import LM
    from repro_torch.train import lm as lmtrain
    t0 = time.time()
    guard = PlainGuard()
    before = launch_counts()
    mesh = make_mesh(EXPERT_MESH, ("data", "model"), "cuda")
    stamps = {"setup": time.time() - t0}
    data, experts = mesh.get_group("data"), mesh.get_group("model")
    d = mesh.get_local_rank("data")
    out = []
    for arch, dispatch, params, tokens in cases:
        cfg = archs.smoke_config(arch)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, dp_axes=("data",)))
        b = tokens.shape[0] // EXPERT_MESH[0]
        mine = torch.from_numpy(tokens[d * b:(d + 1) * b]).long().cuda()
        batch = {"tokens": mine, "labels": mine}
        group = moe.scatter_group(cfg.moe, data, *tokens.shape)
        case = {"arch": arch, "dispatch": dispatch,
                "scatter": group is not None, "model_rank":
                mesh.get_local_rank("model"), "data_rank": d}
        for name in ("whole", "placed"):
            model = LM(cfg, device="cuda")
            model.load_state_dict(lm_params_from_numpy(params, cfg))
            eg = experts if name == "placed" else None
            if eg is not None:
                case["placed_names"] = model.place_experts(mesh)
            kept = []
            compat.start_timing()
            with torch.no_grad(), moe.observe(
                    lambda r: kept.append(int(r.keep.sum()))):
                logits, aux = model.apply_train(mine, moe_group=group,
                                                expert_group=eg)
            kinds = compat.timed_kinds()
            loss, _, grads = lmtrain.loss_and_grads(model, batch, data,
                                                    group, eg)
            torch.cuda.synchronize()
            case[name] = {"logits": logits.cpu(),
                          "aux": {k: float(v) for k, v in aux.items()},
                          "loss": float(loss), "kinds": kinds, "kept": kept,
                          "grads": {k: g.cpu() for k, g in grads.items()},
                          "shapes": {k: tuple(p.shape) for k, p in
                                     model.named_parameters()}}
            del model
        out.append(case)
        stamps[f"{arch}/{dispatch}"] = time.time() - t0 - sum(
            stamps.values())
    out.append({"launches": _launched(before, launch_counts()),
                "plain": dict(guard.counts), "seconds": stamps})
    guard.close()
    return out


def expert_cases() -> tuple[list, dict, float]:
    """(g)'s inputs and single-process side: for each of EXPERT_ARCHS a
    smoke LM from a seed on the card, its numpy parameters and tokens for
    both dispatches, and one process's logits and aux with whole experts
    on each data slice; with the seconds it took."""
    import torch
    from repro_torch.configs import archs
    from repro_torch.models.params import lm_params_to_numpy
    from repro_torch.models.transformer import LM
    t0 = time.time()
    cases, ref = [], {}
    for i, arch in enumerate(EXPERT_ARCHS):
        cfg = archs.smoke_config(arch)
        model = LM(cfg, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(i)
        model.init(gen)
        tokens = torch.randint(0, cfg.vocab_size, EXPERT_TOKENS,
                               generator=torch.Generator().manual_seed(i))
        b = EXPERT_TOKENS[0] // EXPERT_MESH[0]
        with torch.no_grad():
            ref[arch] = [model.apply_train(tokens[j * b:(j + 1) * b].cuda())
                         for j in range(EXPERT_MESH[0])]
        params = lm_params_to_numpy(dict(model.named_parameters()), cfg)
        cases += [(arch, disp, params, tokens.numpy())
                  for disp in ("dense", "scatter")]
        del model
    return cases, ref, time.time() - t0


def _full_expert_params(cfg, lo: int, hi: int, device) -> dict:
    """One MoE layer's parameters at ``cfg``'s widths with experts
    [lo, hi) of its stacks; every expert drawn from a seed of its own (so
    a block equals the whole stacks' slice), in ``init_moe``'s scales."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    gen = torch.Generator(device=device)

    def draw(shape, scale, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    d, f = cfg.d_model, cfg.d_ff
    out = {"router": draw((d, cfg.n_experts), d ** -0.5, 1)}
    if cfg.n_shared:
        out["shared"] = {
            k: draw(shape, shape[0] ** -0.5, 2 + i) for i, (k, shape) in
            enumerate(cm.swiglu_shapes(d, cfg.shared_width).items())}
    for j, (name, shape) in enumerate(moe.moe_shapes(cfg).items()):
        if name == "router":
            continue
        stack = torch.empty((hi - lo, *shape[1:]), device=device)
        for e in range(lo, hi):
            gen.manual_seed(1000 * (j + 1) + e)
            stack[e - lo].normal_(generator=gen).mul_(
                (f if name == "w_down" else d) ** -0.5)
        out[name] = stack
    return out


def _full_expert_run(cfg, params: dict, x, dy, group) -> dict:
    """The layer's output, aux and gradients (inputs, router, shared and
    expert stacks) of sum(y dy) + lb_loss, with its seconds."""
    import torch
    from repro_torch.models import moe
    flat = {k: v for k, v in params.items() if k != "shared"}
    flat.update({f"shared.{k}": v
                 for k, v in params.get("shared", {}).items()})
    for v in flat.values():
        v.requires_grad_(True)
    x = x.detach().requires_grad_(True)
    if x.is_cuda:
        torch.cuda.synchronize()
    t0 = time.time()
    y, aux = moe.apply_moe(params, cfg, x, expert_group=group)
    loss = (y * dy).sum() + aux["lb_loss"]
    grads = torch.autograd.grad(loss, [x, *flat.values()])
    if x.is_cuda:
        torch.cuda.synchronize()
    return {"y": y.detach(),
            "aux": {k: float(v.detach()) for k, v in aux.items()},
            "grads": dict(zip(["x", *flat], grads)),
            "seconds": time.time() - t0}


def expert_full_rank(rank: int, world_size: int, arch: str,
                     tokens: int = EXPERT_FULL_TOKENS, cfg=None,
                     device: str = "cuda") -> dict:
    """(g) at full width, on one rank of a (data 1, model world_size)
    mesh: one MoE layer of ``arch`` (``cfg``: its MoE config, or another
    for a small check) with whole experts on each rank in turn (the
    others wait, so only one rank holds the whole stacks and their
    gradients), this rank's slice of the whole stacks' gradients kept;
    then the experts placed over the model axis, on every rank at once.
    The placed run against the whole one: outputs, aux, the input,
    router, shared and block gradients; its collective bytes by kind,
    seconds, the peak and the launches."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import archs
    from repro_torch.distributed import compat
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(cfg or archs.get_arch(arch).moe,
                              dispatch="dense")
    guard = PlainGuard() if device == "cuda" else None
    before = launch_counts()
    mesh = make_mesh((1, world_size), ("data", "model"), device)
    group = mesh.get_group("model")
    m = mesh.get_local_rank("model")
    n = cfg.n_experts // world_size
    lo, hi = m * n, (m + 1) * n
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device)
    dy = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device)
    stacks = ("w_gate", "w_up", "w_down")
    whole = None
    for turn in range(world_size):
        if turn == m:
            run = _full_expert_run(cfg, _full_expert_params(
                cfg, 0, cfg.n_experts, device), x, dy, None)
            whole = dict(run, grads={
                k: g[lo:hi].clone() if k in stacks else g
                for k, g in run["grads"].items()})
            del run
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    compat.start_timing()
    placed = _full_expert_run(cfg, _full_expert_params(cfg, lo, hi, device),
                              x, dy, group)
    kinds = compat.timed_kinds()
    out = {"model_rank": m, "experts": (lo, hi), "kinds": kinds,
           "whole_s": whole["seconds"], "placed_s": placed["seconds"],
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if device == "cuda" else 0.0),
           "y_rel": float((placed["y"] - whole["y"]).abs().max()
                          / whole["y"].abs().max()),
           "aux_rel": max(abs(placed["aux"][k] - v) / abs(v)
                          for k, v in whole["aux"].items()),
           "grad_worst": {k: float(((placed["grads"][k] - g).abs() / (
               GRAD_ATOL + GRAD_RTOL * g.abs())).max())
               for k, g in whole["grads"].items()},
           "block_shape": tuple(placed["grads"]["w_gate"].shape),
           "launches": _launched(before, launch_counts()),
           "plain": dict(guard.counts) if guard is not None else {}}
    if guard is not None:
        guard.close()
    return out


def expert_full_report(report, res: list, world_s: float) -> dict:
    """(g) at full width from each rank's ``expert_full_rank``: placed
    against whole at EXPERT_RTOL (outputs, aux) and the gradient bar;
    raises on any failed check."""
    from repro_torch.configs import archs
    cfg = archs.get_arch(EXPERT_FULL_ARCH).moe
    worst = 0.0
    for r in res:
        gw = max(r["grad_worst"].values())
        worst = max(worst, r["y_rel"] / EXPERT_RTOL,
                    r["aux_rel"] / EXPERT_RTOL, gw)
        report(f"[dist] (g) full width rank {r['model_rank']}: "
               f"{EXPERT_FULL_ARCH} one MoE layer (d_model {cfg.d_model}, "
               f"d_ff {cfg.d_ff}, top-{cfg.top_k}, {cfg.n_shared} shared), "
               f"{EXPERT_FULL_TOKENS} tokens, dense dispatch; experts "
               f"{r['experts']} of {cfg.n_experts} (block "
               f"{r['block_shape']}); fwd+bwd s whole {r['whole_s']:.3f} "
               f"placed {r['placed_s']:.3f}; bytes_by_kind="
               f"{_nonzero(r['kinds'])} peak_mem_gb {r['peak_gb']:.2f} "
               f"(placed); placed vs whole: output rel {r['y_rel']:.2e} aux "
               f"rel {r['aux_rel']:.2e} gradients worst " + " ".join(
                   f"{k} {v:.3f}" for k, v in r["grad_worst"].items()))
        if r["launches"] or any(r["plain"].values()):
            raise AssertionError(f"(g) full width: launches "
                                 f"{r['launches']}, plain {r['plain']}")
        if r["kinds"]["all_gather"] <= 0 or r["kinds"]["all_to_all"]:
            raise AssertionError(f"(g) full width: collectives "
                                 f"{r['kinds']}")
    report(f"[dist] (g) full width: worst share of the bar {worst:.3f} "
           f"(outputs, aux at {EXPERT_RTOL:g} relative; gradients rtol="
           f"{GRAD_RTOL} atol={GRAD_ATOL}); in (c)'s ranks {world_s:.1f} s")
    if worst > 1.0:
        raise AssertionError(f"(g) full width: placed experts disagree, "
                             f"{worst:.3f} of the bar")
    return {"seconds": world_s, "worst": worst,
            "ranks": [{k: v for k, v in r.items() if k != "grad_worst"}
                      for r in res]}


def expert_report(report, res: list, world_s: float, ref: dict,
                  ref_s: float) -> dict:
    """(g) from each rank's ``expert_rank`` output (run in (b)'s world of
    EXPERT_MESH's 4 ranks after (b)'s own work): the placed experts
    against whole experts in the same world (outputs, aux and loss at
    EXPERT_RTOL, gradients at the gradient bar) and one process with
    whole experts on each data slice (outputs; the dense dispatch's aux
    too); raises on any failed check."""
    from repro_torch.configs import archs
    report(f"[dist] (g) one process's references {ref_s:.1f} s, the ranks"
           f" {world_s:.1f} s (in (b)'s world after its checks)")
    phase_s = ref_s + world_s
    worst = {}
    for r, rank_res in enumerate(res):
        tail = rank_res[-1]
        for c in rank_res[:-1]:
            w, p = c["whole"], c["placed"]
            rel = float((p["logits"] - w["logits"]).abs().max()
                        / w["logits"].abs().max())
            aux_rel = max(abs(p["aux"][k] - w["aux"][k]) / abs(w["aux"][k])
                          for k in w["aux"])
            loss_rel = abs(p["loss"] - w["loss"]) / abs(w["loss"])
            gworst = 0.0
            for k, g in w["grads"].items():
                got = p["grads"][k]
                if k in c["placed_names"]:
                    n = got.shape[-3]
                    g = g.narrow(-3, c["model_rank"] * n, n)
                gworst = max(gworst, float(((got - g).abs() / (
                    GRAD_ATOL + GRAD_RTOL * g.abs())).max()))
            one, one_aux = ref[c["arch"]][c["data_rank"]]
            one_rel = float((p["logits"] - one.cpu()).abs().max()
                            / one.abs().max())
            one_aux_rel = (max(abs(p["aux"][k] - float(one_aux[k]))
                               / abs(float(one_aux[k])) for k in one_aux)
                           if c["dispatch"] == "dense" else 0.0)
            n_exp = archs.smoke_config(c["arch"]).moe.n_experts
            over = " (scatter over the data ranks)" if c["scatter"] else ""
            report(f"[dist] (g) rank {r} (data {c['data_rank']}, model "
                   f"{c['model_rank']}) {c['arch']} {c['dispatch']}{over}"
                   f": experts {p['shapes'][c['placed_names'][0]][-3]} of "
                   f"{n_exp} a stack, {len(c['placed_names'])} stacks placed;"
                   f" all_gather_bytes={p['kinds']['all_gather']} "
                   f"bytes_by_kind={_nonzero(p['kinds'])} kept_pairs="
                   f"{p['kept']}; placed vs whole experts: logits rel "
                   f"{rel:.2e} aux rel {aux_rel:.2e} loss rel {loss_rel:.2e} "
                   f"gradients worst {gworst:.3f}; vs one process on the "
                   f"slice: logits rel {one_rel:.2e}"
                   + (f" aux rel {one_aux_rel:.2e}"
                      if c["dispatch"] == "dense" else ""))
            key = (c["arch"], c["dispatch"])
            worst[key] = max(worst.get(key, 0.0), rel / EXPERT_RTOL,
                             aux_rel / EXPERT_RTOL, loss_rel / EXPERT_RTOL,
                             gworst, one_rel / EXPERT_RTOL,
                             one_aux_rel / EXPERT_RTOL)
            if p["kinds"]["all_gather"] <= 0 or p["kinds"]["all_to_all"]:
                raise AssertionError(f"(g) {key}: collectives {p['kinds']}")
            if p["kept"] != w["kept"]:
                raise AssertionError(f"(g) {key}: kept pairs {p['kept']} "
                                     f"vs {w['kept']}")
        report(f"[dist] (g) rank {r} host seconds: "
               + ", ".join(f"{k} {v:.1f}" for k, v in tail["seconds"].items()))
        if tail["launches"] or any(tail["plain"].values()):
            raise AssertionError(f"(g) rank {r}: launches "
                                 f"{tail['launches']}, plain {tail['plain']}")
    report(f"[dist] (g) worst share of the bar (outputs, aux, loss at "
           f"{EXPERT_RTOL:g} relative; gradients rtol={GRAD_RTOL} atol="
           f"{GRAD_ATOL}): "
           + " ".join(f"{a}/{d} {v:.3f}" for (a, d), v in worst.items())
           + f"; no kernel launched (einsums), no plain version; phase "
           f"{phase_s:.1f} s")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"(g) the placed experts disagree: {worst}")
    return {"experts_s": phase_s, "experts_worst": {
        f"{a}/{d}": v for (a, d), v in worst.items()}}


def examples_phase(report, guard) -> dict:
    """[examples]: ``examples/quickstart_torch.py`` and
    ``examples/storm_case_study_torch.py`` on the card, each through its
    ``main()`` to its last line, with every launch counter and the
    plain-version guard read just before and just after; every FCN3
    kernel must launch, no plain version on a CUDA tensor."""
    import contextlib
    import importlib.util
    import io
    import torch
    before = launch_counts()
    guard.counts = dict.fromkeys(guard.counts, 0)
    out = {}
    for name, last in (("quickstart_torch", "quickstart OK"),
                       ("storm_case_study_torch", "(paper Fig. 4/5).")):
        path = ROOT / "examples" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            mod.main(device="cuda")
        torch.cuda.synchronize()
        seconds = time.time() - t0
        lines = buf.getvalue().splitlines()
        for ln in lines:
            if ln.strip():
                report(f"[examples] {name}: {ln}")
        report(f"[examples] {name}: {seconds:.1f} s on the card")
        if not lines or not lines[-1].endswith(last):
            raise AssertionError(f"{name} did not reach its last line: "
                                 f"{lines[-3:]}")
        out[name] = seconds
        gc.collect()
        torch.cuda.empty_cache()
    launched = _launched(before, launch_counts())
    plain = dict(guard.counts)
    report(f"[examples] launches={launched} plain_calls_on_cuda={plain}")
    for fam in ("disco_band_contract", "disco_band_transpose",
                "legendre_contract", "crps_fused", "crps_fused_bwd"):
        if launched.get(fam, 0) <= 0:
            raise AssertionError(f"the examples never launched {fam}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors in the "
                             f"examples: {plain}")
    return {"seconds": out, "launches": launched}


def dist_phase(report, step0: dict, tmp: str, forecast: dict,
               guard) -> dict:
    """(a) the selftest on the card, (b) Algorithms 1 and 2 at the
    fcn3_full latent, then (g) the expert placement and (d2) in the same
    world, (c) ensemble-parallel training at fcn3_full against the
    training phase's first step, then in the same world (f) channel
    parallelism (with [dryrun] (iv)), (g) at full width, (d1) the
    domain-decomposed step with (d4) and (e) the engine's ``member_axes``
    against ``forecast`` ([main]'s scores, final members and
    parameters); raises on any failed check.  The parts ride two worlds
    besides the selftest's: a world's start costs 15-35 s of the
    script's time."""
    import torch
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.distributed import selftest
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    res = selftest.run("cuda", DIST_BACKEND, timeout=600.0,
                       report=lambda ln: report(f"[dist] (a) {ln}"))
    for r in res:
        if min(r["launches"].values()) <= 0:
            raise AssertionError(f"selftest rank {r['coord']} launched a "
                                 f"kernel no time: {r['launches']}")
    out["selftest_s"] = time.time() - t0
    report(f"[dist] (a) selftest: 8 ranks on one card, backend="
           f"{DIST_BACKEND}, {out['selftest_s']:.1f} s")

    t0 = time.time()
    plans = str(Path(tmp) / "latent_plans.pkl")
    nbytes = _plan_payloads(("latent",), ("latent_sht",), plans)
    ranks = DIST_GRID[0] * DIST_GRID[1]
    cases, expert_ref, expert_ref_s = expert_cases()
    # (g), and (d2) when its rank count agrees, ride (b)'s world
    then = [("experts", expert_rank, (cases,))]
    if ranks == DIST_SMALL_RANKS:
        then.append(("small", dist_small_rank, ()))
    pre_s = time.time() - t0 - expert_ref_s
    res, parts, own_s = run_world_then(
        dist_geometry_rank, ranks, (plans,), then, backend=DIST_BACKEND,
        timeout=600.0)
    out["geometry_s"] = pre_s + own_s
    cfg = fcn3cfg.NAMED_CONFIGS[CONFIG]()
    report(f"[dist] (b) Algorithms 1-2 at the {CONFIG} latent: "
           f"{cfg.latent_nlat}x{cfg.latent_nlon} {cfg.latent_grid}, "
           f"lmax=mmax={cfg.latent_nlat}, {DIST_CHANNELS} channels "
           f"(of the latent's {cfg.c_latent}), mesh lat {DIST_GRID[0]} x "
           f"lon {DIST_GRID[1]} = "
           f"{ranks} ranks on one card, backend={DIST_BACKEND}; plans "
           f"{nbytes / 1e9:.3f} GB handed over; phase {out['geometry_s']:.1f}"
           f" s")
    for r in res:
        report(f"[dist] (b) rank {r['coord']}: setup_s={r['setup_s']:.2f} "
               f"sht_fwd_inv_s={r['sht_s']:.3f} disco_s={r['disco_s']:.3f} "
               f"collective_s={r['collective_s']:.3f} "
               f"launches={r['launches']} plain_calls_on_cuda={r['plain']} "
               f"peak_mem_gb={r['peak_gb']:.2f} live_taps={r['live_taps'][0]}"
               f" of {r['live_taps'][1]}; vs single process (rel to max "
               f"|plain|): sht_forward={r['sht_forward']:.2e} "
               f"sht_inverse={r['sht_inverse']:.2e} disco={r['disco']:.2e}; "
               f"kernels vs plain: masked band x{r['masked_band_shape']} "
               f"{r['masked_band']:.2e}, Legendre on the order slice "
               f"x{r['legendre_shape']} forward "
               f"{r['legendre_forward']:.2e} inverse "
               f"{r['legendre_inverse']:.2e} (bar {REL_TOL:g})")
        g = r["gloo_cuda"]
        report(f"[dist] (b) rank {r['coord']} {DIST_BACKEND} on CUDA "
               f"tensors over the lat group: {g['took']}; over dim -2 of "
               f"{g['shape']} fp32, median s: "
               + " ".join(f"{k}={v:.4f}" for k, v in g["seconds"].items())
               + (f" max_abs_diff={g['max_abs_diff']:.3e}"
                  if "max_abs_diff" in g else ""))
        if min(r["launches"].values()) <= 0 or r["plain"]:
            raise AssertionError(f"rank {r['coord']}: launches "
                                 f"{r['launches']}, plain {r['plain']}")
        worst = max(r[k] for k in ("sht_forward", "sht_inverse", "disco",
                                   "masked_band", "legendre_forward",
                                   "legendre_inverse"))
        if not worst <= REL_TOL:
            raise AssertionError(f"rank {r['coord']}: {worst:.3e} > "
                                 f"{REL_TOL}")
    out["geometry"] = res
    out.update(expert_report(report, *parts["experts"], expert_ref,
                             expert_ref_s))

    t0 = time.time()
    plans = str(Path(tmp) / "full_plans.pkl")
    nbytes = _plan_payloads(("enc", "latent", "dec"),
                            ("in_sht", "latent_sht"), plans)
    argv = ["--config", CONFIG, "--stage", TRAIN_STAGE, "--ensemble",
            str(TRAIN_ENSEMBLE), "--batch", str(TRAIN_BATCH), "--rollout",
            str(TRAIN_ROLLOUT), "--steps", str(DIST_TRAIN_STEPS),
            "--mesh-model",
            str(DIST_TRAIN_RANKS), "--dist-backend", DIST_BACKEND,
            "--init-from", step0["ckpt"], "--device", "cuda"]
    argv_c = argv + ["--fcn3-sharding", "ensemble"]
    report(f"[dist] (c) launch/train.py {' '.join(argv_c)} on "
           f"{DIST_TRAIN_RANKS} ranks of one card (all {cfg.n_blocks} "
           f"blocks: no depth cut); plans {nbytes / 1e9:.3f} GB handed over")
    chan_ref = channel_reference(report, step0, tmp)
    pre_s = time.time() - t0 - chan_ref["ref_s"]
    # (f), (g) at full width, (d1) with (d4), and (e) when its rank count
    # agrees, ride (c)'s world
    then = [("channel", _channel_part, (chan_ref["argv"],
                                        chan_ref["small_ckpt"])),
            ("experts_full", expert_full_rank, (EXPERT_FULL_ARCH,)),
            ("domain", dist_train_rank,
             (plans, argv + ["--fcn3-sharding", "domain"]))]
    if DIST_ENGINE_RANKS == DIST_TRAIN_RANKS:
        then.append(("engine", dist_engine_rank, (plans, forecast["ckpt"])))
    res, train_parts, own_s = run_world_then(
        dist_train_rank, DIST_TRAIN_RANKS, (plans, argv_c), then,
        backend=DIST_BACKEND, timeout=900.0)
    out["train_s"] = pre_s + own_s
    loss, loss_rel, gerr, rel_all, worst, at = _vs_first_step(res, step0)
    for i, r in enumerate(res):
        hs = r["history"]
        report(f"[dist] (c) rank {i}: step_s="
               f"{[round(h['seconds'], 3) for h in hs]} collective_s="
               f"{[round(h['collective_s'], 3) for h in hs]} (share "
               f"{[round(h['collective_s'] / h['seconds'], 3) for h in hs]})"
               f" loss={[round(h['loss'], 7) for h in hs]} |g|="
               f"{[round(h['grad_norm'], 6) for h in hs]} launches="
               f"{r['launches']} plain_calls_on_cuda={r['plain']} "
               f"peak_mem_gb={r['peak_gb']:.2f} params_equal_rank0="
               f"{r['params_equal']}")
    report(f"[dist] (c) first step vs the single-process first step: loss "
           f"{loss:.7f} vs {step0['loss']:.7f} (rel {loss_rel:.2e}, bar "
           f"{DIST_LOSS_RTOL:g}); gradients max_abs_err={gerr:.3e}, "
           f"|diff| / |ref| over all = {rel_all:.2e}, worst "
           f"|diff| / (atol + rtol |ref|) = {worst:.3f} at {at[0]} (ref "
           f"{at[1]:.4e}, diff {at[2]:.3e}; rtol={GRAD_RTOL}, atol="
           f"{GRAD_ATOL}); the single-process first step's members within "
           f"{TIE_REL:.1e} relative of each other at {step0['ties'][0]:.2e}"
           f" of the points, member 0 and the truth at "
           f"{step0['ties'][1]:.2e}; phase {out['train_s']:.1f} s")
    for i, r in enumerate(res):
        if (r["launches"]["crps_fused"] <= 0
                or r["launches"]["crps_fused_bwd"] <= 0
                or min(r["launches"].values()) <= 0):
            raise AssertionError(f"rank {i} launches {r['launches']}")
        if any(r["plain"].values()) or not r["params_equal"]:
            raise AssertionError(f"rank {i}: plain {r['plain']}, params "
                                 f"equal {r['params_equal']}")
    if not (loss_rel <= DIST_LOSS_RTOL and worst <= 1.0):
        raise AssertionError(f"distributed step disagrees: loss rel "
                             f"{loss_rel:.3e}, gradient {worst:.3f}")
    out["train"] = [{k: v for k, v in r.items() if k != "grads"}
                    for r in res]
    out.update(channel_report(report, *train_parts["channel"], chan_ref,
                              guard))
    full = expert_full_report(report, *train_parts["experts_full"])
    out["experts_full"] = full
    out["experts_s"] += full["seconds"]
    out.update(domain_phase(report, step0, plans, argv, parts.get("small"),
                            train_parts["domain"]))
    out.update(engine_dist_phase(report, forecast, plans,
                                 train_parts.get("engine")))
    return out


def _vs_first_step(res, step0: dict) -> tuple:
    """Rank 0's first distributed step against the single process's:
    the loss, its relative error, the gradients' max abs error, their
    relative error over all, the worst |diff| / (atol + rtol |ref|) and
    where it is (name, ref, diff)."""
    loss = res[0]["history"][0]["loss"]
    ref = step0["grads"]
    worst, gerr, at, sq, sq_ref = 0.0, 0.0, None, 0.0, 0.0
    for k, g in res[0]["grads"].items():
        diff = (g - ref[k]).abs()
        gerr = max(gerr, float(diff.max()))
        ratio = diff / (GRAD_ATOL + GRAD_RTOL * ref[k].abs())
        if float(ratio.max()) > worst:
            i = int(ratio.argmax())
            worst, at = float(ratio.max()), (k, float(ref[k].reshape(-1)[i]),
                                             float(diff.reshape(-1)[i]))
        sq += float((diff.double() ** 2).sum())
        sq_ref += float((ref[k].double() ** 2).sum())
    loss_rel = abs(loss - step0["loss"]) / abs(step0["loss"])
    return loss, loss_rel, gerr, math.sqrt(sq / sq_ref), worst, at


def dist_small_rank(rank: int, world_size: int) -> dict:
    """Phase (d2), on one rank: one forward of the domain step at
    ``DIST_SMALL_CONFIG`` on this rank's rows (seeded parameters and
    inputs), with its launches and plain calls on CUDA tensors; rank 0
    gathers every rank's rows and holds them to the single process's
    forward of the whole field (worst |diff| / (atol + rtol |ref|))."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core.fcn3 import FCN3
    from repro_torch.distributed import domain
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import set_precision
    set_precision()
    dev = torch.device("cuda")
    cfg = fcn3cfg.NAMED_CONFIGS[DIST_SMALL_CONFIG]()
    model = FCN3(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    mesh = make_mesh((1, world_size), ("data", "model"), "cuda")
    d = domain.DomainFCN3(model, mesh.get_group("model"))
    gen = torch.Generator(device=dev).manual_seed(21)
    state = torch.randn((2, cfg.n_state, cfg.nlat, cfg.nlon), generator=gen,
                        device=dev)
    cond = torch.randn((2, cfg.n_cond_in, cfg.nlat, cfg.nlon), generator=gen,
                       device=dev)
    lo, hi = d.io_block
    bufs = d.make_buffers()
    guard = PlainGuard()
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    with torch.no_grad():
        got = d(bufs, state[..., lo:hi, :].contiguous(),
                cond[..., lo:hi, :].contiguous())
    out = {"rows": (lo, hi), "latent_rows": d.lat_block,
           "launches": {"disco_band_contract": disco_ops.launches,
                        "legendre_contract": legendre_ops.launches},
           "plain": sum(guard.counts.values())}
    guard.close()
    hp = max(b - a for a, b in d.io_blocks)
    padded = F.pad(got, (0, 0, 0, hp - (hi - lo))).contiguous()
    every = padded.new_empty((world_size * padded.shape[0],)
                             + padded.shape[1:])
    dist.all_gather_into_tensor(every, padded)
    every = every.reshape((world_size,) + padded.shape)
    if rank == 0:
        full = torch.cat([every[q, ..., :b - a, :]
                          for q, (a, b) in enumerate(d.io_blocks)], dim=-2)
        with torch.no_grad():
            ref = model(model.make_buffers(), state, cond)
        diff = (full - ref).abs()
        out["worst"] = float((diff / (STATE_ATOL + STATE_RTOL * ref.abs()))
                             .max())
        out["max_abs_err"] = float(diff.max())
        out["finite"] = bool(torch.isfinite(full).all())
    return out


def domain_phase(report, step0: dict, plans: str, argv: list[str],
                 small: tuple | None = None, part: tuple | None = None
                 ) -> dict:
    """(d) the domain-decomposed step: (d1) the training cell through
    ``launch/train.py --fcn3-sharding domain`` against the single
    process's first step, (d2) the ``fcn3_small`` forward over 4 ranks,
    (d3) the band, CRPS and Legendre kernels on rank 0's row-sliced
    operands at (d1)'s shapes; raises on any failed check.  ``small``
    and ``part``: (d2)'s and (d1)'s results and seconds where they rode
    another world (``dist_train_rank`` with ``argv`` + the domain flags
    for (d1))."""
    import torch
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.core import fcn3
    from repro_torch.core.sphere import disco as discolib
    from repro_torch.distributed import domain
    from repro_torch.distributed.compat import row_block
    from repro_torch.distributed.world import run_world
    from repro_torch.kernels import dispatch
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    report(f"[dist] (d) this process holds "
           f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
           f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the card "
           f"{(total - free) / 1e9:.2f} of {total / 1e9:.2f} GB in use")
    argv_d = argv + ["--fcn3-sharding", "domain"]
    report(f"[dist] (d1) launch/train.py {' '.join(argv_d)} on "
           f"{DIST_TRAIN_RANKS} latitude ranks of one card, both members on "
           "each rank's rows" + (" (in (c)'s world)" if part else ""))
    if part is None:
        res, _, out["domain_s"] = run_world_then(
            dist_train_rank, DIST_TRAIN_RANKS, (plans, argv_d),
            backend=DIST_BACKEND, timeout=900.0)
    else:
        res, out["domain_s"] = part
    loss, loss_rel, gerr, rel_all, worst, at = _vs_first_step(res, step0)
    for i, r in enumerate(res):
        hs = r["history"]
        report(f"[dist] (d1) rank {i}: io_rows={r['rows'][0]} latent_rows="
               f"{r['rows'][1]} step_s={[round(h['seconds'], 3) for h in hs]}"
               f" collective_s={[round(h['collective_s'], 3) for h in hs]} "
               f"(share "
               f"{[round(h['collective_s'] / h['seconds'], 3) for h in hs]})"
               f" halo_bytes={[int(h['halo_bytes']) for h in hs]} "
               f"bytes_by_kind={[_nonzero(h['kind_bytes']) for h in hs]} "
               f"loss={[round(h['loss'], 7) for h in hs]} |g|="
               f"{[round(h['grad_norm'], 6) for h in hs]} launches="
               f"{r['launches']} plain_calls_on_cuda={r['plain']} "
               f"peak_mem_gb={r['peak_gb']:.2f} peak_reserved_gb="
               f"{r['reserved_gb']:.2f} params_equal_rank0="
               f"{r['params_equal']}")
    report(f"[dist] (d1) first step vs the single-process first step: loss "
           f"{loss:.7f} vs {step0['loss']:.7f} (rel {loss_rel:.2e}, bar "
           f"{DIST_LOSS_RTOL:g}); gradients max_abs_err={gerr:.3e}, "
           f"|diff| / |ref| over all = {rel_all:.2e}, worst |diff| / (atol "
           f"+ rtol |ref|) = {worst:.3f} at {at[0]} (ref {at[1]:.4e}, diff "
           f"{at[2]:.3e}); phase {out['domain_s']:.1f} s")
    for i, r in enumerate(res):
        if min(r["launches"].values()) <= 0:
            raise AssertionError(f"(d1) rank {i} launches {r['launches']}")
        if any(r["plain"].values()) or not r["params_equal"]:
            raise AssertionError(f"(d1) rank {i}: plain {r['plain']}, "
                                 f"params equal {r['params_equal']}")
        if not all(h["halo_bytes"] > 0 for h in r["history"]):
            raise AssertionError(f"(d1) rank {i} exchanged no halo")
    if not (loss_rel <= DIST_LOSS_RTOL and worst <= 1.0):
        raise AssertionError(f"domain step disagrees: loss rel "
                             f"{loss_rel:.3e}, gradient {worst:.3f}")
    out["domain"] = [{k: v for k, v in r.items() if k != "grads"}
                     for r in res]
    want = step0["eval"]
    for i, r in enumerate(res):
        ev = r["eval"]
        rel = max(abs(ev["values"][k] - v) / abs(v) for k, v in want.items())
        report(f"[dist] (d4) rank {i} eval_step, {DOMAIN_EVAL_MEMBERS} "
               f"members on its rows at the initial parameters: "
               + " ".join(f"{k}={v:.7f}" for k, v in ev["values"].items())
               + f" (one process: "
               + " ".join(f"{k}={v:.7f}" for k, v in want.items())
               + f"; worst rel {rel:.2e}, bar {EVAL_RTOL:g}) seconds="
               f"{ev['seconds']:.3f} collective_s={ev['collective_s']:.3f} "
               f"launches={ev['launches']} plain_calls_on_cuda="
               f"{ev['plain']} peak_mem_gb={ev['peak_gb']:.2f}")
        if min(ev["launches"].values()) <= 0 or any(ev["plain"].values()):
            raise AssertionError(f"(d4) rank {i}: launches "
                                 f"{ev['launches']}, plain {ev['plain']}")
        if not rel <= EVAL_RTOL:
            raise AssertionError(f"(d4) rank {i}: the domain eval step "
                                 f"disagrees with one process: rel {rel:.3e}")
    report(f"[dist] (d4) the single process's eval step took "
           f"{step0['eval_s']:.3f} s")

    t0 = time.time()
    if small is None:
        res = run_world(dist_small_rank, DIST_SMALL_RANKS, (),
                        backend=DIST_BACKEND, timeout=600.0)
        out["small_s"] = time.time() - t0
    else:
        res, out["small_s"] = small
    for i, r in enumerate(res):
        report(f"[dist] (d2) {DIST_SMALL_CONFIG} forward rank {i}: io_rows="
               f"{r['rows']} latent_rows={r['latent_rows']} launches="
               f"{r['launches']} plain_calls_on_cuda={r['plain']}")
        if min(r["launches"].values()) <= 0 or r["plain"]:
            raise AssertionError(f"(d2) rank {i}: launches {r['launches']}"
                                 f", plain {r['plain']}")
    r0 = res[0]
    report(f"[dist] (d2) gathered forward vs the single process: "
           f"max_abs_err={r0['max_abs_err']:.3e}, worst |diff| / (atol + "
           f"rtol |ref|) = {r0['worst']:.3f} (rtol={STATE_RTOL} atol="
           f"{STATE_ATOL}), finite={r0['finite']}; phase "
           f"{out['small_s']:.1f} s")
    if not (r0["finite"] and r0["worst"] <= 1.0):
        raise AssertionError(f"(d2) the domain forward disagrees: "
                             f"{r0['worst']:.3f}")

    # (d3) rank 0's row-sliced bands at the planes (d1) gave them, each
    # through check_disco / check_transpose as a Recorder entry
    t_d3 = time.time()
    from repro_torch.kernels.disco import ops as disco_ops
    geo = fcn3.geometry(fcn3cfg.NAMED_CONFIGS[CONFIG]())
    cfg = fcn3cfg.NAMED_CONFIGS[CONFIG]()
    shapes = out["domain"][0]["shapes"]
    rows = []
    for name, h_out in (("enc", cfg.latent_nlat), ("latent", cfg.latent_nlat),
                        ("dec", cfg.nlat)):
        plan = discolib.make_disco_plan(*geo[name])
        block = row_block(h_out, 0, DIST_TRAIN_RANKS)
        need = domain.halo_rows(plan, *block)
        bufs = {k: torch.from_numpy(v).cuda() for k, v in
                domain.local_band_rows(plan, block, need).items()}
        ent = {"psi": bufs["psi_band"], "lat_idx": bufs["lat_idx"],
               "taps": disco_ops.LiveTaps.of(bufs),
               "rows": disco_ops.RowTaps.of(bufs), "h_in": len(need),
               "stride": plan.stride}
        psi = tuple(bufs["psi_band"].shape)
        fwd = {x: n for (ps, _, x), n in shapes["disco"].items() if ps == psi}
        bwd = {g: n for (ps, _, g), n in shapes["transpose"].items()
               if ps == psi}
        what = f"{name} rows {block} of {DIST_TRAIN_RANKS}"
        x = max(fwd, key=lambda x: x[0])
        # no conv1d yardstick: the sliced rows repeat the whole band's
        # work, timed in phase 7
        row = check_disco(dict(ent, shape=x, launches=sum(fwd.values())),
                          what, full=True, library=False)
        rows.append(dict(row, kernel="disco_band_contract",
                         path="dist_domain"))
        torch.cuda.empty_cache()
        if bwd:    # the encoders' inputs take no gradient
            g = max(bwd, key=lambda g: g[0])
            # no conv_transpose1d yardstick: the sliced rows repeat the
            # whole band's work, timed in phase 7
            row = check_transpose(dict(ent, shape=g,
                                       launches=sum(bwd.values())), what,
                                  library=False,
                                  plain_planes=DIST_PLAIN_PLANES)
            rows.append(dict(row, kernel="disco_band_transpose",
                             path="dist_domain"))
            torch.cuda.empty_cache()
        del bufs, ent
    # the CRPS kernels at the points of rank 0's terms, and of its eval
    for ent in out["domain"][0]["crps"]:
        rows += [dict(row, kernel="crps_fused", path="dist_domain")
                 for row in check_crps(ent)]
    for ent in out["domain"][0]["eval"]["crps"]:
        rows += [dict(row, kernel="crps_fused", path="dist_domain_eval")
                 for row in check_crps(ent)]
    # the Legendre kernel on rank 0's tables (domain_sht_tables: rows
    # padded to a multiple of the ranks, zero past lmax) at the pencils
    # (d1) gave it, in each layout it read them: the latent SHT's forward
    # table and pct transposed (the inverse SHT; the backwards read the
    # same shapes), the loss's forward table at the IO grid and its
    # transpose (the backward)
    for sht_name, h, inverse in (("latent_sht", cfg.latent_nlat, True),
                                 ("in_sht", cfg.nlat, False)):
        tables = domain.domain_sht_tables(
            geo[sht_name], [row_block(h, q, DIST_TRAIN_RANKS)
                            for q in range(DIST_TRAIN_RANKS)], "cuda",
            inverse=inverse)
        key = "pct" if inverse else "wpct"
        for what, table, ext in (
                ("wpct", tables["wpct"], tables["wpct_ext"]),
                (f"{key} transposed", tables[key].transpose(0, 1),
                 dispatch.transposed_extents(tables[f"{key}_ext"]))):
            shape = out["domain"][0]["legendre"].get(
                (tuple(table.shape), table.is_contiguous()))
            if shape is None:
                continue
            row = check_legendre(table, ext, shape, torch.complex64,
                                 f"{sht_name} {what}, rank 0 of "
                                 f"{DIST_TRAIN_RANKS}")
            rows.append(dict(row, kernel="legendre_contract",
                             path="dist_domain"))
        del tables
    if not any(r["kernel"] == "legendre_contract" for r in rows):
        raise AssertionError("(d3) no Legendre shape of (d1) matched rank "
                             "0's tables")
    out["domain_rows"] = rows
    out["d3_s"] = time.time() - t_d3
    return out


def ptxas_summary(text: str) -> str:
    """Registers and spill stores of the kernels in an ``nvcc -Xptxas -v``
    log: one value per kernel, in its order, or their range for more
    than four (the CRPS source compiles one kernel per member count)."""
    import re
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores", text)]
    if len(regs) > 4:
        return (f"{len(regs)} kernels: registers={min(regs)}..{max(regs)}"
                f" spill_stores={min(spills)}..{max(spills)}")
    return (f"registers={'/'.join(map(str, regs))} "
            f"spill_stores={'/'.join(map(str, spills))}")


def tune_phase(report, model, tuning_dir: str) -> dict:
    """[tune]: every tunable family swept through ``launch/tune.py``'s
    ``run`` into the ``TuningCache`` at ``tuning_dir``: at ``model``'s
    ``model_op_shapes`` (``MEMBERS`` members) and the LM prefill's SSD
    shape, ``TUNE_CANDIDATES`` tiles each, their libraries built first,
    all at once.  Every candidate is then held to the plain version on
    the sweep's own operands at ``REL_TOL`` (the transpose to the
    committed kernel: its plain version takes ~10 s at this shape, and
    phase 7 holds the committed kernel, and the winner, to it); the same
    sweep again must sweep nothing.  Returns per family the winner,
    its times and its check, and the phase's seconds."""
    import torch
    from repro_torch.configs.archs import get_arch
    from repro_torch.kernels import autotune, build
    from repro_torch.launch import tune as tune_mod
    t_phase = time.time()
    shapes = autotune.model_op_shapes(model, members=MEMBERS)
    shapes.update(autotune.lm_op_shapes(get_arch(LM_ARCH),
                                        LM_PREFILL_BATCH, 32768))
    libs = [autotune.library_for(op, d) for op, sh in shapes.items()
            for d in autotune.candidates(op, sh, TUNE_CANDIDATES)]
    nvcc_before = build.nvcc_runs
    t0 = time.time()
    build.build_all(libs)
    build_s = time.time() - t0
    report(f"[tune] built {build.nvcc_runs - nvcc_before} variant "
           f"libraries of {len(libs)} candidates in {build_s:.1f}s "
           f"(one nvcc each, in parallel)")
    cache = autotune.TuningCache(tuning_dir)
    runners = {op: autotune.OpRunner(op, sh) for op, sh in shapes.items()}
    t0 = time.time()
    entries = tune_mod.run(shapes, cache, max_candidates=TUNE_CANDIDATES,
                           iters=TUNE_ITERS, runners=runners,
                           out=lambda ln: report(f"[tune] {ln}"))
    sweep_s = time.time() - t0
    out: dict = {}
    for entry in entries:
        op, runner = entry["op"], runners[entry["op"]]
        # the reference: the plain version on the sweep's operands (the
        # transpose: the committed kernel, see above)
        ref = runner(None)() if op == "disco_bwd" else runner.plain()
        refs = ref if isinstance(ref, tuple) else (ref,)
        worst = 0.0
        for cand in entry["candidates"]:
            got = runner(autotune.blocks_of(op, cand["dims"]))()
            gots = got if isinstance(got, tuple) else (got,)
            worst = max([worst] + [errors(g, r)[1]
                                   for g, r in zip(gots, refs)])
            del got, gots
        del ref, refs
        torch.cuda.empty_cache()
        name, defines = autotune.library_for(op, entry["dims"])
        blocks = autotune.blocks_of(op, entry["dims"])
        ptxas = ptxas_summary(build.build_logs.get(
            (name, build.normalize_defines(defines)), ""))
        out[op] = {"shapes": tuple(shapes[op]), "dims": entry["dims"],
                   "blocks": blocks, "candidates": len(entry["candidates"]),
                   "default_ms": entry["default_us"] / 1e3,
                   "tuned_ms": entry["best_us"] / 1e3, "max_rel_err": worst,
                   "library": build.label(name, defines), "ptxas": ptxas}
        report(f"[tune] {op} shapes={'x'.join(map(str, shapes[op]))} "
               f"candidates={len(entry['candidates'])} default_us="
               f"{entry['default_us']:.1f} best_us={entry['best_us']:.1f} "
               f"best/default={entry['best_us'] / entry['default_us']:.3f} "
               f"dims={autotune.format_blocks(op, entry['dims'])} "
               f"({'committed' if blocks is None else 'variant'} "
               f"{build.label(name, defines)}; ptxas {ptxas}) "
               f"max_rel_err vs "
               f"{'the committed kernel' if op == 'disco_bwd' else 'plain'}"
               f" over every candidate={worst:.2e} (bar {REL_TOL})")
        if not (worst <= REL_TOL
                and entry["best_us"] <= entry["default_us"]):
            raise AssertionError(f"[tune] {op}: a candidate disagrees "
                                 f"(rel {worst:.3e}) or best > default")
    del runners
    gc.collect()
    torch.cuda.empty_cache()
    # the same sweep again: every entry from the cache
    again = tune_mod.run(shapes, cache, max_candidates=TUNE_CANDIDATES,
                         iters=TUNE_ITERS,
                         out=lambda ln: report(f"[tune] again: {ln}"))
    if any(e["swept"] for e in again):
        raise AssertionError("[tune] the second sweep swept again")
    return {"families": out, "build_s": build_s, "sweep_s": sweep_s,
            "variants": len(set(libs)), "stats": cache.stats(),
            "phase_s": time.time() - t_phase}


def tuned_lead(run, forecast: dict, tuning_dir: str) -> dict:
    """[main]'s forecast again (its model, sample, noise seed, members and
    leads) with the tuning cache at ``tuning_dir`` installed, through
    ``RequestSpec.engine_config``: the engine launches the tuned
    libraries.  Held to [main]'s states and scores at the dispatch bar;
    returns its seconds per lead, its launches, its blocks and the worst
    differences."""
    import numpy as np
    import torch
    from repro_torch.inference.engine import ForecastEngine, members_noise
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.serving.spec import RequestSpec
    previous = autotune.install_tuning_cache(tuning_dir)
    try:
        cfg = RequestSpec(config=CONFIG, members=MEMBERS,
                          lead_steps=LEAD_STEPS,
                          lead_chunk=1).engine_config()
    finally:
        autotune.install_tuning_cache(previous)
    model, ds = run.model, run.ds
    eng = ForecastEngine(model, cfg)
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    torch.cuda.synchronize()
    stamps = [time.time()]
    results = []
    for block in eng.stream(run.buffers, run.state0,
                            lambda n: ds.aux_fields(6.0 * (n + 1)),
                            members_noise(model, 7), steps=LEAD_STEPS,
                            truth=lambda n: ds.state(run.sample, n + 1)):
        results.append(block)
        torch.cuda.synchronize()
        stamps.append(time.time())
    out = {"lead_s": [b - a for a, b in zip(stamps[:-1], stamps[1:])],
           "launches": {"disco_band_contract": disco_ops.launches,
                        "legendre_contract": legendre_ops.launches},
           "blocks": cfg.kernels.blocks if cfg.kernels else (),
           "libraries": [build.label(*lib)
                         for lib in eng.kernel_libraries()]}
    worst = {}
    final = results[-1].final_state.cpu().numpy()
    want = forecast["final_state"].numpy()
    np.testing.assert_allclose(final, want, rtol=STATE_RTOL, atol=STATE_ATOL)
    worst["state"] = float(np.abs(final - want).max())
    for name, v in forecast["scores"].items():
        got = torch.cat([r.scores[name] for r in results]).cpu().numpy()
        atol = STATE_ATOL if name == "rank_hist" else SCORE_ATOL
        np.testing.assert_allclose(got, v.numpy(), rtol=SCORE_RTOL,
                                   atol=atol, err_msg=name)
        worst[name] = float(np.abs(got - v.numpy()).max())
    out["worst"] = worst
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"the tuned lead launched {out['launches']}")
    return out


def launch_counts() -> dict:
    """Every kernel's launch counter as it stands (read, not reset)."""
    from repro_torch.kernels.crps import ops as crps_ops
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"disco_band_contract": disco_ops.launches,
            "disco_band_transpose": disco_ops.transpose_launches,
            "legendre_contract": legendre_ops.launches,
            "crps_fused": crps_ops.launches,
            "crps_fused_bwd": crps_ops.bwd_launches,
            "ssd_intra_chunk": ssd_ops.launches,
            "ssd_chunk_recurrence": ssd_ops.state_launches,
            "ssd_intra_chunk_bwd": ssd_ops.bwd_launches,
            "ssd_chunk_recurrence_bwd": ssd_ops.state_bwd_launches}


def _launched(before: dict, after: dict) -> dict:
    """The launches between two ``launch_counts`` readings, where any."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def dry_count(name: str, build, guard, world=None) -> dict:
    """One counted dry run (``repro_torch.launch.dryrun``): ``build(dry)``
    makes the case inside a ``DryRun``, which counts its step; with
    ``world`` = (ranks, mesh shape) it runs as rank 0 of a fake world on
    a ``("data", "model")`` mesh of that shape.  No kernel may launch and
    no plain version run inside it.  Returns the roofline, the counts and
    the host seconds it took."""
    import contextlib
    from repro_torch.launch import counting, dryrun, mesh as meshlib
    from repro_torch.launch import roofline
    before, plain = launch_counts(), dict(guard.counts)
    t0 = time.time()
    with (dryrun.fake_world(world[0]) if world else contextlib.nullcontext()):
        mesh = (meshlib.make_mesh(world[1], ("data", "model"),
                                  counting.dry_run_device().type)
                if world else None)
        with counting.DryRun() as dry:
            case = build(dry, mesh)
            rl, counts = roofline.analyze(name, case.step, case.args,
                                          world[0] if world else 1,
                                          case.model_flops, dry)
    seconds = time.time() - t0
    moved = _launched(before, launch_counts())
    ran = {k: v - plain.get(k, 0) for k, v in guard.counts.items()
           if v != plain.get(k, 0)}
    if moved or ran:
        raise AssertionError(f"dry run {name}: launches {moved}, plain "
                             f"calls {ran} inside it")
    return {"roofline": rl, "counts": counts, "seconds": seconds}


def dryrun_hold(report, tag: str, dry: dict, launches: dict,
                measured_s: float, peak_gb: float) -> dict:
    """Hold a dry run to the card: each kernel family's calls against its
    launches in the same work on the card (equal), the live-set peak
    against ``max_memory_allocated`` there (within
    ``DRYRUN_PEAK_BAND``); print the terms beside the measured time."""
    from repro_torch.launch import roofline
    rl, counts = dry["roofline"], dry["counts"]
    calls = {f: v["calls"] for f, v in counts.kernels.items()}
    peak_ratio = counts.peak_bytes / 1e9 / peak_gb
    flops = counts.kernel_flops + counts.aten_flops
    report(f"[dryrun] {tag}: kernel calls {calls} against the card's "
           f"launches {launches}; FLOPs kernels {counts.kernel_flops:.4g} "
           + "(" + ", ".join(f"{f} {v['flops']:.4g}"
                             for f, v in counts.kernels.items())
           + f") aten {counts.aten_flops:.4g}; bytes kernels "
           f"{counts.kernel_bytes:.4g} aten {counts.aten_bytes:.4g}; "
           f"collectives {counts.collective_bytes()}; dry run "
           f"{dry['seconds']:.1f} s on the host")
    report(f"[dryrun] {tag}: live-set peak "
           f"{counts.peak_bytes / 1e9:.2f} GB "
           + str({k: round(v / 1e9, 2) for k, v in counts.at_peak.items()})
           + f" against max_memory_allocated {peak_gb:.2f} GB (ratio "
           f"{peak_ratio:.3f}, band {DRYRUN_PEAK_BAND}); t_compute="
           f"{rl.t_compute:.4f} s t_compute_fp32={rl.t_compute_fp32:.4f} s "
           f"t_memory={rl.t_memory:.4f} s bound={rl.step_time_bound:.4f} s "
           f"({rl.bottleneck}) measured={measured_s:.4f} s "
           f"bound/measured={rl.step_time_bound / measured_s:.4f} "
           f"FLOPs/(measured x 3xTF32 peak)="
           f"{flops / (measured_s * roofline.PEAK_FLOPS):.4f}")
    if calls != launches:
        raise AssertionError(f"{tag}: the dry run's kernel calls {calls} are "
                             f"not the card's launches {launches}")
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= peak_ratio <= hi:
        raise AssertionError(f"{tag}: the live-set peak is {peak_ratio:.3f} "
                             f"of max_memory_allocated")
    return {"calls": calls, "peak_ratio": peak_ratio,
            "bound_over_measured": rl.step_time_bound / measured_s}


def dryrun_train(guard) -> dict:
    """[dryrun] (i): the training phase's own step dry-run on one rank
    (``fcn3_full``, ``TRAIN_STAGE``, its ensemble, batch and rollout)."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.launch import dryrun, train as train_mod
    tcfg = train_mod.stage_to_tcfg(train_mod.STAGES[TRAIN_STAGE],
                                   TRAIN_ENSEMBLE, TRAIN_ROLLOUT)
    return dry_count("fcn3/train-cell", lambda dry, mesh: (
        dryrun.build_fcn3_case(
            "train", mesh, dry, cfg=fcn3cfg.NAMED_CONFIGS[CONFIG](),
            sizes=(TRAIN_BATCH, TRAIN_ENSEMBLE, TRAIN_ROLLOUT), tcfg=tcfg)),
        guard)


def dryrun_forecast(guard) -> dict:
    """[dryrun] (ii): one FCN3 forward of ``MEMBERS`` members at
    ``fcn3_full`` dry-run on one rank (the JAX ``inference`` case at E =
    MEMBERS and one chip)."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.launch import dryrun
    return dry_count("fcn3/forward", lambda dry, mesh: (
        dryrun.build_fcn3_case("inference", mesh, dry,
                               cfg=fcn3cfg.NAMED_CONFIGS[CONFIG](),
                               sizes=(1, MEMBERS, 1))), guard)


def dryrun_domain(guard) -> dict:
    """[dryrun] (iii): (d1)'s step dry-run as rank 0 of a fake 1 x 2 mesh
    (latitude over 2 ranks, the training cell's settings)."""
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.launch import dryrun, train as train_mod
    tcfg = train_mod.stage_to_tcfg(train_mod.STAGES[TRAIN_STAGE],
                                   TRAIN_ENSEMBLE, TRAIN_ROLLOUT)
    return dry_count("fcn3/domain-1x2", lambda dry, mesh: (
        dryrun.build_fcn3_case(
            "train", mesh, dry, cfg=fcn3cfg.NAMED_CONFIGS[CONFIG](),
            sizes=(TRAIN_BATCH, TRAIN_ENSEMBLE, TRAIN_ROLLOUT), tcfg=tcfg)),
        guard, world=(DIST_TRAIN_RANKS, (1, DIST_TRAIN_RANKS)))


def domain_dryrun(report, dry: dict, history: list[dict]) -> None:
    """[dryrun] (iii) held to (d1): rank 0's ``all_to_all_v`` bytes a step
    as counted against those ``compat`` measured in each of its steps;
    the other kinds beside them."""
    pred = dry["counts"].collective_bytes()
    for i, h in enumerate(history):
        got = _nonzero(h["kind_bytes"])
        pairs = {k: (pred.get(k, 0), got.get(k, 0))
                 for k in sorted(set(pred) | set(got))}
        report(f"[dryrun] (iii) domain step, rank 0 of a fake 1 x "
               f"{DIST_TRAIN_RANKS} mesh, against (d1) rank 0's step {i}: "
               + " ".join(f"{k} {p} / {g}" + ("" if p == g else " (differs)")
                          for k, (p, g) in pairs.items())
               + f" bytes (predicted / measured); halo_bytes "
               f"{h['halo_bytes']}")
        if pred.get("all_to_all_v", 0) != h["halo_bytes"]:
            raise AssertionError(f"(iii): the predicted all_to_all_v bytes "
                                 f"{pred.get('all_to_all_v')} are not (d1)'s "
                                 f"{h['halo_bytes']}")
    rl = dry["roofline"]
    report(f"[dryrun] (iii) roofline: t_compute={rl.t_compute:.4f} s "
           f"t_memory={rl.t_memory:.4f} s t_collective={rl.t_collective:.4f}"
           f" s (NVLink) peak {rl.peak_memory_per_device / 1e9:.2f} GB; dry "
           f"run {dry['seconds']:.1f} s on the host")


def production_dryrun_start() -> dict:
    """Start one production case of the dry-run CLI, ``--arch fcn3
    --shape train`` as rank 0 of 16 x 16 (domain), its record written
    with ``--out``, in a process of its own without the card: it counts
    fake tensors on the host, so it runs beside the kernel checks."""
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"),
                        "dryrun.jsonl")
    src = str(ROOT / "src")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=(
        src + os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else src))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "fcn3", "--shape", "train", "--out", path],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env)
    return {"proc": proc, "path": path, "t0": time.time()}


def production_dryrun(report, started: dict) -> float:
    """Wait for ``production_dryrun_start``'s case and read its record
    back: exit code 0, collective bytes > 0, finite terms.  Returns its
    seconds."""
    proc, path, t0 = started["proc"], started["path"], started["t0"]
    try:
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rc = proc.returncode
    if rc != 0:
        raise AssertionError(f"the production dry run exited {rc}: "
                             f"{err.decode(errors='replace')[-2000:]}")
    with open(path) as f:
        rec = json.loads(f.readline())
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    terms = [rec[k] for k in ("t_compute_s", "t_compute_fp32_s",
                              "t_memory_s", "t_collective_s", "mfu_bound")]
    report(f"[dryrun] CLI --arch fcn3 --shape train (rank 0 of "
           f"{rec['mesh']}, {rec['fcn3_sharding']}): rc={rc} io_rows="
           f"{rec['io_rows']} latent_rows={rec.get('latent_rows')} FLOPs "
           f"{rec['flops_per_device']:.4g} (kernels {rec['kernel_flops']:.4g}"
           f", aten {rec['aten_flops']:.4g}) bytes "
           f"{rec['hbm_bytes_per_device']:.4g} collectives "
           f"{rec['coll_breakdown']} peak "
           f"{rec['peak_memory_per_device'] / 1e9:.2f} GB "
           + str({k: round(v / 1e9, 2)
                  for k, v in rec["memory_analysis"].items()})
           + f" t_compute={rec['t_compute_s']:.4f} t_compute_fp32="
           f"{rec['t_compute_fp32_s']:.4f} t_memory={rec['t_memory_s']:.4f}"
           f" t_collective={rec['t_collective_s']:.4f} s bottleneck="
           f"{rec['bottleneck']} model_flops={rec['model_flops']:.4g} "
           f"mfu_bound={rec['mfu_bound']:.4f}; {time.time() - t0:.1f} s "
           f"in a process of its own beside the kernel checks")
    if not rec["collective_bytes_per_device"] > 0 or not all(
            math.isfinite(t) for t in terms):
        raise AssertionError(f"the production dry run: collective bytes "
                             f"{rec['collective_bytes_per_device']}, terms "
                             f"{terms}")
    return time.time() - t0


def timed_forward(run, members: int) -> dict:
    """One forward of ``members`` members on [main]'s model and buffers:
    its launches and peak over one call, its time the median of 3 more
    (CUDA events)."""
    import torch
    model, cfg = run.model, run.model.cfg
    g = torch.Generator(device="cuda").manual_seed(17)
    state = torch.randn((members, 1, cfg.n_state, cfg.nlat, cfg.nlon),
                        generator=g, device="cuda")
    cond = torch.randn((members, 1, cfg.n_cond_in, cfg.nlat, cfg.nlon),
                       generator=g, device="cuda")

    def fwd():
        with torch.no_grad():
            return model(run.buffers, state, cond)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    out = fwd()
    torch.cuda.synchronize()
    launches = _launched(before, launch_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(out).all())
    del out
    seconds = cuda_ms(fwd, reps=3, warmup=0) / 1e3
    del state, cond
    torch.cuda.empty_cache()
    return {"launches": launches, "peak_gb": peak_gb, "seconds": seconds,
            "finite": finite}


def dryrun_rows(report, dries: dict, rows: dict) -> int:
    """Phase 7's rows at a shape a dry run counted: the same FLOPs and
    bytes a call (the same formulas on the same tables' non-zeros);
    returns how many rows were held."""
    held = 0
    for tag, dry in dries.items():
        calls = dry["counts"].kernel_calls
        for row in (r for rs in rows.values() for r in rs):
            ent = calls.get(tuple(row.get("call", ())))
            if ent is None:
                continue
            n, flops, nbytes = ent
            held += 1
            ok = (math.isclose(flops / n, row["flops"], rel_tol=1e-12)
                  and math.isclose(nbytes / n, row["bytes"], rel_tol=1e-12))
            report(f"[dryrun] {tag} vs phase 7's {row['call'][0]} "
                   f"{row['shape']}: FLOPs {flops / n:.6g} / "
                   f"{row['flops']:.6g} bytes {nbytes / n:.6g} / "
                   f"{row['bytes']:.6g} a call "
                   f"({n} calls in the dry run)")
            if not ok:
                raise AssertionError(f"{tag}: the dry run's counts at "
                                     f"{row['shape']} are not phase 7's")
    return held


def main() -> int:
    """Run every phase; 0 only when all of them pass."""
    # the [dist] phase puts two ranks of 30-34 GB beside this process on
    # the card: expandable segments keep what each process reserves close
    # to what it allocates (without them this process held 1.5 GB in 5.2
    # GB reserved there, and a rank 4.7 GB beyond its allocations); set
    # before the first CUDA allocation, and inherited by the ranks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import fcn3 as fcn3cfg
    from repro_torch.kernels import build
    from repro_torch.kernels.disco import ops as disco_ops
    from repro_torch.kernels.legendre import ops as legendre_ops
    from repro_torch.launch import lm as lm_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import set_precision
    set_precision()
    torch.backends.cudnn.benchmark = False

    # host seconds of each phase, printed at the end against the limit
    phase_s: dict = {}
    t_lap = [time.time()]

    def lap(name: str) -> None:
        phase_s[name] = time.time() - t_lap[0]
        t_lap[0] = time.time()

    # -- phase 1: card, versions, build ----------------------------------
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" count {torch.cuda.device_count()}")
    host_checks(log)
    t0 = time.time()
    build.build_all()
    log(f"[build] {len(build.SOURCES)} kernels built in "
        f"{time.time() - t0:.1f}s (sm_90a)")
    for key, text in build.build_logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {build.label(*key)}: {ln.strip()}")

    # the distributed phase's files: [main]'s parameters (for (e) and the
    # evaluate phase), the training cell's, the plans handed to ranks
    dist_tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    atexit.register(shutil.rmtree, dist_tmp, ignore_errors=True)

    lap("build")
    # -- phase 2: the main path -------------------------------------------
    guard = PlainGuard()
    rec = Recorder()
    stamps: list[float] = []
    # the last lead (steady: every kernel built, the allocator warm) runs
    # under torch.profiler, started and stopped at the lead lines; device
    # activity only, so the host's issue is not slowed by op recording
    leads = []
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof_started = []   # host clock once the profiler is up

    def report(line: str) -> None:
        stamps.append(time.time())
        log(line if line.startswith("[") else f"[serve] {line}")
        if line.startswith("lead"):
            leads.append(stamps[-1])
            if len(leads) == LEAD_STEPS - 1:
                prof.start()
                prof_started.append(time.time())
            elif len(leads) == LEAD_STEPS:
                torch.cuda.synchronize()
                prof.stop()

    torch.cuda.reset_peak_memory_stats()
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    t0 = time.time()
    run = serve_mod.setup(CONFIG, device="cuda",
                          calibration_rounds=CALIBRATION_ROUNDS)
    results = serve_mod.serve(
        CONFIG, MEMBERS, LEAD_STEPS, lead_chunk=1, report=report, run=run)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    launches = {"disco_band_contract": disco_ops.launches,
                "legendre_contract": legendre_ops.launches}
    rec.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lead_s = [b - a for a, b in zip(stamps[:-1], stamps[1:-1])]
    log(f"[main] config={CONFIG} members={MEMBERS} "
        f"leads={LEAD_STEPS} calibration_rounds={CALIBRATION_ROUNDS} "
        f"total_s={total_s:.1f} "
        f"setup_and_calibration_s={stamps[0] - t0:.1f} "
        f"per_lead_s={[round(s, 2) for s in lead_s]} "
        f"peak_mem_gb={peak_gb:.2f} launches={launches}")
    for name in ("crps", "ens_rmse", "spread", "ssr"):
        vals = torch.cat([r.scores[name] for r in results])
        if vals.shape[0] != LEAD_STEPS or not torch.isfinite(vals).all():
            raise AssertionError(f"score {name} not finite / wrong shape "
                                 f"{tuple(vals.shape)}")
    final = results[-1].final_state
    if not torch.isfinite(final).all():
        raise AssertionError("final ensemble state is not finite")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the profiler's own start-up is left out of the profiled lead's wall
    # time; the unprofiled lead before it is the yardstick of its busy share
    profile = lm_mod.report_profile(prof, leads[-1] - prof_started[0], log,
                                    top=12)
    steady_s = leads[-2] - leads[-3]
    log(f"[profile] the forecast's lead {LEAD_STEPS} above (2 members, "
        f"fcn3_full), under torch.profiler; lead {LEAD_STEPS - 1} took "
        f"{steady_s:.3f} s unprofiled: device busy "
        f"{profile['busy_s'] / steady_s:.3f} of it"
        if profile["busy_s"] else "[profile] no device time recorded")
    del prof
    if any(guard.counts.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors in the "
                             f"forecast: {guard.counts}")
    # kept for (e) and phase 2d: the scores and final members (host
    # copies) and the parameters, in the reference checkpoint format
    from repro_torch.train import checkpoint as ckptlib
    forecast = {
        "scores": {name: torch.cat([r.scores[name] for r in results]).cpu()
                   for name in results[0].scores},
        "final_state": final.cpu(),
        "ckpt": ckptlib.save_checkpoint(
            os.path.join(dist_tmp, "forecast"), 0,
            dict(run.model.named_parameters()))}
    del results, final
    gc.collect()
    torch.cuda.empty_cache()

    # -- [dryrun] (ii): the forecast step counted on fake tensors, held to
    # one forward of [main]'s model on the card
    dry = {"(ii)": dryrun_forecast(guard)}
    fw = timed_forward(run, MEMBERS)
    dryrun_hold(log, f"(ii) forecast forward, {MEMBERS} members, "
                f"fcn3_{CONFIG}", dry["(ii)"], fw["launches"], fw["seconds"],
                fw["peak_gb"])
    if not fw["finite"]:
        raise AssertionError("the timed forward is not finite")

    lap("main")
    # -- phase 2a: the kernel tiles tuned on this card, a tuned lead -------
    gc.collect()
    torch.cuda.empty_cache()
    tuning_dir = os.path.join(dist_tmp, "tuning")
    t0 = time.time()
    tuned = tune_phase(log, run.model, tuning_dir)
    lead = tuned_lead(run, forecast, tuning_dir)
    tune_s = time.time() - t0
    log(f"[tune] tuned lead: {MEMBERS} members x {LEAD_STEPS} leads of "
        f"[main]'s forecast through RequestSpec.engine_config with the "
        f"cache installed; blocks={list(lead['blocks'])} libraries="
        f"{lead['libraries']} per_lead_s="
        f"{[round(x, 3) for x in lead['lead_s']]} against [main]'s "
        f"{[round(x, 3) for x in lead_s]} (its last profiled); launches="
        f"{lead['launches']}; vs [main] max_abs_err: "
        + " ".join(f"{k}={v:.3e}" for k, v in lead["worst"].items())
        + f" (state rtol={STATE_RTOL} atol={STATE_ATOL}; scores "
          f"rtol={SCORE_RTOL} atol={SCORE_ATOL})")
    log(f"[tune] card: {card}; phase_s={tune_s:.1f} (sweeps and checks "
        f"{tuned['phase_s']:.1f} s: the build {tuned['build_s']:.1f} s, "
        f"the first sweep {tuned['sweep_s']:.1f} s; the tuned lead the "
        f"rest) cache={tuned['stats']}")
    del lead
    gc.collect()
    torch.cuda.empty_cache()

    lap("tune")
    # -- phase 2b: the engine's other paths on the same model --------------
    gc.collect()
    torch.cuda.empty_cache()
    disco_ops.reset_launches()
    legendre_ops.reset_launches()
    guard.counts = dict.fromkeys(guard.counts, 0)
    eng_rec = Recorder()    # the engine path's own shapes
    t0 = time.time()
    eng = engine_phase(run, log)
    torch.cuda.synchronize()
    engine_s = time.time() - t0
    engine_launches = {"disco_band_contract": disco_ops.launches,
                       "legendre_contract": legendre_ops.launches}
    eng_rec.close()
    engine_plain = dict(guard.counts)
    del run
    w1 = eng["e1_worst"]
    # member-leads per second over the steady (last) lead
    rate_b = 2 * ENGINE_MEMBERS / eng["batched_lead_s"][-1]
    rate_s = ENGINE_MEMBERS / eng["serial_lead_s"][-1]
    log(f"[engine] E1 coalesced: 2 requests x {ENGINE_MEMBERS} members, "
        f"{ENGINE_LEADS} leads (chunks of 2), obs perturbations 0.05, "
        f"spectra; batched per_lead_s="
        f"{[round(x, 3) for x in eng['batched_lead_s']]} "
        f"member_leads_per_s={rate_b:.3f} "
        f"peak_mem_gb={eng['batched_peak_gb']:.2f}; request 0 alone "
        f"per_lead_s={[round(x, 3) for x in eng['serial_lead_s']]} "
        f"member_leads_per_s={rate_s:.3f} "
        f"peak_mem_gb={eng['serial_peak_gb']:.2f}; "
        f"setup_s={eng['e1_setup_s']:.1f} staging={eng['batched_stats']} "
        f"launches={eng['e1_launches']} (both runs)")
    log(f"[engine] E1 batched vs serial max_abs_err: "
        + " ".join(f"{k}={v:.3e}" for k, v in w1.items())
        + f" (state rtol={STATE_RTOL} atol={STATE_ATOL}; scores "
          f"rtol={SCORE_RTOL} atol={SCORE_ATOL}, rank_hist atol="
          f"{STATE_ATOL})")
    log(f"[engine] E2 bf16 policy: bf16 per_lead_s="
        f"{[round(x, 3) for x in eng['bfloat16_lead_s']]} peak_mem_gb="
        f"{eng['bfloat16_peak_gb']:.2f}; fp32 per_lead_s="
        f"{[round(x, 3) for x in eng['float32_lead_s']]} peak_mem_gb="
        f"{eng['float32_peak_gb']:.2f}; final state bf16, max |bf16 - fp32|"
        f"={eng['bf16_vs_fp32']:.4f} (bar {BF16_BAR}); scores fp32, finite")
    prof = eng["profile"]
    log("[profile] bf16 lead GEMM kernels by device time: " + "; ".join(
        f"{name[:60]} x{n} {ms:.1f} ms" for name, (n, ms)
        in prof["gemms"][:6]) + " | products by operand dtypes: " + ", ".join(
        f"{op}({dts}) x{n}" for (op, dts), n in sorted(
            prof["products"].items(), key=lambda kv: -kv[1])))
    log(f"[engine] E3 bred init: 4 members, 3 cycles, ensemble transform; "
        f"init_s={eng['bred_init_s']:.2f} lead_s={eng['bred_lead_s'][0]:.2f} "
        f"peak_mem_gb={eng['bred_peak_gb']:.2f} pair_mean_vs_state0="
        f"{eng['bred_pair_rel']:.2e} of max|state0| (bar {PAIR_TOL}) "
        f"transform_gram_err={eng['bred_gram_err']:.2e} (bar {ORTHO_TOL}) "
        f"final_draw_cosine={eng['bred_cosine']:.3f} "
        f"crps={eng['bred_crps']:.4f}")
    log(f"[engine] phase_s={engine_s:.1f} launches={engine_launches} "
        f"plain_calls_on_cuda={engine_plain}")
    for name, n in engine_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in the engine phase")
    if any(engine_plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors in the "
                             f"engine phase: {engine_plain}")
    for key in ("batched_peak_gb", "serial_peak_gb", "bfloat16_peak_gb",
                "float32_peak_gb", "bred_peak_gb"):
        if not eng[key] < 80:
            raise AssertionError(f"{key} = {eng[key]:.2f} GB")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    lap("engine")
    # -- phase 2d: the WB2 evaluation CLI from [main]'s parameters ---------
    ev = evaluate_phase(log, forecast["ckpt"], guard)
    log(f"[evaluate] config={CONFIG} members={EVAL_MEMBERS} leads="
        f"{EVAL_LEADS} initial_conditions={EVAL_ICS}: seconds="
        f"{ev['seconds']:.1f} setup_s={ev['setup_s']:.1f} ic_s="
        f"{[round(x, 2) for x in ev['ic_s']]} peak_mem_gb="
        f"{ev['peak_gb']:.2f} launches={ev['launches']} "
        f"plain_calls_on_cuda={ev['plain']} entries={ev['entries']} "
        f"finite={ev['finite']}")
    if not ev["finite"] or min(ev["launches"].values()) <= 0 or any(
            ev["plain"].values()):
        raise AssertionError(f"evaluate: finite {ev['finite']}, launches "
                             f"{ev['launches']}, plain {ev['plain']}")
    gc.collect()
    torch.cuda.empty_cache()

    lap("evaluate")
    # -- phase 2c: the forecast service (the forecast's model is gone) ------
    # packed with [tune]'s cache installed: the replica boots with its
    # tunings and their libraries
    from repro_torch.kernels import autotune
    t0 = time.time()
    autotune.install_tuning_cache(tuning_dir)
    try:
        svc = service_phase(log, guard=guard)
    finally:
        autotune.install_tuning_cache(None)
    service_s = time.time() - t0
    service_launches = svc["launches"]
    # later phases load their libraries as before (the bundle's directory
    # is gone; its libraries stay mapped); the plans and tables the
    # replica installed stay, the same a build makes: building them again
    # took 15-23 s of the training phase's set-up on the card
    build.reset_registry()
    gc.collect()
    torch.cuda.empty_cache()
    (n_plans, plan_bytes), (n_libs, lib_bytes) = (
        svc["bundle"]["plans/"], svc["bundle"]["blobs/"])
    info = svc["info"]
    log(f"[service] card: {card}")
    log(f"[service] bundle for {dict(SERVICE_SPEC, config='full')} at "
        f"batch 1 and 2: {n_plans} plans {plan_bytes / 1e9:.3f} GB, "
        f"{n_libs} kernel libraries {lib_bytes / 1e6:.3f} MB, "
        f"{svc['tunings']} tunings; plans_build_s={svc['plans_build_s']:.2f}"
        f" pack_s={svc['pack_s']:.1f}")
    log(f"[service] readonly replica boot: boot_s={svc['boot_s']:.1f} "
        f"(programs={info['programs']} disk_hits={info['disk_hits']} "
        f"warm_s={info['boot_s']}) plans_install_s="
        f"{info['plans_install_s']} against plans_build_s="
        f"{svc['plans_build_s']:.2f}; nvcc runs during boot="
        f"{svc['nvcc_during_boot']}; {info['libraries']} libraries "
        f"loaded from the bundle: {svc['libraries']}; {info['tunings']} "
        f"tunings installed; the served engine's blocks: "
        f"{list(svc['blocks'])}")
    for tag, res in zip(("R1 alone", "R2 coalesced", "R3 coalesced"),
                        svc["served"]):
        t = res.timing
        log(f"[service] {tag} ({res.request_id}, sample "
            f"{res.spec['sample']}, seed {res.spec['seed']}): "
            f"batch_size={res.batch_size} "
            + " ".join(f"{k}={t[k]:.3f}" for k in
                       ("queue_s", "setup_s", "compile_s", "run_s",
                        "total_s"))
            + f" cache={res.cache}")
    r1, r2 = svc["served"][0], svc["served"][1]
    member_leads = SERVICE_SPEC["members"] * SERVICE_SPEC["lead_steps"]
    log(f"[service] member-leads per second: alone "
        f"{member_leads / r1.timing['run_s']:.3f}, coalesced "
        f"{2 * member_leads / r2.timing['run_s']:.3f} (run_s of the "
        f"shared rollout)")
    log(f"[service] estimated_bytes={svc['estimated_bytes'] / 1e9:.3f} GB "
        f"(the engine's own tensors and its warm keys' working sets) + "
        f"model params and buffers {svc['model_bytes'] / 1e9:.3f} GB, "
        f"against peak_mem_gb={svc['peak_gb']:.3f} measured over the three "
        f"requests")
    log(f"[service] /v1/stats batches={svc['stats']['batches']} "
        f"cache={svc['stats']['cache']} served={svc['stats']['served']}; "
        f"R1 equals a direct engine bitwise; R2/R3 vs serial max_abs_err: "
        + " ".join(f"{k}={v:.3e}" for k, v in
                   svc["coalesced_vs_serial"].items())
        + f" (state rtol={STATE_RTOL} atol={STATE_ATOL}; scores "
          f"rtol={SCORE_RTOL} atol={SCORE_ATOL}, rank_hist atol="
          f"{STATE_ATOL})")
    log(f"[service] host seconds: plans {svc['plans_build_s']:.1f}, pack "
        f"{svc['pack_s']:.1f}, boot {svc['boot_s']:.1f}, the three requests "
        f"{svc['serve_s']:.1f}, server and scheduler closed "
        f"{svc['close_s']:.1f}, three direct engines and their checks "
        f"{svc['direct_s']:.1f}")
    log(f"[service] phase_s={service_s:.1f}; from the booted replica to "
        f"the last served request: launches={service_launches} "
        f"plain_calls_on_cuda={svc['plain']}; the boot's calibration "
        f"alone: launches={svc['boot_launches']} "
        f"plain_calls_on_cuda={svc['boot_plain']}")
    del svc

    lap("service")
    # -- phase 3: small input against the reference path -------------------
    err = small_input_check()
    log(f"[check] fcn3_smoke kernel path vs reference path on the card: "
        f"max_abs_err={err:.3e} (rtol=1e-4, atol=1e-5)")
    torch.cuda.empty_cache()

    lap("small_check")
    # -- phase 4: training (the forecast's model is gone) ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    train_rec = Recorder()
    guard.counts = dict.fromkeys(guard.counts, 0)
    summary = train_phase(
        lambda line: log(line if line.startswith("[") else f"[train] {line}"),
        keep=dist_tmp, steps_done=train_rec.close)
    plain_calls = dict(guard.counts)
    for i, (h, sec) in enumerate(zip(summary["history"],
                                     summary["step_s"])):
        log(f"[train] step {i} loss={h['loss']:.6f} nodal={h['nodal_0']:.6f}"
            f" spectral={h['spectral_0']:.6f} |g|={h['grad_norm']:.6f} "
            f"seconds={sec:.2f}")
    log(f"[train] config={CONFIG} stage={TRAIN_STAGE} "
        f"ensemble={TRAIN_ENSEMBLE} batch={TRAIN_BATCH} "
        f"rollout={TRAIN_ROLLOUT} steps={TRAIN_STEPS} "
        f"calibration_rounds={TRAIN_CALIBRATION_ROUNDS} "
        f"setup_s={summary['setup_s']:.1f} "
        f"step_s={[round(x, 2) for x in summary['step_s']]} "
        f"peak_mem_gb={summary['peak_mem_gb']:.2f} "
        f"params_changed={summary['changed']}/{summary['n_params']} "
        f"launches={summary['launches']} plain_calls_on_cuda={plain_calls}")
    for name, n in summary["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the training "
                                 "path")
    for h in summary["history"]:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                and h["grad_norm"] > 0):
            raise AssertionError(f"training diverged or has no gradient: {h}")
    if summary["changed"] == 0:
        raise AssertionError("no parameter changed in training")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors during "
                             f"training: {plain_calls}")
    torch.cuda.empty_cache()

    # -- [dryrun] (i): the training cell's step counted on fake tensors,
    # held to the steady step's launches (the counters read, not reset)
    dry["(i)"] = dryrun_train(guard)
    dryrun_hold(log, f"(i) train step, fcn3_{CONFIG} {TRAIN_STAGE} "
                f"E={TRAIN_ENSEMBLE} batch={TRAIN_BATCH} "
                f"rollout={TRAIN_ROLLOUT}", dry["(i)"],
                summary["step_launches"], summary["step_s"][-1],
                summary["peak_mem_gb"])

    lap("train")
    # -- phase 5: small-input gradients against the reference path ----------
    gerr = small_gradient_check()
    log(f"[check] fcn3_smoke train-step gradients, kernel path vs reference "
        f"path on the card: max_abs_err={gerr:.3e} "
        f"(rtol={GRAD_RTOL}, atol={GRAD_ATOL})")
    torch.cuda.empty_cache()

    lap("gradient_check")
    # -- phase 5b: distribution, every rank a process on the card ----------
    try:
        dist = dist_phase(log, summary.pop("step0"), dist_tmp, forecast,
                          guard)
        # -- [dryrun] (iii): (d1)'s step counted as rank 0 of a fake 1 x 2
        # mesh
        t0 = time.time()
        dry["(iii)"] = dryrun_domain(guard)
        domain_dryrun(log, dry["(iii)"], dist["domain"][0]["history"])
        dist["dryrun_iii_s"] = time.time() - t0
    finally:
        shutil.rmtree(dist_tmp, ignore_errors=True)
    del forecast
    gc.collect()
    torch.cuda.empty_cache()
    lap("dist")
    # (f) with [dryrun] (iv), and (g), ran inside (c)'s and (b)'s worlds:
    # their seconds (the single-process sides, the ranks' parts, the
    # checks) apart from the rest of [dist]
    phase_s["dist_channel"] = dist["channel_s"]
    phase_s["dist_experts"] = dist["experts_s"]
    phase_s["dist"] -= phase_s["dist_channel"] + phase_s["dist_experts"]
    d4 = max(r["eval"]["seconds"] for r in dist["domain"])
    log(f"[dist] card: {card}; host seconds by part: (a) selftest "
        f"{dist['selftest_s']:.1f}, (b) Algorithms 1-2 "
        f"{dist['geometry_s']:.1f}, (c) training "
        f"{dist['train_s']:.1f}, (d1) domain training "
        f"{dist['domain_s']:.1f} ({DIST_TRAIN_STEPS} step; with (d4) "
        f"inside its ranks, {d4:.1f} of them), (d2) domain forward "
        f"{dist['small_s']:.1f}, (d3) rank 0's kernels "
        f"{dist['d3_s']:.1f}, (e) engine over ranks "
        f"{dist['engine_s']:.1f}; [dryrun] (iii) "
        f"{dist['dryrun_iii_s']:.1f}; (f) channel "
        f"{dist['channel_s']:.1f} (in (c)'s ranks "
        f"{dist['channel_world_s']:.1f}), [dryrun] (iv) "
        f"{dist['dryrun_iv_s']:.1f}, (g) experts {dist['experts_s']:.1f} "
        f"(at full width in (c)'s ranks "
        f"{dist['experts_full']['seconds']:.1f})")
    # -- [examples]: the twins of examples/ on the card --------------------
    gc.collect()
    torch.cuda.empty_cache()
    examples = examples_phase(log, guard)
    torch.cuda.empty_cache()
    lap("examples")
    # -- phase 6: the LM path (the FCN3 models are gone) ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    lm_rec = Recorder()
    guard.counts = dict.fromkeys(guard.counts, 0)
    lm = lm_phase(log)
    lm_rec.close()
    lm_plain_calls = dict(guard.counts)
    pf, ps, dc, ds = (lm["prefill"], lm["prefill_steady"], lm["decode"],
                      lm["decode_steady"])
    consist_rel = lm["consist_err"] / lm["consist_scale"]
    log(f"[lm] prefill batch={LM_PREFILL_BATCH} seq_len=32768: "
        f"seconds={pf['seconds']:.3f} (steady {ps['seconds']:.3f}) "
        f"tokens_per_s={pf['tokens_per_s']:.0f} (steady "
        f"{ps['tokens_per_s']:.0f}) peak_mem_gb={pf['peak_mem_gb']} "
        f"ssd_launches={lm['launches']} "
        f"ssd_state_launches={lm['state_launches']} "
        f"logits={lm['logits_shape']} "
        f"finite={lm['logits_finite']} max_abs_logit={lm['logits_max']:.3f}")
    log(f"[lm] decode batch=128 steps={LM_DECODE_STEPS}: "
        f"ms_per_step={dc['ms_per_step']:.3f} (steady "
        f"{ds['ms_per_step']:.3f}) tokens_per_s={dc['tokens_per_s']:.0f} "
        f"(steady {ds['tokens_per_s']:.0f}) peak_mem_gb={dc['peak_mem_gb']} "
        f"ssd_launches={dc['ssd_launches']} finite={lm['decode_finite']}")
    log(f"[lm] prefill vs recurrence, 2 x {LM_CONSIST_TOKENS} tokens: "
        f"max_abs_err={lm['consist_err']:.3e} max_abs_logit="
        f"{lm['consist_scale']:.3f} rel={consist_rel:.3e} (bar "
        f"{LM_CONSIST_TOL:g}) ssd_launches={lm['consist_launches']} "
        f"plain_calls_on_cuda={lm_plain_calls}")
    if not lm["launches"] == lm["state_launches"] == lm["n_layers"]:
        raise AssertionError(f"SSD kernels launched {lm['launches']} and "
                             f"{lm['state_launches']} times in one prefill, "
                             f"want one each per layer")
    if lm["logits_shape"] != (LM_PREFILL_BATCH, 32768, 50432) or not (
            lm["logits_finite"] and lm["decode_finite"]):
        raise AssertionError(f"LM logits wrong shape or not finite: {lm}")
    if not consist_rel <= LM_CONSIST_TOL:
        raise AssertionError(f"prefill and recurrence disagree: rel "
                             f"{consist_rel:.3e} > {LM_CONSIST_TOL}")
    if any(lm_plain_calls.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors on the LM "
                             f"path: {lm_plain_calls}")
    gc.collect()
    torch.cuda.empty_cache()

    lap("lm")
    # -- phase 6a: LM training at full width, the SSD backward kernels ------
    lt = lm_train_phase(log, guard)
    lt_plain = lt["plain"]
    steps = lt["steps"]
    ltcfg = lt["cfg"]
    want_launches = {"ssd_intra_chunk": 2 * lt["n_layers"],
                     "ssd_chunk_recurrence": 2 * lt["n_layers"],
                     "ssd_intra_chunk_bwd": lt["n_layers"],
                     "ssd_chunk_recurrence_bwd": lt["n_layers"]}
    seq = 4096
    log(f"[lm-train] arch={ltcfg.name} layers={ltcfg.n_layers} d_model="
        f"{ltcfg.d_model} heads={ltcfg.ssm.n_heads} d_state="
        f"{ltcfg.ssm.d_state} chunk={ltcfg.ssm.chunk} params={lt['params']} "
        f"batch={LM_TRAIN_BATCH} (train_4k's 256 cut) seq_len={seq} "
        f"steps={LM_TRAIN_STEPS} remat=True lr={LM_TRAIN_LR:g}: setup_s="
        f"{lt['setup_s']:.1f} step_s={[round(x['seconds'], 3) for x in steps]}"
        f" tokens_per_s={[round(LM_TRAIN_BATCH * seq / x['seconds']) for x in steps]}"
        f" loss={[round(x['loss'], 6) for x in steps]} peak_mem_gb="
        f"{lt['peak_gb']:.2f} ({lt['resident_gb']:.2f} GB resident before:"
        f" parameters and Adam's moments) launches a step="
        f"{steps[-1]['launches']} plain_calls_on_cuda={lt_plain}")
    held_lt = dryrun_hold(
        log, f"(lm-train) {LM_ARCH} train step, batch {LM_TRAIN_BATCH} x "
        f"{seq}, remat", lt["dry"], steps[-1]["launches"],
        steps[-1]["seconds"], lt["peak_gb"])
    lt_rows = {"ssd_intra_chunk_bwd": [], "ssd_chunk_recurrence_bwd": []}
    for intra_row, rec_row in lt["bwd_rows"]:
        for name, row in (("ssd_intra_chunk_bwd", intra_row),
                          ("ssd_chunk_recurrence_bwd", rec_row)):
            # (a)'s shape is the kernels' main path; the others by tag
            row = dict(row, path=None if row["what"] == "train"
                       else f"lm_train_{row['what']}")
            lt_rows[name].append(row)
    if dryrun_rows(log, {"(lm-train)": lt["dry"]}, lt_rows) < 2:
        raise AssertionError("the [lm-train] dry run did not count the "
                             "backward kernels at (b)'s train shape")
    log(f"[lm-train] card: {card}; host s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in lt["parts_s"].items())
        + f"; dry run calls = launches {held_lt['calls'] == want_launches}")
    for i, st in enumerate(steps):
        if st["launches"] != want_launches:
            raise AssertionError(f"[lm-train] step {i} launched "
                                 f"{st['launches']}, want {want_launches}")
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
                and st["grad_norm"] > 0):
            raise AssertionError(f"[lm-train] step {i} diverged: {st}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"[lm-train] the loss did not fall: "
                             f"{[x['loss'] for x in steps]}")
    if any(lt_plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors in LM "
                             f"training: {lt_plain}")
    for f in lt["families"]:
        if not (f["rel"] <= LM_TRAIN_LOSS_RTOL
                and f["grad_worst"] <= GRAD_ATOL):
            raise AssertionError(f"[lm-train] (c) {f['arch']}: the card's "
                                 f"loss or gradients are off the CPU's: {f}")
        if f["family"] in ("ssm", "hybrid") and f["ssd_bwd"] <= 0:
            raise AssertionError(f"[lm-train] (c) {f['arch']}: no SSD "
                                 "backward launch")
    lm_train_launches = steps[-1]["launches"]
    del lt
    gc.collect()
    torch.cuda.empty_cache()

    lap("lm_train")
    # -- phase 6b: the attention LMs at their published widths ----------
    hy_rec = Recorder()
    guard.counts = dict.fromkeys(guard.counts, 0)
    t_hy = time.time()
    hy = lm_hybrid_phase(log)
    hy_rec.close()
    fams = [attention_family_phase(log, *c) for c in ATTN_FAMILY_CHECKS]
    hy_s = time.time() - t_hy
    hy_plain_calls = dict(guard.counts)
    hpf, hps, hdc, hds = (hy["prefill"], hy["prefill_steady"], hy["decode"],
                          hy["decode_steady"])
    hy_rel = hy["consist_err"] / hy["consist_scale"]
    split, busy = hy["split_ms"], hy["profile"]["busy_s"]
    attn_ms = hy["attn_unit_ms"] * hy["units"]
    log(f"[lm-hybrid] prefill batch={HYBRID_PREFILL_BATCH} seq_len=32768: "
        f"seconds={hpf['seconds']:.3f} (steady {hps['seconds']:.3f}) "
        f"tokens_per_s={hpf['tokens_per_s']:.0f} (steady "
        f"{hps['tokens_per_s']:.0f}) peak_mem_gb={hpf['peak_mem_gb']} "
        f"ssd_launches={hy['launches']} "
        f"ssd_state_launches={hy['state_launches']} "
        f"logits={hy['logits_shape']} finite={hy['logits_finite']} "
        f"max_abs_logit={hy['logits_max']:.3f}")
    log(f"[lm-hybrid] profiled prefill's device time by kernel kind: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in split.items())
        + (f" of busy {1e3 * busy:.1f}ms" if busy else "")
        + f"; one unit's attention alone {hy['attn_unit_ms']:.1f} ms "
        f"(CUDA events), x{hy['units']} = {attn_ms:.1f} ms")
    log(f"[lm-hybrid] decode batch={HYBRID_DECODE_BATCH} seq_len=32768 "
        f"steps={LM_DECODE_STEPS}: ms_per_step={hdc['ms_per_step']:.3f} "
        f"(steady {hds['ms_per_step']:.3f}) tokens_per_s="
        f"{hdc['tokens_per_s']:.0f} (steady {hds['tokens_per_s']:.0f}) "
        f"peak_mem_gb={hdc['peak_mem_gb']} kv_cache_gb={hy['cache_gb']:.2f} "
        f"ssd_launches={hdc['ssd_launches']} finite={hy['decode_finite']}")
    dbusy, dwall = hy["decode_profile"]["busy_s"], hy["decode_profile"][
        "wall_s"]
    log(f"[lm-hybrid] profiled decode, {HYBRID_PROFILED_STEPS} steps at batch "
        f"{HYBRID_DECODE_BATCH}: wall {1e3 * dwall:.1f}ms"
        + (f" busy {1e3 * dbusy:.1f}ms (share {dbusy / dwall:.3f})"
           if dbusy else "") + "; device time by kernel kind: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in hy["decode_split_ms"].items()))
    log(f"[lm-hybrid] prefill vs recurrence, 2 x {LM_CONSIST_TOKENS} tokens: "
        f"max_abs_err={hy['consist_err']:.3e} max_abs_logit="
        f"{hy['consist_scale']:.3f} rel={hy_rel:.3e} (bar "
        f"{LM_CONSIST_TOL:g}) ssd_launches={hy['consist_launches']}")
    fam_rel = {}
    for f in fams:
        fpf = f["prefill"]
        fam_rel[f["arch"]] = f["consist_err"] / f["consist_scale"]
        log(f"[lm-hybrid] {f['family']} {f['arch']} ({f['n_layers']} layers) "
            f"prefill 1 x {f['prefill_len']}: seconds={fpf['seconds']:.3f} "
            f"tokens_per_s={fpf['tokens_per_s']:.0f} peak_mem_gb="
            f"{fpf['peak_mem_gb']} logits={f['logits_shape']} "
            f"finite={f['logits_finite']}; prefill vs decode, 2 x "
            f"{f['consist_tokens']} tokens: max_abs_err="
            f"{f['consist_err']:.3e} max_abs_logit={f['consist_scale']:.3f} "
            f"rel={fam_rel[f['arch']]:.3e} (bar {LM_CONSIST_TOL:g})")
    log(f"[lm-hybrid] phase_s={hy_s:.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in hy["parts_s"].items())
        + "; " + ", ".join(f"{f['arch']} {f['phase_s']:.1f}" for f in fams)
        + f") plain_calls_on_cuda={hy_plain_calls}")
    if not hy["launches"] == hy["state_launches"] == hy["n_layers"]:
        raise AssertionError(f"SSD kernels launched {hy['launches']} and "
                             f"{hy['state_launches']} times in one hybrid "
                             f"prefill, want one each per Mamba-2 layer")
    if hy["logits_shape"] != (HYBRID_PREFILL_BATCH, 32768, 32000) or not (
            hy["logits_finite"] and hy["decode_finite"]):
        raise AssertionError(f"hybrid logits wrong shape or not finite: "
                             f"{hy['logits_shape']}")
    for f in fams:
        if f["logits_shape"] != f["want_logits"] or not f["logits_finite"]:
            raise AssertionError(f"{f['arch']} logits wrong shape or not "
                                 f"finite: {f['logits_shape']}")
    if not (hy_rel <= LM_CONSIST_TOL
            and all(r <= LM_CONSIST_TOL for r in fam_rel.values())):
        raise AssertionError(f"prefill and decode disagree: hybrid rel "
                             f"{hy_rel:.3e}, others {fam_rel} > "
                             f"{LM_CONSIST_TOL}")
    if any(hy_plain_calls.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors on the "
                             f"attention LM paths: {hy_plain_calls}")
    lerr = lm_small_input_check()
    log(f"[check] {LM_ARCH} smoke widths, SSD kernel vs reference scan on the "
        f"card: max_abs_err={lerr:.3e} (rtol=1e-4, atol=1e-5)")
    herr = lm_small_input_check(HYBRID_ARCH)
    log(f"[check] {HYBRID_ARCH} smoke widths, SSD kernel vs reference scan "
        f"on the card: max_abs_err={herr:.3e} (rtol=1e-4, atol=1e-5)")
    torch.cuda.empty_cache()
    # the SSD kernels at zamba2's shape (80 heads: the ragged head tile)
    hy_ssd_row, (states, decay) = check_ssd(hy_rec.ssd, HYBRID_PREFILL_BATCH)
    hy_rec.ssd = None
    hy_rows = {"ssd_intra_chunk": dict(hy_ssd_row, path="lm_hybrid",
                                       launches=hy["launches"]),
               "ssd_chunk_recurrence": dict(check_ssd_state(
                   states, decay, hy["state_launches"]), path="lm_hybrid")}
    del states, decay
    torch.cuda.empty_cache()

    lap("lm_hybrid")
    # -- phase 6c: the MoE LMs at their published widths -----------------
    guard.counts = dict.fromkeys(guard.counts, 0)
    before = launch_counts()
    moes = [lm_moe_phase(log, *c) for c in MOE_CHECKS]
    moe_launches = _launched(before, launch_counts())
    moe_plain_calls = dict(guard.counts)
    guard.close()
    for m in moes:
        mp, ms_, md, mds = (m["prefill"], m["prefill_steady"], m["decode"],
                            m["decode_steady"])
        inv = m["invariants"]
        m["rel"] = m["consist_err"] / m["consist_scale"]
        log(f"[lm-moe] {m['arch']} ({m['n_layers']} layers, {m['n_moe']} "
            f"MoE) prefill 1 x {m['prefill_len']}: seconds="
            f"{mp['seconds']:.3f} (with the dispatch checks; steady "
            f"{ms_['seconds']:.3f}) tokens_per_s={mp['tokens_per_s']:.0f} "
            f"(steady {ms_['tokens_per_s']:.0f}) peak_mem_gb="
            f"{ms_['peak_mem_gb']} logits={m['logits_shape']} finite="
            f"{m['logits_finite']} max_abs_logit={m['logits_max']:.3f}; "
            f"moe_drop_share={ms_['moe_drop_share']:.4f} at "
            f"capacity_factor {m['capacity_factor']:g} ({ms_['moe_dropped']}"
            f" of {ms_['moe_pairs']} (token, k) pairs)")
        for i, r in enumerate(inv):
            log(f"[lm-moe] {m['arch']} MoE layer {i} dispatch: tokens="
                f"{r['tokens']} cap={r['cap']} kept={r['kept']} of "
                f"{r['pairs']} (host recount {r['host_kept']}, same pairs "
                f"{r['keep_equal']}) one_slot_each_kept_pair="
                f"{r['one_slot_each']} max_pairs_a_slot="
                f"{r['max_pairs_a_slot']:g} dispatch_sum="
                f"{r['dispatch_sum']:g} values_0_or_1={r['values_01']}")
        log(f"[lm-moe] {m['arch']} decode batch={MOE_DECODE_BATCH} "
            f"seq_len=32768 steps={LM_DECODE_STEPS}: ms_per_step="
            f"{md['ms_per_step']:.3f} (steady {mds['ms_per_step']:.3f}) "
            f"tokens_per_s={md['tokens_per_s']:.0f} (steady "
            f"{mds['tokens_per_s']:.0f}) peak_mem_gb={md['peak_mem_gb']} "
            f"cache_gb={m['cache_gb']:.2f} finite={m['decode_finite']}")
        log(f"[lm-moe] {m['arch']} prefill vs decode, 2 x "
            f"{MOE_CONSIST_TOKENS} tokens at capacity_factor "
            f"{m['consist_cf']:g} (nothing drops): max_abs_err="
            f"{m['consist_err']:.3e} max_abs_logit={m['consist_scale']:.3f} "
            f"rel={m['rel']:.3e} (bar {LM_CONSIST_TOL:g}); phase peak "
            f"{m['peak_gb']:.2f} GB (max_memory_allocated, "
            f"{m['resident_gb']:.2f} GB resident before); host s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in m["parts_s"].items()))
    log(f"[lm-moe] card: {card}; kernel launches in the phase: "
        f"{moe_launches or 'none'} (the MoE path has no kernel of the "
        f"port: its products are einsums, as the JAX package's are "
        f"outside any Pallas kernel) plain_calls_on_cuda={moe_plain_calls}")
    for m in moes:
        for r in m["invariants"]:
            if not (r["one_slot_each"] and r["max_pairs_a_slot"] <= 1
                    and r["values_01"] and r["keep_equal"]
                    and r["kept"] == r["host_kept"]
                    and r["dispatch_sum"] == r["kept"]):
                raise AssertionError(f"{m['arch']}: the dispatch breaks "
                                     f"its invariants: {r}")
        if len(m["invariants"]) != m["n_moe"]:
            raise AssertionError(f"{m['arch']}: {len(m['invariants'])} "
                                 f"dispatches seen, want {m['n_moe']}")
        if m["logits_shape"] != m["want_logits"] or not (
                m["logits_finite"] and m["decode_finite"]):
            raise AssertionError(f"{m['arch']} logits wrong shape or not "
                                 f"finite: {m['logits_shape']}")
        if not m["rel"] <= LM_CONSIST_TOL:
            raise AssertionError(f"{m['arch']}: prefill and decode disagree:"
                                 f" rel {m['rel']:.3e} > {LM_CONSIST_TOL}")
    if moe_launches or any(moe_plain_calls.values()):
        raise AssertionError(f"the MoE path launched {moe_launches} or ran "
                             f"plain versions on CUDA: {moe_plain_calls}")
    torch.cuda.empty_cache()

    lap("lm_moe")
    # -- phase 7: kernels against their plain versions, the dry-run CLI's
    # production case beside them (host only) -----------------------------
    cli = production_dryrun_start()
    atexit.register(lambda: cli["proc"].poll() is None and cli["proc"].kill())
    ssd_row, (states, decay) = check_ssd(lm_rec.ssd, LM_PREFILL_BATCH)
    lm_rec.ssd = None
    rows = {"legendre_contract": [], "disco_band_contract": [],
            "disco_band_transpose": [], "crps_fused": [],
            "ssd_intra_chunk": [ssd_row],
            "ssd_chunk_recurrence": [
                check_ssd_state(states, decay, lm["state_launches"])]}
    del states, decay
    for name, row in hy_rows.items():
        rows[name].append(row)
    rows.update(lt_rows)
    torch.cuda.empty_cache()

    def legendre_what(ent):
        # the inverse SHT passes pct as a transposed (L, H, M) view
        return "forward" if ent["table"].is_contiguous() else "inverse"

    for ent in rec.legendre.values():
        rows["legendre_contract"].append(
            check_legendre(ent["table"], ent["extents"], ent["shape"],
                           ent["dtype"], legendre_what(ent)))
    # the engine path's largest batch of each table, where the serve path
    # gave it fewer rows
    for key, ent in eng_rec.legendre.items():
        if ent["b"] > rec.legendre.get(key, {"b": 0})["b"]:
            row = check_legendre(ent["table"], ent["extents"], ent["shape"],
                                 ent["dtype"], legendre_what(ent) + " engine")
            rows["legendre_contract"].append(dict(row, path="engine"))

    def widest(entries) -> dict:
        # the largest batch of each band geometry
        out = {}
        for ent in entries:
            key = (tuple(ent["psi"].shape), ent["stride"])
            if ent["shape"][0] > out.get(key, (0,))[0]:
                out[key] = ent["shape"]
        return out

    def disco_what(ent):
        _, h_in, w_in = ent["shape"]
        return (f"{h_in}x{w_in}->{ent['psi'].shape[1]}x"
                f"{w_in // ent['stride']}")

    served = widest(rec.disco.values())
    for ent in sorted(rec.disco.values(),
                      key=lambda e: (e["psi"].shape[1], e["stride"],
                                     -e["shape"][0])):
        full = ent["shape"] == served[(tuple(ent["psi"].shape),
                                       ent["stride"])]
        rows["disco_band_contract"].append(check_disco(ent, disco_what(ent),
                                                       full))
        torch.cuda.empty_cache()
    if sum(r["launches"] for r in rows["disco_band_contract"]) != launches[
            "disco_band_contract"]:
        raise AssertionError("the band contraction's launches per shape do "
                             "not add up to its count on the main path")
    if sum(e["launches"] for e in eng_rec.disco.values()) != engine_launches[
            "disco_band_contract"]:
        raise AssertionError("the band contraction's launches per shape do "
                             "not add up to its count on the engine path")
    log("[kernel] disco engine path launches by shape: " + "; ".join(
        f"{disco_what(e)} x{e['shape']} {e['launches']}"
        for e in sorted(eng_rec.disco.values(),
                        key=lambda e: (e["psi"].shape[1], -e["shape"][0]))))
    # the engine path's largest batch of each geometry, where the serve
    # path's was smaller: against the plain version too
    for key, shape in widest(eng_rec.disco.values()).items():
        if shape[0] > served.get(key, (0,))[0]:
            ent = eng_rec.disco[key + (shape,)]
            row = check_disco(ent, disco_what(ent) + " engine", True)
            rows["disco_band_contract"].append(dict(row, path="engine"))
            torch.cuda.empty_cache()
    # the conv_transpose1d yardstick and the plain version run at each
    # band's widest shape only: the narrower ones repeat their work
    # (PERF.md), and are held to the first planes of the plain output;
    # the yardstick not at the decoder's band (rows out: the full grid),
    # where one call took 35-44 s of the script's time; [tune]'s winner
    # for the transpose, where it is not the committed tile, is held to
    # that plain output at its shape
    io_rows = fcn3cfg.NAMED_CONFIGS[CONFIG]().nlat
    bwd_tuned = tuned["families"]["disco_bwd"]
    if bwd_tuned["blocks"] is None:
        bwd_tuned = None
    tb, th, ts, _, tk, td, tstride = tuned["families"]["disco_bwd"]["shapes"]
    bands: dict = {}
    for ent in sorted(train_rec.transpose.values(),
                      key=lambda e: (tuple(e["psi"].shape), e["stride"],
                                     -e["shape"][0])):
        what = (f"{ent['psi'].shape[1]}x{ent['shape'][-1]}->{ent['h_in']}x"
                f"{ent['shape'][-1] * ent['stride']}")
        band = bands.setdefault((tuple(ent["psi"].shape), ent["stride"]), {})
        rows["disco_band_transpose"].append(check_transpose(
            ent, what,
            library="ref" not in band and ent["shape"][2] != io_rows,
            band=band,
            tuned=bwd_tuned["blocks"] if bwd_tuned and (
                ent["shape"][0], *ent["psi"].shape, ent["stride"]) == (
                tb, tk, th, ts, td, tstride) else None))
        torch.cuda.empty_cache()
    del bands
    torch.cuda.empty_cache()
    if sum(r["launches"] for r in rows["disco_band_transpose"]) != summary[
            "launches"]["disco_band_transpose"]:
        raise AssertionError("the transpose's launches per shape do not add "
                             "up to its count on the training path")
    rows["disco_band_transpose"].append(
        check_transpose(any_stride_transpose(3), "stride3-synthetic"))
    torch.cuda.empty_cache()
    for ent in train_rec.crps.values():
        rows["crps_fused"].extend(check_crps(ent))
        torch.cuda.empty_cache()
    # (d3): the band and CRPS kernels on a rank's row-sliced operands,
    # the Legendre kernel on its padded tables
    for row in dist["domain_rows"] + dist["engine_rows"]:
        rows[row["kernel"]].append(row)
    held = dryrun_rows(log, {k: dry[k] for k in ("(i)", "(ii)")}, rows)
    if held == 0:
        raise AssertionError("no row of phase 7 is at a shape the dry runs "
                             "counted")

    meta = {
        "legendre_contract": ("cuda", "src/repro_torch/csrc/legendre.cu",
                              "src/repro/kernels/legendre/legendre.py:91"),
        "disco_band_contract": ("cuda", "src/repro_torch/csrc/disco_band.cu",
                                "src/repro/kernels/disco/disco.py:110"),
        # the VJP of the same TPU kernel
        "disco_band_transpose": ("cuda",
                                 "src/repro_torch/csrc/disco_band_bwd.cu",
                                 "src/repro/kernels/disco/disco.py:110"),
        "crps_fused": ("cuda", "src/repro_torch/csrc/crps.cu",
                       "src/repro/kernels/crps/crps.py:67"),
        "ssd_intra_chunk": ("cuda", "src/repro_torch/csrc/ssd.cu",
                            "src/repro/kernels/ssd/ssd.py:106"),
        # no TPU kernel: the jax.lax.scan over chunks of
        # ssd_chunked_pallas, which XLA compiles to one loop on the device
        "ssd_chunk_recurrence": ("cuda", "src/repro_torch/csrc/ssd_state.cu",
                                 "src/repro/kernels/ssd/ops.py:53"),
        # no TPU kernel: the Pallas SSD kernel has no VJP; JAX's LM
        # training differentiates the plain chunked scan
        "ssd_intra_chunk_bwd": ("cuda", "src/repro_torch/csrc/ssd_bwd.cu",
                                "src/repro/models/ssm.py:84"),
        "ssd_chunk_recurrence_bwd": ("cuda",
                                     "src/repro_torch/csrc/ssd_state_bwd.cu",
                                     "src/repro/models/ssm.py:133"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        # the headline shape is the kernel's main path's (the engine
        # path's rows stay in "shapes")
        fwd = [r for r in rows[name]
               if r["what"] != "backward" and r.get("path") is None]
        top = max(fwd, key=lambda r: r["flops"])
        by_path = {"serve": launches.get(name, 0),
                   "engine": engine_launches.get(name, 0),
                   "service": service_launches.get(name, 0),
                   "train": summary["launches"].get(name, 0),
                   "lm_prefill": {"ssd_intra_chunk": lm["launches"],
                                  "ssd_chunk_recurrence":
                                  lm["state_launches"]}.get(name, 0),
                   "lm_hybrid_prefill": {
                       "ssd_intra_chunk": hy["launches"],
                       "ssd_chunk_recurrence": hy["state_launches"]}.get(
                           name, 0),
                   # rank 0's, in Algorithms 1-2 and in its training run
                   "dist_geometry": dist["geometry"][0]["launches"].get(
                       name, 0),
                   "dist_train": dist["train"][0]["launches"].get(name, 0),
                   "dist_domain": dist["domain"][0]["launches"].get(name,
                                                                    0),
                   "evaluate": ev["launches"].get(name, 0),
                   "dist_engine": dist["engine"][0]["launches"].get(name, 0),
                   "dist_domain_eval": dist["domain"][0]["eval"][
                       "launches"].get(name, 0),
                   # one step of [lm-train] (remat: the SSD forwards twice)
                   "lm_train": lm_train_launches.get(name, 0),
                   # rank 0's channel step at the cut fcn3_full, and its
                   # fcn3_smoke one
                   "dist_channel": dist["channel"][0]["launches"].get(name,
                                                                      0),
                   "dist_channel_smoke": dist["channel_small"][0].get(name,
                                                                      0),
                   "examples": examples["launches"].get(name, 0)}
        ent = {
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "tpu_kernel": None if name.startswith(
                ("ssd_chunk_recurrence", "ssd_intra_chunk_bwd")) else replaces,
            # each kernel's main path: the forward kernels' is the
            # forecast, the transpose and CRPS kernels' is training, the
            # SSD kernels' is the LM prefill, their backwards' LM training
            "launches": (by_path["serve"] or by_path["train"]
                         or by_path["lm_prefill"] or by_path["lm_train"]),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               if r["max_abs_err"] is not None),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            **{key: top[key] for key in ("tflops", "dense_band_tflops",
                                         "ms_over_bound", "launches_per_call")
                 if key in top},
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "bound_tc_ms": top["bound_tc_ms"],
            "library_ms": top["library_ms"], "at": top["shape"],
            "shapes": rows[name]}
        # [tune]'s winner and the committed tile at the tuned shape (the
        # CRPS family: one forward and one backward call)
        fam = tuned["families"].get(TUNE_FAMILY.get(name))
        ent.update(tuned_dims=fam and fam["dims"],
                   tuned_ms=fam and fam["tuned_ms"],
                   default_ms=fam and fam["default_ms"],
                   tuned_at=fam and "x".join(map(str, fam["shapes"])))
        bwd = [r for r in rows[name]
               if r["what"] == "backward" and r.get("path") is None]
        if bwd:
            # the CRPS backward kernel of the same source, at its largest
            # shape: its launches, times and bound
            b = max(bwd, key=lambda r: r["bytes"])
            ent["backward"] = {
                "launches": summary["launches"]["crps_fused_bwd"],
                "ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "bound_tc_ms": b["bound_tc_ms"],
                "library_ms": None, "at": b["shape"]}
        kernels.append(ent)
    log(f"[profile] forecast lead: busy_s={profile['busy_s']} "
        f"wall_s={profile['wall_s']:.3f}")
    production_dryrun(log, cli)
    lap("kernels")
    log(f"[time] phase_s={ {k: round(v, 1) for k, v in phase_s.items()} } "
        f"total_s={sum(phase_s.values()):.1f} (limit 1200, target 1100)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
