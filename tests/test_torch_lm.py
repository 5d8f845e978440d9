"""The port's Mamba-2 LM (family ``ssm``) against the JAX package.

At ``smoke_config("mamba2-130m")`` (2 layers, d_model 128, chunk 16) the
JAX ``LM.init`` parameters are carried across with
``lm_params_from_numpy``; the same numpy tokens then go through JAX
``LM.apply_train`` / ``decode_step`` and the port's ``LM.forward`` /
``decode_step``.  Bar: rtol 1e-4, atol 1e-5 (the fp32 bar of
``tests/test_kernel_dispatch.py``).  The port's CLI and its configuration
tables are checked here too.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import TORCH_THREADS, few_torch_threads  # noqa: F401

from repro.configs import archs as jarchs
from repro.configs import shapes as jshapes
from repro.models import ssm as jssm
from repro.models.transformer import LM as JaxLM
from repro.train.checkpoint import _flatten_with_paths
from repro_torch.configs import archs as tarchs
from repro_torch.configs import mamba2_130m
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels.config import KernelConfig
from repro_torch.models import ssm as tssm
from repro_torch.models.params import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.transformer import LM

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def jax_lm():
    cfg = jarchs.smoke_config(ARCH)
    model = JaxLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return model, params, flat


def _port(flat, mode="kernel"):
    cfg = tarchs.smoke_config(ARCH)
    model = LM(cfg, device="cpu", kernels=KernelConfig(ssd=mode))
    model.load_state_dict(lm_params_from_numpy(flat, cfg), strict=True)
    return model


def _tokens(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jarchs.smoke_config(ARCH).vocab_size,
                        shape).astype(np.int32)


@pytest.mark.parametrize("mode", ["kernel", "reference"])
@pytest.mark.parametrize("seq", [64, 50], ids=["s64", "s50_padded"])
def test_prefill_logits_match_jax(jax_lm, seq, mode):
    model, params, flat = jax_lm
    tok = _tokens(seq, (2, seq))
    want, _ = model.apply_train(params, jnp.asarray(tok))
    got = _port(flat, mode)(torch.from_numpy(tok).long())
    assert got.shape == want.shape == (2, seq, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_and_cache_match_jax(jax_lm):
    model, params, flat = jax_lm
    port = _port(flat)
    tok = _tokens(1, (2, 8))
    jcache, tcache = model.init_cache(2, 16), port.init_cache(2, 16)
    for t in range(8):
        want, jcache = model.decode_step(params, jnp.asarray(tok[:, t:t + 1]),
                                         jcache, jnp.int32(t))
        got, tcache = port.decode_step(torch.from_numpy(tok[:, t:t + 1])
                                       .long(), tcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                   np.asarray(jcache["layers"][key]), **TOL)


def test_mixer_matches_jax_at_full_mixer_widths_short_sequence():
    # one mamba2-130m mixer (d_model 768, 24 heads, N 128, chunk 128) on a
    # sequence of 40, zero-padded to one chunk
    cfg = jarchs.get_arch(ARCH).ssm
    params = jssm.init_mamba2(jax.random.PRNGKey(1), cfg)
    u = np.random.default_rng(2).normal(size=(1, 40, 768)).astype(np.float32)
    want = jssm.apply_mamba2_train(params, cfg, jnp.asarray(u))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    got = tssm.apply_mamba2_train(tparams, tarchs.get_arch(ARCH).ssm,
                                  torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_param_round_trip(jax_lm):
    _, _, flat = jax_lm
    cfg = tarchs.smoke_config(ARCH)
    sd = lm_params_from_numpy(flat, cfg)
    assert "layers.1.mixer.in_proj" in sd and "layers.0.ln" in sd
    back = lm_params_to_numpy(_port(flat).state_dict(), cfg)
    assert sorted(back) == sorted(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val)


def test_init_draws_the_jax_distributions():
    cfg = dataclasses.replace(tarchs.smoke_config(ARCH), n_layers=1)
    model = LM(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    mixer = model.layers[0].mixer
    scfg = cfg.ssm
    torch.testing.assert_close(
        mixer.a_log, torch.log(torch.linspace(1.0, 16.0, scfg.n_heads)))
    assert torch.equal(mixer.d_skip, torch.ones(scfg.n_heads))
    dt = tssm.softplus(mixer.dt_bias)
    assert bool(((dt > 1e-3 * 0.999) & (dt < 1e-1 * 1.001)).all())
    assert abs(float(mixer.in_proj.std()) * scfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(model.embed.std()) / 0.02 - 1) < 0.05
    n = sum(int(np.prod(s)) for s in tssm._shapes(scfg).values())
    assert model.param_count() == (2 * cfg.padded_vocab * cfg.d_model
                                   + cfg.d_model + n + cfg.d_model)


def test_chunked_prefill_matches_recurrent_decode(jax_lm):
    # the port's chunked prefill (two chunks plus a padded tail) against
    # the port's token-by-token recurrence
    port = _port(jax_lm[2])
    tok = torch.from_numpy(_tokens(3, (2, 40))).long()
    full = port(tok)
    cache = port.init_cache(2, 40)
    for t in range(40):
        step, cache = port.decode_step(tok[:, t:t + 1], cache, t)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_full_config_widths():
    cfg = mamba2_130m.config()
    assert (cfg.n_layers, cfg.d_model, cfg.padded_vocab) == (24, 768, 50432)
    assert (cfg.ssm.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk) == (24, 64, 128, 128)
    assert mamba2_130m.smoke() == tarchs.smoke_config(ARCH)


@pytest.mark.parametrize("name", sorted(jarchs.ARCHS))
def test_arch_table_matches_jax(name):
    for get in ("get_arch", "smoke_config"):
        j = getattr(jarchs, get)(name)
        t = getattr(tarchs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.padded_vocab == j.padded_vocab


def test_input_shapes_match_jax():
    assert sorted(tshapes.INPUT_SHAPES) == sorted(jshapes.INPUT_SHAPES)
    for name, shape in jshapes.INPUT_SHAPES.items():
        got = tshapes.INPUT_SHAPES[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(shape)
        for arch in ("mamba2-130m", "phi3-mini-3.8b"):
            want = jshapes.adapt_arch_for_shape(jarchs.get_arch(arch), shape)
            cfg = tshapes.adapt_arch_for_shape(tarchs.get_arch(arch), got)
            assert cfg.sliding_window == want.sliding_window


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(TORCH_THREADS))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.lm",
                           *args], capture_output=True, text=True, env=env,
                          timeout=120)


@pytest.mark.parametrize("shape,phase", [("prefill_32k", "[prefill]"),
                                         ("decode_32k", "[decode]")])
def test_lm_cli_on_cpu(shape, phase):
    proc = _run_cli("--arch", ARCH, "--smoke", "--shape", shape, "--batch",
                    "2", "--seq-len", "48", "--decode-steps", "3",
                    "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(phase)]
    assert len(lines) == 1, proc.stdout
    for key in ("seconds=", "tokens_per_s=", "peak_mem_gb=n/a",
                "ssd_launches=0"):
        assert key in lines[0]


def test_lm_cli_profile_on_cpu():
    # the CPU has no device events: the profile says so and the run ends
    proc = _run_cli("--arch", ARCH, "--smoke", "--shape", "decode_32k",
                    "--batch", "2", "--decode-steps", "2", "--device", "cpu",
                    "--profile")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("[decode]") == 2
    assert "[profile] the profiler saw no device events" in proc.stdout


def test_lm_cli_without_device_flag_refuses_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run_cli("--arch", ARCH, "--smoke", "--shape", "prefill_32k")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
