"""The port's attention (``repro_torch.models.attention``), its building
blocks and the attention LM families against the JAX package.

Module functions: the same numpy weights and inputs through the JAX
function and the port's (GQA causal at G = 1 and 4, a sliding window,
cross-attention, the decode's full cache and its ring buffer past the
wrap, MLA's training path and absorbed decode), with the port's query
tiles forced small as well.  Models: for each of the seven non-MoE
attention architectures at ``smoke_config`` widths, the JAX ``LM.init``
parameters carried across with ``lm_params_from_numpy``; prefill logits
against ``LM.apply_train`` (with ``patches`` / ``enc_frames``), decode
steps and the caches against ``LM.decode_step``, and the parameter round
trip.  Bar: rtol 1e-4, atol 1e-5 (``tests/test_kernel_dispatch.py``).
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
from repro.models import attention as jattn
from repro.models import common as jcm
from repro.models.transformer import LM as JaxLM
from repro.train.checkpoint import _flatten_with_paths
from repro_torch.configs import archs as tarchs
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models.params import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models.transformer import LM

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-4, atol=1e-5)
#: the seven architectures of the dense, hybrid, VLM and audio families
ARCHS = ("phi3-mini-3.8b", "mistral-nemo-12b", "yi-6b", "codeqwen1.5-7b",
         "zamba2-2.7b", "llava-next-34b", "whisper-small")
#: the MoE family's two (``tests/test_torch_moe.py``)
MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("positions", ["arange", "scattered"])
def test_apply_rope_matches_jax(theta, positions):
    x = _normal(0, (2, 10, 4, 32))
    pos = (np.arange(10) if positions == "arange"
           else _rng(1).integers(0, 40000, 10)).astype(np.int32)
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcm.apply_rope(_t(x), _t(pos), theta)
    _close(got, want)
    np.testing.assert_array_equal(tcm.rope_freqs(32, theta),
                                  jcm.rope_freqs(32, theta))


def test_swiglu_and_gelu_mlp_match_jax():
    x = _normal(2, (2, 5, 48))
    for j_init, t_fn, j_fn in ((jcm.init_swiglu, tcm.swiglu, jcm.swiglu),
                               (jcm.init_gelu_mlp, tcm.gelu_mlp,
                                jcm.gelu_mlp)):
        p = j_init(jax.random.PRNGKey(3), 48, 96)
        p = {k: np.asarray(v) + (0.1 if k.startswith("b_") else 0.0)
             for k, v in p.items()}
        want = j_fn({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x))
        _close(t_fn({k: _t(v) for k, v in p.items()}, _t(x)), want)


def test_init_draws_the_jax_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    sw = tcm.init_swiglu(gen, 64, 256)
    jsw = jcm.init_swiglu(jax.random.PRNGKey(0), 64, 256)
    assert {k: tuple(v.shape) for k, v in sw.items()} == {
        k: v.shape for k, v in jsw.items()}
    assert abs(float(sw["w_gate"].std()) * 8 - 1) < 0.05
    ge = tcm.init_gelu_mlp(gen, 64, 256)
    assert float(ge["b_up"].abs().max()) == 0.0
    acfg = jattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16)
    tcfg = tattn.AttnConfig(**dataclasses.asdict(acfg))
    assert {k: tuple(v.shape) for k, v in tattn.init_gqa(gen, tcfg).items()
            } == {k: v.shape for k, v in
                  jattn.init_gqa(jax.random.PRNGKey(0), acfg).items()}


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _gqa(heads, kv_heads, window=0, causal=True, seed=4):
    jcfg = jattn.AttnConfig(d_model=64, n_heads=heads, n_kv_heads=kv_heads,
                            head_dim=16, rope_theta=1e4,
                            sliding_window=window, causal=causal)
    params = {k: np.asarray(v) for k, v in
              jattn.init_gqa(jax.random.PRNGKey(seed), jcfg).items()}
    return jcfg, tattn.AttnConfig(**dataclasses.asdict(jcfg)), params


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: _t(v) for k, v in params.items()})


def _tile(monkeypatch, rows, batch, heads, s_k):
    """Make the port's query tiles ``rows`` rows (None: one tile)."""
    if rows is not None:
        monkeypatch.setattr(tattn, "TILE_SCORE_BYTES",
                            4 * batch * heads * s_k * rows)
        assert tattn.query_rows(batch, heads, s_k) == rows


@pytest.mark.parametrize("rows", [None, 3], ids=["one_tile", "tiles_of_3"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)],
                         ids=["G1", "G4"])
def test_gqa_train_causal_matches_jax(heads, kv_heads, rows, monkeypatch):
    jcfg, tcfg, params = _gqa(heads, kv_heads)
    jp, tp = _both(params)
    x = _normal(5, (2, 20, 64))
    want = jattn.apply_gqa_train(jp, jcfg, jnp.asarray(x))
    _tile(monkeypatch, rows, 2, heads, 20)
    _close(tattn.apply_gqa_train(tp, tcfg, _t(x)), want)


@pytest.mark.parametrize("rows", [None, 3, 7])
def test_gqa_train_sliding_window_matches_jax(rows, monkeypatch):
    jcfg, tcfg, params = _gqa(8, 2, window=5)
    jp, tp = _both(params)
    x = _normal(6, (2, 20, 64))
    want = jattn.apply_gqa_train(jp, jcfg, jnp.asarray(x))
    _tile(monkeypatch, rows, 2, 8, 20)
    _close(tattn.apply_gqa_train(tp, tcfg, _t(x)), want)


@pytest.mark.parametrize("rows", [None, 4])
def test_gqa_train_explicit_positions_match_jax(rows, monkeypatch):
    # positions that are not 0..S-1: every tile reads every key
    jcfg, tcfg, params = _gqa(8, 2, window=6)
    jp, tp = _both(params)
    x = _normal(7, (2, 12, 64))
    pos = (np.arange(12) * 3 + 5).astype(np.int32)
    want = jattn.apply_gqa_train(jp, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos))
    _tile(monkeypatch, rows, 2, 8, 12)
    _close(tattn.apply_gqa_train(tp, tcfg, _t(x), positions=_t(pos)), want)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("rows", [None, 5])
def test_cross_attention_matches_jax(rows, window, monkeypatch):
    jcfg, tcfg, params = _gqa(4, 4, window=window, causal=False)
    jp, tp = _both(params)
    x, enc = _normal(8, (2, 11, 64)), _normal(9, (2, 16, 64))
    want = jattn.apply_gqa_train(jp, jcfg, jnp.asarray(x),
                                 kv_states=jnp.asarray(enc))
    _tile(monkeypatch, rows, 2, 4, 16)
    _close(tattn.apply_gqa_train(tp, tcfg, _t(x), kv_states=_t(enc)), want)


@pytest.mark.parametrize("window,max_len", [(0, 24), (8, 24)],
                         ids=["full_cache", "ring_of_8"])
def test_gqa_decode_and_cache_match_jax(window, max_len):
    # 20 steps: the ring of 8 wraps past pos >= window twice
    jcfg, tcfg, params = _gqa(8, 2, window=window)
    jp, tp = _both(params)
    x = _normal(10, (2, 20, 64))
    jc = jattn.init_gqa_cache(jcfg, 2, max_len)
    tc = tattn.init_gqa_cache(tcfg, 2, max_len, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    for t in range(20):
        want, jc = jattn.apply_gqa_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jc, jnp.int32(t))
        got, tc2 = tattn.apply_gqa_decode(tp, tcfg, _t(x[:, t:t + 1]), tc, t)
        assert tc2 is tc                      # updated in place
        _close(got, want)
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_gqa_decode_cross_attention_matches_jax():
    jcfg, tcfg, params = _gqa(4, 4, causal=False)
    jp, tp = _both(params)
    x, enc = _normal(11, (2, 1, 64)), _normal(12, (2, 16, 64))
    want, _ = jattn.apply_gqa_decode(jp, jcfg, jnp.asarray(x), {},
                                     jnp.int32(3), kv_states=jnp.asarray(enc))
    got, cache = tattn.apply_gqa_decode(tp, tcfg, _t(x), {}, 3,
                                        kv_states=_t(enc))
    assert cache == {}
    _close(got, want)


def test_gqa_decode_matches_its_own_prefill_on_a_ring(monkeypatch):
    # the port's decode over a ring buffer against its windowed prefill
    _, tcfg, params = _gqa(8, 2, window=5)
    tp = _both(params)[1]
    x = _t(_normal(13, (2, 17, 64)))
    _tile(monkeypatch, 4, 2, 8, 17)
    full = tattn.apply_gqa_train(tp, tcfg, x)
    cache = tattn.init_gqa_cache(tcfg, 2, 17, "cpu")
    for t in range(17):
        got, _ = tattn.apply_gqa_decode(tp, tcfg, x[:, t:t + 1], cache, t)
        torch.testing.assert_close(got[:, 0], full[:, t], **TOL)


def test_query_tiles_cover_each_row_once_and_every_visible_key():
    for s, rows, causal, window in ((20, 3, True, 0), (20, 7, True, 5),
                                    (9, 4, False, 0), (9, 2, False, 3)):
        seen = np.zeros(s, int)
        for q0, q1, k0, k1 in tattn.query_tiles(s, s, rows, causal, window,
                                                True):
            seen[q0:q1] += 1
            for q in range(q0, q1):
                vis = [k for k in range(s) if (not causal or k <= q)
                       and (not window or k > q - window)]
                assert k0 <= min(vis) and max(vis) < k1
        assert (seen == 1).all()
    # zamba2-2.7b's prefill at 1 x 32768, 32 heads: 1024 rows, 4 GiB
    rows = tattn.query_rows(1, 32, 32768)
    assert rows == 1024 and 4 * 32 * rows * 32768 == tattn.TILE_SCORE_BYTES
    assert tattn.query_rows(2, 32, 32768) == 512
    assert tattn.query_rows(2048, 32, 32768) == 1


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg = jattn.AttnConfig(d_model=64, n_heads=4, n_kv_heads=4,
                            head_dim=16, mla=True, kv_lora_rank=32,
                            q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
                            v_head_dim=16)
    params = {k: np.asarray(v) for k, v in
              jattn.init_mla(jax.random.PRNGKey(14), jcfg).items()}
    return jcfg, tattn.AttnConfig(**dataclasses.asdict(jcfg)), params


@pytest.mark.parametrize("rows", [None, 4])
def test_mla_train_matches_jax(mla, rows, monkeypatch):
    jcfg, tcfg, params = mla
    jp, tp = _both(params)
    assert sorted(tattn.mla_shapes(tcfg)) == sorted(params)
    x = _normal(15, (2, 14, 64))
    want = jattn.apply_mla_train(jp, jcfg, jnp.asarray(x))
    _tile(monkeypatch, rows, 2, 4, 14)
    _close(tattn.apply_mla_train(tp, tcfg, _t(x)), want)


def test_mla_absorbed_decode_and_cache_match_jax(mla):
    jcfg, tcfg, params = mla
    jp, tp = _both(params)
    x = _normal(16, (2, 10, 64))
    jc = jattn.init_mla_cache(jcfg, 2, 12)
    tc = tattn.init_mla_cache(tcfg, 2, 12, "cpu")
    for t in range(10):
        want, jc = jattn.apply_mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                          jc, jnp.int32(t))
        got, _ = tattn.apply_mla_decode(tp, tcfg, _t(x[:, t:t + 1]), tc, t)
        _close(got, want)
    for key in ("c_kv", "k_rope"):
        _close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# the seven architectures
# ---------------------------------------------------------------------------

_JAX_LMS: dict = {}


def _jax_lm(arch):
    if arch not in _JAX_LMS:
        cfg = jarchs.smoke_config(arch)
        model = JaxLM(cfg)
        params = model.init(jax.random.PRNGKey(0))
        flat = {k: np.asarray(v)
                for k, v in _flatten_with_paths(params).items()}
        _JAX_LMS[arch] = model, params, flat
    return _JAX_LMS[arch]


def _port(arch):
    cfg = tarchs.smoke_config(arch)
    model = LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(_jax_lm(arch)[2], cfg),
                          strict=True)
    return model


def _inputs(arch, b, s, seed):
    cfg = tarchs.smoke_config(arch)
    tok = _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = _normal(seed + 1, (b, cfg.n_patches, cfg.d_model))
    if cfg.family == "audio":
        extra["enc_frames"] = _normal(seed + 2,
                                      (b, cfg.encoder_seq, cfg.d_model))
    return tok, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    model, params, _ = _jax_lm(arch)
    tok, extra = _inputs(arch, 2, 24, 20)
    want, _ = model.apply_train(
        params, jnp.asarray(tok),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = _port(arch)(torch.from_numpy(tok).long(),
                      **{k: _t(v) for k, v in extra.items()})
    assert got.shape == want.shape
    _close(got, want)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_jax(arch):
    model, params, _ = _jax_lm(arch)
    port = _port(arch)
    cfg = tarchs.smoke_config(arch)
    tok, _ = _inputs(arch, 2, 8, 21)
    enc = (_normal(22, (2, cfg.encoder_seq, cfg.d_model))
           if cfg.family == "audio" else None)
    jkw = {} if enc is None else {"enc_states": jnp.asarray(enc)}
    tkw = {} if enc is None else {"enc_states": _t(enc)}
    jcache, tcache = model.init_cache(2, 12), port.init_cache(2, 12)
    for t in range(8):
        want, jcache = model.decode_step(params, jnp.asarray(tok[:, t:t + 1]),
                                         jcache, jnp.int32(t), **jkw)
        got, tcache = port.decode_step(torch.from_numpy(tok[:, t:t + 1])
                                       .long(), tcache, t, **tkw)
        _close(got, want)
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(tl) == sorted(jl)
    for key in jl:
        assert tuple(tl[key].shape) == jl[key].shape, key
        _close(tl[key], jl[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_round_trip(arch):
    flat = _jax_lm(arch)[2]
    cfg = tarchs.smoke_config(arch)
    port = _port(arch)
    back = lm_params_to_numpy(port.state_dict(), cfg)
    assert sorted(back) == sorted(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val)
    assert port.param_count() == sum(v.size for v in flat.values())


def test_nested_and_stacked_keys_map_as_the_jax_tree():
    sd = lm_params_from_numpy(_jax_lm("zamba2-2.7b")[2],
                              tarchs.smoke_config("zamba2-2.7b"))
    assert {"shared_attn.attn.wq", "shared_attn.ffn.w_gate",
            "layers.1.mixer.in_proj", "layers.0.ln"} <= set(sd)
    sd = lm_params_from_numpy(_jax_lm("whisper-small")[2],
                              tarchs.smoke_config("whisper-small"))
    assert {"enc_layers.1.attn.wq", "layers.0.cross.wk", "layers.1.ln_cross",
            "layers.0.ffn.b_up"} <= set(sd)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_every_parameter(arch):
    cfg = tarchs.smoke_config(arch)
    model = LM(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    flat = _jax_lm(arch)[2]
    sd = lm_params_from_numpy(flat, cfg)
    for name, p in model.state_dict().items():
        assert tuple(p.shape) == tuple(sd[name].shape), name
        if name.rsplit(".", 1)[-1].startswith(("w", "embed", "lm_head")):
            assert float(p.abs().max()) > 0, name


def test_hybrid_chunked_prefill_matches_recurrent_decode():
    # zamba2's smoke width (chunk 16): the chunked SSD prefill and the
    # shared attention block against token-by-token decode with the
    # per-unit KV caches
    port = _port("zamba2-2.7b")
    tok = torch.from_numpy(_inputs("zamba2-2.7b", 2, 40, 23)[0]).long()
    full = port(tok)
    cache = port.init_cache(2, 40)
    assert cache["shared_attn"]["self"]["k"].shape[0] == port.n_units == 1
    for t in range(40):
        step, cache = port.decode_step(tok[:, t:t + 1], cache, t)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_audio_prefill_matches_decode_through_encode_audio():
    # whisper's smoke width: the encoder against the JAX package's, then
    # the prefill over the frames against decode steps that cross-attend
    # to the encoder's output
    model, params, _ = _jax_lm("whisper-small")
    port = _port("whisper-small")
    tok, extra = _inputs("whisper-small", 2, 24, 24)
    frames = extra["enc_frames"]
    enc = port.encode_audio(_t(frames))
    _close(enc, model._encode_audio(params, jnp.asarray(frames)))
    tok = torch.from_numpy(tok).long()
    full = port(tok, enc_frames=_t(frames))
    cache = port.init_cache(2, 24)
    for t in range(24):
        step, cache = port.decode_step(tok[:, t:t + 1], cache, t,
                                       enc_states=enc)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_decode_without_a_position_is_refused():
    port = _port("phi3-mini-3.8b")
    with pytest.raises(ValueError, match="position"):
        port.decode_step(torch.zeros((1, 1), dtype=torch.long),
                         port.init_cache(1, 4))


# ---------------------------------------------------------------------------
# the LM CLI
# ---------------------------------------------------------------------------

def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(TORCH_THREADS))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.lm",
                           *args], capture_output=True, text=True, env=env,
                          timeout=120)


@pytest.mark.parametrize("arch,shape,phase", [
    ("zamba2-2.7b", "prefill_32k", "[prefill]"),
    ("llava-next-34b", "prefill_32k", "[prefill]"),
    ("whisper-small", "decode_32k", "[decode]")])
def test_lm_cli_runs_the_attention_families_on_cpu(arch, shape, phase):
    proc = _run_cli("--arch", arch, "--smoke", "--shape", shape,
                    "--seq-len", "40", "--decode-steps", "3", "--device",
                    "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(phase)]
    assert len(lines) == 1, proc.stdout
    assert "layers=2" in proc.stdout
    if phase == "[prefill]":    # a VLM's patches are part of the 40
        assert "logits=(2, 40, 256)" in lines[0]


@pytest.mark.parametrize("module", [
    "phi3_mini_3_8b", "mistral_nemo_12b", "yi_6b", "codeqwen1_5_7b",
    "zamba2_2_7b", "llava_next_34b", "whisper_small", "deepseek_v2_236b",
    "llama4_maverick_400b_a17b"])
def test_config_modules_match_jax(module):
    import importlib
    jmod = importlib.import_module(f"repro.configs.{module}")
    tmod = importlib.import_module(f"repro_torch.configs.{module}")
    for fn in ("config", "smoke"):
        want, got = getattr(jmod, fn)(), getattr(tmod, fn)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tmod.config().name in ARCHS + MOE_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_of_the_port_match_jax(arch):
    # the placement rules over the port's parameters, stacked back into
    # the JAX tree, against the JAX rules over the JAX tree
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as jsharding
    from repro_torch.distributed import sharding as tsharding
    _, params, _ = _jax_lm(arch)
    jcfg, tcfg = jarchs.smoke_config(arch), tarchs.smoke_config(arch)
    flat = jax.tree_util.tree_flatten_with_path(
        jsharding.lm_param_specs(jcfg, params),
        is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}
    port = lm_params_to_numpy(_port(arch).state_dict(), tcfg)
    assert tsharding.lm_param_specs(tcfg, port) == want
