"""The dense LM serving path of the port vs the JAX package (CPU).

Both packages get the same numpy inputs: the reference's parameters
(``repro.models.model.init_params``), carried over by
``interop.lm_params``, with its zero-initialised QKV biases and norm
weights first set to seeded random values, so those paths are compared
too.  Sizes are the SMOKE preset's (``launch/train.py``): 4 layers,
d_model 256, 8 query heads of 32, vocab 2,048.

Tolerances, and why:
- configs: equal field for field;
- layers in float32: |Δ| <= 1e-6·max|want| (the two frameworks' exp,
  rsqrt, tanh and cos/sin differ in the last ulp); in bf16: one bf16 ulp
  of max|want| (norms, RoPE and SwiGLU come out bit-equal; GELU's float32
  tanh can move a rounding);
- ``flash_attention``: float32 rtol = atol = 1e-5 (another summation
  order over at most 64 terms), bf16 the reference test's 2e-3
  (``tests/test_layers.py``); both come out far inside (bf16 bit-equal);
- ``Model.prefill`` and eight teacher-forced ``decode_step``s: logits
  max|Δ|/max|want| <= 0.03 and top-1 agreement >= 0.9, caches
  max|Δ|/max|want| <= 0.03 per layer.  bf16 matmuls round once in each
  framework but sum in another order, so an activation can move by one
  bf16 ulp (2^-8 of itself) and four layers carry it on; measured
  ≈ 0.01 on logits.  Tighter than the reference's own decode-versus-
  prefill limits (0.15 and 0.5, ``tests/test_serve.py``), which the
  port's decode-versus-prefill tests here keep.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.train import scaled_config as jscaled
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import scaled_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

LOGIT_TOL = 0.03        # max|Δ| / max|want|, prefill and decode logits
TOP1 = 0.9              # top-1 agreement with the reference
B, S, EXTRA = 4, 48, 8  # batch, prompt, teacher-forced decode steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(a: np.ndarray, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(_f32(j).copy())
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _close(got: torch.Tensor, want, dtype):
    want = _f32(want)
    got = got.float().numpy()
    scale = np.abs(want).max()
    tol = 1e-6 * scale if dtype == jnp.float32 else _bf16_ulp(scale)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_equals_reference(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    for preset in ("smoke", "m100", "full"):
        assert dataclasses.asdict(scaled_config(arch, preset)) == \
            dataclasses.asdict(jscaled(arch, preset))


def test_registry_and_shapes_equal_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    cfg = tconfigs.get_config("qwen2-72b")
    assert cfg.scaled(pad_vocab_multiple=256).vocab_padded == 152064
    assert cfg.scaled(pad_vocab_multiple=1000).vocab_padded == 153000
    assert not cfg.supports(tconfigs.SHAPES["long_500k"])


# ------------------------------------------------------------------ layers

DTYPES = [jnp.float32, jnp.bfloat16]
IDS = ["f32", "bf16"]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    w, b = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(tlayers.rms_norm(tx, torch.from_numpy(w), 1e-5),
           jlayers.rms_norm(jx, jnp.asarray(w), 1e-5), dtype)
    _close(tlayers.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b)),
           jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b)), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_mlps_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32) * 3
    ws = [(rng.standard_normal(s) / 8).astype(np.float32)
          for s in ((64, 128), (64, 128), (128, 64))]
    jw, tw = zip(*(_pair(w, dtype) for w in ws))
    jx, tx = _pair(x, dtype)
    _close(tlayers.swiglu(tx, *tw), jlayers.swiglu(jx, *jw), dtype)
    b_in = (rng.standard_normal(128) * 0.1).astype(np.float32)
    b_out = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(tlayers.gelu_mlp(tx, tw[0], torch.from_numpy(b_in), tw[2],
                            torch.from_numpy(b_out)),
           jlayers.gelu_mlp(jx, jw[0], jnp.asarray(b_in), jw[2],
                            jnp.asarray(b_out)), dtype)
    _close(tlayers.gelu_mlp(tx, tw[0], None, tw[2], None),
           jlayers.gelu_mlp(jx, jw[0], None, jw[2], None), dtype)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_rope_matches_reference(dtype, fraction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32) * 2
    jx, tx = _pair(x, dtype)
    for pos, base in ((np.arange(100, 116), 1e6),
                      (rng.integers(0, 4096, (2, 16)), 1e4)):
        got = tlayers.apply_rope(tx, torch.from_numpy(pos), base=base,
                                 fraction=fraction)
        _close(got, jlayers.apply_rope(jx, jnp.asarray(pos), base=base,
                                       fraction=fraction), dtype)
        if fraction < 1:       # the tail is position-independent
            assert torch.equal(got[..., 16:], tx[..., 16:])


def test_sinusoidal_pos_matches_reference():
    _close(tlayers.sinusoidal_pos(64, 32, offset=5),
           jlayers.sinusoidal_pos(64, 32, 5), jnp.float32)


def test_inits_follow_the_reference_distributions():
    """Same shapes, dtypes, truncation and fan-in scale as the reference's
    draws (the streams differ: one is jax.random, one a torch.Generator).
    Standard deviations within 3% (65,536 draws: sampling noise ~0.3%)."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    got = tlayers.dense_init(g, 256, (8, 32), scale=2.0)
    want = _f32(jlayers.dense_init(key, 256, (8, 32), scale=2.0))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    std = 2.0 / 16
    assert float(got.float().abs().max()) <= 2 * std * (1 + 2 ** -8)
    assert float(got.float().std()) == pytest.approx(float(want.std()),
                                                     rel=0.03)
    got = tlayers.embed_init(g, 512, 128)
    want = _f32(jlayers.embed_init(key, 512, 128))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float(got.float().std()) == pytest.approx(float(want.std()),
                                                     rel=0.03)


# ------------------------------------------------------------- attention

ATTN_CASES = {   # (causal, window, q_offset, G, kv_chunk, q_chunk, skip, Sq)
    "causal_G1": (True, 0, 0, 1, 16, 32, False, 64),
    "causal_skip_G2": (True, 0, 0, 2, 16, 16, True, 64),
    "window_G8": (True, 8, 0, 8, 16, 32, False, 64),
    "bidirectional_G2": (False, 0, 0, 2, 16, 32, False, 64),
    "q_offset_G2": (True, 0, 40, 2, 16, 8, False, 24),
    "kv_chunk_fallback": (True, 0, 0, 2, 24, 32, False, 64),
    "q_chunk_fallback_skip": (True, 0, 0, 2, 16, 48, True, 64),
    "skip_G8": (True, 0, 0, 8, 16, 16, True, 48),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_reference(case, dtype):
    causal, window, q_offset, G, kv_chunk, q_chunk, skip, Sq = \
        ATTN_CASES[case]
    rng = np.random.default_rng(3)
    Skv, Hkv, hd = Sq + q_offset, 2, 16
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, Sq, Hkv * G, hd), (2, Skv, Hkv, hd),
                        (2, Skv, Hkv, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_chunk=kv_chunk, q_chunk=q_chunk, causal_skip=skip)
    got = tattn.flash_attention(tq, tk, tv, **kw)
    want = _f32(jattn.flash_attention(jq, jk, jv, **kw))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 1e-5 if dtype == jnp.float32 else 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_causal_skip_scans_the_triangle_only(monkeypatch):
    """With ``causal_skip`` q chunk i merges kv blocks [0, i] only (10 of
    16 blocks at 4 x 4 chunks), with the full scan's result."""
    calls = []
    inner = tattn._block_attn
    monkeypatch.setattr(tattn, "_block_attn",
                        lambda *a: calls.append(1) or inner(*a))
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 64, 4, 16, generator=g) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    outs = []
    for skip in (False, True):
        calls.clear()
        outs.append(tattn.flash_attention(q, k, v, kv_chunk=16, q_chunk=16,
                                          causal_skip=skip))
        assert len(calls) == (10 if skip else 16)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- model

ARCHS = {   # the dense archs at SMOKE size, each with what it exercises
    "qwen2-72b": {},                               # QKV bias, GQA G=2
    "chatglm3-6b": {"n_kv_heads": 2},              # partial RoPE, G=4
    "llama3-405b": {},                             # no bias
    "qwen2-72b-padded": {"vocab": 2000, "pad_vocab_multiple": 256},
    # the template's other dense branches: layer norm, GELU MLP with
    # biases, sinusoidal positions (no RoPE)
    "qwen1.5-4b-variant": {"norm_type": "layer", "mlp_act": "gelu",
                           "pos_embedding": "sinusoidal"},
}


def _cfgs(name):
    """(reference cfg, port cfg) of an ``ARCHS`` entry, kv chunks of 16 so
    the 48-token prompt takes the chunked path."""
    arch = name.replace("-padded", "").replace("-variant", "")
    kw = dict(ARCHS[name], attn_chunk=16)
    return (jscaled(arch, "smoke").scaled(**kw),
            scaled_config(arch, "smoke").scaled(**kw))


def _randomise(p, seed):
    """The reference's zero-initialised QKV, norm and MLP biases and norm
    weights set to seeded random values (a new tree; the JAX package is
    untouched)."""
    rng = np.random.default_rng(seed)

    def walk(tree, scale_of):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, scale_of)
            elif k in scale_of:
                out[k] = (rng.standard_normal(v.shape) * scale_of[k]
                          ).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(p, {"bq": 0.5, "bk": 0.5, "bv": 0.5, "w": 0.3, "b": 0.3,
                    "b_in": 0.3, "b_out": 0.3})


@pytest.fixture(scope="module", params=list(ARCHS))
def lm(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(11)))
    params = _randomise(params, 12)
    tokens = np.random.default_rng(13).integers(
        0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    jm = jbuild(jcfg)
    ref_prefill = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens[:, :S])}, S + EXTRA)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, params=params,
                tokens=tokens, jm=jm, ref_prefill=ref_prefill,
                model=interop.lm_params(params, tcfg, device="cpu"))


def _logits_close(got: torch.Tensor, want, vocab):
    want = _f32(want)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if want.shape[-1] > vocab:        # padded columns are masked exactly
        assert (got[:, vocab:] == -1e30).all()
        assert (want[:, vocab:] == -1e30).all()
        got, want = got[:, :vocab], want[:, :vocab]
    rel = np.abs(got - want).max() / np.abs(want).max()
    top1 = np.mean(got.argmax(-1) == want.argmax(-1))
    assert rel <= LOGIT_TOL and top1 >= TOP1, (rel, top1)


def _cache_close(got, want):
    assert got["len"] == int(want["len"])
    for key in ("k", "v"):
        g, w = got[key].float().numpy(), _f32(want[key])
        assert got[key].dtype == torch.bfloat16 and g.shape == w.shape
        for layer in range(w.shape[0]):
            scale = np.abs(w[layer]).max()
            assert np.abs(g[layer] - w[layer]).max() <= LOGIT_TOL * scale


def test_prefill_matches_reference(lm):
    prompt = lm["tokens"][:, :S]
    want_logits, want_cache = lm["ref_prefill"]
    got_logits, got_cache = lm["model"].prefill(
        {"tokens": torch.from_numpy(prompt)}, S + EXTRA)
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _cache_close(got_cache, want_cache)
    assert got_cache["k"].shape[2] == S + EXTRA
    assert not got_cache["k"][:, :, S:].any()


def test_teacher_forced_decode_matches_reference(lm):
    """Eight ``decode_step``s after a prefill, each fed the reference's
    next prompt token, against the reference's steps."""
    jstep = jax.jit(lm["jm"].decode_step)
    toks = lm["tokens"]
    jcache = lm["ref_prefill"][1]
    _, tcache = lm["model"].prefill({"tokens": torch.from_numpy(toks[:, :S])},
                                    S + EXTRA)
    for i in range(EXTRA):
        nxt = toks[:, S + i: S + i + 1]
        want, jcache = jstep(lm["params"], jnp.asarray(nxt), jcache)
        got, tcache = lm["model"].decode_step(torch.from_numpy(nxt), tcache)
        _logits_close(got, want, lm["jcfg"].vocab)
    _cache_close(tcache, jcache)


def test_decode_from_the_reference_cache(lm):
    """``interop.lm_cache`` carries the reference's cache over: one step
    from it equals one step from the port's own prefill cache."""
    toks = lm["tokens"]
    jcache = lm["ref_prefill"][1]
    cache = interop.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert cache["k"].dtype == torch.bfloat16 and cache["len"] == S
    nxt = toks[:, S: S + 1]
    want, _ = jax.jit(lm["jm"].decode_step)(lm["params"], jnp.asarray(nxt),
                                            jcache)
    got, cache = lm["model"].decode_step(torch.from_numpy(nxt), cache)
    _logits_close(got, want, lm["jcfg"].vocab)
    assert cache["len"] == S + 1


def test_lm_params_keeps_dtypes_and_values(lm):
    m, p = lm["model"], lm["params"]
    a0 = m.layers[0].attn
    assert a0.wq.dtype == torch.bfloat16 and m.final_norm.w.dtype == \
        torch.float32
    assert np.array_equal(a0.wq.float().numpy(), _f32(p["layers"]["attn"][
        "wq"][0]))
    assert np.array_equal(m.layers[-1].ln2.w.numpy(),
                          p["layers"]["ln2"]["w"][-1])
    if lm["jcfg"].qkv_bias:
        assert a0.bk.dtype == torch.float32
        assert np.array_equal(a0.bk.numpy(), p["layers"]["attn"]["bk"][0])
    bad = dict(p, embed=p["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        interop.lm_params(bad, lm["tcfg"], device="cpu")


# --------------------------------------------- the port's own serving path

DENSE = ("qwen2-72b", "chatglm3-6b", "llama3-405b", "qwen1.5-4b")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """As the reference's ``test_decode_matches_prefill``, on the port: a
    prompt plus eight teacher-forced steps against one prefill of the
    longer sequence, within the reference test's limits."""
    cfg = scaled_config(arch, "smoke").scaled(loss_chunk=64, attn_chunk=64)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    n, extra = 64, 8
    full = torch.randint(0, cfg.vocab, (2, n + extra),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    want, _ = model.prefill({"tokens": full}, n + extra)
    logits, cache = make_prefill(model, n + extra)({"tokens": full[:, :n]})
    step = make_decode_step(model)
    for i in range(extra):
        with syncs.sync_counter() as sc:
            _, logits, cache = step(full[:, n + i: n + i + 1], cache)
        assert sc.syncs == 0
    got, want = logits.numpy(), want.numpy()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.5
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < 0.15


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generation_deterministic(arch):
    cfg = scaled_config(arch, "smoke").scaled(loss_chunk=64, attn_chunk=64)
    t1, s1 = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    assert torch.equal(t1, t2) and t1.shape == (2, 8)
    assert t1.dtype == torch.int32 and int(t1.max()) < cfg.vocab
    assert {"prefill_s", "decode_s", "tok_per_s"} <= set(s1)
    assert s1["decode_host_syncs"] == 0 and s1["decode_step_ms"] is None


def test_sampled_generation_stays_in_vocab():
    """``sample=True`` draws from the softmax with the caller's generator:
    equal seeds give equal tokens, and the padded columns are never
    drawn."""
    cfg = scaled_config("qwen2-72b", "smoke").scaled(
        vocab=2000, pad_vocab_multiple=256, attn_chunk=64)
    t1, _ = tserve.serve(cfg, batch=2, prompt_len=16, gen=6, sample=True,
                         device="cpu", seed=5)
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=16, gen=6, sample=True,
                         device="cpu", seed=5)
    assert torch.equal(t1, t2) and int(t1.max()) < cfg.vocab


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "qwen2-72b", "--preset", "smoke", "--batch", "2",
                 "--prompt-len", "32", "--gen", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 8)" in out and "tok_per_s" in out
