"""The VLM (InternVL2) serving path of the port vs the JAX package (CPU).

The VLM is the dense decoder with a patch frontend: the patches (stub
embeddings of ``frontend_dim``) projected by ``patch_proj`` and put before
the tokens' embeddings, then RoPE over positions 0 .. P+S-1.  Both
packages get the same numpy inputs: the reference's parameters carried
over by ``interop.lm_params`` (norm weights randomised), patches and
tokens drawn with numpy.  Sizes are the SMOKE preset's (``launch/
train.py``): 4 layers, d_model 256, 8 query and 4 KV heads of 32, vocab
2,048, 16 patches of 64 features; a prompt of 16 patches and 24 tokens.

Tolerances, and why (as ``tests/test_torch_audio.py``):
- float32 end to end (both packages' parameters upcast, the reference's
  ``PDT`` set to float32 for the call, as it casts the patches to it):
  the patch projection, prefill logits and k/v cache and eight
  teacher-forced decode steps within F32_TOL = 1e-4 of max|want|
  (measured ~2e-6);
- bf16: the embedded prompt within one bf16 ulp of max|want|; the model
  against the jitted reference at the dense LM tests' limits (logits
  max|Δ|/max|want| <= 0.03, top-1 >= 0.9, caches 0.03 a layer; measured
  ~0.013);
- decode against one prefill of the longer sequence (the port alone): the
  reference test's 0.15 and top-1 >= 0.5 (``tests/test_serve.py``).
"""
from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _close, _f32, _logits_close, _randomise

from repro.launch.train import scaled_config as jscaled
from repro.models import model as jmodel_lib
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import scaled_config
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

ARCH = "internvl2-2b"
B, S, EXTRA = 2, 24, 8   # batch, prompt tokens, teacher-forced decode steps
P = 16                   # the smoke preset's patches
CACHE = P + S + EXTRA
F32_TOL = 1e-4           # float32 end to end, of max|want|
LM_TOL = 0.03            # the dense LM tests' cache limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(got: torch.Tensor, want, tol):
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err / scale, tol)


class _f32_reference:
    """The reference's ``PDT`` set to float32 inside the block."""

    def __enter__(self):
        self.pdt, jmodel_lib.PDT = jmodel_lib.PDT, jnp.float32

    def __exit__(self, *exc):
        jmodel_lib.PDT = self.pdt


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = jscaled(ARCH, "smoke"), scaled_config(ARCH, "smoke")
    assert jcfg.n_patches == P
    params = _randomise(jax.tree.map(np.asarray, jax.jit(
        jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(61))), 62)
    model = interop.lm_params(params, tcfg, device="cpu")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(63)
    tokens = rng.integers(0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    patches = rng.standard_normal((B, P, jcfg.frontend_dim)).astype(
        np.float32)
    jm = jbuild(jcfg)
    batch = {"tokens": jnp.asarray(tokens[:, :S]),
             "patches": jnp.asarray(patches)}
    with _f32_reference():
        ref32 = jax.jit(jm.prefill, static_argnums=2)(params32, batch, CACHE)
    ref16 = jax.jit(jm.prefill, static_argnums=2)(params, batch, CACHE)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, params32=params32,
                tokens=tokens, patches=patches, jm=jm, ref32=ref32,
                ref16=ref16, model=model,
                model32=copy.deepcopy(model).float())


def _batch(lm):
    return {"tokens": torch.from_numpy(lm["tokens"][:, :S]),
            "patches": torch.from_numpy(lm["patches"])}


def _cache_close(got, want, tol):
    assert isinstance(got["len"], int) and got["len"] == int(want["len"])
    assert set(got) == {"k", "v", "len"}
    for key in ("k", "v"):
        g, w = got[key].float().numpy(), _f32(want[key])
        assert g.shape == w.shape, key
        for layer in range(w.shape[0]):
            scale = np.abs(w[layer]).max()
            assert np.abs(g[layer] - w[layer]).max() <= tol * scale, key


def test_vlm_params_carry_over(lm):
    """``patch_proj`` (frontend_dim, d_model) bf16 beside the dense
    layers; a missing or misshapen one refused."""
    m, p = lm["model"], lm["params"]
    assert m.patch_proj.shape == (64, 256)
    assert m.patch_proj.dtype == torch.bfloat16
    assert np.array_equal(m.patch_proj.float().numpy(),
                          _f32(p["patch_proj"]))
    assert len(m.layers) == 4
    with pytest.raises(ValueError, match="not in the tree: patch_proj"):
        interop.lm_params({k: v for k, v in p.items() if k != "patch_proj"},
                          lm["tcfg"], device="cpu")
    with pytest.raises(ValueError, match="patch_proj"):
        interop.lm_params(dict(p, patch_proj=p["patch_proj"][:32]),
                          lm["tcfg"], device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_patch_embedding_matches_reference(lm, dtype):
    """``_embed_inputs``: the projected patches, then the tokens'
    embeddings, (B, P + S, D)."""
    f32 = dtype == "f32"
    params = lm["params32"] if f32 else lm["params"]
    m = lm["model32"] if f32 else lm["model"]
    batch = {"tokens": jnp.asarray(lm["tokens"][:, :S]),
             "patches": jnp.asarray(lm["patches"])}
    with _f32_reference() if f32 else contextlib.nullcontext():
        want, _ = jax.jit(lambda p, b: jmodel_lib._embed_inputs(
            p, lm["jcfg"], b))(params, batch)
    got, mask = tmodel._embed_inputs(m, m.cfg, _batch(lm))
    assert mask is None and got.shape == (B, P + S, 256)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    if f32:
        _rel_close(got, want, F32_TOL)
    else:
        _close(got, want, jnp.bfloat16)
    assert torch.equal(got[:, P:], torch.nn.functional.embedding(
        _batch(lm)["tokens"], m.embed))


def test_vlm_prefix_positions(lm):
    """The patches take positions 0 .. P-1 and the tokens P .. P+S-1: the
    first layer's cached k is RoPE at those positions of its projection of
    the embedded prompt, ``len`` is P + S, and the first decode step
    writes slot P + S."""
    m = lm["model32"]
    cfg = m.cfg
    _, cache = m.prefill(_batch(lm), CACHE)
    assert cache["len"] == P + S
    x, _ = tmodel._embed_inputs(m, cfg, _batch(lm))
    lp = m.layers[0]
    k = tmodel._proj(tmodel._apply_norm(lp.ln1, x, cfg), lp.attn.wk)
    want = tlayers.apply_rope(k, torch.arange(P + S), base=cfg.rope_base)
    assert torch.equal(cache["k"][0, :, :P + S], want)
    assert not cache["k"][:, :, P + S:].any()
    _, cache = m.decode_step(torch.from_numpy(lm["tokens"][:, S:S + 1]),
                             cache)
    assert cache["len"] == P + S + 1
    assert cache["k"][:, :, P + S].any() and not cache["k"][
        :, :, P + S + 1:].any()


def test_prefill_matches_reference(lm):
    """Float32 end to end: last-position logits and the k/v cache."""
    want_logits, want_cache = lm["ref32"]
    got_logits, got_cache = lm["model32"].prefill(_batch(lm), CACHE)
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _rel_close(got_logits, want_logits, F32_TOL)
    _cache_close(got_cache, want_cache, F32_TOL)


def test_teacher_forced_decode_matches_reference(lm):
    """Eight float32 ``decode_step``s after the prefill against the
    reference's (RoPE at P + S + i)."""
    toks, m = lm["tokens"], lm["model32"]
    jcache = lm["ref32"][1]
    _, tcache = m.prefill(_batch(lm), CACHE)
    with _f32_reference():
        jstep = jax.jit(lm["jm"].decode_step)
        for i in range(EXTRA):
            nxt = toks[:, S + i: S + i + 1]
            want, jcache = jstep(lm["params32"], jnp.asarray(nxt), jcache)
            got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
            _rel_close(got, want, F32_TOL)
    _cache_close(tcache, jcache, F32_TOL)


def test_bf16_serving_matches_reference(lm):
    """bf16 prefill and eight teacher-forced steps against the jitted
    reference."""
    toks, m, p = lm["tokens"], lm["model"], lm["params"]
    want, jcache = lm["ref16"]
    got, tcache = m.prefill(_batch(lm), CACHE)
    _logits_close(got, want, lm["jcfg"].vocab)
    _cache_close(tcache, jcache, LM_TOL)
    jstep = jax.jit(lm["jm"].decode_step)
    for i in range(EXTRA):
        nxt = toks[:, S + i: S + i + 1]
        want, jcache = jstep(p, jnp.asarray(nxt), jcache)
        got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
        _logits_close(got, want, lm["jcfg"].vocab)
    _cache_close(tcache, jcache, LM_TOL)


def test_decode_from_the_reference_cache(lm):
    """``interop.lm_cache`` carries the reference's VLM cache (a KV cache of
    P + S positions) over: one float32 step from it equals the
    reference's."""
    jcache = lm["ref32"][1]
    cache = interop.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert set(cache) == {"k", "v", "len"} and cache["len"] == P + S
    nxt = lm["tokens"][:, S: S + 1]
    with _f32_reference():
        want, _ = jax.jit(lm["jm"].decode_step)(lm["params32"],
                                                jnp.asarray(nxt), jcache)
    got, cache = lm["model32"].decode_step(torch.from_numpy(nxt), cache)
    _rel_close(got, want, F32_TOL)


# --------------------------------------------- the port's own serving path

def test_decode_matches_prefill():
    """As the reference's ``test_decode_matches_prefill`` for the VLM: 16
    patches and 48 tokens, 8 teacher-forced steps against one prefill of
    the longer sequence, on the port, 0 host syncs a step."""
    cfg = scaled_config(ARCH, "smoke").scaled(attn_chunk=64)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    n, extra = 48, 8
    g = torch.Generator().manual_seed(4)
    full = torch.randint(0, cfg.vocab, (2, n + extra), generator=g,
                         dtype=torch.int32)
    patches = torch.randn((2, P, cfg.frontend_dim), generator=g)
    want, _ = model.prefill({"tokens": full, "patches": patches},
                            P + n + extra)
    logits, cache = make_prefill(model, P + n + extra)(
        {"tokens": full[:, :n], "patches": patches})
    step = make_decode_step(model)
    for i in range(extra):
        with syncs.sync_counter() as sc:
            _, logits, cache = step(full[:, n + i: n + i + 1], cache)
        assert sc.syncs == 0
    got, want = logits.numpy(), want.numpy()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.5
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < 0.15


def test_serve_draws_patches_and_is_deterministic():
    """``serve`` draws P patches in bf16 and prompt_len - P tokens, as the
    reference's serve; it refuses a prompt with no room for a token; two
    greedy runs are equal."""
    cfg = scaled_config(ARCH, "smoke")
    b = tserve.prompt_batch(cfg, 2, 20, 0, torch.device("cpu"))
    assert b["tokens"].shape == (2, 4) and set(b) == {"tokens", "patches"}
    assert b["patches"].shape == (2, P, 64)
    assert b["patches"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="16 patches"):
        tserve.prompt_batch(cfg, 2, P, 0, torch.device("cpu"))
    t1, s1 = tserve.serve(cfg, batch=2, prompt_len=20, gen=6, device="cpu")
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=20, gen=6, device="cpu")
    assert torch.equal(t1, t2) and t1.shape == (2, 6)
    assert int(t1.max()) < cfg.vocab and s1["decode_host_syncs"] == 0


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--preset", "smoke", "--batch", "2",
                 "--prompt-len", "24", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4)" in out and "tok_per_s" in out
