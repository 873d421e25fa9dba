"""The Whisper (audio) serving path of the port vs the JAX package (CPU).

Both packages get the same numpy inputs: the reference's parameters
(``repro.models.model.init_params``) carried over by
``interop.lm_params``, with its zero-initialised norm weights and biases
and GELU MLP biases first set to seeded random values, and stub frames
drawn with numpy.  Sizes are the SMOKE preset's (``launch/train.py``): 2
encoder and 4 decoder layers, d_model 256, 8 query and 4 KV heads of 32,
d_ff 1,024, vocab 2,048, layer norms, the tanh-GELU MLP with biases,
sinusoidal positions; 40 frames and a 24-token prompt.

Tolerances, and why:
- float32 end to end (both packages' parameters upcast; the reference run
  with its param dtype ``PDT`` set to float32 for the call, since it casts
  the frames and the sinusoidal table to ``PDT`` and its layer scan needs
  one carry dtype; the port's float32 copy computes in float32 from its
  inputs on): cross-attention, the encoder, the decoder sequence with its
  k, v, xk and xv, prefill logits and cache and eight teacher-forced
  decode steps within F32_TOL = 1e-4 of max|want| (measured ~8e-7: the
  two frameworks' exp, rsqrt and tanh differ in the last ulp and the sums
  run in other orders);
- one bf16 decoder block (self-attention, cross-attention, MLP) and its
  k, v and cross k, v: within one bf16 ulp of max|want| of the jitted
  reference;
- the model in bf16: prefill and eight teacher-forced steps against the
  jitted reference at the dense LM tests' limits (logits max|Δ|/max|want|
  <= 0.03, top-1 >= 0.9, caches 0.03 a layer; measured ~0.006, and
  ~0.006 too against the reference run op by op under
  ``jax.disable_jit``, which takes ~20 s here and is left out);
- decode against one prefill of the longer sequence (the port alone): the
  reference test's 0.15 and top-1 >= 0.5 (``tests/test_serve.py``).
"""
from __future__ import annotations

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
from repro_torch.models import model as tmodel
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

ARCH = "whisper-base"
B, S, EXTRA, S_ENC = 2, 24, 8, 40  # batch, prompt, decode steps, frames
F32_TOL = 1e-4                     # float32 end to end, of max|want|
LM_TOL = 0.03                      # the dense LM tests' cache limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
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
    """The reference's ``PDT`` (the dtype it casts frames, tokens'
    embeddings and the sinusoidal table to) set to float32 inside the
    block: its float32 run."""

    def __enter__(self):
        self.pdt, jmodel_lib.PDT = jmodel_lib.PDT, jnp.float32

    def __exit__(self, *exc):
        jmodel_lib.PDT = self.pdt


@pytest.fixture(scope="module")
def lm():
    """The reference's parameters (norms, biases randomised) as its bf16
    tree and the port's model from ``interop.lm_params``, float32 copies
    of both, frames and tokens, and the reference's float32 and bf16
    jitted prefills."""
    jcfg, tcfg = jscaled(ARCH, "smoke"), scaled_config(ARCH, "smoke")
    params = _randomise(jax.tree.map(np.asarray, jax.jit(
        jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(51))), 52)
    model = interop.lm_params(params, tcfg, device="cpu")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(53)
    tokens = rng.integers(0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    frames = rng.standard_normal((B, S_ENC, jcfg.d_model)).astype(
        np.float32)
    jm = jbuild(jcfg)
    batch = {"tokens": jnp.asarray(tokens[:, :S]),
             "frames": jnp.asarray(frames)}
    with _f32_reference():
        ref32 = jax.jit(jm.prefill, static_argnums=2)(params32, batch,
                                                      S + EXTRA)
    ref16 = jax.jit(jm.prefill, static_argnums=2)(params, batch, S + EXTRA)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, params32=params32,
                tokens=tokens, frames=frames, jm=jm, ref32=ref32,
                ref16=ref16, model=model,
                model32=copy.deepcopy(model).float())


def _batch(lm, n=S):
    return {"tokens": torch.from_numpy(lm["tokens"][:, :n]),
            "frames": torch.from_numpy(lm["frames"])}


def _cache_close(got, want, tol):
    """k, v (grown to the cache length), xk and xv (the frames' length)
    within ``tol`` of each layer's max|want|; ``len`` a host int."""
    assert isinstance(got["len"], int) and got["len"] == int(want["len"])
    assert set(got) == {"k", "v", "xk", "xv", "len"}
    for key in ("k", "v", "xk", "xv"):
        g, w = got[key].float().numpy(), _f32(want[key])
        assert g.shape == w.shape, key
        for layer in range(w.shape[0]):
            scale = np.abs(w[layer]).max()
            assert np.abs(g[layer] - w[layer]).max() <= tol * scale, key


def test_audio_params_carry_over(lm):
    """The reference's names, shapes and dtypes, leaf for leaf: 2 encoder
    blocks without and 4 decoder blocks with ``lnx``/``xattn``; layer
    norms (w and b), GELU MLPs with biases, no QKV biases anywhere."""
    m, p = lm["model"], lm["params"]
    assert len(m.enc_layers) == 2 and len(m.dec_layers) == 4
    assert not hasattr(m, "layers")
    assert not hasattr(m.enc_layers[0], "xattn")
    x = m.dec_layers[3].xattn
    assert not x.qkv_bias and not hasattr(x, "bq")
    assert np.array_equal(x.wv.float().numpy(),
                          _f32(p["dec_layers"]["xattn"]["wv"][3]))
    assert np.array_equal(m.dec_layers[1].lnx.b.numpy(),
                          p["dec_layers"]["lnx"]["b"][1])
    mlp = m.enc_layers[1].mlp
    assert mlp.b_in.dtype == torch.float32 and mlp.w_in.dtype == \
        torch.bfloat16
    assert np.array_equal(mlp.b_out.numpy(),
                          p["enc_layers"]["mlp"]["b_out"][1])


def test_lm_params_refuses_partial_audio_trees(lm):
    """A decoder layer's ``xattn`` leaf missing, an encoder or decoder
    depth other than the config's: ``ValueError`` each."""
    p, cfg = lm["params"], lm["tcfg"]
    xattn = {k: v for k, v in p["dec_layers"]["xattn"].items() if k != "wk"}
    dec = dict(p["dec_layers"], xattn=xattn)
    with pytest.raises(ValueError, match=r"not in the tree: "
                                         r"dec_layers\.0\.xattn\.wk"):
        interop.lm_params(dict(p, dec_layers=dec), cfg, device="cpu")
    with pytest.raises(ValueError, match="2 encoder layers stacked, the "
                                         "config has 3"):
        interop.lm_params(p, cfg.scaled(enc_layers=3), device="cpu")
    with pytest.raises(ValueError, match="4 decoder layers stacked, the "
                                         "config has 2"):
        interop.lm_params(p, cfg.scaled(n_layers=2), device="cpu")


def test_cross_attn_seq_matches_reference(lm):
    """``_attn_seq`` with ``kv_override`` in float32: no k/v projection,
    no positions, non-causal over the encoder's 40 positions."""
    p32, jcfg, m = lm["params32"], lm["jcfg"], lm["model32"]
    rng = np.random.default_rng(54)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    hd, H = jcfg.head_dim, jcfg.n_kv_heads
    k, v = (rng.standard_normal((B, S_ENC, H, hd)).astype(np.float32)
            for _ in range(2))
    lp = jax.tree.map(lambda a: a[2], p32["dec_layers"]["xattn"])
    want, (wk, _) = jax.jit(lambda x, k, v: jmodel_lib._attn_seq(
        lp, x, jcfg, jnp.arange(S), causal=False, kv_override=(k, v)))(
        x, k, v)
    got, (gk, _) = tmodel._attn_seq(
        m.dec_layers[2].xattn, torch.from_numpy(x), m.cfg, torch.arange(S),
        causal=False, kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    _rel_close(got, want, F32_TOL)
    assert np.array_equal(gk.numpy(), np.asarray(wk))


def test_encoder_matches_reference(lm):
    """``_whisper_encode`` in float32: the frames plus the sinusoidal
    table through the bidirectional blocks, no final norm."""
    m = lm["model32"]
    with _f32_reference():
        want = jax.jit(lambda f: jmodel_lib._whisper_encode(
            lm["params32"], lm["jcfg"], f))(lm["frames"])
    got = tmodel._whisper_encode(m, m.cfg, torch.from_numpy(lm["frames"]))
    assert got.dtype == torch.float32
    _rel_close(got, want, F32_TOL)


def test_decoder_seq_matches_reference(lm):
    """``_whisper_decode_seq`` in float32 over the reference's encoder
    output: hidden states, each layer's k and v and its cross-attention
    xk and xv."""
    p32, jcfg, m = lm["params32"], lm["jcfg"], lm["model32"]
    toks = lm["tokens"][:, :S]
    with _f32_reference():
        enc = jax.jit(lambda f: jmodel_lib._whisper_encode(p32, jcfg, f))(
            lm["frames"])
        want, ((wk, wv), (wxk, wxv)) = jax.jit(
            lambda p, t, e: jmodel_lib._whisper_decode_seq(
                p, jcfg, t, e, collect_kv=True))(p32, toks, enc)
    got, ((k, v), (xk, xv)) = tmodel._whisper_decode_seq(
        m, m.cfg, torch.from_numpy(toks), torch.from_numpy(np.array(enc)),
        collect_kv=True)
    _rel_close(got, want, F32_TOL)
    for g, w in ((k, wk), (v, wv), (xk, wxk), (xv, wxv)):
        assert g.shape == (4, B) + w.shape[2:]
        _rel_close(g, w, F32_TOL)
    assert xk.shape[2] == S_ENC and k.shape[2] == S
    _, none = tmodel._whisper_decode_seq(m, m.cfg, torch.from_numpy(toks),
                                         torch.from_numpy(np.array(enc)))
    assert none is None


def test_prefill_matches_reference(lm):
    """Float32 end to end: last-position logits and the whole cache (k and
    v grown to 32 positions, zeros past the prompt; xk and xv over the 40
    frames)."""
    want_logits, want_cache = lm["ref32"]
    got_logits, got_cache = lm["model32"].prefill(_batch(lm), S + EXTRA)
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _rel_close(got_logits, want_logits, F32_TOL)
    _cache_close(got_cache, want_cache, F32_TOL)
    assert got_cache["k"].shape[2] == S + EXTRA
    assert got_cache["xk"].shape[2] == S_ENC
    assert not got_cache["v"][:, :, S:].any()


def test_teacher_forced_decode_matches_reference(lm):
    """Eight float32 ``decode_step``s after a prefill, each fed the
    reference's next prompt token, against the reference's steps (the
    sinusoidal row ``pos`` of a table of the cache's length, cross-
    attention over all of xk); the cache after the last, written in
    place."""
    toks, m = lm["tokens"], lm["model32"]
    jcache = lm["ref32"][1]
    _, tcache = m.prefill(_batch(lm), S + EXTRA)
    k = tcache["k"]
    with _f32_reference():
        jstep = jax.jit(lm["jm"].decode_step)
        for i in range(EXTRA):
            nxt = toks[:, S + i: S + i + 1]
            want, jcache = jstep(lm["params32"], jnp.asarray(nxt), jcache)
            got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
            _logits_close(got, want, lm["jcfg"].vocab)
            _rel_close(got, want, F32_TOL)
    assert tcache["k"] is k and tcache["len"] == S + EXTRA
    _cache_close(tcache, jcache, F32_TOL)


def test_decoder_block_matches_reference_bf16(lm):
    """One bf16 decoder block (the third) on the reference's inputs: self-
    attention, cross-attention over projected frames, the GELU MLP, within
    one bf16 ulp of max|want|; its k, v and the cross k and v too."""
    jcfg, m, p = lm["jcfg"], lm["model"], lm["params"]
    rng = np.random.default_rng(55)
    x, enc = (jnp.asarray(rng.standard_normal((B, n, jcfg.d_model)),
                          jnp.bfloat16) for n in (S, S_ENC))
    lp = jax.tree.map(lambda a: a[2], p["dec_layers"])
    def block(lp, x, enc):
        xkv = tuple(jnp.einsum("bsd,dhk->bshk", enc, lp["xattn"][w])
                    for w in ("wk", "wv"))
        return jmodel_lib._dense_block_seq(
            lp, x, jcfg, jnp.arange(S), cross_kv=xkv), xkv
    (want, (wk, wv), _), xkv = jax.jit(block)(lp, x, enc)
    blk = m.dec_layers[2]
    tenc = torch.from_numpy(np.array(_f32(enc))).to(torch.bfloat16)
    gxkv = (tmodel._proj(tenc, blk.xattn.wk), tmodel._proj(tenc, blk.xattn.wv))
    got, (gk, gv), aux = tmodel._dense_block_seq(
        blk, torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16), m.cfg,
        torch.arange(S), cross_kv=gxkv)
    assert got.dtype == torch.bfloat16 and aux == 0.0
    for g, w in ((got, want), (gk, wk), (gv, wv), *zip(gxkv, xkv)):
        _close(g, w, jnp.bfloat16)


def test_bf16_serving_matches_reference(lm):
    """The served dtype end to end: bf16 prefill and eight teacher-forced
    decode steps against the jitted reference."""
    toks, m, p = lm["tokens"], lm["model"], lm["params"]
    want, jcache = lm["ref16"]
    got, tcache = m.prefill(_batch(lm), S + EXTRA)
    assert tcache["xv"].dtype == torch.bfloat16
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
    """``interop.lm_cache`` carries the reference's audio cache over (told
    by its ``xk``): one float32 step from it equals the reference's step.
    The reference's zero cache sizes ``xk``/``xv`` by the cache length,
    not the frames' (its quirk, which ``init_cache`` follows); it crosses
    as four tensors of the port's dtypes and shapes, and one bf16 step
    from it equals the reference's."""
    toks, jm = lm["tokens"], lm["jm"]
    jcache = lm["ref32"][1]
    cache = interop.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert set(cache) == {"k", "v", "xk", "xv", "len"} and cache["len"] == S
    nxt = toks[:, S: S + 1]
    with _f32_reference():
        want, jnew = jax.jit(jm.decode_step)(lm["params32"],
                                             jnp.asarray(nxt), jcache)
    got, cache = lm["model32"].decode_step(torch.from_numpy(nxt), cache)
    _rel_close(got, want, F32_TOL)
    _cache_close(cache, jnew, F32_TOL)
    zero = jm.init_cache(B, S)
    bf = interop.lm_cache(jax.tree.map(np.asarray, zero), device="cpu")
    ours = lm["model"].init_cache(B, S)
    assert len({bf[k].data_ptr() for k in ("k", "v", "xk", "xv")}) == 4
    for key in ("k", "v", "xk", "xv"):
        assert bf[key].dtype == ours[key].dtype == torch.bfloat16
        assert bf[key].shape == ours[key].shape == (4, B, S, 4, 32)
    want, _ = jax.jit(jm.decode_step)(lm["params"], jnp.asarray(nxt), zero)
    got, ours = lm["model"].decode_step(torch.from_numpy(nxt), ours)
    _logits_close(got, want, lm["jcfg"].vocab)
    assert ours["len"] == 1


# --------------------------------------------- the port's own serving path

def test_decode_matches_prefill():
    """As the reference's ``test_decode_matches_prefill`` for Whisper: 64
    frames, a 16-token prompt and 8 teacher-forced steps against one
    prefill of 24 tokens over the same frames, on the port, 0 host syncs a
    step."""
    cfg = scaled_config(ARCH, "smoke").scaled(attn_chunk=64)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    n, extra = 16, 8
    g = torch.Generator().manual_seed(4)
    full = torch.randint(0, cfg.vocab, (2, n + extra), generator=g,
                         dtype=torch.int32)
    frames = torch.randn((2, 64, cfg.d_model), generator=g)
    want, _ = model.prefill({"tokens": full, "frames": frames}, n + extra)
    logits, cache = make_prefill(model, n + extra)(
        {"tokens": full[:, :n], "frames": frames})
    step = make_decode_step(model)
    for i in range(extra):
        with syncs.sync_counter() as sc:
            _, logits, cache = step(full[:, n + i: n + i + 1], cache)
        assert sc.syncs == 0
    got, want = logits.numpy(), want.numpy()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.5
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < 0.15


def test_serve_draws_frames_and_is_deterministic():
    """``serve`` draws frames of (batch, prompt_len, d_model) in bf16 beside
    the tokens, as the reference's serve; two greedy runs are equal."""
    cfg = scaled_config(ARCH, "smoke")
    b = tserve.prompt_batch(cfg, 2, 12, 0, torch.device("cpu"))
    assert b["tokens"].shape == (2, 12) and b["tokens"].dtype == torch.int32
    assert b["frames"].shape == (2, 12, 256)
    assert b["frames"].dtype == torch.bfloat16
    t1, s1 = tserve.serve(cfg, batch=2, prompt_len=12, gen=6, device="cpu")
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=12, gen=6, device="cpu")
    assert torch.equal(t1, t2) and t1.shape == (2, 6)
    assert int(t1.max()) < cfg.vocab and s1["decode_host_syncs"] == 0


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--preset", "smoke", "--batch", "2",
                 "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4)" in out and "tok_per_s" in out
