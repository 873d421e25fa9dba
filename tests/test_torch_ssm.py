"""The Mamba-2 (ssm) serving path of the port vs the JAX package (CPU).

Both packages get the same numpy inputs.  ``models/ssm.py``'s functions run
at small shapes; the model runs at the SMOKE preset (``launch/train.py``:
4 layers, d_model 256, d_inner 512, 16 SSD heads of 32, state 64, chunk
64, conv width 4, vocab 2,048) on the reference's parameters carried over
by ``interop.lm_params``, with its zero-initialised norm weights and conv
biases first set to seeded random values.

Tolerances, and why:
- ``segsum``, ``ssd_chunked``, ``ssd_decode_step`` in float32: within
  1e-5·max|want| (the two frameworks' cumsum, exp and product summation
  orders differ in the last ulps; measured ~1e-6); the -inf pattern of
  ``segsum`` exactly; at bf16 inputs one bf16 ulp of max|want| on y;
- the chunked scan against the stepwise recurrence: the reference test's
  rtol = atol = 1e-3 (``tests/test_layers.py``);
- ``causal_conv1d``: float32 within 1e-6·max|want|, bf16 one bf16 ulp of
  max|want|; the tail exactly (it is a copy of the input);
- the model's constants: ``Dskip`` and ``dt_bias`` exactly, ``A_log``
  within one float32 ulp (XLA's CPU division and log round a few of the
  80 values the other way); init distributions: standard deviations
  within 3%;
- bf16 layers on the reference's own inputs, against the reference run
  op by op (``jax.disable_jit``): one bf16 ulp of max|want|, the layer's
  new SSD state within 1e-5·max|want|.  The jitted reference is not the
  bf16 yardstick: XLA's CPU pipeline drops the float32 → bf16 → float32
  round trips between fused ops (measured: half of a jitted layer's
  outputs differ from its own eager run by an ulp), which the port keeps,
  as the reference's code spells them;
- the model end to end, ``Model.prefill`` and eight teacher-forced
  ``decode_step``s: in float32 (both packages' parameters upcast) logits,
  every layer's SSD state and conv tail within 1e-4·max|want| (measured
  ~7e-6); in bf16 against the reference run op by op, the dense tests' limits
  (logits max|Δ|/max|want| <= 0.03, top-1 >= 0.9, caches 0.03 per layer;
  measured <= 0.018: bf16 products summed in other orders move an
  activation by an ulp, and four layers carry it on);
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
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import scaled_config
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

ARCH = "mamba2-2.7b"
B, S, EXTRA = 2, 72, 8   # batch, prompt (72 % chunk 64: the padding path)
F32_TOL = 1e-4           # float32 end to end, of max|want|
LM_TOL = 0.03            # the dense LM tests' cache limit (test_torch_lm.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(a))).to(dtype)


def _rel_close(got: torch.Tensor, want, tol):
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err / scale, tol)


def _ssd_inputs(S_, seed, H=4, P=8, N=16, Bsz=2):
    """x (B, S, H, P), dt > 0 (B, S, H), A < 0 (H,), Bm, Cm (B, S, N) and
    an initial state (B, H, P, N), float32 numpy (the reference test's
    distributions)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S_, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bsz, S_, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


# ------------------------------------------------------------ models/ssm

@pytest.mark.parametrize("T", [1, 5, 16])
def test_segsum_matches_reference(T):
    x = np.random.default_rng(0).standard_normal((2, 3, T)).astype(
        np.float32)
    got = tssm.segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm.segsum(jnp.asarray(x)))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(fin[0, 0], np.tril(np.ones((T, T), bool)))
    assert np.all(got[~fin] == -np.inf)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(
        want[fin]).max()
    assert not np.isnan(np.exp(got)).any()


SSD_CASES = {   # (S, chunk, with init_state)
    "chunk8": (64, 8, False), "chunk16": (64, 16, False),
    "chunk64": (64, 64, False), "chunk16_init": (64, 16, True),
    "chunk64_init": (64, 64, True), "pad_chunk16": (72, 16, False),
    "pad_chunk64_init": (72, 64, True), "short_S": (40, 64, False),
}


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_reference(case):
    S_, chunk, init = SSD_CASES[case]
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S_, seed=1)
    want_y, want_s = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
        init_state=jnp.asarray(s0) if init else None)
    got_y, got_s = tssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk,
        init_state=torch.from_numpy(s0) if init else None)
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    _rel_close(got_y, want_y, 1e-5)
    _rel_close(got_s, want_s, 1e-5)


def test_ssd_chunked_bf16_inputs_match_reference():
    """The model's dtypes: x, Bm, Cm bf16, dt float32; y comes back bf16,
    the state float32."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(72, seed=2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    tb = [_t(a, torch.bfloat16) for a in jb]
    want_y, want_s = jax.jit(jssm.ssd_chunked, static_argnames="chunk")(
        jb[0], jnp.asarray(dt), jnp.asarray(A), jb[1], jb[2], chunk=16)
    got_y, got_s = tssm.ssd_chunked(tb[0], torch.from_numpy(dt),
                                    torch.from_numpy(A), tb[1], tb[2],
                                    chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    _close(got_y, want_y, jnp.bfloat16)
    _rel_close(got_s, want_s, 1e-5)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (72, 16)])
def test_ssd_chunked_matches_stepwise(S_, chunk):
    """The chunked scan (from an initial state) against S
    ``ssd_decode_step``s, the reference test's 1e-3; each step against the
    reference's step within 1e-5·max|want|."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S_, seed=3)
    tx, tdt, tA, tB, tC = map(torch.from_numpy, (x, dt, A, Bm, Cm))
    y_chunk, final = tssm.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk,
                                      init_state=torch.from_numpy(s0))
    state, jstate, ys = torch.from_numpy(s0), jnp.asarray(s0), []
    for t in range(S_):
        y, state = tssm.ssd_decode_step(state, tx[:, t], tdt[:, t], tA,
                                        tB[:, t], tC[:, t])
        wy, jstate = jssm.ssd_decode_step(
            jstate, jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
            jnp.asarray(A), jnp.asarray(Bm[:, t]), jnp.asarray(Cm[:, t]))
        _rel_close(y, wy, 1e-5)
        ys.append(y)
    _rel_close(state, jstate, 1e-5)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(final.numpy(), state.numpy(), rtol=1e-3,
                               atol=1e-3)


CONV_CASES = {   # (S, with a tail)
    "no_tail": (24, False), "tail": (24, True), "one_token": (1, True),
    "one_token_no_tail": (1, False), "shorter_than_tail": (2, True),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_causal_conv1d_matches_reference(case, dtype):
    S_, with_tail = CONV_CASES[case]
    rng = np.random.default_rng(4)
    W, C = 4, 24
    x, w, tail = (jnp.asarray(rng.standard_normal(s).astype(np.float32),
                              dtype) for s in ((2, S_, C), (W, C),
                                               (2, W - 1, C)))
    b = jnp.asarray(rng.standard_normal(C).astype(np.float32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    for bias in (b, None):
        want_y, want_tail = jssm.causal_conv1d(
            x, w, bias, tail if with_tail else None)
        got_y, got_tail = tssm.causal_conv1d(
            _t(x, tdt), _t(w, tdt), None if bias is None else _t(bias),
            _t(tail, tdt) if with_tail else None)
        assert got_y.dtype == tdt and got_tail.dtype == tdt
        assert got_tail.shape == (2, W - 1, C)
        if dtype == jnp.float32:
            _rel_close(got_y, want_y, 1e-6)
        else:
            _close(got_y, want_y, dtype)
        assert np.array_equal(got_tail.float().numpy(), _f32(want_tail))


def test_causal_conv1d_tail_carries_over():
    """Two calls with the tail carried equal one call over the whole
    sequence, bit for bit (the reference test's property)."""
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(2, 24, 4, generator=g), torch.randn(4, 4, generator=g)
    y_full, tail = tssm.causal_conv1d(x, w, None)
    y1, t1 = tssm.causal_conv1d(x[:, :16], w, None)
    y2, t2 = tssm.causal_conv1d(x[:, 16:], w, None, tail=t1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(t2, tail) and torch.equal(tail, x[:, -3:])


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module")
def lm():
    """The reference's parameters (norm weights and conv biases
    randomised) as its bf16 tree and the port's model from
    ``interop.lm_params``, float32 copies of both, and the reference's
    jitted float32 prefill.  ``remat`` (a backward-pass policy, the
    identity forward) is off, so the op-by-op runs share compiled ops."""
    jcfg = jscaled(ARCH, "smoke").scaled(remat=False)
    tcfg = scaled_config(ARCH, "smoke").scaled(remat=False)
    params = _randomise(jax.tree.map(np.asarray,
                                     jinit(jcfg, jax.random.PRNGKey(31))), 32)
    rng = np.random.default_rng(33)
    lp = dict(params["layers"])
    lp["conv_b"] = (rng.standard_normal(lp["conv_b"].shape) * 0.3).astype(
        np.float32)
    params = dict(params, layers=lp)
    model = interop.lm_params(params, tcfg, device="cpu")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tokens = np.random.default_rng(34).integers(
        0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    jm = jbuild(jcfg)
    ref_prefill = jax.jit(jm.prefill, static_argnums=2)(
        params32, {"tokens": jnp.asarray(tokens[:, :S])}, S + EXTRA)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, params32=params32,
                tokens=tokens, jm=jm, ref_prefill=ref_prefill, model=model,
                model32=copy.deepcopy(model).float())


def test_ssm_params_carry_over(lm):
    """The reference's names, shapes and dtypes, leaf for leaf."""
    m, p, cfg = lm["model"], lm["params"], lm["tcfg"]
    blk, pl = m.layers[1], p["layers"]
    assert not hasattr(blk, "attn") and isinstance(blk, tmodel.MambaBlock)
    for name in ("wz", "wx", "wB", "wC", "wdt", "conv_x", "wo"):
        t = getattr(blk, name)
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == \
            pl[name].shape[1:]
        assert np.array_equal(t.float().numpy(), _f32(pl[name][1]))
    for name in ("conv_b", "A_log", "Dskip", "dt_bias"):
        t = getattr(blk, name)
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), pl[name][1])
    assert np.array_equal(blk.out_norm.w.numpy(), pl["out_norm"]["w"][1])
    assert blk.wx.shape == (cfg.d_model, cfg.d_inner)
    assert blk.A_log.shape == (cfg.ssm_heads,)


def test_lm_params_refuses_partial_ssm_trees(lm):
    p, cfg = lm["params"], lm["tcfg"]
    short = dict(p, layers={k: v for k, v in p["layers"].items()
                            if k != "A_log"})
    with pytest.raises(ValueError, match=r"not in the tree: layers\.0\."
                                         r"A_log"):
        interop.lm_params(short, cfg, device="cpu")
    with pytest.raises(ValueError, match="4 layers stacked, the config "
                                         "has 3"):
        interop.lm_params(p, cfg.scaled(n_layers=3), device="cpu")
    extra = dict(p, layers=dict(p["layers"], conv_B=p["layers"]["conv_x"]))
    with pytest.raises(ValueError, match="conv_B: in the tree, not in the "
                                         "model"):
        interop.lm_params(extra, cfg, device="cpu")


def test_fresh_model_constants_match_reference():
    """``Model(cfg)`` holds the reference's SSM constants at Mamba2-2.7B's
    80 heads: ``A_log = log(linspace(1, 16, H))`` (within one float32
    ulp), ``Dskip = 1``, ``dt_bias = -2``; conv bias and norms zero."""
    cfg = scaled_config(ARCH, "full").scaled(n_layers=1, vocab=64)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda k: jinit(cfg, k)["layers"])(jax.random.PRNGKey(0)))
    blk = tmodel.Model(cfg, "cpu").layers[0]
    a, w = blk.A_log.numpy(), want["A_log"][0]
    assert a.dtype == np.float32 and a.shape == (80,)
    assert np.all(np.abs(a - w) <= np.spacing(np.abs(w)))
    assert np.array_equal(blk.Dskip.numpy(), want["Dskip"][0])
    assert np.array_equal(blk.dt_bias.numpy(), want["dt_bias"][0])
    for t in (blk.conv_b, blk.norm.w, blk.out_norm.w):
        assert t.dtype == torch.float32 and not t.any()


def test_init_follows_the_reference_distributions():
    """``init_params`` draws each matrix with the reference's distribution
    (the streams differ: one is jax.random, one a torch.Generator):
    standard deviations within 3% (d_model 1,024: at least 8,192 draws a
    matrix, sampling noise under 0.8%), fan-in matrices cut at two of
    theirs, the constants untouched by the draws."""
    cfg = scaled_config(ARCH, "full").scaled(n_layers=1, vocab=64,
                                             d_model=1024)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda k: jinit(cfg, k)["layers"])(jax.random.PRNGKey(1)))
    blk = tmodel.init_params(cfg, torch.Generator().manual_seed(1),
                             "cpu").layers[0]
    fresh = tmodel.Model(cfg, "cpu").layers[0]
    D, Di = cfg.d_model, cfg.d_inner
    for name, fan_in in (("wz", D), ("wx", D), ("wB", D), ("wC", D),
                         ("wdt", D), ("conv_x", None), ("wo", Di)):
        got = getattr(blk, name).float().numpy()
        w = _f32(want[name][0])
        assert got.std() == pytest.approx(float(w.std()), rel=0.03), name
        if fan_in:
            assert np.abs(got).max() <= 2 / fan_in ** 0.5 * (1 + 2 ** -8)
    for name in ("A_log", "Dskip", "dt_bias"):
        assert torch.equal(getattr(blk, name), getattr(fresh, name))


def test_layers_match_reference_bf16(lm):
    """Each bf16 layer on the reference's own inputs, the reference run op
    by op: the block's output over the prompt, then one decode step from
    the reference's cache (output and conv tail within one bf16 ulp of
    max|want|, the new SSD state within 1e-5·max|want|)."""
    jcfg, m, jm, p = lm["jcfg"], lm["model"], lm["jm"], lm["params"]
    toks = jnp.asarray(lm["tokens"][:, :S])
    nxt = jnp.asarray(lm["tokens"][:, S: S + 1])
    with jax.disable_jit():
        x, _ = jmodel_lib._embed_inputs(p, jcfg, {"tokens": toks})
        _, cache = jm.prefill(p, {"tokens": toks}, S + 1)
        xd = jnp.asarray(p["embed"])[nxt]
        for i, blk in enumerate(m.layers):
            lp = jax.tree.map(lambda a: a[i], p["layers"])
            want = jmodel_lib._mamba_block_seq(lp, x, jcfg)
            got, _ = tmodel._mamba_block_seq(blk, _t(x, torch.bfloat16),
                                             m.cfg)
            _close(got, want, jnp.bfloat16)
            one = jax.tree.map(lambda a: a[i: i + 1], p["layers"])
            st, tl = cache["state"][i], cache["conv"][i]
            want_x, new = jm._ssm_decode(
                dict(p, layers=one), xd,
                {"state": st[None], "conv": tl[None], "len": cache["len"]})
            got_st, got_tl = _t(st), _t(tl, torch.bfloat16)
            got_x = tmodel._mamba_block_step(blk, _t(xd, torch.bfloat16),
                                             got_st, got_tl, m.cfg)
            _close(got_x, want_x, jnp.bfloat16)
            _close(got_tl, new["conv"][0], jnp.bfloat16)
            _rel_close(got_st, new["state"][0], 1e-5)
            x, xd = want, want_x


def _caches_close(got, want, tol):
    """Every layer's SSD state (float32) and conv tail within ``tol`` of
    that layer's max|want|; ``len`` a host int equal to the reference's."""
    assert isinstance(got["len"], int) and got["len"] == int(want["len"])
    assert got["state"].dtype == torch.float32
    for key in ("state", "conv"):
        g, w = got[key].float().numpy(), _f32(want[key])
        assert g.shape == w.shape
        for layer in range(w.shape[0]):
            scale = np.abs(w[layer]).max()
            assert np.abs(g[layer] - w[layer]).max() <= tol * scale, (
                key, layer)


def test_prefill_matches_reference(lm):
    """Float32 end to end: last-position logits and the whole cache."""
    want_logits, want_cache = lm["ref_prefill"]
    got_logits, got_cache = lm["model32"].prefill(
        {"tokens": torch.from_numpy(lm["tokens"][:, :S])}, S + EXTRA)
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _rel_close(got_logits, want_logits, F32_TOL)
    _caches_close(got_cache, want_cache, F32_TOL)


def test_teacher_forced_decode_matches_reference(lm):
    """Eight float32 ``decode_step``s after a prefill, each fed the
    reference's next prompt token, against the reference's steps; the
    caches after the last one."""
    jstep = jax.jit(lm["jm"].decode_step)
    toks, m = lm["tokens"], lm["model32"]
    jcache = lm["ref_prefill"][1]
    _, tcache = m.prefill({"tokens": torch.from_numpy(toks[:, :S])},
                          S + EXTRA)
    state = tcache["state"]
    for i in range(EXTRA):
        nxt = toks[:, S + i: S + i + 1]
        want, jcache = jstep(lm["params32"], jnp.asarray(nxt), jcache)
        got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
        _logits_close(got, want, lm["jcfg"].vocab)
        _rel_close(got, want, F32_TOL)
    assert tcache["state"] is state            # written in place
    _caches_close(tcache, jcache, F32_TOL)


def test_bf16_serving_matches_eager_reference(lm):
    """The served dtype end to end: bf16 prefill and eight teacher-forced
    decode steps against the reference run op by op."""
    toks, m, jm, p = lm["tokens"], lm["model"], lm["jm"], lm["params"]
    with jax.disable_jit():
        want, jcache = jm.prefill(p, {"tokens": jnp.asarray(toks[:, :S])},
                                  S + EXTRA)
        got, tcache = m.prefill({"tokens": torch.from_numpy(toks[:, :S])},
                                S + EXTRA)
        assert tcache["conv"].dtype == torch.bfloat16
        _logits_close(got, want, lm["jcfg"].vocab)
        _caches_close(tcache, jcache, LM_TOL)
        for i in range(EXTRA):
            nxt = toks[:, S + i: S + i + 1]
            want, jcache = jm.decode_step(p, jnp.asarray(nxt), jcache)
            got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
            _logits_close(got, want, lm["jcfg"].vocab)
    _caches_close(tcache, jcache, LM_TOL)


def test_decode_from_the_reference_cache(lm):
    """``interop.lm_cache`` carries the reference's SSM cache over (told
    from a KV cache by its keys): one float32 step from it equals the
    reference's step; the bf16 cache keeps its dtypes."""
    toks = lm["tokens"]
    jcache = lm["ref_prefill"][1]
    cache = interop.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert set(cache) == {"state", "conv", "len"} and cache["len"] == S
    nxt = toks[:, S: S + 1]
    want, _ = jax.jit(lm["jm"].decode_step)(lm["params32"], jnp.asarray(nxt),
                                            jcache)
    got, cache = lm["model32"].decode_step(torch.from_numpy(nxt), cache)
    _rel_close(got, want, F32_TOL)
    assert cache["len"] == S + 1
    zero = lm["jm"].init_cache(B, S)
    bf = interop.lm_cache(jax.tree.map(np.asarray, zero), device="cpu")
    ours = lm["model"].init_cache(B, S)
    for key in ("state", "conv"):
        assert bf[key].dtype == ours[key].dtype
        assert bf[key].shape == ours[key].shape


# --------------------------------------------- the port's own serving path

def test_decode_matches_prefill():
    """As the reference's ``test_decode_matches_prefill`` for Mamba-2 (a
    64-token prompt, chunk 64, and 8 teacher-forced steps against one
    prefill of 72, which pads), on the port, 0 host syncs a step."""
    cfg = scaled_config(ARCH, "smoke").scaled(loss_chunk=64, attn_chunk=64)
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


def test_greedy_generation_deterministic():
    cfg = scaled_config(ARCH, "smoke")
    t1, s1 = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    assert torch.equal(t1, t2) and t1.shape == (2, 8)
    assert int(t1.max()) < cfg.vocab and s1["decode_host_syncs"] == 0


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--preset", "smoke", "--batch", "2",
                 "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4)" in out and "tok_per_s" in out
