"""The RecurrentGemma (hybrid) serving path of the port vs the JAX package
(CPU).

Both packages get the same numpy inputs.  ``models/rglru.py``'s functions
run at small shapes; the model runs at the SMOKE preset (``launch/
train.py``: 5 layers = one (rec, rec, attn) group and a tail of two
recurrent layers, d_model and lru_width 256, 8 query heads of 32, one KV
head, window 256, conv width 4, vocab 2,048) on the reference's
parameters carried over by ``interop.lm_params``, with its
zero-initialised norm weights and biases (``conv_b``, ``b_r``, ``b_i``)
first set to seeded random values.

Tolerances, and why:
- ``rglru_scan`` and ``rglru_step`` in float32: y and the final h within
  4 float32 ulps of max|want| (the port runs JAX's associative-scan
  recursion and combines in its order; the two frameworks' sigmoid, exp
  and sqrt and XLA's fused multiply-adds differ in the last ulp; measured
  <= 2.5 ulps); bf16 inputs: y within one bf16 ulp of max|want|, h as in
  float32;
- the scan against the port's own stepwise recurrence: 1e-5·max|want|
  (another association of the same products);
- ``_ring_init``: exactly (a copy);
- the model's constants: ``lam`` within one float32 ulp (XLA folds
  linspace's division into a reciprocal product and fuses its
  multiply-adds); init distributions: standard deviations within 3% (the
  1,024 draws of ``conv_w``: within 7%, 3 sigma, of 0.5);
- one bf16 recurrent block on the reference's inputs, against the
  reference run op by op (``jax.disable_jit``; the jitted reference drops
  float32 → bf16 → float32 round trips that the port keeps,
  ``tests/test_torch_ssm.py``): output and conv tail within one bf16 ulp
  of max|want|, the final h (float32) within 1e-5·max|want|, over the
  prompt and for one decode step;
- the model end to end, ``Model.prefill`` and eight teacher-forced
  ``decode_step``s: in float32 (both packages' parameters upcast) logits
  and the whole cache (every h, conv tail and ring) within F32_TOL =
  1e-4 of max|want|; in bf16 against the reference run op by op the dense
  tests' limits (logits max|Δ|/max|want| <= 0.03, top-1 >= 0.9, caches
  0.03 per layer; against the jitted reference one of the two rows' top-1
  flips);
- decode against one prefill of the longer sequence (the port alone): the
  reference test's 0.15 and top-1 >= 0.5 (``tests/test_serve.py``); at
  the wrap, the rings within 1e-3 of max|want| in float32.
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
from repro.models import rglru as jlru
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import scaled_config
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as tlru
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

ARCH = "recurrentgemma-9b"
B, S, EXTRA = 2, 40, 8   # batch, prompt, teacher-forced decode steps
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


def _ulps_close(got: torch.Tensor, want, ulps):
    """max|Δ| within ``ulps`` float32 ulps of max|want|."""
    want = _f32(want)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ulps * np.spacing(np.abs(want).max()), err


def _lru_inputs(S_, seed, Bsz=2, W=16):
    """x (B, S, W), lam, w_r, b_r, w_i, b_i and h0 (B, W), float32 numpy:
    the model's ``lam``, fan-in gate matrices, biases of 0.3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S_, W)).astype(np.float32)
    lam = np.linspace(0.5, 4.0, W).astype(np.float32)
    w_r, w_i = ((rng.standard_normal((W, W)) / W ** 0.5).astype(np.float32)
                for _ in range(2))
    b_r, b_i = ((rng.standard_normal(W) * 0.3).astype(np.float32)
                for _ in range(2))
    h0 = rng.standard_normal((Bsz, W)).astype(np.float32)
    return x, lam, w_r, b_r, w_i, b_i, h0


# ---------------------------------------------------------- models/rglru

@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S_", [1, 2, 3, 7, 64, 1000])
def test_rglru_scan_matches_reference(S_, with_h0):
    """Odd and even lengths take the recursion's two branches at every
    level; 1,000 runs ten levels."""
    x, lam, w_r, b_r, w_i, b_i, h0 = _lru_inputs(S_, seed=S_)
    args = (x, lam, w_r, b_r, w_i, b_i)
    want_y, want_h = jax.jit(jlru.rglru_scan)(
        *map(jnp.asarray, args), h0=jnp.asarray(h0) if with_h0 else None)
    got_y, got_h = tlru.rglru_scan(
        *map(torch.from_numpy, args),
        h0=torch.from_numpy(h0) if with_h0 else None)
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    assert got_h.shape == (2, 16)
    _ulps_close(got_y, want_y, 4)
    _ulps_close(got_h, want_h, 4)


def test_rglru_scan_bf16_inputs_match_reference():
    """The model's dtypes: x and the gate matrices bf16, lam and biases
    float32; y comes back bf16, h float32."""
    x, lam, w_r, b_r, w_i, b_i, h0 = _lru_inputs(72, seed=9)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, w_r, w_i)]
    tb = [_t(a, torch.bfloat16) for a in jb]
    want_y, want_h = jax.jit(jlru.rglru_scan)(
        jb[0], jnp.asarray(lam), jb[1], jnp.asarray(b_r), jb[2],
        jnp.asarray(b_i), h0=jnp.asarray(h0))
    got_y, got_h = tlru.rglru_scan(
        tb[0], torch.from_numpy(lam), tb[1], torch.from_numpy(b_r), tb[2],
        torch.from_numpy(b_i), h0=torch.from_numpy(h0))
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    _close(got_y, want_y, jnp.bfloat16)
    _ulps_close(got_h, want_h, 4)


@pytest.mark.parametrize("S_", [7, 64])
def test_rglru_scan_matches_stepwise(S_):
    """The scan (from h0) against S ``rglru_step``s of the port, 1e-5;
    each step against the reference's step within 4 ulps."""
    x, lam, w_r, b_r, w_i, b_i, h0 = _lru_inputs(S_, seed=11)
    w = (lam, w_r, b_r, w_i, b_i)
    tw, jw = [torch.from_numpy(a) for a in w], [jnp.asarray(a) for a in w]
    y_scan, h_scan = tlru.rglru_scan(torch.from_numpy(x), *tw,
                                     h0=torch.from_numpy(h0))
    h, jh, ys = torch.from_numpy(h0), jnp.asarray(h0), []
    for t in range(S_):
        y, h = tlru.rglru_step(torch.from_numpy(x[:, t]), h, *tw)
        wy, jh = jlru.rglru_step(jnp.asarray(x[:, t]), jh, *jw)
        _ulps_close(y, wy, 4)
        _ulps_close(h, jh, 4)
        ys.append(y)
    _rel_close(y_scan, torch.stack(ys, 1).numpy(), 1e-5)
    _rel_close(h_scan, h.numpy(), 1e-5)


@pytest.mark.parametrize("S_", [5, 16, 40, 32], ids=["short", "full",
                                                       "wrapped", "roll0"])
def test_ring_init_matches_reference(S_):
    """Window 16: S < W pads with zeros, S = W and S = 2W lay the last W
    positions out unrolled, S = 40 rolls by 8; position p at slot p mod W."""
    W = 16
    k = np.random.default_rng(S_).standard_normal((2, S_, 1, 4)).astype(
        np.float32)
    want = np.asarray(jmodel_lib._ring_init(jnp.asarray(k), W))
    got = tmodel._ring_init(torch.from_numpy(k), W).numpy()
    assert np.array_equal(got, want)
    for p in range(max(0, S_ - W), S_):
        assert np.array_equal(got[:, p % W], k[:, p])


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module")
def lm():
    """The reference's parameters (norm weights, conv and gate biases
    randomised) as its bf16 tree and the port's model from
    ``interop.lm_params``, float32 copies of both, and the reference's
    jitted float32 prefill.  ``remat`` (a backward-pass policy, the
    identity forward) is off, so the op-by-op runs share compiled ops."""
    jcfg = jscaled(ARCH, "smoke").scaled(remat=False)
    tcfg = scaled_config(ARCH, "smoke").scaled(remat=False)
    params = _randomise(jax.tree.map(np.asarray, jax.jit(
        jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(41))), 42)
    rng = np.random.default_rng(43)

    def biases(tree):
        return {k: biases(v) if isinstance(v, dict) else (
            (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
            if k in ("conv_b", "b_r", "b_i") else v)
            for k, v in tree.items()}
    params = biases(params)
    model = interop.lm_params(params, tcfg, device="cpu")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tokens = np.random.default_rng(44).integers(
        0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    jm = jbuild(jcfg)
    ref_prefill = jax.jit(jm.prefill, static_argnums=2)(
        params32, {"tokens": jnp.asarray(tokens[:, :S])}, S + EXTRA)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, params32=params32,
                tokens=tokens, jm=jm, ref_prefill=ref_prefill, model=model,
                model32=copy.deepcopy(model).float())


def test_hybrid_params_carry_over(lm):
    """The reference's names, shapes and dtypes, leaf for leaf: one group
    (b0_rec, b1_rec, b2_attn) and a 2-layer tail."""
    m, p = lm["model"], lm["params"]
    assert len(m.groups) == 1 and len(m.tail) == 2
    assert isinstance(m.groups[0].b2_attn, tmodel.DenseBlock)
    assert not hasattr(m, "layers")
    for blk, tree in ((m.groups[0].b1_rec, jax.tree.map(
            lambda a: a[0], p["groups"]["b1_rec"])),
            (m.tail[1], jax.tree.map(lambda a: a[1], p["tail"]))):
        assert isinstance(blk, tmodel.RecBlock)
        for name in ("w_x", "w_gate", "conv_w", "w_r", "w_i", "w_out"):
            t = getattr(blk, name)
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.float().numpy(), _f32(tree[name]))
        for name in ("conv_b", "lam", "b_r", "b_i"):
            t = getattr(blk, name)
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), tree[name])
        assert np.array_equal(blk.mlp.w_down.float().numpy(),
                              _f32(tree["mlp"]["w_down"]))
    wq = m.groups[0].b2_attn.attn.wq
    assert np.array_equal(wq.float().numpy(),
                          _f32(p["groups"]["b2_attn"]["attn"]["wq"][0]))


def test_lm_params_refuses_partial_hybrid_trees(lm):
    """A leaf missing, a group or tail count other than the config's, a
    tail the config has none of: ``ValueError`` each."""
    p, cfg = lm["params"], lm["tcfg"]
    tail = {k: v for k, v in p["tail"].items() if k != "lam"}
    with pytest.raises(ValueError, match=r"not in the tree: tail\.0\.lam"):
        interop.lm_params(dict(p, tail=tail), cfg, device="cpu")
    # 8 layers: two groups and a tail of two; the tree holds one group
    with pytest.raises(ValueError, match="1 groups stacked, the config "
                                         "has 2"):
        interop.lm_params(p, cfg.scaled(n_layers=8), device="cpu")
    # 4 layers: one group and a tail of one; the tree's tail holds two
    with pytest.raises(ValueError, match="2 layers stacked, the config "
                                         "has 1"):
        interop.lm_params(p, cfg.scaled(n_layers=4), device="cpu")
    # 3 layers: one group, no tail
    with pytest.raises(ValueError, match="tail.*in the tree, not in the "
                                         "model"):
        interop.lm_params(p, cfg.scaled(n_layers=3), device="cpu")
    groups = dict(p["groups"], b1_rec={k: v for k, v in
                                       p["groups"]["b1_rec"].items()
                                       if k != "mlp"})
    with pytest.raises(ValueError, match=r"groups\.0\.b1_rec\.mlp\."):
        interop.lm_params(dict(p, groups=groups), cfg, device="cpu")


def test_fresh_model_constants_match_reference():
    """``Model(cfg)`` holds the reference's RG-LRU constant at
    RecurrentGemma-9B's width, ``lam = linspace(0.5, 4.0, 4,096)``, within
    one float32 ulp (XLA folds linspace's division into a reciprocal
    product and fuses its multiply-adds, which rounds about a third of the
    values the other way), the ends exactly; conv and gate biases and
    norms zero."""
    cfg = scaled_config(ARCH, "full").scaled(n_layers=1, vocab=64,
                                             d_model=64, d_ff=64)
    want = np.asarray(jax.jit(lambda k: jinit(cfg, k)["tail"]["lam"][0])(
        jax.random.PRNGKey(0)))
    blk = tmodel.Model(cfg, "cpu").tail[0]
    got = blk.lam.numpy()
    assert got.dtype == np.float32 and got.shape == (4096,)
    assert np.all(np.abs(got - want) <= np.spacing(want))
    assert got[0] == want[0] == 0.5 and got[-1] == want[-1] == 4.0
    assert np.all(np.diff(got) > 0)
    for t in (blk.conv_b, blk.b_r, blk.b_i, blk.norm.w, blk.ln2.w):
        assert t.dtype == torch.float32 and not t.any()


def test_init_follows_the_reference_distributions(lm):
    """``init_params`` draws each matrix with the reference's distribution
    (the streams differ: one is jax.random, one a torch.Generator), at the
    smoke preset: fan-in matrices (at least 65,536 draws) with standard
    deviations within 3% of the reference's and cut at two of theirs;
    ``conv_w`` (1,024 draws) an uncut normal with a standard deviation
    within 7% (3 sigma) of 0.5 in both; the constants untouched by the
    draws."""
    cfg = lm["tcfg"]
    want = jax.tree.map(np.asarray, jax.jit(jinit, static_argnums=0)(
        lm["jcfg"], jax.random.PRNGKey(1)))
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    fresh = tmodel.Model(cfg, "cpu")
    D, Wd = cfg.d_model, cfg.lru_width
    for blk, tree in ((model.groups[0].b0_rec, _at(
            want["groups"]["b0_rec"], 0)), (model.tail[1], _at(
            want["tail"], 1))):
        for name, fan_in in (("w_x", D), ("w_gate", D), ("w_r", Wd),
                             ("w_i", Wd), ("w_out", Wd), ("conv_w", None)):
            got = getattr(blk, name).float().numpy()
            w = _f32(tree[name])
            if not fan_in:     # 1,024 draws: both within 3 sigma of 0.5
                for sd in (got.std(), w.std()):
                    assert sd == pytest.approx(0.5, rel=0.07)
                assert np.abs(got).max() > 1.0 and np.abs(w).max() > 1.0
                continue
            assert got.std() == pytest.approx(float(w.std()), rel=0.03), name
            assert np.abs(got).max() <= 2 / fan_in ** 0.5 * (1 + 2 ** -8)
    wq = model.groups[0].b2_attn.attn.wq.float().numpy()
    assert wq.std() == pytest.approx(
        float(_f32(want["groups"]["b2_attn"]["attn"]["wq"]).std()), rel=0.03)
    for t in range(2):
        assert torch.equal(model.tail[t].lam, fresh.tail[t].lam)


def _at(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _one(tree, a, b):
    return jax.tree.map(lambda x: x[a:b], tree)


def test_rec_block_matches_reference_bf16(lm):
    """One bf16 recurrent block (the group's second) on the reference's
    inputs, the reference run op by op: over a prompt of random
    activations (output; final h and conv tail from the reference's
    ``rec_with_state``, run as the one block of a (rec,) pattern whose
    embedding table holds those activations), then one decode step from
    that state (its ``rec_step``): output, new h, new conv tail."""
    jcfg, m, p = lm["jcfg"], lm["model"], lm["params"]
    cfg, blk = m.cfg, m.groups[0].b1_rec
    x = jnp.asarray(np.random.default_rng(48).standard_normal(
        (B, S + 1, cfg.d_model)), jnp.bfloat16)
    one = {"embed": x.reshape(-1, cfg.d_model), "lm_head": p["lm_head"],
           "final_norm": p["final_norm"],
           "groups": {"b0_rec": _one(p["groups"]["b1_rec"], 0, 1)}}
    toks = jnp.arange(B * (S + 1)).reshape(B, S + 1)[:, :S]
    jrec = jbuild(jcfg.scaled(block_pattern=("rec",), n_layers=1))
    with jax.disable_jit():
        want = jmodel_lib._rec_block_seq(_at(p["groups"]["b1_rec"], 0),
                                         x[:, :S], jcfg)
        _, wcache = jrec.prefill(one, {"tokens": toks}, S)
        want_x, new = jrec._hybrid_decode(one, x[:, S:], wcache,
                                          wcache["len"])
    got, (h, tail) = tmodel._rec_block_seq(blk, _t(x[:, :S], torch.bfloat16),
                                           cfg)
    _close(got, want, jnp.bfloat16)
    assert h.dtype == torch.float32 and tail.dtype == torch.bfloat16
    wh, wtail = wcache["groups"]["b0"]
    _rel_close(h, wh[0], 1e-5)
    _close(tail, wtail[0], jnp.bfloat16)
    got_x = tmodel._rec_block_step(blk, _t(x[:, S:], torch.bfloat16), h,
                                   tail, cfg)
    _close(got_x, want_x, jnp.bfloat16)
    _rel_close(h, new["groups"]["b0"][0][0], 1e-5)
    _close(tail, new["groups"]["b0"][1][0], jnp.bfloat16)


def _caches_close(got, want, tol):
    """Every layer's h (float32), conv tail and k and v rings within
    ``tol`` of that layer's max|want|; ``len`` a host int equal to the
    reference's."""
    assert isinstance(got["len"], int) and got["len"] == int(want["len"])
    assert set(got) == set(want) and set(got["groups"]) == set(
        want["groups"])
    pairs = [(got["tail"], want["tail"])] + [
        (got["groups"][k], want["groups"][k]) for k in want["groups"]]
    for gpair, wpair in pairs:
        for g, w in zip(gpair, wpair):
            g, w = g.float().numpy(), _f32(w)
            assert g.shape == w.shape
            for layer in range(w.shape[0]):
                scale = max(np.abs(w[layer]).max(), 1e-30)
                assert np.abs(g[layer] - w[layer]).max() <= tol * scale


def test_prefill_matches_reference(lm):
    """Float32 end to end: last-position logits and the whole cache; the
    backbone alone (the groups, then the tail) over the whole prompt."""
    want_logits, want_cache = lm["ref_prefill"]
    toks = lm["tokens"][:, :S]
    got_logits, got_cache = lm["model32"].prefill(
        {"tokens": torch.from_numpy(toks)}, S + EXTRA)
    assert got_cache["groups"]["b0"][0].dtype == torch.float32
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _rel_close(got_logits, want_logits, F32_TOL)
    _caches_close(got_cache, want_cache, F32_TOL)
    p32, jcfg, m = lm["params32"], lm["jcfg"], lm["model32"]
    x = np.asarray(p32["embed"])[toks]
    want, _, _ = jax.jit(lambda x: jmodel_lib._backbone_seq(
        p32, jcfg, x, jnp.arange(S)))(x)
    got, kvs, aux = tmodel._backbone_seq(m, m.cfg, torch.from_numpy(x),
                                         torch.arange(S))
    assert kvs is None and float(aux) == 0.0
    _rel_close(got, want, F32_TOL)


def test_teacher_forced_decode_matches_reference(lm):
    """Eight float32 ``decode_step``s after a prefill, each fed the
    reference's next prompt token, against the reference's steps; the
    caches after the last one, written in place."""
    jstep = jax.jit(lm["jm"].decode_step)
    toks, m = lm["tokens"], lm["model32"]
    jcache = lm["ref_prefill"][1]
    _, tcache = m.prefill({"tokens": torch.from_numpy(toks[:, :S])},
                          S + EXTRA)
    ring, h = tcache["groups"]["b2"][0], tcache["tail"][0]
    for i in range(EXTRA):
        nxt = toks[:, S + i: S + i + 1]
        want, jcache = jstep(lm["params32"], jnp.asarray(nxt), jcache)
        got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
        _logits_close(got, want, lm["jcfg"].vocab)
        _rel_close(got, want, F32_TOL)
    assert tcache["groups"]["b2"][0] is ring and tcache["tail"][0] is h
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
        assert tcache["tail"][1].dtype == torch.bfloat16
        _logits_close(got, want, lm["jcfg"].vocab)
        _caches_close(tcache, jcache, LM_TOL)
        for i in range(EXTRA):
            nxt = toks[:, S + i: S + i + 1]
            want, jcache = jm.decode_step(p, jnp.asarray(nxt), jcache)
            got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
            _logits_close(got, want, lm["jcfg"].vocab)
    _caches_close(tcache, jcache, LM_TOL)


def test_decode_from_the_reference_cache(lm):
    """``interop.lm_cache`` carries the reference's hybrid cache over (told
    from KV and SSM caches by its keys): one float32 step from it equals
    the reference's step; the reference's zero cache (one array as both k
    and v) crosses as two tensors in the port's dtypes and shapes."""
    toks = lm["tokens"]
    jcache = lm["ref_prefill"][1]
    cache = interop.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert set(cache) == {"groups", "tail", "len"} and cache["len"] == S
    nxt = toks[:, S: S + 1]
    want, jnew = jax.jit(lm["jm"].decode_step)(lm["params32"],
                                               jnp.asarray(nxt), jcache)
    got, cache = lm["model32"].decode_step(torch.from_numpy(nxt), cache)
    _rel_close(got, want, F32_TOL)
    _caches_close(cache, jnew, F32_TOL)
    zero = lm["jm"].init_cache(B, S)
    bf = interop.lm_cache(jax.tree.map(np.asarray, zero), device="cpu")
    ours = lm["model"].init_cache(B, S)
    k, v = bf["groups"]["b2"]
    assert k is not v and k.data_ptr() != v.data_ptr()
    for key in ("b0", "b1", "b2"):
        for a, b in zip(bf["groups"][key], ours["groups"][key]):
            assert a.dtype == b.dtype and a.shape == b.shape
    for a, b in zip(bf["tail"], ours["tail"]):
        assert a.dtype == b.dtype and a.shape == b.shape


# ---------------------------------------------------------- the ring wrap

@pytest.fixture(scope="module")
def wrap(lm):
    """Window 16, a 40-token prompt (40 mod 16 = 8: the ring rolls) and 12
    steps that cross positions 48 and beyond, on ``lm``'s float32
    parameters (the window changes no shape)."""
    jcfg = lm["jcfg"].scaled(window=16, loss_chunk=64, attn_chunk=64)
    tcfg = lm["tcfg"].scaled(window=16, loss_chunk=64, attn_chunk=64)
    model = copy.deepcopy(lm["model32"])
    model.cfg = tcfg
    tokens = np.random.default_rng(47).integers(
        0, jcfg.vocab, (B, 52)).astype(np.int32)
    return jcfg, lm["params32"], model, tokens


def test_wrap_decode_matches_reference(wrap):
    """Prefill of 40 and 12 float32 steps against the reference's, logits
    each step and the whole cache (rings included) after the last."""
    jcfg, params32, model, toks = wrap
    jm = jbuild(jcfg)
    want, jcache = jax.jit(jm.prefill, static_argnums=2)(
        params32, {"tokens": jnp.asarray(toks[:, :40])}, 52)
    got, tcache = model.prefill({"tokens": torch.from_numpy(toks[:, :40])},
                                52)
    _rel_close(got, want, F32_TOL)
    _caches_close(tcache, jcache, F32_TOL)
    jstep = jax.jit(jm.decode_step)
    for i in range(12):
        nxt = toks[:, 40 + i: 41 + i]
        want, jcache = jstep(params32, jnp.asarray(nxt), jcache)
        got, tcache = model.decode_step(torch.from_numpy(nxt), tcache)
        _rel_close(got, want, F32_TOL)
    assert tcache["len"] == 52
    _caches_close(tcache, jcache, F32_TOL)


def test_wrap_decode_matches_prefill(wrap):
    """The reference's ring-wrap test on the port at S mod W != 0: prefill
    40, 12 teacher-forced steps against one prefill of 52 (whose ring holds
    positions 36..51), at the reference test's limits; the ring after the
    steps equals that prefill's up to rounding, slot for slot."""
    _, _, model, toks = wrap
    full = torch.from_numpy(toks)
    want, wcache = model.prefill({"tokens": full}, 52)
    logits, cache = model.prefill({"tokens": full[:, :40]}, 52)
    for i in range(12):
        logits, cache = model.decode_step(full[:, 40 + i: 41 + i], cache)
    got, want = logits.numpy(), want.numpy()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.5
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1.0) < 0.15
    for g, w in zip(cache["groups"]["b2"], wcache["groups"]["b2"]):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


# --------------------------------------------- the port's own serving path

def test_decode_matches_prefill():
    """As the reference's ``test_decode_matches_prefill`` for the hybrid (a
    64-token prompt and 8 teacher-forced steps against one prefill of 72),
    on the port, 0 host syncs a step."""
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
