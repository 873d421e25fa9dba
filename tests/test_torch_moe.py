"""The MoE serving path of the port vs the JAX package (CPU).

Both packages get the same numpy inputs.  ``moe_ffn`` alone runs at small
shapes (T = 128 tokens, D = 64, E = 8 experts top-2, F = 96); the model
runs at the SMOKE preset (``launch/train.py``: 4 layers, d_model 256, 8
experts top-2, expert d_ff 256, vocab 2,048), ``qwen2-moe-a2.7b`` with 4
shared experts and ``grok-1-314b`` without, on the reference's parameters
carried over by ``interop.lm_params`` with their norm weights and QKV
biases first set to seeded random values.

Tolerances, and why:
- routing: expert ids, ranks within each expert, the keep mask and the
  buffer slots equal exactly, wherever the reference's k-th/(k+1)-th
  probability margin is at least ``MARGIN`` = 1e-6 (float32 tolerance on
  probabilities: the two frameworks' router products sum in other
  orders).  A token under that margin is reported and exempt, and so are
  the later pairs of the experts it chose in either framework (their
  ranks shift with it).  On exactly representable inputs (the tie cases)
  nothing is exempt: equal probabilities must go to the lower expert;
- ``moe_ffn`` outputs: within 1e-5·max|want| at float32 (exp and the
  products' summation order differ in the last ulps), one bf16 ulp of
  max|want| at bf16 (an expert product can round the other way); aux
  within 1e-6 absolute;
- the model: PR 25's limits (``tests/test_torch_lm.py``): logits
  max|Δ|/max|want| <= 0.03 and top-1 >= 0.9, caches max|Δ|/max|want|
  <= 0.03 per layer, after prefill and after eight teacher-forced decode
  steps; the backbone's summed aux within 1e-3 relative (bf16 activations
  move the router's float32 probabilities by ~1e-4 of themselves);
- decode against one prefill of the longer sequence (the port alone):
  the reference test's 0.15 and top-1 >= 0.5 at capacity factor 64
  (``tests/test_serve.py``: two prefill lengths drop different pairs).
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import LOGIT_TOL, _f32, _logits_close, _randomise

from repro.launch.train import scaled_config as jscaled
from repro.models import model as jmodel_lib
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import scaled_config
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.obs import syncs
from repro_torch.train import make_decode_step, make_prefill

MARGIN = 1e-6           # probability margin under which a routing is exempt
MOE_ARCHS = ("qwen2-moe-a2.7b", "grok-1-314b")
B, S, EXTRA = 4, 48, 8  # batch, prompt, teacher-forced decode steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_routing(x, router, top_k, C):
    """The reference's routing, ranks and slots (``repro/models/moe.py``,
    the lines from the router product to ``slot``, unchanged) as numpy:
    ``moe_ffn`` returns only (y, aux)."""
    T = x.shape[0]
    E = router.shape[1]
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, top_k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    cnt = jax.ops.segment_sum(jnp.ones_like(flat_e, jnp.int32), flat_e,
                              num_segments=E)
    start = jnp.cumsum(cnt) - cnt
    rank_sorted = jnp.arange(T * top_k, dtype=jnp.int32) - start[flat_e[order]]
    rank = jnp.zeros((T * top_k,), jnp.int32).at[order].set(rank_sorted)
    keep = rank < C
    slot = jnp.where(keep, flat_e * C + rank, E * C)
    return {k: np.asarray(v) for k, v in dict(
        probs=probs, idx=idx, rank=rank, keep=keep, slot=slot).items()}


def _margins(probs, top_k):
    """Each token's k-th minus (k+1)-th largest probability."""
    s = -np.sort(-probs, axis=-1)
    return s[:, top_k - 1] - s[:, top_k]


def _exempt(want, got_idx, top_k):
    """(token mask, pair mask) exempt from exact equality: tokens under
    ``MARGIN``, and the later pairs of every expert such a token chose in
    either framework."""
    near = _margins(want["probs"], top_k) < MARGIN
    T = near.shape[0]
    token = np.arange(T * top_k) // top_k
    pair = np.repeat(near, top_k)
    for t in np.flatnonzero(near):
        hit = set(want["idx"][t]) | set(got_idx[t])
        pair |= np.isin(want["idx"].reshape(-1), list(hit)) & (token >= t)
    return near, pair


def _moe_inputs(dtype, seed=0, T=128, D=64, E=8, F=96, exact=False):
    """x (1, T, D), w_gate/w_up (E, D, F), w_down (E, F, D) in ``dtype``
    and a float32 router (D, E), as numpy float32.  ``exact``: small
    integers and eighths, so every product and sum is exact in float32 in
    both frameworks (ties stay ties)."""
    rng = np.random.default_rng(seed)
    if exact:
        x = rng.integers(-3, 4, (1, T, D)).astype(np.float32)
        router = rng.integers(-1, 2, (D, E)).astype(np.float32) / 8
    else:
        x = rng.standard_normal((1, T, D)).astype(np.float32)
        router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(
            np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    if dtype == jnp.bfloat16:       # values representable in both
        x, *ws = (np.array(_f32(jnp.asarray(a, jnp.bfloat16)))
                  for a in (x, *ws))
    return x, ws, router


def _run_both(x, ws, router, dtype, top_k, factor):
    """(reference y, aux, routing; port y, aux, routing) on the same
    inputs."""
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x, dtype),
                            *(jnp.asarray(w, dtype) for w in ws),
                            jnp.asarray(router), top_k=top_k,
                            capacity_factor=factor)
    tx = torch.from_numpy(x).to(tdt)
    tws = [torch.from_numpy(w).to(tdt) for w in ws]
    trouter = torch.from_numpy(router)
    ty, taux = tmoe.moe_ffn(tx, *tws, trouter, top_k=top_k,
                            capacity_factor=factor)
    T, E = x.shape[0] * x.shape[1], router.shape[1]
    C = tmoe.capacity(T, E, top_k, factor)
    want = _ref_routing(jnp.asarray(x.reshape(T, -1), dtype),
                        jnp.asarray(router), top_k, C)
    probs, gate, idx = tmoe.route(tx.reshape(T, -1), trouter, top_k)
    rank, keep, slot = tmoe.slots(idx, tmoe.expert_counts(idx, E), C)
    got = dict(probs=probs.numpy(), idx=idx.numpy(), rank=rank.numpy(),
               keep=keep.numpy(), slot=slot.numpy())
    return (jy, float(jaux), want), (ty, float(taux), got)


def _routing_equal(want, got, top_k, exempt=True):
    near, pair = (_exempt(want, got["idx"], top_k) if exempt else
                  (np.zeros(len(want["idx"]), bool),
                   np.zeros(want["slot"].shape, bool)))
    assert np.array_equal(got["idx"][~near], want["idx"][~near])
    for key in ("rank", "keep", "slot"):
        assert np.array_equal(got[key][~pair], want[key][~pair]), key
    return int(near.sum()), int(pair.sum())


# ----------------------------------------------------------------- moe_ffn

FACTORS = {"drops": 0.5, "no_drops": 8.0}


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_ffn_matches_reference(dtype, factor):
    x, ws, router = _moe_inputs(dtype)
    (jy, jaux, want), (ty, taux, got) = _run_both(
        x, ws, router, dtype, 2, FACTORS[factor])
    near, pairs = _routing_equal(want, got, 2)
    print(f"near-tie tokens {near}, exempt pairs {pairs}")
    dropped = int((~want["keep"]).sum())
    assert (dropped > 0) == (factor == "drops"), dropped
    jy = _f32(jy)
    scale = np.abs(jy).max()
    tol = 1e-5 * scale if dtype == jnp.float32 else 2.0 ** (
        np.floor(np.log2(scale)) - 7)
    assert ty.dtype == (torch.float32 if dtype == jnp.float32
                        else torch.bfloat16)
    assert np.abs(ty.float().numpy() - jy).max() <= tol
    assert abs(taux - jaux) <= 1e-6


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_ties_go_to_the_lower_expert(top_k):
    """Exactly representable inputs (ties in both frameworks), with
    router columns 2, 5 and 6 equal and dominant: the lower expert wins
    every tie, as ``jax.lax.top_k`` breaks them; ids, ranks and slots
    equal the reference's with nothing exempt, and the outputs agree."""
    x, ws, router = _moe_inputs(jnp.float32, seed=1, exact=True)
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    x[..., :8] = np.abs(x[..., :8])
    router[:8, [2, 5, 6]] = 1.0   # dominant: the tie is for the top slots
    (jy, jaux, want), (ty, taux, got) = _run_both(
        x, ws, router, jnp.float32, top_k, 1.25)
    assert (got["idx"][:, 0] == 2).mean() > 0.9
    if top_k == 2:
        assert (got["idx"][:, 1] == 5)[got["idx"][:, 0] == 2].all()
    _routing_equal(want, got, top_k, exempt=False)
    jy = _f32(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    assert abs(taux - jaux) <= 1e-6


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 8])
def test_decode_capacity_drops_nothing(batch, monkeypatch):
    """At S == 1 the model's MoE branch runs at capacity factor
    ``n_experts``: with every token sent to the same two experts, no pair
    is dropped and the output equals a run at any larger capacity."""
    cfg = scaled_config("grok-1-314b", "smoke")
    E, K = cfg.n_experts, cfg.experts_per_token
    assert tmoe.capacity(batch, E, K, float(E)) >= batch * K
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = model.layers[0]
    lp.moe.router[:, :2] += 10.0                 # all tokens -> experts 0, 1
    x = torch.randn(batch, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).abs()
    seen = []
    inner = tmoe.moe_ffn
    monkeypatch.setattr(tmoe, "moe_ffn",
                        lambda *a, **kw: seen.append(kw["capacity_factor"])
                        or inner(*a, **kw))
    y, aux = tmodel._ffn_seq(lp, x.to(torch.bfloat16), cfg)
    assert seen == [float(E)]
    xt = x.to(torch.bfloat16).reshape(batch, -1)
    _, _, idx = tmoe.route(xt, lp.moe.router, K)
    assert (idx.sort(-1).values == torch.tensor([0, 1])).all()
    C = tmoe.capacity(batch, E, K, float(E))
    _, keep, _ = tmoe.slots(idx, tmoe.expert_counts(idx, E), C)
    assert keep.all()
    want, _ = inner(x.to(torch.bfloat16), lp.moe.we_gate, lp.moe.we_up,
                    lp.moe.we_down, lp.moe.router, top_k=K,
                    capacity_factor=64.0)
    scale = float(want.float().abs().max())
    assert float((y.float() - want.float()).abs().max()) <= 2.0 ** (
        np.floor(np.log2(scale)) - 7)


# ----------------------------------------------------------------- model

def _cfgs(arch):
    return (jscaled(arch, "smoke").scaled(attn_chunk=16),
            scaled_config(arch, "smoke").scaled(attn_chunk=16))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def lm(request):
    """The reference's parameters (norm weights and QKV biases randomised)
    as its bf16 tree and the port's model from ``interop.lm_params``, plus
    float32 copies of both for the end-to-end comparison."""
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(21)))
    params = _randomise(params, 22)
    model = interop.lm_params(params, tcfg, device="cpu")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tokens = np.random.default_rng(23).integers(
        0, jcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    jm = jbuild(jcfg)
    ref_prefill = jax.jit(jm.prefill, static_argnums=2)(
        params32, {"tokens": jnp.asarray(tokens[:, :S])}, S + EXTRA)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, params=params,
                params32=params32, tokens=tokens, jm=jm,
                ref_prefill=ref_prefill, model=model,
                model32=copy.deepcopy(model).float())


def test_moe_params_carry_over(lm):
    """The reference's names, shapes and dtypes: router float32, experts
    and shared experts bf16, loaded leaf for leaf."""
    m, p, cfg = lm["model"], lm["params"], lm["tcfg"]
    moe, pm = m.layers[1].moe, p["layers"]["moe"]
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert moe.router.dtype == torch.float32 and moe.router.shape == (D, E)
    assert moe.we_down.dtype == torch.bfloat16 and \
        moe.we_down.shape == (E, Fe, D)
    assert np.array_equal(moe.router.numpy(), pm["router"][1])
    assert np.array_equal(moe.we_up.float().numpy(), _f32(pm["we_up"][1]))
    if cfg.n_shared_experts:
        assert moe.shared.w_gate.shape == (D, cfg.n_shared_experts * Fe)
        assert np.array_equal(moe.shared.w_down.float().numpy(),
                              _f32(pm["shared"]["w_down"][1]))
    else:
        assert moe.shared is None and "shared" not in pm
    assert not hasattr(m.layers[0], "mlp")


def _ulp_close(got: torch.Tensor, want):
    """Within one bf16 ulp of max|want|."""
    want = _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_lm_params_loads_whole_trees_only(lm):
    """``interop.lm_params`` refuses a tree that does not cover the model
    leaf for leaf (it used to leave a missing leaf at zero and load the
    first ``n_layers`` of a deeper stack without a word)."""
    p, cfg = lm["params"], lm["tcfg"]
    moe = {k: v for k, v in p["layers"]["moe"].items() if k != "router"}
    short = dict(p, layers=dict(p["layers"], moe=moe))
    with pytest.raises(ValueError, match=r"not in the tree: layers\.0\.moe"
                                         r"\.router"):
        interop.lm_params(short, cfg, device="cpu")
    with pytest.raises(ValueError, match="4 layers stacked, the config "
                                         "has 2"):
        interop.lm_params(p, cfg.scaled(n_layers=2), device="cpu")
    extra = dict(p, layers=dict(p["layers"], moe=dict(
        p["layers"]["moe"], bias=p["layers"]["moe"]["router"])))
    with pytest.raises(ValueError, match="moe.bias: in the tree, not in "
                                         "the model"):
        interop.lm_params(extra, cfg, device="cpu")


def test_layers_match_reference_bf16(lm):
    """Each bf16 layer's two sublayers on the reference's own inputs (its
    layers run in turn): attention and k, v within one bf16 ulp of
    max|want|; the FFN (MoE branch and shared experts) on the reference's
    normed input: routing, ranks, keep mask and slots equal outside
    ``MARGIN``, output within one bf16 ulp of max|want|, aux within
    1e-6.  (The attention's ulps reach the router's input, so a layer run
    whole could flip a near-tie: that is the end-to-end tests' case.)"""
    jcfg, m, K = lm["jcfg"], lm["model"], lm["jcfg"].experts_per_token
    x, _ = jmodel_lib._embed_inputs(lm["params"], jcfg, {
        "tokens": jnp.asarray(lm["tokens"][:, :S])})
    pos, tpos = jnp.arange(S), torch.arange(S)

    def bf16(a):
        return torch.from_numpy(np.array(_f32(a))).to(torch.bfloat16)
    for i, lp_t in enumerate(m.layers):
        lp = jax.tree.map(lambda a: a[i], lm["params"]["layers"])
        hn = jmodel_lib._apply_norm(lp["ln1"], x, jcfg)
        want, (wk, wv) = jmodel_lib._attn_seq(lp["attn"], hn, jcfg, pos)
        got, (gk, gv) = tmodel._attn_seq(lp_t.attn, bf16(hn), m.cfg, tpos)
        for g, w in ((got, want), (gk, wk), (gv, wv)):
            _ulp_close(g, w)
        fn = jmodel_lib._apply_norm(lp["ln2"], x + want, jcfg)
        want, waux = jmodel_lib._ffn_seq(lp, fn, jcfg)
        got, gaux = tmodel._ffn_seq(lp_t, bf16(fn), m.cfg)
        _ulp_close(got, want)
        assert abs(float(gaux) - float(waux)) <= 1e-6
        flat = fn.reshape(B * S, -1)
        C = tmoe.capacity(B * S, jcfg.n_experts, K, jcfg.moe_capacity_factor)
        _, _, idx = tmoe.route(bf16(flat), lp_t.moe.router, K)
        rank, keep, slot = tmoe.slots(
            idx, tmoe.expert_counts(idx, jcfg.n_experts), C)
        ref = _ref_routing(flat, lp["moe"]["router"], K, C)
        near, pairs = _routing_equal(ref, dict(
            idx=idx.numpy(), rank=rank.numpy(), keep=keep.numpy(),
            slot=slot.numpy()), K)
        print(f"layer {i}: near-tie tokens {near}, exempt pairs {pairs}, "
              f"dropped {int((~ref['keep']).sum())}")
        x, _, _ = jmodel_lib._dense_block_seq(lp, x, jcfg, pos)


def _cache_close(got, want):
    """PR 25's cache limit per layer (``tests/test_torch_lm.py``), here on
    float32 caches."""
    assert got["len"] == int(want["len"])
    for key in ("k", "v"):
        g, w = got[key].numpy(), _f32(want[key])
        assert g.shape == w.shape
        for layer in range(w.shape[0]):
            scale = np.abs(w[layer]).max()
            assert np.abs(g[layer] - w[layer]).max() <= LOGIT_TOL * scale


def test_prefill_matches_reference(lm):
    """End to end in float32 (both packages' parameters upcast): bf16
    activations would move router near-ties, and a flipped token moves
    the caches of later layers by 0.2-0.6 of their max (measured; the
    jitted reference flips against its own eager run, as XLA keeps the
    residual sum in float32 before the norm).  PR 25's limits, and the
    float32 one: 1e-4·max|want|."""
    want_logits, want_cache = lm["ref_prefill"]
    got_logits, got_cache = lm["model32"].prefill(
        {"tokens": torch.from_numpy(lm["tokens"][:, :S])}, S + EXTRA)
    _logits_close(got_logits, want_logits, lm["jcfg"].vocab)
    _cache_close(got_cache, want_cache)
    for g, w in ((got_logits, want_logits), (got_cache["k"], want_cache["k"]),
                 (got_cache["v"], want_cache["v"])):
        w = _f32(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_teacher_forced_decode_matches_reference(lm):
    """Eight float32 ``decode_step``s (capacity factor ``n_experts``)
    after a prefill, each fed the reference's next prompt token."""
    jstep = jax.jit(lm["jm"].decode_step)
    toks, m = lm["tokens"], lm["model32"]
    jcache = lm["ref_prefill"][1]
    _, tcache = m.prefill({"tokens": torch.from_numpy(toks[:, :S])},
                          S + EXTRA)
    for i in range(EXTRA):
        nxt = toks[:, S + i: S + i + 1]
        want, jcache = jstep(lm["params32"], jnp.asarray(nxt), jcache)
        got, tcache = m.decode_step(torch.from_numpy(nxt), tcache)
        _logits_close(got, want, lm["jcfg"].vocab)
        assert np.abs(got.numpy() - _f32(want)).max() <= 1e-4 * np.abs(
            _f32(want)).max()
    _cache_close(tcache, jcache)


def test_backbone_aux_matches_reference(lm):
    """The layers' aux losses summed by ``_backbone_seq`` (float32 end to
    end), within 1e-5 of the sum."""
    jcfg, toks = lm["jcfg"], lm["tokens"][:, :S]
    x, _ = jmodel_lib._embed_inputs(lm["params32"], jcfg,
                                    {"tokens": jnp.asarray(toks)})
    _, _, want = jax.jit(lambda p, x: jmodel_lib._backbone_seq(
        p, jcfg, x, jnp.arange(S)))(lm["params32"], x)
    m = lm["model32"]
    tx, _ = tmodel._embed_inputs(m, m.cfg, {"tokens": torch.from_numpy(toks)})
    _, kv, got = tmodel._backbone_seq(m, m.cfg, tx, torch.arange(S))
    assert kv is None and got.dtype == torch.float32 and got.shape == ()
    assert float(want) > 0
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


# --------------------------------------------- the port's own serving path

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch):
    """As the reference's ``test_decode_matches_prefill`` for the MoE
    family (capacity factor 64), on the port, 0 host syncs a step."""
    cfg = scaled_config(arch, "smoke").scaled(
        loss_chunk=64, attn_chunk=64, moe_capacity_factor=64.0)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generation_deterministic(arch):
    cfg = scaled_config(arch, "smoke").scaled(attn_chunk=64)
    t1, s1 = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    t2, _ = tserve.serve(cfg, batch=2, prompt_len=32, gen=8, device="cpu")
    assert torch.equal(t1, t2) and t1.shape == (2, 8)
    assert int(t1.max()) < cfg.vocab and s1["decode_host_syncs"] == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--preset", "smoke", "--batch", "2",
                 "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4)" in out and "tok_per_s" in out
