"""The training half of the port (``lm_loss``, ``Model.loss`` with remat,
``adamw``/``adafactor``, ``make_train_step``) vs the JAX package (CPU).

Both packages get the same numpy inputs: the reference's parameters
(``repro.models.model.init_params``) with its zero-initialised norm
weights and biases set to seeded random values, carried over by
``interop.lm_params``; gradient leaves are compared against the reference
leaf's slice ``[i]`` (``optimizer.stack_name``).  Sizes: the SMOKE preset
(``launch/train.py``) cut to 2 layers (hybrid: one group of 3; Whisper: 2
encoder and 2 decoder layers), ``loss_chunk = attn_chunk = 64``, the SSD
chunk 32 (two chunks), batch 2 × 64 tokens (the VLM's 16 patches before
them, Whisper's 64 frames).  Float32 runs upcast both packages'
parameters, the reference with its ``PDT`` set to float32 (as the serving
tests do).

Tolerances, and why:
- ``lm_loss``: float32 loss within 1e-6 relative, the grads of the hidden
  states and ``lm_head`` within 1e-5 of max|want| (another order of the
  float32 sums); bf16 loss within 1e-5 relative (the bf16 products are
  exact in float32, only the sums' order differs) and grads within one
  bf16 ulp of max|want| (each rounds one float32 product);
- ``Model.loss`` in float32, all six families: loss within 1e-5
  relative, every grad leaf within 1e-4 of max|want| (measured <= 1.4e-5:
  float32 noise amplified through the layers, most by the SSD scan);
- in bf16 the jitted reference keeps excess precision where the port (and
  the reference run op by op) rounds, and two bf16 runs drift apart by a
  few percent of a leaf, more where a router near-tie sends a token to
  another expert.  So both are held against the truth, the reference in
  float32 on the same (bf16-valued) parameters: the port's loss and each
  of its grad leaves must lie within ``BF16_FACTOR`` = 3 times the bf16
  reference's own distance to it, or one bf16 ulp (2^-8) of max|truth|
  (measured: at most 2.3 times; autograd's derivative of softplus at 0,
  1 where the reference's is 1/2, read 5.8 times and failed here);
- remat off, ``full`` and ``dots``: the same float32 loss and grads,
  within 1e-6 of max|want| (recomputation reruns the same kernels);
- optimizers, one and five steps from the same injected grads: float32
  state and parameters within 1e-6 of max|want| (the same float32
  operations, another order of the means' sums), bf16 parameters within
  one bf16 ulp of |before| + |want| a step (a float32 result near a
  rounding boundary may round the other way, and a weight that then
  shrinks toward 0 keeps that difference; measured: 2 ulps after 5
  steps);
- ``make_train_step``: the clipped grads equal the step's own grads times
  the clip scale rounded to their dtype, bit for bit; in float32, against
  the reference's ``make_train_step``, loss, grad norm and clipped grads
  as ``Model.loss``'s limits, and the parameters after one AdamW step
  within 1e-6 of max|want| plus lr times how far the step's g/(|g| + eps)
  can move over the grads' tolerance (it is ±1 but for grads near eps; 2
  where the sign is not determined); in bf16, against the reference's
  arithmetic on its bf16 ``value_and_grad``, loss and grad norm within
  1e-2 relative and the clipped grads within 0.03 of max|want| (the
  serving tests' logit limit; measured ~0.012).
"""
from __future__ import annotations

import contextlib
import copy
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch.train import scaled_config as jscaled
from repro.models import model as jmodel_lib
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.launch.train import scaled_config
from repro_torch.models import build_model
from repro_torch.models import model as tmodel
from repro_torch.models.model import Model
from repro_torch.train import adafactor, adamw, make_optimizer, \
    make_train_step
from repro_torch.train import optimizer as topt

ARCHS = {"dense": "qwen1.5-4b", "moe": "qwen2-moe-a2.7b",
         "ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-9b",
         "audio": "whisper-base", "vlm": "internvl2-2b"}
B, S = 2, 64
F32_LOSS, F32_GRAD = 1e-5, 1e-4
BF16_FACTOR, BF16_ULP = 3.0, 2.0 ** -8
REMAT_TOL = 1e-6
OPT_TOL = 1e-6
TRAIN_BF16, TRAIN_BF16_GRAD = 1e-2, 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _ref_pdt(dtype):
    """The reference's ``PDT`` (the dtype it casts frames, patches and the
    sinusoidal table to) set to ``dtype`` inside the block."""
    pdt, jmodel_lib.PDT = jmodel_lib.PDT, dtype
    try:
        yield
    finally:
        jmodel_lib.PDT = pdt


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cfgs(arch, **kw):
    layers = 3 if arch == "recurrentgemma-9b" else 2
    kw = dict(dict(n_layers=layers, loss_chunk=64, attn_chunk=64), **kw)
    if arch == "mamba2-2.7b":
        kw["ssd_chunk"] = 32
    return jscaled(arch, "smoke").scaled(**kw), \
        scaled_config(arch, "smoke").scaled(**kw)


def _randomise(p, seed):
    """The reference's zero-initialised norm weights and biases set to
    seeded random values (a new tree)."""
    rng = np.random.default_rng(seed)
    scale_of = {"bq": 0.5, "bk": 0.5, "bv": 0.5, "w": 0.3, "b": 0.3,
                "b_in": 0.3, "b_out": 0.3, "conv_b": 0.3, "b_r": 0.3,
                "b_i": 0.3}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * scale_of[k]).astype(v.dtype)
                if k in scale_of else v for k, v in tree.items()}
    return walk(p)


def _ref_leaf(tree, name):
    """The reference leaf (or its slice) a port parameter ``name`` holds."""
    key, i = topt.stack_name(name)
    a = tree
    for k in key.split("."):
        a = a[k]
    return a if i is None else a[i]


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return b


def _port_grads(model: Model, batch):
    """(loss, {name: grad}) of ``model.loss`` on a numpy batch."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    return float(loss), dict(zip(named, grads))


def _family_inputs(family):
    """(reference config, port config, the reference's parameters with
    random norms and biases, a batch) of one family."""
    jcfg, tcfg = _cfgs(ARCHS[family])
    params = _randomise(jax.tree.map(np.asarray, jinit(
        jcfg, jax.random.PRNGKey(7))), 8)
    return jcfg, tcfg, params, _batch(jcfg, 9)


@pytest.fixture(scope="module")
def refs():
    """The reference's jitted ``value_and_grad(Model.loss)`` of every
    family in float32 (parameters upcast, ``PDT`` float32: the truth) and
    in bf16: {family: {"f32"|"bf16": (loss, grads as float32 numpy)}}.
    The twelve programs are traced in turn and compiled and run four at a
    time (XLA compiles outside the GIL)."""
    jobs = []
    for family in ARCHS:
        jcfg, _, params, batch = _family_inputs(family)
        vg = jax.jit(jax.value_and_grad(jbuild(jcfg).loss))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for key, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            p = jax.tree.map(lambda a: np.asarray(a, np.float32), params) \
                if key == "f32" else params
            with _ref_pdt(dtype):
                jobs.append((family, key, vg.lower(p, jb), (p, jb)))

    def run(job):
        _, _, lowered, args = job
        loss, grads = lowered.compile()(*args)
        return float(loss), jax.tree.map(_f32, grads)
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(run, jobs))
    res = {f: {} for f in ARCHS}
    for (family, key, _, _), out in zip(jobs, outs):
        res[family][key] = out
    return res


@pytest.fixture(scope="module", params=list(ARCHS))
def fam(request, refs):
    """One family: the reference's loss and grads in float32 (the truth)
    and in bf16, the port's in float32 and in bf16, on the same
    parameters and batch."""
    _, tcfg, params, batch = _family_inputs(request.param)
    model = interop.lm_params(params, tcfg, device="cpu")
    model32 = copy.deepcopy(model).float()
    return dict(
        tcfg=tcfg, dtypes={n: p.dtype for n, p in model.named_parameters()},
        truth=refs[request.param]["f32"], ref=refs[request.param]["bf16"],
        f32=_port_grads(model32, batch), bf16=_port_grads(model, batch))


# ------------------------------------------------------------- lm_loss

LOSS_CASES = {"mask": dict(vocab=1000, chunk=16, S=64, mask=True),
              "padded_vocab": dict(vocab=1000, pad=128, chunk=16, S=64),
              "one_chunk": dict(vocab=1000, chunk=24, S=64, mask=True)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_matches_reference(case, dtype):
    """The chunked cross entropy and its grads against the reference's: a
    mask, a padded vocabulary (columns at and past ``vocab`` read -1e30),
    and ``S % loss_chunk != 0`` (one chunk)."""
    c = LOSS_CASES[case]
    jcfg, tcfg = _cfgs("qwen1.5-4b", vocab=c["vocab"], loss_chunk=c["chunk"],
                       pad_vocab_multiple=c.get("pad", 0))
    rng = np.random.default_rng(21)
    D, Vp = jcfg.d_model, jcfg.vocab_padded
    h = jnp.asarray(rng.standard_normal((B, c["S"], D)), dtype)
    W = jnp.asarray(rng.standard_normal((D, Vp)) / 8, dtype)
    y = rng.integers(0, c["vocab"], (B, c["S"])).astype(np.int32)
    m = ((rng.random((B, c["S"])) < 0.7).astype(np.float32)
         if c.get("mask") else None)

    def ref(h, W):
        return jmodel_lib.lm_loss({"lm_head": W}, jcfg, h, jnp.asarray(y),
                                  None if m is None else jnp.asarray(m))
    want, (wh, wW) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1)))(h, W)
    th, tW = (torch.from_numpy(_f32(a)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        .requires_grad_(True) for a in (h, W))
    got = tmodel.lm_loss(types.SimpleNamespace(lm_head=tW), tcfg, th,
                         torch.from_numpy(y),
                         None if m is None else torch.from_numpy(m))
    gh, gW = torch.autograd.grad(got, [th, tW])
    assert got.dtype == torch.float32 and got.shape == ()
    f32 = dtype == jnp.float32
    assert abs(float(got) - float(want)) <= \
        (1e-6 if f32 else 1e-5) * abs(float(want))
    for g, w in ((gh, wh), (gW, wW)):
        assert g.dtype == th.dtype
        w = _f32(w)
        tol = (1e-5 if f32 else BF16_ULP) * np.abs(w).max()
        assert np.abs(g.float().numpy() - w).max() <= tol


def test_lm_loss_never_holds_the_whole_logits():
    """Forward and backward allocate no (B, S, V) tensor: no op makes a
    tensor larger than ``lm_head``, and one chunk's logits exist."""
    _, tcfg = _cfgs("qwen1.5-4b", vocab=512, loss_chunk=8)
    D, V = 64, tcfg.vocab
    th = torch.randn(B, S, D, requires_grad=True)
    tW = torch.randn(D, V, requires_grad=True)
    y = torch.randint(0, V, (B, S))
    biggest = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    biggest.append(t.numel())
            return out
    with Sizes():
        loss = tmodel.lm_loss(types.SimpleNamespace(lm_head=tW), tcfg, th, y)
        torch.autograd.grad(loss, [th, tW])
    # lm_head (and its grad) is the largest; one chunk's logits are B·8·V
    assert max(biggest) == D * V < B * S * V
    assert B * 8 * V in biggest


# ---------------------------------------------------------- Model.loss

def test_model_loss_and_grads_float32(fam):
    """Float32: the loss and every grad leaf against the reference's."""
    want_loss, want = fam["truth"]
    got_loss, got = fam["f32"]
    assert abs(got_loss - want_loss) <= F32_LOSS * abs(want_loss)
    names = {topt.stack_name(n)[0] for n in got}
    flat = {".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert names == flat
    for n, g in got.items():
        w = _ref_leaf(want, n)
        assert g.dtype == torch.float32 and g.shape == w.shape, n
        err = np.abs(g.numpy() - w).max()
        assert err <= F32_GRAD * np.abs(w).max(), (n, err)


def test_model_loss_and_grads_bf16(fam):
    """bf16: the port's loss and grads lie as close to the float32 truth as
    the bf16 reference's do (``BF16_FACTOR``), or within one bf16 ulp."""
    truth_loss, truth = fam["truth"]
    ref_loss, ref = fam["ref"]
    got_loss, got = fam["bf16"]
    assert abs(got_loss - truth_loss) <= max(
        BF16_FACTOR * abs(ref_loss - truth_loss), 1e-4 * abs(truth_loss))
    for n, g in got.items():
        t = _ref_leaf(truth, n)
        scale = np.abs(t).max()
        assert g.shape == t.shape and g.dtype == fam["dtypes"][n], n
        e_port = np.abs(g.float().numpy() - t).max() / scale
        e_ref = np.abs(_ref_leaf(ref, n) - t).max() / scale
        assert e_port <= max(BF16_FACTOR * e_ref, BF16_ULP), \
            (n, e_port, e_ref)


class _MmCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in tmodel._DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_policies_give_the_same_loss_and_grads(family):
    """Float32: remat off, ``full`` (nothing saved) and ``dots`` (the
    products without a batch dimension saved) give the same loss and
    grads; ``full`` reruns every layer's projections in the backward,
    ``dots`` none of them (counted for the dense family)."""
    arch = ARCHS[family]
    _, tcfg = _cfgs(arch)
    base = build_model(tcfg.scaled(remat=False), "cpu").init(
        torch.Generator().manual_seed(3)).float()
    batch = _batch(tcfg, 4)
    out, mms = {}, {}
    for name, kw in (("off", dict(remat=False)), ("full", {}),
                     ("dots", dict(remat_policy="dots"))):
        m = Model(tcfg.scaled(**kw), "cpu").float()
        m.load_state_dict(base.state_dict())
        count = _MmCount()
        with count if family == "dense" else contextlib.nullcontext():
            out[name] = _port_grads(m, batch)
        mms[name] = count.n
    want_loss, want = out["off"]
    for name in ("full", "dots"):
        loss, grads = out[name]
        assert abs(loss - want_loss) <= REMAT_TOL * abs(want_loss), name
        for n, g in grads.items():
            w = want[n]
            assert float((g - w).abs().max()) <= \
                REMAT_TOL * float(w.abs().max()), (name, n)
    if family == "dense":
        assert mms["dots"] == mms["off"] < mms["full"], mms


# ----------------------------------------------------------- optimizers

OPT_KW = {"adamw": dict(lr=1e-2, warmup=3),
          "adafactor": dict(lr=1e-2, warmup=3)}


@pytest.fixture(scope="module")
def opt_case():
    """(reference config, port config, the reference's parameters with
    random norms and biases) of the dense SMOKE model at 2 layers, and the
    reference's optimizers as (init, jitted update), each traced once."""
    jcfg, tcfg = _cfgs("qwen1.5-4b")
    params = _randomise(jax.tree.map(np.asarray, jinit(
        jcfg, jax.random.PRNGKey(31))), 32)
    updates = {}
    for name in OPT_KW:
        jo = getattr(jopt, name)(**OPT_KW[name])
        updates[name] = (jo.init, jax.jit(jo.update))
    return jcfg, tcfg, params, updates


def _grad_trees(params, steps, seed, layer_scales=None):
    """``steps`` random grad trees shaped and typed as ``params``; with
    ``layer_scales`` (a list of per-layer factors a step) every stacked
    ``layers`` leaf's layer i scaled by its factor."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        def draw(path, a):
            g = rng.standard_normal(a.shape).astype(np.float32)
            if layer_scales and path[0].key == "layers":
                g *= np.asarray(layer_scales[s], np.float32).reshape(
                    (-1,) + (1,) * (a.ndim - 1))
            return g.astype(a.dtype)
        out.append(jax.tree_util.tree_map_with_path(draw, params))
    return out


def _port_dict(tree, names):
    """{port name: tensor} of a reference-shaped tree of numpy arrays."""
    out = {}
    for n in names:
        a = np.asarray(_ref_leaf(tree, n))
        out[n] = (torch.from_numpy(_f32(a)).to(torch.bfloat16)
                  if a.dtype == jnp.bfloat16 else torch.from_numpy(a.copy()))
    return out


def _run_ref(init_update, params, grads):
    """The reference's optimizer, (init, jitted update), over the grad
    trees: (parameters as float32 numpy, state)."""
    init, update = init_update
    p = jax.tree.map(jnp.asarray, params)
    st = init(p)
    for s, g in enumerate(grads):
        p, st = update(jax.tree.map(jnp.asarray, g), st, p,
                       jnp.asarray(s, jnp.int32))
    return jax.tree.map(_f32, p), st


def _run_port(name, params, tcfg, grads, rename=None):
    """The port's optimizer over the same grads: (parameters by port name,
    state).  ``rename`` maps the port's names before the optimizer sees
    them (a planted fault)."""
    model = interop.lm_params(params, tcfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    rn = rename or (lambda n: n)
    tp = {rn(n): t for n, t in model.named_parameters()}
    opt = make_optimizer(name, **OPT_KW[name])
    st = opt.init(tp)
    for s, g in enumerate(grads):
        tg = {rn(n): t for n, t in _port_dict(g, names).items()}
        tp, st = opt.update(tg, st, tp, torch.tensor(s))
    return dict(model.named_parameters()), st


def _params_close(got, want, before, steps):
    """Float32 parameters within ``OPT_TOL`` of max|want|; bf16 ones within
    one bf16 ulp of |before| + |want| (the float32 update's operands) a
    step: a result near a rounding boundary rounds either way, and a
    weight that then shrinks keeps that difference."""
    for n, t in got.items():
        w = _ref_leaf(want, n)
        g = t.detach().float().numpy()
        if t.dtype == torch.bfloat16:
            mag = np.abs(_f32(_ref_leaf(before, n))) + np.abs(w)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert (np.abs(g - w) <= steps * ulp).all(), n
        else:
            assert np.abs(g - w).max() <= OPT_TOL * np.abs(w).max(), n


def _state_close(got: torch.Tensor, want, key):
    w = _f32(want)
    assert got.dtype == torch.float32 and got.shape == w.shape, key
    assert float(np.abs(got.numpy() - w).max()) <= \
        OPT_TOL * max(np.abs(w).max(), 1e-30), key


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(opt_case, name, steps):
    """Parameters and state after ``steps`` updates from the same injected
    grads: AdamW's ``m``/``v`` per port tensor against the stacked
    leaves' slices, Adafactor's ``r``/``c``/``v`` per reference leaf."""
    _, tcfg, params, updates = opt_case
    grads = _grad_trees(params, steps, 33)
    p, st = _run_ref(updates[name], params, grads)
    tp, tst = _run_port(name, params, tcfg, grads)
    _params_close(tp, p, params, steps)
    if name == "adamw":
        for key in ("m", "v"):
            for n, t in tst[key].items():
                _state_close(t, _ref_leaf(st[key], n), n)
        return
    assert set(tst) == set(topt.leaf_groups(tp))
    for key, s in tst.items():
        ref = st
        for k in key.split("."):
            ref = ref[k]
        assert set(s) == set(ref), key
        for part, t in s.items():
            _state_close(t, ref[part], f"{key}.{part}")


def _per_tensor(name):
    """A planted fault: a port name with its stack index joined to the
    stack's name, so the optimizer treats each layer's tensor as a leaf of
    its own (per-layer clip, per-layer unfactored ``v`` for a norm)."""
    key, i = topt.stack_name(name)
    if i is None:
        return name
    head, rest = key.split(".", 1)
    return f"{head}_{i}.{rest}"


def test_adafactor_follows_the_stacked_leaves(opt_case):
    """Adafactor clips by the RMS of a whole stacked leaf and factors a
    layer norm's (L, D) weight: on grads whose layer 0 grows 8 times at
    step 2 while layer 1 halves, the clip binds for layer 0's MLP update
    and not layer 1's; the port matches the reference, and the
    per-tensor fault (per-layer clip, unfactored per-layer ``v``) fails
    both ``layers.mlp.w_gate`` and ``layers.ln1.w``."""
    _, tcfg, params, updates = opt_case
    grads = _grad_trees(params, 2, 34, layer_scales=[[1, 1], [8, 0.5]])
    p, st = _run_ref(updates["adafactor"], params, grads)
    tp, tst = _run_port("adafactor", params, tcfg, grads)
    _params_close(tp, p, params, 2)
    assert tst["layers.ln1.w"]["r"].shape == (2,)
    assert tst["layers.ln1.w"]["c"].shape == (tcfg.d_model,)
    # the reference's step-2 update of w_gate, layer by layer: unclipped
    # RMS above 1 for layer 0, below for layer 1
    s = st["layers"]["mlp"]["w_gate"]
    r, c = _f32(s["r"]), _f32(s["c"])
    vhat = r[..., None] * c[..., None, :] / np.maximum(
        r.mean(-1, keepdims=True)[..., None], 1e-30)
    u = _f32(grads[1]["layers"]["mlp"]["w_gate"]) / np.sqrt(vhat)
    rms = np.sqrt((u * u).reshape(2, -1).mean(-1))
    assert rms[0] > 1.0 > rms[1], rms
    fp, fst = _run_port("adafactor", params, tcfg, grads, rename=_per_tensor)
    assert set(fst["layers_0.ln1.w"]) == {"v"}
    for n in ("layers.1.mlp.w_gate", "layers.1.ln1.w"):
        w = _ref_leaf(p, n)
        with pytest.raises(AssertionError):
            _params_close({n: fp[n]}, p, params, 2)
        assert np.abs(tp[n].detach().float().numpy() - w).max() < \
            np.abs(fp[n].detach().float().numpy() - w).max()


def test_optimizer_names():
    assert make_optimizer("adamw").init is not None
    assert make_optimizer("adafactor").init is not None
    assert adamw().update is not None and adafactor().update is not None
    with pytest.raises(ValueError):
        make_optimizer("sgd")
    assert topt.stack_name("layers.3.attn.wq") == ("layers.attn.wq", 3)
    assert topt.stack_name("groups.0.b2_attn.ln1.w") == (
        "groups.b2_attn.ln1.w", 0)
    assert topt.stack_name("tail.1.lam") == ("tail.lam", 1)
    assert topt.stack_name("dec_layers.2.xattn.wk") == (
        "dec_layers.xattn.wk", 2)
    assert topt.stack_name("final_norm.w") == ("final_norm.w", None)


# ----------------------------------------------------------- train step

def _spy(opt, box):
    """``opt`` whose update first keeps a copy of the grads it is given."""
    def update(grads, state, params, step):
        box["grads"] = {n: g.clone() for n, g in grads.items()}
        return opt.update(grads, state, params, step)
    return topt.Optimizer(opt.init, update)


def _jspy(opt):
    """The reference's ``opt`` whose state also carries the grads."""
    def init(params):
        return {"inner": opt.init(params), "grads": params}

    def update(grads, state, params, step):
        params, inner = opt.update(grads, state["inner"], params, step)
        return params, {"inner": inner, "grads": grads}
    return jopt.Optimizer(init, update)


def _step_with_spy(model, batch):
    """(raw grads, the grads the optimizer got, metrics) of one
    ``make_train_step`` step of ``model`` with AdamW."""
    raw = _port_grads(model, batch)[1]
    box = {}
    opt = _spy(adamw(**OPT_KW["adamw"]), box)
    step = make_train_step(model, opt)
    _, m = step(opt.init(dict(model.named_parameters())),
                {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.tensor(0))
    assert set(m) == {"loss", "grad_norm"}
    assert all(v.dtype == torch.float32 and v.shape == () for v in m.values())
    # the clipped grads are the raw ones times the scale rounded to the
    # grad's dtype, bit for bit
    scale = torch.clamp(1.0 / torch.clamp(m["grad_norm"], min=1e-6), max=1.0)
    for n, g in box["grads"].items():
        assert torch.equal(g, raw[n] * scale.to(raw[n].dtype)), n
    return raw, box["grads"], {k: float(v) for k, v in m.items()}


def test_train_step_matches_reference_f32(opt_case):
    """One ``make_train_step`` step of the dense model in float32 against
    the reference's ``make_train_step``: loss, grad norm (above 1, so the
    clip binds), the clipped grads and the parameters after the step."""
    jcfg, tcfg, params, _ = opt_case
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    batch = _batch(jcfg, 35)
    jo = _jspy(jopt.adamw(**OPT_KW["adamw"]))
    jp = jax.tree.map(jnp.asarray, params32)
    with _ref_pdt(jnp.float32):
        jp, jst, jm = jax.jit(jmake_train_step(jcfg, jo))(
            jp, jo.init(jp), {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(0, jnp.int32))
    jgrads = jax.tree.map(_f32, jst["grads"])
    model = interop.lm_params(params, tcfg, device="cpu").float()
    _, clipped, m = _step_with_spy(model, batch)
    gnorm = float(jm["grad_norm"])
    assert gnorm > 1.0
    assert abs(m["loss"] - float(jm["loss"])) <= \
        F32_LOSS * abs(float(jm["loss"]))
    assert abs(m["grad_norm"] - gnorm) <= F32_GRAD * gnorm
    for n, g in clipped.items():
        w = _ref_leaf(jgrads, n)
        assert np.abs(g.numpy() - w).max() <= F32_GRAD * np.abs(w).max(), n
    # AdamW's first step moves a weight by sf·(g / (|g| + eps) + wd·p):
    # over grads within F32_GRAD·max|g| of each other, g / (|g| + eps)
    # moves by at most that times eps / (|g| − that + eps)², at most 2
    sf = OPT_KW["adamw"]["lr"] / OPT_KW["adamw"]["warmup"]
    eps = 1e-8
    for n, t in model.named_parameters():
        w, g = _f32(_ref_leaf(jp, n)), np.abs(_ref_leaf(jgrads, n))
        dg = F32_GRAD * g.max()
        move = np.minimum(2.0, dg * eps / (np.maximum(g - dg, 0) + eps) ** 2)
        err = np.abs(t.detach().numpy() - w)
        assert (err <= OPT_TOL * np.abs(w).max() + sf * move).all(), n


def test_train_step_matches_reference_bf16(refs):
    """One bf16 ``make_train_step`` step of the dense model against the
    reference's step arithmetic on its own bf16 ``value_and_grad`` (the
    ``refs`` run): loss, grad norm (above 1), and the grads clipped by
    the scale rounded to bf16."""
    _, tcfg, params, batch = _family_inputs("dense")
    want_loss, want = refs["dense"]["bf16"]
    model = interop.lm_params(params, tcfg, device="cpu")
    _, clipped, m = _step_with_spy(model, batch)
    names = [n for n, _ in model.named_parameters()]
    gnorm = float(np.sqrt(sum(np.sum(_ref_leaf(want, n).astype(np.float64)
                                     ** 2) for n in names)))
    assert gnorm > 1.0
    assert abs(m["loss"] - want_loss) <= TRAIN_BF16 * abs(want_loss)
    assert abs(m["grad_norm"] - gnorm) <= TRAIN_BF16 * gnorm
    scale = jnp.asarray(min(1.0, 1.0 / max(gnorm, 1e-6)), jnp.float32)
    for n, g in clipped.items():
        w = _ref_leaf(want, n)
        if g.dtype == torch.bfloat16:
            w = _f32(jnp.asarray(w, jnp.bfloat16) * scale.astype(
                jnp.bfloat16))
        else:
            w = w * np.float32(scale)
        assert np.abs(g.float().numpy() - w).max() <= \
            TRAIN_BF16_GRAD * np.abs(w).max(), n


# ----------------------------------------------------- learns structure

@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-2.7b",
                                  "qwen2-moe-a2.7b"])
def test_loss_learns_structure(arch):
    """The counterpart of ``tests/test_models.py::
    test_loss_learns_structure`` (its config at 2 of the SMOKE preset's 4
    layers, batch 2 × 32): 30 AdamW steps on a repeating pattern take the
    loss below 0.8 of its first value."""
    cfg = scaled_config(arch, "smoke").scaled(vocab=64, loss_chunk=64,
                                              attn_chunk=64, n_layers=2)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    toks = torch.arange(16, dtype=torch.int32).repeat(B, 2)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    opt = make_optimizer("adamw")
    step = make_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    losses = []
    for s in range(30):
        state, m = step(state, batch, torch.tensor(s))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], losses
