"""Checkpoints, the trainer loop, ``token_batch`` and ``llm_cost`` of the
port (``train/checkpoint.py``, ``launch/train.py``, ``launch/llm_cost.py``)
vs the JAX package (CPU).

Checkpoint files cross between the packages in both directions, bit for
bit (bf16 as its bits).  The loop's losses are held against the
reference's ``train`` over 3 steps of a tiny dense config in float32, with
the reference's parameters (``interop.lm_params``) and batches
(``batch_fn=``) injected, within ``tests/test_torch_train.py``'s float32
loss limit (1e-5 relative: the same float32 operations, sums in another
order).  A crash and a resume on the CPU equal the run without it bit for
bit, and ``llm_cost`` (a copy) equals the reference's exactly.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import llm_cost as jcost
from repro.launch import train as jtrain
from repro.models import model as jmodel_lib
from repro.models.model import build_model as jbuild
from repro.models.model import init_params as jinit
from repro.train import checkpoint as jckpt
from repro_torch import interop
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import llm_cost
from repro_torch.launch.train import make_batch_fn, scaled_config, train
from repro_torch.train import checkpoint as ckpt

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 2, 32
F32_LOSS = 1e-5         # tests/test_torch_train.py's float32 loss limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them as fast and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _ref_pdt(dtype):
    """The reference's ``PDT`` set to ``dtype`` inside the block."""
    pdt, jmodel_lib.PDT = jmodel_lib.PDT, dtype
    try:
        yield
    finally:
        jmodel_lib.PDT = pdt


def _cfgs(arch="qwen1.5-4b", **kw):
    """(reference, port) configs: the SMOKE preset at 2 layers, chunks of
    32."""
    kw = dict(dict(n_layers=2, loss_chunk=32, attn_chunk=32), **kw)
    return jtrain.scaled_config(arch, "smoke").scaled(**kw), \
        scaled_config(arch, "smoke").scaled(**kw)


@pytest.fixture(scope="module")
def ref_params():
    """(reference config, port config, the reference's ``init_params`` of
    the tiny dense config as numpy; jitted, as its op-by-op draws take
    seconds)."""
    jcfg, tcfg = _cfgs()
    params = jax.jit(jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn((4, 8), generator=g).to(torch.bfloat16),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5, dtype=torch.float32)},
            "e": (torch.randn((3,), generator=g),
                  np.arange(6, dtype=np.int64).reshape(2, 3))}


def _bits(t) -> np.ndarray:
    """A leaf's bytes as numpy (bf16 as its uint16 bits)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------ checkpoint

def test_roundtrip_keeps_every_leaf_bit_for_bit(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 7, t, extra={"seed": 1})
    assert os.path.basename(path) == "step_0000000007"
    like = {"a": torch.zeros((4, 8), dtype=torch.bfloat16),
            "b": {"c": torch.zeros(5, dtype=torch.int32),
                  "d": torch.tensor(0.0)},
            "e": (torch.zeros(3), np.zeros((2, 3), np.int64))}
    got, step, extra = ckpt.restore(str(tmp_path), like)
    assert step == 7 and extra == {"seed": 1}
    assert isinstance(got["e"], tuple)
    for (p, a), (q, b) in zip(ckpt._items(t), ckpt._items(got)):
        assert p == q
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        want = torch.as_tensor(a)
        assert b.dtype == want.dtype and b.shape == want.shape, p
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_latest_pointer_and_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_0000000004", "step_0000000005"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]
    _, step, _ = ckpt.restore(str(tmp_path), _tree(), step=4)
    assert step == 4


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((3, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad)
    extra_leaf = _tree()
    extra_leaf["b"]["z"] = torch.zeros(2)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), extra_leaf)


def test_no_partial_checkpoint_visible(tmp_path):
    """A ``.tmp_*`` directory is never a checkpoint; nor is a pointer to a
    directory that is gone."""
    os.makedirs(tmp_path / ".tmp_9_junk")
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _tree())
    ckpt.save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / ".tmp_4_junk")
    assert ckpt.latest_step(str(tmp_path)) == 3
    (tmp_path / "latest").write_text("step_0000000009")
    assert ckpt.latest_step(str(tmp_path)) is None


def test_corrupt_shard_rejected(tmp_path):
    """A flipped byte in a leaf's data fails the member's CRC-32 check, as
    ``np.load`` would."""
    path = ckpt.save(str(tmp_path), 1, _tree())
    shard = os.path.join(path, "shard_00000.npz")
    raw = bytearray(open(shard, "rb").read())
    at = raw.index(b"\x93NUMPY") + 128          # past the first npy header
    raw[at] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile):
        ckpt.restore(str(tmp_path), _tree())


def test_reference_reads_a_port_checkpoint(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t, extra={"seed": 3})
    like = {"a": jnp.zeros((4, 8), jnp.bfloat16),
            "b": {"c": jnp.zeros(5, jnp.int32), "d": jnp.float32(0)},
            "e": (jnp.zeros(3), np.zeros((2, 3), np.int64))}
    got, step, extra = jckpt.restore(str(tmp_path), like)
    assert step == 5 and extra == {"seed": 3}
    assert got["a"].dtype.name == "bfloat16"
    for (p, a), (_, b) in zip(ckpt._items(t), ckpt._items(got)):
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=str(p))


def test_port_reads_a_reference_checkpoint(tmp_path, ref_params):
    """The reference's ``save`` of its ``init_params`` (a tiny dense
    config), restored by the port bit for bit and loaded through
    ``interop.lm_params``: ``Model.loss`` in float32 equals the
    reference's within the float32 loss limit."""
    jcfg, tcfg, params = ref_params
    jckpt.save(str(tmp_path), 0, params, extra={"seed": 3})
    like = jax.tree.map(np.asarray, params)
    tree, step, extra = ckpt.restore(str(tmp_path), like)
    assert step == 0 and extra == {"seed": 3}
    for (p, a), (_, b) in zip(ckpt._items(like), ckpt._items(tree)):
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=str(p))
    model = interop.lm_params(tree, tcfg, device="cpu").float()
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        got = float(model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()}))
    with _ref_pdt(jnp.float32):
        want = float(jax.jit(jbuild(jcfg).loss)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params),
            {k: jnp.asarray(v) for k, v in batch.items()}))
    assert abs(got - want) <= F32_LOSS * abs(want), (got, want)


# ------------------------------------------------------------ batches

@pytest.mark.parametrize("arch", ["qwen1.5-4b", "whisper-base",
                                  "internvl2-2b"])
def test_make_batch_fn(arch):
    """Shapes and dtypes as the reference's batches (dense, audio, vlm);
    the same batch again for the same (seed, step), another for another
    step or seed; labels are the tokens shifted by one."""
    jcfg, tcfg = jtrain.scaled_config(arch, "smoke"), \
        scaled_config(arch, "smoke")
    seq = 48
    want = jax.eval_shape(lambda: jtrain.make_batch_fn(jcfg, B, seq, 0)(0))
    fn = make_batch_fn(tcfg, B, seq, 0, device="cpu")
    b = fn(0)
    assert set(b) == set(want)
    for k, w in want.items():
        assert tuple(b[k].shape) == w.shape, k
        assert str(b[k].dtype) == f"torch.{w.dtype.name}", k
        assert b[k].device.type == "cpu"
    again, other = fn(0), fn(1)
    for k in b:
        assert torch.equal(b[k], again[k]), k
    assert not torch.equal(b["tokens"], other["tokens"])
    assert not torch.equal(b["tokens"], make_batch_fn(
        tcfg, B, seq, 1, device="cpu")(0)["tokens"])
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].min()) >= 0 and \
        int(b["tokens"].max()) < tcfg.vocab


# ------------------------------------------------------------ the loop

def test_train_matches_reference_losses(ref_params):
    """The loop's losses over 3 steps against the reference's ``train`` on
    the same float32 parameters (the reference's bf16 draws, upcast) and
    the reference's own batches."""
    jcfg, tcfg, params = ref_params
    params32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    init, jtrain.init_params = jtrain.init_params, lambda cfg, key: params32
    try:
        with _ref_pdt(jnp.float32):
            _, want = jtrain.train(jcfg, steps=3, batch=B, seq=S, seed=0,
                                   log_every=1)
    finally:
        jtrain.init_params = init
    jbatch = jtrain.make_batch_fn(jcfg, B, S, 0)
    model = interop.lm_params(params, tcfg, device="cpu").float()
    _, got = train(tcfg, steps=3, batch=B, seq=S, seed=0, log_every=1,
                   model=model, batch_fn=lambda s: {
                       k: torch.from_numpy(np.array(v))
                       for k, v in jbatch(s).items()})
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= F32_LOSS * abs(w), (got, want)


def test_resume_equals_uninterrupted_run_bit_for_bit(tmp_path, capsys):
    """3 steps and a save, then ``resume=True`` to 6 steps, against 6
    steps without a stop: the same losses and final parameters, bit for
    bit (on the CPU every op runs in the same order)."""
    _, cfg = _cfgs(vocab=256)
    kw = dict(batch=B, seq=S, seed=5, log_every=1, device="cpu")
    d = str(tmp_path / "ck")
    train(cfg, steps=3, ckpt_dir=d, **kw)
    assert ckpt.latest_step(d) == 3
    resumed, tail = train(cfg, steps=6, ckpt_dir=d, resume=True, **kw)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 6
    whole, losses = train(cfg, steps=6, **kw)
    assert tail == losses[3:]
    got = dict(resumed.named_parameters())
    for n, p in whole.named_parameters():
        assert torch.equal(got[n], p), n


def test_cli_simulated_crash_exits_42(tmp_path):
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--preset", "smoke", "--batch", "2", "--seq", "64", "--steps", "6",
         "--ckpt-every", "2", "--simulate-crash", "3", "--ckpt-dir", d],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 42, r.stderr[-2000:]
    assert "[train] simulating crash at step 3" in r.stdout
    assert ckpt.latest_step(d) == 2


# ------------------------------------------------------------ llm_cost

@pytest.mark.parametrize("arch", list_archs())
def test_llm_cost_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert llm_cost.param_counts(cfg) == jcost.param_counts(jcfg)
    assert set(SHAPES) == set(JSHAPES)
    for name, shape in SHAPES.items():
        if not cfg.supports(shape):
            continue
        js = JSHAPES[name]
        assert llm_cost.model_flops(cfg, shape) == \
            jcost.model_flops(jcfg, js)
        for chips in (1, 8, 512):
            assert llm_cost.flops_analytic(cfg, shape, chips) == \
                jcost.flops_analytic(jcfg, js, chips)
            assert llm_cost.hbm_analytic(cfg, shape, chips) == \
                jcost.hbm_analytic(jcfg, js, chips)
        assert llm_cost._cache_bytes(cfg, shape.global_batch,
                                     shape.seq_len) == \
            jcost._cache_bytes(jcfg, js.global_batch, js.seq_len)
