"""Guards of the port: what it imports, where it runs, and how it dispatches."""
from __future__ import annotations

import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import graph_build as tgb
from repro_torch.core.gkmeans import gk_means
from repro_torch.kernels import gather_score as kgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import refine_merge as krm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast and
    leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    assert path.is_file(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


NEW_MODULES = ("repro_torch.configs", "repro_torch.configs.gkmeans_paper",
               "repro_torch.analysis", "repro_torch.analysis.astlint",
               "repro_torch.analysis.baseline",
               "repro_torch.analysis.contracts",
               "repro_torch.analysis.__main__",
               "repro_torch.kernels.autotune",
               "repro_torch.launch.dryrun_cluster", "repro_torch.core.comm",
               "repro_torch.configs.base", "repro_torch.configs.qwen2_72b",
               "repro_torch.configs.chatglm3_6b", "repro_torch.models",
               "repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.model", "repro_torch.models.moe",
               "repro_torch.models.ssm", "repro_torch.configs.mamba2_27b",
               "repro_torch.models.rglru",
               "repro_torch.configs.recurrentgemma_9b",
               "repro_torch.configs.whisper_base",
               "repro_torch.configs.internvl2_2b",
               "repro_torch.train", "repro_torch.train.optimizer",
               "repro_torch.train.train_step",
               "repro_torch.train.serve_step", "repro_torch.launch.train",
               "repro_torch.launch.serve", "repro_torch.interop")


def test_new_modules_import_without_jax():
    """The analysis, autotune, configs, dry-run, LM serving and training
    modules import in a fresh interpreter without loading jax or the reference
    package."""
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(__import__("os").environ,
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_gk_means_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gk_means(X, 4, kappa=4, xi=8, tau=1, iters=1)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        gk_means(X, 4, kappa=4, xi=8, tau=1, iters=1, device="cuda")


def test_lm_serving_without_device_raises_when_no_cuda(monkeypatch):
    """``serve``, the ``Model`` constructor and the LM interop default to
    the card and raise without one; they never fall back to the CPU."""
    from repro_torch import interop
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = scaled_config("qwen2-72b", "smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])
    for make in (lambda: Model(cfg), lambda: build_model(cfg),
                 lambda: init_params(cfg, torch.Generator())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        Model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_cache({"k": np.zeros((1, 1, 2, 1, 2), np.float32),
                          "v": np.zeros((1, 1, 2, 1, 2), np.float32),
                          "len": 1})
    model = Model(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert float(model.layers[0].attn.wq.abs().sum()) == 0.0


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_lm_moe_entry_points_build_and_serve(arch):
    """The MoE family (ported after the dense one) builds and serves on
    the CPU from every LM entry point that the later families refuse."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import init_params
    cfg = scaled_config(arch, "smoke").scaled(n_layers=1)
    for model in (build_model(cfg, "cpu"), Model(cfg, "cpu")):
        assert model.layers[0].moe.we_gate.shape == (
            cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert float(model.layers[0].moe.we_down.float().abs().sum()) > 0
    toks, stats = tserve.serve(cfg, batch=1, prompt_len=4, gen=2,
                               device="cpu")
    assert toks.shape == (1, 2) and stats["decode_host_syncs"] == 0


def test_lm_ssm_entry_points_build_and_serve():
    """The ssm family (ported after the dense and MoE ones) builds from
    every LM entry point: Mamba2-2.7B at its full width and depth (on
    ``meta``: 2.7 B parameters, the published count) and at the smoke
    preset on the CPU, where it serves."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import MambaBlock, init_params
    full = build_model(get_config("mamba2-2.7b"), "meta")
    n = sum(p.numel() for p in full.parameters())
    assert len(full.layers) == 64 and 2.6e9 < n < 2.9e9
    assert full.layers[63].wx.shape == (2560, 5120)
    cfg = scaled_config("mamba2-2.7b", "smoke").scaled(n_layers=1)
    for model in (build_model(cfg, "cpu"), Model(cfg, "cpu")):
        assert isinstance(model.layers[0], MambaBlock)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert float(model.layers[0].wo.float().abs().sum()) > 0
    toks, stats = tserve.serve(cfg, batch=1, prompt_len=4, gen=2,
                               device="cpu")
    assert toks.shape == (1, 2) and stats["decode_host_syncs"] == 0


def test_lm_hybrid_entry_points_build_and_serve():
    """The hybrid family (ported after the dense, MoE and ssm ones) builds
    from every LM entry point: RecurrentGemma-9B at its full width and all
    38 layers (on ``meta``: 12 (rec, rec, attn) groups and a tail of two
    recurrent layers, 10.4 B parameters, 20.9 GB) and at the smoke preset
    on the CPU, where it serves."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import HybridGroup, RecBlock, init_params
    full = build_model(get_config("recurrentgemma-9b"), "meta")
    n = sum(p.numel() for p in full.parameters())
    assert len(full.groups) == 12 and len(full.tail) == 2
    assert 3 * len(full.groups) + len(full.tail) == 38
    assert 10.4e9 < n < 10.5e9
    assert full.tail[1].w_r.shape == (4096, 4096)
    assert full.groups[11].b2_attn.attn.wk.shape == (4096, 1, 256)
    cfg = scaled_config("recurrentgemma-9b", "smoke").scaled(n_layers=4)
    for model in (build_model(cfg, "cpu"), Model(cfg, "cpu")):
        assert isinstance(model.groups[0], HybridGroup)
        assert isinstance(model.tail[0], RecBlock) and len(model.tail) == 1
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert float(model.tail[0].w_out.float().abs().sum()) > 0
    toks, stats = tserve.serve(cfg, batch=1, prompt_len=4, gen=2,
                               device="cpu")
    assert toks.shape == (1, 2) and stats["decode_host_syncs"] == 0


# the full configs' parameter counts: Whisper-base's, larger than the
# published 74 M, as the reference's model has an untied lm_head and no
# learned decoder positions; InternVL2-2B's backbone (InternLM2-1.8B) and
# patch projection, without the vision encoder, a stub
AUDIO_VLM = {"whisper-base": (97_212_416, 6, 6), "internvl2-2b": (
    1_891_244_032, 0, 24)}


@pytest.mark.parametrize("arch", sorted(AUDIO_VLM))
def test_lm_audio_vlm_entry_points_build_and_serve(arch):
    """The audio and vlm families (ported after the dense, MoE, ssm and
    hybrid ones) build from every LM entry point: at full width and depth
    on ``meta`` (Whisper-base: 6 encoder and 6 decoder layers with
    cross-attention; InternVL2-2B: 24 layers and ``patch_proj``), with the
    parameter counts asserted, and at the smoke preset on the CPU, where
    they serve."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.train import scaled_config
    from repro_torch.models import Model, build_model
    from repro_torch.models.model import init_params
    count, n_enc, n_dec = AUDIO_VLM[arch]
    full = build_model(get_config(arch), "meta")
    assert sum(p.numel() for p in full.parameters()) == count
    if n_enc:
        assert len(full.enc_layers) == n_enc and len(full.dec_layers) == 6
        assert full.dec_layers[5].xattn.wk.shape == (512, 8, 64)
        assert not hasattr(full.enc_layers[0], "xattn")
    else:
        assert len(full.layers) == n_dec
        assert full.patch_proj.shape == (1024, 2048)
    cfg = scaled_config(arch, "smoke").scaled(n_layers=1)
    for model in (build_model(cfg, "cpu"), Model(cfg, "cpu")):
        assert model.cfg.family == cfg.family
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    drawn = model.dec_layers[0].xattn.wo if n_enc else model.patch_proj
    assert float(drawn.float().abs().sum()) > 0
    toks, stats = tserve.serve(cfg, batch=1, prompt_len=cfg.n_patches + 4,
                               gen=2, device="cpu")
    assert toks.shape == (1, 2) and stats["decode_host_syncs"] == 0


def test_audit_without_device_raises_when_no_cuda(monkeypatch):
    """The contract audit runs on the card by default: ``run_audit()`` and
    ``python -m repro_torch.analysis audit`` without ``--device`` raise
    where there is none, before any contract runs; ``device="cpu"`` is
    accepted."""
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis import contracts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(contracts, "CONTRACTS", {
        "probe": lambda device, comm: ran.append(device) or []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.run_audit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["audit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.contract_engine_run()
    assert ran == []
    assert contracts.run_audit(device="cpu") == []
    assert ran == [torch.device("cpu")]


def _gs_args():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g)
    u = torch.randint(0, 12, (8,), generator=g, dtype=torch.int32)
    cand = torch.randint(0, 12, (8, 4), generator=g, dtype=torch.int32)
    D = torch.randn(12, 16, generator=g)
    cnt = torch.ones(12)
    return x, u, cand, D, cnt


def test_kernel_wrappers_reject_cpu_tensors():
    """The wrappers never run the plain version: a CPU tensor is refused
    before any build or launch, and the launch count stays put."""
    x, u, cand, D, cnt = _gs_args()
    before = dict(kgs._build.launch_counts)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kgs.gather_score(x, u, cand, D, cnt)
    rows = cand.clone()
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        krm.refine_merge(x, rows, rows, rows, torch.zeros(8, 4), D)
    assert dict(kgs._build.launch_counts) == before


def test_ops_dispatches_cpu_tensors_to_ref():
    args = _gs_args()
    for mode in ("bkm", "lloyd"):
        assert torch.equal(tops.gather_score(*args, mode=mode),
                           tref.gather_score(*args, mode=mode))
        assert torch.equal(tops.gather_score(*args, mode=mode, force="ref"),
                           tref.gather_score(*args, mode=mode))
    with pytest.raises(ValueError, match="force"):
        tops.gather_score(*args, force="interpret")
    Xb = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tops.pairwise_sq(Xb), tref.pairwise_sq(Xb))
    for force in ("pallas", "interpret", "cuda"):
        with pytest.raises(ValueError, match="force"):
            tops.pairwise_sq(Xb, force=force)


@contextlib.contextmanager
def _gloo_world(tmp_path):
    """A world-size-1 gloo group in this process, left on exit."""
    from repro_torch.launch.mesh import close_group, init_group
    init_group("cpu", rank=0, world_size=1, store_path=tmp_path / "store")
    try:
        yield
    finally:
        close_group()


def test_out_of_slice_options_raise(tmp_path):
    """The sharded options run: shards, bf16 payloads and a GraphBuilder
    over a process group (their parity tests: tests/test_torch_sharded.py;
    telemetry runs: tests/test_torch_obs.py), as do the dense and probe
    sources and the descent build (tests/test_torch_ivf_codec.py,
    tests/test_torch_baselines.py).  What still raises: the probe kernel's
    cap p <= 128, and a shard layout that does not divide."""
    X = torch.randn(64, 4, generator=torch.Generator().manual_seed(1))
    src = teng.graph_source(torch.randint(
        0, 64, (64, 2), generator=torch.Generator().manual_seed(2),
        dtype=torch.int32))
    for cfg in (teng.EngineConfig(shards=2, batch_size=16),
                teng.EngineConfig(payload_bf16=True, sparse_updates=True,
                                  batch_size=16)):
        for source in (src, teng.dense_source(), teng.probe_source(2)):
            out = teng.epoch(X, teng.init_state(
                X, torch.arange(64, dtype=torch.int32) % 2, 2), source,
                [1, 2, 3, 4], cfg)
            assert out.assign.shape == (64,) and int(out.cnt.sum()) == 64
    for p in (0, 129):
        with pytest.raises(ValueError, match="p <= 128"):
            teng.probe_source(p)
    bcfg = tgb.GraphBuildConfig(kappa=4, xi=8, tau=2, shards=2)
    g2, _ = tgb.build_graph(X, bcfg,
                            generator=torch.Generator().manual_seed(3))
    assert g2.ids.shape == (64, 4) and bool((g2.ids >= 0).all())
    with pytest.raises(ValueError, match="divide"):
        tgb.build_graph(X, bcfg._replace(shards=3),
                        generator=torch.Generator())
    with _gloo_world(tmp_path):
        g1, _ = tgb.GraphBuilder(bcfg._replace(shards=1), group="world"
                                 ).build(X, generator=torch.Generator(
                                     ).manual_seed(3))
    want, _ = tgb.build_graph(X, bcfg._replace(shards=1),
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1.ids, want.ids) and torch.equal(g1.dist, want.dist)
    for source in (teng.dense_source(), teng.probe_source(2)):
        out = teng.epoch(X, teng.init_state(
            X, torch.zeros(64, dtype=torch.int32), 2), source, [1, 2, 3, 4],
            teng.EngineConfig(batch_size=16, mode="lloyd"))
        assert out.assign.shape == (64,) and int(out.cnt.sum()) == 64
    g, _ = tgb.build_graph(torch.randn(64, 4, generator=torch.Generator(
    ).manual_seed(0)), tgb.GraphBuildConfig(kappa=4, source="descent",
                                            tau=1),
        generator=torch.Generator().manual_seed(0))
    assert g.ids.shape == (64, 4) and bool((g.ids >= 0).all())


def test_group_backend_must_match_device(tmp_path):
    """A gloo group takes CPU tensors only and an NCCL group CUDA tensors
    only: a mismatch raises before any collective, nothing is copied."""
    from repro_torch.core.comm import Comm
    from repro_torch.core.distributed import ShardedEngine
    with _gloo_world(tmp_path):
        comm = Comm()
        assert comm.backend == "gloo" and comm.size == 1
        comm.check("cpu")
        with pytest.raises(ValueError, match="gloo group takes cpu"):
            comm.check("cuda")
        with pytest.raises(ValueError, match="gloo group takes cpu"):
            comm.psum(torch.zeros(2, device="meta"))
        comm.backend = "nccl"
        with pytest.raises(ValueError, match="nccl group takes cuda"):
            comm.psum(torch.zeros(2))
        with pytest.raises(ValueError, match="nccl group takes cuda"):
            comm.all_gather(torch.zeros(2))
        eng = ShardedEngine(cfg=teng.EngineConfig(batch_size=8))
        eng.comm.backend = "nccl"
        X = torch.zeros((16, 4))
        with pytest.raises(ValueError, match="nccl group takes cuda"):
            eng.run(X, torch.zeros((16, 2), dtype=torch.int32),
                    torch.zeros(16, dtype=torch.int32), torch.zeros(2, 4),
                    torch.ones(2), epoch_words=[[1, 2, 3, 4]])
    with pytest.raises(RuntimeError, match="not initialised"):
        Comm()


def test_sparse_updates_is_the_plain_scatter_on_one_device():
    g = torch.Generator().manual_seed(3)
    X = torch.randn(256, 8, generator=g)
    a = torch.randint(0, 16, (256,), generator=g, dtype=torch.int32)
    G = torch.randint(0, 256, (256, 6), generator=g, dtype=torch.int32)
    outs = []
    for sparse in (False, True):
        st = teng.init_state(X, a, 16)
        teng.epoch(X, st, teng.graph_source(G), [5, 6, 7, 8],
                   teng.EngineConfig(batch_size=64, sparse_updates=sparse))
        outs.append(st)
    assert torch.equal(outs[0].assign, outs[1].assign)
    assert torch.equal(outs[0].cnt, outs[1].cnt)
    assert int(outs[0].moves) > 0


def test_ivf_kernel_wrappers_reject_cpu_tensors():
    from repro_torch.kernels import assign_centroids as kac
    from repro_torch.kernels import centroid_assign as kca
    from repro_torch.kernels import ivf_scan as kivf
    from repro_torch.kernels import ivf_scan_adc as kadc
    from repro_torch.kernels import ivf_scan_grouped as kgrp
    X, C = torch.randn(8, 16), torch.randn(5, 16)
    before = dict(kca._build.launch_counts)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kac.assign_centroids(X, C)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kca.probe_centroids(X, C, 2)
    pids = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kivf.ivf_scan(X, torch.zeros(16, 16), pids,
                      torch.zeros((8, 2), dtype=torch.int32), block_rows=8)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kadc.ivf_scan_adc(torch.zeros(8, 4, 256), torch.zeros(8),
                          torch.zeros(16), torch.zeros((16, 4),
                                                       dtype=torch.uint8),
                          pids, torch.zeros((8, 2), dtype=torch.int32),
                          block_rows=8)
    with pytest.raises(ValueError, match="CPU tensors dispatch"):
        kgrp.ivf_scan_grouped(X, torch.zeros(16, 16), pids,
                              torch.zeros((2, 3), dtype=torch.int32),
                              torch.zeros((8, 3), dtype=torch.int32),
                              block_rows=8)
    # shapes no kernel takes are refused before any launch
    with pytest.raises(ValueError, match="shared memory"):
        kadc.ivf_scan_adc(torch.zeros(1, 129, 256), torch.zeros(1),
                          torch.zeros(8), torch.zeros((8, 129),
                                                      dtype=torch.uint8),
                          pids[:8], torch.zeros((1, 1), dtype=torch.int32),
                          block_rows=8)
    with pytest.raises(ValueError, match="G <= 8"):
        kgrp.ivf_scan_grouped(torch.zeros(18, 16), torch.zeros(16, 16), pids,
                              torch.zeros((2, 3), dtype=torch.int32),
                              torch.zeros((18, 3), dtype=torch.int32),
                              block_rows=8)
    assert dict(kca._build.launch_counts) == before


def test_pairwise_wrapper_rejects_cpu_tensors():
    from repro_torch.kernels import pairwise_sq as kpw
    before = dict(kpw._build.launch_counts)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CPU tensors dispatch"):
            kpw.pairwise_sq(torch.zeros(2, 8, 4, dtype=dtype))
    assert dict(kpw._build.launch_counts) == before


def test_every_kernel_source_has_a_guarded_wrapper():
    """Each CUDA source is built, has its ctypes wrapper beside it, and that
    wrapper is among the files the import guard above checks."""
    from repro_torch.kernels import _build
    assert len(set(_build.SOURCES)) == len(_build.SOURCES)
    assert set(_build.launch_counts) == set(_build.KERNELS)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
        wrapper = _build.CSRC.parent / f"{name}.py"
        assert wrapper in PORT_FILES, name
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SOURCES)


def _tiny_index():
    from repro_torch import index as tivf

    class R:
        assign = torch.arange(32, dtype=torch.int32) % 4
        centroids = torch.randn(4, 8)
        k = 4
    return tivf, tivf.build_ivf(torch.randn(32, 8), R, block_rows=8,
                                device="cpu")


def test_ivf_out_of_slice_options_raise(tmp_path):
    """Sharded lists run (their parity test: tests/test_torch_sharded.py);
    a memmapped load stays on the host; a codec search on an index without
    that codec, or with qgroup, is a ValueError."""
    tivf, index = _tiny_index()
    Q = torch.randn(3, 8)
    parts = tivf.shard_lists(index, 2)
    assert parts.shards == 2 and parts.vecs.shape[0] == 2 * parts.rows_loc
    assert int((parts.ids >= 0).sum()) == index.size
    with pytest.raises(ValueError, match="shards"):
        tivf.shard_lists(index, 0)
    path = str(tmp_path / "ix.ivf")
    tivf.save_index(index, path)
    mapped = tivf.load_index(path, mmap=True)
    assert mapped.device.type == "cpu"
    assert torch.equal(mapped.vecs, index.vecs)
    assert torch.equal(tivf.search(mapped, Q, nprobe=2)[0],
                       tivf.search(index, Q, nprobe=2)[0])
    with pytest.raises(ValueError, match="on the host"):
        tivf.load_index(path, device="cuda", mmap=True)
    for codec in ("int8", "pq"):
        with pytest.raises(ValueError, match="payload is 'f32'"):
            tivf.search(index, Q, codec=codec)
    q8 = tivf.quantize_index(index, "int8")
    with pytest.raises(ValueError, match="payload is 'int8'"):
        tivf.search(q8, Q, codec="pq")
    with pytest.raises(ValueError, match="per-query only"):
        tivf.search(q8, Q, codec="int8", qgroup=2)
    with pytest.raises(ValueError, match="unknown codec kind"):
        tivf.quantize_index(index, "opq")
    ids, _ = tivf.search(index, Q, qgroup=1, nprobe=2)   # per-query layout
    assert ids.shape == (3, 10)
    # rerank belongs to the codec scan: the f32 scan does not read it
    assert torch.equal(tivf.search(index, Q, rerank=40, nprobe=2)[0], ids)


def test_serve_index_without_device_raises_when_no_cuda(monkeypatch,
                                                        tmp_path):
    from repro_torch.launch import serve_index as tserve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--n", "256", "--d", "8", "--k", "4", "--nq", "8"])
    tivf, index = _tiny_index()
    path = str(tmp_path / "ix.ivf")
    tivf.save_index(index, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tivf.load_index(path)
    with pytest.raises(SystemExit, match="per-query only"):
        tserve.main(["--device", "cpu", "--codec", "pq", "--qgroup", "4"])
    with pytest.raises(SystemExit, match="carries 'f32'"):
        tserve.main(["--device", "cpu", "--load", path, "--codec", "int8"])


def test_interop_without_device_raises_when_no_cuda(monkeypatch):
    from repro_torch import interop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    block = 4
    caps = np.array([4, 8], np.int32)
    arrays = (np.zeros((2, 3), np.float32), np.zeros((16, 3), np.float32),
              np.full(16, -1, np.int32), np.array([0, 4], np.int32), caps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.ivf_index(*arrays, block)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.knn_graph(np.zeros((4, 2), np.int32), np.zeros((4, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.bkm_state(np.zeros(4, np.int32), np.zeros((2, 3)),
                          np.zeros(2))
    index = interop.ivf_index(*arrays, block, device="cpu")
    assert index.device.type == "cpu" and index.max_list_tiles == 2
    kv = (np.zeros((1, 2, 4, 3), np.float32), np.zeros((1, 2, 4, 2), np.int32),
          np.zeros((1, 2, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.kv_clusters(*kv)
    assert interop.kv_clusters(*kv, device="cpu").table.dtype == torch.int32
    from repro_torch.core.kv_cluster import build_kv_clusters
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_kv_clusters(np.zeros((1, 8, 1, 2), np.float32), 2,
                          generator=torch.Generator())


# ------------------------------------------------- the launch device guard

class _FakeDeviceGuard:
    """Stands in for ``torch.cuda.device``: records entry and exit."""
    calls: list = []

    def __init__(self, dev):
        self.calls.append(("device", dev))

    def __enter__(self):
        self.calls.append(("enter",))
        return self

    def __exit__(self, *exc):
        self.calls.append(("exit",))
        return False


def test_launch_enters_the_device_then_takes_its_stream(monkeypatch):
    """``_build.launch`` makes the tensors' device current before it takes
    that device's stream and calls the C function (with the stream last)
    inside; it raises on a nonzero return code and counts only a launch
    that returned 0."""
    from repro_torch.kernels import _build

    class Stream:
        cuda_stream = 4242
    calls = _FakeDeviceGuard.calls = []
    monkeypatch.setattr(torch.cuda, "device", _FakeDeviceGuard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: calls.append(("stream", d)) or Stream())
    rcs = [0, 700, -1]

    def fn(*args):
        calls.append(("fn", args))
        return rcs.pop(0)
    dev = torch.device("cuda", 3)
    before = _build.launch_counts["ivf_scan"]
    _build.launch("ivf_scan", fn, dev, 7, 8)
    assert calls == [("device", dev), ("enter",), ("stream", dev),
                     ("fn", (7, 8, 4242)), ("exit",)]
    assert _build.launch_counts["ivf_scan"] == before + 1
    for rc in (700, -1):
        calls.clear()
        with pytest.raises(RuntimeError,
                           match=f"ivf_scan launch failed: CUDA error {rc}"):
            _build.launch("ivf_scan", fn, dev, 7, 8)
        assert calls[:3] == [("device", dev), ("enter",), ("stream", dev)]
        assert calls[-1] == ("exit",)
        assert _build.launch_counts["ivf_scan"] == before + 1


class _Launched(Exception):
    pass


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __getattr__(self, name):
        return _FakeFn()


def test_every_wrapper_launches_through_the_guard(monkeypatch):
    """Each of the eight wrappers hands its launch, with its tensors'
    device, to ``_build.launch`` (stubbed here, with the input checks and
    the library, so that the CPU can follow a wrapper to its launch), and
    no wrapper takes a stream or counts a launch itself."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import assign_centroids as kac
    from repro_torch.kernels import centroid_assign as kca
    from repro_torch.kernels import ivf_scan as kivf
    from repro_torch.kernels import ivf_scan_adc as kadc
    from repro_torch.kernels import ivf_scan_grouped as kgrp
    from repro_torch.kernels import pairwise_sq as kpw
    seen = []

    def fake_launch(name, fn, dev, *args):
        seen.append((name, dev))
        raise _Launched(name)
    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    x, u, cand, D, cnt = _gs_args()
    X, C = torch.randn(8, 16), torch.randn(5, 16)
    pids = torch.zeros(16, dtype=torch.int32)
    tm = torch.zeros((8, 2), dtype=torch.int32)
    calls = [
        lambda: kgs.gather_score(x, u, cand, D, cnt),
        lambda: krm.refine_merge(x, cand, cand, cand, torch.zeros(8, 4), D),
        lambda: kca.probe_centroids(X, C, 2),
        lambda: kac.assign_centroids(X, C),
        lambda: kivf.ivf_scan(X, torch.zeros(16, 16), pids, tm,
                              block_rows=8),
        lambda: kadc.ivf_scan_adc(torch.zeros(8, 4, 256), torch.zeros(8),
                                  torch.zeros(16),
                                  torch.zeros((16, 4), dtype=torch.uint8),
                                  pids, tm, block_rows=8),
        lambda: kgrp.ivf_scan_grouped(X, torch.zeros(16, 16), pids,
                                      torch.zeros((2, 3), dtype=torch.int32),
                                      torch.zeros((8, 3), dtype=torch.int32),
                                      block_rows=8),
        lambda: kpw.pairwise_sq(torch.zeros(2, 8, 4))]
    for call in calls:
        with pytest.raises(_Launched):
            call()
    assert [name for name, _ in seen] == list(_build.KERNELS)
    assert all(dev == torch.device("cpu") for _, dev in seen)
    for name in _build.SOURCES:
        text = (_build.CSRC.parent / f"{name}.py").read_text()
        assert "current_stream" not in text and "launch_counts" not in text
