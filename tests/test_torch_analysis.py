"""The port's static analysis (``repro_torch.analysis``): the linter's rules
on planted-violation trees (as ``tests/test_analysis.py`` does for the
reference's), the real tree against its baseline, and the contract audit —
in process through a ``RecordingComm``, with a planted extra collective, a
stray ``.item()`` and an f64 op each failing it, and on a spawned gloo
group of 4 ranks, which must count the same.
"""
from __future__ import annotations

import json
import os
import sys
import textwrap

import pytest
import torch

from repro_torch.analysis import baseline as bl
from repro_torch.analysis import contracts
from repro_torch.analysis.astlint import (LintConfig, RegistryConfig,
                                          lint_file, run_lint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "src/repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return rel


def _cfg(root, registry=None):
    return LintConfig(root=str(root), template_exempt=(), registry=registry)


def _rules(findings):
    return sorted((f.rule, f.line) for f in findings)


# --------------------------------------------------------------------------
# layer 1: idiom rules on planted violations
# --------------------------------------------------------------------------

def test_planted_item_flagged_at_line(tmp_path):
    rel = _write(tmp_path, f"{PKG}/core/engine.py", """\
        import torch

        def step(x):
            total = torch.sum(x)
            return total.item()
        """)
    findings, _ = run_lint(_cfg(tmp_path))
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("sync-idiom", rel, 5)]


def test_planted_sync_idioms_all_fire(tmp_path):
    _write(tmp_path, f"{PKG}/kernels/foo.py", """\
        import torch

        def bad(x, n):
            a = x.cpu()
            b = x.tolist()
            c = x.numpy()
            d = float(x.sum())
            e = int(torch.argmax(x))
            f = bool((x > 0).any())
            torch.cuda.synchronize()
            g = float(3.0)        # a constant: nothing read
            h = int(n // 2)       # no call: host arithmetic
            return a, b, c, d, e, f, g, h
        """)
    findings, _ = run_lint(_cfg(tmp_path))
    assert all(f.rule == "sync-idiom" for f in findings)
    assert sorted(f.line for f in findings) == [4, 5, 6, 7, 8, 9, 10]


def test_designed_reads_and_boundary_waiver_pass(tmp_path):
    _write(tmp_path, f"{PKG}/core/engine.py", """\
        from repro_torch.obs import syncs

        def ok(x):
            got = syncs.read(x)
            a = got[1:].view(int).tolist()
            b = int(syncs.read(x.sum()))
            c = syncs.read(x).tolist()
            d = x.item()  # lint: boundary(host diagnostic)
            # lint: boundary(a CPU tensor)
            e = bool(x.any())
            return a, b, c, d, e

        def still_bad(x):
            return x.item()
        """)
    findings, _ = run_lint(_cfg(tmp_path))
    assert _rules(findings) == [("sync-idiom", 14)]


def test_sync_idiom_only_in_device_modules(tmp_path):
    src = "def f(x):\n    return x.item()\n"
    for rel in (f"{PKG}/core/lloyd.py", f"{PKG}/kernels/_build.py",
                f"{PKG}/kernels/autotune.py", f"{PKG}/launch/serve.py"):
        assert lint_file(rel, src, _cfg(tmp_path)) == [], rel
    for rel in (f"{PKG}/core/comm.py", f"{PKG}/index/probe.py",
                f"{PKG}/kernels/ivf_scan.py"):
        assert [f.rule for f in lint_file(rel, src, _cfg(tmp_path))] == [
            "sync-idiom"], rel


def test_permute_and_wallclock_rules(tmp_path):
    src = textwrap.dedent("""\
        import time
        import torch

        def f(n, g):
            t0 = time.perf_counter()
            p = torch.randperm(n, generator=g)
            return p, time.time() - t0
        """)
    got = lint_file(f"{PKG}/core/lloyd.py", src, _cfg(tmp_path))
    assert _rules(got) == [("permute-in-core", 6), ("wallclock", 5),
                           ("wallclock", 7)]
    assert _rules(lint_file(f"{PKG}/core/permute.py", src,
                            _cfg(tmp_path))) == [("wallclock", 5),
                                                 ("wallclock", 7)]
    assert lint_file(f"{PKG}/obs/timing.py", src.replace(
        "torch.randperm", "torch.arange"), _cfg(tmp_path)) == []
    assert lint_file(f"{PKG}/launch/x.py", src, _cfg(tmp_path)) == []


def test_parse_error_is_a_finding(tmp_path):
    got = lint_file(f"{PKG}/core/engine.py", "def f(:\n", _cfg(tmp_path))
    assert [f.rule for f in got] == ["parse-error"]


def test_exempt_pattern_must_match(tmp_path):
    cfg = LintConfig(root=str(tmp_path), registry=None,
                     template_exempt=(f"{PKG}/models/*.py",))
    findings, exempt = run_lint(cfg)
    assert [f.rule for f in findings] == ["exempt-missing"] and not exempt
    _write(tmp_path, f"{PKG}/models/attention.py", "x = 1.0\n")
    findings, exempt = run_lint(cfg)
    assert findings == [] and exempt == [f"{PKG}/models/attention.py"]


# --------------------------------------------------------------------------
# kernel-registry on planted trees
# --------------------------------------------------------------------------

def _registry_tree(root, *, wrapper=True, ops=True, ref=True, inv=True,
                   check=True, glob_=True, tuned=None, exempt=True):
    """A minimal tree with one kernel ``foo`` and each piece optional;
    ``tuned``: None (not in SWEEP_TILES), or whether the table has it."""
    _write(root, f"{PKG}/kernels/_build.py", 'KERNELS = ("foo",)\n')
    _write(root, f"{PKG}/kernels/csrc/foo.cu",
           "__global__ void foo_kernel() {}\n" if glob_ else "// none\n")
    body = ("from repro_torch.kernels import _build\n"
            + ("# autotune: exempt(foo): its grid is fixed\n" if exempt
               else "")
            + "def foo(x):\n    f = _build.library('foo').foo_launch\n"
            + ("    _build.launch('foo', f, x.device, x)\n" if wrapper
               else "    return f\n"))
    _write(root, f"{PKG}/kernels/foo.py", body)
    _write(root, f"{PKG}/kernels/ops.py",
           "def foo(x):\n    return x\n" if ops else "")
    _write(root, f"{PKG}/kernels/ref.py",
           "def foo(x):\n    return x\n" if ref else "")
    _write(root, f"{PKG}/launch/roofline.py",
           "KERNEL_INVENTORY = {%s}\n" % ('"foo": {}' if inv else ""))
    _write(root, "chip_smoke.py",
           "def check_foo(x):\n    return ops.foo(x)\n" if check
           else "def check_bar(x):\n    return x\n")
    _write(root, f"{PKG}/kernels/autotune.py",
           "SWEEP_TILES = {%s}\n" % ('"foo": (1, 2)' if tuned is not None
                                     else ""))
    if tuned:
        _write(root, f"{PKG}/kernels/autotune_table.json", json.dumps(
            {"schema": "repro.autotune.v1", "entries": [
                {"kernel": "foo", "backend": "cuda", "shape": {"n": 1},
                 "tile": 1, "us": 1.0, "us_default": 1.0}]}))


def _registry(root):
    findings, _ = run_lint(_cfg(root, RegistryConfig()))
    return [f.message for f in findings if f.rule == "kernel-registry"]


def test_registered_kernel_is_clean(tmp_path):
    _registry_tree(tmp_path)
    assert _registry(tmp_path) == []
    _registry_tree(tmp_path, exempt=False, tuned=True)
    assert _registry(tmp_path) == []


@pytest.mark.parametrize("missing,needle", [
    ("ops", "dispatch in"), ("ref", "plain version"),
    ("inv", "KERNEL_INVENTORY"), ("check", "check_*"),
    ("glob_", "__global__"), ("exempt", "neither in SWEEP_TILES")])
def test_registry_piece_missing_is_a_finding(tmp_path, missing, needle):
    _registry_tree(tmp_path, **{missing: False})
    got = _registry(tmp_path)
    assert len(got) == 1 and needle in got[0], got


def test_registry_wrapper_and_table(tmp_path):
    _registry_tree(tmp_path, wrapper=False)
    got = _registry(tmp_path)
    assert len(got) == 1 and "no wrapper" in got[0]
    _registry_tree(tmp_path, exempt=False, tuned=False)
    got = _registry(tmp_path)
    assert len(got) == 1 and "autotune_table.json entry" in got[0]


def test_real_tree_lints_clean_against_baseline():
    from repro_torch.analysis.astlint import check
    findings, problems = check(REPO, log=lambda s: None)
    assert findings == [] and problems == []


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    path = str(tmp_path / "b.json")
    bl.save({"lint": ["b", "a", "a"], "replication": ["x"]}, path)
    doc = bl.load(path)
    assert doc["lint"] == ["a", "b"] and doc["schema"] == bl.SCHEMA
    assert bl.compare(["a", "b"], doc["lint"], section="lint") == []
    probs = bl.compare(["a", "c"], doc["lint"], section="lint")
    assert probs == ["lint: NEW (not in baseline): c",
                     "lint: STALE baseline entry (no longer found — delete "
                     "it): b"]
    assert bl.load(str(tmp_path / "none.json"))["lint"] == []


def test_baseline_rejects_wrong_schema(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"schema": "other", "lint": []}))
    with pytest.raises(ValueError, match="expected schema"):
        bl.load(str(path))


# --------------------------------------------------------------------------
# layer 2: the contract audit
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audit():
    return contracts.run_audit(device="cpu")


def test_audit_in_process_passes(audit, tmp_path):
    """Every contract holds through the RecordingComm: syncs, budgets,
    dtypes; the replication report equals the baseline; the record is a
    valid ``repro.analysis.v1`` one."""
    from repro_torch.obs import emit
    assert [r.problems for r in audit if not r.ok] == []
    names = {r.name for r in audit}
    assert len(names) == 9 and "ShardedEngine.run[dense]" in names
    by = {r.name: r for r in audit}
    assert by["engine.run[telemetry=off]"].syncs == contracts.ITERS + 1
    assert by["GraphBuilder.build[partition]"].syncs == 0
    assert by["ShardedEngine.run[dense]"].collectives["all-to-all"] == \
        contracts.ITERS
    out = str(tmp_path / "a.json")
    assert contracts.report(audit, out=out, log=lambda s: None) == 0
    rec = emit.load_records(out)[0]
    emit.validate_record(rec)
    assert rec["schema"] == "repro.analysis.v1"
    assert rec["metrics"]["contracts_failed"] == 0


def _sharded_result(name):
    res = contracts.run_audit(["engine_sharded"], device="cpu")
    return {r.name: r for r in res}[name]


def test_audit_fails_on_an_extra_collective(monkeypatch):
    from repro_torch.core import engine
    real = engine._exchange_rows

    def twice(ids, D_loc, coff, comm):
        comm.psum(torch.zeros(1))
        return real(ids, D_loc, coff, comm)
    monkeypatch.setattr(engine, "_exchange_rows", twice)
    r = _sharded_result("ShardedEngine.run[dense]")
    assert not r.ok and any("collective counts" in p for p in r.problems)


def test_audit_fails_on_a_stray_item(monkeypatch):
    from repro_torch.core import engine
    real = engine._deltas

    def peek(u, v, gx, w, k):
        w.sum().item()
        return real(u, v, gx, w, k)
    monkeypatch.setattr(engine, "_deltas", peek)
    r = _sharded_result("ShardedEngine.run[dense]")
    assert not r.ok and any("outside obs.syncs.read" in p
                            for p in r.problems)


def test_audit_fails_on_a_stray_read_called_from_a_marked_line(
        monkeypatch, tmp_path):
    """A marked line covers only its own read: a stray ``.item()`` in port
    code that the marked ``to_device(...)`` statement of
    ``graph_build._build_partition`` calls still fails the audit."""
    import importlib.util

    from repro_torch.core import graph_build
    src = tmp_path / "repro_torch" / "planted.py"
    src.parent.mkdir()
    src.write_text("def to_device(x, dev, real=None):\n"
                   "    x.sum().item()\n"
                   "    return real(x, dev)\n")
    spec = importlib.util.spec_from_file_location("planted", str(src))
    planted = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(planted)
    real = graph_build.to_device
    hits = []

    def from_marked_lines(x, dev):
        f = sys._getframe(1)
        if not contracts._marked(f.f_code.co_filename, f.f_lineno):
            return real(x, dev)
        hits.append(f.f_lineno)
        return planted.to_device(x, dev, real)
    monkeypatch.setattr(graph_build, "to_device", from_marked_lines)
    res = {r.name: r for r in contracts.run_audit(["graph_build"],
                                                  device="cpu")}
    r = res["GraphBuilder.build[partition]"]
    assert hits, "the marked call was not reached"
    assert not r.ok and any("outside obs.syncs.read" in p and "planted.py"
                            in p for p in r.problems), r.problems


def test_audit_fails_on_an_f64_op(monkeypatch):
    from repro_torch.core import engine
    real = engine._score_from_rows

    def wide(xb, u, cand, rows, cnt, mode, eps):
        return real(xb.double().float(), u, cand, rows, cnt, mode, eps)
    monkeypatch.setattr(engine, "_score_from_rows", wide)
    r = _sharded_result("ShardedEngine.run[sparse,bf16]")
    assert not r.ok and any("f64" in p for p in r.problems)


def test_audit_on_a_gloo_group_counts_the_same(audit):
    """The sharded contracts on 4 spawned gloo ranks (120 s at most): every
    rank counts the in-process collectives and syncs, and passes."""
    ranks = contracts.run_gloo(4, timeout=120.0)
    assert len(ranks) == 4
    assert contracts.gloo_problems(audit, ranks) == []
