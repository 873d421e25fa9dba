"""The port's autotune table (``repro_torch.kernels.autotune``) against the
reference's lookup, and each tuned wrapper's plan with and without a table.

- ``best_tile`` and ``resolve`` equal ``repro.kernels.autotune``'s on the
  same entries (nearest batch in log space, exact shapes first);
- without a table every wrapper launches today's plan (the defaults are the
  modules' constants); an explicit argument overrides the table, and the
  committed table's knob is the one launched;
- the committed table comes from the card (backend ``cuda``, the sweep's
  shapes) and every kernel is either in it or exempt with a reason.
"""
from __future__ import annotations

import json
import os

import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import centroid_assign as kca
from repro_torch.kernels import ivf_scan_grouped as kgrp

ENTRIES = [
    {"kernel": "ivf_scan", "backend": "cuda", "shape": {"q": 64, "T": 160,
                                                         "topk": 10},
     "tile": 16, "us": 1.0, "us_default": 2.0},
    {"kernel": "ivf_scan", "backend": "cuda", "shape": {"q": 10_000,
                                                         "T": 160, "topk": 10},
     "tile": 4, "us": 1.0, "us_default": 2.0},
    {"kernel": "ivf_scan", "backend": "cpu", "shape": {"q": 64},
     "tile": 2, "us": 1.0, "us_default": 2.0},
    {"kernel": "probe_centroids", "backend": "cuda",
     "shape": {"n": 64, "k": 16_384, "p": 16}, "tile": 3, "us": 1.0,
     "us_default": 2.0},
    {"kernel": "probe_centroids", "backend": "cuda",
     "shape": {"n": 10_000, "k": 16_384, "p": 16}, "tile": 1, "us": 1.0,
     "us_default": 2.0},
    {"kernel": "gather_score", "backend": "cuda", "shape": {"B": 1024},
     "tile": 7, "us": 1.0, "us_default": 2.0},
]


@pytest.fixture
def table(tmp_path, monkeypatch):
    """The same entries as both packages' table."""
    path = str(tmp_path / "t.json")
    tat.save(list(ENTRIES), path)
    for mod in (tat, jat):
        monkeypatch.setattr(mod, "TABLE_FILE", path)
        mod.load_table.cache_clear()
    yield path
    for mod in (tat, jat):
        mod.load_table.cache_clear()


@pytest.fixture
def no_table(tmp_path, monkeypatch):
    monkeypatch.setattr(tat, "TABLE_FILE", str(tmp_path / "none.json"))
    tat.load_table.cache_clear()
    yield
    tat.load_table.cache_clear()


def test_lookup_equals_reference(table):
    shapes = [{"q": q, "T": 160, "topk": 10} for q in
              (1, 8, 64, 100, 800, 801, 5_000, 10_000, 10 ** 6)]
    shapes += [{"n": n, "k": 16_384, "p": 16} for n in (1, 64, 800, 10 ** 6)]
    shapes += [{"B": 1}, {"B": 1024}, {"B": 4096}, {"q": 64}, {}]
    for kernel in ("ivf_scan", "probe_centroids", "gather_score"):
        for backend in ("cuda", "cpu"):
            for shape in shapes:
                if not any(e["kernel"] == kernel and e["backend"] == backend
                           for e in ENTRIES):
                    continue
                assert tat.best_tile(kernel, backend, shape) == \
                    jat.best_tile(kernel, backend, shape), (kernel, shape)
                for tile in (None, 5):
                    assert tat.resolve(kernel, backend, shape, tile) == \
                        jat.resolve(kernel, backend, shape, tile)


def test_save_record_and_schema(tmp_path):
    entries = []
    tat.record(entries, "ivf_scan", "cuda", {"q": 1}, 4, 1.0, 2.0)
    tat.record(entries, "ivf_scan", "cuda", {"q": 1}, 8, 0.5, 2.0)
    want = []
    jat.record(want, "ivf_scan", "cuda", {"q": 1}, 4, 1.0, 2.0)
    jat.record(want, "ivf_scan", "cuda", {"q": 1}, 8, 0.5, 2.0)
    assert entries == want and len(entries) == 1
    path = tmp_path / "t.json"
    tat.save(entries, str(path))
    assert tat.load_table(str(path)) == tuple(entries)
    path.write_text(json.dumps({"schema": "other", "entries": []}))
    tat.load_table.cache_clear()
    with pytest.raises(ValueError, match="expected schema"):
        tat.load_table(str(path))
    tat.load_table.cache_clear()


def test_lookup_is_memoised_per_table(table, monkeypatch):
    """A launch's lookup is read from the memo after the first; a new table
    drops the memo."""
    shape = {"q": 64, "T": 160, "topk": 10}
    assert tat.best_tile("ivf_scan", "cuda", shape) == 16
    with monkeypatch.context() as m:
        m.setattr(tat, "_lookup", lambda *a: pytest.fail("rescan"))
        assert tat.best_tile("ivf_scan", "cuda", shape) == 16
    tat.save([ENTRIES[1]], table)
    assert tat.best_tile("ivf_scan", "cuda", shape) == 4


def _fake_cases(plans, outputs, kernel="ivf_scan_grouped", shape=None):
    """One case whose candidates map to ``plans`` and whose outputs are
    ``outputs[knob]``."""
    return [(kernel, shape or {"q": 64}, lambda c: plans[c],
             lambda c: (torch.tensor([outputs.get(c, 0)]),))]


def _scripted_times(monkeypatch, rounds):
    """``time_us`` answering from ``rounds``: a list of {knob: us} a round,
    read in the sweep's order."""
    it = iter([(c, us) for r in rounds for c, us in r.items()])

    def fake(call, knob, reps=30):
        c, us = next(it)
        assert c == knob
        return us
    monkeypatch.setattr(tat, "time_us", fake)


def test_sweep_skips_a_shape_with_one_plan(monkeypatch):
    monkeypatch.setattr(tat, "time_us", lambda *a, **k: pytest.fail("timed"))
    logs = []
    got = tat.sweep(cases=_fake_cases({c: "same" for c in (2, 1, 4, 8, 16)},
                                      {}), log=logs.append)
    assert got == [] and '"skipped": "one plan"' in logs[0]


def test_sweep_keeps_only_a_gain_beyond_the_spread(monkeypatch):
    """Candidates with one plan are timed once (the first in grid order);
    a winner inside the rounds' spread is not recorded, one beyond it is."""
    plans = {2: "a", 1: "b", 4: "b", 8: "c", 16: "a"}
    cases = _fake_cases(plans, {})
    _scripted_times(monkeypatch, [{2: 100.0, 1: 96.0, 8: 120.0},
                                  {2: 104.0, 1: 99.0, 8: 121.0}])
    assert tat.sweep(cases=cases, rounds=2, log=lambda s: None) == []
    _scripted_times(monkeypatch, [{2: 100.0, 1: 90.0, 8: 120.0},
                                  {2: 102.0, 1: 91.0, 8: 121.0}])
    got = tat.sweep(cases=cases, rounds=2, log=lambda s: None)
    assert [(e["tile"], e["us"], e["us_default"]) for e in got] == \
        [(1, 90.0, 100.0)]


def test_sweep_pins_the_default_where_the_lookup_would_not(monkeypatch):
    """A shape where the default held gets an entry only if the nearest
    recorded shape's knob would launch another plan there."""
    plans = {2: "two", 1: "one", 3: "two", 4: "four"}

    def cases(*ns):
        return [c for n in ns for c in _fake_cases(
            plans, {}, "probe_centroids", {"n": n, "k": 16, "p": 4})]
    wins = {2: 100.0, 1: 50.0, 4: 100.0}
    holds = {2: 100.0, 1: 100.0, 4: 100.0}
    # 1,024 would take 10^4's knob 1 and is pinned; 64 then takes 1,024's
    _scripted_times(monkeypatch, [wins, holds, holds])
    got = tat.sweep(cases=cases(10_000, 1024, 64), rounds=1,
                    log=lambda s: None)
    assert sorted((e["shape"]["n"], e["tile"]) for e in got) == \
        [(1024, 2), (10_000, 1)]
    _scripted_times(monkeypatch, [wins, holds])
    got = tat.sweep(cases=cases(10_000, 64), rounds=1, log=lambda s: None)
    assert sorted((e["shape"]["n"], e["tile"]) for e in got) == \
        [(64, 2), (10_000, 1)]


def test_sweep_raises_when_a_knob_changes_the_outputs(monkeypatch):
    monkeypatch.setattr(tat, "time_us", lambda *a, **k: 1.0)
    cases = _fake_cases({2: "a", 1: "b", 4: "c", 8: "a", 16: "a"}, {4: 1})
    with pytest.raises(AssertionError, match=r"knobs \[4\]"):
        tat.sweep(cases=cases, log=lambda s: None)


def test_defaults_are_todays_constants(no_table):
    assert tat.DEFAULT_TILE == {
        "ivf_scan_grouped": kgrp.CTAS_PER_SM,
        "probe_centroids": kca._CTAS_PER_SM}
    assert set(tat.SWEEP_TILES) == set(tat.DEFAULT_TILE) == set(tat.KNOBS)
    for kernel, grid in tat.SWEEP_TILES.items():
        assert grid[0] == tat.DEFAULT_TILE[kernel]
        assert tat.best_tile(kernel, "cuda", {"q": 64}) == grid[0]


class _Launched(Exception):
    pass


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __getattr__(self, name):
        return _FakeFn()


def _launched_args(monkeypatch, call, sms=132):
    seen = {}

    def fake_launch(name, fn, dev, *args):
        seen["args"] = args
        raise _Launched(name)
    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(_build, "sm_count", lambda index: sms)
    with pytest.raises(_Launched):
        call()
    return seen["args"]


def _wrapper_cases():
    """(kernel, shape of the table lookup, call(knob), plan(knob) -> the
    ints the launcher receives last)."""
    nq, T, topk, bl, sms = 64, 160, 10, 8, 132
    k, p = 16_384, 16
    return [
        ("ivf_scan_grouped", {"q": nq, "U": 8 * T, "topk": topk},
         lambda c: kgrp.ivf_scan_grouped(
             torch.zeros(nq, 8), torch.zeros(16, 8),
             torch.zeros(16, dtype=torch.int32),
             torch.zeros((nq // 8, 8 * T), dtype=torch.int32),
             torch.zeros((nq, 8 * T), dtype=torch.int32), block_rows=bl,
             topk=topk, raw=True, ctas_per_sm=c),
         lambda c: (kgrp.split_plan(nq // 8, 8 * T, topk, sms, c).splits,)),
        ("probe_centroids", {"n": nq, "k": k, "p": p},
         lambda c: kca.probe_centroids(torch.zeros(nq, 8), torch.zeros(k, 8),
                                       p, ctas_per_sm=c),
         lambda c: tuple(kca.split_plan(nq, k, p, sms, c)[:3])),
    ]


@pytest.mark.parametrize("case", range(len(_wrapper_cases())),
                         ids=[c[0] for c in _wrapper_cases()])
def test_wrapper_without_table_keeps_todays_plan(monkeypatch, no_table,
                                                 case):
    """No table: the wrapper launches the plan of today's constant; an
    explicit knob launches its own plan."""
    kernel, shape, call, plan = _wrapper_cases()[case]
    args = _launched_args(monkeypatch, lambda: call(None))
    want = plan(tat.DEFAULT_TILE[kernel])
    assert tuple(args[-len(want):]) == want
    for knob in tat.SWEEP_TILES[kernel][1:]:
        args = _launched_args(monkeypatch, lambda: call(knob))
        assert tuple(args[-len(want):]) == plan(knob)


@pytest.mark.parametrize("case", range(len(_wrapper_cases())),
                         ids=[c[0] for c in _wrapper_cases()])
def test_wrapper_launches_the_tables_knob(monkeypatch, case):
    """With the committed table the wrapper launches the plan of the
    table's knob for its shape."""
    tat.load_table.cache_clear()
    kernel, shape, call, plan = _wrapper_cases()[case]
    knob = tat.best_tile(kernel, "cuda", shape)
    args = _launched_args(monkeypatch, lambda: call(None))
    want = plan(knob)
    assert tuple(args[-len(want):]) == want


def test_committed_table_is_the_cards():
    tat.load_table.cache_clear()
    entries = tat.load_table()
    assert os.path.exists(tat.TABLE_FILE) and entries
    assert {e["backend"] for e in entries} == {"cuda"}
    assert {e["kernel"] for e in entries} == set(tat.SWEEP_TILES)
    for e in entries:
        assert e["tile"] in tat.SWEEP_TILES[e["kernel"]]
        assert e["us"] <= e["us_default"]
    src = os.path.dirname(tat.__file__)
    for kernel in _build.KERNELS:
        if kernel in tat.SWEEP_TILES:
            continue
        text = open(os.path.join(src, f"{kernel}.py")).read()
        assert f"# autotune: exempt({kernel}): " in text, kernel
