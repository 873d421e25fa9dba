"""The paper's configs, the roofline's collective term, the collective
accounting and the clustering dry run of the port, against the reference.

- ``repro_torch.configs.gkmeans_paper`` equals ``repro.configs.
  gkmeans_paper`` field by field;
- ``launch.roofline.roofline_terms`` equals the reference's once its rates
  (peak, HBM, three ICI links) are injected;
- ``core.comm.collective_counter``'s operand and wire bytes equal the
  reference's HLO model (``repro.launch.roofline.collective_bytes``) for
  each kind, on HLO lines of the same collectives;
- the dry run's analytic flops and bytes equal the reference's formula,
  read out of ``src/repro/launch/dryrun_cluster.py`` (which is not imported:
  it sets a 512-device XLA flag at import), at all 24 cells; a traced cell
  finds what the dry run reports; ``MemoryTally`` counts what the ops hold.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import gkmeans_paper as jcfg
from repro.launch import roofline as jrl
from repro_torch.configs import gkmeans_paper as tcfg
from repro_torch.core.comm import RecordingComm, collective_counter
from repro_torch.launch import dryrun_cluster as dry
from repro_torch.launch import roofline as trl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("SIFT1M", "VLAD10M", "GLOVE1M", "GIST1M", "SIFT_SMALL", "VLAD_SMALL")


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_reference(name):
    got, want = getattr(tcfg, name), getattr(jcfg, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(tcfg.ClusterConfig)] == [
        f.name for f in dataclasses.fields(jcfg.ClusterConfig)]


def test_roofline_terms_equal_reference_with_its_rates():
    rng = np.random.default_rng(0)
    link = jrl.ICI_BW * 3
    for _ in range(200):
        fl, hb, coll = (10.0 ** rng.uniform(6, 15, 3)).tolist()
        want = jrl.roofline_terms(fl, hb, coll)
        got = trl.roofline_terms(fl, hb, coll, peak=jrl.PEAK_FLOPS,
                                 hbm=jrl.HBM_BW, link=link)
        for key in ("compute_s", "memory_s", "collective_s",
                    "roofline_fraction"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        assert got["bottleneck"] == want["bottleneck"]
    t = trl.roofline_terms(1.0, 1.0, 1e12, link=trl.link_rate(512))
    assert t["bottleneck"] == "collective"
    assert t["collective_s"] == 1e12 / trl.NDR_BYTES_PER_S
    assert trl.link_rate(8) == trl.NVLINK_BYTES_PER_S


def test_counter_bytes_equal_reference_model():
    """One all-gather of (2, 16) f32, one all-reduce of (8, 16) and one
    all-to-all of (8, 16) on 4 ranks, against the reference's parser of the
    same collectives' HLO lines."""
    hlo = "\n".join([
        "%ag = f32[8,16]{1,0} all-gather(f32[2,16]{1,0} %p), "
        "replica_groups=[1,4]<=[4], dimensions={0}",
        "%ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %q), "
        "replica_groups=[1,4]<=[4], to_apply=%add",
        "%aa = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %r), "
        "replica_groups=[1,4]<=[4], dimensions={0}"])
    want = jrl.collective_bytes(hlo)
    comm = RecordingComm(1, 4, "cpu")
    with collective_counter() as cc:
        comm.all_gather(torch.zeros(2, 16))
        comm.psum(torch.zeros(8, 16))
        comm.fsum_owned(torch.zeros(8, 16), 2)
    got = cc.summary()
    for kind in ("all-gather", "all-reduce", "all-to-all"):
        assert got[kind]["count"] == want[kind]["count"] == 1
        assert got[kind]["bytes"] == want[kind]["bytes"], kind
        assert got[kind]["wire_bytes"] == want[kind]["wire_bytes"], kind
    assert got["total_wire_bytes"] == want["total_wire_bytes"]


def test_recording_comm_returns_what_a_group_of_copies_would():
    comm = RecordingComm(2, 4, "cpu")
    x = torch.arange(12.0).view(4, 3)
    assert torch.equal(comm.all_gather(x), torch.cat([x] * 4))
    assert torch.equal(comm.psum(x), x)
    assert torch.equal(comm.fsum(x), 4 * x)
    # every rank holds x: rank 2's block summed over 4 ranks
    assert torch.equal(comm.fsum_owned(x, 1), 4 * x[2:3])
    with pytest.raises(ValueError, match="takes cpu"):
        comm.psum(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="rows"):
        comm.fsum_owned(x, 3)


def _reference_formula():
    """The reference dry run's WORKLOADS and its flops/bytes statements,
    read from its source."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun_cluster.py")
    tree = ast.parse(open(path).read())
    wl = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", "") == "WORKLOADS":
            wl = eval(compile(ast.Expression(node.value), path, "eval"),
                      {"dict": dict})
    stmts = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", "") in ("fl", "hb")]
    code = compile(ast.Module(body=stmts, type_ignores=[]), path, "exec")
    return wl, code


def test_analytic_flops_and_bytes_equal_reference_formula():
    wl, code = _reference_formula()
    assert wl == dry.WORKLOADS
    cells = 0
    for name, w in wl.items():
        for mode in dry.MODES:
            for R in dry.RANKS:
                env = dict(w=w, n_loc=w["n"] // R, kappa=w["kappa"],
                           d=w["d"], k=w["k"], mode=mode)
                exec(code, {}, env)
                assert dry.analytic(w, R, mode) == (env["fl"], env["hb"])
                cells += 2        # the move rule does not enter the formula
    assert cells == 24


def test_memory_tally_counts_live_outputs():
    tally = dry.MemoryTally("cpu")
    with tally:
        a = torch.zeros(1000)            # 4,000 bytes
        b = a[10:20]                     # a view: nothing new
        c = a + 1                        # 4,000
        del a
        d = torch.ones(500)              # 2,000: peak 10,000
        del c
        e = b.add_(1)                    # in place: nothing new
    assert tally.peak == 10_000
    assert tally.current == 6_000
    del b, d, e


def test_dry_run_cell_on_meta():
    """VLAD10M, dense, R = 512, traced on meta: the dense sync receives
    k·d·4·(R−1)/R (plus the counts' psum) a step, the exchange's (R·B,
    C, d) all-reduce binds, and the rank does not fit an 80 GB card."""
    rec = dry.run_cell("vlad10m", "dense", 512, "bkm")
    assert rec["status"] == "ok", rec.get("traceback")
    w = dry.WORKLOADS["vlad10m"]
    k, d, R, B = w["k"], w["d"], 512, w["batch"]
    steps = w["n"] // R // B
    assert rec["steps"] == steps == 5
    per = rec["collectives"]["per_step_wire_bytes"]
    assert per["dense_sync"] == pytest.approx(
        k * d * 4 * (R - 1) / R + 2 * k * 4 * (R - 1) / R)
    rows = R * B * (w["kappa"] + 1) * d * 4
    assert per["exchange"] == pytest.approx(
        2 * rows * (R - 1) / R + R * B * (w["kappa"] + 1) * 4 * (R - 1) / R)
    assert rec["roofline"]["bottleneck"] == "collective"
    assert rec["fits_80gb"] is False
    assert rec["memory"]["temp_bytes"] >= 2 * rows
    assert rec["memory"]["argument_bytes"] == (
        (w["n"] // R) * (d * 4 + w["kappa"] * 8 + 4) + (k // R) * d * 4
        + k * 4)


def test_dry_run_main_writes_every_sift1m_cell(tmp_path):
    out = str(tmp_path / "dry.json")
    assert dry.main(["--workload", "sift1m", "--out", out]) == 0
    recs = json.load(open(out))
    assert len(recs) == 12
    keys = {"status", "collectives", "memory", "flops_analytic",
            "hbm_bytes_analytic", "roofline", "fits_80gb"}
    for r in recs:
        assert keys <= set(r) and r["status"] == "ok"
        kinds = {kd for kd in ("all-gather", "all-reduce", "all-to-all")
                 if r["collectives"][kd]["count"]}
        assert ("all-to-all" in kinds) == (r["mode"] == "dense")
