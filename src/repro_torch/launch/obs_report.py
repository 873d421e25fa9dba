"""Observability report: measured run records vs the roofline inventory
(counterpart of ``repro.launch.obs_report``).

Joins the ``repro.bench.v1`` run records (``obs.emit``) in a directory
against ``launch.roofline.KERNEL_INVENTORY``:

  * kernel table — each measured kernel's microseconds per call vs the
    bound for its recorded shape (compute vs HBM term, whichever binds),
    with the achieved fraction (bound / measured: at most 1);
  * per-phase breakdown — the per-epoch / per-round telemetry rows of each
    record (engine epochs, graph-build rounds).

It is also the schema gate: a ``BENCH_*.json`` that drifted from the
schema, a timed kernel missing from ``KERNEL_INVENTORY`` (or a shape that
does not name its arguments), and any name in ``--require`` that is absent
all exit nonzero.  A ``--require`` token matches either a whole record
(``BENCH_<name>.json``) or a single measured kernel inside the ``kernels``
record, whose entries are ``{"kernel", "shape": {argument: value}, "us"}``.
The ``tile`` and ``rowwise_x`` columns show an entry's ``tile`` and
``us_rowwise`` where it has them, else "-".

CLI::

    python -m repro_torch.launch.obs_report [--dir .] \\
        [--require kernels engine gather_score]
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from repro_torch.launch.roofline import KERNEL_INVENTORY, kernel_terms
from repro_torch.obs import emit


class ReportError(RuntimeError):
    """Schema drift / inventory gap — the failing condition."""


def _fmt_table(header: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]

    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    rule = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), rule] + [line(r) for r in rows])


def kernel_rows(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One dict per measured kernel of a ``kernels`` record: kernel,
    shape, measured_us, roofline_us, bottleneck, achieved_frac."""
    entries = rec["metrics"].get("kernels", [])
    if not entries:
        raise ReportError("kernels record has no metrics['kernels'] entries")
    out = []
    for e in entries:
        name = e["kernel"]
        if name not in KERNEL_INVENTORY:
            raise ReportError(
                f"measured kernel {name!r} has no KERNEL_INVENTORY entry")
        try:
            terms = kernel_terms(name, **e["shape"])
        except TypeError as err:
            raise ReportError(f"kernel {name!r}: shape {e['shape']} does not "
                              f"name the inventory's arguments ({err})")
        bound_us = terms["bound_s"] * 1e6
        meas_us = float(e["us"])
        out.append(dict(entry=e, kernel=name, shape=e["shape"],
                        measured_us=meas_us, roofline_us=bound_us,
                        bottleneck=terms["bottleneck"],
                        achieved_frac=(bound_us / meas_us if meas_us > 0
                                       else 0.0)))
    return out


def kernel_table(rec: Dict[str, Any]) -> str:
    """Measured-vs-analytic roofline table from a ``kernels`` record."""
    rows = []
    for r in kernel_rows(rec):
        e = r["entry"]
        dims = ",".join(f"{k}={v}" for k, v in r["shape"].items())
        tile = str(e["tile"]) if "tile" in e else "-"
        roww = (f"{float(e['us_rowwise']) / r['measured_us']:.2f}x"
                if e.get("us_rowwise") and r["measured_us"] > 0 else "-")
        rows.append([r["kernel"], dims, f"{r['measured_us']:.1f}",
                     f"{r['roofline_us']:.2f}", r["bottleneck"],
                     f"{r['achieved_frac']:.4f}", tile, roww])
    return _fmt_table(
        ["kernel", "shape", "measured_us", "roofline_us", "bound",
         "achieved_frac", "tile", "rowwise_x"], rows)


def phase_table(rec: Dict[str, Any]) -> str:
    """Per-row telemetry breakdown of one record (epoch/round/batch)."""
    tel = rec.get("telemetry") or {}
    slots = [s for s, vals in tel.items() if vals]
    if not slots:
        return "(no telemetry section)"
    n_rows = len(tel[slots[0]])
    rows = []
    for t in range(n_rows):
        cells = [str(t)]
        for s in slots:
            v = tel[s][t]
            cells.append(f"{v:.4f}" if isinstance(v, float) else str(v))
        rows.append(cells)
    return _fmt_table(["row"] + slots, rows)


def render(recs: Dict[str, Dict[str, Any]]) -> str:
    out = []
    if "kernels" in recs:
        out.append("== kernel roofline (measured vs analytic) ==")
        out.append(kernel_table(recs["kernels"]))
        out.append("")
    for name, rec in sorted(recs.items()):
        if name == "kernels":
            continue
        out.append(f"== {name} [{rec['git_rev']} "
                   f"{rec['env'].get('backend')}x"
                   f"{rec['env'].get('devices')}] ==")
        m = rec["metrics"]
        flat = [k for k, v in m.items() if isinstance(v, (int, float, bool))]
        for k in flat:
            out.append(f"  {k} = {m[k]}")
        tele = phase_table(rec)
        if tele != "(no telemetry section)":
            out.append("  per-phase telemetry:")
            out.append("\n".join("    " + ln for ln in tele.splitlines()))
        out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=".",
                    help="directory holding BENCH_*.json run records")
    ap.add_argument("--require", nargs="*", default=[],
                    help="record names — or measured kernel names inside the "
                         "kernels record — that must be present")
    args = ap.parse_args(argv)

    try:
        recs = emit.load_dir(args.dir)
    except ValueError as e:                 # schema drift
        print(f"obs_report: schema error: {e}", file=sys.stderr)
        return 1
    timed_kernels = {e["kernel"]
                     for e in (recs.get("kernels", {})
                               .get("metrics", {}).get("kernels", []))}
    missing = [r for r in args.require
               if r not in recs and r not in timed_kernels]
    if missing:
        print(f"obs_report: required records missing: {missing} "
              f"(have records {sorted(recs)}, kernels "
              f"{sorted(timed_kernels)})", file=sys.stderr)
        return 1
    if not recs:
        print(f"obs_report: no BENCH_*.json records in {args.dir!r}",
              file=sys.stderr)
        return 1
    try:
        print(render(recs))
    except ReportError as e:
        print(f"obs_report: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
