"""Checked-in baseline of the port's static analysis: exact-match
semantics.

Counterpart of ``repro.analysis.baseline`` (the same schema).  The file
enumerates every accepted finding, one stable key per entry, and both
directions fail:

  * a finding NOT in the baseline -> new violation: fix it, or baseline it
    with a stated reason in review;
  * a baseline entry with no finding -> stale: the violation went, so the
    entry must go in the same change.  The baseline can only shrink
    silently, never grow.

``lint`` keys are ``astlint.Finding.key()`` strings; ``replication`` keys
are the contract audit's report entries (``contracts.py``): op outputs in a
rank's body whose leading dimension is a global size.  The shipped
``baseline.json`` has an empty lint section (the tree lints clean) and the
replication the port's sharded entry points have by design.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

SCHEMA = "repro.analysis.baseline.v1"
BASELINE_FILE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or BASELINE_FILE
    if not os.path.exists(path):
        return {"schema": SCHEMA, "lint": [], "replication": []}
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: expected schema {SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    return doc


def save(doc: Dict[str, Any], path: Optional[str] = None) -> None:
    doc = dict(doc, schema=SCHEMA)
    for k in ("lint", "replication"):
        doc[k] = sorted(set(doc.get(k, [])))
    with open(path or BASELINE_FILE, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def compare(found: Sequence[str], accepted: Sequence[str], *,
            section: str) -> List[str]:
    """Problem strings for new findings AND stale baseline entries."""
    found_s, accepted_s = set(found), set(accepted)
    problems = [f"{section}: NEW (not in baseline): {k}"
                for k in sorted(found_s - accepted_s)]
    problems += [f"{section}: STALE baseline entry (no longer found — "
                 f"delete it): {k}" for k in sorted(accepted_s - found_s)]
    return problems
