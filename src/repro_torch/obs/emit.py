"""Structured run records (counterpart of ``repro.obs.emit``).

A run record is a plain dict, the same ``repro.bench.v1`` schema as the
reference's, so a record written by either package loads and validates
under the other:

    {
      "schema":  "repro.bench.v1",
      "name":    "engine",               # what produced it
      "git_rev": "35f30c5" | "unknown",
      "env":     {"backend": "cuda", "devices": 1, "torch": "2.x", ...},
      "shapes":  {...},                  # problem sizes (n, d, k, ...)
      "config":  {...},                  # knobs (batch_size, nprobe, ...)
      "metrics": {...},                  # measured numbers
      "telemetry": {...},                # optional: obs.telemetry.to_dict
    }

``run_record`` builds one (stamping the git rev and the environment: on a
card also its name and power limit as ``nvidia-smi`` gives them),
``write_json`` / ``append_jsonl`` persist it, ``load_records`` reads either
layout back, and ``validate_record`` is the schema gate that
``launch/obs_report.py`` fails on.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict, Iterable, List, Optional

import torch

SCHEMA = "repro.bench.v1"
# static-analysis reports share the record layout and the validation gate
# but carry their own schema tag
ANALYSIS_SCHEMA = "repro.analysis.v1"
SCHEMAS = (SCHEMA, ANALYSIS_SCHEMA)
REQUIRED_KEYS = ("schema", "name", "git_rev", "env", "shapes", "config",
                 "metrics")


def git_rev() -> str:
    """Short git rev of the working tree, or 'unknown' outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _smi() -> Optional[str]:
    """The first card's ``name, power.limit`` line from ``nvidia-smi``, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _env() -> Dict[str, Any]:
    cuda = torch.cuda.is_available()
    env: Dict[str, Any] = {"backend": "cuda" if cuda else "cpu",
                           "devices": torch.cuda.device_count() if cuda
                           else 1,
                           "torch": torch.__version__}
    if cuda:
        env["device"] = torch.cuda.get_device_name(0)
        env["nvidia_smi"] = _smi()
    return env


def run_record(name: str, *, shapes: Optional[Dict[str, Any]] = None,
               config: Optional[Dict[str, Any]] = None,
               metrics: Optional[Dict[str, Any]] = None,
               telemetry: Optional[Dict[str, Any]] = None,
               notes: Optional[List[str]] = None,
               schema: str = SCHEMA) -> Dict[str, Any]:
    """Assemble a schema-conforming run record (values must be JSON-able)."""
    rec: Dict[str, Any] = {
        "schema": schema,
        "name": name,
        "git_rev": git_rev(),
        "env": _env(),
        "shapes": dict(shapes or {}),
        "config": dict(config or {}),
        "metrics": dict(metrics or {}),
    }
    if telemetry:
        rec["telemetry"] = dict(telemetry)
    if notes:
        rec["notes"] = list(notes)
    return rec


def validate_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ``ValueError`` on schema drift; return the record unchanged."""
    if not isinstance(rec, dict):
        raise ValueError(f"run record must be a dict, got {type(rec)}")
    missing = [k for k in REQUIRED_KEYS if k not in rec]
    if missing:
        raise ValueError(f"run record missing keys {missing}: "
                         f"have {sorted(rec)}")
    if rec["schema"] not in SCHEMAS:
        raise ValueError(f"schema {rec['schema']!r} not in known {SCHEMAS}")
    for k in ("shapes", "config", "metrics"):
        if not isinstance(rec[k], dict):
            raise ValueError(f"run record [{k!r}] must be a dict")
    return rec


def write_json(path: str, rec: Dict[str, Any]) -> None:
    """Write one validated record as a pretty JSON file (BENCH_*.json)."""
    validate_record(rec)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=False)
        f.write("\n")


def append_jsonl(path: str, rec: Dict[str, Any]) -> None:
    """Append one validated record as a JSONL line (run logs)."""
    validate_record(rec)
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=False) + "\n")


def load_records(path: str) -> List[Dict[str, Any]]:
    """Read records back from a ``.json`` (one record) or ``.jsonl`` file.

    Every record is validated; a drifted file raises rather than yielding
    partial garbage.
    """
    recs: List[Dict[str, Any]] = []
    with open(path) as f:
        text = f.read()
    if path.endswith(".jsonl"):
        for line in text.splitlines():
            if line.strip():
                recs.append(validate_record(json.loads(line)))
    else:
        recs.append(validate_record(json.loads(text)))
    return recs


def load_dir(directory: str, prefix: str = "BENCH_"
             ) -> Dict[str, Dict[str, Any]]:
    """All ``<prefix>*.json`` records in a directory, keyed by record name."""
    out: Dict[str, Dict[str, Any]] = {}
    for fn in sorted(os.listdir(directory)):
        if fn.startswith(prefix) and fn.endswith(".json"):
            for rec in load_records(os.path.join(directory, fn)):
                out[rec["name"]] = rec
    return out


def emit_stdout(recs: Iterable[Dict[str, Any]]) -> None:
    """Print records as JSONL to stdout (pipe-friendly)."""
    for rec in recs:
        print(json.dumps(validate_record(rec), sort_keys=False))
