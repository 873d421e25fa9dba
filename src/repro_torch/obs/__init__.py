"""Observability of the port (counterpart of ``repro.obs``).

Device half (``obs.telemetry``): fixed-shape ``Telemetry`` rows that the
engine's ``run`` (one per epoch) and a graph build (one per round) fill on
the device and that reach the host with the reads those paths make anyway.
Host half: ``span`` / ``device_span`` timers and the kernel scopes
(``obs.timing``), the host-sync counter ``sync_counter()`` (``obs.syncs``),
and the ``repro.bench.v1`` run-record schema (``obs.emit``).
``launch/obs_report.py`` joins the records against the roofline inventory
of ``launch/roofline.py``.
"""
from repro_torch.obs import telemetry
from repro_torch.obs.emit import (SCHEMA, append_jsonl, load_dir,
                                  load_records, run_record, validate_record,
                                  write_json)
from repro_torch.obs.syncs import SyncCounter, sync_counter
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.timing import device_span, kernel_scope, span

__all__ = [
    "telemetry", "Telemetry",
    "SyncCounter", "sync_counter",
    "span", "device_span", "kernel_scope",
    "SCHEMA", "run_record", "write_json", "append_jsonl", "load_records",
    "load_dir", "validate_record",
]
