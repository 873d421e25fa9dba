"""CLI: ``python -m repro_torch.analysis {lint,audit} [...]``.

``lint`` checks the tree against ``baseline.json``; ``audit`` runs the
contract audit in process (through a ``RecordingComm``) on the card, or
with ``--device cpu`` on the CPU, and, with ``--gloo``, again in a spawned
gloo group of four ranks on the CPU, which must count the same.
"""
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else ""
    if cmd == "lint":
        from repro_torch.analysis.astlint import main as lint_main
        return lint_main(argv[1:])
    if cmd == "audit":
        from repro_torch.analysis.contracts import main as audit_main
        return audit_main(argv[1:])
    print("usage: python -m repro_torch.analysis {lint,audit} [options]",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
