"""Layer 1 — AST idiom linter of the port: host-sync discipline and the
kernel registry, static.

Counterpart of ``repro.analysis.astlint``.  The runtime layer measures the
port's discipline (``obs.syncs.sync_counter`` counts host syncs,
``chip_smoke.py`` holds each kernel against its plain version) on the paths
a test or a card run takes; these rules state the same claims for every
line of ``src/repro_torch/``:

  ``sync-idiom``      ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
                      builtin ``float``/``int``/``bool`` of an expression
                      holding a call, and ``torch.cuda.synchronize`` in a
                      device-resident module (``core/engine.py``,
                      ``core/graph_build.py``, ``core/distributed.py``,
                      ``core/comm.py``, ``core/permute.py``,
                      ``index/probe.py``, ``kernels/*.py`` but
                      ``_build.py`` and ``autotune.py``): each is a
                      device-to-host read that would break the
                      ``epochs + 1`` syncs of a run and the 0 of a build or
                      a search.  A designed read goes through
                      ``obs.syncs.read`` (its result, and a name bound to
                      it, may be converted freely); any other sanctioned
                      crossing carries ``# lint: boundary(<why>)`` on its
                      line or the comment line above.
  ``permute-in-core`` ``torch.randperm`` in core/kernels/index outside
                      ``core/permute.py``: the Feistel permutation there is
                      the port's shuffle (its draws replay the reference's).
  ``wallclock``       ``time.time``/``perf_counter``/``monotonic`` in
                      core/kernels/index/obs outside ``obs/timing.py``
                      (and ``kernels/_build.py``, which times ``nvcc``).
  ``kernel-registry`` every kernel ``_build.KERNELS`` names has a wrapper in
                      ``kernels/`` that launches it through
                      ``_build.launch`` from a library whose ``csrc/*.cu``
                      holds a ``__global__`` entry, a dispatch in
                      ``ops.py``, a plain version in ``ref.py``, a
                      ``launch/roofline.py`` ``KERNEL_INVENTORY`` entry, a
                      ``check_*`` in ``chip_smoke.py`` that calls it, and
                      either an autotune table entry (a ``SWEEP_TILES``
                      grid with >= 1 entry in ``autotune_table.json``) or
                      ``# autotune: exempt(<kernel>): <reason>`` in its
                      wrapper module.
  ``exempt-missing``  a template-exempt pattern that matches no file.

The port's LLM-template code (``models/*.py``) is reported as ``exempt:
template`` and not linted, as the reference exempts its LLM subtree.

Every path is configurable through ``LintConfig`` so the fixture tests run
the same rules over planted-violation trees.  CLI: ``python -m
repro_torch.analysis lint [--root DIR]``.
"""
from __future__ import annotations

import ast
import fnmatch
import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # config.root-relative, posix separators
    line: int
    message: str

    def key(self) -> str:
        """Baseline key: line-free so unrelated edits don't churn it."""
        return f"{self.rule}:{self.path}:{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

PKG = "src/repro_torch"

# modules whose work stays on the device between the designed reads
DEVICE_MODULES = tuple(f"{PKG}/{p}" for p in (
    "core/engine.py", "core/graph_build.py", "core/distributed.py",
    "core/comm.py", "core/permute.py", "index/probe.py", "kernels/*.py"))
# host-side build and table lookup, not device work
DEVICE_EXCLUDE = (f"{PKG}/kernels/_build.py", f"{PKG}/kernels/autotune.py")

PERMUTE_SCOPE = (f"{PKG}/core/*.py", f"{PKG}/kernels/*.py",
                 f"{PKG}/index/*.py")
PERMUTE_SANCTIONED = (f"{PKG}/core/permute.py",)

TIME_SCOPE = (f"{PKG}/core/*.py", f"{PKG}/kernels/*.py", f"{PKG}/index/*.py",
              f"{PKG}/obs/*.py")
TIME_SANCTIONED = (f"{PKG}/obs/timing.py", f"{PKG}/kernels/_build.py")

# LLM-template code: reported "exempt: template", never linted.  Every
# pattern must still match >= 1 file (exempt-missing fires otherwise).
TEMPLATE_EXEMPT = (f"{PKG}/models/*.py",)

BOUNDARY_MARK = "lint: boundary"
EXEMPT_MARK = "autotune: exempt"


@dataclass
class RegistryConfig:
    """Paths the kernel-registry rule cross-references (root-relative)."""
    kernels_glob: str = f"{PKG}/kernels/*.py"
    # not wrappers: dispatch, plain versions, build, table
    kernels_skip: Tuple[str, ...] = ("__init__.py", "ops.py", "ref.py",
                                     "autotune.py", "_build.py")
    build_file: str = f"{PKG}/kernels/_build.py"
    csrc_dir: str = f"{PKG}/kernels/csrc"
    ops_file: str = f"{PKG}/kernels/ops.py"
    ref_file: str = f"{PKG}/kernels/ref.py"
    roofline_file: str = f"{PKG}/launch/roofline.py"
    smoke_file: str = "chip_smoke.py"
    autotune_file: str = f"{PKG}/kernels/autotune.py"
    table_file: str = f"{PKG}/kernels/autotune_table.json"


@dataclass
class LintConfig:
    root: str = "."
    device_modules: Tuple[str, ...] = DEVICE_MODULES
    device_exclude: Tuple[str, ...] = DEVICE_EXCLUDE
    permute_scope: Tuple[str, ...] = PERMUTE_SCOPE
    permute_sanctioned: Tuple[str, ...] = PERMUTE_SANCTIONED
    time_scope: Tuple[str, ...] = TIME_SCOPE
    time_sanctioned: Tuple[str, ...] = TIME_SANCTIONED
    template_exempt: Tuple[str, ...] = TEMPLATE_EXEMPT
    registry: Optional[RegistryConfig] = field(default_factory=RegistryConfig)


def _matches(rel: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(rel, p) for p in patterns)


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# --------------------------------------------------------------------------
# per-file idiom rules
# --------------------------------------------------------------------------

_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "perf_counter", "monotonic"}
_READS = {"read", "syncs.read", "obs.syncs.read"}


def _line_has(src_lines: List[str], lineno: int, mark: str) -> bool:
    """Marker on the flagged line, or a comment line directly above it."""
    if not 0 < lineno <= len(src_lines):
        return False
    if mark in src_lines[lineno - 1]:
        return True
    prev = src_lines[lineno - 2].strip() if lineno >= 2 else ""
    return prev.startswith("#") and mark in prev


def _is_read(node: ast.AST, host: Set[str] = frozenset()) -> bool:
    """``syncs.read(...)``, a name bound to one (``host``), or a subscript,
    attribute or method call on either: a value already on the host."""
    while True:
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and _dotted(node.func) not in _READS):
            node = node.func.value
        else:
            break
    if isinstance(node, ast.Name):
        return node.id in host
    return isinstance(node, ast.Call) and _dotted(node.func) in _READS


def _host_names(tree: ast.AST) -> Set[str]:
    """Names the module binds to a designed read's result."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _is_read(node.value)):
            out.add(node.targets[0].id)
    return out


def _holds_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) for n in ast.walk(node))


def lint_file(rel: str, source: str, cfg: LintConfig) -> List[Finding]:
    """Idiom rules (sync-idiom / permute-in-core / wallclock) for one file."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("parse-error", rel, e.lineno or 0, str(e.msg))]
    lines = source.splitlines()
    device = (_matches(rel, cfg.device_modules)
              and not _matches(rel, cfg.device_exclude))
    permute = (_matches(rel, cfg.permute_scope)
               and not _matches(rel, cfg.permute_sanctioned))
    wallclock = (_matches(rel, cfg.time_scope)
                 and not _matches(rel, cfg.time_sanctioned))
    host = _host_names(tree) if device else set()
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        ln = node.lineno
        if device and not _line_has(lines, ln, BOUNDARY_MARK):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args
                    and not _is_read(node.func.value, host)):
                out.append(Finding(
                    "sync-idiom", rel, ln,
                    f".{node.func.attr}() forces a device->host sync"))
            elif name in _SYNC_CALLS:
                out.append(Finding("sync-idiom", rel, ln,
                                   f"{name}() blocks the host on the device"))
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and len(node.args) == 1 and _holds_call(node.args[0])
                  and not _is_read(node.args[0], host)):
                out.append(Finding(
                    "sync-idiom", rel, ln,
                    f"builtin {node.func.id}() of a computed value forces a "
                    "device->host sync"))
        if permute and name in ("torch.randperm", "randperm"):
            out.append(Finding(
                "permute-in-core", rel, ln,
                "torch.randperm outside core/permute.py; use its Feistel "
                "permutation"))
        if wallclock and name in _TIME_CALLS:
            out.append(Finding(
                "wallclock", rel, ln,
                f"{name}() outside obs/timing.py; use obs.timing.span"))
    return out


# --------------------------------------------------------------------------
# kernel-registry rule (whole-tree, static cross-reference)
# --------------------------------------------------------------------------


def _parse(path: str) -> Optional[ast.Module]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ast.parse(f.read())


def _top_level_defs(tree: Optional[ast.Module]) -> Dict[str, ast.AST]:
    if tree is None:
        return {}
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _assigned(tree: Optional[ast.Module], name: str) -> Optional[ast.AST]:
    for node in (tree.body if tree is not None else ()):
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                return node.value
    return None


def _str_items(node: Optional[ast.AST]) -> List[str]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    if isinstance(node, ast.Dict):
        return [k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)]
    return []


def _launches(fn: ast.AST) -> List[str]:
    """Kernel names a def launches through ``_build.launch("<name>", ...)``."""
    out = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and _dotted(node.func) in ("_build.launch", "launch")
                and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(node.args[0].value)
    return out


def _libraries(tree: ast.Module) -> Set[str]:
    """Sources a module loads through ``_build.library("<source>")``."""
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and _dotted(node.func) in ("_build.library", "library")
            and node.args and isinstance(node.args[0], ast.Constant)}


def _mentions(fn: ast.AST, name: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == name:
            return True
        if isinstance(node, ast.Name) and node.id == name:
            return True
    return False


def _table_kernels(table_path: str) -> Set[str]:
    if not os.path.exists(table_path):
        return set()
    with open(table_path) as f:
        doc = json.load(f)
    return {e["kernel"] for e in doc.get("entries", ())}


def lint_registry(cfg: LintConfig) -> List[Finding]:
    reg = cfg.registry
    if reg is None:
        return []
    root = cfg.root

    def j(p):
        return os.path.join(root, p)
    kernels = _str_items(_assigned(_parse(j(reg.build_file)), "KERNELS"))
    ops_defs = _top_level_defs(_parse(j(reg.ops_file)))
    ref_defs = _top_level_defs(_parse(j(reg.ref_file)))
    inventory = set(_str_items(_assigned(_parse(j(reg.roofline_file)),
                                         "KERNEL_INVENTORY")))
    checks = {n: fn for n, fn in _top_level_defs(
        _parse(j(reg.smoke_file))).items() if n.startswith("check_")}
    sweep = set(_str_items(_assigned(_parse(j(reg.autotune_file)),
                                     "SWEEP_TILES")))
    tuned = _table_kernels(j(reg.table_file))

    # wrappers: kernel -> (module rel path, line, module source, sources)
    wrappers: Dict[str, Tuple[str, int, str, Set[str]]] = {}
    for path in sorted(glob.glob(j(reg.kernels_glob))):
        if os.path.basename(path) in reg.kernels_skip:
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path) as f:
            src = f.read()
        tree = ast.parse(src)
        libs = _libraries(tree)
        for fn in _top_level_defs(tree).values():
            for k in _launches(fn):
                if k == fn.name:
                    wrappers[k] = (rel, fn.lineno, src, libs)

    out: List[Finding] = []
    build_rel = reg.build_file
    for kernel in kernels:
        if kernel not in wrappers:
            out.append(Finding(
                "kernel-registry", build_rel, 0,
                f"kernel {kernel!r} has no wrapper def {kernel!r} in "
                f"{reg.kernels_glob} launching through _build.launch"))
            continue
        rel, ln, src, libs = wrappers[kernel]

        def miss(what, rel=rel, ln=ln, kernel=kernel):
            out.append(Finding("kernel-registry", rel, ln,
                               f"kernel {kernel!r} has no {what}"))
        globals_ok = False
        for lib in libs:
            cu = j(os.path.join(reg.csrc_dir, f"{lib}.cu"))
            if os.path.exists(cu) and "__global__" in open(cu).read():
                globals_ok = True
        if not globals_ok:
            miss(f"__global__ entry in {reg.csrc_dir}/<source>.cu")
        if kernel not in ops_defs:
            miss(f"dispatch in {reg.ops_file}")
        if kernel not in ref_defs:
            miss(f"plain version in {reg.ref_file}")
        if kernel not in inventory:
            miss(f"KERNEL_INVENTORY entry ({reg.roofline_file})")
        if not any(_mentions(fn, kernel) for fn in checks.values()):
            miss(f"check_* in {reg.smoke_file} that calls it")
        if kernel in sweep:
            if kernel not in tuned:
                miss(f"{reg.table_file} entry (run the autotune sweep)")
        elif f"{EXEMPT_MARK}({kernel})" not in src:
            out.append(Finding(
                "kernel-registry", rel, ln,
                f"kernel {kernel!r} is neither in SWEEP_TILES nor marked "
                f"'# {EXEMPT_MARK}({kernel}): <reason>'"))
    return out


# --------------------------------------------------------------------------
# tree walk + entry point
# --------------------------------------------------------------------------


def _py_files(root: str) -> List[str]:
    base = os.path.join(root, PKG)
    return sorted(os.path.relpath(p, root).replace(os.sep, "/")
                  for p in glob.glob(os.path.join(base, "**", "*.py"),
                                     recursive=True)
                  if "__pycache__" not in p)


def run_lint(cfg: LintConfig) -> Tuple[List[Finding], List[str]]:
    """All findings + the template-exempt file list (reported, not linted)."""
    findings: List[Finding] = []
    exempt: List[str] = []
    for pat in cfg.template_exempt:
        if not glob.glob(os.path.join(cfg.root, pat)):
            findings.append(Finding(
                "exempt-missing", pat, 0,
                "template-exempt pattern matches no files; prune the list"))
    for rel in _py_files(cfg.root):
        if _matches(rel, cfg.template_exempt):
            exempt.append(rel)
            continue
        with open(os.path.join(cfg.root, rel)) as f:
            findings.extend(lint_file(rel, f.read(), cfg))
    findings.extend(lint_registry(cfg))
    return findings, exempt


def default_root() -> str:
    """The checkout this package lies in (holds ``src/repro_torch``)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def check(root: Optional[str] = None, baseline: Optional[str] = None,
          log=print) -> Tuple[List[Finding], List[str]]:
    """Lint the tree and compare it with the baseline -> (findings,
    problems); each line goes to ``log``."""
    from repro_torch.analysis import baseline as bl
    findings, exempt = run_lint(LintConfig(root=root or default_root()))
    for f in findings:
        log(str(f))
    log(f"lint: {len(findings)} finding(s), {len(exempt)} file(s) exempt: "
        "template")
    problems = bl.compare(sorted({f.key() for f in findings}),
                          bl.load(baseline).get("lint", []), section="lint")
    for p in problems:
        log(p)
    return findings, problems


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="AST idiom linter of the port (repro_torch.analysis "
                    "layer 1)")
    ap.add_argument("--root", default=None,
                    help="repo root (holds src/repro_torch and chip_smoke.py;"
                         " default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: the checked-in one)")
    args = ap.parse_args(argv)
    _, problems = check(args.root, args.baseline)
    print("lint: FAIL" if problems else "lint: OK")
    return 1 if problems else 0
