"""AST linter for the shared-memory protocol discipline in ``core/`` (the
JAX package's ``repro.analysis.lint_protocol``, pointed at the port).

The communication core's correctness rests on conventions no type
checker sees: every store to the shared pool must go through the
coherence protocol, every user-facing tag must stay out of the
reserved internal window, the progress engine must never block inside
a tick, and each matchbox entry field has exactly ONE writing side.
This module enforces those conventions mechanically, as five rules
over the ASTs of ``src/repro_torch/core``:

``LP001`` raw shared-region access
    Calls to the protocol-bypassing primitives (``raw_write`` /
    ``raw_read`` and direct ``.pool.write`` / ``.pool.read`` /
    ``.backing.write`` / ``.backing.read`` chains) are only legal
    inside the coherence layer itself (``coherence.py``, ``pool.py``).
    Elsewhere they need an explicit ``# lint: raw-ok (<why>)`` waiver
    on the line. The port's payloads may live on the card, which reaches
    the pool through its device-side primitives (``device_view``,
    ``tensor_view``, ``write_device``, ``read_device``, ``device_ptr``);
    those count as raw access too, on a ``.pool`` / ``.backing`` chain
    or on a pool object (a name bound, in the same file, to a
    ``*Pool(...)`` constructor, directly or through plain assignments).
    This is wider than the JAX package's rule, which has no device side.

``LP002`` reserved-tag validation
    Every PUBLIC send/recv surface that accepts a ``tag`` must
    (transitively) validate it against ``TAG_RESERVED_BASE`` — a
    surface that forwards user tags unchecked lets user traffic forge
    collective-round matches. The rule builds a call graph across all
    linted files (calls resolve by bare name; instantiating a class
    counts as reaching its methods, which is how ``send_init`` ->
    ``PersistentRequest.start`` -> ``isend`` validates) and runs a
    reachability fixpoint to the validation sites.

``LP003`` no blocking sleeps in tick paths
    ``progress.py`` runs cooperatively: every wait loop must tick the
    engine and may only yield (``time.sleep(0)``). Any sleep with a
    nonzero or non-literal argument would stall EVERY outstanding
    request on the rank.

``LP004`` matchbox single-writer discipline
    The 64-byte matchbox entry is split receiver-owned
    (``post_id``/``_MB_TAG``/``_MB_DEST``/``_MB_CAP``) and
    sender-owned (``_MB_CLAIM``/``_MB_FILL``) — the Dekker-style
    claim/retract handshake is only correct if each side stores only
    to its own fields. Every function that nt-stores a matchbox field
    must carry a ``# mb-writer: sender`` or ``# mb-writer: receiver``
    annotation on (or just above) its ``def`` line, and the stored
    fields must belong to the annotated side.

``LP005`` guarded, allocation-free trace emission
    The flight recorder (``core/trace.py``) is always compiled in;
    its disabled-mode cost budget is ONE predicate check per site. In
    the tick-path files (``progress.py``, ``pt2pt.py``) every
    ``emit(...)`` call must therefore sit lexically inside an ``if``
    whose test checks the ``.enabled`` predicate, and its arguments
    must be plain names/ints — no f-strings, dict/list/set displays,
    comprehensions or ``dict()`` calls, which would allocate eagerly
    on every pass even while tracing is off. The port's tracer also
    records spans and times the core's stream syncs; the same holds for
    each call of a span or sync-timing method (``_SPAN_CALLS``:
    ``open_span``, ``close_span``, ``mark``, ``synced`` ...) in the
    files that make them: the tick-path files and ``coherence.py``,
    ``pool.py`` and ``comm.py``. (``emit`` keeps the reference's scope,
    the tick-path files.)

CLI: ``python -m repro_torch.analysis.lint_protocol [paths...]``
(defaults to ``src/repro_torch/core``); prints ``path:line: LPxxx message`` per
finding and exits nonzero if any were found.
"""
from __future__ import annotations

import argparse
import ast
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["LintFinding", "lint_paths", "lint_sources"]

_RAW_FUNCS = {"raw_write", "raw_read"}
_RAW_CHAINS = {"pool", "backing"}          # .pool.write(...) etc.
# the device side of the pool: windows and pointers the card reads and
# writes through, and the two moves between a CUDA tensor and the pool
_RAW_DEVICE = {"device_view", "tensor_view", "write_device", "read_device",
               "device_ptr"}
_RAW_ALLOWED_FILES = {"coherence.py", "pool.py"}
_RAW_WAIVER = re.compile(r"#\s*lint:\s*raw-ok")

_SURFACE_RE = re.compile(r"^i?(send|recv)(_[a-z0-9_]+)?$")
_RESERVED_NAME = "TAG_RESERVED_BASE"

_TICK_FILES = {"progress.py"}

_MB_SENDER_FIELDS = {"_MB_CLAIM", "_MB_FILL"}
_MB_RECEIVER_FIELDS = {"_MB_TAG", "_MB_DEST", "_MB_CAP"}
_MB_WRITER = re.compile(r"#\s*mb-writer:\s*(sender|receiver)")

_TRACE_FILES = {"progress.py", "pt2pt.py"}
# the tracer's span and sync-timing methods, and the files that call them
_SPAN_CALLS = {"open_span", "open_child", "close_span", "push_span",
               "pop_span", "leave_span", "mark", "add_waits", "end_send",
               "dequeued", "recv_done", "staged", "ack_seen", "synced",
               "send_seq", "call_seq"}
_SPAN_FILES = _TRACE_FILES | {"coherence.py", "pool.py", "comm.py"}
_EMIT_ARG_BANNED = (ast.JoinedStr, ast.Dict, ast.DictComp, ast.ListComp,
                    ast.SetComp, ast.GeneratorExp)


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# --------------------------------------------------------------------------
# per-function facts for the cross-file call graph (LP002)
# --------------------------------------------------------------------------

@dataclass(eq=False)        # identity hash: distinct defs stay distinct
class _FuncInfo:
    name: str
    cls: str | None
    path: str
    line: int
    params: set
    calls: set            # bare names of everything this function calls
    validates: bool       # references TAG_RESERVED_BASE anywhere


def _called_names(tree: ast.AST) -> set:
    out = set()
    for nd in ast.walk(tree):
        if isinstance(nd, ast.Call):
            f = nd.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def _collect_funcs(path: str, tree: ast.Module, funcs: list,
                   classes: dict) -> None:
    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                classes.setdefault(child.name, set())
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                a = child.args
                params = {p.arg for p in (a.posonlyargs + a.args
                                          + a.kwonlyargs)}
                validates = any(
                    (isinstance(nd, ast.Name) and nd.id == _RESERVED_NAME)
                    or (isinstance(nd, ast.Attribute)
                        and nd.attr == _RESERVED_NAME)
                    for nd in ast.walk(child))
                funcs.append(_FuncInfo(child.name, cls, path,
                                       child.lineno, params,
                                       _called_names(child), validates))
                if cls is not None:
                    classes[cls].add(child.name)
                visit(child, cls)   # nested defs can also be surfaces

    visit(tree, None)


def _check_reserved_tags(funcs: list, classes: dict, out: list) -> None:
    by_name: dict = {}
    for f in funcs:
        by_name.setdefault(f.name, []).append(f)

    ok = {id(f) for f in funcs if f.validates}
    changed = True
    while changed:
        changed = False
        for f in funcs:
            if id(f) in ok:
                continue
            reach = set()
            for callee in f.calls:
                reach.update(by_name.get(callee, ()))
                # instantiating a class reaches its methods (the
                # request object the surface returns does the send)
                for m in classes.get(callee, ()):
                    reach.update(by_name.get(m, ()))
            if any(id(g) in ok for g in reach):
                ok.add(id(f))
                changed = True

    for f in funcs:
        if (not f.name.startswith("_") and _SURFACE_RE.match(f.name)
                and "tag" in f.params and id(f) not in ok):
            out.append(LintFinding(
                "LP002", f.path, f.line,
                f"user-facing surface {f.name}() accepts a tag but "
                f"never validates it against {_RESERVED_NAME} (nor "
                f"delegates to a surface that does)"))


# --------------------------------------------------------------------------
# single-file rules
# --------------------------------------------------------------------------

def _name_of(nd: ast.AST) -> str | None:
    """``x`` of a Name ``x`` or an Attribute ``a.b.x``, else None."""
    if isinstance(nd, ast.Name):
        return nd.id
    if isinstance(nd, ast.Attribute):
        return nd.attr
    return None


def _pool_names(tree: ast.Module) -> set:
    """Names bound in this file to a pool object: assigned (as a name or
    an attribute) from an expression that calls a ``*Pool`` constructor,
    or from a name already known to hold one, to a fixpoint."""
    assigns = []
    for nd in ast.walk(tree):
        if isinstance(nd, (ast.Assign, ast.AnnAssign)) and nd.value:
            targets = nd.targets if isinstance(nd, ast.Assign) \
                else [nd.target]
            names = {_name_of(t) for t in targets} - {None}
            assigns.append((names, nd.value))
    known: set = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if names <= known:
                continue
            holds = any(
                (isinstance(sub, ast.Call)
                 and (_name_of(sub.func) or "").endswith("Pool"))
                or (isinstance(sub, (ast.Name, ast.Attribute))
                    and _name_of(sub) in known)
                for sub in ast.walk(value))
            if holds:
                known |= names
                changed = True
    return known


def _check_raw_access(path: str, fname: str, tree: ast.Module,
                      lines: list, out: list) -> None:
    if fname in _RAW_ALLOWED_FILES:
        return
    pools = _pool_names(tree)
    for nd in ast.walk(tree):
        if not (isinstance(nd, ast.Call)
                and isinstance(nd.func, ast.Attribute)):
            continue
        f = nd.func
        owner = _name_of(f.value)
        bad = f.attr in _RAW_FUNCS or (
            f.attr in ("write", "read")
            and isinstance(f.value, ast.Attribute)
            and f.value.attr in _RAW_CHAINS) or (
            f.attr in _RAW_DEVICE
            and (owner in _RAW_CHAINS or owner in pools))
        if not bad:
            continue
        span = lines[nd.lineno - 1:(nd.end_lineno or nd.lineno)]
        if any(_RAW_WAIVER.search(ln) for ln in span):
            continue
        chain = (f.attr if f.attr in _RAW_FUNCS
                 else f"{owner}.{f.attr}")
        out.append(LintFinding(
            "LP001", path, nd.lineno,
            f"shared-region access bypasses the coherence protocol "
            f"({chain}); use CoherentView write_release/read_acquire/"
            f"nt-store helpers or add '# lint: raw-ok (<why>)'"))


def _check_tick_sleeps(path: str, fname: str, tree: ast.Module,
                       out: list) -> None:
    if fname not in _TICK_FILES:
        return
    for nd in ast.walk(tree):
        if not isinstance(nd, ast.Call):
            continue
        f = nd.func
        is_sleep = (isinstance(f, ast.Attribute) and f.attr == "sleep") \
            or (isinstance(f, ast.Name) and f.id == "sleep")
        if not is_sleep:
            continue
        arg = nd.args[0] if nd.args else None
        if isinstance(arg, ast.Constant) and arg.value == 0:
            continue                      # bare yield — legal
        out.append(LintFinding(
            "LP003", path, nd.lineno,
            "blocking sleep in a progress tick path — wait loops must "
            "tick cooperatively and only yield via time.sleep(0)"))


def _mb_store_side(nd: ast.Call, fn_calls_entry_off: bool) -> str | None:
    """Classify an ``nt_store_*`` call as targeting a sender- or
    receiver-owned matchbox field, or None when it does not store to a
    matchbox entry at all."""
    if not (isinstance(nd.func, ast.Attribute)
            and nd.func.attr.startswith("nt_store") and nd.args):
        return None
    off = nd.args[0]
    names = {n.id for n in ast.walk(off) if isinstance(n, ast.Name)}
    if names & _MB_SENDER_FIELDS:
        return "sender"
    if names & _MB_RECEIVER_FIELDS:
        return "receiver"
    # a bare offset in an entry_off-computing function is the post_id
    # word at entry offset 0 — receiver-owned (the publish/retract word)
    if isinstance(off, ast.Name) and fn_calls_entry_off:
        return "receiver"
    return None


def _check_mb_single_writer(path: str, tree: ast.Module, lines: list,
                            out: list) -> None:
    def annotation(fn) -> str | None:
        for ln in range(fn.lineno, max(fn.lineno - 3, 0), -1):
            m = _MB_WRITER.search(lines[ln - 1])
            if m:
                return m.group(1)
        return None

    def own_nodes(fn):
        # this function's own statements — nested defs are annotated
        # (and checked) separately
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            nd = stack.pop()
            if isinstance(nd, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield nd
            stack.extend(ast.iter_child_nodes(nd))

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                own = list(own_nodes(child))
                calls_entry_off = any(
                    isinstance(nd, ast.Call)
                    and ((isinstance(nd.func, ast.Attribute)
                          and nd.func.attr == "entry_off")
                         or (isinstance(nd.func, ast.Name)
                             and nd.func.id == "entry_off"))
                    for nd in own)
                role = annotation(child)
                for nd in own:
                    if not isinstance(nd, ast.Call):
                        continue
                    side = _mb_store_side(nd, calls_entry_off)
                    if side is None:
                        continue
                    if role is None:
                        out.append(LintFinding(
                            "LP004", path, nd.lineno,
                            f"matchbox field store in unannotated "
                            f"function {child.name}() — declare the "
                            f"owning side with '# mb-writer: {side}' "
                            f"on the def line"))
                    elif role != side:
                        out.append(LintFinding(
                            "LP004", path, nd.lineno,
                            f"{child.name}() is annotated mb-writer: "
                            f"{role} but stores a {side}-owned "
                            f"matchbox field — single-writer "
                            f"discipline violated"))
            visit(child)

    visit(tree)


def _mentions_enabled(test: ast.AST) -> bool:
    for nd in ast.walk(test):
        if isinstance(nd, ast.Attribute) and nd.attr == "enabled":
            return True
        if isinstance(nd, ast.Name) and nd.id == "enabled":
            return True
    return False


def _check_trace_guards(path: str, fname: str, tree: ast.Module,
                        out: list) -> None:
    emits, spans = fname in _TRACE_FILES, fname in _SPAN_FILES
    if not (emits or spans):
        return

    def check_emit(nd: ast.Call, guarded: bool, what: str = "emit") -> None:
        if not guarded:
            out.append(LintFinding(
                "LP005", path, nd.lineno,
                f"trace {what}() in a tick path outside an '.enabled' "
                "guard — disabled-mode cost must be one predicate "
                "check (tr = self.tracer; if tr.enabled: tr.emit(...))"))
        for a in list(nd.args) + [kw.value for kw in nd.keywords]:
            if any(isinstance(sub, _EMIT_ARG_BANNED)
                   or (isinstance(sub, ast.Call)
                       and isinstance(sub.func, ast.Name)
                       and sub.func.id == "dict")
                   for sub in ast.walk(a)):
                out.append(LintFinding(
                    "LP005", path, a.lineno,
                    f"trace {what}() argument builds an f-string/dict/"
                    "comprehension — arguments must be plain names or "
                    "ints (records are int64 words; formatting "
                    "belongs in the exporter)"))
                break

    def visit(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, ast.Call):
            f = node.func
            if emits and ((isinstance(f, ast.Attribute) and f.attr == "emit")
                          or (isinstance(f, ast.Name) and f.id == "emit")):
                check_emit(node, guarded)
            elif spans and isinstance(f, ast.Attribute) \
                    and f.attr in _SPAN_CALLS:
                check_emit(node, guarded, f.attr)
        if isinstance(node, ast.If) and _mentions_enabled(node.test):
            for b in node.body:
                visit(b, True)
            for b in node.orelse:
                visit(b, guarded)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def lint_sources(sources: dict) -> list:
    """Lint ``{path: source_text}``; returns sorted findings. Split
    from ``lint_paths`` so tests can feed synthetic bad code."""
    out: list = []
    funcs: list = []
    classes: dict = {}
    for path, text in sorted(sources.items()):
        fname = Path(path).name
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            out.append(LintFinding("LP000", path, e.lineno or 0,
                                   f"syntax error: {e.msg}"))
            continue
        lines = text.splitlines()
        _collect_funcs(path, tree, funcs, classes)
        _check_raw_access(path, fname, tree, lines, out)
        _check_tick_sleeps(path, fname, tree, out)
        _check_mb_single_writer(path, tree, lines, out)
        _check_trace_guards(path, fname, tree, out)
    _check_reserved_tags(funcs, classes, out)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths) -> list:
    sources = {}
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            sources[str(f)] = f.read_text()
    return lint_sources(sources)


def _default_target() -> Path:
    return Path(__file__).resolve().parent.parent / "core"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="shared-memory protocol discipline linter")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: "
                         "src/repro_torch/core)")
    args = ap.parse_args(argv)
    paths = args.paths or [_default_target()]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    print(f"lint_protocol: {len(findings)} finding(s) in "
          f"{', '.join(str(p) for p in paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
