"""Textual graph DSL: the ``graph!`` macro syntax as a runtime parser.

Counterpart of ``oscen_tpu/graph/dsl.py``, nearly a copy: it builds a
:class:`~oscen_tpu_torch.graph.builder.Graph` through the builder and the
IR, so nothing here touches a device.  It accepts the reference's
declarative syntax (oscen-graph-compiler/src/parse.rs), so graph bodies
paste nearly verbatim:

    name: Synth;

    input mod_freq: value = 5.0;
    input cutoff: value = 1200.0 [20.0..20000.0, log, ramp: 64];
    output audio_out: stream;

    nodes {
        modulator = PolyBlepOscillator::sine(5.0, 0.2);
        carrier = PolyBlepOscillator::saw(440.0, 0.5);
        filter = TptFilter::new(1200.0, 0.707);
    }

    connections {
        mod_freq -> modulator.frequency;
        modulator.output -> carrier.frequency_mod;
        carrier.output - 0.5 -> filter.input;
        filter.output -> audio_out;
    }

Supported (mirroring parse.rs): typed inputs with defaults and param specs
(``[min..max, log, ramp: N]``), ``Frame<N>`` outputs, node arrays
(``[Ctor; N]``), node rates (``* N``), ``Type::ctor(args)`` constructor
paths resolved against a registry (default: the node classes that
``oscen_tpu_torch`` exports), policy prefixes (``[latch|linear|sinc|
sinc_iir]``), inline delay vias (``-> [16] ->`` / ``-> [node] ->``),
connection expressions with ``+ - * /`` and parentheses, ``external
name;`` asset slots.

What the port does not have yet fails where it would anyway: a node type
it lacks (``Convolver``, ``SamplePlayer``, ``Oscilloscope``; ROADMAP.md
queue 1, Slice F) is an unknown type at parse time, and a graph whose
inline via needs a per-sample scan island parses but raises
``NotImplementedError`` (Slice F) when compiled.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from ..core.types import ParamSpec
from .builder import Graph, GraphError
from .ir import BinOp, Const, EndpointRef, Expr

__all__ = ["parse_graph", "parse_oversample_variants"]

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<arrow>->)
  | (?P<dcolon>::)
  | (?P<range>\.\.)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>[{}()\[\];:,=*/+<>.-])
""", re.VERBOSE)


def _tokenize(src: str) -> tuple:
    """Tokenize; bad characters are recorded as diagnostics and skipped so
    one stray character does not hide every later error (the reference
    accumulates instead of bailing, diagnostics.rs:40-107)."""
    toks = []
    errors: List[str] = []
    pos = 0
    line = 1
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            errors.append(
                f"DSL line {line}: unexpected character {src[pos]!r}")
            pos += 1
            continue
        line += src[pos:m.end()].count("\n")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group(), line))
    toks.append(("eof", "", line))
    return toks, errors


def _default_registry() -> Dict[str, Any]:
    import oscen_tpu_torch as _o
    reg = {}
    for name in dir(_o):
        obj = getattr(_o, name)
        if isinstance(obj, type):
            reg[name] = obj
    return reg


class _Parser:
    def __init__(self, toks: List[tuple], registry: Dict[str, Any],
                 diags: Optional[List[str]] = None):
        self.toks = toks
        self.i = 0
        self.registry = registry
        self.diags: List[str] = diags if diags is not None else []

    # -- token helpers -------------------------------------------------- #
    def peek(self, k: int = 0) -> tuple:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> tuple:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str) -> tuple:
        t = self.next()
        if t[1] != val:
            raise GraphError(
                f"DSL line {t[2]}: expected {val!r}, got {t[1]!r}")
        return t

    def accept(self, val: str) -> bool:
        if self.peek()[1] == val:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        t = self.next()
        if t[0] != "ident":
            raise GraphError(
                f"DSL line {t[2]}: expected identifier, got {t[1]!r}")
        return t[1]

    def number(self) -> float:
        neg = self.accept("-")
        t = self.next()
        if t[0] != "num":
            raise GraphError(
                f"DSL line {t[2]}: expected number, got {t[1]!r}")
        v = float(t[1])
        return -v if neg else v

    # -- error recovery -------------------------------------------------- #
    # The reference chunks the top level at `;` / `keyword {}` boundaries
    # and each block body at `;`, parsing every chunk independently so one
    # malformed statement yields its error AND the rest still parse
    # (parse.rs:24-117 split_top_level_chunks / split_statement_chunks,
    # diagnostics accumulated per chunk).  Here the same recovery is a
    # synchronizing skip: on error, record the diagnostic and advance to
    # the next statement boundary.

    def _sync_top(self) -> None:
        """Skip to just after the next top-level `;` or balanced `{...}`."""
        depth = 0
        while True:
            t = self.next()
            if t[0] == "eof":
                self.i -= 1
                return
            if t[1] == "{":
                depth += 1
            elif t[1] == "}":
                depth -= 1
                if depth <= 0:
                    return
            elif t[1] == ";" and depth == 0:
                return

    def _sync_stmt(self) -> None:
        """Skip to just after the next `;` inside a block, stopping before
        the block's closing `}` (never consumed — the block loop owns it)."""
        depth = 0
        while True:
            t = self.peek()
            if t[0] == "eof":
                return
            if t[1] == "}" and depth == 0:
                return
            self.next()
            if t[1] in ("{", "[", "("):
                depth += 1
            elif t[1] in ("}", "]", ")"):
                depth -= 1
            elif t[1] == ";" and depth == 0:
                return

    # -- grammar -------------------------------------------------------- #
    def parse(self, name: Optional[str]) -> Graph:
        g: Optional[Graph] = None
        items: List[tuple] = []
        gname = name or "Graph"
        # first pass collects declarations so `connections` can come in any
        # order relative to `nodes` (the reference allows both)
        while self.peek()[0] != "eof":
            t = self.peek()
            try:
                if t[1] == "name":
                    self.next()
                    self.expect(":")
                    gname = self.ident()
                    self.expect(";")
                    if items:
                        # ordering rule from the reference's recovery tests
                        # (parse_recovery.rs misplaced_name_decl_...)
                        raise GraphError(
                            f"DSL line {t[2]}: `name:` must appear at the "
                            f"start of the graph")
                elif t[1] in ("input", "output", "external"):
                    items.append(self._decl() + (t[2],))
                elif t[1] == "nodes":
                    items.extend(self._nodes_block())
                elif t[1] == "connections":
                    items.extend(self._connections_block())
                else:
                    self.next()
                    raise GraphError(
                        f"DSL line {t[2]}: unexpected {t[1]!r} at top level")
            except GraphError as e:
                self.diags.append(str(e))
                self._sync_top()
        g = Graph(gname)
        # declarations first, then nodes, then connections; application
        # errors (unknown endpoints, duplicate names, ...) accumulate the
        # same way parse errors do — one combined report at the end.
        # Application only runs on a clean parse (as in the reference,
        # where semantic checks see only a successfully parsed AST) so
        # recovery skips don't cascade into spurious unknown-node errors.
        if not self.diags:
            for kind, payload, line in sorted(
                    items, key=lambda it: {"decl": 0, "node": 1,
                                           "conn": 2}[it[0]]):
                try:
                    payload(g)
                except GraphError as e:
                    msg = str(e)
                    self.diags.append(msg if msg.startswith("DSL line")
                                      else f"DSL line {line}: {msg}")
        if self.diags:
            # one combined report (the reference's compile_error! collapse)
            raise GraphError("\n".join(dict.fromkeys(self.diags)))
        return g

    def _decl(self) -> tuple:
        which = self.next()[1]
        if which == "external":
            nm = self.ident()
            # optional `: Type` annotation, ignored (type comes from the
            # bound node's consumer, as in the reference)
            if self.accept(":"):
                self.ident()
            self.expect(";")
            return ("decl", lambda g, nm=nm: g.external(nm))
        nm = self.ident()
        kind = "value"
        channels = 1
        if self.accept(":"):
            kind = self.ident()
            if self.accept(":"):  # `output out: stream: Frame<2>`
                fr = self.ident()
                if fr != "Frame":
                    raise GraphError(f"DSL: unknown type {fr!r}")
                self.expect("<")
                channels = int(self.number())
                self.expect(">")
        default = 0.0
        spec = None
        ramp = 0
        if self.accept("="):
            default = self.number()
        if self.peek()[1] == "[" and which == "input":
            spec, ramp = self._param_spec()
        self.expect(";")
        if which == "input":
            return ("decl", lambda g, nm=nm, kind=kind, default=default,
                    channels=channels, spec=spec, ramp=ramp:
                    g.input(nm, kind, default=default, channels=channels,
                            spec=spec, ramp=ramp))
        return ("decl", lambda g, nm=nm, kind=kind, channels=channels:
                g.output(nm, kind, channels=channels))

    def _param_spec(self):
        self.expect("[")
        spec = ParamSpec()
        ramp = 0
        while not self.accept("]"):
            t = self.peek()
            if t[0] == "num" or t[1] == "-":
                lo = self.number()
                self.expect("..")
                hi = self.number()
                spec.min, spec.max = lo, hi
            else:
                key = self.ident()
                if key == "log":
                    spec.log = True
                elif key == "ramp":
                    self.expect(":")
                    ramp = int(self.number())
                    spec.ramp_frames = ramp
                elif key in ("center", "step", "smoother_ms", "smoother"):
                    self.expect(":")
                    setattr(spec, "smoother_ms"
                            if key in ("smoother", "smoother_ms") else key,
                            self.number())
                elif key in ("unit", "display_name", "group"):
                    self.expect(":")
                    setattr(spec, key, self.ident())
                else:
                    raise GraphError(f"DSL: unknown spec field {key!r}")
            self.accept(",")
        return spec, ramp

    # .................................................................. #
    def _nodes_block(self) -> List[tuple]:
        self.expect("nodes")
        self.expect("{")
        out = []
        while not self.accept("}"):
            line = self.peek()[2]
            if self.peek()[0] == "eof":
                raise GraphError(f"DSL line {line}: unterminated nodes block")
            try:
                nm = self.ident()
                self.expect("=")
                count = 1
                if self.accept("["):
                    node = self._ctor()
                    self.expect(";")
                    count = int(self.number())
                    self.expect("]")
                else:
                    node = self._ctor()
                rate = 1
                if self.accept("*"):
                    rate = int(self.number())
                self.expect(";")
            except GraphError as e:
                self.diags.append(str(e))
                self._sync_stmt()
                continue
            out.append(("node", lambda g, nm=nm, node=node, count=count,
                        rate=rate: g.add(nm, node, count=count, rate=rate),
                        line))
        return out

    def _ctor(self):
        ty = self.ident()
        cls = self.registry.get(ty)
        if cls is None:
            raise GraphError(f"DSL: unknown node type {ty!r} (pass it in "
                             f"the registry)")
        method = None
        if self.accept("::"):
            method = self.ident()
        args, kwargs = self._args()
        if method in (None, "new"):
            return cls(*args, **kwargs)
        fn = getattr(cls, method, None)
        if fn is None:
            raise GraphError(f"DSL: {ty} has no constructor {method!r}")
        return fn(*args, **kwargs)

    def _args(self):
        self.expect("(")
        args: List[Any] = []
        kwargs: Dict[str, Any] = {}
        while not self.accept(")"):
            if self.peek()[0] == "ident" and self.peek(1)[1] == "=":
                k = self.ident()
                self.expect("=")
                kwargs[k] = self.number()
            else:
                args.append(self.number())
            self.accept(",")
        return args, kwargs

    # .................................................................. #
    def _connections_block(self) -> List[tuple]:
        self.expect("connections")
        self.expect("{")
        out = []
        while not self.accept("}"):
            line = self.peek()[2]
            if self.peek()[0] == "eof":
                raise GraphError(
                    f"DSL line {line}: unterminated connections block")
            try:
                policy = "default"
                if self.accept("["):
                    policy = self.ident()
                    self.expect("]")
                src = self._expr()
                self.expect("->")
                via = None
                if self.accept("["):
                    t = self.peek()
                    if t[0] == "num":
                        via = int(self.number())
                    else:
                        via = self.ident()
                    self.expect("]")
                    self.expect("->")
                dst = self._dst()
                self.expect(";")
            except GraphError as e:
                self.diags.append(str(e))
                self._sync_stmt()
                continue
            out.append(("conn", lambda g, src=src, dst=dst, policy=policy,
                        via=via: g.connect(
                            _resolve(src, g), _resolve_dst(dst, g),
                            policy=policy, via=via),
                        line))
        return out

    def _dst(self):
        nm = self.ident()
        idx = None
        if self.accept("["):
            idx = int(self.number())
            self.expect("]")
        if self.accept("."):
            ep = self.ident()
            return ("ep", nm, idx, ep)
        return ("out", nm)

    # expression grammar: term (+|-) term; factor (*|/) factor; atoms
    def _expr(self):
        e = self._term()
        while True:
            nxt = self.peek()
            # `-` only binds as subtraction if not part of `->`
            if nxt[1] == "+" or (nxt[1] == "-" and self.peek(1)[1] != ">"):
                op = self.next()[1]
                e = ("bin", op, e, self._term())
            else:
                return e

    def _term(self):
        e = self._factor()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            e = ("bin", op, e, self._factor())
        return e

    def _factor(self):
        t = self.peek()
        if t[1] == "(":
            self.next()
            e = self._expr()
            self.expect(")")
            return e
        if t[0] == "num" or t[1] == "-":
            return ("const", self.number())
        nm = self.ident()
        idx = None
        if self.accept("["):
            idx = int(self.number())
            self.expect("]")
        if self.accept("."):
            ep = self.ident()
            ch = None
            if self.accept("["):
                ch = int(self.number())
                self.expect("]")
            return ("ep", nm, idx, ep, ch)
        return ("input", nm)


def _resolve(node, g: Graph):
    kind = node[0]
    if kind == "const":
        return Const(node[1])
    if kind == "input":
        if node[1] in g._externals:
            return node[1]  # asset binding: builder handles the string
        return EndpointRef("", node[1])
    if kind == "ep":
        nm, idx, ep = node[1], node[2], node[3]
        ch = node[4] if len(node) > 4 else None
        g._check_endpoint(nm, ep)
        return EndpointRef(nm, ep, idx, ch)
    if kind == "bin":
        return BinOp(node[1], _resolve(node[2], g), _resolve(node[3], g))
    raise GraphError(f"DSL: bad expression node {node!r}")


def _resolve_dst(dst, g: Graph):
    if dst[0] == "out":
        nm = dst[1]
        if any(o.name == nm for o in g._outputs):
            return nm
        # bare name might also be a node... the reference requires
        # `node.endpoint` for node destinations
        raise GraphError(f"DSL: unknown connection destination {nm!r}")
    _, nm, idx, ep = dst
    g._check_endpoint(nm, ep)
    return EndpointRef(nm, ep, idx)


def parse_graph(src: str, registry: Optional[Dict[str, Any]] = None,
                name: Optional[str] = None) -> Graph:
    """Parse a ``graph!``-style body into a :class:`Graph`.

    ``registry`` maps type names usable in ``nodes { ... }`` to node
    classes; defaults to every class exported from ``oscen_tpu_torch`` —
    pass your own (or update the dict) for custom nodes.
    """
    reg = _default_registry()
    if registry:
        reg.update(registry)
    toks, tok_errors = _tokenize(src)
    p = _Parser(toks, reg, diags=tok_errors)
    return p.parse(name)

_OV_HEADER_RE = re.compile(
    r"""\s*base_name\s*:\s*(?P<base>[A-Za-z_][A-Za-z0-9_]*)\s*;
        \s*factors\s*:\s*\[(?P<factors>[^\]]*)\]\s*;
        \s*body\s*:\s*\{""", re.VERBOSE)

_FACTOR_RE = re.compile(r"\{\s*FACTOR\s*\}")


def parse_oversample_variants(src: str,
                              registry: Optional[Dict[str, Any]] = None
                              ) -> Dict[str, Graph]:
    """The ``oversample_variants!`` macro for the textual DSL.

    Expands one graph body into ``{base}_{F}x`` variants, substituting each
    factor for every ``{FACTOR}`` placeholder (the reference's
    oversample_variants_macro.rs:94-120 — there a compile-time token
    rewrite, here a textual one feeding :func:`parse_graph`):

        variants = parse_oversample_variants('''
            base_name: Sat;
            factors: [1, 2, 4];
            body: {
                output audio_out: stream;
                nodes { osc = PolyBlepOscillator::saw(440.0, 0.6) * {FACTOR}; }
                connections { [sinc] osc.output -> audio_out; }
            }
        ''')
        variants["Sat_4x"].compile(48000.0, block_size=256)

    Returns a dict mapping variant name -> :class:`Graph`.
    """
    m = _OV_HEADER_RE.match(src)
    if not m:
        raise GraphError(
            "oversample_variants: expected `base_name: Name; "
            "factors: [..]; body: { ... }`")
    base = m.group("base")
    try:
        factors = [int(f.strip()) for f in m.group("factors").split(",")
                   if f.strip()]
    except ValueError:
        raise GraphError("oversample_variants: factors must be integers")
    if not factors:
        raise GraphError(
            "oversample_variants: `factors` list must contain at least one "
            "factor")
    # body: balanced-brace scan from the `{` the header matched through
    depth = 1
    i = m.end()
    while i < len(src) and depth:
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
        i += 1
    if depth:
        raise GraphError("oversample_variants: unterminated body block")
    body = src[m.end():i - 1]
    tail = src[i:].strip()
    if tail not in ("", ";"):
        raise GraphError(
            f"oversample_variants: unexpected trailing tokens {tail!r}")
    out: Dict[str, Graph] = {}
    for f in factors:
        name = f"{base}_{f}x"
        out[name] = parse_graph(_FACTOR_RE.sub(str(f), body),
                                registry=registry, name=name)
    return out
