"""A renderer for the subset of Jinja that Qwen chat templates use.

The JAX package renders a checkpoint's chat template with ``jinja2``
(``qwen3_asr_tpu/models/asr.py:127-171``); the card's machine has no
``jinja2``, so the port renders it here, with the environment JAX builds:
``trim_blocks=True``, ``lstrip_blocks=True``, the ``loopcontrols``
extension, the default (lenient) ``Undefined``, no autoescape, and the
global ``raise_exception``. ``compile_template(source)`` parses once;
``Template.render(**variables)`` renders, and gives ``jinja2``'s string for
every template inside the subset:

- **Text and tags**: ``{{ }}``, ``{% %}``, ``{# #}`` comments; ``-`` on
  either side of a tag strips the whitespace there, ``+`` keeps it;
  newlines are normalised to ``\\n`` and one trailing newline is dropped.
- **Statements**: ``for`` (a name or a tuple of names as target; an
  ``else`` branch, run when no iteration ran its body to the end; ``loop.index``, ``index0``, ``revindex``, ``revindex0``,
  ``first``, ``last``, ``length``), ``if`` / ``elif`` / ``else``,
  ``set name = expr`` and ``set ns.attr = expr``, ``break``, ``continue``.
  A ``for`` body is a scope of its own each iteration; ``if`` is not.
- **Expressions**: string (with escapes), integer, float, ``true`` /
  ``false`` / ``none`` literals, lists, tuples and dicts; names; ``.`` and
  ``[]`` lookup with slices (``[::-1]``); calls; ``+ - * / // % **``,
  unary ``-`` and ``+``; ``~``; ``== != < <= > >=`` (chained), ``in``,
  ``not in``; ``and`` / ``or`` / ``not``; ``x if c else y`` (no ``else``:
  undefined).
- **Tests**: ``is`` and ``is not`` with ``string``, ``defined``,
  ``undefined``, ``none``, ``mapping``, ``sequence``, ``iterable``,
  ``true``, ``false``.
- **Filters**: ``trim``, ``length`` (``count``), ``tojson`` (``indent``),
  ``string``, ``lower``, ``upper``.
- **Methods**: of strings ``startswith``, ``endswith``, ``strip``,
  ``lstrip``, ``rstrip``, ``split``, ``replace``, ``lower``, ``upper``; of
  dicts ``get``, ``items``, ``keys``, ``values``.
- **Globals**: ``namespace(...)``, ``raise_exception(msg)``, ``range``.

Anything outside the subset raises ``TemplateError`` when the template is
compiled or, for a value's attribute, when it is rendered; so does every
failure while rendering. ``jinja2`` escapes a plain string joined by ``+``
(or ``*``, ``%``) to a ``tojson`` result, since that result is markup: the
renderer refuses those operations on a ``tojson`` result, and any other use
of one than output, ``~``, comparison or the filters above.
"""
from __future__ import annotations

import collections.abc
import json
import operator
import re
from collections import ChainMap
from typing import Callable, List, Optional, Tuple


class TemplateError(ValueError):
    """A construct outside the subset, or a template that failed to
    compile or render."""


class UndefinedError(TemplateError):
    """An operation on an undefined value (``jinja2``'s ``UndefinedError``)."""


class Undefined:
    """``jinja2``'s default ``Undefined``: empty as a string, false, of
    length 0 and iterable; equal only to another undefined; any other
    operation raises."""
    __slots__ = ("_name",)

    def __init__(self, name: object = None):
        self._name = name

    def _fail(self, *args, **kwargs):
        raise UndefinedError(f"{self._name!r} is undefined")

    __add__ = __radd__ = __sub__ = __rsub__ = _fail
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _fail
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pow__ = __rpow__ = __pos__ = __neg__ = _fail
    __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail
    __int__ = __float__ = __complex__ = _fail

    def __eq__(self, other):
        return type(self) is type(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return id(type(self))

    def __str__(self):
        return ""

    def __len__(self):
        return 0

    def __iter__(self):
        yield from ()

    def __bool__(self):
        return False

    def __repr__(self):
        return "Undefined"


class Namespace:
    """``namespace(...)``: attributes that a ``set ns.attr`` can change
    from inside a loop."""

    def __init__(self, *args, **kwargs):
        self._attrs = dict(*args, **kwargs)

    def __repr__(self):
        return f"<Namespace {self._attrs!r}>"


class _Loop:
    """The ``loop`` variable of one iteration."""

    def __init__(self, index0: int, length: int):
        self.index0, self.length = index0, length

    def attr(self, name: str):
        i, n = self.index0, self.length
        values = {"index0": i, "index": i + 1, "first": i == 0,
                  "last": i == n - 1, "length": n, "revindex": n - i,
                  "revindex0": n - i - 1}
        if name in values:
            return values[name]
        if name in ("previtem", "nextitem", "depth", "depth0", "cycle",
                    "changed"):
            raise TemplateError(f"loop.{name} is outside the renderer's "
                                "subset")
        raise AttributeError(name)

    def __str__(self):
        raise TemplateError("printing loop is outside the renderer's subset")


class _Json(str):
    """A ``tojson`` result (``jinja2``'s ``Markup``)."""


def _no_json(*values) -> None:
    if any(isinstance(v, _Json) for v in values):
        raise TemplateError("this operation on a tojson result is outside "
                            "the renderer's subset (jinja2 escapes markup)")


def _raise_exception(message):
    raise TemplateError(message)


def _range(*args):
    """``range``, refused past jinja2's 100000 items."""
    items = range(*args)
    if len(items) > 100000:
        raise TemplateError("range too big")
    return items


GLOBALS = {"namespace": Namespace, "raise_exception": _raise_exception,
           "range": _range}
_STR_METHODS = frozenset({"startswith", "endswith", "strip", "lstrip",
                          "rstrip", "split", "replace", "lower", "upper"})
_DICT_METHODS = frozenset({"get", "items", "keys", "values"})


def _py_attr(obj, name: str):
    """Python's attribute ``name`` of ``obj`` where the subset has it;
    AttributeError where Python has none (so lookup goes on as
    ``jinja2``'s does); TemplateError where Python has one the subset
    leaves out."""
    if isinstance(obj, Undefined):
        obj._fail()
    _no_json(obj)
    if isinstance(obj, Namespace):
        if name in obj._attrs:
            return obj._attrs[name]
        raise AttributeError(name)
    if isinstance(obj, _Loop):
        return obj.attr(name)
    allowed = (_STR_METHODS if isinstance(obj, str) else
               _DICT_METHODS if isinstance(obj, dict) else ())
    if name in allowed:
        return getattr(obj, name)
    if hasattr(obj, name):
        raise TemplateError(f"attribute {name!r} of {type(obj).__name__} is "
                            "outside the renderer's subset")
    raise AttributeError(name)


def getattr_(obj, name: str):
    """``obj.name``: the attribute, else the item, else undefined."""
    try:
        return _py_attr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(name)


def getitem(obj, key):
    """``obj[key]``: the item, else (for a string key) the attribute, else
    undefined."""
    _no_json(obj)
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return _py_attr(obj, key)
            except AttributeError:
                pass
        return Undefined(key)


def _soft_str(value):
    return value if isinstance(value, str) else str(value)


def _keep_json(value, result):
    return _Json(result) if isinstance(value, _Json) else result


def _tojson(value, indent=None):
    kwargs = {"sort_keys": True}
    if indent is not None:
        kwargs["indent"] = indent
    return _Json(json.dumps(value, **kwargs).replace("<", "\\u003c")
                 .replace(">", "\\u003e").replace("&", "\\u0026")
                 .replace("'", "\\u0027"))


FILTERS = {
    "length": len, "count": len,
    "trim": lambda v, chars=None: _keep_json(v, _soft_str(v).strip(chars)),
    "tojson": _tojson,
    "string": _soft_str,
    "lower": lambda v: _keep_json(v, _soft_str(v).lower()),
    "upper": lambda v: _keep_json(v, _soft_str(v).upper()),
}


def _test_sequence(value) -> bool:
    try:
        len(value)
        value.__getitem__
    except Exception:
        return False
    return True


def _test_iterable(value) -> bool:
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS = {
    "string": lambda v: isinstance(v, str),
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "mapping": lambda v: isinstance(v, collections.abc.Mapping),
    "sequence": _test_sequence,
    "iterable": _test_iterable,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
}


# -- lexer -----------------------------------------------------------------------

_NEWLINE = re.compile(r"\r\n|\r|\n")
_WHITESPACE = re.compile(r"\s+")
_ROOT = re.compile(
    r"(.*?)(?:(?P<raw>\{%[-+]?\s*raw\s*(?:-%\}\s*|%\}))"
    r"|(?P<var>\{\{)(?P<var_sign>[-+]?)|(?P<block>\{%)(?P<block_sign>[-+]?)"
    r"|(?P<comment>\{#)(?P<comment_sign>[-+]?))", re.S)
_COMMENT_END = re.compile(r"(.*?)(?:\+#\}|-#\}\s*|#\}\n?)", re.S)
_END = {"block": re.compile(r"\+%\}|-%\}\s*|%\}\n?"),
        "var": re.compile(r"-\}\}\s*|\}\}")}
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'"
                     r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_INTEGER = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+"
                      r"|[1-9](_?\d)*|0(_?0)*)", re.I)
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+"
                    r"|\.(\d+_)*\d+)", re.I)
_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_OPERATOR = re.compile(r"//|\*\*|==|!=|>=|<=|[+\-/*%~\[\](){}><=.:|,;]")
_CLOSE = {"{": "}", "(": ")", "[": "]"}


def _tag_tokens(source: str, pos: int, kind: str) -> Tuple[list, int, bool]:
    """The tokens of a ``{{ }}`` or ``{% %}`` tag whose body starts at
    ``pos``: (tokens, position after the tag's end, whether that end
    consumed a newline last)."""
    tokens, balance = [], []
    end_re = _END[kind]
    while True:
        if pos >= len(source):
            raise TemplateError("unexpected end of template inside a tag")
        if not balance:
            m = end_re.match(source, pos)
            if m:
                return tokens, m.end(), m.group().endswith("\n")
        m = _WHITESPACE.match(source, pos)
        if m:
            pos = m.end()
            continue
        for kind_, rx in (("float", _FLOAT), ("integer", _INTEGER),
                          ("name", _NAME), ("string", _STRING),
                          ("op", _OPERATOR)):
            m = rx.match(source, pos)
            if m:
                break
        else:
            raise TemplateError(f"unexpected character {source[pos]!r}")
        text = m.group()
        if kind_ == "float":
            value = float(text.replace("_", ""))
        elif kind_ == "integer":
            value = int(text.replace("_", ""), 0)
        elif kind_ == "string":
            value = (_NEWLINE.sub("\n", text[1:-1])
                     .encode("ascii", "backslashreplace")
                     .decode("unicode-escape"))
        else:
            value = text
            if text in _CLOSE:
                balance.append(_CLOSE[text])
            elif text in ("}", ")", "]"):
                if not balance or balance.pop() != text:
                    raise TemplateError(f"unexpected {text!r}")
        tokens.append((kind_, value))
        pos = m.end()


def tokenize(source: str) -> list:
    """The template as ``("data", text)``, ``("var", tokens)`` and
    ``("block", tokens)`` items, whitespace control and
    ``trim_blocks``/``lstrip_blocks`` applied as ``jinja2``'s lexer
    applies them."""
    lines = _NEWLINE.split(source)
    if lines[-1] == "":
        del lines[-1]
    source = "\n".join(lines)
    items, pos, line_starting = [], 0, True
    while pos < len(source):
        m = _ROOT.match(source, pos)
        if m is None:                              # text to the end
            items.append(("data", source[pos:]))
            break
        if m.group("raw"):
            raise TemplateError("raw blocks are outside the renderer's subset")
        kind = next(k for k in ("var", "block", "comment") if m.group(k))
        text, sign = m.group(1), m.group(kind + "_sign")
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind != "var":          # lstrip_blocks
            start = text.rfind("\n") + 1
            if (start > 0 or line_starting) and \
                    _WHITESPACE.fullmatch(text, start):
                text = text[:start]
        if text:
            items.append(("data", text))
        if kind == "comment":
            end = _COMMENT_END.match(source, m.end())
            if end is None:
                raise TemplateError("missing end of comment tag")
            pos, line_starting = end.end(), end.group().endswith("\n")
            continue
        tokens, pos, line_starting = _tag_tokens(source, m.end(), kind)
        items.append((kind, tokens))
    return items


# -- parser: expressions compile to closures of a context (a ChainMap) ---------

Expr = Callable[[ChainMap], object]
_COMPARE = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
            "<=": operator.le, ">": operator.gt, ">=": operator.ge,
            "in": lambda a, b: a in b, "notin": lambda a, b: a not in b}
_MATH = {"+": operator.add, "-": operator.sub, "*": operator.mul,
         "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
         "**": operator.pow}


def _binary(op: str, left: Expr, right: Expr) -> Expr:
    fn = _MATH[op]

    def run(ctx):
        a, b = left(ctx), right(ctx)
        _no_json(a, b)
        return fn(a, b)
    return run


class _Tokens:
    """A cursor over one tag's tokens."""

    def __init__(self, tokens: list):
        self.tokens, self.i = tokens, 0

    def peek(self, offset: int = 0) -> Tuple[str, object]:
        j = self.i + offset
        return self.tokens[j] if j < len(self.tokens) else ("end", None)

    def is_(self, kind: str, value=None, offset: int = 0) -> bool:
        k, v = self.peek(offset)
        return k == kind and (value is None or v == value)

    def next(self) -> Tuple[str, object]:
        tok = self.peek()
        if tok[0] == "end":
            raise TemplateError("unexpected end of tag")
        self.i += 1
        return tok

    def skip(self, kind: str, value=None) -> bool:
        if self.is_(kind, value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value=None):
        if not self.is_(kind, value):
            raise TemplateError(f"expected {value or kind}, got "
                                f"{self.peek()[1]!r}")
        return self.next()[1]

    def done(self) -> None:
        if self.peek()[0] != "end":
            raise TemplateError(f"unexpected {self.peek()[1]!r} in a tag")


def parse_expression(t: _Tokens, condexpr: bool = True) -> Expr:
    """``jinja2``'s ``parse_expression``: a conditional over ``or``."""
    expr = _parse_or(t)
    while condexpr and t.skip("name", "if"):
        test = _parse_or(t)
        other = parse_expression(t) if t.skip("name", "else") else None

        def cond(ctx, expr=expr, test=test, other=other):
            if test(ctx):
                return expr(ctx)
            return other(ctx) if other is not None else Undefined()
        expr = cond
    return expr


def _parse_or(t: _Tokens) -> Expr:
    left = _parse_and(t)
    while t.skip("name", "or"):
        right = _parse_and(t)
        left = (lambda l, r: lambda ctx: l(ctx) or r(ctx))(left, right)
    return left


def _parse_and(t: _Tokens) -> Expr:
    left = _parse_not(t)
    while t.skip("name", "and"):
        right = _parse_not(t)
        left = (lambda l, r: lambda ctx: l(ctx) and r(ctx))(left, right)
    return left


def _parse_not(t: _Tokens) -> Expr:
    if t.skip("name", "not"):
        inner = _parse_not(t)
        return lambda ctx: not inner(ctx)
    return _parse_compare(t)


def _parse_compare(t: _Tokens) -> Expr:
    first = _parse_math1(t)
    ops: List[Tuple[Callable, Expr]] = []
    while True:
        if t.is_("op") and t.peek()[1] in _COMPARE:
            op = t.next()[1]
        elif t.skip("name", "in"):
            op = "in"
        elif t.is_("name", "not") and t.is_("name", "in", 1):
            t.i += 2
            op = "notin"
        else:
            break
        ops.append((_COMPARE[op], _parse_math1(t)))
    if not ops:
        return first

    def run(ctx):                       # Python's chained comparison
        left = first(ctx)
        for fn, right in ops:
            value = right(ctx)
            if not fn(left, value):
                return False
            left = value
        return True
    return run


def _parse_math1(t: _Tokens) -> Expr:
    left = _parse_concat(t)
    while t.is_("op") and t.peek()[1] in ("+", "-"):
        left = _binary(t.next()[1], left, _parse_concat(t))
    return left


def _parse_concat(t: _Tokens) -> Expr:
    parts = [_parse_math2(t)]
    while t.skip("op", "~"):
        parts.append(_parse_math2(t))
    if len(parts) == 1:
        return parts[0]
    return lambda ctx: "".join(str(p(ctx)) for p in parts)


def _parse_math2(t: _Tokens) -> Expr:
    left = _parse_pow(t)
    while t.is_("op") and t.peek()[1] in ("*", "/", "//", "%"):
        left = _binary(t.next()[1], left, _parse_pow(t))
    return left


def _parse_pow(t: _Tokens) -> Expr:
    left = _parse_unary(t)
    while t.skip("op", "**"):
        left = _binary("**", left, _parse_unary(t))
    return left


def _parse_unary(t: _Tokens, with_filter: bool = True) -> Expr:
    if t.skip("op", "-"):
        inner = _parse_unary(t, False)

        def node(ctx):
            v = inner(ctx)
            _no_json(v)
            return -v
    elif t.skip("op", "+"):
        inner = _parse_unary(t, False)

        def node(ctx):
            v = inner(ctx)
            _no_json(v)
            return +v
    else:
        node = _parse_primary(t)
    node = _parse_postfix(t, node)
    if with_filter:
        node = _parse_filter_expr(t, node)
    return node


def _parse_primary(t: _Tokens) -> Expr:
    kind, value = t.next()
    if kind == "name":
        if value in ("true", "True", "false", "False"):
            const = value in ("true", "True")
            return lambda ctx: const
        if value in ("none", "None"):
            return lambda ctx: None
        return lambda ctx: ctx[value] if value in ctx else Undefined(value)
    if kind == "string":
        parts = [value]
        while t.is_("string"):
            parts.append(t.next()[1])
        text = "".join(parts)
        return lambda ctx: text
    if kind in ("integer", "float"):
        return lambda ctx: value
    if kind == "op" and value == "(":
        node = _parse_tuple(t, ")")
        t.expect("op", ")")
        return node
    if kind == "op" and value == "[":
        items = _parse_items(t, "]")
        return lambda ctx: [i(ctx) for i in items]
    if kind == "op" and value == "{":
        pairs = []
        while not t.is_("op", "}"):
            if pairs:
                t.expect("op", ",")
                if t.is_("op", "}"):
                    break
            key = parse_expression(t)
            t.expect("op", ":")
            pairs.append((key, parse_expression(t)))
        t.expect("op", "}")
        return lambda ctx: {k(ctx): v(ctx) for k, v in pairs}
    raise TemplateError(f"unexpected {value!r}")


def _parse_items(t: _Tokens, close: str) -> List[Expr]:
    items = []
    while not t.is_("op", close):
        if items:
            t.expect("op", ",")
            if t.is_("op", close):
                break
        items.append(parse_expression(t))
    t.expect("op", close)
    return items


def _parse_tuple(t: _Tokens, close: str) -> Expr:
    """Inside parentheses: one expression, or a tuple."""
    if t.is_("op", close):
        return lambda ctx: ()
    items, tuple_ = [parse_expression(t)], False
    while t.skip("op", ","):
        tuple_ = True
        if t.is_("op", close):
            break
        items.append(parse_expression(t))
    if not tuple_:
        return items[0]
    return lambda ctx: tuple(i(ctx) for i in items)


def _parse_postfix(t: _Tokens, node: Expr) -> Expr:
    while True:
        if t.skip("op", "."):
            kind, value = t.next()
            if kind == "name":
                node = (lambda n, a: lambda ctx: getattr_(n(ctx), a))(
                    node, value)
            elif kind == "integer":
                node = (lambda n, k: lambda ctx: getitem(n(ctx), k))(
                    node, value)
            else:
                raise TemplateError("expected a name or a number after '.'")
        elif t.skip("op", "["):
            key = _parse_subscript(t)
            t.expect("op", "]")
            node = (lambda n, k: lambda ctx: getitem(n(ctx), k(ctx)))(
                node, key)
        elif t.is_("op", "("):
            node = _parse_call(t, node)
        else:
            return node


def _parse_subscript(t: _Tokens) -> Expr:
    """One subscript: an expression or a slice (no tuple of them)."""
    parts: List[Optional[Expr]] = []
    if not t.is_("op", ":"):
        first = parse_expression(t)
        if not t.is_("op", ":"):
            if t.is_("op", ","):
                raise TemplateError("tuple subscripts are outside the "
                                    "renderer's subset")
            return first
        parts.append(first)
    else:
        parts.append(None)
    t.expect("op", ":")
    parts.append(None if t.is_("op", ":") or t.is_("op", "]")
                 else parse_expression(t))
    if t.skip("op", ":"):
        parts.append(None if t.is_("op", "]") else parse_expression(t))
    else:
        parts.append(None)

    def run(ctx):
        return slice(*(p(ctx) if p is not None else None for p in parts))
    return run


def _parse_call_args(t: _Tokens) -> Tuple[List[Expr], List[Tuple[str, Expr]]]:
    t.expect("op", "(")
    args, kwargs = [], []
    while not t.is_("op", ")"):
        if args or kwargs:
            t.expect("op", ",")
            if t.is_("op", ")"):
                break
        if t.is_("op", "*") or t.is_("op", "**"):
            raise TemplateError("*args and **kwargs are outside the "
                                "renderer's subset")
        if t.is_("name") and t.is_("op", "=", 1):
            name = t.next()[1]
            t.next()
            kwargs.append((name, parse_expression(t)))
        else:
            if kwargs:
                raise TemplateError("a positional argument after a keyword")
            args.append(parse_expression(t))
    t.expect("op", ")")
    return args, kwargs


def _parse_call(t: _Tokens, node: Expr) -> Expr:
    args, kwargs = _parse_call_args(t)

    def run(ctx):
        fn = node(ctx)
        return fn(*[a(ctx) for a in args],
                  **{k: v(ctx) for k, v in kwargs})
    return run


def _dotted_name(t: _Tokens) -> str:
    name = t.expect("name")
    while t.skip("op", "."):
        name += "." + t.expect("name")
    return name


def _parse_filter_expr(t: _Tokens, node: Expr) -> Expr:
    while True:
        if t.skip("op", "|"):
            name = _dotted_name(t)
            if name not in FILTERS:
                raise TemplateError(f"filter {name!r} is outside the "
                                    "renderer's subset")
            fn = FILTERS[name]
            args, kwargs = (_parse_call_args(t) if t.is_("op", "(")
                            else ([], []))
            node = (lambda n, f, a, kw: lambda ctx: f(
                n(ctx), *[x(ctx) for x in a],
                **{k: v(ctx) for k, v in kw}))(node, fn, args, kwargs)
        elif t.skip("name", "is"):
            negated = t.skip("name", "not")
            name = _dotted_name(t)
            if name not in TESTS:
                raise TemplateError(f"test {name!r} is outside the "
                                    "renderer's subset")
            if t.is_("op", "(") or (
                    t.peek()[0] in ("name", "string", "integer", "float")
                    and not any(t.is_("name", w)
                                for w in ("else", "or", "and"))) \
                    or t.is_("op", "[") or t.is_("op", "{"):
                raise TemplateError("tests with arguments are outside the "
                                    "renderer's subset")
            fn = TESTS[name]
            node = (lambda n, f, neg: lambda ctx: f(n(ctx)) != neg)(
                node, fn, negated)
        elif t.is_("op", "("):
            node = _parse_call(t, node)
        else:
            return node


# -- parser: statements ----------------------------------------------------------

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


Stmt = Callable[[ChainMap, list], None]


def _run(body: List[Stmt], ctx: ChainMap, out: list) -> None:
    for stmt in body:
        stmt(ctx, out)


def _output(expr: Expr) -> Stmt:
    def run(ctx, out):
        out.append(str(expr(ctx)))
    return run


def _target(t: _Tokens) -> List[str]:
    """A ``for`` target: a name, or names separated by commas (with or
    without parentheses)."""
    paren = t.skip("op", "(")
    names = [t.expect("name")]
    while t.skip("op", ","):
        if t.is_("name", "in") or t.is_("op", ")"):
            break
        names.append(t.expect("name"))
    if paren:
        t.expect("op", ")")
    return names


class _Parser:
    """Builds the statement tree from ``tokenize``'s items."""

    def __init__(self, items: list):
        self.items, self.i, self.loops = items, 0, 0

    def body(self, ends: Tuple[str, ...]) -> Tuple[List[Stmt], str, _Tokens]:
        """Statements up to a block tag named in ``ends``: (statements, the
        name that ended them, that tag's remaining tokens)."""
        out: List[Stmt] = []
        while self.i < len(self.items):
            kind, value = self.items[self.i]
            self.i += 1
            if kind == "data":
                out.append((lambda s: lambda ctx, o: o.append(s))(value))
                continue
            t = _Tokens(value)
            if kind == "var":
                expr = parse_expression(t)
                t.done()
                out.append(_output(expr))
                continue
            name = t.expect("name")
            if name in ends:
                return out, name, t
            out.append(self.statement(name, t))
        if ends:
            raise TemplateError(f"missing {' or '.join(ends)}")
        return out, "", _Tokens([])

    def statement(self, name: str, t: _Tokens) -> Stmt:
        if name == "if":
            return self.if_(t)
        if name == "for":
            return self.for_(t)
        if name == "set":
            return self.set_(t)
        if name in ("break", "continue"):
            t.done()
            if not self.loops:
                raise TemplateError(f"{name} outside a loop")
            signal = _Break if name == "break" else _Continue

            def run(ctx, out):
                raise signal
            return run
        raise TemplateError(f"statement {name!r} is outside the renderer's "
                            "subset")

    def if_(self, t: _Tokens) -> Stmt:
        # jinja2 parses an if's test without a conditional expression
        branches = []
        test = parse_expression(t, condexpr=False)
        t.done()
        while True:
            body, end, t = self.body(("elif", "else", "endif"))
            branches.append((test, body))
            if end == "elif":
                test = parse_expression(t, condexpr=False)
                t.done()
                continue
            t.done()
            if end == "else":
                body, _, t = self.body(("endif",))
                t.done()
                branches.append((None, body))
            break

        def run(ctx, out):
            for cond, stmts in branches:
                if cond is None or cond(ctx):
                    _run(stmts, ctx, out)
                    return
        return run

    def for_(self, t: _Tokens) -> Stmt:
        names = _target(t)
        t.expect("name", "in")
        seq = parse_expression(t, condexpr=False)
        if t.is_("name", "if") or t.is_("name", "recursive"):
            raise TemplateError("loop filters and recursive loops are "
                                "outside the renderer's subset")
        t.done()
        self.loops += 1
        body, end, t = self.body(("else", "endfor"))
        self.loops -= 1
        t.done()
        other: List[Stmt] = []
        if end == "else":
            other, _, t = self.body(("endfor",))
            t.done()

        def run(ctx, out):
            # jinja2 runs the else branch (in a scope of its own) when no
            # iteration ran its body to the end: none, or each left by
            # break or continue
            items = list(seq(ctx))
            completed = False
            for i, item in enumerate(items):
                scope = ctx.new_child()
                if len(names) == 1:
                    scope[names[0]] = item
                else:
                    values = tuple(item)
                    if len(values) != len(names):
                        raise TemplateError("cannot unpack the loop item "
                                            f"into {len(names)} names")
                    scope.update(zip(names, values))
                scope["loop"] = _Loop(i, len(items))
                try:
                    _run(body, scope, out)
                except _Continue:
                    continue
                except _Break:
                    break
                completed = True
            if other and not completed:
                _run(other, ctx.new_child(), out)
        return run

    def set_(self, t: _Tokens) -> Stmt:
        name = t.expect("name")
        attr = t.expect("name") if t.skip("op", ".") else None
        if not t.skip("op", "="):
            raise TemplateError("block sets and tuple targets are outside "
                                "the renderer's subset")
        value = parse_expression(t)
        if t.is_("op", ","):
            raise TemplateError("tuple values are outside the renderer's "
                                "subset")
        t.done()
        if attr is None:
            def run(ctx, out):
                ctx[name] = value(ctx)
            return run

        def run_attr(ctx, out):
            ns = ctx[name] if name in ctx else Undefined(name)
            if not isinstance(ns, Namespace):
                raise TemplateError("cannot assign an attribute of a "
                                    "non-namespace object")
            ns._attrs[attr] = value(ctx)
        return run_attr


class Template:
    """A parsed chat template; ``render`` is cheap to call again."""

    def __init__(self, source: str):
        parser = _Parser(tokenize(source))
        self._body, _, _ = parser.body(())

    def render(self, **variables) -> str:
        out: list = []
        ctx = ChainMap({}, variables, GLOBALS)
        try:
            _run(self._body, ctx, out)
        except TemplateError:
            raise
        except Exception as e:                # what jinja2 would raise too
            raise TemplateError(f"render failed: {e!r}") from e
        return "".join(out)


def compile_template(source: str) -> Template:
    """Parse ``source`` once (raises TemplateError outside the subset)."""
    try:
        return Template(source)
    except TemplateError:
        raise
    except (ValueError, UnicodeError) as e:    # a string escape's decode
        raise TemplateError(f"compile failed: {e!r}") from e
