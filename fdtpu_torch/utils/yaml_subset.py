"""A reader and writer for the YAML the CLIs' configs and run files use.

The machine the port runs on has no PyYAML, and the JAX package's configs
(``configs/**.yaml``) and run files (``train_config.yaml``, ``results.yaml``)
are YAML.  :func:`loads` reads the subset they use and resolves every plain
scalar as ``yaml.safe_load`` does (YAML 1.1, PyYAML's implicit resolvers):
``1.0e-3`` is a float but ``1e-3`` a string, ``1_000`` and
``20260816_201855`` are ints, ``on``/``off``/``yes``/``no`` are booleans,
``~`` and ``null`` are None, ``2020-01-01`` is a date.

The subset: block mappings and sequences (PyYAML's layout, a sequence under a
key at the key's indentation or deeper), ``- key: value`` entries, one-line
flow collections (``{}``, ``[1, 2]``, ``{a: 1, b: [x]}``), plain, single- and
double-quoted scalars on one line, and ``#`` comments.  Anchors, tags, block
scalars (``|``, ``>``), multi-line scalars and multiple documents raise
:class:`YAMLSubsetError` rather than being read wrongly.

:func:`dumps` writes block YAML in PyYAML's ``safe_dump(sort_keys=False)``
layout (floats as PyYAML writes them, strings quoted where a plain scalar
would read back as something else), so that either package reads the file
back to the same value.
"""

from __future__ import annotations

import datetime
import math
import re
from pathlib import Path
from typing import Any


class YAMLSubsetError(ValueError):
    """Input outside the supported subset, or malformed."""


# PyYAML's implicit resolvers (yaml/resolver.py), in the order it tries them.
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)"
)
_INT = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(
    r"(?P<year>[0-9]{4})-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])"
    r"(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)(?::(?P<tz_minute>[0-9][0-9]))?))?)?"
)
_DATE_ONLY = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}")
_UNSUPPORTED_PLAIN = re.compile(r"[&*!|>%@`]|<<$|=$")


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text[0] == "-" else 1
    digits = [cast(part) for part in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    body = text.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    if ":" in body:
        return _sexagesimal(text, int)
    return sign * int(body)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    body = text.lstrip("+-")
    if body == ".inf":
        return sign * math.inf
    if body == ".nan":
        return math.nan
    if ":" in body:
        return _sexagesimal(text, float)
    return sign * float(body)


def _timestamp(m: re.Match) -> datetime.date | datetime.datetime:
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if m["hour"] is None:
        return datetime.date(year, month, day)
    fraction = int((m["fraction"] or "0")[:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        tz = datetime.timezone(-delta if m["tz_sign"] == "-" else delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                             int(m["second"]), fraction, tzinfo=tz)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` resolves it."""
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.fullmatch(text):
        return _float(text)
    if _INT.fullmatch(text):
        return _int(text)
    if _NULL.fullmatch(text):
        return None
    m = _TIMESTAMP.fullmatch(text)
    if m and (m["hour"] is not None or _DATE_ONLY.fullmatch(text)):
        return _timestamp(m)
    if _UNSUPPORTED_PLAIN.match(text):
        raise YAMLSubsetError(f"unsupported YAML construct: {text!r}")
    return text


# ------------------------------------------------------------------ reading
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, pos: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[pos]`` and the index after it."""
    quote = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text.startswith("''", i):
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            code = text[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
            elif code in _HEX_ESCAPES:
                n = _HEX_ESCAPES[code]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YAMLSubsetError(f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise YAMLSubsetError(f"bad escape in {text!r}")
            continue
        out.append(c)
        i += 1
    raise YAMLSubsetError(f"unterminated or multi-line quoted scalar: {text!r}")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``#`` comment (one outside quotes that
    follows whitespace or starts the line)."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            try:
                i = _quoted(text, i)[1]
                continue
            except YAMLSubsetError:
                pass  # a quote inside a plain scalar
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


class _Flow:
    """One-line flow collections and scalars."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def _skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos:self.pos + 1]

    def _expect(self, c: str) -> None:
        if self._peek() != c:
            raise YAMLSubsetError(f"expected {c!r} at {self.pos} in {self.text!r}")
        self.pos += 1

    def node(self) -> Any:
        c = self._peek()
        if c == "[":
            self.pos += 1
            out = []
            while self._peek() != "]":
                out.append(self.node())
                if self._peek() != "]":
                    self._expect(",")
            self.pos += 1
            return out
        if c == "{":
            self.pos += 1
            out = {}
            while self._peek() != "}":
                key = self.node()
                value = None
                if self._peek() == ":":
                    self.pos += 1
                    value = None if self._peek() in (",", "}") else self.node()
                out[key] = value
                if self._peek() != "}":
                    self._expect(",")
            self.pos += 1
            return out
        if c in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos)
            return value
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch in ",[]{}":
                break
            if ch == ":" and self.text[self.pos + 1:self.pos + 2] in ("", " ", "\t"):
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip())

    def whole(self) -> Any:
        value = self.node()
        if self._peek():
            raise YAMLSubsetError(f"trailing text in {self.text!r}")
        return value


def _inline(text: str) -> Any:
    """The value written after ``key:`` or ``-`` on one line."""
    if text[0] in "[{'\"":
        return _Flow(text).whole()
    return resolve_plain(text)


def _key_split(text: str) -> tuple[Any, str] | None:
    """``(key, rest)`` if ``text`` starts a block mapping entry."""
    if text[0] in "[{":
        return None
    if text[0] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        if rest == ":" or rest.startswith((": ", ":\t")):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return resolve_plain(text[:m.start()].rstrip()), text[m.end():].strip()


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Block:
    def __init__(self, source: str) -> None:
        self.lines: list[tuple[int, str]] = []
        for raw in source.splitlines():
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise YAMLSubsetError(f"tab in indentation: {raw!r}")
            text = _strip_comment(body)
            if not text:
                continue
            if re.match(r"(?:---|\.\.\.)(?:[ \t]|$)|%", text):
                raise YAMLSubsetError(f"documents and directives are not supported: {raw!r}")
            self.lines.append((len(raw) - len(body), text))
        self.i = 0

    def node(self) -> Any:
        """The node starting at the current line, at that line's column."""
        col, text = self.lines[self.i]
        if _is_entry(text):
            return self.sequence(col)
        if _key_split(text) is not None:
            return self.mapping(col)
        self.i += 1
        return _inline(text)

    def _value_below(self, col: int, seq_at_col: bool) -> Any:
        """The node on the lines after an empty ``key:`` or ``-``."""
        if self.i < len(self.lines):
            nxt_col, nxt = self.lines[self.i]
            if nxt_col > col or (seq_at_col and nxt_col == col and _is_entry(nxt)):
                return self.node()
        return None

    def mapping(self, col: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            line_col, text = self.lines[self.i]
            if line_col < col:
                break
            split = _key_split(text) if line_col == col else None
            if split is None:
                raise YAMLSubsetError(f"unexpected line in a mapping: {text!r}")
            key, rest = split
            self.i += 1
            out[key] = _inline(rest) if rest else self._value_below(col, seq_at_col=True)
        return out

    def sequence(self, col: int) -> list:
        out = []
        while self.i < len(self.lines):
            line_col, text = self.lines[self.i]
            if line_col < col or (line_col == col and not _is_entry(text)):
                break
            if line_col > col:
                raise YAMLSubsetError(f"unexpected indentation: {text!r}")
            rest = text[1:].lstrip(" \t")
            if not rest:
                self.i += 1
                out.append(self._value_below(col, seq_at_col=False))
                continue
            # The entry's content starts a node at its own column.
            self.lines[self.i] = (col + len(text) - len(rest), rest)
            out.append(self.node())
        return out

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node()
        if self.i != len(self.lines):
            raise YAMLSubsetError(f"unexpected line: {self.lines[self.i][1]!r}")
        return value


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Block(text).document()


def load(path: Path | str) -> Any:
    return loads(Path(path).read_text(encoding="utf-8"))


# ------------------------------------------------------------------ writing
_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_/.][A-Za-z0-9_./-]*")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = float.__repr__(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _PLAIN_SAFE.fullmatch(value) and resolve_plain(value) == value:
            return value
        out = ['"']
        for c in value:
            if c in '"\\':
                out.append("\\" + c)
            elif " " <= c <= "~":
                out.append(c)
            elif ord(c) < 0x10000:
                out.append(f"\\u{ord(c):04x}")
            else:
                out.append(f"\\U{ord(c):08x}")
        out.append('"')
        return "".join(out)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _lines(value: Any, indent: int) -> list[str]:
    pad = " " * indent
    if isinstance(value, dict):
        out = []
        for key, item in value.items():
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, dict) and item:
                out += [head, *_lines(item, indent + 2)]
            elif isinstance(item, list) and item:
                out += [head, *_lines(item, indent)]
            else:
                out.append(f"{head} {_block_or_flow(item)}")
        return out
    if isinstance(value, list):
        out = []
        for item in value:
            if isinstance(item, (dict, list)) and item:
                inner = _lines(item, indent + 2)
                out.append(f"{pad}- {inner[0][indent + 2:]}")
                out += inner[1:]
            else:
                out.append(f"{pad}- {_block_or_flow(item)}")
        return out
    return [pad + _scalar(value)]


def _block_or_flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dumps(value: Any) -> str:
    """``value`` (dicts, lists, str, int, float, bool, None) as block YAML."""
    if isinstance(value, (dict, list)) and not value:
        return _block_or_flow(value) + "\n"
    return "\n".join(_lines(value, 0)) + "\n"


def dump(value: Any, path: Path | str) -> None:
    Path(path).write_text(dumps(value), encoding="utf-8")
