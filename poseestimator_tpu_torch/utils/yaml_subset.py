"""A reader and writer for the YAML this repository holds, without PyYAML:
``detection/dataset.yaml``, the seibersdorf calibration files (``K``,
``D``, and ``T`` or ``xyz`` + ``rpy``) and ``utils/config.save_config``'s
output.

The subset: block mappings and sequences (sequences indented or at their
key's column), flow mappings and sequences (``{a: 1}``, ``[1, 2]``), plain,
single- and double-quoted scalars, comments, and one leading ``---``.
Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1): null
(``~``, ``null``, empty), booleans (``true``/``yes``/``on`` and their
opposites), integers (decimal, ``0x`` hex, ``0`` octal, ``0b`` binary;
underscores allowed) and floats (a dot required, a signed exponent,
``.inf``, ``.nan``); anything else is a string. Anchors, aliases, tags,
block scalars (``|``, ``>``) and multi-document streams raise ``ValueError``.
``dump`` writes block style with two-space indents, as
``yaml.safe_dump(..., sort_keys=False)`` does, quoting strings that would
read back as another type.
"""
from __future__ import annotations

import math
import re

_INT = re.compile(r"[-+]?(0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)([eE][-+][0-9]+)?")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")


def _resolve(s: str):
    """A plain scalar's value."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    low = s.lstrip("+-")
    if low in (".inf", ".Inf", ".INF"):
        return -math.inf if s[0] == "-" else math.inf
    if s in (".nan", ".NaN", ".NAN"):
        return math.nan
    if s[0] in "&*!|>%@`":
        raise ValueError(f"YAML subset: unsupported construct {s!r} (anchors, aliases, tags and "
                         f"block scalars are not read)")
    return s


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at the start or after a space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """``(key, rest)`` when ``text`` is ``key: rest`` (the colon outside
    quotes and brackets, followed by a space or the end), else None."""
    quote, depth = None, 0
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _quoted(s: str, i: int):
    """The quoted scalar starting at ``s[i]``: ``(value, index after it)``."""
    q = s[i]
    j = i + 1
    out = []
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1]
            out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
                        "r": "\r", " ": " "}.get(e, "\\" + e))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"YAML subset: unterminated quoted scalar in {s!r}")


def _scalar(text: str):
    text = text.strip()
    if text[:1] in ("'", '"'):
        v, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"YAML subset: text after a quoted scalar in {text!r}")
        return v
    return _resolve(text)


def _flow(s: str, i: int):
    """The flow node starting at ``s[i]``: ``(value, index after it)``."""
    while s[i] == " ":
        i += 1
    if s[i] in "[{":
        close = "]" if s[i] == "[" else "}"
        items, i = [], i + 1
        while True:
            while s[i] == " ":
                i += 1
            if s[i] == close:
                i += 1
                break
            if close == "}":
                key, i = _flow(s, i)
                while s[i] == " ":
                    i += 1
                if s[i] != ":":
                    raise ValueError(f"YAML subset: expected ':' in {s!r}")
                val, i = _flow(s, i + 1)
                items.append((key, val))
            else:
                val, i = _flow(s, i)
                items.append(val)
            while s[i] == " ":
                i += 1
            if s[i] == ",":
                i += 1
            elif s[i] != close:
                raise ValueError(f"YAML subset: expected ',' or {close!r} in {s!r}")
        return (dict(items) if close == "}" else items), i
    if s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and s[j + 1:j + 2] in (" ", "")):
        j += 1
    return _resolve(s[i:j].strip()), j


def _value(text: str):
    """An inline value: a flow collection or a scalar."""
    if text[:1] in "[{":
        v, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"YAML subset: text after a flow collection in {text!r}")
        return v
    return _scalar(text)


def _lines(text: str) -> list:
    out, started = [], False
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("YAML subset: tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.startswith("---") or line.startswith("..."):
            if started or line.startswith("..."):
                raise ValueError("YAML subset: multi-document streams are not read")
            if line[3:].strip():
                raise ValueError("YAML subset: content after '---' is not read")
            continue
        started = True
        out.append([len(line) - len(line.lstrip()), line.strip()])
    # a flow collection over several lines becomes one line
    merged = []
    for ind, t in out:
        if merged and merged[-1][2] > 0:
            merged[-1][1] += " " + t
        else:
            merged.append([ind, t, 0])
        prev = merged[-1]
        prev[2] = sum(prev[1].count(c) for c in "[{") - sum(prev[1].count(c) for c in "]}")
    return [(ind, t) for ind, t, _ in merged]


def _block(lines: list, i: int, indent: int):
    """The block node whose lines start at ``lines[i]`` at ``indent``:
    ``(value, next line index)``."""
    ind, text = lines[i]
    if text == "-" or text.startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip()
            if not rest:  # the item is the nested block below
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    v, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    v, i = None, i + 1
            elif rest.startswith("- ") or (_split_key(rest) and rest[:1] not in "[{'\""):
                # an inline nested block: re-read the rest at its own column
                col = indent + len(lines[i][1]) - len(rest)
                sub = [(col, rest)] + lines[i + 1:]
                v, j = _block(sub, 0, col)
                i = i + j
            else:
                v, i = _value(rest), i + 1
            seq.append(v)
        return seq, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        kv = _split_key(text)
        if kv is None or text.startswith("- "):
            raise ValueError(f"YAML subset: expected 'key: value' at {text!r}")
        key, rest = _scalar(kv[0]) if kv[0] else None, kv[1]
        if key in out:
            raise ValueError(f"YAML subset: duplicate key {key!r}")
        if rest:
            out[key], i = _value(rest), i + 1
        elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                lines[i + 1][0] == indent and (lines[i + 1][1] == "-"
                                               or lines[i + 1][1].startswith("- ")))):
            out[key], i = _block(lines, i + 1, lines[i + 1][0])
        else:
            out[key], i = None, i + 1
    return out, i


def loads(text: str):
    """The document in ``text`` (None when it is empty)."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and not lines[0][1].startswith("-"):
        return _value(lines[0][1])
    v, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"YAML subset: unexpected indentation at {lines[i][1]!r}")
    return v


def load(path: str):
    with open(path) as f:
        return loads(f.read())


def _plain_ok(s: str) -> bool:
    """Whether a string can be written unquoted and read back as itself."""
    if not s or s != s.strip() or s[0] in "-?:,[]{}#&*!|>'\"%@`" or "\n" in s:
        return False
    if ": " in s or " #" in s or s.endswith(":"):
        return False
    try:
        return _resolve(s) == s
    except ValueError:
        return False


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:  # PyYAML's form: 1e-05 -> 1.0e-05
            m, e = r.split("e")
            r = f"{m}.0e{e}"
        elif "." not in r:
            r += ".0"
        if "e" in r and r.split("e")[1][0] not in "+-":
            m, e = r.split("e")
            r = f"{m}e+{e}"
        return r
    s = str(v)
    if _plain_ok(s):
        return s
    if "\n" in s or any(ord(c) < 32 for c in s):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    return "'" + s.replace("'", "''") + "'"


def _dump(v, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _dump_scalar(k)
            if isinstance(x, (dict, list)) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2 if isinstance(x, dict) else indent, out)
            else:
                out.append(f"{pad}{key}: " + ("{}" if x == {} else "[]" if x == [] else
                                               _dump_scalar(x)))
    else:
        for x in v:
            if isinstance(x, (dict, list)) and x:
                out.append(f"{pad}-")
                _dump(x, indent + 2, out)
            else:
                out.append(f"{pad}- " + ("{}" if x == {} else "[]" if x == [] else
                                         _dump_scalar(x)))


def dumps(data) -> str:
    """Block-style YAML of nested dicts, lists and scalars."""
    if not isinstance(data, (dict, list)) or not data:
        return ("{}" if data == {} else "[]" if data == [] else _dump_scalar(data)) + "\n"
    out: list = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"


def dump(data, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))
