"""A reader and writer for the subset of YAML that ``cfg/*.yaml`` uses:
nested block maps, block lists of scalars, flow lists of scalars, plain
and quoted scalars and comments. Plain scalars resolve as PyYAML's
``safe_load`` resolves them (YAML 1.1: ``1.0e-4`` is a float, ``1e-4`` a
string, ``yes``/``on`` booleans). The training CLI reads its configs with
it where PyYAML is not installed; ``dump`` writes the run directory's copy
in the same subset.
"""

from __future__ import annotations

import re

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")


def scalar(text: str):
    """A plain or quoted scalar as safe_load resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        body = t[1:-1]
        return body.replace("''", "'") if t[0] == "'" else body
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t[0] == "-" else float("inf")
    if _NAN.match(t):
        return float("nan")
    return t


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _value(text: str):
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [scalar(v) for v in inner.split(",")] if inner else []
    if t.startswith("{") and t.endswith("}") and not t[1:-1].strip():
        return {}
    return scalar(t)


def loads(text: str):
    """The document's value (a dict for the configs)."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip() and line.strip() != "---":
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    value, pos = _block(lines, 0, lines[0][0] if lines else 0)
    if pos != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[pos][1]!r}")
    return value


def _block(lines, pos, indent):
    if pos >= len(lines):
        return None, pos
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            out.append(_value(lines[pos][1][1:]))
            pos += 1
        return out, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        text = lines[pos][1]
        m = re.match(r"^((?:'[^']*')|(?:\"[^\"]*\")|[^:]+?):(?:\s+(.*))?$",
                     text)
        if not m:
            raise ValueError(f"not a mapping entry: {text!r}")
        key = scalar(m.group(1))
        pos += 1
        if m.group(2) is not None and m.group(2) != "":
            out[key] = _value(m.group(2))
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("-"))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def load(path: str):
    with open(path) as f:
        return loads(f.read())


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text if ("." in text or "e" in text) else text + ".0"
    s = str(v)
    if scalar(s) != s or s != s.strip() or any(c in s for c in ":#[]{},'\""):
        return "'" + s.replace("'", "''") + "'"
    return s


def dumps(obj, indent: int = 0) -> str:
    """A dict of dicts, lists of scalars and scalars in the subset."""
    pad = " " * indent
    lines = []
    for k, v in obj.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{_dump_scalar(k)}:")
            lines.append(dumps(v, indent + 2).rstrip("\n"))
        elif isinstance(v, dict):
            lines.append(f"{pad}{_dump_scalar(k)}: {{}}")
        elif isinstance(v, (list, tuple)):
            items = ", ".join(_dump_scalar(x) for x in v)
            lines.append(f"{pad}{_dump_scalar(k)}: [{items}]")
        else:
            lines.append(f"{pad}{_dump_scalar(k)}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
