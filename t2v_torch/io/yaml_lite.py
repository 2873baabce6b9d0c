"""A reader for the subset of YAML that a VideoCrafter ``model_config.yaml``
uses, with no YAML package (the GPU host has none).

The subset: block mappings with plain keys, block sequences of scalars (a
sequence may sit at its key's indentation), one-line flow lists of
scalars (``[1, 2, 4]``, ``[]``), comments, a leading ``---``, plain scalars
resolved as PyYAML's ``safe_load`` resolves them (null, booleans, decimal
ints, floats with a dot, else strings) and quoted strings without escapes.
Anything else (flow mappings, nested collections in a sequence, anchors,
aliases, tags, block scalars, multi-line scalars or flow lists, tabs in
indentation, duplicate keys, numbers or dates PyYAML reads in another
form, a second document) raises ``YAMLSubsetError`` with its line: the
reader never guesses.
"""

from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
# plain scalars PyYAML resolves to something this reader does not: octal,
# hex, binary and sexagesimal numbers, .inf / .nan, dates and timestamps
_OTHER = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(:[0-5]?[0-9])+"
                    r"(\.[0-9_]*)?|\.(inf|Inf|INF|nan|NaN|NAN))$|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_QUOTED = re.compile(r"'((?:[^']|'')*)'|\"([^\"\\]*)\"")


class YAMLSubsetError(ValueError):
    pass


def _err(lineno: int, msg: str) -> YAMLSubsetError:
    return YAMLSubsetError(f"line {lineno}: {msg}")


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without a trailing comment (a ``#`` at the start or after a
    space, outside quotes; a quote opens at the start or after one of
    `` [,:-``, and ``''`` stays inside a single-quoted string)."""
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote and quote == "'" and text[i + 1 : i + 2] == "'":
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise _err(lineno, "unterminated quoted string")
    return text.rstrip()


def _scalar(text: str, lineno: int):
    """A plain or quoted scalar as ``safe_load`` resolves it."""
    if text[:1] in ("'", '"'):
        m = _QUOTED.fullmatch(text)
        if m is None:
            raise _err(lineno, f"quoted string {text!r} is outside the supported subset")
        return m.group(1).replace("''", "'") if m.group(1) is not None else m.group(2)
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(ch.isdigit() for ch in text):
        return float(text.replace("_", ""))
    if _OTHER.match(text):
        raise _err(lineno, f"number form {text!r} is outside the supported subset")
    if text[0] in "|>":
        raise _err(lineno, "block scalars are outside the supported subset")
    if text[0] in "&*!%@`[]{},?" or text == "=" or ": " in text or text.endswith(":"):
        raise _err(lineno, f"plain scalar {text!r} is outside the supported subset")
    return text


def _value(text: str, lineno: int):
    """The value after a ``key:`` or ``-``: a one-line flow list or a scalar."""
    if not text.startswith("["):
        return _scalar(text, lineno)
    if not text.endswith("]"):
        raise _err(lineno, f"a multi-line flow list or text after it in {text!r}")
    items, item, quote = [], "", None
    for c in text[1:-1]:
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"" and not item.strip():  # a quote opens only an item
            quote = c
        elif c in "[]{}":
            raise _err(lineno, f"nested flow collections are outside the subset: {text!r}")
        elif c == ",":
            items.append(item.strip())
            item = ""
            continue
        item += c
    items.append(item.strip())
    if items == [""]:
        return []
    if "" in items:
        raise _err(lineno, f"an empty flow list item in {text!r}")
    return [_scalar(x, lineno) for x in items]


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _split_key(content: str, lineno: int):
    m = re.search(r":( |$)", content)
    key = content[: m.start()] if m else ""
    if not key or key[0] in "-?" or any(ch in key for ch in "[]{},#&*!|><'\"%@`"):
        raise _err(lineno, f"expected 'key: value' with a plain key, got {content!r}")
    return _scalar(key, lineno), content[m.end() :].strip()


def _lines(text: str) -> list[tuple[int, str, int]]:
    """(indent, content, line number) of every line that holds content."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _err(n, "a tab in the indentation")
        content = _strip_comment(body, n)
        if content:
            out.append((len(raw) - len(body), content, n))
    if out and out[0][1] == "---":
        out.pop(0)
    for _, content, n in out:
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            raise _err(n, "more than one document, or a directive")
    return out


def _check_dedent(lines, i: int, indent: int) -> None:
    if i < len(lines) and lines[i][0] > indent:
        raise _err(lines[i][2], "unexpected indentation (a multi-line scalar or flow list)")


def _seq(lines, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        _, content, n = lines[i]
        rest = content[1:].strip()
        if not rest or _is_item(rest) or re.search(r":( |$)", rest):
            raise _err(n, "a nested collection in a sequence item is outside the subset")
        out.append(_value(rest, n))
        i += 1
    _check_dedent(lines, i, indent)
    return out, i


def _map(lines, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, n = lines[i]
        if _is_item(content):
            raise _err(n, "a sequence item where a mapping key was expected")
        key, rest = _split_key(content, n)
        if key in out:
            raise _err(n, f"duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _value(rest, n)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_item(lines[i][1]))):
            nested = lines[i][0]
            out[key], i = (_seq if _is_item(lines[i][1]) else _map)(lines, i, nested)
        else:
            out[key] = None
        _check_dedent(lines, i, indent)
    return out, i


def safe_load(text: str):
    """Parse ``text`` (the supported subset) into dicts, lists and scalars,
    as ``yaml.safe_load`` would."""
    lines = _lines(text)
    if not lines:
        return None
    indent = lines[0][0]
    value, i = (_seq if _is_item(lines[0][1]) else _map)(lines, 0, indent)
    if i != len(lines):
        raise _err(lines[i][2], "text after the document's top-level node")
    return value


def load_file(path: str):
    with open(path, encoding="utf-8") as f:
        return safe_load(f.read())
