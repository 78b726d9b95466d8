"""A reader for the YAML subset that the model configs use, without PyYAML.

It handles what the JAX package's files under `cfg/models/` hold (all 126
read as `yaml.safe_load` reads them): `key: value` lines, block mappings
(`scales:` with `n: [...]` rows), block sequences of flow lists
(`- [-1, 1, Conv, [64, 3, 2]]`) and of block nodes, nested on one line as
PyYAML's block dumps write them (`- - -1`, `- 0.33` under `n:`), a sequence
at its key's own column, nested flow lists, quoted and plain scalars, and
`#` comments (one right after a flow value's closing bracket too). Plain
scalars resolve as `yaml.safe_load` (YAML 1.1) resolves them: ints, floats
that carry a dot, true/false/yes/no/on/off, null/~, and strings otherwise
(so `None` stays the string "None" and `1e-3` the string "1e-3"). Anything
outside the subset raises ValueError.
"""

from __future__ import annotations

import re
from pathlib import Path

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_NULL = {"null", "Null", "NULL", "~", ""}


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok.lower() in _BOOL and tok in (tok.lower(), tok.capitalize(), tok.upper()):
        return _BOOL[tok.lower()]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok) and tok not in (".", "+.", "-."):
        return float(tok.replace("_", ""))
    if tok[:1] in "[]{}&*!|>%@`,":
        raise ValueError(f"unsupported YAML scalar {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(text: str):
    """Parse one flow value: a scalar or a (nested) [..] list."""
    pos = 0

    def value():
        nonlocal pos
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos < len(text) and text[pos] == "[":
            pos += 1
            items = []
            while True:
                while pos < len(text) and text[pos] == " ":
                    pos += 1
                if pos < len(text) and text[pos] == "]":
                    pos += 1
                    return items
                items.append(value())
                while pos < len(text) and text[pos] == " ":
                    pos += 1
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                elif pos < len(text) and text[pos] == "]":
                    continue
                else:
                    raise ValueError(f"malformed flow list: {text!r}")
        start = pos
        quote = text[pos] if pos < len(text) and text[pos] in "'\"" else None
        if quote:
            end = text.index(quote, pos + 1)
            pos = end + 1
            return text[start + 1:end]
        while pos < len(text) and text[pos] not in ",]":
            pos += 1
        return _scalar(text[start:pos])

    out = value()
    if text[pos:].strip() and not text[pos:].lstrip().startswith("#"):  # a comment may follow a closing bracket
        raise ValueError(f"trailing text after flow value: {text!r}")
    return out


def _key_value(body: str):
    if ":" not in body:
        raise ValueError(f"expected 'key: value', got {body!r}")
    key, _, rest = body.partition(":")
    if rest and not rest.startswith(" "):
        raise ValueError(f"expected 'key: value', got {body!r}")
    return _scalar(key), rest.strip()


def _is_item(body: str) -> bool:
    """A block-sequence entry: '- x' or a bare '-'."""
    return body == "-" or body.startswith("- ")


def _is_key(body: str) -> bool:
    """A block-mapping entry: 'key: value' or 'key:' (not a flow list or a quoted scalar)."""
    return body[0] not in "['\"" and (": " in body or body.endswith(":"))


def _block(lines: list, i: int, indent: int):
    """The block node whose first line, lines[i], sits at `indent`: a
    sequence of '- ' entries or a mapping of 'key:' entries. Returns (value,
    index of the next line)."""
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines: list, i: int, indent: int):
    items = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        body = lines[i][1]
        rest = body[1:].lstrip(" ")
        if not rest:  # the entry's node starts on the next, deeper line
            if i + 1 < len(lines) and lines[i + 1][0] > indent:
                value, i = _block(lines, i + 1, lines[i + 1][0])
            else:
                value, i = None, i + 1
        elif _is_item(rest) or _is_key(rest):
            # a nested block node on the entry's own line ('- - -1', '- key: v'): it
            # starts at the column of its text, and its later lines line up there
            lines[i] = (indent + len(body) - len(rest), rest)
            value, i = _block(lines, i, lines[i][0])
        else:
            value, i = _flow(rest), i + 1
        items.append(value)
    return items, i


def _mapping(lines: list, i: int, indent: int):
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        key, rest = _key_value(lines[i][1])
        i += 1
        if rest:
            out[key] = _flow(rest)
        elif i < len(lines) and (lines[i][0] > indent or lines[i][0] == indent and _is_item(lines[i][1])):
            out[key], i = _block(lines, i, lines[i][0])  # a sequence may sit at its key's column
        else:
            out[key] = None
    return out, i


def loads(text: str) -> dict:
    """Parse the model-config subset of YAML into a dict."""
    lines = []
    for raw in text.replace("\t", "  ").splitlines():
        line = _strip_comment(raw)
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    if lines[0][0] != 0 or _is_item(lines[0][1]):
        raise ValueError(f"expected a top-level mapping, got {lines[0][1]!r}")
    out, i = _mapping(lines, 0, 0)
    if i < len(lines):
        raise ValueError(f"unexpected indentation: {lines[i][1]!r}")
    return out


def load(path) -> dict:
    """Read and parse one config file."""
    return loads(Path(path).read_text(encoding="utf-8"))
