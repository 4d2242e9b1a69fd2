"""Configs as attribute-accessible nested dicts, and the YAML reader that
fills them.

The JAX package reads its YAML configs (rangeldm_tpu/configs/*.yaml) with
PyYAML into `Cfg` (rangeldm_tpu/utils/config.py). The card's machine has no
PyYAML, so this module carries its own reader for the block-YAML subset
those configs are written in:

* nested block mappings, indented with spaces;
* flow lists of scalars, `[1, 2, 4]` (nested flow lists too), on one line;
* `#` comments, on their own line or after a value;
* scalars resolved as PyYAML's `safe_load` resolves them: null (`null`,
  `~`, nothing), booleans (`true`/`false` and YAML 1.1's `yes`/`no`/`on`/
  `off`), decimal ints, floats with a dot (`1.0e-4`, `.5`, `.inf`, `.nan`),
  and plain, single- or double-quoted strings (`1e-4` is a string, as in
  PyYAML).

Anything else (anchors and aliases, tags, block scalars, block sequences,
flow mappings, document markers, directives, octal, hex, sexagesimal and
date scalars, keys that are not strings, duplicate keys) raises ValueError
naming the file and the line. `.get(key, default)` mirrors the reference's
`hasattr(args, ...)` feature gates (ldm/train_unconditional.py:370-389).
"""

from __future__ import annotations

import copy
import importlib
import os
import re
from typing import Any, List, Mapping, Optional, Tuple


class Cfg(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Cfg({k: Cfg.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(Cfg.wrap(v) for v in obj)
        return obj

    def merged(self, other: Mapping) -> "Cfg":
        """Deep merge: values in `other` win."""
        out = copy.deepcopy(dict(self))
        for k, v in other.items():
            if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                out[k] = Cfg.wrap(out[k]).merged(v)
            else:
                out[k] = copy.deepcopy(v)
        return Cfg.wrap(out)


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
# plain scalars that PyYAML would read as something this reader does not
# make: octal, hex, binary and sexagesimal numbers, dates and times
_REFUSED = re.compile(r"[-+]?0[0-9_]+$|[-+]?0[xob]"
                      r"|[-+]?[0-9][0-9_]*(\.[0-9_]*)?:"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
# indicators that may not begin a plain scalar (flow lists and quotes are
# handled before this check); "-", "?" and ":" only before a space
_INDICATORS = set(",]{}#&*!|>%@`")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0", " ": " "}


class _Line:
    def __init__(self, where: str, number: int, text: str):
        self.where, self.number, self.text = where, number, text

    def error(self, msg: str) -> ValueError:
        return ValueError(f"{self.where}:{self.number}: {msg} (the config "
                          f"reader takes block mappings, one-line flow "
                          f"lists, comments and plain or quoted scalars): "
                          f"{self.text.rstrip()!r}")


def _strip_comment(text: str, line: _Line) -> str:
    """The line without its comment: a `#` at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if quote:
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise line.error("unterminated quoted string")
    return text.rstrip()


def _quoted(text: str, line: _Line) -> Tuple[str, str]:
    """(the string, the rest of the text) of a quoted scalar at the start
    of `text`."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if quote == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise line.error(f"escape \\{esc} is not supported")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise line.error("unterminated quoted string")


def _plain(text: str, line: _Line) -> Any:
    """The value of a plain scalar, resolved as PyYAML resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float(text[:-4] + "inf")
    if _NAN.match(text):
        return float("nan")
    if _REFUSED.match(text):
        raise line.error(f"scalar {text!r} (octal, hex, binary, "
                         f"sexagesimal or date) is not supported")
    if (_indicator(text) or text in ("<<", "=") or ": " in text
            or text.endswith(":")):
        raise line.error(f"plain scalar {text!r} starts with an indicator "
                         f"(anchor, alias, tag, block scalar, flow mapping, "
                         f"sequence entry) or holds ': '")
    return text


def _indicator(text: str) -> bool:
    """Whether a plain scalar would begin with a YAML indicator."""
    return text[0] in _INDICATORS or (text[0] in "-?:" and text[1:2] in
                                      ("", " "))


def _flow_list(text: str, line: _Line) -> Tuple[List[Any], str]:
    """(the list, the rest of the text) of a flow list at the start of
    `text`."""
    items: List[Any] = []
    rest = text[1:].lstrip()
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if not rest:
            raise line.error("a flow list must close on its own line")
        if rest[0] == "[":
            item, rest = _flow_list(rest, line)
        elif rest[0] in "'\"":
            item, rest = _quoted(rest, line)
        elif rest[0] == "{":
            raise line.error("flow mappings are not supported")
        else:
            m = re.match(r"[^,\[\]{}]*", rest)
            token = m.group(0).strip()
            if not token:
                raise line.error("empty flow list entry")
            item, rest = _plain(token, line), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith(","):
            rest = rest[1:].lstrip()
        elif rest.startswith("]"):
            return items, rest[1:]
        else:
            raise line.error("expected ',' or ']' in a flow list")


def _value(text: str, line: _Line) -> Any:
    """The value after `key:` on one line."""
    if not text:
        return None
    if text[0] == "[":
        value, rest = _flow_list(text, line)
    elif text[0] in "'\"":
        value, rest = _quoted(text, line)
    else:
        return _plain(text, line)
    if rest.strip():
        raise line.error(f"unexpected text after the value: {rest.strip()!r}")
    return value


def _key(text: str, line: _Line) -> Tuple[str, str]:
    """(key, the text after its colon) of a `key: value` line."""
    if text[0] in "'\"":
        key, rest = _quoted(text, line)
        if not (rest.startswith(":") and (len(rest) == 1 or rest[1] == " ")):
            raise line.error("expected ':' after a quoted key")
        return key, rest[1:].strip()
    m = re.search(r":( |$)", text)
    if m is None:
        raise line.error("expected 'key: value' (block sequences and bare "
                         "scalars are not supported)")
    raw = text[:m.start()].rstrip()
    if not raw or _indicator(raw) or raw == "<<":
        raise line.error(f"key {raw!r} is not supported")
    key = _plain(raw, line)
    if not isinstance(key, str):
        raise line.error(f"key {raw!r} would not be a string")
    return key, text[m.end():].strip()


def parse_yaml(text: str, where: str = "<string>") -> dict:
    """The mapping of a YAML document in the subset this module reads."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        line = _Line(where, number, raw)
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise line.error("tabs in indentation are not supported")
        body = _strip_comment(body, line)
        if not body:
            continue
        if body.startswith("%") or (body.startswith(("---", "..."))
                                    and body[3:4] in ("", " ")):
            raise line.error("directives and document markers (multi-"
                             "document files) are not supported")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, line))

    def block(i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(lines):
            ind, body, line = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise line.error("unexpected indentation")
            key, rest = _key(body, line)
            if key in out:
                raise line.error(f"duplicate key {key!r}")
            i += 1
            if rest:
                out[key] = _value(rest, line)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if not lines:
        return {}
    if lines[0][0] != 0:
        raise lines[0][2].error("the top-level mapping must not be indented")
    out, _ = block(0, 0)
    return out


def load_config(*paths: str, overrides: Optional[Mapping] = None) -> Cfg:
    """Read YAML files and merge them left to right (later files win), then
    `overrides` (vae/main.py:632-636)."""
    cfg = Cfg()
    for path in paths:
        with open(path) as f:
            cfg = cfg.merged(parse_yaml(f.read(), path))
    if overrides:
        cfg = cfg.merged(overrides)
    return Cfg.wrap(cfg)


def expand_env(obj: Any) -> Any:
    """`${NAME}` in every string -> the environment variable NAME, or ''
    when it is unset (rangeldm_tpu/train_ldm.py:39-47)."""
    if isinstance(obj, Mapping):
        return Cfg({k: expand_env(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [expand_env(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"\$\{(\w+)\}",
                      lambda m: os.environ.get(m.group(1), ""), obj)
    return obj


JAX_PACKAGE = "rangeldm_tpu"
PORT_PACKAGE = "rangeldm_tpu_torch"


def instantiate(spec: Mapping, **extra_kwargs) -> Any:
    """`{'target': 'pkg.mod.Cls', 'params': {...}}` -> `Cls(**params,
    **extra_kwargs)` (the vae/sgm/util.py:168-185 convention, as the JAX
    package's rangeldm_tpu/utils/config.py:61-69 keeps it). A target in the
    JAX package names this package's counterpart at the same module path
    (`rangeldm_tpu.models.discriminator.NLayerDiscriminator` ->
    `rangeldm_tpu_torch.models.discriminator.NLayerDiscriminator`); the
    JAX package itself is never imported."""
    target = spec["target"]
    if target.split(".")[0] == JAX_PACKAGE:
        target = PORT_PACKAGE + target[len(JAX_PACKAGE):]
    module, name = target.rsplit(".", 1)
    fn = getattr(importlib.import_module(module), name)
    kwargs = dict(spec.get("params", {}) or {})
    kwargs.update(extra_kwargs)
    return fn(**kwargs)
