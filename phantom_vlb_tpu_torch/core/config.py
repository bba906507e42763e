"""Hydra-like configuration: compose, override, interpolate, instantiate.

Counterpart of ``phantom_vlb_tpu/core/config.py``: a ``defaults`` list
composes a base config with an experiment overlay at the global package,
``key=value`` overrides mutate the tree, ``${a.b.c}`` interpolates against
the composed root, ``${env:VAR[,default]}`` and ``$VAR`` read the
environment, and ``_target_`` nodes instantiate objects.

The JAX package reads YAML with ``yaml.safe_load``; this package reads it
with :func:`parse_yaml`, a reader of its own for the subset the repository's
configs and overrides use (the card's machine has no ``yaml``):

- block mappings and block lists (a list item may be a mapping, as in
  ``- experiment: null``), and flow lists ``[a, [b, c]]``;
- ``#`` comments, plain scalars, and single- or double-quoted scalars on
  one line;
- plain scalars typed by PyYAML's YAML 1.1 rules: ``null``/``~``/empty are
  None, ``yes``/``no``/``on``/``off``/``true``/``false`` (three casings)
  are booleans, integers in decimal, ``0x``, ``0b``, ``0`` octal and
  base 60, floats only with a dot (``1.0e-4`` is a float, ``1e-4`` a
  string), ``.inf`` and ``.nan``.

Anything else (anchors, aliases, tags, block or multi-line scalars, flow
mappings, several documents, dates) raises :class:`YAMLSubsetError`
rather than being guessed. Overrides and ``${env:VAR,default}`` defaults
are read by the same reader; where the JAX package keeps an override that
is not YAML at all (``[a``) as its text, this one raises.
"""

from __future__ import annotations

import copy
import importlib
import os
import re
from pathlib import Path
from typing import Any, Iterable, Mapping

__all__ = ["Config", "YAMLSubsetError", "parse_yaml", "dump_yaml", "load_config", "resolve",
           "instantiate", "to_dict"]

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
_ENV_RE = re.compile(r"\$([A-Z_][A-Z0-9_]*)")


class Config(dict):
    """A dict with attribute access and dotted-path get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.isdigit():
                node = node[int(part)]
            else:
                if default is ...:
                    raise KeyError(path)
                return default
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if not isinstance(node.get(part), Mapping):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


# ---------------------------------------------------------------------------
# The YAML subset

class YAMLSubsetError(ValueError):
    """The text uses YAML this reader does not take, or is not YAML."""


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1.
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# Characters that PyYAML takes as an indicator at the start of a plain scalar.
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                      ">": "block scalars", "{": "flow mappings", "%": "directives",
                      "@": "reserved indicators", "`": "reserved indicators",
                      "?": "complex keys"}


def _sexagesimal(text: str, convert) -> Any:
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += convert(part) * base
        base *= 60
    return sign * value


def _to_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    body = text[1:] if text[0] in "+-" else text
    if ":" in body:
        return _sexagesimal(text, int)
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _to_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    body = text[1:] if text[0] in "+-" else text
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return _sexagesimal(text, float)
    return sign * float(body)


def _plain(text: str) -> Any:
    """A plain scalar typed as PyYAML's SafeLoader types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        return _to_int(text)
    if _FLOAT_RE.match(text):
        return _to_float(text)
    if _TIMESTAMP_RE.match(text):
        raise YAMLSubsetError(f"timestamps are not supported: {text!r}")
    if text == "=" or text.startswith("<<"):
        raise YAMLSubsetError(f"value and merge keys are not supported: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` -> (value, index after it)."""
    quote, out, j = text[i], [], i + 1
    while j < len(text):
        ch = text[j]
        if quote == "'":
            if ch == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
            continue
        if ch == '"':
            return "".join(out), j + 1
        if ch == "\\":
            esc = text[j + 1:j + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                j += 2
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = text[j + 2:j + 2 + n]
                if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                    raise YAMLSubsetError(f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise YAMLSubsetError(f"unsupported escape in {text!r}")
            continue
        out.append(ch)
        j += 1
    raise YAMLSubsetError(f"multi-line or unterminated quoted scalars are not supported: {text!r}")


def _check_plain_start(text: str) -> None:
    if not text:
        return
    ch = text[0]
    if ch in _UNSUPPORTED_START and not (ch == "?" and text[1:2] not in ("", " ")):
        raise YAMLSubsetError(f"{_UNSUPPORTED_START[ch]} are not supported: {text!r}")
    if ch in ",]}":
        raise YAMLSubsetError(f"unexpected {ch!r} in {text!r}")
    if text.startswith(("- ", "? ")) or text in ("-", "?"):
        raise YAMLSubsetError(f"unexpected indicator in {text!r}")


def _flow_list(text: str, i: int) -> tuple[list, int]:
    """The flow list starting at ``text[i] == '['`` -> (items, index after it)."""
    items: list = []
    j = i + 1
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise YAMLSubsetError(f"multi-line flow lists are not supported: {text!r}")
        ch = text[j]
        if ch == "]":
            return items, j + 1
        if ch == "[":
            item, j = _flow_list(text, j)
        elif ch in "'\"":
            item, j = _quoted(text, j)
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                if text[k] == ":" and (k + 1 == len(text) or text[k + 1] in " ,[]{}"):
                    raise YAMLSubsetError(f"mappings inside flow lists are not supported: {text!r}")
                k += 1
            raw = text[j:k].rstrip()
            if not raw:
                raise YAMLSubsetError(f"empty flow list entry in {text!r}")
            _check_plain_start(raw)
            item, j = _plain(raw), k
        items.append(item)
        while j < len(text) and text[j] == " ":
            j += 1
        if j < len(text) and text[j] == ",":
            j += 1
        elif j >= len(text) or text[j] != "]":
            raise YAMLSubsetError(f"bad flow list: {text!r}")


def _inline(text: str) -> Any:
    """A value written on one line: a flow list, a quoted or a plain scalar."""
    text = text.strip()
    if text.startswith("["):
        value, end = _flow_list(text, 0)
    elif text.startswith(("'", '"')):
        value, end = _quoted(text, 0)
    else:
        _check_plain_start(text)
        if ": " in text or text.endswith(":") or " #" in text:
            raise YAMLSubsetError(f"unexpected mapping or comment in a scalar: {text!r}")
        return _plain(text)
    if text[end:].strip():
        raise YAMLSubsetError(f"text after a closed value: {text!r}")
    return value


def _strip_comment(line: str) -> str:
    """``line`` without its ``#`` comment (a ``#`` at the start or after
    whitespace, outside quotes), right-stripped."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _split_key(text: str) -> tuple[str, str] | None:
    """``key: value`` or ``key:`` -> (key text, value text); None when the
    line is no mapping entry."""
    if text.startswith(("'", '"')):
        _, end = _quoted(text, 0)
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return text[:end], rest[1:].strip()
        return None
    if text.startswith("["):
        return None
    for m in re.finditer(":", text):
        j = m.start()
        if j + 1 == len(text) or text[j + 1] == " ":
            return text[:j].rstrip(), text[j + 1:].strip()
    return None


def _key(text: str) -> Any:
    if text.startswith(("'", '"')):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise YAMLSubsetError(f"bad key: {text!r}")
        return value
    _check_plain_start(text)
    return _plain(text)


class _Lines:
    def __init__(self, text: str):
        self.items: list[tuple[int, str]] = []      # (indent, content)
        seen_start = False
        for raw in text.splitlines():
            line = _strip_comment(raw)
            if not line.strip():
                continue
            stripped = line.lstrip(" ")
            if stripped.startswith("\t") or "\t" in line[: len(line) - len(stripped)]:
                raise YAMLSubsetError("tabs in indentation are not supported")
            if line.startswith("%"):
                raise YAMLSubsetError("directives are not supported")
            if line.startswith("---") and line[3:4] in ("", " "):
                if seen_start or self.items or line[3:].strip():
                    raise YAMLSubsetError("several documents are not supported")
                seen_start = True
                continue
            if line.startswith("...") and line[3:4] in ("", " "):
                raise YAMLSubsetError("document end markers are not supported")
            self.items.append((len(line) - len(stripped), stripped))


def _is_seq_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, i: int, indent: int) -> tuple[Any, int]:
    """The block node whose first line is ``lines.items[i]`` at ``indent``."""
    content = lines.items[i][1]
    if _is_seq_item(content):
        return _sequence(lines, i, indent)
    if _split_key(content) is not None:
        return _mapping(lines, i, indent)
    value = _inline(content)
    if i + 1 < len(lines.items) and lines.items[i + 1][0] >= indent:
        raise YAMLSubsetError(f"multi-line scalars are not supported: {content!r}")
    return value, i + 1


def _nested(lines: _Lines, i: int, indent: int, allow_same_indent_seq: bool) -> tuple[Any, int]:
    """The value of an entry whose own line ends at ``i - 1`` (``key:`` or
    ``-``): the deeper block that follows, or None."""
    if i < len(lines.items):
        sub_indent, sub = lines.items[i]
        if sub_indent > indent:
            return _block(lines, i, sub_indent)
        if allow_same_indent_seq and sub_indent == indent and _is_seq_item(sub):
            return _sequence(lines, i, indent)
    return None, i


def _after_inline(lines: _Lines, i: int, indent: int) -> None:
    if i < len(lines.items) and lines.items[i][0] > indent:
        raise YAMLSubsetError(f"multi-line scalars are not supported near {lines.items[i][1]!r}")


def _mapping(lines: _Lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines.items) and lines.items[i][0] == indent:
        content = lines.items[i][1]
        if _is_seq_item(content):
            break
        split = _split_key(content)
        if split is None:
            raise YAMLSubsetError(f"expected 'key: value', got {content!r}")
        key = _key(split[0])
        if split[1]:
            out[key] = _inline(split[1])
            i += 1
            _after_inline(lines, i, indent)
        else:
            out[key], i = _nested(lines, i + 1, indent, allow_same_indent_seq=True)
    if i < len(lines.items) and lines.items[i][0] > indent:
        raise YAMLSubsetError(f"bad indentation at {lines.items[i][1]!r}")
    return out, i


def _sequence(lines: _Lines, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines.items) and lines.items[i][0] == indent and _is_seq_item(lines.items[i][1]):
        content = lines.items[i][1]
        rest = content[1:].lstrip(" ")
        if not rest:
            value, i = _nested(lines, i + 1, indent, allow_same_indent_seq=False)
        elif _is_seq_item(rest) or _split_key(rest) is not None:
            # The item's first line holds a nested node: read it as if the
            # "- " were indentation.
            col = indent + len(content) - len(rest)
            lines.items[i] = (col, rest)
            value, i = _block(lines, i, col)
        else:
            value = _inline(rest)
            i += 1
            _after_inline(lines, i, indent)
        out.append(value)
    if i < len(lines.items) and lines.items[i][0] > indent:
        raise YAMLSubsetError(f"bad indentation at {lines.items[i][1]!r}")
    return out, i


def parse_yaml(text: str) -> Any:
    """One YAML document of the supported subset -> Python values (None
    for an empty document), typed as ``yaml.safe_load`` types them."""
    lines = _Lines(text)
    if not lines.items:
        return None
    value, i = _block(lines, 0, lines.items[0][0])
    if i != len(lines.items):
        raise YAMLSubsetError(f"bad indentation at {lines.items[i][1]!r}")
    return value


# ---------------------------------------------------------------------------
# Emitting (hparams.yaml): ``yaml.safe_dump``'s block style, keys sorted.

def _needs_quotes(s: str) -> bool:
    if not s or s != s.strip() or any(not (" " <= c <= "~") for c in s):
        return True
    try:
        if not isinstance(_plain(s), str):
            return True
    except YAMLSubsetError:
        return True
    if s[0] in "#,[]{}&*!|>'\"%@`" or (s[0] in "?:-" and (len(s) == 1 or s[1] == " ")):
        return True
    return ": " in s or s.endswith(":") or " #" in s


def _scalar_text(v: Any) -> str:
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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'" if _needs_quotes(v) else v
    raise TypeError(f"cannot write {type(v).__name__} values")


def _emit(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, Mapping):
        for k in sorted(value):
            v = value[k]
            key = _scalar_text(k)
            if isinstance(v, Mapping) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent, out)
            else:
                out.append(f"{pad}{key}: {_flow_empty(v)}")
    else:
        for v in value:
            if isinstance(v, Mapping) and v:
                sub: list[str] = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            elif isinstance(v, (list, tuple)) and v:
                sub = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_flow_empty(v)}")


def _flow_empty(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def dump_yaml(value: Mapping) -> str:
    """A mapping of scalars, lists and mappings as block-style YAML with
    sorted keys, as ``yaml.safe_dump`` writes one (strings are quoted where
    they would otherwise read back as something else)."""
    out: list[str] = []
    _emit(value, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"


# ---------------------------------------------------------------------------
# Composition

def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _deep_merge(dst: Config, src: Mapping) -> Config:
    """Merge ``src`` into ``dst`` (src wins; dicts merge recursively)."""
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), Mapping):
            _deep_merge(dst[k], v)
        else:
            dst[k] = _wrap(v)
    return dst


def _resolve_value(value: Any, root: Config, *, _depth: int = 0) -> Any:
    if _depth > 32:
        raise RecursionError("interpolation cycle detected")
    if isinstance(value, str):
        # Full-string interpolation keeps the referenced value's type.
        m = _INTERP_RE.fullmatch(value)
        if m:
            return _resolve_ref(m.group(1), root, _depth)

        def sub(match: re.Match) -> str:
            return str(_resolve_ref(match.group(1), root, _depth))

        out = _INTERP_RE.sub(sub, value)
        return _ENV_RE.sub(lambda m2: os.environ.get(m2.group(1), m2.group(0)), out)
    if isinstance(value, Mapping):
        return Config({k: _resolve_value(v, root, _depth=_depth + 1) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_value(v, root, _depth=_depth + 1) for v in value]
    return value


def _resolve_ref(expr: str, root: Config, depth: int) -> Any:
    expr = expr.strip()
    if expr.startswith("env:"):
        var, comma, default = expr[len("env:"):].partition(",")
        if var in os.environ:
            return os.environ[var]
        if comma:
            return parse_yaml(default.strip())
        raise KeyError(f"environment variable {var!r} is not set")
    return _resolve_value(root.get_path(expr), root, _depth=depth + 1)


def resolve(cfg: Config) -> Config:
    """Resolve all interpolations against the tree's own root."""
    return _resolve_value(cfg, cfg)  # type: ignore[return-value]


def _load_yaml(path: Path) -> Config:
    return _wrap(parse_yaml(Path(path).read_text()) or {})


def load_config(
    config_path: str | Path,
    config_name: str = "base",
    overrides: Iterable[str] = (),
    resolve_interpolations: bool = True,
) -> Config:
    """Compose ``<config_path>/<config_name>.yaml`` with overlays + overrides.

    ``defaults`` entries of the form ``- experiment: null`` name overlay
    groups; an override ``experiment=foo`` loads
    ``<config_path>/experiment/foo.yaml`` and deep-merges it at the root.
    ``- _self_`` sets where the base file is merged among the defaults.
    """
    config_dir = Path(config_path)
    base = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults = base.pop("defaults", [])

    group_choice: dict[str, Any] = {}
    order: list[str] = []
    for entry in defaults:
        if entry == "_self_":
            order.append("_self_")
            continue
        if isinstance(entry, Mapping):
            ((group, choice),) = entry.items()
            group_choice[str(group)] = choice
            order.append(str(group))

    plain_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key=value")
        key, _, raw = ov.partition("=")
        key = key.lstrip("+")
        if key in group_choice:
            group_choice[key] = raw
        else:
            plain_overrides.append((key, parse_yaml(raw)))

    composed = Config()
    if "_self_" not in order:
        order.append("_self_")
    for item in order:
        if item == "_self_":
            _deep_merge(composed, base)
            continue
        choice = group_choice.get(item)
        if choice in (None, "null"):
            continue
        _deep_merge(composed, _load_yaml(config_dir / item / f"{choice}.yaml"))

    for key, value in plain_overrides:
        composed.set_path(key, _wrap(value))

    if resolve_interpolations:
        composed = resolve(composed)
    return composed


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Recursively construct objects from ``_target_`` nodes: each mapping
    with a ``_target_`` becomes a call of the imported callable with the
    other keys (instantiated in turn) as keyword arguments."""
    if isinstance(node, Mapping):
        if "_target_" in node:
            module_name, _, attr = str(node["_target_"]).strip().rpartition(".")
            if not module_name:
                raise ValueError(f"cannot import bare name {node['_target_']!r}")
            target = getattr(importlib.import_module(module_name), attr)
            call_kwargs = {k: instantiate(v) for k, v in node.items() if k != "_target_"}
            call_kwargs.update(kwargs)
            return target(**call_kwargs)
        return Config({k: instantiate(v) for k, v in node.items()})
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def to_dict(cfg: Any) -> Any:
    """Plain-dict copy (for hparam logging / serialization)."""
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return copy.deepcopy(cfg)
