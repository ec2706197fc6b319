"""Configs with dotted overrides and `${a.b.c}` interpolation, and the
strict parsing of the serving flags.

Counterpart of `mmada_tpu/core/config.py` (the reference's OmegaConf
contract, training/utils.py:12-17: a yaml file merged with `key.sub=value`
arguments), on plain dicts and without yaml: the package imports no yaml.

* `load_config` reads its files through a `reader` the caller passes in, a
  function from an open text file to a mapping: the command lines pass
  `yaml.safe_load`. `_base_` inheritance and the coercion of `5e-5`-style
  strings to floats (`_coerce_floats`, what PyYAML 1.1 leaves as a string)
  apply to what the reader returns, as in JAX.
* `parse_overrides` reads each value as JAX's `_parse_scalar` does, with a
  YAML 1.1 scalar reader of its own: ints (decimal, `0x`, `0b`, a leading 0
  for octal, `_` separators, `1:30` sexagesimal), floats (with a dot, or
  `5e-5` whatever its spelling, `.inf`, `.nan`), `true`/`yes`/`on` and
  `false`/`no`/`off` in their three cases, `null`/`~`/nothing, `'single'`
  and `"double"` quoted strings, flow lists `[a, [1, 2]]`, ` #` comments,
  and any other text as a string. A value that YAML would read as a
  mapping (`a: b`, `{a: 1}`) or a block list (`- a`) raises: quote it.
* `parse_kv_cache`, `parse_bool`, `parse_cfg_interval`, `parse_remat` and
  `parse_structured` as in JAX: `bool("int8")` and `bool("false")` are both
  True, so a flag that arrives as a string goes through an explicit table.

Not ported: `Config.to_yaml` / `save` (nothing on the serving path writes a
config) and `get_config` (the command lines call `load_config`).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Any, Callable, Iterator, Mapping, Optional

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")

Reader = Callable[[Any], Any]
"""Reads one config file: an open text file in, a mapping (or None) out."""


class Config(dict):
    """dict with attribute access, deep merge, and interpolation resolution."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        del self[name]

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, Config):
                nxt = Config()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = _wrap(value)

    def merge(self, other: Mapping[str, Any]) -> "Config":
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), Config):
                self[k].merge(v)
            else:
                self[k] = _wrap(v)
        return self

    def resolve(self, root: Optional["Config"] = None) -> "Config":
        root = root if root is not None else self
        for k, v in list(self.items()):
            if isinstance(v, Config):
                v.resolve(root)
            elif isinstance(v, list):
                self[k] = [_resolve_value(item, root) for item in v]
            else:
                self[k] = _resolve_value(v, root)
        return self

    def to_dict(self) -> dict:
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [i.to_dict() if isinstance(i, Config) else i for i in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def flatten(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        """Flat (dotted_key, leaf) pairs (the reference's `flatten_omega_conf`)."""
        for k, v in self.items():
            key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
            if isinstance(v, Config):
                yield from v.flatten(key)
            else:
                yield key, v


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _resolve_value(value: Any, root: Config) -> Any:
    if not isinstance(value, str):
        return value
    m = _INTERP_RE.fullmatch(value)
    if m:  # a whole-string reference keeps the referent's type
        target = root.get_path(m.group(1))
        if target is None:
            raise KeyError(f"unresolvable interpolation: {value}")
        return _resolve_value(target, root)

    def repl(match: re.Match) -> str:  # embedded references become strings
        target = root.get_path(match.group(1))
        if target is None:
            raise KeyError(f"unresolvable interpolation: {match.group(0)}")
        return str(_resolve_value(target, root))

    return _INTERP_RE.sub(repl, value)


_FLOAT_RE = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+")


def _coerce_floats(node: Any) -> Any:
    """PyYAML 1.1 reads a bare `5e-5` as a string; OmegaConf (the reference's
    config layer) as a float. Recursively coerce to match."""
    if isinstance(node, dict):
        return {k: _coerce_floats(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_floats(v) for v in node]
    if isinstance(node, str) and _FLOAT_RE.fullmatch(node.strip()):
        return float(node)
    return node


def _load_with_base(path: str, reader: Optional[Reader], _depth: int = 0) -> Config:
    """One config file through `reader`, honouring a `_base_: other.yaml`
    key (resolved against the cwd first, then the file's directory)."""
    if reader is None:
        raise ValueError(f"reading {path} needs a reader (e.g. yaml.safe_load); without one, "
                         "give every key as a dotted override")
    if _depth > 8:
        raise ValueError(f"_base_ chain too deep at {path}")
    with open(path) as f:
        loaded = _coerce_floats(dict(reader(f) or {}))
    base_path = loaded.pop("_base_", None)
    cfg = Config()
    if base_path:
        if not os.path.exists(base_path):
            candidate = os.path.join(os.path.dirname(path), base_path)
            base_path = candidate if os.path.exists(candidate) else base_path
        cfg.merge(_load_with_base(base_path, reader, _depth + 1))
    cfg.merge(loaded)
    return cfg


# ------------------------------------------------------------- YAML scalars
_YAML_INT = re.compile(r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_YAML_SEXAGESIMAL_INT = re.compile(r"[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_YAML_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_YAML_SEXAGESIMAL_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*")
_YAML_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_YAML_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_YAML_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_YAML_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_YAML_NULL = {"", "~", "null", "Null", "NULL"}
# a value YAML would read as a mapping or a block list
_YAML_STRUCTURE = re.compile(r"^[{]|^-(\s|$)|:(\s|$)")
_YAML_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
                 "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
                 "\\": "\\"}


class _NotYaml(ValueError):
    """Text PyYAML fails on: JAX's `_parse_scalar` keeps such text as it is."""


def _sexagesimal(text: str) -> float:
    sign = -1 if text.startswith("-") else 1
    value = 0.0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + float(part)
    return sign * value


def _plain(text: str) -> Any:
    """A plain (unquoted) YAML 1.1 scalar, stripped of its comment."""
    if text.startswith("#"):
        text = ""
    text = text.split(" #", 1)[0].strip()
    if _YAML_STRUCTURE.search(text):
        raise ValueError(f"{text!r} would be a YAML mapping or list; quote it to pass a string")
    if text in _YAML_NULL:
        return None
    if text in _YAML_TRUE:
        return True
    if text in _YAML_FALSE:
        return False
    digits = text.replace("_", "")
    if _YAML_INT.fullmatch(text):
        body = digits.lstrip("+-")
        sign = -1 if digits.startswith("-") else 1
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        return sign * (int(body, 8) if len(body) > 1 and body.startswith("0") else int(body))
    if _YAML_SEXAGESIMAL_INT.fullmatch(text):
        return int(_sexagesimal(digits))
    if _YAML_FLOAT.fullmatch(text):
        return float(digits)
    if _YAML_SEXAGESIMAL_FLOAT.fullmatch(text):
        return _sexagesimal(digits)
    if _YAML_INF.fullmatch(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _YAML_NAN.fullmatch(text):
        return float("nan")
    return text


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted string starting at `text[i]`, and the index past it."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _YAML_ESCAPES:
                raise _NotYaml(text)
            out.append(_YAML_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise _NotYaml(text)  # unterminated


def _flow_list(text: str, i: int) -> tuple[list, int]:
    """The flow list starting at `text[i] == "["`, and the index past it."""
    items: list = []
    i += 1
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise _NotYaml(text)
        if text[i] == "]":
            return items, i + 1
        if text[i] == "[":
            item, i = _flow_list(text, i)
        elif text[i] in "'\"":
            item, i = _quoted(text, i)
        else:
            j = i
            while j < len(text) and text[j] not in ",[]":
                j += 1
            if j >= len(text) or text[j] == "[":
                raise _NotYaml(text)
            item, i = _plain(text[i:j].strip()), j
        items.append(item)
        while i < len(text) and text[i] == " ":
            i += 1
        if i < len(text) and text[i] == ",":
            i += 1
        elif i >= len(text) or text[i] != "]":
            raise _NotYaml(text)


def _parse_scalar(text: str) -> Any:
    """One override's value as JAX's `_parse_scalar` reads it: `5e-5` in any
    spelling as a float, else the YAML 1.1 scalar or flow list, else (text
    PyYAML fails on) the text as given."""
    if _FLOAT_RE.fullmatch(text.strip()):
        return float(text)
    s = text.strip()
    try:
        if s[:1] == "[":
            value, end = _flow_list(s, 0)
        elif s[:1] in ("'", '"'):
            value, end = _quoted(s, 0)
        else:
            if s[:1] in tuple("*&!%@`|>?"):  # YAML indicators: PyYAML fails or reads no scalar
                raise _NotYaml(s)
            return _plain(s)
    except _NotYaml:
        return text
    rest = s[end:].strip()
    if rest and not rest.startswith("#"):
        return text
    return value


def parse_overrides(args: list[str]) -> Config:
    """Parse `a.b.c=value` tokens into a nested Config."""
    cfg = Config()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must look like key=value, got: {arg!r}")
        key, _, raw = arg.partition("=")
        cfg.set_path(key.strip(), _parse_scalar(raw))
    return cfg


def load_config(path: Optional[str] = None, overrides: Optional[list[str]] = None,
                cli_args: Optional[list[str]] = None,
                reader: Optional[Reader] = None) -> Config:
    """A config file (`path`, or `config=` among `cli_args`) and a topology
    fragment (`topology=`), each read by `reader`, then `overrides` and the
    other `key=value` arguments, interpolated: the reference CLI contract
    `python train.py config=path.yaml a.b=1`. Arguments without `=` are
    ignored; with no file, no reader is needed."""
    kv = [a for a in (cli_args or []) if "=" in a]
    topology = None
    for item in kv:
        k, _, v = item.partition("=")
        if k == "config" and path is None:
            path = v
        elif k == "topology":
            topology = v
    kv = [a for a in kv if not (a.startswith("config=") or a.startswith("topology="))]

    cfg = Config()
    if path:
        cfg.merge(_load_with_base(path, reader))
    if topology:
        cfg.merge(_load_with_base(topology, reader))
    if overrides:
        cfg.merge(parse_overrides(overrides))
    if kv:
        cfg.merge(parse_overrides(kv))
    cfg.resolve()
    return cfg


# ----------------------------------------------------------- serving flags
def parse_kv_cache(value):
    """A `kv_cache` value (bool, or a CLI / HTTP string) -> False | True |
    "int8"; any other string raises."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v == "int8":
            return "int8"
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"kv_cache must be true/false/int8, got {value!r}")
    return "int8" if value == "int8" else bool(value)


def parse_bool(value):
    """A boolean flag (bool, or a CLI / HTTP / yaml string) -> bool; any other
    string raises."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"expected a boolean, got {value!r}")
    return bool(value)


def parse_cfg_interval(value):
    """A `cfg_interval` value -> (lo, hi) floats: a 2-sequence, a "lo,hi" or
    "lo:hi" string, or None / "" / "off" / "none" for (0.0, 1.0) (CFG every
    step, the reference's behaviour); 0 <= lo <= hi <= 1 or it raises."""
    if value is None:
        return (0.0, 1.0)
    if isinstance(value, str):
        v = value.strip()
        if v in ("", "off", "none"):
            return (0.0, 1.0)
        parts = v.replace(":", ",").split(",")
        if len(parts) != 2:
            raise ValueError(f"cfg_interval must be 'lo,hi', got {value!r}")
        value = [float(p) for p in parts]
    lo, hi = (float(value[0]), float(value[1]))
    if not (0.0 <= lo <= hi <= 1.0):
        raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi <= 1, got {value!r}")
    return (lo, hi)


def parse_remat(value):
    """`training.gradient_checkpointing` -> False | "full" | "dots" | "auto"
    (`llada._check_remat`; the Trainer resolves "auto", `training/remat_auto.py`)."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("dots", "auto"):
            return v
        if v in ("1", "true", "yes", "on", "full"):
            return "full"
        if v in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"gradient_checkpointing must be true/false/full/dots/auto, "
                         f"got {value!r}")
    return "full" if value else False


def parse_structured(cls, cfg: Mapping[str, Any]):
    """A config section as a dataclass instance, unknown keys ignored (the
    reference's `models/misc.py:parse_structured`)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dict(cfg).items() if k in names})
