"""Config: typed dataclass schemas populated from YAML/dicts with validation.

Replacement for the reference's Teuchos::ParameterList + YAML
pipeline (`Teuchos::getParametersFromYamlFile`,
`scrap/hp1_mock_reworks/HP1_mock_rework_agents_text_mesh_neigh_linker.cpp:867-1062`)
and the custom `OurAnyNumberParameterEntryValidator`
(`mundy/core/src/mundy_core/OurAnyNumberParameterEntryValidator.hpp`): any
numeric type coerces to the declared field type, unknown keys are rejected,
and nested sublists map to nested dataclasses.
"""

from __future__ import annotations

import dataclasses
import enum
import re
import typing
from typing import Any, Type, TypeVar, Union, get_args, get_origin

_T = TypeVar("_T")


class ConfigError(ValueError):
    """Raised on schema violations (unknown key, bad type, failed check)."""


_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")


def _strip_comment(line: str) -> str:
    """Drop a '#' comment that starts a line or follows whitespace, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, where: str) -> Any:
    tok = tok.strip()
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        if tok[0] in body.replace("\\" + tok[0], ""):
            raise ConfigError(f"{where}: unbalanced quotes in {tok!r}")
        return body.replace("\\" + tok[0], tok[0])
    if _INT.fullmatch(tok):
        return int(tok)
    if _FLOAT.fullmatch(tok):
        return float(tok)
    if tok.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(tok.lower().replace(".", ""))
    if tok[0] in "[]{}&*!|>'\"%@`-" or ": " in tok or tok.endswith(":"):
        raise ConfigError(f"{where}: unsupported YAML syntax {tok!r}")
    return tok


def _value(tok: str, where: str) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise ConfigError(f"{where}: unterminated flow list {tok!r}")
        inner = tok[1:-1].strip()
        if not inner:
            return []
        if "[" in inner or "{" in inner:
            raise ConfigError(f"{where}: nested flow collections are not "
                              "supported")
        return [_scalar(t, where) for t in inner.split(",")]
    return _scalar(tok, where)


def parse_yaml(text: str, source: str = "<string>") -> dict:
    """Parse the YAML subset the configs use: nested mappings by
    indentation, scalars (int, float, bool, null, plain or quoted strings),
    flow lists of scalars, and comments. Anything else (block sequences,
    anchors, multi-line strings, flow mappings, tabs, several documents)
    raises ConfigError."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    pending = None        # (indent, parent, key) awaiting a nested mapping
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"{where}: tab indentation")
        if line.strip() in ("---", "..."):
            raise ConfigError(f"{where}: document markers are not supported")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-":
            raise ConfigError(f"{where}: block sequences are not supported; "
                              "use a flow list [a, b]")
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ConfigError(f"{where}: expected 'key: value', got {body!r}")
        key = key.strip()
        if not _KEY.fullmatch(key):
            raise ConfigError(f"{where}: unsupported key {key!r}")
        if pending is not None:
            p_indent, p_parent, p_key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0] and stack[-1][1] is not root:
            raise ConfigError(f"{where}: inconsistent indentation")
        if stack[-1][1] is root and indent != 0:
            raise ConfigError(f"{where}: unexpected indentation")
        mapping = stack[-1][1]
        if key in mapping:
            raise ConfigError(f"{where}: duplicate key {key!r}")
        if rest.strip():
            mapping[key] = _value(rest, where)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root


def load_yaml(path: str) -> dict:
    """Load a YAML config file into a plain dict (the parse_yaml subset)."""
    with open(path, "r") as f:
        return parse_yaml(f.read(), path)


def _coerce(value: Any, typ: Any, path: str) -> Any:
    origin = get_origin(typ)

    if typ is Any:
        return value
    if origin is Union:
        args = get_args(typ)
        if type(None) in args and value is None:
            return None
        non_none = [a for a in args if a is not type(None)]
        errors = []
        for a in non_none:
            try:
                return _coerce(value, a, path)
            except ConfigError as e:  # noqa: PERF203
                errors.append(str(e))
        raise ConfigError(f"{path}: no Union arm matched ({'; '.join(errors)})")
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected sequence, got {type(value).__name__}")
        args = get_args(typ)
        if origin is list:
            elem_t = args[0] if args else Any
            return [_coerce(v, elem_t, f"{path}[{i}]") for i, v in enumerate(value)]
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0], f"{path}[{i}]") for i, v in enumerate(value))
        if args and len(args) != len(value):
            raise ConfigError(f"{path}: expected {len(args)} items, got {len(value)}")
        if args:
            return tuple(
                _coerce(v, a, f"{path}[{i}]") for i, (v, a) in enumerate(zip(value, args))
            )
        return tuple(value)
    if origin is dict:
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {type(value).__name__}")
        kt, vt = get_args(typ) or (Any, Any)
        return {
            _coerce(k, kt, f"{path}.key"): _coerce(v, vt, f"{path}[{k}]")
            for k, v in value.items()
        }
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        if isinstance(value, typ):
            return value
        try:
            return typ[value] if isinstance(value, str) else typ(value)
        except (KeyError, ValueError) as e:
            raise ConfigError(f"{path}: {value!r} not a valid {typ.__name__}") from e
    if dataclasses.is_dataclass(typ):
        if isinstance(value, typ):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping for {typ.__name__}")
        return config_from_dict(typ, value, path=path)
    if typ is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {type(value).__name__}")
    if typ is float:
        # "accept any number" semantics of OurAnyNumberParameterEntryValidator
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
        raise ConfigError(f"{path}: expected number, got {value!r}")
    if typ is int:
        if isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value == int(value):
            return int(value)
        if isinstance(value, str):
            try:
                return int(value)
            except ValueError:
                pass
        raise ConfigError(f"{path}: expected int, got {value!r}")
    if typ is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{path}: expected str, got {type(value).__name__}")
    if isinstance(typ, type) and isinstance(value, typ):
        return value
    raise ConfigError(f"{path}: cannot coerce {value!r} to {typ!r}")


def config_from_dict(cls: Type[_T], data: dict, path: str = "") -> _T:
    """Build dataclass `cls` from a dict, validating keys and coercing types."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{cls!r} is not a dataclass schema")
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise ConfigError(
            f"{path or cls.__name__}: unknown keys {sorted(unknown)}; "
            f"valid keys: {sorted(field_names)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data[f.name], hints[f.name], f"{path}.{f.name}".lstrip("."))
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise ConfigError(f"{path or cls.__name__}: missing required key '{f.name}'")
    obj = cls(**kwargs)
    validate_config(obj, path=path)
    return obj


def config_to_dict(obj: Any) -> dict:
    """Dataclass config → plain dict (YAML-serializable)."""
    out = dataclasses.asdict(obj)

    def clean(v):
        if isinstance(v, enum.Enum):
            return v.name
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    return clean(out)


def validate_config(obj: Any, path: str = "") -> None:
    """Run the schema's own `__validate__` hook if present."""
    hook = getattr(obj, "__validate__", None)
    if hook is not None:
        try:
            hook()
        except (AssertionError, ValueError) as e:
            raise ConfigError(f"{path or type(obj).__name__}: {e}") from e
