"""Typed config-model base.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``, cut to what the
serving configs use: class annotations declare fields, ``Field(default, ge=,
gt=, le=, choices=)`` bounds them (``deprecated_names=`` gives older
spellings), nested ``ConfigModel`` sections are built from dicts, and an
unknown key raises, naming it, unless the subclass sets ``allow_extra =
True`` (then it is kept in ``_extra``).
"""

import copy
import dataclasses
import logging
import typing
from typing import Any, Optional, Union

logger = logging.getLogger(__name__)


class _MISSING:

    def __repr__(self):
        return "<required>"


MISSING = _MISSING()


@dataclasses.dataclass
class Field:
    default: Any = MISSING
    ge: Optional[float] = None
    gt: Optional[float] = None
    le: Optional[float] = None
    choices: Optional[tuple] = None
    # older spellings of the field, accepted with a warning
    deprecated_names: tuple = ()

    def resolve_default(self):
        if callable(self.default) and self.default is not MISSING:
            return self.default()
        return copy.deepcopy(self.default)


def _coerce(value, tp, path):
    """Best-effort coercion of a JSON value into the annotated type."""
    if tp is Any or value is None:
        return value
    if typing.get_origin(tp) is Union:
        for a in [a for a in typing.get_args(tp) if a is not type(None)]:
            try:
                return _coerce(value, a, path)
            except (TypeError, ValueError):
                continue
        raise TypeError(f"{path}: cannot coerce {value!r} to {tp}")
    if isinstance(tp, type) and issubclass(tp, ConfigModel):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return tp(**value)
        raise TypeError(f"{path}: expected dict for {tp.__name__}, got {type(value).__name__}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise TypeError(f"{path}: expected bool, got {value!r}")
    if tp is int:
        if isinstance(value, bool):
            raise TypeError(f"{path}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str) and float(value).is_integer():
            return int(float(value))
        raise TypeError(f"{path}: expected int, got {value!r}")
    if tp is float:
        if isinstance(value, bool):
            raise TypeError(f"{path}: expected float, got bool")
        if isinstance(value, (int, float, str)):
            return float(value)
        raise TypeError(f"{path}: expected float, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise TypeError(f"{path}: expected str, got {value!r}")
    return value


class ConfigModel:
    """Declarative config base: annotate fields on the subclass body.

    >>> class MyConf(ConfigModel):
    ...     enabled: bool = False
    ...     size: int = Field(8, ge=1)
    """

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fields = {}
        for klass in reversed(cls.__mro__):
            for name, tp in getattr(klass, "__annotations__", {}).items():
                if name.startswith("_"):
                    continue
                raw = klass.__dict__.get(name, MISSING)
                fields[name] = (tp, raw if isinstance(raw, Field) else Field(default=raw))
        cls._fields = fields
        cls._aliases = {alias: name for name, (_, field) in fields.items()
                        for alias in field.deprecated_names}

    allow_extra = False

    def __init__(self, **kwargs):
        cls = type(self)
        for alias in [k for k in kwargs if k in cls._aliases]:
            logger.warning(f"Config field '{alias}' is deprecated, use '{cls._aliases[alias]}'")
            kwargs[cls._aliases[alias]] = kwargs.pop(alias)
        extra = {key: kwargs.pop(key) for key in list(kwargs)
                 if key not in cls._fields and cls.allow_extra}
        for key in kwargs:
            if key not in cls._fields:
                raise ValueError(f"{cls.__name__}: unknown config field '{key}'. "
                                 f"Valid fields: {sorted(cls._fields)}")
        object.__setattr__(self, "_extra", extra)
        for name, (tp, field) in cls._fields.items():
            if name in kwargs:
                value = _coerce(kwargs[name], tp, f"{cls.__name__}.{name}")
            elif field.default is MISSING:
                raise ValueError(f"{cls.__name__}: missing required field '{name}'")
            else:
                value = field.resolve_default()
            self._check_bounds(name, field, value)
            object.__setattr__(self, name, value)
        self.model_validate()

    def _check_bounds(self, name, field, value):
        label = f"{type(self).__name__}.{name}"
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            if field.ge is not None and value < field.ge:
                raise ValueError(f"{label}={value} must be >= {field.ge}")
            if field.gt is not None and value <= field.gt:
                raise ValueError(f"{label}={value} must be > {field.gt}")
            if field.le is not None and value > field.le:
                raise ValueError(f"{label}={value} must be <= {field.le}")
        if field.choices is not None and value not in field.choices:
            raise ValueError(f"{label}={value!r} not in {field.choices}")

    def model_validate(self):
        """Subclass hook for cross-field validation."""

    def to_dict(self):
        """The fields as a plain dict, nested sections as dicts."""
        out = {}
        for name in type(self)._fields:
            value = getattr(self, name)
            if isinstance(value, ConfigModel):
                value = value.to_dict()
            elif isinstance(value, list):
                value = [v.to_dict() if isinstance(v, ConfigModel) else v for v in value]
            out[name] = value
        return out

    def __repr__(self):
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in type(self)._fields)
        return f"{type(self).__name__}({inner})"
