"""Component parameter classes + JSON extraction — the port of
``predictionio_tpu/controller/params.py``.

engine.json `params` blocks map onto `Params` dataclasses through
`params_from_dict`: unknown keys are an error, missing keys take the
dataclass defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Type, TypeVar

P = TypeVar("P", bound="Params")


class Params:
    """Marker base class for component parameters (dataclasses)."""


@dataclasses.dataclass
class EmptyParams(Params):
    pass


class ParamsError(ValueError):
    """An engine.json params block does not match its Params class."""


def params_from_dict(cls: Type[P], d: dict[str, Any]) -> P:
    """Instantiate a Params dataclass from a JSON dict. A class may map
    JSON keys that are not identifiers through `_ALIASES` (engine.json's
    "lambda" → field "lambda_")."""
    if d is None:
        d = {}
    if not dataclasses.is_dataclass(cls):
        if d:
            raise ParamsError(
                f"{cls.__name__} is not a dataclass but params {sorted(d)} "
                "were given")
        return cls()
    aliases: dict[str, str] = getattr(cls, "_ALIASES", {})
    if aliases:
        d = {aliases.get(k, k): v for k, v in d.items()}
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - field_names
    if unknown:
        raise ParamsError(
            f"Unknown parameter(s) {sorted(unknown)} for {cls.__name__} "
            f"(accepted: {sorted(field_names)})")
    try:
        return cls(**d)
    except TypeError as e:
        raise ParamsError(f"Cannot build {cls.__name__} from {d!r}: {e}") from e


def params_to_dict(params: Params) -> dict[str, Any]:
    if dataclasses.is_dataclass(params):
        return dataclasses.asdict(params)
    return {}
