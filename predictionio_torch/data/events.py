"""Canonical event schema + validation — own copy of the reference's
``predictionio_tpu/data/events.py``.

Capability parity with the reference's «data/.../data/storage/Event.scala ::
Event» and «EventValidation» (unverified — mount empty; SURVEY.md §2.2).
Field set matches the PredictionIO event API: event, entityType, entityId,
targetEntityType/Id, properties, eventTime, tags, prId, creationTime.
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import datetime, timezone
from typing import Any, Optional

from predictionio_torch.data.datamap import DataMap


class EventValidationError(ValueError):
    """Raised when an event violates the reserved-event / naming rules."""


SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete", "$reward",
                            "$alert"})


def _now() -> datetime:
    return datetime.now(timezone.utc)


def parse_time(value: Any) -> datetime:
    """Parse ISO-8601 (with 'Z' suffix allowed) or pass through datetimes."""
    if isinstance(value, datetime):
        dt = value
    elif isinstance(value, str):
        s = value.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        dt = datetime.fromisoformat(s)
    else:
        raise EventValidationError(f"Cannot parse time from {value!r}")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def format_time(dt: datetime) -> str:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    # Fixed-width microsecond precision: stored strings are compared
    # lexicographically in SQL (ORDER BY / range filters), so every
    # timestamp must serialize to the same width.
    s = dt.astimezone(timezone.utc).isoformat(timespec="microseconds")
    return s.replace("+00:00", "Z")


@dataclasses.dataclass
class Event:
    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: datetime = dataclasses.field(default_factory=_now)
    tags: list[str] = dataclasses.field(default_factory=list)
    pr_id: Optional[str] = None
    creation_time: datetime = dataclasses.field(default_factory=_now)
    event_id: Optional[str] = None

    # -- serde (wire format of the event API, SURVEY.md §3.3) --------------
    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "eventTime": format_time(self.event_time),
            "properties": self.properties.to_dict(),
            "creationTime": format_time(self.creation_time),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Event":
        if not isinstance(d, dict):
            raise EventValidationError("event must be a JSON object")
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e
        for name, v in (("event", event), ("entityType", entity_type)):
            if not isinstance(v, str) or not v:
                raise EventValidationError(f"field {name} must be a non-empty string")
        # entityId/targetEntityId may arrive as JSON numbers; coerce to string.
        if entity_id is None or (isinstance(entity_id, str) and not entity_id):
            raise EventValidationError("field entityId must be non-empty")
        props = d.get("properties") or {}
        if not isinstance(props, dict):
            raise EventValidationError("properties must be a JSON object")
        now = _now()
        return cls(
            event=event,
            entity_type=entity_type,
            entity_id=str(entity_id),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=(
                str(d["targetEntityId"]) if d.get("targetEntityId") is not None else None
            ),
            properties=DataMap(props),
            event_time=parse_time(d["eventTime"]) if d.get("eventTime") else now,
            tags=list(d.get("tags") or []),
            pr_id=d.get("prId"),
            creation_time=parse_time(d["creationTime"]) if d.get("creationTime") else now,
            event_id=d.get("eventId"),
        )


def new_event_id() -> str:
    return uuid.uuid4().hex


def validate_event(e: Event) -> None:
    """Reserved-event rules, parity with «EventValidation.scala» [U]:

    - names starting with ``$`` or ``pio_`` are reserved; only the builtin
      special events are accepted;
    - special events must not have a target entity;
    - ``$unset`` must carry a non-empty properties map;
    - ``$delete`` must carry no properties;
    - ``$reward`` must carry a non-empty string ``variant`` and a
      numeric ``reward`` in [0, 1] in its properties (the experiment
      plane's bandit-feedback event — docs/experimentation.md);
    - ``$alert`` must carry a non-empty string ``rule``, a ``status``
      of ``firing`` or ``resolved``, and a numeric ``value`` (the alert
      watchdog's dogfooded event — docs/observability.md);
    - ``pio_``-prefixed entity types / property names are reserved.
    """
    if e.event.startswith("$") and e.event not in SPECIAL_EVENTS:
        raise EventValidationError(f"{e.event} is not a supported reserved event name.")
    if e.event.startswith("pio_"):
        raise EventValidationError("event names starting with pio_ are reserved.")
    if e.entity_type.startswith("pio_"):
        raise EventValidationError("entity types starting with pio_ are reserved.")
    if e.target_entity_type is not None and e.target_entity_type.startswith("pio_"):
        raise EventValidationError("entity types starting with pio_ are reserved.")
    if any(k.startswith("pio_") for k in e.properties.keyset()):
        raise EventValidationError("property names starting with pio_ are reserved.")
    if e.event in SPECIAL_EVENTS:
        if e.target_entity_type is not None or e.target_entity_id is not None:
            raise EventValidationError(
                f"{e.event} must not have a targetEntityType or targetEntityId."
            )
        if e.event == "$unset" and e.properties.is_empty:
            raise EventValidationError("$unset must have a non-empty properties map.")
        if e.event == "$delete" and not e.properties.is_empty:
            raise EventValidationError("$delete must not have properties.")
        if e.event == "$reward":
            props = e.properties.to_dict()
            variant = props.get("variant")
            if not isinstance(variant, str) or not variant:
                raise EventValidationError(
                    "$reward must carry a non-empty string 'variant' property."
                )
            reward = props.get("reward")
            if isinstance(reward, bool) or not isinstance(reward, (int, float)):
                raise EventValidationError(
                    "$reward must carry a numeric 'reward' property."
                )
            if not 0.0 <= float(reward) <= 1.0:
                raise EventValidationError(
                    f"$reward 'reward' must be in [0, 1], got {reward!r}."
                )
        if e.event == "$alert":
            props = e.properties.to_dict()
            rule = props.get("rule")
            if not isinstance(rule, str) or not rule:
                raise EventValidationError(
                    "$alert must carry a non-empty string 'rule' property."
                )
            if props.get("status") not in ("firing", "resolved"):
                raise EventValidationError(
                    "$alert 'status' must be 'firing' or 'resolved'."
                )
            value = props.get("value")
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise EventValidationError(
                    "$alert must carry a numeric 'value' property."
                )
