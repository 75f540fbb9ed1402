"""Webhook connectors: map third-party payloads to events — own copy of
the reference's ``predictionio_tpu/data/webhooks.py``.

Parity with «data/.../data/webhooks/{ConnectorUtil,JsonConnector,
FormConnector}» and the segmentio/mailchimp connectors (SURVEY.md §2.2 [U]).
A connector translates an external service's payload into the canonical
event dict that the event server then validates and stores.
"""

from __future__ import annotations

import abc
from typing import Any, Optional


class JsonConnector(abc.ABC):
    """Connector for JSON webhook payloads."""

    form = False

    @abc.abstractmethod
    def to_event_dict(self, payload: dict[str, Any]) -> dict[str, Any]:
        """Translate an external payload into an Event wire dict."""


class FormConnector(JsonConnector, abc.ABC):
    """Connector for application/x-www-form-urlencoded payloads (payload is a
    flat str→str dict)."""

    form = True


class SegmentIOConnector(JsonConnector):
    """Segment.com spec events → pio events (mirrors SegmentIOConnector [U]).

    Supports the common spec calls: identify, track, page, screen, alias,
    group. The spec's userId/anonymousId becomes the entity id.
    """

    def to_event_dict(self, payload: dict[str, Any]) -> dict[str, Any]:
        typ = payload.get("type")
        if typ not in ("identify", "track", "page", "screen", "alias", "group"):
            raise ValueError(f"Cannot process unmarshalled event type {typ!r}.")
        entity_id = payload.get("userId") or payload.get("anonymousId")
        if not entity_id:
            raise ValueError("there is no userId or anonymousId in the event.")
        properties: dict[str, Any] = {}
        if typ == "identify":
            properties = dict(payload.get("traits") or {})
        elif typ == "track":
            properties = dict(payload.get("properties") or {})
            properties["event"] = payload.get("event")
        elif typ in ("page", "screen"):
            properties = dict(payload.get("properties") or {})
            if payload.get("name"):
                properties["name"] = payload["name"]
        elif typ == "alias":
            properties = {"previousId": payload.get("previousId")}
        elif typ == "group":
            properties = dict(payload.get("traits") or {})
            properties["groupId"] = payload.get("groupId")
        d: dict[str, Any] = {
            "event": typ,
            "entityType": "user",
            "entityId": str(entity_id),
            "properties": {k: v for k, v in properties.items() if v is not None},
        }
        if payload.get("timestamp"):
            d["eventTime"] = payload["timestamp"]
        return d


class MailChimpConnector(FormConnector):
    """MailChimp form webhooks (subscribe/unsubscribe/... — mirrors
    MailChimpConnector [U]). MailChimp posts flattened form fields like
    ``data[email]``."""

    SUPPORTED = ("subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign")

    def to_event_dict(self, payload: dict[str, Any]) -> dict[str, Any]:
        typ = payload.get("type")
        if typ not in self.SUPPORTED:
            raise ValueError(f"Cannot process unmarshalled event type {typ!r}.")
        entity_id = (
            payload.get("data[id]")
            or payload.get("data[email]")
            or payload.get("data[list_id]")
        )
        if not entity_id:
            raise ValueError("there is no data[id]/data[email] in the payload.")
        # data[merges][EMAIL] → "merges.EMAIL"; data[email] → "email"
        properties = {
            k[len("data[") : -1].replace("][", "."): v
            for k, v in payload.items()
            if k.startswith("data[") and k.endswith("]")
        }
        d = {
            "event": typ,
            "entityType": "user",
            "entityId": str(entity_id),
            "properties": properties,
        }
        if payload.get("fired_at"):
            d["eventTime"] = payload["fired_at"].replace(" ", "T") + "Z"
        return d


_CONNECTORS: dict[tuple[str, bool], JsonConnector] = {
    ("segmentio", False): SegmentIOConnector(),
    ("mailchimp", True): MailChimpConnector(),
}


def get_connector(name: str, form: bool) -> Optional[JsonConnector]:
    return _CONNECTORS.get((name, form))


def register_connector(name: str, connector: JsonConnector) -> None:
    """Register a connector under `name` for its payload kind (JSON or
    form); the reference's EventServerPlugin SPI analogue [U]."""
    _CONNECTORS[(name, connector.form)] = connector
