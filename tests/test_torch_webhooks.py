"""The port's webhook connectors (``predictionio_tpu_torch/data/webhooks``):
the JAX package's golden tests (ref ConnectorTestUtil.scala + per-connector
specs, JSON-in / event-JSON-out) run against the port, and every payload of
those tests, through both packages' connectors, gives the same event JSON
or the same ConnectorException message."""

import pytest

pytest.importorskip("torch")

from predictionio_tpu_torch.data.webhooks import (
    ConnectorException,
    connector_to_event,
)
from predictionio_tpu_torch.data.webhooks.examples import (
    ExampleFormConnector,
    ExampleJsonConnector,
)
from predictionio_tpu_torch.data.webhooks.mailchimp import MailChimpConnector
from predictionio_tpu_torch.data.webhooks.segmentio import SegmentIOConnector


class TestSegmentIO:
    C = SegmentIOConnector()

    def test_identify(self):
        e = connector_to_event(
            self.C,
            {
                "version": "2",
                "type": "identify",
                "userId": "u1",
                "traits": {"email": "a@b.c"},
                "timestamp": "2024-05-01T10:00:00.000Z",
            },
        )
        assert e.event == "identify"
        assert e.entity_type == "user" and e.entity_id == "u1"
        assert e.properties.get("traits") == {"email": "a@b.c"}
        assert e.event_time.year == 2024

    def test_anonymous_id_fallback(self):
        e = connector_to_event(
            self.C, {"version": "2", "type": "page", "anonymousId": "anon-7"}
        )
        assert e.entity_id == "anon-7"

    def test_alias_group_screen(self):
        alias = self.C.to_event_json(
            {"version": "2", "type": "alias", "userId": "u", "previousId": "old"}
        )
        assert alias["properties"]["previous_id"] == "old"
        group = self.C.to_event_json(
            {"version": "2", "type": "group", "userId": "u", "groupId": "g1"}
        )
        assert group["properties"]["group_id"] == "g1"
        screen = self.C.to_event_json(
            {"version": "2", "type": "screen", "userId": "u", "name": "Home"}
        )
        assert screen["properties"]["name"] == "Home"

    def test_context_merged(self):
        out = self.C.to_event_json(
            {
                "version": "2",
                "type": "track",
                "userId": "u",
                "event": "X",
                "context": {"ip": "1.2.3.4"},
            }
        )
        assert out["properties"]["context"] == {"ip": "1.2.3.4"}

    def test_missing_version(self):
        with pytest.raises(ConnectorException):
            self.C.to_event_json({"type": "track", "userId": "u"})

    def test_missing_user(self):
        with pytest.raises(ConnectorException):
            self.C.to_event_json({"version": "2", "type": "track"})

    def test_unknown_type(self):
        with pytest.raises(ConnectorException):
            self.C.to_event_json({"version": "2", "type": "nope", "userId": "u"})


class TestMailChimp:
    C = MailChimpConnector()

    def test_unsubscribe(self):
        e = connector_to_event(
            self.C,
            {
                "type": "unsubscribe",
                "fired_at": "2009-03-26 21:40:57",
                "data[action]": "unsub",
                "data[reason]": "manual",
                "data[id]": "8a25ff1d98",
                "data[list_id]": "a6b5da1054",
                "data[email]": "api+unsub@mailchimp.com",
                "data[email_type]": "html",
                "data[merges][EMAIL]": "api+unsub@mailchimp.com",
                "data[merges][FNAME]": "MailChimp",
                "data[merges][LNAME]": "API",
                "data[campaign_id]": "cb398d21d2",
                "data[ip_opt]": "10.20.10.30",
            },
        )
        assert e.event == "unsubscribe"
        assert e.target_entity_id == "a6b5da1054"
        assert e.properties.get("action") == "unsub"

    def test_upemail_cleaned_campaign(self):
        up = self.C.to_event_json(
            {
                "type": "upemail",
                "fired_at": "2009-03-26 22:15:09",
                "data[list_id]": "a6b5da1054",
                "data[new_id]": "51da8c3259",
                "data[new_email]": "new@x.com",
                "data[old_email]": "old@x.com",
            }
        )
        assert up["event"] == "upemail" and up["entityType"] == "list"
        cleaned = self.C.to_event_json(
            {
                "type": "cleaned",
                "fired_at": "2009-03-26 22:01:00",
                "data[list_id]": "a6b5da1054",
                "data[campaign_id]": "4fjk2ma9xd",
                "data[reason]": "hard",
                "data[email]": "api+cleaned@mailchimp.com",
            }
        )
        assert cleaned["event"] == "cleaned"
        campaign = self.C.to_event_json(
            {
                "type": "campaign",
                "fired_at": "2009-03-26 21:31:21",
                "data[id]": "5aa2102003",
                "data[subject]": "Test Campaign Subject",
                "data[status]": "sent",
                "data[reason]": "",
                "data[list_id]": "a6b5da1054",
            }
        )
        assert campaign["entityType"] == "campaign"

    def test_unknown_type(self):
        with pytest.raises(ConnectorException):
            self.C.to_event_json({"type": "bogus", "fired_at": "2009-03-26 21:31:21"})

    def test_missing_type(self):
        with pytest.raises(ConnectorException):
            self.C.to_event_json({})


class TestExamples:
    def test_json_user_action(self):
        e = connector_to_event(
            ExampleJsonConnector(),
            {"type": "userAction", "userId": "u1", "properties": {"x": 1}},
        )
        assert e.event == "userAction" and e.properties.get("x") == 1

    def test_json_user_action_item(self):
        e = connector_to_event(
            ExampleJsonConnector(),
            {"type": "userActionItem", "action": "view", "userId": "u1", "itemId": "i1"},
        )
        assert e.event == "view" and e.target_entity_id == "i1"

    def test_form(self):
        e = connector_to_event(
            ExampleFormConnector(),
            {"type": "userAction", "userId": "u1", "price": "9.99"},
        )
        assert e.properties.get("price") == "9.99"


# ---------------------------------------------------------------------------
# parity with the JAX package's connectors
# ---------------------------------------------------------------------------

_PAYLOADS = [
    ("segmentio", {"version": "2", "type": "identify", "userId": "u1",
                   "traits": {"email": "a@b.c"}, "timestamp": "2024-05-01T10:00:00.000Z"}),
    ("segmentio", {"version": "2", "type": "page", "anonymousId": "anon-7"}),
    ("segmentio", {"version": "2", "type": "alias", "userId": "u", "previousId": "old"}),
    ("segmentio", {"version": "2", "type": "group", "userId": "u", "groupId": "g1",
                   "traits": {"n": 3}}),
    ("segmentio", {"version": "2", "type": "screen", "userId": "u", "name": "Home"}),
    ("segmentio", {"version": "2", "type": "track", "userId": "u", "event": "X",
                   "properties": {"plan": "Pro"}, "context": {"ip": "1.2.3.4"}}),
    ("segmentio", {"type": "track", "userId": "u"}),
    ("segmentio", {"version": "2", "type": "track"}),
    ("segmentio", {"version": "2", "type": "nope", "userId": "u"}),
    ("mailchimp", {"type": "subscribe", "fired_at": "2009-03-26 21:35:57",
                   "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
                   "data[email]": "api@mailchimp.com", "data[email_type]": "html",
                   "data[merges][EMAIL]": "api@mailchimp.com", "data[merges][FNAME]": "MailChimp",
                   "data[merges][LNAME]": "API", "data[ip_opt]": "10.20.10.30",
                   "data[ip_signup]": "10.20.10.30"}),
    ("mailchimp", {"type": "profile", "fired_at": "2009-03-26 21:31:21",
                   "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
                   "data[email]": "api@mailchimp.com", "data[email_type]": "html",
                   "data[merges][EMAIL]": "api@mailchimp.com", "data[merges][FNAME]": "MailChimp",
                   "data[merges][LNAME]": "API", "data[ip_opt]": "10.20.10.30"}),
    ("mailchimp", {"type": "upemail", "fired_at": "2009-03-26 22:15:09",
                   "data[list_id]": "a6b5da1054", "data[new_id]": "51da8c3259",
                   "data[new_email]": "new@x.com", "data[old_email]": "old@x.com"}),
    ("mailchimp", {"type": "cleaned", "fired_at": "2009-03-26 22:01:00",
                   "data[list_id]": "a6b5da1054", "data[campaign_id]": "4fjk2ma9xd",
                   "data[reason]": "hard", "data[email]": "api+cleaned@mailchimp.com"}),
    ("mailchimp", {"type": "campaign", "fired_at": "2009-03-26 21:31:21",
                   "data[id]": "5aa2102003", "data[subject]": "Test Campaign Subject",
                   "data[status]": "sent", "data[reason]": "", "data[list_id]": "a6b5da1054"}),
    ("mailchimp", {"type": "subscribe", "fired_at": "yesterday", "data[id]": "x",
                   "data[list_id]": "y"}),
    ("mailchimp", {"type": "bogus", "fired_at": "2009-03-26 21:31:21"}),
    ("mailchimp", {}),
    ("examplejson", {"type": "userAction", "userId": "u1", "properties": {"x": 1},
                     "timestamp": "2024-05-01T10:00:00.000+02:00"}),
    ("examplejson", {"type": "userActionItem", "action": "view", "userId": "u1", "itemId": "i1"}),
    ("examplejson", {"type": "userActionItem", "userId": "u1"}),
    ("exampleform", {"type": "userAction", "userId": "u1", "price": "9.99"}),
    ("exampleform", {"type": "other"}),
]


@pytest.mark.parametrize("name,payload", _PAYLOADS,
                         ids=[f"{n}-{k}" for k, (n, _) in enumerate(_PAYLOADS)])
def test_connectors_match_jax(name, payload):
    import predictionio_tpu.data.webhooks as jax_webhooks
    import predictionio_tpu_torch.data.webhooks as port_webhooks

    def convert(mod):
        connector = mod.json_connector(name) or mod.form_connector(name)
        try:
            out = mod.connector_to_event(connector, dict(payload)).to_json_dict()
        except (mod.ConnectorException, ValueError) as exc:
            return type(exc).__name__, str(exc)
        if not {"timestamp", "fired_at"} & set(payload):  # a clock-made time: only its presence
            assert out.pop("eventTime")
        return out

    assert convert(port_webhooks) == convert(jax_webhooks)
