"""REST admin server (port 7071).

Reference parity: ``tools/.../admin/AdminAPI.scala:39-160`` +
``CommandClient.scala`` — GET /, GET /cmd/app, POST /cmd/app (new),
DELETE /cmd/app/{name} and /cmd/app/{name}/data.

Beyond the reference: GET /cmd/models and /cmd/models/{engine_key} expose
the model registry's inventory (versions, rollout state, history) so
fleet tooling can see what every engine serves without touching disk.

The port's own copy of ``predictionio_tpu/tools/admin_api.py``, served by
the standard library's ``ThreadingHTTPServer`` instead of aiohttp: the
same routes give the same statuses and JSON bodies; an unknown path
answers 404 and a known path with another method 405, as aiohttp's
router does.
"""

from __future__ import annotations

import json
import re
import urllib.parse
from typing import Any

from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.registry.store import ArtifactStore
from predictionio_tpu_torch.tools.route_server import RouteServer

# (method, path pattern) -> handler name; a path segment is [^/]+
_ROUTES = (
    ("GET", re.compile(r"^/$"), "handle_root"),
    ("GET", re.compile(r"^/cmd/app$"), "handle_list_apps"),
    ("POST", re.compile(r"^/cmd/app$"), "handle_new_app"),
    ("DELETE", re.compile(r"^/cmd/app/(?P<name>[^/]+)$"), "handle_delete_app"),
    ("DELETE", re.compile(r"^/cmd/app/(?P<name>[^/]+)/data$"), "handle_delete_app_data"),
    ("GET", re.compile(r"^/cmd/models$"), "handle_list_models"),
    ("GET", re.compile(r"^/cmd/models/(?P<engine_key>[^/]+)$"), "handle_show_models"),
)

Reply = tuple[int, Any]  # (status, JSON body)


class AdminServer(RouteServer):
    thread_name = "pio-admin"

    def __init__(self, storage: Storage | None = None, registry_dir: str | None = None):
        super().__init__()
        self.storage = storage or Storage.instance()
        self.registry = ArtifactStore(registry_dir)

    def handle_root(self, match: dict[str, str], body: bytes) -> Reply:
        import predictionio_tpu_torch

        return 200, {"status": "alive", "version": predictionio_tpu_torch.__version__}

    def handle_list_apps(self, match: dict[str, str], body: bytes) -> Reply:
        apps = self.storage.get_meta_data_apps().get_all()
        keys = self.storage.get_meta_data_access_keys()
        return 200, [
            {
                "name": a.name,
                "id": a.id,
                "description": a.description,
                "accessKeys": [k.key for k in keys.get_by_app_id(a.id)],
            }
            for a in apps
        ]

    def handle_new_app(self, match: dict[str, str], body: bytes) -> Reply:
        try:
            req = json.loads(body)
            name = req["name"]
            requested_id = int(req.get("id") or 0)
        except Exception:
            return 400, {"message": "name required (id, if given, must be an integer)"}
        apps = self.storage.get_meta_data_apps()
        if apps.get_by_name(name):
            return 409, {"message": f"App {name} already exists."}
        app_id = apps.insert(App(requested_id, name, req.get("description")))
        if app_id is None:
            return 500, {"message": "unable to create app"}
        self.storage.get_l_events().init(app_id)
        key = self.storage.get_meta_data_access_keys().insert(AccessKey("", app_id, ()))
        return 201, {"name": name, "id": app_id, "accessKey": key}

    def handle_delete_app(self, match: dict[str, str], body: bytes) -> Reply:
        name = match["name"]
        apps = self.storage.get_meta_data_apps()
        app = apps.get_by_name(name)
        if app is None:
            return 404, {"message": "Not Found"}
        channels = self.storage.get_meta_data_channels()
        for c in channels.get_by_app_id(app.id):
            self.storage.get_l_events().remove(app.id, c.id)
            channels.delete(c.id)
        self.storage.get_l_events().remove(app.id)
        for k in self.storage.get_meta_data_access_keys().get_by_app_id(app.id):
            self.storage.get_meta_data_access_keys().delete(k.key)
        apps.delete(app.id)
        return 200, {"message": f"App {name} deleted."}

    def handle_delete_app_data(self, match: dict[str, str], body: bytes) -> Reply:
        name = match["name"]
        app = self.storage.get_meta_data_apps().get_by_name(name)
        if app is None:
            return 404, {"message": "Not Found"}
        self.storage.get_l_events().remove(app.id)
        self.storage.get_l_events().init(app.id)
        return 200, {"message": f"Data of app {name} deleted."}

    def handle_list_models(self, match: dict[str, str], body: bytes) -> Reply:
        """Registry inventory: one row per engine with its rollout state."""
        out = []
        for key in self.registry.engines():
            versions = self.registry.versions_by_key(key)
            state = self.registry.state_by_key(key)
            out.append(
                {
                    "engineKey": key,
                    "engineId": versions[-1].engine_id if versions else "",
                    "versions": len(versions),
                    "stable": state.stable,
                    "candidate": state.candidate,
                    "mode": state.mode,
                    "fraction": state.fraction,
                }
            )
        return 200, {"registryDir": self.registry.base_dir, "engines": out}

    def handle_show_models(self, match: dict[str, str], body: bytes) -> Reply:
        key = match["engine_key"]
        versions = self.registry.versions_by_key(key)
        if not versions:
            return 404, {"message": "Not Found"}
        return 200, {
            "engineKey": key,
            "state": self.registry.state_by_key(key).to_json_dict(),
            "versions": [m.to_json_dict() for m in versions],
        }

    def route(self, method: str, path: str, body: bytes = b"") -> tuple[int, str, bytes]:
        allowed = False
        for m, pattern, name in _ROUTES:
            hit = pattern.match(path)
            if hit is None:
                continue
            if m != method:
                allowed = True
                continue
            match = {k: urllib.parse.unquote(v) for k, v in hit.groupdict().items()}
            status, out = getattr(self, name)(match, body)
            return status, "application/json; charset=utf-8", json.dumps(out).encode()
        if allowed:
            return 405, "text/plain; charset=utf-8", b"405: Method Not Allowed"
        return 404, "text/plain; charset=utf-8", b"404: Not Found"


def run_admin_server(ip: str = "127.0.0.1", port: int = 7071, registry_dir: str | None = None) -> None:
    """Blocking entry point: the admin server on ``Storage.instance()`` and
    ``registry_dir`` (default: ``$PIO_REGISTRY_DIR``, else ``registry/``
    under the basedir) until SIGINT or SIGTERM. Call from the main thread."""
    from predictionio_tpu_torch.registry.store import default_registry_dir
    from predictionio_tpu_torch.utils.platform import wait_for_signal

    server = AdminServer(registry_dir=registry_dir or default_registry_dir())
    server.start(ip, port)
    try:
        wait_for_signal()
    finally:
        server.shutdown()
