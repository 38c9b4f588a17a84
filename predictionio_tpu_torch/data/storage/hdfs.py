"""HDFS model blob store over WebHDFS REST (no Hadoop client).

Reference parity: ``storage/hdfs/.../HDFSModels.scala`` (model blobs via the
Hadoop FileSystem API). This driver talks WebHDFS — Hadoop's standard
HTTP gateway — with stdlib urllib, including the NameNode -> DataNode
redirect dance on CREATE/OPEN.

Config keys (``PIO_STORAGE_SOURCES_<NAME>_*``): ``URL`` (e.g.
``http://namenode:9870``), ``PATH`` (base dir, default ``/pio_models``),
``USERNAME`` (``user.name`` query param for simple auth).

The port's own copy of ``predictionio_tpu/data/storage/hdfs.py``.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.resilience import (
    TRANSIENT_HTTP_STATUSES,
    RetryPolicy,
    mark_transient,
)


class HDFSError(RuntimeError):
    """``transient`` is True for connection failures and 5xx responses —
    safe to retry because every operation here is idempotent (CREATE with
    overwrite, OPEN, DELETE)."""

    transient = False


class WebHDFSModels(base.Models):
    def __init__(
        self,
        url: str,
        base_path: str = "/pio_models",
        username: str | None = None,
        timeout: float = 30.0,
        retries: int = 3,
        retry_backoff_s: float = 0.2,
    ):
        self._url = url.rstrip("/")
        self._base = "/" + base_path.strip("/")
        self._username = username
        self._timeout = timeout
        # retries re-run the WHOLE NameNode -> DataNode dance: a DataNode
        # that died mid-redirect gets a fresh placement on the next attempt
        self._retry = RetryPolicy(
            max_attempts=max(1, retries), backoff_base_s=retry_backoff_s
        )

    def _op_url(self, model_id: str, op: str, **params: str) -> str:
        safe = urllib.parse.quote(f"pio_model_{model_id}", safe="-_.~")
        q = {"op": op, **params}
        if self._username:
            q["user.name"] = self._username
        return (
            f"{self._url}/webhdfs/v1{self._base}/{safe}?"
            + urllib.parse.urlencode(q)
        )

    def _request(
        self,
        method: str,
        url: str,
        payload: bytes | None = None,
        follow_redirect: bool = True,
        redirect_payload: bytes | None = None,
    ) -> tuple[int, bytes]:
        """One HTTP call; on a NameNode 301/302/307 re-issues against the
        DataNode ``Location`` with ``redirect_payload`` (the WebHDFS CREATE
        protocol sends NO body to the NameNode — only the DataNode gets the
        file bytes)."""
        req = urllib.request.Request(url, data=payload, method=method)
        req.add_header("Content-Type", "application/octet-stream")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code in (301, 302, 307) and follow_redirect:
                location = exc.headers.get("Location")
                if location:
                    return self._request(
                        method, location, redirect_payload, False
                    )
            return exc.code, exc.read()
        except (urllib.error.URLError, OSError) as exc:
            raise mark_transient(HDFSError(f"{method} {url}: {exc}")) from exc

    @staticmethod
    def _check(status: int, body: bytes, ok: tuple[int, ...], what: str) -> None:
        if status in ok:
            return
        err = HDFSError(f"{what}: HTTP {status}: {body[:200]!r}")
        if status in TRANSIENT_HTTP_STATUSES:
            mark_transient(err)
        raise err

    def insert(self, model: Model) -> None:
        def once() -> None:
            # two-step write: body-less CREATE against the NameNode, then PUT
            # the bytes at the DataNode the 307 redirect names
            status, body = self._request(
                "PUT",
                self._op_url(model.id, "CREATE", overwrite="true"),
                payload=None,
                redirect_payload=model.models,
            )
            self._check(status, body, (200, 201), f"CREATE {model.id}")

        self._retry.call(once)

    def get(self, model_id: str) -> Model | None:
        def once() -> Model | None:
            status, body = self._request("GET", self._op_url(model_id, "OPEN"))
            if status == 404:
                return None
            self._check(status, body, (200,), f"OPEN {model_id}")
            return Model(model_id, body)

        return self._retry.call(once)

    def delete(self, model_id: str) -> None:
        def once() -> None:
            status, body = self._request(
                "DELETE", self._op_url(model_id, "DELETE")
            )
            self._check(status, body, (200, 404), f"DELETE {model_id}")

        self._retry.call(once)


class HDFSStorageClient:
    """Backend entry point (type name: ``hdfs``)."""

    def __init__(self, config: dict[str, Any] | None = None):
        cfg = {k.upper(): v for k, v in (config or {}).items()}
        url = cfg.get("URL")
        if not url:
            raise HDFSError("hdfs storage source needs PIO_STORAGE_SOURCES_<NAME>_URL")
        self._models = WebHDFSModels(
            url=url,
            base_path=cfg.get("PATH", "/pio_models"),
            username=cfg.get("USERNAME"),
            timeout=float(cfg.get("TIMEOUT", 30.0)),
            retries=int(cfg.get("RETRIES", 3)),
            retry_backoff_s=float(cfg.get("RETRY_BACKOFF_S", 0.2)),
        )

    def models(self) -> WebHDFSModels:
        return self._models
