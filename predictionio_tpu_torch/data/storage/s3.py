"""S3 model blob store (pure-REST, AWS Signature V4, no boto).

Reference parity: ``storage/s3/.../S3Models.scala`` (model blobs only, via
the AWS SDK). This driver signs requests itself with stdlib hmac/hashlib so
no AWS package is required; it works against AWS S3 and any S3-compatible
endpoint (MinIO, Ceph RGW, GCS interop) via the ``ENDPOINT`` config key.

Config keys (``PIO_STORAGE_SOURCES_<NAME>_*``): ``BUCKET_NAME`` (required),
``REGION`` (default us-east-1), ``BASE_PATH`` (key prefix), ``ENDPOINT``
(default ``https://<bucket>.s3.<region>.amazonaws.com``; for path-style
endpoints include the bucket yourself), ``ACCESS_KEY_ID``/
``SECRET_ACCESS_KEY`` (default from AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY
env), ``DISABLE_SSL_VERIFY`` for self-hosted test endpoints.

The port's own copy of ``predictionio_tpu/data/storage/s3.py``.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import os
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


class S3Error(RuntimeError):
    """``transient`` is set True for connection failures and 5xx responses
    (safe to retry: every op here is an idempotent whole-object
    PUT/GET/DELETE) and stays False for application errors (403, 400...)."""

    transient = False


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(
    method: str,
    url: str,
    region: str,
    access_key: str,
    secret_key: str,
    payload: bytes = b"",
    now: _dt.datetime | None = None,
    service: str = "s3",
) -> dict[str, str]:
    """AWS Signature Version 4 headers for one request (the entire protocol
    the reference gets from the AWS SDK dependency). Returns the headers to
    attach: Authorization, x-amz-date, x-amz-content-sha256, host.

    ``url`` must be the exact percent-encoded form sent on the wire: for S3
    the canonical URI is the path as transmitted, so re-encoding here would
    double-encode (%20 -> %2520) and break the signature."""
    now = now or _dt.datetime.now(tz=_dt.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    canonical_uri = parsed.path or "/"
    # canonical query: sorted, individually encoded
    query_pairs = sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in query_pairs
    )
    payload_hash = _sha256(payload)
    canonical_headers = f"host:{host}\nx-amz-content-sha256:{payload_hash}\nx-amz-date:{amz_date}\n"
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_request = "\n".join(
        [
            method,
            canonical_uri,
            canonical_query,
            canonical_headers,
            signed_headers,
            payload_hash,
        ]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            _sha256(canonical_request.encode()),
        ]
    )
    k_date = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(
        k_signing, string_to_sign.encode(), hashlib.sha256
    ).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


class S3Models(base.Models):
    def __init__(
        self,
        bucket: str,
        region: str = "us-east-1",
        base_path: str = "",
        endpoint: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        timeout: float = 30.0,
        disable_ssl_verify: bool = False,
        retries: int = 3,
        retry_backoff_s: float = 0.2,
    ):
        self._bucket = bucket
        self._region = region
        self._base_path = base_path.strip("/")
        self._endpoint = (
            endpoint or f"https://{bucket}.s3.{region}.amazonaws.com"
        ).rstrip("/")
        self._access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self._secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self._timeout = timeout
        self._retry = RetryPolicy(
            max_attempts=max(1, retries), backoff_base_s=retry_backoff_s
        )
        self._ssl_context = None
        if disable_ssl_verify:
            import ssl

            self._ssl_context = ssl._create_unverified_context()

    def _url(self, model_id: str) -> str:
        safe = urllib.parse.quote(f"pio_model_{model_id}", safe="-_.~")
        prefix = f"/{self._base_path}" if self._base_path else ""
        return f"{self._endpoint}{prefix}/{safe}"

    def _request(
        self, method: str, url: str, payload: bytes = b""
    ) -> tuple[int, bytes]:
        """One logical request = up to ``retries`` wire attempts: connection
        failures and 5xx replies retry with exponential backoff (idempotent
        ops only live here, so replay is safe); 4xx return immediately."""
        return self._retry.call(self._request_once, method, url, payload)

    def _request_once(
        self, method: str, url: str, payload: bytes = b""
    ) -> tuple[int, bytes]:
        req = urllib.request.Request(url, data=payload or None, method=method)
        if self._access_key:
            for k, v in sign_v4(
                method,
                url,
                self._region,
                self._access_key,
                self._secret_key,
                payload,
            ).items():
                req.add_header(k, v)
        try:
            with urllib.request.urlopen(
                req, timeout=self._timeout, context=self._ssl_context
            ) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code in TRANSIENT_HTTP_STATUSES:
                raise mark_transient(
                    S3Error(f"{method} {url}: HTTP {exc.code}: {exc.read()[:200]!r}")
                ) from exc
            return exc.code, exc.read()
        except (urllib.error.URLError, OSError) as exc:
            raise mark_transient(S3Error(f"{method} {url}: {exc}")) from exc

    def insert(self, model: Model) -> None:
        status, body = self._request("PUT", self._url(model.id), model.models)
        if status not in (200, 201):
            raise S3Error(f"PUT model {model.id}: HTTP {status}: {body[:200]!r}")

    def get(self, model_id: str) -> Model | None:
        status, body = self._request("GET", self._url(model_id))
        if status == 404:
            return None
        if status != 200:
            raise S3Error(f"GET model {model_id}: HTTP {status}: {body[:200]!r}")
        return Model(model_id, body)

    def delete(self, model_id: str) -> None:
        status, body = self._request("DELETE", self._url(model_id))
        if status not in (200, 204, 404):
            raise S3Error(f"DELETE model {model_id}: HTTP {status}: {body[:200]!r}")


class S3StorageClient:
    """Backend entry point (type name: ``s3``)."""

    def __init__(self, config: dict[str, Any] | None = None):
        cfg = {k.upper(): v for k, v in (config or {}).items()}
        bucket = cfg.get("BUCKET_NAME")
        if not bucket:
            raise S3Error(
                "s3 storage source needs PIO_STORAGE_SOURCES_<NAME>_BUCKET_NAME"
            )
        self._models = S3Models(
            bucket=bucket,
            region=cfg.get("REGION", "us-east-1"),
            base_path=cfg.get("BASE_PATH", ""),
            endpoint=cfg.get("ENDPOINT"),
            access_key=cfg.get("ACCESS_KEY_ID"),
            secret_key=cfg.get("SECRET_ACCESS_KEY"),
            timeout=float(cfg.get("TIMEOUT", 30.0)),
            disable_ssl_verify=str(cfg.get("DISABLE_SSL_VERIFY", "")).lower()
            in ("1", "true", "yes"),
            retries=int(cfg.get("RETRIES", 3)),
            retry_backoff_s=float(cfg.get("RETRY_BACKOFF_S", 0.2)),
        )

    def models(self) -> S3Models:
        return self._models
