"""Remote stats posting: client side of the remote receiver.

Parity with ``RemoteUIStatsStorageRouter`` and
``deeplearning4j-ui-remote-iterationlisteners/.../WebReporter.java``: a
StatsStorageRouter that POSTs each record to a UIServer's ``/remote``
endpoint over HTTP (urllib, retry with backoff), so a training process can
report to a dashboard running elsewhere. A copy of the JAX package's
jax-free ``ui/remote.py``.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Optional

from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorageRouter

log = logging.getLogger(__name__)


class UiConnectionInfo:
    """Address builder for a remote UI endpoint
    (``deeplearning4j-core/.../ui/UiConnectionInfo.java``): scheme +
    host:port + path, with a session id query and optional login
    credentials."""

    def __init__(self, address: str = "localhost", port: int = 8080,
                 path: str = "", use_https: bool = False,
                 session_id: Optional[str] = None,
                 login: Optional[str] = None, password: Optional[str] = None):
        import uuid
        self.address = address
        self.port = int(port)
        self.path = path
        self.use_https = use_https
        self.session_id = session_id or str(uuid.uuid4())
        self.login = login
        self.password = password

    def get_first_part(self) -> str:
        scheme = "https" if self.use_https else "http"
        return f"{scheme}://{self.address}:{self.port}"

    def get_second_part(self, n_path: str = "") -> str:
        import re
        out = ""
        if self.path:
            out += (self.path if self.path.startswith("/")
                    else "/" + self.path) + "/"
        if n_path:
            n_path = n_path.lstrip("/")
            out += "/" + n_path + "/"
        return re.sub(r"/{2,}", "/", out)

    def get_full_address(self, n_path: str = "") -> str:
        if not n_path:
            return self.get_first_part() + self.get_second_part()
        return (self.get_first_part() + self.get_second_part(n_path)
                + f"?sid={self.session_id}")


class WebReporter:
    """POST a JSON payload to a URL with retries (``WebReporter.java``)."""

    @staticmethod
    def report_to_url(url: str, payload: dict, retries: int = 3,
                      timeout: float = 5.0, backoff: float = 0.2) -> bool:
        body = json.dumps(payload).encode("utf-8")
        last_err: Optional[Exception] = None
        for attempt in range(retries):
            try:
                req = urllib.request.Request(
                    url, data=body, headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return 200 <= resp.status < 300
            except (urllib.error.URLError, OSError) as e:
                last_err = e
                time.sleep(backoff * (2 ** attempt))
        raise ConnectionError(f"Failed to POST to {url}: {last_err}")


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """Router that ships records to a remote UIServer ``/remote`` endpoint.

    By default a dashboard outage logs a warning and DROPS the record — a
    stats reporter must never kill training (the reference router behaves the
    same). Set ``raise_on_error=True`` to surface failures instead.
    """

    def __init__(self, url: str, retries: int = 3, timeout: float = 5.0,
                 raise_on_error: bool = False):
        if not url.endswith("/remote"):
            url = url.rstrip("/") + "/remote"
        self.url = url
        self.retries = retries
        self.timeout = timeout
        self.raise_on_error = raise_on_error
        self._warned = False

    def _send(self, p: Persistable, static: bool) -> None:
        payload = {"session_id": p.session_id, "type_id": p.type_id,
                   "worker_id": p.worker_id, "timestamp": p.timestamp,
                   "static": static, "data": p.data}
        try:
            WebReporter.report_to_url(self.url, payload, self.retries,
                                      self.timeout)
        except ConnectionError:
            if self.raise_on_error:
                raise
            if not self._warned:
                self._warned = True
                log.warning("Dropping stats record: cannot reach %s "
                            "(further drops are silent)", self.url)

    def put_static_info(self, p: Persistable) -> None:
        self._send(p, static=True)

    def put_update(self, p: Persistable) -> None:
        self._send(p, static=False)
