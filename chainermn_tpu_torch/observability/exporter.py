"""In-process HTTP ``/metrics`` scrape endpoint for live fleets — port of
``chainermn_tpu/observability/exporter.py`` (host code, copied as it is).

Everything the repo exported before this module was post-hoc: ``tools.obs``
turns JSONL logs into a Prometheus *textfile* after the run.  A fleet
operator needs the pull model instead — Prometheus scrapes each process
while it runs.  :class:`MetricsExporter` is that bridge: a stdlib
``http.server`` on a background daemon thread rendering a metrics
*source* through :func:`chainermn_tpu_torch.tools.obs.to_prometheus` on every
``GET /metrics``.

The source is either a
:class:`~chainermn_tpu_torch.observability.reporter.Reporter` (its
:meth:`~chainermn_tpu_torch.observability.reporter.Reporter.summary` is taken
fresh per scrape) or any zero-argument callable returning a
summary-shaped dict — the cluster router passes its merged *fleet view*
callable so one scrape of the router covers every replica.

Design constraints:

* **Injectable port** — ``port=0`` binds an ephemeral port (tests, many
  replicas per host); the bound port is available as :attr:`port` after
  :meth:`start`.
* **Zero impact on the serving path** — rendering happens on the scrape
  thread; the only shared state touched is the Reporter's lock for the
  duration of one ``summary()`` snapshot.  Nothing reaches the device;
  nothing is exported unless somebody scrapes.
* **Crash-independent** — the thread is a daemon; a replica dying takes
  its endpoint with it (Prometheus sees the target go down, which *is*
  the signal).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

__all__ = ["MetricsExporter"]

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Serve ``GET /metrics`` for one metrics source.

    ``source`` is a Reporter (anything with a ``summary()`` method) or a
    zero-arg callable returning a summary dict.  ``start()`` binds and
    returns the port; ``stop()`` shuts the server down.  Usable as a
    context manager.
    """

    def __init__(self, source, port: int = 0, host: str = "127.0.0.1",
                 prefix: str = "chainermn_tpu"):
        if hasattr(source, "summary"):
            snapshot: Callable[[], dict] = source.summary
        elif callable(source):
            snapshot = source
        else:
            raise TypeError(
                "source must be a Reporter or a zero-arg callable "
                f"returning a summary dict, got {type(source).__name__}"
            )
        self._snapshot = snapshot
        self._requested_port = int(port)
        self.host = host
        self.prefix = prefix
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        if self._server is not None:
            return self.port
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), self._make_handler()
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    def __enter__(self) -> "MetricsExporter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- read side -----------------------------------------------------
    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("exporter not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def render(self) -> str:
        """One exposition-format page — what a scrape returns, exposed
        for in-process assertions without a socket."""
        from ..tools.obs import to_prometheus

        return to_prometheus(self._snapshot(), prefix=self.prefix)

    # -- handler -------------------------------------------------------
    def _make_handler(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = exporter.render().encode()
                except Exception as exc:  # render must never kill serving
                    self.send_error(500, explain=str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        return Handler
