"""Shared stdlib HTTP-server base of the serving tier.

A copy of lightgbm_tpu/httpd.py.

``ThreadingHTTPServer.shutdown()`` only stops the accept loop: handler
threads serving keep-alive (HTTP/1.1) clients keep answering on their
ESTABLISHED sockets until the *client* hangs up.  An in-process
``stop()`` must instead look like a process kill — every live socket
severed, clients seeing a transport error — or the router's breaker
drills (and its per-thread backend connection pool) would observe a
"dead" backend that still answers through zombie handler threads.
Stdlib-only on purpose.
"""
from __future__ import annotations

import socket
import threading
from http.server import ThreadingHTTPServer


class SeveringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks established connections so
    ``close_client_connections`` can sever them all at stop."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._live_conns = set()
        self._live_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._live_lock:
            self._live_conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def close_client_connections(self) -> None:
        """Sever every established connection — idle keep-alive AND
        in-flight.  ``socket.shutdown`` only (never ``close``): the
        handler thread still owns the fd and closes it on its own way
        out via ``shutdown_request``."""
        with self._live_lock:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
