"""Server-address parsing, dependency-free.

Lives outside ``server.py`` so pure network clients (``client.py``) never
drag the engine stack (torch, database, commands) into their import graph —
a client process needs only a socket and JSON.
"""

from __future__ import annotations


def parse_addr(addr):
    """``"unix:PATH"`` | ``"HOST:PORT"`` | ``(host, port)`` → address spec.

    Returns ``("unix", path)`` or ``("tcp", host, port)``.
    """
    if isinstance(addr, tuple):
        return ("tcp", str(addr[0]), int(addr[1]))
    s = str(addr)
    if s.startswith("unix:"):
        path = s[len("unix:"):]
        if not path:
            raise ValueError(f"Empty unix socket path in address {addr!r}")
        return ("unix", path)
    host, sep, port = s.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"Bad server address {addr!r}: expected HOST:PORT or unix:PATH")
    try:
        return ("tcp", host, int(port))
    except ValueError as e:
        raise ValueError(f"Bad port in server address {addr!r}") from e
