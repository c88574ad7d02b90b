"""Static single-page UI (the zipkin-web role, minus the JVM).

The port's copy of ``zipkin_tpu/web``: ``index.html`` and the devtools
extension (``extension/``) are the reference's files byte for byte.
The page renders from the same JSON API the port's ``api.server``
serves: trace list and search, the per-trace waterfall, the dependency
graph fed by ``/api/dependencies``. No build system, no vendored JS.
"""

from __future__ import annotations

import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def index_html() -> bytes:
    with open(os.path.join(_HERE, "index.html"), "rb") as f:
        return f.read()
