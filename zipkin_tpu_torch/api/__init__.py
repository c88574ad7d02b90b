"""The API layer: request parsing (``extract_query``) and the threaded
HTTP server (``ApiServer``, ``make_server``), the port's copies of
``zipkin_tpu/api``'s."""

from zipkin_tpu_torch.api.query_extractor import extract_query  # noqa: F401
from zipkin_tpu_torch.api.server import ApiServer, make_server  # noqa: F401
