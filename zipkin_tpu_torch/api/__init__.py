"""The API layer's request parsing: GET params → ``QueryRequest``
(``extract_query``, the port's copy of ``zipkin_tpu/api``'s). The JSON
routes of ``zipkin_tpu/api/server.py`` come with the daemon."""

from zipkin_tpu_torch.api.query_extractor import extract_query  # noqa: F401
