"""Device store: state, fused ingest step and reads (PyTorch), and the
SpanStore SPI over it."""
