"""Test fixtures of the port: the crash-injection harness
(``testing/crash.py``)."""
