"""Test fixtures of the port: the crash-injection harness
(``testing/crash.py``) and the in-process v0 Kafka broker with its
minimal producer and consumer (``testing/kafka_fake.py``)."""
