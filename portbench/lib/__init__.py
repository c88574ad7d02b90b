"""The port's benchmark: harness, traffic, reference and checks."""
