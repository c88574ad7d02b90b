"""Data model: spans, traces, dependency links, and the columnar schema."""
