"""Host (numpy) sketch primitives of the cold tier, torch side.

Only ``sketches`` is ported so far: the hashes and the log-histogram
bucket index the host sketch mirror (``store/mirror.py``) shares with
the device step. The segment format, directory and tiered store come
with the capture and cold-tier slice.
"""
