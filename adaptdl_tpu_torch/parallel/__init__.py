"""Parallel modes of the port: per-layer ZeRO-3 (:mod:`.zero3`)."""
