"""Observability (``minio_tpu/obs/``), the part the port runs: the
last-minute latency windows."""
