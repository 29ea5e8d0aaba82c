"""Background services (``minio_tpu/background/``), the part the port
runs: the heal sweep (cmd/global-heal.go)."""
