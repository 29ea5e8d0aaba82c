"""The admin API, its client and the Prometheus metrics
(``minio_tpu/admin/``)."""
