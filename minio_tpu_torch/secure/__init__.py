"""Secrets at rest (the sealing of config.json and iam.json) and TLS on
the S3 front (``certs.py``)."""
