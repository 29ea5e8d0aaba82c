"""AES-GCM from the system libcrypto, DARE 2.0 streams over it, SSE-C,
SSE-S3 and SSE-KMS (``sse.py``) and their key services (``kms.py``,
``kes.py``, ``vault.py``)."""
