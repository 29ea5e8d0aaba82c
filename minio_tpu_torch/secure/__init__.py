"""Secrets at rest (the sealing of config.json and iam.json), TLS on
both planes (``certs.py``, ``transport.py``), the PKI minted with the
system ``openssl`` (``pki.py``) and the OPA webhook (``opa.py``)."""
