"""Shared set-up of the identity and at-rest tests: ``os.urandom`` pinned
in both packages, so DARE nonces, configcrypt salts, STS keys and
service-account keys are the same draws in each, and the sealed blobs
on their drives byte-equal.

Each package gets its own seeded stream, so only the order of draws
within a package matters, never how the two interleave.  The draw sites
are the modules' own names for the source: ``os.urandom`` in
``crypto/dare.py`` and ``secure/configcrypt.py``, and ``secrets`` (which
reads ``os.urandom``) in ``iam/sts.py`` and ``iam/sys.py``.  STS expiry
reads the clock, pinned too.  Nothing else draws from these streams:
request ids and upload ids keep their own sources."""

import base64
import os
import time
import types

import numpy as np

from minio_tpu.crypto import dare as ref_dare
from minio_tpu.iam import sts as ref_sts
from minio_tpu.iam import sys as ref_iamsys
from minio_tpu.secure import configcrypt as ref_cc
from minio_tpu_torch.crypto import dare as port_dare
from minio_tpu_torch.iam import sts as port_sts
from minio_tpu_torch.iam import sys as port_iamsys
from minio_tpu_torch.secure import configcrypt as port_cc

T_NOW = int(time.time())


def stream(seed: int):
    """A seeded ``os.urandom``."""
    rng = np.random.default_rng(seed)
    return lambda n: rng.bytes(n)


def _secrets(urandom) -> types.SimpleNamespace:
    """``secrets``' token calls over ``urandom``."""
    return types.SimpleNamespace(
        token_bytes=urandom,
        token_hex=lambda n: urandom(n).hex(),
        token_urlsafe=lambda n: base64.urlsafe_b64encode(
            urandom(n)).rstrip(b"=").decode())


def pin_random(mp, seed: int = 12) -> None:
    """Both packages' draws pinned, each to its own stream of ``seed``."""
    for dare, cc, sts, iamsys in ((ref_dare, ref_cc, ref_sts, ref_iamsys),
                                  (port_dare, port_cc, port_sts,
                                   port_iamsys)):
        urandom = stream(seed)
        fake_os = types.SimpleNamespace(urandom=urandom, environ=os.environ)
        mp.setattr(dare, "os", fake_os)
        mp.setattr(cc, "os", fake_os)
        mp.setattr(sts, "pysecrets", _secrets(urandom))
        mp.setattr(iamsys, "pysecrets", _secrets(urandom))
        mp.setattr(sts, "time", types.SimpleNamespace(time=lambda: T_NOW))


def sealed(root, n: int, path: str) -> list[bytes]:
    """``.mt.sys/<path>`` of drives ``d0`` .. ``d<n-1>`` under ``root``."""
    out = []
    for i in range(n):
        with open(os.path.join(root, f"d{i}", ".mt.sys", path), "rb") as f:
            out.append(f.read())
    return out
