"""A deployment PKI minted with the system ``openssl``
(``minio_tpu/secure/pki.py``; the ``minio certgen`` role).

One CA, an S3 front leaf and an internode leaf, all EC P-256 (quick to
mint), with subject alternative names for ``localhost`` and
``127.0.0.1`` so hostname checks stay on against loopback endpoints.
``write_certs_dir`` lays the material out as ``CertManager.from_dir``
reads it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass

OPENSSL = "/usr/bin/openssl"

_EC_KEY = ("-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
           "-nodes")
DEFAULT_SAN = "DNS:localhost,IP:127.0.0.1"


class PKIError(Exception):
    pass


def available() -> bool:
    return os.path.exists(OPENSSL)


def _run(args: list[str]) -> None:
    proc = subprocess.run([OPENSSL, *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise PKIError(f"openssl {args[0]} failed: "
                       f"{proc.stderr.strip()[:500]}")


@dataclass(frozen=True)
class PKI:
    """The CA and the two leaf identities: the S3 front's and the
    internode plane's."""
    dir: str
    ca_cert: str
    ca_key: str
    s3_cert: str
    s3_key: str
    internode_cert: str
    internode_key: str

    def cert_manager(self, **kw):
        from .certs import CertManager
        return CertManager((self.s3_cert, self.s3_key),
                           internode=(self.internode_cert,
                                      self.internode_key),
                           ca_file=self.ca_cert, **kw)

    def write_certs_dir(self, certs_dir: str) -> str:
        """The ``tls.certs_dir`` layout: ``public.crt``/``private.key``,
        ``internode/`` and ``CAs/ca.crt``."""
        os.makedirs(os.path.join(certs_dir, "internode"), exist_ok=True)
        os.makedirs(os.path.join(certs_dir, "CAs"), exist_ok=True)
        shutil.copy(self.s3_cert, os.path.join(certs_dir, "public.crt"))
        shutil.copy(self.s3_key, os.path.join(certs_dir, "private.key"))
        shutil.copy(self.internode_cert,
                    os.path.join(certs_dir, "internode", "public.crt"))
        shutil.copy(self.internode_key,
                    os.path.join(certs_dir, "internode", "private.key"))
        shutil.copy(self.ca_cert, os.path.join(certs_dir, "CAs", "ca.crt"))
        return certs_dir


def mint_ca(out_dir: str, cn: str = "minio-tpu ephemeral CA",
            days: int = 3) -> tuple[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    crt = os.path.join(out_dir, "ca.crt")
    key = os.path.join(out_dir, "ca.key")
    # `req -x509` already stamps basicConstraints=CA:TRUE; adding it
    # again via -addext would DUPLICATE the extension and OpenSSL then
    # rejects the whole CA at verification time
    _run(["req", "-x509", *_EC_KEY, "-keyout", key, "-out", crt,
          "-days", str(days), "-subj", f"/CN={cn}",
          "-addext", "keyUsage=critical,keyCertSign,cRLSign"])
    return crt, key


def mint_leaf(out_dir: str, ca_cert: str, ca_key: str, name: str,
              san: str = DEFAULT_SAN, days: int = 2) -> tuple[str, str]:
    """A CA-signed leaf for server and client auth alike (the internode
    identity is served to peers and presented as the mTLS client
    certificate)."""
    os.makedirs(out_dir, exist_ok=True)
    crt = os.path.join(out_dir, f"{name}.crt")
    key = os.path.join(out_dir, f"{name}.key")
    csr = os.path.join(out_dir, f"{name}.csr")
    ext = os.path.join(out_dir, f"{name}.ext")
    # `openssl x509 -req` (1.1.1) does not copy a CSR's extensions: the
    # SAN and the key usages ride an extfile at signing
    with open(ext, "w") as f:
        f.write(f"subjectAltName={san}\n"
                "extendedKeyUsage=serverAuth,clientAuth\n"
                "basicConstraints=CA:FALSE\n"
                "keyUsage=digitalSignature,keyEncipherment\n")
    _run(["req", "-new", *_EC_KEY, "-keyout", key, "-out", csr,
          "-subj", f"/CN={name}"])
    _run(["x509", "-req", "-in", csr, "-CA", ca_cert, "-CAkey", ca_key,
          "-CAcreateserial", "-out", crt, "-days", str(days),
          "-extfile", ext])
    return crt, key


def mint_cluster_pki(out_dir: str, san: str = DEFAULT_SAN) -> PKI:
    """CA, S3 leaf and internode leaf under ``out_dir``: what a cluster
    with both planes under TLS needs."""
    if not available():
        raise PKIError(f"{OPENSSL} not present on this image")
    ca_crt, ca_key = mint_ca(out_dir)
    s3_crt, s3_key = mint_leaf(out_dir, ca_crt, ca_key, "s3", san=san)
    in_crt, in_key = mint_leaf(out_dir, ca_crt, ca_key, "internode",
                               san=san)
    return PKI(out_dir, ca_crt, ca_key, s3_crt, s3_key, in_crt, in_key)
