"""IAMSys: users, service accounts, STS sessions, groups and policies
(``minio_tpu/iam/sys.py``, cmd/iam.go:204 with cmd/iam-object-store.go).

The state is kept in memory and persisted whole after every mutation as
the reference persists it: ``config/iam.json`` in the system volume of
every drive of the layer's metadata set, sealed under the root secret
(``secure/configcrypt.py``).  ``load`` reads the first copy that opens,
under the root secret or a retired one (``MT_ADMIN_SECRET_OLD``), and
reseals it under the current secret when it was not sealed by it.  The
S3 front asks ``lookup_secret`` to authenticate a request and
``is_allowed`` (with ``session_policy_allows`` where a bucket policy
grants) to authorise it.

With an etcd client attached (``attach_etcd``, from the ``etcd``
subsystem) the state lives in etcd instead, one key per entity under
``<path_prefix>/config/iam/`` (cmd/iam-etcd-store.go), and no
``iam.json`` is written to the drives.  Federated identities get STS
sessions of their own: an OpenID subject (``assume_role_web_identity``)
with the policies its token names, an LDAP user
(``assume_role_ldap_identity``) with the policies mapped to its DN and
its groups' DNs (``set_ldap_policy``).  With an ``authorizer`` (the
OPA webhook of ``secure/opa.py``), ``is_allowed`` asks it instead of the
local policy documents, but for the root credential.  Service-account
keys come from ``secrets``, so from ``os.urandom``.
"""

from __future__ import annotations

import json
import secrets as pysecrets
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..storage.xl_storage import SYS_DIR
from . import policy as iampolicy
from . import sts

IAM_PATH = "config/iam.json"                # in the system volume


class IAMError(Exception):
    pass


class NoSuchUser(IAMError):
    pass


class NoSuchPolicy(IAMError):
    pass


@dataclass
class UserIdentity:
    access_key: str
    secret_key: str
    status: str = "enabled"             # enabled | disabled
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    parent_user: str = ""               # service accounts and STS sessions
    expiration: int = 0                 # unix s; 0: permanent
    session_policy: str = ""            # an STS session's inline policy

    def expired(self) -> bool:
        return self.expiration != 0 and self.expiration < time.time()

    def to_dict(self) -> dict:
        return {"ak": self.access_key, "sk": self.secret_key,
                "status": self.status, "policies": self.policies,
                "groups": self.groups, "parent": self.parent_user,
                "exp": self.expiration, "spol": self.session_policy}

    @classmethod
    def from_dict(cls, d: dict) -> "UserIdentity":
        return cls(d["ak"], d["sk"], d.get("status", "enabled"),
                   list(d.get("policies", [])), list(d.get("groups", [])),
                   d.get("parent", ""), d.get("exp", 0), d.get("spol", ""))


class IAMSys:
    def __init__(self, layer, root_access_key: str, root_secret_key: str):
        self._layer = layer             # persists on layer.meta_set
        self.root = UserIdentity(root_access_key, root_secret_key,
                                 policies=["consoleAdmin"])
        self._users: dict[str, UserIdentity] = {}
        self._policies: dict[str, iampolicy.Policy] = dict(iampolicy.CANNED)
        self._group_policies: dict[str, list[str]] = {}
        # LDAP user or group DN -> policy names (cmd/iam.go mappedPolicy)
        self._ldap_policies: dict[str, list[str]] = {}
        self._mu = threading.RLock()
        self._save_mu = threading.Lock()   # one snapshot-and-write at a time
        # the OPA webhook (secure/opa.py): when set, every decision but
        # root's is its; swapped live by S3Server.reload_policy_config
        self.authorizer = None
        # called after every saved change, in either store (a cluster's
        # peer fan-out, S3Server.attach_peers)
        self.on_change = None
        # the etcd store (cmd/iam-etcd-store.go), when attached
        self._etcd = None
        self._etcd_prefix = "config/iam/"
        self._etcd_written: dict[str, bytes] = {}

    # -- at rest in etcd (cmd/iam-etcd-store.go) ----------------------------

    def attach_etcd(self, client, path_prefix: str = "") -> None:
        """Keep the state in etcd from now on, one key per user and per
        policy under ``<path_prefix>/config/iam/``, and load it."""
        self._etcd = client
        self._etcd_prefix = (path_prefix.rstrip("/") + "/"
                             if path_prefix else "") + "config/iam/"
        self.load()

    def _etcd_save(self, doc: dict) -> None:
        """Write the entities that changed since this process last wrote
        or loaded them, and delete those it removed since; what other
        servers sharing the etcd wrote is left alone."""
        pfx = self._etcd_prefix
        now: dict[str, bytes] = {}
        for k, u in doc["users"].items():
            now[f"{pfx}users/{k}"] = json.dumps(u).encode()
        for name, p in doc["policies"].items():
            now[f"{pfx}policies/{name}"] = json.dumps(p).encode()
        now[f"{pfx}groups.json"] = json.dumps(doc["groups"]).encode()
        now[f"{pfx}ldap-policies.json"] = \
            json.dumps(doc["ldap_policies"]).encode()
        prev = self._etcd_written
        for key, blob in now.items():
            if prev.get(key) != blob:
                self._etcd.put(key, blob)
        for key in prev:
            if key not in now:
                self._etcd.delete(key)
        self._etcd_written = now

    def _etcd_load(self) -> dict | None:
        """The document the keys under the prefix make; None when there
        are none.  What is read becomes the baseline of the next save."""
        pfx = self._etcd_prefix
        kvs = self._etcd.get_prefix(pfx)
        self._etcd_written = {k.decode(): bytes(v) for k, v in kvs}
        if not kvs:
            return None
        doc: dict = {"users": {}, "policies": {}, "groups": {},
                     "ldap_policies": {}}
        for key, val in kvs:
            k = key.decode()[len(pfx):]
            try:
                parsed = json.loads(val)
            except json.JSONDecodeError:
                continue
            if k.startswith("users/"):
                doc["users"][k[len("users/"):]] = parsed
            elif k.startswith("policies/"):
                doc["policies"][k[len("policies/"):]] = parsed
            elif k == "groups.json":
                doc["groups"] = parsed
            elif k == "ldap-policies.json":
                doc["ldap_policies"] = parsed
        return doc

    # -- at rest (IAMObjectStore) ------------------------------------------

    def _save(self) -> None:
        from ..secure import configcrypt
        # snapshot and write under one lock: an older snapshot is never
        # written after a newer one
        with self._save_mu:
            with self._mu:
                doc = {
                    "users": {k: u.to_dict() for k, u in self._users.items()},
                    "policies": {name: json.loads(p.to_json())
                                 for name, p in self._policies.items()
                                 if name not in iampolicy.CANNED},
                    "groups": self._group_policies,
                    "ldap_policies": self._ldap_policies,
                }
            if self._etcd is not None:
                self._etcd_save(doc)
            else:
                blob = configcrypt.encrypt_data(self.root.secret_key,
                                                json.dumps(doc).encode())
                er = self._layer.meta_set
                er._fanout(lambda d: d.write_all(SYS_DIR, IAM_PATH, blob),
                           er.disks)
        if self.on_change is not None:
            self.on_change()

    def load(self) -> None:
        from ..secure import configcrypt
        doc, reseal = None, False
        if self._etcd is not None:
            doc = self._etcd_load()
        else:
            olds = configcrypt.old_secrets_from_env()
            er = self._layer.meta_set
            res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, IAM_PATH),
                                er.disks)
            for r in res:
                if r is None:
                    continue
                try:
                    blob, reseal = configcrypt.maybe_decrypt(
                        self.root.secret_key, r, olds)
                    doc = json.loads(blob)
                    break
                except (configcrypt.DecryptError, json.JSONDecodeError):
                    continue        # sealed under a secret not offered
        with self._mu:
            if doc:
                self._users = {k: UserIdentity.from_dict(u)
                               for k, u in doc.get("users", {}).items()}
                for name, pd in doc.get("policies", {}).items():
                    self._policies[name] = iampolicy.Policy.from_json(
                        json.dumps(pd))
                self._group_policies = doc.get("groups", {})
                self._ldap_policies = doc.get("ldap_policies", {})
        if doc and reseal:
            self._save()

    # -- users -------------------------------------------------------------

    def _check_policies(self, names: list[str]) -> None:
        unknown = [n for n in names if n not in self._policies]
        if unknown:
            raise NoSuchPolicy(", ".join(unknown))

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None) -> None:
        with self._mu:
            self._check_policies(policies or [])
            self._users[access_key] = UserIdentity(
                access_key, secret_key, policies=policies or [])
        self._save()

    def remove_user(self, access_key: str) -> None:
        """Remove a user and its service accounts."""
        with self._mu:
            if access_key not in self._users:
                raise NoSuchUser(access_key)
            del self._users[access_key]
            self._users = {k: u for k, u in self._users.items()
                           if u.parent_user != access_key}
        self._save()

    def set_user_status(self, access_key: str, enabled: bool) -> None:
        with self._mu:
            u = self._users.get(access_key)
            if u is None:
                raise NoSuchUser(access_key)
            u.status = "enabled" if enabled else "disabled"
        self._save()

    def list_users(self) -> list[UserIdentity]:
        with self._mu:
            return [u for u in self._users.values() if not u.parent_user]

    def list_service_accounts(self, parent: str | None = None
                              ) -> list[UserIdentity]:
        """Permanent parented credentials (not STS sessions)."""
        with self._mu:
            return [u for u in self._users.values()
                    if u.parent_user and not u.expiration
                    and (parent is None or u.parent_user == parent)]

    def get_user(self, access_key: str) -> UserIdentity:
        with self._mu:
            if access_key == self.root.access_key:
                return self.root
            u = self._users.get(access_key)
            if u is None:
                raise NoSuchUser(access_key)
            return u

    # -- service accounts (cmd/iam.go NewServiceAccount) -------------------

    def new_service_account(self, parent_access_key: str,
                            access_key: str | None = None,
                            secret_key: str | None = None) -> UserIdentity:
        parent = self.get_user(parent_access_key)
        sa = UserIdentity(
            access_key or "SA" + pysecrets.token_hex(8).upper(),
            secret_key or pysecrets.token_urlsafe(24),
            policies=list(parent.policies),
            parent_user=parent.access_key)
        with self._mu:
            self._users[sa.access_key] = sa
        self._save()
        return sa

    # -- STS (cmd/sts-handlers.go AssumeRole) ------------------------------

    def assume_role(self, parent_access_key: str,
                    duration_s: int | None = None,
                    session_policy: str | None = None) -> sts.TempCredentials:
        """Expiring credentials authorised as the parent, bounded by an
        inline session policy when one is given.  A session cannot mint
        another."""
        parent = self.get_user(parent_access_key)
        if parent.parent_user and parent.expiration:
            raise sts.STSError("AccessDenied", "cannot AssumeRole with "
                               "temporary credentials")
        if session_policy:
            try:
                iampolicy.Policy.from_json(session_policy)
            except Exception as e:  # noqa: BLE001 — any malformed document
                raise sts.STSError("MalformedPolicyDocument",
                                   str(e)) from e
        creds = sts.mint(parent.access_key, self.root.secret_key,
                         sts.DEFAULT_DURATION_S if duration_s is None
                         else duration_s)
        with self._mu:
            # each mint sweeps the expired sessions: one lock, one write
            for k in [k for k, u in self._users.items() if u.expired()]:
                del self._users[k]
            self._users[creds.access_key] = UserIdentity(
                creds.access_key, creds.secret_key,
                parent_user=parent.access_key,
                expiration=creds.expiration,
                session_policy=session_policy or "")
        self._save()
        return creds

    # -- federated identities (cmd/sts-handlers.go) ------------------------

    def assume_role_web_identity(self, subject: str,
                                 policy_names: list[str],
                                 duration_s: int | None = None
                                 ) -> sts.TempCredentials:
        """A session for an OpenID subject: no IAM user stands behind
        it, so it carries the policies its token named."""
        self._check_policies(policy_names)
        creds = sts.mint(f"oidc:{subject}", self.root.secret_key,
                         sts.DEFAULT_DURATION_S if duration_s is None
                         else duration_s)
        self._register_temp_identity(creds, list(policy_names),
                                     f"oidc:{subject}")
        return creds

    def _register_temp_identity(self, creds, policies: list[str],
                                parent: str, groups: list[str] = (),
                                session_policy: str = "") -> None:
        """Sweep the expired sessions and keep a federated one."""
        with self._mu:
            for k in [k for k, u in self._users.items() if u.expired()]:
                del self._users[k]
            self._users[creds.access_key] = UserIdentity(
                creds.access_key, creds.secret_key, policies=policies,
                parent_user=parent, groups=list(groups),
                expiration=creds.expiration, session_policy=session_policy)
        self._save()

    def set_ldap_policy(self, dn: str, policy_names: list[str]) -> None:
        """Map an LDAP user or group DN to policies (no names: unmap)."""
        self._check_policies(policy_names)
        with self._mu:
            if policy_names:
                self._ldap_policies[dn] = list(policy_names)
            else:
                self._ldap_policies.pop(dn, None)
        self._save()

    def list_ldap_policies(self) -> dict[str, list[str]]:
        with self._mu:
            return {k: list(v) for k, v in self._ldap_policies.items()}

    def assume_role_ldap_identity(self, user_dn: str, username: str,
                                  groups: list[str],
                                  duration_s: int | None = None,
                                  session_policy: str | None = None
                                  ) -> sts.TempCredentials:
        """A session for a user the directory vouched for
        (cmd/sts-handlers.go:436): the policies mapped to its DN and its
        groups' DNs now, within ``session_policy``; its token carries
        ``ldapUser`` and ``ldapUsername``."""
        with self._mu:
            pols: list[str] = []
            for dn in [user_dn, *groups]:
                for p in self._ldap_policies.get(dn, []):
                    if p not in pols:
                        pols.append(p)
        if not pols:
            raise IAMError(f"no policy mapped for LDAP identity {user_dn} "
                           "or its groups")
        if session_policy:
            try:
                iampolicy.Policy.from_json(session_policy)
            except Exception as e:  # noqa: BLE001 — any malformed document
                raise sts.STSError("MalformedPolicyDocument",
                                   str(e)) from e
        creds = sts.mint(f"ldap:{user_dn}", self.root.secret_key,
                         sts.DEFAULT_DURATION_S if duration_s is None
                         else duration_s,
                         extra_claims={"ldapUser": user_dn,
                                       "ldapUsername": username})
        self._register_temp_identity(creds, pols, f"ldap:{user_dn}",
                                     groups, session_policy or "")
        return creds

    def purge_expired(self) -> int:
        """Drop expired sessions; how many went."""
        with self._mu:
            dead = [k for k, u in self._users.items() if u.expired()]
            for k in dead:
                del self._users[k]
        if dead:
            self._save()
        return len(dead)

    # -- policies ----------------------------------------------------------

    def set_policy(self, name: str, pol: iampolicy.Policy) -> None:
        with self._mu:
            self._policies[name] = pol
        self._save()

    def delete_policy(self, name: str) -> None:
        with self._mu:
            if name not in self._policies or name in iampolicy.CANNED:
                raise NoSuchPolicy(name)
            del self._policies[name]
        self._save()

    def get_policy(self, name: str) -> iampolicy.Policy:
        with self._mu:
            p = self._policies.get(name)
            if p is None:
                raise NoSuchPolicy(name)
            return p

    def list_policies(self) -> list[str]:
        with self._mu:
            return sorted(self._policies)

    def attach_policy(self, access_key: str, policy_names: list[str]) -> None:
        with self._mu:
            self._check_policies(policy_names)
            u = self._users.get(access_key)
            if u is None:
                raise NoSuchUser(access_key)
            u.policies = list(policy_names)
        self._save()

    # -- groups ------------------------------------------------------------

    def list_groups(self) -> dict[str, list[str]]:
        with self._mu:
            return {g: list(p) for g, p in self._group_policies.items()}

    def set_group_policy(self, group: str, policy_names: list[str]) -> None:
        self._check_policies(policy_names)
        with self._mu:
            self._group_policies[group] = list(policy_names)
        self._save()

    def add_user_to_group(self, access_key: str, group: str) -> None:
        with self._mu:
            u = self._users.get(access_key)
            if u is None:
                raise NoSuchUser(access_key)
            if group not in u.groups:
                u.groups.append(group)
        self._save()

    # -- what the front asks (cmd/auth-handler.go) -------------------------

    def lookup_secret(self, access_key: str) -> Optional[str]:
        """The signing secret; None for an unknown key, a disabled user
        and an expired session."""
        with self._mu:
            if access_key == self.root.access_key:
                return self.root.secret_key
            u = self._users.get(access_key)
            if u is None or u.status != "enabled" or u.expired():
                return None
            return u.secret_key

    @staticmethod
    def _session_policy(u: UserIdentity) -> iampolicy.Policy | None:
        """An STS session's policy, parsed once per credential."""
        if not u.session_policy:
            return None
        pol = getattr(u, "_spol_cache", None)
        if pol is None:
            pol = u._spol_cache = iampolicy.Policy.from_json(
                u.session_policy)
        return pol

    def session_policy_allows(self, access_key: str, action: str,
                              resource: str = "",
                              context: dict | None = None) -> bool:
        """The session policy alone: True unless ``access_key`` is an STS
        session whose policy does not grant the action.  Where a bucket
        policy grants, a session is still bounded by its own policy."""
        with self._mu:
            u = self._users.get(access_key)
            if u is None or not u.session_policy:
                return True
            if u.status != "enabled" or u.expired():
                return False
            pol = self._session_policy(u)
        return pol.is_allowed(action, resource, context)

    def is_allowed(self, access_key: str, action: str,
                   resource: str = "", context: dict | None = None) -> bool:
        """IAMSys.IsAllowed: root may do everything; a user by its own
        and its groups' policies; a service account by the policies it
        took from its parent; an STS session as its parent (a federated
        one by the policies it carries), within its session policy.
        Deny anywhere wins.  With an ``authorizer`` the decision is the
        webhook's, bounded by a session policy; whether the key
        authenticates is still decided here."""
        if access_key == self.root.access_key:
            return True
        authorizer = self.authorizer
        if authorizer is not None:
            with self._mu:
                u = self._users.get(access_key)
                if u is None or u.status != "enabled" or u.expired():
                    return False
            if not self.session_policy_allows(access_key, action,
                                              resource, context):
                return False
            from ..secure.opa import auth_args
            return authorizer.is_allowed(auth_args(
                access_key, action, resource, context, owner=False))
        with self._mu:
            u = self._users.get(access_key)
            if u is None or u.status != "enabled" or u.expired():
                return False
            session_pol = self._session_policy(u)
            if u.parent_user and u.expiration:
                if u.parent_user == self.root.access_key:
                    names = None        # root's session: allow-all base
                elif u.parent_user.startswith(("oidc:", "ldap:")):
                    names = list(u.policies)    # a federated session's own
                else:
                    p = self._users.get(u.parent_user)
                    if p is None or p.status != "enabled":
                        return False
                    names = list(p.policies)
                    for g in p.groups:
                        names.extend(self._group_policies.get(g, []))
            else:
                names = list(u.policies)
                for g in u.groups:
                    names.extend(self._group_policies.get(g, []))
            pols = [] if names is None else \
                [self._policies[n] for n in names if n in self._policies]
        if session_pol is not None and \
                not session_pol.is_allowed(action, resource, context):
            return False
        if names is None:
            return True
        if not pols:
            return False
        merged = iampolicy.Policy(
            statements=[s for p in pols for s in p.statements])
        return merged.is_allowed(action, resource, context)
