"""OCI-registry image verifier: the network implementation of the
:class:`~kyverno_tpu_torch.engine.image_verify.Verifier` seam.

Mirrors kyverno/pkg/cosign/cosign.go:

- ``verify_signature`` (cosign.go:30 Verify + verifySignature): resolve
  the image's manifest digest, fetch the cosign signature object (tag
  ``sha256-<hex>.sig`` in the image repo, or the ``repository``
  override), ECDSA-P256-verify each layer's signature annotation over the
  SimpleSigning payload blob, and require the payload's
  ``critical.image.docker-manifest-digest`` to bind the resolved digest
  (the reference's payload check in cosign.go:77).
- ``fetch_attestations`` (cosign.go:103): fetch the ``.att`` object,
  verify each layer's DSSE envelope (PAE pre-authentication encoding over
  payloadType+payload), and return the decoded in-toto statements.

Transport is the Docker Registry HTTP API v2 over stdlib urllib with
token auth (401 + WWW-Authenticate: Bearer -> token exchange), so this
works against real registries; the test suite runs it against an
in-process registry stub speaking the same protocol.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import time
import urllib.error
import urllib.request

from ..utils import ecdsa
from .image_verify import VerificationError, Verifier

SIG_ANNOTATION = "dev.cosignproject.cosign/signature"
MANIFEST_ACCEPT = ", ".join([
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
])


def parse_image_ref(image: str, default_registry: str = "docker.io"):
    """image string -> (registry, repository, tag, digest)."""
    digest = ""
    if "@" in image:
        image, digest = image.split("@", 1)
    tag = ""
    head, _, last = image.rpartition("/")
    if ":" in last:
        last, tag = last.split(":", 1)
    name = f"{head}/{last}" if head else last

    parts = name.split("/")
    if len(parts) > 1 and ("." in parts[0] or ":" in parts[0]
                           or parts[0] == "localhost"):
        registry, repo = parts[0], "/".join(parts[1:])
    else:
        registry, repo = default_registry, name
    if registry == "docker.io" and "/" not in repo:
        repo = "library/" + repo      # official images live under library/
    return registry, repo, tag or ("" if digest else "latest"), digest


class RegistryClient:
    """Minimal Docker Registry API v2 client with Bearer token auth.

    The default timeout is deliberately tight: this client runs inside
    the synchronous admission path, and the Kubernetes webhook budget is
    10s (configmanager.go:33) — one slow registry must not eat it all."""

    def __init__(self, plain_http: bool = False, timeout_s: float = 5.0):
        self.plain_http = plain_http
        self.timeout_s = timeout_s
        # real registry tokens are scoped per repository; key accordingly
        self._tokens: dict[tuple[str, str], str] = {}

    def _base(self, registry: str) -> str:
        scheme = "http" if self.plain_http else "https"
        host = "registry-1.docker.io" if registry == "docker.io" else registry
        return f"{scheme}://{host}"

    @staticmethod
    def _repo_of(path: str) -> str:
        # /v2/<repo...>/{manifests|blobs}/<ref>
        parts = path.split("/")
        return "/".join(parts[2:-2]) if len(parts) >= 5 else ""

    def _get(self, registry: str, path: str, accept: str = "",
             _retried: bool = False):
        url = self._base(registry) + path
        req = urllib.request.Request(url)
        if accept:
            req.add_header("Accept", accept)
        token = self._tokens.get((registry, self._repo_of(path)))
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            if e.code == 401 and not _retried:
                # a cached token may be expired or scoped to another repo:
                # always re-exchange once, then give up
                self._tokens[(registry, self._repo_of(path))] = \
                    self._fetch_token(
                        registry, e.headers.get("WWW-Authenticate", ""))
                return self._get(registry, path, accept, _retried=True)
            raise VerificationError(
                f"registry GET {path} failed: HTTP {e.code}") from e
        except OSError as e:
            raise VerificationError(f"registry unreachable: {e}") from e
        with resp:
            return resp.read(), dict(resp.headers)

    def _fetch_token(self, registry: str, challenge: str) -> str:
        """Docker registry token exchange (Bearer realm=...,service=...)."""
        fields = dict(re.findall(r'(\w+)="([^"]*)"', challenge))
        realm = fields.get("realm")
        if not realm:
            raise VerificationError("unsupported auth challenge")
        params = "&".join(f"{k}={v}" for k, v in fields.items()
                          if k in ("service", "scope"))
        url = realm + ("?" + params if params else "")
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read())
        except (OSError, ValueError) as e:
            raise VerificationError(f"token exchange failed: {e}") from e
        token = doc.get("token") or doc.get("access_token") or ""
        if not token:
            raise VerificationError("token endpoint returned no token")
        return token

    # --------------------------------------------------------------- API

    def manifest(self, registry: str, repo: str, ref: str):
        """(manifest dict, digest) for a tag or digest reference."""
        body, headers = self._get(
            registry, f"/v2/{repo}/manifests/{ref}", MANIFEST_ACCEPT)
        # the digest is ALWAYS computed from the returned bytes (what
        # cosign does): trusting Docker-Content-Digest would let a
        # compromised registry claim a signed image's digest while
        # serving different manifest content. The header, when present,
        # is only cross-checked — a mismatch is a registry lying.
        digest = "sha256:" + hashlib.sha256(body).hexdigest()
        claimed = (headers.get("Docker-Content-Digest") or "").strip().lower()
        # only a sha256 claim is comparable; other algorithms (sha512:...)
        # are spec-legal and simply not cross-checked
        if claimed.startswith("sha256:") and claimed != digest:
            raise VerificationError(
                f"registry digest header {claimed} does not match "
                f"manifest content {digest} for {repo}")
        try:
            return json.loads(body), digest
        except ValueError as e:
            raise VerificationError(f"malformed manifest for {repo}") from e

    def blob(self, registry: str, repo: str, digest: str) -> bytes:
        body, _ = self._get(registry, f"/v2/{repo}/blobs/{digest}")
        if ("sha256:" + hashlib.sha256(body).hexdigest()) != digest:
            raise VerificationError(f"blob digest mismatch for {digest}")
        return body


class RegistryVerifier(Verifier):
    """Key-based cosign verification against a live registry.

    Successful verifications cache for ``cache_ttl_s``: admission bursts
    re-verify the same (image, key) pair, and each network verification
    is 2-4 registry round trips inside the webhook budget."""

    def __init__(self, client: RegistryClient | None = None,
                 default_registry: str = "docker.io",
                 cache_ttl_s: float = 60.0):
        self.client = client or RegistryClient()
        self.default_registry = default_registry
        self.cache_ttl_s = cache_ttl_s
        self._cache: dict[tuple, tuple[float, object]] = {}

    # ------------------------------------------------------------ helpers

    def _cached(self, key: tuple):
        hit = self._cache.get(key)
        if hit is not None and hit[0] > time.monotonic():
            return hit[1]
        return None

    def _remember(self, key: tuple, value):
        self._cache[key] = (time.monotonic() + self.cache_ttl_s, value)
        if len(self._cache) > 4096:
            now = time.monotonic()
            self._cache = {k: v for k, v in self._cache.items()
                           if v[0] > now}
        return value

    def _resolve(self, image: str):
        registry, repo, tag, digest = parse_image_ref(
            image, self.default_registry)
        if not digest:
            _, digest = self.client.manifest(registry, repo, tag)
        return registry, repo, digest

    def _cosign_ref(self, registry: str, repo: str, digest: str, suffix: str,
                    repository: str) -> tuple[str, str, str]:
        """(registry, repo, tag) of the cosign object; ``repository``
        overrides the store location (imageVerify's repository field),
        including a cross-registry override."""
        tag = digest.replace("sha256:", "sha256-") + "." + suffix
        if repository:
            rreg, rrepo, _, _ = parse_image_ref(
                repository, self.default_registry)
            return rreg, rrepo, tag
        return registry, repo, tag

    def _load_key(self, key: str):
        if not key or "BEGIN PUBLIC KEY" not in key:
            raise VerificationError(
                "a PEM public key is required (keyless verification "
                "requires a Fulcio/Rekor deployment)")
        try:
            return ecdsa.load_public_key_pem(key)
        except ValueError as e:
            raise VerificationError(f"invalid public key: {e}") from e

    def _layers(self, registry: str, repo: str, tag: str):
        try:
            manifest, _ = self.client.manifest(registry, repo, tag)
        except VerificationError as e:
            raise VerificationError(f"no cosign object at {repo}:{tag} "
                                    f"({e})") from e
        return manifest.get("layers") or []

    # ---------------------------------------------------------------- API

    def verify_signature(self, image: str, key: str = "", repository: str = "",
                         roots: str = "", subject: str = "") -> str:
        """Key-based OR cert-chain ("keyless") verification, mirroring
        the reference's branch (pkg/cosign/cosign.go:80-89: a key uses
        it directly; otherwise Roots become the trust pool and Subject
        the certificate identity check, pkg/engine/imageVerify.go:176).
        A policy must supply one of the two — the hosted Fulcio root
        cosign would default to is not reachable from this engine."""
        cache_key = ("sig", image, key, repository, roots, subject)
        hit = self._cached(cache_key)
        if hit is not None:
            return hit
        if key:
            check_layer = self._key_checker(key)
        elif roots:
            check_layer = self._cert_chain_checker(roots, subject)
        else:
            raise VerificationError(
                "either a public key or trust roots are required "
                "(hosted-Fulcio keyless needs a Fulcio deployment)")
        registry, repo, digest = self._resolve(image)
        sig_reg, sig_repo, sig_tag = self._cosign_ref(
            registry, repo, digest, "sig", repository)

        layers = self._layers(sig_reg, sig_repo, sig_tag)
        if not layers:
            raise VerificationError(f"no signatures found for {image}")
        errors = []
        for layer in layers:
            b64sig = (layer.get("annotations") or {}).get(SIG_ANNOTATION, "")
            if not b64sig:
                continue
            try:
                payload = self.client.blob(
                    sig_reg, sig_repo, layer.get("digest", ""))
                sig = base64.b64decode(b64sig)
            except (VerificationError, ValueError) as e:
                errors.append(str(e))
                continue
            err = check_layer(layer, payload, sig)
            if err:
                errors.append(err)
                continue
            # the payload must bind the digest we resolved (cosign.go:77)
            try:
                bound = (json.loads(payload).get("critical", {})
                         .get("image", {}).get("docker-manifest-digest", ""))
            except ValueError:
                errors.append("malformed signature payload")
                continue
            if bound != digest:
                errors.append(
                    f"payload binds {bound}, manifest digest is {digest}")
                continue
            return self._remember(cache_key, digest)
        raise VerificationError(
            f"no valid signature for {image}: {'; '.join(errors) or 'none'}")

    def _key_checker(self, key: str):
        """Layer check for the bare-public-key path (ECDSA P-256)."""
        pub = self._load_key(key)

        def check(layer, payload: bytes, sig: bytes):
            if not ecdsa.verify(pub, payload, sig):
                return "signature does not match key"
            return None

        return check

    def _cert_chain_checker(self, roots: str, subject: str):
        """Layer check for the cert-chain path: the signature layer's
        certificate chains to the supplied roots, its identity matches
        ``subject`` (when set), and its public key verifies the payload
        (engine/certchain.py; cosign keyless minus the tlog)."""
        from . import certchain

        try:
            root_certs = certchain.load_pem_certs(roots)
        except certchain.CertChainError as e:
            raise VerificationError(f"invalid roots: {e}") from e

        def check(layer, payload: bytes, sig: bytes):
            ann = layer.get("annotations") or {}
            cert_pem = ann.get(certchain.CERT_ANNOTATION, "")
            if not cert_pem:
                return "signature layer carries no certificate"
            try:
                leaf = certchain.load_pem_certs(cert_pem)[0]
                chain = (certchain.load_pem_certs(
                    ann[certchain.CHAIN_ANNOTATION])
                    if ann.get(certchain.CHAIN_ANNOTATION) else [])
                certchain.verify_chain(leaf, chain, root_certs)
            except certchain.CertChainError as e:
                return str(e)
            if subject and not certchain.subject_matches(leaf, subject):
                return (f"certificate identity "
                        f"{certchain.cert_subjects(leaf)} does not match "
                        f"subject {subject!r}")
            if not certchain.verify_payload_signature(leaf, payload, sig):
                return "signature does not match certificate key"
            return None

        return check

    def fetch_attestations(self, image: str, key: str = "",
                           repository: str = "", roots: str = "",
                           subject: str = "") -> list[dict]:
        """DSSE attestation statements, verified with a public key or —
        keyless — with the certificate on each attestation layer (chain
        to ``roots`` + ``subject`` identity), mirroring
        verify_signature's branch."""
        cache_key = ("att", image, key, repository, roots, subject)
        hit = self._cached(cache_key)
        if hit is not None:
            return list(hit)
        if key:
            check_layer = self._key_checker(key)
        elif roots:
            check_layer = self._cert_chain_checker(roots, subject)
        else:
            raise VerificationError(
                "either a public key or trust roots are required "
                "(hosted-Fulcio keyless needs a Fulcio deployment)")
        registry, repo, digest = self._resolve(image)
        att_reg, att_repo, att_tag = self._cosign_ref(
            registry, repo, digest, "att", repository)

        layers = self._layers(att_reg, att_repo, att_tag)
        if not layers:
            raise VerificationError(f"no attestations found for {image}")
        statements = []
        for layer in layers:
            envelope_raw = self.client.blob(
                att_reg, att_repo, layer.get("digest", ""))
            try:
                envelope = json.loads(envelope_raw)
                payload = base64.b64decode(envelope.get("payload", ""))
                pae = dsse_pae(envelope.get("payloadType", ""), payload)
                sigs = [base64.b64decode((s or {}).get("sig", ""))
                        for s in envelope.get("signatures") or []]
            except (ValueError, TypeError) as e:
                raise VerificationError(
                    f"malformed attestation envelope: {e}") from e
            errs = [check_layer(layer, pae, s) for s in sigs]
            if not any(e is None for e in errs):
                raise VerificationError(
                    "attestation signature verification failed for "
                    f"{image}: {'; '.join(e for e in errs if e) or 'no signatures'}")
            try:
                statement = json.loads(payload)
            except ValueError as e:
                raise VerificationError(
                    f"malformed in-toto statement: {e}") from e
            # the statement's subject must bind the image we resolved —
            # without this, a valid attestation from image A replays
            # under image B's .att tag
            if not _subject_binds(statement, digest):
                raise VerificationError(
                    f"attestation subject does not match {image} "
                    f"digest {digest}")
            statements.append(statement)
        self._remember(cache_key, statements)
        return list(statements)


def _subject_binds(statement: dict, digest: str) -> bool:
    """True when an in-toto statement's subject digest matches."""
    want = digest.split(":", 1)[-1]
    for subject in statement.get("subject") or []:
        got = ((subject or {}).get("digest") or {}).get("sha256", "")
        if got == want:
            return True
    return False


def dsse_pae(payload_type: str, payload: bytes) -> bytes:
    """DSSE pre-authentication encoding (the bytes actually signed)."""
    pt = payload_type.encode()
    return (b"DSSEv1 " + str(len(pt)).encode() + b" " + pt
            + b" " + str(len(payload)).encode() + b" " + payload)
