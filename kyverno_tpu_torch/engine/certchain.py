"""X.509 certificate-chain verification for keyless cosign signatures.

The reference's keyless path (pkg/cosign/cosign.go:88-89: no ``key``
means ``CertEmail = Subject`` + ``RootCerts = getX509CertPool(Roots)``)
trusts the certificate cosign attached to the signature layer
(``dev.sigstore.cosign/certificate`` / ``.../chain`` annotations): the
chain must verify up to one of the policy-supplied roots, the leaf's
SAN must match the policy subject, and the payload signature must
verify with the leaf's public key.

Built on the ``cryptography`` package (in-image) for ASN.1/X.509 —
hand-rolling certificate parsing would be a correctness hazard; the
bare-public-key path keeps the self-contained ECDSA in utils/ecdsa.py.

Expired certificates fail closed: cosign accepts an expired Fulcio leaf
only when a transparency-log timestamp proves signing time, and no tlog
integration exists here, so validity is checked against the wall clock.
"""

from __future__ import annotations

from datetime import datetime, timezone

CERT_ANNOTATION = "dev.sigstore.cosign/certificate"
CHAIN_ANNOTATION = "dev.sigstore.cosign/chain"


class CertChainError(Exception):
    pass


def load_pem_certs(pem: str):
    """PEM bundle -> [Certificate]; raises CertChainError on garbage."""
    from cryptography import x509

    data = pem.encode() if isinstance(pem, str) else pem
    try:
        certs = x509.load_pem_x509_certificates(data)
    except ValueError as e:
        raise CertChainError(f"invalid PEM certificate data: {e}") from e
    if not certs:
        raise CertChainError("no certificates in PEM data")
    return certs


def _check_validity(cert, now: datetime, what: str) -> None:
    nvb = cert.not_valid_before_utc
    nva = cert.not_valid_after_utc
    if now < nvb or now > nva:
        raise CertChainError(
            f"{what} certificate is outside its validity window "
            f"({nvb.isoformat()} .. {nva.isoformat()})")


def _issued_by(child, issuer) -> bool:
    try:
        child.verify_directly_issued_by(issuer)
        return True
    except Exception:
        return False


def _is_ca(cert) -> bool:
    """True when the certificate may issue others: BasicConstraints
    CA=true (absent -> NOT a CA, RFC 5280) and, when KeyUsage is
    present, keyCertSign. verify_directly_issued_by checks only
    name-chaining + signature — without this gate any end-entity cert
    under a trusted root could mint arbitrary identities."""
    from cryptography import x509

    try:
        bc = cert.extensions.get_extension_for_class(
            x509.BasicConstraints).value
        if not bc.ca:
            return False
    except x509.ExtensionNotFound:
        return False
    try:
        ku = cert.extensions.get_extension_for_class(x509.KeyUsage).value
        if not ku.key_cert_sign:
            return False
    except x509.ExtensionNotFound:
        pass
    return True


def verify_chain(leaf, intermediates, roots, now: datetime | None = None) -> None:
    """Verify ``leaf`` chains to one of ``roots`` through (a subset of)
    ``intermediates`` — name chaining + signature at every link, validity
    at every node (getX509CertPool + cosign's chain build). Raises."""
    if not roots:
        raise CertChainError("no trust roots supplied")
    now = now or datetime.now(timezone.utc)
    _check_validity(leaf, now, "leaf")

    current = leaf
    pool = list(intermediates)
    # leaf may itself BE a trusted root (pinned cert in the trust store)
    if any(current == r for r in roots):
        return
    for _ in range(len(pool) + 1):
        for root in roots:
            if _is_ca(root) and _issued_by(current, root):
                _check_validity(root, now, "root")
                return
        for cand in pool:
            if _is_ca(cand) and _issued_by(current, cand):
                _check_validity(cand, now, "intermediate")
                current = cand
                pool.remove(cand)
                break
        else:
            raise CertChainError(
                "certificate chain does not terminate at a trusted root")
    raise CertChainError(
        "certificate chain does not terminate at a trusted root")


def cert_subjects(cert) -> list[str]:
    """The identities a cosign subject check can match: email SANs and
    URI SANs (Fulcio puts the OIDC identity in one of these). The
    subject common name is a fallback ONLY when the cert carries no SAN
    identities — CAs validate SANs, not CNs, so a cert with SANs must
    never match through an unvalidated CN."""
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    out: list[str] = []
    try:
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        out += san.get_values_for_type(x509.RFC822Name)
        out += san.get_values_for_type(x509.UniformResourceIdentifier)
    except x509.ExtensionNotFound:
        pass
    if not out:
        for attr in cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME):
            value = attr.value
            out.append(value.decode() if isinstance(value, bytes) else value)
    return out


def subject_matches(cert, subject: str) -> bool:
    """cosign CertEmail equality, widened to the minio wildcard dialect
    the engine uses everywhere else (``*``/``?``), over every identity
    the certificate carries."""
    from ..utils.wildcard import wildcard_match

    return any(wildcard_match(subject, ident)
               for ident in cert_subjects(cert))


def verify_payload_signature(cert, payload: bytes, signature: bytes) -> bool:
    """Verify ``signature`` over ``payload`` with the certificate's
    public key (cosign signs SimpleSigning payloads with SHA-256)."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, ed25519, padding, rsa

    key = cert.public_key()
    try:
        if isinstance(key, ec.EllipticCurvePublicKey):
            key.verify(signature, payload, ec.ECDSA(hashes.SHA256()))
        elif isinstance(key, rsa.RSAPublicKey):
            key.verify(signature, payload, padding.PKCS1v15(),
                       hashes.SHA256())
        elif isinstance(key, ed25519.Ed25519PublicKey):
            key.verify(signature, payload)
        else:
            return False
        return True
    except InvalidSignature:
        return False
