"""verifyImages on both packages: the P-256 ECDSA (``utils/ecdsa``), the
engine (``verify_and_patch_images`` over a ``StaticVerifier``), the
registry verifier (``RegistryVerifier`` against a local registry on
127.0.0.1) and the keyless cert-chain checks (``certchain``).

Every case of tests/unit/test_image_verify.py's engine classes and of
tests/runtime/test_registry_verify.py runs on the JAX package and on the
port with the same inputs, against the same registry stub: the rule
responses (name, type, status, message, patches), the verified digests,
the attestation statements and the verification errors (class name and
text) are equal, and the JAX tests' own expectations hold on the port.
ECDSA signatures are equal byte for byte (RFC 6979 nonces). The JAX
tests' webhook cases wait for the port's webhook; the engine half of
them runs here. The registry stub and the certificate helpers are the
JAX test's own.
"""

import json
import sys
from types import SimpleNamespace

import pytest

import chip_smoke
import kyverno_tpu.engine.certchain as jax_certchain
import kyverno_tpu.engine.image_verify as jax_image_verify
import kyverno_tpu.engine.registry_verify as jax_registry_verify
import kyverno_tpu.utils.ecdsa as jax_ecdsa
import kyverno_tpu_torch.engine.certchain as certchain
import kyverno_tpu_torch.engine.image_verify as image_verify
import kyverno_tpu_torch.engine.registry_verify as registry_verify
import kyverno_tpu_torch.utils.ecdsa as ecdsa
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.engine.context import Context as JaxContext
from kyverno_tpu.engine.policy_context import PolicyContext as JaxPolicyContext
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.engine.context import Context
from kyverno_tpu_torch.engine.policy_context import PolicyContext
from kyverno_tpu_torch.engine.response import RuleStatus
from kyverno_tpu_torch.utils.jsoncopy import json_copy
from tests.runtime.test_registry_verify import (
    RegistryStub,
    _ca_chain,
    _cosign_sign_cert,
    _pem,
)

JAX = SimpleNamespace(load=jax_load_policy, Context=JaxContext,
                      PolicyContext=JaxPolicyContext, iv=jax_image_verify,
                      rv=jax_registry_verify, ecdsa=jax_ecdsa,
                      cc=jax_certchain)
PORT = SimpleNamespace(load=load_policy, Context=Context,
                       PolicyContext=PolicyContext, iv=image_verify,
                       rv=registry_verify, ecdsa=ecdsa, cc=certchain)
DIGEST = "sha256:" + "ab" * 32
# a fixed private key: keys made by generate_keypair() differ per call
PRIV = 0x1D2C3B4A59687766554433221100FFEEDDCCBBAA99887766554433221100AB


def both(fn):
    """``fn(package)`` on each package: the port's result, after holding
    it to the JAX one's. A raised exception is a result too: the same
    class name and text from each package, raised again from the port."""
    out = []
    for k in (PORT, JAX):
        try:
            out.append(("ok", fn(k)))
        except Exception as e:          # compared, then raised again
            out.append(("raised", e))
    (gk, got), (wk, want) = out
    if gk == "raised" or wk == "raised":
        assert (gk, type(got).__name__, str(got)) == \
            (wk, type(want).__name__, str(want))
        raise got
    assert json.dumps(got) == json.dumps(want)
    return got


# ------------------------------------------------------------------ ECDSA

@pytest.mark.parametrize("message", [b"", b"payload", b"x" * 1000,
                                     json.dumps({"critical": {}}).encode()])
def test_ecdsa_signatures_are_the_jax_packages(message):
    sig = both(lambda k: k.ecdsa.sign(PRIV, message).hex())
    pub = both(lambda k: list(k.ecdsa._mul(PRIV, (k.ecdsa.GX, k.ecdsa.GY))))
    pem = both(lambda k: k.ecdsa.public_key_to_pem(tuple(pub)))
    assert both(lambda k: list(k.ecdsa.load_public_key_pem(pem))) == pub
    for k in (PORT, JAX):
        assert k.ecdsa.verify(tuple(pub), message, bytes.fromhex(sig))
        assert not k.ecdsa.verify(tuple(pub), message + b"!",
                                  bytes.fromhex(sig))
        assert not k.ecdsa.verify(tuple(pub), message, b"\x30\x02junk")


def test_ecdsa_der_and_fresh_keys():
    r, s = 2 ** 255 + 7, 12345
    der = both(lambda k: k.ecdsa.der_encode_signature(r, s).hex())
    assert both(lambda k: list(k.ecdsa.der_decode_signature(
        bytes.fromhex(der)))) == [r, s]
    # a key of each package verifies the other's signature
    for a, b in ((PORT, JAX), (JAX, PORT)):
        priv, pub = a.ecdsa.generate_keypair()
        assert b.ecdsa.on_curve(pub)
        assert b.ecdsa.verify(pub, b"m", a.ecdsa.sign(priv, b"m"))
    with pytest.raises(ValueError):
        both(lambda k: k.ecdsa.load_public_key_pem("not a key"))


# --------------------------------------------------- verify_and_patch_images

def verify_policy(image="ghcr.io/acme/*", key="k1", attestations=None,
                  action="enforce", **extra):
    iv = {"image": image, "key": key, **extra}
    if attestations:
        iv["attestations"] = attestations
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "check-images"},
        "spec": {"validationFailureAction": action, "rules": [{
            "name": "verify-signature",
            "match": {"resources": {"kinds": ["Pod"]}},
            "verifyImages": [iv]}]},
    }


def pod(image="ghcr.io/acme/app:v1", name="p", init=None):
    spec = {"containers": [{"name": "c", "image": image}]}
    if init:
        spec["initContainers"] = [{"name": "i", "image": init}]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": spec}


def run(k, policy_doc, resource, verifier):
    ctx = k.Context()
    ctx.add_resource(json_copy(resource))
    ctx.add_image_info(json_copy(resource))
    return k.iv.verify_and_patch_images(
        k.PolicyContext(policy=k.load(json_copy(policy_doc)),
                        new_resource=json_copy(resource), json_context=ctx),
        verifier)


def response_view(resp) -> list:
    pr = resp.policy_response
    return [resp.successful, pr.policy.name,
            pr.policy.validation_failure_action,
            [pr.resource.kind, pr.resource.name, pr.resource.namespace],
            [[r.name, r.type.value, r.status.value, r.message, r.patches]
             for r in pr.rules]]


def static(k, signed=(), statements=()):
    v = k.iv.StaticVerifier()
    for image, digest, key in signed:
        v.sign(image, digest, key=key)
    for image, st in statements:
        v.attest(image, json_copy(st))
    return v


def provenance(level="L3"):
    return {"predicateType": "https://slsa.dev/provenance/v0.2",
            "predicate": {"buildLevel": level, "builder": {"id": "gha"}}}


def attest_policy(conditions):
    return verify_policy(attestations=[{
        "predicateType": "https://slsa.dev/provenance/v0.2",
        "conditions": conditions}])


LEVEL_L3 = {"key": "{{ buildLevel }}", "operator": "Equals", "value": "L3"}
SIGNED_V1 = [("ghcr.io/acme/app:v1", DIGEST, "k1")]
ENGINE_CASES = {
    "signed-gets-digest-patch": (verify_policy(), pod(), SIGNED_V1, (),
                                 [RuleStatus.PASS]),
    "unsigned": (verify_policy(), pod(), (), (), [RuleStatus.FAIL]),
    "wrong-key": (verify_policy(), pod(),
                  [("ghcr.io/acme/app:v1", DIGEST, "other-key")], (),
                  [RuleStatus.FAIL]),
    "digest-not-repatched": (
        verify_policy(), pod(image=f"ghcr.io/acme/app:v1@{DIGEST}"),
        [(f"ghcr.io/acme/app:v1@{DIGEST}", DIGEST, "k1")], (),
        [RuleStatus.PASS]),
    "image-pattern-skips": (verify_policy(image="docker.io/other/*"), pod(),
                            (), (), []),
    "kind-skips": (verify_policy(), {"apiVersion": "v1", "kind": "Service",
                                     "metadata": {"name": "s"}, "spec": {}},
                   (), (), []),
    "init-container": (verify_policy(), pod(init="ghcr.io/acme/init:v2"),
                       SIGNED_V1 + [("ghcr.io/acme/init:v2", DIGEST, "")],
                       (), [RuleStatus.PASS, RuleStatus.PASS]),
    "variable-key": (verify_policy(key="{{ request.object.metadata.name }}"),
                     pod(name="k1"), SIGNED_V1, (), [RuleStatus.PASS]),
    "unresolvable-key": (verify_policy(key="{{ request.object.nope }}"),
                         pod(), SIGNED_V1, (), [RuleStatus.ERROR]),
    "attestation-passes": (attest_policy([{"all": [LEVEL_L3, {
        "key": "{{ builder.id }}", "operator": "Equals", "value": "gha"}]}]),
        pod(), (), [("ghcr.io/acme/app:v1", provenance())],
        [RuleStatus.PASS]),
    "attestation-fails": (attest_policy([{"all": [LEVEL_L3]}]), pod(), (),
                          [("ghcr.io/acme/app:v1", provenance("L1"))],
                          [RuleStatus.FAIL]),
    "attestation-image-object": (attest_policy([{"all": [
        {"key": "{{ image.tag }}", "operator": "Equals", "value": "v1"},
        {"key": "{{ image.registry }}", "operator": "Equals",
         "value": "ghcr.io"}]}]), pod(), (),
        [("ghcr.io/acme/app:v1", provenance())], [RuleStatus.PASS]),
    "attestations-missing": (attest_policy([{"all": [LEVEL_L3]}]), pod(),
                             (), (), [RuleStatus.ERROR]),
    "attestation-bad-predicate": (attest_policy([{"all": [LEVEL_L3]}]),
                                  pod(), (), [("ghcr.io/acme/app:v1", {
                                      "predicateType": "https://slsa.dev/"
                                      "provenance/v0.2", "predicate": 3})],
                                  [RuleStatus.ERROR]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_verify_and_patch_images(case):
    policy_doc, resource, signed, statements, want = ENGINE_CASES[case]
    view = both(lambda k: response_view(run(
        k, policy_doc, resource, static(k, signed, statements))))
    assert [r[2] for r in view[4]] == [s.value for s in want]
    # tests/unit/test_image_verify.py's expectations, on the port
    rules = view[4]
    if case == "signed-gets-digest-patch":
        assert rules[0][4] == [{"op": "replace",
                                "path": "/spec/containers/0/image",
                                "value": f"ghcr.io/acme/app:v1@{DIGEST}"}]
    elif case == "unsigned":
        assert "signature verification failed" in rules[0][3]
    elif case == "digest-not-repatched":
        assert rules[0][4] == []
    elif case == "image-pattern-skips":
        assert view[0] is True
    elif case == "attestation-fails":
        assert "attestation checks failed" in rules[0][3]
    elif case == "attestations-missing":
        assert view[0] is False


def test_json_pointer_to_jmespath():
    for pointer in ("/spec/containers/0/image",
                    "/spec/initContainers/12/image", "/a/b", ""):
        both(lambda k: k.iv.json_pointer_to_jmespath(pointer))
    assert image_verify.json_pointer_to_jmespath(
        "/spec/containers/0/image") == "spec.containers[0].image"


def test_the_base_verifier_refuses():
    for method in ("verify_signature", "fetch_attestations"):
        with pytest.raises(image_verify.VerificationError,
                           match="no image verifier"):
            both(lambda k: getattr(k.iv.Verifier(), method)("img"))


# ---------------------------------------------------------- the registry

@pytest.fixture()
def stub():
    s = RegistryStub()
    host = s.start()
    yield s, host
    s.stop()


@pytest.fixture(scope="module")
def keypair():
    pub = ecdsa._mul(PRIV, (ecdsa.GX, ecdsa.GY))
    return PRIV, ecdsa.public_key_to_pem(pub)


def verifier(k, host, **kw):
    return k.rv.RegistryVerifier(k.rv.RegistryClient(plain_http=True),
                                 default_registry=host, **kw)


@pytest.mark.parametrize("image", [
    "nginx:1.21", "team/app:v1", "ghcr.io/a/b:v2", "localhost:5000/x/y",
    "r.io/a@sha256:" + "0" * 64, "127.0.0.1:5000/a/b:c@sha256:" + "1" * 64,
    "busybox"])
def test_parse_image_ref(image):
    both(lambda k: list(k.rv.parse_image_ref(image)))
    both(lambda k: list(k.rv.parse_image_ref(image, "mirror.io")))
    if image == "nginx:1.21":
        assert registry_verify.parse_image_ref(image) == \
            ("docker.io", "library/nginx", "1.21", "")


def _publish(s, case, priv, host):
    """Push team/app:v1 and publish what ``case`` needs. Returns the
    verify_signature arguments beside the image."""
    digest = s.push_image("team/app", "v1")
    if case == "signed":
        s.cosign_sign("team/app", digest, priv)
    elif case == "wrong-key":
        s.cosign_sign("team/app", digest, priv + 1)
    elif case == "digest-binding":
        s.cosign_sign("team/app", digest, priv,
                      bind_digest="sha256:" + "ab" * 32)
    elif case == "repository-override":
        s.cosign_sign("mirror/sigs", digest, priv)
        return {"repository": f"{host}/mirror/sigs"}
    return {}


@pytest.mark.parametrize("case, match", [
    ("signed", None), ("unsigned", "no cosign object"),
    ("wrong-key", "does not match key"), ("digest-binding", "binds"),
    ("repository-override", None)])
def test_verify_signature(stub, keypair, case, match):
    s, host = stub
    priv, pem = keypair
    extra = _publish(s, case, priv, host)
    call = lambda k: verifier(k, host).verify_signature(  # noqa: E731
        f"{host}/team/app:v1", key=pem, **extra)
    if match is None:
        assert both(call) == s.push_image("team/app", "v1")
    else:
        with pytest.raises(registry_verify.VerificationError, match=match):
            both(call)


def test_cross_registry_override_and_token_auth(keypair):
    priv, pem = keypair
    img, sig, tok = RegistryStub(), RegistryStub(), \
        RegistryStub(require_token=True)
    img_host, sig_host, tok_host = img.start(), sig.start(), tok.start()
    try:
        digest = img.push_image("team/app", "v1")
        sig.push_image("sigs/store", "seed")
        sig.cosign_sign("sigs/store", digest, priv)
        assert both(lambda k: verifier(k, img_host).verify_signature(
            f"{img_host}/team/app:v1", key=pem,
            repository=f"{sig_host}/sigs/store")) == digest
        assert any("sigs/store" in p for p in sig.requests)
        digest = tok.push_image("team/app", "v1")
        tok.cosign_sign("team/app", digest, priv)
        assert both(lambda k: verifier(k, tok_host).verify_signature(
            f"{tok_host}/team/app:v1", key=pem)) == digest
        assert any(p.startswith("/token") for p in tok.requests)
    finally:
        for x in (img, sig, tok):
            x.stop()


def test_cache_takes_repeats_and_expires_on_its_clock(stub, keypair,
                                                      monkeypatch):
    """A repeat within the TTL makes no registry request in either
    package; the port's cache expires on a stand-in for ``time``, so no
    case here reads the wall clock."""
    s, host = stub
    priv, pem = keypair
    digest = s.push_image("team/app", "v1")
    s.cosign_sign("team/app", digest, priv)
    now = [100.0]
    monkeypatch.setattr(registry_verify, "time",
                        SimpleNamespace(monotonic=lambda: now[0]))
    port_v = verifier(PORT, host, cache_ttl_s=60.0)
    jax_v = verifier(JAX, host)
    image = f"{host}/team/app:v1"
    for v in (port_v, jax_v):
        assert v.verify_signature(image, key=pem) == digest
        before = len(s.requests)
        assert v.verify_signature(image, key=pem) == digest
        assert len(s.requests) == before
    now[0] += 59.0
    before = len(s.requests)
    assert port_v.verify_signature(image, key=pem) == digest
    assert len(s.requests) == before
    now[0] += 2.0                       # past the TTL: to the registry again
    assert port_v.verify_signature(image, key=pem) == digest
    assert len(s.requests) > before
    # attestations cache the same way
    s.cosign_attest("team/app", digest, priv,
                    {"predicateType": "t", "predicate": {"a": 1}})
    first = port_v.fetch_attestations(image, key=pem)
    before = len(s.requests)
    assert port_v.fetch_attestations(image, key=pem) == first
    assert len(s.requests) == before
    # a failure is not cached
    s.push_image("team/other", "v1")
    for _ in range(2):
        with pytest.raises(registry_verify.VerificationError):
            port_v.verify_signature(f"{host}/team/other:v1", key=pem)


def test_default_clock_keeps_the_jax_ttl(stub, keypair):
    s, host = stub
    priv, pem = keypair
    digest = s.push_image("team/app", "v1")
    s.cosign_sign("team/app", digest, priv)
    v = verifier(PORT, host, cache_ttl_s=0.0)
    assert v.verify_signature(f"{host}/team/app:v1", key=pem) == digest
    before = len(s.requests)
    assert v.verify_signature(f"{host}/team/app:v1", key=pem) == digest
    assert len(s.requests) > before     # a TTL of 0 caches nothing


@pytest.mark.parametrize("case, match", [
    ("fetch", None), ("replayed", "subject does not"),
    ("bad-envelope-signature", "attestation signature")])
def test_fetch_attestations(stub, keypair, case, match):
    s, host = stub
    priv, pem = keypair
    digest = s.push_image("team/app", "v1")
    stmt = {"predicateType": "https://slsa.dev/provenance/v0.2",
            "predicate": {"builder": {"id": "ci"}}}
    image = f"{host}/team/app:v1"
    if case == "fetch":
        s.cosign_attest("team/app", digest, priv, stmt)
    elif case == "replayed":
        other = s.push_image("team/other", "v1")
        stmt = dict(stmt, subject=[{"name": "team/app", "digest": {
            "sha256": digest.split(":", 1)[-1]}}])
        s.cosign_attest("team/other", other, priv, stmt, bind_subject=False)
        image = f"{host}/team/other:v1"
    else:
        s.cosign_attest("team/app", digest, priv + 1, stmt)
    call = lambda k: verifier(k, host).fetch_attestations(  # noqa: E731
        image, key=pem)
    if match is None:
        out = both(call)
        assert len(out) == 1 and out[0]["predicate"] == stmt["predicate"]
        assert out[0]["subject"][0]["digest"]["sha256"] == \
            digest.split(":", 1)[-1]
    else:
        with pytest.raises(registry_verify.VerificationError, match=match):
            both(call)


def test_dsse_pae():
    for ptype, payload in (("application/vnd.in-toto+json", b"{}"),
                           ("", b""), ("t", b"x" * 300)):
        both(lambda k: k.rv.dsse_pae(ptype, payload).hex())


def test_engine_over_the_registry(stub, keypair):
    """The engine half of the JAX tests' webhook case: a signed image is
    patched to its digest, an unsigned one fails, a forged signature
    fails; the same responses from each package."""
    s, host = stub
    priv, pem = keypair
    digest = s.push_image("team/app", "v1")
    s.cosign_sign("team/app", digest, priv)
    s.push_image("team/rogue", "v1")
    forged = s.push_image("team/forged", "v1")
    s.cosign_sign("team/forged", forged, priv + 1)
    policy_doc = verify_policy(image=f"{host}/team/*", key=pem)
    out = {}
    for name in ("app", "rogue", "forged"):
        out[name] = both(lambda k: response_view(run(
            k, policy_doc, pod(image=f"{host}/team/{name}:v1"),
            verifier(k, host))))
    [[_, _, status, _, patches]] = out["app"][4]
    assert status == "pass" and patches[0]["value"] == \
        f"{host}/team/app:v1@{digest}"
    for name in ("rogue", "forged"):
        [[_, _, status, msg, _]] = out[name][4]
        assert status == "fail" and "signature verification failed" in msg


# ------------------------------------------------------- keyless chains

def _cert_case(s, case):
    """Publish team/app:v1 signed as ``case`` needs; the roots and
    subject to verify with."""
    root, inter, leaf, leaf_key = _ca_chain(
        leaf_days=-1 if case == "expired-leaf" else 365)
    digest = s.push_image("team/app", "v1")
    roots, subject = _pem(root), "dev@example.com"
    if case == "no-cert":
        s.cosign_sign("team/app", digest, PRIV)
    elif case == "wrong-key":
        from cryptography.hazmat.primitives.asymmetric import ec

        rogue = ec.generate_private_key(ec.SECP256R1())
        _cosign_sign_cert(s, "team/app", digest, rogue, leaf, inter)
    elif case == "tampered-binding":
        _cosign_sign_cert(s, "team/app", digest, leaf_key, leaf, inter,
                          bind_digest="sha256:" + "0" * 64)
    elif case != "no-key-no-roots":
        _cosign_sign_cert(s, "team/app", digest, leaf_key, leaf, inter)
    if case == "subject-wildcard":
        subject = "*@example.com"
    elif case == "wrong-subject":
        subject = "ops@example.com"
    elif case == "untrusted-root":
        roots = _pem(_ca_chain()[0])
    elif case == "no-key-no-roots":
        roots = ""
    return digest, roots, subject


@pytest.mark.parametrize("case, match", [
    ("signed", None), ("subject-wildcard", None),
    ("wrong-subject", "does not match subject"),
    ("untrusted-root", "does not terminate at a trusted root"),
    ("expired-leaf", "validity window"),
    ("wrong-key", "does not match certificate key"),
    ("no-cert", "no certificate"),
    ("no-key-no-roots", "public key or trust"),
    ("tampered-binding", "binds")])
def test_cert_chain_verification(stub, case, match):
    s, host = stub
    digest, roots, subject = _cert_case(s, case)
    call = lambda k: verifier(k, host).verify_signature(  # noqa: E731
        "team/app:v1", roots=roots, subject=subject)
    if match is None:
        assert both(call) == digest
    else:
        with pytest.raises(registry_verify.VerificationError, match=match):
            both(call)


def test_cert_chain_hardening():
    """A non-CA leaf cannot issue, and an unvalidated CN never matches
    when SANs exist, in both packages on the same certificates."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    root, inter, atk_leaf, atk_key = _ca_chain(
        leaf_san="attacker@example.com")
    now = datetime.datetime.now(datetime.timezone.utc)
    rogue_key = ec.generate_private_key(ec.SECP256R1())
    rogue = (x509.CertificateBuilder()
             .subject_name(x509.Name([x509.NameAttribute(
                 NameOID.COMMON_NAME, "rogue")]))
             .issuer_name(atk_leaf.subject)
             .public_key(rogue_key.public_key())
             .serial_number(x509.random_serial_number())
             .not_valid_before(now - datetime.timedelta(days=1))
             .not_valid_after(now + datetime.timedelta(days=30))
             .add_extension(x509.SubjectAlternativeName(
                 [x509.RFC822Name("dev@example.com")]), critical=False)
             .sign(atk_key, hashes.SHA256()))
    with pytest.raises(certchain.CertChainError,
                       match="does not terminate at a trusted root"):
        both(lambda k: k.cc.verify_chain(rogue, [atk_leaf, inter], [root]))
    assert both(lambda k: k.cc.verify_chain(atk_leaf, [inter], [root])) \
        is None
    assert both(lambda k: k.cc.verify_chain(root, [], [root])) is None
    _, _, leaf, _ = _ca_chain(leaf_san="attacker@evil.io")
    assert both(lambda k: k.cc.cert_subjects(leaf)) == ["attacker@evil.io"]
    assert both(lambda k: k.cc.subject_matches(leaf, "signer")) is False
    assert both(lambda k: k.cc.subject_matches(leaf, "*@evil.io")) is True
    with pytest.raises(certchain.CertChainError, match="no trust roots"):
        both(lambda k: k.cc.verify_chain(leaf, [], []))
    for bad in ("garbage", ""):
        with pytest.raises(certchain.CertChainError):
            both(lambda k: k.cc.load_pem_certs(bad))


def test_keyless_attestations(stub):
    import base64

    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    s, host = stub
    root, inter, leaf, leaf_key = _ca_chain()
    digest = s.push_image("team/app", "v1")
    statement = {"predicateType": "https://slsa.dev/provenance/v1",
                 "predicate": {"builder": {"id": "ci"}},
                 "subject": [{"name": "team/app", "digest": {
                     "sha256": digest.split(":", 1)[-1]}}]}
    payload = json.dumps(statement).encode()
    ptype = "application/vnd.in-toto+json"
    sig = base64.b64encode(leaf_key.sign(
        registry_verify.dsse_pae(ptype, payload),
        ec.ECDSA(hashes.SHA256()))).decode()
    envelope = json.dumps({"payloadType": ptype,
                           "payload": base64.b64encode(payload).decode(),
                           "signatures": [{"sig": sig}]}).encode()
    blob = s.put_blob("team/app", envelope)
    s.put_manifest("team/app", digest.replace("sha256:", "sha256-") + ".att",
                   {"schemaVersion": 2, "layers": [{
                       "digest": blob, "size": len(envelope),
                       "annotations": {
                           certchain.CERT_ANNOTATION: _pem(leaf),
                           certchain.CHAIN_ANNOTATION: _pem(inter)}}]})
    out = both(lambda k: verifier(k, host).fetch_attestations(
        "team/app:v1", roots=_pem(root), subject="dev@example.com"))
    assert out and out[0]["predicateType"].startswith("https://slsa")
    with pytest.raises(registry_verify.VerificationError):
        both(lambda k: verifier(k, host).fetch_attestations(
            "team/app:v1", roots=_pem(root), subject="ops@example.com"))


def test_no_cryptography_raises_as_the_jax_package_does(stub, monkeypatch):
    """Where ``cryptography`` cannot be imported, the keyless path raises
    the same ImportError from each package (never a pass), and the
    key-based path does not need it."""
    s, host = stub
    digest, roots, subject = _cert_case(s, "signed")
    s.cosign_sign("team/app", digest, PRIV)
    pem = ecdsa.public_key_to_pem(ecdsa._mul(PRIV, (ecdsa.GX, ecdsa.GY)))
    monkeypatch.setitem(sys.modules, "cryptography", None)
    with pytest.raises(ImportError, match="cryptography"):
        both(lambda k: verifier(k, host).verify_signature(
            "team/app:v1", roots=roots, subject=subject))
    with pytest.raises(ImportError, match="cryptography"):
        both(lambda k: k.cc.load_pem_certs(roots))
    assert both(lambda k: verifier(k, host).verify_signature(
        "team/app:v1", key=pem)) == digest


def test_chip_smoke_actions_phase_on_the_cpu():
    """chip_smoke.py's ``[actions]`` at a small size: it needs no card, so
    its checks run here as they run on the card's machine."""
    out = chip_smoke.actions_phase(n_pods=48, n_namespaces=24)
    assert [out["requests"][f"team/app{j}"] for j in range(6)] == [3] * 6
    assert out["requests"]["team/app7"] == 2 * 6    # no signature: asked again
