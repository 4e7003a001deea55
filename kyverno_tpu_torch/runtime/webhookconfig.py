"""Webhook configuration CRUD + self-healing monitor + cert management.

Mirrors kyverno/pkg/webhookconfig: Register creates/checks/removes
the five Mutating/ValidatingWebhookConfiguration objects
(registration.go:273-542) with optional per-policy narrowing
(configmanager.go); Monitor records the last admission timestamp and
re-registers webhooks + renews certs after idleDeadline
(monitor.go:16-40); CertRenewer mirrors pkg/tls (self-signed CA + TLS pair
stored as Secrets, renewed before expiry) using the ``openssl`` binary.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import time

# monitor.go:17-20
TICKER_INTERVAL_S = 30.0
IDLE_CHECK_INTERVAL_S = 60.0
IDLE_DEADLINE_S = IDLE_CHECK_INTERVAL_S * 5
# configmanager.go:33
DEFAULT_WEBHOOK_TIMEOUT_S = 10

MUTATING_WEBHOOK_CONFIG = "kyverno-resource-mutating-webhook-cfg"
VALIDATING_WEBHOOK_CONFIG = "kyverno-resource-validating-webhook-cfg"
POLICY_VALIDATING_WEBHOOK_CONFIG = "kyverno-policy-validating-webhook-cfg"
POLICY_MUTATING_WEBHOOK_CONFIG = "kyverno-policy-mutating-webhook-cfg"
VERIFY_MUTATING_WEBHOOK_CONFIG = "kyverno-verify-mutating-webhook-cfg"


def _webhook_config(kind: str, name: str, path: str, rules: list[dict],
                    ca_bundle: str, service_namespace: str, service_name: str,
                    failure_policy: str = "Fail",
                    timeout_s: int = DEFAULT_WEBHOOK_TIMEOUT_S) -> dict:
    return {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": kind,
        "metadata": {"name": name},
        "webhooks": [{
            "name": f"{name}.kyverno.svc",
            "clientConfig": {
                "service": {
                    "namespace": service_namespace,
                    "name": service_name,
                    "path": path,
                },
                "caBundle": ca_bundle,
            },
            "rules": rules,
            "failurePolicy": failure_policy,
            "timeoutSeconds": timeout_s,
            "sideEffects": "NoneOnDryRun",
            "admissionReviewVersions": ["v1"],
        }],
    }


_ALL_RESOURCES_RULE = [{
    "apiGroups": ["*"], "apiVersions": ["*"], "resources": ["*/*"],
    "operations": ["CREATE", "UPDATE", "DELETE", "CONNECT"],
}]
_POLICY_RULE = [{
    "apiGroups": ["kyverno.io"], "apiVersions": ["*"],
    "resources": ["clusterpolicies/*", "policies/*"],
    "operations": ["CREATE", "UPDATE"],
}]


class Register:
    """registration.go Register: webhook configuration lifecycle."""

    def __init__(self, client, ca_bundle: str = "",
                 service_namespace: str = "kyverno",
                 service_name: str = "kyverno-svc",
                 timeout_s: int = 0,
                 default_failure_policy: str = ""):
        from . import featureplane

        self.client = client
        self.ca_bundle = ca_bundle
        self.service_namespace = service_namespace
        self.service_name = service_name
        # deployment knobs (Helm webhooks.* -> env). Validated here: a
        # malformed value must degrade to the safe default with a warning,
        # not crash-loop the controller or register an API-invalid config
        import logging

        log = logging.getLogger("kyverno.webhookconfig")
        if not timeout_s:
            raw = featureplane.raw("KTPU_WEBHOOK_TIMEOUT_S")
            try:
                timeout_s = int(raw) if raw else DEFAULT_WEBHOOK_TIMEOUT_S
            except ValueError:
                log.warning("invalid KTPU_WEBHOOK_TIMEOUT_S=%r; using %ss",
                            raw, DEFAULT_WEBHOOK_TIMEOUT_S)
                timeout_s = DEFAULT_WEBHOOK_TIMEOUT_S
        # admissionregistration accepts 1..30 only
        self.timeout_s = min(30, max(1, timeout_s))
        # the catch-all resource webhooks default to Ignore like the
        # reference's; Fail closes the cluster on controller outage
        fp = (default_failure_policy
              or featureplane.raw("KTPU_DEFAULT_FAILURE_POLICY")
              or "Ignore").capitalize()
        if fp not in ("Ignore", "Fail"):
            log.warning("invalid failurePolicy %r; using Ignore", fp)
            fp = "Ignore"
        self.default_failure_policy = fp

    def _configs(self) -> list[dict]:
        mk = _webhook_config
        args = dict(ca_bundle=self.ca_bundle,
                    service_namespace=self.service_namespace,
                    service_name=self.service_name, timeout_s=self.timeout_s)
        return [
            mk("MutatingWebhookConfiguration", MUTATING_WEBHOOK_CONFIG,
               "/mutate", _ALL_RESOURCES_RULE,
               failure_policy=self.default_failure_policy, **args),
            mk("ValidatingWebhookConfiguration", VALIDATING_WEBHOOK_CONFIG,
               "/validate", _ALL_RESOURCES_RULE,
               failure_policy=self.default_failure_policy, **args),
            mk("ValidatingWebhookConfiguration", POLICY_VALIDATING_WEBHOOK_CONFIG,
               "/policyvalidate", _POLICY_RULE, **args),
            mk("MutatingWebhookConfiguration", POLICY_MUTATING_WEBHOOK_CONFIG,
               "/policymutate", _POLICY_RULE, **args),
            mk("MutatingWebhookConfiguration", VERIFY_MUTATING_WEBHOOK_CONFIG,
               "/verifymutate", _POLICY_RULE, **args),
        ]

    def register(self) -> None:
        """registration.go:88 Register."""
        for config in self._configs():
            meta = config["metadata"]
            existing = self.client.get_resource(
                config["apiVersion"], config["kind"], "", meta["name"])
            if existing is None:
                self.client.create_resource(config)
            else:
                self.client.update_resource(config)

    def check(self) -> bool:
        """registration.go:135 Check: all five configs exist."""
        for config in self._configs():
            if self.client.get_resource(
                config["apiVersion"], config["kind"], "", config["metadata"]["name"]
            ) is None:
                return False
        return True

    def remove(self) -> None:
        """registration.go:163 Remove."""
        for config in self._configs():
            self.client.delete_resource(
                config["apiVersion"], config["kind"], "", config["metadata"]["name"])


# ---------------------------------------------------------------- narrowing

# configmanager.go:693-704: *Options kinds map to fixed subresource GVRs
_OPTIONS_GVR = {
    "NodeProxyOptions": ("", "v1", "nodes/proxy"),
    "PodAttachOptions": ("", "v1", "pods/attach"),
    "PodExecOptions": ("", "v1", "pods/exec"),
    "PodPortForwardOptions": ("", "v1", "pods/portforward"),
    "PodProxyOptions": ("", "v1", "pods/proxy"),
    "ServiceProxyOptions": ("", "v1", "services/proxy"),
}

# core/common kinds -> (group, version, resource); the reference resolves
# these via the discovery client (configmanager.go:706 FindResource) — a
# static table plus regular pluralization stands in for discovery here
_KNOWN_GVR = {
    "Pod": ("", "v1", "pods"),
    "Service": ("", "v1", "services"),
    "ConfigMap": ("", "v1", "configmaps"),
    "Secret": ("", "v1", "secrets"),
    "Namespace": ("", "v1", "namespaces"),
    "Node": ("", "v1", "nodes"),
    "ServiceAccount": ("", "v1", "serviceaccounts"),
    "PersistentVolume": ("", "v1", "persistentvolumes"),
    "PersistentVolumeClaim": ("", "v1", "persistentvolumeclaims"),
    "Endpoints": ("", "v1", "endpoints"),
    "LimitRange": ("", "v1", "limitranges"),
    "ResourceQuota": ("", "v1", "resourcequotas"),
    "Deployment": ("apps", "v1", "deployments"),
    "DaemonSet": ("apps", "v1", "daemonsets"),
    "StatefulSet": ("apps", "v1", "statefulsets"),
    "ReplicaSet": ("apps", "v1", "replicasets"),
    "Job": ("batch", "v1", "jobs"),
    "CronJob": ("batch", "v1", "cronjobs"),
    "Ingress": ("networking.k8s.io", "v1", "ingresses"),
    "NetworkPolicy": ("networking.k8s.io", "v1", "networkpolicies"),
    "HorizontalPodAutoscaler": ("autoscaling", "v1", "horizontalpodautoscalers"),
    "PodDisruptionBudget": ("policy", "v1", "poddisruptionbudgets"),
    "Role": ("rbac.authorization.k8s.io", "v1", "roles"),
    "RoleBinding": ("rbac.authorization.k8s.io", "v1", "rolebindings"),
    "ClusterRole": ("rbac.authorization.k8s.io", "v1", "clusterroles"),
    "ClusterRoleBinding": ("rbac.authorization.k8s.io", "v1", "clusterrolebindings"),
}


def _pluralize(kind: str) -> str:
    k = kind.lower()
    if k.endswith(("s", "x", "z", "ch", "sh")):
        return k + "es"
    if k.endswith("y") and k[-2:-1] not in "aeiou":
        return k[:-1] + "ies"
    return k + "s"


def _gvk_to_gvr(gvk: str) -> tuple[str, str, str]:
    """GVK string (Kind / version/Kind / group/version/Kind) -> GVR tuple."""
    parts = gvk.split("/")
    kind = parts[-1]
    if kind in _OPTIONS_GVR:
        return _OPTIONS_GVR[kind]
    if len(parts) == 3:
        group, version = parts[0], parts[1]
    elif len(parts) == 2:
        group, version = "", parts[0]
    else:
        group, version = "", "*"
    if kind in _KNOWN_GVR:
        known = _KNOWN_GVR[kind]
        if len(parts) == 1:
            return known
        return (group if len(parts) == 3 else known[0], version, known[2])
    return (group, version, _pluralize(kind))


def _match_kinds(rule) -> list[str]:
    return rule.match_kinds()


def _dedup(items: list[str]) -> list[str]:
    seen: dict[str, None] = {}
    for x in items:
        seen.setdefault(x)
    return list(seen)


class _NarrowedWebhook:
    """configmanager.go:455 webhook: GVK aggregation per (kind, failurePolicy)."""

    def __init__(self, kind: str, failure_policy: str):
        self.kind = kind
        self.failure_policy = failure_policy
        self.max_timeout = DEFAULT_WEBHOOK_TIMEOUT_S
        self.groups: list[str] = []
        self.versions: list[str] = []
        self.resources: list[str] = []

    def set_wildcard(self) -> None:
        self.groups, self.versions, self.resources = ["*"], ["*"], ["*/*"]

    def merge(self, policy, update_validate: bool) -> None:
        """configmanager.go:667 mergeWebhook."""
        matched: list[str] = []
        for rule in policy.spec.rules:
            if rule.has_generate():
                # generate kinds land in both webhooks (configmanager.go:671)
                matched.extend(_match_kinds(rule))
                if rule.generation.kind:
                    matched.append(rule.generation.kind)
                continue
            if ((update_validate and rule.has_validate())
                    or (not update_validate
                        and (rule.has_mutate() or rule.has_verify_images()))):
                matched.extend(_match_kinds(rule))
        for gvk in _dedup(matched):
            g, v, r = _gvk_to_gvr(gvk)
            self.groups.append(g)
            self.versions.append(v)
            self.resources.append(r)
        self.groups = _dedup(self.groups)
        self.versions = _dedup(self.versions)
        self.resources = _dedup(self.resources)
        t = policy.spec.webhook_timeout_seconds
        if t is not None and t > self.max_timeout:
            self.max_timeout = t

    def rule(self) -> dict | None:
        if not self.resources:
            return None
        return {
            "apiGroups": self.groups,
            "apiVersions": self.versions,
            "resources": self.resources,
            "operations": ["CREATE", "UPDATE", "DELETE", "CONNECT"],
        }


class WebhookConfigManager:
    """configmanager.go:84 webhookConfigManager: recomputes the resource
    webhook rule lists (mutate/validate x Ignore/Fail variants) from the
    live policy set and rewrites the two resource configurations. Driven
    by policy add/update/delete (sync(), the informer handlers of
    configmanager.go:129-150)."""

    def __init__(self, client, register: Register):
        self.client = client
        self.register = register
        self._lock = threading.Lock()

    def build_webhooks(self, policies) -> list[_NarrowedWebhook]:
        """configmanager.go:465 buildWebhooks."""
        mutate_ignore = _NarrowedWebhook("Mutating", "Ignore")
        mutate_fail = _NarrowedWebhook("Mutating", "Fail")
        validate_ignore = _NarrowedWebhook("Validating", "Ignore")
        validate_fail = _NarrowedWebhook("Validating", "Fail")
        out = [mutate_ignore, mutate_fail, validate_ignore, validate_fail]

        if any("*" in _match_kinds(r) for p in policies for r in p.spec.rules):
            for w in out:
                w.set_wildcard()
            return out

        for p in policies:
            has_validate = any(r.has_validate() for r in p.spec.rules)
            has_generate = any(r.has_generate() for r in p.spec.rules)
            has_mutate = any(r.has_mutate() for r in p.spec.rules)
            has_verify = any(r.has_verify_images() for r in p.spec.rules)
            ignore = p.spec.failure_policy == "Ignore"
            if has_validate or has_generate:
                (validate_ignore if ignore else validate_fail).merge(p, True)
            if has_mutate or has_verify or has_generate:
                (mutate_ignore if ignore else mutate_fail).merge(p, False)
        return out

    def sync(self, policies) -> None:
        """Recompute and write both resource webhook configs
        (configmanager.go:508 updateWebhookConfig)."""
        with self._lock:
            webhooks = self.build_webhooks(policies)
            self._update_config(
                "MutatingWebhookConfiguration", MUTATING_WEBHOOK_CONFIG,
                "/mutate", [w for w in webhooks if w.kind == "Mutating"])
            self._update_config(
                "ValidatingWebhookConfiguration", VALIDATING_WEBHOOK_CONFIG,
                "/validate", [w for w in webhooks if w.kind == "Validating"])

    def _update_config(self, kind: str, name: str, path: str,
                       webhooks) -> None:
        reg = self.register
        entries = []
        for w in webhooks:
            rule = w.rule()
            if rule is None:
                continue
            suffix = "ignore" if w.failure_policy == "Ignore" else "fail"
            entries.append({
                "name": f"{name}-{suffix}.kyverno.svc",
                "clientConfig": {
                    "service": {
                        "namespace": reg.service_namespace,
                        "name": reg.service_name,
                        "path": path,
                    },
                    "caBundle": reg.ca_bundle,
                },
                "rules": [rule],
                "failurePolicy": w.failure_policy,
                "timeoutSeconds": w.max_timeout,
                "sideEffects": "NoneOnDryRun",
                "admissionReviewVersions": ["v1"],
            })
        config = {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": kind,
            "metadata": {"name": name},
            "webhooks": entries,
        }
        existing = self.client.get_resource(
            config["apiVersion"], kind, "", name)
        if existing is None:
            self.client.create_resource(config)
        else:
            self.client.update_resource(config)


class Monitor:
    """monitor.go:41 Monitor: the webhook failure detector."""

    def __init__(self, register: Register, cert_renewer=None):
        self.register = register
        self.cert_renewer = cert_renewer
        self._lock = threading.RLock()
        self._last_seen = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.forced_probes = 0
        self.re_registrations = 0

    def set_time(self, t: float | None = None) -> None:
        with self._lock:
            self._last_seen = t if t is not None else time.monotonic()

    def time(self) -> float:
        with self._lock:
            return self._last_seen

    def check_once(self, probe=None) -> None:
        """One tick of monitor.go:76 Run: idle => force probe; dead =>
        delete + re-register webhooks and renew certs."""
        idle = time.monotonic() - self.time()
        if idle > IDLE_DEADLINE_S:
            self.re_registrations += 1
            if self.cert_renewer is not None:
                try:
                    self.cert_renewer.renew()
                except Exception:
                    pass
            self.register.remove()
            self.register.register()
            self.set_time()
        elif idle > IDLE_CHECK_INTERVAL_S:
            self.forced_probes += 1
            if probe is not None:
                probe()  # no-op admission request through /verifymutate
        if not self.register.check():
            self.register.register()

    def run(self, probe=None, interval_s: float = TICKER_INTERVAL_S) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.check_once(probe)
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, name="webhook-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class CertRenewer:
    """pkg/tls certRenewer: self-signed CA + server pair via openssl,
    stored as Secrets through the client; renewable."""

    CERT_VALIDITY_DAYS = 365

    def __init__(self, client=None, service_name: str = "kyverno-svc",
                 namespace: str = "kyverno", workdir: str | None = None):
        self.client = client
        self.service_name = service_name
        self.namespace = namespace
        self.workdir = workdir or tempfile.mkdtemp(prefix="kyverno-tls-")
        self.cert_file = os.path.join(self.workdir, "tls.crt")
        self.key_file = os.path.join(self.workdir, "tls.key")
        self.ca_file = os.path.join(self.workdir, "ca.crt")

    def generate(self) -> bool:
        """InitTLSPemPair: CA + server cert with the service SANs."""
        try:
            ca_key = os.path.join(self.workdir, "ca.key")
            cn = f"{self.service_name}.{self.namespace}.svc"
            subprocess.run(
                ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                 "-keyout", ca_key, "-out", self.ca_file,
                 "-days", str(self.CERT_VALIDITY_DAYS),
                 "-subj", "/CN=kyverno-ca"],
                check=True, capture_output=True)
            csr = os.path.join(self.workdir, "server.csr")
            subprocess.run(
                ["openssl", "req", "-newkey", "rsa:2048", "-nodes",
                 "-keyout", self.key_file, "-out", csr, "-subj", f"/CN={cn}"],
                check=True, capture_output=True)
            ext = os.path.join(self.workdir, "san.cnf")
            with open(ext, "w") as f:
                f.write(f"subjectAltName=DNS:{cn},DNS:{self.service_name}."
                        f"{self.namespace}\n")
            subprocess.run(
                ["openssl", "x509", "-req", "-in", csr, "-CA", self.ca_file,
                 "-CAkey", ca_key, "-CAcreateserial", "-out", self.cert_file,
                 "-days", str(self.CERT_VALIDITY_DAYS), "-extfile", ext],
                check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return False
        self._store_secrets()
        return True

    def renew(self) -> bool:
        return self.generate()

    def ca_bundle(self) -> str:
        import base64

        try:
            with open(self.ca_file, "rb") as f:
                return base64.b64encode(f.read()).decode()
        except OSError:
            return ""

    def _store_secrets(self) -> None:
        if self.client is None:
            return
        import base64

        def b64(path):
            try:
                with open(path, "rb") as f:
                    return base64.b64encode(f.read()).decode()
            except OSError:
                return ""

        pair = {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": f"{self.service_name}.{self.namespace}.svc."
                                 f"kyverno-tls-pair",
                         "namespace": self.namespace},
            "type": "kubernetes.io/tls",
            "data": {"tls.crt": b64(self.cert_file), "tls.key": b64(self.key_file)},
        }
        ca = {
            "apiVersion": "v1", "kind": "Secret",
            "metadata": {"name": f"{self.service_name}.{self.namespace}.svc."
                                 f"kyverno-tls-ca",
                         "namespace": self.namespace},
            "data": {"ca.crt": b64(self.ca_file)},
        }
        for secret in (pair, ca):
            meta = secret["metadata"]
            if self.client.get_resource("v1", "Secret", meta["namespace"],
                                        meta["name"]) is None:
                self.client.create_resource(secret)
            else:
                self.client.update_resource(secret)
