"""Controller process wiring: the cmd/kyverno/main.go:70 equivalent.

Builds and starts every component against a cluster client: policy cache,
dynamic config, webhook server + registration + monitor, cert renewer,
event generator, report pipeline, generate controller, background scanner,
leader election (controllers leader-only, webhooks active-active). Also the
pre-start janitor (cmd/initContainer/main.go) as ``init_cleanup``.

Run: ``python -m kyverno_tpu_torch.server`` (in-cluster, on the card) or
construct :class:`Controller` with a FakeCluster for tests
(``Controller(client=FakeCluster(), device="cpu")`` runs the kernels'
plain versions on the CPU).

One difference from the JAX package, on purpose: a background scan that
raises is logged and kept on the controller (``last_scan_error``), where
the JAX scan loop drops it; the loop stays alive either way.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

from .api.load import load_policy
from .policy.autogen import mutate_policy_for_autogen
from .runtime import migrations, profiling
from .models.engine import resolve_device
from .runtime.background import BackgroundScanner
from .runtime.batch import AdmissionBatcher
from .runtime.client import Client, FakeCluster, RestClient, RestConfig
from .runtime.config import ConfigData
from .runtime.events import EventGenerator
from .runtime.generate_controller import GenerateController
from .runtime.leaderelection import LeaderElector
from .runtime.metrics import MetricsRegistry
from .runtime.policycache import PolicyCache
from .runtime.reports import ReportGenerator
from .runtime.webhook import WebhookServer
from .runtime.webhookconfig import (
    CertRenewer,
    Monitor,
    Register,
    WebhookConfigManager,
)

BACKGROUND_SCAN_INTERVAL_S = 3600.0  # cmd/kyverno/main.go:94 default 1h

log = logging.getLogger("kyverno.server")

# representative resource for warming the admission screen
_WARMUP_POD = {
    "apiVersion": "v1", "kind": "Pod",
    "metadata": {"name": "warmup", "namespace": "default",
                 "labels": {"app": "warmup"}},
    "spec": {"containers": [{"name": "c", "image": "registry.local/a:v1",
                             "resources": {"requests": {"cpu": "100m"},
                                           "limits": {"memory": "128Mi"}}}]},
}


def init_cleanup(client: Client) -> None:
    """cmd/initContainer/main.go: delete stale webhook configs, certs and
    report requests left by a previous instance."""
    from .runtime import webhookconfig as wc

    for kind, api, name in (
        ("MutatingWebhookConfiguration", "admissionregistration.k8s.io/v1",
         wc.MUTATING_WEBHOOK_CONFIG),
        ("ValidatingWebhookConfiguration", "admissionregistration.k8s.io/v1",
         wc.VALIDATING_WEBHOOK_CONFIG),
        ("MutatingWebhookConfiguration", "admissionregistration.k8s.io/v1",
         wc.POLICY_MUTATING_WEBHOOK_CONFIG),
        ("ValidatingWebhookConfiguration", "admissionregistration.k8s.io/v1",
         wc.POLICY_VALIDATING_WEBHOOK_CONFIG),
        ("MutatingWebhookConfiguration", "admissionregistration.k8s.io/v1",
         wc.VERIFY_MUTATING_WEBHOOK_CONFIG),
    ):
        client.delete_resource(api, kind, "", name)
    for rcr in client.list_resource("kyverno.io/v1alpha2", "ReportChangeRequest"):
        meta = rcr.get("metadata") or {}
        client.delete_resource("kyverno.io/v1alpha2", "ReportChangeRequest",
                               meta.get("namespace", ""), meta.get("name", ""))


class Controller:
    """The assembled process (everything main.go wires at :70-531).
    ``device`` is where the policy sets run: ``cuda`` unless the caller
    asks for ``"cpu"``; with no card and no CPU request it raises."""

    def __init__(self, client: Client | None = None, namespace: str = "kyverno",
                 serve_port: int = 9443, enable_tls: bool = False,
                 image_verifier=None, device=None):
        self.device = resolve_device(device)
        self.client = client if client is not None else FakeCluster()
        self.namespace = namespace
        self.serve_port = serve_port

        self.registry = MetricsRegistry()
        self.config = ConfigData()
        self.policy_cache = PolicyCache(device=self.device)
        self.event_gen = EventGenerator(self.client)
        self.report_gen = ReportGenerator(self.client)
        self.cert_renewer = CertRenewer(self.client) if enable_tls else None
        # the device screen for enforce admissions (runtime/batch.py),
        # on by default: its latency router sends lone requests straight
        # to the CPU oracle and engages the device only when a burst
        # forms, so single-request latency never pays the device RTT
        self.admission_batcher = AdmissionBatcher(self.policy_cache)
        if image_verifier is None:
            # deployable default: key-based cosign verification against
            # live registries (pkg/cosign is unconditionally real in the
            # reference); tests/air-gapped runs inject StaticVerifier
            from .engine.registry_verify import RegistryVerifier

            image_verifier = RegistryVerifier()
        self.webhook = WebhookServer(
            policy_cache=self.policy_cache, config=self.config,
            client=self.client, event_gen=self.event_gen,
            report_gen=self.report_gen, registry=self.registry,
            admission_batcher=self.admission_batcher,
            image_verifier=image_verifier, device=self.device,
        )
        ca = self.cert_renewer.ca_bundle() if self.cert_renewer else ""
        self.register = Register(self.client, ca_bundle=ca)
        self.monitor = Monitor(self.register, self.cert_renewer)
        self.webhook_manager = WebhookConfigManager(self.client, self.register)
        self.generate_controller = GenerateController(self.client, {})
        from .policy.crd_sync import CrdSync

        self.crd_sync = CrdSync(self.client)
        self.elector = LeaderElector(
            self.client, namespace=namespace,
            on_started_leading=self._start_leader_tasks,
        )
        self._scan_thread: threading.Thread | None = None
        self._warm_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._scan_kick = threading.Event()
        self._loading_policies = False      # coalesce startup sync
        self._webhook_sync_pending = False
        self._httpd = None
        # the last background scan's result, and the exception of the last
        # scan that raised in the scan loop
        self.last_scan = None
        self.last_scan_error: BaseException | None = None

        # policy-change reconciliation (policy_controller.go:541-573 +
        # configmanager.go:129): cache changes re-narrow the webhooks and
        # re-queue the background scan; cluster watch events feed the cache
        # and prune reports for deleted policies/resources
        self.policy_cache.add_listener(self._on_policy_change)
        if hasattr(self.client, "watch"):
            self.client.watch(self._on_cluster_event)
        self.config.on_change(lambda *_: self.report_gen.reconcile())

    # ---------------------------------------------------------- reconcile

    def _sync_webhooks(self) -> None:
        try:
            self.webhook_manager.sync(self.policy_cache.all_policies())
            self._webhook_sync_pending = False
        except Exception:
            # stale webhook rules mean missed admissions — log and retry
            # on the next scan tick (the reference requeues via workqueue,
            # configmanager.go:129-150)
            logging.getLogger("kyverno.webhookconfig").exception(
                "webhook config sync failed; will retry")
            self._webhook_sync_pending = True

    def _warm_screen(self) -> None:
        """Warm the admission screen off the hot path: the shape bucket's
        K1 -> eval_rules build (the first launch builds the kernels) and
        its K6 blob, so the first burst after a policy change pays for
        neither."""
        if self._warm_thread is not None and self._warm_thread.is_alive():
            return
        from .runtime.policycache import PolicyType

        self._warm_thread = threading.Thread(
            target=lambda: self.admission_batcher.warmup(
                PolicyType.VALIDATE_ENFORCE, "Pod", "default", _WARMUP_POD),
            name="screen-warmup", daemon=True)
        self._warm_thread.start()

    def _on_policy_change(self, event: str, policy) -> None:
        if not self._loading_policies:
            self._sync_webhooks()
            self._warm_screen()
        if event == "DELETE":
            self.report_gen.prune_policy(policy.name)
            self.generate_controller.policies.pop(policy.name, None)
        else:
            self.generate_controller.policies[policy.name] = policy
        self._scan_kick.set()

    def _on_cluster_event(self, event: str, resource: dict) -> None:
        """The informer seam: policy CRs reconcile the cache; resource
        deletions prune their report rows (reportcontroller.go cleanup)."""
        kind = resource.get("kind", "")
        if kind in ("ClusterPolicy", "Policy"):
            try:
                policy = mutate_policy_for_autogen(load_policy(resource))
            except Exception:
                return
            if event == "DELETED":
                self.policy_cache.remove(policy)
            else:
                self.policy_cache.add(policy)
        elif event == "DELETED":
            meta = resource.get("metadata") or {}
            self.report_gen.prune_resource(
                kind, meta.get("namespace", ""), meta.get("name", ""))

    # ------------------------------------------------------------ policies

    def load_policies(self) -> None:
        """Sync the cache (and generate controller) from stored policies,
        applying the same defaults+autogen mutation the policy webhook does."""
        policies = {}
        self._loading_policies = True   # one webhook sync for the batch
        try:
            for kind in ("ClusterPolicy", "Policy"):
                for doc in self.client.list_resource("kyverno.io/v1", kind):
                    policy = mutate_policy_for_autogen(load_policy(doc))
                    self.policy_cache.add(policy)
                    policies[policy.name] = policy
        finally:
            self._loading_policies = False
        self.generate_controller.policies = policies
        self._sync_webhooks()
        self._warm_screen()

    def sync_config(self) -> None:
        cm = self.client.get_configmap(self.namespace, "kyverno")
        if cm is not None:
            self.config.load(cm.get("data") or {})

    # ------------------------------------------------------------ lifecycle

    def start(self, host: str = "0.0.0.0") -> None:
        profiling.maybe_start_profiler()  # KTPU_PROFILE_PORT-gated
        if self.cert_renewer is not None:
            self.cert_renewer.generate()
        self.sync_config()
        self.load_policies()
        certfile = self.cert_renewer.cert_file if self.cert_renewer else ""
        keyfile = self.cert_renewer.key_file if self.cert_renewer else ""
        self._httpd = self.webhook.run(host=host, port=self.serve_port,
                                       certfile=certfile, keyfile=keyfile)
        # schema sync runs on EVERY replica, not just the leader: the
        # policy-admission webhook consuming the schema store serves on
        # every replica (reference wires crdSync unconditionally, main.go)
        try:
            self.crd_sync.run()
        except Exception:
            logging.getLogger("kyverno.crdsync").exception(
                "CRD schema sync failed to start; CRD kinds will skip "
                "policy mutate schema-checks")
        self.event_gen.run()
        self.elector.run()
        self.monitor.run()

    def _start_leader_tasks(self) -> None:
        """Leader-only: webhook registration, generate controller,
        background scan loop (main.go:480-486,503)."""
        self.register.register()
        migrations.run_all(self.client, self.namespace)
        self.generate_controller.run()
        self.generate_controller.sync_from_cluster()
        self.generate_controller.watch_cluster()

        def scan_loop():
            while not self._stop.is_set():
                # interval tick OR a policy-change kick, whichever first
                self._scan_kick.wait(BACKGROUND_SCAN_INTERVAL_S)
                self._scan_kick.clear()
                if self._stop.is_set():
                    return
                if self._webhook_sync_pending:
                    self._sync_webhooks()
                if self.elector.is_leader():
                    try:
                        self.run_background_scan()
                    except Exception as e:
                        # the loop stays alive, as a controller must; the
                        # failure is logged and kept, never dropped
                        log.exception("background scan failed")
                        self.last_scan_error = e

        self._scan_thread = threading.Thread(target=scan_loop, name="bg-scan",
                                             daemon=True)
        self._scan_thread.start()

    def run_background_scan(self):
        scanner = BackgroundScanner(
            self.policy_cache.all_policies(), client=self.client,
            report_gen=self.report_gen, device=self.device,
        )
        result = scanner.scan()
        self.report_gen.aggregate()
        self.last_scan = result
        return result

    def stop(self) -> None:
        self._stop.set()
        self._scan_kick.set()  # unblock the scan loop promptly
        if self.admission_batcher is not None:
            self.admission_batcher.stop()
        self.webhook.stop()
        self.event_gen.stop()
        # persist any still-queued report change requests, then stop the
        # writer — results produced just before shutdown must reach the
        # cluster for the next leader to aggregate
        self.report_gen.flush(timeout_s=2.0)
        self.report_gen.stop()
        self.generate_controller.stop()
        self.crd_sync.stop()
        self.monitor.stop()
        self.elector.stop()
        if hasattr(self.client, "stop_informers"):
            self.client.stop_informers()


def main(argv: list[str] | None = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    client = RestClient(RestConfig.in_cluster())
    if "--init-only" in argv:
        # the init-container entrypoint (cmd/initContainer/main.go)
        init_cleanup(client)
        return 0
    controller = Controller(client=client, enable_tls=True)
    init_cleanup(client)
    controller.start()

    stop = threading.Event()
    # pkg/signal: SIGINT/SIGTERM handler
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    while not stop.is_set():
        time.sleep(1)
    controller.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
