"""Policy lifecycle: autogen (pod-controller rules), policy validation,
the OpenAPI schema registry and its CRD sync."""
