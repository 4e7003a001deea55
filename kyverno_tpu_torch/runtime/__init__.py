"""The runtime around the engine on the host: the ``KTPU_*`` switch
registry (``featureplane``), the span recorder (``tracing``), the host
lane that resolves HOST cells (``hostlane``: prefetch at dispatch, a
content-addressed verdict memo in ``resourcecache``, fan-out over a
thread pool), the pool-safety predicate of ``oracle_pool``, the
background scanner (``background``), the report pipeline (``reports``),
and the admission webhook (``webhook``) with the planes it imports:
``metrics``, ``obs_http``, ``slo`` and ``sloactions``, ``config``,
``userinfo``, ``events``, ``workqueue``, ``client``, ``watch`` and
``auth``.

The scanner's and the reports' names load on first use, so that what an
oracle-pool worker imports from this package loads no torch."""

_EXPORTS = {
    "BackgroundScanner": "background",
    "ResourceManager": "background",
    "ScanResult": "background",
    "ReportGenerator": "reports",
    "build_change_request": "reports",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f"{__name__}.{module}"), name)
