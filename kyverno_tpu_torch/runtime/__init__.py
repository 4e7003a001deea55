"""The runtime around the engine on the host: the ``KTPU_*`` switch
registry (``featureplane``), the span recorder (``tracing``), the host
lane that resolves HOST cells (``hostlane``: prefetch at dispatch, a
content-addressed verdict memo in ``resourcecache``, fan-out over a
thread pool) and the pool-safety predicate of ``oracle_pool``."""
