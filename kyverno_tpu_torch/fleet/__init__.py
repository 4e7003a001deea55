"""Fleet plane: multi-replica serving over a shared verdict fabric.

Three modules, all behind the declared ``KTPU_FABRIC`` /
``KTPU_SCAN_PARTITIONS`` master switches (off = today's single-replica
behavior bit-for-bit):

``fabric``
    Content-addressed shared cache tier for the three per-process
    caches (decision, flatten-row, host-verdict), speaking the stream
    codec's CACHE_GET/PUT/INVALIDATE frames with epoch-scoped
    invalidation.
``router``
    Replica-pool front door for the streaming plane: consistent-hash
    admission routing by resource digest, per-replica /healthz watch,
    circuit-breakered failover.
``scanparts``
    Leader-partitioned background scanning: namespace-hash shard
    ranges assigned via named leases, per-range verdict-matrix
    digests, lease-expiry takeover of orphaned ranges.
"""
