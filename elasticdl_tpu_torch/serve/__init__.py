"""Online serving role (port of elasticdl_tpu/serve).

- ``model.py``    -- load an export into the model-zoo module on the
  chosen device, one padded-batch forward under inference mode.
- ``batcher.py``  -- admission-controlled micro-batching: bounded queue
  with load shedding, max-size-or-max-delay formation, per-request
  deadlines (a late request is shed, never served late).
- ``engine.py``   -- model-version lifecycle: export watcher, warm-up,
  atomic hot swap; directed by the router in fleet mode.
- ``servicer.py`` / ``client.py`` -- the ``elasticdl_tpu.Serve`` gRPC
  surface, wire-compatible with the JAX package.
- ``main.py``     -- the role entry point (SIGTERM graceful drain, the
  router link with ``--router_addr``).

The fleet layer fronts N such replicas with the router role:

- ``router.py``      -- the same ``Serve`` surface, consistent-hash
  affinity routing with bounded-retry failover, per-replica in-flight
  caps (shed, don't spill), canary traffic slicing.
- ``fleet.py``       -- replica registry (register/heartbeat/expire),
  replica autoscaler on the master's ``DecisionGate``, subprocess
  replica placement.
- ``canary.py``      -- the canary judge: a fraction slice on new
  exports, total-variation and failure-rate verdicts, automatic
  promote/rollback, every decision journaled.
- ``router_main.py`` -- the router role entry point.
"""
