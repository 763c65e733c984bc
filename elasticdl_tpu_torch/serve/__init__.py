"""Online serving role (port of elasticdl_tpu/serve, the single-replica
dense path).

- ``model.py``    -- load an export into the model-zoo module on the
  chosen device, one padded-batch forward under inference mode.
- ``batcher.py``  -- admission-controlled micro-batching: bounded queue
  with load shedding, max-size-or-max-delay formation, per-request
  deadlines (a late request is shed, never served late).
- ``engine.py``   -- model-version lifecycle: export watcher, warm-up,
  atomic hot swap.
- ``servicer.py`` / ``client.py`` -- the ``elasticdl_tpu.Serve`` gRPC
  surface, wire-compatible with the JAX package.
- ``main.py``     -- the role entry point (SIGTERM graceful drain).
"""
