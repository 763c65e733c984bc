"""Parameter-server side of the sparse path: the host embedding store
and the in-process client over it (the gRPC servicer, server and
remote client are not ported yet)."""
