"""Parameter-server side of the sparse path: the host embedding stores,
the gRPC servicer and server process over them, and the in-process
client."""
