"""The job's control plane: the task dispatcher, the Master gRPC
service, the liveness monitor, the evaluation service and the mesh
rendezvous, composed by ``master.Master``."""
