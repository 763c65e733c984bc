"""Kubernetes integration of the port: the REST API, the job's pods and
Services, the instance manager that launches and heals them, and the
master's pod manager (port of elasticdl_tpu/k8s/)."""
