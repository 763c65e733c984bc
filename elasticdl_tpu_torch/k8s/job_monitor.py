"""Poll one pod's phase to its end (port of
elasticdl_tpu/k8s/job_monitor.py): a pod is finished in a terminal
phase, when it is gone, or when its ``status`` label reads
``Finished``, the label the master's pod manager sets at the job's end.
"""

import time

from elasticdl_tpu_torch.common.log_utils import (
    default_logger as _logger_factory,
)

logger = _logger_factory("elasticdl_tpu_torch.k8s.job_monitor")

FINISHED_PHASES = ("Succeeded", "Failed")


class PodMonitor:
    def __init__(self, api, pod_name, poll_secs=30):
        self._api = api
        self._pod_name = pod_name
        self._poll_secs = poll_secs

    def pod_phase(self):
        try:
            pod = self._api.get_pod(self._pod_name)
        except Exception as e:
            # log-and-degrade: a vanished pod legitimately reads as
            # finished, but an API outage masquerading as "finished"
            # must leave a trace
            logger.warning("get_pod(%s) failed: %s", self._pod_name, e)
            return None  # gone counts as finished for exit purposes
        return pod.get("status", {}).get("phase")

    def pod_finished(self):
        """True when the pod reached a terminal phase, disappeared, or
        carries a ``status: Finished`` label (k8s/client.py
        ``update_master_status_label``)."""
        try:
            pod = self._api.get_pod(self._pod_name)
        except Exception as e:
            logger.warning("get_pod(%s) failed: %s", self._pod_name, e)
            return True
        phase = pod.get("status", {}).get("phase")
        if phase in FINISHED_PHASES:
            return True
        labels = pod.get("metadata", {}).get("labels", {})
        return labels.get("status") == "Finished"

    def wait(self, timeout_secs=None):
        """Block until finished; returns the final phase (or None)."""
        deadline = (
            time.time() + timeout_secs if timeout_secs else None
        )
        while True:
            if self.pod_finished():
                return self.pod_phase()
            if deadline and time.time() > deadline:
                return self.pod_phase()
            time.sleep(self._poll_secs)
