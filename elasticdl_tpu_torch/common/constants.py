"""Shared constants (copy of elasticdl_tpu/common/constants.py, trimmed
to the gRPC limits, the job and worker modes and the task retry cap)."""


class GRPC:
    # Whole dense models (and a bf16 (1, 1024, 32000) logits response,
    # 65.5 MB) ride in single messages.
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024
    # Per-RPC deadline: a hung peer surfaces as DEADLINE_EXCEEDED
    # instead of blocking the caller forever.
    DEFAULT_RPC_TIMEOUT_SECS = 60.0


class JobType:
    TRAINING_ONLY = "training"
    EVALUATION_ONLY = "evaluation"
    PREDICTION_ONLY = "prediction"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


# Per-task retry budget before the job is declared failed.
MAX_TASK_RETRIES = 3
