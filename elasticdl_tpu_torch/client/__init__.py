"""The client CLI (``edl-torch``): the model-zoo image workflow and job
submission (port of elasticdl_tpu/client/)."""
