"""xDeepFM CTR model-zoo module (port of elasticdl_tpu/models/xdeepfm.py,
the reference's model_zoo/dac_ctr/xdeepfm_model.py).

A thin selector over models/ctr.py pinning the variant; that module has
the architecture.
"""

from elasticdl_tpu_torch.models import ctr as _ctr
from elasticdl_tpu_torch.models.ctr import (  # noqa: F401
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
    params_from_flax,
)


def custom_model():
    return _ctr.VARIANTS["xdeepfm"]()
