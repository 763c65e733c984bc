"""tests/test_model_zoo.py's ``test_census_dnn_learns`` and
``test_census_sqlflow_wide_deep_learns`` on the port, from the
reference's initial weights, as tests/test_torch_feature_learns.py runs
the rest of the family.
"""

import torch

from tests.test_torch_feature_learns import learn_generated

torch.set_num_threads(1)


def test_census_dnn_learns(tmp_path):
    learn_generated(tmp_path, "census_dnn", 0.75, (2048, 512), 6)


def test_census_sqlflow_wide_deep_learns(tmp_path):
    learn_generated(tmp_path, "census_sqlflow_wide_deep", 0.75, (2048, 512),
                    6)
