"""The base of the feature-column models (census_dnn, census_wide_deep,
census_sqlflow_wide_deep, heart): flax names both ways and flax's
initializers for the Dense layers (``FlaxNamed``) and for every
``DenseFeatures`` table, drawn from one generator.
"""

import torch

from elasticdl_tpu_torch.models.layers import Dense, FlaxNamed, init_flax_
from elasticdl_tpu_torch.preprocessing.feature_column import DenseFeatures


class FeatureNet(FlaxNamed):
    def reset_parameters(self, generator=None):
        init_flax_(self, generator)
        for module in self.modules():
            if isinstance(module, DenseFeatures):
                module.reset_parameters(generator)


def tower(net, prefix, in_features, hidden):
    """``net.<prefix>_<i>``: one Dense layer a width of ``hidden``, as
    flax names a ``setup`` list; returns the last width."""
    for i, width in enumerate(hidden):
        setattr(net, "%s_%d" % (prefix, i), Dense(in_features, width))
        in_features = width
    return in_features


def run_tower(net, prefix, hidden, x):
    for i in range(len(hidden)):
        x = torch.relu(getattr(net, "%s_%d" % (prefix, i))(x))
    return x
