"""Dataset -> RecordIO converters (port of elasticdl_tpu/data/gen/).

They write the framework's own example encoding (data/example.py):
caller-provided arrays, or synthetic rows of the mnist, census, frappe
and heart shapes made with numpy from a seed, each with a planted
signal so that training on them converges. For the same seed they
write the same bytes as the JAX package's.
"""

from elasticdl_tpu_torch.data.gen.converters import (  # noqa: F401
    convert_image_label,
    convert_rows,
    gen_census_recordio,
    gen_frappe_recordio,
    gen_heart_recordio,
    gen_mnist_recordio,
)
