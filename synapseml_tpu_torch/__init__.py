"""PyTorch port of synapseml_tpu."""

__version__ = "0.1.0"

# the Dataset/Pipeline algebra first: core.pipeline and the row guard
# import each other, and this order settles it for every entry module
from . import core  # noqa: E402,F401
