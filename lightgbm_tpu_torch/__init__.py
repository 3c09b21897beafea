"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

The same LightGBM-compatible parameters, model text format and Python
API as the JAX package, running on an NVIDIA GPU: binning on the host,
the batched-rounds tree learner on the device with its histogram,
partition and lookup steps as hand-written CUDA kernels (csrc/), and
prediction through the host tree walk.  Entry points run on the GPU
(device_type=cuda, the default); device_type=cpu runs the kernels' plain
PyTorch versions and is taken only when asked for.
"""

__version__ = "0.1.0"

from .config import Config, config_from_params, PARAM_ALIASES
from .dataset import Dataset as RawDataset, Metadata
from .tree import Tree
from .boosting.gbdt import GBDT
from .basic import Dataset, Booster, LightGBMError
from .engine import train

__all__ = ["Config", "config_from_params", "PARAM_ALIASES", "RawDataset",
           "Metadata", "Tree", "GBDT", "Dataset", "Booster",
           "LightGBMError", "train"]
