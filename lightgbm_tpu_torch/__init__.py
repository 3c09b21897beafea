"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

The same LightGBM-compatible parameters, model text format and Python
API as the JAX package, running on an NVIDIA GPU: binning on the host,
the tree learners on the device with their histogram, partition and
lookup steps as hand-written CUDA kernels (csrc/), GBDT, GOSS and DART
boosting, `train` and `cv` with the callback library, the scikit-learn
estimators, and prediction through the host tree walk.  Entry points run
on the GPU (device_type=cuda, the default); device_type=cpu runs the
kernels' plain PyTorch versions and is taken only when asked for.
"""

__version__ = "0.1.0"

from .config import Config, config_from_params, PARAM_ALIASES
from .dataset import Dataset as RawDataset, Metadata
from .tree import Tree
from .boosting.gbdt import GBDT, create_boosting
from .basic import Dataset, Booster, LightGBMError
from .engine import train, cv
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .sklearn import LGBMModel, LGBMRegressor, LGBMClassifier, LGBMRanker

__all__ = ["Config", "config_from_params", "PARAM_ALIASES", "RawDataset",
           "Metadata", "Tree", "GBDT", "create_boosting", "Dataset",
           "Booster", "LightGBMError", "train", "cv", "early_stopping",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]
