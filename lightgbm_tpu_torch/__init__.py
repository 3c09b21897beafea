"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

The same LightGBM-compatible parameters, model text format and Python
API as the JAX package, running on an NVIDIA GPU: binning on the host,
the tree learners on the device with their histogram, partition and
lookup steps as hand-written CUDA kernels (csrc/), GBDT, GOSS and DART
boosting, `train` and `cv` with the callback library, the scikit-learn
estimators, prediction through the host and device tree walks, data
files (`Dataset(path)`, `Booster.predict(path)`, the binary cache), the
CLI (`python -m lightgbm_tpu_torch config=train.conf`, application.py),
the training C ABI (capi.py), PMML and plot export, and — imported on
first use as `serving` and `online` — the serving plane and online
learning.  Entry points run on the GPU (device_type=cuda, the default);
device_type=cpu runs the kernels' plain PyTorch versions and is taken
only when asked for.
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
from .plotting import (plot_importance, plot_metric, plot_tree,
                       create_tree_digraph)

__all__ = ["Config", "config_from_params", "PARAM_ALIASES", "RawDataset",
           "Metadata", "Tree", "GBDT", "create_boosting", "Dataset",
           "Booster", "LightGBMError", "train", "cv", "early_stopping",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
           "plot_importance", "plot_metric", "plot_tree",
           "create_tree_digraph", "serving", "online"]


def __getattr__(name):
    # the serving plane and online learning are imported on first use,
    # so the training and CLI import path stays free of servers and
    # daemons
    if name in ("serving", "online"):
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
