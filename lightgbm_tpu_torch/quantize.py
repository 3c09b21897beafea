"""Raw feature values into store bins, against frozen BinMappers.

Port of the train-policy half of lightgbm_tpu/quantize.py
(`bin_rows_into`, `bin_column_into`, `bin_feature_column`): every
dataset build bins through here.  With a bundle plan (EFB), a packed
feature folds its non-default bins into its shared store column with
`binning.pack_bundle_column` (last writer wins on conflicting rows), and
each function returns the conflicting rows it saw.  Every column goes
through `BinMapper.value_to_bin`; the JAX package's native bulk binner
gives the same bins and is not ported.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .binning import BinMapper, pack_bundle_column


def bin_feature_column(k: int, values: np.ndarray,
                       mappers: Sequence[BinMapper],
                       used_features: Sequence[int], plan,
                       out: np.ndarray) -> int:
    """Bin used feature k's raw column into `out`, the [N] row of its
    store column: a copy for an unbundled feature, a pack into the
    bundle column otherwise.  Returns the realized bundle conflicts."""
    b = mappers[used_features[k]].value_to_bin(values)
    if plan is None or not plan.feat_packed[k]:
        out[:] = b.astype(out.dtype)
        return 0
    return pack_bundle_column(
        b, int(plan.feat_default[k]), int(plan.feat_offset[k]), out)


def bin_column_into(k: int, values: np.ndarray,
                    mappers: Sequence[BinMapper],
                    used_features: Sequence[int], plan,
                    store: np.ndarray) -> int:
    """Bin used feature k's full raw column into its store column of
    `store` [C, N].  Returns the realized bundle conflicts."""
    c = k if plan is None else int(plan.feat_col[k])
    return bin_feature_column(k, values, mappers, used_features, plan,
                              store[c])


def bin_rows_into(X: np.ndarray, mappers: Sequence[BinMapper],
                  used_features: Sequence[int], plan, store: np.ndarray,
                  row0: int) -> int:
    """Bin raw rows X into store[:, row0:row0 + len(X)], feature by
    feature in used order (so packed features fold in the JAX package's
    order).  Returns the realized bundle conflicts."""
    sl = slice(row0, row0 + len(X))
    conflicts = 0
    for k in range(len(used_features)):
        c = k if plan is None else int(plan.feat_col[k])
        conflicts += bin_feature_column(k, X[:, used_features[k]], mappers,
                                        used_features, plan, store[c, sl])
    return conflicts
