"""Faults planted in the program's timed path, by name, for the tests
that see `correct` turn false and for the chip readings that set the
upper end of a limit (`python3 -m benchmark.control --fault <name>`).

Each takes an object with pytest's monkeypatch `setattr(target, name,
value)`.  The exchange between chips is no fault of a one-card cell.
"""
from __future__ import annotations

import torch


def unchanged(mp) -> None:
    """Every step leaves the model and the scores where they were."""
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.tree import Tree
    mp.setattr(gbdt, "shrink_clip_leaves",
               lambda lv, n, rate: torch.zeros_like(lv[:n]))
    real = Tree.apply_shrinkage
    mp.setattr(Tree, "apply_shrinkage", lambda self, rate: real(self, 0.0))


def half_batch(mp) -> None:
    """Half of the rows left out of every step, the rest counted double."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    real = GBDT.boosting_gradients

    def grads(self):
        g, h = real(self)
        n = g.shape[-1]
        w = torch.zeros(n, dtype=g.dtype, device=g.device)
        w[: n // 2] = 2.0
        return g * w, h * w
    mp.setattr(GBDT, "boosting_gradients", grads)


def leaf_altered(mp) -> None:
    """One leaf value of every tree altered where the tree is made."""
    from lightgbm_tpu_torch.tree import Tree
    real = Tree.apply_shrinkage

    def shrink(self, rate):
        real(self, rate)
        self.leaf_value[0] += 0.05
    mp.setattr(Tree, "apply_shrinkage", shrink)


def metric_altered(mp) -> None:
    """The reported valid metric altered where it is computed."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    real = GBDT.eval_valid

    def ev(self):
        return [(a, b, v + 1e-3, c) for a, b, v, c in real(self)]
    mp.setattr(GBDT, "eval_valid", ev)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, leaf_altered,
                                  metric_altered)}


class Patch:
    """monkeypatch's setattr outside pytest; the process ends with it."""

    @staticmethod
    def setattr(target, name, value) -> None:
        setattr(target, name, value)
