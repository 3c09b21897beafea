"""Leaf-value refit from fresh labeled data.

Port of lightgbm_tpu/online/refit.py.  Reference semantics
(`GBDT::RefitTree` + `SerialTreeLearner::FitByExistingTree`): tree
STRUCTURES are kept and leaf VALUES are refit on new labels.  Iteration
by iteration, gradients are taken at the scores of the trees refit so
far, each leaf gets the Newton output of the rows routed to it, and the
result blends with the old value:

    new = refit_decay_rate * old
        + (1 - refit_decay_rate) * clip(leaf_output(sum_g, sum_h,
                                                    l1, l2) * shrinkage,
                                        +-100)

Routing is fixed for the whole refit: one binned ensemble walk
(`ops.predict.predict_ensemble_leaf_binned`, integer bin compares over
the dataset's store) gives every (tree, row) its leaf, or the caller
passes `leaf_idx` from the raw-value router (Booster.refit and the
OnlineTrainer do: upstream's pred_leaf refit, immune to a store whose
own mappers cut a threshold inside a bin).  The JAX package then runs one
`lax.scan` of one-hot matmuls; here the same loop runs as plain PyTorch
on the booster's device (no kernel of its own: the JAX body is XLA, not
Pallas), one iteration a step:

- the objective's own gradients at the current scores (a clone of the
  model's objective, initialised on the refit rows at every refit: the
  port's objectives bind their labels at `init`);
- per-leaf sums of gradient, hessian and rows as one-hot products over
  FIXED row chunks (`_leaf_sums`): a [K, M, rows] one-hot of at most
  `LEAF_SUM_CHUNK_BYTES` times the [K, rows, 3] values, in float64 and
  added chunk by chunk in row order.  A matrix product adds in a fixed
  order, so the sums are the same bits from run to run on the card,
  where an `index_add_` would add in atomic order; float64 makes them
  exact on dyadic gradients and leaves the f32 rounding to the cast;
- the leaf outputs, guards and blend in float32 as in the JAX scan, and
  the score advanced by a gather of the new values.

Guards: a leaf with fewer than `refit_min_rows` rows, or no hessian,
keeps its old value, as do FROZEN trees (the boost-from-average tree and
constant stumps).  Unchanged leaves keep their exact float64 values.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..log import LightGBMError

# bytes of one chunk's float64 one-hot in `_leaf_sums`
LEAF_SUM_CHUNK_BYTES = 64 << 20
# rows a binned routing pass walks at once
ROUTE_CHUNK_ROWS = 262_144


class LeafRefitter:
    """Reusable refit of one (model structure, dataset) pair: build once,
    call :meth:`refit` per refresh window.  The binned routing stack is
    built on the first refit without `leaf_idx` and kept while the model
    structure holds."""

    def __init__(self, gbdt, dataset, *, decay_rate: Optional[float] = None,
                 min_rows: Optional[int] = None):
        cfg = gbdt.config
        if not gbdt.models:
            raise LightGBMError("cannot refit a model with no trees")
        # the booster's device: a GPU must be visible for device_type=cuda
        self.device = gbdt._predict_device()
        self.gbdt = gbdt
        self.dataset = dataset
        self.decay = (cfg.refit_decay_rate if decay_rate is None
                      else float(decay_rate))
        if not 0.0 <= self.decay <= 1.0:
            raise ValueError("decay_rate must be in [0, 1]")
        self.min_rows = (cfg.refit_min_rows if min_rows is None
                         else int(min_rows))
        models = gbdt.models
        self.T = len(models)
        self.K = max(int(gbdt.K), 1)
        if self.T % self.K:
            raise LightGBMError(
                f"model has {self.T} trees, not a multiple of "
                f"num_tree_per_iteration={self.K}")
        self.iters = self.T // self.K
        self.M = max(int(t.max_leaves) for t in models)
        self._stack = None
        self._meta = None
        self._feat_tbl = None
        frozen = np.zeros(self.T, bool)
        if gbdt.boost_from_average_used and self.T:
            frozen[0] = True
        for i, t in enumerate(models):
            if t.num_leaves < 2:
                frozen[i] = True
        self._frozen = frozen
        self._objective = self._clone_objective(gbdt)
        self.refits = 0

    # -- setup ----------------------------------------------------------

    def _ensure_router(self) -> None:
        """Build the binned routing stack on first use."""
        if self._stack is not None:
            return
        from ..ops.predict import stack_ensemble, to_device
        gbdt, dataset = self.gbdt, self.dataset
        train_set = getattr(gbdt, "train_set", None)
        for t in gbdt.models:
            if dataset is not train_set and not getattr(t, "needs_rebin",
                                                        False):
                # trees trained in this process carry in-bin
                # thresholds of the TRAINING mappers; against any other
                # store they re-derive them from the real-valued
                # thresholds (exact against the training mappers, whose
                # bin upper bounds the thresholds are)
                t.needs_rebin = True
            t.rebin_to_dataset(dataset)
        # model order: one "class" per tree, so row t of the [T, N] walk
        # is models[t]
        stack, meta = stack_ensemble([[t] for t in gbdt.models],
                                     binned=True)
        self._stack = to_device(stack, self.device)
        self._meta = meta
        ft = dataset.bundle_feat_table()
        self._feat_tbl = None if ft is None else torch.as_tensor(
            np.asarray(ft), device=self.device)

    @staticmethod
    def _clone_objective(gbdt):
        """A fresh objective of the model's type (initialised on the
        refit rows at each refit), leaving the training objective's
        state alone."""
        from ..objectives import create_objective, objective_from_model_string
        base = gbdt.objective
        obj = (objective_from_model_string(base.to_string(), gbdt.config)
               if base is not None else create_objective(gbdt.config))
        if obj.name == "lambdarank":
            raise LightGBMError(
                "leaf refit does not support lambdarank yet (traffic "
                "windows would need whole queries)")
        return obj

    # -- per-window refresh ---------------------------------------------

    def route_binned(self) -> torch.Tensor:
        """[T, num_data] int32 leaf of every (tree, row) by the binned
        walk over the dataset's store, on the device."""
        from ..ops.predict import predict_ensemble_leaf_binned
        self._ensure_router()
        ds = self.dataset
        n = ds.num_data
        out = torch.empty((self.T, n), dtype=torch.int32, device=self.device)
        store = ds.dense_bins(site="refit_router")
        for a in range(0, n, ROUTE_CHUNK_ROWS):
            b = min(a + ROUTE_CHUNK_ROWS, n)
            bins = torch.as_tensor(store[:, a:b].astype(np.int32),
                                   device=self.device)
            out[:, a:b] = predict_ensemble_leaf_binned(
                self._stack, bins, self._feat_tbl, meta=self._meta)
        return out

    def _leaf_sums(self, leaf: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
        """[K, M, 3] float64 (sum g, sum h, rows) per (class tree, leaf)
        from leaf [K, N] int64 and g, h [K, N]: one-hot products over
        fixed row chunks, added in row order (see the module
        docstring)."""
        K, n = leaf.shape
        M = self.M
        vals = torch.stack([g, h, torch.ones_like(g)], dim=-1).to(
            torch.float64)                                   # [K, N, 3]
        ids = torch.arange(M, device=leaf.device)[None, :, None]
        rows = max(1024, LEAF_SUM_CHUNK_BYTES // (8 * K * M))
        out = torch.zeros((K, M, 3), dtype=torch.float64, device=leaf.device)
        for a in range(0, n, rows):
            oh = (leaf[:, None, a:a + rows] == ids).to(torch.float64)
            out += torch.bmm(oh, vals[:, a:a + rows])
        return out

    def refit(self, leaf_idx: Optional[np.ndarray] = None) -> dict:
        """Refit every tree's leaf values on the dataset's CURRENT rows
        (the model changes in place); returns a stats dict.

        leaf_idx: optional [num_data, num_trees] leaf indices (the C
        API's LGBM_BoosterRefit contract); the binned router runs when
        it is omitted."""
        from ..dataset import Metadata
        from ..ops.split import leaf_output
        gbdt, ds = self.gbdt, self.dataset
        if len(gbdt.models) != self.T:
            raise LightGBMError("model structure changed since this "
                                "LeafRefitter was built; rebuild it")
        n, cap = ds.num_data, ds.row_capacity
        md = ds.metadata
        if n < 1:
            raise LightGBMError("refit needs at least one labeled row")
        if md.label.size != n:
            raise LightGBMError("refit data carries no labels")
        dev = self.device
        if leaf_idx is None:
            leaf = self.route_binned()
        else:
            li = np.asarray(leaf_idx, np.int32)
            if li.shape != (n, self.T):
                raise ValueError(
                    f"leaf_idx must be [{n}, {self.T}], got {li.shape}")
            leaf = torch.as_tensor(np.ascontiguousarray(li.T), device=dev)
        leaf = leaf.reshape(self.iters, self.K, n)

        obj = self._objective
        obj.init(Metadata(label=np.asarray(md.label, np.float32),
                          weights=md.weights), n, dev)
        if hasattr(obj, "need_train"):
            # the refit takes the gradients of a one-class window too, as
            # the JAX scan calls the objective's gradient program directly
            obj.need_train = True
        score = torch.zeros((self.K, n), dtype=torch.float32, device=dev)
        if md.init_score is not None:
            init = np.asarray(md.init_score, np.float64).reshape(-1)
            if init.size == n * self.K:
                score[:] = torch.as_tensor(
                    init.reshape(self.K, n).astype(np.float32), device=dev)
            elif init.size == n:
                score[:] = torch.as_tensor(init.astype(np.float32),
                                           device=dev)[None, :]
            else:
                raise LightGBMError("init score size mismatch")
        old = np.zeros((self.T, self.M), np.float32)
        for i, t in enumerate(gbdt.models):
            m = min(t.max_leaves, self.M)
            old[i, :m] = t.leaf_value[:m].astype(np.float32)
        old_d = torch.as_tensor(old.reshape(self.iters, self.K, self.M),
                                device=dev)
        shrink = torch.as_tensor(np.asarray(
            [t.shrinkage for t in gbdt.models], np.float32).reshape(
                self.iters, self.K), device=dev)
        ok = torch.as_tensor((~self._frozen).reshape(self.iters, self.K),
                             device=dev)
        cfg = gbdt.config
        l1, l2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        decay = float(self.decay)
        # a zero-row leaf must never take its (0/0) Newton step
        minr = float(max(self.min_rows, 1))
        new_lv, upd_lv = [], []
        for it in range(self.iters):
            lf = leaf[it].to(torch.int64)
            g, h = obj.get_gradients(score)
            sums = self._leaf_sums(lf, g, h)
            gs = sums[..., 0].to(torch.float32)
            hs = sums[..., 1].to(torch.float32)
            cnt = sums[..., 2]
            out = torch.clamp(leaf_output(gs, hs, l1, l2)
                              * shrink[it][:, None], -100.0, 100.0)
            # hs > 0 keeps a leaf of only zero-WEIGHT rows (cnt counts
            # rows whatever their weight) from a 0/0 step
            upd = (cnt >= minr) & (hs > 0.0) & ok[it][:, None]
            new = decay * old_d[it] + (1.0 - decay) * out
            new = torch.where(upd, new, old_d[it])
            score = score + torch.gather(new, 1, lf)
            new_lv.append(new)
            upd_lv.append(upd)
        flat = torch.stack(new_lv).reshape(self.T, self.M).cpu().numpy()
        updm = torch.stack(upd_lv).reshape(self.T, self.M).cpu().numpy()
        changed = 0
        for i, t in enumerate(gbdt.models):
            if self._frozen[i] or self.decay == 1.0:
                # decay 1.0 is a documented freeze, and an UNCHANGED leaf
                # keeps its exact f64 value (starved leaves too, hence
                # the update mask)
                continue
            m = t.num_leaves
            t.set_leaf_values(np.where(updm[i, :m],
                                       flat[i, :m].astype(np.float64),
                                       t.leaf_value[:m]))
            changed += 1
        # the device predictor's stacks hold the old leaf values under a
        # key of tree counts, which a refit does not change
        gbdt._models_changed()
        self.refits += 1
        return {"rows": int(n), "capacity": int(cap),
                "trees": int(self.T), "trees_refit": int(changed),
                "decay_rate": float(self.decay),
                "min_rows": int(self.min_rows)}


def refit_gbdt(gbdt, dataset, *, decay_rate: Optional[float] = None,
               min_rows: Optional[int] = None,
               leaf_idx: Optional[np.ndarray] = None) -> dict:
    """One-shot refit of `gbdt`'s leaf values on `dataset` (in place).
    Callers that refresh repeatedly hold a LeafRefitter instead, so the
    routing stack is built once."""
    return LeafRefitter(gbdt, dataset, decay_rate=decay_rate,
                        min_rows=min_rows).refit(leaf_idx=leaf_idx)
