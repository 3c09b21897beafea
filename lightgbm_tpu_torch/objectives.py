"""Objective functions: gradient/hessian on [K, N] tensors.

Port of lightgbm_tpu/objectives.py: the regressions (L2, L1, Huber, Fair,
Poisson), binary logloss, multiclass softmax and one-vs-all, and
lambdarank, with `create_objective` and `objective_from_model_string`.
Every objective is plain tensor code on the device the score lives on,
in the f32 operation order of the JAX functions.  Where JAX folds a
constant (`jnp.sqrt(2 * jnp.pi)` is an f32 square root of f32(2 pi)),
the constant is computed the same way here.
"""
from __future__ import annotations

from typing import Tuple

import math

import numpy as np
import torch

from .config import Config
from .dataset import Metadata


class Objective:
    """Base objective.  get_gradients: [K, N] score -> ([K, N], [K, N])."""

    name = "regression"
    num_tree_per_iteration = 1
    boost_from_average = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.num_data = num_data
        self.label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                     device=device)
        self.weights = (None if metadata.weights is None
                        else torch.as_tensor(
                            np.asarray(metadata.weights, np.float32),
                            device=device))

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def convert_output(self, score: np.ndarray) -> np.ndarray:
        """Raw score -> prediction output (reference ConvertOutput)."""
        return score

    def initial_score(self) -> float:
        """boost_from_average seed value (gbdt.cpp:333-355)."""
        return 0.0

    def to_string(self) -> str:
        return self.name

    def _unit(self, score: torch.Tensor) -> torch.Tensor:
        """The [1, N] weight row, or ones shaped like the score (the JAX
        functions' `jnp.ones_like(score)` when there are no weights)."""
        if self.weights is None:
            return torch.ones_like(score)
        return self.weights[None, :]

    def _label_f64(self) -> np.ndarray:
        return self.label.cpu().numpy().astype(np.float64)


# f32(sqrt(f32(2 pi))): jnp.sqrt of the Python float rounds it to f32
# first and takes an f32 square root
_SQRT_2PI = float(np.sqrt(np.float32(2 * math.pi)))


def _gaussian_hessian(y, t, g, eta: float):
    """Common::ApproximateHessianWithGaussian (common.h:436-445); the
    leading weight factor is applied by the caller."""
    diff = y - t
    x = torch.abs(diff)
    a = 2.0 * torch.abs(g)
    c = torch.clamp((torch.abs(y) + torch.abs(t)) * eta, min=1.0e-10)
    return torch.exp(-x * x / (2.0 * c * c)) * a / (c * _SQRT_2PI)


class RegressionL2(Objective):
    name = "regression"
    boost_from_average = True

    def get_gradients(self, score):
        g = score - self.label[None, :]
        h = torch.ones_like(g)
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def initial_score(self) -> float:
        lab = self._label_f64()
        if self.weights is not None:
            w = self.weights.cpu().numpy().astype(np.float64)
            return float((lab * w).sum() / w.sum())
        return float(lab.mean())


class RegressionL1(Objective):
    name = "regression_l1"
    boost_from_average = True

    def get_gradients(self, score):
        lab = self.label[None, :]
        diff = score - lab
        w = self._unit(score)
        one = torch.ones((), dtype=score.dtype, device=score.device)
        g = torch.where(diff >= 0.0, one, -one) * w
        h = w * _gaussian_hessian(score, lab, g, self.config.gaussian_eta)
        return g, h

    def initial_score(self) -> float:
        return float(np.median(self._label_f64()))


class RegressionHuber(Objective):
    name = "huber"
    boost_from_average = True

    def get_gradients(self, score):
        delta = self.config.huber_delta
        lab = self.label[None, :]
        diff = score - lab
        w = self._unit(score)
        small = torch.abs(diff) <= delta
        # jnp.sign(0) == 0, as torch.sign
        big = torch.sign(diff) * delta
        g = torch.where(small, diff, big) * w
        h_big = w * _gaussian_hessian(score, lab, big * w,
                                      self.config.gaussian_eta)
        h = torch.where(small, w, h_big)
        return g, h

    def initial_score(self) -> float:
        return float(np.mean(self._label_f64()))


class RegressionFair(Objective):
    name = "fair"
    boost_from_average = True

    def get_gradients(self, score):
        c = self.config.fair_c
        x = score - self.label[None, :]
        w = self._unit(score)
        ax = torch.abs(x) + c
        g = c * x / ax * w
        h = c * c / (ax * ax) * w
        return g, h

    def initial_score(self) -> float:
        return float(np.mean(self._label_f64()))


class RegressionPoisson(Objective):
    name = "poisson"
    boost_from_average = True

    def get_gradients(self, score):
        g = score - self.label[None, :]
        h = score + self.config.poisson_max_delta_step
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def initial_score(self) -> float:
        return float(np.mean(self._label_f64()))


class BinaryLogloss(Objective):
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        is_pos = lab > 0
        cnt_pos, cnt_neg = int(is_pos.sum()), int((~is_pos).sum())
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        # per-row (label sign, label weight) as f32 rows, computed once
        is_p = self.label > 0
        one = torch.ones((), dtype=torch.float32, device=device)
        self._lbl = torch.where(is_p, one, -one)
        self._lw = torch.where(is_p, torch.tensor(w_pos, dtype=torch.float32,
                                                  device=device),
                               torch.tensor(w_neg, dtype=torch.float32,
                                            device=device))

    def get_gradients(self, score):
        if not self.need_train:
            z = torch.zeros_like(score)
            return z, z
        sigmoid = self.sigmoid
        lbl = self._lbl[None, :]
        response = -lbl * sigmoid / (1.0 + torch.exp(lbl * sigmoid * score))
        absr = torch.abs(response)
        lw = self._lw[None, :]
        g = response * lw
        h = absr * (sigmoid - absr) * lw
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid:g}"


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """max, exp, sum, divide, written out as JAX's `softmax` is (the
    fused torch.softmax rounds differently)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=dim, keepdim=True)


def _class_onehot(label_int: torch.Tensor, K: int) -> torch.Tensor:
    """[K, N] bool: row k marks the rows whose label is k."""
    k = torch.arange(K, dtype=label_int.dtype, device=label_int.device)
    return k[:, None] == label_int[None, :]


class MulticlassSoftmax(Objective):
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = config.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label).astype(np.int32)
        if lab.min() < 0 or lab.max() >= self.num_class:
            raise ValueError(
                f"Label must be in [0, {self.num_class}) for multiclass")
        self._onehot = _class_onehot(torch.as_tensor(lab, device=device),
                                     self.num_class)

    def get_gradients(self, score):
        p = softmax(score, dim=0)                           # [K, N]
        g = p - self._onehot.to(p.dtype)
        h = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def convert_output(self, score):
        e = np.exp(score - score.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def to_string(self):
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(Objective):
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_tree_per_iteration = config.num_class
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lab = torch.as_tensor(np.asarray(metadata.label).astype(np.int32),
                              device=device)
        one = torch.ones((), dtype=torch.float32, device=device)
        self._lbl = torch.where(_class_onehot(lab, self.num_class), one,
                                -one)

    def get_gradients(self, score):
        sigmoid = self.sigmoid
        lbl = self._lbl
        response = -lbl * sigmoid / (1.0 + torch.exp(lbl * sigmoid * score))
        absr = torch.abs(response)
        g = response
        h = absr * (sigmoid - absr)
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g, h

    def convert_output(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def to_string(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")


class LambdarankNDCG(Objective):
    """LambdaRank with NDCG deltas over query groups.  The per-query
    pairwise loop is a padded [Q, D, D] masked computation, chunked over
    queries (qc queries per chunk, as in JAX, so the f32 sums associate
    alike).  Documents sort by score with a stable sort on -score, pad
    slots at -inf — JAX's stable argsort."""
    name = "lambdarank"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError("Lambdarank tasks require query information")
        qb = np.asarray(metadata.query_boundaries, np.int64)
        Q = len(qb) - 1
        sizes = np.diff(qb)
        D = int(sizes.max())
        j = np.arange(D)
        valid = j[None, :] < sizes[:, None]                     # [Q, D]
        doc_idx = np.where(valid, qb[:-1, None] + j[None, :],
                           num_data).astype(np.int64)
        gains = self.config.label_gain
        if not gains:
            gains = tuple(float(2 ** i - 1) for i in range(31))
        label_gain = np.asarray(gains, np.float64)
        lab = np.asarray(metadata.label).astype(np.int32)
        # inverse max DCG per query at max_position (labels sorted
        # descending, as the reference's CalMaxDCG)
        k = self.config.max_position
        discount = 1.0 / np.log2(2.0 + np.arange(D))
        lab_pad_np = np.concatenate([lab, [0]])
        lab_mat = np.where(valid, lab_pad_np[doc_idx], -1)
        lab_sorted = -np.sort(-lab_mat, axis=1)[:, :k]
        g_sorted = np.where(lab_sorted >= 0,
                            label_gain[np.maximum(lab_sorted, 0)], 0.0)
        md = (g_sorted * discount[None, : g_sorted.shape[1]]).sum(axis=1)
        inv_max_dcg = np.where(md > 0, 1.0 / np.maximum(md, 1e-300), 0.0)
        qc = max(1, min(Q, (1 << 24) // max(D * D, 1)))
        Qp = qc * ((Q + qc - 1) // qc)
        if Qp > Q:
            doc_idx = np.pad(doc_idx, ((0, Qp - Q), (0, 0)),
                             constant_values=num_data)
            inv_max_dcg = np.pad(inv_max_dcg, (0, Qp - Q))
        self._q_chunk = qc
        self._doc_idx = torch.as_tensor(doc_idx, device=device)
        self._mask = self._doc_idx < num_data
        self._inv_max_dcg = torch.as_tensor(
            inv_max_dcg.astype(np.float32), device=device)
        self._label_gain = torch.as_tensor(label_gain.astype(np.float32),
                                           device=device)
        self._n_gain = label_gain.size
        self._discount = torch.as_tensor(discount.astype(np.float32),
                                         device=device)
        self._lab_pad = torch.as_tensor(lab_pad_np.astype(np.int64),
                                        device=device)

    def get_gradients(self, score):
        sigmoid = float(self.config.sigmoid)
        N = self.num_data
        dev = score.device
        s1 = score[0]
        s_pad = torch.cat([s1, torch.zeros(1, dtype=s1.dtype, device=dev)])
        # one slot past the sentinel doc N collects the pad slots' adds
        g_flat = torch.zeros(N + 1, dtype=s1.dtype, device=dev)
        h_flat = torch.zeros(N + 1, dtype=s1.dtype, device=dev)
        neg_inf = torch.full((), -np.inf, dtype=s1.dtype, device=dev)
        zero = torch.zeros((), dtype=s1.dtype, device=dev)
        qc = self._q_chunk
        for c0 in range(0, self._doc_idx.shape[0], qc):
            didx = self._doc_idx[c0:c0 + qc]                    # [qc, D]
            msk = self._mask[c0:c0 + qc]
            imd = self._inv_max_dcg[c0:c0 + qc]
            sc = torch.where(msk, s_pad[didx], neg_inf)
            lb = self._lab_pad[didx]
            # + 0.0: -0.0 ties +0.0 in CUDA's radix sort, as in JAX's
            order = torch.argsort(-sc + 0.0, dim=1, stable=True)
            sc_s = torch.gather(sc, 1, order)
            lb_s = torch.gather(lb, 1, order)
            msk_s = torch.gather(msk, 1, order)
            gain_s = self._label_gain[torch.clamp(lb_s, 0,
                                                  self._n_gain - 1)]
            Dq = sc_s.shape[1]
            best = sc_s[:, 0]
            cnt = msk_s.sum(dim=1)
            worst = torch.gather(sc_s, 1, torch.clamp(cnt - 1, min=0)[:, None]
                                 )[:, 0]
            ds = sc_s[:, :, None] - sc_s[:, None, :]
            valid = (msk_s[:, :, None] & msk_s[:, None, :]
                     & (lb_s[:, :, None] > lb_s[:, None, :]))
            dcg_gap = gain_s[:, :, None] - gain_s[:, None, :]
            disc = self._discount[:Dq]
            paired_disc = torch.abs(disc[None, :, None] - disc[None, None, :])
            delta = dcg_gap * paired_disc * imd[:, None, None]
            norm = torch.where((best != worst)[:, None, None],
                               0.01 + torch.abs(ds),
                               torch.ones((), dtype=s1.dtype, device=dev))
            delta = delta / norm
            p_lambda = 2.0 / (1.0 + torch.exp(2.0 * sigmoid * ds))
            p_hess = p_lambda * (2.0 - p_lambda)
            p_lambda = torch.where(valid, -p_lambda * delta, zero)
            p_hess = torch.where(valid, p_hess * 2.0 * delta, zero)
            lam_s = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
            hes_s = p_hess.sum(dim=2) + p_hess.sum(dim=1)
            docs = torch.gather(didx, 1, order).reshape(-1)
            g_flat.index_add_(0, docs, lam_s.reshape(-1))
            h_flat.index_add_(0, docs, hes_s.reshape(-1))
        g, h = g_flat[:N], h_flat[:N]
        if self.weights is not None:
            g = g * self.weights
            h = h * self.weights
        return g[None, :], h[None, :]


def create_objective(config: Config) -> Objective:
    table = {
        "regression": RegressionL2,
        "regression_l1": RegressionL1,
        "huber": RegressionHuber,
        "fair": RegressionFair,
        "poisson": RegressionPoisson,
        "binary": BinaryLogloss,
        "multiclass": MulticlassSoftmax,
        "multiclassova": MulticlassOVA,
        "lambdarank": LambdarankNDCG,
    }
    if config.objective not in table:
        raise ValueError(f"unknown objective: {config.objective}")
    return table[config.objective](config)


def objective_from_model_string(s: str, config: Config) -> Objective:
    """Recreate an objective from its model-file ToString() form
    (objective_function.cpp:33-57)."""
    toks = s.split()
    name = toks[0]
    kw = {}
    for t in toks[1:]:
        if ":" in t:
            k, v = t.split(":", 1)
            kw[k] = v
    cfg = config
    if "num_class" in kw:
        cfg = cfg.with_updates(num_class=int(kw["num_class"]))
    if "sigmoid" in kw:
        cfg = cfg.with_updates(sigmoid=float(kw["sigmoid"]))
    cfg = cfg.with_updates(objective=name)
    return create_objective(cfg)
