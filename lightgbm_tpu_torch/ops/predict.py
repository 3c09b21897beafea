"""Ensemble prediction on the device.

Port of lightgbm_tpu/ops/predict.py.  The reference predicts row by row
with a pointer-chasing node walk; here every row advances one tree level
a step, all rows and all trees at once, with gathers instead of pointer
dereferences.  The JAX package runs the walk in XLA (`take_along_axis`,
`where` and `segment_sum` in a `fori_loop`) and reaches no Pallas
kernel, so the port runs it as plain PyTorch ops on the stack's device:
the `fori_loop` becomes a Python loop over `meta.depth` levels, with no
read back to the host inside it.

Two kernels, selected by ``predict_kernel``:

- ``walk``: one `TreeStack` a class (`stack_trees`, `predict_trees`,
  `ensemble_raw`);
- ``tensorized`` (what ``auto`` resolves to): every tree of every class
  in one padded ``[T, nodes]`` stack, `depth` levels for the whole
  ensemble.  Shallow numerical ensembles take the perfect layout
  (`PerfectEnsemble`: arithmetic navigation, no child gathers), others
  the general SoA (`EnsembleStack`).  Variants walk the binned training
  store (the whole-model replay of `ScoreUpdater.add_trees`, dense or
  sparse, EFB remap included), ingress-quantized request buffers
  (`predict_ensemble_quantized`, serve_quantize=binned), and co-stacked
  tenants (`predict_ensemble_grouped*`).

Layout: stacks are NamedTuples of host numpy arrays when built
(`build_ensemble`, `stack_ensemble`, ...) and of tensors on one device
after `to_device`, which the predictors take.  Where the JAX stack packs
a node's five fields into one trailing record lane (one TPU gather a
level), the port keeps one array a field, each gathered with
`torch.gather`: child and feature ids are int64 (the gather index type),
raw thresholds f32, binned thresholds int32.  The JAX package narrows
binned records to int16 on a TPU only (`_maybe_narrow`); the port keeps
int32 records on every device (a narrower record is performance work).

The per-class sum.  Three contracts hold inside the port, on every
device: binned serving equals raw serving, grouped (co-stacked) scoring
equals per-tenant dispatch, and a server's answers equal
`predict_ensemble_any`.  Each needs the sum over a class's trees to add
the same values in the same order whatever the batch's row count, the
slice's offset in a super-stack, or the padding of a segment walk.
`torch.sum` over the tree axis does not promise that: its CUDA reduction
picks its split of the reduced axis by the output count and the
pointer's alignment, and a co-stacked batch has another row count than
a tenant's own.  So every tree sum here is `_tree_sum`: pairwise sums
of adjacent trees (t0 + t1, t2 + t3, ...), level after level, with the
tree axis padded by -0.0 to a power of two.  Each level is one
elementwise add, so the order is fixed by the tree count alone, and a
tail of -0.0 (the exact identity of IEEE addition) changes no bit, so a
segment walk's padded slots add nothing.  It takes log2(T) launches
where a sequential loop over trees would take T.  Sums over the same
trees are therefore bitwise equal across the walk and tensorized
kernels, the perfect and SoA layouts, and grouped and solo dispatch, on
any leaf values.  Against the JAX package they are bitwise on dyadic
leaf values and otherwise within T * 2^-23 * sum|leaf| a row (XLA's CPU
reduction order is not reproduced).  Leaf indices are bitwise equal to
the JAX package's: the same f32 values meet the same f32 thresholds.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import COSTACK_KERNELS, PREDICT_KERNELS


def resolve_predict_kernel(kernel: str = "auto") -> str:
    """Resolve the ``predict_kernel`` dial: ``auto`` picks
    ``tensorized`` (depth steps for the whole ensemble); ``walk`` stays
    reachable as the per-class baseline."""
    if kernel not in PREDICT_KERNELS:
        raise ValueError(f"unknown predict_kernel: {kernel!r}; "
                         f"use one of {PREDICT_KERNELS}")
    return "tensorized" if kernel == "auto" else kernel


# total stacked trees above which `auto` takes the segment-gathered
# grouped walk on a GPU (the `costack_segment_trees` Config default)
COSTACK_SEGMENT_TREES = 4096


def resolve_costack_kernel(kernel: str = "auto", *, total_trees: int = 0,
                           segment_trees: int = 0,
                           device_type: str = "cuda") -> str:
    """Resolve the ``costack_kernel`` dial to a grouped traversal.

    ``auto`` picks ``segment`` on the CPU (node math scales with the
    trees walked, so walking every tenant's trees costs ~G x a solo
    tenant) and on a GPU once the group's stacked tree count reaches the
    switch point; ``stacked`` otherwise.  Both are bitwise equal to
    per-tenant dispatch, so the dial is a cost model only.
    ``segment_trees`` (<= 0: COSTACK_SEGMENT_TREES) is the Config key
    ``costack_segment_trees``; the LIGHTGBM_TPU_COSTACK_SEGMENT_TREES
    environment variable, read here, wins over both.  ``device_type`` is
    the replicas' device type (the JAX package asks the default
    backend)."""
    if kernel not in COSTACK_KERNELS:
        raise ValueError(f"unknown costack_kernel: {kernel!r}; "
                         f"use one of {COSTACK_KERNELS}")
    if kernel != "auto":
        return kernel
    thresh = int(segment_trees) if segment_trees and segment_trees > 0 \
        else COSTACK_SEGMENT_TREES
    env = os.environ.get("LIGHTGBM_TPU_COSTACK_SEGMENT_TREES")
    if env:
        try:
            thresh = max(1, int(env))
        except ValueError:
            raise ValueError(
                "LIGHTGBM_TPU_COSTACK_SEGMENT_TREES must be an integer, "
                f"got {env!r}")
    if device_type != "cuda":
        return "segment"
    return "segment" if total_trees >= thresh else "stacked"


def to_device(stack, device):
    """A stack NamedTuple (host numpy, as built) as tensors on `device`;
    None stays None (an untrained class of the walk kernel)."""
    if stack is None:
        return None
    return type(stack)(*(torch.as_tensor(np.ascontiguousarray(a),
                                         device=device) for a in stack))


def _tree_sum(vals: torch.Tensor) -> torch.Tensor:
    """[L, N] -> [N]: the fixed-order pairwise sum over the tree axis of
    the module docstring (-0.0 padding to a power of two, then adjacent
    pairs level by level).  An empty axis sums to +0.0."""
    L, N = vals.shape
    if L == 0:
        return vals.new_zeros(N)
    P = 1 << (L - 1).bit_length()
    if P != L:
        vals = torch.cat([vals, vals.new_full((P - L, N), -0.0)])
    while vals.shape[0] > 1:
        vals = vals[0::2] + vals[1::2]
    return vals[0]


def _class_sums(vals: torch.Tensor, class_segments) -> torch.Tensor:
    """[K, N] per-class sums over the class-major tree slices of `vals`
    ([T, N]); a class with no trees stays +0.0."""
    return torch.stack([_tree_sum(vals[a:b]) for a, b in class_segments])


def _class_segments(cls: np.ndarray, num_class: int, base: int = 0):
    """((start, stop), ...) tree bounds of each class in a class-major
    [T] class-id array, offset by `base`."""
    cls = np.asarray(cls)
    return tuple((base + int(np.searchsorted(cls, k, "left")),
                  base + int(np.searchsorted(cls, k, "right")))
                 for k in range(num_class))


# ----------------------------------------------------------------------
# the walk kernel (predict_kernel=walk)
# ----------------------------------------------------------------------

class TreeStack(NamedTuple):
    """One class's trees as stacked flat-node arrays, padded to the
    widest tree.  Children as in tree.h: internal >= 0, leaves ~leaf."""
    split_feature: object      # [T, M-1] int64 (raw index, or inner)
    threshold: object          # [T, M-1] f32 (raw value, or bin id)
    decision_type: object      # [T, M-1] int32 (0 numerical, 1 categorical)
    left_child: object         # [T, M-1] int64
    right_child: object        # [T, M-1] int64
    leaf_value: object         # [T, M] f32
    num_leaves: object         # [T] int64


def stack_trees(trees, binned: bool) -> TreeStack:
    """Stack host Tree objects into one padded TreeStack (host numpy)."""
    m = max(max(t.max_leaves for t in trees), 2)
    T = len(trees)
    sf = np.zeros((T, m - 1), np.int64)
    th = np.zeros((T, m - 1), np.float32)
    dc = np.zeros((T, m - 1), np.int32)
    lc = np.full((T, m - 1), -1, np.int64)
    rc = np.full((T, m - 1), -1, np.int64)
    lv = np.zeros((T, m), np.float32)
    nl = np.zeros(T, np.int64)
    for i, t in enumerate(trees):
        n = t.num_leaves
        nl[i] = n
        lv[i, :n] = t.leaf_value[:n]
        if n < 2:
            continue
        k = n - 1
        sf[i, :k] = (t.split_feature_inner[:k] if binned
                     else t.split_feature[:k])
        th[i, :k] = (t.threshold_in_bin[:k].astype(np.float32) if binned
                     else t.threshold[:k].astype(np.float32))
        dc[i, :k] = t.decision_type[:k]
        lc[i, :k] = t.left_child[:k]
        rc[i, :k] = t.right_child[:k]
    return TreeStack(sf, th, dc, lc, rc, lv, nl)


def _cat_decide(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The categorical test: int truncation behind a finite mask (a bare
    int cast of NaN is backend-defined and could match category 0)."""
    finite = torch.isfinite(v)
    vi = torch.where(finite, v, -1.0).to(torch.int32)
    return finite & (vi == t.to(torch.int32))


def predict_trees(stack: TreeStack, X: torch.Tensor, *,
                  depth: int) -> torch.Tensor:
    """Sum of one class's tree outputs for every row: [N] f32.  X is
    [N, F] (binned ids or raw values, as the stack was built); `depth`
    bounds the levels walked."""
    XT = X.to(torch.float32).t().contiguous()
    T = stack.split_feature.shape[0]
    N = XT.shape[1]
    n0 = torch.where(stack.num_leaves < 2, -1, 0)
    node = n0[:, None].expand(T, N).contiguous()
    for _ in range(depth):
        safe = node.clamp(min=0)
        v = torch.gather(XT, 0, torch.gather(stack.split_feature, 1, safe))
        t = torch.gather(stack.threshold, 1, safe)
        cat = torch.gather(stack.decision_type, 1, safe) == 1
        gl = torch.where(cat, _cat_decide(v, t), v <= t)
        nxt = torch.where(gl, torch.gather(stack.left_child, 1, safe),
                          torch.gather(stack.right_child, 1, safe))
        node = torch.where(node >= 0, nxt, node)
    leaf = torch.where(node < 0, ~node, 0)
    return _tree_sum(torch.gather(stack.leaf_value, 1, leaf))


def ensemble_raw(stacks, X: torch.Tensor, *, depths) -> torch.Tensor:
    """Raw per-class scores of a multi-class ensemble: [K, N] f32.
    `stacks` holds one TreeStack a class, or None for an untrained class
    (its row stays 0); `depths` the matching walk depths."""
    N = X.shape[0]
    outs = []
    for stack, depth in zip(stacks, depths):
        if stack is None:
            outs.append(torch.zeros(N, dtype=torch.float32,
                                    device=X.device))
        else:
            outs.append(predict_trees(stack, X, depth=depth))
    return torch.stack(outs)


# ----------------------------------------------------------------------
# the tensorized traversal (predict_kernel=tensorized)
# ----------------------------------------------------------------------

class EnsembleStack(NamedTuple):
    """Every tree of every class as one padded [T, nodes] SoA, flattened
    class-major (class 0's trees in boosting order, then class 1's, ...),
    so `class_id` is sorted.  Raw stacks hold (raw feature, f32 value)
    thresholds; binned ones (inner feature, int32 bin)."""
    feature: object        # [T, M-1] int64
    threshold: object      # [T, M-1] f32 raw / int32 binned
    decision: object       # [T, M-1] int32: 1 categorical
    left: object           # [T, M-1] int64
    right: object          # [T, M-1] int64
    leaf_value: object     # [T, M] f32
    root: object           # [T] int64: 0, or -1 for stumps (leaf 0)
    class_id: object       # [T] int64, sorted ascending


class PerfectEnsemble(NamedTuple):
    """Shallow numerical ensembles re-laid out as perfect binary trees of
    the ensemble depth D: the next node is ``2 * node + 1 + go_right``,
    so the walk needs no child gathers and no parked-row select.  A leaf
    grown above the last level fills every last-level slot below it with
    its value in both value lanes; the last level's records carry both
    child leaf values.  Binned stacks put the inner feature and the
    in-bin threshold in the same lanes (bin ids < 2^24 are exact in f32,
    so the f32 compare is the integer compare)."""
    inner_feature: object      # [T, max(2^(D-1) - 1, 1)] int64
    inner_threshold: object    # [T, max(2^(D-1) - 1, 1)] f32
    last_feature: object       # [T, 2^(D-1)] int64
    last_threshold: object     # [T, 2^(D-1)] f32
    left_value: object         # [T, 2^(D-1)] f32
    right_value: object        # [T, 2^(D-1)] f32
    class_id: object           # [T] int64, sorted ascending


class EnsembleMeta(NamedTuple):
    """Host-side companions of an ensemble stack.  `class_segments`
    (each class's (start, stop) trees) is the port's addition: the class
    sums slice by it without reading class_id back from the device."""
    depth: int             # levels to walk (max grown depth, >= 1)
    num_class: int         # K: rows of the [K, N] output
    any_cat: bool          # the ensemble has categorical splits
    class_segments: tuple  # ((start, stop), ...) per class


class GroupMeta(NamedTuple):
    """Host-side companions of a co-stacked SUPER-STACK: tenants'
    ensembles concatenated along the tree axis (tenant-major, each
    tenant's trees class-major as in its solo stack).  ``segments[g]``
    bounds tenant g's trees and ``class_segments[g]`` its classes'
    trees, so each tenant's sums run over exactly the trees, in the
    order, of its solo stack: grouped scoring is bitwise per-tenant
    dispatch."""
    depth: int             # levels to walk (max over every tenant)
    num_class: int         # K, shared by every tenant of the group
    any_cat: bool          # any tenant has categorical splits
    segments: tuple        # ((start, stop), ...) per tenant
    class_segments: tuple  # per tenant, ((start, stop), ...) per class


# perfect relayout budget: total value-slab slots (T * 2^depth) above
# which the padded SoA takes over; the north-star 500-tree depth-8 shape
# takes 128k slots
PERFECT_SLOT_BUDGET = 1 << 22


def _ensemble_shape(flat, binned: bool):
    """(max-capacity leaves, walk depth, any_cat) over a class-major
    [(class, tree)] flatten, shared by `build_ensemble`'s layout choice
    and the stacks' meta.  Binned stacks test `binned_decision_type`
    (trivial-feature categorical splits rebin to numerical sentinels)."""
    m = max(max(t.max_leaves for _, t in flat), 2)
    depth = 1
    any_cat = False
    for _, t in flat:
        if t.num_leaves < 2:
            continue
        depth = max(depth, t.max_depth_grown)
        k = t.num_leaves - 1
        dec = (getattr(t, "binned_decision_type", t.decision_type)
               if binned else t.decision_type)
        any_cat = any_cat or bool(np.any(dec[:k] == 1))
    return m, max(int(depth), 1), any_cat


def _flatten(trees_by_class):
    return [(k, t) for k, trees in enumerate(trees_by_class) for t in trees]


def build_ensemble(trees_by_class, *, binned: bool = False,
                   layout: str = "auto"):
    """The tensorized-traversal stack of a whole model: ``(stack,
    meta)``, a PerfectEnsemble (shallow numerical ensembles within
    PERFECT_SLOT_BUDGET) or the general EnsembleStack, both host numpy;
    `to_device` places them.  `predict_ensemble_any` dispatches on the
    type."""
    num_class = len(trees_by_class)
    flat = _flatten(trees_by_class)
    if not flat:
        raise ValueError("build_ensemble needs at least one tree")
    shape = _ensemble_shape(flat, binned)
    _, depth, any_cat = shape
    if layout not in ("auto", "perfect", "soa"):
        raise ValueError(f"unknown ensemble layout: {layout!r}")
    if layout == "auto":
        fits = len(flat) << depth <= PERFECT_SLOT_BUDGET
        layout = "perfect" if fits and not any_cat else "soa"
    if layout == "perfect":
        if any_cat:
            raise ValueError("perfect layout supports numerical "
                             "ensembles only")
        cls = np.asarray([k for k, _ in flat], np.int64)
        meta = EnsembleMeta(depth=depth, num_class=num_class,
                            any_cat=any_cat,
                            class_segments=_class_segments(cls, num_class))
        return _build_perfect(flat, meta, binned=binned)
    return stack_ensemble(trees_by_class, binned=binned, _shape=shape)


def _build_perfect(flat, meta: EnsembleMeta, binned: bool = False
                   ) -> tuple:
    D = meta.depth
    T = len(flat)
    half = 1 << (D - 1)
    inner = np.zeros((T, max(half - 1, 1), 2), np.float32)
    last = np.zeros((T, half, 4), np.float32)
    cls = np.zeros(T, np.int64)
    for i, (k, t) in enumerate(flat):
        cls[i] = k
        sf = t.split_feature_inner if binned else t.split_feature
        th = t.threshold_in_bin if binned else t.threshold
        if t.num_leaves < 2:                 # stump: one giant filler
            last[i, :, 2] = last[i, :, 3] = np.float32(t.leaf_value[0])
            continue
        # heap-order fill; a leaf met above the last level replicates its
        # value across every last-level slot it covers
        stack = [(0, 0, 0)]                  # (tree node, heap slot, level)
        while stack:
            node, slot, lvl = stack.pop()
            if lvl == D - 1:                 # last level: fuse child values
                local = slot - (half - 1)
                if node < 0:
                    v = np.float32(t.leaf_value[~node])
                    last[i, local, 2] = last[i, local, 3] = v
                else:
                    lc = int(t.left_child[node])
                    rc = int(t.right_child[node])
                    last[i, local, 0] = sf[node]
                    last[i, local, 1] = np.float32(th[node])
                    last[i, local, 2] = np.float32(t.leaf_value[~lc])
                    last[i, local, 3] = np.float32(t.leaf_value[~rc])
                continue
            if node < 0:                     # early leaf: filler subtree
                lo = (slot - ((1 << lvl) - 1)) << (D - 1 - lvl)
                hi = lo + (1 << (D - 1 - lvl))
                v = np.float32(t.leaf_value[~node])
                last[i, lo:hi, 2] = last[i, lo:hi, 3] = v
                continue
            inner[i, slot, 0] = sf[node]
            inner[i, slot, 1] = np.float32(th[node])
            stack.append((int(t.left_child[node]), 2 * slot + 1, lvl + 1))
            stack.append((int(t.right_child[node]), 2 * slot + 2, lvl + 1))
    stack = PerfectEnsemble(
        inner_feature=inner[..., 0].astype(np.int64),
        inner_threshold=np.ascontiguousarray(inner[..., 1]),
        last_feature=last[..., 0].astype(np.int64),
        last_threshold=np.ascontiguousarray(last[..., 1]),
        left_value=np.ascontiguousarray(last[..., 2]),
        right_value=np.ascontiguousarray(last[..., 3]),
        class_id=cls)
    return stack, meta


def stack_ensemble(trees_by_class, *, binned: bool, _shape=None) -> tuple:
    """Flatten per-class host Tree lists into one EnsembleStack (host
    numpy).  A class with no trees has no stack rows and its output row
    stays 0.  Stumps ride along as root=-1 rows whose leaf 0 carries the
    constant."""
    num_class = len(trees_by_class)
    flat = _flatten(trees_by_class)
    if not flat:
        raise ValueError("stack_ensemble needs at least one tree")
    m, depth, any_cat = _shape or _ensemble_shape(flat, binned)
    stack = _fill_stack(flat, m, binned)
    meta = EnsembleMeta(depth=depth, num_class=num_class, any_cat=any_cat,
                        class_segments=_class_segments(stack.class_id,
                                                       num_class))
    return stack, meta


def _fill_stack(flat, m: int, binned: bool) -> EnsembleStack:
    """The node/leaf fill over a class-major [(class, tree)] flatten,
    shared by `stack_ensemble` and `stack_ensemble_group`, so a solo
    stack and a super-stack cannot encode one tree differently."""
    T = len(flat)
    feat = np.zeros((T, m - 1), np.int64)
    thr = np.zeros((T, m - 1), np.int32 if binned else np.float32)
    dec = np.zeros((T, m - 1), np.int32)
    left = np.zeros((T, m - 1), np.int64)
    right = np.zeros((T, m - 1), np.int64)
    lv = np.zeros((T, m), np.float32)
    root = np.zeros(T, np.int64)
    cls = np.zeros(T, np.int64)
    for i, (k, t) in enumerate(flat):
        n = t.num_leaves
        cls[i] = k
        lv[i, :n] = t.leaf_value[:n]
        if n < 2:
            root[i] = -1                     # stump: every row is leaf 0
            continue
        kn = n - 1
        if binned:
            feat[i, :kn] = t.split_feature_inner[:kn]
            thr[i, :kn] = t.threshold_in_bin[:kn]
            dec[i, :kn] = getattr(t, "binned_decision_type",
                                  t.decision_type)[:kn]
        else:
            feat[i, :kn] = t.split_feature[:kn]
            thr[i, :kn] = t.threshold[:kn].astype(np.float32)
            dec[i, :kn] = t.decision_type[:kn]
        left[i, :kn] = t.left_child[:kn]
        right[i, :kn] = t.right_child[:kn]
    return EnsembleStack(feat, thr, dec, left, right, lv, root, cls)


def stack_ensemble_group(members, *, binned: bool = False) -> tuple:
    """Co-stack tenants' ensembles into ONE super-stack.

    ``members`` holds per-tenant ``trees_by_class`` lists, all with the
    same class count.  Trees flatten tenant-major (each tenant's exactly
    in its solo stack order) into one padded [T_total, nodes] SoA.  Node
    records pad to the widest tree of the group and the walk runs to the
    deepest tenant's depth: a parked row stays parked through surplus
    levels, so padding changes no routing decision."""
    if not members:
        raise ValueError("stack_ensemble_group needs at least one member")
    ks = {len(tbc) for tbc in members}
    if len(ks) != 1:
        raise ValueError("co-stacked members must share num_class "
                         f"(got {sorted(ks)})")
    num_class = ks.pop()
    flat = []
    segments = []
    for tbc in members:
        start = len(flat)
        flat.extend(_flatten(tbc))
        if len(flat) == start:
            raise ValueError("every co-stacked member needs at least "
                             "one tree")
        segments.append((start, len(flat)))
    m, depth, any_cat = _ensemble_shape(flat, binned)
    stack = _fill_stack(flat, m, binned)
    class_segments = tuple(
        _class_segments(stack.class_id[a:b], num_class, base=a)
        for a, b in segments)
    meta = GroupMeta(depth=depth, num_class=num_class, any_cat=any_cat,
                     segments=tuple(segments),
                     class_segments=class_segments)
    return stack, meta


def _leaf_values(stack: EnsembleStack, node: torch.Tensor) -> torch.Tensor:
    """[T, N] leaf values the walk parked on."""
    leaf = torch.where(node < 0, ~node, 0)
    return torch.gather(stack.leaf_value, 1, leaf)


def _leaf_sums(stack: EnsembleStack, node: torch.Tensor,
               meta: EnsembleMeta) -> torch.Tensor:
    """[K, N] per-class sums of the leaf values the [T, N] walk parked
    on, each class over its own trees in stack order (`_tree_sum`)."""
    return _class_sums(_leaf_values(stack, node), meta.class_segments)


def _raw_decide(stack: EnsembleStack, safe: torch.Tensor, v: torch.Tensor,
                any_cat: bool) -> torch.Tensor:
    """Go-left mask of the nodes `safe` over their gathered raw feature
    values — the routing decision shared by the full-stack walk and the
    segment walk, so the two cannot disagree: numerical ``v <= t`` (NaN
    falls right), categorical int truncation behind a finite mask."""
    t = _node_field(stack.threshold, safe)
    gl = v <= t
    if any_cat:
        cat = _node_field(stack.decision, safe) > 0
        gl = torch.where(cat, _cat_decide(v, t), gl)
    return gl


def _binned_decide(stack: EnsembleStack, safe: torch.Tensor,
                   bv: torch.Tensor, any_cat: bool) -> torch.Tensor:
    """Go-left mask of binned nodes over gathered bin ids: integer
    compares end to end (same contract as `_raw_decide`)."""
    t = _node_field(stack.threshold, safe)
    if any_cat:
        cat = _node_field(stack.decision, safe) == 1
        return torch.where(cat, bv == t, bv <= t)
    return bv <= t


def _node_field(field: torch.Tensor, safe) -> torch.Tensor:
    """A node field at the [T, N] node ids `safe` (tree axis broadcast),
    or at the (tree, node) pairs of a segment walk (`safe` a tuple)."""
    if isinstance(safe, tuple):
        tree, nd = safe
        return field[tree, nd]
    return torch.gather(field, 1, safe)


def _step_nodes(stack: EnsembleStack, node: torch.Tensor, safe,
                gl: torch.Tensor) -> torch.Tensor:
    nxt = torch.where(gl, _node_field(stack.left, safe),
                      _node_field(stack.right, safe))
    return torch.where(node >= 0, nxt, node)


def _root_nodes(stack: EnsembleStack, N: int) -> torch.Tensor:
    T = stack.root.shape[0]
    return stack.root[:, None].expand(T, N).contiguous()


def _walk_raw_nodes(stack: EnsembleStack, XT: torch.Tensor,
                    meta) -> torch.Tensor:
    """The raw-feature ensemble walk: the parked node of every (tree,
    row), [T, N] int64 with leaves as ~leaf, over XT, the [F, N] f32
    transposed input.  Shared by the value kernel, the leaf-index kernel
    and the grouped kernel, so they cannot disagree on a route."""
    node = _root_nodes(stack, XT.shape[1])
    for _ in range(meta.depth):
        safe = node.clamp(min=0)
        v = torch.gather(XT, 0, _node_field(stack.feature, safe))
        gl = _raw_decide(stack, safe, v, meta.any_cat)
        node = _step_nodes(stack, node, safe, gl)
    return node


def _raw_input(X: torch.Tensor) -> torch.Tensor:
    """[N, F] raw rows -> [F, N] f32, the layout the walks gather from:
    ``torch.gather(XT, 0, f)[t, n] = XT[f[t, n], n]``, the value each
    (tree, row) pair's node names."""
    return X.to(torch.float32).t().contiguous()


def predict_ensemble(stack: EnsembleStack, X: torch.Tensor, *,
                     meta: EnsembleMeta) -> torch.Tensor:
    """Raw per-class scores over raw feature values X [N, F]: [K, N]
    f32.  All N rows x T trees advance one level a step: `meta.depth`
    steps for the whole ensemble."""
    return _leaf_sums(stack, _walk_raw_nodes(stack, _raw_input(X), meta),
                      meta)


def predict_ensemble_perfect(stack: PerfectEnsemble, X: torch.Tensor, *,
                             meta: EnsembleMeta) -> torch.Tensor:
    """Raw per-class scores through the perfect layout: [K, N] f32.  A
    level is one record gather, one feature gather and a compare; the
    root level is a broadcast; the last level's records carry both leaf
    values.  X is raw values, or bin ids for a binned stack."""
    XT = _raw_input(X)
    T = stack.class_id.shape[0]
    N = XT.shape[1]
    D = meta.depth
    if D == 1:
        local = torch.zeros((T, N), dtype=torch.int64, device=XT.device)
    else:
        # level 0: every row is at the root
        gl = XT[stack.inner_feature[:, 0]] <= stack.inner_threshold[:, 0:1]
        node = 2 - gl.to(torch.int64)
        for _ in range(1, D - 1):
            v = torch.gather(XT, 0, torch.gather(stack.inner_feature, 1, node))
            gl = v <= torch.gather(stack.inner_threshold, 1, node)
            node = 2 * node + 2 - gl.to(torch.int64)
        local = node - ((1 << (D - 1)) - 1)
    v = torch.gather(XT, 0, torch.gather(stack.last_feature, 1, local))
    gl = v <= torch.gather(stack.last_threshold, 1, local)
    vals = torch.where(gl, torch.gather(stack.left_value, 1, local),
                       torch.gather(stack.right_value, 1, local))
    return _class_sums(vals, meta.class_segments)


def predict_ensemble_any(stack, X: torch.Tensor, *,
                         meta: EnsembleMeta) -> torch.Tensor:
    """Layout dispatch: PerfectEnsemble or EnsembleStack."""
    if isinstance(stack, PerfectEnsemble):
        return predict_ensemble_perfect(stack, X, meta=meta)
    return predict_ensemble(stack, X, meta=meta)


def sparse_bin_lookup(cols: torch.Tensor, binsv: torch.Tensor,
                      zero_bin: torch.Tensor,
                      col: torch.Tensor) -> torch.Tensor:
    """Store bin id per requested column, read off the ELL row entries:
    a stored (column, bin) entry answers directly, every other request
    the column's zero bin (clamped at 0).

    cols/binsv [N, R] int ELL entries (a column >= C marks an empty slot
    and never matches a request); zero_bin [C] int32 (-1 only on padded
    columns no tree names); col [..., N] int requested store columns.
    Returns [..., N] int32.  The valid-set walk, the sparse row
    partition and the sparse replay share it."""
    hit = cols == col[..., None]                            # [..., N, R]
    bv = torch.where(hit, binsv.to(torch.int32),
                     torch.zeros((), dtype=torch.int32,
                                 device=cols.device)).sum(
                                     dim=-1, dtype=torch.int32)
    C = zero_bin.shape[0]
    zb = torch.clamp(zero_bin[torch.clamp(col, 0, C - 1).long()], min=0)
    return torch.where(hit.any(dim=-1), bv, zb).to(torch.int32)


def _bin_reader(bins):
    """col [T, N] -> bin ids [T, N] int32 from a binned store: the
    dense [C, N] store (int32, or int8 bytes holding value - 128, the
    rounds learner's), or the sparse ELL triple (cols, bins, zero_bin)."""
    if isinstance(bins, (tuple, list)):
        cols, binsv, zero_bin = bins
        return lambda c: sparse_bin_lookup(cols, binsv, zero_bin, c)
    if bins.dtype == torch.int8:
        return lambda c: torch.gather(bins, 0, c).to(torch.int32) + 128
    return lambda c: torch.gather(bins, 0, c).to(torch.int32)


def _num_rows(bins) -> int:
    if isinstance(bins, (tuple, list)):
        return bins[0].shape[0]
    return bins.shape[1]


def _walk_binned_nodes(stack: EnsembleStack, bins,
                       feat_tbl: Optional[torch.Tensor],
                       meta) -> torch.Tensor:
    """The binned ensemble walk: the parked node of every (tree, row),
    [T, N] int64, leaves as ~leaf, over a store (`_bin_reader`).  Shared
    by the score replay, the leaf router and the serving request path,
    so they cannot disagree on a route.  `feat_tbl` ([5, F]: column,
    offset, default, nslots, packed) maps each node's original feature
    onto its EFB store column and the packed slot back to the original
    bin; None for a per-feature store."""
    read = _bin_reader(bins)
    node = _root_nodes(stack, _num_rows(bins))
    ft = None if feat_tbl is None else feat_tbl.to(torch.int64)
    for _ in range(meta.depth):
        safe = node.clamp(min=0)
        f = _node_field(stack.feature, safe)
        if ft is None:
            bv = read(f)
        else:
            bv_store = read(ft[0][f])
            off, dflt, ns = ft[1][f], ft[2][f], ft[3][f]
            s = bv_store - off
            in_r = (s >= 0) & (s < ns)
            orig = torch.where(in_r, s + (s >= dflt).to(torch.int64), dflt)
            bv = torch.where(ft[4][f] > 0, orig, bv_store)
        gl = _binned_decide(stack, safe, bv, meta.any_cat)
        node = _step_nodes(stack, node, safe, gl)
    return node


def predict_ensemble_binned(stack: EnsembleStack, bins: torch.Tensor,
                            feat_tbl: Optional[torch.Tensor] = None, *,
                            meta: EnsembleMeta) -> torch.Tensor:
    """Raw per-class scores over the dense BINNED store: [K, N] f32.

    bins: the [C, N] store of a ScoreUpdater (int32, or the rounds
    learner's int8 bytes) — the port's stores are feature-major where
    the JAX function takes [N+1, C].  Compares stay integer end to end;
    `feat_tbl` is the EFB remap of `_walk_binned_nodes`."""
    return _leaf_sums(stack, _walk_binned_nodes(stack, bins, feat_tbl,
                                                meta), meta)


def predict_ensemble_binned_sparse(stack: EnsembleStack, cols: torch.Tensor,
                                   binsv: torch.Tensor,
                                   zero_bin: torch.Tensor,
                                   feat_tbl: Optional[torch.Tensor] = None,
                                   *, meta: EnsembleMeta) -> torch.Tensor:
    """Raw per-class scores over the SPARSE binned store, without
    densifying: [K, N] f32.  Each level probes the row's ELL entries for
    the split column (`sparse_bin_lookup`, [T, N, R] compares); the
    routing is the dense replay's code, so scores are bitwise
    `predict_ensemble_binned` over the densified store."""
    return _leaf_sums(stack, _walk_binned_nodes(
        stack, (cols, binsv, zero_bin), feat_tbl, meta), meta)


def _request_bins(Xb: torch.Tensor) -> torch.Tensor:
    """[N, F] uint8/uint16 request bins -> the [F, N] int32 store layout
    (torch has no uint16 gather on every device, so widen first)."""
    return Xb.to(torch.int32).t().contiguous()


def predict_ensemble_quantized(stack, Xb: torch.Tensor, *,
                               meta: EnsembleMeta) -> torch.Tensor:
    """Raw per-class scores over an ingress-quantized request buffer:
    [K, N] f32 from [N, F] uint8/uint16 original per-feature bin ids
    (quantize.FeatureQuantizer), the binned serving request path.
    Shallow numerical ensembles traverse the perfect layout (bin ids in
    the f32 lanes), others the SoA walk of the replay with integer
    compares.  The quantizer's MISSING sentinel exceeds every threshold
    bin and matches no category bin, so NaN and unseen categories route
    right as in the raw kernel: scores are bitwise the raw kernel's.  No
    `feat_tbl`: request buffers speak original (feature, bin) space."""
    if isinstance(stack, PerfectEnsemble):
        return predict_ensemble_perfect(stack, Xb, meta=meta)
    return _leaf_sums(stack, _walk_binned_nodes(stack, _request_bins(Xb),
                                                None, meta), meta)


def _leaf_index(node: torch.Tensor) -> torch.Tensor:
    return torch.where(node < 0, ~node, 0).to(torch.int32)


def predict_ensemble_leaf_binned(stack: EnsembleStack, bins,
                                 feat_tbl: Optional[torch.Tensor] = None,
                                 *, meta: EnsembleMeta) -> torch.Tensor:
    """Per-tree leaf index over the binned store ([C, N], or the sparse
    triple): [T, N] int32, exactly the walk `predict_ensemble_binned`
    sums over (stumps park at leaf 0)."""
    return _leaf_index(_walk_binned_nodes(stack, bins, feat_tbl, meta))


def predict_ensemble_leaf(stack: EnsembleStack, X: torch.Tensor, *,
                          meta: EnsembleMeta) -> torch.Tensor:
    """Per-tree leaf index over raw feature values: [T, N] int32, the
    walk `predict_ensemble` sums over (the `pred_leaf` kernel)."""
    return _leaf_index(_walk_raw_nodes(stack, _raw_input(X), meta))


# ----------------------------------------------------------------------
# grouped (cross-model) traversal: co-stacked tenants in one walk
# ----------------------------------------------------------------------

def _select_tenant(per: torch.Tensor, tids: torch.Tensor) -> torch.Tensor:
    """[G, K, N] per-tenant answers -> [K, N], row n taking tenant
    tids[n]'s (an out-of-range id clamps, as JAX's gather does)."""
    G, K, N = per.shape
    idx = tids.to(torch.int64).clamp(0, G - 1)
    return torch.gather(per, 0, idx[None, None, :].expand(1, K, N))[0]


def _grouped_sums(stack: EnsembleStack, node: torch.Tensor,
                  tids: torch.Tensor, meta: GroupMeta) -> torch.Tensor:
    """[K, N] per-class sums where row n sums only its own tenant's
    trees.  Every row walked every tenant's trees; each tenant's sums
    run over its own static slice of the [T, N] leaf values with the
    solo reduction, then each row selects its tenant's."""
    vals = _leaf_values(stack, node)
    per = torch.stack([_class_sums(vals, cs) for cs in meta.class_segments])
    return _select_tenant(per, tids)


def predict_ensemble_grouped(stack: EnsembleStack, X: torch.Tensor,
                             tids: torch.Tensor, *,
                             meta: GroupMeta) -> torch.Tensor:
    """Mixed-tenant raw scores over raw features: [K, N] f32.  One walk
    of the whole super-stack, then per-tenant sums and a per-row tenant
    select; ``tids`` [N] is row n's index into ``meta.segments``."""
    node = _walk_raw_nodes(stack, _raw_input(X), meta)
    return _grouped_sums(stack, node, tids, meta)


def predict_ensemble_grouped_binned(stack: EnsembleStack, Xb: torch.Tensor,
                                    tids: torch.Tensor, *,
                                    meta: GroupMeta) -> torch.Tensor:
    """Mixed-tenant raw scores over ingress-quantized bin ids [N, F]:
    the binned walk over the super-stack, then the grouped sums.  Every
    tenant's buffer columns are padded to the group's widest (a tenant's
    trees never gather past its own columns)."""
    node = _walk_binned_nodes(stack, _request_bins(Xb), None, meta)
    return _grouped_sums(stack, node, tids, meta)


# segment-gathered grouped traversal (costack_kernel=segment): each row
# walks only its own tenant's tree segment, over L = the longest
# segment's slots, so node math is ~1x a solo tenant's

def _segment_slots(stack: EnsembleStack, tids: torch.Tensor,
                   meta: GroupMeta) -> tuple:
    """Per-(slot, row) tree indices ``tree[j, n] = start[tids[n]] + j``
    over L = max segment length slots, and the ``valid`` mask (``j <
    len(segment)``).  Slots past a short segment clamp to a real tree
    (walked, then masked out); an out-of-range tid clamps."""
    dev = stack.root.device
    starts = np.asarray([a for a, _b in meta.segments], np.int64)
    lens = np.asarray([b - a for a, b in meta.segments], np.int64)
    L = int(lens.max())
    T = stack.root.shape[0]
    g = tids.to(torch.int64).clamp(0, len(starts) - 1)
    start = torch.as_tensor(starts, device=dev)[g]
    length = torch.as_tensor(lens, device=dev)[g]
    j = torch.arange(L, dtype=torch.int64, device=dev)[:, None]
    valid = j < length[None, :]
    tree = torch.clamp(start[None, :] + j, max=T - 1)
    return tree, valid


def _walk_segment(stack: EnsembleStack, tree: torch.Tensor, meta,
                  read, decide) -> torch.Tensor:
    """The walk over per-row tree slots: [L, N] parked nodes.  The same
    level structure as the full-stack walks, with the tree axis indexed
    a row; decisions go through the same `_raw_decide` /
    `_binned_decide`, so a row's own trees park where the full walk
    parks them."""
    node = stack.root[tree]
    for _ in range(meta.depth):
        safe = (tree, node.clamp(min=0))
        v = read(_node_field(stack.feature, safe))
        gl = decide(stack, safe, v, meta.any_cat)
        node = _step_nodes(stack, node, safe, gl)
    return node


def _segment_sums(stack: EnsembleStack, node: torch.Tensor,
                  tree: torch.Tensor, valid: torch.Tensor, tids: torch.Tensor,
                  meta: GroupMeta) -> torch.Tensor:
    """[K, N] per-class sums of the [L, N] segment walk.  Row n's slots
    hold its tenant's trees in solo stack order; padded slots add -0.0,
    which `_tree_sum` absorbs exactly, so K == 1 is bitwise the solo sum.
    For K > 1, each class's slots are gathered from the row's segment
    (class-major, so a class is a contiguous run of slots) into their own
    -0.0-padded axis and summed the same way."""
    leaf = torch.where(node < 0, ~node, 0)
    vals = torch.where(valid, stack.leaf_value[tree, leaf], -0.0)
    if meta.num_class == 1:
        return _tree_sum(vals)[None]
    dev = vals.device
    g = tids.to(torch.int64).clamp(0, len(meta.segments) - 1)
    out = []
    for k in range(meta.num_class):
        offs = np.asarray([cs[k][0] - seg[0] for seg, cs in
                           zip(meta.segments, meta.class_segments)],
                          np.int64)
        cnts = np.asarray([cs[k][1] - cs[k][0]
                           for cs in meta.class_segments], np.int64)
        Lk = int(cnts.max())
        j = torch.arange(Lk, dtype=torch.int64, device=dev)[:, None]
        off = torch.as_tensor(offs, device=dev)[g]
        cnt = torch.as_tensor(cnts, device=dev)[g]
        idx = torch.clamp(off[None, :] + j, max=vals.shape[0] - 1)
        vk = torch.where(j < cnt[None, :], torch.gather(vals, 0, idx), -0.0)
        out.append(_tree_sum(vk))
    return torch.stack(out)


def predict_ensemble_grouped_segment(stack: EnsembleStack, X: torch.Tensor,
                                     tids: torch.Tensor, *,
                                     meta: GroupMeta) -> torch.Tensor:
    """Mixed-tenant raw scores over raw features, segment-gathered:
    [K, N] f32, bitwise `predict_ensemble_grouped` and per-tenant
    dispatch; row n walks its own tenant's trees only."""
    XT = _raw_input(X)
    tree, valid = _segment_slots(stack, tids, meta)
    node = _walk_segment(stack, tree, meta,
                         lambda f: torch.gather(XT, 0, f), _raw_decide)
    return _segment_sums(stack, node, tree, valid, tids, meta)


def predict_ensemble_grouped_segment_binned(stack: EnsembleStack,
                                            Xb: torch.Tensor,
                                            tids: torch.Tensor, *,
                                            meta: GroupMeta) -> torch.Tensor:
    """The binned twin of `predict_ensemble_grouped_segment` (integer
    compares end to end; buffers padded to the group's widest)."""
    read = _bin_reader(_request_bins(Xb))
    tree, valid = _segment_slots(stack, tids, meta)
    node = _walk_segment(stack, tree, meta, read, _binned_decide)
    return _segment_sums(stack, node, tree, valid, tids, meta)
