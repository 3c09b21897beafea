"""The program's host reads a tree (Booster._gbdt.host_syncs_per_tree),
over the window's trees. Moves train_iter_s."""
from benchmark.readers import syncs_per_tree as read  # noqa: F401
