"""The data plane's pieces, ported from lightgbm_tpu/sharded/:

- `sketch` — mergeable quantile sketches (per-chunk weighted summaries
  that merge associatively), the bin finder of `bin_find=sketch` and of
  the streamed construction;
- `ingest` — out-of-core streamed dataset construction:
  `Dataset.from_stream` runs a sketch pass, then bins chunk by chunk
  into the capacity-tiered store.

- `mesh` — the mesh layer of the multi-GPU learners: the
  `torch.distributed` world as a (data, feature) mesh, one rank a card,
  its collectives, and the histogram exchange's helpers.
"""
