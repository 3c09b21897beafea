"""The data plane's host-side pieces, copied from lightgbm_tpu/sharded/:

- `sketch` — mergeable quantile sketches (per-chunk weighted summaries
  that merge associatively), the bin finder of `bin_find=sketch` and of
  the streamed construction;
- `ingest` — out-of-core streamed dataset construction:
  `Dataset.from_stream` runs a sketch pass, then bins chunk by chunk
  into the capacity-tiered store.

The mesh layer (`sharded/mesh.py` of the JAX package) comes with the
multi-GPU learners (ROADMAP.md §A item 12).
"""
