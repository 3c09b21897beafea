"""Diagnostics: the deterministic fault-injection registry (`faults`),
the runtime lock sanitizer (`locksan`), the hot-path and divergence
sanitizers with their counter names (`sanitize`), and the static
checks (`lint`, torchlint; `threadlint`).  `faults`, `locksan`, `lint`
and `threadlint` are standard library only."""
