"""Entry points beside the port's library: the probes that time and inspect
its kernels on the card (``kernel_breakdown``, ``mxu_occupancy``,
``int_split_repro``, ``kernel_ab``), the tools that check the CLI's output
or its paths on the card (``trace_summary`` of `stream --trace` and `bench
--profile`, ``hw_parity``, ``wire_ab``, ``decode_ab``), the N-rank check
of the pulse-sharded step (``pulse_shard_ranks``), the route sweep under
the bench's harness (``ab_sweep``), multi-host weak scaling
(``multihost_bench``), N feeds through one card (``consolidation_soak``),
and the producer and consumer shims of `cli produce` / `cli consume`
(``producer``, ``consumer``)."""
