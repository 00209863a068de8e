"""Entry points beside the port's library: the probes that time and inspect
its kernels on the card (``kernel_breakdown``, ``mxu_occupancy``,
``int_split_repro``, ``kernel_ab``), the N-rank check of the
pulse-sharded step (``pulse_shard_ranks``), and the producer and consumer
shims of `cli produce` / `cli consume` (``producer``, ``consumer``)."""
