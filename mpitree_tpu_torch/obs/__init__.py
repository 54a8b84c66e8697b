"""Observability, counterpart of ``mpitree_tpu.obs``: so far the serving
metrics registry (``obs.metrics``) and the streaming ingest's host
arithmetic (``obs.memory``); the build records, traces, the memory
planner and the rest come with ``ROADMAP.md`` Queue 1 item 18."""
