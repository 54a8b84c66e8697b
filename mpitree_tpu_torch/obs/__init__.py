"""Observability, counterpart of ``mpitree_tpu.obs``: so far only the
serving metrics registry (``obs.metrics``); the build records, traces and
the rest come with ``ROADMAP.md`` Queue 1 item 18."""
