"""The benchmark of ``swf_renderer_tpu_torch`` on an NVIDIA card: see
``run.py`` and PERF.md."""
