"""swf_renderer_tpu_torch.parallel: rendering sharded over the ranks of a
``torch.distributed`` group (``mesh.py``)."""
