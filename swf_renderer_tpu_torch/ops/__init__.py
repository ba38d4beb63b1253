"""swf_renderer_tpu_torch.ops subpackage."""
