"""swf_renderer_tpu_torch.utils subpackage."""
