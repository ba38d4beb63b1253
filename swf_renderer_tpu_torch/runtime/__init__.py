"""swf_renderer_tpu_torch.runtime subpackage."""
