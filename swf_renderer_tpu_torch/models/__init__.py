"""swf_renderer_tpu_torch.models subpackage."""
