"""swf_renderer_tpu_torch.native subpackage."""
