"""``swf_renderer_tpu_torch.render_movie_timeline(movie_bytes)``: the
clip is written as SWF bytes in set-up; each call parses them anew into
a new renderer.  The traced call is its documented composition,
``load_movie_timeline`` and then ``TorchRenderer.render_batch``, with a
span around each."""

from __future__ import annotations

from . import Base


class Entry(Base):
    def prepare(self, clip):
        from ..swfwrite import movie_bytes

        return movie_bytes(clip)

    def call(self, movie):
        import swf_renderer_tpu_torch as swf

        return swf.render_movie_timeline(movie, device=self.device)

    def traced_call(self, movie, span):
        from swf_renderer_tpu_torch.runtime.movie import load_movie_timeline
        from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

        with span("load_movie_timeline"):
            stages, bitmaps = load_movie_timeline(movie)
        with span("render_batch"):
            renderer = TorchRenderer(stages[0].width, stages[0].height,
                                     device=self.device)
            for bmp in bitmaps:
                renderer.add_bitmap(bmp)
            out = renderer.render_batch(stages)
        self.record(renderer)
        return out
