"""Where the affine sweep kernel's time goes, phase by phase.

    python3 -m swf_renderer_tpu_torch.tools.sweep_phases

Needs one NVIDIA card and ``nvcc``.  The kernel of ``csrc/sweep.cu`` runs
its phases in order inside one block: setup (zero the planes, load the
frame's tables), piece walk (transform, scatter ramp differences), row
prefix, resolve.  A profiler cannot look inside a kernel on a machine
without ``ncu``, so this script builds copies of the kernel that return
before a given phase (their output is garbage and is not read) and times
each on the animation benchmark scene, uncut (60 frames x 3 layers x
1088x1920), solid and with a fading gradient layer.  The difference
between two neighbouring variants is the later phase's time.  Prints one
JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import tempfile

from .timing import card_line, time_ms

# Variant -> the line of sweep_device.cuh it returns in front of.
STOPS = {
    "setup": "  // Placement: ramp differences of every piece that reaches "
             "the tile.",
    "setup+walk": "  if (*touched_s == 0) {",
    "setup+walk+prefix": "  // Resolve: fill rule, paints, composite, "
                         "quantize, pack.",
    "full": None,
}


def main() -> None:
    import numpy as np
    import torch

    from ..ops import cuda_lib, style as style_ops, transform as sweep
    from ..utils.scenes import anim_scene

    if not torch.cuda.is_available():
        raise SystemExit("sweep_phases needs a CUDA card")
    height, width, frames = 1088, 1920, 60
    tables, colors, mats = anim_scene(height, width, frames)
    tab, colarr = sweep.affine_pieces(tables, colors, mats)
    counts = sweep.layer_piece_counts(tab)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    d_mats, d_tab, d_col = up(mats), up(tab), up(colarr)
    base = np.array([[1, 0.2, 0, 1], [0, 1, 0.5, 0.8], [0.2, 0, 1, 1]],
                    np.float32)
    paints = [style_ops.solid_paint(tuple(c)) for c in colors]
    paints[1] = style_ops.Paint(
        kind=style_ops.PAINT_LINEAR,
        inv_matrix=(2.0 * 16384.0 / width, 0.0, 0.0, 2.0 * 16384.0 / width,
                    -16384.0, -16384.0 * height / width),
        stop_ratios=np.array([0.0, 0.5, 1.0], np.float32), stop_colors=base)
    kpaints, grad_mats = sweep.sweep_paints(paints, mats)
    stops = np.zeros((frames, 3, 3, 4), np.float32)
    stops[:, 1] = base[None] * np.linspace(
        1.0, 0.4, frames, dtype=np.float32)[:, None, None]
    d_gm, d_sc = up(grad_mats), up(stops)

    def solid():
        return sweep.render_affine_sweep(d_mats, d_tab, d_col, height, width,
                                         layer_counts=counts)

    def gradient():
        return sweep.render_affine_sweep(
            d_mats, d_tab, d_col, height, width, layer_counts=counts,
            paints=kpaints, grad_mats=d_gm, stop_colors=d_sc)

    csrc, build = cuda_lib.CSRC_DIR, cuda_lib.BUILD_DIR
    source = (csrc / "sweep_device.cuh").read_text()
    result = {"scene": "anim1080", "frames": frames, "layers": 3,
              "height": height, "width": width, "ms": {}}
    try:
        for name, stop in STOPS.items():
            tmp = pathlib.Path(tempfile.mkdtemp(prefix="sweep_phases_"))
            shutil.copytree(csrc, tmp / "csrc")
            text = source
            if stop is not None:
                if text.count(stop) != 1:
                    raise SystemExit(f"marker of {name!r} not found once in "
                                     "sweep_device.cuh")
                text = text.replace(
                    stop, "  if (a.frames > 0) return;  // probe\n" + stop)
            (tmp / "csrc" / "sweep_device.cuh").write_text(text)
            cuda_lib.CSRC_DIR, cuda_lib.BUILD_DIR = tmp / "csrc", tmp / "build"
            cuda_lib._libs.clear()
            result["ms"][name] = {"solid": time_ms(torch, solid),
                                  "gradient": time_ms(torch, gradient)}
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        cuda_lib.CSRC_DIR, cuda_lib.BUILD_DIR = csrc, build
        cuda_lib._libs.clear()
    print(json.dumps(result))
    print(card_line())


if __name__ == "__main__":
    main()
