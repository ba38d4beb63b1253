"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points never quietly run on the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "swf_renderer_tpu_torch"

# `swf_renderer_tpu_torch` starts with `swf_renderer_tpu`: only a name NOT
# followed by another identifier character is the JAX package.
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|swf_renderer_tpu)(?![\w])", re.M)
_DYNAMIC = re.compile(
    r"import_module\(\s*['\"](?:jax|swf_renderer_tpu)(?![\w])")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_forbidden_pattern_respects_the_name_trap():
    assert _FORBIDDEN.search("import jax\n")
    assert _FORBIDDEN.search("from swf_renderer_tpu.ops import style\n")
    assert _FORBIDDEN.search("    import swf_renderer_tpu\n")
    assert not _FORBIDDEN.search("from swf_renderer_tpu_torch.ops import x\n")
    assert not _FORBIDDEN.search("import swf_renderer_tpu_torch\n")
    assert not _FORBIDDEN.search("import jaxlib_like_name\n")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_do_not_import_jax(path):
    text = path.read_text()
    assert not _FORBIDDEN.search(text), _FORBIDDEN.search(text).group(0)
    assert not _DYNAMIC.search(text)


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['swf_renderer_tpu'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import importlib\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jaxlib' or "
        "m.startswith(('jax.', 'jaxlib.', 'swf_renderer_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_scan_covers_the_movie_front_end_and_the_cli():
    """The SWF front end, the movie loader, the image writers and
    ``python -m swf_renderer_tpu_torch`` are among the modules scanned
    and imported above."""
    mods = set(_port_modules())
    for name in ("utils.bits", "models.sound", "models.screenvideo",
                 "models.swf_binary", "runtime.movie", "utils.png",
                 "utils.pam", "utils.movie_scenes", "__main__"):
        assert f"swf_renderer_tpu_torch.{name}" in mods, name


def test_entry_points_without_device_or_card_raise(monkeypatch):
    from swf_renderer_tpu_torch.models import display
    from swf_renderer_tpu_torch.ops import style as style_ops
    from swf_renderer_tpu_torch.ops.pipeline import (
        render_batch_flatblock, render_batch_styled,
    )
    from swf_renderer_tpu_torch.runtime.renderer import TorchRenderer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tri = np.array([[1, 1, 20, 2], [20, 2, 5, 15], [5, 15, 1, 1]],
                   np.float32)
    colors = np.ones((1, 1, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_batch_flatblock([[tri]], colors, 16, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_batch_styled([[tri]], [style_ops.solid_paint((1, 0, 0, 1))],
                            16, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchRenderer(32, 16)
    # The same calls run when the caller asks for the CPU.
    out = render_batch_flatblock([[tri]], colors, 16, 32, device="cpu")
    assert out.shape == (1, 16, 32, 4) and out[..., 3].max() == 255
    r = TorchRenderer(32, 16, device="cpu")
    assert r.render(display.Stage(width=32, height=16)).shape == (16, 32, 4)


def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch():
    """A wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel or raises (here: the meta device)."""
    from swf_renderer_tpu_torch.ops.flatblock import (
        BLK, render_fused_blocksn,
    )

    ng, group = 2, 6

    def t(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")

    args = (t((ng,), torch.int32), t((ng,), torch.int32),
            t((group, ng), torch.int32),
            t((ng, 1, group * BLK), torch.float32),
            t((ng, group * BLK, 1), torch.float32),
            t((ng, 1, group * BLK), torch.float32),
            t((1, 1, 4), torch.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        render_fused_blocksn(*args, 1, 1, 1, 1)
    assert render_fused_blocksn.launches == 0
