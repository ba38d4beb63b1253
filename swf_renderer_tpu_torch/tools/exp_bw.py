"""HBM streaming probes: a library add beside a hand-written passthrough
in two layouts and a read+sum.

    python3 -m swf_renderer_tpu_torch.tools.exp_bw

Port of the reference's ``tools/exp_bw.py``.  On F, L, NS = 60, 4, 137
planes of 128x128 f32 (2.15 GB: the headline's chunk-major planes),
drawn from a seeded ``torch.Generator`` on the card, it times with CUDA
events (median of 5 after a warm-up): P1 ``torch.add(x, 1.0)`` (the
reference's XLA copy; the library yardstick), P2 the passthrough kernel
over (F, L, NS, 128, 128) blocks of (1, L, 1, 128, 128), P3 over the
transpose (F, NS, L, 128, 128), P4 the read + sum over L of the
transpose.  Each line gives ms and GB/s (bytes read plus written; P4
bytes read, as the reference prints), then the card's name and power
limit.  Needs one NVIDIA card and ``nvcc``.

``passthrough`` and ``read_sum`` launch their kernels (``csrc/probes.cu``)
for tensors on the card and run their plain versions for tensors on the
CPU; each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

F, L, NS, LANE = 60, 4, 137, 128
LAYOUTS = ("lns", "nsl")


def geometry(shape, layout: str):
    """(n_f, n_s, n_l, tile, sf, ss, sl) of the reference's grid over a
    contiguous (F, A, B, R, C) array, as the probe kernels take it: a
    block per (f, s) of L tiles of R*C floats; "lns" reads (F, L, NS, R,
    C), "nsl" (F, NS, L, R, C).  Either covers the array's span exactly
    once, which the passthrough streams."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    n_f, a, b, r, c = shape
    tile = r * c
    if layout == "lns":
        return n_f, b, a, tile, a * b * tile, tile, b * tile
    return n_f, a, b, tile, a * b * tile, b * tile, tile


def _check(x, ndim: int):
    if x.dim() != ndim or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous {ndim}-D float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] * x.shape[-2] % 4:
        raise ValueError(f"tiles of {tuple(x.shape[-2:])}: the kernels "
                         "read 16-byte vectors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def launch_probe(fn: str, x, out, geo, *out_strides):
    """One launch of ``csrc/probes.cu``'s ``fn`` over grid ``geo``."""
    from ..ops import cuda_lib

    err = getattr(cuda_lib.load("swfprobes"), fn)(
        x.data_ptr(), out.data_ptr(), *geo, *out_strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
    return out


def passthrough_plain(x):
    """x + 1 (the reference's kernel body)."""
    return x + 1.0


def passthrough(x, layout: str):
    """x + 1 over a 5-D (F, L, NS, R, C) ("lns") or (F, NS, L, R, C)
    ("nsl") float32 array.

    Kernel: replaces ``passthrough.<locals>.kernel`` (tools/exp_bw.py:63).
    The layout's (f, s) blocks cover the array once, so the kernel streams
    it as one span of 16-byte vectors, a block of 1024 threads a chunk of
    1024 (csrc/probes_device.cuh).
    Bound: bytes (x read once, the result written once).  On the CPU
    ``passthrough_plain`` runs."""
    _check(x, 5)
    geo = geometry(tuple(x.shape), layout)
    if x.device.type == "cpu":
        return passthrough_plain(x)
    out = launch_probe("swf_passthrough", x, torch.empty_like(x), geo)
    passthrough.launches += 1
    return out


passthrough.launches = 0


def read_sum_plain(x):
    """(F, NS, L, R, C) -> (F, NS, R, C): the sum over L, left to right."""
    acc = x[:, :, 0]
    for lyr in range(1, x.shape[2]):
        acc = acc + x[:, :, lyr]
    return acc


def read_sum(x):
    """The sum over L of each (f, s) block of a (F, NS, L, R, C) float32
    array -> (F, NS, R, C), added left to right.

    Kernel: replaces ``kernel4`` (tools/exp_bw.py:84).  A block a (tile,
    chunk) task; a thread loads the L inputs of each of its two output
    vectors up front, then adds them left to right
    (csrc/probes_device.cuh).  Bound: bytes (x read once, the sums written
    once).  On the CPU ``read_sum_plain`` runs."""
    _check(x, 5)
    n_f, n_s, n_l, r, c = x.shape
    geo = geometry(tuple(x.shape), "nsl")
    if x.device.type == "cpu":
        return read_sum_plain(x)
    out = torch.empty((n_f, n_s, r, c), dtype=torch.float32, device=x.device)
    launch_probe("swf_read_sum", x, out, geo, n_s * r * c, r * c)
    read_sum.launches += 1
    return out


read_sum.launches = 0


def planes(device, seed: int = 0, shape=(F, L, NS, LANE, LANE)):
    """The probes' input: (F, L, NS, 128, 128) standard normal f32 from a
    seeded generator on ``device``, and its (F, NS, L, 128, 128)
    transpose."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    return x, x.movedim(1, 2).contiguous()


def main() -> None:
    from .timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_bw needs a CUDA card")
    x, x_t = planes("cuda")
    gb = x.numel() * 4 / 1e9
    probes = (
        ("P1 torch.add", lambda: torch.add(x, 1.0), 2 * gb, "(r+w)", None),
        ("P2 passthrough (F,L,NS)", lambda: passthrough(x, "lns"), 2 * gb,
         "(r+w)", lambda: torch.add(x, 1.0)),
        ("P3 passthrough (F,NS,L)", lambda: passthrough(x_t, "nsl"), 2 * gb,
         "(r+w)", lambda: torch.add(x_t, 1.0)),
        ("P4 read+sum", lambda: read_sum(x_t), gb, "(read)",
         lambda: read_sum_plain(x_t)))
    for label, fn, nbytes, what, plain in probes:
        ms = time_ms(torch, fn)
        check = "" if plain is None else \
            f"  equal to its plain version: {torch.equal(fn(), plain())}"
        print(f"[{label}] {ms:.3f} ms  {nbytes / ms * 1e3:.0f} GB/s {what}"
              f"{check}", flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
